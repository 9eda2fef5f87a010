"""The collector's own host work, in ms a dispatch: the mean over the
traced window's ``batcher.dispatch`` spans of each one's time less its
``host_read`` and ``pipeline.fetch`` spans (the waits on the device),
matched by the dispatch's id. While it runs, a synchronous batcher has
nothing of the next batch on the device. A dispatch that ends after the
last span of the window started (one in flight when the profiler
stopped, which then runs beside the harness's reduction of the trace) is
left out. None where the program records no span."""

import collections

WAITS = ("host_read", "pipeline.fetch")


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    try:
        from deephumor_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    recs = records()
    if not recs:
        return None
    last = max(r.start for r in recs)
    own = {r.id: r.end - r.start for r in recs
           if r.name == "batcher.dispatch" and r.end <= last}
    waited = collections.Counter()
    for r in recs:
        if r.name in WAITS and r.id in own:
            waited[r.id] += r.end - r.start
    if not own:
        return None
    return sum(own[i] - waited[i] for i in own) * 1e-6 / len(own)
