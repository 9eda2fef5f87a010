"""The collector's time to gather a batch, in ms a dispatch: the
program's ``batcher.collect`` spans over the traced window, each from the
wait for a batch's first request to the batch's close
(deephumor_tpu_torch/serving.py ``DynamicBatcher._run``), summed over
the ``batcher.dispatch`` spans that share their id and end before the
last span of the window started, over those dispatches. A collection that
no such dispatch followed (the idle wait after the window) is left out.
None where the program records no span."""


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
    ids = {r.id for r in recs
           if r.name == "batcher.dispatch" and r.end <= last}
    ms = sum((r.end - r.start) * 1e-6 for r in recs
             if r.name == "batcher.collect" and r.id in ids)
    return ms / len(ids) if ids else None
