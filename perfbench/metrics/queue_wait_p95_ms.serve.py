"""The 95th percentile of the requests' wait in the batcher's queue over
the traced window, in ms: the program's ``batcher.queue`` spans
(deephumor_tpu_torch/utils/profiling.py), each from a request's submit
to the start of the dispatch that takes it. None where the program
records no span."""

import numpy as np


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
    ms = [(r.end - r.start) * 1e-6 for r in records()
          if r.name == "batcher.queue"]
    return float(np.percentile(ms, 95)) if ms else None
