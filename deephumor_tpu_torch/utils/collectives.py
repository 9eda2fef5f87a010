"""The all-reduces of the port's steps, counted.

Every all-reduce that a train step or a decode step makes (the
batch-norm moments, the loss's denominators, the summed gradients, the
clip's norm, the model axis's partial sums and gradients) goes through
:func:`all_reduce`, which counts it in ``COUNTS`` by (device type,
elements, backend of its group), so that a run can show what its steps
reduced. An all-reduce made while its stream is captured into a CUDA
graph runs only when the graph replays: it goes into the tally of the
capture (:func:`capture_tally`), which :func:`add` adds to ``COUNTS`` at
each replay, as ``ops/_build.py`` counts kernel launches. The capture is
told by the stream, not by the thread: autograd runs a CUDA backward on
a thread of its own, on the forward's stream, and its all-reduces are
part of the graph too.
"""

import collections
import contextlib

import torch
import torch.distributed as dist

__all__ = ["COUNTS", "all_reduce", "capture_tally", "add"]

COUNTS = collections.Counter()
# the tally of the capture in progress (None: none); captures run one at a
# time in a process (models/graphs.py CAPTURE_LOCK)
_TALLY = [None]


def all_reduce(x, group):
    """``dist.all_reduce(x, group=group)`` (a sum, in place), counted."""
    key = (x.device.type, x.numel(), dist.get_backend(group))
    tally = _TALLY[0]
    if (tally is not None and x.is_cuda
            and torch.cuda.is_current_stream_capturing()):
        tally[key] += 1
    else:
        COUNTS[key] += 1
    dist.all_reduce(x, group=group)


@contextlib.contextmanager
def capture_tally():
    """Collects the all-reduces captured inside the block into the Counter
    it yields, instead of ``COUNTS``."""
    tally, saved = collections.Counter(), _TALLY[0]
    _TALLY[0] = tally
    try:
        yield tally
    finally:
        _TALLY[0] = saved


def add(tally):
    """Adds a captured graph's tally to ``COUNTS`` (once per replay)."""
    COUNTS.update(tally)
