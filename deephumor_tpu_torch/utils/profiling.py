"""Tracing and timing helpers.

Counterpart of deephumor_tpu/utils/profiling.py:

- :func:`sync`: waits for the devices of every CUDA tensor in a tree
  (``torch.cuda.synchronize`` in place of ``block_until_ready``);
- :func:`trace`: a ``torch.profiler`` window whose Chrome trace is written
  to a directory;
- :class:`Timer`: wall-clock section timing that syncs the section's
  result;
- :func:`benchmark`: warm-up, then timed calls, each synced.
"""

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["trace", "Timer", "benchmark", "sync"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def sync(tree):
    """Waits until the work producing every CUDA tensor of ``tree`` is
    done; returns ``tree``."""
    devices = {leaf.device for leaf in _leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


@contextlib.contextmanager
def trace(log_dir):
    """Profiles the block (host, and the card where there is one) and
    writes ``trace.json`` (Chrome / Perfetto format) into ``log_dir``;
    yields the profiler, whose ``key_averages()`` sums time by op."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _SectionResult:
    """Mutable handle a timed block assigns its output to."""

    __slots__ = ("result",)

    def __init__(self):
        self.result = None


class Timer:
    """Accumulating section timer with device sync."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name):
        """Times a block; assign the block's output to the yielded handle
        so that the exit syncs it::

            with timer.section("step") as s:
                s.result = step(x)

        Without the assignment only the host's enqueue time is measured
        (CUDA calls return before the device is done).
        """
        holder = _SectionResult()
        t0 = time.perf_counter()
        yield holder
        if holder.result is not None:
            sync(holder.result)
        self.sections.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self):
        return {name: {"total_s": float(np.sum(ts)),
                       "mean_s": float(np.mean(ts)), "count": len(ts)}
                for name, ts in self.sections.items()}


def benchmark(fn, *args, iters=5, warmup=1):
    """Times ``fn(*args)`` after ``warmup`` calls, syncing each result;
    returns mean, median and min seconds."""
    for _ in range(warmup):
        sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"mean_s": float(np.mean(times)), "p50_s": float(np.median(times)),
            "min_s": float(np.min(times)), "iters": iters}
