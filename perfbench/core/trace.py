"""The harness's spans and the reduction of a device trace.

``Spans`` marks what the harness does around its calls into the program
(a generate call, a submit, an epoch) as
``torch.profiler.record_function`` ranges when the run is traced, so
that the trace can name what the host was doing in each of the device's
idle gaps. ``reduce_trace`` reads a chrome trace that ``torch.profiler``
exported: the device's busy time (the union of its kernel, copy and set
intervals) inside the window, the kernels' total time by name, and the
idle gaps labelled by the innermost span of the harness that covers
them. ``Phases`` splits set-up on the host clock.
"""

import collections
import contextlib
import json
import os
import sys
import time

import torch

WINDOW = "pb:window"
_PREFIX = "pb:"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the breakdown's entries: the longest device operations and idle gaps
TOP = 10


class Spans:
    """The harness's spans around its calls into the program, marked in the
    profiler's trace when the run is traced (``traced``)."""

    def __init__(self, traced=False):
        self.traced = traced

    def __call__(self, name):
        if self.traced:
            return torch.profiler.record_function(_PREFIX + name)
        return contextlib.nullcontext()


class Phases:
    """Set-up's phases on the host clock from the process's start
    (``t0``): each mark ends a phase; ``report`` prints them on standard
    error, so that a slow set-up shows where its time went."""

    def __init__(self, t0):
        self.t0, self.marks = t0, []

    def __call__(self, name):
        self.marks.append((name, time.perf_counter()))

    def report(self):
        last, parts = self.t0, []
        for name, t in self.marks:
            parts.append(f"{name} {t - last:.2f}")
            last = t
        print("setup_s by phase: " + ", ".join(parts), file=sys.stderr,
              flush=True)


def profiler():
    """A profiler of the host and the CUDA device, no stacks or shapes."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _union(intervals):
    """Sorted, merged ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events, device=None):
    """The summary of one process's trace events (chrome format, times in
    microseconds): ``window_s``, ``busy_s``, ``kernel_s`` (name ->
    seconds, inside the window), ``kernels`` (name -> launches), ``gaps``
    (the ``TOP`` longest idle gaps as ``[(label, seconds)]``,
    longest first) and ``span_s`` (the harness's
    spans inside the trace: name -> seconds). ``device``: the CUDA device
    index whose operations count (None: every device in the trace)."""
    window = None
    spans, dev_iv = [], []
    kernel_s = collections.Counter()
    kernels = collections.Counter()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(_PREFIX):
            if name == WINDOW:
                window = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, name[len(_PREFIX):]))
        elif cat in _DEVICE_CATS:
            if device is not None:
                args = ev.get("args", {})
                if int(args.get("device", device)) != device:
                    continue
            dev_iv.append((ts, ts + dur, name, cat))
    if window is None:
        raise ValueError("the trace holds no window span")
    w0, w1 = window
    clipped = []
    for s, e, name, cat in dev_iv:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        kernel_s[name] += (e - s) * 1e-6
        if cat == "kernel":
            kernels[name] += 1
    busy = _union(clipped)
    busy_us = sum(e - s for s, e in busy)
    # idle gaps inside the window, each named by the innermost harness
    # span over its middle (spans nest, so the shortest one covering it)
    spans.sort()
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    labelled = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = 0.5 * (s + e)
        over = [(b - a, n) for a, b, n in spans if a <= mid <= b]
        labelled.append((min(over)[1] if over else "window",
                         (e - s) * 1e-6))
    labelled.sort(key=lambda g: -g[1])
    span_s = collections.Counter()
    for a, b, n in spans:
        span_s[n] += (min(b, w1) - max(a, w0)) * 1e-6 if b > w0 and a < w1 \
            else 0.0
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernel_s": dict(kernel_s), "kernels": dict(kernels),
            "gaps": labelled, "span_s": dict(span_s)}


def reduce_trace(prof, path, device=None):
    """Exports ``prof``'s trace to ``path``, reduces it
    (:func:`reduce_events`) and deletes the file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, device)


def breakdown(summaries):
    """The result line's ``breakdown`` from one summary per chip: the
    device operations that took most time and the longest idle gaps,
    each at most ``TOP`` entries, seconds averaged over the chips."""
    n = len(summaries)
    ops = collections.Counter()
    for s in summaries:
        for k, v in s["kernel_s"].items():
            ops[k] += v / n
    gaps = sorted((g for s in summaries for g in s["gaps"]),
                  key=lambda g: -g[1])[:TOP]
    return {"device_ops": [[_short(k), v] for k, v in ops.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in gaps]}


def _short(name, limit=160):
    return name if len(name) <= limit else name[:limit - 3] + "..."
