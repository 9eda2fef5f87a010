"""Tracing: the program's spans and counters, and a profiler window.

Counterpart of deephumor_tpu/utils/profiling.py:

- :func:`sync`: waits for the devices of every CUDA tensor in a tree
  (``torch.cuda.synchronize`` in place of ``block_until_ready``);
- :func:`trace`: a ``torch.profiler`` window of every thread whose Chrome
  trace is written to a directory.

The program marks its own work with :func:`span` (a named range of one
thread) and :func:`count` (a named tally). Both record only while a
``torch.profiler`` records (``torch.autograd.profiler``'s process-wide
``_is_profiler_enabled``): no option turns them on, and while it is off
a span is a flag check that returns a shared null context, with no
``record_function``, no clock read and no allocation. While it is on, a
span

- opens ``torch.profiler.record_function(name)``, so that the profiler's
  trace shows it on the kernels' clock, on every thread it records;
- appends a :class:`Record` to an in-memory list: its name, its thread's
  name, ``perf_counter_ns`` start and end, the name of the enclosing span
  on the same thread (``parent``) and an ``id`` (given, or the enclosing
  span's: the spans of one batcher dispatch and of the requests in it
  share its sequence number).

A span that starts while recording is on is kept whole, wherever it ends.
The records and counts are cleared when recording is first seen on after
it was seen off, so that they hold one profiled window; they are capped
at ``MAX_RECORDS``, and :func:`dropped` counts what passed the cap.
:func:`stamp` and :func:`span_since` make a span that starts on one thread
and ends on another (a request's wait in a queue): it has no thread
and no ``record_function`` range. :func:`records`, :func:`counts` and
:func:`summary` read them in the process that recorded them.
"""

import collections
import contextlib
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _flag

__all__ = ["trace", "sync", "span", "count", "window", "stamp",
           "span_since", "records", "counts", "summary", "dropped", "Record",
           "MAX_RECORDS"]

# a long traced run keeps at most this many records (~200 bytes each)
MAX_RECORDS = 10 ** 6

Record = collections.namedtuple(
    "Record", ["name", "thread", "start", "end", "parent", "id"])

_OFF = contextlib.nullcontext()


class _State:
    """The recorded window: its records and counts, what passed the cap,
    whether recording was seen off since it was last seen on, and the
    window's number (a span that started in an earlier window is not
    added to this one)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records, self.counts = [], collections.Counter()
        self.dropped, self.seen_off, self.window = 0, True, 0
        self.local = threading.local()


_S = _State()


def _window():
    """The current window's number, after clearing the records if recording
    was seen off since it was last seen on (call only while on)."""
    if _S.seen_off:
        with _S.lock:
            if _S.seen_off:
                _S.records, _S.counts = [], collections.Counter()
                _S.dropped, _S.seen_off = 0, False
                _S.window += 1
    return _S.window


def _add(record, window):
    # a plain tuple of atoms: the collector stops tracking it, so that a
    # long window's records add no work to each garbage collection
    with _S.lock:
        if window != _S.window:
            return
        if len(_S.records) < MAX_RECORDS:
            _S.records.append(record)
        else:
            _S.dropped += 1


def _stack():
    stack = getattr(_S.local, "stack", None)
    if stack is None:
        stack = _S.local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "window", "start", "range")

    def __init__(self, name, id):
        self.name, self.id = name, id

    def __enter__(self):
        self.window = _window()
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.id is None and outer is not None:
            self.id = outer.id
        stack.append(self)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _stack().pop()
        _add((self.name, threading.current_thread().name, self.start, end,
              self.parent, self.id), self.window)
        return False


def span(name, id=None):
    """A context manager that records the block as the span ``name`` while
    a profiler records (module docstring), and does nothing otherwise.
    ``id``: the span's id (None: the enclosing span's)."""
    if not _flag._is_profiler_enabled:
        _S.seen_off = True
        return _OFF
    return _Span(name, id)


def count(name, n=1):
    """Adds ``n`` to the counter ``name`` while a profiler records."""
    if not _flag._is_profiler_enabled:
        _S.seen_off = True
        return
    _window()
    with _S.lock:
        _S.counts[name] += n


def window():
    """The recorded window's number while a profiler records, else None: a
    caller that folds a device's running tally into :func:`count` starts
    afresh in each window."""
    if not _flag._is_profiler_enabled:
        _S.seen_off = True
        return None
    return _window()


def stamp():
    """The start of a :func:`span_since` while a profiler records, else
    None."""
    if not _flag._is_profiler_enabled:
        _S.seen_off = True
        return None
    return _window(), time.perf_counter_ns()


def span_since(name, start, id=None):
    """Records the span ``name`` from ``start`` (a :func:`stamp`; None: no
    span) to now, on no thread: a wait that starts on one thread and ends
    on another. Kept whole, as a span is, if it started in this window."""
    if start is not None:
        window, ns = start
        _add((name, None, ns, time.perf_counter_ns(), None, id), window)


def records():
    """The window's records (:class:`Record`), in the order they ended."""
    with _S.lock:
        recs = list(_S.records)
    return [Record._make(r) for r in recs]


def counts():
    """The window's counters: name -> total."""
    with _S.lock:
        return dict(_S.counts)


def dropped():
    """The window's spans that passed ``MAX_RECORDS`` and were not kept."""
    return _S.dropped


def summary(recs=None):
    """Per span name: ``count``, ``total_ms`` and ``self_ms`` (its time
    less what its child spans on the same thread cover), over ``recs``
    (default: the window's records)."""
    recs = records() if recs is None else recs
    out = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "total_ms": 0.0,
                                    "self_ms": 0.0})
        ms = (r.end - r.start) * 1e-6
        s["count"] += 1
        s["total_ms"] += ms
        s["self_ms"] += ms
    for r in recs:
        if r.parent is not None and r.parent in out:
            out[r.parent]["self_ms"] -= (r.end - r.start) * 1e-6
    return out


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


def _all_threads():
    """The profiler's option to record every thread, or None where the
    installed torch lacks it."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def _write_spans(path, recs):
    """Adds ``recs`` (those with a thread) to the Chrome trace at ``path``
    as complete events on the trace's clock: Unix microseconds less the
    trace's ``baseTimeNanoseconds``."""
    with open(path) as f:
        doc = json.load(f)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    unix_ns = time.time_ns() - time.perf_counter_ns()
    pid, tids = os.getpid(), {}
    for r in recs:
        if r.thread is None:
            continue
        tid = tids.setdefault(r.thread, 1 << 30 | len(tids))
        doc["traceEvents"].append({
            "ph": "X", "cat": "user_annotation", "name": r.name, "pid": pid,
            "tid": tid, "ts": (r.start + unix_ns) / 1e3 - base_us,
            "dur": (r.end - r.start) / 1e3, "args": {"id": r.id}})
    for name, tid in tids.items():
        doc["traceEvents"].append({"ph": "M", "name": "thread_name",
                                   "pid": pid, "tid": tid,
                                   "args": {"name": name}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir):
    """Profiles the block (host, and the card where there is one) on every
    thread, and writes ``trace.json`` (Chrome / Perfetto format) into
    ``log_dir``; yields the profiler, whose ``key_averages()`` sums time
    by op. Where the installed torch cannot record every thread, the
    program's spans are written into the trace from their records."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    config = _all_threads()
    with profile(activities=activities, experimental_config=config) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if config is None:
        _write_spans(path, records())
