"""The readers of the program's spans (``metrics/*`` over
``deephumor_tpu_torch.utils.profiling.records()``) on synthetic records:
each reading, None off its kind, and None from a program that records
no span."""

import collections

import pytest

from perfbench.core import spec
from deephumor_tpu_torch.utils import profiling

MS = 1_000_000  # ns
# the fields of profiling.Record
Record = collections.namedtuple(
    "Record", ["name", "thread", "start", "end", "parent", "id"])


def rec(name, start_ms, end_ms, id=None, parent=None, thread="dh-batcher"):
    return Record(name, thread, int(start_ms * MS), int(end_ms * MS), parent,
                  id)


SERVE = [
    rec("batcher.collect", 0, 8, id=0),
    *[rec("batcher.queue", q, 10, id=0, thread=None)
      for q in (0, 2, 4, 6, 8)],
    rec("pipeline.gather", 10, 11, 0, "batcher.dispatch"),
    rec("host_read", 12, 20, 0, "model.generate"),
    rec("model.generate", 11, 22, 0, "batcher.dispatch"),
    rec("pipeline.fetch", 22, 40, 0, "batcher.dispatch"),
    rec("pipeline.decode", 40, 44, 0, "batcher.dispatch"),
    rec("batcher.resolve", 44, 46, 0, "batcher.dispatch"),
    rec("batcher.dispatch", 10, 46, 0),
    rec("batcher.collect", 46, 58, id=1),
    rec("batcher.queue", 30, 60, id=1, thread=None),
    rec("host_read", 61, 70, 1, "model.generate"),
    rec("pipeline.fetch", 70, 80, 1, "batcher.dispatch"),
    rec("batcher.dispatch", 60, 84, 1),
    # a wait whose dispatch started before the window, the idle
    # collection after the window, and a dispatch in flight when the
    # profiler stopped (it ends after the last span's start): not counted
    rec("host_read", 90, 95, None, "model.generate"),
    rec("batcher.collect", 84, 5000, id=2),
    rec("batcher.collect", 96, 100, id=3),
    rec("batcher.dispatch", 100, 9000, id=3),
]

OFFLINE = [rec(n, i, i + 1, thread="MainThread")
           for i, n in enumerate(["host_read"] * 3 + ["model.generate"]
                                 + ["host_read"] * 3 + ["model.generate"])]


@pytest.fixture
def recorded(monkeypatch):
    def use(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs),
                            raising=False)
    return use


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_serve_readers(recorded):
    recorded(SERVE)
    ctx = {"kind": "serve"}
    # waits 10, 8, 6, 4, 2 and 30 ms
    assert read("queue_wait_p95_ms.serve", ctx) == pytest.approx(25.0)
    assert read("collect_ms_per_dispatch.serve", ctx) == pytest.approx(10.0)
    # (36 - 8 - 18) and (24 - 9 - 10)
    assert read("host_ms_per_dispatch.serve", ctx) == pytest.approx(7.5)


def test_host_reads_per_call(recorded):
    recorded(OFFLINE)
    ctx = {"kind": "offline"}
    assert read("host_reads_per_call.gen", ctx) == 3.0
    assert read("host_reads_per_call.char", ctx) == 3.0


NAMES = ["queue_wait_p95_ms.serve", "collect_ms_per_dispatch.serve",
         "host_ms_per_dispatch.serve", "host_reads_per_call.gen",
         "host_reads_per_call.char"]


@pytest.mark.parametrize("name", NAMES)
def test_none_off_kind_without_records_and_without_spans(recorded,
                                                         monkeypatch, name):
    kind = "serve" if name.endswith(".serve") else "offline"
    other = "offline" if kind == "serve" else "train"
    recorded(SERVE + OFFLINE)
    assert read(name, {"kind": kind}) is not None
    assert read(name, {"kind": other}) is None
    assert read(name, {}) is None
    recorded([])
    assert read(name, {"kind": kind}) is None
    # a program without span records (the commit before them)
    monkeypatch.delattr(profiling, "records", raising=False)
    assert read(name, {"kind": kind}) is None
