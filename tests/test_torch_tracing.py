"""The port's spans and counters (deephumor_tpu_torch/utils/profiling.py) on
the CPU: off without a profiler, on under one, cleared per window and
capped; in ``trace``'s Chrome trace from a thread the profiler did not
start; and where the program records them: the batcher's queue, collect
and dispatch with the pipeline's work inside it, and the host reads of a
generation call run as its graphs run."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from deephumor_tpu_torch.data import Vocab
from deephumor_tpu_torch.models import (CaptioningTransformer,
                                        CaptioningTransformerBase, graphs)
from deephumor_tpu_torch.models import sampling
from deephumor_tpu_torch.ops.testing import cap_test_threads
from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
from deephumor_tpu_torch.serving import DynamicBatcher
from deephumor_tpu_torch.utils import profiling

cap_test_threads()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _off_span():
    """A span, a count and a stamp while no profiler records; flips the
    module's state to "seen off" as every off call does."""
    with profiling.span("off"):
        pass
    profiling.count("off")
    assert profiling.stamp() is None


def test_the_profiler_flag_flips_on_every_thread():
    # the spans read torch's process-wide Python flag: on inside a
    # recording profiler, on a thread started before it too, off after
    seen, go, done = {}, threading.Event(), threading.Event()

    def worker():
        go.wait()
        seen["flag"] = autograd_profiler._is_profiler_enabled
        with profiling.span("worker"):
            pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    _off_span()
    assert not autograd_profiler._is_profiler_enabled
    with _profile():
        assert autograd_profiler._is_profiler_enabled
        go.set()
        done.wait(30)
    t.join()
    assert seen["flag"] is True
    assert not autograd_profiler._is_profiler_enabled
    assert "worker" in [r.name for r in profiling.records()]


def test_spans_off_call_no_record_function_and_no_clock(monkeypatch):
    before = profiling.records()

    def boom(*a, **k):
        raise AssertionError("called while off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", boom)
    for _ in range(3):
        _off_span()
        profiling.span_since("off", profiling.stamp(), id=1)
    assert profiling.records() == before
    assert profiling.span("a") is profiling.span("b")


def test_a_span_records_its_thread_parent_and_id():
    _off_span()
    with _profile():
        with profiling.span("outer", id=7):
            with profiling.span("inner"):
                time.sleep(0.002)
            with profiling.span("other", id=8):
                pass
        with profiling.span("alone"):
            pass
        start = profiling.stamp()
        profiling.count("things", 2)
        profiling.count("things")
        profiling.span_since("queued", start, id=3)
    recs = {r.name: r for r in profiling.records()}
    assert {"outer", "inner", "other", "alone", "queued"} <= set(recs)
    assert (recs["inner"].parent, recs["inner"].id) == ("outer", 7)
    assert (recs["other"].parent, recs["other"].id) == ("outer", 8)
    assert (recs["outer"].parent, recs["alone"].id) == (None, None)
    assert recs["inner"].thread == threading.current_thread().name
    assert (recs["queued"].thread, recs["queued"].id) == (None, 3)
    assert recs["outer"].start <= recs["inner"].start
    assert recs["inner"].end <= recs["outer"].end
    assert profiling.counts() == {"things": 3}
    s = profiling.summary()
    assert s["outer"]["count"] == 1
    inner_ms = (recs["inner"].end - recs["inner"].start) * 1e-6
    other_ms = (recs["other"].end - recs["other"].start) * 1e-6
    assert s["outer"]["self_ms"] == pytest.approx(
        s["outer"]["total_ms"] - inner_ms - other_ms)
    assert s["inner"]["self_ms"] == s["inner"]["total_ms"] >= 2.0


def test_a_span_started_while_on_is_kept_whole():
    _off_span()
    prof = _profile()
    prof.start()
    with profiling.span("across"):
        prof.stop()
        with profiling.span("after"):
            pass
    names = [r.name for r in profiling.records()]
    assert names == ["across"]


def test_records_clear_on_reenable_and_are_capped(monkeypatch):
    _off_span()
    with _profile():
        with profiling.span("first"):
            pass
    # still the first window's while off
    assert [r.name for r in profiling.records()] == ["first"]
    _off_span()
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with _profile():
        for i in range(5):
            with profiling.span("second", id=i):
                pass
    assert [r.id for r in profiling.records()] == [0, 1, 2]
    assert profiling.dropped() == 2
    _off_span()
    with _profile():
        profiling.count("third")
    assert profiling.records() == [] and profiling.dropped() == 0
    assert profiling.counts() == {"third": 1}


@pytest.mark.parametrize("all_threads", [True, False],
                         ids=["profiled", "from_records"])
def test_a_thread_started_before_the_trace_lands_in_it(
        tmp_path, monkeypatch, all_threads):
    # a span of a thread that the profiler did not start appears in
    # trace()'s trace.json on the trace's clock, inside the profiled
    # interval: recorded by the profiler where torch records every
    # thread, written from the records where it cannot
    if not all_threads:
        monkeypatch.setattr(profiling, "_all_threads", lambda: None)
    elif profiling._all_threads() is None:
        pytest.skip("this torch's profiler cannot record every thread")
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait()
        with profiling.span("worker.span"):
            time.sleep(0.01)
        done.set()

    t = threading.Thread(target=worker, name="dh-test-worker")
    t.start()
    _off_span()
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("main.span"):
            go.set()
            done.wait(30)
    t.join()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("ph") == "X" and e["name"] in ("main.span",
                                                     "worker.span")}
    main, work = spans["main.span"], spans["worker.span"]
    assert work["tid"] != main["tid"]
    assert main["ts"] <= work["ts"]
    assert work["ts"] + work["dur"] <= main["ts"] + main["dur"]
    assert work["dur"] >= 1e4


# -- where the program records them --------------------------------------

GEN = dict(max_len=6, beam_size=2, top_k=5)


@pytest.fixture(scope="module")
def pipe():
    vocab = Vocab(["when", "you", "ship", "it", "works", "and", "bug"])
    model = CaptioningTransformerBase(num_tokens=len(vocab), hid_dim=16,
                                      n_layers=1, n_heads=4, pf_dim=24,
                                      max_len=16)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    p = MemeGenerationPipeline(model, params, vocab)
    images = np.random.default_rng(0).normal(size=(3, 32, 32, 3))
    p.add_templates(["a", "b", "c"], images.astype(np.float32))
    return p


def test_batcher_spans_share_their_dispatch_id(pipe):
    _off_span()
    with DynamicBatcher(pipe, max_batch=4, max_wait_ms=30, **GEN) as srv:
        with _profile():
            futs = [srv.submit("abc"[i % 3]) for i in range(5)]
            futs += srv.submit_many(["a", "c", "b"])
            texts = [f.result(timeout=120) for f in futs]
    assert all(isinstance(t, str) for t in texts)
    recs = profiling.records()
    by = lambda name: [r for r in recs if r.name == name]  # noqa: E731
    dispatch = {r.id: r for r in by("batcher.dispatch")}
    assert sorted(dispatch) == list(range(len(srv.batch_sizes)))
    queued = by("batcher.queue")
    # one a request, each ending as its dispatch starts
    assert len(queued) == 8 == sum(srv.batch_sizes)
    assert sorted(np.bincount([r.id for r in queued])) == sorted(
        srv.batch_sizes)
    for r in queued:
        assert r.thread is None and r.start <= r.end
        assert dispatch[r.id].start <= r.end <= dispatch[r.id].end
    inside = ("pipeline.gather", "pipeline.fetch", "pipeline.decode",
              "batcher.resolve", "model.generate")
    for name in inside:
        got = by(name)
        assert len(got) == len(dispatch), name
        for r in got:
            assert (r.parent, r.thread) == ("batcher.dispatch", "dh-batcher")
            assert dispatch[r.id].start <= r.start <= r.end \
                <= dispatch[r.id].end
    # the eager loop's early-exit reads, inside each call
    reads = by("host_read")
    assert reads and all(r.parent == "model.generate" and r.id in dispatch
                         for r in reads)
    # each dispatch's collection carries its id and ends as it starts
    collects = {r.id: r for r in by("batcher.collect")}
    for i, d in dispatch.items():
        if i in collects:
            assert collects[i].parent is None
            assert collects[i].end <= d.start
    assert len(set(collects) & set(dispatch)) >= len(dispatch) - 1
    s = profiling.summary()
    assert s["batcher.dispatch"]["self_ms"] < s["batcher.dispatch"][
        "total_ms"]


def _program(model, params, enc, **kw):
    """The Program and inputs that ``generate_from_emb`` builds."""
    made, real = {}, graphs.generate

    def grab(make_program, inputs, gen, *, key, compiled=None):
        made["program"], made["inputs"] = make_program(), inputs
        return real(make_program, inputs, gen, key=key, compiled=compiled)

    graphs.generate = grab
    try:
        model.generate_from_emb(params, enc, **kw)
    finally:
        graphs.generate = real
    return made["program"], made["inputs"]


HP = dict(num_tokens=300, hid_dim=64, n_layers=2, n_heads=2, pf_dim=128)


@pytest.mark.parametrize("kind", ["word", "char"])
def test_host_reads_of_a_captured_call(kind):
    # the call as its graphs run it (graphs.run_captured): a host_read
    # span for each early-exit read that run_captured makes and, where a
    # boundary ran, the one read of the boundaries' counts after the
    # last graph; word's single phase reads once
    rng = np.random.default_rng(4)
    enc = (torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32)),
           torch.from_numpy(rng.normal(size=(8, 49, 64)).astype(
               np.float32)))
    if kind == "word":
        model = CaptioningTransformer(**HP, max_len=34)
        kw = dict(max_len=12, beam_size=3, top_k=8)
    else:
        model = CaptioningTransformer(**HP, max_len=80)
        kw = dict(max_len=72, beam_size=3, top_k=8, sampler="pallas",
                  temperature=1.1, compact=True)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params["decoder"]["classifier"]["bias"][3] = 1.0
    program, inputs = _program(model, params, enc, **kw)
    noise = sampling.draw_noise(torch.Generator().manual_seed(7),
                                program.noise, "cpu")
    search = program.begin(inputs, noise)
    checks = {"n": 0}
    real = search.all_ended

    def all_ended():
        checks["n"] += 1
        return real()

    search.all_ended = all_ended
    _off_span()
    with _profile():
        ran = graphs.run_captured(
            search, lambda i: search.run_segment(i, eager=False),
            lambda i: search.run_boundary(i, eager=False))
        out = program.read_out(program.finish(search), ran)
    reads = [r for r in profiling.records() if r.name == "host_read"]
    if kind == "word":
        assert (len(reads), ran, checks["n"]) == (1, 0, 1)
    else:
        assert ran > 0 and len(out["boundaries"]) == ran
        assert len(reads) == checks["n"] + 1


def test_the_attention_row_tally_folds_into_counters_per_window(
        monkeypatch):
    # the device tally of K1, K6 and K7 (ops/attention.py rows_tally) as
    # a sequence of totals; a fold reads it only while a profiler records
    dev = torch.device("cuda", 0)
    totals = iter([(100, 400), (130, 520), (150, 600), (190, 800),
                   (200, 840)])
    reads = []

    def read(device):
        reads.append(device)
        return next(totals)

    monkeypatch.setattr(sampling.attention, "rows_tally_totals", read)
    monkeypatch.setattr(sampling, "_FOLDED", {})
    _off_span()
    sampling.fold_rows_tally(dev)
    assert reads == []                  # off: no read of the device
    with _profile():
        sampling.fold_rows_tally(dev)   # the window's first fold: a mark
        assert "attn.rows_read" not in profiling.counts()
        sampling.fold_rows_tally(dev)
        sampling.fold_rows_tally(dev)
        assert profiling.counts()["attn.rows_read"] == 50
        assert profiling.counts()["attn.rows_span"] == 200
    assert len(reads) == 3
    _off_span()
    with _profile():                     # a new window starts afresh
        sampling.fold_rows_tally(dev)
        sampling.fold_rows_tally(dev)
        assert profiling.counts()["attn.rows_read"] == 10
        assert profiling.counts()["attn.rows_span"] == 40


def test_a_host_read_of_a_cpu_tensor_folds_nothing(monkeypatch):
    monkeypatch.setattr(sampling.attention, "rows_tally_totals",
                        lambda device: pytest.fail("read a tally"))
    _off_span()
    with _profile():
        assert sampling.host_read(torch.tensor([1, 2])) == [1, 2]
    assert "attn.rows_read" not in profiling.counts()
