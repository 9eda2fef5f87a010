"""The counts that a phase boundary leaves in device memory, on the CPU:
each twin of K1-K6, K9 and K10 given its count as a 0-d int32 tensor
(as a captured step passes it to the kernel) equals its int form, with
the rows below the count as the all-live call computes them and the
rows past it as the kernel leaves them; the K3/K4 twins given 1/T as a
0-d f32 tensor draw what the float draws. The card's kernels are held to
the same in tests/test_torch_kernels.py and ``chip_smoke.py``. Also the
test workers' cap on torch's CPU threads (ops/testing.py)."""

import numpy as np
import pytest
import torch

from deephumor_tpu_torch.models import sampling as TS
from deephumor_tpu_torch.ops import sampler as S
from deephumor_tpu_torch.ops import testing
from deephumor_tpu_torch.ops.testing import (COUNTED, cap_test_threads,
                                             count_rows, counted_calls)

cap_test_threads()

SHAPES = dict(items=8, beam=3, p=24, c=8, pe=16, d=32, n_heads=2, t_enc=5,
              vocab=40, top_k=8, length=12)


@pytest.fixture(scope="module")
def calls():
    return counted_calls(**SHAPES, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))


def _by_item(t, keep, beam):
    """``keep`` over items, widened to ``t``'s leading rows (an item's
    ``beam`` rows, or one)."""
    return keep.repeat_interleave(beam) if t.shape[0] != keep.shape[0] \
        else keep


@pytest.mark.parametrize("name", COUNTED)
@pytest.mark.parametrize("count", [0, 3, 8])
def test_twin_takes_a_device_count(calls, name, count):
    items, beam = SHAPES["items"], SHAPES["beam"]
    per, run = calls[name]
    got = run(torch.tensor(count * per, dtype=torch.int32))
    want = run(count * per)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # rows below the count as with every item live; the others as with no
    # item live (K6: no row selected is zero)
    full, none = run(items * per), run(0)
    keep = count_rows(name, count, items, beam)
    for i, (g, f, z) in enumerate(zip(got, full, none)):
        k = _by_item(g, keep, beam)
        assert torch.equal(g[k], f[k]), i
        if name == "ancestry_attention_ids":
            assert not g[~k].any()
        else:
            assert torch.equal(g[~k], z[~k]), i


def test_a_count_tensor_must_be_a_0d_int32():
    from deephumor_tpu_torch.ops import _build

    for bad in (torch.tensor([3], dtype=torch.int32),
                torch.tensor(3, dtype=torch.int64)):
        with pytest.raises(ValueError, match="0-d int32"):
            _build.count_args("k", 8, bad, torch.device("cpu"))
    assert _build.count_args("k", 8, 11, torch.device("cpu")) == (8, None)
    assert _build.count_args("k", 8, None, torch.device("cpu")) == (8, None)
    n = torch.tensor(3, dtype=torch.int32)
    assert _build.count_args("k", 8, n, torch.device("cpu")) == (
        8, n.data_ptr())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("temperature", [1.1, 0.7, 1.0])
def test_a_tensor_inv_t_draws_as_the_float(dtype, temperature):
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(20, 300, generator=g).to(dtype)
    x, w = torch.randn(20, 32, generator=g), torch.randn(64, 32, generator=g)
    b = torch.randn(64, generator=g)
    inv_t = TS.inv_temperature(temperature, "cpu")
    assert inv_t.dtype == torch.float32 and inv_t.ndim == 0
    assert inv_t.item() == float(np.float32(1.0 / temperature))
    kw = dict(top_k=8, num_draws=3, live_rows=15)
    for fn, args in ((S.fused_topk_gumbel_sample, (logits,)),
                     (S.fused_classifier_topk_gumbel_sample, (x, w, b))):
        want = fn(*args, 99, 1.0 / temperature, **kw)
        got = fn(*args, 99, inv_t, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # and the exact sampler's weights: a step multiplies by the tensor
    vals = torch.randn(6, 8, generator=g)
    assert torch.equal(vals * inv_t, vals * (1.0 / temperature))


@pytest.mark.parametrize("bad", [torch.tensor(0.9, dtype=torch.float64),
                                 torch.tensor([0.9])])
def test_sampler_rejects_a_bad_inv_t_tensor(bad):
    with pytest.raises(ValueError, match="1/T"):
        S.fused_topk_gumbel_sample(torch.randn(4, 64), 1, bad, top_k=4,
                                   num_draws=2)


@pytest.mark.parametrize("workers,cpus,before,after", [
    (None, 8, 8, 8), ("6", 8, 8, 1), ("2", 8, 8, 4), ("2", 8, 3, 3),
    ("16", 8, 8, 1)])
def test_cap_test_threads_takes_a_workers_share(monkeypatch, workers, cpus,
                                                before, after):
    # the share of the cores under xdist; never more threads than before
    saved = torch.get_num_threads()
    monkeypatch.setattr(testing.os, "cpu_count", lambda: cpus)
    if workers is None:
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    else:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
    try:
        torch.set_num_threads(before)
        assert cap_test_threads() == after == torch.get_num_threads()
    finally:
        torch.set_num_threads(saved)
