"""deephumor_tpu_torch's survivor update (K10's twin) against the JAX
package's pallas_engine on the CPU: its reference op sequence, and its real
kernel body under the TPU interpreter; then DH_FUSED_SURVIVOR=1 through
the port's generation."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from deephumor_tpu.ops import pallas_engine as pe
from deephumor_tpu_torch.models import CaptioningTransformer
from deephumor_tpu_torch.ops import engine as E

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

EOS, PAD = 3, 0
ITEMS, L, P = 8, 16, 24
NAMES = ("chosen", "val", "ended", "seq", "anc", "valid")


def _inputs(beam, seed):
    rng = np.random.default_rng(seed)
    new_idx = rng.integers(4, 60, (ITEMS, beam, beam))
    # planted EOS picks, so that ended propagation is exercised
    new_idx[0, 1, 2] = new_idx[3, 0, 0] = new_idx[5, beam - 1, 1] = EOS
    ended = rng.integers(0, 2, (ITEMS, beam)).astype(bool)
    ended[6] = True  # an item whose branches have all ended
    return dict(
        new_idx=new_idx,
        new_val=rng.normal(size=(ITEMS, beam, beam)).astype(np.float32),
        surv=rng.integers(0, beam * beam, (ITEMS, beam)),
        ended=ended,
        val=rng.normal(size=(ITEMS, beam)).astype(np.float32),
        seq=rng.integers(0, 60, (ITEMS, beam, L)),
        anc=rng.integers(0, beam, (ITEMS, beam, P)),
        valid=rng.integers(0, 2, (ITEMS, beam, P)).astype(bool))


def _jax_args(x):
    ints = ("new_idx", "surv", "seq", "anc")
    return [jnp.asarray(x[k], jnp.int32 if k in ints else None)
            for k in ("new_idx", "new_val", "surv", "ended", "val", "seq",
                      "anc", "valid")]


def _port(x, pos, beam, live_items=None):
    args = [torch.from_numpy(np.asarray(x[k])) for k in (
        "new_idx", "new_val", "surv", "ended", "val", "seq", "anc", "valid")]
    return E.fused_survivor_update(*args, pos, beam=beam, eos_index=EOS,
                                   pad_index=PAD, live_items=live_items)


@pytest.mark.parametrize("beam", [3, 5, 7])
def test_twin_matches_jax_reference(beam):
    x = _inputs(beam, beam)
    want = pe._reference_update(*_jax_args(x), jnp.int32(9), beam=beam,
                                eos_index=EOS, pad_index=PAD)
    got = _port(x, 9, beam)
    assert got[2][3].any() and got[2][6].all()
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("beam", [3, 5, 7])
@pytest.mark.parametrize("live_items", [None, 4])
def test_twin_matches_kernel_body_under_interpreter(beam, live_items):
    # the live prefix equals the kernel body's; dead items keep their
    # state (the JAX kernel does it by aliasing, which its interpreter does
    # not emulate, so they are held against the inputs) and get pad
    x = _inputs(beam, 10 + beam)
    with pltpu.force_tpu_interpret_mode():
        want = pe.fused_survivor_update(
            *_jax_args(x), jnp.int32(11), beam=beam, eos_index=EOS,
            pad_index=PAD, block_items=4, interpret=False,
            live_items=None if live_items is None else jnp.int32(live_items))
    got = _port(x, 11, beam, live_items)
    live = ITEMS if live_items is None else live_items
    for g, w, name in zip(got, want, NAMES):
        np.testing.assert_array_equal(g.numpy()[:live],
                                      np.asarray(w)[:live], err_msg=name)
        if name != "chosen":
            np.testing.assert_array_equal(g.numpy()[live:], x[name][live:],
                                          err_msg=name)
    assert (got[0][live:] == PAD).all()


def test_twin_leaves_dead_items_untouched():
    beam, live = 5, 3
    x = _inputs(beam, 20)
    got = _port(x, 4, beam, live)
    full = _port(x, 4, beam)
    for g, f, name in zip(got, full, NAMES):
        assert torch.equal(g[:live], f[:live]), name
        if name != "chosen":
            assert torch.equal(g[live:],
                               torch.from_numpy(x[name][live:])), name
    # the inputs themselves are not changed by the twin
    assert torch.equal(_port(x, 4, beam)[3], full[3])


@pytest.mark.parametrize("sampler,greedy", [("pallas", False),
                                            ("exact", True)])
def test_generation_with_fused_survivor_equals_default(monkeypatch, sampler,
                                                       greedy):
    # compaction off: K10's twin changes no draw, so the same generator
    # gives the same outputs with the switch on and off
    hp = dict(num_tokens=64, hid_dim=32, n_layers=2, n_heads=2, pf_dim=64,
              max_len=40)
    tm = CaptioningTransformer(**hp)
    tp = tm.init(torch.Generator().manual_seed(4), device="cpu")
    # some branches end before the last step, none ends at once
    tp["decoder"]["classifier"]["bias"][3] = -0.5
    rng = np.random.default_rng(4)
    enc = (torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32)),
           torch.from_numpy(rng.normal(size=(6, 49, 32)).astype(np.float32)))
    calls = []
    twin = E.fused_survivor_update_plain

    def spy(*a, **k):
        # the kernel reads raw pointers: the engine must hand it
        # contiguous tensors (the survivor picks are a slice of a sort)
        calls.append(all(t.is_contiguous() for t in a
                         if isinstance(t, torch.Tensor)))
        return twin(*a, **k)

    monkeypatch.setattr(E, "fused_survivor_update_plain", spy)

    def run():
        return tm.generate_from_emb(
            tp, enc, generator=torch.Generator().manual_seed(7),
            max_len=32, beam_size=4, top_k=8, temperature=1.1,
            sampler=sampler, greedy=greedy, compact=False)

    monkeypatch.delenv("DH_FUSED_SURVIVOR", raising=False)
    want = run()
    assert not calls
    monkeypatch.setenv("DH_FUSED_SURVIVOR", "1")
    got = run()
    assert len(calls) > 25 and all(calls)
    assert want["ended"].any() and not want["ended"].all()
    for key in ("sequences", "chosen", "scores", "ended"):
        assert torch.equal(got[key], want[key]), key


def test_generation_passes_live_rows_to_the_k3_path(monkeypatch):
    # V above the fused-classifier limit: the classifier is a bf16 matmul
    # and K3 draws; after the compaction at p_eff 24 three of the eight
    # items are live, and the draw skips the other rows. Dead items ignore
    # their draws, so the outputs equal those of draws over every row.
    from deephumor_tpu_torch.models import sampling

    hp = dict(num_tokens=16400, hid_dim=32, n_layers=2, n_heads=2, pf_dim=64,
              max_len=42)
    tm = CaptioningTransformer(**hp)
    tp = tm.init(torch.Generator().manual_seed(4), device="cpu")
    tp["decoder"]["classifier"]["bias"][3] = 1.0
    rng = np.random.default_rng(4)
    enc = (torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32)),
           torch.from_numpy(rng.normal(size=(8, 49, 32)).astype(np.float32)))
    real = sampling.fused_topk_gumbel_sample
    calls = []

    def run(drop_live_rows):
        def spy(logits, *a, **k):
            calls.append((logits.shape[0], k.get("live_rows")))
            if drop_live_rows:
                k.pop("live_rows", None)
            return real(logits, *a, **k)

        monkeypatch.setattr(sampling, "fused_topk_gumbel_sample", spy)
        return tm.generate_from_emb(
            tp, enc, generator=torch.Generator().manual_seed(7), max_len=40,
            beam_size=3, top_k=8, temperature=1.0, sampler="pallas",
            compact=True)

    got = run(False)
    assert got["boundaries"][0]["live"] == 3
    assert (24, 9) in calls  # 8 items x beam 3 rows, 3 x 3 of them live
    calls.clear()
    want = run(True)
    assert (24, 9) in calls
    for key in ("sequences", "chosen", "scores", "ended"):
        assert torch.equal(got[key], want[key]), key
