"""deephumor_tpu_torch's long-generation path (the char serving config's
machinery: early-EOS compaction, canonical-prefix attention, the fused
classifier sampler) against the JAX package on the CPU, at small widths."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deephumor_tpu.models import CaptioningTransformer as JaxModel
from deephumor_tpu_torch.models import CaptioningTransformer
from deephumor_tpu_torch.models import sampling as TS
from deephumor_tpu_torch.ops import sampler as S
from test_torch_model import _to_jax_tree

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

HP = dict(num_tokens=64, hid_dim=32, n_layers=2, n_heads=2, pf_dim=64,
          max_len=80)
# 72 steps cross both compaction boundaries and every canon phase
GEN = dict(max_len=72, beam_size=4, top_k=8)
N_ITEMS = 12


@pytest.fixture(scope="module")
def models():
    tm = CaptioningTransformer(**HP)
    tp = tm.init(torch.Generator().manual_seed(1), device="cpu")
    tp["decoder"]["classifier"]["bias"][3] = 0.0
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _to_jax_tree(tp))
    # items at several feature scales end at different steps
    rng = np.random.default_rng(1)
    scale = np.linspace(0.3, 2.0, N_ITEMS, dtype=np.float32)[:, None]
    enc = (rng.normal(size=(N_ITEMS, 32)).astype(np.float32) * scale,
           rng.normal(size=(N_ITEMS, 49, 32)).astype(np.float32)
           * scale[:, :, None])
    return JaxModel(**HP), jp, tm, tp, enc


@pytest.fixture(scope="module")
def port_greedy(models):
    _, _, tm, tp, enc = models
    return tm.generate_from_emb(tp, tuple(map(torch.from_numpy, enc)),
                                greedy=True, compact=True, canon=True, **GEN)


@pytest.mark.parametrize("attn", ["pallas_interpret", "xla"])
def test_greedy_compact_canon_matches_jax(models, port_greedy, attn):
    jm, jp, _, _, enc = models
    got = port_greedy
    # the run really compacted (dead items moved out) and had stragglers
    assert [b["p_eff"] for b in got["boundaries"]] == [24, 40, 48, 56, 64]
    assert min(b["live"] or N_ITEMS for b in got["boundaries"]) < N_ITEMS
    assert any(b["stragglers"] for b in got["boundaries"])
    # JAX runs compaction and canon only inside its Pallas path
    flags = dict(compact=True, canon=True) if attn != "xla" else {}
    want = jm.generate_from_emb(jp, tuple(map(jnp.asarray, enc)),
                                key=jax.random.PRNGKey(0), greedy=True,
                                attn=attn, **flags, **GEN)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["chosen"].numpy(),
                                  np.asarray(want["chosen"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-4)


@pytest.mark.parametrize("compact", [False, True])
def test_stochastic_canon_draws_equal_full_width(models, compact):
    # canon changes how attention is computed, never its result: the same
    # generator gives the same draws with it on and off
    _, _, tm, tp, enc = models
    enc = tuple(map(torch.from_numpy, enc))
    outs = [tm.generate_from_emb(
        tp, enc, generator=torch.Generator().manual_seed(3),
        sampler="pallas", compact=compact, canon=canon, **GEN)
        for canon in (False, True)]
    assert any(b["stragglers"] for b in outs[1]["boundaries"])
    for key in ("sequences", "chosen", "scores", "ended"):
        assert torch.equal(outs[0][key], outs[1][key]), key
    seq = outs[1]["sequences"]
    assert ((seq >= 0) & (seq < HP["num_tokens"]) & (seq != 1)).all()


@pytest.mark.parametrize("num_items,max_len", [(32, 64), (31, 64),
                                               (32, 63)])
def test_default_schedule(num_items, max_len):
    # compaction is on by default from 32 items and 64 steps (after
    # p_eff 24 and 48 here); canon sets up before every phase with
    # p_eff >= 48 (c = p_eff - 16 >= 24), the last one included
    tm = CaptioningTransformer(**HP)
    tp = tm.init(torch.Generator().manual_seed(2), device="cpu")
    tp["decoder"]["classifier"]["bias"][3] = -5.0  # nothing ends early
    rng = np.random.default_rng(2)
    enc = (torch.from_numpy(rng.normal(size=(num_items, 32)).astype(
        np.float32)), torch.from_numpy(rng.normal(
            size=(num_items, 4, 32)).astype(np.float32)))
    out = tm.generate_from_emb(tp, enc, greedy=True, max_len=max_len,
                               beam_size=2, top_k=4)
    compacted = [b["p_eff"] for b in out["boundaries"]
                 if b["live"] is not None]
    canon = [b["p_eff"] for b in out["boundaries"]
             if b["stragglers"] is not None]
    assert compacted == ([24, 48] if (num_items, max_len) == (32, 64)
                         else [])
    assert canon == [40, 48, 56]
    assert not out["ended"].any()


def test_pallas_draw_routes_small_vocab_through_k4():
    # with a classifier of V <= 16384 the step's draw is K4 (hidden states
    # in, the classifier inside the sampler), rows past live_rows inert
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(12, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    tokens, scores = TS._topk_space_draw(
        None, x, 8, 4, 1.0, False, 1, sampler="pallas", classifier=(w, b),
        seed=5, live_rows=8)
    ids, vals = S.fused_classifier_topk_gumbel_sample_plain(
        x, w, b, 5, 1.0, top_k=8, num_draws=4, live_rows=8)
    assert torch.equal(tokens, ids) and not tokens[8:].any()
    torch.testing.assert_close(scores, vals - torch.logsumexp(
        vals, dim=-1, keepdim=True))
