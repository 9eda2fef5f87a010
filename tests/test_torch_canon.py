"""deephumor_tpu_torch's canonical-prefix and compaction pieces against the
JAX package on the CPU: the K5 and K6 twins against the Pallas kernels
run in interpret mode, the K4 twin against JAX's top-k filter, the
live-item paths of K1 and K2, and the engine's boundary transforms
(``_compact_state``, ``_canonicalize_state``, ``_finalize_compaction``)
against the JAX static methods on the same state."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deephumor_tpu.models import CaptioningTransformer as JaxModel
from deephumor_tpu.models.sampling import filter_top_k
from deephumor_tpu.ops import pallas_attention as pa
from deephumor_tpu_torch.models import CaptioningTransformer
from deephumor_tpu_torch.ops import attention as A
from deephumor_tpu_torch.ops import sampler as S

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

B, BEAM, P, H, D = 4, 5, 32, 4, 64
ROWS = B * BEAM
C, PE, POS = 16, 24, 18  # canonical length, read budget, decode position


def _canon_setup(strag=(1,), seed=5):
    """A state where the live branches of every item but ``strag`` agree
    on their ancestry below C; position POS is valid everywhere."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v, k_new, v_new = (f(ROWS, D), f(ROWS, P, D), f(ROWS, P, D),
                             f(ROWS, D), f(ROWS, D))
    path = rng.integers(0, BEAM, size=(B, P))
    anc = np.broadcast_to(path[:, None, :], (B, BEAM, P)).copy()
    anc[:, :, C:] = rng.integers(0, BEAM, size=(B, BEAM, P - C))
    for b in strag:
        anc[b] = rng.integers(0, BEAM, size=(BEAM, P))
    valid = np.zeros((ROWS, P), bool)
    for b, n in enumerate(rng.integers(C + 1, PE, size=B)):
        valid[b * BEAM:(b + 1) * BEAM, :n] = True
        valid[b * BEAM:(b + 1) * BEAM, rng.integers(1, C, size=2)] = False
    valid[:, POS] = True
    shared_k = np.stack([k[b * BEAM + anc[b, 0, :C], np.arange(C)]
                         for b in range(B)])
    shared_v = np.stack([v[b * BEAM + anc[b, 0, :C], np.arange(C)]
                         for b in range(B)])
    bias_sh = np.where(valid.reshape(B, BEAM, P)[:, 0, :C], 0.0,
                       -1e8)[:, None, :].astype(np.float32)
    anc_j, valid_j = jnp.asarray(anc.astype(np.int32)), jnp.asarray(valid)
    bias_full = np.asarray(pa.ancestry_bias(anc_j, valid_j, P))
    bias_win = np.asarray(pa.ancestry_bias(
        anc_j[:, :, C:PE], valid_j[:, C:PE], PE - C))
    return dict(q=q, k=k, v=v, k_new=k_new, v_new=v_new, anc=anc,
                valid=valid, shared_k=shared_k, shared_v=shared_v,
                bias_sh=bias_sh, bias_win=bias_win, bias_full=bias_full,
                strag=strag)


def _t(x):
    return torch.from_numpy(np.array(x))


def _canon_args(s):
    return (_t(s["q"]), _t(s["k"]), _t(s["v"]), _t(s["shared_k"]),
            _t(s["shared_v"]), _t(s["k_new"]), _t(s["v_new"]),
            _t(s["bias_sh"]), _t(s["bias_win"]))


@pytest.mark.parametrize("live_items", [None, 3])
def test_canon_update_twin_matches_jax(live_items):
    s = _canon_setup()
    want, wk, wv = pa.ancestry_attention_update_canon(
        *map(jnp.asarray, (s["q"], s["k"], s["v"], s["shared_k"],
                           s["shared_v"], s["k_new"], s["v_new"],
                           s["bias_sh"], s["bias_win"])), POS, beam=BEAM,
        n_heads=H, c=C, p_eff=PE, interpret=True)
    args = _canon_args(s)
    got = A.ancestry_attention_update_canon(
        *args, POS, beam=BEAM, n_heads=H, c=C, p_eff=PE,
        live_items=live_items).numpy()
    live = B if live_items is None else live_items
    lr = live * BEAM
    # the caches are written in place for live items only
    for gc, wc, old in ((args[1], wk, s["k"]), (args[2], wv, s["v"])):
        np.testing.assert_array_equal(gc.numpy()[:lr], np.asarray(wc)[:lr])
        np.testing.assert_array_equal(gc.numpy()[lr:], old[lr:])
    want = np.asarray(want)
    for b in range(live):
        if b in s["strag"]:
            continue  # a stale shared path: recomputed by K6
        rows = slice(b * BEAM, (b + 1) * BEAM)
        np.testing.assert_allclose(got[rows], want[rows], atol=1e-5)
    assert not got[lr:].any()


@pytest.mark.parametrize("n_sel", [0, 2])
def test_ids_twin_matches_jax(n_sel):
    s = _canon_setup()
    ids = np.array([1, 3, 0, 2], np.int32)
    want = np.asarray(pa.ancestry_attention_ids(
        jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
        jnp.asarray(s["bias_full"]), jnp.asarray(ids), jnp.int32(n_sel),
        beam=BEAM, n_heads=H, p_eff=PE, interpret=True))
    got = A.ancestry_attention_ids(
        _t(s["q"]), _t(s["k"]), _t(s["v"]), _t(s["bias_full"]), _t(ids),
        n_sel, beam=BEAM, n_heads=H, p_eff=PE).numpy()
    # the grid is clamped to at least one item
    for b in range(B):
        rows = slice(b * BEAM, (b + 1) * BEAM)
        if b in ids[:max(n_sel, 1)]:
            np.testing.assert_allclose(got[rows], want[rows], atol=1e-5)
        else:
            assert not got[rows].any()


def test_canon_plus_ids_merge_equals_full_width():
    # what decode_step does: K5 for every item, K6 for the stragglers,
    # merged by row mask == K1's full-width attention, for every item
    s = _canon_setup(strag=(0, 2))
    args = _canon_args(s)
    attn = A.ancestry_attention_update_canon(
        *args, POS, beam=BEAM, n_heads=H, c=C, p_eff=PE)
    strag = torch.tensor([0, 2, 1, 3], dtype=torch.int32)
    out_s = A.ancestry_attention_ids(args[0], args[1], args[2],
                                     _t(s["bias_full"]), strag, 2,
                                     beam=BEAM, n_heads=H, p_eff=PE)
    rows = torch.tensor([b in (0, 2) for b in range(B)]).repeat_interleave(
        BEAM)
    merged = torch.where(rows[:, None], out_s, attn).numpy()
    want, _, _ = pa.ancestry_attention_update(
        *map(jnp.asarray, (s["q"], s["k"], s["v"], s["k_new"], s["v_new"],
                           s["bias_full"])), POS, beam=BEAM, n_heads=H,
        interpret=True, p_eff=PE)
    np.testing.assert_allclose(merged, np.asarray(want), atol=1e-5)


def test_live_items_in_k1_and_k2():
    s = _canon_setup()
    live = 2
    lr = live * BEAM
    args = [_t(s[n]) for n in ("q", "k", "v", "k_new", "v_new",
                               "bias_full")]
    got = A.ancestry_attention_update(*args, POS, beam=BEAM, n_heads=H,
                                      p_eff=PE, live_items=live).numpy()
    want, wk, _ = pa.ancestry_attention_update(
        *map(jnp.asarray, (s["q"], s["k"], s["v"], s["k_new"], s["v_new"],
                           s["bias_full"])), POS, beam=BEAM, n_heads=H,
        interpret=True, p_eff=PE)
    np.testing.assert_allclose(got[:lr], np.asarray(want)[:lr], atol=1e-5)
    assert not got[lr:].any()
    np.testing.assert_array_equal(args[1].numpy()[:lr], np.asarray(wk)[:lr])
    np.testing.assert_array_equal(args[1].numpy()[lr:], s["k"][lr:])

    rng = np.random.default_rng(3)
    ek, ev = (rng.normal(size=(B, 7, D)).astype(np.float32)
              for _ in range(2))
    mask = np.where(rng.random((B, 1, 7)) < 0.3, -1e8, 0.0).astype(
        np.float32)
    want = np.asarray(pa.grouped_cross_attention(
        jnp.asarray(s["q"]), jnp.asarray(ek), jnp.asarray(ev),
        jnp.asarray(mask), groups=B, n_heads=H, interpret=True))
    got = A.grouped_cross_attention(_t(s["q"]), _t(ek), _t(ev), _t(mask),
                                    n_heads=H, live_items=live).numpy()
    np.testing.assert_allclose(got[:lr], want[:lr], atol=1e-5)
    assert not got[lr:].any()


@pytest.mark.parametrize("live_rows", [None, 40])
def test_classifier_sampler_twin_draws_from_jax_support(live_rows):
    # values on a 1/16 grid: every product and sum is exact in f32, so the
    # bf16 rounding of the logits cannot depend on the summation order
    rng = np.random.default_rng(4)
    rows, d, v, k, draws = 64, 64, 96, 12, 5
    x = (rng.integers(-32, 33, size=(rows, d)) / 16).astype(np.float32)
    w = (rng.integers(-8, 9, size=(v, d)) / 16).astype(np.float32)
    b = (rng.integers(-64, 65, size=v) / 16).astype(np.float32)
    w[1] = 0.5  # make UNK a strong candidate
    logits = np.asarray((jnp.dot(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w.T, jnp.bfloat16),
                                 preferred_element_type=jnp.float32)
                         + b).astype(jnp.bfloat16).astype(jnp.float32))
    ids, vals = S.fused_classifier_topk_gumbel_sample(
        _t(x), _t(w), _t(b), 77, 1.3, top_k=k, num_draws=draws,
        live_rows=live_rows)
    ids, vals = ids.numpy(), vals.numpy()
    live = rows if live_rows is None else live_rows
    support = np.isfinite(np.asarray(filter_top_k(jnp.asarray(logits), k)))
    for r in range(live):
        assert support[r, ids[r]].all() and 1 not in ids[r]
        assert len(set(ids[r])) == draws
        np.testing.assert_array_equal(vals[r], logits[r, ids[r]])
    assert not ids[live:].any() and not vals[live:].any()
    # the same rows draw the same tokens whatever live_rows is: the noise
    # hashes the global row
    all_ids = S.fused_classifier_topk_gumbel_sample(
        _t(x), _t(w), _t(b), 77, 1.3, top_k=k, num_draws=draws)[0].numpy()
    np.testing.assert_array_equal(ids[:live], all_ids[:live])


def _engine_state(seed=0, items=6, beam=3, mp=41, d=16, t=5):
    """A mid-generation engine state: prefix-written caches, ancestry and
    validity, compaction bookkeeping, per-item cross K/V; about half the
    items have every branch ended."""
    rng = np.random.default_rng(seed)
    rows, p = items * beam, 48
    pref = 24
    k = np.zeros((rows, p, d), np.float32)
    v = np.zeros((rows, p, d), np.float32)
    k[:, :pref] = rng.normal(size=(rows, pref, d))
    v[:, :pref] = rng.normal(size=(rows, pref, d))
    anc = rng.integers(0, beam, size=(items, beam, mp))
    anc[0, :, :20] = anc[0, 0, :20]     # item 0 coalesced below 20
    anc[3, 1:, :20] = anc[3, 0, :20]    # item 3 too
    valid = rng.random((rows, mp)) < 0.9
    ended = rng.random((items, beam)) < 0.5
    ended[[1, 4]] = True
    ended[0] = [False, True, False]
    return {
        "cache": [{"k": k, "v": v}],
        "valid": valid, "anc": anc.astype(np.int32),
        "item_perm": rng.permutation(items).astype(np.int32),
        "live": np.int32(items),
        "cross": [{"ek": rng.normal(size=(items, t, d)).astype(np.float32),
                   "ev": rng.normal(size=(items, t, d)).astype(np.float32)}],
        "enc_key_mask": rng.random((items, t)) < 0.2,
        "pos": 24,
    }, (rng.integers(0, 50, size=(items, beam, 30)),
        rng.normal(size=(items, beam)).astype(np.float32), ended)


def _torch_state(st):
    conv = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    out = dict(st, valid=conv(st["valid"]), anc=conv(st["anc"]).long(),
               item_perm=conv(st["item_perm"]).long(), live=int(st["live"]),
               enc_key_mask=conv(st["enc_key_mask"]))
    out["cache"] = [{n: conv(x) for n, x in layer.items()}
                    for layer in st["cache"]]
    out["cross"] = [{n: conv(x) for n, x in c.items()} for c in st["cross"]]
    return out


def _jax_state(st):
    out = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in st.items()}
    out["cache"] = [{n: jnp.asarray(x) for n, x in layer.items()}
                    for layer in st["cache"]]
    out["cross"] = [{n: jnp.asarray(x) for n, x in c.items()}
                    for c in st["cross"]]
    return out


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        for key in want:
            _assert_tree_equal(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(got, torch.Tensor):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert got == int(want)


@pytest.mark.parametrize("prefix_positions", [None, 24])
def test_compact_state_matches_jax(prefix_positions):
    st, (seq, val, ended) = _engine_state()
    want = JaxModel._compact_state(_jax_state(st), jnp.asarray(seq),
                                   jnp.asarray(val), jnp.asarray(ended),
                                   prefix_positions=prefix_positions)
    got = CaptioningTransformer._compact_state(
        _torch_state(st), _t(seq), _t(val), _t(ended),
        prefix_positions=prefix_positions)
    assert 0 < got[0]["live"] == (~ended.all(axis=1)).sum() < 6
    _assert_tree_equal(got, want)


def test_canonicalize_state_matches_jax():
    st, (seq, val, ended) = _engine_state(seed=1)
    want = JaxModel._canonicalize_state(
        _jax_state(st), jnp.asarray(seq), jnp.asarray(val),
        jnp.asarray(ended), c=16)[0]
    got = CaptioningTransformer._canonicalize_state(
        _torch_state(st), _t(seq), _t(val), _t(ended), c=16)[0]
    assert 0 < got["n_strag"] < 6
    for key in ("shared", "bias_sh", "strag_ids", "n_strag", "strag_rows"):
        _assert_tree_equal(got[key], want[key])


def test_finalize_compaction_matches_jax():
    st, (seq, val, ended) = _engine_state(seed=2)
    out = {"sequences": seq, "scores": val, "ended": ended}
    want = JaxModel._finalize_compaction(
        _jax_state(st), {k: jnp.asarray(x) for k, x in out.items()})
    got = CaptioningTransformer._finalize_compaction(
        _torch_state(st), {k: _t(x) for k, x in out.items()})
    _assert_tree_equal(got, want)
