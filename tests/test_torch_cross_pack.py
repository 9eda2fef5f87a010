"""deephumor_tpu_torch's packed cross-attention (K9's twin) and the two
kernel-selecting switches (DH_CROSS_PACK, DH_FUSED_SURVIVOR) against the
JAX package on the CPU: the packed Pallas kernel in interpret mode, the
tile-padded cross store and widened mask of one decode step, and whole
greedy generations at the word and char test configs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deephumor_tpu.models import CaptioningTransformer as JaxModel
from deephumor_tpu.models import transformer as jtfm
from deephumor_tpu.ops import pallas_attention as pa
from deephumor_tpu_torch.models import CaptioningTransformer
from deephumor_tpu_torch.models import transformer as ttfm
from deephumor_tpu_torch.ops import attention as A
from deephumor_tpu_torch.ops import engine as E
from test_torch_model import _to_jax_tree

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

G, R, T, HEADS, DM = 8, 5, 12, 8, 64  # n_heads * r = 40, a multiple of 8
T_PAD = 16


def _cross_inputs(seed, masked_item=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    mask = rng.random((G, T)) < 0.4
    mask[:, 0] = False
    if masked_item is not None:
        mask[masked_item] = True  # every encoder row of one item masked
    bias = np.where(mask[:, None, :], -1e8, 0.0).astype(np.float32)
    pad = ((0, 0), (0, T_PAD - T), (0, 0))
    q, ek, ev = f(G * R, DM), f(G, T, DM), f(G, T, DM)
    if masked_item is not None:
        # small energies: -1e8 + e rounds to -1e8 (f32 steps of 8 there),
        # so the masked item's weights are exactly uniform
        q[masked_item * R:(masked_item + 1) * R] *= 0.1
    return dict(q=q, ek=ek, ev=ev, bias=bias,
                ekp=np.pad(ek, pad), evp=np.pad(ev, pad),
                # pad columns of any value: they are re-masked by t_real
                biasp=np.pad(bias, ((0, 0), (0, 0), (0, T_PAD - T)),
                             constant_values=7.0))


@pytest.mark.parametrize("ng", [2, 4])
def test_packed_twin_matches_jax_interpret(ng):
    x = _cross_inputs(0)
    want = pa.grouped_cross_attention(
        *(jnp.asarray(x[k]) for k in ("q", "ekp", "evp", "biasp")), groups=G,
        n_heads=HEADS, pack_items=ng, t_real=T, interpret=True)
    got = A.grouped_cross_attention(
        *(torch.from_numpy(x[k]) for k in ("q", "ekp", "evp", "biasp")),
        n_heads=HEADS, pack_items=ng, t_real=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("ng,live_items", [(2, None), (4, None), (4, 5),
                                           (8, 3)])
def test_packed_twin_matches_k2_twin_on_the_unpadded_store(ng, live_items):
    x = {k: torch.from_numpy(v) for k, v in _cross_inputs(1, 2).items()}
    got = A.grouped_cross_attention(
        x["q"], x["ekp"], x["evp"], x["biasp"], n_heads=HEADS,
        pack_items=ng, t_real=T, live_items=live_items)
    want = A.grouped_cross_attention_plain(
        x["q"], x["ek"], x["ev"], x["bias"], n_heads=HEADS,
        live_items=live_items)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # the fully masked item averages its T real rows, with no NaN
    uniform = x["ev"][2].mean(dim=0)
    torch.testing.assert_close(got[2 * R:3 * R],
                               uniform.expand(R, DM), atol=1e-5, rtol=1e-5)
    if live_items is not None:
        assert not got[live_items * R:].any()


@pytest.mark.parametrize("case", ["no t_real", "t_real past T", "bias T",
                                  "ng divides no G"])
def test_packed_wrapper_raises(case):
    x = {k: torch.from_numpy(v) for k, v in _cross_inputs(2).items()}
    kw = dict(n_heads=HEADS, pack_items=2, t_real=T)
    bias = x["biasp"]
    if case == "no t_real":
        kw["t_real"] = None
    elif case == "t_real past T":
        kw["t_real"] = T_PAD + 1
    elif case == "bias T":
        bias = x["bias"]  # covers the unpadded T only
    else:
        kw["pack_items"] = 3
    with pytest.raises(ValueError, match="t_real|padded T|divide"):
        A.grouped_cross_attention(x["q"], x["ekp"], x["evp"], bias, **kw)


# the word test config of test_torch_model.py
HP = dict(num_tokens=211, hid_dim=128, n_layers=2, n_heads=4, pf_dim=256,
          max_len=32)
GEN = dict(max_len=30, top_k=8)


@pytest.fixture(scope="module")
def word_models():
    tm = CaptioningTransformer(**HP)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    tp["decoder"]["classifier"]["bias"][3] = -2.0
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _to_jax_tree(tp))
    return JaxModel(**HP), jp, tm, tp


def test_pad_to_tile_matches_jax(word_models):
    _, jp, _, tp = word_models
    enc = np.random.default_rng(3).normal(size=(3, 49, 128)).astype(
        np.float32)
    want = jtfm.precompute_cross_attention(jp["decoder"], jnp.asarray(enc),
                                           pad_to_tile=True)
    got = ttfm.precompute_cross_attention(tp["decoder"],
                                          torch.from_numpy(enc),
                                          pad_to_tile=True)
    for g, w in zip(got, want):
        for k in ("ek", "ev"):
            assert g[k].shape == (3, 56, 128)
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=1e-5)
    # a store already a multiple of 8 stays as it is
    same = ttfm.precompute_cross_attention(tp["decoder"],
                                           torch.from_numpy(enc[:, :48]),
                                           pad_to_tile=True)
    assert same[0]["ek"].shape == (3, 48, 128)


@pytest.mark.parametrize("pack_items", [None, 2])
def test_decode_step_widens_the_mask_over_a_padded_store(word_models,
                                                         pack_items):
    # one decode step over the padded store (rows past t_real masked by
    # the widened encoder mask, or skipped by K9) equals the JAX package's
    # step over the same store, its kernels interpreted
    _, jp, _, tp = word_models
    items, beam, t_enc, d, mp, pos, p = 2, 2, 5, HP["hid_dim"], 31, 9, 32
    rows = items * beam
    rng = np.random.default_rng(pos)
    emb = rng.normal(size=(rows, d)).astype(np.float32)
    spatial = rng.normal(size=(items, t_enc, d)).astype(np.float32)
    spatial[1, 2, :] = 0.0  # a masked encoder row
    caches = [(rng.normal(size=(rows, p, d)).astype(np.float32),
               rng.normal(size=(rows, p, d)).astype(np.float32))
              for _ in range(HP["n_layers"])]
    anc = rng.integers(0, beam, size=(items, beam, mp)).astype(np.int32)
    valid = np.zeros((rows, mp), bool)
    valid[:, :pos + 1] = rng.random((rows, pos + 1)) < 0.8
    valid[:, 0] = valid[:, pos] = True
    mask = ~np.all(spatial != 0.0, axis=-1)

    jcross = jtfm.precompute_cross_attention(
        jp["decoder"], jnp.asarray(spatial), pad_to_tile=True)
    want, _ = jtfm.decode_step(
        jp["decoder"], jnp.asarray(emb), jnp.int32(pos),
        [{"k": jnp.asarray(k), "v": jnp.asarray(v)} for k, v in caches],
        jnp.asarray(valid), HP["n_heads"], cross=jcross,
        enc_key_mask=jnp.asarray(mask), anc=jnp.asarray(anc),
        attn_impl="pallas_interpret", p_eff=16, cross_t_real=t_enc)

    calls = []
    twin = A.cross_attention_packed_plain
    tcross = ttfm.precompute_cross_attention(
        tp["decoder"], torch.from_numpy(spatial), pad_to_tile=True)
    assert tcross[0]["ek"].shape[1] == 8
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(A, "cross_attention_packed_plain",
                    lambda *a, **k: calls.append(1) or twin(*a, **k))
        got, _ = ttfm.decode_step(
            tp["decoder"], torch.from_numpy(emb), pos,
            [{"k": torch.tensor(k), "v": torch.tensor(v)} for k, v in caches],
            torch.from_numpy(valid), HP["n_heads"], tcross,
            torch.from_numpy(mask), anc=torch.from_numpy(anc).long(),
            p_eff=16, cross_t_real=t_enc, pack_items=pack_items)
    assert len(calls) == (HP["n_layers"] if pack_items else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _spy_twins(monkeypatch):
    calls = {"packed": 0, "survivor": 0}
    packed, survivor = A.cross_attention_packed_plain, \
        E.fused_survivor_update_plain

    def spy_packed(*a, **k):
        calls["packed"] += 1
        return packed(*a, **k)

    def spy_survivor(*a, **k):
        calls["survivor"] += 1
        return survivor(*a, **k)

    monkeypatch.setattr(A, "cross_attention_packed_plain", spy_packed)
    monkeypatch.setattr(E, "fused_survivor_update_plain", spy_survivor)
    return calls


@pytest.mark.parametrize("beam", [3, 2])
def test_word_greedy_with_both_switches_matches_jax(word_models, monkeypatch,
                                                    beam):
    # beam 3 x 4 heads is 12 query rows per item: not a multiple of 8, so
    # (as in the JAX package) K2 runs over the padded store; beam 2 packs
    jm, jp, tm, tp = word_models
    imgs = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32) * 0.05
    calls = _spy_twins(monkeypatch)
    monkeypatch.setenv("DH_CROSS_PACK", "2")
    monkeypatch.setenv("DH_FUSED_SURVIVOR", "1")
    got = tm.generate(tp, torch.from_numpy(imgs), greedy=True,
                      beam_size=beam, **GEN)
    assert calls["survivor"] == GEN["max_len"] - 1
    assert calls["packed"] == (0 if beam == 3 else
                               HP["n_layers"] * (GEN["max_len"] - 1))
    want = jm.generate(jp, jnp.asarray(imgs), key=jax.random.PRNGKey(0),
                       greedy=True, beam_size=beam, attn="pallas_interpret",
                       **GEN)
    np.testing.assert_array_equal(got["chosen"].numpy(),
                                  np.asarray(want["chosen"]))
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))


def test_char_greedy_with_both_switches_matches_jax(monkeypatch):
    # the char test config of test_torch_char.py: compaction and canon
    # engage, and the packed twin runs on the permuted items' store
    from test_torch_char import GEN as C_GEN
    from test_torch_char import HP as C_HP
    from test_torch_char import N_ITEMS

    tm = CaptioningTransformer(**C_HP)
    tp = tm.init(torch.Generator().manual_seed(1), device="cpu")
    tp["decoder"]["classifier"]["bias"][3] = 0.0
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _to_jax_tree(tp))
    rng = np.random.default_rng(1)
    scale = np.linspace(0.3, 2.0, N_ITEMS, dtype=np.float32)[:, None]
    enc = (rng.normal(size=(N_ITEMS, 32)).astype(np.float32) * scale,
           rng.normal(size=(N_ITEMS, 49, 32)).astype(np.float32)
           * scale[:, :, None])
    calls = _spy_twins(monkeypatch)
    monkeypatch.setenv("DH_CROSS_PACK", "4")
    monkeypatch.setenv("DH_FUSED_SURVIVOR", "1")
    got = tm.generate_from_emb(tp, tuple(map(torch.from_numpy, enc)),
                               greedy=True, compact=True, canon=True,
                               **C_GEN)
    assert min(b["live"] or N_ITEMS for b in got["boundaries"]) < N_ITEMS
    assert any(b["stragglers"] for b in got["boundaries"])
    assert calls["packed"] == C_HP["n_layers"] * calls["survivor"] > 0
    want = JaxModel(**C_HP).generate_from_emb(
        jp, tuple(map(jnp.asarray, enc)), key=jax.random.PRNGKey(0),
        greedy=True, attn="pallas_interpret", compact=True, canon=True,
        **C_GEN)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["chosen"].numpy(),
                                  np.asarray(want["chosen"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-4)
