"""deephumor_tpu_torch attention (K1, K2 and their twins) against the JAX
package's Pallas kernels run in interpret mode on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deephumor_tpu.ops import pallas_attention as pa
from deephumor_tpu_torch.ops import attention as A

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

B, BEAM, P, H, D = 2, 3, 16, 4, 128
ROWS = B * BEAM
G, R, T = 3, 3, 7


def _update_inputs(seed, pos):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    anc = rng.integers(0, BEAM, size=(B, BEAM, P)).astype(np.int32)
    valid = np.zeros((ROWS, P), bool)
    valid[:, :pos + 1] = rng.random((ROWS, pos + 1)) < 0.7
    valid[:, 0] = valid[:, pos] = True
    return (f(ROWS, D), f(ROWS, P, D), f(ROWS, P, D), f(ROWS, D),
            f(ROWS, D), anc, valid)


def test_ancestry_bias_matches_jax():
    *_, anc, valid = _update_inputs(0, P - 1)
    want = np.asarray(pa.ancestry_bias(jnp.asarray(anc), jnp.asarray(valid),
                                       P))
    got = A.ancestry_bias(torch.from_numpy(anc).long(),
                          torch.from_numpy(valid), P)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos,p_eff", [(5, 8), (7, 8), (12, None)])
def test_ancestry_attention_update_twin_matches_jax(pos, p_eff):
    q, ck, cv, kn, vn, anc, valid = _update_inputs(1, pos)
    if p_eff is not None:
        assert p_eff < P
    bias = pa.ancestry_bias(jnp.asarray(anc), jnp.asarray(valid), P)
    out_j, ck_j, cv_j = pa.ancestry_attention_update(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn),
        jnp.asarray(vn), bias, pos, beam=BEAM, n_heads=H, interpret=True,
        p_eff=p_eff)
    ck_t, cv_t = torch.from_numpy(ck), torch.from_numpy(cv)
    out_t = A.ancestry_attention_update(
        torch.from_numpy(q), ck_t, cv_t, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.tensor(np.asarray(bias)), pos,
        beam=BEAM, n_heads=H, p_eff=p_eff)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-4)
    # the caches were written in place, exactly as the JAX kernel writes
    np.testing.assert_array_equal(ck_t.numpy(), np.asarray(ck_j))
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))


@pytest.mark.parametrize("items,pos", [(2, 127), (3, 64)])
def test_ancestry_attention_update_twin_matches_jax_at_char_length(items,
                                                                   pos):
    # the char settings with canon off: beam 7, cache length 136 read
    # through p_eff 128 (896 (slot, position) rows an item), two heads
    beam, p, p_eff, heads = 7, 136, 128, 2
    rows = items * beam
    rng = np.random.default_rng(30 + items)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, ck, cv, kn, vn = f(rows, D), f(rows, p, D), f(rows, p, D), f(rows, D), \
        f(rows, D)
    anc = rng.integers(0, beam, size=(items, beam, p)).astype(np.int32)
    valid = np.zeros((rows, p), bool)
    valid[:, :pos + 1] = rng.random((rows, pos + 1)) < 0.8
    valid[:, 0] = valid[:, pos] = True
    bias = pa.ancestry_bias(jnp.asarray(anc), jnp.asarray(valid), p)
    out_j, ck_j, cv_j = pa.ancestry_attention_update(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn),
        jnp.asarray(vn), bias, pos, beam=beam, n_heads=heads, interpret=True,
        p_eff=p_eff)
    ck_t, cv_t = torch.from_numpy(ck), torch.from_numpy(cv)
    out_t = A.ancestry_attention_update(
        torch.from_numpy(q), ck_t, cv_t, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.tensor(np.asarray(bias)), pos,
        beam=beam, n_heads=heads, p_eff=p_eff)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_array_equal(ck_t.numpy(), np.asarray(ck_j))
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))


def _cross_inputs(seed, masked_group, g=G, r=R, t=T):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(g * r, D)).astype(np.float32)
    ek = rng.normal(size=(g, t, D)).astype(np.float32)
    ev = rng.normal(size=(g, t, D)).astype(np.float32)
    mask = rng.random((g, t)) < 0.3
    mask[:, 0] = False
    if masked_group:
        mask[1] = True  # every encoder row of group 1 masked
    bias = np.where(mask[:, None, :], -1e8, 0.0).astype(np.float32)
    return q, ek, ev, bias


@pytest.mark.parametrize("masked_group", [True, False])
def test_grouped_cross_attention_twin_matches_jax(masked_group):
    q, ek, ev, bias = _cross_inputs(2, masked_group)
    want = np.asarray(pa.grouped_cross_attention(
        jnp.asarray(q), jnp.asarray(ek), jnp.asarray(ev), jnp.asarray(bias),
        groups=G, n_heads=H, interpret=True))
    got = A.grouped_cross_attention(
        torch.from_numpy(q), torch.from_numpy(ek), torch.from_numpy(ev),
        torch.from_numpy(bias), n_heads=H).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    if masked_group:
        # an all-masked group averages its values uniformly, with no NaN
        uniform = ev[1].mean(axis=0)
        for j in range(R):
            np.testing.assert_allclose(got[R + j], uniform, atol=1e-5)


@pytest.mark.parametrize("live_items", [None, 3, 0])
def test_grouped_cross_attention_twin_matches_jax_at_beam_7(live_items):
    # the char serving shape, narrow: beam 7 over 49 encoder rows (a 7 x 7
    # feature map), group 1's rows all masked; groups at or past live_items
    # get zero rows here (the JAX kernel skips their blocks)
    g, r, t = 5, 7, 49
    q, ek, ev, bias = _cross_inputs(4, True, g=g, r=r, t=t)
    want = np.asarray(pa.grouped_cross_attention(
        jnp.asarray(q), jnp.asarray(ek), jnp.asarray(ev), jnp.asarray(bias),
        groups=g, n_heads=H, interpret=True,
        live_items=None if live_items is None else jnp.int32(live_items)))
    got = A.grouped_cross_attention(
        torch.from_numpy(q), torch.from_numpy(ek), torch.from_numpy(ev),
        torch.from_numpy(bias), n_heads=H, live_items=live_items).numpy()
    live = g if live_items is None else live_items
    np.testing.assert_allclose(got[:live * r], want[:live * r], atol=1e-5,
                               rtol=1e-4)
    assert not got[live * r:].any()
    if live > 1:
        for j in range(r):
            np.testing.assert_allclose(got[r + j], ev[1].mean(axis=0),
                                       atol=1e-5)


def test_grouped_cross_attention_without_bias_matches_jax():
    q, ek, ev, _ = _cross_inputs(3, False)
    want = np.asarray(pa.grouped_cross_attention(
        jnp.asarray(q), jnp.asarray(ek), jnp.asarray(ev), None, groups=G,
        n_heads=H, interpret=True))
    got = A.grouped_cross_attention(
        torch.from_numpy(q), torch.from_numpy(ek), torch.from_numpy(ev), None,
        n_heads=H).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
