"""deephumor_tpu_torch attention (K1, K2 and their twins) against the JAX
package's Pallas kernels run in interpret mode on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deephumor_tpu.ops import pallas_attention as pa
from deephumor_tpu_torch.ops import attention as A

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


def _cross_inputs(seed, masked_group):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(G * R, D)).astype(np.float32)
    ek = rng.normal(size=(G, T, D)).astype(np.float32)
    ev = rng.normal(size=(G, T, D)).astype(np.float32)
    mask = rng.random((G, T)) < 0.3
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


def test_grouped_cross_attention_without_bias_matches_jax():
    q, ek, ev, _ = _cross_inputs(3, False)
    want = np.asarray(pa.grouped_cross_attention(
        jnp.asarray(q), jnp.asarray(ek), jnp.asarray(ev), None, groups=G,
        n_heads=H, interpret=True))
    got = A.grouped_cross_attention(
        torch.from_numpy(q), torch.from_numpy(ek), torch.from_numpy(ev), None,
        n_heads=H).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
