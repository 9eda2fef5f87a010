"""deephumor_tpu_torch's K7 (read-only ancestry attention), K8 (position-
tiled ancestry attention update) and K11 (cache column write) twins
against the JAX package's Pallas kernels run in interpret mode on the
CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deephumor_tpu.ops import pallas_attention as pa
from deephumor_tpu.ops import pallas_cache as pc
from deephumor_tpu_torch.ops import attention as A
from deephumor_tpu_torch.ops import cache as C

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

BEAM, P, H, D = 3, 16, 4, 128


def _inputs(seed, items, pos):
    rows = items * BEAM
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    anc = rng.integers(0, BEAM, size=(items, BEAM, P)).astype(np.int32)
    valid = np.zeros((rows, P), bool)
    valid[:, :pos + 1] = rng.random((rows, pos + 1)) < 0.7
    valid[:, 0] = valid[:, pos] = True
    bias = np.array(pa.ancestry_bias(jnp.asarray(anc), jnp.asarray(valid),
                                     P))
    return (f(rows, D), f(rows, P, D), f(rows, P, D), f(rows, D), f(rows, D),
            bias)


@pytest.mark.parametrize("items", [2, 1])
@pytest.mark.parametrize("p_eff", [None, 8])
@pytest.mark.parametrize("impl", ["native4d", "grouped", "blockdiag"])
def test_ancestry_attention_twin_matches_jax(impl, p_eff, items):
    # valid positions run to 12, past p_eff 8: native4d reads only the
    # first p_eff positions, the other two layouts every position
    q, ck, cv, _, _, bias = _inputs(10 + items, items, 12)
    want = np.asarray(pa.ancestry_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(bias),
        beam=BEAM, n_heads=H, interpret=True, impl=impl, p_eff=p_eff))
    t = [torch.from_numpy(x) for x in (q, ck, cv, bias)]
    got = A.ancestry_attention(*t, beam=BEAM, n_heads=H, impl=impl,
                               p_eff=p_eff).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    full = A.ancestry_attention(*t, beam=BEAM, n_heads=H).numpy()
    assert np.array_equal(got, full) == (impl != "native4d" or p_eff is None)
    # the caches are only read
    assert np.array_equal(t[1].numpy(), ck)


@pytest.mark.parametrize("pos", [0, 7, 8, 15])
def test_ancestry_attention_update_flash_twin_matches_jax(pos):
    q, ck, cv, kn, vn, bias = _inputs(20 + pos, 2, pos)
    out_j, ck_j, cv_j = pa.ancestry_attention_update_flash(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(bias), pos, beam=BEAM, n_heads=H,
        interpret=True)
    ck_t, cv_t = torch.from_numpy(ck), torch.from_numpy(cv)
    out_t = A.ancestry_attention_update_flash(
        torch.from_numpy(q), ck_t, cv_t, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.from_numpy(bias), pos, beam=BEAM,
        n_heads=H)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_array_equal(ck_t.numpy(), np.asarray(ck_j))
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))


def _column_inputs(seed, rows):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((rows, P, D), (rows, P, D), (rows, D), (rows, D))]


@pytest.mark.parametrize("pos", [0, 7, 9, 15])
def test_cache_column_write_twin_matches_jax(pos):
    ck, cv, kn, vn = _column_inputs(pos, 2 * BEAM)
    want = pc.cache_column_write(*map(jnp.asarray, (ck, cv, kn, vn)), pos,
                                 interpret=True)
    t = [torch.from_numpy(x) for x in (ck, cv, kn, vn)]
    got = C.cache_column_write(*t, pos)
    assert got[0] is t[0] and got[1] is t[1]  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(t[0].numpy()[:, pos], kn)
    others = np.arange(P) != pos
    np.testing.assert_array_equal(t[1].numpy()[:, others], cv[:, others])


def test_cache_column_write_casts_to_the_cache_dtype():
    # f32 new entries into bf16 caches, rounded as the JAX kernel rounds
    ck, cv, kn, vn = _column_inputs(1, 2 * BEAM)
    want = pc.cache_column_write(jnp.asarray(ck, jnp.bfloat16),
                                 jnp.asarray(cv, jnp.bfloat16),
                                 jnp.asarray(kn), jnp.asarray(vn), 5,
                                 interpret=True)
    caches = [torch.from_numpy(x).bfloat16() for x in (ck, cv)]
    got = C.cache_column_write(*caches, torch.from_numpy(kn),
                               torch.from_numpy(vn), 5)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))


def test_cache_column_write_takes_any_row_count():
    # 65 items x beam 5: no multiple-of-8 divisor of 325 rows, where the
    # JAX package's block search divides by zero
    ck, cv, kn, vn = _column_inputs(2, 325)
    with pytest.raises(ZeroDivisionError):
        pc.cache_column_write(*map(jnp.asarray, (ck, cv, kn, vn)), 4,
                              interpret=True)
    want_k, want_v = ck.copy(), cv.copy()
    want_k[:, 4], want_v[:, 4] = kn, vn
    got = C.cache_column_write(
        *[torch.from_numpy(x) for x in (ck, cv, kn, vn)], 4)
    np.testing.assert_array_equal(got[0].numpy(), want_k)
    np.testing.assert_array_equal(got[1].numpy(), want_v)


@pytest.mark.parametrize("case", ["impl", "p_eff", "flash P", "column pos",
                                  "column shape", "column dtypes"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    q, ck, cv, kn, vn, bias = (torch.from_numpy(x)
                               for x in _inputs(3, 2, 5))
    with pytest.raises(ValueError):
        if case == "impl":
            A.ancestry_attention(q, ck, cv, bias, beam=BEAM, n_heads=H,
                                 impl="tiled")
        elif case == "p_eff":
            A.ancestry_attention(q, ck, cv, bias, beam=BEAM, n_heads=H,
                                 p_eff=12)
        elif case == "flash P":
            A.ancestry_attention_update_flash(
                q, ck[:, :12].contiguous(), cv[:, :12].contiguous(), kn, vn,
                bias.reshape(2, BEAM, BEAM, P)[..., :12].reshape(
                    2, BEAM, -1).contiguous(), 5, beam=BEAM, n_heads=H)
        elif case == "column pos":
            C.cache_column_write(ck, cv, kn, vn, P)
        elif case == "column shape":
            C.cache_column_write(ck, cv, kn[:-1], vn[:-1], 0)
        else:
            C.cache_column_write(ck, cv, kn, vn.bfloat16(), 0)
