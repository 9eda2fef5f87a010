"""deephumor_tpu_torch's K3 sampler twin: the support of its draws against
the JAX package's ``filter_top_k``, its distribution, and its noise hash."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deephumor_tpu.models.sampling import filter_top_k
from deephumor_tpu_torch.ops import sampler as S

R, V, K, D = 16, 512, 16, 4


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _sample(logits, seed=7, inv_t=1.0, top_k=K, num_draws=D):
    ids, vals = S.fused_topk_gumbel_sample(
        logits, seed, inv_t, top_k=top_k, num_draws=num_draws)
    return ids.numpy(), vals.numpy()


def _jax_support(logits, top_k):
    """Columns JAX's filter_top_k keeps (finite) for f32 logits."""
    filt = np.asarray(filter_top_k(jnp.asarray(logits), top_k))
    return [set(np.flatnonzero(np.isfinite(row))) for row in filt]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_draws_within_jax_filter_support(dtype):
    logits = torch.from_numpy(
        np.random.default_rng(0).normal(size=(R, V)).astype(np.float32)
    ).to(dtype)
    ref = logits.float().numpy()
    ids, vals = _sample(logits)
    support = _jax_support(ref, K)
    for r in range(R):
        assert set(ids[r]) <= support[r]
        assert len(set(ids[r])) == D
        np.testing.assert_array_equal(vals[r], ref[r, ids[r]])


def test_no_replacement_and_unk_masked():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(R, V)).astype(np.float32)
    logits[:, 1] = 100.0  # UNK on top of every row
    ids, _ = _sample(_bf16(logits))
    support = _jax_support(_bf16(logits).float().numpy(), K)
    for r in range(R):
        assert len(set(ids[r])) == D and 1 not in ids[r]
        assert set(ids[r]) <= support[r]


def test_keep_ties_at_threshold():
    # 20 tied values at the top with top_k=16: all 20, and only they, are
    # eligible (the reference's `logits < kth` filter)
    base = np.full((8, V), -5.0, np.float32)
    tie_cols = np.arange(40, 60)
    base[:, tie_cols] = 2.0
    ids, _ = _sample(_bf16(base), seed=0, num_draws=8)
    assert set(ids.reshape(-1)) <= set(tie_cols)
    assert _jax_support(base, K)[0] == set(tie_cols)


def test_draws_only_from_filter_support():
    row = np.full((8, V), -10.0, np.float32)
    row[:, :3] = [2.0, 1.0, 0.0]
    ids, _ = _sample(_bf16(row), seed=0, top_k=3, num_draws=3)
    assert set(ids.reshape(-1)) <= {0, 1, 2}


def test_exhausted_support_falls_back_to_column_0():
    # top_k == num_draws with UNK inside the top-k: only two real
    # candidates, so the third draw returns column 0
    row = np.full((8, V), -10.0, np.float32)
    row[:, :3] = [3.0, 4.0, 1.0]
    row[:, 2] = 2.0
    ids, _ = _sample(_bf16(row), seed=0, top_k=3, num_draws=3)
    assert not (ids == 1).any()
    for r in range(ids.shape[0]):
        assert set(ids[r, :2]) == {0, 2}
        assert ids[r, 2] == 0


def test_first_draw_frequencies_match_softmax():
    # every row gets its own noise (row index in the hash), so identical
    # rows are independent samples of the first draw
    v, k, n, inv_t = 16, 6, 20000, 1.3
    logits = np.random.default_rng(2).normal(size=v).astype(np.float32)
    logits[1] = 5.0  # UNK would lead; it is never drawn
    rows = _bf16(np.tile(logits, (n, 1)))
    ids, _ = _sample(rows, seed=11, inv_t=inv_t, top_k=k, num_draws=2)
    ref = rows[0].float().numpy()
    keep = sorted(_jax_support(ref[None], k)[0])
    p = np.exp(ref[keep] * inv_t)
    p /= p.sum()
    freq = np.bincount(ids[:, 0], minlength=v) / n
    assert freq[[c for c in range(v) if c not in keep]].sum() == 0
    np.testing.assert_allclose(freq[keep], p, atol=0.015)


def test_seed_determinism():
    logits = _bf16(np.random.default_rng(3).normal(size=(R, V)))
    a, _ = _sample(logits, seed=3)
    b, _ = _sample(logits, seed=3)
    c, _ = _sample(logits, seed=4)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_noise_hash_known_values():
    # the CUDA kernel computes the same bits; these pin the function
    got = S.mix32(torch.tensor([0, 1, 2, 0x9E3779B9, 0xFFFFFFFF]))
    assert got.tolist() == [0, 1753845952, 3507691905, 33350994, 1734902346]
    bits = S.noise_bits(7, torch.arange(2), torch.arange(3))
    assert bits.tolist() == [[3475429279, 4241213211, 61273690],
                             [208202600, 1612423397, 4108635729]]
    far = S.noise_bits(2 ** 31 - 2, torch.tensor([8959]),
                       torch.tensor([29183]))
    assert far.tolist() == [[2337144217]]


def test_filter_top_k_matches_jax():
    from deephumor_tpu_torch.models.sampling import filter_top_k as port

    x = np.random.default_rng(5).normal(size=(R, V)).astype(np.float32)
    x[:4, 100:130] = 3.0  # ties at the threshold
    want = np.asarray(filter_top_k(jnp.asarray(x), K))
    np.testing.assert_array_equal(port(torch.from_numpy(x), K).numpy(), want)
