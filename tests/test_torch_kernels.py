"""deephumor_tpu_torch's CUDA kernels against their plain twins on the
card. Skipped without a CUDA device. This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from deephumor_tpu_torch.ops import LAUNCHES, reset_launch_counts
from deephumor_tpu_torch.ops import attention as A
from deephumor_tpu_torch.ops import sampler as S

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tol(dtype):
    # f32: summation order only; bf16: one rounding of each output
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p_eff", [8, 16, None])
def test_ancestry_attention_update_matches_twin(cuda, dtype, p_eff):
    items, beam, p, d, heads, pos = 7, 3, 24, 128, 4, 6
    rows = items * beam
    g = torch.Generator(cuda).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa
    q, kn, vn = rnd(rows, d), rnd(rows, d), rnd(rows, d)
    ck, cv = rnd(rows, p, d), rnd(rows, p, d)
    anc = torch.randint(0, beam, (items, beam, p), generator=g, device=cuda)
    valid = torch.rand(rows, p, generator=g, device=cuda) < 0.7
    valid[:, pos + 1:] = False
    valid[:, 0] = True
    bias = A.ancestry_bias(anc, valid, p)
    caches = [(ck.clone(), cv.clone()) for _ in range(2)]
    kw = dict(beam=beam, n_heads=heads, p_eff=p_eff)
    reset_launch_counts()
    got = A.ancestry_attention_update(q, *caches[0], kn, vn, bias, pos, **kw)
    want = A.ancestry_attention_update_plain(q, *caches[1], kn, vn, bias,
                                             pos, **kw)
    assert LAUNCHES["ancestry_attention_update"] == 1
    torch.testing.assert_close(got, want, atol=_tol(dtype), rtol=_tol(dtype))
    assert torch.equal(caches[0][0], caches[1][0])
    assert torch.equal(caches[0][1], caches[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_cross_attention_matches_twin(cuda, dtype):
    groups, r, t, d, heads = 9, 5, 49, 256, 4
    g = torch.Generator(cuda).manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa
    q, ek, ev = rnd(groups * r, d), rnd(groups, t, d), rnd(groups, t, d)
    mask = torch.rand(groups, t, generator=g, device=cuda) < 0.3
    mask[2] = True
    bias = torch.where(mask[:, None, :], A.MASK_FILL, 0.0).float()
    for b in (bias, None):
        got = A.grouped_cross_attention(q, ek, ev, b, n_heads=heads)
        want = A.grouped_cross_attention_plain(q, ek, ev, b, n_heads=heads)
        torch.testing.assert_close(got, want, atol=_tol(dtype),
                                   rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vocab", [3001, 100])
def test_topk_gumbel_sample_matches_twin(cuda, dtype, vocab):
    g = torch.Generator(cuda).manual_seed(2)
    logits = torch.randn(64, vocab, generator=g, device=cuda).to(dtype)
    logits[:8, 1] = 50.0         # UNK on top
    logits[8:16, 10:50] = 9.0    # ties across the threshold
    logits[16:24] = 0.5          # a whole row tied
    got = S.fused_topk_gumbel_sample(logits, 9, 0.8, top_k=32, num_draws=5)
    want = S.fused_topk_gumbel_sample_plain(logits, 9, 0.8, top_k=32,
                                            num_draws=5)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert not (got[0] == 1).any()


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(40, 8, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        S.fused_topk_gumbel_sample(x, 1, 1.0, top_k=4, num_draws=2)
    # head_dim 2 in bf16: rows of 4 bytes, not 16-byte vectors
    q = torch.randn(6, 8, device=cuda, dtype=torch.bfloat16)
    kv = torch.randn(2, 5, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        A.grouped_cross_attention(q, kv, kv, None, n_heads=4)
