"""deephumor_tpu_torch's CUDA kernels against their plain twins on the
card. Skipped without a CUDA device. This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from deephumor_tpu_torch.ops import LAUNCHES, reset_launch_counts
from deephumor_tpu_torch.ops import attention as A
from deephumor_tpu_torch.ops import cache as C
from deephumor_tpu_torch.ops import sampler as S
from deephumor_tpu_torch.ops.testing import (ancestry_rows, canon_state,
                                             searched_biases)

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

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
@pytest.mark.parametrize("beam,p,p_eff,pos,heads,d,live_items", [
    # the char settings with canon off: 7 x 128 (slot, position) rows,
    # more than a kernel staging the whole prefix could hold in either dtype
    (7, 136, 128, 127, 2, 128, None), (7, 136, 128, 127, 2, 128, 3),
    (7, 136, 120, 100, 8, 512, None),
    # beam 36: bf16 blocks of 32 and 4 branches
    (36, 16, None, 13, 4, 128, None), (36, 16, None, 13, 4, 128, 2),
    # head_dim 24 (D 96): bf16 off the tensor cores, on the CUDA-core kernel
    (5, 40, 32, 31, 4, 96, None), (5, 40, 32, 31, 4, 96, 4)])
def test_ancestry_attention_update_at_wide_shapes(cuda, dtype, beam, p, p_eff,
                                                  pos, heads, d, live_items):
    items = 5
    q, ck, cv, kn, vn, bias = _attention_inputs(cuda, dtype, 14, items, beam,
                                                p, d, pos)
    caches = [(ck.clone(), cv.clone()) for _ in range(2)]
    kw = dict(beam=beam, n_heads=heads, p_eff=p_eff, live_items=live_items)
    reset_launch_counts()
    got = A.ancestry_attention_update(q, *caches[0], kn, vn, bias, pos, **kw)
    want = A.ancestry_attention_update_plain(q, *caches[1], kn, vn, bias,
                                             pos, **kw)
    assert LAUNCHES["ancestry_attention_update"] == 1
    torch.testing.assert_close(got, want, atol=_tol(dtype), rtol=_tol(dtype))
    assert torch.equal(caches[0][0], caches[1][0])
    assert torch.equal(caches[0][1], caches[1][1])
    if live_items is not None:
        assert not got[live_items * beam:].any()
        assert torch.equal(caches[0][0][live_items * beam:],
                           ck[live_items * beam:])


@pytest.mark.cuda
def test_ancestry_attention_update_refuses_what_no_block_holds(cuda):
    # f32, beam 32 x 2048 positions: the energies alone (8 MB) are far past
    # any block's shared memory; the wrapper raises before the launch
    q, ck, cv, kn, vn, bias = _attention_inputs(cuda, torch.float32, 15, 1,
                                                32, 2048, 64, 5)
    reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        A.ancestry_attention_update(q, ck, cv, kn, vn, bias, 5, beam=32,
                                    n_heads=2)
    assert LAUNCHES["ancestry_attention_update"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("groups,beam,d,heads", [
    (9, 5, 256, 4), (600, 5, 512, 8), (600, 7, 512, 8), (600, 7, 192, 8)])
@pytest.mark.parametrize("live_items", [None, 0, 500])
@pytest.mark.parametrize("masked", [True, False])
def test_grouped_cross_attention_matches_twin(cuda, dtype, groups, beam, d,
                                              heads, live_items, masked):
    # T 49 (a 7 x 7 feature map); head_dim 64 (bf16 on the tensor cores) or
    # 24 (the CUDA-core kernel); item 2's rows all masked, or no bias;
    # items at or past live_items zero
    t = 49
    g = torch.Generator(cuda).manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa
    q, ek, ev = rnd(groups * beam, d), rnd(groups, t, d), rnd(groups, t, d)
    bias = None
    if masked:
        mask = torch.rand(groups, t, generator=g, device=cuda) < 0.3
        mask[2] = True
        bias = torch.where(mask[:, None, :], A.MASK_FILL, 0.0).float()
    kw = dict(n_heads=heads, live_items=live_items)
    reset_launch_counts()
    got = A.grouped_cross_attention(q, ek, ev, bias, **kw)
    assert LAUNCHES["grouped_cross_attention"] == 1
    want = A.grouped_cross_attention_plain(q, ek, ev, bias, **kw)
    torch.testing.assert_close(got, want, atol=_tol(dtype), rtol=_tol(dtype))
    assert torch.isfinite(got.float()).all()
    live = groups if live_items is None else min(live_items, groups)
    assert not got[live * beam:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,vocab,top_k,draws", [
    *((dt, *c) for dt in DTYPES for c in (
        (29184, 64, 5), (29184, 5, 5), (3001, 7, 7), (100, 50, 7),
        (128, 50, 7))),
    (torch.float32, 52000, 64, 5), (torch.float32, 56031, 64, 5),
    (torch.bfloat16, 104000, 64, 5), (torch.bfloat16, 112062, 64, 5)])
def test_topk_gumbel_sample_planted_rows_match_twin(cuda, dtype, vocab,
                                                    top_k, draws):
    # 1000 rows: each team of the kernel walks several; planted rows: UNK
    # the row's maximum, one value throughout, 2048 tied at the top (the
    # candidate list overflows), ties at the k-th largest. Rows of 52000
    # f32 or 104000 bf16 logits and longer leave no room for the vector
    # table beside a full list; 56031 f32 and 112062 bf16 (224 KB) leave a
    # block under 8 KB for the rest
    g = torch.Generator(cuda).manual_seed(17)
    logits = torch.randn(1000, vocab, generator=g, device=cuda).to(dtype)
    logits[:8, 1] = 50.0
    logits[8:16] = 0.5
    if vocab >= 2048:
        logits[16:24, :2048] = 7.0
    c0 = min(100, vocab - 40)
    logits[24:32, c0:c0 + 40] = logits[24:32].float().topk(
        top_k, dim=1).values[:, -1:].to(dtype)
    kw = dict(top_k=top_k, num_draws=draws)
    reset_launch_counts()
    got = S.fused_topk_gumbel_sample(logits, 21, 0.9, **kw)
    assert LAUNCHES["fused_topk_gumbel_sample"] == 1
    want = S.fused_topk_gumbel_sample_plain(logits, 21, 0.9, **kw)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert not (got[0] == 1).any()


@pytest.mark.cuda
def test_topk_gumbel_sample_refuses_what_no_block_holds(cuda):
    # one f32 row of 2**17 logits (512 KB) is past any block's shared memory
    logits = torch.zeros(2, 2 ** 17, device=cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        S.fused_topk_gumbel_sample(logits, 1, 1.0, top_k=4, num_draws=2)
    assert LAUNCHES["fused_topk_gumbel_sample"] == 0


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("live_rows", [32, 1, 0])
def test_topk_gumbel_sample_live_rows_match_twin(cuda, dtype, live_rows):
    # rows at or past live_rows get id 0 and value 0; a live row draws what
    # it draws in the full call (the noise hashes the global row)
    g = torch.Generator(cuda).manual_seed(13)
    logits = torch.randn(64, 3001, generator=g, device=cuda).to(dtype)
    logits[:8, 1] = 50.0  # UNK on top
    kw = dict(top_k=32, num_draws=5, live_rows=live_rows)
    reset_launch_counts()
    got = S.fused_topk_gumbel_sample(logits, 9, 0.8, **kw)
    assert LAUNCHES["fused_topk_gumbel_sample"] == (1 if live_rows else 0)
    want = S.fused_topk_gumbel_sample_plain(logits, 9, 0.8, **kw)
    full = S.fused_topk_gumbel_sample(logits, 9, 0.8, top_k=32, num_draws=5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[0][live_rows:].any() and not got[1][live_rows:].any()
    assert torch.equal(got[0][:live_rows], full[0][:live_rows])
    assert torch.equal(got[1][:live_rows], full[1][:live_rows])


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
    # head_dim 8 in bf16: 16-byte rows, but narrower than the 16-wide
    # tensor-core tiles of the K5, K6 and K7 kernels
    g = torch.Generator(cuda).manual_seed(12)
    s = canon_state(items=2, beam=3, p=8, c=4, pe=8, d=16,
                    dtype=torch.bfloat16, generator=g, stragglers=[0])
    args = (s["q"], s["ck"], s["cv"])
    ids = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        A.ancestry_attention(*args, s["bias"], beam=3, n_heads=2)
    with pytest.raises(ValueError, match="multiple of 16"):
        A.ancestry_attention_ids(*args, s["bias"], ids, 1, beam=3, n_heads=2)
    with pytest.raises(ValueError, match="multiple of 16"):
        A.ancestry_attention_update_canon(
            *args, s["sk"], s["sv"], s["kn"], s["vn"], s["bias_sh"],
            s["bias_win"], s["pos"], beam=3, n_heads=2, c=4, p_eff=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("live_items", [None, 5])
@pytest.mark.parametrize("beam,c,pe,pos", [
    (7, 24, 40, 33),     # joined support n = c + beam * w = 136
    (3, 21, 29, 25),     # w 8, narrower than a 16-row tile; n 45
    (5, 37, 45, 44),     # n 77: neither c nor n a multiple of 16
    (7, 13, 40, 20),     # n 202: four 64-row tiles, the last ragged
    (7, 120, 128, 127),  # the char leg's last phase: w 8, n 176
    (12, 30, 38, 33),    # beam 12: two 8-wide n-tiles in bf16; n 126
    (40, 10, 14, 12)])   # beam 40: bf16 blocks of 32 and 8 branches; n 170
def test_canon_update_matches_twin(cuda, dtype, live_items, beam, c, pe,
                                   pos):
    items, p, d, heads = 9, 136, 128, 2
    g = torch.Generator(cuda).manual_seed(3)
    s = canon_state(items=items, beam=beam, p=p, c=c, pe=pe, d=d,
                    dtype=dtype, generator=g, stragglers=range(1, items, 2),
                    pos=pos)
    caches = [(s["ck"].clone(), s["cv"].clone()) for _ in range(2)]
    args = (s["sk"], s["sv"], s["kn"], s["vn"], s["bias_sh"], s["bias_win"],
            s["pos"])
    kw = dict(beam=beam, n_heads=heads, c=c, p_eff=pe, live_items=live_items)
    reset_launch_counts()
    got = A.ancestry_attention_update_canon(s["q"], *caches[0], *args, **kw)
    want = A.ancestry_attention_update_canon_plain(s["q"], *caches[1], *args,
                                                   **kw)
    assert LAUNCHES["ancestry_attention_update_canon"] == 1
    torch.testing.assert_close(got, want, atol=_tol(dtype), rtol=_tol(dtype))
    assert torch.equal(caches[0][0], caches[1][0])
    assert torch.equal(caches[0][1], caches[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("beam,pe,n_sel,items,heads", [
    (3, 24, 2, 6, 2), (5, 40, 1, 6, 2), (7, 128, 3, 6, 2),
    (7, 128, 0, 6, 2), (5, 33, 4, 6, 2),
    # beam 12 and 20: two and four 8-wide n-tiles in bf16
    (12, 24, 3, 6, 2), (20, 24, 2, 6, 2),
    # beam 40: two bf16 blocks (32 and 8 branches) per (item, head)
    (40, 20, 2, 6, 2),
    # 80 items x 8 heads: more blocks than the SMs hold at once
    (7, 128, 80, 96, 8)])
def test_ids_matches_twin(cuda, dtype, beam, pe, n_sel, items, heads):
    # beam 7 x p_eff 128 is 896 (slot, position) rows: more than one block
    # could stage at once, in f32 above all, so the kernels tile them; a
    # few items spread each (item, head) over a cluster of bf16 blocks (3
    # items: four blocks take 3, 4, 3 and 4 of the 14 tiles); beam 5 x
    # p_eff 33 is 165 rows, a ragged last tile
    p, d = 136, 64 * heads
    g = torch.Generator(cuda).manual_seed(4)
    s = canon_state(items=items, beam=beam, p=p, c=16, pe=pe, d=d,
                    dtype=dtype, generator=g, stragglers=range(1, items, 2))
    args = (s["q"], s["ck"], s["cv"], s["bias"])
    ids = torch.randperm(items, generator=g, device=cuda).to(torch.int32)
    kw = dict(beam=beam, n_heads=heads, p_eff=pe)
    got = A.ancestry_attention_ids(*args, ids, n_sel, **kw)
    want = A.ancestry_attention_ids_plain(*args, ids, n_sel, **kw)
    rows = (ids[:max(n_sel, 1), None].long() * beam
            + torch.arange(beam, device=cuda)).reshape(-1)
    torch.testing.assert_close(got[rows], want[rows], atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_live_items_in_k1_and_k2(cuda, dtype):
    items, beam, p, d, heads, pos, live = 7, 3, 24, 128, 4, 6, 4
    rows, lr = items * beam, live * beam
    g = torch.Generator(cuda).manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa
    q, kn, vn, ck, cv = (rnd(rows, d), rnd(rows, d), rnd(rows, d),
                         rnd(rows, p, d), rnd(rows, p, d))
    anc = torch.randint(0, beam, (items, beam, p), generator=g, device=cuda)
    valid = torch.ones(rows, p, dtype=torch.bool, device=cuda)
    bias = A.ancestry_bias(anc, valid, p)
    caches = [(ck.clone(), cv.clone()) for _ in range(2)]
    kw = dict(beam=beam, n_heads=heads, p_eff=8, live_items=live)
    got = A.ancestry_attention_update(q, *caches[0], kn, vn, bias, pos, **kw)
    want = A.ancestry_attention_update_plain(q, *caches[1], kn, vn, bias,
                                             pos, **kw)
    torch.testing.assert_close(got, want, atol=_tol(dtype), rtol=_tol(dtype))
    assert not got[lr:].any()
    assert torch.equal(caches[0][0], caches[1][0])
    assert torch.equal(caches[0][0][lr:], ck[lr:])
    ek, ev = rnd(items, 49, d), rnd(items, 49, d)
    got = A.grouped_cross_attention(q, ek, ev, None, n_heads=heads,
                                    live_items=live)
    want = A.grouped_cross_attention_plain(q, ek, ev, None, n_heads=heads,
                                           live_items=live)
    torch.testing.assert_close(got, want, atol=_tol(dtype), rtol=_tol(dtype))
    assert not got[lr:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_topk_gumbel_sample_reads_a_device_seed(cuda, dtype):
    # a captured decode step passes its seed as a one-element int32 tensor
    # that the kernel reads at launch: the same value draws the same ids
    g = torch.Generator(cuda).manual_seed(3)
    logits = torch.randn(96, 3001, generator=g, device=cuda).to(dtype)
    seeds = torch.tensor([7, 123456, 9], dtype=torch.int32, device=cuda)
    kw = dict(top_k=32, num_draws=5, live_rows=80)
    reset_launch_counts()
    got = S.fused_topk_gumbel_sample(logits, seeds[1:2], 0.8, **kw)
    assert LAUNCHES["fused_topk_gumbel_sample"] == 1
    want = S.fused_topk_gumbel_sample(logits, 123456, 0.8, **kw)
    twin = S.fused_topk_gumbel_sample_plain(logits, seeds[1:2], 0.8, **kw)
    for ref in (want, twin):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    seeds[1] = 7  # the kernel reads the value at its launch
    again = S.fused_topk_gumbel_sample(logits, seeds[1:2], 0.8, **kw)
    first = S.fused_topk_gumbel_sample(logits, 7, 0.8, **kw)
    assert torch.equal(again[0], first[0])
    assert not torch.equal(again[0], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("vocab,d", [(128, 512), (2006, 512)])
def test_classifier_sample_reads_a_device_seed(cuda, vocab, d):
    # the resident (V 128) and the streamed (V 2,006) bodies
    g = torch.Generator(cuda).manual_seed(4)
    x = torch.randn(640, d, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(vocab, d, generator=g, device=cuda) / 8).to(
        torch.bfloat16)
    b = torch.randn(vocab, generator=g, device=cuda)
    seed = torch.tensor([4321], dtype=torch.int32, device=cuda)
    kw = dict(top_k=50, num_draws=5, live_rows=600)
    got = S.fused_classifier_topk_gumbel_sample(x, w, b, seed, 0.9, **kw)
    want = S.fused_classifier_topk_gumbel_sample(x, w, b, 4321, 0.9, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    twin = S.fused_classifier_topk_gumbel_sample_plain(x, w, b, seed, 0.9,
                                                       **kw)
    # the product's summation order may move a bf16 rounding by one ulp
    assert (got[0] == twin[0]).all(dim=1).float().mean().item() >= 0.99


def _classifier_case(cuda, dtype, rows, d, vocab, live_rows):
    """K4 and its twin on seeded inputs (UNK on top of every row); checks
    the launch, the dead rows and the draws, and returns what the vals
    checks need."""
    top_k, draws = 50, 7
    g = torch.Generator(cuda).manual_seed(6)
    x = torch.randn(rows, d, generator=g, device=cuda).to(dtype)
    w = (torch.randn(vocab, d, generator=g, device=cuda) / 8).to(dtype)
    b = torch.randn(vocab, generator=g, device=cuda)
    b[1] = 30.0  # UNK on top
    kw = dict(top_k=top_k, num_draws=draws, live_rows=live_rows)
    reset_launch_counts()
    ids, vals = S.fused_classifier_topk_gumbel_sample(x, w, b, 11, 0.9, **kw)
    ids_p, vals_p = S.fused_classifier_topk_gumbel_sample_plain(
        x, w, b, 11, 0.9, **kw)
    assert LAUNCHES["fused_classifier_topk_gumbel_sample"] == 1
    assert ids.dtype == torch.int64 and ids.shape == (rows, draws)
    live = rows if live_rows is None else live_rows
    assert not ids[live:].any() and not vals[live:].any()
    # the product's summation order may move a bf16 rounding by one ulp
    same = (ids == ids_p).all(dim=1).float().mean().item()
    assert same >= 0.99
    logits = S.classifier_logits(x[:live], w, b).float()
    kth = logits.topk(top_k, dim=1).values[:, -1:]
    assert (logits.gather(1, ids[:live]) >= kth).all()
    assert not (ids == 1).any()
    srt = ids[:live].sort(dim=1).values
    assert (srt[:, 1:] != srt[:, :-1]).all()
    eq = (ids == ids_p).all(dim=1)
    return x, w, b, ids, vals, vals_p, eq


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,vocab,live_rows", [
    (448, 512, 128, None), (448, 512, 128, 300), (448, 512, 1000, None),
    (448, 512, 8192, 300),
    # V past the resident path (W streamed), at FUSED_CLASSIFIER_MAX_V
    (64, 512, 16384, 50),
    # V not a multiple of 16 (W's pad rows), and the largest resident V
    (448, 512, 100, None), (448, 256, 256, 300),
    # D 256 (two blocks an SM)
    (448, 256, 128, None),
    # fewer rows than one 16-row tile; no live row; a row past a tile
    # boundary, in rows and in live_rows
    (5, 512, 128, None), (448, 512, 128, 0), (33, 512, 128, None),
    (448, 512, 128, 17),
    # the demo's word leg (streamed, V % 16 != 0)
    (640, 64, 506, None)])
def test_classifier_topk_gumbel_matches_twin(cuda, dtype, rows, d, vocab,
                                             live_rows):
    _, _, _, _, vals, vals_p, eq = _classifier_case(cuda, dtype, rows, d,
                                                    vocab, live_rows)
    assert torch.equal(vals[eq], vals_p[eq])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,vocab,live_rows", [
    # the char step: blocks walk several tiles through both x buffers; a
    # late step's 1,120 live rows; D 768 (W too large to stay resident)
    (5376, 512, 128, None), (5376, 512, 128, 1120), (448, 768, 128, 300),
    # the streamed path: the sweep's step, all and half its rows live; the
    # smallest streamed V; the top of the range, in two chunks of rows;
    # D 768 past V 256
    (1280, 512, 2006, None), (1280, 512, 2006, 640), (448, 512, 257, 300),
    (1280, 512, 16384, 700), (448, 768, 2006, None)])
def test_classifier_topk_gumbel_at_serving_rows(cuda, dtype, rows, d, vocab,
                                                live_rows):
    # ~1e-4 of the logits round to the other bf16 neighbour under another
    # f32 summation order, so over 37,632 draws some drawn value does: where
    # ids are equal, vals equal the twin's but where the twin's f32 sum lies
    # within the summation-order error (16 f32 roundings of the sum of the
    # products' magnitudes) of a bf16 rounding midpoint; there they are one
    # bf16 ulp apart, and such values are rare
    x, w, b, ids, vals, vals_p, eq = _classifier_case(cuda, dtype, rows, d,
                                                      vocab, live_rows)
    bf = torch.bfloat16
    xf, wf = x.to(bf).float(), w.to(bf).float()
    n = int(eq.sum())
    pick = ids[eq]
    z = (xf[eq] @ wf.T + b).gather(1, pick)
    mag = (xf[eq].abs() @ wf.abs().T).gather(1, pick)
    r = z.to(bf).float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r)[1] - 8)
    mid = r + torch.where(z >= r, ulp, -ulp) / 2
    near = (z - mid).abs() <= 16 * 2.0 ** -24 * mag
    same = vals[eq] == vals_p[eq]
    one_ulp = near & ((vals[eq] - vals_p[eq]).abs() <= ulp)
    assert (same | one_ulp).all()
    assert (~same).sum().item() <= max(1, n * ids.shape[1] // 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,ng,live_items,tp,d,heads", [
    (5, 2, None, 56, 256, 4), (7, 4, None, 56, 256, 4),
    (7, 4, 6, 56, 256, 4), (3, 8, None, 56, 256, 4), (10, 2, 3, 56, 256, 4),
    (5, 8, None, 56, 256, 4), (5, 4, 0, 56, 256, 4),
    # t_real == Tp: no pad rows
    (7, 4, None, 49, 256, 4),
    # head_dim 24: bf16 off the tensor cores
    (5, 4, 5, 56, 192, 8)])
def test_cross_attention_packed_matches_twin(cuda, dtype, r, ng, live_items,
                                             tp, d, heads):
    # T 49 (of tp); one item fully masked; r 10 takes two row chunks
    groups, t_real = 16, 49
    g = torch.Generator(cuda).manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa
    q, ek, ev = rnd(groups * r, d), rnd(groups, tp, d), rnd(groups, tp, d)
    mask = torch.rand(groups, tp, generator=g, device=cuda) < 0.3
    mask[1] = True
    bias = torch.where(mask[:, None, :], A.MASK_FILL, 0.0).float()
    kw = dict(n_heads=heads, pack_items=ng, t_real=t_real,
              live_items=live_items)
    for b in (bias, None):
        reset_launch_counts()
        got = A.grouped_cross_attention(q, ek, ev, b, **kw)
        want = A.cross_attention_packed_plain(q, ek, ev, b, **kw)
        assert LAUNCHES["cross_attention_packed"] == 1
        assert LAUNCHES["grouped_cross_attention"] == 0
        torch.testing.assert_close(got, want, atol=_tol(dtype),
                                   rtol=_tol(dtype))
        assert torch.isfinite(got.float()).all()
        if live_items is not None:
            assert not got[live_items * r:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("beam,live_items", [(3, None), (5, None), (7, None),
                                             (7, 5)])
def test_fused_survivor_update_matches_twin(cuda, beam, live_items):
    from deephumor_tpu_torch.ops import engine as E

    items, L, P, pos = 9, 40, 41, 17
    g = torch.Generator(cuda).manual_seed(8)
    ri = lambda hi, *s: torch.randint(0, hi, s, generator=g,  # noqa: E731
                                      device=cuda)
    new_idx = ri(60, items, beam, beam)
    new_idx[0, 1, 2] = new_idx[4, 0, 0] = 3  # planted EOS picks
    ended = ri(2, items, beam).bool()
    ended[6] = True
    args = [new_idx, torch.randn(items, beam, beam, generator=g, device=cuda),
            ri(beam * beam, items, beam), ended,
            torch.randn(items, beam, generator=g, device=cuda),
            ri(60, items, beam, L), ri(beam, items, beam, P),
            ri(2, items, beam, P).bool()]
    kw = dict(beam=beam, eos_index=3, pad_index=0, live_items=live_items)
    reset_launch_counts()
    got = E.fused_survivor_update(*[a.clone() for a in args], pos, **kw)
    want = E.fused_survivor_update_plain(*args, pos, **kw)
    assert LAUNCHES["fused_survivor_update"] == 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _attention_inputs(cuda, dtype, seed, items, beam, p, d, pos):
    rows = items * beam
    g = torch.Generator(cuda).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa
    anc = torch.randint(0, beam, (items, beam, p), generator=g, device=cuda)
    valid = torch.rand(rows, p, generator=g, device=cuda) < 0.7
    valid[:, pos + 1:] = False
    valid[:, 0] = valid[:, pos] = True
    return (rnd(rows, d), rnd(rows, p, d), rnd(rows, p, d), rnd(rows, d),
            rnd(rows, d), A.ancestry_bias(anc, valid, p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl,p_eff,beam,p", [
    ("native4d", None, 3, 24), ("native4d", 16, 3, 24),
    ("grouped", 16, 3, 24), ("native4d", 32, 5, 40),
    ("grouped", None, 7, 136), ("blockdiag", None, 7, 136),
    ("native4d", None, 36, 16)])
def test_ancestry_attention_matches_twin(cuda, dtype, impl, p_eff, beam, p):
    # beam 7 x P 136 is 952 (slot, position) rows: staged in tiles (the
    # grouped and blockdiag layouts read all P, whatever p_eff says)
    q, ck, cv, _, _, bias = _attention_inputs(cuda, dtype, 9, 5, beam, p,
                                              128, 13)
    kw = dict(beam=beam, n_heads=4, impl=impl, p_eff=p_eff)
    reset_launch_counts()
    got = A.ancestry_attention(q, ck, cv, bias, **kw)
    want = A.ancestry_attention_plain(q, ck, cv, bias, **kw)
    assert LAUNCHES["ancestry_attention"] == 1
    torch.testing.assert_close(got, want, atol=_tol(dtype), rtol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos,beam,p", [(0, 3, 24), (7, 3, 24), (13, 5, 40),
                                        (127, 7, 136),
                                        # the char shape at its first tiles;
                                        # beam 36: bf16 blocks of 32 and 4
                                        (0, 7, 136), (8, 7, 136),
                                        (15, 36, 16)])
def test_ancestry_attention_update_flash_matches_twin(cuda, dtype, pos, beam,
                                                      p):
    _check_flash(cuda, dtype, pos, beam, p, 128, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ancestry_attention_update_flash_off_the_tensor_cores(cuda, dtype):
    # head_dim 24: bf16 runs the CUDA-core kernel, as f32 does
    _check_flash(cuda, dtype, 31, 5, 40, 96, 4)


def _check_flash(cuda, dtype, pos, beam, p, d, heads):
    q, ck, cv, kn, vn, bias = _attention_inputs(cuda, dtype, 10, 5, beam, p,
                                                d, pos)
    caches = [(ck.clone(), cv.clone()) for _ in range(2)]
    kw = dict(beam=beam, n_heads=heads)
    reset_launch_counts()
    got = A.ancestry_attention_update_flash(q, *caches[0], kn, vn, bias, pos,
                                            **kw)
    want = A.ancestry_attention_update_flash_plain(q, *caches[1], kn, vn,
                                                   bias, pos, **kw)
    assert LAUNCHES["ancestry_attention_update_flash"] == 1
    torch.testing.assert_close(got, want, atol=_tol(dtype), rtol=_tol(dtype))
    assert torch.equal(caches[0][0], caches[1][0])
    assert torch.equal(caches[0][1], caches[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype,new_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("rows,pos", [(325, 4), (12, 0), (8960, 39)])
def test_cache_column_write_matches_twin(cuda, cache_dtype, new_dtype, rows,
                                         pos):
    g = torch.Generator(cuda).manual_seed(11)
    ck, cv = (torch.randn(rows, 40, 64, generator=g, device=cuda).to(
        cache_dtype) for _ in range(2))
    kn, vn = (torch.randn(rows, 64, generator=g, device=cuda).to(new_dtype)
              for _ in range(2))
    want = C.cache_column_write_plain(ck.clone(), cv.clone(), kn, vn, pos)
    reset_launch_counts()
    got = C.cache_column_write(ck, cv, kn, vn, pos)
    assert LAUNCHES["cache_column_write"] == 1
    assert got[0] is ck and got[1] is cv
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# K1-K6, K9 and K10 with the count in device memory (a 0-d int32, as a
# captured step passes it): the same outputs as the int count, on the
# rows that the count defines, and as many launches
COUNT_SHAPES = dict(items=12, beam=7, p=40, c=24, pe=32, d=128, n_heads=2,
                    t_enc=49, vocab=128, top_k=50, length=32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("count", [0, 5, 12])
def test_kernels_read_a_device_count(cuda, dtype, count):
    from deephumor_tpu_torch.ops.testing import (COUNTED, count_rows,
                                                 counted_calls)

    items, beam = COUNT_SHAPES["items"], COUNT_SHAPES["beam"]
    calls = counted_calls(**COUNT_SHAPES, dtype=dtype,
                          generator=torch.Generator(cuda).manual_seed(3))
    for name in COUNTED:
        if name == "fused_classifier_topk_gumbel_sample" and (
                dtype == torch.float32):
            continue  # K4 casts to bf16 either way
        per, run = calls[name]
        reset_launch_counts()
        got = run(torch.tensor(count * per, dtype=torch.int32, device=cuda))
        launches = LAUNCHES[name]
        reset_launch_counts()
        want = run(count * per)
        # an int count of 0 rows launches no K3; a device count launches
        assert launches == LAUNCHES[name] or (
            name == "fused_topk_gumbel_sample" and count == 0)
        keep = count_rows(name, count, items, beam).to(cuda)
        for g, w in zip(got, want):
            if name != "ancestry_attention_ids":
                assert torch.equal(g, w), name
            else:  # rows of items not selected are left unwritten
                k = keep.repeat_interleave(beam)
                assert torch.equal(g[k], w[k]), name


def _fused_views(t_q, t_k, t_v):
    """The three column views of one [rows, 3D] tensor (rows 3D apart,
    as decode_step's fused QKV product), holding the given values."""
    rows, d = t_q.shape
    base = torch.empty(rows, 3 * d, dtype=t_q.dtype, device=t_q.device)
    views = base.split(d, -1)
    for view, t in zip(views, (t_q, t_k, t_v)):
        view.copy_(t)
    return views


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["k1", "k5", "k6"])
def test_strided_views_bit_equal_contiguous_copies(cuda, dtype, kernel):
    # the char leg's last phase at 2 heads of 64: K1, K5 and K6 read q,
    # k_new and v_new in place from the fused product's views
    items, beam, p, c, pe, d, heads = 9, 7, 136, 120, 128, 128, 2
    g = torch.Generator(cuda).manual_seed(21)
    s = canon_state(items=items, beam=beam, p=p, c=c, pe=pe, d=d,
                    dtype=dtype, generator=g, stragglers=range(1, items, 2))
    views = _fused_views(s["q"], s["kn"], s["vn"])
    assert views[0].stride() == (3 * d, 1)
    ids = torch.randperm(items, generator=g, device=cuda).to(torch.int32)

    def run(q, kn, vn):
        ck, cv = s["ck"].clone(), s["cv"].clone()
        if kernel == "k1":
            out = A.ancestry_attention_update(
                q, ck, cv, kn, vn, s["bias"], s["pos"], beam=beam,
                n_heads=heads, p_eff=pe)
        elif kernel == "k5":
            out = A.ancestry_attention_update_canon(
                q, ck, cv, s["sk"], s["sv"], kn, vn, s["bias_sh"],
                s["bias_win"], s["pos"], beam=beam, n_heads=heads, c=c,
                p_eff=pe)
        else:
            out = torch.zeros_like(s["q"])
            A.ancestry_attention_ids(q, ck, cv, s["bias"], ids, 4,
                                     beam=beam, n_heads=heads, p_eff=pe,
                                     out=out)
        return out, ck, cv

    got = run(*views)
    want = run(*(v.contiguous() for v in views))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_sel", [0, 1, 2, 3, 4, 5, 6, 7, 8, 96])
def test_ids_device_count_bit_equal_to_int(cuda, dtype, n_sel):
    # K6 at the char shapes (beam 7, p_eff 128, D 512 over 8 heads) over
    # 128 items: a count in device memory launches the bounded grid, an
    # int the entries it computes, with one cluster split; both write the
    # listed items' rows into `out` alike and leave every other row
    items, beam, p, pe, d, heads = 128, 7, 136, 128, 512, 8
    g = torch.Generator(cuda).manual_seed(22)
    s = canon_state(items=items, beam=beam, p=p, c=120, pe=pe, d=d,
                    dtype=dtype, generator=g, stragglers=range(0, items, 3))
    q = _fused_views(s["q"], s["kn"], s["vn"])[0]
    ids = torch.randperm(items, generator=g, device=cuda).to(torch.int32)
    base = torch.randn(items * beam, d, generator=g, device=cuda).to(dtype)
    kw = dict(beam=beam, n_heads=heads, p_eff=pe)
    outs = []
    for count in (n_sel, torch.tensor(n_sel, dtype=torch.int32,
                                      device=cuda)):
        out = base.clone()
        A.ancestry_attention_ids(q, s["ck"], s["cv"], s["bias"], ids, count,
                                 out=out, **kw)
        outs.append(out)
    want = A.ancestry_attention_ids_plain(q, s["ck"], s["cv"], s["bias"],
                                          ids, n_sel, out=base.clone(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    rows = torch.zeros(items, dtype=torch.bool, device=cuda)
    rows[ids[:n_sel].long()] = True
    rows = rows.repeat_interleave(beam)
    assert torch.equal(outs[0][~rows], base[~rows])
    torch.testing.assert_close(outs[0], want, atol=_tol(dtype),
                               rtol=_tol(dtype))


# ---- the row list of K1, K6 and K7 (ops/csrc/row_list.cuh) ----

ANCESTRIES = ["search", "distinct", "blank"]


@pytest.fixture(scope="module")
def word_biases():
    # positions whose p_eff is 16, 24 and 32
    return {pos: bias for pos, _, bias in searched_biases(
        items=4, seed=3, steps=(15, 23, 31))}


@pytest.fixture(scope="module")
def char_biases():
    return {pos: bias for pos, _, bias in searched_biases(
        items=4, seed=3, steps=(63, 127), config="char")}


def _row_list_bias(kind, searched, items, beam, p, pos, device, seed=0):
    """An ancestry bias [items, beam, beam * p]: the search's items over
    and over (``searched``: its bias at ``pos``), every branch on its own
    slot, or a random ancestry whose item 0 has a branch valid nowhere."""
    if kind == "search":
        reps = -(-items // searched.shape[0])
        b = searched.repeat(reps, 1, 1)[:items]
        b = b.reshape(items, beam, beam, -1)[..., :p]
        return b.reshape(items, beam, beam * p).contiguous().to(device)
    if kind == "distinct":
        anc = torch.arange(beam, device=device)[None, :, None].expand(
            items, beam, p)
        valid = torch.zeros(items * beam, p, dtype=torch.bool, device=device)
        valid[:, :pos + 1] = True
        return A.ancestry_bias(anc, valid, p)
    g = torch.Generator(device).manual_seed(seed)
    anc = torch.randint(0, beam, (items, beam, p), generator=g, device=device)
    valid = torch.rand(items * beam, p, generator=g, device=device) < 0.8
    valid[:, pos + 1:] = False
    valid[:, 0] = valid[:, pos] = True
    valid[1] = False
    return A.ancestry_bias(anc, valid, p)


def _tally_since(cuda, before):
    torch.cuda.synchronize()
    read, dense = A.rows_tally_totals(cuda)
    return read - before[0], dense - before[1]


def _tally_now(cuda):
    A.rows_tally(cuda)
    torch.cuda.synchronize()
    return A.rows_tally_totals(cuda)


def _mirror_count(bias, beam, pe, cs, items=None):
    lists = ancestry_rows(bias if items is None else bias[items], beam=beam,
                          pe=pe, cs=cs)
    blocks = sum(len(c) for c in lists)
    return sum(len(x) for c in lists for x in c), blocks * beam * pe


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ANCESTRIES)
@pytest.mark.parametrize("pos", [15, 23, 31])
@pytest.mark.parametrize("items,p", [(3, 40), (64, 40), (64, 33)])
def test_row_list_k1_at_the_word_shape(cuda, word_biases, dtype, kind, pos,
                                       items, p):
    # beam 5, D 512 over 8 heads, p_eff 16 / 24 / 32: 3 items spread each
    # (item, head) over a cluster (padded lists), 64 fill the card; P 33
    # scans the biases a row a lane (a slot's biases not 16-byte aligned)
    beam, d, heads, pe = 5, 512, 8, 8 * (pos // 8 + 1)
    bias = _row_list_bias(kind, word_biases[pos], items, beam, p, pos, cuda)
    q, ck, cv, kn, vn, _ = _attention_inputs(cuda, dtype, 31, items, beam, p,
                                             d, pos)
    caches = [(ck.clone(), cv.clone()) for _ in range(2)]
    kw = dict(beam=beam, n_heads=heads, p_eff=pe)
    before = _tally_now(cuda)
    got = A.ancestry_attention_update(q, *caches[0], kn, vn, bias, pos, **kw)
    read, dense = _tally_since(cuda, before)
    want = A.ancestry_attention_update_plain(q, *caches[1], kn, vn, bias,
                                             pos, **kw)
    torch.testing.assert_close(got, want, atol=_tol(dtype), rtol=_tol(dtype))
    assert torch.equal(caches[0][0], caches[1][0])
    assert torch.equal(caches[0][1], caches[1][1])
    if dtype == torch.float32:
        assert (read, dense) == (0, 0)  # the CUDA-core kernel lists nothing
    elif items == 64:
        # one block per (item, head): the mirror's rows, from head 0's
        assert (read, dense) == _mirror_count(bias, beam, pe, 1)
        if kind == "search":
            assert read < dense


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ANCESTRIES)
@pytest.mark.parametrize("pos", [63, 127])
@pytest.mark.parametrize("n_sel", [0, 1, 5, 96])
def test_row_list_k6_at_the_char_shape(cuda, char_biases, dtype, kind, pos,
                                       n_sel):
    # beam 7, D 512 over 8 heads, P 136, p_eff 64 / 128, over 128 items:
    # 0-96 stragglers through a device count and an int, into K5's output
    items, beam, p, d, heads, pe = 128, 7, 136, 512, 8, pos + 1
    bias = _row_list_bias(kind, char_biases[pos], items, beam, p, pos, cuda,
                          seed=pos)
    g = torch.Generator(cuda).manual_seed(pos + n_sel)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa
    q, ck, cv, base = rnd(items * beam, d), rnd(items * beam, p, d), \
        rnd(items * beam, p, d), rnd(items * beam, d)
    ids = torch.randperm(items, generator=g, device=cuda).to(torch.int32)
    kw = dict(beam=beam, n_heads=heads, p_eff=pe)
    outs = []
    before = _tally_now(cuda)
    for count in (n_sel, torch.tensor(n_sel, dtype=torch.int32,
                                      device=cuda)):
        out = base.clone()
        A.ancestry_attention_ids(q, ck, cv, bias, ids, count, out=out, **kw)
        outs.append(out)
    read, dense = _tally_since(cuda, before)
    want = A.ancestry_attention_ids_plain(q, ck, cv, bias, ids, n_sel,
                                          out=base.clone(), **kw)
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], want, atol=_tol(dtype),
                               rtol=_tol(dtype))
    if dtype == torch.bfloat16:
        # both forms computed the same entries: a few on a cluster each over
        # the dense rows, 96 (more than the H100's resident wave holds
        # clusters) a block each over its list
        r1, d1 = _mirror_count(bias, beam, pe, 1, ids[:n_sel].long().cpu())
        assert (read, dense) == ((2 * d1, 2 * d1) if n_sel <= 8
                                 else (2 * r1, 2 * d1))


@pytest.mark.cuda
def test_row_list_k1_replays_over_new_ancestries(cuda, word_biases):
    # a captured K1 bakes its grid and buffers; each replay lists the rows
    # of the bias it finds there, and adds them to the tally
    items, beam, p, d, heads, pos = 64, 5, 40, 512, 8, 31
    dtype = torch.bfloat16
    q, ck, cv, kn, vn, _ = _attention_inputs(cuda, dtype, 32, items, beam, p,
                                             d, pos)
    biases = [_row_list_bias(k, word_biases[pos], items, beam, p, pos, cuda)
              for k in ("search", "distinct", "blank")]
    static = biases[0].clone()
    kw = dict(beam=beam, n_heads=heads, p_eff=32)
    work = (ck.clone(), cv.clone())
    A.ancestry_attention_update(q, *work, kn, vn, static, pos, **kw)
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=stream):
        got = A.ancestry_attention_update(q, *work, kn, vn, static, pos, **kw)
    for bias in biases[::-1] + biases[:1]:
        static.copy_(bias)
        before = _tally_now(cuda)
        graph.replay()
        read, dense = _tally_since(cuda, before)
        want = A.ancestry_attention_update_plain(q, ck.clone(), cv.clone(),
                                                 kn, vn, bias, pos, **kw)
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        assert (read, dense) == _mirror_count(bias, beam, 32, 1)
