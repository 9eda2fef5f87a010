"""``CaptioningMLAMoE`` (DeepSeek-V3's block: latent attention and sparse
experts, models/mla_moe.py) against the plain f32 reference
(perfbench/reference/mla_moe.py), K12's twin against its definition, the
router against an explicit loop, and the expert-parallel share against
the uncut layer; on the CPU at a small size. The tests marked ``cuda``
hold K12, K3 at V 163,840 and the expert path to their twins on the
card and a captured call to an eager one; they skip here.

    python -m pytest -p no:cacheprovider tests/test_torch_mla_moe.py
"""

import math

import pytest
import torch

from deephumor_tpu_torch.models import CaptioningMLAMoE
from deephumor_tpu_torch.models import mla_moe
from deephumor_tpu_torch.models import sampling
from deephumor_tpu_torch.ops import LAUNCHES, moe, reset_launch_counts
from deephumor_tpu_torch.ops import attention as A
from deephumor_tpu_torch.ops import sampler as S
from deephumor_tpu_torch.ops.testing import cap_test_threads
from deephumor_tpu_torch.utils import profiling
from perfbench.core import spec
from perfbench.reference import mla_moe as ref

cap_test_threads()

SMALL = dict(num_tokens=97, hid_dim=64, n_layers=3, n_heads=4, qk_nope=16,
             qk_rope=8, v_dim=16, kv_rank=32, dense_width=96,
             expert_width=24, n_routed=8, n_held=4, experts_per_token=2,
             n_shared=1, first_dense=1, prefix_len=6, rope_theta=800000.0)
# f32 on both sides: the port's absorbed decode and per-expert grouping
# against the reference's unabsorbed full forward differ by summation
# order alone (logits of unit scale)
F32_TOL = 2e-4


def _model(**kw):
    return CaptioningMLAMoE(**{**SMALL, **kw})


def _hp(m):
    return dict(heads=m.n_heads, nope=m.qk_nope, rope=m.qk_rope, v=m.v_dim,
                rank=m.kv_rank, eps=m.rms_eps, theta=m.rope_theta,
                k=m.experts_per_token, scaling=m.routed_scaling,
                first=m.held_first, held=m.n_held)


def _params(m, seed=0):
    return m.init(torch.Generator().manual_seed(seed), device="cpu")


def _prefix(m, n, seed=1):
    return torch.randn(n, m.prefix_len, m.hid_dim,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("held_first,n_held", [(0, 8), (0, 4), (4, 4)])
def test_prefill_and_absorbed_decode_match_reference(held_first, n_held):
    m = _model(n_held=n_held, held_first=held_first)
    params = _params(m)
    dec = params["decoder"]
    n, steps = 2, 5
    prefix = _prefix(m, n)
    tokens = torch.randint(4, m.num_tokens, (n, steps),
                           generator=torch.Generator().manual_seed(2))
    want = ref.logits(dec, prefix, tokens, _hp(m))
    hidden, lat = mla_moe.prefill(m, dec, prefix)
    got = [torch.nn.functional.linear(hidden, dec["classifier"]["weight"],
                                      dec["classifier"]["bias"])]
    # one branch an item: it reads every generated row below s
    gen = [x.new_zeros((n, steps, x.shape[-1])) for x in lat]
    for s in range(1, steps):
        bias = torch.zeros(n, 1, steps)
        bias[..., s:] = A.MASK_FILL
        x = dec["tok_embedding"]["weight"][tokens[:, s - 1]]
        h = mla_moe.decode_step(m, dec, mla_moe.absorbed(m, dec), x, s, lat,
                                gen, bias, 1)
        got.append(torch.nn.functional.linear(
            h, dec["classifier"]["weight"], dec["classifier"]["bias"]))
    torch.testing.assert_close(torch.stack(got, 1), want, atol=F32_TOL,
                               rtol=F32_TOL)


def _recorded_search(m, params, prefix, **kw):
    """generate_from_emb's result, each decode step's hidden states and the
    sequences the step's rows had before it (the rows' histories)."""
    seqs, hiddens = [], []
    step, orig_decode = sampling.BeamSearch._step, mla_moe.decode_step

    def recorded_step(self, s, step_fn):
        seqs.append(self.seq.clone())
        return step(self, s, step_fn)

    def recorded_decode(*args, **kwargs):
        h = orig_decode(*args, **kwargs)
        hiddens.append(h.clone())
        return h

    sampling.BeamSearch._step = recorded_step
    mla_moe.decode_step = recorded_decode
    try:
        out = m.generate_from_emb(params, prefix, **kw)
    finally:
        sampling.BeamSearch._step = step
        mla_moe.decode_step = orig_decode
    return out, seqs, hiddens


def test_greedy_generation_per_step_logits_match_reference():
    # every decode step of a greedy beam search: each row's logits against
    # the reference over the row's history (the survivor reorders make the
    # rows read other slots' generated rows)
    m = _model()
    params = _params(m)
    dec = params["decoder"]
    beam, n = 3, 2
    prefix = _prefix(m, n)
    out, seqs, hiddens = _recorded_search(
        m, params, prefix, max_len=6, beam_size=beam, top_k=8, greedy=True)
    assert len(hiddens) == len(seqs) >= 3
    cls = dec["classifier"]
    for s, (seq, h) in enumerate(zip(seqs, hiddens), start=1):
        hist = seq[:, :, :s + 1].reshape(n * beam, s + 1)
        want = ref.logits(dec, prefix.repeat_interleave(beam, 0), hist,
                          _hp(m))[:, s]
        got = torch.nn.functional.linear(h, cls["weight"], cls["bias"])
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    # the chosen captions are each one of the final beams
    assert all((out["sequences"][i] == out["chosen"][i]).all(-1).any()
               for i in range(n))


def _searched_ancestry(items, beam, steps, seed):
    """The ancestry table of a random beam search after ``steps`` steps:
    each step every branch re-roots onto a random surviving branch (so
    branches coalesce), then writes its own slot at the new position."""
    g = torch.Generator().manual_seed(seed)
    anc = torch.arange(beam)[None, :, None].expand(items, beam,
                                                   steps).contiguous()
    for s in range(steps):
        branch = torch.randint(0, beam, (items, beam), generator=g)
        anc = anc.gather(1, branch[:, :, None].expand_as(anc))
        anc[:, :, s] = torch.arange(beam)
    return anc


def _k12_definition(q_lat, q_pe, prefix, gen, anc, pe, scale):
    """Branch by branch and head by head: softmax over the prefix rows and
    the generated rows of the branch's own ancestry, in f32."""
    heads, rows, dv = q_lat.shape
    items, beam = anc.shape[:2]
    out = torch.empty(heads, rows, dv)
    for g in range(items):
        for j in range(beam):
            r = g * beam + j
            keys = torch.cat([prefix[g].float(), torch.stack([
                gen[g * beam + int(anc[g, j, p]), p].float()
                for p in range(pe)])])
            for h in range(heads):
                q = torch.cat([q_lat[h, r], q_pe[r, h]]).float()
                w = torch.softmax(keys @ q * scale, 0)
                out[h, r] = w.to(q_lat.dtype).float() @ keys[:, :dv]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pe", [1, 4, 7])
def test_k12_twin_matches_definition_over_a_searched_ancestry(dtype, pe):
    items, beam, heads, t0, s, dk, dv = 3, 4, 2, 5, 8, 24, 16
    g = torch.Generator().manual_seed(pe)
    q_lat = torch.randn(heads, items * beam, dv, generator=g).to(dtype)
    q_pe = torch.randn(items * beam, heads, dk - dv, generator=g).to(dtype)
    prefix = torch.randn(items, t0, dk, generator=g).to(dtype)
    gen = torch.randn(items * beam, s, dk, generator=g).to(dtype)
    anc = _searched_ancestry(items, beam, s, seed=pe)
    valid = (torch.arange(s) < pe).expand(items * beam, s)
    bias = A.ancestry_bias(anc, valid, s)
    scale = 1.0 / math.sqrt(dk)
    got = A.mla_attention(q_lat, q_pe, prefix, gen, bias, beam=beam, pe=pe,
                          scale=scale)
    want = _k12_definition(q_lat, q_pe, prefix, gen, anc, pe, scale)
    # f32: summation order; bf16: the output's rounding (and a weight on
    # either side of a rounding edge)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


def _route_loop(h, w_gate, e_bias, k, scaling):
    """The router token by token: sigmoid scores, the k best biased
    scores (sorted), the unbiased scores there over their sum."""
    ids, ws = [], []
    for t in range(h.shape[0]):
        s = torch.sigmoid(w_gate.float() @ h[t].float())
        sel = sorted(range(s.numel()), key=lambda e: -float(s[e] + e_bias[e]))
        sel = sel[:k]
        w = torch.stack([s[e] for e in sel])
        ids.append(sel)
        ws.append(w / w.sum() * scaling)
    return torch.tensor(ids), torch.stack(ws)


def _routes_like_the_loop(route_fn):
    g = torch.Generator().manual_seed(5)
    h = torch.randn(40, 16, generator=g)
    w_gate = torch.randn(8, 16, generator=g) * 0.3
    # a bias as large as the scores' spread: the biased selection differs
    # from the unbiased one on most tokens
    e_bias = torch.linspace(-0.4, 0.4, 8)
    ids, w = route_fn(h, w_gate, e_bias, 3, 2.446)
    want_ids, want_w = _route_loop(h, w_gate, e_bias, 3, 2.446)
    order = ids.argsort(-1)
    return (torch.equal(ids.gather(-1, order),
                        want_ids.gather(-1, want_ids.argsort(-1)))
            and torch.allclose(w.gather(-1, order),
                               want_w.gather(-1, want_ids.argsort(-1)),
                               atol=1e-6))


def test_routing_selects_by_biased_scores_and_weights_by_unbiased():
    def port(h, w_gate, e_bias, k, scaling):
        return moe.route(h, w_gate, e_bias, top_k=k, scaling=scaling)

    def bias_in_weights(h, w_gate, e_bias, k, scaling):
        s = torch.sigmoid(h @ w_gate.T) + e_bias
        ids = s.topk(k).indices
        w = s.gather(-1, ids)
        return ids, w / w.sum(-1, keepdim=True) * scaling

    def bias_ignored(h, w_gate, e_bias, k, scaling):
        return moe.route(h, w_gate, torch.zeros_like(e_bias), top_k=k,
                         scaling=scaling)

    assert _routes_like_the_loop(port)
    assert not _routes_like_the_loop(bias_in_weights)
    assert not _routes_like_the_loop(bias_ignored)


def test_expert_shares_add_up_to_the_uncut_layer():
    # four cards of two experts each: their partial outputs, the shared
    # expert counted once, add up to the reference's whole layer (and to
    # the port's uncut layer)
    whole = _model(n_held=8)
    params = _params(whole)
    ffn = params["decoder"]["layers"][1]["ffn"]
    h = torch.randn(30, whole.hid_dim,
                    generator=torch.Generator().manual_seed(3))
    shared = moe.swiglu(h, ffn["shared"]["gate_up"]["weight"],
                        ffn["shared"]["down"]["weight"])
    parts = []
    for first in range(0, 8, 2):
        m = _model(n_held=2, held_first=first)
        share = dict(ffn, experts={k: v[first:first + 2]
                                   for k, v in ffn["experts"].items()})
        parts.append(mla_moe._ffn(m, share, h, None) - shared)
    got = sum(parts) + shared
    torch.testing.assert_close(got, ref.experts(
        ref._Math("f32"), ffn, h, _hp(whole)), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, mla_moe._ffn(whole, ffn, h, None),
                               atol=1e-5, rtol=1e-5)
    # one share alone is not the layer
    assert not torch.allclose(parts[0] + shared, got, atol=1e-3)


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_moe_tally_folds_into_counters_only_under_a_profiler(monkeypatch):
    # the expert layers' device tally (ops/moe.py moe_tally) as a sequence
    # of totals (pairs, held pairs, summed largest load)
    dev = torch.device("cuda", 0)
    totals = iter([[60, 15, 5], [120, 31, 11], [180, 45, 16]])
    reads = []

    def read(device):
        reads.append(device)
        return next(totals)

    monkeypatch.setattr(sampling.moe, "moe_tally_totals", read)
    monkeypatch.setattr(sampling, "_FOLDED", {})
    with profiling.span("off"):
        pass
    sampling.fold_moe_tally(dev)
    assert reads == []                 # off: no read of the device
    with _profile():
        sampling.fold_moe_tally(dev)   # the window's first fold: a mark
        assert "moe.pairs" not in profiling.counts()
        sampling.fold_moe_tally(dev)
        sampling.fold_moe_tally(dev)
        c = profiling.counts()
        assert (c["moe.pairs"], c["moe.pairs_held"],
                c["moe.held_load_max"]) == (120, 30, 11)
        ctx = {"kind": "offline", "config": {"n_routed_experts": 2}}
        assert spec.metric_reader("held_pair_share.kimi_vl")(ctx) == 25.0
        assert spec.metric_reader("held_load_ratio.kimi_vl")(
            ctx) == pytest.approx(11 / 15)
    assert len(reads) == 3


def test_layer_tally_counts_pairs_held_and_the_largest_load():
    counts = torch.tensor([3, 0, 7, 2])
    tally = torch.zeros(3, dtype=torch.int64)
    moe.note(counts, 40, tally)
    moe.note(counts, 40, tally)
    assert tally.tolist() == [80, 24, 14]
    moe.note(counts, 40, None)          # no tally (the CPU): nothing


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_ancestry(kind, items, beam, steps, seed):
    if kind == "distinct":
        return torch.arange(beam)[None, :, None].expand(
            items, beam, steps).contiguous()
    return _searched_ancestry(items, beam, steps, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["distinct", "searched"])
@pytest.mark.parametrize("pe", [1, 2, 13, 31, 32])
def test_k12_matches_twin_at_the_published_widths(cuda, kind, pe):
    items, beam, heads, t0, s = 96, 5, 16, 64, 32
    g = torch.Generator(cuda).manual_seed(pe)
    bf = torch.bfloat16
    rows = items * beam
    q_lat = torch.randn(heads, rows, 512, generator=g, device=cuda).to(bf)
    q_pe = torch.randn(rows, heads, 64, generator=g, device=cuda).to(bf)
    prefix = torch.randn(items, t0, 576, generator=g, device=cuda).to(bf)
    gen = torch.randn(rows, s, 576, generator=g, device=cuda).to(bf)
    anc = _cuda_ancestry(kind, items, beam, s, pe).to(cuda)
    valid = (torch.arange(s, device=cuda) < pe).expand(rows, s)
    bias = A.ancestry_bias(anc, valid, s)
    kw = dict(beam=beam, pe=pe, scale=1.0 / math.sqrt(192))
    reset_launch_counts()
    got = A.mla_attention(q_lat, q_pe, prefix, gen, bias, **kw)
    assert LAUNCHES["mla_attention"] == 1
    want = A.mla_attention_plain(q_lat, q_pe, prefix, gen, bias, **kw)
    # one bf16 rounding of each output (and of a weight at a rounding edge)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_k12_adds_its_generated_rows_to_the_tally(cuda):
    items, beam, heads, t0, s, pe = 24, 5, 16, 64, 32, 13
    bf = torch.bfloat16
    g = torch.Generator(cuda).manual_seed(3)
    rows = items * beam
    q_lat = torch.randn(heads, rows, 512, generator=g, device=cuda).to(bf)
    q_pe = torch.randn(rows, heads, 64, generator=g, device=cuda).to(bf)
    prefix = torch.randn(items, t0, 576, generator=g, device=cuda).to(bf)
    gen = torch.randn(rows, s, 576, generator=g, device=cuda).to(bf)
    anc = _searched_ancestry(items, beam, s, 5).to(cuda)
    bias = A.ancestry_bias(anc, (torch.arange(s, device=cuda) < pe).expand(
        rows, s), s)
    listed = int((bias.reshape(items, beam, beam, s)[..., :pe] == 0).any(
        1).sum())
    before = A.rows_tally_totals(cuda) or (0, 0)
    A.mla_attention(q_lat, q_pe, prefix, gen, bias, beam=beam, pe=pe,
                    scale=1.0 / math.sqrt(192))
    read, dense = A.rows_tally_totals(cuda)
    # each block: the generated rows some branch selects, of beam x pe
    assert (read - before[0], dense - before[1]) == (listed, rows * pe)
    assert listed < rows * pe


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gather_f32", "swiglu_f32",
                                  "swiglu_width_12", "combine_f32",
                                  "generate_f32"])
def test_card_refuses_what_the_kernels_cannot_take(cuda, case):
    h = torch.zeros(16, 64, device=cuda)
    order = torch.arange(32, device=cuda)
    offs = torch.full((4,), 8, dtype=torch.int32, device=cuda)
    mask = torch.ones(32, dtype=torch.bool, device=cuda)
    calls = {
        "gather_f32": lambda: moe.gather_pairs(h, order, offs, 2),
        "swiglu_f32": lambda: moe.swiglu_rows(h[:, :32].contiguous(), offs),
        "swiglu_width_12": lambda: moe.swiglu_rows(
            h[:, :24].bfloat16().contiguous(), offs),
        "combine_f32": lambda: moe.combine(
            torch.zeros(32, 64, device=cuda), order, mask,
            torch.ones(16, 2, device=cuda), h),
        "generate_f32": lambda: _model().generate_from_emb(
            _model().init(torch.Generator(cuda).manual_seed(0), cuda),
            torch.zeros(2, SMALL["prefix_len"], SMALL["hid_dim"],
                        device=cuda), max_len=2, beam_size=2, top_k=4)}
    with pytest.raises(ValueError):
        calls[case]()


@pytest.mark.cuda
def test_k3_streams_rows_past_shared_memory(cuda):
    # Kimi-VL's vocabulary in bf16 (320 KB a row): no team's buffer holds
    # it; planted rows as the other K3 tests plant them
    g = torch.Generator(cuda).manual_seed(23)
    vocab = 163840
    logits = torch.randn(600, vocab, generator=g, device=cuda).to(
        torch.bfloat16)
    logits[:8, 1] = 50.0
    logits[8:16] = 0.5
    logits[16:24, :2048] = 7.0
    logits[24:32, 100:140] = logits[24:32].float().topk(
        64, dim=1).values[:, -1:].to(torch.bfloat16)
    kw = dict(top_k=64, num_draws=5)
    reset_launch_counts()
    got = S.fused_topk_gumbel_sample(logits, 21, 0.9, **kw)
    assert LAUNCHES["fused_topk_gumbel_sample"] == 1
    want = S.fused_topk_gumbel_sample_plain(logits, 21, 0.9, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    live = torch.tensor(37, dtype=torch.int32, device=cuda)
    got = S.fused_topk_gumbel_sample(logits, 21, 0.9, live_rows=live, **kw)
    assert torch.equal(got[0][:37], want[0][:37])
    assert not got[0][37:].any()


def _ffn_loop(m, ffn, h):
    """The expert layer in f32 token by token over the held experts."""
    out = []
    for t in range(h.shape[0]):
        x = h[t].float()
        s = torch.sigmoid(ffn["gate"]["weight"].float() @ x)
        ids = (s + ffn["gate"]["e_bias"].float()).topk(
            m.experts_per_token).indices
        w = s[ids] / s[ids].sum() * m.routed_scaling
        y = moe.swiglu(x, ffn["shared"]["gate_up"]["weight"].float(),
                       ffn["shared"]["down"]["weight"].float())
        for e, we in zip(ids.tolist(), w):
            if m.held_first <= e < m.held_first + m.n_held:
                le = e - m.held_first
                y = y + we * moe.swiglu(
                    x, ffn["experts"]["gate_up"][le].float(),
                    ffn["experts"]["down"][le].float())
        out.append(y)
    return torch.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("planted", [None, "empty_and_full"])
def test_expert_path_matches_twin(cuda, planted):
    m = _model(hid_dim=256, expert_width=128, n_routed=16, n_held=8,
               held_first=4, experts_per_token=3, compute_dtype="bfloat16")
    params = m.init(torch.Generator(cuda).manual_seed(4), device=cuda)
    ffn = params["decoder"]["layers"][1]["ffn"]
    if planted:
        # held expert 0 gets no pair, held expert 1 gets every token
        ffn["gate"]["e_bias"][4] = -10.0
        ffn["gate"]["e_bias"][5] = 10.0
    bf = dict(ffn, shared={k: {"weight": v["weight"].bfloat16()}
                           for k, v in ffn["shared"].items()},
              experts={k: v.bfloat16() for k, v in ffn["experts"].items()})
    h = torch.randn(700, 256, generator=torch.Generator(cuda).manual_seed(5),
                    device=cuda).bfloat16()
    tally = torch.zeros(3, dtype=torch.int64, device=cuda)
    reset_launch_counts()
    got = mla_moe._ffn(m, bf, h, tally).float()
    assert all(LAUNCHES[k] == 1
               for k in ("moe_gather", "moe_swiglu", "moe_combine"))
    want = _ffn_loop(m, bf, h)
    # bf16 products and the output's rounding, against f32 sums of the
    # same bf16 weights
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)
    pairs, held, top = tally.tolist()
    assert pairs == 700 * 3
    if planted:
        assert top == 700
    cpu = mla_moe._ffn(m, {k: _to_cpu(v) for k, v in bf.items()},
                       h.cpu(), None).float()
    torch.testing.assert_close(got.cpu(), cpu, atol=3e-2, rtol=3e-2)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


@pytest.mark.cuda
def test_captured_call_is_bit_equal_to_eager(cuda):
    m = _model(num_tokens=2000, hid_dim=256, n_heads=4, qk_nope=32,
               qk_rope=64, v_dim=32, kv_rank=512, dense_width=512,
               expert_width=128, n_routed=16, n_held=4, experts_per_token=3,
               prefix_len=16, compute_dtype="bfloat16")
    params = m.init(torch.Generator(cuda).manual_seed(6), device=cuda)
    prefix = torch.randn(24, 16, 256, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(7))
    kw = dict(max_len=12, beam_size=4, top_k=16, sampler="pallas")
    outs = []
    for compiled in (False, None, None):
        reset_launch_counts()
        outs.append(m.generate_from_emb(
            params, prefix, generator=torch.Generator(cuda).manual_seed(8),
            compiled=compiled, **kw))
        assert LAUNCHES["mla_attention"] > 0
        assert LAUNCHES["fused_topk_gumbel_sample"] > 0
    for out in outs[1:]:
        for k in ("sequences", "scores", "chosen"):
            assert torch.equal(out[k], outs[0][k]), k
