"""The decode step's self-attention seam on the CPU, at small widths: K1,
K5 and K6 read q, k_new and v_new as row-strided views of the fused QKV
product, K6 writes the stragglers' rows into K5's output (``out=``), and
the fused QKV weights are made once per generation call. Held against
the same twins on contiguous copies, the JAX package, and the seam as it
was before (q/k/v copied, K6 into a tensor of its own merged by row
mask)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deephumor_tpu.models import CaptioningTransformer as JaxModel
from deephumor_tpu.models import CaptioningTransformerBase as JaxBase
from deephumor_tpu.ops import pallas_attention as pa
from deephumor_tpu_torch.convert.jax_params import params_to_jax
from deephumor_tpu_torch.models import (CaptioningTransformer,
                                        CaptioningTransformerBase, graphs)
from deephumor_tpu_torch.models import sampling as TS
from deephumor_tpu_torch.models import transformer as tfm
from deephumor_tpu_torch.ops import attention as A
from deephumor_tpu_torch.ops.testing import canon_state
from deephumor_tpu_torch.utils.pytree import tree_map
from test_torch_canon import BEAM, C, H, PE, POS, _canon_setup, _t

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

DTYPES = [torch.float32, torch.bfloat16]
# the twins' synthetic state: 5 items of beam 3, D 64 over 4 heads
ITEMS, SBEAM, SP, SC, SPE, SD, SH = 5, 3, 24, 8, 16, 64, 4


def _state(dtype, seed=0):
    return canon_state(items=ITEMS, beam=SBEAM, p=SP, c=SC, pe=SPE, d=SD,
                       dtype=dtype, generator=torch.Generator().manual_seed(
                           seed), stragglers=(1, 3))


def _fused_views(s, dtype, seed=1):
    """q, k_new, v_new as the three column views of one [rows, 3D]
    product (rows 3D apart), holding the state's values."""
    rows = ITEMS * SBEAM
    base = torch.randn(rows, 3 * SD, generator=torch.Generator().manual_seed(
        seed)).to(dtype)
    q, k, v = base.split(SD, -1)
    for view, name in ((q, "q"), (k, "kn"), (v, "vn")):
        view.copy_(s[name])
    assert q.stride() == (3 * SD, 1) and not q.is_contiguous()
    return q, k, v


def _run(kernel, s, q, kn, vn):
    """One call of ``kernel`` on fresh cache copies: its output and the
    caches it wrote."""
    ck, cv = s["ck"].clone(), s["cv"].clone()
    ids = torch.tensor([3, 1, 0, 2, 4], dtype=torch.int32)
    if kernel == "k1":
        out = A.ancestry_attention_update(
            q, ck, cv, kn, vn, s["bias"], s["pos"], beam=SBEAM, n_heads=SH,
            p_eff=SPE)
    elif kernel == "k5":
        out = A.ancestry_attention_update_canon(
            q, ck, cv, s["sk"], s["sv"], kn, vn, s["bias_sh"], s["bias_win"],
            s["pos"], beam=SBEAM, n_heads=SH, c=SC, p_eff=SPE)
    elif kernel == "k6":
        out = A.ancestry_attention_ids(q, ck, cv, s["bias"], ids, 2,
                                       beam=SBEAM, n_heads=SH, p_eff=SPE)
    else:  # k6 into a given output
        out = torch.full((ITEMS * SBEAM, SD), 7.0).to(q.dtype)
        A.ancestry_attention_ids(q, ck, cv, s["bias"], ids, 2, beam=SBEAM,
                                 n_heads=SH, p_eff=SPE, out=out)
    return out, ck, cv


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["k1", "k5", "k6", "k6_out"])
def test_row_strided_views_equal_contiguous_copies(kernel, dtype):
    s = _state(dtype)
    views = _fused_views(s, dtype)
    got = _run(kernel, s, *views)
    want = _run(kernel, s, *(v.contiguous() for v in views))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bad(kind, t):
    """``t`` ([rows, D]) with the same values at a stride no kernel
    takes."""
    rows, d = t.shape
    if kind == "transposed":  # unit stride across rows, not along them
        return t.t().contiguous().t()
    if kind == "overlapping":  # rows closer than D
        return torch.as_strided(t.contiguous(), (rows, d), (d // 2, 1))
    # misaligned: rows D + 1 f32 apart, 4 bytes past a 16-byte multiple
    wide = torch.zeros(rows, d + 1, dtype=t.dtype)
    wide[:, :d] = t
    return wide[:, :d]


@pytest.mark.parametrize("bad", ["transposed", "overlapping", "misaligned"])
@pytest.mark.parametrize("kernel", ["k1", "k5", "k6"])
def test_check_update_refuses_bad_strides(kernel, bad):
    s = _state(torch.float32)
    q, kn, vn = s["q"], s["kn"], s["vn"]
    # K6 reads q only; K1 and K5 get the bad stride on v_new
    args = (_bad(bad, q), kn, vn) if kernel == "k6" else (q, kn,
                                                          _bad(bad, vn))
    with pytest.raises(ValueError, match="stride"):
        _run(kernel, s, *args)


@functools.lru_cache(maxsize=None)
def _jax_merge(n_sel):
    """The JAX package's seam: K6 (interpreted) over the first
    max(n_sel, 1) listed items, merged by row mask into a base output."""
    s = _canon_setup(strag=(0, 2))
    ids = np.array([2, 0, 3, 1], np.int32)
    base = np.random.default_rng(9).normal(size=s["q"].shape).astype(
        np.float32)
    out_s = pa.ancestry_attention_ids(
        jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
        jnp.asarray(s["bias_full"]), jnp.asarray(ids), jnp.int32(n_sel),
        beam=BEAM, n_heads=H, p_eff=PE, interpret=True)
    rows = np.zeros(len(ids), bool)
    rows[ids[:n_sel]] = True
    rows = np.repeat(rows, BEAM)
    return s, ids, base, rows, np.asarray(jnp.where(rows[:, None], out_s,
                                                    base))


@pytest.mark.parametrize("form", ["int", "tensor"])
@pytest.mark.parametrize("n_sel", [0, 2, 4])
def test_ids_out_writes_only_the_listed_items(n_sel, form):
    s, ids, base, rows, want = _jax_merge(n_sel)
    out = _t(base)
    count = n_sel if form == "int" else torch.tensor(n_sel,
                                                     dtype=torch.int32)
    got = A.ancestry_attention_ids(_t(s["q"]), _t(s["k"]), _t(s["v"]),
                                   _t(s["bias_full"]), _t(ids), count,
                                   beam=BEAM, n_heads=H, p_eff=PE, out=out)
    assert got is out
    # no row but the listed items' is written (none at 0), bit for bit
    np.testing.assert_array_equal(out.numpy()[~rows], base[~rows])
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    assert int(rows.sum()) == n_sel * BEAM
    # the written rows are the twin's own output for those items
    alone = A.ancestry_attention_ids_plain(
        _t(s["q"]), _t(s["k"]), _t(s["v"]), _t(s["bias_full"]), _t(ids),
        max(n_sel, 1), beam=BEAM, n_heads=H, p_eff=PE)
    assert torch.equal(out[torch.from_numpy(rows)],
                       alone[torch.from_numpy(rows)])


# generation at small widths: word (K1), and Base and a char-like model
# with compaction and canon (K1, then K5 and K6), at the settings of the
# port's char and Base parity tests (items at several scales end at
# different steps, so the runs compact and have stragglers)
WORD_HP = dict(num_tokens=300, hid_dim=64, n_layers=2, n_heads=2,
               pf_dim=128, max_len=34)
CHAR_HP = dict(num_tokens=64, hid_dim=32, n_layers=2, n_heads=2, pf_dim=64,
               max_len=80)
SHORT = dict(max_len=18, beam_size=3, top_k=8)
LONG = dict(max_len=72, beam_size=4, top_k=8, compact=True, canon=True)
# kind -> (port class, JAX class, widths, init seed, EOS bias, call
# arguments, items)
KINDS = {
    "word": (CaptioningTransformer, JaxModel, WORD_HP, 0, 0.75, SHORT, 3),
    "base_canon": (CaptioningTransformerBase, JaxBase, CHAR_HP, 4, 0.2, LONG,
                   12),
    "char": (CaptioningTransformer, JaxModel, CHAR_HP, 1, 0.0, LONG, 12)}


def _model(kind):
    cls, _, hp, seed, eos_bias, _, _ = KINDS[kind]
    model = cls(**hp)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    params["decoder"]["classifier"]["bias"][3] = eos_bias
    return model, params


def _enc(kind, seed=1):
    cls, _, hp, _, _, _, n = KINDS[kind]
    d = hp["hid_dim"]
    rng = np.random.default_rng(seed)
    scale = np.linspace(0.3, 2.0, n, dtype=np.float32)[:, None]
    glob = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)
                            * scale)
    if cls is CaptioningTransformerBase:
        return glob
    return glob, torch.from_numpy(rng.normal(size=(n, 49, d)).astype(
        np.float32) * scale[:, :, None])


def _program(model, params, enc, **kw):
    """The call's Program as generate_from_emb builds it."""
    made = {}
    real = graphs.generate

    def grab(make_program, inputs, gen, *, key, compiled=None):
        made["program"], made["inputs"] = make_program(), inputs
        return real(make_program, inputs, gen, key=key, compiled=compiled)

    graphs.generate = grab
    try:
        model.generate_from_emb(params, enc, **kw)
    finally:
        graphs.generate = real
    return made["program"], made["inputs"]


def _generate(kind, mode, model, params, enc, **kw):
    """One call, eagerly or as a captured call runs it
    (``graphs.run_captured``: each segment and boundary to its end)."""
    gen = torch.Generator().manual_seed(7)
    if mode == "eager":
        return model.generate_from_emb(params, enc, generator=gen, **kw)
    program, inputs = _program(model, params, enc, generator=gen, **kw)
    noise = TS.draw_noise(torch.Generator().manual_seed(7), program.noise,
                          "cpu")
    search = program.begin(inputs, noise)
    ran = graphs.run_captured(
        search, lambda i: search.run_segment(i, eager=False),
        lambda i: search.run_boundary(i, eager=False))
    return program.read_out(program.finish(search), ran)


@functools.lru_cache(maxsize=None)
def _jax_greedy(kind):
    _, jcls, hp, _, _, gen_kw, _ = KINDS[kind]
    _, params = _model(kind)
    jm = jcls(**hp)
    jp = jax.tree.map(jnp.asarray, params_to_jax(params))
    enc = _enc(kind)
    jenc = jax.tree.map(lambda t: jnp.asarray(t.numpy()), enc)
    kw = {k: v for k, v in gen_kw.items() if k not in ("compact", "canon")}
    # the XLA path: JAX runs compaction and canon only inside its Pallas
    # path, and neither changes a result
    return jm.generate_from_emb(jp, jenc, key=jax.random.PRNGKey(0),
                                greedy=True, attn="xla", **kw)


@pytest.mark.parametrize("mode", ["eager", "captured"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_matches_jax(kind, mode):
    model, params = _model(kind)
    got = _generate(kind, mode, model, params, _enc(kind), greedy=True,
                    **KINDS[kind][5])
    if KINDS[kind][5] is LONG:
        # the run compacted and canon phases had stragglers
        assert any(b["live"] for b in got["boundaries"])
        assert any(b["stragglers"] for b in got["boundaries"])
    want = _jax_greedy(kind)
    assert len(np.unique(got["sequences"].numpy())) > 3
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["chosen"].numpy(),
                                  np.asarray(want["chosen"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-4)


@pytest.fixture
def seam_with_copies(monkeypatch):
    """The decode step's seam as it was: q, k and v copied before the
    kernels, K6 into a tensor of its own merged by row mask (the JAX
    package's ``where``)."""
    def copied(fn):
        def run(q, ck, cv, *args, **kw):
            args = [a.contiguous() if isinstance(a, torch.Tensor)
                    and a.ndim == 2 and a.shape == q.shape else a
                    for a in args]
            return fn(q.contiguous(), ck, cv, *args, **kw)
        return run

    def ids_merged(q, ck, cv, bias, item_ids, n_sel, *, out, **kw):
        out_s = A.ancestry_attention_ids(q.contiguous(), ck, cv, bias,
                                         item_ids, n_sel, **kw)
        items = ck.shape[0] // kw["beam"]
        rows = torch.zeros(items, dtype=torch.bool)
        rows[item_ids[:int(n_sel)].long()] = True
        rows = rows.repeat_interleave(kw["beam"])[:, None]
        return out.copy_(torch.where(rows, out_s, out))

    for name in ("ancestry_attention_update",
                 "ancestry_attention_update_canon"):
        monkeypatch.setattr(tfm, name, copied(getattr(A, name)))
    monkeypatch.setattr(tfm, "ancestry_attention_ids", ids_merged)


@pytest.mark.parametrize("mode", ["eager", "captured"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_sampled_equals_the_seam_with_copies(kind, mode, request):
    # the views and the in-place K6 change no draw: the sampled call is
    # bit-equal to one through the copies and the row-mask merge
    model, params = _model(kind)
    enc, kw = _enc(kind), dict(KINDS[kind][5], sampler="pallas",
                               temperature=1.1)
    got = _generate(kind, mode, model, params, enc, **kw)
    request.getfixturevalue("seam_with_copies")
    want = _generate(kind, mode, model, params, enc, **kw)
    if KINDS[kind][5] is LONG:
        assert any(b["stragglers"] for b in got["boundaries"])
    for key in ("sequences", "scores", "chosen", "ended"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("kind", ["word", "base_canon"])
def test_a_call_reads_parameters_changed_in_place(kind):
    # the fused QKV weights are made at each call's prefill, from the
    # parameters as they are then (a trainer updates them in place)
    model, params = _model(kind)
    enc, kw = _enc(kind), dict(KINDS[kind][5], greedy=True)
    before = model.generate_from_emb(params, enc, **kw)
    with torch.no_grad():
        for layer in params["decoder"]["layers"]:
            for name in ("fc_q", "fc_k", "fc_v"):
                layer["self_attn"][name]["weight"].mul_(3.0)
                layer["self_attn"][name]["bias"].add_(0.5)
    after = model.generate_from_emb(params, enc, **kw)
    fresh = model.generate_from_emb(
        tree_map(lambda t: t.clone(), params), enc, **kw)
    for key in ("sequences", "scores", "chosen"):
        assert torch.equal(after[key], fresh[key]), key
    assert not torch.equal(after["scores"], before["scores"])


def test_decode_step_fuses_unfused_parameters_alike():
    # decode_step on a tree without the fused weights fuses them itself,
    # with the same result as on the fused tree that generation passes
    model, params = _model("word")
    dec = params["decoder"]
    rng = np.random.default_rng(3)
    bs, p = 6, 24
    emb = torch.from_numpy(rng.normal(size=(bs, 64)).astype(np.float32))
    valid = torch.zeros(bs, p, dtype=torch.bool)
    valid[:, :3] = True
    spatial = torch.from_numpy(rng.normal(size=(2, 49, 64)).astype(
        np.float32))
    anc = torch.from_numpy(rng.integers(0, 3, size=(2, 3, p)))
    outs = []
    for tree in (dec, tfm.fuse_qkv(dec)):
        cache = tfm.init_cache(tree, bs, p)
        outs.append(tfm.decode_step(
            tree, emb, 2, cache, valid, 2,
            tfm.precompute_cross_attention(tree, spatial), anc=anc,
            p_eff=8))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert "qkv" not in dec["layers"][0]["self_attn"]
