"""The capture-safe decode loop of deephumor_tpu_torch (models/sampling.py
``BeamSearch``, models/graphs.py) on the CPU, where no graph exists: its
body run as the graphs run it (segment by segment, the early exit read
only between segments) against a plain per-step loop and against the
JAX package; no host read inside a step; the K3/K4 twins' device-seed
form; the graph key; and the launch tally of a captured graph."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deephumor_tpu.models import CaptioningLSTM as JaxLSTM
from deephumor_tpu.models import CaptioningTransformer as JaxModel
from deephumor_tpu.models import CaptioningTransformerBase as JaxBase
from deephumor_tpu_torch.convert.jax_params import params_to_jax
from deephumor_tpu_torch.models import (CaptioningLSTM,
                                        CaptioningTransformer,
                                        CaptioningTransformerBase, graphs)
from deephumor_tpu_torch.models import sampling as TS
from deephumor_tpu_torch.ops import _build
from deephumor_tpu_torch.ops import sampler as S

V = 300
TFM_HP = dict(num_tokens=V, hid_dim=64, n_layers=2, n_heads=2, pf_dim=128,
              max_len=34)
LSTM_HP = dict(num_tokens=V, emb_dim=64, hidden_size=64, num_layers=2)
# 17 steps: two transformer phases (p_eff 16, then 24), LSTM segments of
# 8, 8 and 1 steps
GEN = dict(max_len=18, beam_size=3, top_k=8)
N_ITEMS = 3
KINDS = ("word", "base", "lstm")
MODES = [("exact", True), ("exact", False), ("pallas", False)]


# EOS biases at which some branches end and some do not within GEN's
# steps (random weights give near-uniform logits)
EOS_BIAS = {"word": 0.75, "base": 0.75, "lstm": 0.13}


def _model(kind, eos_bias=None, seed=0):
    eos_bias = EOS_BIAS[kind] if eos_bias is None else eos_bias
    cls = {"word": CaptioningTransformer, "base": CaptioningTransformerBase,
           "lstm": CaptioningLSTM}[kind]
    model = cls(**(LSTM_HP if kind == "lstm" else TFM_HP))
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    params["decoder"]["classifier"]["bias"][3] = eos_bias
    return model, params


def _enc(kind, n=N_ITEMS, seed=1):
    rng = np.random.default_rng(seed)
    glob = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
    if kind != "word":
        return glob
    return glob, torch.from_numpy(
        rng.normal(size=(n, 49, 64)).astype(np.float32))


def _program(model, params, enc, **kw):
    """The call's Program as generate_from_emb builds it (CPU: eager)."""
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


def _as_captured(program, inputs, noise):
    """The program as a captured call runs it: every segment up to the
    first boundary to its end, ``ended.all()`` read only between them,
    then the eager rest and the final pick."""
    search = program.begin(inputs, noise)
    n = search.captured_segments
    for i in range(n):
        if i and search.all_ended():
            break
        search.run_segment(i, eager=False)
    return program.finish(TS.run_eagerly(search, n)), search


def _reference_loop(search):
    """A plain per-step loop over a started search (no boundary, default
    survivor update): new tensors each step, the early exit read before
    each step, the same up-front draws."""
    n, beam, noise = search.n, search.beam, search.noise
    seq, val, ended = (t.clone() for t in (search.seq, search.val,
                                           search.ended))
    state, items, col = search.state, search.items, search.col
    for first, last, step_fn, boundary in search.segments:
        assert boundary is None
        for s in range(first, last + 1):
            if bool(ended.all()):
                break
            pos = search.prefix_len + s
            out, state = step_fn(state, seq[:, :, pos - 1].reshape(-1))
            u = noise["cand"][s, :out.shape[0]] if "cand" in noise else None
            seed = int(noise["seeds"][s]) if "seeds" in noise else None
            new_idx, new_val = TS._topk_space_draw(
                u, out, search.top_k, beam, search.inv_t, search.greedy,
                search.unk, search.sampler, search.classifier, seed)
            new_idx = new_idx.reshape(n, beam, beam)
            new_val = new_val.reshape(n, beam, beam)
            e3 = ended[..., None]
            cand_val = val[..., None] + new_val.masked_fill(e3, 0.0)
            weight = torch.where(~e3 | (col == 0), cand_val * search.inv_t,
                                 float("-inf")).reshape(n, -1)
            surv = TS._select_k(None if search.greedy else
                                noise["surv"][s - 1], weight, beam,
                                search.greedy)
            branch = surv // beam
            chosen = new_idx.masked_fill(e3, search.pad).reshape(
                n, -1).gather(1, surv)
            val = cand_val.reshape(n, -1).gather(1, surv)
            seq = seq[items, branch].clone()
            seq[:, :, pos] = chosen
            ended = ended.gather(1, branch) | (chosen == search.eos)
            state = search.shuffle_fn(state, (items * beam + branch).reshape(
                -1), branch)
    final = TS._select_k(noise.get("final"), val * search.inv_t, 1,
                         search.greedy)[:, 0]
    return {"sequences": seq, "scores": val, "chosen": seq[items[:, 0], final],
            "ended": ended}


def _equal(a, b, keys=("sequences", "scores", "chosen", "ended")):
    for key in keys:
        assert torch.equal(a[key], b[key]), key


def _kw(sampler, greedy, **extra):
    return dict(GEN, sampler=sampler, greedy=greedy, temperature=1.1,
                generator=torch.Generator().manual_seed(7), **extra)


@pytest.fixture
def no_host_reads(monkeypatch):
    """Makes every host read of a tensor raise while ``active`` is set."""
    active = threading.Event()

    def guard(name, real):
        def run(self, *a, **k):
            if active.is_set():
                raise AssertionError(f"host read {name} inside the body")
            return real(self, *a, **k)
        return run

    for name in ("item", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name,
                            guard(name, getattr(torch.Tensor, name)))
    return active


# every family and sampling mode; the transformers also with K10's twin
# (DH_FUSED_SURVIVOR=1)
BODY_CASES = ([(k, s, g, False) for k in KINDS for s, g in MODES]
              + [(k, s, g, True) for k in ("word", "base") for s, g in MODES])


@pytest.mark.parametrize("kind,sampler,greedy,fused", BODY_CASES)
def test_body_equals_a_plain_per_step_loop(no_host_reads, monkeypatch, kind,
                                           sampler, greedy, fused):
    # (a): the eager loop (compiled=False), the loop as the graphs run it
    # and a plain per-step loop give the same outputs from the same draws;
    # (c): the prefill and first draw, each segment and the final pick,
    # run as the graphs run them, read nothing from a tensor
    if fused:
        monkeypatch.setenv("DH_FUSED_SURVIVOR", "1")
    model, params = _model(kind)
    enc = _enc(kind)
    eager = model.generate_from_emb(params, enc, **_kw(sampler, greedy))
    assert eager["ended"].any() and not eager["ended"].all()
    program, inputs = _program(model, params, enc, **_kw(sampler, greedy))
    noise = TS.draw_noise(torch.Generator().manual_seed(7), program.noise,
                          "cpu")
    no_host_reads.set()
    search = program.begin(inputs, noise)
    assert search.captured_segments == len(search.segments)
    for i in range(len(search.segments)):
        search.run_segment(i, eager=False)
    captured = program.finish(search)
    no_host_reads.clear()
    _equal(captured, eager)
    if not fused:
        _equal(_reference_loop(program.begin(inputs, noise)), eager)
    # the LSTM's steps in segments of up to 8 (a graph each on the card)
    if kind == "lstm":
        assert [b - a + 1 for a, b, *_ in search.segments] == [8, 8, 1]
    else:
        assert [b - a + 1 for a, b, *_ in search.segments] == [15, 2]


@pytest.mark.parametrize("kind", KINDS)
def test_one_item_with_several_branches(kind):
    # the prefill's rows tiled per branch are copies, not a broadcast view
    # that the steps would write through
    model, params = _model(kind)
    enc = tuple(t[:1] for t in _enc(kind)) if kind == "word" else _enc(
        kind)[:1]
    got = model.generate_from_emb(params, enc, **_kw("pallas", False))
    program, inputs = _program(model, params, enc, **_kw("pallas", False))
    noise = TS.draw_noise(torch.Generator().manual_seed(7), program.noise,
                          "cpu")
    _equal(got, _reference_loop(program.begin(inputs, noise)))
    assert got["sequences"].shape == (1, 3, GEN["max_len"])


@pytest.mark.parametrize("kind,attn", [("word", "xla"),
                                       ("word", "pallas_interpret"),
                                       ("base", "xla"), ("lstm", None)])
def test_greedy_through_the_body_matches_jax(kind, attn):
    # (b)
    model, params = _model(kind, eos_bias=-2.0)
    # wider logits: the small LSTM's greedy path repeats one token
    params["decoder"]["classifier"]["weight"] *= 8.0
    enc = _enc(kind, n=3)
    program, inputs = _program(model, params, enc, greedy=True, **GEN)
    got, _ = _as_captured(program, inputs, {})
    jcls = {"word": JaxModel, "base": JaxBase, "lstm": JaxLSTM}[kind]
    jm = jcls(**(LSTM_HP if kind == "lstm" else TFM_HP))
    jp = jax.tree.map(jnp.asarray, params_to_jax(params))
    jenc = jax.tree.map(lambda t: jnp.asarray(t.numpy()), enc)
    kw = {} if attn is None else {"attn": attn}
    want = jm.generate_from_emb(jp, jenc, key=jax.random.PRNGKey(0),
                                greedy=True, **kw, **GEN)
    assert len(np.unique(got["sequences"].numpy())) > 3
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["chosen"].numpy(),
                                  np.asarray(want["chosen"]))


def test_phases_before_the_first_boundary_have_no_host_read(no_host_reads):
    # with compaction (forced on: 8 items, 39 steps) the phases up to the
    # first boundary (p_eff 24) are captured; the boundaries and what
    # follows run eagerly from the state the last graph left
    model, params = _model("word", eos_bias=1.0)
    enc = _enc("word", n=8, seed=4)
    kw = dict(max_len=40, beam_size=3, top_k=8, sampler="pallas",
              temperature=1.1, compact=True)
    program, inputs = _program(model, params, enc, **kw)
    noise = TS.draw_noise(torch.Generator().manual_seed(7), program.noise,
                          "cpu")
    no_host_reads.set()
    search = program.begin(inputs, noise)
    n = search.captured_segments
    assert 0 < n < len(search.segments)
    for i in range(n):
        search.run_segment(i, eager=False)
    no_host_reads.clear()
    out = program.finish(TS.run_eagerly(search, n))
    eager = model.generate_from_emb(
        params, enc, generator=torch.Generator().manual_seed(7), **kw)
    _equal(out, eager)
    assert out["boundaries"] == eager["boundaries"]
    assert out["boundaries"][0]["p_eff"] == 24
    assert out["boundaries"][0]["live"] < 8


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sampler,greedy", MODES)
def test_extra_steps_after_every_branch_ended_change_nothing(
        kind, sampler, greedy):
    # (f): a high EOS bias ends every branch within a few steps; the
    # graphs then run their segments to the end
    model, params = _model(kind, eos_bias=6.0)
    enc = _enc(kind)
    program, inputs = _program(model, params, enc, **_kw(sampler, greedy))
    noise = TS.draw_noise(torch.Generator().manual_seed(7), program.noise,
                          "cpu")
    search = program.begin(inputs, noise)
    for i in range(len(search.segments)):
        search.run_segment(i, eager=False)
    full = program.finish(search)
    eager = model.generate_from_emb(params, enc, **_kw(sampler, greedy))
    assert eager["ended"].all()
    # every branch ended well before the last step
    assert (eager["sequences"][:, :, GEN["max_len"] // 2:] == 0).all()
    _equal(full, eager)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_twin_takes_a_seed_tensor(dtype):
    # (d)
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(24, 300, generator=g).to(dtype)
    kw = dict(top_k=8, num_draws=3, live_rows=20)
    want = S.fused_topk_gumbel_sample(logits, 12345, 0.9, **kw)
    seed = torch.tensor([12345], dtype=torch.int32)
    for got in (S.fused_topk_gumbel_sample(logits, seed, 0.9, **kw),
                S.fused_topk_gumbel_sample_plain(logits, seed, 0.9, **kw)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    other = S.fused_topk_gumbel_sample(
        logits, torch.tensor([54321], dtype=torch.int32), 0.9, **kw)
    assert not torch.equal(other[0], want[0])


def test_k4_twin_takes_a_seed_tensor():
    # (d)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(18, 32, generator=g)
    w = torch.randn(64, 32, generator=g)
    b = torch.randn(64, generator=g)
    kw = dict(top_k=8, num_draws=3, live_rows=12)
    want = S.fused_classifier_topk_gumbel_sample(x, w, b, 777, 1.0, **kw)
    seeds = torch.tensor([5, 777, 9], dtype=torch.int32)
    for got in (S.fused_classifier_topk_gumbel_sample(x, w, b, seeds[1:2],
                                                      1.0, **kw),
                S.fused_classifier_topk_gumbel_sample_plain(
                    x, w, b, seeds[1:2], 1.0, **kw)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("seed", [torch.tensor([3], dtype=torch.int64),
                                  torch.tensor([3, 4], dtype=torch.int32),
                                  -1, 2 ** 31])
def test_sampler_rejects_bad_seeds(seed):
    logits = torch.randn(4, 64)
    with pytest.raises(ValueError):
        S.fused_topk_gumbel_sample(logits, seed, 1.0, top_k=8, num_draws=2)


def test_noise_is_drawn_up_front_in_range():
    shapes = TS.noise_shapes(steps=31, num_items=5, beam_size=3, top_k=8,
                             sampler="pallas", greedy=False)
    assert shapes == {"seeds": (31,), "surv": (30, 5, 9), "final": (5, 3)}
    noise = TS.draw_noise(torch.Generator().manual_seed(0), shapes, "cpu")
    assert noise["seeds"].dtype == torch.int32
    assert ((noise["seeds"] >= 0) & (noise["seeds"] < 2 ** 31 - 1)).all()
    # the same generator state draws the same numbers into given buffers
    again = TS.draw_noise(torch.Generator().manual_seed(0), shapes, "cpu",
                          out={k: torch.zeros_like(v)
                               for k, v in noise.items()})
    for k in shapes:
        assert torch.equal(noise[k], again[k])
    assert TS.noise_shapes(steps=31, num_items=5, beam_size=3, top_k=8,
                           sampler="exact", greedy=True) == {}


def _keys(monkeypatch, model, params, enc, calls):
    """The graph key of each generate_from_emb call (``calls``: pairs of
    (keyword arguments, environment))."""
    keys = []
    real = graphs.generate

    def grab(make_program, inputs, gen, *, key, compiled=None):
        keys.append(key())
        return real(make_program, inputs, gen, key=key, compiled=compiled)

    monkeypatch.setattr(graphs, "generate", grab)
    for kw, env in calls:
        for name in ("DH_CROSS_PACK", "DH_FUSED_SURVIVOR"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        model.generate_from_emb(params, kw.pop("enc", enc),
                                **dict(dict(GEN, max_len=6), **kw))
    return keys


def test_graph_key_tracks_what_a_graph_bakes_in(monkeypatch):
    # (e)
    model, params = _model("word")
    enc = _enc("word")
    other = {k: v for k, v in params.items()}
    other["decoder"] = dict(params["decoder"], classifier={
        k: v.clone() for k, v in params["decoder"]["classifier"].items()})
    keys = _keys(monkeypatch, model, params, enc, [
        ({}, {}),
        ({}, {}),
        ({"enc": _enc("word", n=N_ITEMS + 1)}, {}),
        ({"temperature": 0.7}, {}),
        ({}, {"DH_CROSS_PACK": "4"}),
        ({}, {"DH_FUSED_SURVIVOR": "1"}),
        ({"greedy": True}, {}),
    ])
    assert keys[0] == keys[1]
    assert len(set(keys[1:])) == len(keys) - 1
    monkeypatch.undo()
    new = _keys(monkeypatch, model, other, enc, [({}, {})])
    assert new[0] != keys[0]


def test_compiled_runs_eagerly_on_the_cpu():
    assert not graphs.use_graphs(None, "cpu")
    assert not graphs.use_graphs(True, torch.device("cpu"))
    assert graphs.use_graphs(None, "cuda") and graphs.use_graphs(True, "cuda")
    assert not graphs.use_graphs(False, "cuda")
    model, params = _model("lstm")
    enc = _enc("lstm")
    outs = [model.generate_from_emb(params, enc, compiled=c,
                                    **_kw("pallas", False))
            for c in (None, False, True)]
    _equal(outs[0], outs[1])
    _equal(outs[0], outs[2])


def test_launch_tally_of_a_captured_graph():
    # counts of a captured call: a launch noted while a graph is captured
    # goes into the graph's tally, and each replay adds it
    _build.reset_launch_counts()
    with _build.capture_tally() as tally:
        _build.note_launch("fused_topk_gumbel_sample")
        _build.note_launch("ancestry_attention_update")
        _build.note_launch("ancestry_attention_update")
        # another thread's launches run now, outside the capture
        t = threading.Thread(
            target=_build.note_launch, args=("grouped_cross_attention",))
        t.start()
        t.join()
    assert tally == {"fused_topk_gumbel_sample": 1,
                     "ancestry_attention_update": 2}
    assert _build.LAUNCHES["grouped_cross_attention"] == 1
    assert _build.LAUNCHES["ancestry_attention_update"] == 0
    for _ in range(3):
        _build.add_launches(tally)
    assert _build.LAUNCHES["ancestry_attention_update"] == 6
    assert _build.LAUNCHES["fused_topk_gumbel_sample"] == 3
    _build.note_launch("fused_topk_gumbel_sample")
    assert _build.LAUNCHES["fused_topk_gumbel_sample"] == 4
    _build.reset_launch_counts()
