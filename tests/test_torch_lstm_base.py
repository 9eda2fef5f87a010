"""deephumor_tpu_torch's LSTM captioners and decoder-only transformer
against the JAX package on the CPU: the LSTM cell and layers, parameter
conversion, greedy generation (from embeddings and from images), the
Base model through compaction and canonical-prefix attention, and the
LSTM's fused-classifier draw on both sides of V = 16384."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deephumor_tpu.models import CaptioningLSTM as JaxLSTM
from deephumor_tpu.models import CaptioningLSTMWithLabels as JaxLSTMLabels
from deephumor_tpu.models import CaptioningTransformerBase as JaxBase
from deephumor_tpu.models import lstm as jlstm
from deephumor_tpu_torch.convert.jax_params import params_from_jax
from deephumor_tpu_torch.models import (MODEL_REGISTRY, CaptioningLSTM,
                                        CaptioningLSTMWithLabels,
                                        CaptioningTransformer,
                                        CaptioningTransformerBase)
from deephumor_tpu_torch.models import lstm as tlstm
from deephumor_tpu_torch.models import sampling as TS
from deephumor_tpu_torch.utils.pytree import load_params
from test_torch_model import _flat, _images, _to_jax_tree

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

LSTM_HP = dict(num_tokens=211, emb_dim=32, hidden_size=64, num_layers=2)
BASE_HP = dict(num_tokens=211, hid_dim=128, n_layers=2, n_heads=4,
               pf_dim=256, max_len=32)
GEN = dict(max_len=30, beam_size=3, top_k=8)
# the long-generation config of tests/test_torch_char.py
CHAR_HP = dict(num_tokens=64, hid_dim=32, n_layers=2, n_heads=2, pf_dim=64,
               max_len=80)
CHAR_GEN = dict(max_len=72, beam_size=4, top_k=8)
N_ITEMS = 12


def _to_jax(node):
    """The port's tree in the JAX layout, LSTM layers included."""
    if isinstance(node, list):
        return [_to_jax(v) for v in node]
    if "weight_ih" in node:
        return {"wi": node["weight_ih"].T, "wh": node["weight_hh"].T,
                "bi": node["bias_ih"], "bh": node["bias_hh"]}
    if "weight" in node or "running_mean" in node:
        return _to_jax_tree(node)
    return {k: _to_jax(v) for k, v in node.items()}


def _jax_params(tp):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), _to_jax(tp))


def _pair(cls, jcls, hp, seed, eos_bias):
    tm = cls(**hp)
    tp = tm.init(torch.Generator().manual_seed(seed), device="cpu")
    tp["decoder"]["classifier"]["bias"][3] = eos_bias
    return tm, tp, jcls(**hp), _jax_params(tp)


@pytest.fixture(scope="module")
def models():
    # low EOS biases keep branches alive through the whole generation
    return {
        "lstm": _pair(CaptioningLSTM, JaxLSTM, LSTM_HP, 0, -2.0),
        "lstm_labels": _pair(CaptioningLSTMWithLabels, JaxLSTMLabels,
                             LSTM_HP, 1, -2.0),
        "base": _pair(CaptioningTransformerBase, JaxBase, BASE_HP, 2, -2.0),
    }


def _labels(n=2):
    return np.random.default_rng(3).integers(4, LSTM_HP["num_tokens"],
                                             size=(n, 5))


def test_lstm_forward_and_step_match_jax():
    rng = np.random.default_rng(4)
    layers = [{"wi": rng.normal(size=(i, 4 * 24)).astype(np.float32) / 4,
               "wh": rng.normal(size=(24, 4 * 24)).astype(np.float32) / 4,
               "bi": rng.normal(size=4 * 24).astype(np.float32),
               "bh": rng.normal(size=4 * 24).astype(np.float32)}
              for i in (16, 24, 24)]
    x = rng.normal(size=(5, 7, 16)).astype(np.float32)
    h0, c0 = (rng.normal(size=(3, 5, 24)).astype(np.float32)
              for _ in range(2))
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in layers]
    tp = params_from_jax(layers)
    assert tp[0]["weight_ih"].shape == (96, 16)
    want = jlstm.lstm_forward(jp, jnp.asarray(x), jnp.asarray(h0),
                              jnp.asarray(c0))
    got = tlstm.lstm_forward(tp, torch.from_numpy(x), torch.from_numpy(h0),
                             torch.from_numpy(c0))
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    want = jlstm.lstm_step(jp, jnp.asarray(x[:, 0]), jnp.asarray(h0),
                           jnp.asarray(c0))
    got = tlstm.lstm_step(tp, torch.from_numpy(x[:, 0]),
                          torch.from_numpy(h0), torch.from_numpy(c0))
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("name", ["lstm", "lstm_labels", "base"])
def test_params_from_jax_round_trip(models, name, tmp_path):
    tm, tp, jm, jp = models[name]
    jm.save(jp, tmp_path / "ckpt")
    tree, hp = load_params(tmp_path / "ckpt.npz")
    assert hp["model_type"] == tm.model_type
    want, got = _flat(tp), _flat(params_from_jax(tree))
    assert want.keys() == got.keys()
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    if name == "lstm_labels":
        # one token table, the label encoder's, serves the decoder too
        assert "embedding" not in tp["decoder"]
        assert "/encoder/label_encoder/embedding/weight" in got
    # the checkpoint's model_type picks the class; a base class loads its
    # subclasses, never the other way round
    base = (CaptioningTransformerBase if name == "base" else CaptioningLSTM)
    model, params = base.from_pretrained(tmp_path / "ckpt.npz", device="cpu")
    assert model == tm and MODEL_REGISTRY[tm.model_type] is type(tm)
    if name == "lstm":
        with pytest.raises(ValueError, match="not a"):
            CaptioningLSTMWithLabels.from_pretrained(tmp_path / "ckpt.npz",
                                                     device="cpu")
    if name == "base":
        with pytest.raises(ValueError, match="not a"):
            CaptioningTransformer.from_pretrained(tmp_path / "ckpt.npz",
                                                  device="cpu")


def _emb(name, n=3):
    width = BASE_HP["hid_dim"] if name == "base" else LSTM_HP["emb_dim"]
    return np.random.default_rng(5).normal(size=(n, width)).astype(
        np.float32)


@pytest.mark.parametrize("name,attn", [("lstm", None), ("lstm_labels", None),
                                       ("base", "xla"),
                                       ("base", "pallas_interpret")])
def test_greedy_generate_from_emb_matches_jax(models, name, attn):
    tm, tp, jm, jp = models[name]
    emb = _emb(name)
    kw = {} if attn is None else {"attn": attn}
    want = jm.generate_from_emb(jp, jnp.asarray(emb),
                                key=jax.random.PRNGKey(0), greedy=True, **kw,
                                **GEN)
    got = tm.generate_from_emb(tp, torch.from_numpy(emb), greedy=True, **GEN)
    seq = got["sequences"].numpy()
    assert seq.shape == (3, 3, GEN["max_len"]) and len(np.unique(seq)) > 5
    assert not got["ended"].any()  # every step ran
    np.testing.assert_array_equal(seq, np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["chosen"].numpy(),
                                  np.asarray(want["chosen"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-4)


def test_greedy_lstm_with_prefix_matches_jax(models):
    tm, tp, jm, jp = models["lstm"]
    emb = _emb("lstm", n=2)
    prefix = np.random.default_rng(7).integers(6, LSTM_HP["num_tokens"],
                                               size=(2, 4))
    want = jm.generate_from_emb(jp, jnp.asarray(emb),
                                key=jax.random.PRNGKey(0),
                                caption=jnp.asarray(prefix, jnp.int32),
                                greedy=True, **GEN)["chosen"]
    got = tm.generate_from_emb(tp, torch.from_numpy(emb),
                               caption=torch.from_numpy(prefix), greedy=True,
                               **GEN)["chosen"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:, :4], prefix)


@pytest.mark.parametrize("name", ["lstm", "lstm_labels", "base"])
def test_greedy_generate_from_images_matches_jax(models, name):
    tm, tp, jm, jp = models[name]
    imgs = _images(0.05)
    args = (imgs, _labels()) if name == "lstm_labels" else (imgs,)
    kw = {"attn": "xla"} if name == "base" else {}
    want = jm.generate(jp, *map(jnp.asarray, args),
                       key=jax.random.PRNGKey(0), greedy=True, **kw, **GEN)
    got = tm.generate(tp, *map(torch.from_numpy, args), greedy=True, **GEN)
    np.testing.assert_array_equal(got["chosen"].numpy(),
                                  np.asarray(want["chosen"]))
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))


def test_greedy_base_compact_canon_matches_jax():
    # items at several embedding scales end at different steps, so the run
    # compacts and its canon boundaries find stragglers
    tm, tp, jm, jp = _pair(CaptioningTransformerBase, JaxBase, CHAR_HP, 4,
                           0.2)
    rng = np.random.default_rng(1)
    scale = np.linspace(0.3, 2.0, N_ITEMS, dtype=np.float32)[:, None]
    emb = rng.normal(size=(N_ITEMS, CHAR_HP["hid_dim"])).astype(
        np.float32) * scale
    got = tm.generate_from_emb(tp, torch.from_numpy(emb), greedy=True,
                               compact=True, canon=True, **CHAR_GEN)
    assert [b["p_eff"] for b in got["boundaries"]] == [24, 40, 48, 56, 64]
    assert min(b["live"] or N_ITEMS for b in got["boundaries"]) < N_ITEMS
    assert any(b["stragglers"] for b in got["boundaries"])
    want = jm.generate_from_emb(jp, jnp.asarray(emb),
                                key=jax.random.PRNGKey(0), greedy=True,
                                attn="pallas_interpret", compact=True,
                                canon=True, **CHAR_GEN)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["chosen"].numpy(),
                                  np.asarray(want["chosen"]))


@pytest.mark.parametrize("vocab,fused", [(300, True), (16500, False)])
def test_lstm_pallas_sampler_draws_in_support(monkeypatch, vocab, fused):
    # V <= 16384: the draw runs the classifier inside K4; above it, a bf16
    # product and then K3
    calls = {"k3": 0, "k4": 0}

    def counted(key, fn):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(TS, "fused_topk_gumbel_sample",
                        counted("k3", TS.fused_topk_gumbel_sample))
    monkeypatch.setattr(TS, "fused_classifier_topk_gumbel_sample",
                        counted("k4", TS.fused_classifier_topk_gumbel_sample))
    tm = CaptioningLSTM(num_tokens=vocab, emb_dim=16, hidden_size=32,
                        num_layers=2)
    tp = tm.init(torch.Generator().manual_seed(6), device="cpu")
    tp["decoder"]["classifier"]["bias"][1] = 30.0  # UNK on top
    emb = torch.randn(3, 16, generator=torch.Generator().manual_seed(7))
    outs = [tm.generate_from_emb(
        tp, emb, generator=torch.Generator().manual_seed(s), max_len=8,
        beam_size=3, top_k=8, sampler="pallas") for s in (1, 1, 2)]
    seq = outs[0]["sequences"]
    assert ((seq >= 0) & (seq < vocab) & (seq != 1)).all()
    assert torch.isfinite(outs[0]["scores"]).all()
    assert torch.equal(seq, outs[1]["sequences"])
    assert not torch.equal(seq, outs[2]["sequences"])
    # the first draw samples the prefill's logits with K3 on both sides
    steps = 7 * 3
    assert calls == ({"k3": 3, "k4": steps} if fused
                     else {"k3": 3 + steps, "k4": 0})
