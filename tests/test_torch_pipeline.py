"""deephumor_tpu_torch's MemeGenerationPipeline against the JAX
package's on the same weights: greedy caption text (also padded and
after a template refresh) for the decoder-only and cross-attention
transformers and the labelled LSTM, and rendered memes through the
thread pool and a spawn process pool of two."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deephumor_tpu.data import Vocab as JaxVocab
from deephumor_tpu.models import CaptioningLSTMWithLabels as JaxLSTMLabels
from deephumor_tpu.models import CaptioningTransformer as JaxTransformer
from deephumor_tpu.models import CaptioningTransformerBase as JaxBase
from deephumor_tpu.pipeline import MemeGenerationPipeline as JaxPipeline
from deephumor_tpu_torch.convert.jax_params import params_to_jax
from deephumor_tpu_torch.data import Vocab
from deephumor_tpu_torch.models import (CaptioningLSTMWithLabels,
                                        CaptioningTransformer,
                                        CaptioningTransformerBase)
from deephumor_tpu_torch.ops.image_ops import preprocess_batch
from deephumor_tpu_torch.pipeline import MemeGenerationPipeline, derive_seed

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

WORDS = ["when", "you", "ship", "it", "works", "and", "bug", "<sep>", "the",
         "fix", "breaks", "prod", "again", "!", "?", "friday"]
GEN = dict(max_len=10, beam_size=2, top_k=5, greedy=True)
IDS = ["a", "b", "c", "a", "c", "b"]
MODELS = {
    "base": (CaptioningTransformerBase, JaxBase,
             dict(hid_dim=32, n_layers=2, n_heads=2, pf_dim=48, max_len=16)),
    "transformer": (CaptioningTransformer, JaxTransformer,
                    dict(hid_dim=32, n_layers=1, n_heads=2, pf_dim=48,
                         max_len=16)),
    "lstm_labels": (CaptioningLSTMWithLabels, JaxLSTMLabels,
                    dict(emb_dim=16, hidden_size=24, num_layers=1)),
}


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 64, 64, 3)).astype(np.float32)


def _labels(n, seed):
    return np.random.default_rng(seed).integers(6, len(Vocab(WORDS)), (n, 3))


def _pils(n):
    return [Image.new("RGB", (160, 120), (30 * i, 60, 90)) for i in range(n)]


def _pipes(name, **kw):
    cls, jcls, hp = MODELS[name]
    vocab = Vocab(WORDS)
    model = cls(num_tokens=len(vocab), **hp)
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    # a low EOS bias keeps captions several tokens long
    params["decoder"]["classifier"]["bias"][3] = -1.0
    jparams = jax.tree.map(jnp.asarray, params_to_jax(params))
    return (MemeGenerationPipeline(model, params, vocab, **kw),
            JaxPipeline(jcls(num_tokens=len(vocab), **hp), jparams,
                        JaxVocab(WORDS)))


def _add(name, pipes, ids, images, pils=None, seed=0):
    for pipe in pipes:
        extra = ({"label_ids": _labels(len(ids), seed)}
                 if name == "lstm_labels" else {})
        pipe.add_templates(ids, images, pil_images=pils, **extra)


@pytest.mark.parametrize("name", list(MODELS))
def test_generate_captions_matches_jax(name):
    port, jax_pipe = _pipes(name)
    _add(name, (port, jax_pipe), ["a", "b", "c"], _images(3, 1))
    texts = port.generate_captions(IDS, **GEN)
    assert texts == jax_pipe.generate_captions(IDS, **GEN)
    assert min(len(t.split()) for t in texts) > 2
    # padded to a fixed batch: the same texts, cut back to the request
    padded = port.generate_captions(IDS[:5], pad_to=8, **GEN)
    assert padded == jax_pipe.generate_captions(IDS[:5], pad_to=8, **GEN)
    assert padded == texts[:5]
    # a refreshed id serves its new encoding; later ids get fresh rows
    extra = {"label_ids": _labels(1, 9)[0]} if name == "lstm_labels" else {}
    for pipe in (port, jax_pipe):
        pipe.add_template("a", _images(1, 2)[0], **extra)
        pipe.add_template("d", _images(1, 3)[0], **extra)
    assert len(set(port._row.values())) == 4
    ids = ["d", "a", "b", "c", "a", "d"]
    after = port.generate_captions(ids, **GEN)
    assert after == jax_pipe.generate_captions(ids, **GEN)
    assert after[2:4] == texts[1:3]  # b and c unchanged


def test_template_store_gathers_the_encodings():
    port, _ = _pipes("transformer")
    images = torch.from_numpy(_images(5, 4))
    port.add_templates(list("vwxyz"), images, batch_size=2)
    port.add_template("w", images[0])
    got = port._stack_features(["w", "z", "v"])
    want = port.model.encode(port.params, images[[0, 4, 0]])
    # encoded in other batches: the CPU convolutions round apart by ~1e-5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    with pytest.raises(KeyError):
        port._stack_features(["nope"])


def test_add_templates_takes_preprocess_batch_output():
    port, _ = _pipes("base")
    u8 = np.random.default_rng(5).integers(0, 256, (3, 90, 120, 3),
                                           dtype=np.uint8)
    x = preprocess_batch(torch.from_numpy(u8), (64, 64))
    port.add_templates(["p", "q", "r"], x)
    port.add_templates(["s", "t", "u"], x.numpy())
    a, b = port._stack_features(["p", "q", "r", "s", "t", "u"]).split(3)
    assert torch.equal(a, b)


@pytest.mark.parametrize("procs", [0, 2])
def test_generate_memes_renders_what_jax_renders(procs):
    port, jax_pipe = _pipes("base", render_processes=procs)
    pils = _pils(3)
    _add("base", (port, jax_pipe), ["a", "b", "c"], _images(3, 6), pils)
    port.warm_render_pool()
    try:
        got = port.generate_memes(IDS, **GEN)
        want = jax_pipe.generate_memes(IDS, **GEN)
        assert [(t, x) for t, x, _ in got] == [(t, x) for t, x, _ in want]
        for (_, _, gi), (_, _, wi) in zip(got, want):
            assert gi.size == (160, 120) and gi.tobytes() == wi.tobytes()
        batched = port.generate_memes_batched(IDS + ["b"], batch_size=4,
                                              seed=3, **GEN)
        assert [(t, x) for t, x, _ in batched[:6]] == [
            (t, x) for t, x, _ in got]
        assert all(img.tobytes() == g[2].tobytes()
                   for (_, _, img), g in zip(batched, got))
    finally:
        port.close()


def test_sampled_generation_is_seeded_by_the_generator():
    port, _ = _pipes("transformer")
    _add("transformer", (port,), ["a", "b"], _images(2, 7))
    ids = ["a", "b"] * 4
    kw = dict(max_len=10, beam_size=2, top_k=5, sampler="pallas")

    def run(seed):
        return port.generate_captions(
            ids, torch.Generator().manual_seed(seed), **kw)

    assert run(1) == run(1) and run(1) != run(2)
    assert port.generate_captions(ids, **kw) == run(0)
    seeds = {derive_seed(s, n) for s in range(4) for n in range(64)}
    assert len(seeds) == 256 and all(0 <= s < 2 ** 63 for s in seeds)
