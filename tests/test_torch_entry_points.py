"""deephumor_tpu_torch's user entry points on the CPU at small widths:
``generate_meme`` (``caption_image`` greedy from a reference-layout
``.pth``, and the command line from an image file) against the JAX
package's ``from_torch`` + ``generate`` + ``seq_to_text`` +
``split_caption``; ``sweep`` at 4 templates x 2 captions; the demo's
four architectures, word and char."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from deephumor_tpu.data import CharTokenizer as JaxCharTokenizer
from deephumor_tpu.data import Vocab as JaxVocab
from deephumor_tpu.data import WordPunctTokenizer as JaxWordPunctTokenizer
from deephumor_tpu.experiments import seq_to_text as jax_seq_to_text
from deephumor_tpu.experiments import split_caption as jax_split_caption
from deephumor_tpu.experiments import text_to_seq as jax_text_to_seq
from deephumor_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from deephumor_tpu.ops import preprocess_pil as jax_preprocess_pil
from deephumor_tpu_torch import demo, generate_meme, sweep
from deephumor_tpu_torch.data import (CharTokenizer, Vocab,
                                      WordPunctTokenizer)
from deephumor_tpu_torch.models import MODEL_REGISTRY
from torch_oracles import (OracleCaptioningLSTMWithLabels,
                           OracleCaptioningTransformer,
                           OracleCaptioningTransformerBase,
                           randomize_bn_stats)

WORDS = ["grumpy", "cat", "i", "had", "fun", "once", "it", "was", "awful",
         "no", "yes", "!", "?", "one", "does", "not", "simply", "walk",
         "into", "mordor", "when", "you", "ship", "bugs"]
CHARS = list("abcdefghijklmnopqrstuvwxyz '!?.")
ORACLES = {"captioning_transformer": OracleCaptioningTransformer,
           "captioning_transformer_base": OracleCaptioningTransformerBase,
           "captioning_lstm_labels": OracleCaptioningLSTMWithLabels}


def _pth(tmp_path, model_type, num_tokens, seed):
    torch.manual_seed(seed)
    oracle = ORACLES[model_type](num_tokens).eval()
    randomize_bn_stats(oracle, torch.Generator().manual_seed(seed + 1))
    path = tmp_path / f"{model_type}.pth"
    torch.save({"model": oracle.state_dict(), "hp": oracle.hp}, path)
    return str(path)


def _jax_caption(model_type, path, image, words, mode, caption=None,
                 label=None, **kw):
    """examples/generate_meme.py's steps through the JAX package."""
    model, params = JAX_REGISTRY[model_type].from_torch(path)
    vocab = JaxVocab(words)
    tok = JaxWordPunctTokenizer() if mode == "word" else JaxCharTokenizer()
    args = dict(key=jax.random.PRNGKey(0), max_len=kw.pop("max_len"), **kw)
    if caption is not None:
        args["caption"] = jnp.asarray(jax_text_to_seq(caption, vocab, tok))
    x = jnp.asarray(image)
    if label is not None:
        out = model.generate(params, x, labels=jnp.asarray(
            jax_text_to_seq(label, vocab, tok)), **args)
    else:
        out = model.generate(params, x, **args)
    text = jax_seq_to_text(np.asarray(out["chosen"][0]), vocab,
                           delimiter=" " if mode == "word" else "")
    return (text, *jax_split_caption(text, num_blocks=2))


CASES = [
    ("captioning_transformer", "word", None, None, 10),
    ("captioning_transformer", "word", "one does not", None, 1),
    ("captioning_transformer_base", "char", "gru", None, 3),
    ("captioning_lstm_labels", "word", "when you", "grumpy cat", 4),
]


@pytest.mark.parametrize("model_type,mode,caption,label,beam", CASES)
def test_caption_image_greedy_matches_jax(tmp_path, model_type, mode,
                                          caption, label, beam):
    words = WORDS if mode == "word" else CHARS
    vocab = Vocab(words)
    path = _pth(tmp_path, model_type, len(vocab), len(model_type) + beam)
    image = np.random.default_rng(beam).normal(
        size=(1, 64, 64, 3)).astype(np.float32)
    kw = dict(max_len=12, beam_size=beam, top_k=16, greedy=True)
    model, params = MODEL_REGISTRY[model_type].from_torch(path, device="cpu")
    got = generate_meme.caption_image(
        model, params, torch.as_tensor(image), vocab, mode, caption=caption,
        labels=label, **kw)
    want = _jax_caption(model_type, path, image, words, mode, caption,
                        label, **kw)
    assert got == want
    assert got[0]


def test_caption_image_needs_labels_for_the_labels_model(tmp_path):
    path = _pth(tmp_path, "captioning_lstm_labels", len(Vocab(WORDS)), 0)
    model, params = MODEL_REGISTRY["captioning_lstm_labels"].from_torch(
        path, device="cpu")
    with pytest.raises(ValueError, match="labels"):
        generate_meme.caption_image(model, params,
                                    torch.zeros(1, 64, 64, 3), Vocab(WORDS))


def test_generate_meme_command_line(tmp_path):
    vocab = Vocab(WORDS)
    vocab.save(tmp_path / "vocab.txt")
    path = _pth(tmp_path, "captioning_transformer", len(vocab), 5)
    rgb = np.random.default_rng(5).integers(0, 255, (90, 120, 3), np.uint8)
    Image.fromarray(rgb, "RGB").save(tmp_path / "template.png")
    out = tmp_path / "meme.png"
    got = generate_meme.main([
        "--torch-checkpoint", path, "--vocab", str(tmp_path / "vocab.txt"),
        "--image", str(tmp_path / "template.png"), "--out", str(out),
        "--greedy", "--max-len", "12", "--beam-size", "3", "--top-k", "8",
        "--caption", "it was", "--device", "cpu"])
    image = jax_preprocess_pil(Image.open(tmp_path / "template.png"))[None]
    want = _jax_caption("captioning_transformer", path, image, WORDS, "word",
                        "it was", max_len=12, beam_size=3, top_k=8,
                        greedy=True)
    assert got == want
    with Image.open(out) as meme:
        assert meme.size == (120, 90)


def _in_vocab(text, vocab, tokenizer):
    tokens = tokenizer.tokenize(text)
    return all(t in vocab.stoi for t in tokens) and "<unk>" not in tokens


@pytest.mark.parametrize("render", [False, True])
def test_sweep_returns_in_vocabulary_captions(tmp_path, render):
    argv = ["--synthetic", "--num-templates", "4", "--captions-per-template",
            "2", "--batch", "8", "--device", "cpu"]
    if render:
        argv += ["--render", "--out-dir", str(tmp_path)]
    res = sweep.main(argv)
    assert res["templates"] == 4 and res["captions"] == 8
    assert [tid for tid, _ in res["outputs"]] == [
        f"tmpl{i}" for i in range(4) for _ in range(2)]
    assert len(res["vocab"]) == 2006
    tok = WordPunctTokenizer()
    assert all(_in_vocab(text, res["vocab"], tok)
               for _, text in res["outputs"])
    assert res["captions_per_s"] > 0 and res["encode_s"] > 0
    if render:
        assert len(list(tmp_path.glob("tmpl*_*.png"))) == 4
    else:
        # the same seeds give the same captions, rendering or not
        again = sweep.main(argv + ["--render"])
        assert again["outputs"] == res["outputs"]


def test_demo_covers_the_four_models(tmp_path):
    results = demo.main(["--synthetic", "--tokenizer", "both", "--device",
                         "cpu", "--out-dir", str(tmp_path)])
    kinds = [(r["mode"], r["model_type"]) for r in results]
    types = ["captioning_lstm", "captioning_lstm_labels",
             "captioning_transformer_base", "captioning_transformer"]
    assert kinds == [(m, t) for m in ("word", "char") for t in types]
    for r in results:
        mode = r["mode"]
        tok = WordPunctTokenizer() if mode == "word" else CharTokenizer()
        (text, top, bottom), = r["captions"]
        assert _in_vocab(text, demo.synthetic_vocab(mode), tok)
        name = r["name"].replace(".pth", ".png")
        assert (tmp_path / name).exists()


def test_demo_captions_a_batch_with_the_sampler_kernels_path():
    images = torch.randn(3, 32, 32, 3, generator=torch.Generator()
                         .manual_seed(0))
    vocab = demo.synthetic_vocab("word")
    results = demo.demo_captions(images, {"word": vocab}, synthetic=True,
                                 device="cpu")
    assert len(results) == 4
    for r in results:
        assert len(r["captions"]) == 3
        assert all(_in_vocab(c[0], vocab, WordPunctTokenizer())
                   for c in r["captions"])
