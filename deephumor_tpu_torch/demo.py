"""The reference demo notebook's walk: all four architectures, word- and
character-level, caption a template image at the notebook's settings,
and the captions are rendered onto it.

Counterpart of examples/demo.py. :func:`demo_captions` builds or loads
each model and generates on the card (or on ``device``);
:func:`main` adds the command line, the image and the rendering, which
need Pillow.

    python -m deephumor_tpu_torch.demo --synthetic
    python -m deephumor_tpu_torch.demo --ckpt-dir ckpts \\
        --vocab-word vocab_words.txt --vocab-char vocab_chars.txt \\
        --image cat.jpg --tokenizer both --out-dir demo_out

``--synthetic`` takes random weights at small widths and a tiny
vocabulary, and shows the whole surface without files.
"""

import argparse
import os
import zlib

import numpy as np
import torch

from deephumor_tpu_torch.data import CharTokenizer, Vocab, WordPunctTokenizer
from deephumor_tpu_torch.experiments.inference import (seq_to_text,
                                                       split_caption,
                                                       text_to_seq)

__all__ = ["WORD_GEN", "CHAR_GEN", "ARCHS", "synthetic_vocab",
           "load_models", "demo_captions", "main"]

# the notebook's generation settings (cells 35, 42-49)
WORD_GEN = dict(max_len=32, beam_size=10, top_k=70, temperature=1.0)
CHAR_GEN = dict(max_len=128, beam_size=7, top_k=50, temperature=1.1)

# checkpoint file -> model type (notebook cell 13); {T} is Words or Chars
ARCHS = [
    ("LSTMDecoder{T}.best.pth", "captioning_lstm"),
    ("LSTMDecoderWithLabels{T}.best.pth", "captioning_lstm_labels"),
    ("TransformerDecoderBase{T}.best.pth", "captioning_transformer_base"),
    ("TransformerDecoder{T}.best.pth", "captioning_transformer"),
]


def synthetic_vocab(mode):
    """The synthetic demo's tiny vocabulary of ``mode``."""
    return Vocab([f"w{i}" for i in range(500)] if mode == "word"
                 else list("abcdefghijklmnopqrstuvwxyz '!?."))


def load_models(mode, vocab, *, ckpt_dir=None, synthetic=False,
                device="cuda"):
    """``[(file name, model, params)]`` of the four architectures for
    ``mode``: random at the synthetic widths (each seeded from its file
    name), or loaded from ``ckpt_dir`` (``.pth`` files; a missing one is
    skipped with a message)."""
    from deephumor_tpu_torch.models import MODEL_REGISTRY

    gen_kw = WORD_GEN if mode == "word" else CHAR_GEN
    suffix = "Words" if mode == "word" else "Chars"
    models = []
    for fname_t, model_type in ARCHS:
        fname = fname_t.format(T=suffix)
        cls = MODEL_REGISTRY[model_type]
        if synthetic:
            if "transformer" in model_type:
                model = cls(num_tokens=len(vocab), hid_dim=64, n_layers=2,
                            n_heads=4, pf_dim=128,
                            max_len=gen_kw["max_len"] + 2)
            else:
                model = cls(num_tokens=len(vocab), emb_dim=32,
                            hidden_size=64, num_layers=2)
            seed = zlib.crc32(fname.encode())
            params = model.init(torch.Generator(device).manual_seed(seed),
                                device)
        else:
            path = os.path.join(ckpt_dir or ".", fname)
            if not os.path.exists(path):
                print(f"[{fname}] not found: skipped")
                continue
            model, params = cls.from_torch(path, device=device)
        models.append((fname, model, params))
    return models


def demo_captions(images, vocabs, *, ckpt_dir=None, synthetic=False,
                  label="grumpy cat", device="cuda", seed=1):
    """Captions ``images`` (NHWC, ImageNet-normalised) with every model of
    :func:`load_models` for each ``mode -> Vocab`` of ``vocabs``, at the
    notebook's settings (top_k and beam cut to the vocabulary), through
    the sampler kernels (``sampler="pallas"``, as the sweep).

    Returns a list of ``{"name", "model_type", "mode", "captions"}``,
    ``captions`` one ``(text, top, bottom)`` per image. The labels models
    take ``label`` as every image's template label."""
    images = torch.as_tensor(images).to(device)
    results = []
    for mode, vocab in vocabs.items():
        tokenizer = (WordPunctTokenizer() if mode == "word"
                     else CharTokenizer())
        kw = dict(WORD_GEN if mode == "word" else CHAR_GEN, sampler="pallas")
        kw["top_k"] = min(kw["top_k"], len(vocab))
        kw["beam_size"] = min(kw["beam_size"], kw["top_k"])
        for name, model, params in load_models(
                mode, vocab, ckpt_dir=ckpt_dir, synthetic=synthetic,
                device=device):
            gen = torch.Generator(device).manual_seed(seed)
            if model.with_labels:
                labels = torch.as_tensor(
                    text_to_seq(label, vocab, tokenizer), dtype=torch.long,
                    device=device).expand(images.shape[0], -1)
                out = model.generate(params, images, labels, generator=gen,
                                     **kw)
            else:
                out = model.generate(params, images, generator=gen, **kw)
            captions = []
            for seq in out["chosen"].cpu().numpy():
                text = seq_to_text(seq, vocab,
                                   delimiter=" " if mode == "word" else "")
                captions.append((text, *split_caption(text, num_blocks=2)))
            results.append({"name": name, "model_type": model.model_type,
                            "mode": mode, "captions": captions})
    return results


def main(argv=None):
    """The command line (module docstring): one PNG per model under
    ``--out-dir``; returns :func:`demo_captions`' result."""
    ap = argparse.ArgumentParser("deephumor demo: the four architectures")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--vocab-word")
    ap.add_argument("--vocab-char")
    ap.add_argument("--image", help="template image (jpg/png)")
    ap.add_argument("--label", default="grumpy cat",
                    help="template label text (labels models)")
    ap.add_argument("--tokenizer", choices=["word", "char", "both"],
                    default="word")
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    from deephumor_tpu_torch.imaging import memeify_image
    from deephumor_tpu_torch.ops.image_ops import preprocess_pil

    if args.image:
        pil = Image.open(args.image).convert("RGB")
    else:
        pil = Image.fromarray(np.random.default_rng(0).integers(
            0, 255, (300, 400, 3), dtype=np.uint8), "RGB")
    modes = ["word", "char"] if args.tokenizer == "both" else [args.tokenizer]
    vocabs = {}
    for mode in modes:
        path = args.vocab_word if mode == "word" else args.vocab_char
        if args.synthetic:
            vocabs[mode] = synthetic_vocab(mode)
        elif path:
            vocabs[mode] = Vocab.load(path)
        else:
            print(f"[{mode}] no vocabulary given: skipped")

    results = demo_captions(preprocess_pil(pil)[None], vocabs,
                            ckpt_dir=args.ckpt_dir, synthetic=args.synthetic,
                            label=args.label, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    for r in results:
        text, top, bottom = r["captions"][0]
        dest = os.path.join(args.out_dir,
                            r["name"].replace(".pth", "") + ".png")
        memeify_image(pil, top=top, bottom=bottom).save(dest)
        print(f"[{r['name']}] {text!r}\n  -> {dest}")
    return results


if __name__ == "__main__":
    main()
