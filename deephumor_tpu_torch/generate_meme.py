"""One meme from one image: caption it with a captioner, render the caption
on the image and save the PNG.

Counterpart of examples/generate_meme.py (the reference demo's
``get_a_meme``). :func:`caption_image` generates on the parameters'
device (the card by default: the decode kernels); :func:`main` adds the
command line, the image decoding and the rendering, which need Pillow.

    python -m deephumor_tpu_torch.generate_meme --checkpoint model.npz \\
        --vocab vocab.txt --image template.jpg --out meme.png
    python -m deephumor_tpu_torch.generate_meme --torch-checkpoint m.pth \\
        --model-type captioning_transformer --vocab vocab.txt \\
        --image template.jpg [--caption "starting text"] [--mode char] \\
        [--greedy] [--device cpu]
"""

import argparse

import torch

from deephumor_tpu_torch.data import CharTokenizer, WordPunctTokenizer
from deephumor_tpu_torch.experiments.inference import (seq_to_text,
                                                       split_caption,
                                                       text_to_seq)

__all__ = ["caption_image", "main"]

# the reference demo's lengths (notebook cell 35)
MAX_LEN = {"word": 32, "char": 128}


def caption_image(model, params, images, vocab, mode="word", *,
                  caption=None, labels=None, generator=None, max_len=None,
                  beam_size=10, top_k=70, temperature=1.0, greedy=False):
    """Captions the first of ``images`` (NHWC, ImageNet-normalised, on the
    parameters' device).

    Args:
        mode: "word" or "char": the tokenizer of ``vocab`` and how tokens
            join into text.
        caption: the caption's first words (text), or None.
        labels: the template label's text; the labels-conditioned model
            needs it.
        generator: a ``torch.Generator`` on the parameters' device
            (default: seeded with 0).
        max_len: default 32 (word) or 128 (char).

    Returns:
        ``(text, top, bottom)``: the caption and its two halves, split at
        ``<sep>``.
    """
    tokenizer = WordPunctTokenizer() if mode == "word" else CharTokenizer()
    device = images.device

    def ids(text):
        return torch.as_tensor(text_to_seq(text, vocab, tokenizer),
                               dtype=torch.long, device=device)

    kw = dict(generator=generator,
              caption=None if caption is None else ids(caption),
              max_len=max_len or MAX_LEN[mode], beam_size=beam_size,
              top_k=top_k, temperature=temperature, greedy=greedy)
    if model.with_labels:
        if labels is None:
            raise ValueError("the labels-conditioned model needs labels")
        out = model.generate(params, images, ids(labels), **kw)
    else:
        out = model.generate(params, images, **kw)
    text = seq_to_text(out["chosen"][0].cpu().numpy(), vocab,
                       delimiter=" " if mode == "word" else "")
    top, bottom = split_caption(text, num_blocks=2)
    return text, top, bottom


def main(argv=None):
    """The command line (module docstring); returns ``(text, top,
    bottom)``."""
    from deephumor_tpu_torch.models import MODEL_REGISTRY

    parser = argparse.ArgumentParser("deephumor meme generator")
    parser.add_argument("--image", required=True)
    parser.add_argument("--vocab", required=True)
    parser.add_argument("--out", default="meme.png")
    parser.add_argument("--checkpoint", help=".npz + .json checkpoint")
    parser.add_argument("--torch-checkpoint", help="reference .pth checkpoint")
    parser.add_argument("--model-type", default="captioning_transformer",
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("--label", help="template label text (labels model)")
    parser.add_argument("--caption", help="beginning of the caption")
    parser.add_argument("--mode", default="word", choices=["word", "char"])
    parser.add_argument("--max-len", type=int, default=None)
    parser.add_argument("--beam-size", type=int, default=10)
    parser.add_argument("--top-k", type=int, default=70)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--greedy", action="store_true")
    parser.add_argument("--font", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from PIL import Image

    from deephumor_tpu_torch.data import Vocab
    from deephumor_tpu_torch.imaging import memeify_image
    from deephumor_tpu_torch.ops.image_ops import preprocess_pil

    model_cls = MODEL_REGISTRY[args.model_type]
    if args.torch_checkpoint:
        model, params = model_cls.from_torch(args.torch_checkpoint,
                                             device=args.device)
    elif args.checkpoint:
        model, params = model_cls.from_pretrained(args.checkpoint,
                                                  device=args.device)
    else:
        raise SystemExit("pass --checkpoint or --torch-checkpoint")
    if model.with_labels and not args.label:
        raise SystemExit("--label is required for the labels model")

    pil = Image.open(args.image).convert("RGB")
    images = torch.as_tensor(preprocess_pil(pil))[None].to(args.device)
    text, top, bottom = caption_image(
        model, params, images, Vocab.load(args.vocab), args.mode,
        caption=args.caption, labels=args.label,
        generator=torch.Generator(args.device).manual_seed(args.seed),
        max_len=args.max_len, beam_size=args.beam_size, top_k=args.top_k,
        temperature=args.temperature, greedy=args.greedy)
    print(f"caption: {text!r}")
    print(f"top: {top!r}  bottom: {bottom!r}")
    memeify_image(pil, top=top, bottom=bottom,
                  font_path=args.font).save(args.out)
    print(f"saved {args.out}")
    return text, top, bottom


if __name__ == "__main__":
    main()
