"""The 300-template product path: encode every template once, generate N
captions for each with batched beam search on the card, and optionally
render the memes on the host.

Counterpart of examples/sweep_300.py (BASELINE.json config 5), through
the port's ``MemeGenerationPipeline`` with the sampler kernels
(``sampler="pallas"``): K1 and K2 in every decoder layer, the first draw
in K3 and each later one in K4, which computes the classifier inside the
draw up to a 16,384-token vocabulary (above it, a bf16 product before
K3).

With ``--synthetic`` it needs no dataset: random weights of the word
model (a 2,000-word vocabulary, hid 512, 6 layers, 8 heads, pf 2048,
bf16) and 224 x 224 random templates. Chunk ``start`` of the work samples
with a generator seeded by ``pipeline.derive_seed(1, start)``. Pillow is
imported only for ``--render`` or a data directory.

    python -m deephumor_tpu_torch.sweep --synthetic
    python -m deephumor_tpu_torch.sweep --data-dir memes900k \\
        --checkpoint m.npz --vocab vocab.txt --render --out-dir memes_out
"""

import argparse
import os
import time

import numpy as np
import torch

__all__ = ["main"]

# generation seed of the sweep (the JAX script's PRNGKey(1))
SEED = 1


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _synthetic(args):
    """The JAX script's synthetic model, vocabulary and templates."""
    from deephumor_tpu_torch.data import Vocab
    from deephumor_tpu_torch.models import CaptioningTransformer

    rng = np.random.default_rng(0)
    vocab = Vocab([f"w{i}" for i in range(2000)])
    model = CaptioningTransformer(
        num_tokens=len(vocab), hid_dim=512, n_layers=6, n_heads=8,
        pf_dim=2048, max_len=args.max_len + 2, compute_dtype="bfloat16")
    params = model.init(torch.Generator(args.device).manual_seed(0),
                        args.device)
    templates = {f"tmpl{i}": rng.normal(size=(224, 224, 3)).astype(
        np.float32) for i in range(args.num_templates)}
    pils = {}
    if args.render:
        from PIL import Image

        pils = {tid: Image.fromarray(rng.integers(
            0, 255, (300, 400, 3), dtype=np.uint8), "RGB")
            for tid in templates}
    return vocab, model, params, templates, pils


def _dataset(args):
    from PIL import Image

    from deephumor_tpu_torch.data import MemeDataset, Vocab
    from deephumor_tpu_torch.models import CaptioningTransformer

    vocab = Vocab.load(args.vocab)
    model, params = CaptioningTransformer.from_pretrained(
        args.checkpoint, device=args.device)
    ds = MemeDataset(args.data_dir, vocab, num_classes=args.num_templates,
                     split="train")
    pils = {tid: Image.open(ds.templates[tid]) for tid in ds.images}
    return vocab, model, params, ds.images, pils


def main(argv=None):
    """Runs the sweep and prints its rates; returns them as a dict:
    ``templates``, ``captions``, ``encode_s`` (the templates through the
    encoder into the store), ``seconds`` and ``captions_per_s`` (all
    captions, with rendering when asked), ``first_call_s``,
    ``steady_captions_per_s`` (after the first call; None when there is
    no second call), ``outputs``: ``(template id, text)`` in work order,
    and ``vocab``, which decoded them."""
    parser = argparse.ArgumentParser("300-template meme sweep")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--data-dir")
    parser.add_argument("--checkpoint")
    parser.add_argument("--vocab")
    parser.add_argument("--out-dir")
    parser.add_argument("--num-templates", type=int, default=300)
    parser.add_argument("--captions-per-template", type=int, default=10)
    parser.add_argument("--beam-size", type=int, default=5)
    parser.add_argument("--max-len", type=int, default=32)
    parser.add_argument("--top-k", type=int, default=64)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--render", action="store_true",
                        help="also render PNG memes (synthetic mode)")
    parser.add_argument("--render-procs", type=int, default=0,
                        help="render in N spawn processes instead of "
                             "threads (threads overlap with the device, "
                             "but FreeType holds the GIL; processes "
                             "spread rendering over host cores)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from deephumor_tpu_torch.pipeline import (MemeGenerationPipeline,
                                              derive_seed)

    if args.synthetic:
        vocab, model, params, templates, pils = _synthetic(args)
    elif args.data_dir and args.checkpoint and args.vocab:
        vocab, model, params, templates, pils = _dataset(args)
    else:
        raise SystemExit("need --synthetic, or --data-dir, --checkpoint "
                         "and --vocab")

    pipe = MemeGenerationPipeline(model, params, vocab,
                                  render_processes=args.render_procs)
    try:
        ids = list(templates)
        _sync(args.device)
        t0 = time.perf_counter()
        pipe.add_templates(
            ids, np.stack([templates[t] for t in ids]),
            pil_images=[pils[t] for t in ids] if pils else None)
        _sync(args.device)
        t_encode = time.perf_counter() - t0
        print(f"encoded {len(ids)} templates in {t_encode:.2f}s")

        work = [tid for tid in ids for _ in range(args.captions_per_template)]
        total = len(work)
        gen = dict(max_len=args.max_len, beam_size=args.beam_size,
                   top_k=args.top_k, sampler="pallas")
        t0 = time.perf_counter()
        t_first = None
        if pils:
            # each chunk renders while the next one generates
            outputs = pipe.generate_memes_batched(
                work, batch_size=args.batch, seed=SEED, **gen)
            t_first = time.perf_counter() - t0
        else:
            outputs = []
            for start in range(0, total, args.batch):
                chunk = work[start:start + args.batch]
                g = torch.Generator(args.device).manual_seed(
                    derive_seed(SEED, start))
                texts = pipe.generate_captions(chunk, g, pad_to=args.batch,
                                               **gen)
                outputs += [(tid, text, None)
                            for tid, text in zip(chunk, texts)]
                if t_first is None:
                    t_first = time.perf_counter() - t0
        dt = time.perf_counter() - t0
    finally:
        pipe.close()

    print(f"{total} captions over {len(ids)} templates in {dt:.2f}s "
          f"-> {total / dt:.0f} captions/s"
          + (" (incl. rendering)" if pils else ""))
    steady = total - min(args.batch, total)
    steady_rate = None
    if steady > 0 and dt > t_first:
        # the first call carries the kernels' first launches (and their
        # build when the library is not built yet); a serving deployment
        # sees the steady state
        steady_rate = steady / (dt - t_first)
        print(f"  first call {t_first:.2f}s; steady state "
              f"{steady_rate:.0f} captions/s")
    for tid, text, _ in outputs[:3]:
        print(f"  {tid}: {text[:70]!r}")

    if args.out_dir and pils:
        os.makedirs(args.out_dir, exist_ok=True)
        for i, (tid, _, img) in enumerate(outputs[:len(ids)]):
            if img is not None:
                img.save(os.path.join(args.out_dir, f"{tid}_{i}.png"))
        print(f"wrote renders to {args.out_dir}")
    return {"templates": len(ids), "captions": total, "encode_s": t_encode,
            "seconds": dt, "captions_per_s": total / dt,
            "first_call_s": t_first, "steady_captions_per_s": steady_rate,
            "outputs": [(tid, text) for tid, text, _ in outputs],
            "vocab": vocab}


if __name__ == "__main__":
    main()
