"""Train a caption model on a memes900k-format dataset.

The port's counterpart of the JAX package's ``examples/train.py``: a
vocabulary from ``captions_train.txt`` (saved beside it as
``vocab_<mode>.txt``), ``MemeDataset`` + ``BatchIterator`` for the train
and val splits, and the ``Trainer``'s epoch loop, which saves the best
val model (``<title>.best``, readable by either package's
``from_pretrained``) and a train state each epoch (``<title>.e<n>``).
``--resume`` takes a train state written by either package.

    python -m deephumor_tpu_torch.train --data-dir memes900k \\
        --model captioning_transformer --mode word [--epochs 10] \\
        [--batch-size 256] [--resume ckpt_prefix] [--device cuda]

It runs on the card unless ``--device cpu`` is given.
"""

import argparse
import os

MODELS = ("captioning_lstm", "captioning_lstm_labels",
          "captioning_transformer_base", "captioning_transformer")


def main(argv=None):
    ap = argparse.ArgumentParser("deephumor_tpu_torch trainer")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--model", default="captioning_lstm", choices=MODELS)
    ap.add_argument("--mode", default="word", choices=["word", "char"])
    ap.add_argument("--num-classes", type=int, default=300)
    ap.add_argument("--min-df", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--max-caption-len", type=int, default=None)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--clip-norm", type=float, default=3.0)
    ap.add_argument("--log-dir", default="./logs")
    ap.add_argument("--title", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", help="train-state prefix to resume from")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the steps (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from deephumor_tpu_torch.data import (CharTokenizer, WordPunctTokenizer,
                                          build_vocab_from_file)
    from deephumor_tpu_torch.data.dataloaders import BatchIterator
    from deephumor_tpu_torch.data.datasets import MemeDataset
    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.models import MODEL_REGISTRY

    tokenizer = WordPunctTokenizer() if args.mode == "word" \
        else CharTokenizer()
    max_caption_len = args.max_caption_len or (
        32 if args.mode == "word" else 128)
    vocab = build_vocab_from_file(
        os.path.join(args.data_dir, "captions_train.txt"), tokenizer,
        min_df=args.min_df)
    print(f"vocab: {len(vocab)} tokens")
    vocab.save(os.path.join(args.data_dir, f"vocab_{args.mode}.txt"))

    datasets = {split: MemeDataset(args.data_dir, vocab, tokenizer,
                                   split=split, num_classes=args.num_classes)
                for split in ("train", "val")}
    loaders = {split: BatchIterator(ds, args.batch_size,
                                    max_caption_len=max_caption_len,
                                    seed=args.seed)
               for split, ds in datasets.items()}
    print({s: f"{len(ds)} captions" for s, ds in datasets.items()})

    model = MODEL_REGISTRY[args.model](num_tokens=len(vocab))
    trainer = Trainer(model, args.title or f"{args.model}-{args.mode}",
                      log_dir=args.log_dir, learning_rate=args.learning_rate,
                      clip_norm=args.clip_norm, device=args.device)
    if args.resume:
        state = trainer.restore_checkpoint(args.resume)
        print(f"resumed from {args.resume} at step {state['step']}")
    else:
        state = trainer.init_state(
            torch.Generator(trainer.device).manual_seed(args.seed))
    trainer.train(state, loaders, n_epochs=args.epochs,
                  gen=torch.Generator(trainer.device).manual_seed(
                      args.seed + 1))
    trainer.close()
    print(f"artifacts in {trainer.experiment_dir}")


if __name__ == "__main__":
    main()
