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

It runs on the card unless ``--device cpu`` is given; there the train
and eval steps replay as CUDA graphs unless ``--eager`` is given (the
same results, stepped from the host). ``--mesh`` trains
data-parallel over every rank that ``torchrun`` starts, one per card
(gloo ranks with ``--device cpu``); ``--batch-size`` is the global batch,
a multiple of the number of ranks, and rank 0 writes the vocabulary, the
logs and the checkpoints:

    torchrun --nproc-per-node N -m deephumor_tpu_torch.train --mesh \\
        --data-dir memes900k --model captioning_transformer
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
    ap.add_argument("--mesh", action="store_true",
                    help="data-parallel training over the torchrun ranks")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps from the host, not as CUDA graphs "
                         "(a mesh's steps always do)")
    args = ap.parse_args(argv)

    import torch

    from deephumor_tpu_torch.data import (CharTokenizer, WordPunctTokenizer,
                                          build_vocab_from_file)
    from deephumor_tpu_torch.data.dataloaders import BatchIterator
    from deephumor_tpu_torch.data.datasets import MemeDataset
    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.models import MODEL_REGISTRY

    device, mesh, leads = args.device, None, True
    if args.mesh:
        import torch.distributed as dist

        from deephumor_tpu_torch.parallel.mesh import (make_mesh,
                                                       mesh_device, replicate)

        mesh = make_mesh(torch.device(args.device).type, model=1)
        device, leads = mesh_device(mesh), dist.get_rank() == 0
        if leads:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    say = print if leads else (lambda *a, **k: None)

    tokenizer = WordPunctTokenizer() if args.mode == "word" \
        else CharTokenizer()
    max_caption_len = args.max_caption_len or (
        32 if args.mode == "word" else 128)
    vocab = build_vocab_from_file(
        os.path.join(args.data_dir, "captions_train.txt"), tokenizer,
        min_df=args.min_df)
    say(f"vocab: {len(vocab)} tokens")
    if leads:
        vocab.save(os.path.join(args.data_dir, f"vocab_{args.mode}.txt"))

    datasets = {split: MemeDataset(args.data_dir, vocab, tokenizer,
                                   split=split, num_classes=args.num_classes)
                for split in ("train", "val")}
    loaders = {split: BatchIterator(ds, args.batch_size,
                                    max_caption_len=max_caption_len,
                                    seed=args.seed)
               for split, ds in datasets.items()}
    say({s: f"{len(ds)} captions" for s, ds in datasets.items()})

    model = MODEL_REGISTRY[args.model](num_tokens=len(vocab))
    trainer = Trainer(model, args.title or f"{args.model}-{args.mode}",
                      log_dir=args.log_dir, learning_rate=args.learning_rate,
                      clip_norm=args.clip_norm, device=device,
                      compiled=False if args.eager else None)
    if args.resume:
        state = trainer.restore_checkpoint(args.resume)
        say(f"resumed from {args.resume} at step {state['step']}")
    else:
        state = trainer.init_state(
            torch.Generator(trainer.device).manual_seed(args.seed))
    if mesh is not None:
        state = replicate(state, mesh)
    trainer.train(state, loaders, n_epochs=args.epochs,
                  gen=torch.Generator(trainer.device).manual_seed(
                      args.seed + 1), mesh=mesh)
    trainer.close()
    say(f"artifacts in {trainer.experiment_dir}")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
