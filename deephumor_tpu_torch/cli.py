"""Command-line entry points of the data tools: ``crawl_main`` and
``split_main``, with the flags and defaults of deephumor_tpu/cli.py.

    python -c "from deephumor_tpu_torch.cli import crawl_main; crawl_main()" -d memes
    python -c "from deephumor_tpu_torch.cli import split_main; split_main()" -d memes
"""

import argparse

__all__ = ["crawl_main", "split_main"]


def crawl_main(argv=None):
    """The meme dataset crawler (the reference's crawl_data.py flags)."""
    from deephumor_tpu_torch.crawlers import MemeGeneratorCrawler

    parser = argparse.ArgumentParser("Meme dataset crawler")
    parser.add_argument("--source", "-s", type=str,
                        default="memegenerator.net", help="data source")
    parser.add_argument("--save-dir", "-d", required=True, type=str,
                        help="directory where the dataset should be stored")
    parser.add_argument("--poolsize", "-p", type=int, default=25,
                        help="number of concurrent fetches")
    parser.add_argument("--num-templates", "-t", type=int, default=300,
                        help="number of templates to crawl")
    parser.add_argument("--num-captions", "-c", type=int, default=1000,
                        help="number of captions per template")
    parser.add_argument("--detect-english", action="store_true",
                        help="filter out non-english templates")
    parser.add_argument("--detect-duplicates", action="store_true",
                        help="(slow) filter out duplicate captions")
    parser.add_argument("--min-len", type=int, default=10,
                        help="minimum length of the caption text")
    parser.add_argument("--max-len", type=int, default=96,
                        help="maximum length of the caption text")
    parser.add_argument("--max-tokens", type=int, default=31,
                        help="maximum number of tokens in the caption text")
    args = parser.parse_args(argv)

    if args.source != "memegenerator.net":
        raise SystemExit("Only memegenerator.net is supported")

    crawler = MemeGeneratorCrawler(
        poolsize=args.poolsize, min_len=args.min_len, max_len=args.max_len,
        max_tokens=args.max_tokens, detect_english=args.detect_english,
        detect_duplicates=args.detect_duplicates)
    crawler.crawl_dataset(num_templates=args.num_templates,
                          num_captions=args.num_captions,
                          save_dir=args.save_dir)


def split_main(argv=None):
    """The dataset splitter (the reference's split_data.py flags, with
    ``--random-state`` honoured)."""
    from deephumor_tpu_torch.data.splits import split_captions

    parser = argparse.ArgumentParser("Meme dataset split")
    parser.add_argument("--data-dir", "-d", required=True, type=str,
                        help="directory with the dataset")
    parser.add_argument("--splits", type=int, default=(2500, 250, 250),
                        nargs=3, help="train/val/test sizes per template")
    parser.add_argument("--random-state", type=int, default=0,
                        help="random seed for the data shuffling")
    args = parser.parse_args(argv)
    split_captions(args.data_dir, tuple(args.splits), args.random_state)
