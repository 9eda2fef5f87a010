"""Train/val/test split of crawled captions.

Counterpart of deephumor_tpu/data/splits.py: ``captions.txt`` grouped by
template, each template's captions shuffled, and
``captions_{train,val,test}.txt`` written (2500/250/250 a template by
default), each split in the file's order. The shuffle is numpy's global
``np.random.seed`` + ``np.random.shuffle``, in the JAX package's order, so
both packages write the same files for one ``random_state``.
"""

import os
from collections import defaultdict

import numpy as np

__all__ = ["split_captions"]


def split_captions(data_dir, splits=(2500, 250, 250), random_state=0):
    """Writes ``captions_{train,val,test}.txt`` under ``data_dir`` from its
    ``captions.txt``: per template, the first ``splits[0]`` of a shuffled
    order go to train, the next ``splits[1]`` to val, then test."""
    np.random.seed(random_state)
    start_ids = np.cumsum([0] + list(splits))
    end_ids = start_ids[1:]

    captions = defaultdict(list)
    with open(os.path.join(data_dir, "captions.txt")) as f:
        for line in f:
            captions[line.split("\t", 1)[0]].append(line)

    files = [open(os.path.join(data_dir, f"captions_{name}.txt"), "w")
             for name in ("train", "val", "test")]
    try:
        for lines in captions.values():
            indices = np.arange(len(lines))
            np.random.shuffle(indices)
            for i, f in enumerate(files):
                for idx in sorted(indices[start_ids[i]:end_ids[i]]):
                    f.write(lines[idx])
    finally:
        for f in files:
            f.close()
