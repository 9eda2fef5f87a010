"""Static-shape batching.

Counterpart of deephumor_tpu/data/dataloaders.py (numpy only): batches are
padded to a fixed ``max_len`` and the short last batch is dropped or
filled to the full batch size, so every step sees one shape. The shuffle
order is the JAX package's (``np.random.default_rng(seed + epoch)``), so
both packages yield the same batches from the same dataset.
"""

import numpy as np

__all__ = ["pad_ids", "pad_collate", "BatchIterator"]


def pad_ids(seqs, length, pad_value=0):
    """``[n, length]`` int32 matrix: each sequence cut to ``length`` and
    padded with ``pad_value``."""
    out = np.full((len(seqs), length), pad_value, np.int32)
    for i, s in enumerate(seqs):
        s = s[:length]
        out[i, :len(s)] = s
    return out


def pad_collate(batch, max_caption_len=None, max_label_len=None,
                pad_value=0):
    """Collates ``(label_ids, caption_ids, image)`` triples into numpy
    arrays; without lengths, pads to the batch's longest (the
    reference's behaviour)."""
    labels, captions, images = zip(*batch)
    lab_len = max_label_len or max(len(x) for x in labels)
    cap_len = max_caption_len or max(len(x) for x in captions)
    return {"labels": pad_ids(labels, lab_len, pad_value),
            "captions": pad_ids(captions, cap_len, pad_value),
            "images": np.stack(images).astype(np.float32)}


class BatchIterator:
    """Shuffling epoch iterator of fixed-shape dict batches.

    Args:
        dataset: a ``MemeDataset`` (or any indexable of triples).
        batch_size: rows per batch; the short last batch is dropped when
            ``drop_last``, else filled by repeating its last example, with
            ``row_valid`` marking the real rows.
        max_caption_len / max_label_len: the fixed pad lengths.
        seed: shuffle seed; epoch ``e`` shuffles with ``seed + e``.
        fast: with a dataset that has ``materialize`` and preloaded
            images, index its pre-encoded id matrices instead of
            tokenizing per item.
        image_rows: template key -> row of a trunk-feature store
            (``Trainer.build_trunk_cache``); batches then carry int32
            ``image_rows`` instead of images. Needs the fast path.
    """

    def __init__(self, dataset, batch_size, max_caption_len=32,
                 max_label_len=8, shuffle=True, seed=0, drop_last=True,
                 fast=True, image_rows=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_caption_len = max_caption_len
        self.max_label_len = max_label_len
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.image_rows = image_rows
        self._epoch = 0
        self._mat = None
        if (fast and hasattr(dataset, "materialize")
                and getattr(dataset, "preload_images", False)):
            self._mat = dataset.materialize(max_caption_len, max_label_len)
        elif image_rows is not None:
            raise ValueError(
                "image_rows requires the fast path (fast=True and a dataset "
                "with materialize() + preload_images)")

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        stop = (n // self.batch_size) * self.batch_size if self.drop_last \
            else n
        for start in range(0, stop, self.batch_size):
            idx = order[start:start + self.batch_size]
            n_real = len(idx)
            if n_real < self.batch_size:
                idx = np.concatenate(
                    [idx, np.repeat(idx[-1], self.batch_size - n_real)])
            if self._mat is not None:
                keys = self._mat["image_keys"]
                batch = {"labels": self._mat["labels"][idx],
                         "captions": self._mat["captions"][idx]}
                if self.image_rows is not None:
                    batch["image_rows"] = np.asarray(
                        [self.image_rows[keys[int(i)]] for i in idx],
                        np.int32)
                else:
                    batch["images"] = np.stack(
                        [self.dataset.images[keys[int(i)]] for i in idx]
                    ).astype(np.float32)
            else:
                batch = pad_collate([self.dataset[int(i)] for i in idx],
                                    self.max_caption_len, self.max_label_len)
            if n_real < len(idx):
                batch["row_valid"] = np.arange(len(idx)) < n_real
            yield batch
