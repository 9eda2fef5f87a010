"""Data layer: vocabulary, tokenizers, the dataset and batching
(counterpart of deephumor_tpu/data).

``MemeDataset`` and ``pad_collate`` load at first use, so that importing
the vocabulary (as the package's top level does) loads no more.
"""

import importlib

from deephumor_tpu_torch.data.tokenizers import (CharTokenizer, Tokenizer,
                                                 WordPunctTokenizer)
from deephumor_tpu_torch.data.vocab import (BOS_ID, EMP_ID, EOS_ID, PAD_ID,
                                            SEP_ID, SPECIAL_TOKENS, UNK_ID,
                                            Vocab, build_vocab,
                                            build_vocab_from_file)

__all__ = ["SPECIAL_TOKENS", "PAD_ID", "UNK_ID", "BOS_ID", "EOS_ID",
           "SEP_ID", "EMP_ID", "Vocab", "build_vocab",
           "build_vocab_from_file", "Tokenizer", "WordPunctTokenizer",
           "CharTokenizer", "MemeDataset", "pad_collate"]

_LAZY = {"MemeDataset": "deephumor_tpu_torch.data.datasets",
         "pad_collate": "deephumor_tpu_torch.data.dataloaders"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
