"""Experiments layer: the trainer, metrics and the inference text helpers
(counterpart of deephumor_tpu/experiments).

``Trainer`` loads at first use: the trainer imports the models and
``parallel``, which import ``pipeline``, which imports ``inference`` from
here.
"""

import importlib

from deephumor_tpu_torch.experiments.inference import (seq_to_text,
                                                       split_caption,
                                                       text_to_seq)
from deephumor_tpu_torch.experiments.metrics import (masked_cross_entropy,
                                                     perplexity)

__all__ = ["text_to_seq", "seq_to_text", "split_caption", "perplexity",
           "masked_cross_entropy", "Trainer"]


def __getattr__(name):
    if name == "Trainer":
        return importlib.import_module(
            "deephumor_tpu_torch.experiments.trainer").Trainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
