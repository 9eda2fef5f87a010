"""PyTorch + CUDA port of deephumor_tpu for NVIDIA Hopper GPUs.

The package mirrors the JAX package's module names (``models/``, ``ops/``,
``utils/``, ``convert/``, ``data/``, ``experiments/``, ``imaging/``,
``pipeline``, ``serving``) so each function's counterpart is easy to find.
It imports ``torch`` only; the JAX package is the reference it is tested
against and is never imported here.

Kernels (``ops/csrc/*.cu``) are built with ``nvcc`` at first use into
``build/deephumor_tpu_torch/`` and loaded with ``ctypes``; every kernel
has a plain-PyTorch twin that serves CPU tensors.

The top level exports the text core's names, as the JAX package's does,
and imports nothing else: the vocabulary and the tokenizers are pure
Python, so importing the package loads no model, kernel or CUDA.
"""

__version__ = "0.1.0"

from deephumor_tpu_torch.data.tokenizers import (CharTokenizer, Tokenizer,
                                                 WordPunctTokenizer)
from deephumor_tpu_torch.data.vocab import BOS_ID as BOS
from deephumor_tpu_torch.data.vocab import EOS_ID as EOS
from deephumor_tpu_torch.data.vocab import PAD_ID as PAD
from deephumor_tpu_torch.data.vocab import (SPECIAL_TOKENS, Vocab,
                                            build_vocab,
                                            build_vocab_from_file)
from deephumor_tpu_torch.data.vocab import UNK_ID as UNK

__all__ = ["SPECIAL_TOKENS", "Vocab", "build_vocab", "build_vocab_from_file",
           "Tokenizer", "WordPunctTokenizer", "CharTokenizer"]
