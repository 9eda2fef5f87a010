"""PyTorch + CUDA port of deephumor_tpu for NVIDIA Hopper GPUs.

The package mirrors the JAX package's module names (``models/``, ``ops/``,
``utils/``, ``convert/``) so each function's counterpart is easy to find.
It imports ``torch`` only; the JAX package is the reference it is tested
against and is never imported here.

Kernels (``ops/csrc/*.cu``) are built with ``nvcc`` at first use into
``build/deephumor_tpu_torch/`` and loaded with ``ctypes``; every kernel
has a plain-PyTorch twin that serves CPU tensors.
"""

__version__ = "0.1.0"

# special token ids (same values as deephumor_tpu/data/vocab.py)
PAD, UNK, BOS, EOS = 0, 1, 2, 3
