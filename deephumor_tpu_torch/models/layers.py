"""Layer primitives over explicit parameter dicts of tensors.

Counterpart of deephumor_tpu/models/layers.py, with PyTorch's layouts and
names (see convert/jax_params.py): a linear layer is ``{"weight":
[out, in], "bias": [out]}``, an embedding ``{"weight": [N, D]}``, a layer
norm ``{"weight", "bias"}``, a batch norm ``{"weight", "bias",
"running_mean", "running_var"}``. The ``*_init`` functions draw from the
JAX package's distributions with an explicit ``torch.Generator``.
"""

import math

import torch
import torch.nn.functional as F

__all__ = ["linear", "embed", "layer_norm", "batch_norm", "linear_init",
           "embedding_init", "layer_norm_init", "batch_norm_init"]


def linear(params, x):
    return F.linear(x, params["weight"], params["bias"])


def embed(params, ids):
    return params["weight"][ids]


def layer_norm(params, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], params["weight"], params["bias"],
                        eps)


def batch_norm(params, x, eps=1e-5):
    """Eval-mode batch norm over the last axis (running statistics)."""
    y = (x - params["running_mean"]) * torch.rsqrt(params["running_var"]
                                                   + eps)
    return y * params["weight"] + params["bias"]


def _uniform(gen, shape, bound, device):
    u = torch.rand(shape, generator=gen, device=device)
    return (u * 2.0 - 1.0) * bound


def linear_init(gen, in_dim, out_dim, device="cpu"):
    """Kaiming-uniform weight and bias, bound 1/sqrt(in_dim)."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"weight": _uniform(gen, (out_dim, in_dim), bound, device),
            "bias": _uniform(gen, (out_dim,), bound, device)}


def embedding_init(gen, num_embeddings, dim, device="cpu"):
    return {"weight": torch.randn((num_embeddings, dim), generator=gen,
                                  device=device)}


def layer_norm_init(dim, device="cpu"):
    return {"weight": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def batch_norm_init(dim, device="cpu"):
    return {"weight": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device),
            "running_mean": torch.zeros(dim, device=device),
            "running_var": torch.ones(dim, device=device)}
