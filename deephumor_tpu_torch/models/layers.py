"""Layer primitives over explicit parameter dicts of tensors.

Counterpart of deephumor_tpu/models/layers.py, with PyTorch's layouts and
names (see convert/jax_params.py): a linear layer is ``{"weight":
[out, in], "bias": [out]}``, an embedding ``{"weight": [N, D]}``, a layer
norm ``{"weight", "bias"}``, a batch norm ``{"weight", "bias",
"running_mean", "running_var"}``. The ``*_init`` functions draw from the
JAX package's distributions with an explicit ``torch.Generator``; so does
:func:`dropout`, whose draws come from the generator it is given.
"""

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["linear", "embed", "layer_norm", "batch_norm", "dropout",
           "linear_init", "embedding_init", "layer_norm_init",
           "batch_norm_init"]


def linear(params, x):
    return F.linear(x, params["weight"], params["bias"])


def embed(params, ids):
    return params["weight"][ids]


def layer_norm(params, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], params["weight"], params["bias"],
                        eps)


class _GroupSum(torch.autograd.Function):
    """``x`` summed over the ranks of ``group``; the backward sums the
    gradient over them too (every rank's loss depends on every rank's
    ``x``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _global_moments(x, dims, group):
    """Mean, biased variance and count (a 0-d tensor) of ``x`` over
    ``dims`` and over every rank of ``group``: one all-reduce of the sums,
    the sums of squares and the count, through which the gradient flows."""
    n_local = torch.full((1,), x.numel() // x.shape[-1], dtype=x.dtype,
                         device=x.device)
    s = _GroupSum.apply(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims),
                                   n_local]), group)
    c = x.shape[-1]
    n = s[2 * c]
    mean = s[:c] / n
    return mean, (s[c:2 * c] / n - mean * mean).clamp(min=0), n


def batch_norm(params, x, train=False, momentum=0.1, eps=1e-5, group=None):
    """Batch norm over the last axis, PyTorch's semantics.

    Eval mode normalises by the running statistics and returns ``y``.
    Train mode normalises by the batch's biased variance and returns
    ``(y, new_params)``: the running mean and the *unbiased* variance
    advanced by ``momentum``, as new (detached) tensors. The statistics
    leave the forward as parameters, not through autograd. With ``group``
    (a mesh's data axis) the batch is the global one, of which ``x`` is
    this rank's shard: the moments and the count are summed over the
    group, so that every rank's output and statistics are the
    single-device ones.
    """
    if not train:
        y = (x - params["running_mean"]) * torch.rsqrt(
            params["running_var"] + eps)
        return y * params["weight"] + params["bias"]
    dims = tuple(range(x.ndim - 1))
    if group is None:
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        n = x.numel() // x.shape[-1]
        n_minus_1 = max(n - 1, 1)
    else:
        mean, var, n = _global_moments(x, dims, group)
        n_minus_1 = (n - 1).clamp(min=1)
    with torch.no_grad():
        new_params = dict(
            params,
            running_mean=(1 - momentum) * params["running_mean"]
            + momentum * mean,
            running_var=(1 - momentum) * params["running_var"]
            + momentum * var * n / n_minus_1)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["weight"] + params["bias"], new_params


def dropout(gen, x, rate, train):
    """Inverted dropout drawing its mask from ``gen`` (a ``torch.Generator``
    on ``x``'s device); the identity when not training or at rate 0."""
    if not train or rate == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _uniform(gen, shape, bound, device):
    u = torch.rand(shape, generator=gen, device=device)
    return (u * 2.0 - 1.0) * bound


def linear_init(gen, in_dim, out_dim, device="cuda"):
    """Kaiming-uniform weight and bias, bound 1/sqrt(in_dim)."""
    bound = 1.0 / math.sqrt(in_dim)
    return {"weight": _uniform(gen, (out_dim, in_dim), bound, device),
            "bias": _uniform(gen, (out_dim,), bound, device)}


def embedding_init(gen, num_embeddings, dim, device="cuda"):
    return {"weight": torch.randn((num_embeddings, dim), generator=gen,
                                  device=device)}


def layer_norm_init(dim, device="cuda"):
    return {"weight": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def batch_norm_init(dim, device="cuda"):
    return {"weight": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device),
            "running_mean": torch.zeros(dim, device=device),
            "running_var": torch.ones(dim, device=device)}
