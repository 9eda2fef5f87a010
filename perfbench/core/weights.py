"""Seeded weights over the port's parameter names and shapes.

The harness makes the weights itself, on the device, from the run's seed:
one ``uniform_`` and one ``normal_`` call fill two flat f32 buffers, and
every leaf is a view of one of them, scaled in place by the bound or the
standard deviation of its kind (the distributions of the captioners'
own init: Kaiming-uniform linears, unit-normal embeddings, Kaiming-normal
convolutions, layer and batch norms at their identity). The program and
the reference are handed the same tensors. A model's file
(``models/<model>.py``) lays out its tree from these leaves and the
shared ResNet-50 encoder below.
"""

import math

import torch

RESNET_BLOCKS = (3, 4, 6, 3)
RESNET_WIDTHS = (64, 128, 256, 512)
RESNET_FEATURES = 2048


def linear(d_in, d_out):
    bound = 1.0 / math.sqrt(d_in)
    return {"weight": ("uniform", (d_out, d_in), bound),
            "bias": ("uniform", (d_out,), bound)}


def norm(d):
    return {"weight": ("ones", (d,)), "bias": ("zeros", (d,))}


def _batch_norm(d):
    return {**norm(d), "running_mean": ("zeros", (d,)),
            "running_var": ("ones", (d,))}


def _conv(k, c_in, c_out):
    return {"weight": ("normal", (c_out, c_in, k, k),
                       math.sqrt(2.0 / (k * k * c_out)))}


def resnet_spec():
    spec = {"conv1": _conv(7, 3, 64), "bn1": _batch_norm(64)}
    c_in = 64
    for s, (blocks, width) in enumerate(zip(RESNET_BLOCKS, RESNET_WIDTHS)):
        stage = []
        for b in range(blocks):
            c_out = 4 * width
            block = {"conv1": _conv(1, c_in, width), "bn1": _batch_norm(width),
                     "conv2": _conv(3, width, width),
                     "bn2": _batch_norm(width),
                     "conv3": _conv(1, width, c_out),
                     "bn3": _batch_norm(c_out)}
            if b == 0:
                block["downsample"] = {"conv": _conv(1, c_in, c_out),
                                       "bn": _batch_norm(c_out)}
            stage.append(block)
            c_in = c_out
        spec[f"layer{s + 1}"] = stage
    return spec


def encoder_spec(cfg):
    return {"resnet": resnet_spec(),
            "linear": linear(RESNET_FEATURES, cfg["hid_dim"]),
            "bn": _batch_norm(cfg["hid_dim"])}


def _leaves(spec, path=()):
    if isinstance(spec, tuple):
        yield path, spec
    elif isinstance(spec, dict):
        for k, v in spec.items():
            yield from _leaves(v, path + (k,))
    else:
        for i, v in enumerate(spec):
            yield from _leaves(v, path + (i,))


def _assign(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(spec):
    if isinstance(spec, tuple):
        return None
    if isinstance(spec, dict):
        return {k: _skeleton(v) for k, v in spec.items()}
    return [_skeleton(v) for v in spec]


def make(spec, seed, device, eos_index=None, eos_bias=None):
    """The tree of ``spec`` filled from ``seed`` on ``device`` (f32), in a
    few large calls. With ``eos_bias``, the decoder classifier's weight
    row at ``eos_index`` is zeroed and its bias set to ``eos_bias``, so
    that the EOS logit is that constant for every input."""
    gen = torch.Generator(device).manual_seed(int(seed))
    leaves = list(_leaves(spec))
    sizes = {"uniform": 0, "normal": 0}
    for _, (kind, shape, *_) in leaves:
        if kind in sizes:
            sizes[kind] += math.prod(shape)
    flat = {k: torch.empty(n, device=device) for k, n in sizes.items()}
    flat["uniform"].uniform_(-1.0, 1.0, generator=gen)
    flat["normal"].normal_(generator=gen)
    tree, used = _skeleton(spec), {"uniform": 0, "normal": 0}
    for path, (kind, shape, *scale) in leaves:
        if kind in flat:
            n = math.prod(shape)
            leaf = flat[kind][used[kind]:used[kind] + n].view(shape)
            used[kind] += n
            if scale[0] != 1.0:
                leaf.mul_(scale[0])
        else:
            leaf = (torch.ones if kind == "ones" else torch.zeros)(
                shape, device=device)
        _assign(tree, path, leaf)
    if eos_bias is not None:
        tree["decoder"]["classifier"]["bias"][eos_index] = eos_bias
        tree["decoder"]["classifier"]["weight"][eos_index] = 0.0
    return tree

