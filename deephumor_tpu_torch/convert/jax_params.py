"""JAX parameter pytree -> the port's parameter tree.

The JAX package stores every layer as a small dict of arrays
(deephumor_tpu/models/layers.py, resnet.py). The port keeps the same
nesting but uses PyTorch's names and layouts, converted once at load:

==============================  ====================================
JAX leaf dict                   port leaf dict
==============================  ====================================
linear ``kernel [in, out]``     ``weight [out, in]`` (``F.linear``)
conv ``kernel`` HWIO            ``weight`` OIHW (``F.conv2d``)
embedding ``table``             ``weight``
layer norm ``scale, bias``      ``weight, bias``
batch norm ``scale, bias,       ``weight, bias, running_mean,
mean, var``                     running_var``
==============================  ====================================
"""

import numpy as np
import torch

__all__ = ["params_from_jax"]

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _tensor(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _leaf_dict(node):
    """Converts one layer's dict, or returns None if ``node`` is not one."""
    keys = set(node)
    if "kernel" in keys and keys <= {"kernel", "bias"}:
        k = np.asarray(node["kernel"])
        if k.ndim == 2:
            w = k.T
        elif k.ndim == 4:
            w = k.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank {k.ndim}")
        out = {"weight": _tensor(w)}
        if "bias" in node:
            out["bias"] = _tensor(node["bias"])
        return out
    if keys == {"table"}:
        return {"weight": _tensor(node["table"])}
    if keys == set(_BN):
        return {_BN[k]: _tensor(v) for k, v in node.items()}
    if keys == {"scale", "bias"}:
        return {"weight": _tensor(node["scale"]),
                "bias": _tensor(node["bias"])}
    return None


def params_from_jax(tree):
    """Converts a JAX parameter pytree (numpy leaves, e.g. from
    ``load_params`` or ``jax.device_get``) into the port's tree of f32
    CPU tensors."""
    if isinstance(tree, dict):
        leaf = _leaf_dict(tree)
        if leaf is not None:
            return leaf
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    raise ValueError(f"unexpected leaf outside a layer dict: {type(tree)}")
