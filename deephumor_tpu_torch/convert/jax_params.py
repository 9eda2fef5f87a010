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
LSTM layer ``wi [in, 4H],       ``weight_ih [4H, in], weight_hh
wh [H, 4H], bi, bh``            [4H, H], bias_ih, bias_hh``
==============================  ====================================

``params_to_jax`` is the inverse: it gives the JAX layout as float32
numpy arrays, which is what a checkpoint holds.

The labelled LSTM captioner stores its decoder's token embedding once,
under ``encoder/label_encoder``; its ``decoder`` has no ``embedding`` in
either package, and the model reads the label encoder's table.
"""

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax"]

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_LSTM = {"wi": "weight_ih", "wh": "weight_hh", "bi": "bias_ih",
         "bh": "bias_hh"}


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
    if keys == set(_LSTM):
        return {_LSTM[k]: _tensor(np.asarray(v).T) for k, v in node.items()}
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


def _array(t):
    return t.detach().to("cpu", dtype=torch.float32).numpy()


def _jax_leaf_dict(node):
    """The JAX form of one of the port's layer dicts, or None if ``node``
    is not one. A layer dict whose only entry is a 2-D ``weight`` is an
    embedding (the linear layers all have a bias; convolutions are 4-D)."""
    keys = set(node)
    if keys == set(_LSTM.values()):
        inv = {v: k for k, v in _LSTM.items()}
        return {inv[k]: _array(v).T.copy() for k, v in node.items()}
    if keys == set(_BN.values()):
        inv = {v: k for k, v in _BN.items()}
        return {inv[k]: _array(v) for k, v in node.items()}
    w = node.get("weight")
    if not isinstance(w, torch.Tensor) or not keys <= {"weight", "bias"}:
        return None
    if w.ndim == 4:
        out = {"kernel": _array(w).transpose(2, 3, 1, 0).copy()}
    elif w.ndim == 1:
        return {"scale": _array(w), "bias": _array(node["bias"])}
    elif "bias" not in node:
        return {"table": _array(w)}
    else:
        out = {"kernel": _array(w).T.copy()}
    if "bias" in node:
        out["bias"] = _array(node["bias"])
    return out


def params_to_jax(tree):
    """Converts the port's parameter tree (tensors on any device, any
    float dtype) into the JAX package's layout with float32 numpy
    leaves."""
    if isinstance(tree, dict):
        leaf = _jax_leaf_dict(tree)
        if leaf is not None:
            return leaf
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    raise ValueError(f"unexpected leaf outside a layer dict: {type(tree)}")
