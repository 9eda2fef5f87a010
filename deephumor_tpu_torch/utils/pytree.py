"""Reads and writes the framework-native ``.npz`` + ``.json`` checkpoint
format (deephumor_tpu/utils/pytree.py).

A checkpoint is an ``.npz`` of '/'-joined flattened pytree keys (integer
path segments are list indices) plus a JSON hyperparameter sidecar with
the same base name. Only numpy is needed; either package reads what the
other wrote.
"""

import json

import numpy as np

__all__ = ["flatten_tree", "unflatten_tree", "save_params", "load_params",
           "tree_map"]


def flatten_tree(tree, prefix=""):
    """Nested dict/list tree -> ``{'a/b/0/c': leaf}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip("/"): tree}
    flat = {}
    for k, v in items:
        flat.update(flatten_tree(v, f"{prefix}{k}/"))
    return flat


def unflatten_tree(flat):
    """``{'a/b/0/c': leaf}`` -> nested dicts; all-digit keys become lists."""
    root = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _base(path):
    base = str(path)
    return base[: -len(".npz")] if base.endswith(".npz") else base


def save_params(path, params, hp=None):
    """Writes ``<base>.npz`` (the flattened leaves) and, with ``hp``,
    ``<base>.json``, where ``base`` is ``path`` without a ``.npz``
    suffix: the names :func:`load_params` reads back."""
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    np.savez(_base(path) + ".npz", **flat)
    if hp is not None:
        with open(_base(path) + ".json", "w") as f:
            json.dump(hp, f, indent=2)


def load_params(path):
    """Returns ``(tree of numpy arrays, hp dict | None)``."""
    with np.load(_base(path) + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    try:
        with open(_base(path) + ".json") as f:
            hp = json.load(f)
    except FileNotFoundError:
        hp = None
    return unflatten_tree(flat), hp


def tree_map(fn, tree):
    """Applies ``fn`` to every leaf of a nested dict/list/tuple tree (the
    containers keep their types)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
