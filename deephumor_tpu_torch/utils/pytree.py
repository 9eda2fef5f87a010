"""Reads the framework-native ``.npz`` + ``.json`` checkpoint format.

A checkpoint is an ``.npz`` of '/'-joined flattened pytree keys (integer
path segments are list indices) plus a JSON hyperparameter sidecar with
the same base name. Only numpy is needed to read it.
"""

import json

import numpy as np

__all__ = ["unflatten_tree", "load_params", "tree_map"]


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
    """Applies ``fn`` to every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
