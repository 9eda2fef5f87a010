"""Step-numbered, sharding-aware checkpoints of a whole training state.

Counterpart of deephumor_tpu/utils/checkpoint.py. The JAX package writes
orbax checkpoints; orbax is a JAX library, and a machine that runs the
port need not have it. This module writes the same layout (one directory
per step, ``<directory>/<step>``) in ``torch.distributed.checkpoint``'s
format instead, so its functions are named for the state, not the format:
:func:`save_state` and :func:`restore_state` stand for ``save_orbax`` and
``restore_orbax``; :func:`latest_step` keeps its name and meaning.

The state is a tree of dicts (string keys), lists and leaves: tensors,
DTensors and picklable values (counts, steps). It is saved leaf by leaf.

- In one process no process group is needed.
- With a process group every rank calls both functions. A DTensor leaf
  (a ``parallel.place_train_state`` state) is written as each rank's
  shards, without gathering, and a plain tensor once.
- :func:`restore_state` with a ``template`` restores onto the template's
  placement (its devices, dtypes and DTensor layouts) and leaves the
  template as it was; without one, every tensor comes back whole on
  ``device``.
"""

import contextlib
import json
import os
import shutil
import warnings

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata

__all__ = ["save_state", "restore_state", "latest_step"]


def _flatten(tree, path=()):
    """``{json path: leaf}``; a path is a list of dict keys (strings) and
    list indices (ints). An empty list is a leaf; an empty dict is kept
    as its path with a last element of None (the format saves no empty
    mapping)."""
    if isinstance(tree, dict) and not tree and path:
        return {json.dumps(path + (None,)): None}
    if isinstance(tree, dict) and tree:
        flat = {}
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"state keys must be strings, not {k!r}")
            flat.update(_flatten(v, path + (k,)))
        return flat
    if isinstance(tree, (list, tuple)) and tree:
        flat = {}
        for i, v in enumerate(tree):
            flat.update(_flatten(v, path + (i,)))
        return flat
    if not path:
        raise TypeError("the state must be a non-empty dict")
    return {json.dumps(path): tree}


def _unflatten(flat):
    """The tree of :func:`_flatten`'s output (tuples come back as lists)."""
    root = {}
    for key, value in flat.items():
        path = json.loads(key)
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        if path[-1] is not None:
            node[path[-1]] = value

    def build(node):
        # a state's dicts have string keys, so int keys mark a list
        if not isinstance(node, dict) or not node:
            return node
        if all(isinstance(k, int) for k in node):
            return [build(node[i]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}

    return build(root)


@contextlib.contextmanager
def _one_process_quiet():
    # without a process group the format warns at every call that it
    # saves or loads in one process, which is what this module means then
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled")
        yield


def _step_path(directory, step):
    return os.path.join(os.path.abspath(directory), str(int(step)))


def save_state(directory, state, step):
    """Writes ``state`` under ``<directory>/<step>`` (replacing what was
    there); returns that path. With a process group, a collective."""
    path = _step_path(directory, step)
    group = dist.is_available() and dist.is_initialized()
    if (not group or dist.get_rank() == 0) and os.path.isdir(path):
        shutil.rmtree(path)
    if group:
        dist.barrier()
    with _one_process_quiet():
        dcp.save(_flatten(state), checkpoint_id=path)
    return path


def restore_state(directory, step=None, template=None, device="cuda"):
    """``(state, step)`` of the given step, or of the latest one. With a
    ``template`` (a state of the same tree), each tensor is restored onto
    the template leaf's device, dtype and placement; without one, whole
    on ``device``. Raises FileNotFoundError when there is no such
    checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_path(directory, step)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if template is None:
        meta = dcp.FileSystemReader(path).read_metadata()
        flat = {k: (torch.empty(m.size, dtype=m.properties.dtype,
                                device=device)
                    if isinstance(m, TensorStorageMetadata) else None)
                for k, m in meta.state_dict_metadata.items()}
    else:
        flat = {k: torch.empty_like(v) if isinstance(v, torch.Tensor) else v
                for k, v in _flatten(template).items()}
    with _one_process_quiet():
        dcp.load(flat, checkpoint_id=path)
    return _unflatten(flat), step


def latest_step(directory):
    """The highest numeric subdirectory of ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    return max(steps) if steps else None
