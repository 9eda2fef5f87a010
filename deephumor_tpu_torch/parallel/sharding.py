"""Tensor-parallel sharding rules for the transformer decoders.

Counterpart of deephumor_tpu/parallel/sharding.py: Megatron-style column
and row parallelism over the ``model`` mesh axis, in the port's
orientation. A port linear holds ``weight [out, in]`` where the JAX
package holds ``kernel [in, out]``, so each rule shards the other axis
of the weight:

- attention fc_q/fc_k/fc_v and the feed-forward fc_1 are column-parallel:
  ``weight`` and ``bias`` sharded along their output axis (dim 0), heads
  (or pf units) split across ranks;
- fc_o and fc_2 are row-parallel: ``weight`` sharded along its input axis
  (dim 1), ``bias`` replicated (added after the reduction of the partial
  sums);
- everything else (embeddings, classifier, layer and batch norms,
  encoders, LSTMs) is replicated.

Parameters placed by :func:`make_param_shardings` are DTensors. The
captioners' ``generate_from_emb`` and the ``Trainer`` take such a tree and
run on each rank's local shards with explicit collectives over the
``model`` axis (``parallel.mesh.tp_generate``,
``models/transformer.py``); the teacher-forced ``forward`` and the loss
also run on the DTensors themselves with DTensor inputs
(``DTensor.from_local(rows, mesh, data_sharding(...))``), where DTensor's
propagation inserts the collectives. :func:`place_train_state` places a
train state (parameters and Adam's moments) on a mesh, as
``Trainer.restore_checkpoint`` leaves it whole.
"""

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from deephumor_tpu_torch.utils.pytree import flatten_tree, tree_map

__all__ = ["tp_param_specs", "make_param_shardings", "place_train_state",
           "placed_mesh", "local_tree", "is_model_sharded", "model_group",
           "gather_tree"]

_COL_PARALLEL = ("fc_q", "fc_k", "fc_v", "fc_1")  # shard weight dim 0
_ROW_PARALLEL = ("fc_o", "fc_2")  # shard weight dim 1


def tp_param_specs(params, model_axis="model"):
    """The partition spec of every leaf of a port parameter tree: a tuple
    with one entry per tensor axis, the mesh axis it is split over or None
    (``()`` = replicated), as a JAX ``PartitionSpec`` reads."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        parent = path[-2] if len(path) >= 2 else ""
        leaf = path[-1]
        if parent in _COL_PARALLEL:
            if leaf == "weight":
                return (model_axis, None)
            if leaf == "bias":
                return (model_axis,)
        if parent in _ROW_PARALLEL and leaf == "weight":
            return (None, model_axis)
        return ()

    return walk(params, ())


def _placements(mesh, spec):
    """DTensor placements of ``spec``: ``Shard(axis)`` on each mesh axis
    the spec names, ``Replicate()`` on the others."""
    return tuple(Shard(spec.index(name)) if name in spec else Replicate()
                 for name in mesh.mesh_dim_names)


def make_param_shardings(params, mesh, model_axis="model"):
    """``params`` placed on ``mesh`` by :func:`tp_param_specs`: a tree of
    DTensors, ``Replicate()`` on the data axis and the spec on the model
    axis. Rank 0's values are the ones placed."""
    specs = tp_param_specs(params, model_axis)

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [place(v, s) for v, s in zip(x, spec)]
        return distribute_tensor(x, mesh, _placements(mesh, spec))

    return place(params, specs)


def place_train_state(state, mesh, model_axis="model"):
    """A whole train state (``Trainer.init_state`` or
    ``restore_checkpoint``) placed on ``mesh``: the parameters by
    :func:`make_param_shardings`, each of Adam's moments as its parameter,
    the counts as they are."""
    params = make_param_shardings(state["params"], mesh, model_axis)
    flat = flatten_tree(params)
    opt = dict(state["opt_state"])
    for name in ("mu", "nu"):
        opt[name] = {k: distribute_tensor(v, mesh, flat[k].placements)
                     for k, v in opt[name].items()}
    return dict(state, params=params, opt_state=opt)


def placed_mesh(tree):
    """The ``DeviceMesh`` of the first DTensor leaf of ``tree``, or None
    for a tree of plain tensors."""
    for leaf in flatten_tree(tree).values():
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _local(x):
    if not isinstance(x, DTensor):
        return x
    with torch.no_grad():  # the local tensor itself, not a view of it
        return x.to_local()


def local_tree(tree):
    """``tree`` with every DTensor leaf replaced by this rank's local
    tensor (its storage: in-place updates reach the DTensor)."""
    return tree_map(_local, tree)


def is_model_sharded(x, model_axis="model"):
    """Whether ``x`` is a DTensor split over the ``model`` mesh axis."""
    if not isinstance(x, DTensor):
        return False
    names = x.device_mesh.mesh_dim_names
    return model_axis in names and isinstance(
        x.placements[names.index(model_axis)], Shard)


def model_group(tree, model_axis="model"):
    """The process group of the ``model`` mesh axis if a leaf of ``tree``
    is split over it, else None: plain tensors, or a tree replicated on
    its mesh, which every rank runs whole."""
    for leaf in flatten_tree(tree).values():
        if is_model_sharded(leaf, model_axis):
            return leaf.device_mesh.get_group(model_axis)
    return None


def gather_tree(tree):
    """``tree`` with every DTensor leaf gathered whole
    (``full_tensor``): a collective that every rank of its mesh must
    join."""
    with torch.no_grad():
        return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                        else x, tree)
