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

Parameters placed by :func:`make_param_shardings` are DTensors; the
teacher-forced ``forward``, the loss and their gradient run on them with
DTensor inputs (``DTensor.from_local(rows, mesh, data_sharding(...))``),
and DTensor's propagation inserts the collectives.
"""

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

__all__ = ["tp_param_specs", "make_param_shardings"]

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
