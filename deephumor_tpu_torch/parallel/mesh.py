"""Device mesh construction and batch/parameter placement over
``torch.distributed``.

Counterpart of deephumor_tpu/parallel/mesh.py. The JAX package runs one
controller over every chip; the port runs one process per card (as
``torchrun`` starts them) over a ``data x model`` ``DeviceMesh``. Every
rank makes the same calls on the same global inputs (same loader, same
seed) and takes its own rows of them: :func:`shard_batch` is the
counterpart of placing a batch with its axis 0 split over ``data``,
:func:`replicate` of placing a tree on a replicated sharding,
:func:`dp_generate` of the ``shard_map`` decode, and :func:`tp_generate`
of the jitted decode over tensor-parallel (``make_param_shardings``)
parameters, which it runs Megatron-style: each rank decodes its data
block over its local shards, with the row-parallel partial sums
all-reduced over the ``model`` axis (models/transformer.py).

``"cuda"`` meshes run over NCCL, ``"cpu"`` meshes over gloo; neither
falls back to the other.
"""

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from deephumor_tpu_torch.models import graphs
from deephumor_tpu_torch.parallel.sharding import local_tree, model_group
from deephumor_tpu_torch.pipeline import derive_seed
from deephumor_tpu_torch.utils.pytree import tree_map

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_sharding",
    "replicated_sharding",
    "dp_generate",
    "tp_generate",
    "mesh_device",
    "data_index",
    "data_size",
    "shard_generator",
    "all_gather_rows",
]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _init_group(device_type):
    """The default process group for ``device_type``: the one already made
    (its backend must match), else one from ``torchrun``'s environment
    (``env://``; each rank on ``cuda:LOCAL_RANK``), else an explicit
    one-rank group over an in-process store: world size 1, for a process
    started without ``torchrun``."""
    backend = _BACKENDS.get(device_type)
    if backend is None:
        raise ValueError(f"device_type must be one of {sorted(_BACKENDS)}")
    bound = {}  # NCCL: this rank's card, not one guessed from its rank
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        bound["device_id"] = torch.device("cuda", local)
    if dist.is_initialized():
        have = dist.get_backend()
        if backend not in have:
            raise ValueError(f"a {device_type} mesh needs a {backend} "
                             f"process group; the default group is {have}")
        return
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **bound)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **bound)


def make_mesh(device_type="cuda", data=None, model=1,
              axis_names=("data", "model")):
    """Builds a ``data x model`` ``DeviceMesh`` over the default process
    group, which it makes first when there is none (see the module
    docstring).

    Args:
        device_type: "cuda" (NCCL) or "cpu" (gloo).
        data: size of the data axis (default: world size // model).
        model: size of the tensor-parallel axis (default 1 = pure DP).
    """
    n = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", 1)))
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    _init_group(device_type)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh):
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_size(mesh):
    return mesh.size(mesh.mesh_dim_names.index("data"))


def data_index(mesh):
    """This rank's coordinate on the ``data`` axis."""
    return mesh.get_local_rank("data")


def _model_size(mesh):
    names = mesh.mesh_dim_names
    return mesh.size(names.index("model")) if "model" in names else 1


def data_sharding(mesh, ndim=1):
    """DTensor placements splitting axis 0 over the ``data`` mesh axis
    (replicated over the others), for an array of ``ndim`` >= 1 axes."""
    if ndim < 1:
        raise ValueError("a 0-d array has no axis to shard over 'data'")
    return tuple(Shard(0) if name == "data" else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated_sharding(mesh):
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def _rows(x, n_shards, index, device):
    """Block ``index`` of ``n_shards`` of axis 0 of ``x`` on ``device``."""
    if getattr(x, "ndim", 0) < 1:
        raise ValueError("shard_batch: a leaf has no batch axis")
    n = x.shape[0]
    if n % n_shards:
        raise ValueError(f"batch axis {n} is not a multiple of the mesh's "
                         f"data-axis size {n_shards}")
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    block = n // n_shards
    return x[index * block:(index + 1) * block].to(device, non_blocking=True)


def shard_batch(batch, mesh):
    """This rank's contiguous block of axis 0 of every array of ``batch``
    (a tensor or numpy array, or dicts, tuples and lists of them), on the
    rank's device. Every rank holds the same global batch; raises
    ``ValueError`` when an axis 0 is not a multiple of the data size."""
    n, i, dev = data_size(mesh), data_index(mesh), mesh_device(mesh)
    return tree_map(lambda x: _rows(x, n, i, dev), batch)


def replicate(tree, mesh):
    """Every leaf of ``tree`` as rank 0 holds it, on this rank's device:
    tensors are broadcast from rank 0 (into copies), other leaves
    (Python numbers) come with one object broadcast. Ranks start equal."""
    dev = mesh_device(mesh)
    others = []

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            others.append(x)
            return x
        x = x.detach().to(dev, copy=True)
        dist.broadcast(x, src=0)
        return x

    out = tree_map(bcast, tree)
    if not others:
        return out
    # NCCL stages the objects' bytes on the rank's card, gloo on the CPU
    dist.broadcast_object_list(others, src=0,
                               device=dev if dev.type == "cuda" else None)
    it = iter(others)
    return tree_map(lambda x: x if isinstance(x, torch.Tensor)
                    else next(it), out)


def shard_generator(generator, mesh, out=None):
    """A generator for this rank's shard, on its device: seeded by
    ``derive_seed`` of a seed drawn from ``generator`` (every rank holds an
    equal one, so all draw the same) and the rank's data index: the
    counterpart of ``fold_in(key, axis_index('data'))``. None stands for a
    generator seeded with 0. ``out``: a generator on the rank's device to
    reseed in place and return instead of a new one, with the same draws
    (a captured train step holds its generator)."""
    dev = mesh_device(mesh)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    if out is None:
        out = torch.Generator(dev)
    return out.manual_seed(derive_seed(seed, data_index(mesh)))


def all_gather_rows(x, group):
    """``x`` of every rank of ``group``, joined along axis 0 in rank
    order."""
    as_bool = x.dtype == torch.bool
    x = x.to(torch.uint8) if as_bool else x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    return out.bool() if as_bool else out


def _data_rows(x, mesh, n, i, dev):
    """This rank's data block of ``x``: a DTensor's local rows (it must be
    split over ``data`` and replicated over the other axes, as
    ``data_sharding`` places it), else block ``i`` of ``n`` of axis 0."""
    if isinstance(x, DTensor):
        if tuple(x.placements) != data_sharding(mesh, x.ndim):
            raise ValueError(f"a DTensor input must be placed as "
                             f"data_sharding(mesh), not {x.placements}")
        return local_tree(x).to(dev)
    return _rows(x, n, i, dev)


def _generate_blocks(model, params, enc, mesh, generator, generate_kwargs,
                     group_of_model=None, sharded=False):
    """The body of :func:`dp_generate` and :func:`tp_generate`: this rank's
    block of ``enc`` and of the batch-shaped keyword tensors through
    ``model.generate_from_emb`` with the rank's generator, then the outputs
    gathered over the data axis (tensors) or listed per shard. With
    ``group_of_model`` (a model axis of several ranks) the chosen ids are
    checked equal over it; ``sharded``: ``params`` hold tensor-parallel
    shards, and the decode runs its collectives over that group: captured
    over NCCL, eagerly over gloo, where ``compiled=True`` raises before
    the generator is drawn from."""
    n, i, dev = data_size(mesh), data_index(mesh), mesh_device(mesh)
    if sharded:
        graphs.use_graphs(generate_kwargs.get("compiled"), dev,
                          (group_of_model,))
    first = enc[0] if isinstance(enc, tuple) else enc
    bs = first.shape[0]
    local_enc = tree_map(lambda x: _data_rows(x, mesh, n, i, dev), enc)
    kwargs = {k: _data_rows(v, mesh, n, i, dev)
              if isinstance(v, torch.Tensor) and v.ndim >= 1
              and v.shape[0] == bs else v
              for k, v in generate_kwargs.items()}
    if sharded:
        kwargs["model_group"] = group_of_model
    out = model.generate_from_emb(params, local_enc,
                                  generator=shard_generator(generator, mesh),
                                  **kwargs)
    # after the call's last graph: one agreement check and one all-gather
    # per call, from the host
    if group_of_model is not None:
        _check_model_agreement(out["chosen"], group_of_model)
    group = mesh.get_group("data")
    gathered = {}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            gathered[k] = all_gather_rows(v, group)
        else:
            per_shard = [None] * n
            dist.all_gather_object(per_shard, v, group=group)
            gathered[k] = per_shard
    return gathered


def _check_model_agreement(chosen, group):
    """Raises unless every rank of the model group chose the same ids: a
    rank that drew otherwise would follow other beams, and its head-local
    caches would silently part from its peers'."""
    ids = all_gather_rows(chosen, group).reshape(-1, *chosen.shape)
    if not bool((ids == chosen).all()):
        raise RuntimeError("tp_generate: the ranks of a model group chose "
                           "different tokens; their draws must be equal")


def dp_generate(model, params, enc, mesh, generator=None, **generate_kwargs):
    """Data-parallel batched generation over the ``data`` mesh axis.

    Every rank calls it with the same replicated ``params`` and the same
    global ``enc`` (the ``encode()`` output: a tensor or a tuple, batch
    axis 0 a multiple of the data size) and keyword arguments. Each rank
    takes its block of the rows of ``enc`` and of every keyword tensor
    whose axis 0 is the batch (``caption`` prefixes, ``labels``), and runs
    the whole ``generate_from_emb`` on them (on the card: the decode
    kernels at the local shapes), drawing from
    ``shard_generator(generator, mesh)``: draws are decorrelated across
    shards, and greedy runs are token-equal to the unsharded run.

    Returns the generation dict of the whole batch on every rank: each
    tensor of the local output (its axis 0 the local batch, as the output
    gives it) is all-gathered along axis 0. A leaf that is not a tensor
    (``boundaries``: the live items and stragglers each shard's phase
    boundaries left) differs per shard, so it becomes the list of every
    shard's value, in data order, equal on every rank.
    """
    if _model_size(mesh) != 1:
        raise ValueError("dp_generate shards over 'data' only; build the "
                         "mesh with model=1")
    return _generate_blocks(model, params, enc, mesh, generator,
                            generate_kwargs)


def tp_generate(model, tp_params, enc, mesh, generator=None,
                **generate_kwargs):
    """Generation on a ``data x model`` mesh over tensor-parallel
    parameters (``make_param_shardings``: DTensors; the counterpart of the
    JAX package's jitted ``generate_from_emb`` over placed parameters).

    Every rank calls it with the same ``tp_params``, ``enc`` (the whole
    batch on every rank, or DTensors placed by ``data_sharding``) and
    keyword arguments. Each rank takes its data block of ``enc`` and of
    the batch-shaped keyword tensors (as :func:`dp_generate`), the local
    shards of the parameters, and runs ``generate_from_emb`` over its
    ``n_heads / model`` heads: the kernels at head-local shapes (caches
    and cross store ``D / model`` wide), the fc_o / fc_2 partial sums
    all-reduced over the ``model`` group in f32, the classifier and the
    draw (replicated) whole on every rank. The generator comes from
    ``shard_generator(generator, mesh)``, derived over the data axis only,
    so every rank of a model group draws alike; the call checks once that
    their chosen ids agree and raises ``RuntimeError`` if not. Over NCCL
    the decode replays as CUDA graphs (models/graphs.py; the all-reduces
    inside them), as one card's does; over gloo it runs eagerly, and
    ``compiled=True`` raises ``ValueError`` before any work.

    Returns what :func:`dp_generate` returns: the whole batch's outputs
    on every rank. On a mesh whose model axis has size 1, or over a tree
    with no leaf split over it (the LSTMs, a replicated tree), every rank
    decodes its block with whole weights, as :func:`dp_generate` does.
    """
    group = mesh.get_group("model") if _model_size(mesh) > 1 else None
    return _generate_blocks(model, local_tree(tp_params), enc, mesh,
                            generator, generate_kwargs, group,
                            sharded=model_group(tp_params) is not None)
