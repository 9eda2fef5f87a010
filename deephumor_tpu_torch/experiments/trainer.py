"""Training loop: train and eval steps, clipped Adam, metrics logging,
best-val checkpointing and a full resume.

Counterpart of deephumor_tpu/experiments/trainer.py: teacher forcing on
``captions[:, :-1]``, with lengths the non-pad counts of the full caption;
the masked cross-entropy and the perplexity metric; clipping by the
global norm, then Adam (AdamW with ``weight_decay``) with optax's
arithmetic; the ResNet trunk and every batch-norm running statistic
frozen; epoch loops over train/val phases; the best-val model and a
per-epoch train state saved; the reference's metric tag names.

The step is plain PyTorch (autograd, ``torch._foreach_*`` updates) and
launches none of the port's kernels. It updates the state's parameter,
batch-norm statistic and moment tensors in place and returns the state
(the JAX package's ``donate=True`` loop: ``state, metrics = step(state,
...)``), whose tensors keep their addresses. On a CUDA device the train
step, the eval step and the trunk of ``build_trunk_cache`` replay as CUDA
graphs, one per static configuration (experiments/step_graphs.py: the
counterpart of the JAX package's jitted steps), unless the trainer is
made with ``compiled=False``; on the CPU they run eagerly. Over a mesh
they replay the same way when its groups are NCCL, the step's
all-reduces inside the graph; over gloo, whose collectives cannot be
captured, they run eagerly. The values of a step that change with
Adam's count (the learning rate and the two bias corrections) are
written into a device buffer before each step, so one graph serves
every step.

With a mesh (``run_epoch(..., mesh=)``, ``train(..., mesh=)``; the state
replicated with ``parallel.replicate``) every rank runs the same steps on
the same global batches, as ``torchrun`` starts one process per card:
each takes its rows (``parallel.shard_batch``); the loss, the perplexity
and the batch-norm moments are normalised by the global batch; the
gradients are summed over the data axis before the clip, so that the
global norm, the clip and the Adam update are the single-device ones on
every rank; dropout draws from a generator per data block, one per
trainer, reseeded at each epoch (a captured step's key holds it); only
rank 0 writes metrics and checkpoints. A state placed by
``parallel.place_train_state`` on a mesh with a ``model`` axis (DP x TP)
steps over each rank's local shards: the transformers' forward runs its
heads and pf units with the model-axis collectives
(models/transformer.py), the gradients of the local shards are summed
over the data axis only, the clip's global norm counts each sharded
leaf's squares summed over the model axis and each replicated leaf's
once, and Adam updates the local shards and their moments.

The train state checkpoint is the JAX package's ``<path>.state.npz``
layout, so either package resumes the other's, and it does not depend on
the layout: a placed state is gathered whole before it is written, and
``restore_checkpoint`` returns plain tensors that the caller places on
any mesh (``parallel.place_train_state``, ``parallel.replicate``) or on
none. Its keys: ``params/<flat JAX key>``,
``step``, then ``opt/<i>``, the optimizer state's leaves in optax's order
(Adam's int32 count, the first moment of every trainable leaf in JAX tree
order, the second moments in the same order, and with a schedule the
schedule's count).
"""

import dataclasses
import json
import os
import queue
import threading
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from deephumor_tpu_torch.convert.jax_params import (params_from_jax,
                                                    params_to_jax)
from deephumor_tpu_torch.experiments.metrics import masked_ce_and_perplexity
from deephumor_tpu_torch.experiments.step_graphs import StepGraphs, step_key
from deephumor_tpu_torch.models import graphs
from deephumor_tpu_torch.parallel.sharding import (gather_tree,
                                                   is_model_sharded,
                                                   local_tree, model_group,
                                                   placed_mesh)
from deephumor_tpu_torch.utils.collectives import all_reduce
from deephumor_tpu_torch.utils.pytree import (flatten_tree, tree_map,
                                              unflatten_tree)

__all__ = ["Trainer", "Adam", "MetricsWriter", "frozen_mask"]

# leaves that the optimizer never updates: batch-norm running statistics,
# under both packages' names (they advance through the forward)
_STAT_NAMES = ("mean", "var", "running_mean", "running_var")


def frozen_mask(params):
    """The tree of ``params`` with True at every trainable leaf: False
    under ``resnet`` and at batch-norm running statistics. Takes the
    port's tree or the JAX package's."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        return "resnet" not in path and path[-1] not in _STAT_NAMES

    return walk(params, ())


def _trainable_paths(params):
    """Flat keys of the trainable leaves, in the port tree's order."""
    return [k for k, m in flatten_tree(frozen_mask(params)).items() if m]


def _prune(tree, mask):
    """``tree`` without the branches that hold no trainable leaf (the
    ResNet), so that the moments convert without the frozen weights. A
    layer dict with a trainable leaf stays whole, as its conversion needs
    it. Leaves keep their order."""
    if isinstance(tree, dict):
        if not any(isinstance(v, (dict, list)) for v in tree.values()):
            return tree
        return {k: _prune(v, mask[k]) for k, v in tree.items()
                if any(flatten_tree(mask[k]).values())}
    if isinstance(tree, list):
        return [_prune(v, m) for v, m in zip(tree, mask)]
    return tree


def _jax_order(tree, prefix=""):
    """``(flat key, leaf)`` of a nested dict/list tree in JAX's leaf order
    (dict keys sorted, list entries in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_order(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_order(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


class Adam:
    """Clip by global norm, then Adam (AdamW when ``weight_decay``), over
    the trainable leaves only: frozen leaves (``frozen_mask``) get no
    update at all. optax's arithmetic: no epsilon in the clip (``g /
    norm * clip_norm`` when the norm reaches ``clip_norm``), the moments
    as ``(1 - b) * g + b * m``, bias correction with the count after its
    increment, ``m_hat / (sqrt(v_hat) + eps)``. ``schedule``, a callable
    of the update count (0 for the first update), replaces
    ``learning_rate``.

    The state is ``{"count": int, "mu": {flat key: tensor}, "nu": ...}``
    over the trainable keys of the port's tree. The count stays on the
    host; the values the update takes from it (:meth:`terms`) reach the
    device through a buffer written before each update
    (:meth:`write_terms`), which a captured step reads.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate=1e-3, clip_norm=3.0, schedule=None,
                 weight_decay=0.0):
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        self.schedule = schedule
        self.weight_decay = weight_decay

    def init(self, params):
        flat = flatten_tree(params)
        keys = _trainable_paths(params)
        return {"count": 0,
                "mu": {k: torch.zeros_like(flat[k]) for k in keys},
                "nu": {k: torch.zeros_like(flat[k]) for k in keys}}

    def terms(self, count):
        """The update's values after ``count`` updates, in double on the
        host as optax computes them: the learning rate (``schedule(count)``
        with a schedule) and the bias corrections ``1 - b1 ** (count + 1)``
        and ``1 - b2 ** (count + 1)``."""
        lr = (self.schedule(count) if self.schedule is not None
              else self.learning_rate)
        return (float(lr), 1 - self.b1 ** (count + 1),
                1 - self.b2 ** (count + 1))

    @torch.no_grad()
    def write_terms(self, buf, opt_state):
        """Writes the next update's :meth:`terms` into ``buf`` (3 f32 on the
        update's device; each rounded to f32 as a scalar operand would be)
        by fills, which wait for nothing, and advances the count."""
        for i, v in enumerate(self.terms(opt_state["count"])):
            buf[i].fill_(v)
        opt_state["count"] += 1

    @torch.no_grad()
    def update(self, leaves, grads, keys, opt_state, terms, model_group=None,
               sharded=None):
        """Updates the trainable ``leaves`` (flat ``keys``) and the
        moments in place from ``grads``, with the learning rate and bias
        corrections in ``terms`` (:meth:`write_terms`'s buffer); returns
        the pre-clip global norm, a device scalar. Reads nothing from the
        host, so a graph can hold it. With ``model_group`` the leaves,
        gradients and moments are this rank's local shards (moments placed
        on a mesh are read through their local tensors), and ``sharded``
        (a bool tensor on their device, one entry a leaf) marks the leaves
        split over the group: their squares are summed over it, the
        replicated leaves' counted once."""
        mu = [local_tree(opt_state["mu"][k]) for k in keys]
        nu = [local_tree(opt_state["nu"][k]) for k in keys]
        norms = torch.stack(torch._foreach_norm(grads))
        if model_group is None:
            norm = torch.linalg.vector_norm(norms)
        else:
            sq = norms * norms
            sq_split = torch.where(sharded, sq, 0.0).sum()
            all_reduce(sq_split, model_group)
            norm = torch.sqrt(sq_split + torch.where(sharded, 0.0, sq).sum())
        scale = torch.where(norm < self.clip_norm, 1.0,
                            self.clip_norm / norm)
        grads = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        lr, c1, c2 = terms.unbind()
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, leaves, alpha=self.weight_decay)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(leaves, upd)
        return norm

    def to_leaves(self, opt_state, params):
        """The state as optax's leaves (numpy), in its order."""
        params = _prune(params, frozen_mask(params))
        flat = flatten_tree(params)
        leaves = [np.asarray(opt_state["count"], np.int32)]
        for moment in (opt_state["mu"], opt_state["nu"]):
            full = unflatten_tree({k: moment.get(k, torch.zeros_like(v))
                                   for k, v in flat.items()})
            tree = params_to_jax(full)
            mask = flatten_tree(frozen_mask(tree))
            leaves += [x for k, x in _jax_order(tree) if mask[k]]
        if self.schedule is not None:
            leaves.append(np.asarray(opt_state["count"], np.int32))
        return leaves

    def from_leaves(self, leaves, jax_params, device):
        """Rebuilds the state from optax's leaves over ``jax_params`` (the
        JAX layout of the parameters, numpy)."""
        jax_params = _prune(jax_params, frozen_mask(jax_params))
        mask = flatten_tree(frozen_mask(jax_params))
        order = list(_jax_order(jax_params))
        keys = [k for k, _ in order if mask[k]]
        n = len(keys)
        want = 1 + 2 * n + (self.schedule is not None)
        if len(leaves) != want:
            raise ValueError(f"optimizer state has {len(leaves)} leaves; "
                             f"this model and optimizer take {want}")
        state = {"count": int(leaves[0])}
        for name, part in (("mu", leaves[1:1 + n]),
                           ("nu", leaves[1 + n:1 + 2 * n])):
            given = dict(zip(keys, part))
            tree = params_from_jax(unflatten_tree(
                {k: given[k] if k in given else np.zeros_like(x)
                 for k, x in order}))
            flat = flatten_tree(tree)
            state[name] = {k: flat[k].to(device)
                           for k in _trainable_paths(tree)}
        return state


def _all_reduce_sum(tensors, group):
    """``tensors`` summed over ``group``: one all-reduce of their f32
    concatenation."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce(flat, group)
    parts = flat.split([t.numel() for t in tensors])
    return [p.view_as(t).to(t.dtype) for p, t in zip(parts, tensors)]


def _local_params(params):
    """(this rank's local tree, the model axis's group) of a tree placed on
    a mesh (``(params, None)`` for plain tensors); the group is None unless
    a leaf is split over the model axis."""
    if placed_mesh(params) is None:
        return params, None
    return local_tree(params), model_group(params)


@torch.no_grad()
def _write_stats(flat, new_params):
    """Copies the leaves of ``new_params`` that a train forward made anew
    (the batch-norm statistics) into the matching tensors of ``flat``
    (the state's flat tree, or its local tensors on a mesh), so that the
    state keeps its tensors and addresses."""
    for k, v in flatten_tree(new_params).items():
        if v is not flat[k]:
            flat[k].copy_(v)


def _leads(mesh):
    """Whether this process writes logs and checkpoints: always without a
    mesh, on rank 0 with one."""
    return mesh is None or dist.get_rank() == 0


class MetricsWriter:
    """Scalars as JSON lines in ``<log_dir>/metrics.jsonl``, and to
    TensorBoard where ``tensorboardX`` imports. Tag names as the
    reference's."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag, value, step):
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": value,
                                      "step": int(step)}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


def _prefetch_iter(iterable, prepare, depth):
    """Yields ``prepare(batch)`` for each batch of ``iterable``, made by a
    producer thread up to ``depth`` batches ahead. A producer exception
    is raised at the consumer's next item. When the consumer stops early
    (a step raised, the generator was dropped), the producer is told to
    stop, joined, and only then is the queue drained, so that no batch it
    put after the drain stays behind."""
    q = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        end = done
        try:
            for batch in iterable:
                if not put(prepare(batch)):
                    return
        except Exception as e:  # noqa: BLE001 - raised on the consumer
            end = e
        put(end)

    t = threading.Thread(target=produce, daemon=True,
                         name="dh-epoch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        # put() polls ``stop`` every 0.1 s; a producer still inside the
        # loader's next() exits at its next put
        t.join(timeout=1.0)
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


class Trainer:
    """Runs epochs of train and eval steps over batch iterators.

    Args:
        model: a captioner of ``deephumor_tpu_torch.models``.
        log_dir: experiment root; a ``<title>@<timestamp>`` directory is
            made in it, with one metrics directory per phase, at the
            phase's first epoch (with a mesh: on rank 0 only).
        clip_norm: global-norm clip (the reference's 3.0).
        log_grad_norm: also log the pre-clip gradient norm.
        compute_dtype: ``"bfloat16"`` runs the decoder in bf16 (its
            parameters and the encoder's output cast at the seam); master
            parameters, the encoder, batch-norm statistics, the optimizer
            and the loss stay f32. None or "float32": all f32.
        log_flush_every: per-step scalars stay on the device and are
            fetched together every this many steps (and at the epoch's
            end): no step waits for the device. A non-finite loss raises
            ``FloatingPointError`` at that fetch, up to this many steps
            late.
        prefetch: depth of ``run_epoch``'s host pipeline (default 2): a
            producer thread collates and pins the next batches while the
            current step runs; the host-to-device copy is issued by the
            step's thread, without waiting. 0 makes the loop synchronous.
            The dropout draws come from the generator the steps consume
            in order, which the producer never touches, so every depth
            gives the same results.
        device: where the state lives and the steps run (``"cuda"``
            unless the caller asks for the CPU).
        compiled: on a CUDA device, None (default) or True runs the train
            step, the eval step and ``build_trunk_cache``'s trunk as CUDA
            graphs (experiments/step_graphs.py: one per static
            configuration, made at its first call, which runs eagerly and
            counts); False runs them from the host, with the same results.
            On the CPU they always run eagerly. Over a mesh whose groups
            are NCCL the steps replay the same way, their all-reduces in
            the graph; over gloo they run eagerly, and True raises
            ``ValueError`` before any work.
    """

    def __init__(self, model, experiment_title="experiment",
                 log_dir="./logs", learning_rate=1e-3, clip_norm=3.0,
                 log_grad_norm=False, pad_index=0, schedule=None,
                 weight_decay=0.0, phases=("train", "val"),
                 compute_dtype=None, log_flush_every=64, prefetch=2,
                 device="cuda", compiled=None):
        self.model = model
        self.pad_index = pad_index
        self.log_grad_norm = log_grad_norm
        self.log_flush_every = max(1, int(log_flush_every))
        self.phases = phases
        self.prefetch = max(0, int(prefetch))
        self.device = torch.device(device)
        self.compiled = compiled
        self._graphs = StepGraphs()
        self._terms = None  # Adam.write_terms's buffer, made at first use
        # the mesh epochs' dropout generators, one per device and data
        # index, reseeded in place at each epoch: a captured step's key
        # holds its generator
        self._shard_gens = {}
        # Adam.update's ``sharded`` masks on the device, one per pattern
        self._masks = {}
        self._opt = Adam(learning_rate, clip_norm, schedule, weight_decay)
        self._step_model = model
        if compute_dtype not in (None, "float32"):
            self._step_model = dataclasses.replace(
                model, compute_dtype=str(compute_dtype))
        stamp = datetime.now().strftime("%d.%m.%Y-%H:%M:%S")
        self.experiment_name = f"{experiment_title}@{stamp}"
        self.experiment_dir = os.path.join(log_dir, self.experiment_name)
        self.title = experiment_title
        self.writers = {}  # phase -> MetricsWriter, made at first use
        self._trunk_cache = None

    def _writer(self, phase):
        if phase not in self.writers:
            self.writers[phase] = MetricsWriter(
                os.path.join(self.experiment_dir, phase))
        return self.writers[phase]

    # -- state -------------------------------------------------------------
    def init_state(self, gen=None, params=None):
        """``{params, opt_state, step}``; ``params`` from
        ``model.init(gen, device)`` unless given (``from_pretrained``,
        ``from_torch``), on this trainer's device."""
        if params is None:
            params = self.model.init(gen, self.device)
        return {"params": params, "opt_state": self._opt.init(params),
                "step": 0}

    # -- trunk-feature cache -------------------------------------------------
    def build_trunk_cache(self, params, dataset, batch_size=16):
        """Runs every template image of ``dataset.images`` through the
        frozen ResNet trunk once and keeps the features on the device; the
        steps then gather them for batches that carry ``image_rows``. The
        trunk runs in eval mode without a gradient, so training on the
        cache is the same computation. Returns the ``image_rows`` mapping
        (template key -> row) for ``BatchIterator``. On the card the
        trunk replays as a CUDA graph per chunk shape (the last, shorter
        chunk has its own), with the eager trunk's features; the steps'
        graphs read the new cache, so they are made anew."""
        keys = list(dataset.images)
        trunk = StepGraphs()
        feats = []
        for start in range(0, len(keys), batch_size):
            images = torch.from_numpy(np.stack(
                [dataset.images[k] for k in keys[start:start + batch_size]]
            ).astype(np.float32)).to(self.device)
            if graphs.use_graphs(self.compiled, self.device):
                key = step_key("trunk", self.model, {"images": images}, ())
                feats.append(trunk.run(
                    key, lambda x: self.model.trunk(params, x["images"]),
                    {"images": images}).clone())
            else:
                feats.append(self.model.trunk(params, images))
        trunk.clear()
        self._graphs.clear()
        self._trunk_cache = torch.cat(feats)
        return {k: i for i, k in enumerate(keys)}

    # -- steps ---------------------------------------------------------------
    def _loss(self, params, batch, gen, train, group=None, model_group=None):
        """(loss, perplexity, new params) of one device batch. Rows that
        ``row_valid`` marks as padding become all-pad captions (out of the
        loss) and weigh 0 in the perplexity. With ``group`` (a mesh's data
        axis), the batch is this rank's shard and the results are its
        share of the global batch's (``experiments/metrics.py``); with
        ``model_group``, ``params`` are this rank's tensor-parallel
        shards."""
        pad = self.pad_index
        captions = batch["captions"]
        row_valid = batch.get("row_valid")
        if row_valid is not None:
            captions = torch.where(row_valid[:, None], captions, pad)
        lengths = (captions != pad).sum(dim=1)
        kwargs = ({"labels": batch["labels"]}
                  if getattr(self.model, "with_labels", False) else {})
        if "image_rows" in batch:
            images = self._trunk_cache[batch["image_rows"]]
            kwargs["from_trunk"] = True
        else:
            images = batch["images"]
        if model_group is not None:
            kwargs["model_group"] = model_group
        out = self._step_model.forward(params, images, captions[:, :-1],
                                       train=train, gen=gen, group=group,
                                       **kwargs)
        logits, new_params = out if train else (out, params)
        loss, pp = masked_ce_and_perplexity(
            logits[:, :captions.shape[1]], captions, lengths, pad,
            row_weights=row_valid, group=group)
        return loss, pp, new_params

    def _captures(self, group, model_group):
        """Whether a step runs as a graph (``compiled``): over a mesh
        (``group``, its data axis; ``model_group``, the model axis of a
        placed state) only when those groups are NCCL. Over gloo a step
        runs eagerly, and ``compiled=True`` raises ``ValueError``."""
        return graphs.use_graphs(self.compiled, self.device,
                                 (group, model_group))

    def _sharded_mask(self, flags, device):
        """``flags`` as a bool tensor on ``device``, made once per pattern:
        a graph reads it by address, and no step copies from the host."""
        key = (tuple(flags), device)
        if key not in self._masks:
            self._masks[key] = torch.tensor(flags, device=device)
        return self._masks[key]

    def _terms_buffer(self, device):
        if self._terms is None or self._terms.device != device:
            self._terms = torch.zeros(3, device=device)
        return self._terms

    def _train_step(self, state, batch, gen, group=None):
        """Forward, loss, backward, clip and Adam on a device batch, with
        dropout drawn from ``gen``; the encoder's batch-norm statistics
        come from the forward. With ``group`` (a mesh's data axis) the
        batch is this rank's shard: the gradients, the loss and the
        perplexity are summed over the group before the clip. A state
        placed on a mesh with a model axis steps over its local shards
        (module docstring). Returns ``(state, metrics)``, the metrics
        device scalars; captured, they are the graph's outputs, which the
        next step overwrites."""
        placed = state["params"]
        params, model_group = _local_params(placed)
        captured = self._captures(group, model_group)
        flat = flatten_tree(params)
        keys = _trainable_paths(params)
        opt = state["opt_state"]
        device = flat[keys[0]].device
        tp = {}
        if model_group is not None:
            flat_placed = flatten_tree(placed)
            tp = {"model_group": model_group,
                  "sharded": self._sharded_mask(
                      [is_model_sharded(flat_placed[k]) for k in keys],
                      device)}
        terms = self._terms_buffer(device)
        self._opt.write_terms(terms, opt)

        def step(batch):
            leaves = [flat[k].requires_grad_() for k in keys]
            loss, pp, new_params = self._loss(params, batch, gen, True,
                                              group, model_group)
            grads = list(torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True))
            loss, pp = loss.detach(), pp.detach()
            if group is not None:
                *grads, loss, pp = _all_reduce_sum(grads + [loss, pp], group)
                # copies: as views, the metrics would keep the whole
                # summed-gradient buffer alive into the next step
                loss, pp = loss.clone(), pp.clone()
            norm = self._opt.update(leaves, grads, keys, opt, terms, **tp)
            _write_stats(flat, new_params)
            return {"loss": loss, "perplexity": pp, "grad_norm": norm}

        if captured:
            metrics = self._graphs.run(
                self._key("train", params, batch, opt, gen,
                          (group, model_group)), step, batch, gen)
        else:
            metrics = step(batch)
        return dict(state, step=state["step"] + 1), metrics

    def _key(self, kind, params, batch, opt_state=None, gen=None,
             groups=()):
        """The key of a train step (``opt_state`` given) or an eval step
        (experiments/step_graphs.py ``step_key``): the tensors its graph
        reads are every parameter (``params``: the local tensors of a
        placed state), the trunk cache and, for a train step, Adam's
        moments (their local tensors) and the count terms' buffer;
        ``groups``, the data and model groups of a step over a mesh."""
        tensors = list(flatten_tree(params).values())
        if opt_state is not None:
            tensors += [*local_tree(opt_state["mu"]).values(),
                        *local_tree(opt_state["nu"]).values(), self._terms]
        if self._trunk_cache is not None:
            tensors.append(self._trunk_cache)
        return step_key(kind, self._step_model, batch, tensors, gen,
                        groups)

    @torch.no_grad()
    def _eval_step(self, params, batch, group=None):
        placed = params
        params, model_group = _local_params(placed)

        def step(batch):
            loss, pp, _ = self._loss(params, batch, None, False, group,
                                     model_group)
            if group is not None:
                loss, pp = _all_reduce_sum([loss, pp], group)
            return {"loss": loss, "perplexity": pp}

        if self._captures(group, model_group):
            return self._graphs.run(
                self._key("eval", params, batch, groups=(group, model_group)),
                step, batch)
        return step(batch)

    # -- epochs --------------------------------------------------------------
    def _host_batch(self, batch):
        """The host leg of one batch: its real rows, and its arrays as
        tensors (ids as int64), pinned when the steps run on the card."""
        n = (int(np.asarray(batch["row_valid"]).sum())
             if "row_valid" in batch else len(batch["captions"]))
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if v.dtype.kind in "iu":
                v = v.astype(np.int64)
            t = torch.from_numpy(v)
            out[k] = t.pin_memory() if self.device.type == "cuda" else t
        return out, n

    def run_epoch(self, state, dataloader, gen, phase="train", epoch=0,
                  mesh=None):
        """One pass over ``dataloader`` (dict batches of numpy arrays:
        ``captions``, ``images`` or ``image_rows``, ``labels``,
        ``row_valid``); train steps draw dropout from ``gen``, a
        ``torch.Generator`` on the device. Returns ``(state, mean loss,
        mean perplexity)``, each weighted by a batch's real rows.

        With ``mesh`` (the state replicated on it, or placed by
        ``parallel.place_train_state`` for DP x TP), every rank passes the
        same batches and ``gen``: each step takes this rank's rows of the
        batch and sums the gradients over the ``data`` axis before the
        clip; dropout draws from ``parallel.mesh.shard_generator(gen,
        mesh)`` (one generator per data block: this trainer's, reseeded
        in place, so that a captured step's key holds across epochs); the
        returned and logged loss and perplexity are the global batch's,
        and only rank 0 writes them. Over NCCL the steps replay as graphs
        (:class:`Trainer`'s ``compiled``); over gloo they run eagerly."""
        group = None if mesh is None else mesh.get_group("data")
        step_args = () if mesh is None else (group,)
        # raises before any work (compiled=True over gloo)
        self._captures(group, model_group(state["params"]))
        is_train = phase == "train"
        writer = (self._writer(phase)
                  if phase in self.phases and _leads(mesh) else None)
        if mesh is not None:
            from deephumor_tpu_torch.parallel.mesh import (data_index,
                                                           mesh_device,
                                                           shard_batch,
                                                           shard_generator)

            if is_train and gen is not None:
                dev = mesh_device(mesh)
                own = self._shard_gens.setdefault((dev, data_index(mesh)),
                                                  torch.Generator(dev))
                gen = shard_generator(gen, mesh, out=own)
        totals = {"loss": 0.0, "pp": 0.0, "n": 0}
        # each step's metrics, copied into a row of a device ring (a
        # captured step's outputs are overwritten by the next replay) and
        # fetched together every log_flush_every steps: (step, real rows)
        # per row
        ring, names, rows = None, None, []
        step0 = state["step"] if is_train else 0

        def flush():
            if not rows:
                return
            first = rows[0][0]
            cols = dict(zip(names, ring[:len(rows)].cpu().numpy().T))
            ns = np.asarray([n for _, n in rows], np.float64)
            losses = cols["loss"]
            if not np.isfinite(losses).all():
                bad = int(np.argmax(~np.isfinite(losses)))
                raise FloatingPointError(
                    f"non-finite loss {losses[bad]} at step {first + bad} "
                    f"({phase})")
            if writer is not None and is_train:
                for j in range(len(rows)):
                    writer.add_scalar("train/batch_loss", losses[j],
                                      first + j)
                    writer.add_scalar("train/batch_perplexity",
                                      cols["perplexity"][j], first + j)
                    if self.log_grad_norm:
                        writer.add_scalar("train/grad_norm",
                                          cols["grad_norm"][j], first + j)
            totals["loss"] += float(losses @ ns)
            totals["pp"] += float(cols["perplexity"] @ ns)
            totals["n"] += int(ns.sum())
            rows.clear()

        batches = (_prefetch_iter(dataloader, self._host_batch, self.prefetch)
                   if self.prefetch
                   else map(self._host_batch, dataloader))
        for i, (host, n) in enumerate(batches):
            if mesh is None:
                batch = {k: v.to(self.device, non_blocking=True)
                         for k, v in host.items()}
            else:
                batch = shard_batch(host, mesh)
            if is_train:
                state, metrics = self._train_step(state, batch, gen,
                                                  *step_args)
            else:
                metrics = self._eval_step(state["params"], batch, *step_args)
            if ring is None:
                names = list(metrics)
                ring = torch.empty((self.log_flush_every, len(names)),
                                   dtype=metrics["loss"].dtype,
                                   device=metrics["loss"].device)
            torch.stack([metrics[k] for k in names], out=ring[len(rows)])
            rows.append((step0 + i + is_train, n))
            if len(rows) >= self.log_flush_every:
                flush()
        flush()
        epoch_loss = totals["loss"] / max(totals["n"], 1)
        epoch_pp = totals["pp"] / max(totals["n"], 1)
        if writer is not None:
            writer.add_scalar("eval/loss", epoch_loss, epoch)
            writer.add_scalar("eval/perplexity", epoch_pp, epoch)
        return state, epoch_loss, epoch_pp

    def train(self, state, dataloaders, n_epochs=50, gen=None,
              save_every_epoch=True, mesh=None):
        """The epoch loop: each phase in turn; the model with the best
        val loss saved as ``<title>.best`` (``model.save``), and the train
        state as ``<title>.e<epoch>`` after each epoch. ``gen`` (default:
        seeded with 0 on the device) feeds every train step's dropout.
        ``mesh``: training over it (:meth:`run_epoch`); the state should
        be replicated on it (``parallel.replicate``) or placed
        (``parallel.place_train_state``), and only rank 0 prints and
        saves (every rank gathers a placed state for it)."""
        if gen is None:
            gen = torch.Generator(self.device).manual_seed(0)
        leads = _leads(mesh)
        placed = placed_mesh(state["params"]) is not None
        say = print if leads else (lambda *a, **k: None)
        best_epoch, best_val_loss = 0, float("inf")
        history = []
        for epoch in range(1, n_epochs + 1):
            t0 = time.time()
            say(f"Epoch {epoch:02d}/{n_epochs:02d}")
            epoch_metrics = {}
            for phase in self.phases:
                state, loss, pp = self.run_epoch(
                    state, dataloaders[phase], gen, phase, epoch, mesh)
                epoch_metrics[phase] = (loss, pp)
                say(f"  {phase:5s} loss: {loss:.5f}, perplexity: {pp:.3f}")
                if phase == "val" and loss < best_val_loss:
                    best_epoch, best_val_loss = epoch, loss
                    if leads or placed:
                        best = gather_tree(state["params"])
                    if leads:
                        self.model.save(best, os.path.join(
                            self.experiment_dir, f"{self.title}.best"))
            if save_every_epoch and (leads or placed):
                self.save_checkpoint(state, os.path.join(
                    self.experiment_dir, f"{self.title}.e{epoch}"))
            history.append(epoch_metrics)
            say(f"  epoch time: {time.time() - t0:.2f}s")
        say(f"Best val_loss: {best_val_loss} (epoch: {best_epoch})")
        return state, history

    # -- checkpoint / resume -------------------------------------------------
    def save_checkpoint(self, state, path):
        """Writes the train state as ``<path>.state.npz`` (+
        ``.state.json``, the model's hyperparameters), the JAX package's
        layout. A state placed on a mesh is gathered whole first, a
        collective that every rank must join; rank 0 writes it."""
        if placed_mesh(state["params"]) is not None:
            opt = state["opt_state"]
            state = dict(state, params=gather_tree(state["params"]),
                         opt_state=dict(opt, mu=gather_tree(opt["mu"]),
                                        nu=gather_tree(opt["nu"])))
            if dist.get_rank() != 0:
                return
        arrays = {f"params/{k}": v for k, v in flatten_tree(
            params_to_jax(state["params"])).items()}
        arrays["step"] = np.asarray(state["step"], np.int32)
        for i, leaf in enumerate(self._opt.to_leaves(state["opt_state"],
                                                     state["params"])):
            arrays[f"opt/{i}"] = leaf
        np.savez(f"{path}.state", **arrays)
        with open(f"{path}.state.json", "w") as f:
            json.dump({"model_type": self.model.model_type,
                       **self.model.hp()}, f)

    def restore_checkpoint(self, path):
        """Reads ``<path>.state.npz``, written by either package, onto this
        trainer's device: plain tensors, whatever layout saved them; place
        them with ``parallel.place_train_state`` or ``parallel.replicate``
        to resume on a mesh."""
        with np.load(f"{path}.state.npz") as z:
            flat = {k: z[k] for k in z.files}
        jax_params = unflatten_tree({k[len("params/"):]: v
                                     for k, v in flat.items()
                                     if k.startswith("params/")})
        n_opt = sum(1 for k in flat if k.startswith("opt/"))
        opt_state = self._opt.from_leaves(
            [flat[f"opt/{i}"] for i in range(n_opt)], jax_params, self.device)
        params = tree_map(lambda t: t.to(self.device),
                          params_from_jax(jax_params))
        return {"params": params, "opt_state": opt_state,
                "step": int(flat["step"])}

    def close(self):
        """Closes the metrics writers and frees the captured steps' graphs.
        A graph that holds NCCL collectives keeps its communicators in use:
        close the trainer (or drop it) before destroying its process
        groups, which otherwise wait for those graphs."""
        for w in self.writers.values():
            w.close()
        self._graphs.clear()
