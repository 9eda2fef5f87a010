"""Captured train and eval steps, and the captured ResNet trunk: the
Trainer's calls replayed as CUDA graphs.

Counterpart of the JAX package's ``Trainer._build_steps`` (``jax.jit`` of
the train step and of the eval step, one XLA program per static
configuration) and of ``build_trunk_cache``'s jitted trunk. Here one
static configuration of a call (a *key*, :func:`step_key`) is a
:class:`Captured`: a CUDA graph of the whole call (for a train step the
forward, the loss, ``autograd.grad``, the clip and the Adam update), its
static input buffers and its outputs, in a memory pool of its own.

The first call of a key runs the call eagerly on a side stream (every
cuBLAS handle, cuDNN plan and autograd set-up happens outside capture).
That call counts: a train step's first call is a real step, whose update
of the state stays, and its outputs are the call's. Then the call is
captured (``models/graphs.py`` ``capture``: thread-local, so the
trainer's prefetch thread may pin host memory meanwhile) and every later
call copies its inputs into the static buffers with ``copy_`` and
replays. Capture does not run the call, so no step is repeated or
skipped. A call's outputs are the graph's: the next replay overwrites
them, and a caller that keeps them copies them first (``run_epoch``'s
metrics ring).

What a graph reads or writes outside its inputs stays where it was when
it was captured, so the key holds it: the parameters, Adam's moments,
the trunk-feature cache and the buffer of the update's count terms (by
address, shape and dtype), the dropout generator (registered with the
graph, so a replay draws what the eager step draws from its state and
advances it as much), the model and its compute dtype, the batch's keys,
shapes and dtypes (a tail batch with ``row_valid`` has its own key) and
the TF32 flags. A host value that changes from step to step reaches the
graph through device memory: Adam's learning rate and bias corrections
are written into their buffer before each step (``Adam.write_terms``),
and the batch-norm statistics are written into the state's own tensors
in place, so the state keeps its addresses.

Over a mesh (NCCL groups only: a gloo collective cannot be captured) the
graph holds the step's all-reduces: the data axis's (the batch-norm
moments, the loss's denominators, the summed gradients) and a model
group's (the tensor-parallel partial sums and input gradients, the
clip's norm). A key's first call runs them once, eagerly, as every
replay does, so a rank that captures and a rank that replays run the
same collectives; the ranks make the same calls, so they make the same
keys. Every communicator exists before capture: the first call made it.

A capture or replay that fails raises: there is no fallback to the eager
call.
"""

import collections
import time

import torch

from deephumor_tpu_torch.models import graphs

__all__ = ["Captured", "StepGraphs", "step_key", "MAX_KEYS"]

# the keys a trainer keeps: train and eval, each for a full and a tail
# batch
MAX_KEYS = 4


def step_key(kind, model, batch, tensors, generator=None, groups=()):
    """The key of a call: ``kind`` ("train", "eval", "trunk"), the model
    (its hyperparameters and compute dtype), the batch's keys, shapes,
    dtypes and device, the address, shape and dtype of each tensor the
    graph reads or writes in place (``tensors``), the generator that its
    dropout draws from, the process groups that its collectives run over
    (a graph holds their communicators: a mesh's data axis, a model
    group) and the TF32 flags that cuBLAS and cuDNN read when it was
    captured."""
    return (kind, model,
            tuple((k, tuple(v.shape), v.dtype, str(v.device))
                  for k, v in sorted(batch.items())),
            tuple((t.data_ptr(), t.shape, t.dtype) for t in tensors),
            generator, tuple(groups), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


class Captured:
    """One key's graph, made at the key's first call: ``fn(inputs)`` (a
    dict of CUDA tensors) runs eagerly on a side stream, its outputs kept
    as ``first`` (the first call's), then it is captured."""

    def __init__(self, fn, inputs, generator=None):
        dev = next(iter(inputs.values())).device
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.first = fn(self.inputs)
        with graphs.CAPTURE_LOCK:
            self.graph, self.tally, self.out = graphs.capture(
                lambda: fn(self.inputs), torch.cuda.graph_pool_handle(),
                stream, () if generator is None else (generator,))
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.capture_s = time.perf_counter() - t0
        self.bytes = torch.cuda.memory_reserved(dev) - held
        self.replays = 0

    def __call__(self, inputs):
        """A later call: ``inputs`` into the static buffers, one replay;
        returns the graph's outputs (overwritten by the next replay)."""
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        graphs.replay(self.graph, self.tally)
        self.replays += 1
        return self.out


class StepGraphs:
    """A trainer's captured calls: the last ``MAX_KEYS`` keys, least
    recently used first out (an evicted key frees its pool)."""

    def __init__(self):
        self._keys = collections.OrderedDict()

    def run(self, key, fn, inputs, generator=None):
        """``fn(inputs)`` for ``key``: replayed when the key has its graph,
        else run eagerly on a side stream and captured."""
        entry = self._keys.get(key)
        if entry is not None:
            self._keys.move_to_end(key)
            return entry(inputs)
        entry = Captured(fn, inputs, generator)
        out, entry.first = entry.first, None
        self._keys[key] = entry
        while len(self._keys) > MAX_KEYS:
            self._keys.popitem(last=False)
        return out

    def info(self):
        """One dict per key, oldest first: its kind, replays, the seconds
        its first call took (the eager call, then the capture) and the
        device memory it holds (its static inputs and pool, bytes)."""
        return [{"kind": k[0], "replays": e.replays, "capture_s": e.capture_s,
                 "bytes": e.bytes} for k, e in self._keys.items()]

    def clear(self):
        """Drops every key's graph and frees its pool."""
        self._keys.clear()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
