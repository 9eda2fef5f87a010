"""Captured generation: the decode loop replayed as CUDA graphs.

Counterpart of the JAX package's compiled ``generate``
(deephumor_tpu/models/caption_models.py ``_compiled_generate``: an
``lru_cache`` over ``jax.jit``, one XLA program per static configuration,
each phase's steps inside a ``lax.while_loop`` whose condition is the
early exit). Here a call of one static configuration (a *key*) is a
:class:`Program`: the prefill and the first draw, then the segments of
:class:`~deephumor_tpu_torch.models.sampling.BeamSearch` (a phase each,
unrolled; up to 8 steps for the LSTM), then the final pick.

The first call of a key runs the whole program once eagerly on a side
stream (every kernel library build, cuBLAS handle and first-use attribute
happens outside capture), then captures the prefill and each segment that
no phase boundary precedes as a graph of its own, in order, into one
private memory pool; each graph reads the tensors the one before it left.
When no boundary runs, the final pick is captured too. Every call then
copies its encoder output (and caption) into the key's static input
buffers, draws its random numbers into the key's noise buffers
(:func:`~deephumor_tpu_torch.models.sampling.draw_noise`, the same
generator calls as the eager loop) and replays the graphs in order,
reading ``ended.all()`` once between graphs (the ``while_loop``'s
condition, per phase rather than per step). What follows the first
boundary (char's later phases: the boundaries set the host ints ``live``
and ``n_strag``) runs eagerly from the state the last graph left. The
outputs returned are copies: the next replay overwrites the buffers.

A graph bakes in what JAX keeps dynamic, so the key holds it: the batch
size, the device, the temperature (K3/K4 take 1/T by value), the two
kernel switches and the parameters' addresses. New parameters, a new
batch size or a new temperature make a new key. The last ``MAX_KEYS``
keys are kept (the batcher's bucket ladder makes one per bucket), as
long as they hold at most ``MAX_SHARE`` of the card's memory together; an
evicted key frees its pool.

A kernel wrapper notes its launch while a graph is captured into that
graph's tally (ops/_build.py ``note_launch``); each replay adds the
tally to ``LAUNCHES``, so the counts of a captured call equal the eager
call's, but where every branch ends inside a phase: the eager loop
stops at once, a graph runs the rest of its phase (steps that change
nothing). A capture or replay that fails raises: there is no fallback
to the eager loop.
"""

import collections
import copy
import dataclasses
import threading
import time

import torch

from deephumor_tpu_torch.models.sampling import draw_noise, run_eagerly
from deephumor_tpu_torch.ops import _build
from deephumor_tpu_torch.utils.pytree import flatten_tree, tree_map

__all__ = ["Program", "graph_key", "use_graphs", "generate", "run_eager",
           "cache_info", "clear", "MAX_KEYS", "MAX_SHARE"]

# the keys kept, and the share of the card's memory that they may hold
# together (a word key at batch 1792 holds ~7 GiB: its KV caches)
MAX_KEYS, MAX_SHARE = 8, 0.5

_CACHE = collections.OrderedDict()
_CACHE_LOCK = threading.Lock()
# one capture at a time in a process (a server's batchers share it)
_CAPTURE_LOCK = threading.Lock()


@dataclasses.dataclass
class Program:
    """One generation call of a static configuration.

    Attributes:
        begin: ``(inputs, noise) -> BeamSearch``: the prefill and the first
            draw from ``inputs`` (a dict of tensors, or None) and the
            call's draws; returns the started search.
        finish: ``search -> dict``: the final pick and the outputs.
        noise: name -> shape of the call's up-front draws
            (``sampling.noise_shapes``).
        device: where the call runs.
    """

    begin: object
    finish: object
    noise: dict
    device: torch.device


def use_graphs(compiled, device):
    """Whether a call runs captured: on a CUDA device unless ``compiled``
    is False (None means captured there); on the CPU never, since no
    graphs exist there."""
    return torch.device(device).type == "cuda" and compiled is not False


def graph_key(model, params, inputs, **static):
    """The key of a call: the model's hyperparameters, the static
    arguments, the inputs' shapes and dtypes (the batch size), their
    device, the parameters' addresses (a graph holds them) and the
    matmul precision flag that cuBLAS read when it was captured."""
    leaves = [t for t in flatten_tree(params).values()
              if isinstance(t, torch.Tensor)]
    shapes = tuple((k, tuple(t.shape), t.dtype, str(t.device))
                   for k, t in sorted(flatten_tree(inputs).items())
                   if isinstance(t, torch.Tensor))
    return (model, tuple(sorted(static.items())), shapes,
            tuple(t.data_ptr() for t in leaves),
            torch.backends.cuda.matmul.allow_tf32)


def run_eager(program, inputs, gen, noise=None):
    """The program one step at a time from the host (the CPU's path, and
    the card's with ``compiled=False``), drawing from ``gen`` unless the
    draws are given."""
    if noise is None:
        noise = draw_noise(gen, program.noise, program.device)
    return program.finish(run_eagerly(program.begin(inputs, noise)))


def _tensors(tree):
    return [t for _, t in sorted(flatten_tree(tree).items())
            if isinstance(t, torch.Tensor)]


def _clone(tree):
    return tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


class _Graphs:
    """One key's graphs, static buffers and memory pool."""

    def __init__(self, program, inputs, gen):
        dev = program.device
        self.program, self.lock = program, threading.Lock()
        self.replays = 0
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        self.inputs = _clone(inputs)
        self.noise = draw_noise(gen, program.noise, dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            run_eager(program, self.inputs, None, self.noise)
        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        made = {}

        def capture(fn):
            graph = torch.cuda.CUDAGraph()
            with _build.capture_tally() as tally, torch.cuda.graph(
                    graph, pool=pool, stream=stream,
                    capture_error_mode="thread_local"):
                fn()
            self.graphs.append((graph, tally))

        capture(lambda: made.update(
            search=program.begin(self.inputs, self.noise)))
        self.search = search = made["search"]
        self.segments = search.captured_segments
        for i in range(self.segments):
            capture(lambda i=i: search.run_segment(i, eager=False))
        self.out = None
        if self.segments == len(search.segments):
            capture(lambda: made.update(out=program.finish(search)))
            self.out = made["out"]
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.capture_s = time.perf_counter() - t0
        self.bytes = torch.cuda.memory_reserved(dev) - held

    def __call__(self, inputs=None, gen=None):
        """One call: the inputs and this call's draws into the static
        buffers (None: they are there already), then the replays."""
        with self.lock:
            if inputs is not None:
                for dst, src in zip(_tensors(self.inputs), _tensors(inputs)):
                    dst.copy_(src)
                draw_noise(gen, self.program.noise, self.program.device,
                           out=self.noise)
            self._replay(0)
            for i in range(self.segments):
                if self.search.all_ended():
                    break
                self._replay(i + 1)
            if self.out is not None:
                self._replay(len(self.graphs) - 1)
                out = self.out
            else:
                # the phases after the first boundary, from the state the
                # last graph left
                tail = copy.copy(self.search)
                out = self.program.finish(run_eagerly(tail, self.segments))
            self.replays += 1
            return _clone(out)

    def _replay(self, i):
        graph, tally = self.graphs[i]
        graph.replay()
        _build.add_launches(tally)


def generate(make_program, inputs, gen, *, key, compiled=None):
    """Runs a generation call: captured (the graphs of ``key()``, made at
    its first call) when :func:`use_graphs` says so, else eagerly.
    ``make_program()`` builds the call's :class:`Program`."""
    program = make_program()
    if not use_graphs(compiled, program.device):
        return run_eager(program, inputs, gen)
    key = key()
    with _CACHE_LOCK:
        entry = _CACHE.get(key)
        if entry is not None:
            _CACHE.move_to_end(key)
    if entry is not None:
        return entry(inputs, gen)
    with _CAPTURE_LOCK:
        with _CACHE_LOCK:
            entry = _CACHE.get(key)
        if entry is not None:
            return entry(inputs, gen)
        entry = _Graphs(program, inputs, gen)
        budget = MAX_SHARE * torch.cuda.get_device_properties(
            program.device).total_memory
        with _CACHE_LOCK:
            _CACHE[key] = entry
            evicted = []
            while len(_CACHE) > 1 and (
                    len(_CACHE) > MAX_KEYS
                    or sum(e.bytes for e in _CACHE.values()) > budget):
                evicted.append(_CACHE.popitem(last=False))
        if evicted:
            del evicted
            torch.cuda.empty_cache()
        return entry()


def cache_info():
    """One dict per cached key, oldest first: its graphs, replays, the
    seconds its first call took to warm up and capture, and the device
    memory it holds (its static buffers and pool, bytes)."""
    with _CACHE_LOCK:
        return [{"graphs": len(e.graphs), "captured_segments": e.segments,
                 "eager_tail": e.out is None, "replays": e.replays,
                 "capture_s": e.capture_s, "bytes": e.bytes}
                for e in _CACHE.values()]


def clear():
    """Drops every key's graphs and frees their pools."""
    with _CACHE_LOCK:
        _CACHE.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
