"""Captured generation: the decode loop replayed as CUDA graphs.

Counterpart of the JAX package's compiled ``generate``
(deephumor_tpu/models/caption_models.py ``_compiled_generate``: an
``lru_cache`` over ``jax.jit``, one XLA program per static configuration,
each phase's steps inside a ``lax.while_loop`` whose condition is the
early exit; the temperature, the live-item count of compaction and the
straggler count of canonicalisation stay traced values). Here a call of
one static configuration (a *key*) is a :class:`Program`: the prefill
and the first draw, then the segments of
:class:`~deephumor_tpu_torch.models.sampling.BeamSearch` (a phase each,
unrolled; up to 8 steps for the LSTM) with the phase boundary after a
segment (char's early-EOS compaction and canonical-prefix set-up), then
the final pick. A call from images (``generate``) encodes them at the
start of the prefill, so the encoder (the ResNet-50 trunk and its head)
is part of the prefill's graph and such a call replays whole, as the JAX
package's compiled ``generate`` runs ``encode`` inside its program.

The first call of a key runs the whole program once eagerly on a side
stream (every kernel library build, cuBLAS handle and first-use attribute
happens outside capture), then captures the prefill, each segment, each
boundary and the final pick as graphs of their own, in order, into one
private memory pool; each graph reads the tensors the one before it left
(a boundary's gathers and its ``shared`` caches among them). Nothing of a
step or a boundary reads the device from the host: the temperature is a
0-d tensor among the inputs (1/T, which the steps multiply by and K3/K4
read through a pointer), and a boundary leaves its live and straggler
counts in device memory, where the kernels of the next phase read them
through a pointer (``dh::Count``). Every call copies its encoder output,
caption and 1/T into the key's static input buffers, draws its random
numbers into the key's noise buffers
(:func:`~deephumor_tpu_torch.models.sampling.draw_noise`, the same
generator calls as the eager loop) and replays the graphs in order,
reading ``ended.all()`` once before each segment and boundary (the
``while_loop``'s condition, per phase rather than per step); once every
branch has ended it skips the rest, as the eager loop does, and replays
the final pick. The buffers that the final pick reads (sequences,
scores, ended flags, the item order of compaction) are written in place,
so a skipped boundary leaves them right. After the last graph,
``Program.read_out`` reads what the host needs (the boundaries' counts)
once. The outputs returned are copies: the next replay overwrites the
buffers.

A graph bakes in what stays static, so the key holds it: the batch size
(from images, the image shape), the device, the sampler arguments, the
two kernel switches, the parameters' addresses and the model group
that the steps reduce over (``Program.group``). New parameters or a new
batch size make a new key; a new temperature does not. The last
``MAX_KEYS`` keys are kept (the batcher's bucket ladder makes one per
bucket), as long as they hold at most ``MAX_SHARE`` of the card's memory
together; an evicted key frees its pool.

Over a model group (tensor-parallel decoding, ``tp_generate``) each
layer-step all-reduces its row-parallel partial sums over the group
(models/transformer.py), so the graphs hold NCCL collectives, and every
rank of the group must replay, capture or run eagerly together: a rank
that captures (an eager call, then the replays: the collectives twice)
while its peers replay (once) hangs the group. A key is a hit on every
rank alike, as the ranks make the same calls and a key holds its
parameters (their addresses are not reused while it lives); and a key
with collectives is evicted by its count alone, among such keys only
(:func:`_admit`), never by the bytes that each rank measures for itself.
A gloo group's collectives cannot be captured: a call over one runs
eagerly, and ``compiled=True`` raises ``ValueError`` before any work
(:func:`use_graphs`).

A kernel wrapper notes its launch while a graph is captured into that
graph's tally (ops/_build.py ``note_launch``), and so does an all-reduce
(utils/collectives.py); each replay adds the tally to ``LAUNCHES`` and
to the all-reduce counts, so the counts of a captured call equal the eager
call's, but where every branch ends inside a phase: the eager loop
stops at once, a graph runs the rest of its phase (steps that change
nothing). A capture or replay that fails raises: there is no fallback
to the eager loop.
"""

import collections
import dataclasses
import threading
import time

import torch
import torch.distributed as dist

from deephumor_tpu_torch.models.sampling import draw_noise, run_eagerly
from deephumor_tpu_torch.ops import _build
from deephumor_tpu_torch.utils import collectives
from deephumor_tpu_torch.utils.pytree import flatten_tree, tree_map

__all__ = ["Program", "graph_key", "use_graphs", "generate", "run_eager",
           "run_captured", "capture", "replay", "cache_info", "clear",
           "MAX_KEYS", "MAX_SHARE", "CAPTURE_LOCK"]

# the keys kept, and the share of the card's memory that they may hold
# together (a word key at batch 1792 holds ~7 GiB: its KV caches)
MAX_KEYS, MAX_SHARE = 8, 0.5

_CACHE = collections.OrderedDict()
_CACHE_LOCK = threading.Lock()
# one capture at a time in a process (a server's batchers and a trainer's
# steps, experiments/step_graphs.py, share it)
CAPTURE_LOCK = threading.Lock()


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
        read_out: ``(outputs, boundaries) -> outputs``, run on the
            outputs after the last graph: the host reads of the call
            (``boundaries``: how many phase boundaries ran, None for an
            eager call, whose state lists only those).
        group: the process group that the steps all-reduce over (a
            model group), or None.
    """

    begin: object
    finish: object
    noise: dict
    device: torch.device
    read_out: object = lambda out, boundaries: out
    group: object = None


def use_graphs(compiled, device, groups=()):
    """Whether a call runs captured: on a CUDA device unless ``compiled``
    is False (None means captured there); on the CPU never, since no
    graphs exist there. ``groups``: the process groups that the call's
    collectives run over (None entries are skipped); a graph holds NCCL
    collectives only, so over any other group (gloo) the call runs
    eagerly, and ``compiled=True`` raises ``ValueError`` (call this before
    any work)."""
    other = sorted({dist.get_backend(g) for g in groups if g is not None}
                   - {"nccl"})
    if other:
        if compiled:
            raise ValueError(f"a call over a {other[0]} group runs eagerly "
                             f"(its collectives cannot be captured): pass "
                             f"compiled=None or False")
        return False
    return torch.device(device).type == "cuda" and compiled is not False


def graph_key(model, params, inputs, **static):
    """The key of a call: the model's hyperparameters, the static
    arguments (not the temperature: 1/T is an input; a model group, whose
    communicator a graph holds, is one), the inputs' shapes and dtypes
    (the batch size), their device, the parameters' addresses (a graph
    holds them) and the matmul precision flag that cuBLAS read when it
    was captured."""
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
    return program.read_out(
        program.finish(run_eagerly(program.begin(inputs, noise))), None)


def run_captured(search, segment, boundary):
    """Runs a started search in the order of a captured call: each
    segment, then its boundary, with ``ended.all()`` read once before each
    (a boundary leaves every branch as it was, so the segment after it
    needs no read of its own); once every branch has ended, the rest is
    skipped, as the eager loop skips it. ``segment(i)`` and
    ``boundary(i)`` run segment i and its boundary: a graph's replay on
    the card, the captured body itself in the CPU tests. Returns how many
    boundaries ran."""
    ran, live = 0, False
    for i in range(len(search.segments)):
        if not live and search.all_ended():
            break
        segment(i)
        live = False
        if search.has_boundary(i):
            if search.all_ended():
                break
            boundary(i)
            ran, live = ran + 1, True
    return ran


def capture(fn, pool, stream, generators=()):
    """Captures ``fn()`` into a new graph in ``pool`` on ``stream``; returns
    ``(graph, tally, fn's result)``, the tally holding the kernel launches
    and the all-reduces noted while it was captured
    (``_build.capture_tally``, ``collectives.capture_tally``). Each of
    ``generators`` (a ``torch.Generator`` that ``fn`` draws from) is
    registered with the graph, so that every replay draws what an eager
    call would draw from its state then, and advances it as much. The
    capture is thread-local: another thread may make calls that a global
    capture forbids meanwhile (a trainer's prefetch thread pins host
    memory). The caller holds ``CAPTURE_LOCK``."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with _build.capture_tally() as launches, \
            collectives.capture_tally() as reduces, torch.cuda.graph(
                graph, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
        out = fn()
    return graph, (launches, reduces), out


def replay(graph, tally):
    """Replays a graph of :func:`capture` and adds its tally to the
    counts."""
    graph.replay()
    _build.add_launches(tally[0])
    collectives.add(tally[1])


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
        self.collective = program.group is not None
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

        def add(fn):
            graph, tally, _ = capture(fn, pool, stream)
            self.graphs.append((graph, tally))

        add(lambda: made.update(
            search=program.begin(self.inputs, self.noise)))
        self.search = search = made["search"]
        # (segment graph, boundary graph or None) per segment
        self.steps = []
        for i in range(len(search.segments)):
            add(lambda i=i: search.run_segment(i, eager=False))
            step = [len(self.graphs) - 1, None]
            if search.has_boundary(i):
                add(lambda i=i: search.run_boundary(i, eager=False))
                step[1] = len(self.graphs) - 1
            self.steps.append(tuple(step))
        add(lambda: made.update(out=program.finish(search)))
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
            boundaries = run_captured(
                self.search, lambda i: self._replay(self.steps[i][0]),
                lambda i: self._replay(self.steps[i][1]))
            self._replay(len(self.graphs) - 1)
            self.replays += 1
            return self.program.read_out(_clone(self.out), boundaries)

    def _replay(self, i):
        replay(*self.graphs[i])


def generate(make_program, inputs, gen, *, key, compiled=None):
    """Runs a generation call: captured (the graphs of ``key()``, made at
    its first call) when :func:`use_graphs` says so, else eagerly.
    ``make_program()`` builds the call's :class:`Program`."""
    program = make_program()
    if not use_graphs(compiled, program.device, (program.group,)):
        return run_eager(program, inputs, gen)
    key = key()
    with _CACHE_LOCK:
        entry = _CACHE.get(key)
        if entry is not None:
            _CACHE.move_to_end(key)
    if entry is not None:
        return entry(inputs, gen)
    with CAPTURE_LOCK:
        with _CACHE_LOCK:
            entry = _CACHE.get(key)
        if entry is not None:
            return entry(inputs, gen)
        entry = _Graphs(program, inputs, gen)
        if _admit(key, entry, MAX_SHARE * torch.cuda.get_device_properties(
                program.device).total_memory):
            torch.cuda.empty_cache()
        return entry()


def _admit(key, entry, budget):
    """Adds ``entry`` (``.bytes``, ``.collective``) under ``key`` and evicts,
    oldest first: keys without collectives while the cache holds more
    than ``MAX_KEYS`` keys or more than ``budget`` bytes, and never the
    new key; keys with collectives while there are more than ``MAX_KEYS``
    of them, whatever their bytes (each rank measures those itself, and
    the ranks of a group must keep and drop such a key together). Returns
    whether a key was evicted."""
    with _CACHE_LOCK:
        _CACHE[key] = entry
        held = [k for k, e in _CACHE.items() if e.collective]
        drop = held[:max(0, len(held) - MAX_KEYS)]
        others = [k for k, e in _CACHE.items()
                  if not e.collective and k != key]
        size = sum(e.bytes for k, e in _CACHE.items() if k not in drop)
        n = len(_CACHE) - len(drop)
        for k in others:
            if n <= MAX_KEYS and size <= budget:
                break
            drop.append(k)
            size -= _CACHE[k].bytes
            n -= 1
        for k in drop:
            del _CACHE[k]
    return bool(drop)


def cache_info():
    """One dict per cached key, oldest first: its graphs, the segments and
    boundaries they hold, whether any part of a call runs eagerly after
    them (``eager_tail``: never since every boundary is captured), whether
    they hold collectives, its replays, the seconds its first call took to
    warm up and capture, and the device memory it holds (its static
    buffers and pool, bytes)."""
    with _CACHE_LOCK:
        return [{"graphs": len(e.graphs), "captured_segments": len(e.steps),
                 "captured_boundaries": sum(b is not None
                                            for _, b in e.steps),
                 "eager_tail": len(e.steps) < len(e.search.segments),
                 "collective": e.collective, "replays": e.replays,
                 "capture_s": e.capture_s, "bytes": e.bytes}
                for e in _CACHE.values()]


def clear():
    """Drops every key's graphs and frees their pools."""
    with _CACHE_LOCK:
        _CACHE.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
