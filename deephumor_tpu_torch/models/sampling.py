"""Batched beam-search generation engine.

Counterpart of deephumor_tpu/models/sampling.py with the same semantics:
top-k filtering that keeps ties and masks UNK, temperature softmax +
sampling without replacement (Gumbel-top-k) for both the per-branch
candidate draw and the survivor draw, per-step scores = log_softmax over
the k drawn values, ended branches continue with one pad/score-0
candidate, and a deterministic ``greedy`` mode (argmax everywhere).

The token loop runs one decoder step per position, split into
``phases`` whose step functions read a growing cache prefix (or one
``step_fn`` over every step, as the LSTM runs). Every random number of a
call is drawn up front from the caller's ``torch.Generator`` (on the
device of the logits): the K3/K4 seeds, the uniforms of the per-branch
and survivor draws and of the final pick (:func:`draw_noise`). 1/T is a
0-d f32 tensor on that device (:func:`inv_temperature`), and the live row
count that a phase boundary sets is a 0-d int32 tensor. A step then
reads no host value and touches no generator, so a caller may capture
whole segments of steps, and the boundaries between them, as CUDA graphs
(models/graphs.py) and replay them with new draws at any temperature.
Eagerly the loop stops once every branch has ended (one ``ended.all()``
read per step); captured, the caller reads it between segments, and a
step that runs after every branch has ended keeps every branch in place
and appends a pad at score 0, so both give the same result. A model may
run a boundary function after a phase (early-EOS compaction,
canonical-prefix setup) that permutes the items; ``finalize_fn`` puts
the outputs back in the caller's order.
"""

import threading

import numpy as np

import torch

from deephumor_tpu_torch import EOS, PAD, UNK
from deephumor_tpu_torch.ops import attention, moe
from deephumor_tpu_torch.ops.sampler import (
    fused_classifier_topk_gumbel_sample, fused_topk_gumbel_sample)
from deephumor_tpu_torch.utils import profiling
from deephumor_tpu_torch.utils.pytree import tree_map

__all__ = ["filter_top_k", "gumbel_top_k", "beam_search", "BeamSearch",
           "noise_shapes", "draw_noise", "inv_temperature", "host_read",
           "fold_rows_tally", "fold_moe_tally", "run_eagerly"]

NEG_INF = float("-inf")
# above this vocabulary the classifier runs as a separate bf16 product
# before K3; at or below it K4 computes it inside the sampler kernel
FUSED_CLASSIFIER_MAX_V = 16384


def _top_k(x, k):
    """The k largest values and their indices along the last axis; ties go
    to the lower index (as ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def filter_top_k(logits, top_k, unk_index=UNK):
    """Keeps logits >= the k-th largest (ties kept), masks UNK."""
    kth = _top_k(logits, top_k)[0][..., -1:]
    filtered = logits.masked_fill(logits < kth, NEG_INF)
    filtered[..., unk_index] = NEG_INF
    return filtered


def gumbel_top_k(u, log_weights, k):
    """Samples k indices without replacement ~ softmax(log_weights), from
    uniforms ``u`` of ``log_weights``' shape (drawn up front:
    :func:`draw_noise`); -inf weights are never selected (given k <=
    #finite entries)."""
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    perturbed = torch.where(torch.isfinite(log_weights),
                            log_weights + gumbel, NEG_INF)
    return _top_k(perturbed, k)[1]


def _select_k(u, log_weights, k, greedy):
    if greedy:
        return _top_k(log_weights, k)[1]
    return gumbel_top_k(u, log_weights, k)


def _log_softmax_scores(vals):
    return vals - torch.logsumexp(vals, dim=-1, keepdim=True)


def _topk_space_draw(u, logits, top_k, k, inv_t, greedy, unk_index,
                     sampler="exact", classifier=None, seed=None,
                     live_rows=None):
    """One vocab-wide top-k selection, then the k-token draw in the
    reduced space. Returns (token ids ``[..., k]``, scores ``[..., k]``).

    ``sampler="pallas"`` (stochastic only) runs the sampler kernels with
    ``seed`` (an int or a one-element int32 tensor) and ``inv_t`` (a float
    or a 0-d f32 tensor), which skip rows at or past ``live_rows`` (an int
    or a 0-d int32 tensor). With ``classifier``, ``logits`` is the
    pre-classifier hidden state: up to ``FUSED_CLASSIFIER_MAX_V`` the K4
    kernel (ops.fused_classifier_topk_gumbel_sample) computes the
    classifier inside the draw; above it the classifier is a plain bf16
    matmul before K3 (ops.fused_topk_gumbel_sample). ``"exact"`` (and
    greedy) sorts the f32 logits; its stochastic draw reads the uniforms
    ``u`` ``[..., top_k]``."""
    if sampler == "pallas" and not greedy:
        if classifier is not None and (
                classifier[0].shape[0] <= FUSED_CLASSIFIER_MAX_V):
            w, b = classifier
            tokens, vals = fused_classifier_topk_gumbel_sample(
                logits, w, b, seed, inv_t, top_k=top_k, num_draws=k,
                unk_index=unk_index, live_rows=live_rows)
            return tokens, _log_softmax_scores(vals)
        if classifier is not None:
            bf = torch.bfloat16
            w, b = classifier
            logits = torch.nn.functional.linear(logits.to(bf), w.to(bf),
                                                b.to(bf))
        tokens, vals = fused_topk_gumbel_sample(
            logits, seed, inv_t, top_k=top_k, num_draws=k,
            unk_index=unk_index, live_rows=live_rows)
        return tokens, _log_softmax_scores(vals)

    vals, idx = _top_k(logits.float(), top_k)
    vals = vals.masked_fill(idx == unk_index, NEG_INF)
    pick = _select_k(u, vals * inv_t, k, greedy)
    picked = vals.gather(-1, pick)
    # exhausted support (fewer kept candidates than draws): such draws
    # fall back to the best candidate; a fully filtered row emits token 0
    # at score 0
    best = vals.argmax(dim=-1, keepdim=True).expand_as(pick)
    pick = torch.where(picked == NEG_INF, best, pick)
    picked = vals.gather(-1, pick)
    tokens = idx.gather(-1, pick)
    row_dead = picked == NEG_INF
    tokens = tokens.masked_fill(row_dead, 0)
    picked = picked.masked_fill(row_dead, 0.0)
    return tokens, _log_softmax_scores(picked)


def _gather_rows(state, flat_branch, branch):
    """The default survivor reorder: every state tensor's rows follow
    their surviving branch."""
    return tree_map(lambda t: t[flat_branch], state)


def noise_shapes(*, steps, num_items, beam_size, top_k, sampler, greedy):
    """Name -> shape of a call's up-front draws (:func:`draw_noise`):

    - ``seeds`` ``[steps]`` int32 (``sampler="pallas"``): the K3/K4 seed of
      each step, read by the kernel from device memory;
    - ``cand`` ``[steps, num_items * beam, top_k]`` (``"exact"``): the
      uniforms of each step's per-branch draw (the first draw reads the
      first ``num_items`` rows);
    - ``surv`` ``[steps - 1, num_items, beam * beam]``: the survivor draw of
      step s (1 <= s < steps) reads row s - 1;
    - ``final`` ``[num_items, beam]``: the final pick.

    A greedy call draws nothing."""
    if greedy:
        return {}
    shapes = {"seeds": (steps,)} if sampler == "pallas" else {
        "cand": (steps, num_items * beam_size, top_k)}
    shapes["surv"] = (max(steps - 1, 0), num_items, beam_size * beam_size)
    shapes["final"] = (num_items, beam_size)
    return shapes


def inv_temperature(temperature, device):
    """1/T as a generation call holds it: a 0-d f32 tensor on ``device``
    with the f32 value of ``1.0 / temperature``, which the steps multiply
    by and K3/K4 read through a pointer (a captured call's buffer is
    written on every call, so one graph serves every temperature). Made by
    a fill, not a copy from the host, so it waits for nothing."""
    return torch.full((), float(np.float32(1.0 / temperature)),
                      dtype=torch.float32, device=device)


def host_read(t):
    """``t``'s values on the host. Every read of the device that a
    generation call makes on purpose goes through here: ``ended.all()``
    between steps (eager) or graphs (captured), and the phase boundaries'
    counts once after the last graph (the transformers' ``boundaries``).
    Each read is the span ``host_read`` (utils/profiling.py). While a
    profiler records, a read of a CUDA tensor then folds the attention
    kernels' row tally into the counters (:func:`fold_rows_tally`), and
    the expert layers' tally (:func:`fold_moe_tally`)."""
    with profiling.span("host_read"):
        values = t.tolist()
    if t.is_cuda:
        fold_rows_tally(t.device)
        fold_moe_tally(t.device)
    return values


# (counters, device) -> (profiled window, *totals) at the last fold
_FOLDED = {}
_FOLD_LOCK = threading.Lock()


def _fold(device, names, read):
    """Adds to the counters ``names`` what a device tally (``read(device)``:
    its totals read from the device, or None) grew by since the last fold,
    while a profiler records; the first fold of a profiled window only
    notes where the tally stands."""
    window = profiling.window()
    if window is None:
        return
    totals = read(device)
    if totals is None:
        return
    with _FOLD_LOCK:
        last = _FOLDED.get((names, device))
        _FOLDED[(names, device)] = (window, *totals)
    if last is not None and last[0] == window:
        for name, now, before in zip(names, totals, last[1:]):
            profiling.count(name, now - before)


def fold_rows_tally(device):
    """While a profiler records, adds what K1, K6, K7 and K12 added to the
    row tally of ``device`` (ops/attention.py ``rows_tally``) since the last
    fold to the counters ``attn.rows_read`` and ``attn.rows_span``
    (utils/profiling.py ``count``): a device read, made only then. The
    first fold of a profiled window only notes where the tally stands, so
    the counters hold the window's launches from its first host read
    on."""
    _fold(device, ("attn.rows_read", "attn.rows_span"),
          attention.rows_tally_totals)


def fold_moe_tally(device):
    """As :func:`fold_rows_tally`, the expert layers' tally of ``device``
    (ops/moe.py ``moe_tally``: pairs routed, pairs of held experts, the
    most pairs of one held expert in a layer-step) into the counters
    ``moe.pairs``, ``moe.pairs_held`` and ``moe.held_load_max``; nothing is
    read where no expert layer has run."""
    _fold(device, ("moe.pairs", "moe.pairs_held", "moe.held_load_max"),
          moe.moe_tally_totals)


def draw_noise(gen, shapes, device, out=None):
    """Draws every random number of a call up front from ``gen``, one
    generator call per entry of ``shapes`` (:func:`noise_shapes`), into
    ``out``'s tensors when given (a captured call's static buffers) or new
    ones. The same generator state gives the same draws either way, and
    nothing of a step touches a generator: a captured step replays with
    the draws in these buffers."""
    if out is None:
        out = {name: torch.empty(shape, device=device, dtype=(
                   torch.int32 if name == "seeds" else torch.float32))
               for name, shape in shapes.items()}
    for name in shapes:
        if name == "seeds":
            # in [0, 2**31 - 1): the kernels' seed range, kept here
            out[name].random_(0, 2 ** 31 - 1, generator=gen)
        else:
            out[name].uniform_(generator=gen)
    return out


class BeamSearch:
    """One call of batched stochastic or greedy beam search, in the parts
    that a caller runs eagerly or captures as CUDA graphs
    (models/graphs.py):

    - :meth:`start`: the first draw, and ``seq``, ``val`` and ``ended``:
      buffers that every step writes in place, so that each captured step
      and each later graph reads them where the one before left them;
    - :meth:`run_segment`: the steps of one segment (a phase, or up to
      ``segment_steps`` of it), each with no host read: no ``.item()``, no
      shape or allocation size that depends on data. Eagerly it checks
      before each step that a branch is still live (one ``ended.all()``
      read); captured, the caller checks between segments, and a step
      that runs after every branch has ended changes nothing;
    - :meth:`run_boundary`: the phase boundary after a segment (early-EOS
      compaction, canonical-prefix set-up), with no host read either: its
      counts stay in device memory, where the next phase's kernels read
      them;
    - :meth:`finish`: the final pick and ``finalize_fn``.

    Every random number comes from ``noise`` (:func:`draw_noise`), read by
    step: the two paths draw alike.

    Args:
        inv_t: 1/T, a 0-d f32 tensor on the device of the logits
            (:func:`inv_temperature`; a captured call's static buffer).
        step_fn: ``(state, tokens [B*beam]) -> (logits or hidden,
            state)``, run for every step when ``phases`` is not given.
        phases: optional ``[(last_step, step_fn), ...]``: each step_fn runs
            the steps up to its ``last_step`` (the final entry covers the
            rest).
        segment_steps: optional cap on the steps of a segment (a phase is
            cut into segments of at most this many steps).
        shuffle_fn: optional ``(state, flat_branch [B*beam], branch
            [B, beam]) -> state`` that reorders the decoder state to the
            surviving branches; by default every state tensor's rows are
            gathered by ``flat_branch``.
        classifier: optional ``(weight [V, D], bias [V])``; when given the
            step functions return hidden states and the draw classifies.
        live_fn: optional ``state -> live rows``: an int, or a 0-d int32
            tensor that a boundary set (live items lead); the draw skips
            the other rows.
        compactors: optional list, one entry per phase but the last:
            ``None`` or ``(state, seq, val, ended) -> (state, seq, val,
            ended)``, run after that phase's steps (it may permute items).
        finalize_fn: optional ``(state, out) -> out`` run on the outputs.
        survivor_update_fn: optional replacement of the whole update after
            the survivor draw, ``shuffle_fn`` included: ``(state, new_idx,
            new_val, surv, ended, val, seq, pos) -> (state, seq, val,
            ended, chosen)`` with the draw's raw (unmasked) candidates
            ``[B, beam, beam]``. It must reproduce the default update
            (ops.fused_survivor_update does); given, ``shuffle_fn`` is not
            called.
        max_len: total output length including any prefix.
    """

    def __init__(self, *, beam_size, top_k, inv_t, max_len,
                 step_fn=None, phases=None, segment_steps=None,
                 shuffle_fn=None, prefix_len=0, greedy=False,
                 sampler="exact", classifier=None, live_fn=None,
                 compactors=None, finalize_fn=None, survivor_update_fn=None,
                 eos_index=EOS, unk_index=UNK, pad_index=PAD):
        if beam_size > top_k:
            raise ValueError(f"beam_size ({beam_size}) must be <= top_k "
                             f"({top_k})")
        self.beam, self.top_k, self.inv_t = beam_size, top_k, inv_t
        self.max_len, self.prefix_len = max_len, prefix_len
        self.steps = steps = max_len - prefix_len
        self.greedy, self.sampler, self.classifier = greedy, sampler, classifier
        self.live_fn, self.finalize_fn = live_fn, finalize_fn
        self.shuffle_fn = shuffle_fn or _gather_rows
        self.survivor_update_fn = survivor_update_fn
        self.eos, self.unk, self.pad = eos_index, unk_index, pad_index
        if phases is None:
            phases = [(steps - 1, step_fn)]
        bounds = [(min(b, steps - 1), f) for b, f in phases[:-1]]
        bounds.append((steps - 1, phases[-1][1]))
        compactors = list(compactors or []) + [None] * len(bounds)
        # (first step, last step, step_fn, boundary after it)
        self.segments = []
        first = 1
        for (last, fn), boundary in zip(bounds, compactors):
            if last < first:
                continue
            cut = segment_steps or last - first + 1
            for a in range(first, last + 1, cut):
                b = min(a + cut - 1, last)
                self.segments.append(
                    [a, b, fn, boundary if b == last else None])
            first = last + 1

    def _draw(self, logits, s, classifier=None, live_rows=None):
        noise = self.noise
        u = seed = None
        if "cand" in noise:
            u = noise["cand"][s, :logits.shape[0]]
        if "seeds" in noise:
            seed = noise["seeds"][s:s + 1]
        return _topk_space_draw(u, logits, self.top_k, self.beam, self.inv_t,
                                self.greedy, self.unk, self.sampler,
                                classifier, seed, live_rows)

    def start(self, noise, state, init_logits, prefix=None):
        """The first draw from ``init_logits [B, V]``, and the buffers.
        ``state``: the decoder state after prefill, ``B * beam`` rows;
        ``prefix``: optional ``[B, prefix_len]`` fixed first tokens."""
        self.noise, self.state = noise, state
        n, beam, dev = init_logits.shape[0], self.beam, init_logits.device
        self.n = n
        first_idx, self.val = self._draw(init_logits, 0)
        self.seq = torch.full((n, beam, self.max_len), self.pad,
                              dtype=torch.int64, device=dev)
        if prefix is not None and self.prefix_len > 0:
            self.seq[:, :, :self.prefix_len] = prefix[:, None, :]
        self.seq[:, :, self.prefix_len] = first_idx
        self.ended = first_idx == self.eos
        self.col = torch.arange(beam, device=dev)
        self.items = torch.arange(n, device=dev)[:, None]
        # the survivor picks that keep every branch in place
        self.keep = (self.col * beam)[None, :].expand(n, beam)
        return self

    def all_ended(self):
        """True once every branch has ended (reads the device)."""
        return host_read(self.ended.all())

    def run_segment(self, i, eager=True):
        first, last, step_fn, _ = self.segments[i]
        for s in range(first, last + 1):
            if eager and self.all_ended():
                return
            self._step(s, step_fn)

    def has_boundary(self, i):
        """Whether a phase boundary follows segment ``i``."""
        return self.segments[i][3] is not None

    def run_boundary(self, i, eager=True):
        """Segment ``i``'s boundary, if any; eagerly not once every branch
        has ended (it would only permute rows that ``finalize_fn`` puts
        back: a captured call skips its graph from the host then)."""
        boundary = self.segments[i][3]
        if boundary is not None and not (eager and self.all_ended()):
            self.state, seq, val, ended = boundary(
                self.state, self.seq, self.val, self.ended)
            self._keep(seq, val, ended)

    def _keep(self, seq, val, ended):
        """Writes new values of the three buffers into them."""
        for buf, new in ((self.seq, seq), (self.val, val),
                         (self.ended, ended)):
            if new is not buf:
                buf.copy_(new)

    def _step(self, s, step_fn):
        n, beam, pos = self.n, self.beam, self.prefix_len + s
        seq, val, ended = self.seq, self.val, self.ended
        out, state = step_fn(self.state, seq[:, :, pos - 1].reshape(-1))
        new_idx, new_val = self._draw(
            out, s, self.classifier,
            None if self.live_fn is None else self.live_fn(state))
        new_idx = new_idx.reshape(n, beam, beam)
        new_val = new_val.reshape(n, beam, beam)
        e3 = ended[..., None]
        valid = ~e3 | (self.col == 0)
        cand_val = val[..., None] + new_val.masked_fill(e3, 0.0)
        weight = torch.where(valid, cand_val * self.inv_t, NEG_INF)
        surv = _select_k(None if self.greedy else self.noise["surv"][s - 1],
                         weight.reshape(n, -1), beam, self.greedy)
        # once every branch has ended (a graph runs its segment to the
        # end), the step keeps each branch where it is: it appends pads
        # at score 0 and changes nothing
        surv = torch.where(ended.all(), self.keep, surv)
        if self.survivor_update_fn is not None:
            state, seq, val, ended, _ = self.survivor_update_fn(
                state, new_idx, new_val, surv, ended, val, seq, pos)
        else:
            branch = surv // beam
            chosen = new_idx.masked_fill(e3, self.pad).reshape(
                n, -1).gather(1, surv)
            val = cand_val.reshape(n, -1).gather(1, surv)
            seq = seq[self.items, branch]
            ended = ended.gather(1, branch)
            seq[:, :, pos] = chosen
            ended = ended | (chosen == self.eos)
            state = self.shuffle_fn(
                state, (self.items * beam + branch).reshape(-1), branch)
        self.state = state
        self._keep(seq, val, ended)

    def finish(self):
        """The final pick; returns ``sequences [B, beam, max_len]``,
        ``scores [B, beam]``, ``chosen [B, max_len]`` and ``ended [B,
        beam]``."""
        final = _select_k(self.noise.get("final"), self.val * self.inv_t, 1,
                          self.greedy)[:, 0]
        out = {"sequences": self.seq, "scores": self.val,
               "chosen": self.seq[self.items[:, 0], final],
               "ended": self.ended}
        return (out if self.finalize_fn is None
                else self.finalize_fn(self.state, out))


def run_eagerly(search):
    """Runs the segments of a started search, each with its boundary, one
    step at a time from the host; returns the search."""
    for i in range(len(search.segments)):
        search.run_segment(i)
        search.run_boundary(i)
    return search


def beam_search(gen, state, init_logits, *, temperature=1.0, prefix=None,
                **kwargs):
    """Runs batched stochastic or greedy beam search eagerly
    (:class:`BeamSearch`; its arguments, with ``temperature`` for
    ``inv_t``).

    Args:
        gen: ``torch.Generator`` on the logits' device (unused when
            ``greedy``): every draw of the call is made from it up front.
        state: decoder state after prefill, batched ``B * beam`` rows.
        init_logits: ``[B, V]`` logits of the first generated token.
        prefix: optional ``[B, prefix_len]`` fixed first tokens.

    Returns:
        dict with ``sequences [B, beam, max_len]``, ``scores [B, beam]``,
        ``chosen [B, max_len]`` and ``ended [B, beam]``.
    """
    search = BeamSearch(inv_t=inv_temperature(temperature,
                                              init_logits.device), **kwargs)
    noise = draw_noise(gen, noise_shapes(
        steps=search.steps, num_items=init_logits.shape[0],
        beam_size=search.beam, top_k=search.top_k, sampler=search.sampler,
        greedy=search.greedy), init_logits.device)
    return run_eagerly(search.start(noise, state, init_logits,
                                    prefix)).finish()
