"""Batched beam-search generation engine.

Counterpart of deephumor_tpu/models/sampling.py with the same semantics:
top-k filtering that keeps ties and masks UNK, temperature softmax +
sampling without replacement (Gumbel-top-k) for both the per-branch
candidate draw and the survivor draw, per-step scores = log_softmax over
the k drawn values, ended branches continue with one pad/score-0
candidate, and a deterministic ``greedy`` mode (argmax everywhere).

The token loop runs on the host, one decoder step per position, split
into ``phases`` whose step functions read a growing cache prefix (or one
``step_fn`` over every step, as the LSTM runs). It
stops early once every branch has ended (one ``ended.all()`` read per
step), which gives the same result as running every step: ended branches
only append pads at score 0. A model may run a boundary function after a
phase (early-EOS compaction, canonical-prefix setup) that permutes the
items; ``finalize_fn`` puts the outputs back in the caller's order.
Random draws come from the caller's ``torch.Generator``, which must live
on the device of the logits.
"""

import torch

from deephumor_tpu_torch import EOS, PAD, UNK
from deephumor_tpu_torch.ops.sampler import (
    fused_classifier_topk_gumbel_sample, fused_topk_gumbel_sample)
from deephumor_tpu_torch.utils.pytree import tree_map

__all__ = ["filter_top_k", "gumbel_top_k", "beam_search"]

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


def gumbel_top_k(gen, log_weights, k):
    """Samples k indices without replacement ~ softmax(log_weights);
    -inf weights are never selected (given k <= #finite entries)."""
    u = torch.rand(log_weights.shape, generator=gen,
                   device=log_weights.device).clamp_min(1e-20)
    gumbel = -torch.log(-torch.log(u))
    perturbed = torch.where(torch.isfinite(log_weights),
                            log_weights + gumbel, NEG_INF)
    return _top_k(perturbed, k)[1]


def _select_k(gen, log_weights, k, greedy):
    if greedy:
        return _top_k(log_weights, k)[1]
    return gumbel_top_k(gen, log_weights, k)


def _log_softmax_scores(vals):
    return vals - torch.logsumexp(vals, dim=-1, keepdim=True)


def _topk_space_draw(gen, logits, top_k, k, inv_t, greedy, unk_index,
                     sampler="exact", classifier=None, seed=None,
                     live_rows=None):
    """One vocab-wide top-k selection, then the k-token draw in the
    reduced space. Returns (token ids ``[..., k]``, scores ``[..., k]``).

    ``sampler="pallas"`` (stochastic only) runs the sampler kernels, which
    skip rows at or past ``live_rows``. With ``classifier``, ``logits`` is
    the pre-classifier hidden state: up to ``FUSED_CLASSIFIER_MAX_V`` the K4
    kernel (ops.fused_classifier_topk_gumbel_sample) computes the
    classifier inside the draw; above it the classifier is a plain bf16
    matmul before K3 (ops.fused_topk_gumbel_sample). ``"exact"`` (and
    greedy) sorts the f32 logits."""
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
    pick = _select_k(gen, vals * inv_t, k, greedy)
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


def beam_search(gen, state, init_logits, *, beam_size, top_k, temperature,
                max_len, step_fn=None, phases=None, shuffle_fn=None,
                prefix=None, prefix_len=0,
                greedy=False, sampler="exact", classifier=None,
                live_fn=None, compactors=None, finalize_fn=None,
                survivor_update_fn=None, eos_index=EOS, unk_index=UNK,
                pad_index=PAD):
    """Runs batched stochastic or greedy beam search.

    Args:
        gen: ``torch.Generator`` on the logits' device (unused when
            ``greedy``).
        state: decoder state after prefill, batched ``B * beam`` rows.
        init_logits: ``[B, V]`` logits of the first generated token.
        step_fn: ``(state, tokens [B*beam]) -> (logits or hidden,
            state)``, run for every step when ``phases`` is not given.
        phases: optional ``[(last_step, step_fn), ...]``: each step_fn runs
            the steps up to its ``last_step`` (the final entry covers the
            rest).
        shuffle_fn: optional ``(state, flat_branch [B*beam], branch
            [B, beam]) -> state`` that reorders the decoder state to the
            surviving branches; by default every state tensor's rows are
            gathered by ``flat_branch``.
        classifier: optional ``(weight [V, D], bias [V])``; when given the
            step functions return hidden states and the draw classifies.
        live_fn: optional ``state -> int or None``, the live-item count
            (live items lead); the draw skips the other rows.
        compactors: optional list, one entry per phase but the last:
            ``None`` or ``(state, seq, val, ended) -> (state, seq, val,
            ended)``, run after that phase's loop (it may permute items).
        finalize_fn: optional ``(state, out) -> out`` run on the outputs.
        survivor_update_fn: optional replacement of the whole update after
            the survivor draw, ``shuffle_fn`` included: ``(state, new_idx,
            new_val, surv, ended, val, seq, pos) -> (state, seq, val,
            ended, chosen)`` with the draw's raw (unmasked) candidates
            ``[B, beam, beam]``. It must reproduce the default update
            (ops.fused_survivor_update does); given, ``shuffle_fn`` is not
            called.
        max_len: total output length including any prefix.

    Returns:
        dict with ``sequences [B, beam, max_len]``, ``scores [B, beam]``,
        ``chosen [B, max_len]`` and ``ended [B, beam]``.
    """
    if beam_size > top_k:
        raise ValueError(f"beam_size ({beam_size}) must be <= top_k "
                         f"({top_k})")
    num_items = init_logits.shape[0]
    beam, inv_t, dev = beam_size, 1.0 / temperature, init_logits.device
    steps = max_len - prefix_len
    if phases is None:
        phases = [(steps - 1, step_fn)]
    shuffle_fn = shuffle_fn or _gather_rows
    seeds = [None] * steps
    if sampler == "pallas" and not greedy:
        # the K3 kernel's per-step seeds, drawn once up front
        seeds = torch.randint(0, 2 ** 31 - 1, (steps,), generator=gen,
                              device=gen.device).tolist()

    def draw(logits, seed, cls=None, live_rows=None):
        return _topk_space_draw(gen, logits, top_k, beam, inv_t, greedy,
                                unk_index, sampler, cls, seed, live_rows)

    first_idx, val = draw(init_logits, seeds[0])
    seq = torch.full((num_items, beam, max_len), pad_index,
                     dtype=torch.int64, device=dev)
    if prefix is not None and prefix_len > 0:
        seq[:, :, :prefix_len] = prefix[:, None, :]
    seq[:, :, prefix_len] = first_idx
    ended = first_idx == eos_index
    col = torch.arange(beam, device=dev)
    items = torch.arange(num_items, device=dev)[:, None]

    bounds = [(min(b, steps - 1), f) for b, f in phases[:-1]]
    bounds.append((steps - 1, phases[-1][1]))
    compactors = list(compactors or []) + [None] * len(bounds)
    s = 1
    all_ended = bool(ended.all())
    for (last_step, step_fn), boundary in zip(bounds, compactors):
        if last_step < 1:
            continue
        while s <= last_step and not all_ended:
            out, state = step_fn(state, seq[:, :, prefix_len + s - 1]
                                 .reshape(-1))
            live = None if live_fn is None else live_fn(state)
            new_idx, new_val = draw(out, seeds[s], classifier,
                                    None if live is None else live * beam)
            new_idx = new_idx.reshape(num_items, beam, beam)
            new_val = new_val.reshape(num_items, beam, beam)
            e3 = ended[..., None]
            valid = ~e3 | (col == 0)
            cand_val = val[..., None] + new_val.masked_fill(e3, 0.0)
            weight = torch.where(valid, cand_val * inv_t, NEG_INF)
            surv = _select_k(gen, weight.reshape(num_items, -1), beam,
                             greedy)
            if survivor_update_fn is not None:
                state, seq, val, ended, _ = survivor_update_fn(
                    state, new_idx, new_val, surv, ended, val, seq,
                    prefix_len + s)
            else:
                branch = surv // beam
                chosen = new_idx.masked_fill(e3, pad_index).reshape(
                    num_items, -1).gather(1, surv)
                val = cand_val.reshape(num_items, -1).gather(1, surv)
                seq = seq[items, branch]
                ended = ended.gather(1, branch)
                seq[:, :, prefix_len + s] = chosen
                ended = ended | (chosen == eos_index)
                state = shuffle_fn(state, (items * beam + branch).reshape(
                    -1), branch)
            s += 1
            all_ended = bool(ended.all())
        # once every branch has ended no later step runs, so a boundary
        # would only permute rows that finalize_fn puts back
        if boundary is not None and not all_ended:
            state, seq, val, ended = boundary(state, seq, val, ended)

    final = _select_k(gen, val * inv_t, 1, greedy)[:, 0]
    out = {"sequences": seq, "scores": val,
           "chosen": seq[items[:, 0], final], "ended": ended}
    return out if finalize_fn is None else finalize_fn(state, out)
