"""Loss and evaluation metrics.

Counterpart of deephumor_tpu/experiments/metrics.py: the reference's
per-sequence perplexity, exp(-sum_t log p(target_t) / length) with padded
positions zeroed, averaged over the batch; the mean cross-entropy over
non-pad positions; and the two fused into one pass for the train step.

Over a mesh's data axis (``group``), each rank holds a shard of the batch
and the denominators (non-pad tokens, row weights or rows) are those of
the global batch, summed over the group first: the ranks' results, and
their gradients, then sum to the single-device ones. A mean of per-shard
means would weigh shards with fewer tokens (ragged captions, a padded
tail batch's rows) up.
"""

import torch
import torch.distributed as dist

from deephumor_tpu_torch.utils.collectives import all_reduce

__all__ = ["perplexity", "masked_cross_entropy", "masked_ce_and_perplexity"]


def _global_sum(x, group):
    """``x`` summed over ``group`` (itself without one); counts only, no
    gradient."""
    if group is None:
        return x
    x = x.detach().clone()
    all_reduce(x, group)
    return x


def _weighted_mean(pp, row_weights, group=None):
    if row_weights is None:
        if group is None:
            return pp.mean()
        # the shards hold equal numbers of rows
        return pp.sum() / (pp.shape[0] * dist.get_world_size(group))
    w = row_weights.to(pp.dtype)
    return (pp * w).sum() / _global_sum(w.sum(), group).clamp(min=1)


def _target_logp(logp, targets):
    return logp.gather(-1, targets.long()[..., None])[..., 0]


def perplexity(logits, targets, lengths, pad_index=0, row_weights=None):
    """Mean per-sequence perplexity of ``logits [bs, T, V]`` at
    ``targets [bs, T]`` with ``lengths [bs]`` non-pad counts;
    ``row_weights`` (0/1 per row) weights rows into the mean, so that the
    duplicated rows of a padded tail batch do not bias it."""
    tgt = _target_logp(torch.log_softmax(logits, dim=-1), targets)
    tgt = tgt / lengths.clamp(min=1)[:, None]
    tgt = torch.where(targets == pad_index, 0.0, tgt)
    return _weighted_mean(torch.exp(-tgt.sum(dim=-1)), row_weights)


def masked_cross_entropy(logits, targets, pad_index=0):
    """Mean cross-entropy over the non-pad positions."""
    nll = -_target_logp(torch.log_softmax(logits, dim=-1), targets)
    mask = targets != pad_index
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def masked_ce_and_perplexity(logits, targets, lengths, pad_index=0,
                             row_weights=None, group=None):
    """:func:`masked_cross_entropy` and :func:`perplexity` in one pass:
    an f32 ``logsumexp`` over the vocabulary and a gather of the target
    logits (``log_softmax(x)[t] == x[t] - logsumexp(x)``), so no
    ``[bs, T, V]`` log-probability tensor is formed. Takes bf16 or f32
    logits; the results are f32. With ``group`` (a mesh's data axis),
    this shard's share of the global batch's values (module docstring)."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt_logp = _target_logp(logits, targets).float() - lse
    mask = targets != pad_index
    n_tok = _global_sum(mask.sum(), group)
    loss = -(tgt_logp * mask).sum() / n_tok.clamp(min=1)
    per_tok = torch.where(mask, tgt_logp, 0.0) / lengths.clamp(min=1)[:, None]
    return loss, _weighted_mean(torch.exp(-per_tok.sum(dim=-1)), row_weights,
                                group)
