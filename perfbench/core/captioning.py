"""What the captioning cells share: the port's model at a configuration
(by its model's file, ``models/<model>.py``), the gates every caption
passes, the check against the reference, and the per-step live counts
that the per-layer metrics read."""

import math

import numpy as np
import torch

from perfbench.core import spec, weights
from perfbench.reference import captioner as ref

UNK, EOS, PAD = 1, 3, 0
# a served token counts as outside the reference's support when its gap
# passes f32 rounding (the program's bf16 gaps run to some 0.03 logits)
OUTSIDE_TOL = 1e-4


def make_model(cfg):
    """The port's model at ``cfg``'s sizes."""
    return spec.model(cfg).build(cfg)


def make_params(cfg, seed, device, encoder):
    """The seeded weights of ``cfg``'s model: the decoder, and with
    ``encoder`` the whole image encoder."""
    tree = spec.model(cfg).weight_spec(cfg, "full" if encoder else None)
    return weights.make(tree, spec.derive_seed(seed, "weights"), device,
                        eos_index=EOS, eos_bias=cfg["assumed"]["eos_bias"])


def generate_kwargs(cfg):
    g = cfg["generation"]
    return dict(max_len=g["max_len"], beam_size=g["beam_size"],
                top_k=g["top_k"], temperature=g["temperature"],
                sampler=g["sampler"])


def gate_failures(out, vocab):
    """Items of one call's output whose caption fails the gates: a token
    outside ``[0, vocab)``, an UNK, or a score that is not finite."""
    seq = out["chosen"]
    bad = ((seq < 0) | (seq >= vocab) | (seq == UNK)).any(1)
    bad |= ~torch.isfinite(out["scores"]).all(1)
    return bad


def item_last(out, max_len):
    """Per item, the last decode step that some branch of its final beams
    needs: the first EOS position of each final beam (``max_len - 1``
    without one), the largest over the beams. Step s needs the item iff
    this is >= s, a lower bound of the items that the search keeps live."""
    seq = out["sequences"]
    is_eos = seq == EOS
    first = torch.where(is_eos.any(-1), is_eos.int().argmax(-1),
                        torch.full_like(seq[..., 0], max_len - 1))
    return first.amax(1)


def live_per_step(lasts, max_len):
    """``[max_len]`` counts over calls: the items that step s needs."""
    counts = np.zeros(max_len, np.int64)
    for last in lasts:
        hist = np.bincount(np.asarray(last), minlength=max_len)
        counts += hist[::-1].cumsum()[::-1][:max_len]
    return counts


def reference_precision():
    """The reference's f32: no TF32 in the products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check(cfg, dec, prompts, tokens, seed, block=32, control=False):
    """The served tokens ``tokens [N, L]`` judged against the reference
    run once over each prompt with them: ``prompts`` is the model's
    prompts (each ``[N, ...]``), f32 on the device. Returns the readings:
    ``gap`` (the widest by which a served token lies below the edge of
    the reference's top-k support, 0 when every one lies inside),
    ``outside_share`` (the % of judged tokens that lie outside it by
    more than ``OUTSIDE_TOL``),
    ``tail`` (positions past an EOS that hold another token than the
    pad), ``tokens`` (how many were judged) and, with ``control``,
    ``control_gap`` and ``control_outside_share``: the same readings of
    tokens that the fp8 reference draws at the same positions."""
    g = cfg["generation"]
    model = spec.model(cfg)
    reference_precision()
    gen = torch.Generator(tokens.device).manual_seed(
        spec.derive_seed(seed, "control"))
    worst, worst_ctl, tail, judged = 0.0, 0.0, 0, 0
    outside = outside_ctl = 0
    with torch.no_grad():
        for i in range(0, tokens.shape[0], block):
            sl = slice(i, i + block)
            tok = tokens[sl]
            part = tuple(p[sl] for p in prompts)
            lengths = ref.served_lengths(tok, EOS)
            logits = model.logits(dec, part, tok, cfg)
            gaps = ref.support_gaps(logits, tok, lengths, g["top_k"], UNK)
            worst = max(worst, float(torch.nan_to_num(
                gaps, nan=-math.inf).max()))
            outside += int((gaps > OUTSIDE_TOL).sum())
            tail += ref.tail_faults(tok, lengths, PAD)
            judged += int(lengths.sum())
            if control:
                ctl = model.logits(dec, part, tok, cfg, "fp8")
                cg = ref.control_gaps(logits, ctl, lengths, g["top_k"], UNK,
                                      1.0 / g["temperature"], gen)
                worst_ctl = max(worst_ctl, float(torch.nan_to_num(
                    cg, nan=-math.inf).max()))
                outside_ctl += int((cg > OUTSIDE_TOL).sum())
    share = 100.0 / max(judged, 1)
    out = {"gap": max(worst, 0.0), "outside_share": outside * share,
           "tail": tail, "tokens": judged}
    if control:
        out.update(control_gap=max(worst_ctl, 0.0),
                   control_outside_share=outside_ctl * share)
    return out


def verdict(readings, limits, failed):
    """(correct, the numbers compared beside their limits): no caption
    failed the gates or never came, no token past an EOS, the widest gap
    and the share of served tokens outside the reference's support each
    within its limit."""
    checks = {"outside_share": [readings["outside_share"],
                                limits["outside_share"]],
              "gap": [readings["gap"], limits["gap"]],
              "tail": [readings["tail"], 0],
              "failed": [failed, 0]}
    return all(v <= lim for v, lim in checks.values()), checks


def sample_rows(n, k, seed, longest):
    """``k`` of ``n`` finished rows drawn from ``seed``, ``longest``
    among them."""
    rng = np.random.default_rng(spec.derive_seed(seed, "sample"))
    rows = rng.choice(n, size=min(k, n), replace=False)
    if longest not in rows:
        rows[0] = longest
    return np.sort(rows)
