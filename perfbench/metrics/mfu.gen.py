"""The whole generation call's share of the card's bf16 peak, in %.

Model FLOPs of the work done over the traced window's length times the
peak (989 TFLOP/s; the card's power limit is printed beside the run).
The work: the prefill (every item: the cross keys and values of its T
encoder rows, then one position) and each decode step s over ``beam``
rows of each item that it needs (``ctx["live"]``). A row at position s,
per layer: the fused q/k/v and the output projection, the cross query
and output projections, the feed-forward pair, self-attention over s + 1
positions and cross-attention over T rows; then the classifier.
"""

from perfbench.core import peaks


def row_flops(cfg, s):
    d, pf, t = cfg["hid_dim"], cfg["pf_dim"], cfg["encoder_rows"]
    layer = (2 * d * 3 * d + 2 * d * d + 2 * 2 * d * d + 2 * 2 * d * pf
             + 4 * (s + 1) * d + 4 * t * d)
    return cfg["n_layers"] * layer + 2 * d * cfg["num_tokens"]


def flops(cfg, live):
    d, t = cfg["hid_dim"], cfg["encoder_rows"]
    beam = cfg["generation"]["beam_size"]
    total = float(live[0]) * (row_flops(cfg, 0)
                              + cfg["n_layers"] * t * 2 * 2 * d * d)
    for s in range(1, len(live)):
        total += float(live[s]) * beam * row_flops(cfg, s)
    return total


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "offline" or not tr:
        return None
    return 100.0 * flops(ctx["config"], ctx["live"]) / (
        tr["window_s"] * peaks.BF16_FLOPS)
