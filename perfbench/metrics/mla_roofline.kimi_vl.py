"""K12's share of its roofline, in %: the least time of the latent
attention's work over the device time of K12 (``mla_attention`` kernels).

The work of decode step s (s >= 1) over the items that step needs
(``ctx["live"]``), per layer, with R = rank + rope the latent row's width
(576) and Q = beam x heads queries an item:

- bytes: each item's prefix rows and its s kept generated rows read once
  (at least s: every branch reads one row a position), 2 bytes a value,
  the queries in (Q x R) and the latent outputs out (Q x rank);
- FLOPs: each query's energies and weighted sum over the same rows,
  ``Q x 2 x (R + rank)`` a row read.

The least time is the larger of bytes over the HBM bandwidth and FLOPs
over the bf16 peak (the roofline of the whole, not of each launch).
"""

from perfbench.core import peaks

KERNELS = ("mla_attention",)


def work(cfg, live):
    rank, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    width = rank + rope
    q = cfg["generation"]["beam_size"] * cfg["num_attention_heads"]
    t0 = cfg["image_tokens"]
    nbytes = flops = 0.0
    for s in range(1, len(live)):
        items, rows = float(live[s]), t0 + s
        nbytes += items * (rows * width + q * width + q * rank) * 2
        flops += items * q * 2 * (width + rank) * rows
    layers = cfg["num_hidden_layers"]
    return nbytes * layers, flops * layers


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "offline" or not tr:
        return None
    secs = sum(v for k, v in tr["kernel_s"].items()
               if any(n in k for n in KERNELS))
    if secs <= 0:
        return None
    nbytes, flops = work(ctx["config"], ctx["live"])
    least = max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.BF16_FLOPS)
    return 100.0 * least / secs
