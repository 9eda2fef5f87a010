"""Cross-attention's share of its roofline, in %.

The least time of the work over the device time of the kernels that do
it (K2, and K9 where the packed path runs: both launch the
``grouped_cross_attention`` kernels). Each step s over the items it
needs (``ctx["live"]``; the prefill, s = 0, over every item with one row
each, the decode steps over ``beam`` rows an item), T encoder rows, D
the width, e the bytes of the compute dtype:

- bytes: each item's T cross keys and values read once, each row's query
  in and output out: ``items * 2 * T * D * e + rows * 2 * D * e``;
- FLOPs: ``rows * 4 * T * D``.

The least time is the larger of bytes over the HBM bandwidth and FLOPs
over the bf16 peak.
"""

from perfbench.core import peaks

KERNELS = ("grouped_cross_attention",)


def work(cfg, live):
    d, t = cfg["hid_dim"], cfg["encoder_rows"]
    beam = cfg["generation"]["beam_size"]
    e = peaks.DTYPE_BYTES[cfg["compute_dtype"]]
    nbytes = flops = 0.0
    for s in range(len(live)):
        items = float(live[s])
        rows = items * (1 if s == 0 else beam)
        nbytes += items * 2 * t * d * e + rows * 2 * d * e
        flops += rows * 4 * t * d
    return nbytes * cfg["n_layers"], flops * cfg["n_layers"]


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
