"""Decode self-attention's share of its roofline, in %.

The least time of the work over the device time of the kernels that do
it (K1, and in long generations K5 and K6: the names below). The work of
decode step s (position s, s >= 1) over the items that step needs (a
lower bound from the final beams, ``ctx["live"]``), ``beam`` rows an
item, D the width, e the bytes of the compute dtype:

- bytes: each item's cached keys and values of positions 0..s-1 read
  once (its branches' histories share at least one path, so this is the
  least any kernel reads), each row's q, k and v in and its output and
  new cache row out: ``items * 2 * s * D * e + rows * 6 * D * e``;
- FLOPs: each row's scores and weighted sum over positions 0..s:
  ``rows * 4 * (s + 1) * D``.

The least time is the larger of bytes over the HBM bandwidth and FLOPs
over the bf16 peak.
"""

from perfbench.core import peaks

KERNELS = ("ancestry_attention", "canon_attention")


def work(cfg, live):
    d, beam = cfg["hid_dim"], cfg["generation"]["beam_size"]
    e = peaks.DTYPE_BYTES[cfg["compute_dtype"]]
    nbytes = flops = 0.0
    for s in range(1, len(live)):
        items, rows = float(live[s]), float(live[s]) * beam
        nbytes += items * 2 * s * d * e + rows * 6 * d * e
        flops += rows * 4 * (s + 1) * d
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
