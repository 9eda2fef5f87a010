"""The held experts' products' share of their roofline, in %: the least
time of the routed experts' work over the device time of the kernels
that compute their grouped products (``torch._grouped_mm``'s CUTLASS
kernels: the names below).

The work of the window's calls, per expert layer: the held experts'
weights read once a layer-step (the prefill as one pass, then each decode
step), ``held x 3 x D x I`` bf16 values; each held pair's activation in
and its output out (``2 x D`` bf16 values); ``6 x D x I`` FLOPs a held
pair. The pairs: the prefill's ``image_tokens`` rows an item and
``beam`` rows of each item that decode step s needs (``ctx["live"]``),
``num_experts_per_tok`` pairs a row, of which the held share
(models/CaptioningMLAMoE.py ``held_share``) lands here. The least time is the larger
of bytes over the HBM bandwidth and FLOPs over the bf16 peak.
"""

from perfbench.core import peaks, spec

KERNELS = ("GroupProblemShape", "grouped_gemm", "GroupedGemm")


def work(cfg, live, calls, share):
    """(bytes, FLOPs) of the routed experts' products over ``calls``
    calls whose steps need ``live`` items."""
    d, i = cfg["hidden_size"], cfg["moe_intermediate_size"]
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    beam, t0 = cfg["generation"]["beam_size"], cfg["image_tokens"]
    tokens = float(live[0]) * t0 + sum(float(n) * beam for n in live[1:])
    pairs = tokens * cfg["num_experts_per_tok"] * share
    layer_steps = calls * len(live)
    nbytes = layers * (layer_steps * cfg["n_routed_experts"] * 3 * d * i
                       + pairs * 2 * d) * 2
    return nbytes, layers * pairs * 6 * d * i


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "offline" or not tr or not ctx["calls"]:
        return None
    secs = sum(v for k, v in tr["kernel_s"].items()
               if any(n in k for n in KERNELS))
    if secs <= 0:
        return None
    cfg = ctx["config"]
    share = spec.model(cfg).held_share(cfg)
    nbytes, flops = work(cfg, ctx["live"], ctx["calls"], share)
    least = max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.BF16_FLOPS)
    return 100.0 * least / secs
