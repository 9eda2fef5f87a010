"""The Kimi-VL generation call's share of the card's bf16 peak, in %.

Model FLOPs of the work done over the traced window's length times the
peak (989 TFLOP/s; the card's power limit is printed beside the run).
The work: the prefill (each item's ``image_tokens`` prefix rows through
every layer, causal attention in the unabsorbed form, then the head on
its last row) and each decode step s over ``beam`` rows of each item
that it needs (``ctx["live"]``): the projections, the absorbed query and
output (W_kvb's halves), latent attention over the item's prefix and the
branch's s generated rows, and the head. A token's feed-forward is the
dense SwiGLU in the first layers, then the router, the shared experts and
its pairs on the held experts only: ``num_experts_per_tok`` times the
share of pairs held (models/CaptioningMLAMoE.py ``held_share``).
"""

from perfbench.core import peaks, spec


def ffn_flops(cfg, share):
    """FFN FLOPs of one token over every layer."""
    d = cfg["hidden_size"]
    dense = cfg["first_k_dense_replace"]
    moe_layers = cfg["num_hidden_layers"] - dense
    shared = cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    pairs = cfg["num_experts_per_tok"] * share
    return (dense * 6 * d * cfg["intermediate_size"]
            + moe_layers * (2 * d * cfg["n_routed_experts_published"]
                            + 6 * d * shared
                            + pairs * 6 * d * cfg["moe_intermediate_size"]))


def proj_flops(cfg):
    """q, kv_a and o projections of one token in one layer."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    return 2 * d * (h * (nope + rope) + cfg["kv_lora_rank"] + rope
                    + h * cfg["v_head_dim"])


def flops(cfg, live, share):
    d, h, v = (cfg["hidden_size"], cfg["num_attention_heads"],
               cfg["vocab_size"])
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    rank, vd, layers = cfg["kv_lora_rank"], cfg["v_head_dim"], \
        cfg["num_hidden_layers"]
    t0, beam = cfg["image_tokens"], cfg["generation"]["beam_size"]
    per_token = layers * proj_flops(cfg) + ffn_flops(cfg, share)
    # prefill: kv_b and causal attention over t + 1 rows at position t
    attn = sum(2 * h * (t + 1) * (nope + rope + vd) for t in range(t0))
    item = (t0 * (per_token + layers * 2 * rank * h * (nope + vd))
            + layers * attn + 2 * d * v)
    total = float(live[0]) * item
    for s in range(1, len(live)):
        row = (per_token + layers * (2 * h * nope * rank + 2 * h * rank * vd
                                     + 2 * h * (t0 + s) * (2 * rank + rope))
               + 2 * d * v)
        total += float(live[s]) * beam * row
    return total


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "offline" or not tr:
        return None
    cfg = ctx["config"]
    share = spec.model(cfg).held_share(cfg)
    return 100.0 * flops(cfg, ctx["live"], share) / (
        tr["window_s"] * peaks.BF16_FLOPS)
