"""The port's ``CaptioningMLAMoE`` (DeepSeek-V3's latent-attention and
sparse-expert decoder: Kimi-VL-A3B-Instruct's language model) as the
harness runs it: the model at a configuration (the published
``config.json`` keys, ``n_routed_experts`` the experts held here and
``n_routed_experts_published`` the router's width), its weight tree, the
seeded image prefixes that generation starts from, and the reference's
side of each check (reference/mla_moe.py).
"""

import math

import torch

from perfbench.reference import mla_moe as ref


def build(cfg):
    """The port's model at ``cfg``'s sizes."""
    from deephumor_tpu_torch.models import CaptioningMLAMoE

    return CaptioningMLAMoE(
        num_tokens=cfg["vocab_size"], hid_dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        qk_nope=cfg["qk_nope_head_dim"], qk_rope=cfg["qk_rope_head_dim"],
        v_dim=cfg["v_head_dim"], kv_rank=cfg["kv_lora_rank"],
        dense_width=cfg["intermediate_size"],
        expert_width=cfg["moe_intermediate_size"],
        n_routed=cfg["n_routed_experts_published"],
        n_held=cfg["n_routed_experts"], held_first=cfg["held_first"],
        experts_per_token=cfg["num_experts_per_tok"],
        n_shared=cfg["n_shared_experts"],
        first_dense=cfg["first_k_dense_replace"],
        routed_scaling=cfg["routed_scaling_factor"],
        rope_theta=float(cfg["rope_theta"]), rms_eps=cfg["rms_norm_eps"],
        prefix_len=cfg["image_tokens"], compute_dtype=cfg["compute_dtype"])


def _linear(d_out, d_in, *lead):
    return ("uniform", (*lead, d_out, d_in), 1.0 / math.sqrt(d_in))


def decoder_spec(cfg):
    """The decoder's tree (models/mla_moe.py's layout): (kind, shape[,
    scale]) leaves, Kaiming-uniform linears without biases, unit-normal
    embeddings, norms at one, the correction biases uniform in +-0.05, a
    zero head bias (the harness sets EOS's)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
    dense, width = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    held, routed = cfg["n_routed_experts"], cfg["n_routed_experts_published"]
    shared = cfg["n_shared_experts"] * width
    v = cfg["vocab_size"]

    def one(n):
        return {"weight": ("ones", (n,))}

    def layer(i):
        attn = {"q_proj": {"weight": _linear(h * (nope + rope), d)},
                "kv_a_proj": {"weight": _linear(rank + rope, d)},
                "kv_norm": one(rank),
                "kv_b_proj": {"weight": _linear(h * (nope + vd), rank)},
                "o_proj": {"weight": _linear(d, h * vd)}}
        if i < cfg["first_k_dense_replace"]:
            ffn = {"gate_up": {"weight": _linear(2 * dense, d)},
                   "down": {"weight": _linear(d, dense)}}
        else:
            ffn = {"gate": {"weight": _linear(routed, d),
                            "e_bias": ("uniform", (routed,), 0.05)},
                   "experts": {"gate_up": _linear(2 * width, d, held),
                               "down": _linear(d, width, held)},
                   "shared": {"gate_up": {"weight": _linear(2 * shared, d)},
                              "down": {"weight": _linear(d, shared)}}}
        return {"attn_norm": one(d), "ffn_norm": one(d), "attn": attn,
                "ffn": ffn}

    return {"tok_embedding": {"weight": ("normal", (v, d), 1.0)},
            "layers": [layer(i) for i in range(cfg["num_hidden_layers"])],
            "norm": one(d),
            "classifier": {"weight": _linear(v, d),
                           "bias": ("zeros", (v,))}}


def weight_spec(cfg, encoder):
    """The tree that the harness fills: the decoder (the vision tower is
    not part of the configuration, so no ``encoder`` is taken)."""
    if encoder:
        raise ValueError("kimi_vl has no image encoder in the harness")
    return {"decoder": decoder_spec(cfg)}


def prompts(cfg, n, gen, device):
    """``n`` seeded image prefixes ``([n, image_tokens, hidden_size],)``:
    the rows that Kimi-VL's projector would give."""
    return (torch.randn(n, cfg["image_tokens"], cfg["hidden_size"],
                        generator=gen, device=device),)


def encode(enc, images):
    raise NotImplementedError("kimi_vl's vision tower (MoonViT) is not in "
                              "the configuration: its cells start from "
                              "prefix rows")


def hparams(cfg):
    """The reference's sizes of ``cfg``."""
    return dict(heads=cfg["num_attention_heads"],
                nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
                v=cfg["v_head_dim"], rank=cfg["kv_lora_rank"],
                eps=cfg["rms_norm_eps"], theta=float(cfg["rope_theta"]),
                k=cfg["num_experts_per_tok"],
                scaling=cfg["routed_scaling_factor"],
                first=cfg["held_first"], held=cfg["n_routed_experts"])


def logits(dec, prompts, tokens, cfg, precision="f32"):
    """The reference's logits ``[B, L, V]`` of the served ``tokens`` after
    ``prompts`` (the image prefix)."""
    return ref.logits(dec, prompts[0], tokens, hparams(cfg), precision)


def held_share(cfg):
    """The share of routed pairs that the model's FLOPs count on this
    card: the held experts' share of the router's outputs (the pairs
    measured to land there: ``held_pair_share.kimi_vl``)."""
    return cfg["n_routed_experts"] / cfg["n_routed_experts_published"]


def train_steps(params, feats, batches, cfg, lr, clip, precision="f32",
                rows=None):
    raise NotImplementedError("kimi_vl has no training cell")
