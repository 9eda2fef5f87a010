"""The port's ``CaptioningTransformer`` (the spatial cross-attention
decoder over a ResNet-50 encoder) as the harness runs it: the model at a
configuration, its weight tree, the seeded prompts that generation
starts from, and the reference's side of each check.

A configuration names its model by ``model``; the harness finds this
file by that name (``spec.model``). Another model brings a file of its
own with the same functions.
"""

import torch

from perfbench.core import weights
from perfbench.reference import captioner as ref
from perfbench.reference import encoder as ref_encoder
from perfbench.reference import train as ref_train

PAD = 0


def build(cfg):
    """The port's model at ``cfg``'s sizes and dropout."""
    from deephumor_tpu_torch.models import CaptioningTransformer

    return CaptioningTransformer(
        num_tokens=cfg["num_tokens"], hid_dim=cfg["hid_dim"],
        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
        pf_dim=cfg["pf_dim"], max_len=cfg["max_len"],
        enc_dropout=cfg["enc_dropout"], dec_dropout=cfg["dec_dropout"],
        compute_dtype=cfg["compute_dtype"])


def decoder_spec(cfg):
    """The cross-attention decoder's tree: (kind, shape[, scale]) leaves."""
    d, pf, v = cfg["hid_dim"], cfg["pf_dim"], cfg["num_tokens"]

    def attn():
        return {n: weights.linear(d, d) for n in ("fc_q", "fc_k", "fc_v",
                                                   "fc_o")}

    layer = {"self_attn": attn(), "self_attn_ln": weights.norm(d),
             "enc_attn": attn(), "enc_attn_ln": weights.norm(d),
             "pf": {"fc_1": weights.linear(d, pf),
                    "fc_2": weights.linear(pf, d)},
             "pf_ln": weights.norm(d)}
    return {"tok_embedding": {"weight": ("normal", (v, d), 1.0)},
            "pos_embedding": {"weight": ("normal", (cfg["max_len"], d), 1.0)},
            "layers": [layer] * cfg["n_layers"],
            "classifier": weights.linear(d, v)}


def weight_spec(cfg, encoder):
    """The tree that the harness fills: the decoder, and with ``encoder``
    ``"full"`` the whole encoder (ResNet-50 and its head), with
    ``"head"`` the head alone (training from cached trunk features)."""
    tree = {"decoder": decoder_spec(cfg)}
    if encoder:
        enc = weights.encoder_spec(cfg)
        if encoder == "head":
            del enc["resnet"]
        tree["encoder"] = enc
    return tree


def prompts(cfg, n, gen, device):
    """``n`` seeded prompts of ``generate_from_emb``: the start embedding
    ``[n, D]`` and the spatial rows ``[n, T, D]``."""
    d, t = cfg["hid_dim"], cfg["encoder_rows"]
    return (torch.randn(n, d, generator=gen, device=device),
            torch.randn(n, t, d, generator=gen, device=device))


def encode(enc, images):
    """The reference's prompts of NHWC ``images``."""
    return ref_encoder.encode(enc, images)


def logits(dec, prompts, tokens, cfg, precision="f32"):
    """The reference's logits ``[B, L, V]`` of the served ``tokens``
    after ``prompts``."""
    start, spatial = prompts
    return ref.decoder_logits(dec, start, spatial, tokens, cfg["n_heads"],
                              PAD, precision)


def train_steps(params, feats, batches, cfg, lr, clip, precision="f32",
                rows=None):
    """The reference's train steps from ``params`` (changed in place):
    (losses, the first step's clipped gradients)."""
    return ref_train.run_steps(params, feats, batches, cfg["n_heads"], lr,
                               clip, precision, rows)

