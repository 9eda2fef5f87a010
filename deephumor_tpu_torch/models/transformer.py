"""Incremental transformer decoding over KV caches (the decode half).

Counterpart of the decode path of deephumor_tpu/models/transformer.py:
post-LN blocks, learned positions, token embeddings divided by
sqrt(hid_dim), -1e8 mask fills. During beam search the caches are never
reordered: each branch carries an ancestry table and self-attention runs
in the K1 kernel (ops.ancestry_attention_update), which also writes the
position's K/V into the caches in place. Cross-attention onto each item's
encoder K/V runs in the K2 kernel (ops.grouped_cross_attention). On CPU
tensors both run their plain twins.
"""

import math

import torch
import torch.nn.functional as F

from deephumor_tpu_torch.models import layers as L
from deephumor_tpu_torch.ops.attention import (
    MASK_FILL, ancestry_attention_update, ancestry_bias,
    grouped_cross_attention)

__all__ = ["transformer_decoder_init", "init_cache",
           "precompute_cross_attention", "pff_apply", "decode_step"]


def _mha_init(gen, d, device):
    return {name: L.linear_init(gen, d, d, device)
            for name in ("fc_q", "fc_k", "fc_v", "fc_o")}


def transformer_decoder_init(gen, num_tokens, hid_dim=512, n_layers=6,
                             pf_dim=2048, max_len=128, device="cpu"):
    """Random cross-attention decoder parameters (same tree as the JAX
    ``transformer_decoder_init``)."""
    layers = []
    for _ in range(n_layers):
        layers.append({
            "self_attn": _mha_init(gen, hid_dim, device),
            "self_attn_ln": L.layer_norm_init(hid_dim, device),
            "enc_attn": _mha_init(gen, hid_dim, device),
            "enc_attn_ln": L.layer_norm_init(hid_dim, device),
            "pf": {"fc_1": L.linear_init(gen, hid_dim, pf_dim, device),
                   "fc_2": L.linear_init(gen, pf_dim, hid_dim, device)},
            "pf_ln": L.layer_norm_init(hid_dim, device),
        })
    return {
        "tok_embedding": L.embedding_init(gen, num_tokens, hid_dim, device),
        "pos_embedding": L.embedding_init(gen, max_len, hid_dim, device),
        "layers": layers,
        "classifier": L.linear_init(gen, hid_dim, num_tokens, device),
    }


def init_cache(params, bs, max_positions, dtype=torch.float32):
    """Per-layer K/V caches ``[bs, P, D]``, P = max_positions rounded up to
    a multiple of 8 (the tail is never written and always masked)."""
    table = params["tok_embedding"]["weight"]
    p = -(-max_positions // 8) * 8
    return [{"k": torch.zeros((bs, p, table.shape[1]), dtype=dtype,
                              device=table.device),
             "v": torch.zeros((bs, p, table.shape[1]), dtype=dtype,
                              device=table.device)}
            for _ in params["layers"]]


def precompute_cross_attention(params, enc_out):
    """Per-layer cross-attention keys/values over the fixed encoder output
    ``[G, T, D]``, computed once per generation."""
    return [{"ek": L.linear(layer["enc_attn"]["fc_k"], enc_out),
             "ev": L.linear(layer["enc_attn"]["fc_v"], enc_out)}
            for layer in params["layers"]]


def _cached_attention(q, cache_k, cache_v, n_heads, key_mask):
    """Single-query attention of ``q [bs, D]`` over ``[bs, T, D]`` caches;
    ``key_mask [bs, T]`` is True where masked. Used by prefill."""
    bs, t, d = cache_k.shape
    hd = d // n_heads
    qh = q.reshape(bs, n_heads, 1, hd)
    k = cache_k.reshape(bs, t, n_heads, hd).transpose(1, 2)
    v = cache_v.reshape(bs, t, n_heads, hd).transpose(1, 2)
    energy = (qh @ k.transpose(-1, -2)) / math.sqrt(hd)
    energy = energy.masked_fill(key_mask[:, None, None, :], MASK_FILL)
    return (torch.softmax(energy, dim=-1) @ v).reshape(bs, d)


def pff_apply(params, x):
    return L.linear(params["fc_2"], torch.relu(L.linear(params["fc_1"], x)))


def decode_step(params, token_emb_scaled, pos, cache, self_key_valid,
                n_heads, cross, enc_key_mask=None, anc=None, p_eff=None,
                return_hidden=False):
    """One incremental decode position; writes K/V at ``pos`` in place.

    Args:
        token_emb_scaled: ``[bs, D]`` input embedding already divided by
            sqrt(hid_dim).
        pos: int absolute position.
        cache: list from :func:`init_cache`, updated in place.
        self_key_valid: bool ``[bs, max_positions]``.
        cross: list from :func:`precompute_cross_attention`; its batch
            may be ``bs`` or ``bs / beam`` groups.
        enc_key_mask: optional bool ``[groups, T]``, True = masked.
        anc: optional ``[B, beam, max_positions]`` ancestry table; given,
            self-attention runs the K1 ancestry kernel over unshuffled
            caches (beam search); absent, plain cached attention
            (prefill).
        p_eff: with ``anc``, the number of leading cache positions read.
        return_hidden: return the pre-classifier hidden state.

    Returns:
        (logits ``[bs, V]`` or hidden ``[bs, D]``, cache)
    """
    x = token_emb_scaled + params["pos_embedding"]["weight"][pos]
    p_cache = cache[0]["k"].shape[1]
    pad = p_cache - self_key_valid.shape[-1]
    valid = F.pad(self_key_valid, (0, pad))
    anc_bias = None
    if anc is not None:
        anc_bias = ancestry_bias(F.pad(anc, (0, pad)), valid, p_cache)
    cross_bias = None
    if enc_key_mask is not None:
        cross_bias = torch.where(enc_key_mask[:, None, :], MASK_FILL,
                                 0.0).to(torch.float32)
    d = x.shape[-1]
    for i, layer in enumerate(params["layers"]):
        sa = layer["self_attn"]
        # fused QKV projection: one [3D, D] matmul instead of three
        w = torch.cat([sa[n]["weight"] for n in ("fc_q", "fc_k", "fc_v")])
        b = torch.cat([sa[n]["bias"] for n in ("fc_q", "fc_k", "fc_v")])
        q, k, v = (t.contiguous() for t in F.linear(x, w, b).split(d, -1))
        ck, cv = cache[i]["k"], cache[i]["v"]
        if anc_bias is not None:
            attn = ancestry_attention_update(
                q, ck, cv, k, v, anc_bias, pos, beam=anc.shape[1],
                n_heads=n_heads, p_eff=p_eff)
        else:
            ck[:, pos] = k
            cv[:, pos] = v
            attn = _cached_attention(q, ck, cv, n_heads, ~valid)
        x = L.layer_norm(layer["self_attn_ln"], x + L.linear(sa["fc_o"], attn))

        ea = layer["enc_attn"]
        attn = grouped_cross_attention(
            L.linear(ea["fc_q"], x), cross[i]["ek"], cross[i]["ev"],
            cross_bias, n_heads=n_heads)
        x = L.layer_norm(layer["enc_attn_ln"], x + L.linear(ea["fc_o"], attn))
        x = L.layer_norm(layer["pf_ln"], x + pff_apply(layer["pf"], x))
    if return_hidden:
        return x, cache
    return L.linear(params["classifier"], x), cache
