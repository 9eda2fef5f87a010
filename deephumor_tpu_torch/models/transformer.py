"""Incremental transformer decoding over KV caches (the decode half).

Counterpart of the decode path of deephumor_tpu/models/transformer.py:
post-LN blocks, learned positions, token embeddings divided by
sqrt(hid_dim), -1e8 mask fills. During beam search the caches are never
reordered: each branch carries an ancestry table and self-attention runs
in the K1 kernel (ops.ancestry_attention_update), which also writes the
position's K/V into the caches in place. Once the engine has set up a
canonical prefix (long generations), self-attention runs in K5
(ops.ancestry_attention_update_canon) over the shared ancestor rows and a
per-slot window, with the straggler items recomputed full-width by K6
(ops.ancestry_attention_ids). Cross-attention onto each item's encoder K/V
runs in the K2 kernel (ops.grouped_cross_attention), or, when the caller
asks for packing over a tile-padded store, in K9
(ops.cross_attention_packed). The decoder-only stack
(``self_attn_decoder_init``, CaptioningTransformerBase) has no
cross-attention: its layers carry no ``enc_attn`` and ``decode_step`` takes
``cross=None``. On CPU tensors every kernel runs its plain twin.
"""

import math

import torch
import torch.nn.functional as F

from deephumor_tpu_torch.models import layers as L
from deephumor_tpu_torch.ops.attention import (
    MASK_FILL, ancestry_attention_ids, ancestry_attention_update,
    ancestry_attention_update_canon, ancestry_bias, grouped_cross_attention)

__all__ = ["transformer_decoder_init", "self_attn_decoder_init",
           "init_cache",
           "precompute_cross_attention", "pff_apply", "decode_step"]


def _mha_init(gen, d, device):
    return {name: L.linear_init(gen, d, d, device)
            for name in ("fc_q", "fc_k", "fc_v", "fc_o")}


def _stack_init(gen, num_tokens, hid_dim, n_layers, pf_dim, max_len,
                cross_attention, device):
    layers = []
    for _ in range(n_layers):
        layer = {"self_attn": _mha_init(gen, hid_dim, device),
                 "self_attn_ln": L.layer_norm_init(hid_dim, device)}
        if cross_attention:
            layer["enc_attn"] = _mha_init(gen, hid_dim, device)
            layer["enc_attn_ln"] = L.layer_norm_init(hid_dim, device)
        layer["pf"] = {"fc_1": L.linear_init(gen, hid_dim, pf_dim, device),
                       "fc_2": L.linear_init(gen, pf_dim, hid_dim, device)}
        layer["pf_ln"] = L.layer_norm_init(hid_dim, device)
        layers.append(layer)
    return {
        "tok_embedding": L.embedding_init(gen, num_tokens, hid_dim, device),
        "pos_embedding": L.embedding_init(gen, max_len, hid_dim, device),
        "layers": layers,
        "classifier": L.linear_init(gen, hid_dim, num_tokens, device),
    }


def transformer_decoder_init(gen, num_tokens, hid_dim=512, n_layers=6,
                             pf_dim=2048, max_len=128, device="cuda"):
    """Random cross-attention decoder parameters (same tree as the JAX
    ``transformer_decoder_init``)."""
    return _stack_init(gen, num_tokens, hid_dim, n_layers, pf_dim, max_len,
                       True, device)


def self_attn_decoder_init(gen, num_tokens, hid_dim=512, n_layers=6,
                           pf_dim=2048, max_len=128, device="cuda"):
    """Random decoder-only parameters (same tree as the JAX
    ``self_attn_decoder_init``: no ``enc_attn`` in the layers)."""
    return _stack_init(gen, num_tokens, hid_dim, n_layers, pf_dim, max_len,
                       False, device)


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


def precompute_cross_attention(params, enc_out, pad_to_tile=False):
    """Per-layer cross-attention keys/values over the fixed encoder output
    ``[G, T, D]``, computed once per generation.

    ``pad_to_tile`` zero-pads T up to a multiple of 8, the store that the
    packed cross-attention (K9) takes; :func:`decode_step` then masks the
    pad rows (``cross_t_real`` = the unpadded T).
    """
    t = enc_out.shape[-2]
    if pad_to_tile and t % 8:
        enc_out = F.pad(enc_out, (0, 0, 0, -(-t // 8) * 8 - t))
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
                n_heads, cross=None, enc_key_mask=None, anc=None, p_eff=None,
                return_hidden=False, live_items=None, canon=None,
                cross_t_real=None, pack_items=None):
    """One incremental decode position; writes K/V at ``pos`` in place.

    Args:
        token_emb_scaled: ``[bs, D]`` input embedding already divided by
            sqrt(hid_dim).
        pos: int absolute position.
        cache: list from :func:`init_cache`, updated in place.
        self_key_valid: bool ``[bs, max_positions]``.
        cross: list from :func:`precompute_cross_attention`, its batch
            ``bs`` or ``bs / beam`` groups; None for the decoder-only
            stack, whose layers have no ``enc_attn``.
        enc_key_mask: optional bool ``[groups, T]``, True = masked.
        anc: optional ``[B, beam, max_positions]`` ancestry table; given,
            self-attention runs the K1 ancestry kernel over unshuffled
            caches (beam search); absent, plain cached attention
            (prefill).
        p_eff: with ``anc``, the number of leading cache positions read.
        return_hidden: return the pre-classifier hidden state.
        live_items: optional host int, the number of live items (early-EOS
            compaction keeps them first); the kernels skip the rest, whose
            attention rows are zero.
        canon: optional canonical-prefix bundle from the engine's phase
            boundary (``CaptioningTransformer._canonicalize_state``):
            ``{"c": int, "shared": [{"sk", "sv"} per layer],
            "bias_sh": [B, 1, c], "strag_ids": [B], "n_strag": int,
            "strag_rows": bool [bs]}``. Self-attention then reads the
            shared rows below ``c`` plus the per-slot window
            ``[c, p_eff)`` (K5); straggler items are recomputed full-width
            (K6) and merged by row mask. A phase without stragglers
            launches no K6.
        cross_t_real: the number of valid encoder rows of a tile-padded
            cross store (None: the store is not padded).
        pack_items: with ``anc`` and ``cross_t_real``, cross-attention
            runs K9 (ops.cross_attention_packed) with this many items per
            block where the JAX package's packed kernel would run: above
            1, dividing the groups, T and ``n_heads * rows per group``
            multiples of 8. Elsewhere K2 runs.

    Returns:
        (logits ``[bs, V]`` or hidden ``[bs, D]``, cache)
    """
    x = token_emb_scaled + params["pos_embedding"]["weight"][pos]
    pack = cross_bias = None
    if cross is not None:
        # a tile-padded cross store holds rows past cross_t_real: widen the
        # encoder mask so that every cross path masks them
        t_cross = cross[0]["ek"].shape[1]
        if enc_key_mask is not None and enc_key_mask.shape[-1] < t_cross:
            enc_key_mask = F.pad(enc_key_mask,
                                 (0, t_cross - enc_key_mask.shape[-1]),
                                 value=True)
        groups = cross[0]["ek"].shape[0]
        if (pack_items is not None and pack_items > 1 and anc is not None
                and cross_t_real is not None and groups % pack_items == 0
                and t_cross % 8 == 0
                and n_heads * (x.shape[0] // groups) % 8 == 0):
            pack = pack_items
        if enc_key_mask is not None:
            cross_bias = torch.where(enc_key_mask[:, None, :], MASK_FILL,
                                     0.0).to(torch.float32)
    p_cache = cache[0]["k"].shape[1]
    pad = p_cache - self_key_valid.shape[-1]
    valid = F.pad(self_key_valid, (0, pad))
    anc_bias = bias_win = None
    if anc is not None:
        anc = F.pad(anc, (0, pad))
        anc_bias = ancestry_bias(anc, valid, p_cache)
        if canon is not None:
            # the same fold restricted to the still-diverging tip [c, pe)
            c = canon["c"]
            pe = p_cache if p_eff is None else min(p_eff, p_cache)
            bias_win = ancestry_bias(anc[:, :, c:pe], valid[:, c:pe], pe - c)
    d = x.shape[-1]
    for i, layer in enumerate(params["layers"]):
        sa = layer["self_attn"]
        # fused QKV projection: one [3D, D] matmul instead of three
        w = torch.cat([sa[n]["weight"] for n in ("fc_q", "fc_k", "fc_v")])
        b = torch.cat([sa[n]["bias"] for n in ("fc_q", "fc_k", "fc_v")])
        q, k, v = (t.contiguous() for t in F.linear(x, w, b).split(d, -1))
        ck, cv = cache[i]["k"], cache[i]["v"]
        if canon is not None:
            beam = anc.shape[1]
            sh = canon["shared"][i]
            attn = ancestry_attention_update_canon(
                q, ck, cv, sh["sk"], sh["sv"], k, v, canon["bias_sh"],
                bias_win, pos, beam=beam, n_heads=n_heads, c=canon["c"],
                p_eff=pe, live_items=live_items)
            if canon["n_strag"]:
                out_s = ancestry_attention_ids(
                    q, ck, cv, anc_bias, canon["strag_ids"], canon["n_strag"],
                    beam=beam, n_heads=n_heads, p_eff=p_eff)
                attn = torch.where(canon["strag_rows"][:, None], out_s, attn)
        elif anc_bias is not None:
            attn = ancestry_attention_update(
                q, ck, cv, k, v, anc_bias, pos, beam=anc.shape[1],
                n_heads=n_heads, p_eff=p_eff, live_items=live_items)
        else:
            ck[:, pos] = k
            cv[:, pos] = v
            attn = _cached_attention(q, ck, cv, n_heads, ~valid)
        x = L.layer_norm(layer["self_attn_ln"], x + L.linear(sa["fc_o"], attn))

        if "enc_attn" in layer:
            ea = layer["enc_attn"]
            attn = grouped_cross_attention(
                L.linear(ea["fc_q"], x), cross[i]["ek"], cross[i]["ev"],
                cross_bias, n_heads=n_heads, live_items=live_items,
                pack_items=pack, t_real=cross_t_real if pack else None)
            x = L.layer_norm(layer["enc_attn_ln"],
                             x + L.linear(ea["fc_o"], attn))
        x = L.layer_norm(layer["pf_ln"], x + pff_apply(layer["pf"], x))
    if return_hidden:
        return x, cache
    return L.linear(params["classifier"], x), cache
