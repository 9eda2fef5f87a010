"""Transformer decoders: the teacher-forced forward and incremental
decoding over KV caches.

Counterpart of deephumor_tpu/models/transformer.py: post-LN blocks,
learned positions, token embeddings divided by sqrt(hid_dim), -1e8 mask
fills (a fully masked row gets uniform weights, as in the reference).

The full-sequence side (training) is plain PyTorch, as the JAX package
leaves it to XLA: :func:`mha_apply` with attention-weight dropout,
:func:`transformer_decoder_forward` with the reference's
pad-to-common-length quirk (decoder tokens and the 49 encoder rows padded
to one length, the encoder key mask taken from all-zero rows after the
padding), :func:`self_attn_decoder_forward`, and the repaired transformer
encoder (:func:`transformer_encoder_forward`), which no captioner uses.

During beam search the caches are never
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

Tensor parallelism (Megatron-style, explicit collectives): given a
``model_group``, the parameter tree holds this rank's shards of the
``model`` mesh axis (``parallel/sharding.py``): fc_q, fc_k, fc_v and fc_1
column-parallel (its heads, its pf units), fc_o and fc_2 row-parallel. The
attention runs over the rank's ``n_heads / model`` heads (caches and the
cross store are ``D / model`` wide), each row-parallel product is formed
without its bias, summed over the group in f32 (one ``all_reduce``), and
the replicated bias, the residual and the layer norm follow. In training
the column-parallel inputs pass through an identity whose backward sums
the gradient over the group, and the dropout on the attention weights and
on the pf units draws the whole layer's mask and keeps the rank's slice
(the ranks of a group share their generator), so a group applies one
card's masks. ``model_group=None`` (one card, or a tree of whole weights)
runs none of it.
"""

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from deephumor_tpu_torch.models import layers as L
from deephumor_tpu_torch.ops.attention import (
    MASK_FILL, ancestry_attention_ids, ancestry_attention_update,
    ancestry_attention_update_canon, ancestry_bias, grouped_cross_attention)
from deephumor_tpu_torch.utils.collectives import all_reduce

__all__ = ["mha_apply", "pff_apply", "get_pad_mask",
           "get_autoregressive_mask", "encoder_layer_init",
           "encoder_layer_apply", "transformer_encoder_init",
           "transformer_encoder_forward", "transformer_decoder_init",
           "transformer_decoder_forward", "self_attn_decoder_init",
           "self_attn_decoder_forward", "init_cache",
           "precompute_cross_attention", "fuse_qkv", "decode_step"]


class _ModelCopy(torch.autograd.Function):
    """The input of a column-parallel product: the identity forward; the
    backward sums the gradient over the model group (each rank's heads
    give only their share of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        all_reduce(grad, ctx.group)
        return grad, None


class _ModelSum(torch.autograd.Function):
    """The partial products of a row-parallel layer summed over the model
    group; the backward is the identity (the summed output is replicated,
    and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        # x is the fresh partial product, reduced where it lies
        ctx.mark_dirty(x)
        all_reduce(x, group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def local_heads(n_heads, model_group):
    """The heads one rank of ``model_group`` holds (all of them without a
    group)."""
    if model_group is None:
        return n_heads
    m = dist.get_world_size(model_group)
    if n_heads % m:
        raise ValueError(f"{n_heads} heads do not split over a model axis "
                         f"of {m}")
    return n_heads // m


def _col_input(x, model_group):
    return x if model_group is None else _ModelCopy.apply(x, model_group)


def _col_dropout(gen, x, rate, train, model_group, dim):
    """Dropout on a column-parallel activation (``dim``: its heads or pf
    units): over a model group, the mask is drawn at the whole layer's
    shape and this rank's slice of it taken, so the group's ranks, which
    share ``gen``, together apply one card's mask."""
    if model_group is None or not train or rate == 0.0:
        return L.dropout(gen, x, rate, train)
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * dist.get_world_size(model_group)
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=gen, device=x.device).narrow(
        dim, n * dist.get_rank(model_group), n) < keep
    return torch.where(mask, x / keep, 0.0)


def _row_linear(params, x, model_group):
    """A row-parallel linear (fc_o, fc_2): over a model group, the partial
    product without the bias, summed over the group in f32, then the
    replicated bias, rounded once to ``x``'s dtype."""
    if model_group is None:
        return L.linear(params, x)
    part = _ModelSum.apply(F.linear(x, params["weight"]).float(),
                           model_group)
    return (part + params["bias"].float()).to(x.dtype)


def _mha_init(gen, d, device):
    return {name: L.linear_init(gen, d, d, device)
            for name in ("fc_q", "fc_k", "fc_v", "fc_o")}


def _layer_init(gen, hid_dim, pf_dim, cross_attention, device):
    layer = {"self_attn": _mha_init(gen, hid_dim, device),
             "self_attn_ln": L.layer_norm_init(hid_dim, device)}
    if cross_attention:
        layer["enc_attn"] = _mha_init(gen, hid_dim, device)
        layer["enc_attn_ln"] = L.layer_norm_init(hid_dim, device)
    layer["pf"] = {"fc_1": L.linear_init(gen, hid_dim, pf_dim, device),
                   "fc_2": L.linear_init(gen, pf_dim, hid_dim, device)}
    layer["pf_ln"] = L.layer_norm_init(hid_dim, device)
    return layer


def _stack_init(gen, num_tokens, hid_dim, n_layers, pf_dim, max_len,
                cross_attention, device):
    layers = [_layer_init(gen, hid_dim, pf_dim, cross_attention, device)
              for _ in range(n_layers)]
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


def mha_apply(params, query, key, value, n_heads, mask=None, dropout=0.0,
              train=False, gen=None, model_group=None):
    """Multi-head attention of ``query [bs, Tq, D]`` over ``key, value
    [bs, Tk, D]``; ``mask`` bool ``[bs, Tq, Tk]``, True = masked (filled
    with -1e8 before the softmax). In train mode the attention weights
    take ``dropout``. With ``model_group`` the projections are this
    rank's shards and it attends over its ``n_heads / model`` heads
    (module docstring)."""
    bs, tq, _ = query.shape
    heads = local_heads(n_heads, model_group)
    if model_group is not None:
        # one group-summed gradient per distinct input
        q_in = _col_input(query, model_group)
        k_in = q_in if key is query else _col_input(key, model_group)
        value = k_in if value is key else _col_input(value, model_group)
        query, key = q_in, k_in
    q = L.linear(params["fc_q"], query)
    d = q.shape[-1]
    hd = d // heads

    def split(x):
        return x.reshape(bs, x.shape[1], heads, hd).transpose(1, 2)

    q = split(q)
    k = split(L.linear(params["fc_k"], key))
    v = split(L.linear(params["fc_v"], value))
    energy = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        energy = energy.masked_fill(mask[:, None], MASK_FILL)
    attn = _col_dropout(gen, torch.softmax(energy, dim=-1), dropout, train,
                        model_group, 1)
    out = (attn @ v).transpose(1, 2).reshape(bs, tq, d)
    return _row_linear(params["fc_o"], out, model_group)


def pff_apply(params, x, dropout=0.0, train=False, gen=None,
              model_group=None):
    h = _col_dropout(gen, torch.relu(L.linear(
        params["fc_1"], _col_input(x, model_group))), dropout, train,
        model_group, -1)
    return _row_linear(params["fc_2"], h, model_group)


def get_pad_mask(query_ids, key_ids, pad_index=0):
    """Bool ``[bs, Tq, Tk]``: True where the key position is padding."""
    return (key_ids == pad_index)[:, None, :].expand(
        query_ids.shape[0], query_ids.shape[1], key_ids.shape[1])


def get_autoregressive_mask(bs, seq_len, device):
    """Bool ``[bs, T, T]``: True above the diagonal."""
    tri = torch.ones((seq_len, seq_len), dtype=torch.bool,
                     device=device).triu(1)
    return tri[None].expand(bs, seq_len, seq_len)


def _decoder_layer_apply(params, x, n_heads, enc_out=None, input_mask=None,
                         enc_mask=None, dropout=0.0, train=False, gen=None,
                         model_group=None):
    """One post-LN block: self-attention, cross-attention where the layer
    has it, feed-forward; each sublayer's output takes ``dropout`` before
    its residual add in train mode."""
    attn = mha_apply(params["self_attn"], x, x, x, n_heads, input_mask,
                     dropout, train, gen, model_group)
    x = L.layer_norm(params["self_attn_ln"],
                     x + L.dropout(gen, attn, dropout, train))
    if "enc_attn" in params:
        attn = mha_apply(params["enc_attn"], x, enc_out, enc_out, n_heads,
                         enc_mask, dropout, train, gen, model_group)
        x = L.layer_norm(params["enc_attn_ln"],
                         x + L.dropout(gen, attn, dropout, train))
    ff = pff_apply(params["pf"], x, dropout, train, gen, model_group)
    return L.layer_norm(params["pf_ln"], x + L.dropout(gen, ff, dropout,
                                                      train))


def encoder_layer_init(gen, hid_dim=512, pf_dim=2048, device="cuda"):
    """Post-LN encoder block (the reference's EncoderLayer)."""
    return _layer_init(gen, hid_dim, pf_dim, False, device)


def encoder_layer_apply(params, x, n_heads, input_mask=None, dropout=0.0,
                        train=False, gen=None):
    return _decoder_layer_apply(params, x, n_heads, input_mask=input_mask,
                                dropout=dropout, train=train, gen=gen)


def transformer_encoder_init(gen, num_tokens, hid_dim=512, n_layers=6,
                             pf_dim=2048, max_len=128, device="cuda"):
    """Encoder stack parameters (same tree as the JAX
    ``transformer_encoder_init``)."""
    return {
        "tok_embedding": L.embedding_init(gen, num_tokens, hid_dim, device),
        "pos_embedding": L.embedding_init(gen, max_len, hid_dim, device),
        "layers": [encoder_layer_init(gen, hid_dim, pf_dim, device)
                   for _ in range(n_layers)],
    }


def transformer_encoder_forward(params, tokens, n_heads, pad_index=None,
                                dropout=0.0, train=False, gen=None):
    """Encodes ``tokens [bs, T]`` -> ``[bs, T, hid_dim]``: the working
    form of the reference's encoder, whose forward fails with a mask.
    Token embeddings are divided by sqrt(hid_dim), as the reference does;
    ``pad_index=None`` masks nothing."""
    t = tokens.shape[1]
    table = params["tok_embedding"]["weight"]
    pos_rows = params["pos_embedding"]["weight"].shape[0]
    if t > pos_rows:
        raise ValueError(
            f"positional table has {pos_rows} rows but the sequence needs "
            f"{t}; construct the encoder with max_len >= {t}")
    emb = (L.embed(params["tok_embedding"], tokens) / math.sqrt(table.shape[1])
           + params["pos_embedding"]["weight"][:t])
    x = L.dropout(gen, emb, dropout, train)
    mask = (None if pad_index is None
            else get_pad_mask(tokens, tokens, pad_index))
    for layer in params["layers"]:
        x = encoder_layer_apply(layer, x, n_heads, mask, dropout, train, gen)
    return x


def _decoder_input(params, tokens, start_emb, pad_index, dropout, train,
                   gen):
    """The start embedding then the token embeddings, divided by
    sqrt(hid_dim), plus positions (dropout in train mode); the ids with
    the start position as a real token (id 1); and the self-attention
    mask (pads and the future)."""
    t = tokens.shape[1]
    seq_len = t + 1
    pos_rows = params["pos_embedding"]["weight"].shape[0]
    if seq_len > pos_rows:
        raise ValueError(
            f"positional table has {pos_rows} rows but the sequence needs "
            f"{seq_len}; construct the model with max_len >= {seq_len}")
    emb = torch.cat([start_emb[:, None, :],
                     L.embed(params["tok_embedding"], tokens)], dim=1)
    emb = (emb / math.sqrt(start_emb.shape[-1])
           + params["pos_embedding"]["weight"][:seq_len])
    ids = torch.cat([torch.ones_like(tokens[:, :1]), tokens], dim=1)
    # the causal part is made from ``ids`` (not a fresh tensor), so that
    # with DTensor inputs (tensor parallelism) every operand is a DTensor
    future = ids.new_ones((seq_len, seq_len), dtype=torch.bool).triu(1)
    mask = get_pad_mask(ids, ids, pad_index) | future
    return L.dropout(gen, emb, dropout, train), ids, mask


def transformer_decoder_forward(params, tokens, enc_out, start_emb, n_heads,
                                pad_index=0, dropout=0.0, train=False,
                                gen=None, model_group=None):
    """Teacher-forced forward with cross-attention, as the reference runs
    it: the tokens ``[bs, T]`` (after the start embedding ``[bs, D]`` at
    position 0) and the encoder rows ``enc_out [bs, T_enc, D]`` are padded
    to one length, ``max(T + 1, T_enc)``, and an encoder row counts as a
    key only if every element of it is non-zero (taken after the padding,
    in the decoder's dtype). Raises ``ValueError`` when the positional
    table is shorter than the padded sequence.

    ``model_group``: the tree holds this rank's tensor-parallel shards
    (module docstring).

    Returns logits ``[bs, max(T + 1, T_enc), num_tokens]``.
    """
    t = tokens.shape[1]
    enc_len = enc_out.shape[1]
    seq_len = max(t + 1, enc_len)
    pos_rows = params["pos_embedding"]["weight"].shape[0]
    if seq_len > pos_rows:
        raise ValueError(
            f"positional table has {pos_rows} rows but the padded sequence "
            f"needs {seq_len} (decoder {t + 1}, encoder {enc_len}); "
            f"construct the model with max_len >= {seq_len}")
    tokens = F.pad(tokens, (0, seq_len - t - 1), value=pad_index)
    enc_out = F.pad(enc_out, (0, 0, 0, seq_len - enc_len))
    x, ids, input_mask = _decoder_input(params, tokens, start_emb, pad_index,
                                        dropout, train, gen)
    enc_valid = (enc_out != 0).all(dim=-1).to(torch.int32)
    enc_mask = get_pad_mask(ids, enc_valid, pad_index)
    for layer in params["layers"]:
        x = _decoder_layer_apply(layer, x, n_heads, enc_out, input_mask,
                                 enc_mask, dropout, train, gen, model_group)
    return L.linear(params["classifier"], x)


def self_attn_decoder_forward(params, tokens, start_emb, n_heads,
                              pad_index=0, dropout=0.0, train=False,
                              gen=None, model_group=None):
    """Teacher-forced forward of the decoder-only stack: logits
    ``[bs, T + 1, num_tokens]``; ``model_group`` as in
    :func:`transformer_decoder_forward`."""
    x, _, input_mask = _decoder_input(params, tokens, start_emb, pad_index,
                                      dropout, train, gen)
    for layer in params["layers"]:
        x = _decoder_layer_apply(layer, x, n_heads, input_mask=input_mask,
                                 dropout=dropout, train=train, gen=gen,
                                 model_group=model_group)
    return L.linear(params["classifier"], x)


def init_cache(params, bs, max_positions, dtype=torch.float32):
    """Per-layer K/V caches ``[bs, P, D]``, P = max_positions rounded up to
    a multiple of 8 (the tail is never written and always masked). D is
    the width of the layers' fc_k: ``D / model`` for a tree of
    tensor-parallel shards."""
    width = params["layers"][0]["self_attn"]["fc_k"]["weight"].shape[0]
    dev = params["tok_embedding"]["weight"].device
    p = -(-max_positions // 8) * 8
    return [{"k": torch.zeros((bs, p, width), dtype=dtype, device=dev),
             "v": torch.zeros((bs, p, width), dtype=dtype, device=dev)}
            for _ in params["layers"]]


def precompute_cross_attention(params, enc_out, pad_to_tile=False):
    """Per-layer cross-attention keys/values over the fixed encoder output
    ``[G, T, D]``, computed once per generation (``[G, T, D / model]`` from
    a tree of tensor-parallel shards: the rank's heads).

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


def fuse_qkv(params):
    """``params`` with each layer's self-attention q, k and v projections
    also held fused, as one ``[3D, D]`` weight and ``[3D]`` bias
    (``self_attn["qkv"]``; ``[3D / model, D]`` from a tree of
    tensor-parallel shards), which :func:`decode_step` multiplies by in one
    product. The tree and the layers' dicts are new, the other tensors
    shared; the fused ones are made from the parameters' values now, so a
    generation call makes them once, at its prefill (on the card inside
    the prefill's graph), and reads the parameters as they are when it
    starts."""
    def fused(layer):
        sa = layer["self_attn"]
        qkv = {k: torch.cat([sa[n][k] for n in ("fc_q", "fc_k", "fc_v")])
               for k in ("weight", "bias")}
        return dict(layer, self_attn=dict(sa, qkv=qkv))

    return dict(params, layers=[fused(layer) for layer in params["layers"]])


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




def decode_step(params, token_emb_scaled, pos, cache, self_key_valid,
                n_heads, cross=None, enc_key_mask=None, anc=None, p_eff=None,
                return_hidden=False, live_items=None, canon=None,
                cross_t_real=None, pack_items=None, model_group=None):
    """One incremental decode position; writes K/V at ``pos`` in place.

    Args:
        params: the decoder's parameters; its layers carry the fused QKV
            projection of :func:`fuse_qkv` (generation fuses once per
            call), or the step fuses them itself.
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
        live_items: optional int or 0-d int32 tensor on the device (set by
            a compaction boundary, read by the kernels through a pointer),
            the number of live items (early-EOS compaction keeps them
            first); the kernels skip the rest, whose attention rows are
            zero.
        canon: optional canonical-prefix bundle from the engine's phase
            boundary (``CaptioningTransformer._canonicalize_state``):
            ``{"c": int, "shared": [{"sk", "sv"} per layer],
            "bias_sh": [B, 1, c], "strag_ids": [B], "n_strag": int or
            0-d int32 tensor}`` (the engine's ``strag_rows`` is not read
            here). Self-attention then reads the shared rows below ``c``
            plus the per-slot window ``[c, p_eff)`` (K5); the straggler
            items' rows are recomputed full-width by K6, launched on every
            canon step as in the JAX package, which writes them into K5's
            output in place (none with no straggler: the JAX package
            computes the first listed item there and its row-mask merge
            discards it).
        cross_t_real: the number of valid encoder rows of a tile-padded
            cross store (None: the store is not padded).
        pack_items: with ``anc`` and ``cross_t_real``, cross-attention
            runs K9 (ops.cross_attention_packed) with this many items per
            block where the JAX package's packed kernel would run: above
            1, dividing the groups, T and ``n_heads * rows per group``
            multiples of 8. Elsewhere K2 runs.
        model_group: the process group of the ``model`` mesh axis when
            ``params`` holds this rank's tensor-parallel shards; the caches
            and the cross store are then ``D / model`` wide, the kernels
            run over ``n_heads / model`` heads, and the fc_o / fc_2 partial
            sums are all-reduced over it (module docstring). None: one
            card, whole weights.

    Returns:
        (logits ``[bs, V]`` or hidden ``[bs, D]``, cache)
    """
    if "qkv" not in params["layers"][0]["self_attn"]:
        params = fuse_qkv(params)
    x = token_emb_scaled + params["pos_embedding"]["weight"][pos]
    heads = local_heads(n_heads, model_group)
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
                and heads * (x.shape[0] // groups) % 8 == 0):
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
    for i, layer in enumerate(params["layers"]):
        sa = layer["self_attn"]
        # fused QKV projection: one [3D, D] matmul instead of three (over a
        # model group, of this rank's shards: [3D / model, D]); q, k and v
        # are views of its columns, rows 3D apart, which the kernels read
        # in place
        w, b = sa["qkv"]["weight"], sa["qkv"]["bias"]
        q, k, v = F.linear(x, w, b).split(w.shape[0] // 3, -1)
        ck, cv = cache[i]["k"], cache[i]["v"]
        if canon is not None:
            beam = anc.shape[1]
            sh = canon["shared"][i]
            attn = ancestry_attention_update_canon(
                q, ck, cv, sh["sk"], sh["sv"], k, v, canon["bias_sh"],
                bias_win, pos, beam=beam, n_heads=heads, c=canon["c"],
                p_eff=pe, live_items=live_items)
            # the stragglers' rows, full width, written over K5's
            ancestry_attention_ids(
                q, ck, cv, anc_bias, canon["strag_ids"], canon["n_strag"],
                beam=beam, n_heads=heads, p_eff=p_eff, out=attn)
        elif anc_bias is not None:
            attn = ancestry_attention_update(
                q, ck, cv, k, v, anc_bias, pos, beam=anc.shape[1],
                n_heads=heads, p_eff=p_eff, live_items=live_items)
        else:
            ck[:, pos] = k
            cv[:, pos] = v
            attn = _cached_attention(q, ck, cv, heads, ~valid)
        x = L.layer_norm(layer["self_attn_ln"],
                         x + _row_linear(sa["fc_o"], attn, model_group))

        if "enc_attn" in layer:
            ea = layer["enc_attn"]
            attn = grouped_cross_attention(
                L.linear(ea["fc_q"], x), cross[i]["ek"], cross[i]["ev"],
                cross_bias, n_heads=heads, live_items=live_items,
                pack_items=pack, t_real=cross_t_real if pack else None)
            x = L.layer_norm(layer["enc_attn_ln"],
                             x + _row_linear(ea["fc_o"], attn, model_group))
        x = L.layer_norm(layer["pf_ln"], x + pff_apply(
            layer["pf"], x, model_group=model_group))
    if return_hidden:
        return x, cache
    return L.linear(params["classifier"], x), cache
