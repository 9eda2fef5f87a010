"""DeepSeek-V3's decoder block, as Kimi-VL's language model runs it: RMSNorm,
multi-head latent attention (MLA) with decoupled rotary positions, and a
sparse expert layer with shared experts (after ``first_dense`` dense
layers).

Per layer, with x the residual stream (pre-norm residuals):

- MLA: ``h = rms(x)``; ``q = W_q h`` gives each head ``[q_nope | q_pe]``;
  ``[c | k_pe] = W_kva h``, ``c = rms_kv(c)``; q_pe and k_pe rotate by
  position (pairs of adjacent dimensions, :func:`rope`); ``[k_nope |
  v]_head = W_kvb c``; each head's energy is ``(q_nope . k_nope + q_pe .
  k_pe) / sqrt(nope + rope)``, causal softmax, ``o = W_o concat(p . v)``.
- FFN: the dense SwiGLU, or the expert layer (ops/moe.py): sigmoid
  routing over every routed expert with a correction bias in the
  selection only, the held experts' SwiGLUs weighted by the normalised
  unbiased scores times a scaling factor, plus the shared experts (one
  SwiGLU of their summed width).

Then a final RMSNorm and an untied classifier.

A position caches one latent row ``[c | k_pe]`` a layer (``kv_lora_rank +
qk_rope`` values), not per-head keys and values. The prefill runs each
item's prefix rows (the image prefix) through every layer in the
unabsorbed form above and writes their latent rows once per item. A
decode step runs the absorbed form: ``q_lat = W_kvb,k,headᵀ q_nope``
against the latent rows and ``out = W_kvb,v,head (p . c)``, the attention
itself in K12 (ops/attention.py ``mla_attention``) over the item's prefix
rows and the generated rows of its beam slots that the branch's ancestry
selects (the slots' rows are never reordered, as the transformers'
caches: models/transformer.py).

A layer holds the routed experts ``held_first .. held_first + n_held``
(one card's share under expert parallelism; all of them when
``n_held`` equals ``n_routed``): it routes over every expert and adds only
its own experts' part. The parameter tree (``init_decoder``):

    tok_embedding.weight [V, D]
    layers[i]: attn_norm.weight [D], ffn_norm.weight [D],
        attn: q_proj.weight [H (nope + rope), D],
              kv_a_proj.weight [rank + rope, D], kv_norm.weight [rank],
              kv_b_proj.weight [H (nope + v), rank], o_proj.weight [D, H v]
        ffn (dense): gate_up.weight [2 F, D] (gate rows, then up),
              down.weight [D, F]
        ffn (experts): gate.weight [E, D], gate.e_bias [E],
              experts.gate_up [held, 2 I, D], experts.down [held, D, I],
              shared.gate_up.weight [2 S, D], shared.down.weight [D, S]
    norm.weight [D]; classifier.weight [V, D], classifier.bias [V]
"""

import math

import torch
import torch.nn.functional as F

from deephumor_tpu_torch.ops import moe
from deephumor_tpu_torch.ops.attention import mla_attention
from deephumor_tpu_torch.utils import profiling

__all__ = ["rms_norm", "rope_angles", "rope", "init_decoder", "prefill",
           "decode_step", "absorbed"]

# prefix tokens a prefill pass takes at once (items in chunks): bounds the
# expert layer's pair buffers
PREFILL_TOKENS = 8192


def rms_norm(x, w, eps):
    """DeepSeek-V3's RMSNorm over the last axis (``F.rms_norm``: one fused
    pass on the card, the statistics in f32)."""
    return F.rms_norm(x, x.shape[-1:], w, eps)


def rope_angles(pos, dim, theta, device):
    """(cos, sin) ``[..., dim / 2]`` f32 of positions ``pos`` (an int or an
    integer tensor): pair i turns by ``pos * theta ** (-2 i / dim)``."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device,
                                       dtype=torch.float32) / dim)
    ang = (pos[..., None].float() if isinstance(pos, torch.Tensor)
           else pos) * inv
    return ang.cos(), ang.sin()


def rope(x, cos, sin):
    """``x [..., dim]`` with each pair of adjacent dimensions (2i, 2i + 1)
    rotated by its angle (``cos``/``sin`` broadcast to ``[..., dim / 2]``),
    in f32, cast back. DeepSeek-V3's modelling code permutes the
    dimensions to [evens | odds] before its rotate-half rotation, in q and
    k alike: the same dot products."""
    xf = x.float().unflatten(-1, (x.shape[-1] // 2, 2))
    a, b = xf[..., 0], xf[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       -1).flatten(-2).to(x.dtype)


def init_decoder(m, gen, device):
    """Random parameters of model ``m`` (a ``CaptioningMLAMoE``) drawn from
    ``gen``: Kaiming-uniform linears, unit-normal embeddings, norms at
    one, correction biases uniform in +-0.05."""
    def lin(d_out, d_in, *lead):
        bound = 1.0 / math.sqrt(d_in)
        return (torch.rand(*lead, d_out, d_in, generator=gen, device=device)
                * 2 - 1) * bound

    d, h = m.hid_dim, m.n_heads
    layers = []
    for i in range(m.n_layers):
        attn = {"q_proj": {"weight": lin(h * (m.qk_nope + m.qk_rope), d)},
                "kv_a_proj": {"weight": lin(m.kv_rank + m.qk_rope, d)},
                "kv_norm": {"weight": torch.ones(m.kv_rank, device=device)},
                "kv_b_proj": {"weight": lin(h * (m.qk_nope + m.v_dim),
                                            m.kv_rank)},
                "o_proj": {"weight": lin(d, h * m.v_dim)}}
        if i < m.first_dense:
            ffn = {"gate_up": {"weight": lin(2 * m.dense_width, d)},
                   "down": {"weight": lin(d, m.dense_width)}}
        else:
            s = m.n_shared * m.expert_width
            ffn = {"gate": {"weight": lin(m.n_routed, d),
                            "e_bias": (torch.rand(m.n_routed, generator=gen,
                                                  device=device) * 2 - 1)
                            * 0.05},
                   "experts": {"gate_up": lin(2 * m.expert_width, d,
                                              m.n_held),
                               "down": lin(d, m.expert_width, m.n_held)},
                   "shared": {"gate_up": {"weight": lin(2 * s, d)},
                              "down": {"weight": lin(d, s)}}}
        layers.append({"attn_norm": {"weight": torch.ones(d, device=device)},
                       "ffn_norm": {"weight": torch.ones(d, device=device)},
                       "attn": attn, "ffn": ffn})
    return {"tok_embedding": {"weight": torch.randn(
                m.num_tokens, d, generator=gen, device=device)},
            "layers": layers,
            "norm": {"weight": torch.ones(d, device=device)},
            "classifier": {"weight": lin(m.num_tokens, d),
                           "bias": torch.zeros(m.num_tokens, device=device)}}


def _latent(m, attn, h, cos, sin):
    """(q_nope ``[..., H, nope]``, rotated q_pe ``[..., H, rope]``, latent
    rows ``[..., rank + rope]``) of ``h``; ``cos``/``sin`` broadcast to
    the keys' ``[..., rope / 2]``."""
    q = F.linear(h, attn["q_proj"]["weight"]).unflatten(
        -1, (m.n_heads, m.qk_nope + m.qk_rope))
    q_nope, q_pe = q.split([m.qk_nope, m.qk_rope], -1)
    c, k_pe = F.linear(h, attn["kv_a_proj"]["weight"]).split(
        [m.kv_rank, m.qk_rope], -1)
    c = rms_norm(c, attn["kv_norm"]["weight"], m.rms_eps)
    return (q_nope, rope(q_pe, cos[..., None, :], sin[..., None, :]),
            torch.cat([c, rope(k_pe, cos, sin)], -1))


def _ffn(m, ffn, h, tally):
    """The layer's feed-forward of ``h`` ``[..., D]``: the dense SwiGLU,
    or the shared experts plus the held experts' part, summed in f32."""
    if "experts" not in ffn:
        return moe.swiglu(h, ffn["gate_up"]["weight"], ffn["down"]["weight"])
    shape, h2 = h.shape, h.reshape(-1, h.shape[-1])
    ids, w = moe.route(h2, ffn["gate"]["weight"], ffn["gate"]["e_bias"],
                       top_k=m.experts_per_token, scaling=m.routed_scaling)
    order, offs, mask, counts = moe.dispatch(ids, m.held_first, m.n_held)
    x = moe.gather_pairs(h2, order, offs, m.experts_per_token)
    y = moe.expert_products(x, ffn["experts"]["gate_up"],
                            ffn["experts"]["down"], offs)
    out = moe.combine(y, order, mask, w, moe.swiglu(
        h2, ffn["shared"]["gate_up"]["weight"],
        ffn["shared"]["down"]["weight"]))
    moe.note(counts, ids.numel(), tally)
    return out.reshape(shape)


def prefill(m, dec, prefix):
    """Runs each item's prefix rows ``[B, T0, D]`` (compute dtype) through
    every layer, ``PREFILL_TOKENS`` at a time: (the last row's hidden
    state after the final norm ``[B, D]``, the latent rows ``[B, T0, rank +
    rope]`` of each layer)."""
    with profiling.span("mla_moe.prefill"):
        b, t0, d = prefix.shape
        dev, dt = prefix.device, prefix.dtype
        tally = moe.moe_tally(dev)
        cos, sin = rope_angles(torch.arange(t0, device=dev), m.qk_rope,
                               m.rope_theta, dev)
        causal = torch.ones(t0, t0, dtype=torch.bool, device=dev).triu(1)
        scale = 1.0 / math.sqrt(m.qk_nope + m.qk_rope)
        lat = [prefix.new_empty((b, t0, m.kv_rank + m.qk_rope))
               for _ in dec["layers"]]
        last = prefix.new_empty((b, d))
        step = max(1, PREFILL_TOKENS // t0)
        for i in range(0, b, step):
            x = prefix[i:i + step]
            n = x.shape[0]
            for li, layer in enumerate(dec["layers"]):
                attn = layer["attn"]
                h = rms_norm(x, layer["attn_norm"]["weight"], m.rms_eps)
                q_nope, q_pe, rows = _latent(m, attn, h, cos, sin)
                lat[li][i:i + n] = rows
                kv = F.linear(rows[..., :m.kv_rank],
                              attn["kv_b_proj"]["weight"]).unflatten(
                    -1, (m.n_heads, m.qk_nope + m.v_dim))
                k_nope, v = kv.split([m.qk_nope, m.v_dim], -1)
                # q_nope . k_nope per head plus q_pe . k_pe (one k_pe for
                # every head), in f32
                e = (q_nope.transpose(1, 2).float()
                     @ k_nope.permute(0, 2, 3, 1).float()
                     + q_pe.transpose(1, 2).float()
                     @ rows[:, None, :, m.kv_rank:].transpose(-1, -2).float()
                     ) * scale
                p = torch.softmax(e.masked_fill(causal, -math.inf), -1)
                o = (p.to(dt) @ v.transpose(1, 2)).transpose(1, 2)
                x = x + F.linear(o.reshape(n, t0, -1),
                                 attn["o_proj"]["weight"])
                x = x + _ffn(m, layer["ffn"], rms_norm(
                    x, layer["ffn_norm"]["weight"], m.rms_eps), tally)
            last[i:i + n] = x[:, -1]
        return rms_norm(last, dec["norm"]["weight"], m.rms_eps), lat


def absorbed(m, dec):
    """Per layer, the key and value halves of kv_b_proj as ``[H, nope,
    rank]`` and ``[H, v, rank]`` views (no copy)."""
    out = []
    for layer in dec["layers"]:
        w = layer["attn"]["kv_b_proj"]["weight"].view(
            m.n_heads, m.qk_nope + m.v_dim, m.kv_rank)
        out.append((w[:, :m.qk_nope], w[:, m.qk_nope:]))
    return out


def decode_step(m, dec, absorbed_w, x, s, prefix, gen, bias, beam):
    """One decode step of every branch: ``x [R, D]`` the fed tokens'
    embeddings at position ``T0 + s - 1`` (R = items x beam), their latent
    rows written at generated position ``s - 1`` of each layer's ``gen``
    ``[R, S, rank + rope]``, then K12 over each item's ``prefix`` rows and
    the generated rows below ``s`` that ``bias`` (ops/attention.py
    ``ancestry_bias`` over the slots' positions) selects. Returns the last
    hidden state after the final norm ``[R, D]``."""
    r, t0 = x.shape[0], prefix[0].shape[1]
    dev = x.device
    tally = moe.moe_tally(dev)
    cos, sin = rope_angles(t0 + s - 1, m.qk_rope, m.rope_theta, dev)
    scale = 1.0 / math.sqrt(m.qk_nope + m.qk_rope)
    for li, layer in enumerate(dec["layers"]):
        attn = layer["attn"]
        h = rms_norm(x, layer["attn_norm"]["weight"], m.rms_eps)
        q_nope, q_pe, rows = _latent(m, attn, h, cos, sin)
        gen[li][:, s - 1] = rows
        wk, wv = absorbed_w[li]
        # head-major, as the batched products take and give them
        q_lat = torch.bmm(q_nope.transpose(0, 1), wk)
        o = mla_attention(q_lat, q_pe, prefix[li], gen[li], bias, beam=beam,
                          pe=s, scale=scale)
        o = torch.bmm(o, wv.transpose(1, 2)).transpose(0, 1)
        x = x + F.linear(o.reshape(r, -1), attn["o_proj"]["weight"])
        x = x + _ffn(m, layer["ffn"], rms_norm(
            x, layer["ffn_norm"]["weight"], m.rms_eps), tally)
    return rms_norm(x, dec["norm"]["weight"], m.rms_eps)
