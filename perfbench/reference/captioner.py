"""The captioner's decoder, teacher-forced over served tokens, and the
gaps that judge a served token.

Architecture (DeepHumor's ``TransformerDecoder`` with the spatial
encoder): the start embedding, then the embeddings of the tokens, each
divided by sqrt(hid_dim), plus learned positions; per layer, post-LN
self-attention (causal; a key whose token is the pad is masked),
post-LN cross-attention over the item's encoder rows (a row holding a
zero is masked), post-LN ReLU feed-forward; a linear classifier. Masked
energies are filled with -1e8 before the softmax. Position 0 reads the
start embedding and gives the first token's logits; position p reads the
(p-1)-th served token and gives the p-th token's.

``precision="fp8"`` is the control: every product's two operands
rounded to float8 e4m3 with a per-tensor scale (the tensor's largest
magnitude at 448), the step below the program's bf16.
"""

import math

import torch

MASK_FILL = -1e8
FP8_MAX = 448.0


def fp8(x):
    """``x`` rounded to float8 e4m3 with a per-tensor scale, back in f32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Math:
    """The products of one precision: f32, or operands in fp8."""

    def __init__(self, precision="f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.round = fp8 if precision == "fp8" else (lambda x: x)

    def linear(self, p, x):
        return self.round(x) @ self.round(p["weight"]).T + p["bias"]

    def matmul(self, a, b):
        return self.round(a) @ self.round(b)


def layer_norm(p, x, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["weight"] + p["bias"]


def attention(m, p, x, kv, n_heads, masked):
    """Multi-head attention of ``x [B, L, D]`` over ``kv [B, T, D]``;
    ``masked [B, L, T]`` True where a key is masked."""
    b, length, d = x.shape
    hd = d // n_heads

    def heads(t):
        return t.reshape(b, t.shape[1], n_heads, hd).transpose(1, 2)

    q = heads(m.linear(p["fc_q"], x))
    k = heads(m.linear(p["fc_k"], kv))
    v = heads(m.linear(p["fc_v"], kv))
    energy = m.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    energy = energy.masked_fill(masked[:, None], MASK_FILL)
    out = m.matmul(torch.softmax(energy, dim=-1), v)
    return m.linear(p["fc_o"], out.transpose(1, 2).reshape(b, length, d))


def decoder_logits(dec, start, spatial, tokens, n_heads, pad_index=0,
                   precision="f32"):
    """Logits ``[B, L, V]`` (f32) of the served ``tokens [B, L]`` after
    the start embedding ``start [B, D]``, attending over ``spatial [B, T,
    D]``: the row at position p scores the token served at p."""
    m = Math(precision)
    b, length = tokens.shape
    d = start.shape[-1]
    fed = tokens[:, :length - 1]
    emb = torch.cat([start[:, None], dec["tok_embedding"]["weight"][fed]], 1)
    x = emb / math.sqrt(d) + dec["pos_embedding"]["weight"][:length]
    key_ok = torch.cat([torch.ones_like(fed[:, :1], dtype=torch.bool),
                        fed != pad_index], 1)
    future = torch.ones(length, length, dtype=torch.bool,
                        device=x.device).triu(1)
    self_masked = future[None] | ~key_ok[:, None, :]
    enc_masked = (spatial == 0).any(-1)[:, None, :].expand(
        b, length, spatial.shape[1])
    for layer in dec["layers"]:
        x = layer_norm(layer["self_attn_ln"], x + attention(
            m, layer["self_attn"], x, x, n_heads, self_masked))
        x = layer_norm(layer["enc_attn_ln"], x + attention(
            m, layer["enc_attn"], x, spatial, n_heads, enc_masked))
        ff = m.linear(layer["pf"]["fc_2"],
                      torch.relu(m.linear(layer["pf"]["fc_1"], x)))
        x = layer_norm(layer["pf_ln"], x + ff)
    return m.linear(dec["classifier"], x)


def served_lengths(tokens, eos_index):
    """How many positions of each served sequence ``[B, L]`` carry a
    drawn token: through the first EOS, or all of them."""
    length = tokens.shape[1]
    is_eos = tokens == eos_index
    first = torch.where(is_eos.any(1), is_eos.int().argmax(1) + 1,
                        torch.full_like(tokens[:, 0], length))
    return first


def support_gaps(logits, tokens, lengths, top_k, unk_index):
    """By how much each served token's logit lies below the edge of the
    reference's top-k support (the k-th largest logit, ties kept, UNK
    ranked but never served): ``[B, L]``, +inf for UNK, NaN at positions
    past ``lengths``. A token inside the support reads <= 0."""
    edge = logits.topk(top_k, dim=-1).values[..., -1]
    tok = logits.gather(-1, tokens[..., None])[..., 0]
    gap = torch.where(tokens == unk_index, math.inf, edge - tok)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return torch.where(pos[None] < lengths[:, None], gap, math.nan)


def control_gaps(ref_logits, ctl_logits, lengths, top_k, unk_index,
                 inv_t, gen):
    """The control in the program's place: at each position of the same
    prompts and tokens, one token drawn from the lower precision's top-k
    support at temperature 1/``inv_t`` (Gumbel, from ``gen``), read
    against the reference's support as :func:`support_gaps` reads a
    served token."""
    vals, idx = ctl_logits.topk(top_k, dim=-1)
    vals = vals.masked_fill(idx == unk_index, -math.inf)
    u = torch.rand(vals.shape, generator=gen, device=vals.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    pick = (vals * inv_t + g).argmax(-1, keepdim=True)
    drawn = idx.gather(-1, pick)[..., 0]
    return support_gaps(ref_logits, drawn, lengths, top_k, unk_index)


def tail_faults(tokens, lengths, pad_index):
    """Positions past a sequence's first EOS that hold another token than
    the pad."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    past = pos[None] >= lengths[:, None]
    return int((past & (tokens != pad_index)).sum())
