"""Kimi-VL-A3B-Instruct's language model (DeepSeek-V3's decoder block),
teacher-forced over served tokens after an image prefix: the plain f32
reference of the ``kimi_vl`` configuration. Plain ``torch`` and nothing
of the program: no cache, no absorption of kv_b_proj, no batching of
pairs by expert.

Per layer (HF ``modeling_deepseek_v3``, as Kimi-VL's config.json sets
it: no q LoRA, ``noaux_tc`` routing with one group, no rope scaling, no
attention bias), with x the residual stream:

- ``h = rms(x)`` (RMSNorm: normalised in f32, scaled by its weight);
- ``q = q_proj h`` gives each head ``[q_nope | q_pe]``; ``[c | k_pe] =
  kv_a_proj h``; ``c = rms_kv(c)``; ``[k_nope | v] = kv_b_proj c`` per
  head; q_pe and k_pe (one for all heads) rotate by position with
  ``theta ** (-2 i / 64)``;
- energies ``(q_nope . k_nope + q_pe . k_pe) / sqrt(192)``, causal
  softmax, ``x += o_proj concat(p . v)``;
- ``h = rms(x)``; layer 0: ``x += down(silu(gate h) * up h)``; the
  others: ``s = sigmoid(router h)`` over all routed experts, the top
  ``k`` of ``s + e_bias``, weights ``s`` there over their sum times the
  scaling factor, ``x += sum_held w_e expert_e(h) + shared(h)``;
- a final RMSNorm and the head.

Departures from the published block, each shared with the program:

- rotary pairs are adjacent dimensions (2i, 2i + 1) rotated in place;
  the HF code permutes q_pe and k_pe to [evens | odds] and rotates
  halves: the same dot products;
- only the held experts (``held_first`` .. + ``n_held``, one card's share
  of an expert-parallel deployment) add their part; the router keeps all
  its outputs and its ``k``;
- each gate and up projection pair is one ``gate_up`` weight (gate rows
  first), and the shared experts are one SwiGLU of their summed width
  (the published two shared experts are one MLP of width 2 x 1,408 there
  too);
- the head has a bias (zero but at EOS, where the harness sets it and
  zeroes EOS's weight row, so that captions end), which the published
  untied head lacks.

``precision="fp8"`` is the control: every product's two operands rounded
to float8 e4m3 with a per-tensor scale (reference/captioner.py ``fp8``).
The work runs layer by layer over the whole block of sequences, so that
32 captions at a time fit beside the program's weights.
"""

import math

import torch

from perfbench.reference.captioner import fp8


class _Math:
    def __init__(self, precision):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.round = fp8 if precision == "fp8" else (lambda x: x)

    def mm(self, x, w):
        """``x @ w.T`` of f32 operands (rounded in fp8)."""
        return self.round(x.float()) @ self.round(w.float()).T

    def matmul(self, a, b):
        return self.round(a) @ self.round(b)


def rms(x, w, eps):
    return w.float() * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                        + eps))


def rotate(x, pos, theta):
    """``x [..., L, (H,) d]`` with pairs (2i, 2i + 1) turned by ``pos *
    theta ** (-2 i / d)`` (``pos [L]``)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv
    if x.ndim == 4:  # [B, L, H, d]
        ang = ang[:, None]
    cos, sin = ang.cos(), ang.sin()
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       -1).flatten(-2)


def swiglu(m, x, gate_up, down):
    gu = m.mm(x, gate_up)
    i = gu.shape[-1] // 2
    return m.mm(torch.nn.functional.silu(gu[..., :i]) * gu[..., i:], down)


def attention(m, a, h, hp):
    b, length, _ = h.shape
    heads, nope, rope = hp["heads"], hp["nope"], hp["rope"]
    rank, vd = hp["rank"], hp["v"]
    pos = torch.arange(length, device=h.device)
    q = m.mm(h, a["q_proj"]["weight"]).reshape(b, length, heads, nope + rope)
    kva = m.mm(h, a["kv_a_proj"]["weight"])
    c = rms(kva[..., :rank], a["kv_norm"]["weight"], hp["eps"])
    k_pe = rotate(kva[..., rank:], pos, hp["theta"])
    kv = m.mm(c, a["kv_b_proj"]["weight"]).reshape(b, length, heads,
                                                   nope + vd)
    qh = torch.cat([q[..., :nope], rotate(q[..., nope:], pos, hp["theta"])],
                   -1).transpose(1, 2)
    kh = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(
        b, length, heads, rope)], -1).transpose(1, 2)
    vh = kv[..., nope:].transpose(1, 2)
    e = m.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(nope + rope)
    future = torch.ones(length, length, dtype=torch.bool,
                        device=h.device).triu(1)
    p = torch.softmax(e.masked_fill(future, -math.inf), -1)
    o = m.matmul(p, vh).transpose(1, 2).reshape(b, length, heads * vd)
    return m.mm(o, a["o_proj"]["weight"])


def experts(m, f, h, hp):
    """The held experts' part plus the shared experts of ``h [N, D]``."""
    s = torch.sigmoid(m.mm(h, f["gate"]["weight"]))
    ids = torch.topk(s + f["gate"]["e_bias"].float(), hp["k"],
                     dim=-1).indices
    w = s.gather(-1, ids)
    w = w / w.sum(-1, keepdim=True) * hp["scaling"]
    out = swiglu(m, h, f["shared"]["gate_up"]["weight"],
                 f["shared"]["down"]["weight"])
    for e in range(hp["held"]):
        tok, slot = torch.nonzero(ids == hp["first"] + e, as_tuple=True)
        if tok.numel():
            y = swiglu(m, h[tok], f["experts"]["gate_up"][e],
                       f["experts"]["down"][e])
            out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def logits(dec, prefix, tokens, hp, precision="f32"):
    """Logits ``[B, L, V]`` (f32) of the served ``tokens [B, L]`` after the
    prefix rows ``prefix [B, T0, D]``: the row at the prefix's last
    position scores token 0, the row at token p - 1 scores token p.
    ``hp``: heads, nope, rope, v, rank, eps, theta, k, scaling, first,
    held."""
    m = _Math(precision)
    b, length = tokens.shape
    t0 = prefix.shape[1]
    x = torch.cat([prefix.float(), dec["tok_embedding"]["weight"][
        tokens[:, :length - 1]].float()], 1)
    for layer in dec["layers"]:
        x = x + attention(m, layer["attn"],
                          rms(x, layer["attn_norm"]["weight"], hp["eps"]), hp)
        h = rms(x, layer["ffn_norm"]["weight"], hp["eps"])
        f = layer["ffn"]
        if "experts" in f:
            x = x + experts(m, f, h.reshape(-1, h.shape[-1]), hp).reshape(
                h.shape)
        else:
            x = x + swiglu(m, h, f["gate_up"]["weight"], f["down"]["weight"])
    x = rms(x[:, t0 - 1:], dec["norm"]["weight"], hp["eps"])
    return m.mm(x, dec["classifier"]["weight"]) + dec["classifier"][
        "bias"].float()
