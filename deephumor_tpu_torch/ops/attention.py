"""Decode-time attention: the K1 and K2 kernel wrappers and their twins.

Counterparts of deephumor_tpu/ops/pallas_attention.py. Each wrapper
launches its CUDA kernel (ops/csrc/) for CUDA tensors and runs its plain
PyTorch twin for CPU tensors; anything else raises. The twins compute in
f32 and round the softmax weights to the value dtype before the AV
product, as the kernels do.
"""

import math

import torch

from deephumor_tpu_torch.ops import _build

__all__ = ["MASK_FILL", "ancestry_bias", "ancestry_attention_update",
           "ancestry_attention_update_plain", "grouped_cross_attention",
           "grouped_cross_attention_plain"]

MASK_FILL = -1e8


def ancestry_bias(anc, valid, p):
    """Additive selection bias from ancestry + validity.

    Args:
        anc: ``[B, beam, P]`` int -- anc[b, j, pos] = physical slot that
            holds branch j's key at ``pos``.
        valid: bool ``[B*beam, P]`` -- branch-local position validity.
        p: the cache length P (= anc.shape[-1]).

    Returns:
        ``[B, beam, beam*P]`` f32: 0 at (slot i, position pos) iff
        ``anc[b, j, pos] == i`` and the position is valid, -1e8 elsewhere.
    """
    b, beam, _ = anc.shape
    slots = torch.arange(beam, device=anc.device)
    sel = anc[:, :, None, :] == slots[None, None, :, None]   # [B, j, i, pos]
    sel = sel & valid.reshape(b, beam, 1, p)
    return torch.where(sel, 0.0, MASK_FILL).to(torch.float32).reshape(
        b, beam, beam * p)


def _check_update(q, cache_k, cache_v, k_new, v_new, bias, pos, beam,
                  n_heads):
    rows, p, d = cache_k.shape
    if cache_v.shape != cache_k.shape:
        raise ValueError("cache_k and cache_v shapes differ")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.shape != (rows, d):
            raise ValueError(f"{name} must be [{rows}, {d}], got "
                             f"{tuple(t.shape)}")
    if len({t.dtype for t in (q, cache_k, cache_v, k_new, v_new)}) != 1:
        raise ValueError("q, caches and k_new/v_new must share one dtype")
    if rows % beam or d % n_heads:
        raise ValueError(f"rows {rows} / beam {beam} or D {d} / heads "
                         f"{n_heads} do not divide")
    if bias.dtype != torch.float32 or bias.shape != (rows // beam, beam,
                                                      beam * p):
        raise ValueError(f"bias must be f32 [{rows // beam}, {beam}, "
                         f"{beam * p}], got {bias.dtype} {tuple(bias.shape)}")
    if not 0 <= pos < p:
        raise ValueError(f"pos {pos} outside the cache length {p}")


def ancestry_attention_update_plain(q, cache_k, cache_v, k_new, v_new, bias,
                                    pos, *, beam, n_heads, p_eff=None):
    """Plain PyTorch twin of :func:`ancestry_attention_update`."""
    rows, p, d = cache_k.shape
    b, hd = rows // beam, d // n_heads
    pe = p if p_eff is None else min(p_eff, p)
    cache_k[:, pos] = k_new
    cache_v[:, pos] = v_new
    k = cache_k[:, :pe].float().reshape(b, beam, pe, n_heads, hd)
    v = cache_v[:, :pe].float().reshape(b, beam, pe, n_heads, hd)
    qf = q.float().reshape(b, beam, n_heads, hd)
    e = torch.einsum("bjhd,biphd->bjhip", qf, k) * (1.0 / math.sqrt(hd))
    e = e + bias.reshape(b, beam, 1, beam, p)[..., :pe]
    w = torch.softmax(e.reshape(b, beam, n_heads, beam * pe), dim=-1)
    w = w.to(q.dtype).float().reshape(b, beam, n_heads, beam, pe)
    out = torch.einsum("bjhip,biphd->bjhd", w, v)
    return out.reshape(rows, d).to(q.dtype)


def ancestry_attention_update(q, cache_k, cache_v, k_new, v_new, bias, pos,
                              *, beam, n_heads, p_eff=None):
    """K1: writes (k_new, v_new) at ``pos``, then ancestry attention.

    The caches are updated IN PLACE: ``cache_k[:, pos] = k_new`` and
    ``cache_v[:, pos] = v_new``. Each branch j of an item then attends,
    per head, over every (slot i, position p < p_eff) of its item's caches
    with ``bias`` (:func:`ancestry_bias`) added to the scaled energies.

    Args:
        q, k_new, v_new: ``[B*beam, D]``.
        cache_k, cache_v: ``[B*beam, P, D]``, the same dtype as ``q``.
        bias: f32 ``[B, beam, beam*P]``.
        pos: int decode position, ``0 <= pos < P``.
        p_eff: read only the first ``p_eff`` cache positions (every valid
            position must lie below it).

    Returns:
        attention output ``[B*beam, D]`` (before the output projection).
    """
    name = "ancestry_attention_update"
    _check_update(q, cache_k, cache_v, k_new, v_new, bias, pos, beam,
                  n_heads)
    kw = dict(beam=beam, n_heads=n_heads, p_eff=p_eff)
    if not _build.on_kernel_device(name, q, cache_k, cache_v, k_new, v_new,
                                   bias):
        return ancestry_attention_update_plain(
            q, cache_k, cache_v, k_new, v_new, bias, pos, **kw)
    rows, p, d = cache_k.shape
    _build.check_vector_rows(name, d // n_heads, cache_k, cache_v, k_new,
                             v_new)
    pe = p if p_eff is None else min(p_eff, p)
    out = torch.empty_like(q)
    err = _build.library().dh_ancestry_attention_update(
        _build.dtype_code(q, name), q.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        bias.data_ptr(), out.data_ptr(), rows // beam, beam, p, pe, d,
        n_heads, pos, 1.0 / math.sqrt(d // n_heads), _build.stream_of(q))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def grouped_cross_attention_plain(q, ek, ev, bias, *, n_heads):
    """Plain PyTorch twin of :func:`grouped_cross_attention`."""
    g, t, d = ek.shape
    r, hd = q.shape[0] // g, d // n_heads
    qf = q.float().reshape(g, r, n_heads, hd)
    k = ek.float().reshape(g, t, n_heads, hd)
    v = ev.float().reshape(g, t, n_heads, hd)
    e = torch.einsum("grhd,gthd->grht", qf, k) * (1.0 / math.sqrt(hd))
    if bias is not None:
        e = e + bias.reshape(g, 1, 1, t)
    w = torch.softmax(e, dim=-1).to(q.dtype).float()
    out = torch.einsum("grht,gthd->grhd", w, v)
    return out.reshape(g * r, d).to(q.dtype)


def grouped_cross_attention(q, ek, ev, bias, *, n_heads):
    """K2: single-query cross-attention of ``G*r`` rows over per-group K/V.

    Args:
        q: ``[G*r, D]`` pre-projected queries (r rows per group).
        ek, ev: ``[G, T, D]`` pre-projected encoder keys/values, the dtype
            of ``q``.
        bias: f32 ``[G, 1, T]`` additive mask (0 or -1e8), or None.

    Returns:
        ``[G*r, D]`` attention output (before the output projection).
    """
    name = "grouped_cross_attention"
    g, t, d = ek.shape
    if ev.shape != ek.shape or q.ndim != 2 or q.shape[1] != d or (
            q.shape[0] % g) or d % n_heads:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, ek "
                         f"{tuple(ek.shape)}, ev {tuple(ev.shape)}")
    if len({q.dtype, ek.dtype, ev.dtype}) != 1:
        raise ValueError(f"{name}: q, ek and ev must share one dtype")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (g, 1, t)):
        raise ValueError(f"{name}: bias must be f32 [{g}, 1, {t}]")
    tensors = (q, ek, ev) if bias is None else (q, ek, ev, bias)
    if not _build.on_kernel_device(name, *tensors):
        return grouped_cross_attention_plain(q, ek, ev, bias,
                                             n_heads=n_heads)
    _build.check_vector_rows(name, d // n_heads, ek, ev)
    out = torch.empty_like(q)
    err = _build.library().dh_grouped_cross_attention(
        _build.dtype_code(q, name), q.data_ptr(), ek.data_ptr(),
        ev.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), g, q.shape[0] // g, t, d, n_heads,
        1.0 / math.sqrt(d // n_heads), _build.stream_of(q))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
