"""Exact keep-ties top-k + Gumbel-top-k sampling: the K3 wrapper and its
plain twin.

Counterpart of deephumor_tpu/ops/pallas_sampler.py's
``fused_topk_gumbel_sample``. The TPU kernel draws its noise from the
on-core PRNG; here the noise is a counter-based hash of (seed, row,
column) that the CUDA kernel and the twin compute with the same integer
ops, so the two draw the same tokens from the same logits.
"""

import numpy as np
import torch

from deephumor_tpu_torch import UNK
from deephumor_tpu_torch.ops import _build

__all__ = ["fused_topk_gumbel_sample", "fused_topk_gumbel_sample_plain",
           "mix32", "noise_bits"]

_INT_MIN = -(2 ** 31)
_CHUNK_ROWS = 1024  # rows per pass of the twin (bounds its int64 temporaries)
_U32 = 0xFFFFFFFF


def mix32(x):
    """The "lowbias32" integer finaliser on int64 tensors holding uint32
    values (products wrap mod 2**64; the mask keeps their low 32 bits)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def noise_bits(seed, rows, cols):
    """uint32 noise bits (as int64) for rows x cols: mix32(row_hash ^ col)
    with row_hash = mix32(mix32(seed ^ 0x9E3779B9) ^ row)."""
    s = mix32(torch.tensor(seed ^ 0x9E3779B9, dtype=torch.int64,
                           device=rows.device))
    row_hash = mix32(s ^ rows.to(torch.int64))
    return mix32(row_hash[:, None] ^ cols.to(torch.int64)[None, :])


def _order_key(x):
    """Monotone f32 -> int32 map: signed-int order == float order."""
    i = x.view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def _check(logits, top_k, num_draws):
    if logits.ndim != 2 or logits.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise ValueError("logits must be a 2-D float32 or bfloat16 tensor")
    if not 1 <= num_draws <= top_k <= logits.shape[1]:
        raise ValueError(f"need 1 <= num_draws ({num_draws}) <= top_k "
                         f"({top_k}) <= V ({logits.shape[1]})")


def _plain_rows(x, row0, seed, invt, top_k, num_draws, unk, low_bit):
    n, v = x.shape
    keys = _order_key(x)
    t = torch.where((keys >= 0).sum(1) >= top_k, 0, _INT_MIN).to(torch.int32)
    for bit in range(30, low_bit - 1, -1):
        cand = t | (1 << bit)
        t = torch.where((keys >= cand[:, None]).sum(1) >= top_k, cand, t)
    col = torch.arange(v, device=x.device)
    keep = (keys >= t[:, None]) & (col != unk)
    rows = torch.arange(row0, row0 + n, device=x.device)
    bits = noise_bits(seed, rows, col)
    u = ((bits >> 8).to(torch.float32) * (1.0 / 16777216.0)).clamp_min(1e-10)
    pert = x * invt + (-torch.log(-torch.log(u)))
    cmask = (1 << max(13, (v - 1).bit_length())) - 1
    packed = (_order_key(pert) & ~cmask) | (cmask - col).to(torch.int32)
    packed = torch.where(keep, packed, _INT_MIN)
    ids = []
    m = None
    for _ in range(num_draws):
        cand = packed if m is None else torch.where(
            packed < m[:, None], packed, _INT_MIN)
        m = cand.max(dim=1).values
        ids.append(torch.where(m == _INT_MIN, 0, cmask - (m & cmask)))
    return torch.stack(ids, dim=1)


def fused_topk_gumbel_sample_plain(logits, seed, inv_temperature, *, top_k,
                                   num_draws, unk_index=UNK):
    """Plain PyTorch twin of :func:`fused_topk_gumbel_sample`."""
    _check(logits, top_k, num_draws)
    invt = float(np.float32(inv_temperature))
    low_bit = 15 if logits.dtype == torch.bfloat16 else 0
    x = logits.float()
    ids = torch.cat([
        _plain_rows(x[r0:r0 + _CHUNK_ROWS], r0, int(seed), invt, top_k,
                    num_draws, unk_index, low_bit)
        for r0 in range(0, x.shape[0], _CHUNK_ROWS)
    ]).to(torch.int64)
    return ids, x.gather(1, ids)


def fused_topk_gumbel_sample(logits, seed, inv_temperature, *, top_k,
                             num_draws, unk_index=UNK):
    """K3: draws ``num_draws`` tokens per row, without replacement, from
    softmax(top_k_filter(logits) * inv_temperature).

    The filter keeps every logit >= the row's k-th largest (ties kept) and
    never UNK. When fewer than ``num_draws`` columns are kept, the
    remaining draws return column 0.

    Args:
        logits: ``[rows, V]`` float32 or bfloat16 (scored in f32).
        seed: int in ``[0, 2**31)``; a fixed seed gives fixed draws.
        inv_temperature: float (rounded to f32).

    Returns:
        (ids ``[rows, num_draws]`` int64, vals ``[rows, num_draws]`` f32 --
        the raw logits at the drawn ids).
    """
    name = "fused_topk_gumbel_sample"
    _check(logits, top_k, num_draws)
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"{name}: seed {seed} outside [0, 2**31)")
    if not _build.on_kernel_device(name, logits):
        return fused_topk_gumbel_sample_plain(
            logits, seed, inv_temperature, top_k=top_k,
            num_draws=num_draws, unk_index=unk_index)
    rows, v = logits.shape
    ids = torch.empty((rows, num_draws), dtype=torch.int32,
                      device=logits.device)
    err = _build.library().dh_topk_gumbel_sample(
        _build.dtype_code(logits, name), logits.data_ptr(), ids.data_ptr(),
        rows, v, top_k, num_draws, unk_index, int(seed),
        float(np.float32(inv_temperature)), _build.stream_of(logits))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    ids = ids.to(torch.int64)
    return ids, logits.gather(1, ids).float()
