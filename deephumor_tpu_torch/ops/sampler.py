"""Exact keep-ties top-k + Gumbel-top-k sampling: the K3 and K4 wrappers
and their plain twins.

Counterparts of deephumor_tpu/ops/pallas_sampler.py's
``fused_topk_gumbel_sample`` (K3, over logits) and
``fused_classifier_topk_gumbel_sample`` (K4, over hidden states: the
classifier product runs inside the kernel). The TPU kernels draw their
noise from the on-core PRNG; here the noise is a counter-based hash of
(seed, row, column) that the CUDA kernels and the twins compute with the
same integer ops, so they draw the same tokens from the same logits.
The seed is a host int or a one-element int32 tensor on the logits'
device, which the kernel reads at launch: a captured decode step keeps
its seed in device memory, so each replay draws anew. 1/T and the live
row count may be device values too (a 0-d f32 and a 0-d int32 tensor), so
that one captured graph serves every temperature and every compaction.
"""

import numpy as np
import torch

from deephumor_tpu_torch import UNK
from deephumor_tpu_torch.ops import _build

__all__ = ["fused_topk_gumbel_sample", "fused_topk_gumbel_sample_plain",
           "fused_classifier_topk_gumbel_sample",
           "fused_classifier_topk_gumbel_sample_plain", "classifier_logits",
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
    with row_hash = mix32(mix32(seed ^ 0x9E3779B9) ^ row); ``seed`` an int
    or a one-element integer tensor."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(()).to(device=rows.device, dtype=torch.int64)
    else:
        seed = torch.tensor(seed, dtype=torch.int64, device=rows.device)
    s = mix32(seed ^ 0x9E3779B9)
    row_hash = mix32(s ^ rows.to(torch.int64))
    return mix32(row_hash[:, None] ^ cols.to(torch.int64)[None, :])


def _order_key(x):
    """Monotone f32 -> int32 map: signed-int order == float order."""
    i = x.view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def _seed_args(name, seed, device):
    """(value, device pointer or None) of a seed: an int in ``[0, 2**31)``,
    or a one-element int32 tensor on ``device`` that the kernel reads. A
    tensor's value is not read here (that would wait for the device): its
    drawer keeps it in range."""
    if isinstance(seed, torch.Tensor):
        if (seed.dtype != torch.int32 or seed.numel() != 1
                or seed.device != device):
            raise ValueError(f"{name}: a seed tensor must be one int32 on "
                             f"{device}, got {seed.dtype} "
                             f"{tuple(seed.shape)} on {seed.device}")
        return 0, seed.data_ptr()
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"{name}: seed {seed} outside [0, 2**31)")
    return int(seed), None


def _inv_t_args(name, inv_temperature, device):
    """(f32 value, device pointer or None) of 1/T: a float (rounded to
    f32), or a 0-d f32 tensor on ``device`` that the kernel reads (not
    read here)."""
    if isinstance(inv_temperature, torch.Tensor):
        if (inv_temperature.dtype != torch.float32 or inv_temperature.ndim
                or inv_temperature.device != device):
            raise ValueError(f"{name}: a 1/T tensor must be a 0-d float32 "
                             f"on {device}, got {inv_temperature.dtype} "
                             f"{tuple(inv_temperature.shape)} on "
                             f"{inv_temperature.device}")
        return 0.0, inv_temperature.data_ptr()
    return float(np.float32(inv_temperature)), None


def _plain_inv_t(inv_temperature):
    """1/T as the twins multiply by it: the f32 value of a float, or the
    tensor as it is (no host read)."""
    if isinstance(inv_temperature, torch.Tensor):
        return inv_temperature
    return float(np.float32(inv_temperature))


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
                                   num_draws, unk_index=UNK, live_rows=None):
    """Plain PyTorch twin of :func:`fused_topk_gumbel_sample`: every row
    drawn, the live rows' draws kept (so tensor counts and 1/T are never
    read)."""
    _check(logits, top_k, num_draws)
    invt = _plain_inv_t(inv_temperature)
    low_bit = 15 if logits.dtype == torch.bfloat16 else 0
    rows = logits.shape[0]
    x = logits.float()
    if not rows:
        return (torch.zeros((0, num_draws), dtype=torch.int64,
                            device=logits.device),
                torch.zeros((0, num_draws), device=logits.device))
    ids = torch.cat([
        _plain_rows(x[r0:r0 + _CHUNK_ROWS], r0, seed, invt, top_k,
                    num_draws, unk_index, low_bit)
        for r0 in range(0, rows, _CHUNK_ROWS)])
    live = _build.count_mask(rows, live_rows, logits.device)[:, None]
    ids = torch.where(live, ids, 0).to(torch.int64)
    return ids, torch.where(live, x.gather(1, ids), 0.0)


def fused_topk_gumbel_sample(logits, seed, inv_temperature, *, top_k,
                             num_draws, unk_index=UNK, live_rows=None):
    """K3: draws ``num_draws`` tokens per row, without replacement, from
    softmax(top_k_filter(logits) * inv_temperature).

    The filter keeps every logit >= the row's k-th largest (ties kept) and
    never UNK. When fewer than ``num_draws`` columns are kept, the
    remaining draws return column 0.

    Args:
        logits: ``[rows, V]`` float32 or bfloat16 (scored in f32).
        seed: int in ``[0, 2**31)``, or a one-element int32 tensor on the
            logits' device holding one (the kernel reads it at launch);
            a fixed seed value gives fixed draws either way.
        inv_temperature: float (rounded to f32), or a 0-d f32 tensor on
            the logits' device holding one, which the kernel reads at
            launch (a captured call's temperature).
        live_rows: optional int, or a 0-d int32 tensor on the logits'
            device that the kernel reads (a captured step's count); rows
            at or past it are not computed and get id 0 and value 0
            (early-EOS compaction keeps the live rows first). The noise
            hashes the global row, so a row draws the same tokens whatever
            ``live_rows`` is.

    Returns:
        (ids ``[rows, num_draws]`` int64, vals ``[rows, num_draws]`` f32 --
        the raw logits at the drawn ids).
    """
    name = "fused_topk_gumbel_sample"
    _check(logits, top_k, num_draws)
    seed_value, seed_ptr = _seed_args(name, seed, logits.device)
    invt, invt_ptr = _inv_t_args(name, inv_temperature, logits.device)
    if not _build.on_kernel_device(name, logits):
        return fused_topk_gumbel_sample_plain(
            logits, seed, inv_temperature, top_k=top_k,
            num_draws=num_draws, unk_index=unk_index, live_rows=live_rows)
    rows, v = logits.shape
    live, live_ptr = _build.count_args(name, rows, live_rows, logits.device)
    code = _build.dtype_code(logits, name)
    _build.check_smem(name, _build.smem_need(
        "dh_topk_gumbel_sample_smem", code, v), logits)
    # an int count of 0 launches nothing; the kernel zeroes the ids of the
    # rows past any other count itself
    ids = (torch.zeros if live == 0 else torch.empty)(
        (rows, num_draws), dtype=torch.int32, device=logits.device)
    if live:
        err = _build.library().dh_topk_gumbel_sample(
            code, logits.data_ptr(), ids.data_ptr(), rows, live, live_ptr, v,
            top_k, num_draws, unk_index, seed_value, seed_ptr, invt,
            invt_ptr, _build.stream_of(logits))
        _build.check(err, name)
        _build.note_launch(name)
    ids = ids.to(torch.int64)
    vals = logits.gather(1, ids).float()
    if live_rows is not None:
        vals = torch.where(_build.count_mask(rows, live_rows, logits.device)[
            :, None], vals, 0.0)
    return ids, vals


def classifier_logits(x, w, b):
    """K4's logits: bf16 ``x @ w.T`` accumulated in f32, plus the f32
    bias, rounded to bf16."""
    bf = torch.bfloat16
    return (x.to(bf).float() @ w.to(bf).float().T + b.float()).to(bf)


def _check_classifier(x, w, b, top_k, num_draws):
    if x.ndim != 2 or w.ndim != 2 or w.shape[1] != x.shape[1] or (
            b.shape != (w.shape[0],)):
        raise ValueError(f"need x [rows, D], w [V, D], b [V]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if not 1 <= num_draws <= top_k <= w.shape[0]:
        raise ValueError(f"need 1 <= num_draws ({num_draws}) <= top_k "
                         f"({top_k}) <= V ({w.shape[0]})")


def fused_classifier_topk_gumbel_sample_plain(x, w, b, seed, inv_temperature,
                                              *, top_k, num_draws,
                                              unk_index=UNK, live_rows=None):
    """Plain PyTorch twin of :func:`fused_classifier_topk_gumbel_sample`:
    K3's twin over :func:`classifier_logits`."""
    _check_classifier(x, w, b, top_k, num_draws)
    return fused_topk_gumbel_sample_plain(
        classifier_logits(x, w, b), seed, inv_temperature, top_k=top_k,
        num_draws=num_draws, unk_index=unk_index, live_rows=live_rows)


def fused_classifier_topk_gumbel_sample(x, w, b, seed, inv_temperature, *,
                                        top_k, num_draws, unk_index=UNK,
                                        live_rows=None):
    """K4: :func:`fused_topk_gumbel_sample` of :func:`classifier_logits`
    ``(x, w, b)``, with the product inside the kernel: the logits stay in
    its blocks (V up to 256) or pass through a scratch that the draws read
    back at once.

    Args:
        x: ``[rows, D]`` hidden states (cast to bf16).
        w: ``[V, D]`` classifier weight (cast to bf16); b: ``[V]`` bias
            (f32).
        live_rows: optional int or 0-d int32 tensor, as K3's; rows at or
            past it are not computed and get id 0 and value 0 (early-EOS
            compaction keeps the live rows first).
        seed, inv_temperature, top_k, num_draws, unk_index: as K3; the
            noise hashes the global row, so a row draws the same tokens
            whatever ``live_rows`` is.

    Returns:
        (ids ``[rows, num_draws]`` int64, vals ``[rows, num_draws]`` f32 --
        the bf16-rounded logits at the drawn ids).
    """
    name = "fused_classifier_topk_gumbel_sample"
    _check_classifier(x, w, b, top_k, num_draws)
    seed_value, seed_ptr = _seed_args(name, seed, x.device)
    invt, invt_ptr = _inv_t_args(name, inv_temperature, x.device)
    kw = dict(top_k=top_k, num_draws=num_draws, unk_index=unk_index,
              live_rows=live_rows)
    if not _build.on_kernel_device(name, x, w, b):
        return fused_classifier_topk_gumbel_sample_plain(
            x, w, b, seed, inv_temperature, **kw)
    if x.shape[1] % 16:
        raise ValueError(f"{name}: D {x.shape[1]} is not a multiple of 16 "
                         f"(the kernel's tensor-core product steps by 16)")
    bf = torch.bfloat16
    rows, v = x.shape[0], w.shape[0]
    live, live_ptr = _build.count_args(name, rows, live_rows, x.device)
    xb, wb, bb = x.to(bf), w.to(bf), b.float().contiguous()
    _build.check_vector_rows(name, x.shape[1], xb, wb)
    lib = _build.library()
    # the streamed path's bf16 logits (none, NULL, on the resident path),
    # for the live rows (every row, with a device count)
    scratch = torch.empty(
        lib.dh_classifier_topk_gumbel_sample_scratch(v, x.shape[1], live),
        dtype=torch.uint8, device=x.device)
    ids = torch.empty((rows, num_draws), dtype=torch.int64, device=x.device)
    vals = torch.empty((rows, num_draws), dtype=torch.float32,
                       device=x.device)
    err = lib.dh_classifier_topk_gumbel_sample(
        xb.data_ptr(), wb.data_ptr(), bb.data_ptr(), ids.data_ptr(),
        vals.data_ptr(), scratch.data_ptr(), rows, live, live_ptr, v,
        x.shape[1], top_k, num_draws, unk_index, seed_value, seed_ptr, invt,
        invt_ptr, _build.stream_of(x))
    _build.check(err, name)
    _build.note_launch(name)
    return ids, vals
