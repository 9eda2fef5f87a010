"""Decode-time attention: the K1, K2, K5, K6, K7, K8 and K9 kernel
wrappers and their twins.

Counterparts of deephumor_tpu/ops/pallas_attention.py. Each wrapper
launches its CUDA kernel (ops/csrc/) for CUDA tensors and runs its plain
PyTorch twin for CPU tensors; anything else raises. The twins compute in
f32 and round the softmax weights to the value dtype before the AV
product, as the kernels do.
"""

import math
import threading

import torch

from deephumor_tpu_torch.ops import _build

__all__ = ["MASK_FILL", "ancestry_bias", "ancestry_attention",
           "ancestry_attention_plain", "ancestry_attention_update",
           "ancestry_attention_update_plain",
           "ancestry_attention_update_flash",
           "ancestry_attention_update_flash_plain",
           "ancestry_attention_update_canon",
           "ancestry_attention_update_canon_plain", "ancestry_attention_ids",
           "ancestry_attention_ids_plain", "grouped_cross_attention",
           "grouped_cross_attention_plain", "cross_attention_packed",
           "cross_attention_packed_plain", "TALLY_SLOTS", "rows_tally",
           "rows_tally_totals"]

MASK_FILL = -1e8

# The tally of the (slot, position) rows that the tensor-core blocks of K1,
# K6 and K7 read and of the rows in their dense span (ops/csrc/row_list.cuh):
# per device, int64 [2, TALLY_SLOTS], rows read in row 0 and dense rows in
# row 1, one slot per item modulo TALLY_SLOTS.
TALLY_SLOTS = 32
_TALLY = {}
_TALLY_LOCK = threading.Lock()


def _cuda_device(device):
    device = torch.device(device)
    return device if device.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def rows_tally(device):
    """The tally of the rows that K1, K6 and K7 read on ``device`` (a CUDA
    device): int64 ``[2, TALLY_SLOTS]``, to which each head-0 block of their
    tensor-core kernels adds the rows it read and the rows of its dense
    span. It lives as long as the process, so that a captured graph, which
    bakes its address, adds to it at every replay. Made at the first call
    on the device outside a capture (models/graphs.py makes it before each
    capture); None while this thread captures and it does not exist yet:
    launches captured then count nothing."""
    device = _cuda_device(device)
    t = _TALLY.get(device)
    if t is None and not torch.cuda.is_current_stream_capturing():
        with _TALLY_LOCK:
            t = _TALLY.get(device)
            if t is None:
                t = _TALLY[device] = torch.zeros(
                    2, TALLY_SLOTS, dtype=torch.int64, device=device)
    return t


def rows_tally_totals(device):
    """``(rows read, dense rows)`` that the kernels have added to the
    tally of ``device`` so far, read from the device (it waits for the
    current stream), or None where no kernel has made it there."""
    t = _TALLY.get(_cuda_device(device))
    if t is None:
        return None
    read, dense = t.sum(dim=1).tolist()
    return read, dense


def _tally_ptr(device):
    t = rows_tally(device)
    return None if t is None else t.data_ptr()


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


def _check_rows(name, t, d):
    """A ``[rows, d]`` operand that the kernels read at its row stride
    (q, k_new, v_new: the views of a fused QKV product lie 3 D apart):
    unit stride along a row, rows at least ``d`` apart, and a view's row
    stride a multiple of 16 bytes (rows load as 16-byte vectors; a
    contiguous operand's rows are as aligned as its head_dim, which the
    card's wrappers check)."""
    ld = t.stride(0)
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must have unit stride along its rows, got "
                         f"strides {t.stride()}")
    if t.shape[0] > 1 and ld < d:
        raise ValueError(f"{name}: row stride {ld} below its width {d}")
    if t.shape[0] > 1 and ld != d and ld * t.element_size() % 16:
        raise ValueError(f"{name}: row stride {ld} x {t.element_size()} "
                         f"bytes is not a multiple of 16")


def _check_update(q, cache_k, cache_v, k_new, v_new, bias, pos, beam,
                  n_heads):
    """Shapes of the ancestry kernels' operands and the row strides of
    q, k_new and v_new; k_new/v_new, bias and pos may be None where a
    kernel does not take them."""
    rows, p, d = cache_k.shape
    if cache_v.shape != cache_k.shape:
        raise ValueError("cache_k and cache_v shapes differ")
    news = [(n, t) for n, t in (("k_new", k_new), ("v_new", v_new))
            if t is not None]
    for name, t in [("q", q)] + news:
        if t.shape != (rows, d):
            raise ValueError(f"{name} must be [{rows}, {d}], got "
                             f"{tuple(t.shape)}")
        _check_rows(name, t, d)
    if len({t.dtype for t in [q, cache_k, cache_v] + [t for _, t in news]}
           ) != 1:
        raise ValueError("q, caches and k_new/v_new must share one dtype")
    if rows % beam or d % n_heads:
        raise ValueError(f"rows {rows} / beam {beam} or D {d} / heads "
                         f"{n_heads} do not divide")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (rows // beam, beam, beam * p)):
        raise ValueError(f"bias must be f32 [{rows // beam}, {beam}, "
                         f"{beam * p}], got {bias.dtype} {tuple(bias.shape)}")
    if pos is not None and not 0 <= pos < p:
        raise ValueError(f"pos {pos} outside the cache length {p}")


def _attend(q, cache_k, cache_v, bias, *, beam, n_heads, pe):
    """Ancestry attention of every item in ``q [items*beam, D]`` over the
    first ``pe`` positions of its caches: f32 energies and softmax, weights
    rounded to the value dtype before the AV product."""
    rows, p, d = cache_k.shape
    b, hd = rows // beam, d // n_heads
    k = cache_k[:, :pe].float().reshape(b, beam, pe, n_heads, hd)
    v = cache_v[:, :pe].float().reshape(b, beam, pe, n_heads, hd)
    qf = q.float().reshape(b, beam, n_heads, hd)
    e = torch.einsum("bjhd,biphd->bjhip", qf, k) * (1.0 / math.sqrt(hd))
    e = e + bias.reshape(b, beam, 1, beam, p)[..., :pe]
    w = torch.softmax(e.reshape(b, beam, n_heads, beam * pe), dim=-1)
    w = w.to(q.dtype).float().reshape(b, beam, n_heads, beam, pe)
    out = torch.einsum("bjhip,biphd->bjhd", w, v)
    return out.reshape(rows, d).to(q.dtype)


_IMPLS = ("native4d", "grouped", "blockdiag")


def _read_length(p, impl, p_eff):
    """The cache positions K7 reads: ``p_eff`` limits only the native4d
    layout (a multiple of 8, or P), as in the JAX package."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    pe = p if impl != "native4d" or p_eff is None else min(p_eff, p)
    if pe != p and pe % 8:
        raise ValueError(f"p_eff {pe} must be a multiple of 8 or P ({p})")
    return pe


def ancestry_attention_plain(q, cache_k, cache_v, bias, *, beam, n_heads,
                             block_items=None, impl="native4d", p_eff=None):
    """Plain PyTorch twin of :func:`ancestry_attention`."""
    pe = _read_length(cache_k.shape[1], impl, p_eff)
    return _attend(q, cache_k, cache_v, bias, beam=beam, n_heads=n_heads,
                   pe=pe)


def ancestry_attention(q, cache_k, cache_v, bias, *, beam, n_heads,
                       block_items=None, impl="native4d", p_eff=None):
    """K7: read-only ancestry attention (K1 without the cache write).

    Each branch j of an item attends, per head, over every (slot i,
    position p) of its item's caches with ``bias`` added to the scaled
    energies. ``impl`` names the JAX package's three TPU layouts of this
    one function; all three launch the same kernel here, and only
    "native4d" honours ``p_eff`` (the other two read all P positions, as
    in the JAX package). ``block_items`` is the TPU grid's block size,
    accepted for the signature and without effect.

    Args:
        q: ``[B*beam, D]``.
        cache_k, cache_v: ``[B*beam, P, D]``, the dtype of ``q``; only
            read.
        bias: f32 ``[B, beam, beam*P]`` (:func:`ancestry_bias`).
        p_eff: with "native4d", read only the first ``p_eff`` positions (a
            multiple of 8, or P; every valid position must lie below it).

    Returns:
        attention output ``[B*beam, D]`` (before the output projection).
    """
    name = "ancestry_attention"
    _check_update(q, cache_k, cache_v, None, None, bias, None, beam,
                  n_heads)
    rows, p, d = cache_k.shape
    pe = _read_length(p, impl, p_eff)
    kw = dict(beam=beam, n_heads=n_heads, impl=impl, p_eff=p_eff)
    if not _build.on_kernel_device(name, q, cache_k, cache_v, bias):
        return ancestry_attention_plain(q, cache_k, cache_v, bias, **kw)
    _build.check_vector_rows(name, d // n_heads, cache_k, cache_v)
    _build.check_mma_tiles(name, d // n_heads, q)
    out = torch.empty_like(q)
    err = _build.library().dh_ancestry_attention(
        _build.dtype_code(q, name), q.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        _tally_ptr(q.device), rows // beam, beam, p, pe, d, n_heads,
        1.0 / math.sqrt(d // n_heads), _build.stream_of(q))
    _build.check(err, name)
    _build.note_launch(name)
    return out


def ancestry_attention_update_plain(q, cache_k, cache_v, k_new, v_new, bias,
                                    pos, *, beam, n_heads, p_eff=None,
                                    live_items=None):
    """Plain PyTorch twin of :func:`ancestry_attention_update`: every row
    computed, the live items' kept (so a tensor count is never read)."""
    rows, p, _ = cache_k.shape
    pe = p if p_eff is None else min(p_eff, p)
    live = _build.count_mask(rows // beam, live_items, q.device, beam)[:, None]
    cache_k[:, pos] = torch.where(live, k_new, cache_k[:, pos])
    cache_v[:, pos] = torch.where(live, v_new, cache_v[:, pos])
    out = _attend(q, cache_k, cache_v, bias, beam=beam, n_heads=n_heads,
                  pe=pe)
    return torch.where(live, out, 0.0)


def ancestry_attention_update(q, cache_k, cache_v, k_new, v_new, bias, pos,
                              *, beam, n_heads, p_eff=None, live_items=None):
    """K1: writes (k_new, v_new) at ``pos``, then ancestry attention.

    The caches are updated IN PLACE: ``cache_k[:, pos] = k_new`` and
    ``cache_v[:, pos] = v_new``. Each branch j of an item then attends,
    per head, over every (slot i, position p < p_eff) of its item's caches
    with ``bias`` (:func:`ancestry_bias`) added to the scaled energies.

    Args:
        q, k_new, v_new: ``[B*beam, D]``, contiguous or row-strided views
            (unit stride along a row; rows at least D apart, a multiple of
            16 bytes: the three views of a fused QKV product).
        cache_k, cache_v: ``[B*beam, P, D]``, the same dtype as ``q``.
        bias: f32 ``[B, beam, beam*P]``.
        pos: int decode position, ``0 <= pos < P``.
        p_eff: read only the first ``p_eff`` cache positions (every valid
            position must lie below it).
        live_items: optional int, or a 0-d int32 tensor on the device of
            ``q`` that the kernel reads (a captured step's count); items at
            or past it (retired by early-EOS compaction, which keeps live
            items first) are not computed: their output rows are zero and
            their cache columns are not written.

    Returns:
        attention output ``[B*beam, D]`` (before the output projection).

    On the card, bf16 at a head_dim that is a multiple of 16 up to 256 runs
    the tensor-core kernel; f32 and any other head_dim run the CUDA-core
    kernel. Only the f32 energies grow with ``p_eff``; a shape whose block
    would need more shared memory than the card has raises ``ValueError``
    before the launch.
    """
    name = "ancestry_attention_update"
    _check_update(q, cache_k, cache_v, k_new, v_new, bias, pos, beam,
                  n_heads)
    kw = dict(beam=beam, n_heads=n_heads, p_eff=p_eff, live_items=live_items)
    if not _build.on_kernel_device(name, cache_k, cache_v, bias,
                                   rows=(q, k_new, v_new)):
        return ancestry_attention_update_plain(
            q, cache_k, cache_v, k_new, v_new, bias, pos, **kw)
    rows, p, d = cache_k.shape
    _build.check_vector_rows(name, d // n_heads, cache_k, cache_v, q, k_new,
                             v_new)
    pe = p if p_eff is None else min(p_eff, p)
    code = _build.dtype_code(q, name)
    _build.check_smem(name, _build.smem_need(
        "dh_ancestry_attention_update_smem", code, rows // beam, beam, pe, d,
        n_heads), q)
    live, live_ptr = _build.count_args(name, rows // beam, live_items,
                                       q.device)
    out = q.new_empty((rows, d))  # contiguous, whatever q's stride
    err = _build.library().dh_ancestry_attention_update(
        code, q.data_ptr(), q.stride(0), cache_k.data_ptr(),
        cache_v.data_ptr(), k_new.data_ptr(), k_new.stride(0),
        v_new.data_ptr(), v_new.stride(0), bias.data_ptr(), out.data_ptr(),
        _tally_ptr(q.device), rows // beam, live, live_ptr, beam, p, pe, d,
        n_heads, pos, 1.0 / math.sqrt(d // n_heads), _build.stream_of(q))
    _build.check(err, name)
    _build.note_launch(name)
    return out


def ancestry_attention_update_flash_plain(q, cache_k, cache_v, k_new,
                                          v_new, bias, pos, *, beam, n_heads,
                                          block_items=16):
    """Plain PyTorch twin of :func:`ancestry_attention_update_flash`: K1's
    twin over the tiles through ``pos // 8``."""
    return ancestry_attention_update_plain(
        q, cache_k, cache_v, k_new, v_new, bias, pos, beam=beam,
        n_heads=n_heads, p_eff=8 * (pos // 8 + 1))


def ancestry_attention_update_flash(q, cache_k, cache_v, k_new, v_new, bias,
                                    pos, *, beam, n_heads, block_items=16):
    """K8: :func:`ancestry_attention_update` with the caches read in
    8-position tiles through the one holding ``pos`` and the softmax
    accumulated across tiles (flash style).

    The caches are updated IN PLACE at ``pos``. Every valid position must
    be at most ``pos``; tiles past ``pos // 8`` are never read. The JAX
    package keeps its TPU form as a measured negative result; here it
    stands beside K1 for the same comparison. ``block_items`` is the TPU
    grid's block size, accepted for the signature and without effect.

    Args:
        q, k_new, v_new: ``[B*beam, D]``.
        cache_k, cache_v: ``[B*beam, P, D]``, P a multiple of 8, the dtype
            of ``q``.
        bias: f32 ``[B, beam, beam*P]``.
        pos: int decode position, ``0 <= pos < P``.

    Returns:
        attention output ``[B*beam, D]`` (before the output projection).

    On the card, bf16 at a head_dim that is a multiple of 16 up to 256 runs
    the one-pass tensor-core kernel, f32 and any other head_dim the
    CUDA-core kernel; neither keeps energies past their tile, so shared
    memory does not grow with ``pos``. The weights are rounded to the cache
    dtype before they are normalised (the TPU kernel's order; the twin
    normalises first, which differs by at most one rounding).
    """
    name = "ancestry_attention_update_flash"
    _check_update(q, cache_k, cache_v, k_new, v_new, bias, pos, beam,
                  n_heads)
    rows, p, d = cache_k.shape
    if p % 8:
        raise ValueError(f"{name}: the cache length {p} is not a multiple "
                         f"of 8")
    kw = dict(beam=beam, n_heads=n_heads)
    if not _build.on_kernel_device(name, q, cache_k, cache_v, k_new, v_new,
                                   bias):
        return ancestry_attention_update_flash_plain(
            q, cache_k, cache_v, k_new, v_new, bias, pos, **kw)
    _build.check_vector_rows(name, d // n_heads, cache_k, cache_v, k_new,
                             v_new)
    code = _build.dtype_code(q, name)
    _build.check_smem(name, _build.smem_need(
        "dh_ancestry_attention_update_flash_smem", code, beam, d, n_heads), q)
    out = torch.empty_like(q)
    err = _build.library().dh_ancestry_attention_update_flash(
        code, q.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        bias.data_ptr(), out.data_ptr(), rows // beam, beam, p, d, n_heads,
        pos, 1.0 / math.sqrt(d // n_heads), _build.stream_of(q))
    _build.check(err, name)
    _build.note_launch(name)
    return out


def _check_canon(q, cache_k, shared_k, shared_v, bias_shared, bias_win, pos,
                 beam, c, p_eff):
    rows, p, d = cache_k.shape
    b = rows // beam
    if not 0 < c < p_eff <= p or not c <= pos < p_eff:
        raise ValueError(f"need 0 < c ({c}) <= pos ({pos}) < p_eff "
                         f"({p_eff}) <= P ({p})")
    if shared_v.shape != shared_k.shape or shared_k.ndim != 3 or (
            shared_k.shape[0] != b or shared_k.shape[1] < c
            or shared_k.shape[2] != d):
        raise ValueError(f"shared caches must be [{b}, >={c}, {d}], got "
                         f"{tuple(shared_k.shape)}")
    if shared_k.dtype != q.dtype:
        raise ValueError("shared caches must have the dtype of q")
    w = p_eff - c
    for name, t, shape in (("bias_shared", bias_shared, (b, 1, c)),
                           ("bias_win", bias_win, (b, beam, beam * w))):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f"{name} must be f32 {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def ancestry_attention_update_canon_plain(q, cache_k, cache_v, shared_k,
                                          shared_v, k_new, v_new,
                                          bias_shared, bias_win, pos, *,
                                          beam, n_heads, c, p_eff,
                                          live_items=None):
    """Plain PyTorch twin of :func:`ancestry_attention_update_canon`: every
    row computed, the live items' kept."""
    rows, _, d = cache_k.shape
    hd, w, b = d // n_heads, p_eff - c, rows // beam
    live = _build.count_mask(b, live_items, q.device, beam)[:, None]
    cache_k[:, pos] = torch.where(live, k_new, cache_k[:, pos])
    cache_v[:, pos] = torch.where(live, v_new, cache_v[:, pos])
    qf = q.float().reshape(b, beam, n_heads, hd)
    sk, sv = (s[:, :c].float().reshape(b, c, n_heads, hd)
              for s in (shared_k, shared_v))
    wk, wv = (t[:, c:p_eff].float().reshape(b, beam * w, n_heads, hd)
              for t in (cache_k, cache_v))
    scale = 1.0 / math.sqrt(hd)
    e_sh = torch.einsum("bjhd,bchd->bjhc", qf, sk) * scale
    e_sh = e_sh + bias_shared[:, :, None, :]
    e_wn = torch.einsum("bjhd,bwhd->bjhw", qf, wk) * scale
    e_wn = e_wn + bias_win[:, :, None, :]
    wt = torch.softmax(torch.cat([e_sh, e_wn], dim=-1), dim=-1)
    wt = wt.to(q.dtype).float()
    o = (torch.einsum("bjhc,bchd->bjhd", wt[..., :c], sv)
         + torch.einsum("bjhw,bwhd->bjhd", wt[..., c:], wv))
    return torch.where(live, o.reshape(rows, d).to(q.dtype), 0.0)


def ancestry_attention_update_canon(q, cache_k, cache_v, shared_k, shared_v,
                                    k_new, v_new, bias_shared, bias_win, pos,
                                    *, beam, n_heads, c, p_eff,
                                    live_items=None):
    """K5: writes (k_new, v_new) at ``pos``, then canonical-prefix
    attention.

    Each branch j of item b attends over the item's shared ancestor rows
    ``shared[b, :c]`` (bias ``bias_shared``) joined with its item's
    per-slot window ``cache[b*beam:(b+1)*beam, c:p_eff]`` (bias
    ``bias_win``), one softmax over both. Items whose live branches
    disagree below ``c`` (stragglers) get outputs from a stale shared path:
    the caller recomputes them with :func:`ancestry_attention_ids`.

    Args:
        q, k_new, v_new: ``[B*beam, D]``, contiguous or row-strided views
            (as :func:`ancestry_attention_update`).
        cache_k, cache_v: ``[B*beam, P, D]``, updated IN PLACE at ``pos``.
        shared_k, shared_v: ``[B, >=c, D]`` canonical ancestor caches.
        bias_shared: f32 ``[B, 1, c]`` validity bias of the shared rows.
        bias_win: f32 ``[B, beam, beam*(p_eff-c)]`` ancestry bias of the
            window (:func:`ancestry_bias` over positions ``[c, p_eff)``).
        pos: int, ``c <= pos < p_eff``.
        live_items: as :func:`ancestry_attention_update`.

    Returns:
        attention output ``[B*beam, D]`` (before the output projection).
    """
    name = "ancestry_attention_update_canon"
    rows, p, d = cache_k.shape
    _check_update(q, cache_k, cache_v, k_new, v_new, None, pos, beam,
                  n_heads)
    p_eff = min(p_eff, p)
    _check_canon(q, cache_k, shared_k, shared_v, bias_shared, bias_win, pos,
                 beam, c, p_eff)
    kw = dict(beam=beam, n_heads=n_heads, c=c, p_eff=p_eff,
              live_items=live_items)
    if not _build.on_kernel_device(name, cache_k, cache_v, shared_k,
                                   shared_v, bias_shared, bias_win,
                                   rows=(q, k_new, v_new)):
        return ancestry_attention_update_canon_plain(
            q, cache_k, cache_v, shared_k, shared_v, k_new, v_new,
            bias_shared, bias_win, pos, **kw)
    _build.check_vector_rows(name, d // n_heads, cache_k, cache_v, shared_k,
                             shared_v, q, k_new, v_new)
    _build.check_mma_tiles(name, d // n_heads, q)
    live, live_ptr = _build.count_args(name, rows // beam, live_items,
                                       q.device)
    out = q.new_empty((rows, d))
    err = _build.library().dh_ancestry_attention_update_canon(
        _build.dtype_code(q, name), q.data_ptr(), q.stride(0),
        cache_k.data_ptr(), cache_v.data_ptr(), shared_k.data_ptr(),
        shared_v.data_ptr(), k_new.data_ptr(), k_new.stride(0),
        v_new.data_ptr(), v_new.stride(0), bias_shared.data_ptr(),
        bias_win.data_ptr(), out.data_ptr(), rows // beam, live, live_ptr,
        beam, p, shared_k.shape[1], c, p_eff, d, n_heads, pos,
        1.0 / math.sqrt(d // n_heads), _build.stream_of(q))
    _build.check(err, name)
    _build.note_launch(name)
    return out


def ancestry_attention_ids_plain(q, cache_k, cache_v, bias, item_ids, n_sel,
                                 *, beam, n_heads, p_eff=None, out=None):
    """Plain PyTorch twin of :func:`ancestry_attention_ids` (rows of items
    it does not compute are zero, or with ``out`` as they were): every item
    computed, the selected ones' rows kept, so a tensor ``n_sel`` is never
    read."""
    rows, p, _ = cache_k.shape
    pe = p if p_eff is None else min(p_eff, p)
    items = rows // beam
    ids = item_ids[:items].long()
    take = _build.count_mask(ids.shape[0], n_sel, q.device)
    if out is None:
        take[:1] = True  # at least one
    sel = torch.zeros(items, dtype=torch.int32, device=q.device).index_add_(
        0, ids, take.to(torch.int32)) > 0
    attn = _attend(q, cache_k, cache_v, bias, beam=beam, n_heads=n_heads,
                   pe=pe)
    keep = sel.repeat_interleave(beam)[:, None]
    if out is None:
        return torch.where(keep, attn, 0.0)
    return out.copy_(torch.where(keep, attn, out))


def ancestry_attention_ids(q, cache_k, cache_v, bias, item_ids, n_sel, *,
                           beam, n_heads, p_eff=None, out=None):
    """K6: read-only full-width ancestry attention of the items
    ``item_ids[:max(n_sel, 1)]``, or with ``out`` of ``item_ids[:n_sel]``
    written into ``out``.

    Args:
        q, cache_k, cache_v, bias, p_eff: as
            :func:`ancestry_attention_update` (``q`` may be a row-strided
            view; ``bias`` is the step's full ``[B, beam, beam*P]`` bias);
            the caches are only read.
        item_ids: int ``[>= n_sel]`` item indices (the engine lists the
            straggler items first).
        n_sel: the number of leading ids to compute: an int, or a 0-d
            int32 tensor on the device of ``q`` that the kernel reads (a
            captured step's straggler count). Either way the grid holds
            as many list entries as the card holds at once, each (item,
            head) on a cluster of up to four blocks (the TPU grid is
            ``(n_sel,)``), each entry walking the list in strides of the
            grid, so every count is computed, and both forms compute each
            entry alike, bit for bit.
        out: optional contiguous ``[B*beam, D]`` of ``q``'s dtype (the
            canonical-prefix step passes K5's output): the rows of the
            first ``n_sel`` listed items (none at 0) are written into it
            in place and every other row is left as it was.

    Returns:
        ``[B*beam, D]`` (``out`` when given): rows of the selected items
        hold their attention output; without ``out`` the kernel leaves
        every other row unwritten.
    """
    name = "ancestry_attention_ids"
    rows, p, d = cache_k.shape
    _check_update(q, cache_k, cache_v, None, None, bias, None, beam,
                  n_heads)
    if item_ids.ndim != 1 or item_ids.dtype not in (torch.int32,
                                                    torch.int64):
        raise ValueError("item_ids must be a 1-D integer tensor")
    if item_ids.shape[0] < 1:
        raise ValueError("item_ids lists no item")
    if out is not None and (out.shape != (rows, d) or out.dtype != q.dtype
                            or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous [{rows}, {d}] "
                         f"{q.dtype}, got {out.dtype} {tuple(out.shape)}")
    kw = dict(beam=beam, n_heads=n_heads, p_eff=p_eff, out=out)
    dst = () if out is None else (out,)
    if not _build.on_kernel_device(name, cache_k, cache_v, bias, item_ids,
                                   *dst, rows=(q,)):
        return ancestry_attention_ids_plain(q, cache_k, cache_v, bias,
                                            item_ids, n_sel, **kw)
    _build.check_vector_rows(name, d // n_heads, cache_k, cache_v, q, *dst)
    _build.check_mma_tiles(name, d // n_heads, q)
    pe = p if p_eff is None else min(p_eff, p)
    items = rows // beam
    sel = item_ids[:items].to(torch.int32)
    n, n_ptr = _build.count_args(name, sel.shape[0], n_sel, q.device)
    if out is None:
        out = q.new_empty((rows, d))
    err = _build.library().dh_ancestry_attention_ids(
        _build.dtype_code(q, name), q.data_ptr(), q.stride(0),
        cache_k.data_ptr(), cache_v.data_ptr(), bias.data_ptr(),
        sel.data_ptr(), out.data_ptr(), _tally_ptr(q.device), items,
        sel.shape[0], n, n_ptr, 0 if dst else 1, beam, p, pe, d, n_heads,
        1.0 / math.sqrt(d // n_heads), _build.stream_of(q))
    _build.check(err, name)
    _build.note_launch(name)
    return out


def grouped_cross_attention_plain(q, ek, ev, bias, *, n_heads,
                                  live_items=None):
    """Plain PyTorch twin of :func:`grouped_cross_attention`: every group
    computed, the live groups' rows kept."""
    g, t, d = ek.shape
    r, hd = q.shape[0] // g, d // n_heads
    live = _build.count_mask(g, live_items, q.device, r)[:, None]
    qf = q.float().reshape(g, r, n_heads, hd)
    k = ek.float().reshape(g, t, n_heads, hd)
    v = ev.float().reshape(g, t, n_heads, hd)
    e = torch.einsum("grhd,gthd->grht", qf, k) * (1.0 / math.sqrt(hd))
    if bias is not None:
        e = e + bias.reshape(g, 1, 1, t)
    w = torch.softmax(e, dim=-1).to(q.dtype).float()
    out = torch.einsum("grht,gthd->grhd", w, v).reshape(g * r, d)
    return torch.where(live, out.to(q.dtype), 0.0)


def cross_attention_packed_plain(q, ek, ev, bias, *, n_heads, pack_items,
                                 t_real, live_items=None):
    """Plain PyTorch twin of :func:`cross_attention_packed`: K2's twin over
    each item's first ``t_real`` encoder rows (packing only groups the
    items; the masked cross-item energies add nothing)."""
    return grouped_cross_attention_plain(
        q, ek[:, :t_real], ev[:, :t_real],
        None if bias is None else bias[..., :t_real], n_heads=n_heads,
        live_items=live_items)


def cross_attention_packed(q, ek, ev, bias, *, n_heads, pack_items, t_real,
                           live_items=None):
    """K9: :func:`grouped_cross_attention` over the first ``t_real`` rows
    of each item of a tile-padded store, in groups of ``pack_items`` items
    (the TPU kernel's block-diagonal packing; on the card a group's blocks
    are neighbours in the grid). The caller goes through
    ``grouped_cross_attention(..., pack_items=, t_real=)``, which checks
    the arguments."""
    name = "cross_attention_packed"
    kw = dict(n_heads=n_heads, pack_items=pack_items, t_real=t_real,
              live_items=live_items)
    tensors = (q, ek, ev) if bias is None else (q, ek, ev, bias)
    if not _build.on_kernel_device(name, *tensors):
        return cross_attention_packed_plain(q, ek, ev, bias, **kw)
    g, t, d = ek.shape
    _build.check_vector_rows(name, d // n_heads, q, ek, ev)
    code, r = _build.dtype_code(q, name), q.shape[0] // g
    _build.check_smem(name, _build.smem_need(
        "dh_grouped_cross_attention_smem", code, r, t_real, d, n_heads), q)
    live, live_ptr = _build.count_args(name, g, live_items, q.device)
    out = torch.empty_like(q)
    err = _build.library().dh_cross_attention_packed(
        code, q.data_ptr(), ek.data_ptr(), ev.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), g, live,
        live_ptr, r, t, t_real, d, n_heads, 1.0 / math.sqrt(d // n_heads),
        _build.stream_of(q))
    _build.check(err, name)
    _build.note_launch(name)
    return out


def grouped_cross_attention(q, ek, ev, bias, *, n_heads, live_items=None,
                            pack_items=None, t_real=None):
    """K2: single-query cross-attention of ``G*r`` rows over per-group K/V;
    with ``pack_items > 1``, K9 (:func:`cross_attention_packed`).

    Args:
        q: ``[G*r, D]`` pre-projected queries (r rows per group).
        ek, ev: ``[G, T, D]`` pre-projected encoder keys/values, the dtype
            of ``q``.
        bias: f32 ``[G, 1, T]`` additive mask (0 or -1e8), or None.
        live_items: optional int, or a 0-d int32 tensor on the device of
            ``q`` that the kernel reads (a captured step's count); groups
            at or past it are not computed and their output rows are
            zero.
        pack_items: optional; above 1, blocks of this many items (it must
            divide G) over a store padded past its valid rows
            (``precompute_cross_attention(..., pad_to_tile=True)``).
        t_real: with ``pack_items``, required: the number of valid
            encoder rows; rows ``[t_real, T)`` get zero weight. ``bias``
            must cover the padded T.

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
        raise ValueError(f"{name}: bias must be f32 [{g}, 1, {t}] (with "
                         f"pack_items: the padded T)")
    if pack_items is not None and pack_items > 1:
        if t_real is None or not 0 < t_real <= t:
            raise ValueError(f"{name}: pack_items needs t_real, the number "
                             f"of valid encoder rows (0 < t_real <= {t}), "
                             f"got {t_real}: the pad rows would otherwise "
                             f"get softmax weight")
        if g % pack_items:
            raise ValueError(f"{name}: pack_items {pack_items} does not "
                             f"divide the {g} groups")
        return cross_attention_packed(q, ek, ev, bias, n_heads=n_heads,
                                      pack_items=pack_items, t_real=t_real,
                                      live_items=live_items)
    tensors = (q, ek, ev) if bias is None else (q, ek, ev, bias)
    if not _build.on_kernel_device(name, *tensors):
        return grouped_cross_attention_plain(q, ek, ev, bias,
                                             n_heads=n_heads,
                                             live_items=live_items)
    _build.check_vector_rows(name, d // n_heads, q, ek, ev)
    code, r = _build.dtype_code(q, name), q.shape[0] // g
    _build.check_smem(name, _build.smem_need(
        "dh_grouped_cross_attention_smem", code, r, t, d, n_heads), q)
    live, live_ptr = _build.count_args(name, g, live_items, q.device)
    out = torch.empty_like(q)
    err = _build.library().dh_grouped_cross_attention(
        code, q.data_ptr(), ek.data_ptr(), ev.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), g, live,
        live_ptr, r, t, d, n_heads, 1.0 / math.sqrt(d // n_heads),
        _build.stream_of(q))
    _build.check(err, name)
    _build.note_launch(name)
    return out
