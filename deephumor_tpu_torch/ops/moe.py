"""The sparse expert layer's routing, its permutation of (token, expert)
pairs and its combine, with no host read (models/mla_moe.py).

DeepSeek-V3's router (Kimi-VL's language model): sigmoid scores over
every routed expert in f32, the top ``k`` of the scores plus a per-expert
correction bias (``noaux_tc`` with one group), the weights the unbiased
scores at the selected experts over their sum, times a scaling factor.
A layer that holds a contiguous range of the experts (one card's share
under expert parallelism) routes over all of them and computes only the
pairs that land on its own: those are sorted into expert order
(:func:`dispatch`), their tokens' rows gathered in that order
(:func:`gather_pairs`), multiplied by their expert's SwiGLU in two
grouped products over device offsets (:func:`expert_products`:
``torch._grouped_mm``), and added back to their tokens with their
weights, after the shared experts' output (:func:`combine`). What the
absent experts would add is left out. Every buffer is sized for every
pair held, so shapes stay static and a step captures as a CUDA graph;
the grouped products compute only the rows below the last offset, and
on the card the gather, the SwiGLU between the products and the combine
are kernels of their own (ops/csrc/moe.cu) that read that offset from
device memory and touch only the held rows (bf16 rows whose width is a
multiple of 8; other CUDA tensors raise). On the CPU their plain twins
compute every row.

A device tally per device (``moe_tally``: int64 ``[3]``: pairs routed,
pairs held, and the largest held expert's pairs summed over layer-steps)
takes each layer's counts; ``models/sampling.py`` folds it into the
profiling counters ``moe.pairs``, ``moe.pairs_held`` and
``moe.held_load_max`` at a host read while a profiler records.
"""

import threading

import torch
import torch.nn.functional as F

from deephumor_tpu_torch.ops import _build
from deephumor_tpu_torch.utils import profiling

__all__ = ["route", "dispatch", "gather_pairs", "gather_pairs_plain",
           "swiglu_rows", "swiglu_rows_plain", "expert_products", "combine",
           "combine_plain", "note", "moe_tally", "moe_tally_totals",
           "swiglu"]

_TALLY = {}
_TALLY_LOCK = threading.Lock()


def moe_tally(device):
    """int64 ``[3]`` on ``device`` (pairs, held pairs, summed largest held
    load), made at the first call there outside a capture (a generation
    call's eager warm-up runs before its capture), so that a graph bakes an
    address that outlives it; None on the CPU, and while this thread
    captures before it exists."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = _TALLY.get(device)
    if t is None and not torch.cuda.is_current_stream_capturing():
        with _TALLY_LOCK:
            t = _TALLY.get(device)
            if t is None:
                t = _TALLY[device] = torch.zeros(3, dtype=torch.int64,
                                                 device=device)
    return t


def moe_tally_totals(device):
    """The tally of ``device`` read from the device, or None where no
    layer has made it."""
    device = torch.device(device)
    if device.index is None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    t = _TALLY.get(device)
    return None if t is None else t.tolist()


def swiglu(x, gate_up, down):
    """``down(silu(gate x) * up x)`` with ``gate_up`` the gate's rows then
    the up projection's (``[2I, D]``) and ``down`` ``[D, I]``."""
    gu = F.linear(x, gate_up)
    i = gu.shape[-1] // 2
    return F.linear(F.silu(gu[..., :i]) * gu[..., i:], down)


def route(h, w_gate, e_bias, *, top_k, scaling):
    """The experts of each token and their weights: ``s = sigmoid(h
    w_gateᵀ)`` in f32 over every routed expert, the ``top_k`` of ``s +
    e_bias``, and ``s`` there over its sum times ``scaling``. Returns
    (ids ``[T, top_k]`` int64, weights ``[T, top_k]`` f32)."""
    with profiling.span("moe.route"):
        s = torch.sigmoid(F.linear(h.float(), w_gate.float()))
        ids = torch.topk(s + e_bias.float(), top_k, dim=-1).indices
        w = s.gather(-1, ids)
        return ids, w * (scaling / w.sum(-1, keepdim=True))


def dispatch(ids, first, held):
    """The pairs whose expert is one of the ``held`` experts from
    ``first``, in expert order: (``order`` ``[P]``: pair ids (token * k +
    j) sorted by local expert, the pairs of other experts last;
    ``offs`` ``[held]`` int32: each held expert's end in ``order``;
    ``mask`` ``[P]`` bool: the pair is held; ``counts`` ``[held]``)."""
    local = ids.reshape(-1) - first
    mask = (local >= 0) & (local < held)
    key = torch.where(mask, local, held)
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(held + 1, dtype=torch.int64, device=ids.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    offs = counts[:held].cumsum(0).to(torch.int32)
    return order, offs, mask, counts[:held]


def _on_card(name, rows, width, *others):
    """Whether the kernel ``name`` runs (CUDA tensors) or its plain twin
    (CPU tensors). On the card the kernel takes bf16 ``rows`` whose
    ``width`` is a multiple of 8 (16-byte vectors); anything else raises
    ``ValueError`` before the launch."""
    if not _build.on_kernel_device(name, *rows, *others):
        return False
    if any(t.dtype != torch.bfloat16 for t in rows) or width % 8:
        raise ValueError(f"{name}: the kernel takes bf16 rows of a width "
                         f"that is a multiple of 8; got "
                         f"{[str(t.dtype) for t in rows]}, width {width}")
    return True


def gather_pairs_plain(h, order, offs, k):
    """Plain PyTorch twin of :func:`gather_pairs`: every row gathered."""
    return h.index_select(0, order // k)


def gather_pairs(h, order, offs, k):
    """``[P, D]``: row r holds the row of ``h`` ``[T, D]`` of the token of
    sorted pair ``order[r]`` (``order // k``); on the card only the held
    rows (r < ``offs[-1]``) are written, the rest are undefined."""
    if not _on_card("moe_gather", (h,), h.shape[1], order, offs):
        return gather_pairs_plain(h, order, offs, k)
    out = h.new_empty((order.numel(), h.shape[1]))
    err = _build.library().dh_moe_gather(
        h.data_ptr(), order.data_ptr(), out.data_ptr(),
        offs[-1:].data_ptr(), order.numel(), k, h.shape[1],
        _build.stream_of(h))
    _build.check(err, "moe_gather")
    _build.note_launch("moe_gather")
    return out


def swiglu_rows_plain(gu, offs):
    """Plain PyTorch twin of :func:`swiglu_rows`: every row."""
    i = gu.shape[-1] // 2
    return F.silu(gu[:, :i]) * gu[:, i:]


def swiglu_rows(gu, offs):
    """``silu(gu[:, :I]) * gu[:, I:]`` of the grouped products' rows; on
    the card only the rows below ``offs[-1]``, in f32, rounded once."""
    i = gu.shape[-1] // 2
    if not _on_card("moe_swiglu", (gu,), i, offs):
        return swiglu_rows_plain(gu, offs)
    a = gu.new_empty((gu.shape[0], i))
    err = _build.library().dh_moe_swiglu(
        gu.data_ptr(), a.data_ptr(), offs[-1:].data_ptr(), gu.shape[0], i,
        _build.stream_of(gu))
    _build.check(err, "moe_swiglu")
    _build.note_launch("moe_swiglu")
    return a


def expert_products(x, gate_up, down, offs):
    """Each held expert's SwiGLU over its rows of ``x`` ``[P, D]`` (rows in
    expert order, expert e's ending at ``offs[e]``): two grouped products
    with the experts' ``gate_up`` ``[E, 2I, D]`` and ``down`` ``[E, D,
    I]``. Rows past ``offs[-1]`` are not computed: their values are
    undefined."""
    gu = torch._grouped_mm(x, gate_up.transpose(1, 2), offs=offs)
    return torch._grouped_mm(swiglu_rows(gu, offs), down.transpose(1, 2),
                             offs=offs)


def _inverse(order):
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return inv


def combine_plain(y, order, mask, w, base):
    """Plain PyTorch twin of :func:`combine`."""
    t, k = w.shape
    yp = y.index_select(0, _inverse(order)).float()
    yp = torch.where(mask[:, None], yp * w.reshape(-1, 1), 0.0)
    return (yp.reshape(t, k, -1).sum(1) + base.float()).to(base.dtype)


def combine(y, order, mask, w, base):
    """``base`` ``[T, D]`` (the shared experts' output) plus the held
    pairs' outputs ``y`` ``[P, D]`` (in ``order``'s order) on their
    tokens, weighted by ``w`` ``[T, k]``, summed in f32 and rounded once
    to ``base``'s dtype. A pair of an absent expert adds nothing (its row
    of ``y`` is never read into the sum)."""
    if not _on_card("moe_combine", (base, y), base.shape[1], order, w,
                    mask):
        return combine_plain(y, order, mask, w, base)
    t, k = w.shape
    inv = _inverse(order)
    w = w.contiguous()
    out = torch.empty_like(base)
    err = _build.library().dh_moe_combine(
        base.data_ptr(), y.data_ptr(), inv.data_ptr(), w.data_ptr(),
        mask.data_ptr(), out.data_ptr(), t, k, base.shape[1],
        _build.stream_of(base))
    _build.check(err, "moe_combine")
    _build.note_launch("moe_combine")
    return out


def note(counts, pairs, tally):
    """Adds one layer's counts to ``tally`` (nothing for None): its
    ``pairs``, the held pairs and the largest held expert's pairs."""
    if tally is not None:
        # a fill, not a copy from the host: a captured step may hold it
        tally.add_(torch.stack([torch.full_like(counts[0], pairs),
                                counts.sum(), counts.max()]))
