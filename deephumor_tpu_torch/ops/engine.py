"""Beam-search survivor bookkeeping in one launch: the K10 kernel wrapper
and its twin.

Counterpart of deephumor_tpu/ops/pallas_engine.py. After the survivor
draw, the engine's default update is about ten small launches per step
(the candidate masks, the chosen-token and score gathers, the sequence
gather and append, the ended propagation and the model's ancestry and
validity shuffles). ``fused_survivor_update`` does all of it in one
kernel (ops/csrc/survivor_update.cu) for CUDA tensors; for CPU tensors it
runs the twin, which is that op sequence.

Semantics, per item b and survivor j (as pallas_engine.py states them)::

    branch, cand = divmod(surv[b, j], beam);  e = ended[b, branch]
    chosen[b, j] = pad_index if e else new_idx[b, branch, cand]
    val'[b, j]   = val[b, branch] + (0 if e else new_val[b, branch, cand])
    ended'[b, j] = e | (chosen[b, j] == eos_index)
    seq'[b, j]   = seq[b, branch];  seq'[b, j, pos] = chosen[b, j]
    anc'[b, j]   = anc[b, branch];  valid'[b, j] = valid[b, branch]

With ``live_items``, items at or past it (retired by early-EOS
compaction) are left exactly as they were and their ``chosen`` is
``pad_index``. The default engine keeps permuting such an item's
frozen-score branches, so the two agree draw for draw on every item when
compaction is off and on the live items when it is on.
"""

import torch

from deephumor_tpu_torch.ops import _build

__all__ = ["fused_survivor_update", "fused_survivor_update_plain"]


def _reference_update(new_idx, new_val, surv, ended, val, seq, anc, valid,
                      pos, *, beam, eos_index, pad_index):
    """The engine's op sequence over every item given."""
    num_items = surv.shape[0]
    new_idx_m = new_idx.masked_fill(ended[..., None], pad_index)
    cand_val = val[..., None] + new_val.masked_fill(ended[..., None], 0.0)
    branch = surv // beam
    chosen = new_idx_m.reshape(num_items, beam * beam).gather(1, surv)
    val_out = cand_val.reshape(num_items, beam * beam).gather(1, surv)
    rows = branch[..., None]
    seq_out = seq.gather(1, rows.expand_as(seq))
    seq_out[:, :, pos] = chosen
    ended_out = ended.gather(1, branch) | (chosen == eos_index)
    anc_out = anc.gather(1, rows.expand_as(anc))
    valid_out = valid.gather(1, rows.expand_as(valid))
    return chosen, val_out, ended_out, seq_out, anc_out, valid_out


def fused_survivor_update_plain(new_idx, new_val, surv, ended, val, seq,
                                anc, valid, pos, *, beam, eos_index,
                                pad_index, live_items=None):
    """Plain PyTorch twin of :func:`fused_survivor_update` (returns new
    tensors; the inputs are not changed)."""
    live = _build.live_count(surv.shape[0], live_items)
    ref = _reference_update(
        new_idx[:live], new_val[:live], surv[:live], ended[:live],
        val[:live], seq[:live], anc[:live], valid[:live], pos, beam=beam,
        eos_index=eos_index, pad_index=pad_index)
    if live == surv.shape[0]:
        return ref
    chosen = torch.full_like(surv, pad_index)
    outs = [chosen] + [x.clone() for x in (val, ended, seq, anc, valid)]
    for out, part in zip(outs, ref):
        out[:live] = part
    return tuple(outs)


def _check(new_idx, new_val, surv, ended, val, seq, anc, valid, pos, beam):
    name = "fused_survivor_update"
    b = surv.shape[0]
    shapes = {"new_idx": (new_idx, (b, beam, beam), torch.int64),
              "new_val": (new_val, (b, beam, beam), torch.float32),
              "surv": (surv, (b, beam), torch.int64),
              "ended": (ended, (b, beam), torch.bool),
              "val": (val, (b, beam), torch.float32),
              "seq": (seq, (b, beam, seq.shape[-1]), torch.int64),
              "anc": (anc, (b, beam, anc.shape[-1]), torch.int64),
              "valid": (valid, (b, beam, anc.shape[-1]), torch.bool)}
    for key, (t, shape, dtype) in shapes.items():
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {dtype} {list(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not 0 <= pos < seq.shape[-1]:
        raise ValueError(f"{name}: pos {pos} outside the sequence length "
                         f"{seq.shape[-1]}")


def fused_survivor_update(new_idx, new_val, surv, ended, val, seq, anc,
                          valid, pos, *, beam, eos_index, pad_index,
                          live_items=None):
    """K10: the whole post-draw survivor update (see the module docstring).

    The kernel updates ``val``, ``ended``, ``seq``, ``anc`` and ``valid``
    IN PLACE and returns them; the twin returns new tensors. Either way
    the caller goes on with the returned tensors only.

    Args:
        new_idx, new_val: ``[B, beam, beam]`` int64 / f32 raw candidates
            of the per-branch draw (ended branches are masked here).
        surv: ``[B, beam]`` int64 flat candidate picks of the survivor
            draw, in ``[0, beam*beam)``.
        ended, val: ``[B, beam]`` bool / f32, before the update.
        seq: ``[B, beam, L]`` int64; ``pos`` is the column written.
        anc: ``[B, beam, P]`` int64 ancestry table.
        valid: ``[B, beam, P]`` bool (the engine's flat ``[B*beam, P]``
            reshaped by the caller).
        live_items: optional host int, as in the attention kernels.

    Returns:
        ``(chosen [B, beam] int64, val', ended', seq', anc', valid')``.
    """
    name = "fused_survivor_update"
    _check(new_idx, new_val, surv, ended, val, seq, anc, valid, pos, beam)
    kw = dict(beam=beam, eos_index=eos_index, pad_index=pad_index,
              live_items=live_items)
    args = (new_idx, new_val, surv, ended, val, seq, anc, valid)
    if not _build.on_kernel_device(name, *args):
        return fused_survivor_update_plain(*args, pos, **kw)
    if beam > 128:
        raise ValueError(f"{name}: beam {beam} above the kernel's 128")
    b = surv.shape[0]
    chosen = torch.empty_like(surv)
    err = _build.library().dh_fused_survivor_update(
        *(t.data_ptr() for t in args), chosen.data_ptr(), b,
        _build.live_count(b, live_items), beam, seq.shape[-1],
        anc.shape[-1], pos, eos_index, pad_index, _build.stream_of(surv))
    _build.check(err, name)
    _build.note_launch(name)
    return chosen, val, ended, seq, anc, valid
