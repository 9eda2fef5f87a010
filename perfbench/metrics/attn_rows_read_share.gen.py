"""The rows that decode self-attention reads, as a share of the rows in
its dense span, in %: the program's counters ``attn.rows_read`` over
``attn.rows_span`` (models/sampling.py ``fold_rows_tally``, from the
device tally to which each head-0 block of K1, K6 and K7 adds the
(slot, position) rows of its row list and of its item's whole span),
over the traced window. None where the program keeps no such counter."""


def read(ctx):
    if ctx.get("kind") != "offline":
        return None
    try:
        from deephumor_tpu_torch.utils import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "counts", None)
    if counts is None:
        return None
    c = counts()
    span = c.get("attn.rows_span", 0)
    return 100.0 * c.get("attn.rows_read", 0) / span if span else None
