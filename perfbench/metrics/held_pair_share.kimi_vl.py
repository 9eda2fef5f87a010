"""The share of routed (token, expert) pairs that land on the experts
held here, in %: the program's counters ``moe.pairs_held`` over
``moe.pairs`` (ops/moe.py's device tally, folded at the host reads of
the traced window: models/sampling.py ``fold_moe_tally``). None where
the program keeps no such counter."""


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
    pairs = c.get("moe.pairs", 0)
    return 100.0 * c.get("moe.pairs_held", 0) / pairs if pairs else None
