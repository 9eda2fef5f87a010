"""The most-loaded held expert over the mean held expert, summed over the
window's layer-steps: the program's counter ``moe.held_load_max`` (each
expert layer's largest held expert's pairs) over ``moe.pairs_held`` /
the experts held (``n_routed_experts``). 1 is an even spread; the
grouped products wait on the largest expert. None where the program
keeps no such counter."""


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
    held = c.get("moe.pairs_held", 0)
    if not held:
        return None
    return c.get("moe.held_load_max", 0) / (
        held / ctx["config"]["n_routed_experts"])
