"""Rank 0's peak of allocated device memory over the run
(``torch.cuda.max_memory_allocated``), in GiB: the state, Adam's
moments, the step's graph and its pool."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["peak_rank0"]:
        return None
    return ctx["peak_rank0"] / 2 ** 30
