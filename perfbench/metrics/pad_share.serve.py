"""The share of the window's device rows that were padding, in %:
``100 * (1 - sum(batch_sizes) / sum(pad_sizes))`` of the batcher's
dispatches (a dispatch pads to its bucket)."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["pads"]:
        return None
    return 100.0 * (1.0 - sum(ctx["batches"]) / sum(ctx["pads"]))
