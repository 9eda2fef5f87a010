"""The batcher's mean dispatch size over the window, in requests:
``DynamicBatcher.batch_sizes`` of the dispatches that the window's
requests made."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["batches"]:
        return None
    return sum(ctx["batches"]) / len(ctx["batches"])
