"""All-reduces a train step makes on a rank (``utils.collectives``'
counts, a captured step's tally added at each replay), over the window's
steps: the batch norm's moments and their gradient, the loss's
denominators, the gradients with the loss."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    return ctx["reduces_per_step"]
