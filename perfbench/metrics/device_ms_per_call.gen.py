"""Device time of one generation call, in ms: the kernels', copies' and
sets' time inside the traced window (torch.profiler), over the calls the
window made."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "offline" or not tr or not ctx["calls"]:
        return None
    return 1e3 * sum(tr["kernel_s"].values()) / ctx["calls"]
