"""The device's idle share of the traced window, in %: 100 times one
minus the union of its kernel, copy and set intervals over the window's
length (torch.profiler), averaged over the chips of the run."""

KIND = "offline"


def read(ctx):
    sums = ctx.get("summaries") or ([ctx["trace"]] if ctx.get("trace")
                                    else [])
    if ctx.get("kind") != KIND or not sums:
        return None
    busy = sum(s["busy_s"] / s["window_s"] for s in sums) / len(sums)
    return 100.0 * (1.0 - busy)
