"""Graph keys captured inside the window (``graphs.cache_info()``'s keys
after the window less those before it): a count, 0 when set-up warmed
every shape that the traffic uses."""


def read(ctx):
    if ctx.get("kind") != "offline":
        return None
    return ctx["captures"]
