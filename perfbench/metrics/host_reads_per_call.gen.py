"""Host reads a generation call, over the traced window: the program's
``host_read`` spans (models/sampling.py ``host_read``: each drains the
device's queue before the host launches more) over its
``model.generate`` spans (the calls of ``generate_from_emb``). None
where the program records no span."""


def read(ctx):
    if ctx.get("kind") != "offline":
        return None
    try:
        from deephumor_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    names = [r.name for r in records()]
    calls = names.count("model.generate")
    return names.count("host_read") / calls if calls else None
