"""Faults planted in the program underneath a run, to show that the
comparison that decides ``correct`` catches them (``readings.py
--fault``, and the CPU tests). Each is a context manager that patches the
port while it is open (``planted(name)``; a train cell opens it in each
rank's process). For the captioning cells:

- ``token``: a token altered where it is produced: every draw of each
  97th row of the sampler's output is moved to the next id;
- ``half``: half of the batch left out: a generation call's second half
  of items is never computed, so their outputs keep the zeros (pads) of
  a fresh buffer.
"""

import contextlib


@contextlib.contextmanager
def token():
    from deephumor_tpu_torch.models import sampling

    orig = sampling._topk_space_draw

    def altered(u, logits, *args, **kwargs):
        tokens, scores = orig(u, logits, *args, **kwargs)
        # (top_k, k, inv_t, greedy, unk_index, sampler, classifier, ...)
        classifier = kwargs.get("classifier",
                                args[6] if len(args) > 6 else None)
        vocab = (logits.shape[-1] if classifier is None
                 else classifier[0].shape[0])
        tokens = tokens.clone()
        tokens[::97] = (tokens[::97] + 1) % vocab
        return tokens, scores

    sampling._topk_space_draw = altered
    try:
        yield
    finally:
        sampling._topk_space_draw = orig


@contextlib.contextmanager
def half():
    from deephumor_tpu_torch.models import caption_models as cm

    cls = cm.CaptioningTransformer
    orig = cls.generate_from_emb

    def halved(self, params, enc, *args, **kwargs):
        out = orig(self, params, enc, *args, **kwargs)
        h = enc[0].shape[0] // 2
        out = dict(out)
        for k in ("sequences", "chosen"):
            kept = out[k].clone()
            kept[h:] = 0
            out[k] = kept
        return out

    cls.generate_from_emb = halved
    try:
        yield
    finally:
        cls.generate_from_emb = orig


@contextlib.contextmanager
def unchanged():
    """A train step that returns its state unchanged: the step runs, and
    its parameters and moments are put back as they were."""
    import torch

    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    orig = Trainer._train_step

    def step(self, state, batch, gen, group=None):
        keep = [(t, t.detach().clone()) for t in (
            list(flatten_tree(state["params"]).values())
            + list(state["opt_state"]["mu"].values())
            + list(state["opt_state"]["nu"].values()))]
        new, metrics = orig(self, state, batch, gen, group)
        with torch.no_grad():
            for t, old in keep:
                t.copy_(old)
        return new, metrics

    Trainer._train_step = step
    try:
        yield
    finally:
        Trainer._train_step = orig


@contextlib.contextmanager
def half_rows():
    """Half of each rank's batch left out of the step, the loss's mean
    taken over the rest."""
    from deephumor_tpu_torch.experiments.trainer import Trainer

    orig = Trainer._loss

    def loss(self, params, batch, *args, **kwargs):
        n = batch["captions"].shape[0] // 2
        return orig(self, params, {k: v[:n] for k, v in batch.items()},
                    *args, **kwargs)

    Trainer._loss = loss
    try:
        yield
    finally:
        Trainer._loss = orig


@contextlib.contextmanager
def no_exchange():
    """The exchange between chips left out: the step's all-reduces do
    nothing, so each rank steps on its own shard."""
    from deephumor_tpu_torch.utils import collectives

    orig = collectives.dist.all_reduce
    collectives.dist.all_reduce = lambda x, group=None: None
    try:
        yield
    finally:
        collectives.dist.all_reduce = orig


FAULTS = {"token": token, "half": half, "unchanged": unchanged,
          "half_rows": half_rows, "no_exchange": no_exchange}


def planted(name):
    """The fault ``name``'s context, or a context that plants nothing."""
    return FAULTS[name]() if name else contextlib.nullcontext()
