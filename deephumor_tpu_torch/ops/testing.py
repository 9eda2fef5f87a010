"""Synthetic decode states for holding the canonical-prefix kernels (K5,
K6) against their plain twins: the card tests and ``chip_smoke.py`` build
their inputs here, so both check the same kind of state."""

import torch

from deephumor_tpu_torch.ops.attention import MASK_FILL, ancestry_bias

__all__ = ["canon_state"]


def canon_state(*, items, beam, p, c, pe, d, dtype, generator, stragglers,
                pos=None):
    """A decode state at position ``pos`` (default ``pe - 1``) in which
    every item but those listed in ``stragglers`` agrees on its ancestry
    below ``c``.

    Returns a dict of CUDA or CPU tensors (the generator's device): ``q``,
    ``kn``, ``vn`` ``[items * beam, d]``; caches ``ck``, ``cv``
    ``[items * beam, p, d]``; the shared caches ``sk``, ``sv``
    ``[items, c, d]`` gathered along each item's path; ``bias_sh``
    ``[items, 1, c]``, the window bias ``bias_win`` over ``[c, pe)`` and
    the full ancestry bias ``bias``; and the int ``pos``.
    """
    dev = generator.device

    def rnd(*shape):
        return torch.randn(shape, generator=generator, device=dev).to(dtype)

    def randint(*shape):
        return torch.randint(0, beam, shape, generator=generator, device=dev)

    rows, pos = items * beam, pe - 1 if pos is None else pos
    ck, cv = rnd(rows, p, d), rnd(rows, p, d)
    path = randint(items, p)
    anc = path[:, None, :].repeat(1, beam, 1)
    anc[:, :, c:] = randint(items, beam, p - c)
    strag = torch.as_tensor(list(stragglers), dtype=torch.long, device=dev)
    anc[strag] = randint(len(strag), beam, p)
    valid = torch.rand(rows, p, generator=generator, device=dev) < 0.9
    valid[:, pos + 1:] = False
    valid[:, 0] = valid[:, pos] = True
    valid = valid.reshape(items, beam, p)
    valid[:, :, :c] = valid[:, :1, :c].clone()  # one validity below c
    valid = valid.reshape(rows, p)
    item = torch.arange(items, device=dev)[:, None]
    sk, sv = (x[item * beam + path[:, :c], torch.arange(c, device=dev)]
              for x in (ck, cv))
    bias_sh = torch.where(valid.reshape(items, beam, p)[:, :1, :c], 0.0,
                          MASK_FILL).float()
    return dict(q=rnd(rows, d), kn=rnd(rows, d), vn=rnd(rows, d), ck=ck,
                cv=cv, sk=sk, sv=sv, bias_sh=bias_sh,
                bias_win=ancestry_bias(anc[:, :, c:pe], valid[:, c:pe],
                                       pe - c),
                bias=ancestry_bias(anc, valid, p), pos=pos)
