"""The readers of the program's counters (``metrics/*`` over
``deephumor_tpu_torch.utils.profiling.counts()``) on given counts: each
reading, None off its kind, and None from a program that keeps no such
counter."""

import pytest

from perfbench.core import spec
from deephumor_tpu_torch.utils import profiling


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


@pytest.mark.parametrize("name", ["attn_rows_read_share.gen",
                                  "attn_rows_read_share.char"])
def test_attn_rows_read_share(monkeypatch, name):
    def counted(c):
        monkeypatch.setattr(profiling, "counts", lambda: dict(c),
                            raising=False)

    counted({"attn.rows_read": 1300, "attn.rows_span": 5200, "other": 9})
    assert read(name, {"kind": "offline"}) == pytest.approx(25.0)
    assert read(name, {"kind": "serve"}) is None
    assert read(name, {}) is None
    # no counter recorded (an untraced window, or no kernel ran)
    counted({})
    assert read(name, {"kind": "offline"}) is None
    counted({"attn.rows_read": 0, "attn.rows_span": 0})
    assert read(name, {"kind": "offline"}) is None
    # a program without counters (the commit before them)
    monkeypatch.delattr(profiling, "counts", raising=False)
    assert read(name, {"kind": "offline"}) is None
