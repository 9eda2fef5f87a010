"""``idle_share.gen``'s reading of the Kimi-VL cell, which reports
``captions_per_s``: the same quantity, listed for its cell."""

from perfbench.core import spec

read = spec.metric_reader("idle_share.gen")
