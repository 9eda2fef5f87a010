"""``device_ms_per_call.gen``'s reading of the Kimi-VL cell, which reports
``captions_per_s``: the same quantity, listed for its cell."""

from perfbench.core import spec

read = spec.metric_reader("device_ms_per_call.gen")
