"""``mfu.gen``'s reading of the char cell, which reports
``captions_per_s.char``: the same quantity, a metric of its own so
that each configuration's throughput keeps a bound of its own."""

from perfbench.core import spec

read = spec.metric_reader("mfu.gen")
