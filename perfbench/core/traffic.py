"""The one generator of the cells' traffic: what a mix's data file
(``traffic/<mix>.json``) states, drawn from the run's seed.

A mix states the popularity of the templates that its requests ask for
(``"popularity"``) and, where requests arrive on a clock, their arrival
process (``"arrivals"``). A new mix is a new data file over the laws and
processes here.
"""

import math

import numpy as np


def picks(popularity, templates, n, rng):
    """``n`` template indices in ``[0, templates)``.

    - ``{"law": "uniform"}``: every template alike;
    - ``{"law": "zipf", "s": s}``: the template of rank r asked in
      proportion to ``r ** -s``, the ranks a permutation of the
      templates.
    """
    law = popularity["law"]
    if law == "uniform":
        return rng.integers(0, templates, n)
    if law == "zipf":
        weights = 1.0 / np.arange(1, templates + 1) ** popularity["s"]
        ranked = rng.permutation(templates)
        return ranked[rng.choice(templates, size=n,
                                 p=weights / weights.sum())]
    raise ValueError(f"unknown popularity law {law!r}")


def arrivals(process, rate, seconds, rng):
    """Sorted arrival offsets in ``[0, seconds)``, ``round(rate *
    seconds)`` of them whatever the seed (so every seed sends the same
    work, in another order).

    - ``{"process": "poisson"}``: uniform over the window, a Poisson
      process given its count;
    - ``{"process": "on_off", "on_s": a, "off_s": b}``: bursts: cycles of
      ``a`` seconds on and ``b`` off from the window's start, the
      arrivals uniform over the on-periods, so the mean rate is ``rate``
      and the rate in a burst ``rate * (a + b) / a``.
    """
    n = int(round(rate * seconds))
    kind = process["process"]
    if kind == "poisson":
        return np.sort(rng.uniform(0.0, seconds, n))
    if kind == "on_off":
        on, cycle = process["on_s"], process["on_s"] + process["off_s"]
        starts = np.arange(math.ceil(seconds / cycle)) * cycle
        lengths = np.minimum(starts + on, seconds) - starts
        ends = np.concatenate([[0.0], np.cumsum(lengths)])
        u = np.sort(rng.uniform(0.0, ends[-1], n))
        burst = np.searchsorted(ends, u, side="right") - 1
        return starts[burst] + (u - ends[burst])
    raise ValueError(f"unknown arrival process {kind!r}")
