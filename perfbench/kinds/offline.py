"""Bulk captioning from cached template features: ``generate_from_emb``
calls of ``items_per_call`` memes back to back for the whole window.

Set-up makes the weights and a store of ``templates`` prompts (the
model's: start and spatial embeddings) on the device from the seed, and
a schedule of template ids for each call, drawn by the mix's popularity
law; the first two calls (of other draws than the window's) build the
kernels, capture the key and replay it. The window then runs
calls until ``--seconds`` have passed, each on the next ids of the
schedule and a generator of its own. ``captions_per_s`` counts the
captions that pass the gates over the window's whole time. Once the
window has closed, a sample of the window's captions drawn from the
seed, the longest among them, is judged against the reference.
"""

import time

import numpy as np
import torch

from perfbench import faults
from perfbench.core import captioning as cap
from perfbench.core import spec, trace
from perfbench.core import traffic as mix


def inputs(cfg, traffic, seed, device):
    """The template store (the model's prompts, each ``[P, ...]``) and the
    schedule of ids ``[calls, items]`` (a cycle that the window walks),
    drawn by the traffic's popularity law."""
    p = traffic["templates"]
    gen = torch.Generator(device).manual_seed(
        spec.derive_seed(seed, "features"))
    store = spec.model(cfg).prompts(cfg, p, gen, device)
    rng = np.random.default_rng(spec.derive_seed(seed, "schedule"))
    calls, items = traffic["schedule_calls"], traffic["items_per_call"]
    ids = mix.picks(traffic["popularity"], p, calls * items, rng)
    return store, torch.as_tensor(ids.reshape(calls, items), device=device)


def run(cell, seed, seconds, traced, t0, device, limits, control=False,
        fault=None):
    with faults.planted(fault):
        return _run(cell, seed, seconds, traced, t0, device, limits,
                    control)


def _run(cell, seed, seconds, traced, t0, device, limits, control):
    from deephumor_tpu_torch.models import graphs

    cfg, traffic = cell.config, cell.traffic
    phases = trace.Phases(t0)
    phases("start")
    model = cap.make_model(cfg)
    params = cap.make_params(cfg, seed, device, encoder=False)
    store, ids = inputs(cfg, traffic, seed, device)
    kw = cap.generate_kwargs(cfg)
    spans = trace.Spans(traced)
    phases("weights and inputs")

    def call(c):
        rows = ids[c % ids.shape[0]]
        gen = torch.Generator(device).manual_seed(
            spec.derive_seed(seed, 1000 + c))
        with spans("generate"):
            return model.generate_from_emb(
                params, tuple(t[rows] for t in store), generator=gen, **kw)

    for c in (-2, -1):
        call(c)
    keys_before = len(graphs.cache_info())
    spec.settle()
    sync(device)
    phases("build, capture, replay")
    phases.report()
    prof = trace.profiler() if traced else None
    if prof is not None:
        prof.start()
    setup_s = time.perf_counter() - t0
    outs = []
    with spans("window"):
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            outs.append(call(len(outs)))
        sync(device)
        window_s = time.perf_counter() - w0
    summary = None
    if prof is not None:
        prof.stop()
        summary = trace.reduce_trace(
            prof, spec.CACHE_DIR / f"trace-{cell.name}.json",
            (device.index or 0) if device.type == "cuda" else None)
    keys_after = len(graphs.cache_info())
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    n_items = traffic["items_per_call"]
    bad = torch.stack([cap.gate_failures(o, cfg["num_tokens"])
                       for o in outs])
    failed = int(bad.sum())
    attempted = n_items * len(outs)
    max_len = cfg["generation"]["max_len"]
    lasts = [cap.item_last(o, max_len).cpu() for o in outs]
    chosen = torch.stack([o["chosen"] for o in outs]).reshape(-1, max_len)
    del outs
    graphs.clear()
    readings = judge(cfg, traffic, params, store, ids, chosen, seed,
                     control)
    readings["failed"] = failed
    readings["mean_len"] = float(
        cap.ref.served_lengths(chosen, cap.EOS).float().mean())
    correct, checks = cap.verdict(readings, limits, failed)
    ctx = {"kind": "offline", "config": cfg, "traffic": traffic,
           "calls": len(chosen) // n_items, "window_s": window_s,
           "live": cap.live_per_step(lasts, max_len), "trace": summary,
           "captures": keys_after - keys_before}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "e2e": {"captions_per_s": (attempted - failed) / window_s,
                    "setup_s": setup_s},
            "ctx": ctx, "summaries": [summary] if summary else [],
            "memory_peak_bytes": peak,
            "checks": checks,
            "readings": readings}


def judge(cfg, traffic, params, store, ids, chosen, seed, control=False):
    """The reference's readings of a sample of the window's captions."""
    n_items = traffic["items_per_call"]
    lengths = cap.ref.served_lengths(chosen, cap.EOS)
    rows = cap.sample_rows(chosen.shape[0], traffic["check_items"], seed,
                           int(lengths.argmax()))
    rows_t = torch.as_tensor(rows, device=chosen.device)
    templates = ids[rows_t // n_items % ids.shape[0], rows_t % n_items]
    prompts = tuple(t[templates] for t in store)
    return cap.check(cfg, params["decoder"], prompts, chosen[rows_t], seed,
                     control=control)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
