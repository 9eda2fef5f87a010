"""Training: ``Trainer.run_epoch`` over a data mesh of one process a
card (NCCL; gloo on the CPU), each global batch of ``batch`` captions
split over the ranks, features from a seeded trunk cache.

Set-up makes, on every rank alike, the weights (the decoder and the
encoder's head; the trunk is frozen and its features cached), a trunk
cache of ``templates`` seeded ``[7, 7, 2048]`` features, and a pool of
``pool_batches`` global batches of captions drawn from the seed (lengths
as memes900k's: at most 31 words, mean in the low teens; then EOS and
pads), every row distinct. The trainer then takes its first three steps,
one ``run_epoch`` each on the pool's first batches (the first step runs
eagerly and captures the step's graph), at dropout 0: the reference
follows these, and it cannot draw the step's masks. The same trainer
then takes the configuration's dropout (a graph of its own, captured by
one epoch) and two warm epochs of 2 and ``warm_steps`` steps, which rank
0 times: the window is one epoch of as many steps as fill ``--seconds``
at that rate (every rank is told the count), so the epoch's own start
and flush weigh on it as on a real epoch's. ``examples_per_s`` counts the
window's global rows over its time. Rank 0 keeps the first three steps'
losses, Adam's first moments after step 1 and the parameters after step
3; once the window has closed and the program's state is freed, the
reference follows the same three steps from the same weights and batches
(the model's ``train_steps``: reference/train.py).
"""

import dataclasses
import math
import os
import socket
import time

import numpy as np
import torch

from perfbench import faults
from perfbench.core import spec, trace, weights
from perfbench.reference import train as ref

RESULT_WAIT_S = 600.0


def make_params(cfg, seed, device):
    """The train state's seeded weights: the decoder and the encoder's
    head (the frozen trunk's features come from the cache)."""
    return weights.make(spec.model(cfg).weight_spec(cfg, "head"),
                        spec.derive_seed(seed, "weights"), device)


def set_dropout(trainer, enc, dec):
    """The trainer's model, and the model its steps run, at dropout
    ``enc`` and ``dec``: a captured step's key holds the model, so each
    dropout is a graph of its own; the graphs of the dropout before are
    freed."""
    trainer._graphs.clear()
    trainer.model = dataclasses.replace(trainer.model, enc_dropout=enc,
                                        dec_dropout=dec)
    trainer._step_model = dataclasses.replace(
        trainer._step_model, enc_dropout=enc, dec_dropout=dec)


def trunk_cache(traffic, seed, device):
    gen = torch.Generator(device).manual_seed(
        spec.derive_seed(seed, "trunk"))
    return torch.randn(traffic["templates"], 7, 7, 2048, generator=gen,
                       device=device)


def batches(cfg, traffic, seed):
    """The pool: global batches ``{"captions": [B, T + 1] int64,
    "image_rows": [B] int64}`` (numpy), every row distinct."""
    rng = np.random.default_rng(spec.derive_seed(seed, "captions"))
    b, t = traffic["batch"], traffic["caption_tokens"]
    out = []
    for _ in range(traffic["pool_batches"]):
        words = np.clip(np.rint(rng.lognormal(
            math.log(traffic["words_median"]), traffic["words_sigma"], b)),
            1, t - 2).astype(np.int64)
        caps = np.zeros((b, t), np.int64)
        toks = rng.integers(6, cfg["num_tokens"], (b, t))
        pos = np.arange(t)[None]
        caps = np.where(pos < words[:, None], toks, caps)
        caps[np.arange(b), words] = 3  # EOS
        out.append({"captions": caps,
                    "image_rows": rng.integers(0, traffic["templates"], b)})
    return out


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell, seed, seconds, traced, t0, device, limits, control=False,
        fault=None):
    """Runs the ranks (spawned processes on the card; ``device`` cpu:
    gloo processes on the CPU) and returns rank 0's outcome."""
    import torch.multiprocessing as mp

    world = cell.chips
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(
        r, world, port, cell, seed, seconds, traced, t0, device.type,
        limits, control, fault, queue)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        end = time.monotonic() + RESULT_WAIT_S + seconds
        while True:
            try:
                out = queue.get(timeout=1.0)
                break
            except Exception:  # noqa: BLE001 — queue.Empty: poll the ranks
                bad = [p.exitcode for p in procs if p.exitcode]
                if bad or time.monotonic() > end:
                    raise RuntimeError(f"a train rank failed ({bad})")
        for p in procs:
            p.join(timeout=120)
        if any(p.exitcode for p in procs):
            raise RuntimeError("a train rank failed after its result")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)


def _rank(rank, world, port, cell, seed, seconds, traced, t0, dev_type,
          limits, control, fault, queue):
    with faults.planted(fault):
        _rank_run(rank, world, port, cell, seed, seconds, traced, t0,
                  dev_type, limits, control, queue)


def _rank_run(rank, world, port, cell, seed, seconds, traced, t0, dev_type,
              limits, control, queue):
    import torch.distributed as dist

    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.parallel import make_mesh
    from deephumor_tpu_torch.utils import collectives

    phases = trace.Phases(t0)
    phases("spawn")
    os.environ["LOCAL_RANK"] = str(rank)
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    mesh = make_mesh(dev_type)
    phases("process group")
    cfg, traffic = cell.config, cell.traffic
    lead = rank == 0
    trainer = Trainer(spec.model(cfg).build(cfg), phases=(),
                      compute_dtype=cfg["compute_dtype"],
                      device=device, learning_rate=traffic["learning_rate"],
                      clip_norm=traffic["clip_norm"],
                      log_dir=str(spec.CACHE_DIR / "logs"))
    state = trainer.init_state(params=make_params(cfg, seed, device))
    trainer._trunk_cache = trunk_cache(traffic, seed, device)
    pool = batches(cfg, traffic, seed)
    gen = torch.Generator(device).manual_seed(
        spec.derive_seed(seed, "dropout"))
    spans = trace.Spans(traced)
    phases("weights and batches")

    def epoch(chunk):
        nonlocal state
        with spans("epoch"):
            state, loss, _ = trainer.run_epoch(state, chunk, gen, mesh=mesh)
        return loss

    # the first three steps, which the reference follows: at dropout 0,
    # since the reference cannot draw the step's masks
    set_dropout(trainer, 0.0, 0.0)
    losses, mu1, after3 = [], None, None
    for i in range(3):
        losses.append(epoch([pool[i]]))
        if lead and i == 0:
            mu1 = {k: v.detach().to("cpu", copy=True)
                   for k, v in state["opt_state"]["mu"].items()}
    if lead:
        from deephumor_tpu_torch.utils.pytree import flatten_tree
        after3 = {k: v.detach().to("cpu", copy=True)
                  for k, v in flatten_tree(state["params"]).items()}
    phases("checked steps")
    # then the configuration's dropout: one epoch captures its step, two
    # warm epochs, timed on rank 0, set the window: one epoch of as many
    # steps as fill ``seconds`` at their rate (an epoch's own start and
    # flush amortize over it, as over a real epoch's)
    set_dropout(trainer, cfg["enc_dropout"], cfg["dec_dropout"])
    epoch([pool[3]])
    phases("capture at dropout")
    warm = traffic["warm_steps"]
    marks = []
    for n in (2, warm):
        if dev_type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        epoch([pool[(4 + j) % len(pool)] for j in range(n)])
        marks.append(time.perf_counter() - t)
    per_step = max((marks[1] - marks[0]) / (warm - 2), 1e-4)
    steps_t = torch.tensor([float(math.ceil(seconds / per_step))],
                           device=device)
    dist.broadcast(steps_t, 0)
    steps = int(steps_t.item())
    window = [pool[(4 + warm + j) % len(pool)] for j in range(steps)]
    reduces0 = sum(collectives.COUNTS.values())
    spec.settle()
    phases("warm epochs")
    if lead:
        phases.report()
    prof = trace.profiler() if traced else None
    if prof is not None:
        prof.start()
    setup_s = time.perf_counter() - t0
    with spans("window"):
        w0 = time.perf_counter()
        epoch(window)
        if dev_type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - w0
    summary = None
    if prof is not None:
        prof.stop()
        summary = trace.reduce_trace(
            prof, spec.CACHE_DIR / f"trace-{cell.name}-{rank}.json",
            rank if dev_type == "cuda" else None)
    reduces = sum(collectives.COUNTS.values()) - reduces0
    peak = torch.cuda.max_memory_allocated(device) if dev_type == "cuda" \
        else 0
    gathered = [None] * world
    dist.all_gather_object(gathered, {"peak": peak, "summary": summary})
    keys = trainer._graphs.info()
    dropout = [trainer._step_model.enc_dropout,
               trainer._step_model.dec_dropout]
    trainer._graphs.clear()
    del state, trainer
    dist.barrier()
    dist.destroy_process_group()
    if not lead:
        return
    readings = judge(cfg, traffic, seed, device, pool, losses, mu1, after3,
                     world, control)
    correct, checks = verdict(readings, limits)
    ctx = {"kind": "train", "config": cfg, "traffic": traffic,
           "steps": steps, "window_s": window_s, "world": world,
           "reduces_per_step": reduces / max(steps, 1),
           "peak_rank0": peak, "keys": keys, "dropout": dropout,
           "summaries": [g["summary"] for g in gathered if g["summary"]]}
    queue.put({"correct": correct, "attempted": steps * traffic["batch"],
               "failed": 0,
               "e2e": {"examples_per_s": steps * traffic["batch"] / window_s,
                       "setup_s": setup_s},
               "ctx": ctx, "summaries": ctx["summaries"],
               "memory_peak_bytes": max(g["peak"] for g in gathered),
               "checks": checks, "readings": readings})


def judge(cfg, traffic, seed, device, pool, losses, mu1, after3, world,
          control=False):
    """The reference's readings of the first three steps: each step's loss
    against the reference's (``loss``: the largest relative gap), the
    first gradient as Adam's first moments hold it after step 1
    (``grad``) and the parameters' change after step 3 (``change``),
    each by the worst leaf (reference/train.py ``leaf_gaps``). With
    ``control``: the same readings of the reference in fp8, and of the
    faults planted in the reference (half of the batch; one rank's rows
    without the exchange)."""
    from perfbench.core import captioning

    captioning.reference_precision()
    feats = trunk_cache(traffic, seed, device)
    steps = [{"captions": torch.as_tensor(b["captions"], device=device),
              "rows": torch.as_tensor(b["image_rows"], device=device)}
             for b in pool[:3]]
    lr, clip = traffic["learning_rate"], traffic["clip_norm"]
    model = spec.model(cfg)

    def follow(precision="f32", rows=None):
        params = make_params(cfg, seed, device)
        init = {k: v.clone() for k, v in ref.flat(params).items()}
        loss, first = model.train_steps(params, feats, steps, cfg, lr, clip,
                                        precision, rows)
        change = {k: v - init[k] for k, v in ref.flat(params).items()
                  if k in first}
        return loss, first, change

    r_loss, r_first, r_change = follow()
    still = ref.still_leaves(r_first)
    init = ref.flat(make_params(cfg, seed, device))

    def readings(loss, first, change):
        return {"loss": max(abs(a - b) / abs(b) for a, b in
                            zip(loss, r_loss)),
                "grad": ref.leaf_gaps(first, r_first)[0],
                "change": ref.leaf_gaps(change, r_change, still)[0]}

    p_first = {k: v.to(device) / (1 - ref.B1) for k, v in mu1.items()}
    p_change = {k: after3[k].to(device) - init[k] for k in r_change}
    out = readings(losses, p_first, p_change)
    out.update(worst_grad_leaf=ref.leaf_gaps(p_first, r_first)[1],
               worst_change_leaf=ref.leaf_gaps(p_change, r_change, still)[1],
               still=sorted(still), losses=losses, ref_losses=r_loss)
    if control:
        n = traffic["batch"]
        for name, kw in (("control", {"precision": "fp8"}),
                         ("fault_half", {"rows": slice(0, n // 2)}),
                         ("fault_exchange", {"rows": slice(0, n // world)})):
            for k, v in readings(*follow(**kw)).items():
                out[f"{name}_{k}"] = v
    return out


def verdict(readings, limits):
    """(correct, the numbers compared beside their limits): the first
    gradient and the change after three steps, each by its worst leaf.
    The losses' gap is read, not compared: no fault and not the control
    reads ten (three) times the program's there (PERF.md)."""
    checks = {k: [readings[k], limits[k]] for k in ("grad", "change")}
    return all(v <= lim for v, lim in checks.values()), checks
