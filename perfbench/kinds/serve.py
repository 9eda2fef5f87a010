"""Open-loop serving: one caption a request through ``DynamicBatcher``
over a ``MemeGenerationPipeline``, requests sent on a schedule whatever
the server does.

Set-up makes the weights and ``templates`` seeded 224 x 224 images on
the device, encodes them into the pipeline's store (``add_templates``:
the ResNet-50 trunk and the encoder head), starts the batcher at the
traffic's settings and warms each bucket of its ladder. The schedule
(core/traffic.py): ``rate * seconds`` arrival times by the mix's arrival
process (so every seed sends the same number of requests), each for a
template drawn by its popularity law.
One sender thread submits each request at its time; a request's latency
runs from its scheduled arrival to its answer, so a stall is charged to
every request it delays. The window closes with the schedule; every
answer is then waited for, a minute at most. A request that fails, never
comes, or whose caption fails the gates counts as failed. Once all are
in, a sample drawn from the seed, the longest caption among them, is
judged against the reference, which encodes the sampled templates' images
itself.
"""

import threading
import time

import numpy as np
import torch

from perfbench import faults
from perfbench.core import captioning as cap
from perfbench.core import spec, trace
from perfbench.core import traffic as mix

ANSWER_WAIT_S = 60.0


def synthetic_vocab(n):
    """A vocabulary of ``n`` ids: the six special tokens, then ``wNNNNN``
    tokens whose sorted order is their id order."""
    from deephumor_tpu_torch.data import Vocab

    return Vocab([f"w{i:05d}" for i in range(6, n)])


def schedule(traffic, rate, seconds, seed):
    """(arrival offsets [N] in seconds, template indices [N]): the mix's
    arrival process at ``rate`` and its popularity law."""
    rng = np.random.default_rng(spec.derive_seed(seed, "arrivals"))
    arrivals = mix.arrivals(traffic["arrivals"], rate, seconds, rng)
    return arrivals, mix.picks(traffic["popularity"], traffic["templates"],
                               len(arrivals), rng)


class Server:
    """The pipeline and the batcher of one run, set up and warmed."""

    def __init__(self, cell, seed, device, spans, phases=None):
        from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
        from deephumor_tpu_torch.serving import DynamicBatcher

        cfg, traffic = cell.config, cell.traffic
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        phases = phases or (lambda name: None)
        phases("start")
        self.model = cap.make_model(cfg)
        self.params = cap.make_params(cfg, seed, device, encoder=True)
        self.vocab = synthetic_vocab(cfg["num_tokens"])
        gen = torch.Generator(device).manual_seed(
            spec.derive_seed(seed, "images"))
        side = traffic["image_side"]
        self.images = torch.randn(traffic["templates"], side, side, 3,
                                  generator=gen, device=device)
        self.ids = [f"t{i:03d}" for i in range(traffic["templates"])]
        self.pipe = MemeGenerationPipeline(self.model, self.params,
                                           self.vocab)
        phases("weights and images")
        with spans("add_templates"):
            self.pipe.add_templates(self.ids, self.images)
        phases("add_templates")
        b = traffic["batcher"]
        self.batcher = DynamicBatcher(
            self.pipe, max_batch=b["max_batch"],
            max_wait_ms=b["max_wait_ms"], buckets=b["buckets"],
            seed=spec.derive_seed(seed, "batcher"),
            **cap.generate_kwargs(cfg))
        with spans("warmup"):
            for _ in range(2):
                self.batcher.warmup()
        phases("warm buckets")

    def window(self, rate, seconds, spans):
        """Sends the schedule at ``rate`` for ``seconds``; returns the
        requests' scheduled and answer times, their answers (a text, or
        None while none came or for a failed request), the backlog at
        the close and the sender's largest lateness. A request's future
        is dropped once it has answered: the harness keeps its time and
        its text only."""
        arrivals, picks = schedule(self.traffic, rate, seconds, self.seed)
        n = len(arrivals)
        done = np.full(n, np.nan)
        texts = [None] * n
        left = threading.Semaphore(0)
        submit = self.batcher.submit
        late = 0.0
        before = len(self.batcher.batch_sizes)

        def answered(f, i):
            done[i] = time.perf_counter()
            if f.exception() is None:
                texts[i] = f.result()
            left.release()

        with spans("window"):
            w0 = time.perf_counter()
            due = w0 + arrivals
            for i in range(n):
                wait = due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                else:
                    late = max(late, -wait)
                with spans("submit"):
                    f = submit(self.ids[picks[i]])
                f.add_done_callback(lambda f, i=i: answered(f, i))
            wait = w0 + seconds - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            window_s = time.perf_counter() - w0
        backlog = int(np.isnan(done).sum())
        return {"due": due, "done": done, "texts": texts, "left": left,
                "n": n, "picks": picks, "late_s": late,
                "window_s": window_s, "backlog": backlog,
                "batches": self.batcher.batch_sizes[before:],
                "pads": self.batcher.pad_sizes[before:]}

    def close(self):
        self.batcher.close()
        self.pipe.close()


def collect(sent):
    """Waits for every answer (``ANSWER_WAIT_S`` at most past the close);
    returns the texts (None where a request failed or never came)."""
    end = time.perf_counter() + ANSWER_WAIT_S
    for _ in range(sent["n"]):
        if not sent["left"].acquire(
                timeout=max(0.0, end - time.perf_counter())):
            break
    return list(sent["texts"])


def text_ids(text, vocab, max_len):
    """The served ids of a caption text, EOS and pads after them, or None
    for a text that the vocabulary cannot have produced."""
    toks = text.split(" ") if text else []
    if any(t not in vocab.stoi for t in toks) or len(toks) > max_len:
        return None
    ids = [vocab.stoi[t] for t in toks]
    if len(ids) < max_len:
        ids += [cap.EOS] + [cap.PAD] * (max_len - len(ids) - 1)
    return ids


def run(cell, seed, seconds, traced, t0, device, limits, control=False,
        fault=None):
    with faults.planted(fault):
        return _run(cell, seed, seconds, traced, t0, device, limits,
                    control)


def _run(cell, seed, seconds, traced, t0, device, limits, control):
    cfg, traffic = cell.config, cell.traffic
    spans = trace.Spans(traced)
    phases = trace.Phases(t0)
    server = Server(cell, seed, device, spans, phases)
    spec.settle()
    phases.report()
    prof = trace.profiler() if traced else None
    if prof is not None:
        prof.start()
    setup_s = time.perf_counter() - t0
    try:
        sent = server.window(traffic["rate"], seconds, spans)
        summary = None
        if prof is not None:
            prof.stop()
            summary = trace.reduce_trace(
                prof, spec.CACHE_DIR / f"trace-{cell.name}.json",
                (device.index or 0) if device.type == "cuda" else None)
        texts = collect(sent)
        gave_up = time.perf_counter()
    finally:
        server.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    max_len = cfg["generation"]["max_len"]
    served = [None if t is None else text_ids(t, server.vocab, max_len)
              for t in texts]
    failed = sum(s is None for s in served)
    # a request that never came counts the wait until the collection gave
    # up: it sorts past every answer in time
    lat = (np.where(np.isnan(sent["done"]), gave_up, sent["done"])
           - sent["due"]) * 1e3
    attempted = len(served)
    from deephumor_tpu_torch.models import graphs
    graphs.clear()
    readings = judge(cfg, traffic, server, sent, served, seed, control)
    readings["failed"] = failed
    correct, checks = cap.verdict(readings, limits, failed)
    ctx = {"kind": "serve", "config": cfg, "traffic": traffic,
           "batches": sent["batches"], "pads": sent["pads"],
           "window_s": sent["window_s"], "trace": summary}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "e2e": {"latency_p50_ms": float(np.percentile(lat, 50)),
                    "latency_p95_ms": float(np.percentile(lat, 95)),
                    "setup_s": setup_s},
            "ctx": ctx, "summaries": [summary] if summary else [],
            "memory_peak_bytes": peak,
            "checks": checks,
            "readings": readings}


def judge(cfg, traffic, server, sent, served, seed, control=False):
    """The reference's readings of a sample of the served captions; the
    reference encodes the sampled templates' images itself."""
    good = [i for i, s in enumerate(served) if s is not None]
    if not good:
        return {"gap": float("inf"), "outside_share": 100.0, "tail": 0,
                "tokens": 0}
    dev = server.images.device
    tokens = torch.tensor([served[i] for i in good], device=dev)
    lengths = cap.ref.served_lengths(tokens, cap.EOS)
    rows = cap.sample_rows(len(good), traffic["check_items"], seed,
                           int(lengths.argmax()))
    rows_t = torch.as_tensor(rows, device=dev)
    templates = torch.as_tensor(sent["picks"][[good[r] for r in rows]],
                                device=dev)
    cap.reference_precision()
    enc = server.params["encoder"]
    model = spec.model(cfg)
    with torch.no_grad():
        parts = [model.encode(enc, server.images[templates[i:i + 32]])
                 for i in range(0, len(rows), 32)]
    prompts = tuple(torch.cat(p) for p in zip(*parts))
    return cap.check(cfg, server.params["decoder"], prompts, tokens[rows_t],
                     seed, control=control)
