"""Dynamic request batching for meme-caption serving.

Counterpart of deephumor_tpu/serving.py. The decode path reaches its
throughput at large batches, while a request costs one dispatch whatever
its size, and an endpoint receives requests one at a time. So:

- ``submit(template_id)`` returns a ``concurrent.futures.Future`` at
  once; ``submit_many`` hands a client batch over in one queue operation;
- a collector thread drains the queue into batches of up to
  ``max_batch`` requests, waiting at most ``max_wait_ms`` after the first
  pending request before it dispatches a partial batch;
- every device call is padded to a size from a short ``buckets`` ladder
  (the pipeline's ``pad_to``): by default just ``[max_batch]``;
  ``buckets="auto"`` adds halving sizes down to 16, so that a lightly
  loaded server pays for the batch it has, with an EWMA of recent batch
  sizes damping the choice (``hysteresis``);
- with ``render=True`` a batch renders through the pipeline's host pool
  and futures resolve to ``(caption_text, PIL image)``, else to the text.

Sampling is seeded per batch: the batch with sequence number ``n`` runs
on a generator seeded with ``derive_seed(seed, n)``, so results are
deterministic per seed and arrival order (and bucket). A batch whose call
raises fails its own futures; the collector keeps serving.

Example::

    pipe = MemeGenerationPipeline(model, params, vocab)
    pipe.add_templates(ids, images)
    with DynamicBatcher(pipe, max_batch=256, max_wait_ms=5, max_len=32,
                        beam_size=5, top_k=64) as server:
        texts = [f.result() for f in map(server.submit, requests)]
"""

import itertools
import queue
import threading
import time
from concurrent.futures import Future

import torch

from deephumor_tpu_torch.pipeline import derive_seed
from deephumor_tpu_torch.utils import profiling

__all__ = ["DynamicBatcher", "bucket_ladder"]

_BUCKET_FLOOR = 16


def bucket_ladder(max_batch, buckets, data_size=1):
    """The padded call sizes for ``buckets``: None -> ``(max_batch,)``;
    ``"auto"`` -> halving sizes from ``max_batch`` down to 16 (256 -> 16,
    32, 64, 128, 256); a sequence of ints -> those sizes with
    ``max_batch`` added. A mesh pipeline splits every call over its data
    axis, so with ``data_size`` > 1 every size must be a multiple of it:
    ``max_batch`` and given buckets are checked, and the "auto" ladder
    stops at ``max(16, data_size)`` with each step rounded down to a
    multiple."""
    if max_batch % data_size:
        raise ValueError(
            f"max_batch={max_batch} must be a multiple of the pipeline "
            f"mesh's data-axis size {data_size}")
    if buckets is None:
        return (max_batch,)
    if buckets == "auto":
        floor = max(_BUCKET_FLOOR, data_size)
        ladder, b = {max_batch}, max_batch
        while b > floor:
            b = max(floor, b // 2)
            b -= b % data_size  # keep ladder steps shardable
            ladder.add(b)
        return tuple(sorted(ladder))
    if isinstance(buckets, str):  # "128" would iterate per character
        raise ValueError(f"buckets={buckets!r}: expected None, 'auto', or a "
                         "sequence of ints")
    ladder = {int(b) for b in buckets}
    if not ladder or min(ladder) < 1:
        raise ValueError(f"invalid buckets: {buckets!r}")
    if max(ladder) > max_batch:
        raise ValueError(f"bucket {max(ladder)} exceeds max_batch "
                         f"{max_batch}")
    bad = sorted(b for b in ladder if b % data_size)
    if bad:
        raise ValueError(
            f"buckets {bad} not multiples of the pipeline mesh's "
            f"data-axis size {data_size}")
    ladder.add(max_batch)  # a full batch must fit
    return tuple(sorted(ladder))


class DynamicBatcher:
    """Coalesces concurrent caption/meme requests into padded device
    batches (a few fixed sizes, bounded added latency)."""

    def __init__(self, pipeline, max_batch=256, max_wait_ms=10.0,
                 render=False, seed=0, buckets=None, hysteresis=3,
                 **generate_kwargs):
        """Args:
            pipeline: a ready ``MemeGenerationPipeline`` (templates added;
                with a mesh, on rank 0, while the other ranks follow).
            max_batch: the largest device batch.
            max_wait_ms: how long the collector holds the first request of
                a batch while more arrive.
            buckets: padded call sizes (see :func:`bucket_ladder`); a
                dispatch pads to the smallest bucket that fits. Sampled
                draws depend on the batch they land in, so a caption
                depends on its bucket; results stay deterministic per
                (seed, arrival order).
            hysteresis: damping of the bucket choice (ladders of more
                than one size): a dispatch pads to the bucket that fits
                the EWMA of recent batch sizes (over ~``hysteresis``
                dispatches), never below its own fit; 0 picks the raw
                fit.
            render: futures resolve to ``(text, PIL image)`` through the
                pipeline's render pool.
            seed: the base seed of the per-batch generators.
            generate_kwargs: passed to the pipeline's generate call
                (max_len, beam_size, top_k, temperature, sampler, ...).
        """
        self.pipeline = pipeline
        self.max_batch = int(max_batch)
        self.buckets = bucket_ladder(self.max_batch, buckets,
                                     getattr(pipeline, "_data_size", 1))
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.render = render
        self.generate_kwargs = generate_kwargs
        # bucket damping state (collector thread only)
        self.hysteresis = int(hysteresis) if len(self.buckets) > 1 else 0
        self._n_ewma = None
        self.seed = int(seed)
        self._queue = queue.SimpleQueue()
        self._spill = []  # submit_many overflow (collector thread only)
        self._seq = itertools.count()
        self._closed = threading.Event()
        self.batches_dispatched = 0
        self.requests_served = 0
        #: per-dispatch batch sizes (appended by the collector thread only)
        self.batch_sizes = []
        #: per-dispatch padded bucket sizes (indexed as ``batch_sizes``)
        self.pad_sizes = []
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dh-batcher")
        self._worker.start()

    # -- client API ----------------------------------------------------------
    def _known(self, template_id):
        return template_id in self.pipeline._row and (
            not self.render or template_id in self.pipeline._images)

    def submit(self, template_id):
        """Enqueues one request; returns a Future of the caption text (or
        ``(text, image)`` when rendering). An unknown template id fails
        its own future here, not the batch it would join."""
        if self._closed.is_set():
            raise RuntimeError("DynamicBatcher is closed")
        fut = Future()
        if not self._known(template_id):
            fut.set_exception(KeyError(f"unknown template {template_id!r}"))
            return fut
        self._queue.put((template_id, fut, profiling.stamp()))
        return fut

    def submit_many(self, template_ids):
        """Enqueues a client batch in one queue operation; returns one
        Future per id (same order and meaning as :meth:`submit`). The
        collector still splits or joins it against ``max_batch``."""
        if self._closed.is_set():
            raise RuntimeError("DynamicBatcher is closed")
        futs, good, t0 = [], [], profiling.stamp()
        for tid in template_ids:
            fut = Future()
            futs.append(fut)
            if self._known(tid):
                good.append((tid, fut, t0))
            else:
                fut.set_exception(KeyError(f"unknown template {tid!r}"))
        if good:
            self._queue.put(good)
        return futs

    def _bucket_for(self, n):
        """The smallest bucket that fits ``n`` requests."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch  # unreachable: the collector caps at it

    def _choose_bucket(self, n):
        """The damped bucket of an ``n``-request dispatch (collector thread
        only): the bucket that fits the EWMA of recent batch sizes, never
        below this batch's own fit."""
        fit = self._bucket_for(n)
        if not self.hysteresis:
            return fit
        alpha = 1.0 / self.hysteresis
        self._n_ewma = (float(n) if self._n_ewma is None
                        else (1 - alpha) * self._n_ewma + alpha * n)
        return max(fit, self._bucket_for(int(round(self._n_ewma))))

    def _generator(self, n):
        return torch.Generator(self.pipeline.device).manual_seed(
            derive_seed(self.seed, n))

    def warmup(self, template_id=None):
        """One call at each bucket size (smallest first), with
        ``template_id`` or any stored template: builds the kernels and
        warms the libraries before the first request."""
        if template_id is None:
            if not self.pipeline._row:
                raise RuntimeError("warmup() needs at least one registered "
                                   "template (pipeline.add_templates)")
            template_id = next(iter(self.pipeline._row))
        for b in self.buckets:
            self.pipeline.generate_captions(
                [template_id], self._generator(0), pad_to=b,
                **self.generate_kwargs)

    def close(self, timeout=30.0):
        """Stops the collector after it has drained the pending
        requests."""
        if not self._closed.is_set():
            self._closed.set()
            self._queue.put(None)  # wakes the collector
            self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- collector -----------------------------------------------------------
    def _take(self, batch, item):
        """Adds one queue item (a (tid, fut, stamp) triple or a submit_many
        list of them) to ``batch``, spilling what passes max_batch to the
        next dispatch."""
        if isinstance(item, list):
            room = self.max_batch - len(batch)
            batch.extend(item[:room])
            self._spill.extend(item[room:])
        else:
            batch.append(item)

    def _collect(self):
        """Blocks for the first request, then gathers up to max_batch for
        at most max_wait_s. Returns a (possibly empty) list."""
        batch = []
        if self._spill:  # leftovers of an oversized submit_many
            batch = self._spill[:self.max_batch]
            del self._spill[:self.max_batch]
            if len(batch) >= self.max_batch:
                return batch
        else:
            item = self._queue.get()  # until work or the wake-up
            if item is not None:
                self._take(batch, item)
        t_end = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            self._take(batch, item)
        return batch

    def _drained(self):
        return (self._closed.is_set() and self._queue.empty()
                and not self._spill)

    def _run(self):
        seq = next(self._seq)
        while True:
            # a batch's collection and dispatch share its sequence number
            with profiling.span("batcher.collect", id=seq):
                batch = self._collect()
            if not batch:
                if self._drained():
                    return
                continue
            with profiling.span("batcher.dispatch", id=seq):
                self._dispatch(batch, seq)
            seq = next(self._seq)
            # close()'s wake-up may have been taken while this batch was
            # collected: check on every path, or a failed last batch would
            # leave _collect blocked (spilled leftovers drain first)
            if self._drained():
                return

    def _dispatch(self, batch, seq):
        """Runs batch ``seq`` and resolves its futures; a failed call fails
        them all. Each request's wait in the queue ends here."""
        ids, futs, stamps = zip(*batch)
        if any(stamps):  # None while no profiler records
            for t0 in stamps:
                profiling.span_since("batcher.queue", t0, id=seq)
        gen = self._generator(seq)
        pad_to = self._choose_bucket(len(ids))
        try:
            if self.render:
                out = self.pipeline.generate_memes(
                    ids, gen, pad_to=pad_to, **self.generate_kwargs)
                results = [(text, img) for _, text, img in out]
            else:
                results = self.pipeline.generate_captions(
                    ids, gen, pad_to=pad_to, **self.generate_kwargs)
        except Exception as e:  # noqa: BLE001 — fail the batch, not the server
            for f in futs:
                f.set_exception(e)
            return
        self.batches_dispatched += 1
        self.requests_served += len(futs)
        self.batch_sizes.append(len(futs))
        self.pad_sizes.append(pad_to)
        with profiling.span("batcher.resolve"):
            for f, r in zip(futs, results):
                f.set_result(r)
