"""End-to-end meme generation (the serving product path).

Counterpart of deephumor_tpu/pipeline.py:

- template images are encoded once into a store on the model's device:
  one stacked tensor per ``encode`` output (the global embedding and, for
  the cross-attention model, the spatial one), a row per template, so a
  request batch is one gather;
- captions are generated for a batch of template ids by the model's
  ``generate_from_emb`` (on the card: the hand-written decode kernels),
  and the batch's chosen ids move to the host once;
- text decoding and the PIL renderer run on the host, in a thread pool or
  in a spawn process pool.

Sampling takes an explicit ``torch.Generator`` on the model's device
where the JAX package takes a PRNG key; ``derive_seed`` stands in for its
``fold_in``.

With a pure data-parallel ``mesh`` (``parallel.make_mesh(model=1)``; one
process per card) generation scales over the cards: the parameters are
replicated, each rank keeps its block of the store's rows (padded to a
multiple of the data size), a request's rows are summed over the ranks
from their owners, and ``parallel.dp_generate`` decodes each rank's block
of the request. Every rank builds the pipeline and adds the same
templates in the same order. Rank 0 leads: its ``generate_captions`` (and
so a ``DynamicBatcher`` over it) first broadcasts the call's arguments;
every other rank runs :meth:`MemeGenerationPipeline.follow`, which joins
each call until rank 0 closes the pipeline.
"""

import os
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from deephumor_tpu_torch.experiments.inference import (seq_to_text,
                                                       split_caption)
from deephumor_tpu_torch.utils import profiling

__all__ = ["MemeGenerationPipeline", "derive_seed"]

_MASK64 = (1 << 64) - 1


def derive_seed(seed, n):
    """A generator seed derived from a base ``seed`` and a counter ``n``
    (a chunk's start, a batch's sequence number): splitmix64 of the pair,
    so nearby pairs give unrelated seeds."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(n) + 1) * 0xBF58476D1CE4E5B9)
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


# -- process-pool render workers ---------------------------------------------
# FreeType rasterisation runs under the GIL, so threads overlap rendering
# with device work but cannot spread it over host cores; processes can.
# Workers get the template images once, as raw bytes through the spawn
# initializer (spawn, not fork: the parent holds a CUDA context).
_WORKER_IMAGES = {}
_WORKER_FONT = None


def _render_proc_init(images_raw, font_path):
    from PIL import Image

    global _WORKER_FONT
    _WORKER_IMAGES.clear()
    for tid, (mode, size, raw) in images_raw.items():
        _WORKER_IMAGES[tid] = Image.frombytes(mode, size, raw)
    _WORKER_FONT = font_path


def _render_proc_warm(delay_s):
    """Warm task: its answer shows that this worker's initializer ran. The
    sleep keeps one fast worker from taking the whole warm batch."""
    import time

    time.sleep(delay_s)
    return os.getpid()


def _render_proc_one(tid, text):
    from deephumor_tpu_torch.imaging import memeify_image

    top, bottom = split_caption(text, num_blocks=2)
    img = _WORKER_IMAGES.get(tid)
    if img is None:
        return tid, text, None
    out = memeify_image(img, top=top, bottom=bottom, font_path=_WORKER_FONT)
    return tid, text, (out.mode, out.size, out.tobytes())


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else tree
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


class MemeGenerationPipeline:
    """Batched template -> captioned meme pipeline.

    Args:
        model: a captioner of ``deephumor_tpu_torch.models``.
        params: its parameter tree; the pipeline runs on their device.
        vocab: the ``Vocab`` that decodes token ids.
        delimiter: joins decoded tokens (" " for word models, "" for
            char models).
        font_path: the renderer's font (default: ``default_font_path``).
        render_workers: host threads for PIL rendering.
        render_processes: when > 0, render in a persistent spawn process
            pool of this size instead of threads; the workers take a
            snapshot of the template images when the pool is made (it is
            made again when the templates change). ``close()`` shuts it.
        mesh: a pure data-parallel ``DeviceMesh`` to generate over (module
            docstring); the parameters are replicated from rank 0.
    """

    def __init__(self, model, params, vocab, delimiter=" ", font_path=None,
                 render_workers=8, render_processes=0, mesh=None):
        self.model = model
        self.mesh = mesh
        self._data_size = 1
        if mesh is not None:
            from deephumor_tpu_torch.parallel.mesh import data_size, replicate

            shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
            if shape.get("model", 1) != 1:
                raise ValueError(
                    "pipeline mesh must be pure data-parallel (model=1); "
                    "got %r" % shape)
            self._data_size = data_size(mesh)
            params = replicate(params, mesh)
            self._released = False
            # one leader call at a time: each is a sequence of collectives
            self._call_lock = threading.Lock()
        self.params = params
        self.vocab = vocab
        self.delimiter = delimiter
        self.font_path = font_path
        self.render_workers = render_workers
        self.render_processes = render_processes
        self.device = _first_tensor(params).device
        self._proc_pool = None
        self._proc_pool_version = -1
        self._images_version = 0
        self._images = {}  # template id -> PIL image (for rendering)
        # the stacked store: a tuple of device tensors (one per encode
        # output) with a row per template. New encodings wait in
        # ``_pending`` and are concatenated at the next gather (one
        # concatenation per generate call, not one per add_template)
        self._stacked = None
        self._pending = []
        self._pair = None  # whether encode returns a (global, spatial) pair
        self._row = {}  # template id -> row in the stacked store
        self._n_rows = 0
        self._n_stored = 0  # rows in ``_stacked`` (with a mesh: in all blocks)
        # batchers call generate_captions from their own threads
        self._lock = threading.Lock()

    # -- template store ------------------------------------------------------
    def _to_device(self, x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return torch.as_tensor(np.asarray(x)).to(self.device, dtype)

    def _encode(self, images, label_ids):
        images = self._to_device(images, torch.float32)
        if label_ids is None:
            return self.model.encode(self.params, images)
        return self.model.encode(self.params, images,
                                 self._to_device(label_ids, torch.long))

    def add_template(self, template_id, image, pil_image=None,
                     label_ids=None):
        """Encodes and stores one template.

        Args:
            template_id: a hashable id (e.g. the template's label).
            image: the preprocessed ``[224, 224, 3]`` float image (numpy
                array or tensor).
            pil_image: the original PIL image, for rendering.
            label_ids: the template label's token ids ``[L]``, which the
                labels-conditioned model's encoder takes.
        """
        enc = self._encode(
            self._to_device(image, torch.float32)[None],
            None if label_ids is None
            else self._to_device(label_ids, torch.long)[None])
        self._append_stacked([template_id], enc)
        if pil_image is not None:
            # load now: render threads share the image, and PIL's lazy
            # file-backed load is not thread-safe
            if hasattr(pil_image, "load"):
                pil_image.load()
            self._images[template_id] = pil_image
            self._images_version += 1

    def add_templates(self, ids, images, pil_images=None, batch_size=32,
                      label_ids=None):
        """Encodes templates ``batch_size`` at a time (one ResNet pass per
        batch). ``images``: ``[n, 224, 224, 3]`` float, a numpy array or a
        tensor (e.g. ``preprocess_batch`` output on the card);
        ``label_ids``: an optional ``[n, L]`` padded label-token matrix
        for the labels-conditioned model."""
        ids = list(ids)
        for start in range(0, len(ids), batch_size):
            chunk = ids[start:start + batch_size]
            sl = slice(start, start + len(chunk))
            enc = self._encode(images[sl],
                               None if label_ids is None else label_ids[sl])
            self._append_stacked(chunk, enc)
            if pil_images is not None:
                for j, tid in enumerate(chunk):
                    img = pil_images[start + j]
                    if hasattr(img, "load"):
                        img.load()  # see add_template
                    self._images[tid] = img
                self._images_version += 1

    def _append_stacked(self, ids, enc):
        pair = isinstance(enc, tuple)
        with self._lock:
            self._pair = pair
            for j, tid in enumerate(ids):
                # a re-added id points at its fresh rows (the stale rows
                # stay, unreferenced); rows count every appended row, so
                # later templates never collide with a refreshed one
                self._row[tid] = self._n_rows + j
            self._n_rows += len(ids)
            self._pending.append(enc if pair else (enc,))

    def _consolidate(self):
        """Joins the pending encodings to the store (under ``_lock``). With
        a mesh every rank does so in the same call, and keeps its block of
        the rows, padded to a multiple of the data size; the earlier
        blocks are gathered first, as the block bounds move."""
        if not self._pending:
            return
        parts = self._pending
        if self._stacked is not None:
            parts = [self._full_store()] + parts
        full = tuple(torch.cat(xs, dim=0) for xs in zip(*parts))
        self._pending = []
        self._n_stored = full[0].shape[0]
        if self.mesh is None:
            self._stacked = full
            return
        from deephumor_tpu_torch.parallel.mesh import data_index

        n, i = self._data_size, data_index(self.mesh)
        block = -(-self._n_stored // n)
        self._stacked = tuple(
            torch.cat([x, x.new_zeros((block * n - x.shape[0],)
                                      + x.shape[1:])])[
                i * block:(i + 1) * block].clone() for x in full)

    def _full_store(self):
        """Every stored row, in order: the store itself, or with a mesh its
        blocks all-gathered over the data axis."""
        if self.mesh is None:
            return self._stacked
        from deephumor_tpu_torch.parallel.mesh import all_gather_rows

        group = self.mesh.get_group("data")
        return tuple(all_gather_rows(x, group)[:self._n_stored]
                     for x in self._stacked)

    def _stack_features(self, ids):
        """The stored encodings of ``ids``: one gather per store tensor.
        Raises KeyError for an id that was never added. With a mesh, each
        rank fills the rows that its block holds, zeros elsewhere, and the
        rows are summed over the data axis: every rank gets all of them,
        equal to the single-device gather."""
        with profiling.span("pipeline.gather"):
            return self._gather(ids)

    def _gather(self, ids):
        with self._lock:
            rows = [self._row[tid] for tid in ids]
            self._consolidate()
            store = self._stacked
        idx = torch.tensor(rows, dtype=torch.long).to(self.device)
        if self.mesh is None:
            feats = tuple(x.index_select(0, idx) for x in store)
        else:
            from deephumor_tpu_torch.parallel.mesh import data_index

            block = store[0].shape[0]
            local = idx - data_index(self.mesh) * block
            mine = (local >= 0) & (local < block)
            feats = []
            for x in store:
                f = torch.where(
                    mine.view((-1,) + (1,) * (x.ndim - 1)),
                    x.index_select(0, local.clamp(0, block - 1)), 0.0)
                dist.all_reduce(f, group=self.mesh.get_group("data"))
                feats.append(f)
            feats = tuple(feats)
        return feats if self._pair else feats[0]

    # -- generation ----------------------------------------------------------
    def generate_captions(self, template_ids, generator=None, pad_to=None,
                          **generate_kwargs):
        """One caption text per entry of ``template_ids`` (repeat an id
        for several captions of one template).

        ``generator``: a ``torch.Generator`` on the model's device
        (default: seeded with 0). ``pad_to`` pads the request to this
        batch size by repeating its last id (the results are cut back),
        so a server's calls keep a few fixed sizes. With a mesh, a request
        is padded to a multiple of the data size (``pad_to`` must be one),
        and only rank 0 calls this (module docstring).
        """
        n = len(template_ids)
        ids = list(template_ids)
        ds = self._data_size
        if pad_to is not None:
            if pad_to % ds:
                raise ValueError(
                    f"pad_to={pad_to} must be a multiple of the mesh "
                    f"data-axis size {ds}")
            if n < pad_to:
                ids += [ids[-1]] * (pad_to - n)
        elif len(ids) % ds:
            # dp_generate splits the batch evenly over the data axis
            ids += [ids[-1]] * (-len(ids) % ds)
        if self.mesh is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            return self._generate(ids, n, generator, generate_kwargs)
        if dist.get_rank() != 0:
            raise RuntimeError("on a mesh only rank 0 calls "
                               "generate_captions; the others run follow()")
        unknown = [tid for tid in ids if tid not in self._row]
        if unknown:
            raise KeyError(f"unknown templates {unknown!r}")
        seed = 0 if generator is None else int(torch.randint(
            0, 2 ** 62, (), generator=generator, device=generator.device))
        with self._call_lock:
            if self._released:
                raise RuntimeError("the mesh pipeline is closed")
            self._broadcast((ids, n, seed, generate_kwargs))
            return self._generate(ids, n, seed, generate_kwargs)

    def _generate(self, ids, n, generator, generate_kwargs):
        """Texts of the first ``n`` of the (padded) request ``ids``; with a
        mesh ``generator`` is the seed every rank was given."""
        enc = self._stack_features(ids)
        if self.mesh is None:
            result = self.model.generate_from_emb(
                self.params, enc, generator=generator, **generate_kwargs)
        else:
            from deephumor_tpu_torch.parallel.mesh import dp_generate

            result = dp_generate(
                self.model, self.params, enc, self.mesh,
                generator=torch.Generator(self.device).manual_seed(
                    generator), **generate_kwargs)
        with profiling.span("pipeline.fetch"):
            seqs = result["chosen"][:n].cpu().numpy()  # one copy to the host
        with profiling.span("pipeline.decode"):
            return [seq_to_text(seq, self.vocab, delimiter=self.delimiter)
                    for seq in seqs]

    def _broadcast(self, obj):
        """``obj`` of rank 0 on every rank of the mesh."""
        box = [obj]
        dist.broadcast_object_list(
            box, src=0, group=self.mesh.get_group("data"),
            device=self.device if self.device.type == "cuda" else None)
        return box[0]

    def follow(self):
        """The loop of every rank but 0 of a mesh pipeline: joins each
        generate call that rank 0 makes (its arguments come by broadcast),
        and returns once rank 0 closes the pipeline."""
        if self.mesh is None or dist.get_rank() == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a mesh pipeline")
        while True:
            call = self._broadcast(None)
            if call is None:
                return
            self._generate(*call)

    def _render_pool(self):
        """The persistent process pool, made again when the template
        images change (workers take a snapshot of them)."""
        if self._proc_pool_version != self._images_version:
            if self._proc_pool is not None:
                self._proc_pool.shutdown(wait=False)
            import multiprocessing

            snapshot = {tid: (img.mode, img.size, img.tobytes())
                        for tid, img in self._images.items()}
            self._proc_pool = ProcessPoolExecutor(
                self.render_processes,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_render_proc_init,
                initargs=(snapshot, self.font_path))
            self._proc_pool_version = self._images_version
        return self._proc_pool

    def warm_render_pool(self):
        """Starts the render processes (no-op for threads) and returns once
        every worker has run its initializer, so that the first request
        does not pay for the spawn and the image snapshot."""
        if not self.render_processes or not self._images:
            return
        pool = self._render_pool()
        seen = set()
        for _ in range(64):  # normally 1-3 rounds
            futs = [pool.submit(_render_proc_warm, 0.01)
                    for _ in range(self.render_processes - len(seen))]
            seen.update(f.result() for f in futs)
            if len(seen) >= self.render_processes:
                return

    def close(self):
        """Shuts the render process pool down (no-op for threads). On rank
        0 of a mesh, also ends the other ranks' :meth:`follow`."""
        if self.mesh is not None and dist.get_rank() == 0:
            with self._call_lock:
                if not self._released:
                    self._released = True
                    self._broadcast(None)
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=True)
            self._proc_pool = None
            self._proc_pool_version = -1

    @staticmethod
    def _from_raw(rendered):
        tid, text, raw = rendered
        if raw is None:
            return tid, text, None
        from PIL import Image

        mode, size, data = raw
        return tid, text, Image.frombytes(mode, size, data)

    def _render_one(self, tid, text):
        from deephumor_tpu_torch.imaging import memeify_image

        top, bottom = split_caption(text, num_blocks=2)
        img = self._images.get(tid)
        if img is None:
            return tid, text, None
        return tid, text, memeify_image(img, top=top, bottom=bottom,
                                        font_path=self.font_path)

    def _submit_renders(self, pool, ids, texts):
        fn = _render_proc_one if self.render_processes else self._render_one
        return [pool.submit(fn, tid, text) for tid, text in zip(ids, texts)]

    def _results(self, futs):
        if self.render_processes:
            return [self._from_raw(f.result()) for f in futs]
        return [f.result() for f in futs]

    def generate_memes(self, template_ids, generator=None,
                       **generate_kwargs):
        """Captions, then rendering on the host pool. Returns a list of
        ``(template_id, caption_text, PIL image | None)``."""
        texts = self.generate_captions(template_ids, generator,
                                       **generate_kwargs)
        if self.render_processes:
            return self._results(self._submit_renders(
                self._render_pool(), template_ids, texts))
        with ThreadPoolExecutor(self.render_workers) as pool:
            return self._results(self._submit_renders(
                pool, template_ids, texts))

    def generate_memes_batched(self, template_ids, batch_size=256, seed=0,
                               **generate_kwargs):
        """Large sweeps in chunks of ``batch_size`` (each padded to it):
        the device generates chunk N+1 while the host pool renders chunk
        N. Chunk ``start`` samples with a generator seeded by
        ``derive_seed(seed, start)``. Returns ``(template_id,
        caption_text, PIL image | None)`` in input order."""
        ids = list(template_ids)

        def run(pool):
            futs = []
            for start in range(0, len(ids), batch_size):
                chunk = ids[start:start + batch_size]
                gen = torch.Generator(self.device).manual_seed(
                    derive_seed(seed, start))
                texts = self.generate_captions(chunk, gen, pad_to=batch_size,
                                               **generate_kwargs)
                futs.extend(self._submit_renders(pool, chunk, texts))
            return self._results(futs)

        if self.render_processes:
            return run(self._render_pool())
        with ThreadPoolExecutor(self.render_workers) as pool:
            return run(pool)
