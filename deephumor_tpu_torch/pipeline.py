"""End-to-end meme generation (the serving product path).

Counterpart of deephumor_tpu/pipeline.py, on one device (its ``mesh``
form, which shards the template store over chips, is not ported):

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
"""

import os
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from deephumor_tpu_torch.experiments.inference import (seq_to_text,
                                                       split_caption)

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
    """

    def __init__(self, model, params, vocab, delimiter=" ", font_path=None,
                 render_workers=8, render_processes=0):
        self.model = model
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

    def _stack_features(self, ids):
        """The stored encodings of ``ids``: one gather per store tensor.
        Raises KeyError for an id that was never added."""
        with self._lock:
            rows = [self._row[tid] for tid in ids]
            if self._pending:
                parts = ([self._stacked] if self._stacked is not None
                         else []) + self._pending
                self._stacked = tuple(torch.cat(xs, dim=0)
                                      for xs in zip(*parts))
                self._pending = []
            store = self._stacked
        idx = torch.tensor(rows, dtype=torch.long).to(self.device)
        feats = tuple(x.index_select(0, idx) for x in store)
        return feats if self._pair else feats[0]

    # -- generation ----------------------------------------------------------
    def generate_captions(self, template_ids, generator=None, pad_to=None,
                          **generate_kwargs):
        """One caption text per entry of ``template_ids`` (repeat an id
        for several captions of one template).

        ``generator``: a ``torch.Generator`` on the model's device
        (default: seeded with 0). ``pad_to`` pads the request to this
        batch size by repeating its last id (the results are cut back),
        so a server's calls keep a few fixed sizes.
        """
        n = len(template_ids)
        ids = list(template_ids)
        if pad_to is not None and n < pad_to:
            ids += [ids[-1]] * (pad_to - n)
        enc = self._stack_features(ids)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        result = self.model.generate_from_emb(
            self.params, enc, generator=generator, **generate_kwargs)
        seqs = result["chosen"][:n].cpu().numpy()  # one copy to the host
        return [seq_to_text(seq, self.vocab, delimiter=self.delimiter)
                for seq in seqs]

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
        """Shuts the render process pool down (no-op for threads)."""
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
