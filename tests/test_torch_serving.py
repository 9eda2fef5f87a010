"""deephumor_tpu_torch's DynamicBatcher and HTTP server (CPU, tiny
model), the bucket ladders against the JAX package's, and the kernel
library's build lock."""

import ctypes
import io
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from deephumor_tpu.serving import DynamicBatcher as JaxBatcher
from deephumor_tpu_torch import serve as serve_mod
from deephumor_tpu_torch.data import Vocab
from deephumor_tpu_torch.models import CaptioningTransformerBase
from deephumor_tpu_torch.ops import _build
from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
from deephumor_tpu_torch.serving import DynamicBatcher

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

GEN = dict(max_len=6, beam_size=2, top_k=5)


class FlakyPipeline(MemeGenerationPipeline):
    """Fails every batch that holds the template "boom"."""

    def generate_captions(self, template_ids, *args, **kwargs):
        if "boom" in template_ids:
            raise RuntimeError("decode failed")
        return super().generate_captions(template_ids, *args, **kwargs)


@pytest.fixture(scope="module")
def pipe():
    vocab = Vocab(["when", "you", "ship", "it", "works", "and", "bug"])
    model = CaptioningTransformerBase(num_tokens=len(vocab), hid_dim=16,
                                      n_layers=1, n_heads=4, pf_dim=24,
                                      max_len=16)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    p = FlakyPipeline(model, params, vocab)
    images = np.random.default_rng(0).normal(size=(4, 32, 32, 3))
    pils = [Image.new("RGB", (80, 60), (40, 80, 120)) for _ in range(4)]
    p.add_templates(["a", "b", "c", "boom"], images.astype(np.float32),
                    pil_images=pils)
    return p


def test_concurrent_submits_coalesce(pipe):
    with DynamicBatcher(pipe, max_batch=6, max_wait_ms=60, **GEN) as srv:
        ids = [("a", "b", "c")[i % 3] for i in range(17)]
        futs = [None] * len(ids)

        def submit(lo, hi):
            for i in range(lo, hi):
                futs[i] = srv.submit(ids[i])

        threads = [threading.Thread(target=submit,
                                    args=(i * 3, min(len(ids), i * 3 + 3)))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        texts = [f.result(timeout=120) for f in futs]
    assert all(isinstance(t, str) for t in texts)
    assert srv.requests_served == 17 == sum(srv.batch_sizes)
    assert 3 <= srv.batches_dispatched < 17
    assert all(p == 6 for p in srv.pad_sizes)


@pytest.mark.parametrize("buckets", [None, [2, 8]])
def test_results_are_deterministic_per_seed_and_arrival_order(pipe, buckets):
    def run(seed, many=False):
        with DynamicBatcher(pipe, max_batch=8, max_wait_ms=200, seed=seed,
                            buckets=buckets, **GEN) as srv:
            ids = ["a", "b", "c", "a", "b"]
            futs = srv.submit_many(ids) if many else list(map(srv.submit,
                                                              ids))
            return [f.result(timeout=120) for f in futs]

    first = run(7)
    assert run(7) == first and run(7, many=True) == first
    assert any(run(s) != first for s in (8, 9, 10))


def test_failed_batch_fails_its_futures_and_the_server_survives(pipe):
    with DynamicBatcher(pipe, max_batch=4, max_wait_ms=30, **GEN) as srv:
        unknown = srv.submit("nope")
        with pytest.raises(KeyError):
            unknown.result(timeout=120)
        bad = srv.submit_many(["boom", "a"])
        for f in bad:
            with pytest.raises(RuntimeError, match="decode failed"):
                f.result(timeout=120)
        assert isinstance(srv.submit("a").result(timeout=120), str)
        assert srv.requests_served == 1 and srv.batches_dispatched == 1


def test_close_drains_and_rejects(pipe):
    srv = DynamicBatcher(pipe, max_batch=2, max_wait_ms=5, **GEN)
    futs = srv.submit_many([("a", "b", "c")[i % 3] for i in range(7)])
    one = srv.submit("c")
    srv.close(timeout=120)
    assert all(isinstance(f.result(timeout=5), str) for f in futs + [one])
    assert all(n <= 2 for n in srv.batch_sizes)
    with pytest.raises(RuntimeError):
        srv.submit("a")
    with pytest.raises(RuntimeError):
        srv.submit_many(["a"])


def test_render_mode_and_buckets(pipe):
    with DynamicBatcher(pipe, max_batch=8, buckets=[2, 8], max_wait_ms=200,
                        render=True, **GEN) as srv:
        srv.warmup()
        text, img = srv.submit("b").result(timeout=120)
        assert isinstance(text, str) and img.size == (80, 60)
        for f in [srv.submit(t) for t in ("a", "b", "c", "a", "b")]:
            f.result(timeout=120)
    assert srv.pad_sizes[0] == 2 and 8 in srv.pad_sizes[1:]
    assert all(p >= n for p, n in zip(srv.pad_sizes, srv.batch_sizes))


@pytest.mark.parametrize("max_batch,buckets", [
    (256, None), (256, "auto"), (6, "auto"), (100, "auto"), (8, [2, 4]),
    (8, (8, 3, 3)), (4, [8]), (4, []), (4, [0, 2]), (256, "128")])
def test_bucket_ladders_match_jax(pipe, max_batch, buckets):
    def make(cls, p):
        try:
            srv = cls(p, max_batch=max_batch, buckets=buckets)
        except ValueError as e:
            return type(e)
        srv.close()
        return srv.buckets

    # the JAX batcher only reads the pipeline's mesh size when built
    assert make(DynamicBatcher, pipe) == make(JaxBatcher,
                                              types.SimpleNamespace())


@pytest.mark.parametrize("hysteresis", [0, 3])
def test_bucket_choices_match_jax(pipe, hysteresis):
    sizes = [8, 8, 1, 1, 1, 1, 1, 3, 7, 1, 2, 5]
    srv = DynamicBatcher(pipe, max_batch=8, buckets=[2, 4, 8],
                         hysteresis=hysteresis)
    jax_srv = JaxBatcher(types.SimpleNamespace(), max_batch=8,
                         buckets=[2, 4, 8], hysteresis=hysteresis)
    try:
        got = [srv._choose_bucket(n) for n in sizes]
        assert got == [jax_srv._choose_bucket(n) for n in sizes]
        assert all(b >= n for b, n in zip(got, sizes))
    finally:
        srv.close()
        jax_srv.close()


def test_http_server_end_to_end(monkeypatch):
    """``python -m deephumor_tpu_torch.serve --synthetic`` on port 0:
    /caption, /captions with an unknown id and with an id whose batch
    raises, /meme with and without Pillow, and /healthz."""
    build = serve_mod.build_synthetic

    def build_with_a_failing_template(device):
        pipe, gen = build(device)
        pipe.add_template("boom", np.zeros((224, 224, 3), np.float32))
        captions = pipe.generate_captions

        def generate_captions(ids, *args, **kwargs):
            if "boom" in ids:
                raise ValueError("decode failed")
            return captions(ids, *args, **kwargs)

        pipe.generate_captions = generate_captions
        return pipe, gen

    monkeypatch.setattr(serve_mod, "build_synthetic",
                        build_with_a_failing_template)
    ev = threading.Event()
    t = threading.Thread(target=serve_mod.main, kwargs=dict(
        argv=["--synthetic", "--port", "0", "--device", "cpu",
              "--max-batch", "4", "--max-wait-ms", "20"], ready_event=ev),
        daemon=True)
    t.start()
    assert ev.wait(timeout=300), "server failed to come up"
    base = f"http://127.0.0.1:{ev.httpd.server_address[1]}"

    def get(route, timeout=120):
        return urllib.request.urlopen(base + route, timeout=timeout).read()

    try:
        assert get("/caption?template=one").decode()
        rows = json.loads(get("/captions?template=two&template=zzz"))
        assert [r["template"] for r in rows] == ["two", "zzz"]
        assert rows[0]["caption"]
        assert rows[1]["error"] == "unknown template"
        assert rows[1]["error_type"] == "KeyError"
        rows = json.loads(get("/captions?template=boom"))
        assert rows[0]["error_type"] == "ValueError"
        assert "decode failed" in rows[0]["error"]
        with pytest.raises(urllib.error.HTTPError) as err:
            get("/caption?template=zzz")
        assert err.value.code == 404
        png = get("/meme?template=two")
        assert Image.open(io.BytesIO(png)).size == (400, 300)
        monkeypatch.setattr(serve_mod, "_have_pil", lambda: False)
        with pytest.raises(urllib.error.HTTPError) as err:
            get("/meme?template=two")
        assert err.value.code == 501 and b"Pillow" in err.value.read()
        assert get("/caption?template=three").decode()  # still serving
        health = json.loads(get("/healthz"))
        assert health["ok"] and health["requests"] >= 4
    finally:
        ev.httpd.shutdown()
        t.join(timeout=60)
    assert not t.is_alive()


def test_library_builds_once_when_two_threads_call_it_cold(monkeypatch,
                                                           tmp_path):
    """Two threads' first kernel calls at once: one nvcc build, one load,
    one library (without the lock both would build into the same
    files)."""
    calls = {"compile": 0, "link": 0, "load": 0}

    def fake_run_all(cmds, log):
        time.sleep(0.2)  # a build long enough for the threads to meet
        kind = "link" if "-shared" in cmds[0] else "compile"
        calls[kind] += 1
        for cmd in cmds:
            out = cmd[cmd.index("-o") + 1]
            open(out, "w").close()

    class FakeLib:
        def __init__(self, path):
            calls["load"] += 1

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_run_all", fake_run_all)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    _build.library.cache_clear()
    _build._build_and_load.cache_clear()
    try:
        barrier = threading.Barrier(2)
        libs = []

        def first_call():
            barrier.wait()
            libs.append(_build.library())

        threads = [threading.Thread(target=first_call) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(libs) == 2 and libs[0] is libs[1]
        assert calls == {"compile": 1, "link": 1, "load": 1}
        assert len(list(tmp_path.glob("libdh_kernels_*.so"))) == 1
    finally:
        _build.library.cache_clear()
        _build._build_and_load.cache_clear()


def test_build_real_serves_a_saved_checkpoint(tmp_path):
    """``--ckpt/--vocab/--templates``: a checkpoint written by ``save``, a
    vocabulary file and a memes900k-style directory make a pipeline that
    captions every template."""
    from test_torch_image_ops import _memes_dir

    (tmp_path / "data").mkdir()
    root = _memes_dir(tmp_path / "data")
    vocab = Vocab([f"w{i}" for i in range(70)])
    vocab.save(tmp_path / "vocab.txt")
    model = CaptioningTransformerBase(num_tokens=len(vocab), hid_dim=16,
                                      n_layers=1, n_heads=4, pf_dim=24,
                                      max_len=34)
    model.save(model.init(torch.Generator().manual_seed(2), device="cpu"),
               tmp_path / "ckpt")
    pipe, gen = serve_mod.build_real(tmp_path / "ckpt", tmp_path / "vocab.txt",
                                     str(root), 2, device="cpu")
    assert gen == dict(max_len=32, beam_size=5, top_k=64)
    assert pipe.model == model and list(pipe._row) == ["Label 0", "Label 1"]
    assert set(pipe._images) == set(pipe._row)
    texts = pipe.generate_captions(list(pipe._row), **gen)
    assert len(texts) == 2 and all(
        t.split(" ")[0] in vocab.stoi for t in texts if t)
