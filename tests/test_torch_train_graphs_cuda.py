"""deephumor_tpu_torch's captured train and eval steps, trunk and
generation from images (experiments/step_graphs.py, models/graphs.py) on
the card against the same calls run eagerly (``compiled=False``), from
the same state and generator. Skipped without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graphs_cuda.py

Two eager runs of these steps are bit-equal on an H100 (the gap between
them, printed by each comparison, is 0), so the captured run is held to
bit-equality: losses, perplexities, gradient norms, every parameter,
batch-norm statistic and moment, and the eval pass's values.
"""

import json

import numpy as np
import pytest
import torch

from deephumor_tpu_torch.experiments.trainer import Trainer
from deephumor_tpu_torch.models import (CaptioningLSTM,
                                        CaptioningLSTMWithLabels,
                                        CaptioningTransformer, graphs)
from deephumor_tpu_torch.ops import LAUNCHES, reset_launch_counts
from deephumor_tpu_torch.utils.pytree import flatten_tree, tree_map

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

V = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _batches(n, seed, from_images, bs=8):
    """``n`` batches, the last a tail batch of 5 real rows (``row_valid``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        caps = rng.integers(6, V, (bs, 12))
        caps[:, -1] = 3
        caps[2, 7:] = 0
        b = {"captions": caps}
        if from_images:
            b["images"] = rng.normal(size=(bs, 32, 32, 3)).astype(np.float32)
        else:
            b["image_rows"] = rng.integers(0, 4, (bs,))
        if i == n - 1:
            b = {k: np.concatenate([v[:5], np.repeat(v[4:5], bs - 5, 0)])
                 for k, v in b.items()}
            b["row_valid"] = np.arange(bs) < 5
        out.append(b)
    return out


def _run(model, params, trunk, compiled, tmp_path, title):
    """Two epochs of 4 train steps (3 full batches and a tail) and an
    eval pass of 3 batches after each: the logged per-step values, the
    eval losses, the final state and the trainer's keys."""
    dev = torch.device("cuda")
    trainer = Trainer(model, title, log_dir=str(tmp_path), device=dev,
                      compiled=compiled, log_grad_norm=True,
                      log_flush_every=3)
    state = trainer.init_state(params=tree_map(
        lambda t: t.clone().to(dev), params))
    from_images = trunk is None
    if not from_images:
        trainer._trunk_cache = trunk.to(dev)
    gen = torch.Generator(dev).manual_seed(3)
    evals = []
    for epoch in range(2):
        state, _, _ = trainer.run_epoch(
            state, _batches(4, epoch, from_images), gen, epoch=epoch)
        _, loss, pp = trainer.run_epoch(
            state, _batches(3, 10 + epoch, from_images), None, phase="val",
            epoch=epoch)
        evals += [loss, pp]
    lines = (tmp_path / trainer.experiment_name / "train" /
             "metrics.jsonl").read_text().splitlines()
    logged = [json.loads(x)["value"] for x in lines]
    flat = {k: v.clone() for k, v in flatten_tree(state["params"]).items()}
    for m in ("mu", "nu"):
        flat.update({f"{m}/{k}": v.clone()
                     for k, v in state["opt_state"][m].items()})
    info = trainer._graphs.info()
    trainer.close()
    return logged + evals, flat, state, info


def _gap(a, b):
    """The largest difference between two runs' values and tensors."""
    (va, ta), (vb, tb) = a, b
    gap = max(abs(x - y) for x, y in zip(va, vb))
    return max([gap] + [(ta[k].float() - tb[k].float()).abs().max().item()
                        for k in ta])


def _compare(model, params, trunk, tmp_path):
    eager = [_run(model, params, trunk, False, tmp_path, f"e{i}")
             for i in range(2)]
    reset_launch_counts()
    captured = _run(model, params, trunk, None, tmp_path, "c")
    assert not any(LAUNCHES.values())
    gap = _gap(eager[0][:2], eager[1][:2])
    got = _gap(captured[:2], eager[0][:2])
    print(f"gap between two eager runs {gap}, captured vs eager {got}")
    assert got <= gap, (got, gap)
    assert captured[2]["step"] == eager[0][2]["step"] == 8
    assert captured[2]["opt_state"]["count"] == 8
    # a train key for the full batch (1 eager step + 5 replays) and one for
    # the tail (1 + 1); an eval key for each (1 + 3, 1 + 1)
    info = sorted((k["kind"], k["replays"]) for k in captured[3])
    assert info == [("eval", 1), ("eval", 3), ("train", 1), ("train", 5)]
    assert not eager[0][3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_transformer_steps_equal_eager(cuda, tmp_path, dtype):
    model = CaptioningTransformer(num_tokens=V, hid_dim=64, n_layers=2,
                                  n_heads=4, pf_dim=96, max_len=50,
                                  compute_dtype=dtype)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    trunk = torch.randn(4, 7, 7, 2048,
                        generator=torch.Generator().manual_seed(1))
    _compare(model, params, trunk, tmp_path)


@pytest.mark.cuda
def test_captured_lstm_steps_from_images_equal_eager(cuda, tmp_path):
    model = CaptioningLSTM(num_tokens=V, emb_dim=32, hidden_size=32,
                           num_layers=2)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    _compare(model, params, None, tmp_path)


@pytest.mark.cuda
def test_captured_state_keeps_its_tensors(cuda, tmp_path):
    model = CaptioningLSTM(num_tokens=V, emb_dim=32, hidden_size=32,
                           num_layers=2)
    trainer = Trainer(model, "k", log_dir=str(tmp_path), device=cuda)
    state = trainer.init_state(torch.Generator(cuda).manual_seed(0))
    ptrs = {k: v.data_ptr() for k, v in flatten_tree(state["params"]).items()}
    stats = state["params"]["encoder"]["bn"]["running_mean"].clone()
    state, _, _ = trainer.run_epoch(state, _batches(4, 0, True),
                                    torch.Generator(cuda).manual_seed(1))
    assert ptrs == {k: v.data_ptr()
                    for k, v in flatten_tree(state["params"]).items()}
    assert not torch.equal(stats,
                           state["params"]["encoder"]["bn"]["running_mean"])
    trainer.close()


class _Images:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.images = {f"t{i}": rng.normal(size=(64, 64, 3)).astype(
            np.float32) for i in range(n)}


@pytest.mark.cuda
def test_captured_trunk_cache_equals_eager(cuda, tmp_path):
    model = CaptioningTransformer(num_tokens=V, hid_dim=64, n_layers=2,
                                  n_heads=4, pf_dim=96, max_len=50)
    params = model.init(torch.Generator(cuda).manual_seed(0), cuda)
    data = _Images(40, 2)  # chunks of 16, 16 and 8
    feats = []
    for compiled in (False, None):
        trainer = Trainer(model, "t", log_dir=str(tmp_path), device=cuda,
                          compiled=compiled)
        rows = trainer.build_trunk_cache(params, data, batch_size=16)
        feats.append(trainer._trunk_cache)
        trainer.close()
    assert rows == {f"t{i}": i for i in range(40)}
    assert feats[0].shape == (40, 2, 2, 2048)
    assert torch.equal(feats[0], feats[1])


def _count_calls(monkeypatch, cls, name):
    calls = [0]
    real = getattr(cls, name)

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(cls, name, counted)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["word", "lstm_labels"])
def test_generate_from_images_replays_whole(cuda, monkeypatch, kind):
    if kind == "word":
        model = CaptioningTransformer(num_tokens=300, hid_dim=64,
                                      n_layers=2, n_heads=2, pf_dim=128,
                                      max_len=40, compute_dtype="bfloat16")
    else:
        model = CaptioningLSTMWithLabels(num_tokens=300, emb_dim=64,
                                         hidden_size=64, num_layers=2,
                                         compute_dtype="bfloat16")
    params = model.init(torch.Generator(cuda).manual_seed(0), cuda)
    # no branch ends early, so the eager loop launches what the graphs do
    # (where every branch ends inside a segment, a graph runs it out)
    params["decoder"]["classifier"]["bias"][3] = -10.0
    encodes = _count_calls(monkeypatch, type(model), "encode")
    g = torch.Generator(cuda).manual_seed(1)

    def inputs():
        images = torch.randn(4, 64, 64, 3, generator=g, device=cuda)
        if kind == "word":
            return (images,)
        return images, torch.randint(4, 300, (4, 3), generator=g,
                                     device=cuda)

    def call(x, compiled):
        reset_launch_counts()
        out = model.generate(
            params, *x, generator=torch.Generator(cuda).manual_seed(5),
            compiled=compiled, max_len=20, beam_size=3, top_k=8,
            sampler="pallas")
        return out, dict(LAUNCHES)

    for i in range(3):
        x = inputs()
        eager, eager_launches = call(x, False)
        before = encodes[0]
        captured, launches = call(x, None)
        for key in ("sequences", "scores", "chosen", "ended"):
            assert torch.equal(captured[key], eager[key]), key
        # the key's first call runs eagerly, captures, then replays: its
        # launches count twice; every later call replays once
        assert launches == {k: v * (2 if i == 0 else 1)
                            for k, v in eager_launches.items()}
        assert launches["fused_topk_gumbel_sample"] > 0
        # the key's first call encodes eagerly, then in its capture; every
        # later call replays the encoder inside the prefill's graph
        assert encodes[0] - before == (2 if i == 0 else 0)
    (info,) = graphs.cache_info()
    assert info["replays"] == 3 and not info["eager_tail"]
