"""deephumor_tpu_torch's captured mesh programs on the card, over a
one-rank NCCL mesh in this process (``make_mesh("cuda")``: data 1 x model
1), against the same calls run eagerly (``compiled=False``) from the same
state and generator: the data-parallel train and eval steps, the DP x TP
step over a ``place_train_state`` state (a Shard on the size-1 model
axis, so the model-axis all-reduces run over a one-rank group) and the
decode with that model group. Skipped without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_graphs_cuda.py

The graphs hold the all-reduces: the counts of ``utils.collectives`` (a
captured graph adds its tally at each replay) must equal the eager
run's. Results are held to bit-equality, as one card's captured steps
are (tests/test_torch_train_graphs_cuda.py).
"""

import collections

import numpy as np
import pytest
import torch

from deephumor_tpu_torch.experiments.trainer import Trainer
from deephumor_tpu_torch.models import CaptioningTransformer, graphs
from deephumor_tpu_torch.ops import LAUNCHES, reset_launch_counts
from deephumor_tpu_torch.parallel.sharding import local_tree, model_group
from deephumor_tpu_torch.utils import collectives
from deephumor_tpu_torch.utils.pytree import flatten_tree

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

V = 64
HP = dict(num_tokens=V, hid_dim=64, n_layers=2, n_heads=4, pf_dim=96,
          max_len=50)


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from deephumor_tpu_torch.parallel import make_mesh

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    owned = not dist.is_initialized()
    graphs.clear()
    yield make_mesh("cuda")
    # graphs that hold the group's collectives go before it
    graphs.clear()
    if owned:
        dist.destroy_process_group()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _batches(n, seed, bs=8):
    """``n`` batches from the trunk cache, the last a tail batch of 5 real
    rows (``row_valid``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        caps = rng.integers(6, V, (bs, 12))
        caps[:, -1] = 3
        caps[2, 7:] = 0
        b = {"captions": caps, "image_rows": rng.integers(0, 4, (bs,))}
        if i == n - 1:
            b = {k: np.concatenate([v[:5], np.repeat(v[4:5], bs - 5, 0)])
                 for k, v in b.items()}
            b["row_valid"] = np.arange(bs) < 5
        out.append(b)
    return out


def _run(mesh, place, compiled, tmp_path, title, dtype="bfloat16"):
    """Two epochs of 4 train steps (3 full batches and a tail) over
    ``mesh``, the state placed by ``place``, and an eval pass of 3
    batches after each: the logged values, the final local tensors, the
    all-reduce counts of each epoch and the trainer's keys after each
    epoch."""
    from deephumor_tpu_torch import parallel

    dev = torch.device("cuda")
    model = CaptioningTransformer(**HP)
    trainer = Trainer(model, title, log_dir=str(tmp_path), device=dev,
                      compute_dtype=dtype, compiled=compiled,
                      log_grad_norm=True, log_flush_every=3)
    state = getattr(parallel, place)(
        trainer.init_state(torch.Generator(dev).manual_seed(0)), mesh)
    trainer._trunk_cache = torch.from_numpy(np.random.default_rng(7).normal(
        size=(4, 7, 7, 2048)).astype(np.float32)).to(dev)
    gen = torch.Generator(dev).manual_seed(3)
    values, reduces, keys = [], [], []
    for epoch in range(2):
        before = collections.Counter(collectives.COUNTS)
        state, loss, pp = trainer.run_epoch(state, _batches(4, epoch), gen,
                                            epoch=epoch, mesh=mesh)
        _, vloss, vpp = trainer.run_epoch(state, _batches(3, 10 + epoch),
                                          None, phase="val", epoch=epoch,
                                          mesh=mesh)
        reduces.append(collectives.COUNTS - before)
        values += [loss, pp, vloss, vpp]
        keys.append(sorted((k["kind"], k["replays"])
                           for k in trainer._graphs.info()))
    flat = {k: v.clone()
            for k, v in flatten_tree(local_tree(state["params"])).items()}
    for m in ("mu", "nu"):
        flat.update({f"{m}/{k}": v.clone() for k, v in local_tree(
            state["opt_state"][m]).items()})
    trainer.close()
    return values, flat, reduces, keys, state


def _compare(mesh, place, tmp_path):
    eager = _run(mesh, place, False, tmp_path, "e")
    reset_launch_counts()
    captured = _run(mesh, place, None, tmp_path, "c")
    assert not any(LAUNCHES.values())
    assert captured[0] == eager[0]
    for k, v in eager[1].items():
        assert torch.equal(captured[1][k], v), k
    # the graphs' all-reduces, tallied at capture and added per replay,
    # are the eager run's, epoch by epoch
    assert captured[2] == eager[2]
    assert all(n and k[2] == "nccl" for c in captured[2]
               for k, n in c.items())
    # a train and an eval key for the full batch and for the tail; the
    # second epoch replays the first epoch's keys (its dropout generator
    # is reseeded in place), making none
    assert captured[3][0] == [("eval", 0), ("eval", 1), ("train", 0),
                              ("train", 2)]
    assert captured[3][1] == [("eval", 1), ("eval", 3), ("train", 1),
                              ("train", 5)]
    assert not eager[3][1]
    return captured


@pytest.mark.cuda
def test_captured_dp_steps_equal_eager(mesh, tmp_path):
    captured = _compare(mesh, "replicate", tmp_path)
    assert model_group(captured[4]["params"]) is None


@pytest.mark.cuda
def test_captured_dp_x_tp_steps_equal_eager(mesh, tmp_path):
    captured = _compare(mesh, "place_train_state", tmp_path)
    # a Shard on the size-1 model axis: the step's model-axis all-reduces
    # run over a one-rank group, inside the graph
    group = model_group(captured[4]["params"])
    assert group is not None and group.size() == 1


@pytest.mark.cuda
def test_reseeded_generator_takes_effect_at_replay(mesh):
    # a generator registered with a graph and reseeded in place between
    # replays draws what a generator made anew with that seed draws
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    out = torch.empty(1000, device=dev)
    torch.rand(1000, generator=gen, device=dev, out=out)  # warm-up
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with graphs.CAPTURE_LOCK:
        graph, _, _ = graphs.capture(
            lambda: torch.rand(1000, generator=gen, device=dev, out=out),
            torch.cuda.graph_pool_handle(), stream, (gen,))
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (5, 6, 5):
        gen.manual_seed(seed)
        graphs.replay(graph, ({}, collections.Counter()))
        want = torch.rand(1000, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
        assert torch.equal(out, want), seed


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_decode_with_a_model_group_equals_eager(mesh, dtype):
    from deephumor_tpu_torch.parallel import make_param_shardings

    dev = torch.device("cuda")
    model = CaptioningTransformer(**dict(HP, max_len=20), compute_dtype=dtype)
    # random weights: near-uniform logits, so no item ends all its
    # branches before the last step (the eager loop would stop there, a
    # graph runs its phase to the end)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    local = local_tree(make_param_shardings(params, mesh))
    rng = np.random.default_rng(1)
    enc = tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        dev) for s in ((16, 64), (16, 49, 64)))
    kw = dict(max_len=16, beam_size=3, top_k=8, temperature=1.1,
              model_group=mesh.get_group("model"))

    def call(compiled, **extra):
        return model.generate_from_emb(
            local, enc, generator=torch.Generator(dev).manual_seed(5),
            compiled=compiled, **dict(kw, **extra))

    graphs.clear()
    before = collections.Counter(collectives.COUNTS)
    for extra in ({"sampler": "pallas"}, {"greedy": True}):
        reset_launch_counts()
        eager = call(False, **extra)
        counts = [dict(LAUNCHES)]
        reduces = [collectives.COUNTS - before]
        first = call(None, **extra)  # eager warm-up, capture, replay
        before = collections.Counter(collectives.COUNTS)
        reset_launch_counts()
        again = call(None, **extra)
        counts.append(dict(LAUNCHES))
        reduces.append(collectives.COUNTS - before)
        for out in (first, again):
            for key in ("sequences", "scores", "chosen", "ended"):
                assert torch.equal(out[key], eager[key]), key
        assert counts[0] == counts[1]
        assert counts[1]["ancestry_attention_update"]
        assert counts[1]["grouped_cross_attention"]
        # the decode's fc_o / fc_2 partial sums, inside the graphs
        assert reduces[0] == reduces[1] and sum(reduces[1].values())
        before = collections.Counter(collectives.COUNTS)
    info = graphs.cache_info()
    assert [(k["collective"], k["replays"]) for k in info] == [(True, 2)] * 2
    graphs.clear()


@pytest.mark.cuda
def test_captured_char_decode_with_a_model_group_equals_eager(mesh):
    # char's phases and phase boundaries (early-EOS compaction, then the
    # canonical prefix), each a graph that holds the model group's
    # all-reduces
    from deephumor_tpu_torch.parallel import make_param_shardings

    dev = torch.device("cuda")
    model = CaptioningTransformer(**dict(HP, max_len=48))
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    params["decoder"]["classifier"]["bias"][3] = 0.2
    local = local_tree(make_param_shardings(params, mesh))
    rng = np.random.default_rng(3)
    scale = np.linspace(0.3, 2.0, 8, dtype=np.float32)[:, None]
    enc = (rng.normal(size=(8, 64)).astype(np.float32) * scale,
           rng.normal(size=(8, 49, 64)).astype(np.float32)
           * scale[:, :, None])
    enc = tuple(torch.from_numpy(x).to(dev) for x in enc)
    kw = dict(max_len=40, beam_size=4, top_k=8, compact=True, greedy=True,
              model_group=mesh.get_group("model"))
    graphs.clear()
    eager = model.generate_from_emb(local, enc, compiled=False, **kw)
    outs = [model.generate_from_emb(local, enc, **kw) for _ in range(2)]
    for out in outs:
        for key in ("sequences", "scores", "chosen", "ended"):
            assert torch.equal(out[key], eager[key]), key
        assert out["boundaries"] == eager["boundaries"]
    (info,) = graphs.cache_info()
    assert info["collective"] and info["captured_boundaries"] >= 1
    assert not info["eager_tail"] and info["replays"] == 2
    graphs.clear()
