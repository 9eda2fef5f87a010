"""deephumor_tpu_torch.parallel on the CPU: gloo ranks started as spawn
processes over a FileStore, held to the port's single-process run and to
the JAX package's mesh runs (its 8 virtual CPU devices) on the same
weights.

- DP training: two ``Trainer.run_epoch`` steps on 2 ranks (ragged
  captions, a padded tail batch, a train-mode encoder head with batch
  norm), and a run that normalises the loss per shard, which must differ;
- TP: the teacher-forced loss and gradient on DTensor parameters placed
  by ``make_param_shardings`` over a data 1 x model 2 mesh;
- ``dp_generate`` greedy for the word transformer (also with a caption
  prefix), the LSTM and char with compaction, and its model-axis error;
- a ``DynamicBatcher`` on rank 0 over a mesh pipeline that rank 1
  follows;
- without processes: the TP specs, the batcher's data-axis checks and
  ``make_mesh``'s size error.

Each spawn has its own time limit (``SPAWN_TIMEOUT_S``) and kills its
ranks when it runs out, so that a hung rank fails its own tests only.
The workers import torch and the port only (JAX is imported by the tests
that compare with it, in this process).
"""

import os
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deephumor_tpu_torch.convert.jax_params import (params_from_jax,
                                                    params_to_jax)
from deephumor_tpu_torch.data import Vocab
from deephumor_tpu_torch.experiments.metrics import masked_cross_entropy
from deephumor_tpu_torch.experiments.trainer import Trainer
from deephumor_tpu_torch.models import (CaptioningLSTM,
                                        CaptioningTransformer,
                                        CaptioningTransformerBase)
from deephumor_tpu_torch.parallel import (data_sharding, dp_generate,
                                          make_mesh, make_param_shardings,
                                          replicate, shard_batch,
                                          tp_param_specs)
from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
from deephumor_tpu_torch.serving import DynamicBatcher
from deephumor_tpu_torch.utils.pytree import flatten_tree

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

WORLD = 2
SPAWN_TIMEOUT_S = 120
V = 48
TRAIN_HP = dict(num_tokens=V, hid_dim=32, n_layers=2, n_heads=4, pf_dim=48,
                max_len=50, enc_dropout=0.0, dec_dropout=0.0)
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-4  # tests/test_parallel.py's tolerances
# a bias added to every key leaves each softmax as it is: its gradient is
# rounding noise, which Adam turns into steps of up to lr whose sign is
# the noise's, and two ranks' partial sums round otherwise than one
# process's sum. Those leaves' values are not compared (as
# tests/test_torch_training.py skips the zero-gradient head bias)
ZERO_GRAD_SUFFIX = "fc_k/bias"


# -- inputs, the same in every process --------------------------------------
def _train_data():
    """A trunk cache and two global batches of 8: ragged captions (the
    shards hold different token counts) and a padded tail batch (5 real
    rows: 4 on rank 0, 1 on rank 1)."""
    rng = np.random.default_rng(11)
    trunk = rng.normal(size=(6, 7, 7, 2048)).astype(np.float32)
    batches = []
    for tail in (False, True):
        caps = rng.integers(6, V, (8, 12)).astype(np.int32)
        caps[:, -1] = 3
        caps[0, 4:] = 0
        caps[1, 6:] = 0
        caps[5, 9:] = 0
        batch = {"captions": caps,
                 "image_rows": rng.integers(0, 6, (8,)).astype(np.int32)}
        if tail:
            batch["row_valid"] = np.arange(8) < 5
        batches.append(batch)
    return trunk, batches


def _train_model():
    model = CaptioningTransformer(**TRAIN_HP)
    return model, model.init(torch.Generator().manual_seed(5), device="cpu")


def _gen_models():
    """(name, model, params, enc, kwargs) of the three dp_generate cases."""
    rng = np.random.default_rng(3)
    word = CaptioningTransformer(num_tokens=24, hid_dim=16, n_layers=2,
                                 n_heads=4, pf_dim=32, max_len=16)
    enc = (torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
           torch.from_numpy(rng.normal(size=(8, 49, 16)).astype(np.float32)))
    lstm = CaptioningLSTM(num_tokens=24, emb_dim=8, hidden_size=12,
                          num_layers=1)
    emb = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
    char = CaptioningTransformer(num_tokens=64, hid_dim=32, n_layers=2,
                                 n_heads=2, pf_dim=64, max_len=48)
    # items at several feature scales end at different steps
    scale = np.linspace(0.3, 2.0, 8, dtype=np.float32)[:, None]
    cenc = (torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32)
                             * scale),
            torch.from_numpy(rng.normal(size=(8, 49, 32)).astype(np.float32)
                             * scale[:, :, None]))
    out = []
    for name, model, e, kw in (
            ("word", word, enc, dict(max_len=8, beam_size=3, top_k=8)),
            ("lstm", lstm, emb, dict(max_len=8, beam_size=2, top_k=8)),
            ("char", char, cenc, dict(max_len=40, beam_size=4, top_k=8,
                                      compact=True))):
        params = model.init(torch.Generator().manual_seed(7), device="cpu")
        if name == "char":
            # an EOS bias at which each shard's items end at different
            # steps, some before the first compaction (p_eff 24)
            params["decoder"]["classifier"]["bias"][3] = 0.7
        out.append((name, model, params, e, kw))
    return out


PREFIX = torch.from_numpy(
    np.random.default_rng(4).integers(6, 24, size=(8, 3))).long()
WORDS = ["when", "you", "ship", "it", "works", "and", "bug", "<sep>", "the",
         "fix", "breaks", "prod", "again", "!", "?", "friday"]
PIPE_GEN = dict(max_len=10, beam_size=2, top_k=5, greedy=True)
PIPE_IDS = ["a", "b", "c", "d", "e"]
REQUESTS = [PIPE_IDS[(3 * i) % 5] for i in range(25)]


def _pipeline(mesh=None):
    vocab = Vocab(WORDS)
    model = CaptioningTransformer(num_tokens=len(vocab), hid_dim=32,
                                  n_layers=1, n_heads=2, pf_dim=48,
                                  max_len=16)
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    params["decoder"]["classifier"]["bias"][3] = -1.0
    pipe = MemeGenerationPipeline(model, params, vocab, mesh=mesh)
    images = np.random.default_rng(1).normal(size=(5, 64, 64, 3))
    pipe.add_templates(PIPE_IDS[:3], images[:3])
    # every rank consolidates, then the store grows: its blocks move
    pipe._stack_features(PIPE_IDS[:3])
    pipe.add_templates(PIPE_IDS[3:], images[3:])
    return pipe


# -- the ranks ---------------------------------------------------------------
def _np_tree(params):
    return {k: v.detach().numpy().copy()
            for k, v in flatten_tree(params).items()}


def _dp_train(tmp, per_shard_mean=False):
    """Two run_epoch steps over the mesh; with ``per_shard_mean`` the loss
    and perplexity are each shard's own means, averaged over the ranks
    (a naive data-parallel port)."""
    from deephumor_tpu_torch.experiments import trainer as trainer_mod

    own = trainer_mod.masked_ce_and_perplexity
    if per_shard_mean:
        def naive(*args, group=None, **kwargs):
            return tuple(x / dist.get_world_size(group)
                         for x in own(*args, **kwargs))

        trainer_mod.masked_ce_and_perplexity = naive
    try:
        return _dp_run(tmp)
    finally:
        trainer_mod.masked_ce_and_perplexity = own


def _dp_run(tmp):
    mesh = make_mesh("cpu")
    trunk, batches = _train_data()
    model, params = _train_model()
    trainer = Trainer(model, "dp", log_dir=tmp, device="cpu", prefetch=0,
                      log_flush_every=1)
    trainer._trunk_cache = torch.from_numpy(trunk)
    state = replicate(trainer.init_state(params=params), mesh)
    step, metric_bytes = trainer._train_step, []

    def recorded(*args):
        state, metrics = step(*args)
        metric_bytes.append({k: v.untyped_storage().nbytes()
                             for k, v in metrics.items()})
        return state, metrics

    trainer._train_step = recorded
    state, loss, pp = trainer.run_epoch(state, batches,
                                        torch.Generator().manual_seed(1),
                                        mesh=mesh)
    trainer.close()
    return {"loss": loss, "pp": pp, "params": _np_tree(state["params"]),
            "step": state["step"], "metric_bytes": metric_bytes,
            "logged": os.path.isdir(trainer.experiment_dir)}


def _tp_loss(model, params, feats, caps):
    logits = model.forward(params, feats, caps[:, :-1], from_trunk=True)
    return masked_cross_entropy(logits[:, :caps.shape[1]], caps)


def _tp_inputs():
    g = torch.Generator().manual_seed(9)
    caps = torch.randint(6, 24, (8, 7), generator=g)
    caps[:, -1] = 3
    caps[2, 4:] = 0
    return torch.randn(8, 7, 7, 2048, generator=g), caps


def _tp():
    from torch.distributed.tensor import DTensor

    mesh = make_mesh("cpu", model=2)
    model = CaptioningTransformerBase(num_tokens=24, hid_dim=16, n_layers=2,
                                      n_heads=4, pf_dim=32, max_len=16,
                                      enc_dropout=0.0, dec_dropout=0.0)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    feats, caps = _tp_inputs()
    tp = make_param_shardings(params, mesh)
    rows = shard_batch({"feats": feats, "caps": caps}, mesh)
    feats_d, caps_d = (DTensor.from_local(x, mesh, data_sharding(mesh, x.ndim))
                       for x in (rows["feats"], rows["caps"]))
    leaves = [x.requires_grad_() for x in flatten_tree(tp).values()]
    loss = _tp_loss(model, tp, feats_d, caps_d)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True,
                                allow_unused=True)
    sq = sum((g * g).sum() for g in grads)
    fc_q = tp["decoder"]["layers"][0]["self_attn"]["fc_q"]["weight"]
    fc_o = tp["decoder"]["layers"][0]["self_attn"]["fc_o"]["weight"]
    return {"loss": loss.full_tensor().item(),
            "grad_norm": float(sq.full_tensor()) ** 0.5,
            "fc_q": str(fc_q.placements), "fc_o": str(fc_o.placements),
            "fc_q_local": tuple(fc_q.to_local().shape)}


def _rank_train(rank, tmp):
    return {"dp": _dp_train(os.path.join(tmp, f"dp{rank}")),
            "naive": _dp_train(os.path.join(tmp, f"naive{rank}"), True),
            "tp": _tp()}


def _rank_generate(rank, tmp):
    mesh = make_mesh("cpu")
    out = {}
    for name, model, params, enc, kw in _gen_models():
        got = dp_generate(model, replicate(params, mesh), enc, mesh,
                          greedy=True, **kw)
        out[name] = {k: v.numpy() for k, v in got.items()
                     if isinstance(v, torch.Tensor)}
        out[name]["boundaries"] = got.get("boundaries")
        if name == "word":
            got = dp_generate(model, params, enc, mesh, caption=PREFIX,
                              greedy=True, **kw)
            out["word_prefix"] = got["chosen"].numpy()
            one = dp_generate(model, params, enc, mesh, sampler="pallas",
                              generator=torch.Generator().manual_seed(3),
                              **kw)
            two = dp_generate(model, params, enc, mesh, sampler="pallas",
                              generator=torch.Generator().manual_seed(3),
                              **kw)
            out["sampled"] = (one["chosen"].numpy(), two["chosen"].numpy())
    try:
        dp_generate(_gen_models()[0][1], None, None,
                    make_mesh("cpu", model=2))
    except ValueError as e:
        out["model_axis_error"] = str(e)
    pipe = _pipeline(mesh)
    if rank == 0:
        with DynamicBatcher(pipe, max_batch=8, buckets="auto",
                            max_wait_ms=5, **PIPE_GEN) as srv:
            futs = srv.submit_many(REQUESTS[:9]) + [
                srv.submit(t) for t in REQUESTS[9:]]
            out["served"] = [f.result(timeout=60) for f in futs]
            out["pad_sizes"] = srv.pad_sizes
        pipe.close()
    else:
        pipe.follow()
    return out


def _rank_main(target, rank, world, store, outdir):
    """One gloo rank: runs ``target(rank, outdir)`` and saves its result
    (or its traceback) in ``outdir``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        result = globals()[target](rank, outdir)
        torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _spawn(target, tmp_path, timeout=SPAWN_TIMEOUT_S):
    """Runs ``target`` on WORLD gloo ranks; returns their results. Kills
    every rank still running after ``timeout`` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, WORLD, store, str(tmp_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp_path / f"rank{r}.err") for r in range(WORLD)]
    errors = [e.read_text() for e in errors if e.exists()]
    if hung or errors or any(p.exitcode for p in procs):
        pytest.fail(f"{target}: ranks {hung} still running after {timeout} "
                    f"s; exit codes {[p.exitcode for p in procs]}\n"
                    + "\n".join(errors))
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    return _spawn("_rank_train", tmp_path_factory.mktemp("train"))


@pytest.fixture(scope="module")
def gen_ranks(tmp_path_factory):
    return _spawn("_rank_generate", tmp_path_factory.mktemp("generate"))


# -- DP training -------------------------------------------------------------
@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    """The same two steps in one process, without a mesh."""
    trunk, batches = _train_data()
    model, params = _train_model()
    trainer = Trainer(model, "one", log_dir=str(tmp_path_factory.mktemp(
        "one")), device="cpu", prefetch=0)
    trainer._trunk_cache = torch.from_numpy(trunk)
    state, loss, pp = trainer.run_epoch(trainer.init_state(params=params),
                                        batches,
                                        torch.Generator().manual_seed(1))
    trainer.close()
    return {"loss": loss, "pp": pp, "params": _np_tree(state["params"])}


def _assert_params_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if not k.endswith(ZERO_GRAD_SUFFIX):
            np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL,
                                       rtol=0, err_msg=k)


def test_dp_train_loss_matches_single_process(train_ranks, single_run):
    for rank in train_ranks:
        np.testing.assert_allclose(
            [rank["dp"]["loss"], rank["dp"]["pp"]],
            [single_run["loss"], single_run["pp"]], rtol=LOSS_RTOL)
        assert rank["dp"]["step"] == 2


def test_dp_train_params_match_single_process(train_ranks, single_run):
    a, b = (r["dp"]["params"] for r in train_ranks)
    for k in a:  # the ranks stay equal
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _assert_params_close(a, single_run["params"])
    # the synced batch-norm statistics moved as the single process's did
    for k in ("encoder/bn/running_mean", "encoder/bn/running_var"):
        np.testing.assert_allclose(a[k], single_run["params"][k],
                                   rtol=1e-5, atol=1e-6)


def test_dp_train_metrics_hold_only_themselves(train_ranks):
    """The step's metrics are scalars of their own: as views of the
    summed-gradient buffer, every step that run_epoch defers would keep
    the whole buffer alive. Only rank 0 makes the metrics directories."""
    for rank in train_ranks:
        assert len(rank["dp"]["metric_bytes"]) == 2
        for sizes in rank["dp"]["metric_bytes"]:
            assert set(sizes) == {"loss", "perplexity", "grad_norm"}
            assert max(sizes.values()) <= 4, sizes
    assert [r["dp"]["logged"] for r in train_ranks] == [True, False]


def test_dp_train_matches_jax_mesh_run(train_ranks, tmp_path):
    import jax
    import jax.numpy as jnp

    from deephumor_tpu.experiments.trainer import Trainer as JaxTrainer
    from deephumor_tpu.models import CaptioningTransformer as JaxModel
    from deephumor_tpu.parallel import make_mesh as jax_mesh
    from deephumor_tpu.parallel import replicate as jax_replicate

    trunk, batches = _train_data()
    _, params = _train_model()
    jt = JaxTrainer(JaxModel(**TRAIN_HP), "j", log_dir=str(tmp_path))
    mesh = jax_mesh(devices=jax.devices()[:WORLD])
    js = jt.init_state(jax.random.PRNGKey(0),
                       params=jax.tree.map(jnp.asarray, params_to_jax(params)))
    jt._trunk_cache = jnp.asarray(trunk)
    js = {"params": jax_replicate(js["params"], mesh),
          "opt_state": jax_replicate(js["opt_state"], mesh),
          "step": js["step"]}
    js, loss, pp = jt.run_epoch(js, batches, jax.random.PRNGKey(1), "train",
                                1, mesh=mesh)
    jt.close()
    dp = train_ranks[0]["dp"]
    np.testing.assert_allclose([dp["loss"], dp["pp"]], [loss, pp],
                               rtol=LOSS_RTOL)
    want = _np_tree(params_from_jax(jax.device_get(js["params"])))
    _assert_params_close(dp["params"], want)


def test_per_shard_mean_differs(train_ranks, single_run):
    """A mean of per-shard means weighs the shards' tokens unequally:
    this proves that the checks above see the normalisation."""
    naive = train_ranks[0]["naive"]
    assert not np.isclose(naive["loss"], single_run["loss"],
                          rtol=LOSS_RTOL, atol=0)
    assert not np.isclose(naive["pp"], single_run["pp"], rtol=LOSS_RTOL,
                          atol=0)


# -- TP ----------------------------------------------------------------------
def test_tp_loss_matches_replicated(train_ranks):
    model = CaptioningTransformerBase(num_tokens=24, hid_dim=16, n_layers=2,
                                      n_heads=4, pf_dim=32, max_len=16,
                                      enc_dropout=0.0, dec_dropout=0.0)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    plain = _tp_loss(model, params, *_tp_inputs()).item()
    for rank in train_ranks:
        tp = rank["tp"]
        np.testing.assert_allclose(tp["loss"], plain, rtol=1e-5)
        assert np.isfinite(tp["grad_norm"]) and tp["grad_norm"] > 0


def test_tp_places_weights_over_the_model_axis(train_ranks):
    for rank in train_ranks:
        tp = rank["tp"]
        assert tp["fc_q"] == "(Replicate(), Shard(dim=0))"
        assert tp["fc_o"] == "(Replicate(), Shard(dim=1))"
        assert tp["fc_q_local"] == (8, 16)  # half of fc_q's 16 outputs


def test_tp_param_specs_match_jax():
    import jax
    import jax.numpy as jnp

    from deephumor_tpu.parallel import tp_param_specs as jax_specs

    _, params = _train_model()

    def leaf_specs(tree, specs, prefix=""):
        # specs are tuples: walk the parameter tree beside them
        if isinstance(tree, dict):
            return {k: v for name in tree for k, v in leaf_specs(
                tree[name], specs[name], f"{prefix}{name}/").items()}
        if isinstance(tree, list):
            return {k: v for i, t in enumerate(tree) for k, v in leaf_specs(
                t, specs[i], f"{prefix}{i}/").items()}
        return {prefix[:-1]: specs}

    got = leaf_specs(params, tp_param_specs(params))
    jp = jax.tree.map(jnp.asarray, params_to_jax(params))
    want = jax.tree_util.tree_flatten_with_path(
        jax_specs(jp), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in want}
    kernels = {k: v for k, v in want.items() if k.endswith("/kernel")}
    assert any(v for v in kernels.values())
    for k, spec in kernels.items():  # kernel [in, out] = weight.T
        assert got[k[:-len("kernel")] + "weight"] == spec[::-1], k
    for k, spec in want.items():
        if k.endswith("/bias") and k[:-len("bias")] + "kernel" in want:
            assert got[k] == spec, k
    # everything else is replicated in both
    rest = {k for k, v in got.items() if v}
    assert rest == {k.replace("kernel", "weight") for k, v in want.items()
                    if v}


# -- dp_generate -------------------------------------------------------------
@pytest.fixture(scope="module")
def single_generate():
    return {name: model.generate_from_emb(params, enc, greedy=True, **kw)
            for name, model, params, enc, kw in _gen_models()}


@pytest.mark.parametrize("name", ["word", "lstm", "char"])
def test_dp_generate_greedy_equals_single_process(gen_ranks, single_generate,
                                                  name):
    want = single_generate[name]
    for rank in gen_ranks:
        for key in ("sequences", "chosen", "ended"):
            np.testing.assert_array_equal(rank[name][key],
                                          want[key].numpy(), err_msg=key)
        np.testing.assert_allclose(rank[name]["scores"],
                                   want["scores"].numpy(), atol=1e-5)
    if name == "char":
        # each shard compacted: its live items fell below its 4
        shards = gen_ranks[0]["char"]["boundaries"]
        assert shards == gen_ranks[1]["char"]["boundaries"]
        assert len(shards) == WORLD
        assert all(any(b["live"] is not None and b["live"] < 4
                       for b in shard) for shard in shards)


@pytest.mark.parametrize("name", ["word", "lstm", "char"])
def test_dp_generate_greedy_equals_jax_dp_generate(gen_ranks, name):
    import jax
    import jax.numpy as jnp

    from deephumor_tpu import models as JM
    from deephumor_tpu.parallel import dp_generate as jax_dp_generate
    from deephumor_tpu.parallel import make_mesh as jax_mesh
    from deephumor_tpu.parallel import replicate as jax_replicate
    from deephumor_tpu.parallel import shard_batch as jax_shard

    _, model, params, enc, kw = next(c for c in _gen_models()
                                     if c[0] == name)
    jm = getattr(JM, type(model).__name__)(**{
        k: getattr(model, k) for k in model.__dataclass_fields__})
    mesh = jax_mesh(devices=jax.devices()[:WORLD])
    jp = jax_replicate(jax.tree.map(jnp.asarray, params_to_jax(params)),
                       mesh)
    jenc = jax.tree.map(lambda t: jax_shard(jnp.asarray(t.numpy()), mesh),
                        enc)
    jkw = {k: v for k, v in kw.items() if k != "compact"}
    extra = {} if name == "lstm" else {"attn": "xla"}
    want = jax_dp_generate(jm, jp, jenc, mesh, greedy=True, **jkw, **extra)
    np.testing.assert_array_equal(gen_ranks[0][name]["chosen"],
                                  np.asarray(want["chosen"]))
    if name == "word":
        want = jax_dp_generate(
            jm, jp, jenc, mesh, caption=jax_shard(jnp.asarray(
                PREFIX.numpy().astype(np.int32)), mesh),
            greedy=True, **jkw, **extra)
        np.testing.assert_array_equal(gen_ranks[0]["word_prefix"],
                                      np.asarray(want["chosen"]))


def test_dp_generate_shards_caption_prefix(gen_ranks):
    _, model, params, enc, kw = _gen_models()[0]
    want = model.generate_from_emb(params, enc, caption=PREFIX, greedy=True,
                                   **kw)["chosen"].numpy()
    for rank in gen_ranks:
        np.testing.assert_array_equal(rank["word_prefix"], want)
        assert (rank["word_prefix"][:, :3] == PREFIX.numpy()).all()


def test_dp_generate_sampled_is_seeded_and_valid(gen_ranks):
    one, two = gen_ranks[0]["sampled"]
    np.testing.assert_array_equal(one, two)
    np.testing.assert_array_equal(one, gen_ranks[1]["sampled"][0])
    assert ((one >= 0) & (one < 24) & (one != 1)).all()  # no UNK


def test_dp_generate_model_axis_error(gen_ranks):
    for rank in gen_ranks:
        assert rank["model_axis_error"] == (
            "dp_generate shards over 'data' only; build the mesh with "
            "model=1")


# -- the mesh pipeline behind the batcher ------------------------------------
def test_batcher_over_mesh_pipeline_equals_single_device(gen_ranks):
    pipe = _pipeline()
    want = pipe.generate_captions(REQUESTS, **PIPE_GEN)
    served = gen_ranks[0]["served"]
    assert served == want
    assert all(b % WORLD == 0 for b in gen_ranks[0]["pad_sizes"])


# -- without processes -------------------------------------------------------
class _StubPipeline:
    _data_size = 4
    _row = {}
    device = torch.device("cpu")


# (max_batch, buckets): the cases JAX's DynamicBatcher rejects at data size
# 4, and two ladders it accepts
_BATCHER_CASES = [(30, None), (30, "auto"), (64, [16, 30]), (64, [6]),
                  (16, [32]), (64, "auto"), (36, "auto"), (36, [8, 20])]


@pytest.mark.parametrize("max_batch,buckets", _BATCHER_CASES)
def test_batcher_data_axis_checks_match_jax(max_batch, buckets):
    from deephumor_tpu.serving import DynamicBatcher as JaxBatcher

    def build(cls):
        try:
            srv = cls(_StubPipeline(), max_batch=max_batch, buckets=buckets)
        except ValueError as e:
            return str(e)
        srv.close()
        return srv.buckets

    want = build(JaxBatcher)
    assert build(DynamicBatcher) == want
    if isinstance(want, tuple):
        assert all(b % 4 == 0 for b in want)


def test_make_mesh_size_error():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"mesh 3x2 != 1 devices"):
        make_mesh("cpu", data=3, model=2)
    assert not dist.is_initialized()
