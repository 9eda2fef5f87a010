"""Tensor parallelism in deephumor_tpu_torch on the CPU: gloo ranks started
as spawn processes over a FileStore, on a data 1 x model 2 mesh (2 ranks)
and a data 2 x model 2 mesh (4 ranks), held to the port's single-process
runs and to the JAX package's runs on the same weights.

- ``tp_generate`` (through ``generate_from_emb`` on a
  ``make_param_shardings`` tree) greedy for the word transformer, the
  decoder-only transformer, char with compaction and canon, and both
  LSTMs; the word model also against the JAX package (its TP-sharded run
  with ``attn="xla"``, its plain run with ``"pallas_interpret"``);
  sampled calls repeatable and equal across the ranks of a model group,
  and the check that refuses ranks whose draws differ;
- the DP x TP train step (``Trainer.run_epoch`` over a
  ``place_train_state`` state): losses, gradient norms and the gathered
  parameters against one process and the JAX package's mesh run;
- a DP x TP checkpoint saved mid-run and resumed on the same layout, on
  data 1 x model 2 and on no mesh, and read by the JAX package.

Each spawn has its own time limit (``SPAWN_TIMEOUT_S``) and kills its
ranks when it runs out. The workers import torch and the port only.
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
from deephumor_tpu_torch.experiments.trainer import Trainer
from deephumor_tpu_torch.models import (CaptioningLSTM,
                                        CaptioningLSTMWithLabels,
                                        CaptioningTransformer,
                                        CaptioningTransformerBase)
from deephumor_tpu_torch.parallel import (make_mesh, make_param_shardings,
                                          place_train_state, replicate)
from deephumor_tpu_torch.parallel import mesh as mesh_mod
from deephumor_tpu_torch.parallel.sharding import gather_tree
from deephumor_tpu_torch.utils.pytree import flatten_tree

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

SPAWN_TIMEOUT_S = 120
MODEL = 2  # the model axis in both layouts
# tests/test_parallel.py's tolerances: one process (rtol 1e-5), the JAX
# package's mesh run (1e-4), parameters (2e-4), a resumed trajectory (2e-5)
LOSS_RTOL, JAX_RTOL, PARAM_ATOL, RESUME_RTOL = 1e-5, 1e-4, 2e-4, 2e-5
# a bias added to every key leaves each softmax as it is: its gradient is
# rounding noise that Adam turns into steps of up to lr (as
# tests/test_torch_parallel.py, its values are not compared)
ZERO_GRAD_SUFFIX = "fc_k/bias"
# the JAX package's TP generation test (tests/test_parallel.py:241-262)
WORD_HP = dict(num_tokens=24, hid_dim=32, n_layers=2, n_heads=4, pf_dim=64,
               max_len=16)
WORD_KW = dict(max_len=8, beam_size=3, top_k=8)
TRAIN_HP = dict(num_tokens=48, hid_dim=32, n_layers=2, n_heads=4, pf_dim=48,
                max_len=50, enc_dropout=0.0, dec_dropout=0.0)
# tests/test_parallel.py:266-322's resume model
RESUME_HP = dict(num_tokens=24, hid_dim=16, n_layers=1, n_heads=4,
                 pf_dim=24, max_len=16, enc_dropout=0.0, dec_dropout=0.0)
GEN_NAMES = ["word", "word_switches", "base", "char", "char_stragglers",
             "lstm", "lstm_labels"]
# the two kernel-selecting switches: K9 over 4 items a block (2 local heads
# x beam 4 rows, a multiple of 8 at model 2) and K10
SWITCHES = {"DH_CROSS_PACK": "4", "DH_FUSED_SURVIVOR": "1"}
# char's EOS biases: items retire at the first compaction (p_eff 24) in
# every data shard; or none retires and a canon boundary leaves
# stragglers (K6's path) in every shard
CHAR_EOS = {"char": 0.2, "char_stragglers": 0.0}


# -- inputs, the same in every process --------------------------------------
def _gen_cases():
    """{name: (model, params, enc, kwargs)} of the greedy cases."""
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    emb, spa = t(8, 32), t(8, 49, 32)
    scale = torch.linspace(0.3, 2.0, 8)[:, None]
    lstm_emb = t(8, 8)
    char = CaptioningTransformer(num_tokens=64, hid_dim=32, n_layers=2,
                                 n_heads=4, pf_dim=64, max_len=48)
    lstm_hp = dict(num_tokens=24, emb_dim=8, hidden_size=12, num_layers=1)
    cases = {
        "word": (CaptioningTransformer(**WORD_HP), (emb, spa), WORD_KW),
        "word_switches": (CaptioningTransformer(**WORD_HP), (emb, spa),
                          dict(WORD_KW, beam_size=4)),
        "base": (CaptioningTransformerBase(**WORD_HP), emb, WORD_KW),
        # items at several feature scales end at different steps
        **{name: (char, (emb * scale, spa * scale[:, :, None]),
                  dict(max_len=40, beam_size=4, top_k=8, compact=True))
           for name in CHAR_EOS},
        "lstm": (CaptioningLSTM(**lstm_hp), lstm_emb, WORD_KW),
        "lstm_labels": (CaptioningLSTMWithLabels(**lstm_hp), lstm_emb,
                        WORD_KW),
    }
    out = {}
    for name, (model, enc, kw) in cases.items():
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        if name in CHAR_EOS:
            params["decoder"]["classifier"]["bias"][3] = CHAR_EOS[name]
        out[name] = (model, params, enc, kw)
    return out


def _train_data():
    """A trunk cache and two global batches of 8: ragged captions and a
    padded tail batch (5 real rows)."""
    rng = np.random.default_rng(11)
    trunk = rng.normal(size=(6, 7, 7, 2048)).astype(np.float32)
    batches = []
    for tail in (False, True):
        caps = rng.integers(6, TRAIN_HP["num_tokens"], (8, 12)).astype(
            np.int32)
        caps[:, -1] = 3
        caps[0, 4:] = 0
        caps[5, 9:] = 0
        batch = {"captions": caps,
                 "image_rows": rng.integers(0, 6, (8,)).astype(np.int32)}
        if tail:
            batch["row_valid"] = np.arange(8) < 5
        batches.append(batch)
    return trunk, batches


def _resume_data():
    """A trunk cache and four batches of 8 captions [8, 7]."""
    rng = np.random.default_rng(0)
    trunk = rng.normal(size=(4, 7, 7, 2048)).astype(np.float32)
    batches = []
    for _ in range(4):
        caps = rng.integers(6, RESUME_HP["num_tokens"], (8, 7)).astype(
            np.int32)
        caps[:, -1] = 3
        batches.append({"captions": caps, "image_rows": rng.integers(
            0, 4, (8,)).astype(np.int32)})
    return trunk, batches


def _generate_case(name, model, params, enc, kw, **extra):
    """``generate_from_emb`` of one case, with the switches set for
    "word_switches" (and unset after)."""
    env = SWITCHES if name == "word_switches" else {}
    old = {k: os.environ.get(k) for k in SWITCHES}
    os.environ.update(env)
    try:
        return model.generate_from_emb(params, enc, **kw, **extra)
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _images():
    return torch.from_numpy(np.random.default_rng(8).normal(
        size=(8, 32, 32, 3)).astype(np.float32))


def _np_tree(params):
    return {k: v.detach().numpy().copy()
            for k, v in flatten_tree(params).items()}


def _trainer(model, trunk, tmp, title):
    trainer = Trainer(model, title, log_dir=tmp, device="cpu", prefetch=0,
                      log_flush_every=1)
    trainer._trunk_cache = torch.from_numpy(trunk)
    return trainer


def _recording(trainer):
    """Records each train step's loss and pre-clip gradient norm."""
    step, seen = trainer._train_step, []

    def recorded(*args):
        state, metrics = step(*args)
        seen.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        return state, metrics

    trainer._train_step = recorded
    return seen


def _steps(trainer, state, batches, mesh):
    """One ``run_epoch`` per batch: the state and each step's loss."""
    losses = []
    for b in batches:
        state, loss, _ = trainer.run_epoch(state, [b],
                                           torch.Generator().manual_seed(1),
                                           mesh=mesh)
        losses.append(loss)
    return state, losses


# -- the ranks ---------------------------------------------------------------
def _generate(mesh):
    """Greedy outputs of every case (through generate_from_emb on a placed
    tree), the cache widths, the switched kernels' twin calls, sampled
    calls and the refused disagreement."""
    from deephumor_tpu_torch.models import transformer as tfm
    from deephumor_tpu_torch.ops import attention as A
    from deephumor_tpu_torch.ops import engine as E

    calls, widths = [], []
    twins = {"cross_attention_packed_plain": 0,
             "fused_survivor_update_plain": 0}
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (A, "cross_attention_packed_plain"),
        (E, "fused_survivor_update_plain"))]
    for mod, name, fn in saved:
        def counting(*args, _fn=fn, _name=name, **kwargs):
            twins[_name] += 1
            return _fn(*args, **kwargs)

        setattr(mod, name, counting)
    tp_generate, init_cache = mesh_mod.tp_generate, tfm.init_cache

    def counted(*args, **kwargs):
        calls.append(1)
        return tp_generate(*args, **kwargs)

    def recorded_cache(params, *args, **kwargs):
        cache = init_cache(params, *args, **kwargs)
        widths.append(cache[0]["k"].shape[-1])
        return cache

    mesh_mod.tp_generate, tfm.init_cache = counted, recorded_cache
    out = {}
    try:
        for name, (model, params, enc, kw) in _gen_cases().items():
            got = _generate_case(name, model, make_param_shardings(
                params, mesh), enc, kw, greedy=True)
            out[name] = {k: v.numpy() for k, v in got.items()
                         if isinstance(v, torch.Tensor)}
            out[name]["boundaries"] = got.get("boundaries")
    finally:
        mesh_mod.tp_generate, tfm.init_cache = tp_generate, init_cache
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    out["tp_generate_calls"] = len(calls)
    out["switched_twins"] = twins
    # the JAX package's call: placed parameters and a data-sharded enc
    from torch.distributed.tensor import DTensor

    from deephumor_tpu_torch.parallel import data_sharding, shard_batch

    model, params, enc, kw = _gen_cases()["word"]
    rows = shard_batch(enc, mesh)
    out["dtensor_enc"] = model.generate_from_emb(
        make_param_shardings(params, mesh), tuple(
            DTensor.from_local(x, mesh, data_sharding(mesh, x.ndim))
            for x in rows), greedy=True, **kw)["chosen"].numpy()
    # generate from images: the replicated encoder, then tp_generate
    out["from_images"] = model.generate(
        make_param_shardings(params, mesh), _images(), greedy=True,
        **kw)["chosen"].numpy()
    out["cache_widths"] = widths
    sampled = {}
    for name in ("word", "char"):
        model, params, enc, kw = _gen_cases()[name]
        tp = make_param_shardings(params, mesh)
        sampled[name] = [model.generate_from_emb(
            tp, enc, generator=torch.Generator().manual_seed(3),
            sampler="pallas", **kw)["chosen"].numpy() for _ in range(2)]
    out["sampled"] = sampled
    # a generator seeded per rank: the ranks of a model group draw apart
    model, params, enc, kw = _gen_cases()["word"]
    try:
        model.generate_from_emb(
            make_param_shardings(params, mesh), enc, generator=torch.Generator(
            ).manual_seed(dist.get_rank()), **kw)
    except RuntimeError as e:
        out["disagreement"] = str(e)
    return out


def _train(mesh, tmp):
    trunk, batches = _train_data()
    model = CaptioningTransformer(**TRAIN_HP)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    trainer = _trainer(model, trunk, tmp, "tp")
    state = place_train_state(trainer.init_state(params=params), mesh)
    seen = _recording(trainer)
    state, loss, pp = trainer.run_epoch(state, batches,
                                        torch.Generator().manual_seed(1),
                                        mesh=mesh)
    trainer.close()
    flat = flatten_tree(state["params"])
    mu = state["opt_state"]["mu"]
    placements = {k: (str(flat[k].placements), str(mu[k].placements))
                  for k in mu}
    return {"loss": loss, "pp": pp, "steps": seen,
            "params": _np_tree(gather_tree(state["params"])),
            "local_fc_q": tuple(flat["decoder/layers/0/self_attn/fc_q/"
                                     "weight"].to_local().shape),
            "placements": placements}


def _train_dropout(mesh, tmp):
    """Two DP x TP steps at the captioner's default dropout, and the same
    steps over the state replicated on the mesh (each rank steps its data
    block with whole weights, as one card): each step's loss and gradient
    norm."""
    trunk, batches = _train_data()
    model = CaptioningTransformer(**dict(TRAIN_HP, enc_dropout=0.3,
                                         dec_dropout=0.1))
    out = {}
    for name, place in (("tp", place_train_state), ("replicated", replicate)):
        params = model.init(torch.Generator().manual_seed(5), device="cpu")
        trainer = _trainer(model, trunk, os.path.join(tmp, name), name)
        out[name] = _recording(trainer)
        trainer.run_epoch(place(trainer.init_state(params=params), mesh),
                          batches, torch.Generator().manual_seed(1),
                          mesh=mesh)
        trainer.close()
    return out


def _resume_steps(mesh, path, tmp):
    trunk, batches = _resume_data()
    trainer = _trainer(CaptioningTransformerBase(**RESUME_HP), trunk, tmp,
                       "resume")
    state = place_train_state(trainer.restore_checkpoint(path), mesh)
    state, losses = _steps(trainer, state, batches[2:], mesh)
    trainer.close()
    return {"step": state["step"], "losses": losses}


def _rank_4(rank, tmp, _):
    mesh = make_mesh("cpu", model=MODEL)
    out = {"generate": _generate(mesh),
           "train": _train(mesh, os.path.join(tmp, f"train{rank}")),
           "dropout": _train_dropout(mesh, os.path.join(tmp, f"drop{rank}"))}
    # two steps on data 2 x model 2, the state saved, then resumed
    trunk, batches = _resume_data()
    model = CaptioningTransformerBase(**RESUME_HP)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    trainer = _trainer(model, trunk, os.path.join(tmp, f"save{rank}"), "s")
    state = place_train_state(trainer.init_state(params=params), mesh)
    state, out["saved_losses"] = _steps(trainer, state, batches[:2], mesh)
    path = os.path.join(tmp, "ck")
    trainer.save_checkpoint(state, path)
    trainer.close()
    dist.barrier()
    if rank == 0:  # the 2-rank spawn, running beside, waits for it
        open(path + ".done", "w").close()
    out["checkpoint"] = path
    out["resume"] = _resume_steps(mesh, path, os.path.join(tmp, f"r{rank}"))
    return out


def _rank_2(rank, tmp, checkpoint):
    mesh = make_mesh("cpu", model=MODEL)
    out = {"generate": _generate(mesh),
           "train": _train(mesh, os.path.join(tmp, f"train{rank}")),
           "dropout": _train_dropout(mesh, os.path.join(tmp, f"drop{rank}"))}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not os.path.exists(checkpoint + ".done"):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint at {checkpoint}")
        time.sleep(0.2)
    out["resume"] = _resume_steps(mesh, checkpoint,
                                  os.path.join(tmp, f"r{rank}"))
    # Trainer.train over a placed state: every rank gathers, rank 0 saves
    trunk, batches = _resume_data()
    trainer = _trainer(CaptioningTransformerBase(**RESUME_HP), trunk,
                       os.path.join(tmp, "fit"), "fit")
    state = place_train_state(trainer.restore_checkpoint(checkpoint), mesh)
    trainer.train(state, {"train": batches[2:], "val": batches[:1]},
                  n_epochs=1, gen=torch.Generator().manual_seed(1),
                  mesh=mesh)
    trainer.close()
    dist.barrier()  # rank 0 has written
    out["fit_files"] = sorted(os.listdir(trainer.experiment_dir))
    return out


def _rank_main(target, rank, world, store, outdir, arg):
    """One gloo rank: runs ``target(rank, outdir, arg)`` and saves its
    result (or its traceback) in ``outdir``."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        result = globals()[target](rank, outdir, arg)
        torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _start(target, world, tmp_path, arg=None):
    """Starts ``target`` on ``world`` gloo ranks; returns the spawn."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, store, str(tmp_path), arg))
             for r in range(world)]
    for p in procs:
        p.start()
    return target, procs, tmp_path


def _join(spawn, timeout=SPAWN_TIMEOUT_S):
    """The results of a spawn's ranks. Kills every rank still running
    after ``timeout`` seconds."""
    target, procs, tmp_path = spawn
    world = len(procs)
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(tmp_path / f"rank{r}.err") for r in range(world)]
    errors = [e.read_text() for e in errors if e.exists()]
    if hung or errors or any(p.exitcode for p in procs):
        pytest.fail(f"{target}: ranks {hung} still running after {timeout} "
                    f"s; exit codes {[p.exitcode for p in procs]}\n"
                    + "\n".join(errors))
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawns at once: 4 ranks (data 2 x model 2), which save the
    resume checkpoint mid-run, and 2 ranks (data 1 x model 2), which
    resume it once it is written."""
    tmp4 = tmp_path_factory.mktemp("tp4")
    four = _start("_rank_4", 4, tmp4)
    two = _start("_rank_2", 2, tmp_path_factory.mktemp("tp2"),
                 str(tmp4 / "ck"))
    try:
        return {4: _join(four), 2: _join(two)}
    finally:
        for _, procs, _ in (four, two):
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


@pytest.fixture(scope="module")
def ranks4(spawned):
    return spawned[4]


@pytest.fixture(scope="module")
def ranks2(spawned):
    return spawned[2]


@pytest.fixture(params=[2, 4], ids=["data1xmodel2", "data2xmodel2"])
def ranks(request, ranks2, ranks4):
    return {2: ranks2, 4: ranks4}[request.param]


# -- tp_generate -------------------------------------------------------------
@pytest.fixture(scope="module")
def single_generate():
    return {name: _generate_case(name, model, params, enc, kw, greedy=True)
            for name, (model, params, enc, kw) in _gen_cases().items()}


@pytest.mark.parametrize("name", GEN_NAMES)
def test_tp_generate_greedy_equals_single_process(ranks, single_generate,
                                                  name):
    want = single_generate[name]
    for rank in ranks:
        got = rank["generate"][name]
        for key in ("sequences", "chosen", "ended"):
            np.testing.assert_array_equal(got[key], want[key].numpy(),
                                          err_msg=key)
        np.testing.assert_allclose(got["scores"], want["scores"].numpy(),
                                   atol=1e-5)
    if name in CHAR_EOS:
        # per data shard: a compaction that retired items, then canon; or
        # a canon boundary with stragglers
        for shard in ranks[0]["generate"][name]["boundaries"]:
            if name == "char":
                assert any(b["live"] is not None and b["live"] < 8 // (
                    len(ranks) // MODEL) for b in shard), shard
                assert any(b["stragglers"] is not None for b in shard), shard
            else:
                assert any(b["stragglers"] for b in shard), shard


def test_generate_from_emb_on_placed_tree_runs_tp_generate(ranks):
    """One tp_generate per case; the transformers' caches hold the rank's
    heads: D / model wide."""
    for rank in ranks:
        gen = rank["generate"]
        assert gen["tp_generate_calls"] == len(GEN_NAMES)
        # the five transformer cases (hid 32): one cache each
        assert gen["cache_widths"] == [32 // MODEL] * 5
        # word_switches ran K9 (decode layer-steps) and K10 (steps)
        assert all(gen["switched_twins"].values()), gen["switched_twins"]


@pytest.mark.parametrize("attn", ["xla", "pallas_interpret"])
def test_tp_generate_greedy_equals_jax(ranks2, ranks4, attn):
    """The word model on the JAX package's TP test configuration: its run
    over TP-sharded weights on a data 4 x model 2 mesh (``attn="xla"``, as
    its own test) and its unsharded run through the Pallas kernels in
    interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from deephumor_tpu.models import CaptioningTransformer as JaxModel
    from deephumor_tpu.parallel import make_mesh as jax_mesh
    from deephumor_tpu.parallel.sharding import (
        make_param_shardings as jax_shardings)

    model, params, (emb, spa), kw = _gen_cases()["word"]
    jm = JaxModel(**WORD_HP)
    jp = jax.tree.map(jnp.asarray, params_to_jax(params))
    enc = (jnp.asarray(emb.numpy()), jnp.asarray(spa.numpy()))
    if attn == "xla":
        mesh = jax_mesh(model=MODEL)
        jp = jax.device_put(jp, jax_shardings(jp, mesh))
        data = NamedSharding(mesh, P("data"))
        enc = tuple(jax.device_put(x, data) for x in enc)
    want = np.asarray(jm.generate_from_emb(jp, enc, greedy=True, attn=attn,
                                           **kw)["chosen"])
    for rank in ranks2 + ranks4:
        np.testing.assert_array_equal(rank["generate"]["word"]["chosen"],
                                      want)


def test_tp_generate_takes_data_sharded_dtensor_inputs(ranks,
                                                      single_generate):
    want = single_generate["word"]["chosen"].numpy()
    for rank in ranks:
        np.testing.assert_array_equal(rank["generate"]["dtensor_enc"], want)


def test_tp_generate_from_images(ranks):
    model, params, _, kw = _gen_cases()["word"]
    want = model.generate(params, _images(), greedy=True, **kw)["chosen"]
    for rank in ranks:
        np.testing.assert_array_equal(rank["generate"]["from_images"],
                                      want.numpy())


def test_tp_generate_sampled_is_repeatable_and_equal_across_ranks(ranks):
    for name in ("word", "char"):
        one, two = ranks[0]["generate"]["sampled"][name]
        np.testing.assert_array_equal(one, two)
        for rank in ranks[1:]:
            np.testing.assert_array_equal(rank["generate"]["sampled"][name][0],
                                          one)
        assert (one != 1).all()  # no UNK


def test_tp_generate_refuses_ranks_that_draw_apart(ranks):
    for rank in ranks:
        assert rank["generate"]["disagreement"] == (
            "tp_generate: the ranks of a model group chose different "
            "tokens; their draws must be equal")


# -- the DP x TP train step --------------------------------------------------
@pytest.fixture(scope="module")
def single_train(tmp_path_factory):
    trunk, batches = _train_data()
    model = CaptioningTransformer(**TRAIN_HP)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    trainer = _trainer(model, trunk, str(tmp_path_factory.mktemp("one")),
                       "one")
    seen = _recording(trainer)
    state, loss, pp = trainer.run_epoch(trainer.init_state(params=params),
                                        batches,
                                        torch.Generator().manual_seed(1))
    trainer.close()
    return {"loss": loss, "pp": pp, "steps": seen,
            "params": _np_tree(state["params"])}


def _assert_params_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if not k.endswith(ZERO_GRAD_SUFFIX):
            np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL,
                                       rtol=0, err_msg=k)


def test_tp_train_matches_single_process(ranks, single_train):
    """Losses, perplexity and each step's pre-clip gradient norm (the
    sharded leaves' squares summed over the model axis, the replicated
    leaves' once) as one process's."""
    for rank in ranks:
        tr = rank["train"]
        np.testing.assert_allclose([tr["loss"], tr["pp"]],
                                   [single_train["loss"], single_train["pp"]],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(tr["steps"], single_train["steps"],
                                   rtol=LOSS_RTOL)


def test_tp_train_params_match_single_process(ranks, single_train):
    a = ranks[0]["train"]["params"]
    for rank in ranks[1:]:
        for k in a:  # every rank gathers the same parameters
            np.testing.assert_array_equal(rank["train"]["params"][k], a[k],
                                          err_msg=k)
    _assert_params_close(a, single_train["params"])


def test_tp_train_dropout_draws_one_cards_masks(ranks):
    """At dropout 0.3 / 0.1 the ranks of a model group, which share their
    data block's generator, each keep their slice of one card's masks on
    the attention weights and the pf units: the steps' losses and gradient
    norms are those of the same steps over a replicated state."""
    for rank in ranks:
        d = rank["dropout"]
        np.testing.assert_allclose(d["tp"], d["replicated"], rtol=LOSS_RTOL)
        # the masks are on: the first loss is not the dropout-free one
        assert abs(d["tp"][0][0] - rank["train"]["steps"][0][0]) > 1e-3


def test_tp_train_places_moments_as_parameters(ranks):
    for rank in ranks:
        tr = rank["train"]
        assert tr["local_fc_q"] == (32 // MODEL, 32)
        for k, (param, moment) in tr["placements"].items():
            assert param == moment, k
        assert tr["placements"]["decoder/layers/0/pf/fc_2/weight"][0] == (
            "(Replicate(), Shard(dim=1))")


@pytest.fixture(scope="module")
def jax_tp_train(tmp_path_factory):
    """The JAX package's run of the same two steps over TP-sharded
    parameters on a data 2 x model 2 mesh."""
    import jax
    import jax.numpy as jnp

    from deephumor_tpu.experiments.trainer import Trainer as JaxTrainer
    from deephumor_tpu.models import CaptioningTransformer as JaxModel
    from deephumor_tpu.parallel import make_mesh as jax_mesh
    from deephumor_tpu.parallel import replicate as jax_replicate
    from deephumor_tpu.parallel.sharding import (
        make_param_shardings as jax_shardings)

    trunk, batches = _train_data()
    params = CaptioningTransformer(**TRAIN_HP).init(
        torch.Generator().manual_seed(5), device="cpu")
    jt = JaxTrainer(JaxModel(**TRAIN_HP), "j",
                    log_dir=str(tmp_path_factory.mktemp("jax")))
    mesh = jax_mesh(devices=jax.devices()[:4], model=MODEL)
    js = jt.init_state(jax.random.PRNGKey(0),
                       params=jax.tree.map(jnp.asarray, params_to_jax(params)))
    jt._trunk_cache = jnp.asarray(trunk)
    js = {"params": jax.device_put(js["params"],
                                   jax_shardings(js["params"], mesh)),
          "opt_state": jax_replicate(js["opt_state"], mesh),
          "step": js["step"]}
    js, loss, pp = jt.run_epoch(js, batches, jax.random.PRNGKey(1), "train",
                                1, mesh=mesh)
    jt.close()
    return {"loss": loss, "pp": pp, "params": _np_tree(params_from_jax(
        jax.device_get(js["params"])))}


def test_tp_train_matches_jax_mesh_run(ranks, jax_tp_train):
    tr = ranks[0]["train"]
    np.testing.assert_allclose([tr["loss"], tr["pp"]],
                               [jax_tp_train["loss"], jax_tp_train["pp"]],
                               rtol=JAX_RTOL)
    _assert_params_close(tr["params"], jax_tp_train["params"])


# -- layout-independent resume -----------------------------------------------
@pytest.fixture(scope="module")
def unsharded_resume(ranks4, tmp_path_factory):
    trunk, batches = _resume_data()
    trainer = _trainer(CaptioningTransformerBase(**RESUME_HP), trunk,
                       str(tmp_path_factory.mktemp("resume")), "u")
    state = trainer.restore_checkpoint(ranks4[0]["checkpoint"])
    assert state["step"] == 2
    _, losses = _steps(trainer, state, batches[2:], None)
    trainer.close()
    return losses


@pytest.mark.parametrize("layout", ["same_2x2", "data1xmodel2"])
def test_tp_resume_matches_unsharded(ranks2, ranks4, unsharded_resume,
                                     layout):
    """Saved mid-run from data 2 x model 2, resumed on the same layout and
    on data 1 x model 2: the continued losses are the unsharded resume's
    (tests/test_parallel.py:266-322)."""
    for rank in {"same_2x2": ranks4, "data1xmodel2": ranks2}[layout]:
        assert rank["resume"]["step"] == 4
        np.testing.assert_allclose(rank["resume"]["losses"],
                                   unsharded_resume, rtol=RESUME_RTOL)


def test_tp_trainer_train_saves_gathered_state_from_rank_0(ranks2):
    """``Trainer.train`` over a placed state: the best model and the epoch
    checkpoint gathered on every rank and written by rank 0 (both ranks
    share the directory)."""
    files = ranks2[0]["fit_files"]
    assert files == ranks2[1]["fit_files"]
    assert files == ["fit.best.json", "fit.best.npz", "fit.e1.state.json",
                     "fit.e1.state.npz", "train", "val"], files


def test_tp_checkpoint_resumes_on_no_mesh_as_one_process_ran(
        ranks4, unsharded_resume, tmp_path):
    """The unsharded resume continues the trajectory of one process that
    took all four steps, and the saved losses are that process's."""
    trunk, batches = _resume_data()
    model = CaptioningTransformerBase(**RESUME_HP)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    trainer = _trainer(model, trunk, str(tmp_path), "one")
    _, losses = _steps(trainer, trainer.init_state(params=params), batches,
                       None)
    trainer.close()
    np.testing.assert_allclose(ranks4[0]["saved_losses"], losses[:2],
                               rtol=RESUME_RTOL)
    np.testing.assert_allclose(unsharded_resume, losses[2:],
                               rtol=RESUME_RTOL)


def test_jax_package_reads_the_tp_checkpoint(ranks4, unsharded_resume,
                                             tmp_path):
    import jax
    import jax.numpy as jnp

    from deephumor_tpu.experiments.trainer import Trainer as JaxTrainer
    from deephumor_tpu.models import CaptioningTransformerBase as JaxBase

    trunk, batches = _resume_data()
    jt = JaxTrainer(JaxBase(**RESUME_HP), "j", log_dir=str(tmp_path))
    js = jt.restore_checkpoint(ranks4[0]["checkpoint"])
    assert int(js["step"]) == 2
    jt._trunk_cache = jnp.asarray(trunk)
    losses = []
    for b in batches[2:]:
        js, loss, _ = jt.run_epoch(js, [b], jax.random.PRNGKey(1), "train")
        losses.append(loss)
    jt.close()
    np.testing.assert_allclose(losses, unsharded_resume, rtol=JAX_RTOL)
