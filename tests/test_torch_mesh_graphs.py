"""The mesh programs of deephumor_tpu_torch as their CUDA graphs run them,
on the CPU: two gloo ranks started as spawn processes over a FileStore,
f32, at small widths. Gloo collectives cannot be captured, so the ranks
drive the captured forms' bodies and decisions, not graphs:

- the cache decisions of captured generation (models/graphs.py
  ``_admit``) when the two ranks measure different bytes: the keys that
  hold collectives are kept and evicted alike on both;
- the tensor-parallel decode body on a data 1 x model 2 mesh, as the
  graphs run it (``graphs.run_captured``: each segment and boundary to
  its end), word and char (compaction and canon): equal to the eager
  loop, no host read inside a step or a boundary, and greedy
  token-equal to the JAX package's tensor-parallel run on the same
  weights;
- a mesh trainer over two epochs: one dropout generator, reseeded, so
  that its step keys match; the draws as a generator made anew each
  epoch draws them; the losses of the JAX package's mesh run;
- the graph key with and without a model group;
- ``compiled=True`` over gloo: ``ValueError`` before any step or draw,
  for the trainer and for ``tp_generate``.

Each spawn has its own time limit (``SPAWN_TIMEOUT_S``) and kills its
ranks when it runs out. The workers import torch and the port only.
"""

import collections
import os
import time
import traceback
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deephumor_tpu_torch.convert.jax_params import params_to_jax
from deephumor_tpu_torch.experiments.trainer import Trainer
from deephumor_tpu_torch.models import CaptioningTransformer, graphs
from deephumor_tpu_torch.models import sampling as TS
from deephumor_tpu_torch.parallel import (make_mesh, make_param_shardings,
                                          replicate)
from deephumor_tpu_torch.parallel.mesh import shard_generator
from deephumor_tpu_torch.parallel.sharding import local_tree
from deephumor_tpu_torch.utils import collectives

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

SPAWN_TIMEOUT_S = 180
WORLD = 2
# tests/test_torch_parallel.py's tolerance against the JAX package's mesh
# run (LOSS_RTOL)
JAX_LOSS_RTOL = 1e-5
# tests/test_torch_tp.py's cases: the JAX package's TP generation test
# configuration, and char through compaction and canon
WORD_HP = dict(num_tokens=24, hid_dim=32, n_layers=2, n_heads=4, pf_dim=64,
               max_len=16)
CHAR_HP = dict(num_tokens=64, hid_dim=32, n_layers=2, n_heads=4, pf_dim=64,
               max_len=48)
DECODE = {"word": (WORD_HP, None, dict(max_len=8, beam_size=3, top_k=8)),
          "char": (CHAR_HP, 0.2, dict(max_len=40, beam_size=4, top_k=8,
                                      compact=True))}
TRAIN_HP = dict(num_tokens=48, hid_dim=32, n_layers=2, n_heads=4, pf_dim=48,
                max_len=50)
NO_DROPOUT = dict(enc_dropout=0.0, dec_dropout=0.0)


# -- inputs, the same in every process --------------------------------------
def _decode_case(name):
    hp, eos_bias, kw = DECODE[name]
    model = CaptioningTransformer(**hp)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    if eos_bias is not None:
        params["decoder"]["classifier"]["bias"][3] = eos_bias
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(8, 32)).astype(np.float32)
    spa = rng.normal(size=(8, 49, 32)).astype(np.float32)
    if name == "char":  # items at several scales end at different steps
        scale = np.linspace(0.3, 2.0, 8, dtype=np.float32)[:, None]
        emb, spa = emb * scale, spa * scale[:, :, None]
    return model, params, (torch.from_numpy(emb), torch.from_numpy(spa)), kw


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


def _trainer(model, tmp, title, **kw):
    trunk, _ = _train_data()
    trainer = Trainer(model, title, log_dir=tmp, device="cpu", prefetch=0,
                      log_flush_every=1, **kw)
    trainer._trunk_cache = torch.from_numpy(trunk)
    return trainer


def _train_params(dropout):
    model = CaptioningTransformer(**TRAIN_HP, **({} if dropout
                                                 else NO_DROPOUT))
    return model, model.init(torch.Generator().manual_seed(5), device="cpu")


# -- the ranks ---------------------------------------------------------------
def _evictions(rank):
    """Keys admitted one by one into the generation cache, every other one
    with collectives, each rank measuring its own bytes (rank 1 twice
    rank 0's) against one budget: after each admission, the keys held
    with collectives and those held without."""
    graphs.clear()
    budget, held = 10, []
    try:
        for i in range(2 * graphs.MAX_KEYS + 4):
            collective = i % 2 == 0
            entry = types.SimpleNamespace(bytes=(rank + 1) * (i % 5 + 1),
                                          collective=collective)
            graphs._admit(f"k{i}", entry, budget)
            with graphs._CACHE_LOCK:
                held.append((
                    [k for k, e in graphs._CACHE.items() if e.collective],
                    [k for k, e in graphs._CACHE.items()
                     if not e.collective]))
    finally:
        graphs.clear()
    return held


def _grab_program(model, params, enc, **kw):
    """The call's Program, inputs and key as generate_from_emb builds them
    (on the CPU the call then runs eagerly)."""
    made = {}
    real = graphs.generate

    def grab(make_program, inputs, gen, *, key, compiled=None):
        made.update(program=make_program(), inputs=inputs, key=key())
        return real(make_program, inputs, gen, key=key, compiled=compiled)

    graphs.generate = grab
    try:
        out = model.generate_from_emb(params, enc, **kw)
    finally:
        graphs.generate = real
    return made, out


def _guarded_reads():
    """Makes every host read of a tensor raise while the returned event is
    set; returns it and a function that puts the reads back."""
    import threading

    active, saved = threading.Event(), {}

    def guard(name, real):
        def run(self, *a, **k):
            if active.is_set():
                raise AssertionError(f"host read {name} inside the body")
            return real(self, *a, **k)
        return run

    for name in ("item", "tolist", "__bool__", "__int__"):
        saved[name] = getattr(torch.Tensor, name)
        setattr(torch.Tensor, name, guard(name, saved[name]))

    def restore():
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)

    return active, restore


def _decode(mesh):
    """Per case and sampling mode: the eager loop over the rank's local
    shards with the model group, and the same call's body run as its
    graphs run it from the same draws, no host read inside a step or a
    boundary."""
    group = mesh.get_group("model")
    out = {}
    for name in DECODE:
        model, params, enc, kw = _decode_case(name)
        local = local_tree(make_param_shardings(params, mesh))
        for mode, extra in (("greedy", dict(greedy=True)),
                            ("sampled", dict(sampler="pallas"))):
            call = dict(kw, model_group=group, temperature=1.1,
                        generator=torch.Generator().manual_seed(7), **extra)
            made, eager = _grab_program(model, local, enc, **call)
            program = made["program"]
            noise = TS.draw_noise(torch.Generator().manual_seed(7),
                                  program.noise, "cpu")
            active, restore = _guarded_reads()

            def body(fn, *args, **kwargs):
                active.set()
                try:
                    return fn(*args, **kwargs)
                finally:
                    active.clear()

            try:
                search = body(program.begin, made["inputs"], noise)
                ran = graphs.run_captured(
                    search,
                    lambda i: body(search.run_segment, i, eager=False),
                    lambda i: body(search.run_boundary, i, eager=False))
                captured = program.read_out(body(program.finish, search), ran)
            finally:
                restore()
            out[name, mode] = {
                "eager": {k: v for k, v in eager.items()},
                "captured": {k: v for k, v in captured.items()},
                "group_is_programs": program.group is group}
    return out


def _keys(mesh):
    """The graph keys of one decode call: over the model group, without a
    group and over the data axis's (one-rank) group."""
    model, params, enc, kw = _decode_case("word")
    local = local_tree(make_param_shardings(params, mesh))
    keys = [_grab_program(model, local, enc, model_group=g, **kw)[0]["key"]
            for g in (mesh.get_group("model"), None,
                      mesh.get_group("data"))]
    return {"distinct": len(set(keys)) == len(keys),
            "repeat": _grab_program(
                model, local, enc, model_group=mesh.get_group("model"),
                **kw)[0]["key"] == keys[0]}


def _epochs(mesh, tmp):
    """A mesh trainer over two epochs: each step's generator, its key
    (``Trainer._key``, as a captured step makes it) and loss; then the
    same two epochs with a generator derived anew for each (every step
    through ``_train_step``), at the captioner's default dropout. And the
    two epochs without dropout, for the JAX package's run."""
    _, batches = _train_data()
    group = mesh.get_group("data")
    out = {}
    for dropout in (True, False):
        model, params = _train_params(dropout)
        trainer = _trainer(model, os.path.join(tmp, f"e{dropout}"), "e")
        state = replicate(trainer.init_state(params=params), mesh)
        step, seen = trainer._train_step, []

        def recorded(st, batch, gen, *args, _trainer=trainer, _step=step,
                     _seen=seen):
            st, metrics = _step(st, batch, gen, *args)
            key = _trainer._key("train", st["params"], batch,
                                st["opt_state"], gen, (group, None))
            _seen.append((gen, key, float(metrics["loss"])))
            return st, metrics

        trainer._train_step = recorded
        gen = torch.Generator().manual_seed(1)
        losses = []
        for epoch in range(2):
            state, loss, _ = trainer.run_epoch(state, batches, gen,
                                               epoch=epoch, mesh=mesh)
            losses.append(loss)
        trainer.close()
        res = {"epoch_losses": losses,
               "step_losses": [x[2] for x in seen],
               "one_generator": all(x[0] is seen[0][0] for x in seen),
               "generators": len(trainer._shard_gens),
               "keys_match": seen[0][1] == seen[2][1]
               and seen[1][1] == seen[3][1] and seen[0][1] != seen[1][1]}
        if dropout:
            # a generator derived anew each epoch, as before
            from deephumor_tpu_torch.parallel import shard_batch

            trainer = _trainer(model, os.path.join(tmp, "fresh"), "f")
            state = replicate(trainer.init_state(params=params), mesh)
            gen, fresh = torch.Generator().manual_seed(1), []
            for _ in range(2):
                g = shard_generator(gen, mesh)
                for b in batches:
                    state, m = trainer._train_step(
                        state, shard_batch(trainer._host_batch(b)[0], mesh),
                        g, group)
                    fresh.append(float(m["loss"]))
            trainer.close()
            res["fresh_step_losses"] = fresh
        out["dropout" if dropout else "no_dropout"] = res
    return out


def _refused(tp_mesh, dp_mesh, tmp):
    """``compiled=True`` over gloo: the error and whether the count and
    the generator stayed as they were, for a trainer on the data axis and
    for tp_generate; and compiled=None over gloo runs eagerly."""
    _, batches = _train_data()
    out = {}
    model, params = _train_params(True)
    trainer = _trainer(model, tmp, "r", compiled=True)
    state = replicate(trainer.init_state(params=params), dp_mesh)
    gen = torch.Generator().manual_seed(1)
    drawn = gen.get_state()
    try:
        trainer.run_epoch(state, batches, gen, mesh=dp_mesh)
    except ValueError as e:
        out["trainer"] = (str(e), state["opt_state"]["count"],
                          torch.equal(gen.get_state(), drawn))
    trainer.close()
    model, params, enc, kw = _decode_case("word")
    tp = make_param_shardings(params, tp_mesh)
    gen = torch.Generator().manual_seed(1)
    drawn = gen.get_state()
    try:
        model.generate_from_emb(tp, enc, generator=gen, compiled=True, **kw)
    except ValueError as e:
        out["tp_generate"] = (str(e), 0, torch.equal(gen.get_state(), drawn))
    eager = model.generate_from_emb(tp, enc, greedy=True, **kw)
    plain = model.generate_from_emb(params, enc, greedy=True, **kw)
    out["eager_equal"] = torch.equal(eager["chosen"], plain["chosen"])
    return out


def _counts():
    """An all-reduce of a CPU tensor inside a capture tally runs now: it
    counts in COUNTS, not in the tally; a tally adds at each replay."""
    before = collections.Counter(collectives.COUNTS)
    x = torch.ones(3)
    with collectives.capture_tally() as tally:
        collectives.all_reduce(x, dist.group.WORLD)
    key = ("cpu", 3, "gloo")
    counted = (collectives.COUNTS - before)[key]
    for _ in range(3):
        collectives.add(collections.Counter({key: 2}))
    return {"sum": x.tolist(), "tally": dict(tally), "counted": counted,
            "after_adds": (collectives.COUNTS - before)[key]}


def _rank(rank, outdir):
    tp_mesh = make_mesh("cpu", model=WORLD)
    dp_mesh = make_mesh("cpu")
    return {"evictions": _evictions(rank), "decode": _decode(tp_mesh),
            "keys": _keys(tp_mesh),
            "epochs": _epochs(dp_mesh, os.path.join(outdir, f"t{rank}")),
            "refused": _refused(tp_mesh, dp_mesh,
                                os.path.join(outdir, f"r{rank}")),
            "counts": _counts()}


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
def ranks(tmp_path_factory):
    return _spawn("_rank", tmp_path_factory.mktemp("mesh_graphs"))


# -- decisions ---------------------------------------------------------------
def test_eviction_decisions_agree_across_ranks(ranks):
    a, b = (r["evictions"] for r in ranks)
    # the keys with collectives: the same on both ranks after every
    # admission, the last MAX_KEYS of them
    assert [x[0] for x in a] == [x[0] for x in b]
    assert a[-1][0] == [f"k{i}" for i in range(2 * graphs.MAX_KEYS + 4)
                        if i % 2 == 0][-graphs.MAX_KEYS:]
    # the bytes did differ: the ranks kept other keys without collectives
    assert [x[1] for x in a] != [x[1] for x in b]


def test_graph_key_holds_the_model_group(ranks):
    for rank in ranks:
        assert rank["keys"] == {"distinct": True, "repeat": True}


# -- the TP decode body ------------------------------------------------------
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("name", list(DECODE))
def test_tp_decode_body_equals_the_eager_loop(ranks, name, mode):
    for rank in ranks:
        got = rank["decode"][name, mode]
        assert got["group_is_programs"]
        for key in ("sequences", "scores", "chosen", "ended"):
            assert torch.equal(got["captured"][key], got["eager"][key]), key
        assert got["captured"]["boundaries"] == got["eager"]["boundaries"]
    # both ranks of the model group drew alike
    a, b = (r["decode"][name, mode]["captured"] for r in ranks)
    assert torch.equal(a["chosen"], b["chosen"])
    if name == "char" and mode == "greedy":
        # a compaction that retired items, then canon
        marks = a["boundaries"]
        assert any(m["live"] is not None and m["live"] < 8 for m in marks)
        assert any(m["stragglers"] is not None for m in marks)


@pytest.fixture(scope="module")
def jax_tp_greedy():
    """The JAX package's greedy run of each case over TP-sharded weights on
    a data 1 x model 2 mesh (``attn="xla"``, as its own TP test). Its
    compaction and canon take a Pallas attention, which does not
    partition, so char runs there without them: they change no token."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from deephumor_tpu.models import CaptioningTransformer as JaxModel
    from deephumor_tpu.parallel import make_mesh as jax_mesh
    from deephumor_tpu.parallel.sharding import (
        make_param_shardings as jax_shardings)

    mesh = jax_mesh(devices=jax.devices()[:WORLD], model=WORLD)
    data = NamedSharding(mesh, P("data"))
    out = {}
    for name in DECODE:
        model, params, enc, kw = _decode_case(name)
        jp = jax.tree.map(jnp.asarray, params_to_jax(params))
        jp = jax.device_put(jp, jax_shardings(jp, mesh))
        jenc = tuple(jax.device_put(jnp.asarray(x.numpy()), data)
                     for x in enc)
        kw = dict(kw, compact=False, canon=False)
        out[name] = np.asarray(JaxModel(**DECODE[name][0]).generate_from_emb(
            jp, jenc, greedy=True, attn="xla", **kw)["chosen"])
    return out


@pytest.mark.parametrize("name", list(DECODE))
def test_tp_decode_body_greedy_equals_jax(ranks, jax_tp_greedy, name):
    for rank in ranks:
        np.testing.assert_array_equal(
            rank["decode"][name, "greedy"]["captured"]["chosen"].numpy(),
            jax_tp_greedy[name])


# -- the mesh trainer --------------------------------------------------------
def test_mesh_trainer_keeps_one_generator_and_its_keys(ranks):
    for rank in ranks:
        for res in rank["epochs"].values():
            assert res["one_generator"] and res["generators"] == 1
            # epoch 2's full and tail steps have epoch 1's keys
            assert res["keys_match"]


def test_mesh_trainer_draws_as_a_new_generator_would(ranks):
    for rank in ranks:
        res = rank["epochs"]["dropout"]
        assert res["step_losses"] == res["fresh_step_losses"]
    # and dropout does draw: the two epochs of one batch differ
    a = ranks[0]["epochs"]["dropout"]["step_losses"]
    assert a[0] != a[2]


def test_mesh_trainer_two_epochs_match_jax_mesh_run(ranks, tmp_path):
    import jax
    import jax.numpy as jnp

    from deephumor_tpu.experiments.trainer import Trainer as JaxTrainer
    from deephumor_tpu.models import CaptioningTransformer as JaxModel
    from deephumor_tpu.parallel import make_mesh as jax_mesh
    from deephumor_tpu.parallel import replicate as jax_replicate

    trunk, batches = _train_data()
    _, params = _train_params(False)
    jt = JaxTrainer(JaxModel(**TRAIN_HP, **NO_DROPOUT), "j",
                    log_dir=str(tmp_path))
    mesh = jax_mesh(devices=jax.devices()[:WORLD])
    js = jt.init_state(jax.random.PRNGKey(0),
                       params=jax.tree.map(jnp.asarray, params_to_jax(params)))
    jt._trunk_cache = jnp.asarray(trunk)
    js = {"params": jax_replicate(js["params"], mesh),
          "opt_state": jax_replicate(js["opt_state"], mesh),
          "step": js["step"]}
    losses = []
    for epoch in range(2):
        js, loss, _ = jt.run_epoch(js, batches, jax.random.PRNGKey(epoch + 1),
                                   "train", epoch, mesh=mesh)
        losses.append(loss)
    jt.close()
    for rank in ranks:
        np.testing.assert_allclose(rank["epochs"]["no_dropout"][
            "epoch_losses"], losses, rtol=JAX_LOSS_RTOL)


# -- gloo --------------------------------------------------------------------
@pytest.mark.parametrize("entry", ["trainer", "tp_generate"])
def test_compiled_true_over_gloo_raises_before_any_work(ranks, entry):
    for rank in ranks:
        message, count, undrawn = rank["refused"][entry]
        assert "gloo group runs eagerly" in message
        assert count == 0 and undrawn


def test_compiled_none_over_gloo_runs_eagerly(ranks):
    for rank in ranks:
        assert rank["refused"]["eager_equal"]


def test_all_reduce_counts(ranks):
    for rank in ranks:
        assert rank["counts"] == {"sum": [2.0, 2.0, 2.0], "tally": {},
                                  "counted": 1, "after_adds": 7}

