"""deephumor_tpu_torch's training as its captured steps run it, on the
CPU (where the steps always run eagerly), f32, at tiny widths: Adam with
its count terms in a device buffer against the JAX Trainer's steps and
against the step as it stood before the terms left the host; batch-norm
statistics written into the state's own tensors; the metrics ring of
``run_epoch``; the step keys (experiments/step_graphs.py); checkpoints
of either package resumed with the count terms; and ``generate`` from
images, whose encoder now runs inside the prefill."""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deephumor_tpu import models as JM
from deephumor_tpu.experiments.trainer import Trainer as JaxTrainer
from deephumor_tpu_torch import models as TM
from deephumor_tpu_torch.convert.jax_params import params_to_jax
from deephumor_tpu_torch.experiments.trainer import (Adam, Trainer,
                                                     _trainable_paths)
from deephumor_tpu_torch.utils.pytree import flatten_tree, tree_map

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

V = 48
TFM_HP = dict(num_tokens=V, hid_dim=32, n_layers=2, n_heads=4, pf_dim=48,
              max_len=50)
LSTM_HP = dict(num_tokens=V, emb_dim=16, hidden_size=16, num_layers=2)
NO_DROPOUT = dict(enc_dropout=0.0, dec_dropout=0.0)
OPTS = {
    "adam": {},
    "adamw_schedule_clipped": dict(weight_decay=0.01, clip_norm=0.5,
                                   schedule=lambda c: 1e-3 / (1 + c)),
}
ATOL_STEP = 2e-4  # a fifth of one Adam step at lr 1e-3
# one f32 rounding of the parameter, and of lr * update (|update| < 10)
EPS = float(torch.finfo(torch.float32).eps)
ROUND = dict(rtol=EPS, atol=EPS * 1e-2)


def _batches(seed=8, n=3, bs=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        caps = rng.integers(6, V, (bs, 12)).astype(np.int32)
        caps[2, 7:] = 0
        caps[5, 3:] = 0
        out.append({"captions": caps,
                    "image_rows": rng.integers(0, 4, (bs,)).astype(np.int32)})
    return out


TRUNK = np.random.default_rng(7).normal(size=(4, 7, 7, 2048)).astype(
    np.float32)
BATCHES = _batches()


def _params(model, seed=0):
    return model.init(torch.Generator().manual_seed(seed), device="cpu")


def _trainer(tmp_path, model, title="t", **kw):
    trainer = Trainer(model, title, log_dir=str(tmp_path), device="cpu",
                      **kw)
    trainer._trunk_cache = torch.from_numpy(TRUNK)
    return trainer


def _step(trainer, state, i):
    return trainer._train_step(state, trainer._host_batch(BATCHES[i])[0],
                               torch.Generator().manual_seed(i))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX Trainer's states and metrics over BATCHES, per optimizer,
    on the cross-attention model's weights (drawn by the port)."""
    runs = {}

    def get(opt):
        if opt not in runs:
            hp = {**TFM_HP, **NO_DROPOUT}
            tp = _params(TM.CaptioningTransformer(**hp))
            jp = jax.tree.map(jnp.asarray, params_to_jax(tp))
            jt = JaxTrainer(JM.CaptioningTransformer(**hp), "j",
                            log_dir=str(tmp_path_factory.mktemp(opt)),
                            **OPTS[opt])
            js = jt.init_state(jax.random.PRNGKey(0), params=jp)
            jt._trunk_cache = jnp.asarray(TRUNK)
            jt._build_steps()
            states, metrics = [js], []
            for i, batch in enumerate(BATCHES):
                js, m = jt._train_step(
                    js, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(i))
                states.append(js)
                metrics.append({k: float(v) for k, v in m.items()})
            runs[opt] = dict(jt=jt, tp=tp, states=states, metrics=metrics)
        return runs[opt]

    yield get
    for run in runs.values():
        run["jt"].close()


def _old_adam_update(adam, leaves, grads, keys, opt_state):
    """``Adam.update`` as it stood before its count terms moved to a device
    buffer: the learning rate and the bias corrections as host floats."""
    count = opt_state["count"]
    mu = [opt_state["mu"][k] for k in keys]
    nu = [opt_state["nu"][k] for k in keys]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < adam.clip_norm, 1.0, adam.clip_norm / norm)
    grads = torch._foreach_mul(grads, scale)
    torch._foreach_mul_(mu, adam.b1)
    torch._foreach_add_(mu, grads, alpha=1 - adam.b1)
    torch._foreach_mul_(nu, adam.b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - adam.b2)
    lr = (adam.schedule(count) if adam.schedule is not None
          else adam.learning_rate)
    count += 1
    den = torch._foreach_div(nu, 1 - adam.b2 ** count)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, adam.eps)
    upd = torch._foreach_div(mu, 1 - adam.b1 ** count)
    torch._foreach_div_(upd, den)
    if adam.weight_decay:
        torch._foreach_add_(upd, leaves, alpha=adam.weight_decay)
    torch._foreach_add_(leaves, upd, alpha=-lr)
    opt_state["count"] = count
    return norm


def _old_step(trainer, state, i):
    """The eager train step as it stood before this change: the batch-norm
    statistics in a new params dict, Adam with host floats."""
    batch = trainer._host_batch(BATCHES[i])[0]
    params = state["params"]
    flat = flatten_tree(params)
    keys = _trainable_paths(params)
    leaves = [flat[k].requires_grad_() for k in keys]
    loss, pp, new_params = trainer._loss(
        params, batch, torch.Generator().manual_seed(i), True)
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    with torch.no_grad():
        norm = _old_adam_update(trainer._opt, leaves, grads, keys,
                                state["opt_state"])
    return ({"params": new_params, "opt_state": state["opt_state"],
             "step": state["step"] + 1},
            {"loss": loss.detach(), "perplexity": pp.detach(),
             "grad_norm": norm})


def _flat_state(state):
    out = dict(flatten_tree(state["params"]))
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": v for k, v in state["opt_state"][m].items()})
    return out


@pytest.mark.parametrize("opt", list(OPTS))
def test_adam_terms_in_a_buffer_match_jax_and_the_host_step(tmp_path,
                                                            jax_runs, opt):
    run = jax_runs(opt)
    model = TM.CaptioningTransformer(**TFM_HP, **NO_DROPOUT)
    new, old = (_trainer(tmp_path, model, n, **OPTS[opt])
                for n in ("new", "old"))
    ns = new.init_state(params=tree_map(torch.clone, run["tp"]))
    os_ = old.init_state(params=tree_map(torch.clone, run["tp"]))
    for i in range(3):
        ns, nm = _step(new, ns, i)
        os_, om = _old_step(old, os_, i)
        # the buffer holds this step's lr and bias corrections, in f32
        want = new._opt.terms(i)
        assert new._terms.tolist() == [float(np.float32(x)) for x in want]
        assert ns["opt_state"]["count"] == os_["opt_state"]["count"] == i + 1
        for k in ("loss", "perplexity", "grad_norm"):
            np.testing.assert_allclose(float(nm[k]), run["metrics"][i][k],
                                       rtol=1e-5, err_msg=k)
            if i == 0:
                # the same forward and gradients: bit-equal
                assert float(nm[k]) == float(om[k]), k
        got, ref = _flat_state(ns), _flat_state(os_)
        for k in ref:
            if i == 0 and k.startswith(("mu/", "nu/")):
                assert torch.equal(got[k], ref[k]), k
            elif i == 0:
                # leaves - lr * upd in two roundings, where the host step
                # added upd with alpha=-lr in one
                torch.testing.assert_close(got[k], ref[k], **ROUND, msg=k)
            else:
                torch.testing.assert_close(got[k], ref[k], atol=ATOL_STEP,
                                           rtol=0, msg=k)
    want = flatten_tree(jax.device_get(run["states"][3]["params"]))
    got = flatten_tree(params_to_jax(ns["params"]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL_STEP, rtol=0,
                                   err_msg=k)
    new.close()
    old.close()


def test_terms_follow_optax_arithmetic():
    adam = Adam(schedule=lambda c: 1e-3 / (1 + c))
    for count in (0, 1, 7, 1000):
        lr, c1, c2 = adam.terms(count)
        assert lr == 1e-3 / (1 + count)
        assert c1 == 1 - 0.9 ** (count + 1) and c2 == 1 - 0.999 ** (count + 1)
    buf = torch.zeros(3)
    opt = {"count": 4}
    adam.write_terms(buf, opt)
    assert opt["count"] == 5
    assert buf.tolist() == [float(np.float32(x)) for x in adam.terms(4)]
    assert Adam(learning_rate=3e-4).terms(2)[0] == 3e-4


@pytest.mark.parametrize("name", ["transformer", "lstm_images"])
def test_batch_norm_statistics_written_in_place(tmp_path, name):
    if name == "transformer":
        model = TM.CaptioningTransformer(**TFM_HP)
        batch = BATCHES[0]
    else:
        model = TM.CaptioningLSTM(**LSTM_HP)
        rng = np.random.default_rng(3)
        batch = {"captions": BATCHES[0]["captions"],
                 "images": rng.normal(size=(8, 32, 32, 3)).astype(
                     np.float32)}
    trainer = _trainer(tmp_path, model)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    tree_ids = (id(state["params"]), id(state["params"]["encoder"]),
                id(state["params"]["encoder"]["bn"]))
    before = {k: (v, v.data_ptr(), v.clone())
              for k, v in flatten_tree(state["params"]).items()}
    host = trainer._host_batch(batch)[0]
    for i in range(3):
        images = (trainer._trunk_cache[host["image_rows"]]
                  if "image_rows" in host else host["images"])
        # the statistics this step's forward makes, from the same draws
        expect = model.forward(
            state["params"], images, host["captions"][:, :-1], train=True,
            gen=torch.Generator().manual_seed(i),
            from_trunk="image_rows" in host)[1]["encoder"]["bn"]
        state, _ = trainer._train_step(state, host,
                                       torch.Generator().manual_seed(i))
        bn = state["params"]["encoder"]["bn"]
        for k in ("running_mean", "running_var"):
            assert torch.equal(bn[k], expect[k])
    after = flatten_tree(state["params"])
    # the state keeps its dicts, tensors and addresses
    assert (id(state["params"]), id(state["params"]["encoder"]),
            id(state["params"]["encoder"]["bn"])) == tree_ids
    for k, (t, ptr, v0) in before.items():
        assert after[k] is t and t.data_ptr() == ptr, k
        if k.startswith("encoder/bn/running"):
            assert not torch.equal(after[k], v0)
    trainer.close()


def _epoch_loader(n=7):
    rng = np.random.default_rng(9)
    out = []
    for _ in range(n):
        caps = rng.integers(6, V, (4, 7)).astype(np.int32)
        caps[:, -1] = 3
        out.append({"captions": caps,
                    "image_rows": rng.integers(0, 4, (4,)).astype(np.int32)})
    out[-1]["row_valid"] = np.arange(4) < 3
    return out


def _dropout_trainer(tmp_path, title, **kw):
    model = TM.CaptioningTransformer(**TFM_HP)
    trainer = _trainer(tmp_path, model, title, log_grad_norm=True, **kw)
    return trainer, trainer.init_state(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("flush_every", [1, 3, 64])
def test_metrics_ring_logs_each_steps_values(tmp_path, flush_every):
    # the values the steps return, read one by one, against what
    # run_epoch logs through its ring; and the epoch means weighted by
    # the real rows (the tail batch has 3 of 4)
    ref, ref_state = _dropout_trainer(tmp_path, "ref")
    gen = torch.Generator().manual_seed(3)
    want, rows = [], []
    for b in _epoch_loader():
        host, n = ref._host_batch(b)
        ref_state, m = ref._train_step(ref_state, host, gen)
        want.append([m[k].item() for k in ("loss", "perplexity",
                                           "grad_norm")])
        rows.append(n)
    trainer, state = _dropout_trainer(tmp_path, f"ring{flush_every}",
                                      log_flush_every=flush_every,
                                      prefetch=0)
    state, loss, pp = trainer.run_epoch(state, _epoch_loader(),
                                        torch.Generator().manual_seed(3))
    lines = [json.loads(x) for x in (
        tmp_path / trainer.experiment_name / "train" /
        "metrics.jsonl").read_text().splitlines()]
    got = {}
    for x in lines:
        got.setdefault(x["tag"], []).append((x["step"], x["value"]))
    for j, tag in enumerate(("train/batch_loss", "train/batch_perplexity",
                             "train/grad_norm")):
        assert got[tag] == [(i + 1, w[j]) for i, w in enumerate(want)], tag
    # the epoch means: f32 values weighted in f64 (summed per flush)
    w = np.asarray(rows, np.float64)
    means = np.asarray(want, np.float32)[:, :2].T @ w / w.sum()
    np.testing.assert_allclose([loss, pp], means, rtol=1e-12)
    assert got["eval/loss"] == [(0, loss)]
    assert torch.equal(state["params"]["decoder"]["classifier"]["weight"],
                       ref_state["params"]["decoder"]["classifier"]["weight"])
    # an eval pass through the ring
    _, vl, vp = trainer.run_epoch(state, _epoch_loader(), None, phase="val")
    ev = [ref._eval_step(ref_state["params"], ref._host_batch(b)[0])
          for b in _epoch_loader()]
    np.testing.assert_allclose(
        vl, np.asarray([e["loss"].item() for e in ev], np.float32) @ w
        / w.sum(), rtol=1e-12)
    ref.close()
    trainer.close()


@pytest.mark.parametrize("flush_every", [1, 3, 64])
def test_metrics_ring_keeps_the_non_finite_guard(tmp_path, flush_every):
    trainer, state = _dropout_trainer(tmp_path, f"nan{flush_every}",
                                      log_flush_every=flush_every,
                                      prefetch=0)
    state["params"]["decoder"]["classifier"]["bias"][5] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite loss .* at "
                       "step 1 "):
        trainer.run_epoch(state, _epoch_loader(),
                          torch.Generator().manual_seed(0))
    trainer.close()


def test_step_key_tracks_what_a_graph_reads(tmp_path):
    trainer, state = _dropout_trainer(tmp_path, "key")
    gen = torch.Generator().manual_seed(0)
    batches = [trainer._host_batch(b)[0] for b in _epoch_loader()]
    full, tail = batches[0], batches[-1]
    state, _ = trainer._train_step(state, full, gen)

    def key(st=state, batch=full, g=gen, kind="train"):
        if kind == "eval":
            return trainer._key("eval", st["params"], batch)
        return trainer._key("train", st["params"], batch, st["opt_state"], g)

    k0 = key()
    # another batch of the same shapes, and the state after more steps
    # (updated in place), keep the key
    state, _ = trainer._train_step(state, batches[1], gen)
    assert key(batch=batches[1]) == k0
    longer = dict(full, captions=torch.cat([full["captions"]] * 2, 1))
    wider = {k: torch.cat([v, v]) for k, v in full.items()}
    new_params = tree_map(torch.clone, state["params"])
    new_state = dict(state, params=new_params)
    others = [key(batch=tail), key(batch=longer), key(batch=wider),
              key(st=new_state), key(g=torch.Generator().manual_seed(0)),
              key(kind="eval")]
    trainer._trunk_cache = trainer._trunk_cache.clone()
    others.append(key())
    assert len({k0, *others}) == len(others) + 1
    # new moments make a new key too
    opt = dict(state["opt_state"], mu=tree_map(torch.clone,
                                               state["opt_state"]["mu"]))
    assert key(st=dict(state, opt_state=opt)) != key()
    trainer.close()


def test_compiled_true_with_a_mesh_raises_before_any_step(tmp_path):
    # steps over a gloo group (a one-rank CPU mesh in this process) run
    # eagerly, as its collectives cannot be captured: compiled=True raises
    # there before the count moves or the generator is drawn from, from
    # run_epoch and from a step; compiled=None runs the mesh's steps
    # eagerly. Over NCCL they are captured (the card tests)
    import torch.distributed as dist

    from deephumor_tpu_torch.parallel import make_mesh, replicate

    owned = not dist.is_initialized()
    mesh = make_mesh("cpu")
    try:
        trainer, state = _dropout_trainer(tmp_path, "mesh", compiled=True)
        state = replicate(state, mesh)
        gen = torch.Generator().manual_seed(0)
        drawn = gen.get_state()
        with pytest.raises(ValueError, match="gloo group runs eagerly"):
            trainer.run_epoch(state, _epoch_loader(), gen, mesh=mesh)
        host = trainer._host_batch(_epoch_loader()[0])[0]
        with pytest.raises(ValueError, match="gloo group runs eagerly"):
            trainer._train_step(state, host, gen,
                                group=mesh.get_group("data"))
        assert state["opt_state"]["count"] == 0
        assert torch.equal(gen.get_state(), drawn)
        trainer.close()
        trainer, state = _dropout_trainer(tmp_path, "mesh_eager")
        state, _, _ = trainer.run_epoch(replicate(state, mesh),
                                        _epoch_loader(), gen, mesh=mesh)
        assert state["step"] == state["opt_state"]["count"] == 7
        trainer.close()
    finally:
        if owned:
            dist.destroy_process_group()
    # on the CPU without a mesh compiled=True runs eagerly
    trainer, state = _dropout_trainer(tmp_path, "cpu", compiled=True)
    state, _, _ = trainer.run_epoch(state, _epoch_loader(),
                                    torch.Generator().manual_seed(0))
    assert state["step"] == state["opt_state"]["count"] == 7
    assert not trainer._graphs.info()
    trainer.close()


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_resume_with_the_count_terms(tmp_path, jax_runs, opt,
                                                 direction):
    # a train state after two steps, written by one package and resumed by
    # the other: the count reads back, and the port's next step writes the
    # third step's terms and saves count 3 in optax's leaves
    run = jax_runs(opt)
    model = TM.CaptioningTransformer(**TFM_HP, **NO_DROPOUT)
    trainer = _trainer(tmp_path, model, **OPTS[opt])
    if direction == "jax_to_port":
        path = str(tmp_path / "jax")
        run["jt"].save_checkpoint(run["states"][2], path)
    else:
        state = trainer.init_state(params=tree_map(torch.clone, run["tp"]))
        for i in range(2):
            state, _ = _step(trainer, state, i)
        path = str(tmp_path / "port")
        trainer.save_checkpoint(state, path)
        js = run["jt"].restore_checkpoint(path)
        assert int(js["step"]) == 2
        assert int(jax.tree_util.tree_leaves(js["opt_state"])[0]) == 2
    state = trainer.restore_checkpoint(path)
    assert state["step"] == state["opt_state"]["count"] == 2
    state, m = _step(trainer, state, 2)
    assert trainer._terms.tolist() == [float(np.float32(x))
                                       for x in trainer._opt.terms(2)]
    np.testing.assert_allclose(float(m["loss"]), run["metrics"][2]["loss"],
                               rtol=1e-5)
    leaves = trainer._opt.to_leaves(state["opt_state"], state["params"])
    assert leaves[0].dtype == np.int32 and int(leaves[0]) == 3
    if trainer._opt.schedule is not None:
        assert int(leaves[-1]) == 3
    trainer.save_checkpoint(state, str(tmp_path / "again"))
    back = trainer.restore_checkpoint(str(tmp_path / "again"))
    assert back["step"] == back["opt_state"]["count"] == 3
    trainer.close()


def test_trunk_cache_on_the_cpu_is_the_trunk(tmp_path):
    model = TM.CaptioningLSTM(**LSTM_HP)
    params = _params(model)
    rng = np.random.default_rng(4)
    data = types.SimpleNamespace(images={
        f"t{i}": rng.normal(size=(32, 32, 3)).astype(np.float32)
        for i in range(5)})
    trainer = Trainer(model, "trunk", log_dir=str(tmp_path), device="cpu",
                      compiled=True)
    rows = trainer.build_trunk_cache(params, data, batch_size=2)
    x = torch.from_numpy(np.stack(list(data.images.values())))
    want = torch.cat([model.trunk(params, x[i:i + 2]) for i in (0, 2, 4)])
    assert rows == {f"t{i}": i for i in range(5)}
    assert torch.equal(trainer._trunk_cache, want)
    trainer.close()


@pytest.mark.parametrize("name", ["transformer", "base", "lstm",
                                  "lstm_labels"])
def test_generate_from_images_encodes_in_the_prefill(name):
    # the encoder now runs at the start of the call's program: the same
    # outputs as encode followed by generate_from_emb
    cls, hp = {"transformer": ("CaptioningTransformer", TFM_HP),
               "base": ("CaptioningTransformerBase", TFM_HP),
               "lstm": ("CaptioningLSTM", LSTM_HP),
               "lstm_labels": ("CaptioningLSTMWithLabels", LSTM_HP)}[name]
    model = getattr(TM, cls)(**hp)
    params = _params(model)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.normal(size=(3, 32, 32, 3)).astype(
        np.float32))
    extra = ((torch.from_numpy(rng.integers(6, V, (3, 2))),)
             if name == "lstm_labels" else ())
    kw = dict(max_len=8, beam_size=2, top_k=5, temperature=1.1)
    got = model.generate(params, images, *extra,
                         generator=torch.Generator().manual_seed(1), **kw)
    want = model.generate_from_emb(
        params, model.encode(params, images, *extra),
        generator=torch.Generator().manual_seed(1), **kw)
    for k in ("sequences", "scores", "chosen", "ended"):
        assert torch.equal(got[k], want[k]), k
