"""deephumor_tpu_torch's training path against the JAX package on the
CPU, f32, at tiny widths: the teacher-forced forwards of the four
captioners (eval and train mode), their gradients, the loss and metrics,
the transformer's full-sequence pieces (the pad-to-common-length quirk,
the encoder key mask, the repaired encoder), dropout, and the Trainer:
three steps against the JAX Trainer, frozen leaves, the cross-package
resume, the prefetch pipeline, the divergence guard and bf16 compute."""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deephumor_tpu import models as JM
from deephumor_tpu.experiments import metrics as JMET
from deephumor_tpu.experiments.trainer import Trainer as JaxTrainer
from deephumor_tpu.models import transformer as jtfm
from deephumor_tpu_torch import models as TM
from deephumor_tpu_torch.convert.jax_params import (params_from_jax,
                                                    params_to_jax)
from deephumor_tpu_torch.experiments import metrics as TMET
from deephumor_tpu_torch.experiments.trainer import Trainer, frozen_mask
from deephumor_tpu_torch.models import layers as L
from deephumor_tpu_torch.models import transformer as ttfm
from deephumor_tpu_torch.utils import profiling
from deephumor_tpu_torch.utils.pytree import flatten_tree, unflatten_tree

V = 48
LSTM_HP = dict(num_tokens=V, emb_dim=16, hidden_size=16, num_layers=2)
TFM_HP = dict(num_tokens=V, hid_dim=32, n_layers=2, n_heads=4, pf_dim=48,
              max_len=50)
MODELS = {
    "lstm": ("CaptioningLSTM", LSTM_HP),
    "lstm_labels": ("CaptioningLSTMWithLabels", LSTM_HP),
    "base": ("CaptioningTransformerBase", TFM_HP),
    "transformer": ("CaptioningTransformer", TFM_HP),
}
NO_DROPOUT = dict(enc_dropout=0.0, dec_dropout=0.0)
ATOL_STEP = 2e-4  # a fifth of one Adam step at lr 1e-3


def _pair(name, seed=0, **hp):
    """Both packages' models on one set of weights (drawn by the port:
    the JAX package's op-by-op init of the ResNet takes seconds)."""
    cls, base = MODELS[name]
    hp = {**base, **hp}
    jm, tm = getattr(JM, cls)(**hp), getattr(TM, cls)(**hp)
    tp = tm.init(torch.Generator().manual_seed(seed), device="cpu")
    jp = jax.tree.map(jnp.asarray, params_to_jax(tp))
    return jm, jp, tm, params_from_jax(jax.device_get(jp))


def _data(seed=0, n=4, t=9, images=False):
    rng = np.random.default_rng(seed)
    caps = rng.integers(6, V, (n, t)).astype(np.int32)
    caps[:, -1] = 3
    caps[1, t // 2:] = 0
    x = (rng.normal(size=(n, 32, 32, 3)) if images
         else rng.normal(size=(n, 7, 7, 2048))).astype(np.float32)
    return x, caps, rng.integers(6, V, (n, 3)).astype(np.int32)


def _kw(name, labels):
    if name != "lstm_labels":
        return {}, {}
    return ({"labels": jnp.asarray(labels)},
            {"labels": torch.from_numpy(labels).long()})


def _bn(params):
    enc = params["encoder"]
    return enc["bn"] if "bn" in enc else enc["image_encoder"]["bn"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# every model from trunk features; two through the ResNet from images
@pytest.mark.parametrize("name,from_trunk", [
    *((n, True) for n in MODELS), ("transformer", False),
    ("lstm_labels", False)])
def test_eval_forward_matches_jax(name, from_trunk):
    jm, jp, tm, tp = _pair(name)
    x, caps, labels = _data(images=not from_trunk)
    kj, kt = _kw(name, labels)
    want = jax.jit(lambda p, x, c, kw: jm.forward(
        p, x, c, from_trunk=from_trunk, **kw))(
            jp, jnp.asarray(x), jnp.asarray(caps), kj)
    got = tm.forward(tp, torch.from_numpy(x), torch.from_numpy(caps).long(),
                     from_trunk=from_trunk, **kt)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_forward_matches_jax_at_dropout_0(name):
    jm, jp, tm, tp = _pair(name, **NO_DROPOUT)
    x, caps, labels = _data()
    kj, kt = _kw(name, labels)
    want, new_j = jax.jit(lambda p, x, c, kw: jm.forward(
        p, x, c, train=True, rng=jax.random.PRNGKey(1), from_trunk=True,
        **kw))(jp, jnp.asarray(x), jnp.asarray(caps), kj)
    got, new_t = tm.forward(tp, torch.from_numpy(x),
                            torch.from_numpy(caps).long(), train=True,
                            gen=torch.Generator().manual_seed(1),
                            from_trunk=True, **kt)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    for jk, tk in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(_np(_bn(new_t)[tk]), _np(_bn(new_j)[jk]),
                                   atol=1e-6, rtol=1e-5)
        assert not torch.equal(_bn(new_t)[tk], _bn(tp)[tk])


def _jax_loss(jm, captions, **kw):
    def loss(p):
        logits, _ = jm.forward(p, captions=jnp.asarray(captions[:, :-1]),
                               train=True, rng=jax.random.PRNGKey(2), **kw)
        caps = jnp.asarray(captions)
        return JMET.masked_ce_and_perplexity(
            logits[:, :caps.shape[1]], caps, jnp.sum(caps != 0, axis=1))[0]
    return loss


@pytest.mark.parametrize("name", list(MODELS))
def test_gradients_match_jax_grad(name):
    jm, jp, tm, tp = _pair(name, **NO_DROPOUT)
    x, caps, labels = _data(t=11)
    kj, kt = _kw(name, labels)
    want = jax.jit(jax.grad(_jax_loss(jm, caps, images=jnp.asarray(x),
                                      from_trunk=True, **kj)))(jp)
    flat = flatten_tree(tp)
    keys = [k for k, m in flatten_tree(frozen_mask(tp)).items() if m]
    leaves = [flat[k].requires_grad_() for k in keys]
    c = torch.from_numpy(caps).long()
    logits, _ = tm.forward(tp, torch.from_numpy(x), c[:, :-1], train=True,
                           gen=torch.Generator(), from_trunk=True, **kt)
    loss, _ = TMET.masked_ce_and_perplexity(logits[:, :c.shape[1]], c,
                                            (c != 0).sum(1))
    grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
    got = flatten_tree(params_to_jax(unflatten_tree(
        {k: grads.get(k, torch.zeros_like(v)) for k, v in flat.items()})))
    want = jax.device_get(want)
    mask = flatten_tree(frozen_mask(want))
    want = flatten_tree(want)
    assert sum(mask.values()) == len(keys)
    for k, m in mask.items():
        if m:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6,
                                       rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match_jax(dtype, weighted):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(6, 11, 97)) * 3.0).astype(np.float32)
    targets = rng.integers(1, 97, (6, 11)).astype(np.int32)
    targets[2, 7:] = 0
    targets[4, 3:] = 0
    lengths = (targets != 0).sum(1)
    w = np.asarray([1, 1, 1, 1, 0, 1], np.float32) if weighted else None
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    tt, tn = torch.from_numpy(targets), torch.from_numpy(lengths)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    want = JMET.masked_ce_and_perplexity(jl, jnp.asarray(targets),
                                         jnp.asarray(lengths), 0, jw)
    got = TMET.masked_ce_and_perplexity(tl, tt, tn, 0, tw)
    for g, x in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(x), rtol=1e-5)
    jf, tf = jl.astype(jnp.float32), tl.float()
    np.testing.assert_allclose(
        _np(TMET.perplexity(tf, tt, tn, 0, tw)),
        _np(JMET.perplexity(jf, jnp.asarray(targets), jnp.asarray(lengths),
                            0, jw)), rtol=1e-5)
    np.testing.assert_allclose(
        _np(TMET.masked_cross_entropy(tf, tt)),
        _np(JMET.masked_cross_entropy(jf, jnp.asarray(targets))), rtol=1e-5)
    # the fused form equals the two-pass one
    np.testing.assert_allclose(_np(got[0]),
                               _np(TMET.masked_cross_entropy(tf, tt)),
                               rtol=1e-5)


def _decoder_pair(cross, max_len=50):
    jp = (jtfm.transformer_decoder_init if cross
          else jtfm.self_attn_decoder_init)(jax.random.PRNGKey(4), V, 32, 2,
                                            48, max_len)
    return jp, params_from_jax(jax.device_get(jp))


def test_pad_quirk_and_encoder_key_mask_match_jax():
    # tokens padded to the 49 encoder rows; an encoder row with one zero
    # element is masked like an all-zero one; whole masked rows (the pad
    # positions past the encoder's valid rows) get uniform weights
    jp, tp = _decoder_pair(True)
    rng = np.random.default_rng(5)
    tokens = rng.integers(6, V, (3, 10)).astype(np.int32)
    tokens[0, 6:] = 0
    enc = rng.normal(size=(3, 40, 32)).astype(np.float32)
    enc[0, 3, 7] = 0.0
    enc[1, 5] = 0.0
    enc[2] = 0.0
    start = rng.normal(size=(3, 32)).astype(np.float32)
    want = jax.jit(jtfm.transformer_decoder_forward, static_argnums=4)(
        jp, jnp.asarray(tokens), jnp.asarray(enc), jnp.asarray(start), 4)
    got = ttfm.transformer_decoder_forward(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(enc),
        torch.from_numpy(start), 4)
    assert tuple(got.shape) == want.shape == (3, 40, V)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    assert torch.isfinite(got).all()
    # longer captions than encoder rows: T + 1 positions
    tokens = rng.integers(6, V, (3, 45)).astype(np.int32)
    got = ttfm.transformer_decoder_forward(
        tp, torch.from_numpy(tokens).long(), torch.from_numpy(enc),
        torch.from_numpy(start), 4)
    assert got.shape[1] == 46


@pytest.mark.parametrize("cross", [True, False], ids=["cross", "self"])
def test_positional_table_too_small_raises(cross):
    _, tp = _decoder_pair(cross, max_len=10)
    tokens = torch.randint(6, V, (2, 8))
    start = torch.randn(2, 32)
    with pytest.raises(ValueError, match="positional table"):
        if cross:
            # the 49 encoder rows need 49 positions
            ttfm.transformer_decoder_forward(tp, tokens, torch.randn(2, 49,
                                                                     32),
                                             start, 4)
        else:
            ttfm.self_attn_decoder_forward(
                tp, torch.randint(6, V, (2, 10)), start, 4)
    model = TM.CaptioningTransformer(**{**TFM_HP, "max_len": 10})
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="positional table"):
        model.forward(params, torch.randn(2, 7, 7, 2048), tokens,
                      from_trunk=True)


@pytest.mark.parametrize("pad_index", [None, 0])
def test_transformer_encoder_matches_jax(pad_index):
    jp = jtfm.transformer_encoder_init(jax.random.PRNGKey(6), V, 32, 2, 48,
                                       16)
    tp = params_from_jax(jax.device_get(jp))
    tokens = np.random.default_rng(7).integers(1, V, (3, 12)).astype(
        np.int32)
    tokens[1, 8:] = 0
    want = jax.jit(jtfm.transformer_encoder_forward, static_argnums=(2, 3))(
        jp, jnp.asarray(tokens), 4, pad_index)
    got = ttfm.transformer_encoder_forward(tp, torch.from_numpy(tokens).long(),
                                           4, pad_index)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="positional table"):
        ttfm.transformer_encoder_forward(tp, torch.ones(1, 17).long(), 4)
    # the encoder stack has the JAX tree
    assert flatten_tree(params_to_jax(ttfm.transformer_encoder_init(
        torch.Generator(), V, 32, 2, 48, 16, device="cpu"))).keys() == \
        flatten_tree(jax.device_get(jp)).keys()


def test_dropout_keep_fraction_and_scale():
    x = torch.ones(200_000)
    for rate in (0.1, 0.3):
        y = L.dropout(torch.Generator().manual_seed(0), x, rate, True)
        keep = 1 - rate
        frac = (y != 0).float().mean().item()
        assert abs(frac - keep) < 3 * (keep * rate / x.numel()) ** 0.5
        assert torch.allclose(y[y != 0], torch.tensor(1 / keep))
    assert L.dropout(None, x, 0.3, False) is x
    assert L.dropout(None, x, 0.0, True) is x
    with pytest.raises(ValueError, match="Generator"):
        L.dropout(None, x, 0.3, True)


def test_train_mode_differs_from_eval_and_learns(tmp_path):
    model = TM.CaptioningTransformer(**{**TFM_HP, "enc_dropout": 0.3,
                                        "dec_dropout": 0.1})
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    x, caps, _ = _data()
    feats = torch.from_numpy(x)
    c = torch.from_numpy(caps).long()
    ev = model.forward(params, feats, c, from_trunk=True)
    tr, _ = model.forward(params, feats, c, train=True,
                          gen=torch.Generator().manual_seed(0),
                          from_trunk=True)
    assert not torch.allclose(ev, tr)
    trainer = Trainer(model, "toy", log_dir=str(tmp_path), device="cpu",
                      learning_rate=3e-3, prefetch=0)
    state = trainer.init_state(params=params)
    trainer._trunk_cache = feats
    batch = {"captions": c, "image_rows": torch.arange(4)}
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(30):
        state, m = trainer._train_step(state, batch, gen)
        losses.append(m["loss"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, losses


def _make_batches():
    rng = np.random.default_rng(8)
    trunk = rng.normal(size=(4, 7, 7, 2048)).astype(np.float32)
    batches = []
    for _ in range(3):
        caps = rng.integers(6, V, (8, 12)).astype(np.int32)
        caps[2, 7:] = 0
        caps[5, 3:] = 0
        batches.append({"captions": caps,
                        "labels": rng.integers(6, V, (8, 3)).astype(np.int32),
                        "image_rows": rng.integers(0, 4, (8,)).astype(
                            np.int32)})
    return trunk, batches


TRUNK, BATCHES = _make_batches()
OPTS = {
    "adam": {},
    "adamw_schedule_clipped": dict(weight_decay=0.01, clip_norm=0.5,
                                   schedule=lambda c: 1e-3 / (1 + c)),
}
# the head's linear bias ahead of a train-mode batch norm has an exactly
# zero gradient (the norm subtracts the batch mean), so each package's
# Adam step on it normalises rounding noise: its value is not compared
# after steps (its gradient is, in test_gradients_match_jax_grad). The
# cross-attention model's spatial path gives the bias a real gradient.
ZERO_GRAD = {"lstm_labels": "encoder/image_encoder/linear/bias"}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX Trainer's three steps on BATCHES per (model, optimizer):
    the states after each step, the metrics and its train-state
    checkpoint after two; computed once in this module."""
    runs = {}

    def get(name, opt):
        if (name, opt) not in runs:
            jm, jp, tm, _ = _pair(name, **NO_DROPOUT)
            d = tmp_path_factory.mktemp(f"{name}-{opt}")
            jt = JaxTrainer(jm, "j", log_dir=str(d), **OPTS[opt])
            js = jt.init_state(jax.random.PRNGKey(0), params=jp)
            jt._trunk_cache = jnp.asarray(TRUNK)
            jt._build_steps()
            states, metrics = [js], []
            for i, batch in enumerate(BATCHES):
                js, m = jt._train_step(
                    js, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(i))
                states.append(js)
                metrics.append(m)
            jt.save_checkpoint(states[2], str(d / "ck"))
            runs[name, opt] = dict(jt=jt, tm=tm, states=states,
                                   metrics=metrics, ck=str(d / "ck"))
        return runs[name, opt]

    yield get
    for run in runs.values():
        run["jt"].close()


def _port_trainer(tmp_path, run, opt):
    tt = Trainer(run["tm"], "t", log_dir=str(tmp_path), device="cpu",
                 **OPTS[opt])
    tt._trunk_cache = torch.from_numpy(TRUNK)
    params = params_from_jax(jax.device_get(run["states"][0]["params"]))
    return tt, tt.init_state(params=params)


def _port_step(tt, ts, i):
    return tt._train_step(ts, tt._host_batch(BATCHES[i])[0],
                          torch.Generator().manual_seed(i))


def _assert_metrics_close(got, want):
    for k in ("loss", "perplexity", "grad_norm"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-5,
                                   err_msg=k)


def _assert_states_close(tt, ts, js, skip=None):
    want = flatten_tree(jax.device_get(js["params"]))
    got = flatten_tree(params_to_jax(ts["params"]))
    assert got.keys() == want.keys()
    for k in want:
        if k != skip:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL_STEP,
                                       rtol=0, err_msg=k)
    jl = jax.tree_util.tree_leaves(jax.device_get(js["opt_state"]))
    tl = tt._opt.to_leaves(ts["opt_state"], ts["params"])
    assert len(tl) == len(jl)
    assert int(tl[0]) == int(jl[0]) == ts["step"] == int(js["step"])
    for a, b in zip(tl[1:], jl[1:]):
        np.testing.assert_allclose(a, b, atol=ATOL_STEP, rtol=0)


# the main model under both optimizers; the labelled LSTM for its labels
# and its shared embedding (the four forwards and gradients are held to
# the JAX package above)
@pytest.mark.parametrize("name,opt", [
    ("transformer", "adam"), ("transformer", "adamw_schedule_clipped"),
    ("lstm_labels", "adam")])
def test_three_trainer_steps_match_jax(tmp_path, jax_runs, name, opt):
    run = jax_runs(name, opt)
    tt, ts = _port_trainer(tmp_path, run, opt)
    for i in range(3):
        ts, m = _port_step(tt, ts, i)
        _assert_metrics_close(m, run["metrics"][i])
    _assert_states_close(tt, ts, run["states"][3], ZERO_GRAD.get(name))
    tt.close()


def test_frozen_leaves_unchanged_from_images(tmp_path):
    model = TM.CaptioningLSTM(**LSTM_HP)
    trainer = Trainer(model, "f", log_dir=str(tmp_path), device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in flatten_tree(state["params"]).items()}
    x, caps, _ = _data(images=True)
    batch = trainer._host_batch({"captions": caps, "images": x})[0]
    expect_bn = model.forward(
        state["params"], batch["images"], batch["captions"][:, :-1],
        train=True, gen=torch.Generator().manual_seed(0))[1]["encoder"]["bn"]
    state, _ = trainer._train_step(state, batch,
                                   torch.Generator().manual_seed(0))
    after = flatten_tree(state["params"])
    mask = flatten_tree(frozen_mask(state["params"]))
    resnet = [k for k in after if "resnet" in k]
    assert resnet and all(torch.equal(after[k], before[k]) for k in resnet)
    for k in ("running_mean", "running_var"):
        # advanced by the forward only: no optimizer update on top
        assert torch.equal(state["params"]["encoder"]["bn"][k], expect_bn[k])
        assert not torch.equal(after[f"encoder/bn/{k}"],
                               before[f"encoder/bn/{k}"])
        assert not mask[f"encoder/bn/{k}"]
    assert not torch.equal(after["encoder/linear/weight"],
                           before["encoder/linear/weight"])
    assert set(state["opt_state"]["mu"]) == {k for k, m in mask.items() if m}
    trainer.close()


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_resume(tmp_path, jax_runs, direction, opt):
    # a train state after two steps, saved by one package and restored by
    # the other, takes the third step as the saving package would
    run = jax_runs("transformer", opt)
    tt, ts = _port_trainer(tmp_path, run, opt)
    if direction == "jax_to_port":
        ts = tt.restore_checkpoint(run["ck"])
        assert ts["step"] == 2
        ts, m = _port_step(tt, ts, 2)
        _assert_metrics_close(m, run["metrics"][2])
        _assert_states_close(tt, ts, run["states"][3])
    else:
        for i in range(2):
            ts, _ = _port_step(tt, ts, i)
        tt.save_checkpoint(ts, str(tmp_path / "ck"))
        js = run["jt"].restore_checkpoint(str(tmp_path / "ck"))
        assert int(js["step"]) == 2
        js, jm = run["jt"]._train_step(
            js, {k: jnp.asarray(v) for k, v in BATCHES[2].items()},
            jax.random.PRNGKey(2))
        ts, m = _port_step(tt, ts, 2)
        _assert_metrics_close(m, jm)
        _assert_states_close(tt, ts, js)
    tt.close()


def _epoch_loader():
    rng = np.random.default_rng(9)
    out = []
    for _ in range(5):
        caps = rng.integers(6, V, (4, 7)).astype(np.int32)
        caps[:, -1] = 3
        out.append({"captions": caps,
                    "image_rows": rng.integers(0, 4, (4,)).astype(np.int32)})
    return out


def _toy_trainer(tmp_path, title, **kw):
    model = TM.CaptioningTransformer(**{**TFM_HP, "enc_dropout": 0.3,
                                        "dec_dropout": 0.1})
    trainer = Trainer(model, title, log_dir=str(tmp_path), device="cpu",
                      log_flush_every=2, **kw)
    trainer._trunk_cache = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 7, 7, 2048)).astype(np.float32))
    return trainer, trainer.init_state(torch.Generator().manual_seed(0))


def test_prefetch_depths_bit_equal(tmp_path):
    results = []
    for depth in (0, 2):
        trainer, state = _toy_trainer(tmp_path, f"pf{depth}", prefetch=depth)
        state, loss, pp = trainer.run_epoch(
            state, _epoch_loader(), torch.Generator().manual_seed(3))
        results.append((loss, pp, state["params"]["decoder"]["tok_embedding"]
                        ["weight"].clone(), state["step"]))
        trainer.close()
    assert results[0][:2] == results[1][:2]
    assert torch.equal(results[0][2], results[1][2])
    assert results[0][3] == results[1][3] == 5


def test_producer_exception_reraised_at_the_step(tmp_path):
    def bad_loader():
        yield _epoch_loader()[0]
        raise RuntimeError("loader blew up")

    trainer, state = _toy_trainer(tmp_path, "pfx")
    with pytest.raises(RuntimeError, match="loader blew up"):
        trainer.run_epoch(state, bad_loader(),
                          torch.Generator().manual_seed(0))
    trainer.close()


def _producer_alive():
    return any(t.name == "dh-epoch-prefetch" and t.is_alive()
               for t in threading.enumerate())


def test_producer_released_when_a_step_raises(tmp_path):
    trainer, state = _toy_trainer(tmp_path, "pfleak")
    real, calls = trainer._train_step, [0]

    def failing(st, b, g):
        calls[0] += 1
        if calls[0] >= 2:
            raise RuntimeError("boom")
        return real(st, b, g)

    trainer._train_step = failing
    with pytest.raises(RuntimeError, match="boom"):
        trainer.run_epoch(state, _epoch_loader() * 4,
                          torch.Generator().manual_seed(0))
    # the consumer joined the producer before draining: it is gone now
    deadline = time.time() + 5
    while _producer_alive() and time.time() < deadline:
        time.sleep(0.05)
    assert not _producer_alive()
    trainer.close()


def test_non_finite_loss_raises(tmp_path):
    trainer, state = _toy_trainer(tmp_path, "nan", prefetch=0)
    state["params"]["decoder"]["classifier"]["bias"][5] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.run_epoch(state, _epoch_loader(),
                          torch.Generator().manual_seed(0))
    trainer.close()


def test_tail_batch_weights_and_metrics_files(tmp_path):
    # a tail batch of 2 real rows and 2 duplicates scores as the 2 rows
    trainer, state = _toy_trainer(tmp_path, "tail", prefetch=0)
    b = _epoch_loader()[0]
    full = {k: v[:2] for k, v in b.items()}
    tail = {k: np.concatenate([v[:2], v[1:2], v[1:2]]) for k, v in b.items()}
    tail["row_valid"] = np.arange(4) < 2
    _, l2, p2 = trainer.run_epoch(state, [full], None, phase="val")
    _, l4, p4 = trainer.run_epoch(state, [tail], None, phase="val")
    np.testing.assert_allclose([l4, p4], [l2, p2], rtol=1e-6)
    state, _, _ = trainer.run_epoch(state, _epoch_loader(),
                                    torch.Generator().manual_seed(0))
    trainer.close()
    lines = (tmp_path / trainer.experiment_name / "train" /
             "metrics.jsonl").read_text().splitlines()
    tags = [json.loads(line)["tag"] for line in lines]
    assert tags.count("train/batch_loss") == 5
    assert tags[-2:] == ["eval/loss", "eval/perplexity"]


def test_bf16_compute_tracks_f32_losses(tmp_path):
    losses = {}
    for cdt in (None, "bfloat16"):
        jm, jp, tm, tp = _pair("transformer")
        trainer = Trainer(tm, "bf16", log_dir=str(tmp_path), device="cpu",
                          compute_dtype=cdt, learning_rate=1e-2)
        state = trainer.init_state(params=tp)
        rng = np.random.default_rng(0)
        trainer._trunk_cache = torch.from_numpy(
            rng.normal(size=(4, 7, 7, 2048)).astype(np.float32))
        batch = {"captions": torch.from_numpy(
                     rng.integers(6, V, (8, 12))).long(),
                 "image_rows": torch.from_numpy(rng.integers(0, 4, (8,)))}
        ls = []
        for i in range(8):
            state, m = trainer._train_step(state, batch,
                                           torch.Generator().manual_seed(i))
            ls.append(m["loss"].item())
        losses[cdt] = ls
        trainer.close()
    f32, bf16 = losses[None], losses["bfloat16"]
    assert bf16[-1] < bf16[0], bf16
    rel = max(abs(a - b) / abs(a) for a, b in zip(f32, bf16))
    assert rel < 0.02, (rel, f32, bf16)
    assert all(t.dtype == torch.float32
               for t in flatten_tree(state["params"]).values())
    m_bf16 = dataclasses.replace(tm, compute_dtype="bfloat16")
    logits = m_bf16.forward(state["params"],
                            trainer._trunk_cache[batch["image_rows"]],
                            batch["captions"][:, :-1], from_trunk=True)
    assert logits.dtype == torch.bfloat16


def test_profiling_helpers(tmp_path):
    timer = profiling.Timer()
    with timer.section("mm") as s:
        s.result = {"y": [torch.ones(8) @ torch.ones(8)]}
    with timer.section("mm"):
        pass
    assert timer.summary()["mm"]["count"] == 2
    stats = profiling.benchmark(lambda a: a * 2, torch.ones(4), iters=3)
    assert stats["iters"] == 3 and stats["min_s"] <= stats["mean_s"]
    assert profiling.sync({"a": torch.ones(1)})["a"].item() == 1.0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
