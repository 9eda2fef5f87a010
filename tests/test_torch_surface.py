"""deephumor_tpu_torch's public surface against the JAX package's: every
name of every JAX module's ``__all__`` in the port's counterpart (less the
listed exceptions, each with its reason), the reference-name handles
against JAX's on one set of weights (the port's, carried across by
convert/jax_params.py), a light top level, the experiment config's JSON
read by either package, and whole-state checkpoints (``save_state`` /
``restore_state`` / ``latest_step``), in one process and over two gloo
ranks with a tensor-parallel placement."""

import importlib
import os
import pkgutil
import subprocess
import sys
import time
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import deephumor_tpu
from deephumor_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from deephumor_tpu.models import compat as jax_compat
from deephumor_tpu.utils import checkpoint as jax_checkpoint
from deephumor_tpu.utils import config as jax_config
from deephumor_tpu_torch.convert.jax_params import params_to_jax
from deephumor_tpu_torch.experiments.trainer import Trainer
from deephumor_tpu_torch.models import MODEL_REGISTRY
from deephumor_tpu_torch.models import compat
from deephumor_tpu_torch.models import encoders, lstm, transformer
from deephumor_tpu_torch.utils import checkpoint, config
from deephumor_tpu_torch.utils.pytree import flatten_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX module -> the port's module of the same role where the names differ
MODULE_MAP = {"ops.pallas_attention": "ops.attention",
              "ops.pallas_cache": "ops.cache",
              "ops.pallas_engine": "ops.engine",
              "ops.pallas_sampler": "ops.sampler"}
# (JAX module, name) -> why the port has no such name
EXCEPTIONS = {
    ("utils.checkpoint", "save_orbax"):
        "orbax is a JAX library; the port writes the same step directories "
        "with torch.distributed.checkpoint: utils.checkpoint.save_state",
    ("utils.checkpoint", "restore_orbax"):
        "the orbax format's reader; the port's is "
        "utils.checkpoint.restore_state",
    ("experiments.trainer", "make_optimizer"):
        "builds an optax chain; the port's Trainer steps its own Adam "
        "(experiments.trainer.Adam) with optax's arithmetic and leaf order",
    ("models.transformer", "mha_init"):
        "the port makes a layer's attention parameters inside its layer "
        "init (models/transformer.py _mha_init); no caller outside it",
    ("models.transformer", "pff_init"):
        "as mha_init: the port's feed-forward parameters are made in its "
        "layer init",
    ("ops.pallas_attention", "supports_fused_update"):
        "a TPU-only layout constraint of the Pallas kernels; the CUDA "
        "kernels take every shape their wrappers check (ROADMAP: TPU-only "
        "constraints stay out)",
}


def _jax_modules():
    names = [""]
    for info in pkgutil.walk_packages(deephumor_tpu.__path__):
        names.append(info.name)
    return sorted(names)


@pytest.mark.parametrize("name", _jax_modules(), ids=lambda n: n or "top")
def test_every_jax_name_has_a_port_counterpart(name):
    jax_mod = importlib.import_module(
        "deephumor_tpu" + ("." + name if name else ""))
    port_name = MODULE_MAP.get(name, name)
    port = importlib.import_module(
        "deephumor_tpu_torch" + ("." + port_name if port_name else ""))
    missing = [n for n in getattr(jax_mod, "__all__", [])
               if not hasattr(port, n) and (name, n) not in EXCEPTIONS]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_exceptions_are_still_missing():
    for (name, attr), reason in EXCEPTIONS.items():
        port = importlib.import_module(
            "deephumor_tpu_torch." + MODULE_MAP.get(name, name))
        assert not hasattr(port, attr), f"{attr} exists now: drop {reason!r}"


def test_the_top_level_is_light():
    code = ("import sys, deephumor_tpu_torch as d; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "('torch', 'deephumor_tpu_torch.models', "
            "'deephumor_tpu_torch.ops', 'jax'))), d.Vocab, d.CharTokenizer)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.startswith("[] "), out


def _close(got, want, atol=2e-4):
    if isinstance(got, tuple):  # the image encoder's (global, spatial)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=1e-4, atol=atol)


HANDLE_FUNCS = {
    "ImageEncoder": (encoders, {"init": "image_encoder_init",
                                "apply": "image_encoder_apply",
                                "trunk": "image_encoder_trunk"}),
    "LabelEncoder": (encoders, {"init": "label_encoder_init",
                                "apply": "label_encoder_apply"}),
    "ImageLabelEncoder": (encoders, {"init": "image_label_encoder_init",
                                     "apply": "image_label_encoder_apply"}),
    "LSTMDecoder": (lstm, {"init": "lstm_decoder_init",
                           "forward": "lstm_decoder_forward",
                           "step": "lstm_step"}),
    "TransformerEncoder": (transformer, {
        "init": "transformer_encoder_init",
        "forward": "transformer_encoder_forward"}),
    "TransformerDecoder": (transformer, {
        "init": "transformer_decoder_init",
        "forward": "transformer_decoder_forward",
        "decode_step": "decode_step"}),
    "SelfAttentionTransformerDecoder": (transformer, {
        "init": "self_attn_decoder_init",
        "forward": "self_attn_decoder_forward",
        "decode_step": "decode_step"}),
}


def test_handles_are_the_port_functions():
    assert compat.__all__ == jax_compat.__all__ == list(HANDLE_FUNCS)
    for cls, (module, attrs) in HANDLE_FUNCS.items():
        jax_attrs = {k for k in vars(getattr(jax_compat, cls))
                     if not k.startswith("_")}
        assert jax_attrs == set(attrs)
        for attr, fn in attrs.items():
            assert getattr(getattr(compat, cls), attr) is getattr(module, fn)


def _carried(params):
    """The JAX layout of the port's parameters (numpy leaves)."""
    return params_to_jax(params)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def test_encoder_handles_match_jax():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 30, (2, 4))
    gen = torch.Generator().manual_seed(1)
    p = compat.ImageEncoder.init(gen, emb_dim=8, device="cpu")
    jp = _carried(p)
    trunk = compat.ImageEncoder.trunk(p, _t(images))
    jax_trunk = jax_compat.ImageEncoder.trunk(jp, jnp.asarray(images))
    _close(trunk, jax_trunk)
    _close(compat.ImageEncoder.apply(p, _t(images)),
           jax_compat.ImageEncoder.apply(jp, jnp.asarray(images)))
    # the heads from the trunk's features (no second ResNet pass)
    _close(compat.ImageEncoder.apply(p, trunk, spatial_features=True,
                                     from_trunk=True),
           jax_compat.ImageEncoder.apply(jp, jax_trunk, spatial_features=True,
                                         from_trunk=True))
    p = compat.LabelEncoder.init(gen, 30, emb_dim=8, device="cpu")
    _close(compat.LabelEncoder.apply(p, _t(labels, torch.long)),
           jax_compat.LabelEncoder.apply(_carried(p), jnp.asarray(labels)))
    p = compat.ImageLabelEncoder.init(gen, 30, emb_dim=8, device="cpu")
    _close(compat.ImageLabelEncoder.apply(p, trunk, _t(labels, torch.long),
                                          from_trunk=True),
           jax_compat.ImageLabelEncoder.apply(_carried(p), jax_trunk,
                                              jnp.asarray(labels),
                                              from_trunk=True))


def test_decoder_handles_match_jax():
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(2)
    tokens = rng.integers(4, 30, (2, 6))
    emb = rng.normal(size=(2, 16)).astype(np.float32)
    enc = rng.normal(size=(2, 5, 16)).astype(np.float32)
    jtok, ttok = jnp.asarray(tokens), _t(tokens, torch.long)

    p = compat.LSTMDecoder.init(gen, 30, emb_dim=16, hidden_size=24,
                                num_layers=2, device="cpu")
    jp = _carried(p)
    _close(compat.LSTMDecoder.forward(p, _t(emb), ttok),
           jax_compat.LSTMDecoder.forward(jp, jnp.asarray(emb), jtok))
    h = rng.normal(size=(2, 2, 24)).astype(np.float32)
    got = compat.LSTMDecoder.step(p["lstm"], _t(emb), _t(h), _t(h))
    want = jax_compat.LSTMDecoder.step(jp["lstm"], jnp.asarray(emb),
                                       jnp.asarray(h), jnp.asarray(h))
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close(g, w)

    kw = dict(hid_dim=16, n_layers=2, pf_dim=24, max_len=10, device="cpu")
    p = compat.TransformerEncoder.init(gen, 30, **kw)
    _close(compat.TransformerEncoder.forward(p, ttok, 4),
           jax_compat.TransformerEncoder.forward(_carried(p), jtok, 4))
    p = compat.TransformerDecoder.init(gen, 30, **kw)
    _close(compat.TransformerDecoder.forward(p, ttok, _t(enc), _t(emb), 4),
           jax_compat.TransformerDecoder.forward(
               _carried(p), jtok, jnp.asarray(enc), jnp.asarray(emb), 4))
    p = compat.SelfAttentionTransformerDecoder.init(gen, 30, **kw)
    _close(compat.SelfAttentionTransformerDecoder.forward(p, ttok, _t(emb),
                                                          4),
           jax_compat.SelfAttentionTransformerDecoder.forward(
               _carried(p), jtok, jnp.asarray(emb), 4))


HPS = {
    "captioning_lstm": dict(num_tokens=40, emb_dim=16, hidden_size=24,
                            num_layers=2),
    "captioning_lstm_labels": dict(num_tokens=40, emb_dim=16, hidden_size=24,
                                   num_layers=1, compute_dtype="bfloat16"),
    "captioning_transformer_base": dict(num_tokens=40, hid_dim=16,
                                        n_layers=2, n_heads=4, pf_dim=24,
                                        max_len=20),
    "captioning_transformer": dict(num_tokens=40, hid_dim=16, n_layers=1,
                                   n_heads=2, pf_dim=24, max_len=20,
                                   compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("model_type", list(HPS))
def test_config_json_reads_in_either_package(model_type, tmp_path):
    train = dict(learning_rate=3e-4, n_epochs=4, batch_size=16, seed=3,
                 log_grad_norm=True)
    jax_model = JAX_REGISTRY[model_type](**HPS[model_type])
    model = MODEL_REGISTRY[model_type](**HPS[model_type])
    assert model.hp() == jax_model.hp()
    theirs = jax_config.ExperimentConfig.from_model(
        jax_model, train=jax_config.TrainConfig(**train),
        sampling=jax_config.SamplingConfig.char_default(), title="t")
    ours = config.ExperimentConfig.from_model(
        model, train=config.TrainConfig(**train),
        sampling=config.SamplingConfig.char_default(), title="t")
    theirs.save(tmp_path / "jax.json")
    ours.save(tmp_path / "port.json")
    assert ((tmp_path / "jax.json").read_text()
            == (tmp_path / "port.json").read_text())
    back = config.ExperimentConfig.load(tmp_path / "jax.json")
    assert back == ours and back.build_model() == model
    jax_back = jax_config.ExperimentConfig.load(tmp_path / "port.json")
    assert jax_back == theirs
    assert jax_back.build_model().hp() == model.hp()
    assert (back.sampling.generate_kwargs()
            == jax_back.sampling.generate_kwargs())


def _state(seed, device="cpu"):
    model = MODEL_REGISTRY["captioning_transformer"](
        num_tokens=24, hid_dim=16, n_layers=1, n_heads=4, pf_dim=24,
        max_len=12)
    trainer = Trainer(model, log_dir="unused", device=device)
    g = torch.Generator(device).manual_seed(seed)
    state = trainer.init_state(g)
    for name in ("mu", "nu"):
        for t in state["opt_state"][name].values():
            t.normal_(generator=g)
    state["opt_state"]["count"] = state["step"] = seed
    return state


def _assert_bit_equal(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert got[k].dtype == w.dtype and got[k].device == w.device, k
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


def test_save_and_restore_state_round_trip(tmp_path):
    state = _state(3)
    directory = tmp_path / "ckpt"
    assert checkpoint.latest_step(str(directory)) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_state(str(directory), device="cpu")
    checkpoint.save_state(str(directory), _state(4), 7)
    path = checkpoint.save_state(str(directory), state, 12)
    assert path == str(directory / "12")
    assert checkpoint.latest_step(str(directory)) == 12
    template = _state(5)
    got, step = checkpoint.restore_state(str(directory), template=template)
    assert step == 12
    _assert_bit_equal(got, state)
    _assert_bit_equal(template, _state(5))  # left as it was
    got, step = checkpoint.restore_state(str(directory), step=7,
                                         device="cpu")
    _assert_bit_equal(got, _state(4))
    checkpoint.save_state(str(directory), state, 7)  # replaces step 7
    _assert_bit_equal(checkpoint.restore_state(str(directory), 7,
                                               device="cpu")[0], state)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_state(str(directory), step=8, device="cpu")


def test_latest_step_agrees_with_jax(tmp_path):
    for listing in ([], ["3", "10", "abc", "7x", "2"], ["x"], ["0"]):
        root = tmp_path / f"d{len(listing)}_{'_'.join(listing)}"
        root.mkdir()
        for name in listing:
            (root / name).mkdir()
        assert (checkpoint.latest_step(str(root))
                == jax_checkpoint.latest_step(str(root)))
    missing = str(tmp_path / "nowhere")
    assert (checkpoint.latest_step(missing)
            == jax_checkpoint.latest_step(missing) is None)


# -- two gloo ranks: a data 1 x model 2 placement ---------------------------
def _placed_rank(rank, outdir):
    from torch.distributed.tensor import DTensor

    from deephumor_tpu_torch.parallel import make_mesh, place_train_state

    mesh = make_mesh("cpu", model=2)
    state = place_train_state(_state(3), mesh)
    checkpoint.save_state(os.path.join(outdir, "ckpt"), state, 9)
    template = place_train_state(_state(5), mesh)
    got, step = checkpoint.restore_state(os.path.join(outdir, "ckpt"),
                                         template=template)
    got, want = flatten_tree(got), flatten_tree(state)
    placed = same = 0
    for k, w in want.items():
        if isinstance(w, DTensor):
            g = got[k]
            assert isinstance(g, DTensor) and g.placements == w.placements
            assert g.device_mesh == w.device_mesh
            assert torch.equal(g.to_local(), w.to_local()), k
            placed += any(p.is_shard() for p in w.placements)
        else:
            assert (torch.equal(got[k], w) if isinstance(w, torch.Tensor)
                    else got[k] == w), k
        same += 1
    whole, _ = checkpoint.restore_state(os.path.join(outdir, "ckpt"),
                                        device="cpu")
    return {"step": step, "leaves": same, "sharded": placed,
            "whole": {k: v for k, v in flatten_tree(whole).items()
                      if isinstance(v, torch.Tensor)}}


def _rank_main(rank, world, outdir):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(outdir, "store"), world),
            rank=rank, world_size=world)
        torch.save(_placed_rank(rank, outdir),
                   os.path.join(outdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def test_placed_state_restores_onto_its_placement(tmp_path):
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 2, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 120
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [e.read_text() for e in tmp_path.glob("rank*.err")]
    assert not any(alive) and not errors and not any(
        p.exitcode for p in procs), errors
    results = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
               for r in range(2)]
    assert all(r["step"] == 9 and r["sharded"] > 0 for r in results)
    # each rank wrote its own shards
    files = sorted(os.listdir(tmp_path / "ckpt" / "9"))
    assert {"__0_0.distcp", "__1_0.distcp"} <= set(files), files
    # without a template, both ranks read the whole, unplaced state
    whole = {k: v for k, v in flatten_tree(_state(3)).items()
             if isinstance(v, torch.Tensor)}
    for r in results:
        assert r["whole"].keys() == whole.keys()
        for k, w in whole.items():
            assert torch.equal(r["whole"][k], w), k
