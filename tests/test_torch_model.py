"""deephumor_tpu_torch's model path against the JAX package on the CPU:
parameter conversion, one decode step, the image encoder, and whole
greedy generations."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deephumor_tpu.models import CaptioningTransformer as JaxModel
from deephumor_tpu.models import transformer as jtfm
from deephumor_tpu_torch.convert.jax_params import params_from_jax
from deephumor_tpu_torch.models import CaptioningTransformer
from deephumor_tpu_torch.models import transformer as ttfm
from deephumor_tpu_torch.utils.pytree import load_params

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

HP = dict(num_tokens=211, hid_dim=128, n_layers=2, n_heads=4, pf_dim=256,
          max_len=32)
GEN = dict(max_len=30, beam_size=3, top_k=8)


def _to_jax_tree(node):
    """Inverse of params_from_jax: the port's tree in the JAX layout."""
    if isinstance(node, list):
        return [_to_jax_tree(v) for v in node]
    if "running_mean" in node:
        return {"scale": node["weight"], "bias": node["bias"],
                "mean": node["running_mean"], "var": node["running_var"]}
    if "weight" not in node:
        return {k: _to_jax_tree(v) for k, v in node.items()}
    w = node["weight"]
    if w.ndim == 4:
        return {"kernel": w.permute(2, 3, 1, 0)}
    if "bias" not in node:
        return {"table": w}
    if w.ndim == 1:
        return {"scale": w, "bias": node["bias"]}
    return {"kernel": w.T, "bias": node["bias"]}


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


@pytest.fixture(scope="module")
def models():
    tm = CaptioningTransformer(**HP)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    # a low EOS bias keeps every branch alive through the whole p_eff
    # ladder {16, 24, 32}
    tp["decoder"]["classifier"]["bias"][3] = -2.0
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _to_jax_tree(tp))
    return JaxModel(**HP), jp, tm, tp


def _images(scale, n=2):
    x = np.random.default_rng(0).normal(size=(n, 64, 64, 3))
    return (scale * x).astype(np.float32)


def test_params_from_jax_round_trip(models, tmp_path):
    jm, jp, _, tp = models
    jm.save(jp, tmp_path / "ckpt")
    tree, hp = load_params(tmp_path / "ckpt.npz")
    assert hp["model_type"] == "captioning_transformer"
    want, got = _flat(tp), _flat(params_from_jax(tree))
    assert want.keys() == got.keys() and len(want) > 100
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    # layouts: linear [in, out] -> [out, in], conv HWIO -> OIHW
    fc = jp["decoder"]["layers"][0]["self_attn"]["fc_q"]["kernel"]
    np.testing.assert_array_equal(
        tp["decoder"]["layers"][0]["self_attn"]["fc_q"]["weight"].numpy(),
        np.asarray(fc).T)
    conv = jp["encoder"]["resnet"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        tp["encoder"]["resnet"]["conv1"]["weight"].numpy(),
        np.asarray(conv).transpose(3, 2, 0, 1))


def test_encoder_matches_jax(models):
    jm, jp, tm, tp = models
    imgs = _images(1.0)
    want = jm.encode(jp, jnp.asarray(imgs))
    got = tm.encode(tp, torch.from_numpy(imgs))
    assert got[1].shape == (2, 4, HP["hid_dim"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("pos,p_eff", [(9, 16), (20, 24)])
def test_decode_step_matches_jax_pallas_interpret(models, pos, p_eff):
    _, jp, _, tp = models
    items, beam, t_enc, d, mp = 2, 3, 5, HP["hid_dim"], 31
    rows, p = items * beam, 32
    rng = np.random.default_rng(pos)
    emb = rng.normal(size=(rows, d)).astype(np.float32)
    spatial = rng.normal(size=(items, t_enc, d)).astype(np.float32)
    spatial[1, 2, 0] = 0.0  # a masked encoder row
    caches = [(rng.normal(size=(rows, p, d)).astype(np.float32),
               rng.normal(size=(rows, p, d)).astype(np.float32))
              for _ in range(HP["n_layers"])]
    anc = rng.integers(0, beam, size=(items, beam, mp)).astype(np.int32)
    valid = np.zeros((rows, mp), bool)
    valid[:, :pos + 1] = rng.random((rows, pos + 1)) < 0.8
    valid[:, 0] = valid[:, pos] = True

    jdec = jp["decoder"]
    jcross = jtfm.precompute_cross_attention(jdec, jnp.asarray(spatial))
    mask = ~np.all(spatial != 0.0, axis=-1)
    want, jcache = jtfm.decode_step(
        jdec, jnp.asarray(emb), jnp.int32(pos),
        [{"k": jnp.asarray(k), "v": jnp.asarray(v)} for k, v in caches],
        jnp.asarray(valid), HP["n_heads"], cross=jcross,
        enc_key_mask=jnp.asarray(mask), anc=jnp.asarray(anc),
        attn_impl="pallas_interpret", p_eff=p_eff)

    tdec = tp["decoder"]
    tcache = [{"k": torch.tensor(k), "v": torch.tensor(v)} for k, v in caches]
    got, tcache = ttfm.decode_step(
        tdec, torch.from_numpy(emb), pos, tcache, torch.from_numpy(valid),
        HP["n_heads"], ttfm.precompute_cross_attention(
            tdec, torch.from_numpy(spatial)),
        torch.from_numpy(mask), anc=torch.from_numpy(anc).long(),
        p_eff=p_eff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for tc, jc in zip(tcache, jcache):
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   atol=1e-5)
        np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                                   atol=1e-5)


@pytest.fixture(scope="module")
def port_greedy(models):
    _, _, tm, tp = models
    return tm.generate(tp, torch.from_numpy(_images(0.05)), greedy=True,
                       **GEN)


@pytest.mark.parametrize("attn", ["pallas_interpret", "xla"])
def test_greedy_generate_matches_jax(models, port_greedy, attn):
    jm, jp, _, _ = models
    seq = port_greedy["chosen"].numpy()
    assert seq.shape == (2, GEN["max_len"]) and len(np.unique(seq)) > 5
    assert not port_greedy["ended"].any()  # every phase of the ladder ran
    want = jm.generate(jp, jnp.asarray(_images(0.05)),
                       key=jax.random.PRNGKey(0), greedy=True, attn=attn,
                       **GEN)
    np.testing.assert_array_equal(seq, np.asarray(want["chosen"]))
    np.testing.assert_array_equal(port_greedy["sequences"].numpy(),
                                  np.asarray(want["sequences"]))


def test_greedy_generate_with_prefix_matches_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(7)
    enc = (rng.normal(size=(2, HP["hid_dim"])).astype(np.float32),
           rng.normal(size=(2, 4, HP["hid_dim"])).astype(np.float32))
    prefix = rng.integers(6, HP["num_tokens"], size=(2, 4))
    want = jm.generate_from_emb(
        jp, tuple(map(jnp.asarray, enc)), key=jax.random.PRNGKey(0),
        caption=jnp.asarray(prefix, jnp.int32), greedy=True, attn="xla",
        **GEN)["chosen"]
    got = tm.generate_from_emb(
        tp, tuple(map(torch.from_numpy, enc)),
        caption=torch.from_numpy(prefix), greedy=True, **GEN)["chosen"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:, :4], prefix)


def test_pallas_sampler_generate_is_deterministic(models):
    _, _, tm, tp = models
    enc = tm.encode(tp, torch.from_numpy(_images(0.05, n=3)))

    def run(seed):
        return tm.generate_from_emb(
            tp, enc, generator=torch.Generator().manual_seed(seed),
            sampler="pallas", **GEN)

    a, b, c = run(1), run(1), run(2)
    for key in ("sequences", "chosen", "scores", "ended"):
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["sequences"], c["sequences"])
    assert (a["scores"] <= 1e-5).all() and torch.isfinite(a["scores"]).all()
    seq = a["sequences"]
    assert ((seq >= 0) & (seq < HP["num_tokens"]) & (seq != 1)).all()


def test_from_pretrained_gives_same_tokens(models, tmp_path):
    jm, jp, tm, tp = models
    jm.save(jp, tmp_path / "model.npz")
    model, params = CaptioningTransformer.from_pretrained(
        tmp_path / "model.npz", device="cpu")
    assert model == tm
    imgs = torch.from_numpy(_images(0.05))
    want = tm.generate(tp, imgs, greedy=True, **GEN)["chosen"]
    got = model.generate(params, imgs, greedy=True, **GEN)["chosen"]
    assert torch.equal(got, want)
