"""deephumor_tpu_torch's checkpoint I/O against the JAX package: the
port's ``save`` read back by the JAX ``load_params`` and
``from_pretrained`` (and by the port), and ``from_torch`` on reference
``.pth`` files (built by tests/torch_oracles.py) equal to the JAX
``from_torch``: the same parameters and greedy tokens."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deephumor_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from deephumor_tpu.utils.pytree import flatten_tree as jax_flatten
from deephumor_tpu.utils.pytree import load_params as jax_load_params
from deephumor_tpu.utils.pytree import save_params as jax_save_params
from deephumor_tpu_torch.convert.jax_params import (params_from_jax,
                                                    params_to_jax)
from deephumor_tpu_torch.models import MODEL_REGISTRY
from deephumor_tpu_torch.utils.pytree import (flatten_tree, load_params,
                                              save_params)
from torch_oracles import (OracleCaptioningLSTM,
                           OracleCaptioningLSTMWithLabels,
                           OracleCaptioningTransformer,
                           OracleCaptioningTransformerBase,
                           randomize_bn_stats)

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

VOCAB, MAX_LEN = 30, 10
ORACLES = {
    "captioning_lstm": OracleCaptioningLSTM,
    "captioning_lstm_labels": OracleCaptioningLSTMWithLabels,
    "captioning_transformer_base": OracleCaptioningTransformerBase,
    "captioning_transformer": OracleCaptioningTransformer,
}
SMALL_HP = {
    "captioning_lstm": dict(num_tokens=VOCAB, emb_dim=16, hidden_size=24,
                            num_layers=2),
    "captioning_lstm_labels": dict(num_tokens=VOCAB, emb_dim=16,
                                   hidden_size=24, num_layers=1),
    "captioning_transformer_base": dict(num_tokens=VOCAB, hid_dim=16,
                                        n_layers=2, n_heads=4, pf_dim=24,
                                        max_len=16),
    "captioning_transformer": dict(num_tokens=VOCAB, hid_dim=16, n_layers=1,
                                   n_heads=2, pf_dim=24, max_len=16,
                                   compute_dtype="bfloat16"),
}


def _flat_port(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}/{k}"))
    return out


def _assert_same_port_trees(a, b):
    fa, fb = _flat_port(a), _flat_port(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("model_type", list(SMALL_HP))
def test_port_save_reads_back_in_jax_and_port(model_type, tmp_path):
    model = MODEL_REGISTRY[model_type](**SMALL_HP[model_type])
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    path = tmp_path / "ckpt"
    model.save(params, path)
    # the JAX package's reader: its layout, its hyperparameters
    tree, hp = jax_load_params(str(path))
    assert hp == {"model_type": model.model_type, **model.hp()}
    assert ("compute_dtype" in hp) == (model.compute_dtype != "float32")
    jax_model, jax_params = JAX_REGISTRY[model_type].from_pretrained(
        str(path))
    assert jax_model.hp() == model.hp()
    want = jax_flatten(jax.tree.map(np.asarray, jax_params))
    got = jax_flatten(params_to_jax(params))
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == np.float32
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    # the JAX model's own init has this layout too
    init = jax_flatten(jax.eval_shape(jax_model.init,
                                      jax.random.PRNGKey(0)))
    assert {k: v.shape for k, v in init.items()} == {
        k: v.shape for k, v in want.items()}
    # and the port reads its own checkpoint back to the same tensors
    model2, params2 = MODEL_REGISTRY[model_type].from_pretrained(
        path, device="cpu")
    assert model2 == model
    _assert_same_port_trees(params2, params)


def test_save_params_and_flatten_match_jax(tmp_path):
    tree = {"a": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
                  {"w": np.ones(2, np.float32)}],
            "b": {"c": np.zeros((1, 1), np.float32)}}
    assert flatten_tree(tree).keys() == jax_flatten(tree).keys()
    for name in ("port.npz", "port2"):
        save_params(tmp_path / name, tree, hp={"x": 1})
        loaded, hp = jax_load_params(str(tmp_path / name))
        assert hp == {"x": 1}
        for k, v in jax_flatten(tree).items():
            np.testing.assert_array_equal(jax_flatten(loaded)[k], v)
    jax_save_params(str(tmp_path / "jax"), tree, hp={"y": 2})
    loaded, hp = load_params(tmp_path / "jax")
    assert hp == {"y": 2}
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(flatten_tree(loaded)[k], v)


@pytest.mark.parametrize("model_type", list(ORACLES))
def test_from_torch_matches_jax(model_type, tmp_path):
    torch.manual_seed(sum(map(ord, model_type)))
    oracle = ORACLES[model_type](VOCAB).eval()
    randomize_bn_stats(oracle, torch.Generator().manual_seed(11))
    ckpt = tmp_path / "model.pth"
    torch.save({"model": oracle.state_dict(), "hp": oracle.hp}, ckpt)

    jax_model, jax_params = JAX_REGISTRY[model_type].from_torch(str(ckpt))
    model, params = MODEL_REGISTRY[model_type].from_torch(ckpt,
                                                          device="cpu")
    assert model.hp() == jax_model.hp()
    _assert_same_port_trees(
        params, params_from_jax(jax.tree.map(np.asarray, jax_params)))

    g = torch.Generator().manual_seed(12)
    image = torch.randn(1, 3, 64, 64, generator=g)
    nhwc = image.permute(0, 2, 3, 1).contiguous()
    kw = dict(max_len=MAX_LEN, beam_size=1, top_k=VOCAB, greedy=True)
    with torch.no_grad():
        if model_type == "captioning_lstm_labels":
            labels = torch.randint(6, VOCAB, (1, 3), generator=g)
            ref = oracle.greedy_decode(image, labels, MAX_LEN)
            got = model.generate(params, nhwc, labels, **kw)
            want = jax_model.generate(
                jax_params, jnp.asarray(nhwc.numpy()),
                labels=jnp.asarray(labels.numpy()), **kw)
        else:
            ref = oracle.greedy_decode(image, MAX_LEN)
            got = model.generate(params, nhwc, **kw)
            want = jax_model.generate(jax_params, jnp.asarray(nhwc.numpy()),
                                      **kw)
    got = got["chosen"][0].numpy()
    np.testing.assert_array_equal(got, np.asarray(want["chosen"][0]))
    assert list(got[:len(ref)]) == ref
