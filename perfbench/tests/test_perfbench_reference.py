"""The plain reference held to the port at small sizes on the CPU (the
port's plain paths, f32): the decoder teacher-forced, the encoder, what
generation serves, and the train step's loss, gradients and Adam. A test
file may import the port; the reference does not. The control (fp8) and
the planted faults at the cells' own sizes need the card: they run
there, marked ``cuda``, and skip here."""

import time

import pytest
import torch

from perfbench.core import captioning as cap
from perfbench.core import spec, weights
from perfbench.kinds import offline, train
from perfbench.reference import captioner as ref
from perfbench.reference import encoder as ref_encoder
from perfbench.reference import train as ref_train
from perfbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 777


def model(cfg):
    return cap.make_model(dict(cfg, compute_dtype="float32"))


def test_decoder_matches_the_port_teacher_forced():
    from deephumor_tpu_torch.models import transformer as tfm

    cfg = tiny.WORD
    params = cap.make_params(cfg, SEED, CPU, encoder=False)
    gen = torch.Generator().manual_seed(1)
    start = torch.randn(4, cfg["hid_dim"], generator=gen)
    spatial = torch.randn(4, 5, cfg["hid_dim"], generator=gen)
    tokens = torch.randint(4, cfg["num_tokens"], (4, 7), generator=gen)
    tokens[1, 3] = cap.PAD  # a pad among the fed tokens is masked
    want = tfm.transformer_decoder_forward(
        params["decoder"], tokens[:, :-1], spatial, start, cfg["n_heads"])
    got = ref.decoder_logits(params["decoder"], start, spatial, tokens,
                             cfg["n_heads"])
    torch.testing.assert_close(got, want[:, :7], rtol=1e-4, atol=1e-4)


def test_encoder_matches_the_port():
    from deephumor_tpu_torch.models.encoders import image_encoder_apply

    cfg = tiny.WORD
    params = cap.make_params(cfg, SEED, CPU, encoder=True)
    images = torch.randn(2, 64, 64, 3, generator=torch.Generator()
                         .manual_seed(2))
    want = image_encoder_apply(params["encoder"], images,
                               spatial_features=True)
    got = ref_encoder.encode(params["encoder"], images)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg", [tiny.WORD, tiny.CHAR], ids=["word", "char"])
def test_served_tokens_lie_in_the_reference_support(cfg):
    """The port's f32 generation on the CPU serves only tokens inside the
    reference's top-k support, to rounding (its classifier-in-the-draw
    path rounds the classifier to bf16, as the card's kernel does)."""
    params = cap.make_params(cfg, SEED, CPU, encoder=False)
    store, ids = offline.inputs(cfg, tiny.OFFLINE, SEED, CPU)
    rows = ids[0]
    out = model(cfg).generate_from_emb(
        params, (store[0][rows], store[1][rows]),
        generator=torch.Generator().manual_seed(3),
        **cap.generate_kwargs(cfg))
    r = cap.check(cfg, params["decoder"], (store[0][rows], store[1][rows]),
                  out["chosen"], SEED, control=True)
    assert r["tail"] == 0 and r["gap"] < 0.02 and r["tokens"] > 0


def test_the_fp8_control_reads_wider_than_f32():
    cfg = tiny.WORD
    params = cap.make_params(cfg, SEED, CPU, encoder=False)
    gen = torch.Generator().manual_seed(4)
    start = torch.randn(8, cfg["hid_dim"], generator=gen)
    spatial = torch.randn(8, 5, cfg["hid_dim"], generator=gen)
    tokens = torch.randint(6, cfg["num_tokens"], (8, 10), generator=gen)
    f32 = ref.decoder_logits(params["decoder"], start, spatial, tokens, 2)
    fp8 = ref.decoder_logits(params["decoder"], start, spatial, tokens, 2,
                             precision="fp8")
    gap = (fp8 - f32).abs().max()
    assert 1e-3 < gap < 1.0
    x = torch.linspace(0.5, 1.0, 1000)
    q = ref.fp8(x)
    # three mantissa bits: at most 8 values an octave, within 1/16
    assert q.unique().numel() <= 9 and (q - x).abs().max() <= 1 / 16


def test_train_step_matches_the_port():
    """Three steps of the port's trainer (one process, f32) against the
    reference's, from the same weights, features and batches."""
    from deephumor_tpu_torch.experiments.trainer import Trainer
    from deephumor_tpu_torch.models import CaptioningTransformer
    from deephumor_tpu_torch.utils.pytree import flatten_tree

    cfg, traffic = tiny.TRAIN_CFG, tiny.TRAIN
    m = CaptioningTransformer(
        num_tokens=cfg["num_tokens"], hid_dim=cfg["hid_dim"],
        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
        pf_dim=cfg["pf_dim"], max_len=cfg["max_len"], enc_dropout=0.0,
        dec_dropout=0.0)
    trainer = Trainer(m, phases=(), device=CPU, prefetch=0)
    state = trainer.init_state(params=train.make_params(cfg, SEED, CPU))
    trainer._trunk_cache = train.trunk_cache(traffic, SEED, CPU)
    pool = train.batches(cfg, traffic, SEED)
    gen = torch.Generator().manual_seed(5)
    losses = []
    for i in range(3):
        state, loss, _ = trainer.run_epoch(state, [pool[i]], gen)
        losses.append(loss)
        if i == 0:
            mu1 = {k: v.clone() for k, v in state["opt_state"]["mu"].items()}
    after3 = {k: v.clone() for k, v in flatten_tree(state["params"]).items()}
    r = train.judge(cfg, traffic, SEED, CPU, pool, losses, mu1, after3, 1,
                    control=True)
    assert r["loss"] < 1e-5 and r["grad"] < 1e-4 and r["change"] < 1e-4
    # the keys' biases under softmax take no gradient: not compared
    assert all(k.endswith("fc_k/bias") for k in r["still"])
    # the control and the faults planted in the reference read far wider
    assert r["control_grad"] > 100 * r["grad"]
    assert r["fault_half_grad"] > 1000 * r["grad"]


def test_leaf_gaps_and_still_leaves():
    want = {"a": torch.ones(4), "b": torch.full((4,), 2.0),
            "c": torch.full((4,), 1e-9)}
    got = {"a": torch.ones(4), "b": torch.full((4,), 2.2),
           "c": torch.zeros(4)}
    gap, key = ref_train.leaf_gaps(got, want)
    assert key == "b" and gap == pytest.approx(0.1)
    assert ref_train.still_leaves(want) == {"c"}
    # a leaf left unmoved reads 1
    assert ref_train.leaf_gaps({"a": torch.zeros(4)},
                               {"a": torch.ones(4)})[0] == 1.0


# -- on the card, at the cells' own sizes ------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["word.offline", "char.offline",
                                  "word.serve"])
def test_control_and_faults_fail_at_the_cell_size(name, card):
    """Three seeds at the cell's own size: the program reads correct, the
    fp8 control's share of tokens outside the reference's support and
    each planted fault read over the cell's limits."""
    from deephumor_tpu_torch.models import graphs

    cell = spec.cell(name)
    limits = spec.limits(name)
    kind = {"offline": offline}.get(cell.traffic["kind"])
    if kind is None:
        from perfbench.kinds import serve as kind
    for i, seed in enumerate((SEED + 11, SEED + 12, SEED + 13)):
        out = kind.run(cell, seed, 3.0, False, time.perf_counter(), card,
                       limits, control=True)
        assert out["correct"], out["checks"]
        assert (out["readings"]["control_outside_share"]
                > limits["outside_share"])
        for fault in ("token", "half"):
            graphs.clear()
            bad = kind.run(cell, seed, 2.0, False, time.perf_counter(), card,
                           limits, fault=fault)
            assert not bad["correct"], (fault, bad["checks"])
        graphs.clear()


def test_weights_are_views_of_two_buffers():
    tree = weights.make(spec.model(tiny.WORD).weight_spec(tiny.WORD, None),
                        SEED, CPU)
    leaves = ref_train.flat(tree)
    bases = {v.untyped_storage().data_ptr() for v in leaves.values()
             if v.dim() > 1}
    assert len(bases) == 2
