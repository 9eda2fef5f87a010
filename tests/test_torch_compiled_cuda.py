"""deephumor_tpu_torch's captured decode loop (models/graphs.py) on the
card against the eager loop (``compiled=False``): the same outputs from
the same generator, and the same kernel launches per call. Skipped
without a CUDA device. This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_compiled_cuda.py
"""

import pytest
import torch

from deephumor_tpu_torch.models import (CaptioningLSTM,
                                        CaptioningTransformer,
                                        CaptioningTransformerBase, graphs)
from deephumor_tpu_torch.ops import LAUNCHES, reset_launch_counts

GEN = dict(max_len=24, beam_size=3, top_k=8, temperature=1.1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    graphs.clear()
    yield torch.device("cuda")
    graphs.clear()
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _model(kind, dev, vocab=300, dtype="bfloat16", eos_bias=0.5):
    if kind == "lstm":
        model = CaptioningLSTM(num_tokens=vocab, emb_dim=64, hidden_size=64,
                               num_layers=2, compute_dtype=dtype)
    else:
        cls = (CaptioningTransformer if kind == "word"
               else CaptioningTransformerBase)
        model = cls(num_tokens=vocab, hid_dim=64, n_layers=2, n_heads=2,
                    pf_dim=128, max_len=40, compute_dtype=dtype)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    params["decoder"]["classifier"]["bias"][3] = eos_bias
    g = torch.Generator(dev).manual_seed(1)
    enc = torch.randn(16, 64, generator=g, device=dev)
    if kind == "word":
        enc = (enc, torch.randn(16, 49, 64, generator=g, device=dev))
    return model, params, enc


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["word", "base", "lstm"])
@pytest.mark.parametrize("sampler,greedy", [("pallas", False),
                                            ("exact", False),
                                            ("exact", True)])
@pytest.mark.parametrize("eos_bias", [-10.0, 4.0])
def test_captured_equals_eager(cuda, kind, sampler, greedy, eos_bias):
    # no branch ends (-10), or every branch ends within a few steps (4):
    # the eager loop then stops while each graph runs its phase to the end
    model, params, enc = _model(kind, cuda, eos_bias=eos_bias)
    outs, counts = [], []
    for compiled in (False, None, None, False):
        reset_launch_counts()
        outs.append(model.generate_from_emb(
            params, enc, generator=torch.Generator(cuda).manual_seed(7),
            compiled=compiled, sampler=sampler, greedy=greedy, **GEN))
        counts.append(dict(LAUNCHES))
    for out in outs[1:]:
        for key in ("sequences", "scores", "chosen", "ended"):
            assert torch.equal(out[key], outs[0][key]), key
    assert outs[0]["ended"].all() == (eos_bias > 0)
    # the first captured call also runs its warm-up; the second replays
    assert counts[0] == counts[3]
    if eos_bias < 0:
        assert counts[2] == counts[0]
    else:
        assert all(counts[2][k] >= n for k, n in counts[0].items())
        if any(counts[0].values()):  # the LSTM's exact draw runs none
            assert counts[2] != counts[0]
    if sampler == "pallas":
        assert any(counts[2].values())
    (info,) = graphs.cache_info()
    assert info["replays"] == 2 and info["graphs"] >= 3
    assert not info["eager_tail"]


@pytest.mark.cuda
def test_one_item_captured_equals_eager(cuda):
    # beam 3 over one item: the prefill's rows tiled per branch are copies
    model, params, enc = _model("word", cuda)
    enc = tuple(t[:1] for t in enc)
    outs = [model.generate_from_emb(
        params, enc, generator=torch.Generator(cuda).manual_seed(7),
        compiled=c, sampler="pallas", **GEN) for c in (False, None, None)]
    for out in outs[1:]:
        for key in ("sequences", "scores", "chosen", "ended"):
            assert torch.equal(out[key], outs[0][key]), key


@pytest.mark.cuda
def test_a_new_temperature_or_batch_makes_a_new_key(cuda):
    model, params, enc = _model("word", cuda)
    kw = dict(GEN, sampler="pallas")
    model.generate_from_emb(params, enc, **kw)
    model.generate_from_emb(params, enc, **dict(kw, temperature=0.7))
    model.generate_from_emb(params, tuple(t[:8] for t in enc), **kw)
    model.generate_from_emb(params, enc, **kw)
    assert [e["replays"] for e in graphs.cache_info()] == [1, 1, 2]


@pytest.mark.cuda
def test_char_captures_up_to_the_first_boundary(cuda):
    # compaction and canon: the phases before p_eff 24 are captured, the
    # rest run eagerly; the outputs and boundaries equal the eager loop's
    model = CaptioningTransformer(num_tokens=64, hid_dim=64, n_layers=2,
                                  n_heads=2, pf_dim=128, max_len=80,
                                  compute_dtype="bfloat16")
    params = model.init(torch.Generator(cuda).manual_seed(3), cuda)
    params["decoder"]["classifier"]["bias"][3] = 1.0
    g = torch.Generator(cuda).manual_seed(4)
    enc = (torch.randn(32, 64, generator=g, device=cuda),
           torch.randn(32, 49, 64, generator=g, device=cuda))
    kw = dict(max_len=72, beam_size=4, top_k=8, temperature=1.1,
              sampler="pallas")
    outs = [model.generate_from_emb(
        params, enc, generator=torch.Generator(cuda).manual_seed(5),
        compiled=c, **kw) for c in (False, None, None)]
    for out in outs[1:]:
        for key in ("sequences", "scores", "chosen", "ended"):
            assert torch.equal(out[key], outs[0][key]), key
        assert out["boundaries"] == outs[0]["boundaries"]
    (info,) = graphs.cache_info()
    # the phases through p_eff 16 and 24; the first boundary follows
    assert info["eager_tail"] and info["captured_segments"] == 2
