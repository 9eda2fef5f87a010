"""deephumor_tpu_torch's train step on the card against the same step on
the CPU (f32, TF32 off). Skipped without a CUDA device. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_cuda.py
"""

import numpy as np
import pytest
import torch

from deephumor_tpu_torch.experiments.trainer import Trainer
from deephumor_tpu_torch.models import CaptioningLSTM, CaptioningTransformer
from deephumor_tpu_torch.ops import LAUNCHES, reset_launch_counts
from deephumor_tpu_torch.utils.pytree import flatten_tree, tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _batch(from_images):
    rng = np.random.default_rng(0)
    caps = rng.integers(6, 64, (8, 12))
    caps[2, 7:] = 0
    batch = {"captions": caps}
    if from_images:
        batch["images"] = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    else:
        batch["image_rows"] = rng.integers(0, 4, (8,))
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("model", [
    CaptioningTransformer(num_tokens=64, hid_dim=64, n_layers=2, n_heads=4,
                          pf_dim=96, max_len=50, enc_dropout=0.0,
                          dec_dropout=0.0),
    CaptioningLSTM(num_tokens=64, emb_dim=32, hidden_size=32, num_layers=2,
                   enc_dropout=0.0, dec_dropout=0.0)],
    ids=["transformer_trunk", "lstm_images"])
def test_train_step_on_the_card_matches_the_cpu(cuda, tmp_path, model):
    from_images = isinstance(model, CaptioningLSTM)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    trunk = torch.randn(4, 7, 7, 2048, generator=torch.Generator()
                        .manual_seed(1))
    out = {}
    reset_launch_counts()
    for dev in ("cpu", cuda):
        trainer = Trainer(model, "c", log_dir=str(tmp_path), device=dev)
        state = trainer.init_state(params=tree_map(
            lambda t, d=dev: t.clone().to(d), params))
        trainer._trunk_cache = trunk.to(dev)
        batch = trainer._host_batch(_batch(from_images))[0]
        batch = {k: v.to(dev) for k, v in batch.items()}
        state, m = trainer._train_step(state, batch,
                                       torch.Generator(dev).manual_seed(0))
        out[str(dev)] = (m, flatten_tree(state["params"]))
        trainer.close()
    # the training path launches none of the port's kernels
    assert not any(LAUNCHES.values())
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out["cpu"], out["cuda"]
    for k in ("loss", "perplexity", "grad_norm"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-4,
                                   atol=0)
    for k, v in p_cpu.items():
        # the LSTM's head bias sits before a train-mode batch norm: its
        # gradient is exactly zero, so Adam normalises rounding noise
        if not (from_images and k == "encoder/linear/bias"):
            torch.testing.assert_close(p_gpu[k].cpu(), v, atol=2e-4, rtol=0,
                                       msg=k)
