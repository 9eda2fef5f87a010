"""deephumor_tpu_torch's image preprocessing against the JAX package:
``preprocess_batch`` (bilinear with antialiasing on downscale, then
ImageNet normalisation) within 1e-4 at several input sizes, and
``preprocess_pil`` exactly."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from deephumor_tpu.ops import image_ops as jops
from deephumor_tpu_torch.ops import image_ops as tops

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()


def _u8(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("hw", [(300, 400), (224, 224), (150, 180),
                                (640, 480)])
def test_preprocess_batch_matches_jax(hw):
    x = _u8(2, *hw, seed=hw[0])
    want = np.asarray(jops.preprocess_batch(jnp.asarray(x)))
    got = tops.preprocess_batch(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == (2, 224, 224, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_preprocess_batch_takes_numpy_and_other_sizes():
    x = _u8(1, 120, 90, seed=3)
    np.testing.assert_array_equal(
        tops.preprocess_batch(x).numpy(),
        tops.preprocess_batch(torch.from_numpy(x)).numpy())
    assert tops.preprocess_batch(x, (64, 48)).shape == (1, 64, 48, 3)


@pytest.mark.parametrize("mode,hw", [("RGB", (300, 400)), ("L", (150, 180)),
                                     ("RGBA", (224, 224))])
def test_preprocess_pil_is_exact(mode, hw):
    arr = _u8(1, *hw, seed=7)[0]
    img = Image.fromarray(arr).convert(mode)
    want = jops.preprocess_pil(img)
    got = tops.preprocess_pil(img)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _memes_dir(root, n_templates=3):
    """A memes900k-style directory: templates.txt, images/, captions."""
    rng = np.random.default_rng(11)
    (root / "images").mkdir()
    lines = []
    for i in range(n_templates):
        name = f"tpl{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (90 + 10 * i, 120, 3),
                                     dtype=np.uint8)).save(root / "images" /
                                                           name)
        lines.append(f"Label {i}\thttp://x/{i}\thttp://img/{name}")
    (root / "templates.txt").write_text("\n".join(lines) + "\n")
    caps = [f"Label {i % (n_templates + 1)}\t{i}\tWhen you ship it, "
            f"and IT works{'!' * (i % 3)} <sep> bug {i}"
            for i in range(12)]
    (root / "captions_train.txt").write_text("\n".join(caps) + "\n")
    return root


@pytest.mark.parametrize("num_classes,preload", [(3, True), (2, False)])
def test_meme_dataset_matches_jax(tmp_path, num_classes, preload):
    from deephumor_tpu.data import Vocab as JaxVocab
    from deephumor_tpu.data.datasets import MemeDataset as JaxDataset
    from deephumor_tpu_torch.data import Vocab
    from deephumor_tpu_torch.data.datasets import MemeDataset

    root = _memes_dir(tmp_path)
    words = ["when", "you", "ship", "it", ",", "works", "label", "0", "1"]
    want = JaxDataset(str(root), JaxVocab(words), num_classes=num_classes,
                      preload_images=preload)
    got = MemeDataset(str(root), Vocab(words), num_classes=num_classes,
                      preload_images=preload)
    assert got.templates == want.templates and got.captions == want.captions
    assert len(got) == len(want) > 0
    for i in range(len(got)):
        for g, w in zip(got[i], want[i]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        MemeDataset(str(root), Vocab(words), split="dev")
