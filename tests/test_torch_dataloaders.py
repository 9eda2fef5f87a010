"""deephumor_tpu_torch's data layer for training against the JAX
package's: ``pad_ids`` / ``pad_collate``, ``MemeDataset.materialize`` and
``BatchIterator`` (the same batches over two epochs, with a padded tail's
``row_valid`` and trunk-cache ``image_rows``), and the training entry
point, ``python -m deephumor_tpu_torch.train``, for one epoch on the CPU,
whose checkpoints the JAX package reads."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from deephumor_tpu.data import Vocab as JaxVocab
from deephumor_tpu.data.dataloaders import BatchIterator as JaxBatchIterator
from deephumor_tpu.data.dataloaders import pad_collate as jax_pad_collate
from deephumor_tpu.data.datasets import MemeDataset as JaxMemeDataset
from deephumor_tpu.experiments.trainer import Trainer as JaxTrainer
from deephumor_tpu.models import CaptioningLSTM as JaxLSTM
from deephumor_tpu_torch.convert.jax_params import params_to_jax
from deephumor_tpu_torch.data import Vocab
from deephumor_tpu_torch.data.dataloaders import (BatchIterator, pad_collate,
                                                  pad_ids)
from deephumor_tpu_torch.data.datasets import MemeDataset
from deephumor_tpu_torch.models import CaptioningLSTM
from deephumor_tpu_torch.utils.pytree import flatten_tree

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["hello", "world", "bye", "one", "does", "not", "simply", "grumpy",
         "cat", "0", "1", "2", "3"]


@pytest.fixture
def data_root(tmp_path):
    """The fixture dataset of tests/test_training.py: two templates, four
    train captions, two val."""
    root = tmp_path / "memes"
    (root / "images").mkdir(parents=True)
    templates = [("one-does-not-simply", "http://x/one.jpg"),
                 ("grumpy-cat", "http://x/cat.jpg")]
    with open(root / "templates.txt", "w") as f:
        for label, url in templates:
            f.write(f"{label}\tlink\t{url}\n")
            Image.new("RGB", (80, 60), (100, 50, 20)).save(
                root / "images" / url.split("/")[-1])
    for split, k in (("train", 4), ("val", 2)):
        with open(root / f"captions_{split}.txt", "w") as f:
            for i in range(k):
                f.write(f"{templates[i % 2][0]}\t{i}\thello world {i} <sep> "
                        f"bye\n")
    return str(root)


def _datasets(root):
    return (MemeDataset(root, Vocab(WORDS), split="train"),
            JaxMemeDataset(root, JaxVocab(WORDS), split="train"))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("lengths", [(10, 6), (4, 2)],
                         ids=["padded", "truncated"])
def test_materialize_matches_jax(data_root, lengths):
    ds, jds = _datasets(data_root)
    got, want = ds.materialize(*lengths), jds.materialize(*lengths)
    assert got["image_keys"] == want["image_keys"]
    for k in ("captions", "labels"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert ds.materialize(*lengths) is got


@pytest.mark.parametrize("mode", ["images", "image_rows", "collate"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_iterator_matches_jax_over_two_epochs(data_root, mode,
                                                    drop_last):
    ds, jds = _datasets(data_root)
    kw = dict(batch_size=3, max_caption_len=10, max_label_len=6, seed=5,
              drop_last=drop_last, fast=mode != "collate")
    if mode == "image_rows":
        kw["image_rows"] = {k: i for i, k in enumerate(ds.images)}
    it, jit = BatchIterator(ds, **kw), JaxBatchIterator(jds, **kw)
    assert len(it) == len(jit) == (1 if drop_last else 2)
    for _ in range(2):
        got, want = list(it), list(jit)
        _assert_batches_equal(got, want)
    if not drop_last:
        np.testing.assert_array_equal(got[-1]["row_valid"], [1, 0, 0])
    if mode == "image_rows":
        assert "images" not in got[0]
        assert got[0]["image_rows"].dtype == np.int32


def test_image_rows_need_the_fast_path(data_root):
    ds, _ = _datasets(data_root)
    with pytest.raises(ValueError, match="fast path"):
        BatchIterator(ds, 2, fast=False, image_rows={})


def test_pad_ids_and_collate_match_jax():
    seqs = [np.arange(3), np.arange(12), np.arange(0)]
    out = pad_ids(seqs, 8, pad_value=0)
    assert out.dtype == np.int32 and out.shape == (3, 8)
    np.testing.assert_array_equal(out[1], np.arange(8))
    batch = [(np.arange(3, dtype=np.int32), np.arange(12, dtype=np.int32),
              np.zeros((4, 4, 3), np.float32)),
             (np.arange(1, dtype=np.int32), np.arange(5, dtype=np.int32),
              np.ones((4, 4, 3), np.float32))]
    for lengths in ((8, 2), (None, None)):
        _assert_batches_equal([pad_collate(batch, *lengths)],
                              [jax_pad_collate(batch, *lengths)])


def test_train_entry_point_one_epoch_on_the_cpu(data_root, tmp_path):
    logs = tmp_path / "logs"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "deephumor_tpu_torch.train", "--data-dir",
         data_root, "--min-df", "1", "--epochs", "1", "--batch-size", "2",
         "--log-dir", str(logs), "--title", "t", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Best val_loss" in proc.stdout
    (exp,) = glob.glob(str(logs / "t@*"))
    tags = [json.loads(line)["tag"] for line in open(
        os.path.join(exp, "train", "metrics.jsonl"))]
    assert tags.count("train/batch_loss") == 2
    assert "eval/loss" in [json.loads(line)["tag"] for line in open(
        os.path.join(exp, "val", "metrics.jsonl"))]
    # the best model: the JAX package's from_pretrained reads it
    jmodel, jparams = JaxLSTM.from_pretrained(os.path.join(exp, "t.best"))
    model, params = CaptioningLSTM.from_pretrained(
        os.path.join(exp, "t.best"), device="cpu")
    assert jmodel.hp() == model.hp()
    assert jmodel.num_tokens == len(Vocab.load(os.path.join(
        data_root, "vocab_word.txt")))
    want = flatten_tree(params_to_jax(params))
    got = flatten_tree(jax.device_get(jparams))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the epoch's train state: the JAX Trainer restores it
    jstate = JaxTrainer(jmodel, "r", log_dir=str(tmp_path / "r")) \
        .restore_checkpoint(os.path.join(exp, "t.e1"))
    assert int(jstate["step"]) == 2
    np.testing.assert_array_equal(
        jstate["params"]["decoder"]["classifier"]["bias"],
        params["decoder"]["classifier"]["bias"].numpy())
    assert torch.isfinite(params["decoder"]["classifier"]["weight"]).all()
