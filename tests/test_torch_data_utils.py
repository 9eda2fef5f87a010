"""deephumor_tpu_torch's text filters and splitter against the JAX
package's: ``clean_text`` / ``check_text`` on a seeded fuzz of punctuation
runs, non-ASCII, lengths and token counts; ``english_prob`` without
``langdetect``; ``split_captions`` byte-identical files."""

import importlib.util

import numpy as np
import pytest

from deephumor_tpu.data import splits as jax_splits
from deephumor_tpu.data import utils as jax_utils
from deephumor_tpu_torch.data import splits, utils

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

PIECES = ["hello", "world", "don't", "<sep>", "<emp>", "a", "123", "_x_",
          "!", "!!!!", "?!?!?", "...", "....", "$$$$$", "###", "____",
          "--", "(", ")", "**", ",,", ";;", "~~~", "@@", "^^", "{}", "\"\"",
          "<<", ">>", "||", "\\\\", "é", "naïve", "日本", "  ", "\t", "\n"]


def _fuzz(seed, n=400):
    rng = np.random.default_rng(seed)
    texts = ["", None, "   ", "<>|\\", "a" * 120]
    for _ in range(n):
        k = int(rng.integers(0, 30))
        parts = rng.choice(PIECES, k)
        seps = rng.choice(["", " ", "  "], k)
        texts.append("".join(p + s for p, s in zip(parts, seps)))
    return texts


@pytest.mark.parametrize("seed", [0, 1])
def test_clean_text_matches_jax(seed):
    for text in _fuzz(seed):
        assert utils.clean_text(text) == jax_utils.clean_text(text), text


@pytest.mark.parametrize("limits", [(10, 100, 32), (5, 40, 8), (0, 400, 3)])
def test_check_text_matches_jax(limits):
    texts = [t for t in _fuzz(2) if t is not None]
    texts += [utils.clean_text(t) for t in texts]
    verdicts = [utils.check_text(t, *limits) for t in texts]
    assert verdicts == [jax_utils.check_text(t, *limits) for t in texts]
    assert any(verdicts) and not all(verdicts)


@pytest.mark.skipif(importlib.util.find_spec("langdetect") is not None,
                    reason="langdetect is installed")
def test_english_prob_needs_langdetect():
    for fn in (utils.english_prob, jax_utils.english_prob):
        with pytest.raises(ImportError, match="langdetect"):
            fn("a perfectly english sentence")


def _captions_file(root, seed):
    rng = np.random.default_rng(seed)
    with open(root / "captions.txt", "w") as f:
        for t in range(7):
            for i in range(int(rng.integers(3, 40))):
                f.write(f"template {t}\t{int(rng.integers(0, 99))}\tcap "
                        f"{t} {i} <sep> x\n")


@pytest.mark.parametrize("seed", [0, 7])
def test_split_captions_writes_jax_files(tmp_path, seed):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for root in (ours, theirs):
        root.mkdir()
        _captions_file(root, 5)
    splits.split_captions(str(ours), (12, 5, 4), random_state=seed)
    jax_splits.split_captions(str(theirs), (12, 5, 4), random_state=seed)
    for name in ("train", "val", "test"):
        got = (ours / f"captions_{name}.txt").read_bytes()
        assert got == (theirs / f"captions_{name}.txt").read_bytes(), name
        assert got
