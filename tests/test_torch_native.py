"""deephumor_tpu_torch's C++ text core against the JAX package's and
against its own Python path: ids and lengths (word and char, truncation,
EOS), the routing of non-ASCII text, ``materialize`` equal to JAX's, a
compiler that fails (raises, no fallback), no compiler (the Python path),
one build for threads that ask together, and the library's place under
``build/deephumor_tpu_torch/``."""

import pathlib
import random
import shutil
import string
import threading

import numpy as np
import pytest

from deephumor_tpu import native as jax_native
from deephumor_tpu.data import Vocab as JaxVocab
from deephumor_tpu.data.datasets import MemeDataset as JaxMemeDataset
from deephumor_tpu.data.tokenizers import CharTokenizer as JaxCharTokenizer
from deephumor_tpu.data.tokenizers import \
    WordPunctTokenizer as JaxWordPunctTokenizer
from deephumor_tpu_torch import native
from deephumor_tpu_torch.data import (CharTokenizer, Vocab,
                                      WordPunctTokenizer)
from deephumor_tpu_torch.data.datasets import MemeDataset
from deephumor_tpu_torch.ops import _build

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

ROOT = pathlib.Path(__file__).resolve().parents[1]
HAS_GXX = shutil.which("g++") is not None

CORPUS = ["when you ship it <sep> and it works", "don't stop... me now!!",
          "a<sep>b<emp> <unk> <bos>", "punct-run: ?!?!?! (nice)   spaced\tout",
          "<notaspecial <sep> x>y<z>", "'' '' ''' _under_score_ 123abc", "<>",
          "", "\nnew\nlines\n", "x" * 200, "One Does Not Simply <SEP> WALK"]


def _texts(seed, n=300):
    rng = random.Random(seed)
    alphabet = (string.ascii_letters + string.digits
                + "_<>' .,!?-#$%&/:;\t")
    return CORPUS + ["".join(rng.choice(alphabet)
                             for _ in range(rng.randint(0, 80)))
                     for _ in range(n)]


def _vocab(texts, tok, cls):
    """A vocabulary of the texts' tokens less every seventh, which become
    UNK."""
    tokens = sorted({t for s in texts for t in tok.tokenize(s.lower())})
    return cls([t for i, t in enumerate(tokens) if i % 7])


@pytest.mark.parametrize("mode,max_len,append_eos",
                         [("word", 32, True), ("word", 6, True),
                          ("word", 16, False), ("char", 128, True),
                          ("char", 12, True), ("char", 40, False)])
def test_encode_batch_matches_jax_and_python_path(mode, max_len, append_eos):
    texts = _texts(len(mode) + max_len)
    tok, jtok = ((WordPunctTokenizer(), JaxWordPunctTokenizer())
                 if mode == "word" else (CharTokenizer(), JaxCharTokenizer()))
    vocab, jvocab = _vocab(texts, tok, Vocab), _vocab(texts, jtok, JaxVocab)
    assert vocab.tokens == jvocab.tokens
    got = native.encode_batch(texts, vocab, mode, max_len,
                              append_eos=append_eos)
    want = jax_native.encode_batch(texts, jvocab, mode, max_len,
                                   append_eos=append_eos)
    python = native._python_encode([t.lower() for t in texts], vocab, tok,
                                   max_len, 1, 3, append_eos, 0)
    for g, w, p in zip(got, want, python):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    ids, lens = got
    assert (lens == max_len).any() and (ids == 1).any()  # cut rows, UNKs
    assert ((ids == 3).any(axis=1) == append_eos).any()


def test_non_ascii_takes_the_python_path(monkeypatch):
    vocab = Vocab(["hello", "world", "é"])
    texts = ["héllo wörld", "hello world"]
    want = native._python_encode(texts, vocab, WordPunctTokenizer(), 8, 1, 3,
                                 True, 0)

    def refuse(*args, **kwargs):
        raise AssertionError("the C++ encoder saw a non-ASCII batch")

    monkeypatch.setattr(native.NativeVocabEncoder, "encode", refuse)
    got = native.encode_batch(texts, vocab, "word", 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if HAS_GXX:  # an ASCII batch does reach the C++ encoder
        with pytest.raises(AssertionError, match="C\\+\\+ encoder"):
            native.encode_batch(texts[1:], vocab, "word", 8)


class _SplitOnSpaces(WordPunctTokenizer):
    """A tokenizer of another type: ``materialize`` takes it item by item."""

    def tokenize(self, text):
        return text.split()


class _JaxSplitOnSpaces(JaxWordPunctTokenizer):
    def tokenize(self, text):
        return text.split()


def _dataset_dir(root):
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(3)
    words = ["cat", "grumpy", "no", "yes", "I", "had", "fun", "once", "!"]
    with open(root / "templates.txt", "w") as f:
        for t in range(3):
            f.write(f"Grumpy Cat {t}\tlink\thttp://x/{t}.jpg\n")
    with open(root / "captions_train.txt", "w") as f:
        for i in range(40):
            n = int(rng.integers(1, 14))
            text = " ".join(rng.choice(words + ["zzz", "NOPE"], n))
            f.write(f"Grumpy Cat {i % 3}\t{i}\t{text} <sep> {text[::-1]}\n")
    return str(root)


@pytest.mark.parametrize("kind", ["word", "char", "other"])
def test_materialize_matches_jax(tmp_path, kind, monkeypatch):
    root = _dataset_dir(tmp_path / "memes")
    tok, jtok = {"word": (WordPunctTokenizer(), JaxWordPunctTokenizer()),
                 "char": (CharTokenizer(), JaxCharTokenizer()),
                 "other": (_SplitOnSpaces(), _JaxSplitOnSpaces())}[kind]
    lines = (pathlib.Path(root) / "captions_train.txt").read_text()
    vocab = _vocab(lines.split("\n"), tok, Vocab)
    jvocab = _vocab(lines.split("\n"), jtok, JaxVocab)
    ds = MemeDataset(root, vocab, tokenizer=tok, preload_images=False)
    jds = JaxMemeDataset(root, jvocab, tokenizer=jtok, preload_images=False)
    calls = []
    encode = native.encode_batch
    monkeypatch.setattr(native, "encode_batch",
                        lambda *a, **k: calls.append(a[2]) or encode(*a, **k))
    got, want = ds.materialize(24, 6), jds.materialize(24, 6)
    assert calls == ([] if kind == "other" else [kind, kind])
    assert got["image_keys"] == want["image_keys"]
    for k in ("captions", "labels"):
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture
def fresh_source(tmp_path, monkeypatch):
    """The text core's source copied under ``tmp_path`` (its own digest)
    with the library built into ``tmp_path / build``."""
    src = tmp_path / "dh_text.cpp"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.skipif(not HAS_GXX, reason="needs g++")
def test_a_failing_compiler_raises_and_does_not_fall_back(fresh_source):
    fresh_source.write_text(fresh_source.read_text()
                            + "\nthis is not C++;\n")
    for call in (native.available,
                 lambda: native.encode_batch(["a b"], Vocab(["a"]), "word")):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
            call()
        assert "this is not C++" in str(err.value)
    assert not list((fresh_source.parent / "build").glob("*.so"))


def test_without_a_compiler_the_python_path_runs(fresh_source, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    vocab = Vocab(["hello", "world"])
    assert not native.available()
    assert not native.build()
    got = native.encode_batch(["Hello big world!"], vocab, "word", 6)
    np.testing.assert_array_equal(got[0], [[6, 1, 7, 1, 3, 0]])
    with pytest.raises(RuntimeError, match="no\\s+g\\+\\+"):
        native.NativeVocabEncoder(vocab.tokens)


@pytest.mark.skipif(not HAS_GXX, reason="needs g++")
def test_threads_asking_together_build_once(fresh_source, monkeypatch):
    runs = []
    run = native.subprocess.run

    def counted(cmd, **kwargs):
        runs.append(cmd)
        return run(cmd, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", counted)
    barrier = threading.Barrier(8)
    libs = []

    def ask():
        barrier.wait(timeout=30)
        libs.append(native.library())

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(runs) == 1 and len(libs) == 8
    assert all(lib is libs[0] and lib is not None for lib in libs)


@pytest.mark.skipif(not HAS_GXX, reason="needs g++")
def test_library_lands_under_the_build_directory():
    assert native.available()
    so = native._library_path(native.SOURCE, native.BUILD_DIR)
    assert native.BUILD_DIR == _build.BUILD_DIR
    assert _build.BUILD_DIR == ROOT / "build" / "deephumor_tpu_torch"
    assert so.parent == _build.BUILD_DIR and so.exists()
    assert so.name.startswith("libdh_text_")
    src_dir = ROOT / "deephumor_tpu_torch" / "native"
    assert not list(src_dir.glob("*.so"))
