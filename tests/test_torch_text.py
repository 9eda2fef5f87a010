"""deephumor_tpu_torch's text core against the JAX package: the
vocabulary (ids, order, files read across packages), both tokenizers on a
fuzz of strings, and the inference text helpers."""

import numpy as np
import pytest
import torch

import deephumor_tpu_torch
from deephumor_tpu import data as jdata
from deephumor_tpu.experiments import inference as jinf
from deephumor_tpu_torch import data as tdata
from deephumor_tpu_torch.experiments import inference as tinf

from deephumor_tpu_torch.ops.testing import cap_test_threads

cap_test_threads()

ALPHABET = list("abcxyz ABC'!?.,;:-<>_0123456789\té中") + [
    "<sep>", "<emp>", "<eos>", "<unk>", " ", " "]


def _fuzz(n, seed=0, max_len=40):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(ALPHABET, size=rng.integers(0, max_len)))
            for _ in range(n)]


def _vocab_pair(tokens):
    return jdata.Vocab(tokens), tdata.Vocab(tokens)


def test_special_ids_and_constants_match():
    assert tdata.SPECIAL_TOKENS == jdata.SPECIAL_TOKENS
    assert ((tdata.PAD_ID, tdata.UNK_ID, tdata.BOS_ID, tdata.EOS_ID,
             tdata.SEP_ID, tdata.EMP_ID)
            == (jdata.PAD_ID, jdata.UNK_ID, jdata.BOS_ID, jdata.EOS_ID,
                jdata.SEP_ID, jdata.EMP_ID))
    # the package's constants are the vocabulary's
    assert ((deephumor_tpu_torch.PAD, deephumor_tpu_torch.UNK,
             deephumor_tpu_torch.BOS, deephumor_tpu_torch.EOS)
            == (tdata.PAD_ID, tdata.UNK_ID, tdata.BOS_ID, tdata.EOS_ID))


def test_vocab_order_and_ids_match():
    words = [w for s in _fuzz(50, seed=1) for w in s.split()] + ["<sep>"]
    jv, tv = _vocab_pair(words)
    assert tv.tokens == jv.tokens and tv.stoi == jv.stoi
    assert tv.itos == jv.itos and len(tv) == len(jv)
    assert list(tv) == list(jv) and ("<sep>" in tv) == ("<sep>" in jv)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_vocab_files_read_across_packages(writer, tmp_path):
    words = [w for s in _fuzz(30, seed=2) for w in s.split()]
    jv, tv = _vocab_pair(words)
    path = tmp_path / "vocab.txt"
    if writer == "port":
        tv.save(path)
        loaded = jdata.Vocab.load(path)
    else:
        jv.save(path)
        loaded = tdata.Vocab.load(path)
    assert loaded.tokens == jv.tokens


@pytest.mark.parametrize("tok", ["WordPunctTokenizer", "CharTokenizer"])
def test_build_vocab_from_file_matches(tok, tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "captions.txt"
    # a caption holds no tab: the TSV's separator
    lines = [f"label{i % 4}\t{rng.integers(0, 100)}\t"
             f"{text.replace(chr(9), ' ').strip() or 'x'}"
             for i, text in enumerate(_fuzz(120, seed=3))]
    path.write_text("\n".join(lines) + "\n")
    for min_df in (1, 3, 7):
        want = jdata.build_vocab_from_file(path, getattr(jdata, tok)(),
                                           min_df=min_df)
        got = tdata.build_vocab_from_file(path, getattr(tdata, tok)(),
                                          min_df=min_df)
        assert got.tokens == want.tokens


@pytest.mark.parametrize("tok", ["WordPunctTokenizer", "CharTokenizer"])
def test_tokenizers_match_on_fuzz(tok):
    jt, tt = getattr(jdata, tok)(), getattr(tdata, tok)()
    assert isinstance(tt, tdata.Tokenizer)
    for text in _fuzz(300, seed=4):
        assert tt.tokenize(text) == jt.tokenize(text), repr(text)


@pytest.mark.parametrize("tok", ["WordPunctTokenizer", "CharTokenizer"])
def test_text_to_seq_and_back_match(tok):
    texts = _fuzz(200, seed=5)
    jt, tt = getattr(jdata, tok)(), getattr(tdata, tok)()
    # a vocabulary that misses some tokens, so UNK shows up
    tokens = [t for s in texts[:100] for t in jt.tokenize(s.lower())]
    jv, tv = _vocab_pair(tokens)
    delim = " " if tok == "WordPunctTokenizer" else ""
    for text in texts:
        want = jinf.text_to_seq(text, jv, jt)
        got = tinf.text_to_seq(text, tv, tt)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert (tinf.seq_to_text(got[0], tv, delim)
                == jinf.seq_to_text(want[0], jv, delim))


def test_seq_to_text_cuts_at_eos_and_takes_cpu_tensors():
    jv, tv = _vocab_pair(["a", "b", "c"])
    rng = np.random.default_rng(6)
    for _ in range(50):
        seq = rng.integers(0, len(tv), size=rng.integers(0, 12))
        want = jinf.seq_to_text(seq, jv)
        assert tinf.seq_to_text(seq, tv) == want
        assert tinf.seq_to_text(torch.from_numpy(seq), tv) == want


def test_split_caption_matches():
    rng = np.random.default_rng(7)
    parts = ["when you", "<sep>", " ship it ", "<emp>", " , ", "!!", "<eos>",
             "<sep>", "and ...", "it works ?", "<unk>", "x"]
    texts = ["".join(rng.choice(parts, size=rng.integers(0, 10)))
             for _ in range(200)] + _fuzz(100, seed=8)
    for text in texts:
        for blocks in (None, 1, 2, 3, 5):
            assert (tinf.split_caption(text, blocks)
                    == jinf.split_caption(text, blocks)), (text, blocks)
