"""The text core: batch tokenization and vocabulary encoding in C++.

Counterpart of deephumor_tpu/native/__init__.py, with the same API. The
source ``dh_text.cpp`` (beside this file) is built with ``g++`` at first
use into ``build/deephumor_tpu_torch/`` at the repository root (the
kernel library's directory, ``ops/_build.BUILD_DIR``), named by a digest
of the source and flags, and loaded with ``ctypes``. The build runs
under a lock, so threads that ask for the library together build it once;
a concurrent process writes its own temporary file and renames it.

- Without ``g++`` (and no library built already) :func:`available` is
  False and :func:`encode_batch` takes the Python path.
- A ``g++`` that is present but fails to compile raises, with its log: a
  broken build is a fault, not a reason to run slower.
- Non-ASCII texts take the Python path: the scanners implement the ASCII
  restriction of the tokenizers' regexes, and Python's ``\\w`` is
  unicode-aware.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import weakref

import numpy as np

from deephumor_tpu_torch.data.tokenizers import (CharTokenizer,
                                                 WordPunctTokenizer)
from deephumor_tpu_torch.data.vocab import EOS_ID, UNK_ID
from deephumor_tpu_torch.ops._build import BUILD_DIR

__all__ = ["available", "build", "NativeVocabEncoder", "encode_batch"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "dh_text.cpp")
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

# tokenizer modes (must match dh_text.cpp)
MODE_WORD = 0
MODE_CHAR = 1

_LOCK = threading.Lock()


def _library_path(source, build_dir):
    with open(source, "rb") as f:
        digest = hashlib.sha256(" ".join(FLAGS).encode() + f.read())
    return build_dir / f"libdh_text_{digest.hexdigest()[:16]}.so"


def _compile(source, so):
    """Builds ``so`` from ``source``; False when there is no ``g++``,
    RuntimeError (with the compiler's output) when it fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source} "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return True


@functools.lru_cache(maxsize=None)
def _library(source, build_dir):
    so = _library_path(source, build_dir)
    if not so.exists() and not _compile(source, so):
        return None
    lib = ctypes.CDLL(str(so))
    lib.dh_vocab_create.restype = ctypes.c_void_p
    lib.dh_vocab_create.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.dh_vocab_free.restype = None
    lib.dh_vocab_free.argtypes = [ctypes.c_void_p]
    lib.dh_vocab_lookup.restype = ctypes.c_int32
    lib.dh_vocab_lookup.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dh_encode_batch.restype = ctypes.c_int64
    lib.dh_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int32, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    return lib


def library():
    """The loaded library, built first if needed; None without ``g++``."""
    with _LOCK:
        return _library(SOURCE, BUILD_DIR)


def build(force=False):
    """Compiles the library (a no-op when this source's is built, unless
    ``force``). Returns False without ``g++``; raises if it fails."""
    so = _library_path(SOURCE, BUILD_DIR)
    with _LOCK:
        if so.exists() and not force:
            return True
        built = _compile(SOURCE, so)
        _library.cache_clear()
        return built


def available(autobuild=True):
    """True when the library loads (built at this call when needed and
    ``autobuild``)."""
    if not autobuild and not _library_path(SOURCE, BUILD_DIR).exists():
        return False
    return library() is not None


def _pack(texts):
    """Concatenated utf-8 blob + int64 offsets of a list of strings."""
    encoded = [t.encode("utf-8") for t in texts]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def _int64_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _int32_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeVocabEncoder:
    """A vocabulary held by the library; encodes text batches to id
    matrices."""

    def __init__(self, vocab_tokens):
        lib = library()
        if lib is None:
            raise RuntimeError("the text core is not built and there is no "
                               "g++ to build it")
        self._lib = lib
        blob, offsets = _pack(list(vocab_tokens))
        self._handle = lib.dh_vocab_create(blob, _int64_ptr(offsets),
                                           len(vocab_tokens))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.dh_vocab_free(handle)
            self._handle = None

    def encode(self, texts, mode, max_len, unk_id=UNK_ID, eos_id=EOS_ID,
               append_eos=True, pad_id=0):
        """``(ids [n, max_len] int32 padded, lengths [n] int32)``. The texts
        must be lowercased ASCII (:func:`encode_batch` routes the others
        to the Python path)."""
        blob, offsets = _pack(texts)
        n = len(texts)
        out_ids = np.full((n, max_len), pad_id, np.int32)
        out_lens = np.zeros(n, np.int32)
        self._lib.dh_encode_batch(
            self._handle, mode, unk_id, eos_id, int(append_eos), pad_id,
            blob, _int64_ptr(offsets), n, max_len, _int32_ptr(out_ids),
            _int32_ptr(out_lens))
        return out_ids, out_lens


def _python_encode(texts, vocab, tokenizer, max_len, unk_id, eos_id,
                   append_eos, pad_id):
    """The Python path of :func:`encode_batch` (texts already
    lowercased)."""
    n = len(texts)
    out_ids = np.full((n, max_len), pad_id, np.int32)
    out_lens = np.zeros(n, np.int32)
    for i, text in enumerate(texts):
        ids = [vocab.stoi.get(tok, unk_id)
               for tok in tokenizer.tokenize(text)][:max_len]
        if append_eos and len(ids) < max_len:
            ids.append(eos_id)
        out_ids[i, :len(ids)] = ids
        out_lens[i] = len(ids)
    return out_ids, out_lens


# one library-side vocabulary per Vocab object, released with it
_ENCODERS = weakref.WeakKeyDictionary()


def encode_batch(texts, vocab, tokenizer_mode="word", max_len=32,
                 append_eos=True, lowercase=True, pad_id=0, unk_id=UNK_ID,
                 eos_id=EOS_ID):
    """Texts -> ``(ids [n, max_len] int32 padded, lengths [n] int32)``:
    lowercase -> tokenize -> UNK for unknown tokens -> EOS when there is
    room -> ids, cut to ``max_len`` (``MemeDataset``'s preprocessing). In
    C++ when the library is available and every text is ASCII, else in
    Python, with the same ids."""
    if lowercase:
        texts = [t.lower() for t in texts]
    if library() is not None and all(t.isascii() for t in texts):
        encoder = _ENCODERS.get(vocab)
        if encoder is None:
            encoder = _ENCODERS[vocab] = NativeVocabEncoder(vocab.tokens)
        mode = MODE_WORD if tokenizer_mode == "word" else MODE_CHAR
        return encoder.encode(texts, mode, max_len, unk_id, eos_id,
                              append_eos, pad_id)
    tokenizer = (WordPunctTokenizer() if tokenizer_mode == "word"
                 else CharTokenizer())
    return _python_encode(texts, vocab, tokenizer, max_len, unk_id, eos_id,
                          append_eos, pad_id)
