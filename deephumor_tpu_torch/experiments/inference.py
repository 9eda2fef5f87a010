"""Text <-> token-id sequences for inference.

Counterpart of deephumor_tpu/experiments/inference.py. Sequences are
host-side int32 numpy arrays; ``seq_to_text`` also takes a CPU tensor
(the pipeline moves a batch's ids to the host once and decodes the rows
from there).
"""

import re

import numpy as np

from deephumor_tpu_torch.data.vocab import SPECIAL_TOKENS

__all__ = ["text_to_seq", "seq_to_text", "split_caption"]

# drops the space before punctuation when tokens are joined again
_PUNCT_PATTERN = re.compile(r"( )([!#$%&\()*+,\-.\/:;<=>?@\\^{|}~]+)")
_SPECIAL_TOKEN_PATTERN = re.compile(r"<\w+>")


def text_to_seq(text, vocab, tokenizer):
    """Tokenizes ``text`` into a ``[1, seq_len]`` int32 array of token ids:
    lowercased, out-of-vocabulary tokens as UNK, no EOS appended."""
    tokens = tokenizer.tokenize(text.lower())
    unk = SPECIAL_TOKENS["UNK"]
    ids = [vocab.stoi[tok if tok in vocab.stoi else unk] for tok in tokens]
    return np.asarray(ids, dtype=np.int32)[None, :]


def seq_to_text(seq, vocab, delimiter=" "):
    """A 1-D id sequence (numpy array or CPU tensor) as text, cut at the
    first EOS."""
    seq = np.asarray(seq).reshape(-1)
    eos_id = vocab.stoi[SPECIAL_TOKENS["EOS"]]
    eos_positions = np.where(seq == eos_id)[0]
    if eos_positions.size > 0:
        seq = seq[: eos_positions[0]]
    return delimiter.join(vocab.itos[int(i)] for i in seq)


def split_caption(text, num_blocks=None):
    """Splits a caption on ``<sep>`` into blocks with the special tokens,
    the edge whitespace and the space before punctuation removed; pads
    the list with empty strings up to ``num_blocks``, or cuts it there."""

    def _clean(block):
        block = _SPECIAL_TOKEN_PATTERN.sub("", block)
        block = block.strip()
        return _PUNCT_PATTERN.sub(r"\2", block)

    blocks = [_clean(b) for b in text.split(SPECIAL_TOKENS["SEP"])]
    if num_blocks is None:
        num_blocks = len(blocks)
    elif len(blocks) < num_blocks:
        blocks += [""] * (num_blocks - len(blocks))
    return blocks[:num_blocks]
