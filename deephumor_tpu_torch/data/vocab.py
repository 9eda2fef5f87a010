"""Token vocabulary.

Counterpart of deephumor_tpu/data/vocab.py: the fixed special-token
order gives the ids pad=0, unk=1, bos=2, eos=3, sep=4, emp=5, and the
other tokens follow sorted, so a token set always gives the same ids.
Pure Python; a vocabulary file written by either package reads in the
other.
"""

from collections import Counter

__all__ = ["SPECIAL_TOKENS", "PAD_ID", "UNK_ID", "BOS_ID", "EOS_ID",
           "SEP_ID", "EMP_ID", "Vocab", "build_vocab",
           "build_vocab_from_file"]

# insertion order defines the ids 0..5
SPECIAL_TOKENS = {
    "PAD": "<pad>",
    "UNK": "<unk>",
    "BOS": "<bos>",
    "EOS": "<eos>",
    "SEP": "<sep>",
    "EMPTY": "<emp>",
}

PAD_ID, UNK_ID, BOS_ID, EOS_ID, SEP_ID, EMP_ID = range(6)


class Vocab:
    """Deterministic token vocabulary: the special tokens in their fixed
    order, then the other tokens deduplicated and sorted."""

    def __init__(self, tokens, special_tokens=tuple(SPECIAL_TOKENS.values())):
        special_set = set(special_tokens)
        rest = sorted(set(tok for tok in tokens if tok not in special_set))
        self.tokens = list(special_tokens) + rest
        self.stoi = {tok: idx for idx, tok in enumerate(self.tokens)}
        self.itos = {idx: tok for idx, tok in enumerate(self.tokens)}

    def __iter__(self):
        return iter(self.tokens)

    def __len__(self):
        return len(self.tokens)

    def __contains__(self, token):
        return token in self.stoi

    def save(self, filepath):
        """Writes one token per line."""
        with open(filepath, "w") as f:
            for token in self.tokens:
                f.write(f"{token}\n")

    @staticmethod
    def load(filepath):
        """Reads a one-token-per-line vocabulary file."""
        with open(filepath, "r") as f:
            tokens = [line.strip("\n") for line in f]
        return Vocab(tokens)


def build_vocab(documents, tokenizer, min_df=7):
    """A vocabulary of the lowercase tokens whose document frequency is at
    least ``min_df`` (each document counts its set of tokens once)."""
    doc_freq = Counter()
    for text in documents:
        doc_freq.update(set(tokenizer.tokenize(text.lower())))
    kept = [tok for tok, df in doc_freq.items() if df >= min_df]
    return Vocab(kept)


def build_vocab_from_file(captions_file, tokenizer, min_df=7):
    """:func:`build_vocab` over the captions of a ``label\\tscore\\tcaption``
    TSV file."""
    captions = []
    with open(captions_file) as f:
        for line in f:
            _, _, caption = line.strip().split("\t")
            captions.append(caption)
    return build_vocab(captions, tokenizer, min_df=min_df)
