"""Text tokenizers.

Counterpart of deephumor_tpu/data/tokenizers.py; the two regexes are the
behaviour: word-punct tokens keep ``<special>`` markers whole, char tokens
are single characters except ``<special>`` markers, which stay whole.
"""

import abc
import re

__all__ = ["Tokenizer", "WordPunctTokenizer", "CharTokenizer"]


class Tokenizer(abc.ABC):
    """Abstract tokenizer interface."""

    @abc.abstractmethod
    def tokenize(self, text):
        """Splits ``text`` into a list of string tokens."""
        raise NotImplementedError


class WordPunctTokenizer(Tokenizer):
    """Words and runs of punctuation; ``<special>`` tokens stay whole."""

    token_pattern = re.compile(r"[<\w'>]+|[^\w\s]+")

    def tokenize(self, text):
        return self.token_pattern.findall(text)


class CharTokenizer(Tokenizer):
    """Single characters; ``<special>`` tokens stay whole."""

    token_pattern = re.compile(r"<\w+>|.")

    def tokenize(self, text):
        return self.token_pattern.findall(text)
