"""Text cleaning and filtering of crawled captions.

Counterpart of deephumor_tpu/data/utils.py, with the reference filters'
behaviour (the reference's deephumor/data/utils.py): punctuation runs
squashed, ASCII / length / token-count checks, and an English-probability
gate. ``langdetect`` is optional: :func:`english_prob` raises
``ImportError`` without it, and importing this module does not need it.
"""

import re

__all__ = ["clean_text", "check_text", "english_prob"]

# the reference's filters (utils.py:5-8)
TOKEN_PATTERN = re.compile(r"[<\w'>]+|[!#$%&\()*+,\-./:;=?@\\^{|}~]+")
_PUNCT_DROP = re.compile(r"([<>|\\])+")
_PUNCT_SQUASH = re.compile(r"([%&\()*+,\-/:;=@^{}~\"])+")
_PUNCT_TRIPLE = re.compile(r"([\.?!$#_]){4,}")


def clean_text(text):
    """Squashes punctuation runs: ``<>|\\`` runs are dropped, runs of most
    punctuation become one character, and runs of ``.?!$#_`` longer than
    3 become exactly 3. Whitespace becomes single spaces."""
    text = text or ""
    if text:
        text = _PUNCT_DROP.sub("", text)
        text = _PUNCT_SQUASH.sub(r"\g<1>", text)
        text = _PUNCT_TRIPLE.sub(r"\g<1>\g<1>\g<1>", text)
    return " ".join(text.split())


def check_text(text, min_len=10, max_len=100, max_tokens=32):
    """True for ASCII text of ``min_len`` to ``max_len`` characters with at
    most ``max_tokens`` tokens."""
    try:
        text.encode("ascii")
    except UnicodeEncodeError:
        return False
    if len(text) < min_len or len(text) > max_len:
        return False
    return len(TOKEN_PATTERN.findall(text)) <= max_tokens


def english_prob(text):
    """Probability that ``text`` is English; needs the optional
    ``langdetect`` package."""
    try:
        from langdetect import detect_langs
    except ImportError as e:
        raise ImportError(
            "english_prob requires the optional `langdetect` package") from e
    for lang in detect_langs(text):
        if lang.lang == "en":
            return lang.prob
    return 0.0
