"""Question tokenization and encoding for serving, without nltk.

The port's own copy of ``encode_tokens`` and ``tokenize_question`` of the
JAX package's question preprocessing (``preprocess/datautils/
questions_common.py``): lower-case, strip the trailing character (the
question mark), tokenize, and map each token to its vocab id with
``<UNK>`` for unknown words.

The JAX package tokenizes with ``nltk.word_tokenize`` and, where nltk's
punkt data is missing, with nltk's ``TreebankWordTokenizer``. The card's
machine has no nltk, so this module carries the Treebank tokenizer's
regular expressions (nltk 3.x, ``nltk/tokenize/treebank.py`` and the
MacIntyre contractions of ``nltk/tokenize/destructive.py``) and gives
``TreebankWordTokenizer().tokenize`` token for token. ``nltk.word_tokenize``
(``NLTKWordTokenizer``, used where punkt's data is installed) differs from
it on a few inputs: it splits curly quotes and some apostrophes off words
that Treebank keeps whole (``"cats’ toys"``: Treebank ``cats’``,
``toys``; ``word_tokenize`` ``cats``, ``’``, ``toys``). A vocab built by
one and served with the other maps such tokens to ``<UNK>``.
"""

from __future__ import annotations

import re

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),  # the final period
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
_ENDING_QUOTES = [
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_CONTRACTIONS2 = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
)]
_CONTRACTIONS3 = [re.compile(p) for p in (r"(?i) ('t)(?#X)(is)\b", r"(?i) ('t)(?#X)(was)\b")]


def treebank_tokenize(text: str) -> list[str]:
    """nltk's ``TreebankWordTokenizer().tokenize(text)``, step for step."""
    for regexp, sub in _STARTING_QUOTES + _PUNCTUATION + [_PARENS_BRACKETS, _DOUBLE_DASHES]:
        text = regexp.sub(sub, text)
    text = " " + text + " "
    for regexp, sub in _ENDING_QUOTES:
        text = regexp.sub(sub, text)
    for regexp in _CONTRACTIONS2 + _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def tokenize_question(question: str) -> list[str]:
    """lower -> strip the trailing character -> Treebank tokenize."""
    return treebank_tokenize(question.lower()[:-1])


def encode_tokens(tokens, token_to_idx) -> list:
    """Token strings -> vocab ids, unknown words to ``<UNK>``."""
    unk = token_to_idx["<UNK>"]
    return [token_to_idx.get(tok, unk) for tok in tokens]
