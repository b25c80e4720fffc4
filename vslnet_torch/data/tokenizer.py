"""English word tokenization matching the JAX package's `tokenize_query`
(`nltk.word_tokenize(sentence.strip().lower())` in the reference), without
depending on nltk.

The word rules are a copy of nltk's TreebankWordTokenizer
(nltk/tokenize/treebank.py and the MacIntyre contractions in
nltk/tokenize/destructive.py), Copyright (C) 2001-2026 NLTK Project,
licensed under the Apache License, Version 2.0. Sentences are split with
the regex splitter the JAX package uses when the punkt model is absent;
for the single-sentence queries of Charades, ActivityNet and TACoS the two
splitters agree.
"""
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
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
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
_CONTRACTIONS3 = [re.compile(p) for p in (
    r"(?i) ('t)(?#X)(is)\b",
    r"(?i) ('t)(?#X)(was)\b",
)]
_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+(?=[^\s])")


def treebank_tokenize(text):
    """Penn Treebank word tokenization of one sentence."""
    for regexp, substitution in _STARTING_QUOTES + _PUNCTUATION:
        text = regexp.sub(substitution, text)
    for regexp, substitution in (_PARENS_BRACKETS, _DOUBLE_DASHES):
        text = regexp.sub(substitution, text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS2 + _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def sentences(text):
    return [s for s in _SENT_SPLIT.split(text) if s]


def word_tokenize(text):
    out = []
    for sent in sentences(text):
        out.extend(treebank_tokenize(sent))
    return out


def tokenize_query(sentence):
    """The per-query call of every dataset processor and of serving."""
    return word_tokenize(sentence.strip().lower())
