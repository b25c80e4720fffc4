"""Vocabulary ids shared with the JAX package: PAD=0 and UNK=1 in both the
word and the char dict."""

PAD, UNK = "<PAD>", "<UNK>"
