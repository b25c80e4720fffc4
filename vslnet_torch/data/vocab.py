"""Vocabulary and GloVe embeddings, the JAX package's data/vocab.py (the
reference's util/data_gen.py:129-177): the word vocab is every corpus word
found in GloVe, in corpus-frequency order (Counter.most_common: count
descending, first appearance on ties), ids offset by 2 for PAD=0 and
UNK=1, the vectors covering the real words only; the char vocab keeps the
chars seen at least 5 times, with the same PAD and UNK. Pure Python: the
JAX package's native scanner is only a speed-up with equal outputs."""
from collections import Counter

import numpy as np

PAD, UNK = "<PAD>", "<UNK>"
GLOVE_DIM = 300


def _glove_lines(glove_path):
    with open(glove_path, mode="r", encoding="utf-8") as f:
        for line in f:
            parts = line.lstrip().rstrip().split(" ")
            # header lines and malformed rows (reference data_gen.py:134)
            if len(parts) == 2 or len(parts) != GLOVE_DIM + 1:
                continue
            yield parts


def load_glove_vocab(glove_path):
    return set(parts[0] for parts in _glove_lines(glove_path))


def filter_glove_embedding(word_dict, glove_path):
    vectors = np.zeros(shape=[len(word_dict), GLOVE_DIM], dtype=np.float32)
    for parts in _glove_lines(glove_path):
        word = parts[0]
        if word in word_dict:
            vectors[word_dict[word]] = np.asarray(
                [float(x) for x in parts[1:]], dtype=np.float32)
    return vectors


def vocab_emb_gen(datasets, emb_path):
    """(word_dict, char_dict, vectors) over a list of record lists."""
    word_counter, char_counter = Counter(), Counter()
    for data in datasets:
        for record in data:
            for word in record["words"]:
                word_counter[word] += 1
                for char in word:
                    char_counter[char] += 1
    emb_vocab = load_glove_vocab(emb_path)
    word_vocab = [w for w, _ in word_counter.most_common() if w in emb_vocab]
    vectors = filter_glove_embedding(
        {word: index for index, word in enumerate(word_vocab)}, emb_path)
    word_dict = {word: idx for idx, word in enumerate([PAD, UNK] + word_vocab)}
    char_vocab = [PAD, UNK] + [char for char, count in char_counter.most_common()
                               if count >= 5]
    char_dict = {char: idx for idx, char in enumerate(char_vocab)}
    return word_dict, char_dict, vectors
