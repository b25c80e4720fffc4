"""Weights from the JAX package's VSLNet into the port.

The port keeps the flax parameter names and layouts (models/layers.py), so
the conversion is a name map: the flax path params/a/b/c becomes the
state_dict key "a.b.c". The GloVe table sits in flax's `frozen` collection
and becomes the buffer `word_embeddings.word_vectors`. The shared
`feature_encoder` subtree appears once in the flax tree and maps once.
`flax_path` is the map back, from a port name to its flax path, for the
predicates that key on flax names (the l2 regularizer, the weight-decay
mask).

Takes nested dicts of numpy arrays (turn JAX arrays into numpy first, e.g.
with `jax.tree.map(np.asarray, variables)`); imports no JAX.
"""
from collections.abc import Mapping

import numpy as np
import torch

COLLECTIONS = ("params", "frozen")


def flax_path(name):
    """The flax path (within its collection) of a port parameter or buffer:
    state_dict key "a.b.c" is params/a/b/c."""
    return tuple(name.split("."))


def _flatten(tree, prefix, out):
    for key, value in tree.items():
        name = "%s.%s" % (prefix, key) if prefix else str(key)
        if isinstance(value, Mapping):
            _flatten(value, name, out)
        else:
            if name in out:
                raise ValueError("flax leaf %s maps to a key already used" % name)
            out[name] = value
    return out


def flax_to_torch(variables):
    """{"params": tree, "frozen": tree} of numpy arrays -> state_dict of
    float32 tensors, one entry per flax leaf."""
    unknown = set(variables) - set(COLLECTIONS)
    if unknown:
        raise ValueError("unexpected flax collections %s" % sorted(unknown))
    flat = {}
    for collection in COLLECTIONS:
        if collection in variables:
            _flatten(variables[collection], "", flat)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
            for k, v in flat.items()}


def load_flax_variables(model, variables):
    """Load converted flax variables into `model` strictly: every flax leaf
    fills exactly one parameter or buffer, and every one is filled."""
    state = flax_to_torch(variables)
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    unused = sorted(set(state) - set(expected))
    if missing or unused:
        raise ValueError("flax tree does not match the model: missing %s, "
                         "unused %s" % (missing, unused))
    for key, value in state.items():
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError("%s: flax shape %s, port shape %s" % (
                key, tuple(value.shape), tuple(expected[key].shape)))
    model.load_state_dict(state, strict=True)
    return model
