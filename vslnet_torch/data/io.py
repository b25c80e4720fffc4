"""JSON, pickle and text-line helpers, the JAX package's data/io.py (and
through it the reference's util/data_util.py:9-41)."""
import json
import pickle


def load_json(filename):
    with open(filename, mode="r", encoding="utf-8") as f:
        return json.load(f)


def save_json(data, filename, save_pretty=False, sort_keys=False):
    with open(filename, mode="w", encoding="utf-8") as f:
        if save_pretty:
            f.write(json.dumps(data, indent=4, sort_keys=sort_keys))
        else:
            json.dump(data, f)


def load_lines(filename):
    with open(filename, mode="r", encoding="utf-8") as f:
        return [e.strip("\n") for e in f.readlines()]


def save_lines(data, filename):
    with open(filename, mode="w", encoding="utf-8") as f:
        f.write("\n".join(data))


def load_pickle(filename):
    with open(filename, mode="rb") as handle:
        return pickle.load(handle)


def save_pickle(data, filename):
    with open(filename, mode="wb") as handle:
        pickle.dump(data, handle, protocol=pickle.HIGHEST_PROTOCOL)
