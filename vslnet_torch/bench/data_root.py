"""A seeded miniature data root in the reference's Charades-STA format, for
chip_smoke.py's cli phase and the CPU tests:

    root/dataset/charades/charades_sta_{train,test}.txt   `vid s e##sentence`
    root/dataset/charades/charades.json                   {vid: {"duration"}}
    root/features/charades/new/<vid>.npy                  [clips, feature_dim]
    root/features/charades/new/feature_shapes.json        {vid: clips}
    root/features/glove.840B.300d.txt                     seeded 300-d rows

Queries are drawn from a small vocabulary (every word in the GloVe file
but WORDS_NOT_IN_GLOVE, which map to UNK); `extra_vids` get features and
no annotation (a video whose duration must be given).
"""
import json
import os

import numpy as np

WORDS = ("a person opens the door someone closes book sits on couch eats "
         "sandwich takes off shoes walks into room holds phone laughs at "
         "picture turns light puts cup table").split()
WORDS_NOT_IN_GLOVE = ("axolotl", "zeppelin")


def write_charades_root(root, n_train, n_test, n_videos, feature_dim,
                        clips=(10, 30), seed=0, extra_vids=()):
    """Write the data root under `root`; returns {vid: duration}."""
    rng = np.random.default_rng(seed)
    ddir = os.path.join(root, "dataset", "charades")
    fdir = os.path.join(root, "features", "charades", "new")
    os.makedirs(ddir, exist_ok=True)
    os.makedirs(fdir, exist_ok=True)
    vids = ["VID%03d" % i for i in range(n_videos)]
    durations = {v: float(np.round(rng.uniform(15.0, 40.0), 2)) for v in vids}
    vocab = list(WORDS) + list(WORDS_NOT_IN_GLOVE)
    lines = []
    for i in range(n_train + n_test):
        v = vids[i % n_videos]
        d = durations[v]
        s = round(float(rng.uniform(0, d / 2)), 1)
        e = round(float(rng.uniform(s + 1, d)), 1)
        words = [vocab[j] for j in rng.integers(0, len(vocab),
                                                int(rng.integers(3, 12)))]
        lines.append("%s %.1f %.1f##%s ." % (v, s, e, " ".join(words)))
    with open(os.path.join(ddir, "charades_sta_train.txt"), "w") as f:
        f.write("\n".join(lines[:n_train]))
    with open(os.path.join(ddir, "charades_sta_test.txt"), "w") as f:
        f.write("\n".join(lines[n_train:]))
    with open(os.path.join(ddir, "charades.json"), "w") as f:
        json.dump({v: {"duration": d} for v, d in durations.items()}, f)
    shapes = {}
    for v in vids + list(extra_vids):
        n = int(rng.integers(clips[0], clips[1] + 1))
        np.save(os.path.join(fdir, v + ".npy"),
                rng.standard_normal((n, feature_dim)).astype(np.float32))
        shapes[v] = n
    with open(os.path.join(fdir, "feature_shapes.json"), "w") as f:
        json.dump(shapes, f)
    with open(os.path.join(root, "features", "glove.840B.300d.txt"), "w") as f:
        for w in sorted(set(WORDS) | {"."}):
            f.write(w + " " + " ".join(
                "%.4f" % x for x in rng.standard_normal(300)) + "\n")
    return durations
