"""Synthetic dataset generation for smoke tests and benchmarks.

Produces records, visual features, and embedding vectors with the exact same
schema as `gen_or_load_dataset` + `load_video_features`, but random —
Charades-shaped by default (T<=128, 1024-d I3D features). Used where real
video features / GloVe files are unavailable.
"""
import numpy as np


def synthetic_dataset(
    n_train=64,
    n_val=0,
    n_test=32,
    n_videos=24,
    n_words=200,
    n_chars=30,
    max_pos_len=128,
    video_feature_dim=1024,
    word_dim=300,
    max_query_words=12,
    max_word_chars=8,
    min_video_len=24,
    seed=0,
):
    rng = np.random.default_rng(seed)
    vids = ["synth_vid_{:04d}".format(i) for i in range(n_videos)]
    v_lens = {
        vid: int(rng.integers(min_video_len, max_pos_len + 1)) for vid in vids
    }
    visual_features = {
        vid: rng.standard_normal((v_lens[vid], video_feature_dim)).astype(np.float32)
        for vid in vids
    }

    def make_split(n, id0):
        records = []
        for i in range(n):
            vid = vids[int(rng.integers(0, n_videos))]
            v_len = v_lens[vid]
            duration = float(v_len) * 1.0
            s_ind = int(rng.integers(0, v_len))
            e_ind = int(rng.integers(s_ind, v_len))
            s_time = s_ind / v_len * duration
            e_time = (e_ind + 1) / v_len * duration
            n_q = int(rng.integers(3, max_query_words + 1))
            w_ids = rng.integers(2, n_words, size=n_q).tolist()
            c_ids = [
                rng.integers(
                    2, n_chars, size=int(rng.integers(1, max_word_chars + 1))
                ).tolist()
                for _ in range(n_q)
            ]
            records.append(
                {
                    "sample_id": id0 + i,
                    "vid": vid,
                    "s_time": s_time,
                    "e_time": e_time,
                    "duration": duration,
                    "words": ["w%d" % w for w in w_ids],
                    "s_ind": s_ind,
                    "e_ind": e_ind,
                    "v_len": v_len,
                    "w_ids": [int(w) for w in w_ids],
                    "c_ids": [[int(c) for c in cs] for cs in c_ids],
                }
            )
        return records

    train_set = make_split(n_train, 0)
    val_set = make_split(n_val, n_train) if n_val else None
    test_set = make_split(n_test, n_train + n_val)
    vectors = rng.standard_normal((n_words - 2, word_dim)).astype(np.float32)
    word_dict = {"<PAD>": 0, "<UNK>": 1}
    word_dict.update({"w%d" % i: i for i in range(2, n_words)})
    char_dict = {"<PAD>": 0, "<UNK>": 1}
    char_dict.update({"c%d" % i: i for i in range(2, n_chars)})
    dataset = {
        "train_set": train_set,
        "val_set": val_set,
        "test_set": test_set,
        "word_dict": word_dict,
        "char_dict": char_dict,
        "word_vector": vectors,
        "n_train": n_train,
        "n_val": n_val,
        "n_test": n_test,
        "n_words": n_words,
        "n_chars": n_chars,
    }
    return dataset, visual_features
