"""Dataset assembly and its pickle cache, the JAX package's
data/datasets.py (the reference's util/data_gen.py:180-244):

    dataset = gen_or_load_dataset(configs)
    # {train_set, val_set, test_set, word_dict, char_dict, word_vector,
    #  n_train, n_val, n_test, n_words, n_chars}

cached at `{save_dir}/{task}_{fv}_{max_pos_len}[_{suffix}].pkl`. The
pickle holds dicts, lists and numpy arrays only, so a cache written by
either package loads in the other. Each record gains s_ind/e_ind (the
argmax-IoU cell on the grid of min(max_pos_len, clips) frames), v_len,
w_ids and c_ids (words cut at max_pos_len; out-of-vocabulary -> UNK).
"""
import os

from vslnet_torch.data.io import load_json, load_pickle, save_pickle
from vslnet_torch.data.labels import time_to_index
from vslnet_torch.data.processors import PROCESSORS
from vslnet_torch.data.vocab import UNK, vocab_emb_gen


def dataset_gen(data, grid_lens, word_dict, char_dict, max_pos_len):
    dataset = []
    unk_word = word_dict[UNK]
    unk_char = char_dict[UNK]
    for record in data:
        vid = record["vid"]
        if vid not in grid_lens:
            continue
        s_ind, e_ind, _ = time_to_index(record["s_time"], record["e_time"],
                                        grid_lens[vid], record["duration"])
        word_ids, char_ids = [], []
        for word in record["words"][0:max_pos_len]:
            word_ids.append(word_dict.get(word, unk_word))
            char_ids.append([char_dict.get(c, unk_char) for c in word])
        dataset.append({
            "sample_id": record["sample_id"], "vid": record["vid"],
            "s_time": record["s_time"], "e_time": record["e_time"],
            "duration": record["duration"], "words": record["words"],
            "s_ind": int(s_ind), "e_ind": int(e_ind),
            "v_len": grid_lens[vid], "w_ids": word_ids, "c_ids": char_ids,
        })
    return dataset


def dataset_cache_path(configs):
    parts = [configs.task, configs.fv, str(configs.max_pos_len)]
    if configs.suffix is not None:
        parts.append(configs.suffix)
    return os.path.join(configs.save_dir, "_".join(parts) + ".pkl")


def gen_or_load_dataset(configs):
    if configs.task not in PROCESSORS:
        raise ValueError("Unknown task %r (choose from %s)"
                         % (configs.task, sorted(PROCESSORS)))
    os.makedirs(configs.save_dir, exist_ok=True)
    save_path = dataset_cache_path(configs)
    if os.path.exists(save_path):
        return load_pickle(save_path)
    data_dir = os.path.join(configs.data_root, "dataset", configs.task)
    feature_dir = os.path.join(configs.data_root, "features", configs.task,
                               configs.fv)
    emb_path = configs.glove_path or os.path.join(
        configs.data_root, "features", "glove.840B.300d.txt")
    grid_lens = {vid: min(configs.max_pos_len, n_clips) for vid, n_clips in
                 load_json(os.path.join(feature_dir,
                                        "feature_shapes.json")).items()}
    train_data, val_data, test_data = PROCESSORS[configs.task]().convert(
        data_dir)
    corpus = [s for s in (train_data, val_data, test_data) if s is not None]
    word_dict, char_dict, vectors = vocab_emb_gen(corpus, emb_path)

    def gen(data):
        return None if data is None else dataset_gen(
            data, grid_lens, word_dict, char_dict, configs.max_pos_len)

    train_set, val_set, test_set = gen(train_data), gen(val_data), gen(
        test_data)
    dataset = {
        "train_set": train_set, "val_set": val_set, "test_set": test_set,
        "word_dict": word_dict, "char_dict": char_dict,
        "word_vector": vectors, "n_train": len(train_set),
        "n_val": 0 if val_set is None else len(val_set),
        "n_test": len(test_set), "n_words": len(word_dict),
        "n_chars": len(char_dict),
    }
    save_pickle(dataset, save_path)
    return dataset
