"""Static query caps, as the JAX package's loaders derive them
(vslnet_tpu/data/loader.py `_static_caps`)."""


def static_caps(splits, configs):
    """Static W (words per query) and C (chars per word) caps over the
    dataset's splits; explicit `configs.max_words` / `max_chars` win."""
    max_w = configs.max_words
    max_c = configs.max_chars
    if max_w is None or max_c is None:
        w, c = 1, 1
        for split in splits:
            if split is None:
                continue
            for rec in split:
                w = max(w, len(rec["w_ids"]))
                for cid in rec["c_ids"]:
                    c = max(c, len(cid))
        max_w = max_w or min(w, configs.max_pos_len)
        max_c = max_c or c
    return int(max_w), int(max_c)
