"""Annotation readers, the JAX package's data/processors.py: raw files ->
records {sample_id, vid, s_time, e_time, duration, words} (the reference's
util/data_gen.py:20-126).

- Charades-STA: `vid s e##sentence` lines and `charades.json` durations;
  times clamped to [0, duration].
- ActivityNet Captions: train.json, val_2.json (val), val_1.json (test).
- TACoS: frame-index timestamps converted to seconds by fps; a `.avi`
  suffix stripped from the vids.
"""
import os

from vslnet_torch.data.io import load_json, load_lines
from vslnet_torch.data.tokenizer import tokenize_query


class _Processor:
    def __init__(self):
        self.idx_counter = 0

    def reset_idx_counter(self):
        self.idx_counter = 0

    def _record(self, vid, s_time, e_time, duration, words):
        rec = {"sample_id": self.idx_counter, "vid": str(vid),
               "s_time": s_time, "e_time": e_time, "duration": duration,
               "words": words}
        self.idx_counter += 1
        return rec

    @staticmethod
    def _require(data_dir):
        if not os.path.exists(data_dir):
            raise ValueError("missing annotation directory: %s" % data_dir)


class CharadesProcessor(_Processor):
    def process_data(self, data, charades):
        results = []
        for line in data:
            line = line.strip()
            if not line:
                continue
            video_info, sentence = line.split("##")
            vid, start_time, end_time = video_info.split(" ")
            duration = float(charades[vid]["duration"])
            start_time = max(0.0, float(start_time))
            end_time = min(float(end_time), duration)
            results.append(self._record(vid, start_time, end_time, duration,
                                        tokenize_query(sentence)))
        return results

    def convert(self, data_dir):
        self.reset_idx_counter()
        self._require(data_dir)
        charades = load_json(os.path.join(data_dir, "charades.json"))
        train = load_lines(os.path.join(data_dir, "charades_sta_train.txt"))
        test = load_lines(os.path.join(data_dir, "charades_sta_test.txt"))
        return (self.process_data(train, charades), None,
                self.process_data(test, charades))


class ActivityNetProcessor(_Processor):
    def process_data(self, data):
        results = []
        for vid, item in data.items():
            duration = float(item["duration"])
            for timestamp, sentence in zip(item["timestamps"],
                                           item["sentences"]):
                start_time = max(0.0, float(timestamp[0]))
                end_time = min(float(timestamp[1]), duration)
                results.append(self._record(vid, start_time, end_time,
                                            duration,
                                            tokenize_query(sentence)))
        return results

    def convert(self, data_dir):
        self.reset_idx_counter()
        self._require(data_dir)
        return tuple(self.process_data(load_json(os.path.join(data_dir, f)))
                     for f in ("train.json", "val_2.json", "val_1.json"))


class TACoSProcessor(_Processor):
    def process_data(self, data):
        results = []
        for vid, item in data.items():
            if vid.endswith(".avi"):
                vid = vid[:-4]
            fps = float(item["fps"])
            duration = float(item["num_frames"]) / fps
            for timestamp, sentence in zip(item["timestamps"],
                                           item["sentences"]):
                start_time = max(0.0, float(timestamp[0]) / fps)
                end_time = min(float(timestamp[1]) / fps, duration)
                results.append(self._record(vid, start_time, end_time,
                                            duration,
                                            tokenize_query(sentence)))
        return results

    def convert(self, data_dir):
        self.reset_idx_counter()
        self._require(data_dir)
        return tuple(self.process_data(load_json(os.path.join(data_dir, f)))
                     for f in ("train.json", "val.json", "test.json"))


PROCESSORS = {"charades": CharadesProcessor,
              "activitynet": ActivityNetProcessor,
              "tacos": TACoSProcessor}
