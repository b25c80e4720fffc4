"""The command line of the port, the JAX package's cli.py:

    python -m vslnet_torch --task charades --predictor rnn --mode train
    python -m vslnet_torch --mode test            # (configs.json reloaded)
    python -m vslnet_torch --mode predict --vid <vid> --query "..."
    python -m vslnet_torch --mode predict --queries_file q.jsonl \
        [--predictions_out p.jsonl] [--top_k 3]
    python -m vslnet_torch --mode serve [--serve_host H --port P]

Flags are vslnet_torch/config.py's (the JAX package's names). It runs on
the card `cuda:<gpu_idx>`; `main(argv, device="cpu")` runs the plain
versions on the CPU. The data root holds the reference's layout:
dataset/<task>/ annotations, features/<task>/<fv>/<vid>.npy with
feature_shapes.json, and features/glove.840B.300d.txt (or --glove_path).
The dataset is cached as a pickle and the packed video bank as
<save_dir>/<task>_<fv>_<max_pos_len>_bank.{npy,json}, both in the JAX
package's formats. --mode test, predict and serve reload the model
directory's configs.json and apply the flags given explicitly over it.

--precision bf16 trains, resumes, tests and predicts at any max_pos_len
(the parameters and checkpoints are fp32 at either precision, so a
checkpoint trained at one precision serves or resumes at the other).

Not ported, each raising NotImplementedError with its ROADMAP.md item:
--mode export (A8), --text_encoder bert (A10), --t7_checkpoint and
--tf_checkpoint (A11), --dp_size/--sp_size/--tp_size and ring attention
(A9). fused_steps runs one step a dispatch (A3).
"""
import json
import os
import sys

import torch

from vslnet_torch.config import (
    build_parser,
    load_saved_config,
    namespace_to_config,
    resolve_device,
)
from vslnet_torch.data.datasets import gen_or_load_dataset
from vslnet_torch.data.features import load_video_features
from vslnet_torch.data.loader import VideoBank
from vslnet_torch.serve import Localizer
from vslnet_torch.server import durations_from_dataset, run_server
from vslnet_torch.train.runner import Trainer

MODES = ("train", "test", "predict", "serve")


def load_or_build_feature_bank(configs):
    """The video features as a packed VideoBank, cached on disk: the first
    run loads every <vid>.npy and downsamples it; later runs map the saved
    bank (feature_cache=false: a dict, loaded every run)."""
    feature_dir = os.path.join(configs.data_root, "features", configs.task,
                               configs.fv)
    if not configs.feature_cache:
        return load_video_features(feature_dir, configs.max_pos_len)
    prefix = os.path.join(configs.save_dir, "_".join(
        [configs.task, configs.fv, str(configs.max_pos_len), "bank"]))
    if VideoBank.exists(prefix):
        return VideoBank.load(prefix, mmap=True)
    bank = VideoBank.wrap(load_video_features(feature_dir,
                                              configs.max_pos_len),
                          configs.max_pos_len, configs.video_feature_dim)
    os.makedirs(configs.save_dir, exist_ok=True)
    bank.save(prefix)
    return bank


def refuse_unported(configs):
    """NotImplementedError, naming its ROADMAP.md item, for what the port
    does not do yet."""
    unported = [
        (configs.mode.lower() == "export", "--mode export", "A8"),
        (configs.text_encoder != "glove", "--text_encoder %s"
         % configs.text_encoder, "A10"),
        (bool(configs.t7_checkpoint), "--t7_checkpoint", "A11"),
        (bool(configs.tf_checkpoint), "--tf_checkpoint", "A11"),
        (any(getattr(configs, k) not in (None, 1)
             for k in ("dp_size", "sp_size", "tp_size")),
         "--dp_size/--sp_size/--tp_size", "A9"),
        (str(configs.ring_attention).lower() in ("on", "true", "1", "yes"),
         "--ring_attention", "A9"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError("%s is not ported yet (ROADMAP.md %s)"
                                      % (what, item))


def cli_device(configs, device):
    """`device` where given, else the card cuda:<gpu_idx> (raising without
    one), made current."""
    if device is not None:
        return torch.device(device)
    resolve_device()
    device = torch.device("cuda:%d" % int(str(configs.gpu_idx).split(",")[0]))
    torch.cuda.set_device(device)
    return device


def reload_configs(configs, ns, argv):
    """The model directory's configs.json with the flags given in argv
    applied over it (and the requested mode)."""
    model_dir = os.path.join(configs.home_dir(), "model")
    if not os.path.exists(os.path.join(model_dir, "configs.json")):
        raise ValueError("No pre-trained weights exist")
    explicit = {a.lstrip("-").split("=")[0] for a in argv
                if a.startswith("--")}
    overrides = {k: v for k, v in vars(ns).items() if k in explicit}
    if "dim" in overrides:
        overrides["hidden_size"] = overrides.pop("dim")
    overrides["mode"] = configs.mode.lower()
    return load_saved_config(model_dir, overrides)


def main(argv=None, device=None):
    """The command line on argv (default sys.argv[1:]), on `device`
    (default: the card cuda:<gpu_idx>)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ns = build_parser().parse_args(argv)
    configs = namespace_to_config(ns)
    mode = configs.mode.lower()
    refuse_unported(configs)
    if mode not in MODES:
        raise ValueError("Unknown mode {}!!!".format(configs.mode))
    if mode != "train":
        configs = reload_configs(configs, ns, argv)
        refuse_unported(configs)
    device = cli_device(configs, device)
    if mode == "train" and str(configs.fused_steps) != "off":
        print("fused_steps=%s: the port runs one step a dispatch (fused "
              "steps are ROADMAP.md A3)" % configs.fused_steps, flush=True)
    dataset = gen_or_load_dataset(configs)
    configs.char_size = dataset["n_chars"]
    visual_features = load_or_build_feature_bank(configs)
    trainer = Trainer(configs, dataset, visual_features, device)
    print("\x1b[1;33mTotal trainable parameters: {}\x1b[0m".format(
        trainer.n_params()), flush=True)
    if mode == "train":
        trainer.run(resume=configs.resume)
        return
    if mode == "test":
        trainer.test()
        return
    durations = durations_from_dataset(dataset)
    if mode == "serve":
        trainer.restore()
        run_server(Localizer.from_trainer(trainer, dataset["word_dict"],
                                          dataset["char_dict"]),
                   visual_features, durations, host=configs.serve_host,
                   port=configs.port, device=device)
        return
    predict(configs, trainer, dataset, visual_features, durations)


def predict(configs, trainer, dataset, visual_features, durations):
    """--mode predict: one query (--vid, --query, --duration) or a JSONL
    --queries_file of {"vid", "query", "duration"?}; one JSON line a
    request, to stdout or --predictions_out."""
    if not configs.queries_file and (not configs.query or not configs.vid):
        raise ValueError("--mode predict requires --query and --vid (or "
                         "--queries_file for batch inference)")

    def check_vid(vid):
        if vid not in visual_features:
            raise ValueError("No features for video {}".format(vid))

    def lookup_duration(vid, explicit):
        # a guessed duration scales the decoded span wrong: an error
        if explicit is not None:
            return explicit
        if vid in durations:
            return durations[vid]
        raise ValueError(
            "Video {} has no annotation record to read its duration from; "
            "pass --duration <seconds> (or a 'duration' field in "
            "--queries_file)".format(vid))

    k = configs.top_k if configs.top_k > 1 else None

    def result_line(vid, query, res):
        if k:
            return json.dumps({"vid": vid, "query": query, "spans": [
                {"start": round(s, 3), "end": round(e, 3),
                 "prob": round(p, 6)} for s, e, p in res]})
        return json.dumps({"vid": vid, "query": query,
                           "start": round(res[0], 3), "end": round(res[1], 3)})

    trainer.restore()
    loc = Localizer.from_trainer(trainer, dataset["word_dict"],
                                 dataset["char_dict"])
    if not configs.queries_file:
        check_vid(configs.vid)
        res = loc.localize(visual_features[configs.vid],
                           lookup_duration(configs.vid, configs.duration),
                           configs.query, top_k=k)
        print(result_line(configs.vid, configs.query, res), flush=True)
        return
    meta = []
    with open(configs.queries_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            check_vid(rec["vid"])
            meta.append((rec["vid"], rec["query"],
                         lookup_duration(rec["vid"], rec.get("duration"))))
    results = loc.localize_batch(
        [(visual_features[v], d, q) for v, q, d in meta], top_k=k)
    lines = [result_line(vid, query, res)
             for (vid, query, _), res in zip(meta, results)]
    if configs.predictions_out:
        with open(configs.predictions_out, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        print(json.dumps({"predictions_out": configs.predictions_out,
                          "n": len(lines)}), flush=True)
    else:
        for line in lines:
            print(line, flush=True)


if __name__ == "__main__":
    main()
