"""The port's command line (vslnet_torch/cli.py, `python -m vslnet_torch`)
through `cli.main(argv, device="cpu")` on a miniature data root in the
reference's Charades-STA format: train, resume, test and predict, the
caches, the reload of configs.json, and the error paths of the JAX
package's tests/test_cli.py. The dataset and the bank it builds equal the
JAX CLI's."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vslnet_torch import cli
from vslnet_torch.bench.data_root import write_charades_root
from vslnet_torch.data.io import load_pickle
from vslnet_torch.data.loader import VideoBank

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MODEL = ("ckpt", "vslnet_charades_new_16_rnn", "model")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_data")
    write_charades_root(str(root), n_train=16, n_test=8, n_videos=6,
                        feature_dim=16, seed=0, extra_vids=("VID99",))
    return root


def _args(data_root, workdir, *extra):
    return ["--task", "charades", "--predictor", "rnn",
            "--data_root", str(data_root),
            "--save_dir", str(workdir / "datasets"),
            "--model_dir", str(workdir / "ckpt"),
            "--batch_size", "8", "--max_pos_len", "16",
            "--video_feature_dim", "16", "--hidden_size", "16",
            "--char_dim", "4", "--num_heads", "4", "--epochs", "1",
            "--period", "2", "--log_to_tensorboard", "false"] + list(extra)


def _run(data_root, workdir, *extra):
    cli.main(_args(data_root, workdir, *extra), device="cpu")


@pytest.fixture(scope="module")
def trained(data_root, tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_cli_work")
    _run(data_root, work, "--mode", "train")
    return work


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_writes_model_dir_and_caches_equal_to_jax(data_root, trained,
                                                       tmp_path):
    model_dir = trained.joinpath(*MODEL)
    assert (model_dir / "configs.json").exists()
    assert (model_dir / "eval_results.txt").read_text().count("Rank@1") >= 2
    assert list(model_dir.glob("checkpoint_*.pt"))
    prefix = str(trained / "datasets" / "charades_new_16_bank")
    assert VideoBank.exists(prefix)
    # the JAX CLI's own caches from the same data root
    from vslnet_tpu.cli import load_or_build_feature_bank as jax_bank
    from vslnet_tpu.config import Config as JaxConfig
    from vslnet_tpu.data.datasets import gen_or_load_dataset

    jcfg = JaxConfig(data_root=str(data_root), save_dir=str(tmp_path),
                     max_pos_len=16, video_feature_dim=16)
    ref = jax_bank(jcfg)
    got = VideoBank.load(prefix)
    np.testing.assert_array_equal(got.bank, ref.bank)
    assert got.vid_to_row == ref.vid_to_row
    ref_ds = gen_or_load_dataset(jcfg)
    got_ds = load_pickle(str(trained / "datasets" / "charades_new_16.pkl"))
    assert got_ds["word_dict"] == ref_ds["word_dict"]
    assert got_ds["train_set"] == ref_ds["train_set"]
    np.testing.assert_array_equal(got_ds["word_vector"], ref_ds["word_vector"])


def test_test_and_predict_from_the_saved_dir(data_root, trained, capsys):
    _run(data_root, trained, "--mode", "test")
    out = capsys.readouterr().out
    assert "Rank@1, IoU=0.7" in out and "mean IoU" in out
    _run(data_root, trained, "--mode", "predict", "--vid", "VID001",
         "--query", "a person opens the door")
    pred = _last_json(capsys)
    assert pred["vid"] == "VID001" and set(pred) == {"vid", "query",
                                                     "start", "end"}
    assert 0.0 <= pred["start"] <= pred["end"]
    _run(data_root, trained, "--mode", "predict", "--vid", "VID001",
         "--query", "a person opens the door", "--top_k", "3")
    spans = _last_json(capsys)["spans"]
    assert len(spans) == 3 and spans[0]["start"] == pred["start"]
    assert spans[0]["prob"] >= spans[1]["prob"] >= spans[2]["prob"]
    queries = trained / "queries.jsonl"
    queries.write_text("\n".join(json.dumps(q) for q in [
        {"vid": "VID001", "query": "a person opens the door"},
        {"vid": "VID99", "query": "someone sits", "duration": 40.0},
        {"vid": "VID002", "query": "turns off the light"}]) + "\n")
    out_path = trained / "predictions.jsonl"
    _run(data_root, trained, "--mode", "predict", "--queries_file",
         str(queries), "--predictions_out", str(out_path))
    assert _last_json(capsys) == {"predictions_out": str(out_path), "n": 3}
    lines = [json.loads(x) for x in out_path.read_text().splitlines()]
    assert lines[0] == pred and lines[1]["end"] <= 40.0 + 1e-6


def test_test_and_predict_at_bf16_from_an_fp32_model(data_root, trained,
                                                     capsys):
    """--precision bf16 over the reloaded configs.json: the fp32 weights
    serve at bf16 (the parameters are fp32 at either precision)."""
    _run(data_root, trained, "--mode", "test", "--precision", "bf16")
    out = capsys.readouterr().out
    assert "Rank@1, IoU=0.7" in out and "mean IoU" in out
    _run(data_root, trained, "--mode", "predict", "--precision", "bf16",
         "--vid", "VID001", "--query", "a person opens the door")
    pred = _last_json(capsys)
    assert pred["vid"] == "VID001" and 0.0 <= pred["start"] <= pred["end"]


def test_resume_continues_and_appends(data_root, tmp_path, capsys):
    _run(data_root, tmp_path, "--mode", "train", "--eval_period", "1")
    results = tmp_path.joinpath(*MODEL) / "eval_results.txt"
    n_before = results.read_text().count("Rank@1, IoU=0.3")
    _run(data_root, tmp_path, "--mode", "train", "--eval_period", "1",
         "--resume", "true", "--epochs", "2")
    out = capsys.readouterr().out
    assert "resumed from step" in out and "fused_steps=auto" in out
    assert results.read_text().count("Rank@1, IoU=0.3") > n_before
    saved = json.loads((tmp_path.joinpath(*MODEL) / "configs.json")
                       .read_text())
    assert saved["epochs"] == 2 and saved["resume"] is True


def test_test_mode_reloads_saved_config(data_root, trained, capsys):
    """--mode test reloads hidden_size etc. from configs.json though the
    flags' defaults differ; a flag given explicitly wins."""
    saved = json.loads((trained.joinpath(*MODEL) / "configs.json")
                       .read_text())
    assert saved["hidden_size"] == 16 and saved["mode"] == "train"
    argv = ["--task", "charades", "--predictor", "rnn", "--mode", "test",
            "--data_root", str(data_root),
            "--save_dir", str(trained / "datasets"),
            "--model_dir", str(trained / "ckpt"), "--max_pos_len", "16"]
    cli.main(argv, device="cpu")
    assert "mean IoU" in capsys.readouterr().out
    with pytest.raises(ValueError, match="Only support"):
        cli.main(argv + ["--eval_split", "val"], device="cpu")


def test_unknown_task_mode_and_missing_weights(tmp_path):
    with pytest.raises(ValueError, match="Unknown task"):
        _run(tmp_path / "d", tmp_path, "--mode", "train", "--task", "bogus")
    with pytest.raises(ValueError, match="Unknown mode"):
        _run(tmp_path / "d", tmp_path, "--mode", "bogus")
    with pytest.raises(ValueError, match="No pre-trained weights"):
        _run(tmp_path / "d", tmp_path, "--mode", "test")


def test_predict_errors_and_duration(data_root, trained, capsys):
    with pytest.raises(ValueError, match="requires --query"):
        _run(data_root, trained, "--mode", "predict")
    with pytest.raises(ValueError, match="No features for video"):
        _run(data_root, trained, "--mode", "predict", "--vid", "NOPE",
             "--query", "x")
    capsys.readouterr()
    # features but no annotation: the duration must be given
    with pytest.raises(ValueError, match="--duration"):
        _run(data_root, trained, "--mode", "predict", "--vid", "VID99",
             "--query", "a person opens")
    _run(data_root, trained, "--mode", "predict", "--vid", "VID99",
         "--query", "a person opens", "--duration", "40.0")
    pred = _last_json(capsys)
    assert pred["vid"] == "VID99" and 0.0 <= pred["end"] <= 40.0 + 1e-6


@pytest.mark.parametrize("flags,item", [
    (("--mode", "export"), "A8"), (("--text_encoder", "bert"), "A10"),
    (("--t7_checkpoint", "m.t7"), "A11"), (("--tf_checkpoint", "m"), "A11"),
    (("--dp_size", "2"), "A9"), (("--ring_attention", "on"), "A9")])
def test_unported_options_name_their_roadmap_item(tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        _run(tmp_path / "d", tmp_path, *flags)


def test_train_resume_and_test_at_bf16(data_root, tmp_path, capsys):
    """--mode train --precision bf16 (once refused, ROADMAP.md B4b): an
    epoch, a resume to the second, then --mode test on the saved
    directory, which configs.json keeps at bf16."""
    _run(data_root, tmp_path, "--mode", "train", "--precision", "bf16")
    _run(data_root, tmp_path, "--mode", "train", "--resume", "true",
         "--epochs", "2", "--precision", "bf16")
    out = capsys.readouterr().out
    assert "resumed from step" in out
    saved = json.loads((tmp_path.joinpath(*MODEL) / "configs.json")
                       .read_text())
    assert saved["precision"] == "bf16" and saved["epochs"] == 2
    _run(data_root, tmp_path, "--mode", "test")
    out = capsys.readouterr().out
    assert "Rank@1, IoU=0.7" in out and "mean IoU" in out


def test_module_entry_point_and_card_default(tmp_path):
    """`python -m vslnet_torch` is the CLI; without a card and without an
    explicit device it raises instead of dropping to the CPU."""
    res = subprocess.run([sys.executable, "-m", "vslnet_torch", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "--device_bank" in res.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(_args(tmp_path / "d", tmp_path, "--mode", "train"))
