"""The port's checkpoints (vslnet_torch/train/checkpoints.py) and resume:
a save/restore round trip bit-exact for every tensor and the dropout
generator, the newest three kept, the JAX package's resume semantics
(tests/test_train_e2e.py test_resume_continues_from_checkpoint), a SIGTERM
save, and Localizer.from_model_dir on the saved model. CPU, small
shapes."""
import os
import signal

import pytest
import torch

from vslnet_torch.config import Config
from vslnet_torch.data.synthetic import synthetic_dataset
from vslnet_torch.serve import Localizer
from vslnet_torch.train.checkpoints import CheckpointManager
from vslnet_torch.train.runner import Trainer

torch.set_num_threads(1)


def _configs(tmp_path, **kw):
    base = dict(batch_size=8, max_pos_len=16, video_feature_dim=12,
                hidden_size=16, char_dim=4, word_dim=8, num_heads=4,
                epochs=2, period=2, model_dir=str(tmp_path / "ckpt"),
                save_dir=str(tmp_path / "datasets"), log_to_tensorboard=False)
    base.update(kw)
    return Config(**base)


def _data(seed=0):
    return synthetic_dataset(n_train=24, n_test=8, n_videos=6, n_words=40,
                             n_chars=12, max_pos_len=16, video_feature_dim=12,
                             word_dim=8, min_video_len=4, seed=seed)


def _state(trainer):
    """Every tensor a checkpoint holds, and the generator's state."""
    opt = trainer.optimizer.state_dict()
    tensors = dict(trainer.model.state_dict())
    for key in ("mu", "nu", "ema", "acc"):
        for i, t in enumerate(opt[key] or []):
            tensors["%s.%d" % (key, i)] = t
    return (tensors, trainer.generator.get_state(), opt["count"],
            opt["mini_step"], trainer.global_step)


def test_save_restore_is_bit_exact(tmp_path):
    dataset, feats = _data()
    cfg = _configs(tmp_path, ema_decay=0.5, grad_accum=2, drop_rate=0.2)
    trainer = Trainer(cfg, dataset, feats, device="cpu")
    trainer.train(3)  # mid-accumulation: acc and mini_step are live
    ckpt = CheckpointManager(trainer.model_dir)
    trainer.save_checkpoint(ckpt, 12.5)
    saved = _state(trainer)
    other = Trainer(_configs(tmp_path, ema_decay=0.5, grad_accum=2,
                             drop_rate=0.2, seed=99), dataset, feats,
                    device="cpu")
    step, extra = other.restore()
    assert step == 3 and extra == {"r1i7": 12.5, "step": 3}
    got = _state(other)
    assert set(got[0]) == set(saved[0]) and len(got[0]) > 40
    for name, t in saved[0].items():
        assert torch.equal(got[0][name], t), name
    assert torch.equal(got[1], saved[1]) and got[2:] == saved[2:]
    # the restored trainer's next step is the saved one's
    batch = trainer.next_batch()
    trainer.step(batch)
    other.step(batch)
    for (n, p), q in zip(trainer.model.named_parameters(),
                         other.model.parameters()):
        assert torch.equal(p, q), n


def test_keeps_the_newest_three_and_refuses_an_empty_dir(tmp_path):
    dataset, feats = _data()
    trainer = Trainer(_configs(tmp_path), dataset, feats, device="cpu")
    ckpt = CheckpointManager(trainer.model_dir)
    assert ckpt.latest_step() is None
    with pytest.raises(ValueError, match="No pre-trained weights"):
        trainer.restore(ckpt)
    for step in (1, 4, 6, 9):
        trainer.global_step = step
        trainer.save_checkpoint(ckpt, float(step))
    assert ckpt.steps() == [4, 6, 9] and ckpt.latest_step() == 9
    assert sorted(os.listdir(trainer.model_dir)) == [
        "checkpoint_4.pt", "checkpoint_6.pt", "checkpoint_9.pt"]


def test_resume_continues_from_checkpoint(tmp_path):
    """As the JAX package's test: 1 epoch with eval_period 1 lands a
    checkpoint; a resumed run of 2 epochs continues from its step and
    appends to eval_results.txt."""
    dataset, feats = _data()
    trainer = Trainer(_configs(tmp_path, epochs=1, eval_period=1), dataset,
                      feats, device="cpu")
    res1 = trainer.run(verbose=False)
    assert res1["global_step"] == trainer.num_train_batches == 3
    score_path = os.path.join(trainer.model_dir, "eval_results.txt")
    n_before = len(open(score_path).readlines())
    best = CheckpointManager(trainer.model_dir).latest_step()
    trainer2 = Trainer(_configs(tmp_path, epochs=2, eval_period=1), dataset,
                       feats, device="cpu")
    res2 = trainer2.run(resume=True, verbose=False)
    assert res2["global_step"] == 2 * trainer2.num_train_batches
    assert len(open(score_path).readlines()) > n_before  # appended
    # the resumed run trained exactly the remaining steps
    assert len(open(score_path).readlines()) == n_before + 2 * (6 - best)
    assert os.path.exists(os.path.join(trainer.model_dir, "configs.json"))
    jsonl = os.path.join(trainer.log_dir, "metrics.jsonl")
    assert any('"train/loss"' in line for line in open(jsonl))


def test_sigterm_saves_a_resumable_checkpoint(tmp_path):
    dataset, feats = _data()
    trainer = Trainer(_configs(tmp_path, eval_period=100), dataset, feats,
                      device="cpu")
    step = trainer.step

    def step_then_sigterm(batch=None):
        out = step(batch)
        if trainer.global_step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.step = step_then_sigterm
    res = trainer.run(verbose=False)
    assert res["preempted"] and res["global_step"] == 2
    assert CheckpointManager(trainer.model_dir).latest_step() == 2


def test_localizer_from_model_dir_serves_the_saved_model(tmp_path):
    """from_model_dir reloads configs.json and the newest checkpoint: its
    weights are the best checkpoint's (not the run's last), and it serves
    as a Localizer over a Trainer restored by hand."""
    dataset, feats = _data()
    trainer = Trainer(_configs(tmp_path, epochs=1, eval_period=1), dataset,
                      feats, device="cpu")
    trainer.run(verbose=False)
    loc = Localizer.from_model_dir(trainer.model_dir, dataset, feats,
                                   device="cpu")
    restored = Trainer(_configs(tmp_path), dataset, feats, device="cpu")
    step, _ = restored.restore()
    assert step == CheckpointManager(trainer.model_dir).latest_step()
    for (n, p), q in zip(loc.model.named_parameters(),
                         restored.model.parameters()):
        assert torch.equal(p, q), n
    by_hand = Localizer.from_trainer(restored, dataset["word_dict"],
                                     dataset["char_dict"])
    requests = [(feats[r["vid"]], r["duration"], " ".join(r["words"]))
                for r in dataset["test_set"]]
    assert loc.localize_batch(requests) == by_hand.localize_batch(requests)
    with pytest.raises(ValueError, match="not the model directory"):
        Localizer.from_model_dir(str(tmp_path), dataset, feats,
                                 configs=_configs(tmp_path), device="cpu")
