"""The port's serving path (vslnet_torch/serve.py, server.py and the data
helpers) against the JAX package's, and the port's import hygiene."""
import dataclasses
import json
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslnet_tpu.config import Config as JaxConfig
from vslnet_tpu.data import features as jax_features
from vslnet_tpu.data import labels as jax_labels
from vslnet_tpu.data import tokenizer as jax_tokenizer
from vslnet_tpu.data.synthetic import synthetic_dataset
from vslnet_tpu.parallel.mesh import make_mesh
from vslnet_tpu.serve import Localizer as JaxLocalizer
from vslnet_tpu.train.runner import Runner
from vslnet_torch import server as port_server
from vslnet_torch.config import Config
from vslnet_torch.convert_flax import load_flax_variables
from vslnet_torch.data import features, labels, tokenizer
from vslnet_torch.data.loader import static_caps
from vslnet_torch.models.vslnet import build_model
from vslnet_torch.serve import Localizer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX Runner + Localizer on a synthetic dataset (rnn predictor) and
    the port's Localizer over the same weights."""
    tmp = tmp_path_factory.mktemp("serve")
    jcfg = JaxConfig(
        batch_size=4, max_pos_len=16, video_feature_dim=12, hidden_size=16,
        char_dim=4, word_dim=8, num_heads=4, epochs=1, predictor="rnn",
        model_dir=str(tmp / "ckpt"), save_dir=str(tmp / "d"),
        log_to_tensorboard=False,
    )
    dataset, feats = synthetic_dataset(
        n_train=8, n_test=4, n_videos=4, n_words=40, n_chars=12,
        max_pos_len=16, video_feature_dim=12, word_dim=8, min_video_len=4,
        seed=0,
    )
    feats["long_vid"] = np.random.default_rng(5).standard_normal(
        (37, 12)).astype(np.float32)  # downsampled to max_pos_len
    runner = Runner(jcfg, dataset, feats, mesh=make_mesh(1))
    rng = np.random.default_rng(3)
    runner.params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.3 * rng.standard_normal(
            a.shape).astype(np.float32)), runner.params)
    jloc = JaxLocalizer(runner, dataset["word_dict"], dataset["char_dict"])

    configs = Config(**dataclasses.asdict(jcfg))
    model = build_model(configs, dataset["word_vector"].shape, device="cpu")
    load_flax_variables(model, jax.tree.map(
        np.asarray, {"params": runner.eval_params, "frozen": runner.frozen}))
    max_w, max_c = static_caps(
        [dataset["train_set"], dataset["val_set"], dataset["test_set"]],
        configs)
    assert (max_w, max_c) == (runner.train_loader.max_w,
                              runner.train_loader.max_c)
    loc = Localizer(model, configs, dataset["word_dict"],
                    dataset["char_dict"], max_w, max_c, device="cpu")
    return jloc, loc, dataset, feats


def _requests(dataset, feats):
    vids = sorted(feats)
    words = sorted(w for w in dataset["word_dict"] if w.startswith("w"))
    rng = np.random.default_rng(11)
    out = []
    for i in range(7):  # more than batch_size=4: two forward passes
        q = " ".join(rng.choice(words, size=3 + i % 4)) + " unknown-word ."
        vid = vids[i % len(vids)]
        out.append((feats[vid], 10.0 + i, q))
    return out


def test_localizer_matches_jax_localizer(served):
    jloc, loc, dataset, feats = served
    reqs = _requests(dataset, feats)
    assert loc.localize_batch(reqs) == jloc.localize_batch(reqs)
    got = loc.localize_batch(reqs, top_k=3)
    ref = jloc.localize_batch(reqs, top_k=3)
    for g, r in zip(got, ref):
        assert [s[:2] for s in g] == [s[:2] for s in r]
        # span probabilities: fp32 through the model; a tiny probability
        # exp(-d) carries the logits' absolute error d' as relative error,
        # so 1e-4 relative (1e-7 absolute)
        np.testing.assert_allclose([s[2] for s in g], [s[2] for s in r],
                                   rtol=1e-4, atol=1e-7)


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode("utf-8"), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return r.status, json.loads(r.read())


def test_http_server_answers_healthz_and_localize(served):
    _, loc, dataset, feats = served
    durations = port_server.durations_from_dataset(dataset)
    with pytest.raises(ValueError):
        port_server.make_server(loc, feats, durations, port=0, device="cuda")
    server = port_server.make_server(loc, feats, durations, port=0,
                                     device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        with urllib.request.urlopen(base + "/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["predictor"] == "rnn"
        vid = dataset["test_set"][0]["vid"]
        code, out = _post(base + "/localize", {"vid": vid, "query": "w3 w4"})
        expect = loc.localize(feats[vid], durations[vid], "w3 w4")
        assert code == 200
        assert (out["start"], out["end"]) == (round(expect[0], 3),
                                              round(expect[1], 3))
        code, outs = _post(base + "/localize", [
            {"vid": vid, "query": "w%d w9" % i, "top_k": 3} for i in range(5)])
        assert code == 200 and all(len(o["spans"]) == 3 for o in outs)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/localize", {"vid": "no-such-video", "query": "x"})
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


SENTENCES = [
    "A person opens the door.",
    "  the person is putting a book on a shelf  ",
    "person can't stop laughing, then they're sitting down!",
    'he said "hello" (quietly) and left -- fast...',
    "a man's cup: it's on the table; isn't it? yes.",
    "the person gonna cannot wanna 'tis 'twas open it",
    "person takes a phone/camera from the box & smiles #2 @home",
    "Two sentences here. And another one here!",
]


@pytest.mark.parametrize("i", range(len(SENTENCES)))
def test_tokenizer_matches_jax(i):
    s = SENTENCES[i]
    assert tokenizer.tokenize_query(s) == jax_tokenizer.tokenize_query(s)


def test_feature_sampling_and_labels_match_jax():
    rng = np.random.default_rng(0)
    for n in (1, 16, 17, 128, 129, 300, 1001):
        x = rng.standard_normal((n, 6)).astype(np.float32)
        np.testing.assert_array_equal(
            features.visual_feature_sampling(x, 128),
            jax_features.visual_feature_sampling(x, 128))
    for L, dur in ((16, 10.0), (128, 31.7)):
        for s, e in ((0, 0), (3, 9), (L - 1, L - 1)):
            assert labels.index_to_time(s, e, L, dur) == \
                jax_labels.index_to_time(s, e, L, dur)
        st, et = sorted(rng.uniform(0, dur, 2))
        got, ref = (labels.time_to_index(st, et, L, dur),
                    jax_labels.time_to_index(st, et, L, dur))
        assert got[:2] == ref[:2]
        np.testing.assert_array_equal(got[2], ref[2])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, vslnet_torch\n"
        "for m in pkgutil.walk_packages(vslnet_torch.__path__, 'vslnet_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vslnet_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('vslnet_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|"
                         r"vslnet_tpu)\b", re.M)
    files = sorted((REPO / "vslnet_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    for path in files:
        assert not pattern.search(path.read_text()), path
