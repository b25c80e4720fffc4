"""The port's real-data pipeline (vslnet_torch/data/) against the JAX
package's, exactly: the annotation readers, the dataset and its pickle
cache, the video features and the packed bank (saved by either package,
loaded by the other), the batch order, and the "idxs" batch layout
gathered on the device against the host's "vfeats" batch. CPU, a
miniature data root in the reference's formats."""
import json

import numpy as np
import pytest
import torch

from vslnet_tpu.config import Config as JaxConfig
from vslnet_tpu.data import datasets as jax_datasets
from vslnet_tpu.data import labels as jax_labels
from vslnet_tpu.data import loader as jax_loader
from vslnet_tpu.data import processors as jax_processors
from vslnet_tpu.data.features import load_video_features as jax_load_features
from vslnet_torch.bench.data_root import write_charades_root
from vslnet_torch.config import Config
from vslnet_torch.data import datasets, labels, loader, processors
from vslnet_torch.data.features import load_video_features
from vslnet_torch.data.io import load_pickle
from vslnet_torch.train.runner import materialize, to_device

torch.set_num_threads(1)

D = 16


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    write_charades_root(str(root), n_train=20, n_test=9, n_videos=7,
                        feature_dim=D, clips=(6, 40), seed=2,
                        extra_vids=("VID_EXTRA",))
    return root


def _configs(root, save_dir, cls=Config, **kw):
    return cls(task="charades", data_root=str(root), save_dir=str(save_dir),
               max_pos_len=16, video_feature_dim=D, batch_size=4, seed=5,
               **kw)


def _assert_same(a, b, path="dataset"):
    """Equal nested dicts, lists and numpy arrays, element for element."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], "%s.%s" % (path, k))
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_dataset_equals_jax(data_root, tmp_path):
    port = datasets.gen_or_load_dataset(_configs(data_root, tmp_path / "p"))
    ref = jax_datasets.gen_or_load_dataset(
        _configs(data_root, tmp_path / "j", JaxConfig))
    _assert_same(port, ref)
    assert port["n_train"] == 20 and port["n_test"] == 9
    assert port["val_set"] is None and port["word_vector"].shape[1] == 300
    # the words left out of GloVe map to UNK
    assert any(1 in r["w_ids"] for r in port["train_set"] + port["test_set"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dataset_cache_loads_in_the_other_package(data_root, tmp_path,
                                                  writer):
    port_cfg = _configs(data_root, tmp_path)
    jax_cfg = _configs(data_root, tmp_path, JaxConfig)
    first, second = ((datasets.gen_or_load_dataset, port_cfg),
                     (jax_datasets.gen_or_load_dataset, jax_cfg))
    if writer == "jax":
        first, second = second, first
    made = first[0](first[1])
    path = datasets.dataset_cache_path(port_cfg)
    assert path == jax_datasets.dataset_cache_path(jax_cfg)
    _assert_same(load_pickle(path), made)
    _assert_same(second[0](second[1]), made)


def test_activitynet_and_tacos_readers_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    sentences = ["A man opens a door.", "Someone sits down, then stands up.",
                 "The person laughs at the picture!"]

    def videos(frames):
        out = {}
        for i in range(3):
            n = int(rng.integers(2, 4))
            stamps = sorted(rng.uniform(0, 90, (n, 2)).round(1).tolist())
            key = "v%d" % i + (".avi" if frames else "")
            out[key] = {"timestamps": [sorted(t) for t in stamps],
                        "sentences": [sentences[j % 3] for j in range(n)]}
            out[key].update({"fps": 29.4, "num_frames": 2700} if frames
                            else {"duration": 80.0})
        return out

    for task, files, frames in (
            ("activitynet", ("train.json", "val_2.json", "val_1.json"), False),
            ("tacos", ("train.json", "val.json", "test.json"), True)):
        d = tmp_path / task
        d.mkdir()
        for name in files:
            (d / name).write_text(json.dumps(videos(frames)))
        port = processors.PROCESSORS[task]().convert(str(d))
        ref = jax_processors.PROCESSORS[task]().convert(str(d))
        _assert_same(list(port), list(ref), task)
        assert all(not r["vid"].endswith(".avi") for s in port for r in s)


def test_video_features_and_overlap_equal_jax(data_root):
    fdir = str(data_root / "features" / "charades" / "new")
    port = load_video_features(fdir, 16)
    ref = jax_load_features(fdir, 16, verbose=False)
    _assert_same(port, ref, "features")
    assert max(f.shape[0] for f in port.values()) == 16  # downsampled
    pred = [[0.0, 4.0], [2.5, 9.0], [7.0, 7.5]]
    gt = [[1.0, 5.0], [6.0, 10.0]]
    for p, g in ((pred, gt), (pred[0], gt), (pred, gt[1]),
                 (pred[1], gt[0])):
        np.testing.assert_array_equal(labels.compute_overlap(p, g),
                                      jax_labels.compute_overlap(p, g))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_video_bank_saved_by_one_package_loads_in_the_other(data_root,
                                                            tmp_path, writer):
    feats = load_video_features(
        str(data_root / "features" / "charades" / "new"), 16)
    made_by, read_by = ((loader.VideoBank, jax_loader.VideoBank)
                        if writer == "port" else
                        (jax_loader.VideoBank, loader.VideoBank))
    bank = made_by(feats, 16, D)
    prefix = str(tmp_path / "charades_new_16_bank")
    bank.save(prefix)
    assert read_by.exists(prefix)
    loaded = read_by.load(prefix, mmap=True)
    np.testing.assert_array_equal(loaded.bank, bank.bank)
    np.testing.assert_array_equal(loaded.lengths, bank.lengths)
    assert loaded.vid_to_row == bank.vid_to_row and len(loaded) == len(feats)
    for vid, f in feats.items():
        assert vid in loaded
        np.testing.assert_array_equal(loaded[vid], f)
    assert read_by.wrap(loaded, 16, D) is loaded


def _loaders(data_root, tmp_path, layout):
    cfg = _configs(data_root, tmp_path)
    dataset = datasets.gen_or_load_dataset(cfg)
    feats = load_video_features(
        str(data_root / "features" / "charades" / "new"), 16)
    bank = loader.VideoBank(feats, 16, D)
    max_w, max_c = loader.static_caps(
        [dataset["train_set"], dataset["test_set"]], cfg)
    return (cfg, dataset, feats, bank, max_w, max_c,
            loader.TrainLoader(dataset["train_set"], bank, cfg, max_w, max_c,
                               layout),
            loader.TestLoader(dataset, bank, cfg, max_w, max_c, layout))


def test_epoch_and_eval_idxs_equal_jax(data_root, tmp_path):
    cfg, dataset, feats, bank, max_w, max_c, train, test = _loaders(
        data_root, tmp_path, "idxs")
    jcfg = _configs(data_root, tmp_path, JaxConfig)
    jtrain = jax_loader.TrainLoader(dataset["train_set"], feats, jcfg,
                                    max_w=max_w, max_c=max_c, layout="idxs")
    jtest = jax_loader.TestLoader(dataset, feats, jcfg, max_w=max_w,
                                  max_c=max_c, layout="idxs")
    for _ in range(3):  # three epochs: three draws from the shuffle
        ids = train.epoch_idxs()
        np.testing.assert_array_equal(ids, jtrain.epoch_idxs())
        assert ids.shape == (5, 4) and ids.dtype == np.int32
    np.testing.assert_array_equal(test.eval_idxs(), jtest.eval_idxs())
    assert test.eval_idxs()[-1].tolist() == [8, -1, -1, -1]
    # batch_iter draws from the same stream: the next epoch's ids
    order = train.epoch_idxs()
    batches = [b["idxs"] for _, b in train.batch_iter()]
    assert not np.array_equal(np.concatenate(batches), order.reshape(-1))
    with pytest.raises(ValueError, match="Only support"):
        test.eval_idxs("val")


@pytest.mark.parametrize("train", [True, False])
def test_idxs_batches_equal_vfeats_batches_on_real_rows(data_root, tmp_path,
                                                        train):
    """The "idxs" layout gathered from the device-resident arrays (here on
    the CPU) equals the host "vfeats" batch, and the JAX package's, on
    every real row; padded rows carry batch_mask 0 in both."""
    cfg, dataset, feats, bank, max_w, max_c, trl, tel = _loaders(
        data_root, tmp_path, "idxs")
    split = trl.split if train else tel.split("test")
    jsplit = jax_loader._EncodedSplit(
        split.records, feats, _configs(data_root, tmp_path, JaxConfig),
        max_w, max_c, train)
    dev_split = to_device(split.host_arrays(), "cpu")
    dev_bank = to_device({"bank": bank.bank}, "cpu")["bank"]
    ids_rows = (trl.epoch_idxs() if train else tel.eval_idxs())
    for ids in ids_rows:
        real = ids[ids >= 0]
        host = split.gather(real, cfg.batch_size, layout="vfeats")
        _assert_same(host, jsplit.gather(real, cfg.batch_size,
                                         layout="vfeats"), "vfeats batch")
        idx_batch = split.gather(real, cfg.batch_size, layout="idxs")
        _assert_same(idx_batch, jsplit.gather(real, cfg.batch_size,
                                              layout="idxs"), "idxs batch")
        got = materialize({"idxs": torch.from_numpy(idx_batch["idxs"])},
                          dev_bank, dev_split, train)
        assert set(got) == set(host)
        k = len(real)
        for key, want in host.items():
            np.testing.assert_array_equal(got[key].numpy()[:k], want[:k],
                                          err_msg=key)
        assert got["batch_mask"].tolist() == host["batch_mask"].tolist()
