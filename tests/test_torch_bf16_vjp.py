"""vslnet_torch/bench/bf16_vjp.py's readings and verdict on the CPU, with
the plain backward twins standing in for the bf16 kernels: the sound case
reads 0 and passes, both controls exceed the share limit, and each fault
planted in one frame or one row of the activation gradient is refused.
The card tests hold the kernels themselves (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from vslnet_torch.bench import bf16_vjp as V
from vslnet_torch.ops import kernels as K

torch.set_num_threads(1)


@pytest.fixture
def twins_as_kernels(monkeypatch):
    monkeypatch.setattr(K, "launch_lstm_fwd_res", lambda x, k, v: (
        K.lstm_recurrence_plain(x, k, v, residuals=True)))
    monkeypatch.setattr(K, "launch_lstm_bwd", K.lstm_recurrence_bwd_plain)
    monkeypatch.setattr(K, "launch_conv_block_fwd", lambda *a: (
        K.conv_block_residuals_plain(*a[:8])))
    monkeypatch.setattr(K, "launch_conv_block_bwd", lambda *a: (
        K.conv_block_bwd_plain(*a[:9])))
    monkeypatch.setattr(K, "launch_mha_fwd", K.whole_attention_plain)
    monkeypatch.setattr(K, "launch_mha_bwd", lambda *a: K.attention_bwd_plain(
        *a[:7], a[8]))
    monkeypatch.setattr(K, "launch_flash_mha_fwd", K.flash_attention_plain)
    monkeypatch.setattr(K, "launch_flash_mha_bwd", K.flash_attention_bwd_plain)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


def _case(kind):
    rng = np.random.default_rng(13)
    if kind == "lstm":
        return V.lstm_case("cpu", rng, 12, 4, 8)
    if kind in ("mha_whole", "flash"):  # head dim 8: #14b's scale control
        return V.attention_case("cpu", rng, 3, 40, 16, 2, 0.2,
                                kind == "flash")
    return V.conv_case("cpu", rng, 4, 13, 32, 0.2)


@pytest.mark.parametrize("kind", ["lstm", "conv", "mha_whole", "flash"])
def test_sound_case_reads_zero_and_controls_fail(twins_as_kernels, kind):
    case = _case(kind)
    r = V.read(case)
    assert V.verdict(case, r) == (True, "")
    assert all(v == 0 for ms in r["kernel"].values() for v in ms.values())
    first = case.names[0]
    assert set(r["kernel"][first]) == {"share", "slice_share", "elem"}
    for control in ("fp32", "autograd", *case.controls):
        assert r[control][first]["share"] > V.limit(case, first, "share")
    assert set(case.controls) == {"lstm": set(), "conv": set(),
                                  "mha_whole": {"flash"},
                                  "flash": {"whole", "bf16_scale"}}[kind]


@pytest.mark.parametrize("kind,fault", [
    ("lstm", "row_zero"), ("lstm", "row_scaled"), ("lstm", "one_element"),
    ("conv", "last_frame_fp32"), ("conv", "row_zero"),
    ("conv", "row_scaled"), ("conv", "one_element"),
    *((kind, fault) for kind in ("mha_whole", "flash")
      for fault in ("last_frame_fp32", "row_zero", "row_scaled",
                    "one_element"))])
def test_planted_fault_is_refused(twins_as_kernels, kind, fault):
    """A fault in one frame or one row: a small share of the whole tensor
    (the LSTM's length-1 row is 1 of the valid positions, the last frame 1
    of 13), caught by the slice share or the element bound."""
    case = _case(kind)
    bad = V.planted(case, fault)
    r = V.read(bad)
    ok, why = V.verdict(bad, r)
    assert not ok and "beyond the limits" in why, why
    first = r["kernel"][case.names[0]]
    if fault != "one_element":  # a frame or a row: its slice
        assert first["slice_share"] > V.limit(case, case.names[0],
                                               "slice_share")
    if fault != "last_frame_fp32":  # a value 1/16 off or 0: the element
        assert first["elem"] > V.limit(case, case.names[0], "elem")


def test_fp64_verdict_passes_the_twin_and_refuses_the_controls(twins_as_kernels):
    """bf16_vjp.fp64_verdict (#8b at path M's T = 192 on the card): the
    twin as the kernel sits where the twin does from the fp64 evaluation
    and passes; each control, taken as the kernel, lies beyond the twin's
    distance plus the twin limit and is refused."""
    case = _case("lstm")
    fp64 = V.fp64_readings(case, K.lstm_recurrence_bwd_plain)
    assert fp64["kernel"] == fp64["twin"]
    assert V.fp64_verdict(case, V.read(case), fp64) == (True, "")
    for control in ("fp32", "autograd"):
        bad = case._replace(kernel=getattr(case, control))
        ok, why = V.fp64_verdict(bad, V.read(bad), V.fp64_readings(
            bad, K.lstm_recurrence_bwd_plain))
        assert not ok and "from fp64" in why, why
