"""The bf16 backward kernels held to their plain backward twins on the card,
shared by chip_smoke.py's bf16 training rows and the card tests
(tests/test_torch_cuda.py). Run as a script on the card, it prints the
readings of the card tests' cases and the planted faults' verdicts:
`python3 -m vslnet_torch.bench.bf16_vjp`.

A bf16 backward's function is the JAX package's custom VJP at bf16, which
rounds at its own points. Two impostors come close to it: the fp32 kernel's
gradient on the same bf16-valued inputs, and torch's autograd of the bf16
forward twin (the CPU's gradient before the backward twins were written).
A max-error bound does not tell them apart, and a share taken over a whole
tensor does not see a fault confined to a frame or a row, so each output is
read several ways against the twin, over its counted elements (the LSTM's
valid positions; every element of the others):

- share: of a bf16 output's elements that differ from the twin's (dx,
  dx_proj, dk_h);
- slice_share: the largest such share within one frame or one row of a
  bf16 activation gradient (dx [B, T, D], dx_proj [T, B, 4H]);
- mean_rel: an fp32 output's mean absolute error over its mean magnitude
  (the weight gradients);
- elem: the largest error of one element over that element's magnitude,
  floored at the output's mean magnitude, in units of 2^-8 (a bf16 ulp is
  2^-8 to 2^-7 of its value).

Each reading of the kernel must lie within its limit, and each impostor
must exceed the share limit on the first output (the activation's
gradient). The attention backwards (#12b whole-T, #14b flash) have more
impostors: the other route's backward twin, and for #14b at head dim 8
its own twin with the forward's bf16 query scale (ROADMAP.md C6).

    case = conv_case(dev, rng, B, T, D, rate, tiled=False)
    reading = read(case)   # {"kernel": {name: {metric: x}}, "fp32": ...}
    ok, why = verdict(case, reading)
    ok, why = verdict(planted(case, "last_frame_fp32"), ...)  # refused
"""
import json
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from vslnet_torch.ops import kernels as K

# a kernel against its twin on the same inputs: fp32 sums in other orders,
# so a value on a bf16 rounding boundary may round the other way, and the
# flip carries through what follows (0-0.4% of the blocks' dx on the card);
# both impostors differ from the twin on 10-60% of a bf16 output ...
SHARE_TOL = 0.02
# ... and within one frame or one row of it (a frame of the blocks' dx at
# [16, T, 128] is 2,048 elements: the kernels read up to 1.2%, a last
# frame computed as control (a) does 10%, the controls 14-31%; the MHA
# block's and the LSTM's own limits below) ...
SLICE_TOL = 0.05
# ... and on an fp32 weight gradient by 1.4e-3 and more over its mean
# magnitude, where the kernel's sums in another order read below 4e-5
MEAN_TOL = 2e-4
# one element's error over its magnitude (floored at the mean), in units
# of 2^-8: a flip is one bf16 ulp, at most 2 units, and the kernels read
# up to 2.9 (a weight gradient sums flipped bf16(g_p)); an element 1/16
# off reads 15-17
ELEM_TOL = 8.0
ELEM_UNIT = 2.0 ** -8
# The LSTM's reverse chain carries each flip of bf16(dgates) into the
# steps before it, and dk_h sums T * B such dgates: at T = 128 the kernel
# and the twin each differ from the twin summed in fp64 (the same
# roundings) on 1.5% of dx_proj and 16% of dk_h, the impostors on 11-16%
# and 42-50% (PERF.md). Over dx_proj's valid positions the kernels read
# up to 2.7%, 10% in one frame or row; the impostors 21-28%, 27-33%. The
# LSTM's limits, by (output, reading)
LSTM_LIMITS = {("dx_proj", "share"): 0.05, ("dk_h", "share"): 0.3,
               ("dx_proj", "slice_share"): 0.2}
# a flip in a head's q, k or v row carries through the frame's dx: up to
# 3.9% of a frame of 256 elements at [2, 64, 128], 2 heads; the controls
# 47-79%, a last frame computed as control (a) does 41%
MHA_LIMITS = {("dx", "slice_share"): 0.15}
BF16 = torch.bfloat16


class Case(NamedTuple):
    """One bf16 backward at one shape: `name` is the kernel's launch name;
    `names` its outputs in order, `bf16` those stored in bf16; `kernel`,
    `fp32` and `autograd` each return the outputs (the bf16 kernel's,
    control (a)'s and control (b)'s); the plain backward twin's are
    plain(*args). `counted` maps an output to the bool mask (broadcast to
    it) of the elements its readings count, `axes` a bf16 activation
    gradient to its (frame, row) axes, `short_row` is the row the faults
    plant in (the LSTM's row of length 1, the MHA block's fully masked
    row)."""
    name: str
    names: tuple
    bf16: tuple
    kernel: Callable
    plain: Callable
    args: tuple
    fp32: Callable
    autograd: Callable
    shape: tuple
    limits: dict = {}
    counted: dict = {}
    axes: dict = {}
    short_row: int = -1
    controls: dict = {}  # more impostors: name -> their outputs

    def twin(self):
        return self.plain(*self.args)


def _t(dev, a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def share(diff, keep):
    """The share of the counted elements (keep) where diff is set."""
    return float((diff & keep).sum()) / max(int(keep.sum()), 1)


def slice_share(diff, keep, axis):
    """The largest share of differing elements among the counted ones of
    one slice along axis (slices that count none left out)."""
    other = tuple(a for a in range(diff.dim()) if a != axis)
    n = keep.sum(dim=other).double()
    d = (diff & keep).sum(dim=other).double()
    return float((d[n > 0] / n[n > 0]).max()) if bool((n > 0).any()) else 0.0


def mean_rel(out, ref, keep):
    """Mean absolute error over ref's mean magnitude."""
    ref = ref.double()[keep]
    return float((out.double()[keep] - ref).abs().mean()
                 / ref.abs().mean().clamp_min(1e-30))


def elem(out, ref, keep):
    """The largest |out - ref| over max(|ref|, mean |ref|), in ELEM_UNITs."""
    ref = ref.double()[keep]
    mag = ref.abs()
    floor = mag.mean().clamp_min(1e-30)
    return float(((out.double()[keep] - ref).abs()
                  / torch.maximum(mag, floor)).max()) / ELEM_UNIT


def reading(case, outs, ref):
    """{output name: {reading: value}} against ref, by the output's dtype
    in the kernel."""
    r = {}
    for n, o, t in zip(case.names, outs, ref):
        keep = case.counted.get(n)
        keep = (torch.ones(t.shape, dtype=torch.bool, device=t.device)
                if keep is None else keep.bool().expand(t.shape))
        if n in case.bf16:
            diff = o.to(BF16) != t.to(BF16)
            r[n] = {"share": share(diff, keep),
                    "elem": elem(o.to(BF16), t, keep)}
            if n in case.axes:
                r[n]["slice_share"] = max(slice_share(diff, keep, a)
                                          for a in case.axes[n])
        else:
            r[n] = {"mean_rel": mean_rel(o, t, keep), "elem": elem(o, t, keep)}
    return r


def read(case):
    """The kernel's, control (a)'s and control (b)'s readings against the
    twin, and the kernel's bits on two equal calls."""
    ref = [t.detach() for t in case.twin()]
    first = [t.clone() for t in case.kernel()]
    again = case.kernel()
    torch.cuda.synchronize()
    out = {"kernel": reading(case, first, ref)}
    for control in ("fp32", "autograd"):
        out[control] = reading(case, getattr(case, control)(), ref)
    for control, fn in case.controls.items():
        out[control] = reading(case, fn(), ref)
    out["equal_bits_twice"] = all(torch.equal(a, b)
                                  for a, b in zip(first, again))
    out["finite"] = all(bool(torch.isfinite(t.float()).all()) for t in first)
    out["dtypes"] = [str(t.dtype).replace("torch.", "") for t in first]
    return out


def limit(case, name, metric):
    if (name, metric) in case.limits:
        return case.limits[name, metric]
    if metric == "elem":
        return ELEM_TOL
    return {"share": SHARE_TOL, "slice_share": SLICE_TOL,
            "mean_rel": MEAN_TOL}[metric]


def limits(case):
    """{output: {reading: limit}} of the case."""
    return {n: {m: limit(case, n, m) for m in ("share", "slice_share", "elem")
                if m != "slice_share" or n in case.axes}
            if n in case.bf16 else
            {m: limit(case, n, m) for m in ("mean_rel", "elem")}
            for n in case.names}


def worst(case, r):
    """(the largest of the kernel's readings over its limit, output,
    reading)."""
    return max((v / limit(case, n, m), n, m)
               for n, ms in r["kernel"].items() for m, v in ms.items())


def verdict(case, r):
    """(ok, reason): every kernel reading within its limit, both controls
    beyond the share limit on the first output, equal bits twice, finite
    outputs."""
    bad = {(n, m): v for n, ms in r["kernel"].items() for m, v in ms.items()
           if not v <= limit(case, n, m)}
    if bad:
        return False, "%s: %s beyond the limits %s" % (
            case.name, bad, {k: limit(case, *k) for k in bad})
    first = case.names[0]
    for control in ("fp32", "autograd", *case.controls):
        got, lim = r[control][first]["share"], limit(case, first, "share")
        if not got > lim:
            return False, "%s: control %s reads %g on %s, within %g: the " \
                "check does not tell it from the bf16 VJP" % (
                    case.name, control, got, first, lim)
    if not r["equal_bits_twice"]:
        return False, "%s: two equal calls differ" % case.name
    if not r["finite"]:
        return False, "%s: not finite" % case.name
    return True, ""


# Over path M's T = 192 steps the LSTM's chain carries each flip of
# bf16(dgates) further: the twin itself differs from an fp64 evaluation of
# the same function on 2-6% of dx_proj by the draw, and a kernel that sums
# in another order than cuBLAS's reads 1-5.5% against the twin, at
# SHARE's limit (PERF.md §6: over 8 draws the tensor-core kernel,
# the parent kernel and the twin sit 3.6%, 3.7% and 3.8% from fp64).
# There a kernel is held to the fp64 evaluation instead: each bf16
# output's share and worst frame or row no further from fp64 than the
# twin's own plus the twin limit, with the rest of `verdict` (the
# controls beyond the twin limits, equal bits, finite).


def fp64_readings(case, fp64):
    """The kernel's and the twin's readings against fp64(*case.args,
    work=torch.float64), the twin's function in float64 with its bf16
    rounding points (ops/kernels.py)."""
    ref = [t.detach() for t in fp64(*case.args, work=torch.float64)]
    return {"kernel": reading(case, case.kernel(), ref),
            "twin": reading(case, case.twin(), ref)}


def fp64_verdict(case, r, f):
    """(ok, reason) for r = read(case), f = fp64_readings(case, ...): the
    kernel's bf16 outputs no further from fp64 than the twin plus the twin
    limit, and verdict's other conditions."""
    for n in case.bf16:
        for m in ("share", "slice_share"):
            if m in f["kernel"][n]:
                k, t = f["kernel"][n][m], f["twin"][n][m]
                if not k <= t + limit(case, n, m):
                    return False, "%s: %s %s %g from fp64, beyond the twin's %g " \
                        "plus %g" % (case.name, n, m, k, t, limit(case, n, m))
    return verdict(case, {**r, "kernel": {}})


# --- the bf16 forwards (#1b lean, #7b with residuals) against fp64 ----------
# The forwards' outputs are fp32, so they are read by their distance from
# an fp64 evaluation of the same function (lstm_recurrence_plain at
# state_dtype float64: bf16(h) for each product kept, every other value
# float64): an output's mean absolute error over its mean magnitude at the
# valid positions (mean_rel). The twin sums in cuBLAS's fp32 order and the
# kernel in its mma tree, so each sits a few flips of bf16(h) from fp64 or,
# on a draw without one, within 1e-6: one draw's ratio to the twin reads
# 0.01-235. Over 64 draws at [T, 16, 512], T = 128 and 192, the kernel,
# the fp32-FMA kernel it replaces and the twin each read at most 7.6e-5
# (out) and 2.7e-5 (acts), h unrounded in the product 4.5e-4 and 1.6e-4,
# the other planted faults 0.03 and more (PERF.md). A draw is held within
# the twin's distance plus LSTM_FWD_FP64_SLACK; a tree against its parent
# over draws to LSTM_FWD_FP64_RATIO on the mean (bench/tc_bwd_fp64.py
# --against).
LSTM_FWD_FP64_SLACK = 1e-4
LSTM_FWD_FP64_RATIO = 1.25
LSTM_FWD_OUTPUTS = ("out", "acts")
# faults of the tensor-core forward (csrc/lstm.cu lstm_fwd_tc_kernel), built
# from changed copies of its source, which the fp64 reading must refuse;
# "h_unrounded" is the fp32 kernel on the same bf16 values (the product's
# bf16 operands cannot hold an unrounded h)
LSTM_FWD_FAULT_EDITS = {
    # the last k16 step of each warp's product left out
    "k16_step_skipped": [
        ("      vsl::mma16(d[ks + j], a[ks + j], b[2 * j], b[2 * j + 1]);\n",
         "      if (ks + j != KS - 1) vsl::mma16(d[ks + j], a[ks + j], b[2 * j], b[2 * j + 1]);\n")],
    # gate o's A fragment taken from the next unit's k_h column
    "neighbour_unit_fragment": [("    const int gate = m >> 2, unit = uw + (m & 3);\n",
                                 "    const int gate = m >> 2, unit = uw + (m & 3) + (gate == 3);\n")],
    # x_proj[t - 1] in step t's gates (step 0's as it is)
    "x_proj_from_t_minus_1": [
        ("      for (int g = 0; g < 4; ++g) nx[g] = ld_early(xp + next * G + g * H + unit);\n",
         "      for (int g = 0; g < 4; ++g) nx[g] = ld_early(xp + (next - B) * G + g * H + unit);\n")],
}
LSTM_FWD_FAULTS = (*LSTM_FWD_FAULT_EDITS, "h_unrounded")
LSTM_FWD_ENTRIES = ("lstm_recurrence_fwd_bf16", "lstm_recurrence_fwd_res_bf16")


def lstm_fwd_inputs(dev, rng, T, B, H):
    """x_proj [T, B, 4H] and k_h [H, 4H] in bf16, valid [T, B]: ragged
    lengths, the first row full and the second of length 1."""
    lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])[:B]
    return (_t(dev, rng.standard_normal((T, B, 4 * H))).to(BF16),
            _t(dev, rng.standard_normal((H, 4 * H)) / math.sqrt(H)).to(BF16),
            _t(dev, np.arange(T)[:, None] < lens[None, :]))


def lstm_fwd_outputs(args, residuals):
    """The bf16 forward's outputs on args: [out] (#1b), or [out, acts]
    (#7b's that the fp64 reading holds)."""
    if residuals:
        return list(K.launch_lstm_fwd_res(*args)[:2])
    return [K.launch_lstm_fwd(*args)]


def lstm_fwd_reading(outs, ref, valid):
    """{output: mean_rel at the valid positions} of the forward's outputs
    (out, and acts where given) against ref."""
    keep = valid.bool()[..., None]
    return {n: mean_rel(o, r, keep.expand(r.shape))
            for n, o, r in zip(LSTM_FWD_OUTPUTS, outs, ref)}


def lstm_fwd_fp64(args, outs, fp64_plain=None):
    """The kernel's outputs `outs` (out, or out and acts) and the twin's
    against fp64_plain(*args, state_dtype=torch.float64, residuals=True)
    (this tree's lstm_recurrence_plain by default): {"kernel", "twin":
    readings}."""
    fp64_plain = fp64_plain or K.lstm_recurrence_plain
    ref = fp64_plain(*args, state_dtype=torch.float64, residuals=True)
    twin = K.lstm_recurrence_plain(*args, residuals=True)
    n = len(outs)
    return {"kernel": lstm_fwd_reading(outs, ref[:n], args[2]),
            "twin": lstm_fwd_reading(twin[:n], ref[:n], args[2])}


def lstm_fwd_fp64_verdict(f):
    """(ok, reason): each output's distance from fp64 within the twin's
    plus LSTM_FWD_FP64_SLACK."""
    for n, k in f["kernel"].items():
        t = f["twin"][n]
        if not k <= t + LSTM_FWD_FP64_SLACK:
            return False, "lstm forward bf16: %s %g from fp64, beyond the twin's %g plus " \
                "%g" % (n, k, t, LSTM_FWD_FP64_SLACK)
    return True, ""


def lstm_fwd_fault_libraries():
    """{fault: the kernel library with both bf16 forwards from a copy of
    lstm.cu with LSTM_FWD_FAULT_EDITS[fault]}, the copies built at once."""
    from vslnet_torch.bench.common import build_copies, edited_source, library_with

    copies = build_copies({"fault_" + fault: edited_source("fault_" + fault, "lstm.cu", edits)
                           for fault, edits in LSTM_FWD_FAULT_EDITS.items()})
    return {fault: library_with(copies["fault_" + fault], LSTM_FWD_ENTRIES)
            for fault in LSTM_FWD_FAULT_EDITS}


def lstm_fwd_fault(args, fault, residuals, libs):
    """The bf16 forward's outputs on args with LSTM_FWD_FAULTS[fault]
    planted (libs: lstm_fwd_fault_libraries())."""
    if fault == "h_unrounded":
        return lstm_fwd_outputs((args[0].float(), args[1].float(), args[2]), residuals)
    return _with_library(libs[fault], lambda: lstm_fwd_outputs(args, residuals))


# --- faults planted in a kernel's activation gradient, which verdict must
# refuse (the card tests and tests/test_torch_bf16_vjp.py) ------------------


def _last_frame_fp32(case, outs):
    """The last frame of every row as control (a) computes it: a tile
    edge that leaves out the bf16 rounding points."""
    frame = case.axes[case.names[0]][0]
    idx = [slice(None)] * outs[0].dim()
    idx[frame] = -1
    outs[0][tuple(idx)] = case.fp32()[0][tuple(idx)].to(outs[0].dtype)


def _row(case, t):
    """The index of case.short_row in t, the activation gradient."""
    idx = [slice(None)] * t.dim()
    idx[case.axes[case.names[0]][1]] = case.short_row
    return tuple(idx)


def _row_zero(case, outs):
    """The short row skipped (its gradient left 0)."""
    outs[0][_row(case, outs[0])] = 0


def _row_scaled(case, outs):
    """The short row 1/16 too large."""
    outs[0][_row(case, outs[0])] *= 1.0625


def _one_element(case, outs):
    """The largest element of the short row 1/16 too large."""
    idx = _row(case, outs[0])
    flat = outs[0][idx].reshape(-1)
    flat[flat.float().abs().argmax()] *= 1.0625
    outs[0][idx] = flat.reshape(outs[0][idx].shape)


FAULTS = {"last_frame_fp32": _last_frame_fp32, "row_zero": _row_zero,
          "row_scaled": _row_scaled, "one_element": _one_element}


def planted(case, fault):
    """The case with FAULTS[fault] planted in a copy of its kernel's
    outputs."""
    def kernel():
        outs = [t.clone() for t in case.kernel()]
        FAULTS[fault](case, outs)
        return outs

    return case._replace(kernel=kernel)


# --- faults planted in the wide backwards themselves (#9c wide, #10b wide),
# which verdict must refuse (the card tests): three in a copy of the
# kernel's source (the entry points renamed, built into
# vslnet_torch/_build/bench/ and swapped in for the wrapper's call), one an
# impostor function. Each anchor must be found once.
WIDE_FAULT_EDITS = {
    # one keep bit of every (row, head)'s probabilities flipped: (t, j) = (0, 1)
    "keep_bit_flipped": (
        "mha_block.cu", "mha_block_bwd_wide_bf16",
        "const bool kp = t < T && j < T && drop.keep(seed, salt, t, j);",
        "const bool kp = t < T && j < T && (drop.keep(seed, salt, t, j) != "
        "(t == 0 && j == 1));"),
    # dbqkv's last row tile of each (row, head) left out of its sum
    "dbqkv_partial_dropped": (
        "mha_block.cu", "mha_block_bwd_wide_bf16",
        "for (int r = 0; r < NK; ++r) s += colp[(which * NK + r) * HD + c];",
        "for (int r = 0; r + 1 < NK; ++r) s += colp[(which * NK + r) * HD + c];"),
    # the pass's first frame past a strip (its reach) read as zeros
    "halo_frame_skipped": (
        "conv_block.cu", "conv_block_bwd_wide_bf16",
        "const bool on = w.loads(e), own = w.owned(t);",
        "const bool on = w.loads(e) && e != w.s1, own = w.owned(t);"),
    # #3b wide's attention forward (attn_fwd_wide_kernel): a padded key's
    # score (q . 0 = 0) counted in the row's max and sum ...
    "padded_key_in_l": (
        "mha_block.cu", "mha_block_fwd_wide_bf16",
        "sc[n][e] = j >= T ? -INFINITY : sc[n][e] + negk[j];",
        "sc[n][e] = j >= T ? sc[n][e] : sc[n][e] + negk[j];"),
    # ... and one keep bit of every (row, head) flipped, (t, j) = (0, 1)
    "fwd_keep_bit_flipped": (
        "mha_block.cu", "mha_block_fwd_wide_bf16",
        "const bool kept = t < T && j < T && drop.keep(seed, salt, t, j);",
        "const bool kept = t < T && j < T && (drop.keep(seed, salt, t, j) != "
        "(t == 0 && j == 1));"),
}
WIDE_FAULTS = ("keep_bit_flipped", "dbqkv_partial_dropped",
               "halo_frame_skipped", "ds_unrounded")
# the forward's: two in the source, two impostor functions (the bf16
# operands of the kernel's products cannot hold an unrounded q * scale or p)
WIDE_FWD_FAULTS = ("padded_key_in_l", "fwd_keep_bit_flipped", "q_unrounded",
                   "p_unrounded")


def _fault_library(fault):
    """The kernel library with the entry point of WIDE_FAULT_EDITS[fault]
    taken from a changed copy of its source."""
    source, entry, old, new = WIDE_FAULT_EDITS[fault]
    from vslnet_torch.bench.common import edited_library

    return edited_library("fault_" + fault, source, [entry], [(old, new)])


def _with_library(lib, fn):
    """common.with_library's outputs of fn, cloned."""
    from vslnet_torch.bench.common import with_library

    return [t.clone() for t in with_library(lib, fn)]


def wide_fault(case, fault):
    """The wide backward's case with WIDE_FAULTS[fault] planted: its kernel
    from a changed copy of the source, or (ds_unrounded) the MHA block's
    twin with dS left unrounded for dQ and dK."""
    if fault == "ds_unrounded":
        return case._replace(kernel=lambda: K.mha_block_bwd_plain(
            *case.args, round_ds=False))
    lib = _fault_library(fault)
    return case._replace(kernel=lambda: _with_library(lib, case.kernel))


# The wide backward in its fp32-qkv form (fp32 rows holding bf16 values,
# the forward's buffer before qkv was stored in bf16): a copy of
# mha_block.cu whose attn_bwd_wide_kernel takes fp32 qkv and loads it as
# that form did (FP32_QKV_LOAD, its text, in place of the kernel's loads
# from FP32_QKV_FROM to FP32_QKV_TO), so that a card test can hold the
# backward from the bf16 qkv to that form's bits on qkv.float().
FP32_QKV_FROM = ("  const bf16* qrow = qkv + (size_t)b * T * D3 + h * HD;\n"
                 "  const float* grow = gatt")
FP32_QKV_TO = ("  for (int j = tid; j < TP; j += NT)\n"
               "    negk[j] = j < T ? (1.f - mask[(size_t)b * T + j]) * "
               "vsl::kMaskValue : 0.f;\n  __syncthreads();\n  if (warp < NK) {")
FP32_QKV_LOAD = (
    "  const float* qrow = qkv + (size_t)b * T * D3 + h * HD;\n"
    "  const float* grow = gatt + (size_t)b * T * D + h * HD;\n"
    "  // k, v, qs, gh by 16-byte loads in 2 NK rounds of the CTA's threads, up\n"
    "  // to 4 rounds' loads (16 a thread) issued before their stores\n"
    "  constexpr int kRounds = TP * (HD / 4) / NT, kBatch = kRounds < 4 ? kRounds : 4;\n"
    "#pragma unroll 1\n"
    "  for (int r0 = 0; r0 < kRounds; r0 += kBatch) {\n"
    "    float4 q4[kBatch], k4[kBatch], v4[kBatch], g4[kBatch];\n"
    "#pragma unroll\n"
    "    for (int u = 0; u < kBatch; ++u) {\n"
    "      const int i = (r0 + u) * NT + tid, j = i / (HD / 4), c = (i % (HD / 4)) * 4;\n"
    "      q4[u] = k4[u] = v4[u] = g4[u] = make_float4(0.f, 0.f, 0.f, 0.f);\n"
    "      if (j < T) {\n"
    "        const float* r = qrow + (size_t)j * D3 + c;\n"
    "        q4[u] = *reinterpret_cast<const float4*>(r);\n"
    "        k4[u] = *reinterpret_cast<const float4*>(r + D);\n"
    "        v4[u] = *reinterpret_cast<const float4*>(r + 2 * D);\n"
    "        g4[u] = *reinterpret_cast<const float4*>(grow + (size_t)j * D + c);\n"
    "      }\n"
    "    }\n"
    "#pragma unroll\n"
    "    for (int u = 0; u < kBatch; ++u) {\n"
    "      const int i = (r0 + u) * NT + tid, j = i / (HD / 4), c = (i % (HD / 4)) * 4;\n"
    "      const auto put = [&](bf16* dst, float4 v, float f) {\n"
    "        *reinterpret_cast<uint2*>(dst + j * SH + c) =\n"
    "            make_uint2(vsl::pack_bf16(v.x * f, v.y * f), vsl::pack_bf16(v.z * f, v.w * f));\n"
    "      };\n"
    "      put(Ks, k4[u], 1.f);  // bf16 values already\n"
    "      put(Vs, v4[u], 1.f);\n"
    "      put(Qs, q4[u], scale);\n"
    "      put(Gs, g4[u], 1.f);\n"
    "    }\n"
    "  }\n")
FP32_QKV_EDITS = [
    ("attn_bwd_wide_kernel(const __nv_bfloat16* __restrict__ qkv,",
     "attn_bwd_wide_kernel(const float* __restrict__ qkv,"),
    ("cudaError_t launch_attn_bwd_wide(const __nv_bfloat16* qkv,",
     "cudaError_t launch_attn_bwd_wide(const float* qkv,"),
    ("launch_attn_bwd_wide(static_cast<const bf16*>(qkv), mask,",
     "launch_attn_bwd_wide(static_cast<const float*>(qkv), mask,"),
]


def fp32_qkv_edits():
    """FP32_QKV_EDITS and the loads' replacement, found in the source."""
    src = (K.CSRC / "mha_block.cu").read_text()
    start = src.index(FP32_QKV_FROM)
    return FP32_QKV_EDITS + [(src[start:src.index(FP32_QKV_TO, start)],
                              FP32_QKV_LOAD)]


def wide_bwd_from_fp32_qkv(case):
    """#10b wide's outputs for case (mha_case at head dim 128) as its
    fp32-qkv form computed them: the backward of a copy of mha_block.cu
    that loads fp32 qkv (fp32_qkv_edits), on the case's saved qkv widened
    to fp32."""
    from vslnet_torch.bench.common import edited_library

    lib = edited_library("fp32_qkv", "mha_block.cu", ["mha_block_bwd_wide_bf16"],
                         fp32_qkv_edits())
    x, mask, gam, beta, wqkv, bqkv, wd, bd, heads, seeds, rate, g, qkv, att = \
        case.args
    q32 = qkv.float()
    check = K._check

    def fp32_check(name, t, shape, dtype=torch.float32):
        return check(name, t, shape, torch.float32 if t is q32 else dtype)

    K._check = fp32_check
    try:
        return _with_library(lib, lambda: K.launch_mha_block_bwd(
            x, mask, gam, beta, wqkv, wd, heads, seeds, rate, q32, att, g))
    finally:
        K._check = check


# --- faults planted in the tensor-core backwards of #10b and #9b, which
# verdict must refuse (the card tests): each an edit of the kernel's source
# (mma.cuh inlined for the MHA block's per-frame products), each anchor
# found once: the last k16 step of a product left out, a group of 4 k16
# steps (or, in #9b's g_d, one of its four chains) never added, B's
# fragments loaded transposed, a term of a bias gradient dropped (dbqkv's
# last row tile, dbp's first frame), and #9b's ReLU mask read from the
# next layer's.
BWD_TC_ENTRIES = {"mha": "mha_block_bwd_bf16", "conv": "conv_block_bwd_bf16"}
BWD_TC_SOURCES = {"mha": "mha_block.cu", "conv": "conv_block.cu"}
BWD_TC_FAULT_EDITS = {
    "mha": {
        "k16_step_skipped": [("        a[0] = pair(r0, k0 + 2 * tq);\n",
                              "        if (k0 == Kp - 16) continue;\n"
                              "        a[0] = pair(r0, k0 + 2 * tq);\n")],
        "chain_group_not_added": [
            ("sum[h][e] = k == 0 ? c[h][e] : sum[h][e] + c[h][e];",
             "sum[h][e] = k == 0 ? c[h][e] : sum[h][e];")],
        "b_transpose_flipped": [("        ldsm_x4(b, W + (size_t)(n0 + (lane & 7)",
                                 "        ldsm_x4_trans(b, W + (size_t)(n0 + (lane & 7)")],
        "attn_chain_group_not_added": [
            ("acc[n][e] = k0 == 0 ? c[n][e] : acc[n][e] + c[n][e];",
             "acc[n][e] = k0 == 0 ? c[n][e] : acc[n][e];")],
        "dbqkv_term_dropped": [("for (int rt = 0; rt < NK; ++rt) s +=",
                                "for (int rt = 0; rt + 1 < NK; ++rt) s +=")],
    },
    "conv": {
        "k16_step_skipped": [("          const int k0 = k + 16 * q;\n"
                              "          uint32_t a[4], bw[4];\n",
                              "          const int k0 = k + 16 * q;\n"
                              "          if (k0 == Dk - 16) continue;\n"
                              "          uint32_t a[4], bw[4];\n")],
        "chain_group_not_added": [("(acc[2][e / 4][e % 4] + acc[3][e / 4][e % 4]);",
                                   "(acc[2][e / 4][e % 4] + 0.f);")],
        "b_transpose_flipped": [("vsl::ldsm_x4(bw, W + (size_t)(n0 + (lane & 7)",
                                 "vsl::ldsm_x4_trans(bw, W + (size_t)(n0 + (lane & 7)")],
        "dbp_term_dropped": [("for (int t = 0; t < nf; ++t) s += GD[(size_t)(gl + t) * D + c];",
                              "for (int t = 1; t < nf; ++t) s += GD[(size_t)(gl + t) * D + c];")],
        "mask_from_next_layer": [("const uint8_t* mask_l = mask + l * (layer / 4);",
                                  "const uint8_t* mask_l = mask + (l + 1) % L * (layer / 4);")],
    },
}


def bwd_tc_fault_libraries(kind):
    """{fault: the kernel library with the bf16 backward of `kind` ("mha",
    "conv") from a copy of its source with BWD_TC_FAULT_EDITS[kind][fault]},
    the copies built at once."""
    from vslnet_torch.bench.common import build_copies, edited_source, library_with

    edits = BWD_TC_FAULT_EDITS[kind]
    copies = build_copies({
        "bwd_%s_%s" % (kind, fault): edited_source(
            "bwd_%s_%s" % (kind, fault), BWD_TC_SOURCES[kind], e, inline=("mma.cuh",))
        for fault, e in edits.items()})
    return {fault: library_with(copies["bwd_%s_%s" % (kind, fault)], [BWD_TC_ENTRIES[kind]])
            for fault in edits}


def bwd_tc_fault(case, lib):
    """The case with its kernel from lib (one of bwd_tc_fault_libraries)."""
    return case._replace(kernel=lambda: _with_library(lib, case.kernel))


def _autograd(fn, inputs, n_grad, g):
    """torch's autograd of fn at its inputs: the gradients of the first
    n_grad w.r.t. the cotangent g."""
    leaves = [a.detach().requires_grad_() if i < n_grad else a
              for i, a in enumerate(inputs)]
    return list(torch.autograd.grad(fn(*leaves), leaves[:n_grad], g))


# --- the cases -----------------------------------------------------------------


def lstm_case(dev, rng, T, B, H):
    """#8 at bf16 on the residuals of #7 at bf16 (x_proj [T, B, 4H], k_h
    [H, 4H] in bf16, ragged lengths, one row of length 1)."""
    lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])[:B]
    x_proj = _t(dev, rng.standard_normal((T, B, 4 * H))).to(BF16)
    k_h = _t(dev, rng.standard_normal((H, 4 * H)) / math.sqrt(H)).to(BF16)
    valid = _t(dev, np.arange(T)[:, None] < lens[None, :])
    dy = _t(dev, rng.standard_normal((T, B, H)))
    res = K.launch_lstm_fwd_res(x_proj, k_h, valid)[1:]
    res32 = K.launch_lstm_fwd_res(x_proj.float(), k_h.float(), valid)[1:]
    return Case(
        "lstm_recurrence_bwd_bf16", ("dx_proj", "dk_h"), ("dx_proj", "dk_h"),
        lambda: K.launch_lstm_bwd(dy, *res, valid, k_h),
        K.lstm_recurrence_bwd_plain, (dy, *res, valid, k_h),
        lambda: K.launch_lstm_bwd(dy, *res32, valid, k_h.float()),
        lambda: _autograd(K.lstm_recurrence_plain, [x_proj, k_h, valid], 2,
                          dy),
        (T, B, 4 * H), LSTM_LIMITS, counted={"dx_proj": valid[..., None]},
        axes={"dx_proj": (0, 1)}, short_row=1)


def conv_inputs(dev, rng, B, T, D, L=4, KS=7):
    """x [B, T, D] in bf16 and the layers' fp32 weights, with biases of +-1
    and a pointwise product ten times smaller, so that every pre-ReLU lies
    ~1 from the kink: one within ~1e-6 of it may take the other side in
    sums of another order and move the gradients around it by ~0.1."""
    return [_t(dev, rng.standard_normal((B, T, D))).to(BF16),
            _t(dev, 1 + 0.1 * rng.standard_normal((L, D))),
            _t(dev, 0.1 * rng.standard_normal((L, D))),
            _t(dev, rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
            _t(dev, 0.1 * rng.standard_normal((L, D, D)) / math.sqrt(D)),
            _t(dev, np.where(rng.random((L, D)) < 0.5, -1.0, 1.0))]


CONV_NAMES = ("dx", "dgam", "dbeta", "ddw", "dwp", "dbp")


def conv_case(dev, rng, B, T, D, rate, tiled=False, wide=False):
    """#9 at bf16, whole-row (on its forward's layer inputs and ReLU masks)
    or T-tiled (on its forward's xs and masks), or the wide form (#9c at D
    = 896 and 1024, on the wide forward's xs and mask), drop
    rate `rate` with per-row seeds. No fp32 kernel takes the wide widths:
    there control (a) is the fp32 function computed by the plain
    backward."""
    args = conv_inputs(dev, rng, B, T, D)
    seeds = _t(dev, rng.integers(0, 1 << 23, (B, 1))) if rate else None
    g = _t(dev, rng.standard_normal((B, T, D))).to(BF16)
    args32 = [args[0].float()] + args[1:]
    # the forward's xs (and at bf16 its ReLU mask), by activation dtype; the
    # whole-row bf16 forward's residuals
    saved = {a[0].dtype: K.launch_conv_block_fwd_tiled(*a, seeds, rate)[1:]
             for a in (args, args32)} if tiled else None
    if wide:
        saved = {BF16: K.launch_conv_block_fwd_wide(*args, seeds, rate)[1:]}
    if not (tiled or wide):
        saved = {BF16: K.launch_conv_block_fwd(*args, seeds, rate, True)[1:]}

    def kernel(a, g_):
        if wide and a[0].dtype != BF16:
            return K.conv_block_bwd_plain(*a, seeds, rate, g_)
        if wide:
            xs, mask = saved[BF16]
            return K.launch_conv_block_bwd_wide(a[0], xs, *a[1:], seeds, rate,
                                                g_, mask)
        if tiled:
            xs, *mask = saved[a[0].dtype]
            return K.launch_conv_block_bwd_tiled(a[0], xs, *a[1:], seeds, rate,
                                                 g_, *mask)
        return K.launch_conv_block_bwd(*a, seeds, rate, g_,
                                       *saved.get(a[0].dtype, ()))

    name = ("conv_block_bwd_wide_bf16" if wide else "conv_block_bwd_tiled_bf16"
            if tiled else "conv_block_bwd_bf16")
    return Case(
        name, CONV_NAMES, ("dx",), lambda: kernel(args, g),
        K.conv_block_bwd_plain, (*args, seeds, rate, g),
        lambda: kernel(args32, g.float()),
        lambda: _autograd(lambda *a: K.conv_block_plain(*a, seeds, rate),
                          args, 6, g),
        (B, T, D), axes={"dx": (1, 0)}, short_row=B - 1)


MHA_NAMES = ("dx", "dgam", "dbeta", "dwqkv", "dbqkv", "dwd", "dbd")


def mha_case(dev, rng, B, T, D, heads, rate):
    """#10 at bf16 on the bf16 forward's qkv and att (the twin on the same
    ones: a flip in the forward's bf16 q, k or v, where its sums ran in
    another order, would carry through every frame the attention mixes):
    x [B, T, D] in bf16, ragged key masks with one row fully masked, drop
    rate `rate`. At head dim 128 (the wide kernels) no fp32 kernel takes
    the shape: there control (a) is the fp32 function computed by the
    plain backward."""
    lens = np.concatenate([rng.integers(1, T + 1, B - 1), [0]])
    x = _t(dev, rng.standard_normal((B, T, D))).to(BF16)
    mask = _t(dev, np.arange(T)[None, :] < lens[:, None])
    gam, beta = (_t(dev, 1 + 0.1 * rng.standard_normal((2, D))),
                 _t(dev, 0.1 * rng.standard_normal((2, D))))
    wqkv = _t(dev, rng.standard_normal((D, 3 * D)) / math.sqrt(D))
    bqkv = _t(dev, 0.1 * rng.standard_normal(3 * D))
    wd = _t(dev, rng.standard_normal((D, D)) / math.sqrt(D))
    bd = _t(dev, 0.1 * rng.standard_normal(D))
    seeds = _t(dev, rng.integers(0, 1 << 23, (B, 1))) if rate else None
    g = _t(dev, rng.standard_normal((B, T, D))).to(BF16)

    wide = K._wide_head_dim(D, heads)
    saved = {x_.dtype: K.launch_mha_block_fwd(x_, mask, gam, beta, wqkv, bqkv,
                                              wd, bd, heads, seeds, rate)[1:]
             for x_ in ((x,) if wide else (x, x.float()))}

    def kernel(x_, g_):
        if x_.dtype not in saved:
            return K.mha_block_bwd_plain(x_, mask, gam, beta, wqkv, bqkv, wd,
                                         bd, heads, seeds, rate, g_)
        return K.launch_mha_block_bwd(x_, mask, gam, beta, wqkv, wd, heads,
                                      seeds, rate, *saved[x_.dtype], g_)

    def plain(x_, *w):
        return K.mha_block_plain(x_, mask, *w, heads, seeds, rate)

    return Case(
        "mha_block_bwd_wide_bf16" if wide else "mha_block_bwd_bf16", MHA_NAMES,
        ("dx",), lambda: kernel(x, g),
        K.mha_block_bwd_plain,
        (x, mask, gam, beta, wqkv, bqkv, wd, bd, heads, seeds, rate, g,
         *saved[x.dtype]),
        lambda: kernel(x.float(), g.float()),
        lambda: _autograd(plain, [x, gam, beta, wqkv, bqkv, wd, bd], 7, g),
        (B, T, D, heads), MHA_LIMITS, axes={"dx": (1, 0)}, short_row=B - 1)


# --- #3b wide's attention forward (attn_fwd_wide_kernel), read as the
# backwards are: att [B, T, D] is fp32, summed from bf16 operands, so it is
# read against the twin (ops/kernels.py attention at bf16 on the kernel's
# own qkv) element by element over the element's magnitude mag = sum_j
# |bf16(drop(p))_tj| |v_jc|. Sums in another order move an element by fp32
# noise (~2^-20 of mag); a bf16(p) that rounds the other way moves it by
# one bf16 ulp of one term. Readings: `share`, of the elements off by more
# than ATT_NOISE of mag, and `elem`, the largest error over max(mag, its
# mean) in units of 2^-8, held to SHARE_TOL and ELEM_TOL; the impostors
# with q * scale or p unrounded must read beyond SHARE_TOL.
ATT_NOISE = 2.0 ** -12
ATT_LIMITS = {"share": SHARE_TOL, "elem": ELEM_TOL}
ATT_CONTROLS = {"q_unrounded": {"round_q": False},
                "p_unrounded": {"round_p": False}}


def attention_fwd_function(qkv, mask, heads, seeds, rate, work=torch.float32,
                           round_q=True, round_p=True):
    """The wide attention's function of qkv [B, T, 3D] (bf16 values) with
    every other value in `work`, its rounding points kept: bf16(q * scale)
    (scale = bf16(1/sqrt(hd))), p = softmax(qs . k^T + (1 - mask) * -1e30),
    bf16(drop(p)) . v. round_q, round_p False leave one of them unrounded
    (impostors the checks must refuse); work float64 evaluates the same
    function in float64. -> (att [B, T, D], mag [B, T, D])."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(B, T, D)

    q, k, v = (split(qkv[..., i * D:(i + 1) * D].to(work)) for i in range(3))
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float64)
                  .to(BF16))
    qs = q * scale
    if round_q:
        qs = qs.to(BF16).to(work)
    neg = ((1.0 - mask.to(work)) * -1e30).reshape(B, 1, 1, T)
    p = torch.softmax(qs @ k.transpose(-1, -2) + neg, dim=-1)
    if rate > 0.0:
        bits = torch.stack([K.mha_hash_bits(seeds, h, T)
                            for h in range(heads)], dim=1)
        p = K._drop_bits(p, bits, rate)
    if round_p:
        p = p.to(BF16).to(work)
    return merge(p @ v), merge(p @ v.abs())


def _att_reading(att, ref, mag):
    err = (att.double() - ref.double()).abs()
    mag = mag.double()
    floor = torch.clamp(mag, min=float(mag.mean()))
    return {"share": float((err > ATT_NOISE * mag).double().mean()),
            "elem": float((err / floor).max()) / ELEM_UNIT}


class AttnFwdCase(NamedTuple):
    """#3b wide's attention at one shape: kernel() returns the block
    forward's (qkv, att); the twin reads the same qkv."""
    kernel: Callable
    mask: torch.Tensor
    heads: int
    seeds: object
    rate: float
    shape: tuple


def attention_fwd_case(dev, rng, B, T, D, heads, rate):
    """The wide block forward at head dim 128 on x [B, T, D] in bf16,
    ragged key masks with the last row fully masked, drop rate `rate`."""
    lens = np.concatenate([rng.integers(1, T + 1, B - 1), [0]])
    x = _t(dev, rng.standard_normal((B, T, D))).to(BF16)
    mask = _t(dev, np.arange(T)[None, :] < lens[:, None])
    w = [_t(dev, 1 + 0.1 * rng.standard_normal((2, D))),
         _t(dev, 0.1 * rng.standard_normal((2, D))),
         _t(dev, rng.standard_normal((D, 3 * D)) / math.sqrt(D)),
         _t(dev, 0.1 * rng.standard_normal(3 * D)),
         _t(dev, rng.standard_normal((D, D)) / math.sqrt(D)),
         _t(dev, 0.1 * rng.standard_normal(D))]
    seeds = _t(dev, rng.integers(0, 1 << 23, (B, 1))) if rate else None
    return AttnFwdCase(
        lambda: K.launch_mha_block_fwd(x, mask, *w, heads, seeds, rate)[1:],
        mask, heads, seeds, rate, (B, T, D, heads))


def attention_fwd_read(case):
    """The kernel's and the impostors' readings against the twin, each
    against the fp64 evaluation (`fp64`: the kernel's and the twin's), the
    kernel's bits on two equal calls."""
    qkv, att = [t.clone() for t in case.kernel()]
    qkv2, att2 = case.kernel()
    torch.cuda.synchronize()
    args = (case.mask, case.heads, case.seeds, case.rate)
    D = qkv.shape[-1] // 3
    q, k, v = (qkv[..., i * D:(i + 1) * D].float() for i in range(3))
    twin = K.attention(q, k, v, case.mask, case.heads, case.seeds, case.rate,
                       BF16)
    _, mag = attention_fwd_function(qkv, *args)
    out = {"kernel": _att_reading(att, twin, mag)}
    for name, kw in ATT_CONTROLS.items():
        out[name] = _att_reading(attention_fwd_function(qkv, *args, **kw)[0],
                                 twin, mag)
    f64, mag64 = attention_fwd_function(qkv, *args, work=torch.float64)
    out["fp64"] = {"kernel": _att_reading(att, f64, mag64),
                   "twin": _att_reading(twin, f64, mag64)}
    out["equal_bits_twice"] = bool(torch.equal(att, att2)
                                   and torch.equal(qkv, qkv2))
    out["finite"] = bool(torch.isfinite(att).all())
    out["dtypes"] = [str(qkv.dtype).replace("torch.", ""),
                     str(att.dtype).replace("torch.", "")]
    return out


def attention_fwd_verdict(r, fp64=False):
    """(ok, reason): the kernel's readings within ATT_LIMITS of the twin
    (fp64: no further from the fp64 evaluation than the twin's plus the
    limits), both impostors beyond the share limit, equal bits twice, a
    finite att from a bf16 qkv."""
    for m, lim in ATT_LIMITS.items():
        got = r["fp64"]["kernel"][m] if fp64 else r["kernel"][m]
        if fp64:
            lim = r["fp64"]["twin"][m] + lim
        if not got <= lim:
            return False, "attn_fwd_wide: %s %g beyond the limits %g%s" % (
                m, got, lim, " (from fp64)" if fp64 else "")
    for name in ATT_CONTROLS:
        if not r[name]["share"] > ATT_LIMITS["share"]:
            return False, "attn_fwd_wide: control %s reads %g, within %g" % (
                name, r[name]["share"], ATT_LIMITS["share"])
    if not r["equal_bits_twice"]:
        return False, "attn_fwd_wide: two equal calls differ"
    if not r["finite"] or r["dtypes"] != ["bfloat16", "float32"]:
        return False, "attn_fwd_wide: att not finite or dtypes %s" % r["dtypes"]
    return True, ""


def attention_fwd_fault(case, fault):
    """The case with WIDE_FWD_FAULTS[fault] planted: the block forward from
    a changed copy of mha_block.cu, or an impostor att (q * scale or p
    unrounded) on the kernel's own qkv."""
    if fault in ATT_CONTROLS:
        def kernel():
            qkv, _ = case.kernel()
            return qkv, attention_fwd_function(
                qkv, case.mask, case.heads, case.seeds, case.rate,
                **ATT_CONTROLS[fault])[0]
        return case._replace(kernel=kernel)
    lib = _fault_library(fault)
    return case._replace(kernel=lambda: _with_library(lib, case.kernel))


ATTN_NAMES = ("dq", "dk", "dv")


def attention_case(dev, rng, B, T, D, heads, rate, flash):
    """#12b (whole-T) or #14b (flash) at bf16 on its bf16 forward's out
    (and lse): q, k, v and g [B, T, D] in bf16, ragged key masks with one
    row fully masked, drop rate `rate`. Beside the two controls, the other
    route's backward twin and, for #14b at a head dim whose scale bf16
    rounds (8, 32), its twin with the forward's bf16 scale."""
    f32 = torch.float32
    lens = np.concatenate([rng.integers(1, T + 1, B - 1), [0]])
    q, k, v = (_t(dev, rng.standard_normal((B, T, D))).to(BF16)
               for _ in range(3))
    mask = _t(dev, np.arange(T)[None, :] < lens[:, None])
    seeds = _t(dev, rng.integers(0, 1 << 23, (B, 1))) if rate else None
    g = _t(dev, rng.standard_normal((B, T, D))).to(BF16)
    qkv = {dt: [t.to(dt) for t in (q, k, v)] for dt in (BF16, f32)}
    if flash:
        saved = {dt: K.launch_flash_mha_fwd(*a, mask, heads, seeds, rate)
                 for dt, a in qkv.items()}

        def kernel(dt):
            return K.launch_flash_mha_bwd(*qkv[dt], mask, heads, seeds, rate,
                                          *saved[dt], g.to(dt))

        def fwd_twin(*a):
            return K.flash_attention_plain(*a, mask, heads, seeds, rate)[0]

        plain, args = K.flash_attention_bwd_plain, (
            q, k, v, mask, heads, seeds, rate, *saved[BF16], g)
        controls = {"whole": lambda: K.attention_bwd_plain(
            q, k, v, mask, heads, seeds, rate, g)}
        if K._head_scale(D // heads, BF16) != K._head_scale(D // heads, f32):
            controls["bf16_scale"] = lambda: K.flash_attention_bwd_plain(
                *args, scale_dtype=BF16)
    else:
        saved = {dt: K.launch_mha_fwd(*a, mask, heads, seeds, rate)
                 for dt, a in qkv.items()}

        def kernel(dt):
            return K.launch_mha_bwd(*qkv[dt], mask, heads, seeds, rate,
                                    saved[dt], g.to(dt))

        def fwd_twin(*a):
            return K.whole_attention_plain(*a, mask, heads, seeds, rate)

        plain, args = K.attention_bwd_plain, (q, k, v, mask, heads, seeds,
                                              rate, g)
        out, lse = K.flash_attention_plain(q, k, v, mask, heads, seeds, rate)
        controls = {"flash": lambda: K.flash_attention_bwd_plain(
            q, k, v, mask, heads, seeds, rate, out, lse, g)}
    return Case(
        "flash_mha_bwd_bf16" if flash else "mha_bwd_bf16", ATTN_NAMES,
        ATTN_NAMES, lambda: kernel(BF16), plain, args, lambda: kernel(f32),
        lambda: _autograd(fwd_twin, [q, k, v], 3, g), (B, T, D, heads),
        axes={"dq": (1, 0)}, short_row=B - 1, controls=controls)


# --- the bf16 block forwards on the tensor cores (#2c, #3b): each output
# held to its twin (conv_block_plain, mha_block_plain at bf16, cuBLAS's
# sums) and to an fp64 evaluation of the same function (the twin with its
# bf16 rounding points kept and every other value in float64), as the card
# tests hold the forwards: `scaled`, the largest error over max(1, the
# largest magnitude), within BF16_FWD_TOL; `share`, of the bf16 outputs
# that differ, within BF16_FWD_SHARE_TOL (tests/test_torch_cuda.py BF16_TOL
# and BF16_SHARE_TOL: the fp32 function's output differs on 12-15%); and
# `mean_rel`, the mean error over the mean magnitude, the distance whose
# mean over draws a change is held to against its parent (tc_bwd_fp64.py
# --fwd --against).
BF16_FWD_TOL = 2.0 ** -7
BF16_FWD_SHARE_TOL = 0.05
BLOCK_FWD_ENTRIES = {"conv": "conv_block_fwd_tiled_bf16", "mha": "mha_block_fwd_bf16"}
# planted faults, each an edit of the kernel's source (mma.cuh inlined for
# the product's): the last k16 step of the product left out, the second
# group of 4 k16 steps never added, B's fragments loaded untransposed, a
# term of the epilogue dropped (the conv's + bp, the QKV product's + bqkv)
TILE_MMA_FAULTS = {
    "k16_step_skipped": [("      for (int q = 0; q < 4; ++q) {\n        const int k0 = k + 16 * q;\n",
                          "      for (int q = 0; q < 4; ++q) {\n        const int k0 = k + 16 * q;\n"
                          "        if (k0 == Dk - 16) continue;\n")],
    "chain_group_not_added": [
        ("        for (int e = 0; e < 4; ++e) sum[h][e] = k ? sum[h][e] + c[h][e] : c[h][e];",
         "        for (int e = 0; e < 4; ++e) sum[h][e] = k ? sum[h][e] : c[h][e];")],
    "b_transpose_flipped": [("        ldsm_x4_trans(b, W + (size_t)(k0 + (lane & 15)) * ldw",
                             "        ldsm_x4(b, W + (size_t)(k0 + (lane & 15)) * ldw")],
}
BLOCK_FWD_FAULT_EDITS = {
    "conv": {**TILE_MMA_FAULTS, "epilogue_bias_dropped": [
        ("      const float a0 = v0 + b2.x, a1 = v1 + b2.y;",
         "      const float a0 = v0, a1 = v1;")]},
    "mha": {**TILE_MMA_FAULTS, "epilogue_bias_dropped": [
        ("                        vsl::pack_bf16(v0 + b2.x, v1 + b2.y);",
         "                        vsl::pack_bf16(v0, v1);")]},
}
BLOCK_FWD_SOURCES = {"conv": "conv_block.cu", "mha": "mha_block.cu"}


def block_fwd_inputs(dev, rng, kind, shape, rate):
    """(args, seeds) of a bf16 block forward at shape: the conv block's x
    [B, T, D] in bf16 and four layers' fp32 weights (plain draws, so that
    the ReLU mask varies), or the MHA block's x, a ragged key mask with
    its last row fully masked and the fp32 weights, and its heads; seeds
    per row where rate > 0."""
    if kind == "conv":
        B, T, D = shape
        L, KS = 4, 7
        args = [_t(dev, rng.standard_normal((B, T, D))).to(BF16),
                _t(dev, 1 + 0.1 * rng.standard_normal((L, D))),
                _t(dev, 0.1 * rng.standard_normal((L, D))),
                _t(dev, rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                _t(dev, rng.standard_normal((L, D, D)) / math.sqrt(D)),
                _t(dev, 0.1 * rng.standard_normal((L, D)))]
    else:
        B, T, D, heads = shape
        lens = np.concatenate([rng.integers(1, T + 1, B - 1), [0]])
        args = [_t(dev, rng.standard_normal((B, T, D))).to(BF16),
                _t(dev, np.arange(T)[None, :] < lens[:, None]),
                _t(dev, 1 + 0.1 * rng.standard_normal((2, D))),
                _t(dev, 0.1 * rng.standard_normal((2, D))),
                _t(dev, rng.standard_normal((D, 3 * D)) / math.sqrt(D)),
                _t(dev, 0.1 * rng.standard_normal(3 * D)),
                _t(dev, rng.standard_normal((D, D)) / math.sqrt(D)),
                _t(dev, 0.1 * rng.standard_normal(D)), heads]
    seeds = _t(dev, rng.integers(0, 1 << 23, (shape[0], 1))) if rate else None
    return args, seeds


def block_fwd(kind, args, seeds, rate):
    """The bf16 forward kernel's output through its launch wrapper."""
    if kind == "conv":
        return K.launch_conv_block_fwd_tiled(*args, seeds, rate)[0]
    return K.launch_mha_block_fwd(*args, seeds, rate)[0]


def block_fwd_twin(kind, args, seeds, rate, work=torch.float32, plain=None):
    """The forward's twin at bf16, its products and residuals in `work`
    (float64: the fp64 evaluation); plain: a tree's ops/kernels.py (this
    one's by default)."""
    plain = plain or K
    fn = plain.conv_block_plain if kind == "conv" else plain.mha_block_plain
    return fn(*args, seeds, rate, residual_dtype=work)


def block_fwd_reading(out, ref):
    """{scaled, share, mean_rel} of a bf16 output against ref."""
    o, r = out.double(), ref.double()
    return {"scaled": float((o - r).abs().max() / max(1.0, float(r.abs().max()))),
            "share": float((out != ref.to(out.dtype)).float().mean()),
            "mean_rel": float((o - r).abs().mean() / r.abs().mean().clamp_min(1e-30))}


def block_fwd_read(kind, args, seeds, rate, out, plain=None):
    """{"kernel": against the twin, "fp64": against the fp64 evaluation,
    "twin_fp64": the twin against it} of the forward's output out."""
    twin = block_fwd_twin(kind, args, seeds, rate, plain=plain)
    f64 = block_fwd_twin(kind, args, seeds, rate, torch.float64, plain)
    return {"kernel": block_fwd_reading(out, twin), "fp64": block_fwd_reading(out, f64),
            "twin_fp64": block_fwd_reading(twin, f64)}


def block_fwd_verdict(r):
    """(ok, reason): scaled and share within their limits against the twin
    and against fp64."""
    for against in ("kernel", "fp64"):
        got = r[against]
        if not (got["scaled"] <= BF16_FWD_TOL and got["share"] <= BF16_FWD_SHARE_TOL):
            return False, "beyond the limits against the %s: %s" % (
                "twin" if against == "kernel" else "fp64 evaluation", got)
    return True, ""


def block_fwd_fault_libraries(kind):
    """{fault: the kernel library with the bf16 forward of `kind` from a
    copy of its source with BLOCK_FWD_FAULT_EDITS[kind][fault]}, the
    copies built at once."""
    from vslnet_torch.bench.common import build_copies, edited_source, library_with

    edits = BLOCK_FWD_FAULT_EDITS[kind]
    copies = build_copies({
        "fwd_%s_%s" % (kind, fault): edited_source(
            "fwd_%s_%s" % (kind, fault), BLOCK_FWD_SOURCES[kind], e, inline=("mma.cuh",))
        for fault, e in edits.items()})
    return {fault: library_with(copies["fwd_%s_%s" % (kind, fault)],
                                [BLOCK_FWD_ENTRIES[kind]]) for fault in edits}


def block_fwd_fault(kind, args, seeds, rate, lib):
    """The forward's output with a planted fault (lib: one of
    block_fwd_fault_libraries(kind))."""
    return _with_library(lib, lambda: [block_fwd(kind, args, seeds, rate)])[0]


KINDS = ("lstm", "conv", "conv_tiled", "mha", "mha_whole", "flash",
         "conv_wide", "mha_wide")


def card_cases(dev, kind):
    """The card tests' cases of one bf16 backward (KINDS), the main path's
    shape first (the whole-T backward's path M, the flash backward's path
    L, the wide kernels' `saturated`): T = 12 (the query stream), T = 30,
    head dim 8, a fully masked row (every MHA and attention case), drop 0
    and 0.2."""
    rng = np.random.default_rng(36)
    if kind in ("mha_whole", "flash"):
        shapes = ([(16, 192, 128, 8), (4, 146, 128, 4), (2, 200, 64, 8),
                   (2, 100, 128, 2)] if kind == "mha_whole" else
                  [(8, 1024, 128, 8), (2, 300, 64, 8), (2, 256, 128, 4),
                   (2, 210, 128, 2), (2, 1152, 64, 8)])
        return [attention_case(dev, rng, *shape, rate, kind == "flash")
                for shape in shapes for rate in (0.0, 0.2)]
    if kind == "lstm":
        return [lstm_case(dev, rng, T, B, H) for T, B, H in
                [(128, 16, 128), (12, 4, 8), (30, 5, 100)]]
    if kind == "conv":  # the whole-row route's T < 48: the query stream first
        return [conv_case(dev, rng, B, T, D, rate)
                for B, T, D in [(16, 12, 128), (16, 47, 128), (2, 13, 16),
                                (4, 30, 128)] for rate in (0.0, 0.2)]
    if kind == "conv_tiled":
        return [conv_case(dev, rng, B, T, D, rate, True)
                for B, T, D in [(16, 128, 128), (16, 12, 128), (2, 13, 16),
                                (4, 30, 128)] for rate in (0.0, 0.2)]
    if kind == "conv_wide":  # `saturated`'s video and query streams
        return [conv_case(dev, rng, B, T, D, rate, wide=True)
                for B, T, D in [(256, 128, 1024), (32, 24, 1024),
                                (2, 13, 896)] for rate in (0.0, 0.2)]
    if kind == "mha_wide":
        return [mha_case(dev, rng, B, T, D, heads, rate)
                for B, T, D, heads in [(256, 128, 1024, 8), (32, 24, 1024, 8),
                                       (3, 10, 256, 2), (2, 128, 256, 2)]
                for rate in (0.0, 0.2)]
    return [mha_case(dev, rng, B, T, D, heads, rate)
            for B, T, D, heads in [(16, 128, 128, 8), (16, 12, 128, 8),
                                   (3, 10, 16, 2), (4, 40, 128, 4),
                                   (2, 64, 128, 2), (4, 30, 128, 8)]
            for rate in (0.0, 0.2)]


def main():
    """One JSON line a case of card_cases: its readings, verdict and, for
    the main path's shape, each planted fault's verdict and reading."""
    from vslnet_torch.bench.common import card

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"card": card()}), flush=True)
    for kind in KINDS:
        for i, case in enumerate(card_cases(dev, kind)):
            r = read(case)
            row = {"kind": kind, "shape": list(case.shape),
                   "verdict": verdict(case, r), "limits": limits(case), **r}
            if i == 0:
                row["faults"] = {}
                for fault in FAULTS:
                    if kind == "lstm" and fault == "last_frame_fp32":
                        continue  # control (a)'s last frame is the twin's
                    bad = planted(case, fault)
                    rb = read(bad)
                    row["faults"][fault] = {
                        "verdict": verdict(bad, rb),
                        "reading": rb["kernel"][case.names[0]]}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
