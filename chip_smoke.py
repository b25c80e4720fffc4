#!/usr/bin/env python3
"""Drive the PyTorch port (vslnet_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   the card's name and power limit (and the nvidia-smi line);
              TF32 off for matmuls and cuDNN, so fp32 means fp32.
  2. build    compiles vslnet_torch/csrc/*.cu with nvcc (sm_90a) into
              vslnet_torch/_build/ and reports the seconds it took.
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card at the served shapes (random inputs, ragged lengths):
              max abs difference against the stated tolerance, the kernel's
              and the plain version's time (CUDA events), the least time the
              card could take (bound), and for the LSTM a cuDNN yardstick
              (the two LSTM forwards must beat it), its time a step and
              its launch plan.
              The training kernels (the LSTM forward with residuals and its
              reverse recurrence, the conv and MHA block backwards) and the
              two block forwards with dropout are held the same way at the
              training shapes (T = 128 and the query stream's T = max_w,
              drop_rate 0.2, one fully masked query row): the forward, every
              gradient of sum(out * g), and the dropout's zero pattern
              (the conv block's on plain draws, g 0 on the frames whose
              gradient passes a pre-ReLU within KINK of 0, counted);
              the conv block's forward (also the T-tiled forward's bits)
              and the MHA block's forward and backward also give equal
              bits on two equal calls. CQA runs on its plan at the served
              shape, at path L's [8, 1024] and with 64 words there (masked
              tiles and rows, a padded query), with equal bits twice; the
              highlight gate and span decode also at path L's shape (the
              span decode there also with ties planted across its
              chunks, threads and warps, decoded to the planted frames).
              The cluster and tiled kernels carry their launch plans;
              conv_route must send the conv block at [16, 128, 128] to the
              faster of the whole-row and the T-tiled kernels by device
              time, the forward alone when serving and forward with
              backward when training; the MHA block's forward and backward
              must beat those of the unfused block (its PyTorch ops around
              the whole-T attention kernels), each timed in the same run.
              Those rows give beside ms (CUDA events around back-to-back
              calls, as every row, which time the wrapper's host work
              once it outlasts the kernels, and so vary with the host's
              load) device_ms, the device time of a call's kernels
              (torch.profiler), and hold the kernel below its yardstick
              by device time.
  4. slice    the rnn VSLNet at full width (hidden 128, 8 heads, T 128,
              1024-d video features, 300-d GloVe, batch 16), seeded numpy
              weights in the flax layout loaded through convert_flax, a
              synthetic dataset at Charades shapes; serves HTTP requests
              through Localizer + make_server, counts the kernel launches of
              that run, and holds logits and spans against the same weights
              with every kernel off (use_pallas=off) on the card; times a
              served batch of 16 both ways and profiles one (device time by
              kernel, the card's idle share).
  5. train    the same model trained by vslnet_torch.train.Trainer on the
              synthetic training split (drop_rate 0.2, bert_adamw, lr 1e-4
              with linear decay, clip 1.0, l2 3e-7, highlight lambda 5): one
              step with the kernels against one with use_pallas=off from the
              same weights and generator seed (loss and every gradient), then
              20 steps with the kernels, counting their launches (the loss
              must fall), the step time both ways, one profiled step, and an
              evaluation of the test split (R1@{0.3,0.5,0.7}, mIoU).
  5b. bf16    precision=bf16: the four bf16 kernels (the LSTM recurrence
              at [128, 16, 512], the conv block whole-row at the query
              stream's [16, max_w, 128] and T-tiled at [16, 128, 128], the
              MHA block at [16, 128, 128] and max_w) against their bf16
              twins on the card (BF16_LSTM_TOL, BF16_TOL; and
              BF16_LSTM_MEAN_TOL, BF16_SHARE_TOL, which the fp32 function
              must fail), equal bits on
              two equal calls, their time by CUDA events and by
              torch.profiler, the twin's time, the bound at the bf16
              peak (cuDNN's bf16 nn.LSTM beside #1, which the LSTM
              forwards, on the tensor-core kernel alone, must beat; and
              their distance from an fp64 evaluation of the bf16
              function, within the twin's plus a slack); then the slice
              phase's model at bf16 with the same seeded weights: the
              slice phase's HTTP requests, their launches equal to the
              fp32 run's kernel by kernel with the four under their bf16
              entries, the logits against the composition of the twins,
              use_pallas=off at bf16 and the fp32 model (BF16_MODEL_TOL),
              the share of spans equal to the fp32 model's, a served
              batch profiled beside the fp32 one.
  5c. bf16_train  precision=bf16 training: the five bf16 training entry
              points (the LSTM forward with residuals and its backward at
              [128, 16, 512], the conv block backward whole-row at [16,
              max_w, 128] and T-tiled at [16, 128, 128], the MHA block
              backward at [16, 128, 128] and max_w; drop 0 and 0.2)
              against their plain twins on the card
              (vslnet_torch/bench/bf16_vjp.py: the share of a bf16 output
              that differs, overall and within one frame or row, one
              element's error over its magnitude, a weight gradient's
              mean error over its mean magnitude, each within its limit,
              while the fp32 kernel's gradient and torch's autograd of
              the bf16 forward twin must exceed the share's), equal bits
              twice, their time by CUDA events and
              by torch.profiler, the twin's time, the bound at the bf16
              peak, cuDNN's bf16 nn.LSTM beside the LSTM's; then the
              train phase's model at bf16: one step against the bf16
              twins' composition (forward and backward; the fp32
              model's step must fail that bound) and against
              use_pallas=off at bf16, 20 steps whose launches equal the
              fp32 train phase's kernel by kernel under the bf16 entries,
              the loss falling, a step profiled at fp32, bf16, bf16,
              fp32 in turns.
  6. long_t   beyond T = 145, where the whole-row conv and MHA block
              kernels do not fit: the whole-T and flash attention kernels
              (forward, backward) and the T-tiled conv block (forward,
              backward) against their plain versions at the paths' shapes
              (output, every gradient, dropout zero pattern; SDPA as the
              attention yardstick; the flash forward and backward, the
              whole-T backward and the tiled conv forward and backward
              give equal bits on two equal calls and carry their plans and
              device time by kernel (the tiled forward at both paths, with
              its bound), the tiled backward's dropout and ReLU zero
              pattern is the plain version's, and the flash and whole-T
              backwards must beat SDPA's backward by events, the whole-T
              one also by device time); then path M (rnn,
              max_pos_len 192, batch 16) and path L (transformer,
              max_pos_len 1024, batch 8): a served batch against
              use_pallas=off, one train step against off, then 3 (M) or
              10 (L) steps with the kernels (on L the loss must fall),
              with their launches, step times and profiles (a served
              batch and a step each).
  6b. bf16_long  precision=bf16 beyond T = 145: the bf16 whole-T (#11b,
              #12b) and flash (#13b, #14b) kernels against their twins at
              path M's and path L's shapes (the forwards' share of bf16
              outputs that differ, which the fp32 function and the other
              route's twin must fail; the backwards' bench/bf16_vjp.py
              readings and controls), timed beside the fp32 kernel on the
              same inputs and SDPA in bf16 (#13b, on the tensor cores,
              must take less device time than SDPA's forward); then
              paths M and L at bf16: a
              served batch against the twins' composition on the card
              (use_pallas=off at bf16 and the fp32 model reported), one
              train step against it, 3 (M) or 10 (L) steps (on L the loss
              must fall), launches per path, a served batch and a step
              profiled at fp32, bf16, bf16, fp32 in turns.
  7. cli      `python -m vslnet_torch` on a seeded Charades-format data
              root in processes of their own: train, resume, test (also
              at --precision bf16 on the same model directory), predict,
              serve; --mode train --precision bf16 in a model directory of
              its own, its resume and its test; an epoch of the
              transformer at --max_pos_len 1024 --precision bf16 (the
              flash kernels) and its test; the copy rows before them and
              the C5 shapes after.
  8. saturated  the JAX bench's `saturated` configuration (the
              transformer at hidden 1024 in 8 heads of 128, batch 256, T
              128, bf16; bench.py's dataset): the wide kernels (#2c, #9c
              at D = 1024; #3b, #10b at head dim 128) against their twins
              at its shapes (the forwards' share of differing bf16 outputs,
              which the fp32 function must fail; the backwards'
              bench/bf16_vjp.py readings and controls), timed beside their
              twins with their bounds; a served batch of 256 against the
              twins' composition, use_pallas=off and the fp32 model, every
              module's route read from its launches (conv and MHA on the
              wide kernels), 3 train steps at drop 0.2 against
              use_pallas=off, a served batch and a step profiled with and
              without the kernels.
Then the "kernels" line, and last {"ok": true, "device": {...}}.
Any failure raises and exits non-zero before the last line.
"""
import functools
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

TOL = 1e-4          # fp32 kernel vs plain version: summation order only
LOGIT_ATOL = 1e-3   # whole model, kernels vs plain, on the served logits
# A train step with the kernels vs use_pallas=off: the loss within 1e-4
# relative; each parameter's gradient within GRAD_RTOL of its largest
# entry (fp32 sums in another order through two 128-step LSTM chains, four
# blocks and their batch-summed weight gradients) plus GRAD_ATOL, for the
# gradients that are zero up to rounding (the start and end heads' biases:
# the softmax CE's gradient sums to 0 over a row).
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_ATOL = 1e-6
DROP = 0.2          # the training phase's drop_rate (the reference's)
TRAIN_STEPS = 20
SEED = 0
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(work, nbytes):
    """vslnet_torch/bench/common.py bound_ms, the yardstick of every row:
    (ms, "operations" or "bytes") of work {"fp32" or "bf16": the FLOPs done
    at that type's peak} and nbytes (inputs read once, outputs written
    once)."""
    from vslnet_torch.bench.common import bound_ms

    return bound_ms(work, nbytes)


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def scaled_err(a, b):
    """max |a - b| over max(1, max |b|): an absolute error for values of
    order one, a relative one for the large batch-summed gradients."""
    return max_err(a, b) / max(1.0, float(b.double().abs().max()))


def autograd_pair(fn, plain, args, n_grad, g):
    """The output and the gradients of sum(out * g) with respect to the
    first n_grad args, through fn (the kernels' autograd Function) and
    through torch's autograd of the plain version, on the same inputs:
    (max abs error, the output's abs error and the gradients' scaled_err,
    all finite)."""
    import torch

    res = []
    for f in (fn, plain):
        leaves = [a.detach().clone().requires_grad_(i < n_grad)
                  for i, a in enumerate(args)]
        out = f(*leaves)
        grads = torch.autograd.grad(out, leaves[:n_grad], g)
        torch.cuda.synchronize()
        res.append((out.detach(), grads))
    (out, grads), (out_ref, grads_ref) = res
    pairs = [(out, out_ref), *zip(grads, grads_ref)]
    abs_err = max(max_err(a, b) for a, b in pairs)
    err = max([max_err(out, out_ref)]
              + [scaled_err(a, b) for a, b in zip(grads, grads_ref)])
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    return abs_err, err, finite


# a pre-ReLU this close to 0 may take either side in fp32 sums of another
# order: a hundred times the ~1e-6 at which such flips were seen
KINK = 1e-4


def kink_frames(args, seeds, rate):
    """The frames [B, T] (bool) of conv block inputs args through which a
    gradient reaches a pre-ReLU within KINK of 0: the plain forward in
    fp64, a layer-l pre-activation at frame t reaching the block's output
    at frames t +- (L - 1 - l) * (k // 2) through the later layers' taps.
    Where fp32 sums in another order than cuBLAS's put such a pre-ReLU on
    the other side, the mask [p > 0] moves the gradients around it by
    ~0.1 in the kernels and the plain version alike; a g of 0 on these
    frames gives that mask no weight in any gradient, and leaves the
    others' masks as drawn, varying by frame."""
    import torch
    import torch.nn.functional as F

    from vslnet_torch.ops import kernels as K

    x, gam, beta, dw, wp, bp = (a.double() for a in args)
    L, k, D = dw.shape
    near = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    for l in range(L):
        c = x - x.mean(-1, keepdim=True)
        h = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + 1e-6)
        h = F.pad((h * gam[l] + beta[l]).transpose(1, 2),
                  ((k - 1) // 2, k // 2))
        p = F.conv1d(h, dw[l].t().unsqueeze(1), groups=D).transpose(1, 2)
        p = p @ wp[l] + bp[l]
        reach = (L - 1 - l) * (k // 2)
        near |= F.max_pool1d((p.abs() < KINK).any(-1)[:, None].double(),
                             2 * reach + 1, 1, reach)[:, 0] > 0
        x = x + K.site_dropout(torch.relu(p), seeds, 0x100 + l, rate)
    return near


def tiled_bwd_zeros(args, seeds):
    """The T-tiled backward's masks at conv block inputs args [B, T, D]: for
    their first layer and a g that is 1 on frame t of row 0 only, dbp =
    keep(t, o) [p(t, o) > 0] / (1 - rate) is 0 exactly where the plain
    version's autograd has it 0, at frames on the plan's tile edges: one
    bool a frame."""
    import torch

    from vslnet_torch.ops import kernels as K

    B, T, D = args[0].shape
    KS = args[3].shape[1]
    one = [args[0]] + [w[:1].contiguous() for w in args[1:]]
    _, xs1 = K.launch_conv_block_fwd_tiled(*one, seeds, DROP)
    frames = K.conv_tiled_bwd_plan(B, T, D, KS, 1).frames
    zeros = []
    for t_ in (0, frames - 1, frames, T // 2, T - 1):
        g1 = torch.zeros_like(args[0])
        g1[0, t_] = 1.0
        dbp = K.launch_conv_block_bwd_tiled(one[0], xs1, *one[1:], seeds,
                                            DROP, g1)[5]
        one_l = [a.clone().requires_grad_() for a in one]
        ref = torch.autograd.grad(K.conv_block_plain(*one_l, seeds, DROP),
                                  one_l[5], g1)[0]
        zeros.append(torch.equal(dbp == 0, ref == 0))
    return zeros


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# --- phase 3 -------------------------------------------------------------------


def lstm_yardstick(x_proj, k_h):
    """cuDNN nn.LSTM computing the same recurrence on right-padded rows:
    input weights select the pre-projected gates, TF's [i, j, f, o] is
    permuted to torch's [i, f, g, o] and the forget bias folded in."""
    import torch

    H = k_h.shape[0]
    perm = torch.cat([torch.arange(0, H), torch.arange(2 * H, 3 * H),
                      torch.arange(H, 2 * H), torch.arange(3 * H, 4 * H)])
    lstm = torch.nn.LSTM(4 * H, H).to(x_proj.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H, device=x_proj.device)[perm])
        lstm.weight_hh_l0.copy_(k_h.t()[perm])
        lstm.bias_ih_l0.zero_()
        lstm.bias_ih_l0[H:2 * H] = 1.0
        lstm.bias_hh_l0.zero_()
    return lstm


def plan_fields(plan):
    return {"n": plan.n, "bt": plan.bt, "ctas": plan.n * plan.clusters,
            "threads": plan.threads, "splits": plan.splits,
            "smem_bytes": plan.smem, "smem_bwd_bytes": plan.smem_bwd}


def kernel_row(name, source, replaces, err, tol, ms, plain_ms, work, nbytes,
               library_ms=None, checked_err=None, **extra):
    """One kernel's row, emitted and held to tol. checked_err, where given,
    is what is held to tol (scaled_err for gradients); err is always the
    raw max abs error. The bound is bound(work, nbytes)."""
    bound_ms, bound_by = bound(work, nbytes)
    checked = err if checked_err is None else checked_err
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": err, "tol": tol,
           "checked_err": checked, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, **extra}
    emit({"phase": "kernel", **row})
    check(checked <= tol, "%s disagrees with its plain version: error "
          "%g > %g" % (name, checked, tol))
    return row


def kernel_phase(dev, max_w):
    import torch

    from vslnet_torch.bench.common import by_kernel
    from vslnet_torch.bench.span_ties import (SPAN_TIES_1024,
                                             span_tie_logits,
                                             span_ties_expected)
    from vslnet_torch.ops import kernels as K

    rng = np.random.default_rng(SEED)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    B, T, D, H, L, KS, heads = 16, 128, 128, 128, 4, 7, 8
    rows = []

    def record(*args, **kw):
        rows.append(kernel_row(*args, **kw))

    def seeds_for(n):
        return t(rng.integers(0, 1 << 23, (n, 1)))

    # 1. LSTM recurrence [T, B, 4H]
    lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])
    x_proj = t(rng.standard_normal((T, B, 4 * H)))
    k_h = t(rng.standard_normal((H, 4 * H)) / math.sqrt(H))
    valid = t(np.arange(T)[:, None] < lens[None, :])
    out = K.fused_lstm_recurrence(x_proj, k_h, valid)
    torch.cuda.synchronize()
    err = max_err(out, K.lstm_recurrence_plain(x_proj, k_h, valid))
    lstm = lstm_yardstick(x_proj, k_h)
    with torch.no_grad():
        lib_out = lstm(x_proj)[0]
        ms_lib = cuda_ms(lambda: lstm(x_proj), 20)
    vmask = valid.bool()
    lib_err = float((lib_out - out).abs()[vmask].max())
    plan = K.lstm_plan(B, H)
    ms = cuda_ms(lambda: K.fused_lstm_recurrence(x_proj, k_h, valid), 20)
    record("lstm_recurrence_fwd", "vslnet_torch/csrc/lstm.cu",
           "vslnet_tpu/ops/pallas_kernels.py:241", err, TOL, ms,
           cuda_ms(lambda: K.lstm_recurrence_plain(x_proj, k_h, valid), 3),
           # only the valid steps need the product: padding freezes the state
           {"fp32": 2 * int(lens.sum()) * H * 4 * H},
           4 * (T * B * 4 * H + H * 4 * H + T * B + T * B * H),
           library_ms=ms_lib, library_max_abs_err_valid=lib_err,
           shape=[T, B, 4 * H], us_per_step=ms * 1e3 / T,
           plan=plan_fields(plan))
    check(ms < ms_lib, "lstm_recurrence_fwd: %g ms, not below cuDNN's %g"
          % (ms, ms_lib))

    # 2. conv block [B, T, D] and at the query length
    def conv_inputs(T_):
        return [t(rng.standard_normal((B, T_, D))),
                t(1 + 0.1 * rng.standard_normal((L, D))),
                t(0.1 * rng.standard_normal((L, D))),
                t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                t(rng.standard_normal((L, D, D)) / math.sqrt(D)),
                t(0.1 * rng.standard_normal((L, D)))]

    # the whole-row kernel itself (launch_conv_block_fwd) at T and at max_w
    fwd = K.launch_conv_block_fwd
    q_args = conv_inputs(max_w)
    q_err = max_err(fwd(*q_args), K.conv_block_plain(*q_args))
    args = conv_inputs(T)
    err = max_err(fwd(*args), K.conv_block_plain(*args))
    # with dropout (the training forward), at T and at max_w
    seeds = seeds_for(B)
    drop = {"seeds": seeds, "drop_rate": DROP}
    d_err = max(max_err(fwd(*a, **drop), K.conv_block_plain(*a, **drop))
                for a in (args, q_args))
    # one layer: out - x is 0 exactly where its mask (or the ReLU) drops
    one = [args[0]] + [w[:1].contiguous() for w in args[1:]]
    zeros_equal = torch.equal(fwd(*one, **drop) == args[0],
                              K.conv_block_plain(*one, **drop) == args[0])
    check(zeros_equal, "conv_block_fwd: the dropout zero pattern differs")
    # no atomics, a fixed order of every sum: two equal calls, equal bits;
    # the T-tiled forward does the same arithmetic in the same order
    twice = torch.equal(fwd(*args, **drop), fwd(*args, **drop))
    check(twice, "conv_block_fwd: two equal calls differ")
    tiled_bits = torch.equal(fwd(*args, **drop),
                             K.launch_conv_block_fwd_tiled(*args, **drop)[0])
    check(tiled_bits, "conv_block_fwd: the tiled forward's bits differ")
    # the cluster forward against the T-tiled one at the same shape and at
    # max_w, in this run, by CUDA events around back-to-back calls and by
    # the device time of a call's kernels (torch.profiler): conv_route must
    # send a forward alone (serving) to the faster by device time (events
    # time the host once it outlasts the kernel)
    parts = by_kernel(lambda: fwd(*args))
    tiled_parts = by_kernel(lambda: K.launch_conv_block_fwd_tiled(*args))
    device_ms = sum(parts.values())
    tiled_device_ms = sum(tiled_parts.values())
    q_device_ms = sum(by_kernel(lambda: fwd(*q_args)).values())
    q_tiled_device_ms = sum(by_kernel(
        lambda: K.launch_conv_block_fwd_tiled(*q_args)).values())
    route = K.conv_route(T, D, KS, L)
    record("conv_block_fwd", "vslnet_torch/csrc/conv_block.cu",
           "vslnet_tpu/ops/pallas_kernels.py:1019", max(err, q_err, d_err), TOL,
           cuda_ms(lambda: fwd(*args), 50),
           cuda_ms(lambda: K.conv_block_plain(*args), 50),
           {"fp32": L * 2 * B * T * D * (D + KS)},
           4 * (2 * B * T * D + L * (3 * D + KS * D + D * D)),
           shape=[B, T, D], query_T=max_w, query_max_abs_err=q_err,
           dropout_max_abs_err=d_err, dropout_zero_pattern_equal=zeros_equal,
           equal_bits_twice=twice, tiled_equal_bits=tiled_bits,
           dropout_ms=cuda_ms(lambda: fwd(*args, **drop), 50),
           dropout_plain_ms=cuda_ms(
               lambda: K.conv_block_plain(*args, **drop), 50),
           plan=K.conv_fwd_plan(B, T, D, KS, L)._asdict(),
           query_plan=K.conv_fwd_plan(B, max_w, D, KS, L)._asdict(),
           device_ms=device_ms, by_kernel=parts,
           tiled_ms=cuda_ms(lambda: K.launch_conv_block_fwd_tiled(*args), 50),
           tiled_device_ms=tiled_device_ms, tiled_by_kernel=tiled_parts,
           tiled_plan=K.conv_tiled_fwd_plan(B, T, D, KS, L)._asdict(),
           query_ms=cuda_ms(lambda: fwd(*q_args), 50),
           query_device_ms=q_device_ms,
           query_tiled_device_ms=q_tiled_device_ms, route_serve=route,
           query_route_serve=K.conv_route(max_w, D, KS, L))
    check(route == ("tiled" if tiled_device_ms < device_ms else "block"),
          "conv_route: serving at [%d, %d, %d] takes the %s forward, but the "
          "whole-row one takes %g ms of device time and the tiled one %g"
          % (B, T, D, route, device_ms, tiled_device_ms))
    conv_args, conv_q_args = args, q_args

    # 3. MHA block [B, T, D] and at the query length, one row fully masked
    def mha_inputs(T_, lens_):
        return [t(rng.standard_normal((B, T_, D))),
                t(np.arange(T_)[None, :] < np.asarray(lens_)[:, None]),
                t(1 + 0.1 * rng.standard_normal((2, D))),
                t(0.1 * rng.standard_normal((2, D))),
                t(rng.standard_normal((D, 3 * D)) / math.sqrt(D)),
                t(0.1 * rng.standard_normal((3 * D,))),
                t(rng.standard_normal((D, D)) / math.sqrt(D)),
                t(0.1 * rng.standard_normal((D,)))]

    q_args = mha_inputs(max_w, list(rng.integers(1, max_w + 1, B - 1)) + [0])
    q_out = K.fused_mha_block(*q_args, heads)
    check(bool(torch.isfinite(q_out).all()),
          "mha_block_fwd: non-finite output on a fully masked row")
    q_err = max_err(q_out, K.mha_block_plain(*q_args, heads))
    args = mha_inputs(T, lens)
    err = max_err(K.fused_mha_block(*args, heads),
                  K.mha_block_plain(*args, heads))
    # with dropout, at T and at max_w (one fully masked row)
    drop = {"seeds": seeds_for(B), "drop_rate": DROP}
    d_err = max(max_err(K.fused_mha_block(*a, heads, **drop),
                        K.mha_block_plain(*a, heads, **drop))
                for a in (args, q_args))
    # zero q, k, v and an identity dense layer: out - x is drop(drop(LN2
    # (x))), 0 exactly where the 0x202 or the 0x203 mask drops
    x, mask = args[:2]
    probe = [x, mask, *args[2:4], torch.zeros_like(args[4]),
             torch.zeros_like(args[5]), torch.eye(D, device=dev),
             torch.zeros_like(args[7])]
    zeros_equal = torch.equal(K.fused_mha_block(*probe, heads, **drop) == x,
                              K.mha_block_plain(*probe, heads, **drop) == x)
    check(zeros_equal, "mha_block_fwd: the dropout zero pattern differs")
    # no atomics, a fixed order of every sum: two equal calls, equal bits
    twice = all(torch.equal(a, b) for a, b in zip(
        K.launch_mha_block_fwd(*args, heads, **drop),
        K.launch_mha_block_fwd(*args, heads, **drop)))
    check(twice, "mha_block_fwd: two equal calls differ")

    def unfused():
        """The block's PyTorch ops around the whole-T attention kernel
        (mha_block_unfused) at the same inputs."""
        with torch.no_grad():
            K.mha_block_unfused(*args, heads)

    # the kernels against the unfused forward at the same shape, in this
    # run, by CUDA events around back-to-back calls and by the device time
    # of a call's kernels (torch.profiler): the kernels must be the faster
    # by device time
    parts = by_kernel(lambda: K.launch_mha_block_fwd(*args, heads))
    device_ms = sum(parts.values())
    unfused_device_ms = sum(by_kernel(unfused).values())
    # scores and P.V need only the valid keys (all T for a fully masked row)
    keys = int(lens.sum())
    record("mha_block_fwd", "vslnet_torch/csrc/mha_block.cu",
           "vslnet_tpu/ops/pallas_kernels.py:1736", max(err, q_err, d_err), TOL,
           cuda_ms(lambda: K.fused_mha_block(*args, heads), 50),
           cuda_ms(lambda: K.mha_block_plain(*args, heads), 50),
           {"fp32": 2 * B * T * D * 3 * D + 4 * T * keys * D + 2 * B * T * D * D},
           4 * (2 * B * T * D + B * T + 4 * D + 4 * D * D + 4 * D),
           shape=[B, T, D], heads=heads, query_T=max_w,
           query_max_abs_err=q_err, dropout_max_abs_err=d_err,
           dropout_zero_pattern_equal=zeros_equal, equal_bits_twice=twice,
           dropout_ms=cuda_ms(lambda: K.fused_mha_block(*args, heads, **drop),
                              50),
           dropout_plain_ms=cuda_ms(
               lambda: K.mha_block_plain(*args, heads, **drop), 50),
           plan=K.mha_fwd_plan(B, T, D, heads)._asdict(),
           query_plan=K.mha_fwd_plan(B, max_w, D, heads)._asdict(),
           device_ms=device_ms, by_kernel=parts,
           unfused_ms=cuda_ms(unfused, 50), unfused_device_ms=unfused_device_ms,
           query_ms=cuda_ms(lambda: K.launch_mha_block_fwd(*q_args, heads), 50),
           query_device_ms=sum(by_kernel(
               lambda: K.launch_mha_block_fwd(*q_args, heads)).values()))
    check(device_ms < unfused_device_ms, "mha_block_fwd: %g ms of device "
          "time, not below the unfused block's forward %g"
          % (device_ms, unfused_device_ms))
    mha_args, mha_q_args = args, q_args

    # 4. context-query attention on cqa_plan at the served shape: video [B,
    # T, D], query [B, max_w, D], ragged lengths and one padded query (every
    # word masked); at path L's [8, 1024] (rows past whole tiles, one row
    # with every frame masked, a padded query); and at W = 64 there, which
    # the one-block-a-row kernel refused. Each within TOL of the plain
    # version, equal bits on two calls, its device time (torch.profiler)
    # and its bound at every shape it is timed at
    def cqa_inputs(B_, T_, W_, v_lens, q_lens):
        return [t(rng.standard_normal((B_, T_, D))),
                t(rng.standard_normal((B_, W_, D))),
                t(np.arange(T_)[None, :] < np.asarray(v_lens)[:, None]),
                t(np.arange(W_)[None, :] < np.asarray(q_lens)[:, None]),
                *[t(rng.standard_normal(D) / math.sqrt(D)) for _ in range(3)]]

    def cqa_work(B_, T_, W_):
        """FLOPs (scores, both softmaxes, v2q, Sv^T.v, Sq.A, the products)
        and bytes (v, q, masks and weights read, the concat written)."""
        return ({"fp32": B_ * (8 * T_ * W_ * D + 5 * T_ * D + 2 * W_ * D
                               + 18 * T_ * W_)},
                4 * (B_ * T_ * D + B_ * W_ * D + B_ * T_ + B_ * W_ + 3 * D
                     + B_ * T_ * 4 * D))

    def cqa_case(a, what):
        out = K.fused_cqa_concat(*a)
        check(bool(torch.isfinite(out).all()),
              "cqa_concat_fwd: non-finite output at %s" % what)
        twice = torch.equal(out, K.fused_cqa_concat(*a))
        check(twice, "cqa_concat_fwd: two equal calls differ at %s" % what)
        parts = by_kernel(lambda: K.fused_cqa_concat(*a))
        B_, T_, _ = a[0].shape
        W_ = a[1].shape[1]
        return {"shape": [B_, T_, W_, D],
                "plan": K.cqa_plan(B_, T_, W_, D)._asdict(),
                "max_abs_err": max_err(out, K.cqa_plain(*a)[0]),
                "device_ms": sum(parts.values()), "by_kernel": parts,
                "bound_ms": bound(*cqa_work(B_, T_, W_))[0]}

    W = max_w
    q_lens = list(rng.integers(1, W + 1, B - 1)) + [0]
    args = cqa_inputs(B, T, W, lens, q_lens)
    served = cqa_case(args, "the served shape")
    BL, TL = LONG_PATHS["L"]["batch_size"], LONG_PATHS["L"]["max_pos_len"]
    l_vlens = [TL, 0, 70] + list(rng.integers(TL // 2, TL + 1, BL - 3))
    l_args = cqa_inputs(BL, TL, W, l_vlens,
                        [W, 3, 0] + list(rng.integers(1, W + 1, BL - 3)))
    path_l = cqa_case(l_args, "path L")
    long_q = cqa_case(cqa_inputs(
        BL, TL, 64, l_vlens, [64, 3, 0] + list(rng.integers(1, 65, BL - 3))),
        "W = 64 at path L")
    record("cqa_concat_fwd", "vslnet_torch/csrc/cqa.cu",
           "vslnet_tpu/ops/pallas_kernels.py:102",
           max(c["max_abs_err"] for c in (served, path_l, long_q)), TOL,
           cuda_ms(lambda: K.fused_cqa_concat(*args), 50),
           cuda_ms(lambda: K.cqa_plain(*args), 50), *cqa_work(B, T, W),
           shape=[B, T, W, D], plan=served["plan"],
           device_ms=served["device_ms"], by_kernel=served["by_kernel"],
           equal_bits_twice=True,
           path_L={**path_l, "ms": cuda_ms(lambda: K.fused_cqa_concat(*l_args),
                                           50),
                   "plain_ms": cuda_ms(lambda: K.cqa_plain(*l_args), 5)},
           long_query=long_q)

    # 5. highlight gate [B, T, D], ragged lengths
    args = [t(rng.standard_normal((B, T, D))),
            t(rng.standard_normal(D) / math.sqrt(D)),
            t(0.1 * rng.standard_normal(1)),
            t(np.arange(T)[None, :] < lens[:, None])]
    gated, scores = K.fused_highlight_gate(*args)
    scores_ref = K.highlight_plain(*args)[1]
    err = max(max_err(scores, scores_ref),
              max_err(gated, args[0] * scores_ref[:, :, None]))

    def highlight_plain_gate():
        scores = K.highlight_plain(*args)[1]
        return args[0] * scores[:, :, None], scores

    # also at path L's [8, 1024, D], where it runs once a served batch
    l_args = [t(rng.standard_normal((BL, TL, D))), *args[1:3],
              t(np.arange(TL)[None, :] < np.asarray(l_vlens)[:, None])]
    l_err = max(max_err(a, b) for a, b in zip(
        K.fused_highlight_gate(*l_args),
        (l_args[0] * K.highlight_plain(*l_args)[1][:, :, None],
         K.highlight_plain(*l_args)[1])))
    record("highlight_gate_fwd", "vslnet_torch/csrc/highlight_gate.cu",
           "vslnet_tpu/ops/pallas_kernels.py:180", max(err, l_err), TOL,
           cuda_ms(lambda: K.fused_highlight_gate(*args), 100),
           cuda_ms(highlight_plain_gate, 100),
           {"fp32": B * T * (3 * D + 4)}, 4 * (2 * B * T * D + 2 * B * T + D + 1),
           shape=[B, T, D], device_ms=sum(by_kernel(
               lambda: K.fused_highlight_gate(*args)).values()), path_L={
               "shape": [BL, TL, D], "max_abs_err": l_err,
               "ms": cuda_ms(lambda: K.fused_highlight_gate(*l_args), 100),
               "device_ms": sum(by_kernel(
                   lambda: K.fused_highlight_gate(*l_args)).values()),
               "bound_ms": bound({"fp32": BL * TL * (3 * D + 4)}, 4 * (
                   2 * BL * TL * D + 2 * BL * TL + D + 1))[0]})

    # 6. span decode [B, T] of masked logits; exact indices
    mask = t(np.arange(T)[None, :] < lens[:, None])
    sl = t(rng.standard_normal((B, T)) * 3) * mask + (1 - mask) * -1e30
    el = t(rng.standard_normal((B, T)) * 3) * mask + (1 - mask) * -1e30
    s, e = K.fused_span_decode(sl, el)
    s_ref, e_ref = K.span_decode_plain(sl, el)
    index_err = max(max_err(s, s_ref), max_err(e, e_ref))
    # also at path L's [8, 1024], and there with planted ties across the
    # kernel's chunks (4 frames a thread), threads and warps (128 frames)
    l_mask = l_args[3]
    sl_l = t(rng.standard_normal((BL, TL)) * 3) * l_mask + (1 - l_mask) * -1e30
    el_l = t(rng.standard_normal((BL, TL)) * 3) * l_mask + (1 - l_mask) * -1e30
    l_err = max(max_err(a, b) for a, b in zip(
        K.fused_span_decode(sl_l, el_l), K.span_decode_plain(sl_l, el_l)))
    sl_t, el_t = (t(a) for a in span_tie_logits(rng, TL, SPAN_TIES_1024))
    tied = K.fused_span_decode(sl_t, el_t)
    tied_err = max(max_err(a, b) for a, b in zip(
        tied, K.span_decode_plain(sl_t, el_t)))
    decoded = list(zip(*(x.tolist() for x in tied)))
    planted = span_ties_expected(SPAN_TIES_1024)
    check(all(w is None or d == w for d, w in zip(decoded, planted)),
          "span_decode: the tied rows decode to %s, not %s"
          % (decoded, planted))
    record("span_decode", "vslnet_torch/csrc/span_decode.cu",
           "vslnet_tpu/ops/pallas_kernels.py:57",
           max(index_err, l_err, tied_err), 0.0,
           cuda_ms(lambda: K.fused_span_decode(sl, el), 100),
           cuda_ms(lambda: K.span_decode_plain(sl, el), 100),
           {"fp32": 10 * B * T}, 4 * (2 * B * T + 2 * B), shape=[B, T],
           device_ms=sum(by_kernel(
               lambda: K.fused_span_decode(sl, el)).values()),
           path_L={
               "shape": [BL, TL], "max_abs_err": l_err,
               "tied_max_abs_err": tied_err,
               "ms": cuda_ms(lambda: K.fused_span_decode(sl_l, el_l), 100),
               "device_ms": sum(by_kernel(
                   lambda: K.fused_span_decode(sl_l, el_l)).values()),
               "bound_ms": bound({"fp32": 10 * BL * TL}, 4 * (2 * BL * TL + 2 * BL))[0]})

    # --- the training kernels: forward and every gradient of sum(out * g)
    # against the plain version's autograd, then each kernel timed alone
    # 7, 8. LSTM forward with residuals and the reverse recurrence
    dy = t(rng.standard_normal((T, B, H)))
    abs_err, err, finite = autograd_pair(
        K.fused_lstm_recurrence, K.lstm_recurrence_plain,
        [x_proj, k_h, valid], 2, dy)
    check(finite, "LSTM training path: non-finite output or gradient")
    res = K.launch_lstm_fwd_res(x_proj, k_h, valid)
    leaves = [x_proj.clone().requires_grad_(), k_h.clone().requires_grad_()]
    out_p = K.lstm_recurrence_plain(*leaves, valid)
    xp_req = x_proj.clone().requires_grad_()
    ms_lib_f = cuda_ms(lambda: lstm(xp_req), 20)
    ms_lib_fb = cuda_ms(lambda: lstm(xp_req)[0].backward(dy), 20)
    steps = int(lens.sum())  # only valid steps need the products
    ms = cuda_ms(lambda: K.launch_lstm_fwd_res(x_proj, k_h, valid), 20)
    record("lstm_recurrence_fwd_res", "vslnet_torch/csrc/lstm.cu",
           "vslnet_tpu/ops/pallas_kernels.py:276", abs_err, TOL, ms,
           cuda_ms(lambda: K.lstm_recurrence_plain(*leaves, valid), 3),
           {"fp32": 2 * steps * H * 4 * H},
           4 * (2 * T * B * 4 * H + H * 4 * H + T * B + 4 * T * B * H),
           library_ms=ms_lib_f, checked_err=err, shape=[T, B, 4 * H],
           us_per_step=ms * 1e3 / T, plan=plan_fields(plan))
    check(ms < ms_lib_f, "lstm_recurrence_fwd_res: %g ms, not below cuDNN's "
          "training forward %g" % (ms, ms_lib_f))
    ms = cuda_ms(lambda: K.launch_lstm_bwd(dy, *res[1:], valid, k_h), 20)
    record("lstm_recurrence_bwd", "vslnet_torch/csrc/lstm.cu",
           "vslnet_tpu/ops/pallas_kernels.py:316", abs_err, TOL, ms,
           cuda_ms(lambda: torch.autograd.grad(out_p, leaves, dy,
                                               retain_graph=True), 3),
           # dgates . k_h^T along the chain and dk_h = h_prev^T . dgates
           {"fp32": 2 * 2 * steps * H * 4 * H},
           4 * (2 * T * B * 4 * H + 4 * T * B * H + T * B + 2 * H * 4 * H),
           library_ms=ms_lib_fb - ms_lib_f, checked_err=err,
           library_fwd_bwd_ms=ms_lib_fb, shape=[T, B, 4 * H],
           us_per_step=ms * 1e3 / T, plan=plan_fields(plan))
    check(ms < ms_lib_fb - ms_lib_f, "lstm_recurrence_bwd: %g ms, not below "
          "cuDNN's backward %g" % (ms, ms_lib_fb - ms_lib_f))

    # 9. conv block backward (the whole-row kernels' autograd Function), at
    # T and at max_w, drop_rate 0.2
    # on plain draws, g 0 on the frames next to a pre-ReLU at the kink
    def conv_pair(a, sd):
        near = kink_frames(a, sd, DROP)
        g = t(rng.standard_normal(tuple(a[0].shape))) * ~near[..., None]
        kw = {"seeds": sd, "drop_rate": DROP}
        return autograd_pair(lambda *x: K.FusedConvBlock.apply(*x, sd, DROP),
                             lambda *x: K.conv_block_plain(*x, **kw),
                             a, 6, g), g, int(near.sum())

    (q_abs, q_err, q_fin), _, q_kinks = conv_pair(conv_q_args, seeds_for(B))
    seeds = seeds_for(B)
    (abs_err, err, finite), g, kinks = conv_pair(conv_args, seeds)
    check(finite and q_fin, "conv block: non-finite gradient")
    # the T-tiled pair, which conv_route may take for training at this shape
    # (the main path's video conv block), on the same inputs and g, and its
    # backward's masks here
    t_abs, t_err, t_fin = autograd_pair(
        lambda *x: K.FusedConvBlockTiled.apply(*x, seeds, DROP),
        lambda *x: K.conv_block_plain(*x, seeds=seeds, drop_rate=DROP),
        conv_args, 6, g)
    check(t_fin, "conv block, tiled pair: non-finite output or gradient")
    t_zeros = tiled_bwd_zeros(conv_args, seeds)
    check(all(t_zeros), "conv_block_bwd: the tiled backward's dropout zero "
          "pattern differs")
    leaves = [a.clone().requires_grad_() for a in conv_args]
    out_p = K.conv_block_plain(*leaves, seeds=seeds, drop_rate=DROP)
    ms = cuda_ms(lambda: K.launch_conv_block_bwd(*conv_args, seeds, DROP, g),
                 20)
    # the T-tiled backward at the same shape, from its forward's xs
    _, xs = K.launch_conv_block_fwd_tiled(*conv_args, seeds, DROP)

    def tiled_bwd():
        return K.launch_conv_block_bwd_tiled(conv_args[0], xs, *conv_args[1:],
                                             seeds, DROP, g)
    tiled_ms = cuda_ms(tiled_bwd, 20)
    parts = by_kernel(lambda: K.launch_conv_block_bwd(*conv_args, seeds, DROP,
                                                      g))
    tiled_parts = by_kernel(tiled_bwd)

    # a training call's route takes the whole-row kernels or the tiled ones
    # as a pair, so their device time, forward and backward, decides it
    def block_pair():
        K.launch_conv_block_fwd(*conv_args, seeds, DROP)
        return K.launch_conv_block_bwd(*conv_args, seeds, DROP, g)

    def tiled_pair():
        _, xs_ = K.launch_conv_block_fwd_tiled(*conv_args, seeds, DROP)
        return K.launch_conv_block_bwd_tiled(conv_args[0], xs_, *conv_args[1:],
                                             seeds, DROP, g)
    pair_ms = sum(by_kernel(block_pair).values())
    tiled_pair_ms = sum(by_kernel(tiled_pair).values())
    route = K.conv_route(T, D, KS, L, grad=True)
    gq = g[:, :max_w].contiguous()
    record("conv_block_bwd", "vslnet_torch/csrc/conv_block.cu",
           "vslnet_tpu/ops/pallas_kernels.py:1039", max(abs_err, q_abs, t_abs),
           TOL, ms,
           cuda_ms(lambda: torch.autograd.grad(out_p, leaves, g,
                                               retain_graph=True), 20),
           # the forward replayed, then the data and weight products
           {"fp32": L * 6 * B * T * D * (D + KS)},
           4 * (4 * B * T * D + 2 * L * (3 * D + KS * D + D * D) + B),
           checked_err=max(err, q_err, t_err), shape=[B, T, D], drop_rate=DROP,
           query_T=max_w, query_checked_err=q_err, tiled_max_abs_err=t_abs,
           tiled_checked_err=t_err, tiled_dropout_zero_pattern_equal=all(t_zeros),
           kink_frames_left_out=[kinks, B * T],
           query_kink_frames_left_out=[q_kinks, B * max_w],
           plan=K.conv_plan(B, T, D, KS, L)._asdict(),
           query_plan=K.conv_plan(B, max_w, D, KS, L)._asdict(),
           tiled_ms=tiled_ms, device_ms=sum(parts.values()), by_kernel=parts,
           tiled_device_ms=sum(tiled_parts.values()),
           tiled_by_kernel=tiled_parts,
           tiled_plan=K.conv_tiled_bwd_plan(B, T, D, KS, L)._asdict(),
           route_train=route, pair_device_ms=pair_ms,
           tiled_pair_device_ms=tiled_pair_ms,
           query_route_train=K.conv_route(max_w, D, KS, L, grad=True),
           query_ms=cuda_ms(lambda: K.launch_conv_block_bwd(
               *conv_q_args, seeds, DROP, gq), 20))
    check(route == ("tiled" if tiled_pair_ms < pair_ms else "block"),
          "conv_route: training at [%d, %d, %d] takes the %s pair, but the "
          "whole-row forward and backward take %g ms of device time and the "
          "tiled pair %g" % (B, T, D, route, pair_ms, tiled_pair_ms))

    # 10. MHA block backward, at T and at max_w (one fully masked row)
    def mha_pair(a, sd):
        g = t(rng.standard_normal(tuple(a[0].shape)))
        kw = {"seeds": sd, "drop_rate": DROP}
        mask_ = a[1]
        return autograd_pair(
            lambda x, *w: K.fused_mha_block(x, mask_, *w, heads, **kw),
            lambda x, *w: K.mha_block_plain(x, mask_, *w, heads, **kw),
            [a[0], *a[2:]], 7, g), g

    (q_abs, q_err, q_fin), _ = mha_pair(mha_q_args, seeds_for(B))
    seeds = seeds_for(B)
    (abs_err, err, finite), g = mha_pair(mha_args, seeds)
    check(finite and q_fin, "MHA block: non-finite gradient")
    x, mask, gam, beta, wqkv, bqkv, wd, bd = mha_args
    _, qkv, att = K.launch_mha_block_fwd(*mha_args, heads, seeds, DROP)
    leaves = [a.clone().requires_grad_() for a in (x, *mha_args[2:])]
    out_p = K.mha_block_plain(leaves[0], mask, *leaves[1:], heads, seeds=seeds,
                              drop_rate=DROP)

    def mha_bwd():
        return K.launch_mha_block_bwd(x, mask, gam, beta, wqkv, wd, heads,
                                      seeds, DROP, qkv, att, g)

    def unfused(grad):
        """The block's PyTorch ops around the whole-T attention kernels
        (mha_block_unfused) at the same inputs, forward (and backward)."""
        with torch.set_grad_enabled(grad):
            out = K.mha_block_unfused(leaves[0], mask, *leaves[1:], heads,
                                      seeds, DROP)
            if grad:
                torch.autograd.grad(out, leaves, g)

    # the kernels against the unfused block's backward at the same shape, in
    # this run, by CUDA events around back-to-back calls and by the device
    # time of a call's kernels (torch.profiler); the unfused backward's is
    # its forward + backward's less its forward's: the kernels must be the
    # faster by device time
    twice = all(torch.equal(a, b) for a, b in zip(mha_bwd(), mha_bwd()))
    check(twice, "mha_block_bwd: two equal calls differ")
    parts = by_kernel(mha_bwd)
    device_ms = sum(parts.values())
    unfused_device_ms = (sum(by_kernel(lambda: unfused(True)).values())
                         - sum(by_kernel(lambda: unfused(False)).values()))
    ms = cuda_ms(mha_bwd, 20)
    unfused_ms = (cuda_ms(lambda: unfused(True), 20)
                  - cuda_ms(lambda: unfused(False), 20))
    xq, maskq, gamq, betaq, wqkvq, _, wdq, _ = mha_q_args
    _, qkvq, attq = K.launch_mha_block_fwd(*mha_q_args, heads, seeds, DROP)
    gq = g[:, :max_w].contiguous()

    def mha_bwd_q():
        return K.launch_mha_block_bwd(xq, maskq, gamq, betaq, wqkvq, wdq, heads,
                                      seeds, DROP, qkvq, attq, gq)
    record("mha_block_bwd", "vslnet_torch/csrc/mha_block.cu",
           "vslnet_tpu/ops/pallas_kernels.py:1762", max(abs_err, q_abs), TOL,
           ms, cuda_ms(lambda: torch.autograd.grad(out_p, leaves, g,
                                                   retain_graph=True), 20),
           # dense and QKV data + weight products; the scores recomputed,
           # dP, dV, dQ and dK over the valid keys
           {"fp32": 4 * B * T * D * D + 4 * B * T * D * 3 * D
                    + 10 * T * keys * D},
           4 * (3 * B * T * D + B * T + B * T * 3 * D + B * T * D
                + 2 * (4 * D + 4 * D * D + 4 * D) + B),
           checked_err=max(err, q_err), shape=[B, T, D], heads=heads,
           drop_rate=DROP, query_T=max_w, query_checked_err=q_err,
           equal_bits_twice=twice,
           plan=K.mha_bwd_plan(B, T, D, heads)._asdict(),
           query_plan=K.mha_bwd_plan(B, max_w, D, heads)._asdict(),
           device_ms=device_ms, by_kernel=parts, unfused_ms=unfused_ms,
           unfused_device_ms=unfused_device_ms,
           query_ms=cuda_ms(mha_bwd_q, 20),
           query_device_ms=sum(by_kernel(mha_bwd_q).values()))
    check(device_ms < unfused_device_ms, "mha_block_bwd: %g ms of device "
          "time, not below the unfused block's backward %g"
          % (device_ms, unfused_device_ms))
    return rows


# --- phase 4 -------------------------------------------------------------------


def post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode("utf-8"), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, "HTTP %d from %s" % (r.status, url))
        return json.loads(r.read())


def charades_like_dataset():
    """Synthetic records, features and GloVe rows at Charades-STA shapes:
    <= 128 clips of 1024-d I3D features, 300-d word vectors, queries of 3-12
    words; plus one 300-clip video that serving mean-pools to 128."""
    from vslnet_torch.data.synthetic import synthetic_dataset

    dataset, feats = synthetic_dataset(
        n_train=64, n_test=32, n_videos=24, n_words=1200, n_chars=40,
        max_pos_len=128, video_feature_dim=1024, word_dim=300, seed=SEED)
    feats["long_video"] = np.random.default_rng(SEED + 1).standard_normal(
        (300, 1024)).astype(np.float32)
    splits = [dataset["train_set"], dataset["val_set"], dataset["test_set"]]
    return dataset, feats, splits


def slice_phase(dataset, feats, splits):
    import torch

    from vslnet_torch.bench.paths import build_localizer, profile_device
    from vslnet_torch.config import Config
    from vslnet_torch.ops import kernels as K
    from vslnet_torch.server import durations_from_dataset, make_server

    def localizer(use_pallas):
        cfg = Config(task="charades", predictor="rnn", hidden_size=128,
                     num_heads=8, max_pos_len=128, video_feature_dim=1024,
                     word_dim=300, char_dim=50, batch_size=16,
                     char_size=dataset["n_chars"], use_pallas=use_pallas,
                     seed=SEED)
        return build_localizer(cfg, dataset, splits, SEED), cfg

    loc, cfg = localizer("auto")
    loc_off, _ = localizer("off")
    check(loc.device.type == "cuda" and loc.use_kernels and all(
        m.use_kernels for m in loc.model.modules()
        if hasattr(m, "use_kernels")),
        "use_pallas=auto on the card must turn every kernel on")
    check(not loc_off.use_kernels and not any(
        m.use_kernels for m in loc_off.model.modules()
        if hasattr(m, "use_kernels")), "use_pallas=off must turn them off")

    durations = durations_from_dataset(dataset)
    durations["long_video"] = 300.0
    recs = dataset["test_set"]
    single = {"vid": recs[0]["vid"], "query": " ".join(recs[0]["words"])}
    many = [{"vid": r["vid"], "query": " ".join(r["words"])}
            for r in recs[:cfg.batch_size + 4]]
    many[1]["vid"] = "long_video"
    topk = [{"vid": r["vid"], "query": " ".join(r["words"]), "top_k": 3}
            for r in recs[20:23]]

    server = make_server(loc, feats, durations, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d/localize" % server.server_address[1]
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        replies = [post(base, single)] + post(base, many) + post(base, topk)
        served_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")

    reqs = [single] + many + topk
    for req, rep in zip(reqs, replies):
        dur = durations[req["vid"]]
        spans = rep["spans"] if "top_k" in req else [rep]
        check(len(spans) == req.get("top_k", 1), rep)
        for sp in spans:
            check(0.0 <= sp["start"] <= sp["end"] <= dur + 1e-3,
                  "span out of range: %s" % rep)
        probs = [sp.get("prob", 1.0) for sp in spans]
        check(probs == sorted(probs, reverse=True), rep)
    # 4 forwards: 1 (single) + 2 (20 requests) + 1 (top_k); the top_k
    # decode is plain torch.topk, so 3 span decodes; each forward's two
    # conv blocks (the video's T and the query's max_w) take the kernels
    # conv_route gives a call without a gradient
    expected = {name: 0 for name in K.LAUNCHES}  # no training kernel
    expected.update({"lstm_recurrence_fwd": 8, "mha_block_fwd": 8,
                     "cqa_concat_fwd": 4, "highlight_gate_fwd": 4,
                     "span_decode": 3})
    for n, kind in conv_launches(cfg.max_pos_len, loc.max_w, False).items():
        expected[n] = 4 * kind
    check(launches == expected,
          "launch counts %s, expected %s" % (launches, expected))

    # the served path against the same weights with every kernel off
    triples = [(feats[r["vid"]], durations[r["vid"]], r["query"])
               for r in many[:cfg.batch_size]]
    batch, _ = loc.make_batch(triples)
    with torch.inference_mode():
        out_k = loc.model(*batch)
        out_p = loc_off.model(*batch)
    logit_err = max(max_err(out_k[k], out_p[k])
                    for k in ("start_logits", "end_logits", "highlight_scores"))
    finite = all(bool(torch.isfinite(out_k[k]).all())
                 for k in ("highlight_scores", "end_logits"))

    def spans(lo):
        """Top-1 spans and the top-3 spans without their probabilities."""
        return (lo.localize_batch(triples),
                [[sp[:2] for sp in row]
                 for row in lo.localize_batch(triples, top_k=3)])

    same_spans = spans(loc) == spans(loc_off)

    def batch_ms(lo):
        def run():
            lo.localize_batch(triples)
            torch.cuda.synchronize()
        run()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        return (time.perf_counter() - t0) / 5 * 1e3

    ms_kernels = batch_ms(loc)
    emit({"phase": "slice", "requests": len(reqs), "http_200": len(replies),
          "served_seconds": served_s, "launches": launches,
          "max_logit_err_vs_off": logit_err, "logit_atol": LOGIT_ATOL,
          "spans_equal_vs_off": same_spans, "finite": finite,
          "batch16_ms_kernels": ms_kernels, "batch16_ms_off": batch_ms(loc_off),
          "max_w": loc.max_w, "max_c": loc.max_c})
    emit({"phase": "profile", "of": "served batch of 16",
          **profile_device(lambda: loc.localize_batch(triples), ms_kernels)})
    check(finite and logit_err <= LOGIT_ATOL and same_spans,
          "served path disagrees with use_pallas=off")
    return launches


# --- phase 5 -------------------------------------------------------------------

TRAIN_KERNELS = ("lstm_recurrence_fwd_res", "lstm_recurrence_bwd",
                 "conv_block_fwd", "conv_block_bwd", "mha_block_fwd",
                 "mha_block_bwd", "conv_block_fwd_tiled",
                 "conv_block_bwd_tiled")


def conv_launches(T, max_w, grad):
    """{kernel: launches} of one forward's (and with grad its backward's)
    two conv blocks, the video's T and the query's max_w, as conv_route
    sends them (the model's 7 taps and 4 layers)."""
    from vslnet_torch.ops import kernels as K

    out = {}
    for t in (T, max_w):
        tiled = K.conv_route(t, 128, 7, 4, grad) == "tiled"
        names = ["conv_block_fwd" + ("_tiled" if tiled else "")]
        if grad:
            names.append("conv_block_bwd" + ("_tiled" if tiled else ""))
        for n in names:
            out[n] = out.get(n, 0) + 1
    return out


def timed_steps(trainer, n):
    """n train steps, each ended by a synchronise: (losses, ms per step)."""
    import torch

    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss, _ = trainer.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, times


def trainers(configs, dataset, feats):
    """Two Trainers of configs on the card from the same weights: with the
    kernels (use_pallas=auto) and with every kernel off."""
    import torch

    from vslnet_torch.train.runner import Trainer

    tk = Trainer(configs("auto"), dataset, feats)
    to = Trainer(configs("off"), dataset, feats)
    check(tk.device.type == "cuda" and tk.use_kernels and not to.use_kernels,
          "the trainers must run on the card, with and without the kernels")
    named_o = dict(to.model.named_parameters())
    check(all(torch.equal(p, named_o[n])
              for n, p in tk.model.named_parameters()),
          "the two trainers must start from the same weights")
    return tk, to


def step_vs_off(tk, to, of):
    """One step each of the two trainers (same weights, batch and generator
    seed): the losses within LOSS_RTOL, every parameter's gradient within
    GRAD_RTOL of its largest entry plus GRAD_ATOL."""
    loss_k, _ = tk.step()
    loss_o, _ = to.step()
    loss_rel = abs(float(loss_k) - float(loss_o)) / abs(float(loss_o))
    named_o = dict(to.model.named_parameters())
    # per parameter: (max abs error, max abs gradient, error over its bound)
    grad_errs = {}
    for n, p in tk.model.named_parameters():
        ref = named_o[n].grad
        err, scale = max_err(p.grad, ref), float(ref.abs().max())
        grad_errs[n] = (err, scale, err / (GRAD_RTOL * scale + GRAD_ATOL))
    worst = sorted(grad_errs, key=lambda n: -grad_errs[n][2])[:3]
    emit({"phase": "train_step_vs_off", "of": of,
          "loss_kernels": float(loss_k), "loss_off": float(loss_o),
          "loss_rel_err": loss_rel, "loss_rtol": LOSS_RTOL,
          "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL,
          "params": len(grad_errs),
          "worst_params": {n: grad_errs[n] for n in worst}})
    check(loss_rel <= LOSS_RTOL and grad_errs[worst[0]][2] <= 1.0,
          "%s: a train step with the kernels disagrees with use_pallas=off"
          % of)


def train_phase(dataset, feats):
    from vslnet_torch.bench.paths import profile_device, train_config
    from vslnet_torch.ops import kernels as K

    tk, to = trainers(lambda up: train_config(dataset, up, SEED), dataset,
                      feats)
    # 1. one step each: same weights, batch and generator seed
    step_vs_off(tk, to, "rnn T=128")
    _, off_times = timed_steps(to, 3)

    # 2. the main path: TRAIN_STEPS steps with the kernels, launches counted;
    # a step's two conv blocks take the pair conv_route gives a call with a
    # gradient
    K.reset_launches()
    losses, times = timed_steps(tk, TRAIN_STEPS)
    launches = dict(K.LAUNCHES)
    per_step = {"lstm_recurrence_fwd_res": 2, "lstm_recurrence_bwd": 2,
                "mha_block_fwd": 2, "mha_block_bwd": 2,
                **conv_launches(tk.configs.max_pos_len,
                                tk.train_loader.split.word_ids.shape[1], True)}
    expected = {name: TRAIN_STEPS * per_step.get(name, 0)
                for name in K.LAUNCHES}
    step_ms = float(np.mean(times[2:]))
    emit({"phase": "train", "steps": TRAIN_STEPS, "losses": losses,
          "launches": launches, "step_ms_kernels": step_ms,
          "step_ms_off": float(np.mean(off_times)), "step_ms_each": times,
          "train_records": len(dataset["train_set"]),
          "num_train_steps": tk.configs.num_train_steps})
    check(launches == expected,
          "train launch counts %s, expected %s" % (launches, expected))
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    check(float(np.mean(losses[-5:])) < losses[0],
          "the loss did not fall: %s" % losses)
    profile = profile_device(tk.step, step_ms)
    emit({"phase": "profile", "of": "train step", **profile})

    # 3. evaluation of the test split (reported, not judged)
    r1_3, r1_5, r1_7, miou, _, _ = tk.evaluate()
    emit({"phase": "evaluate", "records": len(dataset["test_set"]),
          "R1@0.3": r1_3, "R1@0.5": r1_5, "R1@0.7": r1_7, "mIoU": miou})
    return launches, profile, tk


# --- the bf16 phase -----------------------------------------------------------

# a bf16 kernel against its bf16 twin on the card: the same roundings,
# fp32 sums in another order, so a value on a bf16 rounding boundary can
# round the other way in one of them. The LSTM's fp32 output within
# BF16_LSTM_TOL (a flip of bf16(h) moves a gate by up to 2^-9 and carries
# down the chain); the blocks' bf16 outputs within two bf16 ulps of their
# largest value (BF16_TOL, relative, as scaled_err). Those bounds hold a
# kernel that left out its bf16 rounding points too, so each row is also
# held to a check that tells the bf16 function from the fp32 one: the
# LSTM's mean absolute error over its valid outputs within
# BF16_LSTM_MEAN_TOL, the share of the blocks' bf16 outputs that differ
# from the twin's within BF16_SHARE_TOL. Flips are rare, so these stay
# small; the fp32 function (its output rounded to bf16 only where the
# kernel's output is bf16) is the control, and must fail them. The
# readings on both sides are in PERF.md.
BF16_LSTM_TOL = 5e-3
BF16_TOL = 2.0 ** -7
BF16_LSTM_MEAN_TOL = 2e-5
BF16_SHARE_TOL = 0.05
# the bf16 served model's start and end logits and highlight scores
# (masked logits excluded) against: the composition of the bf16 twins on
# the card (the same function: flips only, carried through the model);
# use_pallas=off at bf16 (the JAX package's XLA path at bf16, another
# function: bf16 residuals and LSTM state); the fp32 model. The fp32
# model's logits must fail the twins' limit, as the control of the check
# that the served model computes the kernels' bf16 function.
BF16_MODEL_TOL = {"twins": 0.05, "off": 0.5, "fp32": 0.5}
BF16_NAMES = ("lstm_recurrence_fwd", "conv_block_fwd", "conv_block_fwd_tiled",
              "mha_block_fwd")


def share_differing(out, ref):
    """The share of a bf16 output's elements that differ from ref rounded
    to bf16."""
    return float((out != ref.to(out.dtype)).float().mean())


def bf16_function_check(name, key, value, control, tol):
    """Holds a bf16 kernel's reading `value` against its twin to tol, and
    the control's (the fp32 function's, against the same twin) beyond it;
    returns both for the kernel's row."""
    check(value <= tol, "%s: %s %g > %g against its bf16 twin"
          % (name, key, value, tol))
    check(control > tol, "%s: the fp32 function's %s %g is within %g, so "
          "the check does not tell it from the bf16 function"
          % (name, key, control, tol))
    return {key: value, key + "_control": control, key + "_tol": tol}


def lstm_tc_checks(row):
    """A bf16 LSTM forward's row: its kernel the tensor-core forward alone
    (no cluster-FMA kernel left on the bf16 path), below cuDNN's bf16
    nn.LSTM by events."""
    names = list(row["by_kernel"])
    check(any("lstm_fwd_tc_kernel" in n for n in names)
          and not any("lstm_fwd_cluster_kernel" in n for n in names),
          "%s: its kernels are %s, not the tensor-core forward" % (row["name"], names))
    check(row["ms"] < row["library_ms"], "%s: %g ms, not below cuDNN's bf16 %g"
          % (row["name"], row["ms"], row["library_ms"]))


def bf16_kernel_rows(dev, max_w):
    """The four bf16 kernels at the served shapes against their bf16 twins
    on the card: error, equal bits on two equal calls, time by CUDA events
    and by torch.profiler, the twin's time and the bound."""
    import torch

    from vslnet_torch.bench import bf16_vjp as V
    from vslnet_torch.bench.common import (by_kernel, conv_fwd_bf16_bound,
                                           conv_fwd_bf16_work,
                                           mha_fwd_bf16_bound,
                                           mha_fwd_bf16_work)
    from vslnet_torch.ops import kernels as K

    bf = torch.bfloat16
    rng = np.random.default_rng(SEED + 12)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    B, T, D, H, L, KS, heads = 16, 128, 128, 128, 4, 7, 8
    rows = []

    def record(name, source, line, err, tol, fn, plain, work, nbytes,
               **extra):
        out = fn()
        twice = torch.equal(out, fn())
        check(twice, "%s: two equal calls differ" % name)
        parts = by_kernel(fn)
        rows.append(kernel_row(
            name, source, "vslnet_tpu/ops/pallas_kernels.py:%d" % line, err,
            tol, cuda_ms(fn, 50), cuda_ms(plain, 3 if "lstm" in name else 50),
            work, nbytes, equal_bits_twice=twice,
            device_ms=sum(parts.values()), by_kernel=parts, **extra))

    # 1. the LSTM recurrence, x_proj [T, B, 4H] and k_h in bf16
    lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])
    x_proj = t(rng.standard_normal((T, B, 4 * H))).to(bf)
    k_h = t(rng.standard_normal((H, 4 * H)) / math.sqrt(H)).to(bf)
    valid = t(np.arange(T)[:, None] < lens[None, :])
    lstm_args = (x_proj, k_h, valid)
    out = K.fused_lstm_recurrence(*lstm_args)
    torch.cuda.synchronize()
    ref = K.lstm_recurrence_plain(*lstm_args)
    ref32 = K.lstm_recurrence_plain(x_proj.float(), k_h.float(), valid)
    err = max_err(out, ref)
    fp32_err = max_err(out, ref32)

    def mean_err(a):
        return float((a - ref).abs()[valid.bool()].mean())

    mean_check = bf16_function_check(
        "lstm_recurrence_fwd_bf16", "mean_abs_err", mean_err(out),
        mean_err(ref32), BF16_LSTM_MEAN_TOL)
    lstm = lstm_yardstick(x_proj.float(), k_h.float()).to(bf)
    lstm.flatten_parameters()  # one contiguous bf16 weight buffer for cuDNN
    with torch.no_grad():
        lib_err = float((lstm(x_proj)[0].float() - out).abs()[valid.bool()]
                        .max())
        ms_lib = cuda_ms(lambda: lstm(x_proj), 20)
    fp64 = V.lstm_fwd_fp64(lstm_args, [out])
    check(*V.lstm_fwd_fp64_verdict(fp64))
    record("lstm_recurrence_fwd_bf16", "vslnet_torch/csrc/lstm.cu", 241, err,
           BF16_LSTM_TOL, lambda: K.fused_lstm_recurrence(*lstm_args),
           lambda: K.lstm_recurrence_plain(*lstm_args),
           {"bf16": 2 * int(lens.sum()) * H * 4 * H},
           2 * (T * B * 4 * H + H * 4 * H) + 4 * (T * B + T * B * H),
           library_ms=ms_lib, library="cuDNN nn.LSTM in bf16",
           library_max_abs_err_valid=lib_err, shape=[T, B, 4 * H],
           err_vs_fp32_function=fp32_err,
           plan=K.lstm_fwd_bf16_plan(B, H)._asdict(), fp64=fp64, **mean_check)
    lstm_tc_checks(rows[-1])

    # 2. the conv block: the whole-row kernel at the query stream's [B,
    # max_w, D], the T-tiled one at the video's [B, T, D]
    def conv_inputs(T_):
        return [t(rng.standard_normal((B, T_, D))).to(bf),
                t(1 + 0.1 * rng.standard_normal((L, D))),
                t(0.1 * rng.standard_normal((L, D))),
                t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                t(rng.standard_normal((L, D, D)) / math.sqrt(D)),
                t(0.1 * rng.standard_normal((L, D)))]

    def conv_work(T_):  # the whole-row form's (#2b)
        return ({"bf16": L * 2 * B * T_ * D * (D + KS)},
                2 * 2 * B * T_ * D + 4 * L * (3 * D + KS * D + D * D))

    def fwd_fp64(kind, args, out):
        # the forward against the twin and an fp64 evaluation of the same
        # function (bench/bf16_vjp.py block_fwd_read), held to their limits
        r = V.block_fwd_read(kind, args, None, 0.0, out)
        check(*V.block_fwd_verdict(r))
        return r

    # the tiled forward (#2c, on the tensor cores) also at path
    # M's [16, 192, 128] and path L's [8, 1024, 128], beside the fp32 tiled
    # forward on the same inputs
    paths = {}
    for path, (B_, T_) in (("path_M", (16, 192)), ("path_L", (8, 1024))):
        args_p = [t(rng.standard_normal((B_, T_, D))).to(bf)] + conv_inputs(1)[1:]
        out_p = K.launch_conv_block_fwd_tiled(*args_p)[0]
        ref_p = K.conv_block_plain(*args_p)
        paths[path] = {
            "shape": [B_, T_, D], "device_ms": sum(by_kernel(
                lambda a=args_p: K.launch_conv_block_fwd_tiled(*a)).values()),
            "fp32_device_ms": sum(by_kernel(
                lambda a=args_p: K.launch_conv_block_fwd_tiled(
                    a[0].float(), *a[1:])).values()),
            "bound_ms": conv_fwd_bf16_bound(B_, T_, D, KS, L)[0],
            "fp64": fwd_fp64("conv", args_p, out_p),
            **bf16_function_check(
                "conv_block_fwd_tiled_bf16 at %s" % path, "share_differing",
                share_differing(out_p, ref_p),
                share_differing(K.conv_block_plain(args_p[0].float(),
                                                   *args_p[1:]).to(bf), ref_p),
                BF16_SHARE_TOL)}
    for name, T_ in (("conv_block_fwd_bf16", max_w),
                     ("conv_block_fwd_tiled_bf16", T)):
        args = conv_inputs(T_)
        tiled_row = "tiled" in name
        if tiled_row:
            got = K.launch_conv_block_fwd_tiled(*args)[0]
            fn = lambda a=args: K.launch_conv_block_fwd_tiled(*a)[0]  # noqa: E731
        else:
            got = K.launch_conv_block_fwd(*args)
            fn = lambda a=args: K.launch_conv_block_fwd(*a)  # noqa: E731
        ref = K.conv_block_plain(*args)
        ref32 = K.conv_block_plain(args[0].float(), *args[1:])
        share_check = bf16_function_check(
            name, "share_differing", share_differing(got, ref),
            share_differing(ref32.to(bf), ref), BF16_SHARE_TOL)
        if tiled_row:  # its product's part alone in cuBLAS bf16
            a_ = torch.randn(B * T_, D, device=dev, dtype=bf)
            w_ = torch.randn(D, D, device=dev, dtype=bf)
            extra = dict(paths, redesigned="tensor cores (mma.sync)", fp64=fwd_fp64("conv", args, got),
                         plan=K.conv_tiled_fwd_bf16_plan(B, T_, D, KS, L)._asdict(),
                         library_parts={"cublas_bf16_product_device_ms": sum(
                             by_kernel(lambda: a_ @ w_).values()), "per": "layer"})
            work = conv_fwd_bf16_work(B, T_, D, KS, L)
        else:
            extra, work = {}, conv_work(T_)
        record(name, "vslnet_torch/csrc/conv_block.cu", 1019,
               max_err(got, ref), BF16_TOL,
               fn, lambda a=args: K.conv_block_plain(*a), *work,
               checked_err=scaled_err(got, ref),
               shape=[B, T_, D], route_serve=K.conv_route(T_, D, KS, L),
               err_vs_fp32_function=scaled_err(got, ref32), **share_check,
               **extra)

    # 3. the MHA block at the video's [B, T, D] and the query's [B, max_w, D]
    def mha_inputs(T_):
        lens_ = np.concatenate([[T_, 0], rng.integers(1, T_ + 1, B - 2)])
        return lens_, [t(rng.standard_normal((B, T_, D))).to(bf),
                       t(np.arange(T_)[None, :] < lens_[:, None]),
                       t(1 + 0.1 * rng.standard_normal((2, D))),
                       t(0.1 * rng.standard_normal((2, D))),
                       t(rng.standard_normal((D, 3 * D)) / math.sqrt(D)),
                       t(0.1 * rng.standard_normal(3 * D)),
                       t(rng.standard_normal((D, D)) / math.sqrt(D)),
                       t(0.1 * rng.standard_normal(D))]

    mlens, args = mha_inputs(T)
    _, q_args = mha_inputs(max_w)
    out = K.fused_mha_block(*args, heads)
    ref = K.mha_block_plain(*args, heads)
    q_out = K.fused_mha_block(*q_args, heads)
    q_ref = K.mha_block_plain(*q_args, heads)
    ref32 = K.mha_block_plain(args[0].float(), *args[1:], heads)
    q_ref32 = K.mha_block_plain(q_args[0].float(), *q_args[1:], heads)
    check(bool(torch.isfinite(out.float()).all()), "mha_block_fwd_bf16: "
          "not finite")
    share_check = bf16_function_check(
        "mha_block_fwd_bf16", "share_differing",
        max(share_differing(out, ref), share_differing(q_out, q_ref)),
        min(share_differing(ref32.to(bf), ref),
            share_differing(q_ref32.to(bf), q_ref)), BF16_SHARE_TOL)
    keys = int(np.maximum(mlens, T * (mlens == 0)).sum())  # all for masked
    q_lens = q_args[1].sum(dim=1)
    q_keys = int(torch.where(q_lens > 0, q_lens, torch.full_like(q_lens, max_w)).sum())

    def parts(T_, m):  # the block's parts alone: cuBLAS and SDPA in bf16
        a_ = torch.randn(B * T_, D, device=dev, dtype=bf)
        w3, w1 = (torch.randn(D, n, device=dev, dtype=bf) for n in (3 * D, D))
        qh, kh, vh = (torch.randn(B, heads, T_, D // heads, device=dev,
                                  dtype=bf) for _ in range(3))
        am = m.bool()[:, None, None, :]
        return {"cublas_qkv_device_ms": sum(by_kernel(lambda: a_ @ w3).values()),
                "cublas_dense_device_ms": sum(by_kernel(lambda: a_ @ w1).values()),
                "sdpa_device_ms": sum(by_kernel(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=am)).values())}

    record("mha_block_fwd_bf16", "vslnet_torch/csrc/mha_block.cu", 1736,
           max(max_err(out, ref), max_err(q_out, q_ref)), BF16_TOL,
           lambda: K.fused_mha_block(*args, heads),
           lambda: K.mha_block_plain(*args, heads),
           *mha_fwd_bf16_work(B, T, D, keys),
           checked_err=max(scaled_err(out, ref), scaled_err(q_out, q_ref)),
           shape=[B, T, D], heads=heads, query_T=max_w, redesigned="tensor cores (mma.sync)",
           plan=K.mha_fwd_bf16_plan(B, T, D, heads)._asdict(),
           query_plan=K.mha_fwd_bf16_plan(B, max_w, D, heads)._asdict(),
           fp64=fwd_fp64("mha", args + [heads], out),
           query_fp64=fwd_fp64("mha", q_args + [heads], q_out),
           err_vs_fp32_function=scaled_err(out, ref32), **share_check,
           query_ms=cuda_ms(lambda: K.fused_mha_block(*q_args, heads), 50),
           query_device_ms=sum(by_kernel(
               lambda: K.fused_mha_block(*q_args, heads)).values()),
           query_bound_ms=mha_fwd_bf16_bound(B, max_w, D, q_keys)[0],
           library_parts=parts(T, args[1]), query_library_parts=parts(max_w, q_args[1]))
    return rows


class TwinsOnTheCard:
    """The kernel wrappers the model calls replaced, for a reference
    forward on the card, by their plain versions (at bf16, the bf16 twins;
    the MHA block as the CPU runs it, kernels.mha_block_twin): the modules
    look the wrappers up in ops/kernels.py at each call. With train, the
    LSTM and the blocks go through the plain twins' autograd Functions,
    whose backwards are the bf16 backward twins (a train step's
    reference); attention at bf16 always does. The wrappers named in
    `keep` stay the kernels."""

    def __init__(self, train=False, keep=()):
        self.train = train
        self.keep = keep

    def __enter__(self):
        from vslnet_torch.ops import kernels as K

        def gate(x, w, b, m):
            scores = K.highlight_plain(x, w, b, m)[1]
            return x * scores[:, :, None], scores

        self.saved = {n: getattr(K, n) for n in (
            "fused_lstm_recurrence", "fused_conv_block", "fused_mha_block",
            "fused_cqa_concat", "fused_highlight_gate", "fused_mha")}
        K.fused_lstm_recurrence = K.lstm_recurrence_plain
        K.fused_conv_block = K.conv_block_plain
        K.fused_cqa_concat = lambda *a: K.cqa_plain(*a)[0]
        K.fused_highlight_gate = gate
        # attention at any T: the twin of the route's kernels (at bf16 with
        # their VJPs for a gradient), which mha_block_unfused looks up
        K.fused_mha = K.mha_twin
        train = self.train
        K.fused_mha_block = functools.partial(K.mha_block_twin, vjp=train)
        if train:
            K.fused_lstm_recurrence = K.PlainLSTMRecurrence.apply

            def conv(x, gam, beta, dw, wp, bp, seeds=None, drop_rate=0.0):
                return K.PlainConvBlock.apply(x, gam, beta, dw, wp, bp, seeds,
                                              float(drop_rate))

            K.fused_conv_block = conv
        for n in self.keep:
            setattr(K, n, self.saved[n])
        return self

    def __exit__(self, *exc):
        from vslnet_torch.ops import kernels as K

        for n, f in self.saved.items():
            setattr(K, n, f)


def bf16_phase(dataset, feats, splits, fp32_launches):
    """The full-width T=128 rnn model at precision=bf16 with the slice
    phase's seeded weights: HTTP requests (the slice phase's) through
    Localizer and make_server, their launches kernel by kernel equal to the
    fp32 run's with the four bf16 kernels under their bf16 entries; the
    served logits against the twins' composition, use_pallas=off at bf16
    and the fp32 model; spans against the fp32 model's; a served batch
    profiled beside the fp32 batch. Returns the HTTP run's launches."""
    import torch

    from vslnet_torch.bench.paths import build_localizer, profile_device
    from vslnet_torch.config import Config
    from vslnet_torch.ops import kernels as K
    from vslnet_torch.server import durations_from_dataset, make_server

    def localizer(precision, use_pallas):
        cfg = Config(task="charades", predictor="rnn", hidden_size=128,
                     num_heads=8, max_pos_len=128, video_feature_dim=1024,
                     word_dim=300, char_dim=50, batch_size=16,
                     char_size=dataset["n_chars"], use_pallas=use_pallas,
                     precision=precision, seed=SEED)
        return build_localizer(cfg, dataset, splits, SEED)

    loc = localizer("bf16", "auto")
    loc_off = localizer("bf16", "off")
    loc32 = localizer("fp32", "auto")
    check(loc.model.dtype == torch.bfloat16 and loc.use_kernels,
          "precision=bf16, use_pallas=auto: a bf16 model with the kernels")

    durations = durations_from_dataset(dataset)
    durations["long_video"] = 300.0
    recs = dataset["test_set"]
    single = {"vid": recs[0]["vid"], "query": " ".join(recs[0]["words"])}
    many = [{"vid": r["vid"], "query": " ".join(r["words"])}
            for r in recs[:16 + 4]]
    many[1]["vid"] = "long_video"
    topk = [{"vid": r["vid"], "query": " ".join(r["words"]), "top_k": 3}
            for r in recs[20:23]]
    server = make_server(loc, feats, durations, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d/localize" % server.server_address[1]
    try:
        K.reset_launches()
        replies = [post(base, single)] + post(base, many) + post(base, topk)
        launches = dict(K.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")
    for req, rep in zip([single] + many + topk, replies):
        spans = rep["spans"] if "top_k" in req else [rep]
        check(len(spans) == req.get("top_k", 1) and all(
            0.0 <= sp["start"] <= sp["end"] <= durations[req["vid"]] + 1e-3
            for sp in spans), "bf16 reply out of range: %s" % rep)
    # the fp32 run's launches, the four kernels with a bf16 form under their
    # bf16 entries: a plain fall-back or a kernel of the wrong precision
    # fails here
    expected = dict(fp32_launches)
    for n in BF16_NAMES:
        expected[n + "_bf16"], expected[n] = fp32_launches[n], 0
    check(launches == expected, "bf16 launches %s, expected %s"
          % (launches, expected))

    triples = [(feats[r["vid"]], durations[r["vid"]], r["query"])
               for r in many[:16]]
    batch, _ = loc.make_batch(triples)
    keys = ("start_logits", "end_logits", "highlight_scores")
    with torch.inference_mode():
        out = loc.model(*batch)
        K.reset_launches()
        with TwinsOnTheCard():
            refs = {"twins": loc.model(*batch)}
        check(not any(K.LAUNCHES.values()), "the twins launched a kernel")
        refs["off"] = loc_off.model(*batch)
        refs["fp32"] = loc32.model(*batch)
    valid = out["v_mask"].bool()

    def model_err(a, b):
        return max(float((a[k].double() - b[k].double()).abs()[valid].max())
                   for k in keys)

    errs = {ref_name: model_err(out, ref) for ref_name, ref in refs.items()}
    control = model_err(refs["fp32"], refs["twins"])
    finite = all(bool(torch.isfinite(out[k][valid]).all()) for k in keys)
    spans16 = loc.localize_batch(triples)
    spans32 = loc32.localize_batch(triples)
    same = sum(a == b for a, b in zip(spans16, spans32)) / len(spans16)

    def batch_ms(lo):
        def run():
            lo.localize_batch(triples)
            torch.cuda.synchronize()
        run()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        return (time.perf_counter() - t0) / 5 * 1e3

    ms16, ms32 = batch_ms(loc), batch_ms(loc32)
    emit({"phase": "bf16", "requests": len(replies), "launches": launches,
          "max_err": errs, "tol": BF16_MODEL_TOL, "finite": finite,
          "fp32_model_err_vs_twins": control,
          "spans_equal_share_vs_fp32": same, "batch16_ms_bf16": ms16,
          "batch16_ms_fp32": ms32, "batch16_ms_bf16_off": batch_ms(loc_off)})
    prof16 = profile_device(lambda: loc.localize_batch(triples), ms16)
    prof32 = profile_device(lambda: loc32.localize_batch(triples), ms32)
    emit({"phase": "profile", "of": "served batch of 16 at bf16",
          "fp32_device_ms_without_copies": prof32["device_ms_without_copies"],
          **prof16})
    check(finite and all(errs[k] <= BF16_MODEL_TOL[k] for k in errs),
          "the bf16 served model disagrees: %s > %s" % (errs, BF16_MODEL_TOL))
    check(control > BF16_MODEL_TOL["twins"], "the fp32 model is within %g "
          "of the bf16 twins (%g): the check does not tell the functions "
          "apart" % (BF16_MODEL_TOL["twins"], control))
    return launches


# --- the bf16 training phase --------------------------------------------------

# the kernels a bf16 train step launches in their bf16 entries, by the fp32
# names whose launches they take over
BF16_TRAIN_NAMES = BF16_NAMES[1:] + (
    "lstm_recurrence_fwd_res", "lstm_recurrence_bwd", "conv_block_bwd",
    "conv_block_bwd_tiled", "mha_block_bwd")
# a bf16 train step with the kernels against the same step through the
# bf16 twins' composition on the card (forward and backward: the same
# function, each bf16 flip carried down two 128-step LSTM chains and
# four blocks): the loss within BF16_STEP_LOSS_RTOL, each parameter's
# gradient within BF16_STEP_GRAD of its largest entry plus BF16_STEP_ATOL
# of the model's largest gradient entry (for the sums that cancel to
# near 0: the heads' biases, the key bias); against use_pallas=off at
# bf16 (the XLA path's function, bf16 residuals and state: another
# function) within BF16_STEP_OFF of the largest entry, plus the same.
# The fp32 model's step from the same weights must fail the first bound
# (one H100: the kernels 0.24 of it, the fp32 step 1.64). The step through
# torch's autograd of the bf16 forward twins is reported, not held: it
# shares the twins' forward bit for bit, and the kernels' forward flips
# carried down the chains move the kernels' step farther from the twins'
# (0.24) than its other rounding points move it (0.063), so only the
# kernel rows, on shared inputs, tell that impostor apart.
BF16_STEP_LOSS_RTOL = 1e-2
BF16_STEP_GRAD = 0.1
BF16_STEP_OFF = 0.5
BF16_STEP_ATOL = 5e-3


def bf16_timed_row(rows, name, source, line, err, tol, fn, plain, work,
                   nbytes, plain_iters=None, parts_named=None, **extra):
    """A bf16 kernel's row (kernel_row, its bound of work and nbytes): fn
    timed by CUDA events and by torch.profiler, its twin plain by events
    (plain_iters calls; 3 for the LSTM's Python loop, else 10).
    parts_named {key: name}: the row's key takes the device ms of fn's
    kernels whose names hold `name`."""
    from vslnet_torch.bench.common import by_kernel

    # a profile that kept no record of a call, or of a part of one (PERF.md
    # §7), reads below the bound: it is taken again, once, and a second such
    # profile fails the row
    least, _ = bound(work, nbytes)
    parts = by_kernel(fn)
    if sum(parts.values()) < least:
        parts = by_kernel(fn)
    check(sum(parts.values()) >= least, "%s: its profile read %g device ms, "
          "below its bound of %g ms: a record lost" % (name, sum(parts.values()), least))
    named = {key: sum(ms for k, ms in parts.items() if sub in k)
             for key, sub in (parts_named or {}).items()}
    if plain_iters is None:
        plain_iters = 3 if "lstm" in name else 10
    rows.append(kernel_row(
        name, "vslnet_torch/csrc/" + source,
        "vslnet_tpu/ops/pallas_kernels.py:%d" % line, err, tol,
        cuda_ms(fn, 20), cuda_ms(plain, plain_iters), work, nbytes,
        device_ms=sum(parts.values()),
        by_kernel=parts, **named, **extra))


def bf16_vjp_row(rows, name, source, line, cases, work, nbytes, fp64=None,
                 **extra):
    """One row of the cases of one bf16 backward entry point (drop 0 and
    0.2, and the shapes given): each case's readings (bench/bf16_vjp.py:
    share, slice_share, mean_rel, elem) and its controls', the worst
    reading over its limit held to 1, the first case timed beside the fp32
    kernel on the same inputs. With fp64 (the twin's function, taking
    work=float64) each case is also held by bf16_vjp.fp64_verdict: its bf16
    outputs no further from the fp64 evaluation than the twin's plus the
    twin limits."""
    from vslnet_torch.bench import bf16_vjp as V
    from vslnet_torch.bench.common import by_kernel

    readings, worst, raw = [], (0.0, "", ""), 0.0
    for case in cases:
        r = V.read(case)
        ok, why = V.verdict(case, r)
        check(ok, why)
        kern, twin = case.kernel(), case.twin()
        raw = max(raw, max(max_err(a, b) for a, b in zip(kern, twin)))
        worst = max(worst, V.worst(case, r))
        readings.append({"shape": list(case.shape), **r})
        if fp64 is not None:
            f = V.fp64_readings(case, fp64)
            ok, why = V.fp64_verdict(case, r, f)
            check(ok, why)
            readings[-1]["fp64"] = f
    first = cases[0]
    bf16_timed_row(rows, name, source, line, raw, 1.0, first.kernel,
                   first.twin, work, nbytes,
                   fp32_ms=cuda_ms(first.fp32, 20),
                   fp32_device_ms=sum(by_kernel(first.fp32).values()),
                   checked_err_is="the worst reading over its limit",
                   checked_err=worst[0], worst_reading=list(worst[1:]),
                   limits=V.limits(first), cases=readings,
                   equal_bits_twice=all(r["equal_bits_twice"]
                                        for r in readings), **extra)


def bf16_train_kernel_rows(dev, max_w):
    """The five bf16 training entry points at the training shapes against
    their plain twins on the card (bench/bf16_vjp.py's readings, with both
    controls), equal bits twice, time by CUDA events and by torch.profiler,
    the fp32 kernel's on the same inputs (fp32_ms, fp32_device_ms), the
    twin's time and the bound at the bf16 peak; cuDNN's bf16 nn.LSTM
    beside the LSTM's."""
    import torch

    from vslnet_torch.bench import bf16_vjp as V
    from vslnet_torch.bench.common import by_kernel, conv_bwd_bf16_work, mha_bwd_bf16_work
    from vslnet_torch.ops import kernels as K

    bf = torch.bfloat16
    rng = np.random.default_rng(SEED + 13)
    B, T, D, H, L, KS, heads = 16, 128, 128, 128, 4, 7, 8
    rows = []

    def timed_row(*args, **extra):
        bf16_timed_row(rows, *args, **extra)

    def vjp_rows(*args, **extra):
        bf16_vjp_row(rows, *args, **extra)

    # 1. the LSTM forward with residuals (#7) and its backward (#8), x_proj
    # [T, B, 4H] and k_h in bf16
    lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])
    x_proj = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(
        np.float32)).to(dev, bf)
    k_h = torch.from_numpy((rng.standard_normal((H, 4 * H)) / math.sqrt(H))
                           .astype(np.float32)).to(dev, bf)
    valid = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(
        np.float32)).to(dev)
    args = (x_proj, k_h, valid)
    args32 = (x_proj.float(), k_h.float(), valid)
    got = K.launch_lstm_fwd_res(*args)
    again = K.launch_lstm_fwd_res(*args)
    twice = all(torch.equal(a, b) for a, b in zip(got, again))
    check(twice, "lstm_recurrence_fwd_res_bf16: two equal calls differ")
    ref = K.lstm_recurrence_plain(*args, residuals=True)
    ref32 = K.lstm_recurrence_plain(x_proj.float(), k_h.float(), valid,
                                    residuals=True)

    def mean_err(a):
        return float((a - ref[0]).abs()[valid.bool()].mean())

    mean_check = bf16_function_check(
        "lstm_recurrence_fwd_res_bf16", "mean_abs_err", mean_err(got[0]),
        mean_err(ref32[0]), BF16_LSTM_MEAN_TOL)
    fp64 = V.lstm_fwd_fp64(args, list(got[:2]))
    check(*V.lstm_fwd_fp64_verdict(fp64))
    lstm = lstm_yardstick(x_proj.float(), k_h.float()).to(bf)
    lstm.flatten_parameters()
    xl = x_proj.detach().clone().requires_grad_()
    with torch.no_grad():
        ms_lib_fwd = cuda_ms(lambda: lstm(x_proj), 20)
    dy = torch.randn(T, B, H, device=dev, dtype=bf)
    ms_lib_both = cuda_ms(lambda: torch.autograd.grad(
        lstm(xl)[0], [xl] + list(lstm.parameters()), dy), 20)
    n_valid = int(lens.sum())
    timed_row("lstm_recurrence_fwd_res_bf16", "lstm.cu", 276,
              max(max_err(a, b) for a, b in zip(got, ref)), BF16_LSTM_TOL,
              lambda: K.launch_lstm_fwd_res(*args),
              lambda: K.lstm_recurrence_plain(*args, residuals=True),
              {"bf16": 2 * n_valid * H * 4 * H},
              2 * (T * B * 4 * H + H * 4 * H) + 4 * (T * B + 8 * T * B * H),
              library_ms=ms_lib_fwd, library="cuDNN nn.LSTM in bf16, forward",
              fp32_ms=cuda_ms(lambda: K.launch_lstm_fwd_res(*args32), 20),
              fp32_device_ms=sum(by_kernel(
                  lambda: K.launch_lstm_fwd_res(*args32)).values()),
              shape=[T, B, 4 * H], equal_bits_twice=twice,
              err_vs_fp32_function=max_err(got[0], ref32[0]),
              plan=K.lstm_fwd_bf16_plan(B, H)._asdict(), fp64=fp64, **mean_check)
    lstm_tc_checks(rows[-1])

    def lstm_bwd_work(T_, n_valid_):
        return ({"bf16": 4 * n_valid_ * H * 4 * H},
                4 * (T_ * B + 8 * T_ * B * H) + 2 * (2 * H * 4 * H + T_ * B * 4 * H))

    # the tensor-core backward also at path M's T = 192: its device
    # time and bound, and its outputs against an fp64 evaluation of the
    # function, no further from it than the twin plus the twin limits
    lstm_128 = V.lstm_case(dev, rng, T, B, H)
    lstm_m = V.lstm_case(dev, rng, 192, B, H)
    parts = by_kernel(lstm_m.kernel)
    fp64_m = V.fp64_readings(lstm_m, K.lstm_recurrence_bwd_plain)
    check(*V.fp64_verdict(lstm_m, V.read(lstm_m), fp64_m))
    vjp_rows("lstm_recurrence_bwd_bf16", "lstm.cu", 316,
             [lstm_128], *lstm_bwd_work(T, n_valid),
             library_ms=ms_lib_both - ms_lib_fwd,
             library="cuDNN nn.LSTM in bf16, forward+backward - forward",
             plan=K.lstm_bwd_bf16_plan(B, H)._asdict(),
             path_M={"shape": [192, B, 4 * H], "device_ms": sum(parts.values()),
                     "by_kernel": parts, "fp64": fp64_m,
                     "bound_ms": bound(*lstm_bwd_work(
                         192, int(lstm_m.counted["dx_proj"].sum())))[0]})

    # 2. the conv block backward (#9): whole-row at the query stream's [B,
    # max_w, D], T-tiled at the video's [B, T, D]; drop 0 and 0.2
    # the bounds of the backwards' functions (bench/common.py): x, g and dx
    # in bf16, the key mask, the weights and their gradients; not the
    # residuals (layer inputs, masks, qkv, att) the port keeps between the
    # two directions
    def conv_work(T_, B_=B):
        return conv_bwd_bf16_work(B_, T_, D, KS, L)

    def lib_ms(fn):
        return sum(by_kernel(fn).values())

    for name, T_, tiled, line in (("conv_block_bwd_bf16", max_w, False, 1039),
                                  ("conv_block_bwd_tiled_bf16", T, True,
                                   1039)):
        cases = [V.conv_case(dev, rng, B, T_, D, rate, tiled)
                 for rate in (DROP, 0.0)]
        # its products' parts alone, a layer each, in cuBLAS bf16
        a_ = torch.randn(B * T_, D, device=dev, dtype=bf)
        w_ = torch.randn(D, D, device=dev, dtype=bf)
        extra = {"parts_library_device_ms_a_layer": {
            "cublas_g_d": lib_ms(lambda: a_ @ w_.t()),
            "cublas_dwp": lib_ms(lambda: a_.t() @ a_)}}
        if tiled:  # also at path M's [16, 192, 128] and path L's [8, 1024,
            # 128], the tensor-core kernel's plan, device time and bound
            extra["plan"] = K.conv_tiled_bwd_bf16_plan(B, T_, D, KS, L)._asdict()
            for path, (B_, T_p) in (("L", (8, 1024)), ("M", (16, 192))):
                cases.append(V.conv_case(dev, rng, B_, T_p, D, DROP, True))
                parts = by_kernel(cases[-1].kernel)
                extra["path_" + path] = {
                    "shape": [B_, T_p, D], "device_ms": sum(parts.values()),
                    "fp32_device_ms": sum(by_kernel(cases[-1].fp32).values()),
                    "by_kernel": parts,
                    "plan": K.conv_tiled_bwd_bf16_plan(B_, T_p, D, KS, L)._asdict(),
                    "bound_ms": bound(*conv_work(T_p, B_))[0]}
        else:  # #9b: on the tensor cores from #2b's residuals
            extra.update(
                note="redesigned on the tensor cores: a CTA a row through every layer, g_d on "
                     "mma.sync, dwp on wgrad_tc, from #2b's saved layer inputs "
                     "and ReLU masks",
                plan=K.conv_bwd_bf16_plan(B, T_, D, KS, L)._asdict())
        vjp_rows(name, "conv_block.cu", line, cases, *conv_work(T_),
                 fp64=None if tiled else K.conv_block_bwd_plain, shape=[B, T_, D],
                 route_train=K.conv_route(T_, D, KS, L, True), **extra)

    # 3. the MHA block backward (#10) at [B, T, D] and [B, max_w, D], 8
    # heads, a fully masked row; drop 0 and 0.2; the bound of this run's
    # keys (a row's unmasked keys, all T for the fully masked row)
    cases = [V.mha_case(dev, rng, B, T_, D, heads, rate)
             for T_ in (T, max_w) for rate in (DROP, 0.0)]

    def keys_of(case):
        mask = case.args[1]
        lens = mask.sum(dim=1)
        return int(torch.where(lens > 0, lens, torch.full_like(lens, mask.shape[1])).sum())

    query = cases[2]
    q_parts = by_kernel(query.kernel)
    parts = {}
    for T_, case in ((T, cases[0]), (max_w, query)):
        # the parts alone in bf16: SDPA's backward at [B, heads, T, hd] with
        # the key mask (forward + backward minus forward), cuBLAS's g_z, g_y,
        # dwd and dwqkv
        qh, kh, vh = (torch.randn(B, heads, T_, D // heads, device=dev, dtype=bf,
                                  requires_grad=True) for _ in range(3))
        am = case.args[1].bool()[:, None, None, :]
        go = torch.randn(B, heads, T_, D // heads, device=dev, dtype=bf)

        def sdpa(grad, qh=qh, kh=kh, vh=vh, am=am, go=go):
            with torch.set_grad_enabled(grad):
                out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
                return torch.autograd.grad(out, (qh, kh, vh), go) if grad else out

        a1, a3 = (torch.randn(B * T_, n, device=dev, dtype=bf) for n in (D, 3 * D))
        w1, w3 = (torch.randn(D, n, device=dev, dtype=bf) for n in (D, 3 * D))
        parts["T=%d" % T_] = {
            "sdpa_backward": lib_ms(lambda: sdpa(True)) - lib_ms(lambda: sdpa(False)),
            "cublas_g_z": lib_ms(lambda: a1 @ w1.t()), "cublas_g_y": lib_ms(lambda: a3 @ w3.t()),
            "cublas_dwd": lib_ms(lambda: a1.t() @ a1), "cublas_dwqkv": lib_ms(lambda: a1.t() @ a3)}
    vjp_rows("mha_block_bwd_bf16", "mha_block.cu", 1762, cases,
             *mha_bwd_bf16_work(B, T, D, keys_of(cases[0])), fp64=K.mha_block_bwd_plain,
             shape=[B, T, D], heads=heads, query_T=max_w,
             note="redesigned on the tensor cores: the per-frame products on mma.sync (tile_mma_bt), the "
                  "attention a CTA a (row, head) on mma.sync, dwd and dwqkv on wgrad_tc",
             plan=K.mha_bwd_bf16_plan(B, T, D, heads)._asdict(),
             query_plan=K.mha_bwd_bf16_plan(B, max_w, D, heads)._asdict(),
             query_device_ms=sum(q_parts.values()), query_by_kernel=q_parts,
             query_bound_ms=bound(*mha_bwd_bf16_work(B, max_w, D, keys_of(query)))[0],
             parts_library_device_ms=parts)
    return rows


def step_grads_against(trainer, refs, tol):
    """A train step's gradients (trainer's parameters') against refs
    {name: gradient}: every leaf's max error over tol of its largest entry
    plus BF16_STEP_ATOL of the refs' largest entry; the worst ratio and its
    leaf, and the median over leaves of the mean error over the mean
    magnitude."""
    got = {n: p.grad for n, p in trainer.model.named_parameters()}
    atol = BF16_STEP_ATOL * max(float(g.abs().max()) for g in refs.values())
    ratios = {n: max_err(g, refs[n]) / (tol * float(refs[n].abs().max())
                                       + atol) for n, g in got.items()}
    means = [float((g.double() - refs[n].double()).abs().mean()
                   / refs[n].double().abs().mean().clamp_min(1e-30))
             for n, g in got.items()]
    n = max(ratios, key=ratios.get)
    return {"worst": [ratios[n], n], "median_mean_rel": float(np.median(means))}


def bf16_train_phase(dataset, feats, fp32_launches, fp32_trainer):
    """precision=bf16 training of the full-width rnn model: one step with
    the kernels against the bf16 twins' composition and against
    use_pallas=off at bf16, from the same weights, batch and generator
    seed; then TRAIN_STEPS steps with the kernels, their launches equal
    kernel by kernel to the fp32 train phase's with the kernels that have
    a bf16 form under their bf16 entries, the loss finite and falling; a
    step profiled at fp32 (the train phase's trainer), bf16, bf16, fp32
    in turns (a mostly idle card runs a step at clocks that vary between
    runs). Returns the steps' launches."""
    import torch

    from vslnet_torch.bench.paths import profile_device, train_config
    from vslnet_torch.ops import kernels as K
    from vslnet_torch.train.runner import Trainer

    def cfg(up):
        return train_config(dataset, up, SEED, precision="bf16")

    tk, to = trainers(cfg, dataset, feats)
    tt = Trainer(cfg("auto"), dataset, feats)
    # the controls, from the same weights, batch and generator seed: the
    # fp32 model's step, which must fail the bound against the twins, and
    # the step through torch's autograd of the bf16 forward twins
    # (reported; BF16_STEP_GRAD's comment)
    tf = Trainer(train_config(dataset, "auto", SEED), dataset, feats)
    ta = Trainer(cfg("auto"), dataset, feats)
    check(tk.model.dtype == torch.bfloat16, "a bf16 model")
    named_k = dict(tk.model.named_parameters())
    check(all(torch.equal(p, named_k[n]) for n, p in
              tf.model.named_parameters()),
          "the fp32 control must start from the bf16 model's weights")
    del named_k
    loss_k, _ = tk.step()
    K.reset_launches()
    with TwinsOnTheCard(train=True):
        loss_t, _ = tt.step()
    with TwinsOnTheCard():
        loss_a, _ = ta.step()
    check(not any(K.LAUNCHES.values()), "the twins launched a kernel")
    loss_o, _ = to.step()
    loss_f, _ = tf.step()

    def grads(t):
        return {n: p.grad for n, p in t.model.named_parameters()}

    twins = grads(tt)
    errs = {"twins": step_grads_against(tk, twins, BF16_STEP_GRAD),
            "off": step_grads_against(tk, grads(to), BF16_STEP_OFF),
            "control_fp32": step_grads_against(tf, twins, BF16_STEP_GRAD),
            "control_autograd": step_grads_against(ta, twins,
                                                   BF16_STEP_GRAD)}
    loss_rel = {k: abs(float(loss_k) - float(v)) / abs(float(v))
                for k, v in (("twins", loss_t), ("off", loss_o))}
    emit({"phase": "bf16_train_step", "loss_kernels": float(loss_k),
          "loss_twins": float(loss_t), "loss_off": float(loss_o),
          "loss_control_fp32": float(loss_f),
          "loss_control_autograd": float(loss_a),
          "loss_rel_err": loss_rel, "loss_rtol": BF16_STEP_LOSS_RTOL,
          "grad_tol": {"twins": BF16_STEP_GRAD, "off": BF16_STEP_OFF},
          "grad_atol_of_largest": BF16_STEP_ATOL, "grads": errs})
    check(loss_rel["twins"] <= BF16_STEP_LOSS_RTOL
          and errs["twins"]["worst"][0] <= 1.0
          and errs["off"]["worst"][0] <= 1.0,
          "a bf16 train step disagrees: %s %s" % (loss_rel, errs))
    check(errs["control_fp32"]["worst"][0] > 1.0,
          "the fp32 step is within the bound against the twins (%s): the "
          "step's check does not tell it from the bf16 VJPs"
          % errs["control_fp32"])
    del tt, ta, tf, to, twins

    K.reset_launches()
    losses, times = timed_steps(tk, TRAIN_STEPS)
    launches = dict(K.LAUNCHES)
    expected = dict(fp32_launches)
    for n in BF16_TRAIN_NAMES:
        expected[n + "_bf16"], expected[n] = expected[n], 0
    step_ms = float(np.mean(times[2:]))
    emit({"phase": "bf16_train", "steps": TRAIN_STEPS, "losses": losses,
          "launches": launches, "step_ms_kernels": step_ms,
          "step_ms_each": times})
    check(launches == expected, "bf16 train launch counts %s, expected %s"
          % (launches, expected))
    check(bool(np.isfinite(losses).all()), "non-finite bf16 training loss")
    check(float(np.mean(losses[-5:])) < losses[0],
          "the bf16 loss did not fall: %s" % losses)
    turns = [profile_device(t.step, step_ms)
             for t in (fp32_trainer, tk, tk, fp32_trainer)]
    emit({"phase": "profile", "of": "train step at bf16",
          **turns_fields(turns), **turns[1]})
    return launches

# --- phase 6 -------------------------------------------------------------------
# Beyond T = 145, where the whole-row conv and MHA block kernels do not fit
# a block: path M (the rnn predictor at max_pos_len 192, batch 16; its
# attention takes the whole-T kernels) and path L (the long-context
# transformer predictor at max_pos_len 1024, batch 8, as the JAX bench's
# long_context rows at fp32; flash). Both tile the video stream's conv
# block; the query stream (T = max_w) keeps the block kernels.

LONG_PATHS = {"M": {"predictor": "rnn", "max_pos_len": 192, "batch_size": 16,
                    "train_steps": 3},
              "L": {"predictor": "transformer", "max_pos_len": 1024,
                    "batch_size": 8, "train_steps": 10}}
LONG_KERNELS = {  # the new kernels' paths: the other path never runs them
    "mha_fwd": "M", "mha_bwd": "M", "flash_mha_fwd": "L", "flash_mha_bwd": "L",
    "conv_block_fwd_tiled": "ML", "conv_block_bwd_tiled": "ML"}


def attention_probe(rng, q, heads):
    """A v whose channel d of head h is 1 at one key j_d and 0 elsewhere:
    out[t, h * hd + d] is head h's dropped probability of (t, j_d), 0
    exactly where the hash drops it (or the key is masked)."""
    import torch

    B, T, D = q.shape
    hd = D // heads
    v = torch.zeros_like(q)
    cols = torch.from_numpy(rng.choice(T, hd, replace=False)).to(q.device)
    for h in range(heads):
        v[:, cols, h * hd + torch.arange(hd, device=q.device)] = 1.0
    return v


def sdpa_yardstick(q, k, v, mask, heads):
    """F.scaled_dot_product_attention on the same heads and the additive
    mask (in q's dtype) at drop 0: (forward ms, backward ms =
    forward+backward minus forward, forward+backward ms, by CUDA events;
    the device time of the backward's kernels, of the forward's kernels,
    torch.profiler). A yardstick; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from vslnet_torch.bench.common import by_kernel

    B, T, D = q.shape

    def split(x):
        return x.view(B, T, heads, D // heads).transpose(1, 2).contiguous()

    qh, kh, vh = (split(x).requires_grad_() for x in (q, k, v))
    bias = ((1.0 - mask) * -1e30).view(B, 1, 1, T).to(q.dtype)
    g = torch.randn_like(qh)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
        torch.autograd.grad(out, (qh, kh, vh), g)

    f = cuda_ms(fwd, 20)
    fb = cuda_ms(fwd_bwd, 20)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
    b_device = sum(by_kernel(lambda: torch.autograd.grad(
        out, (qh, kh, vh), g, retain_graph=True)).values())
    return f, fb - f, fb, b_device, sum(by_kernel(fwd).values())


def long_kernel_rows(dev):
    """The whole-T and flash attention kernels and the tiled conv block
    against their plain versions at the long paths' shapes (random inputs,
    the paths' ragged lengths T/2..T and one fully masked row): output,
    every gradient of sum(out * g) and the dropout zero pattern; times
    beside the plain versions and, for attention, SDPA's."""
    import torch

    from vslnet_torch.bench.common import by_kernel
    from vslnet_torch.ops import kernels as K

    rng = np.random.default_rng(SEED + 2)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    D, heads, L, KS = 128, 8, 4, 7
    rows = []

    def seeds_for(n):
        return t(rng.integers(0, 1 << 23, (n, 1)))

    def attention_rows(path, fname, bname, rep_fwd, rep_bwd, source,
                       launch_fwd, launch_bwd, flash):
        cfg = LONG_PATHS[path]
        B, T = cfg["batch_size"], cfg["max_pos_len"]
        lens = list(rng.integers(T // 2, T + 1, B - 1)) + [0]
        q, k, v = (t(rng.standard_normal((B, T, D))) for _ in range(3))
        mask = t(np.arange(T)[None, :] < np.asarray(lens)[:, None])
        seeds = seeds_for(B)
        check(K.attention_route(T, D // heads) == ("flash" if flash else
                                                    "whole"), "route")
        # forward at drop 0 (serving) and 0.2 (training); the flash lse
        err = max(max_err(K.fused_mha(q, k, v, mask, heads, *sd),
                          K.attention(q, k, v, mask, heads, *sd))
                  for sd in ((None, 0.0), (seeds, DROP)))
        extra = {}
        if flash:
            out, lse = K.launch_flash_mha_fwd(q, k, v, mask, heads, seeds,
                                              DROP)
            out_p, lse_p = K.flash_attention_plain(q, k, v, mask, heads,
                                                   seeds, DROP)
            extra["lse_max_abs_err"] = max_err(lse, lse_p)
            err = max(err, max_err(out, out_p), extra["lse_max_abs_err"])
        probe = [q, k, attention_probe(rng, q, heads), mask, heads, seeds,
                 DROP]
        zeros_equal = torch.equal(K.fused_mha(*probe) == 0,
                                  K.attention(*probe) == 0)
        check(zeros_equal, "%s: the dropout zero pattern differs" % fname)
        g = t(rng.standard_normal((B, T, D)))
        abs_err, g_err, finite = autograd_pair(
            lambda q, k, v: K.fused_mha(q, k, v, mask, heads, seeds, DROP),
            lambda q, k, v: K.attention(q, k, v, mask, heads, seeds, DROP),
            [q, k, v], 3, g)
        check(finite, "%s: non-finite output or gradient" % fname)
        lib_f, lib_b, lib_fb, lib_b_device, _ = sdpa_yardstick(q, k, v, mask,
                                                               heads)
        # only the valid keys need scores and P.V (all T on the masked row)
        keys = sum(n if n else T for n in lens)
        io = B * T * D
        lse_io = B * heads * T if flash else 0
        shape = {"shape": [B, T, D], "heads": heads, "path": path}
        if flash:
            # no atomics: two equal calls, equal bits; the plan, and the
            # device time of a call's kernels (torch.profiler), at drop 0
            # (serving) and 0.2 (training)
            twice = all(torch.equal(a, b) for a, b in zip(
                launch_fwd(q, k, v, mask, heads, seeds, DROP),
                launch_fwd(q, k, v, mask, heads, seeds, DROP)))
            check(twice, "%s: two equal calls differ" % fname)
            parts = by_kernel(lambda: launch_fwd(q, k, v, mask, heads))
            drop_parts = by_kernel(lambda: launch_fwd(q, k, v, mask, heads,
                                                      seeds, DROP))
            extra.update(equal_bits_twice=twice,
                         plan=K.flash_fwd_plan(B, T, D, heads)._asdict(),
                         device_ms=sum(parts.values()), by_kernel=parts,
                         dropout_device_ms=sum(drop_parts.values()))
        rows.append(kernel_row(
            fname, source, rep_fwd, err, TOL,
            cuda_ms(lambda: launch_fwd(q, k, v, mask, heads), 20),
            cuda_ms(lambda: K.attention(q, k, v, mask, heads), 5),
            # q, k, v and the mask read, out (and lse) written
            {"fp32": 4 * T * keys * D}, 4 * (4 * io + B * T + lse_io),
            library_ms=lib_f, dropout_zero_pattern_equal=zeros_equal,
            dropout_ms=cuda_ms(lambda: launch_fwd(q, k, v, mask, heads,
                                                  seeds, DROP), 20),
            **extra, **shape))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out_p = K.attention(*leaves, mask, heads, seeds, DROP)
        # what each backward reads of its forward: out and lse (flash), out
        saved = (K.launch_flash_mha_fwd(q, k, v, mask, heads, seeds, DROP)
                 if flash else (K.launch_mha_fwd(q, k, v, mask, heads, seeds,
                                                 DROP),))

        def bwd():
            return launch_bwd(q, k, v, mask, heads, seeds, DROP, *saved, g)

        # no atomics: two equal calls, equal bits; the plan, and the device
        # time of a call's kernels (torch.profiler)
        twice = all(torch.equal(a, b) for a, b in zip(bwd(), bwd()))
        check(twice, "%s: two equal calls differ" % bname)
        parts = by_kernel(bwd)
        plan = (K.flash_bwd_plan if flash else K.mha_whole_bwd_plan)(
            B, T, D, heads)
        extra = {"equal_bits_twice": twice, "plan": plan._asdict(),
                 "device_ms": sum(parts.values()), "by_kernel": parts}
        ms = cuda_ms(bwd, 20)
        rows.append(kernel_row(
            bname, source, rep_bwd, abs_err, TOL, ms,
            cuda_ms(lambda: torch.autograd.grad(out_p, leaves, g,
                                                retain_graph=True), 5),
            # scores recomputed, dP, dV, dQ and dK over the valid keys;
            # q, k, v, g, out (flash: and lse), mask and seeds read, dq, dk,
            # dv written
            {"fp32": 10 * T * keys * D}, 4 * (8 * io + B * T + B + lse_io),
            library_ms=lib_b, checked_err=g_err, library_fwd_bwd_ms=lib_fb,
            library_device_ms=lib_b_device, drop_rate=DROP, **extra,
            **shape))
        check(ms < lib_b, "%s: %g ms, not below SDPA's backward %g"
              % (bname, ms, lib_b))
        if not flash:
            check(extra["device_ms"] < lib_b_device, "%s: %g ms of device "
                  "time, not below SDPA's backward's %g" % (
                      bname, extra["device_ms"], lib_b_device))

    tpu = "vslnet_tpu/ops/pallas_kernels.py:"
    attention_rows("M", "mha_fwd", "mha_bwd", tpu + "696", tpu + "716",
                   "vslnet_torch/csrc/mha_block.cu", K.launch_mha_fwd,
                   K.launch_mha_bwd, flash=False)
    attention_rows("L", "flash_mha_fwd", "flash_mha_bwd", tpu + "1395",
                   tpu + "1454", "vslnet_torch/csrc/flash_mha.cu",
                   K.launch_flash_mha_fwd, K.launch_flash_mha_bwd, flash=True)

    # the tiled conv block at both paths' shapes, timed at path L's. Biases
    # of +-1 and a pointwise product ten times smaller keep every
    # pre-activation ~1 from the ReLU's kink, where fp32 sums in another
    # order than cuBLAS's could flip a ReLU and move the gradients of the
    # frames around it by ~0.1 (tests/test_torch_cuda.py
    # _conv_inputs_off_kink)
    def conv_inputs(B, T):
        return [t(rng.standard_normal((B, T, D))),
                t(1 + 0.1 * rng.standard_normal((L, D))),
                t(0.1 * rng.standard_normal((L, D))),
                t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                t(0.1 * rng.standard_normal((L, D, D)) / math.sqrt(D)),
                t(np.where(rng.random((L, D)) < 0.5, -1.0, 1.0))]

    f_errs, b_errs, g_errs, zeros, path_args = [], [], [], [], {}
    for path in ("M", "L"):
        B, T = (LONG_PATHS[path][k] for k in ("batch_size", "max_pos_len"))
        check(K.conv_route(T, D, KS, L) == "tiled", "conv route at T=%d" % T)
        args, seeds = conv_inputs(B, T), seeds_for(B)
        path_args[path] = args, seeds
        f_errs += [max_err(K.fused_conv_block(*args, *sd),
                           K.conv_block_plain(*args, *sd))
                   for sd in ((None, 0.0), (seeds, DROP))]
        one = [args[0]] + [w[:1].contiguous() for w in args[1:]]
        zeros.append(torch.equal(
            K.fused_conv_block(*one, seeds, DROP) == args[0],
            K.conv_block_plain(*one, seeds, DROP) == args[0]))
        g = t(rng.standard_normal((B, T, D)))
        abs_err, g_err, finite = autograd_pair(
            lambda *a: K.fused_conv_block(*a, seeds, DROP),
            lambda *a: K.conv_block_plain(*a, seeds, DROP), args, 6, g)
        check(finite, "tiled conv block: non-finite output or gradient")
        b_errs.append(abs_err)
        g_errs.append(g_err)
    check(all(zeros), "conv_block_fwd_tiled: the dropout zero pattern differs")
    shape = {"shape": [B, T, D], "path": "L", "M_shape": [
        LONG_PATHS["M"]["batch_size"], LONG_PATHS["M"]["max_pos_len"], D]}
    weights = L * (3 * D + KS * D + D * D)

    def fwd_work(B_, T_):
        return ({"fp32": L * 2 * B_ * T_ * D * (D + KS)},
                4 * (2 * B_ * T_ * D + weights))

    # the tiled forward on its plan at both paths: equal bits (out and xs)
    # on two equal calls, the device time of a call's kernels
    # (torch.profiler), events and the bound
    by_path = {}
    for path, (a, sd) in path_args.items():
        B_, T_ = a[0].shape[:2]
        first = K.launch_conv_block_fwd_tiled(*a, sd, DROP)
        twice = all(torch.equal(x, y) for x, y in zip(
            first, K.launch_conv_block_fwd_tiled(*a, sd, DROP)))
        check(twice, "conv_block_fwd_tiled: two equal calls differ at path %s"
              % path)
        parts = by_kernel(lambda: K.launch_conv_block_fwd_tiled(*a))
        by_path[path] = {
            "plan": K.conv_tiled_fwd_plan(B_, T_, D, KS, L)._asdict(),
            "ms": cuda_ms(lambda: K.launch_conv_block_fwd_tiled(*a), 20),
            "device_ms": sum(parts.values()), "by_kernel": parts,
            "bound_ms": bound(*fwd_work(B_, T_))[0],
            "equal_bits_twice": twice}
    rows.append(kernel_row(
        "conv_block_fwd_tiled", "vslnet_torch/csrc/conv_block.cu",
        tpu + "1019", max(f_errs), TOL, by_path["L"]["ms"],
        cuda_ms(lambda: K.conv_block_plain(*args), 20), *fwd_work(B, T),
        dropout_zero_pattern_equal=all(zeros),
        dropout_ms=cuda_ms(lambda: K.launch_conv_block_fwd_tiled(
            *args, seeds, DROP), 20),
        plan=by_path["L"]["plan"], device_ms=by_path["L"]["device_ms"],
        by_kernel=by_path["L"]["by_kernel"], equal_bits_twice=True,
        M=by_path["M"], **shape))
    _, xs = K.launch_conv_block_fwd_tiled(*args, seeds, DROP)
    leaves = [a.clone().requires_grad_() for a in args]
    out_p = K.conv_block_plain(*leaves, seeds, DROP)

    def tiled_bwd():
        return K.launch_conv_block_bwd_tiled(args[0], xs, *args[1:], seeds,
                                             DROP, g)

    # no atomics: two equal calls, equal bits
    twice = all(torch.equal(a, b) for a, b in zip(tiled_bwd(), tiled_bwd()))
    check(twice, "conv_block_bwd_tiled: two equal calls differ")
    bwd_zeros = tiled_bwd_zeros(args, seeds)
    check(all(bwd_zeros), "conv_block_bwd_tiled: the dropout zero pattern "
          "differs")
    parts = by_kernel(tiled_bwd)
    rows.append(kernel_row(
        "conv_block_bwd_tiled", "vslnet_torch/csrc/conv_block.cu",
        tpu + "1039", max(b_errs), TOL, cuda_ms(tiled_bwd, 20),
        cuda_ms(lambda: torch.autograd.grad(out_p, leaves, g,
                                            retain_graph=True), 20),
        # the forward's products for the ReLU masks, then the data and
        # weight products
        {"fp32": L * 6 * B * T * D * (D + KS)},
        4 * (3 * B * T * D + 2 * weights + B),
        checked_err=max(g_errs), drop_rate=DROP, equal_bits_twice=twice,
        dropout_zero_pattern_equal=all(bwd_zeros),
        plan=K.conv_tiled_bwd_plan(B, T, D, KS, L)._asdict(),
        M_plan=K.conv_tiled_bwd_plan(*shape["M_shape"], KS, L)._asdict(),
        device_ms=sum(parts.values()), by_kernel=parts, **shape))
    return rows


def long_path(path):
    """One path: a served batch through Localizer against use_pallas=off
    (logits, spans), its launches; one train step against off, then the
    path's steps with the kernels, their launches and times. Returns
    {run: launches}."""
    import torch

    from vslnet_torch.bench.paths import (build_localizer, profile_device,
                                          train_config)
    from vslnet_torch.data.synthetic import synthetic_dataset
    from vslnet_torch.ops import kernels as K

    cfg = LONG_PATHS[path]
    B, T = cfg["batch_size"], cfg["max_pos_len"]
    # the JAX bench's long_context data (bench.py _bench_long_context_one):
    # videos of T/2..T clips of 1024-d features, queries of 3-12 words
    dataset, feats = synthetic_dataset(
        n_train=64, n_test=B, n_videos=8, n_words=1000, n_chars=40,
        max_pos_len=T, video_feature_dim=1024, word_dim=300,
        min_video_len=T // 2, seed=SEED)
    splits = [dataset["train_set"], dataset["test_set"]]

    def configs(use_pallas):
        return train_config(dataset, use_pallas, SEED, cfg["predictor"], T,
                            B)

    # serving: one batch of B requests
    loc = build_localizer(configs("auto"), dataset, splits, SEED)
    loc_off = build_localizer(configs("off"), dataset, splits, SEED)
    triples = [(feats[r["vid"]], r["duration"], " ".join(r["words"]))
               for r in dataset["test_set"][:B]]
    loc.localize_batch(triples)  # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    spans_k = loc.localize_batch(triples)
    torch.cuda.synchronize()
    runs = {"serve": dict(K.LAUNCHES)}
    batch, _ = loc.make_batch(triples)
    with torch.inference_mode():
        out_k, out_p = loc.model(*batch), loc_off.model(*batch)
    logit_err = max(max_err(out_k[k], out_p[k])
                    for k in ("start_logits", "end_logits", "highlight_scores"))
    finite = all(bool(torch.isfinite(out_k[k]).all())
                 for k in ("highlight_scores", "end_logits"))
    same_spans = spans_k == loc_off.localize_batch(triples)

    def batch_ms(lo):
        def run():
            lo.localize_batch(triples)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            run()
        return (time.perf_counter() - t0) / 3 * 1e3

    ms_k = batch_ms(loc)
    emit({"phase": "long_t_serve", "path": path, "T": T, "batch": B,
          "predictor": cfg["predictor"], "launches": runs["serve"],
          "max_logit_err_vs_off": logit_err, "logit_atol": LOGIT_ATOL,
          "spans_equal_vs_off": same_spans, "finite": finite,
          "batch_ms_kernels": ms_k, "batch_ms_off": batch_ms(loc_off),
          "max_w": loc.max_w})
    check(finite and logit_err <= LOGIT_ATOL and same_spans,
          "path %s: the served batch disagrees with use_pallas=off" % path)
    emit({"phase": "profile", "of": "path %s served batch of %d" % (path, B),
          **profile_device(lambda: loc.localize_batch(triples), ms_k)})
    del loc, loc_off, out_k, out_p

    # training: one step against off, then the path's steps
    tk, to = trainers(configs, dataset, feats)
    step_vs_off(tk, to, "path %s (%s, T=%d)" % (path, cfg["predictor"], T))
    _, off_times = timed_steps(to, 2)
    del to
    n = cfg["train_steps"]
    K.reset_launches()
    losses, times = timed_steps(tk, n)
    runs["train"] = dict(K.LAUNCHES)
    step_ms = float(np.mean(times[1:]))
    emit({"phase": "long_t_train", "path": path, "steps": n,
          "losses": losses, "launches": runs["train"],
          "step_ms_kernels": step_ms, "step_ms_off": float(np.mean(off_times)),
          "step_ms_each": times})
    check(bool(np.isfinite(losses).all()), "non-finite training loss")
    if path == "L":
        check(float(np.mean(losses[-5:])) < losses[0],
              "path L: the loss did not fall: %s" % losses)
    emit({"phase": "profile", "of": "path %s train step" % path,
          **profile_device(tk.step, step_ms)})

    # every launch where the path's model says, per served batch and step
    for run, want in (("serve", long_launches(path, 0, False)),
                      ("train", long_launches(path, n, False))):
        expected = {name: want.get(name, 0) for name in K.LAUNCHES}
        check(runs[run] == expected, "path %s %s launch counts %s, expected "
              "%s" % (path, run, runs[run], expected))
    return runs


def long_t_phase(dev):
    rows = long_kernel_rows(dev)
    runs = {path: long_path(path) for path in LONG_PATHS}
    for row in rows:
        by_run = {"%s_%s" % (p, r): c[row["name"]]
                  for p, pr in runs.items() for r, c in pr.items()}
        row["launches"] = sum(by_run.values())
        row["launches_by_run"] = by_run
        row["launches_path"] = "long_t " + "+".join(LONG_KERNELS[row["name"]])
        for p in LONG_PATHS:
            ran = any(by_run["%s_%s" % (p, r)] for r in runs[p])
            check(ran == (p in LONG_KERNELS[row["name"]]),
                  "%s launched on path %s: %s" % (row["name"], p, by_run))
    return rows


# --- phase 6b -----------------------------------------------------------------
# precision=bf16 beyond T = 145: the bf16 whole-T (#11b, #12b) and flash
# (#13b, #14b) kernels against their twins at path M's and path L's shapes,
# then both paths at bf16: a served batch and a train step against the
# twins' composition on the card, path L's 10 steps, launches and profiles
# in turns with fp32.

# the bf16 long phase's steps a path (path L's loss must fall)
BF16_LONG_STEPS = {"M": 3, "L": 10}
# the paths whose bf16 step is held against the twins around kernels that
# round on their own, by the wrappers kept as kernels in the reference: on
# path L the step through all the twins departs by flips across the conv
# blocks' ReLU kinks (PERF.md, Findings), which conv_block_readings
# counts and whose kernels it holds on their own inputs; the flash kernels
# (#13b, #14b, on the tensor cores) sum in another order than
# their twins' cuBLAS products, and their flips cross the same kinks (the
# step around the conv blocks alone read 2.33 of its bound, the fp32 step
# 2.30: PERF.md, Findings), so the reference keeps them too and
# flash_readings holds them on the step's own inputs. The step around the
# conv blocks alone is reported.
BF16_LONG_AROUND = {"L": (("fused_conv_block",),
                          ("fused_conv_block", "fused_mha"))}
# where each bf16 long-T kernel runs: the other path never launches it
BF16_LONG_KERNELS = {"mha_fwd_bf16": "M", "mha_bwd_bf16": "M",
                     "flash_mha_fwd_bf16": "L", "flash_mha_bwd_bf16": "L"}


def bf16_long_kernel_rows(dev):
    """#11b and #12b at path M's [16, 192, 128], #13b and #14b at path L's
    [8, 1024, 128] (8 heads, the paths' ragged lengths T/2..T and one fully
    masked row) against their twins on the card. The forwards at drop 0
    and 0.2: the share of bf16 outputs that differ from the twin within
    BF16_SHARE_TOL, where the fp32 function's and the other route's twin's
    must be beyond it (the flash forward rounds exp(s - m) against each
    1024-key window's max, the whole-T forward the normalised p), the flash
    lse, equal bits twice. The backwards: bench/bf16_vjp.py's readings and
    controls (the fp32 kernel, autograd of the forward twin, the other
    route's backward twin; for #14b at head dim 8 its twin with #13b's
    bf16 scale). Times: events and device time of the kernel and of the
    fp32 kernel on the same inputs, the twin's, SDPA's in bf16, the bound
    at the bf16 peak; #13b (on the tensor cores) must take less
    device time than SDPA's forward in bf16. The flash rows carry their
    plans (flash_fwd_bf16_plan, flash_bwd_bf16_plan)."""
    import torch

    from vslnet_torch.bench import bf16_vjp as V
    from vslnet_torch.bench.common import by_kernel
    from vslnet_torch.ops import kernels as K

    bf = torch.bfloat16
    rng = np.random.default_rng(SEED + 14)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    D, heads = 128, 8
    rows = []
    tpu = "vslnet_tpu/ops/pallas_kernels.py:"
    for path, flash in (("M", False), ("L", True)):
        B, T = (LONG_PATHS[path][k] for k in ("batch_size", "max_pos_len"))
        check(K.attention_route(T, D // heads) == ("flash" if flash else
                                                    "whole"), "route")
        lens = list(rng.integers(T // 2, T + 1, B - 1)) + [0]
        q, k, v = (t(rng.standard_normal((B, T, D))).to(bf) for _ in range(3))
        mask = t(np.arange(T)[None, :] < np.asarray(lens)[:, None])
        seeds = t(rng.integers(0, 1 << 23, (B, 1)))
        whole_twin = K.whole_attention_plain

        def flash_twin(*a):
            return K.flash_attention_plain(*a)[0]

        if flash:
            fname, bname, line_f, line_b = ("flash_mha_fwd_bf16",
                                            "flash_mha_bwd_bf16", 1395, 1454)
            source = "flash_mha.cu"
            twin, other = flash_twin, whole_twin

            def fwd(*a):
                return K.launch_flash_mha_fwd(*a)[0]
        else:
            fname, bname, line_f, line_b = ("mha_fwd_bf16", "mha_bwd_bf16",
                                            696, 716)
            source = "mha_block.cu"
            twin, other, fwd = whole_twin, flash_twin, K.launch_mha_fwd
        errs, raw, shares, ctl32, ctl_other, twice = [], [], [], [], [], True
        for sd in ((None, 0.0), (seeds, DROP)):
            args = (q, k, v, mask, heads, *sd)
            out, ref = fwd(*args), twin(*args)
            twice &= torch.equal(out, fwd(*args))
            errs.append(scaled_err(out, ref))
            raw.append(max_err(out, ref))
            shares.append(share_differing(out, ref))
            ref32 = K.attention(q.float(), k.float(), v.float(), mask, heads,
                                *sd)
            ctl32.append(share_differing(ref32.to(bf), ref))
            ctl_other.append(share_differing(other(*args), ref))
            check(bool(torch.isfinite(out.float()).all()), "%s: not finite"
                  % fname)
        check(twice, "%s: two equal calls differ" % fname)
        share_check = bf16_function_check(fname, "share_differing",
                                          max(shares), min(ctl32),
                                          BF16_SHARE_TOL)
        check(min(ctl_other) > BF16_SHARE_TOL, "%s: the other route's twin "
              "differs on %g of the outputs, within %g: the check does not "
              "tell the routes' functions apart" % (fname, min(ctl_other),
                                                     BF16_SHARE_TOL))
        extra = {}
        if flash:
            lse = K.launch_flash_mha_fwd(q, k, v, mask, heads, seeds, DROP)[1]
            lse_ref = K.flash_attention_plain(q, k, v, mask, heads, seeds,
                                              DROP)[1]
            extra["lse_max_abs_err"] = max_err(lse, lse_ref)
            check(extra["lse_max_abs_err"] <= 1e-3, "%s: lse %g from the "
                  "twin's" % (fname, extra["lse_max_abs_err"]))
        q32, k32, v32 = (x.float() for x in (q, k, v))

        def fwd32():
            return (K.launch_flash_mha_fwd if flash else K.launch_mha_fwd)(
                q32, k32, v32, mask, heads)

        lib_f, lib_b, lib_fb, lib_b_device, lib_f_device = sdpa_yardstick(
            q, k, v, mask, heads)
        keys = sum(n if n else T for n in lens)
        io = B * T * D
        lse_io = B * heads * T if flash else 0
        shape = {"shape": [B, T, D], "heads": heads, "path": path}
        bf16_timed_row(
            rows, fname, source, line_f, max(raw), BF16_TOL,
            lambda: fwd(q, k, v, mask, heads), lambda: twin(q, k, v, mask,
                                                            heads),
            # q, k, v (bf16) and the mask read, out (bf16; and lse) written
            {"bf16": 4 * T * keys * D}, 2 * 4 * io + 4 * (B * T + lse_io),
            plain_iters=5, checked_err=max(errs), library_ms=lib_f,
            library="SDPA in bf16, additive mask", equal_bits_twice=twice,
            library_device_ms=lib_f_device,
            fp32_ms=cuda_ms(fwd32, 20),
            fp32_device_ms=sum(by_kernel(fwd32).values()),
            dropout_device_ms=sum(by_kernel(lambda: fwd(
                q, k, v, mask, heads, seeds, DROP)).values()),
            other_route_share=min(ctl_other), **share_check, **extra,
            **({"plan": K.flash_fwd_bf16_plan(B, T, D, heads)._asdict()}
               if flash else {}), **shape)
        if flash:  # #13b on the tensor cores: below SDPA's forward in bf16
            check(rows[-1]["device_ms"] < lib_f_device, "%s: %g ms of device "
                  "time, not below SDPA's %g" % (fname, rows[-1]["device_ms"],
                                                 lib_f_device))
        cases = [V.attention_case(dev, rng, B, T, D, heads, rate, flash)
                 for rate in (DROP, 0.0)]
        if flash:  # head dim 8: the forward's bf16 scale is another one
            cases.append(V.attention_case(dev, rng, 2, 300, 64, 8, DROP,
                                          True))
        bf16_vjp_row(
            rows, bname, source, line_b, cases,
            # scores recomputed, dP, dV, dQ and dK over the valid keys; q,
            # k, v, g (bf16; flash: and out for delta, and lse), mask and
            # seeds read, dq, dk, dv (bf16) written
            {"bf16": 10 * T * keys * D},
            2 * (8 if flash else 7) * io + 4 * (B * T + B + lse_io),
            library_ms=lib_b, library="SDPA in bf16, forward+backward - "
            "forward", library_fwd_bwd_ms=lib_fb,
            library_device_ms=lib_b_device, drop_rate=DROP,
            plan=(K.flash_bwd_bf16_plan if flash else K.mha_whole_bwd_plan)(
                B, T, D, heads)._asdict(), **shape)
    for row in rows:
        row["replaces"] = tpu + row["replaces"].rsplit(":", 1)[1]
    return rows


def model_err(out, ref, valid):
    """The largest error of the start and end logits and highlight scores
    over the valid frames."""
    return max(float((out[k].double() - ref[k].double()).abs()[valid].max())
               for k in ("start_logits", "end_logits", "highlight_scores"))


def long_launches(path, steps, bf16):
    """{kernel: launches} of a served batch (steps 0) or of `steps` train
    steps on a long path: its T-long encoders' tiled conv blocks and
    attention (3 on the transformer path L, 1 on the rnn path M), the query
    stream's whole-row conv block and MHA block kernels, the LSTM's (rnn),
    CQA, the highlight gate and the span decode; the kernels with a bf16
    form under their bf16 entries at bf16."""
    cfg = LONG_PATHS[path]
    heavy = 3 if cfg["predictor"] == "transformer" else 1
    attn = "flash_mha" if path == "L" else "mha"
    lstm = 2 if cfg["predictor"] == "rnn" else 0
    if not steps:
        want = {"conv_block_fwd_tiled": heavy, attn + "_fwd": heavy,
                "conv_block_fwd": 1, "mha_block_fwd": 1,
                "cqa_concat_fwd": 1, "highlight_gate_fwd": 1,
                "span_decode": 1, "lstm_recurrence_fwd": lstm}
    else:
        want = {k: steps * n for k, n in {
            "conv_block_fwd_tiled": heavy, "conv_block_bwd_tiled": heavy,
            attn + "_fwd": heavy, attn + "_bwd": heavy, "conv_block_fwd": 1,
            "conv_block_bwd": 1, "mha_block_fwd": 1, "mha_block_bwd": 1,
            "lstm_recurrence_fwd_res": lstm,
            "lstm_recurrence_bwd": lstm}.items()}
    if bf16:
        from vslnet_torch.ops import kernels as K

        want = {(k + "_bf16" if k in K._BF16_KERNELS else k): n
                for k, n in want.items()}
    return want


def bf16_long_path(path):
    """One long path at precision=bf16 with long_path's data and seeded
    weights: a served batch against the twins' composition on the card
    (held), use_pallas=off at bf16 and the fp32 model (reported), spans in
    range, its launches; one train step against the twins' composition
    (the fp32 model's step reported as the control), then the path's
    steps (path L's loss must fall); a served batch and a step profiled at
    fp32, bf16, bf16, fp32 in turns. Returns {run: launches}."""
    import torch

    from vslnet_torch.bench.paths import (build_localizer, profile_device,
                                          train_config, wall_ms)
    from vslnet_torch.data.synthetic import synthetic_dataset
    from vslnet_torch.ops import kernels as K
    from vslnet_torch.train.runner import Trainer

    cfg = LONG_PATHS[path]
    B, T = cfg["batch_size"], cfg["max_pos_len"]
    dataset, feats = synthetic_dataset(
        n_train=64, n_test=B, n_videos=8, n_words=1000, n_chars=40,
        max_pos_len=T, video_feature_dim=1024, word_dim=300,
        min_video_len=T // 2, seed=SEED)
    splits = [dataset["train_set"], dataset["test_set"]]

    def configs(use_pallas, precision="bf16"):
        return train_config(dataset, use_pallas, SEED, cfg["predictor"], T,
                            B, precision=precision)

    loc = build_localizer(configs("auto"), dataset, splits, SEED)
    loc_off = build_localizer(configs("off"), dataset, splits, SEED)
    loc32 = build_localizer(configs("auto", "fp32"), dataset, splits, SEED)
    check(loc.model.dtype == torch.bfloat16 and loc.use_kernels,
          "a bf16 model with the kernels")
    triples = [(feats[r["vid"]], r["duration"], " ".join(r["words"]))
               for r in dataset["test_set"][:B]]
    loc.localize_batch(triples)  # warm-ups
    loc32.localize_batch(triples)
    torch.cuda.synchronize()
    K.reset_launches()
    spans = loc.localize_batch(triples)
    torch.cuda.synchronize()
    runs = {"serve": dict(K.LAUNCHES)}
    batch, _ = loc.make_batch(triples)
    with torch.inference_mode():
        out = loc.model(*batch)
        K.reset_launches()
        with TwinsOnTheCard():
            refs = {"twins": loc.model(*batch)}
            if K.mha_route(T, 128, 8) == "whole":
                # the JAX package's route at path M's T: its block kernel,
                # whose bf16 function (fp32 residuals, the attention output
                # unrounded) the port's unfused block is not; a reading
                K.fused_mha_block = K.mha_block_plain
                block_function = loc.model(*batch)
        check(not any(K.LAUNCHES.values()), "the twins launched a kernel")
        refs["off"] = loc_off.model(*batch)
        refs["fp32"] = loc32.model(*batch)
    valid = out["v_mask"].bool()
    errs = {name: model_err(out, ref, valid) for name, ref in refs.items()}
    if K.mha_route(T, 128, 8) == "whole":
        errs["block_kernel_function"] = model_err(out, block_function, valid)
    finite = all(bool(torch.isfinite(out[k][valid]).all())
                 for k in ("start_logits", "end_logits", "highlight_scores"))
    in_range = all(0.0 <= a <= b <= r["duration"] + 1e-3 for (a, b), r in
                   zip(spans, dataset["test_set"][:B]))
    emit({"phase": "bf16_long_serve", "path": path, "T": T, "batch": B,
          "predictor": cfg["predictor"], "launches": runs["serve"],
          "max_err": errs, "tol_twins": BF16_MODEL_TOL["twins"],
          "finite": finite, "spans_in_range": in_range,
          "fp32_model_err_vs_twins": model_err(refs["fp32"], refs["twins"],
                                               valid),
          "batch_ms_bf16": wall_ms(lambda: loc.localize_batch(triples)),
          "batch_ms_fp32": wall_ms(lambda: loc32.localize_batch(triples))})
    check(finite and in_range and errs["twins"] <= BF16_MODEL_TOL["twins"],
          "path %s: the bf16 served batch disagrees with the twins' "
          "composition: %s" % (path, errs))
    ms = wall_ms(lambda: loc.localize_batch(triples))
    turns = [profile_device(lambda lo=lo: lo.localize_batch(triples), ms)
             for lo in (loc32, loc, loc, loc32)]
    emit({"phase": "profile", "of": "path %s served batch of %d at bf16"
          % (path, B), **turns_fields(turns), **turns[1]})
    del loc, loc_off, loc32, out, refs

    tk = Trainer(configs("auto"), dataset, feats)
    tt = Trainer(configs("auto"), dataset, feats)
    tf = Trainer(configs("auto", "fp32"), dataset, feats)
    with ConvBlockCalls(T, kernels=True) as kernel_calls, \
            FlashCalls() as flash_calls:
        loss_k, _ = tk.step()
    K.reset_launches()
    with TwinsOnTheCard(train=True), ConvBlockCalls(T, False) as twin_calls:
        loss_t, _ = tt.step()
    check(not any(K.LAUNCHES.values()), "the twins launched a kernel")
    loss_f, _ = tf.step()
    twins = {n: p.grad for n, p in tt.model.named_parameters()}
    grads = {"twins": step_grads_against(tk, twins, BF16_STEP_GRAD)}
    loss_rel = abs(float(loss_k) - float(loss_t)) / abs(float(loss_t))
    held, losses = "twins", {"loss_twins": float(loss_t)}
    for keep in BF16_LONG_AROUND.get(path, ()):
        # the rest of the path against its twins: the same step with the
        # kept wrappers' kernels in the reference too; the last is held
        tc = Trainer(configs("auto"), dataset, feats)
        with TwinsOnTheCard(train=True, keep=keep):
            loss_c, _ = tc.step()
        held = "twins_around_" + "_and_".join(
            {"fused_conv_block": "conv", "fused_mha": "flash"}[k] for k in keep)
        grads[held] = step_grads_against(
            tk, {n: p.grad for n, p in tc.model.named_parameters()},
            BF16_STEP_GRAD)
        losses["loss_" + held] = float(loss_c)
        loss_rel = abs(float(loss_k) - float(loss_c)) / abs(float(loss_c))
        del tc
    grads["control_fp32"] = step_grads_against(tf, twins, BF16_STEP_GRAD) \
        if held == "twins" else step_grads_against(
            tf, {n: p.grad for n, p in tk.model.named_parameters()},
            BF16_STEP_GRAD)
    blocks = conv_block_readings(kernel_calls.calls, twin_calls.calls)
    attention = flash_readings(flash_calls)
    emit({"phase": "bf16_long_train_step", "path": path, "held": held,
          "loss_kernels": float(loss_k), **losses,
          "loss_control_fp32": float(loss_f), "loss_rel_err": loss_rel,
          "loss_rtol": BF16_STEP_LOSS_RTOL, "grad_tol": BF16_STEP_GRAD,
          "grad_atol_of_largest": BF16_STEP_ATOL, "grads": grads,
          "conv_blocks": blocks, "flash_calls": attention})
    check(loss_rel <= BF16_STEP_LOSS_RTOL and grads[held]["worst"][0] <= 1,
          "path %s: a bf16 train step disagrees with the %s: %s %s"
          % (path, held, loss_rel, grads))
    check(grads["control_fp32"]["worst"][0] > 1,
          "path %s: the fp32 step is within the bound of the bf16 step's "
          "reference (%s): the check does not tell them apart"
          % (path, grads["control_fp32"]))
    check(len(blocks) == len(kernel_calls.calls)
          == long_launches(path, 1, False)["conv_block_bwd_tiled"]
          and all(b["own_inputs"]["worst"][0] <= 1 for b in blocks),
          "path %s: a T-long conv block's kernels disagree with its twin "
          "on the step's own inputs: %s" % (path, blocks))
    flash = long_launches(path, 1, False).get("flash_mha_bwd", 0)
    check(len(attention) == flash and all(
        a["forward"]["share_differing"] <= BF16_SHARE_TOL
        and a["forward"]["lse_max_abs_err"] <= 1e-3
        and a["backward"]["worst"][0] <= 1 for a in attention),
        "path %s: a flash attention call's kernels disagree with their "
        "twins on the step's own inputs: %s" % (path, attention))
    del tt, twins, kernel_calls, twin_calls, flash_calls
    n = BF16_LONG_STEPS[path]
    K.reset_launches()
    losses, times = timed_steps(tk, n)
    runs["train"] = dict(K.LAUNCHES)
    step_ms = float(np.mean(times[1:]))
    emit({"phase": "bf16_long_train", "path": path, "steps": n,
          "losses": losses, "launches": runs["train"],
          "step_ms_kernels": step_ms, "step_ms_each": times})
    check(bool(np.isfinite(losses).all()), "non-finite bf16 training loss")
    if path == "L":
        check(float(np.mean(losses[-5:])) < losses[0],
              "path L at bf16: the loss did not fall: %s" % losses)
    turns = [profile_device(tr.step, step_ms) for tr in (tf, tk, tk, tf)]
    emit({"phase": "profile", "of": "path %s train step at bf16" % path,
          **turns_fields(turns), **turns[1]})
    for run, want in (("serve", long_launches(path, 0, True)),
                      ("train", long_launches(path, n, True))):
        expected = {name: want.get(name, 0) for name in K.LAUNCHES}
        check(runs[run] == expected, "path %s bf16 %s launch counts %s, "
              "expected %s" % (path, run, runs[run], expected))
    return runs


class ConvBlockCalls:
    """The T-long conv blocks of a train step, recorded: with kernels, the
    tiled wrappers' calls (the inputs, the weights as they were, the layer
    inputs the forward kept, the backward's g and gradients); else
    fused_conv_block's calls at T (inputs and weights; entered inside
    TwinsOnTheCard, so its twin's)."""

    def __init__(self, T, kernels):
        self.T, self.kernels, self.calls = T, kernels, []

    def record(self, x, gam, beta, dw, wp, bp, seeds, drop_rate, **kept):
        self.calls.append({"args": (x.detach(), *(
            w.detach().clone() for w in (gam, beta, dw, wp, bp)), seeds,
            float(drop_rate)), **kept})

    def __enter__(self):
        from vslnet_torch.ops import kernels as K

        names = ("launch_conv_block_fwd_tiled", "launch_conv_block_bwd_tiled"
                 ) if self.kernels else ("fused_conv_block",)
        self.saved = {n: getattr(K, n) for n in names}
        if not self.kernels:
            block = self.saved["fused_conv_block"]

            def twin(x, gam, beta, dw, wp, bp, seeds=None, drop_rate=0.0):
                if x.shape[1] == self.T:
                    self.record(x, gam, beta, dw, wp, bp, seeds, drop_rate)
                return block(x, gam, beta, dw, wp, bp, seeds, drop_rate)

            K.fused_conv_block = twin
            return self
        fwd, bwd = self.saved.values()

        def forward(x, gam, beta, dw, wp, bp, seeds=None, drop_rate=0.0,
                    wpb=None):
            out, xs, *mask = fwd(x, gam, beta, dw, wp, bp, seeds, drop_rate,
                                 wpb)
            self.record(x, gam, beta, dw, wp, bp, seeds, drop_rate, xs=xs)
            return (out, xs, *mask)

        def backward(x, xs, gam, beta, dw, wp, bp, seeds, drop_rate, g,
                     mask=None, wpb=None):
            grads = bwd(x, xs, gam, beta, dw, wp, bp, seeds, drop_rate, g,
                        mask, wpb)
            call, = [c for c in self.calls
                     if c["xs"].data_ptr() == xs.data_ptr()]
            call["g"], call["grads"] = g, grads
            return grads

        K.launch_conv_block_fwd_tiled = forward
        K.launch_conv_block_bwd_tiled = backward
        return self

    def __exit__(self, *exc):
        from vslnet_torch.ops import kernels as K

        for n, f in self.saved.items():
            setattr(K, n, f)


class FlashCalls:
    """The flash attention calls of a train step with the kernels,
    recorded: each forward's inputs, out and lse, and its backward's g and
    gradients (launch_flash_mha_fwd and launch_flash_mha_bwd wrapped)."""

    def __enter__(self):
        from vslnet_torch.ops import kernels as K

        self.calls = []
        self.saved = {n: getattr(K, n) for n in ("launch_flash_mha_fwd",
                                                 "launch_flash_mha_bwd")}
        fwd, bwd = self.saved.values()

        def forward(q, k, v, mask, n_heads, seeds=None, drop_rate=0.0):
            out, lse = fwd(q, k, v, mask, n_heads, seeds, drop_rate)
            self.calls.append({"args": (q.detach(), k.detach(), v.detach(),
                                        mask, n_heads, seeds,
                                        float(drop_rate)),
                               "out": out.detach(), "lse": lse})
            return out, lse

        def backward(q, k, v, mask, n_heads, seeds, drop_rate, out, lse, g):
            grads = bwd(q, k, v, mask, n_heads, seeds, drop_rate, out, lse, g)
            call, = [c for c in self.calls if c["lse"].data_ptr()
                     == lse.data_ptr()]
            call["g"], call["grads"] = g, grads
            return grads

        K.launch_flash_mha_fwd = forward
        K.launch_flash_mha_bwd = backward
        return self

    def __exit__(self, *exc):
        from vslnet_torch.ops import kernels as K

        for n, f in self.saved.items():
            setattr(K, n, f)


def flash_readings(flash_calls):
    """For each flash attention call of a train step (FlashCalls): the
    forward kernel's out against flash_attention_plain on the same inputs
    (the share of bf16 outputs that differ, held to BF16_SHARE_TOL as the
    kernel rows are; lse's largest error, to 1e-3), and its backward's
    gradients against flash_attention_bwd_plain on the same inputs, out,
    lse and g (the step's bound, as conv_block_readings holds the conv
    blocks: each output's max error over BF16_STEP_GRAD of its largest
    entry plus BF16_STEP_ATOL of the largest of all three; and the share
    of each that differs)."""
    from vslnet_torch.ops import kernels as K

    out = []
    for c in flash_calls.calls:
        if "grads" not in c:
            continue
        q, k, v, mask, heads, seeds, rate = c["args"]
        ref, lse_ref = K.flash_attention_plain(q, k, v, mask, heads, seeds,
                                               rate)
        refs = K.flash_attention_bwd_plain(q, k, v, mask, heads, seeds, rate,
                                           c["out"], c["lse"], c["g"])
        atol = BF16_STEP_ATOL * max(float(r.abs().max()) for r in refs)
        ratios = {n: max_err(g, r) / (BF16_STEP_GRAD * float(r.abs().max())
                                      + atol)
                  for n, g, r in zip(("dq", "dk", "dv"), c["grads"], refs)}
        worst = max(ratios, key=ratios.get)
        out.append({"shape": list(q.shape), "heads": heads, "drop_rate": rate,
                    "forward": {
                        "share_differing": share_differing(c["out"], ref),
                        "lse_max_abs_err": max_err(c["lse"], lse_ref)},
                    "backward": {"worst": [ratios[worst], worst],
                                 "ratios": ratios, "share_differing": {
                                     n: share_differing(g, r) for n, g, r in
                                     zip(("dq", "dk", "dv"), c["grads"],
                                         refs)}}})
    return out


CONV_GRADS = ("dx", "dgam", "dbeta", "ddw", "dwp", "dbp")


def conv_block_readings(kernel_calls, twin_calls):
    """For each T-long conv block of a train step (kernel_calls and
    twin_calls from ConvBlockCalls, in forward order): its kernels'
    gradients against the backward twin on the same inputs, g and weights
    (the step's bound: each output's max error over BF16_STEP_GRAD of its
    largest entry plus BF16_STEP_ATOL of the largest of all six); and a
    direct count of the pre-ReLUs, per layer, whose sign differs between
    the kernel step and the twin step: each from its own run's layer
    inputs (the kernels' from the x and xs the tiled forward kept, the
    twins' from their replay) by one formula, conv_layer_replay; beside it
    the count between the kernels' layer inputs and the twin's replay of
    the kernels' own x (the flips the kernels' arithmetic makes on one
    input), and the largest |pre-ReLU| of a flip over the layer's
    standard deviation."""
    import torch

    from vslnet_torch.ops import kernels as K

    out = []
    for kc, tc in zip(kernel_calls, twin_calls):
        x, gam, beta, dw, wp, bp, seeds, rate = kc["args"]
        ref = K.conv_block_bwd_plain(x, gam, beta, dw, wp, bp, seeds, rate,
                                     kc["g"])
        atol = BF16_STEP_ATOL * max(float(r.abs().max()) for r in ref)
        ratios = {n: max_err(g, r) / (BF16_STEP_GRAD * float(r.abs().max())
                                      + atol)
                  for n, g, r in zip(CONV_GRADS, kc["grads"], ref)}
        worst = max(ratios, key=ratios.get)
        L = gam.shape[0]
        layer_in = [x.float()] + list(kc["xs"][:L - 1])
        pk = [K.conv_layer_replay(xl, gam[l], beta[l], dw[l], wp[l], bp[l],
                                  x.dtype)[4] for l, xl in enumerate(layer_in)]
        pt = [s[4] for s in K.conv_block_replay(*tc["args"])]
        po = [s[4] for s in K.conv_block_replay(*kc["args"])]

        def flips(a, b):
            return [int(((u > 0) != (v > 0)).sum()) for u, v in zip(a, b)]

        def near_kink(a, b):
            return [float((v.abs()[(u > 0) != (v > 0)].max() / v.std())
                          if bool(((u > 0) != (v > 0)).any()) else 0.0)
                    for u, v in zip(a, b)]

        out.append({"shape": list(x.shape), "own_inputs": {
            "worst": [ratios[worst], worst], "ratios": ratios},
            "pre_relus_a_layer": pk[0].numel(),
            "flips_vs_twin_step": flips(pk, pt),
            "flip_abs_over_std_vs_twin_step": near_kink(pk, pt),
            "flips_on_own_x": flips(pk, po),
            "input_max_abs_diff_vs_twin_step": max_err(x, tc["args"][0])})
        del ref, pk, pt, po
        torch.cuda.empty_cache()
    return out


def turns_fields(turns):
    """The device ms without copies and the launches of profiles taken at
    fp32, bf16, bf16, fp32 in turns."""
    return {"device_ms_without_copies_turns": {
        "fp32": [turns[0]["device_ms_without_copies"],
                 turns[3]["device_ms_without_copies"]],
        "bf16": [turns[1]["device_ms_without_copies"],
                 turns[2]["device_ms_without_copies"]]},
        "fp32_device_launches": turns[0]["device_launches"]}


def bf16_long_phase(dev):
    """The bf16 long-T rows, then both paths at bf16; each row's launches
    are its path's (a bf16 whole-T launch on path L or a flash one on path
    M fails the run)."""
    rows = bf16_long_kernel_rows(dev)
    runs = {path: bf16_long_path(path) for path in LONG_PATHS}
    for row in rows:
        by_run = {"%s_%s" % (p, r): c[row["name"]]
                  for p, pr in runs.items() for r, c in pr.items()}
        row["launches"] = sum(by_run.values())
        row["launches_by_run"] = by_run
        row["launches_path"] = "bf16_long " + BF16_LONG_KERNELS[row["name"]]
        for p in LONG_PATHS:
            ran = any(by_run["%s_%s" % (p, r)] for r in runs[p])
            check(ran == (p in BF16_LONG_KERNELS[row["name"]]),
                  "%s launched on path %s: %s" % (row["name"], p, by_run))
    return rows, runs


# --- phase 7 -------------------------------------------------------------------
# The reference's default run through the command line (python -m
# vslnet_torch) on a seeded miniature data root in Charades-STA's format:
# the copies of a step and of a served batch by torch.profiler; train,
# resume, test, predict and serve, each a process of its own that writes
# its kernel launches when it exits; then the shapes where a kernel does
# not fit (C5) against use_pallas=off.

CLI_DATA = {"n_train": 96, "n_test": 32, "n_videos": 48, "clips": (100, 300)}
CLI_KERNELS = ("lstm_recurrence_fwd", "lstm_recurrence_fwd_res",
               "lstm_recurrence_bwd", "conv_block_fwd", "conv_block_bwd",
               "conv_block_fwd_tiled", "conv_block_bwd_tiled",
               "mha_block_fwd", "mha_block_bwd", "cqa_concat_fwd",
               "highlight_gate_fwd", "span_decode") + tuple(
                   n + "_bf16" for n in BF16_NAMES + BF16_TRAIN_NAMES[3:]) + (
                       "flash_mha_fwd_bf16", "flash_mha_bwd_bf16")
# (the bf16 runs: train, resume and test; the flash kernels in the bf16
# run at max_pos_len 1024)
HTOD_STEP_MAX_BYTES = 1024
# modules -> the kernels that show they took the kernel route
MODULE_KERNELS = {
    "lstm": ("lstm_recurrence_fwd", "lstm_recurrence_fwd_res"),
    "conv": ("conv_block_fwd", "conv_block_fwd_tiled"),
    "mha": ("mha_block_fwd", "mha_fwd", "flash_mha_fwd"),
    "cqa": ("cqa_concat_fwd",), "highlight": ("highlight_gate_fwd",),
    "span_decode": ("span_decode",)}


def cli_args(root, work, *extra):
    """The reference's default run (`--task charades --predictor rnn`: T
    128, batch 16, hidden 128, 8 heads, 1024-d video, 300-d GloVe) on the
    data root, 2 epochs."""
    return ["--task", "charades", "--predictor", "rnn",
            "--data_root", root, "--save_dir", os.path.join(work, "datasets"),
            "--model_dir", os.path.join(work, "ckpt"), "--epochs", "2",
            "--period", "2", "--log_to_tensorboard", "false",
            "--seed", str(SEED)] + list(extra)


# runs the package as `python -m vslnet_torch` does (runpy, as __main__),
# and writes the process's kernel launch counts to argv[1] when it exits
CLI_LAUNCHER = (
    "import atexit, json, runpy, sys\n"
    "from vslnet_torch.ops import kernels\n"
    "out = sys.argv.pop(1)\n"
    "atexit.register(lambda: json.dump(kernels.LAUNCHES, open(out, 'w')))\n"
    "runpy.run_module('vslnet_torch', run_name='__main__', alter_sys=True)\n")


def cli_proc(name, args, work, launches, **kw):
    """`python -m vslnet_torch args` from the repo root, its kernel launch
    counts written to work/launches_<name>.json (read into `launches` by
    cli_launches)."""
    launches[name] = os.path.join(work, "launches_%s.json" % name)
    return [sys.executable, "-c", CLI_LAUNCHER, launches[name]] + args, dict(
        cwd=REPO_ROOT, text=True, **kw)


def cli_run(name, args, work, launches, timeout=600):
    cmd, kw = cli_proc(name, args, work, launches)
    res = subprocess.run(cmd, capture_output=True, timeout=timeout, **kw)
    check(res.returncode == 0, "python -m vslnet_torch %s failed (%d):\n%s"
          % (" ".join(args[-6:]), res.returncode, res.stderr[-4000:]))
    return res.stdout


def scores_at(text, step):
    """(R1@0.3, R1@0.5, R1@0.7, mIoU) of eval_results.txt's last block of
    `step`."""
    lines = text.splitlines()
    heads = [i for i, ln in enumerate(lines)
             if ln.startswith("Epoch") and ln.endswith("Step %d:" % step)]
    check(bool(heads), "no evaluation of step %d in eval_results.txt" % step)
    return [float(x) for x in re.findall(r": ([0-9.]+)",
                                         lines[heads[-1] + 1])]


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def serve_run(root, work, launches, requests):
    """--mode serve on a free port: wait for its `serving` line, POST the
    requests, stop it with SIGINT. Returns the replies."""
    port = free_port()
    cmd, kw = cli_proc("serve", cli_args(root, work, "--mode", "serve",
                                         "--port", str(port)), work,
                       launches, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE)
    proc = subprocess.Popen(cmd, **kw)
    try:
        line = ""
        deadline = time.time() + 300
        while '"serving"' not in line:
            check(proc.poll() is None and time.time() < deadline,
                  "the server did not start: %s" % (proc.poll(),))
            line = proc.stdout.readline()
        base = "http://127.0.0.1:%d/localize" % port
        replies = [post(base, req) for req in requests]
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            _, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
    check(proc.returncode == 0, "the server exited %d: %s"
          % (proc.returncode, err[-2000:]))
    return replies


def cli_launches(files):
    """{run: {kernel: launches}} from each process's launch file."""
    out = {}
    for name, path in files.items():
        with open(path, encoding="utf-8") as f:
            out[name] = json.load(f)
    return out


def copies_phase(root, work):
    """A step and a served batch of the CLI's configuration in this process,
    on the data root's caches (built here, then read by the CLI's runs):
    the data layout and the bytes each copies host to device, by
    torch.profiler. It runs before the CLI's processes: after other
    processes had used the card, the profiler here kept no record of some
    copies."""
    import torch

    from vslnet_torch.bench.paths import profile_device
    from vslnet_torch.cli import load_or_build_feature_bank
    from vslnet_torch.config import build_parser, namespace_to_config
    from vslnet_torch.data.datasets import gen_or_load_dataset
    from vslnet_torch.serve import Localizer
    from vslnet_torch.server import durations_from_dataset
    from vslnet_torch.train.runner import Trainer

    cfg = namespace_to_config(build_parser().parse_args(
        cli_args(root, work, "--mode", "train")))
    dataset = gen_or_load_dataset(cfg)
    cfg.char_size = dataset["n_chars"]
    bank = load_or_build_feature_bank(cfg)
    trainer = Trainer(cfg, dataset, bank)
    for _ in range(2):
        trainer.step()
    torch.cuda.synchronize()
    # three steps in one window: the profiler has once kept no record of a
    # lone step's 64-byte copy
    steps = profile_device(lambda: [trainer.step() for _ in range(3)],
                           float("nan"))
    per_step = steps["htod_bytes"] / 3
    emit({"phase": "cli_copies", "of": "train step",
          "layout": trainer.batch_layout, "htod_bytes_per_step": per_step,
          "htod_copies_3_steps": steps["htod_copies"],
          "htod_copy_ms_per_step": steps["htod_copy_ms"] / 3,
          "device_ms_per_step": steps["device_ms"] / 3,
          "max_bytes": HTOD_STEP_MAX_BYTES})
    check(trainer.batch_layout == "idxs"
          and 0 < per_step <= HTOD_STEP_MAX_BYTES,
          "a step copies %s bytes to the device (%s)" % (
              per_step, steps["htod_copies"]))
    loc = Localizer.from_trainer(trainer, dataset["word_dict"],
                                 dataset["char_dict"])
    durations = durations_from_dataset(dataset)
    triples = [(bank[r["vid"]], durations[r["vid"]], " ".join(r["words"]))
               for r in dataset["test_set"][:cfg.batch_size]]
    loc.localize_batch(triples)
    served = profile_device(lambda: loc.localize_batch(triples), float("nan"))
    kinds = served["htod_copies"]
    # three batches staged back to back, without a wait between (the third
    # refills the first's buffers), against pageable copies of the same
    chunks = [[(bank[r["vid"]], durations[r["vid"]], " ".join(r["words"]))
               for r in dataset["test_set"][i:i + 8]] for i in (0, 8, 16)]
    staged = [loc.make_batch(c)[0] for c in chunks]
    same = True
    for chunk, got in zip(chunks, staged):
        arrays = [np.zeros(shape, str(dtype)[6:])
                  for shape, dtype in loc.batch_specs()]
        loc.fill_batch(arrays, chunk)
        same &= all(torch.equal(g, torch.from_numpy(a).cuda())
                    for g, a in zip(got, arrays))
    emit({"phase": "cli_copies", "of": "served batch of 16",
          "htod_bytes": served["htod_bytes"], "htod_copies": kinds,
          "htod_copy_ms": served["htod_copy_ms"],
          "device_ms": served["device_ms"],
          "back_to_back_equal_pageable": same})
    check(bool(kinds) and all("Pinned" in k for k in kinds),
          "the served batch's copies are not from pinned memory: %s" % kinds)
    check(same, "batches staged back to back disagree with pageable copies")


def c5_phase(dataset, feats, splits):
    """The shapes where a kernel does not fit: a forward and a train step at
    hidden 512 (rnn: the LSTM beyond its 256) and at hidden 192 in 8 heads
    (head dim 24: no MHA kernel) against use_pallas=off, each module's
    route read from the launches; and the span decode at [2, 6144]."""
    import dataclasses

    import torch

    from vslnet_torch.bench.paths import train_config
    from vslnet_torch.ops import kernels as K
    from vslnet_torch.train.runner import materialize

    for hidden, heads in ((512, 8), (192, 8)):
        of = "rnn hidden %d, %d heads" % (hidden, heads)
        tk, to = trainers(lambda up: dataclasses.replace(
            train_config(dataset, up, SEED), hidden_size=hidden,
            num_heads=heads), dataset, feats)
        _, b = next(tk.test_loader.test_iter())
        b = materialize({k: torch.from_numpy(v).cuda() for k, v in b.items()},
                        tk.bank, tk.eval_splits["test"], False)
        args = (b["word_ids"], b["char_ids"], b["vfeats"], b["v_len"])
        K.reset_launches()
        with torch.no_grad():
            out_k = tk.model.eval()(*args)
            s_k = K.span_decode(out_k["start_logits"], out_k["end_logits"])
        fwd = dict(K.LAUNCHES)
        with torch.no_grad():
            out_p = to.model.eval()(*args)
        tk.model.train()
        to.model.train()
        logit_err = max(max_err(out_k[k], out_p[k]) for k in
                        ("start_logits", "end_logits", "highlight_scores"))
        same = all(torch.equal(a, c) for a, c in zip(s_k, K.span_decode_plain(
            out_p["start_logits"], out_p["end_logits"])))
        K.reset_launches()
        step_vs_off(tk, to, "C5 " + of)
        train = dict(K.LAUNCHES)

        def routes(launches):
            return {m: "kernel" if any(launches[n] for n in names) else
                    "plain" for m, names in MODULE_KERNELS.items()}

        max_w = tk.max_w
        want = {"lstm": K.lstm_kernel_fits(16, hidden),
                "conv": K.conv_kernel_fits(128, hidden, 7, 4),
                "mha": K.mha_kernel_fits(128, hidden, heads),
                "cqa": K.cqa_kernel_fits(128, max_w, hidden),
                "highlight": True, "span_decode": True}
        want = {m: "kernel" if v else "plain" for m, v in want.items()}
        emit({"phase": "c5", "of": of, "routes_forward": routes(fwd),
              "routes_train": routes(train), "expected_forward": want,
              "max_logit_err_vs_off": logit_err, "logit_atol": LOGIT_ATOL,
              "spans_equal_vs_off": same})
        check(routes(fwd) == want, "%s: routes %s, expected %s"
              % (of, routes(fwd), want))
        check(logit_err <= LOGIT_ATOL and same,
              "%s: the forward disagrees with use_pallas=off" % of)
        del tk, to
    rng = np.random.default_rng(SEED)
    sl, el = (torch.from_numpy(rng.standard_normal((2, 6144)).astype(
        np.float32)).cuda() for _ in range(2))
    K.reset_launches()
    got = K.span_decode(sl, el)
    ref = K.span_decode_plain(sl, el)
    equal = all(torch.equal(a, c) for a, c in zip(got, ref))
    emit({"phase": "c5", "of": "span decode [2, 6144]",
          "kernel_launches": K.LAUNCHES["span_decode"], "equal": equal,
          "indices": [t.tolist() for t in got]})
    check(equal and K.LAUNCHES["span_decode"] == 0,
          "the span decode at T = 6144 must take the plain version")


def cli_phase(dataset, feats, splits):
    """The `cli` phase; returns the CLI runs' summed kernel launches."""
    from vslnet_torch.bench.data_root import write_charades_root

    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "data")
        durations = write_charades_root(
            root, CLI_DATA["n_train"], CLI_DATA["n_test"],
            CLI_DATA["n_videos"], 1024, CLI_DATA["clips"], SEED,
            extra_vids=("VID_EXTRA",))
        copies_phase(root, work)
        files = {}
        t0 = time.perf_counter()
        cli_run("train", cli_args(root, work, "--mode", "train"),
                            work, files)
        out_resume = cli_run("resume", cli_args(
            root, work, "--mode", "train", "--resume", "true", "--epochs",
            "3"), work, files)
        model_dir = os.path.join(work, "ckpt", "vslnet_charades_new_128_rnn",
                                 "model")
        results = open(os.path.join(model_dir, "eval_results.txt")).read()
        ckpts = sorted(int(f[11:-3]) for f in os.listdir(model_dir)
                       if f.startswith("checkpoint_"))
        m = re.search(r"resumed from step (\d+)", out_resume)
        steps = [int(x) for x in re.findall(r"Step +(\d+) \| loss",
                                            out_resume)]
        last = 3 * -(-CLI_DATA["n_train"] // 16)  # 3 epochs of batch 16
        check(bool(m) and bool(ckpts) and steps and steps[-1] == last,
              "resume: %s, checkpoints %s, steps %s" % (m, ckpts, steps))
        out_test = cli_run("test", cli_args(root, work, "--mode", "test"),
                           work, files)
        test = [float(x) for x in re.findall(r":\t([0-9.]+)", out_test)]
        best = scores_at(results, ckpts[-1])
        check(test == best, "--mode test gave %s, the restored checkpoint's "
              "evaluation %s" % (test, best))
        # the same model directory tested at bf16: configs.json reloaded,
        # --precision applied over it, the fp32 checkpoint served at bf16
        out_test16 = cli_run("test_bf16", cli_args(
            root, work, "--mode", "test", "--precision", "bf16"), work, files)
        test16 = [float(x) for x in re.findall(r":\t([0-9.]+)", out_test16)]
        check(len(test16) == 4 and all(0.0 <= v <= 100.0 for v in test16),
              "--mode test --precision bf16 gave %s" % test16)
        # bf16 training in a model directory of its own: an epoch, a resume
        # to the second, then the test of its best checkpoint at bf16
        bf16_dir = ["--model_dir", os.path.join(work, "ckpt_bf16"),
                    "--precision", "bf16"]
        cli_run("train_bf16", cli_args(root, work, "--mode", "train",
                                       "--epochs", "1", *bf16_dir),
                work, files)
        out_resume16 = cli_run("resume_bf16", cli_args(
            root, work, "--mode", "train", "--resume", "true", "--epochs",
            "2", *bf16_dir), work, files)
        dir16 = os.path.join(work, "ckpt_bf16", "vslnet_charades_new_128_rnn",
                             "model")
        saved16 = json.load(open(os.path.join(dir16, "configs.json")))
        ckpts16 = sorted(int(f[11:-3]) for f in os.listdir(dir16)
                         if f.startswith("checkpoint_"))
        m16 = re.search(r"resumed from step (\d+)", out_resume16)
        steps16 = [int(x) for x in re.findall(r"Step +(\d+) \| loss",
                                              out_resume16)]
        losses16 = [float(x) for x in re.findall(r"\| loss ([0-9.eE+-]+)",
                                                 out_resume16)]
        check(saved16["precision"] == "bf16" and bool(m16) and bool(ckpts16)
              and steps16 and steps16[-1] == last * 2 // 3
              and bool(np.isfinite(losses16).all()),
              "bf16 resume: configs %s, %s, checkpoints %s, steps %s, "
              "losses %s" % (saved16.get("precision"), m16, ckpts16, steps16,
                             losses16))
        out_train16_test = cli_run("test_bf16_trained", cli_args(
            root, work, "--mode", "test", *bf16_dir), work, files)
        # bf16 above T = 145: the JAX bench's long_context row (transformer
        # predictor, max_pos_len 1024) trained for an epoch at bf16 in a
        # model directory of its own, then its test
        long_dir = ["--model_dir", os.path.join(work, "ckpt_long"),
                    "--precision", "bf16", "--predictor", "transformer",
                    "--max_pos_len", "1024"]
        cli_run("train_bf16_long", cli_args(root, work, "--mode", "train",
                                            "--epochs", "1", *long_dir),
                work, files)
        out_long = cli_run("test_bf16_long", cli_args(
            root, work, "--mode", "test", *long_dir), work, files)
        test_long = [float(x) for x in re.findall(r":\t([0-9.]+)", out_long)]
        check(len(test_long) == 4 and all(0.0 <= v <= 100.0
                                          for v in test_long),
              "--mode test at bf16, max_pos_len 1024 gave %s" % test_long)
        test16_trained = [float(x) for x in re.findall(
            r":\t([0-9.]+)", out_train16_test)]
        best16 = scores_at(open(os.path.join(dir16, "eval_results.txt"))
                           .read(), ckpts16[-1])
        check(test16_trained == best16, "--mode test at bf16 gave %s, the "
              "restored bf16 checkpoint's evaluation %s"
              % (test16_trained, best16))
        queries = os.path.join(work, "queries.jsonl")
        vids = sorted(durations)[:20]
        with open(queries, "w") as f:
            for i, v in enumerate(vids):
                f.write(json.dumps({"vid": v, "query": "a person opens the "
                                    "door" if i % 2 else "someone sits on "
                                    "the couch"}) + "\n")
        preds = os.path.join(work, "predictions.jsonl")
        cli_run("predict", cli_args(root, work, "--mode", "predict",
                                    "--queries_file", queries,
                                    "--predictions_out", preds), work, files)
        lines = [json.loads(ln) for ln in open(preds)]
        check(len(lines) == len(vids) and all(
            0.0 <= p["start"] <= p["end"] <= durations[p["vid"]] + 1e-3
            for p in lines), "predict: %s" % lines[:3])
        requests = [{"vid": vids[0], "query": "a person opens the door"},
                    [{"vid": v, "query": "someone closes the book"}
                     for v in vids[:18]],
                    {"vid": "VID_EXTRA", "query": "someone laughs",
                     "duration": 33.0, "top_k": 3}]
        replies = serve_run(root, work, files, requests)
        check(len(replies[1]) == len(requests[1])
              and len(replies[2]["spans"]) == 3,
              "serve: %s" % replies[2])
        runs = cli_launches(files)
        cli_s = time.perf_counter() - t0
    total = {name: sum(r[name] for r in runs.values()) for name in runs["train"]}
    emit({"phase": "cli", "seconds": cli_s, "data": dict(
        CLI_DATA, records=CLI_DATA["n_train"] + CLI_DATA["n_test"]),
        "resumed_from": int(m.group(1)), "checkpoints": ckpts,
        "test": test, "test_bf16": test16,
        "bf16_trained": {"resumed_from": int(m16.group(1)),
                         "checkpoints": ckpts16, "losses": losses16,
                         "test": dict(zip(("R1@0.3", "R1@0.5", "R1@0.7",
                                           "mIoU"), test16_trained))},
        "test_bf16_long": test_long,
        "predictions": len(lines),
        "http_200": len(replies),
        "launches": runs})
    for name in total:
        check((total[name] > 0) == (name in CLI_KERNELS),
              "cli: %s launched %d times" % (name, total[name]))
    for name in BF16_NAMES:  # the bf16 run took the bf16 kernels only
        check(runs["test_bf16"][name + "_bf16"] > 0
              and runs["test_bf16"][name] == 0,
              "cli: the bf16 test run launched %s" % runs["test_bf16"])
    for run in ("train_bf16", "resume_bf16"):  # and so did bf16 training
        check(all(runs[run][n + "_bf16"] > 0 and runs[run][n] == 0
                  for n in BF16_TRAIN_NAMES),
              "cli: the %s run launched %s" % (run, runs[run]))
    for run in ("train_bf16_long", "test_bf16_long"):  # the flash kernels
        want = ("flash_mha_fwd", "flash_mha_bwd") if "train" in run else (
            "flash_mha_fwd",)
        check(all(runs[run][n + "_bf16"] > 0 and runs[run][n] == 0
                  for n in want + ("conv_block_fwd_tiled",))
              and runs[run]["mha_fwd_bf16"] == 0,
              "cli: the %s run launched %s" % (run, runs[run]))
    c5_phase(dataset, feats, splits)
    return total


# --- phase 8 ---------------------------------------------------------------------
# The JAX bench's `saturated` configuration (bench.py bench_saturated): the
# transformer predictor at hidden 1024 in 8 heads of 128, batch 256, T 128,
# bf16, where the JAX package takes its fused conv and MHA block kernels
# and the port its wide kernels (#2c, #9c at D = 1024; #3b, #10b at head
# dim 128).

SATURATED_KERNELS = ("conv_block_fwd_wide_bf16", "conv_block_bwd_wide_bf16",
                     "mha_block_fwd_wide_bf16", "mha_block_bwd_wide_bf16")
# a module's kernels on the saturated path, by the launches they count
SATURATED_MODULES = {"conv": ("conv_block_fwd_wide_bf16",),
                     "mha": ("mha_block_fwd_wide_bf16",),
                     "cqa": ("cqa_concat_fwd",),
                     "highlight": ("highlight_gate_fwd",),
                     "span_decode": ("span_decode",)}
SATURATED_TRAIN_MODULES = {"conv": ("conv_block_fwd_wide_bf16",
                                    "conv_block_bwd_wide_bf16"),
                           "mha": ("mha_block_fwd_wide_bf16",
                                   "mha_block_bwd_wide_bf16")}
SATURATED_STEPS = 3
# the served batch at `saturated` against the twins' composition: at hidden
# 1024 the bf16 flips of sums in other orders (2.9-3.5% of each wide
# block's bf16 outputs, one ulp each) carry through the model's eight
# blocks to 0.137 at most, mean 0.0035, over logits of ~2.5, above
# BF16_MODEL_TOL's 0.05 set at hidden 128; the fp32 function, the
# impostor, reads 0.35, mean 0.011 (one H100 80GB HBM3 at 700 W). Held: the largest
# and the mean error each within this share of the fp32 model's
SATURATED_TWINS_SHARE = 0.5


def sdpa_bwd_yardstick(dev, B, T, heads, D):
    """F.scaled_dot_product_attention's backward in bf16 at [B, heads, T, D
    / heads], no mask, drop 0: the library yardstick of #10b wide's
    attention part (ms by CUDA events, device ms by torch.profiler). The
    port never calls it."""
    import torch
    import torch.nn.functional as F

    from vslnet_torch.bench.common import by_kernel

    q, k, v = (torch.randn(B, heads, T, D // heads, device=dev,
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    out = F.scaled_dot_product_attention(q, k, v)
    g = torch.randn_like(out)

    def bwd():
        torch.autograd.grad(out, (q, k, v), g, retain_graph=True)

    return {"shape": [B, heads, T, D // heads], "ms": cuda_ms(bwd, 20),
            "device_ms": sum(by_kernel(bwd).values())}


def sdpa_fwd_yardstick(dev, B, T, heads, D):
    """F.scaled_dot_product_attention in bf16 at [B, heads, T, D / heads],
    no mask, drop 0: the library yardstick of #3b wide's attention part
    (ms by CUDA events, device ms by torch.profiler). The port never calls
    it."""
    import torch
    import torch.nn.functional as F

    from vslnet_torch.bench.common import by_kernel

    q, k, v = (torch.randn(B, heads, T, D // heads, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v)

    return {"shape": [B, heads, T, D // heads], "ms": cuda_ms(fwd, 20),
            "device_ms": sum(by_kernel(fwd).values())}


# the wide forwards' kernels by name (torch.profiler): each forward's own,
# and the ones they replace, which must not launch at `saturated`
SATURATED_FWD_KERNELS = {"conv_block_fwd_wide_bf16": "conv_wide_d_kernel",
                         "mha_block_fwd_wide_bf16": "attn_fwd_wide_kernel"}
SATURATED_GONE_KERNELS = ("conv_wide_prologue_kernel", "attn_fwd_tile_kernel",
                          "tc_gemm_kernel", "wgrad_tc_partial_kernel")
# every product of the wide kernels runs on this kernel (csrc/mma.cuh
# tc_gemm, wgrad_wg); its launches a call of each wide kernel (L = 4
# layers of the conv blocks)
SATURATED_GEMM_KERNEL = "wg_gemm_kernel"
SATURATED_GEMM_LAUNCHES = {
    "tc_gemm_bf16": {"conv_block_fwd_wide_bf16": 4, "conv_block_bwd_wide_bf16": 4,
                     "mha_block_fwd_wide_bf16": 2, "mha_block_bwd_wide_bf16": 2},
    "wgrad_bf16": {"conv_block_bwd_wide_bf16": 1, "mha_block_bwd_wide_bf16": 2}}


def saturated_kernel_rows(dev, max_w):
    """The four wide kernels at `saturated`'s shapes against their bf16
    twins: the forwards by BF16_TOL and the share of differing bf16
    outputs (the fp32 function the control), equal bits twice; the
    backwards by bench/bf16_vjp.py's readings and controls (drop 0 and
    0.2); each timed by CUDA events and torch.profiler beside its twin,
    with its bound at the bf16 peak; the query stream's [B, max_w, D] as a
    case of each."""
    import torch

    from vslnet_torch.bench import bf16_vjp as V
    from vslnet_torch.bench.common import kernel_counts
    from vslnet_torch.ops import kernels as K

    bf = torch.bfloat16
    rng = np.random.default_rng(SEED + 17)
    B, T, D, L, KS, heads = 256, 128, 1024, 4, 7, 8
    rows = []

    def conv_fwd_work(T_):
        return ({"bf16": 2 * L * B * T_ * D * (D + KS)},
                2 * 2 * B * T_ * D + 4 * (L - 1) * B * T_ * D
                + L * B * T_ * D // 4 + 4 * L * (D * D + (KS + 3) * D))

    def conv_bwd_work(T_):
        return ({"bf16": 2 * L * B * T_ * D * (2 * D + 3 * KS)},
                3 * 2 * B * T_ * D + 4 * (L - 1) * B * T_ * D
                + L * B * T_ * D // 4 + 2 * 4 * L * (D * D + (KS + 3) * D))

    def mha_fwd_work(T_, keys):  # qkv written in bf16, att in fp32
        return ({"bf16": 8 * B * T_ * D * D + 4 * keys * D},
                2 * 2 * B * T_ * D + (2 * 3 + 4) * B * T_ * D + 4 * B * T_
                + 4 * (4 * D * D + 8 * D))

    def mha_bwd_work(T_, keys):  # qkv read in bf16, att in fp32
        return ({"bf16": 16 * B * T_ * D * D + 10 * keys * D},
                3 * 2 * B * T_ * D + 2 * 3 * B * T_ * D
                + 4 * (B * T_ * D + B * T_) + 2 * 4 * (4 * D * D + 8 * D))

    def attn_fwd_work(T_, keys):  # qkv read in bf16, att written in fp32
        return {"bf16": 4 * keys * D}, 2 * 3 * B * T_ * D + 4 * B * T_ * D + 4 * B * T_

    def prologue_work(T_):  # x_l read (bf16, then fp32), d written in bf16
        return ({"bf16": 2 * L * B * T_ * D * (KS + 4)},
                (2 + 4 * (L - 1) + 2 * L) * B * T_ * D + 4 * L * (KS + 2) * D)

    # 1. #2c wide: the video stream's [B, T, D], plain draws, drop 0.2
    checks = {}
    for T_ in (T, max_w):
        # plain draws (pre-ReLUs on both sides of the kink, near it too:
        # a flip moves the forward's output by one ulp of the term)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        args = [t(rng.standard_normal((B, T_, D))).to(bf),
                t(1 + 0.1 * rng.standard_normal((L, D))),
                t(0.1 * rng.standard_normal((L, D))),
                t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                t(rng.standard_normal((L, D, D)) / math.sqrt(D)),
                t(0.1 * rng.standard_normal((L, D)))]
        seeds = t(rng.integers(0, 1 << 23, (B, 1)))
        got = K.launch_conv_block_fwd_wide(*args, seeds, DROP)
        again = K.launch_conv_block_fwd_wide(*args, seeds, DROP)
        twice = all(torch.equal(a, b) for a, b in zip(got, again))
        ref = K.conv_block_plain(*args, seeds, DROP)
        ref32 = K.conv_block_plain(args[0].float(), *args[1:], seeds, DROP)
        check(twice, "conv_block_fwd_wide_bf16: two equal calls differ")
        checks[T_] = (args, seeds, got, ref, ref32, twice)
    args, seeds, got, ref, ref32, twice = checks[T]
    share = bf16_function_check(
        "conv_block_fwd_wide_bf16", "share_differing",
        share_differing(got[0], ref), share_differing(ref32.to(bf), ref),
        BF16_SHARE_TOL)
    q = checks[max_w]
    bf16_timed_row(
        rows, "conv_block_fwd_wide_bf16", "conv_block.cu", 1019,
        scaled_err(got[0], ref), BF16_TOL,
        lambda: K.launch_conv_block_fwd_wide(*args, seeds, DROP),
        lambda: K.conv_block_plain(*args, seeds, DROP), *conv_fwd_work(T),
        shape=[B, T, D], equal_bits_twice=twice,
        plan=K.conv_wide_plan(B, T, D, KS, L)._asdict(),
        parts_named={"prologue_device_ms": "conv_wide_d_kernel"},
        prologue_bound_ms=bound(*prologue_work(T))[0],
        route_serve=K.conv_route(T, D, KS, L, False, bf),
        route_train=K.conv_route(T, D, KS, L, True, bf),
        query_case={"shape": [B, max_w, D],
                    "scaled_err": scaled_err(q[2][0], q[3]),
                    "share_differing": share_differing(q[2][0], q[3]),
                    "equal_bits_twice": q[5]}, **share)
    check(scaled_err(q[2][0], q[3]) <= BF16_TOL
          and share_differing(q[2][0], q[3]) <= BF16_SHARE_TOL,
          "conv_block_fwd_wide_bf16 at [%d, %d, %d] disagrees with its twin"
          % (B, max_w, D))
    saturated_fwd_names(rows[-1])
    del checks, args, got, ref, ref32, q

    # 2. #9c wide: bf16_vjp's cases at [B, T, D] (drop 0.2 and 0) and the
    # query stream's [B, max_w, D]
    cases = [V.conv_case(dev, rng, B, T_, D, rate, wide=True)
             for T_, rate in ((T, DROP), (T, 0.0), (max_w, DROP))]
    bf16_vjp_row(rows, "conv_block_bwd_wide_bf16", "conv_block.cu", 1039,
                 cases, *conv_bwd_work(T), shape=[B, T, D], query_T=max_w,
                 plan=K.conv_wide_plan(B, T, D, KS, L)._asdict(),
                 kernel_launches=kernel_counts(cases[0].kernel, 10))
    # its per-frame work: one d launch for every layer and a pass a layer
    # (after the earlier phases' processes torch.profiler drops some
    # records: a count can read low, never high)
    passes = {k: n for k, n in rows[-1]["kernel_launches"].items()
              if "conv_wide_" in k}
    kinds = {k.split("::")[-1].split("<")[0] for k in passes}
    check("conv_wide_pass_kernel" in kinds
          and kinds <= {"conv_wide_d_kernel", "conv_wide_pass_kernel"}
          and sum(passes.values()) <= L + 1,
          "conv_block_bwd_wide_bf16: per-frame launches %s, expected the d "
          "launch and %d passes" % (passes, L))
    del cases

    # 3. #3b wide: [B, T, D] in 8 heads of 128, ragged key masks with one
    # row fully masked, drop 0.2; the query stream's T as a case
    def mha_args(T_):
        lens = np.concatenate([rng.integers(1, T_ + 1, B - 1), [0]])
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        x = t(rng.standard_normal((B, T_, D))).to(bf)
        mask = t(np.arange(T_)[None, :] < lens[:, None])
        w = [t(1 + 0.1 * rng.standard_normal((2, D))),
             t(0.1 * rng.standard_normal((2, D))),
             t(rng.standard_normal((D, 3 * D)) / math.sqrt(D)),
             t(0.1 * rng.standard_normal(3 * D)),
             t(rng.standard_normal((D, D)) / math.sqrt(D)),
             t(0.1 * rng.standard_normal(D))]
        seeds = t(rng.integers(0, 1 << 23, (B, 1)))
        return (x, mask, *w), seeds, int(T_ * lens.sum())

    results = {}
    for T_ in (T, max_w):
        a, seeds, keys = mha_args(T_)
        got = K.launch_mha_block_fwd(*a, heads, seeds, DROP)
        again = K.launch_mha_block_fwd(*a, heads, seeds, DROP)
        twice = all(torch.equal(x_, y_) for x_, y_ in zip(got, again))
        ref = K.mha_block_plain(*a, heads, seeds, DROP)
        ref32 = K.mha_block_plain(a[0].float(), *a[1:], heads, seeds, DROP)
        check(twice, "mha_block_fwd_wide_bf16: two equal calls differ")
        results[T_] = (a, seeds, keys, got[0], ref, ref32, twice)
    a, seeds, keys, out, ref, ref32, twice = results[T]
    share = bf16_function_check(
        "mha_block_fwd_wide_bf16", "share_differing",
        share_differing(out, ref), share_differing(ref32.to(bf), ref),
        BF16_SHARE_TOL)
    q = results[max_w]
    check(scaled_err(q[3], q[4]) <= BF16_TOL
          and share_differing(q[3], q[4]) <= BF16_SHARE_TOL,
          "mha_block_fwd_wide_bf16 at [%d, %d, %d] disagrees with its twin"
          % (B, max_w, D))
    # its attention against the twin on the kernel's own qkv (and fp64),
    # drop 0.2 and 0, the impostors refused; SDPA's bf16 forward the
    # attention part's library time
    att_rng = np.random.default_rng(SEED + 19)
    att_cases = [V.attention_fwd_case(dev, att_rng, B, T, D, heads, rate)
                 for rate in (DROP, 0.0)]
    att_readings = []
    for case in att_cases:
        r = V.attention_fwd_read(case)
        for fp64 in (False, True):
            ok, why = V.attention_fwd_verdict(r, fp64)
            check(ok, why)
        att_readings.append({"shape": list(case.shape), "rate": case.rate,
                             **r})
    del att_cases
    sdpa = sdpa_fwd_yardstick(dev, B, T, heads, D)
    bf16_timed_row(
        rows, "mha_block_fwd_wide_bf16", "mha_block.cu", 1736,
        scaled_err(out, ref), BF16_TOL,
        lambda: K.launch_mha_block_fwd(*a, heads, seeds, DROP),
        lambda: K.mha_block_plain(*a, heads, seeds, DROP),
        *mha_fwd_work(T, keys), shape=[B, T, D], heads=heads,
        equal_bits_twice=twice, plan=K.mha_wide_plan(B, T, D, heads)._asdict(),
        parts_named={"attention_device_ms": "attn_fwd_wide_kernel"},
        attention_bound_ms=bound(*attn_fwd_work(T, keys))[0],
        attention_cases=att_readings, library_ms=sdpa["ms"],
        library_device_ms=sdpa["device_ms"],
        library="SDPA in bf16, forward, at %s, drop 0 (the attention part)"
        % sdpa["shape"],
        route=K.mha_route(T, D, heads, bf),
        query_case={"shape": [B, max_w, D],
                    "scaled_err": scaled_err(q[3], q[4]),
                    "share_differing": share_differing(q[3], q[4]),
                    "equal_bits_twice": q[6]}, **share)
    saturated_fwd_names(rows[-1])
    del results, a, out, ref, ref32, q

    # 4. #10b wide: bf16_vjp's cases at [B, T, D] (drop 0.2 and 0) and the
    # query stream's T
    cases = [V.mha_case(dev, rng, B, T_, D, heads, rate)
             for T_, rate in ((T, DROP), (T, 0.0), (max_w, DROP))]
    mask = cases[0].args[1]
    keys = int(T * mask.sum())
    bf16_vjp_row(rows, "mha_block_bwd_wide_bf16", "mha_block.cu", 1762,
                 cases, *mha_bwd_work(T, keys), fp64=K.mha_block_bwd_plain,
                 shape=[B, T, D], heads=heads, query_T=max_w,
                 plan=K.mha_wide_plan(B, T, D, heads)._asdict(),
                 attention_library=sdpa_bwd_yardstick(dev, B, T, heads, D),
                 kernel_launches=kernel_counts(cases[0].kernel, 10))
    # its attention: the tensor-core kernel, no cluster kernel at head dim 128
    names = list(rows[-1]["kernel_launches"])
    check(any("attn_bwd_wide_kernel" in k for k in names)
          and not any("attn_bwd_cluster_kernel" in k for k in names),
          "mha_block_bwd_wide_bf16: attention kernels %s" % names)
    del cases
    torch.cuda.empty_cache()
    return rows


def gemm_kernel_rows(dev):
    """The wide kernels' two products alone at `saturated`'s shapes
    (bench/gemm_plans.py): tc_gemm as #9c wide's g_d ([B T, D] . bf16(wp)^T,
    fp32 store) and wgrad_wg as its dwp (Z = L = 4, K = B T) against their
    plain versions (TOL of scaled_err: fp32 sums of the same exact
    products), equal bits twice, each no further from the fp64 product than
    gemm_plans.FP64_FACTOR times the mma.sync form's distance; timed by
    events and torch.profiler beside cuBLAS's bf16 product of the same
    operands by events (library_ms; the port never calls it), after both
    kernels (a profile taken right after cuBLAS's has come back with no
    record of the next call, and cuBLAS's own profile has come back empty
    or below the bound, so it is not read)."""
    import torch

    from vslnet_torch.bench import gemm_plans as G
    from vslnet_torch.ops import kernels as K

    rng = np.random.default_rng(SEED + 20)
    M, D, L = 256 * 128, 1024, 4
    rows, library = [], []
    lib = G.mma_library()
    a, b = G.operands(dev, rng, (M, D), (D, D))
    wa, wb = G.operands(dev, rng, (L, M, D), (L, M, D))
    S = K.wgrad_splits(L, D, D, M)
    products = [
        ("tc_gemm_bf16", 1092, lambda: K.launch_tc_gemm_bf16(a, b, True),
         lambda: K.tc_gemm_plain(a, b, True), lambda: torch.matmul(a, b.t()),
         lambda c: G.fp64_reading(c, a, b, True),
         lambda: G.mma_product(lib, a, b, True), {"bf16": 2 * M * D * D},
         2 * M * D + 2 * D * D + 4 * M * D, {"shape": [M, D, D], "bt": True}),
        ("wgrad_bf16", 1089, lambda: K.launch_wgrad_bf16(wa, wb, S),
         lambda: K.wgrad_plain(wa, wb), lambda: torch.matmul(wa.transpose(1, 2), wb),
         lambda c: G.fp64_reading(c, wa, wb, batched=True),
         lambda: G.mma_wgrad(lib, wa, wb, K._wgrad_splits(L, D, D, M)),
         {"bf16": 2 * L * M * D * D}, 2 * 2 * L * M * D + 4 * L * D * D,
         {"shape": [L, M, D, D], "splits": S})]
    for name, line, fn, plain, cublas, reading, mma, work, nbytes, extra in products:
        got, again = fn(), fn()
        fp64 = {"kernel": reading(got), "mma_sync_form": reading(mma())}
        ok, why = G.fp64_verdict(fp64["kernel"], fp64["mma_sync_form"])
        check(ok, "%s: %s" % (name, why))
        check(torch.equal(got, again), "%s: two equal calls differ" % name)
        bf16_timed_row(rows, name, "mma.cuh", line, scaled_err(got, plain()), TOL,
                       fn, plain, work, nbytes, fp64=fp64, equal_bits_twice=True,
                       library="torch.matmul of the bf16 operands, bf16 out (cuBLAS)",
                       **extra)
        library.append(cublas)
        del got, again
    for row, cublas in zip(rows, library):
        row["library_ms"] = cuda_ms(cublas, 20)
        names = list(row["by_kernel"])
        check(any(SATURATED_GEMM_KERNEL in k for k in names)
              and not any(g in k for k in names for g in SATURATED_GONE_KERNELS),
              "%s: kernels %s" % (row["name"], names))
    del a, b, wa, wb
    torch.cuda.empty_cache()
    return rows


def saturated_fwd_names(row):
    """A wide forward's row ran on its own per-frame or attention kernel
    (by name: a whole run's profiler may drop records, §7 of PERF.md) and
    not on the kernels it replaced."""
    names = list(row["by_kernel"])
    check(any(SATURATED_FWD_KERNELS[row["name"]] in k for k in names)
          and not any(g in k for k in names for g in SATURATED_GONE_KERNELS),
          "%s: kernels %s" % (row["name"], names))


def saturated_path():
    """The `saturated` configuration through its entry points, its weights
    seeded in the flax layout, bench.py's dataset: a served batch of 256
    (Localizer.localize_batch) against the twins' composition on the card
    (held to BF16_MODEL_TOL["twins"]), use_pallas=off at bf16 (held to
    BF16_MODEL_TOL["off"]; spans reported) and the fp32 model (the
    control); SATURATED_STEPS train steps at drop 0.2 with the kernels and
    with use_pallas=off from the same weights, batches and seeds: the first
    step's loss and gradients against the twins' composition
    (BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD) and against use_pallas=off
    (BF16_STEP_OFF, as the bf16_train phase holds it), every step's loss
    against use_pallas=off within BF16_STEP_LOSS_RTOL;
    every module's route read from the launches, serving and training; a
    served batch and a step profiled with the kernels and with
    use_pallas=off.
    Returns {run: launches}."""
    import torch

    from vslnet_torch.bench.paths import (build_localizer, profile_device,
                                          saturated_config, saturated_data,
                                          saturated_requests, wall_ms)
    from vslnet_torch.ops import kernels as K
    from vslnet_torch.train.runner import Trainer

    dataset, feats = saturated_data(SEED)
    splits = [dataset["train_set"], dataset["test_set"]]

    def configs(use_pallas, precision="bf16"):
        return saturated_config(dataset, use_pallas, SEED, precision)

    cfg = configs("auto")
    B, T, D, heads = (cfg.batch_size, cfg.max_pos_len, cfg.hidden_size,
                      cfg.num_heads)
    loc = build_localizer(cfg, dataset, splits, SEED)
    loc_off = build_localizer(configs("off"), dataset, splits, SEED)
    check(loc.model.dtype == torch.bfloat16 and loc.use_kernels
          and not loc_off.use_kernels, "a bf16 model with and without kernels")
    triples = saturated_requests(dataset, feats, B)
    loc.localize_batch(triples)  # warm-up
    torch.cuda.synchronize()
    K.reset_launches()
    spans = loc.localize_batch(triples)
    torch.cuda.synchronize()
    runs = {"serve": dict(K.LAUNCHES)}
    spans_off = loc_off.localize_batch(triples)
    batch, _ = loc.make_batch(triples)
    with torch.inference_mode():
        out = loc.model(*batch)
        K.reset_launches()
        with TwinsOnTheCard():
            refs = {"twins": loc.model(*batch)}
        check(not any(K.LAUNCHES.values()), "the twins launched a kernel")
        refs["off"] = loc_off.model(*batch)
    loc32 = build_localizer(configs("auto", "fp32"), dataset, splits, SEED)
    with torch.inference_mode():
        refs["fp32"] = loc32.model(*batch)
    del loc32
    valid = out["v_mask"].bool()
    errs = {name: model_err(out, ref, valid) for name, ref in refs.items()}
    control = model_err(refs["fp32"], refs["twins"], valid)
    keys = ("start_logits", "end_logits", "highlight_scores")

    def mean_err(a, b):
        return max(float((a[k].double() - b[k].double()).abs()[valid].mean())
                   for k in keys)

    mean_errs = {name: mean_err(out, ref) for name, ref in refs.items()}
    mean_control = mean_err(refs["fp32"], refs["twins"])
    scale = {k: float(refs["twins"][k].double().abs()[valid].max())
             for k in keys}
    finite = all(bool(torch.isfinite(out[k][valid]).all()) for k in keys)
    recs = [dataset["test_set"][i % len(dataset["test_set"])]
            for i in range(B)]
    in_range = all(0.0 <= a <= b <= r["duration"] + 1e-3
                   for (a, b), r in zip(spans, recs))
    spans_equal = float(np.mean([s == o for s, o in zip(spans, spans_off)]))
    max_w = loc.max_w

    def routes(launches, modules):
        return {m: "kernel" if any(launches[n] for n in names) else "plain"
                for m, names in modules.items()}

    want = {"conv": K.conv_kernel_fits(T, D, 7, 4, False, torch.bfloat16)
            and K.conv_kernel_fits(max_w, D, 7, 4, False, torch.bfloat16),
            "mha": K.mha_kernel_fits(T, D, heads, torch.bfloat16)
            and K.mha_kernel_fits(max_w, D, heads, torch.bfloat16),
            "cqa": K.cqa_kernel_fits(T, max_w, D), "highlight": True,
            "span_decode": True}
    want = {m: "kernel" if v else "plain" for m, v in want.items()}
    emit({"phase": "saturated_serve", "B": B, "T": T, "hidden": D,
          "heads": heads, "max_w": max_w, "launches": runs["serve"],
          "routes": routes(runs["serve"], SATURATED_MODULES),
          "expected_routes": want, "max_err": errs, "tol": BF16_MODEL_TOL,
          "fp32_model_err_vs_twins": control, "mean_err": mean_errs,
          "fp32_model_mean_err_vs_twins": mean_control, "scale": scale,
          "finite": finite,
          "spans_in_range": in_range, "spans_equal_vs_off": spans_equal,
          "batch_ms_kernels": wall_ms(lambda: loc.localize_batch(triples)),
          "batch_ms_off": wall_ms(lambda: loc_off.localize_batch(triples))})
    check(routes(runs["serve"], SATURATED_MODULES) == want
          and want["conv"] == want["mha"] == "kernel",
          "saturated: served routes %s, expected %s"
          % (routes(runs["serve"], SATURATED_MODULES), want))
    check(finite and in_range and errs["off"] <= BF16_MODEL_TOL["off"]
          and errs["twins"] <= SATURATED_TWINS_SHARE * control
          and mean_errs["twins"] <= SATURATED_TWINS_SHARE * mean_control,
          "saturated: the served batch disagrees: %s, mean %s; the fp32 "
          "model's %g, mean %g" % (errs, mean_errs, control, mean_control))
    ms = wall_ms(lambda: loc.localize_batch(triples))
    ms_off = wall_ms(lambda: loc_off.localize_batch(triples))
    turns = [profile_device(lambda lo=lo: lo.localize_batch(triples), m)
             for lo, m in ((loc_off, ms_off), (loc, ms), (loc, ms),
                           (loc_off, ms_off))]
    emit({"phase": "profile", "of": "saturated served batch of %d at bf16, "
          "use_pallas=off in the fp32 turns" % B, **turns_fields(turns),
          **turns[1]})
    check_gone(turns, "the served batch")
    profiled = {"served_batch": gemm_launches(turns)}
    del loc, loc_off, out, refs, batch

    tk, to = trainers(configs, dataset, feats)
    tt = Trainer(configs("auto"), dataset, feats)
    K.reset_launches()
    losses_k, times_k = timed_steps(tk, 1)
    grads_k = {n: p.grad.clone() for n, p in tk.model.named_parameters()}
    more_k, more_times_k = timed_steps(tk, SATURATED_STEPS - 1)
    runs["train"] = dict(K.LAUNCHES)
    losses_k, times_k = losses_k + more_k, times_k + more_times_k
    losses_o, times_o = timed_steps(to, 1)
    grads_o = {n: p.grad.clone() for n, p in to.model.named_parameters()}
    more_o, more_times_o = timed_steps(to, SATURATED_STEPS - 1)
    losses_o, times_o = losses_o + more_o, times_o + more_times_o
    K.reset_launches()
    with TwinsOnTheCard(train=True):
        loss_t, _ = tt.step()
    check(not any(K.LAUNCHES.values()), "the twins launched a kernel")
    # the first step's gradients (the same weights, batch and seeds) against
    # the twins' composition and against use_pallas=off
    for n, p in tk.model.named_parameters():
        p.grad = grads_k[n]
    errs = {"twins": step_grads_against(
                tk, {n: p.grad for n, p in tt.model.named_parameters()},
                BF16_STEP_GRAD),
            "off": step_grads_against(tk, grads_o, BF16_STEP_OFF)}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_o)]
    rel_twins = abs(losses_k[0] - float(loss_t)) / abs(float(loss_t))
    train_routes = routes(runs["train"], SATURATED_TRAIN_MODULES)
    emit({"phase": "saturated_train", "steps": SATURATED_STEPS,
          "drop_rate": tk.configs.drop_rate, "losses_kernels": losses_k,
          "losses_off": losses_o, "loss_rel_err_vs_off": rel,
          "loss_twins": float(loss_t), "loss_rel_err_vs_twins": rel_twins,
          "loss_rtol": BF16_STEP_LOSS_RTOL,
          "grad_tol": {"twins": BF16_STEP_GRAD, "off": BF16_STEP_OFF},
          "grad_atol_of_largest": BF16_STEP_ATOL, "grads_first_step": errs,
          "launches": runs["train"], "routes": train_routes,
          "step_ms_kernels": times_k, "step_ms_off": times_o})
    check(all(train_routes[m] == "kernel" for m in train_routes)
          and all(runs["train"][n] for n in SATURATED_KERNELS),
          "saturated: training routes %s, launches %s"
          % (train_routes, runs["train"]))
    check(bool(np.isfinite(losses_k).all()) and rel_twins <= BF16_STEP_LOSS_RTOL
          and errs["twins"]["worst"][0] <= 1.0,
          "saturated: the first step disagrees with the twins' composition: "
          "%s %s" % (rel_twins, errs["twins"]))
    check(max(rel) <= BF16_STEP_LOSS_RTOL and errs["off"]["worst"][0] <= 1.0,
          "saturated: the steps disagree with use_pallas=off: %s %s %s"
          % (losses_k, losses_o, errs["off"]))
    step_ms, step_ms_off = float(np.mean(times_k[1:])), float(np.mean(times_o[1:]))
    turns = [profile_device(t.step, m) for t, m in
             ((to, step_ms_off), (tk, step_ms), (tk, step_ms), (to, step_ms_off))]
    emit({"phase": "profile", "of": "saturated train step of %d at bf16, "
          "use_pallas=off in the fp32 turns" % B, **turns_fields(turns),
          **turns[1]})
    check_gone(turns, "the train step")
    profiled["train_step"] = gemm_launches(turns)
    del tk, to, tt, grads_k, grads_o
    torch.cuda.empty_cache()
    return runs, max_w, profiled


def gemm_launches(turns):
    """The launches of the products' kernel in the profiled kernel turns
    (c1, c2), each > 0."""
    counts = [sum(n for k, n in t["kernel_launches"].items()
                  if SATURATED_GEMM_KERNEL in k) for t in turns[1:3]]
    check(all(n > 0 for n in counts),
          "saturated: no %s in the profiled turns: %s" % (SATURATED_GEMM_KERNEL, counts))
    return counts


def check_gone(turns, what):
    """No kernel that the wide forwards replaced launched in the profiled
    kernel turns (by name)."""
    names = [k for t in turns[1:3] for k in t["kernel_names"]]
    check(not any(g in k for k in names for g in SATURATED_GONE_KERNELS),
          "saturated: %s launched %s" % (what, [
              k for k in names if any(g in k for g in SATURATED_GONE_KERNELS)]))


def saturated_phase(dev):
    """The two products' rows, the saturated path, then its four kernels'
    rows; each row's launches are the path's (a served batch and
    SATURATED_STEPS steps), each > 0: the products' counted from the wide
    kernels' launches (SATURATED_GEMM_LAUNCHES), which must equal their
    launches in the path's profiled batch and step (`launches_profiled`,
    c1 and c2: neither above, the larger equal, as a profile may lose a
    record but never gains one)."""
    products = gemm_kernel_rows(dev)
    runs, max_w, profiled = saturated_path()
    rows = saturated_kernel_rows(dev, max_w)
    for row in rows:
        names = list(row["by_kernel"])
        check(any(SATURATED_GEMM_KERNEL in k for k in names),
              "%s: its products ran on %s" % (row["name"], names))
    rows += products
    derived = {"served_batch": 0, "train_step": 0}
    for row in rows:
        per_call = SATURATED_GEMM_LAUNCHES.get(row["name"])
        if per_call is not None:
            by_run = {r: sum(n * c[w] for w, n in per_call.items())
                      for r, c in runs.items()}
            row["launches_profiled"] = profiled
            derived["served_batch"] += by_run["serve"]
            derived["train_step"] += by_run["train"] / SATURATED_STEPS
        else:
            by_run = {r: c[row["name"]] for r, c in runs.items()}
        row["launches"] = sum(by_run.values())
        row["launches_by_run"] = by_run
        row["launches_per_served_batch"] = by_run["serve"]
        row["launches_per_step"] = by_run["train"] / SATURATED_STEPS
        row["launches_path"] = "saturated"
        check(row["launches"] > 0, "%s never launched on the saturated path"
              % row["name"])
    for run, n in derived.items():
        check(max(profiled[run]) == n and all(p <= n for p in profiled[run]),
              "saturated: %s launches counted from the wide kernels' (%s) "
              "differ from the profiled %s launches of a %s (%s)"
              % (SATURATED_GEMM_KERNEL, n, SATURATED_GEMM_KERNEL, run, profiled[run]))
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vslnet_torch.ops import kernels as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    marks = [("start", time.perf_counter())]

    def mark(name):  # the seconds each phase took
        marks.append((name, time.perf_counter()))

    path, seconds, log = K.build_library()
    emit({"phase": "build", "seconds": seconds, "library": str(path),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    from vslnet_torch.config import Config
    from vslnet_torch.data.loader import static_caps

    dataset, feats, splits = charades_like_dataset()
    # the query stream's length on the served path
    max_w, _ = static_caps(splits, Config())
    mark("build")
    rows = kernel_phase(dev, max_w)
    mark("kernels")
    launches = slice_phase(dataset, feats, splits)
    mark("slice")
    train_launches, _, fp32_trainer = train_phase(dataset, feats)
    mark("train")
    for row in rows:
        # each kernel's launches on the path that runs it: serving for the
        # forward kernels, training for the residual forward and backwards
        name = row["name"]
        on_train = name in TRAIN_KERNELS and not launches[name]
        row["launches"] = (train_launches if on_train else launches)[name]
        row["launches_path"] = "train" if on_train else "serve"
        row["launches_train_step"] = train_launches[name] / TRAIN_STEPS
        check(row["launches"] > 0,
              "%s never launched on its main path" % name)
    bf16_rows = bf16_kernel_rows(dev, max_w)
    bf16_launches = bf16_phase(dataset, feats, splits, launches)
    mark("bf16")
    for row in bf16_rows:
        row["launches"] = bf16_launches[row["name"]]
        row["launches_path"] = "serve_bf16"
        check(row["launches"] > 0,
              "%s never launched on the bf16 served path" % row["name"])
    bf16_train_rows = bf16_train_kernel_rows(dev, max_w)
    bf16_train_launches = bf16_train_phase(dataset, feats, train_launches,
                                           fp32_trainer)
    del fp32_trainer
    mark("bf16_train")
    for row in bf16_train_rows:
        row["launches"] = bf16_train_launches[row["name"]]
        row["launches_path"] = "train_bf16"
        row["launches_train_step"] = row["launches"] / TRAIN_STEPS
        check(row["launches"] > 0,
              "%s never launched on the bf16 training path" % row["name"])
    long_rows = long_t_phase(dev)
    mark("long_t")
    bf16_long_rows, _ = bf16_long_phase(dev)
    mark("bf16_long")
    for row in long_rows:
        # the tiled conv kernels also run on the main path where conv_route
        # sends its rows
        row["launches_main"] = {"serve": launches[row["name"]],
                                "train": train_launches[row["name"]]}
    rows += long_rows + bf16_rows + bf16_train_rows + bf16_long_rows
    cli_counts = cli_phase(dataset, feats, splits)
    mark("cli")
    # after the CLI's copy rows: run before them, its profiles once left
    # torch.profiler with no record of the next served batch's copies
    rows += saturated_phase(dev)
    mark("saturated")
    emit({"phase": "seconds", **{name: t - marks[i][1] for i, (name, t)
                                in enumerate(marks[1:])},
          "total": marks[-1][1] - marks[0][1]})
    for row in rows:
        # and on the command line's runs (train, resume, test, predict,
        # serve), each a process of its own
        row["launches_cli"] = cli_counts[row["name"]]
        row["launches"] += row["launches_cli"]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
