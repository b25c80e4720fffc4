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
              gradient of sum(out * g), and the dropout's zero pattern;
              the conv block's forward and the MHA block's forward and
              backward also give equal bits on two equal calls.
              The cluster and tiled kernels carry their launch plans; the
              conv block's forward and backward must beat the T-tiled
              kernels at the same shape, the MHA block's forward and
              backward those of the unfused block (its PyTorch ops around
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
  6. long_t   beyond T = 145, where the whole-row conv and MHA block
              kernels do not fit: the whole-T and flash attention kernels
              (forward, backward) and the T-tiled conv block (forward,
              backward) against their plain versions at the paths' shapes
              (output, every gradient, dropout zero pattern; SDPA as the
              attention yardstick; the flash backward gives equal bits on
              two equal calls, carries its plan and device time by kernel
              and must beat SDPA's backward); then path M (rnn,
              max_pos_len 192, batch 16) and path L (transformer,
              max_pos_len 1024, batch 8): a served batch against
              use_pallas=off, one train step against off, then 3 (M) or
              10 (L) steps with the kernels (on L the loss must fall),
              with their launches, step times and, on L, profiles.
Then the "kernels" line, and last {"ok": true, "device": {...}}.
Any failure raises and exits non-zero before the last line.
"""
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor cores
# and HBM3 bandwidth. The bound of a kernel is the larger of its FLOPs over
# the first and its bytes (inputs read once, outputs written once) over the
# second.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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


def kernel_row(name, source, replaces, err, tol, ms, plain_ms, flops, nbytes,
               library_ms=None, checked_err=None, **extra):
    """One kernel's row, emitted and held to tol. checked_err, where given,
    is what is held to tol (scaled_err for gradients); err is always the
    raw max abs error."""
    bound_ms, bound_by = bound(flops, nbytes)
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
           2 * int(lens.sum()) * H * 4 * H,
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

    q_args = conv_inputs(max_w)
    q_err = max_err(K.fused_conv_block(*q_args), K.conv_block_plain(*q_args))
    args = conv_inputs(T)
    err = max_err(K.fused_conv_block(*args), K.conv_block_plain(*args))
    # with dropout (the training forward), at T and at max_w
    seeds = seeds_for(B)
    drop = {"seeds": seeds, "drop_rate": DROP}
    d_err = max(max_err(K.fused_conv_block(*a, **drop),
                        K.conv_block_plain(*a, **drop)) for a in (args, q_args))
    # one layer: out - x is 0 exactly where its mask (or the ReLU) drops
    one = [args[0]] + [w[:1].contiguous() for w in args[1:]]
    zeros_equal = torch.equal(K.fused_conv_block(*one, **drop) == args[0],
                              K.conv_block_plain(*one, **drop) == args[0])
    check(zeros_equal, "conv_block_fwd: the dropout zero pattern differs")
    # no atomics, a fixed order of every sum: two equal calls, equal bits
    twice = torch.equal(K.launch_conv_block_fwd(*args, **drop),
                        K.launch_conv_block_fwd(*args, **drop))
    check(twice, "conv_block_fwd: two equal calls differ")
    # the cluster forward against the T-tiled one at the same shape, in
    # this run, by CUDA events around back-to-back calls and by the device
    # time of a call's kernels (torch.profiler): the kernel must be the
    # faster by device time (events time the host once it outlasts the
    # kernel)
    parts = by_kernel(lambda: K.launch_conv_block_fwd(*args))
    tiled_parts = by_kernel(lambda: K.launch_conv_block_fwd_tiled(*args))
    device_ms = sum(parts.values())
    tiled_device_ms = sum(tiled_parts.values())
    ms = cuda_ms(lambda: K.fused_conv_block(*args), 50)
    tiled_ms = cuda_ms(lambda: K.launch_conv_block_fwd_tiled(*args), 50)
    record("conv_block_fwd", "vslnet_torch/csrc/conv_block.cu",
           "vslnet_tpu/ops/pallas_kernels.py:1019", max(err, q_err, d_err), TOL,
           ms, cuda_ms(lambda: K.conv_block_plain(*args), 50),
           L * 2 * B * T * D * (D + KS),
           4 * (2 * B * T * D + L * (3 * D + KS * D + D * D)),
           shape=[B, T, D], query_T=max_w, query_max_abs_err=q_err,
           dropout_max_abs_err=d_err, dropout_zero_pattern_equal=zeros_equal,
           equal_bits_twice=twice,
           dropout_ms=cuda_ms(lambda: K.fused_conv_block(*args, **drop), 50),
           dropout_plain_ms=cuda_ms(
               lambda: K.conv_block_plain(*args, **drop), 50),
           plan=K.conv_fwd_plan(B, T, D, KS, L)._asdict(),
           query_plan=K.conv_fwd_plan(B, max_w, D, KS, L)._asdict(),
           device_ms=device_ms, by_kernel=parts, tiled_ms=tiled_ms,
           tiled_device_ms=tiled_device_ms, tiled_by_kernel=tiled_parts,
           query_ms=cuda_ms(lambda: K.launch_conv_block_fwd(*q_args), 50),
           query_device_ms=sum(by_kernel(
               lambda: K.launch_conv_block_fwd(*q_args)).values()))
    check(device_ms < tiled_device_ms, "conv_block_fwd: %g ms of device "
          "time, not below the tiled forward's %g" % (device_ms,
                                                      tiled_device_ms))
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
           2 * B * T * D * 3 * D + 4 * T * keys * D + 2 * B * T * D * D,
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

    # 4. context-query attention: video [B, T, D], query [B, max_w, D],
    # ragged lengths and one padded query (every word masked)
    W = max_w
    q_lens = list(rng.integers(1, W + 1, B - 1)) + [0]
    args = [t(rng.standard_normal((B, T, D))), t(rng.standard_normal((B, W, D))),
            t(np.arange(T)[None, :] < lens[:, None]),
            t(np.arange(W)[None, :] < np.asarray(q_lens)[:, None]),
            *[t(rng.standard_normal(D) / math.sqrt(D)) for _ in range(3)]]
    out = K.fused_cqa_concat(*args)
    check(bool(torch.isfinite(out).all()),
          "cqa_concat_fwd: non-finite output on a padded query")
    err = max_err(out, K.cqa_plain(*args)[0])
    record("cqa_concat_fwd", "vslnet_torch/csrc/cqa.cu",
           "vslnet_tpu/ops/pallas_kernels.py:102", err, TOL,
           cuda_ms(lambda: K.fused_cqa_concat(*args), 50),
           cuda_ms(lambda: K.cqa_plain(*args), 50),
           # scores, both softmaxes, v2q, Sv^T.v, Sq.(Sv^T.v), the products
           B * (8 * T * W * D + 5 * T * D + 2 * W * D + 18 * T * W),
           4 * (B * T * D + B * W * D + B * T + B * W + 3 * D
                + B * T * 4 * D),
           shape=[B, T, W, D])

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

    record("highlight_gate_fwd", "vslnet_torch/csrc/highlight_gate.cu",
           "vslnet_tpu/ops/pallas_kernels.py:180", err, TOL,
           cuda_ms(lambda: K.fused_highlight_gate(*args), 100),
           cuda_ms(highlight_plain_gate, 100),
           B * T * (3 * D + 4), 4 * (2 * B * T * D + 2 * B * T + D + 1),
           shape=[B, T, D])

    # 6. span decode [B, T] of masked logits; exact indices
    mask = t(np.arange(T)[None, :] < lens[:, None])
    sl = t(rng.standard_normal((B, T)) * 3) * mask + (1 - mask) * -1e30
    el = t(rng.standard_normal((B, T)) * 3) * mask + (1 - mask) * -1e30
    s, e = K.fused_span_decode(sl, el)
    s_ref, e_ref = K.span_decode_plain(sl, el)
    index_err = max(max_err(s, s_ref), max_err(e, e_ref))
    record("span_decode", "vslnet_torch/csrc/span_decode.cu",
           "vslnet_tpu/ops/pallas_kernels.py:57", index_err, 0.0,
           cuda_ms(lambda: K.fused_span_decode(sl, el), 100),
           cuda_ms(lambda: K.span_decode_plain(sl, el), 100),
           10 * B * T, 4 * (2 * B * T + 2 * B), shape=[B, T])

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
           2 * steps * H * 4 * H,
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
           2 * 2 * steps * H * 4 * H,
           4 * (2 * T * B * 4 * H + 4 * T * B * H + T * B + 2 * H * 4 * H),
           library_ms=ms_lib_fb - ms_lib_f, checked_err=err,
           library_fwd_bwd_ms=ms_lib_fb, shape=[T, B, 4 * H],
           us_per_step=ms * 1e3 / T, plan=plan_fields(plan))
    check(ms < ms_lib_fb - ms_lib_f, "lstm_recurrence_bwd: %g ms, not below "
          "cuDNN's backward %g" % (ms, ms_lib_fb - ms_lib_f))

    # 9. conv block backward, at T and at max_w, drop_rate 0.2
    def conv_pair(a, sd):
        g = t(rng.standard_normal(tuple(a[0].shape)))
        kw = {"seeds": sd, "drop_rate": DROP}
        return autograd_pair(lambda *x: K.fused_conv_block(*x, **kw),
                             lambda *x: K.conv_block_plain(*x, **kw),
                             a, 6, g), g

    (q_abs, q_err, q_fin), _ = conv_pair(conv_q_args, seeds_for(B))
    seeds = seeds_for(B)
    (abs_err, err, finite), g = conv_pair(conv_args, seeds)
    check(finite and q_fin, "conv block: non-finite gradient")
    leaves = [a.clone().requires_grad_() for a in conv_args]
    out_p = K.conv_block_plain(*leaves, seeds=seeds, drop_rate=DROP)
    ms = cuda_ms(lambda: K.launch_conv_block_bwd(*conv_args, seeds, DROP, g),
                 20)
    # the T-tiled backward at the same shape, from its forward's xs
    _, xs = K.launch_conv_block_fwd_tiled(*conv_args, seeds, DROP)
    tiled_ms = cuda_ms(lambda: K.launch_conv_block_bwd_tiled(
        conv_args[0], xs, *conv_args[1:], seeds, DROP, g), 20)
    gq = g[:, :max_w].contiguous()
    record("conv_block_bwd", "vslnet_torch/csrc/conv_block.cu",
           "vslnet_tpu/ops/pallas_kernels.py:1039", max(abs_err, q_abs), TOL, ms,
           cuda_ms(lambda: torch.autograd.grad(out_p, leaves, g,
                                               retain_graph=True), 20),
           # the forward replayed, then the data and weight products
           L * 6 * B * T * D * (D + KS),
           4 * (4 * B * T * D + 2 * L * (3 * D + KS * D + D * D) + B),
           checked_err=max(err, q_err), shape=[B, T, D], drop_rate=DROP,
           query_T=max_w, query_checked_err=q_err,
           plan=K.conv_plan(B, T, D, KS, L)._asdict(),
           query_plan=K.conv_plan(B, max_w, D, KS, L)._asdict(),
           tiled_ms=tiled_ms,
           query_ms=cuda_ms(lambda: K.launch_conv_block_bwd(
               *conv_q_args, seeds, DROP, gq), 20))
    check(ms < tiled_ms, "conv_block_bwd: %g ms, not below the tiled "
          "backward's %g" % (ms, tiled_ms))

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
           4 * B * T * D * D + 4 * B * T * D * 3 * D + 10 * T * keys * D,
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


def flax_layout_weights(model, glove, seed):
    """Seeded numpy weights for every tensor of `model`, nested as the JAX
    package's {"params": ..., "frozen": ...} tree."""
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "frozen": {}}
    for key, value in model.state_dict().items():
        shape = tuple(value.shape)
        leaf = key.rsplit(".", 1)[-1]
        if key == "word_embeddings.word_vectors":
            arr = glove
        elif leaf == "scale":
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "bias" or leaf.startswith("bias_"):
            arr = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            arr = rng.standard_normal(shape) / math.sqrt(fan_in)
        node = tree["frozen" if key == "word_embeddings.word_vectors"
                    else "params"]
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = np.asarray(arr, np.float32)
    return tree


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


def profile_device(run, wall_ms):
    """Device time by kernel over one call of run() (torch.profiler), and
    the share of the unprofiled wall time wall_ms the card sits idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"device_ms": device_ms, "wall_ms": wall_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "device_launches": sum(r[2] for r in rows),
            "top": [[k[:70], ms, n] for k, ms, n in rows[:12]]}


def build_localizer(cfg, dataset, splits):
    """A Localizer over cfg's VSLNet with seeded weights in the flax
    layout, loaded through convert_flax."""
    from vslnet_torch.convert_flax import load_flax_variables
    from vslnet_torch.data.loader import static_caps
    from vslnet_torch.models.vslnet import build_model
    from vslnet_torch.serve import Localizer

    model = build_model(cfg, dataset["word_vector"].shape)
    load_flax_variables(model, flax_layout_weights(
        model, dataset["word_vector"], SEED))
    max_w, max_c = static_caps(splits, cfg)
    return Localizer(model, cfg, dataset["word_dict"], dataset["char_dict"],
                     max_w, max_c)


def slice_phase(dataset, feats, splits):
    import torch

    from vslnet_torch.config import Config
    from vslnet_torch.ops import kernels as K
    from vslnet_torch.server import durations_from_dataset, make_server

    def localizer(use_pallas):
        cfg = Config(task="charades", predictor="rnn", hidden_size=128,
                     num_heads=8, max_pos_len=128, video_feature_dim=1024,
                     word_dim=300, char_dim=50, batch_size=16,
                     char_size=dataset["n_chars"], use_pallas=use_pallas,
                     seed=SEED)
        return build_localizer(cfg, dataset, splits), cfg

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
    # decode is plain torch.topk, so 3 span decodes
    expected = {name: 0 for name in K.LAUNCHES}  # no training kernel
    expected.update({"lstm_recurrence_fwd": 8, "conv_block_fwd": 8,
                     "mha_block_fwd": 8, "cqa_concat_fwd": 4,
                     "highlight_gate_fwd": 4, "span_decode": 3})
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
                 "mha_block_bwd")


def train_config(dataset, use_pallas, predictor="rnn", max_pos_len=128,
                 batch_size=16):
    """The reference's default run (main.py flags): rnn predictor, hidden
    128, 8 heads, T 128, batch 16, drop_rate 0.2, bert_adamw at lr 1e-4
    with linear decay over 100 epochs, clip 1.0, l2 3e-7, lambda 5; the
    long_t phase changes the predictor, T and the batch."""
    from vslnet_torch.config import Config

    return Config(task="charades", predictor=predictor, hidden_size=128,
                  num_heads=8, max_pos_len=max_pos_len,
                  video_feature_dim=1024, word_dim=300, char_dim=50,
                  batch_size=batch_size, drop_rate=DROP,
                  optimizer="bert_adamw", init_lr=1e-4, lr_schedule="linear",
                  clip_norm=1.0, l2_decay=3e-7, highlight_lambda=5.0,
                  epochs=100, char_size=dataset["n_chars"],
                  use_pallas=use_pallas, seed=SEED)


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
    from vslnet_torch.ops import kernels as K

    tk, to = trainers(lambda up: train_config(dataset, up), dataset, feats)
    # 1. one step each: same weights, batch and generator seed
    step_vs_off(tk, to, "rnn T=128")
    _, off_times = timed_steps(to, 3)

    # 2. the main path: TRAIN_STEPS steps with the kernels, launches counted
    K.reset_launches()
    losses, times = timed_steps(tk, TRAIN_STEPS)
    launches = dict(K.LAUNCHES)
    expected = {name: 2 * TRAIN_STEPS if name in TRAIN_KERNELS else 0
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
    emit({"phase": "profile", "of": "train step",
          **profile_device(tk.step, step_ms)})

    # 3. evaluation of the test split (reported, not judged)
    r1_3, r1_5, r1_7, miou, _, _ = tk.evaluate()
    emit({"phase": "evaluate", "records": len(dataset["test_set"]),
          "R1@0.3": r1_3, "R1@0.5": r1_5, "R1@0.7": r1_7, "mIoU": miou})
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


def long_kernel_rows(dev):
    """The whole-T and flash attention kernels and the tiled conv block
    against their plain versions at the long paths' shapes (random inputs,
    the paths' ragged lengths T/2..T and one fully masked row): output,
    every gradient of sum(out * g) and the dropout zero pattern; times
    beside the plain versions and, for attention, SDPA's."""
    import torch
    import torch.nn.functional as F

    from vslnet_torch.bench.common import by_kernel
    from vslnet_torch.ops import kernels as K

    rng = np.random.default_rng(SEED + 2)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    D, heads, L, KS = 128, 8, 4, 7
    rows = []

    def seeds_for(n):
        return t(rng.integers(0, 1 << 23, (n, 1)))

    def sdpa_ms(q, k, v, mask):
        """F.scaled_dot_product_attention on the same heads and the additive
        mask at drop 0: (forward ms, backward ms = forward+backward minus
        forward). A yardstick; the port never calls it."""
        B, T, _ = q.shape

        def split(x):
            return x.view(B, T, heads, D // heads).transpose(1, 2).contiguous()

        qh, kh, vh = (split(x).requires_grad_() for x in (q, k, v))
        bias = ((1.0 - mask) * -1e30).view(B, 1, 1, T)
        g = torch.randn_like(qh)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)

        def fwd_bwd():
            out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
            torch.autograd.grad(out, (qh, kh, vh), g)

        f = cuda_ms(fwd, 20)
        fb = cuda_ms(fwd_bwd, 20)
        return f, fb - f, fb

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
        lib_f, lib_b, lib_fb = sdpa_ms(q, k, v, mask)
        # only the valid keys need scores and P.V (all T on the masked row)
        keys = sum(n if n else T for n in lens)
        io = B * T * D
        lse_io = B * heads * T if flash else 0
        shape = {"shape": [B, T, D], "heads": heads, "path": path}
        rows.append(kernel_row(
            fname, source, rep_fwd, err, TOL,
            cuda_ms(lambda: launch_fwd(q, k, v, mask, heads), 20),
            cuda_ms(lambda: K.attention(q, k, v, mask, heads), 5),
            # q, k, v and the mask read, out (and lse) written
            4 * T * keys * D, 4 * (4 * io + B * T + lse_io),
            library_ms=lib_f, dropout_zero_pattern_equal=zeros_equal,
            dropout_ms=cuda_ms(lambda: launch_fwd(q, k, v, mask, heads,
                                                  seeds, DROP), 20),
            **extra, **shape))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out_p = K.attention(*leaves, mask, heads, seeds, DROP)
        saved = (K.launch_flash_mha_fwd(q, k, v, mask, heads, seeds, DROP)
                 if flash else ())

        def bwd():
            return launch_bwd(q, k, v, mask, heads, seeds, DROP, *saved, g)

        extra = {}
        if flash:
            # no atomics: two equal calls, equal bits; the plan, and the
            # device time of a call's kernels (torch.profiler)
            twice = all(torch.equal(a, b) for a, b in zip(bwd(), bwd()))
            check(twice, "%s: two equal calls differ" % bname)
            parts = by_kernel(bwd)
            extra = {"equal_bits_twice": twice,
                     "plan": K.flash_bwd_plan(B, T, D, heads)._asdict(),
                     "device_ms": sum(parts.values()), "by_kernel": parts}
        ms = cuda_ms(bwd, 20)
        rows.append(kernel_row(
            bname, source, rep_bwd, abs_err, TOL, ms,
            cuda_ms(lambda: torch.autograd.grad(out_p, leaves, g,
                                                retain_graph=True), 5),
            # scores recomputed, dP, dV, dQ and dK over the valid keys;
            # q, k, v, g (flash: out, lse), mask and seeds read, dq, dk,
            # dv written
            10 * T * keys * D,
            4 * (7 * io + B * T + B + (io + lse_io if flash else 0)),
            library_ms=lib_b, checked_err=g_err, library_fwd_bwd_ms=lib_fb,
            drop_rate=DROP, **extra, **shape))
        if flash:
            check(ms < lib_b, "%s: %g ms, not below SDPA's backward %g"
                  % (bname, ms, lib_b))

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

    f_errs, b_errs, g_errs, zeros = [], [], [], []
    for path in ("M", "L"):
        B, T = (LONG_PATHS[path][k] for k in ("batch_size", "max_pos_len"))
        check(K.conv_route(T, D, KS, L) == "tiled", "conv route at T=%d" % T)
        args, seeds = conv_inputs(B, T), seeds_for(B)
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
    rows.append(kernel_row(
        "conv_block_fwd_tiled", "vslnet_torch/csrc/conv_block.cu",
        tpu + "1019", max(f_errs), TOL,
        cuda_ms(lambda: K.launch_conv_block_fwd_tiled(*args), 20),
        cuda_ms(lambda: K.conv_block_plain(*args), 20),
        L * 2 * B * T * D * (D + KS), 4 * (2 * B * T * D + weights),
        dropout_zero_pattern_equal=all(zeros),
        dropout_ms=cuda_ms(lambda: K.launch_conv_block_fwd_tiled(
            *args, seeds, DROP), 20), **shape))
    _, xs = K.launch_conv_block_fwd_tiled(*args, seeds, DROP)
    leaves = [a.clone().requires_grad_() for a in args]
    out_p = K.conv_block_plain(*leaves, seeds, DROP)
    rows.append(kernel_row(
        "conv_block_bwd_tiled", "vslnet_torch/csrc/conv_block.cu",
        tpu + "1039", max(b_errs), TOL,
        cuda_ms(lambda: K.launch_conv_block_bwd_tiled(
            args[0], xs, *args[1:], seeds, DROP, g), 20),
        cuda_ms(lambda: torch.autograd.grad(out_p, leaves, g,
                                            retain_graph=True), 20),
        # the forward's products for the ReLU masks, then the data and
        # weight products
        L * 6 * B * T * D * (D + KS),
        4 * (3 * B * T * D + 2 * weights + B),
        checked_err=max(g_errs), drop_rate=DROP, **shape))
    return rows


def long_path(path):
    """One path: a served batch through Localizer against use_pallas=off
    (logits, spans), its launches; one train step against off, then the
    path's steps with the kernels, their launches and times. Returns
    {run: launches}."""
    import torch

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
        return train_config(dataset, use_pallas, cfg["predictor"], T, B)

    # serving: one batch of B requests
    loc = build_localizer(configs("auto"), dataset, splits)
    loc_off = build_localizer(configs("off"), dataset, splits)
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
    if path == "L":
        emit({"phase": "profile", "of": "path L served batch of 8",
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
        emit({"phase": "profile", "of": "path L train step",
              **profile_device(tk.step, step_ms)})

    # every launch where the path's model says, per served batch and step
    heavy = 3 if cfg["predictor"] == "transformer" else 1  # T-long encoders
    attn_f, attn_b = (("flash_mha_fwd", "flash_mha_bwd") if path == "L"
                      else ("mha_fwd", "mha_bwd"))
    lstm = 2 if cfg["predictor"] == "rnn" else 0
    serve = {"conv_block_fwd_tiled": heavy, attn_f: heavy,
             "conv_block_fwd": 1, "mha_block_fwd": 1, "cqa_concat_fwd": 1,
             "highlight_gate_fwd": 1, "span_decode": 1,
             "lstm_recurrence_fwd": lstm}
    step = {"conv_block_fwd_tiled": heavy, "conv_block_bwd_tiled": heavy,
            attn_f: heavy, attn_b: heavy, "conv_block_fwd": 1,
            "conv_block_bwd": 1, "mha_block_fwd": 1, "mha_block_bwd": 1,
            "lstm_recurrence_fwd_res": lstm, "lstm_recurrence_bwd": lstm}
    for run, want in (("serve", serve), ("train", {k: n * v for k, v in
                                                   step.items()})):
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

    path, seconds, log = K.build_library()
    emit({"phase": "build", "seconds": seconds, "library": str(path),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    from vslnet_torch.config import Config
    from vslnet_torch.data.loader import static_caps

    dataset, feats, splits = charades_like_dataset()
    # the query stream's length on the served path
    max_w, _ = static_caps(splits, Config())
    rows = kernel_phase(dev, max_w)
    launches = slice_phase(dataset, feats, splits)
    train_launches = train_phase(dataset, feats)
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
    rows += long_t_phase(dev)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
