#!/usr/bin/env python3
"""The MHA block's launch plans on the card (csrc/mha_block.cu): where a
call spends its time by kernel, and the time of each plan.

    python3 -m vslnet_torch.bench.mha_plans              # the backward
    python3 -m vslnet_torch.bench.mha_plans --forward    # the forward
    python3 -m vslnet_torch.bench.mha_plans [--forward] --by-kernel

At [16, T, 128], 8 heads, ragged key lengths and one fully masked row, for
T = 128 (the main path) and 12 (the query stream).

The backward, at drop_rate 0.2:
- `launch_mha_block_bwd` at its default plan, each call's device time by
  kernel (torch.profiler) and the call's time (CUDA events over 20 calls
  after a warm-up); beside it the backward of `mha_block_unfused` (the
  block's PyTorch ops around the whole-T attention kernels) at the same
  inputs, forward + backward minus forward, by CUDA events and by device
  time;
- every plan of FRAMES frames a tile and QTILES query rows a CTA that
  fits (`plans`), through the kernel library (`runner`): the call's
  device time (the sum of its kernels' in torch.profiler; the CUDA-event
  time of a call is the host's at these sizes), its kernels' and its
  largest difference from mha_bwd_plan's gradients.
The forward (--forward), at drop_rate 0 (served) and 0.2 (trained):
- `launch_mha_block_fwd` at its default plan by kernel, beside
  `mha_block_unfused`'s forward at the same inputs, as above;
- every plan of FWD_FRAMES frames a tile and FWD_SLICES weight slices at
  the default query tile, and of FWD_QTILES query rows at the default
  tiles (`fwd_plans`), through the kernel library (`fwd_runner`): device
  time by kernel and the largest difference from mha_fwd_plan's output;
- the whole-T forward (fused_mha's route on path M) at [16, 192, 128] on
  query tiles of FWD_QTILES rows, beside `attention`.
With --by-kernel only the default calls and the unfused block, which an
older tree of the port with the same wrappers also runs (put it on
PYTHONPATH), so that a change's breakdown can be set beside its parent's.
Prints one JSON line a row with the card's name and power limit.
"""
import json
import math
import sys

import numpy as np

from vslnet_torch.bench.common import by_kernel, card, cuda_ms
from vslnet_torch.ops import kernels as K

B, D, HEADS, RATE = 16, 128, 8, 0.2
FRAMES = [2, 4, 8, 16, 32]
QTILES = [8, 16, 32, 64, 128]
FWD_FRAMES = [2, 4, 8, 16, 32]
FWD_SLICES = [16, 8, 4, 2]  # slices of D / n rows
FWD_QTILES = [8, 16, 32, 64, 128]


def inputs(rng, dev, T):
    """x, mask, gam, beta, wqkv, bqkv, wd, bd, seeds and g at [B, T, D]."""
    import torch

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    lens = list(rng.integers(1, T + 1, B - 1)) + [0]
    return [t(rng.standard_normal((B, T, D))),
            t(np.arange(T)[None, :] < np.asarray(lens)[:, None]),
            t(1 + 0.1 * rng.standard_normal((2, D))),
            t(0.1 * rng.standard_normal((2, D))),
            t(rng.standard_normal((D, 3 * D)) / math.sqrt(D)),
            t(0.1 * rng.standard_normal((3 * D,))),
            t(rng.standard_normal((D, D)) / math.sqrt(D)),
            t(0.1 * rng.standard_normal((D,))),
            t(rng.integers(0, 1 << 23, (B, 1))),
            t(rng.standard_normal((B, T, D)))]


def plans(B, T, D, heads):
    """The plans this script times at [B, T, D]: FRAMES frames a tile and
    QTILES query rows a CTA (at least T / MHA_CLUSTER, so that a (row,
    head) is one cluster), each cut to T, with mha_bwd_plan's weight
    slices, where they fit, each once."""
    hd, sk = D // heads, K.mha_bwd_plan(B, T, D, heads).slice_rows
    out = []
    for frames in FRAMES:
        for q_tile in QTILES:
            f = min(T, frames)
            q = min(T, max(q_tile, -(-T // K.MHA_CLUSTER)))
            plan = K.MHABwdPlan(f, -(-T // f), sk, K._mha_frames_bytes(f, sk, D),
                                q, -(-T // q), K._mha_attention_bytes(T, q, hd))
            if (max(plan.smem_frames, plan.smem_attention) <= K.MAX_SMEM_BYTES
                    and plan not in out):
                out.append(plan)
    return out


def runner(bwd, plan):
    """A call of the backward kernels through the kernel library on
    `plan`, at bwd = [x, mask, gam, beta, wqkv, wd, heads, seeds, rate,
    qkv, att, g] with the workspaces launch_mha_block_bwd allocates:
    returns its gradients in launch_mha_block_bwd's order."""
    import torch

    x, mask, gam, beta, wqkv, wd, heads, seeds, rate, qkv, att, g = bwd
    B, T, D = x.shape
    sp, thresh, scale = K._dropout_args("mha_plans", seeds, rate, B)
    wqkvT, wdT = wqkv.t().contiguous(), wd.t().contiguous()
    dx = torch.empty_like(x)
    dsmall, dwqkv, dwd = (x.new_empty(n) for n in (8 * D, D * 3 * D, D * D))
    z, gdpre, gres, gatt, y = (torch.empty_like(x) for _ in range(5))
    dqkv = torch.empty_like(qkv)
    part = x.new_empty(B * plan.tiles * 8 * D)
    splits = K._wgrad_splits(1, D, 3 * D, B * T)
    ws = x.new_empty(max(1, splits * D * 3 * D))
    ptrs = [a.data_ptr() for a in (x, mask, gam, beta, wqkvT, wdT)]
    outs = [a.data_ptr() for a in (qkv, att, g, dx, dsmall, dwqkv, dwd, z, gdpre, gres,
                                   gatt, y, dqkv, part, ws)]

    def run():
        K._launch("mha_block_bwd", *ptrs, sp, thresh, scale, *outs, splits, B, T, D,
                  heads, plan.frames, plan.slice_rows, plan.q_tile)
        return (dx, dsmall[:2 * D].view(2, D), dsmall[2 * D:4 * D].view(2, D),
                dwqkv.view(D, 3 * D), dsmall[4 * D:7 * D], dwd.view(D, D), dsmall[7 * D:])
    return run


def fwd_plans(B, T, D, heads):
    """The forward's plans this script times at [B, T, D]: FWD_FRAMES
    frames a tile and FWD_SLICES weight slices at mha_fwd_plan's query
    tile, and FWD_QTILES query rows at its tiles, each cut to T, where
    they fit, each once."""
    hd, default = D // heads, K.mha_fwd_plan(B, T, D, heads)

    def plan(frames, sk, q_tile):
        f, q = min(T, frames), min(T, q_tile)
        return K.MHAFwdPlan(f, -(-T // f), sk, K._mha_fwd_frames_bytes(f, sk, D),
                            q, -(-T // q), K._mha_fwd_attention_bytes(T, q, hd))

    cands = [plan(f, D // n, default.q_tile) for f in FWD_FRAMES
             for n in FWD_SLICES if (D // n) % 4 == 0]
    cands += [plan(default.frames, default.slice_rows, q) for q in FWD_QTILES]
    out = []
    for p in cands:
        if (max(p.smem_frames, p.smem_attention) <= K.MAX_SMEM_BYTES
                and p not in out):
            out.append(p)
    return out


def fwd_runner(args, heads, seeds, rate, plan):
    """A call of the forward kernels through the kernel library on `plan`,
    at args = [x, mask, gam, beta, wqkv, bqkv, wd, bd] (the weights 16-byte
    aligned): returns (out, qkv, att) as launch_mha_block_fwd does."""
    import torch

    x = args[0]
    B, T, D = x.shape
    sp, thresh, scale = K._dropout_args("mha_plans", seeds, rate, B)
    qkv = x.new_empty(B, T, 3 * D)
    att, out = torch.empty_like(x), torch.empty_like(x)
    ptrs = [a.data_ptr() for a in args]

    def run():
        K._launch("mha_block_fwd", *ptrs, sp, thresh, scale, qkv.data_ptr(),
                  att.data_ptr(), out.data_ptr(), B, T, D, heads, plan.frames,
                  plan.slice_rows, plan.q_tile)
        return out, qkv, att
    return run


def unfused_forward_ms(args, seeds, rate):
    """mha_block_unfused's forward at these inputs: (CUDA events, device
    time of its kernels)."""
    import torch

    def run():
        with torch.no_grad():
            K.mha_block_unfused(*args, HEADS, seeds, rate)

    return cuda_ms(run), sum(by_kernel(run).values())


def whole_t_forward(emit, rng, dev):
    """The whole-T forward (fused_mha's route on path M, the block
    forward's attention body) at [16, 192, 128], drop 0 and 0.2, on query
    tiles of FWD_QTILES rows through the kernel library, by device time and
    CUDA events, with the largest difference from `attention`."""
    import torch

    T = 192
    x, mask, *_ = inputs(rng, dev, T)
    q, k, v = (torch.randn_like(x) for _ in range(3))
    seeds = torch.from_numpy(rng.integers(0, 1 << 23, (B, 1)).astype(
        np.float32)).to(dev)
    for rate in (0.0, RATE):
        sp, thresh, scale = K._dropout_args("mha_plans", seeds, rate, B)
        ref = K.attention(q, k, v, mask, HEADS, seeds, rate)
        out = torch.empty_like(q)
        for q_tile in FWD_QTILES:
            def run():
                K._launch("mha_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          mask.data_ptr(), sp, thresh, scale, out.data_ptr(),
                          B, T, D, HEADS, q_tile)
                return out
            diff = float((run() - ref).abs().max())
            parts = by_kernel(run)
            emit(direction="whole_t_forward", shape=[B, T, D], drop_rate=rate,
                 q_tile=q_tile, default=q_tile == K.MHA_WHOLE_QTILE,
                 call_ms=cuda_ms(run), device_ms=sum(parts.values()),
                 by_kernel=parts, max_abs_diff_from_attention=diff)


def forward(emit, rng, dev, only_by_kernel):
    if not only_by_kernel:
        whole_t_forward(emit, rng, dev)
    for T in (128, 12):
        *args, seeds, _ = inputs(rng, dev, T)
        for rate in (0.0, RATE):
            def call():
                return K.launch_mha_block_fwd(*args, HEADS, seeds, rate)

            parts = by_kernel(call)
            unfused_ms, unfused_device_ms = unfused_forward_ms(args, seeds, rate)
            emit(direction="forward", shape=[B, T, D], heads=HEADS,
                 drop_rate=rate, call_ms=cuda_ms(call),
                 device_ms=sum(parts.values()), by_kernel=parts,
                 unfused_ms=unfused_ms, unfused_device_ms=unfused_device_ms)
        if only_by_kernel:
            continue
        default = K.mha_fwd_plan(B, T, D, HEADS)
        ref = K.launch_mha_block_fwd(*args, HEADS)
        for plan in fwd_plans(B, T, D, HEADS):
            run = fwd_runner(args, HEADS, None, 0.0, plan)
            diff = max(float((a - b).abs().max()) for a, b in zip(run(), ref))
            parts = by_kernel(run)
            emit(direction="forward", shape=[B, T, D], plan=plan._asdict(),
                 default=plan == default, device_ms=sum(parts.values()),
                 by_kernel=parts, max_abs_diff_from_default=diff)


def unfused_backward_ms(x, mask, gam, beta, wqkv, bqkv, wd, bd, seeds, g):
    """The backward of mha_block_unfused at these inputs, forward +
    backward minus forward: (CUDA events, device time of the kernels)."""
    import torch

    leaves = [a.clone().requires_grad_() for a in (x, gam, beta, wqkv, bqkv,
                                                   wd, bd)]

    def run(grad):
        with torch.set_grad_enabled(grad):
            out = K.mha_block_unfused(leaves[0], mask, *leaves[1:], HEADS,
                                      seeds, RATE)
            if grad:
                torch.autograd.grad(out, leaves, g)

    return (cuda_ms(lambda: run(True)) - cuda_ms(lambda: run(False)),
            sum(by_kernel(lambda: run(True)).values())
            - sum(by_kernel(lambda: run(False)).values()))


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("mha_plans: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    only_by_kernel = "--by-kernel" in argv
    smi = card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def emit(**row):
        print(json.dumps({"bench": "mha_plans", "card": smi, **row}),
              flush=True)

    if "--forward" in argv:
        forward(emit, rng, dev, only_by_kernel)
        return 0
    for T in (128, 12):
        x, mask, gam, beta, wqkv, bqkv, wd, bd, seeds, g = args = inputs(
            rng, dev, T)
        _, qkv, att = K.launch_mha_block_fwd(x, mask, gam, beta, wqkv, bqkv,
                                             wd, bd, HEADS, seeds, RATE)
        bwd = [x, mask, gam, beta, wqkv, wd, HEADS, seeds, RATE, qkv, att, g]

        def call():
            return K.launch_mha_block_bwd(*bwd)

        parts = by_kernel(call)
        unfused_ms, unfused_device_ms = unfused_backward_ms(*args)
        emit(shape=[B, T, D], heads=HEADS, drop_rate=RATE, call_ms=cuda_ms(call),
             device_ms=sum(parts.values()), by_kernel=parts, unfused_ms=unfused_ms,
             unfused_device_ms=unfused_device_ms)
        if only_by_kernel:
            continue
        default = K.mha_bwd_plan(B, T, D, HEADS)
        ref = call()
        for plan in plans(B, T, D, HEADS):
            run = runner(bwd, plan)
            diff = max(float((a - b).abs().max()) for a, b in zip(run(), ref))
            parts = by_kernel(run)
            emit(shape=[B, T, D], plan=plan._asdict(), default=plan == default,
                 device_ms=sum(parts.values()), by_kernel=parts,
                 max_abs_diff_from_default=diff)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
