#!/usr/bin/env python3
"""The MHA block's launch plans on the card (csrc/mha_block.cu): where a
call spends its time by kernel, and the time of each plan.

    python3 -m vslnet_torch.bench.mha_plans              # the backward
    python3 -m vslnet_torch.bench.mha_plans --forward    # the forward
    python3 -m vslnet_torch.bench.mha_plans --whole-t    # whole-T backward
    python3 -m vslnet_torch.bench.mha_plans --forward --bf16   # #3b
    python3 -m vslnet_torch.bench.mha_plans --bf16   # #10b (and #12b's bits)
    python3 -m vslnet_torch.bench.mha_plans [--forward|--whole-t] --by-kernel

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
The whole-T backward (--whole-t), fused_mha's route on path M, at [16, 192,
128] and drop_rate 0.2:
- the backward of `fused_mha` alone (autograd through a retained graph,
  which an older tree's wrapper runs the same way), by kernel and by CUDA
  events;
- every plan of WHOLE_BWD_QTILES query rows and WHOLE_BWD_THREADS threads
  a CTA that fits (`whole_t_plans`), through the kernel library
  (`whole_t_runner`): device time by kernel, CUDA events and the largest
  difference from the gradients of `attention`;
- the default plan's cycles between the attention body's barriers (and
  to where its dP and dK products start), thread 0 of CTA 0, from a copy
  of mha_block.cu with clock stamps built into
  vslnet_torch/_build/bench/, keyed by the stamp's line in mha_block.cu.
The bf16 forward (--forward --bf16, #3b) at T = 128 and 12, drop 0 and 0.2:
- `launch_mha_block_fwd` on bf16 x by kernel (torch.profiler), the call's
  time (CUDA events) and the bound (bench/common.py mha_fwd_bf16_bound);
- the library calls of its parts in bf16 (by device time; the port never
  calls them): cuBLAS's [B T, 128] x [128, 384] and x [128, 128]
  products, SDPA's forward at [16, 8 heads, T, 16] with the key mask;
- #10b at the same T (`launch_mha_block_bwd` on bf16 x and g) by kernel,
  fed qkv and att computed by the plain ops (bf16(y . bf16(Wqkv) + bqkv)
  and `attention` at bf16), the same values whatever tree runs it, so
  that `grads_sha1` can be set beside a parent's; and #11b (`launch_mha_fwd`
  on bf16 q, k, v) at path M's [16, 192, 128] with `out_sha1`;
- on a tree with the tensor-core forward, each plan of BF16_FWD_ROWS
  frames a projection tile and BF16_FWD_COLS columns (`bf16_fwd_plans`)
  through the kernel library: device time by kernel and whether the
  output equals the default plan's bit for bit; and the cycles of a call
  between the stamps of each of its three kernels (thread 0 of the
  CTA at x, y, z 0, its phases' lines in mha_block.cu) from a stamped
  copy standing in for the kernel library while the wrapper launches it.
The bf16 backward (--bf16, #10b) at T = 128 and 12, drop 0 and 0.2, from
qkv and att the plain ops compute (`plain_residuals`, the same values
whatever tree runs it): `launch_mha_block_bwd` on bf16 x and g by kernel,
the call's time, its plan, the bound (bench/common.py mha_bwd_bf16_bound)
and `grads_sha1`; the library calls of its parts in bf16 (SDPA's backward
at [16, 8 heads, T, 16] with the key mask, cuBLAS's g_z, g_y, dwd and
dwqkv), and on a tree with the tensor-core backward the cycles of a call
between the stamps of each of its three kernels (BF16_BWD_STAMPS, thread 0
of the CTA at x, y, z 0) from a stamped copy standing in for the kernel
library; then #12b at path M's [16, 192, 128] (`launch_mha_bwd` on bf16 q,
k, v, g) with the sha1 of its forward's output (#11b) and of its
gradients, to set beside a parent's run by path.
With --by-kernel only the default calls and the unfused block, which an
older tree of the port with the same wrappers also runs (put it on
PYTHONPATH), so that a change's breakdown can be set beside its parent's;
the backward rows carry the sha1 of their gradients (`grads_sha1`), so that
their bits can be set beside the parent's too.
Prints one JSON line a row with the card's name and power limit.
"""
import ctypes
import hashlib
import json
import math
import sys

import numpy as np

from vslnet_torch.bench import common
from vslnet_torch.bench.common import build_copy, by_kernel, card, cuda_ms
from vslnet_torch.ops import kernels as K

B, D, HEADS, RATE = 16, 128, 8, 0.2
FRAMES = [2, 4, 8, 16, 32]
QTILES = [8, 16, 32, 64, 128]
FWD_FRAMES = [2, 4, 8, 16, 32]
FWD_SLICES = [16, 8, 4, 2]  # slices of D / n rows
FWD_QTILES = [8, 16, 32, 64, 128]
WHOLE_BWD_QTILES = [16, 24, 32, 48, 64, 96]
WHOLE_BWD_THREADS = [256, 512]
# where the stamped copy takes a clock in attn_bwd_cluster_kernel: after
# each block and cluster barrier, and where its dP and dK products start
STAMPS = ("__syncthreads();", "cluster.sync();", "// dS = P * (drop(G.V^T)",
          "// this CTA's dK")


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


def whole_t_plans(B, T, D, heads):
    """The whole-T backward's plans this script times at [B, T, D]: query
    tiles of WHOLE_BWD_QTILES rows, each raised to T / MHA_CLUSTER (a (row,
    head) is one cluster) and cut to T, in CTAs of WHOLE_BWD_THREADS
    threads, where they fit, each once."""
    hd, out = D // heads, []
    for q_tile in WHOLE_BWD_QTILES:
        for threads in WHOLE_BWD_THREADS:
            q = min(T, max(q_tile, -(-T // K.MHA_CLUSTER)))
            plan = K.MHAWholeBwdPlan(q, -(-T // q), threads,
                                     K._mha_attention_bytes(T, q, hd))
            if plan.smem <= K.MAX_SMEM_BYTES and plan not in out:
                out.append(plan)
    return out


def digest(tensors):
    """sha1 of the tensors' bytes: equal digests, equal bits (a parent
    tree's call beside this one's)."""
    return hashlib.sha1(b"".join(t.detach().cpu().numpy().tobytes()
                                 for t in tensors)).hexdigest()


def instrumented(src):
    """(csrc/mha_block.cu with a clock stamp, thread 0 of CTA 0, at each of
    STAMPS in attn_bwd_cluster_kernel and its entry points renamed prof_,
    the mha_block.cu line of each stamp)."""
    return common.instrumented(src, "attn_bwd_cluster_kernel", STAMPS)


def whole_t_runner(bwd, plan, lib=None):
    """A call of the whole-T backward kernel through the kernel library (or
    the stamped copy `lib`) on `plan`, at bwd = [q, k, v, mask, heads,
    seeds, rate, out, g]: returns (dq, dk, dv)."""
    import torch

    q, k, v, mask, heads, seeds, rate, out, g = bwd
    B, T, D = q.shape
    sp, thresh, scale = K._dropout_args("mha_plans", seeds, rate, B)
    grads = [torch.empty_like(q) for _ in range(3)]
    ptrs = [a.data_ptr() for a in (q, k, v, mask)]
    outs = [a.data_ptr() for a in (out, g, *grads)]

    def run():
        if lib is None:
            K._launch("mha_bwd", *ptrs, sp, thresh, scale, *outs, B, T, D,
                      heads, plan.q_tile, plan.threads)
        else:
            stream = torch.cuda.current_stream().cuda_stream
            assert lib.prof_mha_bwd(*ptrs, sp, thresh, scale, *outs, B, T, D,
                                    heads, plan.q_tile, plan.threads,
                                    stream) == 0
        return grads
    return run


def whole_t_backward(emit, rng, dev, only_by_kernel):
    """The whole-T backward at [16, 192, 128], drop 0.2: fused_mha's
    backward by kernel and CUDA events; then (unless only_by_kernel) each
    of whole_t_plans through the kernel library, beside the gradients of
    `attention`."""
    import torch

    T = 192
    _, mask, *_, seeds, g = inputs(rng, dev, T)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, D)).astype(
        np.float32)).to(dev) for _ in range(3))
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    out = K.fused_mha(*leaves, mask, HEADS, seeds, RATE)

    def call():
        return torch.autograd.grad(out, leaves, g, retain_graph=True)

    parts = by_kernel(call)
    emit(direction="whole_t_backward", shape=[B, T, D], heads=HEADS,
         drop_rate=RATE, call_ms=cuda_ms(call), device_ms=sum(parts.values()),
         by_kernel=parts, grads_sha1=digest(call()))
    if only_by_kernel:
        return
    ref = torch.autograd.grad(K.attention(*leaves, mask, HEADS, seeds, RATE),
                              leaves, g)
    default = K.mha_whole_bwd_plan(B, T, D, HEADS)
    bwd = [q, k, v, mask, HEADS, seeds, RATE,
           K.launch_mha_fwd(q, k, v, mask, HEADS, seeds, RATE), g]
    for plan in whole_t_plans(B, T, D, HEADS):
        run = whole_t_runner(bwd, plan)
        diff = max(float((a - b).abs().max()) for a, b in zip(run(), ref))
        parts = by_kernel(run)
        emit(direction="whole_t_backward", shape=[B, T, D], drop_rate=RATE,
             plan=plan._asdict(), default=plan == default,
             call_ms=cuda_ms(run), device_ms=sum(parts.values()),
             by_kernel=parts, max_abs_diff_from_attention=diff)
    src, stamped = instrumented((K.CSRC / "mha_block.cu").read_text())
    lib = build_copy("mha_prof", src)
    lib.prof_mha_bwd.argtypes = K._SIGNATURES["vsl_mha_bwd"]
    lib.prof_mha_bwd.restype = ctypes.c_int
    lib.prof_read.argtypes = [ctypes.c_void_p]
    lib.prof_read.restype = ctypes.c_int
    run = whole_t_runner(bwd, default, lib)
    run()
    torch.cuda.synchronize()
    stamps = (ctypes.c_ulonglong * 64)()
    lib.prof_read(stamps)
    reps = 5
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    lib.prof_read(stamps)
    cycles = {"mha_block.cu:%d" % line: stamps[k] / reps
              for k, line in enumerate(stamped)}
    emit(direction="whole_t_backward", shape=[B, T, D], drop_rate=RATE,
         plan=default._asdict(), cycles_to_each_stamp=cycles,
         cycles_total=sum(cycles.values()))


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


BF16_FWD_ROWS = [16, 32, 48]
BF16_FWD_COLS = [128, 64, 32]
# where the stamped copy takes a clock in each bf16 forward kernel, by the
# text of the line: the projections' weight copies sent, the LayerNorm's
# end, the landing barrier and the product's end; the attention's landing
# barrier, the scores' and softmax's end, v's barrier and p . v's end
BF16_FWD_STAMPS = {
    "mha_proj_tc_kernel": ("  vsl::cp_async_commit();", "  vsl::cp_async_wait<0>();",
                           "  __syncthreads();  // the weight's", "                });"),
    "attn_fwd_tc_kernel": ("  __syncthreads();\n", "  vsl::cp_async_wait<0>();",
                           "  __syncthreads();  // v landed", "  float* orow = att"),
}


def bf16_fwd_plans(B, T, D, heads):
    """Each (rows, QKV columns, dense columns) of BF16_FWD_ROWS and
    BF16_FWD_COLS whose shared memory fits, as mha_fwd_bf16_plan's fields."""
    default = K.mha_fwd_bf16_plan(B, T, D, heads)
    for rows in BF16_FWD_ROWS:
        for cols in BF16_FWD_COLS:
            if K._mha_tc_proj_bytes(rows, cols, D) <= K.MAX_SMEM_BYTES:
                yield default._replace(rows=rows, tiles=-(-B * T // rows), qkv_cols=cols,
                                       dense_cols=min(cols, D))


def bf16_fwd_runner(args, heads, seeds, rate, plan, lib=None):
    """A call of the bf16 forward's entry on `plan` through the kernel
    library (or lib): (out, qkv, att)."""
    import torch

    x, mask, gam, beta, wqkv, bqkv, wd, bd = args
    B, T, D = x.shape
    sp, thresh, scale = K._dropout_args("mha_block_fwd_bf16", seeds, rate, B)
    wqkvb, wdb = (w.to(torch.bfloat16).contiguous() for w in (wqkv, wd))
    out, att = torch.empty_like(x), torch.empty(B, T, D, device=x.device)
    qkv = torch.empty(B, T, 3 * D, device=x.device, dtype=torch.bfloat16)
    fn = (lib or K._library()).vsl_mha_block_fwd_bf16

    def run():
        code = fn(x.data_ptr(), mask.data_ptr(), gam.data_ptr(), beta.data_ptr(),
                  wqkvb.data_ptr(), bqkv.data_ptr(), wdb.data_ptr(), bd.data_ptr(), sp,
                  thresh, scale, qkv.data_ptr(), att.data_ptr(), out.data_ptr(), B, T, D,
                  heads, plan.rows, plan.qkv_cols, plan.dense_cols,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError("vsl_mha_block_fwd_bf16: error %d" % code)
        return out, qkv, att
    return run


# the bf16 backward's (#10b on the tensor cores): the per-frame launches'
# landing barrier, LayerNorm statistics and the end of the product and its
# pass; the attention's loads landed, qs rounded, scores, products and the
# dbqkv partials
BF16_BWD_STAMPS = {
    "mha_bwd_out_tc_kernel": ("  __syncthreads();  // R and the tile's",
                              "  vsl::ln_normalize_rows(XH, XH, inv, nf, D);",
                              "  __syncthreads();\n"),
    "attn_bwd_tc_kernel": ("  vsl::cp_async_wait<0>();", "  const uint32_t seed = drop.seed(b), salt",
                           "    scores(true, true);", "    products(0, 3);",
                           "  // dbqkv of the head's columns"),
    "mha_bwd_qkv_tc_kernel": ("  vsl::ln_normalize_rows(x + tile, XH, inv, nf, D);",
                              "  __syncthreads();\n"),
}


def bf16_stamped(src, stamps=None):
    """(mha_block.cu with clock stamps, thread 0 of the CTA at x, y, z 0, in
    each kernel of `stamps` (BF16_FWD_STAMPS by default), its entry points
    renamed mprof_ and mprof_read(h) added; {kernel: the stamps' lines})."""
    lines = src.split("\n")
    stamp = (" { if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)"
             " { long long now = clock64(); g_prof[%d] += now - plast; plast = now; } }")
    at, n = {}, 0
    for kernel, marks in (stamps or BF16_FWD_STAMPS).items():
        first = next(i for i, ln in enumerate(lines) if ln.startswith(kernel + "("))
        last = lines.index("}", first)
        at[kernel] = []
        for mark in marks:
            one = mark.rstrip("\n")
            i = next(i for i in range(first, last)
                     if lines[i].startswith(one) and (mark[-1] != "\n" or lines[i] == one))
            lines[i] = lines[i].split("//")[0].rstrip() + stamp % n
            at[kernel].append((n, i + 1))
            n += 1
        body = next(i for i in range(first, last) if lines[i].endswith(") {"))
        lines[body] += "\n  long long plast = clock64();"
    src = "\n".join(lines).replace('#include "hash.cuh"\n', '#include "hash.cuh"\n'
                                   "__device__ unsigned long long g_prof[64];\n", 1)
    return src.replace('extern "C" int vsl_', 'extern "C" int mprof_') + r'''
extern "C" int mprof_read(unsigned long long* h) {
  const int err = (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));
  unsigned long long z[64] = {0};
  return err ? err : (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
''', at


def forward_bf16(emit, rng, dev, only_by_kernel):
    """The --forward --bf16 rows (module docstring)."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    tc = hasattr(K, "mha_fwd_bf16_plan")
    stamped = None
    if tc and not only_by_kernel:
        src, at = bf16_stamped((K.CSRC / "mha_block.cu").read_text())
        stamped = (build_copy("mha_fwd_bf16_prof", src), at)
    for T in (128, 12):
        x, mask, gam, beta, wqkv, bqkv, wd, bd, seeds, g = inputs(rng, dev, T)
        args = [x.to(bf), mask, gam, beta, wqkv, bqkv, wd, bd]
        lens = mask.sum(dim=1)
        keys = int(torch.where(lens > 0, lens, torch.full_like(lens, T)).sum())
        bound = getattr(common, "mha_fwd_bf16_bound", None)
        for rate in (0.0, RATE):
            def call():
                return K.launch_mha_block_fwd(*args, HEADS, seeds, rate)

            parts = by_kernel(call)
            emit(direction="forward", dtype="bf16", shape=[B, T, D], heads=HEADS,
                 drop_rate=rate, call_ms=cuda_ms(call), device_ms=sum(parts.values()),
                 by_kernel=parts, out_sha1=digest([call()[0].float()]),
                 **({"bound_ms": bound(B, T, D, keys)[0]} if bound else {}))
        # the parts' library calls in bf16, by device time
        a = torch.randn(B * T, D, device=dev, dtype=bf)
        w3, w1 = (torch.randn(D, n, device=dev, dtype=bf) for n in (3 * D, D))
        qh, kh, vh = (torch.randn(B, HEADS, T, D // HEADS, device=dev, dtype=bf)
                      for _ in range(3))
        am = mask.bool()[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)

        emit(direction="forward", dtype="bf16", library="parts", shape=[B, T, D],
             cublas_qkv_device_ms=sum(by_kernel(lambda: a @ w3).values()),
             cublas_dense_device_ms=sum(by_kernel(lambda: a @ w1).values()),
             sdpa_device_ms=sum(by_kernel(sdpa).values()), sdpa_ms=cuda_ms(sdpa))
        # #10b at this T from qkv and att the plain ops compute
        y = K.site_dropout(K.layer_norm(args[0].float(), gam[0], beta[0]), seeds, 0x200, RATE)
        qkv = (y.to(bf).float() @ wqkv.to(bf).float() + bqkv).to(bf)
        q, k, v = (t.contiguous() for t in qkv.float().split(D, dim=-1))
        att = K.attention(q, k, v, mask, HEADS, seeds, RATE, dtype=bf)
        gb = g.to(bf)
        try:
            K._check("mha_block_bwd_bf16", qkv, qkv.shape, bf)
            K.launch_mha_block_bwd(args[0], mask, gam, beta, wqkv, wd, HEADS, seeds, RATE,
                                   qkv, att, gb)
            qkv_in = qkv
        except (ValueError, TypeError):  # a tree whose backward reads fp32 qkv
            qkv_in = qkv.float()

        def bwd():
            return K.launch_mha_block_bwd(args[0], mask, gam, beta, wqkv, wd, HEADS, seeds,
                                          RATE, qkv_in, att, gb)

        parts = by_kernel(bwd)
        emit(direction="backward", dtype="bf16", shape=[B, T, D], heads=HEADS,
             drop_rate=RATE, call_ms=cuda_ms(bwd), device_ms=sum(parts.values()),
             by_kernel=parts, qkv_dtype=str(qkv_in.dtype),
             grads_sha1=digest([t.float() for t in bwd()]))
        if stamped is None:
            continue
        default = K.mha_fwd_bf16_plan(B, T, D, HEADS)
        ref = K.launch_mha_block_fwd(*args, HEADS, seeds, RATE)
        for plan in bf16_fwd_plans(B, T, D, HEADS):
            run = bf16_fwd_runner(args, HEADS, seeds, RATE, plan)
            parts = by_kernel(run)
            emit(direction="forward", dtype="bf16", shape=[B, T, D], plan=plan._asdict(),
                 default=plan == default, drop_rate=RATE, device_ms=sum(parts.values()),
                 by_kernel=parts, equal_bits_to_default=all(
                     torch.equal(a_, b_) for a_, b_ in zip(run(), ref)))
        from vslnet_torch.bench.conv_plans import _Renamed

        lib, at = stamped
        lib.mprof_read.argtypes = [ctypes.c_void_p]
        lib.mprof_mha_block_fwd_bf16.argtypes = K._SIGNATURES["vsl_mha_block_fwd_bf16"]
        lib.mprof_mha_block_fwd_bf16.restype = ctypes.c_int
        stamps = (ctypes.c_ulonglong * 64)()
        run = bf16_fwd_runner(args, HEADS, seeds, RATE, default,
                              _Renamed(lib, "mprof"))
        run()
        torch.cuda.synchronize()
        lib.mprof_read(stamps)
        reps = 5
        for _ in range(reps):
            got = run()
        torch.cuda.synchronize()
        lib.mprof_read(stamps)
        emit(direction="forward", dtype="bf16", shape=[B, T, D], drop_rate=RATE,
             cta="x, y, z 0", cycles_to_each_stamp={
                 kernel: {"mha_block.cu:%d" % line: stamps[k] / reps for k, line in marks}
                 for kernel, marks in at.items()},
             stamped_equal_bits=all(torch.equal(a_, b_) for a_, b_ in zip(got, ref)))
    # #11b at path M, q, k, v in bf16
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 192, D)).astype(np.float32))
               .to(dev, bf) for _ in range(3))
    lens = list(rng.integers(1, 193, B - 1)) + [0]
    m = torch.from_numpy((np.arange(192)[None, :] < np.asarray(lens)[:, None])
                         .astype(np.float32)).to(dev)
    sd = torch.from_numpy(rng.integers(0, 1 << 23, (B, 1)).astype(np.float32)).to(dev)

    def whole():
        return K.launch_mha_fwd(q, k, v, m, HEADS, sd, RATE)

    parts = by_kernel(whole)
    emit(direction="forward", dtype="bf16", kernel="whole-T (#11b)", shape=[B, 192, D],
         drop_rate=RATE, device_ms=sum(parts.values()), by_kernel=parts,
         out_sha1=digest([whole().float()]))


def plain_residuals(args, seeds, rate):
    """qkv and att of the bf16 forward, computed by the plain ops (bf16(y .
    bf16(Wqkv) + bqkv) and `attention` at bf16): the same values whatever
    tree runs the backward."""
    import torch

    bf = torch.bfloat16
    x, mask, gam, beta, wqkv, bqkv = args[:6]
    D = x.shape[-1]
    y = K.site_dropout(K.layer_norm(x.float(), gam[0], beta[0]), seeds, 0x200, rate)
    qkv = (y.to(bf).float() @ wqkv.to(bf).float() + bqkv).to(bf)
    q, k, v = (t.contiguous() for t in qkv.float().split(D, dim=-1))
    return qkv, K.attention(q, k, v, mask, HEADS, seeds, rate, dtype=bf)


def backward_bf16(emit, rng, dev, only_by_kernel):
    """The --bf16 rows (module docstring)."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    tc = hasattr(K, "mha_bwd_bf16_plan")
    stamped = None
    if tc and not only_by_kernel:
        src, at = bf16_stamped((K.CSRC / "mha_block.cu").read_text(), BF16_BWD_STAMPS)
        stamped = (build_copy("mha_bwd_bf16_prof", src), at)
    bound = getattr(common, "mha_bwd_bf16_bound", None)
    for T in (128, 12):
        x, mask, gam, beta, wqkv, bqkv, wd, bd, seeds, g = inputs(rng, dev, T)
        args = [x.to(bf), mask, gam, beta, wqkv, bqkv, wd, bd]
        lens = mask.sum(dim=1)
        keys = int(torch.where(lens > 0, lens, torch.full_like(lens, T)).sum())
        gb = g.to(bf)
        for rate in (0.0, RATE):
            sd = seeds if rate else None
            qkv, att = plain_residuals(args, sd, rate)

            def bwd():
                return K.launch_mha_block_bwd(args[0], mask, gam, beta, wqkv, wd, HEADS, sd,
                                              rate, qkv, att, gb)

            parts = by_kernel(bwd)
            emit(direction="backward", dtype="bf16", shape=[B, T, D], heads=HEADS,
                 drop_rate=rate, call_ms=cuda_ms(bwd), device_ms=sum(parts.values()),
                 by_kernel=parts, grads_sha1=digest([t.float() for t in bwd()]),
                 **({"plan": K.mha_bwd_bf16_plan(B, T, D, HEADS)._asdict()} if tc else {}),
                 **({"bound_ms": bound(B, T, D, keys)[0]} if bound else {}))
        # the parts' library calls in bf16, by device time: SDPA's backward
        # at [16, 8 heads, T, 16] with the key mask (forward + backward minus
        # forward), cuBLAS's g_z, g_y, dwd and dwqkv at their shapes
        qh, kh, vh = (torch.randn(B, HEADS, T, D // HEADS, device=dev, dtype=bf,
                                  requires_grad=True) for _ in range(3))
        am = mask.bool()[:, None, None, :]
        go = torch.randn(B, HEADS, T, D // HEADS, device=dev, dtype=bf)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)

        def sdpa_both():
            out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
            return torch.autograd.grad(out, (qh, kh, vh), go)

        a1, a3 = (torch.randn(B * T, n, device=dev, dtype=bf) for n in (D, 3 * D))
        w1, w3 = (torch.randn(D, n, device=dev, dtype=bf) for n in (D, 3 * D))
        emit(direction="backward", dtype="bf16", library="parts", shape=[B, T, D],
             sdpa_bwd_device_ms=sum(by_kernel(sdpa_both).values())
             - sum(by_kernel(sdpa_fwd).values()),
             cublas_g_z_device_ms=sum(by_kernel(lambda: a1 @ w1.t()).values()),
             cublas_g_y_device_ms=sum(by_kernel(lambda: a3 @ w3.t()).values()),
             cublas_dwd_device_ms=sum(by_kernel(lambda: a1.t() @ a1).values()),
             cublas_dwqkv_device_ms=sum(by_kernel(lambda: a1.t() @ a3).values()))
        if stamped is None:
            continue
        from vslnet_torch.bench.common import with_library
        from vslnet_torch.bench.conv_plans import _Renamed

        lib, at = stamped
        lib.mprof_read.argtypes = [ctypes.c_void_p]
        lib.mprof_mha_block_bwd_bf16.argtypes = K._SIGNATURES["vsl_mha_block_bwd_bf16"]
        lib.mprof_mha_block_bwd_bf16.restype = ctypes.c_int
        qkv, att = plain_residuals(args, seeds, RATE)

        def bwd():
            return K.launch_mha_block_bwd(args[0], mask, gam, beta, wqkv, wd, HEADS, seeds,
                                          RATE, qkv, att, gb)

        ref = bwd()
        stamps = (ctypes.c_ulonglong * 64)()
        run = lambda: with_library(_Renamed(lib, "mprof"), bwd)  # noqa: E731
        run()
        torch.cuda.synchronize()
        lib.mprof_read(stamps)
        reps = 5
        for _ in range(reps):
            got = run()
        torch.cuda.synchronize()
        lib.mprof_read(stamps)
        emit(direction="backward", dtype="bf16", shape=[B, T, D], drop_rate=RATE,
             cta="x, y, z 0", cycles_to_each_stamp={
                 kernel: {"mha_block.cu:%d" % line: stamps[k] / reps for k, line in marks}
                 for kernel, marks in at.items()},
             stamped_equal_bits=all(torch.equal(a_, b_) for a_, b_ in zip(got, ref)))
    # #12b at path M, q, k, v, g in bf16: its bits, which this redesign leaves
    q, k, v, gq = (torch.from_numpy(rng.standard_normal((B, 192, D)).astype(np.float32))
                   .to(dev, bf) for _ in range(4))
    lens = list(rng.integers(1, 193, B - 1)) + [0]
    m = torch.from_numpy((np.arange(192)[None, :] < np.asarray(lens)[:, None])
                         .astype(np.float32)).to(dev)
    sd = torch.from_numpy(rng.integers(0, 1 << 23, (B, 1)).astype(np.float32)).to(dev)
    out = K.launch_mha_fwd(q, k, v, m, HEADS, sd, RATE)

    def whole():
        return K.launch_mha_bwd(q, k, v, m, HEADS, sd, RATE, out, gq)

    parts = by_kernel(whole)
    emit(direction="backward", dtype="bf16", kernel="whole-T (#12b)", shape=[B, 192, D],
         drop_rate=RATE, device_ms=sum(parts.values()), by_kernel=parts,
         out_sha1=digest([out.float()]), grads_sha1=digest([t.float() for t in whole()]))


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

    if "--forward" in argv and "--bf16" in argv:
        forward_bf16(emit, rng, dev, only_by_kernel)
        return 0
    if "--bf16" in argv:
        backward_bf16(emit, rng, dev, only_by_kernel)
        return 0
    if "--forward" in argv:
        forward(emit, rng, dev, only_by_kernel)
        return 0
    if "--whole-t" in argv:
        whole_t_backward(emit, rng, dev, only_by_kernel)
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
             unfused_device_ms=unfused_device_ms, grads_sha1=digest(call()))
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
