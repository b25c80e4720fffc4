#!/usr/bin/env python3
"""The conv block's launch plans on the card (csrc/conv_block.cu, the
cluster kernels): the time of each, how many of its clusters the card
holds at once, the backward product's tile, where a call spends its time
by kernel, and where the backward spends its cycles.

    python3 -m vslnet_torch.bench.conv_plans

At [16, T, 128], drop_rate 0.2, for T = 128 (the main path), 145 (the
longest whole-row T) and 12 (the query stream):
- the forward on every plan of n CTAs a row (n <= 8, ceil(T / n)
  frames each) whose shared memory fits (`fwd_plans`), through the kernel
  library (`fwd_runner`): CUDA events over 20 calls after a warm-up and
  the device time (torch.profiler), whether its output equals
  conv_fwd_plan's bit for bit, and cudaOccupancyMaxActiveClusters for its
  clusters; at T = 128 and 12 the forward's and the T-tiled forward's
  device time by kernel and their calls' times;
- every plan of n CTAs a row (n <= 8, ceil(T / n) frames each) whose
  shared memory fits, through the kernel library: CUDA events over 20
  calls after a warm-up (the call: the kernel, the batch sum of its
  partials and the split-K dwp), dx's and dwp's largest difference from
  conv_plan's plan, and cudaOccupancyMaxActiveClusters for its clusters;
- at T = 128 and 12:
  - conv_plan's plan with the product's tile changed (PRODUCT_TILES: rows
    an item, unroll of the k loop), from copies of conv_block.cu built into
    vslnet_torch/_build/bench/;
  - `launch_conv_block_bwd` and the T-tiled `launch_conv_block_bwd_tiled`
    at the same inputs, each call's device time by kernel (torch.profiler);
  - the cycles a call from each block or cluster barrier of the kernel to
    the next (thread 0 of CTA 0, summed over the layers), from a copy with
    a clock stamp after each, keyed by the barrier's line in conv_block.cu.
Prints one JSON line a row with the card's name and power limit. The
shipped kernel carries no instrumentation.

    python3 -m vslnet_torch.bench.conv_plans --tiled [--by-kernel]

The T-tiled forward and backward (one launch a layer on
conv_tiled_fwd_plan and conv_tiled_bwd_plan) at path L's [8, 1024, 128],
path M's [16, 192, 128] and the main path's [16, 128, 128]. The forward
at drop_rate 0 and 0.2: `launch_conv_block_fwd_tiled`'s device time by
kernel (torch.profiler) and the call's time (CUDA events), beside the
whole-row forward's at T = 128; then every plan of `tiled_fwd_plans` (each
frame count of CONV_TILED_FRAMES with each product tile) through the
kernel library (`tiled_fwd_runner`): device time, events and whether its
output is the default plan's bit for bit, and the cycles a call between
its barriers and phases (thread 0 of tile 1 of row 0, summed over the
layers) from a stamped copy. The backward at drop_rate 0.2:
`launch_conv_block_bwd_tiled`'s device time by kernel
(torch.profiler) and the call's time (CUDA events), beside the whole-row
backward's at T = 128; then every plan of `tiled_bwd_plans` (each frame
count of CONV_TILED_FRAMES with its weight slice) through the kernel
library (`tiled_bwd_runner`): device time, events, and the largest
difference from the default plan's gradients. With --by-kernel only the
wrapper's rows, which an older tree of the port also runs (put it on
PYTHONPATH), so that a change's breakdown can be set beside its parent's.

    python3 -m vslnet_torch.bench.conv_plans --tiled --bf16

The bf16 T-tiled forward (#2c) at path L's [8, 1024, 128], path M's [16,
192, 128] and the main path's [16, 128, 128]: `launch_conv_block_fwd_tiled`
on bf16 x by kernel (torch.profiler) at drop_rate 0 and 0.2, the call's
time (CUDA events), its output's sha1 and the bound (bench/common.py
conv_fwd_bf16_bound); on a tree with the tensor-core forward, each frame
count of CONV_TILED_FRAMES through the kernel library
(`tiled_bf16_fwd_runner`: device time, events, equal bits to the default
plan); and the cycles a call between the layer kernel's barriers and
phases (thread 0 of tile 1 of row 0, summed over the layers) from a
stamped copy standing in for the kernel library while the wrapper
launches it (the tensor-core kernel where conv_block.cu has it, else the
parent's FMA kernel). Then the bf16 T-tiled backward (#9c) at the same
shapes, drop_rate 0.2: the call's
device time by kernel (torch.profiler: the layers, the partials' sum,
the dwp product and its sum, the wrapper's own copies), its time by CUDA
events, and the cycles a call between the layer kernel's barriers and
phases (thread 0 of tile 1 of row 0, summed over the layers) from a
stamped copy of conv_block.cu standing in for the kernel library while
the wrapper launches it: the tensor-core kernel where conv_block.cu has
it, else the parent's (run an older tree by path with it on PYTHONPATH).

    python3 -m vslnet_torch.bench.conv_plans --bf16

The bf16 whole-row pair (#2b, #9b) at the query stream's [16, T, 128] for
T of ROW_BF16_T, drop_rate 0.2: the forward served and with the
backward's residuals (where the tree saves them), the backward, and the
tiled pair (#2c, #9c) at the same inputs, each by kernel (torch.profiler)
and by CUDA events; the pairs' device times side by side with the route a
training call takes, the backward's plan and bound (bench/common.py
conv_bwd_bf16_bound), the sha1 of the served output and of the
gradients; cuBLAS's g_d and dwp products of one layer in bf16; and on a
tree with the tensor-core backward, the cycles of a call between the
layer's barriers and phases (thread 0 of row 1's CTA, summed over the
layers) from a stamped copy standing in for the kernel library. An older
tree runs it by path with it on PYTHONPATH.

    python3 -m vslnet_torch.bench.conv_plans --route

Where conv_route should send a shape: at B = 16, 8, 4 and 1 rows and
T = 12 to 145 (where the whole-row kernels fit), D = 128, the device time
(torch.profiler) of the whole-row and the tiled forward at drop_rate 0
(serving) and of each pair, forward and backward, at 0.2 (training),
beside what conv_route answers for each.
"""
import ctypes
import json
import math
import sys

import numpy as np

from vslnet_torch.bench import common
from vslnet_torch.bench.common import build_copies, build_copy, by_kernel, card, cuda_ms
from vslnet_torch.ops import kernels as K

L, KS, D, B = 4, 7, 128, 16
# (rows an item, k-loop unroll): conv_block.cu's own first
PRODUCT_TILES = [(3, 4), (2, 1), (2, 4), (3, 1), (4, 1), (4, 4)]
BARRIERS = ("cluster.sync();", "__syncthreads();")


def fwd_plans(B, T, D, k):
    """The forward's plans this script times at [B, T, D] and k taps: n =
    1..8 CTAs a row of ceil(T / n) frames (ceil(T / frames) CTAs, none
    empty) whose shared memory fits, each once, as conv_fwd_plan gives
    them."""
    plans = []
    for n in range(1, K.CONV_CLUSTER + 1):
        frames = -(-T // n)
        n = -(-T // frames)
        plan = K.ConvPlan(n, frames, K._conv_fwd_smem_bytes(frames, D, k), B * n)
        if plan.smem <= K.MAX_SMEM_BYTES and plan not in plans:
            plans.append(plan)
    return plans


def fwd_runner(args, seeds, rate, plan):
    """A call of the forward kernel through the kernel library on `plan`,
    at args = (x, gam, beta, dw, wp, bp) (16-byte aligned) and per-row
    seeds: returns the output."""
    import torch

    x, gam, beta, dw, wp, bp = args
    (B, T, D), (L, k, _) = x.shape, dw.shape
    sp, thresh, scale = K._dropout_args("conv_plans", seeds, rate, B)
    out = torch.empty_like(x)

    def run():
        K._launch("conv_block_fwd", x.data_ptr(), gam.data_ptr(), beta.data_ptr(),
                  dw.data_ptr(), wp.data_ptr(), bp.data_ptr(), sp, thresh, scale,
                  out.data_ptr(), B, T, D, L, k, plan.n, plan.frames)
        return out
    return run


def tiled_fwd_plans(B, T, D, k):
    """The tiled forward's plans this script times at [B, T, D] and k taps:
    each frame count of CONV_TILED_FRAMES (cut to T) with its weight slice
    and each product tile of CONV_TILED_FWD_ROWS, where one fits, as
    conv_tiled_fwd_plan builds them."""
    plans = []
    for frames in sorted({min(T, f) for f in K.CONV_TILED_FRAMES}):
        sk = K._conv_tiled_fwd_slice(frames, D, k)
        if sk is not None:
            tiles = -(-T // frames)
            for rows in K.CONV_TILED_FWD_ROWS:
                plans.append(K.ConvTiledFwdPlan(
                    frames, tiles, sk, K._conv_tiled_fwd_smem_bytes(frames, D, k, sk),
                    B * tiles, rows))
    return plans


def tiled_fwd_runner(args, seeds, rate, plan, fn=None):
    """A call of the tiled forward on `plan` through fn (an entry point of
    vsl_conv_block_fwd_tiled's signature; the kernel library's by default),
    at args = (x, gam, beta, dw, wp, bp) (16-byte aligned) and per-row
    seeds: returns (out, xs)."""
    import torch

    x, gam, beta, dw, wp, bp = args
    (B, T, D), (L, k, _) = x.shape, dw.shape
    sp, thresh, scale = K._dropout_args("conv_plans", seeds, rate, B)
    out = torch.empty_like(x)
    xs = x.new_empty(max(L - 1, 1), B, T, D)
    fn = fn or K._library().vsl_conv_block_fwd_tiled

    def run():
        code = fn(x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
                  wp.data_ptr(), bp.data_ptr(), sp, thresh, scale, xs.data_ptr(),
                  out.data_ptr(), B, T, D, L, k, plan.frames, plan.slice, plan.product_rows,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError("conv_block_fwd_tiled launch failed: %d" % code)
        return out, xs
    return run


def tiled_bwd_plans(B, T, D, k):
    """The tiled backward's plans this script times at [B, T, D] and k taps:
    each frame count of CONV_TILED_FRAMES (cut to T) with its weight slice,
    where one fits, as conv_tiled_bwd_plan builds them."""
    plans = []
    for frames in sorted({min(T, f) for f in K.CONV_TILED_FRAMES}):
        sk = K._conv_tiled_slice(frames, D, k)
        if sk is not None:
            tiles = -(-T // frames)
            plans.append(K.ConvTiledBwdPlan(
                frames, tiles, sk, K._conv_tiled_bwd_smem_bytes(frames, D, k, sk),
                B * tiles, K._conv_tiled_rows(frames, D, k)))
    return plans


def tiled_bwd_runner(args, xs, seeds, rate, g, plan, fn=None, waves=None):
    """A call of the tiled backward on `plan` through fn (an entry point of
    vsl_conv_block_bwd_tiled's signature; the kernel library's by default),
    at args = (x, gam, beta, dw, wp, bp) (16-byte aligned), the forward's
    xs, per-row seeds and g, with the workspaces launch_conv_block_bwd_tiled
    allocates, dwp's split-K blocks filling the SMs `waves` times (the
    wrapper's CONV_TILED_WGRAD_WAVES by default): returns
    (dx, dsmall [L, 3 + K, D], dwp)."""
    import torch

    x, gam, beta, dw, wp, bp = args
    (B, T, D), (L, k, _) = x.shape, dw.shape
    sp, thresh, scale = K._dropout_args("conv_plans", seeds, rate, B)
    wpT = wp.transpose(1, 2).contiguous()
    dx = torch.empty_like(x)
    dsmall = x.new_empty(L, 3 + k, D)
    dwp = x.new_empty(L, D, D)
    d_ws, gp_ws = (x.new_empty(L, B, T, D) for _ in range(2))
    g_ws = torch.empty_like(x)
    part = x.new_empty(plan.ctas, L, 3 + k, D)
    splits = K._wgrad_splits(L, D, D, B * T, waves or K.CONV_TILED_WGRAD_WAVES)
    ws = x.new_empty(L * splits * D * D if splits > 1 else 1)
    fn = fn or K._library().vsl_conv_block_bwd_tiled

    def run():
        code = fn(x.data_ptr(), xs.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
                  wp.data_ptr(), wpT.data_ptr(), bp.data_ptr(), sp, thresh, scale,
                  g.data_ptr(), dx.data_ptr(), dsmall.data_ptr(), dwp.data_ptr(),
                  d_ws.data_ptr(), gp_ws.data_ptr(), g_ws.data_ptr(), part.data_ptr(),
                  ws.data_ptr(), splits, B, T, D, L, k, plan.frames, plan.slice,
                  plan.product_rows, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError("conv_block_bwd_tiled launch failed: %d" % code)
        return dx, dsmall, dwp
    return run


# threads a CTA of the tiled backward: the kernel's own first
# (csrc/conv_block.cu kTiledThreads)
TILED_THREADS = [512, 384, 640]


def with_tiled_threads(src, threads):
    """csrc/conv_block.cu with the tiled backward's threads a CTA set to
    `threads`."""
    line = "constexpr int kTiledThreads = %d;"
    if src.count(line % TILED_THREADS[0]) != 1:
        raise RuntimeError("not found once in conv_block.cu: %r" % (line % TILED_THREADS[0]))
    return src.replace(line % TILED_THREADS[0], line % threads)


def instrumented_tiled(src, kernel="bwd"):
    """(csrc/conv_block.cu with a clock stamp, thread 0 of the CTA of tile 1
    of row 0, at each block barrier of conv_layer_<kernel>_tiled_kernel (at
    "bwd_tc", of the layer it runs, conv_bwd_tc_layer, which the bf16
    whole-row backward runs too: there thread 0 of row 1's CTA, every
    layer) and at the first line of each comment that opens a phase, and
    for the forward after its last statement, its entry points renamed
    tprof_, the conv_block.cu line of each stamp)."""
    lines = src.split("\n")
    orig = list(lines)
    head = ("conv_bwd_tc_layer(const " if kernel == "bwd_tc" and
            "conv_bwd_tc_layer(const " in src else "conv_layer_%s_tiled_kernel(const " % kernel)
    first = next(i for i, s in enumerate(lines) if s.startswith(head))
    last = lines.index("}", first)
    stamp = (" { if (threadIdx.x == 0 && blockIdx.x == 1 && blockIdx.y == 0) { long long "
             "now = clock64(); g_prof[%d] += now - plast; plast = now; } }")
    at = []
    for i in range(first, last):
        code = lines[i].split("//")[0]
        opens = orig[i].startswith("  // ") and not orig[i - 1].startswith("  //")
        if "__syncthreads();" in code or opens or (kernel.startswith("fwd") and i == last - 1):
            lines[i] = code.rstrip() + stamp % len(at)
            at.append(i + 1)
    body_open = next(i for i in range(first, last) if lines[i].endswith(") {"))
    lines[body_open] += "\n  long long plast = clock64();"
    src = "\n".join(lines).replace(
        '#include "hash.cuh"\n', '#include "hash.cuh"\n'
        "__device__ unsigned long long g_prof[64];\n", 1)
    return renamed(src, "tprof") + r'''
extern "C" int tprof_read(unsigned long long* h) {
  const int err = (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));
  unsigned long long z[64] = {0};
  return err ? err : (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
''', at


def stamp_cycles(run, read, stamped, reps=5):
    """{conv_block.cu:line: cycles a call} of a stamped copy's run, read by
    its tprof_read, over reps calls after one."""
    import torch

    stamps = (ctypes.c_ulonglong * 64)()
    run()
    torch.cuda.synchronize()
    read(stamps)
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    read(stamps)
    return {"conv_block.cu:%d" % line: stamps[k] / reps for k, line in enumerate(stamped)}


def tiled_main(argv):
    """The --tiled rows (module docstring)."""
    import torch

    smi = card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    if "--by-kernel" not in argv:
        from vslnet_torch.bench.common import build_copies  # absent from older trees

        src = (K.CSRC / "conv_block.cu").read_text()
        prof_src, stamped = instrumented_tiled(src)
        fwd_prof_src, fwd_stamped = instrumented_tiled(src, "fwd")
        tags = {n: "tiled%d" % n for n in TILED_THREADS[1:]}
        libs = build_copies({"tiled_prof": prof_src, "tiled_fwd_prof": fwd_prof_src,
                             **{tag: renamed(with_tiled_threads(src, n), tag)
                                for n, tag in tags.items()}})
        fwd_prof = libs["tiled_fwd_prof"]
        fwd_prof.tprof_conv_block_fwd_tiled.argtypes = K._SIGNATURES["vsl_conv_block_fwd_tiled"]
        fwd_prof.tprof_conv_block_fwd_tiled.restype = ctypes.c_int
        fwd_prof.tprof_read.argtypes = [ctypes.c_void_p]
        fwd_prof.tprof_read.restype = ctypes.c_int
        thread_fns = {n: getattr(libs[tag], tag + "_conv_block_bwd_tiled")
                      for n, tag in tags.items()}
        prof = libs["tiled_prof"]
        fns = [*thread_fns.values(), prof.tprof_conv_block_bwd_tiled]
        for fn in fns:
            fn.argtypes = K._SIGNATURES["vsl_conv_block_bwd_tiled"]
            fn.restype = ctypes.c_int
        prof.tprof_read.argtypes = [ctypes.c_void_p]
        prof.tprof_read.restype = ctypes.c_int
    for B, T in ((8, 1024), (16, 192), (16, 128)):
        def emit(**row):
            print(json.dumps({"bench": "conv_plans", "card": smi, "shape": [B, T, D],
                              "drop_rate": 0.2, **row}), flush=True)

        # biases of +-1 and a smaller pointwise product keep every
        # pre-activation ~1 from the ReLU's kink (tests/test_torch_cuda.py)
        args = [t(rng.standard_normal((B, T, D))), t(1 + 0.1 * rng.standard_normal((L, D))),
                t(0.1 * rng.standard_normal((L, D))),
                t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                t(0.1 * rng.standard_normal((L, D, D)) / math.sqrt(D)),
                t(np.where(rng.random((L, D)) < 0.5, -1.0, 1.0))]
        seeds = t(rng.integers(0, 1 << 23, (B, 1)))
        g = t(rng.standard_normal((B, T, D)))
        # the forward: the wrapper's call by kernel (at T = 128 beside the
        # whole-row forward's), then every plan of tiled_fwd_plans
        for rate in (0.0, 0.2):
            def fwd():
                return K.launch_conv_block_fwd_tiled(*args, seeds, rate)
            parts = by_kernel(fwd)
            row = {"call_ms": cuda_ms(fwd), "device_ms": sum(parts.values()),
                   "by_kernel": parts}
            if T == 128:
                def whole():
                    return K.launch_conv_block_fwd(*args, seeds, rate)
                whole_parts = by_kernel(whole)
                row.update(whole_row_ms=cuda_ms(whole),
                           whole_row_device_ms=sum(whole_parts.values()),
                           whole_row_by_kernel=whole_parts)
            emit(kernel="tiled forward", fwd_drop_rate=rate, **row)
            if "--by-kernel" in argv:
                continue
            default = K.conv_tiled_fwd_plan(B, T, D, KS, L)
            ref = fwd()[0].clone()
            for plan in tiled_fwd_plans(B, T, D, KS):
                run = tiled_fwd_runner(args, seeds, rate, plan)
                parts = by_kernel(run)
                emit(kernel="tiled forward", fwd_drop_rate=rate, plan=plan._asdict(),
                     default=plan == default, ms=cuda_ms(run),
                     device_ms=sum(parts.values()),
                     equal_to_default=bool(torch.equal(run()[0], ref)))
            run = tiled_fwd_runner(args, seeds, rate, default,
                                   fn=fwd_prof.tprof_conv_block_fwd_tiled)
            emit(kernel="tiled forward", fwd_drop_rate=rate, plan=default._asdict(),
                 cta="tile 1 of row 0",
                 cycles_to_each_stamp_over_the_layers=stamp_cycles(
                     run, fwd_prof.tprof_read, fwd_stamped))
        _, xs = K.launch_conv_block_fwd_tiled(*args, seeds, 0.2)

        def call():
            return K.launch_conv_block_bwd_tiled(args[0], xs, *args[1:], seeds, 0.2, g)
        parts = by_kernel(call)
        row = {"call_ms": cuda_ms(call), "device_ms": sum(parts.values()), "by_kernel": parts}
        if T == 128:
            def whole():
                return K.launch_conv_block_bwd(*args, seeds, 0.2, g)
            whole_parts = by_kernel(whole)
            row.update(whole_row_ms=cuda_ms(whole),
                       whole_row_device_ms=sum(whole_parts.values()),
                       whole_row_by_kernel=whole_parts)
        emit(kernel="tiled backward", **row)
        if "--by-kernel" in argv:
            continue
        default = K.conv_tiled_bwd_plan(B, T, D, KS, L)
        dx0, dgam, dbeta, ddw, dwp0, dbp = call()
        ref = (dx0, torch.cat([dgam[:, None], dbeta[:, None], dbp[:, None], ddw], 1), dwp0)

        def timed(run, **row):
            parts = by_kernel(run)
            diff = max(float((a - b).abs().max()) for a, b in zip(run(), ref))
            emit(kernel="tiled backward", ms=cuda_ms(run), device_ms=sum(parts.values()),
                 by_kernel=parts, max_abs_diff_from_default=diff, **row)
        for plan in tiled_bwd_plans(B, T, D, KS):
            timed(tiled_bwd_runner(args, xs, seeds, 0.2, g, plan), plan=plan._asdict(),
                  default=plan == default)
        for waves in (1, 2, 8):
            timed(tiled_bwd_runner(args, xs, seeds, 0.2, g, default, waves=waves),
                  plan=default._asdict(), wgrad_waves=waves)
        for rows in K.CONV_TILED_ROWS:
            plan = default._replace(product_rows=rows)
            timed(tiled_bwd_runner(args, xs, seeds, 0.2, g, plan), plan=plan._asdict())
            for n, fn in thread_fns.items():
                timed(tiled_bwd_runner(args, xs, seeds, 0.2, g, plan, fn=fn),
                      plan=plan._asdict(), threads=n)
        run = tiled_bwd_runner(args, xs, seeds, 0.2, g, default, fn=prof.tprof_conv_block_bwd_tiled)
        cycles = stamp_cycles(run, prof.tprof_read, stamped)
        emit(kernel="tiled backward", plan=default._asdict(), cta="tile 1 of row 0",
             cycles_to_each_stamp_over_the_layers=cycles, cycles_total=sum(cycles.values()))
    return 0


class _Renamed:
    """A stamped library's entry points under the kernel library's names
    (vsl_ -> tag_), so that the wrappers launch them."""

    def __init__(self, lib, tag):
        self.lib, self.tag = lib, tag

    def __getattr__(self, name):
        return getattr(self.lib, name.replace("vsl_", self.tag + "_", 1))


def tiled_bf16_fwd_runner(args, seeds, rate, frames, sn):
    """A call of the bf16 tiled forward's entry on `frames` frames a tile
    and slices of `sn` columns through the kernel library: (out, xs,
    mask)."""
    import torch

    x, gam, beta, dw, wp, bp = args
    B, T, D = x.shape
    L, KS = dw.shape[:2]
    sp, thresh, scale = K._dropout_args("conv_block_fwd_tiled_bf16", seeds, rate, B)
    wpb = wp.to(torch.bfloat16).contiguous()
    out, xs = torch.empty_like(x), torch.empty(max(L - 1, 1), B, T, D, device=x.device)
    mask = torch.empty(L, B, T, D // 4, device=x.device, dtype=torch.uint8)
    fn = K._library().vsl_conv_block_fwd_tiled_bf16

    def run():
        code = fn(x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
                  wpb.data_ptr(), bp.data_ptr(), sp, thresh, scale, xs.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), B, T, D, L, KS, frames, sn,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError("vsl_conv_block_fwd_tiled_bf16: error %d" % code)
        return out, xs, mask
    return run


def tiled_bf16_main():
    """The --tiled --bf16 rows (module docstring)."""
    import hashlib

    import torch

    smi = card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    src = (K.CSRC / "conv_block.cu").read_text()
    kernel = "bwd_tc" if "conv_layer_bwd_tc_tiled_kernel(const " in src else "bwd"
    fwd_kernel = "fwd_tc" if "conv_layer_fwd_tc_tiled_kernel(const " in src else "fwd"
    prof_src, stamped = instrumented_tiled(src, kernel)
    fprof_src, fstamped = instrumented_tiled(src, fwd_kernel)
    copies = build_copies({"tiled_bf16_prof": prof_src, "tiled_bf16_fwd_prof": fprof_src})
    prof, fprof = copies["tiled_bf16_prof"], copies["tiled_bf16_fwd_prof"]
    for lib in (prof, fprof):
        for name in ("conv_block_fwd_tiled_bf16", "conv_block_bwd_tiled_bf16"):
            fn = getattr(lib, "tprof_" + name)
            fn.argtypes = K._SIGNATURES["vsl_" + name]
            fn.restype = ctypes.c_int
        lib.tprof_read.argtypes = [ctypes.c_void_p]
        lib.tprof_read.restype = ctypes.c_int

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    bound = getattr(common, "conv_fwd_bf16_bound", None)
    fwd_plan = getattr(K, "conv_tiled_fwd_bf16_plan", K.conv_tiled_fwd_plan)
    # the forward (#2c): by kernel at drop 0 and 0.2, then its frames a tile
    # and stamps at 0.2
    for B, T in ((8, 1024), (16, 192), (16, 128)):
        args = [t(rng.standard_normal((B, T, D))).to(torch.bfloat16),
                t(1 + 0.1 * rng.standard_normal((L, D))),
                t(0.1 * rng.standard_normal((L, D))),
                t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                t(rng.standard_normal((L, D, D)) / math.sqrt(D)),
                t(0.1 * rng.standard_normal((L, D)))]
        seeds = t(rng.integers(0, 1 << 23, (B, 1)))
        plan = fwd_plan(B, T, D, KS, L)
        for rate in (0.0, 0.2):
            def call():
                return K.launch_conv_block_fwd_tiled(*args, seeds, rate)

            parts = by_kernel(call)
            out = call()
            print(json.dumps({
                "bench": "conv_plans", "card": smi, "kernel": "tiled forward bf16",
                "shape": [B, T, D], "drop_rate": rate, "plan": plan._asdict(),
                "device_ms": sum(parts.values()), "by_kernel": parts, "ms": cuda_ms(call),
                "out_sha1": hashlib.sha1(out[0].float().cpu().numpy().tobytes()).hexdigest(),
                **({"bound_ms": bound(B, T, D, KS, L)[0]} if bound else {})}), flush=True)
        want = [x.clone() for x in call()]
        if fwd_kernel == "fwd_tc":
            for frames in sorted({min(T, f) for f in K.CONV_TILED_FRAMES}):
                run = tiled_bf16_fwd_runner(args, seeds, 0.2, frames, plan.slice)
                parts = by_kernel(run)
                got = run()
                print(json.dumps({
                    "bench": "conv_plans", "card": smi, "kernel": "tiled forward bf16",
                    "shape": [B, T, D], "drop_rate": 0.2, "frames": frames,
                    "default": frames == plan.frames, "device_ms": sum(parts.values()),
                    "ms": cuda_ms(run), "equal_bits_to_default": all(
                        torch.equal(a, b) for a, b in zip(got, want))}), flush=True)
        lib = K._library()
        K._LIB = _Renamed(fprof, "tprof")  # the stamped copy, through the wrapper
        try:
            cycles = stamp_cycles(call, fprof.tprof_read, fstamped)
            got = call()
            torch.cuda.synchronize()
        finally:
            K._LIB = lib
        print(json.dumps({
            "bench": "conv_plans", "card": smi, "kernel": "tiled forward bf16",
            "shape": [B, T, D], "drop_rate": 0.2, "cta": "tile 1 of row 0",
            "cycles_to_each_stamp_over_the_layers": cycles, "cycles_total": sum(cycles.values()),
            "stamped_equal_bits": all(torch.equal(a, b) for a, b in zip(want, got))}),
            flush=True)

    for B, T in ((8, 1024), (16, 192), (16, 128)):
        args = [t(rng.standard_normal((B, T, D))).to(torch.bfloat16),
                t(1 + 0.1 * rng.standard_normal((L, D))),
                t(0.1 * rng.standard_normal((L, D))),
                t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                t(0.1 * rng.standard_normal((L, D, D)) / math.sqrt(D)),
                t(np.where(rng.random((L, D)) < 0.5, -1.0, 1.0))]
        seeds = t(rng.integers(0, 1 << 23, (B, 1)))
        g = t(rng.standard_normal((B, T, D))).to(torch.bfloat16)
        saved = K.launch_conv_block_fwd_tiled(*args, seeds, 0.2)[1:]

        def call():
            return K.launch_conv_block_bwd_tiled(args[0], saved[0], *args[1:], seeds, 0.2, g,
                                                 *saved[1:])
        parts = by_kernel(call)
        plan = getattr(K, "conv_tiled_bwd_bf16_plan", K.conv_tiled_bwd_plan)(B, T, D, KS, L)
        row = {"bench": "conv_plans", "card": smi, "kernel": "tiled backward bf16",
               "shape": [B, T, D], "drop_rate": 0.2, "plan": plan._asdict(),
               "device_ms": sum(parts.values()), "by_kernel": parts, "ms": cuda_ms(call)}
        want = [x.clone() for x in call()]
        lib = K._library()
        K._LIB = _Renamed(prof, "tprof")  # the stamped copy, through the wrapper
        try:
            cycles = stamp_cycles(call, prof.tprof_read, stamped)
            got = call()
            torch.cuda.synchronize()
        finally:
            K._LIB = lib
        row.update(cta="tile 1 of row 0", cycles_to_each_stamp_over_the_layers=cycles,
                   cycles_total=sum(cycles.values()),
                   stamped_equal_bits=all(torch.equal(a, b) for a, b in zip(want, got)))
        print(json.dumps(row), flush=True)
    return 0


# the query stream's lengths the bf16 whole-row pair takes with a gradient
# (conv_route "block": T < CONV_TILED_PAIR_T), where it meets the tiled pair
ROW_BF16_T = (12, 24, 36, 47)


def row_bf16_main():
    """The --bf16 rows (module docstring)."""
    import hashlib
    import inspect

    import torch

    smi = card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    # a tree whose whole-row forward saves the backward's residuals
    res = "residuals" in inspect.signature(K.launch_conv_block_fwd).parameters
    src = (K.CSRC / "conv_block.cu").read_text()
    prof = stamped = None
    if "conv_block_bwd_tc_row_kernel(" in src:
        prof_src, stamped = instrumented_tiled(src, "bwd_tc")
        prof = build_copies({"row_bf16_prof": prof_src})["row_bf16_prof"]
        prof.tprof_conv_block_bwd_bf16.argtypes = K._SIGNATURES["vsl_conv_block_bwd_bf16"]
        prof.tprof_conv_block_bwd_bf16.restype = ctypes.c_int
        prof.tprof_read.argtypes = [ctypes.c_void_p]
        prof.tprof_read.restype = ctypes.c_int

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def emit(**row):
        print(json.dumps({"bench": "conv_plans", "card": smi, **row}), flush=True)

    def sha1(ts):
        return hashlib.sha1(b"".join(x.float().cpu().numpy().tobytes() for x in ts)).hexdigest()

    bound = getattr(common, "conv_bwd_bf16_bound", None)
    for T in ROW_BF16_T:
        args = [t(rng.standard_normal((B, T, D))).to(bf),
                t(1 + 0.1 * rng.standard_normal((L, D))),
                t(0.1 * rng.standard_normal((L, D))),
                t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                t(0.1 * rng.standard_normal((L, D, D)) / math.sqrt(D)),
                t(np.where(rng.random((L, D)) < 0.5, -1.0, 1.0))]
        seeds = t(rng.integers(0, 1 << 23, (B, 1)))
        g = t(rng.standard_normal((B, T, D))).to(bf)

        def served():
            return K.launch_conv_block_fwd(*args, seeds, 0.2)

        def fwd():  # with the backward's residuals, where the tree saves them
            return K.launch_conv_block_fwd(*args, seeds, 0.2, True) if res else served()

        saved = fwd()[1:] if res else ()

        def bwd():
            return K.launch_conv_block_bwd(*args, seeds, 0.2, g, *saved)

        saved_t = K.launch_conv_block_fwd_tiled(*args, seeds, 0.2)[1:]

        def fwd_t():
            return K.launch_conv_block_fwd_tiled(*args, seeds, 0.2)

        def bwd_t():
            return K.launch_conv_block_bwd_tiled(args[0], saved_t[0], *args[1:], seeds, 0.2,
                                                 g, *saved_t[1:])

        ms = {}
        for name, fn in (("fwd_served", served), ("fwd", fwd), ("bwd", bwd),
                         ("fwd_tiled", fwd_t), ("bwd_tiled", bwd_t)):
            parts = by_kernel(fn)
            ms[name] = sum(parts.values())
            emit(kernel="whole-row bf16 " + name, shape=[B, T, D], drop_rate=0.2,
                 device_ms=ms[name], by_kernel=parts, ms=cuda_ms(fn))
        plan = getattr(K, "conv_bwd_bf16_plan", K.conv_plan)(B, T, D, KS, L)
        emit(kernel="whole-row bf16 pair against the tiled pair", shape=[B, T, D],
             drop_rate=0.2, plan=plan._asdict(), whole_pair_device_ms=ms["fwd"] + ms["bwd"],
             tiled_pair_device_ms=ms["fwd_tiled"] + ms["bwd_tiled"],
             route_train=K.conv_route(T, D, KS, L, True, bf),
             out_sha1=sha1([served()]), grads_sha1=sha1(bwd()),
             **({"bound_ms": bound(B, T, D, KS, L)[0]} if bound else {}))
        # the parts' library calls in bf16 at this T, a layer each: cuBLAS's
        # g_d = g_p . wp^T and dwp = d^T . g_p
        a = torch.randn(B * T, D, device=dev, dtype=bf)
        w = torch.randn(D, D, device=dev, dtype=bf)
        emit(kernel="whole-row bf16 backward", library="parts", shape=[B, T, D],
             cublas_g_d_device_ms_a_layer=sum(by_kernel(lambda: a @ w.t()).values()),
             cublas_dwp_device_ms_a_layer=sum(by_kernel(lambda: a.t() @ a).values()))
        if prof is None:
            continue
        want = [x.clone() for x in bwd()]
        lib = K._library()
        K._LIB = _Renamed(prof, "tprof")  # the stamped copy, through the wrapper
        try:
            cycles = stamp_cycles(bwd, prof.tprof_read, stamped)
            got = bwd()
            torch.cuda.synchronize()
        finally:
            K._LIB = lib
        emit(kernel="whole-row bf16 backward", shape=[B, T, D], drop_rate=0.2,
             cta="row 1", cycles_to_each_stamp_over_the_layers=cycles,
             cycles_total=sum(cycles.values()),
             stamped_equal_bits=all(torch.equal(a_, b_) for a_, b_ in zip(want, got)))
    return 0


def renamed(src, tag):
    """src with its entry points renamed vsl_ -> <tag>_."""
    return src.replace('extern "C" int vsl_', 'extern "C" int %s_' % tag)


def with_tile(src, rows, unroll):
    """csrc/conv_block.cu with the product's tile set to (rows, unroll)."""
    for name, old, new in zip(("kGemmRows", "kGemmUnroll"), PRODUCT_TILES[0], (rows, unroll)):
        line = "constexpr int %s = %%d;" % name
        if src.count(line % old) != 1:
            raise RuntimeError("not found once in conv_block.cu: %r" % (line % old))
        src = src.replace(line % old, line % new)
    return src


def instrumented(src):
    """(csrc/conv_block.cu with a clock stamp after every barrier of the
    cluster kernel and a helper that reports how many clusters fit, the
    conv_block.cu line of each stamp's barrier)."""
    lines = src.split("\n")
    head = "conv_block_bwd_cluster_kernel(const float* __restrict__ x"
    first = next(i for i, s in enumerate(lines) if s.startswith(head))
    last = lines.index("}", first)
    stamp = (" { if (threadIdx.x == 0 && blockIdx.x == 0) { long long now = "
             "clock64(); g_prof[%d] += now - plast; plast = now; } }")
    at = []
    for i in range(first, last):
        code = lines[i].split("//")[0]
        if any(b in code for b in BARRIERS):
            lines[i] = code.rstrip() + stamp % len(at)
            at.append(i + 1)
    body_open = next(i for i in range(first, last) if lines[i].endswith(") {"))
    lines[body_open] += "\n  long long plast = clock64();"
    src = "\n".join(lines).replace(
        '#include "hash.cuh"\n', '#include "hash.cuh"\n'
        "__device__ unsigned long long g_prof[64];\n", 1)
    return src + r'''
extern "C" int prof_read(unsigned long long* h) {
  const int err = (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));
  unsigned long long z[64] = {0};
  return err ? err : (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
extern "C" int prof_clusters(int N, int smem, int fwd_frames) {
  // the backward's kernel, or the forward's for fwd_frames frames a CTA
  const void* fn = fwd_frames == 0 ? (const void*)conv_block_bwd_cluster_kernel
                   : fwd_frames <= 16 ? (const void*)conv_block_fwd_cluster_kernel<2>
                                      : (const void*)conv_block_fwd_cluster_kernel<3>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e) return -(int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16 * N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int c = -1;
  e = cudaOccupancyMaxActiveClusters(&c, fn, &cfg);
  return e ? -(int)e : c;
}
''', at


ROUTE_BS = (16, 8, 4, 1)
ROUTE_TS = (12, 24, 32, 48, 64, 96, 128, 145)


def route_main():
    """The --route rows (module docstring)."""
    import torch

    smi = card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    for B in ROUTE_BS:
        for T in ROUTE_TS:
            args = [t(rng.standard_normal((B, T, D))), t(1 + 0.1 * rng.standard_normal((L, D))),
                    t(0.1 * rng.standard_normal((L, D))),
                    t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
                    t(0.1 * rng.standard_normal((L, D, D)) / math.sqrt(D)),
                    t(np.where(rng.random((L, D)) < 0.5, -1.0, 1.0))]
            seeds = t(rng.integers(0, 1 << 23, (B, 1)))
            g = t(rng.standard_normal((B, T, D)))

            def block_pair():
                K.launch_conv_block_fwd(*args, seeds, 0.2)
                return K.launch_conv_block_bwd(*args, seeds, 0.2, g)

            def tiled_pair():
                _, xs = K.launch_conv_block_fwd_tiled(*args, seeds, 0.2)
                return K.launch_conv_block_bwd_tiled(args[0], xs, *args[1:], seeds, 0.2, g)
            ms = {name: sum(by_kernel(fn).values()) for name, fn in (
                ("block_fwd", lambda: K.launch_conv_block_fwd(*args)),
                ("tiled_fwd", lambda: K.launch_conv_block_fwd_tiled(*args)),
                ("block_pair", block_pair), ("tiled_pair", tiled_pair))}
            print(json.dumps({"bench": "conv_plans", "card": smi, "shape": [B, T, D],
                              "device_ms": ms, "route_serve": K.conv_route(T, D, KS, L),
                              "route_train": K.conv_route(T, D, KS, L, grad=True)}),
                  flush=True)
    return 0


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("conv_plans: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--tiled" in argv and "--bf16" in argv:
        return tiled_bf16_main()
    if "--bf16" in argv:
        return row_bf16_main()
    if "--tiled" in argv:
        return tiled_main(argv)
    if "--route" in argv:
        return route_main()
    smi = card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    src = (K.CSRC / "conv_block.cu").read_text()
    prof_src, stamped = instrumented(src)
    prof_lib = build_copy("conv_prof", renamed(prof_src, "prof"))
    prof_lib.prof_read.argtypes = [ctypes.c_void_p]
    prof_lib.prof_read.restype = ctypes.c_int
    prof_lib.prof_clusters.argtypes = [ctypes.c_int] * 3
    prof_lib.prof_clusters.restype = ctypes.c_int
    fns = {"vsl": K._library().vsl_conv_block_bwd,
           "prof": prof_lib.prof_conv_block_bwd}
    for tile in PRODUCT_TILES[1:]:
        tag = "tile%d%d" % tile
        fns[tag] = getattr(build_copy(tag, renamed(with_tile(src, *tile), tag)),
                           tag + "_conv_block_bwd")
    for fn in fns.values():
        fn.argtypes = K._SIGNATURES["vsl_conv_block_bwd"]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    for T in (128, 145, 12):
        def emit(**row):
            print(json.dumps({"bench": "conv_plans", "card": smi, "shape": [B, T, D],
                              **row}), flush=True)

        x, gam, beta, dw, wp, bp = args = [
            t(rng.standard_normal((B, T, D))), t(1 + 0.1 * rng.standard_normal((L, D))),
            t(0.1 * rng.standard_normal((L, D))),
            t(rng.standard_normal((L, KS, D)) / math.sqrt(KS)),
            t(rng.standard_normal((L, D, D)) / math.sqrt(D)),
            t(0.1 * rng.standard_normal((L, D)))]
        seeds = t(rng.integers(0, 1 << 23, (B, 1)))
        g = t(rng.standard_normal((B, T, D)))
        # the forward's plans
        fwd_ref = K.launch_conv_block_fwd(*args, seeds, 0.2)
        fwd_default = K.conv_fwd_plan(B, T, D, KS, L)
        for plan in fwd_plans(B, T, D, KS):
            fwd = fwd_runner(args, seeds, 0.2, plan)
            emit(kernel="forward", n=plan.n, frames=plan.frames, ctas=plan.ctas,
                 smem=plan.smem, default=plan == fwd_default, ms=cuda_ms(fwd),
                 device_ms=sum(by_kernel(fwd).values()),
                 equal_to_default=bool(torch.equal(fwd(), fwd_ref)),
                 max_active_clusters=prof_lib.prof_clusters(plan.n, plan.smem, plan.frames))
        if T != 145:
            def fwd():
                return K.launch_conv_block_fwd(*args, seeds, 0.2)

            def tiled():
                return K.launch_conv_block_fwd_tiled(*args, seeds, 0.2)
            emit(kernel="forward", n=fwd_default.n, ms=cuda_ms(fwd), by_kernel=by_kernel(fwd),
                 tiled_ms=cuda_ms(tiled), tiled_by_kernel=by_kernel(tiled))
        ref = K.launch_conv_block_bwd(*args, seeds, 0.2, g)
        default = K.conv_plan(B, T, D, KS, L)
        wpT = wp.transpose(1, 2).contiguous()
        dx, dsmall, dwp = (torch.empty_like(x), torch.empty(L, 3 + KS, D, device=dev),
                           torch.empty(L, D, D, device=dev))
        d_ws, gp_ws = (torch.empty(L, B, T, D, device=dev) for _ in range(2))
        splits = K._wgrad_splits(L, D, D, B * T)
        ws = torch.empty(max(1, L * splits * D * D), device=dev)
        thresh = K.drop_threshold(0.2)

        def runner(fn, n, frames):
            part = torch.empty(B * n, L, 3 + KS, D, device=dev)

            def run():
                code = fn(x.data_ptr(), gam.data_ptr(), beta.data_ptr(), dw.data_ptr(),
                          wp.data_ptr(), wpT.data_ptr(), bp.data_ptr(), seeds.data_ptr(),
                          thresh, 1.0 / 0.8, g.data_ptr(), dx.data_ptr(), dsmall.data_ptr(),
                          dwp.data_ptr(), d_ws.data_ptr(), gp_ws.data_ptr(), part.data_ptr(),
                          ws.data_ptr(), splits, B, T, D, L, KS, n, frames, stream)
                if code:
                    raise RuntimeError("conv_block_bwd launch failed: %d" % code)
            return run

        def err():
            return max(float((dx - ref[0]).abs().max()), float((dwp - ref[4]).abs().max()))

        for n in range(1, K.CONV_CLUSTER + 1):
            frames = -(-T // n)
            smem = K._conv_smem_bytes(frames, D, KS, L)
            if -(-T // frames) != n or smem > K.MAX_SMEM_BYTES:
                continue
            ms = cuda_ms(runner(fns["vsl"], n, frames))
            emit(n=n, frames=frames, ctas=B * n, smem=smem, default=n == default.n,
                 ms=ms, max_abs_diff_from_default=err(),
                 max_active_clusters=prof_lib.prof_clusters(n, smem, 0))
        if T == 145:
            continue
        for tile in PRODUCT_TILES:
            tag = "vsl" if tile == PRODUCT_TILES[0] else "tile%d%d" % tile
            ms = cuda_ms(runner(fns[tag], default.n, default.frames))
            emit(n=default.n, product_rows=tile[0], product_unroll=tile[1], ms=ms,
                 max_abs_diff_from_default=err())
        _, xs = K.launch_conv_block_fwd_tiled(*args, seeds, 0.2)
        emit(n=default.n, by_kernel=by_kernel(
                 lambda: K.launch_conv_block_bwd(*args, seeds, 0.2, g)),
             tiled_by_kernel=by_kernel(lambda: K.launch_conv_block_bwd_tiled(
                 x, xs, *args[1:], seeds, 0.2, g)))
        run = runner(fns["prof"], default.n, default.frames)
        run()
        torch.cuda.synchronize()
        stamps = (ctypes.c_ulonglong * 64)()
        prof_lib.prof_read(stamps)
        reps = 5
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        prof_lib.prof_read(stamps)
        cycles = {"conv_block.cu:%d" % line: stamps[k] / reps
                  for k, line in enumerate(stamped)}
        emit(n=default.n, cycles_to_each_barrier=cycles,
             cycles_total=sum(cycles.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
