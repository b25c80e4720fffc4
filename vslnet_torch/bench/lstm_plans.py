#!/usr/bin/env python3
"""The LSTM forward's launch plans on the card (csrc/lstm.cu): the time of
each, and where a step of it spends its cycles.

    python3 -m vslnet_torch.bench.lstm_plans

For lstm_plan's default at the main path's [T, B=16, 4H=512] and its
neighbours (PLANS: n CTAs a cluster, bt rows a cluster, S lanes a unit,
threads a CTA), at T = 128 and path M's T = 192:
- the lean and the residual forward through the kernel library, CUDA
  events over 20 calls after a warm-up, and the lean output's error
  against the plain version;
- at T = 128, the cycles a step by phase, from a copy of csrc/lstm.cu
  built with clock stamps (thread 0 of CTA 0, a dot-product and a
  gate-math thread, summed over the T steps):
    wait             the mbarrier wait for h_t (the exchange's latency)
    dot              the lane's share of the four gate dots, all rows
    butterfly+gates  the lanes' shuffle sums and the gate math
    sends            the st.async stores of h_(t+1) into every CTA
    stores           the output (and residual) stores and the loop's tail
  with ns a step (%globaltimer) and the SM clock they imply.
Prints one JSON line a plan with the card's name and power limit, then the
host's µs a call of launch_lstm_fwd under the default plan. The shipped
kernel carries no instrumentation.

    python3 -m vslnet_torch.bench.lstm_plans --bf16

The bf16 LSTM kernels through their wrappers at B = 16, H = 128, T = 128
and path M's T = 192 (a full row, a row of 1, the rest ragged): the lean
forward (#1b, serving), the forward with residuals (#7b) and the backward
(#8b, from #7b's residuals), each call's device time (torch.profiler) and
CUDA events, beside the fp32 kernels on the same inputs, with the bound
at 3.35 TB/s of the bytes chip_smoke.py's rows count (bf16 x_proj, k_h,
dx_proj, dk_h; fp32 states and residuals). One JSON line a kernel and T.

    python3 -m vslnet_torch.bench.lstm_plans --bwd

The bf16 backward (#8b) at B = 16, H = 128, T = 128 and 192: the call's
device time by kernel (the chain, the dk_h product, its partials' sum,
the rounding), and the cycles a step by phase from a copy of csrc/lstm.cu
with clock stamps (thread 0 of CTA 0, the (unit 0, row 0) thread, summed
over the steps), built as the library it replaces for the call: the
tensor-core kernel's phases (BWD_TC_PHASES) where lstm.cu has it, else
the parent's fp32-FMA kernel's (BWD_PHASES), so that an older tree on
PYTHONPATH, run by path (`PYTHONPATH=<parent> python3
vslnet_torch/bench/lstm_plans.py --bwd`), gives its own.

    python3 -m vslnet_torch.bench.lstm_plans --fwd

The bf16 forwards (#1b lean, #7b with residuals) at B = 16, H = 128, T =
128 and 192, each call's device time by kernel, CUDA events, its error
against the twin and its cycles a step by phase from a stamped copy
(thread 0 of CTA 0, the (unit 0, row 0) thread, swapped in for the
wrapper's call): the tensor-core kernel's phases (FWD_TC_PHASES: wait,
mma, gates, sends, stores) where lstm.cu has it, else an older tree's
cluster kernel's (CLUSTER_PHASES), run by path as --bwd. Beside the
shipped kernel, the same for two copies of it: layout (a), K split
across the warps (SPLIT_K_FORM), and each k16 product as two m16n8k8
mma (`k8_`, tc_bwd_fp64.fwd_k8_source).
"""
import ctypes
import json
import math
import sys
import time

import numpy as np

from vslnet_torch.bench.common import build_copy, card, cuda_ms, with_library
from vslnet_torch.ops import kernels as K

# the cluster forward's step phases (the fp32 kernel, and the bf16 one of a
# tree before the tensor-core forward): stamps inserted before each anchor
# of its step loop, the phase named the one the stamp ends
CLUSTER_KERNEL = "lstm_fwd_cluster_kernel("
CLUSTER_PHASES = [
    ("wait", "    float nv = 0.f;\n    if (own && t + 1 < T) {"),
    ("dot", "    for (int off = S >> 1; off > 0; off >>= 1)\n#pragma unroll\n"
            "      for (int g = 0;"),
    ("butterfly+gates", "      if (t + 1 < T) {"),
    ("sends", "      const size_t o = (size_t)t * B + row;\n"),
    ("stores", "    v = nv;\n  }\n"),
]
PHASES = [name for name, _ in CLUSTER_PHASES]
# (n, bt, S, threads): lstm_plan's default at B=16, H=128 first
PLANS = [(8, 2, 8, 128), (8, 4, 16, 256), (8, 4, 8, 128), (8, 1, 8, 128),
         (8, 2, 4, 64), (8, 2, 16, 256), (4, 4, 4, 128)]
FWD_LOOP = "  uint32_t phase = 0;  // bit p: the parity of full[p]'s next phase\n\n  for (int t = 0;"


def stamped(src, head, phases, loop, step):
    """(src, a csrc/lstm.cu source, with clock stamps in the step loop of the
    kernel whose definition starts with `head`: before each phase's
    anchor (thread 0 of CTA 0, the first step's wait skipped; the step
    counter is `step`), and its ns between the loop's ends by
    %globaltimer into g_prof[8], prof_read added, the entry points kept;
    the phase names). Raises where an anchor is not found once in the
    kernel."""
    start = src.index(head)
    end = src.index("\n}\n", start) + 3
    body = src[start:end]

    def insert(anchor, text, after=False):
        nonlocal body
        if body.count(anchor) != 1:
            raise RuntimeError("anchor not found once in lstm.cu's %s: %r"
                               % (head.split("(")[0], anchor))
        body = body.replace(anchor, anchor + text if after else text + anchor)

    for k, (_, anchor) in enumerate(phases):
        insert(anchor, "    if (tid == 0 && blockIdx.x == 0) { unsigned long long now = "
               "clock64(); if (%d > 0 || %s > 0) pacc[%d] += now - plast; plast = now; }\n"
               % (k, step, k))
    insert(loop, "  unsigned long long pacc[8] = {0, 0, 0, 0, 0, 0, 0, 0}, plast = 0, pt0 = 0;\n"
           "  if (tid == 0 && blockIdx.x == 0) {\n"
           "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pt0));\n"
           "    plast = clock64();\n  }\n")
    body = body[:-2] + ("  if (tid == 0 && blockIdx.x == 0) {\n    unsigned long long pt1;\n"
                        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pt1));\n"
                        "    for (int k = 0; k < 8; ++k) g_prof[k] = pacc[k];\n"
                        "    g_prof[8] = pt1 - pt0;\n  }\n}\n")
    src = src[:start] + body + src[end:]
    src = src.replace('#include "common.cuh"\n', '#include "common.cuh"\n'
                      "__device__ unsigned long long g_prof[9];\n", 1)
    return src + ('\nextern "C" int prof_read(unsigned long long* h) {\n'
                  '  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n'), \
        [name for name, _ in phases]


def instrumented(src):
    """csrc/lstm.cu with clock stamps in the fp32 cluster forward's step loop
    (stamped, CLUSTER_PHASES) and its entry points renamed vsl_ -> prof_."""
    out, _ = stamped(src, CLUSTER_KERNEL, CLUSTER_PHASES, FWD_LOOP, "t")
    return out.replace('extern "C" int vsl_', 'extern "C" int prof_')


def build_instrumented():
    lib = build_copy("lstm_prof", instrumented((K.CSRC / "lstm.cu").read_text()))
    lib.prof_lstm_recurrence_fwd.argtypes = K._SIGNATURES["vsl_lstm_recurrence_fwd"]
    lib.prof_lstm_recurrence_fwd.restype = ctypes.c_int
    lib.prof_read.argtypes = [ctypes.c_void_p]
    lib.prof_read.restype = ctypes.c_int
    return lib


# the bf16 forwards' step phases on the tensor cores (lstm_fwd_tc_kernel)
FWD_TC_KERNEL = "lstm_fwd_tc_kernel(const __nv_bfloat16* __restrict__ xp"
FWD_TC_PHASES = [
    ("wait", "    unsigned short nx[4] = {0, 0, 0, 0};\n"),
    ("mma", "    float ig = 0.f, gg = 0.f, f = 0.f, og = 0.f,"),
    ("gates", "    if (t + 1 < T) {  // the warp's pieces of h_(t+1)"),
    ("sends", "    if (own) {  // the step's outputs, off the chain\n"),
    ("stores", "    v = nv;\n  }\n"),
]


def fwd_phases(src):
    """(kernel head, phases) of the bf16 forward in lstm.cu's source: the
    tensor-core kernel's, or an older tree's cluster kernel's."""
    return (FWD_TC_KERNEL, FWD_TC_PHASES) if FWD_TC_KERNEL in src else \
        (CLUSTER_KERNEL, CLUSTER_PHASES)


def instrumented_fwd(src):
    """stamped() of the bf16 forward's kernel (fwd_phases)."""
    return stamped(src, *fwd_phases(src), FWD_LOOP, "t")


# the bf16 backward's step phases: stamps inserted before each anchor of
# the kernel's step loop, the phase named the one the stamp ends
BWD_TC_KERNEL = "lstm_bwd_tc_kernel(const float* __restrict__ dy"
BWD_TC_PHASES = [
    ("wait", "    float nx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};\n"
             "    if (own && t > 0) load(t - 1, nx);"),
    ("loads", "    float dot = 0.f;\n    if (s > 0) {\n"),
    ("mma", "      // the products' sums in a fixed tree"),
    ("tree", "#pragma unroll\n      for (int mt = 0; mt < MT; ++mt) {\n"
             "        float* pw = part"),
    ("partials+barrier", "      if (own)\n#pragma unroll\n        for (int w = 0; w < W; ++w)"),
    ("sum", "    if (own) {\n      const float v = in[7]"),
    ("gates+dx_proj+stage", "    if (t > 0) {  // this CTA's chunks of dg_t"),
    ("barrier+sends", "#pragma unroll\n    for (int k = 0; k < 8; ++k) in[k] = nx[k];\n  }\n"),
]
BWD_KERNEL = "lstm_bwd_cluster_kernel(const float* __restrict__ dy"
BWD_PHASES = [
    ("wait", "    float nx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};\n"
             "    if (own && t > 0) load(t - 1, nx);"),
    ("loads", "    float acc[kBt];\n"),
    ("dot", "    for (int off = S >> 1; off > 0; off >>= 1)\n"),
    ("butterfly", "    float dg[4] = {0.f, 0.f, 0.f, 0.f};\n    if (own) {\n"),
    ("gates", "    // item i of the group's 4*kBt results"),
    ("shares+dx_proj+sends",
     "#pragma unroll\n    for (int k = 0; k < 8; ++k) in[k] = nx[k];\n  }\n"),
]
BWD_LOOP = "  uint32_t phase = 0;  // bit p: the parity of full[p]'s next phase\n\n  for (int s = 0;"


def bwd_phases(src):
    """(kernel head, phases) of the bf16 backward in lstm.cu's source."""
    return (BWD_TC_KERNEL, BWD_TC_PHASES) if BWD_TC_KERNEL in src else (BWD_KERNEL, BWD_PHASES)


def instrumented_bwd(src):
    """stamped() of the bf16 backward's kernel (bwd_phases)."""
    return stamped(src, *bwd_phases(src), BWD_LOOP, "s")


# layout (a) of the tensor-core forward, which the bench times beside the
# shipped layout (b) (PERF.md): K split across the warps as in the
# backward, each warp holding every m16 tile of the CTA's 4U gate rows
# (row gate U + unit) over its KS / W k16 steps, the warps' partials
# through shared memory and a block barrier, then the thread of (unit,
# column) adds them in warp order. Built for the main path's U = 16 (W =
# 4 warps) only, in place of fwd_tc_fragments and fwd_tc_gates.
SPLIT_K_FORM = r"""// The split-K form (bench copy): warp w holds every m16 tile of the 4U
// gate rows over k16 steps [w KS / W, (w + 1) KS / W).
constexpr int kSplitWarps = 4;
template <int KS>
__device__ __forceinline__ void fwd_tc_fragments(uint32_t (&a)[KS][4],
                                                 const __nv_bfloat16* __restrict__ kh, int H,
                                                 int uw) {
  constexpr int W = kSplitWarps, KSW = KS / W, U = 4 * W;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, G = 4 * H;
  const int warp = threadIdx.x >> 5, u0 = uw - kTcFwdWarpUnits * warp;
  const auto pair = [&](int m, int k) {
    const int gate = m / U, unit = u0 + m % U;
    uint32_t out = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (unit < H && k + e < H)
        out |= static_cast<uint32_t>(__bfloat16_as_ushort(kh[(size_t)(k + e) * G + gate * H + unit]))
               << (16 * e);
    return out;
  };
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int mt = i / KSW, k0 = 16 * (warp * KSW + i % KSW) + 2 * tq, m = 16 * mt + g;
    a[i][0] = pair(m, k0);
    a[i][1] = pair(m + 8, k0);
    a[i][2] = pair(m, k0 + 8);
    a[i][3] = pair(m + 8, k0 + 8);
  }
}

template <int KS>
__device__ __forceinline__ void fwd_tc_gates(float (&gate)[4], const uint32_t (&a)[KS][4],
                                             const __nv_bfloat16* hc) {
  constexpr int KST = TcFwdLayout<KS>::KST, W = kSplitWarps, KSW = KS / W, U = 4 * W;
  __shared__ float part[W][4 * U][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
  float d[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    uint32_t b[2];
    vsl::ldsm_x2(b, hc + (lane & 7) * KST + 16 * (warp * KSW + i % KSW) + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
    vsl::mma16(d[i], a[i], b[0], b[1]);
  }
#pragma unroll
  for (int mt = 0; mt < W; ++mt) {
#pragma unroll
    for (int w = 1; w < KSW; w *= 2)
#pragma unroll
      for (int kk = 0; kk + w < KSW; kk += 2 * w)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt * KSW + kk][e] += d[mt * KSW + kk + w][e];
    float* pw = &part[warp][16 * mt + g][2 * tq];
    pw[0] = d[mt * KSW][0];
    pw[1] = d[mt * KSW][1];
    pw[64] = d[mt * KSW][2];
    pw[65] = d[mt * KSW][3];
  }
  __syncthreads();
  const int ul = kTcFwdWarpUnits * warp + ((lane >> 2) & 3), col = 2 * tq + (lane >> 4);
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) sum += part[w][gi * U + ul][col];
    gate[gi] = sum;
  }
}

"""
SPLIT_K_START = "// The A fragments of a warp's tile"
SPLIT_K_END = "template <bool kResiduals, int KS>\n__global__ void __launch_bounds__(256)\nlstm_fwd_tc_kernel"


def split_k_source(src):
    """lstm.cu with layout (a), SPLIT_K_FORM, in place of the shipped
    fragments and product."""
    start, end = src.index(SPLIT_K_START), src.index(SPLIT_K_END)
    return src[:start] + SPLIT_K_FORM + src[end:]


def fwd_main(smi, dev):
    """The --fwd rows (module docstring)."""
    import torch

    from vslnet_torch.bench.common import build_copies, by_kernel, library_with

    src = (K.CSRC / "lstm.cu").read_text()
    copies = {"": instrumented_fwd(src)[0]}
    names = instrumented_fwd(src)[1]
    if FWD_TC_KERNEL in src:  # the layouts timed beside the shipped one
        from vslnet_torch.bench.tc_bwd_fp64 import fwd_k8_source

        copies["split_k_"] = instrumented_fwd(split_k_source(src))[0]
        copies["k8_"] = instrumented_fwd(fwd_k8_source(src))[0]
    built = build_copies({"lstm_fwd_prof_" + key.strip("_"): s.replace(
        'extern "C" int vsl_', 'extern "C" int fault_') for key, s in copies.items()})
    libs = {}  # key: (the library with the copy's two forwards, the copy)
    for key in copies:
        copy = built["lstm_fwd_prof_" + key.strip("_")]
        copy.prof_read.argtypes = [ctypes.c_void_p]
        copy.prof_read.restype = ctypes.c_int
        libs[key] = library_with(copy, ("lstm_recurrence_fwd_bf16",
                                        "lstm_recurrence_fwd_res_bf16")), copy
    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    B, H = 16, 128
    k_h = torch.from_numpy((rng.standard_normal((H, 4 * H)) / math.sqrt(H))
                           .astype(np.float32)).to(dev).to(bf)
    plan = getattr(K, "lstm_fwd_bf16_plan", K.lstm_plan)(B, H)
    for T in (128, 192):
        lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])
        x_proj = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(
            np.float32)).to(dev).to(bf)
        valid = torch.from_numpy((np.arange(T)[:, None] < lens[None, :])
                                 .astype(np.float32)).to(dev)
        ref = K.lstm_recurrence_plain(x_proj, k_h, valid)
        for name, call in (
                ("lstm_recurrence_fwd_bf16", lambda: [K.launch_lstm_fwd(x_proj, k_h, valid)]),
                ("lstm_recurrence_fwd_res_bf16",
                 lambda: list(K.launch_lstm_fwd_res(x_proj, k_h, valid)))):
            parts = by_kernel(call)
            want = [t.clone() for t in call()]
            row = {"bench": "lstm_plans", "card": smi, "kernel": name,
                   "shape": [T, B, 4 * H], "plan": plan._asdict(),
                   "device_ms": sum(parts.values()), "by_kernel": parts,
                   "ms": cuda_ms(call),
                   "max_abs_err": float((want[0] - ref).abs().max())}
            for key, (lib, copy) in libs.items():
                if key:  # another layout: its error, events and device time
                    got = with_library(lib, lambda: [t.clone() for t in call()])
                    row[key + "max_abs_err"] = float((got[0] - ref).abs().max())
                    row[key + "ms"] = with_library(lib, lambda: cuda_ms(call))
                    row[key + "device_ms"] = sum(with_library(
                        lib, lambda: by_kernel(call)).values())
                else:
                    got = with_library(lib, call)
                    row["stamped_equal_bits"] = all(
                        torch.equal(a, b) for a, b in zip(want, got))
                with_library(lib, lambda: [call() for _ in range(3)])
                torch.cuda.synchronize()
                stamps = (ctypes.c_ulonglong * 9)()
                if copy.prof_read(stamps):
                    raise RuntimeError("reading the stamps failed")
                row[key + "cycles_per_step"] = {
                    n: stamps[k] / (T - 1 if k == 0 else T) for k, n in enumerate(names)}
                row[key + "prof_ns_per_step"] = stamps[8] / T
                row[key + "sm_ghz"] = sum(stamps[k] for k in range(len(names))) / stamps[8]
            print(json.dumps(row), flush=True)
    return 0


def bwd_main(smi, dev):
    """The --bwd rows (module docstring): the stamped copy stands in for the
    kernel library while the wrapper launches it."""
    import torch

    from vslnet_torch.bench.common import by_kernel

    src, names = instrumented_bwd((K.CSRC / "lstm.cu").read_text())
    prof = build_copy("lstm_bwd_prof", src)
    entry = prof.vsl_lstm_recurrence_bwd_bf16
    entry.argtypes = K._SIGNATURES["vsl_lstm_recurrence_bwd_bf16"]
    entry.restype = ctypes.c_int
    prof.prof_read.argtypes = [ctypes.c_void_p]
    prof.prof_read.restype = ctypes.c_int
    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    B, H = 16, 128
    k_h = torch.from_numpy((rng.standard_normal((H, 4 * H)) / math.sqrt(H))
                           .astype(np.float32)).to(dev).to(bf)
    plan = getattr(K, "lstm_bwd_bf16_plan", K.lstm_plan)(B, H)
    for T in (128, 192):
        lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])
        x_proj = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(
            np.float32)).to(dev).to(bf)
        valid = torch.from_numpy((np.arange(T)[:, None] < lens[None, :])
                                 .astype(np.float32)).to(dev)
        dy = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
            np.float32)).to(dev)
        res = K.launch_lstm_fwd_res(x_proj, k_h, valid)[1:]

        def call():
            return K.launch_lstm_bwd(dy, *res, valid, k_h)
        parts = by_kernel(call)
        row = {"bench": "lstm_plans", "card": smi, "kernel": "lstm_recurrence_bwd_bf16",
               "shape": [T, B, 4 * H], "plan": plan._asdict(),
               "device_ms": sum(parts.values()), "by_kernel": parts, "ms": cuda_ms(call)}
        lib = K._library()
        K._LIB = prof  # the stamped copy, through the wrapper
        try:
            want = [t.clone() for t in call()]
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        finally:
            K._LIB = lib
        stamps = (ctypes.c_ulonglong * 9)()
        if prof.prof_read(stamps):
            raise RuntimeError("reading the stamps failed")
        row["cycles_per_step"] = {n: stamps[k] / (T - 1 if k == 0 else T)
                                  for k, n in enumerate(names)}
        row["prof_ns_per_step"] = stamps[8] / T
        row["sm_ghz"] = sum(stamps[k] for k in range(len(names))) / stamps[8]
        row["stamped_equal_bits"] = all(torch.equal(a, b) for a, b in zip(want, call()))
        print(json.dumps(row), flush=True)
    return 0


def bf16_main(smi, dev):
    """The --bf16 rows (module docstring)."""
    import torch

    from vslnet_torch.bench.common import by_kernel

    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    B, H = 16, 128
    k_h = torch.from_numpy((rng.standard_normal((H, 4 * H)) / math.sqrt(H))
                           .astype(np.float32)).to(dev)
    for T in (128, 192):
        lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])
        x_proj = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(
            np.float32)).to(dev)
        valid = torch.from_numpy((np.arange(T)[:, None] < lens[None, :])
                                 .astype(np.float32)).to(dev)
        dy = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
            np.float32)).to(dev)
        io, w, st = T * B * 4 * H, H * 4 * H, T * B * H
        calls = {}
        for dt in (bf, torch.float32):  # the fp32 kernels on the bf16 values
            xp, kh = x_proj.to(bf).to(dt), k_h.to(bf).to(dt)
            res = K.launch_lstm_fwd_res(xp, kh, valid)
            calls[dt] = {
                "lstm_recurrence_fwd": (
                    lambda xp=xp, kh=kh: K.launch_lstm_fwd(xp, kh, valid),
                    2 * (io + w) + 4 * (T * B + st)),
                "lstm_recurrence_fwd_res": (
                    lambda xp=xp, kh=kh: K.launch_lstm_fwd_res(xp, kh, valid),
                    2 * (io + w) + 4 * (T * B + 8 * st)),
                "lstm_recurrence_bwd": (
                    lambda kh=kh, res=res: K.launch_lstm_bwd(
                        dy, res[1], res[2], res[3], res[4], valid, kh),
                    4 * (T * B + 8 * st) + 2 * (2 * w + io))}
        for name, (fn, nbytes) in calls[bf].items():
            fn32 = calls[torch.float32][name][0]
            print(json.dumps({
                "bench": "lstm_plans", "card": smi, "kernel": name + "_bf16",
                "shape": [T, B, 4 * H],
                "device_ms": sum(by_kernel(fn).values()), "ms": cuda_ms(fn),
                "fp32_device_ms": sum(by_kernel(fn32).values()),
                "bound_ms": nbytes / 3.35e12 * 1e3, "bound_by": "bytes"}),
                flush=True)
    return 0


def main(argv=()):
    import torch

    if not torch.cuda.is_available():
        print("lstm_plans: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--bf16" in argv:
        return bf16_main(card(), torch.device("cuda"))
    if "--bwd" in argv:
        return bwd_main(card(), torch.device("cuda"))
    if "--fwd" in argv:
        return fwd_main(card(), torch.device("cuda"))
    prof = build_instrumented()
    smi = card()
    rng = np.random.default_rng(0)
    B, H = 16, 128
    dev = torch.device("cuda")
    default = K.lstm_plan(B, H)
    if PLANS[0] != (default.n, default.bt, default.splits, default.threads):
        raise RuntimeError("PLANS[0] is not lstm_plan's default: %s" % (default,))
    k_h = torch.from_numpy((rng.standard_normal((H, 4 * H)) / math.sqrt(H)).astype(
        np.float32)).to(dev)
    cases = {}
    for T in (128, 192):
        lens = np.concatenate([[T, 1], rng.integers(1, T + 1, B - 2)])
        x_proj = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(
            np.float32)).to(dev)
        valid = torch.from_numpy((np.arange(T)[:, None] < lens[None, :]).astype(
            np.float32)).to(dev)
        cases[T] = (x_proj, valid, K.lstm_recurrence_plain(x_proj, k_h, valid))
    stream = torch.cuda.current_stream().cuda_stream
    for plan in PLANS:
        row = {"bench": "lstm_plans", "card": smi, "B": B, "H": H,
               "n": plan[0], "bt": plan[1], "splits": plan[2],
               "threads": plan[3], "ctas": -(-B // plan[1]) * plan[0]}
        for T, (x_proj, valid, ref) in cases.items():
            out = torch.empty(T, B, H, device=dev)
            res = [torch.empty(T, B, G * H, device=dev) for G in (4, 1, 1, 1)]
            lean = (x_proj.data_ptr(), k_h.data_ptr(), valid.data_ptr(),
                    out.data_ptr(), T, B, H, *plan)
            full = (x_proj.data_ptr(), k_h.data_ptr(), valid.data_ptr(),
                    out.data_ptr(), *(r.data_ptr() for r in res), T, B, H, *plan)
            row["T%d_lean_ms" % T] = cuda_ms(
                lambda: K._launch("lstm_recurrence_fwd", *lean))
            row["T%d_lean_max_abs_err" % T] = float((out - ref).abs().max())
            row["T%d_res_ms" % T] = cuda_ms(
                lambda: K._launch("lstm_recurrence_fwd_res", *full))
            row["T%d_res_max_abs_err" % T] = float((out - ref).abs().max())
            row["T%d_lean_us_per_step" % T] = row["T%d_lean_ms" % T] * 1e3 / T
        T = 128
        x_proj, valid, _ = cases[T]
        out = torch.empty(T, B, H, device=dev)
        for _ in range(3):
            code = prof.prof_lstm_recurrence_fwd(
                x_proj.data_ptr(), k_h.data_ptr(), valid.data_ptr(),
                out.data_ptr(), T, B, H, *plan, stream)
            if code:
                raise RuntimeError("instrumented launch failed: %d" % code)
        torch.cuda.synchronize()
        stamps = (ctypes.c_ulonglong * 9)()
        if prof.prof_read(stamps):
            raise RuntimeError("reading the stamps failed")
        row["T128_cycles_per_step"] = {name: stamps[k] / (T - 1 if k == 0 else T)
                                       for k, name in enumerate(PHASES)}
        row["T128_prof_ns_per_step"] = stamps[8] / T
        row["sm_ghz"] = sum(stamps[k] for k in range(len(PHASES))) / stamps[8]
        print(json.dumps(row), flush=True)
    # the wrapper's host time a call, its one-time launch set-up done
    x_proj, valid, _ = cases[128]
    K.launch_lstm_fwd(x_proj, k_h, valid)
    torch.cuda.synchronize()
    calls = 200
    t0 = time.perf_counter()
    for _ in range(calls):
        K.launch_lstm_fwd(x_proj, k_h, valid)
    host_us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    print(json.dumps({"bench": "lstm_plans", "card": smi,
                      "launch_lstm_fwd_host_us_per_call": host_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
