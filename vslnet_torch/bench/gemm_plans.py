#!/usr/bin/env python3
"""The two bf16 products of csrc/mma.cuh on the card: tc_gemm and wgrad_wg
(wg_gemm_kernel, wgmma with operands by TMA), each at the `saturated`
configuration's shapes, timed beside cuBLAS's product of the same bf16
operands (torch.matmul, bf16 out; the port never calls it) and beside the
mma.sync form (wgrad_tc, whose k16 products are added by fp32 adds in k
order, as the tc_gemm of mma.sync did), and held to an fp64 product of the
same operands:

    python3 -m vslnet_torch.bench.gemm_plans
    PYTHONPATH=<older tree> python3 vslnet_torch/bench/gemm_plans.py

One JSON line a shape: ms by CUDA events and device ms by torch.profiler
(null where two profiles came back empty or below the bound: a lost
record), TFLOP/s, the bound at the bf16 peak, and fp64_reading (mean and
largest |C - C64| / (|A| |B|), fp64) of the kernel and of the mma.sync
form. With --faults, each of GEMM_FAULTS planted in a copy of the kernel
(csrc/gemm.cu with mma.cuh inlined and edited, built into
vslnet_torch/_build/bench/) and its verdict.
"""
import ctypes
import functools
import json
import sys

import numpy as np

from vslnet_torch.bench.common import (bound_ms, build_copies, build_copy, by_kernel, card,
                                       cuda_ms, edited_source, library_with, with_library)
from vslnet_torch.ops import kernels as K

# (name, M, N, K, bt): tc_gemm at `saturated`'s [256, 128, 1024] (M = B T)
# and its query stream's T = 12
PRODUCTS = [("g_d", 32768, 1024, 1024, True), ("g_y", 32768, 1024, 3072, True),
            ("qkv", 32768, 3072, 1024, False), ("pointwise", 32768, 1024, 1024, False),
            ("query", 3072, 1024, 1024, False), ("ragged", 3000, 1024, 1024, True),
            ("d896", 32768, 896, 896, False)]
# (name, Z, M, N, K): wgrad_wg's weight gradients there
WGRADS = [("dwp", 4, 1024, 1024, 32768), ("dwqkv", 1, 1024, 3072, 32768),
          ("dwd", 1, 1024, 1024, 32768), ("dwp_query", 4, 1024, 1024, 3072)]
# a kernel reads within this factor of the mma.sync form's distance from
# fp64, mean and largest
FP64_FACTOR = 1.25

MMA_SRC = r'''
#include "common.cuh"
#include "mma.cuh"
extern "C" int bench_wgrad_tc(const void* A, const void* B, float* C, float* P, int Z, int M,
                              int N, int K, int S, void* stream) {
  return (int)vsl::wgrad_tc(static_cast<const __nv_bfloat16*>(A),
                            static_cast<const __nv_bfloat16*>(B), C, P, Z, M, N, K, S,
                            static_cast<cudaStream_t>(stream));
}
'''

# faults planted in wg_gemm_kernel (mma.cuh inlined into a copy of gemm.cu),
# each of which the fp64 verdict must refuse; each anchor found once
GEMM_FAULTS = {
    # the stage of k-tile 1 loaded from past K: read as zeros
    "k_tile_skipped": ("const int k0 = kt * kGemmK;",
                       "const int k0 = kt == 1 ? K : kt * kGemmK;"),
    # the first chain of each item not added to the sums
    "chain_not_added": ("        for (int i = 0; i < 64; ++i) acc[i] += ch[i];\n      }\n"
                        "      if (kt < w.kt1) {",
                        "        for (int i = 0; i < 64; ++i) acc[i] += kt == w.kt0 ? 0.f : ch[i];\n"
                        "      }\n      if (kt < w.kt1) {"),
    # B's transpose bit flipped, with the other layout's descriptor (the
    # bit alone lets the K-major reading run past the ring)
    "b_transpose_flipped": (
        "db = kBT ? wg::desc(b + kk * 32, 16, 1024) : wg::desc(b + kk * 2048, kHalf, 1024);\n"
        "        wg::mma_128<kAT ? 1 : 0, kBT ? 0 : 1>",
        "db = kBT ? wg::desc(b + kk * 2048, kHalf, 1024) : wg::desc(b + kk * 32, 16, 1024);\n"
        "        wg::mma_128<kAT ? 1 : 0, kBT ? 1 : 0>"),
    # the last split's partial written as zeros
    "split_partial_dropped": ("make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);\n",
                              "w.s == S - 1 ? make_float2(0.f, 0.f) : "
                              "make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);\n"),
}
# the products each fault reaches: the split's partial only in wgrad_wg
FAULT_REACHES = {"k_tile_skipped": ("tc_gemm", "tc_gemm_bt", "wgrad"),
                 "chain_not_added": ("tc_gemm", "tc_gemm_bt", "wgrad"),
                 "b_transpose_flipped": ("tc_gemm", "tc_gemm_bt", "wgrad"),
                 "split_partial_dropped": ("wgrad",)}


@functools.lru_cache(maxsize=1)
def mma_library():
    """A library of the mma.sync weight product, wgrad_tc, on its own."""
    lib = build_copy("gemm_mma", MMA_SRC)
    lib.bench_wgrad_tc.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.bench_wgrad_tc.restype = ctypes.c_int
    return lib


def mma_wgrad(lib, a, b, splits):
    """C[z] = a[z]^T . b[z] (a [Z, K, M], b [Z, K, N] bf16) on wgrad_tc."""
    import torch

    Z, Kk, M = a.shape
    N = b.shape[2]
    c = torch.empty(Z, M, N, device=a.device)
    ws = torch.empty(max(1, Z * splits * M * N), device=a.device)
    code = lib.bench_wgrad_tc(a.data_ptr(), b.data_ptr(), c.data_ptr(), ws.data_ptr(), Z, M, N,
                              Kk, splits, torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError("wgrad_tc failed: %d" % code)
    return c


def mma_product(lib, a, b, bt):
    """a . b (or a . b^T) by the mma.sync form: wgrad_tc on a^T, one split,
    each k16 product added by fp32 adds in k order."""
    at = a.t().contiguous()[None]
    bk = (b.t() if bt else b).contiguous()[None]
    return mma_wgrad(lib, at, bk, 1)[0]


def fp64_reading(c, a, b, bt=False, batched=False):
    """{"mean", "max"} of |c - C64| / (|a| |b|) with C64 = a . b (b^T with
    bt; a[z]^T . b[z] when batched) in fp64 on the same bf16 operands."""
    import torch

    a64, b64 = a.double(), b.double()
    if batched:
        a64 = a64.transpose(1, 2)
    elif bt:
        b64 = b64.t()
    ref = torch.matmul(a64, b64)
    scale = torch.matmul(a64.abs(), b64.abs()).clamp_min(1e-300)
    r = (c.double() - ref).abs() / scale
    return {"mean": float(r.mean()), "max": float(r.max())}


def fp64_verdict(kernel, parent):
    """(ok, why): the kernel's fp64 reading within FP64_FACTOR of the
    mma.sync form's, mean and largest."""
    bad = [k for k in ("mean", "max") if not kernel[k] <= FP64_FACTOR * parent[k]]
    if bad:
        return False, "beyond the limits: %s %s against the mma.sync form's %s" % (
            bad, kernel, parent)
    return True, "within %g of the mma.sync form's distance" % FP64_FACTOR


@functools.lru_cache(maxsize=1)
def fault_libraries():
    """{fault: the kernel library with vsl_tc_gemm_bf16 and vsl_wgrad_bf16
    from the copy of csrc/gemm.cu that carries it}, one nvcc a fault, all
    started together."""
    copies = build_copies({"gemm_" + f: edited_source(f, "gemm.cu", [edit], ["mma.cuh"])
                           for f, edit in GEMM_FAULTS.items()})
    return {f: library_with(copies["gemm_" + f], ("tc_gemm_bf16", "wgrad_bf16"))
            for f in GEMM_FAULTS}


def operands(dev, rng, *shapes):
    """bf16 operands of the given shapes, standard normal draws."""
    import torch

    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, torch.bfloat16)
            for s in shapes]


def device_ms(fn, bound):
    """by_kernel's device ms a call of fn, the profile taken again once
    where it came back empty or below `bound` (a record lost, PERF.md §7);
    None, not measured, where the second came back so too."""
    for _ in range(2):
        ms = sum(by_kernel(fn).values())
        if ms >= bound:
            return ms
    return None


def tflops(flops, ms):
    return None if ms is None else flops / ms / 1e9


def product_row(dev, rng, lib, name, M, N, Kk, bt):
    import torch

    a, b = operands(dev, rng, (M, Kk), (N, Kk) if bt else (Kk, N))

    def kernel():
        return K.launch_tc_gemm_bf16(a, b, bt)

    def cublas():
        return torch.matmul(a, b.t() if bt else b)

    c = kernel()
    torch.cuda.synchronize()
    again = kernel()
    flops = 2 * M * N * Kk
    bound = bound_ms({"bf16": flops}, 2 * (M * Kk + N * Kk) + 4 * M * N)[0]
    ms = cuda_ms(kernel)
    dev_ms = device_ms(kernel, bound)
    row = {"kind": "tc_gemm", "name": name, "M": M, "N": N, "K": Kk, "bt": bt, "ms": ms,
           "device_ms": dev_ms, "tflops": tflops(flops, dev_ms), "bound_ms": bound,
           "library_ms": cuda_ms(cublas), "library_device_ms": device_ms(cublas, bound),
           "equal_bits_twice": bool(torch.equal(c, again)),
           "fp64_reading": fp64_reading(c, a, b, bt),
           "mma_fp64_reading": fp64_reading(mma_product(lib, a, b, bt), a, b, bt),
           "mma_ms": cuda_ms(lambda: mma_product(lib, a, b, bt))}
    row["fp64_verdict"] = fp64_verdict(row["fp64_reading"], row["mma_fp64_reading"])
    return row


def wgrad_row(dev, rng, lib, name, Z, M, N, Kk):
    import torch

    a, b = operands(dev, rng, (Z, Kk, M), (Z, Kk, N))
    S = K.wgrad_splits(Z, M, N, Kk)
    S_mma = K._wgrad_splits(Z, M, N, Kk)

    def kernel():
        return K.launch_wgrad_bf16(a, b, S)

    def cublas():
        return torch.matmul(a.transpose(1, 2), b)

    c = kernel()
    torch.cuda.synchronize()
    flops = 2 * Z * M * N * Kk
    bound = bound_ms({"bf16": flops}, 2 * Z * Kk * (M + N) + 4 * Z * M * N)[0]
    dev_ms = device_ms(kernel, bound)
    row = {"kind": "wgrad", "name": name, "Z": Z, "M": M, "N": N, "K": Kk, "splits": S,
           "ms": cuda_ms(kernel), "device_ms": dev_ms, "tflops": tflops(flops, dev_ms),
           "bound_ms": bound,
           "library_ms": cuda_ms(cublas), "library_device_ms": device_ms(cublas, bound),
           "equal_bits_twice": bool(torch.equal(c, kernel())),
           "fp64_reading": fp64_reading(c, a, b, batched=True),
           "mma_splits": S_mma,
           "mma_fp64_reading": fp64_reading(mma_wgrad(lib, a, b, S_mma), a, b, batched=True),
           "mma_ms": cuda_ms(lambda: mma_wgrad(lib, a, b, S_mma))}
    row["fp64_verdict"] = fp64_verdict(row["fp64_reading"], row["mma_fp64_reading"])
    return row


def fault_rows(dev, rng, lib):
    """Each planted fault's verdict at g_d's shape (tc_gemm, bt), the
    pointwise shape (no bt) and dwp's (wgrad_wg, two splits)."""
    out = []
    a, b = operands(dev, rng, (4096, 1024), (1024, 1024))
    wa, wb = operands(dev, rng, (4, 4096, 1024), (4, 4096, 1024))
    parent = {bt: fp64_reading(mma_product(lib, a, b, bt), a, b, bt) for bt in (False, True)}
    wparent = fp64_reading(mma_wgrad(lib, wa, wb, 2), wa, wb, batched=True)
    for fault, flib in fault_libraries().items():
        row = {"kind": "fault", "name": fault}
        for bt in (False, True):
            c = with_library(flib, lambda: K.launch_tc_gemm_bf16(a, b, bt))
            row["tc_gemm_bt" if bt else "tc_gemm"] = fp64_verdict(
                fp64_reading(c, a, b, bt), parent[bt])
        c = with_library(flib, lambda: K.launch_wgrad_bf16(wa, wb, 2))
        row["wgrad"] = fp64_verdict(fp64_reading(c, wa, wb, batched=True), wparent)
        out.append(row)
    return out


def main(argv):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    lib = mma_library()
    head = {"card": card(), "device": torch.cuda.get_device_name(0)}
    rows = [product_row(dev, rng, lib, *p) for p in PRODUCTS]
    rows += [wgrad_row(dev, rng, lib, *w) for w in WGRADS]
    if "--faults" in argv:
        rows += fault_rows(dev, rng, lib)
    for row in rows:
        print(json.dumps({**head, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
