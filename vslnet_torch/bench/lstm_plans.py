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
"""
import ctypes
import json
import math
import sys
import time

import numpy as np

from vslnet_torch.bench.common import build_copy, card, cuda_ms
from vslnet_torch.ops import kernels as K

PHASES = ["wait", "dot", "butterfly+gates", "sends", "stores"]
# (n, bt, S, threads): lstm_plan's default at B=16, H=128 first
PLANS = [(8, 2, 8, 128), (8, 4, 16, 256), (8, 4, 8, 128), (8, 1, 8, 128),
         (8, 2, 4, 64), (8, 2, 16, 256), (4, 4, 4, 128)]


def stamp(k, indent):
    return (indent + "if (tid == 0 && blockIdx.x == 0) { unsigned long long "
            "now = clock64(); if (%d > 0 || t > 0) pacc[%d] += now - plast; "
            "plast = now; }\n" % (k, k))


def instrumented(src):
    """csrc/lstm.cu with clock stamps before lines of its forward kernel's
    step loop (anchors long enough to miss the backward's like lines), and
    its entry points renamed vsl_ -> prof_."""
    def insert(anchor, text, after=False):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError("anchor not found once in lstm.cu: %r" % anchor)
        src = src.replace(anchor, anchor + text if after else text + anchor)

    insert('#include "common.cuh"\n', "__device__ unsigned long long g_prof[8];\n",
           after=True)
    insert("  uint32_t phase = 0;  // bit p: the parity of full[p]'s next phase\n\n"
           "  for (int t = 0;", "  unsigned long long pacc[5] = {0, 0, 0, 0, 0}, "
           "plast = 0, pt0 = 0, pt1 = 0;\n  if (tid == 0 && blockIdx.x == 0) {\n"
           "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pt0));\n"
           "    plast = clock64();\n  }\n")
    insert("    float nx[4] = {0.f, 0.f, 0.f, 0.f}, nv = 0.f;\n", stamp(0, "    "))
    insert("    for (int off = S >> 1; off > 0; off >>= 1)\n#pragma unroll\n"
           "      for (int g = 0;", stamp(1, "    "))
    insert("      if (t + 1 < T) {", stamp(2, "      "))
    insert("      const size_t o = (size_t)t * B + row;\n", stamp(3, "      "))
    insert("#pragma unroll\n    for (int g = 0; g < 4; ++g) x[g] = nx[g];\n",
           stamp(4, "    "))
    insert("    v = nv;\n  }\n", "  if (tid == 0 && blockIdx.x == 0) {\n"
           "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pt1));\n"
           "    for (int k = 0; k < 5; ++k) g_prof[k] = pacc[k];\n"
           "    g_prof[5] = pt1 - pt0;\n  }\n", after=True)
    src = src.replace('extern "C" int vsl_', 'extern "C" int prof_')
    return src + ('\nextern "C" int prof_read(unsigned long long* h) {\n'
                  '  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n')


def build_instrumented():
    lib = build_copy("lstm_prof", instrumented((K.CSRC / "lstm.cu").read_text()))
    lib.prof_lstm_recurrence_fwd.argtypes = K._SIGNATURES["vsl_lstm_recurrence_fwd"]
    lib.prof_lstm_recurrence_fwd.restype = ctypes.c_int
    lib.prof_read.argtypes = [ctypes.c_void_p]
    lib.prof_read.restype = ctypes.c_int
    return lib


def main():
    import torch

    if not torch.cuda.is_available():
        print("lstm_plans: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
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
        stamps = (ctypes.c_ulonglong * 8)()
        if prof.prof_read(stamps):
            raise RuntimeError("reading the stamps failed")
        row["T128_cycles_per_step"] = {name: stamps[k] / (T - 1 if k == 0 else T)
                                       for k, name in enumerate(PHASES)}
        row["T128_prof_ns_per_step"] = stamps[5] / T
        row["sm_ghz"] = sum(stamps[k] for k in range(5)) / stamps[5]
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
    sys.exit(main())
