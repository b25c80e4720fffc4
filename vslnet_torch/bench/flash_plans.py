#!/usr/bin/env python3
"""The flash attention backward on the card (csrc/flash_mha.cu): where a
call spends its time by kernel and, inside its pass, by phase.

    python3 -m vslnet_torch.bench.flash_plans
    python3 -m vslnet_torch.bench.flash_plans --by-kernel

At path L's [8, 1024, 128], 8 heads of 16, drop_rate 0.2, key lengths of
T/2..T and one fully masked row:
- `launch_flash_mha_bwd` on flash_bwd_plan, each call's device time by
  kernel (torch.profiler) and the call's time (CUDA events over 20 calls
  after a warm-up); beside it SDPA's backward
  (F.scaled_dot_product_attention with the additive mask, drop 0,
  forward + backward minus forward), by CUDA events and device time, a
  yardstick the port never calls. With --by-kernel only these, which an
  older tree of the port with the same wrappers also runs (put it on
  PYTHONPATH), so that a change's breakdown can be set beside its
  parent's;
- the call again with every key valid, and at drop_rate 0;
- the cycles a call spends from each block barrier of flash_bwd_kernel
  (and from the start of its dQ product) to the next (thread 0 of CTA 0,
  summed over the query tiles), from a copy of flash_mha.cu with a clock
  stamp after each, built into vslnet_torch/_build/bench/, keyed by the
  stamp's line in flash_mha.cu.
Prints one JSON line a row with the card's name and power limit. The
shipped kernel carries no instrumentation.
"""
import ctypes
import json
import sys

import numpy as np

from vslnet_torch.bench.common import build_copy, by_kernel, card, cuda_ms
from vslnet_torch.ops import kernels as K

B, T, D, HEADS, RATE = 8, 1024, 128, 8, 0.2
# where the stamped copy takes a clock: after each block barrier of the
# kernel, and where its dQ product starts
STAMPS = ("__syncthreads();", "// 3. the tile's dQ partial")


def inputs(rng, dev, B, T, D, heads, rate, ragged=True):
    """q, k, v, mask, seeds, g and the flash forward's out and lse at [B, T,
    D]: key lengths T/2..T and one fully masked row (ragged), or every key
    valid."""
    import torch

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    lens = (list(rng.integers(T // 2, T + 1, B - 1)) + [0] if ragged
            else [T] * B)
    q, k, v, g = (t(rng.standard_normal((B, T, D))) for _ in range(4))
    mask = t(np.arange(T)[None, :] < np.asarray(lens)[:, None])
    seeds = t(rng.integers(0, 1 << 23, (B, 1)))
    out, lse = K.launch_flash_mha_fwd(q, k, v, mask, heads, seeds, rate)
    return q, k, v, mask, seeds, g, out, lse


def instrumented(src):
    """(csrc/flash_mha.cu with a clock stamp, thread 0 of CTA 0, at each of
    STAMPS in flash_bwd_kernel and its entry points renamed prof_, the
    flash_mha.cu line of each stamp)."""
    lines = src.split("\n")
    first = next(i for i, ln in enumerate(lines)
                 if ln.startswith("flash_bwd_kernel(const float* __restrict__ q"))
    last = lines.index("}", first)
    stamp = (" { if (threadIdx.x == 0 && blockIdx.x == 0) { long long now = "
             "clock64(); g_prof[%d] += now - plast; plast = now; } }")
    at = []
    for i in range(first, last):
        if any(m in lines[i] for m in STAMPS):
            lines[i] = lines[i].split("//")[0].rstrip() + stamp % len(at)
            at.append(i + 1)
    body_open = next(i for i in range(first, last) if lines[i].endswith(") {"))
    lines[body_open] += "\n  long long plast = clock64();"
    src = "\n".join(lines).replace(
        '#include "hash.cuh"\n', '#include "hash.cuh"\n'
        "__device__ unsigned long long g_prof[64];\n", 1)
    src = src.replace('extern "C" int vsl_', 'extern "C" int prof_')
    return src + r'''
extern "C" int prof_read(unsigned long long* h) {
  const int err = (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));
  unsigned long long z[64] = {0};
  return err ? err : (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
''', at


def runner(bwd, fn):
    """A call of the backward kernels through fn, an entry point of
    flash_mha.cu's signature, at bwd = [q, k, v, mask, heads, seeds, rate,
    out, lse, g] with the workspaces launch_flash_mha_bwd allocates:
    returns (dq, dk, dv)."""
    import torch

    q, k, v, mask, heads, seeds, rate, out, lse, g = bwd
    B, T, D = q.shape
    sp, thresh, scale = K._dropout_args("flash_plans", seeds, rate, B)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = q.new_empty(B * heads * T)
    dqw = q.new_empty(K.flash_bwd_plan(B, T, D, heads).workspace_bytes // 4)
    ptrs = [a.data_ptr() for a in (q, k, v, mask)]
    outs = [a.data_ptr() for a in (out, lse, g, dq, dk, dv, delta, dqw)]

    args = (*ptrs, sp, thresh, scale, *outs, B, T, D, heads)

    def run():
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError("flash_plans: launch failed (%d)" % code)
        return dq, dk, dv
    return run


def sdpa_backward_ms(q, k, v, mask, heads):
    """SDPA's backward on the same heads and the additive mask at drop 0,
    forward + backward minus forward: (CUDA events, device time)."""
    import torch
    import torch.nn.functional as F

    B, T, D = q.shape

    def split(x):
        return x.view(B, T, heads, D // heads).transpose(1, 2).contiguous()

    qh, kh, vh = (split(x).requires_grad_() for x in (q, k, v))
    bias = ((1.0 - mask) * -1e30).view(B, 1, 1, T)
    g = torch.randn_like(qh)

    def run(grad):
        with torch.set_grad_enabled(grad):
            out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
            if grad:
                torch.autograd.grad(out, (qh, kh, vh), g)

    return (cuda_ms(lambda: run(True)) - cuda_ms(lambda: run(False)),
            sum(by_kernel(lambda: run(True)).values())
            - sum(by_kernel(lambda: run(False)).values()))


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("flash_plans: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def emit(**row):
        print(json.dumps({"bench": "flash_plans", "card": smi, **row}),
              flush=True)

    q, k, v, mask, seeds, g, out, lse = inputs(rng, dev, B, T, D, HEADS, RATE)
    bwd = [q, k, v, mask, HEADS, seeds, RATE, out, lse, g]

    def call():
        return K.launch_flash_mha_bwd(*bwd)

    parts = by_kernel(call)
    sdpa_ms, sdpa_device_ms = sdpa_backward_ms(q, k, v, mask, HEADS)
    emit(shape=[B, T, D], heads=HEADS, drop_rate=RATE, call_ms=cuda_ms(call),
         device_ms=sum(parts.values()), by_kernel=parts, sdpa_ms=sdpa_ms,
         sdpa_device_ms=sdpa_device_ms)
    if "--by-kernel" in argv:
        return 0
    plan = K.flash_bwd_plan(B, T, D, HEADS)._asdict()
    q, k, v, mask, seeds, g, out, lse = inputs(rng, dev, B, T, D, HEADS, RATE,
                                               ragged=False)
    full = [q, k, v, mask, HEADS, seeds, RATE, out, lse, g]
    parts = by_kernel(lambda: K.launch_flash_mha_bwd(*full))
    emit(shape=[B, T, D], plan=plan, mask="every key valid",
         device_ms=sum(parts.values()), by_kernel=parts)
    parts = by_kernel(lambda: K.launch_flash_mha_bwd(*bwd[:6], 0.0, *bwd[7:]))
    emit(shape=[B, T, D], plan=plan, drop_rate=0.0,
         device_ms=sum(parts.values()), by_kernel=parts)
    src, stamped = instrumented((K.CSRC / "flash_mha.cu").read_text())
    lib = build_copy("flash_prof", src)
    fn = lib.prof_flash_mha_bwd
    fn.argtypes = K._SIGNATURES["vsl_flash_mha_bwd"]
    fn.restype = ctypes.c_int
    run = runner(bwd, fn)
    run()
    torch.cuda.synchronize()
    stamps = (ctypes.c_ulonglong * 64)()
    lib.prof_read(stamps)
    reps = 5
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    lib.prof_read(stamps)
    cycles = {"flash_mha.cu:%d" % line: stamps[k] / reps
              for k, line in enumerate(stamped)}
    emit(shape=[B, T, D], plan=plan, cycles_to_each_stamp=cycles,
         cycles_total=sum(cycles.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
