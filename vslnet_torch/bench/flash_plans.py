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

    python3 -m vslnet_torch.bench.flash_plans --forward [--by-kernel]

The flash forward (#13) at path L's shape, ragged key lengths and one fully
masked row: `launch_flash_mha_fwd` at drop_rate 0 (serving) and 0.2
(training), each call's device time by kernel and its time by CUDA events,
beside SDPA's forward (drop 0, device time and events); with every key
valid; then, unless --by-kernel, each of `fwd_rows` (query rows a
thread) through the kernel library (`fwd_runner`), with the largest
difference of out and lse from the default plan's.

    python3 -m vslnet_torch.bench.flash_plans --bf16 [--by-kernel]

The bf16 flash pair (#13b, #14b, tensor cores) at path L's shape in bf16,
ragged key lengths and one fully masked row: the forward at drop_rate 0
(serving) and 0.2 (training) and the backward at 0.2 and 0, each call's
device time by kernel and its CUDA events, beside SDPA's in bf16 (the
additive mask in bf16, drop 0, device time and events); with
--by-kernel only these, which an older tree with the same wrappers also
runs. Otherwise also the kernels at 4 warps a CTA (key tiles of 64 in
the backward) from a copy of csrc/flash_mha.cu (BF16_WARPS,
`with_bf16_warps`, `bf16_runners`), with the largest difference of the
outputs from the kernels' own.
"""
import ctypes
import json
import sys

import numpy as np

from vslnet_torch.bench import common
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
    return common.instrumented(src, "flash_bwd_kernel", STAMPS)


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


def fwd_rows(hd):
    """The query rows a thread the forward is built for at head dim hd
    (csrc/flash_mha.cu vsl_flash_mha_fwd: 1, and 2 up to head dim 32)."""
    return (1, 2) if hd <= 32 else (1,)


def fwd_runner(q, k, v, mask, heads, seeds, rate, rows, fn=None):
    """A call of the forward kernel through fn (an entry point of
    vsl_flash_mha_fwd's signature; the kernel library's by default) with
    `rows` query rows a thread: returns (out, lse)."""
    import torch

    B, T, D = q.shape
    sp, thresh, scale = K._dropout_args("flash_plans", seeds, rate, B)
    out = torch.empty_like(q)
    lse = q.new_empty(B, heads, T)
    fn = fn or K._library().vsl_flash_mha_fwd

    def run():
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), sp,
                  thresh, scale, out.data_ptr(), lse.data_ptr(), B, T, D, heads,
                  rows, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError("flash_plans: forward launch failed (%d)" % code)
        return out, lse
    return run


# (query slots a CTA, keys a step of the online softmax, thread groups
# that split a key tile) of the forward: the kernel's own first
# (csrc/flash_mha.cu kFwdThreads, kFwdBlock, kFwdGroups)
FWD_TILES = [(64, 8, 2), (64, 8, 1), (64, 16, 2), (64, 8, 4), (128, 8, 2), (32, 8, 2)]


def with_fwd_tile(src, threads, block, groups):
    """csrc/flash_mha.cu with the forward's query slots, key block and
    thread groups set to (threads, block, groups), its entry points renamed
    fwd<threads>_<block>_<groups>_."""
    for name, old, new in zip(("kFwdThreads", "kFwdBlock", "kFwdGroups"),
                              FWD_TILES[0], (threads, block, groups)):
        line = "constexpr int %s = %d;" % (name, old)
        if src.count(line) != 1:
            raise RuntimeError("not found once in flash_mha.cu: %r" % line)
        src = src.replace(line, "constexpr int %s = %d;" % (name, new))
    return src.replace('extern "C" int vsl_',
                       'extern "C" int fwd%d_%d_%d_' % (threads, block, groups))


def sdpa_forward_ms(q, k, v, mask, heads):
    """SDPA's forward on the same heads and the additive mask at drop 0:
    (CUDA events, device time)."""
    import torch
    import torch.nn.functional as F

    B, T, D = q.shape

    def split(x):
        return x.view(B, T, heads, D // heads).transpose(1, 2).contiguous()

    qh, kh, vh = (split(x) for x in (q, k, v))
    bias = ((1.0 - mask) * -1e30).view(B, 1, 1, T)

    def run():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
    return cuda_ms(run), sum(by_kernel(run).values())


def forward_main(argv, emit, rng, dev):
    """The --forward rows (module docstring)."""
    q, k, v, mask, seeds, _, _, _ = inputs(rng, dev, B, T, D, HEADS, RATE)
    sdpa_ms, sdpa_device_ms = sdpa_forward_ms(q, k, v, mask, HEADS)
    for rate, sd in ((0.0, None), (RATE, seeds)):
        def call():
            return K.launch_flash_mha_fwd(q, k, v, mask, HEADS, sd, rate)
        parts = by_kernel(call)
        emit(kernel="forward", shape=[B, T, D], heads=HEADS, drop_rate=rate,
             call_ms=cuda_ms(call), device_ms=sum(parts.values()),
             by_kernel=parts, sdpa_ms=sdpa_ms, sdpa_device_ms=sdpa_device_ms)
    full = inputs(rng, dev, B, T, D, HEADS, RATE, ragged=False)
    parts = by_kernel(lambda: K.launch_flash_mha_fwd(*full[:4], HEADS))
    emit(kernel="forward", shape=[B, T, D], mask="every key valid",
         drop_rate=0.0, device_ms=sum(parts.values()), by_kernel=parts)
    if "--by-kernel" in argv:
        return 0
    plan = K.flash_fwd_plan(B, T, D, HEADS)
    from vslnet_torch.bench.common import build_copies  # absent from older trees

    src = (K.CSRC / "flash_mha.cu").read_text()
    fns = {None: None}
    libs = build_copies({"fwd%d_%d_%d" % tile: with_fwd_tile(src, *tile)
                         for tile in FWD_TILES[1:]})
    for tile in FWD_TILES[1:]:
        tag = "fwd%d_%d_%d" % tile
        fn = getattr(libs[tag], tag + "_flash_mha_fwd")
        fn.argtypes = K._SIGNATURES["vsl_flash_mha_fwd"]
        fn.restype = ctypes.c_int
        fns[tile] = fn
    for rate, sd in ((0.0, None), (RATE, seeds)):
        ref = [a.clone() for a in K.launch_flash_mha_fwd(q, k, v, mask, HEADS, sd, rate)]
        for tile, fn in fns.items():
            for rows in fwd_rows(D // HEADS):
                run = fwd_runner(q, k, v, mask, HEADS, sd, rate, rows, fn)
                diff = max(float((a - b).abs().max())
                           for a, b in zip(run(), ref))
                emit(kernel="forward", shape=[B, T, D], drop_rate=rate,
                     rows=rows, slots_block_groups=tile or FWD_TILES[0],
                     default=rows == plan.rows and tile is None,
                     ms=cuda_ms(run), device_ms=sum(by_kernel(run).values()),
                     max_abs_diff_from_default=diff)
    return 0


# (warps a CTA of the bf16 forward, of the bf16 backward): the kernels'
# own first (csrc/flash_mha.cu kTcFwdWarps, kTcBwdWarps), then copies
BF16_WARPS = [(8, 8), (4, 4)]


def with_bf16_warps(src, fwd, bwd):
    """csrc/flash_mha.cu with the bf16 kernels' warps a CTA set to (fwd,
    bwd), its entry points renamed w<fwd>_<bwd>_."""
    for name, old, new in zip(("kTcFwdWarps", "kTcBwdWarps"), BF16_WARPS[0],
                              (fwd, bwd)):
        line = "constexpr int %s = %d;" % (name, old)
        if src.count(line) != 1:
            raise RuntimeError("not found once in flash_mha.cu: %r" % line)
        src = src.replace(line, "constexpr int %s = %d;" % (name, new))
    return src.replace('extern "C" int vsl_', 'extern "C" int w%d_%d_' % (fwd, bwd))


def bf16_runners(q, k, v, mask, heads, seeds, rate, g, lib, tag, key_tile):
    """(forward, backward): calls of the bf16 kernels through the entry
    points `<tag>flash_mha_fwd_bf16` and `<tag>flash_mha_bwd_bf16` of lib,
    whose backward takes key tiles of key_tile keys, the forward returning
    (out, lse), the backward (dq, dk, dv) from the kernel library's
    forward's out and lse."""
    import torch

    B, T, D = q.shape
    fns = []
    for kind in ("fwd", "bwd"):
        fn = getattr(lib, "%sflash_mha_%s_bf16" % (tag, kind))
        fn.argtypes = K._SIGNATURES["vsl_flash_mha_%s_bf16" % kind]
        fn.restype = ctypes.c_int
        fns.append(fn)
    sp, thresh, scale = K._dropout_args("flash_plans", seeds, rate, B)
    out = torch.empty_like(q)
    lse = q.new_empty(B, heads, T, dtype=torch.float32)
    saved = K.launch_flash_mha_fwd(q, k, v, mask, heads, seeds, rate)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    nd = -(-B * heads * T // 4) * 4
    work = q.new_empty(nd + -(-T // key_tile) * B * T * D,
                       dtype=torch.float32)

    def fwd():
        code = fns[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      mask.data_ptr(), sp, thresh, scale, out.data_ptr(),
                      lse.data_ptr(), B, T, D, heads,
                      torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError("flash_plans: bf16 forward failed (%d)" % code)
        return out, lse

    def bwd():
        code = fns[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      mask.data_ptr(), sp, thresh, scale, saved[0].data_ptr(),
                      saved[1].data_ptr(), g.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
                      work[nd:].data_ptr(), B, T, D, heads,
                      torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError("flash_plans: bf16 backward failed (%d)" % code)
        return dq, dk, dv
    return fwd, bwd


def bf16_main(argv, emit, rng, dev):
    """The --bf16 rows (module docstring)."""
    import torch

    bf = torch.bfloat16
    q, k, v, mask, seeds, g, _, _ = inputs(rng, dev, B, T, D, HEADS, RATE)
    q, k, v, g = (x.to(bf) for x in (q, k, v, g))
    sdpa_f = sdpa_forward_ms(q, k, v, mask.to(bf), HEADS)
    sdpa_b = sdpa_backward_ms(q, k, v, mask.to(bf), HEADS)
    for rate, sd in ((0.0, None), (RATE, seeds)):
        def fwd():
            return K.launch_flash_mha_fwd(q, k, v, mask, HEADS, sd, rate)
        parts = by_kernel(fwd)
        emit(kernel="forward_bf16", shape=[B, T, D], heads=HEADS,
             drop_rate=rate, call_ms=cuda_ms(fwd),
             device_ms=sum(parts.values()), by_kernel=parts,
             sdpa_ms=sdpa_f[0], sdpa_device_ms=sdpa_f[1])
    for rate, sd in ((RATE, seeds), (0.0, None)):
        out, lse = K.launch_flash_mha_fwd(q, k, v, mask, HEADS, sd, rate)

        def bwd():
            return K.launch_flash_mha_bwd(q, k, v, mask, HEADS, sd, rate, out,
                                          lse, g)
        parts = by_kernel(bwd)
        emit(kernel="backward_bf16", shape=[B, T, D], heads=HEADS,
             drop_rate=rate, call_ms=cuda_ms(bwd),
             device_ms=sum(parts.values()), by_kernel=parts,
             sdpa_ms=sdpa_b[0], sdpa_device_ms=sdpa_b[1])
    if "--by-kernel" in argv:
        return 0
    from vslnet_torch.bench.common import build_copies  # absent from older trees

    src = (K.CSRC / "flash_mha.cu").read_text()
    libs = {BF16_WARPS[0]: (K._library(), "vsl_")}
    copies = build_copies({"w%d_%d" % w: with_bf16_warps(src, *w)
                           for w in BF16_WARPS[1:]})
    for w in BF16_WARPS[1:]:
        libs[w] = (copies["w%d_%d" % w], "w%d_%d_" % w)
    for rate, sd in ((0.0, None), (RATE, seeds)):
        ref_f = [a.clone() for a in K.launch_flash_mha_fwd(q, k, v, mask,
                                                          HEADS, sd, rate)]
        ref_b = [a.clone() for a in K.launch_flash_mha_bwd(
            q, k, v, mask, HEADS, sd, rate, *ref_f, g)]
        for w, (lib, tag) in libs.items():
            fwd, bwd = bf16_runners(q, k, v, mask, HEADS, sd, rate, g, lib,
                                    tag, 16 * w[1])
            for kernel, run, ref, warps in (("forward_bf16", fwd, ref_f, w[0]),
                                            ("backward_bf16", bwd, ref_b,
                                             w[1])):
                diff = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(run(), ref))
                emit(kernel=kernel, shape=[B, T, D], drop_rate=rate,
                     warps=warps, default=w == BF16_WARPS[0],
                     ms=cuda_ms(run), device_ms=sum(by_kernel(run).values()),
                     max_abs_diff_from_default=diff)
    return 0


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

    if "--forward" in argv:
        return forward_main(argv, emit, rng, dev)
    if "--bf16" in argv:
        return bf16_main(argv, emit, rng, dev)
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
