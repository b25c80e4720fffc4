#!/usr/bin/env python3
"""Context-query attention's launch plans on the card (csrc/cqa.cu): the
time of each, as the kernel's two launches and as one launch of a cluster a
row, and where a call spends its time by kernel.

    python3 -m vslnet_torch.bench.cqa_plans [--by-kernel]

At path L's [8, 1024] with the served query length W = 12, the served
[16, 128, 12] and [8, 1024] with W = 64, D = 128 (ragged row lengths, one
row with every frame masked, one padded query): `fused_cqa_concat`'s
device time by kernel (torch.profiler) and the call's time (CUDA events);
then every plan of `plans` (1 to 64 CTAs a row whose frames fit, each as
two launches through device memory and, up to 16, as one cluster launch)
through `runner`: events, device time and whether its output is
cqa_plan's bit for bit; then cqa_plan's plan with 256 and 1024 threads a
CTA, and the cycles from each block barrier of its two kernels to the next
(thread 0 of CTA 1, keyed by the barrier's line in cqa.cu), from copies of
cqa.cu built into vslnet_torch/_build/bench/. The cluster form lives only
in such a copy: CLUSTER_FORM, appended to cqa.cu, runs the same steps in
one launch, the row's partials read through distributed shared memory
after one cluster barrier. With
--by-kernel only the wrapper's rows, which an older tree of the port also
runs (put it on PYTHONPATH and run this file by path), so that a change's
breakdown can be set beside its parent's. Prints one JSON line a row with
the card's name and power limit.
"""
import ctypes
import json
import math
import sys

import numpy as np

from vslnet_torch.bench.common import by_kernel, card, cuda_ms
from vslnet_torch.ops import kernels as K

SHAPES = [(8, 1024, 12, 128), (16, 128, 12, 128), (8, 1024, 64, 128)]
# threads a CTA: the kernel's own first (csrc/cqa.cu kThreads)
THREADS = [512, 256, 1024]


# CTAs a row this script times: every count up to 16, then a few up to
# CQA_CTAS
CTAS = list(range(1, 17)) + [20, 24, 32, 48, 64]
# the most CTAs a row of the cluster form: a non-portable cluster size,
# which the H100 schedules
CLUSTER = 16

# One launch a row as a thread-block cluster, appended to a copy of
# csrc/cqa.cu (whose functions it calls): steps 1-2, one cluster barrier,
# the combine over the peers' partials through distributed shared memory,
# step 5. Entry point cluster_concat_fwd, vsl_cqa_concat_fwd's signature
# (the workspaces unused).
CLUSTER_FORM = r'''
#include <cooperative_groups.h>

namespace {

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) cqa_cluster_kernel(CqaArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const Tile tl = tile_of(a, static_cast<int>(blockIdx.x) / n,
                          static_cast<int>(cluster.block_rank()));
  partials(a, tl);
  cluster_arrive();  // this thread's part of the partials is written
  __syncthreads();   // S read by every warp
  row_softmax(a, tl);
  __syncthreads();
  first_quarters(a, tl);
  __syncthreads();  // q read by every thread before it takes A
  cluster_wait();   // every CTA's partials
  combine([&](int r) { return static_cast<const float*>(cluster.map_shared_rank(tl.part, r)); },
          n, a.W, a.D, tl.Q);
  __syncthreads();
  last_quarter(a, tl, tl.Q);
  cluster.sync();  // no CTA leaves while another may read its partials
}

}  // namespace

extern "C" int cluster_concat_fwd(const float* video, const float* query, const float* v_mask,
                                  const float* q_mask, const float* w4v, const float* w4q,
                                  const float* wmul, float* out, float*, float*, int B, int T,
                                  int W, int D, int N, int F, void* stream_) {
  if (B < 1 || T < 1 || W < 1 || D < 4 || D % 4 || F < 1 || N < 1 || N > 16 ||
      N != (T + F - 1) / F)
    return static_cast<int>(cudaErrorInvalidValue);
  const CqaArgs a{video, query, v_mask, q_mask, w4v, w4q, wmul, out, T, W, D, F};
  const size_t smem = CqaLayout(F, W, D).floats(F, W) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cqa_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = vsl::launch_cluster(cqa_cluster_kernel, B * N, N, kThreads, smem,
                              static_cast<cudaStream_t>(stream_), a);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
'''

FORMS = ("two", "cluster")


def plans(B, T, W, D):
    """The plans this script times, as (plan, form): n of CTAS CTAs a row
    of ceil(T / n) frames (ceil(T / frames) CTAs, none empty) whose shared
    memory fits, each once, as two launches and, up to CLUSTER CTAs, as a
    cluster."""
    out = []
    for n in CTAS:
        frames = -(-T // min(T, n))
        n = -(-T // frames)
        smem = K._cqa_smem_bytes(frames, W, D)
        plan = K.CQAPlan(n, frames, smem, B * n)
        for form in FORMS:
            if smem <= K.MAX_SMEM_BYTES and (form == "two" or n <= CLUSTER) \
                    and (plan, form) not in out:
                out.append((plan, form))
    return out


def with_threads(src, threads):
    """csrc/cqa.cu with its threads a CTA set to `threads`."""
    line = "constexpr int kThreads = %d;"
    if src.count(line % THREADS[0]) != 1:
        raise RuntimeError("not found once in cqa.cu: %r" % (line % THREADS[0]))
    return src.replace(line % THREADS[0], line % threads)


# the functions of csrc/cqa.cu whose barriers the stamped copy times: the
# two-launch form's kernels and the partials step they run
STAMPED = ("__device__ void partials(", "cqa_partials_kernel(CqaArgs a",
           "cqa_combine_kernel(CqaArgs a")


def instrumented(src):
    """(csrc/cqa.cu with a clock stamp, thread 0 of CTA 1, at each block
    barrier of the functions of STAMPED and at each kernel's last line, its
    entry point renamed cprof_, the cqa.cu line of each stamp). A kernel's
    first stamp counts from its entry."""
    lines = src.split("\n")
    stamp = (" { if (threadIdx.x == 0 && blockIdx.x == 1) { long long now = clock64(); "
             "g_prof[%d] += now - g_last; g_last = now; } }")
    at = []
    for head in STAMPED:
        first = next(i for i, s in enumerate(lines) if head in s)
        last = lines.index("}", first)
        body = next(i for i in range(first, last) if lines[i].endswith(") {"))
        for i in range(body + 1, last):
            code = lines[i].split("//")[0]
            if "__syncthreads();" in code or (i == last - 1 and "kernel" in head):
                lines[i] = code.rstrip() + stamp % len(at)
                at.append(i + 1)
        if "kernel" in head:
            lines[body] += (" if (threadIdx.x == 0 && blockIdx.x == 1) g_last = "
                            "clock64();")
    src = "\n".join(lines).replace(
        '#include "common.cuh"\n', '#include "common.cuh"\n'
        "__device__ unsigned long long g_prof[64];\n__device__ long long g_last;\n", 1)
    return renamed(src, "cprof") + r'''
extern "C" int cprof_read(unsigned long long* h) {
  const int err = (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));
  unsigned long long z[64] = {0};
  return err ? err : (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
''', at


def renamed(src, tag):
    """src with its entry point renamed vsl_ -> <tag>_."""
    return src.replace('extern "C" int vsl_', 'extern "C" int %s_' % tag)


def runner(args, plan, fn=None):
    """A call of the kernel on `plan` through fn (an entry point of
    vsl_cqa_concat_fwd's signature; the kernel library's by default), with
    fused_cqa_concat's workspaces: returns the output."""
    import torch

    video, query, v_mask, q_mask, w4v, w4q, w4mul = args
    B, T, D = video.shape
    W = query.shape[1]
    out = video.new_empty(B, T, 4 * D)
    parts = video.new_empty(plan.ctas * K.cqa_part_floats(W, D))
    sq = video.new_empty(B * T * W)
    fn = fn or K._library().vsl_cqa_concat_fwd

    def run():
        code = fn(video.data_ptr(), query.data_ptr(), v_mask.data_ptr(), q_mask.data_ptr(),
                  w4v.data_ptr(), w4q.data_ptr(), w4mul.data_ptr(), out.data_ptr(),
                  parts.data_ptr(), sq.data_ptr(), B, T, W, D, plan.n, plan.frames,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError("cqa_concat_fwd launch failed: %d" % code)
        return out
    return run


def inputs(rng, B, T, W, D, dev):
    """Seeded inputs: ragged lengths, row 1 with every frame masked, row 2 a
    padded query."""
    import torch

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    v_lens = np.concatenate([[T, 0], rng.integers(1, T + 1, B - 2)])
    q_lens = np.concatenate([[W, W, 0], rng.integers(1, W + 1, B - 3)])
    return [t(rng.standard_normal((B, T, D))), t(rng.standard_normal((B, W, D))),
            t(np.arange(T)[None, :] < v_lens[:, None]),
            t(np.arange(W)[None, :] < q_lens[:, None]),
            *[t(rng.standard_normal(D) / math.sqrt(D)) for _ in range(3)]]


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("cqa_plans: no CUDA device", file=sys.stderr)
        return 2
    smi = card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    fns = {}
    if "--by-kernel" not in argv:
        from vslnet_torch.bench.common import build_copies

        src = (K.CSRC / "cqa.cu").read_text()
        tags = {n: "cqa%d" % n for n in THREADS[1:]}
        prof_src, stamped = instrumented(src)
        libs = build_copies({"cqa_prof": prof_src,
                             "cqa1": renamed(src, "cqa1") + CLUSTER_FORM,
                             **{tag: renamed(with_threads(src, n), tag)
                                for n, tag in tags.items()}})
        for n, tag in tags.items():
            fns[n] = getattr(libs[tag], tag + "_cqa_concat_fwd")
        cluster_fn = libs["cqa1"].cluster_concat_fwd
        prof = libs["cqa_prof"]
        for fn in (*fns.values(), cluster_fn, prof.cprof_cqa_concat_fwd):
            fn.argtypes = K._SIGNATURES["vsl_cqa_concat_fwd"]
            fn.restype = ctypes.c_int
        prof.cprof_read.argtypes = [ctypes.c_void_p]
        prof.cprof_read.restype = ctypes.c_int
    for B, T, W, D in SHAPES:
        def emit(**row):
            print(json.dumps({"bench": "cqa_plans", "card": smi, "shape": [B, T, W, D],
                              **row}), flush=True)

        args = inputs(rng, B, T, W, D, dev)

        def call():
            return K.fused_cqa_concat(*args)
        try:
            parts = by_kernel(call)
        except ValueError as e:  # an older tree's limit on W
            emit(error=str(e))
            continue
        emit(call_ms=cuda_ms(call), device_ms=sum(parts.values()), by_kernel=parts)
        if "--by-kernel" in argv:
            continue
        default = K.cqa_plan(B, T, W, D)
        ref = call().clone()

        def timed(run, **row):
            parts = by_kernel(run)
            emit(ms=cuda_ms(run), device_ms=sum(parts.values()), by_kernel=parts,
                 equal_to_default=bool(torch.equal(run(), ref)), **row)
        for plan, form in plans(B, T, W, D):
            timed(runner(args, plan, cluster_fn if form == "cluster" else None),
                  plan=plan._asdict(), form=form, default=(plan, form) == (default, "two"))
        for n, fn in fns.items():
            timed(runner(args, default, fn), plan=default._asdict(), threads=n)
        run = runner(args, default, prof.cprof_cqa_concat_fwd)
        run()
        torch.cuda.synchronize()
        stamps = (ctypes.c_ulonglong * 64)()
        prof.cprof_read(stamps)
        reps = 5
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        prof.cprof_read(stamps)
        emit(plan=default._asdict(), cta=1, cycles_to_each_stamp={
            "cqa.cu:%d" % line: stamps[k] / reps for k, line in enumerate(stamped)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
