#!/usr/bin/env python3
"""What one step of an h exchange inside a thread-block cluster costs on the
card: the design question behind csrc/lstm.cu's forward.

    python3 -m vslnet_torch.bench.cluster_exchange

Clusters of N CTAs (N = 1..16; 4 clusters of 256 threads) run 20,000 steps
of a loop in which 64 threads of each CTA store one float into every CTA of
the cluster, by one of six exchanges:
  barrier         barrier.cluster.arrive + wait, no stores
  barrier+stores  generic DSMEM stores, then arrive (release) + wait
  barrier+sync    the same with a block barrier before the arrive
  cluster.sync    cooperative_groups' cluster.sync(), no stores
  st.async        st.async stores that complete bytes of the receiver's
                  mbarrier; each CTA waits on its own mbarrier (csrc/lstm.cu)
  remote arrive   generic DSMEM stores, a block barrier, then one remote
                  mbarrier arrive (release, cluster scope) per receiver
and prints one JSON line per (N, exchange) with its ns a step (CUDA
events). The source is built with nvcc into vslnet_torch/_build/bench/.
"""
import ctypes
import json
import subprocess
import sys

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// mode 0-3: cluster barrier variants; 4: st.async + mbarrier tx; 5: stores +
// block barrier + remote mbarrier arrives
__global__ void exchange_kernel(int iters, int mode, float* sink) {
  __shared__ float buf[2][1024];
  __shared__ __align__(8) uint64_t full[2];
  cg::cluster_group cl = cg::this_cluster();
  const uint32_t N = cl.num_blocks(), me = cl.block_rank();
  const int tid = threadIdx.x;
  for (int i = tid; i < 2048; i += blockDim.x) (&buf[0][0])[i] = 0.f;
  const uint32_t bytes = 64u * N * 4u;
  if (tid == 0) {
    const uint32_t count = mode == 4 ? 1u : N;
    for (int p = 0; p < 2; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(&full[p])), "r"(count) : "memory");
      if (mode == 4)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(saddr(&full[p])), "r"(bytes) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cl.sync();
  uint32_t phase = 0;
  float acc = 0.f;
  for (int t = 0; t < iters; ++t) {
    const int p = t & 1, pn = p ^ 1;
    const float val = acc + t;
    const uint32_t la = saddr(&buf[pn][me * 64 + (tid & 63)]);
    if (mode <= 3) {
      if (mode == 3) {
        cl.sync();
      } else {
        if (mode >= 1 && tid < 64)
          for (uint32_t r = 0; r < N; ++r)
            asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(mapa(la, r)), "f"(val) : "memory");
        if (mode == 2) __syncthreads();
        asm volatile("barrier.cluster.arrive;\n" ::: "memory");
        asm volatile("barrier.cluster.wait;\n" ::: "memory");
      }
      acc += buf[pn][tid];
      continue;
    }
    if (t > 0) {
      mbar_wait(saddr(&full[p]), (phase >> p) & 1u);
      phase ^= 1u << p;
      if (mode == 4 && tid == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(saddr(&full[p])), "r"(bytes) : "memory");
    }
    acc += buf[p][tid];
    __syncthreads();  // the same block barrier in modes 4 and 5
    if (t + 1 < iters) {
      if (tid < 64)
        for (uint32_t r = 0; r < N; ++r) {
          if (mode == 4)
            asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                         ::"r"(mapa(la, r)), "r"(__float_as_uint(val)), "r"(mapa(saddr(&full[pn]), r))
                         : "memory");
          else
            asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(mapa(la, r)), "f"(val) : "memory");
        }
      if (mode == 5) {
        __syncthreads();
        if (tid < (int)N)
          asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
                       ::"r"(mapa(saddr(&full[pn]), tid)) : "memory");
      }
    }
  }
  sink[blockIdx.x * blockDim.x + tid] = acc;
}

extern "C" int exchange_launch(int clusters, int N, int threads, int iters, int mode,
                               float* sink, void* stream) {
  cudaError_t e = cudaFuncSetAttribute((const void*)exchange_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * N);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, exchange_kernel, iters, mode, sink);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
"""

MODES = ["barrier", "barrier+stores", "barrier+sync", "cluster.sync",
         "st.async", "remote arrive"]


def main():
    import torch

    from vslnet_torch.ops.kernels import BUILD_DIR, _nvcc

    if not torch.cuda.is_available():
        print("cluster_exchange_bench: no CUDA device", file=sys.stderr)
        return 2
    out = BUILD_DIR / "bench"
    out.mkdir(parents=True, exist_ok=True)
    (out / "exchange.cu").write_text(SOURCE)
    lib_path = out / "libexchange.so"
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(out / "exchange.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.exchange_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.exchange_launch.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    sink = torch.empty(1 << 16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 20000
    for n in (1, 2, 4, 8, 16):
        for mode, name in enumerate(MODES):
            def run():
                code = lib.exchange_launch(4, n, 256, iters, mode,
                                           sink.data_ptr(), stream)
                if code:
                    raise RuntimeError("exchange_launch failed: %d" % code)
            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            print(json.dumps({"bench": "cluster_exchange", "card": smi,
                              "cluster": n, "exchange": name,
                              "ns_per_step": start.elapsed_time(end) * 1e6
                              / iters}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
