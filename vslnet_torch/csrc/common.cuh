// Device helpers shared by the kernels of vslnet_torch (fp32 throughout).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace vsl {

constexpr float kMaskValue = -1e30f;  // the reference's additive key mask
constexpr float kLnEps = 1e-6f;       // LayerNorm epsilon of the reference

// f(std::integral_constant<int, HD>) for the attention kernels' head dims
// (ops/kernels.py MHA_HEAD_DIMS); cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t by_head_dim(int hd, F f) {
  switch (hd) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide sum or max; `red` is 32 floats of shared memory. Every thread
// of the block must call it; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < nwarps ? red[lane] : (kMax ? -FLT_MAX : 0.f);
    r = kMax ? warp_max(r) : warp_sum(r);
    if (lane == 0) red[0] = r;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// 1 / sqrt(hd), the attention kernels' query scale, rounded to fp32 once.
inline float head_scale(int hd) { return static_cast<float>(1.0 / sqrt(static_cast<double>(hd))); }

// The attention kernels' scores, s(t, j) = q_t . k_j + neg_j for one head,
// q pre-scaled, are one fmaf chain over d = 0..hd-1 from 0, then + neg_j:
// the same order of sums wherever they are formed (fmaf is symmetric in q
// and k), so a backward recomputes the forward's scores bit for bit.

// LayerNorm over the last dim of src [T, D] into dst [T, D] (either may be
// shared or global memory): one warp per row, fp32 statistics, population
// variance, eps 1e-6. blockDim.x must be a multiple of 32.
inline __device__ void layer_norm_rows(const float* src, float* dst, const float* __restrict__ gam,
                                const float* __restrict__ beta, int T, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < T; t += nwarps) {
    const float* row = src + (size_t)t * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += row[c];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int c = lane; c < D; c += 32)
      dst[(size_t)t * D + c] = (row[c] - mean) * inv * __ldg(gam + c) + __ldg(beta + c);
  }
}

// The LayerNorm statistics of src [T, D] (shared or global): xh [T, D] =
// (x - mean) * inv and inv [T], as the JAX package's _ln_fwd. xh may alias
// src. One warp per row.
inline __device__ void ln_normalize_rows(const float* src, float* xh, float* inv, int T, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < T; t += nwarps) {
    const float* row = src + (size_t)t * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += row[c];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float r = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int c = lane; c < D; c += 32) xh[(size_t)t * D + c] = (row[c] - mean) * r;
    if (lane == 0) inv[t] = r;
  }
}

// LayerNorm backward over one [T, D] tile (the JAX package's _ln_bwd):
// given gn [T, D], the gradient of the normalised output, xh and inv,
// writes the tile's column sums of gn * xh (dgam) and of gn (dbeta), one
// thread a column in row order, and hands dx = inv * (dxh - mean(dxh) - xh
// * mean(dxh * xh)), dxh = gn * gam, to out(t, c, dx), one warp a row.
template <typename Out>
__device__ void ln_backward_rows(const float* gn, const float* xh, const float* inv,
                                 const float* __restrict__ gam, int T, int D, float* dgam,
                                 float* dbeta, Out out) {
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float sg = 0.f, sb = 0.f;
    for (int t = 0; t < T; ++t) {
      const float g = gn[(size_t)t * D + c];
      sg = fmaf(g, xh[(size_t)t * D + c], sg);
      sb += g;
    }
    dgam[c] = sg;
    dbeta[c] = sb;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < T; t += nwarps) {
    const float* g = gn + (size_t)t * D;
    const float* x = xh + (size_t)t * D;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dxh = g[c] * __ldg(gam + c);
      s1 += dxh;
      s2 += dxh * x[c];
    }
    const float m1 = warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
    for (int c = lane; c < D; c += 32)
      out(t, c, inv[t] * (g[c] * __ldg(gam + c) - m1 - x[c] * m2));
  }
}

// C[t, o] = sum_k A[t, k] * W[k, o] for t < rows and o < ncols, A [rows,
// K] (row stride lda) and W [K, ncols] (row stride ldw) in shared memory,
// handed to epi(t, o, float4 of columns o..o+3). K, ncols, lda and ldw are
// multiples of 4, A and W 16-byte aligned. An item is R rows x 4 columns;
// the lanes of a warp take neighbouring column quads (conflict-free float4
// loads of W, broadcast loads of A), and each W float4 feeds R rows; the k
// loop is unrolled U times. Each output is one fmaf chain over k in order,
// starting from init(t, o) (a float4 of columns o..o+3): a product over
// the rows of W cut into slices continues each chain from the slice
// before, so the sum is the one chain of the whole.
template <int R, int U, typename Init, typename Epi>
__device__ void smem_gemm_from(const float* A, int lda, int rows, int K, const float* W, int ldw,
                               int ncols, Init init, Epi epi) {
  const int N4 = ncols / 4, K4 = K / 4, lda4 = lda / 4, ldw4 = ldw / 4;
  const int items = (rows + R - 1) / R * N4;
  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float4* W4 = reinterpret_cast<const float4*>(W);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c4 = it % N4, t0 = it / N4 * R;
    float4 acc[R];
    int ta[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = min(t0 + r, rows - 1);  // ragged edge: never stored
      acc[r] = init(t, 4 * c4);
      ta[r] = t * lda4;
    }
#pragma unroll U
    for (int k4 = 0; k4 < K4; ++k4) {
      const float4 w0 = W4[(4 * k4 + 0) * ldw4 + c4], w1 = W4[(4 * k4 + 1) * ldw4 + c4];
      const float4 w2 = W4[(4 * k4 + 2) * ldw4 + c4], w3 = W4[(4 * k4 + 3) * ldw4 + c4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 a = A4[ta[r] + k4];
        acc[r].x = fmaf(a.x, w0.x, acc[r].x);
        acc[r].y = fmaf(a.x, w0.y, acc[r].y);
        acc[r].z = fmaf(a.x, w0.z, acc[r].z);
        acc[r].w = fmaf(a.x, w0.w, acc[r].w);
        acc[r].x = fmaf(a.y, w1.x, acc[r].x);
        acc[r].y = fmaf(a.y, w1.y, acc[r].y);
        acc[r].z = fmaf(a.y, w1.z, acc[r].z);
        acc[r].w = fmaf(a.y, w1.w, acc[r].w);
        acc[r].x = fmaf(a.z, w2.x, acc[r].x);
        acc[r].y = fmaf(a.z, w2.y, acc[r].y);
        acc[r].z = fmaf(a.z, w2.z, acc[r].z);
        acc[r].w = fmaf(a.z, w2.w, acc[r].w);
        acc[r].x = fmaf(a.w, w3.x, acc[r].x);
        acc[r].y = fmaf(a.w, w3.y, acc[r].y);
        acc[r].z = fmaf(a.w, w3.z, acc[r].z);
        acc[r].w = fmaf(a.w, w3.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (t0 + r < rows) epi(t0 + r, 4 * c4, acc[r]);
  }
}

// smem_gemm_from with every chain starting from 0.
template <int R, int U, typename Epi>
__device__ void smem_gemm(const float* A, int lda, int rows, int K, const float* W, int ldw,
                          int ncols, Epi epi) {
  smem_gemm_from<R, U>(A, lda, rows, K, W, ldw, ncols,
                       [](int, int) { return make_float4(0.f, 0.f, 0.f, 0.f); }, epi);
}

// dst <- src, n floats (n % 4 == 0, both 16-byte aligned; src global), by
// cp.async as one commit group, left in flight: cp_async_wait<G>() waits
// until at most G of the groups issued after it are pending.
__device__ __forceinline__ void cp_async_floats(float* dst, const float* __restrict__ src, int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16u * i), "l"(src + 4 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// dst <- *src, one float (4-byte aligned) by cp.async, for values whose
// source is not 16-byte aligned; the caller commits the group
// (cp_async_commit).
__device__ __forceinline__ void cp_async_float(float* dst, const float* __restrict__ src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
// dst <- src, one float4 (both 16-byte aligned) by cp.async; the caller
// commits the group.
__device__ __forceinline__ void cp_async_float4(float* dst, const float* __restrict__ src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int G>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(G) : "memory");
}

// --- weight gradients summed over the batch --------------------------------
// C[z] = A[z]^T . B[z] for z < Z: A[z] [K, M] and B[z] [K, N] row-major
// (z-strides K*M and K*N), C[z] [M, N]; K runs over every (row, position)
// of the batch. The TPU kernels sum these over a sequential grid into
// revisited output blocks; here the K rows are cut into S contiguous
// chunks, one block per (64 x 64 tile, z, chunk) writes its partial to
// P[z][s] [M, N], and sum_partials_kernel adds the S partials in a fixed
// order. No atomics: two equal calls give equal bits.

namespace {  // internal linkage: every .cu that includes this gets its own

constexpr int kWgTile = 64;
constexpr int kWgDepth = 16;

__global__ void __launch_bounds__(256)
wgrad_partial_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ P, int M, int N, int K, int S, int chunk) {
  __shared__ __align__(16) float As[kWgDepth][kWgTile];
  __shared__ __align__(16) float Bs[kWgDepth][kWgTile];
  const int z = blockIdx.z / S, s = blockIdx.z - z * S;
  const int m0 = blockIdx.y * kWgTile, n0 = blockIdx.x * kWgTile;
  const float* Az = A + (size_t)z * K * M;
  const float* Bz = B + (size_t)z * K * N;
  const int k_begin = s * chunk, k_end = min(K, k_begin + chunk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // this thread's elements of the next depth slice, loaded while the block
  // multiplies the current one
  constexpr int kLoads = kWgDepth * kWgTile / 256;
  float ra[kLoads], rb[kLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = threadIdx.x + q * 256, kk = i / kWgTile, c = i - kk * kWgTile;
      const int k = k0 + kk;
      ra[q] = (k < k_end && m0 + c < M) ? Az[(size_t)k * M + m0 + c] : 0.f;
      rb[q] = (k < k_end && n0 + c < N) ? Bz[(size_t)k * N + n0 + c] : 0.f;
    }
  };
  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kWgDepth) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = threadIdx.x + q * 256, kk = i / kWgTile, c = i - kk * kWgTile;
      As[kk][c] = ra[q];
      Bs[kk][c] = rb[q];
    }
    __syncthreads();
    if (k0 + kWgDepth < k_end) fetch(k0 + kWgDepth);
#pragma unroll
    for (int kk = 0; kk < kWgDepth; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* Pz = P + ((size_t)z * S + s) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) Pz[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// C[z][e] = sum over s < S of P[z][s][e] for e < n, in a fixed order: a
// block takes 32 neighbouring e of one z, each of its 8 warps adds a
// contiguous eighth of the S partials in order of s, and one warp adds the
// eight sums in order. Also the batch sum of per-row partials (Z = 1).
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ P, float* __restrict__ C, int S, int n) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t z = blockIdx.y, e = (size_t)blockIdx.x * 32 + lane;
  const int chunk = (S + 7) / 8, s0 = w * chunk, s1 = min(S, s0 + chunk);
  float acc = 0.f;
  if (e < (size_t)n) {
    const float* p = P + z * S * n + e;
    for (int s = s0; s < s1; ++s) acc += p[(size_t)s * n];
  }
  sums[w][lane] = acc;
  __syncthreads();
  if (w == 0 && e < (size_t)n) {
    float c = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) c += sums[q][lane];
    C[z * n + e] = c;
  }
}

cudaError_t sum_partials(const float* P, float* C, int Z, int S, int n,
                                cudaStream_t stream) {
  sum_partials_kernel<<<dim3((n + 31) / 32, Z), 256, 0, stream>>>(P, C, S, n);
  return cudaGetLastError();
}

// C = A^T . B as above, with S chunks of K and the partials in P [Z, S, M,
// N] (unused when S == 1: the single partial is C itself).
cudaError_t wgrad(const float* A, const float* B, float* C, float* P, int Z, int M, int N,
                         int K, int S, cudaStream_t stream) {
  if (S < 1) return cudaErrorInvalidValue;
  const int chunk = ((K + S - 1) / S + kWgDepth - 1) / kWgDepth * kWgDepth;
  dim3 grid((N + kWgTile - 1) / kWgTile, (M + kWgTile - 1) / kWgTile, Z * S);
  wgrad_partial_kernel<<<grid, 256, 0, stream>>>(A, B, S == 1 ? C : P, M, N, K, S, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return sum_partials(P, C, Z, S, M * N, stream);
}

// --- launches of thread-block clusters ---------------------------------------
// The set-up a configuration needs once per device, so that later calls go
// straight to the launch: the opt-in to its dynamic shared memory and the
// check that the card can schedule one of its clusters.
// The opt-in of kernel fn to `bytes` of dynamic shared memory on the
// current device, made once and raised, never lowered, as another shape
// may need more of the same kernel.
inline cudaError_t opt_in_smem(const void* fn, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = opted[{fn, dev}];
  if (bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) have = bytes;
  return err;
}

inline cudaError_t ready_to_launch(const void* fn, const cudaLaunchConfig_t& cfg, int N) {
  static std::mutex mu;
  static std::set<std::tuple<const void*, int, int, unsigned, size_t>> ready;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(fn, dev, N, cfg.blockDim.x, cfg.dynamicSmemBytes);
  std::lock_guard<std::mutex> lock(mu);
  if (ready.count(key)) return cudaSuccess;
  err = opt_in_smem(fn, cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;  // the plan cannot be scheduled
  ready.insert(key);
  return cudaSuccess;
}

// kernel<<<ctas, threads, smem, stream>>>(args...) in clusters of N CTAs
// along x (ctas a multiple of N).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int ctas, int N, int threads, size_t smem,
                           cudaStream_t stream, Args... args) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = ready_to_launch(fn, cfg, N);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

}  // namespace vsl
