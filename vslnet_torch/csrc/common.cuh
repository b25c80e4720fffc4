// Device helpers shared by the kernels of vslnet_torch (fp32 throughout).
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace vsl {

constexpr float kMaskValue = -1e30f;  // the reference's additive key mask
constexpr float kLnEps = 1e-6f;       // LayerNorm epsilon of the reference

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

// acc(t, o) = sum_k A[t, k] * W[k, o] for rows t < T and columns o in
// [c0, c1), handed to epi(t, o, acc). A [T, K] lies in shared memory with
// K % 4 == 0; W is row-major in global memory with leading dim ldw.
// A work item is one column and kRows consecutive rows: the lanes of a warp
// take neighbouring columns, so each W load is coalesced and each A load is
// one broadcast float4, and one W value feeds kRows multiply-adds.
template <int kRows, typename Epi>
__device__ void gemm_rows(const float* A, int T, int K, const float* __restrict__ W, int ldw,
                          int c0, int c1, Epi epi) {
  const int ncol = c1 - c0;
  const int items = ncol * ((T + kRows - 1) / kRows);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int o = c0 + it % ncol;
    const int t0 = (it / ncol) * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float w0 = __ldg(W + (size_t)(k + 0) * ldw + o);
      const float w1 = __ldg(W + (size_t)(k + 1) * ldw + o);
      const float w2 = __ldg(W + (size_t)(k + 2) * ldw + o);
      const float w3 = __ldg(W + (size_t)(k + 3) * ldw + o);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int t = min(t0 + r, T - 1);  // ragged edge: compute, never store
        const float4 a = *reinterpret_cast<const float4*>(A + (size_t)t * K + k);
        acc[r] = fmaf(a.x, w0, acc[r]);
        acc[r] = fmaf(a.y, w1, acc[r]);
        acc[r] = fmaf(a.z, w2, acc[r]);
        acc[r] = fmaf(a.w, w3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (t0 + r < T) epi(t0 + r, o, acc[r]);
  }
}

}  // namespace vsl
