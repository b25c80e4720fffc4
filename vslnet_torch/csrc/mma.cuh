// Tensor-core fragments for the bf16 kernels: mma.sync with bf16 operands
// and fp32 accumulators (m16n8k16, and m16n8k8 for head dim 8), ldmatrix
// (and .trans) out of shared memory, and the packing of an fp32 C fragment
// into a bf16 A fragment. That packing is a rounding point of the TPU
// kernels (`p.astype(dtype)` before a product with fp32 sums): an mma of
// bf16 operands with fp32 sums is `jnp.dot(..., preferred_element_type=
// jnp.float32)` on bf16 inputs.
//
// Fragments of one warp (lane = 4 g + tq, g = lane / 4, tq = lane % 4):
//   A [16 x 16] row-major: a0 = (row g, cols 2tq, 2tq+1), a1 = (row g+8,
//     same cols), a2 = (row g, cols 2tq+8, 2tq+9), a3 = (row g+8, those);
//     at k8, a0 and a1 only;
//   B [16 x 8] (k x n): b0 = (k 2tq, 2tq+1; n g), b1 = (k 2tq+8, 2tq+9; n g);
//   C [16 x 8] fp32: c0, c1 = (row g, cols 2tq, 2tq+1), c2, c3 = (row g+8).
// Shared tiles are rows of bf16 at a stride of an odd number of 16-byte
// chunks (tc_stride), so that the 8 rows an ldmatrix reads at once fall in
// distinct banks. At the end, the large products on Hopper's wgmma with
// operands brought by TMA (tc_gemm, wgrad_wg).
#pragma once

#include <cudaTypedefs.h>  // CUtensorMap, PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace vsl {

// The row stride, in bf16 values, of a shared tile of rows of n values (n
// a multiple of 8): n itself where it is an odd number of 16-byte chunks,
// else one chunk more (ops/kernels.py _tc_stride).
__host__ __device__ constexpr int tc_stride(int n) { return (n / 8) % 2 ? n : n + 8; }

// A fragments a k16 step of a row of HD values holds; at head dim 8 one
// step of k8 (a0, a1).
template <int HD>
constexpr int kSteps = HD >= 16 ? HD / 16 : 1;

// Two fp32 values as one bf16x2 register, each rounded to nearest even;
// lo in the low half (the lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lanes 0-7, 8-15 (and 16-23, 24-31 for x4) each give one row's address
// of an 8 x 8 matrix; register i receives matrix i, row g, values 2tq and
// 2tq+1 (.trans: column g, rows 2tq and 2tq+1).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b, [16 x 16] . [16 x 8], bf16 operands, fp32 sums.
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a . b, [16 x 8] . [8 x 8] (head dim 8).
__device__ __forceinline__ void mma8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The A fragments of a warp's 16 rows of HD bf16 values from device
// memory, rows g and g + 8 at r0 and r8 (4-byte aligned), each value
// multiplied by `scale` and rounded to bf16 where kScale, else taken as
// it is.
template <int HD, bool kScale>
__device__ __forceinline__ void load_a(uint32_t (&a)[kSteps<HD>][4], const __nv_bfloat16* r0,
                                       const __nv_bfloat16* r8, float scale) {
  const int tq = threadIdx.x & 3;
  const auto pair = [&](const __nv_bfloat16* row, int col) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(row + col);
    if constexpr (!kScale) return u;
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    return pack_bf16(f.x * scale, f.y * scale);
  };
#pragma unroll
  for (int ks = 0; ks < kSteps<HD>; ++ks) {
    a[ks][0] = pair(r0, 16 * ks + 2 * tq);
    a[ks][1] = pair(r8, 16 * ks + 2 * tq);
    if constexpr (HD >= 16) {
      a[ks][2] = pair(r0, 16 * ks + 8 + 2 * tq);
      a[ks][3] = pair(r8, 16 * ks + 8 + 2 * tq);
    } else {
      a[ks][2] = a[ks][3] = 0u;
    }
  }
}

// c[n] = A . rows^T for a warp: A [16 x HD] in fragments, rows 16 shared
// rows of HD values at stride ld (n = 0: rows 0-7, n = 1: rows 8-15).
// With kAdd each k16 step after the first starts from zero and is added
// to c by fp32 adds (see mma_ab).
template <int HD, bool kAdd = false>
__device__ __forceinline__ void mma_abt(float (&c)[2][4], const uint32_t (&a)[kSteps<HD>][4],
                                        const __nv_bfloat16* rows, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  if constexpr (HD == 8) {
    uint32_t b[2];
    ldsm_x2(b, rows + (lane & 15) * ld);
    mma8(c[0], a[0][0], a[0][1], b[0]);
    mma8(c[1], a[0][0], a[0][1], b[1]);
  } else {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, rows + ((lane & 7) + ((lane >> 4) << 3)) * ld + 16 * ks + ((lane >> 3) & 1) * 8);
      if (kAdd && ks > 0) {
        float t[2][4] = {};
        mma16(t[0], a[ks], b[0], b[1]);
        mma16(t[1], a[ks], b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[0][e] += t[0][e];
          c[1][e] += t[1][e];
        }
      } else {
        mma16(c[0], a[ks], b[0], b[1]);
        mma16(c[1], a[ks], b[2], b[3]);
      }
    }
  }
}

// acc += P . rows for a warp: P [16 x 16] in A fragments, rows 16 shared
// rows of HD values at stride ld (the k dimension), read by ldmatrix.trans.
// The tensor cores' own accumulation into acc is not an fp32 add rounded
// to nearest: chained over the 64 steps of path L's 1024 queries, the bf16
// flash backward's dK and dV differed from their twin more often than with
// fp32 adds. With kAdd each product starts from zero and is added to acc
// by fp32 adds.
template <int HD, bool kAdd = false>
__device__ __forceinline__ void mma_ab(float (&acc)[HD / 8][4], const uint32_t (&p)[4],
                                       const __nv_bfloat16* rows, int ld) {
  const int lane = threadIdx.x & 31;
  const auto step = [&](float (&c)[4], uint32_t b0, uint32_t b1) {
    if constexpr (kAdd) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma16(t, p, b0, b1);
#pragma unroll
      for (int u = 0; u < 4; ++u) c[u] += t[u];
    } else {
      mma16(c, p, b0, b1);
    }
  };
  if constexpr (HD == 8) {
    uint32_t b[2];
    ldsm_x2_trans(b, rows + (lane & 15) * ld);
    step(acc[0], b[0], b[1]);
  } else {
#pragma unroll
    for (int dn = 0; dn < HD / 8; dn += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, rows + (lane & 15) * ld + 8 * (dn + (lane >> 4)));
      step(acc[dn], b[0], b[1]);
      step(acc[dn + 1], b[2], b[3]);
    }
  }
}

// The A fragment [16 x 16] of the bf16 values of two C fragments side by
// side (columns 0-7 in c[0], 8-15 in c[1]).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// --- small products out of shared memory, a warp an item ----------------------
// C = A . W over the rows [0, 16 mtiles) of A [.][lda] and the columns [0,
// 16 nblocks) of W [Dk][ldw], both bf16 in shared memory with k along A's
// rows and down W's columns (Dk a multiple of 64; A's columns and W's rows
// past the operands' k are 0): the bf16 T-tiled conv forward's and the bf16
// MHA block forward's products, the TPU kernels' jnp.dot of bf16 values
// with fp32 accumulation. A warp takes the items (16 rows, 16 columns) w,
// w + nwarps, ...: A's fragments by ldmatrix, W's by ldmatrix.trans; each
// group of 4 k16 steps accumulates in the tensor cores from zero and is
// added to the item's sums by an fp32 add, groups in order of k (the chains
// of 4 of tc_gemm below: chains of 8 drift, PERF.md). epi(r, c, v0, v1)
// takes each pair of neighbouring outputs (c even) of every item, rows and
// columns past the caller's ranges included, from all 32 lanes of the warp
// at once, so that it may shuffle.
template <typename Epi>
__device__ __forceinline__ void tile_mma(const __nv_bfloat16* A, int lda, int mtiles,
                                         const __nv_bfloat16* W, int ldw, int nblocks, int Dk,
                                         Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  for (int item = warp; item < mtiles * nblocks; item += nwarps) {
    const int m0 = 16 * (item / nblocks), n0 = 16 * (item % nblocks);
    float sum[2][4];
    for (int k = 0; k < Dk; k += 64) {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k0 = k + 16 * q;
        uint32_t a[4], b[4];
        ldsm_x4(a, A + (size_t)(m0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
        ldsm_x4_trans(b, W + (size_t)(k0 + (lane & 15)) * ldw + n0 + (lane >> 4) * 8);
        mma16(c[0], a, b[0], b[1]);
        mma16(c[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[h][e] = k ? sum[h][e] + c[h][e] : c[h][e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        epi(m0 + g + 8 * u, n0 + 8 * h + 2 * tq, sum[h][2 * u], sum[h][2 * u + 1]);
  }
}

// C = A . W^T for the 16 rows of a tile of A [16][K] (bf16 rows lda values
// apart, in device or shared memory, read as 4-byte pairs straight into A
// fragments: rows past `rows` read as row 0, k past K as 0; K % 8 == 0)
// and the rows [0, 16 nblocks) of W [.][ldw] in shared memory (bf16, k
// along each row, Kp = K rounded up to 64, W's columns [K, Kp) 0): the
// bf16 MHA block backward's products with a weight's transpose, W's rows
// read as they are stored (B fragments by ldmatrix, no transpose), as
// tile_mma's with each group of 4 k16 steps accumulated in the tensor
// cores from zero and added by an fp32 add, groups in order of k. A warp
// takes the column blocks w, w + nwarps, ...; epi(r, c, v0, v1) as
// tile_mma's, from all 32 lanes at once.
template <typename Epi>
__device__ __forceinline__ void tile_mma_bt(const __nv_bfloat16* A, size_t lda, int rows, int K,
                                            const __nv_bfloat16* W, int ldw, int nblocks, int Kp,
                                            Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* r0 = A + (g < rows ? (size_t)g * lda : 0);
  const __nv_bfloat16* r8 = A + (g + 8 < rows ? (size_t)(g + 8) * lda : 0);
  const auto pair = [&](const __nv_bfloat16* row, int k) {
    return k < K ? *reinterpret_cast<const uint32_t*>(row + k) : 0u;
  };
  for (int nb = warp; nb < nblocks; nb += nwarps) {
    const int n0 = 16 * nb;
    float sum[2][4];
    for (int k = 0; k < Kp; k += 64) {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k0 = k + 16 * j;
        uint32_t a[4], b[4];
        a[0] = pair(r0, k0 + 2 * tq);
        a[1] = pair(r8, k0 + 2 * tq);
        a[2] = pair(r0, k0 + 8 + 2 * tq);
        a[3] = pair(r8, k0 + 8 + 2 * tq);
        ldsm_x4(b, W + (size_t)(n0 + (lane & 7) + ((lane >> 4) << 3)) * ldw + k0 +
                       ((lane >> 3) & 1) * 8);
        mma16(c[0], a, b[0], b[1]);
        mma16(c[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[h][e] = k == 0 ? c[h][e] : sum[h][e] + c[h][e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        epi(g + 8 * u, n0 + 8 * h + 2 * tq, sum[h][2 * u], sum[h][2 * u + 1]);
  }
}

// --- bf16 weight gradients on mma.sync ---------------------------------------
// C[z] = A[z]^T . B[z] for z < Z, as common.cuh wgrad computes it (A[z] [K,
// M], B[z] [K, N] row-major, K every (row, position) of the batch, C[z] [M,
// N] fp32), for the bf16 backwards whose TPU kernels sum bf16 operands in
// fp32: A is rounded to bf16 as it is loaded (it may be stored in fp32), B
// is stored in bf16. The form for fp32 A (the LSTM's h_prev: TMA cannot
// round it) and for the T-tiled conv backward's dwp at D = 128 (host-paced
// paths, where wgrad_wg's two tensor maps a call cost more than its device
// time saves); the wide kernels' run on wgrad_wg. The K rows are cut into S contiguous chunks, one block
// per (64 x 64 tile, z, chunk) writes its partial to P[z][s] [M, N] and
// sum_partials adds them in a fixed order: no atomics, equal calls give
// equal bits. A block is 8 warps; warp w takes the tile's rows [16 (w % 4),
// + 16) and columns [32 (w / 4), + 32), 32 rows of K a stage through shared
// memory (ldmatrix.trans of both operands), the next stage's loads in
// flight while the block multiplies the current one: 16-byte loads of 8
// values where M and N are multiples of 8 (kVec), else one value a load.
// Each k16 product starts from zero and is added to the sums by fp32 adds
// (mma_ab's kAdd): over the thousands of rows of K the tensor cores' own
// accumulation drifts further from fp32.
constexpr int kTcWgTile = 64;
constexpr int kTcWgDepth = 32;
constexpr int kTcWgThreads = 256;
constexpr int kTcWgStride = tc_stride(kTcWgTile);

namespace {  // internal linkage: every .cu that includes this gets its own

// 8 neighbouring values of a row of `n` at p + c (c + 8 <= n or none), as
// 8 bf16 in a uint4; 0 where `on` is false.
__device__ __forceinline__ uint4 load8_bf16(const float* p, bool on) {
  if (!on) return make_uint4(0u, 0u, 0u, 0u);
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                    pack_bf16(b.z, b.w));
}
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p, bool on) {
  return on ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

template <typename TA, bool kVec>
__global__ void __launch_bounds__(kTcWgThreads)
wgrad_tc_partial_kernel(const TA* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                        float* __restrict__ P, int M, int N, int K, int S, int chunk) {
  __shared__ __align__(16) __nv_bfloat16 As[kTcWgDepth][kTcWgStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[kTcWgDepth][kTcWgStride];
  const int z = blockIdx.z / S, s = blockIdx.z - z * S;
  const int m0 = blockIdx.y * kTcWgTile, n0 = blockIdx.x * kTcWgTile;
  const TA* Az = A + (size_t)z * K * M;
  const __nv_bfloat16* Bz = B + (size_t)z * K * N;
  const int k_begin = s * chunk, k_end = min(K, k_begin + chunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 16 * (warp & 3), wn = 32 * (warp >> 2);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // this thread's share of the next stage, loaded while the block
  // multiplies the current one: a chunk of 8 values of each operand
  // (kVec), else 8 single values
  constexpr int kLoads = kTcWgDepth * kTcWgTile / kTcWgThreads;
  uint4 va, vb;
  __nv_bfloat16 ra[kLoads], rb[kLoads];
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int vk = threadIdx.x >> 3, vc = (threadIdx.x & 7) * 8;
  auto fetch = [&](int k0) {
    if constexpr (kVec) {
      const int k = k0 + vk;
      va = load8_bf16(Az + (size_t)k * M + m0 + vc, k < k_end && m0 + vc < M);
      vb = load8_bf16(Bz + (size_t)k * N + n0 + vc, k < k_end && n0 + vc < N);
    } else {
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int i = threadIdx.x + q * kTcWgThreads, kk = i / kTcWgTile;
        const int c = i - kk * kTcWgTile, k = k0 + kk;
        ra[q] = (k < k_end && m0 + c < M) ? __float2bfloat16(to_float(Az[(size_t)k * M + m0 + c]))
                                          : zero;
        rb[q] = (k < k_end && n0 + c < N) ? Bz[(size_t)k * N + n0 + c] : zero;
      }
    }
  };
  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kTcWgDepth) {
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(&As[vk][vc]) = va;
      *reinterpret_cast<uint4*>(&Bs[vk][vc]) = vb;
    } else {
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int i = threadIdx.x + q * kTcWgThreads, kk = i / kTcWgTile;
        As[kk][i - kk * kTcWgTile] = ra[q];
        Bs[kk][i - kk * kTcWgTile] = rb[q];
      }
    }
    __syncthreads();
    if (k0 + kTcWgDepth < k_end) fetch(k0 + kTcWgDepth);
#pragma unroll
    for (int ks = 0; ks < kTcWgDepth / 16; ++ks) {
      // A^T's fragment [16 rows of M x 16 of K]: matrix i of ldmatrix.trans
      // is K rows 16 ks + 8 (i >> 1).., M columns wm + 8 (i & 1)
      const int i = lane >> 3;
      uint32_t a[4];
      ldsm_x4_trans(a, &As[16 * ks + (lane & 7) + ((i >> 1) << 3)][wm + ((i & 1) << 3)]);
      float t[4][4];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, &Bs[16 * ks + (lane & 15)][wn + 8 * (j + (lane >> 4))]);
#pragma unroll
        for (int e = 0; e < 4; ++e) t[j][e] = t[j + 1][e] = 0.f;
        mma16(t[j], a, b[0], b[1]);
        mma16(t[j + 1], a, b[2], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += t[j][e];
    }
    __syncthreads();
  }
  float* Pz = P + ((size_t)z * S + s) * M * N;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm + g + (e >> 1) * 8, n = n0 + wn + 8 * j + 2 * tq + (e & 1);
      if (m < M && n < N) Pz[(size_t)m * N + n] = acc[j][e];
    }
}

}  // namespace

// C = A^T . B as above, with S chunks of K and the partials in P [Z, S, M,
// N] (unused when S == 1: the single partial is C itself).
template <typename TA>
cudaError_t wgrad_tc(const TA* A, const __nv_bfloat16* B, float* C, float* P, int Z, int M,
                     int N, int K, int S, cudaStream_t stream) {
  if (S < 1) return cudaErrorInvalidValue;
  const int chunk = ((K + S - 1) / S + kTcWgDepth - 1) / kTcWgDepth * kTcWgDepth;
  dim3 grid((N + kTcWgTile - 1) / kTcWgTile, (M + kTcWgTile - 1) / kTcWgTile, Z * S);
  float* out = S == 1 ? C : P;
  if (M % 8 == 0 && N % 8 == 0)
    wgrad_tc_partial_kernel<TA, true><<<grid, kTcWgThreads, 0, stream>>>(A, B, out, M, N, K, S, chunk);
  else
    wgrad_tc_partial_kernel<TA, false><<<grid, kTcWgThreads, 0, stream>>>(A, B, out, M, N, K, S, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return sum_partials(P, C, Z, S, M * N, stream);
}

// --- bf16 products on Hopper's wgmma, operands by TMA -------------------------
// C = A . B over tiles of 128 x 128 of C, bf16 operands and fp32 sums: the
// products of the wide block kernels (tc_gemm) and their weight gradients
// (wgrad_wg), the TPU kernels' `jnp.dot` of bf16 values with
// preferred_element_type fp32. What bounds them: their operations (2 M N K
// on the tensor cores) against the bytes of A, B and the epilogue's C.
// A CTA: a producer warpgroup, one thread of which keeps a ring of
// kGemmStages stages full by TMA (a stage: kGemmK values of k of A's 128
// rows and of B's 128 columns, 32 KB in the 128-byte swizzle, each row or
// column of 64 values one 128-byte line) under full and empty mbarriers,
// and two consumer warpgroups, each taking 64 rows x 128 columns of the tile
// by wgmma.mma_async m64n128k16 straight out of the ring. The tensor cores'
// own accumulation over long chains drifts from fp32 adds (mma_ab), so a
// chain of kGemmChain k16 steps (one stage) runs in the tensor cores from
// zero (scale-d 0 on its first wgmma) and is then added to the fp32 sums by
// fp32 adds: against an fp64 product, chains of 8 read up to twice the
// distance of a k16 step's fp32 adds where a split of K is short (K <= 768),
// chains of 4 within 1.24 of it, and both closer where K is long
// (bench/gemm_plans.py, PERF.md). A consumer thread so holds 64 sums and a
// chain of 64: with
// setmaxnreg (kGemmProducerRegs, kGemmConsumerRegs) one CTA fills an SM's
// registers, so the grid is persistent: a CTA an SM walks the tiles in
// turn, and its producer fills the next tile's stages while the consumers
// run this tile's epilogue. Operands out of bounds (A's rows past M, k past
// K) are read as zeros by the TMA unit.
// Each pair of neighbouring outputs goes to epi(m, n, c_mn, c_m(n+1)) (n
// even), for every row m of the tile, m >= M included, with the warp's
// lanes converged so that an epilogue may shuffle: epi ignores m >= M. A
// thread's pairs are those of mma.sync's C fragments: rows 16 w + g and
// 16 w + g + 8 of its warp's 16 rows, columns 8 j + 2 tq and 8 j + 2 tq + 1
// (lane = 4 g + tq).
constexpr int kGemmM = 128;
constexpr int kGemmN = 128;
constexpr int kGemmK = 64;
constexpr int kGemmStages = 6;
constexpr int kGemmChain = 4;  // k16 steps a chain of tensor-core sums
constexpr int kGemmThreads = 384;
constexpr int kGemmProducerRegs = 40;
constexpr int kGemmConsumerRegs = 232;
constexpr int kGemmStageBytes = 2 * (kGemmM + kGemmN) * kGemmK;
constexpr int kGemmChainStages = kGemmChain * 16 / kGemmK;
static_assert(kGemmChainStages == 1 || kGemmChainStages == 2,
              "wg_gemm_kernel's last chain of an item is one stage");

// The ring, its full and empty mbarriers, and the slack that aligns the
// ring to the swizzle's 1024 bytes (ops/kernels.py _gemm_smem_bytes).
constexpr size_t gemm_smem_bytes() {
  return 1024 + (size_t)kGemmStages * kGemmStageBytes + 2 * kGemmStages * sizeof(uint64_t);
}

// TMA reads 16-byte aligned bases and row strides.
inline bool gemm_aligned(const void* A, const void* B) {
  return reinterpret_cast<uintptr_t>(A) % 16 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
}

// tc_gemm takes whole tiles of columns and whole stages of k.
inline bool tc_gemm_ok(int M, int N, int K, int lda, int ldb) {
  return M >= 1 && N >= kGemmN && N % kGemmN == 0 && K >= kGemmK && K % kGemmK == 0 &&
         lda % 8 == 0 && ldb % 8 == 0;
}

// wgrad_wg takes whole tiles of C (every box the TMA unit reads holds a
// row or column in bounds) and any K.
inline bool wgrad_wg_ok(int Z, int M, int N, int K, int S) {
  return Z >= 1 && M >= kGemmM && M % kGemmM == 0 && N >= kGemmN && N % kGemmN == 0 && K >= 1 &&
         S >= 1;
}

namespace {  // internal linkage: every .cu that includes this gets its own

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// One arrival that also expects `bytes` of TMA loads this phase.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// The box of `map` at (c0, c1, c2), innermost first, into shared memory at
// dst; its bytes complete the transaction count of the mbarrier at bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// A wgmma operand in shared memory, 128-byte swizzle: its start, the byte
// offsets between its 64-value lines' neighbours in the two directions
// (K-major: sbo between groups of 8 rows, lbo unused; MN-major: sbo between
// groups of 8 values of k, lbo between 64-value spans of M or N).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}
// d (+)= A . B for 64 x 128 of C over 16 values of k; kTA, kTB: A, B
// MN-major (transposed); d starts from zero where accumulate is 0.
template <int kTA, int kTB>
__device__ __forceinline__ void mma_128(float (&d)[64], uint64_t a, uint64_t b,
                                        uint32_t accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
}
// The registers of d stay where the wgmma instructions put them: the
// compiler may not move their reads across these points.
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A work item of the grid: (z, split s, row tile, column tile), the column
// tile fastest, and its stages [kt0, kt1) of k.
struct Item {
  int z, s, m0, n0, kt0, kt1;
};
__device__ __forceinline__ Item item_at(int it, int M, int N, int K, int S, int chunk) {
  const int tn = N / kGemmN, per = ((M + kGemmM - 1) / kGemmM) * tn;
  const int zs = it / per, t = it - zs * per;
  const int kts = (K + kGemmK - 1) / kGemmK;
  Item r;
  r.z = zs / S;
  r.s = zs - r.z * S;
  r.m0 = (t / tn) * kGemmM;
  r.n0 = (t - (t / tn) * tn) * kGemmN;
  r.kt0 = min(r.s * chunk, kts);
  r.kt1 = min(r.kt0 + chunk, kts);
  return r;
}

}  // namespace wg

// wgrad_wg's epilogue: partial (z, s) of C, rows below M.
struct WgradOut {
  float* out;
};

// kAT: A given as [K, M] (MN-major; wgrad_wg's A^T . B), else [M, K]; kBT: B
// given as B^T [N, K] (K-major), else [K, N]. Items (z, s, m, n) of S splits
// of `chunk` stages of k each.
template <bool kAT, bool kBT, typename Epi>
__global__ void __launch_bounds__(kGemmThreads, 1)
wg_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               int M, int N, int K, int S, int chunk, int items, Epi epi) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t base = (wg::smem_u32(gemm_smem) + 1023u) & ~1023u;
  const uint32_t full0 = base + kGemmStages * kGemmStageBytes, empty0 = full0 + 8 * kGemmStages;
  constexpr uint32_t kHalf = 64 * 128;  // bytes of 64 lines of 128 bytes
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      wg::bar_init(full0 + 8 * s, 1);
      wg::bar_init(empty0 + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int group = threadIdx.x >> 7;
  if (group == 0) {
    // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kGemmProducerRegs));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const wg::Item w = wg::item_at(it, M, N, K, S, chunk);
        for (int kt = w.kt0; kt < w.kt1; ++kt) {
          wg::bar_wait(empty0 + 8 * stage, phase ^ 1u);
          const uint32_t bar = full0 + 8 * stage;
          wg::bar_expect(bar, kGemmStageBytes);
          const uint32_t a = base + stage * kGemmStageBytes, b = a + 2 * kHalf;
          const int k0 = kt * kGemmK;
          if constexpr (kAT) {  // [k][m] lines, two spans of 64 rows of C
            wg::tma_load(a, map_a, bar, w.m0, k0, w.z);
            wg::tma_load(a + kHalf, map_a, bar, w.m0 + 64, k0, w.z);
          } else {  // [m][k] lines, 128 rows
            wg::tma_load(a, map_a, bar, k0, w.m0, w.z);
          }
          if constexpr (kBT) {  // [n][k] lines, 128 columns
            wg::tma_load(b, map_b, bar, k0, w.n0, w.z);
          } else {  // [k][n] lines, two spans of 64 columns
            wg::tma_load(b, map_b, bar, w.n0, k0, w.z);
            wg::tma_load(b + kHalf, map_b, bar, w.n0 + 64, k0, w.z);
          }
          if (++stage == kGemmStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kGemmConsumerRegs));
    const int c = group - 1;  // this warpgroup's 64 rows of the tile
    const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
    int stage = 0;
    uint32_t phase = 0;
    // one stage's 4 k16 steps of the chain; scale-d 0 on a chain's first
    const auto step = [&](float (&ch)[64], bool first) {
      wg::bar_wait(full0 + 8 * stage, phase);
      const uint32_t a = base + stage * kGemmStageBytes + c * kHalf, b = base + stage * kGemmStageBytes + 2 * kHalf;
#pragma unroll
      for (int kk = 0; kk < kGemmK / 16; ++kk) {
        const uint64_t da = kAT ? wg::desc(a + kk * 2048, kHalf, 1024) : wg::desc(a + kk * 32, 16, 1024);
        const uint64_t db = kBT ? wg::desc(b + kk * 32, 16, 1024) : wg::desc(b + kk * 2048, kHalf, 1024);
        wg::mma_128<kAT ? 1 : 0, kBT ? 0 : 1>(ch, da, db, (first && kk == 0) ? 0u : 1u);
      }
      if (++stage == kGemmStages) {
        stage = 0;
        phase ^= 1u;
      }
    };
    // the n stages before `stage` are read: every consumer thread arrives
    const auto release = [&](int n) {
      for (int i = n; i >= 1; --i) wg::bar_arrive(empty0 + 8 * ((stage - i + kGemmStages) % kGemmStages));
    };
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const wg::Item w = wg::item_at(it, M, N, K, S, chunk);
      float acc[64], ch[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int kt = w.kt0;
      for (; kt + kGemmChainStages <= w.kt1; kt += kGemmChainStages) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int t = 0; t < kGemmChainStages; ++t) step(ch, t == 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        wg::hold(ch);
        release(kGemmChainStages);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += ch[i];
      }
      if (kt < w.kt1) {  // a last chain of one stage
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        step(ch, true);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        wg::hold(ch);
        release(1);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += ch[i];
      }
      const int row = w.m0 + 64 * c + 16 * w4 + (lane >> 2), col = w.n0 + 2 * (lane & 3);
      if constexpr (kAT) {
        float* out = epi.out + ((size_t)w.z * S + w.s) * M * N;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * N + col + 8 * j) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            epi(row + 8 * h, col + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, the CUDA library entry point, found through the
// runtime so that the library links no -lcuda.
inline PFN_cuTensorMapEncodeTiled tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a bf16 tensor of Z slices (zs values apart) of `outer` lines of
// `inner` values (ld values apart), read in boxes of box0 values x box1
// lines in the 128-byte swizzle; values out of bounds read as zeros.
inline cudaError_t gemm_map(CUtensorMap* map, const void* p, int inner, int outer, int Z, size_t ld,
                            size_t zs, int box0, int box1) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)zs * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The SMs of the current device: the persistent grid's CTAs.
inline cudaError_t gemm_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

template <bool kAT, bool kBT, typename Epi>
cudaError_t launch_wg_gemm(const CUtensorMap& ma, const CUtensorMap& mb, int M, int N, int K,
                           int Z, int S, int chunk, Epi epi, cudaStream_t stream) {
  const int items = Z * S * ((M + kGemmM - 1) / kGemmM) * (N / kGemmN);
  int sms = 0;
  const cudaError_t err = gemm_sms(&sms);
  if (err != cudaSuccess) return err;
  return launch_opted(wg_gemm_kernel<kAT, kBT, Epi>, dim3(std::min(items, sms)), kGemmThreads,
                      gemm_smem_bytes(), stream, ma, mb, M, N, K, S, chunk, items, epi);
}

}  // namespace

// tc_gemm's epilogue that stores C's rows below M as they are, fp32.
struct TcStoreRows {
  float* out;
  int M, N;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    if (m < M) *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(v0, v1);
  }
};

// C = A . B for A [M, K] bf16 row-major (row stride lda) and B [K, N] bf16
// row-major (row stride ldb), or with kBT B^T given as [N, K] row-major (a
// product with a weight's transpose, W [N, K] read as it is stored), on
// wg_gemm_kernel with C's pairs to epi. Needs N % 128 == 0, K % 64 == 0,
// lda and ldb multiples of 8, A and B 16-byte aligned (tc_gemm_ok,
// gemm_aligned).
template <bool kBT, typename Epi>
cudaError_t tc_gemm(const __nv_bfloat16* A, const __nv_bfloat16* B, int M, int N, int K, int lda,
                    int ldb, Epi epi, cudaStream_t stream) {
  if (!tc_gemm_ok(M, N, K, lda, ldb) || !gemm_aligned(A, B) || lda < K || ldb < (kBT ? K : N))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = gemm_map(&ma, A, K, M, 1, lda, (size_t)lda * M, kGemmK, kGemmM);
  if (err == cudaSuccess)
    err = kBT ? gemm_map(&mb, B, K, N, 1, ldb, (size_t)ldb * N, kGemmK, kGemmN)
              : gemm_map(&mb, B, N, K, 1, ldb, (size_t)ldb * K, 64, kGemmK);
  if (err != cudaSuccess) return err;
  return launch_wg_gemm<false, kBT>(ma, mb, M, N, K, 1, 1, (K + kGemmK - 1) / kGemmK, epi, stream);
}

// C[z] = A[z]^T . B[z] for z < Z (A[z] [K, M], B[z] [K, N] bf16 row-major,
// K every (row, position) of the batch, C[z] [M, N] fp32) on
// wg_gemm_kernel: the K rows cut into S splits of whole chains, one item
// per (z, split, tile) writing its partial to P[z][s] [M, N] (C itself
// where S == 1), and sum_partials adding them in a fixed order: no
// atomics, equal calls give equal bits (ops/kernels.py wgrad_splits
// chooses S).
inline cudaError_t wgrad_wg(const __nv_bfloat16* A, const __nv_bfloat16* B, float* C, float* P,
                            int Z, int M, int N, int K, int S, cudaStream_t stream) {
  if (!wgrad_wg_ok(Z, M, N, K, S) || !gemm_aligned(A, B)) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  cudaError_t err = gemm_map(&ma, A, M, K, Z, M, (size_t)K * M, 64, kGemmK);
  if (err == cudaSuccess) err = gemm_map(&mb, B, N, K, Z, N, (size_t)K * N, 64, kGemmK);
  if (err != cudaSuccess) return err;
  const int kts = (K + kGemmK - 1) / kGemmK;
  const int chunk = ((kts + S - 1) / S + kGemmChainStages - 1) / kGemmChainStages * kGemmChainStages;
  err = launch_wg_gemm<true, false>(ma, mb, M, N, K, Z, S, chunk, WgradOut{S == 1 ? C : P}, stream);
  if (err != cudaSuccess || S == 1) return err;
  return sum_partials(P, C, Z, S, M * N, stream);
}

}  // namespace vsl
