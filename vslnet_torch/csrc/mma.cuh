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
// distinct banks.
#pragma once

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

// --- bf16 weight gradients on the tensor cores -------------------------------
// C[z] = A[z]^T . B[z] for z < Z, as common.cuh wgrad computes it (A[z] [K,
// M], B[z] [K, N] row-major, K every (row, position) of the batch, C[z] [M,
// N] fp32), for the bf16 backwards whose TPU kernels sum bf16 operands in
// fp32: A is rounded to bf16 as it is loaded (it may be stored in fp32), B
// is stored in bf16. The K rows are cut into S contiguous chunks, one block
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

// --- bf16 products of the wide block kernels on the tensor cores ------------
// C = A . B for A [M, K] bf16 row-major (row stride lda) and B [K, N] bf16
// row-major (row stride ldb), or with kBT B^T given as [N, K] row-major (a
// product with a weight's transpose, W [N, K] read as it is stored), bf16
// operands and fp32 sums: the TPU kernels' `jnp.dot` of bf16 values with
// preferred_element_type fp32. A block takes a 128 x 128 tile of C with 8
// warps of 64 x 32 (4 x 4 fragments each), K in steps of 32 through a ring
// of kTcGemmStages stages that 16-byte cp.async fills (rows of A past M
// read as zeros); each k16 product starts from zero and is added to the
// sums by fp32 adds (mma_ab's kAdd). Each pair of neighbouring outputs
// goes to epi(m, n, c_mn, c_m(n+1)) (n even), for every row m of the tile,
// m >= M included, so that an epilogue's lanes stay converged for a warp
// shuffle: epi ignores m >= M. Needs N % 128 == 0, K % 32 == 0, lda and
// ldb multiples of 8, A and B 16-byte aligned (tc_gemm_ok).
constexpr int kTcGemmM = 128;
constexpr int kTcGemmN = 128;
constexpr int kTcGemmK = 32;
constexpr int kTcGemmStages = 3;
constexpr int kTcGemmThreads = 256;
constexpr int kTcGemmKStride = tc_stride(kTcGemmK);   // rows of 32 k values
constexpr int kTcGemmNStride = tc_stride(kTcGemmN);   // rows of 128 n values

// The ring's bytes: a stage holds A's [128][32] and B's [32][128] (or with
// kBT [128][32]) at the strides above.
template <bool kBT>
constexpr size_t tc_gemm_smem_bytes() {
  return (size_t)kTcGemmStages * 2 *
         (kTcGemmM * kTcGemmKStride + (kBT ? kTcGemmN * kTcGemmKStride
                                           : kTcGemmK * kTcGemmNStride));
}

inline bool tc_gemm_ok(int M, int N, int K, int lda, int ldb) {
  return M >= 1 && N >= kTcGemmN && N % kTcGemmN == 0 && K >= kTcGemmK && K % kTcGemmK == 0 &&
         lda % 8 == 0 && ldb % 8 == 0;
}

namespace {  // internal linkage: every .cu that includes this gets its own

template <bool kBT, typename Epi>
__global__ void __launch_bounds__(kTcGemmThreads)
tc_gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B, int M,
               int K, int lda, int ldb, Epi epi) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  constexpr int kAElems = kTcGemmM * kTcGemmKStride;
  constexpr int kBElems = kBT ? kTcGemmN * kTcGemmKStride : kTcGemmK * kTcGemmNStride;
  bf16* As = reinterpret_cast<bf16*>(smem4);
  bf16* Bs = As + kTcGemmStages * kAElems;
  const int m0 = blockIdx.y * kTcGemmM, n0 = blockIdx.x * kTcGemmN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = 64 * (warp >> 2), wn = 32 * (warp & 3);
  // a stage: 512 chunks of 16 bytes of each operand, two a thread
  const auto load = [&](int kt, int slot) {
    const int k0 = kt * kTcGemmK;
    bf16* as = As + slot * kAElems;
    bf16* bs = Bs + slot * kBElems;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = tid + h * kTcGemmThreads;
      const int r = i >> 2, c = (i & 3) * 8;  // A: row r of 128, chunk c of 32
      const int m = m0 + r;
      cp_async16(as + r * kTcGemmKStride + c, A + (size_t)min(m, M - 1) * lda + k0 + c, m < M);
      if constexpr (kBT) {  // B^T rows: n r, k chunk c
        cp_async16(bs + r * kTcGemmKStride + c, B + (size_t)(n0 + r) * ldb + k0 + c, true);
      } else {  // B rows: k i / 16, n chunk (i % 16) * 8
        const int kr = i >> 4, nc = (i & 15) * 8;
        cp_async16(bs + kr * kTcGemmNStride + nc, B + (size_t)(k0 + kr) * ldb + n0 + nc, true);
      }
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int KT = K / kTcGemmK;
#pragma unroll
  for (int s = 0; s + 1 < kTcGemmStages; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kTcGemmStages - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 read by every warp
    const int next = kt + kTcGemmStages - 1;
    if (next < KT) load(next, next % kTcGemmStages);
    cp_async_commit();
    const bf16* as = As + (kt % kTcGemmStages) * kAElems;
    const bf16* bs = Bs + (kt % kTcGemmStages) * kBElems;
#pragma unroll
    for (int ks = 0; ks < kTcGemmK / 16; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i],
                as + (wm + 16 * i + (lane & 15)) * kTcGemmKStride + 16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        if constexpr (kBT)
          ldsm_x4(r, bs + (wn + 8 * j + (lane & 7) + ((lane >> 4) << 3)) * kTcGemmKStride +
                         16 * ks + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_trans(r, bs + (16 * ks + (lane & 15)) * kTcGemmNStride + wn +
                               8 * (j + (lane >> 4)));
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma16(t, a[i], b[j][0], b[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
    }
  }
  cp_async_wait<0>();
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        epi(m0 + wm + 16 * i + g + 8 * h, n0 + wn + 8 * j + 2 * tq, acc[i][j][2 * h],
            acc[i][j][2 * h + 1]);
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

// The launch of tc_gemm_kernel over C [M, N].
template <bool kBT, typename Epi>
cudaError_t tc_gemm(const __nv_bfloat16* A, const __nv_bfloat16* B, int M, int N, int K, int lda,
                    int ldb, Epi epi, cudaStream_t stream) {
  if (!tc_gemm_ok(M, N, K, lda, ldb)) return cudaErrorInvalidValue;
  return launch_opted(tc_gemm_kernel<kBT, Epi>, dim3(N / kTcGemmN, (M + kTcGemmM - 1) / kTcGemmM),
                      kTcGemmThreads, tc_gemm_smem_bytes<kBT>(), stream, A, B, M, K, lda, ldb,
                      epi);
}

}  // namespace vsl
