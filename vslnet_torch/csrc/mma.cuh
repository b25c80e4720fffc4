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

namespace vsl {

// The row stride, in bf16 values, of a shared tile of rows of n values (n
// a multiple of 8): n itself where it is an odd number of 16-byte chunks,
// else one chunk more (ops/kernels.py _tc_stride).
__host__ __device__ constexpr int tc_stride(int n) { return (n / 8) % 2 ? n : n + 8; }

// A fragments a k16 step of a row of HD values holds; at head dim 8 one
// step of k8 (a0, a1).
template <int HD>
constexpr int kSteps = HD >= 16 ? HD / 16 : 1;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

}  // namespace vsl
