// The two bf16 products of mma.cuh on their own: tc_gemm with an fp32 store
// (the g_d and g_z products' epilogue) and the split-K wgrad_wg, each on
// Hopper's wgmma with its operands brought by TMA (wg_gemm_kernel). Entry
// points of the wrappers ops/kernels.py launch_tc_gemm_bf16 and
// launch_wgrad_bf16, which the card tests and chip_smoke.py hold against
// their plain versions; the wide block kernels (#2c, #9c, #3b, #10b wide)
// call the same device functions from their own entry points. They
// replace no TPU kernel of their own: they are the products inside
// vslnet_tpu/ops/pallas_kernels.py's block kernels (#2's pointwise
// product, #9's dwp and g_d, #3's QKV and dense products, #10's dwd, g_z,
// dwqkv and g_y). What bounds them: 2 M N K operations on the tensor cores.
#include "common.cuh"
#include "mma.cuh"

// C [M, N] fp32 = A [M, K] . B, B [K, N] or, with bt, B^T given as [N, K];
// A and B bf16, row-major, rows at their widths.
extern "C" int vsl_tc_gemm_bf16(const void* A, const void* B, float* C, int M, int N, int K,
                                int bt, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  const vsl::TcStoreRows epi{C, M, N};
  return static_cast<int>(bt ? vsl::tc_gemm<true>(a, b, M, N, K, K, K, epi, stream)
                             : vsl::tc_gemm<false>(a, b, M, N, K, K, N, epi, stream));
}

// C[z] [M, N] fp32 = A[z]^T . B[z] for z < Z, A [Z, K, M] and B [Z, K, N]
// bf16, in S splits of K whose partials go to P [Z, S, M, N] (unused at S
// == 1) and are summed in a fixed order.
extern "C" int vsl_wgrad_bf16(const void* A, const void* B, float* C, float* P, int Z, int M,
                              int N, int K, int S, void* stream_) {
  return static_cast<int>(vsl::wgrad_wg(static_cast<const __nv_bfloat16*>(A),
                                        static_cast<const __nv_bfloat16*>(B), C, P, Z, M, N, K,
                                        S, static_cast<cudaStream_t>(stream_)));
}
