// QANet conv block forward, replacing the TPU kernel
// vslnet_tpu/ops/pallas_kernels.py:_make_conv_block_fwd_kernel at
// drop_rate 0 (the serving path).
//
// For l in 0..L-1:  x = x + relu(pointwise(depthwise(LN_l(x))) + bp_l)
//   LN: fp32 statistics over D, population variance, eps 1e-6;
//   depthwise: kernel k along T, SAME, zero padding at the sequence ends
//              (not at the mask), dw [L, k, D];
//   pointwise: [D, D] matrix wp [L, D, D] plus bias bp [L, D].
//
// Design: all L layers in one launch, one block per batch row. The row's
// [T, D] residual stream X, its normalised copy N and the depthwise output
// Dw stay in dynamic shared memory for all layers (3*T*D*4 bytes: 192 KB at
// T = D = 128), so nothing goes back to device memory between layers.
// Ragged T (the query stream's max_w) is masked in every stage.
//
// What bounds it: the pointwise products, 2*T*D*D FLOPs a layer, on the B
// SMs that hold a row (16 of 132 at B=16); bytes are one read of x and one
// write of the output. The products read A as broadcast float4s from shared
// memory and reuse each weight for 16 rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;

__global__ void __launch_bounds__(kThreads)
conv_block_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gam,
                      const float* __restrict__ beta, const float* __restrict__ dw,
                      const float* __restrict__ wp, const float* __restrict__ bp,
                      float* __restrict__ out, int T, int D, int L, int K) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);
  float* N = X + (size_t)T * D;
  float* Dw = N + (size_t)T * D;
  const size_t row = (size_t)blockIdx.x * T * D;
  const int TD = T * D;
  const int pad = (K - 1) / 2;
  for (int i = threadIdx.x; i < TD; i += blockDim.x) X[i] = x[row + i];
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    vsl::layer_norm_rows(X, N, gam + (size_t)l * D, beta + (size_t)l * D, T, D);
    __syncthreads();
    const float* dwl = dw + (size_t)l * K * D;
    for (int i = threadIdx.x; i < TD; i += blockDim.x) {
      const int t = i / D, c = i - t * D;
      float acc = 0.f;
      for (int j = 0; j < K; ++j) {
        const int tt = t + j - pad;
        const float nv = (tt >= 0 && tt < T) ? N[(size_t)tt * D + c] : 0.f;
        acc = fmaf(nv, __ldg(dwl + (size_t)j * D + c), acc);
      }
      Dw[i] = acc;
    }
    __syncthreads();
    const float* bpl = bp + (size_t)l * D;
    vsl::gemm_rows<kRows>(Dw, T, D, wp + (size_t)l * D * D, D, 0, D,
                          [&](int t, int o, float acc) {
                            X[(size_t)t * D + o] += fmaxf(acc + __ldg(bpl + o), 0.f);
                          });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < TD; i += blockDim.x) out[row + i] = X[i];
}

}  // namespace

extern "C" int vsl_conv_block_fwd(const float* x, const float* gam, const float* beta,
                                  const float* dw, const float* wp, const float* bp, float* out,
                                  int B, int T, int D, int L, int K, void* stream) {
  const int smem = 3 * T * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(conv_block_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_block_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, gam, beta, dw, wp, bp, out, T, D, L, K);
  return static_cast<int>(cudaGetLastError());
}
