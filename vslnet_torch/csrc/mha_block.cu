// Pre-LN multi-head attention block forward, replacing the TPU kernel
// vslnet_tpu/ops/pallas_kernels.py:_make_mha_block_fwd_kernel (math in
// _mha_block_fwd_math) at drop_rate 0 (the serving path):
//   y   = LN1(x)
//   qkv = y.Wqkv + bqkv                      Wqkv [D, 3D] = [Wq | Wk | Wv]
//   per head h (hd = D / n_heads):
//     s = (q_h * 1/sqrt(hd)).k_h^T + (1 - mask) * (-1e30)
//     att_h = softmax(s) . v_h               (fp32, max-subtracted)
//   res = att + x
//   out = LN2(res).Wd + bd + res
// There is no output projection between attention and the residual (TF
// parity). The key mask is additive -1e30, never -inf: a row whose keys are
// all masked (padded query rows) gets a uniform softmax, not NaN.
//
// Design: one op, three launches.
//   1. LN1 + QKV projection: grid (B, column chunks of 3D); each block
//      normalises its row into shared memory and writes a chunk of qkv.
//   2. attention: grid (B, n_heads); K_h and V_h of one (row, head) sit in
//      shared memory (8 KB each at T=128, hd=16), one thread per query row,
//      two passes over the keys (max, then exp-sum and P.V).
//   3. residual + LN2 + dense + residual: grid (B, column chunks of D).
// qkv [B, T, 3D] and att [B, T, D] go through device memory (L2-resident at
// the served shapes).
//
// What bounds it: the projections' 2*T*D*4D FLOPs a row on few SMs (96 and
// 32 blocks at B=16, D=128) and the attention's per-thread serial key loop;
// bytes are a read of x and the weights and a write of the output.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kChunk = 64;  // output columns per block in launches 1 and 3

__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const float* __restrict__ x, const float* __restrict__ gam,
              const float* __restrict__ beta, const float* __restrict__ wqkv,
              const float* __restrict__ bqkv, float* __restrict__ qkv, int T, int D) {
  extern __shared__ float4 smem4[];
  float* Y = reinterpret_cast<float*>(smem4);  // [T, D]
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int c1 = min(c0 + kChunk, 3 * D);
  vsl::layer_norm_rows(x + (size_t)b * T * D, Y, gam, beta, T, D);
  __syncthreads();
  float* q = qkv + (size_t)b * T * 3 * D;
  vsl::gemm_rows<kRows>(Y, T, D, wqkv, 3 * D, c0, c1, [&](int t, int o, float acc) {
    q[(size_t)t * 3 * D + o] = acc + __ldg(bqkv + o);
  });
}

template <int HD>
__global__ void attention_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                                 float* __restrict__ att, int T, int D, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [T, HD]
  float* Vs = Ks + (size_t)T * HD;               // [T, HD]
  float* neg = Vs + (size_t)T * HD;              // [T]
  const int b = blockIdx.x, h = blockIdx.y;
  const float* base = qkv + (size_t)b * T * 3 * D;
  for (int i = threadIdx.x; i < T * HD; i += blockDim.x) {
    const int j = i / HD, d = i - j * HD;
    Ks[i] = base[(size_t)j * 3 * D + D + h * HD + d];
    Vs[i] = base[(size_t)j * 3 * D + 2 * D + h * HD + d];
  }
  for (int j = threadIdx.x; j < T; j += blockDim.x)
    neg[j] = (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue;
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = base[(size_t)t * 3 * D + h * HD + d] * scale;
    float m = -FLT_MAX;
    for (int j = 0; j < T; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], Ks[j * HD + d], s);
      m = fmaxf(m, s + neg[j]);
    }
    float l = 0.f, acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
    for (int j = 0; j < T; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], Ks[j * HD + d], s);
      const float p = expf(s + neg[j] - m);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, Vs[j * HD + d], acc[d]);
    }
    const float inv = 1.f / l;
    float* o = att + ((size_t)b * T + t) * D + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = acc[d] * inv;
  }
}

__global__ void __launch_bounds__(kThreads)
out_kernel(const float* __restrict__ x, const float* __restrict__ att,
           const float* __restrict__ gam, const float* __restrict__ beta,
           const float* __restrict__ wd, const float* __restrict__ bd, float* __restrict__ out,
           int T, int D) {
  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);  // [T, D] residual
  float* Z = R + (size_t)T * D;                 // [T, D] LN2(residual)
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int c1 = min(c0 + kChunk, D);
  const size_t row = (size_t)b * T * D;
  for (int i = threadIdx.x; i < T * D; i += blockDim.x) R[i] = att[row + i] + x[row + i];
  __syncthreads();
  vsl::layer_norm_rows(R, Z, gam, beta, T, D);
  __syncthreads();
  vsl::gemm_rows<kRows>(Z, T, D, wd, D, c0, c1, [&](int t, int o, float acc) {
    out[row + (size_t)t * D + o] = acc + __ldg(bd + o) + R[(size_t)t * D + o];
  });
}

template <int HD>
cudaError_t launch_attention(const float* qkv, const float* mask, float* att, int B, int T, int D,
                             int n_heads, cudaStream_t stream) {
  const int threads = min(kThreads, (T + 31) / 32 * 32);
  const size_t smem = ((size_t)2 * T * HD + T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_kernel<HD><<<dim3(B, n_heads), threads, smem, stream>>>(
      qkv, mask, att, T, D, static_cast<float>(1.0 / sqrt(static_cast<double>(HD))));
  return cudaGetLastError();
}

}  // namespace

extern "C" int vsl_mha_block_fwd(const float* x, const float* mask, const float* gam,
                                 const float* beta, const float* wqkv, const float* bqkv,
                                 const float* wd, const float* bd, float* qkv, float* att,
                                 float* out, int B, int T, int D, int n_heads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int smem1 = T * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ln_qkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_qkv_kernel<<<dim3(B, (3 * D + kChunk - 1) / kChunk), kThreads, smem1, stream>>>(
      x, gam, beta, wqkv, bqkv, qkv, T, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int hd = D / n_heads;
  switch (hd) {
    case 8: err = launch_attention<8>(qkv, mask, att, B, T, D, n_heads, stream); break;
    case 16: err = launch_attention<16>(qkv, mask, att, B, T, D, n_heads, stream); break;
    case 32: err = launch_attention<32>(qkv, mask, att, B, T, D, n_heads, stream); break;
    case 64: err = launch_attention<64>(qkv, mask, att, B, T, D, n_heads, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem3 = 2 * T * D * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  out_kernel<<<dim3(B, (D + kChunk - 1) / kChunk), kThreads, smem3, stream>>>(
      x, att, gam + D, beta + D, wd, bd, out, T, D);
  return static_cast<int>(cudaGetLastError());
}
