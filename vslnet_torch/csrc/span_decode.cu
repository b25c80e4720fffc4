// Joint span decode, replacing the TPU kernel
// vslnet_tpu/ops/pallas_kernels.py:_span_decode_kernel.
//
// For masked start/end logits [B, T]: ps = softmax(start), pe = softmax(end)
// (fp32, max-subtracted), outer[i, j] = ps[i] * pe[j] for i <= j (else 0),
//   start = argmax_i max_j outer[i, j],  end = argmax_j max_i outer[i, j],
// ties going to the first index, as jnp.argmax does.
//
// Design: one block per row. The [T, T] product is never formed: since
// rounding is monotone and the probabilities are >= 0,
//   max_j outer[i, j] = ps[i] * max_{j >= i} pe[j]   and
//   max_i outer[i, j] = pe[j] * max_{i <= j} ps[i]
// hold exactly, so a suffix max and a prefix max (one thread, T steps each)
// give the same indices as the banded outer product.
//
// What bounds it: launch latency. It reads 2*B*T floats and writes 2*B ints.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ void softmax_row(const float* __restrict__ x, float* p, int T, float* red) {
  float m = -FLT_MAX;
  for (int i = threadIdx.x; i < T; i += blockDim.x) m = fmaxf(m, x[i]);
  m = vsl::block_reduce<true>(m, red);
  float s = 0.f;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const float e = expf(x[i] - m);
    p[i] = e;
    s += e;
  }
  s = vsl::block_reduce<false>(s, red);
  for (int i = threadIdx.x; i < T; i += blockDim.x) p[i] = p[i] / s;
}

__global__ void __launch_bounds__(kThreads)
span_decode_kernel(const float* __restrict__ start, const float* __restrict__ end,
                   int* __restrict__ s_idx, int* __restrict__ e_idx, int T) {
  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);  // [T]
  float* pe = ps + T;                            // [T]
  float* red = pe + T;                           // [32]
  const int b = blockIdx.x;
  softmax_row(start + (size_t)b * T, ps, T, red);
  softmax_row(end + (size_t)b * T, pe, T, red);
  __syncthreads();
  if (threadIdx.x == 0) {
    // start: suffix max of pe, scanned from the end; keep the first argmax
    // by accepting ties while walking down
    float suf = 0.f, best = -1.f;
    int bi = 0;
    for (int i = T - 1; i >= 0; --i) {
      suf = fmaxf(suf, pe[i]);
      const float v = ps[i] * suf;
      if (v >= best) {
        best = v;
        bi = i;
      }
    }
    s_idx[b] = bi;
    float pre = 0.f;
    best = -1.f;
    bi = 0;
    for (int j = 0; j < T; ++j) {
      pre = fmaxf(pre, ps[j]);
      const float v = pe[j] * pre;
      if (v > best) {
        best = v;
        bi = j;
      }
    }
    e_idx[b] = bi;
  }
}

}  // namespace

extern "C" int vsl_span_decode(const float* start, const float* end, int* s_idx, int* e_idx,
                               int B, int T, void* stream) {
  const size_t smem = ((size_t)2 * T + 32) * sizeof(float);
  span_decode_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      start, end, s_idx, e_idx, T);
  return static_cast<int>(cudaGetLastError());
}
