// Highlight head and feature gate forward, replacing the TPU kernel
// vslnet_tpu/ops/pallas_kernels.py:_highlight_gate_kernel (via
// fused_highlight_gate):
//   logit[r] = x[r].w + b,  masked as logit * m[r] + (1 - m[r]) * (-1e30)
//   score[r] = sigmoid(logit[r]),  gated[r] = x[r] * score[r]
// for every frame r of [B, T] (fp32). A masked frame scores exactly 0.
//
// Design: one warp a frame, eight frames a block: the lanes read the row
// coalesced, reduce the dot with shuffles and write the gated row.
//
// What bounds it: bytes, a read of x and a write of the gated x.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
highlight_gate_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, const float* __restrict__ v_mask,
                      float* __restrict__ gated, float* __restrict__ scores, int rows, int D) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave together
  const float* xr = x + (size_t)r * D;
  float s = 0.f;
  for (int k = lane; k < D; k += 32) s = fmaf(__ldg(xr + k), __ldg(w + k), s);
  const float m = __ldg(v_mask + r);
  const float logit = (vsl::warp_sum(s) + __ldg(bias)) * m + (1.f - m) * vsl::kMaskValue;
  const float score = vsl::sigmoidf_(logit);
  if (lane == 0) scores[r] = score;
  float* gr = gated + (size_t)r * D;
  for (int k = lane; k < D; k += 32) gr[k] = __ldg(xr + k) * score;
}

}  // namespace

extern "C" int vsl_highlight_gate_fwd(const float* x, const float* w, const float* bias,
                                      const float* v_mask, float* gated, float* scores, int rows,
                                      int D, void* stream) {
  const int per_block = kThreads / 32;
  highlight_gate_kernel<<<(rows + per_block - 1) / per_block, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, w, bias, v_mask, gated, scores,
                                                               rows, D);
  return static_cast<int>(cudaGetLastError());
}
