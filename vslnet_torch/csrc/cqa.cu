// Context-query attention forward up to its output projection, replacing
// the TPU kernel vslnet_tpu/ops/pallas_kernels.py:_cqa_kernel (via
// fused_cqa_concat), the serving path's CQA:
//   S[t, w] = v[t].w4v + q[w].w4q + (v[t] * wmul).q[w]          [T, W]
//   Sq = softmax over w of S * qm[w] + (1 - qm[w]) * (-1e30)     (rows)
//   Sv = softmax over t of S * vm[t] + (1 - vm[t]) * (-1e30)     (columns)
//   v2q = Sq.q,  q2v = Sq.(Sv^T.v)
//   out[t] = [v[t], v2q[t], v[t] * v2q[t], v[t] * q2v[t]]         [T, 4d]
// fp32, max-subtracted softmaxes. The masks are multiplicative -1e30, never
// -inf: a padded query (every word masked) gets a uniform Sq row, as in the
// reference. q2v goes through the [W, d] product A = Sv^T.v instead of the
// TPU kernel's [T, T] product Sq.Sv^T: the same sums in another order.
//
// Design: one block per batch row. S (then Sq, in place), Sv, the row's
// query q [W, d], A [W, d] and q.w4q stay in shared memory; v is read from
// global memory (L2) in each phase:
//   1. q -> shared; q.w4q, one warp a word
//   2. S, one warp a frame: v[t].w4v and the W dots of v[t] * wmul with q
//   3. Sv, one warp a word (column softmax over t)
//   4. Sq in place of S, one warp a frame (row softmax over w)
//   5. A = Sv^T.v, one thread a (word, channel)
//   6. out, one thread a (frame, channel): v2q and q2v as W-long sums
//
// What bounds it: B blocks (16 of 132 SMs at the served batch), each a
// chain of six phases whose loads of v from L2 are hidden only by the
// block's own 32 warps; its bytes are a read of v and q and a write of the
// [B, T, 4d] output.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;  // 32 warps: one row's phases are latency-bound

// softmax in place over n values x[i * stride] of one warp, with the
// multiplicative mask m[i]
__device__ void warp_masked_softmax(float* x, const float* __restrict__ m, int n, int stride,
                                    float* out) {
  const int lane = threadIdx.x & 31;
  float mx = -FLT_MAX;
  for (int i = lane; i < n; i += 32) {
    const float mi = __ldg(m + i);
    const float s = x[(size_t)i * stride] * mi + (1.f - mi) * vsl::kMaskValue;
    out[(size_t)i * stride] = s;
    mx = fmaxf(mx, s);
  }
  mx = vsl::warp_max(mx);
  float sum = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float e = expf(out[(size_t)i * stride] - mx);
    out[(size_t)i * stride] = e;
    sum += e;
  }
  const float inv = 1.f / vsl::warp_sum(sum);
  for (int i = lane; i < n; i += 32) out[(size_t)i * stride] *= inv;
}

__global__ void __launch_bounds__(kThreads)
cqa_concat_kernel(const float* __restrict__ video, const float* __restrict__ query,
                  const float* __restrict__ v_mask, const float* __restrict__ q_mask,
                  const float* __restrict__ w4v, const float* __restrict__ w4q,
                  const float* __restrict__ wmul, float* __restrict__ out, int T, int W, int D) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // [T, W] score, then Sq
  float* Sv = S + (size_t)T * W;                // [T, W]
  float* Q = Sv + (size_t)T * W;                // [W, D]
  float* A = Q + (size_t)W * D;                 // [W, D] Sv^T.v
  float* qw = A + (size_t)W * D;                // [W] q.w4q
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* v = video + (size_t)b * T * D;
  const float* q = query + (size_t)b * W * D;
  const float* vm = v_mask + (size_t)b * T;
  const float* qm = q_mask + (size_t)b * W;

  for (int i = threadIdx.x; i < W * D; i += blockDim.x) Q[i] = q[i];
  __syncthreads();
  for (int w = warp; w < W; w += nwarps) {
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s = fmaf(Q[(size_t)w * D + k], __ldg(w4q + k), s);
    s = vsl::warp_sum(s);
    if (lane == 0) qw[w] = s;
  }
  __syncthreads();

  for (int t = warp; t < T; t += nwarps) {
    const float* vt = v + (size_t)t * D;
    float s0 = 0.f;
    for (int k = lane; k < D; k += 32) s0 = fmaf(__ldg(vt + k), __ldg(w4v + k), s0);
    s0 = vsl::warp_sum(s0);
    for (int w = 0; w < W; ++w) {
      float s2 = 0.f;
      for (int k = lane; k < D; k += 32)
        s2 = fmaf(__ldg(vt + k) * __ldg(wmul + k), Q[(size_t)w * D + k], s2);
      s2 = vsl::warp_sum(s2);
      if (lane == 0) S[(size_t)t * W + w] = s0 + qw[w] + s2;
    }
  }
  __syncthreads();

  for (int w = warp; w < W; w += nwarps) warp_masked_softmax(S + w, vm, T, W, Sv + w);
  __syncthreads();
  for (int t = warp; t < T; t += nwarps)
    warp_masked_softmax(S + (size_t)t * W, qm, W, 1, S + (size_t)t * W);
  __syncthreads();

  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int w = i / D, k = i - w * D;
    float a = 0.f;
    for (int t = 0; t < T; ++t) a = fmaf(Sv[(size_t)t * W + w], __ldg(v + (size_t)t * D + k), a);
    A[i] = a;
  }
  __syncthreads();

  float* o = out + (size_t)b * T * 4 * D;
  for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
    const int t = i / D, k = i - t * D;
    float v2q = 0.f, q2v = 0.f;
    for (int w = 0; w < W; ++w) {
      const float p = S[(size_t)t * W + w];
      v2q = fmaf(p, Q[(size_t)w * D + k], v2q);
      q2v = fmaf(p, A[(size_t)w * D + k], q2v);
    }
    const float x = __ldg(v + i);
    float* ot = o + (size_t)t * 4 * D;
    ot[k] = x;
    ot[D + k] = v2q;
    ot[2 * D + k] = x * v2q;
    ot[3 * D + k] = x * q2v;
  }
}

}  // namespace

extern "C" int vsl_cqa_concat_fwd(const float* video, const float* query, const float* v_mask,
                                  const float* q_mask, const float* w4v, const float* w4q,
                                  const float* wmul, float* out, int B, int T, int W, int D,
                                  void* stream) {
  const int smem = (2 * T * W + 2 * W * D + W) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(cqa_concat_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cqa_concat_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      video, query, v_mask, q_mask, w4v, w4q, wmul, out, T, W, D);
  return static_cast<int>(cudaGetLastError());
}
