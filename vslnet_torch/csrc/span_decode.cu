// Joint span decode, replacing the TPU kernel
// vslnet_tpu/ops/pallas_kernels.py:_span_decode_kernel.
//
// For masked start/end logits [B, T]: ps = softmax(start), pe = softmax(end)
// (fp32, max-subtracted), outer[i, j] = ps[i] * pe[j] for i <= j (else 0),
//   start = argmax_i max_j outer[i, j],  end = argmax_j max_i outer[i, j],
// ties going to the first index, as jnp.argmax does.
//
// The [T, T] product is never formed: since rounding is monotone and the
// probabilities are >= 0,
//   max_j outer[i, j] = ps[i] * max_{j >= i} pe[j]   and
//   max_i outer[i, j] = pe[j] * max_{i <= j} ps[i]
// hold exactly, so a suffix max and a prefix max give the same indices as
// the banded outer product.
//
// Design: one CTA of 256 threads a row, each thread holding a contiguous
// chunk of C frames of both rows in registers (C = 1, 2, 4, 8, 16 or 24,
// the least with 256 C >= T). The two softmaxes share their block
// reductions (the maxima, then the sums of exp(x - max)). The suffix max of
// pe and the prefix max of ps are block scans: each chunk's maximum, a
// warp-shuffle scan of those, a scan of the per-warp totals through shared
// memory; then each thread walks its own chunk, down for the start and up
// for the end, keeping its best (value, index), and one block argmax over
// those pairs (the larger value wins; on equal values, the smaller index)
// gives both answers. No thread walks more than C frames.
//
// What bounds it: launch latency. It reads 2*B*T floats and writes 2*B ints.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// a and b reduced over the block (max or sum), the same values in every
// thread: each warp's, then the warps' in order
template <bool kMax>
__device__ void block_reduce2(float& a, float& b, float (*red)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = kMax ? vsl::warp_max(a) : vsl::warp_sum(a);
  b = kMax ? vsl::warp_max(b) : vsl::warp_sum(b);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = red[0][0];
  b = red[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    a = kMax ? fmaxf(a, red[0][w]) : a + red[0][w];
    b = kMax ? fmaxf(b, red[1][w]) : b + red[1][w];
  }
  __syncthreads();  // red is free again
}

// (v, i) becomes (ov, oi) where that is better: a larger value, or an equal
// value at a smaller index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    take_better(v, i, __shfl_xor_sync(kFull, v, off), __shfl_xor_sync(kFull, i, off));
}

template <int C>
__global__ void __launch_bounds__(kThreads)
span_decode_kernel(const float* __restrict__ start, const float* __restrict__ end,
                   int* __restrict__ s_idx, int* __restrict__ e_idx, int T) {
  __shared__ float red[2][kWarps];
  __shared__ float best_v[2][kWarps];
  __shared__ int best_i[2][kWarps];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = threadIdx.x * C;  // this thread's frames [c0, c0 + C), those below T
  const float* xs = start + (size_t)b * T;
  const float* xe = end + (size_t)b * T;
  float ps[C], pe[C];
  float ms = -FLT_MAX, me = -FLT_MAX;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const bool in = c0 + k < T;
    ps[k] = in ? xs[c0 + k] : -FLT_MAX;
    pe[k] = in ? xe[c0 + k] : -FLT_MAX;
    ms = fmaxf(ms, ps[k]);
    me = fmaxf(me, pe[k]);
  }
  block_reduce2<true>(ms, me, red);
  float ss = 0.f, se = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const bool in = c0 + k < T;
    ps[k] = in ? expf(ps[k] - ms) : 0.f;
    pe[k] = in ? expf(pe[k] - me) : 0.f;
    ss += ps[k];
    se += pe[k];
  }
  block_reduce2<false>(ss, se, red);
  // the probabilities (0 beyond T) and the chunk's maxima of each row
  float cs = 0.f, ce = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    ps[k] = ps[k] / ss;
    pe[k] = pe[k] / se;
    cs = fmaxf(cs, ps[k]);
    ce = fmaxf(ce, pe[k]);
  }
  // inclusive scans within the warp: the prefix max of the chunks' ps
  // maxima up the lanes, the suffix max of their pe maxima down them
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, cs, off);
    const float down = __shfl_down_sync(kFull, ce, off);
    if (lane >= off) cs = fmaxf(cs, up);
    if (lane + off < 32) ce = fmaxf(ce, down);
  }
  if (lane == 31) red[0][warp] = cs;
  if (lane == 0) red[1][warp] = ce;
  __syncthreads();
  // exclusive of this thread's chunk: the lanes before (after) it, then the
  // warps before (after) this one
  float pre = __shfl_up_sync(kFull, cs, 1);
  float suf = __shfl_down_sync(kFull, ce, 1);
  if (lane == 0) pre = 0.f;
  if (lane == 31) suf = 0.f;
  for (int w = 0; w < warp; ++w) pre = fmaxf(pre, red[0][w]);
  for (int w = warp + 1; w < kWarps; ++w) suf = fmaxf(suf, red[1][w]);
  // the start: ps[i] * max_{j >= i} pe[j] down the chunk, where ties take
  // the lower index; the end: pe[j] * max_{i <= j} ps[i] up the chunk, where
  // they keep the first
  float vs = -1.f, ve = -1.f;
  int is = INT_MAX, ie = INT_MAX;
#pragma unroll
  for (int k = C - 1; k >= 0; --k) {
    if (c0 + k < T) {
      suf = fmaxf(suf, pe[k]);
      const float v = ps[k] * suf;
      if (v >= vs) {
        vs = v;
        is = c0 + k;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if (c0 + k < T) {
      pre = fmaxf(pre, ps[k]);
      const float v = pe[k] * pre;
      if (v > ve) {
        ve = v;
        ie = c0 + k;
      }
    }
  }
  warp_argmax(vs, is);
  warp_argmax(ve, ie);
  if (lane == 0) {
    best_v[0][warp] = vs;
    best_i[0][warp] = is;
    best_v[1][warp] = ve;
    best_i[1][warp] = ie;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      take_better(vs, is, best_v[0][w], best_i[0][w]);
      take_better(ve, ie, best_v[1][w], best_i[1][w]);
    }
    s_idx[b] = is;
    e_idx[b] = ie;
  }
}

template <int C>
cudaError_t launch_span_decode(const float* start, const float* end, int* s_idx, int* e_idx,
                               int B, int T, cudaStream_t stream) {
  span_decode_kernel<C><<<B, kThreads, 0, stream>>>(start, end, s_idx, e_idx, T);
  return cudaGetLastError();
}

}  // namespace

// T up to 24 * 256 = 6144 frames (the wrapper takes up to ops/kernels.py
// SPAN_DECODE_MAX_T = 6128).
extern "C" int vsl_span_decode(const float* start, const float* end, int* s_idx, int* e_idx,
                               int B, int T, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int c = (T + kThreads - 1) / kThreads;
  if (B < 1 || T < 1 || c > 24) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (c <= 1)
    err = launch_span_decode<1>(start, end, s_idx, e_idx, B, T, stream);
  else if (c <= 2)
    err = launch_span_decode<2>(start, end, s_idx, e_idx, B, T, stream);
  else if (c <= 4)
    err = launch_span_decode<4>(start, end, s_idx, e_idx, B, T, stream);
  else if (c <= 8)
    err = launch_span_decode<8>(start, end, s_idx, e_idx, B, T, stream);
  else if (c <= 16)
    err = launch_span_decode<16>(start, end, s_idx, e_idx, B, T, stream);
  else
    err = launch_span_decode<24>(start, end, s_idx, e_idx, B, T, stream);
  return static_cast<int>(err);
}
