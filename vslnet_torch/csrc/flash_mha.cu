// Flash multi-head attention, forward and backward: fused_mha's long-T
// route, replacing the TPU kernels
// vslnet_tpu/ops/pallas_kernels.py:_make_flash_fwd_kernel and
// _make_flash_bwd_kernel (via _mha_flash_fwd_raw / _mha_flash_bwd_raw).
// Same function as the whole-T kernels (mha_block.cu): q, k, v [B, T, D],
// key mask [B, T] added as (1 - m) * (-1e30), fp32 softmax per head, each
// head's probabilities dropped by the counter hash at the GLOBAL (t, j) of
// its [T, T] tile (hash.cuh head_salt), so both routes drop the same
// elements; no [T, T] tile exists anywhere.
//
// Forward: grid (query tiles of kRows, heads, B), one thread a query row.
// K and V of a head stream through shared memory kStage keys at a time;
// each thread keeps its running max m, sum l and P.V accumulator (an
// online softmax, rescaled when the max grows) and writes out and
// lse = m + log(l) per (row, head, query) into lse [B, H, T].
//
// Backward, two launches, no atomics:
//   1. dq, grid (query tiles, heads, B): delta_t = g_t . out_t (written to
//      a workspace), then over the key tiles p = exp(s - lse_t),
//      dp = drop(g_t . v_j), ds = p * (dp - delta_t), dq += ds * k_j;
//   2. dk, dv, grid (key tiles, heads, B): a thread a key, the query tiles
//      streaming through shared memory (q, g, lse, delta):
//      dv_j += drop(p) * g_t, dk_j += ds * q_t.
//
// Masked keys. A key tile whose keys are all masked is skipped where the
// row has a valid key: there exp(-1e30 - m) is 0 exactly, so the result is
// unchanged. A row with no valid key (every score -1e30 exactly) keeps the
// uniform softmax over all T keys, as the plain version has it: the
// forward runs every tile, and the backward takes p = 1/T instead of
// exp(s - lse), since lse = -1e30 + log(T) rounds to -1e30 and would give
// p = 1 (the TPU kernel's backward does that; it is not copied).
//
// What bounds them: the per-thread key (query) loops, 2*HD FMAs, an exp
// and a hash per (query, key) pair in the forward, about twice that over
// the two backward launches; bytes are q, k, v (and g, out) read once a
// tile, the outputs written once.
#include "common.cuh"
#include "hash.cuh"

namespace {

constexpr int kRows = 128;  // queries (forward, dq) or keys (dk, dv) of a block, one a thread
constexpr int kStage = 64;  // keys (forward, dq) or queries (dk, dv) staged at a time

using vsl::head_score;

// True on every thread if any key of the row is valid (mask != 0).
__device__ bool row_has_key(const float* mrow, int T) {
  int any = 0;
  for (int j = threadIdx.x; j < T; j += blockDim.x) any |= mrow[j] != 0.f;
  return __syncthreads_or(any) != 0;
}

// Stages keys [j0, j0 + nk) of head h: Ks, Vs [nk, HD], neg [nk]. Returns,
// on every thread, whether any staged key is valid; ends with a barrier.
template <int HD>
__device__ bool stage_keys(const float* k, const float* v, const float* mrow, size_t base, int D,
                           int j0, int nk, float* Ks, float* Vs, float* neg) {
  for (int i = threadIdx.x; i < nk * HD; i += blockDim.x) {
    const int jj = i / HD, d = i - jj * HD;
    Ks[i] = k[base + (size_t)(j0 + jj) * D + d];
    Vs[i] = v[base + (size_t)(j0 + jj) * D + d];
  }
  int live = 0;
  for (int jj = threadIdx.x; jj < nk; jj += blockDim.x) {
    const float m = mrow[j0 + jj];
    neg[jj] = (1.f - m) * vsl::kMaskValue;
    live |= m != 0.f;
  }
  return __syncthreads_or(live) != 0;
}

template <int HD>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask, vsl::Dropout drop,
                 float* __restrict__ out, float* __restrict__ lse, int T, int D, float scale) {
  __shared__ float Ks[kStage * HD], Vs[kStage * HD], neg[kStage];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int t = blockIdx.x * kRows + threadIdx.x;
  const bool active = t < T;
  const float* mrow = mask + (size_t)b * T;
  const size_t base = (size_t)b * T * D + h * HD;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const bool has_key = row_has_key(mrow, T);
  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? q[base + (size_t)t * D + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -FLT_MAX, l = 0.f;
  for (int j0 = 0; j0 < T; j0 += kStage) {
    const int nk = min(kStage, T - j0);
    const bool live = stage_keys<HD>(k, v, mrow, base, D, j0, nk, Ks, Vs, neg);
    if (active && (live || !has_key)) {
      for (int jj = 0; jj < nk; ++jj) {
        const float s = head_score<HD>(qr, Ks + jj * HD, neg[jj]);
        if (s > m) {  // the max grows: rescale what was summed
          const float a = expf(m - s);
          l *= a;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] *= a;
          m = s;
        }
        const float p = expf(s - m);
        l += p;
        if (drop.keep(seed, salt, t, j0 + jj)) {
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, Vs[jj * HD + d], acc[d]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  const float inv = (drop.on() ? drop.scale : 1.f) / l;
  float* o = out + ((size_t)b * T + t) * D + h * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = acc[d] * inv;
  lse[((size_t)b * H + h) * T + t] = m + logf(l);
}

template <int HD>
__global__ void __launch_bounds__(kRows)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ mask,
                    vsl::Dropout drop, const float* __restrict__ out,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    float* __restrict__ dq, float* __restrict__ delta, int T, int D, float scale) {
  __shared__ float Ks[kStage * HD], Vs[kStage * HD], neg[kStage];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int t = blockIdx.x * kRows + threadIdx.x;
  const bool active = t < T;
  const float* mrow = mask + (size_t)b * T;
  const size_t base = (size_t)b * T * D + h * HD;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const float dscale = drop.on() ? drop.scale : 1.f;
  const float inv_t = 1.f / T;
  const bool has_key = row_has_key(mrow, T);
  float qr[HD], gr[HD], dqr[HD], dlt = 0.f, lt = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    const size_t i = base + (size_t)t * D + d;
    qr[d] = active ? q[i] * scale : 0.f;
    gr[d] = active ? g[i] : 0.f;
    dlt = fmaf(gr[d], active ? out[i] : 0.f, dlt);
    dqr[d] = 0.f;
  }
  if (active) {
    const size_t s = ((size_t)b * H + h) * T + t;
    delta[s] = dlt;
    lt = lse[s];
  }
  for (int j0 = 0; j0 < T; j0 += kStage) {
    const int nk = min(kStage, T - j0);
    const bool live = stage_keys<HD>(k, v, mrow, base, D, j0, nk, Ks, Vs, neg);
    if (active && (live || !has_key)) {
      for (int jj = 0; jj < nk; ++jj) {
        const float* kj = Ks + jj * HD;
        const float p = has_key ? expf(head_score<HD>(qr, kj, neg[jj]) - lt) : inv_t;
        float dp = 0.f;
        if (drop.keep(seed, salt, t, j0 + jj)) {
#pragma unroll
          for (int d = 0; d < HD; ++d) dp = fmaf(gr[d], Vs[jj * HD + d], dp);
          dp *= dscale;
        }
        const float ds = p * (dp - dlt);
#pragma unroll
        for (int d = 0; d < HD; ++d) dqr[d] = fmaf(ds, kj[d], dqr[d]);
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < HD; ++d) dq[base + (size_t)t * D + d] = dqr[d] * scale;
}

template <int HD>
__global__ void __launch_bounds__(kRows)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ mask,
                      vsl::Dropout drop, const float* __restrict__ lse,
                      const float* __restrict__ delta, const float* __restrict__ g,
                      float* __restrict__ dk, float* __restrict__ dv, int T, int D,
                      float scale) {
  __shared__ float Qs[kStage * HD], Gs[kStage * HD], ls[kStage], dls[kStage];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int j = blockIdx.x * kRows + threadIdx.x;
  const bool active = j < T;
  const float* mrow = mask + (size_t)b * T;
  const size_t base = (size_t)b * T * D + h * HD;
  const size_t srow = ((size_t)b * H + h) * T;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const float dscale = drop.on() ? drop.scale : 1.f;
  const float inv_t = 1.f / T;
  const bool has_key = row_has_key(mrow, T);
  // a masked key of a row with a valid key has p = 0 for every query
  const bool work = active && !(has_key && mrow[j] == 0.f);
  float kr[HD], vr[HD], dkr[HD], dvr[HD];
  const float negj = active ? (1.f - mrow[j]) * vsl::kMaskValue : 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    kr[d] = active ? k[base + (size_t)j * D + d] : 0.f;
    vr[d] = active ? v[base + (size_t)j * D + d] : 0.f;
    dkr[d] = 0.f;
    dvr[d] = 0.f;
  }
  if (__syncthreads_or(work)) {
    for (int t0 = 0; t0 < T; t0 += kStage) {
      const int nq = min(kStage, T - t0);
      for (int i = threadIdx.x; i < nq * HD; i += blockDim.x) {
        const int tt = i / HD, d = i - tt * HD;
        Qs[i] = q[base + (size_t)(t0 + tt) * D + d] * scale;
        Gs[i] = g[base + (size_t)(t0 + tt) * D + d];
      }
      for (int tt = threadIdx.x; tt < nq; tt += blockDim.x) {
        ls[tt] = lse[srow + t0 + tt];
        dls[tt] = delta[srow + t0 + tt];
      }
      __syncthreads();
      if (work) {
        for (int tt = 0; tt < nq; ++tt) {
          const float* qt = Qs + tt * HD;
          const float* gt = Gs + tt * HD;
          const float p = has_key ? expf(head_score<HD>(kr, qt, negj) - ls[tt]) : inv_t;
          float dp = 0.f;
          if (drop.keep(seed, salt, t0 + tt, j)) {
            const float pd = p * dscale;
#pragma unroll
            for (int d = 0; d < HD; ++d) {
              dvr[d] = fmaf(pd, gt[d], dvr[d]);
              dp = fmaf(gt[d], vr[d], dp);
            }
            dp *= dscale;
          }
          const float ds = p * (dp - dls[tt]);
#pragma unroll
          for (int d = 0; d < HD; ++d) dkr[d] = fmaf(ds, qt[d], dkr[d]);
        }
      }
      __syncthreads();
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    dk[base + (size_t)j * D + d] = dkr[d];
    dv[base + (size_t)j * D + d] = dvr[d];
  }
}

dim3 grid_of(int B, int T, int n_heads) { return dim3((T + kRows - 1) / kRows, n_heads, B); }

}  // namespace

// out [B, T, D], lse [B, H, T].
extern "C" int vsl_flash_mha_fwd(const float* q, const float* k, const float* v,
                                 const float* mask, const float* seeds, unsigned thresh,
                                 float scale, float* out, float* lse, int B, int T, int D,
                                 int n_heads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    flash_fwd_kernel<HD><<<grid_of(B, T, n_heads), kRows, 0, stream>>>(
        q, k, v, mask, drop, out, lse, T, D, vsl::head_scale(HD));
    return cudaGetLastError();
  }));
}

// dq, dk, dv [B, T, D]; delta [B, H, T] is a workspace (g . out per query).
extern "C" int vsl_flash_mha_bwd(const float* q, const float* k, const float* v,
                                 const float* mask, const float* seeds, unsigned thresh,
                                 float scale, const float* out, const float* lse, const float* g,
                                 float* dq, float* dk, float* dv, float* delta, int B, int T,
                                 int D, int n_heads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const dim3 grid = grid_of(B, T, n_heads);
    flash_bwd_dq_kernel<HD><<<grid, kRows, 0, stream>>>(q, k, v, mask, drop, out, lse, g, dq,
                                                        delta, T, D, vsl::head_scale(HD));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<HD><<<grid, kRows, 0, stream>>>(q, k, v, mask, drop, lse, delta, g, dk,
                                                          dv, T, D, vsl::head_scale(HD));
    return cudaGetLastError();
  }));
}
