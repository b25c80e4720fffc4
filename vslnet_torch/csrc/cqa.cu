// Context-query attention forward up to its output projection, replacing
// the TPU kernel vslnet_tpu/ops/pallas_kernels.py:_cqa_kernel (via
// fused_cqa_concat), the serving path's CQA:
//   S[t, w] = v[t].w4v + q[w].w4q + (v[t] * wmul).q[w]          [T, W]
//   Sq = softmax over w of S * qm[w] + (1 - qm[w]) * (-1e30)     (rows)
//   Sv = softmax over t of S * vm[t] + (1 - vm[t]) * (-1e30)     (columns)
//   v2q = Sq.q,  q2v = Sq.A,  A = Sv^T.v [W, d]
//   out[t] = [v[t], v2q[t], v[t] * v2q[t], v[t] * q2v[t]]         [T, 4d]
// fp32, max-subtracted softmaxes. The masks are multiplicative -1e30, never
// -inf: a padded query (every word masked) gets a uniform Sq row, a row
// with every frame masked a uniform Sv column, as in the reference. q2v
// goes through A instead of the TPU kernel's [T, T] product Sq.Sv^T: the
// same sums in another order.
//
// Design (plan: ops/kernels.py cqa_plan): N CTAs a batch row, CTA r taking
// the frames [r F, min(T, (r + 1) F)). The column softmax runs over all T
// frames of a row, so it is split as a flash-attention row is. Each CTA:
//   1. takes its frames of v and the row's q into shared memory by
//      cp.async, and (q * wmul)^T; forms S over its frames (a warp four
//      frames, a lane a word); per word (one warp a word) the column
//      maximum m_w over its frames, l_w = sum_t e_tw and the partial A_w =
//      sum_t e_tw v[t], e_tw = exp(S_tw - m_w), each exp taken once and
//      broadcast along the warp in frame order; then Sq in place of S (one
//      warp a frame: the row softmax runs over words, so it is local);
//   2. v2q = Sq.q and the first three quarters of out for its frames;
//   3. waits for every CTA of its row to have written its (m, l, A) part;
//   4. A = sum_r e^(m_r - M) A_r / sum_r e^(m_r - M) l_r, M = max_r m_r,
//      over the row's parts in order of r, into the buffer q held: every
//      CTA sums in the same order and has the same bits; no atomics;
//   5. q2v = Sq.A and the last quarter of out for its frames.
// Two launches, steps 1-2 and then 4-5, the parts and Sq through device
// memory (L2), for any N up to 64: on the card that beat one launch of a
// thread-block cluster a row, the parts read through distributed shared
// memory after one cluster barrier (PERF.md; vslnet_torch/bench/
// cqa_plans.py builds that form into its own copy of this file to time it
// beside this one). A tile whose frames are all masked has m_w = -1e30
// and weighs e^(-1e30 - M) = 0 against a valid M; where every frame of a
// row is masked every m_w is -1e30, every weight 1, and A the mean of v. A
// CTA holds v [F, d], q and A [W, d], S [F, W] and a few vectors, so W
// runs to ~150 words at d = 128 and 64 frames a CTA, ~200 at 16.
//
// What bounds it: bytes, a read of v and q and the write of the [B, T, 4d]
// output; the products are ~8 T W d FLOPs a row. B N CTAs (128 at path L's
// B = 8, T = 1024 and at the served B = 16, T = 128) spread each row over
// the card, where one block a row used to run its phases over all T
// frames on 16 or 8 SMs. Step 4 reads all N parts of the row in each of
// its CTAs: B N^2 (W d + 2 W) floats from L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

struct CqaArgs {
  const float* video;   // [B, T, D]
  const float* query;   // [B, W, D]
  const float* v_mask;  // [B, T]
  const float* q_mask;  // [B, W]
  const float* w4v;     // [D]
  const float* w4q;     // [D]
  const float* wmul;    // [D]
  float* out;           // [B, T, 4D]
  int T, W, D, F;
};

// A CTA's shared memory in floats (ops/kernels.py cqa_plan reports its
// size; the launch uses this one):
//   V    [F][D]  the own frames of v
//   Q    [W][D]  the row's query, then the combined A
//   part [W][D]  the partial A over the own frames, then m [W] and l [W]:
//                the block the row's other CTAs read (in device memory, one
//                a CTA, `stride` floats apart: 16-byte aligned)
//   qw   [W]     q.w4q
//   S    [F][W]  the scores, then Sq
//   vw   [F]     v.w4v
struct CqaLayout {
  size_t FD, WD, part, stride, S;
  __host__ __device__ CqaLayout(int F, int W, int D)
      : FD((size_t)F * D), WD((size_t)W * D), part((size_t)W * D + 2 * (size_t)W),
        stride((part + 3) / 4 * 4), S((size_t)F * W) {}
  __host__ __device__ size_t floats(int F, int W) const { return FD + WD + part + W + S + F; }
};

__device__ __forceinline__ void fma4(float a, float4 x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// The CTA's own frames [t0, t0 + nf) of row b and its shared buffers.
struct Tile {
  int b, t0, nf;
  float *V, *Q, *part, *qw, *S, *vw;
  __device__ const float* v(const CqaArgs& a) const {
    return a.video + ((size_t)b * a.T + t0) * a.D;
  }
  // the own frames of v into V by cp.async, one commit group
  __device__ void stage_v(const CqaArgs& a) const { vsl::cp_async_floats(V, v(a), nf * a.D); }
  __device__ float* out(const CqaArgs& a) const {
    return a.out + ((size_t)b * a.T + t0) * 4 * a.D;
  }
};

// Step 1 up to the partials: S, then per word m_w, l_w and A_w into part.
// Ends with part written by this thread (no barrier after it).
__device__ void partials(const CqaArgs& a, const Tile& tl) {
  const int W = a.W, D = a.D, D4 = D / 4, nf = tl.nf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float* V = tl.V;
  const float4* V4 = reinterpret_cast<const float4*>(V);
  const float* vm = a.v_mask + (size_t)tl.b * a.T + tl.t0;
  const float* q = a.query + (size_t)tl.b * W * D;
  float* Q = tl.Q;
  float* S = tl.S;
  tl.stage_v(a);
  vsl::cp_async_floats(Q, q, W * D);
  // (q * wmul)^T, QT[c][w], into the part buffer, free until the partials
  float* QT = tl.part;
  for (int i = threadIdx.x; i < W * D; i += blockDim.x) {
    const int w = i / D, c = i - w * D;
    QT[(size_t)c * W + w] = __ldg(q + i) * __ldg(a.wmul + c);
  }
  vsl::cp_async_wait<0>();
  __syncthreads();
  // q.w4q and v.w4v, one warp a word or a frame
  for (int i = warp; i < W + nf; i += nwarps) {
    const bool word = i < W;
    const float* x = word ? Q + (size_t)i * D : V + (size_t)(i - W) * D;
    const float* w = word ? a.w4q : a.w4v;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s = fmaf(x[c], __ldg(w + c), s);
    s = vsl::warp_sum(s);
    if (lane == 0) (word ? tl.qw[i] : tl.vw[i - W]) = s;
  }
  __syncthreads();
  // S[t][w] = v.w4v + q.w4q + v[t].(q[w] * wmul), a warp four frames at a
  // time, a lane a word (32 a round): a broadcast float4 of each frame's v
  // and four conflict-free loads of QT feed 16 fmaf, no shuffles
  for (int t0 = 4 * warp; t0 < nf; t0 += 4 * nwarps) {
    const float4* vr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) vr[r] = V4 + (size_t)min(t0 + r, nf - 1) * D4;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int w = min(w0 + lane, W - 1);
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c4 = 0; c4 < D4; ++c4) {
        const float* qt = QT + (size_t)4 * c4 * W + w;
        const float q0 = qt[0], q1 = qt[W], q2 = qt[2 * W], q3 = qt[3 * W];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 x = vr[r][c4];
          s[r] = fmaf(x.x, q0, s[r]);
          s[r] = fmaf(x.y, q1, s[r]);
          s[r] = fmaf(x.z, q2, s[r]);
          s[r] = fmaf(x.w, q3, s[r]);
        }
      }
      if (w0 + lane < W)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (t0 + r < nf) S[(size_t)(t0 + r) * W + w] = tl.vw[t0 + r] + tl.qw[w] + s[r];
    }
  }
  __syncthreads();
  // per word, over the own frames: the masked column maximum m_w, l_w =
  // sum_t e_tw and A_w = sum_t e_tw v[t], one warp a word; each lane takes
  // the exp of one frame of 32, which the warp broadcasts in frame order to
  // the lanes, each summing its float4 columns of v (past the own frames e
  // is 0 and the row read the last frame's: an exact +0), into the part
  // buffer QT held
  float* A = tl.part;
  float* m = A + (size_t)W * D;
  float* l = m + W;
  for (int w = warp; w < W; w += nwarps) {
    auto col = [&](int t) {
      const float mt = __ldg(vm + t);
      return S[(size_t)t * W + w] * mt + (1.f - mt) * vsl::kMaskValue;
    };
    float mx = -FLT_MAX;
    for (int t = lane; t < nf; t += 32) mx = fmaxf(mx, col(t));
    mx = vsl::warp_max(mx);
    float sum = 0.f;
    for (int c4 = lane; c4 - lane < D4; c4 += 32) {  // every lane runs every round
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int base = 0; base < nf; base += 32) {
        const float e = base + lane < nf ? expf(col(base + lane) - mx) : 0.f;
        if (c4 == lane) sum += e;  // the first round counts each frame once
        const int c = min(c4, D4 - 1);
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          const float ej = __shfl_sync(0xffffffffu, e, j);
          fma4(ej, V4[(size_t)min(base + j, nf - 1) * D4 + c], acc);
        }
      }
      if (c4 < D4) reinterpret_cast<float4*>(A + (size_t)w * D)[c4] = acc;
    }
    sum = vsl::warp_sum(sum);
    if (lane == 0) {
      m[w] = mx;
      l[w] = sum;
    }
  }
}

// Sq in place of S, one warp a frame: the row softmax over the words, with
// the multiplicative mask, max-subtracted.
__device__ void row_softmax(const CqaArgs& a, const Tile& tl) {
  const int W = a.W, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* qm = a.q_mask + (size_t)tl.b * W;
  for (int t = warp; t < tl.nf; t += nwarps) {
    float* s = tl.S + (size_t)t * W;
    float mx = -FLT_MAX;
    for (int w = lane; w < W; w += 32) {
      const float mi = __ldg(qm + w);
      s[w] = s[w] * mi + (1.f - mi) * vsl::kMaskValue;
      mx = fmaxf(mx, s[w]);
    }
    mx = vsl::warp_max(mx);
    float sum = 0.f;
    for (int w = lane; w < W; w += 32) {
      const float e = expf(s[w] - mx);
      s[w] = e;
      sum += e;
    }
    const float inv = 1.f / vsl::warp_sum(sum);
    for (int w = lane; w < W; w += 32) s[w] *= inv;
  }
}

// y[t] = sum_w Sq[t][w] M[w] for the own frames, M [W][D] in shared memory,
// in items of 4 frames x one float4 of channels (one M load feeds 4
// frames), each sum in word order, handed to epi(t, c4, y).
template <typename Epi>
__device__ void sq_times(const float* S, int nf, int W, const float* M, int D, Epi epi) {
  const int D4 = D / 4, items = (nf + 3) / 4 * D4;
  const float4* M4 = reinterpret_cast<const float4*>(M);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c4 = it % D4, t0 = it / D4 * 4;
    float4 acc[4];
    const float* s[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      s[r] = S + (size_t)min(t0 + r, nf - 1) * W;  // ragged edge: never handed out
    }
    for (int w = 0; w < W; ++w) {
      const float4 x = M4[(size_t)w * D4 + c4];
#pragma unroll
      for (int r = 0; r < 4; ++r) fma4(s[r][w], x, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (t0 + r < nf) epi(t0 + r, c4, acc[r]);
  }
}

// Step 2: v2q = Sq.q, out[t] = [v, v2q, v * v2q, .] for the own frames.
__device__ void first_quarters(const CqaArgs& a, const Tile& tl) {
  const int D4 = a.D / 4;
  const float4* V4 = reinterpret_cast<const float4*>(tl.V);
  float* o = tl.out(a);
  sq_times(tl.S, tl.nf, a.W, tl.Q, a.D, [&](int t, int c4, float4 y) {
    const float4 x = V4[(size_t)t * D4 + c4];
    float4* ot = reinterpret_cast<float4*>(o + (size_t)t * 4 * a.D) + c4;
    ot[0] = x;
    ot[D4] = y;
    ot[2 * D4] = mul4(x, y);
  });
}

// Step 4: A = sum_r e^(m_r - M) A_r / sum_r e^(m_r - M) l_r over the n
// parts in order of r (part(r): CTA r's [W][D] A_r, then m_r and l_r),
// into Acomb [W][D], one thread a float4 of a word's channels.
template <typename Part>
__device__ void combine(Part part, int n, int W, int D, float* Acomb) {
  const int D4 = D / 4;
  const size_t WD = (size_t)W * D;
  for (int it = threadIdx.x; it < W * D4; it += blockDim.x) {
    const int w = it / D4;
    float M = -FLT_MAX;
#pragma unroll 4
    for (int r = 0; r < n; ++r) M = fmaxf(M, part(r)[WD + w]);
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float* pr = part(r);
      const float e = expf(pr[WD + w] - M);
      den = fmaf(e, pr[WD + W + w], den);
      fma4(e, reinterpret_cast<const float4*>(pr)[it], num);
    }
    const float inv = 1.f / den;  // >= 1: the CTA holding M has l >= 1 there
    reinterpret_cast<float4*>(Acomb)[it] = make_float4(num.x * inv, num.y * inv, num.z * inv,
                                                       num.w * inv);
  }
}

// Step 5: q2v = Sq.A, out[t][3d:] = v * q2v for the own frames.
__device__ void last_quarter(const CqaArgs& a, const Tile& tl, const float* Acomb) {
  const int D4 = a.D / 4;
  const float4* V4 = reinterpret_cast<const float4*>(tl.V);
  float* o = tl.out(a);
  sq_times(tl.S, tl.nf, a.W, Acomb, a.D, [&](int t, int c4, float4 y) {
    const float4 x = V4[(size_t)t * D4 + c4];
    reinterpret_cast<float4*>(o + (size_t)t * 4 * a.D)[3 * D4 + c4] = mul4(x, y);
  });
}

__device__ Tile tile_of(const CqaArgs& a, int b, int rank) {
  extern __shared__ float4 smem4[];
  const CqaLayout lay(a.F, a.W, a.D);
  Tile tl;
  tl.b = b;
  tl.t0 = rank * a.F;
  tl.nf = min(a.F, a.T - tl.t0);
  tl.V = reinterpret_cast<float*>(smem4);
  tl.Q = tl.V + lay.FD;
  tl.part = tl.Q + lay.WD;
  tl.qw = tl.part + lay.part;
  tl.S = tl.qw + a.W;
  tl.vw = tl.S + lay.S;
  return tl;
}

// First launch: steps 1 and 2, the CTA's partials to parts [B N][stride]
// and Sq to sq [B, T, W].
__global__ void __launch_bounds__(kThreads)
cqa_partials_kernel(CqaArgs a, int n, float* __restrict__ parts, float* __restrict__ sq) {
  const Tile tl = tile_of(a, static_cast<int>(blockIdx.x) / n, static_cast<int>(blockIdx.x) % n);
  partials(a, tl);
  __syncthreads();
  const CqaLayout lay(a.F, a.W, a.D);
  float* pg = parts + blockIdx.x * lay.stride;
  for (size_t i = threadIdx.x; i < lay.part; i += blockDim.x) pg[i] = tl.part[i];
  row_softmax(a, tl);
  __syncthreads();
  float* sg = sq + ((size_t)tl.b * a.T + tl.t0) * a.W;
  for (int i = threadIdx.x; i < tl.nf * a.W; i += blockDim.x) sg[i] = tl.S[i];
  first_quarters(a, tl);
}

// Second launch: steps 4 and 5 from the partials of the row's n CTAs and its Sq.
__global__ void __launch_bounds__(kThreads)
cqa_combine_kernel(CqaArgs a, int n, const float* __restrict__ parts,
                   const float* __restrict__ sq) {
  const Tile tl = tile_of(a, static_cast<int>(blockIdx.x) / n, static_cast<int>(blockIdx.x) % n);
  const CqaLayout lay(a.F, a.W, a.D);
  tl.stage_v(a);  // lands behind the combine
  const float* sg = sq + ((size_t)tl.b * a.T + tl.t0) * a.W;
  for (int i = threadIdx.x; i < tl.nf * a.W; i += blockDim.x) tl.S[i] = sg[i];
  const float* row = parts + (size_t)tl.b * n * lay.stride;
  combine([&](int r) { return row + r * lay.stride; }, n, a.W, a.D, tl.Q);
  vsl::cp_async_wait<0>();
  __syncthreads();
  last_quarter(a, tl, tl.Q);
}

}  // namespace

// The CQA concat on cqa_plan's N CTAs a row of F frames (N = ceil(T / F)),
// two launches through the workspaces parts [B N, W D + 2 W rounded up to
// 4] and sq [B, T, W].
extern "C" int vsl_cqa_concat_fwd(const float* video, const float* query, const float* v_mask,
                                  const float* q_mask, const float* w4v, const float* w4q,
                                  const float* wmul, float* out, float* parts, float* sq, int B,
                                  int T, int W, int D, int N, int F, void* stream_) {
  if (B < 1 || T < 1 || W < 1 || D < 4 || D % 4 || F < 1 || N < 1 || N != (T + F - 1) / F)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const CqaArgs a{video, query, v_mask, q_mask, w4v, w4q, wmul, out, T, W, D, F};
  const size_t smem = CqaLayout(F, W, D).floats(F, W) * sizeof(float);
  cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(cqa_partials_kernel), smem);
  if (err == cudaSuccess) err = vsl::opt_in_smem(reinterpret_cast<const void*>(cqa_combine_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cqa_partials_kernel<<<B * N, kThreads, smem, stream>>>(a, N, parts, sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cqa_combine_kernel<<<B * N, kThreads, smem, stream>>>(a, N, parts, sq);
  return static_cast<int>(cudaGetLastError());
}
