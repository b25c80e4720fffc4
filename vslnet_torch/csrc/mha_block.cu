// Pre-LN multi-head attention block, forward and backward, replacing the
// TPU kernels vslnet_tpu/ops/pallas_kernels.py:_make_mha_block_fwd_kernel
// (math in _mha_block_fwd_math) and _make_mha_block_bwd_kernel (via
// fused_mha_block):
//   y   = drop_0x200(LN1(x))
//   qkv = y.Wqkv + bqkv                      Wqkv [D, 3D] = [Wq | Wk | Wv]
//   per head h (hd = D / n_heads):
//     s = (q_h * 1/sqrt(hd)).k_h^T + (1 - mask) * (-1e30)
//     att_h = drop_h(softmax(s)) . v_h       (fp32, max-subtracted)
//   res = drop_0x201(att) + x
//   z   = drop_0x202(LN2(res))
//   out = drop_0x203(z.Wd + bd) + res
// There is no output projection between attention and the residual (TF
// parity). The key mask is additive -1e30, never -inf: a row whose keys are
// all masked (padded query rows) gets a uniform softmax, not NaN, and its
// backward stays finite (ds = p * (dp - sum(dp * p))). Dropout is the
// counter hash (hash.cuh): sites 0x200-0x203 at (t, c) of the row's
// [T, D] tile, and per head at (t, j) of the [T, T] probability tile with
// the head salt; off when seeds is null.
//
// Forward: one op, three launches.
//   1. LN1 + QKV projection: grid (B, column chunks of 3D); each block
//      normalises its row into shared memory and writes a chunk of qkv.
//   2. attention: grid (B, n_heads); K_h and V_h of one (row, head) sit in
//      shared memory (8 KB each at T=128, hd=16), one thread per query row,
//      two passes over the keys (max, then exp-sum and P.V).
//   3. residual + LN2 + dense + residual: grid (B, column chunks of D).
// qkv [B, T, 3D] and att [B, T, D] go through device memory (L2-resident at
// the served shapes); the backward takes them as saved residuals.
//
// Backward: three launches, plus the weight products; the plan (frames a
// tile F, weight slice SK, query tile TQ) is ops/kernels.py mha_bwd_plan.
//   1. dense + LN2 backward on a grid of (tiles of F frames, rows): the
//      frames couple only through the weight and LN column sums. g_dpre,
//      g_z = g_dpre . Wd^T (Wd^T streamed into shared memory by cp.async in
//      double-buffered slices of SK rows, the product register-tiled out of
//      shared memory), g_res and g_att.
//   2. attention backward, a thread-block cluster of ceil(T / TQ) CTAs a
//      (row, head), CTA r taking the query rows [r TQ, (r + 1) TQ) against
//      all keys: S = Q.K^T as a register-tiled product into shared memory,
//      P and drop(P) by warp reductions over each row, the keep bits hashed
//      once a (t, j), D_t = g_att_t . att_t from the saved output
//      (att = drop(P).V, so this is sum_j dP * P without a pass over the
//      keys), dV = drop(P)^T.G, dS = P * (drop(G.V^T) - D_t) in place,
//      dQ = dS.K and dK = dS^T.Q, all register-tiled out of shared
//      memory; each CTA's dK and dV partials over its query rows are
//      summed in rank order through distributed shared memory by the CTA
//      that owns those key rows.
//   3. QKV + LN1 backward on the grid of launch 1: g_y = dqkv . Wqkv^T
//      (Wqkv^T [3D, D] streamed in slices), dx.
// dwd = sum over rows of z^T . g_dpre and dwqkv = y^T . dqkv are
// deterministic split-K products (common.cuh wgrad); the bias and LN
// gradients are per-tile column sums in frame order, summed over the
// tiles in a fixed order. No atomics: two equal calls give equal bits.
//
// What bounds them: the projections' 2*T*D*4D FLOPs a row (twice that and
// more in the backward) and, in the attention, 10*T*T*hd FLOPs a (row,
// head) of small products out of shared memory; bytes are a read of x
// (and g), the weights and the saved qkv and att, and a write of the
// output (dx and the weight gradients).
//
// The forward's attention launch and the old one-thread-a-query-row
// attention backward also serve on their own as the whole-T fused_mha
// kernels (vsl_mha_fwd, vsl_mha_bwd at the end): they take q, k, v and
// the outputs through base pointers and row strides, so one device body
// serves both callers. Those are bound by the per-thread key loops on
// B * n_heads blocks.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hash.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kChunk = 64;  // output columns per block in forward launches 1 and 3

__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const float* __restrict__ x, const float* __restrict__ gam,
              const float* __restrict__ beta, const float* __restrict__ wqkv,
              const float* __restrict__ bqkv, vsl::Dropout drop, float* __restrict__ qkv, int T,
              int D) {
  extern __shared__ float4 smem4[];
  float* Y = reinterpret_cast<float*>(smem4);  // [T, D]
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int c1 = min(c0 + kChunk, 3 * D);
  vsl::layer_norm_rows(x + (size_t)b * T * D, Y, gam, beta, T, D);
  __syncthreads();
  if (drop.on()) {
    const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x200u);
    for (int i = threadIdx.x; i < T * D; i += blockDim.x)
      Y[i] = drop.apply(Y[i], seed, salt, i / D, i % D);
    __syncthreads();
  }
  float* q = qkv + (size_t)b * T * 3 * D;
  vsl::gemm_rows<kRows>(Y, T, D, wqkv, 3 * D, c0, c1, [&](int t, int o, float acc) {
    q[(size_t)t * 3 * D + o] = acc + __ldg(bqkv + o);
  });
}

using vsl::head_score;

// The attention kernels read q, k and v through base pointers and one row
// stride ld: element (b, t, c) of q is q[(b * T + t) * ld + c]. The block
// passes its packed qkv [B, T, 3D] (ld = 3D, k = qkv + D, v = qkv + 2D),
// fused_mha three [B, T, D] tensors (ld = D); the outputs and g the same
// way with their own strides.
template <int HD>
__global__ void attention_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                                 const float* __restrict__ vp, int ld,
                                 const float* __restrict__ mask, vsl::Dropout drop,
                                 float* __restrict__ att, int ldo, int T, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [T, HD]
  float* Vs = Ks + (size_t)T * HD;               // [T, HD]
  float* neg = Vs + (size_t)T * HD;              // [T]
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t base = (size_t)b * T * ld + h * HD;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  for (int i = threadIdx.x; i < T * HD; i += blockDim.x) {
    const int j = i / HD, d = i - j * HD;
    Ks[i] = kp[base + (size_t)j * ld + d];
    Vs[i] = vp[base + (size_t)j * ld + d];
  }
  for (int j = threadIdx.x; j < T; j += blockDim.x)
    neg[j] = (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue;
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = qp[base + (size_t)t * ld + d] * scale;
    float m = -FLT_MAX;
    for (int j = 0; j < T; ++j) m = fmaxf(m, head_score<HD>(q, Ks + j * HD, neg[j]));
    float l = 0.f, acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
    for (int j = 0; j < T; ++j) {
      const float p = expf(head_score<HD>(q, Ks + j * HD, neg[j]) - m);
      l += p;
      if (drop.keep(seed, salt, t, j)) {
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, Vs[j * HD + d], acc[d]);
      }
    }
    const float inv = (drop.on() ? drop.scale : 1.f) / l;
    float* o = att + ((size_t)b * T + t) * ldo + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = acc[d] * inv;
  }
}

__global__ void __launch_bounds__(kThreads)
out_kernel(const float* __restrict__ x, const float* __restrict__ att,
           const float* __restrict__ gam, const float* __restrict__ beta,
           const float* __restrict__ wd, const float* __restrict__ bd, vsl::Dropout drop,
           float* __restrict__ out, int T, int D) {
  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);  // [T, D] residual
  float* Z = R + (size_t)T * D;                 // [T, D] drop(LN2(residual))
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int c1 = min(c0 + kChunk, D);
  const size_t row = (size_t)b * T * D;
  const uint32_t seed = drop.seed(b);
  const uint32_t s201 = vsl::site_salt(0x201u), s202 = vsl::site_salt(0x202u),
                 s203 = vsl::site_salt(0x203u);
  for (int i = threadIdx.x; i < T * D; i += blockDim.x)
    R[i] = drop.apply(att[row + i], seed, s201, i / D, i % D) + x[row + i];
  __syncthreads();
  vsl::layer_norm_rows(R, Z, gam, beta, T, D);
  __syncthreads();
  if (drop.on()) {
    for (int i = threadIdx.x; i < T * D; i += blockDim.x)
      Z[i] = drop.apply(Z[i], seed, s202, i / D, i % D);
    __syncthreads();
  }
  vsl::gemm_rows<kRows>(Z, T, D, wd, D, c0, c1, [&](int t, int o, float acc) {
    out[row + (size_t)t * D + o] =
        drop.apply(acc + __ldg(bd + o), seed, s203, t, o) + R[(size_t)t * D + o];
  });
}

template <int HD>
cudaError_t launch_attention(const float* q, const float* k, const float* v, int ld,
                             const float* mask, vsl::Dropout drop, float* att, int ldo, int B,
                             int T, int n_heads, cudaStream_t stream) {
  const int threads = min(kThreads, (T + 31) / 32 * 32);
  const size_t smem = ((size_t)2 * T * HD + T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_kernel<HD><<<dim3(B, n_heads), threads, smem, stream>>>(q, k, v, ld, mask, drop, att,
                                                                   ldo, T, vsl::head_scale(HD));
  return cudaGetLastError();
}

// --- backward ------------------------------------------------------------------
// Per-tile partials part [B * tiles, 8D]: dgam [2D], dbeta [2D], dbqkv [3D],
// dbd [D].

constexpr int kBwdGemmRows = 2;  // the per-frame launches' product tile: rows an item

// The per-frame launches' shared memory for F frames a tile and weight
// slices of SK rows, in floats: launch 1 the slices [2][SK][D], GD, XH, GZ
// [F][D] and inv [F4]; launch 3 the slices, DQ [F][3D], XH, GY [F][D] and
// inv (ops/kernels.py mha_bwd_plan reports them; the launch uses these).
__host__ __device__ inline size_t out_tile_floats(int F, int SK, int D) {
  return 2 * (size_t)SK * D + 3 * (size_t)F * D + ((size_t)F + 3) / 4 * 4;
}
__host__ __device__ inline size_t qkv_tile_floats(int F, int SK, int D) {
  return 2 * (size_t)SK * D + 5 * (size_t)F * D + ((size_t)F + 3) / 4 * 4;
}

// C [rows, ncols] = A [rows, K] (row stride lda, shared) . W [K, ncols]
// (global, row-major), W streamed through buf [2][SK][ncols] in slices of
// SK rows by cp.async, each slice's product register-tiled (smem_gemm) and
// added to C in slice order. The caller has issued the first slice into
// buf as the last cp.async group; every thread calls this, and it ends
// with a block barrier.
__device__ void streamed_gemm(const float* A, int lda, int rows, int K, const float* __restrict__ Wg,
                              int ncols, float* buf, int SK, float* C) {
  const int S = K / SK;
  for (int s = 0; s < S; ++s) {
    if (s + 1 < S) {
      vsl::cp_async_floats(buf + (size_t)((s + 1) & 1) * SK * ncols,
                           Wg + (size_t)(s + 1) * SK * ncols, SK * ncols);
      vsl::cp_async_wait<1>();
    } else {
      vsl::cp_async_wait<0>();
    }
    __syncthreads();  // slice s landed for every thread; C's last slice written
    vsl::smem_gemm<kBwdGemmRows, 4>(
        A + s * SK, lda, rows, SK, buf + (size_t)(s & 1) * SK * ncols, ncols, ncols,
        [&](int t, int o, float4 acc) {
          float4* c = reinterpret_cast<float4*>(C + (size_t)t * ncols + o);
          if (s > 0) {
            const float4 v = *c;
            acc.x += v.x;
            acc.y += v.y;
            acc.z += v.z;
            acc.w += v.w;
          }
          *c = acc;
        });
    __syncthreads();  // slice s read before its buffer takes slice s + 2
  }
}

// 1. out = drop203(z.Wd + bd) + res: g_dpre = drop203(g) (and dbd); g_z =
// g_dpre . Wd^T; z = drop202(LN2(res)): the LN2 backward (dgam2, dbeta2);
// g_res = g + the LN2 path; g_att = drop201(g_res). One tile of F frames
// of one row; writes z and g_dpre (for dwd), g_res and g_att.
__global__ void __launch_bounds__(kThreads)
bwd_out_tile_kernel(const float* __restrict__ x, const float* __restrict__ att,
                    const float* __restrict__ gam, const float* __restrict__ beta,
                    const float* __restrict__ wdT, vsl::Dropout drop, const float* __restrict__ g,
                    float* __restrict__ z_ws, float* __restrict__ gdpre_ws,
                    float* __restrict__ gres_ws, float* __restrict__ gatt_ws,
                    float* __restrict__ part, int T, int D, int F, int SK) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, t0 = blockIdx.x * F, nf = min(F, T - t0), nel = nf * D;
  const size_t FD = (size_t)F * D;
  float* buf = reinterpret_cast<float*>(smem4);
  float* GD = buf + 2 * (size_t)SK * D;  // g_dpre
  float* XH = GD + FD;                   // res, then its xh
  float* GZ = XH + FD;                   // g_z, then drop202(g_z)
  float* inv = GZ + FD;                  // [F]
  const size_t tile = ((size_t)b * T + t0) * D;
  const uint32_t seed = drop.seed(b);
  const uint32_t s201 = vsl::site_salt(0x201u), s202 = vsl::site_salt(0x202u),
                 s203 = vsl::site_salt(0x203u);
  float* pr = part + ((size_t)b * gridDim.x + blockIdx.x) * 8 * D;
  vsl::cp_async_floats(buf, wdT, SK * D);  // lands behind the loads and the LN
  for (int i = threadIdx.x; i < nel; i += blockDim.x) {
    const int t = t0 + i / D, c = i % D;
    const float gd = drop.apply(g[tile + i], seed, s203, t, c);
    GD[i] = gd;
    gdpre_ws[tile + i] = gd;
    XH[i] = drop.apply(att[tile + i], seed, s201, t, c) + x[tile + i];
  }
  __syncthreads();
  vsl::ln_normalize_rows(XH, XH, inv, nf, D);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < nf; ++t) s += GD[(size_t)t * D + c];
    pr[7 * D + c] = s;  // dbd
  }
  streamed_gemm(GD, D, nf, D, wdT, D, buf, SK, GZ);  // g_z = g_dpre . Wd^T
  for (int i = threadIdx.x; i < nel; i += blockDim.x) {
    const int t = t0 + i / D, c = i % D;
    GZ[i] = drop.apply(GZ[i], seed, s202, t, c);
    z_ws[tile + i] = drop.apply(XH[i] * __ldg(gam + c) + __ldg(beta + c), seed, s202, t, c);
  }
  __syncthreads();
  vsl::ln_backward_rows(  // dgam, dbeta of LN2
      GZ, XH, inv, gam, nf, D, pr + D, pr + 3 * D, [&](int t, int c, float v) {
        const size_t i = tile + (size_t)t * D + c;
        const float gr = g[i] + v;
        gres_ws[i] = gr;
        gatt_ws[i] = drop.apply(gr, seed, s201, t0 + t, c);
      });
}

// 3. qkv = y.Wqkv + bqkv, y = drop200(LN1(x)): dbqkv, g_y = dqkv . Wqkv^T,
// the LN1 backward (dgam1, dbeta1), dx = g_res + the LN1 path. One tile of
// F frames of one row; writes y (for dwqkv) and dx.
__global__ void __launch_bounds__(kThreads)
bwd_qkv_tile_kernel(const float* __restrict__ x, const float* __restrict__ gam,
                    const float* __restrict__ beta, const float* __restrict__ wqkvT,
                    vsl::Dropout drop, const float* __restrict__ dqkv,
                    const float* __restrict__ gres_ws, float* __restrict__ y_ws,
                    float* __restrict__ dx, float* __restrict__ part, int T, int D, int F, int SK) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, t0 = blockIdx.x * F, nf = min(F, T - t0), nel = nf * D;
  const size_t FD = (size_t)F * D;
  float* buf = reinterpret_cast<float*>(smem4);
  float* DQ = buf + 2 * (size_t)SK * D;  // dqkv [F][3D]
  float* XH = DQ + 3 * FD;               // xh of LN1
  float* GY = XH + FD;                   // g_y, then drop200(g_y)
  float* inv = GY + FD;                  // [F]
  const size_t tile = ((size_t)b * T + t0) * D;
  const uint32_t seed = drop.seed(b), s200 = vsl::site_salt(0x200u);
  float* pr = part + ((size_t)b * gridDim.x + blockIdx.x) * 8 * D;
  vsl::cp_async_floats(buf, wqkvT, SK * D);  // lands behind the loads and the LN
  for (int i = threadIdx.x; i < 3 * nel; i += blockDim.x) DQ[i] = dqkv[3 * tile + i];
  vsl::ln_normalize_rows(x + tile, XH, inv, nf, D);
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * D; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < nf; ++t) s += DQ[(size_t)t * 3 * D + c];
    pr[4 * D + c] = s;  // dbqkv
  }
  streamed_gemm(DQ, 3 * D, nf, 3 * D, wqkvT, D, buf, SK, GY);  // g_y = dqkv . Wqkv^T
  for (int i = threadIdx.x; i < nel; i += blockDim.x) {
    const int t = t0 + i / D, c = i % D;
    GY[i] = drop.apply(GY[i], seed, s200, t, c);
    y_ws[tile + i] = drop.apply(XH[i] * __ldg(gam + c) + __ldg(beta + c), seed, s200, t, c);
  }
  __syncthreads();
  vsl::ln_backward_rows(  // dgam, dbeta of LN1
      GY, XH, inv, gam, nf, D, pr, pr + 2 * D, [&](int t, int c, float v) {
        const size_t i = tile + (size_t)t * D + c;
        dx[i] = gres_ws[i] + v;
      });
}

// out(m, n) = sum_k a(m, k) * b(k, n) for m < M, n < N, k < Kd, one fmaf
// chain over k in order, handed to epi(m, n, v). A work item is RM rows m =
// mi + i * MT and RN columns n = ni + j * NT (MT = ceil(M / RM), NT =
// ceil(N / RN)), ni fastest: neighbouring threads take neighbouring
// columns, so rows of an operand laid out along k with an odd stride are
// read without bank conflicts, and rows shared by a warp are broadcast.
template <int RM, int RN, typename A, typename Bf, typename Epi>
__device__ void tile_product(int M, int N, int Kd, A a, Bf b, Epi epi) {
  const int MT = (M + RM - 1) / RM, NT = (N + RN - 1) / RN;
  for (int it = threadIdx.x; it < MT * NT; it += blockDim.x) {
    const int mi = it / NT, ni = it - mi * NT;
    int m[RM], n[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) m[i] = min(mi + i * MT, M - 1);  // ragged: computed, never stored
#pragma unroll
    for (int j = 0; j < RN; ++j) n[j] = min(ni + j * NT, N - 1);
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < Kd; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = a(m[i], k);
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = b(k, n[j]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        if (mi + i * MT < M && ni + j * NT < N) epi(mi + i * MT, ni + j * NT, acc[i][j]);
  }
}

// The block's attention backward's shared memory for query tiles of TQ
// rows against T keys at head dim hd, in floats: Ks, Vs [T][hd + 1]; Qs (q
// * scale), Gs (g_att) [TQ][hd + 1]; SP [TQ][T + 1] (S, then P, then dS);
// PD [TQ][T + 1], drop(P); D_t [TQ]; the key mask's -1e30 terms [T]; this
// CTA's dK and dV partials [T][hd] each.
__host__ __device__ inline size_t attn_tile_floats(int T, int TQ, int hd) {
  return 2 * (size_t)T * (hd + 1) + 2 * (size_t)TQ * (hd + 1) + 2 * (size_t)TQ * (T + 1) + TQ +
         T + 2 * (size_t)T * hd;
}

// 2. the attention backward of one (row, head, query tile), in clusters of
// ceil(T / TQ) CTAs a (row, head) along x, CTA r taking the query rows
// [r TQ, min(T, (r + 1) TQ)). Reads q, k, v from qkv [B, T, 3D], the saved
// attention output att and its gradient g_att [B, T, D]; writes dq, dk, dv
// into dqkv [B, T, 3D].
template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_cluster_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                        vsl::Dropout drop, const float* __restrict__ att,
                        const float* __restrict__ gatt, float* __restrict__ dqkv, int T, int D,
                        int n_heads, int TQ, float scale) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nq = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int bh = static_cast<int>(blockIdx.x) / nq, b = bh / n_heads, h = bh - b * n_heads;
  const int t0 = r * TQ, nt = min(TQ, T - t0);
  constexpr int LD = HD + 1;
  const int lds = T + 1;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + (size_t)T * LD;
  float* Qs = Vs + (size_t)T * LD;
  float* Gs = Qs + (size_t)TQ * LD;
  float* SP = Gs + (size_t)TQ * LD;
  float* PD = SP + (size_t)TQ * lds;
  float* Dt = PD + (size_t)TQ * lds;
  float* neg = Dt + TQ;
  float* dKp = neg + T;
  float* dVp = dKp + (size_t)T * HD;
  const int ld3 = 3 * D;
  const float* qb = qkv + (size_t)b * T * ld3 + h * HD;  // q; k at + D, v at + 2D
  const size_t gb = (size_t)b * T * D + h * HD;           // att and g_att
  float* db = dqkv + (size_t)b * T * ld3 + h * HD;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  for (int i = tid; i < T * HD; i += nth) {
    const int j = i / HD, d = i - j * HD;
    Ks[j * LD + d] = qb[(size_t)j * ld3 + D + d];
    Vs[j * LD + d] = qb[(size_t)j * ld3 + 2 * D + d];
  }
  for (int i = tid; i < nt * HD; i += nth) {
    const int t = i / HD, d = i - t * HD;
    Qs[t * LD + d] = qb[(size_t)(t0 + t) * ld3 + d] * scale;
    Gs[t * LD + d] = gatt[gb + (size_t)(t0 + t) * D + d];
  }
  for (int j = tid; j < T; j += nth) neg[j] = (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue;
  // D_t = sum_j P dP = g_att_t . att_t, since att = drop(P).V
  for (int t = tid; t < nt; t += nth) {
    const float* gt = gatt + gb + (size_t)(t0 + t) * D;
    const float* at = att + gb + (size_t)(t0 + t) * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(gt[d], at[d], s);
    Dt[t] = s;
  }
  __syncthreads();
  // S = (q * scale).k^T + neg, the forward's scores bit for bit (head_score)
  tile_product<4, 4>(
      nt, T, HD, [&](int m, int k) { return Qs[m * LD + k]; },
      [&](int k, int n) { return Ks[n * LD + k]; },
      [&](int m, int n, float v) { SP[(size_t)m * lds + n] = v + neg[n]; });
  __syncthreads();
  // P and drop(P), one warp a query row, the keep bits hashed once a (t, j)
  for (int t = warp; t < nt; t += nwarps) {
    float* row = SP + (size_t)t * lds;
    float* prow = PD + (size_t)t * lds;
    float mx = -FLT_MAX;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, row[j]);
    mx = vsl::warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      l += e;
    }
    const float linv = 1.f / vsl::warp_sum(l);
    for (int j = lane; j < T; j += 32) {
      const float p = row[j] * linv;
      row[j] = p;
      prow[j] = drop.keep(seed, salt, t0 + t, j) ? drop.kept(p) : 0.f;
    }
  }
  __syncthreads();
  // this CTA's dV = drop(P)^T . G over its query rows
  tile_product<4, 2>(
      T, HD, nt, [&](int j, int t) { return PD[(size_t)t * lds + j]; },
      [&](int t, int d) { return Gs[t * LD + d]; },
      [&](int j, int d, float v) { dVp[j * HD + d] = v; });
  // dS = P * (drop(G.V^T) - D_t), in place: each element has one owner.
  // Where P > 0, drop(P) > 0 exactly where the key is kept; where P = 0,
  // dS = 0 whatever the keep.
  tile_product<4, 4>(
      nt, T, HD, [&](int m, int k) { return Gs[m * LD + k]; },
      [&](int k, int n) { return Vs[n * LD + k]; },
      [&](int t, int j, float dp) {
        float* sp = SP + (size_t)t * lds + j;
        const float dpd = PD[(size_t)t * lds + j] != 0.f ? drop.kept(dp) : 0.f;
        *sp = *sp * (dpd - Dt[t]);
      });
  __syncthreads();
  // dQ = scale * dS.K; this CTA's dK = dS^T . (q * scale) over its query rows
  tile_product<2, 2>(
      nt, HD, T, [&](int t, int j) { return SP[(size_t)t * lds + j]; },
      [&](int j, int d) { return Ks[j * LD + d]; },
      [&](int t, int d, float v) { db[(size_t)(t0 + t) * ld3 + d] = v * scale; });
  tile_product<4, 2>(
      T, HD, nt, [&](int j, int t) { return SP[(size_t)t * lds + j]; },
      [&](int t, int d) { return Qs[t * LD + d]; },
      [&](int j, int d, float v) { dKp[j * HD + d] = v; });
  cluster.sync();  // every CTA's partials
  // dK, dV of the key rows [t0, t0 + nt): the cluster's partials in rank order
  for (int i = tid; i < nt * HD; i += nth) {
    const int j = t0 + i / HD, d = i % HD;
    float sk = 0.f, sv = 0.f;
    for (int q = 0; q < nq; ++q) {
      sk += cluster.map_shared_rank(dKp, q)[j * HD + d];
      sv += cluster.map_shared_rank(dVp, q)[j * HD + d];
    }
    db[(size_t)j * ld3 + D + d] = sk;
    db[(size_t)j * ld3 + 2 * D + d] = sv;
  }
  cluster.sync();  // no CTA leaves while another may read its partials
}

// The whole-T attention backward (fused_mha's, vsl_mha_bwd) for one (row,
// head). Phase A, a thread per query row t: m, l and D_t = sum_j dp * p,
// then ds = p * (dp - D_t) into DS and dq = scale * ds . k. Phase B, a
// thread per key column j: P recomputed, dv = sum_t drop(p) * g_t and dk =
// sum_t ds * q_t * scale.
template <int HD>
__global__ void attention_bwd_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                                     const float* __restrict__ vp, int ld,
                                     const float* __restrict__ mask, vsl::Dropout drop,
                                     const float* __restrict__ gatt, int ldg,
                                     float* __restrict__ dqp, float* __restrict__ dkp,
                                     float* __restrict__ dvp, int ldd, int T, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [T, HD], q * scale
  float* Ks = Qs + (size_t)T * HD;               // [T, HD]
  float* Vs = Ks + (size_t)T * HD;               // [T, HD]
  float* Gs = Vs + (size_t)T * HD;               // [T, HD], g_att of the head
  float* neg = Gs + (size_t)T * HD;              // [T]
  float* ms = neg + T;                           // [T] row max
  float* ls = ms + T;                            // [T] 1 / row sum
  float* DS = ls + T;                            // [T, T + 1]
  const int lds = T + 1;  // DS row stride
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t base = (size_t)b * T * ld + h * HD;
  const size_t gbase = (size_t)b * T * ldg + h * HD;
  const size_t dbase = (size_t)b * T * ldd + h * HD;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const float dscale = drop.on() ? drop.scale : 1.f;
  for (int i = threadIdx.x; i < T * HD; i += blockDim.x) {
    const int j = i / HD, d = i - j * HD;
    Qs[i] = qp[base + (size_t)j * ld + d] * scale;
    Ks[i] = kp[base + (size_t)j * ld + d];
    Vs[i] = vp[base + (size_t)j * ld + d];
    Gs[i] = gatt[gbase + (size_t)j * ldg + d];
  }
  for (int j = threadIdx.x; j < T; j += blockDim.x)
    neg[j] = (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue;
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float q[HD], gv[HD], dq[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] = Qs[t * HD + d];
      gv[d] = Gs[t * HD + d];
      dq[d] = 0.f;
    }
    float m = -FLT_MAX;
    for (int j = 0; j < T; ++j) m = fmaxf(m, head_score<HD>(q, Ks + j * HD, neg[j]));
    float l = 0.f, edp = 0.f;
    for (int j = 0; j < T; ++j) {
      const float e = expf(head_score<HD>(q, Ks + j * HD, neg[j]) - m);
      l += e;
      if (drop.keep(seed, salt, t, j)) {
        float dpd = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dpd = fmaf(gv[d], Vs[j * HD + d], dpd);
        edp = fmaf(e, dpd * dscale, edp);
      }
    }
    const float linv = 1.f / l;
    const float Dt = edp * linv;
    for (int j = 0; j < T; ++j) {
      const float p = expf(head_score<HD>(q, Ks + j * HD, neg[j]) - m) * linv;
      float dp = 0.f;
      if (drop.keep(seed, salt, t, j)) {
#pragma unroll
        for (int d = 0; d < HD; ++d) dp = fmaf(gv[d], Vs[j * HD + d], dp);
        dp *= dscale;
      }
      const float ds = p * (dp - Dt);
      DS[(size_t)t * lds + j] = ds;
#pragma unroll
      for (int d = 0; d < HD; ++d) dq[d] = fmaf(ds, Ks[j * HD + d], dq[d]);
    }
    ms[t] = m;
    ls[t] = linv;
#pragma unroll
    for (int d = 0; d < HD; ++d) dqp[dbase + (size_t)t * ldd + d] = dq[d] * scale;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    float k[HD], dk[HD], dv[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      k[d] = Ks[j * HD + d];
      dk[d] = 0.f;
      dv[d] = 0.f;
    }
    for (int t = 0; t < T; ++t) {
      const float* qt = Qs + t * HD;
      if (drop.keep(seed, salt, t, j)) {
        const float pd = expf(head_score<HD>(k, qt, neg[j]) - ms[t]) * ls[t] * dscale;
#pragma unroll
        for (int d = 0; d < HD; ++d) dv[d] = fmaf(pd, Gs[t * HD + d], dv[d]);
      }
      const float ds = DS[(size_t)t * lds + j];
#pragma unroll
      for (int d = 0; d < HD; ++d) dk[d] = fmaf(ds, qt[d], dk[d]);
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dkp[dbase + (size_t)j * ldd + d] = dk[d];
      dvp[dbase + (size_t)j * ldd + d] = dv[d];
    }
  }
}

template <int HD>
cudaError_t launch_attention_bwd(const float* q, const float* k, const float* v, int ld,
                                 const float* mask, vsl::Dropout drop, const float* gatt, int ldg,
                                 float* dq, float* dk, float* dv, int ldd, int B, int T,
                                 int n_heads, cudaStream_t stream) {
  const int threads = min(kThreads, (T + 31) / 32 * 32);
  const size_t smem = ((size_t)4 * T * HD + 3 * T + (size_t)T * (T + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attention_bwd_kernel<HD><<<dim3(B, n_heads), threads, smem, stream>>>(
      q, k, v, ld, mask, drop, gatt, ldg, dq, dk, dv, ldd, T, vsl::head_scale(HD));
  return cudaGetLastError();
}

}  // namespace

extern "C" int vsl_mha_block_fwd(const float* x, const float* mask, const float* gam,
                                 const float* beta, const float* wqkv, const float* bqkv,
                                 const float* wd, const float* bd, const float* seeds,
                                 unsigned thresh, float scale, float* qkv, float* att,
                                 float* out, int B, int T, int D, int n_heads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const vsl::Dropout drop{seeds, thresh, scale};
  const int smem1 = T * D * static_cast<int>(sizeof(float));
  cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(ln_qkv_kernel), smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_qkv_kernel<<<dim3(B, (3 * D + kChunk - 1) / kChunk), kThreads, smem1, stream>>>(
      x, gam, beta, wqkv, bqkv, drop, qkv, T, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention<decltype(hd)::value>(qkv, qkv + D, qkv + 2 * D, 3 * D, mask, drop,
                                                 att, D, B, T, n_heads, stream);
  });
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem3 = 2 * T * D * static_cast<int>(sizeof(float));
  err = vsl::opt_in_smem(reinterpret_cast<const void*>(out_kernel), smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  out_kernel<<<dim3(B, (D + kChunk - 1) / kChunk), kThreads, smem3, stream>>>(
      x, att, gam + D, beta + D, wd, bd, drop, out, T, D);
  return static_cast<int>(cudaGetLastError());
}

// dsmall [8D]: dgam [2, D], dbeta [2, D], dbqkv [3D], dbd [D]; dwqkv
// [D, 3D]; dwd [D, D]. Plan: tiles of F frames, weight slices of SK rows
// (D % SK == 0, SK % 4 == 0), query tiles of TQ rows (ceil(T / TQ) <= 8).
// Workspaces: z, gdpre, gres, gatt, y [B, T, D]; dqkv [B, T, 3D]; part
// [B * ceil(T / F), 8D]; gemm_ws [splits, D, 3D] (unused when splits == 1).
extern "C" int vsl_mha_block_bwd(const float* x, const float* mask, const float* gam,
                                 const float* beta, const float* wqkvT, const float* wdT,
                                 const float* seeds, unsigned thresh, float scale,
                                 const float* qkv, const float* att, const float* g, float* dx,
                                 float* dsmall, float* dwqkv, float* dwd, float* z_ws,
                                 float* gdpre_ws, float* gres_ws, float* gatt_ws, float* y_ws,
                                 float* dqkv, float* part, float* gemm_ws, int splits, int B,
                                 int T, int D, int n_heads, int F, int SK, int TQ,
                                 void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int nq = TQ > 0 ? (T + TQ - 1) / TQ : 0;
  if (B < 1 || T < 1 || D < 4 || D % 4 || n_heads < 1 || D % n_heads || F < 1 || SK < 4 ||
      SK % 4 || D % SK || nq < 1 || nq > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const vsl::Dropout drop{seeds, thresh, scale};
  const dim3 grid((T + F - 1) / F, B);
  const int smem1 = static_cast<int>(out_tile_floats(F, SK, D) * sizeof(float));
  cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(bwd_out_tile_kernel), smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_out_tile_kernel<<<grid, kThreads, smem1, stream>>>(x, att, gam + D, beta + D, wdT, drop, g,
                                                         z_ws, gdpre_ws, gres_ws, gatt_ws, part,
                                                         T, D, F, SK);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = vsl::by_head_dim(D / n_heads, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const size_t smem2 = attn_tile_floats(T, TQ, HD) * sizeof(float);
    cudaError_t e = vsl::launch_cluster(attn_bwd_cluster_kernel<HD>, B * n_heads * nq, nq,
                                        kThreads, smem2, stream, qkv, mask, drop, att, gatt_ws,
                                        dqkv, T, D, n_heads, TQ, vsl::head_scale(HD));
    return e == cudaSuccess ? cudaGetLastError() : e;
  });
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem3 = static_cast<int>(qkv_tile_floats(F, SK, D) * sizeof(float));
  err = vsl::opt_in_smem(reinterpret_cast<const void*>(bwd_qkv_tile_kernel), smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_qkv_tile_kernel<<<grid, kThreads, smem3, stream>>>(x, gam, beta, wqkvT, drop, dqkv, gres_ws,
                                                         y_ws, dx, part, T, D, F, SK);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = vsl::sum_partials(part, dsmall, 1, B * grid.x, 8 * D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vsl::wgrad(z_ws, gdpre_ws, dwd, gemm_ws, 1, D, D, B * T, splits, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vsl::wgrad(y_ws, dqkv, dwqkv, gemm_ws, 1, D, 3 * D, B * T, splits, stream));
}

// Whole-T multi-head attention (fused_mha's small-T route), replacing the
// TPU kernels _make_mha_fwd_kernel and _make_mha_bwd_kernel: the block's
// attention launches over unsplit q, k, v [B, T, D], key mask [B, T] and
// per-row seeds. The backward keeps a head's dS [T, T + 1] in shared
// memory, so it takes T up to 209 at head dim 16 (ops/kernels.py
// attention_route); longer T goes to flash_mha.cu.
extern "C" int vsl_mha_fwd(const float* q, const float* k, const float* v, const float* mask,
                           const float* seeds, unsigned thresh, float scale, float* out, int B,
                           int T, int D, int n_heads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention<decltype(hd)::value>(q, k, v, D, mask, drop, out, D, B, T, n_heads,
                                                 stream);
  }));
}

extern "C" int vsl_mha_bwd(const float* q, const float* k, const float* v, const float* mask,
                           const float* seeds, unsigned thresh, float scale, const float* g,
                           float* dq, float* dk, float* dv, int B, int T, int D, int n_heads,
                           void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention_bwd<decltype(hd)::value>(q, k, v, D, mask, drop, g, D, dq, dk, dv, D,
                                                     B, T, n_heads, stream);
  }));
}
