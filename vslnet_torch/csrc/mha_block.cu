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
// Forward: three launches on the plan of ops/kernels.py mha_fwd_plan
// (frames a tile F, weight slice SK, query tile TQ).
//   1. LN1 + QKV on a grid of (tiles of F frames, rows): LayerNorm is per
//      frame, so the tiles are independent; each CTA normalises its F
//      frames, drops them (site 0x200 at the global (t, c)) and multiplies
//      them by Wqkv [D, 3D], which streams into shared memory in
//      double-buffered slices of SK rows by cp.async (streamed_gemm), each
//      slice's product register-tiled out of shared memory; + bqkv.
//   2. attention on CTAs of (query tile, head, row), no cluster: K_h and
//      V_h of the row in shared memory, S = (Q * scale).K^T + mask as a
//      register-tiled product into a [TQ, T + 1] tile (common.cuh's order
//      of the score's sums), max and sum by warp reductions over each row,
//      the keep bit hashed once a (t, j) while exp(s - max) is written back,
//      drop(P).V register-tiled, scaled by the drop scale over the sum.
//   3. residual + LN2 + dense + residual on the grid of launch 1: R =
//      drop_0x201(att) + x, Z = drop_0x202(LN2(R)), Z.Wd streamed as in 1,
//      out = drop_0x203(. + bd) + R.
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
//      all keys (the head's rows by 16-byte loads, several in flight a
//      thread): S = Q.K^T as a register-tiled product into shared memory,
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
// The whole-T fused_mha kernels (vsl_mha_fwd, vsl_mha_bwd at the end) run
// the block's attention bodies on q, k, v [B, T, D]: the forward the block
// forward's (launch 2 of the forward), the backward the block backward's
// cluster (launch 2 of the backward), with D_t from the forward's output.
// Both bodies take q, k, v and their outputs through base pointers and row
// strides.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hash.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// --- backward ------------------------------------------------------------------
// Per-tile partials part [B * tiles, 8D]: dgam [2D], dbeta [2D], dbqkv [3D],
// dbd [D].

constexpr int kGemmRows = 2;  // the per-frame launches' product tile (both directions)
constexpr int kMaxCluster = 8;        // query tiles a (row, head) in the attention backward
constexpr int kMaxAttnThreads = 512;  // threads a CTA of the attention backward, at most

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
    vsl::smem_gemm<kGemmRows, 4>(
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
// [r TQ, min(T, (r + 1) TQ)). Reads q, k and v through base pointers and
// one row stride ld (the block's packed qkv [B, T, 3D]: ld = 3D, k = qkv +
// D, v = qkv + 2D; the whole-T route's [B, T, D] tensors: ld = D), the
// saved attention output att and its gradient g_att [B, T, D]; writes dq,
// dk and dv through base pointers and one row stride ldd (into dqkv, or
// three [B, T, D] tensors).
template <int HD>
__global__ void __launch_bounds__(kMaxAttnThreads)
attn_bwd_cluster_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                        const float* __restrict__ vp, int ld, const float* __restrict__ mask,
                        vsl::Dropout drop, const float* __restrict__ att,
                        const float* __restrict__ gatt, float* __restrict__ dqp,
                        float* __restrict__ dkp, float* __restrict__ dvp, int ldd, int T, int D,
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
  const size_t ib = (size_t)b * T * ld + h * HD;  // q, k and v of the head
  const size_t gb = (size_t)b * T * D + h * HD;   // att and g_att
  const size_t ob = (size_t)b * T * ldd + h * HD;  // dq, dk and dv
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  // K_h, V_h and the tile's q * scale and g_att by 16-byte loads, several
  // in flight a thread (every row of a head starts on 16 bytes: ld, D and
  // h * HD are multiples of 4, the bases 16-byte aligned)
  constexpr int HD4 = HD / 4;
  const auto load4 = [](const float* src) { return *reinterpret_cast<const float4*>(src); };
  const auto store4 = [](float* dst, float4 v, float f) {
    dst[0] = v.x * f;
    dst[1] = v.y * f;
    dst[2] = v.z * f;
    dst[3] = v.w * f;
  };
#pragma unroll 4
  for (int i = tid; i < T * HD4; i += nth) {
    const int j = i / HD4, d = (i - j * HD4) * 4;
    const float4 kv = load4(kp + ib + (size_t)j * ld + d), vv = load4(vp + ib + (size_t)j * ld + d);
    store4(Ks + j * LD + d, kv, 1.f);
    store4(Vs + j * LD + d, vv, 1.f);
  }
#pragma unroll 2
  for (int i = tid; i < nt * HD4; i += nth) {
    const int t = i / HD4, d = (i - t * HD4) * 4;
    const float4 qv = load4(qp + ib + (size_t)(t0 + t) * ld + d);
    const float4 gv = load4(gatt + gb + (size_t)(t0 + t) * D + d);
    store4(Qs + t * LD + d, qv, scale);
    store4(Gs + t * LD + d, gv, 1.f);
  }
  for (int j = tid; j < T; j += nth) neg[j] = (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue;
  // D_t = sum_j P dP = g_att_t . att_t, since att = drop(P).V
  for (int t = tid; t < nt; t += nth) {
    const float* gt = gatt + gb + (size_t)(t0 + t) * D;
    const float* at = att + gb + (size_t)(t0 + t) * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 g4 = load4(gt + d), a4 = load4(at + d);
      s = fmaf(g4.x, a4.x, s);
      s = fmaf(g4.y, a4.y, s);
      s = fmaf(g4.z, a4.z, s);
      s = fmaf(g4.w, a4.w, s);
    }
    Dt[t] = s;
  }
  __syncthreads();
  // S = (q * scale).k^T + neg, the forward's scores bit for bit
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
  // dQ = scale * dS.K, in items of 2 x 2, or of 1 x 2 where those take no
  // more rounds of the CTA's threads (each element is one chain over the
  // keys either way)
  const auto ds_tj = [&](int t, int j) { return SP[(size_t)t * lds + j]; };
  const auto k_jd = [&](int j, int d) { return Ks[j * LD + d]; };
  const auto dq_out = [&](int t, int d, float v) {
    dqp[ob + (size_t)(t0 + t) * ldd + d] = v * scale;
  };
  const int rounds22 = ((nt + 1) / 2 * (HD / 2) + nth - 1) / nth;
  if (rounds22 < (nt * (HD / 2) + nth - 1) / nth)
    tile_product<2, 2>(nt, HD, T, ds_tj, k_jd, dq_out);
  else
    tile_product<1, 2>(nt, HD, T, ds_tj, k_jd, dq_out);
  // this CTA's dK = dS^T . (q * scale) over its query rows
  tile_product<4, 2>(
      T, HD, nt, [&](int j, int t) { return SP[(size_t)t * lds + j]; },
      [&](int t, int d) { return Qs[t * LD + d]; },
      [&](int j, int d, float v) { dKp[j * HD + d] = v; });
  cluster.sync();  // every CTA's partials
  // dK, dV of the key rows [t0, t0 + nt): the cluster's partials, all read
  // before they are summed in rank order
  for (int i = tid; i < nt * HD; i += nth) {
    const int j = t0 + i / HD, d = i % HD;
    float pk[kMaxCluster], pv[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < nq) {
        pk[q] = cluster.map_shared_rank(dKp, q)[j * HD + d];
        pv[q] = cluster.map_shared_rank(dVp, q)[j * HD + d];
      }
    }
    float sk = 0.f, sv = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < nq) {
        sk += pk[q];
        sv += pv[q];
      }
    }
    dkp[ob + (size_t)j * ldd + d] = sk;
    dvp[ob + (size_t)j * ldd + d] = sv;
  }
  cluster.sync();  // no CTA leaves while another may read its partials
}

// The attention backward (attn_bwd_cluster_kernel) of B rows and n_heads
// heads on query tiles of TQ rows: one cluster of ceil(T / TQ) CTAs of
// `threads` threads a (row, head).
template <int HD>
cudaError_t launch_attention_bwd_tiles(const float* q, const float* k, const float* v, int ld,
                                       const float* mask, vsl::Dropout drop, const float* att,
                                       const float* gatt, float* dq, float* dk, float* dv,
                                       int ldd, int B, int T, int D, int n_heads, int TQ,
                                       int threads, cudaStream_t stream) {
  const int nq = (T + TQ - 1) / TQ;
  const size_t smem = attn_tile_floats(T, TQ, HD) * sizeof(float);
  const cudaError_t err = vsl::launch_cluster(
      attn_bwd_cluster_kernel<HD>, B * n_heads * nq, nq, threads, smem, stream, q, k, v, ld,
      mask, drop, att, gatt, dq, dk, dv, ldd, T, D, n_heads, TQ, vsl::head_scale(HD));
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// --- forward, on mha_fwd_plan ---------------------------------------------------
// The per-frame launches' shared memory for F frames a tile and weight
// slices of SK rows, in floats: launch 1 the slices [2][SK][3D], Y [F][D]
// and C [F][3D]; launch 3 the slices [2][SK][D], R, Z and O [F][D]. The
// attention's for query tiles of TQ rows against T keys at head dim hd:
// Ks, Vs [T][hd + 1], Qs [TQ][hd + 1], S [TQ][T + 1], the key mask's -1e30
// terms [T] and each row's drop scale over its sum [TQ].
// (ops/kernels.py mha_fwd_plan reports them; the launches use these.)
__host__ __device__ inline size_t fwd_qkv_tile_floats(int F, int SK, int D) {
  return 6 * (size_t)SK * D + 4 * (size_t)F * D;
}
__host__ __device__ inline size_t fwd_out_tile_floats(int F, int SK, int D) {
  return 2 * (size_t)SK * D + 3 * (size_t)F * D;
}
__host__ __device__ inline size_t fwd_attn_tile_floats(int T, int TQ, int hd) {
  return 2 * (size_t)T * (hd + 1) + (size_t)TQ * (hd + 1) + (size_t)TQ * (T + 1) + T + TQ;
}

// 1. qkv = drop200(LN1(x)).Wqkv + bqkv for one tile of F frames of one row.
__global__ void __launch_bounds__(kThreads)
fwd_qkv_tile_kernel(const float* __restrict__ x, const float* __restrict__ gam,
                    const float* __restrict__ beta, const float* __restrict__ wqkv,
                    const float* __restrict__ bqkv, vsl::Dropout drop, float* __restrict__ qkv,
                    int T, int D, int F, int SK) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, t0 = blockIdx.x * F, nf = min(F, T - t0), nel = nf * D;
  float* buf = reinterpret_cast<float*>(smem4);
  float* Y = buf + 6 * (size_t)SK * D;  // drop200(LN1(x)) [F][D]
  float* C = Y + (size_t)F * D;         // Y.Wqkv [F][3D]
  const size_t tile = ((size_t)b * T + t0) * D;
  vsl::cp_async_floats(buf, wqkv, SK * 3 * D);  // lands behind the LN
  vsl::layer_norm_rows(x + tile, Y, gam, beta, nf, D);
  __syncthreads();
  if (drop.on()) {
    const uint32_t seed = drop.seed(b), s200 = vsl::site_salt(0x200u);
    for (int i = threadIdx.x; i < nel; i += blockDim.x)
      Y[i] = drop.apply(Y[i], seed, s200, t0 + i / D, i % D);
    __syncthreads();
  }
  streamed_gemm(Y, D, nf, D, wqkv, 3 * D, buf, SK, C);
  float* q = qkv + 3 * tile;
  for (int i = threadIdx.x; i < 3 * nel; i += blockDim.x) q[i] = C[i] + __ldg(bqkv + i % (3 * D));
}

// 2. the attention of one (query tile, head, row): att from q, k and v,
// read through base pointers and one row stride ld as the whole-T kernels
// read them (the block's packed qkv [B, T, 3D]: ld = 3D, k = qkv + D, v =
// qkv + 2D), the output with row stride ldo.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_fwd_tile_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                     const float* __restrict__ vp, int ld, const float* __restrict__ mask,
                     vsl::Dropout drop, float* __restrict__ att, int ldo, int T, int TQ,
                     float scale) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * TQ, nt = min(TQ, T - t0);
  constexpr int LD = HD + 1;
  const int lds = T + 1;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + (size_t)T * LD;
  float* Qs = Vs + (size_t)T * LD;
  float* S = Qs + (size_t)TQ * LD;
  float* neg = S + (size_t)TQ * lds;
  float* rs = neg + T;
  const size_t hb = (size_t)b * T * ld + h * HD;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  for (int i = tid; i < T * HD; i += nth) {
    const int j = i / HD, d = i - j * HD;
    Ks[j * LD + d] = kp[hb + (size_t)j * ld + d];
    Vs[j * LD + d] = vp[hb + (size_t)j * ld + d];
  }
  for (int i = tid; i < nt * HD; i += nth) {
    const int t = i / HD, d = i - t * HD;
    Qs[t * LD + d] = qp[hb + (size_t)(t0 + t) * ld + d] * scale;
  }
  for (int j = tid; j < T; j += nth) neg[j] = (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue;
  __syncthreads();
  // S = (q * scale).k^T + neg, the score order of common.cuh
  tile_product<4, 4>(
      nt, T, HD, [&](int m, int k) { return Qs[m * LD + k]; },
      [&](int k, int n) { return Ks[n * LD + k]; },
      [&](int m, int n, float v) { S[(size_t)m * lds + n] = v + neg[n]; });
  __syncthreads();
  // one warp a query row: exp(s - max) where the key is kept, 0 where it is
  // dropped, the keep bits hashed once a (t, j); the sum over every key
  const float dscale = drop.on() ? drop.scale : 1.f;
  for (int t = warp; t < nt; t += nwarps) {
    float* row = S + (size_t)t * lds;
    float mx = -FLT_MAX;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, row[j]);
    mx = vsl::warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(row[j] - mx);
      l += e;
      row[j] = drop.keep(seed, salt, t0 + t, j) ? e : 0.f;
    }
    l = vsl::warp_sum(l);
    if (lane == 0) rs[t] = dscale / l;
  }
  __syncthreads();
  // att = drop(P).V: the kept exps . V, times the drop scale over the sum
  float* ob = att + ((size_t)b * T + t0) * ldo + h * HD;
  tile_product<2, 2>(
      nt, HD, T, [&](int t, int j) { return S[(size_t)t * lds + j]; },
      [&](int j, int d) { return Vs[j * LD + d]; },
      [&](int t, int d, float v) { ob[(size_t)t * ldo + d] = v * rs[t]; });
}

template <int HD>
cudaError_t launch_attention_tiles(const float* q, const float* k, const float* v, int ld,
                                   const float* mask, vsl::Dropout drop, float* att, int ldo,
                                   int B, int T, int n_heads, int TQ, cudaStream_t stream) {
  const size_t smem = fwd_attn_tile_floats(T, TQ, HD) * sizeof(float);
  cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(attn_fwd_tile_kernel<HD>), smem);
  if (err != cudaSuccess) return err;
  attn_fwd_tile_kernel<HD><<<dim3((T + TQ - 1) / TQ, n_heads, B), kThreads, smem, stream>>>(
      q, k, v, ld, mask, drop, att, ldo, T, TQ, vsl::head_scale(HD));
  return cudaGetLastError();
}

// 3. out = drop203(drop202(LN2(R)).Wd + bd) + R, R = drop201(att) + x, for
// one tile of F frames of one row.
__global__ void __launch_bounds__(kThreads)
fwd_out_tile_kernel(const float* __restrict__ x, const float* __restrict__ att,
                    const float* __restrict__ gam, const float* __restrict__ beta,
                    const float* __restrict__ wd, const float* __restrict__ bd, vsl::Dropout drop,
                    float* __restrict__ out, int T, int D, int F, int SK) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, t0 = blockIdx.x * F, nf = min(F, T - t0), nel = nf * D;
  const size_t FD = (size_t)F * D;
  float* buf = reinterpret_cast<float*>(smem4);
  float* R = buf + 2 * (size_t)SK * D;  // the residual
  float* Z = R + FD;                    // drop202(LN2(R))
  float* O = Z + FD;                    // Z.Wd
  const size_t tile = ((size_t)b * T + t0) * D;
  const uint32_t seed = drop.seed(b);
  const uint32_t s201 = vsl::site_salt(0x201u), s202 = vsl::site_salt(0x202u),
                 s203 = vsl::site_salt(0x203u);
  vsl::cp_async_floats(buf, wd, SK * D);  // lands behind the residual and the LN
  for (int i = threadIdx.x; i < nel; i += blockDim.x)
    R[i] = drop.apply(att[tile + i], seed, s201, t0 + i / D, i % D) + x[tile + i];
  __syncthreads();
  vsl::layer_norm_rows(R, Z, gam, beta, nf, D);
  __syncthreads();
  if (drop.on()) {
    for (int i = threadIdx.x; i < nel; i += blockDim.x)
      Z[i] = drop.apply(Z[i], seed, s202, t0 + i / D, i % D);
    __syncthreads();
  }
  streamed_gemm(Z, D, nf, D, wd, D, buf, SK, O);
  for (int i = threadIdx.x; i < nel; i += blockDim.x) {
    const int c = i % D;
    out[tile + i] = drop.apply(O[i] + __ldg(bd + c), seed, s203, t0 + i / D, c) + R[i];
  }
}

}  // namespace

// Plan: tiles of F frames, weight slices of SK rows (D % SK == 0, SK % 4 ==
// 0), query tiles of TQ rows (ops/kernels.py mha_fwd_plan).
extern "C" int vsl_mha_block_fwd(const float* x, const float* mask, const float* gam,
                                 const float* beta, const float* wqkv, const float* bqkv,
                                 const float* wd, const float* bd, const float* seeds,
                                 unsigned thresh, float scale, float* qkv, float* att,
                                 float* out, int B, int T, int D, int n_heads, int F, int SK,
                                 int TQ, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || D < 4 || D % 4 || n_heads < 1 || D % n_heads || F < 1 || SK < 4 ||
      SK % 4 || D % SK || TQ < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const vsl::Dropout drop{seeds, thresh, scale};
  const dim3 grid((T + F - 1) / F, B);
  const int smem1 = static_cast<int>(fwd_qkv_tile_floats(F, SK, D) * sizeof(float));
  cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(fwd_qkv_tile_kernel), smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_qkv_tile_kernel<<<grid, kThreads, smem1, stream>>>(x, gam, beta, wqkv, bqkv, drop, qkv, T,
                                                         D, F, SK);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention_tiles<decltype(hd)::value>(qkv, qkv + D, qkv + 2 * D, 3 * D, mask,
                                                       drop, att, D, B, T, n_heads, TQ, stream);
  });
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem3 = static_cast<int>(fwd_out_tile_floats(F, SK, D) * sizeof(float));
  err = vsl::opt_in_smem(reinterpret_cast<const void*>(fwd_out_tile_kernel), smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_out_tile_kernel<<<grid, kThreads, smem3, stream>>>(x, att, gam + D, beta + D, wd, bd, drop,
                                                         out, T, D, F, SK);
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
      SK % 4 || D % SK || nq < 1 || nq > kMaxCluster)
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
    return launch_attention_bwd_tiles<decltype(hd)::value>(
        qkv, qkv + D, qkv + 2 * D, 3 * D, mask, drop, att, gatt_ws, dqkv, dqkv + D, dqkv + 2 * D,
        3 * D, B, T, D, n_heads, TQ, kThreads, stream);
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
// TPU kernels _make_mha_fwd_kernel and _make_mha_bwd_kernel, over unsplit
// q, k, v [B, T, D], key mask [B, T] and per-row seeds. The forward runs
// the block forward's attention on query tiles of TQ rows (ops/kernels.py
// MHA_WHOLE_QTILE); the backward the block backward's cluster of query
// tiles of TQ rows (ceil(T / TQ) <= 8) in CTAs of `threads` threads
// (ops/kernels.py mha_whole_bwd_plan), with D_t = g . out from the
// forward's output out.
extern "C" int vsl_mha_fwd(const float* q, const float* k, const float* v, const float* mask,
                           const float* seeds, unsigned thresh, float scale, float* out, int B,
                           int T, int D, int n_heads, int TQ, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (TQ < 1) return static_cast<int>(cudaErrorInvalidValue);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention_tiles<decltype(hd)::value>(q, k, v, D, mask, drop, out, D, B, T,
                                                       n_heads, TQ, stream);
  }));
}

extern "C" int vsl_mha_bwd(const float* q, const float* k, const float* v, const float* mask,
                           const float* seeds, unsigned thresh, float scale, const float* out,
                           const float* g, float* dq, float* dk, float* dv, int B, int T, int D,
                           int n_heads, int TQ, int threads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int nq = TQ > 0 ? (T + TQ - 1) / TQ : 0;
  if (B < 1 || T < 1 || n_heads < 1 || D % n_heads || nq < 1 || nq > kMaxCluster ||
      threads < 32 || threads % 32 || threads > kMaxAttnThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention_bwd_tiles<decltype(hd)::value>(q, k, v, D, mask, drop, out, g, dq,
                                                           dk, dv, D, B, T, D, n_heads, TQ,
                                                           threads, stream);
  }));
}
