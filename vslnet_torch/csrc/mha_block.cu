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
// Backward (fp32; the bf16 backward has kernels of its own, below): three
// launches, plus the weight products; the plan (frames a tile F, weight
// slice SK, query tile TQ) is ops/kernels.py mha_bwd_plan.
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
// strides, and are templated on the storage types of their inputs and
// outputs: vsl_mha_fwd_bf16 and vsl_mha_bwd_bf16 (#11b, #12b) run the
// bodies' kBf16 forms on bf16 q, k, v and g, with bf16 outputs.
//
// bf16 (vsl_mha_block_fwd_bf16): the TPU forward at bf16
// (_mha_block_fwd_math, pallas_kernels.py:1689-1746) takes x in bf16 and
// the weights in fp32: y = bf16(drop(LN1(x))), qkv = y.bf16(Wqkv) with
// fp32 accumulation + bqkv, then q, k and v rounded to bf16; scores
// bf16(q_h * scale).k_h with scale = bf16(1/sqrt(hd)) and fp32
// accumulation, the fp32 mask and softmax, bf16(drop(p)).v_h with fp32
// accumulation; the fp32 residual; z = bf16(drop(LN2(res))),
// z.bf16(Wd) + bd; the output rounded to bf16. Three kernels of its own
// on the tensor cores (mha_proj_tc_kernel, attn_fwd_tc_kernel, further
// down, on ops/kernels.py mha_fwd_bf16_plan): the two projections on tiles
// of the flattened [B T] frames with the LayerNorm, dropout and rounding in
// their prologue and the bias, rounding, dropout and residual on the C
// fragments; the attention a CTA a (query tile, head, row) with S and p . v
// by mma.sync and the softmax on the C fragments. qkv is stored in bf16
// (its values are bf16 either way; #10b reads it so), att in fp32 as the
// TPU kernel's residual.
//
// bf16 (vsl_mha_block_bwd_bf16): the TPU backward at bf16
// (_make_mha_block_bwd_kernel, pallas_kernels.py:1762-1858), from the bf16
// forward's qkv and att and its bf16(Wqkv) and bf16(Wd). Its custom VJP
// rounds at its own points: each bias gradient sums the UNROUNDED gradient
// (dbd of g_dpre, dbqkv of dqkv), and the product beside it takes the
// rounded one (dwd = bf16(z)^T . bf16(g_dpre), g_z = bf16(g_dpre) .
// bf16(Wd)^T; dwqkv = bf16(y)^T . bf16(dqkv), g_y = bf16(dqkv) .
// bf16(Wqkv)^T); the attention: bf16(g_att_h), dV = bf16(drop(P))^T . gh,
// dS = P (dP - sum_j dP P) in fp32 (the sum over the keys, not from att),
// dQ = (bf16(dS) . k_h) * scale, dK = bf16(dS)^T . bf16(q_h * scale),
// scale = bf16(1/sqrt(hd)); the LayerNorm backwards, g_res and the stream
// between the launches fp32; dx = bf16(g_res + the LN1 path). Three
// kernels of its own on the tensor cores (mha_bwd_out_tc_kernel,
// attn_bwd_tc_kernel, mha_bwd_qkv_tc_kernel, on ops/kernels.py
// mha_bwd_bf16_plan, further down): every product on mma.sync, dwd and
// dwqkv on mma.cuh's wgrad_tc. The whole-T backward at bf16 (#12b) keeps
// the cluster body's kBf16 form.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hash.cuh"
#include "mma.cuh"

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
// three [B, T, D] tensors). kBf16: the attention at bf16 (#12b; scale
// already bf16): q * scale and g_att rounded to bf16 as they land, drop(P)
// rounded for dV, and dS = P (dP - sum_j dP P) with the sum taken over the
// keys (not from att, whose product rounded drop(P)), rounded for dQ and
// dK. IT: the storage type of q, k, v, att and g_att; OT: that of dq, dk
// and dv (#12b: both bf16, the outputs rounded once as they are stored).
template <int HD, bool kBf16 = false, typename IT = float, typename OT = float>
__global__ void __launch_bounds__(kMaxAttnThreads)
attn_bwd_cluster_kernel(const IT* __restrict__ qp, const IT* __restrict__ kp,
                        const IT* __restrict__ vp, int ld, const float* __restrict__ mask,
                        vsl::Dropout drop, const IT* __restrict__ att,
                        const IT* __restrict__ gatt, OT* __restrict__ dqp,
                        OT* __restrict__ dkp, OT* __restrict__ dvp, int ldd, int T, int D,
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
  // K_h, V_h and the tile's q * scale and g_att by 16-byte loads (8-byte at
  // bf16), several in flight a thread (every row of a head starts on 16
  // bytes: ld, D and h * HD are multiples of 4, the bases 16-byte aligned)
  constexpr int HD4 = HD / 4;
  using vsl::load4;
  const auto store4 = [](float* dst, float4 v, float f) {
    const auto rnd = [](float a) { return kBf16 ? vsl::bf16_round(a) : a; };
    dst[0] = rnd(v.x * f);
    dst[1] = rnd(v.y * f);
    dst[2] = rnd(v.z * f);
    dst[3] = rnd(v.w * f);
  };
#pragma unroll 4
  for (int i = tid; i < T * HD4; i += nth) {
    const int j = i / HD4, d = (i - j * HD4) * 4;
    const float4 kv = load4(kp + ib + (size_t)j * ld + d), vv = load4(vp + ib + (size_t)j * ld + d);
    store4(Ks + j * LD + d, kv, 1.f);  // bf16 values already at bf16
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
  // D_t = sum_j P dP = g_att_t . att_t, since att = drop(P).V (at bf16 it
  // is summed over the keys below)
  for (int t = tid; t < nt && !kBf16; t += nth) {
    const IT* gt = gatt + gb + (size_t)(t0 + t) * D;
    const IT* at = att + gb + (size_t)(t0 + t) * D;
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
      T, HD, nt,
      [&](int j, int t) {
        const float pd = PD[(size_t)t * lds + j];
        return kBf16 ? vsl::bf16_round(pd) : pd;
      },
      [&](int t, int d) { return Gs[t * LD + d]; },
      [&](int j, int d, float v) { dVp[j * HD + d] = v; });
  if constexpr (!kBf16) {
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
  } else {
    __syncthreads();  // drop(P) read by dV before dP takes its place
    // dP = drop(G.V^T) into PD, in place
    tile_product<4, 4>(
        nt, T, HD, [&](int m, int k) { return Gs[m * LD + k]; },
        [&](int k, int n) { return Vs[n * LD + k]; },
        [&](int t, int j, float dp) {
          float* pd = PD + (size_t)t * lds + j;
          *pd = *pd != 0.f ? drop.kept(dp) : 0.f;
        });
    __syncthreads();
    // one warp a query row: D_t = sum_j dP P, then dS = bf16(P (dP - D_t))
    for (int t = warp; t < nt; t += nwarps) {
      float* row = SP + (size_t)t * lds;
      const float* dprow = PD + (size_t)t * lds;
      float s = 0.f;
      for (int j = lane; j < T; j += 32) s = fmaf(dprow[j], row[j], s);
      s = vsl::warp_sum(s);
      for (int j = lane; j < T; j += 32) row[j] = vsl::bf16_round(row[j] * (dprow[j] - s));
    }
  }
  __syncthreads();
  // dQ = scale * dS.K, in items of 2 x 2, or of 1 x 2 where those take no
  // more rounds of the CTA's threads (each element is one chain over the
  // keys either way)
  const auto ds_tj = [&](int t, int j) { return SP[(size_t)t * lds + j]; };
  const auto k_jd = [&](int j, int d) { return Ks[j * LD + d]; };
  const auto dq_out = [&](int t, int d, float v) {
    dqp[ob + (size_t)(t0 + t) * ldd + d] = vsl::from_float<OT>(v * scale);
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
    dkp[ob + (size_t)j * ldd + d] = vsl::from_float<OT>(sk);
    dvp[ob + (size_t)j * ldd + d] = vsl::from_float<OT>(sv);
  }
  cluster.sync();  // no CTA leaves while another may read its partials
}

// The attention backward (attn_bwd_cluster_kernel) of B rows and n_heads
// heads on query tiles of TQ rows: one cluster of ceil(T / TQ) CTAs of
// `threads` threads a (row, head).
// kBf16: the bf16 body, with the scale rounded to bf16.
template <int HD, bool kBf16 = false, typename IT = float, typename OT = float>
cudaError_t launch_attention_bwd_tiles(const IT* q, const IT* k, const IT* v, int ld,
                                       const float* mask, vsl::Dropout drop, const IT* att,
                                       const IT* gatt, OT* dq, OT* dk, OT* dv,
                                       int ldd, int B, int T, int D, int n_heads, int TQ,
                                       int threads, cudaStream_t stream) {
  const int nq = (T + TQ - 1) / TQ;
  const size_t smem = attn_tile_floats(T, TQ, HD) * sizeof(float);
  const float scale = kBf16 ? vsl::bf16_round_host(vsl::head_scale(HD)) : vsl::head_scale(HD);
  const cudaError_t err = vsl::launch_cluster(
      attn_bwd_cluster_kernel<HD, kBf16, IT, OT>, B * n_heads * nq, nq, threads, smem, stream, q, k, v,
      ld, mask, drop, att, gatt, dq, dk, dv, ldd, T, D, n_heads, TQ, scale);
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
// (The bf16 forward's kernels are further down.)
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
// qkv + 2D), the output with row stride ldo. kBf16: q * scale rounded to
// bf16 (scale already bf16), the probabilities normalised, dropped and
// rounded to bf16 before the product. IT: the storage type of q, k and v;
// OT: that of the output (#11b: both bf16, the output rounded once as it
// is stored).
template <int HD, bool kBf16 = false, typename IT = float, typename OT = float>
__global__ void __launch_bounds__(kThreads)
attn_fwd_tile_kernel(const IT* __restrict__ qp, const IT* __restrict__ kp,
                     const IT* __restrict__ vp, int ld, const float* __restrict__ mask,
                     vsl::Dropout drop, OT* __restrict__ att, int ldo, int T, int TQ,
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
    Ks[j * LD + d] = vsl::to_float(kp[hb + (size_t)j * ld + d]);
    Vs[j * LD + d] = vsl::to_float(vp[hb + (size_t)j * ld + d]);
  }
  for (int i = tid; i < nt * HD; i += nth) {
    const int t = i / HD, d = i - t * HD;
    const float qs = vsl::to_float(qp[hb + (size_t)(t0 + t) * ld + d]) * scale;
    Qs[t * LD + d] = kBf16 ? vsl::bf16_round(qs) : qs;
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
    if (kBf16) {  // p = e / l, dropped, rounded; a lane rewrites its own keys
      for (int j = lane; j < T; j += 32) {
        const float e = expf(row[j] - mx);
        l += e;
        row[j] = e;
      }
      l = vsl::warp_sum(l);
      for (int j = lane; j < T; j += 32)
        row[j] = drop.keep(seed, salt, t0 + t, j) ? vsl::bf16_round(drop.kept(row[j] / l)) : 0.f;
      if (lane == 0) rs[t] = 1.f;
    } else {
      for (int j = lane; j < T; j += 32) {
        const float e = expf(row[j] - mx);
        l += e;
        row[j] = drop.keep(seed, salt, t0 + t, j) ? e : 0.f;
      }
      l = vsl::warp_sum(l);
      if (lane == 0) rs[t] = dscale / l;
    }
  }
  __syncthreads();
  // att = drop(P).V: the kept exps . V, times the drop scale over the sum
  OT* ob = att + ((size_t)b * T + t0) * ldo + h * HD;
  tile_product<2, 2>(
      nt, HD, T, [&](int t, int j) { return S[(size_t)t * lds + j]; },
      [&](int j, int d) { return Vs[j * LD + d]; },
      [&](int t, int d, float v) { ob[(size_t)t * ldo + d] = vsl::from_float<OT>(v * rs[t]); });
}

template <int HD, bool kBf16 = false, typename IT = float, typename OT = float>
cudaError_t launch_attention_tiles(const IT* q, const IT* k, const IT* v, int ld,
                                   const float* mask, vsl::Dropout drop, OT* att, int ldo,
                                   int B, int T, int n_heads, int TQ, cudaStream_t stream) {
  auto kernel = attn_fwd_tile_kernel<HD, kBf16, IT, OT>;
  const size_t smem = fwd_attn_tile_floats(T, TQ, HD) * sizeof(float);
  cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  const float scale = kBf16 ? vsl::bf16_round_host(vsl::head_scale(HD)) : vsl::head_scale(HD);
  kernel<<<dim3((T + TQ - 1) / TQ, n_heads, B), kThreads, smem, stream>>>(
      q, k, v, ld, mask, drop, att, ldo, T, TQ, scale);
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


// --- the bf16 forward on the tensor cores (#3 at bf16, head dims 8-64) ----
// Three launches on ops/kernels.py mha_fwd_bf16_plan, the TPU kernel's
// function at bf16 (_mha_block_fwd_math, pallas_kernels.py:1689-1746) with
// its products on mma.sync m16n8k16 (bf16 operands, fp32 sums):
//   1. (mha_proj_tc_kernel, kRes false) a CTA a tile of MR frames of the
//      flattened [B T] rows and NC of Wqkv's columns: y = bf16(drop200(
//      LN1(x))), one warp a frame (layer_norm_rows' sums and expressions),
//      into a bf16 tile; bf16(Wqkv)'s columns (the wrapper rounds the
//      weights once a call) by cp.async, landing behind the LayerNorm; qkv
//      = y . bf16(Wqkv) by mma.cuh tile_mma (a warp a (16 frames, 16
//      columns) item, each group of 4 k16 steps accumulated in the tensor
//      cores and added by an fp32 add), + bqkv and rounded in the epilogue,
//      stored as bf16 [B, T, 3D] (its values are bf16 either way; the
//      backward reads it as the forward's residual).
//   2. (attn_fwd_tc_kernel) a CTA a (query tile of 16 W queries, head,
//      row), W warps of 16 queries: the head's k and v rows and the tile's
//      q rows by cp.async (bf16, as qkv holds them; head dim 8 padded to a
//      k16 step with zeros), qs = bf16(q * scale) in place; S = qs . k^T on
//      the tensor cores into C fragments (every key of the row, 16 NK of
//      them, in registers), + the key mask's -1e30 terms, the row max and
//      sum of exp(s - max) by quad shuffles, p = bf16(drop(e / l)) with the
//      keep bit hashed once a (t, j) at the head's salt, packed from the C
//      fragments straight into the A fragments of att = p . v (v's rows by
//      ldmatrix.trans; each group of 4 key tiles accumulated in the tensor
//      cores, the groups added by fp32 adds), stored fp32 [B, T, D] as the
//      TPU kernel's residual. A query whose keys are all masked takes the
//      uniform softmax (the -1e30 terms), as the scalar body gives it.
//   3. (mha_proj_tc_kernel, kRes true) the tiles of launch 1 against Wd's
//      columns: z = bf16(drop202(LN2(R))), R = drop201(att) + x formed
//      where it is read (so that a tile fits at every width the block route
//      takes), z . bf16(Wd) on the tensor cores, and in the epilogue out =
//      drop203(. + bd) + R, rounded to x's type.
// What bounds them: the bytes of x, att, qkv and out, and at the served
// shapes each launch's latency (the 12-frame query stream is ~200 frames
// in all); the products take the tensor cores a few hundred cycles a CTA.
constexpr int kTcProjThreads = 256;  // (kernels.py MHA_TC_THREADS)
constexpr int kTcAttnWarps = 8;      // queries a CTA <= 16 of them (kernels.py MHA_TC_ATTN_WARPS)
constexpr int kTcLnValues = 8;       // a lane's values of a row the projections keep in registers

// The projection launches' shared memory for tiles of MR frames and NC
// columns at width D, in bytes (ops/kernels.py _mha_tc_proj_bytes): the
// bf16 operand [MR][tc_stride(Dk)] and the weight's columns
// [Dk][tc_stride(NC)], Dk = D rounded up to 64.
__host__ __device__ inline size_t tc_proj_bytes(int MR, int NC, int D) {
  const int Dk = (D + 63) / 64 * 64;
  return 2 * ((size_t)MR * vsl::tc_stride(Dk) + (size_t)Dk * vsl::tc_stride(NC));
}

// kRes false: qkv [M, N] (N = 3D) = bf16(y . w + bias) for the frames [m0,
// m0 + MR) and the columns [c0, c0 + NC); kRes true: out [M, D] = drop203(z
// . w + bias) + R. M = B T frames, x [M, D] of XT, att [M, D] fp32, w [D,
// N] bf16, gam and beta the LayerNorm's.
template <typename XT, bool kRes>
__global__ void __launch_bounds__(kTcProjThreads)
mha_proj_tc_kernel(const XT* __restrict__ x, const float* __restrict__ att,
                   const float* __restrict__ gam, const float* __restrict__ beta,
                   const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                   vsl::Dropout drop, __nv_bfloat16* __restrict__ qkv, XT* __restrict__ out, int M,
                   int T, int D, int N, int MR, int NC) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  const int m0 = blockIdx.x * MR, c0 = blockIdx.y * NC, mr = min(MR, M - m0);
  const int Dk = (D + 63) / 64 * 64, YST = vsl::tc_stride(Dk), WST = vsl::tc_stride(NC);
  bf16* Y = reinterpret_cast<bf16*>(smem4);
  bf16* Ws = Y + (size_t)MR * YST;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5;
  // w's columns [c0, c0 + NC) of its rows k < Dk by 16-byte cp.async, 0
  // past D and N (D and N are multiples of 8)
  const int q8 = NC / 8;
  for (int i = tid; i < Dk * q8; i += nt) {
    const int k = i / q8, c = 8 * (i - k * q8);
    const bool on = k < D && c0 + c < N;
    vsl::cp_async16(Ws + (size_t)k * WST + c, w + (on ? (size_t)k * N + c0 + c : 0), on);
  }
  vsl::cp_async_commit();
  // the operand's padding: the columns [D, Dk) of every row, the rows [mr, MR)
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < MR * (Dk - D); i += nt) {
    const int r = i / (Dk - D);
    Y[(size_t)r * YST + D + i - r * (Dk - D)] = zero;
  }
  for (int i = tid; i < (MR - mr) * D; i += nt) Y[(size_t)(mr + i / D) * YST + i % D] = zero;
  // y = bf16(drop200(LN1(x))), or z = bf16(drop202(LN2(R))), R =
  // drop201(att) + x: one warp a frame, layer_norm_rows' sums
  const uint32_t s_ln = vsl::site_salt(kRes ? 0x202u : 0x200u), s201 = vsl::site_salt(0x201u);
  const auto src = [&](int m, int t, uint32_t seed, int c) {
    const float v = vsl::to_float(x[(size_t)m * D + c]);
    if constexpr (kRes) return drop.apply(att[(size_t)m * D + c], seed, s201, t, c) + v;
    return v;
  };
  const auto put = [&](int r, int t, uint32_t seed, int c, float n) {
    Y[(size_t)r * YST + c] =
        __float2bfloat16(drop.apply(n * __ldg(gam + c) + __ldg(beta + c), seed, s_ln, t, c));
  };
  for (int r = warp; r < mr; r += nwarps) {
    const int m = m0 + r, b = m / T, t = m - b * T;
    const uint32_t seed = drop.seed(b);
    float s = 0.f, v = 0.f;
    if (D <= 32 * kTcLnValues) {  // the row's values in registers, read once
      float xv[kTcLnValues];
#pragma unroll
      for (int i = 0; i < kTcLnValues; ++i) {
        const int c = lane + 32 * i;
        xv[i] = c < D ? src(m, t, seed, c) : 0.f;
        s += xv[i];
      }
      const float mean = vsl::warp_sum(s) / D;
#pragma unroll
      for (int i = 0; i < kTcLnValues; ++i)
        if (lane + 32 * i < D) v += (xv[i] - mean) * (xv[i] - mean);
      const float inv = rsqrtf(vsl::warp_sum(v) / D + vsl::kLnEps);
#pragma unroll
      for (int i = 0; i < kTcLnValues; ++i)
        if (lane + 32 * i < D) put(r, t, seed, lane + 32 * i, (xv[i] - mean) * inv);
      continue;
    }
    // wider rows than the model's: the same sums, each pass from global memory
    for (int c = lane; c < D; c += 32) s += src(m, t, seed, c);
    const float mean = vsl::warp_sum(s) / D;
    for (int c = lane; c < D; c += 32) {
      const float d = src(m, t, seed, c) - mean;
      v += d * d;
    }
    const float inv = rsqrtf(vsl::warp_sum(v) / D + vsl::kLnEps);
    for (int c = lane; c < D; c += 32) put(r, t, seed, c, (src(m, t, seed, c) - mean) * inv);
  }
  vsl::cp_async_wait<0>();
  __syncthreads();  // the weight's columns landed; the operand written
  const uint32_t s203 = vsl::site_salt(0x203u);
  vsl::tile_mma(Y, YST, (mr + 15) / 16, Ws, WST, NC / 16, Dk,
                [&](int r, int c, float v0, float v1) {
                  const int m = m0 + r, n = c0 + c;
                  if (r >= mr || n >= N) return;  // N even: n < N holds for n + 1 too
                  const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + n));
                  if constexpr (!kRes) {
                    *reinterpret_cast<uint32_t*>(qkv + (size_t)m * N + n) =
                        vsl::pack_bf16(v0 + b2.x, v1 + b2.y);
                  } else {
                    const int b = m / T, t = m - b * T;
                    const uint32_t seed = drop.seed(b);
                    const float o0 = drop.apply(v0 + b2.x, seed, s203, t, n) + src(m, t, seed, n);
                    const float o1 =
                        drop.apply(v1 + b2.y, seed, s203, t, n + 1) + src(m, t, seed, n + 1);
                    out[(size_t)m * D + n] = vsl::from_float<XT>(o0);
                    out[(size_t)m * D + n + 1] = vsl::from_float<XT>(o1);
                  }
                });
}

// The attention's shared memory for NK tiles of 16 keys, W warps of 16
// queries and head dim HD, in bytes (ops/kernels.py _mha_tc_attn_bytes): k
// and v [16 NK][tc_stride(HP)], qs [16 W][tc_stride(HP)] (bf16; HP = HD,
// 16 at head dim 8) and the key mask's terms [16 NK] (fp32).
__host__ __device__ constexpr size_t tc_attn_bytes(int HD, int NK, int W) {
  return 2 * ((size_t)(2 * 16 * NK) + 16 * (size_t)W) * vsl::tc_stride(HD < 16 ? 16 : HD) +
         4 * (16 * (size_t)NK);
}

template <int HD, int NK>
__global__ void __launch_bounds__(32 * kTcAttnWarps)
attn_fwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                   vsl::Dropout drop, float* __restrict__ att, int T, int D, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int HP = HD < 16 ? 16 : HD, SH = vsl::tc_stride(HP), TP = 16 * NK, CH = HD / 8;
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x, QR = nt / 2;  // 16 queries a warp
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TP * SH;
  bf16* Qs = Vs + TP * SH;
  float* negk = reinterpret_cast<float*>(Qs + (size_t)QR * SH);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, tq = lane & 3;
  const size_t D3 = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * D3 + h * HD;
  // the tile's q rows and every key's k row in one commit group, v in a
  // second that lands behind the scores; rows past T zero
  for (int i = tid; i < QR * CH; i += nt) {
    const int j = i / CH, c = (i % CH) * 8, t = q0 + j;
    vsl::cp_async16(Qs + j * SH + c, base + (size_t)(t < T ? t : 0) * D3 + c, t < T);
  }
  for (int i = tid; i < TP * CH; i += nt) {
    const int j = i / CH, c = (i % CH) * 8;
    vsl::cp_async16(Ks + j * SH + c, base + (size_t)(j < T ? j : 0) * D3 + D + c, j < T);
  }
  vsl::cp_async_commit();
  for (int i = tid; i < TP * CH; i += nt) {
    const int j = i / CH, c = (i % CH) * 8;
    vsl::cp_async16(Vs + j * SH + c, base + (size_t)(j < T ? j : 0) * D3 + 2 * D + c, j < T);
  }
  vsl::cp_async_commit();
  if constexpr (HD < 16) {  // head dim 8: q's and k's columns [8, 16) are 0
    for (int j = tid; j < QR + TP; j += nt)
      *reinterpret_cast<uint4*>((j < QR ? Qs + j * SH : Ks + (j - QR) * SH) + 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  for (int j = tid; j < TP; j += nt)
    negk[j] = j < T ? (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue : 0.f;
  vsl::cp_async_wait<1>();
  for (int i = tid; i < QR * CH; i += nt) {  // qs = bf16(q * scale), the chunks this thread copied
    uint4* p = reinterpret_cast<uint4*>(Qs + (i / CH) * SH + (i % CH) * 8);
    uint4 u = *p;
    uint32_t* wv = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wv + k));
      wv[k] = vsl::pack_bf16(f.x * scale, f.y * scale);
    }
    *p = u;
  }
  __syncthreads();
  const int r0 = 16 * warp;
  const bool active = q0 + r0 < T;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  uint32_t pa[NK][4];
  if (active) {
    // S = qs . k^T over HP / 16 k16 steps (at most 4: one chain)
    float sc[2 * NK][4];
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HP / 16; ++ks) {
      uint32_t a[4];
      vsl::ldsm_x4(a, Qs + (r0 + (lane & 15)) * SH + 16 * ks + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 2 * NK; n += 2) {
        uint32_t bb[4];
        vsl::ldsm_x4(bb, Ks + (8 * n + (lane & 7) + ((lane >> 4) << 3)) * SH + 16 * ks +
                             ((lane >> 3) & 1) * 8);
        vsl::mma16(sc[n], a, bb[0], bb[1]);
        vsl::mma16(sc[n + 1], a, bb[2], bb[3]);
      }
    }
    // this lane's queries q0 + r0 + g8 (e < 2) and + 8, keys 8 n + 2 tq + (e & 1)
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * tq + (e & 1);
        sc[n][e] = j < T ? sc[n][e] + negk[j] : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    }
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - mx[e >> 1]);  // 0 past T
        l[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    }
    // p = bf16(drop(e / l)), the keep bit once a (t, j), into the A
    // fragments of key tile ks: n = 2 ks (keys 16 ks + 2 tq, + 1) and 2 ks
    // + 1 (+ 8), rows g8 and g8 + 8 (mma.cuh c_to_a's packing)
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = q0 + r0 + g8 + 8 * u;
        float pd[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * n + 2 * tq + c;
          const bool keep = j < T && t < T && drop.keep(seed, salt, t, j);
          pd[c] = keep ? drop.kept(sc[n][2 * u + c] / l[u]) : 0.f;
        }
        pa[n >> 1][2 * (n & 1) + u] = vsl::pack_bf16(pd[0], pd[1]);
      }
  }
  vsl::cp_async_wait<0>();
  __syncthreads();  // v landed for every thread
  if (!active) return;  // no barrier below
  // att = p . v: each group of 4 key tiles in the tensor cores from zero,
  // the groups added by fp32 adds in order
  float acc[HD / 8][4];
#pragma unroll
  for (int k0 = 0; k0 < NK; k0 += 4) {
    float c[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
    for (int ks = k0; ks < k0 + 4 && ks < NK; ++ks) {
      if constexpr (HD == 8) {
        uint32_t bb[2];
        vsl::ldsm_x2_trans(bb, Vs + (16 * ks + (lane & 15)) * SH);
        vsl::mma16(c[0], pa[ks], bb[0], bb[1]);
      } else {
#pragma unroll
        for (int n = 0; n < HD / 8; n += 2) {
          uint32_t bb[4];
          vsl::ldsm_x4_trans(bb, Vs + (16 * ks + (lane & 15)) * SH + 8 * (n + (lane >> 4)));
          vsl::mma16(c[n], pa[ks], bb[0], bb[1]);
          vsl::mma16(c[n + 1], pa[ks], bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = k0 ? acc[n][e] + c[n][e] : c[n][e];
  }
  float* orow = att + (size_t)b * T * D + h * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = q0 + r0 + g8 + 8 * u;
      if (t < T)
        *reinterpret_cast<float2*>(orow + (size_t)t * D + 8 * n + 2 * tq) =
            make_float2(acc[n][2 * u], acc[n][2 * u + 1]);
    }
}

// The tensor-core attention of B rows and n_heads heads at T <= 16 NK
// keys (NK of 1, 2, 4, 8, 16: the fewest that hold T), W = min(8, ceil(T
// / 16)) warps a CTA.
template <int HD>
cudaError_t launch_attn_fwd_tc(const __nv_bfloat16* qkv, const float* mask, vsl::Dropout drop,
                               float* att, int B, int T, int D, int n_heads,
                               cudaStream_t stream) {
  const int nk = (T + 15) / 16, W = std::min(kTcAttnWarps, nk);
  const dim3 grid((T + 16 * W - 1) / (16 * W), n_heads, B);
  const float scale = vsl::bf16_round_host(vsl::head_scale(HD));
  const auto go = [&](auto kernel, int NK) {
    return vsl::launch_opted(kernel, grid, 32 * W, tc_attn_bytes(HD, NK, W), stream, qkv, mask,
                             drop, att, T, D, scale);
  };
  if (nk <= 1) return go(attn_fwd_tc_kernel<HD, 1>, 1);
  if (nk <= 2) return go(attn_fwd_tc_kernel<HD, 2>, 2);
  if (nk <= 4) return go(attn_fwd_tc_kernel<HD, 4>, 4);
  if (nk <= 8) return go(attn_fwd_tc_kernel<HD, 8>, 8);
  if (nk <= 16) return go(attn_fwd_tc_kernel<HD, 16>, 16);
  return cudaErrorInvalidValue;
}

// --- the bf16 backward on the tensor cores (#10 at bf16, head dims 8-64) ---
// Three launches on ops/kernels.py mha_bwd_bf16_plan, then the partials'
// sum and the two weight products: the TPU kernel's function at bf16
// (_make_mha_block_bwd_kernel, pallas_kernels.py:1762-1858, the custom
// VJP's rounding points listed at the head of this file) with every
// product on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// sums):
//   1. (mha_bwd_out_tc_kernel) a CTA a tile of kTcBwdRows frames of a row:
//      g_dpre = drop203(g), dbd summed from the unrounded g_dpre,
//      bf16(g_dpre) to its workspace (dwd's operand, and this product's A
//      rows); R = drop201(att) + x and LN2's xh and inv; g_z = bf16(g_dpre)
//      . bf16(Wd)^T by mma.cuh tile_mma_bt (A fragments from the tile's
//      bf16 rows, kept in shared memory where they fit beside a slice, B
//      from bf16(Wd)'s rows as they are stored, slices of SN
//      of them by cp.async, each group of 4 k16 steps accumulated in the
//      tensor cores and added by an fp32 add); then, in fp32 as before,
//      drop202, z = bf16(drop202(LN2(R))) to its workspace, the LN2
//      backward, g_res = g + its path, and bf16(drop201(g_res)) = the
//      attention's bf16(g_att) to its workspace.
//   2. (attn_bwd_tc_kernel) a CTA a (row, head) holding every key of the
//      row, k, v, qs = bf16(q * scale) and gh = bf16(g_att) as bf16 rows
//      (head dim 8 padded to a k16 step with zeros): each warp takes query
//      tiles of 16, S = qs . k^T and dP = gh . v^T on the tensor cores, in
//      the C fragments the mask terms, the row max, p = exp(s - max) / l,
//      the keep bit at the head's (t, j), bf16(drop(p)) into P, dP's
//      dropout, D_t = sum_j dP p over the keys (not from att) and
//      bf16(p (dP - D_t)) into dS; then each warp takes (16 rows, 16
//      columns) items of dQ = bf16(dS) . k * scale, dK = bf16(dS)^T . qs
//      and dV = bf16(drop(P))^T . gh (ldmatrix.trans for the transposed
//      operands; each group of 4 k16 steps accumulated in the tensor cores,
//      the groups added by fp32 adds in order), bf16(dq), bf16(dk),
//      bf16(dv) stored straight into dqkvt [B, T, 3D] and the unrounded
//      values summed over the row (the lanes' rows by shuffles, then the
//      row tiles in order) into the row's first tile's dbqkv partials,
//      zeros in its other tiles'. Where P and dS do not both fit (head dims
//      8 and 16 beyond 208 keys), one buffer holds P for dV, then dS, whose
//      scores are computed again (tc_attn_bwd_share).
//   3. (mha_bwd_qkv_tc_kernel) the tiles of launch 1: LN1's xh and inv; g_y
//      = bf16(dqkv) . bf16(Wqkv)^T by tile_mma_bt (A from dqkvt's rows,
//      copied into shared memory where they fit, B from bf16(Wqkv)'s rows
//      in slices); drop200, y = bf16(drop200(LN1(x)))
//      to its workspace, the LN1 backward, dx = bf16(g_res + its path).
// dwd = bf16(z)^T . bf16(g_dpre) and dwqkv = bf16(y)^T . bf16(dqkv) are
// mma.cuh's wgrad_tc over the bf16 workspaces; dgam, dbeta, dbqkv and dbd
// per-tile partials summed in a fixed order. No atomics: two equal calls
// give equal bits. What bounds it: at the served shapes each launch's
// latency (the query stream is ~200 frames in all); the products take the
// tensor cores a few hundred cycles a CTA, the attention 10 T^2 hd FLOPs a
// (row, head).
constexpr int kTcBwdThreads = 256;  // (kernels.py MHA_TC_THREADS)
constexpr int kTcBwdRows = 16;      // frames a per-frame tile (kernels.py MHA_TC_ROWS)
constexpr int kTcBwdAttnWarps = 8;  // (kernels.py MHA_TC_ATTN_WARPS)

// The per-frame launches' shared memory for slices of SN of a weight's rows
// of K values at width D, in bytes (ops/kernels.py _mha_tc_bwd_frames_bytes):
// two fp32 tiles [kTcBwdRows][D] (xh and the product's output) and inv,
// then with a_smem the product's A tile [kTcBwdRows][tc_stride(Kp)] and
// the slice [SN][tc_stride(Kp)] bf16, Kp = K rounded up to 64. Where the A
// tile does not fit beside a slice (D above ~700), the product reads A's
// rows from device memory (L2) a k16 step at a time instead.
__host__ __device__ inline size_t tc_bwd_frames_bytes(int SN, int K, int D, bool a_smem) {
  const int Kp = (K + 63) / 64 * 64;
  return 4 * (2 * (size_t)kTcBwdRows * D + kTcBwdRows) +
         2 * ((a_smem ? kTcBwdRows : 0) + (size_t)SN) * vsl::tc_stride(Kp);
}

// The slice [c0, c0 + SN) of w's rows (K bf16 values each, K % 8 == 0) into
// Ws [SN][ldw] by 16-byte cp.async, rows past D left as they are (their
// outputs are not stored), as one commit group.
__device__ __forceinline__ void load_rows(__nv_bfloat16* Ws, int ldw, const __nv_bfloat16* w,
                                          int c0, int SN, int K, int D) {
  const int q8 = K / 8;
  for (int i = threadIdx.x; i < SN * q8; i += blockDim.x) {
    const int r = i / q8, c = 8 * (i - r * q8);
    if (c0 + r < D) vsl::cp_async16(Ws + (size_t)r * ldw + c, w + (size_t)(c0 + r) * K + c, true);
  }
  vsl::cp_async_commit();
}

// Ws's columns [K, Kp) of its SN rows, never written by a copy, set to 0.
__device__ __forceinline__ void zero_pad_cols(__nv_bfloat16* Ws, int ldw, int SN, int K, int Kp) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < SN * (Kp - K); i += blockDim.x) {
    const int r = i / (Kp - K);
    Ws[(size_t)r * ldw + K + i - r * (Kp - K)] = zero;
  }
}

// 1. g_dpre, dbd, g_z and the LN2 backward for the tile [t0, t0 + 16) of row
// b (part [B * tiles, 8D]; gam, beta LN2's).
__global__ void __launch_bounds__(kTcBwdThreads)
mha_bwd_out_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ att,
                      const float* __restrict__ gam, const float* __restrict__ beta,
                      const __nv_bfloat16* __restrict__ wdb, vsl::Dropout drop,
                      const __nv_bfloat16* __restrict__ g, __nv_bfloat16* gdpre_ws,
                      __nv_bfloat16* __restrict__ z_ws, float* __restrict__ gres_ws,
                      __nv_bfloat16* __restrict__ gatt_ws, float* __restrict__ part, int T, int D,
                      int SN, int a_smem) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, t0 = blockIdx.x * kTcBwdRows, nf = min(kTcBwdRows, T - t0);
  const int nel = nf * D, Kp = (D + 63) / 64 * 64, WST = vsl::tc_stride(Kp);
  float* XH = reinterpret_cast<float*>(smem4);  // R, then its xh
  float* GZ = XH + kTcBwdRows * D;              // g_z, then drop202(g_z)
  float* inv = GZ + kTcBwdRows * D;
  bf16* As = reinterpret_cast<bf16*>(inv + kTcBwdRows);  // bf16(g_dpre) [16][WST] with a_smem
  bf16* Ws = As + (a_smem ? kTcBwdRows * WST : 0);
  const size_t tile = ((size_t)b * T + t0) * D;
  const uint32_t seed = drop.seed(b);
  const uint32_t s201 = vsl::site_salt(0x201u), s202 = vsl::site_salt(0x202u),
                 s203 = vsl::site_salt(0x203u);
  float* pr = part + ((size_t)b * gridDim.x + blockIdx.x) * 8 * D;
  load_rows(Ws, WST, wdb, 0, SN, D, D);  // lands behind the loads and the LN
  zero_pad_cols(Ws, WST, SN, D, Kp);
  for (int i = threadIdx.x; i < nel; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    const bf16 gd = __float2bfloat16(drop.apply(vsl::to_float(g[tile + i]), seed, s203, t0 + r, c));
    gdpre_ws[tile + i] = gd;
    if (a_smem) As[r * WST + c] = gd;
    XH[i] = drop.apply(att[tile + i], seed, s201, t0 + r, c) + vsl::to_float(x[tile + i]);
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < nf; ++t)
      s += drop.apply(vsl::to_float(g[tile + (size_t)t * D + c]), seed, s203, t0 + t, c);
    pr[7 * D + c] = s;  // dbd, of the unrounded g_dpre
  }
  __syncthreads();  // R and the tile's bf16(g_dpre) rows written
  vsl::ln_normalize_rows(XH, XH, inv, nf, D);
  // g_z = bf16(g_dpre) . bf16(Wd)^T, a slice of Wd's rows at a time
  for (int c0 = 0; c0 < D; c0 += SN) {
    if (c0 > 0) load_rows(Ws, WST, wdb, c0, SN, D, D);
    vsl::cp_async_wait<0>();
    __syncthreads();  // the slice landed (and the last one read)
    vsl::tile_mma_bt(a_smem ? As : gdpre_ws + tile, a_smem ? WST : D, nf, D, Ws, WST, SN / 16, Kp,
                     [&](int r, int c, float v0, float v1) {
                       const int n = c0 + c;
                       if (r < nf && n < D)  // D % 8 == 0: n + 1 < D too
                         *reinterpret_cast<float2*>(GZ + (size_t)r * D + n) = make_float2(v0, v1);
                     });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nel; i += blockDim.x) {
    const int t = t0 + i / D, c = i % D;
    GZ[i] = drop.apply(GZ[i], seed, s202, t, c);
    const float z = drop.apply(XH[i] * __ldg(gam + c) + __ldg(beta + c), seed, s202, t, c);
    z_ws[tile + i] = __float2bfloat16(z);
  }
  __syncthreads();
  vsl::ln_backward_rows(  // dgam, dbeta of LN2
      GZ, XH, inv, gam, nf, D, pr + D, pr + 3 * D, [&](int t, int c, float v) {
        const size_t i = tile + (size_t)t * D + c;
        const float gr = vsl::to_float(g[i]) + v;
        gres_ws[i] = gr;
        gatt_ws[i] = __float2bfloat16(drop.apply(gr, seed, s201, t0 + t, c));
      });
}

// 3. g_y and the LN1 backward for the tile [t0, t0 + 16) of row b: dx (part
// as launch 1's; gam, beta LN1's).
__global__ void __launch_bounds__(kTcBwdThreads)
mha_bwd_qkv_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gam,
                      const float* __restrict__ beta, const __nv_bfloat16* __restrict__ wqkvb,
                      vsl::Dropout drop, const __nv_bfloat16* __restrict__ dqkvt,
                      const float* __restrict__ gres_ws, __nv_bfloat16* __restrict__ y_ws,
                      __nv_bfloat16* __restrict__ dx, float* __restrict__ part, int T, int D,
                      int SN, int a_smem) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, t0 = blockIdx.x * kTcBwdRows, nf = min(kTcBwdRows, T - t0);
  const int nel = nf * D, K = 3 * D, Kp = (K + 63) / 64 * 64, WST = vsl::tc_stride(Kp);
  float* XH = reinterpret_cast<float*>(smem4);  // xh of LN1
  float* GY = XH + kTcBwdRows * D;              // g_y, then drop200(g_y)
  float* inv = GY + kTcBwdRows * D;
  bf16* As = reinterpret_cast<bf16*>(inv + kTcBwdRows);  // bf16(dqkv) [16][WST] with a_smem
  bf16* Ws = As + (a_smem ? kTcBwdRows * WST : 0);
  const size_t tile = ((size_t)b * T + t0) * D;
  const uint32_t seed = drop.seed(b), s200 = vsl::site_salt(0x200u);
  float* pr = part + ((size_t)b * gridDim.x + blockIdx.x) * 8 * D;
  if (a_smem)  // the tile's rows of bf16(dqkv), in load_rows' commit group
    for (int i = threadIdx.x; i < nf * (K / 8); i += blockDim.x) {
      const int r = i / (K / 8), c = 8 * (i - r * (K / 8));
      vsl::cp_async16(As + r * WST + c, dqkvt + 3 * tile + (size_t)r * K + c, true);
    }
  load_rows(Ws, WST, wqkvb, 0, SN, K, D);  // lands behind the LN
  zero_pad_cols(Ws, WST, SN, K, Kp);
  vsl::ln_normalize_rows(x + tile, XH, inv, nf, D);
  // g_y = bf16(dqkv) . bf16(Wqkv)^T, a slice of Wqkv's rows at a time
  for (int c0 = 0; c0 < D; c0 += SN) {
    if (c0 > 0) load_rows(Ws, WST, wqkvb, c0, SN, K, D);
    vsl::cp_async_wait<0>();
    __syncthreads();  // the slice landed (and the last one read)
    vsl::tile_mma_bt(a_smem ? As : dqkvt + 3 * tile, a_smem ? WST : K, nf, K, Ws, WST, SN / 16, Kp,
                     [&](int r, int c, float v0, float v1) {
                       const int n = c0 + c;
                       if (r < nf && n < D)
                         *reinterpret_cast<float2*>(GY + (size_t)r * D + n) = make_float2(v0, v1);
                     });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nel; i += blockDim.x) {
    const int t = t0 + i / D, c = i % D;
    GY[i] = drop.apply(GY[i], seed, s200, t, c);
    const float y = drop.apply(XH[i] * __ldg(gam + c) + __ldg(beta + c), seed, s200, t, c);
    y_ws[tile + i] = __float2bfloat16(y);
  }
  __syncthreads();
  vsl::ln_backward_rows(  // dgam, dbeta of LN1
      GY, XH, inv, gam, nf, D, pr, pr + 2 * D, [&](int t, int c, float v) {
        const size_t i = tile + (size_t)t * D + c;
        dx[i] = __float2bfloat16(gres_ws[i] + v);
      });
}

// 2. The attention's shared memory for NK tiles of 16 keys at head dim HD,
// in bytes (ops/kernels.py _mha_tc_attn_bwd_bytes): k, v, qs, gh [16
// NK][tc_stride(HP)] (bf16; HP = HD, 16 at head dim 8), P and dS [16
// NK][tc_stride(16 NK)] (bf16; one buffer for both with share), the mask
// terms [16 NK] and the column sums' row-tile partials [3][NK][HD] (fp32).
__host__ __device__ constexpr size_t tc_attn_bwd_bytes(int HD, int NK, bool share) {
  return 2 * (4 * (size_t)16 * NK * vsl::tc_stride(HD < 16 ? 16 : HD) +
              (share ? 1 : 2) * (size_t)16 * NK * vsl::tc_stride(16 * NK)) +
         4 * (16 * (size_t)NK + 3 * (size_t)NK * HD);
}
// P and dS in one buffer where two do not fit a block (kernels.py
// MAX_SMEM_BYTES)
__host__ __device__ constexpr bool tc_attn_bwd_share(int HD, int NK) {
  return tc_attn_bwd_bytes(HD, NK, false) > 232448;
}
// the most tiles of 16 keys at each head dim: the keys the block route
// gives it (mha_route: T <= 223, 209, 183, 143 at head dims 8-64;
// kernels.py MHA_TC_BWD_KEY_TILES)
__host__ __device__ constexpr int tc_attn_bwd_max_tiles(int HD) {
  return HD == 64 ? 9 : HD == 32 ? 12 : 14;
}

// c[n] = A . B^T for a warp's 16 rows [r0, r0 + 16) of A [.][ld] against
// the 16 NK rows of Bt [.][ld] (B^T row-major), k = HP: its HP / 16 k16
// steps (at most 4, one chain) accumulated in the tensor cores.
template <int NK, int HP>
__device__ __forceinline__ void attn_tc_scores(float (&c)[2 * NK][4], const __nv_bfloat16* A,
                                               const __nv_bfloat16* Bt, int ld, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HP / 16; ++ks) {
    uint32_t a[4];
    vsl::ldsm_x4(a, A + (r0 + (lane & 15)) * ld + 16 * ks + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < 2 * NK; n += 2) {
      uint32_t bb[4];
      vsl::ldsm_x4(bb, Bt + (8 * n + (lane & 7) + ((lane >> 4) << 3)) * ld + 16 * ks +
                           ((lane >> 3) & 1) * 8);
      vsl::mma16(c[n], a, bb[0], bb[1]);
      vsl::mma16(c[n + 1], a, bb[2], bb[3]);
    }
  }
}

template <int HD, int NK>
__global__ void __launch_bounds__(32 * kTcBwdAttnWarps, 1)
attn_bwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                   vsl::Dropout drop, const __nv_bfloat16* __restrict__ gatt,
                   __nv_bfloat16* __restrict__ dqkvt, float* __restrict__ part, int T, int D,
                   int n_heads, int tiles, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int HP = HD < 16 ? 16 : HD, SH = vsl::tc_stride(HP), TP = 16 * NK;
  constexpr int SP = vsl::tc_stride(TP), CH = HD / 8, NT = 32 * kTcBwdAttnWarps;
  constexpr bool kShare = tc_attn_bwd_share(HD, NK);
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TP * SH;
  bf16* Qs = Vs + TP * SH;
  bf16* Gs = Qs + TP * SH;
  bf16* Ps = Gs + TP * SH;
  bf16* DSs = kShare ? Ps : Ps + TP * SP;
  float* negk = reinterpret_cast<float*>(DSs + TP * SP);
  float* colp = negk + TP;  // [3][NK][HD]
  const int b = static_cast<int>(blockIdx.x) / n_heads, h = static_cast<int>(blockIdx.x) % n_heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, tq = lane & 3;
  const size_t D3 = 3 * (size_t)D;
  const bf16* qrow = qkv + (size_t)b * T * D3 + h * HD;
  const bf16* grow = gatt + (size_t)b * T * D + h * HD;
  // q, k, v and gh of every row by cp.async (bf16 as qkv and the g_att
  // workspace hold them), rows past T zero
  for (int i = tid; i < TP * CH; i += NT) {
    const int j = i / CH, c = (i % CH) * 8, r = j < T ? j : 0;
    const bf16* src = qrow + (size_t)r * D3 + c;
    vsl::cp_async16(Qs + j * SH + c, src, j < T);
    vsl::cp_async16(Ks + j * SH + c, src + D, j < T);
    vsl::cp_async16(Vs + j * SH + c, src + 2 * D, j < T);
    vsl::cp_async16(Gs + j * SH + c, grow + (size_t)r * D + c, j < T);
  }
  vsl::cp_async_commit();
  if constexpr (HD < 16) {  // head dim 8: the columns [8, 16) of k, v, qs and gh are 0
    for (int j = tid; j < 4 * TP; j += NT)
      *reinterpret_cast<uint4*>(Ks + (size_t)j * SH + 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int j = tid; j < TP; j += NT)
    negk[j] = j < T ? (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue : 0.f;
  vsl::cp_async_wait<0>();
  for (int i = tid; i < TP * CH; i += NT) {  // qs = bf16(q * scale), the chunks this thread copied
    uint4* p = reinterpret_cast<uint4*>(Qs + (i / CH) * SH + (i % CH) * 8);
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k));
      w[k] = vsl::pack_bf16(f.x * scale, f.y * scale);
    }
    *p = u;
  }
  __syncthreads();
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  // each warp's query tiles: S and dP, the softmax and dropout in the C
  // fragments, bf16(drop(p)) into P and/or bf16(p (dP - D_t)) into dS
  const auto scores = [&](bool put_p, bool put_ds) {
    for (int qt = warp; qt < NK; qt += kTcBwdAttnWarps) {
      const int r0 = 16 * qt;
      float sc[2 * NK][4], dp[2 * NK][4];
      attn_tc_scores<NK, HP>(sc, Qs, Ks, SH, r0);
      attn_tc_scores<NK, HP>(dp, Gs, Vs, SH, r0);
      // this lane's rows r0 + g8 (e < 2) and r0 + g8 + 8, keys 8 n + 2 tq + (e & 1)
      float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * tq + (e & 1);
          sc[n][e] = j < T ? sc[n][e] + negk[j] : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
        mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      }
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = expf(sc[n][e] - mx[e >> 1]);  // 0 past T
          l[e >> 1] += sc[n][e];
        }
      float dt[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
        l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
        l[u] = 1.f / l[u];
      }
      // p, the keep bit once a (t, j), bf16(drop(p)) into P, dP's dropout
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = r0 + g8 + 8 * u;
          float pd[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * u + c, j = 8 * n + 2 * tq + c;
            const float p = sc[n][e] * l[u];
            sc[n][e] = p;
            const bool keep = t < T && j < T && drop.keep(seed, salt, t, j);
            pd[c] = keep ? drop.kept(p) : 0.f;
            dp[n][e] = keep ? drop.kept(dp[n][e]) : 0.f;
            dt[u] = fmaf(dp[n][e], p, dt[u]);
          }
          if (put_p)
            *reinterpret_cast<uint32_t*>(Ps + t * SP + 8 * n + 2 * tq) = vsl::pack_bf16(pd[0], pd[1]);
        }
      if (!put_ds) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        dt[u] += __shfl_xor_sync(0xffffffffu, dt[u], 1);
        dt[u] += __shfl_xor_sync(0xffffffffu, dt[u], 2);
      }
      // bf16(p (dP - D_t)) into dS, 0 on the rows past T
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = r0 + g8 + 8 * u;
          const bool in = t < T;
          *reinterpret_cast<uint32_t*>(DSs + t * SP + 8 * n + 2 * tq) =
              vsl::pack_bf16(in ? sc[n][2 * u] * (dp[n][2 * u] - dt[u]) : 0.f,
                             in ? sc[n][2 * u + 1] * (dp[n][2 * u + 1] - dt[u]) : 0.f);
        }
    }
  };
  // item (which, row tile rt, column block cb) of the three products: dQ
  // rows are queries (k: keys), dK and dV rows keys (k: queries); the
  // head's columns in blocks of 16 (one block of 8 at head dim 8)
  constexpr int NB = HD >= 16 ? HD / 16 : 1, NN = HD >= 16 ? 2 : 1;
  bf16* orow = dqkvt + (size_t)b * T * D3 + h * HD;
  const auto product = [&](int which, int rt, int cb) {
    const bf16* As = which == 2 ? Ps : DSs;
    const bf16* Bs = which == 0 ? Ks : which == 1 ? Qs : Gs;
    const int i = lane >> 3;
    float acc[NN][4];
#pragma unroll
    for (int k0 = 0; k0 < NK; k0 += 4) {
      float c[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
      for (int ks = k0; ks < k0 + 4 && ks < NK; ++ks) {
        uint32_t a[4];
        if (which == 0)
          vsl::ldsm_x4(a, As + (16 * rt + (lane & 15)) * SP + 16 * ks + (lane >> 4) * 8);
        else
          vsl::ldsm_x4_trans(a, As + (16 * ks + (lane & 7) + ((i >> 1) << 3)) * SP + 16 * rt +
                                    ((i & 1) << 3));
        if constexpr (HD == 8) {
          uint32_t bb[2];
          vsl::ldsm_x2_trans(bb, Bs + (16 * ks + (lane & 15)) * SH);
          vsl::mma16(c[0], a, bb[0], bb[1]);
        } else {
          uint32_t bb[4];
          vsl::ldsm_x4_trans(bb, Bs + (16 * ks + (lane & 15)) * SH + 16 * cb + 8 * (lane >> 4));
          vsl::mma16(c[0], a, bb[0], bb[1]);
          vsl::mma16(c[NN - 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = k0 == 0 ? c[n][e] : acc[n][e] + c[n][e];
    }
    const float f = which == 0 ? scale : 1.f;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = 16 * cb + 8 * n + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = 16 * rt + g8 + 8 * u;
        if (t < T)
          *reinterpret_cast<uint32_t*>(orow + (size_t)t * D3 + which * D + col) =
              vsl::pack_bf16(acc[n][2 * u], acc[n][2 * u + 1]);
      }
      // the unrounded sums over the tile's rows (those past T hold zeros:
      // dS and drop(P) are 0 there)
      float cs[2] = {acc[n][0] + acc[n][2], acc[n][1] + acc[n][3]};
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u) cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], off);
      if (g8 == 0)
        *reinterpret_cast<float2*>(colp + (which * NK + rt) * HD + col) = make_float2(cs[0], cs[1]);
    }
  };
  const auto products = [&](int w0, int w1) {  // the items of products w0 .. w1 - 1
    for (int it = warp; it < (w1 - w0) * NK * NB; it += kTcBwdAttnWarps)
      product(w0 + it / (NK * NB), it / NB % NK, it % NB);
  };
  if constexpr (kShare) {  // P for dV, then dS in its place
    scores(true, false);
    __syncthreads();
    products(2, 3);
    __syncthreads();
    scores(false, true);
    __syncthreads();
    products(0, 2);
  } else {
    scores(true, true);
    __syncthreads();
    products(0, 3);
  }
  __syncthreads();
  // dbqkv of the head's columns over the row, the row tiles in order
  float* pr = part + (size_t)b * tiles * 8 * D + 4 * D + h * HD;
  for (int i = tid; i < 3 * HD; i += NT) {
    const int which = i / HD, c = i % HD;
    float s = 0.f;
#pragma unroll
    for (int rt = 0; rt < NK; ++rt) s += colp[(which * NK + rt) * HD + c];
    pr[which * D + c] = s;
    for (int st = 1; st < tiles; ++st) pr[(size_t)st * 8 * D + which * D + c] = 0.f;
  }
}

// The tensor-core attention backward of B rows and n_heads heads at T <=
// 16 NK keys (NK of 1, 2, 4, 8 and tc_attn_bwd_max_tiles(HD)), `tiles`
// per-frame tiles a row (dbqkv's partials go to the first).
template <int HD>
cudaError_t launch_attn_bwd_tc(const __nv_bfloat16* qkv, const float* mask, vsl::Dropout drop,
                               const __nv_bfloat16* gatt, __nv_bfloat16* dqkvt, float* part, int B,
                               int T, int D, int n_heads, int tiles, int NK, cudaStream_t stream) {
  constexpr int kMax = tc_attn_bwd_max_tiles(HD);
  if (T > 16 * NK) return cudaErrorInvalidValue;
  const float scale = vsl::bf16_round_host(vsl::head_scale(HD));
  const auto go = [&](auto kernel, int nk) {
    return vsl::launch_opted(kernel, dim3(B * n_heads), 32 * kTcBwdAttnWarps,
                             tc_attn_bwd_bytes(HD, nk, tc_attn_bwd_share(HD, nk)), stream, qkv,
                             mask, drop, gatt, dqkvt, part, T, D, n_heads, tiles, scale);
  };
  switch (NK) {
    case 1: return go(attn_bwd_tc_kernel<HD, 1>, 1);
    case 2: return go(attn_bwd_tc_kernel<HD, 2>, 2);
    case 4: return go(attn_bwd_tc_kernel<HD, 4>, 4);
    case 8: return go(attn_bwd_tc_kernel<HD, 8>, 8);
    case kMax: return go(attn_bwd_tc_kernel<HD, kMax>, kMax);
    default: return cudaErrorInvalidValue;
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
  cudaError_t err =
      vsl::opt_in_smem(reinterpret_cast<const void*>(fwd_qkv_tile_kernel), smem1);
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

// The bf16 forward (#3 at bf16) on the tensor cores, on mha_fwd_bf16_plan's
// tiles of MR frames, NCQ of Wqkv's and NCD of Wd's columns: x and out [B,
// T, D] in bf16; wqkvb = bf16(Wqkv) [D, 3D] and wdb = bf16(Wd) [D, D] (the
// function's roundings, made once a call), mask and the other weights
// fp32; qkv [B, T, 3D] in bf16 and att [B, T, D] fp32, the backward's
// residuals. Head dims 8-64, D a multiple of 8, T <= 256.
extern "C" int vsl_mha_block_fwd_bf16(const void* x_, const float* mask, const float* gam,
                                      const float* beta, const void* wqkvb, const float* bqkv,
                                      const void* wdb, const float* bd, const float* seeds,
                                      unsigned thresh, float scale, void* qkv_, float* att,
                                      void* out_, int B, int T, int D, int n_heads, int MR,
                                      int NCQ, int NCD, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || T > 256 || D < 8 || D % 8 || n_heads < 1 || D % n_heads || MR < 16 ||
      MR % 16 || NCQ < 16 || NCQ % 16 || NCD < 16 || NCD % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* x = static_cast<const bf16*>(x_);
  bf16* qkv = static_cast<bf16*>(qkv_);
  bf16* out = static_cast<bf16*>(out_);
  const vsl::Dropout drop{seeds, thresh, scale};
  const int M = B * T, tiles = (M + MR - 1) / MR;
  cudaError_t err = vsl::launch_opted(
      mha_proj_tc_kernel<bf16, false>, dim3(tiles, (3 * D + NCQ - 1) / NCQ), kTcProjThreads,
      tc_proj_bytes(MR, NCQ, D), stream, x, static_cast<const float*>(nullptr), gam, beta,
      static_cast<const bf16*>(wqkvb), bqkv, drop, qkv, static_cast<bf16*>(nullptr), M, T, D,
      3 * D, MR, NCQ);
  if (err == cudaSuccess)
    err = vsl::by_head_dim(D / n_heads, [&](auto hd) {
      return launch_attn_fwd_tc<decltype(hd)::value>(qkv, mask, drop, att, B, T, D, n_heads,
                                                     stream);
    });
  if (err == cudaSuccess)
    err = vsl::launch_opted(mha_proj_tc_kernel<bf16, true>, dim3(tiles, (D + NCD - 1) / NCD),
                            kTcProjThreads, tc_proj_bytes(MR, NCD, D), stream, x,
                            static_cast<const float*>(att), gam + D, beta + D,
                            static_cast<const bf16*>(wdb), bd, drop,
                            static_cast<bf16*>(nullptr), out, M, T, D, D, MR, NCD);
  return static_cast<int>(err);
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
  const size_t smem1 = out_tile_floats(F, SK, D) * sizeof(float);
  cudaError_t err = vsl::launch_opted(bwd_out_tile_kernel, grid, kThreads, smem1, stream, x, att,
                                      gam + D, beta + D, wdT, drop, g, z_ws, gdpre_ws, gres_ws,
                                      gatt_ws, part, T, D, F, SK);
  if (err == cudaSuccess)
    err = vsl::by_head_dim(D / n_heads, [&](auto hd) {
      return launch_attention_bwd_tiles<decltype(hd)::value>(
          qkv, qkv + D, qkv + 2 * D, 3 * D, mask, drop, att, gatt_ws, dqkv, dqkv + D,
          dqkv + 2 * D, 3 * D, B, T, D, n_heads, TQ, kThreads, stream);
    });
  const size_t smem3 = qkv_tile_floats(F, SK, D) * sizeof(float);
  if (err == cudaSuccess)
    err = vsl::launch_opted(bwd_qkv_tile_kernel, grid, kThreads, smem3, stream, x, gam, beta,
                            wqkvT, drop, static_cast<const float*>(dqkv),
                            static_cast<const float*>(gres_ws), y_ws, dx, part, T, D, F, SK);
  if (err == cudaSuccess) err = vsl::sum_partials(part, dsmall, 1, B * grid.x, 8 * D, stream);
  if (err == cudaSuccess)
    err = vsl::wgrad(z_ws, gdpre_ws, dwd, gemm_ws, 1, D, D, B * T, splits, stream);
  if (err == cudaSuccess)
    err = vsl::wgrad(y_ws, dqkv, dwqkv, gemm_ws, 1, D, 3 * D, B * T, splits, stream);
  return static_cast<int>(err);
}

// The bf16 backward (#10 at bf16) on the tensor cores, on
// mha_bwd_bf16_plan's tiles of 16 frames a row, slices of SNo of
// bf16(Wd)'s and SNq of bf16(Wqkv)'s rows and the attention's NK tiles of
// 16 keys (a_smem: the per-frame products' A tiles in shared memory): x,
// g and dx [B, T, D] bf16; wqkvb = bf16(Wqkv) [D, 3D], wdb =
// bf16(Wd) [D, D] (the forward's roundings); the bf16 forward's qkv [B, T,
// 3D] (bf16) and att [B, T, D] (fp32); dsmall [8D] (dgam [2, D], dbeta
// [2, D], dbqkv [3D], dbd [D]), dwqkv [D, 3D], dwd [D, D] fp32.
// Workspaces: z, gdpre, gatt, y [B, T, D] bf16 (the weight products'
// operands and the attention's bf16(g_att)); gres [B, T, D] fp32; dqkvt
// [B, T, 3D] bf16 (bf16(dqkv)); part [B * ceil(T / 16), 8D]; gemm_ws
// [splits, D, 3D] (unused when splits == 1). Head dims 8-64, D a multiple
// of 8.
extern "C" int vsl_mha_block_bwd_bf16(const void* x_, const float* mask, const float* gam,
                                      const float* beta, const void* wqkvb_, const void* wdb_,
                                      const float* seeds, unsigned thresh, float scale,
                                      const void* qkv_, const float* att, const void* g_,
                                      void* dx_, float* dsmall, float* dwqkv, float* dwd,
                                      void* z_, void* gdpre_, float* gres, void* gatt_, void* y_,
                                      void* dqkvt_, float* part, float* gemm_ws, int splits,
                                      int B, int T, int D, int n_heads, int SNo, int SNq, int NK,
                                      int a_smem, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || D < 8 || D % 8 || n_heads < 1 || D % n_heads || SNo < 16 || SNo % 16 ||
      SNq < 16 || SNq % 16 || T > 16 * NK)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* g = static_cast<const bf16*>(g_);
  const bf16* wqkvb = static_cast<const bf16*>(wqkvb_);
  const bf16 *z = static_cast<const bf16*>(z_), *y = static_cast<const bf16*>(y_);
  bf16* gdpre = static_cast<bf16*>(gdpre_);
  bf16* gatt = static_cast<bf16*>(gatt_);
  bf16* dqkvt = static_cast<bf16*>(dqkvt_);
  const vsl::Dropout drop{seeds, thresh, scale};
  const int tiles = (T + kTcBwdRows - 1) / kTcBwdRows;
  const dim3 grid(tiles, B);
  // 1. g_dpre, dbd, g_z, the LN2 backward: g_res and bf16(g_att)
  cudaError_t err = vsl::launch_opted(
      mha_bwd_out_tc_kernel, grid, kTcBwdThreads, tc_bwd_frames_bytes(SNo, D, D, a_smem), stream,
      x, att, gam + D, beta + D, static_cast<const bf16*>(wdb_), drop, g, gdpre,
      static_cast<bf16*>(z_), gres, gatt, part, T, D, SNo, a_smem);
  // 2. the attention backward: bf16(dqkv) and dbqkv
  if (err == cudaSuccess)
    err = vsl::by_head_dim(D / n_heads, [&](auto hd) {
      return launch_attn_bwd_tc<decltype(hd)::value>(static_cast<const bf16*>(qkv_), mask, drop,
                                                     gatt, dqkvt, part, B, T, D, n_heads, tiles,
                                                     NK, stream);
    });
  // 3. g_y, the LN1 backward: dx
  if (err == cudaSuccess)
    err = vsl::launch_opted(mha_bwd_qkv_tc_kernel, grid, kTcBwdThreads,
                            tc_bwd_frames_bytes(SNq, 3 * D, D, a_smem), stream, x, gam, beta,
                            wqkvb, drop, static_cast<const bf16*>(dqkvt),
                            static_cast<const float*>(gres), static_cast<bf16*>(y_),
                            static_cast<bf16*>(dx_), part, T, D, SNq, a_smem);
  if (err == cudaSuccess) err = vsl::sum_partials(part, dsmall, 1, B * tiles, 8 * D, stream);
  if (err == cudaSuccess)
    err = vsl::wgrad_tc(z, gdpre, dwd, gemm_ws, 1, D, D, B * T, splits, stream);
  if (err == cudaSuccess)
    err = vsl::wgrad_tc(y, dqkvt, dwqkv, gemm_ws, 1, D, 3 * D, B * T, splits, stream);
  return static_cast<int>(err);
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

namespace {

bool whole_bwd_ok(int B, int T, int D, int n_heads, int TQ, int threads) {
  const int nq = TQ > 0 ? (T + TQ - 1) / TQ : 0;
  return !(B < 1 || T < 1 || n_heads < 1 || D % n_heads || nq < 1 || nq > kMaxCluster ||
           threads < 32 || threads % 32 || threads > kMaxAttnThreads);
}

}  // namespace

extern "C" int vsl_mha_bwd(const float* q, const float* k, const float* v, const float* mask,
                           const float* seeds, unsigned thresh, float scale, const float* out,
                           const float* g, float* dq, float* dk, float* dv, int B, int T, int D,
                           int n_heads, int TQ, int threads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (!whole_bwd_ok(B, T, D, n_heads, TQ, threads)) return static_cast<int>(cudaErrorInvalidValue);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention_bwd_tiles<decltype(hd)::value>(q, k, v, D, mask, drop, out, g, dq,
                                                           dk, dv, D, B, T, D, n_heads, TQ,
                                                           threads, stream);
  }));
}

// The whole-T kernels at bf16 (#11b, #12b; the TPU kernels
// _make_mha_fwd_kernel and _make_mha_bwd_kernel at dtype bf16): q, k, v,
// out, g, dq, dk and dv [B, T, D] in bf16, on the same plans. The forward
// is #3b's attention body (bf16(q_h * bf16 scale), fp32 scores and
// softmax, bf16(drop(p)) . v_h summed in fp32) with its output rounded to
// bf16; the backward #10b's (dV = bf16(drop(P))^T . g, dS = P (dP - sum_j
// dP P) from the keys, dQ = (bf16(dS) . k_h) * bf16 scale, dK = bf16(dS)^T .
// bf16(q_h * scale)) with dq, dk and dv rounded to bf16 once, as stored;
// out is not read.
extern "C" int vsl_mha_fwd_bf16(const void* q, const void* k, const void* v, const float* mask,
                                const float* seeds, unsigned thresh, float scale, void* out,
                                int B, int T, int D, int n_heads, int TQ, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (TQ < 1) return static_cast<int>(cudaErrorInvalidValue);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention_tiles<decltype(hd)::value, true>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), D,
        mask, drop, static_cast<bf16*>(out), D, B, T, n_heads, TQ, stream);
  }));
}

extern "C" int vsl_mha_bwd_bf16(const void* q, const void* k, const void* v, const float* mask,
                                const float* seeds, unsigned thresh, float scale, const void* out,
                                const void* g, void* dq, void* dk, void* dv, int B, int T, int D,
                                int n_heads, int TQ, int threads, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (!whole_bwd_ok(B, T, D, n_heads, TQ, threads)) return static_cast<int>(cudaErrorInvalidValue);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention_bwd_tiles<decltype(hd)::value, true>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), D,
        mask, drop, static_cast<const bf16*>(out), static_cast<const bf16*>(g),
        static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), D, B, T, D,
        n_heads, TQ, threads, stream);
  }));
}

namespace {

// --- the bf16 block at head dim 128 (wide) ------------------------------------
// #3b and #10b at the JAX bench's `saturated` widths (D = 1024 in 8 heads of
// 128; ops/kernels.py mha_wide_plan). The per-frame launches above keep a
// tile's rows and two weight slices in shared memory: at D = 1024 they fit
// 8 frames only with slices of <= 8 rows, and each of B T / 8 CTAs would
// re-read the 6 MB of bf16 weights. So the per-frame launches split at
// their products: the LayerNorms, dropouts, residuals and column sums run
// on warps a frame (the forward) or on strips of S frames a row streamed a
// few frames at a time (the backward, wide_ln_pass_kernel), and the four
// products [B T, D] x [D, 3D], [B T, D] x [D, D] and their transposes run
// over every frame at once on mma.cuh's tc_gemm (wgmma, operands by TMA),
// the bias, rounding, dropout and residual epilogues fused into them, and
// the weight gradients on its wgrad_wg. Both attentions are
// tensor-core kernels of their own, a CTA a (row, head) (attn_fwd_wide_kernel,
// attn_bwd_wide_kernel below). The function, with each rounding point, is
// the bf16 block's (vsl_mha_block_fwd_bf16 / _bwd_bf16 above): y, q, k, v,
// bf16(q scale), drop(p), z rounded; the bias gradients of the unrounded
// gradients, the products and dwd, dwqkv of the rounded ones; att as the
// bf16 forward saves it and qkv, whose values are bf16, stored as bf16.
// What bounds them: the products, 2 B T D 4D FLOPs forward and twice that
// backward plus the weight gradients, on the tensor cores, and the
// attention's bytes (4 T^2 hd FLOPs a (row, head) forward, 10 backward).
using vsl::kWideThreads;
constexpr int kLnRows = 8;         // frames a CTA of the forward's LayerNorm launch, one a warp

// Out [B T, D] = bf16(drop_site(LN(src))) with src = x (kRes false: LN1,
// site 0x200) or drop201(att) + x (kRes: LN2, site 0x202), one warp a
// frame, its row staged in shared memory (kLnRows rows of D floats): the
// LayerNorm of layer_norm_rows, so y and z are the per-frame launches'.
template <typename XT, bool kRes>
__global__ void __launch_bounds__(32 * kLnRows)
wide_ln_kernel(const XT* __restrict__ x, const float* __restrict__ att,
               const float* __restrict__ gam, const float* __restrict__ beta, vsl::Dropout drop,
               __nv_bfloat16* __restrict__ out, int M, int T, int D) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.x * kLnRows + warp;
  if (m >= M) return;  // no block barrier below
  float* r = reinterpret_cast<float*>(smem4) + (size_t)warp * D;
  const int b = m / T, t = m - b * T;
  const uint32_t seed = drop.seed(b);
  const size_t o = (size_t)m * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) {
    float v = vsl::to_float(x[o + c]);
    if (kRes) v = drop.apply(att[o + c], seed, vsl::site_salt(0x201u), t, c) + v;
    r[c] = v;
    s += v;
  }
  const float mean = vsl::warp_sum(s) / D;
  float var = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = r[c] - mean;
    var += d * d;
  }
  const float inv = rsqrtf(vsl::warp_sum(var) / D + vsl::kLnEps);
  const uint32_t salt = vsl::site_salt(kRes ? 0x202u : 0x200u);
  for (int c = lane; c < D; c += 32) {
    const float n = (r[c] - mean) * inv * __ldg(gam + c) + __ldg(beta + c);
    out[o + c] = __float2bfloat16(drop.apply(n, seed, salt, t, c));
  }
}

// qkv = bf16(y . bf16(Wqkv) + bqkv), stored as bf16: the attention reads
// it, and the backward as the forward's residual.
struct QkvEpi {
  __nv_bfloat16* qkv;
  const float* bqkv;
  int M, N;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    if (m >= M) return;
    *reinterpret_cast<uint32_t*>(qkv + (size_t)m * N + n) =
        vsl::pack_bf16(v0 + __ldg(bqkv + n), v1 + __ldg(bqkv + n + 1));
  }
};

// out = drop203(z . bf16(Wd) + bd) + R, R = drop201(att) + x.
template <typename XT>
struct DenseEpi {
  const XT* x;
  const float* att;
  const float* bd;
  XT* out;
  vsl::Dropout drop;
  int M, T, D;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    if (m >= M) return;
    const int b = m / T, t = m - b * T;
    const uint32_t seed = drop.seed(b);
    const uint32_t s201 = vsl::site_salt(0x201u), s203 = vsl::site_salt(0x203u);
    const size_t i = (size_t)m * D + n;
    const float v[2] = {v0, v1};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float res = drop.apply(att[i + q], seed, s201, t, n + q) + vsl::to_float(x[i + q]);
      const float o = drop.apply(v[q] + __ldg(bd + n + q), seed, s203, t, n + q);
      out[i + q] = vsl::from_float<XT>(o + res);
    }
  }
};

// g_dpre = drop203(g) rounded to bf16 into gdt [B T, D], and dbd, the
// column sums of the unrounded g_dpre over the strip [s0, s0 + S) of row b,
// into part's slot [7D, 8D) of [B * strips, 8D].
__global__ void __launch_bounds__(kWideThreads)
wide_gdpre_kernel(const __nv_bfloat16* __restrict__ g, vsl::Dropout drop,
                  __nv_bfloat16* __restrict__ gdt, float* __restrict__ part, int T, int D,
                  int S) {
  const int b = blockIdx.y, s0 = blockIdx.x * S, s1 = min(T, s0 + S);
  const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x203u);
  float* pr = part + ((size_t)b * gridDim.x + blockIdx.x) * 8 * D + 7 * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int t = s0; t < s1; ++t) {
      const size_t i = ((size_t)b * T + t) * D + c;
      const float v = drop.apply(__bfloat162float(g[i]), seed, salt, t, c);
      s += v;
      gdt[i] = __float2bfloat16(v);
    }
    pr[c] = s;
  }
}

// 1. after g_z = bf16(g_dpre) . bf16(Wd)^T (gz [B T, D]): the LN2 backward
// (dgam2, dbeta2 over the strip), g_res = g + the LN2 path, g_att =
// drop201(g_res), z = bf16(drop202(LN2(res))) for dwd. 3. (kQkv) after g_y
// = bf16(dqkv) . bf16(Wqkv)^T (gz holds g_y): the LN1 backward (dgam1,
// dbeta1), dx = bf16(g_res + the LN1 path), y = bf16(drop200(LN1(x))) for
// dwqkv. A CTA of D / 4 threads streams the strip [s0, s0 + S) of row b
// as conv_block.cu's backward passes do: each thread 4 columns of every
// frame, kWideLnFrames frames a batch into rings of shared memory that
// only it reads, by cp.async with the next batch in flight, the rows' sums
// by vsl::block_sums; a frame's LayerNorm statistics in the batch it
// lands, its backward (which needs them) a batch later. Rings of 3
// batches: A (att, or with kQkv g_res), X (x, bf16 in the first 8 bytes of
// a thread's 16, then xh), Z (gz), G (g; unused with kQkv).
constexpr int kWideLnFrames = 2;
constexpr int kWideLnMaxThreads = 256;  // D / 4 at D = 1024

// Its shared memory in bytes (ops/kernels.py _mha_wide_ln_bytes): the four
// rings [3 kWideLnFrames][D] and two reductions [D / 128][3 kWideLnFrames].
__host__ __device__ inline size_t wide_ln_pass_bytes(int D) {
  return 4 * (4 * 3 * (size_t)kWideLnFrames * D + 2 * (size_t)(D / 128) * 3 * kWideLnFrames);
}

template <bool kQkv>
__global__ void __launch_bounds__(kWideLnMaxThreads, 2)
wide_ln_pass_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ att,
                    const float* __restrict__ gam, const float* __restrict__ beta,
                    vsl::Dropout drop, const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ gz, float* __restrict__ gres,
                    float* __restrict__ gatt, __nv_bfloat16* __restrict__ zy,
                    __nv_bfloat16* __restrict__ dx, float* __restrict__ part, int T, int D,
                    int S) {
  using vsl::ld4;
  using vsl::st4;
  using vsl::sum4;
  constexpr int F = kWideLnFrames, RL = 3 * F;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, c = 4 * tid, nw = blockDim.x >> 5;
  const int b = blockIdx.y, s0 = blockIdx.x * S, s1 = min(T, s0 + S);
  const int nb = (s1 - s0 + F - 1) / F;
  float* A = reinterpret_cast<float*>(smem4);  // [RL][D]
  float* X = A + (size_t)RL * D;
  float* Z = X + (size_t)RL * D;
  float* G = Z + (size_t)RL * D;
  float* RED = G + (size_t)RL * D;  // [2][nw][3F]
  const size_t row = (size_t)b * T * D;
  const uint32_t seed = drop.seed(b);
  const uint32_t s201 = vsl::site_salt(0x201u), sln = vsl::site_salt(kQkv ? 0x200u : 0x202u);
  const float4 gm = ld4(gam + c), bt = ld4(beta + c);
  const auto at = [&](float* ring, int e) { return ring + (size_t)((e - s0) % RL) * D + c; };
  // batch i's frames (one commit group, empty past the last batch)
  const auto issue = [&](int i) {
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int e = s0 + i * F + k;
      const bool on = i < nb && e < s1;
      const size_t o = row + (size_t)(on ? e : s0) * D + c;
      if (!on) continue;
      vsl::cp_row4(at(X, e), x, o, true, true);
      vsl::cp_row4(at(Z, e), gz, o, false, true);
      if (kQkv) {
        vsl::cp_row4(at(A, e), gres, o, false, true);
      } else {
        vsl::cp_row4(at(A, e), att, o, false, true);
        vsl::cp_row4(at(G, e), g, o, true, true);
      }
    }
    vsl::cp_async_commit();
  };
  const auto apply4 = [&](float4 v, uint32_t salt, int t) {
    return make_float4(drop.apply(v.x, seed, salt, t, c), drop.apply(v.y, seed, salt, t, c + 1),
                       drop.apply(v.z, seed, salt, t, c + 2),
                       drop.apply(v.w, seed, salt, t, c + 3));
  };
  float4 sg = make_float4(0.f, 0.f, 0.f, 0.f), sb = sg;
  float inv_prev[F];
  issue(0);
  for (int i = 0; i <= nb; ++i) {  // batch i's statistics, batch i - 1's backward
    issue(i + 1);
    vsl::cp_async_wait<1>();
    // round 1: the new frames' LayerNorm input and its sums; the previous
    // batch's G = drop(gz), dgam, dbeta and the sums of dxh = G gam, dxh xh
    float4 v[F], gn[F];
    float r1[3 * F], r2[F], inv[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int e = s0 + i * F + k, t = e - F;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nb && e < s1) {
        v[k] = vsl::slot4(at(X, e), true);
        if (!kQkv) {
          const float4 a = apply4(ld4(at(A, e)), s201, e);
          v[k] = make_float4(a.x + v[k].x, a.y + v[k].y, a.z + v[k].z, a.w + v[k].w);
        }
      }
      r1[k] = sum4(v[k]);
      r1[F + 2 * k] = r1[F + 2 * k + 1] = 0.f;
      gn[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i == 0 || t >= s1) continue;
      gn[k] = apply4(ld4(at(Z, t)), sln, t);
      const float4 xh = ld4(at(X, t));
      const float4 dxh = make_float4(gn[k].x * gm.x, gn[k].y * gm.y, gn[k].z * gm.z,
                                     gn[k].w * gm.w);
      r1[F + 2 * k] = sum4(dxh);
      r1[F + 2 * k + 1] = ((dxh.x * xh.x + dxh.y * xh.y) + dxh.z * xh.z) + dxh.w * xh.w;
      sg = vsl::fma4(gn[k], xh, sg);
      sb = make_float4(sb.x + gn[k].x, sb.y + gn[k].y, sb.z + gn[k].z, sb.w + gn[k].w);
    }
    vsl::block_sums<3 * F>(r1, RED);
    // round 2: the new frames' variances; xh into X, the normalised output
    // (z or y) rounded
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const float mean = r1[k] / D;
      v[k] = make_float4(v[k].x - mean, v[k].y - mean, v[k].z - mean, v[k].w - mean);
      r2[k] = ((v[k].x * v[k].x + v[k].y * v[k].y) + v[k].z * v[k].z) + v[k].w * v[k].w;
    }
    vsl::block_sums<F>(r2, RED + nw * 3 * F);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int e = s0 + i * F + k;
      inv[k] = rsqrtf(r2[k] / D + vsl::kLnEps);
      if (i == nb || e >= s1) continue;
      const float4 xh = make_float4(v[k].x * inv[k], v[k].y * inv[k], v[k].z * inv[k],
                                    v[k].w * inv[k]);
      st4(at(X, e), xh);
      const float4 n = make_float4(xh.x * gm.x + bt.x, xh.y * gm.y + bt.y, xh.z * gm.z + bt.z,
                                   xh.w * gm.w + bt.w);
      vsl::st4_bf16(zy + row + (size_t)e * D + c, apply4(n, sln, e));
    }
    // the previous batch's frames: dx_ln = inv (G gam - m1 - xh m2)
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int t = s0 + i * F + k - F;
      if (i == 0 || t >= s1) continue;
      const float m1 = r1[F + 2 * k] / D, m2 = r1[F + 2 * k + 1] / D, r = inv_prev[k];
      const float4 xh = ld4(at(X, t));
      const float4 d = make_float4(r * (gn[k].x * gm.x - m1 - xh.x * m2),
                                   r * (gn[k].y * gm.y - m1 - xh.y * m2),
                                   r * (gn[k].z * gm.z - m1 - xh.z * m2),
                                   r * (gn[k].w * gm.w - m1 - xh.w * m2));
      const size_t o = row + (size_t)t * D + c;
      if constexpr (kQkv) {
        const float4 gr = ld4(at(A, t));
        vsl::st4_bf16(dx + o, make_float4(gr.x + d.x, gr.y + d.y, gr.z + d.z, gr.w + d.w));
      } else {
        const float4 g4 = vsl::slot4(at(G, t), true);
        const float4 gr = make_float4(g4.x + d.x, g4.y + d.y, g4.z + d.z, g4.w + d.w);
        st4(gres + o, gr);
        st4(gatt + o, apply4(gr, s201, t));
      }
    }
#pragma unroll
    for (int k = 0; k < F; ++k) inv_prev[k] = inv[k];
  }
  float* pr = part + ((size_t)b * gridDim.x + blockIdx.x) * 8 * D;
  st4(pr + (kQkv ? 0 : D) + c, sg);  // dgam [2D], dbeta [2D]: LN1 first
  st4(pr + (kQkv ? 2 * D : 3 * D) + c, sb);
}

// 2. (wide) the attention backward at head dim 128 on the tensor cores, one
// CTA of kAttnWideWarps warps a (row, head), no cluster: T <= 16 NK keys
// (NK tiles of 16, ops/kernels.py mha_wide_plan's attn_tiles) whole in
// shared memory as bf16 rows at tc_stride(128): k, v, qs = bf16(q * scale)
// and gh = bf16(g_att) (the function's roundings; qkv holds bf16 values),
// rows past T zero. Warp w < NK takes the queries [16 w, 16 w + 16): S =
// qs . k^T and dP = gh . v^T by mma.sync m16n8k16 (mma.cuh), then in the C
// fragments, each row's sums over its four lanes in a fixed order: the
// mask term, the row max, p = exp(s - max) * (1 / l), the keep bit at the
// head's (t, j), bf16(drop(p)) into P [t][j], dP's dropout, D_t = sum_j dP
// p and bf16(p (dP - D_t)) into dS [t][j], as attn_bwd_cluster_kernel's
// kBf16 body has them. Then each warp takes (16 rows, 16 NK columns) of
// the three products, over the keys or queries as k: dQ = bf16(dS) . k *
// scale, dK = bf16(dS)^T . qs, dV = bf16(drop(P))^T . gh (ldmatrix.trans
// for the transposed operands). Its epilogue writes bf16(dq), bf16(dk),
// bf16(dv) straight into dqkvt [B, T, 3D] and sums the unrounded values
// over the row's frames (the lanes' rows by shuffles, then the row tiles
// in order) into strip 0's dbqkv partials of part [B * strips, 8D], zero
// in the row's other strips. No atomics: two equal calls give equal bits.
// What bounds it: its bytes, the bf16 q, k, v and fp32 g_att read once and
// dqkvt written once (10 T^2 hd FLOPs a (row, head) take ~0.04 ms of the
// tensor cores at `saturated`); one 221 KB CTA an SM loads, computes and
// stores in turn.
constexpr int kAttnWideWarps = 8;
constexpr int kAttnWideHd = 128;

// Its shared memory for NK tiles of 16 keys, in bytes (ops/kernels.py
// _mha_wide_attn_bwd_bytes): k, v, qs, gh [16 NK][tc_stride(128)], P and
// dS [16 NK][tc_stride(16 NK)] (bf16), the mask terms [16 NK] and the
// column sums' row-tile partials [3][NK][128] (fp32).
__host__ __device__ constexpr size_t attn_wide_bwd_bytes(int NK) {
  return 2 * (4 * (size_t)16 * NK * vsl::tc_stride(kAttnWideHd) +
              2 * (size_t)16 * NK * vsl::tc_stride(16 * NK)) +
         4 * (16 * (size_t)NK + 3 * (size_t)NK * kAttnWideHd);
}

// acc[n] = A . B over k = 16 NK for a warp: A's rows [16 rt, + 16) from As
// [.][lda] (kTA: A = As^T, As's columns), B's columns [c0, c0 + 16 NK) of
// Bs [k][ldb]. The k16 products accumulate in the tensor cores: over these
// few steps (8 at T = 128) their sums differ from fp32 adds no more than
// another order of fp32 sums does (mma.cuh's kAdd, the fp32 adds that the
// flash backward's 64-step chains need, cost this kernel a third of its
// time).
template <int NK, bool kTA>
__device__ __forceinline__ void attn_wide_product(float (&acc)[2 * NK][4],
                                                  const __nv_bfloat16* As, int lda,
                                                  const __nv_bfloat16* Bs, int ldb, int rt, int c0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    uint32_t a[4];
    if constexpr (kTA)
      vsl::ldsm_x4_trans(a, As + (16 * ks + (lane & 7) + ((i >> 1) << 3)) * lda + 16 * rt +
                                ((i & 1) << 3));
    else
      vsl::ldsm_x4(a, As + (16 * rt + (lane & 15)) * lda + 16 * ks + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < 2 * NK; n += 2) {
      uint32_t bb[4];
      vsl::ldsm_x4_trans(bb, Bs + (16 * ks + (lane & 15)) * ldb + c0 + 8 * (n + (lane >> 4)));
      vsl::mma16(acc[n], a, bb[0], bb[1]);
      vsl::mma16(acc[n + 1], a, bb[2], bb[3]);
    }
  }
}

// c[n] = A . B^T for a warp's 16 rows [r0, r0 + 16) of A [.][ld] against
// the rows [k0, k0 + 16 NP) of Bt [.][ld] (B^T row-major), k = 128,
// accumulated in the tensor cores as attn_wide_product's.
template <int NP>
__device__ __forceinline__ void attn_wide_scores(float (&c)[2 * NP][4], const __nv_bfloat16* A,
                                                 const __nv_bfloat16* Bt, int ld, int r0,
                                                 int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kAttnWideHd / 16; ++ks) {
    uint32_t a[4];
    vsl::ldsm_x4(a, A + (r0 + (lane & 15)) * ld + 16 * ks + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < 2 * NP; n += 2) {
      uint32_t bb[4];
      vsl::ldsm_x4(bb, Bt + (k0 + 8 * n + (lane & 7) + ((lane >> 4) << 3)) * ld + 16 * ks +
                           ((lane >> 3) & 1) * 8);
      vsl::mma16(c[n], a, bb[0], bb[1]);
      vsl::mma16(c[n + 1], a, bb[2], bb[3]);
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(32 * kAttnWideWarps, 1)
attn_bwd_wide_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                     vsl::Dropout drop, const float* __restrict__ gatt,
                     __nv_bfloat16* __restrict__ dqkvt, float* __restrict__ part, int T, int D,
                     int n_heads, int strips, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int HD = kAttnWideHd, TP = 16 * NK, SH = vsl::tc_stride(HD), SP = vsl::tc_stride(TP);
  constexpr int NT = 32 * kAttnWideWarps, CW = 16 * NK;  // CW: a product item's columns
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TP * SH;
  bf16* Qs = Vs + TP * SH;
  bf16* Gs = Qs + TP * SH;
  bf16* Ps = Gs + TP * SH;
  bf16* DSs = Ps + TP * SP;
  float* negk = reinterpret_cast<float*>(DSs + TP * SP);
  float* colp = negk + TP;  // [3][NK][HD]
  const int b = static_cast<int>(blockIdx.x) / n_heads, h = static_cast<int>(blockIdx.x) % n_heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, tq = lane & 3;
  const size_t D3 = 3 * (size_t)D;
  const bf16* qrow = qkv + (size_t)b * T * D3 + h * HD;
  const float* grow = gatt + (size_t)b * T * D + h * HD;
  // k, v, qs, gh 8 columns a thread a round by 16-byte loads (q, k and v
  // bf16 as qkv holds them, g_att fp32) in NK rounds of the CTA's threads,
  // up to 4 rounds' loads (20 a thread) issued before their stores
  constexpr int CH = HD / 8, kRounds = TP * CH / NT, kBatch = kRounds < 4 ? kRounds : 4;
#pragma unroll 1
  for (int r0 = 0; r0 < kRounds; r0 += kBatch) {
    uint4 q8[kBatch], k8[kBatch], v8[kBatch];
    float4 g8a[kBatch], g8b[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = (r0 + u) * NT + tid, j = i / CH, c = (i % CH) * 8;
      q8[u] = k8[u] = v8[u] = make_uint4(0u, 0u, 0u, 0u);
      g8a[u] = g8b[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < T) {
        const bf16* r = qrow + (size_t)j * D3 + c;
        q8[u] = *reinterpret_cast<const uint4*>(r);
        k8[u] = *reinterpret_cast<const uint4*>(r + D);
        v8[u] = *reinterpret_cast<const uint4*>(r + 2 * D);
        g8a[u] = *reinterpret_cast<const float4*>(grow + (size_t)j * D + c);
        g8b[u] = *reinterpret_cast<const float4*>(grow + (size_t)j * D + c + 4);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = (r0 + u) * NT + tid, j = i / CH, c = (i % CH) * 8;
      uint32_t* w = reinterpret_cast<uint32_t*>(&q8[u]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // qs = bf16(q * scale)
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k));
        w[k] = vsl::pack_bf16(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(Ks + j * SH + c) = k8[u];  // bf16 values as they are
      *reinterpret_cast<uint4*>(Vs + j * SH + c) = v8[u];
      *reinterpret_cast<uint4*>(Qs + j * SH + c) = q8[u];
      *reinterpret_cast<uint4*>(Gs + j * SH + c) =
          make_uint4(vsl::pack_bf16(g8a[u].x, g8a[u].y), vsl::pack_bf16(g8a[u].z, g8a[u].w),
                     vsl::pack_bf16(g8b[u].x, g8b[u].y), vsl::pack_bf16(g8b[u].z, g8b[u].w));
    }
  }
  for (int j = tid; j < TP; j += NT)
    negk[j] = j < T ? (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue : 0.f;
  __syncthreads();
  if (warp < NK) {
    const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
    const int r0 = 16 * warp;
    float sc[2 * NK][4], dp[2 * NK][4];
    attn_wide_scores<NK>(sc, Qs, Ks, SH, r0, 0);
    attn_wide_scores<NK>(dp, Gs, Vs, SH, r0, 0);
    // this lane's rows r0 + g8 (e < 2) and r0 + g8 + 8, columns 8 n + 2 tq + (e & 1)
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * tq + (e & 1);
        sc[n][e] = j < T ? sc[n][e] + negk[j] : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    }
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - mx[e >> 1]);  // 0 past T
        l[e >> 1] += sc[n][e];
      }
    float dt[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
      l[u] = 1.f / l[u];
    }
    // p, the keep bit once a (t, j), bf16(drop(p)) into P, dP's dropout
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = r0 + g8 + 8 * u;
        float pd[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * u + c, j = 8 * n + 2 * tq + c;
          const float p = sc[n][e] * l[u];
          sc[n][e] = p;
          const bool kp = t < T && j < T && drop.keep(seed, salt, t, j);
          pd[c] = kp ? drop.kept(p) : 0.f;
          dp[n][e] = kp ? drop.kept(dp[n][e]) : 0.f;
          dt[u] = fmaf(dp[n][e], p, dt[u]);
        }
        *reinterpret_cast<uint32_t*>(Ps + t * SP + 8 * n + 2 * tq) = vsl::pack_bf16(pd[0], pd[1]);
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      dt[u] += __shfl_xor_sync(0xffffffffu, dt[u], 1);
      dt[u] += __shfl_xor_sync(0xffffffffu, dt[u], 2);
    }
    // bf16(p (dP - D_t)) into dS, 0 on the rows past T
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = r0 + g8 + 8 * u;
        const bool in = t < T;
        *reinterpret_cast<uint32_t*>(DSs + t * SP + 8 * n + 2 * tq) =
            vsl::pack_bf16(in ? sc[n][2 * u] * (dp[n][2 * u] - dt[u]) : 0.f,
                           in ? sc[n][2 * u + 1] * (dp[n][2 * u + 1] - dt[u]) : 0.f);
      }
  }
  __syncthreads();
  // the three products, item (row tile rt, columns [c0, c0 + CW)) a warp:
  // dQ rows are queries (k: keys), dK and dV rows keys (k: queries)
  const int rt = warp % NK, c0 = (warp / NK) * CW;
  bf16* orow = dqkvt + (size_t)b * T * D3 + h * HD;
#pragma unroll 1
  for (int which = 0; which < 3; ++which) {
    float acc[2 * NK][4];
    if (which == 0)
      attn_wide_product<NK, false>(acc, DSs, SP, Ks, SH, rt, c0);
    else if (which == 1)
      attn_wide_product<NK, true>(acc, DSs, SP, Qs, SH, rt, c0);
    else
      attn_wide_product<NK, true>(acc, Ps, SP, Gs, SH, rt, c0);
    const float f = which == 0 ? scale : 1.f;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      float cs[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = 16 * rt + g8 + 8 * u;
        if (t < T)
          *reinterpret_cast<uint32_t*>(orow + (size_t)t * D3 + which * D + c0 + 8 * n + 2 * tq) =
              vsl::pack_bf16(acc[n][2 * u], acc[n][2 * u + 1]);
      }
      // the unrounded sums over the tile's rows (those past T hold zeros:
      // dS and drop(P) are 0 there)
      cs[0] = acc[n][0] + acc[n][2];
      cs[1] = acc[n][1] + acc[n][3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u) cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], off);
      if (g8 == 0)
        *reinterpret_cast<float2*>(colp + (which * NK + rt) * HD + c0 + 8 * n + 2 * tq) =
            make_float2(cs[0], cs[1]);
    }
  }
  __syncthreads();
  // dbqkv of the head's columns over the row, the row tiles in order
  float* pr = part + (size_t)b * strips * 8 * D + 4 * D + h * HD;
  for (int i = tid; i < 3 * HD; i += NT) {
    const int which = i / HD, c = i % HD;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < NK; ++r) s += colp[(which * NK + r) * HD + c];
    pr[which * D + c] = s;
    for (int st = 1; st < strips; ++st) pr[(size_t)st * 8 * D + which * D + c] = 0.f;
  }
}

// The wide attention backward of B rows and n_heads heads at NK tiles of
// 16 keys (T <= 16 NK; NK of 1, 2, 4, 8).
cudaError_t launch_attn_bwd_wide(const __nv_bfloat16* qkv, const float* mask, vsl::Dropout drop,
                                 const float* gatt, __nv_bfloat16* dqkvt, float* part, int B,
                                 int T, int D, int n_heads, int strips, int NK,
                                 cudaStream_t stream) {
  if (T > 16 * NK || D != kAttnWideHd * n_heads) return cudaErrorInvalidValue;
  const float scale = vsl::bf16_round_host(vsl::head_scale(kAttnWideHd));
  const auto go = [&](auto kernel, int nk) {
    return vsl::launch_opted(kernel, dim3(B * n_heads), 32 * kAttnWideWarps,
                             attn_wide_bwd_bytes(nk), stream, qkv, mask, drop, gatt, dqkvt, part,
                             T, D, n_heads, strips, scale);
  };
  switch (NK) {
    case 1: return go(attn_bwd_wide_kernel<1>, 1);
    case 2: return go(attn_bwd_wide_kernel<2>, 2);
    case 4: return go(attn_bwd_wide_kernel<4>, 4);
    case 8: return go(attn_bwd_wide_kernel<8>, 8);
    default: return cudaErrorInvalidValue;
  }
}

// 2. (wide) the attention forward at head dim 128 on the tensor cores, a
// CTA of kAttnWideWarps warps a (row, head) as attn_bwd_wide_kernel's: T <=
// 16 NK keys (mha_wide_plan's attn_tiles), k, v and qs = bf16(q * scale)
// whole in shared memory as bf16 rows at tc_stride(128), rows past T zero:
// every row by cp.async as qkv holds it (q scaled and rounded in place by
// the thread that copied it), v in a commit group of its own that lands
// while the scores are computed. Warp w < NK takes the
// queries [16 w, 16 w + 16): S = qs . k^T by mma.sync m16n8k16 (the k16
// steps accumulated in the tensor cores, as attn_wide_scores does), then
// in the C fragments, each row's sums over its four lanes in a fixed
// order: the mask term (a key past T scores -inf, so it adds nothing to
// l, and a query whose keys are all masked takes p = 1/T, as the scalar
// body's -1e30 terms give it), the row max, e = exp(s - max), l = sum e,
// the keep bit hashed once a (t, j) at the head's salt, p = bf16(drop(e /
// l)) packed from the C fragments straight into the A fragments of att =
// p . v (m16n8k16, v's rows by ldmatrix.trans), stored fp32 [B, T, D].
// The function, rounding for rounding, is the bf16 block's attention
// (attn_fwd_tile_kernel<HD, true> at head dims 8-64). What bounds it: its
// bytes, qkv read once in bf16 and att written once in fp32 (4 T^2 hd
// FLOPs a (row, head) take ~0.02 ms of the tensor cores at `saturated`);
// two ~103 KB CTAs share an SM, so one's loads overlap the other's work.
// Its shared memory for NK tiles of 16 keys, in bytes (ops/kernels.py
// _mha_wide_attn_fwd_bytes): k, v, qs [16 NK][tc_stride(128)] (bf16) and
// the mask terms [16 NK] (fp32).
__host__ __device__ constexpr size_t attn_wide_fwd_bytes(int NK) {
  return 2 * (3 * (size_t)16 * NK * vsl::tc_stride(kAttnWideHd)) + 4 * (16 * (size_t)NK);
}

template <int NK>
__global__ void __launch_bounds__(32 * kAttnWideWarps, 2)
attn_fwd_wide_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                     vsl::Dropout drop, float* __restrict__ att, int T, int D, int n_heads,
                     float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int HD = kAttnWideHd, TP = 16 * NK, SH = vsl::tc_stride(HD);
  constexpr int NT = 32 * kAttnWideWarps, CH = HD / 8;  // CH: 16-byte chunks a row
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TP * SH;
  bf16* Qs = Vs + TP * SH;
  float* negk = reinterpret_cast<float*>(Qs + TP * SH);
  const int b = static_cast<int>(blockIdx.x) / n_heads, h = static_cast<int>(blockIdx.x) % n_heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, tq = lane & 3;
  const size_t D3 = 3 * (size_t)D;
  const bf16* qrow = qkv + (size_t)b * T * D3 + h * HD;
  // every row by cp.async as qkv holds it, rows past T zero: q and k in
  // one commit group, v in a second that lands behind the scores
  const auto copy = [&](bf16* dst, int part) {
    for (int i = tid; i < TP * CH; i += NT) {
      const int j = i / CH, c = (i % CH) * 8;
      vsl::cp_async16(dst + j * SH + c, qrow + (size_t)(j < T ? j : 0) * D3 + part * D + c, j < T);
    }
  };
  copy(Qs, 0);
  copy(Ks, 1);
  vsl::cp_async_commit();
  copy(Vs, 2);
  vsl::cp_async_commit();
  for (int j = tid; j < TP; j += NT)
    negk[j] = j < T ? (1.f - mask[(size_t)b * T + j]) * vsl::kMaskValue : 0.f;
  vsl::cp_async_wait<1>();
  for (int i = tid; i < TP * CH; i += NT) {  // qs = bf16(q * scale), the chunks this thread copied
    uint4* p = reinterpret_cast<uint4*>(Qs + (i / CH) * SH + (i % CH) * 8);
    uint4 u = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k));
      w[k] = vsl::pack_bf16(f.x * scale, f.y * scale);
    }
    *p = u;
  }
  __syncthreads();
  // warp w < NK takes the queries [16 w, 16 w + 16); the others only wait
  // at the barrier before the product
  const int r0 = 16 * warp;
  const bool active = warp < NK && r0 < T;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  uint32_t pa[NK][4];
  if (active) {
    float sc[2 * NK][4];
    attn_wide_scores<NK>(sc, Qs, Ks, SH, r0, 0);
    // this lane's rows r0 + g8 (e < 2) and r0 + g8 + 8, keys 8 n + 2 tq + (e & 1)
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * tq + (e & 1);
        sc[n][e] = j >= T ? -INFINITY : sc[n][e] + negk[j];
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    }
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - mx[e >> 1]);  // 0 past T
        l[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    }
    // p = bf16(drop(e / l)), the keep bit once a (t, j), into the A
    // fragments of key step ks: n = 2 ks (keys 16 ks + 2 tq, + 1) and 2 ks
    // + 1 (+ 8), rows g8 and g8 + 8 (mma.cuh c_to_a's packing)
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = r0 + g8 + 8 * u;
        float pd[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 8 * n + 2 * tq + c;
          const bool kept = t < T && j < T && drop.keep(seed, salt, t, j);
          pd[c] = kept ? drop.kept(sc[n][2 * u + c] / l[u]) : 0.f;
        }
        pa[n >> 1][2 * (n & 1) + u] = vsl::pack_bf16(pd[0], pd[1]);
      }
  }
  vsl::cp_async_wait<0>();
  __syncthreads();  // v landed for every thread
  if (!active) return;  // no barrier below
  // att = p . v, a half of the head's 128 columns at a time
  float* orow = att + (size_t)b * T * D + h * HD;
#pragma unroll 1
  for (int c0 = 0; c0 < HD; c0 += HD / 2) {
    float acc[HD / 16][4];
#pragma unroll
    for (int n = 0; n < HD / 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
#pragma unroll
      for (int n = 0; n < HD / 16; n += 2) {
        uint32_t bb[4];
        vsl::ldsm_x4_trans(bb, Vs + (16 * ks + (lane & 15)) * SH + c0 + 8 * (n + (lane >> 4)));
        vsl::mma16(acc[n], pa[ks], bb[0], bb[1]);
        vsl::mma16(acc[n + 1], pa[ks], bb[2], bb[3]);
      }
#pragma unroll
    for (int n = 0; n < HD / 16; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = r0 + g8 + 8 * u;
        if (t < T)
          *reinterpret_cast<float2*>(orow + (size_t)t * D + c0 + 8 * n + 2 * tq) =
              make_float2(acc[n][2 * u], acc[n][2 * u + 1]);
      }
  }
}

// The wide attention forward of B rows and n_heads heads at NK tiles of 16
// keys (T <= 16 NK; NK of 1, 2, 4, 8).
cudaError_t launch_attn_fwd_wide(const __nv_bfloat16* qkv, const float* mask, vsl::Dropout drop,
                                 float* att, int B, int T, int D, int n_heads, int NK,
                                 cudaStream_t stream) {
  if (T > 16 * NK || D != kAttnWideHd * n_heads) return cudaErrorInvalidValue;
  const float scale = vsl::bf16_round_host(vsl::head_scale(kAttnWideHd));
  const auto go = [&](auto kernel, int nk) {
    return vsl::launch_opted(kernel, dim3(B * n_heads), 32 * kAttnWideWarps,
                             attn_wide_fwd_bytes(nk), stream, qkv, mask, drop, att, T, D,
                             n_heads, scale);
  };
  switch (NK) {
    case 1: return go(attn_fwd_wide_kernel<1>, 1);
    case 2: return go(attn_fwd_wide_kernel<2>, 2);
    case 4: return go(attn_fwd_wide_kernel<4>, 4);
    case 8: return go(attn_fwd_wide_kernel<8>, 8);
    default: return cudaErrorInvalidValue;
  }
}

bool wide_ok(int B, int T, int D, int n_heads) {
  return B >= 1 && T >= 1 && n_heads >= 1 && D == kAttnWideHd * n_heads &&
         D % vsl::kGemmN == 0 && D / 4 <= kWideLnMaxThreads && T <= 16 * kAttnWideWarps;
}

}  // namespace

// #3b at head dim 128 (mha_wide_plan): x and out [B, T, D] bf16; wqkvb =
// bf16(Wqkv) [D, 3D], wdb = bf16(Wd) [D, D]; qkv [B, T, 3D] bf16 and att
// [B, T, D] fp32, the backward's residuals; y_ws [B, T, D] bf16, the
// products' operand (y, then z). The attention on NK tiles of 16 keys (T
// <= 16 NK).
extern "C" int vsl_mha_block_fwd_wide_bf16(const void* x_, const float* mask, const float* gam,
                                           const float* beta, const void* wqkvb,
                                           const float* bqkv, const void* wdb, const float* bd,
                                           const float* seeds, unsigned thresh, float scale,
                                           void* qkv_, float* att, void* out_, void* y_ws, int B,
                                           int T, int D, int n_heads, int NK, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (!wide_ok(B, T, D, n_heads)) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* x = static_cast<const bf16*>(x_);
  bf16* qkv = static_cast<bf16*>(qkv_);
  bf16* out = static_cast<bf16*>(out_);
  bf16* y = static_cast<bf16*>(y_ws);
  const vsl::Dropout drop{seeds, thresh, scale};
  const int M = B * T;
  const dim3 ln_grid((M + kLnRows - 1) / kLnRows);
  const size_t ln_smem = (size_t)kLnRows * D * sizeof(float);
  cudaError_t err = vsl::launch_opted(wide_ln_kernel<bf16, false>, ln_grid, 32 * kLnRows,
                                      ln_smem, stream, x, static_cast<const float*>(nullptr), gam,
                                      beta, drop, y, M, T, D);
  if (err == cudaSuccess)
    err = vsl::tc_gemm<false>(y, static_cast<const bf16*>(wqkvb), M, 3 * D, D, D, 3 * D,
                              QkvEpi{qkv, bqkv, M, 3 * D}, stream);
  if (err == cudaSuccess)
    err = launch_attn_fwd_wide(qkv, mask, drop, att, B, T, D, n_heads, NK, stream);
  if (err == cudaSuccess)
    err = vsl::launch_opted(wide_ln_kernel<bf16, true>, ln_grid, 32 * kLnRows, ln_smem, stream,
                            x, static_cast<const float*>(att), gam + D, beta + D, drop, y, M, T,
                            D);
  if (err == cudaSuccess)
    err = vsl::tc_gemm<false>(y, static_cast<const bf16*>(wdb), M, D, D, D, D,
                              DenseEpi<bf16>{x, att, bd, out, drop, M, T, D}, stream);
  return static_cast<int>(err);
}

// #10b at head dim 128, from the wide forward's qkv (bf16) and att: x, g and dx
// [B, T, D] bf16; wqkvb, wdb as the forward's; dsmall [8D] (dgam [2, D],
// dbeta [2, D], dbqkv [3D], dbd [D]), dwqkv [D, 3D], dwd [D, D] fp32.
// Workspaces: gdt, z, y [B, T, D] bf16 (bf16(g_dpre), and dwd's and
// dwqkv's operands); gz [B, T, D] fp32 (g_z, then g_y); gres, gatt [B, T,
// D] fp32; dqkvt [B, T, 3D] bf16 (bf16(dqkv), from the attention's
// epilogue); part [B * ceil(T / S), 8D]; gemm_ws [splits, D, 3D] (and
// [splits_d, D, D], dwd's splits). Strips of S frames; the attention on NK
// tiles of 16 keys (T <= 16 NK).
extern "C" int vsl_mha_block_bwd_wide_bf16(
    const void* x_, const float* mask, const float* gam, const float* beta, const void* wqkvb,
    const void* wdb, const float* seeds, unsigned thresh, float scale, const void* qkv,
    const float* att, const void* g_, void* dx_, float* dsmall, float* dwqkv, float* dwd,
    void* gdt_, float* gz, void* z_, float* gres, float* gatt, void* dqkvt_, void* y_,
    float* part, float* gemm_ws, int splits, int splits_d, int B, int T, int D, int n_heads,
    int S, int NK, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (!wide_ok(B, T, D, n_heads) || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* g = static_cast<const bf16*>(g_);
  bf16* dx = static_cast<bf16*>(dx_);
  bf16 *gdt = static_cast<bf16*>(gdt_), *z = static_cast<bf16*>(z_), *y = static_cast<bf16*>(y_);
  bf16* dqkvt = static_cast<bf16*>(dqkvt_);
  const vsl::Dropout drop{seeds, thresh, scale};
  const int M = B * T;
  const dim3 grid((T + S - 1) / S, B);
  const size_t smem = wide_ln_pass_bytes(D);
  // 1. g_dpre = drop203(g) rounded, dbd; g_z; the LN2 backward
  cudaError_t err = vsl::launch_opted(wide_gdpre_kernel, grid, kWideThreads, 0, stream, g, drop,
                                      gdt, part, T, D, S);
  if (err == cudaSuccess)
    err = vsl::tc_gemm<true>(gdt, static_cast<const bf16*>(wdb), M, D, D, D, D,
                             vsl::TcStoreRows{gz, M, D}, stream);
  if (err == cudaSuccess)
    err = vsl::launch_opted(wide_ln_pass_kernel<false>, grid, D / 4, smem, stream, x, att,
                            gam + D, beta + D, drop, g, static_cast<const float*>(gz), gres,
                            gatt, z, static_cast<bf16*>(nullptr), part, T, D, S);
  // 2. the attention backward: bf16(dqkv) and dbqkv
  if (err == cudaSuccess)
    err = launch_attn_bwd_wide(static_cast<const bf16*>(qkv), mask, drop, gatt, dqkvt, part, B,
                               T, D, n_heads, static_cast<int>(grid.x), NK, stream);
  // 3. g_y; the LN1 backward
  if (err == cudaSuccess)
    err = vsl::tc_gemm<true>(dqkvt, static_cast<const bf16*>(wqkvb), M, D, 3 * D, 3 * D, 3 * D,
                             vsl::TcStoreRows{gz, M, D}, stream);
  if (err == cudaSuccess)
    err = vsl::launch_opted(wide_ln_pass_kernel<true>, grid, D / 4, smem, stream, x, att, gam,
                            beta, drop, g, static_cast<const float*>(gz), gres, gatt, y, dx, part,
                            T, D, S);
  if (err == cudaSuccess) err = vsl::sum_partials(part, dsmall, 1, B * grid.x, 8 * D, stream);
  if (err == cudaSuccess)
    err = vsl::wgrad_wg(static_cast<const bf16*>(z), gdt, dwd, gemm_ws, 1, D, D, M, splits_d,
                        stream);
  if (err == cudaSuccess)
    err = vsl::wgrad_wg(static_cast<const bf16*>(y), dqkvt, dwqkv, gemm_ws, 1, D, 3 * D, M, splits,
                        stream);
  return static_cast<int>(err);
}
