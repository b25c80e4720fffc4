// QANet conv block, forward and backward, replacing the TPU kernels
// vslnet_tpu/ops/pallas_kernels.py:_make_conv_block_fwd_kernel and
// _make_conv_block_bwd_kernel (via fused_conv_block).
//
// For l in 0..L-1:  x = x + drop_l(relu(pointwise(depthwise(LN_l(x))) + bp_l))
//   LN: fp32 statistics over D, population variance, eps 1e-6;
//   depthwise: kernel k along T, SAME, zero padding at the sequence ends
//              (not at the mask), dw [L, k, D];
//   pointwise: [D, D] matrix wp [L, D, D] plus bias bp [L, D];
//   drop_l: inverted dropout by the counter hash (hash.cuh), salt 0x100 + l,
//           at (t, o) of the row's [T, D] tile; off when seeds is null.
//
// Forward: all L layers in one launch, a thread-block cluster of N CTAs
// per batch row (plan: ops/kernels.py conv_fwd_plan), CTA r owning the
// frames [r*F, min(T, (r+1)*F)) of the row's residual stream X in shared
// memory for all layers. A layer: n = LN(X) over the own frames into a
// window double-buffered by layer parity, one cluster barrier, the halo of
// the depthwise reach read from the neighbours' windows through
// distributed shared memory, the depthwise product, then the pointwise
// product register-tiled out of shared memory (smem_gemm; the layer's wp
// and taps land by cp.async behind the LN and the barrier), its epilogue
// adding bp, the ReLU, the dropout and the residual in place. One cluster
// barrier a layer and one before exit: a window a layer writes was last
// read by the neighbours two layers before, behind the barrier of the
// layer between. Ragged T (the query stream's max_w) is masked in every
// stage. The arithmetic, in its order, is the backward's replay and the
// T-tiled forward's, so the three give equal bits and equal masks.
//
// Backward: a thread-block cluster of N CTAs per batch row (plan:
// ops/kernels.py conv_plan; 6 CTAs of 22 frames at T = 128, so the card
// holds the 16 rows' clusters at once), CTA r owning the frames
// [r*F, min(T, (r+1)*F)). The TPU kernel keeps every layer's residuals of a
// row in VMEM; here each CTA keeps, for its own frames and for all L
// layers, the layer input x_l, the normalised n_l and a bit each of the
// ReLU's mask (p > 0) and the dropout's keep in shared memory:
//   1. replay: for each layer, n_l = LN(x_l) over the own frames, one
//      cluster barrier, the depthwise output d over the own frames (the
//      halo of the depthwise reach read from the neighbours' n_l through
//      distributed shared memory; d also to the [L, B, T, D] workspace for
//      dwp), the pointwise product, the masks, x_(l+1);
//   2. backward, layers in reverse, G the running gradient: g_p = mask *
//      drop(G) (also to a workspace for dwp); dbp; g_d = g_p . wp^T into a
//      buffer double-buffered by layer parity; one cluster barrier; g_n =
//      the depthwise transpose of g_d (its halo from the neighbours); the
//      column sums ddw, dgam, dbeta; the LN backward, G += dx_ln.
// That is one cluster barrier a layer each way and one before exit: the
// n_l stay in place, and the g_d buffer a layer writes was last read two
// layers before, behind a barrier every CTA has passed since (g_n goes
// into the other parity's buffer for the same reason). Each layer's wp (or
// wp^T) goes into shared memory by cp.async once a phase, behind the LN
// and the depthwise product; the pointwise products are register-tiled
// (smem_gemm, operands from shared memory). dwp = sum over rows of
// d^T . g_p is the deterministic split-K product (common.cuh wgrad); dgam,
// dbeta, dbp and ddw are per-CTA column sums in frame order, summed over
// the CTAs in a fixed order. No atomics.
//
// What bounds them: the pointwise products, 2*T*D*D FLOPs a layer (the
// forward's, the replay's and g_d's a layer in the backward, plus dwp's),
// run on B*N CTAs (128 and 96 at the main path's shape), where
// shared-memory bandwidth of the products, the LN and depthwise passes and
// the cluster barriers split the time (PERF.md has the phases;
// vslnet_torch/bench/conv_plans.py measures them).
//
// These whole-row kernels take T up to 145 at D = 128 (the backward's
// shared memory); the T-tiled kernels further down take any T, one layer
// a launch (ops/kernels.py conv_route picks between them).
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "hash.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct ConvParams {
  const float* gam;   // [L, D]
  const float* beta;  // [L, D]
  const float* dw;    // [L, K, D]
  const float* wp;    // [L, D, D]
  const float* bp;    // [L, D]
  int T, D, L, K;
};

// --- the forward and the backward, a cluster per row ------------------------------

// The forward's shared memory for F frames a CTA and K taps (ops/kernels.py
// conv_fwd_plan reports its size; the launch uses this one), in floats:
//   X   [F][D]     the residual stream over the own frames
//   NW  [2][H][D]  n_l by layer parity, own frames at rows [pad, pad + F)
//   P   [F][D]     the depthwise output
//   W   [D][D]     the layer's wp
//   DW  [K][D]     the layer's depthwise taps
struct FwdLayout {
  size_t FD, HD;
  __host__ __device__ FwdLayout(int F, int D, int K)
      : FD((size_t)F * D), HD((size_t)(F + K - 1) * D) {}
  __host__ __device__ size_t floats(int D, int K) const {
    return 2 * FD + 2 * HD + (size_t)D * D + (size_t)K * D;
  }
};

// The backward's shared memory for F frames a CTA and K taps (ops/kernels.py
// conv_plan reports its size; the launch uses this one), in floats, with
// H = F + K - 1 the rows of a window (the own frames and the halo of the
// depthwise reach on either side):
//   X   [L][F][D]  each layer's input
//   NW  [L][H][D]  each layer's n_l: own frames at rows [pad, pad + F),
//                  the halo copied from the neighbours, 0 outside [0, T)
//   W   [D][D]     the layer's wp or wp^T
//   G   [F][D]     the running gradient
//   P   [F][D]     the depthwise output (replay), g_p, then xh
//   GW  [2][H][D]  g_d by layer parity: own frames at rows [K-1-pad, ...);
//                  the other parity's first F rows hold g_n
//   DW  [K][D]     the layer's depthwise taps
//   inv [F4]
//   M   [L][F][D/4] bytes: for the columns 4 c4 + q of frame t, bit q of
//                  byte (t, c4) is the ReLU's mask (p > 0), bit 4 + q the
//                  dropout's keep
struct BwdLayout {
  size_t FD, HD, F4, MF;
  __host__ __device__ BwdLayout(int F, int D, int L, int K)
      : FD((size_t)F * D), HD((size_t)(F + K - 1) * D), F4(((size_t)F + 3) / 4 * 4),
        MF(((size_t)L * F * (D / 4) + 15) / 16 * 4) {}
  __host__ __device__ size_t floats(int D, int L, int K) const {
    return L * FD + L * HD + (size_t)D * D + 2 * FD + 2 * HD + (size_t)K * D + F4 + MF;
  }
};

// The backward's product tile (vsl::smem_gemm): 3 rows x 4 columns, the k
// loop unrolled 4 times; at the main path's 22 frames a CTA that is 256
// items, one a thread, and the fastest of the tiles vslnet_torch/bench/
// conv_plans.py times at T = 128 and 12 (PERF.md).
constexpr int kGemmRows = 3;
constexpr int kGemmUnroll = 4;

// The halo rows of a window buf [F + K - 1][D] whose own frames [c0, c0 + nf)
// sit at rows [lo, lo + nf): each row h outside them is frame c0 - lo + h,
// read from the window of the CTA of the cluster that owns it (the same
// offset there), or 0 outside [0, T). Float4s along D, so a remote row is
// one coalesced read.
__device__ void fill_halo(cg::cluster_group& cluster, float* buf, int lo, int c0, int nf, int F,
                          int T, int D, int K) {
  const int D4 = D / 4, H = F + K - 1;
  float4* b4 = reinterpret_cast<float4*>(buf);
  for (int i = threadIdx.x; i < H * D4; i += blockDim.x) {
    const int h = i / D4, c4 = i - h * D4;
    if (h >= lo && h < lo + nf) continue;  // own
    const int t = c0 - lo + h;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      const int r = t / F;
      const float4* src = reinterpret_cast<const float4*>(cluster.map_shared_rank(buf, r));
      v = src[(size_t)(t - r * F + lo) * D4 + c4];
    }
    b4[i] = v;
  }
}

// out[t][c] = sum_j win[t + j][c] * taps[j][c] for the nf own frames: the
// depthwise product over a window (taps in order, as the plain version
// adds them) or its transpose (taps reversed).
template <bool kReversed>
__device__ void window_taps(const float* win, const float* taps, int nf, int D, int K, float* out) {
  for (int i = threadIdx.x; i < nf * D; i += blockDim.x) {
    const int t = i / D, c = i - t * D;
    float acc = 0.f;
#pragma unroll 7
    for (int j = 0; j < K; ++j)
      acc = fmaf(win[(size_t)(t + j) * D + c], taps[(size_t)(kReversed ? K - 1 - j : j) * D + c],
                 acc);
    out[i] = acc;
  }
}

// The forward's product tile: R rows x 4 columns (R = 3 above 16 frames a
// CTA, so that the main path's 22 are 256 items, one a thread; else 2),
// the k loop unrolled 4 times.
template <int R>
__global__ void __launch_bounds__(kThreads)
conv_block_fwd_cluster_kernel(const float* __restrict__ x, ConvParams p, vsl::Dropout drop,
                              float* __restrict__ out, int F) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int T = p.T, D = p.D, K = p.K, pad = (K - 1) / 2;
  const int N = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = static_cast<int>(blockIdx.x) / N;
  const int c0 = rank * F, nf = min(F, T - c0);  // the own frames [c0, c0 + nf)
  const FwdLayout lay(F, D, K);
  float* X = reinterpret_cast<float*>(smem4);
  float* NW = X + lay.FD;
  float* P = NW + 2 * lay.HD;
  float* W = P + lay.FD;
  float* DW = W + (size_t)D * D;
  const size_t own = ((size_t)b * T + c0) * D;
  const uint32_t seed = drop.seed(b);
  const int nel = nf * D;
  for (int i = threadIdx.x; i < nel; i += blockDim.x) X[i] = x[own + i];
  for (int l = 0; l < p.L; ++l) {
    float* NWl = NW + (l & 1) * lay.HD;
    __syncthreads();  // X written; W, DW and P read by the layer before
    vsl::cp_async_floats(DW, p.dw + (size_t)l * K * D, K * D);
    vsl::cp_async_floats(W, p.wp + (size_t)l * D * D, D * D);  // lands behind the LN and depthwise
    vsl::layer_norm_rows(X, NWl + (size_t)pad * D, p.gam + (size_t)l * D,
                         p.beta + (size_t)l * D, nf, D);
    cluster.sync();  // every CTA's n_l, before the halo reads
    fill_halo(cluster, NWl, pad, c0, nf, F, T, D, K);
    vsl::cp_async_wait<1>();
    __syncthreads();
    window_taps<false>(NWl, DW, nf, D, K, P);  // P[t] = sum_j n(t + j - pad) dw[j]
    vsl::cp_async_wait<0>();
    __syncthreads();
    const float* bpl = p.bp + (size_t)l * D;
    const uint32_t salt = vsl::site_salt(0x100u + l);
    vsl::smem_gemm<R, 4>(P, D, nf, D, W, D, D, [&](int t, int o, float4 acc) {
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        X[(size_t)t * D + o + q] +=
            drop.apply(fmaxf(a[q] + __ldg(bpl + o + q), 0.f), seed, salt, c0 + t, o + q);
    });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nel; i += blockDim.x) out[own + i] = X[i];
  cluster.sync();  // no CTA leaves while a neighbour may read its window
}

// Per-CTA partials part [B * N, L, 3 + K, D]: dgam, dbeta, dbp, then ddw [K, D].
__global__ void __launch_bounds__(kThreads)
conv_block_bwd_cluster_kernel(const float* __restrict__ x, ConvParams p,
                              const float* __restrict__ wpT, vsl::Dropout drop,
                              const float* __restrict__ g, float* __restrict__ dx,
                              float* __restrict__ d_ws, float* __restrict__ gp_ws,
                              float* __restrict__ part, int F) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int T = p.T, D = p.D, K = p.K, L = p.L, pad = (K - 1) / 2, gl = K - 1 - pad;
  const int N = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = static_cast<int>(blockIdx.x) / N;
  const int c0 = rank * F, nf = min(F, T - c0);  // the own frames [c0, c0 + nf)
  const BwdLayout lay(F, D, L, K);
  const size_t FD = lay.FD, HD = lay.HD;
  float* X = reinterpret_cast<float*>(smem4);
  float* NW = X + L * FD;
  float* W = NW + L * HD;
  float* G = W + (size_t)D * D;
  float* P = G + FD;
  float* GW = P + FD;
  float* DW = GW + 2 * HD;
  float* inv = DW + (size_t)K * D;
  uint8_t* M = reinterpret_cast<uint8_t*>(inv + lay.F4);
  const int D4 = D / 4, FD4 = F * D4;
  const size_t row = (size_t)b * T * D, own = row + (size_t)c0 * D;
  const size_t layer = (size_t)gridDim.x / N * T * D;  // stride of one layer in the workspaces
  const uint32_t seed = drop.seed(b);
  const int tid = threadIdx.x, nt = blockDim.x, nel = nf * D;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

  // 1. forward replay: each layer's input, n_l window and masks stay in
  // place; d = depthwise(n_l) goes to d_ws for dwp
  for (int i = tid; i < nel; i += nt) X[i] = x[own + i];
  for (int l = 0; l < L; ++l) {
    float* Xl = X + l * FD;
    float* NWl = NW + l * HD;
    uint8_t* Ml = M + l * FD4;
    vsl::cp_async_floats(DW, p.dw + (size_t)l * K * D, K * D);
    vsl::cp_async_floats(W, p.wp + (size_t)l * D * D, D * D);  // lands during the LN and depthwise
    __syncthreads();  // x_l written
    vsl::layer_norm_rows(Xl, NWl + (size_t)pad * D, p.gam + (size_t)l * D,
                         p.beta + (size_t)l * D, nf, D);
    cluster.sync();  // every CTA's n_l, before the halo reads
    fill_halo(cluster, NWl, pad, c0, nf, F, T, D, K);
    vsl::cp_async_wait<1>();
    __syncthreads();
    window_taps<false>(NWl, DW, nf, D, K, P);  // P[t] = sum_j n(t + j - pad) dw[j]
    for (int i = tid; i < nel; i += nt) d_ws[l * layer + own + i] = P[i];  // own writes: no barrier
    vsl::cp_async_wait<0>();
    __syncthreads();
    const float* bpl = p.bp + (size_t)l * D;
    const uint32_t salt = vsl::site_salt(0x100u + l);
    const bool next = l + 1 < L;
    vsl::smem_gemm<kGemmRows, kGemmUnroll>(P, D, nf, D, W, D, D, [&](int t, int o, float4 acc) {
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
      uint32_t bits = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t i = (size_t)t * D + o + q;
        const float pre = a[q] + __ldg(bpl + o + q);
        const bool keep = drop.keep(seed, salt, c0 + t, o + q);
        bits |= ((pre > 0.f ? 1u : 0u) | (keep ? 16u : 0u)) << q;
        if (next) Xl[FD + i] = Xl[i] + (keep ? drop.kept(fmaxf(pre, 0.f)) : 0.f);
      }
      Ml[t * D4 + o / 4] = static_cast<uint8_t>(bits);
    });
    __syncthreads();
  }

  // 2. backward, layer by layer
  for (int i = tid; i < nel; i += nt) G[i] = g[own + i];
  for (int l = L - 1; l >= 0; --l) {
    const float* Xl = X + l * FD;
    const float* NWl = NW + l * HD;
    const uint8_t* Ml = M + l * FD4;
    float* GWl = GW + (l & 1) * HD;
    // g_n's rows: the other parity's g_d (layer l + 1's), which every CTA
    // has read before it arrived at this layer's cluster barrier
    float* GN = GW + ((l + 1) & 1) * HD;
    const float* gam = p.gam + (size_t)l * D;
    float* pr = part + ((size_t)blockIdx.x * L + l) * (3 + K) * D;
    vsl::cp_async_floats(DW, p.dw + (size_t)l * K * D, K * D);  // both land behind the g_p pass
    vsl::cp_async_floats(W, wpT + (size_t)l * D * D, D * D);
    __syncthreads();  // G written
    for (int i = tid; i < nel; i += nt) {  // g_p = mask * drop(G)
      const int t = i / D, c = i - t * D;
      const uint32_t m = Ml[t * D4 + (c >> 2)] >> (c & 3);
      const float gp = (m & 17u) == 17u ? drop.kept(G[i]) : 0.f;
      P[i] = gp;
      gp_ws[l * layer + own + i] = gp;
    }
    vsl::cp_async_wait<0>();
    __syncthreads();
    for (int c = tid; c < D; c += nt) {  // dbp
      float s = 0.f;
      for (int t = 0; t < nf; ++t) s += P[(size_t)t * D + c];
      pr[2 * D + c] = s;
    }
    // g_d = g_p . wp^T
    vsl::smem_gemm<kGemmRows, kGemmUnroll>(P, D, nf, D, W, D, D, [&](int t, int o, float4 acc) {
      *reinterpret_cast<float4*>(GWl + (size_t)(gl + t) * D + o) = acc;
    });
    cluster.sync();  // every CTA's g_d, before the halo reads
    fill_halo(cluster, GWl, gl, c0, nf, F, T, D, K);
    vsl::ln_normalize_rows(Xl, P, inv, nf, D);  // xh into P (g_p is in gp_ws)
    __syncthreads();
    // g_n(t, c) = sum_j g_d(t + pad - j, c) * dw[j, c]
    window_taps<true>(GWl, DW, nf, D, K, GN);
    __syncthreads();
    // column sums over the own frames, each in frame order: ddw[j, c] =
    // sum_t n(t + j - pad, c) g_d(t, c); dgam = sum_t g_n xh; dbeta = sum_t g_n
    for (int i = tid; i < (K + 2) * D; i += nt) {
      const int j = i / D, c = i - j * D;
      float s = 0.f;
      if (j < K) {
#pragma unroll 4
        for (int t = 0; t < nf; ++t)
          s = fmaf(NWl[(size_t)(t + j) * D + c], GWl[(size_t)(gl + t) * D + c], s);
        pr[3 * D + i] = s;
      } else if (j == K) {
#pragma unroll 4
        for (int t = 0; t < nf; ++t) s = fmaf(GN[(size_t)t * D + c], P[(size_t)t * D + c], s);
        pr[c] = s;
      } else {
#pragma unroll 4
        for (int t = 0; t < nf; ++t) s += GN[(size_t)t * D + c];
        pr[D + c] = s;
      }
    }
    // the LN backward, one warp a frame: G += inv * (dxh - mean(dxh) -
    // xh * mean(dxh * xh)), dxh = g_n * gam
    for (int t = warp; t < nf; t += nwarps) {
      const float* gn = GN + (size_t)t * D;
      const float* xh = P + (size_t)t * D;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float dxh = gn[c] * __ldg(gam + c);
        s1 += dxh;
        s2 += dxh * xh[c];
      }
      const float m1 = vsl::warp_sum(s1) / D, m2 = vsl::warp_sum(s2) / D;
      for (int c = lane; c < D; c += 32)
        G[(size_t)t * D + c] += inv[t] * (gn[c] * __ldg(gam + c) - m1 - xh[c] * m2);
    }
  }
  __syncthreads();
  for (int i = tid; i < nel; i += nt) dx[own + i] = G[i];
  cluster.sync();  // no CTA leaves while a neighbour may read its windows
}

ConvParams make_params(const float* gam, const float* beta, const float* dw, const float* wp,
                       const float* bp, int T, int D, int L, int K) {
  return ConvParams{gam, beta, dw, wp, bp, T, D, L, K};
}

// --- T-tiled kernels ------------------------------------------------------------
// Above T = 145 at D = 128 a row's tiles do not fit a cluster's shared
// memory (the whole-row backward keeps every layer's residuals). These
// kernels run one layer a launch on a grid of (T-tiles, B rows), tiles of
// F frames; every dropout coordinate is the frame's index t in the row.
// The forward writes each layer's output to device memory (the inputs of
// layers 1..L-1 go to the workspace xs, which the backward reads back
// instead of replaying the forward).
//
// The forward, on the plan of ops/kernels.py conv_tiled_fwd_plan (tiles of
// F frames, product items of R rows), a CTA taking the F own frames [t0,
// t0 + F) of one row:
//   1. x_l over the own frames and the depthwise reach, (K - 1) / 2 frames
//      before and K / 2 after (0 outside [0, T)), and the taps land by
//      cp.async, wp (its first slice) behind the LayerNorm, which runs
//      in place out of shared memory, a row in registers, two rows a warp
//      at a time (the whole-row forward's sums and expressions);
//   2. d = depthwise(n_l) over the own frames, a register window of taps
//      along each column (taps_rows, the taps in order);
//   3. p = d . wp (smem_gemm_from: one fmaf chain over k in order, wp whole
//      in shared memory, or streamed in slices of SK rows where it does not
//      fit), and in its epilogue + bp, the ReLU, the dropout (salt 0x100 +
//      l) and the residual, x_(l+1) = x_l + drop(relu(p + bp)), float4s.
// That is the whole-row forward's arithmetic in the same order, so the two
// give equal bits, and the backward below replays [p > 0] bit for bit.
//
// The backward walks the layers in reverse, one launch a layer on the plan
// of ops/kernels.py conv_tiled_bwd_plan (tiles of F frames, wp streamed in
// slices of SK rows; SK = D at D = 128), no atomics. A CTA takes the F own
// frames [t0, t0 + F) of one row and everything their gradient needs, so
// that nothing but G crosses a tile's edge:
//   1. x_l over the own frames and 2 (K - 1) more and the taps land by
//      cp.async, wp (its first slice) behind the LayerNorm, which runs out
//      of shared memory: xh and 1/sigma of the own frames, then n_l in
//      place (the forward's layer_norm_rows, row for row, 0 outside
//      [0, T));
//   2. over the E = F + K - 1 frames [t0 - (K - 1 - pad), t0 + F + pad):
//      d = depthwise(n_l) (the forward's chain of taps), the pre-ReLU
//      p = d . wp + bp (smem_gemm, one fmaf chain over k in order: the
//      forward's sum, so p's sign is the forward's) and in its epilogue
//      g_p = [p > 0] * drop(G_in), 0 outside [0, T);
//   3. wp^T into the same buffer behind dbp; g_d = g_p . wp^T over E;
//   4. G_in's own rows into the weight buffer by cp.async behind g_n = the
//      depthwise transpose of g_d over the own frames and ddw; dgam, dbeta,
//      and the LN backward: G_out = G_in + dx_ln.
// G_in is read over E (the neighbours' frames too), so each layer writes
// G_out into the other of two buffers (dx and a workspace, dx last).
// d and g_p of the own frames go to [L, B, T, D] workspaces for dwp's
// split-K product; dgam, dbeta, dbp and ddw to per-(row, tile) partials
// summed in a fixed order.
//
// What bounds them: the pointwise products (2*T*D*D FLOPs a layer, the
// forward's once, the tiled backward's two over E / F of the frames and
// dwp's), register-tiled out of shared memory at R x 4 a thread; bytes are
// each layer's [B, T, D] input and output (and G) through L2/HBM.

// The tiled kernels' CTA: kTiledThreads threads (one CTA an SM at the
// plans' shared memory), product tiles of R rows x 4 columns (the plans'
// product_rows: the backward's 4, or 6 where 4 would leave a second round
// of items; the forward's 2 or 4), the k loop unrolled kTiledUnroll times:
// the fastest of the tiles vslnet_torch/bench/conv_plans.py --tiled times
// at paths L and M and at T = 128 (PERF.md).
constexpr int kTiledThreads = 512;
constexpr int kTiledUnroll = 4;

// out[e][c] = sum over j < K of win[e + j][c] * taps[j][c] for e < rows
// (kRev: win[e + K - 1 - j][c]), each one fmaf chain over j in order, so
// the depthwise output is the forward's bit for bit. A thread takes a
// column and a run of rows, its taps and the last K rows of its column in
// registers: one shared load an output where the loop of taps has 2 K.
template <int K, bool kRev>
__device__ void taps_sliding(const float* win, const float* taps, int rows, int D, float* out) {
  const int parts = max(1, static_cast<int>(blockDim.x) / D);  // threads a column
  const int per = (rows + parts - 1) / parts;
  for (int i = threadIdx.x; i < D * parts; i += blockDim.x) {
    const int c = i % D, e0 = i / D * per, e1 = min(rows, e0 + per);
    float w[K], n[K];
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = taps[j * D + c];
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) n[j] = e0 + j < rows + K - 1 ? win[(e0 + j) * D + c] : 0.f;
    for (int e = e0; e < e1; ++e) {
      n[K - 1] = win[(e + K - 1) * D + c];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) acc = fmaf(kRev ? n[K - 1 - j] : n[j], w[j], acc);
      out[e * D + c] = acc;
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) n[j] = n[j + 1];
    }
  }
}

// out[e][c] = sum over j < K of win[e + j][c] * taps[j][c] for e < rows
// (kRev: win[e + K - 1 - j][c]), each one fmaf chain over j in order: the
// register window of taps_sliding at the model's K = 7, a loop of taps at
// any other K.
template <bool kRev>
__device__ void taps_rows(const float* win, const float* taps, int rows, int D, int K, float* out) {
  if (K == 7) {
    taps_sliding<7, kRev>(win, taps, rows, D, out);
    return;
  }
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const float* n = win + i;  // row e + j of column c is n[j * D]
    const float* w = taps + i % D;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc = fmaf(n[(kRev ? K - 1 - j : j) * D], w[j * D], acc);
    out[i] = acc;
  }
}

// vsl::layer_norm_rows of the rows [0, rows) of X [.][D] in place, for D
// <= 32 kC: the same sums and expressions, so the same bits, with a row's
// values, gam and beta in registers (one shared load and one store an
// element) and two rows a warp at a time, so that their reductions
// overlap.
template <int kC>
__device__ void ln_rows_in_registers(float* X, const float* __restrict__ gam,
                                     const float* __restrict__ beta, int rows, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float g[kC], bt[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = min(lane + 32 * i, D - 1);
    g[i] = __ldg(gam + c);
    bt[i] = __ldg(beta + c);
  }
  for (int r0 = 2 * warp; r0 < rows; r0 += 2 * nwarps) {
    float* x[2] = {X + (size_t)r0 * D, X + (size_t)min(r0 + 1, rows - 1) * D};
    float v[2][kC], mean[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kC; ++i)
        if (lane + 32 * i < D) {
          v[h][i] = x[h][lane + 32 * i];
          s += v[h][i];
        }
      mean[h] = s;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) mean[h] = vsl::warp_sum(mean[h]) / D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kC; ++i)
        if (lane + 32 * i < D) {
          const float d = v[h][i] - mean[h];
          s += d * d;
        }
      inv[h] = s;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(vsl::warp_sum(inv[h]) / D + vsl::kLnEps);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kC; ++i)
        if (lane + 32 * i < D)
          x[h][lane + 32 * i] = (v[h][i] - mean[h]) * inv[h] * g[i] + bt[i];
  }
}

// LayerNorm of the window rows [lo, lo + rows) of W [.][D] in place, n =
// the forward's layer_norm_rows (the same sums and expressions, so the
// same bits), and for the window rows [own, own + nf) also xh [nf][D] and
// inv [nf] as ln_normalize_rows gives them: one warp a row, its
// statistics once.
__device__ void ln_window_rows(float* W, int lo, int rows, int own, int nf,
                               const float* __restrict__ gam, const float* __restrict__ beta,
                               float* xh, float* inv, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int w = lo + warp; w < lo + rows; w += nwarps) {
    float* row = W + w * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += row[c];
    const float mean = vsl::warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float r = rsqrtf(vsl::warp_sum(v) / D + vsl::kLnEps);
    const int t = w - own;
    if (t >= 0 && t < nf) {
      for (int c = lane; c < D; c += 32) xh[t * D + c] = (row[c] - mean) * r;
      if (lane == 0) inv[t] = r;
    }
    for (int c = lane; c < D; c += 32)
      row[c] = (row[c] - mean) * r * __ldg(gam + c) + __ldg(beta + c);
  }
}

// The tiled backward's shared memory for F frames a tile, K taps and
// weight slices of SK rows, in floats (ops/kernels.py conv_tiled_bwd_plan
// reports it; the launch uses this one):
//   N   [F + 2 (K - 1)][D]  n_l over the own frames and both reaches
//   A   [F + K - 1][D]      d, then g_d, over E
//   P   [F + K - 1][D]      g_p over E, then g_n over the own frames
//   XH  [F][D]              xh of the own frames
//   W   [SK][D], or [2][SK][D] where SK < D (slices double-buffered)
//   DW  [K][D]              the layer's taps
//   inv [F4]
struct TiledBwdLayout {
  size_t N, E, F, W, F4;
  __host__ __device__ TiledBwdLayout(int F_, int D, int K, int SK)
      : N((size_t)(F_ + 2 * (K - 1)) * D), E((size_t)(F_ + K - 1) * D), F((size_t)F_ * D),
        W((SK < D ? 2 : 1) * (size_t)SK * D), F4(((size_t)F_ + 3) / 4 * 4) {}
  __host__ __device__ size_t floats(int D, int K) const {
    return N + 2 * E + F + W + (size_t)K * D + F4;
  }
};

// C = A . Wg over rows rows of A [rows][D] and Wg [D][D] in global memory,
// streamed in slices of SK rows through Wb (slice 0 already issued by the
// caller as the last commit group; two buffers where SK < D), each fmaf
// chain continued across the slices (smem_gemm_from), the last slice's
// sums handed to epi(t, o, float4). Ends with a barrier.
template <int R, typename Epi>
__device__ void sliced_product(const float* A, int rows, int D, const float* __restrict__ Wg,
                               float* Wb, int SK, float* C, Epi epi) {
  const int S = D / SK;
  for (int s = 0; s < S; ++s) {
    if (s + 1 < S) {
      vsl::cp_async_floats(Wb + (size_t)((s + 1) & 1) * SK * D, Wg + (size_t)(s + 1) * SK * D,
                           SK * D);
      vsl::cp_async_wait<1>();
    } else {
      vsl::cp_async_wait<0>();
    }
    __syncthreads();  // slice s landed for every thread; C's last slice written
    const bool last = s + 1 == S;
    vsl::smem_gemm_from<R, kTiledUnroll>(
        A + s * SK, D, rows, SK, Wb + (size_t)(s & 1) * SK * D, D, D,
        [&](int t, int o) {
          return s ? *reinterpret_cast<const float4*>(C + (size_t)t * D + o)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        },
        [&](int t, int o, float4 acc) {
          if (last)
            epi(t, o, acc);
          else
            *reinterpret_cast<float4*>(C + (size_t)t * D + o) = acc;
        });
    __syncthreads();  // slice s read before its buffer takes slice s + 2; C written
  }
}

// The tiled forward's shared memory for F frames a tile, K taps and weight
// slices of SK rows, in floats (ops/kernels.py conv_tiled_fwd_plan reports
// it; the launch uses this one):
//   X   [F + K - 1][D]  x_l over the own frames and the depthwise reach,
//                       then n_l in place
//   A   [F][D]          d over the own frames
//   C   [F][D]          the product's sums between slices, where SK < D
//   W   [SK][D], or [2][SK][D] where SK < D (slices double-buffered)
//   DW  [K][D]          the layer's taps
struct TiledFwdLayout {
  size_t X, A, C, W;
  __host__ __device__ TiledFwdLayout(int F, int D, int K, int SK)
      : X((size_t)(F + K - 1) * D), A((size_t)F * D), C(SK < D ? (size_t)F * D : 0),
        W((SK < D ? 2 : 1) * (size_t)SK * D) {}
  __host__ __device__ size_t floats(int D, int K) const { return X + A + C + W + (size_t)K * D; }
};

// One layer of the tiled forward for the tile [t0, t0 + F) of row b: xout =
// xin + drop(relu(depthwise(LN(xin)) . wp + bp)) over the own frames.
template <int R>
__global__ void __launch_bounds__(kTiledThreads, 1)
conv_layer_fwd_tiled_kernel(const float* __restrict__ xin, ConvParams p, int l, vsl::Dropout drop,
                            float* __restrict__ xout, int F, int SK) {
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, K = p.K, pad = (K - 1) / 2;
  const int b = blockIdx.y, t0 = blockIdx.x * F, nf = min(F, T - t0);
  const TiledFwdLayout lay(F, D, K, SK);
  float* X = reinterpret_cast<float*>(smem4);
  float* A = X + lay.X;
  float* C = A + lay.A;
  float* W = C + lay.C;
  float* DW = W + lay.W;
  const size_t row = (size_t)b * T * D;
  const float* bpl = p.bp + (size_t)l * D;
  const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x100u + l);

  // 1. the taps and x_l over [t0 - pad, t0 + nf + K - 1 - pad) (0 outside
  // [0, T)) by cp.async, then wp's first slice, which lands behind the
  // LayerNorm; n_l in place over the frames in [0, T)
  const int h0 = t0 - pad, lo = max(h0, 0), hi = min(h0 + nf + K - 1, T);
  vsl::cp_async_floats(DW, p.dw + (size_t)l * K * D, K * D);
  for (int i = threadIdx.x; i < (nf + K - 1) * D / 4; i += blockDim.x) {
    const int t = h0 + 4 * i / D;
    if (t >= lo && t < hi)
      vsl::cp_async_float4(X + 4 * i, xin + row + (size_t)h0 * D + 4 * i);
    else
      reinterpret_cast<float4*>(X)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  vsl::cp_async_commit();
  vsl::cp_async_floats(W, p.wp + (size_t)l * D * D, SK * D);
  vsl::cp_async_wait<1>();  // the taps and x_l (wp's slice may be in flight)
  __syncthreads();
  float* own = X + (size_t)(lo - h0) * D;
  const float* gam = p.gam + (size_t)l * D;
  const float* beta = p.beta + (size_t)l * D;
  if (D <= 128)
    ln_rows_in_registers<4>(own, gam, beta, hi - lo, D);
  else  // wider rows than the model's: the same sums out of shared memory
    vsl::layer_norm_rows(own, own, gam, beta, hi - lo, D);
  __syncthreads();
  // 2. d over the own frames: A[r] = sum_j n(t0 + r + j - pad) dw[j]
  taps_rows<false>(X, DW, nf, D, K, A);
  // 3. (sliced_product's first barrier orders A's writes before its reads)
  // x_(l+1) = x_l + drop(relu(d . wp + bp)), one float4 of x_l, of bp and
  // of the output an epilogue
  sliced_product<R>(A, nf, D, p.wp + (size_t)l * D * D, W, SK, C, [&](int r, int o, float4 acc) {
    const size_t i = row + (size_t)(t0 + r) * D + o;
    const float4 x4 = __ldg(reinterpret_cast<const float4*>(xin + i));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(bpl + o));
    const float a[4] = {acc.x, acc.y, acc.z, acc.w}, bb[4] = {b4.x, b4.y, b4.z, b4.w};
    float y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      y[q] = drop.apply(fmaxf(a[q] + bb[q], 0.f), seed, salt, t0 + r, o + q);
    *reinterpret_cast<float4*>(xout + i) =
        make_float4(x4.x + y[0], x4.y + y[1], x4.z + y[2], x4.w + y[3]);
  });
}

// One layer of the tiled backward for the tile [t0, t0 + F) of row b:
// G_in -> G_out, d and g_p of the own frames into d_l and gp_l, per-(row,
// tile) partials part [B * tiles, L, 3 + K, D] (dgam, dbeta, dbp, ddw [K,
// D]) as the whole-row backward's per-CTA ones.
template <int R>
__global__ void __launch_bounds__(kTiledThreads, 1)
conv_layer_bwd_tiled_kernel(const float* __restrict__ xin, ConvParams p, int l,
                            const float* __restrict__ wpT, vsl::Dropout drop,
                            const float* __restrict__ Gin, float* __restrict__ Gout,
                            float* __restrict__ d_l, float* __restrict__ gp_l,
                            float* __restrict__ part, int F, int SK) {
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, K = p.K, pad = (K - 1) / 2, gl = K - 1 - pad;
  const int b = blockIdx.y, t0 = blockIdx.x * F, nf = min(F, T - t0);
  const int ne = nf + K - 1;  // E: frames [t0 - gl, t0 + nf + pad)
  const int e0 = t0 - gl;
  const TiledBwdLayout lay(F, D, K, SK);
  float* N = reinterpret_cast<float*>(smem4);
  float* A = N + lay.N;
  float* P = A + lay.E;
  float* XH = P + lay.E;
  float* W = XH + lay.F;
  float* DW = W + lay.W;
  float* inv = DW + (size_t)K * D;
  const size_t row = (size_t)b * T * D;
  const float* gam = p.gam + (size_t)l * D;
  const float* bpl = p.bp + (size_t)l * D;
  float* pr = part + ((size_t)(b * gridDim.x + blockIdx.x) * p.L + l) * (3 + K) * D;
  const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x100u + l);
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. the taps, x_l over the window [t0 - (K - 1), t0 + nf + K - 1) (0
  // outside [0, T)) and wp's first slice by cp.async; the slice lands
  // behind the LayerNorms, which run out of shared memory
  const int h0 = t0 - (K - 1), lo = max(h0, 0), hi = min(t0 + nf + K - 1, T);
  vsl::cp_async_floats(DW, p.dw + (size_t)l * K * D, K * D);
  for (int i = tid; i < (nf + 2 * (K - 1)) * D / 4; i += nt) {
    const int t = h0 + 4 * i / D;
    if (t >= lo && t < hi)
      vsl::cp_async_float4(N + 4 * i, xin + row + (size_t)h0 * D + 4 * i);
    else
      reinterpret_cast<float4*>(N)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  vsl::cp_async_commit();
  vsl::cp_async_floats(W, p.wp + (size_t)l * D * D, SK * D);
  vsl::cp_async_wait<1>();  // the taps and x_l (wp's slice may be in flight)
  __syncthreads();
  // n_l in place, xh and inv of the own rows
  ln_window_rows(N, lo - h0, hi - lo, K - 1, nf, gam, p.beta + (size_t)l * D, XH, inv, D);
  __syncthreads();
  // 2. d over E, in the forward's order of taps: A[e] = sum_j N[e + j] dw[j]
  taps_rows<false>(N, DW, ne, D, K, A);
  // (sliced_product's first barrier orders A's writes before its reads)
  // p = d . wp + bp, and g_p = [p > 0] * drop(G_in) into P, 0 outside [0, T)
  sliced_product<R>(A, ne, D, p.wp + (size_t)l * D * D, W, SK, P, [&](int e, int o, float4 acc) {
    const int t = e0 + e;
    const bool in = t >= 0 && t < T;
    // one float4 load of G_in and of bp, whatever the masks say
    const float4 g4 = *reinterpret_cast<const float4*>(Gin + row + (size_t)(in ? t : 0) * D + o);
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(bpl + o));
    const float a[4] = {acc.x, acc.y, acc.z, acc.w}, gi[4] = {g4.x, g4.y, g4.z, g4.w};
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
    float gp[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gp[q] = in && a[q] + bb[q] > 0.f ? drop.apply(gi[q], seed, salt, t, o + q) : 0.f;
    const float4 gp4 = make_float4(gp[0], gp[1], gp[2], gp[3]);
    *reinterpret_cast<float4*>(P + (size_t)e * D + o) = gp4;
    if (e >= gl && e < gl + nf)
      *reinterpret_cast<float4*>(gp_l + row + (size_t)t * D + o) = gp4;
  });
  // 3. wp^T's first slice lands behind dbp and d's own rows to d_l
  vsl::cp_async_floats(W, wpT + (size_t)l * D * D, SK * D);
  for (int i = tid; i < nf * D; i += nt) d_l[row + (size_t)t0 * D + i] = A[(size_t)gl * D + i];
  for (int c = tid; c < D; c += nt) {
    float s = 0.f;
    for (int t = 0; t < nf; ++t) s += P[(size_t)(gl + t) * D + c];
    pr[2 * D + c] = s;  // dbp
  }
  // g_d = g_p . wp^T into A (0 outside [0, T), where g_p is)
  sliced_product<R>(P, ne, D, wpT + (size_t)l * D * D, W, SK, A, [&](int e, int o, float4 acc) {
    *reinterpret_cast<float4*>(A + (size_t)e * D + o) = acc;
  });
  // 4. G_in's own rows into the free weight buffer where they fit, landing
  // behind g_n and ddw; g_n(t0 + r) = sum_j g_d(t0 + r + pad - j) dw[j]
  // into P's first rows
  const bool staged = (size_t)nf * D <= lay.W;
  if (staged) vsl::cp_async_floats(W, Gin + row + (size_t)t0 * D, nf * D);
  taps_rows<true>(A, DW, nf, D, K, P);
  __syncthreads();
  // ddw[j, c] = sum over the own frames of n(t + j - pad, c) * g_d(t, c)
  for (int i = tid; i < K * D; i += nt) {
    const int j = i / D, c = i - j * D;
    float s = 0.f;
    for (int r = 0; r < nf; ++r)
      s = fmaf(N[(size_t)(r + j + gl) * D + c], A[(size_t)(r + gl) * D + c], s);
    pr[3 * D + i] = s;
  }
  // the LN backward over the own frames (dgam, dbeta), G_out = G_in + dx_ln
  if (staged) {
    vsl::cp_async_wait<0>();
    __syncthreads();
  }
  vsl::ln_backward_rows(P, XH, inv, gam, nf, D, pr, pr + D, [&](int r, int c, float v) {
    const size_t i = (size_t)r * D + c;
    Gout[row + (size_t)t0 * D + i] = (staged ? W[i] : Gin[row + (size_t)t0 * D + i]) + v;
  });
}

int tiles(int T, int F) { return (T + F - 1) / F; }

}  // namespace

// The forward on conv_fwd_plan's N CTAs a row, F frames a CTA (N = ceil(T /
// F) <= 8).
extern "C" int vsl_conv_block_fwd(const float* x, const float* gam, const float* beta,
                                  const float* dw, const float* wp, const float* bp,
                                  const float* seeds, unsigned thresh, float scale, float* out,
                                  int B, int T, int D, int L, int K, int N, int F, void* stream) {
  if (B < 1 || T < 1 || L < 1 || K < 1 || D < 4 || D % 4 || F < 1 || N < 1 || N > 8 ||
      N != (T + F - 1) / F)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = FwdLayout(F, D, K).floats(D, K) * sizeof(float);
  const ConvParams p = make_params(gam, beta, dw, wp, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = F <= 16 ? vsl::launch_cluster(conv_block_fwd_cluster_kernel<2>, B * N, N,
                                                  kThreads, smem, s, x, p, drop, out, F)
                            : vsl::launch_cluster(conv_block_fwd_cluster_kernel<3>, B * N, N,
                                                  kThreads, smem, s, x, p, drop, out, F);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The backward on conv_plan's N CTAs a row, F frames a CTA (N = ceil(T /
// F) <= 8). dsmall [L, 3 + K, D]: dgam, dbeta, dbp, ddw; dwp [L, D, D].
// Workspaces: d_ws, gp_ws [L, B, T, D]; part [B * N, L, 3 + K, D];
// gemm_ws [L, splits, D, D] (unused when splits == 1).
extern "C" int vsl_conv_block_bwd(const float* x, const float* gam, const float* beta,
                                  const float* dw, const float* wp, const float* wpT,
                                  const float* bp, const float* seeds, unsigned thresh,
                                  float scale, const float* g, float* dx, float* dsmall,
                                  float* dwp, float* d_ws, float* gp_ws, float* part,
                                  float* gemm_ws, int splits, int B, int T, int D, int L, int K,
                                  int N, int F, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || L < 1 || K < 1 || D < 4 || D % 4 || F < 1 || N < 1 || N > 8 ||
      N != (T + F - 1) / F)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = BwdLayout(F, D, L, K).floats(D, L, K) * sizeof(float);
  cudaError_t err = vsl::launch_cluster(
      conv_block_bwd_cluster_kernel, B * N, N, kThreads, smem, stream, x,
      make_params(gam, beta, dw, wp, bp, T, D, L, K), wpT, vsl::Dropout{seeds, thresh, scale}, g,
      dx, d_ws, gp_ws, part, F);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vsl::sum_partials(part, dsmall, 1, B * N, L * (3 + K) * D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dwp[l] = d_l^T . g_p,l over the B*T rows of layer l
  return static_cast<int>(vsl::wgrad(d_ws, gp_ws, dwp, gemm_ws, L, D, D, B * T, splits, stream));
}

// The T-tiled forward on conv_tiled_fwd_plan's tiles of F frames, weight
// slices of SK rows and product tiles of R rows (2 or 4), L launches: layer
// l reads `l == 0 ? x : xs[l - 1]` and writes `l == L - 1 ? out : xs[l]`;
// xs [L - 1, B, T, D].
extern "C" int vsl_conv_block_fwd_tiled(const float* x, const float* gam, const float* beta,
                                        const float* dw, const float* wp, const float* bp,
                                        const float* seeds, unsigned thresh, float scale,
                                        float* xs, float* out, int B, int T, int D, int L, int K,
                                        int F, int SK, int R, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || L < 1 || K < 1 || D < 4 || D % 4 || F < 1 || SK < 4 || SK % 4 ||
      D % SK || (R != 2 && R != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = R == 2 ? conv_layer_fwd_tiled_kernel<2> : conv_layer_fwd_tiled_kernel<4>;
  const size_t smem = TiledFwdLayout(F, D, K, SK).floats(D, K) * sizeof(float);
  cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ConvParams p = make_params(gam, beta, dw, wp, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  const size_t layer = (size_t)B * T * D;
  const dim3 grid(tiles(T, F), B);
  for (int l = 0; l < L; ++l) {
    const float* in = l == 0 ? x : xs + (l - 1) * layer;
    float* o = l == L - 1 ? out : xs + l * layer;
    kernel<<<grid, kTiledThreads, smem, stream>>>(in, p, l, drop, o, F, SK);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The T-tiled backward from the forward's xs on conv_tiled_bwd_plan's tiles
// of F frames, weight slices of SK rows and product tiles of R rows (4 or
// 6): dx, dsmall [L, 3 + K, D] and
// dwp as the whole-row backward's. Workspaces: d_ws, gp_ws [L, B, T, D];
// g_ws [B, T, D] (the running gradient's second buffer); part [B *
// ceil(T / F), L, 3 + K, D]; gemm_ws [L, splits, D, D].
extern "C" int vsl_conv_block_bwd_tiled(const float* x, const float* xs, const float* gam,
                                        const float* beta, const float* dw, const float* wp,
                                        const float* wpT, const float* bp, const float* seeds,
                                        unsigned thresh, float scale, const float* g, float* dx,
                                        float* dsmall, float* dwp, float* d_ws, float* gp_ws,
                                        float* g_ws, float* part, float* gemm_ws, int splits,
                                        int B, int T, int D, int L, int K, int F, int SK,
                                        int R, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || L < 1 || K < 1 || D < 4 || D % 4 || F < 1 || SK < 4 || SK % 4 ||
      D % SK || (R != 4 && R != 6))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = R == 4 ? conv_layer_bwd_tiled_kernel<4> : conv_layer_bwd_tiled_kernel<6>;
  const size_t smem = TiledBwdLayout(F, D, K, SK).floats(D, K) * sizeof(float);
  cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t layer = (size_t)B * T * D;
  const ConvParams p = make_params(gam, beta, dw, wp, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  const dim3 grid(tiles(T, F), B);
  for (int l = L - 1; l >= 0; --l) {
    const float* in = l == 0 ? x : xs + (l - 1) * layer;
    // layer l writes dx (l even) or g_ws (l odd) and reads what layer l + 1 wrote
    const float* Gin = l == L - 1 ? g : ((l + 1) & 1 ? g_ws : dx);
    float* Gout = l & 1 ? g_ws : dx;
    kernel<<<grid, kTiledThreads, smem, stream>>>(
        in, p, l, wpT, drop, Gin, Gout, d_ws + l * layer, gp_ws + l * layer, part, F, SK);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = vsl::sum_partials(part, dsmall, 1, B * tiles(T, F), L * (3 + K) * D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vsl::wgrad(d_ws, gp_ws, dwp, gemm_ws, L, D, D, B * T, splits, stream));
}
