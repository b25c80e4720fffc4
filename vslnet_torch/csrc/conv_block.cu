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
constexpr int kRows = 16;
constexpr int kGnPer = 4;  // tiled launch B: g_n elements a thread holds, so D <= kGnPer * kThreads

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
// Above T = 145 at D = 128 a row's tiles do not fit a block (the backward's
// 3*T*D + T + 16*D floats). These kernels run one layer per launch on a
// grid of (T-tiles of kTile frames, B rows). A tile reads its frames plus a
// halo of the depthwise reach, (K - 1) / 2 frames before and K / 2 after,
// zero padded only at the sequence ends; every dropout coordinate is the
// frame's index t in the row. The forward writes each layer's output to
// device memory (the inputs of layers 1..L-1 go to the workspace xs, which
// the backward reads back instead of replaying the forward). The forward's
// arithmetic is the whole-row kernel's, in the same order, so both give
// equal bits.
//
// The backward walks the layers in reverse, two launches a layer:
//   A. per tile: LN and the depthwise output d over the tile (from the
//      halo), the pre-ReLU recomputed, g_p = [p > 0] * drop(G), dbp, and
//      g_d = g_p . wp^T, written for every frame;
//   B. per tile: g_n = the depthwise transpose of g_d over the halo,
//      ddw = sum_t n(t + j - pad) * g_d(t), the LN backward, G += dx_ln in
//      place (a tile reads and writes only its own frames of G).
// d and g_p go to [L, B, T, D] workspaces for dwp's split-K product;
// dgam, dbeta, dbp and ddw to per-(row, tile) partials summed in a fixed
// order. No atomics.
//
// What bounds them: the pointwise products (2*T*D*D FLOPs a layer, three
// in the backward), now on B * T / kTile blocks (256 at B = 8, T = 1024);
// bytes are each layer's [B, T, D] input and output through L2/HBM.

constexpr int kTile = 32;

// LN of the frames [h0, h0 + rows) of one row (xr [T, D]) into N [rows, D],
// zero for frames outside [0, T).
__device__ void halo_layer_norm(const float* xr, float* N, const float* gam, const float* beta,
                                int h0, int rows, int T, int D) {
  const int lo = max(h0, 0), hi = min(h0 + rows, T);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int t = h0 + i / D;
    if (t < 0 || t >= T) N[i] = 0.f;
  }
  if (hi > lo)
    vsl::layer_norm_rows(xr + (size_t)lo * D, N + (size_t)(lo - h0) * D, gam, beta, hi - lo, D);
}

// Dw[r, c] = sum_j N[r + j, c] * dw[j, c] for the nt frames of the tile.
template <typename Out>
__device__ void depthwise_tile(const float* N, const float* __restrict__ dwl, int nt, int D,
                               int K, Out out) {
  for (int i = threadIdx.x; i < nt * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc = fmaf(N[(size_t)(r + j) * D + c], __ldg(dwl + (size_t)j * D + c), acc);
    out(i, acc);
  }
}

__global__ void __launch_bounds__(kThreads)
conv_layer_fwd_tiled_kernel(const float* __restrict__ xin, ConvParams p, int l, vsl::Dropout drop,
                            float* __restrict__ xout) {
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, K = p.K, pad = (K - 1) / 2;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile, nt = min(kTile, T - t0);
  float* N = reinterpret_cast<float*>(smem4);  // [nt + K - 1, D]
  float* Dw = N + (size_t)(kTile + K - 1) * D;   // [nt, D]
  const size_t row = (size_t)b * T * D;
  const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x100u + l);
  halo_layer_norm(xin + row, N, p.gam + (size_t)l * D, p.beta + (size_t)l * D, t0 - pad,
                  nt + K - 1, T, D);
  __syncthreads();
  depthwise_tile(N, p.dw + (size_t)l * K * D, nt, D, K, [&](int i, float v) { Dw[i] = v; });
  __syncthreads();
  const float* bpl = p.bp + (size_t)l * D;
  vsl::gemm_rows<kRows>(Dw, nt, D, p.wp + (size_t)l * D * D, D, 0, D,
                        [&](int t, int o, float acc) {
                          const size_t i = row + (size_t)(t0 + t) * D + o;
                          xout[i] = xin[i] + drop.apply(fmaxf(acc + __ldg(bpl + o), 0.f), seed,
                                                        salt, t0 + t, o);
                        });
}

// Per-(row, tile) partials part [B * tiles, L, 3 + K, D], as the whole-row
// backward's per-row ones: dgam, dbeta, dbp, then ddw [K, D].
__global__ void __launch_bounds__(kThreads)
conv_layer_bwd_a_kernel(const float* __restrict__ xin, ConvParams p, int l,
                        const float* __restrict__ wpT, vsl::Dropout drop,
                        const float* __restrict__ G, float* __restrict__ d_l,
                        float* __restrict__ gp_l, float* __restrict__ gd,
                        float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, K = p.K, pad = (K - 1) / 2;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile, nt = min(kTile, T - t0);
  float* N = reinterpret_cast<float*>(smem4);  // [nt + K - 1, D]
  float* Dw = N + (size_t)(kTile + K - 1) * D;   // [nt, D]
  float* GP = Dw + (size_t)kTile * D;            // [nt, D]
  const size_t row = (size_t)b * T * D, tile = row + (size_t)t0 * D;
  const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x100u + l);
  float* pr = part + ((size_t)(b * gridDim.x + blockIdx.x) * p.L + l) * (3 + K) * D;
  halo_layer_norm(xin + row, N, p.gam + (size_t)l * D, p.beta + (size_t)l * D, t0 - pad,
                  nt + K - 1, T, D);
  __syncthreads();
  depthwise_tile(N, p.dw + (size_t)l * K * D, nt, D, K, [&](int i, float v) {
    Dw[i] = v;
    d_l[tile + i] = v;
  });
  __syncthreads();
  const float* bpl = p.bp + (size_t)l * D;
  vsl::gemm_rows<kRows>(Dw, nt, D, p.wp + (size_t)l * D * D, D, 0, D,
                        [&](int t, int o, float acc) {
                          const size_t i = (size_t)t * D + o;
                          const float gp = acc + __ldg(bpl + o) > 0.f
                                               ? drop.apply(G[tile + i], seed, salt, t0 + t, o)
                                               : 0.f;
                          GP[i] = gp;
                          gp_l[tile + i] = gp;
                        });
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < nt; ++t) s += GP[(size_t)t * D + c];
    pr[2 * D + c] = s;  // dbp
  }
  vsl::gemm_rows<kRows>(GP, nt, D, wpT + (size_t)l * D * D, D, 0, D,
                        [&](int t, int o, float acc) { gd[tile + (size_t)t * D + o] = acc; });
}

__global__ void __launch_bounds__(kThreads)
conv_layer_bwd_b_kernel(const float* __restrict__ xin, ConvParams p, int l,
                        const float* __restrict__ gd, float* __restrict__ G,
                        float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, K = p.K, pad = (K - 1) / 2;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile, nt = min(kTile, T - t0);
  const int rows = nt + K - 1;
  const int h0 = t0 - pad;           // first frame of the LN halo
  const int g0 = t0 - (K - 1 - pad);  // first frame of the g_d halo
  float* XH = reinterpret_cast<float*>(smem4);  // [rows, D] xh of the LN halo
  float* GD = XH + (size_t)(kTile + K - 1) * D;  // [rows, D] g_d, zero outside [0, T)
  float* inv = GD + (size_t)(kTile + K - 1) * D; // [rows]
  const size_t row = (size_t)b * T * D;
  const float* gam = p.gam + (size_t)l * D;
  const float* beta = p.beta + (size_t)l * D;
  const float* dwl = p.dw + (size_t)l * K * D;
  float* pr = part + ((size_t)(b * gridDim.x + blockIdx.x) * p.L + l) * (3 + K) * D;
  const int lo = max(h0, 0), hi = min(h0 + rows, T);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int t = g0 + i / D;
    GD[i] = (t >= 0 && t < T) ? gd[row + (size_t)t * D + i % D] : 0.f;
  }
  vsl::ln_normalize_rows(xin + row + (size_t)lo * D, XH + (size_t)(lo - h0) * D, inv + (lo - h0),
                         hi - lo, D);
  __syncthreads();
  // ddw[j, c] = sum over the tile's t of n(t + j - pad, c) * g_d(t, c)
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) {
    const int j = i / D, c = i - j * D;
    float s = 0.f;
    for (int r = 0; r < nt; ++r) {
      const int tt = t0 + r + j - pad;
      if (tt >= 0 && tt < T)
        s = fmaf(XH[(size_t)(tt - h0) * D + c] * __ldg(gam + c) + __ldg(beta + c),
                 GD[(size_t)(t0 + r - g0) * D + c], s);
    }
    pr[3 * D + i] = s;
  }
  // g_n(t0 + r, c) = sum_j g_d(t0 + r + pad - j, c) * dw[j, c], which reads
  // GD's rows r .. r + K - 1, into GD's row r in place: chunks of rows in
  // increasing order, each computed into registers before any of it is
  // written
  const int chunk = kGnPer * kThreads / D;
  for (int r0 = 0; r0 < nt; r0 += chunk) {
    const int n = min(chunk, nt - r0) * D;
    float v[kGnPer];
#pragma unroll
    for (int q = 0; q < kGnPer; ++q) {
      const int i = threadIdx.x + q * kThreads, r = r0 + i / D, c = i % D;
      v[q] = 0.f;
      if (i < n)
        for (int j = 0; j < K; ++j)
          v[q] = fmaf(GD[(size_t)(r + K - 1 - j) * D + c], __ldg(dwl + (size_t)j * D + c), v[q]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kGnPer; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (i < n) GD[(size_t)r0 * D + i] = v[q];
    }
    __syncthreads();
  }
  // the LN backward over the tile's own frames (dgam, dbeta), G += dx_ln
  vsl::ln_backward_rows(GD, XH + (size_t)(t0 - h0) * D, inv + (t0 - h0), gam, nt, D, pr, pr + D,
                        [&](int r, int c, float v) { G[row + (size_t)(t0 + r) * D + c] += v; });
}

int tiles(int T) { return (T + kTile - 1) / kTile; }

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

// The T-tiled forward, L launches: layer l reads `l == 0 ? x : xs[l - 1]`
// and writes `l == L - 1 ? out : xs[l]`; xs [L - 1, B, T, D].
extern "C" int vsl_conv_block_fwd_tiled(const float* x, const float* gam, const float* beta,
                                        const float* dw, const float* wp, const float* bp,
                                        const float* seeds, unsigned thresh, float scale,
                                        float* xs, float* out, int B, int T, int D, int L, int K,
                                        void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int smem = ((2 * kTile + K - 1) * D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(conv_layer_fwd_tiled_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ConvParams p = make_params(gam, beta, dw, wp, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  const size_t layer = (size_t)B * T * D;
  for (int l = 0; l < L; ++l) {
    const float* in = l == 0 ? x : xs + (l - 1) * layer;
    float* o = l == L - 1 ? out : xs + l * layer;
    conv_layer_fwd_tiled_kernel<<<dim3(tiles(T), B), kThreads, smem, stream>>>(in, p, l, drop, o);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The T-tiled backward from the forward's xs: dx (which carries the
// running gradient G, starting from g), dsmall [L, 3 + K, D] and dwp as the
// whole-row backward's. Workspaces: d_ws, gp_ws [L, B, T, D]; gd_ws [B, T,
// D]; part [B * tiles, L, 3 + K, D]; gemm_ws [L, splits, D, D].
extern "C" int vsl_conv_block_bwd_tiled(const float* x, const float* xs, const float* gam,
                                        const float* beta, const float* dw, const float* wp,
                                        const float* wpT, const float* bp, const float* seeds,
                                        unsigned thresh, float scale, const float* g, float* dx,
                                        float* dsmall, float* dwp, float* d_ws, float* gp_ws,
                                        float* gd_ws, float* part, float* gemm_ws, int splits,
                                        int B, int T, int D, int L, int K, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (D > kGnPer * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int smem_a = ((3 * kTile + K - 1) * D) * static_cast<int>(sizeof(float));
  const int smem_b =
      (2 * (kTile + K - 1) * D + kTile + K - 1) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(conv_layer_bwd_a_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conv_layer_bwd_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t layer = (size_t)B * T * D;
  err = cudaMemcpyAsync(dx, g, layer * sizeof(float), cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ConvParams p = make_params(gam, beta, dw, wp, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  const dim3 grid(tiles(T), B);
  for (int l = L - 1; l >= 0; --l) {
    const float* in = l == 0 ? x : xs + (l - 1) * layer;
    conv_layer_bwd_a_kernel<<<grid, kThreads, smem_a, stream>>>(
        in, p, l, wpT, drop, dx, d_ws + l * layer, gp_ws + l * layer, gd_ws, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_layer_bwd_b_kernel<<<grid, kThreads, smem_b, stream>>>(in, p, l, gd_ws, dx, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = vsl::sum_partials(part, dsmall, 1, B * tiles(T), L * (3 + K) * D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vsl::wgrad(d_ws, gp_ws, dwp, gemm_ws, L, D, D, B * T, splits, stream));
}
