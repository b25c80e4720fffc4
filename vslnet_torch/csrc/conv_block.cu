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
// fp32 T-tiled forward's, so at fp32 the three give equal bits and equal
// masks; at bf16 the T-tiled forward runs its product on the tensor cores
// (another order of sums) and writes the mask its backward reads.
//
// Backward (fp32; the bf16 backwards are kernels of their own, below): a
// thread-block cluster of N CTAs per batch row (plan:
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
//
// bf16 (vsl_conv_block_fwd_bf16, vsl_conv_block_fwd_tiled_bf16): the TPU
// forward at bf16 (pallas_kernels.py:985-1034) takes x in bf16 and the
// weights in fp32, keeps the residual stream fp32 across all L layers,
// rounds n = LN(x) to bf16 before the fp32 depthwise, rounds d and wp to
// bf16 for the pointwise product (fp32 accumulation), and rounds the
// output to bf16 once, after the last layer. The whole-row forward,
// templated: x widened as it is loaded, n rounded as the LayerNorm stores
// it, d as the depthwise stores it, wp in shared memory once it has landed, the
// output narrowed as it is stored; bound as the fp32 forward is. Where a
// gradient follows it also writes each layer's input (fp32) and ReLU mask
// for the bf16 whole-row backward. The tiled
// forward at bf16 is a kernel of its own on the tensor cores
// (conv_layer_fwd_tc_tiled_kernel, further down): bf16(d) . bf16(wp) by
// mma.sync, its epilogue on the C fragments, the layer's ReLU mask written
// for the backward. Its inter-layer stream xs stays fp32, as the TPU
// kernel's stream does; only the first layer reads bf16 and only the last
// writes it.
//
// bf16 backwards (vsl_conv_block_bwd_bf16, vsl_conv_block_bwd_tiled_bf16):
// the TPU backward at bf16 (pallas_kernels.py:1039-1114, the custom VJP at
// 1320-1339) takes x and g in bf16 and keeps the running gradient G fp32
// between the layers. Its replay is the bf16 forward's; then per layer g_p
// = [p > 0] drop(G) is fp32 and dbp sums it UNROUNDED, while dwp = sum
// bf16(d)^T . bf16(g_p) and g_d = bf16(g_p) . bf16(wp)^T take it rounded;
// g_n, ddw, the LayerNorm backward and G stay fp32, and ddw pairs g_d with
// the UNROUNDED n (the forward's depthwise read bf16(n)); dx = bf16(G)
// once, after layer 0. Both are kernels of their own on the tensor cores
// that read what their forward saved in place of replaying p: the tiled
// backward (conv_layer_bwd_tc_tiled_kernel, one layer a launch) the ReLU
// mask the bf16 tiled forward writes, the whole-row backward
// (conv_block_bwd_tc_row_kernel, a CTA a row through every layer, the same
// layer with the row as its tile) each layer's input and ReLU mask, which
// the bf16 whole-row forward writes when a gradient follows; each runs g_d
// on mma.sync and dwp on wgrad_tc.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "hash.cuh"
#include "mma.cuh"

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
// kRound: each output rounded to bf16 as it is stored.
template <bool kReversed, bool kRound = false>
__device__ void window_taps(const float* win, const float* taps, int nf, int D, int K, float* out) {
  for (int i = threadIdx.x; i < nf * D; i += blockDim.x) {
    const int t = i / D, c = i - t * D;
    float acc = 0.f;
#pragma unroll 7
    for (int j = 0; j < K; ++j)
      acc = fmaf(win[(size_t)(t + j) * D + c], taps[(size_t)(kReversed ? K - 1 - j : j) * D + c],
                 acc);
    out[i] = kRound ? vsl::bf16_round(acc) : acc;
  }
}

// The forward's product tile: R rows x 4 columns (R = 3 above 16 frames a
// CTA, so that the main path's 22 are 256 items, one a thread; else 2),
// the k loop unrolled 4 times. XT: the storage type of x and out (float,
// or __nv_bfloat16 for the bf16 forward). With xs and mask non-null (the
// bf16 forward when a gradient follows) it also writes the backward's
// residuals: each layer's input x_l, l >= 1, into xs [L - 1, B, T, D]
// (fp32, as the stream holds it) and each layer's ReLU mask [p > 0] into
// mask [L, B, T, D / 4] (bit q of byte c: column 4 c + q, the T-tiled
// forward's layout); null pointers write nothing more.
template <int R, typename XT = float>
__global__ void __launch_bounds__(kThreads)
conv_block_fwd_cluster_kernel(const XT* __restrict__ x, ConvParams p, vsl::Dropout drop,
                              XT* __restrict__ out, float* __restrict__ xs,
                              uint8_t* __restrict__ mask, int F) {
  constexpr bool kBf16 = !std::is_same<XT, float>::value;
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
  const size_t layer = (size_t)gridDim.x / N * T * D;  // a layer's stride in xs
  for (int i = threadIdx.x; i < nel; i += blockDim.x) X[i] = vsl::to_float(x[own + i]);
  for (int l = 0; l < p.L; ++l) {
    float* NWl = NW + (l & 1) * lay.HD;
    __syncthreads();  // X written; W, DW and P read by the layer before
    if (xs != nullptr && l > 0)  // x_l, the layer's input
      for (int i = threadIdx.x; i < nel; i += blockDim.x) xs[(l - 1) * layer + own + i] = X[i];
    vsl::cp_async_floats(DW, p.dw + (size_t)l * K * D, K * D);
    vsl::cp_async_floats(W, p.wp + (size_t)l * D * D, D * D);  // lands behind the LN and depthwise
    vsl::layer_norm_rows<kBf16>(X, NWl + (size_t)pad * D, p.gam + (size_t)l * D,
                                p.beta + (size_t)l * D, nf, D);
    cluster.sync();  // every CTA's n_l, before the halo reads
    fill_halo(cluster, NWl, pad, c0, nf, F, T, D, K);
    vsl::cp_async_wait<1>();
    __syncthreads();
    window_taps<false, kBf16>(NWl, DW, nf, D, K, P);  // P[t] = sum_j n(t + j - pad) dw[j]
    vsl::cp_async_wait<0>();
    __syncthreads();
    if (kBf16) {  // wp rounded in place for the product
      vsl::round_bf16(W, D * D);
      __syncthreads();
    }
    const float* bpl = p.bp + (size_t)l * D;
    const uint32_t salt = vsl::site_salt(0x100u + l);
    uint8_t* mask_l = mask == nullptr ? nullptr : mask + l * (layer / 4);
    vsl::smem_gemm<R, 4>(P, D, nf, D, W, D, D, [&](int t, int o, float4 acc) {
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
      uint32_t bits = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float pre = a[q] + __ldg(bpl + o + q);
        bits |= (pre > 0.f ? 1u : 0u) << q;
        X[(size_t)t * D + o + q] += drop.apply(fmaxf(pre, 0.f), seed, salt, c0 + t, o + q);
      }
      if (mask_l != nullptr) mask_l[(own + (size_t)t * D + o) / 4] = static_cast<uint8_t>(bits);
    });
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nel; i += blockDim.x) out[own + i] = vsl::from_float<XT>(X[i]);
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
    // P[t] = sum_j n(t + j - pad) dw[j]
    window_taps<false>(NWl, DW, nf, D, K, P);
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
// That is the whole-row forward's arithmetic in the same order, so at fp32
// the two give equal bits, and the backward below replays [p > 0] bit for
// bit. (At bf16 the tiled forward is conv_layer_fwd_tc_tiled_kernel, whose
// tensor-core sums round otherwise; the bf16 backward reads its mask.)
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
// kRound: each output rounded to bf16 as it is stored; kRoundIn: each
// window value rounded to bf16 as it is read; Out: the output's storage
// type (bf16 for the bf16 backward's d, which goes straight to dwp's
// workspace); ldo: the output's row stride (D, or a bf16 tile's).
template <int K, bool kRev, bool kRound = false, bool kRoundIn = false, typename Out = float>
__device__ void taps_sliding(const float* win, const float* taps, int rows, int D, Out* out,
                             int ldo) {
  const auto in = [](float v) { return kRoundIn ? vsl::bf16_round(v) : v; };
  const int parts = max(1, static_cast<int>(blockDim.x) / D);  // threads a column
  const int per = (rows + parts - 1) / parts;
  for (int i = threadIdx.x; i < D * parts; i += blockDim.x) {
    const int c = i % D, e0 = i / D * per, e1 = min(rows, e0 + per);
    float w[K], n[K];
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = taps[j * D + c];
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) n[j] = e0 + j < rows + K - 1 ? in(win[(e0 + j) * D + c]) : 0.f;
    for (int e = e0; e < e1; ++e) {
      n[K - 1] = in(win[(e + K - 1) * D + c]);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) acc = fmaf(kRev ? n[K - 1 - j] : n[j], w[j], acc);
      out[e * ldo + c] = vsl::from_float<Out>(kRound ? vsl::bf16_round(acc) : acc);
#pragma unroll
      for (int j = 0; j + 1 < K; ++j) n[j] = n[j + 1];
    }
  }
}

// out[e][c] = sum over j < K of win[e + j][c] * taps[j][c] for e < rows
// (kRev: win[e + K - 1 - j][c]), each one fmaf chain over j in order: the
// register window of taps_sliding at the model's K = 7, a loop of taps at
// any other K.
template <bool kRev, bool kRound = false, bool kRoundIn = false, typename Out = float>
__device__ void taps_rows(const float* win, const float* taps, int rows, int D, int K, Out* out,
                          int ldo) {
  if (K == 7) {
    taps_sliding<7, kRev, kRound, kRoundIn, Out>(win, taps, rows, D, out, ldo);
    return;
  }
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const float* n = win + i;  // row e + j of column c is n[j * D]
    const float* w = taps + i % D;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      const float v = n[(kRev ? K - 1 - j : j) * D];
      acc = fmaf(kRoundIn ? vsl::bf16_round(v) : v, w[j * D], acc);
    }
    out[i / D * ldo + i % D] = vsl::from_float<Out>(kRound ? vsl::bf16_round(acc) : acc);
  }
}

// vsl::layer_norm_rows of the rows [0, rows) of X [.][D] into Y (X itself
// where Y is X), for D <= 32 kC: the same sums and expressions, so the same
// bits, with a row's values, gam and beta in registers (one shared load and
// one store an element) and two rows a warp at a time, so that their
// reductions overlap. kRound: the output rounded to bf16 as it is stored.
template <int kC, bool kRound = false>
__device__ void ln_rows_in_registers(const float* X, float* Y, const float* __restrict__ gam,
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
    const size_t o[2] = {(size_t)r0 * D, (size_t)min(r0 + 1, rows - 1) * D};
    const float* x[2] = {X + o[0], X + o[1]};
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
        if (lane + 32 * i < D) {
          const float n = (v[h][i] - mean[h]) * inv[h] * g[i] + bt[i];
          Y[o[h] + lane + 32 * i] = kRound ? vsl::bf16_round(n) : n;
        }
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
// xin + drop(relu(depthwise(LN(xin)) . wp + bp)) over the own frames. (The
// bf16 tiled forward is a kernel of its own further down.)
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
    ln_rows_in_registers<4>(own, own, gam, beta, hi - lo, D);
  else  // wider rows than the model's: the same sums out of shared memory
    vsl::layer_norm_rows(own, own, gam, beta, hi - lo, D);
  __syncthreads();
  // 2. d over the own frames: A[r] = sum_j n(t0 + r + j - pad) dw[j]
  taps_rows<false>(X, DW, nf, D, K, A, D);
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
// D]) as the whole-row backward's per-CTA ones. (The bf16 tiled backward is
// a kernel of its own further down.)
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
  taps_rows<false>(N, DW, ne, D, K, A, D);
  // (sliced_product's first barrier orders A's writes before its reads)
  // p = d . wp + bp, and g_p = [p > 0] * drop(G_in) into P, 0 outside [0, T)
  sliced_product<R>(A, ne, D, p.wp + (size_t)l * D * D, W, SK, P, [&](int e, int o,
                                                                     float4 acc) {
    const int t = e0 + e;
    const bool in = t >= 0 && t < T;
    // one float4 load of G_in and of bp, whatever the masks say
    const size_t go = row + (size_t)(in ? t : 0) * D + o;
    const float4 g4 = *reinterpret_cast<const float4*>(Gin + go);
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(bpl + o));
    const float a[4] = {acc.x, acc.y, acc.z, acc.w}, gi[4] = {g4.x, g4.y, g4.z, g4.w};
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
    float gp[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gp[q] = in && a[q] + bb[q] > 0.f ? drop.apply(gi[q], seed, salt, t, o + q) : 0.f;
    const float4 gp4 = make_float4(gp[0], gp[1], gp[2], gp[3]);
    *reinterpret_cast<float4*>(P + (size_t)e * D + o) = gp4;
    if (e >= gl && e < gl + nf)  // dwp's operand
      *reinterpret_cast<float4*>(gp_l + row + (size_t)t * D + o) = gp4;
  });
  // 3. wp^T's first slice lands behind dbp and d's own rows to d_l
  vsl::cp_async_floats(W, wpT + (size_t)l * D * D, SK * D);
  for (int i = tid; i < nf * D; i += nt) d_l[row + (size_t)t0 * D + i] = A[(size_t)gl * D + i];
  for (int c = tid; c < D; c += nt) {
    float s = 0.f;
    for (int t = 0; t < nf; ++t) s += P[(size_t)(gl + t) * D + c];
    pr[2 * D + c] = s;  // dbp, of the unrounded g_p
  }
  // g_d = g_p . wp^T into A (0 outside [0, T), where g_p is)
  sliced_product<R>(P, ne, D, wpT + (size_t)l * D * D, W, SK, A, [&](int e, int o,
                                                                           float4 acc) {
    *reinterpret_cast<float4*>(A + (size_t)e * D + o) = acc;
  });
  // 4. G_in's own rows into the free weight buffer where they fit, landing
  // behind g_n and ddw; g_n(t0 + r) = sum_j g_d(t0 + r + pad - j) dw[j]
  // into P's first rows
  const bool staged = (size_t)nf * D <= lay.W;
  if (staged) vsl::cp_async_floats(W, Gin + row + (size_t)t0 * D, nf * D);
  taps_rows<true>(A, DW, nf, D, K, P, D);
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
  float* no_xs = nullptr;
  uint8_t* no_mask = nullptr;
  cudaError_t err = F <= 16 ? vsl::launch_cluster(conv_block_fwd_cluster_kernel<2>, B * N, N,
                                                  kThreads, smem, s, x, p, drop, out, no_xs,
                                                  no_mask, F)
                            : vsl::launch_cluster(conv_block_fwd_cluster_kernel<3>, B * N, N,
                                                  kThreads, smem, s, x, p, drop, out, no_xs,
                                                  no_mask, F);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The bf16 forward on the same plan: x and out [B, T, D] in bf16, the
// weights fp32; where a gradient follows, the bf16 backward's residuals xs
// [L - 1, B, T, D] (fp32) and mask [L, B, T, D / 4] (bytes), else both
// null.
extern "C" int vsl_conv_block_fwd_bf16(const void* x, const float* gam, const float* beta,
                                       const float* dw, const float* wp, const float* bp,
                                       const float* seeds, unsigned thresh, float scale,
                                       void* out, float* xs, void* mask, int B, int T, int D,
                                       int L, int K, int N, int F, void* stream) {
  if (B < 1 || T < 1 || L < 1 || K < 1 || D < 4 || D % 4 || F < 1 || N < 1 || N > 8 ||
      N != (T + F - 1) / F)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  const size_t smem = FwdLayout(F, D, K).floats(D, K) * sizeof(float);
  const ConvParams p = make_params(gam, beta, dw, wp, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* mk = static_cast<uint8_t*>(mask);
  cudaError_t err = F <= 16 ? vsl::launch_cluster(conv_block_fwd_cluster_kernel<2, bf16>, B * N,
                                                  N, kThreads, smem, s, xb, p, drop, ob, xs, mk,
                                                  F)
                            : vsl::launch_cluster(conv_block_fwd_cluster_kernel<3, bf16>, B * N,
                                                  N, kThreads, smem, s, xb, p, drop, ob, xs, mk,
                                                  F);
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
  const ConvParams p = make_params(gam, beta, dw, wp, bp, T, D, L, K);
  const size_t smem = BwdLayout(F, D, L, K).floats(D, L, K) * sizeof(float);
  cudaError_t err = vsl::launch_cluster(conv_block_bwd_cluster_kernel, B * N, N, kThreads, smem,
                                        stream, x, p, wpT, vsl::Dropout{seeds, thresh, scale}, g,
                                        dx, d_ws, gp_ws, part, F);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) err = vsl::sum_partials(part, dsmall, 1, B * N, L * (3 + K) * D, stream);
  // dwp[l] = d_l^T . g_p,l over the B*T rows of layer l
  if (err == cudaSuccess) err = vsl::wgrad(d_ws, gp_ws, dwp, gemm_ws, L, D, D, B * T, splits, stream);
  return static_cast<int>(err);
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

namespace {

// --- the bf16 T-tiled backward on the tensor cores (#9 at bf16, tiled) -----
// One launch a layer on ops/kernels.py conv_tiled_bwd_bf16_plan (tiles of F
// frames, wp's rows in slices of SN), no atomics, the layers in reverse. A
// CTA takes the F own frames [t0, t0 + F) of one row and everything their
// gradient needs, so that nothing but G crosses a tile's edge:
//   1. the taps, x_l over the own frames and the depthwise reach [t0 - pad,
//      t0 + nf + K - 1 - pad) (0 outside [0, T)) and bf16(wp)'s rows (the
//      wrapper rounds wp once a call) by cp.async; n_l in place (the
//      forward's layer_norm_rows, row for row), xh and inv of the own rows;
//   2. d = depthwise(bf16(n_l)) over the own frames, rounded, straight to
//      dwp's bf16 workspace; over E = F + K - 1 frames [t0 - (K - 1 - pad),
//      t0 + nf + pad): g_p = [p > 0] drop(G_in), the sign read from the mask
//      bits the bf16 forward wrote (the same test on the same sums: the
//      fp32 replay of p = d . wp + bp is gone), 0 outside [0, T); fp32 into
//      GD, bf16 into GP (ldmatrix rows at tc_stride) and the own rows to
//      dwp's bf16 workspace; dbp sums the unrounded g_p of the own rows;
//   3. g_d [E, D] = bf16(g_p) . bf16(wp)^T on mma.sync m16n8k16, bf16
//      operands, fp32 sums: A fragments from GP, B from wp's rows as they
//      are (no transpose), each warp a (16 frames, 16 columns) item at a
//      time, each k16 product added to the item's sums by fp32 adds, into
//      GD; four k16 products at a time, each group's into sums of its own,
//      added in a fixed order at the end;
//   4. ddw (the unrounded n against g_d), then g_n = the depthwise
//      transpose of g_d over the own frames into N's first rows, then the
//      LayerNorm backward (dgam, dbeta) and G_out = G_in + dx_ln.
// dwp = sum bf16(d)^T . bf16(g_p) is then mma.cuh's wgrad_tc over the bf16
// workspaces; dgam, dbeta, dbp and ddw are per-(row, tile) partials summed in
// a fixed order. What bounds it: the LayerNorm, depthwise and gradient
// passes out of shared memory and the block barriers between them; its one
// product is ~1/15 of the fp32 kernel's two.
constexpr int kTcTiledThreads = 512;  // (kernels.py CONV_TILED_THREADS)

// Its shared memory for F frames a tile, K taps and wp slices of SN rows
// (ops/kernels.py conv_tiled_bwd_bf16_plan reports it; the launch uses this
// one), Dk = D rounded up to 64 (whole groups of 4 k16 steps), E = F + K -
// 1 rounded up to 16 for Ep:
//   N   [E][D] float     n_l over the own frames and the reach; then g_n
//   XH  [F][D] float     xh of the own frames
//   GD  [E][D] float     g_p over E, then g_d
//   DW  [K][D] float     the layer's taps
//   inv [F4] float
//   GP  [Ep][GST] bf16   bf16(g_p) over E, 0 in its padding
//   W   [SN][GST] bf16   bf16(wp)'s rows of the slice, 0 past D
struct TcTiledBwdLayout {
  size_t N, XH, DW, F4, GP, W;
  int Dk, GST, Ep;
  __host__ __device__ TcTiledBwdLayout(int F, int D, int K, int SN)
      : N((size_t)(F + K - 1) * D), XH((size_t)F * D), DW((size_t)K * D),
        F4(((size_t)F + 3) / 4 * 4), Dk((D + 63) / 64 * 64), GST(vsl::tc_stride((D + 63) / 64 * 64)),
        Ep((F + K - 1 + 15) / 16 * 16) {
    GP = (size_t)Ep * GST;
    W = (size_t)SN * GST;
  }
  __host__ __device__ size_t bytes() const { return 4 * (2 * N + XH + DW + F4) + 2 * (GP + W); }
};

// One layer of the bf16 backward for the tile [t0, t0 + F) of row b, t0 =
// tile F: G_in -> G_out, bf16 d and g_p of the own frames into d_l and
// gp_l, per-(row, tile) partials part [B * tiles, L, 3 + K, D] (dgam,
// dbeta, dbp, ddw [K, D]); mask_l [B, T, D / 4] the forward's [p > 0] bits
// of layer l. XIn, GIn, GOut: the storage types of the layer's input, G_in
// and G_out (bf16 for x, g and dx, fp32 for xs and the stream between the
// layers). The T-tiled backward runs it a layer a launch; the whole-row
// backward (conv_block_bwd_tc_row_kernel) a row a CTA, every layer in one
// launch, G_in read where the layer before wrote G_out (so no read-only
// loads of them).
template <typename XIn, typename GIn, typename GOut>
__device__ __forceinline__ void
conv_bwd_tc_layer(const XIn* __restrict__ xin, const ConvParams& p, int l,
                  const __nv_bfloat16* __restrict__ wpb, const uint8_t* __restrict__ mask_l,
                  const vsl::Dropout& drop, const GIn* Gin, GOut* Gout,
                  __nv_bfloat16* __restrict__ d_l, __nv_bfloat16* __restrict__ gp_l,
                  float* __restrict__ part, int b, int tile, int tiles, int F, int SN) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, K = p.K, pad = (K - 1) / 2, gl = K - 1 - pad, D4 = D / 4;
  const int t0 = tile * F, nf = min(F, T - t0);
  const int ne = nf + K - 1;  // E: frames [t0 - gl, t0 + nf + pad)
  const int e0 = t0 - gl;
  const TcTiledBwdLayout lay(F, D, K, SN);
  float* N = reinterpret_cast<float*>(smem4);
  float* XH = N + lay.N;
  float* GD = XH + lay.XH;
  float* DW = GD + lay.N;
  float* inv = DW + lay.DW;
  bf16* GP = reinterpret_cast<bf16*>(inv + lay.F4);
  bf16* W = GP + lay.GP;
  const int GST = lay.GST, Dk = lay.Dk;
  const size_t row = (size_t)b * T * D;
  const float* gam = p.gam + (size_t)l * D;
  const bf16* wl = wpb + (size_t)l * D * D;
  float* pr = part + ((size_t)(b * tiles + tile) * p.L + l) * (3 + K) * D;
  const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x100u + l);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5;

  // 1. the taps and x_l over [t0 - pad, t0 + nf + K - 1 - pad) by cp.async
  // (bf16 x by plain loads), then wp's first slice (8-byte copies of its
  // rows); the slice lands behind the LayerNorm
  const int h0 = t0 - pad, lo = max(h0, 0), hi = min(h0 + nf + K - 1, T);
  vsl::cp_async_floats(DW, p.dw + (size_t)l * K * D, K * D);
  if constexpr (std::is_same<XIn, float>::value) {
    for (int i = tid; i < ne * D4; i += nt) {
      const int t = h0 + i / D4;
      if (t >= lo && t < hi)
        vsl::cp_async_float4(N + 4 * i, xin + row + (size_t)h0 * D + 4 * i);
      else
        reinterpret_cast<float4*>(N)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < ne * D; i += nt) {
      const int t = h0 + i / D;
      N[i] = t >= lo && t < hi ? vsl::to_float(xin[row + (size_t)h0 * D + i]) : 0.f;
    }
  }
  vsl::cp_async_commit();
  const auto load_slice = [&](int c0) {
    for (int i = tid; i < SN * D4; i += nt) {
      const int r = i / D4, q = i - r * D4;
      if (c0 + r < D) {
        const uint32_t dst = vsl::smem_addr(W + (size_t)r * GST + 4 * q);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                     "l"(wl + (size_t)(c0 + r) * D + 4 * q)
                     : "memory");
      }
    }
    vsl::cp_async_commit();
  };
  load_slice(0);
  // the products' padding: GP's rows past E and columns past D, W's
  // columns past D (never written by a copy)
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < lay.Ep * (Dk - D); i += nt) {
    const int r = i / (Dk - D);
    GP[(size_t)r * GST + D + i - r * (Dk - D)] = zero;
  }
  for (int i = tid; i < (lay.Ep - ne) * D; i += nt) GP[(size_t)(ne + i / D) * GST + i % D] = zero;
  for (int i = tid; i < SN * (Dk - D); i += nt) {
    const int r = i / (Dk - D);
    W[(size_t)r * GST + D + i - r * (Dk - D)] = zero;
  }
  vsl::cp_async_wait<1>();  // the taps and x_l (wp's slice may be in flight)
  __syncthreads();
  // n_l in place, xh and inv of the own rows
  ln_window_rows(N, lo - h0, hi - lo, pad, nf, gam, p.beta + (size_t)l * D, XH, inv, D);
  __syncthreads();

  // 2. d over the own frames (of bf16(n), rounded) into dwp's workspace
  taps_rows<false, true, true>(N, DW, nf, D, K, d_l + row + (size_t)t0 * D, D);
  // g_p over E: 4 columns an item, one load of G_in and one mask byte
  for (int i = tid; i < ne * D4; i += nt) {
    const int e = i / D4, o = 4 * (i - e * D4), t = e0 + e;
    const bool in = t >= 0 && t < T;
    const size_t go = row + (size_t)(in ? t : 0) * D + o;
    const float4 g4 = vsl::load4(Gin + go);
    const uint32_t m = in ? mask_l[go / 4] : 0u;
    const float gi[4] = {g4.x, g4.y, g4.z, g4.w};
    float gp[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gp[q] = (m >> q) & 1u ? drop.apply(gi[q], seed, salt, t, o + q) : 0.f;
    *reinterpret_cast<float4*>(GD + (size_t)e * D + o) = make_float4(gp[0], gp[1], gp[2], gp[3]);
    uint2 pk;
    pk.x = vsl::pack_bf16(gp[0], gp[1]);
    pk.y = vsl::pack_bf16(gp[2], gp[3]);
    *reinterpret_cast<uint2*>(GP + (size_t)e * GST + o) = pk;
    if (e >= gl && e < gl + nf) *reinterpret_cast<uint2*>(gp_l + go) = pk;
  }
  __syncthreads();
  for (int c = tid; c < D; c += nt) {
    float s = 0.f;
    for (int t = 0; t < nf; ++t) s += GD[(size_t)(gl + t) * D + c];
    pr[2 * D + c] = s;  // dbp, of the unrounded g_p
  }

  // 3. g_d = bf16(g_p) . bf16(wp)^T into GD, slice by slice of wp's rows
  const int mtiles = lay.Ep / 16, nblocks = SN / 16;
  for (int c0 = 0; c0 < Dk; c0 += SN) {
    if (c0 > 0) load_slice(c0);
    vsl::cp_async_wait<0>();
    __syncthreads();  // the slice landed; dbp (or the last slice) read GD's g_p
    for (int item = warp; item < mtiles * nblocks; item += nwarps) {
      const int m0 = 16 * (item / nblocks), n0 = 16 * (item % nblocks);
      float acc[4][2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e / 4][e % 4] = 0.f;
      for (int k = 0; k < Dk; k += 64) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k0 = k + 16 * q;
          uint32_t a[4], bw[4];
          vsl::ldsm_x4(a, GP + (size_t)(m0 + (lane & 15)) * GST + k0 + (lane >> 4) * 8);
          vsl::ldsm_x4(bw, W + (size_t)(n0 + (lane & 7) + ((lane >> 4) << 3)) * GST + k0 +
                               ((lane >> 3) & 1) * 8);
          float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          vsl::mma16(c[0], a, bw[0], bw[1]);
          vsl::mma16(c[1], a, bw[2], bw[3]);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[q][e / 4][e % 4] += c[e / 4][e % 4];
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[0][e / 4][e % 4] = (acc[0][e / 4][e % 4] + acc[1][e / 4][e % 4]) +
                               (acc[2][e / 4][e % 4] + acc[3][e / 4][e % 4]);
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int r = m0 + g + 8 * e2, col = c0 + n0 + 8 * h + 2 * tq;
          if (r < ne && col < D)  // D % 4 == 0: col < D holds for col + 1 too
            *reinterpret_cast<float2*>(GD + (size_t)r * D + col) =
                make_float2(acc[0][h][2 * e2], acc[0][h][2 * e2 + 1]);
        }
    }
    __syncthreads();  // GD's g_d written; the slice read before the next lands
  }

  // 4. ddw[j, c] = sum over the own frames of n(t + j - pad, c) * g_d(t, c)
  for (int i = tid; i < K * D; i += nt) {
    const int j = i / D, c = i - j * D;
    float s = 0.f;
    for (int r = 0; r < nf; ++r)
      s = fmaf(N[(size_t)(r + j) * D + c], GD[(size_t)(r + gl) * D + c], s);
    pr[3 * D + i] = s;
  }
  __syncthreads();
  // g_n(t0 + r) = sum_j g_d(t0 + r + pad - j) dw[j] into N's first rows
  taps_rows<true>(GD, DW, nf, D, K, N, D);
  __syncthreads();
  // the LN backward over the own frames (dgam, dbeta), G_out = G_in + dx_ln
  vsl::ln_backward_rows(N, XH, inv, gam, nf, D, pr, pr + D, [&](int r, int c, float v) {
    const size_t i = row + (size_t)(t0 + r) * D + c;
    Gout[i] = vsl::from_float<GOut>(vsl::to_float(Gin[i]) + v);
  });
}

template <typename XIn, typename GIn, typename GOut>
__global__ void __launch_bounds__(kTcTiledThreads, 1)
conv_layer_bwd_tc_tiled_kernel(const XIn* __restrict__ xin, ConvParams p, int l,
                               const __nv_bfloat16* __restrict__ wpb,
                               const uint8_t* __restrict__ mask_l, vsl::Dropout drop,
                               const GIn* __restrict__ Gin, GOut* __restrict__ Gout,
                               __nv_bfloat16* __restrict__ d_l, __nv_bfloat16* __restrict__ gp_l,
                               float* __restrict__ part, int F, int SN) {
  conv_bwd_tc_layer(xin, p, l, wpb, mask_l, drop, Gin, Gout, d_l, gp_l, part,
                    static_cast<int>(blockIdx.y), static_cast<int>(blockIdx.x),
                    static_cast<int>(gridDim.x), F, SN);
}

// One layer of the bf16 tiled backward, its kernel picked by the storage
// types of its input, G_in and G_out.
template <typename XIn, typename GIn, typename GOut>
cudaError_t tc_tiled_bwd_layer(const XIn* in, const ConvParams& p, int l,
                               const __nv_bfloat16* wpb, const uint8_t* mask,
                               const vsl::Dropout& drop, const GIn* Gin, GOut* Gout,
                               __nv_bfloat16* d_l, __nv_bfloat16* gp_l, float* part, int B, int F,
                               int SN, size_t smem, cudaStream_t stream) {
  auto kernel = conv_layer_bwd_tc_tiled_kernel<XIn, GIn, GOut>;
  const cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(p.T, F), B), kTcTiledThreads, smem, stream>>>(
      in, p, l, wpb, mask + (size_t)l * B * p.T * (p.D / 4), drop, Gin, Gout, d_l, gp_l, part, F,
      SN);
  return cudaGetLastError();
}

// --- the bf16 whole-row backward on the tensor cores (#9 at bf16) ----------
// The T-tiled backward's layer (conv_bwd_tc_layer) at whole-row scale, on
// ops/kernels.py conv_bwd_bf16_plan: one CTA a row, its tile the whole row
// (F = T, so the depthwise reach outside the own frames is the zero
// padding of the sequence ends), all L layers in one launch, the layers in
// reverse with a block barrier between them. It reads what the bf16
// whole-row forward saved for it (x_l for l >= 1 in xs, each layer's [p >
// 0] in mask) in place of the replay that recomputed p = bf16(d) .
// bf16(wp) on FMA products: n_l = LN(x_l) and d = depthwise(bf16(n_l)) are
// recomputed from the saved x_l, the replay's values bit for bit, and the
// only product left, g_d = bf16(g_p) . bf16(wp)^T, runs on mma.sync. The
// running gradient between the layers goes through g_ws [2, B, T, D] (fp32;
// layer l writes g_ws[l & 1], layer 0 the bf16 dx), written and read by
// the same CTA. What bounds it: the LayerNorm, depthwise and gradient
// passes out of shared memory and the barriers between them, a row's CTA
// in turn through its layers (16 CTAs at the query stream's [16, 12, 128]).
__global__ void __launch_bounds__(kTcTiledThreads, 1)
conv_block_bwd_tc_row_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xs,
                             const uint8_t* __restrict__ mask, ConvParams p,
                             const __nv_bfloat16* __restrict__ wpb, vsl::Dropout drop,
                             const __nv_bfloat16* __restrict__ g, __nv_bfloat16* dx, float* g_ws,
                             __nv_bfloat16* __restrict__ d_ws, __nv_bfloat16* __restrict__ gp_ws,
                             float* __restrict__ part, int SN) {
  const int b = static_cast<int>(blockIdx.x), T = p.T, L = p.L;
  const size_t layer = (size_t)gridDim.x * T * p.D;
  for (int l = L - 1; l >= 0; --l) {
    const uint8_t* mask_l = mask + l * (layer / 4);
    __nv_bfloat16* d_l = d_ws + l * layer;
    __nv_bfloat16* gp_l = gp_ws + l * layer;
    const float* gin = g_ws + ((l + 1) & 1) * layer;
    float* gout = g_ws + (l & 1) * layer;
    const float* in = xs + (l > 0 ? l - 1 : 0) * layer;
    if (l == 0 && L == 1)
      conv_bwd_tc_layer(x, p, l, wpb, mask_l, drop, g, dx, d_l, gp_l, part, b, 0, 1, T, SN);
    else if (l == 0)
      conv_bwd_tc_layer(x, p, l, wpb, mask_l, drop, gin, dx, d_l, gp_l, part, b, 0, 1, T, SN);
    else if (l == L - 1)
      conv_bwd_tc_layer(in, p, l, wpb, mask_l, drop, g, gout, d_l, gp_l, part, b, 0, 1, T, SN);
    else
      conv_bwd_tc_layer(in, p, l, wpb, mask_l, drop, gin, gout, d_l, gp_l, part, b, 0, 1, T, SN);
    __syncthreads();  // G_out written and the shared buffers read before the next layer's loads
  }
}


// --- the bf16 T-tiled forward on the tensor cores (#2 at bf16, tiled) ------
// One launch a layer on ops/kernels.py conv_tiled_fwd_bf16_plan (tiles of F
// frames, bf16(wp)'s columns in slices of SN), no atomics. A CTA takes the
// F own frames [t0, t0 + F) of one row:
//   1. the taps and x_l over the own frames and the depthwise reach [t0 -
//      pad, t0 + nf + K - 1 - pad) (0 outside [0, T)) by cp.async (bf16 x
//      by plain loads), then bf16(wp)'s first slice (the wrapper rounds wp
//      once a call), which lands behind the LayerNorm: n_l = bf16(LN(x_l))
//      into a buffer of its own (x_l stays for the residual), a row in
//      registers (the whole-row forward's sums and expressions);
//   2. d = bf16(depthwise(n_l)) over the own frames (taps_rows, the taps in
//      order), straight into the bf16 A tile [Fp][AST] (Fp = F rounded up
//      to 16 frames, k = D rounded up to Dk, a multiple of 64; padding 0);
//   3. p = d . bf16(wp) on mma.sync m16n8k16 (mma.cuh tile_mma: bf16
//      operands, fp32 sums, each group of 4 k16 steps accumulated in the
//      tensor cores and added by an fp32 add), a warp a (16 frames, 16
//      columns) item, wp's rows as they are by ldmatrix.trans; the epilogue
//      runs on the C fragments: + bp, the ReLU, the dropout (salt 0x100 +
//      l), the ReLU mask [p > 0] for the bf16 backward (a byte a 4 columns:
//      two lanes' pairs joined by a shuffle) and the fp32 residual out of
//      shared memory, x_(l+1) = x_l + drop(relu(p + bp)).
// Where bf16(wp)'s columns do not fit whole, slices of SN columns in turn,
// each with its own epilogue. The product's sums are not the whole-row bf16
// forward's one fmaf chain over k, so the two forms' bits differ where a sum
// rounds otherwise (and a ReLU may flip at a pre-activation within an fp32
// rounding of 0); the bf16 backward reads this kernel's mask, so the pair
// agrees with itself. What bounds it: the x_l window's bytes and the
// LayerNorm and depthwise passes out of shared memory; the product, 2 F D^2
// FLOPs a tile, takes the tensor cores a few hundred cycles.
constexpr int kTcFwdThreads = 512;  // (kernels.py CONV_TILED_THREADS)

// Its shared memory for F frames a tile, K taps and slices of SN columns
// (ops/kernels.py _conv_tiled_fwd_bf16_smem_bytes; the launch uses this
// one), Dk = D rounded up to 64, Fp = F rounded up to 16:
//   X   [F + K - 1][D] float  x_l over the own frames and the reach (the
//                             epilogue's residual)
//   N   [F + K - 1][D] float  n_l = bf16(LN(x_l)), 0 outside [0, T)
//   DW  [K][D] float          the layer's taps
//   A   [Fp][AST] bf16        bf16(d), 0 in its padding
//   W   [Dk][WST] bf16        bf16(wp)'s columns of the slice, 0 past D
struct TcTiledFwdLayout {
  size_t X, DW, A, W;
  int Dk, AST, WST, Fp;
  __host__ __device__ TcTiledFwdLayout(int F, int D, int K, int SN)
      : X((size_t)(F + K - 1) * D), DW((size_t)K * D), Dk((D + 63) / 64 * 64),
        AST(vsl::tc_stride((D + 63) / 64 * 64)), WST(vsl::tc_stride(SN)), Fp((F + 15) / 16 * 16) {
    A = (size_t)Fp * AST;
    W = (size_t)Dk * WST;
  }
  __host__ __device__ size_t bytes() const { return 4 * (2 * X + DW) + 2 * (A + W); }
};

// One layer of the bf16 tiled forward for the tile [t0, t0 + F) of row b:
// xout = xin + drop(relu(bf16(depthwise(bf16(LN(xin)))) . bf16(wp) + bp))
// over the own frames, and the layer's ReLU mask mask_l [B, T, D / 4] (bit
// q of byte c: column 4 c + q). XIn, XOut: the storage types of the
// layer's input and output (bf16 for x and out, fp32 for xs).
template <typename XIn, typename XOut>
__global__ void __launch_bounds__(kTcFwdThreads, 1)
conv_layer_fwd_tc_tiled_kernel(const XIn* __restrict__ xin, ConvParams p, int l,
                               const __nv_bfloat16* __restrict__ wpb, vsl::Dropout drop,
                               XOut* __restrict__ xout, uint8_t* __restrict__ mask_l, int F,
                               int SN) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, K = p.K, pad = (K - 1) / 2, D4 = D / 4;
  const int b = blockIdx.y, t0 = blockIdx.x * F, nf = min(F, T - t0);
  const TcTiledFwdLayout lay(F, D, K, SN);
  float* X = reinterpret_cast<float*>(smem4);
  float* N = X + lay.X;
  float* DW = N + lay.X;
  bf16* A = reinterpret_cast<bf16*>(DW + lay.DW);
  bf16* W = A + lay.A;
  const int Dk = lay.Dk, AST = lay.AST, WST = lay.WST;
  const size_t row = (size_t)b * T * D;
  const float* bpl = p.bp + (size_t)l * D;
  const bf16* wl = wpb + (size_t)l * D * D;
  const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x100u + l);
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. the taps and x_l over [t0 - pad, t0 + nf + K - 1 - pad) by cp.async
  // (bf16 x by 8-byte loads, widened), then the first slice of bf16(wp),
  // which lands behind the LayerNorm
  const int h0 = t0 - pad, lo = max(h0, 0), hi = min(h0 + nf + K - 1, T);
  vsl::cp_async_floats(DW, p.dw + (size_t)l * K * D, K * D);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < (nf + K - 1) * D4; i += nt) {
    const int t = h0 + i / D4;
    const bool in = t >= lo && t < hi;
    const XIn* src = xin + row + (size_t)h0 * D + 4 * i;
    if constexpr (std::is_same<XIn, float>::value) {
      if (in)
        vsl::cp_async_float4(X + 4 * i, src);
      else
        reinterpret_cast<float4*>(X)[i] = zero4;
    } else {
      reinterpret_cast<float4*>(X)[i] = in ? vsl::load4(src) : zero4;
    }
    if (!in) reinterpret_cast<float4*>(N)[i] = zero4;
  }
  vsl::cp_async_commit();
  // bf16(wp)'s columns [c0, c0 + SN) of its rows k < Dk by 16-byte copies
  // (8-byte where D % 8 != 0), 0 past D either way
  const auto load_slice = [&](int c0) {
    const int w = D % 8 ? 4 : 8, q = SN / w;
    for (int i = tid; i < Dk * q; i += nt) {
      const int k = i / q, c = w * (i - k * q);
      const bool on = k < D && c0 + c < D;
      const bf16* src = wl + (on ? (size_t)k * D + c0 + c : 0);
      if (w == 8)
        vsl::cp_async16(W + (size_t)k * WST + c, src, on);
      else
        vsl::cp_async8(W + (size_t)k * WST + c, src, on);
    }
    vsl::cp_async_commit();
  };
  load_slice(0);
  // A's padding: the columns [D, Dk) of every row and the rows [nf, Fp)
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < lay.Fp * (Dk - D); i += nt) {
    const int r = i / (Dk - D);
    A[(size_t)r * AST + D + i - r * (Dk - D)] = zero;
  }
  for (int i = tid; i < (lay.Fp - nf) * D; i += nt) A[(size_t)(nf + i / D) * AST + i % D] = zero;
  vsl::cp_async_wait<1>();  // the taps and x_l (the slice may be in flight)
  __syncthreads();
  // n_l into N, x_l kept in X for the residual
  const size_t own = (size_t)(lo - h0) * D;
  const float* gam = p.gam + (size_t)l * D;
  const float* beta = p.beta + (size_t)l * D;
  if (D <= 128)
    ln_rows_in_registers<4, true>(X + own, N + own, gam, beta, hi - lo, D);
  else  // wider rows than the model's: the same sums out of shared memory
    vsl::layer_norm_rows<true>(X + own, N + own, gam, beta, hi - lo, D);
  __syncthreads();
  // 2. bf16(d) over the own frames: A[r] = sum_j n(t0 + r + j - pad) dw[j]
  taps_rows<false, true, false, bf16>(N, DW, nf, D, K, A, AST);

  // 3. p = bf16(d) . bf16(wp), a slice of columns at a time, and in the
  // epilogue x_(l+1) = x_l + drop(relu(p + bp)) and the mask bits
  const int mtiles = (nf + 15) / 16;
  for (int c0 = 0; c0 < D; c0 += SN) {
    if (c0 > 0) load_slice(c0);
    vsl::cp_async_wait<0>();
    __syncthreads();  // the slice landed; A written (or the last slice read)
    vsl::tile_mma(A, AST, mtiles, W, WST, SN / 16, Dk, [&](int r, int c, float v0, float v1) {
      const int col = c0 + c, t = t0 + r;
      const bool on = r < nf && col < D;  // D % 4 == 0: col < D holds for col + 3 too
      const float2 b2 = on ? __ldg(reinterpret_cast<const float2*>(bpl + col))
                           : make_float2(0.f, 0.f);
      const float a0 = v0 + b2.x, a1 = v1 + b2.y;
      // the backward's [p > 0], as it tested it; the lane of columns col +
      // 2, col + 3 is this one's neighbour (tq ^ 1)
      const uint32_t bits = (a0 > 0.f ? 1u : 0u) | (a1 > 0.f ? 2u : 0u);
      const uint32_t up = __shfl_xor_sync(0xffffffffu, bits, 1);
      if (!on) return;
      const size_t i = row + (size_t)t * D + col;
      if ((c & 2) == 0) mask_l[i / 4] = static_cast<uint8_t>(bits | up << 2);
      const float2 x2 = *reinterpret_cast<const float2*>(X + (size_t)(r + pad) * D + col);
      const float y0 = x2.x + drop.apply(fmaxf(a0, 0.f), seed, salt, t, col);
      const float y1 = x2.y + drop.apply(fmaxf(a1, 0.f), seed, salt, t, col + 1);
      if constexpr (std::is_same<XOut, float>::value)
        *reinterpret_cast<float2*>(xout + i) = make_float2(y0, y1);
      else
        *reinterpret_cast<uint32_t*>(xout + i) = vsl::pack_bf16(y0, y1);
    });
    if (c0 + SN < D) __syncthreads();  // the slice read before the next lands
  }
}

// One layer of the bf16 tiled forward, its kernel picked by the storage
// types of its input and output.
template <typename XIn, typename XOut>
cudaError_t tc_tiled_fwd_layer(const XIn* in, const ConvParams& p, int l,
                               const __nv_bfloat16* wpb, const vsl::Dropout& drop, XOut* o,
                               uint8_t* mask, int B, int F, int SN, size_t smem,
                               cudaStream_t stream) {
  return vsl::launch_opted(conv_layer_fwd_tc_tiled_kernel<XIn, XOut>, dim3(tiles(p.T, F), B),
                           kTcFwdThreads, smem, stream, in, p, l, wpb, drop, o,
                           mask + (size_t)l * B * p.T * (p.D / 4), F, SN);
}

}  // namespace

// The bf16 T-tiled backward (#9 at bf16, tiled) on conv_tiled_bwd_bf16_plan's
// tiles of F frames and wp slices of SN rows: x, g and dx [B, T, D] in bf16;
// xs [L - 1, B, T, D] and mask [L, B, T, D / 4] from the bf16 tiled forward;
// wpb = bf16(wp) [L, D, D]; the weight gradients fp32, dsmall [L, 3 + K, D]
// and dwp [L, D, D]. Workspaces: d_ws, gp_ws [L, B, T, D] bf16, the stream
// between the layers g_ws [2, B, T, D] fp32 (layer l writes g_ws[l & 1],
// only layer 0 the bf16 dx), part [B * ceil(T / F), L, 3 + K, D], gemm_ws
// [L, splits, D, D].
extern "C" int vsl_conv_block_bwd_tiled_bf16(const void* x, const float* xs, const void* mask,
                                             const float* gam, const float* beta,
                                             const float* dw, const void* wpb_, const float* bp,
                                             const float* seeds, unsigned thresh, float scale,
                                             const void* g, void* dx, float* dsmall, float* dwp,
                                             void* d_ws_, void* gp_ws_, float* g_ws, float* part,
                                             float* gemm_ws, int splits, int B, int T, int D,
                                             int L, int K, int F, int SN, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || L < 1 || K < 1 || D < 4 || D % 4 || F < 1 || SN < 16 || SN % 16 ||
      ((D + 63) / 64 * 64) % SN)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = TcTiledBwdLayout(F, D, K, SN).bytes();
  const ConvParams p = make_params(gam, beta, dw, nullptr, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* wpb = static_cast<const bf16*>(wpb_);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  bf16* dxb = static_cast<bf16*>(dx);
  bf16* d_ws = static_cast<bf16*>(d_ws_);
  bf16* gp_ws = static_cast<bf16*>(gp_ws_);
  const size_t layer = (size_t)B * T * D;
  cudaError_t err = cudaSuccess;
  for (int l = L - 1; l >= 0 && err == cudaSuccess; --l) {
    bf16* d_l = d_ws + l * layer;
    bf16* gp_l = gp_ws + l * layer;
    const float* gin = g_ws + ((l + 1) & 1) * layer;
    float* gout = g_ws + (l & 1) * layer;
    const float* in = l > 0 ? xs + (l - 1) * layer : xs;
    if (l == 0 && L == 1)
      err = tc_tiled_bwd_layer(xb, p, l, wpb, mk, drop, gb, dxb, d_l, gp_l, part, B, F, SN, smem,
                               stream);
    else if (l == 0)
      err = tc_tiled_bwd_layer(xb, p, l, wpb, mk, drop, gin, dxb, d_l, gp_l, part, B, F, SN, smem,
                               stream);
    else if (l == L - 1)
      err = tc_tiled_bwd_layer(in, p, l, wpb, mk, drop, gb, gout, d_l, gp_l, part, B, F, SN, smem,
                               stream);
    else
      err = tc_tiled_bwd_layer(in, p, l, wpb, mk, drop, gin, gout, d_l, gp_l, part, B, F, SN,
                               smem, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vsl::sum_partials(part, dsmall, 1, B * tiles(T, F), L * (3 + K) * D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vsl::wgrad_tc(static_cast<const bf16*>(d_ws), gp_ws, dwp, gemm_ws, L, D,
                                        D, B * T, splits, stream));
}

// The bf16 whole-row backward (#9 at bf16) on conv_bwd_bf16_plan's CTA a
// row and slices of SN of bf16(wp)'s rows, from the bf16 whole-row
// forward's xs [L - 1, B, T, D] and mask [L, B, T, D / 4]; the arguments
// and workspaces of vsl_conv_block_bwd_tiled_bf16 (part [B, L, 3 + K, D]).
extern "C" int vsl_conv_block_bwd_bf16(const void* x, const float* xs, const void* mask,
                                       const float* gam, const float* beta, const float* dw,
                                       const void* wpb, const float* bp, const float* seeds,
                                       unsigned thresh, float scale, const void* g, void* dx,
                                       float* dsmall, float* dwp, void* d_ws_, void* gp_ws_,
                                       float* g_ws, float* part, float* gemm_ws, int splits,
                                       int B, int T, int D, int L, int K, int SN, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || L < 1 || K < 1 || D < 4 || D % 4 || SN < 16 || SN % 16 ||
      ((D + 63) / 64 * 64) % SN)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvParams p = make_params(gam, beta, dw, nullptr, bp, T, D, L, K);
  bf16* d_ws = static_cast<bf16*>(d_ws_);
  bf16* gp_ws = static_cast<bf16*>(gp_ws_);
  cudaError_t err = vsl::launch_opted(
      conv_block_bwd_tc_row_kernel, dim3(B), kTcTiledThreads, TcTiledBwdLayout(T, D, K, SN).bytes(),
      stream, static_cast<const bf16*>(x), xs, static_cast<const uint8_t*>(mask), p,
      static_cast<const bf16*>(wpb), vsl::Dropout{seeds, thresh, scale}, static_cast<const bf16*>(g),
      static_cast<bf16*>(dx), g_ws, d_ws, gp_ws, part, SN);
  if (err == cudaSuccess) err = vsl::sum_partials(part, dsmall, 1, B, L * (3 + K) * D, stream);
  if (err == cudaSuccess)
    err = vsl::wgrad_tc(static_cast<const bf16*>(d_ws), gp_ws, dwp, gemm_ws, L, D, D, B * T,
                        splits, stream);
  return static_cast<int>(err);
}

// The bf16 T-tiled forward (#2 at bf16, tiled) on the tensor cores, on
// conv_tiled_fwd_bf16_plan's tiles of F frames and slices of SN of
// bf16(wp)'s columns: x and out [B, T, D] in bf16, wpb = bf16(wp) [L, D, D]
// (the function's rounding of wp, made once a call), the stream between
// the layers, xs [L - 1, B, T, D], in fp32, and each layer's ReLU mask,
// mask [L, B, T, D / 4] bytes, for the bf16 backward. L launches: layer l
// reads `l == 0 ? x : xs[l - 1]` and writes `l == L - 1 ? out : xs[l]`.
extern "C" int vsl_conv_block_fwd_tiled_bf16(const void* x, const float* gam, const float* beta,
                                             const float* dw, const void* wpb, const float* bp,
                                             const float* seeds, unsigned thresh, float scale,
                                             float* xs, void* mask, void* out, int B, int T,
                                             int D, int L, int K, int F, int SN, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || L < 1 || K < 1 || D < 4 || D % 4 || F < 1 || SN < 16 || SN % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = TcTiledFwdLayout(F, D, K, SN).bytes();
  const ConvParams p = make_params(gam, beta, dw, nullptr, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w = static_cast<const bf16*>(wpb);
  bf16* ob = static_cast<bf16*>(out);
  uint8_t* mk = static_cast<uint8_t*>(mask);
  const size_t layer = (size_t)B * T * D;
  cudaError_t err = L == 1
                        ? tc_tiled_fwd_layer(xb, p, 0, w, drop, ob, mk, B, F, SN, smem, stream)
                        : tc_tiled_fwd_layer(xb, p, 0, w, drop, xs, mk, B, F, SN, smem, stream);
  for (int l = 1; l < L && err == cudaSuccess; ++l) {
    const float* in = xs + (l - 1) * layer;
    err = l == L - 1
              ? tc_tiled_fwd_layer(in, p, l, w, drop, ob, mk, B, F, SN, smem, stream)
              : tc_tiled_fwd_layer(in, p, l, w, drop, xs + l * layer, mk, B, F, SN, smem, stream);
  }
  return static_cast<int>(err);
}

namespace {

// --- the bf16 conv block at the widths the tiled kernels do not take --------
// #2c and #9c at D = 896 and 1024 (ops/kernels.py conv_wide_plan; the JAX
// bench's `saturated` configuration runs hidden 1024). The tiled kernels
// keep a tile's rows and wp's slices in shared memory and run each layer's
// pointwise product per tile: at D = 1024 the bf16 backward needs 242 KB a
// tile of 8 frames, and a product of so few frames would re-read the 2 MB
// of bf16(wp) once a tile. So each layer is split at its product:
//   - the per-frame work on CTAs of strips of frames a row (ops/kernels.py
//     conv_wide_plan), streamed a few frames at a time (below), the column
//     sums (dbp, dgam, dbeta, ddw) carried over the strip and written once
//     a strip;
//   - the product [B T, D] x [D, D] over every frame at once on mma.cuh's
//     tc_gemm (wgmma, operands by TMA), the layer's epilogue fused into it.
// Forward, a layer: (1) conv_wide_d_kernel for layer l alone: d =
// bf16(depthwise(bf16(LN(x_l)))) into a bf16 workspace, the backward's d
// bit for bit; (2) tc_gemm d . bf16(wp) (the wrapper rounds wp once a call) with
// ConvWideFwdEpi: p = . + bp, the ReLU mask [p > 0] the backward reads
// (bits of 4 columns a byte, two lanes' pairs joined by a shuffle),
// x_(l+1) = x_l + drop(relu(p)), fp32 between the layers.
// Backward, layers in reverse, L + 1 per-frame launches beside the
// products: (1) conv_wide_d_kernel, once for all layers: d_l =
// bf16(depthwise(bf16(LN_l(x_l)))) (dwp's operand) and, for the top layer,
// g_p = [p > 0] drop(g) from the mask, bf16(g_p) to dwp's workspace, dbp
// summing the unrounded g_p; (2) per layer, tc_gemm g_d = bf16(g_p) .
// bf16(wp)^T (wp's rows as they are stored) into an fp32 workspace; (3)
// conv_wide_pass_kernel: ddw from the UNROUNDED n_l against g_d, g_n the
// depthwise transpose of g_d, the LayerNorm backward (dgam, dbeta), G_out =
// G_in + dx_ln and, below the top layer, the next layer down's g_p =
// [p > 0] drop(G_out) from the same frames' G_out, its bf16 copy and dbp
// (its prologue, fused into the pass above it). Then dwp = sum bf16(d)^T .
// bf16(g_p) on wgrad_wg and the partials summed in a fixed order. The
// function, rounding for rounding, is the tiled bf16 kernels'; no atomics.
// The per-frame launches take a CTA of D / 4 threads a strip of S frames of
// a row (conv_wide_plan's strip: one CTA a row at `saturated`), four
// columns a thread. A column's frames stream through rings of shared
// memory that only its own thread reads, kWideBwdFrames frames a batch by
// cp.async, the next batch in flight while the thread works on the current
// one: x_l (then xh, or n) and g_d over the depthwise reach, G_in over the
// own frames; its taps, dw, ddw, dgam, dbeta and dbp sums stay in
// registers. The rows' sums (each new frame's LayerNorm mean and
// variance, each own frame's two LN backward means) are block sums in a
// fixed order (a warp's by shuffles, then the warps' in order), two
// barriers a batch. 88-97 KB of shared memory a CTA at D = 1024, so two
// CTAs share an SM. Each frame's statistics are taken once a launch.
// What bounds them: the products, 2 B T D^2 FLOPs a layer forward and two
// such backward plus dwp's, on the tensor cores (at `saturated`, 69 GFLOP
// a product); the per-frame passes move each layer's [B, T, D] rows a few
// times (x, G, g_d, the bf16 workspaces).

// The forward product's epilogue for layer l: x_(l+1) = x_l +
// drop(relu(d . wp + bp)) at frame m = b T + t, and the ReLU mask.
template <typename XIn, typename XOut>
struct ConvWideFwdEpi {
  const XIn* xin;
  XOut* xout;
  uint8_t* mask;    // layer l's [B, T, D / 4]
  const float* bp;  // layer l's [D]
  vsl::Dropout drop;
  uint32_t salt;
  int M, T, D;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const float p0 = v0 + __ldg(bp + n), p1 = v1 + __ldg(bp + n + 1);
    // columns 4c..4c+3 are lanes 4g + 2h and 4g + 2h + 1's pairs (n % 4 = 0, 2)
    uint32_t bits = ((p0 > 0.f ? 1u : 0u) | (p1 > 0.f ? 2u : 0u)) << (n & 2);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
    if (m >= M) return;
    const size_t i = (size_t)m * D + n;
    if ((n & 2) == 0) mask[i / 4] = static_cast<uint8_t>(bits);
    const int b = m / T, t = m - b * T;
    const uint32_t seed = drop.seed(b);
    const float y0 = drop.apply(fmaxf(p0, 0.f), seed, salt, t, n);
    const float y1 = drop.apply(fmaxf(p1, 0.f), seed, salt, t, n + 1);
    xout[i] = vsl::from_float<XOut>(vsl::to_float(xin[i]) + y0);
    xout[i + 1] = vsl::from_float<XOut>(vsl::to_float(xin[i + 1]) + y1);
  }
};

// --- the backward's per-frame passes ----------------------------------------
// Frames a batch of the pass's and the d launch's streams (ops/kernels.py
// WIDE_BWD_FRAMES, WIDE_D_FRAMES) and the taps they are built for (the
// model's; conv_wide_plan refuses others).
constexpr int kWideBwdFrames = 2;
constexpr int kWideDFrames = 4;
constexpr int kWideBwdK = 7;
constexpr int kWideBwdMaxThreads = 256;  // D / 4 at D = 1024

// Frames a ring of batches of F holds: an own frame's reach on either side
// (K - 1 - pad frames, pad = (K - 1) / 2) twice, the batch in use and the
// one in flight.
__host__ __device__ constexpr int wide_bwd_ring(int K, int F) {
  return 2 * F + 2 * (K - 1 - (K - 1) / 2);
}

// Their shared memory in bytes (ops/kernels.py _conv_wide_pass_bytes,
// _conv_wide_d_bytes), D / 128 warps: the pass X, GD [R][D], GI [2F][D],
// inv [R] and two reductions [D / 128][3F] (F = kWideBwdFrames); the d
// launch X [R][D], GI [2F][D] and two reductions [D / 128][F] (F =
// kWideDFrames); R = wide_bwd_ring(K, F).
__host__ __device__ inline size_t wide_pass_bytes(int D, int K) {
  const int F = kWideBwdFrames, R = wide_bwd_ring(K, F);
  return 4 * ((2 * (size_t)R + 2 * F) * D + R + 2 * (size_t)(D / 128) * 3 * F);
}
__host__ __device__ inline size_t wide_d_bytes(int D, int K) {
  const int F = kWideDFrames, R = wide_bwd_ring(K, F);
  return 4 * (((size_t)R + 2 * F) * D + 2 * (size_t)(D / 128) * F);
}

using vsl::block_sums;
using vsl::cp_async8;
using vsl::cp_row4;
using vsl::fma4;
using vsl::ld4;
using vsl::slot4;
using vsl::st4;
using vsl::sum4;

// g_p = [p > 0] drop(v) of 4 columns (mask bits 0-3) at (t, c..c+3) of
// layer `salt`'s site, bf16(g_p) stored at gp, the unrounded g_p added to s
__device__ __forceinline__ void put_gp(float4 v, uint32_t bits, const vsl::Dropout& drop,
                                       uint32_t seed, uint32_t salt, int t, int c,
                                       __nv_bfloat16* gp, float4& s) {
  const float in[4] = {v.x, v.y, v.z, v.w};
  float o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = (bits >> q) & 1u ? drop.apply(in[q], seed, salt, t, c + q) : 0.f;
  *reinterpret_cast<uint2*>(gp) =
      make_uint2(vsl::pack_bf16(o[0], o[1]), vsl::pack_bf16(o[2], o[3]));
  s = make_float4(s.x + o[0], s.y + o[1], s.z + o[2], s.w + o[3]);
}

// A thread's view of a pass's stream over the strip [s0, s1) of row b: its
// frames e = a + i F + k (batch i, k < F) land in ring slot (e - a) % R,
// its own frame t = e - gl of batch i (its reach has landed) is worked in
// it, its G_in in slot (i F + k) % 2F of a ring of two batches.
template <int K, int F_>
struct WideStream {
  static constexpr int F = F_, PAD = (K - 1) / 2, GL = K - 1 - PAD, R = wide_bwd_ring(K, F);
  int a, nb, s0, s1, T;
  __device__ int own(int i, int k) const { return a + i * F + k - GL; }
  __device__ bool owned(int t) const { return t >= s0 && t < s1; }
  __device__ int slot(int e) const { return (e - a) % R; }
  // the frames to load: inside [0, T), none past the strip's last reach
  __device__ bool loads(int e) const { return e >= 0 && e < T && e < s1 + GL; }
};

// d_l = bf16(depthwise(bf16(LN_l(x_l)))) for layer l = l0 + blockIdx.z
// over the strip [s0, s0 + S) of row b = blockIdx.y into d_all's layer
// blockIdx.z [B, T, D]: the forward's prologue of one layer (grid z 1, g
// null) and the backward's (1), every layer at once, where with g the top
// layer also takes its g_p from g and mask_top, with dbp into its slot of
// part [B * strips, L, 3 + K, D]. One kernel makes d both ways, so the
// backward's dwp reads the forward's operand bit for bit. x_l: x (bf16)
// for layer 0, else xs[l - 1] (fp32). A thread's columns [4 tid, 4 tid +
// 4): its frames e = s0 - pad + i F + k stream into the ring X (n once the
// frame's statistics are known), own frame t = e - (K - 1 - pad) once its
// reach has landed.
template <int K>
__global__ void __launch_bounds__(kWideBwdMaxThreads, 2)
conv_wide_d_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xs, ConvParams p,
                   int S, int l0, __nv_bfloat16* __restrict__ d_all,
                   const uint8_t* __restrict__ mask_top, vsl::Dropout drop,
                   const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ gp_top,
                   float* __restrict__ part) {
  using W = WideStream<K, kWideDFrames>;
  constexpr int F = W::F, PAD = W::PAD, R = W::R;
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, l = l0 + blockIdx.z, tid = threadIdx.x, c = 4 * tid;
  const int nw = blockDim.x >> 5;
  const int b = blockIdx.y, s0 = blockIdx.x * S, s1 = min(T, s0 + S);
  const W w{s0 - PAD, (s1 - s0 + K - 1 + F - 1) / F, s0, s1, T};
  const bool top = g != nullptr && l == p.L - 1, xb = l == 0;
  const size_t layer = (size_t)gridDim.y * T * D, row = (size_t)b * T * D;
  const void* xin =
      xb ? static_cast<const void*>(x) : static_cast<const void*>(xs + (l - 1) * layer);
  float* X = reinterpret_cast<float*>(smem4);  // [R][D]
  float* GI = X + (size_t)R * D;               // [2F][D]
  float* RED = GI + (size_t)2 * F * D;         // [2][nw][F]
  const float4 gam = ld4(p.gam + (size_t)l * D + c), beta = ld4(p.beta + (size_t)l * D + c);
  float4 dw[K];
#pragma unroll
  for (int j = 0; j < K; ++j) dw[j] = ld4(p.dw + ((size_t)l * K + j) * D + c);
  const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x100u + l);
  float4 sp = make_float4(0.f, 0.f, 0.f, 0.f);
  // batch i's frames into the ring, the top layer's G_in of its own frames
  // into GI (one commit group); their mask bytes, frame k in byte k
  const auto issue = [&](int i) {
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int e = w.a + i * F + k, t = w.own(i, k);
      const bool on = w.loads(e), own = top && w.owned(t);
      cp_row4(X + (size_t)w.slot(e) * D + c, xin, row + (size_t)(on ? e : 0) * D + c, xb, on);
      if (top)
        cp_async8(GI + (size_t)((i * F + k) % (2 * F)) * D + c,
                  g + row + (size_t)(own ? t : 0) * D + c, own);
    }
    vsl::cp_async_commit();
  };
  const auto bits_of = [&](int i) {
    uint32_t m = 0;
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int t = w.own(i, k);
      if (top && w.owned(t)) m |= (uint32_t)mask_top[(row + (size_t)t * D) / 4 + tid] << (8 * k);
    }
    return m;
  };
  issue(0);
  uint32_t bits = bits_of(0);
  for (int i = 0; i < w.nb; ++i) {
    uint32_t next = 0;
    if (i + 1 < w.nb) {
      issue(i + 1);
      next = bits_of(i + 1);
      vsl::cp_async_wait<1>();
    } else {
      vsl::cp_async_wait<0>();
    }
    // the new frames' statistics, then n = bf16(LN(x)) in place (0 outside [0, T))
    float4 xn[F];
    float r1[F], r2[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      xn[k] = slot4(X + (size_t)w.slot(w.a + i * F + k) * D + c, xb);
      r1[k] = sum4(xn[k]);
    }
    block_sums<F>(r1, RED);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const float mean = r1[k] / D;
      xn[k] = make_float4(xn[k].x - mean, xn[k].y - mean, xn[k].z - mean, xn[k].w - mean);
      r2[k] = ((xn[k].x * xn[k].x + xn[k].y * xn[k].y) + xn[k].z * xn[k].z) + xn[k].w * xn[k].w;
    }
    block_sums<F>(r2, RED + nw * F);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int e = w.a + i * F + k;
      const float inv = rsqrtf(r2[k] / D + vsl::kLnEps);
      float4 n = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e >= 0 && e < T)
        n = make_float4(vsl::bf16_round(xn[k].x * inv * gam.x + beta.x),
                        vsl::bf16_round(xn[k].y * inv * gam.y + beta.y),
                        vsl::bf16_round(xn[k].z * inv * gam.z + beta.z),
                        vsl::bf16_round(xn[k].w * inv * gam.w + beta.w));
      st4(X + (size_t)w.slot(e) * D + c, n);
    }
    // the own frames: d = bf16(sum_j n(t + j - pad) dw[j]), the top layer's g_p
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int t = w.own(i, k);
      if (!w.owned(t)) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < K; ++j) acc = fma4(ld4(X + (size_t)w.slot(t + j - PAD) * D + c), dw[j], acc);
      const size_t o = (size_t)blockIdx.z * layer + row + (size_t)t * D + c;
      *reinterpret_cast<uint2*>(d_all + o) =
          make_uint2(vsl::pack_bf16(acc.x, acc.y), vsl::pack_bf16(acc.z, acc.w));
      if (top)
        put_gp(slot4(GI + (size_t)((i * F + k) % (2 * F)) * D + c, true), (bits >> (8 * k)) & 0xFu,
               drop, seed, salt, t, c, gp_top + row + (size_t)t * D + c, sp);
    }
    bits = next;
  }
  if (top) st4(part + ((size_t)(b * gridDim.x + blockIdx.x) * p.L + l) * (3 + K) * D + 2 * D + c, sp);
}

// (3) layer l's pass over the strip [s0, s0 + S) of row b after its g_d
// (gd [B, T, D], 0 outside [0, T)): ddw, g_n, the LN backward (dgam,
// dbeta), G_out = G_in + dx_ln; with mask_prev (l > 0) also layer l - 1's
// g_p from G_out, bf16 into gp_prev, dbp into layer l - 1's slot. x_l and
// G_in in bf16 (xb, gb: layer 0's x, the block's g) or fp32, G_out in bf16
// (ob: layer 0's dx) or fp32. A thread's columns [4 tid, 4 tid + 4): its
// frames e = s0 - gl + i F + k (gl = K - 1 - pad) stream into the rings X
// (xh once the frame's statistics are known) and GD, own frame t = e - gl
// (its reach landed) into GI; an own frame's inverse deviation is from an
// earlier batch (F <= gl), kept in inv by thread 0.
template <int K>
__global__ void __launch_bounds__(kWideBwdMaxThreads, 2)
conv_wide_pass_kernel(const void* __restrict__ xin, bool xb, ConvParams p, int l, int S,
                      const float* __restrict__ gd, const void* __restrict__ gin, bool gb,
                      void* __restrict__ gout, bool ob, const uint8_t* __restrict__ mask_prev,
                      __nv_bfloat16* __restrict__ gp_prev, vsl::Dropout drop,
                      float* __restrict__ part) {
  using bf16 = __nv_bfloat16;
  using W = WideStream<K, kWideBwdFrames>;
  constexpr int F = W::F, PAD = W::PAD, GL = W::GL, R = W::R;
  static_assert(F <= GL, "an own frame's statistics come from an earlier batch");
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, tid = threadIdx.x, c = 4 * tid;
  const int nw = blockDim.x >> 5;
  const int b = blockIdx.y, s0 = blockIdx.x * S, s1 = min(T, s0 + S);
  const W w{s0 - GL, (s1 - s0 + 2 * GL + F - 1) / F, s0, s1, T};
  const size_t row = (size_t)b * T * D;
  float* X = reinterpret_cast<float*>(smem4);  // [R][D]
  float* GD = X + (size_t)R * D;               // [R][D]
  float* GI = GD + (size_t)R * D;              // [2F][D]
  float* INV = GI + (size_t)2 * F * D;         // [R]
  float* RED = INV + R;                        // [2][nw][3F]
  const float4 gam = ld4(p.gam + (size_t)l * D + c), beta = ld4(p.beta + (size_t)l * D + c);
  float4 dw[K], ddw[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    dw[j] = ld4(p.dw + ((size_t)l * K + j) * D + c);
    ddw[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 sg = make_float4(0.f, 0.f, 0.f, 0.f), sb = sg, sp = sg;
  const uint32_t seed = drop.seed(b), salt = vsl::site_salt(0x100u + l - 1);
  const auto at = [&](float* ring, int e) { return ring + (size_t)w.slot(e) * D + c; };
  const auto gi_at = [&](int i, int k) { return GI + (size_t)((i * F + k) % (2 * F)) * D + c; };
  // batch i's frames into the rings, its own frames' G_in into GI (one
  // commit group)
  const auto issue = [&](int i) {
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int e = w.a + i * F + k, t = w.own(i, k);
      const bool on = w.loads(e), own = w.owned(t);
      const size_t o = row + (size_t)(on ? e : 0) * D + c;
      cp_row4(at(X, e), xin, o, xb, on);
      vsl::cp_async16(at(GD, e), gd + o, on);
      cp_row4(gi_at(i, k), gin, row + (size_t)(own ? t : 0) * D + c, gb, own);
    }
    vsl::cp_async_commit();
  };
  const auto bits_of = [&](int i) {  // the own frames' mask bytes, frame k in byte k
    uint32_t m = 0;
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int t = w.own(i, k);
      if (mask_prev && w.owned(t))
        m |= (uint32_t)mask_prev[(row + (size_t)t * D) / 4 + tid] << (8 * k);
    }
    return m;
  };
  issue(0);
  uint32_t bits = bits_of(0);
  for (int i = 0; i < w.nb; ++i) {
    uint32_t next = 0;
    if (i + 1 < w.nb) {
      issue(i + 1);
      next = bits_of(i + 1);
      vsl::cp_async_wait<1>();
    } else {
      vsl::cp_async_wait<0>();
    }
    // round 1: the new frames' sums; the own frames' g_n(t) = sum_j g_d(t +
    // pad - j) dw[j] and the LN backward's sums of dxh = g_n gam and dxh xh
    float4 xn[F], gn[F];
    float r1[3 * F], r2[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int t = w.own(i, k);
      xn[k] = slot4(at(X, w.a + i * F + k), xb);
      r1[k] = sum4(xn[k]);
      r1[F + 2 * k] = r1[F + 2 * k + 1] = 0.f;
      gn[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!w.owned(t)) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) gn[k] = fma4(ld4(at(GD, t + PAD - j)), dw[j], gn[k]);
      const float4 xh = ld4(at(X, t));
      const float4 dxh = make_float4(gn[k].x * gam.x, gn[k].y * gam.y, gn[k].z * gam.z,
                                     gn[k].w * gam.w);
      r1[F + 2 * k] = sum4(dxh);
      r1[F + 2 * k + 1] = ((dxh.x * xh.x + dxh.y * xh.y) + dxh.z * xh.z) + dxh.w * xh.w;
      sg = fma4(gn[k], xh, sg);
      sb = make_float4(sb.x + gn[k].x, sb.y + gn[k].y, sb.z + gn[k].z, sb.w + gn[k].w);
    }
    block_sums<3 * F>(r1, RED);
    // round 2: the new frames' variances; then xh in place
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const float mean = r1[k] / D;
      xn[k] = make_float4(xn[k].x - mean, xn[k].y - mean, xn[k].z - mean, xn[k].w - mean);
      r2[k] = ((xn[k].x * xn[k].x + xn[k].y * xn[k].y) + xn[k].z * xn[k].z) + xn[k].w * xn[k].w;
    }
    block_sums<F>(r2, RED + nw * 3 * F);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int e = w.a + i * F + k;
      const float inv = rsqrtf(r2[k] / D + vsl::kLnEps);
      st4(at(X, e), make_float4(xn[k].x * inv, xn[k].y * inv, xn[k].z * inv, xn[k].w * inv));
      if (tid == 0) INV[w.slot(e)] = inv;
    }
    // the own frames: dx_ln, G_out, layer l - 1's g_p, ddw[j] += n(t + j -
    // pad) g_d(t) with the unrounded n = xh gam + beta (0 outside [0, T))
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const int t = w.own(i, k);
      if (!w.owned(t)) continue;
      const float m1 = r1[F + 2 * k] / D, m2 = r1[F + 2 * k + 1] / D, inv = INV[w.slot(t)];
      const float4 xh = ld4(at(X, t));
      const float4 gi = slot4(gi_at(i, k), gb);
      const float4 go =
          make_float4(gi.x + inv * (gn[k].x * gam.x - m1 - xh.x * m2),
                      gi.y + inv * (gn[k].y * gam.y - m1 - xh.y * m2),
                      gi.z + inv * (gn[k].z * gam.z - m1 - xh.z * m2),
                      gi.w + inv * (gn[k].w * gam.w - m1 - xh.w * m2));
      const size_t o = row + (size_t)t * D + c;
      if (ob)
        *reinterpret_cast<uint2*>(static_cast<bf16*>(gout) + o) =
            make_uint2(vsl::pack_bf16(go.x, go.y), vsl::pack_bf16(go.z, go.w));
      else
        st4(static_cast<float*>(gout) + o, go);
      if (mask_prev) put_gp(go, (bits >> (8 * k)) & 0xFu, drop, seed, salt, t, c, gp_prev + o, sp);
      const float4 g = ld4(at(GD, t));
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int e = t + j - PAD;
        if (e < 0 || e >= T) continue;
        const float4 h = ld4(at(X, e));
        const float4 n = make_float4(h.x * gam.x + beta.x, h.y * gam.y + beta.y,
                                     h.z * gam.z + beta.z, h.w * gam.w + beta.w);
        ddw[j] = fma4(n, g, ddw[j]);
      }
    }
    bits = next;
  }
  float* pr = part + ((size_t)(b * gridDim.x + blockIdx.x) * p.L + l) * (3 + K) * D;
  st4(pr + c, sg);
  st4(pr + D + c, sb);
#pragma unroll
  for (int j = 0; j < K; ++j) st4(pr + (size_t)(3 + j) * D + c, ddw[j]);
  if (mask_prev) st4(pr - (size_t)(3 + K) * D + 2 * D + c, sp);
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<bf16>) where bf16, else f(Tag<float>).
template <typename F>
cudaError_t by_type(bool bf16, F f) {
  return bf16 ? f(Tag<__nv_bfloat16>{}) : f(Tag<float>{});
}

// The per-frame launches take the model's taps and 4 columns a thread.
bool wide_ok(int B, int T, int D, int L, int K, int S) {
  return B >= 1 && T >= 1 && L >= 1 && K == kWideBwdK && D % vsl::kGemmN == 0 &&
         D / 4 <= kWideBwdMaxThreads && S >= 1 && wide_pass_bytes(D, K) <= 232448;
}

}  // namespace

// #2c at the wide widths (conv_wide_plan's strips of S frames): x and out
// [B, T, D] bf16, wpb = bf16(wp) [L, D, D], xs [L - 1, B, T, D] fp32 and
// mask [L, B, T, D / 4] as the tiled bf16 forward writes them; d_ws [B, T,
// D] bf16, the product's operand, reused by every layer. A layer: its d by
// the backward's d kernel (grid z 1), then its product.
extern "C" int vsl_conv_block_fwd_wide_bf16(const void* x, const float* gam, const float* beta,
                                            const float* dw, const void* wpb, const float* bp,
                                            const float* seeds, unsigned thresh, float scale,
                                            float* xs, void* mask, void* out, void* d_ws, int B,
                                            int T, int D, int L, int K, int S, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (!wide_ok(B, T, D, L, K, S)) return static_cast<int>(cudaErrorInvalidValue);
  const ConvParams p = make_params(gam, beta, dw, nullptr, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  const size_t layer = (size_t)B * T * D;
  const int M = B * T;
  bf16* d = static_cast<bf16*>(d_ws);
  const bf16* wb = static_cast<const bf16*>(wpb);
  uint8_t* mk = static_cast<uint8_t*>(mask);
  const dim3 grid((T + S - 1) / S, B);
  cudaError_t err = cudaSuccess;
  for (int l = 0; l < L && err == cudaSuccess; ++l) {
    const void* in = l == 0 ? x : static_cast<const void*>(xs + (l - 1) * layer);
    void* o = l == L - 1 ? out : static_cast<void*>(xs + l * layer);
    err = vsl::launch_opted(conv_wide_d_kernel<kWideBwdK>, grid, D / 4, wide_d_bytes(D, K), stream,
                            static_cast<const bf16*>(x), xs, p, S, l, d, nullptr, drop, nullptr,
                            nullptr, nullptr);
    if (err != cudaSuccess) break;
    err = by_type(l == 0, [&](auto it) {
      using XIn = typename decltype(it)::type;
      const XIn* xin = static_cast<const XIn*>(in);
      return by_type(l == L - 1, [&](auto ot) {
        using XOut = typename decltype(ot)::type;
        const ConvWideFwdEpi<XIn, XOut> epi{xin, static_cast<XOut*>(o),
                                            mk + l * layer / 4, bp + (size_t)l * D, drop,
                                            vsl::site_salt(0x100u + l), M, T, D};
        return vsl::tc_gemm<false>(d, wb + (size_t)l * D * D, M, D, D, D, D, epi, stream);
      });
    });
  }
  return static_cast<int>(err);
}

// #9c at the wide widths, from the wide forward's xs and mask: x, g and dx
// [B, T, D] bf16; wpb = bf16(wp) [L, D, D]; dsmall [L, 3 + K, D] (dgam,
// dbeta, dbp, ddw) and dwp [L, D, D] fp32. Workspaces: d_ws, gp_ws [L, B,
// T, D] bf16 (dwp's operands), gd_ws [B, T, D] fp32 (a layer's g_d), g_ws
// [2, B, T, D] fp32 (the stream between the layers, as the tiled bf16
// backward's), part [B * ceil(T / S), L, 3 + K, D], gemm_ws [L, splits, D,
// D]. The passes on strips of S frames (conv_wide_plan's strip).
extern "C" int vsl_conv_block_bwd_wide_bf16(const void* x, const float* xs, const void* mask,
                                            const float* gam, const float* beta,
                                            const float* dw, const void* wpb, const float* bp,
                                            const float* seeds, unsigned thresh, float scale,
                                            const void* g, void* dx, float* dsmall, float* dwp,
                                            void* d_ws, void* gp_ws, float* gd_ws, float* g_ws,
                                            float* part, float* gemm_ws, int splits, int B,
                                            int T, int D, int L, int K, int S, void* stream_) {
  using bf16 = __nv_bfloat16;
  constexpr int KW = kWideBwdK;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (!wide_ok(B, T, D, L, K, S)) return static_cast<int>(cudaErrorInvalidValue);
  const ConvParams p = make_params(gam, beta, dw, nullptr, bp, T, D, L, K);
  const vsl::Dropout drop{seeds, thresh, scale};
  const size_t layer = (size_t)B * T * D;
  const int M = B * T, threads = D / 4;
  const bf16* wb = static_cast<const bf16*>(wpb);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  bf16* d_all = static_cast<bf16*>(d_ws);
  bf16* gp_all = static_cast<bf16*>(gp_ws);
  const dim3 grid((T + S - 1) / S, B);
  cudaError_t err = vsl::launch_opted(
      conv_wide_d_kernel<KW>, dim3(grid.x, B, L), threads, wide_d_bytes(D, K), stream,
      static_cast<const bf16*>(x), xs, p, S, 0, d_all, mk + (L - 1) * layer / 4, drop,
      static_cast<const bf16*>(g), gp_all + (L - 1) * layer, part);
  for (int l = L - 1; l >= 0 && err == cudaSuccess; --l) {
    const void* in = l == 0 ? x : static_cast<const void*>(xs + (l - 1) * layer);
    const void* gin = l == L - 1 ? g : static_cast<const void*>(g_ws + ((l + 1) & 1) * layer);
    void* gout = l == 0 ? dx : static_cast<void*>(g_ws + (l & 1) * layer);
    err = vsl::tc_gemm<true>(gp_all + l * layer, wb + (size_t)l * D * D, M, D, D, D, D,
                             vsl::TcStoreRows{gd_ws, M, D}, stream);
    if (err == cudaSuccess)
      err = vsl::launch_opted(conv_wide_pass_kernel<KW>, grid, threads, wide_pass_bytes(D, K),
                              stream, in, l == 0, p, l, S, static_cast<const float*>(gd_ws), gin,
                              l == L - 1, gout, l == 0,
                              l > 0 ? mk + (l - 1) * layer / 4 : nullptr,
                              l > 0 ? gp_all + (l - 1) * layer : nullptr, drop, part);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vsl::sum_partials(part, dsmall, 1, B * grid.x, L * (3 + K) * D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vsl::wgrad_wg(static_cast<const bf16*>(d_ws), gp_all, dwp, gemm_ws, L,
                                        D, D, B * T, splits, stream));
}
