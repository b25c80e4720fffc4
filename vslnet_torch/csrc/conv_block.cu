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
// Forward: all L layers in one launch, one block per batch row. The row's
// [T, D] residual stream X, its normalised copy N and the depthwise output
// Dw stay in dynamic shared memory for all layers (3*T*D*4 bytes: 192 KB at
// T = D = 128), so nothing goes back to device memory between layers.
// Ragged T (the query stream's max_w) is masked in every stage.
//
// Backward: the TPU kernel keeps every layer's residuals (x_in, n, xh, inv,
// d, p) of a row in VMEM; a Hopper block has room for three [T, D] tiles.
// So one block per row first replays the forward and writes each layer's
// input to a workspace xs [L, B, T, D] (4 MB at the served shapes,
// L2-resident), then walks the layers backwards, recomputing LN, the
// depthwise output and the pre-ReLU from xs, with the dropout masks
// regenerated from the same seeds. It writes dx, per-row partials of dgam,
// dbeta, dbp and ddw, and each layer's depthwise output d and pointwise
// gradient g_p to workspaces; dwp = sum over rows of d^T . g_p is then a
// deterministic split-K product (common.cuh wgrad), and the per-row
// partials are summed over the batch in a fixed order.
//
// What bounds them: the pointwise products, 2*T*D*D FLOPs a layer (three
// such products a layer in the backward, plus the replay), on the B SMs
// that hold a row (16 of 132 at B=16); bytes are a read of x (and g) and a
// write of the output (dx), the workspaces staying in L2. The products read
// A as broadcast float4s from shared memory and reuse each weight for 16
// rows.
//
// These whole-row kernels take T up to 145 at D = 128 (the backward's
// shared memory); the T-tiled kernels further down take any T, one layer
// a launch (ops/kernels.py conv_route picks between them).
#include "common.cuh"
#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;

struct ConvParams {
  const float* gam;   // [L, D]
  const float* beta;  // [L, D]
  const float* dw;    // [L, K, D]
  const float* wp;    // [L, D, D]
  const float* bp;    // [L, D]
  int T, D, L, K;
};

// out[t, c] = sum_j n_at(t + j - pad, c) * dw[j, c], zero outside [0, T)
template <typename NAt, typename Out>
__device__ void depthwise(NAt n_at, const float* __restrict__ dwl, int T, int D, int K, Out out) {
  const int pad = (K - 1) / 2;
  for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
    const int t = i / D, c = i - t * D;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      const int tt = t + j - pad;
      const float nv = (tt >= 0 && tt < T) ? n_at(tt, c) : 0.f;
      acc = fmaf(nv, __ldg(dwl + (size_t)j * D + c), acc);
    }
    out(i, acc);
  }
}

// One layer forward over the row's tile in shared memory:
// X += drop(relu(depthwise(LN(X)) . wp + bp)), with N and Dw as scratch.
__device__ void layer_forward(float* X, float* N, float* Dw, const ConvParams& p, int l,
                              const vsl::Dropout& drop, uint32_t seed) {
  const int T = p.T, D = p.D;
  vsl::layer_norm_rows(X, N, p.gam + (size_t)l * D, p.beta + (size_t)l * D, T, D);
  __syncthreads();
  depthwise([&](int t, int c) { return N[(size_t)t * D + c]; }, p.dw + (size_t)l * p.K * D, T, D,
            p.K, [&](int i, float v) { Dw[i] = v; });
  __syncthreads();
  const float* bpl = p.bp + (size_t)l * D;
  const uint32_t salt = vsl::site_salt(0x100u + l);
  vsl::gemm_rows<kRows>(Dw, T, D, p.wp + (size_t)l * D * D, D, 0, D,
                        [&](int t, int o, float acc) {
                          X[(size_t)t * D + o] +=
                              drop.apply(fmaxf(acc + __ldg(bpl + o), 0.f), seed, salt, t, o);
                        });
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
conv_block_fwd_kernel(const float* __restrict__ x, ConvParams p, vsl::Dropout drop,
                      float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int TD = p.T * p.D;
  float* X = reinterpret_cast<float*>(smem4);
  float* N = X + TD;
  float* Dw = N + TD;
  const size_t row = (size_t)blockIdx.x * TD;
  const uint32_t seed = drop.seed(blockIdx.x);
  for (int i = threadIdx.x; i < TD; i += blockDim.x) X[i] = x[row + i];
  __syncthreads();
  for (int l = 0; l < p.L; ++l) layer_forward(X, N, Dw, p, l, drop, seed);
  for (int i = threadIdx.x; i < TD; i += blockDim.x) out[row + i] = X[i];
}

// Per-row partials, [B, L, (3 + K) * D]: dgam, dbeta, dbp, then ddw [K, D].
__global__ void __launch_bounds__(kThreads)
conv_block_bwd_kernel(const float* __restrict__ x, ConvParams p, const float* __restrict__ wpT,
                      vsl::Dropout drop, const float* __restrict__ g, float* __restrict__ dx,
                      float* __restrict__ xs, float* __restrict__ d_ws, float* __restrict__ gp_ws,
                      float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  const int T = p.T, D = p.D, K = p.K, TD = T * D;
  const int pad = (K - 1) / 2;
  float* S0 = reinterpret_cast<float*>(smem4);  // X during the replay, then the gradient G
  float* S1 = S0 + TD;                          // N / xh / g_p
  float* S2 = S1 + TD;                          // Dw / g_d
  float* inv = S2 + TD;                         // [T]
  float* red = inv + T;                         // [kWarps, 2D]
  const int b = blockIdx.x;
  const size_t row = (size_t)b * TD;
  const size_t layer = (size_t)gridDim.x * TD;  // stride of one layer in the workspaces
  const size_t per_row = (size_t)p.L * (3 + K) * D;
  const uint32_t seed = drop.seed(b);

  // 1. forward replay, saving each layer's input
  for (int i = threadIdx.x; i < TD; i += blockDim.x) S0[i] = x[row + i];
  __syncthreads();
  for (int l = 0; l < p.L; ++l) {
    for (int i = threadIdx.x; i < TD; i += blockDim.x) xs[l * layer + row + i] = S0[i];
    layer_forward(S0, S1, S2, p, l, drop, seed);
  }

  // 2. backward, layer by layer
  for (int i = threadIdx.x; i < TD; i += blockDim.x) S0[i] = g[row + i];
  for (int l = p.L - 1; l >= 0; --l) {
    const float* xin = xs + l * layer + row;
    const float* gam = p.gam + (size_t)l * D;
    const float* beta = p.beta + (size_t)l * D;
    const float* dwl = p.dw + (size_t)l * K * D;
    const float* bpl = p.bp + (size_t)l * D;
    float* pr = part + (size_t)b * per_row + (size_t)l * (3 + K) * D;
    const uint32_t salt = vsl::site_salt(0x100u + l);
    auto n_at = [&](int t, int c) { return S1[(size_t)t * D + c] * __ldg(gam + c) + __ldg(beta + c); };
    for (int i = threadIdx.x; i < kWarps * 2 * D; i += blockDim.x) red[i] = 0.f;
    vsl::ln_normalize_rows(xin, S1, inv, T, D);
    __syncthreads();
    // d = depthwise(n), kept for ddw's partner g_d below and for dwp
    depthwise(n_at, dwl, T, D, K, [&](int i, float v) {
      S2[i] = v;
      d_ws[l * layer + row + i] = v;
    });
    __syncthreads();
    // g_p = [p > 0] * drop(g): the pre-ReLU p recomputed, the mask regenerated
    vsl::gemm_rows<kRows>(S2, T, D, p.wp + (size_t)l * D * D, D, 0, D,
                          [&](int t, int o, float acc) {
                            const size_t i = (size_t)t * D + o;
                            const float gp = acc + __ldg(bpl + o) > 0.f
                                                 ? drop.apply(S0[i], seed, salt, t, o)
                                                 : 0.f;
                            S1[i] = gp;
                            gp_ws[l * layer + row + i] = gp;
                          });
    __syncthreads();
    // dbp: column sums of g_p; g_d = g_p . wp^T
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
      for (int t = 0; t < T; ++t) s += S1[(size_t)t * D + c];
      pr[2 * D + c] = s;
    }
    vsl::gemm_rows<kRows>(S1, T, D, wpT + (size_t)l * D * D, D, 0, D,
                          [&](int t, int o, float acc) { S2[(size_t)t * D + o] = acc; });
    __syncthreads();
    vsl::ln_normalize_rows(xin, S1, inv, T, D);  // xh again (g_p is in gp_ws)
    __syncthreads();
    // ddw[j, c] = sum_t n(t + j - pad, c) * g_d(t, c)
    for (int i = threadIdx.x; i < K * D; i += blockDim.x) {
      const int j = i / D, c = i - j * D;
      float s = 0.f;
      for (int t = 0; t < T; ++t) {
        const int tt = t + j - pad;
        if (tt >= 0 && tt < T) s = fmaf(n_at(tt, c), S2[(size_t)t * D + c], s);
      }
      pr[3 * D + i] = s;
    }
    // g_n = depthwise backward of g_d (the reversed shifts); LN backward;
    // G = g_o + dx_ln (residual and LN input paths)
    auto g_n = [&](int t, int c) {
      float s = 0.f;
      for (int j = 0; j < K; ++j) {
        const int tt = t + pad - j;
        if (tt >= 0 && tt < T) s = fmaf(S2[(size_t)tt * D + c], __ldg(dwl + (size_t)j * D + c), s);
      }
      return s;
    };
    vsl::ln_backward_rows(S1, inv, gam, T, D, red, g_n,
                          [&](int t, int c, float v) { S0[(size_t)t * D + c] += v; });
    __syncthreads();
    vsl::fold_rows(red, kWarps, 2 * D, pr);  // dgam, dbeta
    __syncthreads();
  }
  for (int i = threadIdx.x; i < TD; i += blockDim.x) dx[row + i] = S0[i];
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
  float* red = inv + kTile + K - 1;             // [kWarps, 2D]
  const size_t row = (size_t)b * T * D;
  const float* gam = p.gam + (size_t)l * D;
  const float* beta = p.beta + (size_t)l * D;
  const float* dwl = p.dw + (size_t)l * K * D;
  float* pr = part + ((size_t)(b * gridDim.x + blockIdx.x) * p.L + l) * (3 + K) * D;
  const int lo = max(h0, 0), hi = min(h0 + rows, T);
  for (int i = threadIdx.x; i < kWarps * 2 * D; i += blockDim.x) red[i] = 0.f;
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
  // g_n(t, c) = sum_j g_d(t + pad - j, c) * dw[j, c]; then the LN backward
  // over the tile's own frames, G += dx_ln
  auto g_n = [&](int r, int c) {
    float s = 0.f;
    for (int j = 0; j < K; ++j)
      s = fmaf(GD[(size_t)(t0 + r + pad - j - g0) * D + c], __ldg(dwl + (size_t)j * D + c), s);
    return s;
  };
  vsl::ln_backward_rows(XH + (size_t)(t0 - h0) * D, inv + (t0 - h0), gam, nt, D, red, g_n,
                        [&](int r, int c, float v) { G[row + (size_t)(t0 + r) * D + c] += v; });
  __syncthreads();
  vsl::fold_rows(red, kWarps, 2 * D, pr);  // dgam, dbeta
}

int tiles(int T) { return (T + kTile - 1) / kTile; }

}  // namespace

extern "C" int vsl_conv_block_fwd(const float* x, const float* gam, const float* beta,
                                  const float* dw, const float* wp, const float* bp,
                                  const float* seeds, unsigned thresh, float scale, float* out,
                                  int B, int T, int D, int L, int K, void* stream) {
  const int smem = 3 * T * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(conv_block_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_block_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, make_params(gam, beta, dw, wp, bp, T, D, L, K), vsl::Dropout{seeds, thresh, scale}, out);
  return static_cast<int>(cudaGetLastError());
}

// dsmall [L, 3 + K, D]: dgam, dbeta, dbp, ddw; dwp [L, D, D]. Workspaces:
// xs, d_ws, gp_ws [L, B, T, D]; part [B, L, 3 + K, D]; gemm_ws [L, splits,
// D, D] (unused when splits == 1).
extern "C" int vsl_conv_block_bwd(const float* x, const float* gam, const float* beta,
                                  const float* dw, const float* wp, const float* wpT,
                                  const float* bp, const float* seeds, unsigned thresh,
                                  float scale, const float* g, float* dx, float* dsmall,
                                  float* dwp, float* xs, float* d_ws, float* gp_ws, float* part,
                                  float* gemm_ws, int splits, int B, int T, int D, int L, int K,
                                  void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int smem = (3 * T * D + T + kWarps * 2 * D) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(conv_block_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_block_bwd_kernel<<<B, kThreads, smem, stream>>>(
      x, make_params(gam, beta, dw, wp, bp, T, D, L, K), wpT, vsl::Dropout{seeds, thresh, scale},
      g, dx, xs, d_ws, gp_ws, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vsl::sum_partials(part, dsmall, 1, B, L * (3 + K) * D, stream);
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
  const int smem_a = ((3 * kTile + K - 1) * D) * static_cast<int>(sizeof(float));
  const int smem_b =
      (2 * (kTile + K - 1) * D + kTile + K - 1 + kWarps * 2 * D) * static_cast<int>(sizeof(float));
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
