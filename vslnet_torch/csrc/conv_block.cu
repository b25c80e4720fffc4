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
