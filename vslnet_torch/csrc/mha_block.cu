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
// Backward: a row's q, k, v, P and dP do not fit one block's shared memory
// together, so it is three launches too, plus the weight products.
//   1. dense + LN2 backward, one block per row: g_dpre, g_res and g_att.
//   2. attention backward, grid (B, n_heads): P recomputed from q, k and
//      the mask, dS kept in shared memory ([T, T+1]), dq by query rows,
//      dk and dv by key columns.
//   3. QKV + LN1 backward, one block per row: dx.
// dwd = sum over rows of z^T . g_dpre and dwqkv = y^T . dqkv are
// deterministic split-K products (common.cuh wgrad); the bias and LN
// gradients are per-row partials summed over the batch in a fixed order.
//
// What bounds them: the projections' 2*T*D*4D FLOPs a row (twice that and
// more in the backward) on few SMs, and the attention's per-thread serial
// key loops; bytes are a read of x (and g), the weights and the saved qkv
// and att, and a write of the output (dx and the weight gradients).
//
// The attention launches (2 of the forward, 2 of the backward) also serve
// on their own as the whole-T fused_mha kernels (vsl_mha_fwd, vsl_mha_bwd
// at the end): they take q, k, v and the outputs through base pointers and
// row strides, so one device body serves both callers. Those are bound by
// the per-thread key loops on B * n_heads blocks.
#include "common.cuh"
#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
// Per-row partials part [B, 8D]: dgam [2D], dbeta [2D], dbqkv [3D], dbd [D].

// 1. out = drop203(z.Wd + bd) + res: g_dpre = drop203(g) (and dbd);
// g_z = g_dpre . Wd^T; z = drop202(LN2(res)): LN2 backward (dgam2, dbeta2);
// g_res = g + the LN2 path; g_att = drop201(g_res). Writes z and g_dpre
// (for dwd), g_res and g_att.
__global__ void __launch_bounds__(kThreads)
bwd_out_kernel(const float* __restrict__ x, const float* __restrict__ att,
               const float* __restrict__ gam, const float* __restrict__ beta,
               const float* __restrict__ wdT, vsl::Dropout drop, const float* __restrict__ g,
               float* __restrict__ z_ws, float* __restrict__ gdpre_ws,
               float* __restrict__ gres_ws, float* __restrict__ gatt_ws,
               float* __restrict__ part, int T, int D) {
  extern __shared__ float4 smem4[];
  const int TD = T * D;
  float* XH = reinterpret_cast<float*>(smem4);  // res, then its xh
  float* GD = XH + TD;                           // g_dpre
  float* GZ = GD + TD;                           // g_z
  float* inv = GZ + TD;                          // [T]
  float* red = inv + T;                          // [kWarps, 2D]
  const int b = blockIdx.x;
  const size_t row = (size_t)b * TD;
  const uint32_t seed = drop.seed(b);
  const uint32_t s201 = vsl::site_salt(0x201u), s202 = vsl::site_salt(0x202u),
                 s203 = vsl::site_salt(0x203u);
  float* pr = part + (size_t)b * 8 * D;
  for (int i = threadIdx.x; i < TD; i += blockDim.x) {
    const int t = i / D, c = i - t * D;
    const float gd = drop.apply(g[row + i], seed, s203, t, c);
    GD[i] = gd;
    gdpre_ws[row + i] = gd;
    XH[i] = drop.apply(att[row + i], seed, s201, t, c) + x[row + i];
  }
  for (int i = threadIdx.x; i < kWarps * 2 * D; i += blockDim.x) red[i] = 0.f;
  __syncthreads();
  vsl::ln_normalize_rows(XH, XH, inv, T, D);
  vsl::gemm_rows<kRows>(GD, T, D, wdT, D, 0, D,
                        [&](int t, int o, float acc) { GZ[(size_t)t * D + o] = acc; });
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += GD[(size_t)t * D + c];
    pr[7 * D + c] = s;  // dbd
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TD; i += blockDim.x) {
    const int t = i / D, c = i - t * D;
    z_ws[row + i] = drop.apply(XH[i] * __ldg(gam + c) + __ldg(beta + c), seed, s202, t, c);
  }
  vsl::ln_backward_rows(
      XH, inv, gam, T, D, red,
      [&](int t, int c) { return drop.apply(GZ[(size_t)t * D + c], seed, s202, t, c); },
      [&](int t, int c, float v) {
        const size_t i = row + (size_t)t * D + c;
        const float gr = g[i] + v;
        gres_ws[i] = gr;
        gatt_ws[i] = drop.apply(gr, seed, s201, t, c);
      });
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sg += red[(size_t)w * 2 * D + c];
      sb += red[(size_t)w * 2 * D + D + c];
    }
    pr[D + c] = sg;      // dgam of LN2
    pr[3 * D + c] = sb;  // dbeta of LN2
  }
}

// 2. attention backward for one (row, head). Phase A, a thread per query
// row t: m, l and D_t = sum_j dp * p, then ds = p * (dp - D_t) into DS and
// dq = scale * ds . k. Phase B, a thread per key column j: P recomputed,
// dv = sum_t drop(p) * g_t and dk = sum_t ds * q_t * scale.
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

// 3. qkv = y.Wqkv + bqkv, y = drop200(LN1(x)): dbqkv, g_y = dqkv . Wqkv^T,
// LN1 backward (dgam1, dbeta1), dx = g_res + the LN1 path. Writes y (for
// dwqkv) and dx.
__global__ void __launch_bounds__(kThreads)
bwd_qkv_kernel(const float* __restrict__ x, const float* __restrict__ gam,
               const float* __restrict__ beta, const float* __restrict__ wqkvT,
               vsl::Dropout drop, const float* __restrict__ dqkv,
               const float* __restrict__ gres_ws, float* __restrict__ y_ws,
               float* __restrict__ dx, float* __restrict__ part, int T, int D) {
  extern __shared__ float4 smem4[];
  const int TD = T * D;
  float* XH = reinterpret_cast<float*>(smem4);  // xh of LN1
  float* GY = XH + TD;                           // g_y
  float* inv = GY + TD;                          // [T]
  float* red = inv + T;                          // [kWarps, 2D]
  const int b = blockIdx.x;
  const size_t row = (size_t)b * TD;
  const uint32_t seed = drop.seed(b), s200 = vsl::site_salt(0x200u);
  const float* dq = dqkv + (size_t)b * T * 3 * D;
  float* pr = part + (size_t)b * 8 * D;
  for (int i = threadIdx.x; i < kWarps * 2 * D; i += blockDim.x) red[i] = 0.f;
  vsl::ln_normalize_rows(x + row, XH, inv, T, D);
  vsl::gemm_rows<kRows>(dq, T, 3 * D, wqkvT, D, 0, D,
                        [&](int t, int o, float acc) { GY[(size_t)t * D + o] = acc; });
  for (int c = threadIdx.x; c < 3 * D; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += dq[(size_t)t * 3 * D + c];
    pr[4 * D + c] = s;  // dbqkv
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TD; i += blockDim.x) {
    const int t = i / D, c = i - t * D;
    y_ws[row + i] = drop.apply(XH[i] * __ldg(gam + c) + __ldg(beta + c), seed, s200, t, c);
  }
  vsl::ln_backward_rows(
      XH, inv, gam, T, D, red,
      [&](int t, int c) { return drop.apply(GY[(size_t)t * D + c], seed, s200, t, c); },
      [&](int t, int c, float v) {
        const size_t i = row + (size_t)t * D + c;
        dx[i] = gres_ws[i] + v;
      });
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float sg = 0.f, sb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sg += red[(size_t)w * 2 * D + c];
      sb += red[(size_t)w * 2 * D + D + c];
    }
    pr[c] = sg;          // dgam of LN1
    pr[2 * D + c] = sb;  // dbeta of LN1
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

cudaError_t set_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  cudaError_t err = set_smem(reinterpret_cast<const void*>(ln_qkv_kernel), smem1);
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
  err = set_smem(reinterpret_cast<const void*>(out_kernel), smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  out_kernel<<<dim3(B, (D + kChunk - 1) / kChunk), kThreads, smem3, stream>>>(
      x, att, gam + D, beta + D, wd, bd, drop, out, T, D);
  return static_cast<int>(cudaGetLastError());
}

// dsmall [8D]: dgam [2, D], dbeta [2, D], dbqkv [3D], dbd [D]; dwqkv
// [D, 3D]; dwd [D, D]. Workspaces: z, gdpre, gres, gatt, y [B, T, D]; dqkv
// [B, T, 3D]; part [B, 8D]; gemm_ws [splits, D, 3D] (unused when splits ==
// 1).
extern "C" int vsl_mha_block_bwd(const float* x, const float* mask, const float* gam,
                                 const float* beta, const float* wqkvT, const float* wdT,
                                 const float* seeds, unsigned thresh, float scale,
                                 const float* qkv, const float* att, const float* g, float* dx,
                                 float* dsmall, float* dwqkv, float* dwd, float* z_ws,
                                 float* gdpre_ws, float* gres_ws, float* gatt_ws, float* y_ws,
                                 float* dqkv, float* part, float* gemm_ws, int splits, int B,
                                 int T, int D, int n_heads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const vsl::Dropout drop{seeds, thresh, scale};
  const int smem1 = (3 * T * D + T + kWarps * 2 * D) * static_cast<int>(sizeof(float));
  cudaError_t err = set_smem(reinterpret_cast<const void*>(bwd_out_kernel), smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_out_kernel<<<B, kThreads, smem1, stream>>>(x, att, gam + D, beta + D, wdT, drop, g, z_ws,
                                                 gdpre_ws, gres_ws, gatt_ws, part, T, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = vsl::by_head_dim(D / n_heads, [&](auto hd) {
    return launch_attention_bwd<decltype(hd)::value>(qkv, qkv + D, qkv + 2 * D, 3 * D, mask, drop,
                                                     gatt_ws, D, dqkv, dqkv + D, dqkv + 2 * D,
                                                     3 * D, B, T, n_heads, stream);
  });
  if (err != cudaSuccess) return static_cast<int>(err);

  const int smem3 = (2 * T * D + T + kWarps * 2 * D) * static_cast<int>(sizeof(float));
  err = set_smem(reinterpret_cast<const void*>(bwd_qkv_kernel), smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_qkv_kernel<<<B, kThreads, smem3, stream>>>(x, gam, beta, wqkvT, drop, dqkv, gres_ws, y_ws,
                                                 dx, part, T, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = vsl::sum_partials(part, dsmall, 1, B, 8 * D, stream);
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
