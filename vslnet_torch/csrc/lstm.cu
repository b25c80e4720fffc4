// LSTM recurrence: the lean forward (inference), the forward with
// residuals and the reverse recurrence, replacing the TPU kernels
// vslnet_tpu/ops/pallas_kernels.py:_lstm_fwd_lean_kernel, _lstm_fwd_kernel
// and _lstm_bwd_kernel (via fused_lstm_recurrence and its VJP).
//
// Forward, over pre-projected inputs x_proj [T, B, 4H] (x.W_x + bias), the
// recurrent kernel k_h [H, 4H] and the validity mask valid [T, B]:
//   gates = x_proj[t] + h.k_h, TF gate order [i, j, f, o], forget bias +1
//   c~ = c*sigmoid(f+1) + sigmoid(i)*tanh(j),  h~ = tanh(c~)*sigmoid(o)
//   c  = v*c~ + (1-v)*c   (state frozen where invalid)
//   out[t] = v*h~         (output zeroed where invalid)
//   h  = out[t] + (1-v)*h (h carried through padding)
// exactly as the Pallas kernel's lines 264-269 do. h and c stay fp32. The
// residual forward also writes the gate activations acts [T, B, 4H]
// (i, g, f, o after their nonlinearities), tanh(c~) [T, B, H] and the
// state each step starts from, c_prev and h_prev [T, B, H].
//
// Backward (lines 316-375): the reverse chain carries dh and dc, passes
// them through invalid steps (dh_pass, dc_pass) and writes
// dx_proj [T, B, 4H]; then dk_h = sum over (t, b) of h_prev^T . dgates is
// a deterministic split-K product (common.cuh wgrad) over [T*B, H] and
// [T*B, 4H].
//
// Design: one launch for all T steps, one block per batch row, 4H threads.
// Forward: h and c live in shared memory; each step every thread forms one
// gate pre-activation, reading its k_h column from global memory (coalesced
// along j, served from L2: 256 KB at H=128 is above the 227 KB a block can
// hold in shared memory). After a barrier, H threads do the gate math.
// Backward: H threads form dgates and the new dc; then all 4H threads
// form dgates.k_h^T as four partial sums over quarters of the gates,
// reading k_h^T [4H, H] (coalesced along H) from L2; H threads add the four.
//
// What bounds them: the chain of T dependent steps, not bytes or FLOPs.
// Only B blocks run (16 of 132 SMs at B=16), and each step waits on the
// previous one; every step re-reads k_h from L2.
#include "common.cuh"

namespace {

template <bool kResiduals>
__global__ void lstm_recurrence_fwd_kernel(const float* __restrict__ xp,
                                           const float* __restrict__ kh,
                                           const float* __restrict__ valid,
                                           float* __restrict__ out, float* __restrict__ acts,
                                           float* __restrict__ th, float* __restrict__ c_prev,
                                           float* __restrict__ h_prev, int T, int B, int H) {
  extern __shared__ float smem[];
  float* h = smem;              // [H]
  float* c = smem + H;          // [H]
  float* gates = smem + 2 * H;  // [4H]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int G = 4 * H;
  if (j < H) {
    h[j] = 0.f;
    c[j] = 0.f;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    float dot = 0.f;
#pragma unroll 8
    for (int i = 0; i < H; ++i) dot = fmaf(h[i], __ldg(kh + (size_t)i * G + j), dot);
    gates[j] = xp[((size_t)t * B + b) * G + j] + dot;
    __syncthreads();
    if (j < H) {
      const size_t o = (size_t)t * B + b;
      const float ig = vsl::sigmoidf_(gates[j]);
      const float g = tanhf(gates[H + j]);
      const float f = vsl::sigmoidf_(gates[2 * H + j] + 1.f);
      const float og = vsl::sigmoidf_(gates[3 * H + j]);
      const float v = valid[o];
      const float cp = c[j];
      const float cn = cp * f + ig * g;
      const float tc = tanhf(cn);
      const float ht = tc * og;
      if (kResiduals) {
        acts[o * G + j] = ig;
        acts[o * G + H + j] = g;
        acts[o * G + 2 * H + j] = f;
        acts[o * G + 3 * H + j] = og;
        th[o * H + j] = tc;
        c_prev[o * H + j] = cp;
        h_prev[o * H + j] = h[j];
      }
      c[j] = v * cn + (1.f - v) * cp;
      const float nh = v * ht;
      out[o * H + j] = nh;
      h[j] = nh + (1.f - v) * h[j];
    }
    __syncthreads();
  }
}

__global__ void lstm_recurrence_bwd_kernel(const float* __restrict__ dy,
                                           const float* __restrict__ acts,
                                           const float* __restrict__ th,
                                           const float* __restrict__ c_prev,
                                           const float* __restrict__ valid,
                                           const float* __restrict__ khT,
                                           float* __restrict__ dxp, int T, int B, int H) {
  extern __shared__ float smem[];
  float* dh = smem;         // [H]
  float* dc = dh + H;       // [H]
  float* dg = dc + H;       // [4H] dgates of the current step
  float* part = dg + 4 * H;  // [4H] quarter sums of dgates . k_h^T
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int G = 4 * H;
  if (tid < H) {
    dh[tid] = 0.f;
    dc[tid] = 0.f;
  }
  __syncthreads();
  float dh_pass = 0.f;
  const int q = tid / H, jj = tid - q * H;
  for (int t = T - 1; t >= 0; --t) {
    if (tid < H) {
      const int j = tid;
      const size_t o = (size_t)t * B + b;
      const float v = valid[o];
      const float i = acts[o * G + j], g = acts[o * G + H + j];
      const float f = acts[o * G + 2 * H + j], og = acts[o * G + 3 * H + j];
      const float tc = th[o * H + j];
      const float dh_t = v * (dy[o * H + j] + dh[j]);
      dh_pass = (1.f - v) * dh[j];
      const float dc_t = v * dc[j] + dh_t * og * (1.f - tc * tc);
      const float dc_pass = (1.f - v) * dc[j];
      const float d_o = dh_t * tc;
      const float d_f = dc_t * c_prev[o * H + j];
      const float d_i = dc_t * g;
      const float d_g = dc_t * i;
      const float gi = d_i * i * (1.f - i);
      const float gg = d_g * (1.f - g * g);
      const float gf = d_f * f * (1.f - f);
      const float go = d_o * og * (1.f - og);
      dg[j] = gi;
      dg[H + j] = gg;
      dg[2 * H + j] = gf;
      dg[3 * H + j] = go;
      dxp[o * G + j] = gi;
      dxp[o * G + H + j] = gg;
      dxp[o * G + 2 * H + j] = gf;
      dxp[o * G + 3 * H + j] = go;
      dc[j] = dc_pass + dc_t * f;
    }
    __syncthreads();
    float acc = 0.f;
    const float* kq = khT + (size_t)q * H * H + jj;
#pragma unroll 8
    for (int k = 0; k < H; ++k) acc = fmaf(dg[q * H + k], __ldg(kq + (size_t)k * H), acc);
    part[tid] = acc;
    __syncthreads();
    if (tid < H) dh[tid] = dh_pass + ((part[tid] + part[H + tid]) + (part[2 * H + tid] + part[3 * H + tid]));
  }
}

}  // namespace

extern "C" int vsl_lstm_recurrence_fwd(const float* xp, const float* kh, const float* valid,
                                       float* out, int T, int B, int H, void* stream) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  lstm_recurrence_fwd_kernel<false><<<B, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, kh, valid, out, nullptr, nullptr, nullptr, nullptr, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vsl_lstm_recurrence_fwd_res(const float* xp, const float* kh, const float* valid,
                                           float* out, float* acts, float* th, float* c_prev,
                                           float* h_prev, int T, int B, int H, void* stream) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  lstm_recurrence_fwd_kernel<true><<<B, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, kh, valid, out, acts, th, c_prev, h_prev, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

// dkh = sum over the T*B rows of h_prev^T . dxp; gemm_ws [splits, H, 4H]
// (unused when splits == 1).
extern "C" int vsl_lstm_recurrence_bwd(const float* dy, const float* acts, const float* th,
                                       const float* c_prev, const float* h_prev,
                                       const float* valid, const float* khT, float* dxp,
                                       float* dkh, float* gemm_ws, int splits, int T, int B,
                                       int H, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t smem = (size_t)10 * H * sizeof(float);
  lstm_recurrence_bwd_kernel<<<B, 4 * H, smem, stream>>>(dy, acts, th, c_prev, valid, khT, dxp,
                                                         T, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(vsl::wgrad(h_prev, dxp, dkh, gemm_ws, 1, H, 4 * H, T * B, splits, stream));
}
