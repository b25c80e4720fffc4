// LSTM recurrence forward (inference), replacing the TPU kernel
// vslnet_tpu/ops/pallas_kernels.py:_lstm_fwd_lean_kernel.
//
// Computes, over pre-projected inputs x_proj [T, B, 4H] (x.W_x + bias), the
// recurrent kernel k_h [H, 4H] and the validity mask valid [T, B]:
//   gates = x_proj[t] + h.k_h, TF gate order [i, j, f, o], forget bias +1
//   c~ = c*sigmoid(f+1) + sigmoid(i)*tanh(j),  h~ = tanh(c~)*sigmoid(o)
//   c  = v*c~ + (1-v)*c   (state frozen where invalid)
//   out[t] = v*h~         (output zeroed where invalid)
//   h  = out[t] + (1-v)*h (h carried through padding)
// exactly as the Pallas kernel's lines 264-269 do. h and c stay fp32.
//
// Design: one launch for all T steps, one block per batch row, 4H threads.
// h and c live in shared memory; each step every thread forms one gate
// pre-activation, reading its k_h column from global memory (coalesced
// along j, served from L2: 256 KB at H=128 is above the 227 KB a block
// can hold in shared memory). After a barrier, H threads do the gate math.
//
// What bounds it: the chain of T dependent steps, not bytes or FLOPs. Only
// B blocks run (16 of 132 SMs at B=16), and each step waits on the previous
// one; every step re-reads k_h from L2.
#include "common.cuh"

namespace {

__global__ void lstm_recurrence_fwd_kernel(const float* __restrict__ xp,
                                           const float* __restrict__ kh,
                                           const float* __restrict__ valid,
                                           float* __restrict__ out, int T, int B, int H) {
  extern __shared__ float smem[];
  float* h = smem;           // [H]
  float* c = smem + H;       // [H]
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
      const float ig = vsl::sigmoidf_(gates[j]);
      const float g = tanhf(gates[H + j]);
      const float f = vsl::sigmoidf_(gates[2 * H + j] + 1.f);
      const float o = vsl::sigmoidf_(gates[3 * H + j]);
      const float v = valid[(size_t)t * B + b];
      const float cp = c[j];
      const float cn = cp * f + ig * g;
      const float ht = tanhf(cn) * o;
      c[j] = v * cn + (1.f - v) * cp;
      const float nh = v * ht;
      out[((size_t)t * B + b) * H + j] = nh;
      h[j] = nh + (1.f - v) * h[j];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int vsl_lstm_recurrence_fwd(const float* xp, const float* kh, const float* valid,
                                       float* out, int T, int B, int H, void* stream) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  lstm_recurrence_fwd_kernel<<<B, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, kh, valid, out, T, B, H);
  return static_cast<int>(cudaGetLastError());
}
