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
// Forward design: a recurrence resident in a thread-block cluster, one
// launch for all T steps (plan: ops/kernels.py lstm_plan).
// - A cluster of N CTAs takes Bt batch rows. CTA r owns the hidden units
//   [r*U, min(H, (r+1)*U)), U = ceil(H/N), with all four gates of each, so
//   its gate math and c stay local.
// - Before step 0 each CTA copies its 4U columns of k_h into shared memory
//   (transposed, a column's H floats padded to an odd number of float4s, so
//   lanes on neighbouring columns load without bank conflicts) and keeps
//   them there: the chain reads nothing from L2 but x_proj[t] and valid[t],
//   which each thread loads a step ahead.
// - Every CTA holds the whole h of its Bt rows, double-buffered by step
//   parity. A step: S neighbouring lanes of a warp share a unit; each forms
//   the unit's four gate dots for all Bt rows over every S-th float4 of H
//   (fp32 FMAs; TF32 would break parity with the fp32 Pallas kernel), a
//   shuffle butterfly sums them, and lane b < Bt does row b's gate math and
//   stores its new h into the other buffer of every CTA of the cluster with
//   st.async (distributed shared memory), each store completing bytes of
//   the receiver's mbarrier for that buffer. Each thread waits on its own
//   CTA's mbarrier for the Bt*H floats of the next h: no block or cluster
//   barrier runs in the loop (a cluster barrier costs twice the exchange).
// - No barrier guards the buffer a store overwrites: a CTA that has all of
//   h_t knows every warp of every CTA has sent its slice of h_t, so has
//   finished reading h_(t-1), the buffer h_(t+1) goes into. No step sends
//   h_T, so every store into a CTA lands before that CTA's last wait, and
//   no CTA exits while another may still write into it.
// - Clusters are independent, so any B runs, in waves where the card
//   cannot hold all ceil(B/Bt)*N CTAs.
// What bounds it: the chain of T dependent steps, each a dot product out
// of shared memory, the butterfly, the gate math of one lane per (row,
// unit) and the DSMEM exchange's latency (PERF.md has the measured
// split). Not the call's bytes or FLOPs, nor L2, which bounded the
// one-block-per-row forward this replaces: 16 SMs each re-reading k_h's
// 256 KB every step.
//
// Backward design: the mirror of the forward, on the same plan and
// clusters, one launch for all T steps walked in reverse.
// - CTA r owns the same units; before the first step it copies the k_h
//   rows of its units (4H floats each, a gate's H padded to whole float4s,
//   rows padded to an odd number of float4s) into shared memory and keeps
//   them: dh_(t-1)[j] = sum_k dg_t[k] * k_h[j, k] reads no L2.
// - The thread of (row, unit) keeps that cell's dh carried through padding
//   and dc in registers. A step: the S lanes of a unit form its dot with
//   the dgates of the step before (all 4H of each row, from every CTA) and
//   sum it by the butterfly; lane b < Bt does row b's gate gradients; the
//   group's lanes then share the 4*Bt values by shuffles, and each writes
//   its share of dx_proj and sends it to every CTA of the cluster by
//   st.async into the other buffer of a double buffer of dgates, whose
//   mbarrier counts the bytes, exactly as the forward's h exchange (the
//   same argument makes the buffers safe without a barrier).
// - dy, acts, tanh(c~), c_prev and valid of the next step are loaded a
//   step ahead with asm volatile loads.
// - dk_h = h_prev^T . dgates is then the split-K product over [T*B, H].
// What bounds it: the chain of T dependent steps (dot, butterfly, gate
// gradients, exchange latency), not bytes or FLOPs; the one-block-per-row
// backward this replaces re-read k_h^T's 256 KB from L2 every step on B
// SMs.
//
// bf16 (vsl_lstm_recurrence_fwd_bf16, _fwd_res_bf16 and _bwd_bf16): the TPU
// kernel at bf16 takes x_proj and k_h in bf16 and forms gates = f32(x_proj)
// + dot(bf16(h), k_h) with fp32 accumulation; the gate math, c and the
// carried h stay fp32 and the output is fp32 (pallas_kernels.py:250-269).
// That dot is mma.sync with bf16 operands and fp32 sums, so both bf16
// forwards run on the tensor cores, in a kernel of their own on the
// cluster design above (lstm_fwd_tc_kernel, at the end): k_h as mma A
// fragments in registers, bf16(h) exchanged in 8-byte pieces. The
// backward at bf16 (_lstm_bwd_kernel and _fused_lstm_bwd,
// pallas_kernels.py:316-375, 550-557) keeps the gate backward, dh and dc
// fp32 and rounds each step's dgates once, where they leave the thread:
// the dh product of the step before reads them rounded (dh +=
// bf16(dgates) . k_h^T), dx_proj is written as those bf16 values (the
// TPU's dxp.astype(bf16)), and dk_h = sum bf16(h_prev)^T . dgates is a
// split-K product with h_prev rounded as it loads, rounded to bf16 once
// summed. Both products are mma.sync with bf16 operands and fp32 sums, in
// a kernel of its own (lstm_bwd_tc_kernel, further down).
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;  // CTAs a cluster on any sm_90 part (kernels.py LSTM_CLUSTER)

// The forward's shared-memory layout for hidden size H and cluster size N
// (ops/kernels.py lstm_plan reports its size; the launch uses this one):
//   full [2] mbarrier: h of the next step has arrived, by step parity
//   khs  [4U][KS4] float4: column g*U + u is k_h[:, g*H + r*U + u], 0 past H
//   hbuf [2][Bt][4*Hq] float: h of the cluster's rows, by step parity
struct FwdLayout {
  int U, Hq, KS4;
  __host__ __device__ FwdLayout(int H, int N) : U((H + N - 1) / N), Hq((H + 3) / 4), KS4(Hq | 1) {}
  __host__ __device__ size_t smem_bytes(int Bt) const {
    return 16 + sizeof(float) * (16 * (size_t)U * KS4 + 8 * (size_t)Bt * Hq);
  }
};

// The backward's (ops/kernels.py lstm_plan smem_bwd):
//   full [2] mbarrier: the dgates of the step before have arrived, by parity
//   khs  [U][KS4] float4: row u is k_h[r*U + u, :], each gate's H padded to
//        Hq float4s, KS4 = 4*Hq | 1
//   dgb  [2][Bt][4*Hq] float4: the dgates of the cluster's rows, same layout
struct BwdLayout {
  int U, Hq, KS4;
  __host__ __device__ BwdLayout(int H, int N)
      : U((H + N - 1) / N), Hq((H + 3) / 4), KS4((4 * ((H + 3) / 4)) | 1) {}
  __host__ __device__ size_t smem_bytes(int Bt) const {
    return 16 + 16 * ((size_t)U * KS4 + 8 * (size_t)Bt * Hq);
  }
};

// The h exchange: a CTA's 32-bit shared-memory addresses, the same offset
// in CTA `rank` of the cluster, and the mbarrier operations on them.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_u32(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// One local arrival that also expects `bytes` of remote stores this phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// A global load issued here: the compiler may not sink it to its use a step
// later, where its L2 latency would land on the chain.
__device__ __forceinline__ float ld_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
// A bf16 is loaded as its bits and widened where it is used (widen), not
// beside the load, where the widening would wait out the load's latency.
__device__ __forceinline__ unsigned short ld_early(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);  // bf16 -> fp32 is exact
}
// v into the cluster address `addr`; its 4 bytes complete the transaction
// count of the mbarrier at the cluster address `bar` (in the same CTA).
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

template <bool kResiduals, int kBt>
__global__ void __launch_bounds__(512)
lstm_fwd_cluster_kernel(const float* __restrict__ xp, const float* __restrict__ kh,
                        const float* __restrict__ valid, float* __restrict__ out,
                        float* __restrict__ acts, float* __restrict__ th,
                        float* __restrict__ c_prev, float* __restrict__ h_prev, int T, int B,
                        int H, int S) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = static_cast<int>(cluster.num_blocks());
  const FwdLayout L(H, N);
  const int U = L.U, C4 = 4 * U, Hq = L.Hq, Hp = 4 * Hq, G = 4 * H;
  const int u0 = static_cast<int>(cluster.block_rank()) * U;
  const int row0 = static_cast<int>(blockIdx.x) / N * kBt;
  const int tid = threadIdx.x, nt = blockDim.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  float4* khs = smem4 + 1;
  float* hbuf = reinterpret_cast<float*>(khs + (size_t)C4 * L.KS4);
  // a step's h arrives from every CTA: H floats for each valid row
  const uint32_t h_bytes = 4u * H * min(kBt, B - row0);

  // k_h's columns of this CTA, once; global reads run along the units
  float* khf = reinterpret_cast<float*>(khs);
  const int KS = 4 * L.KS4;
  for (int i = tid; i < C4 * KS; i += nt) {
    const int k = i / C4, lc = i - k * C4;
    const int g = lc / U, u = u0 + lc - g * U;
    khf[(size_t)lc * KS + k] = (k < H && u < H) ? kh[(size_t)k * G + g * H + u] : 0.f;
  }
  for (int i = tid; i < 2 * kBt * Hp; i += nt) hbuf[i] = 0.f;
  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      mbar_init(smem_u32(full + p));
      mbar_expect(smem_u32(full + p), h_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA's buffers and mbarriers are set before any remote store

  // S neighbouring lanes of a warp share unit u0 + lu: lane ls takes the
  // float4s q = ls, ls + S, ... of H for its unit's four gate columns and
  // all kBt rows, the lanes sum their dots by a butterfly, and lane ls <
  // kBt does the gate math of row ls. Lanes past the CTA's units only join
  // the shuffles.
  const int lu = tid / S, ls = tid - lu * S;
  const int unit = u0 + lu, row = row0 + ls;
  const bool column = lu < U;
  const bool own = column && unit < H && ls < kBt && row < B;
  float c = 0.f, x[4] = {0.f, 0.f, 0.f, 0.f}, v = 0.f;
  if (own && T > 0) {
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = xp[(size_t)row * G + g * H + unit];
    v = valid[row];
  }
  const float4* wcol = khs + (size_t)lu * L.KS4;
  const size_t wgate = (size_t)U * L.KS4;  // float4s from one gate's column to the next
  uint32_t phase = 0;  // bit p: the parity of full[p]'s next phase

  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    const float* hc = hbuf + p * kBt * Hp;
    float* hn = hbuf + (p ^ 1) * kBt * Hp;
    if (t > 0) {  // h_t, stored by every CTA at step t - 1
      mbar_wait(smem_u32(full + p), (phase >> p) & 1u);
      phase ^= 1u << p;
      if (tid == 0) mbar_expect(smem_u32(full + p), h_bytes);  // for h_(t+2)
    }
    float nx[4] = {0.f, 0.f, 0.f, 0.f};
    float nv = 0.f;
    if (own && t + 1 < T) {  // off the chain: the next step's inputs
      const size_t o = (size_t)(t + 1) * B + row;
#pragma unroll
      for (int g = 0; g < 4; ++g) nx[g] = ld_early(xp + o * G + g * H + unit);
      nv = ld_early(valid + o);
    }
    float acc[4][kBt];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int b = 0; b < kBt; ++b) acc[g][b] = 0.f;
    if (column) {
      const float4* h4 = reinterpret_cast<const float4*>(hc);
#pragma unroll 4
      for (int q = ls; q < Hq; q += S) {
        float4 w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = wcol[g * wgate + q];
#pragma unroll
        for (int b = 0; b < kBt; ++b) {
          const float4 hv = h4[b * Hq + q];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[g][b] = fmaf(hv.x, w[g].x, acc[g][b]);
            acc[g][b] = fmaf(hv.y, w[g].y, acc[g][b]);
            acc[g][b] = fmaf(hv.z, w[g].z, acc[g][b]);
            acc[g][b] = fmaf(hv.w, w[g].w, acc[g][b]);
          }
        }
      }
    }
    // every lane of the group ends with the same sums: each level adds the
    // same two partials in either order
    for (int off = S >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int b = 0; b < kBt; ++b) acc[g][b] += __shfl_xor_sync(0xffffffffu, acc[g][b], off);
    if (own) {
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float a = acc[g][0];  // row ls's sum, without indexing registers at run time
#pragma unroll
        for (int b = 1; b < kBt; ++b) a = ls == b ? acc[g][b] : a;
        gate[g] = a + x[g];
      }
      const float ig = vsl::sigmoidf_(gate[0]);
      const float gg = tanhf(gate[1]);
      const float f = vsl::sigmoidf_(gate[2] + 1.f);
      const float og = vsl::sigmoidf_(gate[3]);
      const float cp = c;
      const float cn = cp * f + ig * gg;
      const float tc = tanhf(cn);
      c = v * cn + (1.f - v) * cp;
      const float hp = hc[ls * Hp + unit];
      const float ho = v * (tc * og);
      if (t + 1 < T) {  // h_(t+1) into every CTA of the cluster
        const float hnew = ho + (1.f - v) * hp;
        const uint32_t dst = smem_u32(hn + ls * Hp + unit);
        const uint32_t bar = smem_u32(full + (p ^ 1));
        for (int r = 0; r < N; ++r) st_async(cluster_u32(dst, r), hnew, cluster_u32(bar, r));
      }
      const size_t o = (size_t)t * B + row;
      out[o * H + unit] = ho;
      if (kResiduals) {
        acts[o * G + unit] = ig;
        acts[o * G + H + unit] = gg;
        acts[o * G + 2 * H + unit] = f;
        acts[o * G + 3 * H + unit] = og;
        th[o * H + unit] = tc;
        c_prev[o * H + unit] = cp;
        h_prev[o * H + unit] = hp;
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = nx[g];
    v = nv;
  }
}

template <int kBt>
__global__ void __launch_bounds__(512)
lstm_bwd_cluster_kernel(const float* __restrict__ dy, const float* __restrict__ acts,
                        const float* __restrict__ th, const float* __restrict__ c_prev,
                        const float* __restrict__ valid, const float* __restrict__ kh,
                        float* __restrict__ dxp, int T, int B, int H, int S) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = static_cast<int>(cluster.num_blocks());
  const BwdLayout L(H, N);
  const int U = L.U, Hq = L.Hq, Q = 4 * Hq, G = 4 * H;
  const int u0 = static_cast<int>(cluster.block_rank()) * U;
  const int row0 = static_cast<int>(blockIdx.x) / N * kBt;
  const int tid = threadIdx.x, nt = blockDim.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  float4* khs = smem4 + 1;
  float4* dgb = khs + (size_t)U * L.KS4;
  // a step's dgates arrive from every CTA: 4H floats for each valid row
  const uint32_t dg_bytes = 4u * G * min(kBt, B - row0);

  // k_h's rows of this CTA's units, once; global reads run along the gates
  float* khf = reinterpret_cast<float*>(khs);
  const int KS = 4 * L.KS4, Hp = 4 * Hq;
  for (int i = tid; i < U * KS; i += nt) {
    const int u = i / KS, k = i - u * KS;
    const int g = k / Hp, kk = k - g * Hp;
    const int j = u0 + u;
    khf[i] = (g < 4 && kk < H && j < H) ? kh[(size_t)j * G + g * H + kk] : 0.f;
  }
  float* dgf = reinterpret_cast<float*>(dgb);
  for (int i = tid; i < 2 * kBt * Q * 4; i += nt) dgf[i] = 0.f;
  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      mbar_init(smem_u32(full + p));
      mbar_expect(smem_u32(full + p), dg_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA's buffers and mbarriers are set before any remote store

  // S neighbouring lanes of a warp share unit u0 + lu: lane ls takes the
  // float4s q = ls, ls + S, ... of the unit's k_h row and every row's
  // dgates, the lanes sum by a butterfly, lane ls < kBt does row ls's
  // gate gradients, and the group's lanes share out the 4*kBt results.
  const int lu = tid / S, ls = tid - lu * S;
  const int unit = u0 + lu, row = row0 + ls;
  const bool column = lu < U && unit < H;
  const bool own = column && ls < kBt && row < B;
  const int base = (threadIdx.x & 31) - ls;  // the group's first lane in the warp
  float dc = 0.f, dh_pass = 0.f;
  float in[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // dy, i, g, f, o, tc, c_prev, v
  auto load = [&](int t, float* v) {
    const size_t o = (size_t)t * B + row;
    const float* src[8] = {dy + o * H + unit, acts + o * G + unit, acts + o * G + H + unit,
                           acts + o * G + 2 * H + unit, acts + o * G + 3 * H + unit,
                           th + o * H + unit, c_prev + o * H + unit, valid + o};
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = ld_early(src[k]);
  };
  if (own && T > 0) load(T - 1, in);
  const float4* wrow = khs + (size_t)lu * L.KS4;
  uint32_t phase = 0;  // bit p: the parity of full[p]'s next phase

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s, p = s & 1;
    const float4* dgc4 = dgb + (size_t)p * kBt * Q;  // dgates of step t + 1
    float4* dn4 = dgb + (size_t)(p ^ 1) * kBt * Q;
    if (s > 0) {  // stored by every CTA at step t + 1
      mbar_wait(smem_u32(full + p), (phase >> p) & 1u);
      phase ^= 1u << p;
      if (tid == 0) mbar_expect(smem_u32(full + p), dg_bytes);  // for step t - 1's
    }
    float nx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (own && t > 0) load(t - 1, nx);  // off the chain: the next step's inputs
    float acc[kBt];
#pragma unroll
    for (int b = 0; b < kBt; ++b) acc[b] = 0.f;
    if (column && s > 0) {
#pragma unroll 4
      for (int q = ls; q < Q; q += S) {
        const float4 w = wrow[q];
#pragma unroll
        for (int b = 0; b < kBt; ++b) {
          const float4 d = dgc4[b * Q + q];
          acc[b] = fmaf(d.x, w.x, acc[b]);
          acc[b] = fmaf(d.y, w.y, acc[b]);
          acc[b] = fmaf(d.z, w.z, acc[b]);
          acc[b] = fmaf(d.w, w.w, acc[b]);
        }
      }
    }
    for (int off = S >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int b = 0; b < kBt; ++b) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
    float dg[4] = {0.f, 0.f, 0.f, 0.f};
    if (own) {
      float a = acc[0];  // row ls's sum, without indexing registers at run time
#pragma unroll
      for (int b = 1; b < kBt; ++b) a = ls == b ? acc[b] : a;
      const float v = in[7], ig = in[1], gg = in[2], f = in[3], og = in[4], tc = in[5];
      const float dh = dh_pass + a;
      const float dh_t = v * (in[0] + dh);
      dh_pass = (1.f - v) * dh;
      const float dc_t = v * dc + dh_t * og * (1.f - tc * tc);
      const float dc_pass = (1.f - v) * dc;
      const float d_o = dh_t * tc;
      const float d_f = dc_t * in[6];
      const float d_i = dc_t * gg;
      const float d_g = dc_t * ig;
      dg[0] = d_i * ig * (1.f - ig);
      dg[1] = d_g * (1.f - gg * gg);
      dg[2] = d_f * f * (1.f - f);
      dg[3] = d_o * og * (1.f - og);
      dc = dc_pass + dc_t * f;
    }
    // item i of the group's 4*kBt results is gate i & 3 of row i >> 2, held
    // by lane i >> 2; lane ls writes and sends items ls, ls + S, ...
    for (int m = 0; m * S < 4 * kBt; ++m) {
      const int i = ls + m * S;
      const int src = base + min(i >> 2, kBt - 1);
      float val = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float x = __shfl_sync(0xffffffffu, dg[g], src);
        val = (i & 3) == g ? x : val;
      }
      const int rb = i >> 2, r = row0 + rb, g = i & 3;
      if (column && i < 4 * kBt && r < B) {
        dxp[((size_t)t * B + r) * G + g * H + unit] = val;
        if (t > 0) {  // dg_t into every CTA of the cluster
          const uint32_t dst = smem_u32(reinterpret_cast<float*>(dn4 + (size_t)rb * Q) + g * Hp + unit);
          const uint32_t bar = smem_u32(full + (p ^ 1));
          for (int c = 0; c < N; ++c) st_async(cluster_u32(dst, c), val, cluster_u32(bar, c));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) in[k] = nx[k];
  }
}

// The plan (N CTAs a cluster, Bt rows a cluster, S lanes a unit, threads)
// must fit the layout for H: every CTA owns a unit; S is a power of two up
// to a warp and at least Bt (a lane for each row's gate math); every (unit,
// lane) has a thread.
cudaError_t check_plan(int H, int N, int Bt, int S, int threads) {
  if (H < 1 || N < 1 || N > kMaxCluster || S < Bt || S > 32 || (S & (S - 1)) ||
      threads < 32 || threads > 512 || threads % 32)
    return cudaErrorInvalidValue;
  const FwdLayout L(H, N);
  if ((N - 1) * L.U >= H || S * L.U > threads)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// launch(std::integral_constant<int, Bt>) for the batch rows a cluster the
// kernels are built for (lstm_plan LSTM_ROWS), after the plan's check.
template <typename F>
int by_rows(int B, int H, int N, int Bt, int S, int threads, F launch) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = check_plan(H, N, Bt, S, threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (Bt) {
    case 1: err = launch(std::integral_constant<int, 1>{}); break;
    case 2: err = launch(std::integral_constant<int, 2>{}); break;
    case 4: err = launch(std::integral_constant<int, 4>{}); break;
    case 8: err = launch(std::integral_constant<int, 8>{}); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool kResiduals>
int launch_fwd_plan(const float* xp, const float* kh, const float* valid, float* out, float* acts,
                    float* th, float* c_prev, float* h_prev, int T, int B, int H, int N, int Bt,
                    int S, int threads, void* stream) {
  return by_rows(B, H, N, Bt, S, threads, [&](auto rows) {
    constexpr int kBt = decltype(rows)::value;
    return vsl::launch_cluster(lstm_fwd_cluster_kernel<kResiduals, kBt>, (B + kBt - 1) / kBt * N,
                               N, threads, FwdLayout(H, N).smem_bytes(kBt),
                               static_cast<cudaStream_t>(stream), xp, kh, valid, out, acts, th,
                               c_prev, h_prev, T, B, H, S);
  });
}

}  // namespace

// The forwards take the plan of ops/kernels.py lstm_plan as ints.
extern "C" int vsl_lstm_recurrence_fwd(const float* xp, const float* kh, const float* valid,
                                       float* out, int T, int B, int H, int N, int Bt, int S,
                                       int threads, void* stream) {
  return launch_fwd_plan<false>(xp, kh, valid, out, nullptr, nullptr, nullptr, nullptr, T, B, H,
                                N, Bt, S, threads, stream);
}

extern "C" int vsl_lstm_recurrence_fwd_res(const float* xp, const float* kh, const float* valid,
                                           float* out, float* acts, float* th, float* c_prev,
                                           float* h_prev, int T, int B, int H, int N, int Bt,
                                           int S, int threads, void* stream) {
  return launch_fwd_plan<true>(xp, kh, valid, out, acts, th, c_prev, h_prev, T, B, H, N, Bt, S,
                               threads, stream);
}

// The reverse recurrence on the same plan, then dkh = sum over the T*B rows
// of h_prev^T . dxp; gemm_ws [splits, H, 4H] (unused when splits == 1).
extern "C" int vsl_lstm_recurrence_bwd(const float* dy, const float* acts, const float* th,
                                       const float* c_prev, const float* h_prev,
                                       const float* valid, const float* kh, float* dxp,
                                       float* dkh, float* gemm_ws, int splits, int T, int B,
                                       int H, int N, int Bt, int S, int threads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int err = by_rows(B, H, N, Bt, S, threads, [&](auto rows) {
    constexpr int kBt = decltype(rows)::value;
    return vsl::launch_cluster(lstm_bwd_cluster_kernel<kBt>, (B + kBt - 1) / kBt * N, N, threads,
                               BwdLayout(H, N).smem_bytes(kBt), stream, dy, acts, th, c_prev,
                               valid, kh, dxp, T, B, H, S);
  });
  if (err != 0) return err;
  return static_cast<int>(vsl::wgrad(h_prev, dxp, dkh, gemm_ws, 1, H, 4 * H, T * B, splits, stream));
}

namespace {

// --- the bf16 backward on the tensor cores (#8 at bf16) ----------------------
// A kernel of its own on ops/kernels.py lstm_bwd_bf16_plan: clusters of N
// CTAs and Bt rows, as the fp32 backward, CTA r owning the units [r U, r U
// + U) with U a multiple of 8, so that the gates' padded width Hp = N U
// holds every CTA's units in 16-byte chunks of 8 units' bf16 dgates. W = 4
// MT warps a CTA, MT = ceil(U / 16) m16 tiles of units.
// - Before the first step each warp takes its slice of K = 4 Hp, kTcBwdKSteps
//   k16 steps (0 past K), of the k_h rows of the CTA's units as bf16 mma A
//   fragments [16 MT, 16 kTcBwdKSteps] and keeps them in registers for the
//   whole launch (32 registers a thread at H = 128).
// - The dgates of the step before sit in shared memory as bf16 rows [8][16
//   W kTcBwdKSteps] (the cluster's rows, N padded to 8; gate g of unit j at
//   g Hp + j; rows at tc_stride), double-buffered by parity: half the fp32
//   kernel's bytes.
// - A step: dh^T [U, Bt] = k_h_own . bf16(dgates)^T, each warp's k16 steps
//   one independent mma each (B fragments by ldmatrix), the products added
//   by fp32 adds in a fixed tree; the W partials go to shared memory, one
//   block barrier, and the thread of (unit, row) adds them in warp order
//   (equal calls, equal bits), does that cell's gate gradients with the
//   fp32 kernel's expressions, writes its bf16 dx_proj and its bf16 dgates
//   into its own CTA's next buffer. A second barrier, then the CTA's
//   threads copy its chunks of that buffer to every other CTA of the
//   cluster, one 16-byte st.async each, into the mbarrier-counted buffer.
//   No butterfly, no lane-b select, no shuffles.
// - The barriers also guard the buffers: a CTA's threads write its next
//   buffer and send only after every warp of it has read the step's
//   dgates (the first barrier), and the partials are read before the
//   second, which every thread passes before the next step writes them.
//   The remote copies of a step land in other CTAs' chunks than the ones
//   the receiver writes itself, and, as in the fp32 kernel, only after
//   the receiver has sent the step before, so after it has read the
//   buffer they overwrite.
// - dk_h = sum bf16(h_prev)^T . bf16(dgates) is then mma.cuh's split-K
//   product on the tensor cores (wgrad_tc), summed in fp32 and rounded once.
// What bounds it: the chain of T dependent steps (exchange latency, the
// warps' mma, two block barriers, the gate gradients), not bytes or FLOPs.
constexpr int kTcBwdKSteps = 8;  // k16 steps a warp (kernels.py LSTM_TC_KSTEPS)

// The tensor-core backward's shared memory for MT m16 tiles of units
// (ops/kernels.py lstm_bwd_bf16_plan reports its size; the launch uses this
// one):
//   full [2] mbarrier: the dgates of the step before have arrived, by parity
//   dgb  [2][8][KST] bf16: the dgates of the cluster's rows, KST =
//        tc_stride(16 W kTcBwdKSteps), 0 past the rows, units and gates
//   part [W][16 MT][8] float: the warps' partial dh^T
template <int MT>
struct TcBwdLayout {
  static constexpr int W = 4 * MT;
  static constexpr int KST = vsl::tc_stride(16 * W * kTcBwdKSteps);
  static constexpr size_t kBytes = 16 + 2 * 8 * (size_t)KST * 2 + (size_t)W * MT * 16 * 8 * 4;
};

// 16 bytes into the cluster address `addr`, completing 16 bytes of the
// mbarrier at the cluster address `bar`.
__device__ __forceinline__ void st_async_v4(uint32_t addr, const uint4& v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

template <int MT>
__global__ void __launch_bounds__(128 * MT)
lstm_bwd_tc_kernel(const float* __restrict__ dy, const float* __restrict__ acts,
                   const float* __restrict__ th, const float* __restrict__ c_prev,
                   const float* __restrict__ valid, const __nv_bfloat16* __restrict__ kh,
                   __nv_bfloat16* __restrict__ dxp, int T, int B, int H, int U, int Bt) {
  using Lay = TcBwdLayout<MT>;
  constexpr int W = Lay::W, KST = Lay::KST;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int Hp = N * U, u0 = rank * U, G = 4 * H;
  const int row0 = static_cast<int>(blockIdx.x) / N * Bt, rows = min(Bt, B - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  __nv_bfloat16* dgb = reinterpret_cast<__nv_bfloat16*>(smem4 + 1);
  float* part = reinterpret_cast<float*>(dgb + 2 * 8 * KST);
  // a step's dgates arrive from every other CTA: 4 U bf16 for each valid row
  const uint32_t dg_bytes = 8u * U * rows * (N - 1);
  // the 16-byte chunks a CTA sends a step: (row, gate, 8 units) to each
  // other CTA
  const int chunks = U / 8, sends = rows * 4 * chunks * (N - 1);

  for (int i = tid; i < 8 * KST; i += blockDim.x) reinterpret_cast<uint32_t*>(dgb)[i] = 0u;
  // the A fragments of this warp's K slice: rows m of the CTA's units, k =
  // gate * Hp + column; 0 past U, H and K
  const int kw = warp * kTcBwdKSteps * 16;
  const auto kh_pair = [&](int m, int k) {
    uint32_t out = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gk = (k + e) / Hp, c = k + e - gk * Hp, j = u0 + m;
      if (m < U && j < H && gk < 4 && c < H)
        out |= static_cast<uint32_t>(__bfloat16_as_ushort(kh[(size_t)j * G + gk * H + c])) << (16 * e);
    }
    return out;
  };
  uint32_t a[MT][kTcBwdKSteps][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < kTcBwdKSteps; ++ks) {
      const int k0 = kw + 16 * ks + 2 * tq, m = 16 * mt + g;
      a[mt][ks][0] = kh_pair(m, k0);
      a[mt][ks][1] = kh_pair(m + 8, k0);
      a[mt][ks][2] = kh_pair(m, k0 + 8);
      a[mt][ks][3] = kh_pair(m + 8, k0 + 8);
    }
  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      mbar_init(smem_u32(full + p));
      mbar_expect(smem_u32(full + p), dg_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA's buffers and mbarriers are set before any remote store

  // the (unit, row) of this thread's gate gradients
  const int gu = tid % U, gr = tid / U;
  const int unit = u0 + gu, row = row0 + gr;
  const bool own = tid < U * Bt && gr < rows && unit < H;
  float dc = 0.f, dh_pass = 0.f;
  float in[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // dy, i, g, f, o, tc, c_prev, v
  auto load = [&](int t, float* v) {
    const size_t o = (size_t)t * B + row;
    const float* src[8] = {dy + o * H + unit, acts + o * G + unit, acts + o * G + H + unit,
                           acts + o * G + 2 * H + unit, acts + o * G + 3 * H + unit,
                           th + o * H + unit, c_prev + o * H + unit, valid + o};
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = ld_early(src[k]);
  };
  if (own && T > 0) load(T - 1, in);
  uint32_t phase = 0;  // bit p: the parity of full[p]'s next phase

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s, p = s & 1;
    const __nv_bfloat16* dgc = dgb + (size_t)p * 8 * KST;  // dgates of step t + 1
    __nv_bfloat16* dgn = dgb + (size_t)(p ^ 1) * 8 * KST;
    if (s > 0) {  // stored by every other CTA at step t + 1
      mbar_wait(smem_u32(full + p), (phase >> p) & 1u);
      phase ^= 1u << p;
      if (tid == 0) mbar_expect(smem_u32(full + p), dg_bytes);  // for step t - 1's
    }
    float nx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (own && t > 0) load(t - 1, nx);  // off the chain: the next step's inputs
    float dot = 0.f;
    if (s > 0) {
      float c[kTcBwdKSteps][MT][4];
#pragma unroll
      for (int ks = 0; ks < kTcBwdKSteps; ++ks) {
        uint32_t b[2];
        vsl::ldsm_x2(b, dgc + (lane & 7) * KST + kw + 16 * ks + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) c[ks][mt][e] = 0.f;
          vsl::mma16(c[ks][mt], a[mt][ks], b[0], b[1]);
        }
      }
      // the products' sums in a fixed tree: ((0 + 1) + (2 + 3)) + ...
#pragma unroll
      for (int w = 1; w < kTcBwdKSteps; w *= 2)
#pragma unroll
        for (int ks = 0; ks + w < kTcBwdKSteps; ks += 2 * w)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[ks][mt][e] += c[ks + w][mt][e];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* pw = part + ((size_t)(warp * MT + mt) * 16 + g) * 8 + 2 * tq;
        pw[0] = c[0][mt][0];
        pw[1] = c[0][mt][1];
        pw[64] = c[0][mt][2];
        pw[65] = c[0][mt][3];
      }
      __syncthreads();
      if (own)
#pragma unroll
        for (int w = 0; w < W; ++w) dot += part[((size_t)w * MT * 16 + gu) * 8 + gr];
    }
    if (own) {
      const float v = in[7], ig = in[1], gg = in[2], f = in[3], og = in[4], tc = in[5];
      const float dh = dh_pass + dot;
      const float dh_t = v * (in[0] + dh);
      dh_pass = (1.f - v) * dh;
      const float dc_t = v * dc + dh_t * og * (1.f - tc * tc);
      const float dc_pass = (1.f - v) * dc;
      const float d_o = dh_t * tc;
      const float d_f = dc_t * in[6];
      const float d_i = dc_t * gg;
      const float d_g = dc_t * ig;
      float dg[4];
      dg[0] = d_i * ig * (1.f - ig);
      dg[1] = d_g * (1.f - gg * gg);
      dg[2] = d_f * f * (1.f - f);
      dg[3] = d_o * og * (1.f - og);
      dc = dc_pass + dc_t * f;
      // bf16(dgates): dx_proj, dk_h's operand and the dh product's
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat16 v16 = __float2bfloat16(dg[k]);
        dxp[((size_t)t * B + row) * G + k * H + unit] = v16;
        if (t > 0) dgn[(size_t)gr * KST + k * Hp + unit] = v16;
      }
    }
    if (t > 0) {  // this CTA's chunks of dg_t into every other CTA
      __syncthreads();
      const uint32_t bar = smem_u32(full + (p ^ 1));
      for (int i = tid; i < sends; i += blockDim.x) {
        const int ch = i % chunks, rgc = i / chunks, k = rgc % 4, rc = rgc / 4;
        const int r = rc % rows, other = rc / rows, dst = other < rank ? other : other + 1;
        const __nv_bfloat16* src = dgn + (size_t)r * KST + k * Hp + u0 + 8 * ch;
        st_async_v4(cluster_u32(smem_u32(src), dst), *reinterpret_cast<const uint4*>(src),
                    cluster_u32(bar, dst));
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) in[k] = nx[k];
  }
}

// The tensor-core backward's plan (lstm_bwd_bf16_plan) must fit its layout
// for H: U a multiple of 8 up to 32 (two m16 tiles), every CTA owns a unit,
// 128 threads a 16 units, a thread for each (unit, row), K = 4 N U within
// the warps' kTcBwdKSteps k16 steps.
cudaError_t check_tc_plan(int H, int N, int Bt, int U, int threads) {
  if (H < 1 || N < 1 || N > kMaxCluster || U < 8 || U % 8 || U > 32 || Bt < 1 || Bt > 8 ||
      (N - 1) * U >= H || N * U < H || threads != 128 * ((U + 15) / 16) || U * Bt > threads ||
      4 * N * U > threads / 32 * 16 * kTcBwdKSteps)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// The bf16 backward (#8 at bf16, with _fused_lstm_bwd's casts) on
// lstm_bwd_bf16_plan (N, Bt, U, threads): k_h, dx_proj and dk_h in bf16, dy
// and the residuals fp32. dx_proj = bf16(dgates); dk_h = sum bf16(h_prev)^T
// . bf16(dgates) in fp32 into dkh32 [H, 4H] (wgrad_tc; gemm_ws [splits, H,
// 4H]), then rounded to bf16.
extern "C" int vsl_lstm_recurrence_bwd_bf16(const float* dy, const float* acts, const float* th,
                                            const float* c_prev, const float* h_prev,
                                            const float* valid, const void* kh_, void* dxp_,
                                            void* dkh_, float* dkh32, float* gemm_ws, int splits,
                                            int T, int B, int H, int N, int Bt, int U,
                                            int threads, void* stream_) {
  using bf16 = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = check_tc_plan(H, N, Bt, U, threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  bf16* dxp = static_cast<bf16*>(dxp_);
  e = U > 16 ? vsl::launch_cluster(lstm_bwd_tc_kernel<2>, (B + Bt - 1) / Bt * N, N, threads,
                                   TcBwdLayout<2>::kBytes, stream, dy, acts, th, c_prev, valid,
                                   static_cast<const bf16*>(kh_), dxp, T, B, H, U, Bt)
             : vsl::launch_cluster(lstm_bwd_tc_kernel<1>, (B + Bt - 1) / Bt * N, N, threads,
                                   TcBwdLayout<1>::kBytes, stream, dy, acts, th, c_prev, valid,
                                   static_cast<const bf16*>(kh_), dxp, T, B, H, U, Bt);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = vsl::wgrad_tc(h_prev, static_cast<const bf16*>(dxp), dkh32, gemm_ws, 1, H, 4 * H, T * B,
                    splits, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(vsl::narrow_bf16(dkh32, static_cast<bf16*>(dkh_), H * 4 * H, stream));
}

namespace {

// --- the bf16 forwards on the tensor cores (#1 and #7 at bf16) ---------------
// A kernel of its own on ops/kernels.py lstm_fwd_bf16_plan: clusters of N
// CTAs and Bt rows, as the fp32 forward, CTA r owning the units [r U, r U +
// U), all four gates of each, with U a multiple of 8 (the backward's
// units). U / kTcFwdWarpUnits warps a CTA.
// - Warp w's mma tile holds the four gates of its 4 units: row m of the
//   tile is gate m / 4 of unit r U + 4 w + m % 4. Before step 0 it takes
//   those k_h columns as bf16 mma A fragments [16, 16 KS] (k = h's unit, 0
//   past H) and keeps them in registers for the whole launch (32
//   registers a thread at H = 128).
// - bf16(h) of the cluster's rows sits in shared memory as bf16 rows
//   [8][KST] (rows past Bt and units past H stay 0), double-buffered by
//   step parity; the B fragments load by ldmatrix.
// - A step: gates^T [16, 8] = k_h_own^T . bf16(h)^T, each of the warp's KS
//   k16 steps one independent mma, the products added by fp32 adds in a
//   fixed tree ((0 + 1) + (2 + 3)) + ..., then x_proj[t] (equal calls give
//   equal bits). Lane l holds rows g and g + 8 of columns 2 tq and 2 tq + 1:
//   below lane 16 gates i and f, from lane 16 on gates j and o, of unit g %
//   4. Lanes l and l ^ 16 swap by two shuffles the two values the other
//   needs, and each does the gate math of one (unit, row), column 2 tq + l /
//   16, with the fp32 kernel's expressions, keeping c and the carried fp32
//   h in registers: no partials in shared memory.
// - The exchange: two shuffles gather the warp's 4 units of bf16(h_(t+1))
//   of a row into 8 bytes, and the warp's lanes send them, one 8-byte
//   st.async each, into the next buffer of every CTA of the cluster, its
//   own included, whose mbarrier counts the bytes: no block barrier in the
//   step (a CTA's 16-byte chunks of 8 units need one between two warps:
//   PERF.md has both timed).
// - No barrier guards the buffer a store overwrites, as in the fp32
//   kernel: a warp that has all of h_t knows every warp of the cluster has
//   sent its piece of h_t, so has read h_(t-1), the buffer h_(t+1) goes
//   into. No step sends h_T.
// - x_proj[t + 1] and valid[t + 1] are loaded a step ahead.
// What bounds it: the chain of T dependent steps (exchange latency, the
// warp's mma, the gate math, the gather), not bytes or FLOPs.
constexpr int kTcFwdWarpUnits = 4;  // units a warp's m16 tile (kernels.py LSTM_FWD_TC_WARP_UNITS)

// The tensor-core forward's shared memory for KS k16 steps (ops/kernels.py
// lstm_fwd_bf16_plan reports its size; the launch uses this one):
//   full [2] mbarrier: h of the next step has arrived, by step parity
//   hbuf [2][8][KST] bf16: h of the cluster's rows, KST = tc_stride(16 KS)
template <int KS>
struct TcFwdLayout {
  static constexpr int KST = vsl::tc_stride(16 * KS);
  static constexpr size_t kBytes = 16 + 2 * 8 * (size_t)KST * 2;
};

// 8 bytes (lo, hi) into the cluster address `addr`, completing 8 bytes of
// the mbarrier at the cluster address `bar`.
__device__ __forceinline__ void st_async_v2(uint32_t addr, uint32_t lo, uint32_t hi,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "r"(lo), "r"(hi), "r"(bar)
      : "memory");
}

// sigmoid(x) as vsl::sigmoidf_ computes it: 1 / y correctly rounded is the
// reciprocal correctly rounded, without the division's general path.
__device__ __forceinline__ float sigmoid_rcp(float x) { return __frcp_rn(1.f + expf(-x)); }

// The A fragments of a warp's tile: k_h[k, gate H + unit] at row 4 gate +
// unit - uw, column k; 0 past H.
template <int KS>
__device__ __forceinline__ void fwd_tc_fragments(uint32_t (&a)[KS][4],
                                                 const __nv_bfloat16* __restrict__ kh, int H,
                                                 int uw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, G = 4 * H;
  const auto pair = [&](int m, int k) {
    const int gate = m >> 2, unit = uw + (m & 3);
    uint32_t out = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (unit < H && k + e < H)
        out |= static_cast<uint32_t>(__bfloat16_as_ushort(kh[(size_t)(k + e) * G + gate * H + unit]))
               << (16 * e);
    return out;
  };
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k0 = 16 * ks + 2 * tq;
    a[ks][0] = pair(g, k0);
    a[ks][1] = pair(g + 8, k0);
    a[ks][2] = pair(g, k0 + 8);
    a[ks][3] = pair(g + 8, k0 + 8);
  }
}

// The step's product for this thread's (unit, column): gate[0..3] = i, j,
// f, o of dot(bf16(h), k_h), h the shared rows hc at stride KST.
template <int KS>
__device__ __forceinline__ void fwd_tc_gates(float (&gate)[4], const uint32_t (&a)[KS][4],
                                             const __nv_bfloat16* hc) {
  constexpr int KST = TcFwdLayout<KS>::KST;
  const int lane = threadIdx.x & 31;
  float d[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ks += 2) {  // one ldmatrix for two k16 steps
    uint32_t b[4];
    if constexpr (KS == 1)
      vsl::ldsm_x2(*reinterpret_cast<uint32_t(*)[2]>(b), hc + (lane & 7) * KST + ((lane >> 3) & 1) * 8);
    else
      vsl::ldsm_x4(b, hc + (lane & 7) * KST + 16 * ks + (lane >> 3) * 8);
#pragma unroll
    for (int j = 0; j < 2 && ks + j < KS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[ks + j][e] = 0.f;
      vsl::mma16(d[ks + j], a[ks + j], b[2 * j], b[2 * j + 1]);
    }
  }
  // the products' sums in a fixed tree: ((0 + 1) + (2 + 3)) + ...
#pragma unroll
  for (int w = 1; w < KS; w *= 2)
#pragma unroll
    for (int ks = 0; ks + w < KS; ks += 2 * w)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[ks][e] += d[ks + w][e];
  // lane l < 16 keeps i and f of column 2 tq and takes j and o of it from
  // lane l + 16, which keeps those of column 2 tq + 1 and takes i and f
  const bool upper = lane >= 16;
  const float s0 = __shfl_xor_sync(0xffffffffu, upper ? d[0][0] : d[0][1], 16);
  const float s1 = __shfl_xor_sync(0xffffffffu, upper ? d[0][2] : d[0][3], 16);
  gate[0] = upper ? s0 : d[0][0];
  gate[1] = upper ? d[0][1] : s0;
  gate[2] = upper ? s1 : d[0][2];
  gate[3] = upper ? d[0][3] : s1;
}

template <bool kResiduals, int KS>
__global__ void __launch_bounds__(256)
lstm_fwd_tc_kernel(const __nv_bfloat16* __restrict__ xp, const __nv_bfloat16* __restrict__ kh,
                   const float* __restrict__ valid, float* __restrict__ out,
                   float* __restrict__ acts, float* __restrict__ th, float* __restrict__ c_prev,
                   float* __restrict__ h_prev, int T, int B, int H, int U, int Bt) {
  constexpr int KST = TcFwdLayout<KS>::KST;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int u0 = rank * U, G = 4 * H;
  const int row0 = static_cast<int>(blockIdx.x) / N * Bt, rows = min(Bt, B - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem4 + 1);
  // a step's h arrives from every CTA, this one included: N U bf16 for each
  // valid row, 8 bytes a warp's piece
  const uint32_t h_bytes = 2u * N * U * rows;
  const int sends = rows * N;  // a warp's pieces a step: (row, CTA)

  for (int i = tid; i < 8 * KST; i += blockDim.x) reinterpret_cast<uint32_t*>(hbuf)[i] = 0u;
  const int uw = u0 + kTcFwdWarpUnits * warp;
  uint32_t a[KS][4];
  fwd_tc_fragments<KS>(a, kh, H, uw);
  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      mbar_init(smem_u32(full + p));
      mbar_expect(smem_u32(full + p), h_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA's buffers and mbarriers are set before any remote store

  // the (unit, column) of this thread's gate math: column 2 tq + l / 16 of
  // the cluster's rows
  const int unit = uw + ((lane >> 2) & 3), col = 2 * (lane & 3) + (lane >> 4);
  const int row = row0 + col;
  const bool own = col < rows && unit < H;
  float c = 0.f, hreg = 0.f, x[4] = {0.f, 0.f, 0.f, 0.f}, v = 0.f;
  if (own && T > 0) {
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = vsl::to_float(xp[(size_t)row * G + g * H + unit]);
    v = valid[row];
  }
  // the warp's pieces this lane sends each step, s = lane and lane + 32:
  // column s / N (its units in lanes src + 4 j) into CTA s % N, at the
  // cluster addresses of both buffers and mbarriers
  int src[2];
  bool on[2];
  uint32_t dst_h[2][2], dst_bar[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = 32 * i + lane, sc = min(s, sends - 1) / N, dst = s < sends ? s - sc * N : 0;
    on[i] = s < sends;
    src[i] = (sc & 1) * 16 + (sc >> 1);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      dst_h[i][q] = cluster_u32(smem_u32(hbuf + (size_t)q * 8 * KST + (size_t)sc * KST + uw), dst);
      dst_bar[i][q] = cluster_u32(smem_u32(full + q), dst);
    }
  }
  uint32_t phase = 0;  // bit p: the parity of full[p]'s next phase

  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    const __nv_bfloat16* hc = hbuf + (size_t)p * 8 * KST;
    if (t > 0) {  // h_t, stored by every CTA at step t - 1
      mbar_wait(smem_u32(full + p), (phase >> p) & 1u);
      phase ^= 1u << p;
      if (tid == 0) mbar_expect(smem_u32(full + p), h_bytes);  // for h_(t+2)
    }
    unsigned short nx[4] = {0, 0, 0, 0};
    float nv = 0.f;
    if (own && t + 1 < T) {  // off the chain: the next step's inputs
      const size_t next = (size_t)(t + 1) * B + row;
#pragma unroll
      for (int g = 0; g < 4; ++g) nx[g] = ld_early(xp + next * G + g * H + unit);
      nv = ld_early(valid + next);
    }
    float gate[4];
    fwd_tc_gates<KS>(gate, a, hc);
    float ig = 0.f, gg = 0.f, f = 0.f, og = 0.f, tc = 0.f, cp = 0.f, hp = 0.f, ho = 0.f;
    if (own) {
      ig = sigmoid_rcp(gate[0] + x[0]);
      gg = tanhf(gate[1] + x[1]);
      f = sigmoid_rcp(gate[2] + x[2] + 1.f);
      og = sigmoid_rcp(gate[3] + x[3]);
      cp = c;
      const float cn = cp * f + ig * gg;
      tc = tanhf(cn);
      c = v * cn + (1.f - v) * cp;
      hp = hreg;
      ho = v * (tc * og);
      hreg = ho + (1.f - v) * hp;
    }
    if (t + 1 < T) {  // the warp's pieces of h_(t+1) into every CTA
      // units 0-3 of a column by four shuffles (units past H carry 0)
      const uint32_t hb = __bfloat16_as_ushort(__float2bfloat16(hreg));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && sends <= 32) break;
        uint32_t u[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) u[j] = __shfl_sync(0xffffffffu, hb, src[i] + 4 * j);
        if (on[i])  // into the buffer of parity p ^ 1
          st_async_v2(p ? dst_h[i][0] : dst_h[i][1], u[0] | (u[1] << 16), u[2] | (u[3] << 16),
                      p ? dst_bar[i][0] : dst_bar[i][1]);
      }
    }
    if (own) {  // the step's outputs, off the chain
      const size_t o = (size_t)t * B + row;
      out[o * H + unit] = ho;
      if (kResiduals) {
        acts[o * G + unit] = ig;
        acts[o * G + H + unit] = gg;
        acts[o * G + 2 * H + unit] = f;
        acts[o * G + 3 * H + unit] = og;
        th[o * H + unit] = tc;
        c_prev[o * H + unit] = cp;
        h_prev[o * H + unit] = hp;
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = widen(nx[g]);
    v = nv;
  }
}

// The k16 steps of K that cover h's padded width N U (a power of two, so
// that each count has a kernel of its own: a runtime trip count splits the
// unrolled mma loop).
int fwd_tc_ksteps(int N, int U) {
  int ks = 1;
  while (16 * ks < N * U) ks *= 2;
  return ks;
}

// The tensor-core forward's plan (lstm_fwd_bf16_plan) must fit its layout
// for H: U a multiple of 8 up to 32, every CTA owns a unit, a warp a 4
// units, Bt rows within the mma's 8 columns, h's padded width within 16
// k16 steps.
cudaError_t check_fwd_tc_plan(int H, int N, int Bt, int U, int threads) {
  if (H < 1 || N < 1 || N > kMaxCluster || U < 8 || U % 8 || U > 32 || Bt < 1 || Bt > 8 ||
      (N - 1) * U >= H || N * U < H || threads != 32 * U / kTcFwdWarpUnits ||
      fwd_tc_ksteps(N, U) > 16)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <bool kResiduals>
int launch_fwd_tc(const void* xp_, const void* kh_, const float* valid, float* out, float* acts,
                  float* th, float* c_prev, float* h_prev, int T, int B, int H, int N, int Bt,
                  int U, int threads, void* stream_) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = check_fwd_tc_plan(H, N, Bt, U, threads);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* xp = static_cast<const __nv_bfloat16*>(xp_);
  const auto* kh = static_cast<const __nv_bfloat16*>(kh_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int ctas = (B + Bt - 1) / Bt * N;
  const auto launch = [&](auto steps) {
    constexpr int KS = decltype(steps)::value;
    return vsl::launch_cluster(lstm_fwd_tc_kernel<kResiduals, KS>, ctas, N, threads,
                               TcFwdLayout<KS>::kBytes, stream, xp, kh, valid, out, acts, th,
                               c_prev, h_prev, T, B, H, U, Bt);
  };
  switch (fwd_tc_ksteps(N, U)) {
    case 1: e = launch(std::integral_constant<int, 1>{}); break;
    case 2: e = launch(std::integral_constant<int, 2>{}); break;
    case 4: e = launch(std::integral_constant<int, 4>{}); break;
    case 8: e = launch(std::integral_constant<int, 8>{}); break;
    case 16: e = launch(std::integral_constant<int, 16>{}); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// The bf16 lean forward (#1 at bf16) on lstm_fwd_bf16_plan (N, Bt, U,
// threads): x_proj [T, B, 4H] and k_h [H, 4H] in bf16, valid and the output
// fp32.
extern "C" int vsl_lstm_recurrence_fwd_bf16(const void* xp, const void* kh, const float* valid,
                                            float* out, int T, int B, int H, int N, int Bt, int U,
                                            int threads, void* stream) {
  return launch_fwd_tc<false>(xp, kh, valid, out, nullptr, nullptr, nullptr, nullptr, T, B, H, N,
                              Bt, U, threads, stream);
}

// The bf16 forward with residuals (#7 at bf16) on the same plan: x_proj and
// k_h in bf16, the five outputs fp32, as the TPU kernel writes them (h_prev
// is the carried fp32 h, which the backward rounds for dk_h).
extern "C" int vsl_lstm_recurrence_fwd_res_bf16(const void* xp, const void* kh,
                                                const float* valid, float* out, float* acts,
                                                float* th, float* c_prev, float* h_prev, int T,
                                                int B, int H, int N, int Bt, int U, int threads,
                                                void* stream) {
  return launch_fwd_tc<true>(xp, kh, valid, out, acts, th, c_prev, h_prev, T, B, H, N, Bt, U,
                             threads, stream);
}
