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
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

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
    float nx[4] = {0.f, 0.f, 0.f, 0.f}, nv = 0.f;
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
    return vsl::launch_cluster(lstm_bwd_cluster_kernel<kBt>, (B + kBt - 1) / kBt * N, N,
                               threads, BwdLayout(H, N).smem_bytes(kBt), stream, dy, acts, th,
                               c_prev, valid, kh, dxp, T, B, H, S);
  });
  if (err != 0) return err;
  return static_cast<int>(vsl::wgrad(h_prev, dxp, dkh, gemm_ws, 1, H, 4 * H, T * B, splits, stream));
}
