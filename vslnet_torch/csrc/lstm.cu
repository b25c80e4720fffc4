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
// Backward design: one launch for all T steps, one block per batch row, 4H
// threads; dh and dc live in shared memory. H threads form dgates and the
// new dc; then all 4H threads form dgates.k_h^T as four partial sums over
// quarters of the gates, reading k_h^T [4H, H] (coalesced along H) from
// L2; H threads add the four. Bound by its chain of T steps on B SMs.
#include <cooperative_groups.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

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

// The set-up a configuration needs once per device, so that later calls go
// straight to the launch: the opt-in to its dynamic shared memory (raised,
// never lowered, as another H may need more of the same kernel) and the
// check that the card can schedule one of its clusters.
cudaError_t ready_to_launch(const void* fn, const cudaLaunchConfig_t& cfg, int N) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> opt_in;
  static std::set<std::tuple<const void*, int, int, unsigned, size_t>> ready;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(fn, dev, N, cfg.blockDim.x, cfg.dynamicSmemBytes);
  std::lock_guard<std::mutex> lock(mu);
  if (ready.count(key)) return cudaSuccess;
  size_t& bytes = opt_in[{fn, dev}];
  if (cfg.dynamicSmemBytes > bytes) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.dynamicSmemBytes));
    if (err != cudaSuccess) return err;
    bytes = cfg.dynamicSmemBytes;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;  // the plan cannot be scheduled
  ready.insert(key);
  return cudaSuccess;
}

template <bool kResiduals, int kBt>
cudaError_t launch_fwd(const float* xp, const float* kh, const float* valid, float* out,
                       float* acts, float* th, float* c_prev, float* h_prev, int T, int B, int H,
                       int N, int S, int threads, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(lstm_fwd_cluster_kernel<kResiduals, kBt>);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + kBt - 1) / kBt * N);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = FwdLayout(H, N).smem_bytes(kBt);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = ready_to_launch(fn, cfg, N);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, lstm_fwd_cluster_kernel<kResiduals, kBt>, xp, kh, valid, out,
                            acts, th, c_prev, h_prev, T, B, H, S);
}

template <bool kResiduals>
int launch_fwd_plan(const float* xp, const float* kh, const float* valid, float* out, float* acts,
                    float* th, float* c_prev, float* h_prev, int T, int B, int H, int N, int Bt,
                    int S, int threads, void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = check_plan(H, N, Bt, S, threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto launch = [&](auto rows) {
    return launch_fwd<kResiduals, decltype(rows)::value>(xp, kh, valid, out, acts, th, c_prev,
                                                         h_prev, T, B, H, N, S, threads,
                                                         static_cast<cudaStream_t>(stream));
  };
  switch (Bt) {  // the batch rows a cluster the kernel is built for (lstm_plan LSTM_ROWS)
    case 1: err = launch(std::integral_constant<int, 1>{}); break;
    case 2: err = launch(std::integral_constant<int, 2>{}); break;
    case 4: err = launch(std::integral_constant<int, 4>{}); break;
    case 8: err = launch(std::integral_constant<int, 8>{}); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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
