// Flash multi-head attention, forward and backward: fused_mha's long-T
// route, replacing the TPU kernels
// vslnet_tpu/ops/pallas_kernels.py:_make_flash_fwd_kernel and
// _make_flash_bwd_kernel (via _mha_flash_fwd_raw / _mha_flash_bwd_raw).
// Same function as the whole-T kernels (mha_block.cu): q, k, v [B, T, D],
// key mask [B, T] added as (1 - m) * (-1e30), fp32 softmax per head, each
// head's probabilities dropped by the counter hash at the GLOBAL (t, j) of
// its [T, T] tile (hash.cuh head_salt), so both routes drop the same
// elements; no [T, T] tile exists anywhere.
//
// Forward: one pass a (query tile, head, row) CTA on the plan of
// ops/kernels.py flash_fwd_plan: kFwdThreads query slots, each keeping RQ
// query rows (2 up to head dim 16, else 1; TQ = RQ * kFwdThreads queries a
// CTA) pre-scaled in registers, in each of kFwdGroups thread groups. The
// head's K and V stream through two shared buffers of kFwdKeys keys by
// cp.async, the next tile landing while the current one is worked on;
// each group takes its share of a tile's keys (so that an SM holds twice
// the warps a slot a thread would give it), and at the end the groups'
// partial softmaxes (m, l, P.V) merge in group order. 64 slots in 2 groups
// beat 128 in 1 or 2 and 64 in 4 at path L (vslnet_torch/bench/
// flash_plans.py --forward, PERF.md). A thread takes its
// keys in blocks of kFwdBlock: the block's scores, each in common.cuh's score order, from K
// rows read as float4 broadcasts (one load feeds RQ * 4 FMAs); then the
// online softmax once a block and row (the block's max, one exp to rescale
// l and the P.V accumulator); then per key one exp, at drop > 0 one hash
// (the hash's row term once a row, its column term once a key), and
// drop(P).V from V rows read as float4 broadcasts. No branch depends on the
// data. It writes out and lse = m + log(l) per (row, head, query) into
// lse [B, H, T].
//
// Backward: one pass over (row, head, key tile) CTAs on the plan of
// ops/kernels.py flash_bwd_plan (key tile TK = bwd_key_tile), no atomics:
//   1. delta_t = g_t . out_t per (row, head, query) into delta [B, H, T].
//   2. CTA r of a (row, head) keeps the keys [r TK, (r + 1) TK) (K_j, V_j)
//      in shared memory and streams every query tile of 64 (Q_i, G_i,
//      lse_i, delta_i) through two shared buffers by cp.async, the next
//      tile landing while the current one is worked on. Per tile, with
//      register tiles of compile-time sizes out of shared memory
//      (flash_bwd_kernel): S = (Q * scale).K^T and G.V^T in one pass,
//      then P = exp(S + mask - lse) and the keep bit, each once a (t, j),
//      drop(P) and dS = P * (drop(G.V^T) - delta); dV += drop(P)^T.G and
//      dK += dS^T.(Q * scale), summed in registers over the query tiles;
//      the tile's dQ partial dS.K, written to a workspace [n, B, T, D].
//   3. dq = scale * the n key tiles' partials, summed in key-tile order
//      by a short launch.
// Two equal calls give equal bits. A cluster of a (row, head)'s key tiles
// summing dQ through distributed shared memory instead of the workspace
// was slower at path L's shape (PERF.md): a cluster holds its SMs until
// its last CTA ends, so the CTAs of fully masked key tiles, which end at
// once, idled their SMs, and its 175 KB CTAs packed fewer to the card.
//
// Masked keys. A key tile whose keys are all masked is skipped where the
// row has a valid key: there exp(-1e30 - m) is 0 exactly, so the result is
// unchanged. A row with no valid key (every score -1e30 exactly) keeps the
// uniform softmax over all T keys, as the plain version has it: the
// forward runs every tile, and the backward takes p = 1/T instead of
// exp(s - lse), since lse = -1e30 + log(T) rounds to -1e30 and would give
// p = 1 (the TPU kernel's backward does that; it is not copied).
//
// What bounds them: the forward's 2*HD FMAs, an exp and (drop > 0) a
// hash's mix per (query, key) pair, on the FMA and ALU pipes (its K and V
// loads are broadcasts, one per RQ * 4 FMAs); the backward's five products, 10*HD
// FLOPs a pair, out of shared memory, with one exp and one hash a pair;
// bytes are q, k, v (and g, out) read once a tile, the outputs written
// once.
//
// bf16 (vsl_flash_mha_fwd_bf16, vsl_flash_mha_bwd_bf16; the TPU kernels at
// dtype bf16, pallas_kernels.py:1395-1529): the same kernels templated on
// the storage type of q, k, v, out and g (and of dq, dk, dv); lse, delta
// and the dQ partials stay fp32. The forward takes qs = bf16(q * bf16
// scale) and rounds each probability for P.V unnormalised, p = exp(s - m),
// against the running max m of the TPU kernel's 1024-key windows
// (kFlashWindow): since it streams 64-key tiles with a running max of its
// own, it takes each window's tiles twice, first for the window's row max
// (the thread groups' maxima merged through shared memory), then for
// exp(s - m), l (unrounded) and bf16(drop(p)).V; out = bf16(acc / l). The
// backward scales q by the FP32 1/sqrt(hd) and rounds it (pallas_kernels.py
// :1460, ROADMAP.md C6), rounds drop(P) for dV and dS for dQ and dK, sums
// dK and dV over every query tile in fp32 and rounds them once. At bf16
// the forward's max pass repeats the q.k products, about 1.5x the FMAs of
// the fp32 forward.
#include "common.cuh"
#include "hash.cuh"

namespace {

// True on every thread if any key of the row is valid (mask != 0).
__device__ bool row_has_key(const float* mrow, int T) {
  int any = 0;
  for (int j = threadIdx.x; j < T; j += blockDim.x) any |= mrow[j] != 0.f;
  return __syncthreads_or(any) != 0;
}

constexpr int kFwdThreads = 64;   // the forward's query slots a CTA
constexpr int kFwdGroups = 2;     // thread groups that split a key tile: threads = slots x groups
constexpr int kFwdKeys = 64;      // keys a streamed tile
constexpr int kFwdBlock = 8;      // keys a step of the online softmax
constexpr float kLog2e = 1.4426950408889634f;
// keys a tile of the TPU forward's online softmax (pallas_kernels.py
// _FLASH_TK): at bf16 the probabilities are rounded against the running
// max of such windows, so the kernel takes each window's max first
constexpr int kFlashWindow = 1024;

// The forward's shared memory at head dim hd and rq query rows a thread,
// in floats: two buffers of a key tile's K, V [kFwdKeys][hd] and key mask
// [kFwdKeys]; after the keys, the same memory holds the groups' partial
// m, l and P.V [kFwdGroups - 1][rq][hd + 2][kFwdThreads] for the merge
// (ops/kernels.py flash_fwd_plan reports it).
__host__ __device__ inline size_t flash_fwd_floats(int hd, int rq) {
  const size_t keys = 2 * (2 * (size_t)kFwdKeys * hd + kFwdKeys);
  const size_t merge = (size_t)(kFwdGroups - 1) * rq * (hd + 2) * kFwdThreads;
  return keys > merge ? keys : merge;
}

template <int HD, int RQ, bool kDrop, typename T = float>
__global__ void __launch_bounds__(kFwdThreads * kFwdGroups)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask, vsl::Dropout drop,
                 T* __restrict__ out, float* __restrict__ lse, int Tn, int D, float scale) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  constexpr int TQ = RQ * kFwdThreads, TK = kFwdKeys, CK = kFwdBlock, H4 = HD / 4;
  constexpr int NT = kFwdThreads * kFwdGroups, GK = TK / kFwdGroups;  // keys a group a tile
  constexpr int BUF = 2 * TK * HD + TK;  // one buffer's floats
  constexpr int E = 16 / sizeof(T), HC = HD / E;  // a 16-byte chunk's values, a row's chunks
  constexpr int WT = kFlashWindow / TK;           // key tiles a window of the TPU kernel
  static_assert(HD % 4 == 0 && GK % CK == 0 && HD % E == 0 && kFlashWindow % TK == 0,
                "tile sizes");
  // bf16: the windows' maxima pass through buffer 1's free end, past its
  // packed K, V and mask, which the next tile's cp.async may be filling
  static_assert(!kBf16 || kFwdGroups * RQ * kFwdThreads <= TK * HD,
                "the window maxima overlap a bf16 buffer's keys");
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int T_ = Tn;
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y, tid = threadIdx.x;
  const int slot = tid % kFwdThreads, grp = tid / kFwdThreads;  // query slot, key group
  const int t0 = blockIdx.x * TQ, n = (T_ + TK - 1) / TK;
  const float* mrow = mask + (size_t)b * T_;
  const size_t base = (size_t)b * T_ * D + h * HD;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const bool has_key = row_has_key(mrow, T_);
  // a buffer's K, V (bf16: packed, half the floats) and key mask
  const auto keys_of = [&](int slot_) { return reinterpret_cast<T*>(buf + slot_ * BUF); };
  const auto mask_of = [&](int slot_) {
    return buf + slot_ * BUF + (kBf16 ? TK * HD : 2 * TK * HD);
  };
  // key tile i into buffer `to`, one commit group; keys past T are zero
  // with mask -1, so their scores lie near -2e30 and their p is 0 beside
  // any real key's
  auto issue = [&](int i, int to) {
    T* Ks = keys_of(to);
    T* Vs = Ks + TK * HD;
    float* Ms = mask_of(to);
    const int j0 = i * TK, nk = min(TK, T_ - j0);
    for (int e = tid; e < TK * HC; e += NT) {
      const int jj = e / HC, c4 = e - jj * HC;
      if (jj < nk) {
        const size_t src = base + (size_t)(j0 + jj) * D + E * c4;
        vsl::cp_async_float4(reinterpret_cast<float*>(Ks + E * e),
                             reinterpret_cast<const float*>(k + src));
        vsl::cp_async_float4(reinterpret_cast<float*>(Vs + E * e),
                             reinterpret_cast<const float*>(v + src));
      } else {
        *reinterpret_cast<float4*>(Ks + E * e) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(Vs + E * e) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int jj = tid; jj < TK; jj += NT) {
      if (jj < nk)
        vsl::cp_async_float(Ms + jj, mrow + j0 + jj);
      else
        Ms[jj] = -1.f;
    }
    vsl::cp_async_commit();
  };
  // the steps over the key tiles: at fp32 one a tile; at bf16 two a tile,
  // window by window (WT tiles each, the last one ragged): its tiles for
  // the window's row max, then again for exp(s - m), P.V and the sums
  const int nsteps = kBf16 ? 2 * n : n;
  const auto tile_at = [&](int st) {
    if (!kBf16) return st;
    const int w = st / (2 * WT), r = st - 2 * w * WT, c = min(WT, n - w * WT);
    return w * WT + (r < c ? r : r - c);
  };
  float qr[RQ][HD], acc[RQ][HD], m[RQ], l[RQ], wm[RQ];
  uint32_t hr[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int t = t0 + r * kFwdThreads + slot;
    const T* qt = q + base + (size_t)min(t, T_ - 1) * D;
#pragma unroll
    for (int c4 = 0; c4 < H4; ++c4) {
      const float4 x = vsl::load4(qt + 4 * c4);
      qr[r][4 * c4 + 0] = x.x * scale;
      qr[r][4 * c4 + 1] = x.y * scale;
      qr[r][4 * c4 + 2] = x.z * scale;
      qr[r][4 * c4 + 3] = x.w * scale;
    }
    if constexpr (kBf16) {  // bf16(q_h * scale), the scale already bf16
#pragma unroll
      for (int d = 0; d < HD; ++d) qr[r][d] = vsl::bf16_round(qr[r][d]);
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[r][d] = 0.f;
    m[r] = -FLT_MAX;
    l[r] = 0.f;
    wm[r] = -FLT_MAX;
    hr[r] = vsl::hash_row(t);
  }
  issue(tile_at(0), 0);
  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) {
      issue(tile_at(st + 1), (st + 1) & 1);
      vsl::cp_async_wait<1>();
    } else {
      vsl::cp_async_wait<0>();
    }
    const int i = tile_at(st);
    const int j0 = i * TK, nk = min(TK, T_ - j0);
    // at bf16: the window's max pass, and whether this is its last tile
    const int w = st / (2 * WT), wr = st - 2 * w * WT, wc = min(WT, n - w * WT);
    const bool max_pass = kBf16 && wr < wc;
    int live = 0;
    for (int jj = tid; jj < nk; jj += NT) live |= mrow[j0 + jj] != 0.f;
    // tile i landed for every thread; a tile of masked keys on a row with a
    // valid key adds exp(-1e30 - m) = 0 exactly (nor moves a max), and is
    // skipped
    if (__syncthreads_or(live) || !has_key) {
      const T* Ks = keys_of(st & 1);
      const T* Vs = Ks + TK * HD;
      const float* Ms = mask_of(st & 1);
      // this group's keys of the tile, [grp GK, (grp + 1) GK)
      for (int c0 = grp * GK; c0 < min(nk, (grp + 1) * GK); c0 += CK) {
        float s[RQ][CK];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < CK; ++c) s[r][c] = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < H4; ++k4) {
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            const float4 kk = vsl::load4(Ks + (c0 + c) * HD + 4 * k4);
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
              s[r][c] = fmaf(qr[r][4 * k4 + 0], kk.x, s[r][c]);
              s[r][c] = fmaf(qr[r][4 * k4 + 1], kk.y, s[r][c]);
              s[r][c] = fmaf(qr[r][4 * k4 + 2], kk.z, s[r][c]);
              s[r][c] = fmaf(qr[r][4 * k4 + 3], kk.w, s[r][c]);
            }
          }
        }
        if constexpr (kBf16) {
          if (max_pass) {  // + the key mask's -1e30 terms; the window's max
#pragma unroll
            for (int r = 0; r < RQ; ++r)
#pragma unroll
              for (int c = 0; c < CK; ++c)
                wm[r] = fmaxf(wm[r], s[r][c] + (1.f - Ms[c0 + c]) * vsl::kMaskValue);
            continue;
          }
          // p = exp(s - m) against the window's running max, unnormalised:
          // l sums it unrounded, P.V takes bf16(drop(p))
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            float p[RQ];
            const uint32_t hc = kDrop ? vsl::hash_col(j0 + c0 + c, seed, salt) : 0u;
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
              p[r] = expf(s[r][c] + (1.f - Ms[c0 + c]) * vsl::kMaskValue - m[r]);
              l[r] += p[r];
              if (kDrop)
                p[r] = vsl::hash_mix(hr[r] ^ hc) >= drop.thresh ? p[r] * drop.scale : 0.f;
              p[r] = vsl::bf16_round(p[r]);
            }
#pragma unroll
            for (int d4 = 0; d4 < H4; ++d4) {
              const float4 vv = vsl::load4(Vs + (c0 + c) * HD + 4 * d4);
#pragma unroll
              for (int r = 0; r < RQ; ++r) {
                acc[r][4 * d4 + 0] = fmaf(p[r], vv.x, acc[r][4 * d4 + 0]);
                acc[r][4 * d4 + 1] = fmaf(p[r], vv.y, acc[r][4 * d4 + 1]);
                acc[r][4 * d4 + 2] = fmaf(p[r], vv.z, acc[r][4 * d4 + 2]);
                acc[r][4 * d4 + 3] = fmaf(p[r], vv.w, acc[r][4 * d4 + 3]);
              }
            }
          }
        } else {
          // + the key mask's -1e30 terms; the block's max; one rescale a row
#pragma unroll
          for (int r = 0; r < RQ; ++r) {
            float mx = m[r];
#pragma unroll
            for (int c = 0; c < CK; ++c) {
              s[r][c] += (1.f - Ms[c0 + c]) * vsl::kMaskValue;
              mx = fmaxf(mx, s[r][c]);
            }
            const float f = exp2f((m[r] - mx) * kLog2e);
            m[r] = mx;
            l[r] *= f;
#pragma unroll
            for (int d = 0; d < HD; ++d) acc[r][d] *= f;
          }
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            float p[RQ];
            const uint32_t hc = kDrop ? vsl::hash_col(j0 + c0 + c, seed, salt) : 0u;
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
              p[r] = exp2f((s[r][c] - m[r]) * kLog2e);
              l[r] += p[r];
              if (kDrop) p[r] = vsl::hash_mix(hr[r] ^ hc) >= drop.thresh ? p[r] : 0.f;
            }
#pragma unroll
            for (int d4 = 0; d4 < H4; ++d4) {
              const float4 vv = vsl::load4(Vs + (c0 + c) * HD + 4 * d4);
#pragma unroll
              for (int r = 0; r < RQ; ++r) {
                acc[r][4 * d4 + 0] = fmaf(p[r], vv.x, acc[r][4 * d4 + 0]);
                acc[r][4 * d4 + 1] = fmaf(p[r], vv.y, acc[r][4 * d4 + 1]);
                acc[r][4 * d4 + 2] = fmaf(p[r], vv.z, acc[r][4 * d4 + 2]);
                acc[r][4 * d4 + 3] = fmaf(p[r], vv.w, acc[r][4 * d4 + 3]);
              }
            }
          }
        }
      }
    }
    if (kBf16 && wr == wc - 1) {
      // the window's max pass done: both groups' maxima through the free
      // end of buffer 1, then the running max moves to the window's and l
      // and P.V rescale, alike in every group
      float* red = buf + 2 * BUF - kFwdGroups * RQ * kFwdThreads;
#pragma unroll
      for (int r = 0; r < RQ; ++r) red[(grp * RQ + r) * kFwdThreads + slot] = wm[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        float mx = m[r];
        for (int g = 0; g < kFwdGroups; ++g) mx = fmaxf(mx, red[(g * RQ + r) * kFwdThreads + slot]);
        const float f = expf(m[r] - mx);
        m[r] = mx;
        l[r] *= f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[r][d] *= f;
        wm[r] = -FLT_MAX;
      }
    }
    __syncthreads();  // buffer st & 1 (and the maxima) read before it is refilled
  }
  // the key groups' partial softmaxes merged in group order: groups 1..
  // hand m, l and P.V to group 0 through the free buffers (at bf16 their m
  // are equal, so the factors are 1)
  float* part = buf;
  if (grp > 0) {
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      float* pr = part + ((size_t)((grp - 1) * RQ + r) * (HD + 2)) * kFwdThreads + slot;
      pr[0] = m[r];
      pr[kFwdThreads] = l[r];
#pragma unroll
      for (int d = 0; d < HD; ++d) pr[(2 + d) * kFwdThreads] = acc[r][d];
    }
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    for (int g = 1; g < kFwdGroups; ++g) {
      const float* pr = part + ((size_t)((g - 1) * RQ + r) * (HD + 2)) * kFwdThreads + slot;
      const float mg = pr[0], mx = fmaxf(m[r], mg);
      const float f = exp2f((m[r] - mx) * kLog2e), fg = exp2f((mg - mx) * kLog2e);
      m[r] = mx;
      l[r] = l[r] * f + pr[kFwdThreads] * fg;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[r][d] = acc[r][d] * f + pr[(2 + d) * kFwdThreads] * fg;
    }
    const int t = t0 + r * kFwdThreads + slot;
    if (t >= T_) continue;
    T* ot = out + ((size_t)b * T_ + t) * D + h * HD;
    if constexpr (kBf16) {  // bf16(acc / l): the drop scale is in bf16(drop(p))
#pragma unroll
      for (int d = 0; d < HD; ++d) ot[d] = __float2bfloat16(acc[r][d] / l[r]);
    } else {
      const float inv = (kDrop ? drop.scale : 1.f) / l[r];
      float4* o4 = reinterpret_cast<float4*>(ot);
#pragma unroll
      for (int c4 = 0; c4 < H4; ++c4)
        o4[c4] = make_float4(acc[r][4 * c4] * inv, acc[r][4 * c4 + 1] * inv,
                             acc[r][4 * c4 + 2] * inv, acc[r][4 * c4 + 3] * inv);
    }
    lse[((size_t)b * H + h) * T_ + t] = m[r] + logf(l[r]);
  }
}

// delta [B, H, T] = g . out per (row, head, query), one thread each, the
// heads of a frame on neighbouring threads.
template <int HD, typename T = float>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ g,
                                       float* __restrict__ delta, int Tn, int D, int H, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (b * T + t) * H + h
  if (i >= n) return;
  const int h = i % H, bt = i / H, t = bt % Tn, b = bt / Tn;
  const T* gt = g + (size_t)bt * D + h * HD;
  const T* ot = out + (size_t)bt * D + h * HD;
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(vsl::to_float(gt[d]), vsl::to_float(ot[d]), s);
  delta[((size_t)b * H + h) * Tn + t] = s;
}

constexpr int kBwdThreads = 512;  // the backward's threads a CTA: 16 warps an SM
constexpr int kBwdQ = 64;         // queries a streamed tile
constexpr int kDqFloats = 8192;   // phase 3's partials over key groups
// keys a CTA: 128, or 64 at head dim 64, where a CTA's 512 threads hold
// dK and dV at 2 keys x 8 dims a thread (ops/kernels.py FLASH_KEY_TILE)
constexpr int bwd_key_tile(int hd) { return hd * 128 <= 4096 ? 128 : 64; }

// The backward's shared memory at key tiles of TK and head dim hd, in
// floats: Ks, Vs [TK][hd + 1] (an odd stride: the score products read a key
// a lane); Ka [TK][hd] (16-byte rows: the dQ product reads a key's row as
// float4 broadcasts); Qs, Gs [2][kBwdQ][hd] and lse, delta [2][kBwdQ] (the
// query tiles' two buffers); the key mask's -1e30 terms [TK]; drop(P) and
// dS [kBwdQ][TK + 1]; the dQ product's partials over key groups
// [kDqFloats] (ops/kernels.py flash_bwd_plan reports it).
__host__ __device__ inline size_t flash_bwd_floats(int TK, int hd) {
  return 2 * (size_t)TK * (hd + 1) + (size_t)TK * hd + 4 * (size_t)kBwdQ * hd + 4 * kBwdQ + TK +
         2 * (size_t)kBwdQ * (TK + 1) + kDqFloats;
}

// One (row, head, key tile of TK keys): dk, dv of its keys and its dQ
// partial, into dqw [n, B, T, D]. Each query tile takes three phases, each
// out of shared memory with register tiles whose sizes are compile-time:
//   1. S = (Q * scale).K^T and G.V^T, fused: 8 query rows x 2 keys a
//      thread (its keys on neighbouring lanes, its rows' q and g read as
//      float4 broadcasts), an fmaf chain over d in order (common.cuh);
//      then P = 2^((s - lse) log2 e), the keep bit (one exp and one hash a
//      (t, j)), drop(P) and dS = P * (drop(dP) - delta) into shared
//      memory, without a branch (the epilogue, not the FMAs, bounds this
//      phase's instruction issue);
//   2. dV += drop(P)^T.G and dK += dS^T.(Q * scale): 2 keys x 8 dims a
//      thread, summed in registers over every query tile, the tile's rows
//      split KS ways (KS partials summed in order at the end);
//   3. the tile's dQ partial dS.K: a query's 16 dims a thread over one
//      of JG groups of the keys (the query's dS on its lane, the keys'
//      rows as float4 broadcasts), then the JG group sums added in order.
// One CTA of 512 threads an SM (at most 128 registers a thread), so that
// 16 warps hide the shared loads' latency.
template <int HD, int TK, typename T = float>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask, vsl::Dropout drop,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const T* __restrict__ g, float* __restrict__ dqw, T* __restrict__ dk,
                 T* __restrict__ dv, int B, int Tn, int D, int H, float scale) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  constexpr int TQ = kBwdQ, LD = HD + 1, LDP = TK + 1, H4 = HD / 4;
  constexpr int E = 16 / sizeof(T), HC = HD / E;  // a 16-byte chunk's values, a row's chunks
  const int T_ = Tn;
  // a rounding point at bf16; the identity at fp32
  const auto rnd = [](float a) { return kBf16 ? vsl::bf16_round(a) : a; };
  constexpr int CG = TK / 2, RM = TQ * TK / (2 * kBwdThreads);  // phase 1's tile
  constexpr int KH = TK / 2, GROUPS = KH * (HD / 8);              // phase 2's threads
  constexpr int KS = kBwdThreads / GROUPS, TS = TQ / KS;          // and its row split
  constexpr int JG = kDqFloats / (TQ * HD) < 8 ? kDqFloats / (TQ * HD) : 8;  // phase 3's
  constexpr int JK = TK / JG;                                                // key groups
  static_assert(HD % 16 == 0 || HD == 8, "head dim");
  static_assert(RM >= 1 && KS >= 1 && TQ % KS == 0 && JG >= 1 && TK % JG == 0, "tile sizes");
  extern __shared__ float4 smem4[];
  const int n = (T_ + TK - 1) / TK;
  const int r = static_cast<int>(blockIdx.x) % n, bh = static_cast<int>(blockIdx.x) / n;
  const int b = bh / H, h = bh - b * H;
  const int j0 = r * TK, nk = min(TK, T_ - j0), nqt = (T_ + TQ - 1) / TQ;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + TK * LD;
  float* Ka = Vs + TK * LD;
  float* Qf = Ka + TK * HD;      // [2][TQ][HD] floats (at bf16 half of them)
  float* Gf = Qf + 2 * TQ * HD;  // [2][TQ][HD] floats
  T* Qb = reinterpret_cast<T*>(Qf);
  T* Gb = reinterpret_cast<T*>(Gf);
  float* Lb = Gf + 2 * TQ * HD;  // [2][TQ]
  float* Db = Lb + 2 * TQ;       // [2][TQ]
  float* neg = Db + 2 * TQ;
  float* PD = neg + TK;          // drop(P) [TQ][LDP]
  float* DS = PD + TQ * LDP;     // dS [TQ][LDP]
  float* DQ = DS + TQ * LDP;     // phase 3's partials [JG][TQ][HD]
  const float* mrow = mask + (size_t)b * T_;
  const size_t base = (size_t)b * T_ * D + h * HD;
  const size_t srow = ((size_t)b * H + h) * T_;
  float* dqr = dqw + (size_t)r * B * T_ * D + base;  // this tile's dQ partial
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const float inv_t = 1.f / T_;
  const int tid = threadIdx.x;
  const bool has_key = row_has_key(mrow, T_);
  // the key tile, zero past its last key
  for (int i = tid; i < TK * HD; i += kBwdThreads) {
    const int jj = i / HD, d = i - jj * HD;
    const bool in = jj < nk;
    const float kv = in ? vsl::to_float(k[base + (size_t)(j0 + jj) * D + d]) : 0.f;
    Ks[jj * LD + d] = kv;
    Ka[i] = kv;
    Vs[jj * LD + d] = in ? vsl::to_float(v[base + (size_t)(j0 + jj) * D + d]) : 0.f;
  }
  int live = 0;
  for (int jj = tid; jj < TK; jj += kBwdThreads) {
    const float m = jj < nk ? mrow[j0 + jj] : 0.f;
    neg[jj] = (1.f - m) * vsl::kMaskValue;
    live |= m != 0.f;
  }
  // a tile of masked keys on a row with a valid key has p = 0 everywhere
  const bool work = __syncthreads_or(live) != 0 || !has_key;
  // query tile i into buffer i & 1, one commit group
  auto issue = [&](int i) {
    const int t0 = i * TQ, nt = min(TQ, T_ - t0), o = (i & 1) * TQ;
    for (int e = tid; e < nt * HC; e += kBwdThreads) {
      const int t = e / HC, c4 = e - t * HC;
      const size_t src = base + (size_t)(t0 + t) * D + E * c4;
      vsl::cp_async_float4(reinterpret_cast<float*>(Qb + (o + t) * HD + E * c4),
                           reinterpret_cast<const float*>(q + src));
      vsl::cp_async_float4(reinterpret_cast<float*>(Gb + (o + t) * HD + E * c4),
                           reinterpret_cast<const float*>(g + src));
    }
    for (int t = tid; t < nt; t += kBwdThreads) {
      vsl::cp_async_float(Lb + o + t, lse + srow + t0 + t);
      vsl::cp_async_float(Db + o + t, delta + srow + t0 + t);
    }
    vsl::cp_async_commit();
  };
  // phase 1's rows [rg RM, rg RM + RM) and keys cg, cg + CG; phase 2's keys
  // jk, jk + KH and dims [8 dg, 8 dg + 8) on row share ks; phase 3's query
  // tq and key group jg
  const int cg = tid % CG, rg = tid / CG;
  const int grp = tid % GROUPS, ks = tid / GROUPS, jk = grp % KH, dg = grp / KH;
  const int tq = tid % TQ, jg = tid / TQ;
  float accK[2][8], accV[2][8];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) accK[a][c] = accV[a][c] = 0.f;
  if (!work) {
    for (int e = tid; e < T_ * H4; e += kBwdThreads) {
      const int t = e / H4, c4 = e - t * H4;
      *reinterpret_cast<float4*>(dqr + (size_t)t * D + 4 * c4) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    issue(0);
    for (int i = 0; i < nqt; ++i) {
      if (i + 1 < nqt) {
        issue(i + 1);
        vsl::cp_async_wait<1>();
      } else {
        vsl::cp_async_wait<0>();
      }
      const int t0 = i * TQ, nt = min(TQ, T_ - t0), o = (i & 1) * TQ;
      T* Qs = Qb + o * HD;
      const T* Gs = Gb + o * HD;
      const float* Ls = Lb + o;
      const float* Dl = Db + o;
      if constexpr (kBf16) {
        // bf16(q * scale), the scale fp32 (pallas_kernels.py:1460), each
        // thread on the 16-byte chunks it copied
        for (int e = tid; e < nt * HC; e += kBwdThreads) {
#pragma unroll
          for (int u = 0; u < E; ++u)
            Qs[E * e + u] = __float2bfloat16(vsl::to_float(Qs[E * e + u]) * scale);
        }
      } else {
        // q * scale, each thread on the float4s it copied: the forward's
        // pre-scaled q, bit for bit
        for (int e = tid; e < nt * H4; e += kBwdThreads) {
          float4* p4 = reinterpret_cast<float4*>(Qs) + e;
          float4 x = *p4;
          x.x *= scale;
          x.y *= scale;
          x.z *= scale;
          x.w *= scale;
          *p4 = x;
        }
      }
      __syncthreads();  // tile i landed and scaled; tile i - 1's phases done
      {  // 1. S and G.V^T, then drop(P) and dS
        float aS[RM][2], aP[RM][2];
#pragma unroll
        for (int m = 0; m < RM; ++m)
#pragma unroll
          for (int c = 0; c < 2; ++c) aS[m][c] = aP[m][c] = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < H4; ++k4) {
          float kr[2][4], vr[2][4];
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              kr[c][u] = Ks[(cg + CG * c) * LD + 4 * k4 + u];
              vr[c][u] = Vs[(cg + CG * c) * LD + 4 * k4 + u];
            }
#pragma unroll
          for (int m = 0; m < RM; ++m) {
            const float4 qa = vsl::load4(Qs + (rg * RM + m) * HD + 4 * k4);
            const float4 ga = vsl::load4(Gs + (rg * RM + m) * HD + 4 * k4);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              aS[m][c] = fmaf(qa.x, kr[c][0], aS[m][c]);
              aS[m][c] = fmaf(qa.y, kr[c][1], aS[m][c]);
              aS[m][c] = fmaf(qa.z, kr[c][2], aS[m][c]);
              aS[m][c] = fmaf(qa.w, kr[c][3], aS[m][c]);
              aP[m][c] = fmaf(ga.x, vr[c][0], aP[m][c]);
              aP[m][c] = fmaf(ga.y, vr[c][1], aP[m][c]);
              aP[m][c] = fmaf(ga.z, vr[c][2], aP[m][c]);
              aP[m][c] = fmaf(ga.w, vr[c][3], aP[m][c]);
            }
          }
        }
        // without branches: every (t, j) is hashed (with dropout off the
        // threshold is 0 and the scale 1, so every key is kept as it is),
        // and a (t, j) past the tile's rows or keys is 0 by selection
#pragma unroll
        for (int m = 0; m < RM; ++m) {
          const int t = rg * RM + m;
          const float lt = Ls[t], dt = Dl[t];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int jj = cg + CG * c;
            const float e = aS[m][c] + neg[jj] - lt;
            const float p = has_key ? (kBf16 ? expf(e) : exp2f(e * kLog2e)) : inv_t;
            const bool in = t < nt && jj < nk;
            const bool keep = vsl::counter_hash(t0 + t, j0 + jj, seed, salt) >= drop.thresh;
            const float dpd = keep ? aP[m][c] * drop.scale : 0.f;
            // at bf16 drop(P) and dS rounded for their products
            PD[t * LDP + jj] = in && keep ? rnd(p * drop.scale) : 0.f;
            DS[t * LDP + jj] = in ? rnd(p * (dpd - dt)) : 0.f;
          }
        }
      }
      __syncthreads();
      // 2. dV += drop(P)^T . G, dK += dS^T . (q * scale) over this thread's
      // share of the tile's rows
#pragma unroll 4
      for (int tt = 0; tt < TS; ++tt) {
        const int t = ks * TS + tt;
        if (t >= nt) break;
        const float p0 = PD[t * LDP + jk], p1 = PD[t * LDP + jk + KH];
        const float s0 = DS[t * LDP + jk], s1 = DS[t * LDP + jk + KH];
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          const float4 gg = vsl::load4(Gs + t * HD + 8 * dg + 4 * h4);
          const float4 qq = vsl::load4(Qs + t * HD + 8 * dg + 4 * h4);
          const float gv[4] = {gg.x, gg.y, gg.z, gg.w}, qv[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            accV[0][4 * h4 + u] = fmaf(p0, gv[u], accV[0][4 * h4 + u]);
            accV[1][4 * h4 + u] = fmaf(p1, gv[u], accV[1][4 * h4 + u]);
            accK[0][4 * h4 + u] = fmaf(s0, qv[u], accK[0][4 * h4 + u]);
            accK[1][4 * h4 + u] = fmaf(s1, qv[u], accK[1][4 * h4 + u]);
          }
        }
      }
      // 3. the tile's dQ partial dS . K (keys past the tile's last: dS 0,
      // K 0): query tq's dims over key group jg, 16 at a time
      if (jg < JG) {
        const float* ds = DS + tq * LDP + jg * JK;
        const float4* ka = reinterpret_cast<const float4*>(Ka + jg * JK * HD);
#pragma unroll
        for (int d16 = 0; d16 < (HD + 15) / 16; ++d16) {
          constexpr int W = HD < 16 ? HD / 4 : 4;  // float4s of the chunk
          float4 acc[W];
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
          for (int j = 0; j < JK; ++j) {
            const float a = ds[j];
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const float4 kk = ka[j * H4 + 4 * d16 + w];
              acc[w].x = fmaf(a, kk.x, acc[w].x);
              acc[w].y = fmaf(a, kk.y, acc[w].y);
              acc[w].z = fmaf(a, kk.z, acc[w].z);
              acc[w].w = fmaf(a, kk.w, acc[w].w);
            }
          }
          float4* out4 = reinterpret_cast<float4*>(DQ + (jg * TQ + tq) * HD) + 4 * d16;
#pragma unroll
          for (int w = 0; w < W; ++w) out4[w] = acc[w];
        }
      }
      __syncthreads();
      // the key groups' partials in order
      for (int it = tid; it < nt * H4; it += kBwdThreads) {
        const int t = it / H4, c4 = it - t * H4;
        float4 acc = reinterpret_cast<const float4*>(DQ)[t * H4 + c4];
#pragma unroll
        for (int g2 = 1; g2 < JG; ++g2) {
          const float4 x = reinterpret_cast<const float4*>(DQ)[(g2 * TQ + t) * H4 + c4];
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
        *reinterpret_cast<float4*>(dqr + (size_t)(t0 + t) * D + 4 * c4) = acc;
      }
      __syncthreads();  // PD, DS, DQ and buffer i & 1 free for tile i + 1
    }
  }
  // dK and dV: the KS row shares summed in order into red [2][TK][HD] (in
  // PD and DS), one share a round
  float* red = PD;
  for (int s = 0; s < KS; ++s) {
    if (ks == s) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float* rk = red + (jk + KH * a) * HD + 8 * dg + c;
          float* rv = rk + TK * HD;
          *rk = s ? *rk + accK[a][c] : accK[a][c];
          *rv = s ? *rv + accV[a][c] : accV[a][c];
        }
    }
    __syncthreads();
  }
  for (int e = tid; e < nk * HD; e += kBwdThreads) {
    const int jj = e / HD, d = e - jj * HD;
    dk[base + (size_t)(j0 + jj) * D + d] = vsl::from_float<T>(red[e]);
    dv[base + (size_t)(j0 + jj) * D + d] = vsl::from_float<T>(red[TK * HD + e]);
  }
}

// dq = scale * the sum of the key tiles' partials dqw [n, B, T, D] in
// key-tile order (the workspace route), stored as T.
template <typename T = float>
__global__ void flash_dq_sum_kernel(const float* __restrict__ dqw, T* __restrict__ dq, int n,
                                    size_t btd, float scale) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= btd) return;
  float s = 0.f;
  for (int r = 0; r < n; ++r) s += dqw[(size_t)r * btd + i];
  dq[i] = vsl::from_float<T>(s * scale);
}

}  // namespace

namespace {

// The forward on flash_fwd_plan's `rows` query rows a thread (1, or up to
// head dim 32 also 2), at the query scale `qs`.
template <typename T>
cudaError_t flash_forward(const T* q, const T* k, const T* v, const float* mask,
                          vsl::Dropout drop, T* out, float* lse, int B, int Tn, int D,
                          int n_heads, int rows, bool bf16_scale, cudaStream_t stream) {
  if (B < 1 || Tn < 1 || n_heads < 1 || D % n_heads || (rows != 1 && rows != 2))
    return cudaErrorInvalidValue;
  return vsl::by_head_dim(D / n_heads, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const float qs = bf16_scale ? vsl::bf16_round_host(vsl::head_scale(HD)) : vsl::head_scale(HD);
    auto launch = [&](auto kernel, int rq) {
      const size_t smem = flash_fwd_floats(HD, rq) * sizeof(float);
      cudaError_t err = vsl::opt_in_smem(reinterpret_cast<const void*>(kernel), smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((Tn + rq * kFwdThreads - 1) / (rq * kFwdThreads), n_heads, B);
      kernel<<<grid, kFwdThreads * kFwdGroups, smem, stream>>>(q, k, v, mask, drop, out, lse, Tn,
                                                               D, qs);
      return cudaGetLastError();
    };
    if (rows == 1)
      return drop.seeds ? launch(flash_fwd_kernel<HD, 1, true, T>, 1)
                        : launch(flash_fwd_kernel<HD, 1, false, T>, 1);
    if constexpr (HD <= 32) {
      return drop.seeds ? launch(flash_fwd_kernel<HD, 2, true, T>, 2)
                        : launch(flash_fwd_kernel<HD, 2, false, T>, 2);
    }
    return cudaErrorInvalidValue;
  });
}

// The backward's three launches (delta, the key tiles' pass, the dQ sum)
// at the fp32 query scale.
template <typename T>
cudaError_t flash_backward(const T* q, const T* k, const T* v, const float* mask,
                           const float* seeds, unsigned thresh, float scale, const T* out,
                           const float* lse, const T* g, T* dq, T* dk, T* dv, float* delta,
                           float* dqw, int B, int Tn, int D, int n_heads, cudaStream_t stream) {
  if (B < 1 || Tn < 1 || n_heads < 1 || D % n_heads) return cudaErrorInvalidValue;
  // the kernel hashes every (t, j): off, it keeps every key at scale 1
  const vsl::Dropout drop{seeds, seeds ? thresh : 0u, seeds ? scale : 1.f};
  return vsl::by_head_dim(D / n_heads, [&](auto hd) {
    constexpr int HD = decltype(hd)::value, TK = bwd_key_tile(HD);
    const int nd = B * n_heads * Tn, n = (Tn + TK - 1) / TK;
    const float qs = vsl::head_scale(HD);
    flash_bwd_delta_kernel<HD, T><<<(nd + 255) / 256, 256, 0, stream>>>(out, g, delta, Tn, D,
                                                                        n_heads, nd);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem = flash_bwd_floats(TK, HD) * sizeof(float);
    err = vsl::opt_in_smem(reinterpret_cast<const void*>(flash_bwd_kernel<HD, TK, T>), smem);
    if (err != cudaSuccess) return err;
    flash_bwd_kernel<HD, TK, T><<<B * n_heads * n, kBwdThreads, smem, stream>>>(
        q, k, v, mask, drop, lse, delta, g, dqw, dk, dv, B, Tn, D, n_heads, qs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t btd = (size_t)B * Tn * D;
    flash_dq_sum_kernel<T><<<static_cast<unsigned>((btd + 255) / 256), 256, 0, stream>>>(
        dqw, dq, n, btd, qs);
    return cudaGetLastError();
  });
}

}  // namespace

// out [B, T, D], lse [B, H, T], on flash_fwd_plan's `rows` query rows a
// thread (1, or up to head dim 32 also 2).
extern "C" int vsl_flash_mha_fwd(const float* q, const float* k, const float* v,
                                 const float* mask, const float* seeds, unsigned thresh,
                                 float scale, float* out, float* lse, int B, int T, int D,
                                 int n_heads, int rows, void* stream_) {
  return static_cast<int>(flash_forward(q, k, v, mask, vsl::Dropout{seeds, thresh, scale}, out,
                                        lse, B, T, D, n_heads, rows, false,
                                        static_cast<cudaStream_t>(stream_)));
}

// dq, dk, dv [B, T, D]; delta [B, H, T] (g . out per query) and dqw, the
// key tiles' dQ partials [ceil(T / TK), B, T, D], are workspaces; TK =
// bwd_key_tile(head dim) (ops/kernels.py flash_bwd_plan).
extern "C" int vsl_flash_mha_bwd(const float* q, const float* k, const float* v,
                                 const float* mask, const float* seeds, unsigned thresh,
                                 float scale, const float* out, const float* lse, const float* g,
                                 float* dq, float* dk, float* dv, float* delta, float* dqw, int B,
                                 int T, int D, int n_heads, void* stream_) {
  return static_cast<int>(flash_backward(q, k, v, mask, seeds, thresh, scale, out, lse, g, dq, dk,
                                         dv, delta, dqw, B, T, D, n_heads,
                                         static_cast<cudaStream_t>(stream_)));
}

// The flash kernels at bf16 (#13b, #14b; the TPU kernels at dtype bf16): q,
// k, v, out, g, dq, dk and dv [B, T, D] in bf16, lse, delta and dqw fp32,
// on the same plans and workspaces. The forward's query scale is bf16, the
// backward's fp32 (pallas_kernels.py:1400, 1460).
extern "C" int vsl_flash_mha_fwd_bf16(const void* q, const void* k, const void* v,
                                      const float* mask, const float* seeds, unsigned thresh,
                                      float scale, void* out, float* lse, int B, int T, int D,
                                      int n_heads, int rows, void* stream_) {
  using bf16 = __nv_bfloat16;
  return static_cast<int>(flash_forward(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
      vsl::Dropout{seeds, thresh, scale}, static_cast<bf16*>(out), lse, B, T, D, n_heads, rows,
      true, static_cast<cudaStream_t>(stream_)));
}

extern "C" int vsl_flash_mha_bwd_bf16(const void* q, const void* k, const void* v,
                                      const float* mask, const float* seeds, unsigned thresh,
                                      float scale, const void* out, const float* lse,
                                      const void* g, void* dq, void* dk, void* dv, float* delta,
                                      float* dqw, int B, int T, int D, int n_heads,
                                      void* stream_) {
  using bf16 = __nv_bfloat16;
  return static_cast<int>(flash_backward(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
      seeds, thresh, scale, static_cast<const bf16*>(out), lse, static_cast<const bf16*>(g),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), delta, dqw, B, T, D,
      n_heads, static_cast<cudaStream_t>(stream_)));
}
