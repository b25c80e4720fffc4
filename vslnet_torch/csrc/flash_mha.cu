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
// Forward: grid (query tiles of kRows, heads, B), one thread a query row.
// K and V of a head stream through shared memory kStage keys at a time;
// each thread keeps its running max m, sum l and P.V accumulator (an
// online softmax, rescaled when the max grows) and writes out and
// lse = m + log(l) per (row, head, query) into lse [B, H, T].
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
// What bounds them: the forward's per-thread key loops, 2*HD FMAs, an exp
// and a hash per (query, key) pair; the backward's five products, 10*HD
// FLOPs a pair, out of shared memory, with one exp and one hash a pair;
// bytes are q, k, v (and g, out) read once a tile, the outputs written
// once.
#include "common.cuh"
#include "hash.cuh"

namespace {

constexpr int kRows = 128;      // the forward's queries a block, one a thread
constexpr int kStage = 64;      // the forward's keys staged at a time

using vsl::head_score;

// True on every thread if any key of the row is valid (mask != 0).
__device__ bool row_has_key(const float* mrow, int T) {
  int any = 0;
  for (int j = threadIdx.x; j < T; j += blockDim.x) any |= mrow[j] != 0.f;
  return __syncthreads_or(any) != 0;
}

// Stages keys [j0, j0 + nk) of head h: Ks, Vs [nk, HD], neg [nk]. Returns,
// on every thread, whether any staged key is valid; ends with a barrier.
template <int HD>
__device__ bool stage_keys(const float* k, const float* v, const float* mrow, size_t base, int D,
                           int j0, int nk, float* Ks, float* Vs, float* neg) {
  for (int i = threadIdx.x; i < nk * HD; i += blockDim.x) {
    const int jj = i / HD, d = i - jj * HD;
    Ks[i] = k[base + (size_t)(j0 + jj) * D + d];
    Vs[i] = v[base + (size_t)(j0 + jj) * D + d];
  }
  int live = 0;
  for (int jj = threadIdx.x; jj < nk; jj += blockDim.x) {
    const float m = mrow[j0 + jj];
    neg[jj] = (1.f - m) * vsl::kMaskValue;
    live |= m != 0.f;
  }
  return __syncthreads_or(live) != 0;
}

template <int HD>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask, vsl::Dropout drop,
                 float* __restrict__ out, float* __restrict__ lse, int T, int D, float scale) {
  __shared__ float Ks[kStage * HD], Vs[kStage * HD], neg[kStage];
  const int b = blockIdx.z, h = blockIdx.y, H = gridDim.y;
  const int t = blockIdx.x * kRows + threadIdx.x;
  const bool active = t < T;
  const float* mrow = mask + (size_t)b * T;
  const size_t base = (size_t)b * T * D + h * HD;
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const bool has_key = row_has_key(mrow, T);
  float qr[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = active ? q[base + (size_t)t * D + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -FLT_MAX, l = 0.f;
  for (int j0 = 0; j0 < T; j0 += kStage) {
    const int nk = min(kStage, T - j0);
    const bool live = stage_keys<HD>(k, v, mrow, base, D, j0, nk, Ks, Vs, neg);
    if (active && (live || !has_key)) {
      for (int jj = 0; jj < nk; ++jj) {
        const float s = head_score<HD>(qr, Ks + jj * HD, neg[jj]);
        if (s > m) {  // the max grows: rescale what was summed
          const float a = expf(m - s);
          l *= a;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] *= a;
          m = s;
        }
        const float p = expf(s - m);
        l += p;
        if (drop.keep(seed, salt, t, j0 + jj)) {
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, Vs[jj * HD + d], acc[d]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  const float inv = (drop.on() ? drop.scale : 1.f) / l;
  float* o = out + ((size_t)b * T + t) * D + h * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = acc[d] * inv;
  lse[((size_t)b * H + h) * T + t] = m + logf(l);
}

// delta [B, H, T] = g . out per (row, head, query), one thread each, the
// heads of a frame on neighbouring threads.
template <int HD>
__global__ void flash_bwd_delta_kernel(const float* __restrict__ out, const float* __restrict__ g,
                                       float* __restrict__ delta, int T, int D, int H, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (b * T + t) * H + h
  if (i >= n) return;
  const int h = i % H, bt = i / H, t = bt % T, b = bt / T;
  const float* gt = g + (size_t)bt * D + h * HD;
  const float* ot = out + (size_t)bt * D + h * HD;
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(gt[d], ot[d], s);
  delta[((size_t)b * H + h) * T + t] = s;
}

constexpr int kBwdThreads = 512;  // the backward's threads a CTA: 16 warps an SM
constexpr int kBwdQ = 64;         // queries a streamed tile
constexpr int kDqFloats = 8192;   // phase 3's partials over key groups
constexpr float kLog2e = 1.4426950408889634f;
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
//      float4 broadcasts), an fmaf chain over d in order (head_score's);
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
template <int HD, int TK>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask, vsl::Dropout drop,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ g, float* __restrict__ dqw, float* __restrict__ dk,
                 float* __restrict__ dv, int B, int T, int D, int H, float scale) {
  constexpr int TQ = kBwdQ, LD = HD + 1, LDP = TK + 1, H4 = HD / 4;
  constexpr int CG = TK / 2, RM = TQ * TK / (2 * kBwdThreads);  // phase 1's tile
  constexpr int KH = TK / 2, GROUPS = KH * (HD / 8);              // phase 2's threads
  constexpr int KS = kBwdThreads / GROUPS, TS = TQ / KS;          // and its row split
  constexpr int JG = kDqFloats / (TQ * HD) < 8 ? kDqFloats / (TQ * HD) : 8;  // phase 3's
  constexpr int JK = TK / JG;                                                // key groups
  static_assert(HD % 16 == 0 || HD == 8, "head dim");
  static_assert(RM >= 1 && KS >= 1 && TQ % KS == 0 && JG >= 1 && TK % JG == 0, "tile sizes");
  extern __shared__ float4 smem4[];
  const int n = (T + TK - 1) / TK;
  const int r = static_cast<int>(blockIdx.x) % n, bh = static_cast<int>(blockIdx.x) / n;
  const int b = bh / H, h = bh - b * H;
  const int j0 = r * TK, nk = min(TK, T - j0), nqt = (T + TQ - 1) / TQ;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + TK * LD;
  float* Ka = Vs + TK * LD;
  float* Qb = Ka + TK * HD;      // [2][TQ][HD]
  float* Gb = Qb + 2 * TQ * HD;  // [2][TQ][HD]
  float* Lb = Gb + 2 * TQ * HD;  // [2][TQ]
  float* Db = Lb + 2 * TQ;       // [2][TQ]
  float* neg = Db + 2 * TQ;
  float* PD = neg + TK;          // drop(P) [TQ][LDP]
  float* DS = PD + TQ * LDP;     // dS [TQ][LDP]
  float* DQ = DS + TQ * LDP;     // phase 3's partials [JG][TQ][HD]
  const float* mrow = mask + (size_t)b * T;
  const size_t base = (size_t)b * T * D + h * HD;
  const size_t srow = ((size_t)b * H + h) * T;
  float* dqr = dqw + (size_t)r * B * T * D + base;  // this tile's dQ partial
  const uint32_t seed = drop.seed(b), salt = vsl::head_salt(h);
  const float inv_t = 1.f / T;
  const int tid = threadIdx.x;
  const bool has_key = row_has_key(mrow, T);
  // the key tile, zero past its last key
  for (int i = tid; i < TK * HD; i += kBwdThreads) {
    const int jj = i / HD, d = i - jj * HD;
    const bool in = jj < nk;
    const float kv = in ? k[base + (size_t)(j0 + jj) * D + d] : 0.f;
    Ks[jj * LD + d] = kv;
    Ka[i] = kv;
    Vs[jj * LD + d] = in ? v[base + (size_t)(j0 + jj) * D + d] : 0.f;
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
    const int t0 = i * TQ, nt = min(TQ, T - t0), o = (i & 1) * TQ;
    for (int e = tid; e < nt * H4; e += kBwdThreads) {
      const int t = e / H4, c4 = e - t * H4;
      const size_t src = base + (size_t)(t0 + t) * D + 4 * c4;
      vsl::cp_async_float4(Qb + (o + t) * HD + 4 * c4, q + src);
      vsl::cp_async_float4(Gb + (o + t) * HD + 4 * c4, g + src);
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
    for (int e = tid; e < T * H4; e += kBwdThreads) {
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
      const int t0 = i * TQ, nt = min(TQ, T - t0), o = (i & 1) * TQ;
      float* Qs = Qb + o * HD;
      const float* Gs = Gb + o * HD;
      const float* Ls = Lb + o;
      const float* Dl = Db + o;
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
            const float4 qa = reinterpret_cast<const float4*>(Qs)[(rg * RM + m) * H4 + k4];
            const float4 ga = reinterpret_cast<const float4*>(Gs)[(rg * RM + m) * H4 + k4];
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
            const float p =
                has_key ? exp2f((aS[m][c] + neg[jj] - lt) * kLog2e) : inv_t;
            const bool in = t < nt && jj < nk;
            const bool keep = vsl::counter_hash(t0 + t, j0 + jj, seed, salt) >= drop.thresh;
            const float dpd = keep ? aP[m][c] * drop.scale : 0.f;
            PD[t * LDP + jj] = in && keep ? p * drop.scale : 0.f;
            DS[t * LDP + jj] = in ? p * (dpd - dt) : 0.f;
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
        const float4* g4 = reinterpret_cast<const float4*>(Gs + t * HD + 8 * dg);
        const float4* q4 = reinterpret_cast<const float4*>(Qs + t * HD + 8 * dg);
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          const float4 gg = g4[h4], qq = q4[h4];
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
    dk[base + (size_t)(j0 + jj) * D + d] = red[e];
    dv[base + (size_t)(j0 + jj) * D + d] = red[TK * HD + e];
  }
}

// dq = scale * the sum of the key tiles' partials dqw [n, B, T, D] in
// key-tile order (the workspace route).
__global__ void flash_dq_sum_kernel(const float* __restrict__ dqw, float* __restrict__ dq, int n,
                                    size_t btd, float scale) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= btd) return;
  float s = 0.f;
  for (int r = 0; r < n; ++r) s += dqw[(size_t)r * btd + i];
  dq[i] = s * scale;
}

dim3 grid_of(int B, int T, int n_heads) { return dim3((T + kRows - 1) / kRows, n_heads, B); }

}  // namespace

// out [B, T, D], lse [B, H, T].
extern "C" int vsl_flash_mha_fwd(const float* q, const float* k, const float* v,
                                 const float* mask, const float* seeds, unsigned thresh,
                                 float scale, float* out, float* lse, int B, int T, int D,
                                 int n_heads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const vsl::Dropout drop{seeds, thresh, scale};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    flash_fwd_kernel<HD><<<grid_of(B, T, n_heads), kRows, 0, stream>>>(
        q, k, v, mask, drop, out, lse, T, D, vsl::head_scale(HD));
    return cudaGetLastError();
  }));
}

// dq, dk, dv [B, T, D]; delta [B, H, T] (g . out per query) and dqw, the
// key tiles' dQ partials [ceil(T / TK), B, T, D], are workspaces; TK =
// bwd_key_tile(head dim) (ops/kernels.py flash_bwd_plan).
extern "C" int vsl_flash_mha_bwd(const float* q, const float* k, const float* v,
                                 const float* mask, const float* seeds, unsigned thresh,
                                 float scale, const float* out, const float* lse, const float* g,
                                 float* dq, float* dk, float* dv, float* delta, float* dqw, int B,
                                 int T, int D, int n_heads, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 1 || T < 1 || n_heads < 1 || D % n_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernel hashes every (t, j): off, it keeps every key at scale 1
  const vsl::Dropout drop{seeds, seeds ? thresh : 0u, seeds ? scale : 1.f};
  return static_cast<int>(vsl::by_head_dim(D / n_heads, [&](auto hd) {
    constexpr int HD = decltype(hd)::value, TK = bwd_key_tile(HD);
    const int nd = B * n_heads * T, n = (T + TK - 1) / TK;
    const float qs = vsl::head_scale(HD);
    flash_bwd_delta_kernel<HD><<<(nd + 255) / 256, 256, 0, stream>>>(out, g, delta, T, D, n_heads,
                                                                     nd);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem = flash_bwd_floats(TK, HD) * sizeof(float);
    err = vsl::opt_in_smem(reinterpret_cast<const void*>(flash_bwd_kernel<HD, TK>), smem);
    if (err != cudaSuccess) return err;
    flash_bwd_kernel<HD, TK><<<B * n_heads * n, kBwdThreads, smem, stream>>>(
        q, k, v, mask, drop, lse, delta, g, dqw, dk, dv, B, T, D, n_heads, qs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t btd = (size_t)B * T * D;
    flash_dq_sum_kernel<<<static_cast<unsigned>((btd + 255) / 256), 256, 0, stream>>>(dqw, dq, n,
                                                                                     btd, qs);
    return cudaGetLastError();
  }));
}
