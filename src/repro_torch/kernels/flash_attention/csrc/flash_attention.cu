// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// softcap / GQA, fp32 online softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (function flash_attention, body _kernel).  Computes
//   O = softmax(mask(softcap(Q K^T / sqrt(dh)))) V
// for q (b, sq, h, dh) and k/v (b, sk, kv, dh), all contiguous; the kv head
// of query head hh is hh / (h / kv).  Output in the q dtype.
//
// What bounds it: at the serving shape (b=4, sq=sk=2048, h=32, kv=4,
// dh=128, bf16, causal) the work is ~1.4e11 FLOPs against ~151 MB of
// traffic, so the card's bound is its arithmetic (~139 us at the bf16
// tensor-core peak); only wgmma reaches that rate.  The bf16 design:
//   * one block per (q tile of 128 rows, q head, batch): two consumer
//     warpgroups of 64 q rows each and one producer warp, whose elected
//     thread issues every load (288 threads);
//   * loads are TMA copies over rank-4 tensor maps (dh, heads, seq, batch),
//     built on the host per call (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint: no link to libcuda) and passed as
//     __grid_constant__ parameters, so a CUDA graph keeps them by value.
//     Rows past a sequence's end come back as zeros from TMA's bounds
//     check, never the next batch's rows.  128-byte swizzle, so a box is
//     64 elements wide and a dh 128 tile is two boxes side by side;
//   * Q is loaded once per block; K and V tiles of 96 keys go through a
//     ring of 3 stages with "full" (transaction count) and "empty" (one
//     arrival per consumer warp) mbarriers, so the next tiles' loads are in
//     flight while the consumers work.  Shared memory at dh 128: Q 32 KB +
//     3 x (K 24 KB + V 24 KB) = 176 KB;
//   * both products are wgmma: S = Q K^T with A and B read from shared
//     memory (both K-major as stored); O += P V with P in registers (the
//     fp32 score accumulators rounded to bf16 in place, which is the
//     register A layout) and V read as stored through the transpose bit
//     (MN-major), so nothing is transposed by hand.  The descriptors use
//     the same 128-byte swizzle as the tensor maps.  Tile i's S product is
//     issued before tile i - 1's P V, so each softmax overlaps a product;
//   * registers: a kernel with wgmma gets 168 registers a thread whatever
//     the block's warp count (ptxas sizes it by warpgroups), and setmaxnreg
//     did not raise ptxas's allocation for the consumers (their SASS used
//     no register above the entry count).  With 128-key tiles S (64) + P (32) + O (64)
//     spilled P and serialised every wgmma; 96-key tiles (48 + 24 + 64)
//     fit with no spill, and each warpgroup waits on its products only
//     twice per tile;
//   * softmax in base 2: ex2.approx with log2(e) / sqrt(dh) folded into one
//     FMA.
//     Only tiles that can hold an invisible pair (the causal diagonal, the
//     window's lower edge, the ragged last tile) test visibility; there an
//     explicit visibility bit zeroes p, so a row that has seen no key keeps
//     l = 0 (and its output is 0).  The softcap's tanh is taken only when
//     softcap > 0;
//   * the grid is (h, b, q tile) with the q tile reversed: the heaviest
//     causal tiles start first, and the g query heads of one kv head are
//     neighbouring blocks, so their K/V tiles hit in L2;
//   * head dims 64, 80 and 128.  At dh 80 (stablelm-3b) a 160-byte row is
//     wider than one 128-byte swizzle atom, so a tile is two boxes as at dh
//     128 and TMA fills columns 80-127 with zeros (padded(), hopper.cuh):
//     S = Q K^T takes 5 k-steps of 16 (the real columns only), P V runs
//     at N = 128 (wgmma's transposed B reads whole 64-column atoms) and
//     only columns 0-79 are stored.  That is 1.3x the least tensor work
//     ((80 + 128) / 160) and the dh-128 kernel's shared memory.
// Padded k/v rows are zero (TMA's fill) and masked (C-a of the roadmap);
// q rows past sq are zero and never stored.
//
// fp32 keeps its CUDA-core body (the tolerance of the fp32 path, 3e-5,
// rules out TF32): 64 x 64 tiles, fp32 FMA, each thread holding a 4 x 4
// tile of scores and a 4 x dh/16 tile of the output, plain loads.
//
// Both entries optionally write the row log-sum-exp of the logits, lse
// (b, h, sq) fp32, natural log, for the backward (flash_attention_bwd.cu);
// a null pointer skips it, so serving is unchanged.  A row that sees no
// key (l = 0) gets +inf, so that exp(logit - lse) = 0 in the backward.

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// +inf: the lse of a row that sees no key
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Is key kj visible from query qi?
__device__ __forceinline__ bool visible(int qi, int kj, int sk, int causal,
                                        int window) {
  bool ok = kj < sk;
  if (causal) {
    ok = ok && kj <= qi;
    if (window > 0) ok = ok && (qi - kj) < window;
  }
  return ok;
}

// The k tiles (of TK keys) some row of the q tile [q0, q0 + TQ) can see:
// causal positions start at 0 for both q and k.
template <int TQ, int TK>
__device__ __forceinline__ void k_tiles(int q0, int sk, int causal, int window,
                                        int* t_begin, int* t_end) {
  int k_begin = 0, k_end = sk;
  if (causal) {
    k_end = min(sk, q0 + TQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  *t_begin = k_begin / TK;
  *t_end = k_begin < k_end ? (k_end + TK - 1) / TK : k_begin / TK;
}

// ----------------------------------------------------------------- bf16
constexpr int HQ = 128;            // q rows per block: 2 consumer warpgroups
constexpr int HK = 96;             // keys per K/V tile
constexpr int STAGES = 3;          // K/V ring
constexpr int HOPPER_THREADS = 2 * WG + 32;   // + one producer warp

// Each tile is D / 64 boxes of (rows x 64) bf16 side by side, each box
// 128-byte swizzled as TMA writes it; every box starts on 1024 bytes.
template <int D>
struct Smem {
  alignas(1024) __nv_bfloat16 q[HQ * D];
  alignas(1024) __nv_bfloat16 k[STAGES][HK * D];
  alignas(1024) __nv_bfloat16 v[STAGES][HK * D];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

// Online softmax of one 64 x HK score tile held as wgmma accumulators.
// Element i of a thread: row r0 + 8 ((i >> 1) & 1), key
// k0 + 8 (i >> 2) + 2 t + (i & 1).  The scores become probabilities in
// place; m is the running row max of the base-2 logits, l this thread's
// share of the row sum, alpha the factor for the output so far.  Without a
// softcap the logit is s * sl2 (log2(e) / sqrt(dh)), folded into the
// exponent's FMA; with one it is cap_out * tanh(s * cap_in).
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[HK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int r0, int k0, int t, int sk, int causal, int window, float sl2,
    float cap_in, float cap_out) {
  float scl = sl2;
  if (cap_in > 0.f) {
    scl = 1.f;
#pragma unroll
    for (int i = 0; i < HK / 2; ++i) sc[i] = cap_out * tanhf(sc[i] * cap_in);
  }
  uint64_t ok = ~0ull;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < HK / 2; ++i) {
    const int r = (i >> 1) & 1;
    if (MASKED && !visible(r0 + 8 * r, k0 + 8 * (i >> 2) + 2 * t + (i & 1),
                           sk, causal, window)) {
      ok &= ~(1ull << i);
      continue;
    }
    mx[r] = fmaxf(mx[r], sc[i]);
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scl);
    alpha[r] = fexp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < HK / 2; ++i) {
    const int r = (i >> 1) & 1;
    float p = fexp2(fmaf(sc[i], scl, neg_m[r]));
    if (MASKED) p = (ok >> i) & 1ull ? p : 0.f;
    sc[i] = p;
    l[r] += p;
  }
}

// Softmax of tile k0 for the warpgroup whose rows start at ql: the
// visibility test runs only where the tile can hold an invisible pair (the
// causal diagonal, the window's lower edge, the ragged last tile).
__device__ __forceinline__ void softmax_any(
    float (&sc)[HK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int ql, int r0, int k0, int t, int sk, int causal, int window, float sl2,
    float cap_in, float cap_out) {
  const bool edge = k0 + HK > sk ||
                    (causal && (k0 + HK - 1 > ql ||
                                (window > 0 && ql + 63 - k0 >= window)));
  if (edge)
    softmax_tile<true>(sc, m, l, alpha, r0, k0, t, sk, causal, window, sl2,
                       cap_in, cap_out);
  else
    softmax_tile<false>(sc, m, l, alpha, r0, k0, t, sk, causal, window, sl2,
                        cap_in, cap_out);
}

// S = Q K^T of one tile into sc: 64 x HK, DH / 16 k-steps (the columns
// past DH of a D-wide tile are zero), both operands K-major as stored.
template <int D, int DH>
__device__ __forceinline__ void issue_s(float (&sc)[HK / 2],
                                        const Smem<D>& sm, int wg,
                                        int stage) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 16;
    const uint64_t da =
        gmma_desc(sm.q + box * HQ * BOX + wg * 64 * BOX + off, 16, 1024);
    const uint64_t db = gmma_desc(sm.k[stage] + box * HK * BOX + off, 16, 1024);
    wgmma_ss(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V: V (keys x D) read as stored, MN-major; LBO steps between the
// 64-wide boxes of D, SBO between groups of 8 keys.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[HK / 16][4],
                                         const Smem<D>& sm, int stage) {
#pragma unroll
  for (int kk = 0; kk < HK / 16; ++kk) {
    const uint64_t db =
        gmma_desc(sm.v[stage] + kk * 16 * BOX, HK * BOX * 2, 1024);
    wgmma_rs(acc, pa[kk], db);
  }
  wgmma_commit();
}

template <int DH>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int sq,
               int sk, int h, int kv, int causal, int window, float softcap,
               float scale) {
  constexpr int D = padded(DH);        // the tiles' width in shared memory
  constexpr int NB = D / BOX;          // boxes per row
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = aligned_smem<Smem<D>>(smem_raw);

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * HQ;   // heaviest first
  const int kh = hh / (h / kv);
  // warp-uniform to the compiler (a shuffle), so that the wgmma code of
  // the consumer branch needs no divergence handling; 2 is the producer
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  int t_begin, t_end;
  k_tiles<HQ, HK>(q0, sk, causal, window, &t_begin, &t_end);
  const int n_tiles = max(t_end - t_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 2 * WG / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every TMA load
    if (threadIdx.x == 2 * WG) {
      mbar_expect_tx(&sm.q_full, HQ * D * 2);
      for (int j = 0; j < NB; ++j)
        tma_load4(sm.q + j * HQ * BOX, &tm_q, &sm.q_full, j * BOX, hh, q0, bb);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int k0 = (t_begin + i) * HK;
        mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[s], HK * D * 2);
        for (int j = 0; j < NB; ++j)
          tma_load4(sm.k[s] + j * HK * BOX, &tm_k, &sm.k_full[s], j * BOX,
                    kh, k0, bb);
        mbar_expect_tx(&sm.v_full[s], HK * D * 2);
        for (int j = 0; j < NB; ++j)
          tma_load4(sm.v[s] + j * HK * BOX, &tm_v, &sm.v_full[s], j * BOX,
                    kh, k0, bb);
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int ql = q0 + wg * 64;
    const int r0 = ql + warp * 16 + g;         // rows r0 and r0 + 8
    const float sl2 = scale * LOG2E;
    const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
    const float cap_out = softcap * LOG2E;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];

    uint32_t pa[HK / 16][4];

    // Tile i's scores are computed while tile i - 1's P V runs: its softmax
    // overlaps that product, and the output is rescaled once it is done.
    float sc[HK / 2];
#pragma unroll
    for (int j = 0; j < HK / 2; ++j) sc[j] = 0.f;
    mbar_wait(&sm.q_full, 0);
    if (n_tiles > 0) {
      mbar_wait(&sm.k_full[0], 0);
      wgmma_fence();
      fence_regs(sc);
      issue_s<D, DH>(sc, sm, wg, 0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_any(sc, m, l, alpha, ql, r0, t_begin * HK, t, sk, causal,
                  window, sl2, cap_in, cap_out);
      pack_a<HK>(pa, sc);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      mbar_wait(&sm.k_full[s], (i / STAGES) & 1);
      mbar_wait(&sm.v_full[sp], ((i - 1) / STAGES) & 1);
      wgmma_fence();
      fence_regs(sc);
      fence_regs(acc);
      issue_s<D, DH>(sc, sm, wg, s);
      issue_pv<D>(acc, pa, sm, sp);
      wgmma_wait<1>();                 // the scores are in, P V may run on
      fence_regs(sc);
      softmax_any(sc, m, l, alpha, ql, r0, (t_begin + i) * HK, t, sk, causal,
                  window, sl2, cap_in, cap_out);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&sm.empty[sp]);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      pack_a<HK>(pa, sc);
    }
    if (n_tiles > 0) {
      const int sp = (n_tiles - 1) % STAGES;
      mbar_wait(&sm.v_full[sp], ((n_tiles - 1) / STAGES) & 1);
      wgmma_fence();
      fence_regs(acc);
      issue_pv<D>(acc, pa, sm, sp);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = r0 + 8 * r;
      if (row < sq) {
        // m is in base-2 units of the logits: lse = ln 2 (m + log2 l)
        if (lse != nullptr && t == 0)
          lse[((long)bb * h + hh) * sq + row] =
              l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : pos_inf();
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow =
            o + (((long)bb * sq + row) * h + hh) * DH + 2 * t;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                    acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ----------------------------------------------------------------- fp32
constexpr int BQ = 64;             // q rows per block
constexpr int BK = 64;             // keys per tile
constexpr int SIMT_THREADS = 256;  // 16 row groups x 16 column lanes
constexpr int RN = BQ / 16;        // q rows per thread (4)
constexpr int CN = BK / 16;        // score columns per thread (4)

template <int D>
constexpr int simt_smem_bytes() {
  return 4 * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int sq, int sk, int h, int kv,
              int causal, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;     // padded row stride of qs / ks
  constexpr int LDP = BK + 1;   // padded row stride of ps
  constexpr int ON = D / 16;    // output columns per thread
  float* qs = smem;             // BQ x LD, pre-scaled q
  float* ks = qs + BQ * LD;     // BK x LD
  float* vs = ks + BK * LD;     // BK x D
  float* ps = vs + BK * D;      // BQ x LDP, probabilities of this tile

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kh = hh / (h / kv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;      // owns q rows ty*RN .. ty*RN+RN-1
  const int tx = tid % 16;      // owns columns tx + 16*j

  const long q_row = (long)h * D;
  const long k_row = (long)kv * D;
  const float* qb = q + (long)bb * sq * q_row + (long)hh * D;
  const float* kb = k + (long)bb * sk * k_row + (long)kh * D;
  const float* vb = v + (long)bb * sk * k_row + (long)kh * D;
  float* ob = o + (long)bb * sq * q_row + (long)hh * D;

  for (int i = tid; i < BQ * D; i += SIMT_THREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    qs[r * LD + d] = qi < sq ? qb[(long)qi * q_row + d] * scale : 0.f;
  }

  float m[RN], l[RN], acc[RN][ON];
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ON; ++c) acc[i][c] = 0.f;
  }

  int t_begin, t_end;
  k_tiles<BQ, BK>(q0, sk, causal, window, &t_begin, &t_end);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // qs written / previous tile's ks, vs, ps consumed
    for (int i = tid; i < BK * D; i += SIMT_THREADS) {
      const int r = i / D, d = i % D, kj = k0 + r;
      const bool in = kj < sk;
      ks[r * LD + d] = in ? kb[(long)kj * k_row + d] : 0.f;
      vs[r * D + d] = in ? vb[(long)kj * k_row + d] : 0.f;
    }
    __syncthreads();

    float s[RN][CN];
#pragma unroll
    for (int i = 0; i < RN; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RN], bk[CN];
#pragma unroll
      for (int i = 0; i < RN; ++i) a[i] = qs[(ty * RN + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) bk[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const int qi = q0 + ty * RN + i;
      bool ok[CN];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        ok[j] = visible(qi, k0 + tx + 16 * j, sk, causal, window);
        s[i][j] = x;
        if (ok[j]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[(ty * RN + i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < ON; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RN], vv[ON];
#pragma unroll
      for (int i = 0; i < RN; ++i) p[i] = ps[(ty * RN + i) * LDP + c];
#pragma unroll
      for (int e = 0; e < ON; ++e) vv[e] = vs[c * D + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int e = 0; e < ON; ++e) acc[i][e] = fmaf(p[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int qi = q0 + ty * RN + i;
    if (qi < sq) {
      if (lse != nullptr && tx == 0)
        lse[((long)bb * h + hh) * sq + qi] =
            l[i] > 0.f ? m[i] + logf(l[i]) : pos_inf();
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < ON; ++e)
        ob[(long)qi * q_row + tx + 16 * e] = acc[i][e] / denom;
    }
  }
}

// ----------------------------------------------------------------- launch
template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int b, int sq, int sk, int h, int kv,
                        int causal, int window, float softcap,
                        cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, b, sq, h, DH, HQ) ||
      !tensor_map(&tk, k, b, sk, kv, DH, HK) ||
      !tensor_map(&tv, v, b, sk, kv, DH, HK))
    return cudaErrorInvalidValue;
  const int smem = smem_bytes<Smem<padded(DH)>>();
  static bool configured = false;   // once, so that launches can be captured
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(h, b, (sq + HQ - 1) / HQ);
  flash_fwd_bf16<DH><<<grid, HOPPER_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, sq, sk, h, kv,
      causal, window, softcap, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int sq, int sk, int h, int kv,
                       int causal, int window, float softcap,
                       cudaStream_t stream) {
  const int smem = simt_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_f32<D><<<grid, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk, h,
      kv, causal, window, softcap, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int kv, int causal, int window,
           float softcap, cudaStream_t s) {
  return (int)(sizeof(T) == 2
                   ? launch_bf16<D>(q, k, v, o, lse, b, sq, sk, h, kv, causal,
                                    window, softcap, s)
                   : launch_f32<D>(q, k, v, o, lse, b, sq, sk, h, kv, causal,
                                   window, softcap, s));
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int b, int sq, int sk, int h, int kv, int dh, int causal,
             int window, float softcap, void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || sk <= 0 || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, o, l, b, sq, sk, h, kv, causal, window,
                           softcap, s);
    case 80:
      return launch<T, 80>(q, k, v, o, l, b, sq, sk, h, kv, causal, window,
                           softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, o, l, b, sq, sk, h, kv, causal, window,
                            softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// lse: (b, h, sq) fp32, or null to skip it
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int b, int sq, int sk, int h, int kv,
                        int dh, int causal, int window, float softcap,
                        void* stream) {
  return dispatch<float>(q, k, v, o, lse, b, sq, sk, h, kv, dh, causal,
                         window, softcap, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         void* lse, int b, int sq, int sk, int h, int kv,
                         int dh, int causal, int window, float softcap,
                         void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, b, sq, sk, h, kv, dh,
                                 causal, window, softcap, stream);
}

}  // extern "C"
