// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of
//   O = softmax(mask(softcap(Q K^T / sqrt(dh)))) V
// for the masks of the forward (causal, sliding window, ragged sq / sk),
// the softcap and GQA; q / dq (b, sq, h, dh), k / v / dk / dv (b, sk, kv,
// dh), all contiguous, fp32 or bf16; lse (b, h, sq) fp32 from the forward
// (flash_attention.cu, natural log, +inf for a row that sees no key).
//
// No Pallas kernel: the reference trains through XLA autodiff of
// src/repro/models/layers.py:blocked_attention; the port's forward is the
// CUDA kernel in flash_attention.cu, so its gradient needs this one.
//
// What bounds it: at the training shape (b 4, s 2048, h 32 / kv 4, dh 128,
// causal) the least work is the five products over the visible pairs,
// 2.5 x the forward's 1.375e11 FLOP = 3.44e11 FLOP, 0.35 ms at the bf16
// tensor-core peak, against ~0.3 GB of traffic (0.09 ms): compute-bound,
// and only wgmma reaches that rate.
//
// Three launches a call, each deterministic (no atomics: two calls give
// equal gradients):
//   * delta: D = rowsum(dO o O) per (b, h, q row), one warp a row;
//   * dK / dV: one block per (key tile, kv head, batch), the key tile the
//     slowest grid index, so the heaviest causal tiles start first.  dK
//     and dV stay in registers while the block walks the g query heads of
//     its kv head and, for each, the q tiles that can see the key tile: the
//     GQA sum over the group needs no atomics;
//   * dQ: one block per (q tile, head, batch), the forward's grid (the g
//     heads of one kv head are neighbouring blocks, so K / V hit in L2).
// S and dP are computed in both kernels: seven products where five are
// the least work, the price of a dQ without atomics.
//
// The bf16 design (both kernels): two warpgroups of 128 threads and no
// producer warp; thread 0 issues every TMA load (the forward's rank-4
// tensor maps and 128-byte swizzle, hopper.cuh) and refills a ring stage
// once both warpgroups have released it (full / empty mbarriers; a broken
// ring traps after 1 s instead of hanging the card).  Every product is
// wgmma:
//   * dK / dV: 128 keys a block, 64 a warpgroup.  K and V stay in shared
//     memory; Q and dO tiles of 64 rows stream through a 3-stage ring.  Per
//     tile S^T = K Q^T and dP^T = V dO^T (both operands K-major as stored),
//     then P^T and dS^T in registers, rounded to bf16 in place (the
//     register A layout, as the forward's P), and dV += P^T dO, dK += dS^T Q
//     with dO and Q read as stored through the transpose bit.  The q rows'
//     lse and D go through shared memory, one copy per warpgroup, each
//     thread prefetching its row of the next tile.  Registers: dK + dV
//     (2 x 64) + S^T + dP^T (2 x 32) at dh 128 (244 a thread in all),
//     which is why the block has no producer warp: with one, ptxas sizes
//     the allocation for three warpgroups (168 a thread for the forward,
//     flash_attention.cu).  Shared memory at dh 128: 64 KB of K / V,
//     3 x 32 KB of Q / dO and 2 KB of lse / D;
//   * dQ: 128 q rows a block, 64 a warpgroup, Q and dO resident, K and V
//     tiles of 64 keys through a 3-stage ring.  S = Q K^T and dP = dO V^T
//     (K-major), dS in registers, dQ += dS K with K read through the
//     transpose bit.  Tile i's S and dP are issued with tile i - 1's dS K,
//     so each softmax gradient overlaps a product.  Shared memory at dh
//     128: 64 KB of Q / dO and 3 x 32 KB of K / V.
// Head dims 64, 80 and 128.  At dh 80 (stablelm-3b) the tiles are two
// 64-column boxes as at dh 128, TMA filling columns 80-127 with zeros
// (padded(), hopper.cuh): the products over the head dim (S, dP) take its
// 5 real k-steps, the products into it (dV, dK, dQ) run at N = 128 and
// only columns 0-79 are stored; the registers and shared memory are the
// dh-128 kernels'.
// P and dS are each rounded to bf16 once before the product that takes
// them, as FlashAttention does; the CPU test test_torch_flash_bwd.py holds
// that rounding to the bf16 tolerance.  Masked pairs get P = 0 by an
// explicit visibility test, never through the value of lse, so rows that
// see no key (lse +inf) and rows past sq give zero gradients, not NaN; the
// test runs only on tiles that can hold an invisible pair.  Past a
// sequence's end TMA reads zeros, and nothing is stored there.
//
// Measured at the training shape (tools/flash_bwd_variants.json): the
// dK / dV kernel sets the pace (four of the seven products, on an eighth
// of dQ's blocks); it took 1.5x as long with 32 q rows a stage and 1.4x
// with the key tile as the fastest grid index (lightest and heaviest
// blocks mixed).
//
// fp32 keeps the first port's CUDA-core body (the tolerance of the fp32 path,
// 3e-5, rules out TF32): 64 x 64 tiles, fp32 FMA, 4 x 4 scores a thread,
// the tiles copied into padded shared memory element by element.  dK / dV
// sum each q tile apart before adding it to the running sums: one
// sequential fp32 sum over the group's g x sq rows missed the tolerance at
// the training shape (tools/flash_bwd_fp64.py holds both against float64).

#include "hopper.cuh"

namespace {

// Is key kj visible from query qi?  Causal positions start at 0 for both.
__device__ __forceinline__ bool visible(int qi, int kj, int sq, int sk,
                                        int causal, int window) {
  bool ok = qi < sq && kj < sk;
  if (causal) {
    ok = ok && kj <= qi;
    if (window > 0) ok = ok && (qi - kj) < window;
  }
  return ok;
}

// ----------------------------------------------------------------- fp32
constexpr int BM = 64;         // q rows or keys per tile
constexpr int THREADS = 256;   // 16 row groups x 16 column lanes
constexpr int RN = BM / 16;    // tile rows per thread (4)
constexpr int CN = BM / 16;    // score columns per thread (4)
constexpr int LDP = BM + 1;    // padded row stride of the P / dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// rows [r0, r0 + BM) of a (rows, heads, D) tensor at head `head` into a
// BM x (D + 1) fp32 tile; rows past n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int r0,
                                          int n, long row_stride) {
  for (int i = threadIdx.x; i < BM * D; i += THREADS) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < n ? to_f(base[(long)row * row_stride + d])
                                   : 0.f;
  }
}

// The 4 x 4 scores and dP of this thread for q tile q0 (rows ty RN + i of
// qs / dos) against key tile k0 (rows tx + 16 j of ks / vs), turned into P
// and dS (scaled by 1 / sqrt(dh)) and stored as ps (if STORE_P) and
// dss[q row][key].
template <int D, bool STORE_P>
__device__ __forceinline__ void p_and_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* ls, const float* dls, float* ps, float* dss, int q0, int k0,
    int sq, int sk, int causal, int window, float softcap, float scale) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[RN][CN], dp[RN][CN];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RN], ad[RN], bk[CN], bv[CN];
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      a[i] = qs[(ty * RN + i) * LD + d];
      ad[i] = dos[(ty * RN + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      bk[j] = ks[(tx + 16 * j) * LD + d];
      bv[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RN; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(ad[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int r = ty * RN + i;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = tx + 16 * j;
      float x = s[i][j] * scale, dcap = 1.f;
      if (softcap > 0.f) {
        const float th = tanhf(x / softcap);
        x = softcap * th;
        dcap = 1.f - th * th;
      }
      const bool ok = visible(q0 + r, k0 + c, sq, sk, causal, window);
      const float p = ok ? expf(x - ls[r]) : 0.f;
      if (STORE_P) ps[r * LDP + c] = p;
      dss[r * LDP + c] = p * (dp[i][j] - dls[r]) * dcap * scale;
    }
  }
}

// D = rowsum(dO o O): one warp per row of the (b, sq, h) rows; written to
// delta (b, h, sq)
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          float* __restrict__ delta, long rows, int sq, int h, int D) {
  const long row = ((long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int hh = (int)(row % h);
    const long bq = row / h;             // bb * sq + qi
    const int qi = (int)(bq % sq);
    const long bb = bq / sq;
    delta[(bb * h + hh) * sq + qi] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
         int kv, int causal, int window, float softcap, float scale) {
  constexpr int LD = D + 1;
  constexpr int ON = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BM * LD;
  float* qs = vs + BM * LD;
  float* dos = qs + BM * LD;
  float* ps = dos + BM * LD;
  float* dss = ps + BM * LDP;
  float* ls = dss + BM * LDP;
  float* dls = ls + BM;

  // heaviest first: under a causal mask key tile k0 is seen by q rows
  // [k0, sq), so the first tile has the most work
  const int k0 = blockIdx.x * BM;
  const int kh = blockIdx.y, bb = blockIdx.z;
  const int g = h / kv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long q_row = (long)h * D, k_row = (long)kv * D;

  load_tile<T, D>(ks, k + (long)bb * sk * k_row + (long)kh * D, k0, sk, k_row);
  load_tile<T, D>(vs, v + (long)bb * sk * k_row + (long)kh * D, k0, sk, k_row);

  float acc_k[RN][ON], acc_v[RN][ON];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int e = 0; e < ON; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  // the q rows that can see some key of [k0, k0 + BM)
  int q_lo = 0, q_hi = sq;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(sq, k0 + BM - 1 + window);
  }
  const int t_begin = q_lo / BM;
  const int t_end = q_lo < q_hi ? (q_hi + BM - 1) / BM : t_begin;

  for (int hh = kh * g; hh < (kh + 1) * g; ++hh) {
    const long head = (long)hh * D;
    const float* lrow = lse + ((long)bb * h + hh) * sq;
    const float* drow = delta + ((long)bb * h + hh) * sq;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * BM;
      __syncthreads();   // the previous tile's qs, dos, ps, dss consumed
      load_tile<T, D>(qs, q + (long)bb * sq * q_row + head, q0, sq, q_row);
      load_tile<T, D>(dos, dout + (long)bb * sq * q_row + head, q0, sq, q_row);
      if (threadIdx.x < BM) {
        const int qi = q0 + threadIdx.x;
        ls[threadIdx.x] = qi < sq ? lrow[qi] : 0.f;
        dls[threadIdx.x] = qi < sq ? drow[qi] : 0.f;
      }
      __syncthreads();
      p_and_ds<D, true>(qs, dos, ks, vs, ls, dls, ps, dss, q0, k0, sq, sk,
                        causal, window, softcap, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: this thread's keys are ty RN + i.  The
      // tile's 64 rows are summed apart and then added to the running sums
      // (blocked summation, see the header)
      float tile_k[RN][ON], tile_v[RN][ON];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int e = 0; e < ON; ++e) tile_k[i][e] = tile_v[i][e] = 0.f;
#pragma unroll 2
      for (int r = 0; r < BM; ++r) {
        float pp[RN], dd[RN], o[ON], qq[ON];
#pragma unroll
        for (int i = 0; i < RN; ++i) {
          pp[i] = ps[r * LDP + ty * RN + i];
          dd[i] = dss[r * LDP + ty * RN + i];
        }
#pragma unroll
        for (int e = 0; e < ON; ++e) {
          o[e] = dos[r * LD + tx + 16 * e];
          qq[e] = qs[r * LD + tx + 16 * e];
        }
#pragma unroll
        for (int i = 0; i < RN; ++i)
#pragma unroll
          for (int e = 0; e < ON; ++e) {
            tile_v[i][e] = fmaf(pp[i], o[e], tile_v[i][e]);
            tile_k[i][e] = fmaf(dd[i], qq[e], tile_k[i][e]);
          }
      }
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int e = 0; e < ON; ++e) {
          acc_v[i][e] += tile_v[i][e];
          acc_k[i][e] += tile_k[i][e];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int kj = k0 + ty * RN + i;
    if (kj < sk) {
      const long base = ((long)bb * sk + kj) * k_row + (long)kh * D;
#pragma unroll
      for (int e = 0; e < ON; ++e) {
        dk[base + tx + 16 * e] = from_f<T>(acc_k[i][e]);
        dv[base + tx + 16 * e] = from_f<T>(acc_v[i][e]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, int sq, int sk, int h, int kv, int causal,
       int window, float softcap, float scale) {
  constexpr int LD = D + 1;
  constexpr int ON = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BM * LD;
  float* ks = dos + BM * LD;
  float* vs = ks + BM * LD;
  float* dss = vs + BM * LD;
  float* ls = dss + BM * LDP;
  float* dls = ls + BM;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // heaviest first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / kv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long q_row = (long)h * D, k_row = (long)kv * D;

  load_tile<T, D>(qs, q + (long)bb * sq * q_row + (long)hh * D, q0, sq, q_row);
  load_tile<T, D>(dos, dout + (long)bb * sq * q_row + (long)hh * D, q0, sq,
                  q_row);
  if (threadIdx.x < BM) {
    const int qi = q0 + threadIdx.x;
    const long at = ((long)bb * h + hh) * sq + qi;
    ls[threadIdx.x] = qi < sq ? lse[at] : 0.f;
    dls[threadIdx.x] = qi < sq ? delta[at] : 0.f;
  }

  float acc[RN][ON];
#pragma unroll
  for (int i = 0; i < RN; ++i)
#pragma unroll
    for (int e = 0; e < ON; ++e) acc[i][e] = 0.f;

  // the keys some row of [q0, q0 + BM) can see
  int k_lo = 0, k_hi = sk;
  if (causal) {
    k_hi = min(sk, q0 + BM);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_begin = k_lo / BM;
  const int t_end = k_lo < k_hi ? (k_hi + BM - 1) / BM : t_begin;
  const T* kb = k + (long)bb * sk * k_row + (long)kh * D;
  const T* vb = v + (long)bb * sk * k_row + (long)kh * D;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BM;
    __syncthreads();     // qs written / the previous tile's ks, vs, dss read
    load_tile<T, D>(ks, kb, k0, sk, k_row);
    load_tile<T, D>(vs, vb, k0, sk, k_row);
    __syncthreads();
    p_and_ds<D, false>(qs, dos, ks, vs, ls, dls, nullptr, dss, q0, k0, sq, sk,
                       causal, window, softcap, scale);
    __syncthreads();
    // dQ += dS K: this thread's q rows are ty RN + i
#pragma unroll 2
    for (int c = 0; c < BM; ++c) {
      float dd[RN], kk[ON];
#pragma unroll
      for (int i = 0; i < RN; ++i) dd[i] = dss[(ty * RN + i) * LDP + c];
#pragma unroll
      for (int e = 0; e < ON; ++e) kk[e] = ks[c * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int e = 0; e < ON; ++e) acc[i][e] = fmaf(dd[i], kk[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int qi = q0 + ty * RN + i;
    if (qi < sq) {
      const long base = ((long)bb * sq + qi) * q_row + (long)hh * D;
#pragma unroll
      for (int e = 0; e < ON; ++e) dq[base + tx + 16 * e] = from_f<T>(acc[i][e]);
    }
  }
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return 4 * (4 * BM * (D + 1) + 2 * BM * LDP + 2 * BM);
}

template <int D>
constexpr int dq_smem_bytes() {
  return 4 * (4 * BM * (D + 1) + BM * LDP + 2 * BM);
}

// ----------------------------------------------------------------- bf16
constexpr int TC_THREADS = 2 * WG;   // two warpgroups, no producer warp
constexpr int KV_BK = 128;           // dK / dV: keys a block, 64 a warpgroup
constexpr int KV_BQ = 64;            // dK / dV: q rows a ring stage
constexpr int KV_STAGES = 3;
constexpr int Q_BQ = 128;            // dQ: q rows a block, 64 a warpgroup
constexpr int Q_BK = 64;             // dQ: keys a ring stage
constexpr int Q_STAGES = 3;

// Each tile is D / 64 boxes of (rows x 64) bf16 side by side, each box
// 128-byte swizzled as TMA writes it; every box starts on 1024 bytes.
template <int D>
struct DkdvSmem {
  alignas(1024) __nv_bfloat16 k[KV_BK * D];
  alignas(1024) __nv_bfloat16 v[KV_BK * D];
  alignas(1024) __nv_bfloat16 q[KV_STAGES][KV_BQ * D];
  alignas(1024) __nv_bfloat16 dout[KV_STAGES][KV_BQ * D];
  // [warpgroup][step parity][q row]: log2(e) lse and D of the step's rows
  float lse[2][2][KV_BQ];
  float delta[2][2][KV_BQ];
  uint64_t kv_full, full[KV_STAGES], empty[KV_STAGES];
};

template <int D>
struct DqSmem {
  alignas(1024) __nv_bfloat16 q[Q_BQ * D];
  alignas(1024) __nv_bfloat16 dout[Q_BQ * D];
  alignas(1024) __nv_bfloat16 k[Q_STAGES][Q_BK * D];
  alignas(1024) __nv_bfloat16 v[Q_STAGES][Q_BK * D];
  uint64_t q_full, full[Q_STAGES], empty[Q_STAGES];
};

// The 128 threads of warpgroup wg wait for each other (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, %0;\n" :: "n"(WG) : "memory");
  else
    asm volatile("bar.sync 2, %0;\n" :: "n"(WG) : "memory");
}

// The rows [row, row + rows) of one head of two (batch, seq, heads, D)
// tensors into shared tiles a and b, completion counted on `bar`.
template <int D>
__device__ __forceinline__ void tma_pair(__nv_bfloat16* a,
                                         const CUtensorMap* ma,
                                         __nv_bfloat16* b,
                                         const CUtensorMap* mb, uint64_t* bar,
                                         int rows, int head, int row,
                                         int batch) {
  mbar_expect_tx(bar, 2 * rows * D * 2);
  for (int j = 0; j < D / BOX; ++j) {
    tma_load4(a + j * rows * BOX, ma, bar, j * BOX, head, row, batch);
    tma_load4(b + j * rows * BOX, mb, bar, j * BOX, head, row, batch);
  }
}

// C (64 x N) = A B^T over the DH columns of the head dim: A the 64 rows
// from row a0 of a tile of a_rows, B a tile of N rows, both K-major as
// stored.
template <int DH, int N>
__device__ __forceinline__ void issue_abt(float (&c)[N / 2],
                                          const __nv_bfloat16* a, int a_rows,
                                          int a0, const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 16;
    wgmma_ss(c, gmma_desc(a + box * a_rows * BOX + a0 * BOX + off, 16, 1024),
             gmma_desc(b + box * N * BOX + off, 16, 1024), kk > 0);
  }
}

// C (64 x D) += A B: A (64 x K) bf16 registers, B a tile of K rows read as
// stored (MN-major through the transpose bit); LBO steps between the
// 64-wide boxes of D, SBO between groups of 8 rows.
template <int D, int K>
__device__ __forceinline__ void issue_ab(float (&c)[D / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs(c, a[kk], gmma_desc(b + kk * 16 * BOX, K * BOX * 2, 1024));
}

// One pair's score s and dP in place: s becomes P = exp(logit - lse) if the
// pair is visible (else 0), dp becomes dS = P (dP - D) (1 - tanh^2 under a
// softcap) / sqrt(dh).  Logits in base 2: s sl2 without a softcap, cap_out
// tanh(s cap_in) with one; lse2 is log2(e) lse.
__device__ __forceinline__ void p_and_ds_pair(float& s, float& dp, float lse2,
                                              float d, bool ok, float sl2,
                                              float cap_in, float cap_out,
                                              float scale) {
  float x, dcap = scale;
  if (cap_in > 0.f) {
    const float th = tanhf(s * cap_in);
    x = cap_out * th;
    dcap = (1.f - th * th) * scale;
  } else {
    x = s * sl2;
  }
  const float p = ok ? fexp2(x - lse2) : 0.f;
  s = p;
  dp = p * (dp - d) * dcap;
}

struct Grad {
  int sq, sk, causal, window;
  float sl2, cap_in, cap_out, scale;
};

// P^T and dS^T of the dK / dV kernel, as the bf16 register A operands pa
// and da: rows are keys (kr, kr + 8), columns the q rows q0 + c.  Element i
// of a thread is key kr + 8 ((i >> 1) & 1), column c = 8 (i >> 2) + 2 t +
// (i & 1), whose lse2 and D are ls[c], dl[c]; k-step kk of the operands
// holds elements 8 kk .. 8 kk + 7, so each is packed as soon as it is done.
template <bool MASKED>
__device__ __forceinline__ void grad_keys(float (&st)[KV_BQ / 2],
                                          float (&dpt)[KV_BQ / 2],
                                          uint32_t (&pa)[KV_BQ / 16][4],
                                          uint32_t (&da)[KV_BQ / 16][4],
                                          const float* ls, const float* dl,
                                          int kr, int q0, int t,
                                          const Grad& gr) {
#pragma unroll
  for (int kk = 0; kk < KV_BQ / 16; ++kk) {
#pragma unroll
    for (int i = 8 * kk; i < 8 * kk + 8; ++i) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);
      const bool ok = !MASKED || visible(q0 + c, kr + 8 * ((i >> 1) & 1),
                                         gr.sq, gr.sk, gr.causal, gr.window);
      p_and_ds_pair(st[i], dpt[i], ls[c], dl[c], ok, gr.sl2, gr.cap_in,
                    gr.cap_out, gr.scale);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
      da[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
    }
  }
}

// P and dS of the dQ kernel: rows are the q rows r0, r0 + 8 (lse2 ls[r],
// D dl[r]), columns the keys k0 + 8 (i >> 2) + 2 t + (i & 1).
template <bool MASKED>
__device__ __forceinline__ void grad_rows(float (&sc)[Q_BK / 2],
                                          float (&dp)[Q_BK / 2],
                                          const float (&ls)[2],
                                          const float (&dl)[2], int r0,
                                          int k0, int t, const Grad& gr) {
#pragma unroll
  for (int i = 0; i < Q_BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const bool ok = !MASKED || visible(r0 + 8 * r,
                                       k0 + 8 * (i >> 2) + 2 * t + (i & 1),
                                       gr.sq, gr.sk, gr.causal, gr.window);
    p_and_ds_pair(sc[i], dp[i], ls[r], dl[r], ok, gr.sl2, gr.cap_in,
                  gr.cap_out, gr.scale);
  }
}

// Can the tile of q rows [q0, q0 + QN) and keys [k0, k0 + KN) hold a pair
// that is not visible?  Only such tiles run the visibility test.
template <int QN, int KN>
__device__ __forceinline__ bool edge_tile(int q0, int k0, const Grad& gr) {
  return q0 + QN > gr.sq || k0 + KN > gr.sk ||
         (gr.causal && (k0 + KN - 1 > q0 ||
                        (gr.window > 0 && q0 + QN - 1 - k0 >= gr.window)));
}

// Rows r, r + 8 of a 64 x N accumulator tile (element i: row + 8 ((i >> 1)
// & 1), column 8 (i >> 2) + 2 t + (i & 1)), its first DH columns, to bf16
// rows at dst0 / dst8 (already offset by 2 t), skipping a null row.
template <int DH, int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N],
                                           __nv_bfloat16* dst0,
                                           __nv_bfloat16* dst8) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* dst = r ? dst8 : dst0;
    if (dst == nullptr) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              int sq, int sk, int h, int kv, Grad gr) {
  constexpr int D = padded(DH);        // the tiles' width in shared memory
  constexpr int S = KV_STAGES;
  extern __shared__ unsigned char smem_raw[];
  DkdvSmem<D>& sm = aligned_smem<DkdvSmem<D>>(smem_raw);

  const int kh = blockIdx.x, bb = blockIdx.y;
  const int k0 = blockIdx.z * KV_BK;   // the slowest index: heaviest first
  const int g = h / kv;
  // the q tiles that can see some key of [k0, k0 + KV_BK); the block walks
  // n steps of (query head of the group, q tile)
  int q_lo = 0, q_hi = sq;
  if (gr.causal) {
    q_lo = k0;
    if (gr.window > 0) q_hi = min(sq, k0 + KV_BK - 1 + gr.window);
  }
  const int t_begin = q_lo / KV_BQ;
  const int nt = q_lo < q_hi ? (q_hi + KV_BQ - 1) / KV_BQ - t_begin : 0;
  const int n = g * nt;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], TC_THREADS / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n > 0) {
    tma_pair<D>(sm.k, &tm_k, sm.v, &tm_v, &sm.kv_full, KV_BK, kh, k0, bb);
    for (int i = 0; i < min(n, S); ++i)
      tma_pair<D>(sm.q[i], &tm_q, sm.dout[i], &tm_do, &sm.full[i], KV_BQ,
                  kh * g + i / nt, (t_begin + i % nt) * KV_BQ, bb);
  }

  // warp-uniform to the compiler (a shuffle), so that the wgmma code needs
  // no divergence handling
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int kw = k0 + wg * 64;                   // this warpgroup's keys
  const int kr = kw + warp * 16 + (lane >> 2);   // this thread's: kr, kr + 8
  // thread tid < 2 KV_BQ stages the lse2 (tid < KV_BQ) or D of q row
  // tid % KV_BQ of every step: it reads row src[(step head) sq + q row]
  const bool stages = tid < 2 * KV_BQ;
  const bool stages_lse = tid < KV_BQ;
  const int my_row = tid % KV_BQ;
  const float* src = (stages_lse ? lse : delta) + ((long)bb * h + kh * g) * sq;
  const float mul = stages_lse ? LOG2E : 1.f;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  uint32_t pa[KV_BQ / 16][4], da[KV_BQ / 16][4];

  // this thread's lse2 or D of step i's q row my_row, read ahead a step
  auto row_value = [&](int i) {
    const int qi = (t_begin + i % nt) * KV_BQ + my_row;
    return stages && qi < sq ? src[(long)(i / nt) * sq + qi] * mul : 0.f;
  };
  float ahead = n > 0 ? row_value(0) : 0.f;
  if (n > 0) mbar_wait(&sm.kv_full, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    const int q0 = (t_begin + i % nt) * KV_BQ;
    // a step's rows go to the buffer of its parity: the one step i - 2
    // read, which every thread of the warpgroup finished before step i - 1's
    // barrier
    float* ls = sm.lse[wg][i & 1];
    float* dl = sm.delta[wg][i & 1];
    if (stages) (stages_lse ? ls : dl)[my_row] = ahead;
    if (i + 1 < n) ahead = row_value(i + 1);
    wg_sync(wg);

    float st[KV_BQ / 2], dpt[KV_BQ / 2];
#pragma unroll
    for (int j = 0; j < KV_BQ / 2; ++j) st[j] = dpt[j] = 0.f;
    mbar_wait(&sm.full[s], (i / S) & 1);
    wgmma_fence();
    fence_regs(st);
    fence_regs(dpt);
    issue_abt<DH, KV_BQ>(st, sm.k, KV_BK, wg * 64, sm.q[s]);
    issue_abt<DH, KV_BQ>(dpt, sm.v, KV_BK, wg * 64, sm.dout[s]);
    wgmma_commit();
    // while the products run, thread 0 refills the stage of step i - 1 with
    // step i - 1 + S once both warpgroups have released it
    const int j = i - 1 + S;
    if (threadIdx.x == 0 && i >= 1 && j < n) {
      const int sj = j % S;
      mbar_wait(&sm.empty[sj], ((i - 1) / S) & 1);
      tma_pair<D>(sm.q[sj], &tm_q, sm.dout[sj], &tm_do, &sm.full[sj], KV_BQ,
                  kh * g + j / nt, (t_begin + j % nt) * KV_BQ, bb);
    }
    __syncwarp();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    if (edge_tile<KV_BQ, 64>(q0, kw, gr))
      grad_keys<true>(st, dpt, pa, da, ls, dl, kr, q0, t, gr);
    else
      grad_keys<false>(st, dpt, pa, da, ls, dl, kr, q0, t, gr);
    wgmma_fence();
    fence_regs(acc_v);
    fence_regs(acc_k);
    issue_ab<D, KV_BQ>(acc_v, pa, sm.dout[s]);   // dV += P^T dO
    issue_ab<D, KV_BQ>(acc_k, da, sm.q[s]);      // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(pa);
    fence_regs(da);
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  const long kv_row = (long)kv * DH;
  __nv_bfloat16* out[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kr + 8 * r;
    const long at = ((long)bb * sk + key) * kv_row + (long)kh * DH + 2 * t;
    out[0][r] = key < sk ? dk + at : nullptr;
    out[1][r] = key < sk ? dv + at : nullptr;
  }
  store_rows<DH>(acc_k, out[0][0], out[0][1]);
  store_rows<DH>(acc_v, out[1][0], out[1][1]);
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, int sq, int sk, int h, int kv,
            Grad gr) {
  constexpr int D = padded(DH);        // the tiles' width in shared memory
  constexpr int S = Q_STAGES;
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D>& sm = aligned_smem<DqSmem<D>>(smem_raw);

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * Q_BQ;   // heaviest first
  const int kh = hh / (h / kv);
  // the key tiles some row of [q0, q0 + Q_BQ) can see
  int k_lo = 0, k_hi = sk;
  if (gr.causal) {
    k_hi = min(sk, q0 + Q_BQ);
    if (gr.window > 0) k_lo = max(0, q0 - gr.window + 1);
  }
  const int t_begin = k_lo / Q_BK;
  const int n = k_lo < k_hi ? (k_hi + Q_BK - 1) / Q_BK - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], TC_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n > 0) {
    tma_pair<D>(sm.q, &tm_q, sm.dout, &tm_do, &sm.q_full, Q_BQ, hh, q0, bb);
    for (int i = 0; i < min(n, S); ++i)
      tma_pair<D>(sm.k[i], &tm_k, sm.v[i], &tm_v, &sm.full[i], Q_BK, kh,
                  (t_begin + i) * Q_BK, bb);
  }

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32, t = lane & 3;
  const int ql = q0 + wg * 64;                   // this warpgroup's rows
  const int r0 = ql + warp * 16 + (lane >> 2);   // this thread's: r0, r0 + 8
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const long at = ((long)bb * h + hh) * sq + row;
    ls[r] = row < sq ? lse[at] * LOG2E : 0.f;
    dl[r] = row < sq ? delta[at] : 0.f;
  }

  float acc[D / 2], sc[Q_BK / 2], dp[Q_BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Q_BK / 2; ++i) sc[i] = dp[i] = 0.f;
  uint32_t da[Q_BK / 16][4];

  // Tile i's S and dP are computed while tile i - 1's dS K runs: its
  // softmax gradient overlaps that product.
  if (n > 0) {
    const int k0 = t_begin * Q_BK;
    mbar_wait(&sm.q_full, 0);
    mbar_wait(&sm.full[0], 0);
    wgmma_fence();
    fence_regs(sc);
    fence_regs(dp);
    issue_abt<DH, Q_BK>(sc, sm.q, Q_BQ, wg * 64, sm.k[0]);
    issue_abt<DH, Q_BK>(dp, sm.dout, Q_BQ, wg * 64, sm.v[0]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if (edge_tile<64, Q_BK>(ql, k0, gr))
      grad_rows<true>(sc, dp, ls, dl, r0, k0, t, gr);
    else
      grad_rows<false>(sc, dp, ls, dl, r0, k0, t, gr);
    pack_a<Q_BK>(da, dp);
  }
  for (int i = 1; i < n; ++i) {
    const int s = i % S, sp = (i - 1) % S;
    const int k0 = (t_begin + i) * Q_BK;
    mbar_wait(&sm.full[s], (i / S) & 1);
    wgmma_fence();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
    issue_abt<DH, Q_BK>(sc, sm.q, Q_BQ, wg * 64, sm.k[s]);
    issue_abt<DH, Q_BK>(dp, sm.dout, Q_BQ, wg * 64, sm.v[s]);
    wgmma_commit();
    issue_ab<D, Q_BK>(acc, da, sm.k[sp]);     // dQ += dS K of tile i - 1
    wgmma_commit();
    wgmma_wait<1>();                          // S and dP are in
    fence_regs(sc);
    fence_regs(dp);
    if (edge_tile<64, Q_BK>(ql, k0, gr))
      grad_rows<true>(sc, dp, ls, dl, r0, k0, t, gr);
    else
      grad_rows<false>(sc, dp, ls, dl, r0, k0, t, gr);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    if (lane == 0) mbar_arrive(&sm.empty[sp]);
    // thread 0 refills the stage of tile i - 1 with tile i - 1 + S once
    // both warpgroups have released it
    const int j = i - 1 + S;
    if (threadIdx.x == 0 && j < n) {
      mbar_wait(&sm.empty[sp], ((i - 1) / S) & 1);
      tma_pair<D>(sm.k[sp], &tm_k, sm.v[sp], &tm_v, &sm.full[sp], Q_BK, kh,
                  (t_begin + j) * Q_BK, bb);
    }
    __syncwarp();
    pack_a<Q_BK>(da, dp);
  }
  if (n > 0) {
    wgmma_fence();
    fence_regs(acc);
    issue_ab<D, Q_BK>(acc, da, sm.k[(n - 1) % S]);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
  }

  __nv_bfloat16* out[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    out[r] = row < sq ? dq + (((long)bb * sq + row) * h + hh) * DH + 2 * t
                      : nullptr;
  }
  store_rows<DH>(acc, out[0], out[1]);
}

// ----------------------------------------------------------------- launch
// Bits of `stages`: which of the three kernels a bf16 call launches (the
// op launches all three; chip_smoke.py times each alone).
constexpr int STAGE_DELTA = 1, STAGE_DKDV = 2, STAGE_DQ = 4;

// D = rowsum(dO o O) into delta (b, h, sq)
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, void* delta, int b,
                         int sq, int h, int D, cudaStream_t stream) {
  const long rows = (long)b * sq * h;
  const int warps_per_block = THREADS / 32;
  bwd_delta<T><<<(unsigned)((rows + warps_per_block - 1) / warps_per_block),
                 THREADS, 0, stream>>>(static_cast<const T*>(o),
                                       static_cast<const T*>(dout),
                                       static_cast<float*>(delta), rows, sq,
                                       h, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       void* dq, void* dk, void* dv, void* delta, int b,
                       int sq, int sk, int h, int kv, int causal, int window,
                       float softcap, cudaStream_t stream) {
  using T = float;
  static bool configured = false;   // once, so that launches can be captured
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dkdv_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float scale = 1.0f / sqrtf((float)D);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* tl = static_cast<const float*>(lse);
  float* td = static_cast<float*>(delta);

  cudaError_t err = launch_delta<T>(o, dout, delta, b, sq, h, D, stream);
  if (err != cudaSuccess) return err;

  const dim3 grid_kv((sk + BM - 1) / BM, kv, b);
  bwd_dkdv<T, D><<<grid_kv, THREADS, dkdv_smem_bytes<D>(), stream>>>(
      tq, tk, tv, tdo, tl, td, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      sk, h, kv, causal, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid_q((sq + BM - 1) / BM, h, b);
  bwd_dq<T, D><<<grid_q, THREADS, dq_smem_bytes<D>(), stream>>>(
      tq, tk, tv, tdo, tl, td, static_cast<T*>(dq), sq, sk, h, kv, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dq, void* dk, void* dv, void* delta, int b,
                        int sq, int sk, int h, int kv, int causal, int window,
                        float softcap, int stages, cudaStream_t stream) {
  constexpr int KV_SMEM = smem_bytes<DkdvSmem<padded(DH)>>();
  constexpr int Q_SMEM = smem_bytes<DqSmem<padded(DH)>>();
  static bool configured = false;   // once, so that launches can be captured
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dkdv_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KV_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_dq_bf16<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Q_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float scale = 1.0f / sqrtf((float)DH);
  const Grad gr{sq, sk, causal, window, scale * LOG2E,
                softcap > 0.f ? scale / softcap : 0.f, softcap * LOG2E,
                scale};
  const float* tl = static_cast<const float*>(lse);
  const float* td = static_cast<const float*>(delta);
  cudaError_t err = cudaSuccess;
  if (stages & STAGE_DELTA) {
    err = launch_delta<__nv_bfloat16>(o, dout, delta, b, sq, h, DH, stream);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap tq, tk, tv, tdo;
  if (stages & STAGE_DKDV) {
    if (!tensor_map(&tq, q, b, sq, h, DH, KV_BQ) ||
        !tensor_map(&tdo, dout, b, sq, h, DH, KV_BQ) ||
        !tensor_map(&tk, k, b, sk, kv, DH, KV_BK) ||
        !tensor_map(&tv, v, b, sk, kv, DH, KV_BK))
      return cudaErrorInvalidValue;
    const dim3 grid(kv, b, (sk + KV_BK - 1) / KV_BK);
    bwd_dkdv_bf16<DH><<<grid, TC_THREADS, KV_SMEM, stream>>>(
        tq, tk, tv, tdo, tl, td, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), sq, sk, h, kv, gr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & STAGE_DQ) {
    if (!tensor_map(&tq, q, b, sq, h, DH, Q_BQ) ||
        !tensor_map(&tdo, dout, b, sq, h, DH, Q_BQ) ||
        !tensor_map(&tk, k, b, sk, kv, DH, Q_BK) ||
        !tensor_map(&tv, v, b, sk, kv, DH, Q_BK))
      return cudaErrorInvalidValue;
    const dim3 grid(h, b, (sq + Q_BQ - 1) / Q_BQ);
    bwd_dq_bf16<DH><<<grid, TC_THREADS, Q_SMEM, stream>>>(
        tq, tk, tv, tdo, tl, td, static_cast<__nv_bfloat16*>(dq), sq, sk, h,
        kv, gr);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int b, int sq, int sk, int h, int kv, int causal,
           int window, float softcap, int stages, cudaStream_t s) {
  return (int)(sizeof(T) == 2
                   ? launch_bf16<D>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                    b, sq, sk, h, kv, causal, window, softcap,
                                    stages, s)
                   : launch_f32<D>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                   b, sq, sk, h, kv, causal, window, softcap,
                                   s));
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dq, void* dk, void* dv,
             void* delta, int b, int sq, int sk, int h, int kv, int dh,
             int causal, int window, float softcap, int stages,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || sk <= 0 || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
#define BWD_ARGS q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk, h, kv, \
                 causal, window, softcap, stages, s
  switch (dh) {
    case 64: return launch<T, 64>(BWD_ARGS);
    case 80: return launch<T, 80>(BWD_ARGS);
    case 128: return launch<T, 128>(BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_ARGS
}

}  // namespace

extern "C" {

// q, o, dout, dq: (b, sq, h, dh); k, v, dk, dv: (b, sk, kv, dh); lse and
// the scratch delta: (b, h, sq) fp32
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dq, void* dk, void* dv, void* delta, int b,
                            int sq, int sk, int h, int kv, int dh, int causal,
                            int window, float softcap, void* stream) {
  return dispatch<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq, sk,
                         h, kv, dh, causal, window, softcap, 0, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dq, void* dk, void* dv, void* delta, int b,
                             int sq, int sk, int h, int kv, int dh,
                             int causal, int window, float softcap,
                             void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, b,
                                 sq, sk, h, kv, dh, causal, window, softcap,
                                 STAGE_DELTA | STAGE_DKDV | STAGE_DQ, stream);
}

// The bf16 entry with the kernels named by `stages` only (1 delta, 2 dK /
// dV, 4 dQ; 7 is flash_attention_bwd_bf16), for timing each kernel alone.
int flash_attention_bwd_bf16_stages(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    void* dq, void* dk, void* dv, void* delta,
                                    int b, int sq, int sk, int h, int kv,
                                    int dh, int causal, int window,
                                    float softcap, int stages, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, b,
                                 sq, sk, h, kv, dh, causal, window, softcap,
                                 stages, stream);
}

}  // extern "C"
