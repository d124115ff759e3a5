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
//     neighbouring blocks, so their K/V tiles hit in L2.
// Padded k/v rows are zero (TMA's fill) and masked (C-a of the roadmap);
// q rows past sq are zero and never stored.
//
// fp32 keeps its CUDA-core body (the tolerance of the fp32 path, 3e-5,
// rules out TF32): 64 x 64 tiles, fp32 FMA, each thread holding a 4 x 4
// tile of scores and a 4 x dh/16 tile of the output, plain loads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU, without exp2f's handling of denormal results
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// ------------------------------------------------------- Hopper primitives
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that has not ended after a second traps, so that a broken
// pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0, polls = 0;
  uint64_t since = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (++polls % 256 == 0) {
      const uint64_t now = globaltimer_ns();
      if (since == 0) since = now;
      else if (now - since > 1000000000ull) __trap();
    }
  }
}

// One TMA box of a rank-4 tensor map into shared memory; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 96, fp32) (+)= A (64 x 16, shared, K-major) * B (16 x 96, shared,
// K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, shared,
// MN-major: the transpose bit reads B as stored, rows = the k dimension).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, shared,
// MN-major: the transpose bit reads B as stored, rows = the k dimension).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ----------------------------------------------------------------- bf16
constexpr int HQ = 128;            // q rows per block: 2 consumer warpgroups
constexpr int HK = 96;             // keys per K/V tile
constexpr int STAGES = 3;          // K/V ring
constexpr int WG = 128;            // threads per warpgroup
constexpr int HOPPER_THREADS = 2 * WG + 32;   // + one producer warp
constexpr int BOX = 64;            // elements in one 128-byte swizzled row

// Each tile is D / 64 boxes of (rows x 64) bf16 side by side, each box
// 128-byte swizzled as TMA writes it; every box starts on 1024 bytes.
template <int D>
struct Smem {
  alignas(1024) __nv_bfloat16 q[HQ * D];
  alignas(1024) __nv_bfloat16 k[STAGES][HK * D];
  alignas(1024) __nv_bfloat16 v[STAGES][HK * D];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

template <int D>
constexpr int hopper_smem_bytes() {
  return (int)sizeof(Smem<D>) + 1024;   // + room to align the base
}

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

// S = Q K^T of one tile into sc: 64 x HK, D / 16 k-steps, both operands
// K-major as stored.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[HK / 2],
                                        const Smem<D>& sm, int wg,
                                        int stage) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
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

// P as the register A operand: k-step kk covers keys 16 kk .. + 16.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[HK / 16][4],
                                       const float (&sc)[HK / 2]) {
#pragma unroll
  for (int kk = 0; kk < HK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
}

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, int sq, int sk, int h, int kv,
               int causal, int window, float softcap, float scale) {
  constexpr int NB = D / BOX;          // boxes per row
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

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
      issue_s<D>(sc, sm, wg, 0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_any(sc, m, l, alpha, ql, r0, t_begin * HK, t, sk, causal,
                  window, sl2, cap_in, cap_out);
      pack_p(pa, sc);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      mbar_wait(&sm.k_full[s], (i / STAGES) & 1);
      mbar_wait(&sm.v_full[sp], ((i - 1) / STAGES) & 1);
      wgmma_fence();
      fence_regs(sc);
      fence_regs(acc);
      issue_s<D>(sc, sm, wg, s);
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
      pack_p(pa, sc);
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
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow =
            o + (((long)bb * sq + row) * h + hh) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
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
              int sq, int sk, int h, int kv, int causal, int window,
              float softcap, float scale) {
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
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < ON; ++e)
        ob[(long)qi * q_row + tx + 16 * e] = acc[i][e] / denom;
    }
  }
}

// ----------------------------------------------------------------- launch
// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link to libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Rank-4 map over (dh, heads, seq, batch) of a contiguous (batch, seq,
// heads, dh) bf16 tensor; a box is (64, 1, rows, 1), 128-byte swizzled, and
// rows past seq read as zero.
bool tensor_map(CUtensorMap* map, const void* base, int b, int s, int heads,
                int dh, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)s * heads * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int b, int sq, int sk, int h, int kv, int causal,
                        int window, float softcap, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, b, sq, h, D, HQ) ||
      !tensor_map(&tk, k, b, sk, kv, D, HK) ||
      !tensor_map(&tv, v, b, sk, kv, D, HK))
    return cudaErrorInvalidValue;
  const int smem = hopper_smem_bytes<D>();
  static bool configured = false;   // once, so that launches can be captured
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(h, b, (sq + HQ - 1) / HQ);
  flash_fwd_bf16<D><<<grid, HOPPER_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, h, kv, causal,
      window, softcap, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int b, int sq, int sk, int h, int kv, int causal,
                       int window, float softcap, cudaStream_t stream) {
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
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, h, kv,
      causal, window, softcap, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int kv, int dh, int causal, int window,
             float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || sk <= 0 || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  constexpr bool bf16 = sizeof(T) == 2;
  if (dh == 64)
    return (int)(bf16 ? launch_bf16<64>(q, k, v, o, b, sq, sk, h, kv, causal,
                                        window, softcap, s)
                      : launch_f32<64>(q, k, v, o, b, sq, sk, h, kv, causal,
                                       window, softcap, s));
  if (dh == 128)
    return (int)(bf16 ? launch_bf16<128>(q, k, v, o, b, sq, sk, h, kv, causal,
                                         window, softcap, s)
                      : launch_f32<128>(q, k, v, o, b, sq, sk, h, kv, causal,
                                        window, softcap, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int b, int sq, int sk, int h, int kv, int dh,
                        int causal, int window, float softcap, void* stream) {
  return dispatch<float>(q, k, v, o, b, sq, sk, h, kv, dh, causal, window,
                         softcap, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int b, int sq, int sk, int h, int kv, int dh,
                         int causal, int window, float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kv, dh, causal,
                                 window, softcap, stream);
}

}  // extern "C"
