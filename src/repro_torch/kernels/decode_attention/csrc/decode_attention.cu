// Decode attention for Hopper (sm_90a): one query token per (batch, head)
// against a KV cache over the valid prefix, optional window and softcap,
// GQA, fp32 online softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (function decode_attention, body _kernel).  For q (b, h, dh), k/v cache
// (b, S, kv, dh) and lengths (b,) int32 it attends to cache rows
// [max(0, len - window), len) (all of [0, len) without a window); a
// sequence with no visible row gets 0, as the Pallas kernel returns.
//
// What bounds it: the K/V bytes of the valid prefix (at the serving shape,
// b=4, h=32, kv=4, dh=128, bf16, len ~2050-2080: ~17 MB, ~5 us at
// 3.35 TB/s); the arithmetic is ~4 FLOPs per byte.  So the design is about
// bytes in flight and instructions per byte:
//   * one block per (split of the cache, kv head, batch) serves all
//     g = h / kv query heads from each K/V row it loads; the split size is
//     set on the host from S, b x kv and the SM count alone (ops.split_plan:
//     about one wave of blocks, num_sms / (b x kv) splits, 8 of 512 rows
//     each at S 4096, b 4, kv 4 on 132 SMs; there that was faster than
//     128-row splits, since each block's fixed costs and the merge's
//     partials weigh more than the bytes in flight at 17 MB; a smaller
//     batch gets more, shorter splits).  Splits and rows outside
//     [lo, len) are skipped by loop bounds read from the device-side
//     lengths: the host never reads them, so a CUDA graph replays the
//     launch for any lengths;
//   * bf16: K/V tiles of 64 rows are copied into shared memory with
//     cp.async through a ring of 3 stages (rows past the split's end are
//     zero-filled by the copy and masked); two blocks of 104 KB fit on an
//     SM, each with 2 tiles (64 KB) in flight while it works on a third;
//   * bf16: the g heads' dot products run on the tensor cores (mma.sync
//     m16n8k16, bf16 in, fp32 accumulate): S = Q K^T with the heads as M
//     (padded to 16; rows past g are zero and never stored), K fragments
//     by ldmatrix, V fragments by ldmatrix.trans; the score accumulators
//     are the A layout of P V.  Each of the 4 warps takes 16 rows of every
//     tile, so the reduction over dh leaves the shuffle network, and the
//     softmax costs 2 shuffle rounds per row max and 8 exp2f per thread per
//     tile (base 2, log2(e) / sqrt(dh) folded into one scale).  Rows are
//     padded by 16 bytes in shared memory, so every fragment load is free
//     of bank conflicts;
//   * the 4 warps merge through shared memory, and a second small kernel
//     merges the splits that hold rows: partials are dh + 2 floats per
//     (split, head), written only by splits that hold rows.
// fp32 keeps its CUDA-core body (the tolerance of the fp32 path, 3e-5,
// rules out TF32): each warp takes 4 consecutive rows at a time, a lane
// holds dh / 32 contiguous elements of a row, and the 4 x g dot products
// are reduced by warp shuffles side by side.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int N> struct Raw;
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// E contiguous elements of T in one aligned load, widened to fp32.
template <typename T, int E>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[E]) {
  using R = typename Raw<sizeof(T) * E>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = to_f32(vals[e]);
}

// ----------------------------------------------------------------- fp32
template <int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_split_f32(const float* __restrict__ q, const float* __restrict__ kc,
                 const float* __restrict__ vc, const int* __restrict__ lengths,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int h, int kv, int S,
                 int window, float softcap, float scale, int chunk,
                 int nsplit) {
  constexpr int E = D / 32;
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][D];

  const int split = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = h / kv;
  const int len = min(max(lengths[bb], 0), S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s_lo = max(lo, split * chunk);
  const int s_hi = min(len, (split + 1) * chunk);
  if (s_lo >= s_hi) return;        // the merge reads only splits with rows

  const long row = (long)kv * D;
  const float* kb = kc + (long)bb * S * row + (long)kh * D + lane * E;
  const float* vb = vc + (long)bb * S * row + (long)kh * D + lane * E;
  const float* qb = q + ((long)bb * h + (long)kh * g) * D + lane * E;

  // heads j >= g (G is g rounded up to a power of two) get q = 0 and are
  // never stored: computing them keeps every loop free of branches on g,
  // so the G independent dot products and shuffle reductions interleave
  float qr[G][E], m[G], l[G], acc[G][E];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = NEG;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) { qr[j][e] = 0.f; acc[j][e] = 0.f; }
    if (j < g) {
      load_f32<float, E>(qb + (long)j * D, qr[j]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[j][e] *= scale;
    }
  }

  // each warp takes U consecutive rows per step and loads the next step's
  // 2U rows before it works on this one's; it reduces all U x G dot
  // products together and rescales (m, l, acc) once per step
  constexpr int U = G <= 8 ? 4 : 2;
  constexpr int STEP = WARPS * U;
  float kf[U][E], vf[U][E], kn[U][E], vn[U][E];
  auto load_rows = [&](int t0, float (&kd)[U][E], float (&vd)[U][E]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < s_hi) {
        load_f32<float, E>(kb + (long)(t0 + u) * row, kd[u]);
        load_f32<float, E>(vb + (long)(t0 + u) * row, vd[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) { kd[u][e] = 0.f; vd[u][e] = 0.f; }
      }
    }
  };
  load_rows(s_lo + warp * U, kf, vf);
  for (int t0 = s_lo + warp * U; t0 < s_hi; t0 += STEP) {
    load_rows(t0 + STEP, kn, vn);
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[j][e], kf[u][e], x);
        s[u][j] = x;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < G; ++j)
          s[u][j] += __shfl_xor_sync(0xffffffffu, s[u][j], off);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float mx = m[j];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (softcap > 0.f) s[u][j] = tanhf(s[u][j] / softcap) * softcap;
        if (t0 + u < s_hi) mx = fmaxf(mx, s[u][j]);
      }
      const float alpha = expf(m[j] - mx);
      m[j] = mx;
      l[j] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = t0 + u < s_hi ? expf(s[u][j] - mx) : 0.f;
        l[j] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] = fmaf(p, vf[u][e], acc[j][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) { kf[u][e] = kn[u][e]; vf[u][e] = vn[u][e]; }
  }

  // merge the warps of this block
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (lane == 0) { sm_m[warp][j] = m[j]; sm_l[warp][j] = l[j]; }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][j][lane * E + e] = acc[j][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * D; i += THREADS) {
    const int j = i / D, d = i % D;
    float ms = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ms = fmaxf(ms, sm_m[w][j]);
    float ls = 0.f, os = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(sm_m[w][j] - ms);
      ls += sm_l[w][j] * c;
      os += sm_acc[w][j][d] * c;
    }
    const long idx = ((long)bb * h + (long)kh * g + j) * nsplit + split;
    part_acc[idx * D + d] = os;
    if (d == 0) { part_m[idx] = ms; part_l[idx] = ls; }
  }
}

// ----------------------------------------------------------------- bf16
constexpr int TILE = 64;           // cache rows per stage: 16 per warp
constexpr int NST = 3;             // cp.async ring stages

template <int D>
constexpr int tc_smem_bytes() {
  return NST * 2 * TILE * (D + 8) * 2;     // K and V tiles, padded rows
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
decode_split_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc,
                  const int* __restrict__ lengths, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int h, int kv, int S, int window, float softcap,
                  float scale, int chunk, int nsplit) {
  constexpr int LDS = D + 8;       // padded row: fragment loads conflict-free
  constexpr int KS = D / 16;       // k-steps of S = Q K^T
  constexpr int NT = D / 8;        // n-tiles of O
  constexpr int CH = D / 8;        // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int split = blockIdx.x, kh = blockIdx.y, bb = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane >> 2, t = lane & 3;     // mma fragment coordinates
  const int gq = h / kv;
  const int len = min(max(lengths[bb], 0), S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s_lo = max(lo, split * chunk);
  const int s_hi = min(len, (split + 1) * chunk);
  const long head0 = (long)bb * h + (long)kh * gq;   // first head served
  if (s_lo >= s_hi) return;        // the merge reads only splits with rows
  const int n_tiles = (s_hi - s_lo + TILE - 1) / TILE;

  const long row = (long)kv * D;
  const __nv_bfloat16* kb = kc + (long)bb * S * row + (long)kh * D;
  const __nv_bfloat16* vb = vc + (long)bb * S * row + (long)kh * D;
  const __nv_bfloat16* qb = q + head0 * D;

  // rows [s_lo + 64 tile, + 64) of K and V into stage tile % NST; rows at
  // or past s_hi are zero-filled (and masked below)
  auto issue = [&](int tile) {
    __nv_bfloat16* ks = ring + (tile % NST) * 2 * TILE * LDS;
    __nv_bfloat16* vs = ks + TILE * LDS;
    const int r_base = s_lo + tile * TILE;
#pragma unroll
    for (int i = threadIdx.x; i < TILE * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = r_base + r < s_hi;
      const long off = (long)(in ? r_base + r : s_lo) * row + c;
      cp_async16(ks + r * LDS + c, kb + off, in ? 16 : 0);
      cp_async16(vs + r * LDS + c, vb + off, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // Q as the A operand: rows are the heads g8 and g8 + 8 (zero past gq)
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int head = g8 + 8 * (e & 1);
      const int col = kk * 16 + 2 * t + 8 * (e >> 1);
      qa[kk][e] = head < gq ? *reinterpret_cast<const uint32_t*>(
                                  qb + (long)head * D + col)
                            : 0u;
    }

  const float sl2 = scale * LOG2E;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * LOG2E;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + NST - 1 < n_tiles) issue(tile + NST - 1);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();
    const __nv_bfloat16* ks = ring + (tile % NST) * 2 * TILE * LDS;
    const __nv_bfloat16* vs = ks + TILE * LDS;

    // S = Q K^T for this warp's 16 rows, as 2 n-tiles of 8 rows; lane L
    // addresses row (L & 7) of 8x8 matrix L >> 3: (rows 0-7, cols k),
    // (rows 0-7, cols k + 8), (rows 8-15, cols k), (rows 8-15, cols k + 8)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const __nv_bfloat16* kr =
        ks + (16 * warp + (lane >> 4) * 8 + (lane & 7)) * LDS +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, kr + kk * 16);
      mma_bf16(s[0], qa[kk], b[0], b[1]);
      mma_bf16(s[1], qa[kk], b[2], b[3]);
    }

    // online softmax, base 2; element e of n-tile j: head g8 + 8 (e >> 1),
    // cache row r_warp + 8 j + 2 t + (e & 1)
    const int r_warp = s_lo + tile * TILE + 16 * warp;
    const bool ragged = r_warp + 16 > s_hi;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = cap_in > 0.f ? cap_out * tanhf(s[j][e] * cap_in)
                               : s[j][e] * sl2;
        if (ragged && r_warp + 8 * j + 2 * t + (e & 1) >= s_hi) x = -__int_as_float(0x7f800000);
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);   // masked: exp2(-inf) = 0
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A layout of the next product;
    // matrices (rows 0-7, cols n), (rows 8-15, cols n), (rows 0-7,
    // cols n + 8), (rows 8-15, cols n + 8)
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
    const __nv_bfloat16* vr =
        vs + (16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS +
        (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vr + n * 8);
      mma_bf16(acc[n], pa, b[0], b[1]);
      mma_bf16(acc[n + 1], pa, b[2], b[3]);
    }
    __syncthreads();               // the stage is refilled next iteration
  }
  cp_async_wait<0>();

  // merge the warps of this block through shared memory (the ring is free)
  float* red_acc = reinterpret_cast<float*>(smem_raw);   // [WARPS][16][D]
  float* red_m = red_acc + WARPS * 16 * D;               // [WARPS][16]
  float* red_l = red_m + WARPS * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    float* dst = red_acc + (warp * 16 + g8 + 8 * r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    if (t == 0) {
      red_m[warp * 16 + g8 + 8 * r] = m[r];
      red_l[warp * 16 + g8 + 8 * r] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gq * D; i += THREADS) {
    const int j = i / D, d = i % D;
    float ms = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ms = fmaxf(ms, red_m[w * 16 + j]);
    float ls = 0.f, os = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f(red_m[w * 16 + j] - ms);
      ls += red_l[w * 16 + j] * c;
      os += red_acc[(w * 16 + j) * D + d] * c;
    }
    const long idx = (head0 + j) * nsplit + split;
    part_acc[idx * D + d] = os;
    if (d == 0) {
      part_m[idx] = ms / LOG2E;    // natural-log units, as the merge reads
      part_l[idx] = ls;
    }
  }
}


// One block per (head, batch), one thread per output element; it merges
// the splits that hold rows of [lo, len) (no split: the output is 0).  The
// splits' (m, l) are staged in shared memory by one parallel load, and the
// accumulator loads are unrolled so that several are in flight at once.
constexpr int MAX_SPLITS = 1024;

template <typename T>
__global__ void decode_combine(const int* __restrict__ lengths,
                               const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               T* __restrict__ out, int h, int D, int S,
                               int window, int chunk, int nsplit) {
  __shared__ float sm_m[MAX_SPLITS];
  __shared__ float sm_l[MAX_SPLITS];
  const int head = blockIdx.x, bb = blockIdx.y, d = threadIdx.x;
  const int len = min(max(lengths[bb], 0), S);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int first = lo / chunk;
  const int n = (len + chunk - 1) / chunk - first;
  const long base = ((long)bb * h + head) * nsplit + first;
  for (int p = d; p < n; p += blockDim.x) {
    sm_m[p] = part_m[base + p];
    sm_l[p] = part_l[base + p];
  }
  __syncthreads();
  float ms = NEG;
  for (int p = 0; p < n; ++p) ms = fmaxf(ms, sm_m[p]);
  float ls = 0.f, os = 0.f;
#pragma unroll 8
  for (int p = 0; p < n; ++p) {
    const float c = expf(sm_m[p] - ms);
    ls += sm_l[p] * c;
    os += part_acc[(base + p) * D + d] * c;
  }
  out[((long)bb * h + head) * D + d] = from_f32<T>(os / fmaxf(ls, 1e-30f));
}

// The split pass of the bf16 kernel.  Its heads are always padded to the
// 16 rows of the mma M tile, so only the head dim is a template parameter.
template <int D>
cudaError_t split_bf16(dim3 grid, const void* q, const void* k, const void* v,
                       const int* lengths, float* part_m, float* part_l,
                       float* part_acc, int h, int kv, int S, int window,
                       float softcap, int chunk, cudaStream_t stream) {
  const int smem = tc_smem_bytes<D>();
  static bool configured = false;     // once, so that launches can be captured
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  decode_split_bf16<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, part_m, part_l, part_acc,
      h, kv, S, window, softcap, 1.0f / sqrtf((float)D), chunk, grid.x);
  return cudaGetLastError();
}

// The split pass of the fp32 kernel: its shuffle reductions run over G
// heads, padded up to a power of two.
template <int D, int G>
cudaError_t split_f32(dim3 grid, const void* q, const void* k, const void* v,
                      const int* lengths, float* part_m, float* part_l,
                      float* part_acc, int h, int kv, int S, int window,
                      float softcap, int chunk, cudaStream_t stream) {
  decode_split_f32<D, G><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, part_m, part_l, part_acc, h, kv,
      S, window, softcap, 1.0f / sqrtf((float)D), chunk, grid.x);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* out, void* part_m, void* part_l, void* part_acc, int b,
             int h, int kv, int S, int dh, int window, float softcap,
             int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (b <= 0 || S <= 0 || kv <= 0 || chunk <= 0 || h % kv != 0 ||
      h / kv > 16 || (S + chunk - 1) / chunk > MAX_SPLITS ||
      (dh != 64 && dh != 128))
    return (int)cudaErrorInvalidValue;
  const int g = h / kv;
  const dim3 grid((S + chunk - 1) / chunk, kv, b);
  cudaError_t err;
#define DECODE_ARGS grid, q, k, v, lens, pm, pl, pa, h, kv, S, window, \
                    softcap, chunk, s
  if constexpr (sizeof(T) == 2) {
    err = dh == 64 ? split_bf16<64>(DECODE_ARGS) : split_bf16<128>(DECODE_ARGS);
  } else {
#define DECODE_GROUPS(DH)                                                   \
  err = g <= 1   ? split_f32<DH, 1>(DECODE_ARGS)                            \
        : g <= 2 ? split_f32<DH, 2>(DECODE_ARGS)                            \
        : g <= 4 ? split_f32<DH, 4>(DECODE_ARGS)                            \
        : g <= 8 ? split_f32<DH, 8>(DECODE_ARGS)                            \
                 : split_f32<DH, 16>(DECODE_ARGS)
    if (dh == 64) {
      DECODE_GROUPS(64);
    } else {
      DECODE_GROUPS(128);
    }
#undef DECODE_GROUPS
  }
#undef DECODE_ARGS
  if (err != cudaSuccess) return (int)err;
  decode_combine<T><<<dim3(h, b), dh, 0, s>>>(
      lens, pm, pl, pa, static_cast<T*>(out), h, dh, S, window, chunk,
      grid.x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, void* part_m,
                         void* part_l, void* part_acc, int b, int h, int kv,
                         int S, int dh, int window, float softcap, int chunk,
                         void* stream) {
  return dispatch<float>(q, k, v, lengths, out, part_m, part_l, part_acc, b,
                         h, kv, S, dh, window, softcap, chunk, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lengths, void* out, void* part_m,
                          void* part_l, void* part_acc, int b, int h, int kv,
                          int S, int dh, int window, float softcap, int chunk,
                          void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, lengths, out, part_m, part_l,
                                 part_acc, b, h, kv, S, dh, window, softcap,
                                 chunk, stream);
}

}  // extern "C"
