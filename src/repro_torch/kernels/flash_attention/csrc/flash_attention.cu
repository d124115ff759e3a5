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
// tensor-core peak).  What the design does about it:
//   * one block per (q tile of 64 rows, q head, batch); the Pallas grid's
//     sequential k axis becomes a loop inside the block over the k tiles
//     that causal / window visibility leaves (loop bounds replace pl.when);
//     scores never reach device memory, each output element is written
//     once, q once and k/v once per q tile;
//   * bf16 (the serving path): the two products run on the tensor cores
//     with mma.sync m16n8k16 (bf16 in, fp32 accumulate).  Four warps each
//     own 16 q rows; Q fragments stay in registers for the whole k loop,
//     K fragments are read from shared memory, V fragments through
//     ldmatrix.trans, and the probabilities go from the score accumulators
//     straight into the A fragments of the second product (rounded to
//     bf16, as the value side is).  Shared-memory rows are padded by 16
//     bytes so the fragment reads hit distinct banks.  Loads are plain
//     16-byte loads with no copy/compute overlap yet (cp.async or TMA with
//     a ring of stages is the next step, then wgmma);
//   * fp32: the same tiling on the CUDA cores (fp32 FMA; the tolerance of
//     the fp32 path, 3e-5, rules out TF32), each thread holding a 4 x 4
//     tile of scores and a 4 x dh/16 tile of the output.
// Ragged tails: k rows past sk are masked in the scores AND loaded as zero
// (so 0 * garbage can never poison the accumulator); q rows past sq are
// loaded as zero and never stored.  bf16 <-> fp32 only through the
// __bfloat162float / __float2bfloat16 family.  Shared memory above 48 KB is
// enabled with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per tile
constexpr float NEG = -1e30f;

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

// The k tiles some row of the q tile [q0, q0 + BQ) can see: causal
// positions start at 0 for both q and k.
__device__ __forceinline__ void k_tiles(int q0, int sk, int causal, int window,
                                        int* t_begin, int* t_end) {
  int k_begin = 0, k_end = sk;
  if (causal) {
    k_end = min(sk, q0 + BQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  *t_begin = k_begin / BK;
  *t_end = (k_end + BK - 1) / BK;
}

// ----------------------------------------------------------------- bf16
constexpr int MMA_THREADS = 128;   // 4 warps x 16 q rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + 64) of a (rows, D) bf16 matrix with row stride `stride`
// elements into shared memory (row stride LDS); rows past `n` become zero.
template <int D, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, long stride,
                                          int r0, int n) {
  constexpr int CHUNKS = D / 8;    // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += MMA_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

template <int D>
constexpr int mma_smem_bytes() {
  return 3 * 64 * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int sq, int sk, int h, int kv,
               int causal, int window, float softcap, float scale) {
  constexpr int LDS = D + 8;       // padded row: fragment reads conflict-free
  constexpr int KS = D / 16;       // k-steps of the score product
  constexpr int NT = D / 8;        // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + 64 * LDS;
  __nv_bfloat16* vs = ks + 64 * LDS;

  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / (h / kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const long q_row = (long)h * D, k_row = (long)kv * D;
  const __nv_bfloat16* qb = q + (long)bb * sq * q_row + (long)hh * D;
  const __nv_bfloat16* kb = k + (long)bb * sk * k_row + (long)kh * D;
  const __nv_bfloat16* vb = v + (long)bb * sk * k_row + (long)kh * D;
  __nv_bfloat16* ob = o + (long)bb * sq * q_row + (long)hh * D;

  load_tile<D, LDS>(qs, qb, q_row, q0, sq);
  __syncthreads();
  const int r0 = warp * 16 + g;            // this thread's rows: r0, r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qf[kk][0] = lds32(qs + r0 * LDS + kk * 16 + 2 * t);
    qf[kk][1] = lds32(qs + (r0 + 8) * LDS + kk * 16 + 2 * t);
    qf[kk][2] = lds32(qs + r0 * LDS + kk * 16 + 2 * t + 8);
    qf[kk][3] = lds32(qs + (r0 + 8) * LDS + kk * 16 + 2 * t + 8);
  }
  const int qi[2] = {q0 + r0, q0 + r0 + 8};
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int t_begin, t_end;
  k_tiles(q0, sk, causal, window, &t_begin, &t_end);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();               // previous tile's ks / vs consumed
    load_tile<D, LDS>(ks, kb, k_row, k0, sk);
    load_tile<D, LDS>(vs, vb, k_row, k0, sk);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(s[j], qf[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }

    // online softmax; element e of n-tile j: row qi[e >> 1],
    // key k0 + 8 j + 2 t + (e & 1)
    uint32_t ok = 0;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[j][e] = x;
        if (visible(qi[e >> 1], k0 + 8 * j + 2 * t + (e & 1), sk, causal,
                    window)) {
          ok |= 1u << (4 * j + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok >> (4 * j + e)) & 1u ? expf(s[j][e] - m[e >> 1])
                                                  : 0.f;
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A layout of the next product
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {           // 16 keys per step
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // lane L addresses row (L & 7) of 8x8 matrix L >> 3: matrices are
      // (keys 0-7, cols n), (keys 8-15, cols n), (keys 0-7, cols n + 8),
      // (keys 8-15, cols n + 8)
      const __nv_bfloat16* vr =
          vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS +
          (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + n * 8);
        mma_bf16(acc[n], pa, b[0], b[1]);
        mma_bf16(acc[n + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] < sq) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = ob + (long)qi[r] * q_row + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat162 val = __floats2bfloat162_rn(
            acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = val;
      }
    }
  }
}

// ----------------------------------------------------------------- fp32
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
  k_tiles(q0, sk, causal, window, &t_begin, &t_end);
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
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int h, int kv, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t err = cudaSuccess;
  if constexpr (sizeof(T) == 2) {
    const int smem = mma_smem_bytes<D>();
    static bool configured = false;   // once, so that launches can be captured
    if (!configured) {
      err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    flash_fwd_bf16<D><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        sq, sk, h, kv, causal, window, softcap, scale);
  } else {
    const int smem = simt_smem_bytes<D>();
    static bool configured = false;
    if (!configured) {
      err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    flash_fwd_f32<D><<<grid, SIMT_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, h, kv,
        causal, window, softcap, scale);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int kv, int dh, int causal, int window,
             float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || sk <= 0 || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)launch<T, 64>(q, k, v, o, b, sq, sk, h, kv, causal, window, softcap, s);
  if (dh == 128)
    return (int)launch<T, 128>(q, k, v, o, b, sq, sk, h, kv, causal, window, softcap, s);
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
