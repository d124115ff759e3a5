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
// tensor-core peak, against ~0.3 GB of traffic (0.09 ms): compute-bound.
// This first kernel is simple rather than fast: fp32 math on the CUDA
// cores for both entries (bf16 is converted on load), and S and dP are
// recomputed in each of the two kernels (seven products instead of five),
// so it runs far from that bound; tensor cores are later work.
//
// Design (three launches per call, each deterministic, no atomics):
//   * delta: D = rowsum(dO o O) per (b, h, q row), one warp a row;
//   * dK / dV: one block per (key tile of 64, kv head, batch), heaviest
//     causal tiles first.  K and V of the tile stay in shared memory and
//     dK, dV in registers while the block walks the g query heads of its
//     kv head and, for each, the q tiles that can see the key tile: the
//     GQA sum over the group needs no atomics.  Per q tile: S = Q K^T and
//     dP = dO V^T (4 x 4 values a thread), P = exp(logit - lse) where
//     visible, dS = P (dP - D) (times 1 - tanh^2 under a softcap, and the
//     1 / sqrt(dh) scale), both through shared memory; then dV += P^T dO
//     and dK += dS^T Q;
//   * dQ: one block per (q tile of 64, head, batch); Q, dO, lse and D stay
//     put while the block walks the key tiles the q tile can see,
//     recomputing S, dP and dS, and dQ += dS K in registers.
// Masked pairs get P = 0 by an explicit visibility test, never through the
// value of lse, so rows that see no key (lse +inf) and rows past sq give
// zero gradients, not NaN.  Shared memory at dh 128: four 64 x 129 fp32
// tiles + two 64 x 65 = 166 KB (dK / dV), 149 KB (dQ): one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

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
      // dV += P^T dO, dK += dS^T Q: this thread's keys are ty RN + i
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
            acc_v[i][e] = fmaf(pp[i], o[e], acc_v[i][e]);
            acc_k[i][e] = fmaf(dd[i], qq[e], acc_k[i][e]);
          }
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* dk,
                   void* dv, void* delta, int b, int sq, int sk, int h,
                   int kv, int causal, int window, float softcap,
                   cudaStream_t stream) {
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

  const long rows = (long)b * sq * h;
  const int warps_per_block = THREADS / 32;
  bwd_delta<T><<<(unsigned)((rows + warps_per_block - 1) / warps_per_block),
                 THREADS, 0, stream>>>(static_cast<const T*>(o), tdo, td,
                                       rows, sq, h, D);
  cudaError_t err = cudaGetLastError();
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

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dq, void* dk, void* dv,
             void* delta, int b, int sq, int sk, int h, int kv, int dh,
             int causal, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || sk <= 0 || kv <= 0 || h % kv != 0)
    return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return (int)launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, b, sq,
                              sk, h, kv, causal, window, softcap, s);
  if (dh == 128)
    return (int)launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, b,
                               sq, sk, h, kv, causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
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
                         h, kv, dh, causal, window, softcap, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* dq, void* dk, void* dv, void* delta, int b,
                             int sq, int sk, int h, int kv, int dh,
                             int causal, int window, float softcap,
                             void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, b,
                                 sq, sk, h, kv, dh, causal, window, softcap,
                                 stream);
}

}  // extern "C"
