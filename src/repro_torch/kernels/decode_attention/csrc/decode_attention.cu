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
// 3.35 TB/s); the arithmetic is ~4 FLOPs per byte.  The design streams each
// byte once and spreads the stream over the SMs:
//   * one block per (split of the cache, kv head, batch) serves all
//     g = h / kv query heads from each K/V row it loads (the Pallas grid
//     re-streams a kv head's cache once per query head);
//   * the cache axis is split in chunks of `chunk` rows so that b * kv
//     (16 at the serving shape) is not the whole parallelism; splits and
//     rows outside [lo, len) are skipped by loop bounds, read from the
//     device-side lengths (no scalar prefetch);
//   * inside a block each warp takes 4 consecutive rows at a time and
//     loads the next 4 while it works on these; a lane holds dh / 32
//     contiguous elements of a row (one 8- or 16-byte load), the 4 x g dot
//     products are reduced by warp shuffles side by side (g is a template
//     parameter, so nothing branches on it), and (m, l, acc) stay in
//     registers, rescaled once per 4 rows;
//   * the 4 warps merge through shared memory, and a second small kernel
//     merges the splits that hold rows: partials are dh + 2 floats per
//     (split, head), written only by splits that hold rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, const int* __restrict__ lengths,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int h, int kv, int S, int window,
             float softcap, float scale, int chunk, int nsplit) {
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
  const T* kb = kc + (long)bb * S * row + (long)kh * D + lane * E;
  const T* vb = vc + (long)bb * S * row + (long)kh * D + lane * E;
  const T* qb = q + ((long)bb * h + (long)kh * g) * D + lane * E;

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
      load_f32<T, E>(qb + (long)j * D, qr[j]);
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
        load_f32<T, E>(kb + (long)(t0 + u) * row, kd[u]);
        load_f32<T, E>(vb + (long)(t0 + u) * row, vd[u]);
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

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* part_m,
                   float* part_l, float* part_acc, int b, int h, int kv,
                   int S, int window, float softcap, int chunk,
                   cudaStream_t stream) {
  const int nsplit = (S + chunk - 1) / chunk;
  decode_split<T, D, G><<<dim3(nsplit, kv, b), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_m, part_l, part_acc, h, kv, S,
      window, softcap, 1.0f / sqrtf((float)D), chunk, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<dim3(h, b), D, 0, stream>>>(
      lengths, part_m, part_l, part_acc, static_cast<T*>(out), h, D, S,
      window, chunk, nsplit);
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
      (S + chunk - 1) / chunk > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int g = h / kv;
#define DECODE_LAUNCH(DH, GG)                                                 \
  return (int)launch<T, DH, GG>(q, k, v, lens, out, pm, pl, pa, b, h, kv, S, \
                                window, softcap, chunk, s)
#define DECODE_GROUPS(DH)                 \
  if (g <= 1) DECODE_LAUNCH(DH, 1);       \
  if (g <= 2) DECODE_LAUNCH(DH, 2);       \
  if (g <= 4) DECODE_LAUNCH(DH, 4);       \
  if (g <= 8) DECODE_LAUNCH(DH, 8);       \
  if (g <= 16) DECODE_LAUNCH(DH, 16)
  if (dh == 64) {
    DECODE_GROUPS(64);
  } else if (dh == 128) {
    DECODE_GROUPS(128);
  }
#undef DECODE_GROUPS
#undef DECODE_LAUNCH
  return (int)cudaErrorInvalidValue;
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
