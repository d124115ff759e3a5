// SSD (Mamba-2 state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py (function
// ssd_chunk_scan, body _kernel).  For x (b, s, h, p), dt (b, s, h) fp32,
// A (h,) fp32 and B/C (b, s, g, n), with head hh reading group
// hh / (h / g), it walks the sequence in chunks of Q rows and per chunk
// computes, with cum the prefix sum of dt * A over the chunk:
//   intra:  y  = ((C B^T) o L) (dt * x),   L[q][k] = exp(cum_q - cum_k), k <= q
//   inter:  y += (C o exp(cum)) S_prev
//   state:  S  = S_prev * exp(cum_last) + B^T ((dt * x) o exp(cum_last - cum))
// and writes y (in x's dtype) and the final state S (b, h, n, p) fp32.
// The state starts at 0, as the Pallas kernel's does.
//
// What bounds it: at the mamba2-2.7b serving shape (b 4, s 2048, h 80,
// p 64, g 1, n 128, Q 256, bf16 x/B/C) the least work is ~4.4e10 FLOPs
// against ~185 MB of traffic, so the card's bound is its memory (~0.055 ms).
// This first version does the products in fp32 on the CUDA cores, ~6e10
// FMA-FLOPs at that shape, so it is bound by its arithmetic and shared-
// memory reads, tens of times above the bound; tensor cores are the next
// step.  What the design does:
//   * one block per (head, batch) walks the chunks in order; the chunk
//     axis of the Pallas grid becomes a loop and the carried state S
//     (n x p fp32) lives in shared memory for the whole sequence;
//   * x, B and C are read in place through their batch and sequence
//     strides (the model passes slices of one convolution output), with
//     no head-major transposes: those existed for TPU block addressing;
//   * each chunk is cut into tiles of T rows (64, or 32 / 16 where shared
//     memory or a short chunk ask for it), so the footprint does not grow
//     with Q: for each q tile, the inter term, then the intra term against
//     every k tile at or before it; the k tile on the diagonal also adds
//     its share to the new state, kept apart from S_prev until the chunk
//     ends (the inter term of later q tiles still needs S_prev);
//   * the decay exponents are sums of dt * A over the rows between k and
//     q, never differences of two prefix sums: deep in a 256-row chunk
//     |cum| reaches hundreds, and cum_q - cum_k then carries an absolute
//     error of a few ulp of |cum| however close q and k are, which kept y
//     at the serving shape outside 5e-4 of the sequential recurrence in
//     fp32.  Each exponent is built from nonpositive pieces (a running
//     sum down each column of the diagonal tile; for other tiles a
//     within-tile prefix of q, the whole tiles between and a within-tile
//     suffix of k), and a sum of terms of one sign is exact to a few ulp
//     of itself;
//   * exp(...) is evaluated only where k <= q, so a large dt * A can never
//     give inf * 0;
//   * products are 4 x 4 register tiles per thread reading 16-byte rows of
//     shared memory; leading dims are padded so that 8 rows read together
//     hit distinct banks; n and p are padded to multiples of 4 with zeros,
//     so head_dim 1 (jamba's mode) and odd groupings need no second path;
//     rows past the end of a ragged chunk are loaded as zero and never
//     stored.
// bf16 <-> fp32 only through the __bfloat162float / __float2bfloat16
// family.  Shared memory above 48 KB is enabled with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;   // bytes a block may opt into on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) / 4 * 4; }
// a multiple of 4 whose quarter is odd (see the header)
__host__ __device__ __forceinline__ int ld_odd(int v) { return ((v / 4) & 1) ? v : v + 4; }

struct Shape {
  int S, H, P, G, N;          // sequence, heads, head_dim, groups, d_state
  int Q, nc;                  // chunk length and count
  int T, NP, PP, QT;          // tile rows; n, p padded to 4; Q padded to T
  int ldn, ldt;               // leading dims of the C/B tiles, the scores
  long long xsb, xst, bsb, bst, csb, cst;   // batch / sequence strides
};

// Offsets (in floats) of the shared arrays; ops.py::smem_bytes mirrors it.
struct Layout {
  int cs, bs, xs, ys, ss, st, sn, dts, loc, rloc, ecum, wts, tiles, total;
};

__host__ __device__ inline Layout layout(const Shape& d) {
  Layout l;
  int o = 0;
  l.cs = o;   o += d.T * d.ldn;      // C rows of the q tile
  l.bs = o;   o += d.T * d.ldn;      // B rows of the k tile
  l.xs = o;   o += d.T * d.PP;       // dt * x rows of the k tile
  l.ys = o;   o += d.T * d.PP;       // y rows of the q tile
  l.ss = o;   o += d.T * d.ldt;      // masked, decayed scores (q x k)
  l.st = o;   o += d.NP * d.PP;      // S_prev
  l.sn = o;   o += d.NP * d.PP;      // this chunk's share of the new state
  l.dts = o;  o += d.QT;             // dt of the chunk
  l.loc = o;  o += d.QT;             // dt * A summed from the tile's start to t
  l.rloc = o; o += d.QT;             // dt * A summed after t to the tile's end
  l.ecum = o; o += d.QT;             // exp(dt * A summed from the chunk's start)
  l.wts = o;  o += d.QT;             // exp(dt * A summed after t), 0 past Q
  l.tiles = o; o += 4 * (d.QT / d.T);  // per tile: sum, sum before, sum after;
                                       // then the chunk's sum
  l.total = o;
  return l;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The chunk's decay sums (all <= 0): per row t, loc[t] (the tile's rows
// up to t) and rloc[t] (the tile's rows after t); per tile m, tot[m], the
// sums of the tiles before it (pre) and after it (suf); and the chunk's
// sum.  One thread per tile, then one thread over the tiles.
__device__ void decay_sums(const float* dts, float* loc, float* rloc,
                           float* tiles, float a, const Shape& d, int tid) {
  const int nT = d.QT / d.T;
  float* tot = tiles;
  float* pre = tiles + nT;
  float* suf = tiles + 2 * nT;
  for (int m = tid; m < nT; m += THREADS) {
    const int lo = m * d.T;
    float run = 0.f;
    for (int t = 0; t < d.T; ++t) {
      run += dts[lo + t] * a;
      loc[lo + t] = run;
    }
    tot[m] = run;
    run = 0.f;
    for (int t = d.T - 1; t >= 0; --t) {
      rloc[lo + t] = run;
      run += dts[lo + t] * a;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int m = 0; m < nT; ++m) {
      pre[m] = run;
      run += tot[m];
    }
    tiles[3 * nT] = run;
    run = 0.f;
    for (int m = nT - 1; m >= 0; --m) {
      suf[m] = run;
      run += tot[m];
    }
  }
}

// Rows [row0, row0 + rows) of a (., n) operand of type TI into a T x ld
// fp32 tile, scaled by scale[r] when given; zero past rows and past n.
template <typename TI>
__device__ void load_tile(float* dst, int ld, int width, const TI* src,
                          long long stride, int row0, int rows, int n,
                          const float* scale, int T, int tid) {
  for (int i = tid; i < T * width; i += THREADS) {
    const int r = i / width, c = i - r * width;
    float v = 0.f;
    if (r < rows && c < n) {
      v = to_f32(src[(long long)(row0 + r) * stride + c]);
      if (scale) v *= scale[r];
    }
    dst[r * ld + c] = v;
  }
}

// Ss[q][k] = decay(q, k) * sum_n Cs[q][n] Bs[k][n] where k <= q, else 0.
// On the diagonal tile Ss already holds the decays (diagonal_decay); off
// it, decay = exp(loc_q + mid + rloc_k), mid the sum of the tiles between.
// Both operands hold n contiguous; a thread owns rows qi + G*r and columns
// ki + G*c (r, c < 4), so the 8 threads of a 16-byte read phase take 8
// consecutive B rows.
__device__ void scores(const float* Cs, const float* Bs, float* Ss,
                       const float* loc, const float* rloc, float mid,
                       bool diagonal, const Shape& d, int q0, int k0,
                       int tid) {
  const int G = d.T / 4;
  for (int e = tid; e < G * G; e += THREADS) {
    const int qi = e / G, ki = e - qi * G;
    float acc[4][4] = {};
    for (int n = 0; n < d.NP; n += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(Cs + (qi + G * r) * d.ldn + n);
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ld4(Bs + (ki + G * c) * d.ldn + n);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = acc[r][c];
          s = fmaf(a[r].x, b[c].x, s);
          s = fmaf(a[r].y, b[c].y, s);
          s = fmaf(a[r].z, b[c].z, s);
          s = fmaf(a[r].w, b[c].w, s);
          acc[r][c] = s;
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = qi + G * r, qg = q0 + q;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = ki + G * c, kg = k0 + k;
        float v = 0.f;
        if (diagonal) {
          if (k <= q) v = acc[r][c] * Ss[q * d.ldt + k];
        } else {
          v = acc[r][c] * expf(loc[qg] + mid + rloc[kg]);
        }
        Ss[q * d.ldt + k] = v;
      }
    }
  }
}

// Ss[q][k] = exp(dt * A summed over rows k+1 .. q) for k <= q on the
// diagonal tile starting at row q0: one thread per column, a running sum
// down it.
__device__ void diagonal_decay(const float* dts, float a, float* Ss,
                               const Shape& d, int q0, int tid) {
  for (int k = tid; k < d.T; k += THREADS) {
    float run = 0.f;
    Ss[k * d.ldt + k] = 1.f;
    for (int q = k + 1; q < d.T; ++q) {
      run += dts[q0 + q] * a;
      Ss[q * d.ldt + k] = expf(run);
    }
  }
}

// out[q][p] (+)= rowscale[q] * sum_k Am[q][k] Bk[k][p], q < T, p < PP:
// Am holds k contiguous (rows strided per thread), Bk holds p contiguous
// (a thread owns 4 consecutive p).
__device__ void mm_rows(const float* Am, int lda, const float* Bk, int ldb,
                        int K, float* out, int ldo, const float* rowscale,
                        bool accumulate, const Shape& d, int tid) {
  const int RG = d.T / 4, CG = d.PP / 4;
  for (int e = tid; e < RG * CG; e += THREADS) {
    const int qi = e / CG, pi = e - qi * CG;
    float acc[4][4] = {};
    for (int k = 0; k < K; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(Am + (qi + RG * r) * lda + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) b[kk] = ld4(Bk + (k + kk) * ldb + pi * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float av[4] = {a[r].x, a[r].y, a[r].z, a[r].w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[r][0] = fmaf(av[kk], b[kk].x, acc[r][0]);
          acc[r][1] = fmaf(av[kk], b[kk].y, acc[r][1]);
          acc[r][2] = fmaf(av[kk], b[kk].z, acc[r][2]);
          acc[r][3] = fmaf(av[kk], b[kk].w, acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = qi + RG * r;
      const float s = rowscale ? rowscale[q] : 1.f;
      float* o = out + q * ldo + pi * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = (accumulate ? o[c] : 0.f) + acc[r][c] * s;
    }
  }
}

// Sn[n][p] += sum_k w[k] Bs[k][n] Xs[k][p], n < NP, p < PP: both operands
// hold their output index contiguous; a thread owns a 4 x 4 block.
__device__ void state_update(const float* Bs, const float* Xs, const float* w,
                             float* Sn, const Shape& d, int tid) {
  const int CG = d.PP / 4, RG = d.NP / 4;
  for (int e = tid; e < RG * CG; e += THREADS) {
    const int ni = e / CG, pi = e - ni * CG;
    float acc[4][4] = {};
    for (int k = 0; k < d.T; ++k) {
      const float wk = w[k];
      const float4 a = ld4(Bs + k * d.ldn + ni * 4);
      const float4 b = ld4(Xs + k * d.PP + pi * 4);
      const float av[4] = {a.x * wk, a.y * wk, a.z * wk, a.w * wk};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(av[r], b.x, acc[r][0]);
        acc[r][1] = fmaf(av[r], b.y, acc[r][1]);
        acc[r][2] = fmaf(av[r], b.z, acc[r][2]);
        acc[r][3] = fmaf(av[r], b.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* o = Sn + (ni * 4 + r) * d.PP + pi * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] += acc[r][c];
    }
  }
}

template <typename TI>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan_kernel(const TI* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const TI* __restrict__ Bm,
                      const TI* __restrict__ Cm, TI* __restrict__ y,
                      float* __restrict__ state_out, Shape d) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = layout(d);
  float* Cs = smem + l.cs;
  float* Bs = smem + l.bs;
  float* Xs = smem + l.xs;
  float* Ys = smem + l.ys;
  float* Ss = smem + l.ss;
  float* St = smem + l.st;
  float* Sn = smem + l.sn;
  float* dts = smem + l.dts;
  float* loc = smem + l.loc;
  float* rloc = smem + l.rloc;
  float* ecum = smem + l.ecum;
  float* wts = smem + l.wts;
  float* tiles = smem + l.tiles;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int grp = h / (d.H / d.G);
  const float a = A[h];
  const TI* xb = x + b * d.xsb + (long long)h * d.P;
  const TI* Bb = Bm + b * d.bsb + (long long)grp * d.N;
  const TI* Cb = Cm + b * d.csb + (long long)grp * d.N;
  const float* dtb = dt + (long long)b * d.S * d.H + h;
  TI* yb = y + ((long long)b * d.S * d.H + h) * d.P;
  const long long yst = (long long)d.H * d.P;
  const int nT = d.QT / d.T;

  for (int i = tid; i < d.NP * d.PP; i += THREADS) St[i] = 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const int t0 = c * d.Q;
    for (int t = tid; t < d.QT; t += THREADS)
      dts[t] = t < d.Q ? dtb[(long long)(t0 + t) * d.H] : 0.f;
    for (int i = tid; i < d.NP * d.PP; i += THREADS) Sn[i] = 0.f;
    __syncthreads();
    decay_sums(dts, loc, rloc, tiles, a, d, tid);
    __syncthreads();
    const float* tot = tiles;
    const float total = tiles[3 * nT];
    for (int t = tid; t < d.QT; t += THREADS) {
      const int m = t / d.T;
      ecum[t] = expf(tiles[nT + m] + loc[t]);
      wts[t] = t < d.Q ? expf(rloc[t] + tiles[2 * nT + m]) : 0.f;
    }
    for (int i = 0; i < nT; ++i) {
      const int q0 = i * d.T;
      load_tile(Cs, d.ldn, d.NP, Cb, d.cst, t0 + q0, min(d.T, d.Q - q0), d.N,
                (const float*)nullptr, d.T, tid);
      __syncthreads();
      if (c == 0) {
        for (int e = tid; e < d.T * d.PP; e += THREADS) Ys[e] = 0.f;
      } else {
        mm_rows(Cs, d.ldn, St, d.PP, d.NP, Ys, d.PP, ecum + q0, false, d, tid);
      }
      for (int j = 0; j <= i; ++j) {
        const int k0 = j * d.T, rows = min(d.T, d.Q - k0);
        load_tile(Bs, d.ldn, d.NP, Bb, d.bst, t0 + k0, rows, d.N,
                  (const float*)nullptr, d.T, tid);
        load_tile(Xs, d.PP, d.PP, xb, d.xst, t0 + k0, rows, d.P, dts + k0,
                  d.T, tid);
        if (j == i) diagonal_decay(dts, a, Ss, d, q0, tid);
        float mid = 0.f;
        for (int m = j + 1; m < i; ++m) mid += tot[m];
        __syncthreads();
        scores(Cs, Bs, Ss, loc, rloc, mid, j == i, d, q0, k0, tid);
        __syncthreads();
        mm_rows(Ss, d.ldt, Xs, d.PP, d.T, Ys, d.PP, nullptr, true, d, tid);
        if (j == i) state_update(Bs, Xs, wts + k0, Sn, d, tid);
        __syncthreads();
      }
      const int rows = min(d.T, d.Q - q0);
      for (int e = tid; e < rows * d.P; e += THREADS) {
        const int r = e / d.P, p = e - r * d.P;
        yb[(long long)(t0 + q0 + r) * yst + p] = from_f32<TI>(Ys[r * d.PP + p]);
      }
      __syncthreads();
    }
    const float decay = expf(total);
    for (int i = tid; i < d.NP * d.PP; i += THREADS) St[i] = St[i] * decay + Sn[i];
    __syncthreads();
  }
  float* so = state_out + ((long long)b * d.H + h) * d.N * d.P;
  for (int e = tid; e < d.N * d.P; e += THREADS) {
    const int n = e / d.P, p = e - n * d.P;
    so[e] = St[n * d.PP + p];
  }
}

template <typename TI>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* state, int b, int s, int h, int p,
           int g, int n, int q, int tile, long long xsb, long long xst,
           long long bsb, long long bst, long long csb, long long cst,
           void* stream) {
  if (b <= 0 || b > 65535 || s <= 0 || h <= 0 || p <= 0 || g <= 0 || n <= 0 ||
      h % g != 0 || q <= 0 || s % q != 0 || (tile != 64 && tile != 32 && tile != 16))
    return (int)cudaErrorInvalidValue;
  Shape d;
  d.S = s; d.H = h; d.P = p; d.G = g; d.N = n;
  d.Q = q; d.nc = s / q;
  d.T = tile; d.NP = round4(n); d.PP = round4(p);
  d.QT = (q + tile - 1) / tile * tile;
  d.ldn = ld_odd(d.NP); d.ldt = ld_odd(tile);
  d.xsb = xsb; d.xst = xst; d.bsb = bsb; d.bst = bst; d.csb = csb; d.cst = cst;
  const size_t bytes = (size_t)layout(d).total * sizeof(float);
  if (bytes > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool configured = false;   // once, so that launches can be captured
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_scan_kernel<TI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  ssd_chunk_scan_kernel<TI><<<dim3(h, b), THREADS, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TI*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TI*>(B),
      static_cast<const TI*>(C), static_cast<TI*>(y),
      static_cast<float*>(state), d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ssd_chunk_scan_f32(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* state,
                       int b, int s, int h, int p, int g, int n, int q,
                       int tile, long long xsb, long long xst, long long bsb,
                       long long bst, long long csb, long long cst,
                       void* stream) {
  return launch<float>(x, dt, A, B, C, y, state, b, s, h, p, g, n, q, tile,
                       xsb, xst, bsb, bst, csb, cst, stream);
}

int ssd_chunk_scan_bf16(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, void* y, void* state,
                        int b, int s, int h, int p, int g, int n, int q,
                        int tile, long long xsb, long long xst, long long bsb,
                        long long bst, long long csb, long long cst,
                        void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, y, state, b, s, h, p, g, n, q,
                               tile, xsb, xst, bsb, bst, csb, cst, stream);
}

}  // extern "C"
