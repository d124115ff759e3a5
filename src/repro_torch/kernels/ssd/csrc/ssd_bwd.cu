// SSD (Mamba-2 state-space duality) chunk-scan backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates the chunked XLA path
// of src/repro/models/ssm.py (ssd_forward, lines 95-166) through XLA.  The
// port pairs its forward kernels (ssd.cu) with this hand-written backward
// behind an autograd.Function (ops.py::SSDChunkScanFn), as it does for
// flash attention.  For x (b, s, h, p), dt (b, s, h) fp32, A (h,) fp32,
// B/C (b, s, g, n), an optional initial state (b, h, n, p) fp32, the output
// gradient dy (b, s, h, p) and an optional final-state gradient dstate
// (b, h, n, p) fp32, with head hh reading group hh / (h / g), it writes dx,
// ddt, dA, dB, dC (dB, dC summed over each group's heads) and dinit.
//
// Per chunk of Q rows, with x' = dt x, cum the prefix sum of dt A over the
// chunk (inclusive), after_k the sum after row k, total the chunk's sum,
// L[q][k] = exp(cum_q - cum_k) for k <= q, S_prev the state entering the
// chunk and dS the gradient of the state leaving it:
//   dx'_k = Σ_q L (C_q . B_k) dy_q     + exp(after_k) B_k^T dS
//   dB_k  = Σ_q L (dy_q . x'_k) C_q    + exp(after_k) dS x'_k
//   dC_q  = Σ_k L (dy_q . x'_k) B_k    + exp(cum_q) S_prev dy_q
//   dx = dt dx',  ddt = x . dx' + A d(dt A),  dA = Σ dt d(dt A),
//   d(dt A)_t = <S_out, dS> + Σ_{u >= t in the chunk} (C_u . dC_u - x'_u . dx'_u)
// (per head; the last line is the reversed cumsum of d cum, whose last row
// also carries d total = <S_out, dS>).  kernels/ssd/ref.py::ssd_bwd_ref
// writes the same four stages out in plain PyTorch.
//
// Four kernels, each instantiated for fp32 and bf16 x/B/C/dy; all
// arithmetic is fp32 on the CUDA cores (a first design, as the forward's
// first port was):
//   1. ssd_bwd_states, one block per (head, batch): walks the chunks
//      forward from init, writing the state entering each chunk (recomputed,
//      not kept by the forward), then backward from dstate, writing the
//      gradient of the state leaving each chunk, dS_{c-1} = exp(total_c) dS_c
//      + Σ_q exp(cum_q) C_q ⊗ dy_q, and <S_out_c, dS_c>; what is left is
//      dinit.  Both products are n x p sums over the chunk's rows.
//   2. ssd_bwd_keys, one block per (key tile of T rows, tile of heads of one
//      group, chunk, batch): for each head, the state terms, then against
//      every q tile at or after its own, the scores C B^T and dy x'^T times
//      their decays; dx' and dB; it writes dx, x . dx' (ddt's direct part)
//      and -x' . dx' (d cum's key part), and dB summed over its heads;
//   3. ssd_bwd_queries, one block per (query tile, head tile, chunk, batch):
//      for each head, the inter term, then against every key tile at or
//      before its own; it adds C . dC (d cum's query part) and writes dC
//      summed over its heads;
//   4. ssd_bwd_finish: a block per head walks each (batch, chunk)'s rows in
//      reverse, ddt += A d(dt A), and sums dA in a fixed order; further
//      blocks sum the head tiles' dB and dC partials.  No float atomics:
//      every sum has one order, so the gradients repeat bit for bit.
//
// What bounds it: at mamba2-2.7b's train shape (b 4, s 2048, h 80, p 64,
// g 1, n 128, Q 256, bf16) the least work is ~1.2e11 FLOPs (the causal
// halves of the chunk products) against ~265 MB of traffic, so the card's
// bound is its tensor cores (~0.12 ms).  This design runs every product on
// the CUDA cores in fp32 from shared memory (4 x 4 register tiles, ~2 FMAs
// per float loaded), recomputes C B^T and dy x'^T per head and per pass,
// and runs one block to an SM: it is far above that bound (PERF.md).
//
// Decay precision: every exponent is a sum of one sign, as in ssd.cu: for
// a key tile before the q tile, loc_q + (the tiles between) + rloc_k;
// inside the diagonal tile a running sum down each column; exp(cum_q) a
// prefix and exp(after_k) a suffix.
//
// Inputs x, B and C are read through their batch and sequence strides
// (the model passes slices of one convolution output); dy, the outputs and
// the scratch are dense.  Rows past the chunk, n past d_state and p past
// head_dim are zero in shared memory.  Padded rows (dt = 0, x = B = C = 0,
// dy = 0) give dx = dB = dC = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 232448;   // bytes a block may opt into on sm_90
constexpr unsigned FULL = 0xffffffffu;
typedef __nv_bfloat16 bf16;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) / 4 * 4; }
// a multiple of 4 whose quarter is odd: 16-byte reads of 8 consecutive rows
// hit distinct banks
__host__ __device__ __forceinline__ int ld_odd(int v) { return ((v / 4) & 1) ? v : v + 4; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

struct Dims {
  int S, H, P, G, N, Q, nc;
  int T, NP, PP, QT, nT;      // tile rows; n, p padded to 4; Q padded to T; tiles
  int ldn, ldp, ldt;          // leading dims of n-wide and p-wide tiles, scores
  int HT, TPG;                // heads per block; head tiles per group
  long long xsb, xst, bsb, bst, csb, cst;   // batch / sequence strides
};

// Offsets (floats) of the per-row arrays every kernel keeps for one chunk
// of one head: dt, the sums within each tile up to and after each row, and
// per tile its sum, the sum of the tiles before it and after it, then the
// chunk's sum; then a per-row array of the caller's.
struct Rows { int dts, loc, rloc, tiles, w, total; };

__host__ __device__ inline Rows rows_layout(const Dims& d, int o) {
  Rows r;
  r.dts = o;   o += d.QT;
  r.loc = o;   o += d.QT;
  r.rloc = o;  o += d.QT;
  r.tiles = o; o += 3 * d.nT + 1;
  r.w = o;     o += d.QT;
  r.total = o;
  return r;
}

// Shared floats of the states kernel (ops.py::bwd_smem_bytes mirrors the
// three kernels'): the running state (or gradient), an n-wide and a p-wide
// row tile, the rows, the block sum's per-warp partials.
__host__ __device__ inline int states_floats(const Dims& d) {
  return rows_layout(d, d.NP * d.ldp + d.T * d.ldn + d.T * d.ldp).total + WARPS;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------------------ products
// All operands in shared memory, fp32; M, N, K multiples of 4; 256 threads
// own 4 x 4 register tiles of the output.

// out[m][n] (+)= s[m] Σ_k A[m][k] B[n][k]: both operands hold k contiguous;
// a thread owns rows mi + RG r and columns ni + CG c, so the 8 threads of a
// 16-byte read phase take 8 consecutive B rows.
__device__ void mm_nt(const float* A, int lda, const float* B, int ldb, int M,
                      int N, int K, float* out, int ldo, const float* s,
                      bool accumulate) {
  const int RG = M / 4, CG = N / 4;
  for (int e = threadIdx.x; e < RG * CG; e += THREADS) {
    const int mi = e / CG, ni = e - mi * CG;
    float acc[4][4] = {};
    for (int k = 0; k < K; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(A + (mi + RG * r) * lda + k);
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = ld4(B + (ni + CG * c) * ldb + k);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = acc[r][c];
          v = fmaf(a[r].x, b[c].x, v);
          v = fmaf(a[r].y, b[c].y, v);
          v = fmaf(a[r].z, b[c].z, v);
          v = fmaf(a[r].w, b[c].w, v);
          acc[r][c] = v;
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = mi + RG * r;
      const float sc = s ? s[m] : 1.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* o = out + m * ldo + ni + CG * c;
        *o = (accumulate ? *o : 0.f) + acc[r][c] * sc;
      }
    }
  }
}

// out[m][n] (+)= s[m] Σ_k A[m][k] B[k][n]: A holds k contiguous, B holds n
// contiguous; a thread owns rows mi + RG r and columns 4 ni .. 4 ni + 3.
__device__ void mm_nn(const float* A, int lda, const float* B, int ldb, int M,
                      int N, int K, float* out, int ldo, const float* s,
                      bool accumulate) {
  const int RG = M / 4, CG = N / 4;
  for (int e = threadIdx.x; e < RG * CG; e += THREADS) {
    const int mi = e / CG, ni = e - mi * CG;
    float acc[4][4] = {};
    for (int k = 0; k < K; k += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(A + (mi + RG * r) * lda + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) b[kk] = ld4(B + (k + kk) * ldb + 4 * ni);
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
      const int m = mi + RG * r;
      const float sc = s ? s[m] : 1.f;
      float* o = out + m * ldo + 4 * ni;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = (accumulate ? o[c] : 0.f) + acc[r][c] * sc;
    }
  }
}

// out[m][n] += Σ_k w[k] A[k][m] B[k][n]: both operands hold their output
// index contiguous; a thread owns rows 4 mi .. +3 and columns 4 ni .. +3.
__device__ void mm_tn(const float* A, int lda, const float* B, int ldb, int M,
                      int N, int K, float* out, int ldo, const float* w) {
  const int RG = M / 4, CG = N / 4;
  for (int e = threadIdx.x; e < RG * CG; e += THREADS) {
    const int mi = e / CG, ni = e - mi * CG;
    float acc[4][4] = {};
    for (int k = 0; k < K; ++k) {
      const float wk = w ? w[k] : 1.f;
      const float4 a = ld4(A + k * lda + 4 * mi);
      const float4 b = ld4(B + k * ldb + 4 * ni);
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
      float* o = out + (4 * mi + r) * ldo + 4 * ni;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] += acc[r][c];
    }
  }
}

// ------------------------------------------------------------ loads
// R x width fp32 tile at dst (row stride ld) from `rows` rows of src (row
// stride rs, `cols` columns), each scaled by scale[r] if given; zero past
// rows and cols.
template <typename In>
__device__ void load_tile(float* dst, int ld, int width, const In* src,
                          long long rs, int R, int rows, int cols,
                          const float* scale) {
  for (int i = threadIdx.x; i < R * width; i += THREADS) {
    const int r = i / width, c = i - r * width;
    float v = 0.f;
    if (r < rows && c < cols) {
      v = to_f(src[r * rs + c]);
      if (scale) v *= scale[r];
    }
    dst[r * ld + c] = v;
  }
}

// One head's n x p fp32 state at src (dense) into an NP x PP tile (row
// stride ld), zero past n and p.
__device__ void load_state(float* dst, int ld, const float* src, const Dims& d) {
  for (int i = threadIdx.x; i < d.NP * d.PP; i += THREADS) {
    const int n = i / d.PP, p = i - n * d.PP;
    dst[n * ld + p] = (src && n < d.N && p < d.P) ? src[n * d.P + p] : 0.f;
  }
}

__device__ void store_state(float* dst, const float* src, int ld, const Dims& d) {
  for (int i = threadIdx.x; i < d.N * d.P; i += THREADS) {
    const int n = i / d.P, p = i - n * d.P;
    dst[i] = src[n * ld + p];
  }
}

// ------------------------------------------------------------ decays
// The chunk's dt for head hh into r.dts (0 past Q), then its decay sums
// (all <= 0): per row loc (the tile's rows up to it) and rloc (the tile's
// rows after it); per tile its sum, the sums of the tiles before and after
// it; the chunk's sum.  One thread per tile, then one over the tiles.
__device__ void chunk_decays(float* sm, const Rows& r, const float* dt, int b,
                             int c, int hh, float a, const Dims& d) {
  float* dts = sm + r.dts;
  const float* dtb = dt + ((long long)b * d.S + (long long)c * d.Q) * d.H + hh;
  for (int t = threadIdx.x; t < d.QT; t += THREADS)
    dts[t] = t < d.Q ? dtb[(long long)t * d.H] : 0.f;
  __syncthreads();
  float* loc = sm + r.loc;
  float* rloc = sm + r.rloc;
  float* tot = sm + r.tiles;
  float* pre = tot + d.nT;
  float* suf = pre + d.nT;
  for (int m = threadIdx.x; m < d.nT; m += THREADS) {
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
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int m = 0; m < d.nT; ++m) {
      pre[m] = run;
      run += tot[m];
    }
    tot[3 * d.nT] = run;
    run = 0.f;
    for (int m = d.nT - 1; m >= 0; --m) {
      suf[m] = run;
      run += tot[m];
    }
  }
  __syncthreads();
}

// exp(cum_t) (prefix: after = false) or exp(after_t) (suffix), times dt_t
// if with_dt, for the T rows of tile m into w[0 .. T); 0 past Q.
__device__ void row_factors(float* sm, const Rows& r, int m, bool after,
                            bool with_dt, const Dims& d) {
  const float* tiles = sm + r.tiles;
  for (int t = threadIdx.x; t < d.T; t += THREADS) {
    const int g = m * d.T + t;
    const float e = after ? sm[r.rloc + g] + tiles[2 * d.nT + m]
                          : sm[r.loc + g] + tiles[d.nT + m];
    const float v = g < d.Q ? expf(e) : 0.f;
    sm[r.w + t] = with_dt ? v * sm[r.dts + g] : v;
  }
}

// Scores S1 (and S2, if given) of q tile iq against k tile ik times their
// decays exp(sum of dt A over k+1 .. q), 0 where k > q.  On the diagonal a
// running sum down each column; off it loc_q + (tiles between) + rloc_k.
__device__ void apply_decay(float* S1, float* S2, const float* sm,
                            const Rows& r, float a, int iq, int ik,
                            const Dims& d) {
  const float* dts = sm + r.dts;
  if (iq == ik) {
    const int q0 = iq * d.T;
    for (int k = threadIdx.x; k < d.T; k += THREADS) {
      float run = 0.f;
      for (int q = 0; q < d.T; ++q) {
        float f = 0.f;
        if (q == k) {
          f = 1.f;
        } else if (q > k) {
          run += dts[q0 + q] * a;
          f = expf(run);
        }
        S1[q * d.ldt + k] *= f;
        if (S2) S2[q * d.ldt + k] *= f;
      }
    }
    return;
  }
  const float* tot = sm + r.tiles;
  float mid = 0.f;
  for (int m = ik + 1; m < iq; ++m) mid += tot[m];
  const float* loc = sm + r.loc + iq * d.T;
  const float* rloc = sm + r.rloc + ik * d.T;
  for (int e = threadIdx.x; e < d.T * d.T; e += THREADS) {
    const int q = e / d.T, k = e - q * d.T;
    const float f = expf(loc[q] + mid + rloc[k]);
    S1[q * d.ldt + k] *= f;
    if (S2) S2[q * d.ldt + k] *= f;
  }
}

// Σ_c U[row][c] V[row][c] for each of `rows` rows of width `cols` (row
// strides lu, lv) into out[row]; a warp per row.
__device__ void row_dots(const float* U, int lu, const float* V, int lv,
                         int rows, int cols, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < rows; row += WARPS) {
    float s = 0.f;
    for (int c = lane; c < cols; c += 32) s += U[row * lu + c] * V[row * lv + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) out[row] = s;
  }
}

// Sum of v over the block, in a fixed order; every thread gets it.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// ------------------------------------------------ 1. states and their grads
template <typename In>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_states(const In* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const In* __restrict__ Bm,
               const In* __restrict__ Cm, const float* __restrict__ init,
               const In* __restrict__ dy, const float* __restrict__ dstate,
               float* __restrict__ prev, float* __restrict__ grads,
               float* __restrict__ delta, float* __restrict__ dinit, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* St = sm;                              // NP x ldp
  float* Nt = St + d.NP * d.ldp;               // T x ldn: B or C rows
  float* Pt = Nt + d.T * d.ldn;                // T x ldp: x or dy rows
  const Rows r = rows_layout(d, d.NP * d.ldp + d.T * d.ldn + d.T * d.ldp);
  float* red = sm + r.total;
  const int hh = blockIdx.x, b = blockIdx.y;
  const int grp = hh / (d.H / d.G);
  const float a = A[hh];
  const long long E = (long long)d.N * d.P;
  const long long head = (long long)b * d.H + hh;
  auto at = [&](float* base, int c) {          // (b, c, hh) of a (b, nc, h, n, p) scratch
    return base + (((long long)b * d.nc + c) * d.H + hh) * E;
  };

  // forward: S_c = exp(total_c) S_{c-1} + Σ_k exp(after_k) dt_k B_k ⊗ x_k
  load_state(St, d.ldp, init ? init + head * E : nullptr, d);
  for (int c = 0; c < d.nc; ++c) {
    chunk_decays(sm, r, dt, b, c, hh, a, d);    // syncs: St is complete
    store_state(at(prev, c), St, d.ldp, d);
    const float decay = expf(sm[r.tiles + 3 * d.nT]);
    __syncthreads();
    for (int i = threadIdx.x; i < d.NP * d.PP; i += THREADS) {
      const int n = i / d.PP, p = i - n * d.PP;
      St[n * d.ldp + p] *= decay;
    }
    for (int m = 0; m < d.nT; ++m) {
      const long long t0 = (long long)c * d.Q + m * d.T;
      const int rows = min(d.T, d.Q - m * d.T);
      row_factors(sm, r, m, true, true, d);
      load_tile(Nt, d.ldn, d.NP, Bm + b * d.bsb + t0 * d.bst + (long long)grp * d.N,
                d.bst, d.T, rows, d.N, (const float*)nullptr);
      load_tile(Pt, d.ldp, d.PP, x + b * d.xsb + t0 * d.xst + (long long)hh * d.P,
                d.xst, d.T, rows, d.P, (const float*)nullptr);
      __syncthreads();
      mm_tn(Nt, d.ldn, Pt, d.ldp, d.NP, d.PP, d.T, St, d.ldp, sm + r.w);
      __syncthreads();
    }
  }
  // backward: dS_{c-1} = exp(total_c) dS_c + Σ_q exp(cum_q) C_q ⊗ dy_q, and
  // <S_out_c, dS_c> (S_out of the last chunk is St, the final state)
  const float* dsb = dstate ? dstate + head * E : nullptr;
  {
    float v = 0.f;
    for (int i = threadIdx.x; i < d.N * d.P; i += THREADS) {
      const int n = i / d.P, p = i - n * d.P;
      if (dsb) v += St[n * d.ldp + p] * dsb[i];
    }
    v = block_sum(v, red);
    if (threadIdx.x == 0) delta[((long long)b * d.nc + d.nc - 1) * d.H + hh] = v;
  }
  __syncthreads();
  load_state(St, d.ldp, dsb, d);
  for (int c = d.nc - 1; c >= 0; --c) {
    chunk_decays(sm, r, dt, b, c, hh, a, d);
    store_state(at(grads, c), St, d.ldp, d);
    if (c + 1 < d.nc) {                          // S_out_c entered chunk c + 1
      const float* so = at(prev, c + 1);
      float v = 0.f;
      for (int i = threadIdx.x; i < d.N * d.P; i += THREADS) {
        const int n = i / d.P, p = i - n * d.P;
        v += so[i] * St[n * d.ldp + p];
      }
      v = block_sum(v, red);
      if (threadIdx.x == 0) delta[((long long)b * d.nc + c) * d.H + hh] = v;
    }
    const float decay = expf(sm[r.tiles + 3 * d.nT]);
    __syncthreads();
    for (int i = threadIdx.x; i < d.NP * d.PP; i += THREADS) {
      const int n = i / d.PP, p = i - n * d.PP;
      St[n * d.ldp + p] *= decay;
    }
    for (int m = 0; m < d.nT; ++m) {
      const long long t0 = (long long)c * d.Q + m * d.T;
      const int rows = min(d.T, d.Q - m * d.T);
      row_factors(sm, r, m, false, false, d);
      load_tile(Nt, d.ldn, d.NP, Cm + b * d.csb + t0 * d.cst + (long long)grp * d.N,
                d.cst, d.T, rows, d.N, (const float*)nullptr);
      load_tile(Pt, d.ldp, d.PP, dy + (((long long)b * d.S + t0) * d.H + hh) * d.P,
                (long long)d.H * d.P, d.T, rows, d.P, (const float*)nullptr);
      __syncthreads();
      mm_tn(Nt, d.ldn, Pt, d.ldp, d.NP, d.PP, d.T, St, d.ldp, sm + r.w);
      __syncthreads();
    }
  }
  if (dinit) store_state(dinit + head * E, St, d.ldp, d);
}

// Shared layout (floats) of the keys kernel (keys) or the queries kernel.
struct Pass { int own_n, own_p, oth_n, oth_p, s1, s2, acc_p, acc_n, acc2, st, dots, end; };

__host__ __device__ inline Pass pass_layout(const Dims& d, bool keys) {
  Pass l;
  int o = 0;
  l.own_n = o; o += d.T * d.ldn;     // keys: B rows; queries: C rows
  l.own_p = o; o += d.T * d.ldp;     // keys: x' rows; queries: dy rows
  l.oth_n = o; o += d.T * d.ldn;     // keys: C rows of a q tile; queries: B
  l.oth_p = o; o += d.T * d.ldp;     // keys: dy rows (then x rows); queries: x'
  l.s2 = o;    o += d.T * d.ldt;     // dy x'^T times the decays
  l.acc_n = o; o += d.T * d.ldn;     // keys: dB over the heads; queries: dC
  l.st = o;    o += d.NP * d.ldp;    // keys: dS; queries: S_prev
  l.s1 = l.acc_p = l.acc2 = -1;
  if (keys) {
    l.s1 = o;    o += d.T * d.ldt;   // C B^T times the decays
    l.acc_p = o; o += d.T * d.ldp;   // dx'
  } else {
    l.acc2 = o;  o += d.T * d.ldn;   // dC over the heads
  }
  l.dots = o;  o += (keys ? 2 : 1) * d.T;   // per row dot products
  l.end = o;
  return l;
}

__host__ __device__ inline int pass_floats(const Dims& d, bool keys) {
  return rows_layout(d, pass_layout(d, keys).end).total;
}

// ------------------------------------------------------------ 2. keys
template <typename In>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_keys(const In* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const In* __restrict__ Bm,
             const In* __restrict__ Cm, const In* __restrict__ dy,
             const float* __restrict__ grads, In* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ dcum,
             float* __restrict__ dBp, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const Pass l = pass_layout(d, true);
  const Rows r = rows_layout(d, l.end);
  float* Bs = sm + l.own_n;
  float* Xs = sm + l.own_p;
  float* Cs = sm + l.oth_n;
  float* Ds = sm + l.oth_p;
  float* S1 = sm + l.s1;
  float* S2 = sm + l.s2;
  float* dX = sm + l.acc_p;
  float* dBs = sm + l.acc_n;
  float* Gs = sm + l.st;
  float* dots = sm + l.dots;                   // per row: x' . dx', x . dx'
  const int ik = blockIdx.x;
  const int hpg = d.H / d.G, grp = blockIdx.y / d.TPG;
  const int h_first = grp * hpg + (blockIdx.y % d.TPG) * d.HT;
  const int nh = min(d.HT, (grp + 1) * hpg - h_first);
  const int c = blockIdx.z % d.nc, b = blockIdx.z / d.nc;
  const int k0 = ik * d.T, krows = min(d.T, d.Q - k0);
  const long long t0 = (long long)c * d.Q + k0;     // first row of the tile
  const long long E = (long long)d.N * d.P;

  load_tile(Bs, d.ldn, d.NP, Bm + b * d.bsb + t0 * d.bst + (long long)grp * d.N,
            d.bst, d.T, krows, d.N, (const float*)nullptr);
  for (int i = threadIdx.x; i < d.T * d.NP; i += THREADS) {
    const int row = i / d.NP, n = i - row * d.NP;
    dBs[row * d.ldn + n] = 0.f;
  }
  for (int j = 0; j < nh; ++j) {
    const int hh = h_first + j;
    const float a = A[hh];
    chunk_decays(sm, r, dt, b, c, hh, a, d);
    const In* xb = x + b * d.xsb + t0 * d.xst + (long long)hh * d.P;
    load_tile(Xs, d.ldp, d.PP, xb, d.xst, d.T, krows, d.P, sm + r.dts + k0);
    load_state(Gs, d.ldp, grads + (((long long)b * d.nc + c) * d.H + hh) * E, d);
    row_factors(sm, r, ik, true, false, d);      // exp(after_k)
    __syncthreads();
    // state terms: dx' = exp(after) B dS, dB += exp(after) dS x'
    mm_nn(Bs, d.ldn, Gs, d.ldp, d.T, d.PP, d.NP, dX, d.ldp, sm + r.w, false);
    mm_nt(Xs, d.ldp, Gs, d.ldp, d.T, d.NP, d.PP, dBs, d.ldn, sm + r.w, true);
    for (int iq = ik; iq < d.nT; ++iq) {
      const long long tq = (long long)c * d.Q + iq * d.T;
      const int qrows = min(d.T, d.Q - iq * d.T);
      __syncthreads();                           // Cs, Ds, S1, S2 are free
      load_tile(Cs, d.ldn, d.NP, Cm + b * d.csb + tq * d.cst + (long long)grp * d.N,
                d.cst, d.T, qrows, d.N, (const float*)nullptr);
      load_tile(Ds, d.ldp, d.PP, dy + (((long long)b * d.S + tq) * d.H + hh) * d.P,
                (long long)d.H * d.P, d.T, qrows, d.P, (const float*)nullptr);
      __syncthreads();
      mm_nt(Cs, d.ldn, Bs, d.ldn, d.T, d.T, d.NP, S1, d.ldt, nullptr, false);
      mm_nt(Ds, d.ldp, Xs, d.ldp, d.T, d.T, d.PP, S2, d.ldt, nullptr, false);
      __syncthreads();
      apply_decay(S1, S2, sm, r, a, iq, ik, d);
      __syncthreads();
      mm_tn(S1, d.ldt, Ds, d.ldp, d.T, d.PP, d.T, dX, d.ldp, nullptr);
      mm_tn(S2, d.ldt, Cs, d.ldn, d.T, d.NP, d.T, dBs, d.ldn, nullptr);
    }
    __syncthreads();
    // this head's rows: dx = dt dx'; x . dx'; -x' . dx'
    load_tile(Ds, d.ldp, d.PP, xb, d.xst, d.T, krows, d.P,
              (const float*)nullptr);            // x rows (Ds is free)
    __syncthreads();
    row_dots(Xs, d.ldp, dX, d.ldp, krows, d.PP, dots);
    row_dots(Ds, d.ldp, dX, d.ldp, krows, d.PP, dots + d.T);
    In* dxb = dx + (((long long)b * d.S + t0) * d.H + hh) * d.P;
    for (int i = threadIdx.x; i < krows * d.P; i += THREADS) {
      const int row = i / d.P, p = i - row * d.P;
      dxb[(long long)row * d.H * d.P + p] =
          from_f<In>(sm[r.dts + k0 + row] * dX[row * d.ldp + p]);
    }
    __syncthreads();
    for (int row = threadIdx.x; row < krows; row += THREADS) {
      const long long o = ((long long)b * d.S + t0 + row) * d.H + hh;
      ddt[o] = dots[d.T + row];
      dcum[o] = -dots[row];
    }
  }
  __syncthreads();
  float* out = dBp + (((long long)b * d.S + t0) * (d.G * d.TPG) + blockIdx.y) * d.N;
  for (int i = threadIdx.x; i < krows * d.N; i += THREADS) {
    const int row = i / d.N, n = i - row * d.N;
    out[(long long)row * d.G * d.TPG * d.N + n] = dBs[row * d.ldn + n];
  }
}

// ------------------------------------------------------------ 3. queries
template <typename In>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_queries(const In* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const In* __restrict__ Bm,
                const In* __restrict__ Cm, const In* __restrict__ dy,
                const float* __restrict__ prev, float* __restrict__ dcum,
                float* __restrict__ dCp, Dims d) {
  extern __shared__ __align__(16) float sm[];
  const Pass l = pass_layout(d, false);
  const Rows r = rows_layout(d, l.end);
  float* Cs = sm + l.own_n;
  float* Ds = sm + l.own_p;
  float* Bs = sm + l.oth_n;
  float* Xs = sm + l.oth_p;
  float* S2 = sm + l.s2;
  float* dots = sm + l.dots;
  float* dCh = sm + l.acc_n;
  float* dCs = sm + l.acc2;
  float* Ps = sm + l.st;
  const int iq = blockIdx.x;
  const int hpg = d.H / d.G, grp = blockIdx.y / d.TPG;
  const int h_first = grp * hpg + (blockIdx.y % d.TPG) * d.HT;
  const int nh = min(d.HT, (grp + 1) * hpg - h_first);
  const int c = blockIdx.z % d.nc, b = blockIdx.z / d.nc;
  const int q0 = iq * d.T, qrows = min(d.T, d.Q - q0);
  const long long t0 = (long long)c * d.Q + q0;
  const long long E = (long long)d.N * d.P;

  load_tile(Cs, d.ldn, d.NP, Cm + b * d.csb + t0 * d.cst + (long long)grp * d.N,
            d.cst, d.T, qrows, d.N, (const float*)nullptr);
  for (int i = threadIdx.x; i < d.T * d.NP; i += THREADS) {
    const int row = i / d.NP, n = i - row * d.NP;
    dCs[row * d.ldn + n] = 0.f;
  }
  for (int j = 0; j < nh; ++j) {
    const int hh = h_first + j;
    const float a = A[hh];
    chunk_decays(sm, r, dt, b, c, hh, a, d);
    load_tile(Ds, d.ldp, d.PP, dy + (((long long)b * d.S + t0) * d.H + hh) * d.P,
              (long long)d.H * d.P, d.T, qrows, d.P, (const float*)nullptr);
    load_state(Ps, d.ldp, prev + (((long long)b * d.nc + c) * d.H + hh) * E, d);
    row_factors(sm, r, iq, false, false, d);     // exp(cum_q)
    __syncthreads();
    // inter term: dC = exp(cum) dy S_prev^T
    mm_nt(Ds, d.ldp, Ps, d.ldp, d.T, d.NP, d.PP, dCh, d.ldn, sm + r.w, false);
    for (int ik = 0; ik <= iq; ++ik) {
      const long long tk = (long long)c * d.Q + ik * d.T;
      const int krows = min(d.T, d.Q - ik * d.T);
      __syncthreads();                           // Bs, Xs, S2 are free
      load_tile(Bs, d.ldn, d.NP, Bm + b * d.bsb + tk * d.bst + (long long)grp * d.N,
                d.bst, d.T, krows, d.N, (const float*)nullptr);
      load_tile(Xs, d.ldp, d.PP, x + b * d.xsb + tk * d.xst + (long long)hh * d.P,
                d.xst, d.T, krows, d.P, sm + r.dts + ik * d.T);
      __syncthreads();
      mm_nt(Ds, d.ldp, Xs, d.ldp, d.T, d.T, d.PP, S2, d.ldt, nullptr, false);
      __syncthreads();
      apply_decay(S2, nullptr, sm, r, a, iq, ik, d);
      __syncthreads();
      mm_nn(S2, d.ldt, Bs, d.ldn, d.T, d.NP, d.T, dCh, d.ldn, nullptr, true);
    }
    __syncthreads();
    row_dots(Cs, d.ldn, dCh, d.ldn, qrows, d.NP, dots);
    for (int i = threadIdx.x; i < d.T * d.NP; i += THREADS) {
      const int row = i / d.NP, n = i - row * d.NP;
      dCs[row * d.ldn + n] += dCh[row * d.ldn + n];
    }
    __syncthreads();
    for (int row = threadIdx.x; row < qrows; row += THREADS)
      dcum[((long long)b * d.S + t0 + row) * d.H + hh] += dots[row];
  }
  __syncthreads();
  float* out = dCp + (((long long)b * d.S + t0) * (d.G * d.TPG) + blockIdx.y) * d.N;
  for (int i = threadIdx.x; i < qrows * d.N; i += THREADS) {
    const int row = i / d.N, n = i - row * d.N;
    out[(long long)row * d.G * d.TPG * d.N + n] = dCs[row * d.ldn + n];
  }
}

// ------------------------------------------------------------ 4. finish
// Blocks 0 .. H-1: head blockIdx.x; a thread per (batch, chunk) walks its
// rows in reverse, d(dt A)_t = delta + Σ_{u >= t} dcum_u, ddt += A d(dt A),
// and dA = Σ dt d(dt A) over the block in a fixed order.  Blocks from H:
// dB and dC, each element the sum of its group's head-tile partials.
template <typename In>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
               const float* __restrict__ delta, const float* __restrict__ dcum,
               float* __restrict__ ddt, float* __restrict__ dA,
               const float* __restrict__ dBp, const float* __restrict__ dCp,
               In* __restrict__ dB, In* __restrict__ dC, int batch, Dims d) {
  __shared__ float red[WARPS];
  if ((int)blockIdx.x < d.H) {
    const int hh = blockIdx.x;
    const float a = A[hh];
    float part = 0.f;
    for (int j = threadIdx.x; j < batch * d.nc; j += THREADS) {
      const int b = j / d.nc, c = j - b * d.nc;
      float run = delta[((long long)b * d.nc + c) * d.H + hh];
      for (int u = d.Q - 1; u >= 0; --u) {
        const long long o = ((long long)b * d.S + (long long)c * d.Q + u) * d.H + hh;
        run += dcum[o];
        ddt[o] += a * run;
        part += dt[o] * run;
      }
    }
    const float s = block_sum(part, red);
    if (threadIdx.x == 0) dA[hh] = s;
    return;
  }
  const long long e = ((long long)blockIdx.x - d.H) * THREADS + threadIdx.x;
  const long long total = (long long)batch * d.S * d.G * d.N;
  if (e >= total) return;
  const int n = (int)(e % d.N);
  const long long rg = e / d.N;                // (b, t) * G + grp
  const int grp = (int)(rg % d.G);
  const long long bt = rg / d.G;
  const float* pb = dBp + (bt * d.G * d.TPG + (long long)grp * d.TPG) * d.N + n;
  const float* pc = dCp + (bt * d.G * d.TPG + (long long)grp * d.TPG) * d.N + n;
  float sb = 0.f, sc = 0.f;
  for (int t = 0; t < d.TPG; ++t) {
    sb += pb[(long long)t * d.N];
    sc += pc[(long long)t * d.N];
  }
  dB[e] = from_f<In>(sb);
  dC[e] = from_f<In>(sc);
}

// ------------------------------------------------------------ launch
template <typename F>
cudaError_t allow_smem(F* kernel, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess) configured = true;
  return err;
}

struct Ptrs {
  const void *x, *dt, *A, *B, *C, *init, *dy, *dstate;
  void *dx, *ddt, *dA, *dB, *dC, *dinit;
  void *prev, *grads, *delta, *dcum, *dBp, *dCp;
};

template <typename In>
int launch(const Ptrs& q, const Dims& d, int batch, int stages,
           cudaStream_t stream) {
  static bool c1 = false, c2 = false, c3 = false;
  const size_t s1 = (size_t)states_floats(d) * sizeof(float);
  const size_t s2 = (size_t)pass_floats(d, true) * sizeof(float);
  const size_t s3 = (size_t)pass_floats(d, false) * sizeof(float);
  if (s1 > (size_t)SMEM_LIMIT || s2 > (size_t)SMEM_LIMIT || s3 > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ssd_bwd_states<In>, c1);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_keys<In>, c2);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_queries<In>, c3);
  if (err != cudaSuccess) return (int)err;
  const In* x = static_cast<const In*>(q.x);
  const In* B = static_cast<const In*>(q.B);
  const In* C = static_cast<const In*>(q.C);
  const In* dy = static_cast<const In*>(q.dy);
  const float* dt = static_cast<const float*>(q.dt);
  const float* A = static_cast<const float*>(q.A);
  float* prev = static_cast<float*>(q.prev);
  float* grads = static_cast<float*>(q.grads);
  float* delta = static_cast<float*>(q.delta);
  float* dcum = static_cast<float*>(q.dcum);
  float* ddt = static_cast<float*>(q.ddt);
  const dim3 tiles(d.nT, d.G * d.TPG, d.nc * batch);
  if (stages & 1) {
    ssd_bwd_states<In><<<dim3(d.H, batch), THREADS, s1, stream>>>(
        x, dt, A, B, C, static_cast<const float*>(q.init), dy,
        static_cast<const float*>(q.dstate), prev, grads, delta,
        static_cast<float*>(q.dinit), d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & 2) {
    ssd_bwd_keys<In><<<tiles, THREADS, s2, stream>>>(
        x, dt, A, B, C, dy, grads, static_cast<In*>(q.dx), ddt, dcum,
        static_cast<float*>(q.dBp), d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & 4) {
    ssd_bwd_queries<In><<<tiles, THREADS, s3, stream>>>(
        x, dt, A, B, C, dy, prev, dcum, static_cast<float*>(q.dCp), d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & 8) {
    const long long elems = (long long)batch * d.S * d.G * d.N;
    const long long blocks = d.H + (elems + THREADS - 1) / THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    ssd_bwd_finish<In><<<(unsigned)blocks, THREADS, 0, stream>>>(
        dt, A, delta, dcum, ddt, static_cast<float*>(q.dA),
        static_cast<const float*>(q.dBp), static_cast<const float*>(q.dCp),
        static_cast<In*>(q.dB), static_cast<In*>(q.dC), batch, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename In>
int launch_checked(const Ptrs& q, int b, int s, int h, int p, int g, int n,
                   int chunk, int tile, int heads, long long xsb, long long xst,
                   long long bsb, long long bst, long long csb, long long cst,
                   int stages, cudaStream_t stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || g <= 0 || n <= 0 || h % g != 0 ||
      chunk <= 0 || s % chunk != 0 || (tile != 64 && tile != 32 && tile != 16) ||
      heads <= 0 || b > 65535 || (long long)(s / chunk) * b > 65535)
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.S = s; d.H = h; d.P = p; d.G = g; d.N = n; d.Q = chunk; d.nc = s / chunk;
  d.T = tile; d.NP = round4(n); d.PP = round4(p);
  d.QT = (chunk + tile - 1) / tile * tile; d.nT = d.QT / tile;
  d.ldn = ld_odd(d.NP); d.ldp = ld_odd(d.PP); d.ldt = ld_odd(tile);
  d.HT = heads; d.TPG = (h / g + heads - 1) / heads;
  if ((long long)d.G * d.TPG > 65535) return (int)cudaErrorInvalidValue;
  d.xsb = xsb; d.xst = xst; d.bsb = bsb; d.bst = bst; d.csb = csb; d.cst = cst;
  return launch<In>(q, d, b, stages, stream);
}

}  // namespace

extern "C" {

// stages: 1 states, 2 keys, 4 queries, 8 finish (15 for the whole backward)
#define SSD_BWD_ENTRY(NAME, IN)                                                  \
  int NAME(const void* x, const void* dt, const void* A, const void* B,         \
           const void* C, const void* init, const void* dy, const void* dstate, \
           void* dx, void* ddt, void* dA, void* dB, void* dC, void* dinit,      \
           void* prev, void* grads, void* delta, void* dcum, void* dBp,         \
           void* dCp, int b, int s, int h, int p, int g, int n, int chunk,      \
           int tile, int heads, long long xsb, long long xst, long long bsb,    \
           long long bst, long long csb, long long cst, int stages,             \
           void* stream) {                                                       \
    const Ptrs q{x, dt, A, B, C, init, dy, dstate, dx, ddt, dA, dB, dC, dinit,  \
                 prev, grads, delta, dcum, dBp, dCp};                            \
    return launch_checked<IN>(q, b, s, h, p, g, n, chunk, tile, heads, xsb,     \
                              xst, bsb, bst, csb, cst, stages,                   \
                              static_cast<cudaStream_t>(stream));                \
  }

SSD_BWD_ENTRY(ssd_chunk_scan_bwd_f32, float)
SSD_BWD_ENTRY(ssd_chunk_scan_bwd_bf16, bf16)

#undef SSD_BWD_ENTRY

}  // extern "C"
