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
// fp32 entry (ssd_chunk_scan_bwd_f32): the first design's four kernels, fp32
// on the CUDA cores, kept as the forward's fp32 entry keeps its first port:
// its 5e-4 tolerance and the card-vs-CPU fp32 gradients of chip_smoke phase
// 4 rest on full fp32 products.
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
//      blocks sum the head tiles' dB and dC partials.
// Products are 4 x 4 register tiles per thread from shared memory (~2 FMAs
// per float loaded); decay exponents are sums of one sign: for a key tile
// before the q tile loc_q + (the tiles between) + rloc_k, inside the
// diagonal tile a running sum down each column, exp(cum_q) a prefix and
// exp(after_k) a suffix.
//
// bf16 entry (ssd_chunk_scan_bwd_bf16): five kernels, every product on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate, fragments by
// ldmatrix from rows padded by 8 elements), from the duality that only the
// state links the chunks:
//   1. ssd_bwd_chunk_bf16, one block per (chunk, head, batch), 2,560 at the
//      train shape: the chunk-local state terms B^T (x o w), w = dt
//      exp(sum after the row), and C^T (dy o exp(cum)), n x p products over
//      the chunk's rows with B, x, C, dy through a two-stage cp.async ring
//      (three blocks to an SM); fp32 into the two state scratches;
//   2. ssd_bwd_pass, one block per (head, batch), 4 elements a thread:
//      backward over the chunks,
//      G_{c-1} = exp(total_c) G_c + (its chunk term) from dstate, writing
//      G_c (the gradient of the state leaving chunk c) over its chunk term,
//      and dinit; then forward, S_c = exp(total_c) S_{c-1} + (its chunk
//      term) from init, writing S_{c-1} (the state entering chunk c) over
//      its term, and <S_c, G_c>.  Both are written as packed hi / lo bf16
//      halves (packed_at: groups of 64 elements, or of 8 where n p is not
//      a multiple of 64, so jamba's 16-element heads are not padded);
//   3. ssd_bwd_keys_bf16, one block per (64-row key tile, up to 16 heads of
//      one group, chunk, batch), 640, one to an SM: C B^T against every q
//      tile at or after the key tile once, kept in shared memory for every
//      head of the block (heads differ only in dt and A); per head its decay
//      tables (warp 0, in registers), the state terms dx' = exp(after) B dS
//      and dB = dt exp(after) x dS^T, then per q tile dy x^T once, M1 =
//      C B^T o L and M2 = dy x'^T o L (all fragments first, then all
//      products), dx' += M1^T dy, dB += M2^T C, and M2 (hi and lo) written
//      to a scratch for the queries kernel (tiles of the chunk's rows
//      rounded up to 16, at most 64: jamba's chunk of 16 stores 16 x 16);
//      it writes dx, x . dx' and -x' . dx', and dB summed over its heads;
//   4. ssd_bwd_queries_bf16, one block per (64-row q tile, head tile, chunk,
//      batch): per head dC = exp(cum) dy S_prev^T + Σ_k M2 B over the key
//      tiles at or before the q tile (the keys kernel's M2, read once), and
//      C . dC of the state term; dC summed over its heads.
//   Both take their tiles through three-stage cp.async rings, two loads
//   ahead, and a head's own rows and state as soon as the previous head is
//   done with their buffers; the blocks with the most tile pairs launch
//   first.  Keys then queries run over slices of (chunk, batch) rows whose
//   M2 fits one scratch of at most 512 MB (ops.py::M2_BYTES; mamba2's
//   train shape is one slice, jamba's 8,192 heads at b 4 x s 2048 eight);
//   5. ssd_bwd_finish_bf16: a warp per (batch, chunk) of a head, a suffix
//      scan over the lanes for d(dt A), ddt, dA in a fixed order; further
//      blocks sum the head tiles' dB and dC partials.
// Operands that are not bf16 data are split into hi + lo bf16 halves and
// multiplied twice: x w and dy exp(cum) (chunk), M1 and M2 (keys, queries),
// the fp32 states S_prev and dS.  One bf16 rounding of any one of them puts
// the gradients outside chip_smoke's 2e-2 of the plain backward at mamba2's
// widths (tests/test_torch_ssd_bwd.py emulates the roundings).  x, dy, B, C
// stay bf16 data: dt, exp(after) and exp(cum) scale the rows of a product
// after it.  d cum's terms cancel in d(dt A) = Σ_{u >= t} d cum_u (the
// intra terms of C . dC and of x' . dx' are the same scores S = (C B^T) o
// (dy x'^T) o L summed over keys and over queries); computed from the two
// hi + lo products they left ddt and dA outside that criterion on the card.
// So the keys kernel sums S itself in fp32, over q for its key rows and
// over its keys for the q rows (one partial per key tile, added by the
// finish kernel in order; a chunk of one tile adds its own to d cum), and
// the products give only the state terms' dots.  No float atomics: every sum has one order, so the gradients
// repeat bit for bit.
//
// What bounds it: at mamba2-2.7b's train shape (b 4, s 2048, h 80, p 64,
// g 1, n 128, Q 256, bf16) the least work is ~1.2e11 FLOPs (the causal
// halves of the chunk products) against ~265 MB of traffic, so the card's
// bound is its tensor cores (~0.12 ms).  The bf16 entry executes ~2.7e11
// tensor FLOPs (hi + lo doubles the products, the keys kernel forms dy x^T
// in both halves of its warps, the diagonal tiles are done whole) and
// moves ~1.6 GB (M2, 420 MB, written and read once; the state scratches
// written and read twice).  The keys and queries kernels, one block of 8
// warps to an SM, are bound by latency: long chains from the products
// through the decays and the hi + lo splits back into products (PERF.md).
//
// Decay precision: every exponent is a sum of one sign: exp(cum_q) a
// prefix, exp(after_k) a suffix; in the bf16 keys kernel, for a q row in a
// later 16-row block than the key, the sum after the key in its block,
// the blocks between and the sum up to q in its block; in one block a
// running sum.
//
// Inputs x, B and C are read through their batch and sequence strides
// (the model passes slices of one convolution output); dy, the outputs and
// the scratch are dense.  Rows past the chunk, n past d_state and p past
// head_dim are zero in shared memory.  Padded rows (dt = 0, x = B = C = 0,
// dy = 0) give dx = dB = dC = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 232448;   // bytes a block may opt into on sm_90
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) / 4 * 4; }
// a multiple of 4 whose quarter is odd: 16-byte reads of 8 consecutive rows
// hit distinct banks
__host__ __device__ __forceinline__ int ld_odd(int v) { return ((v / 4) & 1) ? v : v + 4; }

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
__device__ void load_tile(float* dst, int ld, int width, const float* src,
                          long long rs, int R, int rows, int cols,
                          const float* scale) {
  for (int i = threadIdx.x; i < R * width; i += THREADS) {
    const int r = i / width, c = i - r * width;
    float v = 0.f;
    if (r < rows && c < cols) {
      v = src[r * rs + c];
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
__global__ void __launch_bounds__(THREADS)
ssd_bwd_states(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ init,
               const float* __restrict__ dy, const float* __restrict__ dstate,
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
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_keys(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ Bm,
             const float* __restrict__ Cm, const float* __restrict__ dy,
             const float* __restrict__ grads, float* __restrict__ dx,
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
    const float* xb = x + b * d.xsb + t0 * d.xst + (long long)hh * d.P;
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
    float* dxb = dx + (((long long)b * d.S + t0) * d.H + hh) * d.P;
    for (int i = threadIdx.x; i < krows * d.P; i += THREADS) {
      const int row = i / d.P, p = i - row * d.P;
      dxb[(long long)row * d.H * d.P + p] =
          sm[r.dts + k0 + row] * dX[row * d.ldp + p];
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
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_queries(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dy,
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
// dB and dC element e (of b s g n) for block `blk` of those past the H
// head blocks: each the sum of its group's head-tile partials.
template <typename In>
__device__ void sum_tiles(long long blk, const float* __restrict__ dBp,
                          const float* __restrict__ dCp, In* __restrict__ dB,
                          In* __restrict__ dC, int batch, const Dims& d) {
  const long long e = blk * THREADS + threadIdx.x;
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

// Blocks 0 .. H-1: head blockIdx.x; a thread per (batch, chunk) walks its
// rows in reverse, d(dt A)_t = delta + Σ_{u >= t} dcum_u, ddt += A d(dt A),
// and dA = Σ dt d(dt A) over the block in a fixed order.  Blocks from H:
// dB and dC (sum_tiles).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_finish(const float* __restrict__ dt, const float* __restrict__ A,
               const float* __restrict__ delta, const float* __restrict__ dcum,
               float* __restrict__ ddt, float* __restrict__ dA,
               const float* __restrict__ dBp, const float* __restrict__ dCp,
               float* __restrict__ dB, float* __restrict__ dC, int batch, Dims d) {
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
  sum_tiles(blockIdx.x - d.H, dBp, dCp, dB, dC, batch, d);
}

// =================================================================== bf16
// Every product on the tensor cores: mma.sync m16n8k16, bf16 in, fp32
// accumulate, fragments by ldmatrix from rows padded by 8 elements (free of
// bank conflicts).  Operands that are not bf16 data are split hi + lo and
// multiplied twice (the header says which).
constexpr int TB = 64;              // rows of a key or query tile
constexpr int QMAX = 256;           // the longest chunk: a scan thread a row
constexpr int NBLK = QMAX / 16;     // 16-row blocks of the longest chunk
constexpr int HT_MAX = 16;          // heads of one group per keys / queries block
constexpr int EPT = 32;             // state elements per pass thread (n p <= 8192)
constexpr int LM = TB + 8;          // row stride of an M2 tile in shared memory
constexpr int RING = 3;             // stages of the keys / queries rings, two
                                    // loads in flight ahead of the one in use

struct DimsB {
  int S, H, P, G, N, Q, nc;
  int NP, QT, nT, npair;      // n padded to 16; Q padded to 64; its 64-row
                              // tiles; (q tile, key tile) pairs, q >= key
  int HT, TPG;                // heads per block; head tiles per group
  int E, Eh, GS;              // n p; n p rounded up to a packing group of
                              // 2^GS elements (a head's scratch)
  int TM;                     // rows (and columns) of a stored M2 tile
  int y0, m2rows;             // first (chunk, batch) row of a keys / queries
                              // launch; rows of the M2 scratch (a launch's)
  long long xsb, xst, bsb, bst, csb, cst;   // batch / sequence strides
  int vx, vy, vb, vc, vs;     // 16-byte copies: x, dy, B, C, the states
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// The state pass packs each head's n p elements in place as hi and lo bf16
// halves, in groups of 2^gs elements (64 where n p is a multiple of 64,
// else 8, so a small head is not padded to 64): each group's hi halves,
// then its lo halves, in the group's 4 * 2^gs bytes; a head pads to a whole
// group.  packed_at(e, gs) is the bf16 offset of element e's hi half from
// the head's start; its lo half is 2^gs further.  (gs 6 is ssd_common.cuh's
// hi_at.)
__device__ __forceinline__ long long packed_at(long long e, int gs) {
  return ((e >> gs) << (gs + 1)) + (e & ((1 << gs) - 1));
}

// Inclusive scan of one value per thread over the block: prefix (threads
// <= tid) or suffix (threads >= tid); the values are of one sign.
template <bool SUFFIX>
__device__ float block_scan(float v, float* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = SUFFIX ? __shfl_down_sync(FULL, v, off)
                           : __shfl_up_sync(FULL, v, off);
    if (SUFFIX ? lane + off < 32 : lane >= off) v += o;
  }
  if (lane == (SUFFIX ? 0 : 31)) tmp[warp] = v;
  __syncthreads();
  float add = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    if (SUFFIX ? w > warp : w < warp) add += tmp[w];
  __syncthreads();
  return v + add;
}

// R x cp bf16 tile at dst (row stride ld) from `rows` rows of src (row
// stride rs); zero past rows and past cols.  vec: 16-byte cp.async copies
// (src, rs and cols multiples of 8 elements), else element loads; the
// caller waits and syncs.
__device__ void load_rows(bf16* dst, int ld, const bf16* src, long long rs,
                          int R, int rows, int cp, int cols, bool vec) {
  if (vec) {
    const int ch = cp / 8;
    for (int i = threadIdx.x; i < R * ch; i += THREADS) {
      const int r = i / ch, c = (i - r * ch) * 8;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * ld + c, in ? src + r * rs + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * cp; i += THREADS) {
      const int r = i / cp, c = i - r * cp;
      dst[r * ld + c] = (r < rows && c < cols) ? src[r * rs + c]
                                               : __float2bfloat16(0.f);
    }
  }
}

// Waits until the copies of commit group `ticket` (groups counted from 0 in
// commit order, `issued` of them so far) have landed, then syncs the block:
// they are visible, and every thread is done with what it read before.
__device__ __forceinline__ void wait_ticket(int issued, int ticket) {
  const int newer = issued - 1 - ticket;       // block-uniform
  if (newer >= 3) cp_async_wait<3>();
  else if (newer == 2) cp_async_wait<2>();
  else if (newer == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
  __syncthreads();
}

// NP x cp hi and lo tiles (row stride ld) of one head's packed state, whose
// elements start at `planes` (packed_at); zero past n and p.
__device__ void load_planes(bf16* Sh, bf16* Sl, int ld, int cp,
                            const bf16* planes, const DimsB& d) {
  if (d.vs) {
    const int ch = cp / 8;
    for (int i = threadIdx.x; i < d.NP * ch; i += THREADS) {
      const int r = i / ch, c = (i - r * ch) * 8;
      const bool in = r < d.N && c < d.P;
      const bf16* src = in ? planes + packed_at(r * d.P + c, d.GS) : planes;
      cp_async16(Sh + r * ld + c, src, in ? 16 : 0);
      cp_async16(Sl + r * ld + c, in ? src + (1 << d.GS) : planes, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < d.NP * cp; i += THREADS) {
      const int r = i / cp, c = i - r * cp;
      const bool in = r < d.N && c < d.P;
      const long long at = packed_at(r * d.P + c, d.GS);
      Sh[r * ld + c] = in ? planes[at] : zero;
      Sl[r * ld + c] = in ? planes[at + (1 << d.GS)] : zero;
    }
  }
}

// ---- 1. chunk-local state terms, one block per (chunk, head, batch): the
// state the chunk adds, B^T (x o w), w = dt exp(sum after the row), and the
// state gradient its outputs give, C^T (dy o exp(cum)); the scaled rows
// split hi + lo.  B and x, then C and dy, come in 64-row tiles through a
// two-stage cp.async ring; warp w owns rows 16 w .. + 16 of n.
__host__ __device__ inline int chunk_smem(int NP, int PP) {
  return 2 * 2 * TB * (NP + 8 + PP + 8) + 2 * 2 * TB * (PP + 8) +
         4 * (2 * QMAX + WARPS);
}

template <int PP>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                   float* __restrict__ states, float* __restrict__ dstates,
                   float* __restrict__ tot, DimsB d) {
  constexpr int LX = PP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LB = d.NP + 8, SB = TB * (LB + LX);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* Yh = ring + 2 * SB;
  bf16* Yl = Yh + TB * LX;
  float* wts = reinterpret_cast<float*>(Yl + TB * LX);
  float* ecum = wts + QMAX;
  float* tmp = ecum + QMAX;

  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3, j8 = lane >> 3;
  const int grp = hh / (d.H / d.G), t0 = c * d.Q, nT = d.nT;
  const long long dys = (long long)d.H * d.P;
  const bf16* xb = x + b * d.xsb + (long long)hh * d.P + (long long)t0 * d.xst;
  const bf16* Bb = Bm + b * d.bsb + (long long)grp * d.N + (long long)t0 * d.bst;
  const bf16* Cb = Cm + b * d.csb + (long long)grp * d.N + (long long)t0 * d.cst;
  const bf16* yb = dy + ((long long)b * d.S + t0) * dys + (long long)hh * d.P;
  auto issue = [&](int u) {          // tile u % nT of B, x (u < nT) or C, dy
    if (u < 2 * nT) {
      bf16* Xs = ring + (u & 1) * SB;
      const int k0 = (u % nT) * TB, rows = min(TB, d.Q - k0);
      if (u < nT) {
        load_rows(Xs, LB, Bb + k0 * d.bst, d.bst, TB, rows, d.NP, d.N, d.vb);
        load_rows(Xs + TB * LB, LX, xb + k0 * d.xst, d.xst, TB, rows, PP, d.P,
                  d.vx);
      } else {
        load_rows(Xs, LB, Cb + k0 * d.cst, d.cst, TB, rows, d.NP, d.N, d.vc);
        load_rows(Xs + TB * LB, LX, yb + k0 * dys, dys, TB, rows, PP, d.P,
                  d.vy);
      }
    }
    cp_async_commit();
  };
  issue(0);

  // w_t = dt_t exp(sum after t), e_t = exp(sum up to t); 0 past Q
  const float a = A[hh];
  const float* dtb = dt + ((long long)b * d.S + t0) * d.H + hh;
  const float dtv = tid < d.Q ? dtb[(long long)tid * d.H] : 0.f;
  const float nxt = tid + 1 < d.Q ? dtb[(long long)(tid + 1) * d.H] * a : 0.f;
  const float after = block_scan<true>(nxt, tmp);
  const float cum = block_scan<false>(dtv * a, tmp);
  wts[tid] = dtv * expf(after);
  ecum[tid] = tid < d.Q ? expf(cum) : 0.f;
  if (tid == 0) tot[((long long)b * d.nc + c) * d.H + hh] = dtv * a + after;

  const int m0 = 16 * warp;
  float acc[PP / 8][4];
  for (int u = 0; u < 2 * nT; ++u) {
    if (u % nT == 0) {
#pragma unroll
      for (int i = 0; i < PP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    issue(u + 1);
    cp_async_wait<1>();
    __syncthreads();                 // tile u landed; the factors are written
    const bf16* Xs = ring + (u & 1) * SB;
    const bf16* Yr = Xs + TB * LB;
    const float* f = (u < nT ? wts : ecum) + (u % nT) * TB;
    for (int i = tid; i < TB * (PP / 8); i += THREADS) {
      const int r = i / (PP / 8), c8 = (i - r * (PP / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(Yr + r * LX + c8);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      const float w = f[r];
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split2(__bfloat162float(e[2 * j]) * w,
               __bfloat162float(e[2 * j + 1]) * w, hi[j], lo[j]);
      *reinterpret_cast<uint4*>(Yh + r * LX + c8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Yl + r * LX + c8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
    if (m0 < d.NP) {
#pragma unroll
      for (int ks = 0; ks < TB; ks += 16) {
        // A = X^T (rows n, columns rows of the chunk): transposed 8x8 blocks
        uint32_t af[4];
        ldsm_x4_t(af, Xs + (ks + (j8 >> 1) * 8 + (lane & 7)) * LB + m0 + (j8 & 1) * 8);
        const int yr = ks + (j8 & 1) * 8 + (lane & 7);
#pragma unroll
        for (int pn = 0; pn < PP / 8; pn += 2) {
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, Yh + yr * LX + pn * 8 + (j8 >> 1) * 8);
          ldsm_x4_t(bl, Yl + yr * LX + pn * 8 + (j8 >> 1) * 8);
          mma(acc[pn], af, bh[0], bh[1]);
          mma(acc[pn + 1], af, bh[2], bh[3]);
          mma(acc[pn], af, bl[0], bl[1]);
          mma(acc[pn + 1], af, bl[2], bl[3]);
        }
      }
      if (u % nT == nT - 1) {
        float* out = (u < nT ? states : dstates) +
                     ((long long)b * d.nc + c) * d.H * d.Eh + (long long)hh * d.Eh;
#pragma unroll
        for (int pn = 0; pn < PP / 8; ++pn)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int n = m0 + g8 + 8 * r, p = pn * 8 + 2 * t4;
            if (n >= d.N) continue;
            float* o = out + n * d.P + p;
            if (p + 1 < d.P && (d.P & 1) == 0) {
              *reinterpret_cast<float2*>(o) = make_float2(acc[pn][2 * r], acc[pn][2 * r + 1]);
            } else {
              if (p < d.P) o[0] = acc[pn][2 * r];
              if (p + 1 < d.P) o[1] = acc[pn][2 * r + 1];
            }
          }
      }
    }
    __syncthreads();                 // the stage and Yh, Yl are refilled
  }
  cp_async_wait<0>();
}

// ---- 2. state pass, one block per (head, batch); thread t owns elements
// 4 (t + 256 i) .. + 4 of the head's n x p (where n p is a multiple of 4;
// else t + 256 i, V = 1).  Backward from dstate: G_{c-1} = exp(total_c)
// G_c + dstates_c, writing G_c (the gradient of the state leaving chunk c)
// hi + lo over dstates_c, and dinit.  Then forward from init: S_c =
// exp(total_c) S_{c-1} + states_c, writing S_{c-1} (the state entering
// chunk c) hi + lo over states_c, and <S_c, G_c> (G_c as hi + lo) summed
// over the block in a fixed order.  A packing group of a head is read by
// all its threads before any writes over it (a block barrier).
template <int V>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_pass(float* __restrict__ states, float* __restrict__ dstates,
             const float* __restrict__ tot, const float* __restrict__ init,
             const float* __restrict__ dstate, float* __restrict__ delta,
             float* __restrict__ dinit, DimsB d) {
  constexpr int NI = EPT / V;                  // element vectors a thread
  __shared__ float red[WARPS];
  const int hh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long head = ((long long)b * d.H + hh) * d.E;
  const long long rowlen = (long long)d.H * d.Eh;
  auto at = [&](float* base, int c) {
    return base + ((long long)b * d.nc + c) * rowlen + (long long)hh * d.Eh;
  };
  auto first = [&](int i) { return V * (tid + THREADS * i); };
  // V consecutive floats at p + e (16-byte aligned where V = 4)
  auto load = [&](const float* p, int e, float (&v)[V]) {
    if constexpr (V == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + e);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
      v[0] = p[e];
    }
  };
  // hi and lo halves of elements e .. e + V - 1 into their packed places
  auto pack = [&](bf16* pl, int e, const float (&v)[V]) {
    if constexpr (V == 4) {
      uint32_t h0, l0, h1, l1;
      split2(v[0], v[1], h0, l0);
      split2(v[2], v[3], h1, l1);
      *reinterpret_cast<uint2*>(pl + packed_at(e, d.GS)) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(pl + packed_at(e, d.GS) + (1 << d.GS)) =
          make_uint2(l0, l1);
    } else {
      const bf16 hi = __float2bfloat16(v[0]);
      pl[packed_at(e, d.GS)] = hi;
      pl[packed_at(e, d.GS) + (1 << d.GS)] =
          __float2bfloat16(v[0] - __bfloat162float(hi));
    }
  };
  float v[NI][V], nx[NI][V];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if (dstate && first(i) < d.E) {
      load(dstate + head, first(i), v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[i][k] = 0.f;
    }
  }
  for (int c = d.nc - 1; c >= 0; --c) {
    float* base = at(dstates, c);
    const float decay = expf(tot[((long long)b * d.nc + c) * d.H + hh]);
#pragma unroll
    for (int i = 0; i < NI; ++i)
      if (first(i) < d.E) load(base, first(i), nx[i]);
    __syncthreads();
    bf16* pl = reinterpret_cast<bf16*>(base);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (first(i) >= d.E) continue;
      pack(pl, first(i), v[i]);
#pragma unroll
      for (int k = 0; k < V; ++k) v[i][k] = v[i][k] * decay + nx[i][k];
    }
  }
  if (dinit) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (first(i) >= d.E) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) dinit[head + first(i) + k] = v[i][k];
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if (init && first(i) < d.E) {
      load(init + head, first(i), v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[i][k] = 0.f;
    }
  }
  for (int c = 0; c < d.nc; ++c) {
    float* base = at(states, c);
    const bf16* g = reinterpret_cast<const bf16*>(at(dstates, c));
    const float decay = expf(tot[((long long)b * d.nc + c) * d.H + hh]);
#pragma unroll
    for (int i = 0; i < NI; ++i)
      if (first(i) < d.E) load(base, first(i), nx[i]);
    __syncthreads();
    bf16* pl = reinterpret_cast<bf16*>(base);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (first(i) >= d.E) continue;
      pack(pl, first(i), v[i]);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const long long at_e = packed_at(first(i) + k, d.GS);
        v[i][k] = v[i][k] * decay + nx[i][k];
        part += v[i][k] * (__bfloat162float(g[at_e]) +
                           __bfloat162float(g[at_e + (1 << d.GS)]));
      }
    }
    const float s = block_sum(part, red);
    if (tid == 0) delta[((long long)b * d.nc + c) * d.H + hh] = s;
  }
}

// Shared layout (bytes) of the keys kernel; ops.py::bwd_bf16_plan mirrors it.
struct KeysLayout { int bk, cb, xk, ds, ring, stage, dtv, tab, dots, cols, total; };

__host__ __device__ inline KeysLayout keys_layout(int NP, int PP, int nT) {
  const int LB = NP + 8, LX = PP + 8;
  KeysLayout l;
  int o = 0;
  l.bk = o;    o += 2 * TB * LB;             // the key tile's B rows
  l.cb = o;    o += 4 * nT * TB * TB;        // C B^T per q tile (fragments)
  l.xk = o;    o += 2 * 2 * TB * LX;         // x rows, two heads
  l.ds = o;    o += 2 * 2 * NP * LX;         // dS hi, lo
  l.stage = 2 * TB * (LB + LX);              // C rows, dy rows of a q tile
  l.ring = o;  o += RING * l.stage;
  l.dtv = o;   o += 4 * 2 * QMAX;            // dt of the chunk, two heads
  // dt A; exp of: the 16-row block's sum up to each row, the sum after
  // each of the tile's rows in its block, the sums between blocks, the
  // sum after each of the tile's rows in the chunk
  l.tab = o;   o += 4 * (2 * QMAX + NBLK * NBLK + 2 * TB);
  l.dots = o;  o += 4 * 2 * 3 * TB;          // the rows' three dots, two halves
  l.cols = o;  o += 4 * nT * 4 * TB;         // column sums of S per q tile, warp
  l.total = o;
  return l;
}

// exp(sum of dt A over chunk rows k+1 .. q) for k <= q in one 16-row block
// (a running sum: its terms are of one sign), 0 for k > q.
__device__ __forceinline__ float decay_in_block(const float* av, int k, int q) {
  if (k > q) return 0.f;
  float s = 0.f;
  for (int u = k + 1; u <= q; ++u) s += av[u];
  return expf(s);
}

// ---- 3. keys, one block per (tile of up to 16 heads of one group, chunk,
// batch, 64-row key tile; the key tiles with the most q tiles after them
// launch first): C B^T against every q tile at or after the key tile
// once, kept in shared memory for every head of the block.  Per head, with
// the next loads in flight (one ahead): the state terms dx' = exp(after)
// B dS and dB = dt exp(after) x dS^T; then per q tile dy x^T once, M1 =
// C B^T o L and M2 = dy x'^T o L (hi + lo), dx' += M1^T dy, dB += M2^T C,
// and M2 written to scratch for the queries kernel; at the head's end dx,
// x . dx' (ddt's direct part) and -x' . dx' (d cum's key part).  dB sums
// over the block's heads.  Warp w owns key rows 16 (w % 4) .. + 16 and half
// w / 4 of the columns of dx' and dB (the scores of its rows in full).
template <int PP, bool WHOLE>   // WHOLE: M2 tiles of 64 x 64 (TM == TB)
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_keys_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                  const float* __restrict__ grads, bf16* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dcum,
                  float* __restrict__ dBp, bf16* __restrict__ m2,
                  float* __restrict__ colpart, DimsB d) {
  constexpr int LX = PP + 8, HP = PP / 16;     // p n8-tiles of a half
  const int TM = WHOLE ? TB : d.TM;             // rows of a stored M2 tile
  constexpr int NT8 = 8;                       // n n8-tiles of a half, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LB = d.NP + 8, HN = d.NP / 16;     // n n8-tiles of a half
  const KeysLayout L = keys_layout(d.NP, PP, d.nT);
  bf16* Bk = reinterpret_cast<bf16*>(smem_raw + L.bk);
  float* CBs = reinterpret_cast<float*>(smem_raw + L.cb);
  bf16* Xk0 = reinterpret_cast<bf16*>(smem_raw + L.xk);
  bf16* dSh = reinterpret_cast<bf16*>(smem_raw + L.ds);
  bf16* dSl = dSh + d.NP * LX;
  float* dtv0 = reinterpret_cast<float*>(smem_raw + L.dtv);
  float* av = reinterpret_cast<float*>(smem_raw + L.tab);
  float* eL = av + QMAX;
  float* er = eL + QMAX;
  float* btw = er + TB;
  float* ea = btw + NBLK * NBLK;
  float* dots = reinterpret_cast<float*>(smem_raw + L.dots);
  float* cols = reinterpret_cast<float*>(smem_raw + L.cols);
  auto stage = [&](int i) {
    return reinterpret_cast<bf16*>(smem_raw + L.ring + (i % RING) * L.stage);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3, j8 = lane >> 3;
  const int rg = warp & 3, half = warp >> 2;
  const int ik = blockIdx.z, npair = d.nT - ik;  // the most pairs first
  const int hpg = d.H / d.G, grp = blockIdx.x / d.TPG;
  const int h_first = grp * hpg + (blockIdx.x % d.TPG) * d.HT;
  const int nh = min(d.HT, (grp + 1) * hpg - h_first);
  const int y = blockIdx.y + d.y0, c = y % d.nc, b = y / d.nc, t0 = c * d.Q;
  const int k0 = ik * TB, krows = min(TB, d.Q - k0);
  const long long dys = (long long)d.H * d.P;
  const bf16* Bb = Bm + b * d.bsb + (long long)grp * d.N + (long long)t0 * d.bst;
  const bf16* Cb = Cm + b * d.csb + (long long)grp * d.N + (long long)t0 * d.cst;
  const float* dtb = dt + ((long long)b * d.S + t0) * d.H;
  const long long srow = ((long long)b * d.nc + c) * d.H * d.Eh;

  // Two streams of cp.async loads.  The ring, two loads ahead of its use:
  // the C tiles of the q tiles (the first with the key tile's B), then per
  // head its q tiles' C and dy rows.  Per head its x rows, dS and dt, issued
  // once the previous head's state terms are done with dS.
  const int nring = npair + nh * npair;
  int issued = 0, ring_t[RING], xs_t[2];
  auto issue_ring = [&](int r) {
    if (r < nring) {
      bf16* st = stage(r);
      if (r < npair) {
        const int q0 = (ik + r) * TB;
        if (r == 0)
          load_rows(Bk, LB, Bb + (long long)k0 * d.bst, d.bst, TB, krows, d.NP, d.N, d.vb);
        load_rows(st, LB, Cb + (long long)q0 * d.cst, d.cst, TB,
                  min(TB, d.Q - q0), d.NP, d.N, d.vc);
      } else {
        const int j = (r - npair) / npair, hh = h_first + j;
        const int q0 = (ik + (r - npair) % npair) * TB, qr = min(TB, d.Q - q0);
        load_rows(st, LB, Cb + (long long)q0 * d.cst, d.cst, TB, qr, d.NP, d.N, d.vc);
        load_rows(st + TB * LB, LX, dy + ((long long)b * d.S + t0 + q0) * dys + (long long)hh * d.P,
                  dys, TB, qr, PP, d.P, d.vy);
      }
    }
    cp_async_commit();
    ring_t[r % RING] = issued++;
  };
  auto issue_xs = [&](int j) {
    if (j < nh) {
      const int hh = h_first + j;
      load_rows(Xk0 + (j & 1) * TB * LX, LX,
                x + b * d.xsb + (long long)(t0 + k0) * d.xst + (long long)hh * d.P,
                d.xst, TB, krows, PP, d.P, d.vx);
      load_planes(dSh, dSl, LX, PP,
                  reinterpret_cast<const bf16*>(grads + srow + (long long)hh * d.Eh), d);
      float* dtv = dtv0 + (j & 1) * QMAX;
      for (int t = tid; t < d.QT; t += THREADS)
        cp_async4(dtv + t, dtb + (long long)min(t, d.Q - 1) * d.H + hh,
                  t < d.Q ? 4 : 0);
    }
    cp_async_commit();
    xs_t[j & 1] = issued++;
  };
  issue_xs(0);
  issue_ring(0);
  issue_ring(1);
  auto next_ring = [&](int r) {      // ring load r is usable; r + 2 issued
    wait_ticket(issued, ring_t[r % RING]);
    issue_ring(r + 2);
  };

  // C B^T: warp (rg, half) computes key rows 16 rg .. + 16 against q rows
  // 32 half .. + 32 of each q tile and keeps them in fragment order
  const bf16* brow = Bk + (16 * rg + (lane & 15)) * LB + (lane >> 4) * 8;
  for (int u = 0; u < npair; ++u) {
    next_ring(u);
    const bf16* Cq = stage(u);
    float acc[4][4] = {};
    for (int ks = 0; ks < d.NP; ks += 16) {
      uint32_t af[4];
      ldsm_x4(af, brow + ks);
#pragma unroll
      for (int qn = 0; qn < 4; qn += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, Cq + (32 * half + qn * 8 + (lane >> 4) * 8 + (lane & 7)) * LB +
                        ks + (j8 & 1) * 8);
        mma(acc[qn], af, bf[0], bf[1]);
        mma(acc[qn + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int qn = 0; qn < 4; ++qn)
      reinterpret_cast<float4*>(CBs)[((u * 4 + rg) * 8 + 4 * half + qn) * 32 + lane] =
          make_float4(acc[qn][0], acc[qn][1], acc[qn][2], acc[qn][3]);
  }

  const int r0 = 16 * rg + g8, r1 = r0 + 8;    // this thread's key rows
  const int kb = k0 / 16 + rg;                 // their 16-row block
  float dbs[NT8][4] = {};                      // dB over the block's heads
  for (int j = 0; j < nh; ++j) {
    const int hh = h_first + j;
    const float a = A[hh];
    wait_ticket(issued, xs_t[j & 1]);         // x rows, dS, dt of head j
    const bf16* Xk = Xk0 + (j & 1) * TB * LX;
    const float* dtv = dtv0 + (j & 1) * QMAX;
    // the head's decay tables, by warp 0 in registers: lane L holds rows
    // 8 L .. + 8, two lanes a 16-row block; every sum adds terms of one sign
    if (warp == 0) {
      float v[8], pre[8], suf[8], run = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * lane + i;
        v[i] = t < d.QT ? dtv[t] * a : 0.f;
        av[t] = v[i];
        run += v[i];
        pre[i] = run;
      }
      const float tot = run;
      run = 0.f;
#pragma unroll
      for (int i = 7; i >= 0; --i) {
        suf[i] = run;
        run += v[i];
      }
      const float other = __shfl_xor_sync(FULL, tot, 1);   // the block's other lane
      const bool odd = lane & 1;
      float bl[NBLK];                          // every 16-row block's sum
#pragma unroll
      for (int m = 0; m < NBLK; ++m) bl[m] = __shfl_sync(FULL, tot + other, 2 * m);
      float later = 0.f;                       // the blocks after this lane's
#pragma unroll
      for (int m = 0; m < NBLK; ++m)
        if (m > (lane >> 1)) later += bl[m];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * lane + i;
        eL[t] = expf(pre[i] + (odd ? other : 0.f));
        if (t >= k0 && t < k0 + TB) {
          const float after = suf[i] + (odd ? 0.f : other);
          er[t - k0] = expf(after);
          ea[t - k0] = expf(after + later);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {            // exp of the blocks strictly
        const int e = 8 * lane + u, i = e >> 4, jj = e & 15;   // between i, jj
        float sb = 0.f;
#pragma unroll
        for (int m = 0; m < NBLK; ++m)
          if (m > i && m < jj) sb += bl[m];
        btw[i * NBLK + jj] = expf(sb);
      }
    }
    __syncthreads();
    // the decay of a q row in a later 16-row block than the key is the
    // product of er (the key's block after it), btw (the blocks between)
    // and eL (the row's block up to it), each <= 1
    const float dk0 = dtv[k0 + r0], dk1 = dtv[k0 + r1];
    const float rk0 = er[r0], rk1 = er[r1];

    // state terms: dx' = exp(after) B dS (K = n), dB = dt exp(after) x dS^T
    // (K = p), dS hi + lo
    float dxa[HP][4] = {};
    for (int ks = 0; ks < d.NP; ks += 16) {
      uint32_t af[4];
      ldsm_x4(af, brow + ks);
      const bf16* sh = dSh + (ks + (j8 & 1) * 8 + (lane & 7)) * LX + half * (PP / 2);
      const bf16* sl = dSl + (ks + (j8 & 1) * 8 + (lane & 7)) * LX + half * (PP / 2);
      if constexpr (HP == 1) {
        uint32_t bh[2], bl[2];
        ldsm_x2_t(bh, sh);
        ldsm_x2_t(bl, sl);
        mma(dxa[0], af, bh[0], bh[1]);
        mma(dxa[0], af, bl[0], bl[1]);
      } else {
#pragma unroll
        for (int pn = 0; pn < HP; pn += 2) {
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, sh + pn * 8 + (j8 >> 1) * 8);
          ldsm_x4_t(bl, sl + pn * 8 + (j8 >> 1) * 8);
          mma(dxa[pn], af, bh[0], bh[1]);
          mma(dxa[pn + 1], af, bh[2], bh[3]);
          mma(dxa[pn], af, bl[0], bl[1]);
          mma(dxa[pn + 1], af, bl[2], bl[3]);
        }
      }
    }
    const float e0 = ea[r0], e1 = ea[r1];
    // x . dx' of the state term alone, and below the intra sums of S
    float sd0 = 0.f, sd1 = 0.f, rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int pn = 0; pn < HP; ++pn) {
      dxa[pn][0] *= e0; dxa[pn][1] *= e0;
      dxa[pn][2] *= e1; dxa[pn][3] *= e1;
      const int p = half * (PP / 2) + pn * 8 + 2 * t4;
      const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xk + r0 * LX + p));
      const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xk + r1 * LX + p));
      sd0 += x0.x * dxa[pn][0] + x0.y * dxa[pn][1];
      sd1 += x1.x * dxa[pn][2] + x1.y * dxa[pn][3];
    }
    const bf16* xrow = Xk + (16 * rg + (lane & 15)) * LX + (lane >> 4) * 8;
    float dbh[NT8][4] = {};
    // B operand rows n (K = p contiguous) of this half's n-tiles
    auto nt_pairs = [&](const bf16* base, int ldb, int kofs, auto&& body) {
#pragma unroll
      for (int nn = 0; nn < NT8; nn += 2) {
        if (nn + 1 < HN) {
          uint32_t f[4];
          ldsm_x4(f, base + (half * HN * 8 + nn * 8 + (lane >> 4) * 8 + (lane & 7)) * ldb +
                         kofs + (j8 & 1) * 8);
          body(nn, f[0], f[1]);
          body(nn + 1, f[2], f[3]);
        } else if (nn < HN) {
          uint32_t f[2];
          ldsm_x2(f, base + (half * HN * 8 + nn * 8 + (lane & 7)) * ldb + kofs +
                         ((lane >> 3) & 1) * 8);
          body(nn, f[0], f[1]);
        }
      }
    };
    for (int ks = 0; ks < PP; ks += 16) {
      uint32_t af[4];
      ldsm_x4(af, xrow + ks);
      nt_pairs(dSh, LX, ks, [&](int nn, uint32_t b0, uint32_t b1) { mma(dbh[nn], af, b0, b1); });
      nt_pairs(dSl, LX, ks, [&](int nn, uint32_t b0, uint32_t b1) { mma(dbh[nn], af, b0, b1); });
    }
    const float f0 = dk0 * e0, f1 = dk1 * e1;
#pragma unroll
    for (int nn = 0; nn < NT8; ++nn) {
      dbh[nn][0] *= f0; dbh[nn][1] *= f0;
      dbh[nn][2] *= f1; dbh[nn][3] *= f1;
    }
    __syncthreads();                           // dS is free
    issue_xs(j + 1);

    for (int i = 0; i < npair; ++i) {
      next_ring(npair + j * npair + i);        // C, dy rows of q tile ik + i
      const int iq = ik + i, q0 = iq * TB;
      const bf16* Cq = stage(npair + j * npair + i);
      const bf16* Dq = Cq + TB * LB;
      // dy x^T: key rows of the warp against the tile's 64 q rows (K = p)
      float xd[8][4] = {};
#pragma unroll
      for (int ks = 0; ks < PP; ks += 16) {
        uint32_t af[4];
        ldsm_x4(af, xrow + ks);
#pragma unroll
        for (int qn = 0; qn < 8; qn += 2) {
          uint32_t bf[4];
          ldsm_x4(bf, Dq + (qn * 8 + (lane >> 4) * 8 + (lane & 7)) * LX + ks + (j8 & 1) * 8);
          mma(xd[qn], af, bf[0], bf[1]);
          mma(xd[qn + 1], af, bf[2], bf[3]);
        }
      }
      bf16* mt = m2 + (((long long)blockIdx.y * d.H + hh) * d.npair +
                       iq * (iq + 1) / 2 + ik) * 2 * TM * TM;
      const float4* cbf = reinterpret_cast<const float4*>(CBs) + (i * 4 + rg) * 8 * 32 + lane;
      // (1) every score's decay; M1 = C B^T o L and M2 = dy x'^T o L as A
      // fragments (hi, lo) of the four 16-row steps of q; this half's share
      // of M2 to the scratch, of S = (C B^T) o M2 to the sums over q (row
      // sums) and over the keys (cs: partial column sums of two rows)
      uint32_t mh[4][2][4], ml[4][2][4];       // [step][M1, M2][fragment]
      float cs[8];                             // [step of the half][q tile][column]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // rows r0, r1 are in key block kb; q block qb after it: er btw eL;
        // in kb a running sum; before it 0
        const int qb = q0 / 16 + kk;
        const float bt = qb > kb ? btw[kb * NBLK + qb] : 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qt = 2 * kk + u, q = q0 + qt * 8 + 2 * t4;
          float l[2][2];
          if (qb > kb) {
            const float2 el = *reinterpret_cast<const float2*>(eL + q);
            l[0][0] = rk0 * bt * el.x; l[0][1] = rk0 * bt * el.y;
            l[1][0] = rk1 * bt * el.x; l[1][1] = rk1 * bt * el.y;
          } else if (qb == kb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              l[0][e] = decay_in_block(av, k0 + r0, q + e);
              l[1][e] = decay_in_block(av, k0 + r1, q + e);
            }
          } else {
            l[0][0] = l[0][1] = l[1][0] = l[1][1] = 0.f;
          }
          const float4 cb = cbf[qt * 32];
          const float m00 = xd[qt][0] * l[0][0] * dk0, m01 = xd[qt][1] * l[0][1] * dk0;
          const float m10 = xd[qt][2] * l[1][0] * dk1, m11 = xd[qt][3] * l[1][1] * dk1;
          split2(cb.x * l[0][0], cb.y * l[0][1], mh[kk][0][2 * u], ml[kk][0][2 * u]);
          split2(cb.z * l[1][0], cb.w * l[1][1], mh[kk][0][2 * u + 1], ml[kk][0][2 * u + 1]);
          split2(m00, m01, mh[kk][1][2 * u], ml[kk][1][2 * u]);
          split2(m10, m11, mh[kk][1][2 * u + 1], ml[kk][1][2 * u + 1]);
          if ((kk >> 1) == half) {
            // S in fp32: d cum's intra terms with one rounding of each score
            const float s00 = cb.x * m00, s01 = cb.y * m01;
            const float s10 = cb.z * m10, s11 = cb.w * m11;
            rs0 += s00 + s01;
            rs1 += s10 + s11;
            cs[(kk & 1) * 4 + u * 2] = s00 + s10;
            cs[(kk & 1) * 4 + u * 2 + 1] = s01 + s11;
            if (WHOLE || (16 * kk < TM && 16 * rg < TM)) {   // else past the chunk
              uint32_t* h0 = reinterpret_cast<uint32_t*>(mt + r0 * TM + qt * 8 + 2 * t4);
              uint32_t* h1 = reinterpret_cast<uint32_t*>(mt + r1 * TM + qt * 8 + 2 * t4);
              h0[0] = mh[kk][1][2 * u];
              h1[0] = mh[kk][1][2 * u + 1];
              h0[TM * TM / 2] = ml[kk][1][2 * u];
              h1[TM * TM / 2] = ml[kk][1][2 * u + 1];
            }
          }
        }
      }
      // (2) the column sums over the warp's 16 key rows: a butterfly over
      // the lanes' row bits, each round keeping half the values; lane
      // (bits 4, 3, 2 = step, q tile, column) ends with one column's sum
      {
        const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
        float r1[4], r2[2];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          r1[w] = (b4 ? cs[4 + w] : cs[w]) +
                  __shfl_xor_sync(FULL, b4 ? cs[w] : cs[4 + w], 16);
#pragma unroll
        for (int w = 0; w < 2; ++w)
          r2[w] = (b3 ? r1[2 + w] : r1[w]) +
                  __shfl_xor_sync(FULL, b3 ? r1[w] : r1[2 + w], 8);
        const float cv = (b2 ? r2[1] : r2[0]) +
                         __shfl_xor_sync(FULL, b2 ? r2[0] : r2[1], 4);
        const int col = (2 * half + (b4 ? 1 : 0)) * 16 + (b3 ? 8 : 0) + 2 * t4 + (b2 ? 1 : 0);
        cols[(i * 4 + rg) * TB + col] = cv;
      }
      // (3) dx' += M1^T dy (this half's p), dB += M2^T C (this half's n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (q0 / 16 + kk < kb) continue;       // k > q throughout: zeros
        const int qr = 16 * kk + (j8 & 1) * 8 + (lane & 7);
        if constexpr (HP == 1) {
          uint32_t bq[2];
          ldsm_x2_t(bq, Dq + qr * LX + half * (PP / 2));
          mma(dxa[0], mh[kk][0], bq[0], bq[1]);
          mma(dxa[0], ml[kk][0], bq[0], bq[1]);
        } else {
#pragma unroll
          for (int pn = 0; pn < HP; pn += 2) {
            uint32_t bq[4];
            ldsm_x4_t(bq, Dq + qr * LX + half * (PP / 2) + pn * 8 + (j8 >> 1) * 8);
            mma(dxa[pn], mh[kk][0], bq[0], bq[1]);
            mma(dxa[pn + 1], mh[kk][0], bq[2], bq[3]);
            mma(dxa[pn], ml[kk][0], bq[0], bq[1]);
            mma(dxa[pn + 1], ml[kk][0], bq[2], bq[3]);
          }
        }
#pragma unroll
        for (int nn = 0; nn < NT8; nn += 2) {
          if (nn + 1 < HN) {
            uint32_t bq[4];
            ldsm_x4_t(bq, Cq + qr * LB + half * HN * 8 + nn * 8 + (j8 >> 1) * 8);
            mma(dbh[nn], mh[kk][1], bq[0], bq[1]);
            mma(dbh[nn + 1], mh[kk][1], bq[2], bq[3]);
            mma(dbh[nn], ml[kk][1], bq[0], bq[1]);
            mma(dbh[nn + 1], ml[kk][1], bq[2], bq[3]);
          } else if (nn < HN) {
            uint32_t bq[2];
            ldsm_x2_t(bq, Cq + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * LB +
                              half * HN * 8 + nn * 8);
            mma(dbh[nn], mh[kk][1], bq[0], bq[1]);
            mma(dbh[nn], ml[kk][1], bq[0], bq[1]);
          }
        }
      }
    }

    // the head's rows: dx = dt dx'; x . dx' (ddt's direct part) and
    // -dt x . dx' (d cum's key part), the halves' sums meeting in `dots`
    float s0 = 0.f, s1 = 0.f;
    bf16* dxb = dx + ((long long)b * d.S + t0 + k0) * dys + (long long)hh * d.P;
#pragma unroll
    for (int pn = 0; pn < HP; ++pn) {
      const int p = half * (PP / 2) + pn * 8 + 2 * t4;
      const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xk + r0 * LX + p));
      const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Xk + r1 * LX + p));
      s0 += x0.x * dxa[pn][0] + x0.y * dxa[pn][1];
      s1 += x1.x * dxa[pn][2] + x1.y * dxa[pn][3];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? r1 : r0;
        if (row >= krows) continue;
        const float dk = r ? dk1 : dk0;
        bf16* o = dxb + (long long)row * dys + p;
        if (p + 1 < d.P && (d.P & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(dk * dxa[pn][2 * r], dk * dxa[pn][2 * r + 1]);
        } else {
          if (p < d.P) o[0] = __float2bfloat16(dk * dxa[pn][2 * r]);
          if (p + 1 < d.P) o[1] = __float2bfloat16(dk * dxa[pn][2 * r + 1]);
        }
      }
    }
    float v6[6] = {s0, s1, sd0, sd1, rs0, rs1};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      v6[e] += __shfl_xor_sync(FULL, v6[e], 1);
      v6[e] += __shfl_xor_sync(FULL, v6[e], 2);
    }
    if (t4 == 0) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        dots[(half * 3 + e) * TB + r0] = v6[2 * e];
        dots[(half * 3 + e) * TB + r1] = v6[2 * e + 1];
      }
    }
#pragma unroll
    for (int nn = 0; nn < NT8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dbs[nn][e] += dbh[nn][e];
    __syncthreads();
    if (tid < krows) {
      // ddt's direct part x . dx'; d cum's key part -x' . dx' = -(the
      // keys' sum of S + dt x . dx' of the state term); a chunk of one
      // tile adds C . dC's intra part of the same rows (the warps' column
      // sums) here, with no partials
      const float* dh = dots + 3 * TB;
      const long long o = ((long long)b * d.S + t0 + k0 + tid) * d.H + hh;
      ddt[o] = dots[tid] + dh[tid];
      float v = -(dots[2 * TB + tid] + dh[2 * TB + tid] +
                  dtv[k0 + tid] * (dots[TB + tid] + dh[TB + tid]));
      if (d.nT == 1) v += cols[tid] + cols[TB + tid] + cols[2 * TB + tid] + cols[3 * TB + tid];
      dcum[o] = v;
    }
    // C . dC's intra part of the q rows from this key tile: the warps'
    // column sums in a fixed order, one partial per key tile
    for (int e = tid; e < npair * TB && d.nT > 1; e += THREADS) {
      const int i = e / TB, col = e - i * TB, q = (ik + i) * TB + col;
      if (q >= d.Q) continue;
      const float* cw = cols + i * 4 * TB + col;
      colpart[(((long long)b * d.S + t0 + q) * d.H + hh) * d.nT + ik] =
          cw[0] + cw[TB] + cw[2 * TB] + cw[3 * TB];
    }
  }
  cp_async_wait<0>();
  // dB summed over the block's heads: one partial per head tile
  float* out = dBp + (((long long)b * d.S + t0 + k0) * (d.G * d.TPG) + blockIdx.x) * d.N;
  const long long ost = (long long)d.G * d.TPG * d.N;
#pragma unroll
  for (int nn = 0; nn < NT8; ++nn) {
    if (nn >= HN) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0, n = half * HN * 8 + nn * 8 + 2 * t4;
      if (row >= krows) continue;
      if (n < d.N) out[row * ost + n] = dbs[nn][2 * r];
      if (n + 1 < d.N) out[row * ost + n + 1] = dbs[nn][2 * r + 1];
    }
  }
}

// Shared layout (bytes) of the queries kernel; ops.py::bwd_bf16_plan
// mirrors it.
struct QueriesLayout { int cq, bk, dy, sp, ring, stage, dtv, tab, dots, total; };

__host__ __device__ inline QueriesLayout queries_layout(int NP, int PP, int nT) {
  const int LB = NP + 8, LX = PP + 8;
  QueriesLayout l;
  int o = 0;
  l.cq = o;    o += 2 * TB * LB;             // the q tile's C rows
  l.bk = o;    o += 2 * nT * TB * LB;        // B rows of the key tiles
  l.dy = o;    o += 2 * TB * LX;             // dy rows of a head
  l.sp = o;    o += 2 * 2 * NP * LX;         // S_prev hi, lo
  l.stage = 2 * 2 * TB * LM;                 // an M2 tile, hi and lo
  l.ring = o;  o += RING * l.stage;
  l.dtv = o;   o += 4 * QMAX;                // dt of the chunk
  l.tab = o;   o += 4 * (TB + WARPS);        // exp(cum) of the tile's rows
  l.dots = o;  o += 4 * 2 * TB;
  l.total = o;
  return l;
}

// ---- 4. queries, one block per (head tile, chunk, batch, 64-row q tile;
// the last q tiles, with the most key tiles, launch first):
// per head the state term dC = exp(cum) dy S_prev^T, then against every key
// tile at or before the q tile dC += M2 B with the keys kernel's M2 (hi +
// lo); C . dC (d cum's query part) added per row; dC summed over the heads.
// Warp w owns q rows 16 (w % 4) .. + 16 and half w / 4 of dC's columns.
template <int PP, bool WHOLE>   // WHOLE: M2 tiles of 64 x 64 (TM == TB)
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_queries_bf16(const float* __restrict__ dt, const float* __restrict__ A,
                     const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                     const bf16* __restrict__ dy, const float* __restrict__ prev,
                     const bf16* __restrict__ m2, float* __restrict__ dcum,
                     float* __restrict__ dCp, DimsB d) {
  constexpr int LX = PP + 8, NT8 = 8;
  const int TM = WHOLE ? TB : d.TM;             // rows of a stored M2 tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LB = d.NP + 8, HN = d.NP / 16;
  const QueriesLayout L = queries_layout(d.NP, PP, d.nT);
  bf16* Cq = reinterpret_cast<bf16*>(smem_raw + L.cq);
  bf16* Bk = reinterpret_cast<bf16*>(smem_raw + L.bk);
  bf16* Dy = reinterpret_cast<bf16*>(smem_raw + L.dy);
  bf16* Sh = reinterpret_cast<bf16*>(smem_raw + L.sp);
  bf16* Sl = Sh + d.NP * LX;
  float* dtv = reinterpret_cast<float*>(smem_raw + L.dtv);
  float* ecum = reinterpret_cast<float*>(smem_raw + L.tab);
  float* tmp = ecum + TB;
  float* dots = reinterpret_cast<float*>(smem_raw + L.dots);
  auto stage = [&](int i) {
    return reinterpret_cast<bf16*>(smem_raw + L.ring + (i % RING) * L.stage);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3, j8 = lane >> 3;
  const int rg = warp & 3, half = warp >> 2;
  const int iq = d.nT - 1 - blockIdx.z, q0 = iq * TB;   // the most pairs first
  const int hpg = d.H / d.G, grp = blockIdx.x / d.TPG;
  const int h_first = grp * hpg + (blockIdx.x % d.TPG) * d.HT;
  const int nh = min(d.HT, (grp + 1) * hpg - h_first);
  const int y = blockIdx.y + d.y0, c = y % d.nc, b = y / d.nc, t0 = c * d.Q;
  const int qrows = min(TB, d.Q - q0);
  const long long dys = (long long)d.H * d.P;
  const float* dtb = dt + ((long long)b * d.S + t0) * d.H;
  const long long srow = ((long long)b * d.nc + c) * d.H * d.Eh;

  // The loads: C of the q tile and B of the key tiles at the start; per
  // head its dy rows, S_prev and dt, issued once the previous head's state
  // term is done with them; the M2 tiles, head after head, through a ring
  // two loads ahead of their use.
  const int nm = nh * (iq + 1);
  int issued = 0, m_t[RING], ys_t;
  {
    const bf16* Cb = Cm + b * d.csb + (long long)grp * d.N + (long long)(t0 + q0) * d.cst;
    load_rows(Cq, LB, Cb, d.cst, TB, qrows, d.NP, d.N, d.vc);
    const bf16* Bb = Bm + b * d.bsb + (long long)grp * d.N + (long long)t0 * d.bst;
    for (int k = 0; k <= iq; ++k)
      load_rows(Bk + k * TB * LB, LB, Bb + (long long)k * TB * d.bst, d.bst, TB,
                min(TB, d.Q - k * TB), d.NP, d.N, d.vb);
    cp_async_commit();
    ++issued;                                  // ticket 0
  }
  auto issue_ys = [&](int j) {
    if (j < nh) {
      const int hh = h_first + j;
      load_rows(Dy, LX, dy + ((long long)b * d.S + t0 + q0) * dys + (long long)hh * d.P,
                dys, TB, qrows, PP, d.P, d.vy);
      load_planes(Sh, Sl, LX, PP,
                  reinterpret_cast<const bf16*>(prev + srow + (long long)hh * d.Eh), d);
      for (int t = tid; t < d.QT; t += THREADS)
        cp_async4(dtv + t, dtb + (long long)min(t, d.Q - 1) * d.H + hh,
                  t < d.Q ? 4 : 0);
    }
    cp_async_commit();
    ys_t = issued++;
  };
  auto issue_m = [&](int f) {                  // head f / (iq + 1), key tile f % (iq + 1)
    if (f < nm) {
      const int hh = h_first + f / (iq + 1), k = f % (iq + 1);
      const bf16* src = m2 + (((long long)blockIdx.y * d.H + hh) * d.npair +
                              iq * (iq + 1) / 2 + k) * 2 * TM * TM;
      bf16* st = stage(f);
      const int ch = TM / 8;                   // TM x TM of each half
      for (int i = tid; i < 2 * TM * ch; i += THREADS) {
        const int row = i / ch, c8 = (i - row * ch) * 8, half_m = row / TM;
        cp_async16(st + (half_m * TB + row - half_m * TM) * LM + c8,
                   src + row * TM + c8, 16);
      }
    }
    cp_async_commit();
    m_t[f % RING] = issued++;
  };
  issue_ys(0);
  issue_m(0);
  issue_m(1);
  wait_ticket(issued, 0);                      // C and B rows

  const int r0 = 16 * rg + g8, r1 = r0 + 8;    // this thread's q rows
  const bf16* yrow = Dy + (16 * rg + (lane & 15)) * LX + (lane >> 4) * 8;
  float dcs[NT8][4] = {};                      // dC over the block's heads
  for (int j = 0; j < nh; ++j) {
    const int hh = h_first + j;
    wait_ticket(issued, ys_t);                // dy rows, S_prev, dt of head j
    const float cum = block_scan<false>(tid < d.QT ? dtv[tid] * A[hh] : 0.f, tmp);
    if (tid >= q0 && tid < q0 + TB) ecum[tid - q0] = expf(cum);
    __syncthreads();
    // state term: exp(cum) dy S_prev^T (K = p), S_prev hi + lo
    float dca[NT8][4] = {};
#pragma unroll
    for (int ks = 0; ks < PP; ks += 16) {
      uint32_t af[4];
      ldsm_x4(af, yrow + ks);
#pragma unroll
      for (int nn = 0; nn < NT8; nn += 2) {
        if (nn + 1 < HN) {
          uint32_t fh[4], fl[4];
          const int off = (half * HN * 8 + nn * 8 + (lane >> 4) * 8 + (lane & 7)) * LX +
                          ks + (j8 & 1) * 8;
          ldsm_x4(fh, Sh + off);
          ldsm_x4(fl, Sl + off);
          mma(dca[nn], af, fh[0], fh[1]);
          mma(dca[nn + 1], af, fh[2], fh[3]);
          mma(dca[nn], af, fl[0], fl[1]);
          mma(dca[nn + 1], af, fl[2], fl[3]);
        } else if (nn < HN) {
          uint32_t fh[2], fl[2];
          const int off = (half * HN * 8 + nn * 8 + (lane & 7)) * LX + ks +
                          ((lane >> 3) & 1) * 8;
          ldsm_x2(fh, Sh + off);
          ldsm_x2(fl, Sl + off);
          mma(dca[nn], af, fh[0], fh[1]);
          mma(dca[nn], af, fl[0], fl[1]);
        }
      }
    }
    const float e0 = ecum[r0], e1 = ecum[r1];
    // C . dC of the state term (its intra part comes from the keys kernel)
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nn = 0; nn < NT8; ++nn) {
      dca[nn][0] *= e0; dca[nn][1] *= e0;
      dca[nn][2] *= e1; dca[nn][3] *= e1;
      if (nn >= HN) continue;
      const int n = half * HN * 8 + nn * 8 + 2 * t4;
      const float2 c0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Cq + r0 * LB + n));
      const float2 c1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Cq + r1 * LB + n));
      s0 += c0.x * dca[nn][0] + c0.y * dca[nn][1];
      s1 += c1.x * dca[nn][2] + c1.y * dca[nn][3];
    }
    __syncthreads();                           // dy, S_prev and dt are free
    issue_ys(j + 1);
    // dC += M2 B over the key tiles at or before the q tile
    for (int k = 0; k <= iq; ++k) {
      const int f = j * (iq + 1) + k;
      wait_ticket(issued, m_t[f % RING]);
      issue_m(f + 2);
      const bf16* Mh = stage(f);
      const bf16* Ml = Mh + TB * LM;
      const bf16* Bt = Bk + k * TB * LB;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {         // key rows 16 kk .. + 16
        if (k == iq && kk > rg) continue;      // keys after the rows: zeros
        if (!WHOLE && (16 * kk >= TM || 16 * rg >= TM)) continue;   // past the chunk
        // A = M2 (rows q, K = keys) from the [key][q] tile: transposed blocks
        uint32_t ah[4], al[4];
        const int off = (16 * kk + (j8 >> 1) * 8 + (lane & 7)) * LM + 16 * rg + (j8 & 1) * 8;
        ldsm_x4_t(ah, Mh + off);
        ldsm_x4_t(al, Ml + off);
        const int kr = 16 * kk + (j8 & 1) * 8 + (lane & 7);
#pragma unroll
        for (int nn = 0; nn < NT8; nn += 2) {
          if (nn + 1 < HN) {
            uint32_t bq[4];
            ldsm_x4_t(bq, Bt + kr * LB + half * HN * 8 + nn * 8 + (j8 >> 1) * 8);
            mma(dca[nn], ah, bq[0], bq[1]);
            mma(dca[nn + 1], ah, bq[2], bq[3]);
            mma(dca[nn], al, bq[0], bq[1]);
            mma(dca[nn + 1], al, bq[2], bq[3]);
          } else if (nn < HN) {
            uint32_t bq[2];
            ldsm_x2_t(bq, Bt + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * LB +
                              half * HN * 8 + nn * 8);
            mma(dca[nn], ah, bq[0], bq[1]);
            mma(dca[nn], al, bq[0], bq[1]);
          }
        }
      }
    }
    // the halves' sums of C . dC meet in `dots`
#pragma unroll
    for (int nn = 0; nn < NT8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dcs[nn][e] += dca[nn][e];
    s0 += __shfl_xor_sync(FULL, s0, 1);
    s0 += __shfl_xor_sync(FULL, s0, 2);
    s1 += __shfl_xor_sync(FULL, s1, 1);
    s1 += __shfl_xor_sync(FULL, s1, 2);
    if (t4 == 0) {
      dots[half * TB + r0] = s0;
      dots[half * TB + r1] = s1;
    }
    __syncthreads();
    if (tid < qrows)
      dcum[((long long)b * d.S + t0 + q0 + tid) * d.H + hh] += dots[tid] + dots[TB + tid];
  }
  cp_async_wait<0>();
  float* out = dCp + (((long long)b * d.S + t0 + q0) * (d.G * d.TPG) + blockIdx.x) * d.N;
  const long long ost = (long long)d.G * d.TPG * d.N;
#pragma unroll
  for (int nn = 0; nn < NT8; ++nn) {
    if (nn >= HN) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0, n = half * HN * 8 + nn * 8 + 2 * t4;
      if (row >= qrows) continue;
      if (n < d.N) out[row * ost + n] = dcs[nn][2 * r];
      if (n + 1 < d.N) out[row * ost + n + 1] = dcs[nn][2 * r + 1];
    }
  }
}

// ---- 5. finish.  Blocks 0 .. H-1: head blockIdx.x; warp w walks the
// (batch, chunk) pairs w, w + 8, ..., lane L rows 8 L .. 8 L + 7: d cum_t
// (its stored share plus the keys kernel's partials of C . dC, one per key
// tile at or before the row's, in order), d(dt A)_t = delta + Σ_{u >= t}
// d cum_u (a suffix scan over the lanes), ddt += A d(dt A); dA = Σ dt
// d(dt A), summed in a fixed order.  Blocks from H: dB and dC (sum_tiles).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_finish_bf16(const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ delta,
                    const float* __restrict__ dcum,
                    const float* __restrict__ colpart,
                    float* __restrict__ ddt, float* __restrict__ dA,
                    const float* __restrict__ dBp,
                    const float* __restrict__ dCp, bf16* __restrict__ dB,
                    bf16* __restrict__ dC, int batch, DimsB d, Dims f) {
  __shared__ float red[WARPS];
  if ((int)blockIdx.x >= d.H) {
    sum_tiles(blockIdx.x - d.H, dBp, dCp, dB, dC, batch, f);
    return;
  }
  const int hh = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float a = A[hh];
  float part = 0.f;
  for (int j = warp; j < batch * d.nc; j += WARPS) {
    const int b = j / d.nc, c = j - b * d.nc;
    const long long row0 = (long long)b * d.S + (long long)c * d.Q;
    float v[8], lsum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * lane + i;
      v[i] = 0.f;
      if (t < d.Q) {
        const long long o = (row0 + t) * d.H + hh;
        v[i] = dcum[o];
        if (d.nT > 1)
          for (int k = 0; k <= t / TB; ++k) v[i] += colpart[o * d.nT + k];
      }
      lsum += v[i];
    }
    float incl = lsum;                         // the lanes from this one on
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(FULL, incl, off);
      if (lane + off < 32) incl += o;
    }
    float later = __shfl_down_sync(FULL, incl, 1);   // the lanes after it
    if (lane == 31) later = 0.f;
    float run = delta[((long long)b * d.nc + c) * d.H + hh] + later;
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      const int t = 8 * lane + i;
      run += v[i];
      if (t < d.Q) {
        const long long o = (row0 + t) * d.H + hh;
        ddt[o] += a * run;
        part += dt[o] * run;
      }
    }
  }
  const float s = block_sum(part, red);
  if (threadIdx.x == 0) dA[hh] = s;
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
  void *prev, *grads, *delta, *dcum, *dBp, *dCp, *tot, *m2, *cols;
};

int launch(const Ptrs& q, const Dims& d, int batch, int stages,
           cudaStream_t stream) {
  static bool c1 = false, c2 = false, c3 = false;
  const size_t s1 = (size_t)states_floats(d) * sizeof(float);
  const size_t s2 = (size_t)pass_floats(d, true) * sizeof(float);
  const size_t s3 = (size_t)pass_floats(d, false) * sizeof(float);
  if (s1 > (size_t)SMEM_LIMIT || s2 > (size_t)SMEM_LIMIT || s3 > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ssd_bwd_states, c1);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_keys, c2);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_queries, c3);
  if (err != cudaSuccess) return (int)err;
  const float* x = static_cast<const float*>(q.x);
  const float* B = static_cast<const float*>(q.B);
  const float* C = static_cast<const float*>(q.C);
  const float* dy = static_cast<const float*>(q.dy);
  const float* dt = static_cast<const float*>(q.dt);
  const float* A = static_cast<const float*>(q.A);
  float* prev = static_cast<float*>(q.prev);
  float* grads = static_cast<float*>(q.grads);
  float* delta = static_cast<float*>(q.delta);
  float* dcum = static_cast<float*>(q.dcum);
  float* ddt = static_cast<float*>(q.ddt);
  const dim3 tiles(d.nT, d.G * d.TPG, d.nc * batch);
  if (stages & 1) {
    ssd_bwd_states<<<dim3(d.H, batch), THREADS, s1, stream>>>(
        x, dt, A, B, C, static_cast<const float*>(q.init), dy,
        static_cast<const float*>(q.dstate), prev, grads, delta,
        static_cast<float*>(q.dinit), d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & 2) {
    ssd_bwd_keys<<<tiles, THREADS, s2, stream>>>(
        x, dt, A, B, C, dy, grads, static_cast<float*>(q.dx), ddt, dcum,
        static_cast<float*>(q.dBp), d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & 4) {
    ssd_bwd_queries<<<tiles, THREADS, s3, stream>>>(
        x, dt, A, B, C, dy, prev, dcum, static_cast<float*>(q.dCp), d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & 8) {
    const long long elems = (long long)batch * d.S * d.G * d.N;
    const long long blocks = d.H + (elems + THREADS - 1) / THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    ssd_bwd_finish<<<(unsigned)blocks, THREADS, 0, stream>>>(
        dt, A, delta, dcum, ddt, static_cast<float*>(q.dA),
        static_cast<const float*>(q.dBp), static_cast<const float*>(q.dCp),
        static_cast<float*>(q.dB), static_cast<float*>(q.dC), batch, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

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
  return launch(q, d, b, stages, stream);
}


inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int PP, bool WHOLE>
int launch_bf16_pp(const Ptrs& q, const DimsB& d, int batch, int stages,
                   cudaStream_t stream) {
  static bool c1 = false, c3 = false, c4 = false;
  const int s1 = chunk_smem(d.NP, PP);
  const int s3 = keys_layout(d.NP, PP, d.nT).total;
  const int s4 = queries_layout(d.NP, PP, d.nT).total;
  if (s1 > SMEM_LIMIT || s3 > SMEM_LIMIT || s4 > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ssd_bwd_chunk_bf16<PP>, c1);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_keys_bf16<PP, WHOLE>, c3);
  if (err == cudaSuccess) err = allow_smem(ssd_bwd_queries_bf16<PP, WHOLE>, c4);
  if (err != cudaSuccess) return (int)err;
  const bf16* x = static_cast<const bf16*>(q.x);
  const bf16* B = static_cast<const bf16*>(q.B);
  const bf16* C = static_cast<const bf16*>(q.C);
  const bf16* dy = static_cast<const bf16*>(q.dy);
  const float* dt = static_cast<const float*>(q.dt);
  const float* A = static_cast<const float*>(q.A);
  float* prev = static_cast<float*>(q.prev);
  float* grads = static_cast<float*>(q.grads);
  float* dcum = static_cast<float*>(q.dcum);
  float* tot = static_cast<float*>(q.tot);
  bf16* m2 = static_cast<bf16*>(q.m2);
  if (stages & 1) {
    ssd_bwd_chunk_bf16<PP><<<dim3(d.nc, d.H, batch), THREADS, s1, stream>>>(
        x, dt, A, B, C, dy, prev, grads, tot, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & 2) {
    const float* init = static_cast<const float*>(q.init);
    const float* dstate = static_cast<const float*>(q.dstate);
    float* delta = static_cast<float*>(q.delta);
    float* dinit = static_cast<float*>(q.dinit);
    if (d.E % 4 == 0 && aligned16(init) && aligned16(dstate) && aligned16(dinit))
      ssd_bwd_pass<4><<<dim3(d.H, batch), THREADS, 0, stream>>>(
          prev, grads, tot, init, dstate, delta, dinit, d);
    else
      ssd_bwd_pass<1><<<dim3(d.H, batch), THREADS, 0, stream>>>(
          prev, grads, tot, init, dstate, delta, dinit, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // keys then queries over slices of m2rows (chunk, batch) rows, each
  // slice's M2 in the one scratch
  const int rows = d.nc * batch;
  for (int y0 = 0; y0 < rows && (stages & 12); y0 += d.m2rows) {
    DimsB ds = d;
    ds.y0 = y0;
    const dim3 tiles(d.G * d.TPG, min(d.m2rows, rows - y0), d.nT);
    if (stages & 4) {
      ssd_bwd_keys_bf16<PP, WHOLE><<<tiles, THREADS, s3, stream>>>(
          x, dt, A, B, C, dy, grads, static_cast<bf16*>(q.dx),
          static_cast<float*>(q.ddt), dcum, static_cast<float*>(q.dBp), m2,
          static_cast<float*>(q.cols), ds);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if (stages & 8) {
      ssd_bwd_queries_bf16<PP, WHOLE><<<tiles, THREADS, s4, stream>>>(
          dt, A, B, C, dy, prev, m2, dcum, static_cast<float*>(q.dCp), ds);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  if (stages & 16) {
    Dims f;
    f.S = d.S; f.H = d.H; f.G = d.G; f.N = d.N; f.Q = d.Q; f.nc = d.nc;
    f.TPG = d.TPG;
    const long long elems = (long long)batch * d.S * d.G * d.N;
    const long long blocks = d.H + (elems + THREADS - 1) / THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    ssd_bwd_finish_bf16<<<(unsigned)blocks, THREADS, 0, stream>>>(
        dt, A, static_cast<const float*>(q.delta), dcum,
        static_cast<const float*>(q.cols), static_cast<float*>(q.ddt),
        static_cast<float*>(q.dA), static_cast<const float*>(q.dBp),
        static_cast<const float*>(q.dCp), static_cast<bf16*>(q.dB),
        static_cast<bf16*>(q.dC), batch, d, f);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

int launch_checked_bf16(const Ptrs& q, int b, int s, int h, int p, int g,
                        int n, int chunk, int heads, int m2rows, long long xsb,
                        long long xst, long long bsb, long long bst,
                        long long csb, long long cst, int stages,
                        cudaStream_t stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > 64 || g <= 0 || n <= 0 ||
      n > 128 || h % g != 0 || chunk <= 0 || chunk > QMAX || s % chunk != 0 ||
      heads <= 0 || heads > HT_MAX || b > 65535 ||
      (long long)(s / chunk) * b > 65535 || m2rows <= 0 ||
      (chunk > TB && q.cols == nullptr))
    return (int)cudaErrorInvalidValue;
  DimsB d;
  d.S = s; d.H = h; d.P = p; d.G = g; d.N = n; d.Q = chunk; d.nc = s / chunk;
  d.NP = (n + 15) / 16 * 16;
  d.QT = (chunk + TB - 1) / TB * TB;
  d.nT = d.QT / TB;
  d.npair = d.nT * (d.nT + 1) / 2;
  d.HT = heads; d.TPG = (h / g + heads - 1) / heads;
  if ((long long)d.G * d.TPG > 65535) return (int)cudaErrorInvalidValue;
  d.E = n * p;
  d.GS = d.E % 64 == 0 ? 6 : 3;
  d.Eh = (d.E + (1 << d.GS) - 1) >> d.GS << d.GS;
  d.TM = d.nT > 1 ? TB : (chunk + 15) / 16 * 16;
  d.y0 = 0; d.m2rows = m2rows;
  d.xsb = xsb; d.xst = xst; d.bsb = bsb; d.bst = bst; d.csb = csb; d.cst = cst;
  d.vx = p % 8 == 0 && xsb % 8 == 0 && xst % 8 == 0 && aligned16(q.x);
  d.vy = p % 8 == 0 && aligned16(q.dy);
  d.vb = n % 8 == 0 && bsb % 8 == 0 && bst % 8 == 0 && aligned16(q.B);
  d.vc = n % 8 == 0 && csb % 8 == 0 && cst % 8 == 0 && aligned16(q.C);
  d.vs = p % 8 == 0 && aligned16(q.prev) && aligned16(q.grads);
  // M2 tiles of the chunk's rows below 64 only where a chunk is one tile
  if (d.TM == TB) {
    if (p <= 16) return launch_bf16_pp<16, true>(q, d, b, stages, stream);
    if (p <= 32) return launch_bf16_pp<32, true>(q, d, b, stages, stream);
    return launch_bf16_pp<64, true>(q, d, b, stages, stream);
  }
  if (p <= 16) return launch_bf16_pp<16, false>(q, d, b, stages, stream);
  if (p <= 32) return launch_bf16_pp<32, false>(q, d, b, stages, stream);
  return launch_bf16_pp<64, false>(q, d, b, stages, stream);
}

}  // namespace

extern "C" {

// fp32 stages: 1 states, 2 keys, 4 queries, 8 finish; bf16 stages: 1 chunk
// states, 2 state pass, 4 keys, 8 queries, 16 finish (31 runs either whole).
int ssd_chunk_scan_bwd_f32(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* init, const void* dy, const void* dstate, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dinit, void* prev, void* grads,
    void* delta, void* dcum, void* dBp, void* dCp, int b, int s, int h, int p,
    int g, int n, int chunk, int tile, int heads, long long xsb, long long xst,
    long long bsb, long long bst, long long csb, long long cst, int stages,
    void* stream) {
  const Ptrs q{x, dt, A, B, C, init, dy, dstate, dx, ddt, dA, dB, dC, dinit,
               prev, grads, delta, dcum, dBp, dCp, nullptr, nullptr, nullptr};
  return launch_checked(q, b, s, h, p, g, n, chunk, tile, heads, xsb, xst,
                        bsb, bst, csb, cst, stages,
                        static_cast<cudaStream_t>(stream));
}

// tot: each chunk's sum of dt A; m2: M2 of m2rows (chunk, batch) rows; cols:
// the key tiles' shares of C . dC (null for a chunk of one 64-row tile).
int ssd_chunk_scan_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* init, const void* dy, const void* dstate, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dinit, void* prev, void* grads,
    void* delta, void* dcum, void* dBp, void* dCp, void* tot, void* m2,
    void* cols, int b, int s, int h, int p, int g, int n, int chunk, int heads,
    int m2rows, long long xsb, long long xst, long long bsb, long long bst,
    long long csb, long long cst, int stages, void* stream) {
  const Ptrs q{x, dt, A, B, C, init, dy, dstate, dx, ddt, dA, dB, dC, dinit,
               prev, grads, delta, dcum, dBp, dCp, tot, m2, cols};
  return launch_checked_bf16(q, b, s, h, p, g, n, chunk, heads, m2rows, xsb,
                             xst, bsb, bst, csb, cst, stages,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
