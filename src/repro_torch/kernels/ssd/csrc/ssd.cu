// SSD (Mamba-2 state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py (function
// ssd_chunk_scan, body _kernel).  For x (b, s, h, p), dt (b, s, h) fp32,
// A (h,) fp32, B/C (b, s, g, n) and an optional initial state (b, h, n, p)
// fp32, with head hh reading group hh / (h / g), it walks the sequence in
// chunks of Q rows and per chunk computes, with cum the prefix sum of
// dt * A over the chunk:
//   intra:  y  = ((C B^T) o L) (dt * x),   L[q][k] = exp(cum_q - cum_k), k <= q
//   inter:  y += (C o exp(cum)) S_prev
//   state:  S  = S_prev * exp(cum_last) + B^T ((dt * x) o exp(cum_last - cum))
// and writes y (in x's dtype) and the final state S (b, h, n, p) fp32.
// The state starts at the given one, or at 0 as the Pallas kernel's does.
//
// What bounds it: at the mamba2-2.7b serving shape (b 4, s 2048, h 80,
// p 64, g 1, n 128, Q 256, bf16 x/B/C) the least work is ~4.4e10 FLOPs
// against ~185 MB of traffic, so the card's bound is its memory (~0.055 ms);
// the tensor cores would take ~0.044 ms.  The first CUDA port of this
// kernel (now the fp32 entry) took 5.1 ms there: 320 blocks, one per
// (head, batch), walked the 8 chunks in order on the CUDA cores in fp32
// and recomputed C B^T for every head.
//
// bf16 entry: three kernels, from the duality that only the state links
// the chunks (ssd_states_bf16, ssd_pass, ssd_scan_bf16):
//   1. chunk states, one block per (chunk, head, batch), 2560 at the
//      serving shape: dS_c = B^T x', an n x p product over the chunk's rows
//      with x' = (dt * x) o exp(sum of dt * A after the row); B and x come
//      in 64-row tiles through a 2-stage cp.async ring (three blocks to an
//      SM); dS_c goes fp32 into scratch (b, nc, h n p rounded up to 256:
//      the heads' states packed one after the other, so the scratch is the
//      size of the states at any n and p), each chunk's decay sum into
//      (b, nc, h);
//   2. state pass: a warp walks 256 elements of one batch's row of states
//      over the chunks, S_c = S_{c-1} exp(total_c) + dS_c from the initial
//      state (or 0), loading the next chunk's row before it overwrites this
//      one in place with the state entering the chunk (hi and lo bf16
//      halves, see hi_at), and writes the final state; every access of a
//      warp is contiguous;
//   3. chunk scan, one block per (64-row q tile, tile of up to 16 heads of
//      one group, chunk, batch), 640 at the serving shape: C B^T for the q
//      tile against the chunk's keys at or before it once, kept in
//      registers and reused for every head of the tile (heads differ only
//      in dt and A); each head's decay factors (one warp per head, warp
//      scans in log2 units); then per head, with the next head's x rows
//      and entering state loading into the other of two stages, the inter
//      term C S_{c-1} and the intra term ((C B^T) o L o dt) x, and y
//      written once, 16 bytes a thread.
// Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 accumulate; fragments by ldmatrix from padded shared rows, so the
// loads are free of bank conflicts).  Operands that are not bf16 data
// (the decayed scores, x', the fp32 state) are split into hi + lo bf16
// halves and multiplied twice: one bf16 rounding of the scores, of x' or of
// the state puts y outside 2e-2 of the sequential recurrence at the
// serving shape (tests/test_torch_ssd.py emulates these roundings), while
// hi + lo keeps ~16 bits.  In the chunk scan warp w takes q rows
// 16 (w % 4) .. + 16 and one of two splits of the keys (and of n for the
// inter term); the splits' partial y meet in shared memory.  Loads are
// 16-byte cp.async copies (zero-filled past the chunk, n and p) where rows
// are 16-byte aligned, else element loads: head_dim 1 has rows of 2 bytes.
// x, B and C are read in place through their batch and sequence strides
// (the model passes slices of one convolution output).  What holds the op
// above its bound (PERF.md): the chunk scan is bound by latency, one block
// of 8 warps to an SM (~230 registers, 201 KB of shared memory), and the
// hi + lo scores cost as many instructions as the products that use them.
//
// Decay precision: deep in a 256-row chunk |cum| reaches hundreds, and
// cum_q - cum_k then carries an absolute error of a few ulp of |cum|
// however close q and k are.  So exponents are sums of one sign: x' takes
// the sum after its row (a suffix scan); for a key k before the q tile
// (rows from q0) the decay is rank-1, exp(loc_q) * exp(sum over k+1 .. q0-1)
// with loc_q the sum over q0 .. q, both factors <= 1: the key's factor
// scales the scores, the row's factor the accumulated rows; inside the
// diagonal 64-row tile it is exp(loc_q - loc_k), a difference of two sums
// of at most 64 rows, and it is evaluated only where k <= q.
//
// fp32 entry: the first port's kernel, kept on the CUDA cores in fp32, as
// the fp32 entries of the attention kernels are: its tolerance (5e-4
// against the sequential recurrence) and the fp32 decode-vs-teacher-forcing
// check rest on full fp32 products.  One block per (head, batch) walks the chunks with
// S (n x p fp32) in shared memory; each chunk is cut into tiles of T rows
// (64, or 32 / 16 where shared memory or a short chunk ask for it); per q
// tile the inter term, then the intra term against every k tile at or
// before it; the k tile on the diagonal also adds its share to the new
// state.  Its decay exponents are built from nonpositive pieces (a running
// sum down each column of the diagonal tile; for other tiles a within-tile
// prefix of q, the whole tiles between and a within-tile suffix of k).
// Products are 4 x 4 register tiles per thread reading 16-byte rows of
// shared memory; n and p are padded to multiples of 4 with zeros.
//
// bf16 <-> fp32 only through the __bfloat162float / __float2bfloat16
// family.  Shared memory above 48 KB is enabled with cudaFuncSetAttribute,
// once per kernel, so that the launches can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 232448;   // bytes a block may opt into on sm_90

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) / 4 * 4; }
// a multiple of 4 whose quarter is odd (see the header)
__host__ __device__ __forceinline__ int ld_odd(int v) { return ((v / 4) & 1) ? v : v + 4; }

// =================================================================== fp32
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

// Rows [row0, row0 + rows) of a (., n) operand into a T x ld fp32 tile,
// scaled by scale[r] when given; zero past rows and past n.
__device__ void load_tile(float* dst, int ld, int width, const float* src,
                          long long stride, int row0, int rows, int n,
                          const float* scale, int T, int tid) {
  for (int i = tid; i < T * width; i += THREADS) {
    const int r = i / width, c = i - r * width;
    float v = 0.f;
    if (r < rows && c < n) {
      v = src[(long long)(row0 + r) * stride + c];
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

// (at mamba2's widths its shared memory fits one block to an SM; without
// the minimum of 1 ptxas held it to 80 registers and spilled)
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_f32(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ init,
                   float* __restrict__ y, float* __restrict__ state_out,
                   Shape d) {
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
  const float* xb = x + b * d.xsb + (long long)h * d.P;
  const float* Bb = Bm + b * d.bsb + (long long)grp * d.N;
  const float* Cb = Cm + b * d.csb + (long long)grp * d.N;
  const float* dtb = dt + (long long)b * d.S * d.H + h;
  float* yb = y + ((long long)b * d.S * d.H + h) * d.P;
  const long long yst = (long long)d.H * d.P;
  const int nT = d.QT / d.T;
  const float* ib = init ? init + ((long long)b * d.H + h) * d.N * d.P : nullptr;

  for (int i = tid; i < d.NP * d.PP; i += THREADS) {
    const int n = i / d.PP, p = i - n * d.PP;
    St[i] = (ib && n < d.N && p < d.P) ? ib[n * d.P + p] : 0.f;
  }
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
                nullptr, d.T, tid);
      __syncthreads();
      if (c == 0 && !ib) {
        for (int e = tid; e < d.T * d.PP; e += THREADS) Ys[e] = 0.f;
      } else {
        mm_rows(Cs, d.ldn, St, d.PP, d.NP, Ys, d.PP, ecum + q0, false, d, tid);
      }
      for (int j = 0; j <= i; ++j) {
        const int k0 = j * d.T, rows = min(d.T, d.Q - k0);
        load_tile(Bs, d.ldn, d.NP, Bb, d.bst, t0 + k0, rows, d.N, nullptr,
                  d.T, tid);
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
        yb[(long long)(t0 + q0 + r) * yst + p] = Ys[r * d.PP + p];
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

int launch_f32(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* init, void* y, void* state, int b,
               int s, int h, int p, int g, int n, int q, int tile,
               long long xsb, long long xst, long long bsb, long long bst,
               long long csb, long long cst, cudaStream_t stream) {
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
        ssd_scan_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  ssd_scan_f32<<<dim3(h, b), THREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(state), d);
  return (int)cudaGetLastError();
}

// =================================================================== bf16
typedef __nv_bfloat16 bf16;
constexpr int TQ = 64;        // q rows per scan block; key rows per state tile
constexpr int QMAX = 256;     // longest chunk: one scan thread per key
constexpr int HT_MAX = 16;    // heads per scan block, at most
constexpr int STATES_STAGES = 2;   // ring stages of the chunk-states kernel
constexpr int SK = 64;             // rows of a chunk-states tile
constexpr int KEY_SPLITS = 2;      // splits of the keys in a scan block
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Dims {
  int S, H, P, G, N, Q, nc;
  int NP, QT, HT;             // n padded to 16; Q padded to 64; heads per block
  long long xsb, xst, bsb, bst, csb, cst;   // batch / sequence strides
  int vx, vb, vc, vs, vy;     // 16-byte copies for x, B, C, the state, y
  int has_init;
  int E;                      // n * p: floats of one head's state
  long long Rs;               // floats per (batch, chunk) row of the scratch:
                              // the h states, h * n * p rounded up to 256
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) as bf16 pairs hi and lo with hi + lo = (u, v) to ~2^-16 relative
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

// Inclusive scan of one value per thread over the block: prefix (threads
// <= tid) or suffix (threads >= tid).  The callers' values are all of one
// sign, so each partial sum is exact to a few ulp of itself.
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
  __syncthreads();                  // tmp is free for the next scan
  return v + add;
}

// R x CP bf16 tile at dst (row stride ld) from rows of src (row stride rs):
// rows past `rows` and columns past `cols` are zero.  vec: 16-byte cp.async
// copies (src, rs and cols multiples of 8 elements); the caller waits.
// CT > 0 fixes CP at compile time (the index arithmetic becomes shifts).
template <int CT = 0>
__device__ void load_rows(bf16* dst, int ld, const bf16* src, long long rs,
                          int R, int rows, int cp, int cols, bool vec) {
  const int CP = CT > 0 ? CT : cp;
  if (vec) {
    const int ch = CP / 8;
    for (int i = threadIdx.x; i < R * ch; i += THREADS) {
      const int r = i / ch, c = (i - r * ch) * 8;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * ld + c, in ? src + r * rs + c : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * CP; i += THREADS) {
      const int r = i / CP, c = i - r * CP;
      dst[r * ld + c] = (r < rows && c < cols) ? src[r * rs + c]
                                               : __float2bfloat16(0.f);
    }
  }
}

// The state entering chunk c, element e = (hh * n + n_idx) * p + p_idx of
// a (batch, chunk) row of the scratch, which holds the h heads' states one
// after the other: the hi bf16 halves of each group of 64 consecutive
// elements, then their lo halves, fill that group's 256 bytes (the state
// pass writes them over the group's fp32 chunk state, in place; a group
// may span two heads).  hi_at(e) is the bf16 offset of e's hi half; its lo
// half is 64 further.
__device__ __forceinline__ long long hi_at(long long e) {
  return 128 * (e >> 6) + (e & 63);
}

// NP x CP state tiles Sh, Sl (row stride ld) of the head whose state
// starts at element e0 of the row at `planes`; zero past n and p.  vec:
// 16-byte cp.async copies (p, so e0 too, a multiple of 8).
template <int CP>
__device__ void load_state(bf16* Sh, bf16* Sl, int ld, const bf16* planes,
                           long long e0, int N, int P, int NP, bool vec) {
  if (vec) {
    const int ch = CP / 8;
    for (int i = threadIdx.x; i < NP * ch; i += THREADS) {
      const int r = i / ch, c = (i - r * ch) * 8;
      const bool in = r < N && c < P;
      const bf16* src = in ? planes + hi_at(e0 + r * P + c) : planes;
      cp_async16(Sh + r * ld + c, src, in ? 16 : 0);
      cp_async16(Sl + r * ld + c, in ? src + 64 : planes, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < NP * CP; i += THREADS) {
      const int r = i / CP, c = i - r * CP;
      const bool in = r < N && c < P;
      const long long at = hi_at(e0 + r * P + c);
      Sh[r * ld + c] = in ? planes[at] : zero;
      Sl[r * ld + c] = in ? planes[at + 64] : zero;
    }
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Shared bytes of the two kernels; ops.py::bf16_plan mirrors them.
__host__ __device__ inline int states_smem(int NP, int PP) {
  // the ring's stages of B and x rows, x' hi and lo, row weights, scan space
  return STATES_STAGES * 2 * SK * (NP + 8 + PP + 8) + 2 * 2 * SK * (PP + 8) +
         4 * (QMAX + WARPS);
}

struct ScanLayout { int cs, r, stage, f, total; };

__host__ __device__ inline ScanLayout scan_layout(int NP, int PP, int QT) {
  ScanLayout l;
  l.cs = 0;                                   // C rows of the q tile
  l.r = 2 * TQ * (NP + 8);                    // B rows, then two stages of
  l.stage = 2 * QT * (PP + 8) + 2 * 2 * NP * (PP + 8);   // x, S hi, S lo
  // over a used stage: the other splits' partial y, then y as bf16 rows
  const int red = (KEY_SPLITS - 1) * 4 * (PP / 8) * 32 * 16 + 2 * TQ * (PP + 8);
  if (l.stage < red) l.stage = red;
  int region = 2 * l.stage;
  if (region < 2 * QT * (NP + 8)) region = 2 * QT * (NP + 8);
  l.f = l.r + region;
  // per head: dt of the keys, the keys' factors, dt and sums of the tile's
  // rows, the sum before the tile
  l.total = l.f + 4 * HT_MAX * (2 * QMAX + 2 * TQ + 1);
  return l;
}

// ---- 1. chunk states: dS = B^T x', x' = x dt exp(sum of dt A after it).
// B and x come in SK-row tiles through a ring of STATES_STAGES stages; each
// x tile is scaled and split into x' hi and lo in shared memory.
template <int PP>
__global__ void __launch_bounds__(THREADS)
ssd_states_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                float* __restrict__ dstate, float* __restrict__ tot, Dims d) {
  constexpr int LX = PP + 8, NS = STATES_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LB = d.NP + 8;
  const int SB = SK * (LB + LX);              // a stage: B rows, x rows
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* Xh = ring + NS * SB;
  bf16* Xl = Xh + SK * LX;
  float* wts = reinterpret_cast<float*>(Xl + SK * LX);
  float* tmp = wts + QMAX;

  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3, j8 = lane >> 3;
  const int grp = hh / (d.H / d.G), t0 = c * d.Q;
  const bf16* xb = x + b * d.xsb + (long long)hh * d.P + (long long)t0 * d.xst;
  const bf16* Bb = Bm + b * d.bsb + (long long)grp * d.N + (long long)t0 * d.bst;
  const int ntiles = d.QT / SK;
  auto issue = [&](int kt) {         // one commit group a call, maybe empty
    if (kt < ntiles) {
      bf16* Bs = ring + (kt % NS) * SB;
      const int k0 = kt * SK, rows = min(SK, d.Q - k0);
      load_rows(Bs, LB, Bb + k0 * d.bst, d.bst, SK, rows, d.NP, d.N, d.vb);
      load_rows<PP>(Bs + SK * LB, LX, xb + k0 * d.xst, d.xst, SK, rows, PP,
                    d.P, d.vx);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int kt = 0; kt < NS - 1; ++kt) issue(kt);

  // w_t = dt_t exp(sum over rows t+1 .. Q-1), 0 past Q
  const float a = A[hh];
  const float* dtb = dt + ((long long)b * d.S + t0) * d.H + hh;
  const float dtv = tid < d.Q ? dtb[(long long)tid * d.H] : 0.f;
  const float nxt = tid + 1 < d.Q ? dtb[(long long)(tid + 1) * d.H] * a : 0.f;
  const float after = block_scan<true>(nxt, tmp);
  wts[tid] = dtv * expf(after);
  if (tid == 0) tot[((long long)b * d.nc + c) * d.H + hh] = dtv * a + after;

  const int m0 = 16 * warp;
  float acc[PP / 8][4] = {};
  for (int kt = 0; kt < ntiles; ++kt) {
    issue(kt + NS - 1);
    cp_async_wait<NS - 1>();
    __syncthreads();                 // tile kt landed; wts is written
    const bf16* Bs = ring + (kt % NS) * SB;
    const bf16* Xr = Bs + SK * LB;
    for (int i = tid; i < SK * (PP / 8); i += THREADS) {
      const int r = i / (PP / 8), c8 = (i - r * (PP / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(Xr + r * LX + c8);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      const float w = wts[kt * SK + r];
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split2(__bfloat162float(e[2 * j]) * w,
               __bfloat162float(e[2 * j + 1]) * w, hi[j], lo[j]);
      *reinterpret_cast<uint4*>(Xh + r * LX + c8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Xl + r * LX + c8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
    if (m0 < d.NP) {
#pragma unroll
      for (int ks = 0; ks < SK; ks += 16) {
        // A = B^T (rows n, columns keys): transposed 8x8 blocks of B
        uint32_t af[4];
        ldsm_x4_t(af, Bs + (ks + (j8 >> 1) * 8 + (lane & 7)) * LB + m0 + (j8 & 1) * 8);
        const int xr = ks + (j8 & 1) * 8 + (lane & 7);
#pragma unroll
        for (int pn = 0; pn < PP / 8; pn += 2) {
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, Xh + xr * LX + pn * 8 + (j8 >> 1) * 8);
          ldsm_x4_t(bl, Xl + xr * LX + pn * 8 + (j8 >> 1) * 8);
          mma(acc[pn], af, bh[0], bh[1]);
          mma(acc[pn + 1], af, bh[2], bh[3]);
          mma(acc[pn], af, bl[0], bl[1]);
          mma(acc[pn + 1], af, bl[2], bl[3]);
        }
      }
    }
    __syncthreads();                 // the stage and Xh, Xl are refilled
  }
  cp_async_wait<0>();
  if (m0 >= d.NP) return;
  float* out = dstate + ((long long)b * d.nc + c) * d.Rs + (long long)hh * d.E;
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

// ---- 2. state pass: a warp owns 256 consecutive elements (4 groups of
// 64) of one batch's row of h states and walks the chunks, loading the
// next chunk's row before it writes this one's hi and lo halves over this
// one's fp32 chunk states; the final state is written fp32.  Lane L holds
// elements 4L .. 4L+3 and 128 + 4L .. 4L+3: every load and store of a
// warp is contiguous.  Each element decays by its own head's chunk sum
// (one head for the whole warp where n * p is a multiple of 256).
__global__ void __launch_bounds__(THREADS)
ssd_pass(float* __restrict__ dstate, const float* __restrict__ tot,
         const float* __restrict__ init, float* __restrict__ state_out,
         Dims d) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const long long base =
      256 * (((long long)blockIdx.x * THREADS + threadIdx.x) >> 5);
  const long long R = (long long)d.H * d.E;   // state elements in a row
  if (base >= R) return;
  auto elem = [&](int i) {
    return base + (i < 4 ? 4 * lane + i : 128 + 4 * lane + i - 4);
  };
  int hd[8];                         // each element's head
  float s[8], v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    hd[i] = (int)(min(elem(i), R - 1) / d.E);
    s[i] = (d.has_init && elem(i) < R) ? init[b * R + elem(i)] : 0.f;
  }
  auto load = [&](int c, float (&dst)[8]) {
    const float4* src = reinterpret_cast<const float4*>(
        dstate + ((long long)b * d.nc + c) * d.Rs + base);
    const float4 u = src[lane], w = src[32 + lane];
    dst[0] = u.x; dst[1] = u.y; dst[2] = u.z; dst[3] = u.w;
    dst[4] = w.x; dst[5] = w.y; dst[6] = w.z; dst[7] = w.w;
  };
  load(0, v);
  for (int c = 0; c < d.nc; ++c) {
    float vn[8];
    if (c + 1 < d.nc) load(c + 1, vn);
    const long long row = (long long)b * d.nc + c;
    const float* tc = tot + row * d.H;
    float decay[8];
    if (hd[0] == hd[7]) {
      const float e = expf(tc[hd[0]]);
#pragma unroll
      for (int i = 0; i < 8; ++i) decay[i] = e;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) decay[i] = expf(tc[hd[i]]);
    }
    __syncwarp();                    // the warp has read these 1 KB
    bf16* pl = reinterpret_cast<bf16*>(dstate + row * d.Rs + base);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      uint32_t hi[2], lo[2];
      split2(s[4 * k], s[4 * k + 1], hi[0], lo[0]);
      split2(s[4 * k + 2], s[4 * k + 3], hi[1], lo[1]);
      bf16* at = pl + hi_at(128 * k + 4 * lane);
      *reinterpret_cast<uint2*>(at) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(at + 64) = make_uint2(lo[0], lo[1]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[i] = s[i] * decay[i] + (elem(i) < R ? v[i] : 0.f);
      if (c + 1 < d.nc) v[i] = vn[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (elem(i) < R) state_out[b * R + elem(i)] = s[i];
}

// ---- 3. chunk scan: y for a 64-row q tile and a tile of heads; KS splits
// of the keys, each of 4 warps of 16 q rows.
template <int PP>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ dstate,
              bf16* __restrict__ y, Dims d) {
  constexpr int LX = PP + 8, NPT = PP / 8;
  constexpr int KS = KEY_SPLITS;
  static_assert(4 * 32 * KS == THREADS, "4 warps of q rows per key split");
  constexpr int NCB = QMAX / KS / 8;          // C B^T n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LB = d.NP + 8;
  const ScanLayout L = scan_layout(d.NP, PP, d.QT);
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw + L.cs);
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw + L.r);   // then the stages
  float* dts = reinterpret_cast<float*>(smem_raw + L.f);  // [head][key]
  // per head, in log2 units: cs dt exp2(sum after the key, before q0);
  // dk dt and lc the sum from q0 of the tile's rows; pre the sum before q0
  float* cs = dts + HT_MAX * QMAX;
  float* dk = cs + HT_MAX * QMAX;
  float* lc = dk + HT_MAX * TQ;
  float* pre = lc + HT_MAX * TQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3, j8 = lane >> 3;
  const int rg = warp & 3, part = warp >> 2;
  const int q0 = blockIdx.x * TQ, K = q0 + TQ;
  const int hpg = d.H / d.G, per_group = (hpg + d.HT - 1) / d.HT;
  const int grp = blockIdx.y / per_group;
  const int h_first = grp * hpg + (blockIdx.y % per_group) * d.HT;
  const int nh = min(d.HT, (grp + 1) * hpg - h_first);
  const int c = blockIdx.z % d.nc, b = blockIdx.z / d.nc, t0 = c * d.Q;
  const bool inter = c > 0 || d.has_init;

  const bf16* Cb = Cm + b * d.csb + (long long)grp * d.N + (long long)(t0 + q0) * d.cst;
  const bf16* Bb = Bm + b * d.bsb + (long long)grp * d.N + (long long)t0 * d.bst;
  load_rows(Cs, LB, Cb, d.cst, TQ, min(TQ, d.Q - q0), d.NP, d.N, d.vc);
  load_rows(Bs, LB, Bb, d.bst, K, min(K, d.Q), d.NP, d.N, d.vb);
  cp_async_commit();
  const int kv = min(K, d.Q);          // keys that hold rows
  const float* dtb = dt + ((long long)b * d.S + t0) * d.H + h_first;
  for (int i = tid; i < K * nh; i += THREADS) {
    const int t = i / nh, j = i - t * nh;
    dts[j * QMAX + t] = t < kv ? dtb[(long long)t * d.H + j] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // C B^T for rows 16 rg .. + 16 and this warp's keys: the 16-key steps
  // up to the warp's last row (later keys are masked), dealt out to the
  // KS splits in turn, so each split gets as many steps of the diagonal
  // tile (which cost an exp per element) as the others.  Local step m is
  // keys 16 (m KS + part) .. + 16.
  const int nsteps = q0 / 16 + rg + 1;
  const int npair = (nsteps - part + KS - 1) / KS;
  float cb[NCB][4];
#pragma unroll
  for (int i = 0; i < NCB; ++i) cb[i][0] = cb[i][1] = cb[i][2] = cb[i][3] = 0.f;
  const bf16* crow = Cs + (16 * rg + (lane & 15)) * LB + (lane >> 4) * 8;
  for (int ks = 0; ks < d.NP; ks += 16) {
    uint32_t af[4];
    ldsm_x4(af, crow + ks);
#pragma unroll
    for (int j = 0; j < NCB / 2; ++j) {
      if (j < npair) {
        uint32_t bf[4];
        ldsm_x4(bf, Bs + (16 * (j * KS + part) + (lane >> 4) * 8 + (lane & 7)) * LB +
                        ks + (j8 & 1) * 8);
        mma(cb[2 * j], af, bf[0], bf[1]);
        mma(cb[2 * j + 1], af, bf[2], bf[3]);
      }
    }
  }

  // each head's decay factors, one warp per head, 8 keys per lane; every
  // partial sum adds terms of one sign
  for (int hw = warp; hw < nh; hw += WARPS) {
    const float a = A[h_first + hw] * LOG2E;
    const float* dw = dts + hw * QMAX;
    float av[8], sv[8], pv[8];
    float ssum = 0.f, psum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * lane + i;
      av[i] = t < K ? dw[t] * a : 0.f;
    }
#pragma unroll
    for (int i = 7; i >= 0; --i) {     // after t, before q0 (exclusive)
      sv[i] = ssum;
      if (8 * lane + i < q0) ssum += av[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {      // from q0 to t (inclusive)
      const int t = 8 * lane + i;
      if (t >= q0 && t < K) psum += av[i];
      pv[i] = psum;
    }
    float sinc = ssum, pinc = psum;    // inclusive scans of the lane sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float so = __shfl_down_sync(FULL, sinc, off);
      const float po = __shfl_up_sync(FULL, pinc, off);
      if (lane + off < 32) sinc += so;
      if (lane >= off) pinc += po;
    }
    float safter = __shfl_down_sync(FULL, sinc, 1);   // lanes after this one
    float pbefore = __shfl_up_sync(FULL, pinc, 1);    // lanes before it
    if (lane == 31) safter = 0.f;
    if (lane == 0) pbefore = 0.f;
    const float total = __shfl_sync(FULL, sinc, 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * lane + i;
      if (t < q0) cs[hw * QMAX + t] = dw[t] * exp2f(sv[i] + safter);
      if (t >= q0 && t < K) {
        dk[hw * TQ + t - q0] = dw[t];
        lc[hw * TQ + t - q0] = pv[i] + pbefore;
      }
    }
    if (lane == 0) pre[hw] = total;
  }

  // per head: the x rows of the keys and the entering state, two stages
  auto stage = [&](int j) {
    return reinterpret_cast<bf16*>(smem_raw + L.r + (j & 1) * L.stage);
  };
  auto issue = [&](int j) {
    bf16* Xs = stage(j);
    const int hh = h_first + j;
    const bf16* xb = x + b * d.xsb + (long long)hh * d.P + (long long)t0 * d.xst;
    load_rows<PP>(Xs, LX, xb, d.xst, K, kv, PP, d.P, d.vx);
    if (inter) {
      const bf16* planes = reinterpret_cast<const bf16*>(
          dstate + ((long long)b * d.nc + c) * d.Rs);
      bf16* Sh = Xs + d.QT * LX;
      load_state<PP>(Sh, Sh + d.NP * LX, LX, planes, (long long)hh * d.E,
                     d.N, d.P, d.NP, d.vs);
    }
    cp_async_commit();
  };
  __syncthreads();                   // C B^T is in registers: B is free
  issue(0);

  const int qq0 = 16 * rg + g8, qq1 = qq0 + 8;     // this thread's rows - q0
  for (int j = 0; j < nh; ++j) {
    const int hh = h_first + j;
    cp_async_wait<0>();
    __syncthreads();                 // head j landed; the other stage is free
    if (j + 1 < nh) issue(j + 1);
    const bf16* Xs = stage(j);
    const bf16* Sh = Xs + d.QT * LX;
    const bf16* Sl = Sh + d.NP * LX;
    const float* csj = cs + j * QMAX;
    const float* dkj = dk + j * TQ;
    const float* lcj = lc + j * TQ;

    float acc[NPT][4];
#pragma unroll
    for (int i = 0; i < NPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    const float l0 = lcj[qq0], l1 = lcj[qq1];
    if (inter) {                     // this split's 16-wide steps of n
      for (int ks = 16 * part; ks < d.NP; ks += 16 * KS) {
        uint32_t af[4];
        ldsm_x4(af, crow + ks);
        const int sr = ks + (j8 & 1) * 8 + (lane & 7);
#pragma unroll
        for (int pn = 0; pn < NPT; pn += 2) {
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, Sh + sr * LX + pn * 8 + (j8 >> 1) * 8);
          ldsm_x4_t(bl, Sl + sr * LX + pn * 8 + (j8 >> 1) * 8);
          mma(acc[pn], af, bh[0], bh[1]);
          mma(acc[pn + 1], af, bh[2], bh[3]);
          mma(acc[pn], af, bl[0], bl[1]);
          mma(acc[pn + 1], af, bl[2], bl[3]);
        }
      }
      const float r = exp2f(pre[j]);   // the rows' own factor comes below
#pragma unroll
      for (int pn = 0; pn < NPT; ++pn) {
        acc[pn][0] *= r; acc[pn][1] *= r;
        acc[pn][2] *= r; acc[pn][3] *= r;
      }
    }

    // intra: the scores times their decay and dt, split hi + lo, times x.
    // Keys before the tile first, scaled by cs_k; then the rows' factor
    // exp2(l) (rank-1 decay, both factors <= 1) scales them and the inter
    // term; then the keys of the tile, with a decay per element.
    const int n_off = min(npair, (q0 / 16 - part + KS - 1) / KS);
    auto product = [&](int jj, const uint32_t (&ph)[4], const uint32_t (&pl)[4]) {
      const int xr = 16 * (jj * KS + part) + (j8 & 1) * 8 + (lane & 7);
#pragma unroll
      for (int pn = 0; pn < NPT; pn += 2) {
        uint32_t bx[4];
        ldsm_x4_t(bx, Xs + xr * LX + pn * 8 + (j8 >> 1) * 8);
        mma(acc[pn], ph, bx[0], bx[1]);
        mma(acc[pn + 1], ph, bx[2], bx[3]);
        mma(acc[pn], pl, bx[0], bx[1]);
        mma(acc[pn + 1], pl, bx[2], bx[3]);
      }
    };
#pragma unroll
    for (int jj = 0; jj < NCB / 2; ++jj) {
      if (jj < n_off) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float (&s)[4] = cb[2 * jj + u];
          const float2 cc = *reinterpret_cast<const float2*>(
              csj + 16 * (jj * KS + part) + 8 * u + 2 * t4);
          split2(s[0] * cc.x, s[1] * cc.y, ph[2 * u], pl[2 * u]);
          split2(s[2] * cc.x, s[3] * cc.y, ph[2 * u + 1], pl[2 * u + 1]);
        }
        product(jj, ph, pl);
      }
    }
    const float f0 = exp2f(l0), f1 = exp2f(l1);
#pragma unroll
    for (int pn = 0; pn < NPT; ++pn) {
      acc[pn][0] *= f0; acc[pn][1] *= f0;
      acc[pn][2] *= f1; acc[pn][3] *= f1;
    }
#pragma unroll
    for (int jj = 0; jj < NCB / 2; ++jj) {
      if (jj >= n_off && jj < npair) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float (&s)[4] = cb[2 * jj + u];
          const int kk = 16 * (jj * KS + part) + 8 * u + 2 * t4 - q0;   // exp only where k <= q
          const float d0 = dkj[kk], d1 = dkj[kk + 1];
          const float e0 = lcj[kk], e1 = lcj[kk + 1];
          const float v00 = kk <= qq0 ? s[0] * d0 * exp2f(l0 - e0) : 0.f;
          const float v01 = kk + 1 <= qq0 ? s[1] * d1 * exp2f(l0 - e1) : 0.f;
          const float v10 = kk <= qq1 ? s[2] * d0 * exp2f(l1 - e0) : 0.f;
          const float v11 = kk + 1 <= qq1 ? s[3] * d1 * exp2f(l1 - e1) : 0.f;
          split2(v00, v01, ph[2 * u], pl[2 * u]);
          split2(v10, v11, ph[2 * u + 1], pl[2 * u + 1]);
        }
        product(jj, ph, pl);
      }
    }

    // the splits' partial y meet in shared memory, over this stage
    __syncthreads();
    float4* red = reinterpret_cast<float4*>(stage(j));
    if (part) {
#pragma unroll
      for (int pn = 0; pn < NPT; ++pn)
        red[(((part - 1) * 4 + rg) * NPT + pn) * 32 + lane] =
            make_float4(acc[pn][0], acc[pn][1], acc[pn][2], acc[pn][3]);
    }
    __syncthreads();
    bf16* ys = reinterpret_cast<bf16*>(red + (KS - 1) * 4 * NPT * 32);
    if (!part) {                     // y rows as bf16
#pragma unroll
      for (int pn = 0; pn < NPT; ++pn) {
#pragma unroll
        for (int o = 1; o < KS; ++o) {
          const float4 v = red[(((o - 1) * 4 + rg) * NPT + pn) * 32 + lane];
          acc[pn][0] += v.x; acc[pn][1] += v.y;
          acc[pn][2] += v.z; acc[pn][3] += v.w;
        }
        const int p = pn * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(ys + qq0 * LX + p) =
            __floats2bfloat162_rn(acc[pn][0], acc[pn][1]);
        *reinterpret_cast<__nv_bfloat162*>(ys + qq1 * LX + p) =
            __floats2bfloat162_rn(acc[pn][2], acc[pn][3]);
      }
    }
    __syncthreads();
    // rows of y, 16 bytes a thread where p allows
    bf16* yb = y + (((long long)b * d.S + t0 + q0) * d.H + hh) * d.P;
    const long long yst = (long long)d.H * d.P;
    const int rows = min(TQ, d.Q - q0);
    for (int i = tid; i < rows * NPT; i += THREADS) {
      const int r = i / NPT, c8 = (i - r * NPT) * 8;
      if (c8 >= d.P) continue;
      const bf16* src = ys + r * LX + c8;
      bf16* dst = yb + r * yst + c8;
      if (d.vy) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && c8 + k < d.P; ++k) dst[k] = src[k];
      }
    }
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess) configured = true;
  return err;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int PP>
int launch_bf16_pp(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* init, void* y,
                   void* state, void* scratch, void* tot, const Dims& d, int b,
                   int stages, cudaStream_t stream) {
  static bool cfg_states = false, cfg_scan = false;
  const int smem1 = states_smem(d.NP, PP);
  const int smem3 = scan_layout(d.NP, PP, d.QT).total;
  if (smem1 > SMEM_LIMIT || smem3 > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ssd_states_bf16<PP>, cfg_states);
  if (err == cudaSuccess) err = allow_smem(ssd_scan_bf16<PP>, cfg_scan);
  if (err != cudaSuccess) return (int)err;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(B);
  const bf16* Cb = static_cast<const bf16*>(C);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* scr = static_cast<float*>(scratch);
  float* totf = static_cast<float*>(tot);
  const int hpg = d.H / d.G;
  if (stages & 1) {
    ssd_states_bf16<PP><<<dim3(d.nc, d.H, b), THREADS, smem1, stream>>>(
        xb, dtf, Af, Bb, scr, totf, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & 2) {
    const long long lanes = d.Rs / 8;   // 8 elements a lane
    ssd_pass<<<dim3((unsigned)((lanes + THREADS - 1) / THREADS), b), THREADS,
               0, stream>>>(
        scr, totf, static_cast<const float*>(init), static_cast<float*>(state),
        d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (stages & 4) {
    const dim3 grid(d.QT / TQ, d.G * ((hpg + d.HT - 1) / d.HT), d.nc * b);
    ssd_scan_bf16<PP><<<grid, THREADS, smem3, stream>>>(
        xb, dtf, Af, Bb, Cb, scr, static_cast<bf16*>(y), d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

int launch_bf16(const void* x, const void* dt, const void* A, const void* B,
                const void* C, const void* init, void* y, void* state,
                void* scratch, void* tot, int b, int s, int h, int p, int g,
                int n, int q, int heads, long long xsb, long long xst,
                long long bsb, long long bst, long long csb, long long cst,
                int stages, cudaStream_t stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p > 64 || g <= 0 || n <= 0 ||
      n > 128 || h % g != 0 || q <= 0 || q > QMAX || s % q != 0 ||
      heads <= 0 || heads > HT_MAX || (long long)(s / q) * b > 65535)
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.S = s; d.H = h; d.P = p; d.G = g; d.N = n; d.Q = q; d.nc = s / q;
  d.NP = (n + 15) / 16 * 16;
  d.QT = (q + TQ - 1) / TQ * TQ;
  d.HT = heads;
  d.xsb = xsb; d.xst = xst; d.bsb = bsb; d.bst = bst; d.csb = csb; d.cst = cst;
  d.vx = p % 8 == 0 && xsb % 8 == 0 && xst % 8 == 0 && aligned16(x);
  d.vb = n % 8 == 0 && bsb % 8 == 0 && bst % 8 == 0 && aligned16(B);
  d.vc = n % 8 == 0 && csb % 8 == 0 && cst % 8 == 0 && aligned16(C);
  d.vs = p % 8 == 0 && aligned16(scratch);
  d.vy = p % 8 == 0 && aligned16(y);
  d.has_init = init != nullptr;
  d.E = n * p;
  d.Rs = ((long long)h * d.E + 255) / 256 * 256;
  if (p <= 16)
    return launch_bf16_pp<16>(x, dt, A, B, C, init, y, state, scratch, tot, d,
                              b, stages, stream);
  if (p <= 32)
    return launch_bf16_pp<32>(x, dt, A, B, C, init, y, state, scratch, tot, d,
                              b, stages, stream);
  return launch_bf16_pp<64>(x, dt, A, B, C, init, y, state, scratch, tot, d,
                            b, stages, stream);
}

}  // namespace

extern "C" {

int ssd_chunk_scan_f32(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* init,
                       void* y, void* state, int b, int s, int h, int p,
                       int g, int n, int q, int tile, long long xsb,
                       long long xst, long long bsb, long long bst,
                       long long csb, long long cst, void* stream) {
  return launch_f32(x, dt, A, B, C, init, y, state, b, s, h, p, g, n, q, tile,
                    xsb, xst, bsb, bst, csb, cst,
                    static_cast<cudaStream_t>(stream));
}

// stages: 1 chunk states, 2 state pass, 4 chunk scan (7 for the whole op)
int ssd_chunk_scan_bf16(const void* x, const void* dt, const void* A,
                        const void* B, const void* C, const void* init,
                        void* y, void* state, void* scratch, void* tot, int b,
                        int s, int h, int p, int g, int n, int q, int heads,
                        long long xsb, long long xst, long long bsb,
                        long long bst, long long csb, long long cst,
                        int stages, void* stream) {
  return launch_bf16(x, dt, A, B, C, init, y, state, scratch, tot, b, s, h, p,
                     g, n, q, heads, xsb, xst, bsb, bst, csb, cst, stages,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
