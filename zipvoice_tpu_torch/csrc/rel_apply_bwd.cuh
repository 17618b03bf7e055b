// Flash backward of the shared-probabilities attention consumer (B3): its
// kernels and launch code.  rel_apply_bwd.cu builds them for f32 inputs
// with the C entry point, rel_apply_bwd_bf16.cu for bf16 inputs, as two
// sources of one library that nvcc compiles side by side.
//
// Replaces the TPU kernel zipvoice_tpu/ops/attention.py
// `_pallas_rel_apply_bwd` (body `_apply_bwd_kernel`), the backward of
// out = probs @ v where probs = softmax(s + bias) is recomputed from
// s[i,j] = q_i.k_j + pq_i.pe[j-i+Tq-1] instead of read back:
//
//   used = const_gate ? (p > 0) / count(p > 0) : p       (per row)
//   dv   = used^T g
//   ds   = const_gate ? 0 : p * (dP - D),  dP = g v^T, D_i = sum_j p_ij dP_ij
//   ds  += pen * sign(s) * (|s| > limit)                  (pre-mask s, keys j < valid_cols)
//   dq = ds k,  dk = ds^T q,  dpq_i = sum_j ds_ij pe[j-i+Tq-1],
//   dpe[n] = sum_{b, i} ds_{i, n+i-Tq+1} pq_i              (summed over batch)
//
// Tq query rows i against Tk keys j: q, pq, g (B,Tq,H,.); k (via kt =
// (B,H,QD,Tk)), v (B,Tk,H,VD); pe (Tq+Tk-1,H,PD); mask (B,Tk).  The square
// case Tq = Tk = T is a whole sequence; a rectangular tile is a block of
// query rows [r0, r0 + Tq) of a longer sequence against all of its keys,
// pe the window pe[Tk - r0 - Tq : 2 Tk - 1 - r0] of the square pe (a rank's
// share under sequence parallelism), so that the kernels need no row
// offset: the band index j - i + Tq - 1 runs over [0, Tq + Tk - 1).  The
// square case has instantiations of its own with Tk = Tq known to the
// compiler, so that it pays nothing for the second size.  Inputs f32
// or all bf16; VD = 12 (SelfAttention, H = 4) or the NonlinAttention head-0
// width (VD = 3D/4 = 384 or 144 at H = 1), VD <= 384.  Outputs are f32.
//
// What bounds it on an H100: the arithmetic on the CUDA cores (f32 and bf16
// inputs alike: `used` and ds stay f32, and f32 inputs never take TF32).
// Each (i, j) pair costs the score (QD+4 FMAs) three times, dP (VD FMAs)
// three times at VD = 12 and twice for wider values, dv, dq and dk once.
// The design is the SGEMM structure:
//   * a block computes 64 x 64 (row, key) tiles with 256 threads; a thread
//     owns 4 rows x 4 keys (rows 4ty.., keys tx, tx+16, tx+32, tx+48) of
//     s, p, dP and ds in registers, and every operand row (q, k, g, v) sits
//     in shared memory row-major with an odd float4 count a row, read as
//     float4 broadcasts: 8 shared loads for 64 FMAs;
//   * the 64 x QD products (dq, dk) give a thread 4 rows x 4 dims and a
//     share of the tile's keys (rows), two float4 loads for 16 FMAs; the
//     shares meet in shared memory once, at the end, in a fixed order;
//   * the score keeps the summation order of B1 (rel_common.cuh
//     `row_tile_scores`): q.k over d in order, then the four pe terms, then
//     the mask bias, and with the const gate p takes B1's expf; so p > 0,
//     the const gate's support, is B1's.  Without the gate p takes the
//     hardware's exp (a few ulp; both passes use it);
//   * pass 1 (rows): a block owns 64 query rows and streams key tiles.  A
//     first sweep gathers the row max, 1/sum and D = sum p dP, rescaling
//     online as the max moves; with the const gate the max and then the sum
//     are taken exactly as B1 takes them (32 key classes j mod 32, each
//     summed in key order, then the same shuffle tree), so 1/sum and p are
//     B1's bit for bit.  A second sweep computes p, count(p > 0), ds, dq,
//     dpq, and stores max, 1/sum, D and the count per row.  For wide values
//     the first sweep skips dP: the second sums D itself and takes
//     dq = sum p dP k - D sum p k (dpq likewise);
//   * pass 2 (columns): a block owns 64 keys and streams query tiles: p from
//     pass 1's statistics (the same operations, so the same values), dP,
//     ds; dv (4 keys x 12 dims a thread in registers at VD <= 12, 4 keys x
//     4 dims per 64-dim chunk otherwise), dk, and the tile's dpe diagonals
//     (127 x 4 sums, two threads a diagonal, no branch per element), added
//     to the batch-summed dpe with one atomic each;
//   * at VD = 12 both passes run two blocks an SM (128 registers), and a
//     tile's operands are loaded just before it is computed (the other
//     block hides the wait); for wide values (VD > 12, one block an SM) the
//     next tile's operands are loaded into registers while the current one
//     is computed and stored to a second buffer after it, as measured
//     fastest for each;
//   * wide values: the block's own rows of g (pass 1) or keys of v (pass 2)
//     stay in shared memory, the other operand streams in chunks of 64
//     dims, double-buffered through registers the same way.
// No shared-memory row is Tq or Tk long and any Tq, Tk work.  dq, dk, dpq and dv are
// written once, in a fixed order.

#pragma once

#include "rel_common.cuh"

namespace {

using namespace zv;

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows and keys of a tile
constexpr int kBandRows = 128;  // pe rows a tile touches (127) padded
constexpr int kNW = 12;         // narrow value width (VD <= 12, zero-padded)
constexpr int kCW = 64;         // value dims a wide kernel streams at once
constexpr int kMaxChunks = 6;   // wide: VD <= kMaxChunks * kCW
constexpr int kPS = kTile + 4;  // row stride of the shared pair tiles (ds, used)
constexpr int kClsS = 33;       // row stride of the key-class partial sums
// the 64 x QD products (dq, dk): a thread owns 4 rows (keys) x 4 dims and a
// share of the tile's 64 keys (rows); QD / 4 dim quads x 16 row quads x
// kSplits(QD) shares fill the block
__host__ __device__ constexpr int kSplits(int QD) { return kThreads / (16 * (QD / 4)); }

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// a row stride of w floats (w % 4 == 0) with an odd float4 count, so the 8
// lanes of a float4 phase that read 8 rows hit distinct banks
__host__ __device__ constexpr int odd4(int w) { return (w / 4) % 2 == 0 ? w + 4 : w; }

constexpr int kNS = odd4(kNW);  // narrow value row stride
constexpr int kCS = odd4(kCW);  // wide chunk row stride

// acc[r][c] += sum_d A[(4ty+r)*as + d] * B[(tx+16c)*bs + d] over d < 4*N4,
// d in order: a thread's 4 rows x 4 keys
template <int N4>
__device__ __forceinline__ void micro(float (&acc)[4][4], const float* A, int as, const float* B,
                                      int bs) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* a0 = A + 4 * ty * as;
  const float* b0 = B + tx * bs;
#pragma unroll
  for (int d4 = 0; d4 < N4; ++d4) {
    float4 a[4], w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(a0 + r * as + 4 * d4);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[c] = *reinterpret_cast<const float4*>(b0 + 16 * c * bs + 4 * d4);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(a[r].x, w[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, w[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, w[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, w[c].w, acc[r][c]);
      }
  }
}

// s[r][c] = q.k (rows of Qr, keys of Kr) then + pq . pe[j - i + Tq - 1] from
// the tile's band (band row j_local - i_local + 63): B1's order
template <int QD>
__device__ __forceinline__ void tile_scores(float (&s)[4][4], const float* Qr, const float* Kr,
                                            const float* PQ, const float* band) {
  constexpr int QS = odd4(QD);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  micro<QD / 4>(s, Qr, QS, Kr, QS);
  const float4* pq4 = reinterpret_cast<const float4*>(PQ);
  const float4* band4 = reinterpret_cast<const float4*>(band);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 pv = pq4[4 * ty + r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 ev = band4[tx + 16 * c - 4 * ty - r + kTile - 1];
      s[r][c] = fmaf(pv.x, ev.x, s[r][c]);
      s[r][c] = fmaf(pv.y, ev.y, s[r][c]);
      s[r][c] = fmaf(pv.z, ev.z, s[r][c]);
      s[r][c] = fmaf(pv.w, ev.w, s[r][c]);
    }
  }
}

// exp of a score: expf, B1's own, where p > 0 must be B1's (the const gate's
// support); elsewhere the hardware's ex2 (a few ulp at |x| < 20, within the
// tolerance of every output, and the two passes agree on it)
__device__ __forceinline__ float exp_s(float x, bool exact) { return exact ? expf(x) : __expf(x); }

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[r][c] = 0.f;
}

// Sum over the 16 key lanes (tx) of a row quad.
__device__ __forceinline__ float tx_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Offsets (floats, 16-byte aligned) of a pass's shared-memory regions.
struct Carve {
  int off = 0;
  __host__ __device__ int take(int n) {
    const int r = off;
    off += round4(n);
    return r;
  }
};

// Pass 1 regions: q rows | pq rows | g rows (resident) | per buffer: k tile,
// pe band, key bias, narrow v tile | wide v chunks x 2 | ds tile (also the
// key-class sums) | wide: p tile | row statistics
struct RowsLayout {
  int q, pq, g, k[2], band[2], bias[2], v[2], ds, ds2, rs, total;
  __host__ __device__ RowsLayout(int QD, bool wide, int RS) {
    Carve c;
    const int QS = odd4(QD);
    q = c.take(kTile * QS);
    pq = c.take(kTile * kPD);
    g = c.take(kTile * (wide ? RS : kNS));
    for (int i = 0; i < 2; ++i) {
      k[i] = c.take(kTile * QS);
      band[i] = c.take(kBandRows * kPD);
      bias[i] = c.take(kTile);
      v[i] = c.take(kTile * (wide ? kCS : kNS));
    }
    ds = c.take(kTile * kPS);
    ds2 = c.take(wide ? kTile * kPS : 0);
    rs = c.take(kTile * 4);
    total = c.off;
  }
};

// Stage rows x0 .. x0+63 of a (B,T,H,W) tensor's (b, h) slice, dims d0 ..
// d0+w-1 (zero past T and past W), into dst[x * stride + d].
template <typename Tin>
__device__ __forceinline__ void stage_rows(const Tin* __restrict__ src, float* dst, int stride,
                                           int w, int b, int h, int T, int H, int W, int x0,
                                           int d0) {
  staged_copy<4>(
      kTile * w,
      [&](int idx) {
        const int x = idx / w, d = d0 + idx % w;
        return (x0 + x < T && d < W) ? to_f32(src[((size_t)(b * T + x0 + x) * H + h) * W + d])
                                     : 0.f;
      },
      [&](int idx, float val) { dst[(idx / w) * stride + idx % w] = val; });
}

// A value chunk (64 rows of dims c*32 .. c*32+31) through registers: load
// now, store later, so the load overlaps the current chunk's arithmetic.
template <typename Tin>
struct ChunkPipe {
  float r[kTile * kCW / kThreads];
  __device__ __forceinline__ void load(const Tin* __restrict__ src, int b, int h, int T, int H,
                                       int W, int x0, int c) {
#pragma unroll
    for (int u = 0; u < kTile * kCW / kThreads; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      const int x = idx / kCW, d = c * kCW + idx % kCW;
      r[u] = (x0 + x < T && d < W) ? to_f32(src[((size_t)(b * T + x0 + x) * H + h) * W + d])
                                   : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int u = 0; u < kTile * kCW / kThreads; ++u) {
      const int idx = threadIdx.x + u * kThreads;
      dst[(idx / kCW) * kCS + idx % kCW] = r[u];
    }
  }
};

// pass 1: a block owns rows i0 .. i0+63 of one (b,h).  kSquare: Tk is
// Tq, known to the compiler (see launch_in)
template <int QD, typename Tin, bool kWide, bool kSquare>
__global__ void __launch_bounds__(kThreads, kWide ? 1 : 2)
bwd_rows_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                const Tin* __restrict__ pq, const Tin* __restrict__ pe,
                const uint8_t* __restrict__ mask, const Tin* __restrict__ v,
                const Tin* __restrict__ g, float* __restrict__ stats,
                float* __restrict__ dq, float* __restrict__ dpq, int Tq, int Tk_, int H, int VD,
                int RS, int nvc, int const_gate, int valid_cols, float pen, float limit) {
  const int Tk = kSquare ? Tq : Tk_;
  constexpr int QS = odd4(QD);
  constexpr int NK = QD * kTile / kThreads;
  constexpr int KQ = QD / 4, NS = kSplits(QD), SPAN = kTile / NS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const RowsLayout L(QD, kWide, RS);
  float* Qr = sm + L.q;
  float* PQ = sm + L.pq;
  float* Gr = sm + L.g;
  float* DS = sm + L.ds;
  float* rs = sm + L.rs;  // [row][mx, inv, D, -]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * kTile;
  const int nt = (Tk + kTile - 1) / kTile;
  const Tin* ktb = kt + (size_t)bh * QD * Tk;
  const int GS = kWide ? RS : kNS;

  stage_rows(q, Qr, QS, QD, b, h, Tq, H, QD, i0, 0);
  stage_rows(pq, PQ, kPD, kPD, b, h, Tq, H, kPD, i0, 0);
  stage_rows(g, Gr, GS, kWide ? nvc * kCW : kNW, b, h, Tq, H, VD, i0, 0);

  // the next key tile through registers: k (from kt: coalesced over keys),
  // the pe band, the key bias, a narrow v tile
  float rk[NK], rb[2], rz, rv[kTile * kNW / kThreads];
  auto fetch = [&](int t) {
    const int j0 = t * kTile;
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const int idx = tid + u * kThreads, d = idx / kTile, x = idx % kTile;
      rk[u] = j0 + x < Tk ? to_f32(ktb[(size_t)d * Tk + j0 + x]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = tid + u * kThreads, w = idx / kPD, e = idx % kPD;
      const int n = j0 - i0 + Tq - kTile + w;
      rb[u] = (w < 2 * kTile - 1 && n >= 0 && n < Tq + Tk - 1)
                  ? to_f32(pe[((size_t)n * H + h) * kPD + e]) : 0.f;
    }
    rz = (tid < kTile && j0 + tid < Tk) ? mask_bias(mask, b, Tk, j0 + tid) : 0.f;
    if (!kWide) {
#pragma unroll
      for (int u = 0; u < kTile * kNW / kThreads; ++u) {
        const int idx = tid + u * kThreads, x = idx / kNW, d = idx % kNW;
        rv[u] = (j0 + x < Tk && d < VD)
                    ? to_f32(v[((size_t)(b * Tk + j0 + x) * H + h) * VD + d]) : 0.f;
      }
    }
  };
  auto put = [&](int t) {
    const int p = t & 1;
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const int idx = tid + u * kThreads;
      sm[L.k[p] + (idx % kTile) * QS + idx / kTile] = rk[u];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) sm[L.band[p] + tid + u * kThreads] = rb[u];
    if (tid < kTile) sm[L.bias[p] + tid] = rz;
    if (!kWide) {
#pragma unroll
      for (int u = 0; u < kTile * kNW / kThreads; ++u) {
        const int idx = tid + u * kThreads;
        sm[L.v[p] + (idx / kNW) * kNS + idx % kNW] = rv[u];
      }
    }
  };
  // body(t) for every key tile, the tile's operands in buffer t & 1; wide:
  // the next tile is loaded while this one is computed (at VD = 12 the
  // registers are worth more: two blocks an SM hide the load instead)
  auto for_tiles = [&](auto&& body) {
    if (kWide) fetch(0);
    for (int t = 0; t < nt; ++t) {
      if (!kWide) fetch(t);
      put(t);
      __syncthreads();
      if (kWide && t + 1 < nt) fetch(t + 1);
      body(t);
    }
    __syncthreads();
  };
  // dP of the tile: g rows (resident) against the tile's v
  ChunkPipe<Tin> pipe;
  auto tile_dp = [&](int t, float (&dp)[4][4]) {
    zero(dp);
    if (!kWide) {
      micro<kNW / 4>(dp, Gr, kNS, sm + L.v[t & 1], kNS);
      return;
    }
    pipe.load(v, b, h, Tk, H, VD, t * kTile, 0);
    for (int c = 0; c < nvc; ++c) {
      pipe.store(sm + L.v[c & 1]);
      __syncthreads();
      if (c + 1 < nvc) pipe.load(v, b, h, Tk, H, VD, t * kTile, c + 1);
      micro<kCW / 4>(dp, Gr + c * kCW, RS, sm + L.v[c & 1], kCS);
    }
  };

  // ---- sweep 1: row statistics ------------------------------------------
  float mx[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) mx[r] = -INFINITY;
  if (!const_gate) {
    // online max, sum of e = exp(x - max) and sum of e * dP
    float l[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
    for_tiles([&](int t) {
      float s[4][4], dp[4][4];
      tile_scores<QD>(s, Qr, sm + L.k[t & 1], PQ, sm + L.band[t & 1]);
      // wide: D is summed in sweep 2 instead (one dP product fewer)
      if (kWide) zero(dp);
      else tile_dp(t, dp);
      const float* Z = sm + L.bias[t & 1];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x[4], mt = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x[c] = s[r][c] + Z[tx + 16 * c];
          if (t * kTile + tx + 16 * c < Tk) mt = fmaxf(mt, x[c]);
        }
        if (mt > mx[r]) {
          const float sc = __expf(mx[r] - mt);
          l[r] *= sc;
          u[r] *= sc;
          mx[r] = mt;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (t * kTile + tx + 16 * c < Tk) {
            const float e = __expf(x[c] - mx[r]);
            l[r] += e;
            u[r] = fmaf(e, dp[r][c], u[r]);
          }
        }
      }
    });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, mx[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        const float uo = __shfl_xor_sync(0xffffffffu, u[r], o);
        const float m = fmaxf(mx[r], mo);
        const float a = mx[r] == -INFINITY ? 0.f : __expf(mx[r] - m);
        const float a2 = mo == -INFINITY ? 0.f : __expf(mo - m);
        l[r] = l[r] * a + lo * a2;
        u[r] = u[r] * a + uo * a2;
        mx[r] = m;
      }
      if (tx == 0) {
        const float inv = 1.f / l[r];
        rs[(4 * ty + r) * 4] = mx[r];
        rs[(4 * ty + r) * 4 + 1] = inv;
        rs[(4 * ty + r) * 4 + 2] = u[r] * inv;
      }
    }
  } else {
    // B1's statistics exactly: the max, then 32 key classes (j mod 32) each
    // summed in key order and joined by B1's shuffle tree
    for_tiles([&](int t) {
      float s[4][4];
      tile_scores<QD>(s, Qr, sm + L.k[t & 1], PQ, sm + L.band[t & 1]);
      const float* Z = sm + L.bias[t & 1];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (t * kTile + tx + 16 * c < Tk) mx[r] = fmaxf(mx[r], s[r][c] + Z[tx + 16 * c]);
    });
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    float part[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for_tiles([&](int t) {
      float s[4][4];
      tile_scores<QD>(s, Qr, sm + L.k[t & 1], PQ, sm + L.band[t & 1]);
      const float* Z = sm + L.bias[t & 1];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)  // c = 0, 2: class tx; c = 1, 3: class tx + 16
          if (t * kTile + tx + 16 * c < Tk)
            part[r][c & 1] += expf(s[r][c] + Z[tx + 16 * c] - mx[r]);
    });
    float* cls = DS;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      cls[(4 * ty + r) * kClsS + tx] = part[r][0];
      cls[(4 * ty + r) * kClsS + tx + 16] = part[r][1];
      if (tx == 0) {
        rs[(4 * ty + r) * 4] = mx[r];
        rs[(4 * ty + r) * 4 + 2] = 0.f;
      }
    }
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    for (int row = warp; row < kTile; row += kThreads / 32) {
      const float sum = warp_sum(cls[row * kClsS + lane]);
      if (lane == 0) rs[row * 4 + 1] = 1.f / sum;
    }
  }
  __syncthreads();

  // ---- sweep 2: p, count(p > 0), ds, dq, dpq -----------------------------
  // dq: thread = (key share qs, row quad qr, dim quad qd)
  const bool dq_thread = tid < NS * 16 * KQ;
  const int qs = tid / (16 * KQ), qr = tid % (16 * KQ) / KQ, qd = tid % KQ;
  // wide: ds is taken as p dP (+ penalty) and D's share is subtracted at
  // the end: dq = sum p dP k - D sum p k (dqy), dpq likewise (dpqy)
  float dqa[4][4], dqy[4][4], dpqa[4][kPD], dpqy[4][kPD], cnt[4], dsum[4];
  zero(dqa);
  zero(dqy);
  zero(dpqa);
  zero(dpqy);
#pragma unroll
  for (int r = 0; r < 4; ++r) cnt[r] = dsum[r] = 0.f;
  const bool need_ds = !const_gate || pen != 0.f;
  for_tiles([&](int t) {
    const int j0 = t * kTile;
    const float* K = sm + L.k[t & 1];
    const float* band = sm + L.band[t & 1];
    const float* Z = sm + L.bias[t & 1];
    float s[4][4], dp[4][4], pw[4][4];
    tile_scores<QD>(s, Qr, K, PQ, band);
    if (!const_gate) tile_dp(t, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 st = *reinterpret_cast<const float4*>(rs + (4 * ty + r) * 4);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        float d = 0.f, w = 0.f;
        if (j < Tk) {
          const float p = exp_s(s[r][c] + Z[tx + 16 * c] - st.x, const_gate) * st.y;
          if (const_gate) {
            cnt[r] += p > 0.f ? 1.f : 0.f;
          } else if (kWide) {
            d = p * dp[r][c];
            w = p;
            dsum[r] = fmaf(p, dp[r][c], dsum[r]);
          } else {
            d = p * (dp[r][c] - st.z);
          }
          if (j < valid_cols) d += penalty_term(s[r][c], pen, limit);
        }
        s[r][c] = d;  // s now holds ds (wide: without D's share)
        pw[r][c] = w;
      }
    }
    if (need_ds) {
      // ds to shared memory, key-major (a key's 4 rows as one float4)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<float4*>(DS + (tx + 16 * c) * kPS + 4 * ty) =
            make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
        if (kWide)
          *reinterpret_cast<float4*>(sm + L.ds2 + (tx + 16 * c) * kPS + 4 * ty) =
              make_float4(pw[0][c], pw[1][c], pw[2][c], pw[3][c]);
      }
      // dpq from the registers: band row j - i + Tq - 1 of each pair
      const float4* band4 = reinterpret_cast<const float4*>(band);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 ev = band4[tx + 16 * c - 4 * ty - r + kTile - 1];
          const float evs[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
          for (int e = 0; e < kPD; ++e) {
            dpqa[r][e] = fmaf(s[r][c], evs[e], dpqa[r][e]);
            if (kWide) dpqy[r][e] = fmaf(pw[r][c], evs[e], dpqy[r][e]);
          }
        }
      __syncthreads();
      // dq[rows 4qr.., dims 4qd..] += ds[rows, keys] k[keys, dims] over the
      // thread's share of the keys: two float4 loads for 16 FMAs
      if (dq_thread) {
        const int k1 = min(qs * SPAN + SPAN, Tk - j0);
        for (int key = qs * SPAN; key < k1; ++key) {
          const float4 d4 = *reinterpret_cast<const float4*>(DS + key * kPS + 4 * qr);
          const float4 k4 = *reinterpret_cast<const float4*>(K + key * QS + 4 * qd);
          const float dr[4] = {d4.x, d4.y, d4.z, d4.w}, kd[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int m = 0; m < 4; ++m) dqa[r][m] = fmaf(dr[r], kd[m], dqa[r][m]);
          if (kWide) {
            const float4 p4 = *reinterpret_cast<const float4*>(sm + L.ds2 + key * kPS + 4 * qr);
            const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int m = 0; m < 4; ++m) dqy[r][m] = fmaf(pr[r], kd[m], dqy[r][m]);
          }
        }
      }
    }
  });

  const size_t bht = (size_t)gridDim.y * Tq;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float c_all = tx_sum(cnt[r]);
    float dd = rs[(4 * ty + r) * 4 + 2];
    if (kWide) dd = tx_sum(dsum[r]);  // D = sum p dP, gathered in this sweep
    float dpq_all[kPD];
#pragma unroll
    for (int e = 0; e < kPD; ++e) {
      dpq_all[e] = tx_sum(dpqa[r][e]);
      if (kWide) dpq_all[e] -= dd * tx_sum(dpqy[r][e]);
    }
    if (kWide && tx == 0) rs[(4 * ty + r) * 4 + 2] = dd;
    const int i = i0 + 4 * ty + r;
    if (i >= Tq) continue;
    const size_t row = ((size_t)(b * Tq + i) * H + h);
    if (tx == 0) {
      const size_t o = (size_t)bh * Tq + i;
      stats[o] = rs[(4 * ty + r) * 4];
      stats[bht + o] = rs[(4 * ty + r) * 4 + 1];
      stats[2 * bht + o] = dd;
      stats[3 * bht + o] = c_all;
#pragma unroll
      for (int e = 0; e < kPD; ++e) dpq[row * kPD + e] = dpq_all[e];
    }
  }
  // dq: the key shares meet in shared memory, added in a fixed order (wide:
  // the p k sums follow the p dP k sums, and D's share is subtracted)
  float* red = DS;  // [share][64 rows][QD], wide: then the same for dqy
  const int ny = NS * kTile * QD;
  if (dq_thread)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        red[(qs * kTile + 4 * qr + r) * QD + 4 * qd + m] = dqa[r][m];
        if (kWide) red[ny + (qs * kTile + 4 * qr + r) * QD + 4 * qd + m] = dqy[r][m];
      }
  __syncthreads();
  for (int idx = tid; idx < kTile * QD; idx += kThreads) {
    const int i = i0 + idx / QD;
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int sh = 0; sh < NS; ++sh) {
      x += red[sh * kTile * QD + idx];
      if (kWide) y += red[ny + sh * kTile * QD + idx];
    }
    if (kWide) x -= rs[(idx / QD) * 4 + 2] * y;
    if (i < Tq) dq[((size_t)(b * Tq + i) * H + h) * QD + idx % QD] = x;
  }
}

// Pass 2 regions: k of the block's keys | key bias | v of the keys
// (resident) | per buffer: q tile, pq tile, pe band, row statistics, narrow
// g tile | wide g chunks x 2 | used tile (wide) | ds tile (also dv's sums)
struct ColsLayout {
  int k, bias, v, q[2], pq[2], band[2], st[2], g[2], used, ds, total;
  __host__ __device__ ColsLayout(int QD, bool wide, int RS) {
    Carve c;
    const int QS = odd4(QD);
    k = c.take(kTile * QS);
    bias = c.take(kTile);
    v = c.take(kTile * (wide ? RS : kNS));
    for (int i = 0; i < 2; ++i) {
      q[i] = c.take(kTile * QS);
      pq[i] = c.take(kTile * kPD);
      band[i] = c.take(kBandRows * kPD);
      st[i] = c.take(kTile * 4);
      g[i] = c.take(kTile * (wide ? kCS : kNS));
    }
    used = c.take(wide ? kTile * kPS : 0);
    ds = c.take(kTile * kPS);
    total = c.off;
  }
};

// pass 2: a block owns keys j0 .. j0+63 of one (b,h); kSquare as pass 1's
template <int QD, typename Tin, bool kWide, bool kSquare>
__global__ void __launch_bounds__(kThreads, kWide ? 1 : 2)
bwd_cols_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                const Tin* __restrict__ pq, const Tin* __restrict__ pe,
                const uint8_t* __restrict__ mask, const Tin* __restrict__ v,
                const Tin* __restrict__ g, const float* __restrict__ stats,
                float* __restrict__ dk, float* __restrict__ dpe, float* __restrict__ dv, int Tq,
                int Tk_, int H, int VD, int RS, int nvc, int const_gate, int valid_cols,
                float pen, float limit) {
  const int Tk = kSquare ? Tq : Tk_;
  constexpr int QS = odd4(QD);
  constexpr int NQ = QD * kTile / kThreads;
  constexpr int KQ = QD / 4, NS = kSplits(QD), SPAN = kTile / NS;
  constexpr int NG = kTile * kNW / kThreads;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const ColsLayout L(QD, kWide, RS);
  float* Kr = sm + L.k;
  float* Z = sm + L.bias;
  float* Vr = sm + L.v;
  float* U = sm + L.used;
  float* DS = sm + L.ds;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int j0 = blockIdx.x * kTile;
  const int nt = (Tq + kTile - 1) / kTile;
  const size_t bht = (size_t)gridDim.y * Tq;
  const Tin* ktb = kt + (size_t)bh * QD * Tk;

  staged_copy<4>(
      QD * kTile,
      [&](int idx) {
        const int x = idx % kTile;
        return j0 + x < Tk ? to_f32(ktb[(size_t)(idx / kTile) * Tk + j0 + x]) : 0.f;
      },
      [&](int idx, float x) { Kr[(idx % kTile) * QS + idx / kTile] = x; });
  if (tid < kTile) Z[tid] = j0 + tid < Tk ? mask_bias(mask, b, Tk, j0 + tid) : 0.f;
  stage_rows(v, Vr, kWide ? RS : kNS, kWide ? nvc * kCW : kNW, b, h, Tk, H, VD, j0, 0);

  // the next query tile through registers: q, pq, the pe band, the rows'
  // statistics, a narrow g tile
  float rq[NQ], rp, rb[2], rst, rg[NG];
  auto fetch = [&](int t) {
    const int i0 = t * kTile;
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int idx = tid + u * kThreads, x = idx / QD, d = idx % QD;
      rq[u] = i0 + x < Tq ? to_f32(q[((size_t)(b * Tq + i0 + x) * H + h) * QD + d]) : 0.f;
    }
    {
      const int x = tid / kPD, e = tid % kPD;
      rp = i0 + x < Tq ? to_f32(pq[((size_t)(b * Tq + i0 + x) * H + h) * kPD + e]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = tid + u * kThreads, w = idx / kPD, e = idx % kPD;
      const int n = j0 - i0 + Tq - kTile + w;
      rb[u] = (w < 2 * kTile - 1 && n >= 0 && n < Tq + Tk - 1)
                  ? to_f32(pe[((size_t)n * H + h) * kPD + e]) : 0.f;
    }
    {
      const int k4 = tid / kTile, x = tid % kTile;
      rst = i0 + x < Tq ? stats[k4 * bht + (size_t)bh * Tq + i0 + x] : 0.f;
    }
    if (!kWide) {
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const int idx = tid + u * kThreads, x = idx / kNW, d = idx % kNW;
        rg[u] = (i0 + x < Tq && d < VD)
                    ? to_f32(g[((size_t)(b * Tq + i0 + x) * H + h) * VD + d]) : 0.f;
      }
    }
  };
  auto put = [&](int t) {
    const int p = t & 1;
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int idx = tid + u * kThreads;
      sm[L.q[p] + (idx / QD) * QS + idx % QD] = rq[u];
    }
    sm[L.pq[p] + tid] = rp;
#pragma unroll
    for (int u = 0; u < 2; ++u) sm[L.band[p] + tid + u * kThreads] = rb[u];
    sm[L.st[p] + (tid % kTile) * 4 + tid / kTile] = rst;
    if (!kWide) {
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const int idx = tid + u * kThreads;
        sm[L.g[p] + (idx / kNW) * kNS + idx % kNW] = rg[u];
      }
    }
  };

  // dk: thread = (row share ks, key group kg: keys kg + 16c, dim quad kd)
  const bool dk_thread = tid < NS * 16 * KQ;
  const int ks = tid / (16 * KQ), kg = tid % (16 * KQ) / KQ, kd = tid % KQ;
  float dka[4][4];
  float dvn[kWide ? 1 : 4][kNW];                     // narrow: 4 keys x 12 dims, over 4 rows
  float dvw[kWide ? kMaxChunks : 1][4][4];           // wide: 4 keys x 4 dims a chunk
  zero(dka);
#pragma unroll
  for (int c = 0; c < (kWide ? 1 : 4); ++c)
#pragma unroll
    for (int d = 0; d < kNW; ++d) dvn[c][d] = 0.f;
#pragma unroll
  for (int c = 0; c < (kWide ? kMaxChunks : 1); ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) dvw[c][k][0] = dvw[c][k][1] = dvw[c][k][2] = dvw[c][k][3] = 0.f;
  const bool need_ds = !const_gate || pen != 0.f;
  ChunkPipe<Tin> pipe;

  if (kWide) fetch(0);  // wide: the next tile loads while this one computes
  for (int t = 0; t < nt; ++t) {
    if (!kWide) fetch(t);
    put(t);
    __syncthreads();
    if (kWide && t + 1 < nt) fetch(t + 1);
    const int i0 = t * kTile, p = t & 1;
    const float* Qb = sm + L.q[p];
    const float* PQb = sm + L.pq[p];
    const float* St = sm + L.st[p];
    float s[4][4], used[4][4], dp[4][4];
    tile_scores<QD>(s, Qb, Kr, PQb, sm + L.band[p]);
    // p (or the const branch's weights) and the penalty share of ds
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 st = *reinterpret_cast<const float4*>(St + (4 * ty + r) * 4);
      const bool row_ok = i0 + 4 * ty + r < Tq;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        float w = 0.f, d = 0.f;
        if (row_ok && j < Tk) {
          const float pr = exp_s(s[r][c] + Z[tx + 16 * c] - st.x, const_gate) * st.y;
          w = const_gate ? (pr > 0.f ? 1.f / fmaxf(st.w, 1e-20f) : 0.f) : pr;
          if (j < valid_cols) d = penalty_term(s[r][c], pen, limit);
        }
        used[r][c] = w;
        s[r][c] = d;  // s now holds ds
      }
    }
    zero(dp);
    if (!kWide) {
      const float* Gb = sm + L.g[p];
      if (!const_gate) micro<kNW / 4>(dp, Gb, kNS, Vr, kNS);
      // dv[keys, :] += used[rows, keys]^T g[rows, :] over the thread's 4 rows
#pragma unroll
      for (int d4 = 0; d4 < kNW / 4; ++d4) {
        float4 gr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          gr[r] = *reinterpret_cast<const float4*>(Gb + (4 * ty + r) * kNS + 4 * d4);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dvn[c][4 * d4] = fmaf(used[r][c], gr[r].x, dvn[c][4 * d4]);
            dvn[c][4 * d4 + 1] = fmaf(used[r][c], gr[r].y, dvn[c][4 * d4 + 1]);
            dvn[c][4 * d4 + 2] = fmaf(used[r][c], gr[r].z, dvn[c][4 * d4 + 2]);
            dvn[c][4 * d4 + 3] = fmaf(used[r][c], gr[r].w, dvn[c][4 * d4 + 3]);
          }
      }
    } else {
      // used to shared memory (row-major, a row's 4 keys of a thread as one
      // float4); g streams in chunks: dP over the chunk's dims, and dv of
      // the chunk's dims as a 64 x 64 product over the tile's rows
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(U + (4 * ty + r) * kPS + 4 * tx) =
            make_float4(used[r][0], used[r][1], used[r][2], used[r][3]);
      const int nr = min(kTile, Tq - i0);
      pipe.load(g, b, h, Tq, H, VD, i0, 0);
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        if (c < nvc) {
          float* Gc = sm + L.g[c & 1];
          pipe.store(Gc);
          __syncthreads();
          if (c + 1 < nvc) pipe.load(g, b, h, Tq, H, VD, i0, c + 1);
          if (!const_gate) micro<kCW / 4>(dp, Gc, kCS, Vr + c * kCW, RS);
          for (int row = 0; row < nr; ++row) {
            const float4 u4 = *reinterpret_cast<const float4*>(U + row * kPS + 4 * tx);
            const float4 g4 = *reinterpret_cast<const float4*>(Gc + row * kCS + 4 * ty);
            const float uk[4] = {u4.x, u4.y, u4.z, u4.w}, gm[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int m = 0; m < 4; ++m) dvw[c][k][m] = fmaf(uk[k], gm[m], dvw[c][k][m]);
          }
        }
      }
    }
    if (need_ds) {
      if (!const_gate) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dd = St[(4 * ty + r) * 4 + 2];
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] += used[r][c] * (dp[r][c] - dd);
        }
      }
      // ds row-major with the thread's 4 keys as one float4: key j_local
      // sits at 4 * (j_local % 16) + j_local / 16
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(DS + (4 * ty + r) * kPS + 4 * tx) =
            make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
      __syncthreads();
      const int nr = min(kTile, Tq - i0);
      // dk[keys kg + 16c, dims 4kd..] += ds[rows, keys]^T q[rows, dims] over
      // the thread's share of the rows: two float4 loads for 16 FMAs
      if (dk_thread) {
        const int r1 = min(ks * SPAN + SPAN, nr);
        for (int row = ks * SPAN; row < r1; ++row) {
          const float4 d4 = *reinterpret_cast<const float4*>(DS + row * kPS + 4 * kg);
          const float4 q4 = *reinterpret_cast<const float4*>(Qb + row * QS + 4 * kd);
          const float dc[4] = {d4.x, d4.y, d4.z, d4.w}, qm[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int m = 0; m < 4; ++m) dka[c][m] = fmaf(dc[c], qm[m], dka[c][m]);
        }
      }
      // dpe: band row w gathers the diagonal key - row = w - 63 of the
      // tile, times pq of each row; two threads a w, each half the rows
      const int w = tid >> 1, half = tid & 1;
      float a[kPD] = {0.f, 0.f, 0.f, 0.f};
      if (w < 2 * kTile - 1) {
        const int lo = max(0, kTile - 1 - w), hi = min(nr, 2 * kTile - 1 - w);
        const int mid = (lo + hi + 1) / 2;
        for (int row = half ? mid : lo; row < (half ? hi : mid); ++row) {
          const int key = row + w - (kTile - 1);
          const float d = DS[row * kPS + 4 * (key % 16) + key / 16];
          const float4 pv = *reinterpret_cast<const float4*>(PQb + row * kPD);
          a[0] = fmaf(d, pv.x, a[0]);
          a[1] = fmaf(d, pv.y, a[1]);
          a[2] = fmaf(d, pv.z, a[2]);
          a[3] = fmaf(d, pv.w, a[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < kPD; ++e) a[e] += __shfl_xor_sync(0xffffffffu, a[e], 1);
      const int n = j0 - i0 + Tq - kTile + w;
      if (w < 2 * kTile - 1 && n >= 0 && n < Tq + Tk - 1) {
#pragma unroll
        for (int e = 2 * half; e < 2 * half + 2; ++e)
          if (a[e] != 0.f) atomicAdd(&dpe[((size_t)n * H + h) * kPD + e], a[e]);
      }
    }
  }
  __syncthreads();

  // dk: the row shares meet in shared memory, added in a fixed order
  {
    float* red = DS;  // [share][64 keys][QD]
    if (dk_thread)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          red[(ks * kTile + kg + 16 * c) * QD + 4 * kd + m] = dka[c][m];
    __syncthreads();
    for (int idx = tid; idx < kTile * QD; idx += kThreads) {
      const int j = j0 + idx / QD;
      float x = 0.f;
#pragma unroll
      for (int sh = 0; sh < NS; ++sh) x += red[sh * kTile * QD + idx];
      if (j < Tk) dk[((size_t)(b * Tk + j) * H + h) * QD + idx % QD] = x;
    }
    __syncthreads();  // red is reused below
  }
  if (kWide) {
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = j0 + tx + 16 * k, d = c * kCW + 4 * ty + m;
          if (c < nvc && j < Tk && d < VD) dv[((size_t)(b * Tk + j) * H + h) * VD + d] = dvw[c][k][m];
        }
  } else {
    // the 16 row quads of a key meet: lanes ty, ty^1 by a shuffle, then the
    // 8 warps one after another in shared memory
    const int warp = tid >> 5, lane = tid & 31;
    float* red = DS;  // [64 keys][kNW]
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int d = 0; d < kNW; ++d) dvn[c][d] += __shfl_xor_sync(0xffffffffu, dvn[c][d], 16);
    for (int wv = 0; wv < kThreads / 32; ++wv) {
      if (warp == wv && lane < 16) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int d = 0; d < kNW; ++d) {
            float* o = red + (lane + 16 * c) * kNW + d;
            *o = (wv == 0 ? 0.f : *o) + dvn[c][d];
          }
      }
      __syncthreads();
    }
    for (int idx = tid; idx < kTile * VD; idx += kThreads) {
      const int key = idx / VD, d = idx % VD, j = j0 + key;
      if (j < Tk) dv[((size_t)(b * Tk + j) * H + h) * VD + d] = red[key * kNW + d];
    }
  }
}

template <int QD, typename Tin, bool kWide, bool kSquare>
int launch_typed(const void* q, const void* kt, const void* pq, const void* pe,
                 const void* mask, const void* v, const void* g, float* stats, float* dq,
                 float* dk, float* dpq, float* dpe, float* dv, int B, int Tq, int Tk, int H,
                 int VD, int const_gate, int valid_cols, float pen, float limit,
                 cudaStream_t stream) {
  const int nvc = kWide ? (VD + kCW - 1) / kCW : 1;
  if (nvc > kMaxChunks) return (int)cudaErrorInvalidValue;
  const int RS = kWide ? odd4(nvc * kCW) : kNS;
  const size_t smem_rows = RowsLayout(QD, kWide, RS).total * sizeof(float);
  const size_t smem_cols = ColsLayout(QD, kWide, RS).total * sizeof(float);
  const int max_smem = max_optin_smem();
  if (smem_rows > (size_t)max_smem || smem_cols > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  auto kern_rows = bwd_rows_kernel<QD, Tin, kWide, kSquare>;
  auto kern_cols = bwd_cols_kernel<QD, Tin, kWide, kSquare>;
  cudaError_t e = allow_smem(kern_rows, smem_rows);
  if (e == cudaSuccess) e = allow_smem(kern_cols, smem_cols);
  if (e != cudaSuccess) return (int)e;
  const Tin* qi = static_cast<const Tin*>(q);
  const Tin* kti = static_cast<const Tin*>(kt);
  const Tin* pqi = static_cast<const Tin*>(pq);
  const Tin* pei = static_cast<const Tin*>(pe);
  const Tin* vi = static_cast<const Tin*>(v);
  const Tin* gi = static_cast<const Tin*>(g);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  // pass 1 over the row tiles, pass 2 over the key tiles
  const dim3 grid_rows((Tq + kTile - 1) / kTile, B * H);
  const dim3 grid_cols((Tk + kTile - 1) / kTile, B * H);
  kern_rows<<<grid_rows, kThreads, smem_rows, stream>>>(qi, kti, pqi, pei, m, vi, gi, stats, dq,
                                                        dpq, Tq, Tk, H, VD, RS, nvc, const_gate,
                                                        valid_cols, pen, limit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kern_cols<<<grid_cols, kThreads, smem_cols, stream>>>(qi, kti, pqi, pei, m, vi, gi, stats, dk,
                                                        dpe, dv, Tq, Tk, H, VD, RS, nvc,
                                                        const_gate, valid_cols, pen, limit);
  return (int)cudaGetLastError();
}

// QD and the value route dispatched, for Tin inputs; zv_rel_apply_bwd's
// arguments after bf16.  Each route has a square instantiation (Tk = Tq
// at compile time) besides the rectangular one: with Tk a second run-time
// size both passes spill more (at 128 and 255 registers), and the wide
// route's bf16 pass 2 took 15 % longer on the square tile (B=8, T=1024,
// VD=384 on an H100), the narrow one 1-3 %.
template <typename Tin>
int launch_in(const void* q, const void* kt, const void* pq, const void* pe, const void* mask,
              const void* v, const void* g, void* stats, void* dq, void* dk, void* dpq,
              void* dpe, void* dv, int B, int Tq, int Tk, int H, int QD, int PD, int VD,
              int const_gate, int valid_cols, float pen, float limit, void* stream) {
  if (PD != kPD || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || VD <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *st = static_cast<float*>(stats), *fq = static_cast<float*>(dq),
        *fk = static_cast<float*>(dk), *fpq = static_cast<float*>(dpq),
        *fpe = static_cast<float*>(dpe), *fv = static_cast<float*>(dv);
#define ZV_TYPED(QDV, WIDE, SQUARE)                                                      \
  launch_typed<QDV, Tin, WIDE, SQUARE>(q, kt, pq, pe, mask, v, g, st, fq, fk, fpq, fpe, fv, B, \
                                       Tq, Tk, H, VD, const_gate, valid_cols, pen, limit, s)
#define ZV_LAUNCH(QDV)                                                                    \
  if (Tq == Tk) return VD > kNW ? ZV_TYPED(QDV, true, true) : ZV_TYPED(QDV, false, true); \
  return VD > kNW ? ZV_TYPED(QDV, true, false) : ZV_TYPED(QDV, false, false)
  switch (QD) {
    case 8: ZV_LAUNCH(8);
    case 16: ZV_LAUNCH(16);
    case 24: ZV_LAUNCH(24);
    case 32: ZV_LAUNCH(32);
    case 64: ZV_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZV_LAUNCH
#undef ZV_TYPED
}

}  // namespace

// B3 for bf16 inputs (rel_apply_bwd_bf16.cu, linked beside
// rel_apply_bwd.cu): zv_rel_apply_bwd's arguments after bf16.
int rel_apply_bwd_bf16(const void* q, const void* kt, const void* pq, const void* pe,
                       const void* mask, const void* v, const void* g, void* stats, void* dq,
                       void* dk, void* dpq, void* dpe, void* dv, int B, int Tq, int Tk, int H,
                       int QD, int PD, int VD, int const_gate, int valid_cols, float pen,
                       float limit, void* stream);
