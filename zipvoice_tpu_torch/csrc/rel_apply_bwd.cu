// Flash backward of the shared-probabilities attention consumer (B3).
//
// Replaces the TPU kernel zipvoice_tpu/ops/attention.py
// `_pallas_rel_apply_bwd` (body `_apply_bwd_kernel`), the backward of
// out = probs @ v where probs = softmax(s + bias) is recomputed from
// s[i,j] = q_i.k_j + pq_i.pe[j-i+T-1] instead of read back:
//
//   used = const_gate ? (p > 0) / count(p > 0) : p       (per row)
//   dv   = used^T g
//   ds   = const_gate ? 0 : p * (dP - D),  dP = g v^T, D_i = sum_j p_ij dP_ij
//   ds  += pen * sign(s) * (|s| > limit)                  (pre-mask s, keys j < valid_cols)
//   dq = ds k,  dk = ds^T q,  dpq_i = sum_j ds_ij pe[j-i+T-1],
//   dpe[n] = sum_{b, i} ds_{i, n+i-T+1} pq_i              (summed over batch)
//
// q, k (via kt = (B,H,QD,T)), pq, pe, v, g: f32 or all bf16; v, g: (B,T,H,VD)
// with VD = 12 (SelfAttention, H = 4) or the NonlinAttention head-0 width
// (VD = 3D/4 = 384 or 144 at H = 1).  Outputs are f32.
//
// The TPU kernel walks row tiles in order and carries dk, dv and dpe across
// them in VMEM.  On the card blocks run in no order, so the work is split
// into two passes (a second pass for dq and dpq, no atomics on them):
//
//   1. rows: a block owns `rows` query rows of one (b,h) and every key, as
//      B1/B4 do (rel_common.cuh): it recomputes the scores, takes the
//      softmax statistics, computes dP for its rows (a lane per key, four
//      value dims of the key in registers against float4s of the g rows in
//      shared memory) and D,
//      writes ds over the scores in shared memory, and reduces dq and dpq
//      over the keys.  It stores the per-row max, 1/sum, D and count(p > 0).
//   2. columns: a block owns 32 keys of one (b,h) (16 for wide values;
//      FlashAttention-2's backward layout) and walks every query row in
//      tiles of 16: it
//      recomputes s, p (with pass 1's statistics, the same summation order,
//      so the same values), dP and ds for the tile, and accumulates dv, dk
//      and the dpe band of its keys in shared memory.  dk and dv are written
//      once; the band (T+31 pe rows, or T+15) is added to the batch-summed
//      dpe with atomics.
//
// What bounds it on an H100: the arithmetic.  Each (i, j) pair costs the
// score (QD+4 FMAs) twice, dP (VD FMAs) twice and dv (VD FMAs) once; at
// VD = 384 that is ~1.2k FMAs per pair on the CUDA cores, far above the
// bytes (q, k, v, g in and five gradients out, each once).  Every value- and
// query-width product reads float4s from shared memory (rows padded to a
// multiple of 4, per-key strides with an odd float4 count so that no two
// lanes of a phase share a bank).  Tensor cores (wgmma) for dP and dv are
// for a later version.  The TPU kernel's lane-padding of v and g to 128 is
// not copied: VD is a runtime width.

#include "rel_common.cuh"

namespace {

using namespace zv;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;  // pass 1: query rows per block (fewer for long T)
constexpr int kKChunk = 64;   // pass 1: keys staged per dq step
constexpr int kMaxOut = 4;    // pass 1: dq outputs per thread (16 rows x QD 64)
constexpr int kRowTile = 16;  // pass 2: query rows per step

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// Value rows are held VD4 = round4(VD) wide (zero-filled) so that every
// value-width product reads float4s.  A per-key row stride whose float4
// count is odd keeps the 8 lanes of each float4 shared-memory phase on
// distinct banks.
__host__ __device__ inline int odd_quads(int w4) { return ((w4 / 4) % 2 == 0) ? w4 + 4 : w4; }

// Carve 16-byte aligned regions of `n` floats out of shared memory.
struct Carver {
  float* p;
  __device__ float* take(size_t n) {
    float* r = p;
    p += round4(n);
    return r;
  }
};

// pass 1 shared memory (floats): row tile | S[rows*T] | DP[rows*T] |
// g rows[rows*VD4] | max, inv, D, count [4*rows] | key chunk[QD*(kKChunk+1)]
size_t rows_smem_floats(int T, int rows, int QD, int VD) {
  return row_tile_floats(T, rows, QD) + 2 * round4((size_t)rows * T) +
         (size_t)rows * round4(VD) + round4(4 * (size_t)rows) +
         round4((size_t)QD * (kKChunk + 1));
}

template <int QD, typename Tin>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                const Tin* __restrict__ pq, const Tin* __restrict__ pe,
                const uint8_t* __restrict__ mask, const Tin* __restrict__ v,
                const Tin* __restrict__ g, float* __restrict__ stats,
                float* __restrict__ dq, float* __restrict__ dpq, int T, int H, int VD,
                int rows, int const_gate, int valid_cols, float pen, float limit) {
  extern __shared__ float4 smem4[];
  const int VD4 = (int)round4(VD);
  float* qs = reinterpret_cast<float*>(smem4);
  float* pqs = qs + rows * QD;
  float* band = pqs + rows * kPD;
  Carver cv{band + (size_t)(T + rows - 1) * kPD};
  float* S = cv.take((size_t)rows * T);
  float* DP = cv.take((size_t)rows * T);
  float* gs = cv.take((size_t)rows * VD4);
  float* rmx = cv.take(4 * (size_t)rows);
  float* rinv = rmx + rows;
  float* rD = rinv + rows;
  float* rcnt = rD + rows;
  float* kch = cv.take((size_t)QD * (kKChunk + 1));
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * rows;
  const int nrows = min(rows, T - i0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bht = (size_t)gridDim.y * T;
  const Tin* ktb = kt + (size_t)bh * QD * T;

  stage_row_tile<QD>(q, pq, pe, qs, pqs, band, b, h, T, H, i0, rows);
  staged_copy<4>(
      rows * VD4,
      [&](int idx) {
        const int r = idx / VD4, d = idx % VD4;
        return (r < nrows && d < VD)
                   ? to_f32(g[((size_t)(b * T + i0 + r) * H + h) * VD + d]) : 0.f;
      },
      [&](int idx, float x) { gs[idx] = x; });
  for (int r = threadIdx.x; r < rows; r += blockDim.x) rD[r] = rcnt[r] = 0.f;
  __syncthreads();
  row_tile_scores<QD, Tin, false>(ktb, mask, qs, pqs, band, S, b, T, rows, nrows);
  __syncthreads();

  // softmax statistics, and the const branch's support size: a warp per row
  for (int r = warp; r < nrows; r += kWarps) {
    const float* srow = S + (size_t)r * T;
    float mx, inv;
    row_softmax_stats(srow, mask, b, T, &mx, &inv);
    float cnt = 0.f;
    if (const_gate) {
      for (int j = lane; j < T; j += 32)
        cnt += (expf(srow[j] + mask_bias(mask, b, T, j) - mx) * inv > 0.f) ? 1.f : 0.f;
      cnt = warp_sum(cnt);
    }
    if (lane == 0) {
      rmx[r] = mx;
      rinv[r] = inv;
      rcnt[r] = cnt;
    }
  }
  __syncthreads();

  // dP = g v^T for the block's rows (a lane per key; four value dims of
  // the key in registers against a float4 of every row) and D_r = sum_j p dP
  if (!const_gate) {
    float dpart[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) dpart[r] = 0.f;
    const float4* g4 = reinterpret_cast<const float4*>(gs);
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
      const Tin* vj = v + ((size_t)(b * T + j) * H + h) * VD;
      float acc[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
      for (int d0 = 0; d0 < VD4; d0 += 4) {
        float vr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vr[u] = d0 + u < VD ? to_f32(vj[d0 + u]) : 0.f;
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nrows) {
            const float4 gv = g4[(r * VD4 + d0) / 4];
            acc[r] = fmaf(gv.x, vr[0], acc[r]);
            acc[r] = fmaf(gv.y, vr[1], acc[r]);
            acc[r] = fmaf(gv.z, vr[2], acc[r]);
            acc[r] = fmaf(gv.w, vr[3], acc[r]);
          }
        }
      }
      const float bias = mask_bias(mask, b, T, j);
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nrows) {
          DP[(size_t)r * T + j] = acc[r];
          dpart[r] += expf(S[(size_t)r * T + j] + bias - rmx[r]) * rinv[r] * acc[r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < nrows) {
        const float x = warp_sum(dpart[r]);
        if (lane == 0) atomicAdd(&rD[r], x);
      }
    }
    __syncthreads();
  }

  // ds over the scores; the row statistics go out for pass 2
  for (int idx = threadIdx.x; idx < nrows * T; idx += blockDim.x) {
    const int r = idx / T, j = idx - r * T;
    const float s = S[idx];
    float d = 0.f;
    if (!const_gate) {
      const float p = expf(s + mask_bias(mask, b, T, j) - rmx[r]) * rinv[r];
      d = p * (DP[idx] - rD[r]);
    }
    S[idx] = j < valid_cols ? d + penalty_term(s, pen, limit) : d;
  }
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const size_t o = (size_t)bh * T + i0 + r;
    stats[o] = rmx[r];
    stats[bht + o] = rinv[r];
    stats[2 * bht + o] = rD[r];
    stats[3 * bht + o] = rcnt[r];
  }
  __syncthreads();

  // dq[r, d] = sum_j ds[r, j] k[j, d], keys staged kKChunk at a time (row
  // stride kKChunk+1 keeps lanes on neighbouring d in distinct banks)
  float acc[kMaxOut];
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) acc[u] = 0.f;
  const int nout = nrows * QD;
  for (int j0 = 0; j0 < T; j0 += kKChunk) {
    const int n = min(kKChunk, T - j0);
    staged_copy<4>(
        QD * kKChunk,
        [&](int idx) {
          const int d = idx / kKChunk, jj = idx % kKChunk;
          return jj < n ? to_f32(ktb[(size_t)d * T + j0 + jj]) : 0.f;
        },
        [&](int idx, float x) { kch[(idx / kKChunk) * (kKChunk + 1) + idx % kKChunk] = x; });
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMaxOut; ++u) {
      const int o = threadIdx.x + u * kThreads;
      if (o < nout) {
        const float* dsr = S + (size_t)(o / QD) * T + j0;
        const float* kd = kch + (o % QD) * (kKChunk + 1);
        float a = acc[u];
        for (int jj = 0; jj < n; ++jj) a = fmaf(dsr[jj], kd[jj], a);
        acc[u] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) {
    const int o = threadIdx.x + u * kThreads;
    if (o < nout)
      dq[((size_t)(b * T + i0 + o / QD) * H + h) * QD + o % QD] = acc[u];
  }

  // dpq[r, e] = sum_j ds[r, j] pe[j - r + T - 1, e]: rows*4 outputs, the keys
  // split over blockDim / (rows*4) slices and summed in shared memory
  const int nout2 = rows * kPD, slices = blockDim.x / nout2;
  float* red = kch;
  for (int o = threadIdx.x; o < nout2; o += blockDim.x) red[o] = 0.f;
  __syncthreads();
  {
    const int o = threadIdx.x % nout2, sl = threadIdx.x / nout2;
    const int r = o / kPD, e = o % kPD;
    if (sl < slices && r < nrows) {
      const float* dsr = S + (size_t)r * T;
      float a = 0.f;
      for (int j = sl; j < T; j += slices) a = fmaf(dsr[j], band[(j - r + rows - 1) * kPD + e], a);
      atomicAdd(&red[o], a);
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nrows * kPD; o += blockDim.x)
    dpq[((size_t)(b * T + i0 + o / kPD) * H + h) * kPD + o % kPD] = red[o];
}

// pass 2: keys per block; fewer for wide values, so that two blocks fit
// an SM's shared memory
inline int cols_per_block(int VD) { return round4(VD) > 64 ? 16 : 32; }

// pass 2 shared memory (floats); KS / VS: the per-key row strides of k and v
size_t cols_smem_floats(int T, int QD, int VD, int C) {
  const size_t VD4 = round4(VD);
  const size_t KS = odd_quads(QD), VS = odd_quads((int)VD4);
  return C * KS + C * VS + C + kRowTile * QD + kRowTile * kPD +
         kRowTile * VD4 + 4 * kRowTile + round4((C + kRowTile - 1) * kPD) +
         2 * kRowTile * C + C * VD4 + C * QD + round4((size_t)(T + C - 1) * kPD);
}

template <int QD, typename Tin>
__global__ void __launch_bounds__(kThreads)
bwd_cols_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                const Tin* __restrict__ pq, const Tin* __restrict__ pe,
                const uint8_t* __restrict__ mask, const Tin* __restrict__ v,
                const Tin* __restrict__ g, const float* __restrict__ stats,
                float* __restrict__ dk, float* __restrict__ dpe, float* __restrict__ dv,
                int T, int H, int VD, int C, int const_gate, int valid_cols, float pen,
                float limit) {
  extern __shared__ float4 smem4[];
  constexpr int KS = QD / 4 % 2 == 0 ? QD + 4 : QD;
  const int VD4 = (int)round4(VD);
  const int VS = odd_quads(VD4);
  Carver cv{reinterpret_cast<float*>(smem4)};
  float* kc = cv.take(C * KS);                          // [C][KS]
  float* vc = cv.take((size_t)C * VS);                  // [C][VS]
  float* biasc = cv.take(C);                            // [C]
  float* qr = cv.take(kRowTile * QD);                       // [kRowTile][QD]
  float* pqr = cv.take(kRowTile * kPD);                     // [kRowTile][4]
  float* gr = cv.take((size_t)kRowTile * VD4);              // [kRowTile][VD4]
  float* rst = cv.take(4 * kRowTile);                       // [4][kRowTile]
  float* bandr = cv.take((C + kRowTile - 1) * kPD);     // [C+kRowTile-1][4]
  float* P = cv.take(kRowTile * C);                     // used probs [kRowTile][C]
  float* DS = cv.take(kRowTile * C);                    // [kRowTile][C]
  float* dv_acc = cv.take((size_t)C * VD4);             // [C][VD4]
  float* dk_acc = cv.take(C * QD);                      // [C][QD]
  float* dpe_acc = cv.take((size_t)(T + C - 1) * kPD);  // pe rows j0 .. j0+T+C-2
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int j0 = blockIdx.x * C;
  const int ncols = min(C, T - j0);
  const size_t bht = (size_t)gridDim.y * T;
  const Tin* ktb = kt + (size_t)bh * QD * T;
  const int tid = threadIdx.x;
  const int VQ = VD4 / 4;

  staged_copy<4>(
      C * QD,
      [&](int idx) {
        const int d = idx / C, c = idx % C;
        return c < ncols ? to_f32(ktb[(size_t)d * T + j0 + c]) : 0.f;
      },
      [&](int idx, float x) { kc[(idx % C) * KS + idx / C] = x; });
  staged_copy<4>(
      C * VD4,
      [&](int idx) {
        const int c = idx / VD4, d = idx % VD4;
        return (c < ncols && d < VD)
                   ? to_f32(v[((size_t)(b * T + j0 + c) * H + h) * VD + d]) : 0.f;
      },
      [&](int idx, float x) { vc[(idx / VD4) * VS + idx % VD4] = x; });
  for (int c = tid; c < C; c += blockDim.x)
    biasc[c] = c < ncols ? mask_bias(mask, b, T, j0 + c) : 0.f;
  for (int o = tid; o < C * VD4; o += blockDim.x) dv_acc[o] = 0.f;
  for (int o = tid; o < C * QD; o += blockDim.x) dk_acc[o] = 0.f;
  for (int o = tid; o < (T + C - 1) * kPD; o += blockDim.x) dpe_acc[o] = 0.f;

  for (int i0 = 0; i0 < T; i0 += kRowTile) {
    const int nr = min(kRowTile, T - i0);
    __syncthreads();  // the previous tile is consumed
    staged_copy<4>(
        kRowTile * QD,
        [&](int idx) {
          const int r = idx / QD, d = idx % QD;
          return r < nr ? to_f32(q[((size_t)(b * T + i0 + r) * H + h) * QD + d]) : 0.f;
        },
        [&](int idx, float x) { qr[idx] = x; });
    staged_copy<1>(
        kRowTile * kPD,
        [&](int idx) {
          const int r = idx / kPD, e = idx % kPD;
          return r < nr ? to_f32(pq[((size_t)(b * T + i0 + r) * H + h) * kPD + e]) : 0.f;
        },
        [&](int idx, float x) { pqr[idx] = x; });
    staged_copy<4>(
        kRowTile * VD4,
        [&](int idx) {
          const int r = idx / VD4, d = idx % VD4;
          return (r < nr && d < VD)
                     ? to_f32(g[((size_t)(b * T + i0 + r) * H + h) * VD + d]) : 0.f;
        },
        [&](int idx, float x) { gr[idx] = x; });
    for (int idx = tid; idx < 4 * kRowTile; idx += blockDim.x) {
      const int k4 = idx / kRowTile, r = idx % kRowTile;
      rst[idx] = r < nr ? stats[k4 * bht + (size_t)bh * T + i0 + r] : 0.f;
    }
    // band index w holds pe row nbase + w = j - i + T - 1 for c - r = w - (kRowTile-1)
    const int nbase = j0 - i0 - kRowTile + T;
    staged_copy<1>(
        (C + kRowTile - 1) * kPD,
        [&](int idx) {
          const int n = nbase + idx / kPD, e = idx % kPD;
          return (n >= 0 && n < 2 * T - 1) ? to_f32(pe[((size_t)n * H + h) * kPD + e]) : 0.f;
        },
        [&](int idx, float x) { bandr[idx] = x; });
    __syncthreads();

    // the tile's used probabilities and ds (same score summation order as
    // row_tile_scores, so p equals pass 1's)
    for (int e = tid; e < kRowTile * C; e += blockDim.x) {
      const int r = e / C, c = e % C;
      float used = 0.f, d = 0.f;
      if (r < nr && c < ncols) {
        const float4* qv = reinterpret_cast<const float4*>(qr + r * QD);
        const float4* kv = reinterpret_cast<const float4*>(kc + c * KS);
        float s = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < QD / 4; ++d4) {
          const float4 a = qv[d4], k4 = kv[d4];
          s = fmaf(a.x, k4.x, s);
          s = fmaf(a.y, k4.y, s);
          s = fmaf(a.z, k4.z, s);
          s = fmaf(a.w, k4.w, s);
        }
        const float4 pv = reinterpret_cast<const float4*>(pqr)[r];
        const float4 ev = reinterpret_cast<const float4*>(bandr)[c - r + kRowTile - 1];
        s = fmaf(pv.x, ev.x, s);
        s = fmaf(pv.y, ev.y, s);
        s = fmaf(pv.z, ev.z, s);
        s = fmaf(pv.w, ev.w, s);
        const float p = expf(s + biasc[c] - rst[r]) * rst[kRowTile + r];
        if (const_gate) {
          used = p > 0.f ? 1.f / fmaxf(rst[3 * kRowTile + r], 1e-20f) : 0.f;
        } else {
          const float4* gv = reinterpret_cast<const float4*>(gr + r * VD4);
          const float4* vv = reinterpret_cast<const float4*>(vc + c * VS);
          // four independent partial sums: a quarter of the dependent chain
          float4 dp = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int d4 = 0; d4 < VQ; ++d4) {
            const float4 a = gv[d4], w = vv[d4];
            dp.x = fmaf(a.x, w.x, dp.x);
            dp.y = fmaf(a.y, w.y, dp.y);
            dp.z = fmaf(a.z, w.z, dp.z);
            dp.w = fmaf(a.w, w.w, dp.w);
          }
          used = p;
          d = p * ((dp.x + dp.y) + (dp.z + dp.w) - rst[2 * kRowTile + r]);
        }
        if (j0 + c < valid_cols) d += penalty_term(s, pen, limit);
      }
      P[e] = used;
      DS[e] = d;
    }
    __syncthreads();

    // dv[c, :] += sum_r used[r, c] g[r, :];  dk[c, :] += sum_r ds[r, c] q[r, :]
    // (a float4 of four value / query dims per output)
    float4* dv4 = reinterpret_cast<float4*>(dv_acc);
    const float4* g4 = reinterpret_cast<const float4*>(gr);
    for (int o = tid; o < C * VQ; o += blockDim.x) {
      const int c = o / VQ, d4 = o % VQ;
      float4 a = dv4[o];
      for (int r = 0; r < nr; ++r) {
        const float w = P[r * C + c];
        const float4 x = g4[r * VQ + d4];
        a.x = fmaf(w, x.x, a.x);
        a.y = fmaf(w, x.y, a.y);
        a.z = fmaf(w, x.z, a.z);
        a.w = fmaf(w, x.w, a.w);
      }
      dv4[o] = a;
    }
    float4* dk4 = reinterpret_cast<float4*>(dk_acc);
    const float4* q4 = reinterpret_cast<const float4*>(qr);
    for (int o = tid; o < C * QD / 4; o += blockDim.x) {
      const int c = o / (QD / 4), d4 = o % (QD / 4);
      float4 a = dk4[o];
      for (int r = 0; r < nr; ++r) {
        const float w = DS[r * C + c];
        const float4 x = q4[r * (QD / 4) + d4];
        a.x = fmaf(w, x.x, a.x);
        a.y = fmaf(w, x.y, a.y);
        a.z = fmaf(w, x.z, a.z);
        a.w = fmaf(w, x.w, a.w);
      }
      dk4[o] = a;
    }
    // dpe: each band index w gathers its diagonal c - r = w - (kRowTile-1)
    for (int o = tid; o < (C + kRowTile - 1) * kPD; o += blockDim.x) {
      const int w = o / kPD, e = o % kPD;
      float a = 0.f;
      for (int r = 0; r < nr; ++r) {
        const int c = w + r - (kRowTile - 1);
        if (c >= 0 && c < C) a = fmaf(DS[r * C + c], pqr[r * kPD + e], a);
      }
      const int slot = nbase + w - j0;
      if (slot >= 0 && slot < T + C - 1) dpe_acc[slot * kPD + e] += a;
    }
  }
  __syncthreads();

  for (int o = tid; o < ncols * VD; o += blockDim.x)
    dv[((size_t)(b * T + j0 + o / VD) * H + h) * VD + o % VD] = dv_acc[(o / VD) * VD4 + o % VD];
  for (int o = tid; o < ncols * QD; o += blockDim.x)
    dk[((size_t)(b * T + j0 + o / QD) * H + h) * QD + o % QD] = dk_acc[o];
  for (int o = tid; o < (T + C - 1) * kPD; o += blockDim.x) {
    const int n = j0 + o / kPD;
    const float a = dpe_acc[o];
    if (n < 2 * T - 1 && a != 0.f) atomicAdd(&dpe[((size_t)n * H + h) * kPD + o % kPD], a);
  }
}

template <int QD, typename Tin>
int launch_typed(const void* q, const void* kt, const void* pq, const void* pe,
                 const void* mask, const void* v, const void* g, float* stats, float* dq,
                 float* dk, float* dpq, float* dpe, float* dv, int B, int T, int H, int VD,
                 int const_gate, int valid_cols, float pen, float limit, cudaStream_t stream) {
  const int max_smem = max_optin_smem();
  const int rows =
      fit_rows(kMaxRows, max_smem, [&](int r) { return rows_smem_floats(T, r, QD, VD); });
  const size_t smem_rows = rows_smem_floats(T, rows, QD, VD) * sizeof(float);
  const int cols = cols_per_block(VD);
  const size_t smem_cols = cols_smem_floats(T, QD, VD, cols) * sizeof(float);
  if (smem_rows > (size_t)max_smem || smem_cols > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  auto kern_rows = bwd_rows_kernel<QD, Tin>;
  auto kern_cols = bwd_cols_kernel<QD, Tin>;
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
  kern_rows<<<dim3((T + rows - 1) / rows, B * H), kThreads, smem_rows, stream>>>(
      qi, kti, pqi, pei, m, vi, gi, stats, dq, dpq, T, H, VD, rows, const_gate, valid_cols, pen,
      limit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kern_cols<<<dim3((T + cols - 1) / cols, B * H), kThreads, smem_cols, stream>>>(
      qi, kti, pqi, pei, m, vi, gi, stats, dk, dpe, dv, T, H, VD, cols, const_gate, valid_cols,
      pen, limit);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (QD not instantiated, PD != 4, T or VD too large for shared memory).
// dpe must be zeroed by the caller (the batch sum is accumulated in it).  The
// penalty acts on key columns j < valid_cols only.
extern "C" int zv_rel_apply_bwd(const void* q, const void* kt, const void* pq,
                                const void* pe, const void* mask, const void* v,
                                const void* g, void* stats, void* dq, void* dk, void* dpq,
                                void* dpe, void* dv, int B, int T, int H, int QD, int PD,
                                int VD, int bf16, int const_gate, int valid_cols, float pen,
                                float limit, void* stream) {
  if (PD != kPD || B <= 0 || T <= 0 || H <= 0 || VD <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *st = static_cast<float*>(stats), *fq = static_cast<float*>(dq),
        *fk = static_cast<float*>(dk), *fpq = static_cast<float*>(dpq),
        *fpe = static_cast<float*>(dpe), *fv = static_cast<float*>(dv);
#define ZV_LAUNCH(QDV)                                                                     \
  return bf16 ? launch_typed<QDV, __nv_bfloat16>(q, kt, pq, pe, mask, v, g, st, fq, fk, fpq, \
                                                 fpe, fv, B, T, H, VD, const_gate,          \
                                                 valid_cols, pen, limit, s)                 \
              : launch_typed<QDV, float>(q, kt, pq, pe, mask, v, g, st, fq, fk, fpq, fpe,   \
                                         fv, B, T, H, VD, const_gate, valid_cols, pen, limit, s)
  switch (QD) {
    case 8: ZV_LAUNCH(8);
    case 16: ZV_LAUNCH(16);
    case 24: ZV_LAUNCH(24);
    case 32: ZV_LAUNCH(32);
    case 64: ZV_LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZV_LAUNCH
}
