// Relative-position attention probabilities for the Zipformer (B1), the
// same probabilities with a fused probs @ V epilogue (B6), their score
// cotangent (B4) and softmax @ V with the const gate at a narrow V (B5): the
// kernel body the four share (one epilogue mode each), their kernels and
// launch code.  rel_probs.cu builds B1's entry point, rel_probs_consume.cu
// B6's, rel_ds.cu B4's, rel_apply.cu B5's, as libraries that nvcc compiles
// side by side.
//
// B1 replaces the TPU kernel zipvoice_tpu/ops/attention.py `_pallas_rel_probs`
// (body `_kernel` with `_tile_scores` / `_tile_softmax`):
//
//   probs[b,h,i,j] = softmax_j( q_i . k_j + pq_i . pe[j - i + Tq - 1] + bias_j )
//
// with bias_j = -1000 where key j is padded (else 0), scores and softmax in
// f32, probs written in f32 or bf16.  q: (B,Tq,H,QD); kt: k transposed to
// (B,H,QD,T) by the caller; pq: (B,Tq,H,PD); pe: (Tq+T-1,H,PD); mask: (B,T)
// uint8 or null; out: (B,H,Tq,T).  T counts the keys and Tq the query rows:
// the square case Tq = T is the model's; a rectangular tile (Tq < T) is a
// block of query rows against every key, its pe the window of the square
// pe that those rows touch (the sequence-parallel sampler's), so the kernel
// needs no row offset.  B4 and B6 take the same tiles (the sequence-parallel
// training step's, and the fused sequence-parallel sampler's).  B5 runs at
// Tq = T.
//
// B6 replaces `rel_attention_probs_consume` (body `_probs_consume_kernel`):
// it writes the same probabilities and contracts them, as rounded to the
// probs dtype, with v (B,T,H,VD) (T keys): out = round(p) @ v with f32
// sums, out (B,Tq,H,VD) in v's dtype.  It is B1's kernel body with an epilogue
// (`rel_probs_consume_kernel`), so its probabilities are B1's by
// construction; see "B6's epilogue" below.
//
// B5 at VD <= 64 replaces `_pallas_rel_apply` (body `_apply_kernel`,
// probabilities `_apply_probs`): used = const_gate ? (p > 0) / count(p >
// 0) : p, rounded to v's dtype, @ v with f32 sums, out (B,T,H,VD) in
// out_dtype; see "B5's epilogue" below (its wide route, VD > 64, is
// rel_wide_consume.cuh).
//
// The arithmetic is that of the shared row tile (rel_common.cuh), which B3-B5
// and B7 recompute, so B3's const gate recomputes B1's support p > 0 and B7's
// probabilities are B1's: each score is one fmaf chain over q.k
// in d order, then the four pe terms, then + bias; the row max over s +
// bias; e = expf(s - max) summed in 32 classes j mod 32, each in key order,
// then warp_sum's xor tree; p = e * (1 / sum), rounded once.  Only who
// computes which score, when, and how it is stored differ from rel_common.
//
// What bounds it on an H100: the 36 f32 score FMAs an element on the CUDA
// cores (9.0 us at B=2, H=4, T=1024 at 67 TFLOP/s) and the (B,H,T,T) output
// write (32 MB in f32: 10.7 us at 3.35 TB/s), with expf and the softmax's
// shared-memory passes on top of the FMAs' issue slots.  The design:
//   * one 256-thread block an SM (255 registers a thread); the rows of each
//     (b,h) are split evenly over SMs / (B*H) blocks, in tiles of 16 rows
//     (8 or 4 for short T, 1 for the longest); q, pq and the pe band of all
//     the block's rows are staged once;
//   * a thread owns 4 consecutive keys (2 at QD = 64): their k columns sit
//     in registers (16-byte loads of the transposed kt), kept for all the
//     block's tiles when every key group has its own thread (T <= 1024 at
//     QD <= 32); short T splits each tile's rows over the idle threads.
//     Each q / pq broadcast feeds 4 keys' FMAs (16 FMAs a shared-memory
//     load, against 4 in rel_common), and the pe window slides one band
//     row a query row (one new load, not four).  The band of a tile of
//     several rows has one pad every 8 rows, so the lanes' stride-4 window
//     loads do not conflict; the 1-row tile (the longest T) has none, so it
//     takes any T the row tile of rel_common takes;
//   * the row max is taken while the scores are made (a running max a row
//     in registers, one partial a thread in shared memory); the scores go
//     to shared memory as one 16-byte store a thread and row;
//   * one warp a row: one pass sums e (lane = j mod 32, stride-32 reads,
//     16 exps in flight) and leaves it in place, one pass writes 16 bytes a
//     lane (4 f32 or 8 bf16), the ragged head and tail of rows that do not
//     start 16-byte aligned one element a lane.
// What still holds it back (PERF.md): 8 warps an SM hide too little of the
// shared-memory and exp latency, so neither the score FMAs nor the softmax
// passes issue at their full rate; the k columns of one (b,h) are read from
// L2 once a block.
// Any T: keys past T are masked in the kernel, nothing is padded.
//
// B6's epilogue.  The contraction P (R x T) @ v (T x VD) is 2*T*VD
// operations a row against 2*T*36 for the scores, so it runs on the tensor
// cores (tensor_core.cuh), after each tile's softmax:
//   * the pass that writes a row also leaves round(p) (as f32) in place of
//     its scores, and zeroes the keys T .. up to a multiple of 16; the row
//     stride is 16 mod 32 floats, so that the A fragments load as 16-byte
//     loads without bank conflicts;
//   * v of the block's (b,h) is staged once a block by `cp.async`, issued
//     before the row staging so that it lands while the rows and keys load:
//     f32 v transposed (a column's keys contiguous), bf16 v as it lies in
//     rows padded for `ldmatrix.trans`; where all of it does not fit beside
//     the row tile (long T, wide VD), every tile streams it in chunks;
//   * the 8 warps split the keys (16-key steps, interleaved; in bf16 each
//     step's fragments load while the last one's products run); each keeps
//     a 16 x 16 block of sums (two n8 tiles; wider VD loops over 16-column
//     chunks) in registers; probs and v both bf16: `mma.sync.m16n8k16`
//     (exact products, only the order of the f32 sum differs from the plain
//     version); otherwise 3xTF32 on `m16n8k8`, which keeps the f32
//     tolerance; a tile of fewer than 16 rows repeats its last row in the
//     fragment's unused rows (rows 8-15 are zero for tiles of at most 8);
//   * the warps' partial sums meet in shared memory, added in warp order
//     (no atomics: two launches give the same bits), and the R x VD outputs
//     are written in v's dtype.
// What bounds B6 beyond B1 (PERF.md): the contraction runs after each
// tile's softmax, beside nothing; in f32 the rate of its 12 TF32
// `mma.sync` a 16-key step and warp bounds it, in bf16 the latency of the
// steps.  Overlapping it with the next tile's scores (a second score
// buffer, the warps split between the two) measured slower.
//
// B5's epilogue (`rel_apply_kernel`) is B6's without the probabilities'
// store: what bounds B6 beyond B1 bounds it.
//   * the write pass writes nothing to device memory: it leaves round(p),
//     rounded to v's dtype, in the score rows (p = e * inv as B6's pass
//     takes it, so with the gate closed and out in v's dtype the output is
//     B6's bit for bit), and zero for the keys T .. up to a multiple of 16;
//   * with the const gate, one more pass of the row's warp counts the
//     support p > 0 (B1's p, whose support B3 recomputes) and leaves
//     round(1 / max(count, 1e-20)) on it;
//   * the contraction is B6's, on the probabilities' v-dtype rounding (bf16
//     inputs: `mma.sync.m16n8k16` whatever the output type), and the
//     outputs go out in out_dtype.
//
// B4's epilogue.  B4 replaces `_pallas_rel_ds` (body `_bwd_kernel`), B1's
// backward with the probabilities recomputed:
//
//   ds[i,j] = p[i,j] * (g[i,j] - sum_j' g[i,j'] p[i,j'])
//             + pen * sign(s[i,j]) * (|s[i,j]| > limit)
//
// with s the pre-mask score (padded keys get the penalty too); g and ds
// (B,H,T,T) in the input type.  What bounds it on an H100: B1's score FMAs
// and the two (B,H,T,T) streams, g read and ds written (at B=8, H=4, T=1024
// in f32: 268 MB, 80 us at 3.35 TB/s).  On B1's body:
//   * the score rows hold the pre-mask s; the running row max is still
//     over s + bias, and the row passes add the bias (staged once a block)
//     with the same floating-point add, so p keeps B1's bits;
//   * the tile's R rows of g go to shared memory by 16-byte `cp.async`,
//     issued before the tile's scores (the first tile's before the rows
//     are staged), so that the g stream lands while the FMAs run; each row
//     keeps its offset from a 16-byte boundary, so the copies and the write
//     pass's vectors are aligned;
//   * one warp a row: B1's sum pass (the same e, order and 1 / sum) also
//     takes sum(g * e), so dot = inv * sum(g * e) and one expf an element;
//     the write pass writes ds = e * inv * (g - dot) 16 bytes a lane.  With
//     pen != 0 (no model path) the scores stay for the penalty and the
//     write pass takes expf again, the same bits;
//   * where R rows of g do not fit beside the scores even at one row a
//     tile (the longest T), the row passes read g and the mask from device
//     memory instead, so B4 takes every T that B1 does.

#pragma once

#include <algorithm>
#include <type_traits>

#include "rel_common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace zv;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Band padding of an R-row tile: one pad float4 every 8 band rows (shift 3),
// none for R = 1 (idx >> 30 == 0), which loads its window once a key group.
template <int R>
struct BandPad {
  static constexpr int shift = R == 1 ? 30 : 3;
  static constexpr int extra = R == 1 ? 0 : 1;
};

template <int QD>
struct KeysPerThread {
  static constexpr int value = QD <= 32 ? 4 : 2;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Score row stride: 16-byte aligned rows, except the 1-row tile (one row).
__host__ __device__ inline int score_stride(int T, int R) { return R == 1 ? T : round4(T); }

// Band rows of RB block rows against T keys: pe rows j - i + Tq - 1 for the
// block's rows.
__host__ __device__ inline int band_rows(int T, int RB) { return T + RB - 1; }
template <int R>
__host__ __device__ inline int band_slots(int NB) {
  return NB + (NB >> BandPad<R>::shift) + BandPad<R>::extra;
}

// B6: the keys of its 16-key contraction steps (zero past T), and the row
// stride (>= n, n a multiple of 16) of its score rows and of its transposed
// f32 v: 16 mod 32 floats, so that the lanes' 16-byte fragment loads do not
// conflict
__host__ __device__ inline int keys16(int T) { return (T + 15) & ~15; }
__host__ __device__ inline int stride16(int n) { return (n & ~31) + 16; }

// shared memory (floats): q[RB*QD] | pq[RB*4] | band | row-max partials
// [R*threads] (none for R = 1) | scores[R*stride]; B6 adds its v buffer and
// the warps' partial sums after them
template <int R>
__host__ __device__ inline size_t smem_floats(int T, int RB, int QD, int stride) {
  return (size_t)RB * QD + (size_t)RB * kPD + (size_t)band_slots<R>(band_rows(T, RB)) * kPD +
         (R == 1 ? 0 : (size_t)R * kThreads) + (size_t)R * stride;
}

// B6's v buffer of `keys` keys and `cols` columns (cols = VD when all of v
// is staged, 16 for a streamed chunk): f32 v transposed, cols rows of
// stride16(keys) floats; bf16 v as it lies, keys rows of vrow_stride(cols)
// halfwords.  Its row stride and its size in floats (16-byte aligned).
__host__ __device__ inline int vrow_stride(int cols) { return (cols + 15) / 16 * 16 + 8; }
__host__ __device__ inline int v_stride(int cols, int keys, int elem) {
  return elem == 4 ? stride16(keys) : vrow_stride(cols);
}
__host__ __device__ inline size_t v_floats(int cols, int keys, int elem) {
  const size_t n = elem == 4 ? (size_t)cols * stride16(keys) : (size_t)keys * vrow_stride(cols);
  return (n * elem + 15) / 16 * 4;
}
// and of the warps' partial sums, one 16 x 16 block a warp
constexpr int kRedFloats = kWarps * 256;
// B6: keys of a streamed chunk of v, where all of it does not fit
constexpr int kChunkKeys = 256;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename Tin>
__device__ __forceinline__ float4 load4_or_zero(const Tin* p, bool ok) {
  return ok ? load4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// count float4s into shared memory, kBatch global loads in flight a thread
template <int kBatch, typename Load, typename Store>
__device__ __forceinline__ void staged_copy4(int count, Load load, Store store) {
  for (int base = threadIdx.x; base < count; base += kBatch * kThreads) {
    float4 tmp[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      tmp[u] = load(idx, idx < count);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < count) store(idx, tmp[u]);
    }
  }
}

// 4 (f32) or 8 (bf16) probabilities as one 16-byte store
__device__ __forceinline__ void store16(float* dst, const float* p) {
  *reinterpret_cast<float4*>(dst) = make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* p) {
  uint4 w;
  uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const __nv_bfloat162 x = __floats2bfloat162_rn(p[2 * u], p[2 * u + 1]);
    wp[u] = *reinterpret_cast<const uint32_t*>(&x);
  }
  *reinterpret_cast<uint4*>(dst) = w;
}

// Stage q and pq of the block's RB rows from i0b (zero past Tq) and the pe
// band: pe row n = j - i + Tq - 1 of block row rg = i - i0b lives at band
// index j - rg + RB - 1 (stored at index + index >> BandPad<R>::shift).
template <int QD, int R, typename Tin>
__device__ __forceinline__ void stage_rows(const Tin* __restrict__ q, const Tin* __restrict__ pq,
                                           const Tin* __restrict__ pe, float* qs, float* pqs,
                                           float* band, int b, int h, int Tq, int T, int H,
                                           int i0b, int RB) {
  const int nrb = min(Tq - i0b, RB);
  staged_copy4<2>(
      RB * (QD / 4),
      [&](int idx, bool ok) {
        const int r = idx / (QD / 4), d4 = idx % (QD / 4);
        return load4_or_zero(q + ((size_t)(b * Tq + i0b + r) * H + h) * QD + 4 * d4,
                             ok && r < nrb);
      },
      [&](int idx, float4 x) { reinterpret_cast<float4*>(qs)[idx] = x; });
  staged_copy4<1>(
      RB,
      [&](int r, bool ok) {
        return load4_or_zero(pq + ((size_t)(b * Tq + i0b + r) * H + h) * kPD, ok && r < nrb);
      },
      [&](int r, float4 x) { reinterpret_cast<float4*>(pqs)[r] = x; });
  const int n0 = Tq - 1 - i0b - (RB - 1);
  staged_copy4<4>(
      band_rows(T, RB),
      [&](int idx, bool ok) {
        const int n = n0 + idx;
        return load4_or_zero(pe + ((size_t)n * H + h) * kPD, ok && n >= 0 && n < Tq + T - 1);
      },
      [&](int idx, float4 x) {
        reinterpret_cast<float4*>(band)[idx + (idx >> BandPad<R>::shift)] = x;
      });
}

// The k columns of keys j0 .. j0+KPT-1 in registers (zero past T) and their
// bias (-inf past T, so that they never win the row max).
template <int QD, int KPT, typename Tin>
__device__ __forceinline__ void load_keys(const Tin* __restrict__ ktb,
                                          const uint8_t* __restrict__ mask, int b, int T,
                                          int j0, float (&kr)[QD][KPT], float (&bias)[KPT]) {
  // whole groups of a T that keeps them aligned: one vector load a row
  if (j0 + KPT <= T && T % KPT == 0) {
#pragma unroll
    for (int d = 0; d < QD; ++d) {
      if constexpr (KPT == 4) {
        const float4 x = load4(ktb + (size_t)d * T + j0);
        kr[d][0] = x.x;
        kr[d][1 % KPT] = x.y;
        kr[d][2 % KPT] = x.z;
        kr[d][3 % KPT] = x.w;
      } else {
        const float2 x = load2(ktb + (size_t)d * T + j0);
        kr[d][0] = x.x;
        kr[d][1 % KPT] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < QD; ++d)
#pragma unroll
      for (int u = 0; u < KPT; ++u)
        kr[d][u] = j0 + u < T ? to_f32(ktb[(size_t)d * T + j0 + u]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < KPT; ++u)
    bias[u] = j0 + u < T ? mask_bias(mask, b, T, j0 + u) : -INFINITY;
}

// The scores s + bias of keys j0.. against one query row (q row q4r, pq
// pv, pe window win: band rows of keys j0..), and the pre-mask s (B4): one
// fmaf chain a score, q.k in d order, then the four pe terms.
template <int QD, int KPT>
__device__ __forceinline__ void score_row(const float (&kr)[QD][KPT], const float (&bias)[KPT],
                                          const float4 (&win)[KPT], const float4* q4r,
                                          float4 pv, float (&pre)[KPT], float (&sc)[KPT]) {
  float s[KPT];
#pragma unroll
  for (int u = 0; u < KPT; ++u) s[u] = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < QD / 4; ++d4) {
    const float4 qv = q4r[d4];
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      s[u] = fmaf(qv.x, kr[4 * d4][u], s[u]);
      s[u] = fmaf(qv.y, kr[4 * d4 + 1][u], s[u]);
      s[u] = fmaf(qv.z, kr[4 * d4 + 2][u], s[u]);
      s[u] = fmaf(qv.w, kr[4 * d4 + 3][u], s[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < KPT; ++u) {
    s[u] = fmaf(pv.x, win[u].x, s[u]);
    s[u] = fmaf(pv.y, win[u].y, s[u]);
    s[u] = fmaf(pv.z, win[u].z, s[u]);
    s[u] = fmaf(pv.w, win[u].w, s[u]);
    pre[u] = s[u];
    sc[u] = s[u] + bias[u];
  }
}

// KPT scores to a 16-byte aligned row position
template <int KPT>
__device__ __forceinline__ void store_scores(float* dst, const float (&sc)[KPT]) {
  if constexpr (KPT == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(sc[0], sc[1 % KPT], sc[2 % KPT], sc[3 % KPT]);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(sc[0], sc[1 % KPT]);
}

// The softmax sum of one row by one warp: e = expf(s - mx) summed in lane =
// j mod 32 classes, each in key order (kU loads and exps in flight), then
// warp_sum's xor tree; e is left in srow.  Returns 1 / sum.
__device__ __forceinline__ float row_sum(float* srow, float mx, int T) {
  const int lane = threadIdx.x & 31;
  constexpr int kU = 16;
  float sum = 0.f;
  int j = lane;
  for (; j + 32 * (kU - 1) < T; j += 32 * kU) {
    float e[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) e[u] = expf(srow[j + 32 * u] - mx);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      srow[j + 32 * u] = e[u];
      sum += e[u];
    }
  }
  for (; j < T; j += 32) {
    const float e = expf(srow[j] - mx);
    srow[j] = e;
    sum += e;
  }
  const float inv = 1.f / warp_sum(sum);
  __syncwarp();
  return inv;
}

// p rounded to Tout, as f32
template <typename Tout>
__device__ __forceinline__ float round_out(float p) {
  return to_f32(from_f32<Tout>(p));
}

// p = e * inv of one row by one warp, 16 bytes a lane (4 f32 or 8 bf16);
// the ragged head and tail of a row that does not start 16-byte aligned one
// element a lane.  kKeep (B6): round(p), as f32, also replaces e in srow.
template <typename Tout, bool kKeep = false>
__device__ __forceinline__ void write_row(float* srow, float inv, Tout* __restrict__ orow,
                                          int T) {
  const int lane = threadIdx.x & 31;
  constexpr int V = 16 / sizeof(Tout);
  const int mis = (int)((reinterpret_cast<uintptr_t>(orow) & 15) / sizeof(Tout));
  const int head = min(T, mis ? V - mis : 0);  // elements before a 16-byte boundary
  const int nvec = (T - head) / V;
  const int tail = head + nvec * V;
  if (lane < head) orow[lane] = from_f32<Tout>(srow[lane] * inv);
  if (lane < T - tail) orow[tail + lane] = from_f32<Tout>(srow[tail + lane] * inv);
  if constexpr (kKeep) {
    if (lane < head) srow[lane] = round_out<Tout>(srow[lane] * inv);
    if (lane < T - tail) srow[tail + lane] = round_out<Tout>(srow[tail + lane] * inv);
  }
  Tout* ov = orow + head;
  float* sv = srow + head;
  if ((head & 3) == 0) {  // the shared-memory side is 16-byte aligned too
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      float p[V];
#pragma unroll
      for (int u = 0; u < V; u += 4) {
        const float4 x = *reinterpret_cast<const float4*>(sv + v * V + u);
        p[u] = x.x * inv;
        p[u + 1] = x.y * inv;
        p[u + 2] = x.z * inv;
        p[u + 3] = x.w * inv;
      }
      store16(ov + v * V, p);
      if constexpr (kKeep) {
#pragma unroll
        for (int u = 0; u < V; u += 4)
          *reinterpret_cast<float4*>(sv + v * V + u) =
              make_float4(round_out<Tout>(p[u]), round_out<Tout>(p[u + 1]),
                          round_out<Tout>(p[u + 2]), round_out<Tout>(p[u + 3]));
      }
    }
  } else {
    for (int v = lane; v < nvec; v += 32) {
      float p[V];
#pragma unroll
      for (int u = 0; u < V; ++u) p[u] = sv[v * V + u] * inv;
      store16(ov + v * V, p);
      if constexpr (kKeep) {
#pragma unroll
        for (int u = 0; u < V; ++u) sv[v * V + u] = round_out<Tout>(p[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B6's epilogue: round(p) @ v on the tensor cores
// ---------------------------------------------------------------------------

// v (B,T,H,VD) over the T keys in the input type and out (B,Tq,H,VD) over
// the query rows (B6: the input type; B5: its output type); all: v is
// staged whole once a block (kc = keys16(T) keys), else streamed in chunks
// of kc = min(keys16(T), kChunkKeys) keys and 16 columns (kc is passed, not
// worked out in the kernel: that register is the one the f32-input, 16-row
// kernels do not have)
struct ConsumeArgs {
  const void* v;
  void* out;
  int VD, kc, all;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// v[k0 + kk][c0 + c] of one (b,h) (vb: its key 0, rows vstride apart) for
// kk < nk, c < nc (c0 and nc multiples of 4) into the v buffer by
// `cp.async`, zero past T; committed as one group.  f32: transposed, vbuf[c
// * vs + kk], 4 bytes a copy; bf16: as it lies, vbuf[kk * vs + c], 8 bytes
// a copy, the columns nc .. up to a multiple of 16 zero.
template <typename Tin>
__device__ __forceinline__ void copy_v(const Tin* __restrict__ vb, size_t vstride, Tin* vbuf,
                                       int vs, int k0, int nk, int c0, int nc, int T) {
  if constexpr (sizeof(Tin) == 4) {
    const int units = nk * nc;
    for (int i = threadIdx.x; i < units; i += kThreads) {
      const int kk = i / nc, cc = i - kk * nc;
      const bool valid = k0 + kk < T;
      cp_async4(vbuf + (size_t)cc * vs + kk,
                valid ? vb + (size_t)(k0 + kk) * vstride + c0 + cc : vb, valid);
    }
  } else {
    const int per = (nc + 15) / 16 * 4, units = nk * per;  // 4-column copies a key
    for (int i = threadIdx.x; i < units; i += kThreads) {
      const int kk = i / per, cc = 4 * (i - kk * per);
      const bool valid = k0 + kk < T && cc < nc;
      cp_async8(vbuf + (size_t)kk * vs + cc,
                valid ? vb + (size_t)(k0 + kk) * vstride + c0 + cc : vb, valid);
    }
  }
  cp_async_commit();
}

// This warp's share of P (16 x nk: rows g and g + 8 of the tile, columns
// kp0..) @ v (nk keys, columns c0 .. c0+ncol-1 of the v buffer; its key 0
// is column kp0 of P), in 16-key steps warp, warp + 8, ... (bf16: each
// step's fragments loaded while the last one's products run; f32 has no
// registers to spare for that); into acc (3xTF32: big + small sums in acc,
// acc2).  P holds round(p) as f32, zero from key T on; a tile of R < 16
// rows repeats its last row in the fragment's unused rows (rows 8-15 are
// zero where R <= 8).  Within a step, lane t takes keys 4t .. 4t+3 for its
// fragment columns (the sum over keys does not care which key is which
// column, as long as A and B agree), so that its A fragment of a row is one
// 16-byte load, and its B fragments are two 16-byte loads of the transposed
// f32 v, or one `ldmatrix.trans` of bf16 v whose lanes give the rows of
// those keys.
template <int R, bool kBf16Mma, typename Tin>
__device__ __forceinline__ void contract_keys(const float* P, int stride, const Tin* vbuf, int vs,
                                              int kp0, int nk, int c0, int ncol,
                                              float (&acc)[2][4], float (&acc2)[2][4]) {
  constexpr bool kF32V = sizeof(Tin) == 4;
  constexpr int NB = kF32V ? 8 : 4;  // B fragment registers a step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* p0 = P + (size_t)(g < R ? g : R - 1) * stride + kp0 + 4 * t;
  const float* p1 = P + (size_t)(g + 8 < R ? g + 8 : R - 1) * stride + kp0 + 4 * t;
  const bool ok0 = g < ncol, ok1 = g + 8 < ncol, n1 = ncol > 8;
  // f32: the rows of columns g, g + 8; bf16: this lane's ldmatrix row, of
  // key 4 (j / 2) + j % 2 (+ 2 for the odd matrices), columns 0-7 or 8-15
  const Tin* v0 = vbuf + (size_t)(c0 + g) * vs + 4 * t;
  const Tin* v1 = v0 + (size_t)8 * vs;
  const int j = lane & 7, m = lane >> 3;
  const Tin* vr = vbuf + (size_t)(4 * (j >> 1) + (j & 1) + 2 * (m & 1)) * vs + c0 + 8 * (m >> 1);
  auto load = [&](int k, float4& x, float4& y, uint32_t (&bq)[NB]) {
    x = *reinterpret_cast<const float4*>(p0 + k);
    // a tile of at most 8 rows leaves the fragment's rows 8-15 unused
    y = R > 8 ? *reinterpret_cast<const float4*>(p1 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kF32V) {
      const float4 z0 = ok0 ? *reinterpret_cast<const float4*>(v0 + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 z1 = ok1 ? *reinterpret_cast<const float4*>(v1 + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float z[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) bq[e] = __float_as_uint(z[e]);
    } else {
      ldmatrix_x4_trans(bq, vr + (size_t)k * vs);
    }
  };
  const int steps = nk / 16;
  float4 x, y;
  uint32_t bq[NB];
  if (warp < steps) load(16 * warp, x, y, bq);
  for (int s = warp; s < steps; s += kWarps) {
    const float4 cx = x, cy = y;
    uint32_t cb[NB];
#pragma unroll
    for (int e = 0; e < NB; ++e) cb[e] = bq[e];
    if constexpr (kBf16Mma) {
      if (s + kWarps < steps) load(16 * (s + kWarps), x, y, bq);
    }
    if constexpr (kBf16Mma) {
      const uint32_t a[4] = {pack_bf16(cx.x, cx.y), pack_bf16(cy.x, cy.y), pack_bf16(cx.z, cx.w),
                             pack_bf16(cy.z, cy.w)};
      mma_bf16_16816(acc[0], a, cb[0], cb[1]);
      if (n1) mma_bf16_16816(acc[1], a, cb[2], cb[3]);
    } else {
      // keys 4t, 4t + 1 (h = 0) and 4t + 2, 4t + 3 (h = 1) as columns t, t + 4
      const float av[2][4] = {{cx.x, cy.x, cx.y, cy.y}, {cx.z, cy.z, cx.w, cy.w}};
      float bv[2][2][2];  // [h][n][key]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (kF32V)
              bv[h][n][e] = __uint_as_float(cb[4 * n + 2 * h + e]);
            else  // bf16 pairs (low: the even key) widened exactly
              bv[h][n][e] = __uint_as_float(e ? cb[2 * n + h] & 0xffff0000u : cb[2 * n + h] << 16);
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(av[h][e], ah[e], al[e]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (n == 1 && !n1) break;  // warp-uniform
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(bv[h][n][0], bh0, bl0);
          split_tf32(bv[h][n][1], bh1, bl1);
          mma_3xtf32(acc[n], acc2[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      if (s + kWarps < steps) load(16 * (s + kWarps), x, y, bq);
    }
  }
}

// The warps' sums of columns c0 .. c0+15 meet in red, added in warp order;
// rows < nrows go out (row i0 + r of (b,h), of Tq rows) in To.  Ends with
// every warp past its reads of P and v.
template <typename To>
__device__ __forceinline__ void reduce_out(float* red, const float (&acc)[2][4],
                                           const float (&acc2)[2][4], To* __restrict__ out,
                                           int b, int h, int Tq, int H, int VD, int i0,
                                           int nrows, int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* rw = red + warp * 256;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = 8 * n + 2 * t;
    *reinterpret_cast<float2*>(rw + g * 16 + col) =
        make_float2(acc[n][0] + acc2[n][0], acc[n][1] + acc2[n][1]);
    *reinterpret_cast<float2*>(rw + (g + 8) * 16 + col) =
        make_float2(acc[n][2] + acc2[n][2], acc[n][3] + acc2[n][3]);
  }
  __syncthreads();
  const int r = threadIdx.x >> 4, col = c0 + (threadIdx.x & 15);
  if (r < nrows && col < VD) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * 256 + threadIdx.x];
    out[((size_t)(b * Tq + i0 + r) * H + h) * VD + col] = from_f32<To>(s);
  }
}

// B5: one row by one warp, e in srow from row_sum: round(p) to Tin, p = e *
// inv (with the gate: round(1 / max(count(p > 0), 1e-20)) on the support p
// > 0, zero off it) in place of e for keys < T, zero for keys T .. Tk - 1
// (Tk a multiple of 16, srow 16-byte aligned); nothing to device memory.
template <typename Tin>
__device__ __forceinline__ void apply_row(float* srow, float inv, int T, int Tk, int gate) {
  const int lane = threadIdx.x & 31;
  float used = 0.f;
  if (gate) {
    float cnt = 0.f;
    for (int j = lane; j < T; j += 32) cnt += srow[j] * inv > 0.f ? 1.f : 0.f;
    used = round_out<Tin>(1.f / fmaxf(warp_sum(cnt), 1e-20f));
  }
  float4* s4 = reinterpret_cast<float4*>(srow);
  for (int v = lane; v < Tk / 4; v += 32) {
    const float4 x = s4[v];
    float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float p = e[u] * inv;
      e[u] = 4 * v + u >= T ? 0.f : gate ? (p > 0.f ? used : 0.f) : round_out<Tin>(p);
    }
    s4[v] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

// ---------------------------------------------------------------------------
// B4's epilogue: the score cotangent from the tile's scores and g
// ---------------------------------------------------------------------------

// g (B,H,T,T), 16-byte aligned like ds, pen and limit; staged: the tiles'
// g rows and the keys' bias go through shared memory, else (the longest T)
// the row passes read g and the mask from device memory
struct DsArgs {
  const void* g;
  float pen, limit;
  int staged;
};

// Row stride (elements) of the staged g: a row's 16-byte chunks from the
// boundary at or before its first key
__host__ __device__ inline int g_stride(int T, int elem) {
  const int V = 16 / elem;
  return (T + 2 * V - 2) / V * V;
}

// B4's staged shared memory after the scores (floats): R rows of g from a
// 16-byte boundary, then the keys' bias row
__host__ __device__ inline size_t ds_floats(int T, int R, int stride, int elem) {
  return (size_t)(round4(R * stride) - R * stride) + (size_t)R * g_stride(T, elem) * elem / 4 + T;
}

// Rows row0 .. row0+n-1 of g (rows of T keys) into gbuf by 16-byte
// `cp.async`, one warp a row: key j of row r lands at gbuf[r * gs + mis + j],
// mis being the row's offset (elements) from a 16-byte boundary, so every
// copy is aligned on both sides; the first chunk reads the end of the row
// before (g starts aligned), bytes past the row are zeroed, not read.
// Committed as one group.
template <typename Tin>
__device__ __forceinline__ void copy_g(const Tin* __restrict__ g, Tin* gbuf, int gs, size_t row0,
                                       int n, int T) {
  constexpr int V = 16 / sizeof(Tin);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += kWarps) {
    const size_t off = (row0 + r) * T;
    const int mis = (int)(off % V);
    const Tin* src = g + off - mis;
    const int bytes = (T + mis) * (int)sizeof(Tin);
    for (int c = lane; 16 * c < bytes; c += 32)
      cp_async16_n(gbuf + (size_t)r * gs + c * V, src + c * V, min(16, bytes - 16 * c));
  }
  cp_async_commit();
}

// 16 bytes of g (4 f32 or 8 bf16) as f32
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[u]));
    x[2 * u] = f.x;
    x[2 * u + 1] = f.y;
  }
}

// One row of ds by one warp, from the pre-mask scores in srow, the row of g
// (grow[j] is key j, 16-byte aligned where orow is) and the keys' bias
// (bias(j)); mx is the row max of s + bias (kScan, the 1-row tile: this
// pass takes it).  The sum pass is row_sum's, e = expf((s + bias) - mx)
// summed in the same order, with sum(g * e) beside it; then ds = e * inv *
// (g - inv * sum(g * e)) (+ the penalty on s), written as write_row writes
// p.  !kPen: the sum pass leaves e in srow; kPen keeps s and the write
// pass takes expf again.
template <bool kScan, bool kPen, typename Tin, typename Bias>
__device__ __forceinline__ void ds_row(float* srow, const Tin* grow, Bias bias, float mx,
                                       Tin* __restrict__ orow, int T, float pen, float limit) {
  const int lane = threadIdx.x & 31;
  if constexpr (kScan) {
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, srow[j] + bias(j));
    mx = warp_max(mx);
  }
  constexpr int kU = 16;
  float sum = 0.f, gd = 0.f;
  int j = lane;
  for (; j + 32 * (kU - 1) < T; j += 32 * kU) {
    float e[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) e[u] = expf(srow[j + 32 * u] + bias(j + 32 * u) - mx);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if constexpr (!kPen) srow[j + 32 * u] = e[u];
      sum += e[u];
      gd = fmaf(to_f32(grow[j + 32 * u]), e[u], gd);
    }
  }
  for (; j < T; j += 32) {
    const float e = expf(srow[j] + bias(j) - mx);
    if constexpr (!kPen) srow[j] = e;
    sum += e;
    gd = fmaf(to_f32(grow[j]), e, gd);
  }
  const float inv = 1.f / warp_sum(sum);
  const float dot = inv * warp_sum(gd);
  __syncwarp();

  auto ds = [&](int k, float x, float gv) {
    if constexpr (kPen) {
      const float p = expf(x + bias(k) - mx) * inv;
      return p * (gv - dot) + penalty_term(x, pen, limit);
    } else {
      return x * inv * (gv - dot);
    }
  };
  constexpr int V = 16 / sizeof(Tin);
  const int mis = (int)((reinterpret_cast<uintptr_t>(orow) & 15) / sizeof(Tin));
  const int head = min(T, mis ? V - mis : 0);  // elements before a 16-byte boundary
  const int nvec = (T - head) / V;
  const int tail = head + nvec * V;
  if (lane < head) orow[lane] = from_f32<Tin>(ds(lane, srow[lane], to_f32(grow[lane])));
  if (lane < T - tail) {
    const int k = tail + lane;
    orow[k] = from_f32<Tin>(ds(k, srow[k], to_f32(grow[k])));
  }
  auto vec = [&](int k, const float (&x)[V]) {  // keys k .. k+V-1
    float gv[V], o[V];
    load16(grow + k, gv);
#pragma unroll
    for (int u = 0; u < V; ++u) o[u] = ds(k + u, x[u], gv[u]);
    store16(orow + k, o);
  };
  if ((head & 3) == 0) {  // the score side is 16-byte aligned too
#pragma unroll 4
    for (int v = lane; v < nvec; v += 32) {
      const int k = head + v * V;
      float x[V];
#pragma unroll
      for (int u = 0; u < V; u += 4) {
        const float4 y = *reinterpret_cast<const float4*>(srow + k + u);
        x[u] = y.x;
        x[u + 1] = y.y;
        x[u + 2] = y.z;
        x[u + 3] = y.w;
      }
      vec(k, x);
    }
  } else {
    for (int v = lane; v < nvec; v += 32) {
      const int k = head + v * V;
      float x[V];
#pragma unroll
      for (int u = 0; u < V; ++u) x[u] = srow[k + u];
      vec(k, x);
    }
  }
}

// The epilogue modes of the shared body: B1's probabilities, B6's
// contraction, B4's score cotangent, B5's contraction without the
// probabilities
enum class Epi { kProbs, kConsume, kDs, kApply };

// grid (row blocks, B*H); block x owns rows [x*rpb, min(Tq, x*rpb + rpb)) in
// tiles of R rows (the last one may be short): the scores of a tile, a
// barrier, its softmax, a barrier; with kConsume (B6), then the tile's
// round(p) @ v; with kDs (B4), the softmax passes write ds instead of p;
// with kApply (B5), they write nothing and the tile's round(p) (or, with
// gate, the const branch's) @ v goes out in Tout (out is not read).
template <int QD, int R, typename Tin, typename Tout, Epi kE>
__device__ __forceinline__ void probs_body(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                                           const Tin* __restrict__ pq,
                                           const Tin* __restrict__ pe,
                                           const uint8_t* __restrict__ mask,
                                           Tout* __restrict__ out, int Tq, int T, int H,
                                           int rpb, const ConsumeArgs& c, const DsArgs& d,
                                           int gate = 0) {
  constexpr bool kConsume = kE == Epi::kConsume;
  constexpr bool kDs = kE == Epi::kDs;
  constexpr bool kApply = kE == Epi::kApply;
  constexpr bool kContract = kConsume || kApply;  // round(p) @ v after each tile
  constexpr int KPT = KeysPerThread<QD>::value;
  constexpr int kShift = BandPad<R>::shift;
  // the contraction's operands: p rounded to the probs dtype (B6) or to
  // v's (B5), and v
  constexpr bool kBf16Mma = std::is_same<Tin, __nv_bfloat16>::value &&
                            (kApply || std::is_same<Tout, __nv_bfloat16>::value);
  using To = std::conditional_t<kApply, Tout, Tin>;  // the contraction's output type
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int i0b = blockIdx.x * rpb;                 // first row of the block
  const int i_end = min(Tq, i0b + rpb);
  const int ntb = (i_end - i0b + R - 1) / R;          // tiles of the block
  const int RB = (rpb + R - 1) / R * R;               // rows the layout holds
  const int stride = kContract ? stride16(keys16(T)) : score_stride(T, R);
  const int NB = band_rows(T, RB);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* pqs = qs + RB * QD;
  float* band = pqs + RB * kPD;
  float* part = band + (size_t)band_slots<R>(NB) * kPD;
  float* scores = part + (R == 1 ? 0 : R * kThreads);
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const float4* pq4 = reinterpret_cast<const float4*>(pqs);
  const float4* band4 = reinterpret_cast<const float4*>(band);

  // B6, B5: the v buffer (all of v, or a streamed chunk of 16 columns) and
  // the partial sums after the scores; all of v staged now, landing while
  // the rows and keys load
  const int Tk = keys16(T);
  const int vcols = c.all ? c.VD : min(c.VD, 16);
  const int vs = v_stride(vcols, c.kc, (int)sizeof(Tin));
  Tin* vbuf = reinterpret_cast<Tin*>(scores + (size_t)R * stride);
  float* red = scores + (size_t)R * stride + v_floats(vcols, c.kc, (int)sizeof(Tin));
  const Tin* vb = static_cast<const Tin*>(c.v) + ((size_t)b * T * H + h) * c.VD;
  if constexpr (kContract) {
    if (c.all) copy_v(vb, (size_t)H * c.VD, vbuf, vs, 0, Tk, 0, c.VD, T);
  }

  // B4: g's rows and the keys' bias after the scores; the first tile's g
  // rows requested now, landing while the rows and keys load
  const int gs = g_stride(T, (int)sizeof(Tin));
  Tin* gbuf = reinterpret_cast<Tin*>(scores + round4(R * stride));
  float* brow = reinterpret_cast<float*>(gbuf + (size_t)R * gs);
  const Tin* gb = static_cast<const Tin*>(d.g);
  if constexpr (kDs) {
    if (d.staged) {
      copy_g(gb, gbuf, gs, (size_t)bh * Tq + i0b, min(R, i_end - i0b), T);
      for (int j = tid; j < T; j += kThreads) brow[j] = mask_bias(mask, b, T, j);
    }
  }

  stage_rows<QD, R>(q, pq, pe, qs, pqs, band, b, h, Tq, T, H, i0b, RB);

  // this thread's key groups and rows: the groups spread over the nts
  // threads of a slice, each tile's R rows over S slices of rps rows; S > 1
  // only where the groups leave threads idle (short T)
  const int ngroups = (T + KPT - 1) / KPT;
  int S = 1;
  while (2 * S <= R && 2 * S * ngroups <= kThreads) S *= 2;
  const int nts = kThreads / S, rps = R / S;
  const int gl = tid % nts, r0 = (tid / nts) * rps;
  const bool resident = ngroups <= nts;  // one group a thread: k stays in registers
  const Tin* ktb = kt + (size_t)bh * QD * T;
  float kr[QD][KPT];
  float bias[KPT];
  if (resident && gl < ngroups) load_keys<QD>(ktb, mask, b, T, gl * KPT, kr, bias);
  __syncthreads();

  for (int t = 0; t < ntb; ++t) {
    const int rb = t * R;  // the tile's first block row
    const int i0 = i0b + rb;
    const int nrows = min(R, i_end - i0);
    float m[R];  // running max of this thread's rows r0 + rr
#pragma unroll
    for (int rr = 0; rr < R; ++rr) m[rr] = -INFINITY;

    for (int g = gl; g < ngroups; g += nts) {
      const int j0 = g * KPT;
      if (!resident) load_keys<QD>(ktb, mask, b, T, j0, kr, bias);
      const int idx0 = j0 + RB - 1 - rb - r0;  // band index of key j0 at row r0
      float4 win[KPT];                         // band rows of keys j0.. at row r
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const int idx = min(idx0 + u, NB - 1);  // past T: any finite row
        win[u] = band4[idx + (idx >> kShift)];
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        if (rr >= rps || r0 + rr >= nrows) break;
        const int r = r0 + rr;
        if (rr > 0) {
#pragma unroll
          for (int u = KPT - 1; u > 0; --u) win[u] = win[u - 1];
          const int idx = idx0 - rr;
          win[0] = band4[idx + (idx >> kShift)];
        }
        float pre[KPT], sc[KPT];
        score_row<QD, KPT>(kr, bias, win, q4 + (rb + r) * (QD / 4), pq4[rb + r], pre, sc);
#pragma unroll
        for (int u = 0; u < KPT; ++u) m[rr] = fmaxf(m[rr], sc[u]);
        float* dst = scores + (size_t)r * stride + j0;
        const float(&st)[KPT] = kDs ? pre : sc;  // B4 keeps the pre-mask score
        if constexpr (R > 1) {
          store_scores<KPT>(dst, st);
        } else {
#pragma unroll
          for (int u = 0; u < KPT; ++u)
            if (j0 + u < T) dst[u] = st[u];
        }
      }
    }
    if constexpr (R > 1) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        if (rr < rps) part[(r0 + rr) * nts + gl] = m[rr];
    }
    if constexpr (kDs) cp_async_wait<0>();  // this thread's g copies have landed
    __syncthreads();

    // the softmax, one warp a row
    for (int r = warp; r < nrows; r += kWarps) {
      float* srow = scores + (size_t)r * stride;
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
      if constexpr (R > 1) {
        const float* pr = part + r * nts;
#pragma unroll
        for (int x = lane; x < kThreads; x += 128) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (x + 32 * k < nts) mx[k] = fmaxf(mx[k], pr[x + 32 * k]);
        }
      } else if constexpr (!kDs) {  // B4's 1-row tile adds the bias first
        for (int j = lane; j < T; j += 32) mx[0] = fmaxf(mx[0], srow[j]);
      }
      const float rmax = warp_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
      if constexpr (kDs) {
        const size_t off = ((size_t)bh * Tq + i0 + r) * T;
        constexpr int V = 16 / sizeof(Tin);
        if (d.staged) {
          const Tin* grow = gbuf + (size_t)r * gs + (int)(off % V);
          auto bias_of = [&](int j) { return brow[j]; };
          if (d.pen != 0.f)
            ds_row<R == 1, true>(srow, grow, bias_of, rmax, out + off, T, d.pen, d.limit);
          else
            ds_row<R == 1, false>(srow, grow, bias_of, rmax, out + off, T, 0.f, 0.f);
        } else if constexpr (R == 1) {
          auto bias_of = [&](int j) { return mask_bias(mask, b, T, j); };
          if (d.pen != 0.f)
            ds_row<true, true>(srow, gb + off, bias_of, rmax, out + off, T, d.pen, d.limit);
          else
            ds_row<true, false>(srow, gb + off, bias_of, rmax, out + off, T, 0.f, 0.f);
        }
      } else if constexpr (kApply) {
        apply_row<Tin>(srow, row_sum(srow, rmax, T), T, Tk, gate);
      } else {
        const float inv = row_sum(srow, rmax, T);
        write_row<Tout, kConsume>(srow, inv, out + ((size_t)bh * Tq + i0 + r) * T, T);
      }
      if constexpr (kConsume) {
        for (int j = T + lane; j < Tk; j += 32) srow[j] = 0.f;  // keys past T
      }
    }
    if constexpr (kContract) cp_async_wait<0>();  // the staged v has landed
    __syncthreads();

    if constexpr (kDs) {  // the next tile's g rows, landing while its scores are made
      if (d.staged && t + 1 < ntb)
        copy_g(gb, gbuf, gs, (size_t)bh * Tq + i0 + R, min(R, i_end - i0 - R), T);
    }

    if constexpr (kContract) {
      // round(p) @ v, 16 columns at a time
      for (int c0 = 0; c0 < c.VD; c0 += 16) {
        float acc[2][4], acc2[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = acc2[n][e] = 0.f;
        const int ncol = min(16, c.VD - c0);
        if (c.all) {
          contract_keys<R, kBf16Mma>(scores, stride, vbuf, vs, 0, Tk, c0, ncol, acc, acc2);
        } else {
          for (int k0 = 0; k0 < Tk; k0 += c.kc) {
            const int nk = min(c.kc, Tk - k0);
            __syncthreads();  // the last chunk is consumed
            copy_v(vb, (size_t)H * c.VD, vbuf, vs, k0, nk, c0, ncol, T);
            cp_async_wait<0>();
            __syncthreads();
            contract_keys<R, kBf16Mma>(scores, stride, vbuf, vs, k0, nk, 0, ncol, acc, acc2);
          }
        }
        reduce_out(red, acc, acc2, static_cast<To*>(c.out), b, h, Tq, H, c.VD, i0, nrows, c0);
        if (c0 + 16 < c.VD) __syncthreads();  // red is read before the next columns
      }
    }
  }
}

// B1
template <int QD, int R, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
rel_probs_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                 const Tin* __restrict__ pq, const Tin* __restrict__ pe,
                 const uint8_t* __restrict__ mask, Tout* __restrict__ out, int Tq, int T,
                 int H, int rpb) {
  probs_body<QD, R, Tin, Tout, Epi::kProbs>(q, kt, pq, pe, mask, out, Tq, T, H, rpb,
                                            ConsumeArgs{}, DsArgs{});
}

// B6: B1's probabilities in `out`, round(p) @ v in c.out
template <int QD, int R, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
rel_probs_consume_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                         const Tin* __restrict__ pq, const Tin* __restrict__ pe,
                         const uint8_t* __restrict__ mask, Tout* __restrict__ out, int Tq,
                         int T, int H, int rpb, ConsumeArgs c) {
  probs_body<QD, R, Tin, Tout, Epi::kConsume>(q, kt, pq, pe, mask, out, Tq, T, H, rpb, c,
                                              DsArgs{});
}

// B4: the score cotangent of B1's probabilities in `ds`, from d.g
template <int QD, int R, typename Tin>
__global__ void __launch_bounds__(kThreads, 1)
rel_ds_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt, const Tin* __restrict__ pq,
              const Tin* __restrict__ pe, const uint8_t* __restrict__ mask,
              Tin* __restrict__ ds, int Tq, int T, int H, int rpb, DsArgs d) {
  probs_body<QD, R, Tin, Tin, Epi::kDs>(q, kt, pq, pe, mask, ds, Tq, T, H, rpb, ConsumeArgs{}, d);
}

// B5 at a narrow V: round(p) (or, with gate, the const branch's) @ v in
// Tout to c.out; no probabilities
template <int QD, int R, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
rel_apply_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                 const Tin* __restrict__ pq, const Tin* __restrict__ pe,
                 const uint8_t* __restrict__ mask, int T, int H, int rpb, ConsumeArgs c,
                 int gate) {
  probs_body<QD, R, Tin, Tout, Epi::kApply>(q, kt, pq, pe, mask, nullptr, T, T, H, rpb, c,
                                            DsArgs{}, gate);
}

// Launch with R-row tiles and rpb rows a block (fewer if the shared memory
// asks for it); 1 if launched (or the launch failed: *code), 0 if R does not
// fit.  B6 and B5 count their v buffer and partial sums too: all of v where
// that fits, else a chunk of kChunkKeys keys and 16 columns.  B4 counts its
// staged g rows and bias row; where they do not fit at one row a tile, the
// kernel reads g from device memory instead.
template <int QD, int R, typename Tin, typename Tout, Epi kE>
int try_launch(const void* q, const void* kt, const void* pq, const void* pe,
               const void* mask, void* out, int B, int Tq, int T, int H, int rpb0,
               ConsumeArgs c, DsArgs d, int gate, cudaStream_t stream, int* code) {
  constexpr bool kConsume = kE == Epi::kConsume, kDs = kE == Epi::kDs;
  constexpr bool kContract = kConsume || kE == Epi::kApply;
  const int max_smem = max_optin_smem();
  const int Tk = keys16(T);
  const int stride = kContract ? stride16(Tk) : score_stride(T, R);
  auto bytes = [&](int rpb, bool all) {
    size_t f = smem_floats<R>(T, (rpb + R - 1) / R * R, QD, stride);
    if (kContract)
      f += (all ? v_floats(c.VD, Tk, (int)sizeof(Tin))
                : v_floats(std::min(c.VD, 16), std::min(Tk, kChunkKeys), (int)sizeof(Tin))) +
           kRedFloats;
    if (kDs && all) f += ds_floats(T, R, stride, (int)sizeof(Tin));
    return f * sizeof(float);
  };
  // fewer rows a block until it fits
  int rpb = rpb0;
  bool all = true;
  while (rpb > R && bytes(rpb, all) > (size_t)max_smem) rpb = std::max(R, (rpb + 1) / 2);
  if ((kContract || (kDs && R == 1)) && bytes(rpb, all) > (size_t)max_smem) {
    all = false;  // B6, B5: stream v; B4: g from device memory
    rpb = rpb0;
    while (rpb > R && bytes(rpb, all) > (size_t)max_smem) rpb = std::max(R, (rpb + 1) / 2);
  }
  if (bytes(rpb, all) > (size_t)max_smem) return 0;
  const size_t smem = bytes(rpb, all);
  c.kc = all ? Tk : std::min(Tk, kChunkKeys);
  c.all = all;
  d.staged = all;
  dim3 grid((Tq + rpb - 1) / rpb, B * H);
  const Tin* qi = static_cast<const Tin*>(q);
  const Tin* kti = static_cast<const Tin*>(kt);
  const Tin* pqi = static_cast<const Tin*>(pq);
  const Tin* pei = static_cast<const Tin*>(pe);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaError_t e;
  if constexpr (kConsume) {
    auto kern = rel_probs_consume_kernel<QD, R, Tin, Tout>;
    e = allow_smem(kern, smem);
    if (e == cudaSuccess)
      kern<<<grid, kThreads, smem, stream>>>(qi, kti, pqi, pei, m, static_cast<Tout*>(out), Tq, T,
                                             H, rpb, c);
  } else if constexpr (kE == Epi::kApply) {
    auto kern = rel_apply_kernel<QD, R, Tin, Tout>;
    e = allow_smem(kern, smem);
    if (e == cudaSuccess)
      kern<<<grid, kThreads, smem, stream>>>(qi, kti, pqi, pei, m, T, H, rpb, c, gate);
  } else if constexpr (kDs) {
    auto kern = rel_ds_kernel<QD, R, Tin>;
    e = allow_smem(kern, smem);
    if (e == cudaSuccess)
      kern<<<grid, kThreads, smem, stream>>>(qi, kti, pqi, pei, m, static_cast<Tin*>(out), Tq, T,
                                             H, rpb, d);
  } else {
    auto kern = rel_probs_kernel<QD, R, Tin, Tout>;
    e = allow_smem(kern, smem);
    if (e == cudaSuccess)
      kern<<<grid, kThreads, smem, stream>>>(qi, kti, pqi, pei, m, static_cast<Tout*>(out), Tq, T,
                                             H, rpb);
  }
  *code = (int)(e == cudaSuccess ? cudaGetLastError() : e);
  return 1;
}

template <int QD, Epi kE, typename Tin, typename Tout>
int launch_typed(const void* q, const void* kt, const void* pq, const void* pe,
                 const void* mask, void* out, int B, int Tq, int T, int H, const ConsumeArgs& c,
                 const DsArgs& d, int gate, cudaStream_t stream) {
  // one block an SM: the rows of each (b, h) split evenly over SMs / (B*H)
  // blocks; tiles of 16 rows, or of 8 / 4 where a block has no more rows
  // (short T), or where long rows fill shared memory (then 1)
  const int blocks = std::max(1, sm_count() / (B * H));
  const int rpb = (Tq + blocks - 1) / blocks;
  int code = 0;
  if ((rpb > 8 && try_launch<QD, 16, Tin, Tout, kE>(q, kt, pq, pe, mask, out, B, Tq, T, H, rpb,
                                                     c, d, gate, stream, &code)) ||
      (rpb > 4 && try_launch<QD, 8, Tin, Tout, kE>(q, kt, pq, pe, mask, out, B, Tq, T, H, rpb, c,
                                                    d, gate, stream, &code)) ||
      try_launch<QD, 4, Tin, Tout, kE>(q, kt, pq, pe, mask, out, B, Tq, T, H, rpb, c, d, gate,
                                       stream, &code) ||
      try_launch<QD, 1, Tin, Tout, kE>(q, kt, pq, pe, mask, out, B, Tq, T, H, rpb, c, d, gate,
                                       stream, &code))
    return code;
  return (int)cudaErrorInvalidValue;
}

// QD, PD and the output type dispatched, for Tin inputs (B4's output type
// is its input type; B5's is out_bf16's, its probabilities are not
// written); Tq query rows against T keys; gate: B5's const gate
template <Epi kE, typename Tin>
int launch_in(const void* q, const void* kt, const void* pq, const void* pe, const void* mask,
              void* out, int B, int Tq, int T, int H, int QD, int PD, int out_bf16,
              const ConsumeArgs& c, const DsArgs& d, void* stream, int gate = 0) {
  if (PD != kPD || B <= 0 || Tq <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (QD) {
#define ZV_QD(QDV)                                                                           \
  case QDV:                                                                                  \
    if constexpr (kE == Epi::kDs)                                                            \
      return launch_typed<QDV, kE, Tin, Tin>(q, kt, pq, pe, mask, out, B, Tq, T, H, c, d,   \
                                             gate, s);                                       \
    else                                                                                     \
      return out_bf16 ? launch_typed<QDV, kE, Tin, __nv_bfloat16>(q, kt, pq, pe, mask, out, \
                                                                  B, Tq, T, H, c, d, gate, s) \
                      : launch_typed<QDV, kE, Tin, float>(q, kt, pq, pe, mask, out, B, Tq, T, \
                                                          H, c, d, gate, s);
    ZV_QD(8)
    ZV_QD(16)
    ZV_QD(24)
    ZV_QD(32)
    ZV_QD(64)
#undef ZV_QD
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// B6 for bf16 inputs (rel_probs_consume_bf16.cu, linked beside
// rel_probs_consume.cu): zv_rel_probs_consume's arguments after bf16.
int rel_probs_consume_bf16(const void* q, const void* kt, const void* pq, const void* pe,
                           const void* mask, const void* v, void* probs, void* out, int B,
                           int Tq, int Tk, int H, int QD, int PD, int VD, int probs_bf16,
                           void* stream);
