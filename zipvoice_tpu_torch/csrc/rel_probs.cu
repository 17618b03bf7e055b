// Relative-position attention probabilities for the Zipformer (B1).
//
// Replaces the TPU kernel zipvoice_tpu/ops/attention.py `_pallas_rel_probs`
// (body `_kernel` with `_tile_scores` / `_tile_softmax`):
//
//   probs[b,h,i,j] = softmax_j( q_i . k_j + pq_i . pe[j - i + T - 1] + bias_j )
//
// with bias_j = -1000 where key j is padded (else 0), scores and softmax in
// f32, probs written in f32 or bf16.  q: (B,T,H,QD); kt: k transposed to
// (B,H,QD,T) by the caller; pq: (B,T,H,PD); pe: (2T-1,H,PD); mask: (B,T)
// uint8 or null; out: (B,H,T,T).
//
// The arithmetic is that of the shared row tile (rel_common.cuh), which B3-B7
// recompute, so B6's probabilities equal B1's bit for bit and B3's const
// gate recomputes B1's support p > 0: each score is one fmaf chain over q.k
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

#include <algorithm>

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

// Band rows of RB block rows: pe rows j - i + T - 1 for the block's rows.
__host__ __device__ inline int band_rows(int T, int RB) { return T + RB - 1; }
template <int R>
__host__ __device__ inline int band_slots(int NB) {
  return NB + (NB >> BandPad<R>::shift) + BandPad<R>::extra;
}

// shared memory (floats): q[RB*QD] | pq[RB*4] | band | row-max partials
// [R*threads] (none for R = 1) | scores[R*stride]
template <int R>
__host__ __device__ inline size_t smem_floats(int T, int RB, int QD) {
  return (size_t)RB * QD + (size_t)RB * kPD + (size_t)band_slots<R>(band_rows(T, RB)) * kPD +
         (R == 1 ? 0 : (size_t)R * kThreads) + (size_t)R * score_stride(T, R);
}

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

// Stage q and pq of the block's RB rows from i0b (zero past T) and the pe
// band: pe row n = j - i + T - 1 of block row rg = i - i0b lives at band
// index j - rg + RB - 1 (stored at index + index >> BandPad<R>::shift).
template <int QD, int R, typename Tin>
__device__ __forceinline__ void stage_rows(const Tin* __restrict__ q, const Tin* __restrict__ pq,
                                           const Tin* __restrict__ pe, float* qs, float* pqs,
                                           float* band, int b, int h, int T, int H, int i0b,
                                           int RB) {
  const int nrb = min(T - i0b, RB);
  staged_copy4<2>(
      RB * (QD / 4),
      [&](int idx, bool ok) {
        const int r = idx / (QD / 4), d4 = idx % (QD / 4);
        return load4_or_zero(q + ((size_t)(b * T + i0b + r) * H + h) * QD + 4 * d4,
                             ok && r < nrb);
      },
      [&](int idx, float4 x) { reinterpret_cast<float4*>(qs)[idx] = x; });
  staged_copy4<1>(
      RB,
      [&](int r, bool ok) {
        return load4_or_zero(pq + ((size_t)(b * T + i0b + r) * H + h) * kPD, ok && r < nrb);
      },
      [&](int r, float4 x) { reinterpret_cast<float4*>(pqs)[r] = x; });
  const int n0 = T - 1 - i0b - (RB - 1);
  staged_copy4<4>(
      band_rows(T, RB),
      [&](int idx, bool ok) {
        const int n = n0 + idx;
        return load4_or_zero(pe + ((size_t)n * H + h) * kPD, ok && n >= 0 && n < 2 * T - 1);
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
// pv, pe window win: band rows of keys j0..): one fmaf chain a score, q.k
// in d order, then the four pe terms.
template <int QD, int KPT>
__device__ __forceinline__ void score_row(const float (&kr)[QD][KPT], const float (&bias)[KPT],
                                          const float4 (&win)[KPT], const float4* q4r,
                                          float4 pv, float (&sc)[KPT]) {
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

// p = e * inv of one row by one warp, 16 bytes a lane (4 f32 or 8 bf16);
// the ragged head and tail of a row that does not start 16-byte aligned one
// element a lane.
template <typename Tout>
__device__ __forceinline__ void write_row(const float* srow, float inv, Tout* __restrict__ orow,
                                          int T) {
  const int lane = threadIdx.x & 31;
  constexpr int V = 16 / sizeof(Tout);
  const int mis = (int)((reinterpret_cast<uintptr_t>(orow) & 15) / sizeof(Tout));
  const int head = min(T, mis ? V - mis : 0);  // elements before a 16-byte boundary
  const int nvec = (T - head) / V;
  const int tail = head + nvec * V;
  if (lane < head) orow[lane] = from_f32<Tout>(srow[lane] * inv);
  if (lane < T - tail) orow[tail + lane] = from_f32<Tout>(srow[tail + lane] * inv);
  Tout* ov = orow + head;
  const float* sv = srow + head;
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
    }
  } else {
    for (int v = lane; v < nvec; v += 32) {
      float p[V];
#pragma unroll
      for (int u = 0; u < V; ++u) p[u] = sv[v * V + u] * inv;
      store16(ov + v * V, p);
    }
  }
}

// grid (row blocks, B*H); block x owns rows [x*rpb, min(T, x*rpb + rpb)) in
// tiles of R rows (the last one may be short): the scores of a tile, a
// barrier, its softmax, a barrier.
template <int QD, int R, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, 1)
rel_probs_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                 const Tin* __restrict__ pq, const Tin* __restrict__ pe,
                 const uint8_t* __restrict__ mask, Tout* __restrict__ out, int T, int H,
                 int rpb) {
  constexpr int KPT = KeysPerThread<QD>::value;
  constexpr int kShift = BandPad<R>::shift;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int i0b = blockIdx.x * rpb;                 // first row of the block
  const int i_end = min(T, i0b + rpb);
  const int ntb = (i_end - i0b + R - 1) / R;          // tiles of the block
  const int RB = (rpb + R - 1) / R * R;               // rows the layout holds
  const int stride = score_stride(T, R);
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

  stage_rows<QD, R>(q, pq, pe, qs, pqs, band, b, h, T, H, i0b, RB);

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
        float sc[KPT];
        score_row<QD, KPT>(kr, bias, win, q4 + (rb + r) * (QD / 4), pq4[rb + r], sc);
#pragma unroll
        for (int u = 0; u < KPT; ++u) m[rr] = fmaxf(m[rr], sc[u]);
        float* dst = scores + (size_t)r * stride + j0;
        if constexpr (R > 1) {
          store_scores<KPT>(dst, sc);
        } else {
#pragma unroll
          for (int u = 0; u < KPT; ++u)
            if (j0 + u < T) dst[u] = sc[u];
        }
      }
    }
    if constexpr (R > 1) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        if (rr < rps) part[(r0 + rr) * nts + gl] = m[rr];
    }
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
      } else {
        for (int j = lane; j < T; j += 32) mx[0] = fmaxf(mx[0], srow[j]);
      }
      const float inv =
          row_sum(srow, warp_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))), T);
      write_row(srow, inv, out + ((size_t)bh * T + i0 + r) * T, T);
    }
    __syncthreads();
  }
}

// Launch with R-row tiles and rpb rows a block (fewer if the shared memory
// asks for it); 1 if launched (or the launch failed: *code), 0 if R does not
// fit.
template <int QD, int R, typename Tin, typename Tout>
int try_launch(const void* q, const void* kt, const void* pq, const void* pe,
               const void* mask, void* out, int B, int T, int H, int rpb0,
               cudaStream_t stream, int* code) {
  const int max_smem = max_optin_smem();
  auto bytes = [&](int rpb) {
    return smem_floats<R>(T, (rpb + R - 1) / R * R, QD) * sizeof(float);
  };
  // fewer rows a block until it fits
  int rpb = rpb0;
  while (rpb > R && bytes(rpb) > (size_t)max_smem) rpb = std::max(R, (rpb + 1) / 2);
  if (bytes(rpb) > (size_t)max_smem) return 0;
  const size_t smem = bytes(rpb);
  auto kern = rel_probs_kernel<QD, R, Tin, Tout>;
  cudaError_t e = allow_smem(kern, smem);
  if (e == cudaSuccess) {
    dim3 grid((T + rpb - 1) / rpb, B * H);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const Tin*>(q), static_cast<const Tin*>(kt), static_cast<const Tin*>(pq),
        static_cast<const Tin*>(pe), static_cast<const uint8_t*>(mask),
        static_cast<Tout*>(out), T, H, rpb);
    e = cudaGetLastError();
  }
  *code = (int)e;
  return 1;
}

template <int QD, typename Tin, typename Tout>
int launch_typed(const void* q, const void* kt, const void* pq, const void* pe,
                 const void* mask, void* out, int B, int T, int H, cudaStream_t stream) {
  // one block an SM: the rows of each (b, h) split evenly over SMs / (B*H)
  // blocks; tiles of 16 rows, or of 8 / 4 where a block has no more rows
  // (short T), or where long rows fill shared memory (then 1)
  const int blocks = std::max(1, sm_count() / (B * H));
  const int rpb = (T + blocks - 1) / blocks;
  int code = 0;
  if ((rpb > 8 &&
       try_launch<QD, 16, Tin, Tout>(q, kt, pq, pe, mask, out, B, T, H, rpb, stream, &code)) ||
      (rpb > 4 &&
       try_launch<QD, 8, Tin, Tout>(q, kt, pq, pe, mask, out, B, T, H, rpb, stream, &code)) ||
      try_launch<QD, 4, Tin, Tout>(q, kt, pq, pe, mask, out, B, T, H, rpb, stream, &code) ||
      try_launch<QD, 1, Tin, Tout>(q, kt, pq, pe, mask, out, B, T, H, rpb, stream, &code))
    return code;
  return (int)cudaErrorInvalidValue;
}

template <int QD>
int launch_qd(const void* q, const void* kt, const void* pq, const void* pe, const void* mask,
              void* out, int B, int T, int H, int in_bf16, int out_bf16, cudaStream_t s) {
  if (!in_bf16 && !out_bf16)
    return launch_typed<QD, float, float>(q, kt, pq, pe, mask, out, B, T, H, s);
  if (!in_bf16 && out_bf16)
    return launch_typed<QD, float, __nv_bfloat16>(q, kt, pq, pe, mask, out, B, T, H, s);
  if (in_bf16 && !out_bf16)
    return launch_typed<QD, __nv_bfloat16, float>(q, kt, pq, pe, mask, out, B, T, H, s);
  return launch_typed<QD, __nv_bfloat16, __nv_bfloat16>(q, kt, pq, pe, mask, out, B, T, H, s);
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (QD not instantiated, PD != 4, T too long for shared memory).
extern "C" int zv_rel_probs(const void* q, const void* kt, const void* pq, const void* pe,
                            const void* mask, void* out, int B, int T, int H, int QD,
                            int PD, int in_bf16, int out_bf16, void* stream) {
  if (PD != kPD || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (QD) {
    case 8: return launch_qd<8>(q, kt, pq, pe, mask, out, B, T, H, in_bf16, out_bf16, s);
    case 16: return launch_qd<16>(q, kt, pq, pe, mask, out, B, T, H, in_bf16, out_bf16, s);
    case 24: return launch_qd<24>(q, kt, pq, pe, mask, out, B, T, H, in_bf16, out_bf16, s);
    case 32: return launch_qd<32>(q, kt, pq, pe, mask, out, B, T, H, in_bf16, out_bf16, s);
    case 64: return launch_qd<64>(q, kt, pq, pe, mask, out, B, T, H, in_bf16, out_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
