// The wide-V consume kernel: relative-position probabilities, recomputed
// and never written, rounded to v's dtype, @ a wide value stream on the
// tensor cores.  Two entry points build it:
//
//   B7 (rel_consume_fwd.cu) `rel_attention_head0_consume` (TPU body
//      `_head0_consume_kernel`): head 0 only, v (B,T,C) (C = 384 fm_decoder,
//      144 text encoder), out in v's dtype;
//   B5's wide route (rel_apply_wide.cu) `_pallas_rel_apply` (TPU body
//      `_apply_kernel`, probabilities `_apply_probs`) for VD > 64: every
//      (b, h), v (B,T,H,VD), used = const_gate ? (p > 0) / count(p > 0) : p,
//      out in out_dtype.
//
// B7 is the case nh = 1, h = 0 of the same code (same bits), with that
// case's constants folded in (kHeads = false: same code).  The row tile
// is rel_common's (scores and softmax as B1's, so the support p > 0 under
// the const gate is the one B3 recomputes).  Any T: the ragged row tile is
// masked, nothing is padded.  C (VD) must be a multiple of 4.
//
// The contraction P (16 x T) @ v (T x C) is 2*16*T*C operations a block
// against 16*T*36 for the scores, so it runs on the tensor cores
// (tensor_core.cuh), 512 threads a block:
//   * the softmax leaves P, rounded to v's dtype, in its own shared-memory
//     tile with a padded row stride (conflict-free fragment loads) and zero
//     keys up to a multiple of the stage;
//   * v streams through 3 (or, where they do not fit, 2) stages of 64 (bf16)
//     or 32 (f32) keys x up to 384 columns, filled by coalesced 16-byte
//     `cp.async` (8-byte in bf16 when C is not a multiple of 8) whose
//     offsets a thread works out once a pass, keys past T zero-filled;
//     the stages take the row tile's memory once the softmax is done;
//   * warp = (key group, column warp): a column warp owns three pairs of n8
//     tiles and keeps their sums in registers; the two key groups take the
//     two halves of every stage, and their sums meet once, in shared
//     memory, at the end of a pass;
//   * bf16: `mma.sync.m16n8k16` on A fragments from `ldmatrix` of P and B
//     fragments from `ldmatrix.trans` of the v stage (the products are exact
//     in f32, so only the order of the f32 sum differs from the plain
//     version);
//   * f32: 3xTF32 (`mma.sync.m16n8k8` on operands split by masking), which
//     keeps the f32 tolerance where one TF32 product does not;
//   * the grid is (row tiles x B x nh, column blocks): at short T a block
//     takes a slice of C (a multiple of 16 columns, chosen on the host from
//     the units, C and the SM count) so that the card has up to a block an
//     SM, and recomputes its 16 rows' scores and softmax (16*T*36 MACs
//     against 16*T*C / split for its share of the contraction).
// What bounds it on an H100: in f32 the three TF32 products and the v tiles
// every row block reads again from L2; in bf16 the scores and the per-stage
// waits (PERF.md).
#pragma once

#include <type_traits>

#include "rel_common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace zv;

constexpr int kWideRows = 16;  // rows a block: the mma's m
constexpr int kWideThreads = 512, kWideWarps = kWideThreads / 32;
constexpr int kWideGroups = 2;  // key groups: each warp takes half of every stage's keys
constexpr int kWideWarpsN = kWideWarps / kWideGroups;  // warps that split the columns
constexpr int kWidePairs = 3;  // pairs of n8 column tiles a warp owns
constexpr int kWideChunk = kWideWarpsN * kWidePairs * 16;  // columns a pass over the keys covers

// keys a stage of v holds: 64 (bf16) or 32 (f32), half of them for each
// key group; fewer, smaller stages measured slower (each stage costs a
// barrier and a wait, and the copies of a stage go out together)
__host__ __device__ constexpr int wide_keys(int elem) { return elem == 2 ? 64 : 32; }

struct WideArgs {
  const void *q, *kt, *pq, *pe, *v;
  const uint8_t* mask;
  void* out;
  int T, H, C, B, rows;
  Split split;  // the blocks' (row tile, b * nh + h) units and column blocks
  int cols;    // the most columns a block takes, a multiple of 16
  int sv;      // row stride of a v stage (elements), 8 mod 32
  int ps;      // row stride of the P tile (elements): 4 mod 32 (f32), 8 mod 32 (bf16)
  int p_off;   // byte offset of the P tile
  int bytes;
  int stages;  // stages of v in shared memory: 3, or 2 where 3 do not fit
  // B5 (kHeads): the heads the grid walks, which are also the heads of v's
  // and out's rows (B7: one, head 0), and the const-attention gate
  int nh, gate;
};

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Shared memory: [row tile | scores, then the v stages over them once the
// softmax is done] [P].  P has min(rows + 1, 16) rows (row `rows` is zero
// and stands in for the missing rows of a short tile).  The stages also
// take the key groups' partial sums at the end of a pass.
inline void wide_layout(WideArgs& a, int QD, int elem) {
  a.sv = round_up(a.cols < kWideChunk ? a.cols : kWideChunk, 32) + 8;
  a.ps = round_up(a.T, wide_keys(elem)) + (elem == 4 ? 4 : 8);  // keys up to Kp
  const size_t scores = ((size_t)a.rows * a.T + 3) & ~(size_t)3;
  const int tile = (int)((row_tile_floats(a.T, a.rows, QD) + scores) * sizeof(float));
  const int stages = a.stages * wide_keys(elem) * a.sv * elem;
  a.p_off = round_up(tile > stages ? tile : stages, 128);
  a.bytes = a.p_off + (a.rows < 16 ? a.rows + 1 : 16) * a.ps * elem;
}

// Tin: q, k, pq, pe and v; P is rounded to Tin; Tout: out.  kHeads (B5):
// every head and the gate, from a.nh and a.gate; B7 (!kHeads) takes head 0
// and no gate as constants, so that its code is that of one head alone.
template <int QD, typename Tin, typename Tout, bool kHeads>
__global__ void __launch_bounds__(kWideThreads, 1) rel_wide_consume_kernel(WideArgs a) {
  constexpr bool kBf16 = std::is_same<Tin, __nv_bfloat16>::value;
  constexpr int kElem = (int)sizeof(Tin), kKeys = wide_keys(kElem);
  const int nst = a.stages;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int T = a.T, rows = a.rows, C = a.C, nh = kHeads ? a.nh : 1;
  int unit, c_lo, c_hi;
  split_block(a.split, blockIdx.x, C, unit, c_lo, c_hi);
  const int BH = a.B * nh;
  const int tiles = (T + rows - 1) / rows, tile = unit / BH, bh = unit - tile * BH;
  const int b = bh / nh, h = bh - b * nh;
  float* qs = reinterpret_cast<float*>(base);
  float* pqs = qs + rows * QD;
  float* band = pqs + rows * kPD;
  float* S = band + (size_t)(T + rows - 1) * kPD;
  Tin* stg = reinterpret_cast<Tin*>(base);  // over the row tile, after the softmax
  Tin* P = reinterpret_cast<Tin*>(base + a.p_off);
  const int i0 = tile * rows;
  const int nrows = min(rows, T - i0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Kp = round_up(T, kKeys), ns = Kp / kKeys, sv = a.sv, ps = a.ps;
  // each row tile starts its walk over the keys at its own stage, so that
  // the tiles of one (b, h) do not all read the same rows of v at once
  const int rot = (int)((long long)tile * ns / tiles);
  // key j of (b, h): v row (b * T + j) * nh + h
  const int vstride = nh * C;
  const Tin* vb = static_cast<const Tin*>(a.v) + ((size_t)b * T * nh + h) * C;
  // 16-byte copies, or 8-byte ones where a bf16 row of v is 8-byte aligned only
  const bool wide = !kBf16 || C % 8 == 0;
  const int per = wide ? 16 / kElem : 4;  // elements a copy moves

  // stage s of a pass goes to buffer s % nst; keys past T are zero.
  // A thread's 16-byte copies are the same (key, column) slots in every
  // stage: their offsets are worked out once a pass.
  constexpr int kMaxU = 6;  // 16-byte copies a thread issues a stage: 64 x 48 / 512 (bf16)
  int u_key[kMaxU], u_smem[kMaxU], u_glob[kMaxU];
  int upr = 0, pass_c0 = 0;  // copies a key row; the pass's first column
  auto plan_pass = [&](int c0, int wc) {
    upr = wc / per;
    pass_c0 = c0;
#pragma unroll
    for (int i = 0; i < kMaxU; ++i) {
      const int u = threadIdx.x + i * kWideThreads, kk = u / upr, cu = u - kk * upr;
      u_key[i] = u < kKeys * upr ? kk : kKeys;  // kKeys: no copy
      u_smem[i] = kk * sv + cu * per;
      u_glob[i] = kk * vstride + c0 + cu * per;
    }
  };
  auto produce = [&](int s) {
    const int k0 = ((s + rot) % ns) * kKeys;
    Tin* dst = stg + (size_t)(s % nst) * kKeys * sv;
    const Tin* src = vb + (size_t)k0 * vstride;
    if (wide) {
#pragma unroll
      for (int i = 0; i < kMaxU; ++i) {
        if (u_key[i] < kKeys) {
          const bool valid = k0 + u_key[i] < T;
          cp_async16(dst + u_smem[i], valid ? src + u_glob[i] : vb, valid);
        }
      }
    } else {
      for (int u = threadIdx.x; u < kKeys * upr; u += kWideThreads) {
        const int kk = u / upr, cu = u - kk * upr;
        const bool valid = k0 + kk < T;
        cp_async8(dst + kk * sv + cu * per,
                  valid ? src + (size_t)kk * vstride + pass_c0 + cu * per : vb, valid);
      }
    }
    cp_async_commit();
  };
  // a pass's start: the columns of its last n16 tile past wc are zero in
  // every stage, then the first nst - 1 stages go out
  auto start_pass = [&](int c0) {
    const int wc = min(kWideChunk, c_hi - c0), wz = round_up(wc, 16) - wc;
    for (int i = threadIdx.x; i < nst * kKeys * wz; i += kWideThreads) {
      const int row = i / wz;
      stg[(size_t)row * sv + wc + (i - row * wz)] = from_f32<Tin>(0.f);
    }
    plan_pass(c0, wc);
    for (int s = 0; s < nst - 1; ++s) {
      if (s < ns)
        produce(s);
      else
        cp_async_commit();
    }
  };

  stage_row_tile<QD>(static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.pq),
                     static_cast<const Tin*>(a.pe), qs, pqs, band, b, h, T, a.H, i0, rows);
  __syncthreads();
  row_tile_scores<QD, Tin>(static_cast<const Tin*>(a.kt) + (size_t)bh * QD * T, a.mask, qs, pqs,
                           band, S, b, T, rows, nrows);
  __syncthreads();

  // softmax, one warp a row (B1's operations), into the P tile rounded to
  // v's dtype (with the const gate: round(1 / count(p > 0)) on the support
  // p > 0); keys T .. Kp-1 and the rows past the tile are zero
  const int prows = rows < 16 ? rows + 1 : 16;
  for (int r = warp; r < prows; r += kWideWarps) {
    Tin* prow_out = P + (size_t)r * ps;
    int j0 = 0;
    if (r < nrows) {
      float* prow = S + (size_t)r * T;
      float mx = -INFINITY;
      for (int j = lane; j < T; j += 32) mx = fmaxf(mx, prow[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float e = expf(prow[j] - mx);
        prow[j] = e;
        sum += e;
      }
      const float inv = 1.f / warp_sum(sum);
      if (kHeads && a.gate) {
        float cnt = 0.f;
        for (int j = lane; j < T; j += 32) cnt += prow[j] * inv > 0.f ? 1.f : 0.f;
        const Tin used = from_f32<Tin>(1.f / fmaxf(warp_sum(cnt), 1e-20f));
        for (int j = lane; j < T; j += 32)
          prow_out[j] = prow[j] * inv > 0.f ? used : from_f32<Tin>(0.f);
      } else {
        for (int j = lane; j < T; j += 32) prow_out[j] = from_f32<Tin>(prow[j] * inv);
      }
      j0 = T;
    }
    for (int j = j0 + lane; j < Kp; j += 32) prow_out[j] = from_f32<Tin>(0.f);
  }
  __syncthreads();  // P is complete; the row tile and the scores are dead

  // warp = (key group kg, column warp wn): wn owns pairs wn + 8i of n8
  // tiles; kg takes keys kg * kKeys / 2 .. of every stage
  const int wn = warp % kWideWarpsN, kg = warp / kWideWarpsN;
  const int g = lane >> 2, t = lane & 3, m = lane >> 3;
  auto prow_of = [&](int r) { return r < rows ? r : rows; };
  for (int c0 = c_lo; c0 < c_hi; c0 += kWideChunk) {
    const int wc = min(kWideChunk, c_hi - c0);
    start_pass(c0);

    // f32: the 3xTF32 big and small products in two sets of sums
    float acc[kWidePairs][2][4], acc2[kWidePairs][2][4];
#pragma unroll
    for (int i = 0; i < kWidePairs; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = acc2[i][n][e] = 0.f;

    for (int s = 0; s < ns; ++s) {
      if (nst == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // stage s has landed; stage s - 1's buffer is consumed
      if (s + nst - 1 < ns)
        produce(s + nst - 1);
      else
        cp_async_commit();
      const int kh = kg * (kKeys / 2);  // this key group's keys in the stage
      const Tin* vs = stg + (size_t)(s % nst) * kKeys * sv + kh * sv;
      const int k0 = ((s + rot) % ns) * kKeys + kh;
      if constexpr (kBf16) {
#pragma unroll
        for (int kq = 0; kq < kKeys / 2; kq += 16) {
          uint32_t af[4];
          ldmatrix_x4(af, P + (size_t)prow_of((lane & 7) + (m & 1) * 8) * ps + k0 + kq +
                              (m >> 1) * 8);
#pragma unroll
          for (int i = 0; i < kWidePairs; ++i) {
            const int n0 = 16 * (wn + kWideWarpsN * i);
            if (n0 < wc) {
              uint32_t bf[4];
              ldmatrix_x4_trans(
                  bf, vs + (kq + (lane & 7) + (m & 1) * 8) * sv + n0 + (m >> 1) * 8);
              mma_bf16_16816(acc[i][0], af, bf[0], bf[1]);
              mma_bf16_16816(acc[i][1], af, bf[2], bf[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kq = 0; kq < kKeys / 2; kq += 8) {
          const float* pr0 = P + (size_t)prow_of(g) * ps + k0 + kq + t;
          const float* pr1 = P + (size_t)prow_of(g + 8) * ps + k0 + kq + t;
          uint32_t ah[4], al[4];
          split_tf32(pr0[0], ah[0], al[0]);
          split_tf32(pr1[0], ah[1], al[1]);
          split_tf32(pr0[4], ah[2], al[2]);
          split_tf32(pr1[4], ah[3], al[3]);
#pragma unroll
          for (int i = 0; i < kWidePairs; ++i) {
            const int n0 = 16 * (wn + kWideWarpsN * i);
            if (n0 < wc) {
#pragma unroll
              for (int n = 0; n < 2; ++n) {
                const float* vk = vs + (kq + t) * sv + n0 + 8 * n + g;
                uint32_t bh0, bl0, bh1, bl1;
                split_tf32(vk[0], bh0, bl0);
                split_tf32(vk[4 * sv], bh1, bl1);
                mma_3xtf32(acc[i][n], acc2[i][n], ah, al, bh0, bh1, bl0, bl1);
              }
            }
          }
        }
      }
    }

    // key group 1 leaves its sums in the stages' memory, key group 0 adds
    // them and writes out rows i0 + g (+ 8), columns c0 + n0 + 8n + 2t (+1)
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the stages
    float* red = reinterpret_cast<float*>(stg);  // [16][sv]
#pragma unroll
    for (int i = 0; i < kWidePairs; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += acc2[i][n][e];
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < kWidePairs; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * (wn + kWideWarpsN * i) + 8 * n + 2 * t;
          if (col < wc)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(red + (g + 8 * hh) * sv + col) =
                  make_float2(acc[i][n][2 * hh], acc[i][n][2 * hh + 1]);
        }
    }
    __syncthreads();
    if (kg == 0) {
      Tout* out = static_cast<Tout*>(a.out) + ((size_t)b * T + i0) * vstride + (size_t)h * C + c0;
#pragma unroll
      for (int i = 0; i < kWidePairs; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * (wn + kWideWarpsN * i) + 8 * n + 2 * t;
          if (col < wc) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = g + 8 * hh;
              const float2 o = *reinterpret_cast<const float2*>(red + r * sv + col);
              const float x0 = acc[i][n][2 * hh] + o.x, x1 = acc[i][n][2 * hh + 1] + o.y;
              if (r < nrows) {
                if constexpr (std::is_same<Tout, __nv_bfloat16>::value)
                  *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * vstride + col) =
                      __floats2bfloat162_rn(x0, x1);
                else
                  *reinterpret_cast<float2*>(out + (size_t)r * vstride + col) =
                      make_float2(x0, x1);
              }
            }
          }
        }
    }
    __syncthreads();  // the sums are read before the next pass refills the stages
  }
}

template <int QD, typename Tin, typename Tout, bool kHeads>
int launch_wide_typed(WideArgs a, cudaStream_t stream) {
  const int max_smem = max_optin_smem(), sms = sm_count();
  const int elem = (int)sizeof(Tin);
  const int bh = a.B * (kHeads ? a.nh : 1);
  // the grid for `rows` rows a block (C split where the SMs would idle),
  // and its shared memory
  auto layout = [&](int rows, int stages) {
    WideArgs x = a;
    x.rows = rows;
    x.stages = stages;
    x.split = plan_split(bh * ((a.T + rows - 1) / rows), a.C, 16, sms);
    x.cols = x.split.w_main > x.split.w_tail ? x.split.w_main : x.split.w_tail;
    wide_layout(x, QD, elem);
    return x;
  };
  // 16 rows (the mma's m) with three stages, else two; fewer rows only
  // where a long T's score rows do not fit even so
  a = layout(kWideRows, 3);
  if (a.bytes > max_smem) {
    a = layout(fit_rows(kWideRows, max_smem,
                        [&](int r) { return (size_t)(layout(r, 2).bytes + 3) / 4; }),
               2);
    if (a.bytes > max_smem) return (int)cudaErrorInvalidValue;
  }
  auto kern = rel_wide_consume_kernel<QD, Tin, Tout, kHeads>;
  const cudaError_t e = allow_smem(kern, a.bytes);
  if (e != cudaSuccess) return (int)e;
  const int units = bh * ((a.T + a.rows - 1) / a.rows);
  kern<<<split_blocks(a.split, units), kWideThreads, a.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// QD dispatched, for Tin inputs, a Tout output and B5's heads (kHeads) or
// B7's head 0
template <typename Tin, typename Tout, bool kHeads>
int launch_wide(const WideArgs& a, int QD, int PD, void* stream) {
  if (PD != kPD || a.T <= 0 || a.H <= 0 || a.B <= 0 || a.C <= 0 || a.C % 4 != 0 ||
      (kHeads && a.nh <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (QD) {
    case 8: return launch_wide_typed<8, Tin, Tout, kHeads>(a, s);
    case 16: return launch_wide_typed<16, Tin, Tout, kHeads>(a, s);
    case 24: return launch_wide_typed<24, Tin, Tout, kHeads>(a, s);
    case 32: return launch_wide_typed<32, Tin, Tout, kHeads>(a, s);
    case 64: return launch_wide_typed<64, Tin, Tout, kHeads>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
