// Shared device code of the relative-position attention kernels B1, B4, B6
// and B5's narrow route (rel_probs.cuh), B3 (rel_apply_bwd.cu), B7 and B5's
// wide route (rel_wide_consume.cuh); B9 (conv_glu.cu) takes its type and
// copy helpers.
// The score of
// query row i against key j is
//
//   s[i,j] = q_i . k_j + pq_i . pe[j - i + T - 1]
//
// computed in f32.  A "row tile" is `rows` consecutive query rows of one
// (b, h) against every key: the block stages the rows' q and pq and the pe
// band they touch in shared memory, and each lane owns one key at a time
// with its k column in registers (k is read from the transpose kt, shape
// (B, H, QD, T), so lanes on neighbouring keys read neighbouring
// addresses).  The TPU kernels' band product + strided-rotate shear becomes
// a direct read of pe row j - i + T - 1 from the staged band.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace zv {

constexpr int kPD = 4;  // pos_head_dim of every published config
constexpr float kMaskBias = -1000.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive values as f32; p is 16-byte (f32) or 8-byte (bf16) aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]), b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float mask_bias(const uint8_t* mask, int b, int T, int j) {
  return (mask != nullptr && mask[(size_t)b * T + j]) ? kMaskBias : 0.f;
}

// Copy `count` values into shared memory with kBatch independent global
// loads in flight per thread: a plain load-then-store loop would wait one
// full memory latency per element.
template <int kBatch, typename Load, typename Store>
__device__ __forceinline__ void staged_copy(int count, Load load, Store store) {
  for (int base = threadIdx.x; base < count; base += kBatch * blockDim.x) {
    float tmp[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
      tmp[u] = idx < count ? load(idx) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < count) store(idx, tmp[u]);
    }
  }
}

// Floats of a row tile's staged inputs: q[rows*QD] | pq[rows*4] |
// band[(T+rows-1)*4]; every region stays 16-byte aligned (QD % 4 == 0).
__host__ __device__ inline size_t row_tile_floats(int T, int rows, int QD) {
  return (size_t)rows * QD + (size_t)rows * kPD + (size_t)(T + rows - 1) * kPD;
}

// Stage the q and pq rows i0 .. i0+rows-1 of (b, h) (rows past T are zero)
// and the pe band: pe row n = j - (i0 + r) + T - 1 lives at band index
// j - r + rows - 1.
template <int QD, typename Tin>
__device__ __forceinline__ void stage_row_tile(const Tin* __restrict__ q,
                                               const Tin* __restrict__ pq,
                                               const Tin* __restrict__ pe, float* qs,
                                               float* pqs, float* band, int b, int h,
                                               int T, int H, int i0, int rows) {
  const int nrows = min(rows, T - i0);
  staged_copy<4>(
      rows * QD,
      [&](int idx) {
        const int r = idx / QD, d = idx % QD;
        return r < nrows ? to_f32(q[((size_t)(b * T + i0 + r) * H + h) * QD + d]) : 0.f;
      },
      [&](int idx, float x) { qs[idx] = x; });
  staged_copy<1>(
      rows * kPD,
      [&](int idx) {
        const int r = idx / kPD, d = idx % kPD;
        return r < nrows ? to_f32(pq[((size_t)(b * T + i0 + r) * H + h) * kPD + d]) : 0.f;
      },
      [&](int idx, float x) { pqs[idx] = x; });
  const int n0 = T - 1 - i0 - (rows - 1);
  staged_copy<8>(
      (T + rows - 1) * kPD,
      [&](int idx) {
        const int n = n0 + idx / kPD, d = idx % kPD;
        return (n >= 0 && n < 2 * T - 1) ? to_f32(pe[((size_t)n * H + h) * kPD + d]) : 0.f;
      },
      [&](int idx, float x) { band[idx] = x; });
}

// scores[r*T + j] = s[i0 + r, j] + the key's mask bias for r < nrows and
// every key j: lane = key, k column in registers, q rows as shared-memory
// float4 broadcasts.  ktb is kt of this (b, h).
template <int QD, typename Tin>
__device__ __forceinline__ void row_tile_scores(const Tin* __restrict__ ktb,
                                                const uint8_t* __restrict__ mask,
                                                const float* qs, const float* pqs,
                                                const float* band, float* scores, int b,
                                                int T, int rows, int nrows) {
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const float4* pq4 = reinterpret_cast<const float4*>(pqs);
  const float4* band4 = reinterpret_cast<const float4*>(band);
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    float kr[QD];
#pragma unroll
    for (int d = 0; d < QD; ++d) kr[d] = to_f32(ktb[(size_t)d * T + j]);
    const float bias = mask_bias(mask, b, T, j);
    for (int r = 0; r < nrows; ++r) {
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < QD / 4; ++d4) {
        const float4 qv = q4[r * (QD / 4) + d4];
        s = fmaf(qv.x, kr[4 * d4], s);
        s = fmaf(qv.y, kr[4 * d4 + 1], s);
        s = fmaf(qv.z, kr[4 * d4 + 2], s);
        s = fmaf(qv.w, kr[4 * d4 + 3], s);
      }
      const float4 pv = pq4[r];
      const float4 ev = band4[j - r + rows - 1];
      s = fmaf(pv.x, ev.x, s);
      s = fmaf(pv.y, ev.y, s);
      s = fmaf(pv.z, ev.z, s);
      s = fmaf(pv.w, ev.w, s);
      scores[(size_t)r * T + j] = s + bias;
    }
  }
}

// The failsafe penalty's share of a score cotangent: pen * sign(s) where
// |s| > limit (pre-mask score).
__device__ __forceinline__ float penalty_term(float s, float pen, float limit) {
  return (pen != 0.f && fabsf(s) - limit > 0.f) ? copysignf(pen, s) : 0.f;
}

// Largest power-of-two row count <= start whose shared memory fits.
template <typename Floats>
inline int fit_rows(int start, int max_smem, Floats floats) {
  int rows = start;
  while (rows > 1 && floats(rows) * sizeof(float) > (size_t)max_smem) rows >>= 1;
  return rows;
}

inline int max_optin_smem() {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return max_smem;
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace zv
