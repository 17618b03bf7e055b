// Score cotangent of the relative-position attention probabilities (B4).
//
// Replaces the TPU kernel zipvoice_tpu/ops/attention.py `_pallas_rel_ds`
// (body `_bwd_kernel`): the backward of B1 with the probabilities
// recomputed rather than read back,
//
//   p[i,:]  = softmax_j( s[i,j] + bias_j ),  s = q_i.k_j + pq_i.pe[j-i+T-1]
//   ds[i,j] = p[i,j] * (g[i,j] - sum_j' g[i,j'] p[i,j'])
//             + pen * sign(s[i,j]) * (|s[i,j]| > limit)
//
// The penalty (the attention-score failsafe, pen = gate * 1e-4) acts on the
// pre-mask score of every key, padded ones included.  q: (B,T,H,QD); kt:
// (B,H,QD,T); pq: (B,T,H,4); pe: (2T-1,H,4); mask: (B,T) uint8 or null;
// g, ds: (B,H,T,T); all tensors f32 or all bf16.
//
// What bounds it on an H100: reading g and writing ds, two (B,H,T,T)
// streams (at B=8, H=4, T=1024 in bf16: 134 MB, ~40 us at 3.35 TB/s); the
// score recompute is the same (QD+4) FMAs per element as B1.  The design is
// B1's (rel_common.cuh): a block owns `rows` query rows of one (b,h) and
// every key, recomputes the pre-mask scores into shared memory, and then
// one warp per row takes the softmax statistics, the row sum of g*p and
// writes ds, so g is read and ds written once with coalesced accesses (g's
// row is read a second time from cache).  Any T; no padding.

#include "rel_common.cuh"

namespace {

using namespace zv;

constexpr int kWarps = 8;

__host__ __device__ inline size_t smem_floats(int T, int rows, int QD) {
  return row_tile_floats(T, rows, QD) + (size_t)rows * T;
}

template <int QD, typename Tin>
__global__ void __launch_bounds__(kWarps * 32)
rel_ds_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
              const Tin* __restrict__ pq, const Tin* __restrict__ pe,
              const uint8_t* __restrict__ mask, const Tin* __restrict__ g,
              Tin* __restrict__ ds, int T, int H, int rows, float pen, float limit) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* pqs = qs + rows * QD;
  float* band = pqs + rows * kPD;
  float* scores = band + (size_t)(T + rows - 1) * kPD;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int i0 = blockIdx.x * rows;
  const int nrows = min(rows, T - i0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage_row_tile<QD>(q, pq, pe, qs, pqs, band, b, h, T, H, i0, rows);
  __syncthreads();
  row_tile_scores<QD, Tin, false>(kt + (size_t)bh * QD * T, mask, qs, pqs, band, scores, b,
                                  T, rows, nrows);
  __syncthreads();

  for (int r = warp; r < nrows; r += kWarps) {
    const float* srow = scores + (size_t)r * T;
    const size_t off = ((size_t)bh * T + i0 + r) * T;
    float mx, inv;
    row_softmax_stats(srow, mask, b, T, &mx, &inv);
    float dot = 0.f;
    for (int j = lane; j < T; j += 32)
      dot += expf(srow[j] + mask_bias(mask, b, T, j) - mx) * inv * to_f32(g[off + j]);
    dot = warp_sum(dot);
    for (int j = lane; j < T; j += 32) {
      const float s = srow[j];
      const float p = expf(s + mask_bias(mask, b, T, j) - mx) * inv;
      ds[off + j] = from_f32<Tin>(p * (to_f32(g[off + j]) - dot) + penalty_term(s, pen, limit));
    }
  }
}

template <int QD, typename Tin>
int launch_typed(const void* q, const void* kt, const void* pq, const void* pe,
                 const void* mask, const void* g, void* ds, int B, int T, int H, float pen,
                 float limit, cudaStream_t stream) {
  const int max_smem = max_optin_smem();
  const int rows = fit_rows(16, max_smem, [&](int r) { return smem_floats(T, r, QD); });
  const size_t smem = smem_floats(T, rows, QD) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  auto kern = rel_ds_kernel<QD, Tin>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + rows - 1) / rows, B * H);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(kt), static_cast<const Tin*>(pq),
      static_cast<const Tin*>(pe), static_cast<const uint8_t*>(mask),
      static_cast<const Tin*>(g), static_cast<Tin*>(ds), T, H, rows, pen, limit);
  return (int)cudaGetLastError();
}

template <int QD>
int launch_qd(const void* q, const void* kt, const void* pq, const void* pe, const void* mask,
              const void* g, void* ds, int B, int T, int H, int bf16, float pen, float limit,
              cudaStream_t s) {
  if (bf16)
    return launch_typed<QD, __nv_bfloat16>(q, kt, pq, pe, mask, g, ds, B, T, H, pen, limit, s);
  return launch_typed<QD, float>(q, kt, pq, pe, mask, g, ds, B, T, H, pen, limit, s);
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (QD not instantiated, PD != 4, T too long for shared memory).
extern "C" int zv_rel_ds(const void* q, const void* kt, const void* pq, const void* pe,
                         const void* mask, const void* g, void* ds, int B, int T, int H,
                         int QD, int PD, int bf16, float pen, float limit, void* stream) {
  if (PD != kPD || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (QD) {
    case 8: return launch_qd<8>(q, kt, pq, pe, mask, g, ds, B, T, H, bf16, pen, limit, s);
    case 16: return launch_qd<16>(q, kt, pq, pe, mask, g, ds, B, T, H, bf16, pen, limit, s);
    case 24: return launch_qd<24>(q, kt, pq, pe, mask, g, ds, B, T, H, bf16, pen, limit, s);
    case 32: return launch_qd<32>(q, kt, pq, pe, mask, g, ds, B, T, H, bf16, pen, limit, s);
    case 64: return launch_qd<64>(q, kt, pq, pe, mask, g, ds, B, T, H, bf16, pen, limit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
