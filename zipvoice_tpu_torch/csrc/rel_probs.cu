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
// What bounds it on an H100: the (B,H,T,T) output write is the only large
// stream (at B=2, H=4, T=1024 in f32: 32 MB, ~10 us at 3.35 TB/s), while the
// score arithmetic is (QD+PD) FMAs per element (~0.3 GFMA, ~10 us of the
// card's f32 FMA rate).  The two are close, so the design keeps the inner
// loop in registers rather than in shared memory:
//   * one block owns `rows` query rows of one (b,h) and every key;
//   * each lane owns one key: its k column (QD floats, read coalesced from
//     the transposed kt) sits in registers and is reused for all `rows`
//     queries, whose q/pq rows are staged in shared memory and read as
//     warp-wide float4 broadcasts;
//   * the TPU's band product + strided-rotate shear becomes a direct read of
//     pe row j - i + T - 1 from a shared-memory band that covers the block;
//   * the block's score rows stay in shared memory, so the softmax (one warp
//     per row, shuffle reductions) and the single coalesced write of the
//     probabilities touch device memory once.
// Any T is handled by masking the ragged edge in the kernel (no padding to a
// tile multiple, unlike the TPU's (8,128) tiling).  `rows` shrinks for long
// sequences so the score rows fit in shared memory.  The staging and score
// code is shared with B3 and B4 (rel_common.cuh).

#include "rel_common.cuh"

namespace {

using namespace zv;

constexpr int kWarps = 8;

// shared memory (floats): the row tile (rel_common.cuh) | scores[rows*T]
__host__ __device__ inline size_t smem_floats(int T, int rows, int QD) {
  return row_tile_floats(T, rows, QD) + (size_t)rows * T;
}

template <int QD, typename Tin, typename Tout>
__global__ void __launch_bounds__(kWarps * 32)
rel_probs_kernel(const Tin* __restrict__ q, const Tin* __restrict__ kt,
                 const Tin* __restrict__ pq, const Tin* __restrict__ pe,
                 const uint8_t* __restrict__ mask, Tout* __restrict__ out,
                 int T, int H, int rows) {
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
  row_tile_scores<QD, Tin, true>(kt + (size_t)bh * QD * T, mask, qs, pqs, band, scores, b,
                                 T, rows, nrows);
  __syncthreads();

  // softmax: one warp per row
  for (int r = warp; r < nrows; r += kWarps) {
    float* srow = scores + (size_t)r * T;
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    Tout* orow = out + ((size_t)bh * T + i0 + r) * T;
    for (int j = lane; j < T; j += 32) orow[j] = from_f32<Tout>(srow[j] * inv);
  }
}

template <int QD, typename Tin, typename Tout>
int launch_typed(const void* q, const void* kt, const void* pq, const void* pe,
                 const void* mask, void* out, int B, int T, int H,
                 cudaStream_t stream) {
  const int max_smem = max_optin_smem();
  // largest row count whose score rows fit; 16 keeps two blocks per SM at
  // T=1024, fewer rows are taken only for long sequences
  const int rows = fit_rows(16, max_smem, [&](int r) { return smem_floats(T, r, QD); });
  const size_t smem = smem_floats(T, rows, QD) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  auto kern = rel_probs_kernel<QD, Tin, Tout>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + rows - 1) / rows, B * H);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(kt), static_cast<const Tin*>(pq),
      static_cast<const Tin*>(pe), static_cast<const uint8_t*>(mask), static_cast<Tout*>(out),
      T, H, rows);
  return (int)cudaGetLastError();
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
