// Relative-position attention forwards with a fused probs @ V epilogue:
// B6, B7 and B5.
//
// Each replaces a TPU kernel of zipvoice_tpu/ops/attention.py that is B1's
// row tile (p = softmax_j(q_i.k_j + pq_i.pe[j-i+T-1] + bias_j), scores and
// softmax in f32) followed by a contraction with a value stream:
//
//   B6 `rel_attention_probs_consume` (body `_probs_consume_kernel`): writes
//      the probabilities (B,H,T,T) in the probs dtype and contracts the
//      ROUNDED values with v (B,T,H,VD): out = round(p) @ v, f32 sums, out
//      in v's dtype.  The probabilities equal B1's bit for bit.
//   B7 `rel_attention_head0_consume` (body `_head0_consume_kernel`): head 0
//      only; the probabilities, rounded to v's dtype, contract the wide gated
//      value stream v (B,T,C) (C = 384 fm_decoder, 144 text encoder); they
//      are never written.
//   B5 `_pallas_rel_apply` (body `_apply_kernel`, probabilities
//      `_apply_probs`): used = const_gate ? (p > 0) / count(p > 0) : p,
//      rounded to v's dtype, @ v (B,T,H,VD), out in out_dtype.  Its backward
//      is B3 (rel_apply_bwd.cu), whose recompute of the support p > 0 takes
//      the same f32 operations in the same order, so forward and backward
//      agree on which keys the const branch uses.
//
// What bounds them on an H100: B6 the (B,H,T,T) probabilities written
// (bytes); B7, and B5 at the head-0 width, the contraction on the f32 CUDA
// cores (2*T*C operations a query row; operations).  The design:
//   * a block owns `rows` query rows of one (b,h) (B7: of one b, head 0) and
//     every key, exactly as B1 (rel_common.cuh): the row tile is staged, the
//     scores go to shared memory, one warp a row takes the softmax and leaves
//     the rounded probabilities of every row in shared memory;
//   * the epilogue splits the contraction over (4-wide column group, key
//     slice) work items: the column groups are padded to a power of two
//     (12 wide: 4 groups, 64 key slices; 384 wide: 128 groups, 2 slices), a
//     thread reads float4s of v for kUnroll keys at once, the next kUnroll
//     in flight while it sums these (the memory latency, not the arithmetic,
//     set the first version's time), into rows x 4 f32 sums in registers
//     against shared-memory broadcasts of the probabilities; the slices of
//     one warp meet by shuffles, and the partial sums of the warps (or key
//     slices) add up in shared memory one after another, in a fixed order
//     (no atomics);
//   * a narrow V (VD <= 64) takes 256 threads a block, a wide one 512: the
//     wide contraction is latency-bound with one row tile a SM at B7's
//     serving shape, and more warps hide more of it;
//   * any T: the ragged row tile is masked, nothing is padded (the TPU
//     kernels pad T to 128 and the value width to 128 lanes).  VD must be a
//     multiple of 4 (vector loads of v).
// Tensor-core (mma) contractions are for a later version.

#include <type_traits>

#include "rel_common.cuh"

namespace {

using namespace zv;

// Threads a block: 256 for a narrow V; 512 for a wide one (VD > 64), whose
// contraction waits on memory with only one row tile a SM at serving
// shapes, and takes more warps to hide it (measured at B7's serving shape).
constexpr int kNarrow = 256, kWide = 512;
constexpr int kMaxRows = 16;
constexpr int kUnroll = 4;  // keys a thread loads at once in the epilogue

enum Mode { kProbsConsume, kHead0, kApply };

struct Args {
  const void *q, *kt, *pq, *pe, *v;
  const uint8_t* mask;
  void *probs, *out;
  int T, H, VD, rows, probs_bf16, out_bf16, const_gate;
};

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// The epilogue's column groups (VD / 4) padded to a power of two, at most
// one a thread; NT / group_pad key slices.
__host__ __device__ inline int group_pad(int VD, int NT) {
  int n = 1;
  while (n < VD / 4 && n < NT) n <<= 1;
  return n;
}

// shared memory (floats): the row tile | P[rows*T], the probabilities the
// epilogue contracts | out sums[rows*VD]
__host__ __device__ inline size_t smem_floats(int T, int rows, int QD, int VD) {
  return row_tile_floats(T, rows, QD) + round4((size_t)rows * T) + (size_t)rows * VD;
}

__device__ __forceinline__ float round_to(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(x)) : x;
}

__device__ __forceinline__ void store(void* dst, size_t i, float x, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(dst)[i] = x;
}

// One row tile of (b, h): kt slice `kslice` of kt; v and out rows of key /
// query j at ((b*T + j)*vH + vh)*VD.
template <int QD, typename Tin, int kMode, int NT>
__device__ __forceinline__ void consume_tile(const Args& a, int b, int h, int kslice, int vH,
                                             int vh) {
  constexpr int kInBf16 = std::is_same<Tin, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  const int T = a.T, rows = a.rows, VD = a.VD;
  float* qs = reinterpret_cast<float*>(smem4);
  float* pqs = qs + rows * QD;
  float* band = pqs + rows * kPD;
  float* P = band + (size_t)(T + rows - 1) * kPD;
  float* sums = P + round4((size_t)rows * T);
  const int i0 = blockIdx.x * rows;
  const int nrows = min(rows, T - i0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tin* q = static_cast<const Tin*>(a.q);
  const Tin* ktb = static_cast<const Tin*>(a.kt) + (size_t)kslice * QD * T;

  stage_row_tile<QD>(q, static_cast<const Tin*>(a.pq), static_cast<const Tin*>(a.pe), qs, pqs,
                     band, b, h, T, a.H, i0, rows);
  __syncthreads();
  row_tile_scores<QD, Tin, true>(ktb, a.mask, qs, pqs, band, P, b, T, rows, nrows);
  __syncthreads();

  // softmax, one warp a row (B1's operations), then the values the
  // epilogue contracts
  for (int r = warp; r < nrows; r += NT / 32) {
    float* prow = P + (size_t)r * T;
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
    if (kMode == kProbsConsume) {
      const size_t orow = ((size_t)(b * a.H + h) * T + i0 + r) * T;
      for (int j = lane; j < T; j += 32) {
        const float p = round_to(prow[j] * inv, a.probs_bf16);
        store(a.probs, orow + j, p, a.probs_bf16);
        prow[j] = p;
      }
    } else if (kMode == kApply && a.const_gate) {
      // the const-attention branch: the row-normalised support indicator
      float cnt = 0.f;
      for (int j = lane; j < T; j += 32) cnt += (prow[j] * inv > 0.f) ? 1.f : 0.f;
      const float used = round_to(1.f / fmaxf(warp_sum(cnt), 1e-20f), kInBf16);
      for (int j = lane; j < T; j += 32) prow[j] = (prow[j] * inv > 0.f) ? used : 0.f;
    } else {
      for (int j = lane; j < T; j += 32) prow[j] = round_to(prow[j] * inv, kInBf16);
    }
  }
  __syncthreads();

  // out rows = P @ v over (column group g, key slice sl) work items.  Each
  // row tile starts its walk over the keys at its own offset, so the tiles
  // of one (b, h) do not all read the same rows of v at once.
  const int NG = VD / 4, NGp = group_pad(VD, NT);
  const int slices = NT / NGp, sl = threadIdx.x / NGp;
  const int span = NGp > 32 ? NGp : 32;  // threads whose sums form one partial set
  const int rot = (int)((long long)blockIdx.x * T / gridDim.x);
  const size_t vstride = (size_t)vH * VD;
  const Tin* vb = static_cast<const Tin*>(a.v) + ((size_t)b * T * vH + vh) * VD;
  auto key = [&](int jj) { return jj + rot < T ? jj + rot : jj + rot - T; };
  for (int g0 = 0; g0 < NG; g0 += NGp) {
    const int g = g0 + threadIdx.x % NGp;
    float4 acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < NG) {
      // kUnroll keys' loads in flight, the next batch loaded while this one
      // is summed
      const Tin* vg = vb + 4 * g;
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = sl + u * slices;
        x[u] = jj < T ? load4(vg + (size_t)key(jj) * vstride) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int jj0 = sl; jj0 < T; jj0 += kUnroll * slices) {
        float4 nx[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jj = jj0 + (kUnroll + u) * slices;
          nx[u] = jj < T ? load4(vg + (size_t)key(jj) * vstride)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int jj = jj0 + u * slices;
          if (jj < T) {
            const float* pj = P + key(jj);
#pragma unroll
            for (int r = 0; r < kMaxRows; ++r) {
              if (r < nrows) {
                const float p = pj[(size_t)r * T];
                acc[r].x = fmaf(p, x[u].x, acc[r].x);
                acc[r].y = fmaf(p, x[u].y, acc[r].y);
                acc[r].z = fmaf(p, x[u].z, acc[r].z);
                acc[r].w = fmaf(p, x[u].w, acc[r].w);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x[u] = nx[u];
      }
    }
    // the key slices within a warp meet by shuffles (column groups < 32)
    for (int off = NGp; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < nrows) {
          acc[r].x += __shfl_xor_sync(0xffffffffu, acc[r].x, off);
          acc[r].y += __shfl_xor_sync(0xffffffffu, acc[r].y, off);
          acc[r].z += __shfl_xor_sync(0xffffffffu, acc[r].z, off);
          acc[r].w += __shfl_xor_sync(0xffffffffu, acc[r].w, off);
        }
      }
    }
    // then the partial sets (a warp each, or a key slice each) add into the
    // sums one after another, in a fixed order
    const bool holder = g < NG && threadIdx.x % span < NGp;
    for (int st = 0; st < NT / span; ++st) {
      if (holder && threadIdx.x / span == st) {
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < nrows) {
            float4* s4 = reinterpret_cast<float4*>(sums + (size_t)r * VD + 4 * g);
            if (st > 0) {
              const float4 o = *s4;
              acc[r] = make_float4(o.x + acc[r].x, o.y + acc[r].y, o.z + acc[r].z,
                                   o.w + acc[r].w);
            }
            *s4 = acc[r];
          }
        }
      }
      __syncthreads();
    }
  }
  for (int o = threadIdx.x; o < nrows * VD; o += blockDim.x) {
    const int r = o / VD, d = o - r * VD;
    store(a.out, ((size_t)(b * T + i0 + r) * vH + vh) * VD + d, sums[o], a.out_bf16);
  }
}

// B6: grid (row tiles, B*H)
template <int QD, typename Tin, int NT>
__global__ void __launch_bounds__(NT) rel_probs_consume_kernel(Args a) {
  const int bh = blockIdx.y;
  consume_tile<QD, Tin, kProbsConsume, NT>(a, bh / a.H, bh % a.H, bh, a.H, bh % a.H);
}

// B7: grid (row tiles, B); kt holds head 0 only, (B, QD, T)
template <int QD, typename Tin, int NT>
__global__ void __launch_bounds__(NT) rel_head0_consume_kernel(Args a) {
  const int b = blockIdx.y;
  consume_tile<QD, Tin, kHead0, NT>(a, b, 0, b, 1, 0);
}

// B5: grid (row tiles, B*H)
template <int QD, typename Tin, int NT>
__global__ void __launch_bounds__(NT) rel_apply_kernel(Args a) {
  const int bh = blockIdx.y;
  consume_tile<QD, Tin, kApply, NT>(a, bh / a.H, bh % a.H, bh, a.H, bh % a.H);
}

template <int QD, typename Tin, int NT>
int launch_typed(int mode, Args a, int grid_y, cudaStream_t stream) {
  const int max_smem = max_optin_smem();
  // 16 rows as B1; fewer only where a long T's score rows do not fit
  a.rows = fit_rows(kMaxRows, max_smem, [&](int r) { return smem_floats(a.T, r, QD, a.VD); });
  const size_t smem = smem_floats(a.T, a.rows, QD, a.VD) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  auto kern = mode == kProbsConsume ? rel_probs_consume_kernel<QD, Tin, NT>
              : mode == kHead0      ? rel_head0_consume_kernel<QD, Tin, NT>
                                    : rel_apply_kernel<QD, Tin, NT>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((a.T + a.rows - 1) / a.rows, grid_y), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch(int mode, const Args& a, int grid_y, int QD, int PD, int bf16, void* stream) {
  if (PD != kPD || a.T <= 0 || a.H <= 0 || grid_y <= 0 || a.VD <= 0 || a.VD % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = a.VD > 64;
#define ZV_LAUNCH(QDV)                                                                  \
  if (bf16)                                                                             \
    return wide ? launch_typed<QDV, __nv_bfloat16, kWide>(mode, a, grid_y, s)           \
                : launch_typed<QDV, __nv_bfloat16, kNarrow>(mode, a, grid_y, s);        \
  return wide ? launch_typed<QDV, float, kWide>(mode, a, grid_y, s)                     \
              : launch_typed<QDV, float, kNarrow>(mode, a, grid_y, s)
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

}  // namespace

// Plain C entry points (loaded through ctypes).  Each returns a cudaError_t
// code: 0 on a clean launch; cudaErrorInvalidValue for a shape the kernels
// do not take (QD not instantiated, PD != 4, VD not a multiple of 4, T too
// long for shared memory).  q, pq: (B,T,H,QD/PD); pe: (2T-1,H,PD); mask:
// (B,T) uint8 or null; bf16: q, k, pq, pe and v are bf16 (else f32).

// B6: kt (B,H,QD,T); v (B,T,H,VD); probs (B,H,T,T) in bf16 if probs_bf16;
// out (B,T,H,VD) in v's dtype.
extern "C" int zv_rel_probs_consume(const void* q, const void* kt, const void* pq, const void* pe,
                                    const void* mask, const void* v, void* probs, void* out,
                                    int B, int T, int H, int QD, int PD, int VD, int bf16,
                                    int probs_bf16, void* stream) {
  const Args a{q, kt, pq, pe, v, static_cast<const uint8_t*>(mask), probs, out,
               T, H, VD, 0, probs_bf16, bf16, 0};
  return launch(kProbsConsume, a, B * H, QD, PD, bf16, stream);
}

// B7: kt0 (B,QD,T), head 0's keys; v (B,T,C); out (B,T,C) in v's dtype.
extern "C" int zv_rel_head0_consume(const void* q, const void* kt0, const void* pq,
                                    const void* pe, const void* mask, const void* v, void* out,
                                    int B, int T, int H, int QD, int PD, int C, int bf16,
                                    void* stream) {
  const Args a{q, kt0, pq, pe, v, static_cast<const uint8_t*>(mask), nullptr, out,
               T, H, C, 0, 0, bf16, 0};
  return launch(kHead0, a, B, QD, PD, bf16, stream);
}

// B5: kt (B,H,QD,T); v (B,T,H,VD); out (B,T,H,VD) in bf16 if out_bf16.
extern "C" int zv_rel_apply(const void* q, const void* kt, const void* pq, const void* pe,
                            const void* mask, const void* v, void* out, int B, int T, int H,
                            int QD, int PD, int VD, int bf16, int out_bf16, int const_gate,
                            void* stream) {
  const Args a{q, kt, pq, pe, v, static_cast<const uint8_t*>(mask), nullptr, out,
               T, H, VD, 0, 0, out_bf16, const_gate};
  return launch(kApply, a, B * H, QD, PD, bf16, stream);
}
