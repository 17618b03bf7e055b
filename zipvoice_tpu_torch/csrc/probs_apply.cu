// Attention probabilities @ values for the Zipformer SelfAttention (B2).
//
// Replaces the TPU kernel zipvoice_tpu/ops/attention.py `_pallas_probs_apply`
// (body `_probs_apply_kernel`):
//
//   out[b,t,h,:] = sum_s probs[b,h,t,s] * v[b,s,h,:]      (f32 accumulation)
//
// probs: (B,H,T,T); v: (B,T,H,VD) of the same dtype (f32 or bf16); out:
// (B,T,H,VD) in that dtype.
//
// What bounds it on an H100: reading probs (B*H*T*T elements) is the whole
// cost; with VD = 12 there are only 12 FMAs per probability, far below the
// card's ridge point, so it is a bandwidth-bound streaming pass.  The TPU
// version padded VD to 128 lanes for its matrix unit; here nothing is padded:
//   * a block owns kRows query rows of one (b,h) (kRowsPerWarp rows a warp);
//   * the block stages v for a chunk of keys in shared memory (row stride
//     VD+1 so lanes on neighbouring keys hit distinct banks);
//   * lanes walk the keys, so every probs row is read with coalesced loads,
//     kUnroll keys at a time to keep enough loads in flight, and each lane
//     keeps kRowsPerWarp x VD f32 partial sums in registers;
//   * a shuffle reduction ends each row, and the lane whose index is the
//     output column writes it.
// Every row of every (b,h) is written for any T: the grid covers
// ceil(T / kRows) row blocks and the ragged edge is masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kChunk = 256;  // keys staged per pass
constexpr int kUnroll = 4;   // keys a lane loads per step (32 apart)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

template <int VD, typename T>
__global__ void __launch_bounds__(kWarps * 32)
probs_apply_kernel(const T* __restrict__ probs, const T* __restrict__ v,
                   T* __restrict__ out, int Tn, int H) {
  __shared__ float vs[kChunk * (VD + 1)];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kRows + warp * kRowsPerWarp;

  float acc[kRowsPerWarp][VD];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int d = 0; d < VD; ++d) acc[r][d] = 0.f;

  for (int s0 = 0; s0 < Tn; s0 += kChunk) {
    const int n = min(kChunk, Tn - s0);
    __syncthreads();  // the previous chunk is consumed
    staged_copy<8>(
        n * VD,
        [&](int idx) {
          const int s = idx / VD, d = idx % VD;
          return to_f32(v[((size_t)(b * Tn + s0 + s) * H + h) * VD + d]);
        },
        [&](int idx, float x) { vs[(idx / VD) * (VD + 1) + idx % VD] = x; });
    __syncthreads();
    for (int s = lane; s < n; s += 32 * kUnroll) {
      // issue every probs load of this step before the first FMA, so that
      // kUnroll * kRowsPerWarp loads a lane are in flight together
      float p[kUnroll][kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int ss = s + 32 * u, t = t0 + r;
          p[u][r] = (ss < n && t < Tn) ? to_f32(probs[((size_t)bh * Tn + t) * Tn + s0 + ss])
                                       : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ss = s + 32 * u;
        if (ss < n) {
          float vv[VD];
#pragma unroll
          for (int d = 0; d < VD; ++d) vv[d] = vs[ss * (VD + 1) + d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
            for (int d = 0; d < VD; ++d) acc[r][d] = fmaf(p[u][r], vv[d], acc[r][d]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + r;
#pragma unroll
    for (int d = 0; d < VD; ++d) {
      float x = acc[r][d];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (t < Tn && lane == d) out[((size_t)(b * Tn + t) * H + h) * VD + d] = from_f32<T>(x);
    }
  }
}

template <int VD, typename T>
int launch_typed(const void* probs, const void* v, void* out, int B, int Tn, int H,
                 cudaStream_t stream) {
  dim3 grid((Tn + kRows - 1) / kRows, B * H);
  probs_apply_kernel<VD, T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(probs), static_cast<const T*>(v), static_cast<T*>(out), Tn, H);
  return (int)cudaGetLastError();
}

template <int VD>
int launch_vd(const void* probs, const void* v, void* out, int B, int Tn, int H, int bf16,
              cudaStream_t s) {
  if (bf16) return launch_typed<VD, __nv_bfloat16>(probs, v, out, B, Tn, H, s);
  return launch_typed<VD, float>(probs, v, out, B, Tn, H, s);
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch, cudaErrorInvalidValue for a VD not instantiated.
extern "C" int zv_probs_apply(const void* probs, const void* v, void* out, int B, int Tn,
                              int H, int VD, int bf16, void* stream) {
  if (B <= 0 || Tn <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (VD) {
    case 4: return launch_vd<4>(probs, v, out, B, Tn, H, bf16, s);
    case 8: return launch_vd<8>(probs, v, out, B, Tn, H, bf16, s);
    case 12: return launch_vd<12>(probs, v, out, B, Tn, H, bf16, s);
    case 16: return launch_vd<16>(probs, v, out, B, Tn, H, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
