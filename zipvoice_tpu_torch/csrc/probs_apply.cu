// Attention probabilities @ values for the Zipformer SelfAttention (B2).
//
// Replaces the TPU kernel zipvoice_tpu/ops/attention.py `_pallas_probs_apply`
// (body `_probs_apply_kernel`):
//
//   out[b,t,h,:] = sum_s probs[b,h,t,s] * v[b,s,h,:]      (f32 accumulation)
//
// probs: (B,H,Tq,Tk); v: (B,Tk,H,VD) of the same dtype (f32 or bf16), VD in
// {4, 8, 12, 16}; out: (B,Tq,H,VD) in that dtype.  The model's probabilities
// are square (Tq = Tk = T); the sequence-parallel sampler contracts a block
// of query rows against every key (Tq < Tk).
//
// What bounds it on an H100: reading probs (B*H*T*T elements) is the whole
// cost (12 FMAs a probability at VD = 12, far below the card's ridge point),
// so the design is a stream at full width:
//   * every lane loads probs in 16-byte vectors (4 f32 or 8 bf16 keys), the
//     lanes of a row on neighbouring addresses, and a warp issues 4 (f32)
//     or 8 (bf16) such segments of each of its rows before it computes, so
//     that enough bytes are in flight; the first ones go out before v is
//     staged;
//   * a block owns 16 * RT query rows of one (b,h) (64 where the grid still
//     fills the card) and stages v of up to 1024 (f32) or 2048 (bf16) keys
//     once for all of them, transposed to [VD][keys] so that a lane reads
//     the values of its keys as one 16-byte vector; the block's 8 warps
//     split the keys and their partial sums meet in shared memory in a
//     fixed order;
//   * f32 stays on the CUDA cores (no TF32): a lane owns 4 rows x 4 keys a
//     segment and VD sums a row in registers, 16 FMAs a shared-memory load;
//   * bf16 goes to the tensor cores: `mma.sync.m16n8k16` with bf16 inputs
//     and f32 accumulation.  A warp owns a 16-row tile; the A fragments come
//     straight from the 16-byte probs loads.  The k order inside an mma is
//     free (the products are exact in f32), so a lane's 8 consecutive keys
//     fill its 4 A slots of two consecutive mmas, and the B fragments (v,
//     columns padded to 8 or 16) are read with the same key permutation as
//     one 16-byte vector of the transposed v.
// Any Tq, Tk: rows past Tq are masked, keys past Tk are zero in both
// operands; the 16-byte path needs rows aligned to 16 bytes (Tk % 4 == 0 in
// f32, Tk % 8 == 0 in bf16), other Tk load element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// keys of v staged at a time: f32 1024 (VD x 4 KB), bf16 2048 (64 KB), so
// that the serving buckets up to T = 2048 stage v once in bf16
constexpr int kChunkF = 1024, kChunkH = 2048;
constexpr int kSeg = 32;               // keys of one row that a warp load covers
constexpr int kStrideF = kChunkF + 4;  // f32 row stride of the transposed v
// bf16 row stride: 4160 bytes = 64 mod 128, so the two rows a phase of 8
// lanes reads sit on disjoint banks
constexpr int kStrideH = kChunkH + 32;
constexpr int kUnrollF = 4;  // f32 segments a warp loads at once (4 rows a lane)
constexpr int kUnrollH = 8;  // bf16 segments (2 rows a lane)
constexpr int kRedFloats = kWarps * 16 * 16;  // each warp's 16 x 16 partial sums

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// D += A B for one m16n8k16 tile, bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage v of keys c0 .. c0+nkeys-1 of (b, h), of Tk keys, transposed:
// vt[d * stride + s].  Keys n .. nkeys-1 (past Tk) are zero.  Four values of a key are one load
// (16 bytes in f32, 8 in bf16; VD is a multiple of 4), kBatch loads in
// flight a thread.
template <int VD, typename T>
__device__ __forceinline__ void stage_vt(const T* __restrict__ v, T* vt, int stride, int b,
                                         int h, int Tk, int H, int c0, int n, int nkeys) {
  constexpr int kQuads = VD / 4, kBatch = 8;
  using Quad = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;
  const int units = nkeys * kQuads;
  for (int base = threadIdx.x; base < units; base += kBatch * kThreads) {
    Quad tmp[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      const int s = idx / kQuads, q = idx % kQuads;
      tmp[u] = Quad{};
      if (idx < units && s < n)
        tmp[u] = *reinterpret_cast<const Quad*>(v + ((size_t)(b * Tk + c0 + s) * H + h) * VD +
                                                4 * q);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < units) {
        const int s = idx / kQuads, q = idx % kQuads;
        const T* x = reinterpret_cast<const T*>(&tmp[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i) vt[(4 * q + i) * stride + s] = x[i];
      }
    }
  }
}

// The block's rows (of Tq) from the warps' partial sums: red[warp][row][col],
// warp = split * RT + row tile; the key splits are added in a fixed order.
template <int VD, typename T>
__device__ __forceinline__ void write_rows(const float* red, T* __restrict__ out, int b, int h,
                                           int Tq, int H, int RT) {
  const int KS = kWarps / RT;
  const int t0 = blockIdx.x * 16 * RT;
  for (int idx = threadIdx.x; idx < RT * 16 * VD; idx += kThreads) {
    const int row = idx / VD, d = idx % VD;
    const int rt = row / 16, rr = row % 16;
    float x = 0.f;
    for (int s = 0; s < KS; ++s) x += red[(s * RT + rt) * 256 + rr * 16 + d];
    const int t = t0 + row;
    if (t < Tq) out[((size_t)(b * Tq + t) * H + h) * VD + d] = from_f32<T>(x);
  }
}

// f32: lane = (row quad rq, key lane kc); a segment is 32 keys, 4 per lane.
template <bool kVec>
__device__ __forceinline__ void load_f32(float4 (&p)[kUnrollF][4], const float* const (&prow)[4],
                                         const bool (&rok)[4], int c0, int n, int s0, int kc) {
#pragma unroll
  for (int u = 0; u < kUnrollF; ++u)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = (s0 + u) * kSeg + 4 * kc;
      const float* src = prow[r] + c0 + key;
      if (kVec) {
        p[u][r] = (rok[r] && key < n) ? *reinterpret_cast<const float4*>(src)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = (rok[r] && key + i < n) ? src[i] : 0.f;
        p[u][r] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
}

template <int VD, bool kVec>
__global__ void __launch_bounds__(kThreads)
probs_apply_f32(const float* __restrict__ probs, const float* __restrict__ v,
                float* __restrict__ out, int Tq, int Tk, int H, int RT) {
  extern __shared__ float4 smem4[];
  float* vt = reinterpret_cast<float*>(smem4);  // [VD][kStrideF]
  float* red = vt + VD * kStrideF;              // [kWarps][16][16]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rt = warp % RT, split = warp / RT, KS = kWarps / RT;
  const int rq = lane >> 3, kc = lane & 7;
  const int trow = blockIdx.x * 16 * RT + rt * 16 + rq * 4;
  const float* prow[4];
  bool rok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rok[r] = trow + r < Tq;
    prow[r] = probs + ((size_t)bh * Tq + (rok[r] ? trow + r : 0)) * Tk;
  }
  float acc[4][VD];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int d = 0; d < VD; ++d) acc[r][d] = 0.f;

  float4 p[kUnrollF][4];
  for (int c0 = 0; c0 < Tk; c0 += kChunkF) {
    const int n = min(kChunkF, Tk - c0);
    const int nseg = (n + kSeg - 1) / kSeg;
    int s0 = split * kUnrollF;
    load_f32<kVec>(p, prow, rok, c0, n, s0, kc);  // in flight while v is staged
    __syncthreads();  // the previous chunk's v is consumed
    stage_vt<VD>(v, vt, kStrideF, b, h, Tk, H, c0, n, nseg * kSeg);
    __syncthreads();
    while (s0 < nseg) {
#pragma unroll
      for (int u = 0; u < kUnrollF; ++u) {
        if (s0 + u < nseg) {  // the same for the whole warp
          const float* vk = vt + (s0 + u) * kSeg + 4 * kc;
#pragma unroll
          for (int d = 0; d < VD; ++d) {
            const float4 w = *reinterpret_cast<const float4*>(vk + d * kStrideF);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][d] = fmaf(p[u][r].x, w.x, acc[r][d]);
              acc[r][d] = fmaf(p[u][r].y, w.y, acc[r][d]);
              acc[r][d] = fmaf(p[u][r].z, w.z, acc[r][d]);
              acc[r][d] = fmaf(p[u][r].w, w.w, acc[r][d]);
            }
          }
        }
      }
      s0 += KS * kUnrollF;
      if (s0 < nseg) load_f32<kVec>(p, prow, rok, c0, n, s0, kc);
    }
  }

  // the 8 key lanes of a row quad meet by shuffles; lane kc keeps the
  // columns d = kc mod 8
  float* mine = red + warp * 256;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int d = 0; d < VD; ++d) {
      float x = acc[r][d];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      if (d % 8 == kc) mine[(rq * 4 + r) * 16 + d] = x;
    }
  __syncthreads();
  write_rows<VD>(red, out, b, h, Tq, H, RT);
}

// bf16: lane = (group g, thread-in-group c) of the mma fragments; a warp's
// rows are g and g + 8 of its 16-row tile, a segment is 32 keys, 8 per lane.
template <bool kVec>
__device__ __forceinline__ void load_bf16(uint4 (&p)[kUnrollH][2],
                                          const __nv_bfloat16* const (&prow)[2],
                                          const bool (&rok)[2], int c0, int n, int s0, int c) {
#pragma unroll
  for (int u = 0; u < kUnrollH; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = (s0 + u) * kSeg + 8 * c;
      const __nv_bfloat16* src = prow[r] + c0 + key;
      if (kVec) {
        p[u][r] = (rok[r] && key < n) ? *reinterpret_cast<const uint4*>(src)
                                      : make_uint4(0u, 0u, 0u, 0u);
      } else {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = (rok[r] && key + 2 * i < n) ? s16[2 * i] : 0u;
          const uint32_t hi = (rok[r] && key + 2 * i + 1 < n) ? s16[2 * i + 1] : 0u;
          w[i] = lo | (hi << 16);
        }
        p[u][r] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
}

// two blocks an SM (at most 128 registers): a second block's loads hide the
// first one's staging, and T = 1152 (144 row blocks) runs in one wave
template <int VD, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
probs_apply_bf16(const __nv_bfloat16* __restrict__ probs, const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int Tq, int Tk, int H, int RT) {
  constexpr int NT = VD > 8 ? 2 : 1;  // n tiles of 8 output columns
  extern __shared__ float4 smem4[];
  // [16][kStrideH]: rows d >= VD are never written; they only feed output
  // columns that are not stored
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(smem4);
  float* red = reinterpret_cast<float*>(vt + 16 * kStrideH);  // [kWarps][16][16]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rt = warp % RT, split = warp / RT, KS = kWarps / RT;
  const int g = lane >> 2, c = lane & 3;
  const int trow = blockIdx.x * 16 * RT + rt * 16 + g;
  const __nv_bfloat16* prow[2];
  bool rok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rok[r] = trow + 8 * r < Tq;
    prow[r] = probs + ((size_t)bh * Tq + (rok[r] ? trow + 8 * r : 0)) * Tk;
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  uint4 p[kUnrollH][2];
  for (int c0 = 0; c0 < Tk; c0 += kChunkH) {
    const int n = min(kChunkH, Tk - c0);
    const int nseg = (n + kSeg - 1) / kSeg;
    int s0 = split * kUnrollH;
    load_bf16<kVec>(p, prow, rok, c0, n, s0, c);  // in flight while v is staged
    __syncthreads();
    stage_vt<VD>(v, vt, kStrideH, b, h, Tk, H, c0, n, nseg * kSeg);
    __syncthreads();
    while (s0 < nseg) {
#pragma unroll
      for (int u = 0; u < kUnrollH; ++u) {
        if (s0 + u < nseg) {  // the same for the whole warp
          // keys 8c .. 8c+7 of the segment: (8c, 8c+1 | 8c+2, 8c+3) fill the
          // A slots (2c, 2c+1 | 2c+8, 2c+9) of the first mma, 8c+4 .. 8c+7
          // those of the second; rows g (a0, a2) and g+8 (a1, a3)
          const uint32_t a0[4] = {p[u][0].x, p[u][1].x, p[u][0].y, p[u][1].y};
          const uint32_t a1[4] = {p[u][0].z, p[u][1].z, p[u][0].w, p[u][1].w};
          const __nv_bfloat16* vk = vt + (s0 + u) * kSeg + 8 * c;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // column n = nt*8 + g, the same 8 keys in the same slots
            const uint4 bv = *reinterpret_cast<const uint4*>(vk + (nt * 8 + g) * kStrideH);
            const uint32_t b0[2] = {bv.x, bv.y}, b1[2] = {bv.z, bv.w};
            mma_bf16(acc[nt], a0, b0);
            mma_bf16(acc[nt], a1, b1);
          }
        }
      }
      s0 += KS * kUnrollH;
      if (s0 < nseg) load_bf16<kVec>(p, prow, rok, c0, n, s0, c);
    }
  }

  // accumulator fragment: (row g | g+8, columns nt*8 + 2c, +1)
  float* mine = red + warp * 256;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * c;
    mine[g * 16 + col] = acc[nt][0];
    mine[g * 16 + col + 1] = acc[nt][1];
    mine[(g + 8) * 16 + col] = acc[nt][2];
    mine[(g + 8) * 16 + col + 1] = acc[nt][3];
  }
  __syncthreads();
  write_rows<VD>(red, out, b, h, Tq, H, RT);
}

int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <typename T>
int launch(void (*kern)(const T*, const T*, T*, int, int, int, int), size_t smem,
           const void* probs, const void* v, void* out, int B, int Tq, int Tk, int H,
           cudaStream_t stream) {
  // 64 rows a block (4 row tiles) unless the grid would leave a quarter of
  // the card idle; the rows a block gives up go to more key splits
  const int sms = num_sms();
  int RT = 4;
  while (RT > 1 && (long long)B * H * ((Tq + 16 * RT - 1) / (16 * RT)) < (3 * sms) / 4) RT >>= 1;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Tq + 16 * RT - 1) / (16 * RT), B * H);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(probs), static_cast<const T*>(v),
                                         static_cast<T*>(out), Tq, Tk, H, RT);
  return (int)cudaGetLastError();
}

template <int VD>
int launch_vd(const void* probs, const void* v, void* out, int B, int Tq, int Tk, int H,
              int bf16, cudaStream_t s) {
  const size_t red = kRedFloats * sizeof(float);
  if (bf16) {
    const size_t smem = 16 * kStrideH * sizeof(__nv_bfloat16) + red;
    auto kern = Tk % 8 == 0 ? probs_apply_bf16<VD, true> : probs_apply_bf16<VD, false>;
    return launch(kern, smem, probs, v, out, B, Tq, Tk, H, s);
  }
  const size_t smem = VD * kStrideF * sizeof(float) + red;
  auto kern = Tk % 4 == 0 ? probs_apply_f32<VD, true> : probs_apply_f32<VD, false>;
  return launch(kern, smem, probs, v, out, B, Tq, Tk, H, s);
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch, cudaErrorInvalidValue for a VD not instantiated.
// probs (B,H,Tq,Tk), v (B,Tk,H,VD) and out (B,Tq,H,VD) must be 16-byte
// aligned.
extern "C" int zv_probs_apply(const void* probs, const void* v, void* out, int B, int Tq,
                              int Tk, int H, int VD, int bf16, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (VD) {
    case 4: return launch_vd<4>(probs, v, out, B, Tq, Tk, H, bf16, s);
    case 8: return launch_vd<8>(probs, v, out, B, Tq, Tk, H, bf16, s);
    case 12: return launch_vd<12>(probs, v, out, B, Tq, Tk, H, bf16, s);
    case 16: return launch_vd<16>(probs, v, out, B, Tq, Tk, H, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
