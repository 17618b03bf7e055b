// Fused ConvolutionModule tail of the Zipformer eval path (B9).
//
// Replaces the TPU kernel zipvoice_tpu/ops/convglu.py `conv_glu_swoosh_out`
// (body `_conv_glu_kernel`):
//
//   g[t,c]   = proj[t,c] * sigmoid(proj[t,C+c]) * keep[t]    (f32; 0 outside [0,T))
//   y[t,c]   = SwooshR(sum_k w[c,k] g[t+k-K/2, c] + b[c])     (f32)
//   out[t,d] = sum_c round(y[t,c]) w_out[d,c] + b_out[d]       (f32 sums)
//
// with round() to proj's dtype.  proj (B,T,2C), w_out (D,C) (the nn.Linear
// layout) and out (B,T,D) are all f32 or all bf16; w (C,K) (nn.Conv1d's
// (C,1,K)), b (C) and b_out (D, or null) are f32; keep[t] = 0 where the
// (B,T) uint8 padding mask (or null) is set, so padded rows are zeroed
// before the conv, as in `_conv_glu_kernel`.
//
// What bounds it on an H100: the out-projection, 2*T*C*D operations a batch
// row on the f32 CUDA cores (operations; the bytes are proj in and out
// once).  The design:
//   * a block owns kRows = 16 time rows of one batch row and every channel.
//     It computes the gate for its rows and the K-1 halo rows around them
//     into shared memory ((16 + K - 1) x C f32: 94 KB at C = 512, K = 31),
//     four channels a thread with several rows' loads in flight.
//     The TPU kernel reads the neighbouring time tiles through three
//     BlockSpecs and zeroes them at the sequence edges; here the halo is just
//     more rows, zero outside [0, T);
//   * the depthwise conv: one thread a channel (two or more for C > 256),
//     the 16 rows' sums in registers, each tap read once; bias, SwooshR and
//     the rounding follow, and the results overwrite the gate rows in shared
//     memory once every thread has read them;
//   * the out-projection: each thread owns two output columns d and the 16
//     rows' sums of each in registers and walks c four at a time: a float4
//     of its own w_out row (L1/L2-cached) against shared-memory float4
//     broadcasts of y, each block from its own starting c (the blocks would
//     otherwise all read the same w_out lines of one L2 slice at once).  The
//     out-projection is computed here, not by a GEMM library.
// Any T: the ragged last tile is masked; nothing is padded to 128 rows.
// C must be a multiple of 4 and at most kMaxChan * 256.

#include "rel_common.cuh"

namespace {

using namespace zv;

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kMaxChan = 4;  // channels a thread convolves: C <= 1024
constexpr int kCols = 2;     // output columns a thread owns per pass
constexpr int kGateBatch = 4;  // gate loads (float4 pairs) a thread has in flight

__device__ __forceinline__ float sigmoid(float s) { return 1.f / (1.f + expf(-s)); }

__device__ __forceinline__ float swoosh_r(float y) {
  // log(1 + exp(y - 1)) - 0.08 y - 0.313261687, as logaddexp(0, y - 1)
  const float z = y - 1.f;
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - 0.08f * y - 0.313261687f;
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
conv_glu_kernel(const Tin* __restrict__ proj, const uint8_t* __restrict__ mask,
                const float* __restrict__ w, const float* __restrict__ bconv,
                const Tin* __restrict__ w_out, const float* __restrict__ b_out,
                Tin* __restrict__ out, int T, int C, int K, int D) {
  extern __shared__ float4 smem4[];
  float* G = reinterpret_cast<float*>(smem4);  // gate rows [kRows + K - 1][C], then y [kRows][C]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int pad = K / 2;
  const int nrows = min(kRows, T - t0);
  const Tin* pb = proj + (size_t)b * T * 2 * C;

  // gate row gr is time t0 - pad + gr; four channels a thread, kGateBatch
  // rows of loads in flight
  const int C4 = C / 4, n4 = (kRows + K - 1) * C4;
  for (int base = threadIdx.x; base < n4; base += kGateBatch * kThreads) {
    float4 vv[kGateBatch], ss[kGateBatch];
    float keep[kGateBatch];
#pragma unroll
    for (int u = 0; u < kGateBatch; ++u) {
      const int idx = base + u * kThreads, gr = idx / C4, c4 = idx - gr * C4;
      const int t = t0 - pad + gr;
      const bool in = idx < n4 && t >= 0 && t < T;
      const Tin* row = pb + (size_t)(in ? t : 0) * 2 * C + 4 * c4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      vv[u] = in ? load4(row) : zero;
      ss[u] = in ? load4(row + C) : zero;
      keep[u] = (in && !(mask != nullptr && mask[(size_t)b * T + t])) ? 1.f : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGateBatch; ++u) {
      const int idx = base + u * kThreads;
      if (idx < n4)
        reinterpret_cast<float4*>(G)[idx] = make_float4(
            vv[u].x * sigmoid(ss[u].x) * keep[u], vv[u].y * sigmoid(ss[u].y) * keep[u],
            vv[u].z * sigmoid(ss[u].z) * keep[u], vv[u].w * sigmoid(ss[u].w) * keep[u]);
    }
  }
  __syncthreads();

  // depthwise conv + bias + SwooshR, rounded to proj's dtype
  float y[kMaxChan][kRows];
#pragma unroll
  for (int u = 0; u < kMaxChan; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c < C) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float wk = w[(size_t)c * K + k];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(wk, G[(size_t)(r + k) * C + c], acc[r]);
      }
      const float bc = bconv[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) y[u][r] = to_f32(from_f32<Tin>(swoosh_r(acc[r] + bc)));
    }
  }
  __syncthreads();  // every gate row is read
#pragma unroll
  for (int u = 0; u < kMaxChan; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c < C) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) G[(size_t)r * C + c] = y[u][r];
    }
  }
  __syncthreads();

  // out[t, d] = sum_c y[t, c] w_out[d, c] + b_out[d].  Each block starts its
  // walk over c at its own offset, so the blocks do not all read the same
  // lines of w_out at once.
  const float4* Y4 = reinterpret_cast<const float4*>(G);
  const int rot = (int)((long long)(blockIdx.y * gridDim.x + blockIdx.x) * C4 /
                        (gridDim.x * gridDim.y));
  for (int d0 = threadIdx.x; d0 < D; d0 += kCols * kThreads) {
    float acc[kCols][kRows];
#pragma unroll
    for (int u = 0; u < kCols; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[u][r] = 0.f;
#pragma unroll 4
    for (int i = 0; i < C4; ++i) {
      const int c4 = i + rot < C4 ? i + rot : i + rot - C4;
      float4 wv[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int d = d0 + u * kThreads;
        wv[u] = d < D ? load4(w_out + (size_t)d * C + 4 * c4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 yv = Y4[r * C4 + c4];
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          float a = acc[u][r];
          a = fmaf(yv.x, wv[u].x, a);
          a = fmaf(yv.y, wv[u].y, a);
          a = fmaf(yv.z, wv[u].z, a);
          a = fmaf(yv.w, wv[u].w, a);
          acc[u][r] = a;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int d = d0 + u * kThreads;
      if (d < D) {
        const float bo = b_out != nullptr ? b_out[d] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nrows) out[((size_t)b * T + t0 + r) * D + d] = from_f32<Tin>(acc[u][r] + bo);
      }
    }
  }
}

template <typename Tin>
int launch_typed(const void* proj, const void* mask, const float* w, const float* b,
                 const void* w_out, const float* b_out, void* out, int B, int T, int C, int K,
                 int D, cudaStream_t stream) {
  const size_t smem = (size_t)(kRows + K - 1) * C * sizeof(float);
  if (smem > (size_t)max_optin_smem()) return (int)cudaErrorInvalidValue;
  auto kern = conv_glu_kernel<Tin>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((T + kRows - 1) / kRows, B), kThreads, smem, stream>>>(
      static_cast<const Tin*>(proj), static_cast<const uint8_t*>(mask), w, b,
      static_cast<const Tin*>(w_out), b_out, static_cast<Tin*>(out), T, C, K, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (C not a multiple of 4 or above 1024, the halo rows too large for
// shared memory).  bf16: proj, w_out and out are bf16 (else f32).
extern "C" int zv_conv_glu(const void* proj, const void* mask, const void* w, const void* b,
                           const void* w_out, const void* b_out, void* out, int B, int T, int C,
                           int K, int D, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || C > kMaxChan * kThreads || K <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* bo = static_cast<const float*>(b_out);
  if (bf16)
    return launch_typed<__nv_bfloat16>(proj, mask, wf, bf, w_out, bo, out, B, T, C, K, D, s);
  return launch_typed<float>(proj, mask, wf, bf, w_out, bo, out, B, T, C, K, D, s);
}
