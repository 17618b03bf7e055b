// Fused log-mel spectrogram (B8).
//
// Replaces the TPU kernel zipvoice_tpu/ops/melspec.py `fused_log_mel`
// (body `_kernel`): for every frame f of the center-padded waveform,
//
//   x_f[n]  = wav[f*hop + n] * hann[n]                    n < n_fft
//   X_f[k]  = sum_n x_f[n] (cos - i sin)(2 pi k n / n_fft)  k <= n_fft/2
//   out[f,m] = log(max(sum_k |X_f[k]| fb[k, m], 1e-7))     (HTK mel, no norm)
//
// wav: (B, L) f32, already reflect-padded by n_fft/2 on both sides;
// out: (B, F, n_mels) f32 with F = (L - n_fft) / hop + 1, any F (no padding
// of the frame count to a tile, unlike the TPU's 128-frame tiles).
//
// What bounds it on an H100: the DFT arithmetic, n_fft * (n_fft/2+1) * 2
// FMAs a frame (1.05 M at n_fft = 1024) on the CUDA cores; the audio read and
// the mel write are a few bytes a frame.  The TPU kernel feeds a (n_fft,
// 640) basis to its matrix unit; here the basis is never stored:
//   * a block owns kFrames consecutive frames of one row; their overlapping
//     audio window ((kFrames-1)*hop + n_fft samples, one read) sits in
//     shared memory with the window function and one period of cos and sin
//     (cos(2 pi m / n_fft), m < n_fft, built in f64 and rounded to f32, so
//     the basis entry of (k, n) is table[k*n mod n_fft], the same f32 value
//     the TPU kernel's host-built basis holds; stored skewed so that the
//     lanes' reads spread over the banks);
//   * a thread owns one frequency bin and keeps its kFrames complex sums in
//     registers, so each table read serves kFrames frames;
//   * magnitudes go to shared memory and the mel product, clamp and log are
//     the epilogue; one write of (kFrames, n_mels).

#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 16;

// The tables are read at m = k*n mod n_fft by lanes on neighbouring bins
// k; for n a multiple of 32 every lane's m falls in one bank.  Entry m is
// stored at m + m/32, which spreads those reads over distinct banks.
__host__ __device__ inline int skew(int m) { return m + (m >> 5); }

// shared memory (floats): audio window | hann | cos table | sin table |
// magnitudes [kFrames][half]
size_t smem_floats(int n_fft, int hop) {
  const int half = n_fft / 2 + 1;
  const size_t span = (size_t)(kFrames - 1) * hop + n_fft;
  return span + n_fft + 2 * (size_t)skew(n_fft) + (size_t)kFrames * half;
}

__global__ void log_mel_kernel(const float* __restrict__ wav, const float* __restrict__ win,
                               const float* __restrict__ cos_t,
                               const float* __restrict__ sin_t,
                               const float* __restrict__ fb, float* __restrict__ out, int L,
                               int F, int n_fft, int hop, int n_mels) {
  extern __shared__ float smem[];
  const int half = n_fft / 2 + 1;
  const int span = (kFrames - 1) * hop + n_fft;
  float* aw = smem;
  float* ws = aw + span;
  float* ct = ws + n_fft;
  float* st = ct + skew(n_fft);
  float* mag = st + skew(n_fft);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, F - f0);
  const size_t s0 = (size_t)f0 * hop;
  const float* row = wav + (size_t)b * L;

  for (int i = threadIdx.x; i < span; i += blockDim.x)
    aw[i] = s0 + i < (size_t)L ? row[s0 + i] : 0.f;
  for (int i = threadIdx.x; i < n_fft; i += blockDim.x) {
    ws[i] = win[i];
    ct[skew(i)] = cos_t[i];
    st[skew(i)] = sin_t[i];
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < half) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) re[f] = im[f] = 0.f;
    const int mask = n_fft - 1;  // n_fft is a power of two
    for (int n = 0; n < n_fft; ++n) {
      const int m = skew((k * n) & mask);
      const float c = ct[m], s = st[m], w = ws[n];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float x = aw[f * hop + n] * w;
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) mag[f * half + k] = sqrtf(re[f] * re[f] + im[f] * im[f]);
  }
  __syncthreads();

  for (int o = threadIdx.x; o < nf * n_mels; o += blockDim.x) {
    const int f = o / n_mels, m = o % n_mels;
    const float* mf = mag + f * half;
    float acc = 0.f;
    for (int kk = 0; kk < half; ++kk) acc = fmaf(mf[kk], fb[(size_t)kk * n_mels + m], acc);
    out[((size_t)b * F + f0 + f) * n_mels + m] = logf(fmaxf(acc, 1e-7f));
  }
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (n_fft not a power of two or above 2046, L < n_fft).
extern "C" int zv_log_mel(const float* wav, const float* win, const float* cos_t,
                          const float* sin_t, const float* fb, float* out, int B, int L,
                          int n_fft, int hop, int n_mels, void* stream) {
  if (B <= 0 || L < n_fft || hop <= 0 || n_mels <= 0 || (n_fft & (n_fft - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int half = n_fft / 2 + 1;
  const int threads = ((half + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const int F = (L - n_fft) / hop + 1;
  const size_t smem = smem_floats(n_fft, hop) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((F + kFrames - 1) / kFrames, B);
  log_mel_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      wav, win, cos_t, sin_t, fb, out, L, F, n_fft, hop, n_mels);
  return (int)cudaGetLastError();
}
