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
// What bounds it on an H100.  At n_fft 1024, hop 256 and 100 mels a frame
// needs about 30.3 k operations: the window (1024), a real FFT (2.5 N log2 N,
// 25.6 k), |X| of 513 bins (3 each), the mel product over the filterbank's
// 1008 nonzeros (2 each) and 100 logs.  At B=8, 10 s (7504 frames) that is
// 0.227 GFLOP, 0.0034 ms at 67 TFLOP/s f32; the audio in and the mels out are
// 10.7 MB, 0.0032 ms at 3.35 TB/s.  The TPU kernel's DFT as two (n_fft, 640)
// basis products is 2.1 M operations a frame; on this card the scarce things
// are the SM's shared-memory bandwidth and the latency between a block's
// phases, so the design counts shared accesses and keeps loads in flight:
//   * a block owns fpb consecutive frames of one row (1 to 8 at n_fft 1024,
//     chosen at launch so that every SM gets about eight blocks) and copies
//     their overlapping audio window, (fpb-1)*hop + n_fft samples, once into
//     shared memory with 4-byte asynchronous copies that stop at the end of
//     the row, issued with the twiddles and mel weights before one wait;
//   * a real frame of N samples is packed as z[n] = x[2n] + i x[2n+1] and
//     takes an N/2-point complex FFT: Stockham passes of radix 8 (one last
//     radix-2 or radix-4 pass where 3 does not divide log2(N/2)), N/16
//     threads a frame holding 8 values each in registers, one exchange
//     buffer a frame (512 points: three passes, two exchanges), stored at
//     swizzled addresses so that the strided stores of every pass and the
//     unit-stride loads hit distinct banks;
//   * every twiddle comes from the wrapper's one-period f32 table
//     (cos, sin)(2 pi m / N): the N/2-point FFT's at even m and the split's
//     X[k] = E[k] + W^k O[k] into the N/2+1 bins, both staged a block in
//     the order the threads read them;
//   * |X[k]| goes to shared memory, and one thread a (frame, mel) sums
//     |X[k]| fb[k, m] over that mel's nonzero bins only (the wrapper's
//     ranges and packed weights), in increasing k; the block writes its
//     (fpb, n_mels) tile with consecutive threads on consecutive addresses.

#include <cuda_runtime.h>

namespace {

// The FFT plan of an N = 2^LOG2N sample frame, as M = N/2 complex points:
// pass s has radix radix(s) and follows ns(s) = 8^s points already combined;
// TPF threads work on one frame, VPT complex values each.
template <int LOG2N>
struct Plan {
  static_assert(LOG2N >= 0 && LOG2N <= 10, "n_fft up to 1024");
  static constexpr int N = 1 << LOG2N;
  static constexpr int M = N / 2;  // 0 for N = 1
  static constexpr int LOG2M = LOG2N - 1;
  static constexpr int VPT = M >= 8 ? 8 : (M > 0 ? M : 1);
  static constexpr int TPF = M >= 8 ? M / 8 : 1;
  static constexpr int P = LOG2N >= 2 ? (LOG2M + 2) / 3 : 0;
  // floats of one frame's exchange buffer: re [0, M), im [M, 2M)
  static constexpr int BS = M > 0 ? 2 * M : 2;
  __host__ __device__ static constexpr int radix(int s) {
    return LOG2M - 3 * s >= 3 ? 8 : 1 << (LOG2M - 3 * s);
  }
  __host__ __device__ static constexpr int ns(int s) { return 1 << (3 * s); }
  // pass s's (radix - 1) x ns twiddles start here in the staged table
  __host__ __device__ static constexpr int tw_off(int s) {
    int o = 0;
    for (int q = 1; q < s; ++q) o += (radix(q) - 1) * ns(q);
    return o;
  }
  static constexpr int NTW = tw_off(P);
};

// Where point i of a frame's exchange buffer lives: its low 5 bits XORed with
// bits of i >> 5, so that a pass's stores at stride 8 (ns 1) and in runs of 8
// at stride 64 (ns 8) fall on 32 distinct banks, as do unit-stride runs.
__device__ __forceinline__ int sw(int i) {
  const int h = i >> 5;
  return i ^ ((h & 7) ^ (((h >> 1) & 3) << 3));
}

// a <- a + b, b <- a - b
__device__ __forceinline__ void bfly2(float& ar, float& ai, float& br, float& bi) {
  const float tr = ar - br, ti = ai - bi;
  ar += br;
  ai += bi;
  br = tr;
  bi = ti;
}

// Forward radix-4 DFT, X[s] = sum_m x[m] (-i)^(m s), in place, natural order.
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1, float& i1, float& r2,
                                     float& i2, float& r3, float& i3) {
  bfly2(r0, i0, r2, i2);  // x0 + x2, x0 - x2
  bfly2(r1, i1, r3, i3);  // x1 + x3, x1 - x3
  bfly2(r0, i0, r1, i1);  // X0, X2
  const float x2r = r1, x2i = i1, ar = r2, ai = i2, br = r3, bi = i3;
  r1 = ar + bi;  // X1 = (x0 - x2) - i (x1 - x3)
  i1 = ai - br;
  r2 = x2r;
  i2 = x2i;
  r3 = ar - bi;  // X3 = (x0 - x2) + i (x1 - x3)
  i3 = ai + br;
}

// Forward radix-8 DFT in place, natural order: pairs (m, m+4) first, the odd
// half turned by W8^m, then a radix-4 DFT of each half (even and odd outputs).
__device__ __forceinline__ void dft8(float (&r)[8], float (&i)[8]) {
  // sqrt(1/2) rounded to f32, the table's entry N/8
  constexpr float h = 0.70710678118654752f;
#pragma unroll
  for (int m = 0; m < 4; ++m) bfly2(r[m], i[m], r[m + 4], i[m + 4]);
  float x = r[5], y = i[5];
  r[5] = (x + y) * h;  // * (1 - i) / sqrt 2
  i[5] = (y - x) * h;
  x = r[6];
  r[6] = i[6];  // * -i
  i[6] = -x;
  x = r[7];
  y = i[7];
  r[7] = (y - x) * h;  // * (-1 - i) / sqrt 2
  i[7] = -(x + y) * h;
  dft4(r[0], i[0], r[1], i[1], r[2], i[2], r[3], i[3]);
  dft4(r[4], i[4], r[5], i[5], r[6], i[6], r[7], i[7]);
  float yr[8], yi[8];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    yr[2 * s] = r[s];
    yi[2 * s] = i[s];
    yr[2 * s + 1] = r[4 + s];
    yi[2 * s + 1] = i[4 + s];
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    r[s] = yr[s];
    i[s] = yi[s];
  }
}

// One Stockham pass of radix R = radix(S) over a frame's M points: the thread
// holds v[q] = point t + q*TPF, runs VPT/R butterflies j = t + u*TPF (points
// j + r*M/R are v[u + U*r]), each input r turned by W^(r (j mod ns)) of the
// (ns R)-point FFT, and stores output r at (j / ns) ns R + j mod ns + r ns.
template <int LOG2N, int S>
__device__ __forceinline__ void fft_pass(float (&vr)[Plan<LOG2N>::VPT],
                                         float (&vi)[Plan<LOG2N>::VPT], int t,
                                         const float2* tw, float* dst) {
  using PL = Plan<LOG2N>;
  constexpr int R = PL::radix(S), NS = PL::ns(S), U = PL::VPT / R, M = PL::M;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = t + u * PL::TPF, c = j & (NS - 1);
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = tw[PL::tw_off(S) + (r - 1) * NS + c];  // (cos, sin)
        const float a = vr[u + U * r], b = vi[u + U * r];
        vr[u + U * r] = fmaf(a, w.x, b * w.y);
        vi[u + U * r] = fmaf(b, w.x, -a * w.y);
      }
    }
    if constexpr (R == 8) {
      dft8(vr, vi);
    } else if constexpr (R == 4) {
      dft4(vr[u], vi[u], vr[u + U], vi[u + U], vr[u + 2 * U], vi[u + 2 * U], vr[u + 3 * U],
           vi[u + 3 * U]);
    } else {
      bfly2(vr[u], vi[u], vr[u + U], vi[u + U]);
    }
    const int d = (j - c) * R + c;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dst[sw(d + r * NS)] = vr[u + U * r];
      dst[M + sw(d + r * NS)] = vi[u + U * r];
    }
  }
}

template <int LOG2N>
__device__ __forceinline__ void load_points(float (&vr)[Plan<LOG2N>::VPT],
                                            float (&vi)[Plan<LOG2N>::VPT], int t,
                                            const float* src) {
  using PL = Plan<LOG2N>;
#pragma unroll
  for (int q = 0; q < PL::VPT; ++q) {
    vr[q] = src[sw(t + q * PL::TPF)];
    vi[q] = src[PL::M + sw(t + q * PL::TPF)];
  }
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// 4-byte asynchronous copy to shared memory, zero-filled where !valid (src is
// then not read); the block's staging issues all of them before one wait
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// floats of shared memory: audio window | exchange buffers [fpb] | the FFT's
// twiddles (float2) | the split's cos and sin of bins 0..M/2 | packed mel
// weights
template <int LOG2N>
size_t smem_floats(int fpb, int hop, int n_w) {
  using PL = Plan<LOG2N>;
  const int span = hop < PL::N ? (fpb - 1) * hop + PL::N : fpb * PL::N;
  return (size_t)round4(span) + (size_t)fpb * PL::BS + 2 * PL::NTW + 2 * (PL::M / 2 + 1) + n_w;
}

template <int LOG2N>
__global__ void __launch_bounds__(512, 3)
    log_mel_kernel(const float* __restrict__ wav, const float* __restrict__ win,
                   const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                   const float* __restrict__ fb_w, const int* __restrict__ fb_r,
                   float* __restrict__ out, int L, int F, int hop, int n_mels, int n_w,
                   int fpb) {
  using PL = Plan<LOG2N>;
  constexpr int N = PL::N, M = PL::M, TPF = PL::TPF, VPT = PL::VPT, P = PL::P, BS = PL::BS;
  extern __shared__ float4 smem4[];
  float* aw = reinterpret_cast<float*>(smem4);
  // a frame's first sample in the staged audio: frames overlap when hop < N
  const int fs = hop < N ? hop : N;
  const int span = hop < N ? (fpb - 1) * hop + N : fpb * N;
  float* buf = aw + round4(span);
  float2* tw = reinterpret_cast<float2*>(buf + fpb * BS);
  constexpr int H = M / 2 + 1;
  float* cs = reinterpret_cast<float*>(tw + PL::NTW);  // cos, then sin, of bins 0..M/2
  float* ws = cs + 2 * H;

  const int b = blockIdx.y, f0 = blockIdx.x * fpb, nf = min(fpb, F - f0);
  const size_t s0 = (size_t)f0 * hop;
  const float* row = wav + (size_t)b * L;
  if (hop < N) {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const bool in = s0 + i < (size_t)L;
      cp_async4(aw + i, in ? row + s0 + i : row, in);
    }
  } else {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const size_t s = s0 + (size_t)(i >> LOG2N) * hop + (i & (N - 1));
      cp_async4(aw + i, s < (size_t)L ? row + s : row, s < (size_t)L);
    }
  }
  if constexpr (P > 1) {
#pragma unroll
    for (int s = 1; s < P; ++s) {
      const int ns = PL::ns(s), count = (PL::radix(s) - 1) * ns;
      const int step = N / (ns * PL::radix(s));
      float* dst = reinterpret_cast<float*>(tw + PL::tw_off(s));
      for (int i = threadIdx.x; i < count; i += blockDim.x) {
        const int e = (i / ns + 1) * (i % ns) * step;
        cp_async4(dst + 2 * i, cos_t + e, true);
        cp_async4(dst + 2 * i + 1, sin_t + e, true);
      }
    }
  }
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    cp_async4(cs + i, cos_t + i, true);
    cp_async4(cs + H + i, sin_t + i, true);
  }
  for (int i = threadIdx.x; i < n_w; i += blockDim.x) cp_async4(ws + i, fb_w + i, true);
  // the thread's window values, read while the copies land
  const int g = threadIdx.x / TPF, t = threadIdx.x % TPF;
  float2 wv[VPT];
  if constexpr (LOG2N > 0) {
#pragma unroll
    for (int q = 0; q < VPT; ++q)
      wv[q] = __ldg(reinterpret_cast<const float2*>(win) + t + q * TPF);
  }
  cp_async_wait_all();
  __syncthreads();

  // every group of TPF threads transforms one frame of the block; frames past
  // F see the zeros staged for them and are not written
  float* zb = buf + g * BS;  // the frame's exchange buffer, then its |X|
  if constexpr (LOG2N == 0) {
    zb[0] = fabsf(aw[g * fs] * __ldg(win));
  } else {
    float vr[VPT], vi[VPT];
    const float* a = aw + g * fs;
#pragma unroll
    for (int q = 0; q < VPT; ++q) {
      const int n = t + q * TPF;
      const float2 w = wv[q];
      float x0, x1;
      if ((fs & 1) == 0) {
        const float2 x = *reinterpret_cast<const float2*>(a + 2 * n);
        x0 = x.x;
        x1 = x.y;
      } else {
        x0 = a[2 * n];
        x1 = a[2 * n + 1];
      }
      vr[q] = x0 * w.x;
      vi[q] = x1 * w.y;
    }
    if constexpr (P == 0) {
      zb[0] = vr[0];
      zb[1] = vi[0];
    } else {
      fft_pass<LOG2N, 0>(vr, vi, t, tw, zb);
    }
    // each later pass reads all of the frame's points before any is overwritten
    if constexpr (P >= 2) {
      __syncthreads();
      load_points<LOG2N>(vr, vi, t, zb);
      __syncthreads();
      fft_pass<LOG2N, 1>(vr, vi, t, tw, zb);
    }
    if constexpr (P >= 3) {
      __syncthreads();
      load_points<LOG2N>(vr, vi, t, zb);
      __syncthreads();
      fft_pass<LOG2N, 2>(vr, vi, t, tw, zb);
    }
    __syncthreads();

    // Z = FFT(z) -> |X[k]| for the pair (k, M - k): with E = (Z[k] +
    // conj Z[M-k]) / 2 and O = (Z[k] - conj Z[M-k]) / 2i, the transforms of
    // the even and odd samples, X[k] = E + W^k O, X[M-k] = conj E + W^(M-k) conj O
    // all of the thread's pairs are read before |X| overwrites the buffer
    constexpr int KPT = M / 2 / TPF + 1;
    float za[KPT][4];
#pragma unroll
    for (int p = 0; p < KPT; ++p) {
      const int k = t + p * TPF;
      if (k <= M / 2) {
        za[p][0] = zb[sw(k)];
        za[p][1] = zb[M + sw(k)];
        za[p][2] = zb[sw(M - k)];
        za[p][3] = zb[M + sw(M - k)];
      }
    }
    __syncthreads();
    float* mag = zb;
#pragma unroll
    for (int p = 0; p < KPT; ++p) {
      const int k = t + p * TPF;
      if (k > M / 2) continue;
      const float ar = za[p][0], ai = za[p][1], br = za[p][2], bi = za[p][3];
      if (k == 0) {
        mag[0] = fabsf(ar + ai);
        mag[M] = fabsf(ar - ai);
        continue;
      }
      const int kk = M - k;
      const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
      const float orr = 0.5f * (ai + bi), oi = 0.5f * (br - ar);
      const float c = cs[k], s = cs[H + k];
      const float xr = er + fmaf(c, orr, s * oi), xi = ei + fmaf(c, oi, -s * orr);
      mag[k] = sqrtf(xr * xr + xi * xi);
      if (kk != k) {
        // the table's (cos, sin) at M - k are (-cos, sin) at k, bit for bit
        const float yr = er - fmaf(c, orr, s * oi), yi = fmaf(c, oi, -s * orr) - ei;
        mag[kk] = sqrtf(yr * yr + yi * yi);
      }
    }
  }
  __syncthreads();

  // the mel product over each mel's nonzero bins [lo, hi), then the log
  const float* mags = buf;
  float* dst = out + ((size_t)b * F + f0) * n_mels;
  for (int o = threadIdx.x; o < nf * n_mels; o += blockDim.x) {
    const int f = o / n_mels, m = o - f * n_mels;
    const int lo = __ldg(fb_r + 3 * m), hi = __ldg(fb_r + 3 * m + 1);
    const float* mf = mags + f * BS;
    const float* wm = ws + __ldg(fb_r + 3 * m + 2) - lo;
    float acc = 0.f;
#pragma unroll 4  // four bins' loads in flight; the sum still runs in increasing k
    for (int k = lo; k < hi; ++k) acc = fmaf(mf[k], wm[k], acc);
    dst[o] = logf(fmaxf(acc, 1e-7f));
  }
}

// frames a block: the most (a power of two, at most 512 threads) that still
// gives every SM about eight blocks, within half an SM's shared memory
constexpr int kBlocksPerSm = 8;
constexpr size_t kSmemBudget = 227 * 1024 / 2;

template <int LOG2N>
int launch(const float* wav, const float* win, const float* cos_t, const float* sin_t,
           const float* fb_w, const int* fb_r, float* out, int B, int L, int hop, int n_mels,
           int n_w, cudaStream_t stream) {
  using PL = Plan<LOG2N>;
  const int F = (L - PL::N) / hop + 1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int fpb = 1;
  while (2 * fpb * PL::TPF <= 512 &&
         (long long)B * ((F + 2 * fpb - 1) / (2 * fpb)) >= (long long)kBlocksPerSm * sms &&
         smem_floats<LOG2N>(2 * fpb, hop, n_w) * sizeof(float) <= kSmemBudget)
    fpb *= 2;
  const size_t smem = smem_floats<LOG2N>(fpb, hop, n_w) * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(log_mel_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((F + fpb - 1) / fpb, B);
  log_mel_kernel<LOG2N><<<grid, fpb * PL::TPF, smem, stream>>>(
      wav, win, cos_t, sin_t, fb_w, fb_r, out, L, F, hop, n_mels, n_w, fpb);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (n_fft not a power of two up to 1024, L < n_fft).  win, cos_t, sin_t:
// (n_fft,) f32, win 8-byte aligned; fb_w: the filterbank's packed weights,
// n_w of them, mel m's at fb_r[3m+2] for its bins [fb_r[3m], fb_r[3m+1]).
extern "C" int zv_log_mel(const float* wav, const float* win, const float* cos_t,
                          const float* sin_t, const float* fb_w, const int* fb_r, float* out,
                          int B, int L, int n_fft, int hop, int n_mels, int n_w, void* stream) {
  if (B <= 0 || n_fft <= 0 || n_fft > 1024 || (n_fft & (n_fft - 1)) != 0 || L < n_fft ||
      hop <= 0 || n_mels <= 0 || n_w < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (__builtin_ctz(n_fft)) {
    case 0: return launch<0>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    case 1: return launch<1>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    case 2: return launch<2>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    case 3: return launch<3>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    case 4: return launch<4>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    case 5: return launch<5>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    case 6: return launch<6>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    case 7: return launch<7>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    case 8: return launch<8>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    case 9: return launch<9>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
    default:
      return launch<10>(wav, win, cos_t, sin_t, fb_w, fb_r, out, B, L, hop, n_mels, n_w, s);
  }
}
