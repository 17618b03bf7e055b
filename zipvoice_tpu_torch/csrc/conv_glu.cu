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
// row (operations in f32; in bf16 the bytes of proj in and out), and the
// w_out tiles every row block reads again from L2.  The design, 512
// threads a block:
//   * a block owns kRows = 16 time rows of one batch row and every channel.
//     It computes the gate for its rows and the K-1 halo rows around them
//     into shared memory ((16 + K - 1) x C f32: 94 KB at C = 512, K = 31),
//     four channels a thread with several rows' loads in flight.
//     The TPU kernel reads the neighbouring time tiles through three
//     BlockSpecs and zeroes them at the sequence edges; here the halo is just
//     more rows, zero outside [0, T);
//   * the depthwise conv: one thread a channel (two for C > 512), the 16
//     rows' sums in registers, each tap read once; bias, SwooshR and the
//     rounding follow, and once every thread has read the gate rows, y goes
//     over them as the A tile of the out-projection (16 x C in proj's dtype,
//     a padded row stride for conflict-free fragment loads);
//   * the out-projection on the tensor cores (tensor_core.cuh): w_out's
//     (D, C) layout is already the column-major B operand of `mma.row.col`.
//     Tiles of 256 output rows d x 64 channels stream through 3 (or, where
//     they do not fit, 2) shared-memory stages, filled by coalesced 16-byte
//     `cp.async` (8-byte in bf16 when C is not a multiple of 8) whose
//     offsets a thread works out once a pass, edges zero-filled, behind
//     the A tile over the gate rows.  warp = (channel group, column
//     warp): a column warp owns two pairs of n8 tiles of d, the two channel
//     groups take the two halves of every stage, and their sums meet once,
//     in shared memory, at the end of a pass.  bf16: `mma.sync.m16n8k16`, A
//     and B fragments by `ldmatrix` (no transpose); the products are exact
//     in f32.  f32: 3xTF32 `mma.sync.m16n8k8` on operands split by masking,
//     within f32's tolerance;
//   * the grid is (time tiles, B, blocks of d): at short T a block takes a
//     slice of D (a multiple of 16, chosen on the host from T, D and the SM
//     count) so that the card has up to a block an SM, and recomputes the
//     gate and conv of its 16 rows ((16 + K - 1) * C sigmoids and 16 * C * K
//     FMAs against 16 * C * D / split for its share of the out-projection).
// Any T: the ragged last tile is masked; nothing is padded to 128 rows.
// C must be a multiple of 4 and at most kMaxChan * kThreads (1024); any D.

#include <type_traits>

#include "rel_common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace zv;

constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr int kRows = 16;
constexpr int kMaxChan = 2;    // channels a thread convolves: C <= 1024
constexpr int kGateBatch = 4;  // gate loads (float4 pairs) a thread has in flight
constexpr int kKt = 64;        // channels a w_out stage holds (32 measured slower)
constexpr int kGroups = 2;     // channel groups: each warp takes half of every stage
constexpr int kWarpsN = kWarps / kGroups;  // warps that split the output columns
constexpr int kPairs = 2;      // pairs of n8 tiles of d a warp owns
constexpr int kDc = kWarpsN * kPairs * 16;  // output columns a pass over C covers

struct Args {
  const void* proj;
  const uint8_t* mask;
  const float *w, *bconv;
  const void* w_out;
  const float* b_out;
  void* out;
  int T, C, K, D, B;
  Split split;  // the blocks' (time tile, batch row) units and blocks of d
  int cols;    // the most output columns a block takes, a multiple of 16
  int sa;      // row stride of the A tile (elements): 4 mod 32 (f32), 8 mod 32 (bf16)
  int sw;      // row stride of a w_out stage (elements)
  int srows;   // rows of d a stage holds
  int st_off;  // byte offset of the w_out stages
  int bytes;
  int stages;  // w_out stages in shared memory: 3, or 2 where 3 do not fit
};

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Shared memory: the gate rows, and over them, once the conv has read
// them, the A tile and behind it the w_out stages.  The stages also take
// the channel groups' partial sums at the end of a pass.
inline void smem_layout(Args& a, int elem) {
  a.sa = round_up(a.C, kKt) + (elem == 4 ? 4 : 8);
  a.sw = kKt + (elem == 4 ? 4 : 8);
  a.srows = round_up(a.cols < kDc ? a.cols : kDc, 16);
  const int gate = (kRows + a.K - 1) * a.C * (int)sizeof(float);
  const int tile = kRows * a.sa * elem;
  const int stages = a.stages * a.srows * a.sw * elem;
  a.st_off = round_up(tile, 128);
  a.bytes = a.st_off + stages > gate ? a.st_off + stages : gate;
}

__device__ __forceinline__ float sigmoid(float s) { return 1.f / (1.f + expf(-s)); }

__device__ __forceinline__ float swoosh_r(float y) {
  // log(1 + exp(y - 1)) - 0.08 y - 0.313261687, as logaddexp(0, y - 1)
  const float z = y - 1.f;
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - 0.08f * y - 0.313261687f;
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads, 1) conv_glu_kernel(Args a) {
  constexpr bool kBf16 = std::is_same<Tin, __nv_bfloat16>::value;
  constexpr int kElem = (int)sizeof(Tin);
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* G = reinterpret_cast<float*>(base);  // gate rows [kRows + K - 1][C]
  Tin* A = reinterpret_cast<Tin*>(base);      // then y [kRows][sa], over the gate rows
  Tin* stg = reinterpret_cast<Tin*>(base + a.st_off);
  const int T = a.T, C = a.C, K = a.K, D = a.D;
  int unit, d_lo, d_hi;
  split_block(a.split, blockIdx.x, D, unit, d_lo, d_hi);
  const int tiles = (T + kRows - 1) / kRows, tile = unit / a.B, b = unit - tile * a.B;
  const int t0 = tile * kRows;
  const int pad = K / 2;
  const int nrows = min(kRows, T - t0);
  const Tin* pb = static_cast<const Tin*>(a.proj) + (size_t)b * T * 2 * C;
  const uint8_t* mask = a.mask;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The out-projection's w_out stages: kKt channels of a.srows rows d.  Each
  // time tile starts at its own stage, so the blocks do not all read the
  // same lines of w_out at once.  Stage s of a pass goes to buffer
  // s % nst; channels past C and rows past the block's d are zero.
  const int Kp = round_up(C, kKt), ns = Kp / kKt, sw = a.sw, nst = a.stages;
  const int rot = (int)((long long)tile * ns / tiles);
  const Tin* wo = static_cast<const Tin*>(a.w_out);
  // 16-byte copies, or 8-byte ones where a bf16 row of w_out is 8-byte aligned only
  const bool wide = !kBf16 || C % 8 == 0;
  const int per = wide ? 16 / kElem : 4;  // elements a copy moves
  // A thread's copies are the same (row, channel) slots in every stage:
  // their offsets are worked out once a pass.
  constexpr int kMaxU = 8;  // copies a thread issues a stage (f32: 256 x 16 / 512)
  int u_row[kMaxU], u_col[kMaxU], u_glob[kMaxU];
  int pass_rows = 0;  // rows of d this pass
  auto plan_pass = [&](int dc0, int wd) {
    const int cpr = kKt / per;  // copies a row
    pass_rows = wd;
#pragma unroll
    for (int i = 0; i < kMaxU; ++i) {
      const int u = threadIdx.x + i * kThreads, r = u / cpr;
      u_row[i] = u < round_up(wd, 16) * cpr ? r : -1;  // -1: no copy
      u_col[i] = (u - r * cpr) * per;
      u_glob[i] = (dc0 + r) * C + u_col[i];
    }
  };
  auto produce = [&](int s) {
    const int c0 = ((s + rot) % ns) * kKt;
    Tin* dst = stg + (size_t)(s % nst) * a.srows * sw;
#pragma unroll
    for (int i = 0; i < kMaxU; ++i) {
      if (u_row[i] >= 0) {
        const bool valid = u_row[i] < pass_rows && c0 + u_col[i] < C;
        Tin* d = dst + u_row[i] * sw + u_col[i];
        if (wide)
          cp_async16(d, valid ? wo + (size_t)u_glob[i] + c0 : wo, valid);
        else
          cp_async8(d, valid ? wo + (size_t)u_glob[i] + c0 : wo, valid);
      }
    }
    cp_async_commit();
  };
  auto start_pass = [&](int dc0) {
    plan_pass(dc0, min(kDc, d_hi - dc0));
    for (int s = 0; s < nst - 1; ++s) {
      if (s < ns)
        produce(s);
      else
        cp_async_commit();
    }
  };

  // gate row gr is time t0 - pad + gr; four channels a thread, kGateBatch
  // rows of loads in flight
  const int C4 = C / 4, n4 = (kRows + K - 1) * C4;
  for (int base4 = threadIdx.x; base4 < n4; base4 += kGateBatch * kThreads) {
    float4 vv[kGateBatch], ss[kGateBatch];
    float keep[kGateBatch];
#pragma unroll
    for (int u = 0; u < kGateBatch; ++u) {
      const int idx = base4 + u * kThreads, gr = idx / C4, c4 = idx - gr * C4;
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
      const int idx = base4 + u * kThreads;
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
        const float wk = a.w[(size_t)c * K + k];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(wk, G[(size_t)(r + k) * C + c], acc[r]);
      }
      const float bc = a.bconv[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) y[u][r] = swoosh_r(acc[r] + bc);
    }
  }
  __syncthreads();  // every gate row is read
  const int sa = a.sa;
#pragma unroll
  for (int u = 0; u < kMaxChan; ++u) {
    const int c = threadIdx.x + u * kThreads;
    if (c < C) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) A[r * sa + c] = from_f32<Tin>(y[u][r]);
    }
  }
  for (int i = threadIdx.x; i < kRows * (Kp - C); i += kThreads) {  // channels C .. Kp-1
    const int r = i / (Kp - C);
    A[r * sa + C + (i - r * (Kp - C))] = from_f32<Tin>(0.f);
  }

  // out[t, d] = sum_c y[t, c] w_out[d, c] + b_out[d].  warp = (channel
  // group kg, column warp wn): wn owns pairs wn + 8i of n8 tiles of d; kg
  // takes channels kg * kKt / 2 .. of every stage.
  const int wn = warp % kWarpsN, kg = warp / kWarpsN;
  const int g = lane >> 2, t = lane & 3, m = lane >> 3;
  for (int dc0 = d_lo; dc0 < d_hi; dc0 += kDc) {
    const int wd = min(kDc, d_hi - dc0);
    start_pass(dc0);

    // f32: the 3xTF32 big and small products in two sets of sums
    float acc[kPairs][2][4], acc2[kPairs][2][4];
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = acc2[i][n][e] = 0.f;

    for (int s = 0; s < ns; ++s) {
      if (nst == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // stage s has landed (and the A tile is complete); s - 1 is consumed
      if (s + nst - 1 < ns)
        produce(s + nst - 1);
      else
        cp_async_commit();
      const int kk = kg * (kKt / 2);  // this channel group's channels in the stage
      const Tin* ws = stg + (size_t)(s % nst) * a.srows * sw + kk;
      const int c0 = ((s + rot) % ns) * kKt + kk;
      if constexpr (kBf16) {
#pragma unroll
        for (int k16 = 0; k16 < kKt / 2; k16 += 16) {
          uint32_t af[4];
          ldmatrix_x4(af, A + ((lane & 7) + (m & 1) * 8) * sa + c0 + k16 + (m >> 1) * 8);
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            const int n0 = 16 * (wn + kWarpsN * i);
            if (n0 < wd) {
              uint32_t bf[4];
              ldmatrix_x4(bf, ws + (n0 + (lane & 7) + (m >> 1) * 8) * sw + k16 + (m & 1) * 8);
              mma_bf16_16816(acc[i][0], af, bf[0], bf[1]);
              mma_bf16_16816(acc[i][1], af, bf[2], bf[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int k8 = 0; k8 < kKt / 2; k8 += 8) {
          const float* a0 = A + g * sa + c0 + k8 + t;
          uint32_t ah[4], al[4];
          split_tf32(a0[0], ah[0], al[0]);
          split_tf32(a0[8 * sa], ah[1], al[1]);
          split_tf32(a0[4], ah[2], al[2]);
          split_tf32(a0[8 * sa + 4], ah[3], al[3]);
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            const int n0 = 16 * (wn + kWarpsN * i);
            if (n0 < wd) {
#pragma unroll
              for (int n = 0; n < 2; ++n) {
                const float* wk = ws + (n0 + 8 * n + g) * sw + k8 + t;
                uint32_t bh0, bl0, bh1, bl1;
                split_tf32(wk[0], bh0, bl0);
                split_tf32(wk[4], bh1, bl1);
                mma_3xtf32(acc[i][n], acc2[i][n], ah, al, bh0, bh1, bl0, bl1);
              }
            }
          }
        }
      }
    }

    // channel group 1 leaves its sums in the stages' memory, group 0 adds
    // them and b_out and writes out rows t0 + g (+ 8), columns dc0 + n0 +
    // 8n + 2t (+1)
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the stages
    float* red = reinterpret_cast<float*>(stg);  // [16][srows + 4]
    const int rs = a.srows + 4;
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += acc2[i][n][e];
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * (wn + kWarpsN * i) + 8 * n + 2 * t;
          if (col < wd)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(red + (g + 8 * h) * rs + col) =
                  make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
        }
    }
    __syncthreads();
    if (kg == 0) {
      Tin* out = static_cast<Tin*>(a.out) + ((size_t)b * T + t0) * D;
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * (wn + kWarpsN * i) + 8 * n + 2 * t;
          if (col < wd) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = g + 8 * h;
              const float2 o = *reinterpret_cast<const float2*>(red + r * rs + col);
              const float x[2] = {acc[i][n][2 * h] + o.x, acc[i][n][2 * h + 1] + o.y};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int d = dc0 + col + e;
                if (r < nrows && d < d_hi)
                  out[(size_t)r * D + d] =
                      from_f32<Tin>(x[e] + (a.b_out != nullptr ? a.b_out[d] : 0.f));
              }
            }
          }
        }
    }
    __syncthreads();  // the sums are read before the next pass refills the stages
  }
}

template <typename Tin>
int launch_typed(Args a, cudaStream_t stream) {
  const int elem = (int)sizeof(Tin), max_smem = max_optin_smem();
  const int units = a.B * ((a.T + kRows - 1) / kRows);
  // D split where the SMs would idle
  a.split = plan_split(units, a.D, 16, sm_count());
  a.cols = a.split.w_main > a.split.w_tail ? a.split.w_main : a.split.w_tail;
  // three stages, else two
  a.stages = 3;
  smem_layout(a, elem);
  if (a.bytes > max_smem) {
    a.stages = 2;
    smem_layout(a, elem);
  }
  if (a.bytes > max_smem) return (int)cudaErrorInvalidValue;
  auto kern = conv_glu_kernel<Tin>;
  const cudaError_t e = allow_smem(kern, a.bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<split_blocks(a.split, units), kThreads, a.bytes, stream>>>(a);
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
  Args a{};
  a.proj = proj;
  a.mask = static_cast<const uint8_t*>(mask);
  a.w = static_cast<const float*>(w);
  a.bconv = static_cast<const float*>(b);
  a.w_out = w_out;
  a.b_out = static_cast<const float*>(b_out);
  a.out = out;
  a.T = T;
  a.C = C;
  a.K = K;
  a.D = D;
  a.B = B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<__nv_bfloat16>(a, s);
  return launch_typed<float>(a, s);
}
