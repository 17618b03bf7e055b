// Relative-position attention forwards with a fused probs @ V epilogue:
// B7 and B5.  (B6, which also writes the probabilities, is B1's kernel with
// an epilogue, in rel_probs.cu.)
//
// Each replaces a TPU kernel of zipvoice_tpu/ops/attention.py that is B1's
// row tile (p = softmax_j(q_i.k_j + pq_i.pe[j-i+T-1] + bias_j), scores and
// softmax in f32) followed by a contraction with a value stream:
//
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
// Every block owns `rows` (16) query rows and every key, exactly as B1
// (rel_common.cuh): the row tile is staged, the scores go to shared memory,
// one warp a row takes the softmax.  Any T: the ragged row tile is masked,
// nothing is padded (the TPU kernels pad T to 128 and the value width to
// 128 lanes).  VD must be a multiple of 4.
//
// B5 (`consume_tile`): what bounds it on an H100 is its contraction at the
// head-0 width.  The epilogue splits the contraction over (4-wide column
// group, key slice) work items: the column groups are padded to a power of two (12
// wide: 4 groups, 64 key slices; 384 wide: 128 groups, 2 slices), a thread
// reads float4s of v for kUnroll keys at once, the next kUnroll in flight
// while it sums these, into rows x 4 f32 sums in registers against
// shared-memory broadcasts of the probabilities; the slices of one warp
// meet by shuffles, and the partial sums of the warps (or key slices) add
// up in shared memory one after another, in a fixed order (no atomics).  A
// narrow V (VD <= 64) takes 256 threads a block, a wide one 512.
//
// B7 (`rel_head0_consume_kernel`): the contraction P (16 x T) @ v (T x C) is
// 2*16*T*C operations a block against 16*T*36 for the scores, so it runs on
// the tensor cores (tensor_core.cuh), 512 threads a block:
//   * the softmax leaves P, rounded to v's dtype, in its own shared-memory
//     tile with a padded row stride (conflict-free fragment loads) and zero
//     keys up to a multiple of the stage;
//   * v streams through 3 (or, where they do not fit, 2) stages of 64 (bf16)
//     or 32 (f32) keys x up to 384 columns, filled by coalesced 16-byte
//     `cp.async` (8-byte in bf16 when C is not a multiple of 8) whose
//     offsets a thread works out once a pass, keys past T zero-filled;
//     the stages take the row tile's memory once the softmax is done;
//   * warp = (key group, column warp): a column warp owns three pairs of n8
//     tiles and keeps their sums in registers; the two key groups take the
//     two halves of every stage, and their sums meet once, in shared
//     memory, at the end of a pass;
//   * bf16: `mma.sync.m16n8k16` on A fragments from `ldmatrix` of P and B
//     fragments from `ldmatrix.trans` of the v stage (the products are exact
//     in f32, so only the order of the f32 sum differs from the plain
//     version);
//   * f32: 3xTF32 (`mma.sync.m16n8k8` on operands split by masking), which
//     keeps the f32 tolerance where one TF32 product does not;
//   * the grid is (row tiles, B, column blocks): at short T a block takes a
//     slice of C (a multiple of 16 columns, chosen on the host from T, C and
//     the SM count) so that the card has up to a block an SM, and
//     recomputes its 16 rows' scores and softmax (16*T*36 MACs against
//     16*T*C / split for its share of the contraction).
// What bounds B7 on an H100: in f32 the three TF32 products and the v tiles
// every row block reads again from L2; in bf16 the scores and the per-stage
// waits (PERF.md).

#include <type_traits>

#include "rel_common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace zv;

// Threads a block: 256 for a narrow V; 512 for a wide one (VD > 64), whose
// contraction waits on memory with only one row tile a SM at serving
// shapes, and takes more warps to hide it (measured at B7's serving shape).
constexpr int kNarrow = 256, kWide = 512;
constexpr int kMaxRows = 16;
constexpr int kUnroll = 4;  // keys a thread loads at once in the epilogue

struct Args {
  const void *q, *kt, *pq, *pe, *v;
  const uint8_t* mask;
  void* out;
  int T, H, VD, rows, out_bf16, const_gate;
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
template <int QD, typename Tin, int NT>
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
  row_tile_scores<QD, Tin>(ktb, a.mask, qs, pqs, band, P, b, T, rows, nrows);
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
    if (a.const_gate) {
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

// B5: grid (row tiles, B*H)
template <int QD, typename Tin, int NT>
__global__ void __launch_bounds__(NT) rel_apply_kernel(Args a) {
  const int bh = blockIdx.y;
  consume_tile<QD, Tin, NT>(a, bh / a.H, bh % a.H, bh, a.H, bh % a.H);
}

template <int QD, typename Tin, int NT>
int launch_typed(Args a, int grid_y, cudaStream_t stream) {
  const int max_smem = max_optin_smem();
  // 16 rows as B1; fewer only where a long T's score rows do not fit
  a.rows = fit_rows(kMaxRows, max_smem, [&](int r) { return smem_floats(a.T, r, QD, a.VD); });
  const size_t smem = smem_floats(a.T, a.rows, QD, a.VD) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  auto kern = rel_apply_kernel<QD, Tin, NT>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((a.T + a.rows - 1) / a.rows, grid_y), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch(const Args& a, int grid_y, int QD, int PD, int bf16, void* stream) {
  if (PD != kPD || a.T <= 0 || a.H <= 0 || grid_y <= 0 || a.VD <= 0 || a.VD % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = a.VD > 64;
#define ZV_LAUNCH(QDV)                                                                  \
  if (bf16)                                                                             \
    return wide ? launch_typed<QDV, __nv_bfloat16, kWide>(a, grid_y, s)                 \
                : launch_typed<QDV, __nv_bfloat16, kNarrow>(a, grid_y, s);              \
  return wide ? launch_typed<QDV, float, kWide>(a, grid_y, s)                           \
              : launch_typed<QDV, float, kNarrow>(a, grid_y, s)
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

// ---------------------------------------------------------------------------
// B7: head 0's probabilities @ the wide value stream, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kH0Threads = 512, kH0Warps = kH0Threads / 32;
constexpr int kH0Groups = 2;  // key groups: each warp takes half of every stage's keys
constexpr int kH0WarpsN = kH0Warps / kH0Groups;  // warps that split the columns
constexpr int kH0Pairs = 3;   // pairs of n8 column tiles a warp owns
constexpr int kH0Chunk = kH0WarpsN * kH0Pairs * 16;  // columns a pass over the keys covers

// keys a stage of v holds: 64 (bf16) or 32 (f32), half of them for each
// key group; fewer, smaller stages measured slower (each stage costs a
// barrier and a wait, and the copies of a stage go out together)
__host__ __device__ constexpr int h0_keys(int elem) { return elem == 2 ? 64 : 32; }

struct H0Args {
  const void *q, *kt, *pq, *pe, *v;
  const uint8_t* mask;
  void* out;
  int T, H, C, B, rows;
  Split split;  // the blocks' (row tile, batch row) units and column blocks
  int cols;    // the most columns a block takes, a multiple of 16
  int sv;      // row stride of a v stage (elements), 8 mod 32
  int ps;      // row stride of the P tile (elements): 4 mod 32 (f32), 8 mod 32 (bf16)
  int p_off;   // byte offset of the P tile
  int bytes;
  int stages;  // stages of v in shared memory: 3, or 2 where 3 do not fit
};

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Shared memory: [row tile | scores, then the v stages over them once the
// softmax is done] [P].  P has min(rows + 1, 16) rows (row `rows` is zero
// and stands in for the missing rows of a short tile).  The stages also
// take the key groups' partial sums at the end of a pass.
inline void h0_layout(H0Args& a, int QD, int elem) {
  a.sv = round_up(a.cols < kH0Chunk ? a.cols : kH0Chunk, 32) + 8;
  a.ps = round_up(a.T, h0_keys(elem)) + (elem == 4 ? 4 : 8);  // keys up to Kp
  const int tile =
      (int)((row_tile_floats(a.T, a.rows, QD) + round4((size_t)a.rows * a.T)) * sizeof(float));
  const int stages = a.stages * h0_keys(elem) * a.sv * elem;
  a.p_off = round_up(tile > stages ? tile : stages, 128);
  a.bytes = a.p_off + (a.rows < 16 ? a.rows + 1 : 16) * a.ps * elem;
}

template <int QD, typename Tin>
__global__ void __launch_bounds__(kH0Threads, 1) rel_head0_consume_kernel(H0Args a) {
  constexpr bool kBf16 = std::is_same<Tin, __nv_bfloat16>::value;
  constexpr int kElem = (int)sizeof(Tin), kKeys = h0_keys(kElem);
  const int nst = a.stages;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int T = a.T, rows = a.rows, C = a.C;
  int unit, c_lo, c_hi;
  split_block(a.split, blockIdx.x, C, unit, c_lo, c_hi);
  const int tiles = (T + rows - 1) / rows, tile = unit / a.B, b = unit - tile * a.B;
  float* qs = reinterpret_cast<float*>(base);
  float* pqs = qs + rows * QD;
  float* band = pqs + rows * kPD;
  float* S = band + (size_t)(T + rows - 1) * kPD;
  Tin* stg = reinterpret_cast<Tin*>(base);  // over the row tile, after the softmax
  Tin* P = reinterpret_cast<Tin*>(base + a.p_off);
  const int i0 = tile * rows;
  const int nrows = min(rows, T - i0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Kp = round_up(T, kKeys), ns = Kp / kKeys, sv = a.sv, ps = a.ps;
  // each row tile starts its walk over the keys at its own stage, so that
  // the tiles of one batch row do not all read the same rows of v at once
  const int rot = (int)((long long)tile * ns / tiles);
  const Tin* vb = static_cast<const Tin*>(a.v) + (size_t)b * T * C;
  // 16-byte copies, or 8-byte ones where a bf16 row of v is 8-byte aligned only
  const bool wide = !kBf16 || C % 8 == 0;
  const int per = wide ? 16 / kElem : 4;  // elements a copy moves

  // stage s of a pass goes to buffer s % nst; keys past T are zero.
  // A thread's 16-byte copies are the same (key, column) slots in every
  // stage: their offsets are worked out once a pass.
  constexpr int kMaxU = 6;  // 16-byte copies a thread issues a stage: 64 x 48 / 512 (bf16)
  int u_key[kMaxU], u_smem[kMaxU], u_glob[kMaxU];
  int upr = 0, pass_c0 = 0;  // copies a key row; the pass's first column
  auto plan_pass = [&](int c0, int wc) {
    upr = wc / per;
    pass_c0 = c0;
#pragma unroll
    for (int i = 0; i < kMaxU; ++i) {
      const int u = threadIdx.x + i * kH0Threads, kk = u / upr, cu = u - kk * upr;
      u_key[i] = u < kKeys * upr ? kk : kKeys;  // kKeys: no copy
      u_smem[i] = kk * sv + cu * per;
      u_glob[i] = kk * C + c0 + cu * per;
    }
  };
  auto produce = [&](int s) {
    const int k0 = ((s + rot) % ns) * kKeys;
    Tin* dst = stg + (size_t)(s % nst) * kKeys * sv;
    const Tin* src = vb + (size_t)k0 * C;
    if (wide) {
#pragma unroll
      for (int i = 0; i < kMaxU; ++i) {
        if (u_key[i] < kKeys) {
          const bool valid = k0 + u_key[i] < T;
          cp_async16(dst + u_smem[i], valid ? src + u_glob[i] : vb, valid);
        }
      }
    } else {
      for (int u = threadIdx.x; u < kKeys * upr; u += kH0Threads) {
        const int kk = u / upr, cu = u - kk * upr;
        const bool valid = k0 + kk < T;
        cp_async8(dst + kk * sv + cu * per, valid ? src + (size_t)kk * C + pass_c0 + cu * per : vb,
                  valid);
      }
    }
    cp_async_commit();
  };
  // a pass's start: the columns of its last n16 tile past wc are zero in
  // every stage, then the first nst - 1 stages go out
  auto start_pass = [&](int c0) {
    const int wc = min(kH0Chunk, c_hi - c0), wz = round_up(wc, 16) - wc;
    for (int i = threadIdx.x; i < nst * kKeys * wz; i += kH0Threads) {
      const int row = i / wz;
      stg[(size_t)row * sv + wc + (i - row * wz)] = from_f32<Tin>(0.f);
    }
    plan_pass(c0, wc);
    for (int s = 0; s < nst - 1; ++s) {
      if (s < ns)
        produce(s);
      else
        cp_async_commit();
    }
  };

  stage_row_tile<QD>(static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.pq),
                     static_cast<const Tin*>(a.pe), qs, pqs, band, b, 0, T, a.H, i0, rows);
  __syncthreads();
  row_tile_scores<QD, Tin>(static_cast<const Tin*>(a.kt) + (size_t)b * QD * T, a.mask,
                                 qs, pqs, band, S, b, T, rows, nrows);
  __syncthreads();

  // softmax, one warp a row (B1's operations), into the P tile rounded to
  // v's dtype; keys T .. Kp-1 and the rows past the tile are zero
  const int prows = rows < 16 ? rows + 1 : 16;
  for (int r = warp; r < prows; r += kH0Warps) {
    Tin* prow_out = P + (size_t)r * ps;
    int j0 = 0;
    if (r < nrows) {
      float* prow = S + (size_t)r * T;
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
      for (int j = lane; j < T; j += 32) prow_out[j] = from_f32<Tin>(prow[j] * inv);
      j0 = T;
    }
    for (int j = j0 + lane; j < Kp; j += 32) prow_out[j] = from_f32<Tin>(0.f);
  }
  __syncthreads();  // P is complete; the row tile and the scores are dead

  // warp = (key group kg, column warp wn): wn owns pairs wn + 8i of n8
  // tiles; kg takes keys kg * kKeys / 2 .. of every stage
  const int wn = warp % kH0WarpsN, kg = warp / kH0WarpsN;
  const int g = lane >> 2, t = lane & 3, m = lane >> 3;
  auto prow_of = [&](int r) { return r < rows ? r : rows; };
  for (int c0 = c_lo; c0 < c_hi; c0 += kH0Chunk) {
    const int wc = min(kH0Chunk, c_hi - c0);
    start_pass(c0);

    // f32: the 3xTF32 big and small products in two sets of sums
    float acc[kH0Pairs][2][4], acc2[kH0Pairs][2][4];
#pragma unroll
    for (int i = 0; i < kH0Pairs; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = acc2[i][n][e] = 0.f;

    for (int s = 0; s < ns; ++s) {
      if (nst == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // stage s has landed; stage s - 1's buffer is consumed
      if (s + nst - 1 < ns)
        produce(s + nst - 1);
      else
        cp_async_commit();
      const int kh = kg * (kKeys / 2);  // this key group's keys in the stage
      const Tin* vs = stg + (size_t)(s % nst) * kKeys * sv + kh * sv;
      const int k0 = ((s + rot) % ns) * kKeys + kh;
      if constexpr (kBf16) {
#pragma unroll
        for (int kq = 0; kq < kKeys / 2; kq += 16) {
          uint32_t af[4];
          ldmatrix_x4(af, P + (size_t)prow_of((lane & 7) + (m & 1) * 8) * ps + k0 + kq +
                              (m >> 1) * 8);
#pragma unroll
          for (int i = 0; i < kH0Pairs; ++i) {
            const int n0 = 16 * (wn + kH0WarpsN * i);
            if (n0 < wc) {
              uint32_t bf[4];
              ldmatrix_x4_trans(
                  bf, vs + (kq + (lane & 7) + (m & 1) * 8) * sv + n0 + (m >> 1) * 8);
              mma_bf16_16816(acc[i][0], af, bf[0], bf[1]);
              mma_bf16_16816(acc[i][1], af, bf[2], bf[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kq = 0; kq < kKeys / 2; kq += 8) {
          const float* pr0 = P + (size_t)prow_of(g) * ps + k0 + kq + t;
          const float* pr1 = P + (size_t)prow_of(g + 8) * ps + k0 + kq + t;
          uint32_t ah[4], al[4];
          split_tf32(pr0[0], ah[0], al[0]);
          split_tf32(pr1[0], ah[1], al[1]);
          split_tf32(pr0[4], ah[2], al[2]);
          split_tf32(pr1[4], ah[3], al[3]);
#pragma unroll
          for (int i = 0; i < kH0Pairs; ++i) {
            const int n0 = 16 * (wn + kH0WarpsN * i);
            if (n0 < wc) {
#pragma unroll
              for (int n = 0; n < 2; ++n) {
                const float* vk = vs + (kq + t) * sv + n0 + 8 * n + g;
                uint32_t bh0, bl0, bh1, bl1;
                split_tf32(vk[0], bh0, bl0);
                split_tf32(vk[4 * sv], bh1, bl1);
                mma_3xtf32(acc[i][n], acc2[i][n], ah, al, bh0, bh1, bl0, bl1);
              }
            }
          }
        }
      }
    }

    // key group 1 leaves its sums in the stages' memory, key group 0 adds
    // them and writes out rows i0 + g (+ 8), columns c0 + n0 + 8n + 2t (+1)
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the stages
    float* red = reinterpret_cast<float*>(stg);  // [16][sv]
#pragma unroll
    for (int i = 0; i < kH0Pairs; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += acc2[i][n][e];
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < kH0Pairs; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * (wn + kH0WarpsN * i) + 8 * n + 2 * t;
          if (col < wc)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(red + (g + 8 * h) * sv + col) =
                  make_float2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
        }
    }
    __syncthreads();
    if (kg == 0) {
      Tin* out = static_cast<Tin*>(a.out) + ((size_t)b * T + i0) * C + c0;
#pragma unroll
      for (int i = 0; i < kH0Pairs; ++i)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * (wn + kH0WarpsN * i) + 8 * n + 2 * t;
          if (col < wc) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = g + 8 * h;
              const float2 o = *reinterpret_cast<const float2*>(red + r * sv + col);
              const float x0 = acc[i][n][2 * h] + o.x, x1 = acc[i][n][2 * h + 1] + o.y;
              if (r < nrows) {
                if constexpr (kBf16)
                  *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * C + col) =
                      __floats2bfloat162_rn(x0, x1);
                else
                  *reinterpret_cast<float2*>(out + (size_t)r * C + col) = make_float2(x0, x1);
              }
            }
          }
        }
    }
    __syncthreads();  // the sums are read before the next pass refills the stages
  }
}

template <int QD, typename Tin>
int launch_head0_typed(H0Args a, cudaStream_t stream) {
  const int max_smem = max_optin_smem(), sms = sm_count();
  const int elem = (int)sizeof(Tin);
  // the grid for `rows` rows a block (C split where the SMs would idle),
  // and its shared memory
  auto layout = [&](int rows, int stages) {
    H0Args x = a;
    x.rows = rows;
    x.stages = stages;
    x.split = plan_split(a.B * ((a.T + rows - 1) / rows), a.C, 16, sms);
    x.cols = x.split.w_main > x.split.w_tail ? x.split.w_main : x.split.w_tail;
    h0_layout(x, QD, elem);
    return x;
  };
  // 16 rows (the mma's m) with three stages, else two; fewer rows only
  // where a long T's score rows do not fit even so
  a = layout(kMaxRows, 3);
  if (a.bytes > max_smem) {
    a = layout(fit_rows(kMaxRows, max_smem,
                        [&](int r) { return (size_t)(layout(r, 2).bytes + 3) / 4; }),
               2);
    if (a.bytes > max_smem) return (int)cudaErrorInvalidValue;
  }
  auto kern = rel_head0_consume_kernel<QD, Tin>;
  const cudaError_t e = allow_smem(kern, a.bytes);
  if (e != cudaSuccess) return (int)e;
  const int units = a.B * ((a.T + a.rows - 1) / a.rows);
  kern<<<split_blocks(a.split, units), kH0Threads, a.bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_head0(const H0Args& a, int QD, int PD, int bf16, void* stream) {
  if (PD != kPD || a.T <= 0 || a.H <= 0 || a.B <= 0 || a.C <= 0 || a.C % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZV_LAUNCH(QDV)                                                 \
  return bf16 ? launch_head0_typed<QDV, __nv_bfloat16>(a, s)           \
              : launch_head0_typed<QDV, float>(a, s)
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

// B7: kt0 (B,QD,T), head 0's keys; v (B,T,C); out (B,T,C) in v's dtype.
extern "C" int zv_rel_head0_consume(const void* q, const void* kt0, const void* pq,
                                    const void* pe, const void* mask, const void* v, void* out,
                                    int B, int T, int H, int QD, int PD, int C, int bf16,
                                    void* stream) {
  H0Args a{};
  a.q = q;
  a.kt = kt0;
  a.pq = pq;
  a.pe = pe;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = out;
  a.T = T;
  a.H = H;
  a.C = C;
  a.B = B;
  return launch_head0(a, QD, PD, bf16, stream);
}

// B5: kt (B,H,QD,T); v (B,T,H,VD); out (B,T,H,VD) in bf16 if out_bf16.
extern "C" int zv_rel_apply(const void* q, const void* kt, const void* pq, const void* pe,
                            const void* mask, const void* v, void* out, int B, int T, int H,
                            int QD, int PD, int VD, int bf16, int out_bf16, int const_gate,
                            void* stream) {
  const Args a{q, kt, pq, pe, v, static_cast<const uint8_t*>(mask), out,
               T, H, VD, 0, out_bf16, const_gate};
  return launch(a, B * H, QD, PD, bf16, stream);
}
