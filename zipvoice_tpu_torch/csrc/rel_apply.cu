// B5: softmax of the relative-position scores @ v with the const-attention
// gate (TPU kernel zipvoice_tpu/ops/attention.py `_pallas_rel_apply`, body
// `_apply_kernel`, probabilities `_apply_probs`):
//
//   p    = softmax_j( q_i.k_j + pq_i.pe[j - i + T - 1] + bias_j )   (f32)
//   used = const_gate ? (p > 0) / max(count(p > 0), 1e-20) : p
//   out  = round_to(v's dtype, used) @ v                        (f32 sums)
//
// out (B,T,H,VD) in out_dtype; nothing else is written.  Two routes, chosen
// here by VD:
//   * VD <= kNarrowVD: B1's kernel body with B5's epilogue (rel_probs.cuh,
//     "B5's epilogue"): B6 without the probabilities' store, so with the
//     gate closed and out in v's dtype its output is B6's bit for bit.
//     This file builds it for f32 inputs, rel_apply_bf16.cu for bf16 ones;
//   * VD > kNarrowVD: the wide consume kernel of rel_wide_consume.cuh (B7's,
//     on every (b, h)), built by rel_apply_wide.cu: at H = 1 its output is
//     B7's on v[:, :, 0] bit for bit.
// Both take B1's f32 p and its support p > 0, which B3, B5's backward
// (rel_apply_bwd.cu), recomputes under the gate.  The three files build
// side by side into one library.

#include "rel_probs.cuh"

// The widest V of the narrow route.  tools/time_rel_attention.py
// --crossover builds this file with ZV_NARROW_VD set, to time the two
// routes at one width (PERF.md); the library's own build leaves it unset.
#ifndef ZV_NARROW_VD
#define ZV_NARROW_VD 64
#endif

namespace {

constexpr int kNarrowVD = ZV_NARROW_VD;

}  // namespace

// The other routes, linked beside this file: the narrow one for bf16 inputs
// (rel_apply_bf16.cu) and the wide one (rel_apply_wide.cu), both with
// zv_rel_apply's arguments
int rel_apply_bf16(const void* q, const void* kt, const void* pq, const void* pe,
                   const void* mask, const void* v, void* out, int B, int T, int H, int QD,
                   int PD, int VD, int out_bf16, int const_gate, void* stream);
int rel_apply_wide(const void* q, const void* kt, const void* pq, const void* pe,
                   const void* mask, const void* v, void* out, int B, int T, int H, int QD,
                   int PD, int VD, int bf16, int out_bf16, int const_gate, void* stream);

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernels do not
// take (QD not instantiated, PD != 4, VD not a multiple of 4, T too long
// for shared memory).  q, pq: (B,T,H,QD/PD); kt: (B,H,QD,T); pe:
// (2T-1,H,PD); mask: (B,T) uint8 or null; v (B,T,H,VD); q, kt, pq, pe and v
// bf16 if bf16 (else f32); out (B,T,H,VD) in bf16 if out_bf16.
extern "C" int zv_rel_apply(const void* q, const void* kt, const void* pq, const void* pe,
                            const void* mask, const void* v, void* out, int B, int T, int H,
                            int QD, int PD, int VD, int bf16, int out_bf16, int const_gate,
                            void* stream) {
  if (VD <= 0 || VD % 4 != 0) return (int)cudaErrorInvalidValue;
  if (VD > kNarrowVD)
    return rel_apply_wide(q, kt, pq, pe, mask, v, out, B, T, H, QD, PD, VD, bf16, out_bf16,
                          const_gate, stream);
  if (bf16)
    return rel_apply_bf16(q, kt, pq, pe, mask, v, out, B, T, H, QD, PD, VD, out_bf16,
                          const_gate, stream);
  return launch_in<Epi::kApply, float>(q, kt, pq, pe, mask, nullptr, B, T, T, H, QD, PD,
                                       out_bf16, ConsumeArgs{v, out, VD, 0, 0}, DsArgs{}, stream,
                                       const_gate);
}
