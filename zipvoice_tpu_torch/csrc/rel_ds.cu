// B4: the score cotangent of the relative-position attention probabilities
// (TPU kernel zipvoice_tpu/ops/attention.py `_pallas_rel_ds`, body
// `_bwd_kernel`), B1's backward with the probabilities recomputed:
//
//   ds[i,j] = p[i,j] * (g[i,j] - sum_j' g[i,j'] p[i,j'])
//             + pen * sign(s[i,j]) * (|s[i,j]| > limit)
//
// with s the pre-mask score.  The kernel is B1's body with a score-cotangent
// epilogue (rel_probs.cuh, "B4's epilogue"), so its probabilities are B1's
// bit for bit, at any Tq rows against Tk keys as B1's are (a rank's rows
// under sequence-parallel training); this file builds its 40
// instantiations (output type = input type) beside B1's and B6's
// libraries.

#include "rel_probs.cuh"

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (QD not instantiated, PD != 4, Tk too long for shared memory).  Tq
// query rows against Tk keys (B1's rectangular tile; Tq = Tk = T for a whole
// sequence): q, pq: (B,Tq,H,QD/PD); kt: (B,H,QD,Tk); pe: (Tq+Tk-1,H,PD);
// mask: (B,Tk) uint8 or null; g, ds: (B,H,Tq,Tk), 16-byte aligned; all
// tensors f32, or all bf16 if bf16; pen = 0 switches the failsafe penalty
// off.
extern "C" int zv_rel_ds(const void* q, const void* kt, const void* pq, const void* pe,
                         const void* mask, const void* g, void* ds, int B, int Tq, int Tk,
                         int H, int QD, int PD, int bf16, float pen, float limit, void* stream) {
  const DsArgs d{g, pen, limit, 1};
  return bf16 ? launch_in<Epi::kDs, __nv_bfloat16>(q, kt, pq, pe, mask, ds, B, Tq, Tk, H, QD, PD,
                                                   1, ConsumeArgs{}, d, stream)
              : launch_in<Epi::kDs, float>(q, kt, pq, pe, mask, ds, B, Tq, Tk, H, QD, PD, 0,
                                           ConsumeArgs{}, d, stream);
}
