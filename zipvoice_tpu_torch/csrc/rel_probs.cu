// B1: relative-position attention probabilities (TPU kernel
// zipvoice_tpu/ops/attention.py `_pallas_rel_probs`).  The kernel and its
// design are in rel_probs.cuh, which B6 (rel_probs_consume.cu) and B4
// (rel_ds.cu) share.

#include "rel_probs.cuh"

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (QD not instantiated, PD != 4, Tk too long for shared memory).  Tq
// query rows against Tk keys: q, pq: (B,Tq,H,QD/PD); kt: (B,H,QD,Tk); pe:
// (Tq+Tk-1,H,PD); mask: (B,Tk) uint8 or null; out (B,H,Tq,Tk); in_bf16: q,
// kt, pq, pe are bf16 (else f32); out_bf16: out is bf16.
extern "C" int zv_rel_probs(const void* q, const void* kt, const void* pq, const void* pe,
                            const void* mask, void* out, int B, int Tq, int Tk, int H, int QD,
                            int PD, int in_bf16, int out_bf16, void* stream) {
  return in_bf16 ? launch_in<Epi::kProbs, __nv_bfloat16>(q, kt, pq, pe, mask, out, B, Tq, Tk, H,
                                                         QD, PD, out_bf16, ConsumeArgs{},
                                                         DsArgs{}, stream)
                 : launch_in<Epi::kProbs, float>(q, kt, pq, pe, mask, out, B, Tq, Tk, H, QD, PD,
                                                 out_bf16, ConsumeArgs{}, DsArgs{}, stream);
}
