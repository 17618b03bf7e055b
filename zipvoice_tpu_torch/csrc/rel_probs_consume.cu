// B6: B1's probabilities written and, rounded to the probs dtype, @ v on
// the tensor cores (TPU kernel zipvoice_tpu/ops/attention.py
// `rel_attention_probs_consume`).  The kernel is B1's body with an epilogue
// (rel_probs.cuh), so its probabilities are B1's bit for bit.  This file
// builds it for f32 inputs; rel_probs_consume_bf16.cu, linked into the same
// library, for bf16 inputs, so that nvcc compiles the two halves side by
// side.

#include "rel_probs.cuh"

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (QD not instantiated, PD != 4, VD not a multiple of 4, Tk too long
// for shared memory).  Tq query rows against Tk keys, as B1's tiles
// (rel_probs.cuh): q, pq: (B,Tq,H,QD/PD); kt: (B,H,QD,Tk); pe:
// (Tq+Tk-1,H,PD); mask: (B,Tk) uint8 or null; v (B,Tk,H,VD) and out
// (B,Tq,H,VD) in the input type (bf16 if bf16); probs (B,H,Tq,Tk) in bf16
// if probs_bf16.
extern "C" int zv_rel_probs_consume(const void* q, const void* kt, const void* pq, const void* pe,
                                    const void* mask, const void* v, void* probs, void* out,
                                    int B, int Tq, int Tk, int H, int QD, int PD, int VD, int bf16,
                                    int probs_bf16, void* stream) {
  if (VD <= 0 || VD % 4 != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return rel_probs_consume_bf16(q, kt, pq, pe, mask, v, probs, out, B, Tq, Tk, H, QD, PD, VD,
                                  probs_bf16, stream);
  return launch_in<Epi::kConsume, float>(q, kt, pq, pe, mask, probs, B, Tq, Tk, H, QD, PD,
                                         probs_bf16, ConsumeArgs{v, out, VD, 0, 0}, DsArgs{},
                                         stream);
}
