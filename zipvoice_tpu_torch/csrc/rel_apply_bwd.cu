// B3: the flash backward of the shared-probabilities attention consumer
// (TPU kernel zipvoice_tpu/ops/attention.py `_pallas_rel_apply_bwd`).  The
// kernels and their design are in rel_apply_bwd.cuh.  This file builds them
// for f32 inputs with the C entry point; rel_apply_bwd_bf16.cu, linked into
// the same library, for bf16 inputs, so that nvcc compiles the two halves
// side by side.

#include "rel_apply_bwd.cuh"

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does not
// take (QD not instantiated, PD != 4, VD > 384).  Tq query rows against Tk
// keys: q, pq, g (B,Tq,H,.); kt (B,H,QD,Tk); v (B,Tk,H,VD); pe
// (Tq+Tk-1,H,PD); mask (B,Tk) uint8 or null; stats (4,B,H,Tq); dq, dpq
// (B,Tq,H,.); dk, dv (B,Tk,H,.); dpe (Tq+Tk-1,H,PD), zeroed by the caller
// (the batch sum is accumulated in it).  The penalty acts on key columns
// j < valid_cols only.
extern "C" int zv_rel_apply_bwd(const void* q, const void* kt, const void* pq,
                                const void* pe, const void* mask, const void* v,
                                const void* g, void* stats, void* dq, void* dk, void* dpq,
                                void* dpe, void* dv, int B, int Tq, int Tk, int H, int QD,
                                int PD, int VD, int bf16, int const_gate, int valid_cols,
                                float pen, float limit, void* stream) {
  if (bf16)
    return rel_apply_bwd_bf16(q, kt, pq, pe, mask, v, g, stats, dq, dk, dpq, dpe, dv, B, Tq, Tk,
                              H, QD, PD, VD, const_gate, valid_cols, pen, limit, stream);
  return launch_in<float>(q, kt, pq, pe, mask, v, g, stats, dq, dk, dpq, dpe, dv, B, Tq, Tk, H,
                          QD, PD, VD, const_gate, valid_cols, pen, limit, stream);
}
