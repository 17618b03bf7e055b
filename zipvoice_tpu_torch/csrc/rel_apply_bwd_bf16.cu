// B3 for bf16 inputs (see rel_apply_bwd.cu, whose entry point calls this;
// the two files build side by side into one library).

#include "rel_apply_bwd.cuh"

int rel_apply_bwd_bf16(const void* q, const void* kt, const void* pq, const void* pe,
                       const void* mask, const void* v, const void* g, void* stats, void* dq,
                       void* dk, void* dpq, void* dpe, void* dv, int B, int Tq, int Tk, int H,
                       int QD, int PD, int VD, int const_gate, int valid_cols, float pen,
                       float limit, void* stream) {
  return launch_in<__nv_bfloat16>(q, kt, pq, pe, mask, v, g, stats, dq, dk, dpq, dpe, dv, B, Tq,
                                  Tk, H, QD, PD, VD, const_gate, valid_cols, pen, limit, stream);
}
