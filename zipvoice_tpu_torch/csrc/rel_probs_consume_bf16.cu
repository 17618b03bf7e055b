// B6 for bf16 inputs (see rel_probs_consume.cu, whose entry point calls
// this; the two files build side by side into one library).

#include "rel_probs.cuh"

int rel_probs_consume_bf16(const void* q, const void* kt, const void* pq, const void* pe,
                           const void* mask, const void* v, void* probs, void* out, int B,
                           int Tq, int Tk, int H, int QD, int PD, int VD, int probs_bf16,
                           void* stream) {
  return launch_in<Epi::kConsume, __nv_bfloat16>(q, kt, pq, pe, mask, probs, B, Tq, Tk, H, QD,
                                                 PD, probs_bf16, ConsumeArgs{v, out, VD, 0, 0},
                                                 DsArgs{}, stream);
}
