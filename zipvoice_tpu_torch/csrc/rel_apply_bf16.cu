// B5's narrow route for bf16 inputs (see rel_apply.cu, whose entry point
// calls this; the library's sources build side by side).

#include "rel_probs.cuh"

int rel_apply_bf16(const void* q, const void* kt, const void* pq, const void* pe,
                   const void* mask, const void* v, void* out, int B, int T, int H, int QD,
                   int PD, int VD, int out_bf16, int const_gate, void* stream) {
  return launch_in<Epi::kApply, __nv_bfloat16>(q, kt, pq, pe, mask, nullptr, B, T, T, H, QD,
                                               PD, out_bf16, ConsumeArgs{v, out, VD, 0, 0},
                                               DsArgs{}, stream, const_gate);
}
