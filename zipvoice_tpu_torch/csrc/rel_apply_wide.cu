// B5's wide route (VD > 64): the kernel of rel_wide_consume.cuh on every
// (b, h), with the const gate and out in out_dtype.  Linked into B5's
// library beside rel_apply.cu, whose entry point calls it, so that nvcc
// compiles it beside the narrow route's halves.

#include "rel_wide_consume.cuh"

int rel_apply_wide(const void* q, const void* kt, const void* pq, const void* pe,
                   const void* mask, const void* v, void* out, int B, int T, int H, int QD,
                   int PD, int VD, int bf16, int out_bf16, int const_gate, void* stream) {
  WideArgs a{};
  a.q = q;
  a.kt = kt;
  a.pq = pq;
  a.pe = pe;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = out;
  a.T = T;
  a.H = H;
  a.C = VD;
  a.B = B;
  a.nh = H;
  a.gate = const_gate;
  using bf = __nv_bfloat16;
  if (bf16)
    return out_bf16 ? launch_wide<bf, bf, true>(a, QD, PD, stream)
                    : launch_wide<bf, float, true>(a, QD, PD, stream);
  return out_bf16 ? launch_wide<float, bf, true>(a, QD, PD, stream)
                  : launch_wide<float, float, true>(a, QD, PD, stream);
}
