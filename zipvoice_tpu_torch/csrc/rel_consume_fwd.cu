// B7: head 0's relative-position probabilities, recomputed and never
// written, rounded to v's dtype, @ the wide gated value stream v (B,T,C) on
// the tensor cores (TPU kernel zipvoice_tpu/ops/attention.py
// `rel_attention_head0_consume`, body `_head0_consume_kernel`).  The kernel
// and its design are in rel_wide_consume.cuh, which B5's wide route
// (rel_apply_wide.cu) shares: B7 is its case of one head walked (head 0),
// v and out rows of one head, out in v's dtype.

#include "rel_wide_consume.cuh"

// Plain C entry point (loaded through ctypes).  Returns a cudaError_t code:
// 0 on a clean launch; cudaErrorInvalidValue for a shape the kernel does
// not take (QD not instantiated, PD != 4, C not a multiple of 4, Tk too
// long for shared memory).  Tq query rows against Tk keys, as B1's tiles:
// q, pq: (B,Tq,H,QD/PD); kt0 (B,QD,Tk), head 0's keys; pe: (Tq+Tk-1,H,PD);
// mask: (B,Tk) uint8 or null; v (B,Tk,C) and out (B,Tq,C), all f32, or all
// bf16 if bf16.
extern "C" int zv_rel_head0_consume(const void* q, const void* kt0, const void* pq,
                                    const void* pe, const void* mask, const void* v, void* out,
                                    int B, int Tq, int Tk, int H, int QD, int PD, int C, int bf16,
                                    void* stream) {
  WideArgs a{};
  a.q = q;
  a.kt = kt0;
  a.pq = pq;
  a.pe = pe;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = out;
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.C = C;
  a.B = B;
  return bf16 ? launch_wide<__nv_bfloat16, __nv_bfloat16, false>(a, QD, PD, stream)
              : launch_wide<float, float, false>(a, QD, PD, stream);
}
