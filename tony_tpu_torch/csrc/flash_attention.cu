// Flash attention for training: forward (B1), dq backward (B2), dk/dv backward (B3).
//
// Replaces the Pallas TPU kernels of tony_tpu/ops/attention.py:
//   tt_flash_fwd     <- `_flash_kernel` (:95, launched at :215)
//   tt_flash_bwd_dq  <- `_flash_bwd_dq_kernel` (:287, launched at :526)
//   tt_flash_bwd_dkv <- `_flash_bwd_dkv_kernel_resident` (:373, launched at :572)
//                       and `_flash_bwd_dkv_kernel` (:434, launched at :662): one kernel for both.
//
// The kernels are attention_kernels.cuh's, in their flash mode: one launch computes the
// whole function at positions 0, and o, lse, dq, dk and dv are written once, in q's type
// (lse f32). The maths, the tiling and the bound are in that header. Bound: operations (the
// T x T scores stay on chip). In bf16 each kernel is a warp-specialised Hopper kernel: one
// producer warp keeps TMA loads of the next k (or q) tiles in flight behind mbarriers while
// two consumer warpgroups multiply with wgmma into register accumulators and run the
// softmax (or dS) in registers; tiles outside the causal band, the window or every shared
// segment are never loaded.

#include "attention_kernels.cuh"

namespace {

Args flash_args(const void* q, const void* k, const void* v, const int* seg, int B, int H,
                int Hkv, int Tq, int Tk, int causal, int window, float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.segq = a.segk = seg;
  a.B = B;
  a.gm = Geom{H, Hkv, Tq, Tk};
  a.sp = Span{Tq, Tk, causal, window, 0, 0};
  a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return a;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. q/o/dout [B, H, Tq, Dh], k/v [B, Hkv, Tk, Dh], lse and
// delta [B, H, Tq] f32, seg [B, T] int32 (Tq == Tk) or NULL; all contiguous. Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for what it does not take).
extern "C" int tt_flash_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
                            float* lse, int B, int H, int Hkv, int Tq, int Tk, int Dh, int causal,
                            int window, float scale, int dtype, void* stream) {
  Args a = flash_args(q, k, v, seg, B, H, Hkv, Tq, Tk, causal, window, scale, stream);
  a.o = o;
  a.lse_out = lse;
  return dispatch<Fwd, false>(a, Dh, dtype);
}

extern "C" int tt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, const int* seg, void* dq,
                               int B, int H, int Hkv, int Tq, int Tk, int Dh, int causal,
                               int window, float scale, int dtype, void* stream) {
  Args a = flash_args(q, k, v, seg, B, H, Hkv, Tq, Tk, causal, window, scale, stream);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dq = dq;
  return dispatch<Dq, false>(a, Dh, dtype);
}

extern "C" int tt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const int* seg, void* dk,
                                void* dv, int B, int H, int Hkv, int Tq, int Tk, int Dh,
                                int causal, int window, float scale, int dtype, void* stream) {
  Args a = flash_args(q, k, v, seg, B, H, Hkv, Tq, Tk, causal, window, scale, stream);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return dispatch<Dkv, false>(a, Dh, dtype);
}

// Dynamic shared memory of one block of a kernel (0 forward, 1 dq, 2 dk/dv) for head_dim Dh
// and dtype (0 bfloat16, 1 float32), the same for both modes; -1 for what they do not take.
extern "C" int tt_attention_smem_bytes(int kernel, int Dh, int dtype) {
  if (Dh != 64 && Dh != 128) return -1;
  if (dtype == 0) {
    if (kernel == 0) return (int)(Dh == 128 ? hop::FwdLayout<128>().bytes : hop::FwdLayout<64>().bytes);
    if (kernel == 1) return (int)(Dh == 128 ? hop::DqLayout<128>().bytes : hop::DqLayout<64>().bytes);
    if (kernel == 2) return (int)(Dh == 128 ? hop::DkvLayout<128>().bytes : hop::DkvLayout<64>().bytes);
  } else if (dtype == 1) {
    if (kernel == 0) return (int)(Dh == 128 ? simt::FwdSmem<128>().bytes : simt::FwdSmem<64>().bytes);
    if (kernel == 1 || kernel == 2)
      return (int)(Dh == 128 ? simt::BwdSmem<128>(kernel == 2).bytes : simt::BwdSmem<64>(kernel == 2).bytes);
  }
  return -1;
}
