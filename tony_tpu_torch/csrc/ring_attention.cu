// Ring attention steps: forward (B9) and backward (B10, a dq entry and a dk/dv entry).
//
// Replaces the Pallas TPU kernels of tony_tpu/ops/ring.py:
//   tt_ring_fwd_step     <- `_ring_fwd_kernel` (:83, launched at :347 in `_ring_fwd`)
//   tt_ring_bwd_dq_step  <- `_ring_bwd_kernel` (:380, launched at :720 in `_ring_bwd`):
//   tt_ring_bwd_dkv_step    its dq and its riding dk/dv accumulations.
//
// On the TPU each is one kernel per device that runs the whole ring: KV shards move by remote
// DMA between double-buffered HBM slots while the kernel computes on the slot it holds. A
// CUDA kernel cannot issue that neighbour exchange itself, so the port splits the work: one
// launch per (held shard, ring step), and the transport (tony_tpu_torch/parallel/
// collectives.py) moves the slots between launches.
//
// The kernels are attention_kernels.cuh's, in their ring-step mode. One step of shard `my`
// holding the KV shard `src` (per-shard length Tl) has queries at global positions
// qpos0 + r (qpos0 = my * Tl) and keys at kpos0 + c (kpos0 = src * Tl); the causal mask, the
// window and the segment ids (segq the shard's own, segk the all-gathered global table) apply
// in global positions. The forward folds the KV shard into the f32 state (acc, m, l) and on
// the last step writes o and lse (ring.py:243-248); the backward adds into f32 dq and the
// riding f32 dk/dv. Tiles wholly outside the causal band or the window are skipped
// (ring.py:187-196), and so are tiles whose query and key rows share no segment; the caller
// skips whole steps (ring.py:260-272). Bound: operations, as flash attention's: a full step
// of Tl 4096 at H 32, Hkv 8, D 128 is 0.27 TFLOP forward to 0.55 TFLOP dk/dv against 50-150
// MB of traffic, ~5,000 flop/B against the ridge's ~295. In bf16 each step is the header's
// warp-specialised Hopper kernel (TMA into a ring of stages, wgmma into register
// accumulators, the softmax and dS in registers), and the f32 state is read into registers
// once at the start of a block and written once at its end.

#include "attention_kernels.cuh"

namespace {

Args step_args(const void* q, const void* k, const void* v, const int* segq, const int* segk,
               int B, int H, int Hkv, int Tl, int P, int Tseg, int qpos0, int kpos0, int causal,
               int window, float scale, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.segq = segq;
  a.segk = segk;
  a.B = B;
  a.gm = Geom{H, Hkv, P, Tseg};
  a.sp = Span{Tl, Tl, causal, window, qpos0, kpos0};
  a.scale = scale;
  a.stream = (cudaStream_t)stream;
  return a;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. q/do/o [B, H, P, Dh] at this shard's first row, k/v
// [B, Hkv, Tl, Dh], segq [B, P] at the shard's first row and segk [B, Tseg] (both NULL
// without segments), f32 acc/dq [B, H, P, Dh], m/l/lse/delta [B, H, P], f32 dk/dv
// [B, Hkv, Tl, Dh]. Each returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for what it does not take).
extern "C" int tt_ring_fwd_step(const void* q, const void* k, const void* v, const int* segq,
                                const int* segk, float* acc, float* m, float* l, void* o,
                                float* lse, int B, int H, int Hkv, int Tl, int P, int Tseg,
                                int qpos0, int kpos0, int causal, int window, int first, int last,
                                int Dh, float scale, int dtype, void* stream) {
  Args a = step_args(q, k, v, segq, segk, B, H, Hkv, Tl, P, Tseg, qpos0, kpos0, causal, window,
                     scale, stream);
  a.acc = acc;
  a.m = m;
  a.l = l;
  a.o = o;
  a.lse_out = lse;
  a.first = first;
  a.last = last;
  return dispatch<Fwd, true>(a, Dh, dtype);
}

extern "C" int tt_ring_bwd_dq_step(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, const int* segq,
                                   const int* segk, float* dq, int B, int H, int Hkv, int Tl, int P,
                                   int Tseg, int qpos0, int kpos0, int causal, int window, int Dh,
                                   float scale, int dtype, void* stream) {
  Args a = step_args(q, k, v, segq, segk, B, H, Hkv, Tl, P, Tseg, qpos0, kpos0, causal, window,
                     scale, stream);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dq = dq;
  return dispatch<Dq, true>(a, Dh, dtype);
}

extern "C" int tt_ring_bwd_dkv_step(const void* q, const void* k, const void* v, const void* dout,
                                    const float* lse, const float* delta, const int* segq,
                                    const int* segk, float* dk, float* dv, int B, int H, int Hkv,
                                    int Tl, int P, int Tseg, int qpos0, int kpos0, int causal,
                                    int window, int Dh, float scale, int dtype, void* stream) {
  Args a = step_args(q, k, v, segq, segk, B, H, Hkv, Tl, P, Tseg, qpos0, kpos0, causal, window,
                     scale, stream);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return dispatch<Dkv, true>(a, Dh, dtype);
}
