// The attention kernels for training, shared by flash attention (flash_attention.cu: B1 forward,
// B2 dq, B3 dk/dv) and the ring steps of context parallelism (ring_attention.cu: B9 forward,
// B10 dq and dk/dv). One body per kernel and element type; each source instantiates the mode
// it launches.
//
// Maths (identical to the TPU kernels): q [B, H, Tq, D], k/v [B, Hkv, Tk, D], query head h
// reads kv head h / (H / Hkv), never broadcast. Score s = scale * q.k with scale = D^-0.5.
// Query row r sits at global position i = qpos0 + r, key column c at j = kpos0 + c; i sees j
// when (not causal or i >= j) and (window <= 0 or i - j < window) and seg[i] == seg[j]
// (segment ids int32, optional). Flash attention launches with qpos0 = kpos0 = 0 and no
// Tk - Tq offset, as the TPU kernels; a ring step with its shards' offsets.
//   forward: an online softmax in f32 over the visible keys; o = acc / max(l, 1e-20) in q's
//     type and the per-row logsumexp lse = m + log(max(l, 1e-20)) [B, H, Tq] f32.
//   backward: p = exp(s - lse) recomputed, delta = rowsum(do * o) from the caller,
//     ds = p * (do.v - delta), dq = scale * sum_k ds.k, dk = scale * sum_q ds^T.q,
//     dv = sum_q p^T.do (dk/dv summed over the n_rep query heads of the kv head).
// A masked score gives p = 0 exactly, never exp(0) of a -1e30 row maximum, so a row whose
// first tiles are all masked (segments, windows) carries nothing into its sum.
// Any Tq, Tk >= 1: the last tile of each is ragged, its missing rows load as zeros and are
// masked out of every score, and nothing is stored past the end.
//
// Two modes, a template flag of each kernel:
//   flash (kStep false): one launch computes the whole function; o, lse, dq, dk, dv are
//     written in the input's type.
//   ring step (kStep true): one launch per (held shard, ring step) while the transport
//     moves KV between launches. The forward's online-softmax state acc [B, H, Tq, D],
//     m, l [B, H, Tq] stays in device memory in f32 between steps (the TPU kernel keeps it
//     in HBM scratch, tony_tpu/ops/ring.py:181-183, :250-252): `first` starts it (acc 0,
//     m -1e30, l 0), a middle step reads and writes it, `last` writes o and lse. The
//     backward adds into f32 accumulators: dq of the local queries, and the dk/dv that
//     ride the ring with their KV shard (ring.py:565-576). A block with nothing visible
//     leaves them as they are.
//
// Layouts: q-like tensors (q, do, o, acc, dq) are [B, H, P, D] with the launch's rows at the
// pointer (P >= Tq rows a (b, h) plane: the held shards of a process lie side by side along
// the sequence), the per-row vectors (lse, delta, m, l) [B, H, P]; segq [B, P]; k, v, dk, dv
// one contiguous [B, Hkv, Tk, D]; segk [B, Tseg], read from column kpos0. Flash attention
// has P = Tq, Tseg = Tk and one segment table for both.
//
// Bound on this card: operations. At the training shapes (T 2048 to 16384, D 128) a q tile
// does ~T/2 * 4 * D flops per 2 * D * 2 bytes it reads, far above the H100's ~295 flop/B
// ridge, so the aim is to keep the T x T scores on chip and feed the tensor cores at their
// rate. On Hopper the TPU's sequential grid dimension becomes a loop inside the block: the
// forward and dq take one block per (b*h, 128 query rows) and walk the k tiles from the
// window's start up to the causal diagonal; dk/dv takes one block per (b*hkv, 128 key rows)
// and walks the group's n_rep heads and only the q tiles that reach it. Each block owns the
// rows it writes: no atomics, so the result is the same bits from run to run.
//
// bf16 (the training path), one design for all three kernels:
//   - warp specialisation: 384 threads, two consumer warpgroups (64 rows each; setmaxnreg
//     raises them to 240 registers) and a producer warpgroup (lowered to 24) of which one warp
//     works: it alone decides which tiles the block visits (the causal and window bounds of
//     Span::k_range / q_range, then the segment skip) and keeps TMA loads in flight into a
//     ring of stages behind full/empty mbarriers. It writes each stage's tile index (and a
//     final sentinel -1) beside the stage, so a skipped tile never puts the two sides'
//     barrier phases out of step. (Two other splits stalled on the H100: 288 threads with a
//     lone producer warp at 56 registers, and 384 with the producer at 32, which leaves no
//     slack in the 64K register file.)
//   - TMA (cp.async.bulk.tensor) with the 128-byte swizzle in boxes 64 columns wide (two per
//     row at D 128), from tensor maps built on the host for each launch: q-like tensors seen
//     as [B*H, Tq, D] with a plane pitch of P rows, k/v as [B*Hkv, Tk, D], so rows past Tq
//     or Tk load as zeros and no load reaches the next held shard;
//   - wgmma.mma_async with f32 accumulators in registers: q.k^T, do.v^T, k.q^T, v.do^T with
//     both operands from shared memory (K-major); p.v, ds.k, p^T.do and ds^T.q with P, dS,
//     P^T or dS^T converted to bf16 in registers as the A operand and the B tile read
//     MN-major. S, P, dP and dS never touch shared memory; the softmax runs in registers
//     (row max and sum over the 4 lanes that hold a row, exp2 with scale*log2(e) folded in);
//   - masking: the bitwise predicate Span() on each accumulator element, only on tiles that
//     cross the causal diagonal, the window's edge, a ragged end or a segment boundary (the
//     producer flags them); interior tiles skip it;
//   - segment skip: a (q tile, k tile) pair whose segment id ranges [min, max] do not
//     overlap is never loaded nor computed (exact for any ids).
//   Tiles and shared memory (D 128 / 64): forward 128 queries x 128 keys, q 32 / 16 KB plus
//   2 / 3 stages of k and v at 64 / 32 KB; dq 128 x 64, q and do 64 / 32 KB plus 3 stages of
//   k and v at 32 / 16 KB; dk/dv 128 keys x 64 queries, k and v 64 / 32 KB plus 3 stages of
//   q, do, lse, delta and segment ids at 33 / 17 KB: one block per SM (about 166 KB at D 128).
//   Each warpgroup runs its two products of a tile back to back (wait, then the softmax or
//   dS in registers); the other warpgroup's products fill the tensor cores meanwhile.
// f32 (tests, f32 runs) keeps a plain per-thread product over shared memory (32-row tiles).
// A ring step adds the f32 state (acc, dq, dk/dv) read and written once, small beside its
// Tq x Tk work.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>
#include <type_traits>

namespace {

constexpr int NREP_MAX = 8;
constexpr float NEG = -1e30f;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared-memory carving, the same on the host (size) and the device (offsets).
struct Arena {
  size_t off = 0;
  template <typename U>
  __host__ __device__ size_t take(size_t n, size_t align = 128) {
    off = (off + align - 1) / align * align;
    const size_t r = off;
    off += n * sizeof(U);
    return r;
  }
};

// Which (query row r, key column c) pairs of one launch are visible, in local indices.
// The predicate is bitwise, without branches: with `&&` the compiler's code for the score
// loops cost B2 up to 15% on the H100.
struct Span {
  int Tq, Tk, causal, window, qpos0, kpos0;
  __device__ __forceinline__ bool operator()(int r, int c, int si, int sj) const {
    const int i = qpos0 + r, j = kpos0 + c;
    return (r < Tq) & (c < Tk) & (!causal | (i >= j)) & ((window <= 0) | (i - j < window)) &
           (si == sj);
  }
  // k tiles [kb0, kb1) that a q tile starting at local row q0 reaches (forward, dq)
  template <int BQ, int BK>
  __device__ __forceinline__ void k_range(int q0, int& kb0, int& kb1) const {
    kb0 = 0;
    kb1 = cdiv(Tk, BK);
    if (causal) {
      const int hi = qpos0 + q0 + BQ - 1 - kpos0;  // last key any row of the tile may see
      kb1 = hi < 0 ? 0 : min(kb1, hi / BK + 1);
    }
    if (window > 0) {
      // first key any row of the tile sees; the TPU kernel's floor division of a negative
      // value is 0 after its clamp, and C's `/` truncates: keep lo > 0
      const int lo = qpos0 + q0 - window + 1 - kpos0;
      kb0 = lo > 0 ? lo / BK : 0;
    }
  }
  // q tiles [qb0, qb1) that reach a k tile starting at local key k0 (dk/dv): from the
  // diagonal (causal) to the window's end, the bounds of the TPU kernels
  // (tony_tpu/ops/attention.py:396-401, :603-608)
  template <int BQ, int BK>
  __device__ __forceinline__ void q_range(int k0, int& qb0, int& qb1) const {
    int lo = 0, end = Tq;
    if (causal) lo = max(0, kpos0 + k0 - qpos0);  // first row that sees the tile's first key
    if (window > 0) end = max(0, min(Tq, kpos0 + k0 + BK - 1 + window - qpos0));
    qb0 = lo / BQ;
    qb1 = cdiv(end, BQ);
  }
  // whether a tile of rows [q0, q0 + BQ) x columns [k0, k0 + BK) holds a pair that the
  // causal or window bound masks, or a row or column past the end
  template <int BQ, int BK>
  __device__ __forceinline__ bool edge(int q0, int k0) const {
    const int i0 = qpos0 + q0, j0 = kpos0 + k0;
    return (q0 + BQ > Tq) | (k0 + BK > Tk) | (causal && i0 < j0 + BK - 1) |
           (window > 0 && i0 + BQ - 1 - j0 >= window);
  }
};

// Heads and row pitches of one launch (see the header comment).
struct Geom {
  int H, Hkv, P, Tseg;
};

// One launch's arguments; the pointers a kernel does not use stay NULL.
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  const int *segq, *segk;
  float *acc, *m, *l;   // the forward's ring-step state
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B;
  Geom gm;
  Span sp;
  int first, last;
  float scale;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// =======================================================================================
// f32: a plain per-thread product over shared memory, 32-row tiles, 256 threads
namespace simt {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BQ = 32, BK = 32, LDS = BK + 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C[M][N] (+)= A'.B' over shared memory: A' is A [M][K] or, with AT, A stored [K][M]; B' is
// B [K][N] or, with BT, B stored [N][K].
template <int M, int N, int K, bool AT, bool BT>
__device__ __forceinline__ void block_mm(const float* A, int lda, const float* B, int ldb,
                                         float* C, int ldc, bool acc) {
  for (int i = threadIdx.x; i < M * N; i += NTHREADS) {
    const int m = i / N, n = i % N;
    float s = acc ? C[m * ldc + n] : 0.f;
    for (int kk = 0; kk < K; ++kk)
      s += (AT ? A[kk * lda + m] : A[m * lda + kk]) * (BT ? B[n * ldb + kk] : B[kk * ldb + n]);
    C[m * ldc + n] = s;
  }
}

// R rows of a row-major [*, D] matrix into shared memory [R][ld]; rows at or past `n`
// (the ragged end of the sequence) are zero.
template <int R, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src, int n) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < R * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) x = reinterpret_cast<const float4*>(src + (size_t)r * D)[c];
    reinterpret_cast<float4*>(dst + r * ld)[c] = x;
  }
}

// R per-row values starting at row0 of a [*, T] row (rows past T read `fill`).
template <typename U>
__device__ __forceinline__ void load_vec(U* dst, int R, const U* __restrict__ src, int row0, int T,
                                         U fill) {
  for (int i = threadIdx.x; i < R; i += NTHREADS) dst[i] = row0 + i < T ? src[row0 + i] : fill;
}

// segment ids of R rows from row0 (rows past T read 0); all 0 without segments
__device__ __forceinline__ void load_seg(int* dst, int R, const int* __restrict__ seg, int row0,
                                         int T) {
  if (seg != nullptr) load_vec(dst, R, seg, row0, T, 0);
  else
    for (int i = threadIdx.x; i < R; i += NTHREADS) dst[i] = 0;
}

// dst = v (flash) or dst += v (ring step)
template <bool kStep>
__device__ __forceinline__ void put(float& dst, float v) {
  if constexpr (kStep) dst += v;
  else dst = v;
}

template <int D>
struct FwdSmem {
  size_t q, k, v, s, o, m, l, alpha, segq, segk, bytes;
  __host__ __device__ FwdSmem() {
    Arena a;
    q = a.take<float>(BQ * (D + 4));
    k = a.take<float>(BK * (D + 4));
    v = a.take<float>(BK * (D + 4));
    s = a.take<float>(BQ * LDS);
    o = a.take<float>(BQ * (D + 4));
    m = a.take<float>(BQ);
    l = a.take<float>(BQ);
    alpha = a.take<float>(BQ);
    segq = a.take<int>(BQ);
    segk = a.take<int>(BK);
    bytes = a.off;
  }
};

template <int D, bool kStep>
__global__ void __launch_bounds__(NTHREADS)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const int* __restrict__ segq, const int* __restrict__ segk,
                float* __restrict__ acc, float* __restrict__ m, float* __restrict__ l,
                float* __restrict__ o, float* __restrict__ lse, Geom gm, Span sp, float scale,
                int first_step, int last_step) {
  constexpr int LDT = D + 4, LDO = D + 4;
  const bool first = !kStep || first_step, last = !kStep || last_step;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Tq = sp.Tq, Tk = sp.Tk;
  const int bh = blockIdx.y, b = bh / gm.H, g = (bh % gm.H) / (gm.H / gm.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest (diagonal) tiles first
  const int nq = min(BQ, Tq - q0);
  int kb0, kb1;
  sp.k_range<BQ, BK>(q0, kb0, kb1);
  if (kb0 >= kb1 && !first && !last) return;  // nothing of this step is visible: state stays

  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem<D> L;
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* Ks = reinterpret_cast<float*>(smem + L.k);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* S = reinterpret_cast<float*>(smem + L.s);  // P overwrites S in place
  float* O = reinterpret_cast<float*>(smem + L.o);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);
  int* sq = reinterpret_cast<int*>(smem + L.segq);
  int* sk = reinterpret_cast<int*>(smem + L.segk);

  const size_t row0 = (size_t)bh * gm.P + q0;  // this tile's first row in q, acc, o, m, l, lse
  const float* kg = k + (size_t)(b * gm.Hkv + g) * Tk * D;
  const float* vg = v + (size_t)(b * gm.Hkv + g) * Tk * D;
  load_rows<BQ, D>(Qs, LDT, q + row0 * D, nq);
  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D;
    O[r * LDO + i % D] = first || r >= nq ? 0.f : acc[(row0 + r) * D + i % D];
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    m_s[r] = first || r >= nq ? NEG : m[row0 + r];
    l_s[r] = first || r >= nq ? 0.f : l[row0 + r];
  }
  load_seg(sq, BQ, segq == nullptr ? nullptr : segq + (size_t)b * gm.P, q0, Tq);
  const int* skg = segk == nullptr ? nullptr : segk + (size_t)b * gm.Tseg + sp.kpos0;
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done with Ks / Vs / S
    load_rows<BK, D>(Ks, LDT, kg + (size_t)k0 * D, Tk - k0);
    load_rows<BK, D>(Vs, LDT, vg + (size_t)k0 * D, Tk - k0);
    load_seg(sk, BK, skg, k0, Tk);
    __syncthreads();
    block_mm<BQ, BK, D, false, true>(Qs, LDT, Ks, LDT, S, LDS, false);
    __syncthreads();
    // online softmax, one warp per row, one key per lane (BK = 32)
    for (int r = warp; r < BQ; r += NWARPS) {
      const bool ok = sp(q0 + r, k0 + lane, sq[r], sk[lane]);
      const float sv = S[r * LDS + lane] * scale;
      const float mx = warp_max(ok ? sv : NEG);
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      const float p = ok ? expf(sv - m_new) : 0.f;
      S[r * LDS + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        alpha_s[r] = al;
        l_s[r] = l_s[r] * al + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < BQ * D; i += NTHREADS) O[(i / D) * LDO + i % D] *= alpha_s[i / D];
    __syncthreads();
    block_mm<BQ, D, BK, false, false>(S, LDS, Vs, LDT, O, LDO, true);
  }
  __syncthreads();
  if (last) {
    float* og = o + row0 * D;
    for (int i = tid; i < nq * D; i += NTHREADS) {
      const int r = i / D;
      og[i] = O[r * LDO + i % D] / fmaxf(l_s[r], 1e-20f);
    }
    for (int r = tid; r < nq; r += NTHREADS) lse[row0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-20f));
  } else {
    for (int i = tid; i < nq * D; i += NTHREADS) acc[row0 * D + i] = O[(i / D) * LDO + i % D];
    for (int r = tid; r < nq; r += NTHREADS) {
      m[row0 + r] = m_s[r];
      l[row0 + r] = l_s[r];
    }
  }
}

template <int D>
struct BwdSmem {
  size_t q, dout, k, v, s, dp, acc1, acc2, lse, delta, segq, segk, bytes;
  __host__ __device__ BwdSmem(bool dkv) {
    Arena a;
    q = a.take<float>(BQ * (D + 4));
    dout = a.take<float>(BQ * (D + 4));
    k = a.take<float>(BK * (D + 4));
    v = a.take<float>(BK * (D + 4));
    s = a.take<float>(BQ * LDS);
    dp = a.take<float>(BQ * LDS);
    acc1 = a.take<float>(BQ * (D + 4));         // dq, or dk
    acc2 = dkv ? a.take<float>(BK * (D + 4)) : 0;  // dv
    lse = a.take<float>(BQ);
    delta = a.take<float>(BQ);
    segq = a.take<int>(BQ);
    segk = a.take<int>(BK);
    bytes = a.off;
  }
};

template <int D, bool kStep>
__global__ void __launch_bounds__(NTHREADS)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, const int* __restrict__ segq,
                   const int* __restrict__ segk, float* __restrict__ dq, Geom gm, Span sp,
                   float scale) {
  constexpr int LDT = D + 4, LDO = D + 4;
  const int tid = threadIdx.x;
  const int Tq = sp.Tq, Tk = sp.Tk;
  const int bh = blockIdx.y, b = bh / gm.H, g = (bh % gm.H) / (gm.H / gm.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int nq = min(BQ, Tq - q0);
  int kb0, kb1;
  sp.k_range<BQ, BK>(q0, kb0, kb1);
  // Nothing visible: a ring step adds nothing, flash attention writes 0.
  if (kb0 >= kb1) {
    if constexpr (!kStep)
      for (int i = tid; i < nq * D; i += NTHREADS) dq[((size_t)bh * gm.P + q0) * D + i] = 0.f;
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<D> L(false);
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* dOs = reinterpret_cast<float*>(smem + L.dout);
  float* Ks = reinterpret_cast<float*>(smem + L.k);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* S = reinterpret_cast<float*>(smem + L.s);
  float* dP = reinterpret_cast<float*>(smem + L.dp);  // dS overwrites dP in place
  float* dQ = reinterpret_cast<float*>(smem + L.acc1);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  int* sq = reinterpret_cast<int*>(smem + L.segq);
  int* sk = reinterpret_cast<int*>(smem + L.segk);

  const size_t row0 = (size_t)bh * gm.P + q0;
  const float* kg = k + (size_t)(b * gm.Hkv + g) * Tk * D;
  const float* vg = v + (size_t)(b * gm.Hkv + g) * Tk * D;
  load_rows<BQ, D>(Qs, LDT, q + row0 * D, nq);
  load_rows<BQ, D>(dOs, LDT, dout + row0 * D, nq);
  for (int i = tid; i < BQ * D; i += NTHREADS) dQ[(i / D) * LDO + i % D] = 0.f;
  load_vec(lse_s, BQ, lse + (size_t)bh * gm.P, q0, Tq, 0.f);
  load_vec(delta_s, BQ, delta + (size_t)bh * gm.P, q0, Tq, 0.f);
  load_seg(sq, BQ, segq == nullptr ? nullptr : segq + (size_t)b * gm.P, q0, Tq);
  const int* skg = segk == nullptr ? nullptr : segk + (size_t)b * gm.Tseg + sp.kpos0;
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    load_rows<BK, D>(Ks, LDT, kg + (size_t)k0 * D, Tk - k0);
    load_rows<BK, D>(Vs, LDT, vg + (size_t)k0 * D, Tk - k0);
    load_seg(sk, BK, skg, k0, Tk);
    __syncthreads();
    block_mm<BQ, BK, D, false, true>(Qs, LDT, Ks, LDT, S, LDS, false);    // q.k^T
    block_mm<BQ, BK, D, false, true>(dOs, LDT, Vs, LDT, dP, LDS, false);  // do.v^T
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const float p = sp(q0 + r, k0 + c, sq[r], sk[c]) ? expf(S[r * LDS + c] * scale - lse_s[r]) : 0.f;
      dP[r * LDS + c] = p * (dP[r * LDS + c] - delta_s[r]);
    }
    __syncthreads();
    block_mm<BQ, D, BK, false, false>(dP, LDS, Ks, LDT, dQ, LDO, true);  // ds.k
  }
  __syncthreads();
  float* dqg = dq + row0 * D;
  for (int i = tid; i < nq * D; i += NTHREADS) put<kStep>(dqg[i], scale * dQ[(i / D) * LDO + i % D]);
}

template <int D, bool kStep>
__global__ void __launch_bounds__(NTHREADS)
attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ segq,
                    const int* __restrict__ segk, float* __restrict__ dk, float* __restrict__ dv,
                    Geom gm, Span sp, float scale) {
  constexpr int LDT = D + 4, LDO = D + 4;
  const int tid = threadIdx.x;
  const int Tq = sp.Tq, Tk = sp.Tk;
  const int bg = blockIdx.y, b = bg / gm.Hkv, g = bg % gm.Hkv, n_rep = gm.H / gm.Hkv;
  const int k0 = blockIdx.x * BK;  // low k tiles see the most q tiles: they start first
  const int nk = min(BK, Tk - k0);
  int qb0, qb1;
  sp.q_range<BQ, BK>(k0, qb0, qb1);
  if (qb0 >= qb1) {  // no query reaches the tile: as in the dq kernel
    if constexpr (!kStep)
      for (int i = tid; i < nk * D; i += NTHREADS) {
        const size_t at = ((size_t)bg * Tk + k0) * D + i;
        dk[at] = dv[at] = 0.f;
      }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<D> L(true);
  float* Ks = reinterpret_cast<float*>(smem + L.k);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* dOs = reinterpret_cast<float*>(smem + L.dout);
  float* S = reinterpret_cast<float*>(smem + L.s);    // P overwrites S in place
  float* dP = reinterpret_cast<float*>(smem + L.dp);  // dS overwrites dP in place
  float* dK = reinterpret_cast<float*>(smem + L.acc1);
  float* dV = reinterpret_cast<float*>(smem + L.acc2);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  int* sq = reinterpret_cast<int*>(smem + L.segq);
  int* sk = reinterpret_cast<int*>(smem + L.segk);

  const size_t krow0 = (size_t)bg * Tk + k0;
  load_rows<BK, D>(Ks, LDT, k + krow0 * D, nk);
  load_rows<BK, D>(Vs, LDT, v + krow0 * D, nk);
  for (int i = tid; i < BK * D; i += NTHREADS) {
    dK[(i / D) * LDO + i % D] = 0.f;
    dV[(i / D) * LDO + i % D] = 0.f;
  }
  load_seg(sk, BK, segk == nullptr ? nullptr : segk + (size_t)b * gm.Tseg + sp.kpos0, k0, Tk);
  for (int r = 0; r < n_rep; ++r) {
    const int bh = b * gm.H + g * n_rep + r;
    for (int qb = qb0; qb < qb1; ++qb) {
      const int q0 = qb * BQ;
      const int nq = min(BQ, Tq - q0);
      const size_t row0 = (size_t)bh * gm.P + q0;
      __syncthreads();  // the previous q tile's readers are done
      load_rows<BQ, D>(Qs, LDT, q + row0 * D, nq);
      load_rows<BQ, D>(dOs, LDT, dout + row0 * D, nq);
      load_vec(lse_s, BQ, lse + (size_t)bh * gm.P, q0, Tq, 0.f);
      load_vec(delta_s, BQ, delta + (size_t)bh * gm.P, q0, Tq, 0.f);
      load_seg(sq, BQ, segq == nullptr ? nullptr : segq + (size_t)b * gm.P, q0, Tq);
      __syncthreads();
      block_mm<BQ, BK, D, false, true>(Qs, LDT, Ks, LDT, S, LDS, false);    // q.k^T
      block_mm<BQ, BK, D, false, true>(dOs, LDT, Vs, LDT, dP, LDS, false);  // do.v^T
      __syncthreads();
      for (int i = tid; i < BQ * BK; i += NTHREADS) {
        const int rr = i / BK, c = i % BK;
        const float p = sp(q0 + rr, k0 + c, sq[rr], sk[c]) ? expf(S[rr * LDS + c] * scale - lse_s[rr])
                                                          : 0.f;
        S[rr * LDS + c] = p;
        dP[rr * LDS + c] = p * (dP[rr * LDS + c] - delta_s[rr]);
      }
      __syncthreads();
      block_mm<BK, D, BQ, true, false>(S, LDS, dOs, LDT, dV, LDO, true);   // p^T.do
      block_mm<BK, D, BQ, true, false>(dP, LDS, Qs, LDT, dK, LDO, true);  // ds^T.q
    }
  }
  __syncthreads();
  float* dkg = dk + krow0 * D;
  float* dvg = dv + krow0 * D;
  for (int i = tid; i < nk * D; i += NTHREADS) {
    const int off = (i / D) * LDO + i % D;
    put<kStep>(dkg[i], scale * dK[off]);
    put<kStep>(dvg[i], dV[off]);
  }
}

template <int D, bool kStep>
cudaError_t fwd(const Args& a) {
  const FwdSmem<D> L;
  auto kern = attn_fwd_kernel<D, kStep>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(a.sp.Tq, BQ), a.B * a.gm.H);
  kern<<<grid, NTHREADS, L.bytes, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, a.segq, a.segk, a.acc, a.m, a.l,
      (float*)a.o, a.lse_out, a.gm, a.sp, a.scale, a.first, a.last);
  return cudaGetLastError();
}

template <int D, bool kStep>
cudaError_t dq(const Args& a) {
  const BwdSmem<D> L(false);
  auto kern = attn_bwd_dq_kernel<D, kStep>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(a.sp.Tq, BQ), a.B * a.gm.H);
  kern<<<grid, NTHREADS, L.bytes, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.dout, a.lse_in,
      a.delta, a.segq, a.segk, (float*)a.dq, a.gm, a.sp, a.scale);
  return cudaGetLastError();
}

template <int D, bool kStep>
cudaError_t dkv(const Args& a) {
  const BwdSmem<D> L(true);
  auto kern = attn_bwd_dkv_kernel<D, kStep>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(a.sp.Tk, BK), a.B * a.gm.Hkv);
  kern<<<grid, NTHREADS, L.bytes, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.dout, a.lse_in,
      a.delta, a.segq, a.segk, (float*)a.dk, (float*)a.dv, a.gm, a.sp, a.scale);
  return cudaGetLastError();
}

}  // namespace simt

// =======================================================================================
// bf16: warp-specialised TMA + wgmma kernels for Hopper (sm_90a)
namespace hop {

using bf16 = __nv_bfloat16;
constexpr int NCONS = 256;              // two consumer warpgroups of 64 rows each
constexpr int NTHREADS = NCONS + 128;   // and the producer warpgroup, of which one warp works
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65536
constexpr float LOG2E = 1.4426950408889634f;

// -inf, the score of a masked pair
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the dynamic shared memory, its base raised to 1024 bytes (the 128-byte swizzle's period)
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
}

// -- mbarriers and TMA ------------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b)) : "memory");
}
// arrive and expect `bytes` more of TMA traffic on the barrier's current phase
__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool bar_try(uint64_t* b, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(saddr(b)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of parity `parity` to complete. The wait has no bound: a clock64 bound
// with a trap costs the dk/dv kernel 660 bytes of spills and ~3x its time on the H100.
__device__ __forceinline__ void bar_wait(uint64_t* b, int parity) {
  while (!bar_try(b, parity)) {
  }
}

// one box of a 3-D tensor map at (column c0, row c1, plane c2) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// R rows from row0 of one plane into a tile [D / 64][R][64]: one 128-byte-swizzled box of
// 64 columns each; rows past the map's end arrive as zeros
template <int R, int D>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map, uint64_t* bar, int row0,
                                         int plane) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h) tma_load(dst + h * R * 64, map, bar, h * 64, row0, plane);
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- wgmma ------------------------------------------------------------------------------
// d[64 x N] (+)= a.b over k 16 for one warpgroup. _ss: a and b from shared memory through
// descriptors (a K-major; b K-major for TB 0, MN-major for TB 1); _rs: a from registers, four
// bf16 pairs a thread in the accumulator's own layout. The accumulator d: thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8 for d[4j + 2], d[4j + 3]) at columns
// 8j + 2 (t % 4) (+ 1 for d[4j + 1], d[4j + 3]).

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of registers that an issued wgmma owns
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void pin(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Descriptor of a 128-byte-swizzled tile in shared memory: rows of 128 bytes, eight rows a
// 1024-byte atom (the stride between 8-row groups), `lbo` the stride between 64-column boxes
// (read only for an MN-major operand wider than 64).
__device__ __forceinline__ uint64_t sw128(const bf16* p, uint32_t lbo) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// c[64 x N] = a.b^T over k = D: a the warpgroup's 64 rows at `a` in a tile of RA rows, b the
// N rows of a tile of RB rows, both [D / 64][rows][64] as TMA leaves them (K-major). A k step
// of 16 columns is 32 bytes into the 128-byte swizzled row.
template <int N, int D, int RA, int RB>
__device__ __forceinline__ void mm_nt(float (&c)[N / 2], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(c, sw128(a + (kk / 4) * RA * 64 + (kk % 4) * 16, 16),
                sw128(b + (kk / 4) * RB * 64 + (kk % 4) * 16, 16), kk > 0);
}

// c[64 x D] += a.b: a [64 x K] bf16 in registers, b [K][D] rows of a tile of RB rows as TMA
// leaves it (MN-major: D runs along the swizzled rows). A k step of 16 is 16 rows, 2048 bytes.
template <int K, int D, int RB>
__device__ __forceinline__ void mm_rn(float (&c)[D / 2], uint32_t (&a)[K / 4], const bf16* b) {
#pragma unroll
  for (int t = 0; t < K / 16; ++t) wgmma_rs<1>(c, &a[4 * t], sw128(b + t * 16 * 64, RB * 128), 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A consumer thread's place in the accumulators of its warpgroup's 64 rows: `row` is the
// block-local row of c[4j], c[4j + 1] (row + 8 for c[4j + 2], c[4j + 3]), `col` the column
// of c[4j] in each block of 8 columns.
struct Frag {
  int wg, row, col, lane;
  __device__ explicit Frag(int t)
      : wg(t >> 7), row(((t >> 7) << 6) + (((t >> 5) & 3) << 4) + ((t & 31) >> 2)),
        col(2 * (t & 3)), lane(t & 31) {}
};

// the row sum or maximum over the 4 lanes that hold a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The producer warp's segment ids of R rows r0 .. r0 + n of a table (NULL: no segments, all
// 0), R / 32 a lane, and their [lo, hi] over the warp.
template <int R>
__device__ __forceinline__ void seg_ids(const int* seg, int r0, int n, int lane, int (&ids)[R / 32],
                                        int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < R / 32; ++i) {
    const int r = lane + 32 * i;
    ids[i] = seg != nullptr && r < n ? seg[r0 + r] : 0;
    if (r < n) {
      lo = min(lo, ids[i]);
      hi = max(hi, ids[i]);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// whether a tile needs the mask for its segments: the ids of its rows and its columns are not
// all one and the same
__device__ __forceinline__ bool mixed(int qlo, int qhi, int klo, int khi) {
  return !(qlo == qhi && klo == khi && qlo == klo);
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages, uint64_t* once) {
  for (int s = 0; s < stages; ++s) {
    bar_init(&full[s], 32);           // the producer warp's lanes, and the TMA bytes
    bar_init(&empty[s], NCONS / 32);  // one arrive per consumer warp
  }
  bar_init(once, 1);  // the block's resident tiles (q / do, or k / v)
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// -- forward: B1 (flash), B9 (ring step) ----------------------------------------------------

template <int D>
struct FwdLayout {
  static constexpr int BQ = 128, BK = 128, ST = D == 128 ? 2 : 3;
  size_t q, k, v, segk, tile, flag, full, empty, qbar, bytes;
  __host__ __device__ FwdLayout() {
    Arena a;
    q = a.take<bf16>(BQ * D, 1024);
    k = a.take<bf16>(ST * BK * D, 1024);
    v = a.take<bf16>(ST * BK * D, 1024);
    segk = a.take<int>(ST * BK);
    tile = a.take<int>(ST);
    flag = a.take<int>(ST);
    full = a.take<uint64_t>(ST, 8);
    empty = a.take<uint64_t>(ST, 8);
    qbar = a.take<uint64_t>(1, 8);
    bytes = a.off + 1024;  // and the base's alignment
  }
};

template <int D, bool kStep>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const int* __restrict__ segq,
                const int* __restrict__ segk, float* __restrict__ acc, float* __restrict__ m,
                float* __restrict__ l, bf16* __restrict__ o, float* __restrict__ lse, Geom gm,
                Span sp, float scale, int first_step, int last_step) {
  using L = FwdLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST;
  const L lay;
  unsigned char* smem = smem_base();
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  int* segk_s = reinterpret_cast<int*>(smem + lay.segk);
  int* tile_s = reinterpret_cast<int*>(smem + lay.tile);
  int* flag_s = reinterpret_cast<int*>(smem + lay.flag);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + lay.empty);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + lay.qbar);

  const bool first = !kStep || first_step, last = !kStep || last_step;
  const int Tq = sp.Tq, Tk = sp.Tk;
  const int bh = blockIdx.y, b = bh / gm.H, g = (bh % gm.H) / (gm.H / gm.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest (diagonal) tiles first
  const int nq = min(BQ, Tq - q0);
  if (threadIdx.x == 0) init_ring(full, empty, ST, qbar);
  __syncthreads();

  if (threadIdx.x >= NCONS) {  // the producer warpgroup: its first warp loads, the rest leave
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= NCONS + 32) return;
    const int lane = threadIdx.x & 31;
    const int* skg = segk == nullptr ? nullptr : segk + (size_t)b * gm.Tseg + sp.kpos0;
    int qids[BQ / 32], qlo, qhi;
    seg_ids<BQ>(segq == nullptr ? nullptr : segq + (size_t)b * gm.P, q0, nq, lane, qids, qlo, qhi);
    int kb0, kb1;
    sp.k_range<BQ, BK>(q0, kb0, kb1);
    int n = 0;
    for (int kb = kb0; kb < kb1; ++kb) {
      const int k0 = kb * BK;
      int ids[BK / 32], klo, khi;
      seg_ids<BK>(skg, k0, min(BK, Tk - k0), lane, ids, klo, khi);
      if (klo > qhi || khi < qlo) continue;  // no segment in common: skipped
      const int st = n % ST;
      bar_wait(&empty[st], ((n / ST) & 1) ^ 1);
      const bool mask = sp.edge<BQ, BK>(q0, k0) || mixed(qlo, qhi, klo, khi);
      if (mask) {
#pragma unroll
        for (int i = 0; i < BK / 32; ++i) segk_s[st * BK + lane + 32 * i] = ids[i];
      }
      if (lane == 0) {
        tile_s[st] = kb;
        flag_s[st] = mask;
        if (n == 0) {
          bar_arrive_tx(qbar, BQ * D * 2);
          tma_rows<BQ, D>(Qs, &tq, qbar, q0, bh);
        }
        bar_arrive_tx(&full[st], 2 * BK * D * 2);
        tma_rows<BK, D>(Ks + st * BK * D, &tk, &full[st], k0, b * gm.Hkv + g);
        tma_rows<BK, D>(Vs + st * BK * D, &tv, &full[st], k0, b * gm.Hkv + g);
      } else {
        bar_arrive(&full[st]);
      }
      ++n;
    }
    const int st = n % ST;  // the sentinel
    bar_wait(&empty[st], ((n / ST) & 1) ^ 1);
    if (lane == 0) tile_s[st] = -1;
    bar_arrive(&full[st]);
  } else {  // two consumer warpgroups
    regs_inc<CONSUMER_REGS>();
    const Frag f(threadIdx.x);
    const float c2 = scale * LOG2E;
    const size_t row0 = (size_t)bh * gm.P + q0;  // this tile's first row in acc, o, m, l, lse
    float oa[D / 2], mrow[2], lrow[2];  // lrow: this thread's part of the row sum
    int sqr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.row + 8 * h;
      const bool in = r < nq;
      sqr[h] = segq != nullptr && in ? segq[(size_t)b * gm.P + q0 + r] : 0;
      mrow[h] = first || !in ? NEG : m[row0 + r];
      lrow[h] = first || !in || (f.lane & 3) ? 0.f : l[row0 + r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        float2 x = make_float2(0.f, 0.f);
        if (!first && in) x = *reinterpret_cast<const float2*>(acc + (row0 + r) * D + 8 * j + f.col);
        oa[4 * j + 2 * h] = x.x;
        oa[4 * j + 2 * h + 1] = x.y;
      }
    }
    const bf16* Qw = Qs + f.wg * 64 * 64;
    int st = 0, ph = 0, visited = 0;
    for (;;) {
      bar_wait(&full[st], ph);
      const int kb = tile_s[st];
      if (kb < 0) break;
      if (visited == 0) bar_wait(qbar, 0);
      const int k0 = kb * BK;
      float s[BK / 2];
      wg_fence();
      mm_nt<BK, D, BQ, BK>(s, Qw, Ks + st * BK * D);
      wg_commit();
      wg_wait();
      pin(s);
      if (flag_s[st]) {
        const int* skt = segk_s + st * BK;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + f.col + (e & 1);
            if (!sp(q0 + f.row + 8 * (e >> 1), k0 + c, sqr[e >> 1], skt[c])) s[4 * j + e] = neg_inf();
          }
      }
      // online softmax in registers: m in scaled-score units, p = exp2(s * scale * log2e - m * log2e)
      float mx[2] = {neg_inf(), neg_inf()}, mb[2], al[2];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(mrow[h], quad_max(mx[h]) * scale);
        al[h] = ex2((mrow[h] - mn) * LOG2E);
        mrow[h] = mn;
        mb[h] = mn * LOG2E;
        lrow[h] *= al[h];
      }
      // P in bf16 as the A operand, pair i = s[2i], s[2i + 1] of row i % 2
      uint32_t pa[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const float p0 = ex2(fmaf(s[2 * i], c2, -mb[i & 1]));  // masked: exp2(-inf) = 0
        const float p1 = ex2(fmaf(s[2 * i + 1], c2, -mb[i & 1]));
        lrow[i & 1] += p0 + p1;
        pa[i] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oa[4 * j + e] *= al[e >> 1];
      pin(pa);
      wg_fence();
      pin(oa);
      mm_rn<BK, D, BK>(oa, pa, Vs + st * BK * D);
      wg_commit();
      wg_wait();
      pin(oa);
      __syncwarp();
      if (f.lane == 0) bar_arrive(&empty[st]);
      ++visited;
      if (++st == ST) {
        st = 0;
        ph ^= 1;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) lrow[h] = quad_sum(lrow[h]);
    if (last) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.row + 8 * h;
        if (r >= nq) continue;
        const float inv = 1.f / fmaxf(lrow[h], 1e-20f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(o + (row0 + r) * D + 8 * j + f.col) =
              __floats2bfloat162_rn(oa[4 * j + 2 * h] * inv, oa[4 * j + 2 * h + 1] * inv);
        if ((f.lane & 3) == 0) lse[row0 + r] = mrow[h] + logf(fmaxf(lrow[h], 1e-20f));
      }
    } else if (first || visited > 0) {  // a middle step that saw nothing leaves the state
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.row + 8 * h;
        if (r >= nq) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(acc + (row0 + r) * D + 8 * j + f.col) =
              make_float2(oa[4 * j + 2 * h], oa[4 * j + 2 * h + 1]);
        if ((f.lane & 3) == 0) {
          m[row0 + r] = mrow[h];
          l[row0 + r] = lrow[h];
        }
      }
    }
  }
}

// -- dq: B2 (flash), B10 (ring step) --------------------------------------------------------

template <int D>
struct DqLayout {
  static constexpr int BQ = 128, BK = 64, ST = 3;
  size_t q, dout, k, v, segk, tile, flag, full, empty, qbar, bytes;
  __host__ __device__ DqLayout() {
    Arena a;
    q = a.take<bf16>(BQ * D, 1024);
    dout = a.take<bf16>(BQ * D, 1024);
    k = a.take<bf16>(ST * BK * D, 1024);
    v = a.take<bf16>(ST * BK * D, 1024);
    segk = a.take<int>(ST * BK);
    tile = a.take<int>(ST);
    flag = a.take<int>(ST);
    full = a.take<uint64_t>(ST, 8);
    empty = a.take<uint64_t>(ST, 8);
    qbar = a.take<uint64_t>(1, 8);
    bytes = a.off + 1024;
  }
};

// the gradients' type: bf16 for flash attention, f32 accumulators for a ring step
template <bool kStep>
using GradT = typename std::conditional<kStep, float, bf16>::type;

// two gradient values at dst: written (flash) or added (ring step)
template <bool kStep>
__device__ __forceinline__ void put2(GradT<kStep>* dst, float x, float y) {
  if constexpr (kStep) {
    float2* p = reinterpret_cast<float2*>(dst);
    const float2 old = *p;
    *p = make_float2(old.x + x, old.y + y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
}

template <int D, bool kStep>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ segq, const int* __restrict__ segk,
                   GradT<kStep>* __restrict__ dq, Geom gm, Span sp, float scale) {
  using L = DqLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST;
  const L lay;
  unsigned char* smem = smem_base();
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + lay.dout);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  int* segk_s = reinterpret_cast<int*>(smem + lay.segk);
  int* tile_s = reinterpret_cast<int*>(smem + lay.tile);
  int* flag_s = reinterpret_cast<int*>(smem + lay.flag);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + lay.empty);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + lay.qbar);

  const int Tq = sp.Tq, Tk = sp.Tk;
  const int bh = blockIdx.y, b = bh / gm.H, g = (bh % gm.H) / (gm.H / gm.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int nq = min(BQ, Tq - q0);
  if (threadIdx.x == 0) init_ring(full, empty, ST, qbar);
  __syncthreads();

  if (threadIdx.x >= NCONS) {  // the producer warpgroup: its first warp loads, the rest leave
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= NCONS + 32) return;
    const int lane = threadIdx.x & 31;
    const int* skg = segk == nullptr ? nullptr : segk + (size_t)b * gm.Tseg + sp.kpos0;
    int qids[BQ / 32], qlo, qhi;
    seg_ids<BQ>(segq == nullptr ? nullptr : segq + (size_t)b * gm.P, q0, nq, lane, qids, qlo, qhi);
    int kb0, kb1;
    sp.k_range<BQ, BK>(q0, kb0, kb1);
    int n = 0;
    for (int kb = kb0; kb < kb1; ++kb) {
      const int k0 = kb * BK;
      int ids[BK / 32], klo, khi;
      seg_ids<BK>(skg, k0, min(BK, Tk - k0), lane, ids, klo, khi);
      if (klo > qhi || khi < qlo) continue;
      const int st = n % ST;
      bar_wait(&empty[st], ((n / ST) & 1) ^ 1);
      const bool mask = sp.edge<BQ, BK>(q0, k0) || mixed(qlo, qhi, klo, khi);
      if (mask) {
#pragma unroll
        for (int i = 0; i < BK / 32; ++i) segk_s[st * BK + lane + 32 * i] = ids[i];
      }
      if (lane == 0) {
        tile_s[st] = kb;
        flag_s[st] = mask;
        if (n == 0) {
          bar_arrive_tx(qbar, 2 * BQ * D * 2);
          tma_rows<BQ, D>(Qs, &tq, qbar, q0, bh);
          tma_rows<BQ, D>(dOs, &tdo, qbar, q0, bh);
        }
        bar_arrive_tx(&full[st], 2 * BK * D * 2);
        tma_rows<BK, D>(Ks + st * BK * D, &tk, &full[st], k0, b * gm.Hkv + g);
        tma_rows<BK, D>(Vs + st * BK * D, &tv, &full[st], k0, b * gm.Hkv + g);
      } else {
        bar_arrive(&full[st]);
      }
      ++n;
    }
    const int st = n % ST;
    bar_wait(&empty[st], ((n / ST) & 1) ^ 1);
    if (lane == 0) tile_s[st] = -1;
    bar_arrive(&full[st]);
  } else {
    regs_inc<CONSUMER_REGS>();
    const Frag f(threadIdx.x);
    const float c2 = scale * LOG2E;
    const size_t row0 = (size_t)bh * gm.P + q0;
    float lse2[2], dl[2];
    int sqr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.row + 8 * h;
      const bool in = r < nq;
      sqr[h] = segq != nullptr && in ? segq[(size_t)b * gm.P + q0 + r] : 0;
      lse2[h] = in ? lse[row0 + r] * LOG2E : 0.f;
      dl[h] = in ? delta[row0 + r] : 0.f;
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    const bf16* Qw = Qs + f.wg * 64 * 64;
    const bf16* dOw = dOs + f.wg * 64 * 64;
    int st = 0, ph = 0, visited = 0;
    for (;;) {
      bar_wait(&full[st], ph);
      const int kb = tile_s[st];
      if (kb < 0) break;
      if (visited == 0) bar_wait(qbar, 0);
      const int k0 = kb * BK;
      const bf16* Kt = Ks + st * BK * D;
      float s[BK / 2], dp[BK / 2];
      wg_fence();
      mm_nt<BK, D, BQ, BK>(s, Qw, Kt);
      mm_nt<BK, D, BQ, BK>(dp, dOw, Vs + st * BK * D);
      wg_commit();
      wg_wait();
      pin(s);
      pin(dp);
      const bool mask = flag_s[st];
      const int* skt = segk_s + st * BK;
      // dS in bf16 as the A operand, pair i = columns c, c + 1 of row i % 2
      uint32_t da[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const int h = i & 1, c = 8 * (i >> 1) + f.col, r = q0 + f.row + 8 * h;
        float p0 = ex2(fmaf(s[2 * i], c2, -lse2[h])), p1 = ex2(fmaf(s[2 * i + 1], c2, -lse2[h]));
        if (mask) {
          if (!sp(r, k0 + c, sqr[h], skt[c])) p0 = 0.f;
          if (!sp(r, k0 + c + 1, sqr[h], skt[c + 1])) p1 = 0.f;
        }
        da[i] = pack_bf16(p0 * (dp[2 * i] - dl[h]), p1 * (dp[2 * i + 1] - dl[h]));
      }
      pin(da);
      wg_fence();
      pin(dqa);
      mm_rn<BK, D, BK>(dqa, da, Kt);
      wg_commit();
      wg_wait();
      pin(dqa);
      __syncwarp();
      if (f.lane == 0) bar_arrive(&empty[st]);
      ++visited;
      if (++st == ST) {
        st = 0;
        ph ^= 1;
      }
    }
    // flash attention writes every row (0 where nothing is visible); a ring step that saw
    // nothing adds nothing
    if (!kStep || visited > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.row + 8 * h;
        if (r >= nq) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          put2<kStep>(dq + (row0 + r) * D + 8 * j + f.col, scale * dqa[4 * j + 2 * h],
                      scale * dqa[4 * j + 2 * h + 1]);
      }
    }
  }
}

// -- dk / dv: B3 (flash), B10 (ring step, the riding accumulators) --------------------------

template <int D>
struct DkvLayout {
  static constexpr int BK = 128, BQ = 64, ST = 3;
  size_t k, v, q, dout, lse, delta, segq, head, tile, flag, full, empty, kvbar, bytes;
  __host__ __device__ DkvLayout() {
    Arena a;
    k = a.take<bf16>(BK * D, 1024);
    v = a.take<bf16>(BK * D, 1024);
    q = a.take<bf16>(ST * BQ * D, 1024);
    dout = a.take<bf16>(ST * BQ * D, 1024);
    lse = a.take<float>(ST * BQ);
    delta = a.take<float>(ST * BQ);
    segq = a.take<int>(ST * BQ);
    head = a.take<int>(ST);
    tile = a.take<int>(ST);
    flag = a.take<int>(ST);
    full = a.take<uint64_t>(ST, 8);
    empty = a.take<uint64_t>(ST, 8);
    kvbar = a.take<uint64_t>(1, 8);
    bytes = a.off + 1024;
  }
};

template <int D, bool kStep>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ segq, const int* __restrict__ segk,
                    GradT<kStep>* __restrict__ dk, GradT<kStep>* __restrict__ dv, Geom gm, Span sp,
                    float scale) {
  using L = DkvLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST;
  const L lay;
  unsigned char* smem = smem_base();
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + lay.dout);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* delta_s = reinterpret_cast<float*>(smem + lay.delta);
  int* segq_s = reinterpret_cast<int*>(smem + lay.segq);
  int* head_s = reinterpret_cast<int*>(smem + lay.head);
  int* tile_s = reinterpret_cast<int*>(smem + lay.tile);
  int* flag_s = reinterpret_cast<int*>(smem + lay.flag);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + lay.empty);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + lay.kvbar);

  const int Tq = sp.Tq, Tk = sp.Tk;
  const int bg = blockIdx.y, b = bg / gm.Hkv, g = bg % gm.Hkv, n_rep = gm.H / gm.Hkv;
  const int k0 = blockIdx.x * BK;  // low k tiles see the most q tiles: they start first
  const int nk = min(BK, Tk - k0);
  const int* skg = segk == nullptr ? nullptr : segk + (size_t)b * gm.Tseg + sp.kpos0;
  if (threadIdx.x == 0) init_ring(full, empty, ST, kvbar);
  __syncthreads();

  if (threadIdx.x >= NCONS) {  // the producer warpgroup: its first warp loads, the rest leave
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= NCONS + 32) return;
    const int lane = threadIdx.x & 31;
    const int* sqg = segq == nullptr ? nullptr : segq + (size_t)b * gm.P;
    int kids[BK / 32], klo, khi;
    seg_ids<BK>(skg, k0, nk, lane, kids, klo, khi);
    int qb0, qb1;
    sp.q_range<BQ, BK>(k0, qb0, qb1);
    int n = 0;
    for (int r = 0; r < n_rep; ++r) {
      const int bh = b * gm.H + g * n_rep + r;
      for (int qb = qb0; qb < qb1; ++qb) {
        const int q0 = qb * BQ, nq = min(BQ, Tq - q0);
        int ids[BQ / 32], qlo, qhi;
        seg_ids<BQ>(sqg, q0, nq, lane, ids, qlo, qhi);
        if (klo > qhi || khi < qlo) continue;
        const int st = n % ST;
        bar_wait(&empty[st], ((n / ST) & 1) ^ 1);
        const bool mask = sp.edge<BQ, BK>(q0, k0) || mixed(qlo, qhi, klo, khi);
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          const int c = lane + 32 * i;
          const bool in = c < nq;
          lse_s[st * BQ + c] = in ? lse[(size_t)bh * gm.P + q0 + c] * LOG2E : 0.f;
          delta_s[st * BQ + c] = in ? delta[(size_t)bh * gm.P + q0 + c] : 0.f;
          segq_s[st * BQ + c] = ids[i];
        }
        if (lane == 0) {
          head_s[st] = bh;
          tile_s[st] = qb;
          flag_s[st] = mask;
          if (n == 0) {
            bar_arrive_tx(kvbar, 2 * BK * D * 2);
            tma_rows<BK, D>(Ks, &tk, kvbar, k0, bg);
            tma_rows<BK, D>(Vs, &tv, kvbar, k0, bg);
          }
          bar_arrive_tx(&full[st], 2 * BQ * D * 2);
          tma_rows<BQ, D>(Qs + st * BQ * D, &tq, &full[st], q0, bh);
          tma_rows<BQ, D>(dOs + st * BQ * D, &tdo, &full[st], q0, bh);
        } else {
          bar_arrive(&full[st]);
        }
        ++n;
      }
    }
    const int st = n % ST;
    bar_wait(&empty[st], ((n / ST) & 1) ^ 1);
    if (lane == 0) tile_s[st] = -1;
    bar_arrive(&full[st]);
  } else {
    regs_inc<CONSUMER_REGS>();
    const Frag f(threadIdx.x);
    const float c2 = scale * LOG2E;
    int skr[2];  // the segment ids of this thread's two key rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.row + 8 * h;
      skr[h] = skg != nullptr && r < nk ? skg[k0 + r] : 0;
    }
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    const bf16* Kw = Ks + f.wg * 64 * 64;
    const bf16* Vw = Vs + f.wg * 64 * 64;
    int st = 0, ph = 0, visited = 0;
    for (;;) {
      bar_wait(&full[st], ph);
      const int qb = tile_s[st];
      if (qb < 0) break;
      if (visited == 0) bar_wait(kvbar, 0);
      const int q0 = qb * BQ;
      const bf16* Qt = Qs + st * BQ * D;
      const bf16* dOt = dOs + st * BQ * D;
      float s[BQ / 2], dp[BQ / 2];  // s^T and dp^T: rows are keys, columns queries
      wg_fence();
      mm_nt<BQ, D, BK, BQ>(s, Kw, Qt);
      mm_nt<BQ, D, BK, BQ>(dp, Vw, dOt);
      wg_commit();
      wg_wait();
      pin(s);
      pin(dp);
      const bool mask = flag_s[st];
      const float* lt = lse_s + st * BQ;
      const float* dt = delta_s + st * BQ;
      const int* sqt = segq_s + st * BQ;
      // P^T and dS^T in bf16 as A operands, pair i = query columns c, c + 1 of key row i % 2
      uint32_t pa[BQ / 4], da[BQ / 4];
#pragma unroll
      for (int i = 0; i < BQ / 4; ++i) {
        const int h = i & 1, c = 8 * (i >> 1) + f.col, r = k0 + f.row + 8 * h;
        float p0 = ex2(fmaf(s[2 * i], c2, -lt[c])), p1 = ex2(fmaf(s[2 * i + 1], c2, -lt[c + 1]));
        if (mask) {
          if (!sp(q0 + c, r, sqt[c], skr[h])) p0 = 0.f;
          if (!sp(q0 + c + 1, r, sqt[c + 1], skr[h])) p1 = 0.f;
        }
        pa[i] = pack_bf16(p0, p1);
        da[i] = pack_bf16(p0 * (dp[2 * i] - dt[c]), p1 * (dp[2 * i + 1] - dt[c + 1]));
      }
      pin(pa);
      pin(da);
      wg_fence();
      pin(dva);
      pin(dka);
      mm_rn<BQ, D, BQ>(dva, pa, dOt);
      mm_rn<BQ, D, BQ>(dka, da, Qt);
      wg_commit();
      wg_wait();
      pin(dva);
      pin(dka);
      __syncwarp();
      if (f.lane == 0) bar_arrive(&empty[st]);
      ++visited;
      if (++st == ST) {
        st = 0;
        ph ^= 1;
      }
    }
    if (!kStep || visited > 0) {
      const size_t krow0 = (size_t)bg * Tk + k0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.row + 8 * h;
        if (r >= nk) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const size_t at = (krow0 + r) * D + 8 * j + f.col;
          put2<kStep>(dk + at, scale * dka[4 * j + 2 * h], scale * dka[4 * j + 2 * h + 1]);
          put2<kStep>(dv + at, dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// -- launches -----------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so nothing links libcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor seen as `planes` planes of `rows` rows of D, plane i at base + i * pitch rows,
// loaded in boxes of box_rows x 64 with the 128-byte swizzle; rows past `rows` load as zeros.
inline bool tensor_map(CUtensorMap* map, const void* base, int D, int rows, int planes, int pitch,
                       int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)pitch * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the q-like maps ([B*H, Tq, D], plane pitch P) with boxes of rq rows and the k/v maps
// ([B*Hkv, Tk, D]) with boxes of rk rows; false when one cannot be encoded
template <int D>
bool maps(const Args& a, const void* q2, int rq, int rk, CUtensorMap& mq, CUtensorMap& mq2,
          CUtensorMap& mk, CUtensorMap& mv) {
  const int BH = a.B * a.gm.H, BG = a.B * a.gm.Hkv;
  return tensor_map(&mq, a.q, D, a.sp.Tq, BH, a.gm.P, rq) &&
         (q2 == nullptr || tensor_map(&mq2, q2, D, a.sp.Tq, BH, a.gm.P, rq)) &&
         tensor_map(&mk, a.k, D, a.sp.Tk, BG, a.sp.Tk, rk) &&
         tensor_map(&mv, a.v, D, a.sp.Tk, BG, a.sp.Tk, rk);
}

template <int D, bool kStep>
cudaError_t fwd(const Args& a) {
  using L = FwdLayout<D>;
  CUtensorMap mq, mk, mv;
  if (!maps<D>(a, nullptr, L::BQ, L::BK, mq, mq, mk, mv)) return cudaErrorInvalidValue;
  auto kern = attn_fwd_kernel<D, kStep>;
  const L lay;
  cudaError_t e = allow_smem(kern, lay.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(a.sp.Tq, L::BQ), a.B * a.gm.H);
  kern<<<grid, NTHREADS, lay.bytes, a.stream>>>(mq, mk, mv, a.segq, a.segk, a.acc, a.m, a.l,
                                                 (bf16*)a.o, a.lse_out, a.gm, a.sp, a.scale,
                                                 a.first, a.last);
  return cudaGetLastError();
}

template <int D, bool kStep>
cudaError_t dq(const Args& a) {
  using L = DqLayout<D>;
  CUtensorMap mq, mdo, mk, mv;
  if (!maps<D>(a, a.dout, L::BQ, L::BK, mq, mdo, mk, mv)) return cudaErrorInvalidValue;
  auto kern = attn_bwd_dq_kernel<D, kStep>;
  const L lay;
  cudaError_t e = allow_smem(kern, lay.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(a.sp.Tq, L::BQ), a.B * a.gm.H);
  kern<<<grid, NTHREADS, lay.bytes, a.stream>>>(mq, mdo, mk, mv, a.lse_in, a.delta, a.segq, a.segk,
                                                 (GradT<kStep>*)a.dq, a.gm, a.sp, a.scale);
  return cudaGetLastError();
}

template <int D, bool kStep>
cudaError_t dkv(const Args& a) {
  using L = DkvLayout<D>;
  CUtensorMap mq, mdo, mk, mv;
  if (!maps<D>(a, a.dout, L::BQ, L::BK, mq, mdo, mk, mv)) return cudaErrorInvalidValue;
  auto kern = attn_bwd_dkv_kernel<D, kStep>;
  const L lay;
  cudaError_t e = allow_smem(kern, lay.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid(cdiv(a.sp.Tk, L::BK), a.B * a.gm.Hkv);
  kern<<<grid, NTHREADS, lay.bytes, a.stream>>>(mq, mdo, mk, mv, a.lse_in, a.delta, a.segq, a.segk,
                                                 (GradT<kStep>*)a.dk, (GradT<kStep>*)a.dv, a.gm,
                                                 a.sp, a.scale);
  return cudaGetLastError();
}

}  // namespace hop

// =======================================================================================
// dispatch: bf16 to the Hopper kernels, f32 to the per-thread ones

template <typename T, int D, bool kStep>
struct Fwd {
  static cudaError_t go(const Args& a) {
    if constexpr (std::is_same<T, float>::value) return simt::fwd<D, kStep>(a);
    else return hop::fwd<D, kStep>(a);
  }
};

template <typename T, int D, bool kStep>
struct Dq {
  static cudaError_t go(const Args& a) {
    if constexpr (std::is_same<T, float>::value) return simt::dq<D, kStep>(a);
    else return hop::dq<D, kStep>(a);
  }
};

template <typename T, int D, bool kStep>
struct Dkv {
  static cudaError_t go(const Args& a) {
    if constexpr (std::is_same<T, float>::value) return simt::dkv<D, kStep>(a);
    else return hop::dkv<D, kStep>(a);
  }
};

// dtype: 0 = bfloat16, 1 = float32. cudaErrorInvalidValue for what the kernels do not take
// (and for a bf16 tensor that no tensor map can describe).
template <template <typename, int, bool> class Launch, bool kStep>
int dispatch(const Args& a, int Dh, int dtype) {
  const Geom& g = a.gm;
  const Span& s = a.sp;
  const bool ok = a.B > 0 && g.Hkv > 0 && g.H % g.Hkv == 0 && g.H / g.Hkv <= NREP_MAX &&
                  s.Tq > 0 && s.Tk > 0 && g.P >= s.Tq && s.qpos0 >= 0 && s.kpos0 >= 0 &&
                  (a.segq == nullptr) == (a.segk == nullptr) &&
                  (a.segk == nullptr || g.Tseg >= s.kpos0 + s.Tk);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 128) return (int)Launch<__nv_bfloat16, 128, kStep>::go(a);
  if (dtype == 0 && Dh == 64) return (int)Launch<__nv_bfloat16, 64, kStep>::go(a);
  if (dtype == 1 && Dh == 128) return (int)Launch<float, 128, kStep>::go(a);
  if (dtype == 1 && Dh == 64) return (int)Launch<float, 64, kStep>::go(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
