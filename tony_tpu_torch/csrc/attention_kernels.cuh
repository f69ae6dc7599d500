// The attention kernels for training, shared by flash attention (flash_attention.cu: B1 forward,
// B2 dq, B3 dk/dv) and the ring steps of context parallelism (ring_attention.cu: B9 forward,
// B10 dq and dk/dv). One body per kernel; each source instantiates the mode it launches.
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
// Bound on this card: operations. At the training shape (T 2048, D 128) a q tile does
// ~T/2 * 4 * D flops per 2 * D * 2 bytes it reads, far above the H100's ~295 flop/B ridge,
// so the aim is to keep the T x T scores on chip and feed the tensor cores: each block
// keeps its score tile in shared memory, never in device memory. On Hopper the TPU's
// sequential grid dimension becomes a loop inside the block: the forward and dq take one
// block per (b*h, q tile) and walk the k tiles from the window's start up to the causal
// diagonal; dk/dv takes one block per (b*hkv, k tile) and walks the group's n_rep heads and
// only the q tiles that reach this k tile causally or inside the window, summing dk and dv
// in f32 in shared memory. Each block owns the rows it writes: no atomics, so the result is
// the same bits from run to run. bf16 products run on the tensor cores through WMMA
// 16x16x16 tiles with f32 accumulate (64-row tiles); f32 runs a plain per-thread loop
// (32-row tiles) and is for tests. Tile loads are plain 16-byte loads; cp.async/TMA
// pipelining and wgmma come later. A ring step adds the f32 state (acc, dq, dk/dv) read and
// written once, small beside its Tq x Tk work.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NREP_MAX = 8;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Tile geometry per element type. Row pitches are padded by 16 bytes (banks shift from
// row to row; rows stay 16-byte aligned for the vector loads and 32-byte aligned at every
// 16-row WMMA fragment). For f32 the P / dS tiles live on top of the f32 score tiles.
template <typename T>
struct Cfg {
  static constexpr bool kWmma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BQ = kWmma ? 64 : 32;
  static constexpr int BK = BQ;
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int LDS = BK + 4;                // f32 score tiles
  static constexpr int LDP = kWmma ? BK + 8 : LDS;  // P / dS tiles in T
};

// Shared-memory carving, the same on the host (size) and the device (offsets).
struct Arena {
  size_t off = 0;
  template <typename U>
  __host__ __device__ size_t take(size_t n) {
    const size_t r = off;
    off += (n * sizeof(U) + 127) / 128 * 128;
    return r;
  }
};

// Block-level product over shared memory: C[M][N] (+)= A'.B' with C in f32. A' is A
// [M][K] or, with AT, A stored [K][M]; B' is B [K][N] or, with BT, B stored [N][K].
template <int M, int N, int K, bool AT, bool BT>
__device__ __forceinline__ void block_mm(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B,
                                         int ldb, float* C, int ldc, bool acc) {
  using LA = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  constexpr int TN = N / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * TN; t += NWARPS) {
    const int mi = t / TN, ni = t % TN;
    float* cp = C + mi * 16 * ldc + ni * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (acc) wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
    else wmma::fill_fragment(c, 0.f);
#pragma unroll 4
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
      wmma::load_matrix_sync(a, AT ? A + kk * lda + mi * 16 : A + mi * 16 * lda + kk, lda);
      wmma::load_matrix_sync(b, BT ? B + ni * 16 * ldb + kk : B + kk * ldb + ni * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
  }
}

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
template <typename T, int R, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ src, int n) {
  constexpr int CH = D * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < R * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < n) x = reinterpret_cast<const uint4*>(src + (size_t)r * D)[c];
    reinterpret_cast<uint4*>(dst + r * ld)[c] = x;
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
};

// Heads and row pitches of one launch (see the header comment).
struct Geom {
  int H, Hkv, P, Tseg;
};

// ---------------------------------------------------------------------------------------
// forward: B1 (flash), B9 (ring step)

template <typename T, int D>
struct FwdSmem {
  size_t q, k, v, s, p, o, m, l, alpha, segq, segk, bytes;
  __host__ __device__ FwdSmem() {
    using C = Cfg<T>;
    Arena a;
    q = a.take<T>(C::BQ * (D + C::PAD));
    k = a.take<T>(C::BK * (D + C::PAD));
    v = a.take<T>(C::BK * (D + C::PAD));
    s = a.take<float>(C::BQ * C::LDS);
    p = C::kWmma ? a.take<T>(C::BQ * C::LDP) : s;
    o = a.take<float>(C::BQ * (D + 4));
    m = a.take<float>(C::BQ);
    l = a.take<float>(C::BQ);
    alpha = a.take<float>(C::BQ);
    segq = a.take<int>(C::BQ);
    segk = a.take<int>(C::BK);
    bytes = a.off;
  }
};

template <typename T, int D, bool kStep>
__global__ void __launch_bounds__(NTHREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ segq, const int* __restrict__ segk,
                float* __restrict__ acc, float* __restrict__ m, float* __restrict__ l,
                T* __restrict__ o, float* __restrict__ lse, Geom gm, Span sp, float scale,
                int first_step, int last_step) {
  using C = Cfg<T>;
  constexpr int BQ = C::BQ, BK = C::BK, LDT = D + C::PAD, LDS = C::LDS, LDP = C::LDP, LDO = D + 4;
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
  const FwdSmem<T, D> L;
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* S = reinterpret_cast<float*>(smem + L.s);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  float* O = reinterpret_cast<float*>(smem + L.o);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);
  int* sq = reinterpret_cast<int*>(smem + L.segq);
  int* sk = reinterpret_cast<int*>(smem + L.segk);

  const size_t row0 = (size_t)bh * gm.P + q0;  // this tile's first row in q, acc, o, m, l, lse
  const T* kg = k + (size_t)(b * gm.Hkv + g) * Tk * D;
  const T* vg = v + (size_t)(b * gm.Hkv + g) * Tk * D;
  load_rows<T, BQ, D>(Qs, LDT, q + row0 * D, nq);
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
    __syncthreads();  // the previous tile's readers are done with Ks / Vs / Ps
    load_rows<T, BK, D>(Ks, LDT, kg + (size_t)k0 * D, Tk - k0);
    load_rows<T, BK, D>(Vs, LDT, vg + (size_t)k0 * D, Tk - k0);
    load_seg(sk, BK, skg, k0, Tk);
    __syncthreads();
    block_mm<BQ, BK, D, false, true>(Qs, LDT, Ks, LDT, S, LDS, false);
    __syncthreads();
    // online softmax, one warp per row; P overwrites S in place for f32 (same lane, same slot)
    for (int r = warp; r < BQ; r += NWARPS) {
      float sv[BK / 32];
      bool ok[BK / 32];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        ok[j] = sp(q0 + r, k0 + c, sq[r], sk[c]);
        sv[j] = S[r * LDS + c] * scale;
        if (ok[j]) mx = fmaxf(mx, sv[j]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = ok[j] ? expf(sv[j] - m_new) : 0.f;
        Ps[r * LDP + lane + 32 * j] = from_f<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
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
    block_mm<BQ, D, BK, false, false>(Ps, LDP, Vs, LDT, O, LDO, true);
  }
  __syncthreads();
  if (last) {
    T* og = o + row0 * D;
    for (int i = tid; i < nq * D; i += NTHREADS) {
      const int r = i / D;
      og[i] = from_f<T>(O[r * LDO + i % D] / fmaxf(l_s[r], 1e-20f));
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

// ---------------------------------------------------------------------------------------
// dq: B2 (flash), B10 (ring step)

// The gradients' type: the input's for flash attention, f32 accumulators for a ring step.
template <typename T, bool kStep>
using GradT = typename std::conditional<kStep, float, T>::type;

// dst = v in T (flash) or dst += v in f32 (ring step)
template <typename T, bool kStep>
__device__ __forceinline__ void put(GradT<T, kStep>& dst, float v) {
  if constexpr (kStep) dst += v;
  else dst = from_f<T>(v);
}

template <typename T, int D>
struct DqSmem {
  size_t q, dout, k, v, s, dp, ds, dq, lse, delta, segq, segk, bytes;
  __host__ __device__ DqSmem() {
    using C = Cfg<T>;
    Arena a;
    q = a.take<T>(C::BQ * (D + C::PAD));
    dout = a.take<T>(C::BQ * (D + C::PAD));
    k = a.take<T>(C::BK * (D + C::PAD));
    v = a.take<T>(C::BK * (D + C::PAD));
    s = a.take<float>(C::BQ * C::LDS);
    dp = a.take<float>(C::BQ * C::LDS);
    ds = C::kWmma ? a.take<T>(C::BQ * C::LDP) : dp;
    dq = a.take<float>(C::BQ * (D + 4));
    lse = a.take<float>(C::BQ);
    delta = a.take<float>(C::BQ);
    segq = a.take<int>(C::BQ);
    segk = a.take<int>(C::BK);
    bytes = a.off;
  }
};

template <typename T, int D, bool kStep>
__global__ void __launch_bounds__(NTHREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, const int* __restrict__ segq,
                   const int* __restrict__ segk, GradT<T, kStep>* __restrict__ dq, Geom gm,
                   Span sp, float scale) {
  using C = Cfg<T>;
  constexpr int BQ = C::BQ, BK = C::BK, LDT = D + C::PAD, LDS = C::LDS, LDP = C::LDP, LDO = D + 4;
  const int tid = threadIdx.x;
  const int Tq = sp.Tq, Tk = sp.Tk;
  const int bh = blockIdx.y, b = bh / gm.H, g = (bh % gm.H) / (gm.H / gm.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int nq = min(BQ, Tq - q0);
  int kb0, kb1;
  sp.k_range<BQ, BK>(q0, kb0, kb1);
  // Nothing visible: a ring step adds nothing, flash attention writes 0. Returning here also
  // tells the compiler the tile loop below runs (without it B2 or B3 ran up to 16% slower).
  if (kb0 >= kb1) {
    if constexpr (!kStep)
      for (int i = tid; i < nq * D; i += NTHREADS) dq[((size_t)bh * gm.P + q0) * D + i] = from_f<T>(0.f);
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  const DqSmem<T, D> L;
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* dOs = reinterpret_cast<T*>(smem + L.dout);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* S = reinterpret_cast<float*>(smem + L.s);
  float* dP = reinterpret_cast<float*>(smem + L.dp);
  T* dSs = reinterpret_cast<T*>(smem + L.ds);
  float* dQ = reinterpret_cast<float*>(smem + L.dq);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  int* sq = reinterpret_cast<int*>(smem + L.segq);
  int* sk = reinterpret_cast<int*>(smem + L.segk);

  const size_t row0 = (size_t)bh * gm.P + q0;
  const T* kg = k + (size_t)(b * gm.Hkv + g) * Tk * D;
  const T* vg = v + (size_t)(b * gm.Hkv + g) * Tk * D;
  load_rows<T, BQ, D>(Qs, LDT, q + row0 * D, nq);
  load_rows<T, BQ, D>(dOs, LDT, dout + row0 * D, nq);
  for (int i = tid; i < BQ * D; i += NTHREADS) dQ[(i / D) * LDO + i % D] = 0.f;
  load_vec(lse_s, BQ, lse + (size_t)bh * gm.P, q0, Tq, 0.f);
  load_vec(delta_s, BQ, delta + (size_t)bh * gm.P, q0, Tq, 0.f);
  load_seg(sq, BQ, segq == nullptr ? nullptr : segq + (size_t)b * gm.P, q0, Tq);
  const int* skg = segk == nullptr ? nullptr : segk + (size_t)b * gm.Tseg + sp.kpos0;
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    load_rows<T, BK, D>(Ks, LDT, kg + (size_t)k0 * D, Tk - k0);
    load_rows<T, BK, D>(Vs, LDT, vg + (size_t)k0 * D, Tk - k0);
    load_seg(sk, BK, skg, k0, Tk);
    __syncthreads();
    block_mm<BQ, BK, D, false, true>(Qs, LDT, Ks, LDT, S, LDS, false);    // q.k^T
    block_mm<BQ, BK, D, false, true>(dOs, LDT, Vs, LDT, dP, LDS, false);  // do.v^T
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const float p = sp(q0 + r, k0 + c, sq[r], sk[c]) ? expf(S[r * LDS + c] * scale - lse_s[r]) : 0.f;
      dSs[r * LDP + c] = from_f<T>(p * (dP[r * LDS + c] - delta_s[r]));
    }
    __syncthreads();
    block_mm<BQ, D, BK, false, false>(dSs, LDP, Ks, LDT, dQ, LDO, true);  // ds.k
  }
  __syncthreads();
  GradT<T, kStep>* dqg = dq + row0 * D;
  for (int i = tid; i < nq * D; i += NTHREADS) put<T, kStep>(dqg[i], scale * dQ[(i / D) * LDO + i % D]);
}

// ---------------------------------------------------------------------------------------
// dk / dv: B3 (flash), B10 (ring step, the riding accumulators)

template <typename T, int D>
struct DkvSmem {
  size_t k, v, q, dout, s, dp, p, ds, dk, dv, lse, delta, segq, segk, bytes;
  __host__ __device__ DkvSmem() {
    using C = Cfg<T>;
    Arena a;
    k = a.take<T>(C::BK * (D + C::PAD));
    v = a.take<T>(C::BK * (D + C::PAD));
    q = a.take<T>(C::BQ * (D + C::PAD));
    dout = a.take<T>(C::BQ * (D + C::PAD));
    s = a.take<float>(C::BQ * C::LDS);
    dp = a.take<float>(C::BQ * C::LDS);
    p = C::kWmma ? a.take<T>(C::BQ * C::LDP) : s;
    ds = C::kWmma ? a.take<T>(C::BQ * C::LDP) : dp;
    dk = a.take<float>(C::BK * (D + 4));
    dv = a.take<float>(C::BK * (D + 4));
    lse = a.take<float>(C::BQ);
    delta = a.take<float>(C::BQ);
    segq = a.take<int>(C::BQ);
    segk = a.take<int>(C::BK);
    bytes = a.off;
  }
};

template <typename T, int D, bool kStep>
__global__ void __launch_bounds__(NTHREADS)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ segq,
                    const int* __restrict__ segk, GradT<T, kStep>* __restrict__ dk,
                    GradT<T, kStep>* __restrict__ dv, Geom gm, Span sp, float scale) {
  using C = Cfg<T>;
  constexpr int BQ = C::BQ, BK = C::BK, LDT = D + C::PAD, LDS = C::LDS, LDP = C::LDP, LDO = D + 4;
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
        dk[at] = dv[at] = from_f<T>(0.f);
      }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  const DkvSmem<T, D> L;
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* dOs = reinterpret_cast<T*>(smem + L.dout);
  float* S = reinterpret_cast<float*>(smem + L.s);
  float* dP = reinterpret_cast<float*>(smem + L.dp);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  T* dSs = reinterpret_cast<T*>(smem + L.ds);
  float* dK = reinterpret_cast<float*>(smem + L.dk);
  float* dV = reinterpret_cast<float*>(smem + L.dv);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* delta_s = reinterpret_cast<float*>(smem + L.delta);
  int* sq = reinterpret_cast<int*>(smem + L.segq);
  int* sk = reinterpret_cast<int*>(smem + L.segk);

  const size_t krow0 = (size_t)bg * Tk + k0;
  load_rows<T, BK, D>(Ks, LDT, k + krow0 * D, nk);
  load_rows<T, BK, D>(Vs, LDT, v + krow0 * D, nk);
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
      load_rows<T, BQ, D>(Qs, LDT, q + row0 * D, nq);
      load_rows<T, BQ, D>(dOs, LDT, dout + row0 * D, nq);
      load_vec(lse_s, BQ, lse + (size_t)bh * gm.P, q0, Tq, 0.f);
      load_vec(delta_s, BQ, delta + (size_t)bh * gm.P, q0, Tq, 0.f);
      load_seg(sq, BQ, segq == nullptr ? nullptr : segq + (size_t)b * gm.P, q0, Tq);
      __syncthreads();
      block_mm<BQ, BK, D, false, true>(Qs, LDT, Ks, LDT, S, LDS, false);    // q.k^T
      block_mm<BQ, BK, D, false, true>(dOs, LDT, Vs, LDT, dP, LDS, false);  // do.v^T
      __syncthreads();
      // P and dS overwrite S and dP in place for f32 (same thread, same slot)
      for (int i = tid; i < BQ * BK; i += NTHREADS) {
        const int rr = i / BK, c = i % BK;
        const float p = sp(q0 + rr, k0 + c, sq[rr], sk[c]) ? expf(S[rr * LDS + c] * scale - lse_s[rr])
                                                          : 0.f;
        const float ds = p * (dP[rr * LDS + c] - delta_s[rr]);
        Ps[rr * LDP + c] = from_f<T>(p);
        dSs[rr * LDP + c] = from_f<T>(ds);
      }
      __syncthreads();
      block_mm<BK, D, BQ, true, false>(Ps, LDP, dOs, LDT, dV, LDO, true);  // p^T.do
      block_mm<BK, D, BQ, true, false>(dSs, LDP, Qs, LDT, dK, LDO, true);  // ds^T.q
    }
  }
  __syncthreads();
  GradT<T, kStep>* dkg = dk + krow0 * D;
  GradT<T, kStep>* dvg = dv + krow0 * D;
  for (int i = tid; i < nk * D; i += NTHREADS) {
    const int off = (i / D) * LDO + i % D;
    put<T, kStep>(dkg[i], scale * dK[off]);
    put<T, kStep>(dvg[i], dV[off]);
  }
}

// ---------------------------------------------------------------------------------------
// launches

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

template <typename T, int D, bool kStep>
struct Fwd {
  static cudaError_t go(const Args& a) {
    const FwdSmem<T, D> L;
    auto kern = attn_fwd_kernel<T, D, kStep>;
    cudaError_t e = allow_smem(kern, L.bytes);
    if (e != cudaSuccess) return e;
    dim3 grid(cdiv(a.sp.Tq, Cfg<T>::BQ), a.B * a.gm.H);
    kern<<<grid, NTHREADS, L.bytes, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.segq, a.segk, a.acc, a.m, a.l, (T*)a.o,
        a.lse_out, a.gm, a.sp, a.scale, a.first, a.last);
    return cudaGetLastError();
  }
};

template <typename T, int D, bool kStep>
struct Dq {
  static cudaError_t go(const Args& a) {
    const DqSmem<T, D> L;
    auto kern = attn_bwd_dq_kernel<T, D, kStep>;
    cudaError_t e = allow_smem(kern, L.bytes);
    if (e != cudaSuccess) return e;
    dim3 grid(cdiv(a.sp.Tq, Cfg<T>::BQ), a.B * a.gm.H);
    kern<<<grid, NTHREADS, L.bytes, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse_in, a.delta, a.segq,
        a.segk, (GradT<T, kStep>*)a.dq, a.gm, a.sp, a.scale);
    return cudaGetLastError();
  }
};

template <typename T, int D, bool kStep>
struct Dkv {
  static cudaError_t go(const Args& a) {
    const DkvSmem<T, D> L;
    auto kern = attn_bwd_dkv_kernel<T, D, kStep>;
    cudaError_t e = allow_smem(kern, L.bytes);
    if (e != cudaSuccess) return e;
    dim3 grid(cdiv(a.sp.Tk, Cfg<T>::BK), a.B * a.gm.Hkv);
    kern<<<grid, NTHREADS, L.bytes, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse_in, a.delta, a.segq,
        a.segk, (GradT<T, kStep>*)a.dk, (GradT<T, kStep>*)a.dv, a.gm, a.sp, a.scale);
    return cudaGetLastError();
  }
};

// dtype: 0 = bfloat16, 1 = float32. cudaErrorInvalidValue for what the kernels do not take.
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
