// Flash attention for training: forward (B1), dq backward (B2), dk/dv backward (B3).
//
// Replaces the Pallas TPU kernels of tony_tpu/ops/attention.py:
//   flash_fwd_kernel      <- `_flash_kernel` (:95, launched at :215)
//   flash_bwd_dq_kernel   <- `_flash_bwd_dq_kernel` (:287, launched at :526)
//   flash_bwd_dkv_kernel  <- `_flash_bwd_dkv_kernel_resident` (:373, launched at :572)
//                        and `_flash_bwd_dkv_kernel` (:434, launched at :662): one kernel for both.
//
// Maths (identical to the TPU kernels): q [B, H, Tq, D], k/v [B, Hkv, Tk, D], query head h
// reads kv head h / (H / Hkv). Score s = scale * q.k with scale = D^-0.5; position i sees j
// when (not causal or i >= j) and (window <= 0 or i - j < window) and seg[i] == seg[j]
// (segment ids [B, T] int32, optional). No Tk - Tq offset, as in the TPU kernels. The
// forward keeps an online softmax in f32 and writes o (q's type) and the per-row
// logsumexp lse = m + log(max(l, 1e-20)) [B, H, Tq] f32; the backward recomputes
// p = exp(s - lse) from it, with delta = rowsum(do * o) computed by the caller:
//   ds = p * (do.v - delta),  dq = scale * sum_k ds.k,  dk = scale * sum_q ds^T.q,
//   dv = sum_q p^T.do  (dk/dv summed over the n_rep query heads of the kv head).
// A masked score gives p = 0 exactly, never exp(0) of a -1e30 row maximum, so a row whose
// first tiles are all masked (segments, windows) carries nothing into its sum.
// Any Tq, Tk >= 1: the last tile of each is ragged, its missing rows load as zeros and
// are masked out of every score, and nothing is stored past the end.
//
// Bound on this card: operations. At the training shape (T 2048, D 128) a q tile does
// ~T/2 * 4 * D flops per 2 * D * 2 bytes it reads, far above the H100's ~295 flop/B ridge,
// so the aim is to keep the T x T scores on chip and feed the tensor cores: each block
// keeps its score tile in shared memory, never in device memory. On Hopper the TPU's
// sequential grid dimension becomes a loop inside the block: B1 and B2 take one block per
// (b*h, q tile) and walk the k tiles from the window's start up to the causal diagonal;
// B3 takes one block per (b*hkv, k tile) and walks the group's n_rep heads and only the
// q tiles that reach this k tile causally or inside the window, summing dk and dv in f32
// in shared memory: no atomics, so the result is the same bits from run to run.
// bf16 products run on the tensor cores through WMMA 16x16x16 tiles with f32 accumulate
// (64-row tiles); f32 runs a plain per-thread loop (32-row tiles) and is for tests.
// Tile loads are plain 16-byte loads; cp.async/TMA pipelining and wgmma come later.

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

// The mask of one (query i, key j) pair; i >= Tq or j >= Tk are the ragged edge.
struct Mask {
  int Tq, Tk, causal, window;
  __device__ __forceinline__ bool operator()(int i, int j, int si, int sj) const {
    return i < Tq && j < Tk && (!causal || i >= j) && (window <= 0 || i - j < window) && si == sj;
  }
};

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

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// k tiles [kb0, kb1) that a q tile starting at q0 reaches (B1, B2).
template <typename T>
__device__ __forceinline__ void k_range(int q0, const Mask& mk, int& kb0, int& kb1) {
  constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK;
  kb0 = 0;
  kb1 = cdiv(mk.Tk, BK);
  if (mk.causal) kb1 = min(kb1, (q0 + BQ - 1) / BK + 1);
  if (mk.window > 0) {
    const int lo = q0 - mk.window + 1;  // first key any row of the tile sees; the TPU
    kb0 = lo > 0 ? lo / BK : 0;         // kernel's floor division of a negative value is 0
  }                                     // after its clamp, and C's `/` truncates: keep lo > 0
}

// ---------------------------------------------------------------------------------------
// B1: forward

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

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse,
                 int H, int Hkv, Mask mk, float scale) {
  using C = Cfg<T>;
  constexpr int BQ = C::BQ, BK = C::BK, LDT = D + C::PAD, LDS = C::LDS, LDP = C::LDP, LDO = D + 4;
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
  int* segq = reinterpret_cast<int*>(smem + L.segq);
  int* segk = reinterpret_cast<int*>(smem + L.segk);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Tq = mk.Tq, Tk = mk.Tk;
  const int bh = blockIdx.y, b = bh / H, g = (bh % H) / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest (diagonal) tiles first
  const int nq = min(BQ, Tq - q0);
  const T* kg = k + (size_t)(b * Hkv + g) * Tk * D;
  const T* vg = v + (size_t)(b * Hkv + g) * Tk * D;

  load_rows<T, BQ, D>(Qs, LDT, q + ((size_t)bh * Tq + q0) * D, nq);
  for (int i = tid; i < BQ * D; i += NTHREADS) O[(i / D) * LDO + i % D] = 0.f;
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  if (seg != nullptr) load_vec(segq, BQ, seg + (size_t)b * Tq, q0, Tq, 0);
  else if (tid < BQ) segq[tid] = 0;
  int kb0, kb1;
  k_range<T>(q0, mk, kb0, kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done with Ks / Vs / Ps
    load_rows<T, BK, D>(Ks, LDT, kg + (size_t)k0 * D, Tk - k0);
    load_rows<T, BK, D>(Vs, LDT, vg + (size_t)k0 * D, Tk - k0);
    if (seg != nullptr) load_vec(segk, BK, seg + (size_t)b * Tk, k0, Tk, 0);
    else if (tid < BK) segk[tid] = 0;
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
        ok[j] = mk(q0 + r, k0 + c, segq[r], segk[c]);
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
  T* og = o + ((size_t)bh * Tq + q0) * D;
  for (int i = tid; i < nq * D; i += NTHREADS) {
    const int r = i / D;
    og[i] = from_f<T>(O[r * LDO + i % D] / fmaxf(l_s[r], 1e-20f));
  }
  if (tid < nq) lse[(size_t)bh * Tq + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-20f));
}

// ---------------------------------------------------------------------------------------
// B2: dq

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

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    T* __restrict__ dq, int H, int Hkv, Mask mk, float scale) {
  using C = Cfg<T>;
  constexpr int BQ = C::BQ, BK = C::BK, LDT = D + C::PAD, LDS = C::LDS, LDP = C::LDP, LDO = D + 4;
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
  int* segq = reinterpret_cast<int*>(smem + L.segq);
  int* segk = reinterpret_cast<int*>(smem + L.segk);

  const int tid = threadIdx.x;
  const int Tq = mk.Tq, Tk = mk.Tk;
  const int bh = blockIdx.y, b = bh / H, g = (bh % H) / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int nq = min(BQ, Tq - q0);
  const T* kg = k + (size_t)(b * Hkv + g) * Tk * D;
  const T* vg = v + (size_t)(b * Hkv + g) * Tk * D;
  const size_t row0 = (size_t)bh * Tq + q0;

  load_rows<T, BQ, D>(Qs, LDT, q + row0 * D, nq);
  load_rows<T, BQ, D>(dOs, LDT, dout + row0 * D, nq);
  for (int i = tid; i < BQ * D; i += NTHREADS) dQ[(i / D) * LDO + i % D] = 0.f;
  load_vec(lse_s, BQ, lse + (size_t)bh * Tq, q0, Tq, 0.f);
  load_vec(delta_s, BQ, delta + (size_t)bh * Tq, q0, Tq, 0.f);
  if (seg != nullptr) load_vec(segq, BQ, seg + (size_t)b * Tq, q0, Tq, 0);
  else if (tid < BQ) segq[tid] = 0;
  int kb0, kb1;
  k_range<T>(q0, mk, kb0, kb1);
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    load_rows<T, BK, D>(Ks, LDT, kg + (size_t)k0 * D, Tk - k0);
    load_rows<T, BK, D>(Vs, LDT, vg + (size_t)k0 * D, Tk - k0);
    if (seg != nullptr) load_vec(segk, BK, seg + (size_t)b * Tk, k0, Tk, 0);
    else if (tid < BK) segk[tid] = 0;
    __syncthreads();
    block_mm<BQ, BK, D, false, true>(Qs, LDT, Ks, LDT, S, LDS, false);    // q.k^T
    block_mm<BQ, BK, D, false, true>(dOs, LDT, Vs, LDT, dP, LDS, false);  // do.v^T
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const float p = mk(q0 + r, k0 + c, segq[r], segk[c]) ? expf(S[r * LDS + c] * scale - lse_s[r])
                                                          : 0.f;
      dSs[r * LDP + c] = from_f<T>(p * (dP[r * LDS + c] - delta_s[r]));
    }
    __syncthreads();
    block_mm<BQ, D, BK, false, false>(dSs, LDP, Ks, LDT, dQ, LDO, true);  // ds.k
  }
  __syncthreads();
  T* dqg = dq + row0 * D;
  for (int i = tid; i < nq * D; i += NTHREADS) dqg[i] = from_f<T>(scale * dQ[(i / D) * LDO + i % D]);
}

// ---------------------------------------------------------------------------------------
// B3: dk / dv

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

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ seg,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, Mask mk,
                     float scale) {
  using C = Cfg<T>;
  constexpr int BQ = C::BQ, BK = C::BK, LDT = D + C::PAD, LDS = C::LDS, LDP = C::LDP, LDO = D + 4;
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
  int* segq = reinterpret_cast<int*>(smem + L.segq);
  int* segk = reinterpret_cast<int*>(smem + L.segk);

  const int tid = threadIdx.x;
  const int Tq = mk.Tq, Tk = mk.Tk;
  const int bg = blockIdx.y, b = bg / Hkv, g = bg % Hkv, n_rep = H / Hkv;
  const int k0 = blockIdx.x * BK;  // low k tiles see the most q tiles: they start first
  const int nk = min(BK, Tk - k0);
  const size_t krow0 = (size_t)bg * Tk + k0;

  load_rows<T, BK, D>(Ks, LDT, k + krow0 * D, nk);
  load_rows<T, BK, D>(Vs, LDT, v + krow0 * D, nk);
  for (int i = tid; i < BK * D; i += NTHREADS) {
    dK[(i / D) * LDO + i % D] = 0.f;
    dV[(i / D) * LDO + i % D] = 0.f;
  }
  if (seg != nullptr) load_vec(segk, BK, seg + (size_t)b * Tk, k0, Tk, 0);
  else if (tid < BK) segk[tid] = 0;
  // q tiles that reach this k tile: from the diagonal (causal) to the window's end, the
  // bounds of the TPU kernels (:396-401, :603-608)
  const int qb0 = mk.causal ? k0 / BQ : 0;
  const int q_end = mk.window > 0 ? min(Tq, k0 + BK - 1 + mk.window) : Tq;
  const int qb1 = cdiv(q_end, BQ);
  for (int r = 0; r < n_rep; ++r) {
    const int bh = b * H + g * n_rep + r;
    for (int qb = qb0; qb < qb1; ++qb) {
      const int q0 = qb * BQ;
      const int nq = min(BQ, Tq - q0);
      const size_t row0 = (size_t)bh * Tq + q0;
      __syncthreads();  // the previous q tile's readers are done
      load_rows<T, BQ, D>(Qs, LDT, q + row0 * D, nq);
      load_rows<T, BQ, D>(dOs, LDT, dout + row0 * D, nq);
      load_vec(lse_s, BQ, lse + (size_t)bh * Tq, q0, Tq, 0.f);
      load_vec(delta_s, BQ, delta + (size_t)bh * Tq, q0, Tq, 0.f);
      if (seg != nullptr) load_vec(segq, BQ, seg + (size_t)b * Tq, q0, Tq, 0);
      else if (tid < BQ) segq[tid] = 0;
      __syncthreads();
      block_mm<BQ, BK, D, false, true>(Qs, LDT, Ks, LDT, S, LDS, false);    // q.k^T
      block_mm<BQ, BK, D, false, true>(dOs, LDT, Vs, LDT, dP, LDS, false);  // do.v^T
      __syncthreads();
      // P and dS overwrite S and dP in place for f32 (same thread, same slot)
      for (int i = tid; i < BQ * BK; i += NTHREADS) {
        const int rr = i / BK, c = i % BK;
        const float p = mk(q0 + rr, k0 + c, segq[rr], segk[c])
                            ? expf(S[rr * LDS + c] * scale - lse_s[rr]) : 0.f;
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
  T* dkg = dk + krow0 * D;
  T* dvg = dv + krow0 * D;
  for (int i = tid; i < nk * D; i += NTHREADS) {
    const int off = (i / D) * LDO + i % D;
    dkg[i] = from_f<T>(scale * dK[off]);
    dvg[i] = from_f<T>(dV[off]);
  }
}

// ---------------------------------------------------------------------------------------
// launches

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  const int* seg;
  void *o, *dk, *dv;
  float* lse_out;
  int B, H, Hkv;
  Mask mk;
  float scale;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_fwd(const Args& a) {
  const FwdSmem<T, D> L;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((a.mk.Tq + Cfg<T>::BQ - 1) / Cfg<T>::BQ, a.B * a.H);
  kern<<<grid, NTHREADS, L.bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.seg, (T*)a.o, a.lse_out, a.H, a.Hkv, a.mk,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const DqSmem<T, D> L;
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((a.mk.Tq + Cfg<T>::BQ - 1) / Cfg<T>::BQ, a.B * a.H);
  kern<<<grid, NTHREADS, L.bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse_in, a.delta, a.seg,
      (T*)a.o, a.H, a.Hkv, a.mk, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const DkvSmem<T, D> L;
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t e = allow_smem(kern, L.bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((a.mk.Tk + Cfg<T>::BK - 1) / Cfg<T>::BK, a.B * a.Hkv);
  kern<<<grid, NTHREADS, L.bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse_in, a.delta, a.seg,
      (T*)a.dk, (T*)a.dv, a.H, a.Hkv, a.mk, a.scale);
  return cudaGetLastError();
}

bool shape_ok(const Args& a, int Dh) {
  return a.B > 0 && a.Hkv > 0 && a.H % a.Hkv == 0 && a.H / a.Hkv <= NREP_MAX &&
         (Dh == 64 || Dh == 128) && a.mk.Tq > 0 && a.mk.Tk > 0;
}

template <template <typename, int> class Launch>
int dispatch(const Args& a, int Dh, int dtype) {
  if (!shape_ok(a, Dh)) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && Dh == 128) return (int)Launch<__nv_bfloat16, 128>::go(a);
  if (dtype == 0 && Dh == 64) return (int)Launch<__nv_bfloat16, 64>::go(a);
  if (dtype == 1 && Dh == 128) return (int)Launch<float, 128>::go(a);
  if (dtype == 1 && Dh == 64) return (int)Launch<float, 64>::go(a);
  return (int)cudaErrorInvalidValue;
}
template <typename T, int D> struct Fwd { static cudaError_t go(const Args& a) { return launch_fwd<T, D>(a); } };
template <typename T, int D> struct Dq { static cudaError_t go(const Args& a) { return launch_dq<T, D>(a); } };
template <typename T, int D> struct Dkv { static cudaError_t go(const Args& a) { return launch_dkv<T, D>(a); } };

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. q/o/dout [B, H, Tq, Dh], k/v [B, Hkv, Tk, Dh], lse and
// delta [B, H, Tq] f32, seg [B, T] int32 (Tq == Tk) or NULL; all contiguous. Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for what it does not take).
extern "C" int tt_flash_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
                            float* lse, int B, int H, int Hkv, int Tq, int Tk, int Dh, int causal,
                            int window, float scale, int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, seg, o, nullptr, nullptr, lse,
         B, H, Hkv, Mask{Tq, Tk, causal, window}, scale, (cudaStream_t)stream};
  return dispatch<Fwd>(a, Dh, dtype);
}

extern "C" int tt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, const int* seg, void* dq,
                               int B, int H, int Hkv, int Tq, int Tk, int Dh, int causal,
                               int window, float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, seg, dq, nullptr, nullptr, nullptr,
         B, H, Hkv, Mask{Tq, Tk, causal, window}, scale, (cudaStream_t)stream};
  return dispatch<Dq>(a, Dh, dtype);
}

extern "C" int tt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const int* seg, void* dk,
                                void* dv, int B, int H, int Hkv, int Tq, int Tk, int Dh,
                                int causal, int window, float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, seg, nullptr, dk, dv, nullptr,
         B, H, Hkv, Mask{Tq, Tk, causal, window}, scale, (cudaStream_t)stream};
  return dispatch<Dkv>(a, Dh, dtype);
}
