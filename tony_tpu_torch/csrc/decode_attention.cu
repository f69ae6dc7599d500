// One-token decode attention per slot over a read-only KV cache, dense or paged.
//
// Replaces the Pallas TPU kernel tony_tpu/ops/decode_attention.py:49 `_kernel`
// in both its launch sites: `ragged_decode_attention` (dense cache
// [S, Hkv, maxT, Dh]) and `paged_decode_attention` (page pool
// [P, Hkv, page_len, Dh] read through page_table[s, pos / page_len], with an
// optional staged window staged_k/v [S, W, Hkv, Dh] + staged_count [S]).
//
// Maths (identical to the TPU kernel): slot s, kv head g, its n_rep query
// heads. Cache band [lo, pool_len) with lo = max(0, len+1-window) when
// window > 0 else 0 and pool_len = max(len - count, 0); then the `count`
// staged entries at positions pool_len + j (valid when >= lo); then the
// current token cur_k/cur_v, always valid, so a zero-length slot still
// normalises. Online softmax in f32, q pre-scaled by Dh^-0.5, o in q's type.
//
// Bound on this card: bytes. The step reads each slot's band of K and V once
// (sum_s band_s * Hkv * Dh * 2 tensors * 2 B) and does ~4 flops per byte, far
// below the H100's ~295 flop/B ridge. The design reads only the band: one
// block per (kv head, slot) walks its positions in tiles of TILE rows,
// independent of page_len (a 256-position bf16 page of K and V is 128 KB,
// beyond 48 KB of static shared memory). The n_rep query heads of the group
// share every K/V tile staged in shared memory, so K/V are read from device
// memory once per group. Split-K over positions (8 slots x 8 kv heads fill
// only 64 of 132 SMs) and cp.async/TMA double buffering are left for a
// later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
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

// TILE rows of K and V in shared memory: 64 rows of bf16 at Dh=128 is 32 KB.
template <typename T, int DH>
struct Tile {
  static constexpr int ROWS = 64 * 2 / (int)sizeof(T);  // 64 bf16 rows, 32 f32 rows
  static constexpr int CH = DH * (int)sizeof(T) / 16;   // 16-byte chunks per row
};

template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, const int* __restrict__ page_table, int max_pages,
    const T* __restrict__ cur_k, const T* __restrict__ cur_v,
    const T* __restrict__ staged_k, const T* __restrict__ staged_v,
    const int* __restrict__ staged_count, int W,
    T* __restrict__ o, int H, int Hkv, int T_len, int window) {
  constexpr int ROWS = Tile<T, DH>::ROWS;
  constexpr int CH = Tile<T, DH>::CH;
  constexpr int PER = DH / 32;  // elements of one row each lane holds

  __shared__ __align__(16) unsigned char kv_raw[2 * ROWS * DH * sizeof(T)];
  T* ks = reinterpret_cast<T*>(kv_raw);
  T* vs = ks + ROWS * DH;
  __shared__ float qs[NREP_MAX][DH];
  __shared__ float sc[NREP_MAX][ROWS];
  __shared__ float m_s[NREP_MAX], l_s[NREP_MAX], alpha_s[NREP_MAX];
  __shared__ const T* krow[ROWS];
  __shared__ const T* vrow[ROWS];
  __shared__ bool valid[ROWS];

  const int g = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_rep = H / Hkv;
  const bool paged = page_table != nullptr;

  const int len = lengths[s];
  const int count = staged_count != nullptr ? staged_count[s] : 0;
  const int pool_len = max(len - count, 0);
  const int lo = window > 0 ? max(len + 1 - window, 0) : 0;
  const float scale = 1.0f / sqrtf((float)DH);

  for (int i = tid; i < n_rep * DH; i += NTHREADS) {
    const int r = i / DH, d = i % DH;
    qs[r][d] = to_f(q[((size_t)s * H + g * n_rep + r) * DH + d]) * scale;
  }
  if (tid < NREP_MAX) { m_s[tid] = NEG; l_s[tid] = 0.f; }
  float acc[NREP_MAX];
#pragma unroll
  for (int r = 0; r < NREP_MAX; ++r) acc[r] = 0.f;

  // three segments, one tile loop: 0 = pool band, 1 = staged window, 2 = current token
  for (int seg = 0; seg < 3; ++seg) {
    int first, n_total;
    if (seg == 0) { first = lo; n_total = max(pool_len - lo, 0); }
    else if (seg == 1) { first = 0; n_total = staged_k != nullptr ? count : 0; }
    else { first = 0; n_total = 1; }
    for (int t0 = 0; t0 < n_total; t0 += ROWS) {
      const int n_rows = min(ROWS, n_total - t0);
      __syncthreads();  // the previous tile's readers are done with smem
      if (tid < n_rows) {
        const int j = first + t0 + tid;
        const T *kp, *vp;
        bool ok = true;
        if (seg == 0) {
          size_t base;
          if (paged) {
            const int page = page_table[(size_t)s * max_pages + j / T_len];
            base = (((size_t)page * Hkv + g) * T_len + j % T_len) * DH;
          } else {
            base = (((size_t)s * Hkv + g) * T_len + j) * DH;
          }
          kp = k + base; vp = v + base;
        } else if (seg == 1) {
          const size_t base = (((size_t)s * W + j) * Hkv + g) * DH;
          kp = staged_k + base; vp = staged_v + base;
          ok = pool_len + j >= lo;
        } else {
          const size_t base = ((size_t)s * Hkv + g) * DH;
          kp = cur_k + base; vp = cur_v + base;
        }
        krow[tid] = kp; vrow[tid] = vp; valid[tid] = ok;
      }
      __syncthreads();
      for (int idx = tid; idx < ROWS * CH; idx += NTHREADS) {
        const int row = idx / CH, c = idx % CH;
        uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
        if (row < n_rows && valid[row]) {
          kv4 = reinterpret_cast<const uint4*>(krow[row])[c];
          vv4 = reinterpret_cast<const uint4*>(vrow[row])[c];
        }
        reinterpret_cast<uint4*>(ks + row * DH)[c] = kv4;
        reinterpret_cast<uint4*>(vs + row * DH)[c] = vv4;
      }
      __syncthreads();
      // scores: one warp per key row, lanes split the head dim
      for (int i = warp; i < n_rows; i += NWARPS) {
        float kf[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e) kf[e] = to_f(ks[i * DH + lane * PER + e]);
        for (int r = 0; r < n_rep; ++r) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < PER; ++e) part += qs[r][lane * PER + e] * kf[e];
          part = warp_sum(part);
          if (lane == 0) sc[r][i] = valid[i] ? part : NEG;
        }
      }
      __syncthreads();
      // online softmax: one warp per query row
      for (int r = warp; r < n_rep; r += NWARPS) {
        float mx = NEG;
        for (int i = lane; i < n_rows; i += 32) mx = fmaxf(mx, sc[r][i]);
        mx = warp_max(mx);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int i = lane; i < n_rows; i += 32) {
          const float p = valid[i] ? expf(sc[r][i] - m_new) : 0.f;
          sc[r][i] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          alpha_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();
      // p @ V: thread d owns output column d for every query row of the group
      if (tid < DH) {
#pragma unroll
        for (int r = 0; r < NREP_MAX; ++r)
          if (r < n_rep) acc[r] *= alpha_s[r];
        for (int i = 0; i < n_rows; ++i) {
          const float vv = to_f(vs[i * DH + tid]);
#pragma unroll
          for (int r = 0; r < NREP_MAX; ++r)
            if (r < n_rep) acc[r] += sc[r][i] * vv;
        }
      }
    }
  }
  if (tid < DH) {
#pragma unroll
    for (int r = 0; r < NREP_MAX; ++r)
      if (r < n_rep)
        o[((size_t)s * H + g * n_rep + r) * DH + tid] = from_f<T>(acc[r] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   const int* page_table, int max_pages, const void* cur_k, const void* cur_v,
                   const void* staged_k, const void* staged_v, const int* staged_count, int W,
                   void* o, int S, int H, int Hkv, int T_len, int window, cudaStream_t stream) {
  dim3 grid(Hkv, S);
  decode_attention_kernel<T, DH><<<grid, NTHREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, page_table, max_pages,
      (const T*)cur_k, (const T*)cur_v, (const T*)staged_k, (const T*)staged_v,
      staged_count, W, (T*)o, H, Hkv, T_len, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. page_table == NULL selects the dense
// cache [S, Hkv, T_len=maxT, Dh]; otherwise the pool [P, Hkv, T_len=page_len, Dh].
// staged_k == NULL means no staged window. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported dtype / Dh / n_rep).
extern "C" int tt_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    const int* page_table, int max_pages, const void* cur_k, const void* cur_v,
    const void* staged_k, const void* staged_v, const int* staged_count, int W,
    void* o, int S, int H, int Hkv, int Dh, int T_len, int window, int dtype,
    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > NREP_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define TT_ARGS q, k, v, lengths, page_table, max_pages, cur_k, cur_v, staged_k, staged_v, \
                staged_count, W, o, S, H, Hkv, T_len, window, st
  if (dtype == 0 && Dh == 128) return (int)launch<__nv_bfloat16, 128>(TT_ARGS);
  if (dtype == 0 && Dh == 64) return (int)launch<__nv_bfloat16, 64>(TT_ARGS);
  if (dtype == 1 && Dh == 128) return (int)launch<float, 128>(TT_ARGS);
  if (dtype == 1 && Dh == 64) return (int)launch<float, 64>(TT_ARGS);
#undef TT_ARGS
  return (int)cudaErrorInvalidValue;
}
