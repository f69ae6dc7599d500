// Weight-only int8 matmul: out[M, N] = bf16((x[M, K] @ q[K, N]) * scale[N]).
//
// Replaces the Pallas TPU kernel tony_tpu/ops/quant.py:54 `_quant_matmul_kernel`
// (launched by `int8_matmul`, quant.py:78). Takes bfloat16 x only: the TPU
// kernel casts x to bf16 before its dot (quant.py:66), int8 -> bf16 is exact,
// and bf16 is the serving dtype; the wrapper raises on any other x dtype.
// Accumulation is f32; the per-N-channel scale lands in the epilogue.
//
// Bound on this card: at decode sizes (M <= 32) bytes, the int8 weight
// (K*N B) read once; at prefill sizes operations (2*M*K*N at the bf16
// tensor-core rate). The design streams the weight at 1 B/element and never
// writes a bf16 copy of it: each block owns a BM x BN output tile, loads a
// BK-deep slab of x (bf16) and of q (int8) per step, converts q to bf16 in
// registers on its way into shared memory, and runs WMMA bf16 16x16x16
// products with f32 accumulators. The next slab is loaded into registers
// while the current one is multiplied. Decode-sized M leaves few output
// tiles (N = 1024 gives 16), so K is split over grid.z until about two
// blocks per SM are in flight; split partials go to an f32 workspace and a
// second kernel sums them in a fixed order (no atomics: identical inputs
// give identical bits), scales and casts. Every M from 1 up is taken; ragged
// M and N edges are masked. K and N must be multiples of 16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 32, BN = 64, BK = 128;
constexpr int NTHREADS = 128;         // 4 warps; warp w owns rows (w%2)*16, cols (w/2)*32..+32
constexpr int XLD = BK + 8;           // padded leading dims (multiples of 8 for wmma)
constexpr int WLD = BN + 8;
constexpr int CLD = BN + 4;
constexpr int X_CHUNKS = BM * BK / 8;     // 16-byte chunks of the x slab (8 bf16 each)
constexpr int W_CHUNKS = BK * BN / 16;    // 16-byte chunks of the q slab (16 int8 each)
constexpr int X_PER = X_CHUNKS / NTHREADS;
constexpr int W_PER = W_CHUNKS / NTHREADS;

// shared memory as raw bytes: the x and q slabs, reused for the f32 output tile
constexpr int X_BYTES = BM * XLD * 2;     // 8704: keeps the q slab 32-byte aligned
constexpr int W_BYTES = BK * WLD * 2;
constexpr int C_BYTES = BM * CLD * 4;
constexpr int SMEM_BYTES = X_BYTES + W_BYTES > C_BYTES ? X_BYTES + W_BYTES : C_BYTES;

__device__ __forceinline__ void load_slab(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    int M, int N, int K, int m0, int n0, int k0, uint4 (&xr)[X_PER], uint4 (&wr)[W_PER]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < X_PER; ++i) {
    const int idx = tid + i * NTHREADS;
    const int row = idx / (BK / 8), c = idx % (BK / 8);
    const int m = m0 + row, kk = k0 + c * 8;
    xr[i] = (m < M && kk < K)
        ? *reinterpret_cast<const uint4*>(x + (size_t)m * K + kk) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < W_PER; ++i) {
    const int idx = tid + i * NTHREADS;
    const int row = idx / (BN / 16), c = idx % (BN / 16);
    const int kk = k0 + row, n = n0 + c * 16;
    wr[i] = (kk < K && n < N)
        ? *reinterpret_cast<const uint4*>(q + (size_t)kk * N + n) : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void store_slab(__nv_bfloat16* xs, __nv_bfloat16* wsm,
                                           const uint4 (&xr)[X_PER], const uint4 (&wr)[W_PER]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < X_PER; ++i) {
    const int idx = tid + i * NTHREADS;
    const int row = idx / (BK / 8), c = idx % (BK / 8);
    *reinterpret_cast<uint4*>(xs + row * XLD + c * 8) = xr[i];
  }
#pragma unroll
  for (int i = 0; i < W_PER; ++i) {
    const int idx = tid + i * NTHREADS;
    const int row = idx / (BN / 16), c = idx % (BN / 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&wr[i]);
    __align__(16) __nv_bfloat16 h[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) h[e] = __float2bfloat16_rn((float)b[e]);  // exact for |v| <= 127
    uint4* dst = reinterpret_cast<uint4*>(wsm + row * WLD + c * 16);
    dst[0] = reinterpret_cast<const uint4*>(h)[0];
    dst[1] = reinterpret_cast<const uint4*>(h)[1];
  }
}

__global__ void __launch_bounds__(NTHREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ ws, int M, int N, int K, int tiles_per_split) {
  __shared__ __align__(32) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + X_BYTES);
  float* cs = reinterpret_cast<float*>(smem);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, (K + BK - 1) / BK);
  const int warp = threadIdx.x / 32;
  const int wm = (warp % 2) * 16, wn = (warp / 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  uint4 xr[X_PER], wr[W_PER];
  if (kt0 < kt1) load_slab(x, q, M, N, K, m0, n0, kt0 * BK, xr, wr);
  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();  // readers of the previous slab are done
    store_slab(xs, wsm, xr, wr);
    __syncthreads();
    if (kt + 1 < kt1) load_slab(x, q, M, N, K, m0, n0, (kt + 1) * BK, xr, wr);  // in flight during the mma
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + wm * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wsm + kk * WLD + wn + j * 16, WLD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(cs + wm * CLD + wn + j * 16, acc[j], CLD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float a = cs[r * CLD + c];
    if (ws == nullptr) {
      out[(size_t)m * N + n] = __float2bfloat16_rn(a * scale[n]);
    } else {
      ws[((size_t)blockIdx.z * M + m) * N + n] = a;
    }
  }
}

__global__ void split_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                                    __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
  const size_t MN = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f;
    for (int z = 0; z < splits; ++z) a += ws[z * MN + i];  // fixed order: deterministic
    out[i] = __float2bfloat16_rn(a * scale[i % N]);
  }
}

}  // namespace

// Number of K splits the launcher uses for this shape (the caller sizes the
// f32 workspace [splits, M, N] from it; 1 means no workspace).
extern "C" int tt_int8_matmul_splits(int M, int N, int K, int num_sms) {
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int kt = (K + BK - 1) / BK;
  int splits = (2 * num_sms + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > kt ? kt : splits);
  splits = splits > 16 ? 16 : splits;
  const int tps = (kt + splits - 1) / splits;
  return (kt + tps - 1) / tps;
}

// x [M, K] bf16, q [K, N] int8, scale [N] f32, out [M, N] bf16; ws is the
// [splits, M, N] f32 workspace (NULL when splits == 1). Returns
// cudaGetLastError() after the launches.
extern "C" int tt_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                              void* ws, int M, int N, int K, int splits, void* stream) {
  if (M < 1 || K % 16 != 0 || N % 16 != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kt = (K + BK - 1) / BK;
  const int tps = (kt + splits - 1) / splits;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_matmul_kernel<<<grid, NTHREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)scale, (__nv_bfloat16*)out,
      splits > 1 ? (float*)ws : nullptr, M, N, K, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t MN = (size_t)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  split_reduce_kernel<<<blocks, 256, 0, st>>>((const float*)ws, (const float*)scale,
                                              (__nv_bfloat16*)out, M, N, splits);
  return (int)cudaGetLastError();
}
