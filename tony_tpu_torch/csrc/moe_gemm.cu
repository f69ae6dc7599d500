// Grouped SwiGLU expert MLP for MoE: forward (B7) and backward (B8).
//
// Replaces the Pallas TPU kernels of tony_tpu/ops/moe_gemm.py:
//   tt_moe_fwd  <- `_fwd_kernel` (:104, launched by `_fwd_call` at :198)
//   tt_moe_bwd  <- `_bwd_kernel` (:128, launched by `_bwd_call` at :238)
//
// Maths (identical to the TPU kernels): rows xs [PN, D] arrive sorted by expert, every
// expert's span padded to whole row tiles of TILE = 128 rows, and tile_group [PN/128] names
// the expert of each row tile (non-decreasing). With e = tile_group[i / 128]:
//   g = xs[i].Wg[e], u = xs[i].Wu[e] (f32), h = bf16(silu(g) * u), ys[i] = bf16(h.Wd[e])
// and the backward, from dy [PN, D]:
//   dh = dy.Wd[e]^T, du = bf16(dh * silu(g)), dg = bf16(dh * u * s * (1 + g * (1 - s))),
//   s = sigmoid(g); dxs = bf16(dg.Wg[e]^T + du.Wu[e]^T);
//   dWg[e] = xs^T.dg, dWu[e] = xs^T.du, dWd[e] = h^T.dy over the expert's rows, each summed
//   in f32 and written once in bf16 (the parameter type).
// Wg/Wu [E, D, F], Wd [E, F, D], all bf16. An expert that owns no row tile gets dW = 0.
//
// Bound on this card: operations. At the Mixtral-8x7B training shape (D 4096, F 14336,
// 16k routed rows) B7 does 6*N*D*F and B8 16*N*D*F flops against ~3 GB of weights: far
// above the ~295 flop/B ridge. The TPU kernel keeps a [128, F] intermediate and the
// expert's weight slabs (~100 MB) in VMEM for one pass per row tile; a Hopper SM has
// 228 KB of shared memory, so the design splits the work into GEMM passes that each keep
// one 128 x 64 output tile in registers and write the bf16 intermediate once:
//   B7  (a) per (row tile, F tile): g and u accumulators, epilogue h = bf16(silu(g) * u)
//           into an [PN, F] scratch (the TPU kernel's own rounding point);
//       (b) per (row tile, D tile): ys = h.Wd[e].
//   B8  (a) per (row tile, F tile): g, u and dh accumulators; epilogue writes h, dg, du;
//       (b) per (row tile, D tile): dxs = dg.Wg[e]^T + du.Wu[e]^T;
//       (c) per (expert, output tile) of dWg / dWu / dWd: the block finds its expert's row
//           tiles in tile_group and loops over them, summing in f32 registers; no atomics,
//           so the same inputs give the same bits.
// Every product runs on the tensor cores through WMMA bf16 16x16x16 tiles with f32
// accumulate: 256 threads, a 128 x 64 block tile, 32-deep K slabs staged through shared
// memory (the next slab is loaded into registers while the current one is multiplied).
// Operands stored transposed (Wd in dh, Wg/Wu in dxs, xs/h in the weight gradients) are
// staged as stored and read with column-major fragments. D and F must be multiples of
// 128 and PN of 128, so no tile is ragged. wgmma/TMA pipelining comes later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TILE = 128;                // routing row tile
constexpr int BM = 128, BN = 64, BK = 32;
constexpr int NT = 256;                  // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int ROW = 0, COL = 1;
// A: ROW -> A[m * lda + k], COL -> A[k * lda + m]; B: ROW -> B[k * ldb + n], COL -> B[n * ldb + k]

template <int L, int MN>  // shared tile of an operand: R rows of C contiguous elements
struct Stage {
  static constexpr int R = L == ROW ? MN : BK;
  static constexpr int C = L == ROW ? BK : MN;
  static constexpr int LD = C + 8;       // 16-byte pad: banks shift by row, fragments stay aligned
  static constexpr int ELEMS = R * LD;
  static constexpr int PER = R * C / 8 / NT;   // 16-byte chunks per thread
};
template <int AL> using SA = Stage<AL, BM>;
// B is stored [k][n] (ROW) or [n][k] (COL): the same shapes with the roles of the dims swapped
template <int BL> using SB = Stage<BL == ROW ? COL : ROW, BN>;

constexpr int CLD = BN + 4;
constexpr int SMEM_MAIN = (BM * (BK + 8) > BK * (BM + 8) ? BM * (BK + 8) : BK * (BM + 8)) * 2
                        + (BK * (BN + 8) > BN * (BK + 8) ? BK * (BN + 8) : BN * (BK + 8)) * 2;
constexpr int SMEM_EPI = BM * CLD * 4;
constexpr int SMEM_BYTES = SMEM_MAIN > SMEM_EPI ? SMEM_MAIN : SMEM_EPI;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using Tile = Acc[2][2];

template <int R, int C, int PER>
__device__ __forceinline__ void gload(const bf16* __restrict__ base, size_t ld, uint4 (&r)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int row = idx / (C / 8), c = idx % (C / 8);
    r[i] = *reinterpret_cast<const uint4*>(base + (size_t)row * ld + c * 8);
  }
}

template <int C, int LD, int PER>
__device__ __forceinline__ void sstore(bf16* s, const uint4 (&r)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int row = idx / (C / 8), c = idx % (C / 8);
    *reinterpret_cast<uint4*>(s + row * LD + c * 8) = r[i];
  }
}

__device__ __forceinline__ void zero(Tile& t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(t[i][j], 0.f);
}

// acc += A[0:BM, 0:K] . B[0:K, 0:BN]; A and B point at the tile's origin.
template <int AL, int BL>
__device__ void gemm(Tile& acc, const bf16* __restrict__ A, size_t lda, const bf16* __restrict__ B,
                     size_t ldb, int K, unsigned char* smem) {
  using Sa = SA<AL>;
  using Sb = SB<BL>;
  using LA = typename std::conditional<AL == ROW, wmma::row_major, wmma::col_major>::type;
  using LB = typename std::conditional<BL == ROW, wmma::row_major, wmma::col_major>::type;
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + Sa::ELEMS;
  const int warp = threadIdx.x / 32;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  // the K step moves along the contiguous dim of a ROW A / COL B, across rows otherwise
  const size_t astep = AL == ROW ? BK : BK * lda;
  const size_t bstep = BL == ROW ? BK * ldb : BK;
  uint4 ar[Sa::PER], br[Sb::PER];
  if (K > 0) {
    gload<Sa::R, Sa::C>(A, lda, ar);
    gload<Sb::R, Sb::C>(B, ldb, br);
  }
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every warp is done with the previous slab (or the caller's epilogue)
    sstore<Sa::C, Sa::LD>(as, ar);
    sstore<Sb::C, Sb::LD>(bs, br);
    __syncthreads();
    if (k0 + BK < K) {  // in flight during the products below
      gload<Sa::R, Sa::C>(A + (k0 / BK + 1) * astep, lda, ar);
      gload<Sb::R, Sb::C>(B + (k0 / BK + 1) * bstep, ldb, br);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + i * 16;
        wmma::load_matrix_sync(a[i], AL == ROW ? as + m * Sa::LD + kk : as + kk * Sa::LD + m, Sa::LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + j * 16;
        wmma::load_matrix_sync(b[j], BL == ROW ? bs + kk * Sb::LD + n : bs + n * Sb::LD + kk, Sb::LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
}

// Write one BM x BN tile in bf16 at out (row pitch ldo): each element is fn(fragment index
// i, j, element t) in f32, staged through shared memory for 16-byte stores. Fragments of
// one type share their element-to-thread mapping, so fn may combine several accumulators.
template <typename Fn>
__device__ void emit(bf16* __restrict__ out, size_t ldo, unsigned char* smem, Fn fn) {
  float* cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  const int wm = (warp % 4) * 32, wn = (warp / 4) * 32;
  __syncthreads();  // the main loop's last slab is no longer read
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Acc f;
#pragma unroll
      for (int t = 0; t < f.num_elements; ++t) f.x[t] = fn(i, j, t);
      wmma::store_matrix_sync(cs + (wm + i * 16) * CLD + wn + j * 16, f, CLD, wmma::mem_row_major);
    }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < BM * BN / 8 / NT; ++q) {
    const int idx = threadIdx.x + q * NT;
    const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(cs[r * CLD + c + e]);
    *reinterpret_cast<uint4*>(out + (size_t)r * ldo + c) = *reinterpret_cast<const uint4*>(v);
  }
}

__device__ __forceinline__ float sigmoid(float g) { return 1.f / (1.f + expf(-g)); }

// B7 (a), B8 (a): block (F tile, row tile). With dy == nullptr only h is written.
__global__ void __launch_bounds__(NT)
moe_up_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ dy, const bf16* __restrict__ wg,
              const bf16* __restrict__ wu, const bf16* __restrict__ wd, const int* __restrict__ tg,
              bf16* __restrict__ h, bf16* __restrict__ dg, bf16* __restrict__ du, int D, int F) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int n0 = blockIdx.x * BN;
  const size_t m0 = (size_t)blockIdx.y * BM;
  const size_t e = tg[blockIdx.y];
  const size_t DF = (size_t)D * F;
  Tile G, U;
  zero(G);
  zero(U);
  gemm<ROW, ROW>(G, xs + m0 * D, D, wg + e * DF + n0, F, D, smem);
  gemm<ROW, ROW>(U, xs + m0 * D, D, wu + e * DF + n0, F, D, smem);
  bf16* hout = h + m0 * F + n0;
  if (dy == nullptr) {
    emit(hout, F, smem, [&](int i, int j, int t) {
      const float g = G[i][j].x[t];
      return g * sigmoid(g) * U[i][j].x[t];
    });
    return;
  }
  Tile DH;
  zero(DH);
  // dh[r, f] = sum_d dy[r, d] Wd[e][f, d]: Wd read as stored, [f][d], column-major B
  gemm<ROW, COL>(DH, dy + m0 * D, D, wd + e * DF + (size_t)n0 * D, D, D, smem);
  emit(hout, F, smem, [&](int i, int j, int t) {
    const float g = G[i][j].x[t];
    return g * sigmoid(g) * U[i][j].x[t];
  });
  emit(du + m0 * F + n0, F, smem, [&](int i, int j, int t) {
    const float g = G[i][j].x[t];
    return DH[i][j].x[t] * (g * sigmoid(g));
  });
  emit(dg + m0 * F + n0, F, smem, [&](int i, int j, int t) {
    const float g = G[i][j].x[t], s = sigmoid(g);
    return DH[i][j].x[t] * U[i][j].x[t] * (s * (1.f + g * (1.f - s)));
  });
}

// B7 (b): ys = h . Wd[e]; block (D tile, row tile).
__global__ void __launch_bounds__(NT)
moe_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ wd, const int* __restrict__ tg,
                bf16* __restrict__ ys, int D, int F) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int n0 = blockIdx.x * BN;
  const size_t m0 = (size_t)blockIdx.y * BM;
  const size_t e = tg[blockIdx.y];
  Tile Y;
  zero(Y);
  gemm<ROW, ROW>(Y, h + m0 * F, F, wd + e * (size_t)D * F + n0, D, F, smem);
  emit(ys + m0 * D + n0, D, smem, [&](int i, int j, int t) { return Y[i][j].x[t]; });
}

// B8 (b): dxs = dg . Wg[e]^T + du . Wu[e]^T; block (D tile, row tile).
__global__ void __launch_bounds__(NT)
moe_dx_kernel(const bf16* __restrict__ dg, const bf16* __restrict__ du, const bf16* __restrict__ wg,
              const bf16* __restrict__ wu, const int* __restrict__ tg, bf16* __restrict__ dxs,
              int D, int F) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int n0 = blockIdx.x * BN;
  const size_t m0 = (size_t)blockIdx.y * BM;
  const size_t eDF = (size_t)tg[blockIdx.y] * D * F;
  Tile X;
  zero(X);
  // Wg[e] read as stored, [d][f]: B(k = f, n = d) is column-major
  gemm<ROW, COL>(X, dg + m0 * F, F, wg + eDF + (size_t)n0 * F, F, F, smem);
  gemm<ROW, COL>(X, du + m0 * F, F, wu + eDF + (size_t)n0 * F, F, F, smem);
  emit(dxs + m0 * D + n0, D, smem, [&](int i, int j, int t) { return X[i][j].x[t]; });
}

// B8 (c): block (output tile, expert, which): which 0 -> dWg = xs^T.dg, 1 -> dWu = xs^T.du
// (both [D, F]), 2 -> dWd = h^T.dy ([F, D]). The K loop runs over the expert's row tiles.
__global__ void __launch_bounds__(NT)
moe_dw_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ dy, const bf16* __restrict__ h,
              const bf16* __restrict__ dg, const bf16* __restrict__ du, const int* __restrict__ tg,
              int ntiles, bf16* __restrict__ dwg, bf16* __restrict__ dwu, bf16* __restrict__ dwd,
              int D, int F) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int s_lo, s_hi;
  const int e = blockIdx.y, which = blockIdx.z;
  if (threadIdx.x == 0) {
    s_lo = ntiles;
    s_hi = 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ntiles; t += NT)
    if (tg[t] == e) {
      atomicMin(&s_lo, t);
      atomicMax(&s_hi, t + 1);
    }
  __syncthreads();
  const int lo = s_lo, K = s_hi > s_lo ? (s_hi - s_lo) * TILE : 0;
  const size_t r0 = (size_t)lo * TILE;
  const int M = which < 2 ? D : F, N = which < 2 ? F : D;
  const int m0 = (blockIdx.x / (N / BN)) * BM, n0 = (blockIdx.x % (N / BN)) * BN;
  const bf16* A = which < 2 ? xs : h;                        // [rows][M]: column-major A
  const bf16* B = which == 0 ? dg : which == 1 ? du : dy;    // [rows][N]
  bf16* out = (which == 0 ? dwg : which == 1 ? dwu : dwd) + (size_t)e * D * F;
  Tile W;
  zero(W);
  gemm<COL, ROW>(W, A + r0 * M + m0, M, B + r0 * N + n0, N, K, smem);
  emit(out + (size_t)m0 * N + n0, N, smem, [&](int i, int j, int t) { return W[i][j].x[t]; });
}

bool shapes_ok(int PN, int D, int F, int E) {
  return PN > 0 && PN % TILE == 0 && D > 0 && D % BM == 0 && F > 0 && F % BM == 0 && E > 0;
}

}  // namespace

// xs [PN, D], wg/wu [E, D, F], wd [E, F, D], tile_group [PN/128] int32, h [PN, F] scratch,
// ys [PN, D]; all bf16 but tile_group. Returns cudaGetLastError() after the launches.
extern "C" int tt_moe_fwd(const void* xs, const void* wg, const void* wu, const void* wd,
                          const int* tile_group, void* h, void* ys, int PN, int D, int F, int E,
                          void* stream) {
  if (!shapes_ok(PN, D, F, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  moe_up_kernel<<<dim3(F / BN, PN / BM), NT, 0, st>>>(
      (const bf16*)xs, nullptr, (const bf16*)wg, (const bf16*)wu, nullptr, tile_group, (bf16*)h,
      nullptr, nullptr, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_down_kernel<<<dim3(D / BN, PN / BM), NT, 0, st>>>((const bf16*)h, (const bf16*)wd, tile_group,
                                                        (bf16*)ys, D, F);
  return (int)cudaGetLastError();
}

// dy [PN, D]; h, dg, du [PN, F] scratch; dxs [PN, D]; dwg, dwu [E, D, F], dwd [E, F, D].
extern "C" int tt_moe_bwd(const void* xs, const void* dy, const void* wg, const void* wu,
                          const void* wd, const int* tile_group, void* h, void* dg, void* du,
                          void* dxs, void* dwg, void* dwu, void* dwd, int PN, int D, int F, int E,
                          void* stream) {
  if (!shapes_ok(PN, D, F, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  moe_up_kernel<<<dim3(F / BN, PN / BM), NT, 0, st>>>(
      (const bf16*)xs, (const bf16*)dy, (const bf16*)wg, (const bf16*)wu, (const bf16*)wd,
      tile_group, (bf16*)h, (bf16*)dg, (bf16*)du, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_dx_kernel<<<dim3(D / BN, PN / BM), NT, 0, st>>>((const bf16*)dg, (const bf16*)du,
                                                      (const bf16*)wg, (const bf16*)wu, tile_group,
                                                      (bf16*)dxs, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_dw_kernel<<<dim3((D / BM) * (F / BN), E, 3), NT, 0, st>>>(
      (const bf16*)xs, (const bf16*)dy, (const bf16*)h, (const bf16*)dg, (const bf16*)du, tile_group,
      PN / TILE, (bf16*)dwg, (bf16*)dwu, (bf16*)dwd, D, F);
  return (int)cudaGetLastError();
}
