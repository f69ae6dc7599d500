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
// Bound on this card. At the Mixtral-8x7B training shape (D 4096, F 14336, 16k routed rows)
// operations: B7 does 6*N*D*F and B8 16*N*D*F flops against ~2.8 GB of weights, far above
// the ~295 flop/B ridge. For one 1000-token prefill bytes: ~3 row tiles an expert, so every
// weight panel serves 3 row tiles and the 2.8 GB of weights, read once, set the floor.
// The TPU kernel keeps a [128, F] intermediate and the expert's weight slabs in VMEM for one
// pass per row tile; a Hopper SM has 227 KB of shared memory, so the work is split into GEMM
// passes, each a 128 x 128 output tile a block with its f32 accumulators in registers:
//   B7  UP     per (row tile, F tile): g and u, epilogue h = bf16(silu(g) * u) into an
//              [PN, F] scratch (the TPU kernel's own rounding point);
//       DOWN   per (row tile, D tile): ys = h.Wd[e].
//   B8  UP_BWD per (row tile, F tile): g and u over xs, then dh over dy; epilogue h, dg, du;
//       DX     per (row tile, D tile): dxs = dg.Wg[e]^T + du.Wu[e]^T in one accumulator;
//       DW_GU  per (expert, D tile, F tile): dWg and dWu from one xs tile, K = the expert's rows;
//       DW_D   per (expert, F tile, D tile): dWd = h^T.dy.
// The design, against what bounds it:
//   - one warp-specialised body for all six passes: 384 threads, a producer warpgroup lowered
//     to 24 registers of which one thread issues TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle, boxes 64 columns wide) into a 192 KB ring of stages behind full/empty
//     mbarriers (4 stages of three 16 KB tiles, or 6 of two), and two consumer warpgroups
//     raised to 240 registers, 64 output rows each, that run wgmma.mma_async m64n128k16 with
//     the accumulators in registers and keep one k slab's products in flight while the
//     previous stage is handed back (ptxas notes, C7515, that it serialises the products of
//     five passes across that boundary; a build that waited for every slab, without the note,
//     was no faster at the training shape);
//   - N = 128: the up passes hold two (B8: three) 64 x 128 f32 accumulators a thread, 128
//     (192) registers; N = 256 would need 256 (384). Tiles that share an operand share its
//     load: g and u read one xs tile, dWg and dWu one xs tile, dxs sums both products in one
//     accumulator;
//   - operand layouts: activations are K-major A tiles; Wg/Wu in UP and Wd in DOWN are
//     MN-major B (N runs along the weight's rows); Wd in dh and Wg/Wu in dxs K-major B; the
//     dW passes take xs^T / h^T as MN-major A (wgmma's transpose-A) and dg, du, dy as MN-major
//     B. Weights are seen as 2-D maps over all experts, [E*D, F] and [E*F, D]; the expert
//     picks the row offset, and D, F multiples of 128 keep every box inside one expert;
//   - the epilogue works from the accumulator registers (silu, its derivative and the bf16
//     rounding there), stages each bf16 output tile in the then idle ring and writes it once
//     with 16-byte stores;
//   - the tile order: a row pass's block b covers expert e = tile_group[b / panels], and
//     inside an expert's blocks the row tile runs fastest, so one expert's row tiles of one
//     weight panel run side by side and the panel comes from HBM about once a launch. Each
//     block finds its expert's first and last row tile by binary search in tile_group (it is
//     non-decreasing); a dW block sums over exactly those tiles. Every block owns the tile it
//     writes: no atomics, so the same inputs give the same bits.
// D and F must be multiples of 128 and PN of 128, so no tile is ragged.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <climits>

#include "hopper.cuh"

namespace {

using namespace hop;

constexpr int TILE = 128;                 // routing row tile, and a block tile's rows
constexpr int BN = 128;                   // a block tile's columns
constexpr int BK = 64;                    // K slab: one 128-byte swizzled box row
constexpr int NCONS = 256;                // two consumer warpgroups of 64 rows each
constexpr int NTHREADS = NCONS + 128;     // and the producer warpgroup, of which one thread works
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 x 24 + 256 x 240 <= 65536
constexpr int SLOT = TILE * BK;           // bf16 elements of one operand tile of a stage, 16 KB
constexpr int BOX = 64 * 64;              // one 64-row box of an MN-major tile [2][64][64]
constexpr int RING = 12 * SLOT;           // 192 KB: 4 stages of three tiles or 6 of two
constexpr int MAX_STAGES = 6;
constexpr int OPITCH = BN + 8;            // staged output row in bf16: 272 B, no bank conflicts
constexpr int SMEM_BYTES = RING * 2 + 2 * MAX_STAGES * 8 + 1024;  // and the base's alignment

enum Pass { UP, UP_BWD, DOWN, DX, DW_GU, DW_D };

template <int P>
struct Spec {
  static constexpr bool ROWS = P == UP || P == UP_BWD || P == DOWN || P == DX;  // row-tile blocks
  static constexpr int SLOTS = P == UP || P == UP_BWD || P == DW_GU ? 3 : 2;    // tiles a stage
  static constexpr int STAGES = RING / (SLOTS * SLOT);
  static constexpr int PHASES = P == UP_BWD || P == DX ? 2 : 1;  // K loops run one after another
  static constexpr int NACC = P == UP_BWD ? 3 : P == UP || P == DW_GU ? 2 : 1;
  static constexpr int NOUT = P == UP_BWD ? 3 : P == DW_GU ? 2 : 1;
};

// The tensor maps of a pass (see the launches for which is which).
struct Maps {
  CUtensorMap m[5];
};

// One block's work: the expert, the output tile's origin (m0 rows, n0 columns), the first
// activation row of its K loop (dW passes) and the number of K slabs of each phase.
struct Job {
  int e, m0, n0, r0, steps;
};

// the first row tile whose expert is >= e (tile_group is non-decreasing)
__device__ __forceinline__ int first_tile(const int* __restrict__ tg, int n, int e) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tg[mid] < e) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <int P>
__device__ __forceinline__ Job job(const int* __restrict__ tg, int ntiles, int D, int F) {
  Job j;
  if constexpr (Spec<P>::ROWS) {
    // blocks [panels * lo, panels * hi) belong to the expert of tiles [lo, hi): panel-major,
    // the row tile fastest
    const int panels = (P == UP || P == UP_BWD ? F : D) / BN;
    const int b = blockIdx.x;
    j.e = tg[b / panels];
    const int lo = first_tile(tg, ntiles, j.e), cnt = first_tile(tg, ntiles, j.e + 1) - lo;
    const int i = b - panels * lo;
    j.m0 = (lo + i % cnt) * TILE;
    j.n0 = (i / cnt) * BN;
    j.r0 = j.m0;
    j.steps = (P == UP || P == UP_BWD ? D : F) / BK;
  } else {
    const int mtiles = (P == DW_GU ? D : F) / TILE;
    j.e = blockIdx.y;
    const int lo = first_tile(tg, ntiles, j.e), hi = first_tile(tg, ntiles, j.e + 1);
    j.m0 = (blockIdx.x % mtiles) * TILE;
    j.n0 = (blockIdx.x / mtiles) * BN;
    j.r0 = lo * TILE;
    j.steps = (hi - lo) * (TILE / BK);
  }
  return j;
}

// A tile of a 2-D map at (column c0, row r): K-major, one box [128 rows][64]; or MN-major,
// two boxes [64 rows][64] at columns c0 and c0 + 64.
__device__ __forceinline__ void load_k(bf16* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int r) {
  tma_load(dst, map, bar, c0, r, 0);
}
__device__ __forceinline__ void load_mn(bf16* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                        int r) {
  tma_load(dst, map, bar, c0, r, 0);
  tma_load(dst + BOX, map, bar, c0 + 64, r, 0);
}

template <int P>
__device__ __forceinline__ int stage_bytes(int phase) {
  return (P == UP_BWD && phase == 1 ? 2 : Spec<P>::SLOTS) * SLOT * 2;
}

// The producer's loads of K slab k of a phase into stage st.
template <int P>
__device__ __forceinline__ void load_slab(const Maps& mp, bf16* st, uint64_t* bar, const Job& j,
                                          int phase, int k, int D, int F) {
  const int k0 = k * BK;
  if constexpr (P == UP || P == UP_BWD) {
    if (phase == 0) {
      load_k(st, &mp.m[0], bar, k0, j.m0);                     // xs rows: K-major A
      load_mn(st + SLOT, &mp.m[1], bar, j.n0, j.e * D + k0);      // Wg[e] rows k: MN-major B
      load_mn(st + 2 * SLOT, &mp.m[2], bar, j.n0, j.e * D + k0);  // Wu[e]
    } else {
      load_k(st, &mp.m[3], bar, k0, j.m0);                   // dy rows
      load_k(st + SLOT, &mp.m[4], bar, k0, j.e * F + j.n0);  // Wd[e] rows n: K-major B
    }
  } else if constexpr (P == DOWN) {
    load_k(st, &mp.m[0], bar, k0, j.m0);                  // h rows
    load_mn(st + SLOT, &mp.m[1], bar, j.n0, j.e * F + k0);  // Wd[e] rows k: MN-major B
  } else if constexpr (P == DX) {
    load_k(st, &mp.m[2 * phase], bar, k0, j.m0);                       // dg (du) rows
    load_k(st + SLOT, &mp.m[2 * phase + 1], bar, k0, j.e * D + j.n0);  // Wg[e] (Wu[e]) rows n
  } else {
    const int r = j.r0 + k0;                              // the expert's rows are K
    load_mn(st, &mp.m[0], bar, j.m0, r);         // xs (h) rows k, columns m: MN-major A
    load_mn(st + SLOT, &mp.m[1], bar, j.n0, r);  // dg (dy) rows k, columns n: MN-major B
    if constexpr (P == DW_GU) load_mn(st + 2 * SLOT, &mp.m[2], bar, j.n0, r);  // du
  }
}

// descriptors of one k step (16) of the slab: K-major (32 bytes into the swizzled row) or
// MN-major (16 rows of an [2][64][64] tile, the halves 8 KB apart)
__device__ __forceinline__ uint64_t kdesc(const bf16* t, int kk) { return sw128(t + kk * 16, 16); }
__device__ __forceinline__ uint64_t mdesc(const bf16* t, int kk) {
  return sw128(t + kk * 16 * 64, BOX * 2);
}

// The consumer warpgroup wg's products of one K slab in stage st.
template <int P, int NA>
__device__ __forceinline__ void mma_slab(float (&acc)[NA][64], const bf16* st, int phase, int wg) {
  const bf16* a = st + wg * BOX;  // K-major A: the warpgroup's 64 rows; MN-major A: its 64 columns
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (P == UP || P == UP_BWD) {
      if (phase == 0) {
        wgmma_ss<1>(acc[0], kdesc(a, kk), mdesc(st + SLOT, kk), 1);
        wgmma_ss<1>(acc[1], kdesc(a, kk), mdesc(st + 2 * SLOT, kk), 1);
      } else {
        wgmma_ss<0>(acc[NA - 1], kdesc(a, kk), kdesc(st + SLOT, kk), 1);
      }
    } else if constexpr (P == DOWN) {
      wgmma_ss<1>(acc[0], kdesc(a, kk), mdesc(st + SLOT, kk), 1);
    } else if constexpr (P == DX) {
      wgmma_ss<0>(acc[0], kdesc(a, kk), kdesc(st + SLOT, kk), 1);
    } else {
      wgmma_ss<1, 1>(acc[0], mdesc(a, kk), mdesc(st + SLOT, kk), 1);
      if constexpr (P == DW_GU) wgmma_ss<1, 1>(acc[1], mdesc(a, kk), mdesc(st + 2 * SLOT, kk), 1);
    }
  }
}

__device__ __forceinline__ float sigmoid(float g) { return 1.f / (1.f + expf(-g)); }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int P>
__global__ void __launch_bounds__(NTHREADS, 1)
moe_gemm_kernel(const __grid_constant__ Maps mp, const int* __restrict__ tg, int ntiles, int D,
                int F, bf16* __restrict__ o0, bf16* __restrict__ o1, bf16* __restrict__ o2) {
  using S = Spec<P>;
  unsigned char* smem = smem_base();
  bf16* ring = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING * 2);
  uint64_t* empty = full + MAX_STAGES;
  const Job j = job<P>(tg, ntiles, D, F);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      bar_init(&full[s], 1);              // the producer's arrive, and the TMA bytes
      bar_init(&empty[s], NCONS / 32);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {  // the producer warpgroup: one thread loads, the rest leave
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != NCONS) return;
    int st = 0, ph = 0;
    for (int i = 0; i < S::PHASES * j.steps; ++i) {
      const int phase = i >= j.steps, k = i - phase * j.steps;
      bar_wait(&empty[st], ph ^ 1);
      bar_arrive_tx(&full[st], stage_bytes<P>(phase));
      load_slab<P>(mp, ring + st * S::SLOTS * SLOT, &full[st], j, phase, k, D, F);
      if (++st == S::STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7;
  float acc[S::NACC][64];
#pragma unroll
  for (int a = 0; a < S::NACC; ++a)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[a][i] = 0.f;
  int st = 0, ph = 0, prev = -1;
  for (int i = 0; i < S::PHASES * j.steps; ++i) {
    bar_wait(&full[st], ph);
    wg_fence();
    mma_slab<P>(acc, ring + st * S::SLOTS * SLOT, i >= j.steps, wg);
    wg_commit();
    wg_wait<1>();  // the previous slab's products are done: hand its stage back
    if (prev >= 0) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) bar_arrive(&empty[prev]);
    }
    prev = st;
    if (++st == S::STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int a = 0; a < S::NACC; ++a) pin(acc[a]);

  // Epilogue: each bf16 output tile staged in the ring (every load has landed and both
  // warpgroups' products are done), then written once with 16-byte stores.
  consumers_sync();
  const int t = threadIdx.x;
  const int row = (wg << 6) + (((t >> 5) & 3) << 4) + ((t & 31) >> 2), col = 2 * (t & 3);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 4 * jj + 2 * hh;
      float v[S::NOUT][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if constexpr (P == UP || P == UP_BWD) {
          const float g = acc[0][i + q], u = acc[1][i + q], s = sigmoid(g), sg = g * s;
          v[0][q] = sg * u;  // h
          if constexpr (P == UP_BWD) {
            const float dh = acc[2][i + q];
            v[1][q] = dh * u * (s * (1.f + g * (1.f - s)));  // dg
            v[2][q] = dh * sg;                               // du
          }
        } else {
#pragma unroll
          for (int o = 0; o < S::NOUT; ++o) v[o][q] = acc[o][i + q];
        }
      }
#pragma unroll
      for (int o = 0; o < S::NOUT; ++o)
        *reinterpret_cast<__nv_bfloat162*>(ring + (o * TILE + row + 8 * hh) * OPITCH + 8 * jj +
                                           col) = __floats2bfloat162_rn(v[o][0], v[o][1]);
    }
  consumers_sync();
  const int ld = P == UP || P == UP_BWD || P == DW_GU ? F : D;
  const size_t base = (S::ROWS ? 0 : (size_t)j.e * D * F) + (size_t)j.m0 * ld + j.n0;
  bf16* outs[3] = {o0, o1, o2};
#pragma unroll
  for (int o = 0; o < S::NOUT; ++o)
#pragma unroll
    for (int c = t; c < TILE * BN / 8; c += NCONS) {
      const int r = c / (BN / 8), x = c % (BN / 8) * 8;
      *reinterpret_cast<uint4*>(outs[o] + base + (size_t)r * ld + x) =
          *reinterpret_cast<const uint4*>(ring + (o * TILE + r) * OPITCH + x);
    }
}

// a row-major bf16 matrix [rows, cols] seen by TMA in boxes of box_rows x 64
bool map2d(CUtensorMap* m, const void* base, int rows, int cols, int box_rows) {
  return tensor_map(m, base, cols, rows, 1, rows, box_rows);
}

template <int P>
cudaError_t launch(const Maps& mp, dim3 grid, const int* tg, int ntiles, int D, int F, void* o0,
                   void* o1, void* o2, cudaStream_t st) {
  auto kern = moe_gemm_kernel<P>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  kern<<<grid, NTHREADS, SMEM_BYTES, st>>>(mp, tg, ntiles, D, F, (bf16*)o0, (bf16*)o1, (bf16*)o2);
  return cudaGetLastError();
}

bool shapes_ok(int PN, int D, int F, int E) {
  return PN > 0 && PN % TILE == 0 && D > 0 && D % BN == 0 && F > 0 && F % BN == 0 && E > 0 &&
         (long long)E * D <= INT_MAX && (long long)E * F <= INT_MAX;
}

}  // namespace

// xs [PN, D], wg/wu [E, D, F], wd [E, F, D], tile_group [PN/128] int32, h [PN, F] scratch,
// ys [PN, D]; all bf16 but tile_group. Returns cudaGetLastError() after the launches.
extern "C" int tt_moe_fwd(const void* xs, const void* wg, const void* wu, const void* wd,
                          const int* tile_group, void* h, void* ys, int PN, int D, int F, int E,
                          void* stream) {
  if (!shapes_ok(PN, D, F, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = PN / TILE;
  Maps up{}, down{};
  const bool ok = map2d(&up.m[0], xs, PN, D, TILE) && map2d(&up.m[1], wg, E * D, F, 64) &&
                  map2d(&up.m[2], wu, E * D, F, 64) && map2d(&down.m[0], h, PN, F, TILE) &&
                  map2d(&down.m[1], wd, E * F, D, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      launch<UP>(up, dim3(nt * (F / BN)), tile_group, nt, D, F, h, nullptr, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<DOWN>(down, dim3(nt * (D / BN)), tile_group, nt, D, F, ys, nullptr, nullptr,
                           st);
}

// dy [PN, D]; h, dg, du [PN, F] scratch; dxs [PN, D]; dwg, dwu [E, D, F], dwd [E, F, D].
extern "C" int tt_moe_bwd(const void* xs, const void* dy, const void* wg, const void* wu,
                          const void* wd, const int* tile_group, void* h, void* dg, void* du,
                          void* dxs, void* dwg, void* dwu, void* dwd, int PN, int D, int F, int E,
                          void* stream) {
  if (!shapes_ok(PN, D, F, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = PN / TILE;
  Maps up{}, dx{}, dwgu{}, dwd_{};
  const bool ok =
      map2d(&up.m[0], xs, PN, D, TILE) && map2d(&up.m[1], wg, E * D, F, 64) &&
      map2d(&up.m[2], wu, E * D, F, 64) && map2d(&up.m[3], dy, PN, D, TILE) &&
      map2d(&up.m[4], wd, E * F, D, TILE) &&
      map2d(&dx.m[0], dg, PN, F, TILE) && map2d(&dx.m[1], wg, E * D, F, TILE) &&
      map2d(&dx.m[2], du, PN, F, TILE) && map2d(&dx.m[3], wu, E * D, F, TILE) &&
      map2d(&dwgu.m[0], xs, PN, D, 64) && map2d(&dwgu.m[1], dg, PN, F, 64) &&
      map2d(&dwgu.m[2], du, PN, F, 64) &&
      map2d(&dwd_.m[0], h, PN, F, 64) && map2d(&dwd_.m[1], dy, PN, D, 64);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch<UP_BWD>(up, dim3(nt * (F / BN)), tile_group, nt, D, F, h, dg, du, st);
  if (err != cudaSuccess) return (int)err;
  err = launch<DX>(dx, dim3(nt * (D / BN)), tile_group, nt, D, F, dxs, nullptr, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  // dW: the D (F) tile fastest, then the F (D) tile, then the expert
  err = launch<DW_GU>(dwgu, dim3((D / TILE) * (F / BN), E), tile_group, nt, D, F, dwg, dwu,
                      nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<DW_D>(dwd_, dim3((F / TILE) * (D / BN), E), tile_group, nt, D, F, dwd, nullptr,
                           nullptr, st);
}

// the dynamic shared memory a block of each pass asks for (the build report prints it)
extern "C" int tt_moe_smem_bytes() { return SMEM_BYTES; }
