// Weight-only int8 matmul: out[M, N] = bf16((x[M, K] @ q[K, N]) * scale[N]).
//
// Replaces the Pallas TPU kernel tony_tpu/ops/quant.py:54 `_quant_matmul_kernel`
// (launched by `int8_matmul`, quant.py:132). Takes bfloat16 x only: the TPU kernel casts x
// to bf16 before its dot (quant.py:66), int8 -> bf16 is exact, and bf16 is the serving
// dtype; the wrapper raises on any other x dtype. q keeps the JAX package's [K, N] row-major
// layout; accumulation is f32 and the per-N-channel scale lands in the epilogue. Every M from
// 1 up is taken, K and N are multiples of 16, and ragged M, N and K edges are zero-filled by
// the TMA loads and masked on the way out. One launch a call, no float atomics: the same
// inputs give the same bits.
//
// Two paths, chosen by M on the host (`tt_int8_matmul`):
//
// Decode, M <= DECODE_MAX_M (64). Bound: bytes. Each weight byte feeds 2*M operations, far
// below the card's ~295 a byte, so the kernel has to stream q at the memory's rate:
//   - a producer warp keeps a ring of DSTAGES (6) stages in flight behind full/empty
//     mbarriers, each stage one TMA box of q (128 k rows x 128 n, 16 KB, 128-byte swizzle) and
//     two of x (64 k x 8*MT rows, bf16); two blocks an SM at MT 1, ~200 KB in flight an SM;
//   - operands swapped so that no tensor-core row is wasted: out^T = q^T . x^T with mma.sync
//     m16n8k16, 16 weight columns n as the product's rows and 8 tokens as its columns, so
//     M = 8 fills a fragment with no padding (MT = ceil(M / 8) column tiles, 1, 2, 4 or 8);
//   - q^T's A fragment is built in registers: a thread reads 8 bytes (8 n) of each of its four
//     k rows 2t, 2t+1, 2t+8, 2t+9 (8-byte shared loads, conflict-free under the swizzle) and
//     converts two bytes at a time with a magic number in bf16 (`bf2`: one prmt, two lop3 and
//     one bf16x2 fma, exact for every int8), 2 instructions a weight, each converted once
//     however many tokens use it (the f32 form of the trick, prmt each byte into 2^23,
//     subtract 2^23 + 128, pack the pair, costs 2.75: the same time on this path, 5% more
//     on the prefill path at M 1024, measured with the probe below);
//   - eight consumer warps: two cover the tile's 128 n, four pairs take alternate 16-row k
//     steps of each stage; the pairs' partial sums meet in shared memory in a fixed order;
//   - K split across blocks where the n tiles cannot fill the card (N = 1024 gives 8 tiles):
//     splits leave f32 partials in a workspace, and the last block of an n tile to take its
//     ticket sums them in split order, scales and writes bf16, then resets the ticket (the
//     tickets are zeroed once by the caller, outside any CUDA-graph capture; nothing is read
//     on the host, so the call replays in a graph).
//
// Prefill, M > DECODE_MAX_M. Bound: operations (2*M per weight byte; M = 1024 is past the
// ridge), so the tensor cores have to be kept busy:
//   - 384 threads: a producer warpgroup lowered to 24 registers, of which one thread keeps
//     TMA loads of x (bf16, K-major, BM tokens x 64 k, 128-byte swizzle) and q (int8, 64 k x
//     128 n) in flight over a PSTAGES-deep ring; two consumer warpgroups raised to 240
//     registers, 64 weight columns each;
//   - operands swapped here too: out^T = q^T . x^T with wgmma m64n128k16, A = q^T from
//     registers, B = x^T straight from the TMA tile (K-major), f32 accumulators in
//     registers (BM = 128 TH tokens, TH 64 x 128 tiles a warpgroup; TH 2 above M 128). Each
//     consumer thread converts its A fragments from the stage's int8 tile (2-byte shared
//     loads, `bf2`): no converted tile is written to shared memory, no proxy fence or barrier
//     stands between the conversion and the products, and each weight is converted once
//     for the block's BM tokens. Two register sets of fragments let slab i+1 be converted
//     while slab i's products run;
//   - why the weight is A and not B: converted into a bf16 tile in shared memory for wgmma's
//     B, it bound the path (0.243 ms at M 1024 x 4096 x 14336, 0.17 without the conversion;
//     measured on the H100): both operands then stream from shared memory, and each slab
//     waits on a written, fenced tile;
//   - the scale in the epilogue; the bf16 tile staged in the idle ring and written with
//     16-byte stores. Blocks run the token tile fastest, so the tiles in flight share q panels;
//   - K split where the output tiles leave SMs idle (a short prompt, or N = 1024), with the
//     decode path's workspace and ticket merge: one block's k slabs run one after another, so
//     a 32-block call would leave the card latency-bound.
//
// Crossover: DECODE_MAX_M is the largest M the decode path takes, and the decode path's
// register tiles end there (MT 8). Measured on the H100 at K 4096 x N 14336 (`chip_smoke.py`'s
// crossover lines), the decode path is the faster of the two at every M up to 64: 0.037
// against 0.053 ms at M 16, 0.041 against 0.045 at M 64. Where B6's time goes:
// `python -m tony_tpu_torch.ops.int8_matmul_probe` builds variants of this source and times
// them.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hop;

constexpr int DECODE_MAX_M = 64;

// -- shared pieces --------------------------------------------------------------------

// an int8 [rows, cols] row-major matrix seen by TMA in boxes of box_rows x 128 bytes with the
// 128-byte swizzle (a 3-D map of one plane, as hop::tma_load takes); rows and columns past
// the matrix load as zeros
bool map_i8(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)cols, (cuuint64_t)cols * rows};
  const cuuint32_t box[3] = {128, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Two int8 weights as bf16x2, exactly, in four instructions. `sel` (a prmt selector) puts the
// two bytes, b, at bytes 0 and 2 of p. With l = b & 0x7f and s its sign bit, b = l - 128 s, so
// each lane is (128 + l) + (-128 - 128 s): bf16 0x4300 | l plus bf16 0xc300 | (b & 0x80), one
// exact bf16x2 add (an fma by 1; every value is a small integer).
__device__ __forceinline__ uint32_t bf2(uint32_t a, uint32_t b, uint32_t sel) {
  const uint32_t p = prmt(a, b, sel);
  const uint32_t hi = (p & 0x007F007Fu) | 0x43004300u, lo = (p & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(hi), "r"(0x3F803F80u), "r"(lo));
  return d;
}

// byte E of a (low lane) and byte E of b (high lane), as bf16x2
template <int E>
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b) {
  return bf2(a, b, E | (E << 4) | ((4 + E) << 8) | ((4 + E) << 12));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

constexpr int MAX_SPLITS = 8;  // K splits a call takes at most

// The K-split merge of an output tile (rows m0 .. m1 - 1 of 128 columns from n0), by the 256
// consumer threads of each of its splits once their f32 partial is in the workspace: the last
// split to take the tile's ticket sums the partials in split order, scales, writes bf16 and
// resets the ticket. No float atomics: the same inputs give the same bits.
__device__ __forceinline__ void merge_splits(const float* __restrict__ ws,
                                             const float* __restrict__ scale,
                                             bf16* __restrict__ out, int* ticket, int* last, int M,
                                             int N, int m0, int m1, int n0, int splits, int tid) {
  __threadfence();
  consumers_sync();
  if (tid == 0) *last = atomicAdd(ticket, 1) == splits - 1;
  consumers_sync();
  if (!*last) return;
  __threadfence();
  for (int idx = tid; idx < (m1 - m0) * 64; idx += 256) {
    const int m = m0 + idx / 64, n = n0 + 2 * (idx % 64);
    if (n >= N) continue;
    // every split's load in flight at once, then summed in split order
    float2 o[MAX_SPLITS];
#pragma unroll
    for (int z = 0; z < MAX_SPLITS; ++z)
      if (z < splits)
        o[z] = __ldcg(reinterpret_cast<const float2*>(ws + ((size_t)z * M + m) * N + n));
    float2 v = o[0];
#pragma unroll
    for (int z = 1; z < MAX_SPLITS; ++z)
      if (z < splits) {
        v.x += o[z].x;
        v.y += o[z].y;
      }
    const float2 sc = *reinterpret_cast<const float2*>(scale + n);
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
        __floats2bfloat162_rn(v.x * sc.x, v.y * sc.y);
  }
  if (tid == 0) *ticket = 0;  // ready for the next call
}

// -- decode path ----------------------------------------------------------------------

constexpr int DN = 128;                     // a block's n tile: one 128-byte int8 box row
constexpr int DBK = 128;                    // k rows a stage (a multiple of 64)
constexpr int DSTAGES = 6;
constexpr int DWARPS = 8;                   // consumer warps: 4 k pairs x 2 halves of 64 n
constexpr int DTHREADS = DWARPS * 32 + 32;  // and the producer warp

template <int MT>
struct Dec {
  static constexpr int MB = 8 * MT;               // x rows a stage (zero past M)
  static constexpr int QBYTES = DBK * DN;         // 16 KB
  static constexpr int XBOX = MB * 128;           // one box of 64 k
  static constexpr int STAGE = QBYTES + DBK / 64 * XBOX;  // a multiple of 1024: boxes swizzle alike
  static constexpr int RPITCH = DN + 4;           // f32 row of the pairs' reduction tile
  static constexpr int RING = DSTAGES * STAGE;
  static constexpr int SMEM = RING + 2 * DSTAGES * 8 + 16 + 1024;
  static_assert(MB * RPITCH * 4 <= RING, "the reduction tile reuses the ring");
};

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of product i (rows n 2i and 2i + 1 of the thread's 8) from its 8 bytes of rows
// k 2t (w0), 2t+1 (w1), 2t+8 (w2), 2t+9 (w3)
template <int I>
__device__ __forceinline__ void frag(uint32_t (&a)[4], const uint2 (&w)[4]) {
  constexpr int E = (2 * I) & 3;
  const uint32_t w0 = I < 2 ? w[0].x : w[0].y, w1 = I < 2 ? w[1].x : w[1].y;
  const uint32_t w2 = I < 2 ? w[2].x : w[2].y, w3 = I < 2 ? w[3].x : w[3].y;
  a[0] = pair<E>(w0, w1);
  a[1] = pair<E + 1>(w0, w1);
  a[2] = pair<E>(w2, w3);
  a[3] = pair<E + 1>(w2, w3);
}

template <int MT>
__global__ void __launch_bounds__(DTHREADS)
i8_decode_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tx,
                 const float* __restrict__ scale, bf16* __restrict__ out, float* __restrict__ ws,
                 int* __restrict__ tickets, int M, int N, int K, int tps) {
  using G = Dec<MT>;
  unsigned char* smem = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::RING);
  uint64_t* empty = full + DSTAGES;
  int* last = reinterpret_cast<int*>(empty + DSTAGES);
  const int n0 = blockIdx.x * DN, split = blockIdx.y, splits = gridDim.y;
  const int kt0 = split * tps, kt1 = min(kt0 + tps, (K + DBK - 1) / DBK);
  const int steps = kt1 - kt0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DSTAGES; ++s) {
      bar_init(&full[s], 1);       // the producer's arrive, and the TMA bytes
      bar_init(&empty[s], DWARPS);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == DWARPS) {  // the producer warp: one thread loads
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      for (int i = 0; i < steps; ++i) {
        const int s = i % DSTAGES;
        bar_wait(&empty[s], ((i / DSTAGES) & 1) ^ 1);
        unsigned char* st = smem + s * G::STAGE;
        const int k0 = (kt0 + i) * DBK;
        bar_arrive_tx(&full[s], G::STAGE);
        tma_load(st, &tq, &full[s], n0, k0, 0);
#pragma unroll
        for (int b = 0; b < DBK / 64; ++b)
          tma_load(st + G::QBYTES + b * G::XBOX, &tx, &full[s], k0 + 64 * b, 0, 0);
      }
    }
    return;
  }

  const int kp = warp >> 1, half = warp & 1;  // k pair, and which 64 n of the tile
  const int r = lane >> 2, t = lane & 3;
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int s = i % DSTAGES;
    bar_wait(&full[s], (i / DSTAGES) & 1);
    const unsigned char* qs = smem + s * G::STAGE;
    const unsigned char* xs = qs + G::QBYTES;
#pragma unroll
    for (int j = 0; j < DBK / 64; ++j) {
      const int kb = 16 * (kp + 4 * j);  // this k step's first row in the stage
      // the thread's 8 bytes (n = 64 half + 8 r ..) of rows kb + 2t + {0, 1, 8, 9}; the
      // swizzle puts 16-byte chunk c of row k at c ^ (k % 8)
      uint2 w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = kb + 2 * t + (e & 1) + 8 * (e >> 1);
        const int chunk = (4 * half + (r >> 1)) ^ (row & 7);
        w[e] = *reinterpret_cast<const uint2*>(qs + row * 128 + chunk * 16 + 8 * (r & 1));
      }
      uint32_t a[4][4];
      frag<0>(a[0], w);
      frag<1>(a[1], w);
      frag<2>(a[2], w);
      frag<3>(a[3], w);
      // B = x^T: rows k kb + 2t (+1) and + 8, column m = 8 mt + r
      const unsigned char* xb = xs + (kb >> 6) * G::XBOX;
      const int ck = (kb & 63) >> 3;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* xr = xb + (8 * mt + r) * 128 + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr + ((ck ^ r) << 4));
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + (((ck + 1) ^ r) << 4));
#pragma unroll
        for (int p = 0; p < 4; ++p) mma16816(acc[mt][p], a[p], b0, b1);
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }

  // The four k pairs' sums meet in a [MB][DN] f32 tile in the ring, pair 0 first (every
  // stage has been consumed, and no load is in flight).
  float* red = reinterpret_cast<float*>(smem);
  consumers_sync();
  for (int p = 0; p < 4; ++p) {
    if (kp == p) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // column m = 8 mt + 2t + h, rows n 2i and 2i + 1
            float2* dst = reinterpret_cast<float2*>(red + (8 * mt + 2 * t + h) * G::RPITCH +
                                                    64 * half + 8 * r + 2 * i);
            float2 v = make_float2(acc[mt][i][h], acc[mt][i][h + 2]);
            if (p > 0) {
              const float2 o = *dst;
              v.x = o.x + v.x;
              v.y = o.y + v.y;
            }
            *dst = v;
          }
    }
    consumers_sync();
  }
  const int tid = threadIdx.x;
  const int mrows = min(M, G::MB);
  if (splits == 1) {
    for (int idx = tid; idx < mrows * DN / 2; idx += DWARPS * 32) {
      const int m = idx / (DN / 2), c = 2 * (idx % (DN / 2)), n = n0 + c;
      if (n >= N) continue;
      const float2 v = *reinterpret_cast<const float2*>(red + m * G::RPITCH + c);
      const float2 sc = *reinterpret_cast<const float2*>(scale + n);
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
          __floats2bfloat162_rn(v.x * sc.x, v.y * sc.y);
    }
    return;
  }
  for (int idx = tid; idx < mrows * DN / 2; idx += DWARPS * 32) {
    const int m = idx / (DN / 2), c = 2 * (idx % (DN / 2)), n = n0 + c;
    if (n >= N) continue;
    __stcg(reinterpret_cast<float2*>(ws + ((size_t)split * M + m) * N + n),
           *reinterpret_cast<const float2*>(red + m * G::RPITCH + c));
  }
  merge_splits(ws, scale, out, &tickets[blockIdx.x], last, M, N, 0, mrows, n0, splits, tid);
}

// -- prefill path ---------------------------------------------------------------------

constexpr int PBN = 128, PBK = 64;
constexpr int PSTAGES = 4;
constexpr int PNCONS = 256;                     // two consumer warpgroups, 64 weight columns each
constexpr int PTHREADS = PNCONS + 128;          // and the producer warpgroup
// setmaxnreg moves registers between a block's own warps: the totals must fit the 168 a
// thread that a 384-thread block is launched with (an inc that does not fit waits forever)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + PNCONS * CONSUMER_REGS <= 168 * PTHREADS, "register budget");
constexpr int QTILE = PBK * PBN;                // 8 KB: q [64 k][128 n] int8, one box
constexpr int OPITCH = PBN + 8;                 // staged output row in bf16
constexpr int PREFILL_WIDE_M = 128;             // above this M, 256-token tiles (TH 2)
constexpr int PREFILL_MIN_SLABS = 8;            // k slabs a K split takes at least

// TH 128-token halves a block tile: BM = 128 TH rows of x (tokens)
template <int TH>
struct Pre {
  static constexpr int BM = 128 * TH;
  static constexpr int XTILE = BM * PBK * 2;    // x [BM rows][64 k], one box
  static constexpr int STAGE = XTILE + QTILE;
  static constexpr int RING = PSTAGES * STAGE;
  static constexpr int SMEM = RING + 2 * PSTAGES * 8 + 16 + 1024;
  static_assert(BM * OPITCH * 2 <= RING, "the output tile is staged in the ring");
};

// The warpgroup's A fragments of one k slab, q^T [64 n][64 k] as four k16 steps, from the
// stage's int8 tile (swizzled [64 k][128 n]). Thread (warp w, lane 4r + c) holds rows 16w + r
// and 16w + r + 8 of each step, which stand for weight columns 16w + 2r and 16w + 2r + 1 of
// the warpgroup's 64 (so one 2-byte load of a k row serves both), at k 2c, 2c+1, 2c+8, 2c+9.
__device__ __forceinline__ void convert_slab(uint32_t (&f)[4][4], const unsigned char* src,
                                             int chunk, int r, int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * kk + 2 * c + (e & 1) + 8 * (e >> 1);
      l[e] = *reinterpret_cast<const unsigned short*>(src + k * 128 + ((chunk ^ (k & 7)) << 4) +
                                                      2 * r);
    }
    f[kk][0] = pair<0>(l[0], l[1]);
    f[kk][1] = pair<1>(l[0], l[1]);
    f[kk][2] = pair<0>(l[2], l[3]);
    f[kk][3] = pair<1>(l[2], l[3]);
  }
}

template <int TH>
__device__ __forceinline__ void mma_slab(float (&acc)[TH][64], uint32_t (&f)[4][4],
                                         const bf16* xt, int i) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < TH; ++h)
      wgmma_rs<0>(acc[h], f[kk], sw128(xt + h * 128 * 64 + kk * 16, 16), (i | kk) != 0);
  wg_commit();
}

template <int TH>
__global__ void __launch_bounds__(PTHREADS, 1)
i8_prefill_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                  const float* __restrict__ scale, bf16* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ tickets, int M, int N, int K, int tps) {
  using G = Pre<TH>;
  unsigned char* smem = smem_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::RING);
  uint64_t* empty = full + PSTAGES;
  int* last = reinterpret_cast<int*>(empty + PSTAGES);
  const int mtiles = (M + G::BM - 1) / G::BM;
  const int m0 = (blockIdx.x % mtiles) * G::BM, n0 = (blockIdx.x / mtiles) * PBN;
  const int split = blockIdx.y, splits = gridDim.y;  // K split over blockIdx.y
  const int kt0 = split * tps, steps = min(tps, (K + PBK - 1) / PBK - kt0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      bar_init(&full[s], 1);                // the producer's arrive, and the TMA bytes
      bar_init(&empty[s], PNCONS / 32);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= PNCONS) {  // the producer warpgroup: one thread loads, the rest leave
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != PNCONS) return;
    for (int i = 0; i < steps; ++i) {
      const int st = i % PSTAGES;
      bar_wait(&empty[st], ((i / PSTAGES) & 1) ^ 1);
      unsigned char* s = smem + st * G::STAGE;
      bar_arrive_tx(&full[st], G::STAGE);
      tma_load(s, &tx, &full[st], (kt0 + i) * PBK, m0, 0);
      tma_load(s + G::XTILE, &tq, &full[st], n0, (kt0 + i) * PBK, 0);
    }
    return;
  }

  regs_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, tid = threadIdx.x, w = (tid >> 5) & 3, lane = tid & 31;
  const int r = lane >> 2, c = lane & 3, chunk = 4 * wg + w;
  // TH 64 x 128 accumulators (weight columns x tokens), set by the first product (scale-d
  // 0), not zeroed: an instruction that defines the accumulators between products makes
  // ptxas serialise them (C7515)
  float acc[TH][64];
  // the A fragments of even and odd slabs: a slab's products read its registers until they
  // finish, so slab i + 1 is converted into the other set while they run, and `pin` keeps the
  // compiler from reusing a set before the wait that retires its products
  uint32_t fa[4][4], fb[4][4];
  auto stage = [&](int i) { return smem + (i % PSTAGES) * G::STAGE; };
  auto ready = [&](int i) { bar_wait(&full[i % PSTAGES], (i / PSTAGES) & 1); };
  auto release = [&](int i) {  // slab i's products are done: hand its stage back
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[i % PSTAGES]);
  };
  ready(0);
  convert_slab(fa, stage(0) + G::XTILE, chunk, r, c);
  for (int i = 0; i < steps; i += 2) {
    mma_slab<TH>(acc, fa, reinterpret_cast<const bf16*>(stage(i)), i);
    wg_wait<1>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(fb[kk]);
    if (i > 0) release(i - 1);
    if (i + 1 >= steps) break;
    ready(i + 1);
    convert_slab(fb, stage(i + 1) + G::XTILE, chunk, r, c);
    mma_slab<TH>(acc, fb, reinterpret_cast<const bf16*>(stage(i + 1)), i + 1);
    wg_wait<1>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(fa[kk]);
    release(i);
    if (i + 2 >= steps) break;
    ready(i + 2);
    convert_slab(fa, stage(i + 2) + G::XTILE, chunk, r, c);
  }
  wg_wait<0>();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pin(fa[kk]);
    pin(fb[kk]);
  }
#pragma unroll
  for (int h = 0; h < TH; ++h) pin(acc[h]);
  // d[4j + q] of half h: weight column nl + (q >> 1), token tl + 128 h + 8 j + (q & 1)
  const int nl = 64 * wg + 16 * w + 2 * r, tl = 2 * c;
  const float2 sc =
      n0 + nl < N ? *reinterpret_cast<const float2*>(scale + n0 + nl) : make_float2(0.f, 0.f);

  if (splits > 1) {
    // K split: the f32 partial straight from the accumulators to the workspace
    const int n = n0 + nl;
#pragma unroll
    for (int h = 0; h < TH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + tl + 128 * h + 8 * j + e;
          if (m < M && n < N)
            __stcg(reinterpret_cast<float2*>(ws + ((size_t)split * M + m) * N + n),
                   make_float2(acc[h][4 * j + e], acc[h][4 * j + 2 + e]));
        }
    merge_splits(ws, scale, out, &tickets[blockIdx.x], last, M, N, m0, min(M, m0 + G::BM), n0,
                 splits, tid);
    return;
  }

  // Epilogue: scale, round to bf16, stage the tile [tokens][weight columns] in the ring (every
  // load has landed and both warpgroups' products are done), write rows < M and columns < N
  // with 16-byte stores.
  consumers_sync();
  bf16* o = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int h = 0; h < TH; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<__nv_bfloat162*>(o + (tl + 128 * h + 8 * j + e) * OPITCH + nl) =
            __floats2bfloat162_rn(acc[h][4 * j + e] * sc.x, acc[h][4 * j + 2 + e] * sc.y);
  consumers_sync();
  for (int q = tid; q < G::BM * PBN / 8; q += PNCONS) {
    const int row = q / (PBN / 8), x = q % (PBN / 8) * 8;
    if (m0 + row < M && n0 + x < N)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + row) * N + n0 + x) =
          *reinterpret_cast<const uint4*>(o + row * OPITCH + x);
  }
}

// -- launches -------------------------------------------------------------------------

int decode_mt(int M) { return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8; }

template <int MT>
int decode_blocks_per_sm() {
  static int occ = 0;
  if (occ == 0) {
    int n = 0;
    cudaFuncSetAttribute(i8_decode_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Dec<MT>::SMEM);
    occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, i8_decode_kernel<MT>, DTHREADS,
                                                        Dec<MT>::SMEM) == cudaSuccess && n > 0
              ? n
              : 1;
  }
  return occ;
}

// K splits of the decode path: as many as keep every block of the call resident at once (one
// wave: a second wave would stream its bytes after the first), at most MAX_SPLITS, each split
// at least one stage
int decode_splits(int M, int N, int K, int num_sms) {
  const int mt = decode_mt(M);
  const int occ = mt == 1   ? decode_blocks_per_sm<1>()
                  : mt == 2 ? decode_blocks_per_sm<2>()
                  : mt == 4 ? decode_blocks_per_sm<4>()
                            : decode_blocks_per_sm<8>();
  const int tiles = (N + DN - 1) / DN, kt = (K + DBK - 1) / DBK;
  int splits = occ * num_sms / tiles;
  splits = splits < 1 ? 1 : (splits > kt ? kt : splits);
  splits = splits > MAX_SPLITS ? MAX_SPLITS : splits;
  const int tps = (kt + splits - 1) / splits;
  return (kt + tps - 1) / tps;
}

template <int MT>
cudaError_t launch_decode(const void* x, const void* q, const float* scale, bf16* out, float* ws,
                          int* tickets, int M, int N, int K, int splits, cudaStream_t st) {
  using G = Dec<MT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      i8_decode_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tx;
  if (!map_i8(&tq, q, K, N, DBK) || !tensor_map(&tx, x, K, M, 1, M, G::MB))
    return cudaErrorInvalidValue;
  const int kt = (K + DBK - 1) / DBK, tps = (kt + splits - 1) / splits;
  const dim3 grid((N + DN - 1) / DN, splits);
  i8_decode_kernel<MT><<<grid, DTHREADS, G::SMEM, st>>>(tq, tx, scale, out, ws, tickets, M, N, K,
                                                         tps);
  return cudaGetLastError();
}

// K splits of the prefill path: where its tiles leave SMs idle, enough splits for a block an
// SM, at most MAX_SPLITS, each split at least PREFILL_MIN_SLABS slabs
int prefill_splits(int M, int N, int K, int num_sms) {
  const int bm = M > PREFILL_WIDE_M ? 256 : 128;  // Pre<TH>::BM
  const int tiles = ((M + bm - 1) / bm) * ((N + PBN - 1) / PBN), kt = (K + PBK - 1) / PBK;
  int splits = num_sms / tiles;
  const int most = kt / PREFILL_MIN_SLABS < MAX_SPLITS ? kt / PREFILL_MIN_SLABS : MAX_SPLITS;
  splits = splits > most ? most : splits;
  if (splits < 2) return 1;
  const int tps = (kt + splits - 1) / splits;
  return (kt + tps - 1) / tps;
}

template <int TH>
cudaError_t launch_prefill(const void* x, const void* q, const float* scale, bf16* out, float* ws,
                           int* tickets, int M, int N, int K, int splits, cudaStream_t st) {
  using G = Pre<TH>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      i8_prefill_kernel<TH>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tx, tq;
  if (!tensor_map(&tx, x, K, M, 1, M, G::BM) || !map_i8(&tq, q, K, N, PBK))
    return cudaErrorInvalidValue;
  const int kt = (K + PBK - 1) / PBK, tps = (kt + splits - 1) / splits;
  const dim3 grid(((M + G::BM - 1) / G::BM) * ((N + PBN - 1) / PBN), splits);
  i8_prefill_kernel<TH><<<grid, PTHREADS, G::SMEM, st>>>(tx, tq, scale, out, ws, tickets, M, N, K,
                                                        tps);
  return cudaGetLastError();
}

}  // namespace

// The K splits of a call, which size the f32 workspace [splits, M, N] and decide whether it
// takes tickets (one int an output tile, zero between calls): 1 means neither. path -1
// chooses by M.
extern "C" int tt_int8_matmul_splits(int M, int N, int K, int num_sms, int path) {
  if (path < 0) path = M <= DECODE_MAX_M ? 0 : 1;
  return path == 0 ? decode_splits(M, N, K, num_sms) : prefill_splits(M, N, K, num_sms);
}

// x [M, K] bf16, q [K, N] int8, scale [N] f32, out [M, N] bf16; ws the f32 workspace
// [splits, M, N] and tickets [ceil(M / 128) * ceil(N / 128)] int32 zeros (both NULL when
// splits == 1); splits as tt_int8_matmul_splits plans them. path -1 chooses by M (0 forces
// the decode path, which takes M <= 64; 1 the prefill path). One launch; returns
// cudaGetLastError() after it.
extern "C" int tt_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                              void* ws, int* tickets, int M, int N, int K, int splits, int path,
                              void* stream) {
  if (path < 0) path = M <= DECODE_MAX_M ? 0 : 1;
  if (M < 1 || K < 16 || N < 16 || K % 16 != 0 || N % 16 != 0 || splits < 1 ||
      splits > MAX_SPLITS || (path == 0 && M > DECODE_MAX_M) ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  bf16* o = (bf16*)out;
  float* w = (float*)ws;
  if (path == 1)
    return (int)(M > PREFILL_WIDE_M
                     ? launch_prefill<2>(x, q, sc, o, w, tickets, M, N, K, splits, st)
                     : launch_prefill<1>(x, q, sc, o, w, tickets, M, N, K, splits, st));
  switch (decode_mt(M)) {
    case 1: return (int)launch_decode<1>(x, q, sc, o, w, tickets, M, N, K, splits, st);
    case 2: return (int)launch_decode<2>(x, q, sc, o, w, tickets, M, N, K, splits, st);
    case 4: return (int)launch_decode<4>(x, q, sc, o, w, tickets, M, N, K, splits, st);
    default: return (int)launch_decode<8>(x, q, sc, o, w, tickets, M, N, K, splits, st);
  }
}

// the dynamic shared memory a block asks for: path 0 with MT (1, 2, 4, 8), path 1 with TH (1,
// 2) as mt
extern "C" int tt_int8_smem_bytes(int path, int mt) {
  if (path == 1) return mt <= 1 ? Pre<1>::SMEM : Pre<2>::SMEM;
  return mt <= 1 ? Dec<1>::SMEM : mt <= 2 ? Dec<2>::SMEM : mt <= 4 ? Dec<4>::SMEM : Dec<8>::SMEM;
}
