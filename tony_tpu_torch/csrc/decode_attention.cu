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
// normalises. Online softmax in f32, scores scaled by Dh^-0.5, o in q's type.
//
// Bound on this card: bytes. A call reads each slot's band of K and V once
// (sum_s band_s * Hkv * Dh * 2 tensors * 2 B) and does ~4 flops a byte, far
// below the H100's ~295 flop/B ridge, so the design keeps bytes in flight on
// every SM (flash-decoding), in one launch:
//
//  - Split-K. One block of NW warps a (kv head, slot, split), a split being
//    SPLIT cache positions; the grid has ceil(T_cap / SPLIT) splits, from the
//    cache's shape and never from `lengths`, so the host reads nothing and a
//    call can be captured in a CUDA graph. A block whose split holds no
//    position of the band exits at once; the slot's last busy split also
//    walks the staged rows and the current token (so a zero-length slot has
//    one busy split, split 0, with the current token alone).
//  - Asynchronous loads. A block's rows go in tiles of TROWS; warp w takes
//    tiles w, w + NW, ... and streams each into its own ring of NST stages of
//    K and V in dynamic shared memory with 16-byte cp.async copies (commit /
//    wait_group), so the next tiles are on their way while one is computed.
//    Rows outside the band are zero-filled, never read. The page table is
//    read once a tile: an aligned tile of 16 rows holds at most one page
//    boundary (page_len is a multiple of 8), at row 8. Rows are padded by 16
//    bytes, so ldmatrix and row reads are free of bank conflicts.
//  - Lean compute. The n_rep query heads of the group share every tile (K and
//    V are read from device memory once per kv head). bf16: mma.sync
//    m16n8k16 with the heads as the 16 rows (padded), q in registers as A
//    fragments; the score fragments become P's A fragments in registers; P
//    goes in as two bf16 terms (hi + lo) so the weights keep ~16 bits, as the
//    f32 softmax of the plain version. Each lane keeps its own running sum;
//    the row max takes two shuffles a tile. f32: the same rings, CUDA-core
//    FMAs with the head dim split over the lanes. Two __syncwarp a tile; the
//    one block-wide barrier joins the warps' states, in warp order.
//  - Deterministic merge. A slot whose band is one split writes o from that
//    join. Otherwise each split writes its unnormalised f32 partial (m, l, o)
//    to a workspace the wrapper allocates, takes a ticket, and the last of
//    the slot's splits to arrive merges them in split order and resets the
//    ticket. Same inputs, same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NREP_MAX = 8;
constexpr int NW = 4;        // warps a split block: each walks every NW-th tile of the split
constexpr int SPLIT = 256;   // cache positions a split block walks (a multiple of TROWS)
constexpr int TROWS = 16;    // rows of K and of V a stage holds: one k16 of keys
constexpr int NST = 3;       // stages in each warp's ring
static_assert(SPLIT % TROWS == 0, "a split is whole tiles");
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int DH>
struct Geo {
  static constexpr int ROWB = DH * (int)sizeof(T) + 16;  // a padded row in shared memory
  static constexpr int CH = DH * (int)sizeof(T) / 16;    // 16-byte chunks a row
  static constexpr int TILE = TROWS * ROWB;              // one tensor's rows in a stage
  static constexpr int STAGE = 2 * TILE;                 // K, then V
  static constexpr int RING = NST * STAGE;               // one warp's ring
  static constexpr int SMEM = NW * RING;
  // after its last tile a warp leaves its partial (o [NREP_MAX][DH], m, l) in its own ring
  static_assert(RING >= (NREP_MAX * DH + 2 * NREP_MAX) * 4, "a warp's partial fits its ring");
};

struct Args {
  const void *q, *k, *v;
  const int* lengths;
  const int* page_table;  // NULL: dense cache
  int max_pages;
  const void *cur_k, *cur_v;
  const void *staged_k, *staged_v;  // NULL: no staged window
  const int* staged_count;
  int W;
  void* o;
  float* ws_o;    // [S, Hkv, n_splits, n_rep, Dh] unnormalised partial o
  float2* ws_ml;  // [S, Hkv, n_splits, n_rep] (running max of the raw scores, sum of weights)
  int* tickets;   // [S, Hkv] splits of (slot, kv head) done; 0 between calls
  int S, H, Hkv;
  int T_len;  // maxT (dense) or page_len (paged)
  int T_cap;  // positions the cache holds for one slot
  int window, n_splits;
};

// Slot s's band: pool positions [lo, end), then cnt staged rows (row j valid when
// pool_len + j >= lo), then the current token. Its busy splits are [b0, b1): those that
// hold a pool position, or split 0 alone when none does; the last, b1 - 1, also walks the
// staged rows and the current token (the tail).
struct Band {
  int lo, end, pool_len, cnt, b0, b1;
};
__device__ __forceinline__ Band band(const Args& a, int s) {
  const int len = a.lengths[s];
  const int count = a.staged_k != nullptr ? a.staged_count[s] : 0;
  Band bd;
  bd.pool_len = max(len - count, 0);
  bd.end = min(bd.pool_len, a.T_cap);
  bd.cnt = a.staged_k != nullptr ? min(max(count, 0), a.W) : 0;
  bd.lo = a.window > 0 ? max(len + 1 - a.window, 0) : 0;
  bd.b0 = bd.lo < bd.end ? bd.lo / SPLIT : 0;
  bd.b1 = bd.lo < bd.end ? (bd.end + SPLIT - 1) / SPLIT : 1;
  return bd;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, bypassing L1; `ok` false zero-fills without a read
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 -> f32; a's rows 8-15 are zero (padding heads)
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// PER consecutive f32 (PER 2 or 4: one 8- or 16-byte load)
template <int PER>
__device__ __forceinline__ void ld_vec(float (&x)[PER], const void* p) {
  if constexpr (PER == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}

// One block of NW warps a (kv head g, slot s, split b = blockIdx.z); a block outside the
// slot's busy splits exits at once. The split's rows go in tiles of TROWS (its pool rows,
// then the tail's on the last busy split), warp w taking tiles w, w + NW, ... through its
// own ring of NST stages; each warp keeps its own online-softmax state, and the block
// joins the NW states in warp order through shared memory. A slot whose band is one split
// writes o there; otherwise each split leaves its partial in the workspace and the last
// of them to finish merges all of them, in split order.
template <typename T, int DH>
__global__ void __launch_bounds__(NW * 32) decode_attention_kernel(Args a) {
  using G = Geo<T, DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int merges;
  const int g = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_rep = a.H / a.Hkv;
  const Band bd = band(a, s);
  if (b < bd.b0 || b >= bd.b1) return;
  // pool rows [first, end) in tiles from r0, then the tail's cnt + 1 rows
  const int first = max(b * SPLIT, bd.lo), end = min((b + 1) * SPLIT, bd.end);
  const int r0 = first / TROWS * TROWS;
  const int n_pool = first < end ? (end - r0 + TROWS - 1) / TROWS : 0;
  const int n_tiles = n_pool + (b == bd.b1 - 1 ? (bd.cnt + 1 + TROWS - 1) / TROWS : 0);
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + NW - 1) / NW : 0;
  unsigned char* ring = smem + warp * G::RING;

  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  // tile t of the block: x0 its first row (a pool position, or a tail row: staged rows
  // 0 .. cnt - 1, then the current token at cnt)
  auto tile_x0 = [&](int t) { return t < n_pool ? r0 + t * TROWS : (t - n_pool) * TROWS; };
  auto key_ok = [&](bool tail, int x) {
    if (!tail) return x >= first && x < end;
    return x < bd.cnt ? bd.pool_len + x >= bd.lo : x == bd.cnt;
  };
  auto load = [&](int i) {
    unsigned char* st = ring + (i % NST) * G::STAGE;
    const int t = warp + i * NW;
    const bool tail = t >= n_pool;
    const int x0 = tile_x0(t);
    size_t off_a = 0, off_b = 0;  // element offsets of rows 0 and 8 of a pool tile
    if (!tail) {
      if (a.page_table != nullptr) {
        // the page table once a tile: an aligned tile of 16 rows holds at most one
        // page boundary (page_len is a multiple of 8), at row 8
        const int* pt = a.page_table + (size_t)s * a.max_pages;
        const int ia = x0 / a.T_len, ib = (x0 + 8) / a.T_len;
        const int pa = pt[ia], pb = ib < a.max_pages ? pt[ib] : pa;
        off_a = (((size_t)pa * a.Hkv + g) * a.T_len + (x0 - ia * a.T_len)) * DH;
        off_b = (((size_t)pb * a.Hkv + g) * a.T_len + (x0 + 8 - ib * a.T_len)) * DH;
      } else {
        off_a = (((size_t)s * a.Hkv + g) * a.T_len + x0) * DH;
        off_b = off_a + 8 * DH;
      }
    }
#pragma unroll
    for (int j = 0; j < G::CH / 2; ++j) {
      const int idx = lane + 32 * j, r = idx / G::CH, c = idx % G::CH;
      const int x = x0 + r;
      const bool ok = key_ok(tail, x);
      const T *kp = K, *vp = V;
      if (ok) {
        size_t off;
        if (!tail) {
          off = r < 8 ? off_a + (size_t)r * DH : off_b + (size_t)(r - 8) * DH;
        } else if (x < bd.cnt) {
          off = (((size_t)s * a.W + x) * a.Hkv + g) * DH;
          kp = static_cast<const T*>(a.staged_k);
          vp = static_cast<const T*>(a.staged_v);
        } else {
          off = ((size_t)s * a.Hkv + g) * DH;
          kp = static_cast<const T*>(a.cur_k);
          vp = static_cast<const T*>(a.cur_v);
        }
        kp += off + c * (16 / sizeof(T));
        vp += off + c * (16 / sizeof(T));
      }
      const uint32_t dst = saddr(st + r * G::ROWB + c * 16);
      cp16(dst, kp, ok);
      cp16(dst + G::TILE, vp, ok);
    }
  };

  const float c2 = LOG2E / sqrtf((float)DH);  // exp(x / sqrt(Dh)) = exp2(x * c2)
  const T* qrow = static_cast<const T*>(a.q) + ((size_t)s * a.H + (size_t)g * n_rep) * DH;
  // this warp's state, left in its ring once its tiles are done
  float* o_s = reinterpret_cast<float*>(ring);  // [NREP_MAX][DH]
  float* m_s = o_s + NREP_MAX * DH;             // [NREP_MAX]
  float* l_s = m_s + NREP_MAX;                  // [NREP_MAX]

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < my_tiles) load(i);
    cp_commit();
  }

  if constexpr (std::is_same<T, bf16>::value) {
    // lane (gq, tq): query head gq of the group, key / column pair tq
    const int gq = lane >> 2, tq = lane & 3;
    const bool live = gq < n_rep;
    uint32_t qa[DH / 16][2];
    {
      const uint32_t* qp = reinterpret_cast<const uint32_t*>(qrow + (size_t)(live ? gq : 0) * DH);
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        qa[ks][0] = live ? qp[8 * ks + tq] : 0u;
        qa[ks][1] = live ? qp[8 * ks + 4 + tq] : 0u;
      }
    }
    float o[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m = NEG, l = 0.f;

    for (int i = 0; i < my_tiles; ++i) {
      if (i + NST - 1 < my_tiles) load(i + NST - 1);
      cp_commit();
      cp_wait<NST - 1>();
      __syncwarp();
      const unsigned char* ks_ = ring + (i % NST) * G::STAGE;
      const unsigned char* vs_ = ks_ + G::TILE;
      const int t = warp + i * NW;
      const bool tail = t >= n_pool;
      const int x0 = tile_x0(t);
      // scores: two n8 blocks of keys, the head dim in k16 steps (two chains a block)
      float sc[2][2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int h = 0; h < 2; ++h) sc[nb][h][0] = sc[nb][h][1] = sc[nb][h][2] = sc[nb][h][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 32; ++kk) {
          uint32_t bk[4];
          ldsm4(bk, saddr(ks_ + (nb * 8 + (lane & 7)) * G::ROWB + (kk * 32 + (lane >> 3) * 8) * 2));
          mma(sc[nb][kk & 1], qa[2 * kk][0], qa[2 * kk][1], bk[0], bk[1]);
          mma(sc[nb][kk & 1], qa[2 * kk + 1][0], qa[2 * kk + 1][1], bk[2], bk[3]);
        }
      }
      const int key[4] = {2 * tq, 2 * tq + 1, 8 + 2 * tq, 9 + 2 * tq};
      float sv[4] = {sc[0][0][0] + sc[0][1][0], sc[0][0][1] + sc[0][1][1],
                     sc[1][0][0] + sc[1][1][0], sc[1][0][1] + sc[1][1][1]};
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ok[e] = key_ok(tail, x0 + key[e]);
        if (ok[e]) mx = fmaxf(mx, sv[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f((m - m_new) * c2);
      m = m_new;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = ok[e] ? exp2f((sv[e] - m_new) * c2) : 0.f;
      l = l * alpha + (p[0] + p[1]) + (p[2] + p[3]);
      bf16 hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __float2bfloat16_rn(p[e]);
        lo[e] = __float2bfloat16_rn(p[e] - __bfloat162float(hi[e]));
      }
      const uint32_t ph0 = pack(hi[0], hi[1]), ph2 = pack(hi[2], hi[3]);
      const uint32_t pl0 = pack(lo[0], lo[1]), pl2 = pack(lo[2], lo[3]);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[n][0] *= alpha;
        o[n][1] *= alpha;
      }
      // o += P . V: V's rows are the k16 of keys, its columns two n8 blocks an ldmatrix
#pragma unroll
      for (int nv = 0; nv < DH / 16; ++nv) {
        uint32_t bv[4];
        ldsm4t(bv, saddr(vs_ + (((lane >> 3) & 1) * 8 + (lane & 7)) * G::ROWB + (nv * 16 + (lane >> 4) * 8) * 2));
        mma(o[2 * nv], ph0, ph2, bv[0], bv[1]);
        mma(o[2 * nv], pl0, pl2, bv[0], bv[1]);
        mma(o[2 * nv + 1], ph0, ph2, bv[2], bv[3]);
        mma(o[2 * nv + 1], pl0, pl2, bv[2], bv[3]);
      }
      __syncwarp();
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    cp_wait<0>();
    __syncwarp();
    if (live) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<float2*>(o_s + gq * DH + n * 8 + 2 * tq) = make_float2(o[n][0], o[n][1]);
      if (tq == 0) {
        m_s[gq] = m;
        l_s[gq] = l;
      }
    }
  } else {
    // f32: lane owns PER consecutive columns of every head
    constexpr int PER = DH / 32;
    float qf[NREP_MAX][PER], of[NREP_MAX][PER], mf[NREP_MAX], lf[NREP_MAX];
#pragma unroll
    for (int r = 0; r < NREP_MAX; ++r) {
      mf[r] = NEG;
      lf[r] = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        qf[r][e] = r < n_rep ? qrow[(size_t)r * DH + lane * PER + e] : 0.f;
        of[r][e] = 0.f;
      }
    }
    for (int i = 0; i < my_tiles; ++i) {
      if (i + NST - 1 < my_tiles) load(i + NST - 1);
      cp_commit();
      cp_wait<NST - 1>();
      __syncwarp();
      const unsigned char* ks_ = ring + (i % NST) * G::STAGE + lane * PER * 4;
      const unsigned char* vs_ = ks_ + G::TILE;
      const int t = warp + i * NW;
      const bool tail = t >= n_pool;
      const int x0 = tile_x0(t);
      bool ok[TROWS];
#pragma unroll
      for (int j = 0; j < TROWS; ++j) ok[j] = key_ok(tail, x0 + j);
#pragma unroll
      for (int r = 0; r < NREP_MAX; ++r) {
        if (r >= n_rep) break;
        float sc[TROWS];
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < TROWS; ++j) {
          float kr[PER];
          ld_vec<PER>(kr, ks_ + j * G::ROWB);
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < PER; ++e) part = fmaf(qf[r][e], kr[e], part);
          sc[j] = warp_sum(part);
          if (ok[j]) mx = fmaxf(mx, sc[j]);
        }
        const float m_new = fmaxf(mf[r], mx);
        const float alpha = exp2f((mf[r] - m_new) * c2);
        mf[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) of[r][e] *= alpha;
#pragma unroll
        for (int j = 0; j < TROWS; ++j) {
          const float pj = ok[j] ? exp2f((sc[j] - m_new) * c2) : 0.f;
          sum += pj;
          float vr[PER];
          ld_vec<PER>(vr, vs_ + j * G::ROWB);
#pragma unroll
          for (int e = 0; e < PER; ++e) of[r][e] = fmaf(pj, vr[e], of[r][e]);
        }
        lf[r] = lf[r] * alpha + sum;
      }
      __syncwarp();
    }
    cp_wait<0>();
    __syncwarp();
#pragma unroll
    for (int r = 0; r < NREP_MAX; ++r) {
      if (r >= n_rep) break;
#pragma unroll
      for (int e = 0; e < PER; ++e) o_s[r * DH + lane * PER + e] = of[r][e];
      if (lane == 0) {
        m_s[r] = mf[r];
        l_s[r] = lf[r];
      }
    }
  }
  __syncthreads();
  // the block's state: the NW warp states joined in warp order (a warp without a valid
  // row has l = 0 and is left out)
  const bool alone = bd.b1 - bd.b0 == 1;
  const size_t part0 = ((size_t)s * a.Hkv + g) * a.n_splits;
  T* out = static_cast<T*>(a.o) + ((size_t)s * a.H + (size_t)g * n_rep) * DH;
  for (int i = threadIdx.x; i < n_rep * DH; i += NW * 32) {
    const int r = i / DH, d = i % DH;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (w < n_tiles) M = fmaxf(M, reinterpret_cast<const float*>(smem + w * G::RING)[NREP_MAX * DH + r]);
    float L = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* ow = reinterpret_cast<const float*>(smem + w * G::RING);
      const float lw = ow[NREP_MAX * DH + NREP_MAX + r];
      if (w < n_tiles && lw > 0.f) {
        const float e = exp2f((ow[NREP_MAX * DH + r] - M) * c2);
        L = fmaf(e, lw, L);
        acc = fmaf(e, ow[r * DH + d], acc);
      }
    }
    if (alone) {
      out[i] = from_f<T>(acc / L);  // L > 0: the tail holds the current token
    } else {
      a.ws_o[((part0 + b) * n_rep + r) * DH + d] = acc;
      if (d == 0) a.ws_ml[(part0 + b) * n_rep + r] = make_float2(M, L);
    }
  }
  if (alone) return;
  // the last of the slot's busy splits to arrive merges splits b0 .. b1 - 1 in that
  // order, whichever block it is (same inputs, same bits)
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (size_t)s * a.Hkv + g;
  if (threadIdx.x == 0) merges = atomicAdd(ticket, 1) == bd.b1 - bd.b0 - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();
  const int nb = bd.b1 - bd.b0;
  float* wgt = reinterpret_cast<float*>(smem);  // [nb][NREP_MAX] weights, then [NREP_MAX] 1 / L
  float2* ml = reinterpret_cast<float2*>(wgt + nb * NREP_MAX + NREP_MAX);  // [nb][NREP_MAX]
  for (int i = threadIdx.x; i < nb * n_rep; i += NW * 32)
    ml[(i / n_rep) * NREP_MAX + i % n_rep] = __ldcg(&a.ws_ml[(part0 + bd.b0 + i / n_rep) * n_rep + i % n_rep]);
  __syncthreads();
  if (threadIdx.x < n_rep) {
    const int r = threadIdx.x;
    float M = NEG;
    for (int j = 0; j < nb; ++j) M = fmaxf(M, ml[j * NREP_MAX + r].x);
    float L = 0.f;
    for (int j = 0; j < nb; ++j) {
      const float w = exp2f((ml[j * NREP_MAX + r].x - M) * c2);
      wgt[j * NREP_MAX + r] = w;
      L = fmaf(w, ml[j * NREP_MAX + r].y, L);
    }
    wgt[nb * NREP_MAX + r] = 1.f / L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rep * DH / 4; i += NW * 32) {
    const int r = i / (DH / 4), d = i % (DH / 4) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < nb; ++j) {
      const float4 ov = __ldcg(reinterpret_cast<const float4*>(a.ws_o + ((part0 + bd.b0 + j) * n_rep + r) * DH + d));
      const float w = wgt[j * NREP_MAX + r];
      acc[0] = fmaf(w, ov.x, acc[0]);
      acc[1] = fmaf(w, ov.y, acc[1]);
      acc[2] = fmaf(w, ov.z, acc[2]);
      acc[3] = fmaf(w, ov.w, acc[3]);
    }
    const float inv = wgt[nb * NREP_MAX + r];
#pragma unroll
    for (int e = 0; e < 4; ++e) out[r * DH + d + e] = from_f<T>(acc[e] * inv);
  }
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next call
}

template <typename T, int DH>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using G = Geo<T, DH>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return attr;
  // the merge's weights and (m, l) of every split fit the shared memory it reuses
  if ((size_t)a.n_splits * NREP_MAX * 12 + NREP_MAX * 4 > (size_t)G::SMEM) return cudaErrorInvalidValue;
  decode_attention_kernel<T, DH><<<dim3(a.Hkv, a.S, a.n_splits), NW * 32, G::SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Cache positions a split walks: the wrapper sizes the workspace and the split count from it.
extern "C" int tt_decode_split_rows() { return SPLIT; }

// Dynamic shared memory a split block asks for (dtype 0 = bfloat16, 1 = float32), -1 if not taken.
extern "C" int tt_decode_smem_bytes(int dtype, int Dh) {
  if (dtype == 0 && Dh == 128) return Geo<bf16, 128>::SMEM;
  if (dtype == 0 && Dh == 64) return Geo<bf16, 64>::SMEM;
  if (dtype == 1 && Dh == 128) return Geo<float, 128>::SMEM;
  if (dtype == 1 && Dh == 64) return Geo<float, 64>::SMEM;
  return -1;
}

// dtype: 0 = bfloat16, 1 = float32. page_table == NULL selects the dense
// cache [S, Hkv, T_len=maxT, Dh]; otherwise the pool [P, Hkv, T_len=page_len, Dh].
// staged_k == NULL means no staged window. workspace: S * Hkv * n_splits *
// n_rep * (Dh + 2) floats, n_splits = ceil(T_cap / SPLIT) with T_cap =
// maxT (dense) or max_pages * page_len (paged); tickets: S * Hkv ints, zero
// before the call and zero again after it (the merging blocks reset them).
// One launch on `stream`; returns cudaGetLastError() after it
// (cudaErrorInvalidValue for an unsupported dtype / Dh / n_rep or a split
// count that does not match).
extern "C" int tt_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    const int* page_table, int max_pages, const void* cur_k, const void* cur_v,
    const void* staged_k, const void* staged_v, const int* staged_count, int W,
    void* o, void* workspace, int* tickets, int n_splits, int S, int H, int Hkv, int Dh,
    int T_len, int window, int dtype, void* stream) {
  if (S <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > NREP_MAX) return (int)cudaErrorInvalidValue;
  const int T_cap = page_table != nullptr ? max_pages * T_len : T_len;
  if (T_cap <= 0 || n_splits != (T_cap + SPLIT - 1) / SPLIT) return (int)cudaErrorInvalidValue;
  const int n_rep = H / Hkv;
  Args a;
  a.q = q; a.k = k; a.v = v; a.lengths = lengths;
  a.page_table = page_table; a.max_pages = max_pages;
  a.cur_k = cur_k; a.cur_v = cur_v;
  a.staged_k = staged_k; a.staged_v = staged_v; a.staged_count = staged_count; a.W = W;
  a.o = o;
  a.ws_o = static_cast<float*>(workspace);
  a.ws_ml = reinterpret_cast<float2*>(a.ws_o + (size_t)S * Hkv * n_splits * n_rep * Dh);
  a.tickets = tickets;
  a.S = S; a.H = H; a.Hkv = Hkv; a.T_len = T_len; a.T_cap = T_cap;
  a.window = window; a.n_splits = n_splits;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && Dh == 128) return (int)launch<bf16, 128>(a, st);
  if (dtype == 0 && Dh == 64) return (int)launch<bf16, 64>(a, st);
  if (dtype == 1 && Dh == 128) return (int)launch<float, 128>(a, st);
  if (dtype == 1 && Dh == 64) return (int)launch<float, 64>(a, st);
  return (int)cudaErrorInvalidValue;
}
