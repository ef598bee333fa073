// The 1x1-convolution link of a bottleneck, fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of benchmarks/probe_fused_link.py:
// _link_kernel :31-52, launched by fused_link :55-82 (pl.pallas_call :66).
// For x [M, K] bf16 (an NHWC activation seen as rows), w [K, N] bf16 (the
// 1x1 convolution's weight) and scale, shift [K] float32 (the previous
// BatchNorm's affine folded with its statistics):
//   xn  = bf16(relu(x * scale + shift))    in float32 (the product, then
//                                           the sum, each rounded), then
//                                           rounded to bf16
//   acc = xn @ w                            float32 accumulation
//   y   = bf16(acc)                         [M, N]
//   s   = sum over rows of acc, ss = sum over rows of acc^2   [N] float32
// The statistics are taken from the float32 accumulator before y is
// rounded, as in the TPU kernel (its probe's xla_link takes them from the
// rounded y, which is not the kernel's function).
//
// What bounds it: bytes.  At ResNet-50's bottleneck links at bs 96 (the
// probe's shapes, e.g. M 301056, K 256, N 64) a link reads x and w and
// writes y once, 2*(M*K + K*N + M*N) bytes, against 2*M*K*N flops: about
// 51 flops a byte, where the H100 needs about 295 (989 TFLOP/s bf16 over
// 3.35 TB/s) before the tensor cores and not the memory are the limit.
// The TPU kernel's order of work (the M tiles innermost and in sequence,
// the statistics carried across them in the output block) does not carry
// over: blocks run in parallel, in no order.
//
// Design: a persistent, warp-specialised kernel.  ops/fused_link.link_plan
// chooses the plan (N-tile width BN, consumer warpgroups G, w resident or
// streamed, ring depth, blocks an N-range) and the entry point takes it.
//   * Tiles of 64 rows x BN columns (BN 64 for N <= 64, else 128, the
//     widest whose accumulator stays in a thread's registers).  The grid
//     is ranges x per_range blocks, at most one an SM: block b keeps
//     N-range b % ranges for all its tiles and walks the M-tiles q, q + P,
//     q + 2P, ... (q = b / ranges, P = per_range), so the blocks of all
//     ranges read the same rows of x at about the same time (all but the
//     first from the L2).  A tile is 64 rows, so the busiest block has at
//     most one tile more than the least busy: at the probe's shapes 99% of
//     the grid's block slots do work over all rounds, 89% at layer3's.
//   * A producer warp (its warpgroup's registers lowered by setmaxnreg)
//     keeps a ring of 3-8 stages full by TMA: a stage is a 64-k slice of G
//     tiles' x, [64 rows x 64] each (128-byte swizzle; the map takes x's
//     row stride, so a strided view is read in place), and, where w
//     streams, the slice's [64 x BN] of w.  It runs ahead across tile
//     boundaries, so a tile's epilogue overlaps the next tiles' loads, and
//     TMA fills rows past M and k past K with zeros (nothing masked by
//     hand).  Where the block's [K x BN] slice of w fits beside the ring
//     (K <= 576 at BN 128, K <= 1280 at BN 64), it is loaded once and
//     stays in shared memory for all the block's tiles (kept last in the
//     L2); else it streams through the ring beside x (layer3's K 1024,
//     layer4's K 2048).  scale and shift are copied into shared memory once
//     a block (zeros past K; their loads from L1 had sat on every slice's
//     critical path), which bounds K (ops/fused_link.link_plan).
//   * G consumer warpgroups (2, or 3 for tiles with many products a byte),
//     one tile each of every group of the block's tiles (the group shares
//     the stage and a streamed w slice).  A warp reads its 16 rows of the
//     slice by ldmatrix from the swizzled box, applies relu(x * scale +
//     shift) -> bf16 to the A fragments in registers, and issues wgmma with
//     A from registers and w as an MN-major B from shared memory: xn never
//     leaves the registers, and the prologue runs once for each element of
//     x in the block's N-range.  A warpgroup waits for a slice's products
//     before it writes the next slice's A fragments: ptxas serialises every
//     wgmma of a kernel that writes A-fragment registers while any product
//     is in flight (its C7513, seen with double-buffered fragments and with
//     two accumulators), and xn written back for an SS wgmma cost more than
//     it saved (a proxy fence and a barrier a slice); the G warpgroups'
//     slices overlap one another instead.
//   * The epilogue: y rounded to bf16 into each warp's staging tile (the
//     128-byte swizzle, conflict-free) and out by TMA store, which clips
//     rows past M and columns past N; s and ss of the float32 accumulators
//     (rows < M) summed over the warp's eight row lanes in a fixed
//     reduce-scatter, each lane keeping BN / 16 running sums across the
//     block's tiles.  At the block's end they are summed over the warps in
//     order: one partial row a block, part [2][per_range][N].
//   * fused_link_reduce_kernel, a second launch, sums each column's
//     per_range partials in a fixed order (32 runs, then the runs), no
//     float atomics: every launch and every graph replay gives the same
//     bits.  It is launched with programmatic stream serialisation: the
//     link's blocks let it start at once, it waits for their writes
//     (griddepcontrol), so its launch overlaps the link's tail.
// What the earlier design (mma.sync from cp.async stages, a barrier a
// stage, a block per 128-row M-tile and N-tile) lost, and what this one does
// about it: the latency of a serial stage loop (TMA, a ring running ahead
// of the consumers, G warpgroups), the mostly empty last wave (64-row
// tiles over a persistent grid), w reloaded for every tile (resident),
// and x read again and the prologue repeated by each N-tile's block (one
// N-range of up to 128 columns a block).  Times against the byte bound:
// PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace scat_mma;

constexpr int kRows = 64;   // rows of a tile: one consumer warpgroup's
constexpr int kBK = 64;     // k of a slice: one 128-byte swizzled row
// a block of G consumer warpgroups (2 or 3, the plan's) and a producer
// warpgroup; the registers a thread of each keeps (setmaxnreg: 128 *
// (producer + G * consumer) <= 64K)
template <int G>
struct Groups {
  static constexpr int kWarps = 4 * G;  // consumer warps
  static constexpr int kThreads = 32 * (kWarps + 4);
  static constexpr int kProducerRegs = G == 2 ? 40 : 24;
  static constexpr int kConsumerRegs = G == 2 ? 232 : 160;
};
constexpr uint32_t kBox = kRows * kBK * 2;  // an x box, a w box: 8 KB
constexpr uint32_t kAtom = 1024;            // 8 swizzled rows of 128 B
constexpr int kMinStages = 3, kMaxStages = 8;
constexpr int kSmemMax = 232448;  // a block's shared memory on an H100
constexpr int kRuns = 32;         // runs of partials the reduce sums

// a warp's staging tile: 16 rows of BN bf16 as BN / 64 boxes of 16 rows x
// 128 B
template <int BN>
__host__ __device__ constexpr int staging_bytes() {
  return 16 * BN * 2;
}

// a ring stage: G tiles' x boxes, then (w streamed) w's BN / 64 boxes
template <int BN, int RES, int G>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return G * kBox + (RES ? 0 : (BN / 64) * kBox);
}

// the dynamic shared memory of a plan (ops/fused_link.smem_bytes mirrors
// it): 1 KB of alignment slack, the ring, w's resident slice, the warps'
// staging tiles, scale and shift (K rounded up to whole slices), and a full
// and an empty barrier a stage and w's
long long smem_bytes(int K, int bn, int groups, int resident, int stages) {
  const long long kpad = (K + kBK - 1) / kBK * kBK;
  const long long stage = groups * kBox + (resident ? 0 : kBK * bn * 2);
  return 1024 + stages * stage + (resident ? kpad * bn * 2 : 0) +
         4LL * groups * 16 * bn * 2 + 8 * kpad + 8LL * (2 * stages + 1);
}

// what a launch needs, passed by value (__grid_constant__, so a CUDA
// graph keeps the tensor maps)
struct Params {
  CUtensorMap x;  // [M, K], boxes of 64 rows x 64 k
  CUtensorMap w;  // [K, N], boxes of 64 k x 64 n
  CUtensorMap y;  // [M, N], boxes of 16 rows x 64 n
  const float* scale;
  const float* shift;
  float* part;  // [2][per_range][N]
  int M, K, N;
  int m_tiles, nk, ranges, per_range, stages;
};

// relu(v * s + h) of a register of two bf16 (the lower column in the low
// half), rounded back to bf16: the product and the sum each rounded, as
// the plain version's two float32 operations are; u holds s.x, s.y, h.x,
// h.y.  The relu after the rounding, on the pair (rounding is monotonic
// and keeps 0, so the bits are the same)
__device__ __forceinline__ uint32_t prologue(uint32_t v, float4 u) {
  const float lo = __uint_as_float(v << 16);
  const float hi = __uint_as_float(v & 0xffff0000u);
  const __nv_bfloat162 r = __hmax2(
      __floats2bfloat162_rn(__fadd_rn(__fmul_rn(lo, u.x), u.z),
                            __fadd_rn(__fmul_rn(hi, u.y), u.w)),
      __float2bfloat162_rn(0.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// warp wq's 16 rows of the slice at k0 in the swizzled box xs as the A
// fragments of its four k16 steps, the prologue applied with scale and
// shift from shared memory (sc[k / 2]: scale[k], scale[k + 1], shift[k],
// shift[k + 1]); k past K reads zeros of x and of scale and shift, so its
// xn is 0
__device__ __forceinline__ void load_slice(uint32_t (&a)[4][4],
                                           const uint8_t* xs,
                                           const float4* sc, int k0, int wq,
                                           int lane) {
  const int row = 16 * wq + lane % 16, half = lane / 16, t = lane % 4;
  const uint8_t* rp = xs + row * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // lanes 0-15 rows 0-15 at k 16kk, lanes 16-31 at 16kk + 8: registers
    // a0 (row g, k 2t), a1 (g + 8), a2 (g, 2t + 8), a3 (g + 8, 2t + 8)
    ldsm_x4(a[kk], rp + (((2 * kk + half) ^ (row & 7)) << 4));
    const int k = k0 + 16 * kk + 2 * t;
    const float4 u0 = sc[k / 2], u1 = sc[k / 2 + 4];
    a[kk][0] = prologue(a[kk][0], u0);
    a[kk][1] = prologue(a[kk][1], u0);
    a[kk][2] = prologue(a[kk][2], u1);
    a[kk][3] = prologue(a[kk][3], u1);
  }
}

// the slice's four k16 products into acc: w's [64 k x BN] at ws, MN-major
// (k rows of 128 swizzled bytes, its 64-column atoms lbo bytes apart); a
// k16 step is two 8-row atoms on
template <int BN>
__device__ __forceinline__ void mma_slice(float (&acc)[BN / 2],
                                          const uint32_t (&a)[4][4],
                                          const uint8_t* ws, uint32_t lbo,
                                          bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = wgmma_desc_sw128(ws + 2 * kAtom * kk, lbo, kAtom);
    if constexpr (BN == 64)
      wgmma_64x64x16_bt(acc, a[kk], b, !(first && kk == 0));
    else
      wgmma_64x128x16_bt(acc, a[kk], b, !(first && kk == 0));
  }
}

// slice c of a tile, the it-th stage of the ring: once it has landed, warp
// wq's A fragments of warpgroup grp's box, then the slice's products,
// waited for (a product in flight while the next slice's A fragments are
// written would make ptxas serialise every wgmma); a stage is free once x
// is in registers and w's slice, if streamed, has been read
template <int BN, int RES, int G>
__device__ __forceinline__ void slice(float (&acc)[BN / 2], const Params& p,
                                      const uint8_t* ring,
                                      const uint8_t* wres, const float4* sc,
                                      uint64_t* full, uint64_t* empty,
                                      uint32_t lbo, int it, int c, int grp,
                                      int wq, int lane) {
  const int s = it % p.stages;
  mbar_wait(&full[s], (it / p.stages) & 1);
  const uint8_t* st = ring + s * stage_bytes<BN, RES, G>();
  uint32_t a[4][4];
  load_slice(a, st + grp * kBox, sc, kBK * c, wq, lane);
  if (RES) mbar_arrive(&empty[s]);
  wgmma_fence();
  mma_slice<BN>(acc, a, RES ? wres + c * kBox : st + G * kBox, lbo, c == 0);
  wgmma_commit();
  wgmma_wait<0>();
  hold(a);
  if (!RES) mbar_arrive(&empty[s]);
}

// The producer, one lane: w's resident slice once, then for each group of
// G of the block's tiles every k slice into the next free stage (the
// tiles' x and, where w streams, w's slice), completing on the stage's
// full barrier
template <int BN, int RES, int G>
__device__ __forceinline__ void produce(const Params& p, uint8_t* ring,
                                        uint8_t* wres, uint64_t* full,
                                        uint64_t* empty, uint64_t* wbar,
                                        int n0, int q) {
  constexpr int kNb = BN / 64;
  constexpr uint32_t kStage = stage_bytes<BN, RES, G>();
  if (RES) {
    mbar_arrive_expect_tx(wbar, p.nk * kNb * kBox);
    for (int jb = 0; jb < kNb; ++jb)
      for (int c = 0; c < p.nk; ++c)
        tma_load_2d<L2Keep::kLastOut>(wres + (jb * p.nk + c) * kBox, &p.w,
                                      wbar, n0 + 64 * jb, kBK * c);
  }
  const int S = p.stages;
  int it = 0;
  for (int mt0 = q; mt0 < p.m_tiles; mt0 += G * p.per_range) {
    // the group's tiles mt0 + i * per_range that exist
    const int count = min(G, (p.m_tiles - mt0 + p.per_range - 1) / p.per_range);
    for (int c = 0; c < p.nk; ++c, ++it) {
      const int s = it % S;
      if (it >= S) mbar_wait(&empty[s], (it / S - 1) & 1);
      uint8_t* st = ring + s * kStage;
      mbar_arrive_expect_tx(&full[s],
                            kBox * count + (RES ? 0 : kNb * kBox));
      // x's rows are read again by the other ranges' blocks, if any
      for (int i = 0; i < count; ++i) {
        const int row = kRows * (mt0 + i * p.per_range);
        if (p.ranges == 1)
          tma_load_2d<L2Keep::kFirstOut>(st + i * kBox, &p.x, &full[s],
                                         kBK * c, row);
        else
          tma_load_2d<L2Keep::kNormal>(st + i * kBox, &p.x, &full[s],
                                       kBK * c, row);
      }
      if (!RES)
        for (int jb = 0; jb < kNb; ++jb)
          tma_load_2d<L2Keep::kLastOut>(st + (G + jb) * kBox, &p.w,
                                        &full[s], n0 + 64 * jb, kBK * c);
    }
  }
}

// one round of reduce_scatter: v[i] and v[i + H] summed with the lane
// whose bit M differs, that lane keeping the other half
template <int L, int H, int M>
__device__ __forceinline__ void scatter_round(float (&v)[L], int lane) {
  const bool upper = lane & M;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// v's L values summed over the warp's eight row lanes g (lane bits 4, 3,
// 2) and scattered: three rounds, each halving what a lane keeps (the lane
// whose bit is set keeps the upper half); lane g ends with the sums of
// v[g L/8 .. (g + 1) L/8 - 1] in v[0 .. L/8 - 1], each in a fixed order
template <int L>
__device__ __forceinline__ void reduce_scatter(float (&v)[L], int lane) {
  scatter_round<L, L / 2, 16>(v, lane);
  scatter_round<L, L / 4, 8>(v, lane);
  scatter_round<L, L / 8, 4>(v, lane);
}

// The consumers: warpgroup grp takes tile mt0 + grp * per_range of each
// group of G; warp wq of it rows 16 wq .. 16 wq + 15 of the tile
template <int BN, int RES, int G>
__device__ __forceinline__ void consume(const Params& p, uint8_t* ring,
                                        const uint8_t* wres,
                                        uint8_t* staging, float4* sc,
                                        uint64_t* full, uint64_t* empty,
                                        uint64_t* wbar, int n0, int q,
                                        int warp, int lane) {
  constexpr int kWarps = Groups<G>::kWarps;
  constexpr int kNb = BN / 64;
  constexpr int kCols = BN / 4;   // a thread's column slots 2j + e: 8j + 2t + e
  constexpr int kKeep = BN / 16;  // s, then ss, of the slots: 2 kCols / 8
  const int grp = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int S = p.stages, nk = p.nk;
  // bytes between w's 64-column atoms: the resident slice keeps each
  // atom's K rows together, a stage its 64
  const uint32_t lbo = RES ? nk * kBox : kBox;
  uint8_t* tile = staging + warp * staging_bytes<BN>();

  // scale and shift once for all the block's tiles, zeros past K (K is
  // even)
  for (int i = threadIdx.x; i < nk * kBK / 2; i += 32 * kWarps) {
    const bool in = 2 * i < p.K;
    sc[i] = in ? make_float4(p.scale[2 * i], p.scale[2 * i + 1],
                             p.shift[2 * i], p.shift[2 * i + 1])
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  named_sync(1, 32 * kWarps);

  // the block's running s and ss of this lane's share (reduce_scatter)
  float stat[kKeep];
#pragma unroll
  for (int i = 0; i < kKeep; ++i) stat[i] = 0.f;
  if (RES) mbar_wait(wbar, 0);

  float acc[BN / 2];
  int it = 0;
  for (int mt0 = q; mt0 < p.m_tiles; mt0 += G * p.per_range) {
    const int mt = mt0 + grp * p.per_range;
    if (mt >= p.m_tiles) {
      // the group has fewer tiles: pass the stages on
      for (int c = 0; c < nk; ++c, ++it) {
        mbar_wait(&full[it % S], (it / S) & 1);
        mbar_arrive(&empty[it % S]);
      }
      continue;
    }

    // slice c is stage it + c; the other warpgroups' slices overlap
    unset(acc);
    for (int c = 0; c < nk; ++c, ++it)
      slice<BN, RES, G>(acc, p, ring, wres, sc, full, empty, lbo, it, c,
                        grp, wq, lane);
    hold(acc);

    // s and ss of the warp's 16 rows (those < M): this thread's rows g and
    // g + 8 (n-tile j in acc[4j..4j+3]: row g columns 8j + 2t, +1, then
    // row g + 8), then over the eight row lanes, into the running sums
    const int row0 = kRows * mt + 16 * wq;
    {
      const bool ok0 = row0 + g < p.M, ok1 = row0 + g + 8 < p.M;
      float v[2 * kCols];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v0 = ok0 ? acc[4 * j + e] : 0.f;
          const float v1 = ok1 ? acc[4 * j + 2 + e] : 0.f;
          v[2 * j + e] = v0 + v1;
          v[kCols + 2 * j + e] = v0 * v0 + v1 * v1;
        }
      reduce_scatter(v, lane);
#pragma unroll
      for (int i = 0; i < kKeep; ++i) stat[i] += v[i];
    }

    // y: the warp's 16 rows into its staging tile once the tile's last
    // store has read it, then out by TMA (clipped at M and N)
    if (lane == 0) bulk_wait_read<0>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint8_t* box = tile + (j / 8) * 2048;
      const int at = 16 * ((j % 8) ^ g) + 4 * t;  // rows g, g + 8 alike
      *reinterpret_cast<uint32_t*>(box + g * 128 + at) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(box + (g + 8) * 128 + at) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    fence_proxy_async();  // written by the threads, read by TMA
    __syncwarp();
    if (lane == 0 && row0 < p.M) {
#pragma unroll
      for (int jb = 0; jb < kNb; ++jb)
        if (n0 + 64 * jb < p.N)
          tma_store_2d(&p.y, tile + jb * 2048, n0 + 64 * jb, row0);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait<0>();

  // the block's partial s and ss: each lane's share into shared memory
  // (the ring, which every consumer has left), then each column over the
  // warps in order
  named_sync(1, 32 * kWarps);
  float* red = reinterpret_cast<float*>(ring);  // [warp][2][BN]
#pragma unroll
  for (int i = 0; i < kKeep; ++i) {
    const int idx = g * kKeep + i, which = idx >= kCols;
    const int slot = idx - which * kCols;
    red[(2 * warp + which) * BN + 8 * (slot / 2) + 2 * t + slot % 2] =
        stat[i];
  }
  named_sync(1, 32 * kWarps);
  const int tid = threadIdx.x;
  if (tid < 2 * BN) {
    const int which = tid / BN, col = tid % BN;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[(2 * wi + which) * BN + col];
    if (n0 + col < p.N)
      p.part[((long long)which * p.per_range + q) * p.N + n0 + col] = v;
  }
}

template <int BN, int RES, int G>
__global__ void __launch_bounds__(Groups<G>::kThreads, 1)
fused_link_kernel(const __grid_constant__ Params p) {
  constexpr int kWarps = Groups<G>::kWarps;
  extern __shared__ __align__(128) uint8_t smem_link[];
  // swizzled boxes need 1024-byte aligned atoms
  uint8_t* base =
      smem_link + ((1024 - (smem_addr(smem_link) & 1023)) & 1023);
  uint8_t* ring = base;
  uint8_t* wres = ring + p.stages * stage_bytes<BN, RES, G>();
  uint8_t* staging = wres + (RES ? p.nk * kBK * BN * 2 : 0);
  float4* sc = reinterpret_cast<float4*>(staging +
                                         kWarps * staging_bytes<BN>());
  uint64_t* full = reinterpret_cast<uint64_t*>(sc + p.nk * kBK / 2);
  uint64_t* empty = full + p.stages;
  uint64_t* wbar = empty + p.stages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x / p.ranges;
  const int n0 = (blockIdx.x % p.ranges) * BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);             // the producer's expect_tx
      mbar_init(&empty[s], 32 * kWarps);  // every consumer thread
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
    // the reduce launch may start; it waits for this grid's writes
    grid_launch_dependents();
  }
  __syncthreads();  // the only block-wide barrier

  if (warp >= kWarps) {
    regs_dec<Groups<G>::kProducerRegs>();
    if (warp == kWarps && lane == 0)
      produce<BN, RES, G>(p, ring, wres, full, empty, wbar, n0, q);
    return;
  }
  regs_inc<Groups<G>::kConsumerRegs>();
  consume<BN, RES, G>(p, ring, wres, staging, sc, full, empty, wbar, n0, q,
                      warp, lane);
}

// s and ss of each column from the blocks' partials part [2][parts][N]: a
// block of 32 columns x kRuns threads; thread (c, j) sums run j of
// consecutive partials in order, then thread (c, 0) the runs in order.
// blockIdx.y 0 gives s, 1 gives ss.  Launched after the link with
// programmatic stream serialisation: it waits for the link's writes.
__global__ void __launch_bounds__(32 * kRuns)
fused_link_reduce_kernel(const float* __restrict__ part, float* __restrict__ s,
                         float* __restrict__ ss, int parts, int N) {
  grid_dependency_wait();
  __shared__ float runs[kRuns][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* src = part + (long long)blockIdx.y * parts * N;
  const int per = (parts + kRuns - 1) / kRuns;
  const int p0 = threadIdx.y * per;
  const int p1 = min(p0 + per, parts);
  float v = 0.f;
  if (col < N)
    for (int i = p0; i < p1; ++i) v += src[(long long)i * N + col];
  runs[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < N) {
    float total = 0.f;
    for (int j = 0; j < kRuns; ++j) total += runs[j][threadIdx.x];
    (blockIdx.y == 0 ? s : ss)[col] = total;
  }
}

// the 2-D map of a bf16 [rows, cols] operand with rows ld elements apart,
// boxes of box_rows x 64 in the 128-byte swizzle; what lies past rows or
// cols reads as zeros (and is not written)
cudaError_t encode_2d(CUtensorMap* map, const void* ptr, long long rows,
                      long long cols, long long ld, int box_rows) {
  scat_tma::EncodeTiled encode = scat_tma::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(2 * ld)};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, int RES, int G>
cudaError_t launch_link(const Params& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_link_kernel<BN, RES, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_link_kernel<BN, RES, G>
      <<<p.ranges * p.per_range, Groups<G>::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BN, int RES>
cudaError_t launch_groups(const Params& p, int groups, int smem,
                          cudaStream_t stream) {
  return groups == 2 ? launch_link<BN, RES, 2>(p, smem, stream)
                     : launch_link<BN, RES, 3>(p, smem, stream);
}

cudaError_t launch_reduce(const float* part, float* s, float* ss, int parts,
                          int N, bool dependent, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 31) / 32, 2);
  cfg.blockDim = dim3(32, kRuns);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, fused_link_reduce_kernel, part, s, ss,
                            parts, N);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// the dynamic shared memory a plan takes (bytes), for ops/fused_link's
// mirror of it to be checked against
long long scat_fused_link_smem(int K, int bn, int groups, int resident,
                               int stages) {
  return smem_bytes(K, bn, groups, resident, stages);
}

// x [M, K] bf16 with rows ldx elements apart, w [K, N] bf16 with rows ldw
// apart (16-byte aligned, ldx >= K unless M is 1, ldw >= N, both multiples
// of 8); scale and shift [K] float32 contiguous; y [M, N] bf16
// contiguous (16-byte aligned); s and ss [N] float32; work: float32
// scratch of 2 * per_range * N.  K and N are multiples of 8, M >= 1.  The
// plan (ops/fused_link.link_plan): N-tiles of bn columns (64 or 128),
// `groups` consumer warpgroups (2 or 3), w resident or not, `stages` ring
// stages, per_range blocks an N-range (at most the 64-row M-tiles).  Two
// launches on `stream` (the
// link, then the sum of its blocks' partials, a programmatic dependent of
// it), no synchronisation; returns cudaGetLastError().
int scat_fused_link(const void* x, const void* w, const void* scale,
                    const void* shift, void* y, void* s, void* ss,
                    void* work, int M, int K, int N, long long ldx,
                    long long ldw, int bn, int groups, int resident,
                    int stages, int per_range, void* stream) {
  const int m_tiles = (M + kRows - 1) / kRows;
  const int nk = (K + kBK - 1) / kBK;
  const long long smem = smem_bytes(K, bn, groups, resident, stages);
  if (M < 1 || K < 8 || N < 8 || K % 8 || N % 8 || ldx % 8 || ldw % 8 ||
      (ldx < K && M > 1) || ldw < N || !aligned(x, 16) || !aligned(w, 16) ||
      !aligned(y, 16) ||
      work == nullptr || (bn != 64 && bn != 128) ||
      (groups != 2 && groups != 3) || stages < kMinStages ||
      stages > kMaxStages || per_range < 1 || per_range > m_tiles ||
      smem > kSmemMax || (resident && nk * kBox >= (1u << 18)))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  cudaError_t err = encode_2d(&p.x, x, M, K, M > 1 ? ldx : K, kRows);
  if (err == cudaSuccess) err = encode_2d(&p.w, w, K, N, ldw, kBK);
  if (err == cudaSuccess) err = encode_2d(&p.y, y, M, N, N, 16);
  if (err != cudaSuccess) return int(err);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.part = static_cast<float*>(work);
  p.M = M;
  p.K = K;
  p.N = N;
  p.m_tiles = m_tiles;
  p.nk = nk;
  p.ranges = (N + bn - 1) / bn;
  p.per_range = per_range;
  p.stages = stages;
  if ((long long)p.ranges * per_range > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  err = bn == 64
            ? (resident ? launch_groups<64, 1>(p, groups, int(smem), st)
                        : launch_groups<64, 0>(p, groups, int(smem), st))
            : (resident ? launch_groups<128, 1>(p, groups, int(smem), st)
                        : launch_groups<128, 0>(p, groups, int(smem), st));
  if (err != cudaSuccess) return int(err);
  err = launch_reduce(p.part, static_cast<float*>(s), static_cast<float*>(ss),
                      per_range, N, true, st);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

// the second launch alone, on partials `work` [2][parts][N] (for timing
// it); dependent: 1 with programmatic stream serialisation, as the link
// launches it
int scat_fused_link_reduce(const void* work, void* s, void* ss, int parts,
                           int N, int dependent, void* stream) {
  if (parts < 1 || N < 1 || work == nullptr) return int(cudaErrorInvalidValue);
  const cudaError_t err = launch_reduce(
      static_cast<const float*>(work), static_cast<float*>(s),
      static_cast<float*>(ss), parts, N, dependent != 0,
      static_cast<cudaStream_t>(stream));
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
