// Fused softmax attention forward for short sequences, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scat_tpu/ops/pallas_attention.py
// (_fwd_kernel :49-60, launched by _flash_fwd_impl :111-129):
//   O = softmax(Q K^T * scale) V      over [B,H,N,D], f32 accumulation.
//
// SCAT's sequences are tiny (21 joint tokens, or 128 feature tokens on the
// HRNet/Inception heads) with head dim 64, so one (batch, head) pair fits
// whole in shared memory and no streaming (online-softmax) decomposition is
// needed.  Q, K, V and O are addressed through (batch, head, row) strides,
// so the projection's [B,N,3,H,D] output is read as views without a copy
// and O is written [B,N,H,D] for the merge of heads.
//
// What bounds it on the H100: bytes.  The work is 4*B*H*N*N*D flops against
// 4*B*H*N*D elements moved (Q, K, V read once, O written once): ~21 flops
// per element at N = 21 and 128 at N = 128, below the ~295 flops per byte
// where the tensor cores become the limit.  In bf16: 8,257,536 bytes at the
// flagship's train shape [96,8,21,64] (2.465 us at 3.35 TB/s) and
// 50,331,648 at the 128-token heads' [96,8,128,64] (15.024 us).  Three
// kernels, chosen by the host code below (fwd_design) from N and the dtype.
//
// bf16, N <= 64 (the flagship's N = 21): per-head tiles on mma.sync.  The
// first design, the CUDA-core one kept below for float32, was bounded by
// its count of instructions (one FMA per 4-byte shared-memory load, one
// query row per warp at a time), so this kernel is the plan of
// attention_bwd.cu's bf16 kernel cut to the forward:
//   * one block per (batch, head) of NT = ceil(N/16) warps (2 at N = 21);
//     warp w owns query rows 16w..16w+15, so the 768 heads of the training
//     batch (18 KB of shared memory each at N = 21) are resident at once;
//   * Q, K and V rows are copied into shared memory as bf16 in 16-byte
//     cp.async copies (attention.cuh stage_async), rows past N zero, rows
//     padded to 144 bytes so that ldmatrix is free of bank conflicts;
//   * S = Q K^T by mma.sync.m16n8k16 (bf16 in, f32 accumulate); keys >= N
//     masked to -inf as the TPU kernel masks its padding; row max and row
//     sum in the accumulator registers with quad shuffles;
//   * P is normalised in float32 and split into a bf16 high part and a
//     bf16 low part, lo = bf16(p - float(hi)) (mma.cuh split_bf16): the
//     accumulator tiles of keys 16kk..16kk+15 are the two A fragments of
//     k-step kk of O = P V, so P never leaves the registers; both products
//     go into the same float32 accumulator; V's B fragments by
//     ldmatrix.trans;
//   * O goes through a per-warp staging tile and leaves in 16-byte stores
//     (attention.cuh store_rows).
// The Pallas kernel keeps P in float32 (pallas_attention.py:57-59).  V is a
// bf16 input, so it is exact, and hi + lo carries P to about 2^-17 of its
// value: the two products do the Pallas kernel's float32 P V at the cost
// of one more product a k-step.  Every bf16 result is held against the
// float32 plain version rounded to bf16, within 2 bf16 ulps.
//
// bf16, 64 < N <= 128 (the 128-token heads): a persistent, warp-specialised
// wgmma kernel (attention_fwd_wgmma_kernel).  The per-head plan above at
// NT = 8 held 127 registers a thread and 72 KB of shared memory a block:
// 2 blocks an SM, 2.9 ragged waves over the 768 heads, and no overlap of a
// block's loads with its own compute.  It took 0.03205 ms on an H100 80GB
// HBM3 at 700 W, 47% of the byte bound and slower than SDPA's 0.02268
// (PERF.md, chip_smoke.py).  This design:
//   * a persistent grid: min(B*H, SMs) blocks, block i takes the pairs i,
//     i + grid, ...; no ragged last wave, and the neighbouring heads of one
//     batch row are read together;
//   * a producer warpgroup (setmaxnreg down to 40 registers) of which one
//     thread keeps three pairs' Q, K and V in flight in a ring of three
//     48 KB stages: a TMA copy of each operand's [128 rows x 128 bytes] box
//     (tensor maps encoded on the host from the strided views, tma.cuh;
//     rows past N read as zeros), completing on the stage's full mbarrier;
//     the consumers release a stage on its empty mbarrier.  The operands
//     are read once, so the copies ask the L2 to evict them first.  A
//     cp.async producer in the same place (16-byte copies into the
//     no-swizzle core layout) held the memory path to well under the
//     TMA's rate;
//   * two consumer warpgroups (setmaxnreg up to 232), 64 query rows each.
//     S = Q K^T is wgmma.m64n128k16 with Q and K read K-major from the
//     stage in TMA's 128-byte swizzled layout, and the next pair's S is in
//     flight while this pair's softmax runs (two score arrays alternate).
//     The softmax stays in registers (in the accumulator layout a row lies
//     in one quad): masking, quad-shuffle max and sum, exp(x scale - max)
//     as exp2 of one fma.  P is normalised and split into bf16 high and low
//     A fragments straight from the accumulators; O = P V is
//     wgmma.m64n64k16 with V an MN-major B (the descriptor's transpose
//     bit) from the same stage;
//   * O leaves through a per-warp staging tile (16 rows in the swizzled
//     layout) by one TMA store a warp into [B,N,H,D] (rows past N are not
//     written), while the next pair's copies land; 16-byte stores from the
//     threads in its place measured slower.
// 168 registers a thread, 164,912 B of shared memory a block, no spills.
// At [96,8,128,64] on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py,
// 200 calls in a CUDA graph): 0.02386 ms, 63.0% of the byte bound, beside
// SDPA's 0.02264 in the same run: 26% faster than the per-head plan and
// 5% slower than the library.  It cannot overlap the first pairs' copies
// and the last pair's compute on each SM (5.8 pairs an SM at the training
// shape); where the rest of the gap to the bound goes is not measured (no
// stall profiler on the card's machine).
//
// The float32 instantiation keeps the CUDA-core design: float32 is the
// parity type (atol 2e-5 against the plain version), which a bf16
// tensor-core product cannot meet.  One block of 4 warps per (batch,
// head); Q, K, V staged as f32 (K rows padded to D+1 floats so that lane j
// reading row j is free of bank conflicts); each warp takes query rows
// warp, warp+4, ...: lane l holds the scores of keys l, l+32, l+64, l+96,
// the row max and sum are warp shuffles, the probabilities go to a
// per-warp row in shared memory, and lane l accumulates output columns l
// and l+32 of P V.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace {

using namespace scat_mma;
using namespace scat_attention;

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kF32Warps = 4;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kKeysPerLane = kMaxSeq / 32;
constexpr int kKStride = kHeadDim + 1;

size_t f32_smem_bytes(int n) {
  // sQ [n][D], sK [n][D+1], sV [n][D], per-warp probability rows [4][n]
  return sizeof(float) *
         (size_t(n) * kHeadDim * 2 + size_t(n) * kKStride + kF32Warps * n);
}

__global__ void __launch_bounds__(kF32Threads)
attention_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         Strides sq, Strides sk, Strides sv, Strides so,
                         int heads, int n, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + n * kHeadDim;
  float* sV = sK + n * kKStride;
  float* sP = sV + n * kHeadDim;

  const long long b = blockIdx.x / heads;
  const long long h = blockIdx.x % heads;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int e = threadIdx.x; e < n * kHeadDim; e += kF32Threads) {
    const int r = e / kHeadDim;
    const int c = e % kHeadDim;
    sQ[r * kHeadDim + c] = qb[r * sq.n + c];
    sK[r * kKStride + c] = kb[r * sk.n + c];
    sV[r * kHeadDim + c] = vb[r * sv.n + c];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p_row = sP + warp * n;
  for (int i = warp; i < n; i += kF32Warps) {
    const float* qi = sQ + i * kHeadDim;
    float s[kKeysPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < n) {
        const float* kj = sK + j * kKStride;
        float acc = 0.f;
#pragma unroll 16
        for (int c = 0; c < kHeadDim; ++c) acc = fmaf(qi[c], kj[c], acc);
        s[t] = acc * scale;
        m = fmaxf(m, s[t]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      if (lane + 32 * t < n) {
        s[t] = expf(s[t] - m);
        l += s[t];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const float inv = 1.f / l;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < n) p_row[j] = s[t] * inv;
    }
    __syncwarp();
    float acc0 = 0.f, acc1 = 0.f;
    for (int j = 0; j < n; ++j) {
      const float p = p_row[j];
      acc0 = fmaf(p, sV[j * kHeadDim + lane], acc0);
      acc1 = fmaf(p, sV[j * kHeadDim + lane + 32], acc1);
    }
    float* oi = ob + i * so.n;
    oi[lane] = acc0;
    oi[lane + 32] = acc1;
    __syncwarp();  // p_row is rewritten for the warp's next row
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores

// the bf16 kernel with NT 16-row tiles: Q, K, V [NP][kRowS] and per-warp
// staging [16][kRowS]
template <int NT>
struct FwdTiles : Tiles<NT> {
  static constexpr size_t kSmem =
      3 * Tiles<NT>::kOperandBytes + Tiles<NT>::kStageBytes;
};

template <int NT>
__global__ void __launch_bounds__(Tiles<NT>::kThreads)
attention_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          Strides sq, Strides sk, Strides sv, Strides so,
                          int heads, int n, float scale) {
  using T = FwdTiles<NT>;
  constexpr int NP = T::kNP;
  constexpr int NC = NP / 8;         // n-tiles of 8 keys
  constexpr int DT = kHeadDim / 8;   // n-tiles of 8 head columns
  constexpr int DK = kHeadDim / 16;  // k-steps over the head dimension
  extern __shared__ uint4 smem_fwd[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_fwd);
  bf16* sK = sQ + NP * kRowS;
  bf16* sV = sK + NP * kRowS;
  bf16* sOut = sV + NP * kRowS;

  const long long b = blockIdx.x / heads;
  const long long h = blockIdx.x % heads;
  stage_async(sQ, q + b * sq.b + h * sq.h, sq.n, n, NP, T::kThreads);
  stage_async(sK, k + b * sk.b + h * sk.h, sk.n, n, NP, T::kThreads);
  stage_async(sV, v + b * sv.b + h * sv.h, sv.n, n, NP, T::kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = 16 * warp;
  const int2 la = lane_a_rowmajor(lane);
  const int2 lnk = lane_b_nk(lane);
  const int2 lkn = lane_b_kn(lane);

  // S = Q K^T: query rows row0..row0+15 against every key
  float s[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DK; ++ks) {
    uint32_t qa[4];
    ldsm_x4(qa, sQ + (row0 + la.x) * kRowS + 16 * ks + la.y);
#pragma unroll
    for (int c2 = 0; c2 < NC / 2; ++c2) {
      uint32_t kb[4];
      ldsm_x4(kb, sK + (16 * c2 + lnk.x) * kRowS + 16 * ks + lnk.y);
      mma_bf16(s[2 * c2], qa, kb[0], kb[1]);
      mma_bf16(s[2 * c2 + 1], qa, kb[2], kb[3]);
    }
  }

  // softmax of rows g (index 0) and g + 8 (index 1); a row is spread over
  // the four lanes of a quad
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * c + 2 * t + (e & 1);
      s[c][e] = col < n ? s[c][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[c][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[c][e] = expf(s[c][e] - mx[e >> 1]);
      sum[e >> 1] += s[c][e];
    }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
    inv[i] = 1.f / sum[i];
  }

  // O = P V: P's accumulator tiles 2kk, 2kk+1, normalised and split into
  // bf16 high and low parts, are the two A fragments of k-step kk
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0], hi[0], lo[0]);
    split_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1], hi[1], lo[1]);
    split_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0], hi[2],
               lo[2]);
    split_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1], hi[3],
               lo[3]);
#pragma unroll
    for (int np = 0; np < DT / 2; ++np) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, sV + (16 * kk + lkn.x) * kRowS + 16 * np + lkn.y);
      mma_bf16(acc[2 * np], hi, vb[0], vb[1]);
      mma_bf16(acc[2 * np], lo, vb[0], vb[1]);
      mma_bf16(acc[2 * np + 1], hi, vb[2], vb[3]);
      mma_bf16(acc[2 * np + 1], lo, vb[2], vb[3]);
    }
  }
  store_rows(acc, 1.f, sOut + warp * 16 * kRowS, o + b * so.b + h * so.h,
             so.n, row0, n, lane);
}

// ---------------------------------------------------------------------------
// bfloat16, 64 < N <= 128: a persistent, warp-specialised wgmma kernel fed
// by TMA (see the head of this file)

constexpr int kWgStages = 3;        // ring of (Q, K, V) stages
constexpr int kWgGroups = 2;        // consumer warpgroups, 64 query rows each
constexpr int kWgWarps = 4 * kWgGroups;          // consumer warps
constexpr int kWgThreads = 32 * (kWgWarps + 4);  // and a producer warpgroup
// registers a thread of the producer warpgroup and of a consumer warpgroup
// keeps (setmaxnreg; 128 * (kWgProducerRegs + 2 * kWgConsumerRegs) <= 64K)
constexpr int kWgProducerRegs = 40;
constexpr int kWgConsumerRegs = 232;
constexpr int kWgBlocksPerSM = 1;
// one staged operand: kMaxSeq rows of kHeadDim bf16 (128 bytes), as TMA
// writes a box in the 128-byte swizzled layout (atoms of 8 rows, 1024 B)
constexpr int kWgOperand = kMaxSeq * kHeadDim;
constexpr int kWgStage = 3 * kWgOperand;  // Q, K, V
constexpr uint32_t kWgStageBytes = sizeof(bf16) * kWgStage;

constexpr uint32_t kTileBytes = 16 * kRowBytes;  // a warp's staging tile

size_t wg_smem_bytes() {
  // the ring and the consumer warps' staging tiles (1024-byte aligned at
  // run time: up to 1 KB of slack), and a full and an empty barrier a
  // stage
  return 1024 + sizeof(bf16) * size_t(kWgStages) * kWgStage +
         size_t(kWgWarps) * kTileBytes + sizeof(uint64_t) * 2 * kWgStages;
}

// the TMA maps of Q, K, V (boxes of kMaxSeq rows) and O (boxes of 16
// rows): 4-D, the head dimension innermost, then row and head in the order
// of their strides, then batch
using WgMaps = scat_tma::Maps<4>;

// a consumer warp's [16 x D] float32 accumulators (wgmma layout: n-tile j
// in acc[4j..4j+3]) as bf16 rows row0..row0+15 of (b, h)'s O: into the
// warp's staging tile (16 rows of 128 bytes in the 128-byte swizzled
// layout, conflict-free), then one TMA store of the box, which writes no
// row past n.  The tile's previous store must have read it first.
__device__ __forceinline__ void wg_store(const float (&acc)[32],
                                         uint8_t* stage, const WgMaps& maps,
                                         int row0, int n, int h, int b,
                                         int lane) {
  if (lane == 0) bulk_wait_read<0>();
  __syncwarp();
  stage_tile(acc, 1.f, stage, lane);
  fence_proxy_async();  // the tile, written by the threads, read by TMA
  __syncwarp();
  if (lane == 0 && row0 < n) {
    store_box(maps, 3, stage, row0, h, b);
    bulk_commit();
  }
}

// issue S = Q K^T of the pair in `st` (a ring stage) for warpgroup grp's
// 64 query rows into sc, committed and in flight: Q (A) and K (B) K-major,
// a k-step of 16 head columns 32 bytes on within the swizzled rows
__device__ __forceinline__ void wg_scores(float (&sc)[64], const bf16* st,
                                          int grp) {
  const uint8_t* sQ = reinterpret_cast<const uint8_t*>(st);
  const uint8_t* sK = sQ + sizeof(bf16) * kWgOperand;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks)
    wgmma_ss_64x128x16<0, 0>(
        sc, wgmma_desc_sw128(sQ + grp * 64 * kRowBytes + 32 * ks, 16, kAtom),
        wgmma_desc_sw128(sK + 32 * ks, 16, kAtom), ks > 0);
  wgmma_commit();
}

// pair p (the it-th of this block) whose scores `cur` are in flight: the
// next pair's scores into `next`, then the softmax, O = P V and O's store
__device__ __forceinline__ void wg_pair(
    float (&cur)[64], float (&next)[64], const bf16* ring, uint64_t* full,
    uint64_t* empty, uint8_t* stage, const WgMaps& maps, int heads, int n,
    long long pairs, long long p, int it, int grp, int gw, int lane,
    float scale) {
  const int t = lane % 4;
  const int s = it % kWgStages;
  wgmma_wait<0>();
  hold(cur);
  if (p + gridDim.x < pairs) {
    const int sn = (it + 1) % kWgStages;
    mbar_wait(&full[sn], ((it + 1) / kWgStages) & 1);
    wg_scores(next, ring + sn * kWgStage, grp);
  }

  // softmax of rows g (index 0) and g + 8 (index 1): key n-tile j in
  // cur[4j..4j+3], a row spread over the four lanes of a quad; keys >= n
  // masked; exp(x scale - max) as exp2 of one fma
  if (n < kMaxSeq) {
#pragma unroll
    for (int j = 0; j < kMaxSeq / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t + (e & 1) >= n) cur[4 * j + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], cur[i]);
  const float c = scale * 1.4426950408889634f;  // scale * log2(e)
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    mc[r] = mx[r] * c;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    cur[i] = exp2f(fmaf(cur[i], c, -mc[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += cur[i];
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
    inv[r] = 1.f / sum[r];
  }

  // P normalised and split into bf16 high and low parts: key n-tiles 2kk
  // and 2kk + 1 are the A fragments of k-step kk of O = P V
  uint32_t hi[kMaxSeq / 16][4], lo[kMaxSeq / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxSeq / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // fragment f: n-tile 2kk + f/2, row g + 8 (f % 2)
      const int i = 8 * kk + 4 * (f >> 1) + 2 * (f & 1);
      split_bf16(cur[i] * inv[f & 1], cur[i + 1] * inv[f & 1], hi[kk][f],
                 lo[kk][f]);
    }

  // O = P V: V an MN-major B ([key][head column], the columns within the
  // swizzled rows), a k-step of 16 keys two atoms on; both parts into one
  // accumulator
  const uint8_t* sV =
      reinterpret_cast<const uint8_t*>(ring + s * kWgStage + 2 * kWgOperand);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMaxSeq / 16; ++kk) {
    const uint64_t bv =
        wgmma_desc_sw128(sV + 2 * kAtom * kk, kMaxSeq * kRowBytes, kAtom);
    wgmma_64x64x16_bt(acc, hi[kk], bv, kk > 0);
    wgmma_64x64x16_bt(acc, lo[kk], bv, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();  // this pair's O and the next pair's scores
  hold(acc);
  hold(hi);
  hold(lo);
  hold(next);
  mbar_arrive(&empty[s]);  // the stage is read: the producer may refill it

  wg_store(acc, stage, maps, 64 * grp + 16 * gw, n, int(p % heads),
           int(p / heads), lane);
}

__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSM)
attention_fwd_wgmma_kernel(const __grid_constant__ WgMaps maps, int heads,
                           int n, long long pairs, float scale) {
  extern __shared__ __align__(128) uint8_t smem_wg[];
  // the swizzled ring and staging tiles need 1024-byte aligned atoms
  uint8_t* base = smem_wg + ((1024 - (smem_addr(smem_wg) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);
  uint8_t* staging = base + sizeof(bf16) * kWgStages * kWgStage;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + kWgWarps * kTileBytes);
  uint64_t* empty = full + kWgStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);                // the producer's expect_tx
      mbar_init(&empty[s], 32 * kWgWarps);   // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();  // the only block-wide barrier

  if (warp >= kWgWarps) {
    // The producer, one lane: pair it into stage it % kWgStages once the
    // consumers have released it, three TMA copies completing on the
    // stage's full barrier; up to kWgStages pairs in flight
    regs_dec<kWgProducerRegs>();
    if (warp == kWgWarps && lane == 0) {
      int it = 0;
      for (long long p = blockIdx.x; p < pairs; p += gridDim.x, ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
        const int b = int(p / heads), h = int(p % heads);
        bf16* st = ring + s * kWgStage;
        mbar_arrive_expect_tx(&full[s], kWgStageBytes);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          load_box(st + i * kWgOperand, maps, i, &full[s], h, b);
      }
    }
    return;
  }

  // The consumers: warpgroup grp takes query rows 64 grp .. 64 grp + 63 of
  // every pair; warp gw of it rows 64 grp + 16 gw + g and + 8.  S of the
  // next pair is in flight on the tensor cores while this pair's softmax
  // runs: the two score arrays alternate
  regs_inc<kWgConsumerRegs>();
  const int grp = warp / 4, gw = warp % 4;
  uint8_t* stage = staging + warp * kTileBytes;
  float sa[64], sb[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sa[i] = sb[i] = 0.f;
  long long p = blockIdx.x;
  int it = 0;
  if (p < pairs) {
    mbar_wait(&full[0], 0);
    wg_scores(sa, ring, grp);
  }
  while (p < pairs) {
    wg_pair(sa, sb, ring, full, empty, stage, maps, heads, n, pairs, p, it,
            grp, gw, lane, scale);
    p += gridDim.x;
    ++it;
    if (p >= pairs) break;
    wg_pair(sb, sa, ring, full, empty, stage, maps, heads, n, pairs, p, it,
            grp, gw, lane, scale);
    p += gridDim.x;
    ++it;
  }
  if (lane == 0) bulk_wait<0>();  // the last stores have left the tile
}

// ---------------------------------------------------------------------------
// launches

cudaError_t launch_f32(const void* const* ptrs, int grid, int heads, int n,
                       const Strides* st, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_f32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  attention_fwd_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(ptrs[0]), static_cast<const float*>(ptrs[1]),
      static_cast<const float*>(ptrs[2]),
      static_cast<float*>(const_cast<void*>(ptrs[3])), st[0], st[1], st[2],
      st[3], heads, n, scale);
  return cudaSuccess;
}

template <int NT>
cudaError_t launch_bf16(const void* const* ptrs, int grid, int heads, int n,
                        const Strides* st, float scale, cudaStream_t stream) {
  using T = FwdTiles<NT>;
  if (T::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_bf16_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::kSmem));
    if (err != cudaSuccess) return err;
  }
  attention_fwd_bf16_kernel<NT><<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const bf16*>(ptrs[0]), static_cast<const bf16*>(ptrs[1]),
      static_cast<const bf16*>(ptrs[2]),
      static_cast<bf16*>(const_cast<void*>(ptrs[3])), st[0], st[1], st[2],
      st[3], heads, n, scale);
  return cudaSuccess;
}

// the persistent kernel's grid: a block an SM (kWgBlocksPerSM), never more
// blocks than pairs
long long wg_grid(long long pairs, int sms) {
  return pairs < (long long)sms * kWgBlocksPerSM
             ? pairs
             : (long long)sms * kWgBlocksPerSM;
}

cudaError_t launch_wgmma(const void* const* ptrs, int batch, int heads,
                         int n, const Strides* st, float scale,
                         cudaStream_t stream) {
  const long long pairs = (long long)batch * heads;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  WgMaps maps;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = scat_tma::encode_rows(&maps.op[i], ptrs[i], st[i].b, st[i].h,
                                st[i].n, batch, heads, n, kHeadDim,
                                i < 3 ? kMaxSeq : 16, kHeadDim,
                                &maps.row_dim[i]);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_fwd_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(wg_smem_bytes()));
  if (err != cudaSuccess) return err;
  attention_fwd_wgmma_kernel<<<int(wg_grid(pairs, sms)), kWgThreads,
                               wg_smem_bytes(), stream>>>(maps, heads, n,
                                                          pairs, scale);
  return cudaSuccess;
}

// the kernel scat_attention_fwd launches for sequence length n and dtype:
// 0 the float32 CUDA-core kernel, 1 the per-head bf16 mma.sync kernel, 2
// the persistent bf16 wgmma kernel; -1 for what it does not take
int fwd_design(int n, int dtype) {
  if (n < 1 || n > kMaxSeq) return -1;
  if (dtype == 0) return 0;
  if (dtype == 1) return n >= kWgMinSeq ? 2 : 1;
  return -1;
}

}  // namespace

extern "C" {

// q, k, v, o: [batch, heads, n, d] addressed through `strides`, 12 element
// strides (batch, head, row) of q, k, v and o in that order; the last
// dimension is contiguous.  dtype 0 = float32, 1 = bfloat16 (then every
// pointer 16-byte aligned and every stride a multiple of 8).  Launches on
// `stream` without synchronising and returns cudaGetLastError().
int scat_attention_fwd(const void* q, const void* k, const void* v, void* o,
                       int batch, int heads, int n, int d,
                       const long long* strides, float scale, int dtype,
                       void* stream) {
  if (d != kHeadDim || n < 1 || n > kMaxSeq || batch < 1 || heads < 1)
    return int(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const long long grid = (long long)batch * heads;  // a block a pair
  if (grid > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, o};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(ptrs, int(grid), heads, n, st, scale, s);
  } else if (dtype == 1) {
    if (!rows_aligned(ptrs, st, 4)) return int(cudaErrorInvalidValue);
    if (fwd_design(n, dtype) == 2)
      err = launch_wgmma(ptrs, batch, heads, n, st, scale, s);
    else
      err = with_tiles(n, [&](auto nt) {
        return launch_bf16<decltype(nt)::value>(ptrs, int(grid), heads, n,
                                                st, scale, s);
      });
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// the blocks of the kernel that scat_attention_fwd launches for sequence
// length n and `dtype` that one SM holds at once (the occupancy API), and
// the dynamic shared memory of each, in bytes; returns a cudaError_t
int scat_attention_fwd_occupancy(int n, int dtype, int* blocks,
                                  int* smem) {
  if (n < 1 || n > kMaxSeq) return int(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    *smem = int(f32_smem_bytes(n));
    err = occupancy(attention_fwd_f32_kernel, kF32Threads,
                    f32_smem_bytes(n), blocks);
  } else if (fwd_design(n, dtype) == 2) {
    *smem = int(wg_smem_bytes());
    err = occupancy(attention_fwd_wgmma_kernel, kWgThreads, wg_smem_bytes(),
                    blocks);
  } else if (dtype == 1) {
    err = with_tiles(n, [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      using T = FwdTiles<NT>;
      *smem = int(T::kSmem);
      return occupancy(attention_fwd_bf16_kernel<NT>, T::kThreads,
                       T::kSmem, blocks);
    });
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(err);
}

// the launch scat_attention_fwd makes for sequence length n, `dtype` and
// `pairs` = batch * heads on a card of `sms` SMs: *design as fwd_design
// gives it, *grid the blocks launched (one a pair, or the persistent
// grid); returns a cudaError_t
int scat_attention_fwd_plan(int n, int dtype, long long pairs, int sms,
                            int* design, long long* grid) {
  *design = fwd_design(n, dtype);
  if (*design < 0 || pairs < 1 || sms < 1) return int(cudaErrorInvalidValue);
  *grid = *design == 2 ? wg_grid(pairs, sms) : pairs;
  return int(cudaSuccess);
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
