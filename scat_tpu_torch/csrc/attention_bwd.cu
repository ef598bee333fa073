// Fused softmax attention backward for short sequences, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scat_tpu/ops/pallas_attention.py
// (_bwd_kernel :63-86, launched by _flash_bwd :136-161), the backward half
// of the _flash_core custom VJP.  Given Q, K, V and dO over [B,H,N,D]:
//   S = Q K^T * scale,  P = softmax(S)            (recomputed, f32)
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dP o P),  dS = P o (dP - delta)
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// P, dP and dS never reach device memory.  D = 64, 1 <= N <= 128; every
// operand is addressed through (batch, head, row) strides, so the
// projection's strided Q/K/V views and the dO that autograd delivers need
// no copy.  Keys >= N are masked to -inf, queries >= N contribute nothing,
// and rows past N are neither read nor written.
//
// What bounds it on the H100: bytes.  It reads Q, K, V, dO and writes dQ,
// dK, dV: 14,450,688 bytes in bf16 at the flagship's train shape
// [96,8,21,64] (4.31 us at 3.35 TB/s) and 88,080,384 at the 128-token
// heads' [96,8,128,64] (26.29 us), against 10*N*N*D flops per (batch,
// head).  Three kernels, chosen by the host code below (bwd_design) from N
// and the dtype.
//
// bf16, N <= 64 (the flagship's N = 21): per-head tiles on mma.sync.  The
// first design, the CUDA-core one kept below for float32, was bounded by
// its count of shared-memory instructions, so the five products run on the
// tensor cores, where one mma.sync does 2,048 multiply-adds from fragments
// that one ldmatrix loads:
//   * one block per (batch, head) of NT = ceil(N/16) warps (2 at N = 21):
//     warp w owns query rows 16w..16w+15 in phase 1 and key rows
//     16w..16w+15 in phase 2; the 768 heads of the training batch (33 KB of
//     shared memory each at N = 21, six blocks an SM) are resident in one
//     wave;
//   * Q, K, V and dO rows are copied into shared memory as bf16 in 16-byte
//     cp.async copies, rows past N zero, rows padded to 144 bytes so that
//     the eight row addresses of an ldmatrix fall in distinct banks;
//   * phase 1 (warp: 16 query rows against all keys): S and dP by
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate); keys >= N masked to
//     -inf; row max, row sum, delta and dS in the accumulator registers
//     with quad shuffles.  P and dS are each split into a bf16 high part
//     and a bf16 low part, lo = bf16(x - float(hi)) (mma.cuh split_bf16),
//     and the four are written to shared memory; dQ = dS K takes dS's two
//     parts straight from the registers as A fragments;
//   * phase 2 (warp: 16 keys): dV = P^T dO and dK = dS^T Q, the transposes
//     by ldmatrix.trans;
//   * each output tile leaves through a per-warp staging tile in 16-byte
//     stores.
//
// bf16, 64 < N <= 128 (the 128-token heads): a persistent, warp-specialised,
// key-major wgmma kernel fed by TMA (attention_bwd_wgmma_kernel).  The
// per-head plan above at NT = 8 took 0.07552 ms at [96,8,128,64] on an
// H100 80GB HBM3 at 700 W, 35% of the byte bound (PERF.md, chip_smoke.py):
// its four [128 x 136] bf16 tiles of P and dS filled an SM's shared memory
// (231,424 B), so one block of 8 warps ran on an SM at a time, 5.8 ragged
// waves over the 768 heads, its copies and its products in series.  This
// design is the persistent forward's plan (attention_fwd.cu) turned round:
//   * a persistent grid: min(B*H, SMs) blocks, block i takes the pairs i,
//     i + grid, ...;
//   * a producer warpgroup (setmaxnreg down to 40 registers) of which one
//     thread keeps the next pair's Q, K, V and dO in flight in a ring of two
//     64 KB stages: one TMA copy a operand of its [128 rows x 128 bytes]
//     box in the 128-byte swizzled layout (rows past N read as zeros),
//     evicted first from the L2, completing on the stage's full mbarrier;
//     the consumers release a stage on its empty mbarrier;
//   * two consumer warpgroups (setmaxnreg up to 232), key-major: warpgroup
//     c owns keys 64c..64c+63.  S^T = K Q^T and dP^T = V dO^T are each four
//     wgmma.m64n128k16 with both operands K-major from the stage, so a
//     thread holds the scores and dP of two keys against 32 queries.  P^T
//     and dS^T then stay in registers, and no [N x N] tile reaches shared
//     memory for dV and dK;
//   * the softmax statistics and delta belong to a query, a column here.
//     S^T and dP^T are two wgmma groups, so that the column max runs while
//     dP^T is in flight.  A warp first takes its 16 keys' column max (a
//     reduce-scatter over the
//     eight lanes that share a column, xor 16, 8, 4, then the all-gather
//     back: 56 shuffles for 32 columns, where a butterfly takes 96), then
//     exp(s scale - max) of each element, and its column sums of e and of
//     e dP reduce-scattered the same way, so that each lane ends holding
//     four columns' (max, sum, sum of e dP).  One exchange through shared
//     memory and two named barriers of the 256 consumer threads combine the
//     eight warps' partials per column in a fixed order (the online
//     softmax's rescaling by exp(max_w - max)); the combine hands each warp
//     the factor exp(max_w - max) / sum that turns its e into P, and delta
//     = sum(P dP).  Queries >= N get factor 0, so they add nothing;
//   * dV = P^T dO and dK = dS^T Q * scale are wgmma.m64n64k16 with P^T and
//     dS^T as A fragments from the registers, split into bf16 high and low
//     parts (mma.cuh split_bf16) into one float32 accumulator, and dO and Q
//     MN-major B operands (the descriptor's transpose bit) from the stage.
//     dV is in flight while dS^T is split and written, and while the
//     warpgroups meet at the barrier that publishes it;
//   * dQ = dS K * scale needs dS by query: the only [N x N] tile in shared
//     memory is dS^T's two bf16 parts (64 KB), written from the fragments
//     into the swizzled layout a descriptor reads, so that warpgroup c forms
//     its 64 query rows of dQ with wgmma.m64n64k16 from dS^T as an MN-major
//     A and K as an MN-major B, issued behind dK.  No atomics: every sum
//     has one fixed order, and the kernel is bit-deterministic;
//   * dQ, dK and dV leave by one TMA store a warp each from swizzled staging
//     tiles in the warpgroup's half of dS's region, once its dQ is formed
//     (rows past N are not written); the next pair's copies land meanwhile.
// The ring (128 KB), dS (64 KB) and the exchange (16.5 KB) take 214,560 B
// of shared memory a block: one block an SM, two stages.  168 registers a
// thread as ptxas counts them (the consumers' setmaxnreg raises theirs), no
// spills.  At [96,8,128,64] on an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py, 200 calls in a CUDA graph): about 0.047 ms, 56% of the
// byte bound, against 0.07552 for the per-head plan and about 0.092 for
// SDPA's backward alone (PERF.md has each run's figures).  What holds the
// rest (timing-only variants of a scratch copy): the copies alone, with
// no compute, already take most of the time, and the column statistics
// and the output stores, neither of which overlaps the tensor cores
// within a pair, each cost a visible share.  Issuing the next pair's S^T
// and dP^T behind dQ (dK and dV stored from the registers) spilled and
// was slower.
//
// The Pallas backward keeps P and dS in float32 (pallas_attention.py:74-83).
// Q, K, V and dO are bf16 inputs, so they are exact, and hi + lo carries P
// and dS to about 2^-17 of their values: each of dV, dQ and dK runs the high
// and the low part's products into the same float32 accumulator, the
// Pallas kernel's float32 products at the cost of one more product a
// split operand.  The bf16 results are held against the float32 plain
// version rounded to bf16, within 2 bf16 ulps.
//
// The float32 instantiation keeps the CUDA-core design of the first port:
// float32 is the parity type (atol 2e-5 against the plain version), which
// a bf16 tensor-core product cannot meet.  One block of 4 warps per
// (batch, head), operands staged as f32 rows padded to D+1 floats; pass 1
// by query row (softmax statistics, delta, dQ), pass 2 by key row
// (recomputing s and dp in the same order; dV, dK).

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kF32Warps = 4;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kPerLane = kMaxSeq / 32;
constexpr int kStride = kHeadDim + 1;

// a . b over the head dimension, in one fixed order
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int c = 0; c < kHeadDim; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

size_t f32_smem_bytes(int n) {
  // sQ, sK, sV, sDO [n][D+1]; per-warp rows [4][n] for p and ds;
  // per-row max, 1/sum and delta [n] each
  return sizeof(float) * (size_t(4) * n * kStride +
                          size_t(2) * kF32Warps * n + size_t(3) * n);
}

__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long row, int n) {
  for (int e = threadIdx.x; e < n * kHeadDim; e += kF32Threads) {
    const int r = e / kHeadDim;
    const int c = e % kHeadDim;
    dst[r * kStride + c] = src[r * row + c];
  }
}

__global__ void __launch_bounds__(kF32Threads)
attention_bwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, Strides sq, Strides sk,
                         Strides sv, Strides sdo, Strides sdq, Strides sdk,
                         Strides sdv, int heads, int n, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + n * kStride;
  float* sV = sK + n * kStride;
  float* sDO = sV + n * kStride;
  float* sRowA = sDO + n * kStride;      // [kF32Warps][n]: p (pass 2)
  float* sRowB = sRowA + kF32Warps * n;  // [kF32Warps][n]: ds
  float* sMax = sRowB + kF32Warps * n;   // [n] row max of S
  float* sInv = sMax + n;                // [n] 1 / row sum of exp(S - max)
  float* sDelta = sInv + n;              // [n] rowsum(dP o P)

  const long long b = blockIdx.x / heads;
  const long long h = blockIdx.x % heads;
  stage_f32(sQ, q + b * sq.b + h * sq.h, sq.n, n);
  stage_f32(sK, k + b * sk.b + h * sk.h, sk.n, n);
  stage_f32(sV, v + b * sv.b + h * sv.h, sv.n, n);
  stage_f32(sDO, dout + b * sdo.b + h * sdo.h, sdo.n, n);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* row_a = sRowA + warp * n;
  float* row_b = sRowB + warp * n;

  // pass 1: query rows -> softmax statistics, delta, dQ
  float* dqb = dq + b * sdq.b + h * sdq.h;
  for (int i = warp; i < n; i += kF32Warps) {
    const float* qi = sQ + i * kStride;
    const float* doi = sDO + i * kStride;
    float s[kPerLane], dp[kPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      dp[t] = 0.f;
      if (j < n) {
        s[t] = dot(qi, sK + j * kStride) * scale;
        dp[t] = dot(doi, sV + j * kStride);
        m = fmaxf(m, s[t]);
      }
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      if (lane + 32 * t < n) {
        s[t] = expf(s[t] - m);
        l += s[t];
      }
    }
    const float inv = 1.f / warp_sum(l);
    float delta = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      s[t] *= inv;  // p_ij
      if (lane + 32 * t < n) delta = fmaf(s[t], dp[t], delta);
    }
    delta = warp_sum(delta);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < n) row_b[j] = s[t] * (dp[t] - delta);
    }
    if (lane == 0) {
      sMax[i] = m;
      sInv[i] = inv;
      sDelta[i] = delta;
    }
    __syncwarp();
    float acc0 = 0.f, acc1 = 0.f;
    for (int j = 0; j < n; ++j) {
      const float ds = row_b[j];
      acc0 = fmaf(ds, sK[j * kStride + lane], acc0);
      acc1 = fmaf(ds, sK[j * kStride + lane + 32], acc1);
    }
    float* dqi = dqb + i * sdq.n;
    dqi[lane] = acc0 * scale;
    dqi[lane + 32] = acc1 * scale;
    __syncwarp();  // row_b is rewritten for the warp's next row
  }
  __syncthreads();  // every row's statistics are in shared memory

  // pass 2: key rows -> dV, dK
  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
  for (int j = warp; j < n; j += kF32Warps) {
    const float* kj = sK + j * kStride;
    const float* vj = sV + j * kStride;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int i = lane + 32 * t;
      if (i < n) {
        // the dot products of pass 1 in the same order
        const float s = dot(sQ + i * kStride, kj) * scale;
        const float p = expf(s - sMax[i]) * sInv[i];
        const float dp = dot(sDO + i * kStride, vj);
        row_a[i] = p;
        row_b[i] = p * (dp - sDelta[i]);
      }
    }
    __syncwarp();
    float v0 = 0.f, v1 = 0.f, k0 = 0.f, k1 = 0.f;
    for (int i = 0; i < n; ++i) {
      const float p = row_a[i];
      const float ds = row_b[i];
      const float* doi = sDO + i * kStride;
      const float* qi = sQ + i * kStride;
      v0 = fmaf(p, doi[lane], v0);
      v1 = fmaf(p, doi[lane + 32], v1);
      k0 = fmaf(ds, qi[lane], k0);
      k1 = fmaf(ds, qi[lane + 32], k1);
    }
    float* dvj = dvb + j * sdv.n;
    float* dkj = dkb + j * sdk.n;
    dvj[lane] = v0;
    dvj[lane + 32] = v1;
    dkj[lane] = k0 * scale;
    dkj[lane + 32] = k1 * scale;
    __syncwarp();  // row_a / row_b are rewritten for the warp's next key
  }
}

// ---------------------------------------------------------------------------
// bfloat16, N < kWgMinSeq: per-head tiles on mma.sync

// the per-head bf16 kernel with NT 16-row tiles: the shared row stride of
// P and dS, and its shared memory (Q, K, V, dO [NP][kRowS]; the high and
// low parts of P and dS [NP][kPS]; per-warp staging [16][kRowS])
template <int NT>
struct BwdTiles : Tiles<NT> {
  static constexpr int kPS = 16 * NT + 8;
  static constexpr size_t kSmem =
      4 * Tiles<NT>::kOperandBytes +
      sizeof(bf16) * size_t(4) * Tiles<NT>::kNP * kPS +
      Tiles<NT>::kStageBytes;
};

template <int NT>
__global__ void __launch_bounds__(Tiles<NT>::kThreads)
attention_bwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          bf16* __restrict__ dq, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, Strides sq, Strides sk,
                          Strides sv, Strides sdo, Strides sdq, Strides sdk,
                          Strides sdv, int heads, int n, float scale) {
  using T = BwdTiles<NT>;
  constexpr int NP = T::kNP, PS = T::kPS;
  constexpr int NC = NP / 8;         // n-tiles of 8 keys
  constexpr int DT = kHeadDim / 8;   // n-tiles of 8 head columns
  constexpr int DK = kHeadDim / 16;  // k-steps over the head dimension
  extern __shared__ uint4 smem_bwd[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_bwd);
  bf16* sK = sQ + NP * kRowS;
  bf16* sV = sK + NP * kRowS;
  bf16* sDO = sV + NP * kRowS;
  bf16* sP = sDO + NP * kRowS;  // high parts
  bf16* sPl = sP + NP * PS;     // low parts
  bf16* sDS = sPl + NP * PS;
  bf16* sDSl = sDS + NP * PS;
  bf16* sOut = sDSl + NP * PS;

  const long long b = blockIdx.x / heads;
  const long long h = blockIdx.x % heads;
  stage_async(sQ, q + b * sq.b + h * sq.h, sq.n, n, NP, T::kThreads);
  stage_async(sK, k + b * sk.b + h * sk.h, sk.n, n, NP, T::kThreads);
  stage_async(sV, v + b * sv.b + h * sv.h, sv.n, n, NP, T::kThreads);
  stage_async(sDO, dout + b * sdo.b + h * sdo.h, sdo.n, n, NP, T::kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 16 * warp;
  bf16* stage = sOut + warp * 16 * kRowS;
  const int2 la = lane_a_rowmajor(lane);
  const int2 lnk = lane_b_nk(lane);
  const int2 lkn = lane_b_kn(lane);
  const int2 lkm = lane_a_km(lane);

  // phase 1: query rows row0..row0+15 against every key
  float s[NC][4], dp[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DK; ++ks) {
    uint32_t qa[4], da[4];
    ldsm_x4(qa, sQ + (row0 + la.x) * kRowS + 16 * ks + la.y);
    ldsm_x4(da, sDO + (row0 + la.x) * kRowS + 16 * ks + la.y);
#pragma unroll
    for (int c2 = 0; c2 < NC / 2; ++c2) {
      uint32_t kb[4], vb[4];
      ldsm_x4(kb, sK + (16 * c2 + lnk.x) * kRowS + 16 * ks + lnk.y);
      ldsm_x4(vb, sV + (16 * c2 + lnk.x) * kRowS + 16 * ks + lnk.y);
      mma_bf16(s[2 * c2], qa, kb[0], kb[1]);
      mma_bf16(s[2 * c2 + 1], qa, kb[2], kb[3]);
      mma_bf16(dp[2 * c2], da, vb[0], vb[1]);
      mma_bf16(dp[2 * c2 + 1], da, vb[2], vb[3]);
    }
  }

  // softmax, delta and dS for rows g (index 0) and g + 8 (index 1); a row
  // is spread over the four lanes of a quad
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * c + 2 * t + (e & 1);
      s[c][e] = col < n ? s[c][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[c][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[c][e] = expf(s[c][e] - mx[e >> 1]);
      sum[e >> 1] += s[c][e];
    }
  float inv[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
    // padded query rows get P = 0, so they add nothing to dV and dK
    inv[i] = row0 + g + 8 * i < n ? 1.f / sum[i] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[c][e] *= inv[e >> 1];  // p_ij
      delta[e >> 1] = fmaf(s[c][e], dp[c][e], delta[e >> 1]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], off);
  // dS, and the high and low parts of P and dS into shared memory; dS's
  // parts of key tile c stay in registers for dQ
  uint32_t dsh[NC][2], dsl[NC][2];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[c][e] = s[c][e] * (dp[c][e] - delta[e >> 1]);  // ds_ij
    const int col = 8 * c + 2 * t;
    uint32_t ph[2], pl[2];
    split_bf16(s[c][0], s[c][1], ph[0], pl[0]);
    split_bf16(s[c][2], s[c][3], ph[1], pl[1]);
    split_bf16(dp[c][0], dp[c][1], dsh[c][0], dsl[c][0]);
    split_bf16(dp[c][2], dp[c][3], dsh[c][1], dsl[c][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = (row0 + g + 8 * i) * PS + col;
      *reinterpret_cast<uint32_t*>(sP + at) = ph[i];
      *reinterpret_cast<uint32_t*>(sPl + at) = pl[i];
      *reinterpret_cast<uint32_t*>(sDS + at) = dsh[c][i];
      *reinterpret_cast<uint32_t*>(sDSl + at) = dsl[c][i];
    }
  }

  // dQ = dS K: the parts of key tiles 2kk, 2kk+1 are the two A fragments
  // of k-step kk
  {
    float acc[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const uint32_t hi[4] = {dsh[2 * kk][0], dsh[2 * kk][1],
                              dsh[2 * kk + 1][0], dsh[2 * kk + 1][1]};
      const uint32_t lo[4] = {dsl[2 * kk][0], dsl[2 * kk][1],
                              dsl[2 * kk + 1][0], dsl[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, sK + (16 * kk + lkn.x) * kRowS + 16 * np + lkn.y);
        mma_bf16(acc[2 * np], hi, kb[0], kb[1]);
        mma_bf16(acc[2 * np], lo, kb[0], kb[1]);
        mma_bf16(acc[2 * np + 1], hi, kb[2], kb[3]);
        mma_bf16(acc[2 * np + 1], lo, kb[2], kb[3]);
      }
    }
    store_rows(acc, scale, stage, dq + b * sdq.b + h * sdq.h, sdq.n, row0, n,
               lane);
  }
  __syncthreads();  // every warp's P and dS rows are in shared memory

  // phase 2: keys row0..row0+15; dV = P^T dO, dK = dS^T Q over all rows,
  // each from the high and the low part
  float av[DT][4], ak[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[j][e] = ak[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const int at = (16 * kk + lkm.x) * PS + row0 + lkm.y;
    uint32_t pa[4], pl[4], sa[4], sl[4];
    ldsm_x4_trans(pa, sP + at);
    ldsm_x4_trans(pl, sPl + at);
    ldsm_x4_trans(sa, sDS + at);
    ldsm_x4_trans(sl, sDSl + at);
#pragma unroll
    for (int np = 0; np < DT / 2; ++np) {
      uint32_t ob[4], qb[4];
      ldsm_x4_trans(ob, sDO + (16 * kk + lkn.x) * kRowS + 16 * np + lkn.y);
      ldsm_x4_trans(qb, sQ + (16 * kk + lkn.x) * kRowS + 16 * np + lkn.y);
      mma_bf16(av[2 * np], pa, ob[0], ob[1]);
      mma_bf16(av[2 * np], pl, ob[0], ob[1]);
      mma_bf16(av[2 * np + 1], pa, ob[2], ob[3]);
      mma_bf16(av[2 * np + 1], pl, ob[2], ob[3]);
      mma_bf16(ak[2 * np], sa, qb[0], qb[1]);
      mma_bf16(ak[2 * np], sl, qb[0], qb[1]);
      mma_bf16(ak[2 * np + 1], sa, qb[2], qb[3]);
      mma_bf16(ak[2 * np + 1], sl, qb[2], qb[3]);
    }
  }
  store_rows(av, 1.f, stage, dv + b * sdv.b + h * sdv.h, sdv.n, row0, n,
             lane);
  store_rows(ak, scale, stage, dk + b * sdk.b + h * sdk.h, sdk.n, row0, n,
             lane);
}

// ---------------------------------------------------------------------------
// bfloat16, 64 < N <= 128: a persistent, warp-specialised, key-major wgmma
// kernel fed by TMA (see the head of this file)

constexpr int kWgStages = 2;        // ring of (Q, K, V, dO) stages
constexpr int kWgGroups = 2;        // consumer warpgroups, 64 keys each
constexpr int kWgWarps = 4 * kWgGroups;          // consumer warps
constexpr int kWgConsumers = 32 * kWgWarps;      // consumer threads
constexpr int kWgThreads = kWgConsumers + 128;   // and a producer warpgroup
// registers a thread of the producer warpgroup and of a consumer warpgroup
// keeps (setmaxnreg; 128 * (kWgProducerRegs + 2 * kWgConsumerRegs) <= 64K)
constexpr int kWgProducerRegs = 40;
constexpr int kWgConsumerRegs = 232;
constexpr int kWgBlocksPerSM = 1;
// one staged operand: kMaxSeq rows of kHeadDim bf16 (128 bytes), as TMA
// writes a box in the 128-byte swizzled layout (atoms of 8 rows, 1024 B)
constexpr uint32_t kOperandBytes = kMaxSeq * kRowBytes;
constexpr uint32_t kStageBytes = 4 * kOperandBytes;  // Q, K, V, dO
// dS^T, the MN-major A of dQ = dS K: per half of the queries (64, one
// swizzled row of 128 bytes) and per part (high, low), [kMaxSeq keys][64]
constexpr uint32_t kDsBlock = kMaxSeq * kRowBytes;
constexpr uint32_t kDsHalf = 2 * kDsBlock;
constexpr uint32_t kDsBytes = 2 * kDsHalf;
constexpr uint32_t kTileBytes = 16 * kRowBytes;  // a warp's output tile
// the column exchange: each consumer warp's max, sum and sum of e dP, and
// the factors the combine hands back, [kWgWarps][kMaxSeq] floats each;
// delta [kMaxSeq]
constexpr uint32_t kPartBytes = sizeof(float) * kWgWarps * kMaxSeq;
constexpr size_t kWgSmem = 1024 /* 1024-byte alignment at run time */ +
                           kWgStages * kStageBytes + kDsBytes +
                           4 * kPartBytes + sizeof(float) * kMaxSeq +
                           sizeof(uint64_t) * 2 * kWgStages;
static_assert(kWgSmem <= 232448, "the backward must fit a block's 227 KB");
static_assert(4 * 3 * kTileBytes <= kDsHalf,
              "a warpgroup's output tiles fit its half of dS's region");
// named barriers of the consumer threads: partials written, combined, and
// dS^T written; then one of each warpgroup's 128 threads
constexpr int kBarPartials = 1, kBarCombined = 2, kBarDs = 3, kBarGroup = 4;

// the TMA maps of Q, K, V, dO (boxes of kMaxSeq rows) and dQ, dK, dV
// (boxes of 16 rows), in that order
using BwdMaps = scat_tma::Maps<7>;

// One halving step of a reduce-scatter over the eight lanes that share a
// column (lanes xor `mask`, the bit of g it flips): of the slots v[0..2H),
// the lane whose bit is set keeps the upper half, the other the lower, and
// each combines its half with its partner's, into v[0..H)
template <int H, int N>
__device__ __forceinline__ void scatter_max(float (&v)[N], bool upper,
                                            int mask) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = upper ? v[i + H] : v[i];
    const float send = upper ? v[i] : v[i + H];
    v[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, mask));
  }
}
template <int H, int N>
__device__ __forceinline__ void scatter_sum(float (&v)[N], float (&w)[N],
                                            bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep_v = upper ? v[i + H] : v[i];
    const float send_v = upper ? v[i] : v[i + H];
    const float keep_w = upper ? w[i + H] : w[i];
    const float send_w = upper ? w[i] : w[i + H];
    v[i] = keep_v + __shfl_xor_sync(0xffffffffu, send_v, mask);
    w[i] = keep_w + __shfl_xor_sync(0xffffffffu, send_w, mask);
  }
}
// the inverse step: v[0..H) and the partner's back into v[0..2H)
template <int H, int N>
__device__ __forceinline__ void gather(float (&v)[N], bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float mine = v[i];
    const float other = __shfl_xor_sync(0xffffffffu, mine, mask);
    v[i] = upper ? other : mine;
    v[i + H] = upper ? mine : other;
  }
}

// The column statistics of one pair for consumer warp cw, whose thread
// holds keys key0 and key0 + 8: s holds the raw scores S^T (query n-tile j
// in s[4j..4j+3]).  A thread's 32 columns are its slots 2j + u (column
// 8j + 2t + u); after the three halving steps of a reduce-scatter, slot
// 4g + f of its lane group is in v[f].  column_max masks keys >= n and
// gives every lane the warp's max of each of its columns (mx, by slot),
// and its own four slots' max scaled by c = scale log2(e) (mine)
__device__ __forceinline__ void column_max(float (&s)[64], float (&mx)[32],
                                           float (&mine)[4], int key0, int n,
                                           float c, int lane) {
  const int g = lane / 4;
  const bool up4 = g & 4, up2 = g & 2, up1 = g & 1;
  if (n < kMaxSeq) {
    const bool m0 = key0 >= n, m1 = key0 + 8 >= n;
#pragma unroll
    for (int j = 0; j < kMaxSeq / 8; ++j) {
      if (m0) s[4 * j] = s[4 * j + 1] = -INFINITY;
      if (m1) s[4 * j + 2] = s[4 * j + 3] = -INFINITY;
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[i] = fmaxf(s[4 * (i >> 1) + (i & 1)], s[4 * (i >> 1) + 2 + (i & 1)]);
  scatter_max<16>(mx, up4, 16);
  scatter_max<8>(mx, up2, 8);
  scatter_max<4>(mx, up1, 4);
#pragma unroll
  for (int f = 0; f < 4; ++f) mine[f] = mx[f] * c;
  gather<4>(mx, up1, 4);
  gather<8>(mx, up2, 8);
  gather<16>(mx, up4, 16);
}

// then column_sums replaces s by e = exp(s scale - max_w) and writes the
// warp's partials of its own four columns (max_w c, the sum of e, the sum
// of e dP) to the exchange
__device__ __forceinline__ void column_sums(float (&s)[64],
                                            const float (&dp)[64],
                                            const float (&mx)[32],
                                            const float (&mine)[4],
                                            float* xm, float* xl, float* xd,
                                            int cw, float c, int lane) {
  const int g = lane / 4, t = lane % 4;
  const bool up4 = g & 4, up2 = g & 2, up1 = g & 1;
  // e, and its column sums (the first halving step fused in)
  float sl[16], sd[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float l2[2], d2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int slot = i + 16 * hh;
      const int a = 4 * (slot >> 1) + (slot & 1), b = a + 2;
      // a warp whose keys are all masked has max -inf: its e are 0
      const float mc = mx[slot] == -INFINITY ? 0.f : mx[slot] * c;
      s[a] = exp2_approx(fmaf(s[a], c, -mc));
      s[b] = exp2_approx(fmaf(s[b], c, -mc));
      l2[hh] = s[a] + s[b];
      d2[hh] = fmaf(s[b], dp[b], s[a] * dp[a]);
    }
    const float keep_l = up4 ? l2[1] : l2[0], send_l = up4 ? l2[0] : l2[1];
    const float keep_d = up4 ? d2[1] : d2[0], send_d = up4 ? d2[0] : d2[1];
    sl[i] = keep_l + __shfl_xor_sync(0xffffffffu, send_l, 16);
    sd[i] = keep_d + __shfl_xor_sync(0xffffffffu, send_d, 16);
  }
  scatter_sum<8>(sl, sd, up2, 8);
  scatter_sum<4>(sl, sd, up1, 4);
  // slots 4g + f: columns 16g + 8(f/2) + 2t + f%2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int at = cw * kMaxSeq + 16 * g + 8 * h + 2 * t;
    *reinterpret_cast<float2*>(xm + at) =
        make_float2(mine[2 * h], mine[2 * h + 1]);
    *reinterpret_cast<float2*>(xl + at) =
        make_float2(sl[2 * h], sl[2 * h + 1]);
    *reinterpret_cast<float2*>(xd + at) =
        make_float2(sd[2 * h], sd[2 * h + 1]);
  }
}

// query q's statistics from the eight warps' partials, in warp order: the
// max, the sum of e rescaled by exp(max_w - max), and delta = sum(P dP);
// writes each warp's factor exp(max_w - max) / sum (0 for q >= n) and
// delta
__device__ __forceinline__ void combine_column(const float* xm,
                                               const float* xl,
                                               const float* xd, float* fac,
                                               float* delta, int q, int n) {
  float f[kWgWarps], mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWgWarps; ++w) {
    f[w] = xm[w * kMaxSeq + q];
    mx = fmaxf(mx, f[w]);
  }
  float l = 0.f, d = 0.f;
#pragma unroll
  for (int w = 0; w < kWgWarps; ++w) {
    f[w] = exp2_approx(f[w] - mx);
    l = fmaf(xl[w * kMaxSeq + q], f[w], l);
    d = fmaf(xd[w * kMaxSeq + q], f[w], d);
  }
  const float inv = q < n ? 1.f / l : 0.f;
#pragma unroll
  for (int w = 0; w < kWgWarps; ++w) fac[w * kMaxSeq + q] = f[w] * inv;
  delta[q] = d * inv;
}

// e -> P = e * factor and dP -> dS = P (dP - delta), column by column
__device__ __forceinline__ void probabilities(float (&s)[64],
                                              float (&dp)[64],
                                              const float* fac,
                                              const float* delta, int cw,
                                              int lane) {
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < kMaxSeq / 8; ++j) {
    const float2 f2 = *reinterpret_cast<const float2*>(
        fac + cw * kMaxSeq + 8 * j + 2 * t);
    const float2 d2 =
        *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float p = s[i] * ((e & 1) ? f2.y : f2.x);
      dp[i] = p * (dp[i] - ((e & 1) ? d2.y : d2.x));
      s[i] = p;
    }
  }
}

// x (a key-major [64 x kMaxSeq] accumulator) split into bf16 high and low A
// fragments: query n-tiles 2kk and 2kk + 1 are k-step kk's
__device__ __forceinline__ void split_fragments(const float (&x)[64],
                                                uint32_t (&hi)[8][4],
                                                uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < kMaxSeq / 16; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // fragment f: n-tile 2kk + f/2, row g + 8 (f % 2)
      const int i = 8 * kk + 4 * (f >> 1) + 2 * (f & 1);
      split_bf16(x[i], x[i + 1], hi[kk][f], lo[kk][f]);
    }
}

__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSM)
attention_bwd_wgmma_kernel(const __grid_constant__ BwdMaps maps, int heads,
                           int n, long long pairs, float scale) {
  extern __shared__ __align__(128) uint8_t smem_wg[];
  // the swizzled ring, dS^T and the staging tiles need 1024-byte atoms
  uint8_t* ring = smem_wg + ((1024 - (smem_addr(smem_wg) & 1023)) & 1023);
  uint8_t* ds = ring + kWgStages * kStageBytes;
  float* xm = reinterpret_cast<float*>(ds + kDsBytes);
  float* xl = xm + kWgWarps * kMaxSeq;
  float* xd = xl + kWgWarps * kMaxSeq;
  float* fac = xd + kWgWarps * kMaxSeq;
  float* delta = fac + kWgWarps * kMaxSeq;
  uint64_t* full = reinterpret_cast<uint64_t*>(delta + kMaxSeq);
  uint64_t* empty = full + kWgStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx
      mbar_init(&empty[s], kWgConsumers);   // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();  // the only block-wide barrier

  if (warp >= kWgWarps) {
    // The producer, one lane: pair it into stage it % kWgStages once the
    // consumers have released it, four TMA copies completing on the
    // stage's full barrier
    regs_dec<kWgProducerRegs>();
    if (warp == kWgWarps && lane == 0) {
      int it = 0;
      for (long long p = blockIdx.x; p < pairs; p += gridDim.x, ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
        const int b = int(p / heads), h = int(p % heads);
        uint8_t* st = ring + s * kStageBytes;
        mbar_arrive_expect_tx(&full[s], kStageBytes);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_box(st + i * kOperandBytes, maps, i, &full[s], h, b);
      }
    }
    return;
  }

  // The consumers: warpgroup grp takes keys 64 grp .. 64 grp + 63 of every
  // pair (warp gw of it keys 64 grp + 16 gw + g and + 8) for S^T, dP^T, dV
  // and dK, and query rows 64 grp .. 64 grp + 63 for dQ
  regs_inc<kWgConsumerRegs>();
  const int grp = warp / 4, gw = warp % 4;
  const int key0 = 64 * grp + 16 * gw + lane / 4;
  const float c = scale * 1.4426950408889634f;  // scale * log2(e)
  uint8_t* dsq = ds + grp * kDsHalf;  // this warpgroup's queries of dS^T
  uint8_t* tiles = dsq + gw * 3 * kTileBytes;  // the warp's dQ, dK, dV
  int it = 0;
  for (long long p = blockIdx.x; p < pairs; p += gridDim.x, ++it) {
    const int s = it % kWgStages;
    const uint8_t* sQ = ring + s * kStageBytes;
    const uint8_t* sK = sQ + kOperandBytes;
    const uint8_t* sV = sK + kOperandBytes;
    const uint8_t* sDO = sV + kOperandBytes;
    mbar_wait(&full[s], (it / kWgStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: the warpgroup's 64 keys (A) against
    // every query (B), both K-major, a k-step of 16 head columns 32 bytes
    // on within the swizzled rows; two groups, so that the column max runs
    // while dP^T is in flight
    float sc[64], dp[64];
    unset(sc);
    unset(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks)
      wgmma_ss_64x128x16<0, 0>(
          sc, wgmma_desc_sw128(sK + grp * 64 * kRowBytes + 32 * ks, 16, kAtom),
          wgmma_desc_sw128(sQ + 32 * ks, 16, kAtom), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks)
      wgmma_ss_64x128x16<0, 0>(
          dp, wgmma_desc_sw128(sV + grp * 64 * kRowBytes + 32 * ks, 16, kAtom),
          wgmma_desc_sw128(sDO + 32 * ks, 16, kAtom), ks > 0);
    wgmma_commit();

    // the column statistics: partials, one exchange, the combine
    wgmma_wait<1>();
    hold(sc);
    float mx[32], mine[4];
    column_max(sc, mx, mine, key0, n, c, lane);
    wgmma_wait<0>();
    hold(dp);
    column_sums(sc, dp, mx, mine, xm, xl, xd, warp, c, lane);
    // the previous pair's output stores have read their tiles (dS^T's
    // region, rewritten below) before any thread passes the barriers
    if (lane == 0) bulk_wait_read<0>();
    named_sync(kBarPartials, kWgConsumers);
    if (int(threadIdx.x) < kMaxSeq)
      combine_column(xm, xl, xd, fac, delta, int(threadIdx.x), n);
    named_sync(kBarCombined, kWgConsumers);
    probabilities(sc, dp, fac, delta, warp, lane);

    // dV = P^T dO: P^T's parts as A fragments, dO an MN-major B ([query]
    // [head column]), a k-step of 16 queries two atoms on; both parts into
    // one accumulator
    uint32_t ph[8][4], pl[8][4];
    split_fragments(sc, ph, pl);
    float av[32];
    unset(av);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMaxSeq / 16; ++kk) {
      const uint64_t b =
          wgmma_desc_sw128(sDO + 2 * kAtom * kk, kOperandBytes, kAtom);
      wgmma_64x64x16_bt(av, ph[kk], b, kk > 0);
      wgmma_64x64x16_bt(av, pl[kk], b, 1);
    }
    wgmma_commit();

    // dS^T's parts: the A fragments of dK = dS^T Q, and into shared memory
    // as dQ's MN-major A: key row r of query half j / 8, its 16-byte chunk
    // (query n-tile) j % 8 swizzled by r % 8 = g
    uint32_t sh[8][4], sl[8][4];
    split_fragments(dp, sh, sl);
    {
      const int g = lane / 4, t = lane % 4;
#pragma unroll
      for (int kk = 0; kk < kMaxSeq / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = 2 * kk + (f >> 1);
          uint8_t* at = ds + (j >> 3) * kDsHalf +
                        (key0 + 8 * (f & 1)) * kRowBytes +
                        16 * ((j & 7) ^ g) + 4 * t;
          *reinterpret_cast<uint32_t*>(at) = sh[kk][f];
          *reinterpret_cast<uint32_t*>(at + kDsBlock) = sl[kk][f];
        }
    }
    fence_proxy_async();  // dS^T, written by the threads, read by wgmma
    named_sync(kBarDs, kWgConsumers);  // both warpgroups' dS^T written
    float ak[32];
    unset(ak);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMaxSeq / 16; ++kk) {
      const uint64_t b =
          wgmma_desc_sw128(sQ + 2 * kAtom * kk, kOperandBytes, kAtom);
      wgmma_64x64x16_bt(ak, sh[kk], b, kk > 0);
      wgmma_64x64x16_bt(ak, sl[kk], b, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // dV: P^T's fragments are free
    hold(av);
    hold(ph);
    hold(pl);

    // dQ = dS K: this warpgroup's 64 queries of dS^T's parts (an MN-major
    // A, 64 queries a swizzled row) and K an MN-major B, a k-step of 16
    // keys two atoms on
    float aq[32];
    unset(aq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMaxSeq / 16; ++kk) {
      const uint64_t b =
          wgmma_desc_sw128(sK + 2 * kAtom * kk, kOperandBytes, kAtom);
      wgmma_ss_64x64x16<1, 1>(
          aq, wgmma_desc_sw128(dsq + 2 * kAtom * kk, kOperandBytes, kAtom),
          b, kk > 0);
      wgmma_ss_64x64x16<1, 1>(
          aq,
          wgmma_desc_sw128(dsq + kDsBlock + 2 * kAtom * kk, kOperandBytes,
                           kAtom),
          b, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(ak);
    hold(sh);
    hold(sl);
    hold(aq);
    mbar_arrive(&empty[s]);  // the stage is read: the producer may refill it

    // the outputs leave through staging tiles in this warpgroup's half of
    // dS^T, once every warp of the warpgroup has its dQ (the half's only
    // reader)
    group_sync(kBarGroup + grp);
    stage_tile(aq, scale, tiles, lane);
    stage_tile(ak, scale, tiles + kTileBytes, lane);
    stage_tile(av, 1.f, tiles + 2 * kTileBytes, lane);
    fence_proxy_async();  // the tiles, written by the threads, read by TMA
    __syncwarp();
    const int row0 = 64 * grp + 16 * gw;
    if (lane == 0 && row0 < n) {
      const int b = int(p / heads), h = int(p % heads);
      store_box(maps, 4, tiles, row0, h, b);
      store_box(maps, 5, tiles + kTileBytes, row0, h, b);
      store_box(maps, 6, tiles + 2 * kTileBytes, row0, h, b);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait<0>();  // the last stores have left the tiles
}

// ---------------------------------------------------------------------------
// launches

cudaError_t launch_f32(const void* const* ptrs, int grid, int heads, int n,
                       const Strides* st, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_f32_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  attention_bwd_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(ptrs[0]), static_cast<const float*>(ptrs[1]),
      static_cast<const float*>(ptrs[2]), static_cast<const float*>(ptrs[3]),
      static_cast<float*>(const_cast<void*>(ptrs[4])),
      static_cast<float*>(const_cast<void*>(ptrs[5])),
      static_cast<float*>(const_cast<void*>(ptrs[6])), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], heads, n, scale);
  return cudaSuccess;
}

template <int NT>
cudaError_t launch_bf16(const void* const* ptrs, int grid, int heads, int n,
                        const Strides* st, float scale, cudaStream_t stream) {
  using T = BwdTiles<NT>;
  if (T::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_bf16_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::kSmem));
    if (err != cudaSuccess) return err;
  }
  attention_bwd_bf16_kernel<NT><<<grid, T::kThreads, T::kSmem, stream>>>(
      static_cast<const bf16*>(ptrs[0]), static_cast<const bf16*>(ptrs[1]),
      static_cast<const bf16*>(ptrs[2]), static_cast<const bf16*>(ptrs[3]),
      static_cast<bf16*>(const_cast<void*>(ptrs[4])),
      static_cast<bf16*>(const_cast<void*>(ptrs[5])),
      static_cast<bf16*>(const_cast<void*>(ptrs[6])), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], heads, n, scale);
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
  BwdMaps maps;
  for (int i = 0; i < 7 && err == cudaSuccess; ++i)
    err = scat_tma::encode_rows(&maps.op[i], ptrs[i], st[i].b, st[i].h,
                                st[i].n, batch, heads, n, kHeadDim,
                                i < 4 ? kMaxSeq : 16, kHeadDim,
                                &maps.row_dim[i]);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(kWgSmem));
  if (err != cudaSuccess) return err;
  attention_bwd_wgmma_kernel<<<int(wg_grid(pairs, sms)), kWgThreads, kWgSmem,
                               stream>>>(maps, heads, n, pairs, scale);
  return cudaSuccess;
}

// the kernel scat_attention_bwd launches for sequence length n and dtype:
// 0 the float32 CUDA-core kernel, 1 the per-head bf16 mma.sync kernel, 2
// the persistent bf16 wgmma kernel; -1 for what it does not take
int bwd_design(int n, int dtype) {
  if (n < 1 || n > kMaxSeq) return -1;
  if (dtype == 0) return 0;
  if (dtype == 1) return n >= kWgMinSeq ? 2 : 1;
  return -1;
}

}  // namespace

extern "C" {

// q, k, v, dout (read) and dq, dk, dv (written): [batch, heads, n, d]
// addressed through `strides`, 21 element strides (batch, head, row) of
// q, k, v, dout, dq, dk, dv in that order; the last dimension is
// contiguous.  dtype 0 = float32, 1 = bfloat16 (then every pointer 16-byte
// aligned and every stride a multiple of 8).  Launches on `stream`
// without synchronising and returns cudaGetLastError().
int scat_attention_bwd(const void* q, const void* k, const void* v,
                       const void* dout, void* dq, void* dk, void* dv,
                       int batch, int heads, int n, int d,
                       const long long* strides, float scale, int dtype,
                       void* stream) {
  if (d != kHeadDim || n < 1 || n > kMaxSeq || batch < 1 || heads < 1)
    return int(cudaErrorInvalidValue);
  Strides st[7];
  for (int i = 0; i < 7; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const long long grid = (long long)batch * heads;  // a block a pair
  if (grid > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(ptrs, int(grid), heads, n, st, scale, s);
  } else if (dtype == 1) {
    if (!rows_aligned(ptrs, st, 7)) return int(cudaErrorInvalidValue);
    if (bwd_design(n, dtype) == 2)
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

// the blocks of the kernel that scat_attention_bwd launches for sequence
// length n and `dtype` that one SM holds at once (the occupancy API), and
// the dynamic shared memory of each, in bytes; returns a cudaError_t
int scat_attention_bwd_occupancy(int n, int dtype, int* blocks,
                                  int* smem) {
  if (n < 1 || n > kMaxSeq) return int(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    *smem = int(f32_smem_bytes(n));
    err = occupancy(attention_bwd_f32_kernel, kF32Threads,
                    f32_smem_bytes(n), blocks);
  } else if (bwd_design(n, dtype) == 2) {
    *smem = int(kWgSmem);
    err = occupancy(attention_bwd_wgmma_kernel, kWgThreads, kWgSmem, blocks);
  } else if (dtype == 1) {
    err = with_tiles(n, [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      using T = BwdTiles<NT>;
      *smem = int(T::kSmem);
      return occupancy(attention_bwd_bf16_kernel<NT>, T::kThreads,
                       T::kSmem, blocks);
    });
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(err);
}

// the launch scat_attention_bwd makes for sequence length n, `dtype` and
// `pairs` = batch * heads on a card of `sms` SMs: *design as bwd_design
// gives it, *grid the blocks launched (one a pair, or the persistent
// grid); returns a cudaError_t
int scat_attention_bwd_plan(int n, int dtype, long long pairs, int sms,
                            int* design, long long* grid) {
  *design = bwd_design(n, dtype);
  if (*design < 0 || pairs < 1 || sms < 1) return int(cudaErrorInvalidValue);
  *grid = *design == 2 ? wg_grid(pairs, sms) : pairs;
  return int(cudaSuccess);
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
