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
// no copy.
//
// What bounds it on the H100: bytes, at the bound.  It reads Q, K, V, dO
// and writes dQ, dK, dV: 14,450,688 bytes in bf16 at the flagship's train
// shape [96,8,21,64], 4.31 us at 3.35 TB/s, against 10*N*N*D flops per
// (batch, head).  What bounded the first design (one CUDA-core FMA per
// 4-byte shared-memory load, and a second pass that recomputed S and dP)
// was the count of shared-memory instructions.  So the bf16 kernel, the
// one the canonical training path runs, does its five products on the
// tensor cores, where one mma.sync does 2,048 multiply-adds from fragments
// that one ldmatrix loads:
//   * one block per (batch, head) of NT = ceil(N/16) warps (2 at N = 21, 8
//     at N = 128): warp w owns query rows 16w..16w+15 in phase 1 and key
//     rows 16w..16w+15 in phase 2, so every warp does tensor-core work and
//     the 768 heads of the training batch (33 KB of shared memory each at
//     N = 21, six blocks an SM) are resident in one wave;
//   * Q, K, V and dO rows are copied into shared memory as bf16 in 16-byte
//     cp.async copies, all issued before any math; rows past N are zero.
//     Rows are padded by 16 bytes (144 B) so that the eight row addresses
//     of an ldmatrix fall in distinct banks;
//   * phase 1 (warp: 16 query rows against all keys): S and dP by
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate); keys >= N masked to
//     -inf as the TPU kernel does; row max, row sum, delta and dS in the
//     accumulator registers with quad shuffles.  P and dS are each split
//     into a bf16 high part and a bf16 low part, lo = bf16(x - float(hi))
//     (mma.cuh split_bf16), and the four are written to shared memory
//     ([NP][NP] each, NP = 16 NT); dQ = dS K takes dS's two parts straight
//     from the registers as A fragments;
//   * phase 2 (warp: 16 keys): dV = P^T dO and dK = dS^T Q, the
//     transposes by ldmatrix.trans.  The four bf16 tiles fit beside the
//     operands (226 KB of the 227 KB a block may have at N = 128, 33 KB at
//     N = 21), so there is no recompute pass;
//   * each output tile goes through a per-warp staging tile in shared
//     memory and leaves in 16-byte stores through the output strides.
// The Pallas backward keeps P and dS in float32 (pallas_attention.py:74-83).
// Q, K, dO are bf16 inputs, so they are exact, and hi + lo carries P and dS
// to about 2^-17 of their values: each of dV, dQ and dK runs the high
// and the low part's products into the same float32 accumulator, the
// Pallas kernel's float32 products at the cost of one more mma.sync per
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
// bfloat16: tensor cores

// the bf16 kernel with NT 16-row tiles: the shared row stride of P and
// dS, and its shared memory (Q, K, V, dO [NP][kRowS]; the high and low
// parts of P and dS [NP][kPS]; per-warp staging [16][kRowS])
template <int NT>
struct BwdTiles : Tiles<NT> {
  static constexpr int kPS = 16 * NT + 8;
  static constexpr size_t kSmem =
      4 * Tiles<NT>::kOperandBytes +
      sizeof(bf16) * size_t(4) * Tiles<NT>::kNP * kPS +
      Tiles<NT>::kStageBytes;
};
static_assert(BwdTiles<8>::kSmem <= 232448,
              "the N = 128 backward must fit a block's 227 KB");

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
  const long long grid = (long long)batch * heads;
  if (grid > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(ptrs, int(grid), heads, n, st, scale, s);
  } else if (dtype == 1) {
    if (!rows_aligned(ptrs, st, 7)) return int(cudaErrorInvalidValue);
    err = with_tiles(n, [&](auto nt) {
      return launch_bf16<decltype(nt)::value>(ptrs, int(grid), heads, n, st,
                                              scale, s);
    });
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
