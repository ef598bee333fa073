// Fused softmax attention backward for short sequences, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scat_tpu/ops/pallas_attention.py
// (_bwd_kernel :63-86, launched by _flash_bwd :136-161), the backward half
// of the _flash_core custom VJP.  Given Q, K, V and dO over [B,H,N,D]:
//   S = Q K^T * scale,  P = softmax(S)            (recomputed, f32)
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dP o P),  dS = P o (dP - delta)
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// P, dP and dS never reach device memory.
//
// Design: one block of 4 warps per (batch, head), as the forward
// (attention_fwd.cu).  Q, K, V and dO rows are read once from device memory,
// converted to f32 and staged in shared memory, every row padded to D+1
// floats so that lane j reading row j is free of bank conflicts.  Two
// passes over that staged block:
//   1. by query row i (warp i, i+4, ...): lane l holds keys l, l+32, l+64,
//      l+96; it computes s_ij and dp_ij, the row max, sum and delta_i are
//      warp shuffles, ds_ij goes to a per-warp row in shared memory and lane
//      c accumulates dQ_i columns c and c+32.  The row's max, 1/sum and
//      delta are kept in shared memory (3 floats a row);
//   2. by key row j (warp j, j+4, ...): lane l holds queries l, l+32, ...;
//      it recomputes s_ij and dp_ij by the dot products of pass 1, in the
//      same order, forms p_ij and ds_ij from
//      the stored row statistics, writes both columns to per-warp rows in
//      shared memory, and lane c accumulates dV_j and dK_j columns c, c+32.
// The recompute in pass 2 takes the place of an [N,N] P and dS in shared
// memory: at N = 128 those would add 128 KB in f32 to the 130 KB of the
// four staged operands, past the 227 KB a block can have.  As it is the
// kernel needs (4*N*(D+1) + 8*N + 3*N) floats: 138,752 bytes at N = 128
// (above 48 KB only after the cudaFuncSetAttribute opt-in), 22,764 at
// N = 21.  dQ, dK and dV are written once, in the input type.  No padding
// of N: rows and keys past N are never read.  Every operand is addressed
// through (batch, head, row) strides, so the projection's strided Q/K/V
// views and the dO that autograd delivers need no copy.
//
// What bounds it on the H100: bytes.  It reads Q, K, V, dO and writes dQ,
// dK, dV: 7*B*H*N*D elements, 14,450,688 bytes in bf16 at the flagship's
// train shape [96,8,21,64], 4.31 us at 3.35 TB/s.  Its work is 10*N*N*D
// flops per (batch, head) by the formulas above, ~30 per element moved at
// N = 21 (pass 2's recompute adds 4*N*N*D that the bound does not count),
// far below the ~295 flops per byte where the tensor cores become the
// limit.  So, as the forward, it spends nothing on tensor cores and keeps
// every [N,N] intermediate on chip.

#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = kMaxSeq / 32;
constexpr int kStride = kHeadDim + 1;

// element strides of one operand; the head dimension is contiguous
struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// a . b over the head dimension, in one fixed order
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int c = 0; c < kHeadDim; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

size_t smem_bytes(int n) {
  // sQ, sK, sV, sDO [n][D+1]; per-warp rows [4][n] for p and ds;
  // per-row max, 1/sum and delta [n] each
  return sizeof(float) *
         (size_t(4) * n * kStride + size_t(2) * kWarps * n + size_t(3) * n);
}

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row,
                                      int n) {
  for (int e = threadIdx.x; e < n * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim;
    const int c = e % kHeadDim;
    dst[r * kStride + c] = to_f32(src[r * row + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     T* __restrict__ dq, T* __restrict__ dk,
                     T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                     Strides sdo, Strides sdq, Strides sdk, Strides sdv,
                     int heads, int n, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + n * kStride;
  float* sV = sK + n * kStride;
  float* sDO = sV + n * kStride;
  float* sRowA = sDO + n * kStride;   // [kWarps][n]: p (pass 2)
  float* sRowB = sRowA + kWarps * n;  // [kWarps][n]: ds (passes 1 and 2)
  float* sMax = sRowB + kWarps * n;   // [n] row max of S
  float* sInv = sMax + n;             // [n] 1 / row sum of exp(S - max)
  float* sDelta = sInv + n;           // [n] rowsum(dP o P)

  const long long b = blockIdx.x / heads;
  const long long h = blockIdx.x % heads;
  stage(sQ, q + b * sq.b + h * sq.h, sq.n, n);
  stage(sK, k + b * sk.b + h * sk.h, sk.n, n);
  stage(sV, v + b * sv.b + h * sv.h, sv.n, n);
  stage(sDO, dout + b * sdo.b + h * sdo.h, sdo.n, n);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* row_a = sRowA + warp * n;
  float* row_b = sRowB + warp * n;

  // pass 1: query rows -> softmax statistics, delta, dQ
  T* dqb = dq + b * sdq.b + h * sdq.h;
  for (int i = warp; i < n; i += kWarps) {
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
    T* dqi = dqb + i * sdq.n;
    store(dqi + lane, acc0 * scale);
    store(dqi + lane + 32, acc1 * scale);
    __syncwarp();  // row_b is rewritten for the warp's next row
  }
  __syncthreads();  // every row's statistics are in shared memory

  // pass 2: key rows -> dV, dK
  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
  for (int j = warp; j < n; j += kWarps) {
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
    T* dvj = dvb + j * sdv.n;
    T* dkj = dkb + j * sdk.n;
    store(dvj + lane, v0);
    store(dvj + lane + 32, v1);
    store(dkj + lane, k0 * scale);
    store(dkj + lane + 32, k1 * scale);
    __syncwarp();  // row_a / row_b are rewritten for the warp's next key
  }
}

template <typename T>
cudaError_t launch(const void* const* ptrs, int grid, int heads, int n,
                   const Strides* st, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  attention_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<const T*>(ptrs[3]),
      static_cast<T*>(const_cast<void*>(ptrs[4])),
      static_cast<T*>(const_cast<void*>(ptrs[5])),
      static_cast<T*>(const_cast<void*>(ptrs[6])), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], heads, n, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// q, k, v, dout (read) and dq, dk, dv (written): [batch, heads, n, d]
// addressed through `strides`, 21 element strides (batch, head, row) of
// q, k, v, dout, dq, dk, dv in that order; the last dimension is
// contiguous.  dtype 0 = float32, 1 = bfloat16.  Launches on `stream`
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
  if (dtype == 0)
    err = launch<float>(ptrs, int(grid), heads, n, st, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(ptrs, int(grid), heads, n, st, scale, s);
  else
    return int(cudaErrorInvalidValue);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
