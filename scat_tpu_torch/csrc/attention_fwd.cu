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
// 4*B*H*N*D elements moved (Q, K, V read once, O written once): at N = 21
// that is ~21 flops per element, far below the ~295 flops per byte where
// the tensor cores become the limit.  8,257,536 bytes in bf16 at the
// flagship's train shape [96,8,21,64]: 2.465 us at 3.35 TB/s.  What bounded
// the first design, the CUDA-core one kept below for float32, was the
// count of instructions: one FMA per 4-byte shared-memory load, one query
// row per warp at a time, and a conversion per element staged.  So the
// bf16 kernel, the one the flagship's serving and training paths run, is
// the plan of attention_bwd.cu's bf16 kernel cut to the forward:
//   * one block per (batch, head) of NT = ceil(N/16) warps (2 at N = 21, 8
//     at N = 128); warp w owns query rows 16w..16w+15, so the 768 heads of
//     the training batch (18 KB of shared memory each at N = 21) are
//     resident in one wave;
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
// of one more mma.sync a k-step.  The bf16 result is held against the
// float32 plain version rounded to bf16, within 2 bf16 ulps.
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
  const long long grid = (long long)batch * heads;
  if (grid > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, o};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(ptrs, int(grid), heads, n, st, scale, s);
  } else if (dtype == 1) {
    if (!rows_aligned(ptrs, st, 4)) return int(cudaErrorInvalidValue);
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
