// Fused softmax attention forward for short sequences, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scat_tpu/ops/pallas_attention.py
// (_fwd_kernel :49-60, launched by _flash_fwd_impl :111-129):
//   O = softmax(Q K^T * scale) V      over [B,H,N,D], f32 accumulation.
//
// SCAT's sequences are tiny (21 joint tokens, or 128 feature tokens on the
// HRNet/Inception heads) with head dim 64, so one (batch, head) pair fits
// whole in shared memory and no streaming (online-softmax) decomposition is
// needed.  Design:
//   * one block of 4 warps per (batch, head);
//   * Q, K, V rows are read once from device memory, converted to f32 and
//     staged in shared memory (K rows padded to D+1 floats so that lane j
//     reading row j is free of bank conflicts);
//   * each warp takes query rows i = warp, warp+4, ...: lane l holds the
//     scores of keys l, l+32, l+64, l+96, the row max and sum are warp
//     shuffles, the normalised probabilities go to a per-warp row in shared
//     memory, and lane l accumulates output columns l and l+32 of P V;
//   * O is written once, in the input type.
// No padding of N is needed: keys past N are never read.  Q, K, V and O are
// addressed through (batch, head, row) strides, so the projection's
// [B,N,3,H,D] output can be passed as views without a copy.
//
// What bounds it on the H100: bytes.  The work is 4*B*H*N*N*D flops against
// 4*B*H*N*D elements moved (Q, K, V read once, O written once): at N=21 that
// is ~21 flops per element, far below the ~295 flops per byte where the
// tensor cores become the limit.  So the design spends nothing on tensor
// cores and keeps every intermediate (S, P) on chip; the one device-memory
// round trip per (batch, head) is the whole cost at the bound.

#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerLane = kMaxSeq / 32;
constexpr int kKStride = kHeadDim + 1;

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

size_t smem_bytes(int n) {
  // sQ [n][D], sK [n][D+1], sV [n][D], per-warp probability rows [4][n]
  return sizeof(float) *
         (size_t(n) * kHeadDim * 2 + size_t(n) * kKStride + kWarps * n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides sq,
                     Strides sk, Strides sv, Strides so, int heads, int n,
                     float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + n * kHeadDim;
  float* sV = sK + n * kKStride;
  float* sP = sV + n * kHeadDim;

  const long long b = blockIdx.x / heads;
  const long long h = blockIdx.x % heads;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int e = threadIdx.x; e < n * kHeadDim; e += kThreads) {
    const int r = e / kHeadDim;
    const int c = e % kHeadDim;
    sQ[r * kHeadDim + c] = to_f32(qb[r * sq.n + c]);
    sK[r * kKStride + c] = to_f32(kb[r * sk.n + c]);
    sV[r * kHeadDim + c] = to_f32(vb[r * sv.n + c]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p_row = sP + warp * n;
  for (int i = warp; i < n; i += kWarps) {
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
    T* oi = ob + i * so.n;
    store(oi + lane, acc0);
    store(oi + lane + 32, acc1);
    __syncwarp();  // p_row is rewritten for the warp's next row
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int grid, int heads, int n, const Strides* st,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], heads, n, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// q, k, v, o: [batch, heads, n, d] addressed through `strides`, 12 element
// strides (batch, head, row) of q, k, v and o in that order; the last
// dimension is contiguous.  dtype 0 = float32, 1 = bfloat16.  Launches on
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, o, int(grid), heads, n, st, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, o, int(grid), heads, n, st, scale, s);
  else
    return int(cudaErrorInvalidValue);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
