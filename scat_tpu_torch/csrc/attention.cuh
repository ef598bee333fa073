// What the bf16 attention kernels (attention_fwd.cu, attention_bwd.cu)
// share: the head dimension and sequence limit, the operands' strides,
// the tile sizes of a block of NT warps (one warp per 16 rows), the
// 16-byte cp.async staging of [N][D] rows, the per-warp staging tile
// through which a warp's [16 x D] accumulators leave in 16-byte stores,
// the alignment those copies need, and the dispatch on NT.

#pragma once

#include <stdint.h>

#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"
#include "tma.cuh"

namespace scat_attention {

using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 64;
constexpr int kMaxSeq = 128;
// bf16 N from here takes the persistent wgmma kernels, below it the
// per-head mma.sync ones
constexpr int kWgMinSeq = 65;
// shared row stride of D-wide bf16 rows: 144 bytes, so that the eight row
// addresses of an ldmatrix fall in distinct banks
constexpr int kRowS = kHeadDim + 8;

// element strides of one operand; the head dimension is contiguous
struct Strides {
  long long b, h, n;
};

// sizes of a per-head bf16 kernel with NT 16-row tiles (N <= 16 NT)
template <int NT>
struct Tiles {
  static constexpr int kNP = 16 * NT;  // padded sequence length
  static constexpr int kThreads = 32 * NT;
  // one staged operand [NP][kRowS], and the warps' staging tiles
  // [NT][16][kRowS]
  static constexpr size_t kOperandBytes = sizeof(bf16) * size_t(kNP) * kRowS;
  static constexpr size_t kStageBytes = sizeof(bf16) * size_t(NT) * 16 * kRowS;
};

// rows [0, n) of one [n][D] operand into dst [np][kRowS] by 16-byte
// cp.async copies; rows n..np-1 zero
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                            long long row_stride, int n,
                                            int np, int nthreads) {
  for (int i = threadIdx.x; i < np * (kHeadDim / 8); i += nthreads) {
    const int r = i / (kHeadDim / 8), c = (i % (kHeadDim / 8)) * 8;
    bf16* d = dst + r * kRowS + c;
    if (r < n)
      scat_mma::cp_async16(d, src + r * row_stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// a warp's [16 x D] float32 accumulators (n-tile j: columns 8j..8j+7) as
// bf16 rows row0..row0+15 (those < n) of dst, through the warp's staging
// tile, in 16-byte stores
__device__ __forceinline__ void store_rows(const float (&acc)[kHeadDim / 8][4],
                                           float scale, bf16* stage,
                                           bf16* dst, long long row_stride,
                                           int row0, int n, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * kRowS + 8 * j + 2 * t) =
        scat_mma::pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kRowS + 8 * j + 2 * t) =
        scat_mma::pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (kHeadDim / 8); i += 32) {
    const int r = i / (kHeadDim / 8), c = (i % (kHeadDim / 8)) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * kRowS + c);
  }
  __syncwarp();  // the staging tile is rewritten by the next store
}

// The persistent wgmma kernels' operands as TMA moves them: rows of
// kHeadDim bf16 (128 bytes) in the 128-byte swizzled layout, atoms of 8
// rows (1024 bytes, 1024-byte aligned)
constexpr uint32_t kRowBytes = 2 * kHeadDim;
constexpr uint32_t kAtom = 1024;

// operand i's whole box of (b, h) from its map into dst, completing on bar
template <int K>
__device__ __forceinline__ void load_box(void* dst,
                                         const scat_tma::Maps<K>& maps,
                                         int i, uint64_t* bar, int h, int b) {
  const bool rows_first = maps.row_dim[i] == 1;
  scat_mma::tma_load_4d(dst, &maps.op[i], bar, 0, rows_first ? 0 : h,
                        rows_first ? h : 0, b);
}

// a staged box into operand i's rows row0.. of (b, h) (rows past the
// tensor's edge are not written)
template <int K>
__device__ __forceinline__ void store_box(const scat_tma::Maps<K>& maps,
                                          int i, const void* src, int row0,
                                          int h, int b) {
  const bool rows_first = maps.row_dim[i] == 1;
  scat_mma::tma_store_4d(&maps.op[i], src, 0, rows_first ? row0 : h,
                         rows_first ? h : row0, b);
}

// a consumer warp's [16 x D] float32 wgmma accumulators (n-tile j in
// acc[4j..4j+3]) times `scale` as bf16 into its staging tile: 16 rows in
// the 128-byte swizzled layout, conflict-free
__device__ __forceinline__ void stage_tile(const float (&acc)[32],
                                           float scale, uint8_t* tile,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kHeadDim / 8; ++j) {
    const int at = 16 * (j ^ g) + 4 * t;  // rows g and g + 8 swizzle alike
    *reinterpret_cast<uint32_t*>(tile + g * kRowBytes + at) =
        scat_mma::pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(tile + (g + 8) * kRowBytes + at) =
        scat_mma::pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// the bf16 kernels' 16-byte copies and stores need every row of each of
// the `count` operands 16-byte aligned
inline bool rows_aligned(const void* const* ptrs, const Strides* st,
                         int count) {
  for (int i = 0; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0 || st[i].b % 8 != 0 ||
        st[i].h % 8 != 0 || st[i].n % 8 != 0)
      return false;
  return true;
}

// how many blocks of `kernel` (`threads` threads, `smem` bytes of dynamic
// shared memory) one SM holds at once, with the shared-memory limit raised
// as its launch raises it
template <typename K>
cudaError_t occupancy(K kernel, int threads, size_t smem, int* blocks) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, smem);
}

// f(std::integral_constant<int, NT>()) for the NT = ceil(n/16) warps of
// the per-head bf16 kernels, which take n < kWgMinSeq (above it the
// persistent wgmma kernels run)
template <typename F>
cudaError_t with_tiles(int n, F f) {
  switch ((n + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
  }
  return cudaErrorInvalidValue;
}

}  // namespace scat_attention
