// Warp-level tensor-core helpers shared by the kernels under csrc/:
// 16-byte cp.async copies into shared memory, ldmatrix loads of 8x8 bf16
// tiles, and the bf16 mma.sync.m16n8k16 with float32 accumulation.
//
// Fragment layouts of mma.m16n8k16.row.col (lane = 4 * g + t):
//   A [16 x 16] row-major, 4 registers of two bf16 each:
//     a0 (row g,   cols 2t, 2t+1)   a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g,   cols 2t+8, +9)   a3 (row g+8, cols 2t+8, +9)
//   B [16 x 8] (k x n), 2 registers:
//     b0 (k 2t, 2t+1; col g)        b1 (k 2t+8, 2t+9; col g)
//   C, D [16 x 8] float32, 4 registers:
//     c0, c1 (row g, cols 2t, 2t+1) c2, c3 (row g+8, cols 2t, 2t+1)
// ldmatrix.x4 loads four 8x8 tiles; lanes 8i..8i+7 give the row addresses
// of tile i, and register i receives tile i: lane (g, t) gets row g,
// elements 2t and 2t+1 (with .trans, column g, rows 2t and 2t+1).  The
// lane_* helpers below give each lane its row and column for the four
// usual ways of cutting an operand into those tiles.

#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace scat_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one register of bf16 (round to nearest even); lo is the
// element of the lower column
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Row and column (in elements) that lane `lane` hands ldmatrix.x4 when a
// 16 x 16 tile at (r0, c0) of a row-major array is read as
//   a_rowmajor:  the A fragment of that tile (m = rows, k = columns);
//   b_nk:        B fragments, the array stored [n][k] (n = rows): registers
//                0-1 are b0, b1 of n rows r0..r0+7, registers 2-3 of
//                r0+8..r0+15 (non-transposed load);
//   b_kn:        B fragments, the array stored [k][n] (k = rows): registers
//                0-1 are b0, b1 of n columns c0..c0+7, registers 2-3 of
//                c0+8..c0+15 (transposed load);
//   a_km:        the A fragment of the transpose, the array stored [k][m]
//                (k = rows, m = columns; transposed load).
__device__ __forceinline__ int2 lane_a_rowmajor(int lane) {
  return make_int2(lane % 16, (lane / 16) * 8);
}
__device__ __forceinline__ int2 lane_b_nk(int lane) {
  return make_int2((lane % 8) + (lane / 16) * 8, ((lane / 8) % 2) * 8);
}
__device__ __forceinline__ int2 lane_b_kn(int lane) {
  return make_int2((lane % 8) + ((lane / 8) % 2) * 8, (lane / 16) * 8);
}
// (the same cut of the tile as b_nk: tiles 0-3 at (0,0), (0,8), (8,0),
// (8,8); read transposed they are a0-a3)
__device__ __forceinline__ int2 lane_a_km(int lane) {
  return lane_b_nk(lane);
}

}  // namespace scat_mma
