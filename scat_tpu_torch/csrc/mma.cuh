// Tensor-core helpers shared by the kernels under csrc/: 16-byte cp.async
// copies into shared memory, ldmatrix loads of 8x8 bf16 tiles, the bf16
// mma.sync.m16n8k16 with float32 accumulation, the warpgroup's wgmma
// (m64n64k16 and m64n128k16, operands from registers or from shared
// memory, K-major or MN-major; sm_90a), the mbarriers of a producer /
// consumer ring, TMA copies and stores, and programmatic dependent launch.
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

// two floats (x0 the element of the lower column) as a high register of
// bf16 (round to nearest even) and a low register holding what the high
// part leaves, rounded to bf16: hi + lo carries each float to about 2^-17
// of its magnitude, so two bf16 products into one float32 accumulator do
// a float32 operand's product
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
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

// Warpgroup matrix multiply (sm_90a).  B is read by the tensor cores from
// shared memory through a descriptor, in the no-swizzle K-major layout: 8 x
// 8 core matrices of 128 contiguous bytes (8 rows of 16 bytes), the two
// core matrices of a 16-deep k-step 128 bytes apart (LBO), 8-row groups
// SBO bytes apart.  A comes from registers as the warps' mma A fragments
// (warp w of the warpgroup: rows 16w..16w+15), and the float32
// accumulator of a 64 x 64 tile is, per warp, 8 n-tiles of mma C
// fragments (32 registers).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's committed wgmma groups are in
// flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers an in-flight wgmma reads or writes: the compiler must neither
// reuse them nor read them early, so each is redefined after the wait
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// accumulators that a chain's first wgmma (accumulate 0) overwrites:
// defined for the compiler without an instruction
template <int N>
__device__ __forceinline__ void unset(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "=f"(r[i]));
}

// 2^x on the special-function unit (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d = (accumulate ? d : 0) + a b over the warpgroup's 64 x 64 x 16 tile
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d = (accumulate ? d : 0) + a b over the warpgroup's 64 x 128 x 16 tile,
// both operands read from shared memory through descriptors; TransA /
// TransB = 1 for an MN-major (transposed) operand
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss_64x128x16(float (&d)[64], uint64_t a,
                                                   uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TransA), "n"(TransB));
}

// the same over a 64 x 64 x 16 tile
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss_64x64x16(float (&d)[32], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TransA), "n"(TransB));
}

// wgmma_64x64x16 with B MN-major (transposed): A from registers as mma A
// fragments, B [k][n] stored with n contiguous
__device__ __forceinline__ void wgmma_64x64x16_bt(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the same over a 64 x 128 x 16 tile: A from registers, B MN-major (two
// 64-column atoms of n, LBO apart)
__device__ __forceinline__ void wgmma_64x128x16_bt(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Operands in shared memory for the descriptors above, no swizzle: an
// operand is cut into core matrices of 128 contiguous bytes, 8 rows of 16
// bytes.  K-major (the default): a core is 8 m (or n) rows x 8 k elements;
// MN-major (transposed): 8 k rows x 8 m (or n) elements.  Either way
// wgmma_desc's LBO is the byte stride between cores adjacent in k, its SBO
// the stride between cores adjacent in m (or n).

// the descriptor of an operand in the 128-byte swizzled layout (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 bytes whose 16-byte chunks are
// permuted by the row's index modulo 8, atoms of 8 rows (1024 bytes, their
// start 1024-byte aligned).  K-major: a k-step 32 bytes on within the row,
// SBO the stride between 8-row groups, LBO unused.  MN-major: SBO the
// stride between groups of 8 k rows, LBO between 64-element atoms of m
// (or n).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return wgmma_desc(p, lbo, sbo) | (uint64_t(1) << 62);
}

// ---------------------------------------------------------------------------
// Asynchronous copies and mbarriers

// writes made through the generic proxy (st.shared, cp.async) made
// visible to the async proxy (wgmma's shared-memory operands); the
// writing thread fences before the barrier that publishes them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialisation made visible before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive (release): what this thread wrote before is seen by a thread
// whose wait completes the phase
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
// (the bytes a TMA copy signalling this barrier will write)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// a TMA copy of one box of a 4-D tensor map at coordinates c0..c3
// (innermost first) into shared memory, completing on `bar`; the operands
// are read once, so their lines are the first the L2 evicts
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4, %5}], [%6], pol;\n}\n"
      ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// a TMA store of one box of a 4-D tensor map at coordinates c0..c3 from
// shared memory, in this thread's bulk async-group; what lies past the
// tensor's edges is not written
__device__ __forceinline__ void tma_store_4d(const void* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// how long a TMA load's lines should stay in the L2: read once (first
// evicted), read again by other blocks soon (the default), or read by
// every block (last evicted)
enum class L2Keep { kFirstOut, kNormal, kLastOut };

// a TMA copy of one box of a 2-D tensor map at (c0, c1) (innermost first)
// into shared memory, completing on `bar`
template <L2Keep Keep>
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  if constexpr (Keep == L2Keep::kNormal) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(smem_addr(bar))
        : "memory");
  } else if constexpr (Keep == L2Keep::kFirstOut) {
    asm volatile(
        "{\n.reg .b64 pol;\n"
        "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], "
        "pol;\n}\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(smem_addr(bar))
        : "memory");
  } else {
    asm volatile(
        "{\n.reg .b64 pol;\n"
        "createpolicy.fractional.L2::evict_last.b64 pol, 1.0;\n"
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], "
        "pol;\n}\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(smem_addr(bar))
        : "memory");
  }
}

// a TMA store of one box of a 2-D tensor map at (c0, c1) from shared
// memory, in this thread's bulk async-group; what lies past the tensor's
// edges is not written
__device__ __forceinline__ void tma_store_2d(const void* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

// programmatic dependent launch (sm_90): a primary grid lets the grid
// launched after it with programmatic stream serialisation start (its
// blocks may then run up to their wait), and that grid waits until the
// primary grid has completed and its writes are visible
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups are still reading
// shared memory (its source may be rewritten)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until at most N of this thread's bulk groups are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait (acquire) until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// element (n, k) of an [n][kdim] operand in the core layout above
__device__ __forceinline__ int core_at(int n, int k, int kdim) {
  return ((n >> 3) * (kdim >> 3) + (k >> 3)) * 64 + (n & 7) * 8 + (k & 7);
}

// the registers a thread of this warpgroup may hold from here on (every
// thread of the warpgroup executes it): a producer warpgroup gives its
// registers back, the consumer warpgroups take them
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// barrier `id` (1..15; 0 is __syncthreads') of one warpgroup's 128 threads
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// barrier `id` (1..15) of `threads` threads (whole warps), e.g. the
// consumer warpgroups of a warp-specialised block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace scat_mma
