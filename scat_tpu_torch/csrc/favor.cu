// FAVOR+ linear attention, stats and apply passes, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of scat_tpu/ops/pallas_favor.py,
// both launched by _favor_impl :105-147:
//   stats  _favor_stats_kernel :63-87 (call :128): over the T rows of one
//          (batch, head), ksum = sum_t phi(k_t) [m] and
//          kptv = sum_t phi(k_t) v_t^T [m, e];
//   apply  _favor_apply_kernel :90-102 (call :139): for each q row,
//          y = phi(q) kptv / (phi(q) . ksum);
// with phi(x) = exp(w x^T - |x|^2 / 2) * (1/sqrt(m)) (_prm :54-60) and w
// [m, e] the frozen Gaussian projection.  Float32 accuracy throughout (no
// fast-math, no TF32: the exp amplifies input rounding, which is why the
// JAX package runs these dots at Precision.HIGHEST) and no max-subtraction
// stabiliser, so that overflow and underflow behave as in the reference.
//
// Blocks run in parallel, so T cannot be accumulated across grid steps as
// on the TPU: the host splits T into as many tiles as filling the SMs
// needs (ops/favor.py t_tiles, from each kernel's chunk rows and
// residency), the stats blocks write per-tile partials, and a second
// launch (favor_reduce_kernel) sums them in tile order.  No float atomics,
// so two runs agree bit for bit.  With one tile the stats kernel writes its
// outputs directly.  Shapes: e <= 128, m <= 64 (ViP: 128 and 64); rows past
// T and columns past e or m are zero in shared memory and never stored.
//
// The stats pass on bf16 operands (ViP's bf16 serving and training):
// tensor cores by wgmma.  Its work is 4*m*e flops a row against 2*e bf16
// elements read, which at IEEE float32 on CUDA cores (67 TFLOP/s) bounds
// it at 0.597 ms for ViP training's [96,4,3137,128], three times its bytes
// (629,473,280 B: 0.188 ms at 3.35 TB/s).  The way past that floor is
// split precision: k and v are bf16 and exact; w and phi are each split
// into three bf16 parts, x_0 + x_1 + x_2 with x_i = bf16(x - sum_{j<i}
// x_j), which carry float32's 24 bits, and each product is a sum of three
// bf16 products accumulated in float32 ("bf16x3").  That is 3 * 4*m*e
// flops a row, 0.120 ms at 989 TFLOP/s, so the bytes bound the design.
// A first design on mma.sync (16 warps, every w, phi and v fragment
// through ldmatrix) took 0.58579 ms on an H100 80GB HBM3 at 700 W, at the
// float32-operation figure, not the byte bound.  Layout
// (favor_stats_wgmma_kernel), the apply's wgmma plan:
//   * one block of two warpgroups per (batch*head, T-tile), one block an SM
//     (225 KB of shared memory); w's three parts [3][64 features][128] are
//     split once per block into shared memory in wgmma's K-major core
//     layout (split_w_core, shared with the apply);
//   * each warpgroup takes 64-row slabs in turn (two buffers of its own):
//     one thread issues four TMA copies a slab (k and v, two 64-column
//     boxes each, tensor maps from the strided views, tma.cuh; rows past T
//     read as zeros) into the 128-byte swizzled layout, the next slab in
//     flight while one is computed; after the set-up the warpgroups never
//     wait for each other.  A cp.async version of the same ring left the
//     copies' latency exposed;
//   * features: |x|^2 from ldmatrix fragments of the slab; per k-step a
//     chain of three wgmma.m64n64k16 (x K-major from the slab, w's parts
//     smallest first) into a fresh accumulator, two alternating so one
//     chain runs while the other is added to wx in IEEE float32; phi =
//     exp(wx - |x|^2/2) / sqrt(m) in float32 registers; ksum += phi
//     (float32, unsplit); phi's three bf16 parts into the warpgroup's
//     [row][feature] buffer;
//   * outer product: one chain a slab, kptv_slab = sum_i phi_i^T v by
//     wgmma.m64n128k16 with phi^T an MN-major A and v an MN-major B, both
//     read by the tensor cores from shared memory (no ldmatrix, no B
//     fragment), added to the warpgroup's running [64 x 128] float32 kptv
//     in IEEE float32: the tensor cores accumulate in float32 but
//     truncate, so each chain spans one slab;
//   * the two warpgroups' partials (kptv through the freed ring) and the
//     warps' ksum partials are summed in a fixed order; with more than one
//     T-tile, favor_reduce_kernel sums the tiles in order.
// 235 registers a thread, no spills.  On an NVIDIA H100 80GB HBM3 at
// 700.00 W (chip_smoke.py, 20 calls in a CUDA graph): 0.36908 ms at
// [96,4,3137,128], 50.9% of the byte bound (the mma.sync design 0.58579).
// Against float64 (ViP-like operands, the stats alone) kptv is off by
// 1.1e-6 of its largest magnitude at that shape, against 2.8e-6 for the
// mma.sync design and 6.6e-6 for the float32 plain version.
// The stats pass on float32 operands keeps the CUDA-core design below
// (favor_stats_kernel): all-float32 k and v would need the split on both
// sides of every product, nine bf16 products for one.
//
// The apply pass on bf16 q (ViP's bf16 serving and training): tensor cores
// by wgmma.  A row costs 4*m*e flops against e bf16 elements read and e
// float32 written: at IEEE float32 on CUDA cores that bounds ViP
// training's [96,4,3137,128] at 0.601 ms, twice its bytes (937,852,928 B:
// 0.280 ms at 3.35 TB/s).  The split, as in the stats pass:
//   * features: q is bf16 and exact; w in three bf16 parts, three products
//     a k-step.  Two parts would not do: the exp turns an absolute error
//     in w.q into a relative error in phi, and at ViP's scale sum |w_i q_i|
//     is ~41 over e = 128, so 16-bit parts leave w.q off by up to ~3e-4,
//     above the 1e-4 rtol y is held to.  |q|^2/2, the exp and D = phi .
//     ksum are IEEE float32 on CUDA cores, D from the unsplit phi;
//   * contraction phi kptv: phi and kptv in three bf16 parts each, and of
//     the nine cross products phi_i kptv_j the six with i + j <= 2.  On the
//     CPU (bf16-valued ViP-like q, k, v at [8,3137,128], against float64)
//     six products are off by up to 5.6e-6, 0.35 of the tolerance; three
//     (two parts each, ~16 bits) by 6.2e-5, 1.6 times it; the float32
//     plain version by 1.0e-5, 0.6 of it.
// That is 9 * 2*m*e flops a row, 177.6 GFLOP at the training shape, 0.180
// ms at 989 TFLOP/s, so the bytes bound the design.  Both B operands, w's
// parts and kptv's, are the same for every row of a (batch, head).  A
// first design on mma.sync (a warp per 32 rows, each w and kptv fragment
// that ldmatrix loads serving two 16-row tiles) took 0.824 ms on an H100
// 80GB HBM3 at 700 W: the fragments, phi's parts and the accumulators held
// it at 255 registers with spills and two warps a scheduler.  wgmma reads B
// from shared memory itself, so a warp holds no B fragment and issues one
// instruction per 64 x 64 x 16 tile: 0.457 ms on the same card, 61% of the
// byte bound, off float64 by 4.3e-6.  Layout (favor_apply_bf16_kernel):
//   * one block of three warpgroups per (batch*head, T-tile), one block an
//     SM (177 KB of shared memory, 168 registers, no spills); w's parts
//     [3][64 features][128] (split_w_core) and kptv's parts transposed
//     [3][128 columns][64 features] are split once per block into shared
//     memory (96 KB) in wgmma's K-major no-swizzle layout of 8 x 8 core
//     matrices;
//   * each warpgroup takes 64-row slabs of q: 16-byte cp.async copies from
//     the strided view into its own slab buffer (plain loads where rows are
//     not 16-byte aligned or e % 8 != 0), the next slab in flight while one
//     is computed; after the set-up the warpgroups never wait for each
//     other;
//   * warp w of a group owns rows 16w..16w+15.  Features: the rows' A
//     fragments by ldmatrix (|q|^2 from the same registers), and per k-step
//     a chain of three wgmma.m64n64k16 against w's parts, smallest first,
//     into a fresh accumulator; two accumulators alternate, so one chain
//     runs while the other is added to wq in IEEE float32;
//   * phi's three bf16 parts go from the accumulator registers straight
//     into A fragments (feature n-tiles 2kk and 2kk+1 are k-step kk);
//   * contraction, 64 columns a pass: per k-step a chain of the six
//     products, smallest first, the two accumulators alternating as above;
//     y = acc / D through a per-warp staging tile and out in 16-byte
//     stores, 128 contiguous bytes a row, into y's [B,T,H,e] layout.
//
// The apply pass on float32 q, and the stats pass on float32 operands
// (float32 is the parity type): IEEE float32 FMAs on CUDA cores.  A row
// costs 2*m*e FMAs (m*e for its features, m*e
// for the outer product phi(k)^T v or for phi(q) kptv) against e elements
// read: at e = 128, m = 64 that is 128 flops per element, above the ~20
// flops per byte of float32 where the 67 TFLOP/s non-tensor-core rate,
// not the 3.35 TB/s memory, is the limit.  So the design feeds the FMA
// pipes from registers and shared memory:
//   * one block of 256 threads per (batch*head, T-tile), two an SM; w
//     [m][e] stays in shared memory for the block's life; rows are staged
//     32 at a time ([32][e] of k and v, or of q), converted to float32 on
//     load (bf16 operands convert exactly, as the caller's cast would);
//   * the features of a 32-row chunk are a [32 x e] x [e x m] product,
//     register-tiled 4 rows x 2 features a thread and laid out so that a
//     warp's float4 loads of w (row stride e+4 floats) are free of bank
//     conflicts and its loads of rows are broadcasts; |x|^2 is one warp
//     reduction per row;
//   * stats: each thread keeps a 4 x 8 tile of kptv (and 4 entries of ksum)
//     in registers across all of the block's rows;
//   * apply: each thread computes a 4-row x 4-column tile of phi(q) kptv,
//     divides it by D and stores it.
// phi never reaches device memory in any of the kernels.

#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace scat_mma;

constexpr int kE = 128;         // largest head dim, the padded column count
constexpr int kM = 64;          // largest feature count
constexpr int kRows = 32;       // rows staged per chunk
constexpr int kThreads = 256;   // 8 warps
constexpr int kXS = kE + 4;     // shared row stride of w, rows and kptv
constexpr int kPS = kM + 4;     // shared row stride of phi

// element strides of one [batch, heads, rows, e] operand; e is contiguous
struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dst [rows][kXS] <- src [rows][cols] (row-major, contiguous), zero-padded
// to [rows_pad][kE]
__device__ void load_matrix(float* dst, const float* __restrict__ src,
                            int rows, int cols, int rows_pad) {
  for (int i = threadIdx.x; i < rows_pad * kE; i += kThreads) {
    const int r = i / kE, c = i % kE;
    dst[r * kXS + c] = (r < rows && c < cols) ? src[r * cols + c] : 0.f;
  }
}

// the chunk of rows [row0, row0 + kRows) of one (batch, head): dst
// [kRows][kXS] float32; rows >= row_end and columns >= e are zero
__device__ void stage_rows(float* dst, const float* __restrict__ src,
                           long long row_stride, int row0, int row_end,
                           int e) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kRows * kE; i += kThreads) {
    const int r = i / kE, c = i % kE;
    const int row = row0 + r;
    float x = 0.f;
    if (row < row_end && c < e) x = src[row * row_stride + c];
    dst[r * kXS + c] = x;
  }
}

// sXd[r] = 0.5 * |x_r|^2 for the chunk; warp w takes rows 4w..4w+3
__device__ void half_sq_norms(const float* sX, float* sXd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kRows / 8; ++i) {
    const int r = warp * (kRows / 8) + i;
    const float4 x = ld4(sX + r * kXS + 4 * lane);
    float s = x.x * x.x;
    s = fmaf(x.y, x.y, s);
    s = fmaf(x.z, x.z, s);
    s = fmaf(x.w, x.w, s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sXd[r] = 0.5f * s;
  }
}

// sPhi [kRows][kPS] <- phi of the chunk's rows: expf(x_r . w_f - sXd[r]) *
// inv_sqrt_m for r < rows and f < m, zero elsewhere.  Warp w covers rows
// (w/4)*16 .. +15 and features (w%4)*16 .. +15; lane (ly, lx) = (lane/8,
// lane%8) takes rows r0 + 4i (i < 4) and features f0 + 8j (j < 2).
__device__ void features(const float* sX, const float* sW, const float* sXd,
                         float* sPhi, int rows, int m, float inv_sqrt_m) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp / 4) * 16 + lane / 8;
  const int f0 = (warp % 4) * 16 + lane % 8;
  float acc[4][2] = {};
#pragma unroll 4
  for (int c = 0; c < kE; c += 4) {
    float4 wv[2], xv[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) wv[j] = ld4(sW + (f0 + 8 * j) * kXS + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = ld4(sX + (r0 + 4 * i) * kXS + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float a = acc[i][j];
        a = fmaf(xv[i].x, wv[j].x, a);
        a = fmaf(xv[i].y, wv[j].y, a);
        a = fmaf(xv[i].z, wv[j].z, a);
        a = fmaf(xv[i].w, wv[j].w, a);
        acc[i][j] = a;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 4 * i, f = f0 + 8 * j;
      sPhi[r * kPS + f] = (r < rows && f < m)
                              ? expf(acc[i][j] - sXd[r]) * inv_sqrt_m
                              : 0.f;
    }
}

size_t stats_smem() {
  // sW [kM][kXS], sK and sV [kRows][kXS], sPhi [kRows][kPS], sXd [kRows]
  return sizeof(float) *
         (size_t(kM) * kXS + 2 * kRows * kXS + kRows * kPS + kRows);
}

size_t apply_smem() {
  // sW and sKV [kM][kXS], sKs [kM], sQ [kRows][kXS], sPhi [kRows][kPS],
  // sXd and sD [kRows]
  return sizeof(float) * (2 * size_t(kM) * kXS + kM + kRows * kXS +
                          kRows * kPS + 2 * kRows);
}

__global__ void __launch_bounds__(kThreads, 2)
favor_stats_kernel(const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ w, float* __restrict__ ksum,
                   float* __restrict__ kptv, float* __restrict__ work,
                   Strides sk, Strides sv, int heads, int t, int e, int m,
                   int tiles, int tile_rows, float inv_sqrt_m) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sK = sW + kM * kXS;
  float* sV = sK + kRows * kXS;
  float* sPhi = sV + kRows * kXS;
  float* sXd = sPhi + kRows * kPS;

  const int tile = blockIdx.x % tiles;
  const long long bh = blockIdx.x / tiles;
  const long long b = bh / heads, h = bh % heads;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int row_begin = tile * tile_rows;
  const int row_end = min(t, row_begin + tile_rows);

  load_matrix(sW, w, m, e, kM);

  // the outer-product tile of this thread: features fb..fb+3, columns
  // cb..cb+3 and cb+32..cb+35; (warp/4 == 0, lane%8 == 0) also own ksum
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int fb = (warp % 4) * 16 + (lane / 8) * 4;
  const int cb = (warp / 4) * 64 + (lane % 8) * 4;
  const bool owns_ksum = warp < 4 && lane % 8 == 0;
  float acc[4][8] = {};
  float ks[4] = {};

  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    __syncthreads();  // the previous chunk is consumed (and sW is loaded)
    stage_rows(sK, kb, sk.n, row0, row_end, e);
    stage_rows(sV, vb, sv.n, row0, row_end, e);
    __syncthreads();
    half_sq_norms(sK, sXd);
    __syncthreads();
    features(sK, sW, sXd, sPhi, row_end - row0, m, inv_sqrt_m);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      const float4 p = ld4(sPhi + r * kPS + fb);
      const float4 v0 = ld4(sV + r * kXS + cb);
      const float4 v1 = ld4(sV + r * kXS + cb + 32);
      const float pf[4] = {p.x, p.y, p.z, p.w};
      const float vc[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pf[i], vc[j], acc[i][j]);
        if (owns_ksum) ks[i] += pf[i];
      }
    }
  }

  float* dst_kv;
  float* dst_ks;
  if (work != nullptr) {
    dst_kv = work + (bh * tiles + tile) * (long long)(m * e + m);
    dst_ks = dst_kv + m * e;
  } else {
    dst_kv = kptv + bh * (long long)(m * e);
    dst_ks = ksum + bh * m;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = fb + i;
    if (f >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cb + (j < 4 ? j : 28 + j);
      if (c < e) dst_kv[f * e + c] = acc[i][j];
    }
    if (owns_ksum) dst_ks[f] = ks[i];
  }
}

// kptv and ksum of each (batch, head) as the sum of its tiles' partials,
// taken in tile order
__global__ void favor_reduce_kernel(const float* __restrict__ work,
                                    float* __restrict__ ksum,
                                    float* __restrict__ kptv, long long bhs,
                                    int tiles, int e, int m) {
  const long long part = (long long)m * e + m;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bhs * part) return;
  const long long bh = i / part, j = i % part;
  const float* src = work + bh * tiles * part + j;
  float s = 0.f;
  for (int tile = 0; tile < tiles; ++tile) s += src[tile * part];
  if (j < (long long)m * e)
    kptv[bh * m * e + j] = s;
  else
    ksum[bh * m + (j - (long long)m * e)] = s;
}

__global__ void __launch_bounds__(kThreads, 2)
favor_apply_kernel(const float* __restrict__ q, const float* __restrict__ w,
                   const float* __restrict__ ksum,
                   const float* __restrict__ kptv, float* __restrict__ y,
                   Strides sq, Strides sy, int heads, int t, int e, int m,
                   int tiles, int tile_rows, float inv_sqrt_m) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sKV = sW + kM * kXS;
  float* sKs = sKV + kM * kXS;
  float* sQ = sKs + kM;
  float* sPhi = sQ + kRows * kXS;
  float* sXd = sPhi + kRows * kPS;
  float* sD = sXd + kRows;

  const int tile = blockIdx.x % tiles;
  const long long bh = blockIdx.x / tiles;
  const long long b = bh / heads, h = bh % heads;
  const float* qb = q + b * sq.b + h * sq.h;
  float* yb = y + b * sy.b + h * sy.h;
  const int row_begin = tile * tile_rows;
  const int row_end = min(t, row_begin + tile_rows);

  load_matrix(sW, w, m, e, kM);
  load_matrix(sKV, kptv + bh * (long long)(m * e), m, e, kM);
  for (int f = threadIdx.x; f < kM; f += kThreads)
    sKs[f] = f < m ? ksum[bh * m + f] : 0.f;

  // this thread's output tile: rows r0 + 4i (i < 4), columns c0..c0+3
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp / 4) * 16 + lane / 8;
  const int c0 = (warp % 4) * 32 + (lane % 8) * 4;
  const bool vec = e % 4 == 0 && sy.n % 4 == 0 && sy.b % 4 == 0 &&
                   sy.h % 4 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0;

  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    __syncthreads();  // the previous chunk is stored (and w, kptv loaded)
    stage_rows(sQ, qb, sq.n, row0, row_end, e);
    __syncthreads();
    half_sq_norms(sQ, sXd);
    __syncthreads();
    features(sQ, sW, sXd, sPhi, row_end - row0, m, inv_sqrt_m);
    __syncthreads();
    // D_r = phi(q_r) . ksum; warp w takes rows 4w..4w+3
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i) {
      const int r = warp * (kRows / 8) + i;
      float s = sPhi[r * kPS + lane] * sKs[lane];
      s = fmaf(sPhi[r * kPS + lane + 32], sKs[lane + 32], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) sD[r] = s;
    }
    __syncthreads();

    float acc[4][4] = {};
#pragma unroll 2
    for (int f = 0; f < kM; f += 4) {
      float4 p[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ld4(sPhi + (r0 + 4 * i) * kPS + f);
#pragma unroll
      for (int s = 0; s < 4; ++s) kv[s] = ld4(sKV + (f + s) * kXS + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pf[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          acc[i][0] = fmaf(pf[s], kv[s].x, acc[i][0]);
          acc[i][1] = fmaf(pf[s], kv[s].y, acc[i][1]);
          acc[i][2] = fmaf(pf[s], kv[s].z, acc[i][2]);
          acc[i][3] = fmaf(pf[s], kv[s].w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * i;
      const int row = row0 + r;
      if (row >= row_end) continue;
      const float d = sD[r];
      float* out = yb + row * sy.n + c0;
      if (vec && c0 < e) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[i][0] / d, acc[i][1] / d, acc[i][2] / d,
                        acc[i][3] / d);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < e) out[j] = acc[i][j] / d;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// What the two bf16 kernels share: the bf16x3 split, the bf16 staging of
// rows, and w's three parts in wgmma's K-major core layout

constexpr int kParts = 3;       // bf16 parts of w, phi and kptv
constexpr int kXS16 = kE + 8;   // bf16 row stride of the apply's q slabs
constexpr uint32_t kCoreK = 128;              // bytes between k-cores
constexpr uint32_t kSboW = (kE / 8) * 128;    // between n-cores of [kM][kE]

// lo, hi as three registers of bf16 pairs whose sum is (lo, hi) to
// float32's precision: part i = bf16(x - parts 0..i-1); each difference is
// exact in float32
__device__ __forceinline__ void split3(float lo, float hi,
                                       uint32_t (&part)[kParts]) {
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    part[i] = *reinterpret_cast<const uint32_t*>(&p);
    lo -= __low2float(p);
    hi -= __high2float(p);
  }
}

// the two bf16 of a register as float32 (a bf16 is the top half of its
// float32)
__device__ __forceinline__ float lo_bf16(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// rows [row0, row0 + rows) of one bf16 operand (those < row_end) into dst
// [rows][kXS16], by thread `tid` of `nthreads`; other rows and columns >= e
// zero.  `vec`: every row 16-byte aligned and e % 8 == 0, so each
// 8-element group is one cp.async; otherwise plain loads.
__device__ __forceinline__ void stage_bf16_rows(bf16* dst,
                                                const bf16* __restrict__ src,
                                                long long row_stride,
                                                int row0, int rows,
                                                int row_end, int e, bool vec,
                                                int tid, int nthreads) {
  constexpr int kGroups = kE / 8;  // 16-byte groups a row
  for (int i = tid; i < rows * kGroups; i += nthreads) {
    const int r = i / kGroups, c = (i % kGroups) * 8;
    bf16* d = dst + r * kXS16 + c;
    const int row = row0 + r;
    if (row < row_end && c < e) {
      const bf16* from = src + row * row_stride + c;
      if (vec) {
        cp_async16(d, from);
      } else {
        uint32_t pair[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float lo =
              c + 2 * j < e ? __bfloat162float(from[2 * j]) : 0.f;
          const float hi =
              c + 2 * j + 1 < e ? __bfloat162float(from[2 * j + 1]) : 0.f;
          pair[j] = pack_bf16(lo, hi);  // exact: bf16 values
        }
        *reinterpret_cast<uint4*>(d) =
            make_uint4(pair[0], pair[1], pair[2], pair[3]);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// w's three bf16 parts into sW [3][kM n][kE k] in wgmma's K-major core
// layout (mma.cuh core_at), by thread `tid` of `nthreads`; features >= m
// and columns >= e zero
__device__ __forceinline__ void split_w_core(bf16* sW,
                                             const float* __restrict__ w,
                                             int e, int m, int tid,
                                             int nthreads) {
  for (int i = tid; i < kM * kE / 2; i += nthreads) {
    // w [f][c]: pairs along c
    const int f = i / (kE / 2), c = (i % (kE / 2)) * 2;
    const float lo = f < m && c < e ? w[f * e + c] : 0.f;
    const float hi = f < m && c + 1 < e ? w[f * e + c + 1] : 0.f;
    uint32_t part[kParts];
    split3(lo, hi, part);
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      *reinterpret_cast<uint32_t*>(sW + p * kM * kE + core_at(f, c, kE)) =
          part[p];
  }
}

// ---------------------------------------------------------------------------
// The stats pass on bf16 operands: bf16x3 split products on the tensor
// cores by wgmma (see the head of this file)

constexpr int kStGroups = 2;                  // warpgroups a block
constexpr int kStThreads = 128 * kStGroups;
constexpr int kStSlab = 64;                   // rows a warpgroup takes
constexpr int kStRows = kStGroups * kStSlab;  // rows a block takes at a time
constexpr int kStOperand = kStSlab * kE;      // a slab of k or of v
constexpr int kStPhi = kStSlab * kM;          // a slab's phi part
constexpr uint32_t kStSlabBytes = 2 * sizeof(bf16) * kStOperand;  // k and v
constexpr uint32_t kRowsPhi = (kM / 8) * 128;  // between row cores of phi
// a slab of k or v as TMA writes it: two column blocks of 64 (128-byte
// rows in the 128-byte swizzled layout, 8-row atoms of 1024 bytes)
constexpr uint32_t kAtom = 1024;
constexpr uint32_t kColBlock = kStSlab * 128;  // bytes of one column block

size_t tc_stats_smem() {
  // the ring, per warpgroup two buffers of a k and a v slab (1024-byte
  // aligned at run time: up to 1 KB of slack); w's parts [3][kM][kE] and
  // per warpgroup phi's parts [3][kStSlab][kM] in the core layout; a full
  // barrier a buffer
  return 1024 +
         sizeof(bf16) * (size_t(kStGroups) * 4 * kStOperand +
                         size_t(kParts) * kM * kE +
                         size_t(kStGroups) * kParts * kStPhi) +
         sizeof(uint64_t) * kStGroups * 2;
}

// the TMA maps of k and v; row_dim[i] is where operand i's row coordinate
// goes (scat_tma::encode_rows)
struct StMaps {
  CUtensorMap kv[2];
  int row_dim[2];
};

// slab rows [row0, row0 + kStSlab) of k and v of (b, h) into one ring
// buffer (k's two column blocks, then v's), completing on `bar`
__device__ __forceinline__ void load_slab(const StMaps& maps, uint8_t* dst,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
  mbar_arrive_expect_tx(bar, kStSlabBytes);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool rows_first = maps.row_dim[i] == 1;
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
      tma_load_4d(dst + (2 * i + cb) * kColBlock, &maps.kv[i], bar, 64 * cb,
                  rows_first ? row0 : h, rows_first ? h : row0, b);
  }
}

__global__ void __launch_bounds__(kStThreads, 1)
favor_stats_wgmma_kernel(const __grid_constant__ StMaps maps,
                         const float* __restrict__ w, float* __restrict__ ksum,
                         float* __restrict__ kptv, float* __restrict__ work,
                         int heads, int t, int e, int m, int tiles,
                         int tile_rows, float inv_sqrt_m) {
  extern __shared__ __align__(128) uint8_t smem_st[];
  uint8_t* sRing = smem_st + ((1024 - (smem_addr(smem_st) & 1023)) & 1023);
  bf16* sW = reinterpret_cast<bf16*>(sRing + kStGroups * 2 * kStSlabBytes);
  bf16* sPhi = sW + kParts * kM * kE;  // [group][part][slab], core layout
  uint64_t* full = reinterpret_cast<uint64_t*>(sPhi + kStGroups * kParts *
                                               kStPhi);  // [group][buffer]

  const int tile = blockIdx.x % tiles;
  const long long bh = blockIdx.x / tiles;
  const int b = int(bh / heads), h = int(bh % heads);
  const int row_begin = tile * tile_rows;
  const int row_end = min(t, row_begin + tile_rows);
  const int slabs = (row_end - row_begin + kStSlab - 1) / kStSlab;

  const int group = threadIdx.x / 128, gtid = threadIdx.x % 128;
  const int gw = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  uint8_t* ring = sRing + group * 2 * kStSlabBytes;
  uint64_t* gfull = full + 2 * group;
  bf16* phi = sPhi + group * kParts * kStPhi;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kStGroups; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // the group's first slab is in flight while w is split
  if (gtid == 0 && group < slabs)
    load_slab(maps, ring, &gfull[0], row_begin + group * kStSlab, h, b);
  split_w_core(sW, w, e, m, threadIdx.x, kStThreads);
  fence_proxy_async();  // w's parts, written by the threads, read by wgmma
  __syncthreads();      // the groups run apart until the end

  const int2 la = lane_a_rowmajor(lane);
  // kptv over the group's slabs (wgmma layout: features 16 gw + g and + 8,
  // columns 8j + 2 t4 and + 1 in kv[4j..4j+3]); ksum of features 8j + 2 t4
  // and + 1 in ks[2j], ks[2j + 1] over the thread's rows
  float kv[64], ks[2 * (kM / 8)];
#pragma unroll
  for (int i = 0; i < 64; ++i) kv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * (kM / 8); ++i) ks[i] = 0.f;

  int it = 0;
  for (int s = group; s < slabs; s += kStGroups, ++it) {
    const int row0 = row_begin + s * kStSlab;
    const uint8_t* sk_ = ring + (it & 1) * kStSlabBytes;
    const uint8_t* sv_ = sk_ + 2 * kColBlock;
    // the next slab into the other buffer, whose last readers (slab it -
    // 1's) finished before the barrier ending it - 1
    if (gtid == 0 && s + kStGroups < slabs)
      load_slab(maps, ring + ((it + 1) & 1) * kStSlabBytes,
                &gfull[(it + 1) & 1], row0 + kStRows, h, b);
    mbar_wait(&gfull[it & 1], (it >> 1) & 1);  // slab s has landed

    // |x|^2 of the warp's rows g and g + 8 from ldmatrix fragments of the
    // slab: row r's 16-byte chunk c of column block cb at cb kColBlock +
    // 128 r + 16 (c ^ r % 8)
    float sq2[2] = {0.f, 0.f};
#pragma unroll
    for (int ks8 = 0; ks8 < kE / 16; ++ks8) {
      const int r = 16 * gw + la.x, c = (2 * ks8 + la.y / 8) % 8;
      uint32_t xa[4];
      ldsm_x4(xa, sk_ + (ks8 / 4) * kColBlock + 128 * r + 16 * (c ^ (r % 8)));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x0 = lo_bf16(xa[j]), x1 = hi_bf16(xa[j]);
        sq2[j & 1] = fmaf(x1, x1, fmaf(x0, x0, sq2[j & 1]));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        sq2[i] += __shfl_xor_sync(0xffffffffu, sq2[i], off);

    // features wx = sum_p X w_p^T, X (A, K-major, swizzled) from the slab:
    // each k-step's three products (smallest part first) a chain of its
    // own, in one of two accumulators, added to wx on CUDA cores while the
    // next runs
    float wx[32], step[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) wx[i] = step[0][i] = step[1][i] = 0.f;
#pragma unroll
    for (int ks8 = 0; ks8 < kE / 16; ++ks8) {
      const uint64_t xd = wgmma_desc_sw128(
          sk_ + (ks8 / 4) * kColBlock + 32 * (ks8 % 4), 16, kAtom);
      wgmma_fence();
#pragma unroll
      for (int p = kParts - 1; p >= 0; --p)
        wgmma_ss_64x64x16<0, 0>(
            step[ks8 & 1], xd,
            wgmma_desc(sW + p * kM * kE + 128 * ks8, kCoreK, kSboW),
            p != kParts - 1);
      wgmma_commit();
      if (ks8 > 0) {
        wgmma_wait<1>();
        hold(step[(ks8 - 1) & 1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) wx[i] += step[(ks8 - 1) & 1][i];
      }
    }
    wgmma_wait<0>();
    hold(step[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) wx[i] += step[1][i];

    // phi = exp(wx - |x|^2/2) / sqrt(m) in IEEE float32; ksum += phi
    // unsplit; phi's three bf16 parts into the group's phi buffer
    // [row][feature] (core layout), the A operand phi^T of the outer
    // product read MN-major
    const int r0 = 16 * gw + g;
    const bool row_ok[2] = {row0 + r0 < row_end, row0 + r0 + 8 < row_end};
#pragma unroll
    for (int j = 0; j < kM / 8; ++j) {
      const int f = 8 * j + 2 * t4;
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = row_ok[i >> 1] && f + (i & 1) < m
                   ? expf(wx[4 * j + i] - 0.5f * sq2[i >> 1]) * inv_sqrt_m
                   : 0.f;
      ks[2 * j] += p[0] + p[2];
      ks[2 * j + 1] += p[1] + p[3];
      uint32_t lo[kParts], hi[kParts];
      split3(p[0], p[1], lo);
      split3(p[2], p[3], hi);
#pragma unroll
      for (int q = 0; q < kParts; ++q) {
        *reinterpret_cast<uint32_t*>(phi + q * kStPhi + core_at(r0, f, kM)) =
            lo[q];
        *reinterpret_cast<uint32_t*>(phi + q * kStPhi +
                                     core_at(r0 + 8, f, kM)) = hi[q];
      }
    }
    fence_proxy_async();
    group_sync(1 + group);  // every thread's phi parts are written

    // kptv += sum_p phi_p^T V over the slab: one chain of wgmma (A = phi_p^T
    // and B = V, both MN-major from shared memory, V swizzled; per k-step
    // of 16 rows the parts smallest first) in a fresh accumulator, added to
    // kv in IEEE float32 (the tensor cores' accumulation truncates)
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStSlab / 16; ++kk) {
      const uint64_t bd =
          wgmma_desc_sw128(sv_ + 2 * kAtom * kk, kColBlock, kAtom);
#pragma unroll
      for (int p = kParts - 1; p >= 0; --p)
        wgmma_ss_64x128x16<1, 1>(
            part,
            wgmma_desc(phi + p * kStPhi + kk * 16 * kM, kRowsPhi, kCoreK),
            bd, kk > 0 || p != kParts - 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) kv[i] += part[i];
    group_sync(1 + group);  // the slab's buffer and phi are free
  }

  __syncthreads();  // every group is done: the ring is free
  // ksum: over the warp's rows (the lanes of one t4), then the (group,
  // warp) partials in that order; group 1's kptv partial through the ring,
  // added to group 0's
  float* sKs = reinterpret_cast<float*>(sRing);  // [groups][4 warps][kM]
  float* other = sKs + kStGroups * 4 * kM;        // [64][128 threads]
#pragma unroll
  for (int i = 0; i < 2 * (kM / 8); ++i) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      ks[i] += __shfl_xor_sync(0xffffffffu, ks[i], off);
    if (g == 0)
      sKs[(group * 4 + gw) * kM + 8 * (i / 2) + 2 * t4 + (i & 1)] = ks[i];
  }
  if (group == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) other[i * 128 + gtid] = kv[i];
  }
  __syncthreads();

  float* dst_kv;
  float* dst_ks;
  if (work != nullptr) {
    dst_kv = work + (bh * tiles + tile) * (long long)(m * e + m);
    dst_ks = dst_kv + m * e;
  } else {
    dst_kv = kptv + bh * (long long)(m * e);
    dst_ks = ksum + bh * m;
  }
  for (int f = threadIdx.x; f < m; f += kStThreads) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kStGroups * 4; ++i) sum += sKs[i * kM + f];
    dst_ks[f] = sum;
  }
  if (group == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int f = 16 * gw + g + 8 * ((i >> 1) & 1);
      const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
      if (f < m && col < e)
        dst_kv[f * e + col] = kv[i] + other[i * 128 + gtid];
    }
  }
}

// ---------------------------------------------------------------------------
// The apply pass on bf16 q: bf16x3 split products on the tensor cores by
// wgmma (see the head of this file)

constexpr int kApGroups = 3;                  // warpgroups a block
constexpr int kApThreads = 128 * kApGroups;
constexpr int kApSlab = 64;                   // rows a warpgroup takes
constexpr int kApRows = kApGroups * kApSlab;  // rows a block takes at a time
constexpr int kApCols = 32;                   // y columns a staging pass
constexpr int kApYS = kApCols + 8;            // float row stride of staging
constexpr uint32_t kSboKV = (kM / 8) * 128;   // SBO of kptv's parts [kE][kM]

size_t tc_apply_smem() {
  // w parts [3][kM n][kE k] and kptv parts [3][kE n][kM k] in the core
  // layout, per-warpgroup q slabs [kApSlab][kXS16] (bf16); ksum [kM],
  // per-warp y staging [16][kApYS] (float)
  return sizeof(bf16) * (size_t(2) * kParts * kM * kE +
                         size_t(kApGroups) * kApSlab * kXS16) +
         sizeof(float) * (kM + size_t(kApGroups) * 4 * 16 * kApYS);
}

// rows row0..row0+15 (those < row_end) and columns col0..col0+31 (those <
// e) of y: a warp's accumulators acc[4j + i] (n-tile j: columns col0 + 8j
// ..+7) times the rows' 1/D, through the warp's staging tile, in 16-byte
// stores where `vec` (every y row 16-byte aligned, e % 4 == 0)
__device__ __forceinline__ void store_y(const float* acc,
                                        const float (&inv_d)[2],
                                        float* stage, float* yb,
                                        long long row_stride, int row0,
                                        int row_end, int col0, int e,
                                        bool vec, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < kApCols / 8; ++j) {
    *reinterpret_cast<float2*>(stage + g * kApYS + 8 * j + 2 * t4) =
        make_float2(acc[4 * j] * inv_d[0], acc[4 * j + 1] * inv_d[0]);
    *reinterpret_cast<float2*>(stage + (g + 8) * kApYS + 8 * j + 2 * t4) =
        make_float2(acc[4 * j + 2] * inv_d[1], acc[4 * j + 3] * inv_d[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (kApCols / 4); i += 32) {
    const int r = i / (kApCols / 4), c = (i % (kApCols / 4)) * 4;
    const int row = row0 + r, col = col0 + c;
    if (row >= row_end || col >= e) continue;
    const float4 x = *reinterpret_cast<const float4*>(stage + r * kApYS + c);
    float* out = yb + row * row_stride + col;
    if (vec) {
      *reinterpret_cast<float4*>(out) = x;
    } else {
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < e) out[j] = xs[j];
    }
  }
  __syncwarp();  // the staging tile is rewritten by the next store
}

__global__ void __launch_bounds__(kApThreads, 1)
favor_apply_bf16_kernel(const bf16* __restrict__ q,
                        const float* __restrict__ w,
                        const float* __restrict__ ksum,
                        const float* __restrict__ kptv, float* __restrict__ y,
                        Strides sq, Strides sy, int heads, int t, int e, int m,
                        int tiles, int tile_rows, float inv_sqrt_m,
                        bool vec) {
  extern __shared__ uint4 smem_ap[];
  bf16* sW = reinterpret_cast<bf16*>(smem_ap);  // [3][kM][kE], core layout
  bf16* sKV = sW + kParts * kM * kE;            // [3][kE][kM], core layout
  bf16* sQ = sKV + kParts * kE * kM;
  float* sKs = reinterpret_cast<float*>(sQ + kApGroups * kApSlab * kXS16);
  float* sY = sKs + kM;

  const int tile = blockIdx.x % tiles;
  const long long bh = blockIdx.x / tiles;
  const long long b = bh / heads, h = bh % heads;
  const bf16* qb = q + b * sq.b + h * sq.h;
  float* yb = y + b * sy.b + h * sy.h;
  const float* kv = kptv + bh * (long long)(m * e);
  const int row_begin = tile * tile_rows;
  const int row_end = min(t, row_begin + tile_rows);
  const int slabs = (row_end - row_begin + kApSlab - 1) / kApSlab;
  const bool vec_y = e % 4 == 0 && sy.b % 4 == 0 && sy.h % 4 == 0 &&
                     sy.n % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;

  const int group = threadIdx.x / 128, gtid = threadIdx.x % 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = 16 * (warp % 4);  // the warp's rows of its group's slab
  const int t4 = lane % 4;
  bf16* slab = sQ + group * kApSlab * kXS16;
  float* stage = sY + warp * 16 * kApYS;

  // the group's first slab is in flight while w and kptv are split
  if (group < slabs)
    stage_bf16_rows(slab, qb, sq.n, row_begin + group * kApSlab, kApSlab,
                    row_end, e, vec, gtid, 128);
  cp_async_commit();
  split_w_core(sW, w, e, m, threadIdx.x, kApThreads);
  for (int i = threadIdx.x; i < kM / 2 * kE; i += kApThreads) {
    // kptv [f][c] as B [c][f]: pairs along f
    const int c = i % kE, f = (i / kE) * 2;
    const float lo = f < m && c < e ? kv[f * e + c] : 0.f;
    const float hi = f + 1 < m && c < e ? kv[(f + 1) * e + c] : 0.f;
    uint32_t part[kParts];
    split3(lo, hi, part);
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      *reinterpret_cast<uint32_t*>(sKV + p * kE * kM + core_at(c, f, kM)) =
          part[p];
  }
  for (int f = threadIdx.x; f < kM; f += kApThreads)
    sKs[f] = f < m ? ksum[bh * m + f] : 0.f;
  // the parts, written by the threads, are read by the tensor cores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // the only block-wide barrier: the groups run apart

  const int2 la = lane_a_rowmajor(lane);

  for (int s = group; s < slabs; s += kApGroups) {
    const int row0 = row_begin + s * kApSlab;
    cp_async_wait<0>();
    group_sync(1 + group);  // the group's rows of slab s have landed

    // the warp's A fragments (k-step ks: columns 16ks..16ks+15) and |q|^2
    // of its rows g, g + 8
    uint32_t xa[kE / 16][4];
    float sq2[2] = {0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kE / 16; ++ks) {
      ldsm_x4(xa[ks], slab + (wrow + la.x) * kXS16 + 16 * ks + la.y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x0 = lo_bf16(xa[ks][j]), x1 = hi_bf16(xa[ks][j]);
        sq2[j & 1] = fmaf(x1, x1, fmaf(x0, x0, sq2[j & 1]));
      }
    }
    group_sync(1 + group);  // the slab is read: the next may land in it
    if (s + kApGroups < slabs)
      stage_bf16_rows(slab, qb, sq.n, row0 + kApGroups * kApSlab, kApSlab,
                      row_end, e, vec, gtid, 128);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        sq2[i] += __shfl_xor_sync(0xffffffffu, sq2[i], off);

    // features wq = sum_p Q w_p^T: each k-step's three products (smallest
    // part first) a chain of its own, in one of two accumulators, added to
    // wq on CUDA cores while the next chain runs
    float wq[32], step[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) wq[i] = step[0][i] = step[1][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kE / 16; ++ks) {
      wgmma_fence();
#pragma unroll
      for (int p = kParts - 1; p >= 0; --p)
        wgmma_64x64x16(step[ks & 1], xa[ks],
                       wgmma_desc(sW + p * kM * kE + 2 * ks * 64, kCoreK,
                                  kSboW),
                       p != kParts - 1);
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
        hold(step[(ks - 1) & 1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) wq[i] += step[(ks - 1) & 1][i];
      }
    }
    wgmma_wait<0>();
    hold(step[1]);
    hold(xa);
#pragma unroll
    for (int i = 0; i < 32; ++i) wq[i] += step[1][i];

    // phi = exp(wq - |q|^2/2) / sqrt(m) and D = phi . ksum in IEEE float32;
    // phi's three bf16 parts straight into A fragments: feature n-tiles
    // 2kk and 2kk+1 are k-step kk of the contraction
    uint32_t pa[kM / 16 * kParts][4];  // [k-step * kParts + part]
    float inv_d[2];
    {
      float d[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kM / 8; ++j) {
        const int f = 8 * j + 2 * t4;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = f + (i & 1) < m
                     ? expf(wq[4 * j + i] - 0.5f * sq2[i >> 1]) * inv_sqrt_m
                     : 0.f;
        const float2 kf = *reinterpret_cast<const float2*>(sKs + f);
        d[0] = fmaf(p[1], kf.y, fmaf(p[0], kf.x, d[0]));
        d[1] = fmaf(p[3], kf.y, fmaf(p[2], kf.x, d[1]));
        uint32_t lo[kParts], hi[kParts];
        split3(p[0], p[1], lo);
        split3(p[2], p[3], hi);
#pragma unroll
        for (int pi = 0; pi < kParts; ++pi) {
          pa[(j / 2) * kParts + pi][2 * (j & 1)] = lo[pi];
          pa[(j / 2) * kParts + pi][2 * (j & 1) + 1] = hi[pi];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          d[i] += __shfl_xor_sync(0xffffffffu, d[i], off);
        inv_d[i] = 1.f / d[i];
      }
    }

    // y = phi kptv / D, 64 columns a pass: per k-step a chain of the six
    // products phi_i kptv_j with i + j <= 2, smallest first, in one of two
    // accumulators, added on CUDA cores while the next chain runs
#pragma unroll
    for (int half = 0; half < kE / 64; ++half) {
      if (64 * half >= e) break;
      float ya[32], part[2][32];
#pragma unroll
      for (int i = 0; i < 32; ++i) ya[i] = part[0][i] = part[1][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk) {
        const bf16* base = sKV + half * 64 * kM + 2 * kk * 64;
        wgmma_fence();
        auto product = [&](int i, int j, int accumulate) {
          wgmma_64x64x16(part[kk & 1], pa[kk * kParts + i],
                         wgmma_desc(base + j * kE * kM, kCoreK, kSboKV),
                         accumulate);
        };
        product(0, 2, 0);
        product(1, 1, 1);
        product(2, 0, 1);
        product(0, 1, 1);
        product(1, 0, 1);
        product(0, 0, 1);
        wgmma_commit();
        if (kk > 0) {
          wgmma_wait<1>();
          hold(part[(kk - 1) & 1]);
#pragma unroll
          for (int i = 0; i < 32; ++i) ya[i] += part[(kk - 1) & 1][i];
        }
      }
      wgmma_wait<0>();
      hold(part[1]);
      hold(pa);
#pragma unroll
      for (int i = 0; i < 32; ++i) ya[i] += part[1][i];
#pragma unroll
      for (int piece = 0; piece < 64 / kApCols; ++piece)
        store_y(ya + kApCols / 2 * piece, inv_d, stage, yb, sy.n,
                row0 + wrow, row_end, 64 * half + kApCols * piece, e,
                vec_y, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// launches

// rows of each T-tile: whole chunks of `chunk` rows
int tile_rows_of(int t, int tiles, int chunk) {
  const int per = (t + tiles - 1) / tiles;
  return (per + chunk - 1) / chunk * chunk;
}

// the shapes the kernels take; tiles must be ops/favor.py t_tiles' count
// for the kernel's chunk rows
bool valid(int batch, int heads, int t, int e, int m, int tiles, int chunk) {
  if (batch < 1 || heads < 1 || t < 1 || e < 1 || e > kE || m < 1 ||
      m > kM || tiles < 1 || tiles > t)
    return false;
  const long long grid = (long long)batch * heads * tiles;
  const int rows = tile_rows_of(t, tiles, chunk);
  return grid <= 0x7fffffffLL && (t + rows - 1) / rows == tiles;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// the second launch of a split T: each (batch, head)'s tiles summed in
// order
cudaError_t reduce_tiles(const float* work, float* ksum, float* kptv,
                         long long bhs, int tiles, int e, int m,
                         cudaStream_t stream) {
  const long long n = bhs * ((long long)m * e + m);
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  favor_reduce_kernel<<<int(blocks), 256, 0, stream>>>(work, ksum, kptv,
                                                       bhs, tiles, e, m);
  return cudaGetLastError();
}

cudaError_t launch_stats_f32(const float* k, const float* v, const float* w,
                             float* ksum, float* kptv, float* work,
                             int batch, int heads, int t, int e, int m,
                             const Strides* st, int tiles, float inv_sqrt_m,
                             cudaStream_t stream) {
  cudaError_t err = set_smem(favor_stats_kernel, stats_smem());
  if (err != cudaSuccess) return err;
  const long long bhs = (long long)batch * heads;
  favor_stats_kernel<<<int(bhs * tiles), kThreads, stats_smem(), stream>>>(
      k, v, w, ksum, kptv, tiles > 1 ? work : nullptr, st[0], st[1], heads, t,
      e, m, tiles, tile_rows_of(t, tiles, kRows), inv_sqrt_m);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  return reduce_tiles(work, ksum, kptv, bhs, tiles, e, m, stream);
}

// rows of `count` bf16 operands that the cp.async staging takes: e % 8 ==
// 0 and every row 16-byte aligned (otherwise the kernels stage with plain
// loads)
bool rows_vec(const void* const* ptrs, const Strides* st, int count, int e) {
  bool vec = e % 8 == 0;
  for (int i = 0; i < count; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0 &&
          st[i].b % 8 == 0 && st[i].h % 8 == 0 && st[i].n % 8 == 0;
  return vec;
}

cudaError_t launch_stats_bf16(const bf16* k, const bf16* v, const float* w,
                              float* ksum, float* kptv, float* work,
                              int batch, int heads, int t, int e, int m,
                              const Strides* st, int tiles, float inv_sqrt_m,
                              cudaStream_t stream) {
  // the TMA copies need 16-byte aligned rows (the wrapper copies others)
  const void* ptrs[2] = {k, v};
  if (!rows_vec(ptrs, st, 2, 8)) return cudaErrorInvalidValue;
  StMaps maps;
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    err = scat_tma::encode_rows(&maps.kv[i], ptrs[i], st[i].b, st[i].h,
                                st[i].n, batch, heads, t, e, kStSlab, 64,
                                &maps.row_dim[i]);
  if (err == cudaSuccess)
    err = set_smem(favor_stats_wgmma_kernel, tc_stats_smem());
  if (err != cudaSuccess) return err;
  const long long bhs = (long long)batch * heads;
  favor_stats_wgmma_kernel<<<int(bhs * tiles), kStThreads, tc_stats_smem(),
                             stream>>>(
      maps, w, ksum, kptv, tiles > 1 ? work : nullptr, heads, t, e, m, tiles,
      tile_rows_of(t, tiles, kStRows), inv_sqrt_m);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  return reduce_tiles(work, ksum, kptv, bhs, tiles, e, m, stream);
}

cudaError_t launch_apply_f32(const float* q, const float* w,
                             const float* ksum, const float* kptv, float* y,
                             int batch, int heads, int t, int e, int m,
                             const Strides* st, int tiles, float inv_sqrt_m,
                             cudaStream_t stream) {
  cudaError_t err = set_smem(favor_apply_kernel, apply_smem());
  if (err != cudaSuccess) return err;
  favor_apply_kernel<<<int((long long)batch * heads * tiles), kThreads,
                       apply_smem(), stream>>>(
      q, w, ksum, kptv, y, st[0], st[1], heads, t, e, m, tiles,
      tile_rows_of(t, tiles, kRows), inv_sqrt_m);
  return cudaGetLastError();
}

cudaError_t launch_apply_bf16(const bf16* q, const float* w,
                              const float* ksum, const float* kptv, float* y,
                              int batch, int heads, int t, int e, int m,
                              const Strides* st, int tiles, float inv_sqrt_m,
                              cudaStream_t stream) {
  cudaError_t err = set_smem(favor_apply_bf16_kernel, tc_apply_smem());
  if (err != cudaSuccess) return err;
  const void* ptrs[1] = {q};
  favor_apply_bf16_kernel<<<int((long long)batch * heads * tiles),
                            kApThreads, tc_apply_smem(), stream>>>(
      q, w, ksum, kptv, y, st[0], st[1], heads, t, e, m, tiles,
      tile_rows_of(t, tiles, kApRows), inv_sqrt_m, rows_vec(ptrs, st, 1, e));
  return cudaGetLastError();
}

void read_strides(const long long* strides, Strides* st, int n) {
  for (int i = 0; i < n; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

extern "C" {

// k, v: [batch, heads, t, e] addressed through `strides` (6 element strides:
// batch, head, row of k, then of v; e is contiguous); w: float32 [m][e]
// contiguous; ksum [batch*heads][m] and kptv [batch*heads][m][e]: float32
// contiguous outputs; work: float32 [batch*heads][tiles][m*e + m] scratch
// when tiles > 1 (then a second launch sums the tiles), unused otherwise.
// dtype 0 = float32, 1 = bfloat16; tiles is t_tiles' count for the dtype's
// kernel (32-row chunks, two blocks an SM for float32; 64-row chunks, one
// block an SM for bfloat16).  Launches on `stream` without synchronising
// and returns cudaGetLastError().
int scat_favor_stats(const void* k, const void* v, const void* w, void* ksum,
                     void* kptv, void* work, int batch, int heads, int t,
                     int e, int m, const long long* strides, int tiles,
                     float inv_sqrt_m, int dtype, void* stream) {
  // the bf16 operands' kernel takes rounds of kStRows rows (a 64-row slab
  // for each of its two warpgroups), the float32 one 32-row chunks
  const int chunk = dtype == 1 ? kStRows : kRows;
  if (!valid(batch, heads, t, e, m, tiles, chunk) ||
      (tiles > 1 && work == nullptr))
    return int(cudaErrorInvalidValue);
  Strides st[2];
  read_strides(strides, st, 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* ks = static_cast<float*>(ksum);
  float* kv = static_cast<float*>(kptv);
  float* wk = static_cast<float*>(work);
  cudaError_t err;
  if (dtype == 0)
    err = launch_stats_f32(static_cast<const float*>(k),
                           static_cast<const float*>(v), wf, ks, kv, wk,
                           batch, heads, t, e, m, st, tiles, inv_sqrt_m, s);
  else if (dtype == 1)
    err = launch_stats_bf16(static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), wf, ks, kv, wk,
                            batch, heads, t, e, m, st, tiles, inv_sqrt_m, s);
  else
    return int(cudaErrorInvalidValue);
  return int(err);
}

// q: [batch, heads, t, e] and y (float32, the output): addressed through
// `strides` (6 element strides: batch, head, row of q, then of y); w, ksum,
// kptv: float32 contiguous as scat_favor_stats leaves them.  dtype is q's;
// tiles is t_tiles' count for its kernel (32-row chunks, two blocks an SM
// for float32; 192-row rounds, one block an SM for bfloat16).
int scat_favor_apply(const void* q, const void* w, const void* ksum,
                     const void* kptv, void* y, int batch, int heads, int t,
                     int e, int m, const long long* strides, int tiles,
                     float inv_sqrt_m, int dtype, void* stream) {
  // the bf16 q kernel takes rounds of kApRows rows, the float32 one 32
  const int chunk = dtype == 1 ? kApRows : kRows;
  if (!valid(batch, heads, t, e, m, tiles, chunk))
    return int(cudaErrorInvalidValue);
  Strides st[2];
  read_strides(strides, st, 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* ks = static_cast<const float*>(ksum);
  const float* kv = static_cast<const float*>(kptv);
  float* yf = static_cast<float*>(y);
  cudaError_t err;
  if (dtype == 0)
    err = launch_apply_f32(static_cast<const float*>(q), wf, ks, kv, yf,
                           batch, heads, t, e, m, st, tiles, inv_sqrt_m, s);
  else if (dtype == 1)
    err = launch_apply_bf16(static_cast<const bf16*>(q), wf, ks, kv, yf,
                            batch, heads, t, e, m, st, tiles, inv_sqrt_m, s);
  else
    return int(cudaErrorInvalidValue);
  return int(err);
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
