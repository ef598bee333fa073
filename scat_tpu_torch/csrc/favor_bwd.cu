// FAVOR+ linear attention, the backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's _favor_bwd
// (scat_tpu/ops/pallas_favor.py:168-172) is a vjp through plain jax ops,
// which the port first ran as autograd through favor_attention in float32.
// On ViP's training shape that recompute cast q, k and v to float32 and
// ran several dozen elementwise, cast and reduction passes over [B,H,T,e]
// and [B,H,T,m] float32 tensors a block, and float32 GEMMs on CUDA cores:
// it took most of a training step's device time.  These kernels compute
// the gradient in closed form instead, from the forward's saved ksum and
// kptv, in two passes over the rows.
//
// Notation per (batch, head) and row t, as in favor.cu: phi(x) = exp(w x -
// |x|^2 / 2) / sqrt(m), s = ksum [m], K = kptv [m, e], D_t = phi(q_t) . s,
// y_t = K^T phi(q_t) / D_t, g_t = dy_t.
//   q pass (favor_bwd_q_kernel, favor_bwd_q_bf16_kernel), per row:
//     a_t = K g_t,  gy_t = (phi(q_t) . a_t) / D_t,
//     dphi_t = (a_t - gy_t s) / D_t,  u_t = dphi_t * phi(q_t),
//     dq_t = w^T u_t - q_t sum_m u_t;
//   and over the rows dK = sum_t phi(q_t) g_t^T / D_t [m, e] and ds =
//   -sum_t phi(q_t) gy_t / D_t [m].  Blocks run in parallel, so with T split
//   into tiles each block writes per-tile partials and a second launch
//   (favor_bwd_reduce_kernel) sums them in tile order: no float atomics, two
//   runs agree bit for bit;
//   k, v pass (favor_bwd_kv_kernel, favor_bwd_kv_bf16_kernel), per row:
//     dphi_t = dK v_t + ds,  dv_t = dK^T phi(k_t),  u_t = dphi_t * phi(k_t),
//     dk_t = w^T u_t - k_t sum_m u_t.
// Float32 accuracy throughout, as the float32 recompute at HIGHEST had; no
// max-subtraction stabiliser, as the forward has none.
//
// What bounds it: a row reads q, k, v (bf16) and dy (float32) and writes
// dq, dk, dv (bf16), 16 bytes an element: 2.47 GB at ViP training's
// [96,4,3137,128], 0.74 ms at 3.35 TB/s.  Its arithmetic is eight products
// of 2 m e flops a row (two feature maps, K g, w^T u twice, phi g^T, dK v,
// dK^T phi): 158 GFLOP, 2.4 ms in IEEE float32 on CUDA cores (67 TFLOP/s),
// three times the byte bound.  So the bf16 design takes the tensor cores,
// as the forward's do, with float32 factors split into three bf16 parts
// (bf16x3, favor.cu): a product with an exact bf16 side (q, k or v against
// w's, K's or dK's parts) is three bf16 products; one of two float32 sides
// keeps the six of the nine cross products whose part indices sum to at
// most 2.  That is 39 bf16 products of 2 m e flops a row where float32
// needs 8: 0.78 ms at 989 TFLOP/s, about the byte bound, so a design near
// the tensor cores' rate is near the byte bound too.
//
// The bf16 kernels (two warpgroups a block, one block an SM; warpgroup g
// takes 64-row slabs g, g + 2, ... of its T-tile, warp w of a group rows
// 16w..16w+15 of a slab):
//   * w's parts and K's (q pass) or dK's (k, v pass) parts [3][64][128] are
//     split once a block into shared memory in wgmma's no-swizzle core
//     layout (favor.cu split_w_core).  The same bytes are the K-major B of
//     x w^T and g K^T (n = feature, k = column) and the MN-major B of u w
//     and phi dK (k = feature, n = column);
//   * each group stages its slabs of q and dy (k and v) into shared memory
//     by cp.async, the next slab in flight while one is computed (k in two
//     buffers; q's buffer then takes phi / D's parts); A operands are read
//     from the slabs into mma fragments, by ldmatrix for bf16 rows and as
//     float2 pairs split into three parts for dy; the corrections q sum(u)
//     and k sum(u) read the slabs too.  A first design read the fragments
//     from device memory straight into registers, a k-step at a time: 5.16
//     ms a block, most of it waiting on those loads;
//   * the feature maps: one chain of wgmma a k-step, two accumulators
//     alternating, added to the float32 sum on CUDA cores (the exp turns an
//     error in w x into a relative error in phi); a = K g: one chain a
//     k-step; the contractions over the 64 features (u w, phi dK): one
//     chain over the four k-steps, 64 columns a pass; phi, D, gy, u and
//     their row sums in IEEE float32 registers; u's and phi's three parts
//     go from the accumulator registers straight into A fragments (as
//     favor.cu's apply does);
//   * dK^T += g^T (phi / D) (q pass): A = dy's slab read transposed and
//     split, B = phi / D's three parts MN-major from shared memory, one
//     chain a 64-column tile added to the group's running [128 x 64]
//     float32 dK^T in registers; ds's partials in shared memory, a thread's
//     own; the two groups' partials summed in a fixed order at the end;
//   * dq, dk and dv leave as bf16 pairs, rounded once from float32.
// 231,680 bytes of shared memory a q-pass block, 203,008 a k, v-pass block;
// 255 registers a thread, a few dozen bytes spilled.  On an NVIDIA H100
// 80GB HBM3 at 700 W, at [96,4,3137,128], m 64, bf16 (CUDA events over 10
// calls): q pass 1.17-1.18 ms, k, v pass 1.27-1.29 ms, 2.44-2.47 ms in all,
// 30% of the byte bound, where autograd's float32 recompute took 24.4 ms.
// Against float64 at that shape dq, dk and dv lie within 3.8e-7 of their
// largest magnitude of float64 rounded to bf16 (half a bf16 ulp), and dK
// within 4.3e-7; the float32 plain version, rounded alike, within 2.5e-6
// (on the CPU, at [1,4,3137,128]).
//
// The float32 kernels (float32 operands, the parity type): IEEE float32
// FMAs on CUDA cores, the layout of favor.cu's float32 stats and apply
// kernels (256 threads, 32-row chunks staged in shared memory, register-
// tiled products).  Shapes: e <= 128, m <= 64 (ViP: 128 and 64); rows past
// T and columns past e or m are zero and never stored.

#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace scat_mma;

constexpr int kE = 128;  // largest head dim, the padded column count
constexpr int kM = 64;   // largest feature count

// element strides of one [batch, heads, rows, e] operand; e is contiguous
struct Strides {
  long long b, h, n;
};

// ---------------------------------------------------------------------------
// The float32 kernels (CUDA cores)

constexpr int kRows = 32;      // rows staged per chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kXS = kE + 4;    // shared row stride of w, K, dK and rows
constexpr int kPS = kM + 4;    // shared row stride of [row][feature] tiles

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// dst [rows_pad][kXS] <- src [rows][cols] (row-major, contiguous), zero
// elsewhere
__device__ void load_matrix(float* dst, const float* __restrict__ src,
                            int rows, int cols, int rows_pad) {
  for (int i = threadIdx.x; i < rows_pad * kE; i += kThreads) {
    const int r = i / kE, c = i % kE;
    dst[r * kXS + c] = (r < rows && c < cols) ? src[r * cols + c] : 0.f;
  }
}

// the chunk of rows [row0, row0 + kRows) of one (batch, head): dst
// [kRows][kXS]; rows >= row_end and columns >= e are zero
__device__ void stage_rows(float* dst, const float* __restrict__ src,
                           long long row_stride, int row0, int row_end,
                           int e) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kRows * kE; i += kThreads) {
    const int r = i / kE, c = i % kE;
    const int row = row0 + r;
    dst[r * kXS + c] =
        (row < row_end && c < e) ? src[row * row_stride + c] : 0.f;
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
    s = warp_sum(s);
    if (lane == 0) sXd[r] = 0.5f * s;
  }
}

// sOut [kRows][kPS] <- x_r . b_f for r < rows and f < m (B [kM][kXS]),
// zero elsewhere; with kExp, phi: expf(x_r . w_f - sXd[r]) * inv_sqrt_m.
// Warp w covers rows (w/4)*16 .. +15 and features (w%4)*16 .. +15; lane
// (lane/8, lane%8) takes rows r0 + 4i (i < 4) and features f0 + 8j (j < 2)
template <bool kExp>
__device__ void rows_by_features(const float* sX, const float* sB,
                                 const float* sXd, float* sOut, int rows,
                                 int m, float inv_sqrt_m) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp / 4) * 16 + lane / 8;
  const int f0 = (warp % 4) * 16 + lane % 8;
  float acc[4][2] = {};
#pragma unroll 4
  for (int c = 0; c < kE; c += 4) {
    float4 bv[2], xv[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) bv[j] = ld4(sB + (f0 + 8 * j) * kXS + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = ld4(sX + (r0 + 4 * i) * kXS + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float a = acc[i][j];
        a = fmaf(xv[i].x, bv[j].x, a);
        a = fmaf(xv[i].y, bv[j].y, a);
        a = fmaf(xv[i].z, bv[j].z, a);
        a = fmaf(xv[i].w, bv[j].w, a);
        acc[i][j] = a;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = r0 + 4 * i, f = f0 + 8 * j;
      float x = 0.f;
      if (r < rows && f < m)
        x = kExp ? expf(acc[i][j] - sXd[r]) * inv_sqrt_m : acc[i][j];
      sOut[r * kPS + f] = x;
    }
}

// acc[i][j] = sum_f sA[r0 + 4i][f] sB[f][c0 + j] over the kM features (A
// [kRows][kPS], B [kM][kXS]); the thread's tile of favor.cu's apply
__device__ __forceinline__ void contract(const float* sA, const float* sB,
                                         int r0, int c0, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int f = 0; f < kM; f += 4) {
    float4 p[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ld4(sA + (r0 + 4 * i) * kPS + f);
#pragma unroll
    for (int s = 0; s < 4; ++s) b[s] = ld4(sB + (f + s) * kXS + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pf[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        acc[i][0] = fmaf(pf[s], b[s].x, acc[i][0]);
        acc[i][1] = fmaf(pf[s], b[s].y, acc[i][1]);
        acc[i][2] = fmaf(pf[s], b[s].z, acc[i][2]);
        acc[i][3] = fmaf(pf[s], b[s].w, acc[i][3]);
      }
    }
  }
}

// row `r` of the chunk, columns c0..c0+3 (< e): out = acc - x * scale,
// x the staged row (sX [kRows][kXS]) or no correction where sX is null
__device__ __forceinline__ void store_row4(float* out, const float (&acc)[4],
                                           const float* sXr, float scale,
                                           int c0, int e, bool vec) {
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = sXr ? fmaf(-sXr[c0 + j], scale, acc[j]) : acc[j];
  if (vec && c0 + 3 < e) {
    *reinterpret_cast<float4*>(out + c0) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < e) out[c0 + j] = o[j];
  }
}

size_t bwd_q_smem() {
  // sW and sK [kM][kXS], sQ and sG [kRows][kXS], sPhi, sU and sP
  // [kRows][kPS], sKs [kM], sXd, sUs and sGy [kRows]
  return sizeof(float) * (2 * size_t(kM) * kXS + 2 * kRows * kXS +
                          3 * kRows * kPS + kM + 3 * kRows);
}

size_t bwd_kv_smem() {
  // sW and sDK [kM][kXS], sK and sV [kRows][kXS], sPhi and sU
  // [kRows][kPS], sDs [kM], sXd and sUs [kRows]
  return sizeof(float) * (2 * size_t(kM) * kXS + 2 * kRows * kXS +
                          2 * kRows * kPS + kM + 2 * kRows);
}

__global__ void __launch_bounds__(kThreads, 1)
favor_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ dy,
                   const float* __restrict__ w, const float* __restrict__ ksum,
                   const float* __restrict__ kptv, float* __restrict__ dq,
                   float* __restrict__ dkptv, float* __restrict__ dksum,
                   float* __restrict__ work, Strides sq, Strides sg,
                   Strides sdq, int heads, int t, int e, int m, int tiles,
                   int tile_rows, float inv_sqrt_m, bool vec_out) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sK = sW + kM * kXS;
  float* sQ = sK + kM * kXS;
  float* sG = sQ + kRows * kXS;
  float* sPhi = sG + kRows * kXS;
  float* sU = sPhi + kRows * kPS;
  float* sP = sU + kRows * kPS;
  float* sKs = sP + kRows * kPS;
  float* sXd = sKs + kM;
  float* sUs = sXd + kRows;
  float* sGy = sUs + kRows;

  const int tile = blockIdx.x % tiles;
  const long long bh = blockIdx.x / tiles;
  const long long b = bh / heads, h = bh % heads;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* gb = dy + b * sg.b + h * sg.h;
  float* dqb = dq + b * sdq.b + h * sdq.h;
  const int row_begin = tile * tile_rows;
  const int row_end = min(t, row_begin + tile_rows);

  load_matrix(sW, w, m, e, kM);
  load_matrix(sK, kptv + bh * (long long)(m * e), m, e, kM);
  for (int f = threadIdx.x; f < kM; f += kThreads)
    sKs[f] = f < m ? ksum[bh * m + f] : 0.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the dK tile of this thread (favor.cu's stats tile): features fb..fb+3,
  // columns cb..cb+3 and cb+32..cb+35; (warp < 4, lane%8 == 0) own ds
  const int fb = (warp % 4) * 16 + (lane / 8) * 4;
  const int cb = (warp / 4) * 64 + (lane % 8) * 4;
  const bool owns_ds = warp < 4 && lane % 8 == 0;
  // the dq tile of this thread (favor.cu's apply tile)
  const int r0 = (warp / 4) * 16 + lane / 8;
  const int c0 = (warp % 4) * 32 + (lane % 8) * 4;
  float acc[4][8] = {};
  float ds[4] = {};

  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    const int rows = row_end - row0;
    __syncthreads();  // the previous chunk is consumed (and sW is loaded)
    stage_rows(sQ, qb, sq.n, row0, row_end, e);
    stage_rows(sG, gb, sg.n, row0, row_end, e);
    __syncthreads();
    half_sq_norms(sQ, sXd);
    __syncthreads();
    rows_by_features<true>(sQ, sW, sXd, sPhi, rows, m, inv_sqrt_m);
    rows_by_features<false>(sG, sK, sXd, sU, rows, m, 0.f);  // a = K g
    __syncthreads();
    // per row (warp w: rows 4w..4w+3; lane: features lane, lane + 32):
    // D, gy, u (over a in sU), its sum, and phi / D
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i) {
      const int r = warp * (kRows / 8) + i;
      const float p0 = sPhi[r * kPS + lane], p1 = sPhi[r * kPS + lane + 32];
      const float a0 = sU[r * kPS + lane], a1 = sU[r * kPS + lane + 32];
      const float s0 = sKs[lane], s1 = sKs[lane + 32];
      const float d = warp_sum(fmaf(p1, s1, p0 * s0));
      const float pa = warp_sum(fmaf(p1, a1, p0 * a0));
      const float inv_d = r < rows ? 1.f / d : 0.f;
      const float gy = pa * inv_d;
      const float u0 = (a0 - gy * s0) * inv_d * p0;
      const float u1 = (a1 - gy * s1) * inv_d * p1;
      const float us = warp_sum(u0 + u1);
      sU[r * kPS + lane] = u0;
      sU[r * kPS + lane + 32] = u1;
      sP[r * kPS + lane] = p0 * inv_d;
      sP[r * kPS + lane + 32] = p1 * inv_d;
      if (lane == 0) {
        sUs[r] = us;
        sGy[r] = gy;
      }
    }
    __syncthreads();
    // dq = u w - q sum(u)
    {
      float o[4][4];
      contract(sU, sW, r0, c0, o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 4 * i;
        if (r < rows)
          store_row4(dqb + (row0 + r) * sdq.n, o[i], sQ + r * kXS, sUs[r], c0,
                     e, vec_out);
      }
    }
    // dK += (phi / D)^T g and ds -= (phi / D) gy over the chunk's rows
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      const float4 p = ld4(sP + r * kPS + fb);
      const float4 g0 = ld4(sG + r * kXS + cb);
      const float4 g1 = ld4(sG + r * kXS + cb + 32);
      const float gy = sGy[r];
      const float pf[4] = {p.x, p.y, p.z, p.w};
      const float gc[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pf[i], gc[j], acc[i][j]);
        if (owns_ds) ds[i] = fmaf(-pf[i], gy, ds[i]);
      }
    }
  }

  float* dst_kv;
  float* dst_ds;
  if (work != nullptr) {
    dst_kv = work + (bh * tiles + tile) * (long long)(m * e + m);
    dst_ds = dst_kv + m * e;
  } else {
    dst_kv = dkptv + bh * (long long)(m * e);
    dst_ds = dksum + bh * m;
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
    if (owns_ds) dst_ds[f] = ds[i];
  }
}

// dK and ds of each (batch, head) as the sum of its tiles' partials, taken
// in tile order
__global__ void favor_bwd_reduce_kernel(const float* __restrict__ work,
                                        float* __restrict__ dksum,
                                        float* __restrict__ dkptv,
                                        long long bhs, int tiles, int e,
                                        int m) {
  const long long part = (long long)m * e + m;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bhs * part) return;
  const long long bh = i / part, j = i % part;
  const float* src = work + bh * tiles * part + j;
  float s = 0.f;
  for (int tile = 0; tile < tiles; ++tile) s += src[tile * part];
  if (j < (long long)m * e)
    dkptv[bh * m * e + j] = s;
  else
    dksum[bh * m + (j - (long long)m * e)] = s;
}

__global__ void __launch_bounds__(kThreads, 1)
favor_bwd_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ w,
                    const float* __restrict__ dkptv,
                    const float* __restrict__ dksum, float* __restrict__ dk,
                    float* __restrict__ dv, Strides sk, Strides sv,
                    Strides sdk, Strides sdv, int heads, int t, int e, int m,
                    int tiles, int tile_rows, float inv_sqrt_m,
                    bool vec_out) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sDK = sW + kM * kXS;
  float* sK = sDK + kM * kXS;
  float* sV = sK + kRows * kXS;
  float* sPhi = sV + kRows * kXS;
  float* sU = sPhi + kRows * kPS;
  float* sDs = sU + kRows * kPS;
  float* sXd = sDs + kM;
  float* sUs = sXd + kRows;

  const int tile = blockIdx.x % tiles;
  const long long bh = blockIdx.x / tiles;
  const long long b = bh / heads, h = bh % heads;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* dkb = dk + b * sdk.b + h * sdk.h;
  float* dvb = dv + b * sdv.b + h * sdv.h;
  const int row_begin = tile * tile_rows;
  const int row_end = min(t, row_begin + tile_rows);

  load_matrix(sW, w, m, e, kM);
  load_matrix(sDK, dkptv + bh * (long long)(m * e), m, e, kM);
  for (int f = threadIdx.x; f < kM; f += kThreads)
    sDs[f] = f < m ? dksum[bh * m + f] : 0.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp / 4) * 16 + lane / 8;
  const int c0 = (warp % 4) * 32 + (lane % 8) * 4;

  for (int row0 = row_begin; row0 < row_end; row0 += kRows) {
    const int rows = row_end - row0;
    __syncthreads();  // the previous chunk is stored (and w, dK loaded)
    stage_rows(sK, kb, sk.n, row0, row_end, e);
    stage_rows(sV, vb, sv.n, row0, row_end, e);
    __syncthreads();
    half_sq_norms(sK, sXd);
    __syncthreads();
    rows_by_features<true>(sK, sW, sXd, sPhi, rows, m, inv_sqrt_m);
    rows_by_features<false>(sV, sDK, sXd, sU, rows, m, 0.f);  // dK v
    __syncthreads();
    // u = (dK v + ds) * phi and its sum, per row
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i) {
      const int r = warp * (kRows / 8) + i;
      const float u0 = (sU[r * kPS + lane] + sDs[lane]) * sPhi[r * kPS + lane];
      const float u1 =
          (sU[r * kPS + lane + 32] + sDs[lane + 32]) * sPhi[r * kPS + lane + 32];
      const float us = warp_sum(u0 + u1);
      sU[r * kPS + lane] = u0;
      sU[r * kPS + lane + 32] = u1;
      if (lane == 0) sUs[r] = us;
    }
    __syncthreads();
    float o[4][4];
    contract(sPhi, sDK, r0, c0, o);  // dv = phi dK
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * i;
      if (r < rows)
        store_row4(dvb + (row0 + r) * sdv.n, o[i], nullptr, 0.f, c0, e,
                   vec_out);
    }
    contract(sU, sW, r0, c0, o);  // dk = u w - k sum(u)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * i;
      if (r < rows)
        store_row4(dkb + (row0 + r) * sdk.n, o[i], sK + r * kXS, sUs[r], c0,
                   e, vec_out);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernels: bf16x3 split products on the tensor cores by wgmma (see
// the head of this file)

constexpr int kParts = 3;                     // bf16 parts of a float32
constexpr int kBwGroups = 2;                  // warpgroups a block
constexpr int kBwThreads = 128 * kBwGroups;
constexpr int kBwSlab = 64;                   // rows a warpgroup takes
constexpr int kBwRows = kBwGroups * kBwSlab;  // rows a block takes at a time
constexpr int kHalf = 64;                     // columns a dq/dk/dv pass
constexpr int kPart = kM * kE;                // one part of w, K or dK
constexpr int kSlabPart = kBwSlab * kM;       // one part of phi / D
constexpr uint32_t kCoreK = 128;              // bytes between k-cores
constexpr uint32_t kSboW = (kE / 8) * 128;    // between 8-feature groups
constexpr uint32_t kRows64 = (64 / 8) * 128;  // between 8-row groups
constexpr int kXS16 = kE + 8;  // bf16 row stride of the staged q, k, v slabs
constexpr int kGS = kE + 4;    // float row stride of the staged dy slab
// a q-pass warpgroup's region: its q slab, then phi / D's three parts
constexpr size_t kQRegion = sizeof(bf16) * (kParts * kSlabPart);
static_assert(kQRegion >= sizeof(bf16) * kBwSlab * kXS16,
              "the q slab fits the region phi / D's parts take after it");

// lo, hi as three registers of bf16 pairs whose sum is (lo, hi) to
// float32's precision: part i = bf16(x - parts 0..i-1); each difference is
// exact in float32 (favor.cu)
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

__device__ __forceinline__ float lo_bf16(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// the float32 [m][e] matrix src's three bf16 parts into dst [3][kM][kE] in
// wgmma's core layout (mma.cuh core_at), by thread `tid` of `nthreads`;
// features >= m and columns >= e zero (favor.cu split_w_core)
__device__ __forceinline__ void split_core(bf16* dst,
                                           const float* __restrict__ src,
                                           int e, int m, int tid,
                                           int nthreads) {
  for (int i = tid; i < kM * kE / 2; i += nthreads) {
    const int f = i / (kE / 2), c = (i % (kE / 2)) * 2;
    const float lo = f < m && c < e ? src[f * e + c] : 0.f;
    const float hi = f < m && c + 1 < e ? src[f * e + c + 1] : 0.f;
    uint32_t part[kParts];
    split3(lo, hi, part);
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      *reinterpret_cast<uint32_t*>(dst + p * kPart + core_at(f, c, kE)) =
          part[p];
  }
}

// the descriptor of the operand at `p` (wgmma_desc), opaque to the
// compiler: the descriptors of a chain are this plus byte offsets / 16
// (the start address field), formed where they are used, and not dozens
// of 64-bit constants hoisted out of the slab loop into registers
__device__ __forceinline__ uint64_t desc_at(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  uint64_t d = wgmma_desc(p, lbo, sbo);
  asm volatile("" : "+l"(d));
  return d;
}

// a bf16 pair to columns c, c + 1 of a row (those < e)
__device__ __forceinline__ void st_pair(bf16* row, int c, int e, float lo,
                                        float hi, bool vec) {
  if (vec && c + 1 < e) {
    *reinterpret_cast<uint32_t*>(row + c) = pack_bf16(lo, hi);
    return;
  }
  if (c < e) row[c] = __float2bfloat16_rn(lo);
  if (c + 1 < e) row[c + 1] = __float2bfloat16_rn(hi);
}

// rows [row0, row0 + kBwSlab) (those < row_end) of one (batch, head) of a
// bf16 operand into dst [kBwSlab][kXS16], by the warpgroup's thread `gtid`;
// other rows and columns >= e zero.  `vec`: every row 16-byte aligned and e
// % 8 == 0, so each 8-element group is one cp.async; otherwise plain loads
// (favor.cu stage_bf16_rows)
__device__ __forceinline__ void stage_bf16(bf16* dst,
                                           const bf16* __restrict__ src,
                                           long long row_stride, int row0,
                                           int row_end, int e, bool vec,
                                           int gtid) {
  constexpr int kGroups = kE / 8;  // 16-byte groups a row
  for (int i = gtid; i < kBwSlab * kGroups; i += 128) {
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

// the same for a float32 operand into dst [kBwSlab][kGS]: 4-element groups,
// one cp.async each where `vec` (rows 16-byte aligned, e % 4 == 0)
__device__ __forceinline__ void stage_f32(float* dst,
                                          const float* __restrict__ src,
                                          long long row_stride, int row0,
                                          int row_end, int e, bool vec,
                                          int gtid) {
  constexpr int kGroups = kE / 4;
  for (int i = gtid; i < kBwSlab * kGroups; i += 128) {
    const int r = i / kGroups, c = (i % kGroups) * 4;
    float* d = dst + r * kGS + c;
    const int row = row0 + r;
    if (row < row_end && c < e) {
      const float* from = src + row * row_stride + c;
      if (vec) {
        cp_async16(d, from);
      } else {
        float x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = c + j < e ? from[j] : 0.f;
        *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
      }
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// out = X B^T over the warpgroup's 64 rows x 64 features (wgmma accumulator
// layout), X an exact bf16 slab in shared memory ([kBwSlab][kXS16]; the
// warp's A fragments by ldmatrix, rows wrow..wrow+15), B's three parts
// K-major in shared memory ([kM][kE] core layout): per k-step a chain of
// three products, smallest part first, in one of two accumulators, added
// to out in IEEE float32 while the next chain runs.  sq2: |x|^2 of the
// thread's rows g and g + 8, from the same fragments
__device__ __forceinline__ void dot_slab(float (&out)[32], float (&sq2)[2],
                                         const bf16* slab, int wrow,
                                         const bf16* sB, int lane) {
  const int2 la = lane_a_rowmajor(lane);
  float step[2][32];
  uint32_t xa[2][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] = 0.f;
  sq2[0] = sq2[1] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kE / 16; ++ks) {
    uint32_t(&x)[4] = xa[ks & 1];
    ldsm_x4(x, slab + (wrow + la.x) * kXS16 + 16 * ks + la.y);
    unset(step[ks & 1]);
    wgmma_fence();
#pragma unroll
    const uint64_t d = desc_at(sB + 128 * ks, kCoreK, kSboW);
#pragma unroll
    for (int p = kParts - 1; p >= 0; --p)
      wgmma_64x64x16(step[ks & 1], x, d + p * (2 * kPart / 16),
                     p != kParts - 1);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = lo_bf16(x[j]), x1 = hi_bf16(x[j]);
      sq2[j & 1] = fmaf(x1, x1, fmaf(x0, x0, sq2[j & 1]));
    }
    if (ks > 0) {
      wgmma_wait<1>();
      hold(step[(ks - 1) & 1]);
      hold(xa);
#pragma unroll
      for (int i = 0; i < 32; ++i) out[i] += step[(ks - 1) & 1][i];
    }
  }
  wgmma_wait<0>();
  hold(step[1]);
  hold(xa);
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] += step[1][i];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      sq2[i] += __shfl_xor_sync(0xffffffffu, sq2[i], off);
}

// the three bf16 parts of the pairs (x0, x1) of four registers
__device__ __forceinline__ void split_frag(uint32_t (&a)[kParts][4],
                                           const float2 (&x)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t p[kParts];
    split3(x[r].x, x[r].y, p);
#pragma unroll
    for (int i = 0; i < kParts; ++i) a[i][r] = p[i];
  }
}

// out = G B^T as dot_slab, G a float32 slab in shared memory ([kBwSlab]
// [kGS]), its A fragments read as float2 pairs and split into three parts:
// per k-step a chain of the six products G_i B_j with i + j <= 2,
// smallest first
__device__ __forceinline__ void dot_split_slab(float (&out)[32],
                                               const float* slab, int row,
                                               const bf16* sB, int t4) {
  float step[32];
  uint32_t ga[kParts][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kE / 16; ++ks) {
    const float* p = slab + row * kGS + 16 * ks + 2 * t4;
    const float2 x[4] = {*reinterpret_cast<const float2*>(p),
                         *reinterpret_cast<const float2*>(p + 8 * kGS),
                         *reinterpret_cast<const float2*>(p + 8),
                         *reinterpret_cast<const float2*>(p + 8 * kGS + 8)};
    split_frag(ga, x);
    const uint64_t d = desc_at(sB + 128 * ks, kCoreK, kSboW);
    unset(step);
    wgmma_fence();
    auto product = [&](int i, int j, int accumulate) {
      wgmma_64x64x16(step, ga[i], d + j * (2 * kPart / 16), accumulate);
    };
    product(0, 2, 0);
    product(1, 1, 1);
    product(2, 0, 1);
    product(0, 1, 1);
    product(1, 0, 1);
    product(0, 0, 1);
    wgmma_commit();
    wgmma_wait<0>();
    hold(step);
    hold(ga);
#pragma unroll
    for (int i = 0; i < 32; ++i) out[i] += step[i];
  }
}

// acc = G^T P over the slab's 64 rows for columns 64 mt .. 64 mt + 63 of G
// (the warp's 16wi + g and + 8) and the 64 features of P: A = G^T from the
// float32 slab read transposed (columns as rows) and split into three
// parts, B = P's three parts MN-major in shared memory ([kBwSlab][kM] core
// layout, features contiguous): one chain of the six products G_i P_j with
// i + j <= 2 a k-step over the four k-steps of 16 rows
__device__ __forceinline__ void moments_tc(float (&acc)[32], const float* slab,
                                           const bf16* sP, int mt, int wi,
                                           int g, int t4) {
  uint32_t ga[2][kParts][4];
  const int col = 64 * mt + 16 * wi + g;
  unset(acc);
#pragma unroll
  for (int kk = 0; kk < kBwSlab / 16; ++kk) {
    const float* p = slab + (16 * kk + 2 * t4) * kGS + col;
    // a0 (col, rows 2t4, +1), a1 (col + 8), a2 (rows + 8), a3 (both)
    const float2 x[4] = {make_float2(p[0], p[kGS]),
                         make_float2(p[8], p[kGS + 8]),
                         make_float2(p[8 * kGS], p[9 * kGS]),
                         make_float2(p[8 * kGS + 8], p[9 * kGS + 8])};
    split_frag(ga[kk & 1], x);
    const uint64_t d = desc_at(sP + 16 * kk * kM, kRows64, kCoreK);
    wgmma_fence();
    auto product = [&](int i, int j, int accumulate) {
      wgmma_64x64x16_bt(acc, ga[kk & 1][i], d + j * (2 * kSlabPart / 16),
                        accumulate);
    };
    product(0, 2, kk > 0);
    product(1, 1, 1);
    product(2, 0, 1);
    product(0, 1, 1);
    product(1, 0, 1);
    product(0, 0, 1);
    wgmma_commit();
    wgmma_wait<1>();  // the chain before is done: its parts are free
    if (kk > 0) hold(ga[(kk + 1) & 1]);
  }
  wgmma_wait<0>();
  hold(acc);
  hold(ga[0]);
  hold(ga[1]);
}

// the A fragments of x's three parts, x [64 rows x 64 features] in the
// accumulator layout: feature n-tiles 2kk and 2kk + 1 are k-step kk
// (favor.cu's apply)
__device__ __forceinline__ void to_frags(uint32_t (&a)[kM / 16 * kParts][4],
                                         const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < kM / 8; ++j) {
    uint32_t lo[kParts], hi[kParts];
    split3(x[4 * j], x[4 * j + 1], lo);
    split3(x[4 * j + 2], x[4 * j + 3], hi);
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      a[(j / 2) * kParts + p][2 * (j & 1)] = lo[p];
      a[(j / 2) * kParts + p][2 * (j & 1) + 1] = hi[p];
    }
  }
}

// out = X B[:, 64 hf .. 64 hf + 63] over the 64 features, X in parts as
// A fragments (to_frags), B's three parts MN-major in shared memory (the
// [kM][kE] core layout read with k = feature, n = column): one chain of
// the six products X_i B_j with i + j <= 2 a k-step, smallest first, over
// the four k-steps (24 truncating additions, about 2^-19 of the sums;
// nothing feeds an exp)
__device__ __forceinline__ void contract_tc(
    float (&out)[32], const uint32_t (&xa)[kM / 16 * kParts][4],
    const bf16* sB, int hf) {
  const uint64_t d = desc_at(sB + 512 * hf, kSboW, kCoreK);
  unset(out);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kM / 16; ++kk) {
    auto product = [&](int i, int j, int accumulate) {
      wgmma_64x64x16_bt(out, xa[kk * kParts + i],
                        d + (2 * (16 * kk * kE + j * kPart)) / 16,
                        accumulate);
    };
    product(0, 2, kk > 0);
    product(1, 1, 1);
    product(2, 0, 1);
    product(0, 1, 1);
    product(1, 0, 1);
    product(0, 0, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  hold(out);
}

// phi = exp(wx - |x|^2 / 2) / sqrt(m) in IEEE float32, zero for features
// >= m and rows that are not `ok`
__device__ __forceinline__ void feature_map(float (&x)[32],
                                            const float (&sq2)[2],
                                            const bool (&ok)[2], int m, int t4,
                                            float inv_sqrt_m) {
#pragma unroll
  for (int j = 0; j < kM / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = 8 * j + 2 * t4 + (i & 1);
      x[4 * j + i] = ok[i >> 1] && f < m
                         ? expf(x[4 * j + i] - 0.5f * sq2[i >> 1]) * inv_sqrt_m
                         : 0.f;
    }
}

// sum over the four lanes of a row (one t4 each)
__device__ __forceinline__ float quad_sum(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// the bf16 pairs of a staged slab's rows `row` and row + 8 at columns 64
// hf + 8 jj + 2 t4, both halves: the correction store_half subtracts, at
// the positions of the contraction's accumulator
__device__ __forceinline__ void slab_pairs(uint32_t (&xc)[2][8][2],
                                           const bf16* slab, int row,
                                           int t4) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        xc[hf][jj][r] = *reinterpret_cast<const uint32_t*>(
            slab + (row + 8 * r) * kXS16 + 64 * hf + 8 * jj + 2 * t4);
}

// rows lo and hi, columns 64 hf + 8 jj + 2 t4 (+1): acc - xc * scale[row]
// (no correction where scale is null), rounded to bf16
__device__ __forceinline__ void store_half(const float (&acc)[32],
                                           bf16* const (&out)[2],
                                           const uint32_t (&xc)[8][2],
                                           const float* scale, int hf,
                                           int t4, int e, bool vec) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = 64 * hf + 8 * jj + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (out[r] == nullptr) continue;
      float o0 = acc[4 * jj + 2 * r], o1 = acc[4 * jj + 2 * r + 1];
      if (scale != nullptr) {
        o0 = fmaf(-lo_bf16(xc[jj][r]), scale[r], o0);
        o1 = fmaf(-hi_bf16(xc[jj][r]), scale[r], o1);
      }
      st_pair(out[r], c, e, o0, o1, vec);
    }
  }
}

size_t tc_bwd_q_smem() {
  // w's and K's parts [3][kM][kE]; per warpgroup a region that holds the q
  // slab [kBwSlab][kXS16] and then phi / D's parts [3][kBwSlab][kM], and
  // the dy slab [kBwSlab][kGS]; ksum [kM]; the threads' ds partials
  // [2 kM / 8][kBwThreads]
  return sizeof(bf16) * 2 * size_t(kParts) * kPart +
         size_t(kBwGroups) * (kQRegion + sizeof(float) * kBwSlab * kGS) +
         sizeof(float) * (kM + 2 * (kM / 8) * kBwThreads);
}

size_t tc_bwd_kv_smem() {
  // w's and dK's parts [3][kM][kE]; per warpgroup two k slabs and a v
  // slab [kBwSlab][kXS16]; ds [kM]
  return sizeof(bf16) * (2 * size_t(kParts) * kPart +
                         size_t(kBwGroups) * 3 * kBwSlab * kXS16) +
         sizeof(float) * kM;
}

__global__ void __launch_bounds__(kBwThreads, 1)
favor_bwd_q_bf16_kernel(const bf16* __restrict__ q,
                        const float* __restrict__ dy,
                        const float* __restrict__ w,
                        const float* __restrict__ ksum,
                        const float* __restrict__ kptv, bf16* __restrict__ dq,
                        float* __restrict__ dkptv, float* __restrict__ dksum,
                        float* __restrict__ work, Strides sq, Strides sg,
                        Strides sdq, int heads, int t, int e, int m,
                        int tiles, int tile_rows, float inv_sqrt_m,
                        bool vec_q, bool vec_g, bool vec_out) {
  extern __shared__ uint4 smem_bq[];
  bf16* sW = reinterpret_cast<bf16*>(smem_bq);
  bf16* sK = sW + kParts * kPart;
  uint8_t* regions = reinterpret_cast<uint8_t*>(sK + kParts * kPart);
  float* sS = reinterpret_cast<float*>(
      regions + kBwGroups * (kQRegion + sizeof(float) * kBwSlab * kGS));
  float* sDsp = sS + kM;  // [16][kBwThreads] ds partials

  const int tile = blockIdx.x % tiles;
  const long long bh = blockIdx.x / tiles;
  const long long b = bh / heads, h = bh % heads;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const float* gb = dy + b * sg.b + h * sg.h;
  bf16* dqb = dq + b * sdq.b + h * sdq.h;
  const int row_begin = tile * tile_rows;
  const int row_end = min(t, row_begin + tile_rows);
  const int slabs = (row_end - row_begin + kBwSlab - 1) / kBwSlab;

  const int group = threadIdx.x / 128, gtid = threadIdx.x % 128;
  const int wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  uint8_t* mine_region =
      regions + group * (kQRegion + sizeof(float) * kBwSlab * kGS);
  bf16* qslab = reinterpret_cast<bf16*>(mine_region);  // then phi / D
  bf16* myP = qslab;
  float* gslab = reinterpret_cast<float*>(mine_region + kQRegion);

  // the group's first slab is in flight while w and K are split
  if (group < slabs) {
    stage_bf16(qslab, qb, sq.n, row_begin + group * kBwSlab, row_end, e,
               vec_q, gtid);
    stage_f32(gslab, gb, sg.n, row_begin + group * kBwSlab, row_end, e,
              vec_g, gtid);
  }
  cp_async_commit();
  split_core(sW, w, e, m, threadIdx.x, kBwThreads);
  split_core(sK, kptv + bh * (long long)(m * e), e, m, threadIdx.x,
             kBwThreads);
  for (int f = threadIdx.x; f < kM; f += kBwThreads)
    sS[f] = f < m ? ksum[bh * m + f] : 0.f;
  float* mine = sDsp + threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2 * (kM / 8); ++i) mine[i * kBwThreads] = 0.f;
  fence_proxy_async();  // the parts, written by threads, read by wgmma
  __syncthreads();      // the groups run apart until the end

  // the group's running dK^T (wgmma layout of each 64-column tile mt:
  // columns 64 mt + 16 wi + g and + 8, features 8j + 2 t4 and + 1 in
  // dkt[mt][4j..4j+3]) in registers, and the thread's ds partial (features
  // 8j + 2 t4 and + 1 in mine[2j], mine[2j + 1], a stride of kBwThreads
  // apart) in shared memory
  float dkt[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkt[0][i] = dkt[1][i] = 0.f;

  for (int s = group; s < slabs; s += kBwGroups) {
    const int row0 = row_begin + s * kBwSlab;
    const int rows[2] = {row0 + 16 * wi + g, row0 + 16 * wi + g + 8};
    const bool ok[2] = {rows[0] < row_end, rows[1] < row_end};
    cp_async_wait<0>();
    group_sync(1 + group);  // the group's slabs of q and dy have landed

    // phi of the rows, D = phi . s and a = K g
    float phi[32], sq2[2];
    dot_slab(phi, sq2, qslab, 16 * wi, sW, lane);
    feature_map(phi, sq2, ok, m, t4, inv_sqrt_m);
    float inv_d[2];
    {
      float d[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kM / 8; ++j) {
        const float2 sf = *reinterpret_cast<const float2*>(sS + 8 * j + 2 * t4);
        d[0] = fmaf(phi[4 * j + 1], sf.y, fmaf(phi[4 * j], sf.x, d[0]));
        d[1] = fmaf(phi[4 * j + 3], sf.y, fmaf(phi[4 * j + 2], sf.x, d[1]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sum = quad_sum(d[r]);  // every lane shuffles
        inv_d[r] = ok[r] ? 1.f / sum : 0.f;
      }
    }
    float a[32];
    dot_split_slab(a, gslab, 16 * wi + g, sK, t4);
    // q at dq's positions, for its correction, before phi / D's parts take
    // the slab's place
    uint32_t xc[2][8][2];
    slab_pairs(xc, qslab, 16 * wi + g, t4);
    group_sync(1 + group);  // the q slab is read: phi / D's parts go there

    // gy = (phi . a) / D; u = (a - gy s) / D * phi (in a) and its sum;
    // phi / D's parts to the group's buffer, ds -= (phi / D) gy
    float gy[2], us[2];
    {
      float pa[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        pa[(i >> 1) & 1] = fmaf(phi[i], a[i], pa[(i >> 1) & 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        gy[r] = quad_sum(pa[r]) * inv_d[r];
        us[r] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kM / 8; ++j) {
      const int f = 8 * j + 2 * t4;
      const float2 sf = *reinterpret_cast<const float2*>(sS + f);
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float sv = (i & 1) ? sf.y : sf.x;
        const float u = (a[4 * j + i] - gy[r] * sv) * inv_d[r] * phi[4 * j + i];
        a[4 * j + i] = u;
        us[r] += u;
        p[i] = phi[4 * j + i] * inv_d[r];
      }
      mine[(2 * j) * kBwThreads] -= fmaf(p[0], gy[0], p[2] * gy[1]);
      mine[(2 * j + 1) * kBwThreads] -= fmaf(p[1], gy[0], p[3] * gy[1]);
      uint32_t lo[kParts], hi[kParts];
      split3(p[0], p[1], lo);
      split3(p[2], p[3], hi);
#pragma unroll
      for (int pi = 0; pi < kParts; ++pi) {
        *reinterpret_cast<uint32_t*>(myP + pi * kSlabPart +
                                     core_at(16 * wi + g, f, kM)) = lo[pi];
        *reinterpret_cast<uint32_t*>(myP + pi * kSlabPart +
                                     core_at(16 * wi + g + 8, f, kM)) = hi[pi];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) us[r] = quad_sum(us[r]);

    // dq = u w - q sum(u), 64 columns a pass
    {
      bf16* dqr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        dqr[r] = ok[r] ? dqb + rows[r] * sdq.n : nullptr;
      uint32_t ua[kM / 16 * kParts][4];
      to_frags(ua, a);
#pragma unroll
      for (int hf = 0; hf < kE / kHalf; ++hf) {
        if (kHalf * hf >= e) break;
        float acc[32];
        contract_tc(acc, ua, sW, hf);
        store_half(acc, dqr, xc[hf], us, hf, t4, e, vec_out);
      }
      hold(ua);
    }
    fence_proxy_async();  // phi / D's parts, read by wgmma
    group_sync(1 + group);

    // dK^T += g^T (phi / D) over the slab, 64 columns a tile
#pragma unroll
    for (int mt = 0; mt < kE / 64; ++mt) {
      if (64 * mt >= e) break;
      float part[32];
      moments_tc(part, gslab, myP, mt, wi, g, t4);
#pragma unroll
      for (int i = 0; i < 32; ++i) dkt[mt][i] += part[i];
    }
    group_sync(1 + group);  // the slabs are free: the next lands meanwhile
    if (s + kBwGroups < slabs) {
      stage_bf16(qslab, qb, sq.n, row0 + kBwRows, row_end, e, vec_q, gtid);
      stage_f32(gslab, gb, sg.n, row0 + kBwRows, row_end, e, vec_g, gtid);
    }
    cp_async_commit();
  }

  __syncthreads();  // every group is done: the regions are free
  // ds: over the warp's rows (the lanes of one t4), then the (group, warp)
  // partials in that order; group 1's dK^T through shared memory, added to
  // group 0's
  float* sDs = reinterpret_cast<float*>(regions);  // [groups][4 warps][kM]
  float* other = sDs + kBwGroups * 4 * kM;          // [64][128 threads]
#pragma unroll
  for (int i = 0; i < 2 * (kM / 8); ++i) {
    float dsp = mine[i * kBwThreads];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      dsp += __shfl_xor_sync(0xffffffffu, dsp, off);
    if (g == 0)
      sDs[(group * 4 + wi) * kM + 8 * (i / 2) + 2 * t4 + (i & 1)] = dsp;
  }
  if (group == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) other[i * 128 + gtid] = dkt[i / 32][i % 32];
  }
  __syncthreads();

  float* dst_kv;
  float* dst_ds;
  if (work != nullptr) {
    dst_kv = work + (bh * tiles + tile) * (long long)(m * e + m);
    dst_ds = dst_kv + m * e;
  } else {
    dst_kv = dkptv + bh * (long long)(m * e);
    dst_ds = dksum + bh * m;
  }
  for (int f = threadIdx.x; f < m; f += kBwThreads) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBwGroups * 4; ++i) sum += sDs[i * kM + f];
    dst_ds[f] = sum;
  }
  if (group == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int mt = i / 32, j = i % 32;
      const int col = 64 * mt + 16 * wi + g + 8 * ((j >> 1) & 1);
      const int f = 8 * (j / 4) + 2 * t4 + (j & 1);
      if (f < m && col < e)
        dst_kv[f * e + col] = dkt[mt][j] + other[i * 128 + gtid];
    }
  }
}

__global__ void __launch_bounds__(kBwThreads, 1)
favor_bwd_kv_bf16_kernel(const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ dkptv,
                         const float* __restrict__ dksum,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         Strides sk, Strides sv, Strides sdk, Strides sdv,
                         int heads, int t, int e, int m, int tiles,
                         int tile_rows, float inv_sqrt_m, bool vec_in,
                         bool vec_out) {
  extern __shared__ uint4 smem_bkv[];
  bf16* sW = reinterpret_cast<bf16*>(smem_bkv);
  bf16* sD = sW + kParts * kPart;  // dK's parts
  bf16* slabs_kv = sD + kParts * kPart;  // [group][k, k, v][kBwSlab][kXS16]
  float* sS = reinterpret_cast<float*>(slabs_kv +
                                       kBwGroups * 3 * kBwSlab * kXS16);

  const int tile = blockIdx.x % tiles;
  const long long bh = blockIdx.x / tiles;
  const long long b = bh / heads, h = bh % heads;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  bf16* dkb = dk + b * sdk.b + h * sdk.h;
  bf16* dvb = dv + b * sdv.b + h * sdv.h;
  const int row_begin = tile * tile_rows;
  const int row_end = min(t, row_begin + tile_rows);
  const int slabs = (row_end - row_begin + kBwSlab - 1) / kBwSlab;

  const int group = threadIdx.x / 128, gtid = threadIdx.x % 128;
  const int wi = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  bf16* kslabs = slabs_kv + group * 3 * kBwSlab * kXS16;
  bf16* vslab = kslabs + 2 * kBwSlab * kXS16;

  // the group's first slab is in flight while w and dK are split
  if (group < slabs) {
    stage_bf16(kslabs, kb, sk.n, row_begin + group * kBwSlab, row_end, e,
               vec_in, gtid);
    stage_bf16(vslab, vb, sv.n, row_begin + group * kBwSlab, row_end, e,
               vec_in, gtid);
  }
  cp_async_commit();
  split_core(sW, w, e, m, threadIdx.x, kBwThreads);
  split_core(sD, dkptv + bh * (long long)(m * e), e, m, threadIdx.x,
             kBwThreads);
  for (int f = threadIdx.x; f < kM; f += kBwThreads)
    sS[f] = f < m ? dksum[bh * m + f] : 0.f;
  fence_proxy_async();
  __syncthreads();  // the only block-wide barrier: the groups run apart

  for (int s = group, it = 0; s < slabs; s += kBwGroups, ++it) {
    const int row0 = row_begin + s * kBwSlab;
    const int rows[2] = {row0 + 16 * wi + g, row0 + 16 * wi + g + 8};
    const bool ok[2] = {rows[0] < row_end, rows[1] < row_end};
    bf16* kslab = kslabs + (it & 1) * kBwSlab * kXS16;
    cp_async_wait<0>();
    group_sync(1 + group);  // the group's slabs of k and v have landed
    // the next slab's k into the other buffer, in flight all through this
    if (s + kBwGroups < slabs)
      stage_bf16(kslabs + ((it + 1) & 1) * kBwSlab * kXS16, kb, sk.n,
                 row0 + kBwRows, row_end, e, vec_in, gtid);
    cp_async_commit();

    // phi of the rows; u = (dK v + ds) (in u), both from the slabs
    float phi[32], sq2[2];
    dot_slab(phi, sq2, kslab, 16 * wi, sW, lane);
    feature_map(phi, sq2, ok, m, t4, inv_sqrt_m);
    float u[32], vq[2];
    dot_slab(u, vq, vslab, 16 * wi, sD, lane);
    group_sync(1 + group);  // the v slab is free: the next lands meanwhile
    if (s + kBwGroups < slabs)
      stage_bf16(vslab, vb, sv.n, row0 + kBwRows, row_end, e, vec_in, gtid);
    cp_async_commit();

    bf16* dkr[2];
    bf16* dvr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dkr[r] = ok[r] ? dkb + rows[r] * sdk.n : nullptr;
      dvr[r] = ok[r] ? dvb + rows[r] * sdv.n : nullptr;
    }
    // dv = phi dK, 64 columns a pass
    {
      uint32_t pa[kM / 16 * kParts][4];
      to_frags(pa, phi);
      const uint32_t none[8][2] = {};
#pragma unroll
      for (int hf = 0; hf < kE / kHalf; ++hf) {
        if (kHalf * hf >= e) break;
        float acc[32];
        contract_tc(acc, pa, sD, hf);
        store_half(acc, dvr, none, nullptr, hf, t4, e, vec_out);
      }
      hold(pa);
    }

    // u = (dK v + ds) * phi and its sum; dk = u w - k sum(u), k from the
    // slab
    float us[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kM / 8; ++j) {
      const float2 sf = *reinterpret_cast<const float2*>(sS + 8 * j + 2 * t4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = (u[4 * j + i] + ((i & 1) ? sf.y : sf.x)) *
                        phi[4 * j + i];
        u[4 * j + i] = x;
        us[i >> 1] += x;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) us[r] = quad_sum(us[r]);
    {
      uint32_t xc[2][8][2];
      slab_pairs(xc, kslab, 16 * wi + g, t4);
      uint32_t ua[kM / 16 * kParts][4];
      to_frags(ua, u);
#pragma unroll
      for (int hf = 0; hf < kE / kHalf; ++hf) {
        if (kHalf * hf >= e) break;
        float acc[32];
        contract_tc(acc, ua, sW, hf);
        store_half(acc, dkr, xc[hf], us, hf, t4, e, vec_out);
      }
      hold(ua);
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

void read_strides(const long long* strides, Strides* st, int n) {
  for (int i = 0; i < n; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// every row of the operands starts on `bytes` (element strides and
// pointers)
bool aligned(const void* const* ptrs, const Strides* st, int count,
             int elem, int bytes) {
  bool ok = true;
  for (int i = 0; i < count; ++i)
    ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % bytes == 0 &&
         (st[i].b * elem) % bytes == 0 && (st[i].h * elem) % bytes == 0 &&
         (st[i].n * elem) % bytes == 0;
  return ok;
}

}  // namespace

extern "C" {

// q: [batch, heads, t, e] (bf16 rows 4-byte aligned); dy: float32 [batch,
// heads, t, e]; dq (the output, q's dtype): addressed through `strides` (9
// element strides: batch, head, row of q, of dy, then of dq; e is
// contiguous); w: float32 [m][e], ksum [batch*heads][m] and kptv
// [batch*heads][m][e]: float32 contiguous as scat_favor_stats leaves them;
// dkptv [batch*heads][m][e] and dksum [batch*heads][m]: float32 contiguous
// outputs; work: float32 [batch*heads][tiles][m*e + m] scratch when tiles >
// 1 (then a second launch sums the tiles), unused otherwise.  dtype 0 =
// float32, 1 = bfloat16 (q and dq); tiles is t_tiles' count for the dtype's
// kernel (32-row chunks for float32, 128-row rounds for bfloat16; one block
// an SM).  Launches on `stream` without synchronising and returns
// cudaGetLastError().
int scat_favor_bwd_q(const void* q, const void* dy, const void* w,
                     const void* ksum, const void* kptv, void* dq,
                     void* dkptv, void* dksum, void* work, int batch,
                     int heads, int t, int e, int m,
                     const long long* strides, int tiles, float inv_sqrt_m,
                     int dtype, void* stream) {
  const int chunk = dtype == 1 ? kBwRows : kRows;
  if (!valid(batch, heads, t, e, m, tiles, chunk) ||
      (tiles > 1 && work == nullptr) || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  Strides st[3];
  read_strides(strides, st, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dy);
  const float* wf = static_cast<const float*>(w);
  const float* ks = static_cast<const float*>(ksum);
  const float* kv = static_cast<const float*>(kptv);
  float* dkv = static_cast<float*>(dkptv);
  float* dks = static_cast<float*>(dksum);
  float* wk = tiles > 1 ? static_cast<float*>(work) : nullptr;
  const long long bhs = (long long)batch * heads;
  const int grid = int(bhs * tiles);
  const void* gp[1] = {dy};
  const void* dqp[1] = {dq};
  cudaError_t err;
  if (dtype == 0) {
    err = set_smem(favor_bwd_q_kernel, bwd_q_smem());
    if (err != cudaSuccess) return int(err);
    favor_bwd_q_kernel<<<grid, kThreads, bwd_q_smem(), s>>>(
        static_cast<const float*>(q), g, wf, ks, kv, static_cast<float*>(dq),
        dkv, dks, wk, st[0], st[1], st[2], heads, t, e, m, tiles,
        tile_rows_of(t, tiles, kRows), inv_sqrt_m,
        e % 4 == 0 && aligned(dqp, st + 2, 1, 4, 16));
  } else {
    const void* qp[1] = {q};
    if (!aligned(qp, st, 1, 2, 4)) return int(cudaErrorInvalidValue);
    err = set_smem(favor_bwd_q_bf16_kernel, tc_bwd_q_smem());
    if (err != cudaSuccess) return int(err);
    favor_bwd_q_bf16_kernel<<<grid, kBwThreads, tc_bwd_q_smem(), s>>>(
        static_cast<const bf16*>(q), g, wf, ks, kv, static_cast<bf16*>(dq),
        dkv, dks, wk, st[0], st[1], st[2], heads, t, e, m, tiles,
        tile_rows_of(t, tiles, kBwRows), inv_sqrt_m,
        e % 8 == 0 && aligned(qp, st, 1, 2, 16),
        e % 4 == 0 && aligned(gp, st + 1, 1, 4, 16),
        aligned(dqp, st + 2, 1, 2, 4));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return int(err);
  const long long n = bhs * ((long long)m * e + m);
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  favor_bwd_reduce_kernel<<<int(blocks), 256, 0, s>>>(wk, dks, dkv, bhs,
                                                      tiles, e, m);
  return int(cudaGetLastError());
}

// k, v: [batch, heads, t, e] (bf16 rows 4-byte aligned); dk, dv (the
// outputs, k's dtype): addressed through `strides` (12 element strides:
// batch, head, row of k, v, dk, then dv; e is contiguous); w, dkptv,
// dksum: float32 contiguous as scat_favor_bwd_q leaves them.  dtype is k's
// and v's; tiles is t_tiles' count for its kernel (as scat_favor_bwd_q's).
int scat_favor_bwd_kv(const void* k, const void* v, const void* w,
                      const void* dkptv, const void* dksum, void* dk,
                      void* dv, int batch, int heads, int t, int e, int m,
                      const long long* strides, int tiles, float inv_sqrt_m,
                      int dtype, void* stream) {
  const int chunk = dtype == 1 ? kBwRows : kRows;
  if (!valid(batch, heads, t, e, m, tiles, chunk) ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  Strides st[4];
  read_strides(strides, st, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* dkv = static_cast<const float*>(dkptv);
  const float* dks = static_cast<const float*>(dksum);
  const int grid = int((long long)batch * heads * tiles);
  const void* outs[2] = {dk, dv};
  cudaError_t err;
  if (dtype == 0) {
    err = set_smem(favor_bwd_kv_kernel, bwd_kv_smem());
    if (err != cudaSuccess) return int(err);
    favor_bwd_kv_kernel<<<grid, kThreads, bwd_kv_smem(), s>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), wf, dkv,
        dks, static_cast<float*>(dk), static_cast<float*>(dv), st[0], st[1],
        st[2], st[3], heads, t, e, m, tiles, tile_rows_of(t, tiles, kRows),
        inv_sqrt_m, e % 4 == 0 && aligned(outs, st + 2, 2, 4, 16));
  } else {
    const void* ins[2] = {k, v};
    if (!aligned(ins, st, 2, 2, 4)) return int(cudaErrorInvalidValue);
    err = set_smem(favor_bwd_kv_bf16_kernel, tc_bwd_kv_smem());
    if (err != cudaSuccess) return int(err);
    favor_bwd_kv_bf16_kernel<<<grid, kBwThreads, tc_bwd_kv_smem(), s>>>(
        static_cast<const bf16*>(k), static_cast<const bf16*>(v), wf, dkv,
        dks, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st[0], st[1],
        st[2], st[3], heads, t, e, m, tiles, tile_rows_of(t, tiles, kBwRows),
        inv_sqrt_m, e % 8 == 0 && aligned(ins, st, 2, 2, 16),
        aligned(outs, st + 2, 2, 2, 4));
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
