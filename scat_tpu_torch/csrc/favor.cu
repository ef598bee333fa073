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
// [m, e] the frozen Gaussian projection.  IEEE float32 throughout (FMAs and
// expf; no fast-math, no TF32: the exp amplifies input rounding, which is
// why the JAX package runs these dots at Precision.HIGHEST) and no
// max-subtraction stabiliser, so that overflow and underflow behave as in
// the reference.
//
// What bounds them on the H100: float32 operations.  A row costs 2*m*e FMAs
// (m*e for its features, m*e for the outer product phi(k)^T v or for
// phi(q) kptv) against e elements read: at e = 128, m = 64 that is 128 flops
// per element, above the ~20 flops per byte of float32 where the 67 TFLOP/s
// non-tensor-core rate, not the 3.35 TB/s memory, is the limit.  So the
// design feeds the FMA pipes from registers and shared memory:
//   * one block of 256 threads per (batch*head, T-tile); w [m][e] stays in
//     shared memory for the block's life; rows are staged 32 at a time
//     ([32][e] of k and v, or of q), converted to float32 on load (bf16
//     operands convert exactly, as the caller's cast would);
//   * the features of a 32-row chunk are a [32 x e] x [e x m] product,
//     register-tiled 4 rows x 2 features a thread and laid out so that a
//     warp's float4 loads of w (row stride e+4 floats) are free of bank
//     conflicts and its loads of rows are broadcasts; |x|^2 is one warp
//     reduction per row;
//   * stats: each thread keeps a 4 x 8 tile of kptv (and 4 entries of ksum)
//     in registers across all of the block's rows;
//   * apply: each thread computes a 4-row x 4-column tile of phi(q) kptv,
//     divides it by D and stores it.
// phi never reaches device memory.  Blocks run in parallel, so T cannot be
// accumulated across grid steps as on the TPU: the host splits T into as
// many tiles as filling the SMs needs (ops/favor.py t_tiles), the stats
// blocks write per-tile partials, and a second launch sums them in tile
// order.  No float atomics, so two runs agree bit for bit.  With one tile
// the stats kernel writes its outputs directly.  Shapes: e <= 128, m <= 64
// (ViP: 128 and 64); rows past T and columns past e or m are zero in shared
// memory and never stored.

#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
template <typename T>
__device__ void stage_rows(float* dst, const T* __restrict__ src,
                           long long row_stride, int row0, int row_end,
                           int e) {
#pragma unroll 4
  for (int i = threadIdx.x; i < kRows * kE; i += kThreads) {
    const int r = i / kE, c = i % kE;
    const int row = row0 + r;
    float x = 0.f;
    if (row < row_end && c < e) x = to_f32(src[row * row_stride + c]);
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
favor_stats_kernel(const T* __restrict__ k, const T* __restrict__ v,
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
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
favor_apply_kernel(const T* __restrict__ q, const float* __restrict__ w,
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
  const T* qb = q + b * sq.b + h * sq.h;
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

int tile_rows_of(int t, int tiles) {
  const int per = (t + tiles - 1) / tiles;
  return (per + kRows - 1) / kRows * kRows;
}

// the shapes both kernels take; tiles must be ops/favor.py t_tiles' count
bool valid(int batch, int heads, int t, int e, int m, int tiles) {
  if (batch < 1 || heads < 1 || t < 1 || e < 1 || e > kE || m < 1 ||
      m > kM || tiles < 1 || tiles > t)
    return false;
  const long long grid = (long long)batch * heads * tiles;
  return grid <= 0x7fffffffLL &&
         (t + tile_rows_of(t, tiles) - 1) / tile_rows_of(t, tiles) == tiles;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <typename T>
cudaError_t launch_stats(const void* k, const void* v, const float* w,
                         float* ksum, float* kptv, float* work, int batch,
                         int heads, int t, int e, int m, const Strides* st,
                         int tiles, float inv_sqrt_m, cudaStream_t stream) {
  cudaError_t err = set_smem(favor_stats_kernel<T>, stats_smem());
  if (err != cudaSuccess) return err;
  const long long bhs = (long long)batch * heads;
  favor_stats_kernel<T><<<int(bhs * tiles), kThreads, stats_smem(),
                          stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), w, ksum, kptv,
      tiles > 1 ? work : nullptr, st[0], st[1], heads, t, e, m, tiles,
      tile_rows_of(t, tiles), inv_sqrt_m);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  const long long n = bhs * ((long long)m * e + m);
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  favor_reduce_kernel<<<int(blocks), 256, 0, stream>>>(work, ksum, kptv,
                                                       bhs, tiles, e, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply(const void* q, const float* w, const float* ksum,
                         const float* kptv, float* y, int batch, int heads,
                         int t, int e, int m, const Strides* st, int tiles,
                         float inv_sqrt_m, cudaStream_t stream) {
  cudaError_t err = set_smem(favor_apply_kernel<T>, apply_smem());
  if (err != cudaSuccess) return err;
  favor_apply_kernel<T><<<int((long long)batch * heads * tiles), kThreads,
                          apply_smem(), stream>>>(
      static_cast<const T*>(q), w, ksum, kptv, y, st[0], st[1], heads, t, e,
      m, tiles, tile_rows_of(t, tiles), inv_sqrt_m);
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
// dtype 0 = float32, 1 = bfloat16.  Launches on `stream` without
// synchronising and returns cudaGetLastError().
int scat_favor_stats(const void* k, const void* v, const void* w, void* ksum,
                     void* kptv, void* work, int batch, int heads, int t,
                     int e, int m, const long long* strides, int tiles,
                     float inv_sqrt_m, int dtype, void* stream) {
  if (!valid(batch, heads, t, e, m, tiles) || (tiles > 1 && work == nullptr))
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
    err = launch_stats<float>(k, v, wf, ks, kv, wk, batch, heads, t, e, m,
                              st, tiles, inv_sqrt_m, s);
  else if (dtype == 1)
    err = launch_stats<__nv_bfloat16>(k, v, wf, ks, kv, wk, batch, heads, t,
                                      e, m, st, tiles, inv_sqrt_m, s);
  else
    return int(cudaErrorInvalidValue);
  return int(err);
}

// q: [batch, heads, t, e] and y (float32, the output): addressed through
// `strides` (6 element strides: batch, head, row of q, then of y); w, ksum,
// kptv: float32 contiguous as scat_favor_stats leaves them.  dtype is q's.
int scat_favor_apply(const void* q, const void* w, const void* ksum,
                     const void* kptv, void* y, int batch, int heads, int t,
                     int e, int m, const long long* strides, int tiles,
                     float inv_sqrt_m, int dtype, void* stream) {
  if (!valid(batch, heads, t, e, m, tiles)) return int(cudaErrorInvalidValue);
  Strides st[2];
  read_strides(strides, st, 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* ks = static_cast<const float*>(ksum);
  const float* kv = static_cast<const float*>(kptv);
  float* yf = static_cast<float*>(y);
  cudaError_t err;
  if (dtype == 0)
    err = launch_apply<float>(q, wf, ks, kv, yf, batch, heads, t, e, m, st,
                              tiles, inv_sqrt_m, s);
  else if (dtype == 1)
    err = launch_apply<__nv_bfloat16>(q, wf, ks, kv, yf, batch, heads, t, e,
                                      m, st, tiles, inv_sqrt_m, s);
  else
    return int(cudaErrorInvalidValue);
  return int(err);
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
