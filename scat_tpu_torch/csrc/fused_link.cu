// The 1x1-convolution link of a bottleneck, fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of benchmarks/probe_fused_link.py:
// _link_kernel :31-52, launched by fused_link :55-82 (pl.pallas_call :66).
// For x [M, K] bf16 (an NHWC activation seen as rows), w [K, N] bf16 (the
// 1x1 convolution's weight) and scale, shift [K] float32 (the previous
// BatchNorm's affine folded with its statistics):
//   xn  = bf16(relu(x * scale + shift))    in float32 (the product, then
//                                           the sum, each rounded), then
//                                           rounded to bf16
//   acc = xn @ w                            float32 accumulation
//   y   = bf16(acc)                         [M, N]
//   s   = sum over rows of acc, ss = sum over rows of acc^2   [N] float32
// The statistics are taken from the float32 accumulator before y is
// rounded, as in the TPU kernel (its probe's xla_link takes them from the
// rounded y, which is not the kernel's function).
//
// What bounds it: bytes.  At ResNet-50's bottleneck links at bs 96 (the
// probe's shapes, e.g. M 301056, K 256, N 64) a link reads x and w and
// writes y once, 2*(M*K + K*N + M*N) bytes, against 2*M*K*N flops: about
// 51 flops a byte, where the H100 needs about 295 (989 TFLOP/s bf16 over
// 3.35 TB/s) before the tensor cores and not the memory are the limit.
// The TPU kernel's order of work (the M tiles innermost and in sequence,
// the statistics carried across them in the output block) does not carry
// over: blocks run in parallel, in no order.  Design (simple first):
//   * one block of 8 warps per (128-row M-tile, N-tile of 64 or 128
//     columns); the N-tile is the fastest-varying block index, so the
//     blocks that share an M-tile run together and all but the first read
//     its x from L2, not from device memory;
//   * x's [128 x 64] and w's [64 x BN] slices stream into shared memory by
//     16-byte cp.async, 3 stages (4 for BN = 64) with two (three) in
//     flight, the scale and shift of the same 64 k beside them; rows past
//     M and k past K are zero-filled (x, w, scale and shift), so they add
//     nothing to acc;
//   * the tensor cores by mma.sync.m16n8k16 (csrc/mma.cuh).  Each warp
//     loads its A fragments of x by ldmatrix and applies the prologue
//     relu(x * scale + shift) -> bf16 to them in registers, so xn never
//     exists outside the registers; B fragments of w by ldmatrix.trans;
//     rows of every shared tile padded by 16 bytes, so each ldmatrix reads
//     eight distinct bank groups;
//   * the epilogue: each warp's column sums of acc and acc^2 over its rows
//     (rows past M left out), summed across the lanes of a column by a
//     fixed butterfly and across the warps in order through shared
//     memory, are the M-tile's partials, written to a float32 workspace
//     [2][M-tiles][N]; y is rounded to bf16 into a shared staging tile and
//     leaves in 16-byte row stores;
//   * a second launch (fused_link_reduce_kernel) sums the partials of
//     each column: 32 runs of consecutive M-tiles, each in tile order, then
//     the 32 run sums in order.  No float atomics, so two launches agree
//     bit for bit.
// Every shape is byte-bound, so the design's aim is bytes in flight: two
// blocks an SM (109,056 or 112,640 B of shared memory each), each with
// two or three stages of x in flight.  On an H100 80GB HBM3 at 700 W it
// takes 50-62% of the byte bound at the probe's layer1 shapes and 19-40%
// at its layer2 and layer3 shapes (PERF.md).  What holds it is the stage
// loop's latency, not its instructions: in timing-only variants a wgmma
// main loop (A from registers, w in the 128-byte swizzle) moved the times
// little either way, and leaving out the main loop's copies, its
// prologue or its products each left most of the time in place.
// The way on is a later design's: a warp-specialised producer, w resident
// across a persistent block's M-tiles, and tiles that fill the last wave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace scat_mma;

constexpr int kBM = 128;       // rows of an M-tile (ops/fused_link.py)
constexpr int kBK = 64;        // k of one stage
constexpr int kThreads = 256;  // 8 warps
constexpr int kXS = kBK + 8;   // a stage's x row, padded: 144 B
constexpr int kRuns = 32;      // runs of M-tiles the reduce launch sums

// the block's tile at N-tile width BN (64 for N <= 64, else 128)
template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN == 64 ? 1 : 2;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kMI = kBM / kWarpsM / 16;  // m16 tiles a warp
  static constexpr int kNI = BN / kWarpsN / 8;    // n8 tiles a warp
  static constexpr int kStages = BN == 64 ? 4 : 3;
  static constexpr int kWS = BN + 8;  // a w row (and a y row), padded
  static constexpr int kXElems = kBM * kXS;
  static constexpr int kWElems = kBK * kWS;
  // x, w, scale and shift of one stage
  static constexpr int kStageBytes = (kXElems + kWElems) * 2 + 2 * kBK * 4;
  static constexpr int kSmem = kStages * kStageBytes;
  // the epilogue's y staging tile, then the warps' column partials
  static_assert(kBM * kWS * 2 + 2 * kWarpsM * BN * 4 <= kSmem, "epilogue");
  static_assert(kStageBytes % 16 == 0, "stage alignment");
};

// 16 bytes from global to shared memory, or 16 zero bytes where !ok (src
// is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes, or 4 zero bytes where !ok
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// relu(v * s + h) of a register of two bf16 (the lower column in the low
// half), rounded back to bf16: the product and the sum each rounded, as
// the plain version's two float32 operations are
__device__ __forceinline__ uint32_t prologue(uint32_t v, float2 s, float2 h) {
  const float lo = __uint_as_float(v << 16);
  const float hi = __uint_as_float(v & 0xffff0000u);
  return pack_bf16(fmaxf(__fadd_rn(__fmul_rn(lo, s.x), h.x), 0.f),
                   fmaxf(__fadd_rn(__fmul_rn(hi, s.y), h.y), 0.f));
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
fused_link_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, bf16* __restrict__ y,
                  float* __restrict__ part, int M, int K, int N,
                  long long ldx, long long ldw, int n_tiles) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = blockIdx.x / n_tiles;
  const int m0 = mt * kBM, n0 = (blockIdx.x % n_tiles) * BN;
  const int wm0 = (warp % T::kWarpsM) * (kBM / T::kWarpsM);
  const int wn0 = (warp / T::kWarpsM) * (BN / T::kWarpsN);
  const int m_tiles = (M + kBM - 1) / kBM;

  auto stage_x = [&](int st) {
    return reinterpret_cast<bf16*>(smem + st * T::kStageBytes);
  };
  auto stage_w = [&](int st) { return stage_x(st) + T::kXElems; };
  auto stage_f = [&](int st) {  // scale, then shift
    return reinterpret_cast<float*>(stage_w(st) + T::kWElems);
  };

  auto load = [&](int st, int k0) {
    bf16* xs = stage_x(st);
#pragma unroll
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16_zfill(xs + r * kXS + c,
                       ok ? x + (long long)(m0 + r) * ldx + k0 + c : x, ok);
    }
    bf16* ws = stage_w(st);
#pragma unroll
    for (int i = tid; i < kBK * (BN / 8); i += kThreads) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16_zfill(ws + r * T::kWS + c,
                       ok ? w + (long long)(k0 + r) * ldw + n0 + c : w, ok);
    }
    if (tid < 2 * kBK) {
      const int j = tid % kBK;
      const float* src = tid < kBK ? scale : shift;
      const bool ok = k0 + j < K;
      cp_async4_zfill(stage_f(st) + tid, ok ? src + k0 + j : src, ok);
    }
  };

  float acc[T::kMI][T::kNI][4];
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
    for (int nj = 0; nj < T::kNI; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < T::kStages - 1; ++st) {
    if (st < nk) load(st, st * kBK);
    cp_async_commit();
  }
  const int2 la = lane_a_rowmajor(lane), lb = lane_b_kn(lane);
  for (int c = 0; c < nk; ++c) {
    // stage c has landed for every thread; the stage refilled next was
    // read in iteration c - 1, which every thread has left
    cp_async_wait<T::kStages - 2>();
    __syncthreads();
    const int next = c + T::kStages - 1;
    if (next < nk) load(next % T::kStages, next * kBK);
    cp_async_commit();

    const int st = c % T::kStages;
    const bf16* xs = stage_x(st);
    const bf16* ws = stage_w(st);
    const float* sc = stage_f(st);
    const float* sh = sc + kBK;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // a0, a1 hold k columns kk + 2t, +1; a2, a3 kk + 2t + 8, +9
      const float2 s0 = *reinterpret_cast<const float2*>(sc + kk + 2 * t);
      const float2 s1 = *reinterpret_cast<const float2*>(sc + kk + 2 * t + 8);
      const float2 h0 = *reinterpret_cast<const float2*>(sh + kk + 2 * t);
      const float2 h1 = *reinterpret_cast<const float2*>(sh + kk + 2 * t + 8);
      uint32_t a[T::kMI][4];
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi) {
        ldsm_x4(a[mi], xs + (wm0 + mi * 16 + la.x) * kXS + kk + la.y);
        a[mi][0] = prologue(a[mi][0], s0, h0);
        a[mi][1] = prologue(a[mi][1], s0, h0);
        a[mi][2] = prologue(a[mi][2], s1, h1);
        a[mi][3] = prologue(a[mi][3], s1, h1);
      }
#pragma unroll
      for (int nj = 0; nj < T::kNI; nj += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, ws + (kk + lb.x) * T::kWS + wn0 + nj * 8 + lb.y);
#pragma unroll
        for (int mi = 0; mi < T::kMI; ++mi) {
          mma_bf16(acc[mi][nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: the epilogue reuses them

  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* col_s = reinterpret_cast<float*>(smem + kBM * T::kWS * 2);
  float* col_ss = col_s + T::kWarpsM * BN;
  const int wrow = warp % T::kWarpsM;
#pragma unroll
  for (int nj = 0; nj < T::kNI; ++nj) {
    const int col = wn0 + nj * 8 + 2 * t;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm0 + mi * 16 + half * 8 + g;
        const float v0 = acc[mi][nj][2 * half], v1 = acc[mi][nj][2 * half + 1];
        *reinterpret_cast<uint32_t*>(ys + r * T::kWS + col) =
            pack_bf16(v0, v1);
        if (m0 + r < M) {
          s0 += v0;
          s1 += v1;
          q0 += v0 * v0;
          q1 += v1 * v1;
        }
      }
    }
    // the eight lanes of a column (g = 0..7), in a fixed butterfly
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      q0 += __shfl_xor_sync(0xffffffffu, q0, o);
      q1 += __shfl_xor_sync(0xffffffffu, q1, o);
    }
    if (g == 0) {
      col_s[wrow * BN + col] = s0;
      col_s[wrow * BN + col + 1] = s1;
      col_ss[wrow * BN + col] = q0;
      col_ss[wrow * BN + col + 1] = q1;
    }
  }
  __syncthreads();

  // the M-tile's partials: the warps' column sums in warp order
  if (tid < 2 * BN) {
    const int col = tid % BN;
    const float* src = tid < BN ? col_s : col_ss;
    float v = 0.f;
#pragma unroll
    for (int wr = 0; wr < T::kWarpsM; ++wr) v += src[wr * BN + col];
    if (n0 + col < N)
      part[((long long)(tid < BN ? 0 : m_tiles) + mt) * N + n0 + col] = v;
  }
  // y in 16-byte row stores; rows past M and columns past N stay unwritten
#pragma unroll
  for (int i = tid; i < kBM * (BN / 8); i += kThreads) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    if (m0 + r < M && n0 + c < N)
      *reinterpret_cast<uint4*>(y + (long long)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(ys + r * T::kWS + c);
  }
}

// s and ss of each column from the M-tiles' partials part [2][m_tiles][N]:
// a block of 32 columns x kRuns threads; thread (c, j) sums run j of
// consecutive M-tiles in tile order, then thread (c, 0) the runs in order.
// blockIdx.y 0 gives s, 1 gives ss.
__global__ void __launch_bounds__(32 * kRuns)
fused_link_reduce_kernel(const float* __restrict__ part, float* __restrict__ s,
                         float* __restrict__ ss, int m_tiles, int N) {
  __shared__ float runs[kRuns][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* src = part + (long long)blockIdx.y * m_tiles * N;
  const int per = (m_tiles + kRuns - 1) / kRuns;
  const int t0 = threadIdx.y * per;
  const int t1 = min(t0 + per, m_tiles);
  float v = 0.f;
  if (col < N)
    for (int tile = t0; tile < t1; ++tile) v += src[(long long)tile * N + col];
  runs[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < N) {
    float total = 0.f;
    for (int j = 0; j < kRuns; ++j) total += runs[j][threadIdx.x];
    (blockIdx.y == 0 ? s : ss)[col] = total;
  }
}

template <int BN>
cudaError_t launch(const bf16* x, const bf16* w, const float* scale,
                   const float* shift, bf16* y, float* part, int M, int K,
                   int N, long long ldx, long long ldw, cudaStream_t stream) {
  using T = Tile<BN>;
  const int n_tiles = (N + BN - 1) / BN;
  const long long blocks = (long long)((M + kBM - 1) / kBM) * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_link_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return err;
  fused_link_kernel<BN><<<int(blocks), kThreads, T::kSmem, stream>>>(
      x, w, scale, shift, y, part, M, K, N, ldx, ldw, n_tiles);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x [M, K] bf16 with rows ldx elements apart, w [K, N] bf16 with rows ldw
// apart (both 16-byte aligned, ldx and ldw multiples of 8); scale and
// shift [K] float32 contiguous; y [M, N] bf16 contiguous (16-byte
// aligned); s and ss [N] float32; work: float32 scratch of 2 *
// ceil(M / 128) * N.  K and N are multiples of 8, M >= 1.  Two launches
// on `stream` (the link, then the sum of its M-tiles' partials), no
// synchronisation; returns cudaGetLastError().
int scat_fused_link(const void* x, const void* w, const void* scale,
                    const void* shift, void* y, void* s, void* ss,
                    void* work, int M, int K, int N, long long ldx,
                    long long ldw, void* stream) {
  if (M < 1 || K < 8 || N < 8 || K % 8 || N % 8 || ldx < 0 || ldx % 8 ||
      ldw < 0 || ldw % 8 || !aligned16(x) || !aligned16(w) ||
      !aligned16(y) || work == nullptr)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* part = static_cast<float*>(work);
  bf16* yb = static_cast<bf16*>(y);
  cudaError_t err =
      N <= 64 ? launch<64>(xb, wb, sc, sh, yb, part, M, K, N, ldx, ldw, st)
              : launch<128>(xb, wb, sc, sh, yb, part, M, K, N, ldx, ldw, st);
  if (err != cudaSuccess) return int(err);
  const int m_tiles = (M + kBM - 1) / kBM;
  fused_link_reduce_kernel<<<dim3((N + 31) / 32, 2), dim3(32, kRuns), 0,
                             st>>>(part, static_cast<float*>(s),
                                   static_cast<float*>(ss), m_tiles, N);
  return int(cudaGetLastError());
}

const char* scat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
