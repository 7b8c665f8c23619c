// Fused block-LoRA projection (one adapter for every row) for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel
//   mdlora_matmul_pallas  src/repro/kernels/mdlora/kernel.py:117 (body
//   _kernel, :25-44)
// For each slice k of an optional leading batch axis (K >= 1):
//   xm    = x[k] * mask[k]                         x [T, D], mask [D]
//   y[k]  = xm @ W0[k] + scale * (xm @ a[k]) @ b[k]
// with W0 [D, F], a [D, r], b [r, F]. Every operand has its own batch stride
// in elements; stride 0 shares one copy across the batch (the frozen W0 of
// the clients of a vmapped training step). x, W0, a, b and y are all fp32 or
// all bf16, the mask is fp32 (null = all ones), and every sum is fp32.
//
// Bound: at the training path's shape (8 clients x 32 rows, D 112, F 128,
// r 8) the call moves 0.37 MB and does 8.4 MFLOP: 0.13 us at the fp32
// peak, 0.11 us at the memory rate, far below one launch. At 1024 clients
// (40 MB, 1.1 GFLOP) fp32 operations bound it (16 us against 12 us of
// bytes); in bf16 the bytes do.
//
// Design (simple and right first; tensor cores are later work):
//   one block per (32-row tile, 64-column tile, batch slice), 256 threads.
//   The block walks D in chunks of 32. x*mask [32 x 32], the W0 tile
//   [32 x 64] and a's rows [32 x r] are staged in shared memory, the ragged
//   edges of T, D and F zero-filled (no divisibility is asked of any size);
//   each thread issues all of its loads of a stage before it stores any, so
//   they are in flight together. Each thread keeps 2 rows x 4 columns of the
//   base product xm @ W0 and up to kUPer elements of the bottleneck
//   u = xm @ a in fp32 registers, so one pass over D builds both, as the
//   TPU kernel's scratch does. Then u goes to shared memory, b's tile is
//   staged 32 rows at a time in W0's place, and each output adds
//   scale * sum_j u[i, j] b[j, f].
//   Sums run d ascending, then j ascending, with no atomics: two calls give
//   the same bits, and a tile's result does not depend on the grid. Each
//   column tile recomputes its rows' u (r/F of the base product's work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileT = 32;   // rows per block
constexpr int kTileF = 64;   // columns per block
constexpr int kChunk = 32;   // d per shared-memory stage
constexpr int kMaxR = 64;    // largest LoRA rank taken
constexpr int kUPer = kTileT * kMaxR / kThreads;  // u elements per thread
constexpr int kXPer = kTileT * kChunk / kThreads;  // x loads per stage
constexpr int kWPer = kChunk * kTileF / kThreads;  // W0 (or b) loads
constexpr int kAPer = kChunk * kMaxR / kThreads;   // at most, a loads
static_assert(kChunk == kTileT, "the a stage is reused for u [kTileT, r]");
static_assert(kThreads == 16 * (kTileT / 2), "2 rows x 4 columns a thread");
static_assert(kTileF == 16 * 4, "2 rows x 4 columns a thread");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mdlora_kernel(
    const T* __restrict__ x, const T* __restrict__ w0,
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ mask, float scale, int Tn, int D, int F, int r,
    long long sx, long long sw, long long sa, long long sb, long long sm,
    T* __restrict__ y) {
  __shared__ float xs[kTileT][kChunk + 1];  // +1: rows on other banks
  __shared__ float ws[kChunk][kTileF];
  __shared__ float as[kChunk][kMaxR];  // a's rows, then u [kTileT, r]
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kTileF, t0 = blockIdx.y * kTileT;
  const long long k = blockIdx.z;
  x += k * sx;
  w0 += k * sw;
  a += k * sa;
  b += k * sb;
  if (mask != nullptr) mask += k * sm;
  y += k * (long long)Tn * F;

  const int tx = tid % 16, ty = tid / 16;  // columns tx + 16c, rows ty, ty+16
  const int nu = kTileT * r;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  float uacc[kUPer];
#pragma unroll
  for (int q = 0; q < kUPer; ++q) uacc[q] = 0.f;

  for (int c0 = 0; c0 < D; c0 += kChunk) {
    float xv[kXPer], wv[kWPer], av[kAPer];
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      const int e = tid + q * kThreads, i = e / kChunk, dd = e % kChunk;
      const int row = t0 + i, d = c0 + dd;
      xv[q] = 0.f;
      if (row < Tn && d < D) {
        xv[q] = to_float(x[(long long)row * D + d]);
        if (mask != nullptr) xv[q] *= mask[d];
      }
    }
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int e = tid + q * kThreads, dd = e / kTileF, col = e % kTileF;
      const int d = c0 + dd, f = f0 + col;
      wv[q] = (d < D && f < F) ? to_float(w0[(long long)d * F + f]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kAPer; ++q) {
      const int e = tid + q * kThreads, d = c0 + e / r;
      av[q] = (e < kChunk * r && d < D) ? to_float(a[(long long)c0 * r + e])
                                         : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kXPer; ++q) {
      const int e = tid + q * kThreads;
      xs[e / kChunk][e % kChunk] = xv[q];
    }
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int e = tid + q * kThreads;
      ws[e / kTileF][e % kTileF] = wv[q];
    }
#pragma unroll
    for (int q = 0; q < kAPer; ++q) {
      const int e = tid + q * kThreads;
      if (e < kChunk * r) as[e / r][e % r] = av[q];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      const float x0 = xs[ty][kk], x1 = xs[ty + 16][kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float w = ws[kk][tx + 16 * c];
        acc[0][c] = fmaf(x0, w, acc[0][c]);
        acc[1][c] = fmaf(x1, w, acc[1][c]);
      }
    }
#pragma unroll
    for (int q = 0; q < kUPer; ++q) {
      const int e = tid + q * kThreads;
      if (e < nu) {
        const int i = e / r, j = e % r;
        float s = uacc[q];
        for (int kk = 0; kk < kChunk; ++kk) s = fmaf(xs[i][kk], as[kk][j], s);
        uacc[q] = s;
      }
    }
    __syncthreads();  // the stage is read; the next one may overwrite it
  }

#pragma unroll
  for (int q = 0; q < kUPer; ++q) {
    const int e = tid + q * kThreads;
    if (e < nu) as[e / r][e % r] = uacc[q];
  }
  __syncthreads();
  float lora[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) lora[i][c] = 0.f;
  for (int j0 = 0; j0 < r; j0 += kChunk) {  // b's tile, 32 rows at a time
    float bv[kWPer];
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int e = tid + q * kThreads, j = j0 + e / kTileF;
      const int f = f0 + e % kTileF;
      bv[q] = (j < r && f < F) ? to_float(b[(long long)j * F + f]) : 0.f;
    }
    __syncthreads();  // done with the previous rows of b (or with W0)
#pragma unroll
    for (int q = 0; q < kWPer; ++q) {
      const int e = tid + q * kThreads;
      ws[e / kTileF][e % kTileF] = bv[q];
    }
    __syncthreads();
    const int jn = min(kChunk, r - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float u0 = as[ty][j0 + jj], u1 = as[ty + 16][j0 + jj];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float w = ws[jj][tx + 16 * c];
        lora[0][c] = fmaf(u0, w, lora[0][c]);
        lora[1][c] = fmaf(u1, w, lora[1][c]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = t0 + ty + 16 * rr;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = f0 + tx + 16 * c;
      if (row < Tn && f < F)
        y[(long long)row * F + f] =
            from_float<T>(fmaf(scale, lora[rr][c], acc[rr][c]));
    }
  }
}

}  // namespace

extern "C" {

// The largest rank the kernel takes (its u registers are sized for it).
int mdlora_max_rank() { return kMaxR; }

// dtype 0 = fp32, 1 = bf16 (x, W0, a, b and y). Strides are in elements
// between batch slices (0 = shared). y is [K, T, F], contiguous. Returns a
// cudaError_t.
int mdlora_fused(const void* x, const void* w0, const void* a, const void* b,
                 const float* mask, float scale, int K, int T, int D, int F,
                 int r, int dtype, long long sx, long long sw, long long sa,
                 long long sb, long long sm, void* y, void* stream) {
  if (K < 1 || T < 1 || D < 1 || F < 1 || r < 1 || r > kMaxR)
    return (int)cudaErrorInvalidValue;
  const long long ft = (F + kTileF - 1) / kTileF;
  const long long tt = (T + kTileT - 1) / kTileT;
  if (ft > 0x7fffffff || tt > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ft, (unsigned)tt, (unsigned)K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    mdlora_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w0),
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), mask, scale, T, D, F, r, sx, sw,
        sa, sb, sm, static_cast<__nv_bfloat16*>(y));
  } else {
    mdlora_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w0),
        static_cast<const float*>(a), static_cast<const float*>(b), mask,
        scale, T, D, F, r, sx, sw, sa, sb, sm, static_cast<float*>(y));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
