// Gathered multi-adapter block-LoRA projection for Hopper (sm_90a), with a
// plain C interface loaded through ctypes.
//
// Replaces the TPU kernel
//   mdlora_matmul_multi_pallas  src/repro/kernels/mdlora/kernel.py:70
// x [B, D] (fp32 or bf16), W0 [D, F] (x's type), a [A, D, r] and b [A, r, F]
// fp32, idx [B] int32, mask [B, D] fp32 or null (= all ones):
//   xm[i]  = x[i] * mask[i]
//   y[i]   = xm[i] @ W0 + scale * (xm[i] @ a[idx[i]]) @ b[idx[i]]
// -> y [B, F] in x's type. Each row gathers its own adapter through idx; no
// [B, D, r] copy of the adapters is made. An idx outside [0, A) is clamped.
//
// Bound: device-memory bytes. At decode (B ~ 16) every element of W0 feeds
// 2B flops, far below the card's flops-per-byte ridge, so the least time is
// W0's bytes (plus the gathered adapters, x and the mask) over the memory
// rate. The design reads W0 once per F tile for all B rows.
//
// Two launches:
//   1. one grid of two kinds of block.
//      base blocks: (F tile of 32 columns) x (D split). 256 threads: 16
//        column pairs x 16 d-groups. x*mask for a chunk of 256 d and 16 rows
//        is staged in shared memory; each thread walks its d-group's rows of
//        the W0 tile (two columns per load, all 16 loads of a chunk in
//        flight) and keeps 16 rows x 2 columns of fp32 sums; the 16
//        d-groups are summed in shared memory in a fixed order and the
//        partial goes to a workspace [sd, B, F]. More than 16 rows: the next
//        16 reread the tile (from L2).
//      bottleneck blocks: (D split) x (row). u_part[su, B, r] =
//        xm[i, split] @ a[idx[i], split, :], threads on consecutive (d, j)
//        elements of the row's own adapter, summed per j in a fixed order.
//   2. finish: y[i, f] = sum over splits of the base partials (in split
//      order) + scale * sum_j u[i, j] b[idx[i], j, f], with u[i, j] the sum
//      of its partials in split order.
// The split counts sd and su are a function of (D, F, r, SM count) only,
// never of B, and no float atomics are used: a row's result is the same
// bits whatever rows sit beside it, how many there are, and in what order
// (continuous batching moves requests between slots).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileF = 32;     // columns per base block
constexpr int kPairs = 16;     // column pairs (threads per W0 row)
constexpr int kDGroups = 16;   // d-groups of a base block
constexpr int kRows = 16;      // rows per pass over the W0 tile
constexpr int kChunk = 256;    // d per shared-memory stage
constexpr int kXStride = 20;   // floats per staged d (16 rows + pad, 16 B aligned)
constexpr int kSplitMin = 256; // least d per base split
constexpr int kUChunk = 512;   // d per bottleneck split
constexpr int kFinish = 128;   // columns per finish block

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

// two adjacent W0 columns in one 4-byte (bf16) or 8-byte (fp32) load
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}

__device__ __forceinline__ int adapter(const int* idx, int i, int A) {
  return min(max(idx[i], 0), A - 1);
}

// acc[i][:] += x_i * (w_a, w_b) for the 16 staged rows of one d
__device__ __forceinline__ void fma_rows(float (&acc)[kRows][2],
                                         const float* xs, float w_a,
                                         float w_b) {
  const float4* xv = reinterpret_cast<const float4*>(xs);
#pragma unroll
  for (int q4 = 0; q4 < kRows / 4; ++q4) {
    const float4 t = xv[q4];
    acc[4 * q4 + 0][0] += t.x * w_a;
    acc[4 * q4 + 0][1] += t.x * w_b;
    acc[4 * q4 + 1][0] += t.y * w_a;
    acc[4 * q4 + 1][1] += t.y * w_b;
    acc[4 * q4 + 2][0] += t.z * w_a;
    acc[4 * q4 + 2][1] += t.z * w_b;
    acc[4 * q4 + 3][0] += t.w * w_a;
    acc[4 * q4 + 3][1] += t.w * w_b;
  }
}

// kVec: F is even, so a thread's two columns are one aligned vector load
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) partial_kernel(
    const T* __restrict__ x, const T* __restrict__ w0,
    const float* __restrict__ a, const int* __restrict__ idx,
    const float* __restrict__ mask, int B, int D, int F, int A, int r,
    int sd, int su, float* __restrict__ ws_base, float* __restrict__ ws_u) {
  __shared__ __align__(16) float buf[kDGroups * kRows * kTileF];  // 32 KB
  const int tid = threadIdx.x;
  const int n_ftiles = (F + kTileF - 1) / kTileF;
  const int n_base = n_ftiles * sd;

  if ((int)blockIdx.x >= n_base) {  // bottleneck block: u_part[split, i, :]
    const int ub = blockIdx.x - n_base, split = ub / B, i = ub % B;
    const int len = (D + su - 1) / su;
    const int d0 = split * len, d1 = min(D, d0 + len);
    const int per = kThreads / r, nthr = per * r, j = tid % r;
    const float* ai = a + (long long)adapter(idx, i, A) * D * r;
    float acc = 0.f;
    if (tid < nthr) {
      for (int d = d0 + tid / r; d < d1; d += per) {
        float xm = to_float(x[(long long)i * D + d]);
        if (mask != nullptr) xm *= mask[(long long)i * D + d];
        acc += xm * ai[(long long)d * r + j];
      }
    }
    buf[tid] = acc;
    __syncthreads();
    for (int jj = tid; jj < r; jj += kThreads) {
      float s = 0.f;
      for (int t = jj; t < nthr; t += r) s += buf[t];
      ws_u[((long long)split * B + i) * r + jj] = s;
    }
    return;
  }

  const int ftile = blockIdx.x % n_ftiles, split = blockIdx.x / n_ftiles;
  const int len = (D + sd - 1) / sd;
  const int d0 = split * len, d1 = min(D, d0 + len);
  const int cp = tid % kPairs, dg = tid / kPairs;
  const int f0 = ftile * kTileF + 2 * cp;
  const bool ok0 = f0 < F, ok1 = f0 + 1 < F;

  for (int g0 = 0; g0 < B; g0 += kRows) {
    float acc[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int c0 = d0; c0 < d1; c0 += kChunk) {
      const int clen = min(kChunk, d1 - c0);
      __syncthreads();  // the previous stage's readers are done
      for (int e = tid; e < kRows * clen; e += kThreads) {
        const int i = e / clen, dd = e % clen, row = g0 + i;
        float xm = 0.f;
        if (row < B) {
          const long long off = (long long)row * D + c0 + dd;
          xm = to_float(x[off]);
          if (mask != nullptr) xm *= mask[off];
        }
        buf[dd * kXStride + i] = xm;
      }
      __syncthreads();
      if (kVec && clen == kChunk) {
        // a full chunk: all of this thread's W0 loads in flight at once,
        // then the sums in the same ascending order as the loop below
        constexpr int kSteps = kChunk / kDGroups;
        float wa[kSteps], wb[kSteps];
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {
          wa[k] = wb[k] = 0.f;
          if (ok0)
            load2(w0 + (long long)(c0 + dg + k * kDGroups) * F + f0, wa[k],
                  wb[k]);
        }
#pragma unroll
        for (int k = 0; k < kSteps; ++k)
          fma_rows(acc, buf + (dg + k * kDGroups) * kXStride, wa[k], wb[k]);
      } else {
#pragma unroll 4
        for (int dd = dg; dd < clen; dd += kDGroups) {
          const long long wrow = (long long)(c0 + dd) * F;
          const float w_a = ok0 ? to_float(w0[wrow + f0]) : 0.f;
          const float w_b = ok1 ? to_float(w0[wrow + f0 + 1]) : 0.f;
          fma_rows(acc, buf + dd * kXStride, w_a, w_b);
        }
      }
    }
    __syncthreads();  // done with the staged x: reuse buf for the d-groups
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      buf[(dg * kRows + i) * kTileF + 2 * cp] = acc[i][0];
      buf[(dg * kRows + i) * kTileF + 2 * cp + 1] = acc[i][1];
    }
    __syncthreads();
    for (int o = tid; o < kRows * kTileF; o += kThreads) {
      const int i = o / kTileF, col = o % kTileF;
      const int row = g0 + i, f = ftile * kTileF + col;
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kDGroups; ++g) s += buf[(g * kRows + i) * kTileF + col];
      if (row < B && f < F) ws_base[((long long)split * B + row) * F + f] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinish) finish_kernel(
    const float* __restrict__ ws_base, const float* __restrict__ ws_u,
    const float* __restrict__ b, const int* __restrict__ idx, float scale,
    int B, int F, int A, int r, int sd, int su, T* __restrict__ out) {
  __shared__ float u[256];
  const int i = blockIdx.y, tid = threadIdx.x;
  for (int j = tid; j < r; j += kFinish) {
    float s = 0.f;
    for (int p = 0; p < su; ++p) s += ws_u[((long long)p * B + i) * r + j];
    u[j] = s;
  }
  __syncthreads();
  const int f = blockIdx.x * kFinish + tid;
  if (f >= F) return;
  float base = 0.f;
  for (int p = 0; p < sd; ++p) base += ws_base[((long long)p * B + i) * F + f];
  const float* bi = b + (long long)adapter(idx, i, A) * r * F;
  float lora = 0.f;
  for (int j = 0; j < r; ++j) lora += u[j] * bi[(long long)j * F + f];
  out[(long long)i * F + f] = from_float<T>(base + scale * lora);
}

template <typename T>
int launch(const void* x, const void* w0, const float* a, const float* b,
           const int* idx, const float* mask, float scale, int B, int D,
           int F, int A, int r, int sd, int su, float* ws, void* out,
           cudaStream_t stream) {
  const long long n_ftiles = (F + kTileF - 1) / kTileF;
  const long long blocks = n_ftiles * sd + (long long)B * su;
  const long long fblocks = (F + kFinish - 1) / kFinish;
  if (blocks > 0x7fffffff || fblocks > 0x7fffffff || B > 65535)
    return (int)cudaErrorInvalidValue;
  float* ws_base = ws;
  float* ws_u = ws + (long long)sd * B * F;
  auto kern = F % 2 == 0 ? partial_kernel<T, true> : partial_kernel<T, false>;
  kern<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w0), a, idx, mask, B,
      D, F, A, r, sd, su, ws_base, ws_u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<T><<<dim3((unsigned)fblocks, (unsigned)B), kFinish, 0,
                      stream>>>(ws_base, ws_u, b, idx, scale, B, F, A, r, sd,
                                su, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Split counts for a shape on a card with `sms` SMs: out[0] = sd (base
// product), out[1] = su (bottleneck). Enough base blocks for ~4 per SM, each
// split at least kSplitMin rows of d. Independent of the batch size.
void mdlora_multi_plan(int D, int F, int r, int sms, int* out) {
  const int n_ftiles = (F + kTileF - 1) / kTileF;
  const int max_sd = D / kSplitMin > 1 ? D / kSplitMin : 1;
  int sd = (4 * sms + n_ftiles - 1) / n_ftiles;
  sd = sd < 1 ? 1 : (sd > max_sd ? max_sd : sd);
  const int su = (D + kUChunk - 1) / kUChunk;
  out[0] = sd;
  out[1] = su;
  (void)r;
}

// dtype 0 = fp32, 1 = bf16 (x, W0 and y). ws holds sd*B*F + su*B*r floats.
// Returns a cudaError_t.
int mdlora_multi(const void* x, const void* w0, const float* a,
                 const float* b, const int* idx, const float* mask,
                 float scale, int B, int D, int F, int A, int r, int dtype,
                 int sd, int su, float* ws, void* out, void* stream) {
  if (r < 1 || r > 256 || sd < 1 || su < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w0, a, b, idx, mask, scale, B, D, F, A,
                                 r, sd, su, ws, out, st);
  return launch<float>(x, w0, a, b, idx, mask, scale, B, D, F, A, r, sd, su,
                       ws, out, st);
}

}  // extern "C"
