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
// rate. Both designs read W0 once per 16 rows for all of them.
//
// Dispatch (the C entry `mdlora_multi`, explicit by dtype, no fallback):
//   fp32 -> the first version (partial_kernel + finish_kernel), unchanged:
//           fp32 FMAs on the CUDA cores, two launches (its 1e-4 parity
//           needs fp32 arithmetic; the serving path runs bf16).
//   bf16 -> bf16_kernel, one launch, for every shape (ragged D and F take
//           its plain-load staging, kVec = false).
//
// fp32, two launches:
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
//
// bf16, one launch of 128-thread blocks (bf16_kernel below):
//   su x ceil(B / ug) bottleneck blocks, one per (128-wide D split, group of
//     ug rows; ug = 16, or 4 where the card has room, from the planner):
//     u_part[split, i, :] in fp32 on the CUDA cores (< 10% of the bytes).
//     Per 8 columns the split's x*m and the rows' adapter slices are staged
//     in shared memory by 16-byte cp.async, all in flight; thread (j, d-lane)
//     sums its d and the d-lanes add in lane order; the split's u_part goes
//     to the workspace and an integer atomicAdd counts it written.
//   n_ft * sd base blocks, (F tile of 64 columns) x (D split of L rows, L a
//     multiple of 64 from the wrapper's planner). A ring of 6 stages, each
//     64 d of W0's tile (8 KB) with the same d of x and the mask for the
//     16 rows, streams by 16-byte cp.async, the copies of 5 stages in
//     flight while one is consumed (~70 KB per block, two blocks per SM).
//     The product runs on mma.sync m16n8k16 (bf16 in, fp32 sums): the 16
//     batch rows are the M side, each warp takes 16 of a stage's 64 d (A:
//     x by ldmatrix, times the mask in fp32 and rounded to bf16 once; B: W0
//     by ldmatrix.trans); the 4 warps' sums add in warp order and the
//     partial goes to the workspace [sd, B, F]. More than 16 rows: further
//     16-row passes reread the split (from L2).
//   finish, without a second launch: each base block, after its partial is
//     written and fenced, adds one to its F tile's counter (an integer
//     atomicAdd). The block that brings a tile's count to sd is the last:
//     it sums that tile's base partials in split order and, once all su
//     splits of u are written, u's in split order, adds scale * u @ b[idx]
//     and writes y, then zeroes the counter. A
//     block's role comes from a ticket (an atomicAdd at its start), not
//     from blockIdx, and the first su tickets are the bottleneck's, so a
//     block waiting for u waits only on blocks already running. The
//     counters (ceil(F / 64) tiles, then u, tickets and finished tiles; an
//     int32 buffer the wrapper keeps zeroed per device) are left zeroed
//     and shared by the calls of one stream, which run in order.
//   A fractional mask is multiplied into x in fp32 and rounded to bf16 once
//   (2^-9 of the element; the path's masks are 0/1, where x*m is exact);
//   the bottleneck uses the fp32 product.
// The split plans are a function of (D, F, r, SM count) only, never of B,
// and no float atomics are used: a row's result is the same bits whatever
// rows sit beside it, how many there are, and in what order (continuous
// batching moves requests between slots). The mma's sum for an element
// reads only that element's row and column.

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

// the fp32 path's element type is a template parameter (T = float)
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// two adjacent W0 columns in one 8-byte load
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
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


// ---------------------------------------------------------------------------
// bf16: one launch, W0 through a cp.async ring onto mma.sync
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kBThreads = 128;             // 4 warps
constexpr int kBTileF = 64;                // columns per base block
constexpr int kBStageK = 64;               // d per ring stage
constexpr int kBStages = 6;                // ring depth
constexpr int kBULen = 128;                // d per bottleneck split
constexpr int kBLdW = kBTileF + 8;         // staged W0 row, bf16 (ldmatrix banks)
constexpr int kBLdX = kBStageK + 8;        // staged x row, bf16
constexpr int kBLdM = kBStageK + 4;        // staged mask row, fp32
// one ring stage: W0 [64][kBLdW] and x [16][kBLdX] bf16, mask [16][kBLdM]
// fp32 (bytes; each part a multiple of 16)
constexpr int kBStageW = kBStageK * kBLdW * 2;
constexpr int kBStageX = 16 * kBLdX * 2;
constexpr int kBStageBytes = kBStageW + kBStageX + 16 * kBLdM * 4;
constexpr int kBRingBytes = kBStages * kBStageBytes;
constexpr int kBBlocksPerSM = 2;  // by shared memory: 2 x ~96 KB

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16-byte asynchronous copy; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d += a (16 x 16, row-major) . b (16 x 8, column-major); bf16 in, fp32 sum
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A load with acquire semantics at GPU scope: what the releasing block wrote
// before its release is visible to this thread after it.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

size_t bf16_smem(int r) {
  return (size_t)kBRingBytes + 16ull * r * sizeof(float);
}

// Ring slot `slot` <- stage k of the block's split: W0 rows d_lo .. d_lo +
// 63, columns col0 .. col0 + 63; x (and the mask) rows g0 .. g0 + 15, the
// same d. Rows at or past d1 or B and columns at or past F are zero.
template <bool kVec>
__device__ __forceinline__ void stage(unsigned char* ring, int slot,
                                      const bf16* __restrict__ w0,
                                      const bf16* __restrict__ x,
                                      const float* __restrict__ mask, int B,
                                      int D, int F, int g0, int d_lo, int d1,
                                      int col0) {
  unsigned char* base = ring + slot * kBStageBytes;
  bf16* ws = reinterpret_cast<bf16*>(base);
  bf16* xs = reinterpret_cast<bf16*>(base + kBStageW);
  float* ms = reinterpret_cast<float*>(base + kBStageW + kBStageX);
  const int tid = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int u = 0; u < kBStageK * kBTileF / 8 / kBThreads; ++u) {
      const int e = tid + kBThreads * u;
      const int row = e >> 3, c = (e & 7) * 8;
      const int d = d_lo + row, f = col0 + c;
      const bool ok = d < d1 && f < F;
      cp_async16(ws + row * kBLdW + c,
                 ok ? w0 + (long long)d * F + f : w0, ok ? 16 : 0);
    }
    {  // x: 16 rows x 8 chunks, one per thread
      const int i = tid >> 3, c = (tid & 7) * 8, d = d_lo + c;
      const bool ok = g0 + i < B && d < d1;
      const long long off = ok ? (long long)(g0 + i) * D + d : 0;
      cp_async16(xs + i * kBLdX + c, x + off, ok ? 16 : 0);
      if (mask != nullptr) {
        cp_async16(ms + i * kBLdM + c, mask + off, ok ? 16 : 0);
        cp_async16(ms + i * kBLdM + c + 4, mask + off + (ok ? 4 : 0),
                   ok ? 16 : 0);
      }
    }
  } else {
    for (int e = tid; e < kBStageK * kBTileF; e += kBThreads) {
      const int row = e >> 6, c = e & 63;
      const int d = d_lo + row, f = col0 + c;
      ws[row * kBLdW + c] = (d < d1 && f < F) ? w0[(long long)d * F + f]
                                              : __float2bfloat16_rn(0.f);
    }
    for (int e = tid; e < 16 * kBStageK; e += kBThreads) {
      const int i = e >> 6, c = e & 63, d = d_lo + c;
      const bool ok = g0 + i < B && d < d1;
      const long long off = (long long)(g0 + i) * D + d;
      xs[i * kBLdX + c] = ok ? x[off] : __float2bfloat16_rn(0.f);
      if (mask != nullptr) ms[i * kBLdM + c] = ok ? mask[off] : 0.f;
    }
  }
}

// The last base block of F tile ft writes y for rows g0 .. g0 + 15: base
// partials summed in split order (taken before u is waited for), then u
// (its splits summed in split order) and scale * u @ b[idx]. Thread (column
// c, row phase r0) takes rows r0, r0 + 2, ...; a phase's loads are all in
// flight before their sums (__ldcg keeps program order), the sums in order.
constexpr int kBPer = 16 * kBTileF / kBThreads;  // rows per thread
constexpr int kBPre = 8;                          // b rows in registers

__device__ __forceinline__ void tile_partials(
    float (&base)[kBPer], int ft, int g0, const float* __restrict__ ws_base,
    int B, int F, int sd) {
  const int tid = threadIdx.x, r0 = tid / kBTileF;
  const int f = ft * kBTileF + tid % kBTileF, rows = min(16, B - g0);
#pragma unroll
  for (int k = 0; k < kBPer; ++k) base[k] = 0.f;
  if (f >= F) return;
  for (int p0 = 0; p0 < sd; p0 += 8) {
    float v[8][kBPer];
#pragma unroll
    for (int pp = 0; pp < 8; ++pp) {
      const float* part =
          ws_base + ((long long)(p0 + pp) * B + g0 + r0) * F + f;
#pragma unroll
      for (int k = 0; k < kBPer; ++k)
        v[pp][k] = (p0 + pp < sd && r0 + 2 * k < rows)
                       ? __ldcg(part + 2LL * k * F) : 0.f;
    }
#pragma unroll
    for (int pp = 0; pp < 8; ++pp)
#pragma unroll
      for (int k = 0; k < kBPer; ++k)
        if (p0 + pp < sd) base[k] += v[pp][k];
  }
}

__device__ __forceinline__ void tile_finish(
    const float (&base)[kBPer], const int (&slot)[kBPer], int ft, int g0,
    const float* __restrict__ u_part, const float* __restrict__ b,
    float scale, int B, int F, int r, int su, float* us, bf16* out) {
  const int tid = threadIdx.x, r0 = tid / kBTileF;
  const int f = ft * kBTileF + tid % kBTileF, rows = min(16, B - g0);
  float bv[kBPer][kBPre];  // b's first rows, loaded beside u's splits
#pragma unroll
  for (int k = 0; k < kBPer; ++k) {
    const float* bi = b + (long long)slot[k] * r * F + min(f, F - 1);
#pragma unroll
    for (int j = 0; j < kBPre; ++j)
      bv[k][j] = (j < r && r0 + 2 * k < rows) ? bi[(long long)j * F] : 0.f;
  }
  for (int e = tid; e < rows * r; e += kBThreads) {  // u, in split order
    float sum = 0.f;
    for (int p0 = 0; p0 < su; p0 += 16) {
      float v[16];
#pragma unroll
      for (int pp = 0; pp < 16; ++pp)
        v[pp] = p0 + pp < su
                    ? __ldcg(u_part + ((long long)(p0 + pp) * B + g0) * r + e)
                    : 0.f;
#pragma unroll
      for (int pp = 0; pp < 16; ++pp)
        if (p0 + pp < su) sum += v[pp];
    }
    us[e] = sum;
  }
  __syncthreads();
  if (f < F) {
#pragma unroll
    for (int k = 0; k < kBPer; ++k) {
      const int i = r0 + 2 * k;
      if (i >= rows) continue;
      float lora = 0.f;
#pragma unroll
      for (int j = 0; j < kBPre; ++j)
        if (j < r) lora += us[i * r + j] * bv[k][j];
      if (r > kBPre) {
        const float* bi = b + (long long)slot[k] * r * F + f;
        for (int j = kBPre; j < r; ++j)
          lora += us[i * r + j] * bi[(long long)j * F];
      }
      out[(long long)(g0 + i) * F + f] =
          __float2bfloat16_rn(base[k] + scale * lora);
    }
  }
  __syncthreads();
}

// Counters after the n_ft tile counters: the bottleneck splits written, the
// block tickets, and the finished tiles.
constexpr int kCU = 0, kCTicket = 1, kCDone = 2;

template <bool kVec>
__global__ void __launch_bounds__(kBThreads) bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w0,
    const float* __restrict__ a, const float* __restrict__ b,
    const int* __restrict__ idx, const float* __restrict__ mask, float scale,
    int B, int D, int F, int A, int r, int L, int sd, int su, int ug,
    float* __restrict__ ws_base, float* __restrict__ ws_u,
    int* __restrict__ counters, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  float* us = reinterpret_cast<float*>(smem_raw + kBRingBytes);
  __shared__ float ured[16][kBThreads];
  __shared__ long long arow[16];
  __shared__ int flag;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_ft = (F + kBTileF - 1) / kBTileF;
  int* more = counters + n_ft;

  // A block's work is its ticket, not its blockIdx: the su bottleneck
  // tickets go to the first blocks that run, so a base block that waits
  // for u below waits only on blocks that are running.
  // the first 16 rows' adapter slots, read beside the ticket (a bottleneck
  // block needs them first)
  const int slot0 = tid < 16 ? adapter(idx, min(tid, B - 1), A) : 0;
  if (tid == 0) {
    flag = atomicAdd(more + kCTicket, 1);
    if (flag == (int)gridDim.x - 1) more[kCTicket] = 0;  // all handed out
  }
  __syncthreads();
  const int ticket = flag;
  __syncthreads();

  // the bottleneck's blocks: su splits x ceil(B / ug) groups of ug rows
  const int nub = su * ((B + ug - 1) / ug);
  if (ticket < nub) {  // bottleneck: u_part[split, rows of the group, :]
    // per 16 rows and 8 columns at a time: the split's x [16][128] bf16,
    // mask [16][128] fp32 and the rows' adapters [16][128][8] fp32 are
    // staged in shared memory by 16-byte cp.async, all in flight at once;
    // then thread (j, lane) sums x*m*a over its 8 d per row and the 16
    // lanes add in lane order
    float* a_s = reinterpret_cast<float*>(ring);           // [16][128][8]
    float* m_s = a_s + 16 * kBULen * 8;                    // [16][128]
    bf16* x_s = reinterpret_cast<bf16*>(m_s + 16 * kBULen);  // [16][128]
    const int split = ticket % su, j = tid & 7, dl = tid >> 3;
    const int row_lo = (ticket / su) * ug, row_hi = min(B, row_lo + ug);
    const int h0 = split * kBULen, hl = min(kBULen, D - h0);
    const bool avec = r % 8 == 0 && (((uintptr_t)a) & 15) == 0;
    for (int i0 = row_lo; i0 < row_hi; i0 += 16) {
      const int nrow = min(16, row_hi - i0);
      __syncthreads();  // the previous readers of the stage are done
      if (tid < 16)  // each row's adapter, as an offset into a
        arow[tid] =
            (long long)(i0 == 0 ? slot0 : adapter(idx, min(i0 + tid, B - 1), A)) *
            D * r;
      if (kVec) {  // x and the mask: 16 rows x 16 (32) chunks
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = tid + kBThreads * k, ii = e >> 4, c = (e & 15) * 8;
          const bool ok = ii < nrow && c < hl;
          const long long off = ok ? (long long)(i0 + ii) * D + h0 + c : 0;
          cp_async16(x_s + ii * kBULen + c, x + off, ok ? 16 : 0);
          if (mask != nullptr) {
            cp_async16(m_s + ii * kBULen + c, mask + off, ok ? 16 : 0);
            cp_async16(m_s + ii * kBULen + c + 4, mask + off + (ok ? 4 : 0),
                       ok ? 16 : 0);
          }
        }
      } else {
        for (int e = tid; e < 16 * kBULen; e += kBThreads) {
          const int ii = e / kBULen, d = e - ii * kBULen;
          const bool ok = ii < nrow && d < hl;
          const long long off = (long long)(i0 + ii) * D + h0 + d;
          x_s[e] = ok ? x[off] : __float2bfloat16_rn(0.f);
          if (mask != nullptr) m_s[e] = ok ? mask[off] : 0.f;
        }
      }
      __syncthreads();  // arow
      for (int jc = 0; jc < r; jc += 8) {
        if (jc > 0) __syncthreads();  // the previous columns' readers
#pragma unroll 8
        for (int k = 0; k < nrow * (kBULen * 2 / kBThreads); ++k) {
          // e = tid + 128 k: row k / 2, 4 floats q of d = rem / 2
          const int ii = k >> 1, rem = tid + kBThreads * (k & 1);
          const int d = rem >> 1, q = (rem & 1) * 4;
          float* dst = a_s + (ii * kBULen + d) * 8 + q;
          const bool ok = ii < nrow && d < hl;
          const float* src = a + arow[ii] + (long long)(h0 + d) * r + jc + q;
          if (avec) {
            cp_async16(dst, ok ? src : a, ok ? 16 : 0);
          } else {
#pragma unroll
            for (int t = 0; t < 4; ++t)
              dst[t] = (ok && jc + q + t < r) ? src[t] : 0.f;
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        float acc[16];
#pragma unroll
        for (int ii = 0; ii < 16; ++ii) {
          acc[ii] = 0.f;
          if (ii >= nrow) continue;
#pragma unroll
          for (int t = 0; t < kBULen / 16; ++t) {
            const int d = dl + 16 * t;
            float xm = __bfloat162float(x_s[ii * kBULen + d]);
            if (mask != nullptr) xm *= m_s[ii * kBULen + d];
            acc[ii] += xm * a_s[(ii * kBULen + d) * 8 + j];
          }
        }
#pragma unroll
        for (int ii = 0; ii < 16; ++ii) ured[ii][tid] = acc[ii];
        __syncthreads();
        {
          const int ii = tid >> 3, jj = tid & 7;  // 16 rows x 8 columns
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < 16; ++t) sum += ured[ii][jj + 8 * t];
          if (ii < nrow && jc + jj < r)
            ws_u[((long long)split * B + i0 + ii) * r + jc + jj] = sum;
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(more + kCU, 1);  // this split of u is written
    return;
  }

  // the adapter slots of this thread's finishing rows (first 16-row
  // group), read now so that a finisher's b loads need no index load
  int slot[kBPer];
#pragma unroll
  for (int k = 0; k < kBPer; ++k)
    slot[k] = adapter(idx, min(tid / kBTileF + 2 * k, B - 1), A);
  const int bid = ticket - nub;
  const int ft = bid % n_ft, split = bid / n_ft;
  const int d0 = split * L, d1 = min(D, d0 + L);
  const int nk = (d1 - d0 + kBStageK - 1) / kBStageK;
  const int col0 = ft * kBTileF;
  float* wred = reinterpret_cast<float*>(ring);  // [4][16][64] after the loop

  for (int g0 = 0; g0 < B; g0 += 16) {
#pragma unroll
    for (int s = 0; s < kBStages - 1; ++s) {
      if (s < nk)
        stage<kVec>(ring, s, w0, x, mask, B, D, F, g0, d0 + s * kBStageK, d1,
                    col0);
      cp_async_commit();
    }
    float acc[kBTileF / 8][4];
#pragma unroll
    for (int n = 0; n < kBTileF / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int k = 0; k < nk; ++k) {
      cp_async_wait<kBStages - 2>();
      __syncthreads();  // stage k is in; slot (k - 1) % S is free
      const int nxt = k + kBStages - 1;
      if (nxt < nk)
        stage<kVec>(ring, nxt % kBStages, w0, x, mask, B, D, F, g0,
                    d0 + nxt * kBStageK, d1, col0);
      cp_async_commit();
      const unsigned char* base = ring + (k % kBStages) * kBStageBytes;
      const bf16* wst = reinterpret_cast<const bf16*>(base);
      const bf16* xst = reinterpret_cast<const bf16*>(base + kBStageW);
      const float* mst =
          reinterpret_cast<const float*>(base + kBStageW + kBStageX);
      // A: x rows 0-15, d 16 warp .. 16 warp + 15; times the mask in fp32,
      // rounded to bf16 once
      unsigned af[4];
      ldsm_x4(af, xst + (lane & 15) * kBLdX + 16 * warp + (lane >> 4) * 8);
      if (mask != nullptr) {
#pragma unroll
        for (int rg = 0; rg < 4; ++rg) {
          const int i = (lane >> 2) + 8 * (rg & 1);
          const int c = 16 * warp + 2 * (lane & 3) + 8 * (rg >> 1);
          const float2 m =
              *reinterpret_cast<const float2*>(mst + i * kBLdM + c);
          const __nv_bfloat162 v =
              *reinterpret_cast<const __nv_bfloat162*>(&af[rg]);
          const __nv_bfloat162 w = __floats2bfloat162_rn(
              __low2float(v) * m.x, __high2float(v) * m.y);
          af[rg] = *reinterpret_cast<const unsigned*>(&w);
        }
      }
#pragma unroll
      for (int dp = 0; dp < kBTileF / 16; ++dp) {
        unsigned bfr[4];
        ldsm_x4_t(bfr, wst + (16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                 kBLdW +
                             dp * 16 + (lane >> 4) * 8);
        mma(acc[2 * dp], af, bfr[0], bfr[1]);
        mma(acc[2 * dp + 1], af, bfr[2], bfr[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int n = 0; n < kBTileF / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (lane >> 2) + 8 * (e >> 1);
        const int c = n * 8 + 2 * (lane & 3) + (e & 1);
        wred[(warp * 16 + i) * kBTileF + c] = acc[n][e];
      }
    __syncthreads();
    for (int e = tid; e < 16 * kBTileF; e += kBThreads) {
      const int i = e / kBTileF, c = e - i * kBTileF;
      const int row = g0 + i, f = col0 + c;
      const float s = ((wred[e] + wred[16 * kBTileF + e]) +
                       wred[32 * kBTileF + e]) +
                      wred[48 * kBTileF + e];
      if (row < B && f < F)
        ws_base[((long long)split * B + row) * F + f] = s;
    }
    __syncthreads();  // wred is the ring of the next pass
  }
  // the last of the tile's sd base blocks finishes it, once u is written
  __threadfence();
  __syncthreads();
  if (tid == 0) flag = atomicAdd(counters + ft, 1) == sd - 1;
  __syncthreads();
  if (!flag) return;
  __threadfence();
  for (int g0 = 0; g0 < B; g0 += 16) {
    float base[kBPer];
    tile_partials(base, ft, g0, ws_base, B, F, sd);
    if (g0 == 0 && tid == 0) {
      while (ld_acquire(more + kCU) != nub) __nanosleep(32);
    }
    __syncthreads();
    tile_finish(base, slot, ft, g0, ws_u, b, scale, B, F, r, su, us, out);
    if (g0 + 16 < B) {
#pragma unroll
      for (int k = 0; k < kBPer; ++k)
        slot[k] = adapter(idx, min(g0 + 16 + tid / kBTileF + 2 * k, B - 1), A);
    }
  }
  if (tid == 0) {
    counters[ft] = 0;
    if (atomicAdd(more + kCDone, 1) == n_ft - 1) {  // the call's last tile
      more[kCU] = 0;
      more[kCDone] = 0;
    }
  }
}

int smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

// The dynamic shared memory a bf16_kernel launch may ask for: the card's
// per-block limit less the kernel's static shared memory; 0 on failure.
int configure_bf16(int limit) {
  int dyn = limit;
  const void* kernels[2] = {(const void*)bf16_kernel<true>,
                            (const void*)bf16_kernel<false>};
  for (const void* k : kernels) {
    cudaFuncAttributes at;
    if (cudaFuncGetAttributes(&at, k) != cudaSuccess) return 0;
    const int room = limit - (int)at.sharedSizeBytes;
    dyn = room < dyn ? room : dyn;
  }
  for (const void* k : kernels)
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn) != cudaSuccess)
      return 0;
  return dyn;
}

int launch_bf16(const void* x, const void* w0, const float* a, const float* b,
                const int* idx, const float* mask, float scale, int B, int D,
                int F, int A, int r, int L, int sd, int su, int ug,
                float* ws, int* counters, void* out, cudaStream_t stream) {
  // once, to the card's per-block limit, so a launch being captured into a
  // CUDA graph makes no attribute call
  static const int limit = configure_bf16(smem_limit());
  if (limit <= 0) return (int)cudaErrorInvalidValue;
  const long long n_ft = (F + kBTileF - 1) / kBTileF;
  const long long blocks = (long long)su * ((B + ug - 1) / ug) + n_ft * sd;
  const size_t smem = bf16_smem(r);
  if (L < kBStageK || L % kBStageK != 0 || sd != (D + L - 1) / L ||
      su != (D + kBULen - 1) / kBULen || ug < 1 || ug > 16 ||
      blocks > 0x7fffffff || smem > (size_t)limit)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need D and F multiples of 8 and aligned operands
  const bool vec =
      D % 8 == 0 && F % 8 == 0 &&
      (((uintptr_t)x | (uintptr_t)w0 | (uintptr_t)mask) & 15) == 0;
  auto kern = vec ? bf16_kernel<true> : bf16_kernel<false>;
  kern<<<(unsigned)blocks, kBThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w0), a, b, idx,
      mask, scale, B, D, F, A, r, L, sd, su, ug, ws,
      ws + (long long)sd * B * F,
      counters, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 path. Split counts for a shape on a card with `sms` SMs: out[0] = sd
// (base product), out[1] = su (bottleneck). Enough base blocks for ~4 per
// SM, each split at least kSplitMin rows of d. Independent of the batch
// size. (The bf16 path's plan is the wrapper's, from the geometry below.)
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

// bf16 path geometry, which the wrapper's planner must use: out = {columns
// per F tile, d per ring stage (L is a multiple), d per bottleneck split,
// blocks per SM}.
void mdlora_multi_bf16_geometry(int* out) {
  out[0] = kBTileF;
  out[1] = kBStageK;
  out[2] = kBULen;
  out[3] = kBBlocksPerSM;
}

// dtype 0 = fp32 (two launches; ws holds sd*B*F + su*B*r floats; L, ug
// and counters unused), 1 = bf16 (one launch; L the base split length, ug
// the rows per bottleneck block, ws
// holds sd*B*F + su*B*r floats, counters ceil(F / 64) + 3 zeroed
// int32, left zeroed).
// Returns a cudaError_t.
int mdlora_multi(const void* x, const void* w0, const float* a,
                 const float* b, const int* idx, const float* mask,
                 float scale, int B, int D, int F, int A, int r, int dtype,
                 int L, int sd, int su, int ug, float* ws, int* counters,
                 void* out, void* stream) {
  if (r < 1 || r > 256 || sd < 1 || su < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(x, w0, a, b, idx, mask, scale, B, D, F, A, r, L, sd,
                       su, ug, ws, counters, out, st);
  return launch<float>(x, w0, a, b, idx, mask, scale, B, D, F, A, r, sd, su,
                       ws, out, st);
}

}  // extern "C"
