// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a), with
// a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel
//   ssd_pallas  src/repro/kernels/ssd/kernel.py:65
// x [b, s, h, p] (fp32 or bf16), dt [b, s, h] fp32, A_log [h] fp32, B and C
// [b, s, n] in x's type (one group, shared by all heads), init [b, h, p, n]
// fp32 or null (zeros). Per chunk of Q steps, with a = -exp(A_log) * dt and
// cum its running sum in the chunk:
//   y     = (C Bᵀ ⊙ exp(cum_i - cum_j), i >= j) (x dt) + exp(cum) C stateᵀ
//   state = state exp(cum_last) + Bᵀ (x dt exp(cum_last - cum))
// -> y [b, s, h, p] in x's type, final_state [b, h, p, n] fp32; the state
// starts at init.
//
// Dispatch (the C entry `ssd`, explicit by dtype and shape, no fallback):
//   bf16, Q <= 128, n <= 128 (the serving shapes: Q 64, n 128 or 16)
//        -> chunk_kernel<QP, NP>, one launch, tensor cores (below).
//   fp32, or bf16 past those sizes
//        -> scores_kernel + scan_kernel, the first version: fp32 on the CUDA
//           cores, two launches (fp32 parity needs fp32 arithmetic).
//
// Bound: at the serving shapes (mamba2-1.3b: h 64, p 64, n 128, Q 64) the
// least time is device-memory bytes (x and y dominate) if the arithmetic
// runs on the bf16 tensor cores.
//
// chunk_kernel (bf16). One block of 4 warps per (32 columns of p, head,
// batch row): 512 blocks at mamba2's B=4, two per SM. It walks the chunks
// in order with its slice of the state [32, n] in fp32 registers (the mma
// accumulator layout) and never writes a chunk's state to device memory.
// Per chunk, C, B, x (its 32 columns) and dt are staged by cp.async into
// one of two buffers while the previous chunk computes. Warp 0 takes the
// running sums of the log-decays in fp64 (in log2 units), exp(cum) and the
// state weights w_j = dt_j exp(cum_last - cum_j), while the others start on
// the products. All products are mma.sync m16n8k16, bf16 in, fp32 sums,
// fed by ldmatrix; operands exact in bf16 (x, B, C) go in as they are, and
// each derived fp32 operand goes in as a bf16 hi + lo pair (two products;
// one rounding would break the parity bound, 2^-9 against ~1e-4):
//   G  = C Bᵀ over the causal 16 x 8 tiles only (exact operands);
//   yo = C Sᵀ (S hi + lo, published to shared memory after each chunk);
//   M  = G exp(cum_i - cum_j) dt_j for j <= i, from G's accumulators
//        straight into A fragments (masked before the exp), times x;
//   y  = M x + exp(cum_i) yo, written as bf16;
//   S  = S exp(cum_last) + (x w)ᵀ B, xᵀ by ldmatrix.trans scaled by w in
//        registers.
// Warp w owns y's row tiles w, w + 4, ...; warp (16 state rows, half of
// n) owns the state. Tiles are zero-padded in shared memory to
// QP = 64 or 128 rows and NP = 16, 64 or 128 columns (so Q = 10, p = 6,
// n = 5 need no other code); padding is zeroed once and never written. A
// misaligned or ragged row (n or p not a multiple of 8) is staged by plain
// loads. Every sum has a fixed order: repeated calls give the same bits.
//
// The fp32 version (scores_kernel, scan_kernel) does its arithmetic in fp32
// on the CUDA cores, so it is bound by operations: about 2 (Q p + 2 p n)
// flops per element of x, read from shared memory in 4 x 4 register tiles.
// Two launches:
//   1. scores: one block per (chunk, batch row) writes G = C Bᵀ [Q, Q] to a
//      workspace [b, s/Q, Q, Q] fp32. The reference has a single group, so
//      C Bᵀ is the same for every head of a batch row: computed once here
//      instead of once per head in launch 2, where it would be a third of
//      the flops at mamba2's shapes (Q² n against Q p n per head), for 4 MB
//      of writes at b = 4, s = 4096.
//   2. scan: one block per (head, batch row) walks the chunks in order with
//      the state [p, n] in fp32 shared memory. Per chunk it stages C [Q, n],
//      (x dt)ᵀ [p, Q] and the log-decays in shared memory; warp 0 takes
//      their running sum in fp64 in a fixed order (shuffle scan); the
//      decayed, masked scores M [Q, Q] come from G (the mask is applied
//      before exp: exp of the upper triangle would overflow); y = exp(cum)
//      C Sᵀ + M (x dt) in 4 x 4 register tiles; then Bᵀ [n, Q] replaces C
//      in shared memory and the state is updated in place, each element by
//      one thread.
//      104 KB of shared memory at mamba2's shapes, so two blocks per SM.
// Both versions: the running sums of the log-decays reach ~1000 within a
// chunk at the models' A = 1..16, so exp(cum_i - cum_j) taken from fp32
// sums carries a relative error of a few ulps of 1000 (~1e-4) on the
// largest terms. The sums are kept in fp64 and each difference is rounded
// to fp32 once, so a decay's error is a few ulps of its own exponent; the
// log-decays a themselves are fp32, as in the reference.
// Shared tiles are zero-padded to multiples of 4 (any Q, p, n up to the
// shared-memory limit) and their row strides are 4 mod 8 floats, so the
// float4 loads of 8 consecutive rows fall in distinct banks. No float
// atomics: repeated calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ __forceinline__ int padded(int v) { return (v + 3) & ~3; }

// row stride (floats) of a [rows][cols] shared tile: >= cols, 4 mod 8
__host__ __device__ __forceinline__ int row_stride(int cols) {
  const int s = padded(cols);
  return (s % 8 == 4) ? s : s + 4;
}

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

// acc[i][j] += sum_{k < K} A[(r + rs i) lda + k] * Bt[(c + cs j) ldb + k]:
// a 4 x 4 tile of rows r, r + rs, ... and columns c, c + cs, ... of A Btᵀ,
// with both operands row-major over k in shared memory (K a multiple of 4)
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         int lda, int r, int rs,
                                         const float* Bt, int ldb, int c,
                                         int cs, int K) {
  for (int k = 0; k < K; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r + rs * i) * lda + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bt + (c + cs * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[i][j];
        v = fmaf(a[i].x, b[j].x, v);
        v = fmaf(a[i].y, b[j].y, v);
        v = fmaf(a[i].z, b[j].z, v);
        v = fmaf(a[i].w, b[j].w, v);
        acc[i][j] = v;
      }
  }
}

size_t scores_smem(int Q, int n) {
  return 2ull * padded(Q) * row_stride(n) * sizeof(float);
}

size_t scan_smem(int Q, int p, int n) {
  const size_t Qp = padded(Q), Pp = padded(p), Np = padded(n);
  const size_t ns = row_stride(n), qs = row_stride(Q);
  const size_t cb = Qp * ns > Np * qs ? Qp * ns : Np * qs;
  return (cb + Pp * qs + Pp * ns + Qp * qs) * sizeof(float) +
         Qp * sizeof(double);
}

// launch 1: G[b, c] = C_c B_cᵀ, one block per (chunk c, batch row b)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scores_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                  float* __restrict__ G, int s, int n, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int Qp = padded(Q), Np = padded(n), ns = row_stride(n), Q4 = Qp / 4;
  float* Cs = smem;            // [Qp][ns]
  float* Bs = smem + Qp * ns;  // [Qp][ns]
  const long long row0 = (long long)b * s + (long long)c * Q;
  for (int e = threadIdx.x; e < Qp * Np; e += kThreads) {
    const int i = e / Np, k = e % Np;
    const bool in = i < Q && k < n;
    const long long g = (row0 + i) * n + k;
    Cs[i * ns + k] = in ? to_float(Cm[g]) : 0.f;
    Bs[i * ns + k] = in ? to_float(Bm[g]) : 0.f;
  }
  __syncthreads();
  float* Gc = G + ((long long)b * nc + c) * Q * Q;
  for (int t = threadIdx.x; t < Q4 * Q4; t += kThreads) {
    const int tj = t % Q4, ti = t / Q4;
    float acc[4][4] = {};
    tile_dot(acc, Cs, ns, ti, Q4, Bs, ns, tj, Q4, Np);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = ti + Q4 * a, jj = tj + Q4 * j;
        if (i < Q && jj < Q) Gc[i * Q + jj] = acc[a][j];
      }
  }
}

// launch 2: the chunk walk of one (head hh, batch row b)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ G,
                const float* __restrict__ init, T* __restrict__ y,
                float* __restrict__ final_state, int s, int h, int p, int n,
                int Q) {
  extern __shared__ __align__(16) float smem[];
  const int hh = blockIdx.x, b = blockIdx.y, nc = s / Q;
  const int tid = threadIdx.x, lane = tid & 31;
  const int Qp = padded(Q), Pp = padded(p), Np = padded(n);
  const int ns = row_stride(n), qs = row_stride(Q);
  const int Q4 = Qp / 4, P4 = Pp / 4, N4 = Np / 4;
  const int cb = Qp * ns > Np * qs ? Qp * ns : Np * qs;
  float* CB = smem;           // C [Qp][ns], then Bᵀ [Np][qs]
  float* XT = CB + cb;        // (x dt)ᵀ [Pp][qs]
  float* S = XT + Pp * qs;    // state [Pp][ns]
  float* M = S + Pp * ns;     // decayed, masked scores [Qp][qs]
  // running sums of the log-decays [Qp], fp64 (8-byte aligned: every tile
  // above is a multiple of 4 floats)
  double* cum = reinterpret_cast<double*>(M + Qp * qs);
  const float neg_A = -expf(A_log[hh]);
  const float* s0 = init ? init + ((long long)b * h + hh) * p * n : nullptr;
  for (int e = tid; e < Pp * ns; e += kThreads) {
    const int q = e / ns, k = e % ns;
    S[e] = (s0 && q < p && k < n) ? s0[q * n + k] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const long long row0 = (long long)b * s + (long long)c * Q;
    // stage C, (x dt)ᵀ and the log-decays a = -exp(A_log) dt
    for (int e = tid; e < Qp * Np; e += kThreads) {
      const int i = e / Np, k = e % Np;
      CB[i * ns + k] =
          (i < Q && k < n) ? to_float(Cm[(row0 + i) * n + k]) : 0.f;
    }
    for (int e = tid; e < Qp * Pp; e += kThreads) {
      const int i = e / Pp, q = e % Pp;
      float v = 0.f;
      if (i < Q && q < p)
        v = to_float(x[((row0 + i) * h + hh) * p + q]) *
            dt[(row0 + i) * h + hh];
      XT[q * qs + i] = v;
    }
    for (int i = tid; i < Qp; i += kThreads)
      cum[i] = i < Q ? (double)(neg_A * dt[(row0 + i) * h + hh]) : 0.0;
    __syncthreads();
    // running sum of the log-decays, 32 at a time, in a fixed order
    if (tid < 32) {
      double carry = 0.0;
      for (int base = 0; base < Qp; base += 32) {
        const int i = base + lane;
        double v = i < Qp ? cum[i] : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (i < Qp) cum[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const double last = cum[Q - 1];
    // M[i][j] = G[i][j] exp(cum_i - cum_j) for j <= i, else 0 (masked
    // before exp)
    const float* Gc = G + ((long long)b * nc + c) * Q * Q;
    for (int e = tid; e < Qp * Qp; e += kThreads) {
      const int i = e / Qp, j = e % Qp;
      M[i * qs + j] = (j <= i && i < Q)
                          ? Gc[i * Q + j] * expf((float)(cum[i] - cum[j]))
                          : 0.f;
    }
    __syncthreads();
    // y = exp(cum) C Sᵀ + M (x dt): rows i, columns q
    for (int t = tid; t < Q4 * P4; t += kThreads) {
      const int tq = t % P4, ti = t / P4;
      float acc[4][4] = {};
      tile_dot(acc, CB, ns, ti, Q4, S, ns, tq, P4, Np);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float d = expf((float)cum[ti + Q4 * a]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] *= d;
      }
      tile_dot(acc, M, qs, ti, Q4, XT, qs, tq, P4, Qp);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = ti + Q4 * a, q = tq + P4 * j;
          if (i < Q && q < p)
            y[((row0 + i) * h + hh) * p + q] = from_float<T>(acc[a][j]);
        }
    }
    __syncthreads();
    // Bᵀ replaces C; (x dt) decays to the chunk's end
    for (int e = tid; e < Qp * Np; e += kThreads) {
      const int i = e / Np, k = e % Np;
      CB[k * qs + i] =
          (i < Q && k < n) ? to_float(Bm[(row0 + i) * n + k]) : 0.f;
    }
    for (int e = tid; e < Pp * Qp; e += kThreads) {
      const int q = e / Qp, i = e % Qp;
      XT[q * qs + i] *= expf((float)(last - cum[i]));
    }
    __syncthreads();
    // state = state exp(cum_last) + (x dt decayed)ᵀ B: rows q, columns k
    const float chunk_decay = expf((float)last);
    for (int t = tid; t < P4 * N4; t += kThreads) {
      const int tk = t % N4, tq = t / N4;
      float acc[4][4] = {};
      tile_dot(acc, XT, qs, tq, P4, CB, qs, tk, N4, Qp);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& st = S[(tq + P4 * a) * ns + tk + N4 * j];
          st = st * chunk_decay + acc[a][j];
        }
    }
    __syncthreads();
  }
  float* fs = final_state + ((long long)b * h + hh) * p * n;
  for (int e = tid; e < p * n; e += kThreads) fs[e] = S[(e / n) * ns + e % n];
}

int smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

template <typename T>
cudaError_t configure(int limit) {
  cudaError_t err = cudaFuncSetAttribute(
      scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
}

template <typename T>
int launch(const void* x, const float* dt, const float* A_log, const void* Bm,
           const void* Cm, const float* init, float* G, void* y,
           float* final_state, int b, int s, int h, int p, int n, int Q,
           cudaStream_t st) {
  // once per instantiation, to the card's per-block limit, so a launch
  // being captured into a CUDA graph makes no attribute call
  static const int limit = smem_limit();
  static const cudaError_t configured = configure<T>(limit);
  if (configured != cudaSuccess) return (int)configured;
  const size_t s1 = scores_smem(Q, n), s2 = scan_smem(Q, p, n);
  if (s1 > (size_t)limit || s2 > (size_t)limit || b > 65535)
    return (int)cudaErrorInvalidValue;
  scores_kernel<T><<<dim3(s / Q, b), kThreads, s1, st>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), G, s, n, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<T><<<dim3(h, b), kThreads, s2, st>>>(
      static_cast<const T*>(x), dt, A_log, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), G, init, static_cast<T*>(y), final_state, s,
      h, p, n, Q);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: one launch, the chunk walk on mma.sync
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kCThreads = 128;  // 4 warps
constexpr int kPB = 32;         // p columns per block
constexpr int kLdX = kPB + 8;   // staged x row (ldmatrix banks)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// v = hi + lo in bf16 (to 2^-16 of v); packed as (v0, v1) pairs
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h),
                                                 v1 - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// 2^x, flushing subnormal results to zero (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of chunk_kernel<QP, NP> (element offsets in bf16 units):
// two buffers of {C [QP][LDN], B [QP][LDN], x [QP][kLdX]} bf16; two of dt
// [QP] fp32; the state's hi and lo halves [kPB][LDN] bf16; the running sums
// [QP] fp64 (in log2 units); exp(cum) and the state weights w [QP] fp32.
template <int QP, int NP>
struct ChunkSmem {
  static constexpr int LDN = NP + 8;
  static constexpr int kBuf = 2 * QP * LDN + QP * kLdX;
  static constexpr int kDt = 2 * kBuf;               // fp32 [2][QP]
  static constexpr int kS = kDt + 4 * QP;            // bf16 [2][kPB][LDN]
  static constexpr int kCum = kS + 2 * kPB * LDN;    // fp64 [QP]
  static constexpr int kEnd = kCum + 4 * QP + 4 * QP;  // + 2 fp32 [QP]
  static constexpr size_t bytes = 2ull * kEnd;
};

template <int QP, int NP>
__global__ void __launch_bounds__(kCThreads) chunk_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A_log, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ init,
    bf16* __restrict__ y, float* __restrict__ final_state, int s, int h,
    int p, int n, int Q, int vec) {
  using L = ChunkSmem<QP, NP>;
  constexpr int LDN = L::LDN;
  constexpr int NTW = NP >= 32 ? NP / 16 : 2;  // state n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  float* dts = reinterpret_cast<float*>(sm + L::kDt);
  bf16* Sh = sm + L::kS;
  bf16* Sl = Sh + kPB * LDN;
  double* cum = reinterpret_cast<double*>(sm + L::kCum);
  float* ecum = reinterpret_cast<float*>(cum + QP);
  float* wj = ecum + QP;

  const int n_ps = (p + kPB - 1) / kPB;
  const int ps = blockIdx.x % n_ps, hh = blockIdx.x / n_ps, b = blockIdx.y;
  const int q0 = ps * kPB, pw = min(kPB, p - q0), nc = s / Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float neg_A = -expf(A_log[hh]);

  // zero all of it once: padding rows and columns are never written again
  for (int e = tid; e < (int)(L::bytes / 16); e += kCThreads)
    reinterpret_cast<uint4*>(smem_raw)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // chunk c's C, B, x (this block's columns) and dt into buffer bi
  auto stage = [&](int c, int bi) {
    bf16* Cs = sm + bi * L::kBuf;
    bf16* Bs = Cs + QP * LDN;
    bf16* Xs = Bs + QP * LDN;
    float* dd = dts + bi * QP;
    const long long row0 = (long long)b * s + (long long)c * Q;
    if (vec) {
      const int cpr = n >> 3, xpr = pw >> 3;
      for (int e = tid; e < Q * cpr; e += kCThreads) {
        const int i = e / cpr, k = (e - i * cpr) * 8;
        cp_async16(Cs + i * LDN + k, Cm + (row0 + i) * n + k);
        cp_async16(Bs + i * LDN + k, Bm + (row0 + i) * n + k);
      }
      for (int e = tid; e < Q * xpr; e += kCThreads) {
        const int i = e / xpr, k = (e - i * xpr) * 8;
        cp_async16(Xs + i * kLdX + k, x + ((row0 + i) * h + hh) * p + q0 + k);
      }
    } else {
      for (int e = tid; e < Q * n; e += kCThreads) {
        const int i = e / n, k = e - i * n;
        Cs[i * LDN + k] = Cm[(row0 + i) * n + k];
        Bs[i * LDN + k] = Bm[(row0 + i) * n + k];
      }
      for (int e = tid; e < Q * pw; e += kCThreads) {
        const int i = e / pw, k = e - i * pw;
        Xs[i * kLdX + k] = x[((row0 + i) * h + hh) * p + q0 + k];
      }
    }
    for (int i = tid; i < Q; i += kCThreads)
      cp_async4(dd + i, dt + (row0 + i) * h + hh);
  };

  // the state [kPB][NP] in fp32 registers: warp (mq, nh) holds rows
  // 16 mq .. 16 mq + 15 and n-tiles nh NTW .. (NTW + 1) nh - 1, in the
  // mma accumulator layout (at NP = 16 warps nh = 0 hold all of it)
  const int mq = warp & 1, nh = warp >> 1;
  const bool state_warp = NP >= 32 || nh == 0;
  // y: warp mt0 takes row tiles mt0, mt0 + 4, ... and all 32 columns
  const int mt0 = warp;
  float st[NTW][4];
#pragma unroll
  for (int t = 0; t < NTW; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = mq * 16 + (lane >> 2) + 8 * (e >> 1);
      const int k = (nh * NTW + t) * 8 + 2 * (lane & 3) + (e & 1);
      st[t][e] = (init != nullptr && state_warp && q < pw && k < n)
                     ? init[(((long long)b * h + hh) * p + q0 + q) * n + k]
                     : 0.f;
    }
  // the state's bf16 hi and lo halves, the B operand of C Sᵀ
  auto publish_state = [&]() {
    if (!state_warp) return;
#pragma unroll
    for (int t = 0; t < NTW; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = mq * 16 + (lane >> 2) + 8 * hf;
        const int k = (nh * NTW + t) * 8 + 2 * (lane & 3);
        unsigned hi, lo;
        split2(st[t][2 * hf], st[t][2 * hf + 1], hi, lo);
        *reinterpret_cast<unsigned*>(Sh + q * LDN + k) = hi;
        *reinterpret_cast<unsigned*>(Sl + q * LDN + k) = lo;
      }
  };
  publish_state();
  stage(0, 0);
  cp_async_commit();

  const bool pair_store = (p % 2) == 0;
  constexpr double kLog2e = 1.4426950408889634;
  float g[QP / 8][4], yo[4][4];
  for (int c = 0; c < nc; ++c) {
    const int bi = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c is in; chunk c - 1's buffer is free
    if (c + 1 < nc) stage(c + 1, bi ^ 1);
    cp_async_commit();
    const bf16* Cs = sm + bi * L::kBuf;
    const bf16* Bs = Cs + QP * LDN;
    const bf16* Xs = Bs + QP * LDN;
    const float* dd = dts + bi * QP;
    const long long row0 = (long long)b * s + (long long)c * Q;

    // G = C Bᵀ over the causal tiles of row tile mt and yo = C Sᵀ (hi + lo)
    // share C's fragments; they need no decay, so the first tile's run
    // while warp 0 takes the running sums
    auto scores = [&](int mt) {
#pragma unroll
      for (int t = 0; t < QP / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) g[t][e] = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) yo[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        unsigned ca[4];
        ldsm_x4(ca, Cs + (mt * 16 + (lane & 15)) * LDN + kk * 16 +
                        (lane >> 4) * 8);
        const int boff = ((lane >> 4) * 8 + (lane & 7)) * LDN + kk * 16 +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < QP / 16; ++np) {
          if (np <= mt) {
            unsigned bb[4];
            ldsm_x4(bb, Bs + np * 16 * LDN + boff);
            mma(g[2 * np], ca, bb[0], bb[1]);
            mma(g[2 * np + 1], ca, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned sb[4];
          ldsm_x4(sb, Sh + np * 16 * LDN + boff);
          mma(yo[2 * np], ca, sb[0], sb[1]);
          mma(yo[2 * np + 1], ca, sb[2], sb[3]);
          ldsm_x4(sb, Sl + np * 16 * LDN + boff);
          mma(yo[2 * np], ca, sb[0], sb[1]);
          mma(yo[2 * np + 1], ca, sb[2], sb[3]);
        }
      }
    };
    // y for row tile mt: M = G exp(cum_i - cum_j) dt_j (j <= i) goes from
    // the accumulators to A fragments in hi + lo; y = M x + exp(cum) yo
    auto rows = [&](int mt) {
      float yd[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) yd[t][e] = 0.f;
      const int i0 = mt * 16 + (lane >> 2), i1 = i0 + 8;
      const double c0 = cum[i0], c1 = cum[i1];
#pragma unroll
      for (int kk = 0; kk < QP / 16; ++kk) {
        if (kk <= mt) {
          float m[2][4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? i0 : i1;
              const int j = (2 * kk + hf) * 8 + 2 * (lane & 3) + (e & 1);
              m[hf][e] = j <= i ? g[2 * kk + hf][e] *
                                      ex2((float)((e < 2 ? c0 : c1) - cum[j])) *
                                      dd[j]
                                : 0.f;
            }
          unsigned ah[4], al[4];
          split2(m[0][0], m[0][1], ah[0], al[0]);
          split2(m[0][2], m[0][3], ah[1], al[1]);
          split2(m[1][0], m[1][1], ah[2], al[2]);
          split2(m[1][2], m[1][3], ah[3], al[3]);
#pragma unroll
          for (int dp = 0; dp < 2; ++dp) {
            unsigned xb[4];
            ldsm_x4_t(xb, Xs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   kLdX +
                              dp * 16 + (lane >> 4) * 8);
            mma(yd[2 * dp], ah, xb[0], xb[1]);
            mma(yd[2 * dp + 1], ah, xb[2], xb[3]);
            mma(yd[2 * dp], al, xb[0], xb[1]);
            mma(yd[2 * dp + 1], al, xb[2], xb[3]);
          }
        }
      }
      const float e0 = ecum[i0], e1 = ecum[i1];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = hf ? i1 : i0;
          const int q = t * 8 + 2 * (lane & 3);
          if (i >= Q || q >= pw) continue;
          const float ed = hf ? e1 : e0;
          const float v0 = yd[t][2 * hf] + ed * yo[t][2 * hf];
          const float v1 = yd[t][2 * hf + 1] + ed * yo[t][2 * hf + 1];
          bf16* dst = y + ((row0 + i) * h + hh) * p + q0 + q;
          if (pair_store && q + 1 < pw) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            dst[0] = __float2bfloat16_rn(v0);
            if (q + 1 < pw) dst[1] = __float2bfloat16_rn(v1);
          }
        }
    };

    // running sums of the log-decays in fp64 (in log2 units), in a fixed
    // order; then exp(cum_i) and w_j = dt_j exp(cum_last - cum_j)
    if (warp == 0) {
      double carry = 0.0;
      for (int base = 0; base < QP; base += 32) {
        const int i = base + lane;
        double v = (double)(neg_A * dd[i]);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        cum[i] = v * kLog2e;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      __syncwarp();
      const double last = cum[Q - 1];
      for (int i = lane; i < QP; i += 32) {
        ecum[i] = ex2((float)cum[i]);
        wj[i] = dd[i] * ex2((float)(last - cum[i]));
      }
    }
    const bool first = mt0 * 16 < Q;
    if (first) scores(mt0);
    __syncthreads();
    if (first) rows(mt0);
    for (int mt = mt0 + 4; mt < QP / 16 && mt * 16 < Q; mt += 4) {
      scores(mt);
      rows(mt);
    }

    // state = state exp(cum_last) + (x w)ᵀ B: A = xᵀ by ldmatrix.trans,
    // scaled by w in registers (hi + lo); B from the staged B rows
    if (state_warp) {
      const float decay = ex2((float)cum[Q - 1]);
#pragma unroll
      for (int t = 0; t < NTW; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < QP / 16; ++kk) {
        if (kk * 16 >= Q) break;
        unsigned xa[4], ah[4], al[4];
        ldsm_x4_t(xa, Xs + (kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) *
                               kLdX +
                          mq * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int rg = 0; rg < 4; ++rg) {
          const int j = kk * 16 + 2 * (lane & 3) + 8 * (rg >> 1);
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
              &xa[rg]);
          split2(__low2float(xv) * wj[j], __high2float(xv) * wj[j + 1],
                 ah[rg], al[rg]);
        }
#pragma unroll
        for (int dp = 0; dp < NTW / 2; ++dp) {
          unsigned bb[4];
          ldsm_x4_t(bb, Bs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                 LDN +
                            nh * NTW * 8 + dp * 16 + (lane >> 4) * 8);
          mma(st[2 * dp], ah, bb[0], bb[1]);
          mma(st[2 * dp + 1], ah, bb[2], bb[3]);
          mma(st[2 * dp], al, bb[0], bb[1]);
          mma(st[2 * dp + 1], al, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp has read Sh / Sl of the previous state
    publish_state();
  }
  if (state_warp) {
    float* fs = final_state + (((long long)b * h + hh) * p + q0) * n;
#pragma unroll
    for (int t = 0; t < NTW; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = mq * 16 + (lane >> 2) + 8 * (e >> 1);
        const int k = (nh * NTW + t) * 8 + 2 * (lane & 3) + (e & 1);
        if (q < pw && k < n) fs[q * n + k] = st[t][e];
      }
  }
}

// (QP, NP) of a shape: Q <= 128 and n <= 128 run chunk_kernel, else 0
__host__ __forceinline__ int chunk_qp(int Q) { return Q <= 64 ? 64 : 128; }
__host__ __forceinline__ int chunk_np(int n) {
  return n <= 16 ? 16 : n <= 64 ? 64 : 128;
}
bool chunk_fits(int Q, int n) { return Q <= 128 && n <= 128; }

size_t chunk_smem(int Q, int n) {
  const int qp = chunk_qp(Q), np = chunk_np(n);
  if (qp == 64)
    return np == 16 ? ChunkSmem<64, 16>::bytes
                    : np == 64 ? ChunkSmem<64, 64>::bytes
                               : ChunkSmem<64, 128>::bytes;
  return np == 16 ? ChunkSmem<128, 16>::bytes
                  : np == 64 ? ChunkSmem<128, 64>::bytes
                             : ChunkSmem<128, 128>::bytes;
}

template <int QP, int NP>
int launch_chunk(const void* x, const float* dt, const float* A_log,
                 const void* Bm, const void* Cm, const float* init, void* y,
                 float* final_state, int b, int s, int h, int p, int n, int Q,
                 int limit, cudaStream_t st) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      chunk_kernel<QP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      limit);
  if (configured != cudaSuccess) return (int)configured;
  const size_t smem = ChunkSmem<QP, NP>::bytes;
  const long long blocks = (long long)((p + kPB - 1) / kPB) * h;
  if (smem > (size_t)limit || b > 65535 || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need n and p multiples of 8 and aligned operands
  const int vec =
      n % 8 == 0 && p % 8 == 0 &&
      (((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm) & 15) == 0;
  chunk_kernel<QP, NP><<<dim3((unsigned)blocks, b), kCThreads, smem, st>>>(
      static_cast<const bf16*>(x), dt, A_log, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), init, static_cast<bf16*>(y), final_state,
      s, h, p, n, Q, vec);
  return (int)cudaGetLastError();
}

int launch_chunk_any(const void* x, const float* dt, const float* A_log,
                     const void* Bm, const void* Cm, const float* init,
                     void* y, float* final_state, int b, int s, int h, int p,
                     int n, int Q, cudaStream_t st) {
  static const int limit = smem_limit();
  const int qp = chunk_qp(Q), np = chunk_np(n);
#define SSD_CHUNK(QPV, NPV)                                                 \
  if (qp == QPV && np == NPV)                                               \
    return launch_chunk<QPV, NPV>(x, dt, A_log, Bm, Cm, init, y, final_state, \
                                  b, s, h, p, n, Q, limit, st);
  SSD_CHUNK(64, 16)
  SSD_CHUNK(64, 64)
  SSD_CHUNK(64, 128)
  SSD_CHUNK(128, 16)
  SSD_CHUNK(128, 64)
  SSD_CHUNK(128, 128)
#undef SSD_CHUNK
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The plan of a call at (Q, p, n, dtype): out[0] = 1 when it runs
// chunk_kernel (bf16, Q <= 128, n <= 128), 0 for scores_kernel +
// scan_kernel; out[1] = the largest dynamic shared memory (bytes) its
// launches ask for; out[2] = the card's per-block limit; out[3] = 1 when it
// needs the G workspace (b * (s / Q) * Q * Q floats).
void ssd_plan(int Q, int p, int n, int dtype, long long* out) {
  const bool chunk = dtype == 1 && chunk_fits(Q, n);
  const size_t s1 = scores_smem(Q, n), s2 = scan_smem(Q, p, n);
  out[0] = chunk;
  out[1] = chunk ? (long long)chunk_smem(Q, n)
                 : (long long)(s1 > s2 ? s1 : s2);
  out[2] = smem_limit();
  out[3] = !chunk;
}

// dtype 0 = fp32, 1 = bf16 (x, B, C and y alike). init: [b, h, p, n] fp32
// or null (zeros). G: the workspace of the two-launch path, else unused.
// Dispatch, explicit: bf16 with Q <= 128 and n <= 128 -> chunk_kernel (one
// launch); otherwise scores_kernel + scan_kernel (fp32 arithmetic). Returns
// a cudaError_t.
int ssd(const void* x, const float* dt, const float* A_log, const void* Bm,
        const void* Cm, const float* init, float* G, void* y,
        float* final_state, int b, int s, int h, int p, int n, int Q,
        int dtype, void* stream) {
  if (b < 1 || h < 1 || p < 1 || n < 1 || Q < 1 || s < Q || s % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && chunk_fits(Q, n))
    return launch_chunk_any(x, dt, A_log, Bm, Cm, init, y, final_state, b, s,
                            h, p, n, Q, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, init, G, y,
                                 final_state, b, s, h, p, n, Q, st);
  return launch<float>(x, dt, A_log, Bm, Cm, init, G, y, final_state, b, s,
                       h, p, n, Q, st);
}

}  // extern "C"
