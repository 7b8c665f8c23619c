// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a), with
// a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel
//   ssd_pallas  src/repro/kernels/ssd/kernel.py:65
// x [b, s, h, p] (fp32 or bf16), dt [b, s, h] fp32, A_log [h] fp32, B and C
// [b, s, n] in x's type (one group, shared by all heads). Per chunk of Q
// steps, with a = -exp(A_log) * dt and cum its running sum in the chunk:
//   y     = (C Bᵀ ⊙ exp(cum_i - cum_j), i >= j) (x dt) + exp(cum) C stateᵀ
//   state = state exp(cum_last) + Bᵀ (x dt exp(cum_last - cum))
// -> y [b, s, h, p] in x's type, final_state [b, h, p, n] fp32. The state
// starts at zero.
//
// Bound: at the serving shapes (mamba2-1.3b: h 64, p 64, n 128, Q 64) the
// least time is device-memory bytes (x and y dominate) if the arithmetic
// ran on the bf16 tensor cores. This first kernel does its arithmetic in
// fp32 on the CUDA cores, so it is bound by operations: about 2 (Q p + 2 p n)
// flops per element of x, read from shared memory in 4 x 4 register tiles.
//
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
// The running sums of the log-decays reach ~1000 within a chunk at the
// models' A = 1..16, so exp(cum_i - cum_j) taken from fp32 sums carries a
// relative error of a few ulps of 1000 (~1e-4) on the largest terms. The
// sums are kept in fp64 and each difference is rounded to fp32 once, so a
// decay's error is a few ulps of its own exponent; the log-decays a
// themselves are fp32, as in the reference.
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
                T* __restrict__ y, float* __restrict__ final_state, int s,
                int h, int p, int n, int Q) {
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
  for (int e = tid; e < Pp * ns; e += kThreads) S[e] = 0.f;

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
           const void* Cm, float* G, void* y, float* final_state, int b,
           int s, int h, int p, int n, int Q, cudaStream_t st) {
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
      static_cast<const T*>(Cm), G, static_cast<T*>(y), final_state, s, h, p,
      n, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[0], out[1]: shared memory (bytes) of the scores and scan launches at
// (Q, p, n); out[2]: the card's per-block limit.
void ssd_plan(int Q, int p, int n, long long* out) {
  out[0] = (long long)scores_smem(Q, n);
  out[1] = (long long)scan_smem(Q, p, n);
  out[2] = smem_limit();
}

// dtype 0 = fp32, 1 = bf16 (x, B, C and y alike). G: workspace of
// b * (s / Q) * Q * Q floats. Returns a cudaError_t.
int ssd(const void* x, const float* dt, const float* A_log, const void* Bm,
        const void* Cm, float* G, void* y, float* final_state, int b, int s,
        int h, int p, int n, int Q, int dtype, void* stream) {
  if (b < 1 || h < 1 || p < 1 || n < 1 || Q < 1 || s < Q || s % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, G, y, final_state, b,
                                 s, h, p, n, Q, st);
  return launch<float>(x, dt, A_log, Bm, Cm, G, y, final_state, b, s, h, p,
                       n, Q, st);
}

}  // extern "C"
