// Online-softmax attention over the GQA layout, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes.
//
// Replaces the TPU kernel
//   flash_attention_pallas  src/repro/kernels/flash_attention/kernel.py:72
// q [B, S, K, G, hd], k/v [B, T, K, hd] (fp32 or bf16), q_pos [S], kv_pos [T]
// int32 -> out [B, S, K, G, hd] in q's type:
//   s    = (q * hd^-0.5) . k, then cap * tanh(s / cap) when softcapped
//   mask = q_pos >= kv_pos  &  q_pos - kv_pos < window  &  kv_pos >= 0
//   out  = softmax over the valid keys of s, times v; a row with no valid
//          key gives 0 (p is masked again after exp, as kernel.py:59 does).
//
// Bound: at decode (S = 1) the bytes of K and V; at prefill the operations
// (4 hd flops per valid (query, key) pair). This first version does its
// arithmetic in fp32 on the CUDA cores, not the tensor cores, so at prefill
// it sits well above the tensor-core bound; wgmma tiles are later work.
//
// Design: the Pallas grid walks the KV tiles in order with m, l, acc in VMEM
// scratch. Here one block owns (batch b, kv head k, a tile of query rows)
// and walks the KV tiles itself, so the running state never leaves
// registers. As in the TPU kernel the G heads of a group are folded into the
// rows (row = s * G + g), so a block reads each K/V tile once for all of
// them. Each warp owns R rows; each lane owns one key of a 32-key tile for
// the scores and hd/32 output columns for the accumulation. The max and the
// sum over a tile are xor-shuffle trees, whose result is the same bits on
// every lane, and the order of every sum is fixed: the output does not
// depend on scheduling. Q and K/V tiles are staged in shared memory as fp32;
// q and k rows are zero-padded to hd4 = hd rounded up to 4 columns (k rows
// to hd4 + 4, so the lanes' 16-byte reads of their keys fall in distinct
// banks) and the scores read four columns per load.
// Each thread starts a batch of up to 32 K and 32 V loads before storing
// any, so a tile's loads overlap (a block per SM at decode has no other
// work to hide their latency behind).
// Ragged S and T are masked in the kernel; a tile with no key visible to any
// row of the block is skipped, which changes no bit of the result (its p is
// all zero and its correction factor is exactly 1). The window test is done
// in 64 bits, so window may be int32 max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileT = 32;  // keys per tile: one per lane
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, m));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(~0u, x, m);
  return x;
}

__device__ __forceinline__ bool visible(int qp, int kp, long long window) {
  return kp >= 0 && qp >= kp && (long long)qp - (long long)kp < window;
}

__host__ __device__ __forceinline__ int pad4(int hd) { return (hd + 3) & ~3; }

size_t smem_bytes(int rows, int hd) {
  return sizeof(float) * ((size_t)rows * pad4(hd) +
                          (size_t)kTileT * (pad4(hd) + 4) +
                          (size_t)kTileT * hd) +
         sizeof(int) * (kTileT + 2);
}

// NPL: output columns per lane (hd <= 32 * NPL); R: query rows per warp
template <typename T, int NPL, int R>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    T* __restrict__ out, int S, int K, int G, int hd, int Tn,
    long long window, float cap, int has_cap) {
  constexpr int kRows = kWarps * R;
  // loads in flight per thread and tensor while staging a K/V tile
  constexpr int kLoads = 8 * NPL < 32 ? 8 * NPL : 32;
  extern __shared__ __align__(16) float smem[];
  const int hd4 = pad4(hd), ks_stride = hd4 + 4;
  float* qs = smem;                         // [kRows][hd4], pre-scaled
  float* ks = qs + kRows * hd4;             // [kTileT][hd4 + 4]
  float* vs = ks + kTileT * ks_stride;      // [kTileT][hd]
  int* kp = reinterpret_cast<int*>(vs + kTileT * hd);  // [kTileT]
  int* qrange = kp + kTileT;                // min, max q_pos of the block

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int n_rows = S * G;
  const int row0 = blockIdx.x * kRows;
  const float scale = 1.f / sqrtf((float)hd);

  for (int e = tid; e < kTileT * (ks_stride - hd); e += kThreads) {
    const int j = e / (ks_stride - hd);  // K's padding columns stay zero
    ks[j * ks_stride + hd + e % (ks_stride - hd)] = 0.f;
  }
  for (int e = tid; e < kRows * hd4; e += kThreads) {
    const int rr = row0 + e / hd4, d = e % hd4;
    float x = 0.f;
    if (rr < n_rows && d < hd) {
      const int s = rr / G, g = rr % G;
      x = to_float(q[(((long long)b * S + s) * K + kh) * G * (long long)hd +
                     (long long)g * hd + d]) * scale;
    }
    qs[e] = x;
  }
  if (tid == 0) {
    int lo = 0x7fffffff, hi = -0x7fffffff - 1;
    for (int i = 0; i < kRows && row0 + i < n_rows; ++i) {
      const int p = q_pos[(row0 + i) / G];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    qrange[0] = lo;
    qrange[1] = hi;
  }

  int my_qpos[R];
  bool my_valid[R];
  float m_run[R], l_run[R], acc[R][NPL];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rr = row0 + warp * R + i;
    my_valid[i] = rr < n_rows;
    my_qpos[i] = my_valid[i] ? q_pos[rr / G] : 0;
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NPL; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();
  const int q_lo = qrange[0], q_hi = qrange[1];

  for (int t0 = 0; t0 < Tn; t0 += kTileT) {
    bool live = false;
    if (tid < kTileT) {
      const int t = t0 + tid;
      const int p = t < Tn ? kv_pos[t] : -1;
      kp[tid] = p;
      // some row of the block may see this key (q_lo <= q_pos <= q_hi)
      live = p >= 0 && p <= q_hi && (long long)q_lo - (long long)p < window;
    }
    if (!__syncthreads_or(live)) continue;  // uniform: every thread skips
    // stage the tile: a batch of loads starts before any is stored, so
    // a thread has up to kLoads of each of K and V in flight
    for (int e0 = 0; e0 < kTileT * hd; e0 += kLoads * kThreads) {
      T kx[kLoads], vx[kLoads];  // raw: converted only when stored
#pragma unroll
      for (int it = 0; it < kLoads; ++it) {
        const int e = e0 + it * kThreads + tid, j = e / hd, t = t0 + j;
        kx[it] = vx[it] = from_float<T>(0.f);
        if (e < kTileT * hd && t < Tn) {
          const long long off =
              (((long long)b * Tn + t) * K + kh) * hd + (e - j * hd);
          kx[it] = k[off];
          vx[it] = v[off];
        }
      }
#pragma unroll
      for (int it = 0; it < kLoads; ++it) {
        const int e = e0 + it * kThreads + tid, j = e / hd;
        if (e < kTileT * hd) {
          ks[j * ks_stride + (e - j * hd)] = to_float(kx[it]);
          vs[e] = to_float(vx[it]);
        }
      }
    }
    __syncthreads();

    float sc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) sc[i] = 0.f;
    const float* krow = ks + lane * ks_stride;
    const float* qrow = qs + warp * R * hd4;
#pragma unroll 2
    for (int d = 0; d < hd4; d += 4) {
      const float4 kd = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 qd = *reinterpret_cast<const float4*>(qrow + i * hd4 + d);
        sc[i] += qd.x * kd.x;
        sc[i] += qd.y * kd.y;
        sc[i] += qd.z * kd.z;
        sc[i] += qd.w * kd.w;
      }
    }
    const int kpos = kp[lane];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float s = sc[i];
      if (has_cap) s = cap * tanhf(s / cap);
      const bool ok = my_valid[i] && visible(my_qpos[i], kpos, window);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m_run[i], warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + warp_sum(p);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < NPL; ++c) acc[i][c] *= corr;
      sc[i] = p;
    }
    for (int j = 0; j < kTileT; ++j) {
      const float* vrow = vs + j * hd;
      float vj[NPL];
#pragma unroll
      for (int c = 0; c < NPL; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < hd ? vrow[d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pj = __shfl_sync(~0u, sc[i], j);
#pragma unroll
        for (int c = 0; c < NPL; ++c) acc[i][c] += pj * vj[c];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!my_valid[i]) continue;
    const int rr = row0 + warp * R + i, s = rr / G, g = rr % G;
    const float l = fmaxf(l_run[i], 1e-30f);
    T* o = out + (((long long)b * S + s) * K + kh) * G * (long long)hd +
           (long long)g * hd;
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) o[d] = from_float<T>(acc[i][c] / l);
    }
  }
}

template <typename T, int NPL, int R>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* out, int B, int S, int K, int G, int hd,
           int Tn, long long window, float cap, int has_cap,
           cudaStream_t stream) {
  constexpr int kRows = kWarps * R;
  auto kern = flash_kernel<T, NPL, R>;
  // once per instantiation, for its largest hd (so a launch being captured
  // into a CUDA graph makes no attribute call)
  static const cudaError_t configured = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kRows, 32 * NPL));
  if (configured != cudaSuccess) return (int)configured;
  const size_t smem = smem_bytes(kRows, hd);
  const long long row_tiles = ((long long)S * G + kRows - 1) / kRows;
  if (row_tiles > 0x7fffffff || K > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_tiles, (unsigned)K, (unsigned)B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), S, K, G,
      hd, Tn, window, cap, has_cap);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int dispatch_hd(const void* q, const void* k, const void* v, const int* qp,
                const int* kp, void* out, int B, int S, int K, int G, int hd,
                int Tn, long long window, float cap, int has_cap,
                cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 1, R>(q, k, v, qp, kp, out, B, S, K, G, hd, Tn, window,
                           cap, has_cap, st);
  if (hd <= 64)
    return launch<T, 2, R>(q, k, v, qp, kp, out, B, S, K, G, hd, Tn, window,
                           cap, has_cap, st);
  if (hd <= 128)
    return launch<T, 4, R>(q, k, v, qp, kp, out, B, S, K, G, hd, Tn, window,
                           cap, has_cap, st);
  return launch<T, 8, R>(q, k, v, qp, kp, out, B, S, K, G, hd, Tn, window,
                         cap, has_cap, st);
}

template <typename T>
int dispatch_rows(const void* q, const void* k, const void* v, const int* qp,
                  const int* kp, void* out, int B, int S, int K, int G,
                  int hd, int Tn, long long window, float cap, int has_cap,
                  cudaStream_t st) {
  // few rows per (b, k) (decode): one row per warp keeps all four warps
  // busy; many rows (prefill): four rows per warp reuse each K element
  if ((long long)S * G >= 256)
    return dispatch_hd<T, 4>(q, k, v, qp, kp, out, B, S, K, G, hd, Tn,
                             window, cap, has_cap, st);
  return dispatch_hd<T, 1>(q, k, v, qp, kp, out, B, S, K, G, hd, Tn, window,
                           cap, has_cap, st);
}

}  // namespace

extern "C" {

// dtype 0 = fp32, 1 = bf16 (q, k, v and out alike). Returns a cudaError_t.
int flash_attention(const void* q, const void* k, const void* v,
                    const int* q_pos, const int* kv_pos, void* out, int B,
                    int S, int K, int G, int hd, int T, int dtype,
                    long long window, float softcap, int has_softcap,
                    void* stream) {
  if (hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_rows<__nv_bfloat16>(q, k, v, q_pos, kv_pos, out, B, S, K,
                                        G, hd, T, window, softcap,
                                        has_softcap, st);
  return dispatch_rows<float>(q, k, v, q_pos, kv_pos, out, B, S, K, G, hd, T,
                              window, softcap, has_softcap, st);
}

}  // extern "C"
