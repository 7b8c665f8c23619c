// Fused cohort-masked aggregation + Eq. 5 divergence statistics, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernels
//   cohort_agg_divergence_pallas        src/repro/kernels/cohort_agg/kernel.py:72
//   cohort_agg_divergence_quant_pallas  src/repro/kernels/cohort_agg/kernel.py:130
// Given client-stacked deltas [N, D, r] (fp32, or int8 codes with a
// per-client scale), combine weights W [N, D] and cohort mask C [N, D]:
//   agg  [D, r] = sum_n W[n,d] * x[n,d,:]                      (Eq. 3)
//   sq   [D]    = sum_n C[n,d] * ||x[n,d,:]||^2
//   mean [D, r] = sum_n C[n,d] * x[n,d,:] / max(cnt[d], 1)
//   cnt  [D]    = sum_n C[n,d]                                 (Eq. 5 stats)
// The int8 variant dequantizes in registers (x = q * scale[n]) and weights by
// W * (1 + staleness[n])^-a, so the fp32 stack never exists in device memory.
//
// Bound: device-memory bytes. Each input element is read once and feeds ~7
// flops, far below the card's flops-per-byte ridge.
//
// Design: the Pallas grid walks N in order with its accumulators resident in
// VMEM. Blocks on Hopper run in parallel and in no order, so the reduction
// over N is split in two stages:
//   stage 1  grid (element tiles of [D*r]) x (client splits). Each block
//            reduces its slice of clients into per-element fp32 partials in a
//            workspace (agg, cohort sum, squared sum; count per row).
//   stage 2  one thread per element sums the partials in split order and
//            finishes: the row reductions (sq over r, cnt) and mean / cnt.
// No float atomics anywhere: the result depends on the shape and the split
// count only, never on scheduling. The split over N is what occupies the SMs
// at fleet scale (N ~ 10^4); at the async path's own shape (N = 4) it is
// one split and the kernel is launch-bound. Threads own consecutive
// elements, so loads are coalesced; the ragged tail of D*r is masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

// Workspace layout for S splits and E = D*r elements:
//   [S, E] agg partials | [S, E] cohort sums | [S, E] squared sums | [S, D] counts
template <bool kQuant, bool kDiscount>
__global__ void __launch_bounds__(kThreads) partial_kernel(
    const void* __restrict__ x_raw, const float* __restrict__ scales,
    const float* __restrict__ W, const float* __restrict__ C,
    const float* __restrict__ staleness, float exponent, int N, int D, int r,
    float* __restrict__ ws) {
  const long long E = (long long)D * r;
  const int S = gridDim.y;
  const int split = blockIdx.y;
  const int chunk = (N + S - 1) / S;
  const int n0 = split * chunk;
  const int n1 = min(N, n0 + chunk);

  long long e[kPerThread];
  int row[kPerThread];
  bool valid[kPerThread];
  float acc_agg[kPerThread], acc_sum[kPerThread], acc_sq[kPerThread],
      acc_cnt[kPerThread];
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    e[k] = base + (long long)k * kThreads;
    valid[k] = e[k] < E;
    row[k] = valid[k] ? (int)(e[k] / r) : 0;
    acc_agg[k] = acc_sum[k] = acc_sq[k] = acc_cnt[k] = 0.f;
  }

  for (int n = n0; n < n1; ++n) {
    float x_scale = 1.f, w_scale = 1.f;
    if (kQuant) x_scale = scales[n];
    if (kDiscount) w_scale = powf(1.f + staleness[n], -exponent);
    const long long w0 = (long long)n * D;
    const long long x0 = (long long)n * E;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!valid[k]) continue;
      float x;
      if (kQuant) {
        x = (float)static_cast<const int8_t*>(x_raw)[x0 + e[k]] * x_scale;
      } else {
        x = static_cast<const float*>(x_raw)[x0 + e[k]];
      }
      const float w = W[w0 + row[k]] * w_scale;
      const float c = C[w0 + row[k]];
      acc_agg[k] += w * x;
      acc_sum[k] += c * x;
      acc_sq[k] += c * (x * x);
      acc_cnt[k] += c;
    }
  }

  float* p_agg = ws + (long long)split * E;
  float* p_sum = ws + (long long)(S + split) * E;
  float* p_sq = ws + (long long)(2 * S + split) * E;
  float* p_cnt = ws + 3LL * S * E + (long long)split * D;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (!valid[k]) continue;
    p_agg[e[k]] = acc_agg[k];
    p_sum[e[k]] = acc_sum[k];
    p_sq[e[k]] = acc_sq[k];
    if (e[k] % r == 0) p_cnt[row[k]] = acc_cnt[k];  // one writer per row
  }
}

__global__ void __launch_bounds__(kThreads) finish_kernel(
    const float* __restrict__ ws, int S, int D, int r, float* __restrict__ agg,
    float* __restrict__ sq, float* __restrict__ mean, float* __restrict__ cnt) {
  const long long E = (long long)D * r;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const float* p_agg = ws;
  const float* p_sum = ws + (long long)S * E;
  const float* p_sq = ws + 2LL * S * E;
  const float* p_cnt = ws + 3LL * S * E;
  if (i < E) {
    const long long d = i / r;
    float a = 0.f, m = 0.f, c = 0.f;
    for (int s = 0; s < S; ++s) {
      a += p_agg[s * E + i];
      m += p_sum[s * E + i];
      c += p_cnt[s * (long long)D + d];
    }
    agg[i] = a;
    mean[i] = m / fmaxf(c, 1.f);
  }
  if (i < D) {
    float q = 0.f, c = 0.f;
    for (int s = 0; s < S; ++s) {
      c += p_cnt[s * (long long)D + i];
      const float* row = p_sq + s * E + i * r;
      for (int j = 0; j < r; ++j) q += row[j];
    }
    sq[i] = q;
    cnt[i] = c;
  }
}

template <bool kQuant, bool kDiscount>
int launch(const void* x, const float* scales, const float* W, const float* C,
           const float* staleness, float exponent, int N, int D, int r,
           int splits, float* ws, float* agg, float* sq, float* mean,
           float* cnt, cudaStream_t stream) {
  const long long E = (long long)D * r;
  const dim3 grid1((unsigned)((E + kTile - 1) / kTile), (unsigned)splits);
  partial_kernel<kQuant, kDiscount><<<grid1, kThreads, 0, stream>>>(
      x, scales, W, C, staleness, exponent, N, D, r, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned grid2 = (unsigned)((E + kThreads - 1) / kThreads);  // E >= D
  finish_kernel<<<grid2, kThreads, 0, stream>>>(ws, splits, D, r, agg, sq,
                                                mean, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per stage-1 block; the wrapper sizes the split count from it.
int cohort_agg_tile() { return kTile; }

// fp32 uplink. ws holds (3 * D * r + D) * splits floats.
int cohort_agg_f32(const float* deltas, const float* W, const float* C, int N,
                   int D, int r, int splits, float* ws, float* agg, float* sq,
                   float* mean, float* cnt, void* stream) {
  return launch<false, false>(deltas, nullptr, W, C, nullptr, 0.f, N, D, r,
                              splits, ws, agg, sq, mean, cnt,
                              static_cast<cudaStream_t>(stream));
}

// int8 uplink; exponent == 0 takes the specialization without powf.
int cohort_agg_i8(const int8_t* q, const float* scales, const float* W,
                  const float* C, const float* staleness, float exponent,
                  int N, int D, int r, int splits, float* ws, float* agg,
                  float* sq, float* mean, float* cnt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exponent == 0.f) {
    return launch<true, false>(q, scales, W, C, staleness, exponent, N, D, r,
                               splits, ws, agg, sq, mean, cnt, s);
  }
  return launch<true, true>(q, scales, W, C, staleness, exponent, N, D, r,
                            splits, ws, agg, sq, mean, cnt, s);
}

}  // extern "C"
