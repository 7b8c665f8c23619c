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
// flops, far below the card's flops-per-byte ridge. The least bytes per call
// are 4 N D r + 8 N D (fp32) and N D r + 8 N D + 8 N (int8), plus 8 D (r + 1)
// of outputs: at the fleet's 16384 x 1024 x 4, 402.7 MB (120.2 us at 3.35
// TB/s) and 201.5 MB (60.1 us). W and C are 134 MB of either.
//
// The Pallas grid walks N in order with its accumulators resident in VMEM.
// Blocks on Hopper run in parallel and in no order, so the reduction over N
// is split over blocks, and no float atomics are used anywhere: the result
// depends on the shape and the plan only, never on scheduling.
//
// One kernel serves both uplinks: agg_kernel, one launch. Its load stage
// (F32Uplink, I8Uplink) is the only part that knows the uplink's type: the
// raw span it loads, how the span unpacks to floats, whether a per-client
// scale exists, and how many clients' loads it keeps in flight.
//   * Blocks of 256 threads = (span threads) x (client lanes). A span is 4
//     consecutive elements of a row (one float4 / char4 load) when r % 4 ==
//     0, else one. A tile is whole rows, as many as the span threads cover
//     (the path's r = 128: one row of 32 spans per 32 threads; the fleet's
//     r = 4: 32 rows, so a warp reads 512 contiguous bytes of fp32 deltas
//     and 128 of W and of C); a row wider than 256 spans is walked in
//     passes. Lane l of a block's split takes clients n0 + l, n0 + l +
//     lanes, ..., so even N = 4 keeps every load of a tile in flight at once.
//   * W[n, d] and C[n, d] are read once per span, not once per element.
//     int8: the per-client scalars (scale, scale * (1 + staleness)^-a) are
//     computed by one thread per client for the warp's next 32 clients and
//     broadcast by shuffle; codes are summed as codes: agg += (W f_n) q, sum
//     += (C s_n) q, sq += (C s_n^2) |q|^2. fp32 has no scalars (no shuffle):
//     agg += W x, sum += C x, sq += C |x|^2.
//   * Clients go kUnroll at a time, every load of the group issued before
//     any use: 4 x 12 bytes per thread in flight for int8, 2 x 24 bytes for
//     fp32 (a float4 is 4 registers). A thread has 64 registers at 4 blocks
//     per SM: int8 at 8 clients and fp32 at 4 or 8 spilled, and each ran
//     slower at fleet scale on an H100. Streaming loads (__ldcs) of the
//     fp32 deltas, read once, were no faster and are not used.
//   * Stage 1 keeps the row statistics: the lanes add in lane order, then
//     the spans of each row in span order; a split's partials are [S, E]
//     for agg and the cohort sum and [S, D] for sq and cnt.
//   * One launch: with S > 1 splits each block writes its partials, fences
//     and takes an integer atomicAdd ticket on its tile's counter; the
//     tile's last block sums the S partials in split order (__ldcg, eight
//     splits' loads in flight before their adds), writes agg, sq, mean and
//     cnt, and zeroes the counter. With S = 1 the block writes the outputs
//     itself. The counters are an int32 buffer per device that the wrapper
//     keeps zeroed; the calls of a stream run in order.
//   * The plan (rows per tile, lanes, S) comes from the wrapper's plan_agg,
//     a function of (N, D, r, SM count) for both uplinks: all blocks
//     resident in one wave where N allows, at most 4 blocks of 256 threads
//     per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kAThreads = 256;
constexpr int kABlocksPerSM = 4;  // resident blocks per SM the plan assumes
constexpr int kSumBatch = 8;      // splits whose partials load before adding

// The load stages: V elements of one client at a time -> floats, and the
// per-client scale. The rest of agg_kernel sees only floats.
struct F32Uplink {
  using Code = float;
  template <int V>
  using Raw = typename std::conditional<V == 4, float4, float>::type;
  static constexpr bool kScaled = false;
  static constexpr int kUnroll = 2;  // clients whose loads are in flight
  template <int V>
  __device__ static Raw<V> load(const Code* p) {
    return *reinterpret_cast<const Raw<V>*>(p);
  }
  __device__ static void unpack(float4 c, float (&v)[4]) {
    v[0] = c.x;
    v[1] = c.y;
    v[2] = c.z;
    v[3] = c.w;
  }
  __device__ static void unpack(float c, float (&v)[1]) { v[0] = c; }
  __device__ static float scale(const float*, int) { return 1.f; }
};

struct I8Uplink {
  using Code = int8_t;
  template <int V>
  using Raw = typename std::conditional<V == 4, char4, signed char>::type;
  static constexpr bool kScaled = true;
  static constexpr int kUnroll = 4;
  template <int V>
  __device__ static Raw<V> load(const Code* p) {
    return *reinterpret_cast<const Raw<V>*>(p);
  }
  __device__ static void unpack(char4 c, float (&v)[4]) {
    v[0] = (float)c.x;
    v[1] = (float)c.y;
    v[2] = (float)c.z;
    v[3] = (float)c.w;
  }
  __device__ static void unpack(signed char c, float (&v)[1]) {
    v[0] = (float)c;
  }
  __device__ static float scale(const float* scales, int n) {
    return scales[n];
  }
};

// Per-block shared memory: the lanes' partials of one pass, then the span
// and row statistics.
template <int V>
struct AggSmem {
  float red[kAThreads][2 * V + 2];  // per thread: agg[V], sum[V], sq, cnt
  float span_sq[kAThreads], span_cnt[kAThreads];
  float row_sq[kAThreads], row_cnt[kAThreads];
  int last;
};

// Partials, in the workspace: [S, E] agg | [S, E] cohort sum | [S, D] sq |
// [S, D] cnt.
template <class Up, int V, bool kDisc>
__global__ void __launch_bounds__(kAThreads, kABlocksPerSM) agg_kernel(
    const typename Up::Code* __restrict__ q, const float* __restrict__ scales,
    const float* __restrict__ W, const float* __restrict__ C,
    const float* __restrict__ staleness, float exponent, int N, int D, int r,
    int rows, int lanes, int S, float* __restrict__ ws,
    int* __restrict__ counters, float* __restrict__ agg,
    float* __restrict__ sq, float* __restrict__ mean,
    float* __restrict__ cnt) {
  constexpr int kUnroll = Up::kUnroll;
  constexpr bool kScalars = Up::kScaled || kDisc;
  __shared__ AggSmem<V> sm;
  const int tid = threadIdx.x, wl = tid & 31;
  const int ts = kAThreads / lanes, p = tid % ts, l = tid / ts;
  const int n_tiles = (D + rows - 1) / rows;
  const int tile = blockIdx.x % n_tiles, split = blockIdx.x / n_tiles;
  const int d0 = tile * rows, nrow = min(rows, D - d0);
  const int sr = r / V, spans = nrow * sr;
  const int chunk = (N + S - 1) / S, n0 = split * chunk;
  const int n1 = min(N, n0 + chunk);
  // this lane's clients: n0 + l + k * lanes, k < nl (a warp is one lane)
  const int nl = n1 - n0 > l ? (n1 - n0 - l + lanes - 1) / lanes : 0;
  const long long E = (long long)D * r;
  float* ws_agg = ws;
  float* ws_sum = ws + (long long)S * E;
  float* ws_sq = ws + 2LL * S * E;
  float* ws_cnt = ws_sq + (long long)S * D;
  if (tid < nrow) sm.row_sq[tid] = sm.row_cnt[tid] = 0.f;

  for (int s0 = 0; s0 < spans; s0 += ts) {  // passes: rows wider than ts
    const int span = s0 + p;
    const bool active = span < spans;
    const int row = d0 + (active ? span / sr : 0);
    const long long off = (long long)row * r + (active ? (span % sr) * V : 0);
    float aq[V], mq[V], sqv = 0.f, cn = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) aq[v] = mq[v] = 0.f;
    for (int kb = 0; kb < nl; kb += 32) {
      // thread wl computes the scalars of client kb + wl of this lane
      float fs = 0.f, fw = 0.f;
      if (kScalars && kb + wl < nl) {
        const int n = n0 + l + (kb + wl) * lanes;
        fs = Up::kScaled ? Up::scale(scales, n) : 1.f;
        fw = kDisc ? fs * powf(1.f + staleness[n], -exponent) : fs;
      }
      const int cnt32 = min(32, nl - kb);
      for (int u0 = 0; u0 < cnt32; u0 += kUnroll) {
        typename Up::template Raw<V> raw[kUnroll];
        float wv[kUnroll], cv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (active && u0 + u < cnt32) {
            const long long n = n0 + l + (long long)(kb + u0 + u) * lanes;
            raw[u] = Up::template load<V>(q + n * E + off);
            wv[u] = W[n * D + row];
            cv[u] = C[n * D + row];
          } else {
            raw[u] = {};
            wv[u] = cv[u] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float s = 1.f, f = 1.f;
          if (kScalars) {
            s = __shfl_sync(0xffffffffu, fs, (u0 + u) & 31);
            f = __shfl_sync(0xffffffffu, fw, (u0 + u) & 31);
          }
          if (u0 + u < cnt32) {
            float x[V];
            Up::unpack(raw[u], x);
            const float wq = wv[u] * f, cs = cv[u] * s;
            float t = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              aq[v] = fmaf(wq, x[v], aq[v]);
              mq[v] = fmaf(cs, x[v], mq[v]);
              t = fmaf(x[v], x[v], t);
            }
            sqv = fmaf(cs * s, t, sqv);
            cn += cv[u];
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sm.red[tid][v] = aq[v];
      sm.red[tid][V + v] = mq[v];
    }
    sm.red[tid][2 * V] = sqv;
    sm.red[tid][2 * V + 1] = cn;
    __syncthreads();
    if (l == 0) {  // the lanes, in lane order
      float a[V], m[V], qs = 0.f, c = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) a[v] = m[v] = 0.f;
      for (int ll = 0; ll < lanes; ++ll) {
        const float* rd = sm.red[ll * ts + p];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          a[v] += rd[v];
          m[v] += rd[V + v];
        }
        qs += rd[2 * V];
        c += rd[2 * V + 1];
      }
      sm.span_sq[p] = qs;
      sm.span_cnt[p] = c;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sm.red[p][v] = a[v];
        sm.red[p][V + v] = m[v];
      }
    }
    __syncthreads();
    {  // each row of the pass: its spans in span order
      const int first = s0 / sr, last = (min(s0 + ts, spans) - 1) / sr;
      const int i = first + tid;
      if (i <= last) {
        const int lo = max(i * sr, s0), hi = min(i * sr + sr, s0 + ts);
        float qs = sm.row_sq[i];
        for (int sp = lo; sp < hi; ++sp) qs += sm.span_sq[sp - s0];
        sm.row_sq[i] = qs;
        if (lo == i * sr) sm.row_cnt[i] = sm.span_cnt[lo - s0];
      }
    }
    __syncthreads();
    if (l == 0 && active) {  // the split's partials of this span
      const int i = span / sr;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const long long e = (long long)d0 * r + (long long)span * V + v;
        if (S == 1) {
          agg[e] = sm.red[p][v];
          mean[e] = sm.red[p][V + v] / fmaxf(sm.row_cnt[i], 1.f);
        } else {
          ws_agg[(long long)split * E + e] = sm.red[p][v];
          ws_sum[(long long)split * E + e] = sm.red[p][V + v];
        }
      }
    }
    __syncthreads();  // red is the next pass's
  }
  if (tid < nrow) {
    const int d = d0 + tid;
    if (S == 1) {
      sq[d] = sm.row_sq[tid];
      cnt[d] = sm.row_cnt[tid];
    } else {
      ws_sq[(long long)split * D + d] = sm.row_sq[tid];
      ws_cnt[(long long)split * D + d] = sm.row_cnt[tid];
    }
  }
  if (S == 1) return;

  // the tile's last block sums the S partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) sm.last = atomicAdd(counters + tile, 1) == S - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  if (tid < nrow) {
    const int d = d0 + tid;
    float qs = 0.f, c = 0.f;
    for (int b0 = 0; b0 < S; b0 += kSumBatch) {
      float vq[kSumBatch], vc[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        const bool ok = b0 + u < S;
        vq[u] = ok ? __ldcg(ws_sq + (long long)(b0 + u) * D + d) : 0.f;
        vc[u] = ok ? __ldcg(ws_cnt + (long long)(b0 + u) * D + d) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (b0 + u < S) {
          qs += vq[u];
          c += vc[u];
        }
    }
    sq[d] = qs;
    cnt[d] = c;
    sm.row_cnt[tid] = c;
  }
  __syncthreads();
  const long long e0 = (long long)d0 * r;
  for (int o = tid; o < nrow * r; o += kAThreads) {
    const long long e = e0 + o;
    float a = 0.f, m = 0.f;
    for (int b0 = 0; b0 < S; b0 += kSumBatch) {
      float va[kSumBatch], vm[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        const bool ok = b0 + u < S;
        va[u] = ok ? __ldcg(ws_agg + (long long)(b0 + u) * E + e) : 0.f;
        vm[u] = ok ? __ldcg(ws_sum + (long long)(b0 + u) * E + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (b0 + u < S) {
          a += va[u];
          m += vm[u];
        }
    }
    agg[e] = a;
    mean[e] = m / fmaxf(sm.row_cnt[o / r], 1.f);
  }
  if (tid == 0) counters[tile] = 0;
}

// The plan's checks, shared by both entries: vec = elements per span (4
// when r % 4 == 0, else 1), rows per tile, client lanes per block (a power
// of two, at most 8, leaving at least 32 span threads), splits S; with S >
// 1 a workspace and counters.
bool bad_plan(int N, int D, int r, int vec, int rows, int lanes, int splits,
              const float* ws, const int* counters) {
  const int ts = lanes > 0 ? kAThreads / lanes : 0;
  return N < 1 || D < 1 || r < 1 || splits < 1 || rows < 1 ||
         (vec != 4 && vec != 1) || r % vec != 0 || lanes < 1 || lanes > 8 ||
         (lanes & (lanes - 1)) != 0 || rows > ts ||
         (rows > 1 && rows * (r / vec) > ts) ||
         (splits > 1 && (ws == nullptr || counters == nullptr)) ||
         (long long)((D + rows - 1) / rows) * splits > 0x7fffffff;
}

template <class Up, int V, bool kDisc>
int launch(const typename Up::Code* x, const float* scales, const float* W,
           const float* C, const float* staleness, float exponent, int N,
           int D, int r, int rows, int lanes, int splits, float* ws,
           int* counters, float* agg, float* sq, float* mean, float* cnt,
           cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((D + rows - 1) / rows) * (long long)splits);
  agg_kernel<Up, V, kDisc><<<blocks, kAThreads, 0, stream>>>(
      x, scales, W, C, staleness, exponent, N, D, r, rows, lanes, splits, ws,
      counters, agg, sq, mean, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// agg_kernel's geometry, which the wrapper's planner must use: out =
// {threads per block, resident blocks per SM}.
void cohort_agg_geometry(int* out) {
  out[0] = kAThreads;
  out[1] = kABlocksPerSM;
}

// fp32 uplink, one launch (agg_kernel<F32Uplink>); with vec = 4 deltas must
// be 16-byte aligned. With S > 1, ws holds S * (2 * D * r + 2 * D) floats
// and counters ceil(D / rows) zeroed int32 (left zeroed); with S = 1
// neither is touched.
int cohort_agg_f32(const float* deltas, const float* W, const float* C,
                   int N, int D, int r, int vec, int rows, int lanes,
                   int splits, float* ws, int* counters, float* agg,
                   float* sq, float* mean, float* cnt, void* stream) {
  if (bad_plan(N, D, r, vec, rows, lanes, splits, ws, counters))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kern = vec == 4 ? launch<F32Uplink, 4, false>
                       : launch<F32Uplink, 1, false>;
  return kern(deltas, nullptr, W, C, nullptr, 0.f, N, D, r, rows, lanes,
              splits, ws, counters, agg, sq, mean, cnt, s);
}

// int8 uplink, one launch (agg_kernel<I8Uplink>); exponent == 0 takes the
// specialization without powf; with vec = 4 q must be 4-byte aligned. The
// plan, ws and counters as for cohort_agg_f32.
int cohort_agg_i8(const int8_t* q, const float* scales, const float* W,
                  const float* C, const float* staleness, float exponent,
                  int N, int D, int r, int vec, int rows, int lanes,
                  int splits, float* ws, int* counters, float* agg,
                  float* sq, float* mean, float* cnt, void* stream) {
  if (bad_plan(N, D, r, vec, rows, lanes, splits, ws, counters))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool disc = exponent != 0.f;
  auto kern = vec == 4 ? (disc ? launch<I8Uplink, 4, true>
                               : launch<I8Uplink, 4, false>)
                       : (disc ? launch<I8Uplink, 1, true>
                               : launch<I8Uplink, 1, false>);
  return kern(q, scales, W, C, staleness, exponent, N, D, r, rows, lanes,
              splits, ws, counters, agg, sq, mean, cnt, s);
}

}  // extern "C"
