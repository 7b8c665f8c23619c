// Online-softmax attention over the GQA layout, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes.
//
// Replaces the TPU kernel
//   flash_attention_pallas  src/repro/kernels/flash_attention/kernel.py:72
// q [B, S, K, G, hd], k/v [B, T, K, hd] (fp32 or bf16), q_pos [S], kv_pos [T]
// int32 -> out [B, S, K, G, hd] in q's type:
//   s    = (q . k) * hd^-0.5 in fp32, then cap * tanh(s / cap) when capped
//   mask = q_pos >= kv_pos  &  q_pos - kv_pos < window  &  kv_pos >= 0
//   out  = softmax over the valid keys of s, times v; a row with no valid
//          key gives 0 (p is masked again after exp, as kernel.py:59 does).
// As in the TPU kernel the G heads of a KV group are folded into the rows
// (row = s * G + g), so each K/V tile is read once for all of them. The
// window test is done in 64 bits, so window may be int32 max.
//
// Dispatch (the C entry `flash_attention`, explicit, no fallback):
//   fp32             -> flash_kernel, the first version, unchanged: fp32
//                       FMAs on the CUDA cores (its 2e-5 parity needs fp32
//                       arithmetic; the serving path runs bf16).
//   bf16, S*G > 16   -> prefill: prefill_prep_kernel, then prefill_kernel.
//   bf16, S*G <= 16  -> decode: decode_kernel over n_split chunks of T, then
//                       combine_kernel.
// Every bf16 kernel: 4 warps, 64-key K/V tiles staged raw (bf16) by 16-byte
// cp.async copies into rows padded by 8 elements (so ldmatrix's 8 row
// addresses fall in distinct banks), QK^T and PV on mma.sync m16n8k16 bf16
// with fp32 accumulation fed by ldmatrix, head_dim zero-padded in shared
// memory to HDP = 32, 64, 128 or 256 (so hd = 18, 40 or 64 need no other
// code). Scores are scaled in fp32 after the product (q is never rounded
// again) and kept in log2 units; the softmax works on the accumulator
// fragments in registers: a row's max and sum are shuffles within the quad
// of lanes that owns it, in a fixed order; p is packed to bf16 in registers
// as the A operand of PV and never touches shared memory (a row's largest
// p is exactly 1); l sums the fp32 p. A head_dim that is not a multiple of
// 8 is staged by plain loads instead (a misaligned 16-byte copy is illegal).
// K/V tiles go through a two-stage ring (tile j + 1's copies run while tile
// j computes; cp.async.wait_group), and each tile's slots and positions
// through a ring of three filled two tiles ahead, so no copy waits on an
// index load. A tile no row of the block can see is neither copied nor
// computed, and a tile that every row sees whole skips the per-element mask
// (mask and softcap are template choices, not per-element branches).
//
// Prefill (phi3-medium-14b batched: B=8, S=512, T=544, K=10, G=4, hd=128).
// Bound: bytes (Q, out and the visible K/V: 31 us at 3.35 TB/s) above the
// causal operations (21.5 GFLOP: 22 us at 989 TFLOP/s). A block owns 128
// folded rows of one (b, k) (64 at hd > 128), each warp two 16-row mma tiles
// (one), so every K/V fragment read from shared memory feeds two products
// and each staged tile serves 128 rows; it writes its output through shared
// memory in 16-byte stores. Row tiles are scheduled latest rows first (most
// work first). prefill_prep_kernel first sorts the slots by position (a
// stable rank sort, empty slots last) and, for each row tile, counts the
// range [k_lo, k_hi) of sorted keys its rows may see (q_lo - window < pos
// <= q_hi); the block walks that range, gathering K/V rows by slot. A ring
// in any slot order thus gives every block one contiguous range, and the
// causal half of the work is skipped.
//
// Decode (S*G <= 16, e.g. phi3 batched decode: S=1, G=4, T=544). Bound:
// bytes (the K/V of the visible slots, 21.8 MB: 6.5 us). Few rows per
// (b, k) would leave most SMs idle, so the T axis is cut into n_split
// contiguous chunks of whole tiles (split-KV, flash-decoding); n_split comes
// from the wrapper's planner, a function of T and S*G alone, so a row's
// bits do not depend on B or K. A block (chunk, k, b) walks its chunk's
// tiles; each warp takes 16 keys of a tile on the same 16-row mma tile
// (rows past S*G see no key), the four warps' (m, l, acc) merge in shared
// memory in warp order, and the block writes its fp32 partial to a scratch
// the wrapper allocates. combine_kernel merges the partials in ascending
// chunk order. Every sum has a fixed order: the output is bitwise
// repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// fp32: the first version, on the CUDA cores
// ---------------------------------------------------------------------------
// One block owns (batch b, kv head k, a tile of folded rows) and walks the
// KV tiles itself, so the running state never leaves registers. Each warp
// owns R rows; each lane owns one key of a 32-key tile for the scores and
// hd/32 output columns for the accumulation. The max and the sum over a
// tile are xor-shuffle trees, whose result is the same bits on every lane,
// and the order of every sum is fixed. Q and K/V tiles are staged in shared
// memory as fp32; q and k rows are zero-padded to hd4 = hd rounded up to 4
// columns (k rows to hd4 + 4, so the lanes' 16-byte reads of their keys
// fall in distinct banks). Each thread starts a batch of up to 32 K and 32 V
// loads before storing any. A tile with no key visible to any row of the
// block is skipped, which changes no bit of the result.

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


// ---------------------------------------------------------------------------
// bf16: tensor-core prefill and split-KV decode
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 128;    // 4 warps in every bf16 kernel
constexpr int kBN = 64;          // keys per K/V tile
// prefill: 16-row mma tiles per warp, so each K/V fragment read from
// shared memory feeds that many products; 2 while the accumulators fit in
// registers (HDP <= 128), else 1
template <int HDP>
__host__ __device__ constexpr int prefill_mr() {
  return HDP <= 128 ? 2 : 1;
}
constexpr int kDecodeRows = 16;  // S*G at or below this: split-KV decode
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kEmptyKey = 0x80000000u;  // above every int32 position

__device__ __forceinline__ unsigned sort_key(int p) {
  return p < 0 ? kEmptyKey : (unsigned)p;
}

// the lowest key position a row at qp may see (p >= 0, qp - p < window)
__device__ __forceinline__ int lowest_visible(int qp, long long window) {
  return (int)max(0LL, (long long)qp - window + 1);
}

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

// 2^x, flushing subnormal results to zero (|error| ~2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&h);
}

// Zero columns [hd, HDP) of `rows` shared rows of stride LD: the padding
// that the products read and the copies never write.
template <int HDP>
__device__ __forceinline__ void zero_padding(bf16* base, int rows, int hd) {
  constexpr int LD = HDP + 8;
  const int w = HDP - hd;
  for (int e = threadIdx.x; e < rows * w; e += kThreads) {
    const int i = e / w;
    base[i * LD + hd + (e - i * w)] = __float2bfloat16_rn(0.f);
  }
}

// Per K/V tile, in a ring of three (tiles j, j + 1, j + 2): each key's slot
// in the cache (-1: none, zero-filled) and position, and per half tile
// whether some row of the block may see one of its keys. The ring is
// filled two tiles ahead, so a tile's copies never wait on its indices.
constexpr int kMeta = 3;
struct TileMeta {
  int slot[kMeta][kBN];
  int pos[kMeta][kBN];
  unsigned live[kMeta][2];
};

// Key t of a tile at `idx`: its slot (order[idx], or idx when order is
// null) and position (posv[idx]); -1 at or past `end`.
__device__ __forceinline__ void fetch_meta(int& slot, int& pos,
                                           const int* order, const int* posv,
                                           int idx, int end) {
  const bool ok = idx < end;
  slot = ok ? (order ? order[idx] : idx) : -1;
  pos = ok ? posv[idx] : -1;
}

// Called by two whole warps, thread t < kBN holding key t of ring entry m.
__device__ __forceinline__ void store_meta(TileMeta& mt, int m, int t,
                                           int slot, int pos, int q_lo,
                                           int q_hi, long long window) {
  mt.slot[m][t] = slot;
  mt.pos[m][t] = pos;
  const unsigned any = __ballot_sync(
      ~0u, pos >= 0 && pos <= q_hi && (long long)q_lo - pos < window);
  if ((t & 31) == 0) mt.live[m][t >> 5] = any;
}

__device__ __forceinline__ bool tile_live(const TileMeta& mt, int m) {
  return (mt.live[m][0] | mt.live[m][1]) != 0u;
}

// Stage the kBN keys of a tile (slots from shared memory) into ks and vs
// (stride LD). vec: 16-byte copies, thread (c, r) copying chunk c of rows
// r, r + 8, ...; else plain loads.
template <int HDP>
__device__ __forceinline__ void stage_kv(bf16* ks, bf16* vs, const bf16* k,
                                         const bf16* v, const int* slot,
                                         long long base, long long stride,
                                         int hd, bool vec) {
  constexpr int LD = HDP + 8, kHalves = (HDP / 8 + 15) / 16;
  constexpr int kPass = kThreads / 16;  // rows per pass
  if (vec) {
    const int c = threadIdx.x & 15;
#pragma unroll
    for (int u = 0; u < kBN / kPass; ++u) {
      const int i = (threadIdx.x >> 4) + kPass * u, sl = slot[i];
      const long long off = sl >= 0 ? base + sl * stride : 0;
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const int cc = (c + 16 * h) * 8;
        if (cc < hd) {
          cp_async16(ks + i * LD + cc, k + off + cc, sl >= 0 ? 16 : 0);
          cp_async16(vs + i * LD + cc, v + off + cc, sl >= 0 ? 16 : 0);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < kBN * hd; e += kThreads) {
      const int i = e / hd, d = e - i * hd, sl = slot[i];
      bf16 kx = __float2bfloat16_rn(0.f), vx = kx;
      if (sl >= 0) {
        kx = k[base + sl * stride + d];
        vx = v[base + sl * stride + d];
      }
      ks[i * LD + d] = kx;
      vs[i * LD + d] = vx;
    }
  }
}

// Stage `n` folded q rows starting at row0 (row = s * G + g); rows at or
// past n_rows are zero.
template <int LD>
__device__ __forceinline__ void stage_q(bf16* qs, const bf16* q, int n,
                                        int row0, int n_rows, int G,
                                        long long q_base, long long q_s,
                                        int hd, bool vec) {
  if (vec) {
    const int cpr = hd >> 3;
    for (int e = threadIdx.x; e < n * cpr; e += kThreads) {
      const int i = e / cpr, c = (e - i * cpr) * 8, r = row0 + i;
      const bool ok = r < n_rows;
      const long long off =
          ok ? q_base + (r / G) * q_s + (long long)(r % G) * hd + c : 0;
      cp_async16(qs + i * LD + c, q + off, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < n * hd; e += kThreads) {
      const int i = e / hd, d = e - i * hd, r = row0 + i;
      qs[i * LD + d] =
          r < n_rows ? q[q_base + (r / G) * q_s + (long long)(r % G) * hd + d]
                     : __float2bfloat16_rn(0.f);
    }
  }
}

// s[mr][nb] = q rows 16 mr .. 16 mr + 15 of qs . keys 8 nb .. 8 nb + 7 of
// ks, fp32; each K fragment feeds MR products
template <int MR, int NB, int HDP>
__device__ __forceinline__ void qk(float (&s)[MR][NB][4], const bf16* qs,
                                   const bf16* ks, int lane) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int mr = 0; mr < MR; ++mr)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mr][nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    unsigned a[MR][4];
#pragma unroll
    for (int mr = 0; mr < MR; ++mr)
      ldsm_x4(a[mr], qs + (mr * 16 + (lane & 15)) * LD + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      unsigned b[4];
      ldsm_x4(b, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        mma(s[mr][2 * np], a[mr], b[0], b[1]);
        mma(s[mr][2 * np + 1], a[mr], b[2], b[3]);
      }
    }
  }
}

// One online-softmax step on the score fragments: lane owns rows lane/4
// (e = 0, 1) and lane/4 + 8 (e = 2, 3), keys 8 nb + 2 (lane % 4) + e % 2.
// MASK: key position p is visible to a row at qp iff lo <= p <= qp, lo =
// max(0, qp - window + 1) (lo0, lo1: the lane's two rows); CAP: softcap. sl2 =
// scale * log2(e): scores are kept in log2 units. On return s holds p
// (fp32, masked keys exactly 0); o is rescaled.
template <int NB, int ND, bool MASK, bool CAP>
__device__ __forceinline__ void softmax_step(
    float (&s)[NB][4], float (&o)[ND][4], float (&m)[2], float (&l)[2],
    const int* kp, int qp0, int qp1, int lo0, int lo1, float scale,
    float sl2, float cap, int lane) {
  unsigned ok_bits = 0;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = CAP ? cap * tanhf(s[nb][e] * scale / cap) * kLog2e
                    : s[nb][e] * sl2;
      if (MASK) {
        const int p = kp[nb * 8 + 2 * (lane & 3) + (e & 1)];
        const bool ok = p >= (e < 2 ? lo0 : lo1) && p <= (e < 2 ? qp0 : qp1);
        ok_bits |= (unsigned)ok << (nb * 4 + e);
        x = ok ? x : kNegInf;
      }
      s[nb][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 2));
    corr[h] = ex2(m[h] - mx[h]);
    m[h] = mx[h];
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(s[nb][e] - mx[e >> 1]);
      if (MASK && !((ok_bits >> (nb * 4 + e)) & 1u)) p = 0.f;
      s[nb][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];  // lane's part
  // the row max rarely moves once a few tiles are in: skip the rescale
  // when no row of the warp's changed (corr is exactly 1 then)
  if (__any_sync(~0u, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }
  }
}

// softmax_step with MASK and CAP chosen at run time, uniformly per warp
template <int NB, int ND>
__device__ __forceinline__ void softmax_any(
    float (&s)[NB][4], float (&o)[ND][4], float (&m)[2], float (&l)[2],
    const int* kp, bool mask, int has_cap, int qp0, int qp1, int lo0,
    int lo1, float scale, float cap, int lane) {
  const float sl2 = scale * kLog2e;
  if (mask) {
    if (has_cap)
      softmax_step<NB, ND, true, true>(s, o, m, l, kp, qp0, qp1, lo0, lo1,
                                       scale, sl2, cap, lane);
    else
      softmax_step<NB, ND, true, false>(s, o, m, l, kp, qp0, qp1, lo0, lo1,
                                        scale, sl2, cap, lane);
  } else {
    if (has_cap)
      softmax_step<NB, ND, false, true>(s, o, m, l, kp, qp0, qp1, lo0, lo1,
                                        scale, sl2, cap, lane);
    else
      softmax_step<NB, ND, false, false>(s, o, m, l, kp, qp0, qp1, lo0, lo1,
                                         scale, sl2, cap, lane);
  }
}

// o[mr] += p[mr] (16 rows x 16 NB/2 keys, bf16 from registers) . vs; each
// V fragment feeds MR products
template <int MR, int NB, int HDP>
__device__ __forceinline__ void pv(const float (&p)[MR][NB][4],
                                   float (&o)[MR][HDP / 8][4], const bf16* vs,
                                   int lane) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    unsigned a[MR][4];
#pragma unroll
    for (int mr = 0; mr < MR; ++mr) {
      a[mr][0] = pack_bf16(p[mr][2 * kk][0], p[mr][2 * kk][1]);
      a[mr][1] = pack_bf16(p[mr][2 * kk][2], p[mr][2 * kk][3]);
      a[mr][2] = pack_bf16(p[mr][2 * kk + 1][0], p[mr][2 * kk + 1][1]);
      a[mr][3] = pack_bf16(p[mr][2 * kk + 1][2], p[mr][2 * kk + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      unsigned b[4];
      ldsm_x4_t(b, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                       dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mr = 0; mr < MR; ++mr) {
        mma(o[mr][2 * dp], a[mr], b[0], b[1]);
        mma(o[mr][2 * dp + 1], a[mr], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(~0u, x, m);
  return x;
}

// Prefill preparation, one launch (bm <= 256 rows per row tile). Blocks
// [0, n_sort): a stable rank sort
// of the slots by position, empty slots (< 0) last: order[rank] = slot,
// spos[rank] = kv_pos[slot]; each warp ranks 8 slots, its lanes splitting
// the comparisons. Blocks [n_sort, ...): for prefill row tile x, the
// positions its rows hold (q_lo, q_hi) and the range [k_lo, k_hi) of sorted
// keys they may see (q_lo - window < pos <= q_hi), which counts the slots
// below each end: ranges[x] = (k_lo, k_hi, q_lo, q_hi).
__global__ void __launch_bounds__(256) prefill_prep_kernel(
    const int* __restrict__ kv_pos, const int* __restrict__ q_pos, int T,
    int n_rows, int G, long long window, int n_sort, int* __restrict__ order,
    int* __restrict__ spos, int4* __restrict__ ranges, int bm) {
  __shared__ unsigned keys[1024];
  __shared__ int red[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.x < n_sort) {
    const int i0 = blockIdx.x * 64 + warp * 8;
    unsigned ki[8];
    int cnt[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      ki[u] = i0 + u < T ? sort_key(kv_pos[i0 + u]) : 0xffffffffu;
      cnt[u] = 0;
    }
    for (int c0 = 0; c0 < T; c0 += 1024) {
      const int n = min(1024, T - c0);
      __syncthreads();
      for (int j = tid; j < n; j += 256) keys[j] = sort_key(kv_pos[c0 + j]);
      __syncthreads();
      for (int j = lane; j < n; j += 32) {
        const unsigned kj = keys[j];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          cnt[u] += (kj < ki[u]) | ((kj == ki[u]) & (c0 + j < i0 + u));
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int rank = warp_sum_int(cnt[u]);
      if (lane == 0 && i0 + u < T) {
        order[rank] = i0 + u;
        spos[rank] = kv_pos[i0 + u];
      }
    }
    return;
  }
  const int x = blockIdx.x - n_sort, row0 = x * bm;
  if (tid < 4) red[tid] = tid == 0 ? 0x7fffffff : tid == 1 ? -0x7fffffff - 1
                                                          : 0;
  __syncthreads();
  {
    const int r = row0 + tid;
    int lo = 0x7fffffff, hi = -0x7fffffff - 1;
    if (tid < bm && r < n_rows) lo = hi = q_pos[r / G];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      lo = min(lo, __shfl_xor_sync(~0u, lo, m));
      hi = max(hi, __shfl_xor_sync(~0u, hi, m));
    }
    if (lane == 0) {
      atomicMin(&red[0], lo);
      atomicMax(&red[1], hi);
    }
  }
  __syncthreads();
  const int q_lo = red[0], q_hi = red[1];
  const unsigned first = (unsigned)max(0LL, (long long)q_lo - window + 1);
  const unsigned last =
      (unsigned)min(max(0LL, (long long)q_hi + 1), 0x80000000LL);
  int below_first = 0, below_last = 0;
  for (int j = tid; j < T; j += 256) {
    const unsigned kj = sort_key(kv_pos[j]);
    below_first += kj < first;
    below_last += kj < last;
  }
  below_first = warp_sum_int(below_first);
  below_last = warp_sum_int(below_last);
  if (lane == 0) {
    atomicAdd(&red[2], below_first);
    atomicAdd(&red[3], below_last);
  }
  __syncthreads();
  if (tid == 0) ranges[x] = make_int4(red[2], red[3], q_lo, q_hi);
}

template <int HDP>
constexpr size_t prefill_smem() {
  return sizeof(bf16) * (size_t)(64 * prefill_mr<HDP>() + 4 * kBN) *
         (HDP + 8);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads) prefill_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ order, const int* __restrict__ spos,
    const int4* __restrict__ ranges, bf16* __restrict__ out, int S, int K,
    int G, int hd, int T, long long window, float scale, float cap,
    int has_cap, int vec) {
  constexpr int LD = HDP + 8, ND = HDP / 8, NB = kBN / 8;
  constexpr int MR = prefill_mr<HDP>(), WR = 16 * MR, BM = 4 * WR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* kvs = qs + BM * LD;                      // [2][K, V][kBN][LD]
  __shared__ TileMeta mt;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = blockIdx.y, b = blockIdx.z, n_rows = S * G;
  const int x = gridDim.x - 1 - blockIdx.x;  // latest rows (most work) first
  const int row0 = x * BM;
  const long long q_s = (long long)K * G * hd;
  const long long q_base = ((long long)b * S * K + kh) * G * hd;
  const long long kv_base = ((long long)b * T * K + kh) * hd;
  const long long kv_stride = (long long)K * hd;
  const int4 rg = ranges[x];
  const int k_lo = rg.x, k_hi = rg.y, q_lo = rg.z, q_hi = rg.w;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBN - 1) / kBN : 0;

  stage_q<LD>(qs, q, BM, row0, n_rows, G, q_base, q_s, hd, vec);
  zero_padding<HDP>(qs, BM + 4 * kBN, hd);
  {  // ring entries of tiles 0 and 1: threads 0-63 and 64-127
    const int t = tid & (kBN - 1), j = tid / kBN;
    int sl, p;
    fetch_meta(sl, p, order, spos, k_lo + j * kBN + t, k_hi);
    store_meta(mt, j, t, sl, p, q_lo, q_hi, window);
  }
  // the warp's rows 16 mr + lane/4 (+ 8); a row past the end sees no key
  int qp0[MR], qp1[MR], lo0[MR], lo1[MR];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
    const int ra = row0 + warp * WR + mr * 16 + (lane >> 2), rb = ra + 8;
    qp0[mr] = ra < n_rows ? q_pos[ra / G] : -1;
    qp1[mr] = rb < n_rows ? q_pos[rb / G] : -1;
    lo0[mr] = lowest_visible(qp0[mr], window);
    lo1[mr] = lowest_visible(qp1[mr], window);
  }
  float o[MR][ND][4], m[MR][2], l[MR][2];
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
    m[mr][0] = m[mr][1] = kNegInf;
    l[mr][0] = l[mr][1] = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mr][d][e] = 0.f;
  }
  __syncthreads();

  if (n_tiles > 0 && tile_live(mt, 0))
    stage_kv<HDP>(kvs, kvs + kBN * LD, k, v, mt.slot[0], kv_base,
                            kv_stride, hd, vec);
  cp_async_commit();  // with Q
  for (int j = 0; j < n_tiles; ++j) {
    const int mj = j % kMeta, m1 = (j + 1) % kMeta, m2 = (j + 2) % kMeta;
    const bool live = tile_live(mt, mj);
    if (j + 1 < n_tiles && tile_live(mt, m1)) {
      bf16* ks = kvs + ((j + 1) & 1) * 2 * kBN * LD;
      stage_kv<HDP>(ks, ks + kBN * LD, k, v, mt.slot[m1], kv_base,
                              kv_stride, hd, vec);
    }
    cp_async_commit();
    const bool ahead = j + 2 < n_tiles && tid < kBN;  // warps 0 and 1
    int sl = -1, p = -1;
    if (ahead)
      fetch_meta(sl, p, order, spos, k_lo + (j + 2) * kBN + tid, k_hi);
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const bf16* ks = kvs + (j & 1) * 2 * kBN * LD;
      const int* kp = mt.pos[mj];
      // every row sees every key of the tile: no per-element mask (the
      // range is sorted, so its first and last keys bound it)
      const bool whole = k_lo + (j + 1) * kBN <= k_hi && kp[kBN - 1] <= q_lo &&
                         (long long)q_hi - kp[0] < window;
      float s[MR][NB][4];
      qk<MR, NB, HDP>(s, qs + warp * WR * LD, ks, lane);
#pragma unroll
      for (int mr = 0; mr < MR; ++mr)
        softmax_any<NB, ND>(s[mr], o[mr], m[mr], l[mr], kp, !whole, has_cap,
                            qp0[mr], qp1[mr], lo0[mr], lo1[mr], scale, cap,
                            lane);
      pv<MR, NB, HDP>(s, o, ks + kBN * LD, lane);
    }
    if (ahead) store_meta(mt, m2, tid, sl, p, q_lo, q_hi, window);
    __syncthreads();
  }
  cp_async_wait<0>();

  // normalize; each warp writes its rows into its own (no longer read) Q
  // rows, then copies them out in 16-byte stores
  bf16* ow = qs + warp * WR * LD;
  __syncwarp();
#pragma unroll
  for (int mr = 0; mr < MR; ++mr) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[mr][h];
      lh += __shfl_xor_sync(~0u, lh, 1);
      lh += __shfl_xor_sync(~0u, lh, 2);
      inv[h] = 1.f / fmaxf(lh, 1e-30f);
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int c = d * 8 + 2 * (lane & 3), r = mr * 16 + (lane >> 2);
      *reinterpret_cast<__nv_bfloat162*>(ow + r * LD + c) =
          __floats2bfloat162_rn(o[mr][d][0] * inv[0], o[mr][d][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(ow + (r + 8) * LD + c) =
          __floats2bfloat162_rn(o[mr][d][2] * inv[1], o[mr][d][3] * inv[1]);
    }
  }
  __syncwarp();
  const int cpr = vec ? hd >> 3 : hd;
  for (int e = lane; e < WR * cpr; e += 32) {
    const int i = e / cpr, c = e - i * cpr, r = row0 + warp * WR + i;
    if (r >= n_rows) continue;
    bf16* dst = out + q_base + (r / G) * q_s + (long long)(r % G) * hd;
    if (vec)
      *reinterpret_cast<uint4*>(dst + c * 8) =
          *reinterpret_cast<const uint4*>(ow + i * LD + c * 8);
    else
      dst[c] = ow[i * LD + c];
  }
}

template <int HDP>
constexpr size_t decode_smem(int stages) {
  return sizeof(bf16) * (size_t)(kDecodeRows + 2 * stages * kBN) * (HDP + 8);
}

// Block (chunk, k, b): the fp32 partial (m, l, acc) of rows 0 .. S*G - 1
// over the chunk's keys, to part_ml [B][K][n_split][rows][2] and part_acc
// [B][K][n_split][rows][hd]; m in log2 units.
template <int HDP>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int S, int K, int G, int hd, int T,
    long long window, float scale, float cap, int has_cap, int n_split,
    int tiles_per_split, int vec) {
  constexpr int LD = HDP + 8, ND = HDP / 8;
  // the merge scratch (4 warps x 16 rows x HDP fp32) fits one K/V stage
  static_assert(4 * kDecodeRows * HDP * sizeof(float) <=
                    2 * kBN * (HDP + 8) * sizeof(bf16),
                "merge scratch exceeds a K/V stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stages = tiles_per_split > 1 ? 2 : 1;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [16][LD]
  bf16* kvs = qs + kDecodeRows * LD;             // [stages][K, V][kBN][LD]
  __shared__ TileMeta mt;
  __shared__ float wm[4][kDecodeRows], wl[4][kDecodeRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int rows = S * G;
  const long long q_s = (long long)K * G * hd;
  const long long q_base = ((long long)b * S * K + kh) * G * hd;
  const long long kv_base = ((long long)b * T * K + kh) * hd;
  const long long kv_stride = (long long)K * hd;
  const long long t_first = (long long)split * tiles_per_split * kBN;
  const int t_begin = (int)min(t_first, (long long)T);
  const int t_end = (int)min(t_first + (long long)tiles_per_split * kBN,
                             (long long)T);
  const int n_tiles = (t_end - t_begin + kBN - 1) / kBN;

  stage_q<LD>(qs, q, kDecodeRows, 0, rows, G, q_base, q_s, hd, vec);
  zero_padding<HDP>(qs, kDecodeRows + stages * 2 * kBN, hd);
  // every warp reduces the rows' positions itself (rows <= 16 lanes)
  const int my_qp = lane < rows ? q_pos[lane / G] : -1;  // -1 sees no key
  int q_lo = lane < rows ? my_qp : 0x7fffffff;
  int q_hi = lane < rows ? my_qp : -0x7fffffff - 1;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    q_lo = min(q_lo, __shfl_xor_sync(~0u, q_lo, s));
    q_hi = max(q_hi, __shfl_xor_sync(~0u, q_hi, s));
  }
  const int ra = lane >> 2, rb = ra + 8;
  const int qp0 = __shfl_sync(~0u, my_qp, ra);
  const int qp1 = __shfl_sync(~0u, my_qp, rb);
  const int lo0 = lowest_visible(qp0, window);
  const int lo1 = lowest_visible(qp1, window);
  {  // ring entries of tiles 0 and 1: threads 0-63 and 64-127
    const int t = tid & (kBN - 1), j = tid / kBN;
    int sl, p;
    fetch_meta(sl, p, nullptr, kv_pos, t_begin + j * kBN + t, t_end);
    store_meta(mt, j, t, sl, p, q_lo, q_hi, window);
  }
  float o[1][ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[0][d][e] = 0.f;
  __syncthreads();

  if (n_tiles > 0 && tile_live(mt, 0))
    stage_kv<HDP>(kvs, kvs + kBN * LD, k, v, mt.slot[0], kv_base,
                           kv_stride, hd, vec);
  cp_async_commit();  // with Q
  for (int j = 0; j < n_tiles; ++j) {
    const int mj = j % kMeta, m1 = (j + 1) % kMeta, m2 = (j + 2) % kMeta;
    const bool live = tile_live(mt, mj);
    if (j + 1 < n_tiles && tile_live(mt, m1)) {
      bf16* ks = kvs + ((j + 1) & 1) * 2 * kBN * LD;
      stage_kv<HDP>(ks, ks + kBN * LD, k, v, mt.slot[m1], kv_base,
                             kv_stride, hd, vec);
    }
    cp_async_commit();
    const bool ahead = j + 2 < n_tiles && tid < kBN;  // warps 0 and 1
    int sl = -1, p = -1;
    if (ahead)
      fetch_meta(sl, p, nullptr, kv_pos, t_begin + (j + 2) * kBN + tid, t_end);
    cp_async_wait<1>();
    __syncthreads();
    if (live) {  // warp w takes keys 16 w .. 16 w + 15 of the tile
      const bf16* ks = kvs + (j & 1) * 2 * kBN * LD + warp * 16 * LD;
      float s[1][2][4];
      qk<1, 2, HDP>(s, qs, ks, lane);
      softmax_any<2, ND>(s[0], o[0], m, l, mt.pos[mj] + warp * 16, true,
                         has_cap, qp0, qp1, lo0, lo1, scale, cap, lane);
      pv<1, 2, HDP>(s, o, ks + kBN * LD, lane);
    }
    if (ahead) store_meta(mt, m2, tid, sl, p, q_lo, q_hi, window);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the four warps' partials, in warp order, through shared memory
  float* wo = reinterpret_cast<float*>(kvs);  // [4][16][HDP]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(~0u, l[h], 1);
    l[h] += __shfl_xor_sync(~0u, l[h], 2);
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int c = d * 8 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(wo + (warp * kDecodeRows + ra) * HDP + c) =
        make_float2(o[0][d][0], o[0][d][1]);
    *reinterpret_cast<float2*>(wo + (warp * kDecodeRows + rb) * HDP + c) =
        make_float2(o[0][d][2], o[0][d][3]);
  }
  if ((lane & 3) == 0) {
    wm[warp][ra] = m[0];
    wm[warp][rb] = m[1];
    wl[warp][ra] = l[0];
    wl[warp][rb] = l[1];
  }
  __syncthreads();
  const long long p0 = (((long long)b * K + kh) * n_split + split) * rows;
  for (int e = tid; e < rows * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    const float mm =
        fmaxf(fmaxf(wm[0][r], wm[1][r]), fmaxf(wm[2][r], wm[3][r]));
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      acc += wo[(w * kDecodeRows + r) * HDP + d] * ex2(wm[w][r] - mm);
    part_acc[(p0 + r) * hd + d] = acc;
  }
  for (int r = tid; r < rows; r += kThreads) {
    const float mm =
        fmaxf(fmaxf(wm[0][r], wm[1][r]), fmaxf(wm[2][r], wm[3][r]));
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) sum += wl[w][r] * ex2(wm[w][r] - mm);
    part_ml[(p0 + r) * 2] = mm;
    part_ml[(p0 + r) * 2 + 1] = sum;
  }
}

// Block (b, k, row), thread d: out = sum_c acc_c 2^(m_c - M) / sum_c l_c
// 2^(m_c - M) over the chunks c in ascending order, M = max_c m_c.
__global__ void __launch_bounds__(256) combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    bf16* __restrict__ out, int S, int K, int G, int hd, int n_split) {
  const int bk = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int b = bk / K, kh = bk - b * K, rows = S * G;
  if (d >= hd) return;
  const long long p0 = (long long)bk * n_split * rows + r;
  float mm = kNegInf;
  for (int c = 0; c < n_split; ++c)
    mm = fmaxf(mm, part_ml[(p0 + (long long)c * rows) * 2]);
  float acc = 0.f, sum = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const long long i = p0 + (long long)c * rows;
    const float w = ex2(part_ml[i * 2] - mm);
    sum += part_ml[i * 2 + 1] * w;
    acc += part_acc[i * hd + d] * w;
  }
  const int s = r / G, g = r - s * G;
  out[(((long long)b * S + s) * K + kh) * G * hd + (long long)g * hd + d] =
      __float2bfloat16_rn(acc * (1.f / fmaxf(sum, 1e-30f)));
}

struct Args {
  const bf16 *q, *k, *v;
  const int *q_pos, *kv_pos;
  bf16* out;
  int B, S, K, G, hd, T;
  long long window;
  float scale, cap;
  int has_cap, vec, n_split;
  void* scratch;
  cudaStream_t stream;
};

template <int HDP>
int launch_prefill(const Args& a) {
  constexpr int bm = 64 * prefill_mr<HDP>();
  const long long row_tiles = ((long long)a.S * a.G + bm - 1) / bm;
  if (row_tiles > 0x7fffffff || a.K > 65535 || a.B > 65535)
    return (int)cudaErrorInvalidValue;
  int4* ranges = static_cast<int4*>(a.scratch);
  int* order = reinterpret_cast<int*>(ranges + row_tiles);
  int* spos = order + a.T;
  const int n_sort = (a.T + 63) / 64;
  prefill_prep_kernel<<<n_sort + (unsigned)row_tiles, 256, 0, a.stream>>>(
      a.kv_pos, a.q_pos, a.T, a.S * a.G, a.G, a.window, n_sort, order, spos,
      ranges, bm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kern = prefill_kernel<HDP>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)prefill_smem<HDP>());
  if (configured != cudaSuccess) return (int)configured;
  kern<<<dim3((unsigned)row_tiles, a.K, a.B), kThreads, prefill_smem<HDP>(),
         a.stream>>>(a.q, a.k, a.v, a.q_pos, order, spos, ranges, a.out, a.S,
                     a.K, a.G, a.hd, a.T, a.window, a.scale, a.cap,
                     a.has_cap, a.vec);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_decode(const Args& a) {
  const int n_tiles = (a.T + kBN - 1) / kBN;
  const int per = (n_tiles + a.n_split - 1) / a.n_split;
  const int rows = a.S * a.G;
  float* part_acc = static_cast<float*>(a.scratch);
  float* part_ml = part_acc + (size_t)a.B * a.K * a.n_split * rows * a.hd;
  auto kern = decode_kernel<HDP>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)decode_smem<HDP>(2));
  if (configured != cudaSuccess) return (int)configured;
  if (a.K > 65535 || a.B > 65535 || (long long)a.B * a.K > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  kern<<<dim3(a.n_split, a.K, a.B), kThreads,
         decode_smem<HDP>(per > 1 ? 2 : 1), a.stream>>>(
      a.q, a.k, a.v, a.q_pos, a.kv_pos, part_acc, part_ml, a.S, a.K, a.G,
      a.hd, a.T, a.window, a.scale, a.cap, a.has_cap, a.n_split, per, a.vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<dim3(a.B * a.K, rows), (a.hd + 31) / 32 * 32, 0,
                   a.stream>>>(part_acc, part_ml, a.out, a.S, a.K, a.G, a.hd,
                               a.n_split);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch(const Args& a) {
  return a.S * a.G <= kDecodeRows ? launch_decode<HDP>(a)
                                  : launch_prefill<HDP>(a);
}

template <int HDP>
int smem_bytes(int path) {
  return (int)(path ? decode_smem<HDP>(2) : prefill_smem<HDP>());
}

int dispatch(const Args& a) {
  if (a.hd <= 32) return launch<32>(a);
  if (a.hd <= 64) return launch<64>(a);
  if (a.hd <= 128) return launch<128>(a);
  return launch<256>(a);
}

}  // namespace tc
}  // namespace

extern "C" {

// dtype 0 = fp32, 1 = bf16 (q, k, v and out alike). n_split: 0 for a bf16
// prefill (S*G > 16) and for fp32, the number of T chunks for a bf16 decode
// (S*G <= 16). scratch (allocated by the caller): bf16 prefill
// 4 ceil(S*G / 64) + 2T int32, bf16 decode B*K*n_split*S*G*(hd + 2) fp32,
// else unused. Returns a cudaError_t.
int flash_attention(const void* q, const void* k, const void* v,
                    const int* q_pos, const int* kv_pos, void* out, int B,
                    int S, int K, int G, int hd, int T, int dtype,
                    long long window, float softcap, int has_softcap,
                    int n_split, void* scratch, void* stream) {
  if (hd < 1 || hd > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (n_split != 0) return (int)cudaErrorInvalidValue;
    return dispatch_rows<float>(q, k, v, q_pos, kv_pos, out, B, S, K, G, hd,
                                T, window, softcap, has_softcap, st);
  }
  const bool decode = (long long)S * G <= tc::kDecodeRows;
  if (dtype != 1 || hd < 16 || (decode ? n_split < 1 : n_split != 0))
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  tc::Args a{static_cast<const tc::bf16*>(q),
             static_cast<const tc::bf16*>(k),
             static_cast<const tc::bf16*>(v),
             q_pos,
             kv_pos,
             static_cast<tc::bf16*>(out),
             B, S, K, G, hd, T,
             window,
             1.f / sqrtf((float)hd),
             softcap,
             has_softcap,
             hd % 8 == 0 && any % 16 == 0,
             n_split,
             scratch,
             st};
  return tc::dispatch(a);
}

// Dynamic shared memory (bytes) a bf16 launch asks for at head_dim hd:
// path 0 prefill, 1 decode with two stages. For reports; launches nothing.
int flash_attention_smem_bytes(int hd, int path) {
  if (hd < 16 || hd > 256) return -1;
  if (hd <= 32) return tc::smem_bytes<32>(path);
  if (hd <= 64) return tc::smem_bytes<64>(path);
  if (hd <= 128) return tc::smem_bytes<128>(path);
  return tc::smem_bytes<256>(path);
}

}  // extern "C"
