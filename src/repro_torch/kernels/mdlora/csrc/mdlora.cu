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
// r 8) the call moves 0.37 MB and does 8.4 MFLOP, far below one launch: the
// floor there is one launch plus one round trip to device memory. At 1024
// clients it moves 40 MB (12 us at the memory rate); its 1.1 GFLOP run on
// the tensor cores, three TF32 products each in fp32 (6.7 us at the TF32
// peak), so bytes bound it in both types.
//
// Design: tiles of (batch slice, 32 rows, 32 columns), each summed by one
// block of 8 warps. Warp (wm, kg) owns rows 16 wm .. 16 wm + 15 of the tile
// and the k-steps kg, kg + 4, kg + 8, ... of D (a k-step is 8 d in fp32, 16
// in bf16): the path's D = 112 is 14 fp32 k-steps, so a warp's chain of
// dependent products is 3-4 steps long, and a block keeps 8 warps busy
// where two would each walk all of D.
//   * One product for the base and the bottleneck. [W0 tile | a] sit side
//     by side in shared memory, so xm @ [W0 | a] gives the base product and
//     u = xm @ a in the same pass, as the TPU kernel's _kernel does: u is
//     UF more n8 fragments beside the tile's four (a's columns zero-padded
//     to 8 UF; each column tile recomputes its rows' u, r / 32 of its base
//     work).
//   * Tensor cores through mma.sync. bf16: m16n8k16, A = x * mask rounded to
//     bf16 once (exact for 0/1 masks) by ldmatrix, B = [W0 | a] by
//     ldmatrix.trans. fp32: m16n8k8 TF32 with the 3xTF32 split: hi =
//     rna_tf32(v), lo = rna_tf32(v - hi) (cvt.rna.tf32.f32's rounding, done
//     with integer operations), and lo*hi + hi*lo + hi*hi into fp32
//     accumulators, ~2^-21 of each term (one TF32 product would be 2^-11).
//     These mma instructions do not read PyTorch's allow_tf32.
//   * A cp.async ring of 4 stages, each one k-step per k-group of d: x [32
//     rows], [W0 | a] and the mask. Blocks are persistent: the grid is the
//     blocks the card holds at once, and a block walks its tiles with the
//     ring running across them, so the next tile's copies are in flight
//     while a tile computes and finishes. When all of a block's stages fit
//     the ring (the path: one tile of D = 112) every copy is issued before
//     the first wait. Aligned operands come by 16-byte copies, whose source
//     size zero-fills the ragged edges of T, D, F and r; rows that are not
//     16-byte aligned (F = 70, r = 5) by 4-byte copies (fp32) or plain loads
//     (bf16), zero-filled the same way. The shapes of the copies are
//     compile-time, and the issuing side keeps its tile's pointers.
//   * The four k-groups' sums meet in shared memory and are added in k-group
//     order. Then y = base + scale * u @ b, a product of depth 8 UF in fp32
//     on the CUDA cores (each thread's outputs share one column, whose b
//     values it holds in registers), with coalesced stores; b's column tile
//     rides with the tile's first stage, in a slot of its own.
//   * The path's 8 slices are 32 tiles on 32 blocks; 1024 slices are 4096
//     tiles on the ~3 blocks per SM that fit at r <= 16.
// Each output element is summed in a fixed order: per k-group over its
// k-steps in ascending order, the k-groups in order, then over j ascending,
// with no atomics. Two calls give the same bits, and an element's result
// depends only on its own row and column: a slice's rows are the same bits
// whatever K is and whatever slices sit beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;  // 8 warps: 2 row tiles x 4 k-groups
constexpr int kRows = 32;      // rows per block (two m16 tiles)
constexpr int kCols = 32;      // W0 columns per block (four n8 fragments)
constexpr int kGroups = 4;     // k-groups; a ring stage is one k-step each
constexpr int kStages = 4;     // ring depth
constexpr int kMaxR = 64;      // largest LoRA rank taken
constexpr int kMaxUF = kMaxR / 8;  // u fragments per warp, at most

// d per ring stage: kGroups k-steps of 8 (fp32) or 16 (bf16)
__host__ __device__ constexpr int chunk_of(int es) {
  return kGroups * (es == 4 ? 8 : 16);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// The geometry of one instantiation (element type T, UF u fragments: the
// bottleneck's columns are padded with zeros to rp = 8 UF), all compile-time.
// Shared memory (bytes): the ring, kStages x (x | [W0 | a] | mask); b's
// column tiles, one per ring slot (tile i in slot i % kStages); the
// k-groups' sums (kGroups - 1 of them, fragment by fragment); then base
// [32][33] and u [32][rp + 1] in fp32. Row strides keep the fragment loads
// free of bank conflicts: fp32 rows of [W0 | a] are 8 words mod 32 apart
// and x rows 4, bf16 rows 16 bytes mod 128 (ldmatrix).
template <typename T, int UF>
struct Geo {
  static constexpr int es = sizeof(T), kc = chunk_of(es), rp = 8 * UF;
  static constexpr int width = kCols + rp;
  static constexpr int ldx = kc + (es == 4 ? 4 : 8);
  static constexpr int ldw = es == 4 ? width + (40 - width % 32) % 32
                                     : width + (72 - width % 64) % 64;
  static constexpr int x_bytes = kRows * ldx * es, w_bytes = kc * ldw * es;
  static constexpr int stage_bytes = x_bytes + w_bytes + kc * 4;
  static constexpr int b_off = kStages * stage_bytes;
  static constexpr int b_bytes = rp * kCols * es;
  static constexpr int red_off = b_off + kStages * b_bytes;
  static constexpr int base_off =
      red_off + (kGroups - 1) * 2 * (4 + UF) * 32 * 16;
  static constexpr int u_off = base_off + kRows * (kCols + 1) * 4;
  static constexpr int total = u_off + kRows * (rp + 1) * 4;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16-byte asynchronous copy; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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
// wait until at most n (0 .. kStages - 1) groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}
static_assert(kStages == 4, "cp_async_wait_upto covers 0 .. 3 pending; "
              "slots are j & (kStages - 1)");

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
__device__ __forceinline__ void ldsm_x2_t(unsigned& r0, unsigned& r1,
                                          const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}
// d += a (16 x 16, row-major) . b (16 x 8, column-major); bf16 in, fp32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a (16 x 8) . b (8 x 8); TF32 in, fp32 sum
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// cvt.rna.tf32.f32 in two integer operations (the conversion instruction
// runs at a fraction of the ALU rate): add half of the 13 dropped bits to
// the magnitude and clear them; the same bits for every finite v
__device__ __forceinline__ unsigned tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}
// v = hi + lo, both TF32; lo carries the 13 bits hi drops (rounded again)
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}
// the 3xTF32 product, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], float b0,
                                     float b1) {
  unsigned bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Copy a ROWS x LEN tile (row stride LD in shared memory, ld_src in device
// memory) whose first rows_valid rows and n_valid columns exist; the rest
// is zero-filled. The shape is compile-time, so each thread's share is a
// fixed unrolled list. kVec: 16-byte copies (rows 16-byte aligned), a
// partial chunk by its source size; else 4-byte copies (fp32) or plain
// loads (bf16).
template <typename T, bool kVec, int ROWS, int LEN, int LD>
__device__ __forceinline__ void copy_tile(T* dst, const T* src,
                                          long long ld_src, int rows_valid,
                                          int n_valid, int tid) {
  constexpr int epc = kVec ? 16 / (int)sizeof(T) : 1;
  constexpr int cpr = LEN / epc, total = ROWS * cpr;
  static_assert(LEN % epc == 0, "whole chunks per row");
#pragma unroll
  for (int q = 0; q < (total + kThreads - 1) / kThreads; ++q) {
    const int e = tid + q * kThreads;
    if (total % kThreads != 0 && e >= total) break;
    const int i = e / cpr, c = (e % cpr) * epc;
    const int n = i < rows_valid ? min(max(n_valid - c, 0), epc) : 0;
    const T* from = n > 0 ? src + i * ld_src + c : src;
    if constexpr (kVec) {
      cp_async16(dst + i * LD + c, from, n * (int)sizeof(T));
    } else if constexpr (sizeof(T) == 4) {
      cp_async4(dst + i * LD + c, from, n * 4);
    } else {
      dst[i * LD + c] = n > 0 ? *from : T(0.f);
    }
  }
}

// UF: u fragments the accumulators hold (r <= 8 UF); fewer registers give
// three blocks per SM at the path's r = 8
template <typename T, int UF, bool kVec>
__global__ void __launch_bounds__(kThreads, UF <= 2 ? 3 : 2) fused_kernel(
    const T* __restrict__ x, const T* __restrict__ w0,
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ mask, float scale, int Tn, int D, int F, int r,
    long long sx, long long sw, long long sa, long long sb, long long sm,
    int n_tiles, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  using G = Geo<T, UF>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kc = G::kc, kstep = kc / kGroups, rp = G::rp;
  constexpr int kFrags = 4 + UF;  // W0's four fragments, then u's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, kg = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int n_ft = (F + kCols - 1) / kCols, n_tt = (Tn + kRows - 1) / kRows;
  const int nk = (D + kc - 1) / kc;
  // this block's tiles: blockIdx.x, + gridDim.x, ...; stage j is chunk
  // j % nk of the block's tile j / nk (32-bit index arithmetic: the host
  // keeps tiles and stages below 2^31)
  const int n_mine = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x;
  const int n_stages = n_mine * nk;
  struct Tile {
    long long k;
    int t0, f0, rows, cols;
  };
  auto tile_of = [&](int i) {
    const int id = (int)blockIdx.x + i * (int)gridDim.x;
    const int rest = id / n_ft;
    Tile u;
    u.f0 = (id - rest * n_ft) * kCols;
    u.k = rest / n_tt;
    u.t0 = (rest - (int)u.k * n_tt) * kRows;
    u.rows = min(kRows, Tn - u.t0);
    u.cols = min(kCols, F - u.f0);
    return u;
  };
  // Stages are issued in order: the issue side keeps its tile's pointers
  // (recomputed at each tile's first chunk) and its position.
  int is_i = 0, is_c = 0, is_rows = 0, is_cols = 0;
  const T *is_x = x, *is_w = w0, *is_a = a;
  const float* is_m = mask;
  auto stage = [&](int j) {
    if (is_c == 0) {
      const Tile u = tile_of(is_i);
      is_x = x + u.k * sx + (long long)u.t0 * D;
      is_w = w0 + u.k * sw + u.f0;
      is_a = a + u.k * sa;
      if (mask != nullptr) is_m = mask + u.k * sm;
      is_rows = u.rows;
      is_cols = u.cols;
      // the tile's b columns, into its own slot
      copy_tile<T, kVec, rp, kCols, kCols>(
          reinterpret_cast<T*>(smem + G::b_off +
                               (is_i & (kStages - 1)) * G::b_bytes),
          b + u.k * sb + u.f0, F, r, u.cols, tid);
    }
    unsigned char* s = smem + (j & (kStages - 1)) * G::stage_bytes;
    T* xs = reinterpret_cast<T*>(s);
    T* ws = reinterpret_cast<T*>(s + G::x_bytes);
    const int d0 = is_c * kc, dv = min(kc, D - d0);
    copy_tile<T, kVec, kRows, kc, G::ldx>(xs, is_x + d0, D, is_rows, dv, tid);
    copy_tile<T, kVec, kc, kCols, G::ldw>(ws, is_w + (long long)d0 * F, F, dv,
                                          is_cols, tid);
    copy_tile<T, kVec, kc, rp, G::ldw>(ws + kCols, is_a + (long long)d0 * r,
                                       r, dv, r, tid);
    if (mask != nullptr)
      copy_tile<float, kVec, 1, kc, kc>(
          reinterpret_cast<float*>(s + G::x_bytes + G::w_bytes), is_m + d0, 0,
          1, dv, tid);
    if (++is_c == nk) {
      is_c = 0;
      ++is_i;
    }
  };

  // the ring: every stage up front when they fit (the path: one tile of
  // D = 112), else kStages - 1 ahead, across the block's tiles
  const bool fits = n_stages <= kStages;
  const int pre = fits ? n_stages : kStages - 1;
  for (int j = 0; j < pre; ++j) {
    stage(j);
    cp_async_commit();
  }

  float acc[kFrags][4];
#pragma unroll
  for (int n = 0; n < kFrags; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int row_a = wm * 16;  // the warp's first row in the tile
  const int kk = kg * kstep;  // the warp's k-step in each stage
  for (int j = 0, c = 0; j < n_stages; ++j, c = c + 1 == nk ? 0 : c + 1) {
    if (fits) {
      cp_async_wait_upto(n_stages - 1 - j);
    } else {
      cp_async_wait<kStages - 2>();
    }
    __syncthreads();  // stage j is in; the slot of stage j - 1 is free
    if (!fits) {
      if (j + kStages - 1 < n_stages) stage(j + kStages - 1);
      cp_async_commit();
    }
    const unsigned char* s = smem + (j & (kStages - 1)) * G::stage_bytes;
    const float* ms = reinterpret_cast<const float*>(s + G::x_bytes + G::w_bytes);
    if constexpr (kF32) {
      const float* xf = reinterpret_cast<const float*>(s);
      const float* wf = reinterpret_cast<const float*>(s + G::x_bytes);
      unsigned ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // a0 (g, t) a1 (g+8, t) a2 (g, t+4)
        const int i = row_a + g + 8 * (q & 1), d = kk + t + 4 * (q >> 1);
        float v = xf[i * G::ldx + d];
        if (mask != nullptr) v *= ms[d];
        split(v, ah[q], al[q]);
      }
      const float* w_t = wf + (kk + t) * G::ldw + g;
      const float* w_t4 = w_t + 4 * G::ldw;
#pragma unroll
      for (int n = 0; n < kFrags; ++n)
        mma3(acc[n], ah, al, w_t[8 * n], w_t4[8 * n]);
    } else {
      const bf16* xh = reinterpret_cast<const bf16*>(s);
      const bf16* wh = reinterpret_cast<const bf16*>(s + G::x_bytes);
      unsigned af[4];
      ldsm_x4(af, xh + (row_a + (lane & 15)) * G::ldx + kk + (lane >> 4) * 8);
      if (mask != nullptr) {  // x * m in fp32, rounded to bf16 once
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int d = kk + 2 * t + 8 * (q >> 1);
          const float2 m = *reinterpret_cast<const float2*>(ms + d);
          const __nv_bfloat162 v =
              *reinterpret_cast<const __nv_bfloat162*>(&af[q]);
          const __nv_bfloat162 w = __floats2bfloat162_rn(
              __low2float(v) * m.x, __high2float(v) * m.y);
          af[q] = *reinterpret_cast<const unsigned*>(&w);
        }
      }
      const bf16* w_k = wh + (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * G::ldw;
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        unsigned bfr[4];
        ldsm_x4_t(bfr, w_k + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * dp + 1], af, bfr[2], bfr[3]);
      }
#pragma unroll
      for (int n = 4; n < kFrags; ++n) {
        unsigned b0, b1;
        ldsm_x2_t(b0, b1, w_k + 8 * n);
        mma_bf16(acc[n], af, b0, b1);
      }
    }
    if (c != nk - 1) continue;

    // the tile is summed: the k-groups' sums meet in shared memory and are
    // added in k-group order; then y = base + scale * u @ b
    const int i = j / nk;
    const Tile u = tile_of(i);
    float4* red = reinterpret_cast<float4*>(smem + G::red_off);
    if (kg > 0) {
#pragma unroll
      for (int n = 0; n < kFrags; ++n)
        red[(((kg - 1) * 2 + wm) * kFrags + n) * 32 + lane] =
            make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
    __syncthreads();
    float* base = reinterpret_cast<float*>(smem + G::base_off);
    float* us = reinterpret_cast<float*>(smem + G::u_off);
    constexpr int ldu = rp + 1;
    if (kg == 0) {
#pragma unroll
      for (int q = 0; q < kGroups - 1; ++q)
#pragma unroll
        for (int n = 0; n < kFrags; ++n) {
          const float4 v = red[((q * 2 + wm) * kFrags + n) * 32 + lane];
          acc[n][0] += v.x;
          acc[n][1] += v.y;
          acc[n][2] += v.z;
          acc[n][3] += v.w;
        }
#pragma unroll
      for (int n = 0; n < kFrags; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ii = row_a + g + 8 * (e >> 1);
            const int c = 8 * n + 2 * t + (e & 1);
            if (n < 4) {
              base[ii * (kCols + 1) + c] = acc[n][e];
            } else {
              us[ii * ldu + c - kCols] = acc[n][e];
            }
          }
    }
#pragma unroll
    for (int n = 0; n < kFrags; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    __syncthreads();
    const T* bs =
        reinterpret_cast<const T*>(smem + G::b_off +
                                   (i & (kStages - 1)) * G::b_bytes);
    T* yt = y + (u.k * Tn + u.t0) * (long long)F + u.f0;
    // a thread's outputs share one column: its b column in registers. The
    // padding (j >= r) adds 0 * 0: u's and b's padded entries are zero.
    const int col = tid % kCols;
    float bcol[rp];
#pragma unroll
    for (int jj = 0; jj < rp; ++jj) bcol[jj] = to_float(bs[jj * kCols + col]);
#pragma unroll
    for (int q = 0; q < kRows * kCols / kThreads; ++q) {
      const int ii = tid / kCols + q * (kThreads / kCols);
      float lora = 0.f;
#pragma unroll
      for (int jj = 0; jj < rp; ++jj)
        lora = fmaf(us[ii * ldu + jj], bcol[jj], lora);
      const float v = fmaf(scale, lora, base[ii * (kCols + 1) + col]);
      if (ii < u.rows && col < u.cols) {
        if constexpr (kF32) {
          yt[(long long)ii * F + col] = v;
        } else {
          yt[(long long)ii * F + col] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

template <typename T, int UF>
const void* kernel_of(bool vec) {
  return vec ? (const void*)fused_kernel<T, UF, true>
             : (const void*)fused_kernel<T, UF, false>;
}

template <typename T>
const void* kernel_of(int uf, bool vec) {
  return uf == 1   ? kernel_of<T, 1>(vec)
         : uf == 2 ? kernel_of<T, 2>(vec)
         : uf == 4 ? kernel_of<T, 4>(vec)
                   : kernel_of<T, 8>(vec);
}

// the instantiation's u fragments for rank r: 1, 2, 4 or 8
int uf_of(int r) {
  const int uf = (r + 7) / 8;
  return uf <= 1 ? 1 : uf <= 2 ? 2 : uf <= 4 ? 4 : 8;
}

const void* kernel_for(int dtype, int uf, bool vec) {
  return dtype == 1 ? kernel_of<bf16>(uf, vec) : kernel_of<float>(uf, vec);
}

template <typename T>
int smem_of(int uf) {
  return uf == 1   ? Geo<T, 1>::total
         : uf == 2 ? Geo<T, 2>::total
         : uf == 4 ? Geo<T, 4>::total
                   : Geo<T, 8>::total;
}

int smem_bytes(int dtype, int uf) {
  return dtype == 1 ? smem_of<bf16>(uf) : smem_of<float>(uf);
}

// Once per process (so a launch being captured into a CUDA graph makes no
// attribute call): every instantiation may use the card's opt-in shared
// memory per block, and the blocks of each that fit on one SM at its
// largest rank. {0, ...} on failure.
struct Card {
  int smem, sms;
  int resident[2][4][2];  // [dtype][log2 uf][vec]
};

Card configure() {
  Card c{};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&c.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return Card{};
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int lu = 0; lu < 4; ++lu)
      for (int vec = 0; vec < 2; ++vec) {
        const void* k = kernel_for(dtype, 1 << lu, vec);
        if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 c.smem) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &c.resident[dtype][lu][vec], k, kThreads,
                smem_bytes(dtype, 1 << lu)) != cudaSuccess ||
            c.resident[dtype][lu][vec] < 1)
          return Card{};
      }
  return c;
}

bool aligned16(const void* p) { return (((uintptr_t)p) & 15) == 0; }

}  // namespace

extern "C" {

// The largest rank the kernel takes (its u registers are sized for it).
int mdlora_max_rank() { return kMaxR; }

// dtype 0 = fp32, 1 = bf16 (x, W0, a, b and y). Strides are in elements
// between batch slices (0 = shared). y is [K, T, F], contiguous. `blocks`
// is the count of persistent blocks: <= 0 takes as many as are resident at
// once; any count gives the same bits (each tile is summed by one block in
// one order). The count launched is written to *used when used is not
// null. Returns a cudaError_t.
int mdlora_fused(const void* x, const void* w0, const void* a, const void* b,
                 const float* mask, float scale, int K, int T, int D, int F,
                 int r, int dtype, long long sx, long long sw, long long sa,
                 long long sb, long long sm, int blocks, int* used, void* y,
                 void* stream) {
  if (K < 1 || T < 1 || D < 1 || F < 1 || r < 1 || r > kMaxR)
    return (int)cudaErrorInvalidValue;
  static const Card card = configure();
  if (card.smem <= 0) return (int)cudaErrorInvalidValue;
  const int es = dtype == 1 ? 2 : 4;
  const long long tiles = (long long)K * ((T + kRows - 1) / kRows) *
                          ((F + kCols - 1) / kCols);
  const int nk = (D + chunk_of(es) - 1) / chunk_of(es);
  const int uf = uf_of(r);
  const int smem = smem_bytes(dtype, uf);
  if (tiles * nk > 0x7fffffff || smem > card.smem)
    return (int)cudaErrorInvalidValue;
  int n_tiles = (int)tiles;
  // 16-byte copies need every row and slice of every operand aligned
  const long long row_bytes[] = {(long long)D * es, (long long)F * es,
                                 (long long)r * es, sx * es, sw * es, sa * es,
                                 sb * es, sm * 4};
  bool vec = aligned16(x) && aligned16(w0) && aligned16(a) && aligned16(b) &&
             (mask == nullptr || aligned16(mask));
  for (long long v : row_bytes) vec = vec && v % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* kern = kernel_for(dtype, uf, vec);
  // persistent blocks, each walking its tiles with the next tile's copies
  // in flight: by default as many as are resident at once
  const int lu = uf == 1 ? 0 : uf == 2 ? 1 : uf == 4 ? 2 : 3;
  const long long slots =
      blocks > 0 ? (long long)blocks
                 : (long long)card.resident[dtype == 1][lu][vec] * card.sms;
  const long long grid = tiles < slots ? tiles : slots;
  if (used != nullptr) *used = (int)grid;
  void* args[] = {(void*)&x,  (void*)&w0, (void*)&a,  (void*)&b,
                  (void*)&mask, (void*)&scale, (void*)&T, (void*)&D,
                  (void*)&F,  (void*)&r,  (void*)&sx, (void*)&sw,
                  (void*)&sa, (void*)&sb, (void*)&sm, (void*)&n_tiles,
                  (void*)&y};
  const cudaError_t err = cudaLaunchKernel(
      kern, dim3((unsigned)grid), dim3(kThreads), args, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
