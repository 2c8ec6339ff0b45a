// Shared pieces of the flash-attention kernels (K3 forward, K4 backward).
//
// Tiles: a block of 16 x 16 = 256 threads owns a tile of 16 * R rows; the
// thread (ty, tx) holds the R x R scores of rows ty + 16 i and columns
// tx + 16 j, and R output rows ty + 16 i over the columns tx + 16 jd of the
// head dim.  The head dim is zero-padded to DP (16, 32, 64, 128 or 256) in
// shared memory, where tiles are held as f32 rows of DP + 1 floats: the
// odd row stride puts the 16 rows a half-warp reads at one column in 16
// different banks.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mxt_flash {

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and widened again: the `.astype(T)` before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Element offset of row (b, h, l) of a [B, H, L, D] (bhld) or [B, L, H, D]
// (blhd) contiguous tensor.
struct Layout {
  int H, L, D, blhd;
  __device__ __forceinline__ size_t row(int b, int h, int l) const {
    return blhd ? ((size_t)(b * L + l) * H + h) * D
                : ((size_t)(b * H + h) * L + l) * D;
  }
};

// Rows [r0, r0 + ROWS) of head (b, h) into dst[ROWS][DP + 1] as f32, zero
// past the sequence end and past D.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          const Layout& lay, int b, int h,
                                          int r0) {
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float x = 0.f;
    if (r0 + r < lay.L && c < lay.D) x = to_f(src[lay.row(b, h, r0 + r) + c]);
    dst[r * (DP + 1) + c] = x;
  }
}

// Reductions over the 16 lanes (tx) that share one row.
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows per thread for a padded head dim: 4 (tiles of 64) up to 128, 2
// (tiles of 32) at 256, so the f32 tiles fit in shared memory.
// flash_attention.kernel_tile in Python mirrors this.
template <int DP> struct Rows { static constexpr int value = DP <= 128 ? 4 : 2; };

// ---------------------------------------------------------------------------
// Tensor-core pieces of the bf16 kernels (head dim <= 128): warp-wide
// mma.sync m16n8k16, bf16 operands, f32 accumulators.  Lane l of a warp is
// (g, t) = (l / 4, l % 4).  A (16 x 16, row-major) sits in 4 registers of
// two bf16: rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9.  B
// (16 x 8, k x n) in 2: k = 2t, 2t + 1 and 2t + 8, 2t + 9, column n = g.
// C (16 x 8 f32) in 4: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// So a C tile pair converts to the A operand of the next product in
// registers, and a B operand is two 32-bit shared-memory loads from a
// row-major [n][k] tile.  Tiles are kept as bf16 rows of (width + 8)
// elements: the 8 rows x 4 words a warp reads then hit 32 banks.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps, 16 rows each

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even), the first in the low
// half: the element order of the mma operand registers.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [r0, r0 + ROWS) of head (b, h) into dst as bf16, zero past the
// sequence end and past D: row-major [ROWS][DP + 8], or with TRANS
// column-major [DP][ROWS + 8] (the layout a B operand over rows needs).
// When D is a multiple of 8 and src is 16-byte aligned, each thread moves
// 8 elements with one 16-byte load; a transposed tile is then read with
// the 32 lanes of a warp on 32 rows, so its stores fill consecutive
// addresses.
template <int ROWS, int DP, bool TRANS>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
    const Layout& lay, int b, int h, int r0) {
  constexpr int NV = DP / 8;
  if (lay.D % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int idx = threadIdx.x; idx < ROWS * NV; idx += kMmaThreads) {
      const int r = TRANS ? idx % ROWS : idx / NV;
      const int c = 8 * (TRANS ? idx / ROWS : idx % NV);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < lay.L && c < lay.D)
        x = *reinterpret_cast<const uint4*>(src + lay.row(b, h, r0 + r) + c);
      if (TRANS) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[(c + j) * (ROWS + 8) + r] = e[j];
      } else {
        *reinterpret_cast<uint4*>(dst + r * (DP + 8) + c) = x;
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += kMmaThreads) {
    const int r = idx / DP, c = idx % DP;
    __nv_bfloat16 x = __float2bfloat16_rn(0.f);
    if (r0 + r < lay.L && c < lay.D) x = src[lay.row(b, h, r0 + r) + c];
    if (TRANS)
      dst[c * (ROWS + 8) + r] = x;
    else
      dst[r * (DP + 8) + c] = x;
  }
}

}  // namespace mxt_flash
