// Hopper building blocks of the flash-attention kernels' "hopper" form
// (K3 forward, K4 backward): TMA tile loads into 128-byte-swizzled shared
// memory, mbarrier rings, warpgroup matrix products (wgmma) with f32
// accumulators, and register reallocation between the producer and the
// consumer warpgroups.  sm_90a only.
//
// Shared-memory tiles.  A tile is 64 rows of a [B, L, H, D] or [B, H, L,
// D] bf16 tensor, held as D / 64 panels of [64 rows][64 columns] (128
// bytes a row, 8 KB a panel), each written by one TMA box with the
// 128-byte swizzle: the 16-byte chunk c of row r lands at chunk c ^ (r %
// 8).  Every panel is 1024-byte aligned, so the swizzle atoms (8 rows,
// 1024 bytes) line up with the addresses wgmma's descriptors decode.
//
// wgmma operands from a tile (one instruction: k = 16 bf16):
//   * K-major (the contraction runs along a row, over the head dim): a
//     64-row A or a 64-column B.  Chunk kk of the head dim lies in panel
//     kk / 4 at byte 32 (kk % 4) of each row; 8-row groups are 1024 bytes
//     apart (SBO).
//   * MN-major (the contraction runs over the tile's rows, the result's
//     columns along the head dim; the instruction's transpose bit): B of
//     p v, ds k, p^T do, ds^T q.  Chunk kk (16 rows) starts 2048 bytes
//     further; 8-row groups are 1024 bytes apart (SBO) and the 64-column
//     panels 8 KB apart (LBO).
// The accumulator of an m64nN product: warp w of the warpgroup holds rows
// 16 w + g and 16 w + g + 8 (g = lane / 4, t = lane % 4), element
// d[4 j + 2 r + e] at row 16 w + g + 8 r, column 8 j + 2 t + e.  The A
// operand from registers has the same layout per 16 columns, so a
// rounded accumulator is the next product's A without a shuffle.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "flash_attn_common.cuh"

namespace mxt_hopper {

constexpr int kThreads = 384;    // one producer warpgroup, two consumers
constexpr int kStages = 2;       // the ring of K/V (or q/do) tiles
constexpr int kPanel = 64 * 64 * 2;                 // bytes of a panel
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Host: one tensor map per operand
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found at run time, so the
// library needs no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 4-D map over (D, L, H, B) of a contiguous bf16 [B, L, H, D] (blhd) or
// [B, H, L, D] tensor; boxes of 64 columns x 64 rows, 128-byte swizzle,
// rows past L read as zeros.  Returns false if the driver refuses it.
inline bool make_map(CUtensorMap* map, const void* base, int B, int H, int L,
                     int D, int blhd) {
  auto encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t e = 2;  // bytes of a bf16
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3];  // bytes, of dims 1..3
  if (blhd) {
    strides[0] = e * D * H;
    strides[1] = e * D;
    strides[2] = e * D * H * L;
  } else {
    strides[0] = e * D;
    strides[1] = e * D * L;
    strides[2] = e * D * L * H;
  }
  cuuint32_t box[4] = {64, 64, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// Device: shared-memory addresses, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to 1024 bytes (the launch asks
// for 1024 bytes more than the layout needs).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival per warp, once all its lanes are here (a consumer warp
// releasing a ring slot).
__device__ __forceinline__ void mbar_arrive_warp(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// One arrival that also expects `bytes` of TMA traffic on this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  The retry loop
// sits inside one asm block (its labels are local to the braces), so a
// warp leaves it converged, as the .aligned wgmma instructions after it
// need.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One 64 x 64 box at (column c0, row r0, head h, batch b) into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int r0, int h, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(h), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// The D / 64 panels of the 64-row tile at row r0 (D / 64 boxes).
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         int r0, int h, int b, uint64_t* bar) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load(dst + p * kPanel, map, 64 * p, r0, h, b, bar);
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`
// (bits 0-13: address / 16; 16-29: LBO / 16; 32-45: SBO / 16; 62-63: 1 =
// 128-byte swizzle; base offset 0, as every atom is 1024-byte aligned).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Head-dim chunk kk (16 columns) of the K-major tile at `tile`.
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  return desc(smem_u32(tile) + (kk >> 2) * kPanel + (kk & 3) * 32, 16, 1024);
}

// Row chunk kk (16 rows) of the MN-major tile at `tile`.
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  return desc(smem_u32(tile) + kk * 2048, kPanel, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed product groups are
// still running (they finish in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (wgmma_fence / wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator columns [16 kk, 16 kk + 16) of an m64n64 product, rounded
// to bf16, as the A operand (registers) of the next product.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&d)[32],
                                     int kk) {
  using mxt_flash::pack_bf16;
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d (m64n64, f32) += a (smem, K-major) * b (smem; transposed by TB)
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (m64n64, f32) += a (registers) * b (smem; transposed by TB)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// d (m64n128, f32) += a (registers) * b (smem; transposed by TB)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

}  // namespace mxt_hopper
