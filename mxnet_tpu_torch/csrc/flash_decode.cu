// Paged flash-decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces mxnet_tpu/serve/flash_decode.py:_decode_kernel (the Pallas TPU
// kernel driven by flash_decode_attention) on the serving decode path: one
// query token per request attends over its table-addressed KV blocks.  One
// entry point, mxt_flash_decode, takes plain f32/bf16 pools (K5) and fp8
// pools (K5-fp8: the quantized=True branch of the same TPU kernel), an e4m3
// payload of 1 byte per element with one f32 scale per cached position.
//
// What bounds it: device-memory bytes.  Every valid K/V position of every
// request is read once (2 * H * hd elements per position) for about four
// flops per element: one query row per head makes it a matrix-vector
// product, some 300x below the card's operations-per-byte balance, so the
// tensor cores (wgmma) have nothing to give.  The lever is bytes in flight.
// Two forms compute the same function:
//
// "hopper" (decode_hopper_kernel): bulk-copy rings.
//   * a block owns (request, part of a split, head group of G heads); the
//     parts subdivide each split's table columns so enough blocks exist to
//     fill the card (the wrapper's hopper_plan picks G and the parts).
//   * the block reads its table entries once into shared memory; no
//     position waits on a table read.
//   * one elected producer thread copies each entry's K and V rows for the
//     group (one contiguous run when G == H, else one run of G * hd
//     elements per position) and, for fp8, the entry's K and V scale rows,
//     with cp.async.bulk (1-D TMA, no tensor map) into a ring of up to 4
//     stages, each with two full mbarriers (K and both scale rows, then
//     V, so q.k and the softmax run while V lands) and an empty one; it
//     keeps up to S - 1 entries in flight while the consumers work on the
//     oldest.  Only the
//     positions < length of an entry are copied; a part whose first
//     position is >= length copies nothing and returns.
//   * one consumer warp per head: q sits in registers; a lane holds 16
//     elements of a row in 16-byte chunks (tx = hd / 16 lanes a
//     position, ty = 32 / tx positions a pass, 2 passes a group: 16
//     positions at hd 64), so a dot product needs log2(tx) shuffles and
//     a lane two exps a group.  A group's loads are in flight together
//     (rows past the valid positions are clamped and masked, never
//     branched around), its scores and probabilities stay in registers,
//     and ONE online-softmax (m, l, acc) update per group and head
//     follows (one per table entry at hd 64, BS 16), then p.V.  fp8 is
//     widened two values per instruction (cvt e4m3x2 -> f16x2); its
//     scales multiply the dot product and the probability (s = (q . k) *
//     kscale * scale, acc += (p * vscale) * v), which equals scaling
//     every element up to f32 rounding.
//   * the combine runs in the same launch: each (request, head group) has
//     an int32 ticket; every non-empty part writes its partial (acc, m, l),
//     fences and takes a ticket; the last one combines the partials in
//     part order with _combine's formula (m* = max m, w = exp(m - m*),
//     l* = max(sum l w, 1e-30), out = sum acc w / l*) and resets the
//     ticket to 0.  A single non-empty part writes out directly.  The
//     order is fixed, so the output is bitwise repeatable.
//   The form needs 16-byte aligned pools (and scales), hd * element size a
//   multiple of 16 bytes, and for fp8 BS a multiple of 4 (scale rows of
//   BS * 4 bytes): the bulk copy's rules.
//
// "warp" (decode_partial_kernel + combine_kernel): the first port.
//   * grid (request, split, head); each of a block's 4 warps takes every
//     4th position of the split, reading the table entry, then the K row
//     (lanes split the head dim), a shuffle reduction, two exps and the V
//     row: one dependent chain per position.  The four warp partials merge
//     in shared memory; a second kernel combines the split partials.
//   It takes any alignment and any hd <= 256.
//
// Scores and statistics are f32 (f32, bf16 or fp8 inputs), scaled by
// `scale` after the dot product, masked with NEG_INF = -1e30.  An empty
// split keeps (m = NEG_INF, l = 0, acc = 0); all rescales are
// exp(finite - finite), so a fully masked split gives no NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stddef.h>

#include "flash_attn_hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kMaxHeadDim = 256;
constexpr int kPerLane = kMaxHeadDim / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---------------------------------------------------------------------------
// "warp" form
// ---------------------------------------------------------------------------

// q [B, H, hd]; k, v [NB, BS, H, hd]; with kQuant, kscale and vscale
// [NB, BS] (else unused); tables [B, nblk]; lengths [B].
// Writes acc [B, S, H, hd], m [B, S, H], l [B, S, H] (f32), S = gridDim.y.
template <typename TQ, typename TKV, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32)
decode_partial_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                      const TKV* __restrict__ v,
                      const float* __restrict__ kscale,
                      const float* __restrict__ vscale,
                      const int* __restrict__ tables,
                      const int* __restrict__ lengths,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int H, int hd, int BS,
                      int nblk, int bps, float scale) {
  const int b = blockIdx.x, s = blockIdx.y, h = blockIdx.z;
  const int splits = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float qr[kPerLane], acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < hd ? to_f32(q[((size_t)b * H + h) * hd + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // this split's positions: logical blocks [j0, j1) clipped to the table
  // and to the request's length
  const int j0 = s * bps;
  const int j1 = min(j0 + bps, nblk);
  const int p_end = min(j1 * BS, lengths[b]);
  const int* table = tables + (size_t)b * nblk;
  for (int p = j0 * BS + warp; p < p_end; p += kWarps) {
    const int j = p / BS;
    const size_t row = (size_t)table[j] * BS + (p - j * BS);
    const size_t base = (row * H + h) * (size_t)hd;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = kscale[row];
      vsc = vscale[row];
    }
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) {
        if constexpr (kQuant)
          dot += qr[i] * (to_f32(k[base + d]) * ksc);
        else
          dot += qr[i] * to_f32(k[base + d]);
      }
    }
    const float score = warp_sum(dot) * scale;
    const float m_new = fmaxf(m, score);
    const float alpha = expf(m - m_new);
    const float pexp = expf(score - m_new);
    l = l * alpha + pexp;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) {
        if constexpr (kQuant)
          acc[i] = acc[i] * alpha + pexp * (to_f32(v[base + d]) * vsc);
        else
          acc[i] = acc[i] * alpha + pexp * to_f32(v[base + d]);
      }
    }
    m = m_new;
  }

  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxHeadDim];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) sm_acc[warp][d] = acc[i];
  }
  __syncthreads();

  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wt[kWarps];
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = expf(sm_m[w] - mx);
    lsum += sm_l[w] * wt[w];
  }
  const size_t o = ((size_t)b * splits + s) * H + h;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * wt[w];
    acc_out[o * hd + d] = a;
  }
  if (threadIdx.x == 0) {
    m_out[o] = mx;
    l_out[o] = lsum;
  }
}

// Split-K combine: one block per (request, head).  out [B, H, hd].
template <typename TO>
__global__ void combine_kernel(const float* __restrict__ acc,
                               const float* __restrict__ m,
                               const float* __restrict__ l,
                               TO* __restrict__ out, int S, int H, int hd) {
  const int b = blockIdx.x, h = blockIdx.y;
  float mx = kNegInf;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, m[((size_t)b * S + s) * H + h]);
  float lsum = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t i = ((size_t)b * S + s) * H + h;
    lsum += l[i] * expf(m[i] - mx);
  }
  lsum = fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t i = ((size_t)b * S + s) * H + h;
      a += acc[i * hd + d] * expf(m[i] - mx);
    }
    store(out + ((size_t)b * H + h) * hd + d, a / lsum);
  }
}

template <typename TQ, typename TKV, bool kQuant>
cudaError_t launch_warp(const void* q, const void* k, const void* v,
                        const float* kscale, const float* vscale,
                        const int* tables, const int* lengths, float* acc,
                        float* m, float* l, void* out, int B, int H, int hd,
                        int BS, int nblk, int splits, int bps, float scale,
                        cudaStream_t stream) {
  decode_partial_kernel<TQ, TKV, kQuant><<<dim3(B, splits, H), kWarps * 32,
                                           0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), kscale, vscale, tables, lengths, acc, m,
      l, H, hd, BS, nblk, bps, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = hd < 32 ? 32 : (hd > 256 ? 256 : hd);
  combine_kernel<TQ><<<dim3(B, H), threads, 0, stream>>>(
      acc, m, l, static_cast<TQ*>(out), splits, H, hd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "hopper" form
// ---------------------------------------------------------------------------

constexpr int kMaxGroup = 8;      // consumer warps (heads) of a block
constexpr int kMaxStages = 4;     // the ring of table entries
// bytes of dynamic shared memory a block can use: the card's 232,448 less
// room for the kernel's static barriers
constexpr int kMaxSmem = 232448 - 1024;
constexpr int kPass = 2;          // passes of ty positions a group
constexpr int kCombineUnroll = 4; // partials read at once by the combine

// One 16-byte shared-memory load of T widened to f32: n = 4 (f32), 8
// (bf16) or 16 (fp8: two e4m3 values to two halves in one cvt, exact,
// then f32) elements.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Chunk<__nv_fp8_e4m3> {
  static constexpr int n = 16;
  __device__ __forceinline__ static void load(const __nv_fp8_e4m3* p,
                                              float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)(w[i / 2] >> (16 * (i % 2))), __NV_E4M3)));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// One 1-D bulk copy (TMA without a tensor map) of `bytes` (a multiple of
// 16, both addresses 16-byte aligned) from global to shared memory; its
// bytes complete a transaction of the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(mxt_hopper::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(mxt_hopper::smem_u32(bar))
      : "memory");
}

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// Shared-memory layout of one block: S stages of [K rows | V rows | K
// scales | V scales], then the part's table entries.
struct HopperSmem {
  int kv, sc, stage, table, total;
  __host__ __device__ HopperSmem(int BS, int G, int hd, int esize,
                                 bool quant, int S, int eps) {
    kv = align128(BS * G * hd * esize);
    sc = quant ? align128(BS * 4) : 0;
    stage = 2 * kv + 2 * sc;
    table = S * stage;
    total = table + eps * 4 + 128;  // + 128: base alignment slack
  }
};

// Grid (B, H / G head groups, NP = splits * P parts: the parts vary
// slowest, so the first parts, never empty, are scheduled first).  Part
// i = s * P + p
// covers table columns [s * bps + p * eps, min(s * bps + min((p + 1) *
// eps, bps), nblk)).  Writes acc [B, NP, H, hd], m and l [B, NP, H] for
// the non-empty parts, out [B, H, hd]; tickets [B, H / G] are 0 on entry
// and on exit.
template <typename TQ, typename TKV>
__global__ void decode_hopper_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    TQ* __restrict__ out, int* __restrict__ tickets, int H, int hd, int BS,
    int nblk, int bps, int P, int eps, int G, int S, float scale) {
  using mxt_hopper::mbar_arrive;
  using mxt_hopper::mbar_arrive_tx;
  using mxt_hopper::mbar_fence_init;
  using mxt_hopper::mbar_init;
  using mxt_hopper::mbar_wait;
  using mxt_hopper::smem_u32;
  constexpr bool kQuant = sizeof(TKV) == 1;
  const int b = blockIdx.x, g = blockIdx.y, part = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = part / P, p = part % P;
  const int e0 = s * bps + p * eps;  // the part's columns: [e0, e1)
  const int e1 = min(s * bps + min((p + 1) * eps, bps), nblk);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const HopperSmem lay(BS, G, hd, (int)sizeof(TKV), kQuant, S, eps);
  int* tab = reinterpret_cast<int*>(smem + lay.table);
  // per stage: K rows (+ K scales) full, V rows (+ V scales) full, empty
  __shared__ uint64_t full_k[kMaxStages], full_v[kMaxStages],
      empty[kMaxStages];
  __shared__ int last;

  // the length and the part's table entries in one round trip
  const int len = lengths[b];
  const int* trow = tables + (size_t)b * nblk + e0;
  for (int i = threadIdx.x; i < e1 - e0; i += blockDim.x) tab[i] = trow[i];

  // the parts before the request's end form a prefix 0 .. ne - 1
  const int lim = min(nblk, (max(len, 0) + BS - 1) / BS);
  int ne = 1;
  if (lim > 0) {
    const int s_last = (lim - 1) / bps;
    ne = s_last * P + min(P, (lim - s_last * bps + eps - 1) / eps);
  }
  if (part >= ne) return;
  const int n = max(min(e1, lim) - e0, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty[i], G);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int row = G * hd * (int)sizeof(TKV);  // bytes of a position's group
  if (warp == G) {
    // producer: one elected thread keeps up to S - 1 entries in flight
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int st = i % S;
        if (i >= S) mbar_wait(&empty[st], ((i / S) - 1) & 1);
        const int nv = min(BS, len - (e0 + i) * BS);
        const int scb = kQuant ? (nv * 4 + 15) / 16 * 16 : 0;
        uint8_t* kd = smem + st * lay.stage;
        uint8_t* vd = kd + lay.kv;
        const size_t r0 = (size_t)tab[i] * BS;  // the entry's first row
        // K and both scale rows first: the consumers start on q . k and
        // the softmax (which reads both scale rows) while V lands
        const TKV* src[2] = {k, v};
        uint8_t* dst[2] = {kd, vd};
        uint64_t* bar[2] = {&full_k[st], &full_v[st]};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mbar_arrive_tx(bar[t], nv * row + (t == 0 ? 2 * scb : 0));
          if (kQuant && t == 0) {
            bulk_copy(kd + 2 * lay.kv, kscale + r0, scb, bar[0]);
            bulk_copy(kd + 2 * lay.kv + lay.sc, vscale + r0, scb, bar[0]);
          }
          if (G == H) {  // the entry's rows are one contiguous run
            bulk_copy(dst[t], src[t] + r0 * H * hd, nv * row, bar[t]);
          } else {
            for (int r = 0; r < nv; ++r)
              bulk_copy(dst[t] + r * row,
                        src[t] + ((r0 + r) * H + (size_t)g * G) * hd, row,
                        bar[t]);
          }
        }
      }
    }
    return;
  }

  // consumer warp `warp` owns head h.  A lane holds 16 elements of a
  // row: kNC 16-byte chunks of kCE elements, chunk c of lane tx_i being
  // chunk c * tx + tx_i of the row, so tx = hd / 16 lanes share a
  // position (4 at hd 64) and ty = 32 / tx positions make a pass; kPass
  // passes make a group (16 positions at hd 64).  A group's loads go out
  // together (rows past the valid positions are clamped to the last
  // valid row and masked, never branched around); its scores and
  // probabilities stay in registers; ONE online-softmax (m, l, acc)
  // update a group and head follows (one a table entry at hd 64, BS 16).
  constexpr int kCE = Chunk<TKV>::n;
  constexpr int kNC = 16 / kCE;
  const int h = g * G + warp;
  const int nch = hd / kCE;  // chunks of a row
  int tx = 1;
  while (tx * kNC < nch) tx <<= 1;
  const int ty = 32 / tx, ty_i = lane / tx, tx_i = lane % tx;
  float qf[16], acc[16];
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    const int ch = c * tx + tx_i;
#pragma unroll
    for (int e = 0; e < kCE; ++e) {
      qf[c * kCE + e] =
          ch < nch ? to_f32(q[((size_t)b * H + h) * hd + ch * kCE + e]) : 0.f;
      acc[c * kCE + e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;  // l: this lane's positions, summed at the end
  for (int i = 0; i < n; ++i) {
    const int st = i % S;
    const int nv = min(BS, len - (e0 + i) * BS);
    const TKV* kb = reinterpret_cast<const TKV*>(smem + st * lay.stage);
    const TKV* vb = reinterpret_cast<const TKV*>(smem + st * lay.stage +
                                                 lay.kv);
    const float* ksc = reinterpret_cast<const float*>(
        smem + st * lay.stage + 2 * lay.kv);
    const float* vsc = ksc + lay.sc / 4;
    mbar_wait(&full_k[st], (i / S) & 1);

    for (int p0 = 0; p0 < nv; p0 += kPass * ty) {
      int row[kPass];
      float x[kPass];
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        row[u] = (min(p0 + u * ty + ty_i, nv - 1) * G + warp) * hd;
        x[u] = 0.f;
      }
      // q . k over the lane's chunks, summed over the tx lanes
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int ch = min(c * tx + tx_i, nch - 1) * kCE;
#pragma unroll
        for (int u = 0; u < kPass; ++u) {
          float kx[kCE];
          Chunk<TKV>::load(kb + row[u] + ch, kx);
#pragma unroll
          for (int e = 0; e < kCE; ++e)
            x[u] = fmaf(qf[c * kCE + e], kx[e], x[u]);
        }
      }
      for (int o = tx >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kPass; ++u)
          x[u] += __shfl_xor_sync(0xffffffffu, x[u], o);
      }
      // scores, the group's max over the ty position groups, then p
      float gmax = kNegInf;
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int pos = p0 + u * ty + ty_i;
        x[u] = pos < nv ? (kQuant ? x[u] * ksc[min(pos, nv - 1)] : x[u]) *
                              scale
                        : kNegInf;
        gmax = fmaxf(gmax, x[u]);
      }
      for (int o = tx; o < 32; o <<= 1)
        gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
      const float m_new = fmaxf(m, gmax);
      const float alpha = expf(m - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int pos = p0 + u * ty + ty_i;
        const float pe = pos < nv ? expf(x[u] - m_new) : 0.f;
        lsum += pe;
        x[u] = kQuant ? pe * vsc[min(pos, nv - 1)] : pe;
      }
      l = l * alpha + lsum;
      m = m_new;
      // acc = acc * alpha + p . V
      if (p0 == 0) mbar_wait(&full_v[st], (i / S) & 1);
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] *= alpha;
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int ch = min(c * tx + tx_i, nch - 1) * kCE;
#pragma unroll
        for (int u = 0; u < kPass; ++u) {
          float vx[kCE];
          Chunk<TKV>::load(vb + row[u] + ch, vx);
#pragma unroll
          for (int e = 0; e < kCE; ++e)
            acc[c * kCE + e] = fmaf(x[u], vx[e], acc[c * kCE + e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // sum acc and l over the ty position groups (the tx lanes of a group
  // hold the same l)
  for (int o = tx; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    l += __shfl_xor_sync(0xffffffffu, l, o);
  }

  const int HG = H / G;
  TQ* orow = out + ((size_t)b * H + h) * hd;
  if (ne == 1) {  // the only partial: out = acc / max(l, 1e-30)
    const float ls = fmaxf(l, 1e-30f);
    if (ty_i == 0) {
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int ch = c * tx + tx_i;
        if (ch < nch) {
#pragma unroll
          for (int e = 0; e < kCE; ++e)
            store(orow + ch * kCE + e, acc[c * kCE + e] / ls);
        }
      }
    }
    return;
  }
  const int NP = gridDim.z;
  const size_t pi = ((size_t)b * NP + part) * H + h;
  if (ty_i == 0) {
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int ch = c * tx + tx_i;
      if (ch < nch) {
#pragma unroll
        for (int e = 0; e < kCE; ++e)
          acc_out[pi * hd + ch * kCE + e] = acc[c * kCE + e];
      }
    }
  }
  if (lane == 0) {
    m_out[pi] = m;
    l_out[pi] = l;
  }
  // the last of the ne parts to finish combines: after the consumers'
  // barrier, one thread's release-acquire ticket publishes this part's
  // partial and, for the last part, acquires the others'
  asm volatile("bar.sync 1, %0;\n" ::"r"(G * 32) : "memory");
  int* ticket = tickets + (size_t)b * HG + g;
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(ticket)
                 : "memory");
    last = old == ne - 1;
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(G * 32) : "memory");
  if (!last) return;
  // lane r reads the statistics of parts r, r + 32, ...; the partials'
  // acc rows are read kCombineUnroll at a time and summed in part order
  const size_t p0i = (size_t)b * NP * H + h;  // part 0 of head h
  float mx = kNegInf;
  for (int i = lane; i < ne; i += 32)
    mx = fmaxf(mx, __ldcg(m_out + p0i + (size_t)i * H));
  mx = warp_max(mx);
  float a[kPerLane] = {};
  float ls = 0.f;
  for (int i0 = 0; i0 < ne; i0 += 32) {
    float w = 0.f;
    if (i0 + lane < ne) {
      const size_t ii = p0i + (size_t)(i0 + lane) * H;
      w = expf(__ldcg(m_out + ii) - mx);
      ls += __ldcg(l_out + ii) * w;
    }
    const int cnt = min(32, ne - i0);
    for (int r0 = 0; r0 < cnt; r0 += kCombineUnroll) {
      float x[kCombineUnroll][kPerLane];
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) {
        const size_t ii = p0i + (size_t)(i0 + r0 + u) * H;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int dd = lane + 32 * j;
          x[u][j] = r0 + u < cnt && dd < hd ? __ldcg(acc_out + ii * hd + dd)
                                            : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) {
        const float wu = __shfl_sync(0xffffffffu, w, (r0 + u) & 31);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) a[j] += x[u][j] * wu;
      }
    }
  }
  ls = fmaxf(warp_sum(ls), 1e-30f);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int dd = lane + 32 * j;
    if (dd < hd) store(orow + dd, a[j] / ls);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <typename TQ, typename TKV>
cudaError_t launch_hopper(const void* q, const void* k, const void* v,
                          const float* kscale, const float* vscale,
                          const int* tables, const int* lengths, float* acc,
                          float* m, float* l, void* out, int* tickets, int B,
                          int H, int hd, int BS, int nblk, int splits,
                          int bps, int G, int P, int eps, int S, float scale,
                          cudaStream_t stream) {
  constexpr bool kQuant = sizeof(TKV) == 1;
  const int esize = (int)sizeof(TKV);
  if (G < 1 || G > kMaxGroup || H % G != 0 || S < 1 || S > kMaxStages ||
      P < 1 || eps < 1 || (long long)P * eps < bps ||
      (long long)(P - 1) * eps >= bps || splits * P > 65535 ||
      tickets == nullptr ||
      (hd * esize) % 16 != 0 || !mxt_hopper::aligned16(k) ||
      !mxt_hopper::aligned16(v) ||
      (kQuant && (BS % 4 != 0 || !mxt_hopper::aligned16(kscale) ||
                  !mxt_hopper::aligned16(vscale))))
    return cudaErrorInvalidValue;
  const HopperSmem lay(BS, G, hd, esize, kQuant, S, eps);
  if (lay.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = decode_hopper_kernel<TQ, TKV>;
  // the dynamic shared-memory limit is raised only when a launch needs
  // more than this instance was given on this device (an attribute call
  // per launch would cost host time every decode step)
  static int raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (lay.total > 48 * 1024 && !(dev < 64 && raised[dev] >= lay.total)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             lay.total);
    if (e != cudaSuccess) return e;
    if (dev < 64) raised[dev] = lay.total;
  }
  kern<<<dim3(B, H / G, splits * P), 32 * (G + 1), lay.total, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), kscale, vscale, tables, lengths, acc, m, l,
      static_cast<TQ*>(out), tickets, H, hd, BS, nblk, bps, P, eps, G, S,
      scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch(int form, const void* q, const void* k, const void* v,
                   const float* kscale, const float* vscale,
                   const int* tables, const int* lengths, float* acc,
                   float* m, float* l, void* out, int* tickets, int B, int H,
                   int hd, int BS, int nblk, int splits, int bps, int G,
                   int P, int eps, int S, float scale, cudaStream_t stream) {
  if (form == 1)
    return launch_hopper<TQ, TKV>(q, k, v, kscale, vscale, tables, lengths,
                                  acc, m, l, out, tickets, B, H, hd, BS, nblk,
                                  splits, bps, G, P, eps, S, scale, stream);
  if (form == 0)
    return launch_warp<TQ, TKV, sizeof(TKV) == 1>(
        q, k, v, kscale, vscale, tables, lengths, acc, m, l, out, B, H, hd,
        BS, nblk, splits, bps, scale, stream);
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int H, int hd, int BS, int nblk, int splits, int bps) {
  return B < 1 || H < 1 || hd < 1 || hd > kMaxHeadDim || BS < 1 ||
         nblk < 1 || splits < 1 || bps < 1 || splits > 65535 || H > 65535;
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16 (the output has q's dtype).
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn with kscale and
// vscale [NB, BS] f32.  form: 0 = "warp" (acc/m/l hold [B, splits, H,
// ...]), 1 = "hopper" (acc/m/l hold [B, splits * P, H, ...]; G, P, eps and
// S from the wrapper's plan; tickets [B, H / G] int32, zero).  A form the
// operands do not allow returns cudaErrorInvalidValue.  Returns a
// cudaError_t (0 = launched).
int mxt_flash_decode(const void* q, int q_dtype, const void* k,
                     const void* v, int kv_dtype, const float* kscale,
                     const float* vscale, const int* tables,
                     const int* lengths, float* acc, float* m, float* l,
                     void* out, int* tickets, int B, int H, int hd, int BS,
                     int nblk, int splits, int bps, int form, int G, int P,
                     int eps, int S, float scale, void* stream) {
  if (bad_shape(B, H, hd, BS, nblk, splits, bps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  using fp8 = __nv_fp8_e4m3;
#define MXT_DECODE(TQ, TKV)                                                  \
  return (int)launch<TQ, TKV>(form, q, k, v, kscale, vscale, tables, lengths, \
                              acc, m, l, out, tickets, B, H, hd, BS, nblk,    \
                              splits, bps, G, P, eps, S, scale, st)
  if (q_dtype == 0 && kv_dtype == 0) MXT_DECODE(float, float);
  if (q_dtype == 0 && kv_dtype == 1) MXT_DECODE(float, bf16);
  if (q_dtype == 1 && kv_dtype == 0) MXT_DECODE(bf16, float);
  if (q_dtype == 1 && kv_dtype == 1) MXT_DECODE(bf16, bf16);
  if (kscale != nullptr && vscale != nullptr) {
    if (q_dtype == 0 && kv_dtype == 2) MXT_DECODE(float, fp8);
    if (q_dtype == 1 && kv_dtype == 2) MXT_DECODE(bf16, fp8);
  }
#undef MXT_DECODE
  return (int)cudaErrorInvalidValue;
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
