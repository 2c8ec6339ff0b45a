// Paged flash-decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces mxnet_tpu/serve/flash_decode.py:_decode_kernel (the Pallas TPU
// kernel driven by flash_decode_attention) on the serving decode path: one
// query token per request attends over its table-addressed KV blocks.  Two
// entry points: mxt_flash_decode for plain f32/bf16 pools (K5), and
// mxt_flash_decode_fp8 for fp8 pools (K5-fp8: the quantized=True branch of
// the same TPU kernel), an e4m3 payload of 1 byte per element with one f32
// scale per cached position.
//
// What bounds it: device-memory bytes.  Every valid K/V position of every
// request is read once (2 * H * hd elements per position) for about four
// flops per element, far below the card's operations-per-byte balance.
// The design therefore only has to read each byte once and keep everything
// else on chip:
//   * grid (request, split, head): one block per triple loops over the
//     split's table entries itself (the TPU grid ran (b, split, block)
//     serially and carried the partial in its output refs; here nothing
//     carries between blocks).  The block reads its table entries from
//     global memory -- there is no scalar prefetch -- and reads each
//     table-addressed block exactly once, only at positions < length.
//     Positions past a request's length, and table columns past the end
//     (the TPU version's trash-padded split tail), are never read.
//   * each warp takes every 4th position of the split and keeps its own
//     online-softmax partial (acc in registers, m and l as scalars); lanes
//     split the head dimension, so a K or V row is one coalesced read (for
//     fp8 at hd 64: two 32-byte sectors, one byte a lane).
//   * fp8 pools: the payload is read as one byte per element and widened
//     to f32 in registers, and each position's K and V scales (indexed by
//     the same table[j] * BS + offset as the payload row) are read once
//     per warp.  Scale placement: every dequantized element is its payload
//     times its position's scale BEFORE the dot and the p-weighted sum, as
//     the JAX body does (k * kscale[:, None, None]); HBM traffic stays the
//     1-byte payload plus 4 bytes of scale per position and pool.
//   * the four warp partials merge in shared memory and the block writes
//     one (acc[hd], m, l) partial, once.
//   * a second small kernel, shared by both entry points, combines the
//     split partials exactly as the JAX package does outside Pallas:
//     m* = max m, w = exp(m - m*), l* = max(sum l w, 1e-30),
//     out = sum acc w / l*.
// Scores and statistics are f32 (f32, bf16 or fp8 inputs), scaled by
// `scale` after the dot product, masked with NEG_INF = -1e30.  An empty
// split keeps (m = NEG_INF, l = 0, acc = 0); all rescales are
// exp(finite - finite), so a fully masked split gives no NaN.  Simple and
// correct first: no vectorised loads, no wgmma, no TMA, no cp.async.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stddef.h>

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

template <typename TQ, typename TKV, bool kQuant = false>
cudaError_t launch(const void* q, const void* k, const void* v,
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

}  // namespace

namespace {

bool bad_shape(int B, int H, int hd, int BS, int nblk, int splits, int bps) {
  return B < 1 || H < 1 || hd < 1 || hd > kMaxHeadDim || BS < 1 ||
         nblk < 1 || splits < 1 || bps < 1 || splits > 65535 || H > 65535;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  The output has q's dtype.
// Returns a cudaError_t (0 = launched).
int mxt_flash_decode(const void* q, int q_dtype, const void* k,
                     const void* v, int kv_dtype, const int* tables,
                     const int* lengths, float* acc, float* m, float* l,
                     void* out, int B, int H, int hd, int BS, int nblk,
                     int splits, int bps, float scale, void* stream) {
  if (bad_shape(B, H, hd, BS, nblk, splits, bps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return (int)launch<float, float>(q, k, v, nullptr, nullptr, tables,
                                     lengths, acc, m, l, out, B, H, hd, BS,
                                     nblk, splits, bps, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return (int)launch<float, bf16>(q, k, v, nullptr, nullptr, tables,
                                    lengths, acc, m, l, out, B, H, hd, BS,
                                    nblk, splits, bps, scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return (int)launch<bf16, float>(q, k, v, nullptr, nullptr, tables,
                                    lengths, acc, m, l, out, B, H, hd, BS,
                                    nblk, splits, bps, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)launch<bf16, bf16>(q, k, v, nullptr, nullptr, tables,
                                   lengths, acc, m, l, out, B, H, hd, BS,
                                   nblk, splits, bps, scale, st);
  return (int)cudaErrorInvalidValue;
}

// fp8 pools: k, v [NB, BS, H, hd] e4m3 bytes; kscale, vscale [NB, BS] f32.
// q_dtype as above; the output has q's dtype.  Returns a cudaError_t.
int mxt_flash_decode_fp8(const void* q, int q_dtype, const void* k,
                         const void* v, const float* kscale,
                         const float* vscale, const int* tables,
                         const int* lengths, float* acc, float* m, float* l,
                         void* out, int B, int H, int hd, int BS, int nblk,
                         int splits, int bps, float scale, void* stream) {
  if (bad_shape(B, H, hd, BS, nblk, splits, bps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using fp8 = __nv_fp8_e4m3;
  if (q_dtype == 0)
    return (int)launch<float, fp8, true>(q, k, v, kscale, vscale, tables,
                                         lengths, acc, m, l, out, B, H, hd,
                                         BS, nblk, splits, bps, scale, st);
  if (q_dtype == 1)
    return (int)launch<__nv_bfloat16, fp8, true>(
        q, k, v, kscale, vscale, tables, lengths, acc, m, l, out, B, H, hd,
        BS, nblk, splits, bps, scale, st);
  return (int)cudaErrorInvalidValue;
}

int mxt_max_head_dim(void) { return kMaxHeadDim; }

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
