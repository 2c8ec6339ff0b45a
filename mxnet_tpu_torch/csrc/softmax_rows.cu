// Row softmax for Hopper (sm_90a), with a plain C interface.
//
// Replaces mxnet_tpu/ops/nn_ops.py:_pallas_softmax_rows (the Pallas TPU
// kernel that _softmax_rows dispatches to): out[i, :] = exp(x[i, :] - m_i)
// / sum_j exp(x[i, j] - m_i), m_i = max_j x[i, j], over a row-major [N, C]
// float32 or bfloat16 array, C <= 16384.  On the training path it is the
// SoftmaxOutput forward over the classifier's logits ([batch, 1000] f32 for
// ResNet-50).
//
// What bounds it: device-memory bytes.  Each element is read and written
// once for about five flops (max, subtract, exp, add, divide), far below
// the card's operations-per-byte balance; at the training shape the whole
// [64, 1000] array is 512 KB in and out, which the card moves in well under
// a microsecond, so the launch and one round trip to device memory set the
// time.  The design only has to touch each byte once, with as few
// dependent steps as possible.  Two forms:
//   * "warp" (C <= 1024, softmax_rows_warp_kernel): one warp per row, four
//     rows to a block.  The row is held in registers (at most 32 values a
//     lane), loaded with 16-byte vectors when C * element size and both
//     bases are 16-byte aligned, else with scalar loads; all of a lane's
//     loads are in flight at once (a slot past the row re-reads its last
//     slot and is masked, never branched around), so the row costs one
//     round trip.  Max and sum are shuffle reductions (no shared memory,
//     no __syncthreads); exp(x - m) is computed once and kept in
//     registers; the row is read from device memory once.
//   * "block" (any C <= 16384, softmax_rows_kernel): one block per row
//     (the TPU kernel streamed row blocks through VMEM in grid order; here
//     rows are independent blocks in no order).  Pass 1: each thread walks
//     its strided columns keeping an online (max, sum of exp(x - max))
//     pair in f32 registers; a warp-shuffle merge and one shared-memory
//     merge across warps give the row's (m, s).  Pass 2 writes exp(x - m)
//     / s; its second read of the row hits L1/L2.
// Both divide truly (__fdiv_rn), as the Pallas body does (nn_ops.py:864),
// not by multiplying with the reciprocal.  bfloat16 input is widened to
// f32 on load and rounded to nearest even on store.  -inf inputs
// contribute exp(-inf) = 0; NaN propagates to the row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16384;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Merge the partial (m2, s2) into (m, s).  An empty partial (s == 0,
// m == -inf) contributes nothing and never forms exp(-inf - -inf).
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mx = fmaxf(m, m2);
  const float a = s == 0.f ? 0.f : s * expf(m - mx);
  const float b = s2 == 0.f ? 0.f : s2 * expf(m2 - mx);
  m = mx;
  s = a + b;
}

template <typename T>
__global__ void softmax_rows_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, int C) {
  const T* row = x + (size_t)blockIdx.x * C;
  T* orow = out + (size_t)blockIdx.x * C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;

  // pass 1: online max and rescaled sum over this thread's columns
  float m = -INFINITY, s = 0.f;
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const float v = load(row + j);
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else if (v != -INFINITY) {
      s += expf(v - m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  __shared__ float sm_m[kMaxWarps], sm_s[kMaxWarps];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < nwarps ? sm_m[lane] : -INFINITY;
    s = lane < nwarps ? sm_s[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      merge(m, s, m2, s2);
    }
    if (lane == 0) {
      sm_m[0] = m;
      sm_s[0] = s;
    }
  }
  __syncthreads();
  m = sm_m[0];
  s = sm_s[0];

  // pass 2: normalise
  for (int j = threadIdx.x; j < C; j += blockDim.x)
    store(orow + j, __fdiv_rn(expf(load(row + j) - m), s));
}

constexpr int kWarpMaxCols = 1024;
constexpr int kRowsPerBlock = 4;
constexpr int kPerLane = kWarpMaxCols / 32;

// 16 bytes of T: E values.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* o) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// One warp per row; kVec: 16-byte loads and stores (C * sizeof(T) and
// both bases 16-byte aligned).  Lane `lane` holds columns lane + 32 i
// (scalar) or the E columns of vectors lane + 32 i (kVec).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
softmax_rows_warp_kernel(const T* __restrict__ x, T* __restrict__ out,
                         int N, int C) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const T* xr = x + (size_t)row * C;
  T* orow = out + (size_t)row * C;
  constexpr int E = kVec ? Vec16<T>::E : 1;
  constexpr int kSlots = kPerLane / E;
  const int nslots = C / E;  // vectors (kVec) or columns of the row
  // every load of the row is in flight at once: a slot past the row
  // reads the row's last slot (never branched around) and is masked
  // to -inf
  float v[kPerLane];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = min(lane + 32 * i, nslots - 1);
    if constexpr (kVec)
      Vec16<T>::load(xr + j * E, v + i * E);
    else
      v[i] = load(xr + j);
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (lane + 32 * i >= nslots) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[i * E + e] = -INFINITY;
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) m = fmaxf(m, v[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool valid = lane + 32 * i < nslots;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float p = valid ? expf(v[i * E + e] - m) : 0.f;
      v[i * E + e] = p;
      s += p;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = lane + 32 * i;
    if (j < nslots) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[i * E + e] = __fdiv_rn(v[i * E + e], s);
      if constexpr (kVec)
        Vec16<T>::store(orow + j * E, v + i * E);
      else
        store(orow + j, v[i]);
    }
  }
}

template <typename T>
cudaError_t launch_warp(const void* x, void* out, int n, int c,
                        cudaStream_t st) {
  const bool vec = (c * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec)
    softmax_rows_warp_kernel<T, true><<<blocks, kRowsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, c);
  else
    softmax_rows_warp_kernel<T, false><<<blocks, kRowsPerBlock * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(const void* x, void* out, int n, int c,
                         cudaStream_t st) {
  int threads = ((c + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  softmax_rows_kernel<T><<<n, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: row-major [n, c], both of `dtype` (0 = float32, 1 = bfloat16).
// form: 0 = "block" (c <= 16384), 1 = "warp" (c <= 1024); a form that
// cannot take c returns cudaErrorInvalidValue.  Returns a cudaError_t
// (0 = launched).
int mxt_softmax_rows(const void* x, void* out, int dtype, int n, int c,
                     int form, void* stream) {
  if (n < 1 || c < 1 || c > kMaxCols || (form == 1 && c > kWarpMaxCols) ||
      (form != 0 && form != 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 1)
    return (int)(dtype == 0 ? launch_warp<float>(x, out, n, c, st)
                            : launch_warp<__nv_bfloat16>(x, out, n, c, st));
  return (int)(dtype == 0 ? launch_block<float>(x, out, n, c, st)
                          : launch_block<__nv_bfloat16>(x, out, n, c, st));
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
