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
// a microsecond, so one launch costs more than the work.  The design only
// has to touch each byte once and keep the row statistics on chip:
//   * one block per row (the TPU kernel streamed row blocks through VMEM
//     in grid order; here rows are independent blocks in no order);
//   * pass 1: each thread walks its strided columns keeping an online
//     (max, sum of exp(x - max)) pair in f32 registers, rescaling its sum
//     when the max grows; a warp-shuffle merge and one shared-memory merge
//     across warps give the row's (m, s);
//   * pass 2: each thread writes exp(x - m) / s for its columns, a true
//     division as in the Pallas body (nn_ops.py:864), not a multiply by
//     the reciprocal.  The second read of the row hits L1/L2.
// bfloat16 input is widened to f32 on load and rounded to nearest even on
// store.  -inf inputs contribute exp(-inf) = 0; NaN propagates to the row.
// Simple and correct first: no vector loads, no multi-row blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

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

}  // namespace

extern "C" {

// x, out: row-major [n, c], both of `dtype` (0 = float32, 1 = bfloat16).
// Returns a cudaError_t (0 = launched).
int mxt_softmax_rows(const void* x, void* out, int dtype, int n, int c,
                     void* stream) {
  if (n < 1 || c < 1 || c > kMaxCols) return (int)cudaErrorInvalidValue;
  int threads = ((c + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    softmax_rows_kernel<float><<<n, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), c);
  else if (dtype == 1)
    softmax_rows_kernel<__nv_bfloat16><<<n, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), c);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
