// Single-pass fused optimizer update for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/fused_update.py:_make_kernel/_pallas_apply (the
// Pallas TPU kernel behind the mxtpu_fused_update primitive): one pass over
// a flat float32 gradient bucket that applies the combined multiplier
// (loss-scale unscale x global-norm clip), rescale_grad, clip_gradient and
// the whole optimizer step -- sgd, sgd with momentum, adam or adamw, with a
// scalar weight decay or a per-element wd vector -- and gates everything on
// the guard's `ok` flag.  w and the optimizer state are updated in place,
// as input_output_aliases does on the TPU.
//
// Bitwise contract: the per-element arithmetic repeats the unfused eager
// update (mxnet_tpu_torch/optimizer.py, itself the JAX package's
// _reference order) operation for operation, each with an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn).  The intrinsics are never contracted into FMAs, so the
// kernel equals a chain of separate correctly rounded torch ops bit for
// bit, whatever nvcc's contraction setting.  Built without fast math.
//
// Scalars that the trainer computes on the card (lr_eff or lr_t, adamw's
// second scalar, mult, ok) are read from device memory, so a step never
// synchronises with the host.  Hyperparameters (momentum, beta1, beta2,
// 1 - beta1, 1 - beta2, epsilon, wd, rescale_grad, clip) arrive as float
// arguments, rounded once from double on the host, as np.float32(...) does
// in the JAX kernel.
//
// What bounds it: device-memory bytes.  Each element reads g, w, the state
// and the wd vector once and writes w and the state once, for about ten
// flops: sgd with momentum and a wd vector moves 24 B per element, 25.2 MB
// for a full 1,048,576-element bucket (7.5 us at 3.35 TB/s).  The design
// is the simplest that touches each byte once: a grid-stride loop, one
// element per thread per iteration, coalesced 4-byte accesses; ok = false
// returns before any load.  Not yet: 16-byte vector loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { kSgd = 0, kSgdMomentum = 1, kAdam = 2, kAdamW = 3 };

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Hyper {
  float momentum, beta1, beta2, omb1, omb2, epsilon, wd, rescale, clip;
  int has_clip;
};

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(int64_t n, const float* __restrict__ g,
                    float* __restrict__ w, float* __restrict__ s0,
                    float* __restrict__ s1, const float* __restrict__ wdvec,
                    const float* __restrict__ sc0,
                    const float* __restrict__ sc1,
                    const float* __restrict__ mult,
                    const bool* __restrict__ ok, Hyper h) {
  if (ok != nullptr && !*ok) return;  // bad step: a bitwise no-op
  const float lr = *sc0;              // lr_eff (sgd) or lr_t (adam/adamw)
  const float lr_b = KIND == kAdamW ? *sc1 : 0.f;
  const float mv = mult != nullptr ? *mult : 1.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float gi = g[i];
    if (mult != nullptr) gi = __fmul_rn(gi, mv);
    gi = __fmul_rn(gi, h.rescale);
    if (h.has_clip) gi = clampf(gi, -h.clip, h.clip);
    const float wi = w[i];
    const float wdv = wdvec != nullptr ? wdvec[i] : h.wd;
    if (KIND == kSgd) {
      // w - lr * (g + wd * w)
      w[i] = __fsub_rn(wi, __fmul_rn(lr, __fadd_rn(gi, __fmul_rn(wdv, wi))));
    } else if (KIND == kSgdMomentum) {
      // mom = momentum * mom - lr * (g + wd * w); w + mom
      const float mom =
          __fsub_rn(__fmul_rn(h.momentum, s0[i]),
                    __fmul_rn(lr, __fadd_rn(gi, __fmul_rn(wdv, wi))));
      w[i] = __fadd_rn(wi, mom);
      s0[i] = mom;
    } else {
      if (KIND == kAdam) gi = __fadd_rn(gi, __fmul_rn(wdv, wi));
      // m = b1 * m + (1 - b1) * g; v = b2 * v + ((1 - b2) * g) * g
      const float m = __fadd_rn(__fmul_rn(h.beta1, s0[i]),
                                __fmul_rn(h.omb1, gi));
      const float v = __fadd_rn(__fmul_rn(h.beta2, s1[i]),
                                __fmul_rn(__fmul_rn(h.omb2, gi), gi));
      // (lr_t * m) / (sqrt(v) + eps)
      const float upd = __fdiv_rn(__fmul_rn(lr, m),
                                  __fadd_rn(__fsqrt_rn(v), h.epsilon));
      if (KIND == kAdam) {
        w[i] = __fsub_rn(wi, upd);
      } else {
        // (w - update) - lrwd * w; lrwd = lr_eff * wd_vec or lr * wd
        const float lrwd = wdvec != nullptr ? __fmul_rn(lr_b, wdv) : lr_b;
        w[i] = __fsub_rn(__fsub_rn(wi, upd), __fmul_rn(lrwd, wi));
      }
      s0[i] = m;
      s1[i] = v;
    }
  }
}

template <int KIND>
cudaError_t launch(int64_t n, const float* g, float* w, float* s0, float* s1,
                   const float* wdvec, const float* sc0, const float* sc1,
                   const float* mult, const bool* ok, Hyper h,
                   cudaStream_t st) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_update_kernel<KIND><<<(int)blocks, kThreads, 0, st>>>(
      n, g, w, s0, s1, wdvec, sc0, sc1, mult, ok, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 sgd, 1 sgd_momentum, 2 adam, 3 adamw.  g, w, s0, s1, wdvec: flat
// float32 [n] (s0/s1 may be null where the kind has no such state; wdvec
// null for a scalar wd).  sc0: lr_eff (sgd kinds) or lr_t (adam kinds);
// sc1: adamw's lr * wd (scalar wd) or lr_eff (with wdvec); mult (float) and
// ok (bool) may be null.  All pointers are device memory.  Returns a
// cudaError_t (0 = launched).
int mxt_fused_update(int kind, int64_t n, const float* g, float* w, float* s0,
                     float* s1, const float* wdvec, const float* sc0,
                     const float* sc1, const float* mult, const bool* ok,
                     float momentum, float beta1, float beta2, float omb1,
                     float omb2, float epsilon, float wd, float rescale,
                     int has_clip, float clip, void* stream) {
  if (n < 1 || g == nullptr || w == nullptr || sc0 == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((kind == kSgdMomentum || kind == kAdam || kind == kAdamW) &&
      s0 == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((kind == kAdam || kind == kAdamW) && s1 == nullptr)
    return (int)cudaErrorInvalidValue;
  if (kind == kAdamW && sc1 == nullptr) return (int)cudaErrorInvalidValue;
  const Hyper h{momentum, beta1, beta2, omb1, omb2, epsilon,
                wd,       rescale, clip, has_clip};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSgd:
      return (int)launch<kSgd>(n, g, w, s0, s1, wdvec, sc0, sc1, mult, ok, h,
                               st);
    case kSgdMomentum:
      return (int)launch<kSgdMomentum>(n, g, w, s0, s1, wdvec, sc0, sc1, mult,
                                       ok, h, st);
    case kAdam:
      return (int)launch<kAdam>(n, g, w, s0, s1, wdvec, sc0, sc1, mult, ok, h,
                                st);
    case kAdamW:
      return (int)launch<kAdamW>(n, g, w, s0, s1, wdvec, sc0, sc1, mult, ok,
                                 h, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
