// Single-pass fused optimizer update for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/ops/fused_update.py:_make_kernel/_pallas_apply (the
// Pallas TPU kernel behind the mxtpu_fused_update primitive): one pass that
// applies the combined multiplier (loss-scale unscale x global-norm clip),
// rescale_grad, clip_gradient and the whole optimizer step -- sgd, sgd with
// momentum, adam or adamw, with a scalar weight decay or a per-element wd
// vector -- and gates everything on the guard's `ok` flag.  w and the
// optimizer state are updated in place, as input_output_aliases does on the
// TPU.  Two forms share one element chain (step_one):
//
//   "bucket" (fused_update_kernel): one launch per flat float32 gradient
//   bucket, a grid-stride loop of one element per thread per iteration with
//   4-byte accesses.  The first port; kept for operands the caller forces.
//
//   "hopper" (fused_update_params_kernel): one launch per step over every
//   parameter's gradient where autograd left it.  A table of up to
//   kTableTensors gradient pointers, flat offsets and lengths rides in the
//   kernel's parameter space (6 KB; sm_90 takes up to 32,764 bytes), so no
//   gather into a flat gradient buffer is needed.  A chunk plan built once
//   per layout (int4 {tensor, start, length, flat offset on the 16-byte
//   grid}, a few thousand elements each, never crossing a tensor) is walked
//   by a persistent grid of SMs x resident blocks, so a whole step is one
//   wave with one ramp and one tail.  A chunk whose gradient pointer, flat
//   offset and flat buffers are all 16-byte aligned moves float4s, kUnroll
//   of each operand loaded before any arithmetic (a full chunk of 2048
//   elements is one such step of the block), stored with the streaming
//   hint (__stcs: every byte is touched once); other chunks and a ragged
//   tail take the scalar path.
//
// Bitwise contract: the per-element arithmetic repeats the unfused eager
// update (mxnet_tpu_torch/optimizer.py, itself the JAX package's
// _reference order) operation for operation, each with an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn).  The intrinsics are never contracted into FMAs, so both
// forms equal a chain of separate correctly rounded torch ops bit for
// bit, whatever nvcc's contraction setting.  Vectorising changes which
// thread does an element, never its arithmetic.  Built without fast math.
//
// Scalars that the trainer computes on the card (lr_eff or lr_t, adamw's
// second scalar, mult, ok) are read from device memory, so a step never
// synchronises with the host.  Hyperparameters (momentum, beta1, beta2,
// 1 - beta1, 1 - beta2, epsilon, wd, rescale_grad, clip) arrive as float
// arguments, rounded once from double on the host, as np.float32(...) does
// in the JAX kernel.  ok = false returns before any load.
//
// What bounds it: device-memory bytes.  Each element reads g, w, the state
// and the wd vector once and writes w and the state once, for about ten
// flops: sgd with momentum and a wd vector moves 24 B per element (ResNet-50's
// 25,557,032 parameters: 613 MB, 0.183 ms at 3.35 TB/s), adam with a scalar
// wd 28 B.  Each byte is used once, by one thread, so the hopper form uses
// no shared memory and no TMA: staging through shared memory would only add
// a copy.  What it does about the bound: 16-byte accesses with several in
// flight per thread, one launch per step, no gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { kSgd = 0, kSgdMomentum = 1, kAdam = 2, kAdamW = 3 };

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // bucket form's grid cap
constexpr int kTableTensors = 256;     // hopper form: tensors per launch
constexpr int kUnroll = 2;             // float4s of each operand in flight
constexpr int kMinBlocks = 2;          // hopper form: resident blocks an SM
constexpr int kMaxDevices = 64;

struct Hyper {
  float momentum, beta1, beta2, omb1, omb2, epsilon, wd, rescale, clip;
  int has_clip;
};

// the hopper form's per-launch pointer table, passed by value
struct Table {
  const float* g[kTableTensors];
  int64_t off[kTableTensors];   // flat offset of each tensor
  int64_t len[kTableTensors];   // elements of each tensor
};

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One element of the update, in _functional_step's order.  w, s0, s1 are
// read and written through the references; wdv is the element's wd (the
// vector's or the scalar); lr, lr_b, mv are the device scalars.
template <int KIND>
__device__ __forceinline__ void step_one(float gi, float& w, float& s0,
                                         float& s1, float wdv, bool has_wdvec,
                                         bool has_mult, float lr, float lr_b,
                                         float mv, const Hyper& h) {
  if (has_mult) gi = __fmul_rn(gi, mv);
  gi = __fmul_rn(gi, h.rescale);
  if (h.has_clip) gi = clampf(gi, -h.clip, h.clip);
  const float wi = w;
  if (KIND == kSgd) {
    // w - lr * (g + wd * w)
    w = __fsub_rn(wi, __fmul_rn(lr, __fadd_rn(gi, __fmul_rn(wdv, wi))));
  } else if (KIND == kSgdMomentum) {
    // mom = momentum * mom - lr * (g + wd * w); w + mom
    const float mom =
        __fsub_rn(__fmul_rn(h.momentum, s0),
                  __fmul_rn(lr, __fadd_rn(gi, __fmul_rn(wdv, wi))));
    w = __fadd_rn(wi, mom);
    s0 = mom;
  } else {
    if (KIND == kAdam) gi = __fadd_rn(gi, __fmul_rn(wdv, wi));
    // m = b1 * m + (1 - b1) * g; v = b2 * v + ((1 - b2) * g) * g
    const float m = __fadd_rn(__fmul_rn(h.beta1, s0), __fmul_rn(h.omb1, gi));
    const float v = __fadd_rn(__fmul_rn(h.beta2, s1),
                              __fmul_rn(__fmul_rn(h.omb2, gi), gi));
    // (lr_t * m) / (sqrt(v) + eps)
    const float upd = __fdiv_rn(__fmul_rn(lr, m),
                                __fadd_rn(__fsqrt_rn(v), h.epsilon));
    if (KIND == kAdam) {
      w = __fsub_rn(wi, upd);
    } else {
      // (w - update) - lrwd * w; lrwd = lr_eff * wd_vec or lr * wd
      const float lrwd = has_wdvec ? __fmul_rn(lr_b, wdv) : lr_b;
      w = __fsub_rn(__fsub_rn(wi, upd), __fmul_rn(lrwd, wi));
    }
    s0 = m;
    s1 = v;
  }
}

__host__ __device__ constexpr bool has_s0(int kind) { return kind != kSgd; }
__host__ __device__ constexpr bool has_s1(int kind) {
  return kind == kAdam || kind == kAdamW;
}

// ---------------------------------------------------------------------------
// "bucket" form: one flat bucket a launch
// ---------------------------------------------------------------------------

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
    float wi = w[i];
    float a = has_s0(KIND) ? s0[i] : 0.f;
    float b = has_s1(KIND) ? s1[i] : 0.f;
    step_one<KIND>(g[i], wi, a, b, wdvec != nullptr ? wdvec[i] : h.wd,
                   wdvec != nullptr, mult != nullptr, lr, lr_b, mv, h);
    w[i] = wi;
    if (has_s0(KIND)) s0[i] = a;
    if (has_s1(KIND)) s1[i] = b;
  }
}

// ---------------------------------------------------------------------------
// "hopper" form: one launch over a table of gradients
// ---------------------------------------------------------------------------

// plain loads: the evict-first hint (__ldcs, or L1::no_allocate) read
// slower over ResNet-50's update on an H100; stores stream (__stcs)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

template <int KIND>
__device__ __forceinline__ void step_vec(const float4& g, float4& w,
                                         float4& a, float4& b,
                                         const float4& d, bool has_wdvec,
                                         bool has_mult, float lr, float lr_b,
                                         float mv, const Hyper& h) {
  step_one<KIND>(g.x, w.x, a.x, b.x, d.x, has_wdvec, has_mult, lr, lr_b, mv,
                 h);
  step_one<KIND>(g.y, w.y, a.y, b.y, d.y, has_wdvec, has_mult, lr, lr_b, mv,
                 h);
  step_one<KIND>(g.z, w.z, a.z, b.z, d.z, has_wdvec, has_mult, lr, lr_b, mv,
                 h);
  step_one<KIND>(g.w, w.w, a.w, b.w, d.w, has_wdvec, has_mult, lr, lr_b, mv,
                 h);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_update_params_kernel(const __grid_constant__ Table tab,
                           const int4* __restrict__ chunks, int n_chunks,
                           float* __restrict__ w, float* __restrict__ s0,
                           float* __restrict__ s1,
                           const float* __restrict__ wdvec,
                           const float* __restrict__ sc0,
                           const float* __restrict__ sc1,
                           const float* __restrict__ mult,
                           const bool* __restrict__ ok, int flat_aligned,
                           Hyper h) {
  // the device scalars and the block's first chunk descriptor in one
  // round trip; each later descriptor is loaded one chunk ahead
  const bool go = ok == nullptr || *ok;
  const float lr = *sc0;
  const float lr_b = KIND == kAdamW ? *sc1 : 0.f;
  const float mv = mult != nullptr ? *mult : 1.f;
  int4 next = __ldg(chunks + blockIdx.x);
  if (!go) return;  // bad step: a bitwise no-op, no byte of g, w or state
  const bool has_wdvec = wdvec != nullptr, has_mult = mult != nullptr;
  const float4 wd4 = make_float4(h.wd, h.wd, h.wd, h.wd);
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int4 d = next;
    if (c + (int)gridDim.x < n_chunks) next = __ldg(chunks + c + gridDim.x);
    const int t = d.x;
    const int64_t start = d.y;
    // a chunk never reaches past its tensor, whatever the plan says
    int64_t n = d.z;
    if (start + n > tab.len[t])
      n = tab.len[t] > start ? tab.len[t] - start : 0;
    const float* g = tab.g[t] + start;
    const int64_t f = tab.off[t] + start;
    float* wc = w + f;
    float* ac = has_s0(KIND) ? s0 + f : nullptr;
    float* bc = has_s1(KIND) ? s1 + f : nullptr;
    const float* dc = has_wdvec ? wdvec + f : nullptr;
    int64_t done = 0;
    if (d.w && flat_aligned && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const int64_t nv = n >> 2;
      for (int64_t v0 = threadIdx.x; v0 < nv; v0 += kUnroll * kThreads) {
        float4 gv[kUnroll], wv[kUnroll], av[kUnroll], bv[kUnroll], dv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t e = 4 * (v0 + (int64_t)u * kThreads);
          if (e < 4 * nv) {
            gv[u] = ld4(g + e);
            wv[u] = ld4(wc + e);
            av[u] = has_s0(KIND) ? ld4(ac + e) : wd4;
            bv[u] = has_s1(KIND) ? ld4(bc + e) : wd4;
            dv[u] = has_wdvec ? ld4(dc + e) : wd4;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t e = 4 * (v0 + (int64_t)u * kThreads);
          if (e < 4 * nv) {
            step_vec<KIND>(gv[u], wv[u], av[u], bv[u], dv[u], has_wdvec,
                           has_mult, lr, lr_b, mv, h);
            st4(wc + e, wv[u]);
            if (has_s0(KIND)) st4(ac + e, av[u]);
            if (has_s1(KIND)) st4(bc + e, bv[u]);
          }
        }
      }
      done = nv << 2;
    }
    for (int64_t i = done + threadIdx.x; i < n; i += kThreads) {
      float wi = wc[i];
      float a = has_s0(KIND) ? ac[i] : 0.f;
      float b = has_s1(KIND) ? bc[i] : 0.f;
      step_one<KIND>(g[i], wi, a, b, has_wdvec ? dc[i] : h.wd, has_wdvec,
                     has_mult, lr, lr_b, mv, h);
      wc[i] = wi;
      if (has_s0(KIND)) ac[i] = a;
      if (has_s1(KIND)) bc[i] = b;
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

// SMs x resident blocks of the hopper form on the current device, queried
// once per kind and device
template <int KIND>
cudaError_t persistent_grid(int* grid) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *grid = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_update_params_kernel<KIND>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *grid;
  return cudaSuccess;
}

template <int KIND>
cudaError_t launch_params(const Table& tab, const int4* chunks, int n_chunks,
                          float* w, float* s0, float* s1, const float* wdvec,
                          const float* sc0, const float* sc1,
                          const float* mult, const bool* ok, Hyper h,
                          cudaStream_t st) {
  int grid = 0;
  cudaError_t err = persistent_grid<KIND>(&grid);
  if (err != cudaSuccess) return err;
  if (grid > n_chunks) grid = n_chunks;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(s0) |
                          reinterpret_cast<uintptr_t>(s1) |
                          reinterpret_cast<uintptr_t>(wdvec);
  fused_update_params_kernel<KIND><<<grid, kThreads, 0, st>>>(
      tab, chunks, n_chunks, w, s0, s1, wdvec, sc0, sc1, mult, ok,
      (bases & 15) == 0, h);
  return cudaGetLastError();
}

int check_operands(int kind, float* s0, float* s1, const float* sc0,
                   const float* sc1) {
  if (sc0 == nullptr) return (int)cudaErrorInvalidValue;
  if (has_s0(kind) && s0 == nullptr) return (int)cudaErrorInvalidValue;
  if (has_s1(kind) && s1 == nullptr) return (int)cudaErrorInvalidValue;
  if (kind == kAdamW && sc1 == nullptr) return (int)cudaErrorInvalidValue;
  return 0;
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
  if (n < 1 || g == nullptr || w == nullptr) return (int)cudaErrorInvalidValue;
  if (int err = check_operands(kind, s0, s1, sc0, sc1)) return err;
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

// The hopper form over one table: n_tensors (1..kTableTensors) gradients at
// the host arrays g_ptrs (device addresses), flat offsets offs and lengths
// lens; chunks: device int4 [n_chunks] {tensor index within the table,
// start within the tensor, length, flat offset on the 16-byte grid}.  w,
// s0, s1, wdvec: the flat buffers the offsets index.  The other arguments
// as mxt_fused_update's.
int mxt_fused_update_params(int kind, int n_tensors, const uint64_t* g_ptrs,
                            const int64_t* offs, const int64_t* lens,
                            const void* chunks, int n_chunks, float* w,
                            float* s0, float* s1, const float* wdvec,
                            const float* sc0, const float* sc1,
                            const float* mult, const bool* ok, float momentum,
                            float beta1, float beta2, float omb1, float omb2,
                            float epsilon, float wd, float rescale,
                            int has_clip, float clip, void* stream) {
  if (n_tensors < 1 || n_tensors > kTableTensors || n_chunks < 1 ||
      g_ptrs == nullptr || offs == nullptr || lens == nullptr ||
      chunks == nullptr || w == nullptr)
    return (int)cudaErrorInvalidValue;
  if (int err = check_operands(kind, s0, s1, sc0, sc1)) return err;
  Table tab;
  for (int i = 0; i < kTableTensors; ++i) {
    const bool used = i < n_tensors;
    if (used && (g_ptrs[i] == 0 || offs[i] < 0 || lens[i] < 1))
      return (int)cudaErrorInvalidValue;
    tab.g[i] = used ? reinterpret_cast<const float*>(g_ptrs[i]) : nullptr;
    tab.off[i] = used ? offs[i] : 0;
    tab.len[i] = used ? lens[i] : 0;
  }
  const Hyper h{momentum, beta1, beta2, omb1, omb2, epsilon,
                wd,       rescale, clip, has_clip};
  const int4* ch = static_cast<const int4*>(chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSgd:
      return (int)launch_params<kSgd>(tab, ch, n_chunks, w, s0, s1, wdvec,
                                      sc0, sc1, mult, ok, h, st);
    case kSgdMomentum:
      return (int)launch_params<kSgdMomentum>(tab, ch, n_chunks, w, s0, s1,
                                              wdvec, sc0, sc1, mult, ok, h,
                                              st);
    case kAdam:
      return (int)launch_params<kAdam>(tab, ch, n_chunks, w, s0, s1, wdvec,
                                       sc0, sc1, mult, ok, h, st);
    case kAdamW:
      return (int)launch_params<kAdamW>(tab, ch, n_chunks, w, s0, s1, wdvec,
                                        sc0, sc1, mult, ok, h, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// tensors one hopper launch takes (Python's TABLE_TENSORS must agree)
int mxt_fused_update_table_tensors() { return kTableTensors; }

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
