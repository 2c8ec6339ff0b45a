// Flash-attention forward (K3) for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/parallel/flash_attention.py:_flash_fwd_pallas and its
// body _fwd_kernel: out = softmax(q k^T * scale [causal mask]) v and the
// row logsumexp lse = m + log(l), over q [B, Lq, H, D] / [B, H, Lq, D] and
// k, v with Lk rows, f32 or bf16, D <= 256; out in the input type, lse
// [B, H, Lq] f32.
//
// What bounds it: operations.  At the LM's training shape (B 8, H 8,
// L 2048, D 64, causal) the two products cost 4 * B * H * D * L^2 / 2 =
// 34.4 GFLOP against 67 MB of q, k, v and out in bf16: about 500
// operations per byte, above the card's balance, so the bound is the
// tensor-core rate (0.035 ms at 989 TFLOP/s bf16; 0.51 ms for f32 inputs
// at the 67 TFLOP/s of the f32 units).
//
// Design.  On the TPU the grid's last axis walks the K/V blocks in order
// and carries (m, l, acc) in VMEM scratch.  Here one thread block owns a
// tile of query rows of one (batch, head) and walks the K/V tiles itself,
// staging each in shared memory; the running max m, sum l and the f32
// accumulator of its rows live in registers.  Three forms; the caller
// names one (flash_attention.kernel_form picks it from the type, the head
// dim and the operands' alignment) and the C call refuses a form the
// operands do not allow:
//   * "hopper", flash_fwd_hopper_kernel: bf16 with D 64 or 128 and
//     16-byte-aligned operands (the LM's case).  Built for this card: TMA
//     loads into 128-byte-swizzled shared memory, one producer warp
//     keeping a 2-stage ring of K/V tiles in flight (full/empty
//     mbarriers), two consumer warpgroups of 64 query rows each issuing
//     wgmma (s = q k^T with both operands in shared memory; o += p v with
//     p from registers and v read MN-major through the transpose bit, so
//     no transposed copy), registers moved to the consumers by
//     setmaxnreg, the heaviest causal query tiles scheduled first;
//   * "mma", flash_fwd_mma_kernel: bf16 with D <= 128: the products on
//     the tensor cores (mma.sync m16n8k16, f32 accumulate);
//   * "fma", flash_fwd_kernel, f32 at any D and bf16 with D > 128: the
//     products on the f32 FMA units (f32 inputs must stay f32-exact), 16 R
//     rows a block, an R x R register tile a thread.
// Per K/V tile, all three:
//   * s = (q . k) * scale in f32 (scale after the dot, as the Pallas body
//     does), masked to NEG_INF = -1e30 for keys past Lk and, if causal,
//     above the diagonal;
//   * m_new = max(m, rowmax s), alpha = exp(m - m_new),
//     p = exp(s - m_new) zeroed where masked (after the exp, so a fully
//     masked tile adds nothing), l = l alpha + rowsum p;
//   * p is rounded to the input type (p.astype(v.dtype)), staged in
//     shared memory, and acc = acc alpha + p v.
// Tiles strictly above the diagonal are never loaded.  At the end
// l = max(l, 1e-30), out = acc / l, lse = m + log(l).  Layouts are read in
// place from the strides (no transpose).  Products of bf16 values are
// exact in f32, so the forms differ only in the order of the f32 sums,
// and the hopper form in its exponential: exp2 of the scores scaled by
// scale * log2(e) (one FMA and one MUFU op an element), a few f32 units in
// the last place from expf.  Its key tile is 64, as the others', so p is
// rounded against the same running maxima (flash_attention.kernel_tile).

#include "flash_attn_hopper.cuh"

namespace {

using namespace mxt_flash;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Layout lq, Layout lk, int causal,
                 float scale) {
  constexpr int R = Rows<DP>::value, BM = 16 * R, BN = 16 * R;
  constexpr int NJ = DP / 16, LD = DP + 1, LP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BM][LD]
  float* Ks = Qs + BM * LD;    // [BN][LD]
  float* Vs = Ks + BN * LD;    // [BN][LD]
  float* Ps = Vs + BN * LD;    // [BM][LP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / lq.H, h = bh % lq.H;
  const int q0 = blockIdx.x * BM;

  load_tile<T, BM, DP>(Qs, q, lq, b, h, q0);
  float m[R], l[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) acc[i][jd] = 0.f;
  }
  // causal: tiles starting past this tile's last row are all masked
  const int k_end = causal ? min(lk.L, q0 + BM) : lk.L;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's reads of Ks, Vs, Ps are done
    load_tile<T, BN, DP>(Ks, k, lk, b, h, k0);
    load_tile<T, BN, DP>(Vs, v, lk, b, h, k0);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DP; ++dd) {
      float a[R], c[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = Qs[(ty + 16 * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = Ks[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[R];
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < lk.L && (!causal || qi >= kj);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mb = fmaxf(mb, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mb));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pr[R], vv[NJ];
#pragma unroll
      for (int i = 0; i < R; ++i) pr[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) vv[jd] = Vs[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd)
          acc[i][jd] = fmaf(pr[i], vv[jd], acc[i][jd]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= lq.L) continue;
    const float li = fmaxf(l[i], 1e-30f);
    const size_t row = lq.row(b, h, qi);
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) {
      const int col = tx + 16 * jd;
      if (col < lq.D) out[row + col] = from_f<T>(acc[i][jd] / li);
    }
    if (tx == 0) lse[(size_t)bh * lq.L + qi] = m[i] + logf(li);
  }
}

// The bf16 forward on the tensor cores, head dim <= DP <= 128: four warps,
// each owning 16 of the tile's 64 query rows.  q's A operand stays in
// registers; per key tile of 64, s = q k^T (8 n-tiles of 8 keys) and the
// online softmax run on the accumulator registers (a row's 64 scores sit
// in the 4 lanes of a quad), p is rounded to bf16 straight into the A
// operand of p v, and v is staged transposed so its B operand is two
// 32-bit loads.  The arithmetic and its order of rounding are those of
// flash_fwd_kernel above.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     Layout lq, Layout lk, int causal, float scale) {
  constexpr int BM = 64, BN = 64, KS = DP / 16, NT = BN / 8, DN = DP / 8;
  constexpr int LDQ = DP + 8, LDV = BN + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LDQ]
  __nv_bfloat16* Ks = Qs + BM * LDQ;                                // [BN][LDQ]
  __nv_bfloat16* Vt = Ks + BN * LDQ;                                // [DP][LDV]
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first row
  const int bh = blockIdx.y, b = bh / lq.H, h = bh % lq.H;
  const int q0 = blockIdx.x * BM;

  load_tile_bf16<BM, DP, false>(Qs, q, lq, b, h, q0);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* p0 = Qs + (r0 + g) * LDQ + ks * 16 + 2 * t;
    qa[ks][0] = lds32(p0);
    qa[ks][1] = lds32(p0 + 8 * LDQ);
    qa[ks][2] = lds32(p0 + 8);
    qa[ks][3] = lds32(p0 + 8 * LDQ + 8);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  const int k_end = causal ? min(lk.L, q0 + BM) : lk.L;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // every warp is done with the previous Ks, Vt
    load_tile_bf16<BN, DP, false>(Ks, k, lk, b, h, k0);
    load_tile_bf16<BN, DP, true>(Vt, v, lk, b, h, k0);
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LDQ + ks * 16 + 2 * t;
        mma_bf16(s[nt], qa[ks], lds32(kp), lds32(kp + 8));
      }
    }
    // scale, mask, and the online softmax of rows g (e = 0, 1) and g + 8
    float mb[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + nt * 8 + 2 * t + (e & 1), r = e >> 1;
        const bool ok = kj < lk.L && (!causal || qi[r] >= kj);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
        mb[r] = fmaxf(mb[r], s[nt][e]);
      }
    float m_new[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 1));
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], 2));
      m_new[r] = fmaxf(m[r], mb[r]);
      alpha[r] = expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + nt * 8 + 2 * t + (e & 1), r = e >> 1;
        const bool ok = kj < lk.L && (!causal || qi[r] >= kj);
        s[nt][e] = ok ? expf(s[nt][e] - m_new[r]) : 0.f;  // p
        rs[r] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }
    // o += p v: p (rounded to bf16) as A, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const __nv_bfloat16* vp = Vt + (dn * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_bf16(o[dn], pa, lds32(vp), lds32(vp + 8));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= lq.L) continue;
    const float li = fmaxf(l[r], 1e-30f);
    const size_t row = lq.row(b, h, qi[r]);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + 2 * t + e;
        if (col < lq.D) out[row + col] = __float2bfloat16_rn(o[dn][2 * r + e] / li);
      }
    if (t == 0) lse[(size_t)bh * lq.L + qi[r]] = m[r] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// The "hopper" form: bf16, D = 64 or 128.  One block per (128-row query
// tile, batch * head), 384 threads: warpgroup 0 is the producer (one
// thread issues every TMA load), warpgroups 1 and 2 own query rows
// [q0, q0 + 64) and [q0 + 64, q0 + 128).  Shared memory: q [2][tile], then
// the rings of k [kStages][tile] and v [kStages][tile], then the
// mbarriers (q full; full and empty per stage of k and of v).  A tile is
// 64 rows x D.  k and v have barriers of their own, so a k slot is free
// again once s is computed while its v is still being read.
//
// Each consumer overlaps the softmax of key tile j with the product of
// tile j - 1 on the tensor cores: it issues s_j = q k_j^T and o += p_{j-1}
// v_{j-1}, waits for s_j only, runs the online softmax on it, and only
// then waits for o, rescales it and rounds p_j into registers.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
constexpr size_t hopper_fwd_smem() {
  return 1024 + (size_t)(2 + 2 * mxt_hopper::kStages) * 128 * D +
         8 * (1 + 4 * mxt_hopper::kStages);
}

// Scores of key tile k0 (in `sc`, scaled here) folded into the running
// max m and sum l of this thread's rows qi[0], qi[1]; sc becomes p and
// alpha the factor for the accumulator.  Element i of an m64n64
// accumulator is row qi[(i / 2) % 2], column k0 + 8 (i / 4) + 2 t + i % 2;
// masks only on the diagonal tile and past Lk.
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               const int (&qi)[2], int k0,
                                               int r_lo, int t, int Lk,
                                               int causal, float scale) {
  using mxt_hopper::ex2;
  using mxt_hopper::kLog2e;
  const bool edge = (causal && k0 + 63 > r_lo) || k0 + 64 > Lk;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] *= scale;
    if (edge) {
      const int kj = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (kj >= Lk || (causal && qi[r] < kj)) sc[i] = -INFINITY;
    }
    mx[r] = fmaxf(mx[r], sc[i]);
  }
  float rs[2] = {0.f, 0.f}, mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2((m[r] - m_new) * kLog2e);
    mb[r] = m_new * kLog2e;
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    // a masked score is -inf: exp2 gives 0, as the zeroed p
    sc[i] = ex2(fmaf(sc[i], kLog2e, -mb[r]));
    rs[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * alpha[r] + rs[r];
  }
}

// Issue s = q k^T for one key tile (both operands K-major in shared
// memory), as one committed group; the fence orders it after the
// registers' earlier writes.
template <int D>
__device__ __forceinline__ void fwd_issue_s(float (&sc)[32],
                                            const uint8_t* sQw,
                                            const uint8_t* sKs) {
  using namespace mxt_hopper;
  fence_acc(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(sc, desc_k(sQw, kk), desc_k(sKs, kk), kk > 0);
  wgmma_commit();
}

// Issue o += p v for one key tile (p from registers, v MN-major), as one
// committed group.
template <int D>
__device__ __forceinline__ void fwd_issue_pv(float (&o)[D / 2],
                                             const uint32_t (&pa)[4][4],
                                             const uint8_t* sVs) {
  using namespace mxt_hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, pa[kk], desc_mn(sVs, kk), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(mxt_hopper::kThreads, 1)
flash_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        Layout lq, int Lk, int causal, float scale) {
  using namespace mxt_hopper;
  constexpr int TILE = 128 * D;  // bytes of a 64-row tile
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + 2 * TILE;
  uint8_t* sV = sK + S * TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + S * TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + S;
  uint64_t* v_full = k_empty + S;
  uint64_t* v_empty = v_full + S;

  const int bh = blockIdx.x, b = bh / lq.H, h = bh % lq.H;
  // causal: the last query tiles see the most keys, so they start first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * 128;
  const int k_end = causal ? min(Lk, q0 + 128) : Lk;
  const int n_kt = (k_end + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: thread 0 keeps the rings full
    regs_dealloc();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(q_full, 2 * TILE);
      tma_tile<D>(sQ, &tq, q0, h, b, q_full);
      tma_tile<D>(sQ + TILE, &tq, q0 + 64, h, b, q_full);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S, parity = ((kt / S) & 1) ^ 1;
        mbar_wait(&k_empty[s], parity);
        mbar_arrive_tx(&k_full[s], TILE);
        tma_tile<D>(sK + s * TILE, &tk, kt * 64, h, b, &k_full[s]);
        mbar_wait(&v_empty[s], parity);
        mbar_arrive_tx(&v_full[s], TILE);
        tma_tile<D>(sV + s * TILE, &tv, kt * 64, h, b, &v_full[s]);
      }
    }
  } else {
    regs_alloc();
    const int w = threadIdx.x / 128 - 1;         // consumer warpgroup
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int r_lo = q0 + 64 * w;                // the warpgroup's rows
    const int qi[2] = {r_lo + 16 * warp + lane / 4,
                       r_lo + 16 * warp + lane / 4 + 8};
    // causal: tiles past the warpgroup's last row are all masked; it
    // only releases them
    const int n_w = causal ? min(n_kt, (r_lo + 64 + 63) / 64) : n_kt;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
    float o[D / 2], sc[32];
    uint32_t pa[4][4];
    const uint8_t* sQw = sQ + w * TILE;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    mbar_wait(q_full, 0);

    mbar_wait(&k_full[0], 0);
    fwd_issue_s<D>(sc, sQw, sK);
    wgmma_wait<0>();
    fence_acc(sc);
    mbar_arrive_warp(&k_empty[0]);
    online_softmax(sc, m, l, alpha, qi, 0, r_lo, t, Lk, causal, scale);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a(pa[kk], sc, kk);
    for (int kt = 1; kt < n_w; ++kt) {
      const int s = kt % S, sp = (kt - 1) % S;
      mbar_wait(&k_full[s], (kt / S) & 1);
      fence_acc(o);
      fence_acc(pa);
      fwd_issue_s<D>(sc, sQw, sK + s * TILE);
      mbar_wait(&v_full[sp], ((kt - 1) / S) & 1);
      fwd_issue_pv<D>(o, pa, sV + sp * TILE);
      wgmma_wait<1>();  // s of tile kt is in; p v of tile kt - 1 runs on
      fence_acc(sc);
      mbar_arrive_warp(&k_empty[s]);
      online_softmax(sc, m, l, alpha, qi, kt * 64, r_lo, t, Lk, causal,
                     scale);
      wgmma_wait<0>();
      fence_acc(o);
      mbar_arrive_warp(&v_empty[sp]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_a(pa[kk], sc, kk);
    }
    const int sl = (n_w - 1) % S;
    mbar_wait(&v_full[sl], ((n_w - 1) / S) & 1);
    fence_acc(o);
    fence_acc(pa);
    wgmma_fence();
    fwd_issue_pv<D>(o, pa, sV + sl * TILE);
    wgmma_wait<0>();
    fence_acc(o);
    mbar_arrive_warp(&v_empty[sl]);
    for (int kt = n_w; kt < n_kt; ++kt) {
      mbar_wait(&k_full[kt % S], (kt / S) & 1);
      mbar_arrive_warp(&k_empty[kt % S]);
      mbar_wait(&v_full[kt % S], (kt / S) & 1);
      mbar_arrive_warp(&v_empty[kt % S]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= lq.L) continue;
      const float li = fmaxf(l[r], 1e-30f);
      bf16* row = out + lq.row(b, h, qi[r]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / li,
                                  o[4 * j + 2 * r + 1] / li);
      if (t == 0) lse[(size_t)bh * lq.L + qi[r]] = m[r] + logf(li);
    }
  }
}

template <int D>
int launch_hopper(const void* q, const void* k, const void* v, void* out,
                  float* lse, int B, int H, int Lq, int Lk, int blhd,
                  int causal, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!mxt_hopper::make_map(&tq, q, B, H, Lq, D, blhd) ||
      !mxt_hopper::make_map(&tk, k, B, H, Lk, D, blhd) ||
      !mxt_hopper::make_map(&tv, v, B, H, Lk, D, blhd))
    return (int)cudaErrorInvalidValue;
  const size_t smem = hopper_fwd_smem<D>();
  auto kern = flash_fwd_hopper_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Lq + 127) / 128);
  kern<<<grid, mxt_hopper::kThreads, smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, Layout{H, Lq, D, blhd}, Lk,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int H, int Lq, int Lk, int D, int blhd,
               int causal, float scale, cudaStream_t st) {
  constexpr int BM = 64, BN = 64;
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(BM + BN) * (DP + 8) + (size_t)DP * (BN + 8));
  auto kern = flash_fwd_mma_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, Layout{H, Lq, D, blhd}, Layout{H, Lk, D, blhd}, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int Lq, int Lk, int D, int blhd,
           int causal, float scale, cudaStream_t st) {
  constexpr int R = Rows<DP>::value, BM = 16 * R, BN = 16 * R;
  constexpr int LD = DP + 1;
  const size_t smem = sizeof(float) * ((size_t)(BM + 2 * BN) * LD
                                       + (size_t)BM * (BN + 1));
  auto kern = flash_fwd_kernel<T, DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + BM - 1) / BM, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse,
      Layout{H, Lq, D, blhd}, Layout{H, Lk, D, blhd}, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int H, int Lq, int Lk, int D, int blhd,
             int causal, float scale, cudaStream_t st) {
#define MXT_FWD(DP)                                                    \
  if (D <= DP)                                                         \
    return launch<T, DP>(q, k, v, out, lse, B, H, Lq, Lk, D, blhd,     \
                         causal, scale, st);
  MXT_FWD(16) MXT_FWD(32) MXT_FWD(64) MXT_FWD(128) MXT_FWD(256)
#undef MXT_FWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, Lq, H, D] (blhd = 1) or [B, H, Lq, D] (blhd = 0), k and v with Lk
// rows, out like q, all contiguous of `dtype` (0 = float32, 1 = bfloat16);
// lse [B, H, Lq] float32.  causal needs Lq == Lk.  `form` names the kernel
// (0 = fma, 1 = mma, 2 = hopper); a form the operands do not allow is
// refused, never replaced.  Returns a cudaError_t (0 = launched).
int mxt_flash_attn_fwd(const void* q, const void* k, const void* v,
                       void* out, float* lse, int dtype, int B, int H,
                       int Lq, int Lk, int D, int blhd, int causal, int form,
                       float scale, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > 256 ||
      (causal && Lq != Lk) || B * H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == 2) {
    using mxt_hopper::aligned16;
    if (dtype != 1 || !(aligned16(q) && aligned16(k) && aligned16(v) &&
                        aligned16(out)))
      return (int)cudaErrorInvalidValue;
    if (D == 64)
      return launch_hopper<64>(q, k, v, out, lse, B, H, Lq, Lk, blhd, causal,
                               scale, st);
    if (D == 128)
      return launch_hopper<128>(q, k, v, out, lse, B, H, Lq, Lk, blhd,
                                causal, scale, st);
    return (int)cudaErrorInvalidValue;
  }
  if (form == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
#define MXT_FWD_MMA(DP)                                                  \
  if (D <= DP)                                                           \
    return launch_mma<DP>(q, k, v, out, lse, B, H, Lq, Lk, D, blhd, causal, \
                          scale, st);
    MXT_FWD_MMA(16) MXT_FWD_MMA(32) MXT_FWD_MMA(64) MXT_FWD_MMA(128)
#undef MXT_FWD_MMA
    return (int)cudaErrorInvalidValue;
  }
  if (form != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lse, B, H, Lq, Lk, D, blhd, causal,
                           scale, st);
  return dispatch<__nv_bfloat16>(q, k, v, out, lse, B, H, Lq, Lk, D, blhd,
                                 causal, scale, st);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
