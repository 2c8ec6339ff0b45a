// Flash-attention backward (K4) for Hopper (sm_90a), plain C interface.
//
// Replaces mxnet_tpu/parallel/flash_attention.py:_flash_bwd_pallas and its
// bodies _dq_kernel and _dkv_kernel: from q, k, v, the output gradient do,
// the forward's row logsumexp lse and delta = rowsum(do * out) (f32, or an
// external delta), with p = exp(s - lse) and ds = p * (do v^T - delta):
//   dq = ds k * scale,   dk = ds^T q * scale,   dv = p^T do,
// over the layouts and types of K3 (flash_attn_fwd.cu), D <= 256.
//
// What bounds it: operations.  The least work is five products of the
// forward's size (s, do v^T, ds k, ds^T q, p^T do); the two kernels do
// seven, since each recomputes s and do v^T.  At the LM's training shape
// that least work is 5 x 17.2 = 86 GFLOP (causal) against 135 MB of
// operands and results in bf16: 0.087 ms at the bf16 tensor-core rate.
//
// Design: the TPU's two kernels, kept as two, so neither needs atomics
// and the gradients are deterministic.  Like K3, each comes twice: on the
// tensor cores (mma.sync, bf16 with D <= 128, the LM's case) and on the
// f32 FMA units (f32 at any D, bf16 with D > 128), with the same
// arithmetic and rounding points.
//   * dq kernel: one block per (query tile, batch * head); q, do, lse and
//     delta stay in shared memory and registers while the block walks the
//     K/V tiles (causal: up to the diagonal), recomputes s and p, forms
//     ds, rounds it to the input type (ds.astype(k.dtype)) and
//     accumulates ds k in f32 registers.
//   * dk/dv kernel: one block per (key tile, batch * head); k and v stay
//     in shared memory while the block walks the query tiles (causal:
//     from the diagonal on), computes the transposed tiles p^T and ds^T,
//     rounds them (p.astype(do.dtype), ds.astype(q.dtype)), and
//     accumulates p^T do and ds^T q.
// Masked scores are NEG_INF, so p = exp(NEG_INF - lse) = 0 there, as in
// the Pallas bodies.  dq and dk are scaled once, after the last tile (the
// Pallas bodies scale each tile's product; the sum differs only in f32
// rounding).  Both kernels launch from one C call, on one stream.

#include "flash_attn_common.cuh"

namespace {

using namespace mxt_flash;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Layout lq, Layout lk, int causal, float scale) {
  constexpr int R = Rows<DP>::value, BM = 16 * R, BN = 16 * R;
  constexpr int NJ = DP / 16, LD = DP + 1, LP = BN + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BM][LD]
  float* Gs = Qs + BM * LD;    // do, [BM][LD]
  float* Ks = Gs + BM * LD;    // [BN][LD]
  float* Vs = Ks + BN * LD;    // [BN][LD]
  float* Ds = Vs + BN * LD;    // ds, [BM][LP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / lq.H, h = bh % lq.H;
  const int q0 = blockIdx.x * BM;

  load_tile<T, BM, DP>(Qs, q, lq, b, h, q0);
  load_tile<T, BM, DP>(Gs, dout, lq, b, h, q0);
  float lse_r[R], delta_r[R], acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse_r[i] = qi < lq.L ? lse[(size_t)bh * lq.L + qi] : 0.f;
    delta_r[i] = qi < lq.L ? delta[(size_t)bh * lq.L + qi] : 0.f;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) acc[i][jd] = 0.f;
  }
  const int k_end = causal ? min(lk.L, q0 + BM) : lk.L;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();
    load_tile<T, BN, DP>(Ks, k, lk, b, h, k0);
    load_tile<T, BN, DP>(Vs, v, lk, b, h, k0);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float a[R], g[R], kc[R], vc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + dd];
        g[i] = Gs[(ty + 16 * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kc[j] = Ks[(tx + 16 * j) * LD + dd];
        vc[j] = Vs[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = qi < lq.L && kj < lk.L && (!causal || qi >= kj);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        Ds[(ty + 16 * i) * LP + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float dr[R], kk[NJ];
#pragma unroll
      for (int i = 0; i < R; ++i) dr[i] = Ds[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) kk[jd] = Ks[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd)
          acc[i][jd] = fmaf(dr[i], kk[jd], acc[i][jd]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= lq.L) continue;
    const size_t row = lq.row(b, h, qi);
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) {
      const int col = tx + 16 * jd;
      if (col < lq.D) dq[row + col] = from_f<T>(acc[i][jd] * scale);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Layout lq, Layout lk, int causal,
                     float scale) {
  constexpr int R = Rows<DP>::value, BM = 16 * R, BN = 16 * R;
  constexpr int NJ = DP / 16, LD = DP + 1, LP = BM + 1;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BN][LD]
  float* Vs = Ks + BN * LD;    // [BN][LD]
  float* Qs = Vs + BN * LD;    // [BM][LD]
  float* Gs = Qs + BM * LD;    // do, [BM][LD]
  float* Pt = Gs + BM * LD;    // p^T, [BN][LP]
  float* Dt = Pt + BN * LP;    // ds^T, [BN][LP]
  float* Ls = Dt + BN * LP;    // lse of the query tile, [BM]
  float* Es = Ls + BM;         // delta of the query tile, [BM]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / lk.H, h = bh % lk.H;
  const int k0 = blockIdx.x * BN;

  load_tile<T, BN, DP>(Ks, k, lk, b, h, k0);
  load_tile<T, BN, DP>(Vs, v, lk, b, h, k0);
  float dk_acc[R][NJ], dv_acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) dk_acc[i][jd] = dv_acc[i][jd] = 0.f;
  // causal: query tiles ending before this key tile are all masked
  const int q_begin = causal ? (k0 / BM) * BM : 0;
  for (int q0 = q_begin; q0 < lq.L; q0 += BM) {
    __syncthreads();
    load_tile<T, BM, DP>(Qs, q, lq, b, h, q0);
    load_tile<T, BM, DP>(Gs, dout, lq, b, h, q0);
    for (int r = threadIdx.x; r < BM; r += kThreads) {
      const bool in = q0 + r < lq.L;
      Ls[r] = in ? lse[(size_t)bh * lq.L + q0 + r] : 0.f;
      Es[r] = in ? delta[(size_t)bh * lq.L + q0 + r] : 0.f;
    }
    __syncthreads();
    // rows: keys ty + 16 i; columns: queries tx + 16 j
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float kr[R], vr[R], qc[R], gc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kr[i] = Ks[(ty + 16 * i) * LD + dd];
        vr[i] = Vs[(ty + 16 * i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        qc[j] = Qs[(tx + 16 * j) * LD + dd];
        gc[j] = Gs[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qc[j], kr[i], s[i][j]);
          dp[i][j] = fmaf(gc[j], vr[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int ql = tx + 16 * j, qi = q0 + ql;
        const bool ok = qi < lq.L && kj < lk.L && (!causal || qi >= kj);
        const float p = ok ? expf(s[i][j] * scale - Ls[ql]) : 0.f;
        Pt[(ty + 16 * i) * LP + ql] = round_to<T>(p);
        Dt[(ty + 16 * i) * LP + ql] = round_to<T>(p * (dp[i][j] - Es[ql]));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BM; ++c) {
      float pr[R], dr[R], gg[NJ], qq[NJ];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pr[i] = Pt[(ty + 16 * i) * LP + c];
        dr[i] = Dt[(ty + 16 * i) * LP + c];
      }
#pragma unroll
      for (int jd = 0; jd < NJ; ++jd) {
        gg[jd] = Gs[c * LD + tx + 16 * jd];
        qq[jd] = Qs[c * LD + tx + 16 * jd];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd) {
          dv_acc[i][jd] = fmaf(pr[i], gg[jd], dv_acc[i][jd]);
          dk_acc[i][jd] = fmaf(dr[i], qq[jd], dk_acc[i][jd]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= lk.L) continue;
    const size_t row = lk.row(b, h, kj);
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd) {
      const int col = tx + 16 * jd;
      if (col < lk.D) {
        dk[row + col] = from_f<T>(dk_acc[i][jd] * scale);
        dv[row + col] = from_f<T>(dv_acc[i][jd]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores, head dim <= DP <= 128 (the two kernels above,
// with the products as mma.sync m16n8k16 and the elementwise work on the
// accumulator registers; see flash_attn_common.cuh for the operand
// layouts).  Four warps a block, 16 rows each.  A operands come from
// row-major tiles, B operands of products over the tile's rows from tiles
// staged transposed.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// A operand (16 x 16) of rows r0.. and columns c0.. of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int c0, int g, int t) {
  const bf16* p = tile + (r0 + g) * ld + c0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// B operand (16 x 8) whose column n is row n0 + n of a row-major tile
// and whose k runs over that row's columns c0..
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[4],
                                         const bf16* tile, int ld, int n0,
                                         int c0, int g, int t) {
  const bf16* p = tile + (n0 + g) * ld + c0 + 2 * t;
  mma_bf16(c, a, lds32(p), lds32(p + 8));
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, Layout lq, Layout lk,
                        int causal, float scale) {
  constexpr int BM = 64, BN = 64, KS = DP / 16, NT = BN / 8, DN = DP / 8;
  constexpr int LD = DP + 8, LT = BN + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* Gs = Qs + BM * LD;                       // do, [BM][LD]
  bf16* Ks = Gs + BM * LD;                       // [BN][LD]
  bf16* Vs = Ks + BN * LD;                       // [BN][LD]
  bf16* Kt = Vs + BN * LD;                       // k transposed, [DP][LT]
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const int bh = blockIdx.y, b = bh / lq.H, h = bh % lq.H;
  const int q0 = blockIdx.x * BM;

  load_tile_bf16<BM, DP, false>(Qs, q, lq, b, h, q0);
  load_tile_bf16<BM, DP, false>(Gs, dout, lq, b, h, q0);
  const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float lse_r[2], delta_r[2], acc[DN][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = qi[r] < lq.L ? lse[(size_t)bh * lq.L + qi[r]] : 0.f;
    delta_r[r] = qi[r] < lq.L ? delta[(size_t)bh * lq.L + qi[r]] : 0.f;
  }
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int k_end = causal ? min(lk.L, q0 + BM) : lk.L;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();
    load_tile_bf16<BN, DP, false>(Ks, k, lk, b, h, k0);
    load_tile_bf16<BN, DP, false>(Vs, v, lk, b, h, k0);
    load_tile_bf16<BN, DP, true>(Kt, k, lk, b, h, k0);
    __syncthreads();
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], ga[4];
      load_a(qa, Qs, LD, r0, ks * 16, g, t);
      load_a(ga, Gs, LD, r0, ks * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_rows(s[nt], qa, Ks, LD, nt * 8, ks * 16, g, t);
        mma_rows(dp[nt], ga, Vs, LD, nt * 8, ks * 16, g, t);
      }
    }
    // ds = p (dp - delta), p = exp(s scale - lse), in place of s
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + nt * 8 + 2 * t + (e & 1), r = e >> 1;
        const bool ok = qi[r] < lq.L && kj < lk.L && (!causal || qi[r] >= kj);
        const float p = ok ? expf(s[nt][e] * scale - lse_r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[r]);
      }
    // acc += ds k, ds rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        mma_rows(acc[dn], da, Kt, LT, dn * 8, kk * 16, g, t);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= lq.L) continue;
    const size_t row = lq.row(b, h, qi[r]);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + 2 * t + e;
        if (col < lq.D)
          dq[row + col] = __float2bfloat16_rn(acc[dn][2 * r + e] * scale);
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         Layout lq, Layout lk, int causal, float scale) {
  constexpr int BM = 64, BN = 64, KS = DP / 16, NT = BM / 8, DN = DP / 8;
  constexpr int LD = DP + 8, LT = BM + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BN][LD]
  bf16* Vs = Ks + BN * LD;                       // [BN][LD]
  bf16* Qs = Vs + BN * LD;                       // [BM][LD]
  bf16* Gs = Qs + BM * LD;                       // do, [BM][LD]
  bf16* Qt = Gs + BM * LD;                       // q transposed, [DP][LT]
  bf16* Gt = Qt + DP * LT;                       // do transposed, [DP][LT]
  float* Ls = reinterpret_cast<float*>(Gt + DP * LT);  // lse, [BM]
  float* Es = Ls + BM;                                 // delta, [BM]
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first key
  const int bh = blockIdx.y, b = bh / lk.H, h = bh % lk.H;
  const int k0 = blockIdx.x * BN;

  load_tile_bf16<BN, DP, false>(Ks, k, lk, b, h, k0);
  load_tile_bf16<BN, DP, false>(Vs, v, lk, b, h, k0);
  const int kj[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  const int q_begin = causal ? (k0 / BM) * BM : 0;
  for (int q0 = q_begin; q0 < lq.L; q0 += BM) {
    __syncthreads();
    load_tile_bf16<BM, DP, false>(Qs, q, lq, b, h, q0);
    load_tile_bf16<BM, DP, false>(Gs, dout, lq, b, h, q0);
    load_tile_bf16<BM, DP, true>(Qt, q, lq, b, h, q0);
    load_tile_bf16<BM, DP, true>(Gt, dout, lq, b, h, q0);
    for (int r = threadIdx.x; r < BM; r += kMmaThreads) {
      const bool in = q0 + r < lq.L;
      Ls[r] = in ? lse[(size_t)bh * lq.L + q0 + r] : 0.f;
      Es[r] = in ? delta[(size_t)bh * lq.L + q0 + r] : 0.f;
    }
    __syncthreads();
    // rows: the warp's 16 keys; columns: the tile's 64 queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, LD, r0, ks * 16, g, t);
      load_a(va, Vs, LD, r0, ks * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_rows(s[nt], ka, Qs, LD, nt * 8, ks * 16, g, t);
        mma_rows(dp[nt], va, Gs, LD, nt * 8, ks * 16, g, t);
      }
    }
    // p^T in place of s, ds^T in place of dp
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1), qi = q0 + ql, r = e >> 1;
        const bool ok = qi < lq.L && kj[r] < lk.L && (!causal || qi >= kj[r]);
        const float p = ok ? expf(s[nt][e] * scale - Ls[ql]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - Es[ql]);
      }
    // dv += p^T do and dk += ds^T q, both rounded to bf16, 16 queries a step
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        mma_rows(dv_acc[dn], pa, Gt, LT, dn * 8, kk * 16, g, t);
        mma_rows(dk_acc[dn], da, Qt, LT, dn * 8, kk * 16, g, t);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= lk.L) continue;
    const size_t row = lk.row(b, h, kj[r]);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + 2 * t + e;
        if (col < lk.D) {
          dk[row + col] = __float2bfloat16_rn(dk_acc[dn][2 * r + e] * scale);
          dv[row + col] = __float2bfloat16_rn(dv_acc[dn][2 * r + e]);
        }
      }
  }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int H, int Lq, int Lk, int D, int blhd,
               int causal, float scale, cudaStream_t st) {
  constexpr int BM = 64, BN = 64, LD = DP + 8;
  const Layout lq{H, Lq, D, blhd}, lk{H, Lk, D, blhd};
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);

  const size_t smem_dq = sizeof(bf16) * ((size_t)(2 * BM + 2 * BN) * LD
                                         + (size_t)DP * (BN + 8));
  auto kdq = flash_bwd_dq_mma_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return (int)e;
  kdq<<<dim3((Lq + BM - 1) / BM, B * H), kMmaThreads, smem_dq, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dq), lq, lk, causal,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv = sizeof(bf16) * ((size_t)(2 * BN + 2 * BM) * LD
                                         + 2 * (size_t)DP * (BM + 8))
                         + 2 * sizeof(float) * BM;
  auto kkv = flash_bwd_dkv_mma_kernel<DP>;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  kkv<<<dim3((Lk + BN - 1) / BN, B * H), kMmaThreads, smem_kv, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), lq, lk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int B, int H, int Lq, int Lk, int D, int blhd,
           int causal, float scale, cudaStream_t st) {
  constexpr int R = Rows<DP>::value, BM = 16 * R, BN = 16 * R;
  constexpr int LD = DP + 1;
  const Layout lq{H, Lq, D, blhd}, lk{H, Lk, D, blhd};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);

  const size_t smem_dq = sizeof(float) * ((size_t)(2 * BM + 2 * BN) * LD
                                          + (size_t)BM * (BN + 1));
  auto kdq = flash_bwd_dq_kernel<T, DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return (int)e;
  kdq<<<dim3((Lq + BM - 1) / BM, B * H), kThreads, smem_dq, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), lq, lk, causal,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv = sizeof(float) * ((size_t)(2 * BN + 2 * BM) * LD
                                          + 2 * (size_t)BN * (BM + 1)
                                          + 2 * (size_t)BM);
  auto kkv = flash_bwd_dkv_kernel<T, DP>;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  kkv<<<dim3((Lk + BN - 1) / BN, B * H), kThreads, smem_kv, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      lq, lk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq, void* dk,
             void* dv, int B, int H, int Lq, int Lk, int D, int blhd,
             int causal, float scale, cudaStream_t st) {
#define MXT_BWD(DP)                                                      \
  if (D <= DP)                                                           \
    return launch<T, DP>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Lq, \
                         Lk, D, blhd, causal, scale, st);
  MXT_BWD(16) MXT_BWD(32) MXT_BWD(64) MXT_BWD(128) MXT_BWD(256)
#undef MXT_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, do, dq [B, Lq, H, D] (blhd = 1) or [B, H, Lq, D] (blhd = 0); k, v, dk,
// dv with Lk rows; all contiguous of `dtype` (0 = float32, 1 = bfloat16);
// lse and delta [B, H, Lq] float32.  Launches the dq kernel, then the
// dk/dv kernel, on `stream`.  Returns a cudaError_t (0 = launched).
int mxt_flash_attn_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, void* dk, void* dv,
                       int dtype, int B, int H, int Lq, int Lk, int D,
                       int blhd, int causal, float scale, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > 256 ||
      (causal && Lq != Lk) || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Lq,
                           Lk, D, blhd, causal, scale, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define MXT_BWD_MMA(DP)                                                   \
  if (D <= DP)                                                            \
    return launch_mma<DP>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Lq, \
                          Lk, D, blhd, causal, scale, st);
  MXT_BWD_MMA(16) MXT_BWD_MMA(32) MXT_BWD_MMA(64) MXT_BWD_MMA(128)
#undef MXT_BWD_MMA
  return dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                                 Lq, Lk, D, blhd, causal, scale, st);
}

const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
