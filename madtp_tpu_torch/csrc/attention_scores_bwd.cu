// K2 on Hopper: the backward of K1 (attention with the DTP scoring outputs).
//
// Replaces the TPU kernel madtp_tpu/ops/pallas/fused_attention.py
// `fused_attention_scores_bwd` (kernel body `_bwd_kernel`).  Given K1's inputs,
// its out and row statistics (max m_i and sum-exp l_i of the scaled, biased
// logits, fp32 row norms r_h[i] = ||out_h[i]||), and the cotangents dout
// [B, N, H, Dh], dcls and dcol [B, N-1] (slot 0 has none), it computes for
// every head h, with P = softmax(scale q k^T + bias) recomputed from m and l:
//   S[j] = sum_h r_h[j] + 1e-8,  C[j] = sum_h P_h[0, j] r_h[j]
//   do_eff_i = dout_i + out_i * drn_i / max(r_h[i], 1e-30),
//              drn_i = dcls_i (P_h[0, i] S_i - C_i) / S_i^2
//   dp_ij = do_eff_i . v_j
//         + qmask_i dcol_j [h is a head max at (i, j)] / (number of such heads)
//         + [i == 0] dcls_j r_h[j] / S_j
//   D_i = sum_j P_ij dp_ij,  G_ij = P_ij (dp_ij - D_i)
//   dq_i = scale sum_j G_ij k_j,  dk_j = scale sum_i G_ij q_i,
//   dv_j = sum_i P_ij do_eff_i,   dbias_j = sum_h sum_i G_ij
// where qmask_i is 1 for alive queries i >= 1.  Ties of the head max split
// evenly, as XLA's reduce_max VJP and torch's amax backward do.  Dead keys
// have P exactly 0 and get zero gradient; a row with no alive key has P all
// 0, every head tied, and yields no NaN.
//
// Layout: q, k, v are [B, N, H, Dh] views sharing their strides (Dh
// contiguous, heads next), as K1 takes them; out, dout, dq, dk, dv are
// contiguous [B, N, H, Dh].  Any N >= 2: the ragged tile is masked here.
//
// Design.  The TPU kernel keeps two [N, N] fp32 planes (head max and tie
// count) on chip, 1.4 MB each at N = 592; a block here has 227 KB.  Four
// launches on one stream, no float atomics, every sum in a fixed order (two
// runs give the same bits):
//   pass M, one block per (key tile, image): recompute P for every head,
//     keep the running head max in registers and write one 16-bit mask of
//     the heads that reach it per (query, key), 2 bytes instead of the
//     planes' 8; the query tile of row 0 also writes P_h[0, j], S and C;
//   pass Q, one block per (query tile, head, image): over key tiles,
//     accumulate D_i = sum_j P dp, A_i = sum_j P dp k_j and B_i = sum_j P k_j,
//     so that dq_i = scale (A_i - D_i B_i) needs no second sweep; writes dq
//     and D;
//   pass K, one block per (key tile, head, image): over query tiles, with
//     D from pass Q, accumulate dv, dk and the per-head dbias (the
//     FlashAttention-2 split: dq sums over keys, dk/dv/dbias over queries);
//   a last pass sums dbias over heads.
//
// Bound on the card: the function's own work is one q k^T recompute and the
// four gradient products, 10 Dh flops per (head, query, alive key): at the
// NLVR train step's ViT shape (B = 32 images, H = 12, N = 592) about 86
// GFLOP, 0.09 ms at the bf16 tensor-core rate and 1.3 ms at the 67 TFLOP/s
// fp32 CUDA-core rate; it moves q, k, v, dout in and dq, dk, dv out once,
// 0.06-0.09 ms at 3.35 TB/s.  This first version multiplies in fp32 on the
// CUDA cores and does 16 + 2 (pass M, for all heads) instead of 10 Dh flops
// per (head, query, key), so it is bound by its own fp32 arithmetic;
// tensor cores (mma / wgmma), TMA and pipelining are left to later work.
//
// Launch count: the Python wrapper
// madtp_tpu_torch/kernels/attention_scores_bwd.py (`attention_scores_bwd_cuda`)
// adds one to `attention_scores_bwd_cuda.launches` per successful call of
// `k2_attention_scores_bwd` below, which launches all four passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;   // head dim (ViT-B and BERT-base)
constexpr int TQ = 64;   // query rows per tile
constexpr int TK = 64;   // key columns per tile
constexpr int NT = 256;  // threads: 16 row groups x 16 column groups
constexpr int LD = 68;   // padded leading dim of the transposed tiles
constexpr int MAX_HEADS = 16;
static_assert(TQ == TK && TK == DH, "the tiles share one shape and reuse buffers");
static_assert(LD % 4 == 0, "float4 reads need 16-byte aligned rows");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// dst[d * LD + r] = src[(r0 + r) * row_stride + d] in fp32; rows >= n are 0.
template <typename T>
__device__ void load_transposed(float* dst, const T* __restrict__ src, int64_t row_stride,
                                int r0, int n) {
  for (int e = threadIdx.x; e < TQ * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    dst[d * LD + r] = (r0 + r < n) ? to_f(src[(int64_t)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// dst[r * DH + d] = src[(r0 + r) * row_stride + d] in fp32; rows >= n are 0.
template <typename T>
__device__ void load_rows(float* dst, const T* __restrict__ src, int64_t row_stride, int r0,
                          int n) {
  for (int e = threadIdx.x; e < TQ * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    dst[e] = (r0 + r < n) ? to_f(src[(int64_t)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// s[i][j] = sum_d At[d][rg*4+i] * Bt[d][cg*4+j]  (K1's tile product, same order)
__device__ __forceinline__ void tile_dot(float s[4][4], const float* At, const float* Bt,
                                         int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&At[d * LD + rg * 4]);
    const float4 c = *reinterpret_cast<const float4*>(&Bt[d * LD + cg * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
  }
}

// Sum over the 16 lanes of one row group (a half warp).
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// P from a raw q.k dot, as K1's pass B computes it; kb is -inf at dead keys.
__device__ __forceinline__ float prob(float s, float scale, float kb, float m, float l) {
  return (kb == -INFINITY) ? 0.f : expf(s * scale + kb - m) / fmaxf(l, 1e-30f);
}

// The column-mass and row-0 terms of dp at (row, col) for head h.
__device__ __forceinline__ float dp_extra(float qm, float dcol, float r0, int row,
                                          const uint16_t* __restrict__ ismax, int64_t idx,
                                          int h) {
  float x = (row == 0) ? r0 : 0.f;
  if (qm != 0.f && dcol != 0.f) {
    const unsigned bits = ismax[idx];
    if ((bits >> h) & 1u) x += dcol / (float)__popc(bits);
  }
  return x;
}

// Per-key-tile scalars shared by passes Q and K: key bias (-inf where dead or
// past N), the col_mass cotangent and the row-0 term dcls_j r_h[j] / S_j.
__device__ __forceinline__ void load_key_scalars(float* kb, float* dcol_s, float* r0_s, int k0,
                                                 int N, int64_t bN, int64_t bN1, int64_t srow,
                                                 const uint8_t* __restrict__ alive,
                                                 const float* __restrict__ bias,
                                                 const float* __restrict__ dcls,
                                                 const float* __restrict__ dcol,
                                                 const float* __restrict__ rnorm,
                                                 const float* __restrict__ ssum) {
  const int t = threadIdx.x;
  if (t < TK) {
    const int j = k0 + t;
    kb[t] = (j < N && alive[bN + j]) ? bias[bN + j] : -INFINITY;
    float dc = 0.f, r0 = 0.f;
    if (j >= 1 && j < N) {
      dc = dcol[bN1 + j - 1];
      r0 = dcls[bN1 + j - 1] * rnorm[srow + j] / ssum[bN + j];
    }
    dcol_s[t] = dc;
    r0_s[t] = r0;
  }
}

// Per-query-tile scalars: m, l, the query mask of col_mass, and the do_eff
// coefficient drn_i / max(r_h[i], 1e-30).
__device__ __forceinline__ void load_row_scalars(float* ms, float* ls, float* qm, float* coef,
                                                 int i0, int N, int64_t bN, int64_t bN1,
                                                 int64_t srow, const uint8_t* __restrict__ alive,
                                                 const float* __restrict__ stat_m,
                                                 const float* __restrict__ stat_l,
                                                 const float* __restrict__ rnorm,
                                                 const float* __restrict__ clsrow,
                                                 const float* __restrict__ ssum,
                                                 const float* __restrict__ csum,
                                                 const float* __restrict__ dcls) {
  const int t = threadIdx.x;
  if (t < TQ) {
    const int i = i0 + t;
    float m = 0.f, l = 1.f, a = 0.f, c = 0.f;
    if (i < N) {
      m = stat_m[srow + i];
      l = stat_l[srow + i];
      if (i >= 1) {
        a = alive[bN + i] ? 1.f : 0.f;
        const float S = ssum[bN + i], C = csum[bN + i];
        const float drn = dcls[bN1 + i - 1] * (clsrow[srow + i] * S - C) / (S * S);
        c = drn / fmaxf(rnorm[srow + i], 1e-30f);
      }
    }
    ms[t] = m;
    ls[t] = l;
    qm[t] = a;
    coef[t] = c;
  }
}

// Pass M: grid (ceil(N/TK), B).  K1's pass B with the head-max mask.
template <typename T>
__global__ void __launch_bounds__(NT) k2_heads(
    const T* __restrict__ q, const T* __restrict__ k, int64_t sb, int64_t sn,
    const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    const float* __restrict__ rnorm, uint16_t* __restrict__ ismax, float* __restrict__ clsrow,
    float* __restrict__ ssum, float* __restrict__ csum, int N, int H, float scale) {
  __shared__ __align__(16) float Qt[DH * LD];
  __shared__ __align__(16) float Kt[DH * LD];
  __shared__ float kb[TK], ms[TQ], ls[TQ], rn_s[TK];

  const int k0 = blockIdx.x * TK, b = blockIdx.y;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int64_t bN = (int64_t)b * N;

  if (tid < TK) {
    const int j = k0 + tid;
    kb[tid] = (j < N && alive[bN + j]) ? bias[bN + j] : -INFINITY;
  }
  float num[4] = {0.f, 0.f, 0.f, 0.f}, den[4] = {0.f, 0.f, 0.f, 0.f};

  for (int q0 = 0; q0 < N; q0 += TQ) {
    float mx[4][4];
    unsigned bits[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx[i][j] = 0.f;
        bits[i][j] = 0u;
      }

    for (int h = 0; h < H; ++h) {
      const int64_t head = (int64_t)b * sb + (int64_t)h * DH;
      const int64_t srow = ((int64_t)b * H + h) * N;
      __syncthreads();  // the previous head's tiles are consumed
      load_transposed(Qt, q + head, sn, q0, N);
      load_transposed(Kt, k + head, sn, k0, N);
      if (tid < TQ) {
        const int i = q0 + tid;
        ms[tid] = (i < N) ? stat_m[srow + i] : 0.f;
        ls[tid] = (i < N) ? stat_l[srow + i] : 1.f;
      } else if (tid < TQ + TK && q0 == 0) {
        const int j = k0 + tid - TQ;
        rn_s[tid - TQ] = (j < N) ? rnorm[srow + j] : 0.f;
      }
      __syncthreads();

      float s[4][4];
      tile_dot(s, Qt, Kt, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = prob(s[i][j], scale, kb[cg * 4 + j], ms[r], ls[r]);
          s[i][j] = p;
          // mx starts at 0 and p >= 0: the heads with p >= max(0, max_h p)
          if (p > mx[i][j]) {
            mx[i][j] = p;
            bits[i][j] = 1u << h;
          } else if (p == mx[i][j]) {
            bits[i][j] |= 1u << h;
          }
        }
      }
      if (q0 == 0 && rg == 0) {  // this lane holds query row 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = k0 + cg * 4 + j;
          const float r = rn_s[cg * 4 + j];
          num[j] = fmaf(s[0][j], r, num[j]);
          den[j] += r;
          if (c < N) clsrow[srow + c] = s[0][j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      if (row < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = k0 + cg * 4 + j;
          if (c < N) ismax[(bN + row) * N + c] = (uint16_t)bits[i][j];
        }
      }
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + cg * 4 + j;
      if (c < N) {
        ssum[bN + c] = den[j] + 1e-8f;
        csum[bN + c] = num[j];
      }
    }
  }
}

// Pass Q: grid (ceil(N/TQ), H, B).  dq and D.
template <typename T>
__global__ void __launch_bounds__(NT) k2_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int64_t sb,
    int64_t sn, const T* __restrict__ out, const T* __restrict__ dout,
    const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    const float* __restrict__ rnorm, const uint16_t* __restrict__ ismax,
    const float* __restrict__ clsrow, const float* __restrict__ ssum,
    const float* __restrict__ csum, const float* __restrict__ dcls,
    const float* __restrict__ dcol, T* __restrict__ dq, float* __restrict__ drow, int N, int H,
    float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // [DH][LD]
  float* Et = Qt + DH * LD;    // [DH][LD] do_eff^T
  float* Kt = Et + DH * LD;    // [DH][LD]; after the products, P^T as [TK][LD]
  float* Vt = Kt + DH * LD;    // [DH][LD]; after the products, (P dp)^T as [TK][LD]
  float* Ks = Vt + DH * LD;    // [TK][DH]
  float* kb = Ks + TK * DH;    // [TK]
  float* dcol_s = kb + TK;     // [TK]
  float* r0_s = dcol_s + TK;   // [TK]
  float* ms = r0_s + TK;       // [TQ]
  float* ls = ms + TQ;         // [TQ]
  float* qm = ls + TQ;         // [TQ]
  float* coef = qm + TQ;       // [TQ]

  const int i0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int64_t head = (int64_t)b * sb + (int64_t)h * DH;
  const int64_t rs = (int64_t)H * DH;                        // row stride of out/dout/dq
  const int64_t ohead = (int64_t)b * N * rs + (int64_t)h * DH;
  const int64_t srow = ((int64_t)b * H + h) * N;
  const int64_t bN = (int64_t)b * N, bN1 = (int64_t)b * (N - 1);

  load_row_scalars(ms, ls, qm, coef, i0, N, bN, bN1, srow, alive, stat_m, stat_l, rnorm, clsrow,
                   ssum, csum, dcls);
  load_transposed(Qt, q + head, sn, i0, N);
  __syncthreads();
  for (int e = tid; e < TQ * DH; e += NT) {
    const int r = e / DH, d = e % DH, i = i0 + r;
    float x = 0.f;
    if (i < N) {
      const int64_t o = ohead + (int64_t)i * rs + d;
      x = to_f(dout[o]) + to_f(out[o]) * coef[r];
    }
    Et[d * LD + r] = x;
  }

  float A[4][4], Bk[4][4], Dp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    Dp[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) A[i][d] = Bk[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += TK) {
    __syncthreads();  // the previous tile's P^T, (P dp)^T and K are consumed
    load_transposed(Kt, k + head, sn, k0, N);
    load_transposed(Vt, v + head, sn, k0, N);
    load_rows(Ks, k + head, sn, k0, N);
    load_key_scalars(kb, dcol_s, r0_s, k0, N, bN, bN1, srow, alive, bias, dcls, dcol, rnorm,
                     ssum);
    __syncthreads();

    float s[4][4], g[4][4];
    tile_dot(s, Qt, Kt, rg, cg);
    tile_dot(g, Et, Vt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, row = i0 + r;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg * 4 + j;
        float p = 0.f, w = 0.f;
        if (row < N) {
          p = prob(s[i][j], scale, kb[c], ms[r], ls[r]);
          const float dp = g[i][j] + dp_extra(qm[r], dcol_s[c], r0_s[c], row, ismax,
                                              (bN + row) * N + k0 + c, h);
          w = p * dp;
        }
        s[i][j] = p;
        g[i][j] = w;
        part += w;
      }
      Dp[i] += part;
    }
    __syncthreads();  // every lane is done reading the K and V tiles
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&Kt[(cg * 4 + j) * LD + rg * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(&Vt[(cg * 4 + j) * LD + rg * 4]) =
          make_float4(g[0][j], g[1][j], g[2][j], g[3][j]);
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < TK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Kt[c * LD + rg * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Vt[c * LD + rg * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&Ks[c * DH + cg * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          A[i][d] = fmaf(wv[i], kv[d], A[i][d]);
          Bk[i][d] = fmaf(pv[i], kv[d], Bk[i][d]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + rg * 4 + i;
    const float D = group_sum(Dp[i]);
    if (row < N) {
      T* dst = dq + ohead + (int64_t)row * rs + cg * 4;
#pragma unroll
      for (int d = 0; d < 4; ++d) dst[d] = from_f<T>(scale * (A[i][d] - D * Bk[i][d]));
      if (cg == 0) drow[srow + row] = D;
    }
  }
}

// Pass K: grid (ceil(N/TK), H, B).  dk, dv and the per-head dbias.
template <typename T>
__global__ void __launch_bounds__(NT) k2_dkv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int64_t sb,
    int64_t sn, const T* __restrict__ out, const T* __restrict__ dout,
    const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    const float* __restrict__ rnorm, const uint16_t* __restrict__ ismax,
    const float* __restrict__ clsrow, const float* __restrict__ ssum,
    const float* __restrict__ csum, const float* __restrict__ dcls,
    const float* __restrict__ dcol, const float* __restrict__ drow, T* __restrict__ dk,
    T* __restrict__ dv, float* __restrict__ dbias_h, int N, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;            // [DH][LD]
  float* Vt = Kt + DH * LD;    // [DH][LD]
  float* Qt = Vt + DH * LD;    // [DH][LD]; after the products, P as [TQ][LD]
  float* Et = Qt + DH * LD;    // [DH][LD] do_eff^T; after the products, G as [TQ][LD]
  float* Qs = Et + DH * LD;    // [TQ][DH]
  float* Es = Qs + TQ * DH;    // [TQ][DH] do_eff
  float* kb = Es + TQ * DH;    // [TK]
  float* dcol_s = kb + TK;     // [TK]
  float* r0_s = dcol_s + TK;   // [TK]
  float* ms = r0_s + TK;       // [TQ]
  float* ls = ms + TQ;         // [TQ]
  float* qm = ls + TQ;         // [TQ]
  float* coef = qm + TQ;       // [TQ]
  float* dr = coef + TQ;       // [TQ]
  float* red = dr + TQ;        // [16][TK]

  const int k0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int64_t head = (int64_t)b * sb + (int64_t)h * DH;
  const int64_t rs = (int64_t)H * DH;
  const int64_t ohead = (int64_t)b * N * rs + (int64_t)h * DH;
  const int64_t srow = ((int64_t)b * H + h) * N;
  const int64_t bN = (int64_t)b * N, bN1 = (int64_t)b * (N - 1);

  load_transposed(Kt, k + head, sn, k0, N);
  load_transposed(Vt, v + head, sn, k0, N);
  load_key_scalars(kb, dcol_s, r0_s, k0, N, bN, bN1, srow, alive, bias, dcls, dcol, rnorm, ssum);

  float dK[4][4], dV[4][4], dbp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dbp[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) dK[i][d] = dV[i][d] = 0.f;
  }

  for (int i0 = 0; i0 < N; i0 += TQ) {
    __syncthreads();  // the previous tile's P, G, Q and do_eff are consumed
    load_row_scalars(ms, ls, qm, coef, i0, N, bN, bN1, srow, alive, stat_m, stat_l, rnorm,
                     clsrow, ssum, csum, dcls);
    if (tid < TQ) dr[tid] = (i0 + tid < N) ? drow[srow + i0 + tid] : 0.f;
    load_transposed(Qt, q + head, sn, i0, N);
    load_rows(Qs, q + head, sn, i0, N);
    __syncthreads();  // coef is ready
    for (int e = tid; e < TQ * DH; e += NT) {
      const int r = e / DH, d = e % DH, i = i0 + r;
      float x = 0.f;
      if (i < N) {
        const int64_t o = ohead + (int64_t)i * rs + d;
        x = to_f(dout[o]) + to_f(out[o]) * coef[r];
      }
      Et[d * LD + r] = x;
      Es[e] = x;
    }
    __syncthreads();

    float s[4][4], g[4][4];
    tile_dot(s, Qt, Kt, rg, cg);
    tile_dot(g, Et, Vt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, row = i0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg * 4 + j;
        float p = 0.f, gr = 0.f;
        if (row < N) {
          p = prob(s[i][j], scale, kb[c], ms[r], ls[r]);
          const float dp = g[i][j] + dp_extra(qm[r], dcol_s[c], r0_s[c], row, ismax,
                                              (bN + row) * N + k0 + c, h);
          gr = p * (dp - dr[r]);
        }
        s[i][j] = p;
        g[i][j] = gr;
        dbp[j] += gr;
      }
    }
    __syncthreads();  // every lane is done reading the Q and do_eff tiles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(&Qt[(rg * 4 + i) * LD + cg * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(&Et[(rg * 4 + i) * LD + cg * 4]) =
          make_float4(g[i][0], g[i][1], g[i][2], g[i][3]);
    }
    __syncthreads();
    // now lane (rg, cg) owns keys rg*4.. and head dims cg*4..
#pragma unroll 8
    for (int r = 0; r < TQ; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(&Qt[r * LD + rg * 4]);
      const float4 gg = *reinterpret_cast<const float4*>(&Et[r * LD + rg * 4]);
      const float4 e = *reinterpret_cast<const float4*>(&Es[r * DH + cg * 4]);
      const float4 qq = *reinterpret_cast<const float4*>(&Qs[r * DH + cg * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float gv[4] = {gg.x, gg.y, gg.z, gg.w};
      const float ev[4] = {e.x, e.y, e.z, e.w};
      const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          dV[i][d] = fmaf(pv[i], ev[d], dV[i][d]);
          dK[i][d] = fmaf(gv[i], qv[d], dK[i][d]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + rg * 4 + i;
    if (col < N) {
      const int64_t o = ohead + (int64_t)col * rs + cg * 4;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        dk[o + d] = from_f<T>(scale * dK[i][d]);
        dv[o + d] = from_f<T>(dV[i][d]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[rg * TK + cg * 4 + j] = dbp[j];
  __syncthreads();
  if (tid < TK && k0 + tid < N) {
    float acc = 0.f;
    for (int g = 0; g < 16; ++g) acc += red[g * TK + tid];
    dbias_h[srow + k0 + tid] = acc;
  }
}

// dbias[b, j] = sum_h dbias_h[b, h, j], heads in order.
__global__ void k2_dbias(const float* __restrict__ dbias_h, float* __restrict__ dbias, int B,
                         int N, int H) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * N) return;
  const int64_t b = idx / N, j = idx % N;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += dbias_h[(b * H + h) * N + j];
  dbias[idx] = acc;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, int64_t sb, int64_t sn,
                   const void* alive, const void* bias, const void* stat_m,
                   const void* stat_l, const void* rnorm, const void* out, const void* dout,
                   const void* dcls, const void* dcol, void* ismax, void* clsrow, void* ssum,
                   void* csum, void* drow, void* dbias_h, void* dq, void* dk, void* dv,
                   void* dbias, int B, int N, int H, float scale, cudaStream_t stream) {
  const size_t smem_q = (4 * DH * LD + TK * DH + 3 * TK + 4 * TQ) * sizeof(float);
  const size_t smem_k = (4 * DH * LD + 2 * TQ * DH + 3 * TK + 5 * TQ + 16 * TK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(k2_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_q);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k2_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_k);
  if (err != cudaSuccess) return err;

  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  const float* bi = static_cast<const float*>(bias);
  const float* sm = static_cast<const float*>(stat_m);
  const float* sl = static_cast<const float*>(stat_l);
  const float* rn = static_cast<const float*>(rnorm);
  uint16_t* im = static_cast<uint16_t*>(ismax);
  float* cr = static_cast<float*>(clsrow);
  float* ss = static_cast<float*>(ssum);
  float* cs = static_cast<float*>(csum);
  const float* dc = static_cast<const float*>(dcls);
  const float* dl = static_cast<const float*>(dcol);
  float* dr = static_cast<float*>(drow);

  const int tiles = (N + TQ - 1) / TQ;
  k2_heads<T><<<dim3(tiles, B), NT, 0, stream>>>(qp, kp, sb, sn, al, bi, sm, sl, rn, im, cr, ss,
                                                 cs, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2_dq<T><<<dim3(tiles, H, B), NT, smem_q, stream>>>(
      qp, kp, vp, sb, sn, static_cast<const T*>(out), static_cast<const T*>(dout), al, bi, sm, sl,
      rn, im, cr, ss, cs, dc, dl, static_cast<T*>(dq), dr, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2_dkv<T><<<dim3(tiles, H, B), NT, smem_k, stream>>>(
      qp, kp, vp, sb, sn, static_cast<const T*>(out), static_cast<const T*>(dout), al, bi, sm, sl,
      rn, im, cr, ss, cs, dc, dl, dr, static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dbias_h), N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)B * N;
  k2_dbias<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dbias_h), static_cast<float*>(dbias), B, N, H);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/k/v strides are in elements and
// shared; stat_m, stat_l, rnorm: K1's [B, H, N] fp32 row statistics; dcls,
// dcol: [B, N-1] fp32.  Scratch: ismax [B, N, N] 16-bit; clsrow, drow,
// dbias_h [B, H, N] fp32; ssum, csum [B, N] fp32.  Outputs dq, dk, dv
// [B, N, H, Dh] in the input dtype, dbias [B, N] fp32.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int k2_attention_scores_bwd(
    int dtype, const void* q, const void* k, const void* v, long long sb, long long sn,
    const void* alive, const void* bias, const void* stat_m, const void* stat_l,
    const void* rnorm, const void* out, const void* dout, const void* dcls, const void* dcol,
    void* ismax, void* clsrow, void* ssum, void* csum, void* drow, void* dbias_h, void* dq,
    void* dk, void* dv, void* dbias, int B, int N, int H, int Dh, float scale, void* stream) {
  if (Dh != DH || N < 2 || B < 1 || H < 1 || H > MAX_HEADS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, sb, sn, alive, bias, stat_m, stat_l, rnorm, out, dout,
                              dcls, dcol, ismax, clsrow, ssum, csum, drow, dbias_h, dq, dk, dv,
                              dbias, B, N, H, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, sb, sn, alive, bias, stat_m, stat_l, rnorm, out,
                                      dout, dcls, dcol, ismax, clsrow, ssum, csum, drow, dbias_h,
                                      dq, dk, dv, dbias, B, N, H, scale, st);
  return (int)cudaErrorInvalidValue;
}
