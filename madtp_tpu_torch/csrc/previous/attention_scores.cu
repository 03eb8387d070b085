// The design that madtp_tpu_torch/csrc/attention_scores.cu replaced: K1 (fp32 on the CUDA cores in both dtypes, two passes of 64 x 64 FFMA tiles).
// Kept unchanged as a yardstick: chip_smoke.py times it beside the current
// kernel on the same card and inputs (`previous_ms`).  The port never calls
// it, and its launches are not counted in the wrapper's `launches`.
//
// K1 on Hopper: multi-head attention with the DTP scoring side outputs.
//
// Replaces the TPU kernels madtp_tpu/ops/pallas/fused_attention.py
// `fused_attention_scores` (kernel body `_kernel`, padded N <= 1536) and
// `fused_attention_scores_tiled` (`:522`, kernel body `_kernel_tiled`, padded
// N in (1536, 4096], "K3").  The TPU split the two only because the full
// kernel's [N, N] head-max plane outgrows VMEM past 1536 slots; this kernel
// keeps no such plane (below), so it serves both ranges unchanged.  For
// every head h:
//   P_h      = softmax(scale * q_h k_h^T + key_bias), dead keys exactly 0,
//              a row with no alive key all 0;
//   out_h    = P_h v_h, accumulated in fp32, stored in the input dtype;
//   col_mass[n] = sum over alive queries i >= 1 of max_h P_h[i, n], 0 at dead n;
//   cls_attn[n] = sum_h P_h[0, n] r_h[n] / (sum_h r_h[n] + 1e-8),
//              r_h[n] = ||out_h[n]|| taken in fp32, before the store rounds.
//
// Layout: q, k, v are [B, N, H, Dh] views (Dh contiguous, heads next, any
// token and batch stride shared by the three), the layout the qkv linear
// writes; out is [B, N, H, Dh] contiguous.  Any N >= 2; the ragged last tile
// is masked here, so the caller pads nothing.
//
// Design.  The TPU kernel keeps an [N, N] fp32 head-max plane in VMEM; at
// N = 592 that is 1.4 MB, and a block here has 227 KB.  So two passes:
//   pass A, one block per (query tile, head, batch): an online-softmax pass
//     over key tiles writes out, the row max and sum-exp, and the fp32 row
//     norms r_h;
//   pass B, one block per (key tile, batch): over query tiles, then heads,
//     recompute P_h from the saved statistics, keep the max over heads in
//     registers and add the alive rows into col_mass; the query tile holding
//     row 0 also forms cls_attn.
// Sums run in a fixed order with no float atomics, so col_mass is the same
// bit for bit from run to run and the DTP decisions fed by it cannot flip.
//
// Bound on the card: the work sits at the H100's ridge.  At the NLVR gather
// path's first layer (B = 64 images, H = 12, N = 584, Dh = 64, bf16) it needs
// 4 N^2 Dh flops per (image, head), about 66 GFLOP or 0.067 ms of bf16 tensor
// cores at 989 TFLOP/s, and moves about 230 MB (q, k, v in, out back), 0.069
// ms at 3.35 TB/s.  This first version multiplies in fp32 on the CUDA cores
// (67 TFLOP/s peak) and recomputes q k^T in pass B, so it is bound by its own
// fp32 arithmetic, far above both; tensor cores (mma / wgmma), TMA and
// pipelining are left to later work.  In K3's range, at the VQA-640 gather
// path's first layer (ViT-B/16 at 640 px: B = 16 images, H = 12, N = 1608,
// bf16), the work is about 127 GFLOP, 0.128 ms of bf16 tensor cores, against
// about 158 MB moved, 0.047 ms: bound by operations.  Both passes grow as N^2
// (pass B walks every query tile and head for each key tile), so the fp32
// arithmetic binds there too.
//
// Launch count: the Python wrapper
// madtp_tpu_torch/kernels/attention_scores.py (`attention_scores_cuda`) adds
// one to `attention_scores_cuda.launches` per successful call of
// `k1_attention_scores` below, which launches both passes, and, when
// N > 1536, one to `attention_scores_cuda.large_n_launches` (K3's count).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;      // head dim (ViT-B and BERT-base)
constexpr int TQ = 64;      // query rows per tile
constexpr int TK = 64;      // key columns per tile
constexpr int NT = 256;     // threads: 16 row groups x 16 column groups
constexpr int LD = 68;      // padded leading dim of the transposed tiles
static_assert(TK == DH, "pass A reuses the K tile buffer for P^T");
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
__device__ void load_transposed(float* dst, const T* __restrict__ src,
                                int64_t row_stride, int r0, int n) {
  for (int e = threadIdx.x; e < TQ * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    dst[d * LD + r] = (r0 + r < n) ? to_f(src[(int64_t)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// s[i][j] = sum_d A[d][rg*4+i] * Bt[d][cg*4+j]
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

// Reductions over the 16 lanes of one row group (a half warp).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Pass A: grid (ceil(N/TQ), H, B).
template <typename T>
__global__ void __launch_bounds__(NT) k1_forward(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    int64_t sb, int64_t sn, const uint8_t* __restrict__ alive,
    const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ stat_m,
    float* __restrict__ stat_l, float* __restrict__ rnorm, int N, int H, float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;             // [DH][LD]
  float* Kt = Qt + DH * LD;     // [DH][LD]; after the scores, P^T as [TK][LD]
  float* Vs = Kt + DH * LD;     // [TK][DH]
  float* kb = Vs + TK * DH;     // [TK] key bias, -inf where dead or past N

  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int64_t head = (int64_t)b * sb + (int64_t)h * DH;

  load_transposed(Qt, q + head, sn, q0, N);

  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) o[i][d] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += TK) {
    __syncthreads();  // the previous tile's P^T and V are consumed
    load_transposed(Kt, k + head, sn, k0, N);
    for (int e = tid; e < TK * DH; e += NT) {
      const int r = e / DH, d = e % DH;
      Vs[e] = (k0 + r < N) ? to_f(v[head + (int64_t)(k0 + r) * sn + d]) : 0.f;
    }
    if (tid < TK) {
      const int j = k0 + tid;
      kb[tid] = (j < N && alive[(int64_t)b * N + j]) ? bias[(int64_t)b * N + j] : -INFINITY;
    }
    __syncthreads();

    float s[4][4];
    tile_dot(s, Qt, Kt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kbj = kb[cg * 4 + j];
        s[i][j] = (kbj == -INFINITY) ? -INFINITY : s[i][j] * scale + kbj;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float mn = fmaxf(m[i], group_max(tmax));
      const float alpha = (mn == -INFINITY) ? 1.f : expf(m[i] - mn);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - mn);
        psum += s[i][j];
      }
      l[i] = l[i] * alpha + psum;  // per-lane partial; summed over the group at the end
#pragma unroll
      for (int d = 0; d < 4; ++d) o[i][d] *= alpha;
      m[i] = mn;
    }
    __syncthreads();  // every lane is done reading the K tile
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Kt[(cg * 4 + j) * LD + rg * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < TK; ++jj) {
      const float4 p = *reinterpret_cast<const float4*>(&Kt[jj * LD + rg * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Vs[jj * DH + cg * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < 4; ++d) o[i][d] = fmaf(pv[i], wv[d], o[i][d]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    const float lsum = group_sum(l[i]);
    const float denom = fmaxf(lsum, 1e-30f);
    float sq = 0.f;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      o[i][d] = o[i][d] / denom;
      sq += o[i][d] * o[i][d];
    }
    const float rn = sqrtf(group_sum(sq));
    if (row < N) {
      T* dst = out + (((int64_t)b * N + row) * H + h) * DH + cg * 4;
#pragma unroll
      for (int d = 0; d < 4; ++d) dst[d] = from_f<T>(o[i][d]);
      if (cg == 0) {
        const int64_t s_idx = ((int64_t)b * H + h) * N + row;
        stat_m[s_idx] = (m[i] == -INFINITY) ? 0.f : m[i];
        stat_l[s_idx] = lsum;
        rnorm[s_idx] = rn;
      }
    }
  }
}

// Pass B: grid (ceil(N/TK), B).
template <typename T>
__global__ void __launch_bounds__(NT) k1_scores(
    const T* __restrict__ q, const T* __restrict__ k, int64_t sb, int64_t sn,
    const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    const float* __restrict__ rnorm, float* __restrict__ col, float* __restrict__ cls,
    int N, int H, float scale) {
  __shared__ __align__(16) float Qt[DH * LD];
  __shared__ __align__(16) float Kt[DH * LD];
  __shared__ float kb[TK], ms[TQ], ls[TQ], rn_s[TK];
  __shared__ float red[16][TK];

  const int k0 = blockIdx.x * TK, b = blockIdx.y;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;

  if (tid < TK) {
    const int j = k0 + tid;
    kb[tid] = (j < N && alive[(int64_t)b * N + j]) ? bias[(int64_t)b * N + j] : -INFINITY;
  }
  float colacc[4] = {0.f, 0.f, 0.f, 0.f}, num[4] = {0.f, 0.f, 0.f, 0.f},
        den[4] = {0.f, 0.f, 0.f, 0.f};

  for (int q0 = 0; q0 < N; q0 += TQ) {
    float mx[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[i][j] = 0.f;

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
          const float kbj = kb[cg * 4 + j];
          const float p = (kbj == -INFINITY)
                              ? 0.f
                              : expf(s[i][j] * scale + kbj - ms[r]) / fmaxf(ls[r], 1e-30f);
          s[i][j] = p;
          mx[i][j] = fmaxf(mx[i][j], p);
        }
      }
      if (q0 == 0 && rg == 0) {  // this lane holds query row 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float r = rn_s[cg * 4 + j];
          num[j] = fmaf(s[0][j], r, num[j]);
          den[j] += r;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      if (row >= 1 && row < N && alive[(int64_t)b * N + row]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) colacc[j] += mx[i][j];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) red[rg][cg * 4 + j] = colacc[j];
  __syncthreads();
  if (tid < TK) {
    const int j = k0 + tid;
    if (j < N) {
      float acc = 0.f;
      for (int g = 0; g < 16; ++g) acc += red[g][tid];
      col[(int64_t)b * N + j] = alive[(int64_t)b * N + j] ? acc : 0.f;
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = k0 + cg * 4 + j;
      if (jj < N) cls[(int64_t)b * N + jj] = num[j] / (den[j] + 1e-8f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, int64_t sb, int64_t sn,
                   const void* alive, const void* bias, void* out, void* col, void* cls,
                   void* stat_m, void* stat_l, void* rnorm, int B, int N, int H,
                   float scale, cudaStream_t stream) {
  const size_t smem = (2 * DH * LD + TK * DH + TK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k1_forward<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_a((N + TQ - 1) / TQ, H, B), grid_b((N + TK - 1) / TK, B);
  k1_forward<T><<<grid_a, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), sb, sn,
      static_cast<const uint8_t*>(alive), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(stat_m), static_cast<float*>(stat_l),
      static_cast<float*>(rnorm), N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1_scores<T><<<grid_b, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), sb, sn,
      static_cast<const uint8_t*>(alive), static_cast<const float*>(bias),
      static_cast<const float*>(stat_m), static_cast<const float*>(stat_l),
      static_cast<const float*>(rnorm), static_cast<float*>(col), static_cast<float*>(cls),
      N, H, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements and shared by
// q, k and v.  Scratch stat_m, stat_l, rnorm: [B, H, N] fp32.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int k1_attention_scores(int dtype, const void* q, const void* k, const void* v,
                                   long long sb, long long sn, const void* alive,
                                   const void* bias, void* out, void* col, void* cls,
                                   void* stat_m, void* stat_l, void* rnorm, int B, int N,
                                   int H, int Dh, float scale, void* stream) {
  if (Dh != DH || N < 2 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, sb, sn, alive, bias, out, col, cls, stat_m, stat_l, rnorm,
                        B, N, H, scale, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, sb, sn, alive, bias, out, col, cls, stat_m, stat_l,
                                rnorm, B, N, H, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
