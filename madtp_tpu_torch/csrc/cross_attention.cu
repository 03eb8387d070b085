// K4 on Hopper: masked-softmax cross-attention, no scores.
//
// Replaces the TPU kernel madtp_tpu/ops/pallas/cross_attention.py
// `fused_cross_attention` (kernel body `_kernel`).  For every (b, h):
//   out[b, :, h] = softmax(scale * q k^T + bias[b, :]) v,
// with dead keys (alive[b, j] == 0) at weight exactly 0, fp32 logits,
// softmax and accumulation, and the output stored in q's dtype.  A row of a
// batch with no alive key gets zeros, as the plain PyTorch version
// (madtp_tpu_torch/ops/attention.py `cross_attention_plain`) gives; the TPU
// kernel's finite -1e30 mask would give the mean of v there.
//
// Layout: q is a [B, Nq, H, Dh] view, k and v [B, S, H, Dh] views sharing
// their strides (Dh contiguous, heads next, any token and batch stride), the
// layouts the query, key and value linears write; out is [B, Nq, H, Dh]
// contiguous.  Any Nq >= 1 and S >= 1: the ragged query and key tiles are
// masked here, so the caller pads nothing.  bias may be null (no bias).
//
// Bound on the card.  At the ITM rerank's shape (B = 256 candidates, Nq = 35
// text queries, S = 592 image tokens, H = 12, Dh = 64, bf16) the function
// reads 465 MB of K and V, 0.14 ms at 3.35 TB/s, and needs 4 Nq S Dh flops
// per (b, h), 16 GFLOP, 0.017 ms of bf16 tensor cores: it is bound by the
// bytes.  So the design reads K and V once: one block per (b, h) holds all
// its (up to 64) queries and streams 64-key tiles of K and V through shared
// memory with an online softmax; only out goes back to device memory.  Nq >
// 64 loops over query tiles inside the block (K and V are read once per
// tile).  Warps whose query rows are all past Nq skip the arithmetic.  There
// are no float atomics, so two launches give the same bits.  This first
// version multiplies in fp32 on the CUDA cores (67 TFLOP/s peak, about 0.25
// ms of arithmetic at the shape above); tensor cores (mma / wgmma), TMA and
// a deeper pipeline are left to later work.
//
// Launch count: the Python wrapper madtp_tpu_torch/kernels/cross_attention.py
// (`cross_attention_cuda`) adds one to `cross_attention_cuda.launches` per
// successful call of `k4_cross_attention` below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;      // head dim (BERT-base)
constexpr int TQ = 64;      // query rows per tile
constexpr int TK = 64;      // key columns per tile
constexpr int NT = 256;     // threads: 16 row groups x 16 column groups
constexpr int LD = 68;      // padded leading dim of the transposed tiles
constexpr int ROWS_PER_WARP = 8;  // two row groups of 4 rows each
static_assert(TK == DH, "the K tile buffer is reused for P^T");
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
  for (int e = threadIdx.x; e < 64 * DH; e += NT) {
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

// Reductions over the 16 lanes of one row group (a half warp).  Every lane of
// the warp must take part: callers branch only on warp-uniform conditions.
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

// Grid (B, H).
template <typename T>
__global__ void __launch_bounds__(NT) k4_cross(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    int64_t qsb, int64_t qsn, int64_t ksb, int64_t ksn, const uint8_t* __restrict__ alive,
    const float* __restrict__ bias, T* __restrict__ out, int Nq, int S, int H,
    float scale) {
  extern __shared__ float smem[];
  float* Qt = smem;             // [DH][LD]
  float* Kt = Qt + DH * LD;     // [DH][LD]; after the scores, P^T as [TK][LD]
  float* Vs = Kt + DH * LD;     // [TK][DH]
  float* kb = Vs + TK * DH;     // [TK] key bias, -inf where dead or past S

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int64_t qhead = (int64_t)b * qsb + (int64_t)h * DH;
  const int64_t khead = (int64_t)b * ksb + (int64_t)h * DH;

  for (int q0 = 0; q0 < Nq; q0 += TQ) {
    // warp-uniform: this warp holds query rows q0 + 8 w .. q0 + 8 w + 7
    const bool active = (tid / 32) * ROWS_PER_WARP < Nq - q0;
    __syncthreads();  // the previous query tile's buffers are consumed
    load_transposed(Qt, q + qhead, qsn, q0, Nq);

    float m[4], l[4], o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int d = 0; d < 4; ++d) o[i][d] = 0.f;
    }

    for (int k0 = 0; k0 < S; k0 += TK) {
      __syncthreads();  // the previous key tile's P^T and V are consumed
      load_transposed(Kt, k + khead, ksn, k0, S);
      for (int e = tid; e < TK * DH; e += NT) {
        const int r = e / DH, d = e % DH;
        Vs[e] = (k0 + r < S) ? to_f(v[khead + (int64_t)(k0 + r) * ksn + d]) : 0.f;
      }
      if (tid < TK) {
        const int j = k0 + tid;
        const bool live = j < S && alive[(int64_t)b * S + j];
        kb[tid] = !live ? -INFINITY : (bias ? bias[(int64_t)b * S + j] : 0.f);
      }
      __syncthreads();

      float s[4][4];
      if (active) {
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
      }
      __syncthreads();  // every lane is done reading the K tile
      if (active) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(&Kt[(cg * 4 + j) * LD + rg * 4]) =
              make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      }
      __syncthreads();
      if (active) {
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
    }

    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rg * 4 + i;
        const float denom = fmaxf(group_sum(l[i]), 1e-30f);
        if (row < Nq) {
          T* dst = out + (((int64_t)b * Nq + row) * H + h) * DH + cg * 4;
#pragma unroll
          for (int d = 0; d < 4; ++d) dst[d] = from_f<T>(o[i][d] / denom);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, int64_t qsb, int64_t qsn,
                   int64_t ksb, int64_t ksn, const void* alive, const void* bias, void* out,
                   int B, int Nq, int S, int H, float scale, cudaStream_t stream) {
  const size_t smem = (2 * DH * LD + TK * DH + TK) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k4_cross<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  k4_cross<T><<<dim3(B, H), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qsb, qsn,
      ksb, ksn, static_cast<const uint8_t*>(alive), static_cast<const float*>(bias),
      static_cast<T*>(out), Nq, S, H, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: (qsb, qsn) of
// q, (ksb, ksn) shared by k and v.  bias may be null.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int k4_cross_attention(int dtype, const void* q, const void* k, const void* v,
                                  long long qsb, long long qsn, long long ksb, long long ksn,
                                  const void* alive, const void* bias, void* out, int B,
                                  int Nq, int S, int H, int Dh, float scale, void* stream) {
  if (Dh != DH || B < 1 || Nq < 1 || S < 1 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, qsb, qsn, ksb, ksn, alive, bias, out, B, Nq, S, H, scale, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, qsb, qsn, ksb, ksn, alive, bias, out, B, Nq, S, H,
                                scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
