// The designs that madtp_tpu_torch/csrc/ffn.cu replaced: K5 in bf16 (mma.sync
// from a cp.async ring; entry point `k5_ffn`) and in fp32 (the first FFMA
// SGEMM, `k5_sgemm`; entry point `k5_ffn_fp32`, at the end).
// Kept unchanged as yardsticks: chip_smoke.py times it beside the current
// kernel on the same card and inputs (`previous_ms`).  The port never calls
// it, and its launches are not counted in the wrapper's `launches`.
//
// K5 on Hopper: the transformer FFN on tensor cores.
//
// Replaces the TPU kernel madtp_tpu/ops/pallas/fused_ffn.py `fused_mlp_2d`
// (kernel body `_kernel`).  For x [M, D], W1 [F, D], b1 [F], W2 [D, F],
// b2 [D], all bfloat16 and row-major (PyTorch's [out, in] weight layout):
//   h = bf16(x W1^T + b1)        fp32 products and sums, rounded once
//   g = bf16(act(h))             act in fp32: exact-erf GELU or QuickGELU
//   y = bf16(g W2^T + b2)        fp32 products and sums, rounded once
// the roundings of the TPU kernel and of the plain PyTorch version
// (madtp_tpu_torch/ops/layers.py `mlp_plain`).  The TPU kernel evaluates
// erf by a polynomial only because Mosaic has no erf; here it is `erff`.
//
// Bound on the card.  At the CLIP ViT-L/14@336 vision tower's shape (M =
// 32 images x 584 slots = 18,688 rows, D = 1024, F = 4096) the function does
// 4 M D F = 313 GFLOP, 0.317 ms at the dense bf16 tensor-core peak (989
// TFLOP/s), and must move about 93 MB (0.028 ms at 3.35 TB/s): it is bound
// by the operations, so both products run on the tensor cores.
//
// Design (a first version, right and simple): one tiled GEMM with a fused
// epilogue, launched twice on the stream:
//   (a) hidden = act(bf16(x W1^T + b1)), written as bf16 [M, F] to scratch;
//   (b) y = hidden W2^T + b2.
// The TPU kernel keeps the hidden tile in VMEM; here a [128, D] fp32
// accumulator of fc2 at D = 1024 would need 512 KB, more than a block's
// registers, so the hidden goes through device memory for now: 2 M F 2
// bytes, 0.31 GB at the shape above, ~0.09 ms of HBM time beside the 0.32
// ms of tensor-core time.  Keeping it on chip (hidden chunks shared across a
// thread-block cluster over distributed shared memory), wgmma and TMA are
// later work.
//
// Each block computes a 128 x 128 tile of C = A B^T with 8 warps (2 x 4,
// 64 x 32 each) issuing mma.sync.m16n8k16 (bf16 in, fp32 accumulate),
// fragments read from shared memory by ldmatrix; A and B stream through a
// 4-stage ring of 128 x 32 tiles filled by cp.async (rows padded by 16 bytes,
// so ldmatrix reads are free of bank conflicts).  Rows of A past M are
// zero-filled by cp.async and their outputs not stored, so any M >= 1 is
// taken; D and F must be multiples of 128.  No atomics: two launches give the
// same bits.
//
// Launch count: the Python wrapper madtp_tpu_torch/kernels/ffn.py
// (`ffn_cuda`) adds one to `ffn_cuda.launches` per successful call of
// `k5_ffn` below (the two grid launches of one FFN).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // rows of a block tile
constexpr int BN = 128;          // columns of a block tile
constexpr int BK = 32;           // depth of one pipeline stage
constexpr int STAGES = 4;        // cp.async ring depth
constexpr int NT = 256;          // 8 warps
constexpr int WM = 64, WN = 32;  // a warp's tile: 2 x 4 warps cover 128 x 128
constexpr int MT = WM / 16;      // m16 fragments per warp
constexpr int NF = WN / 8;       // n8 fragments per warp
constexpr int LDS = BK + 8;      // padded shared-memory row, bf16 elements (80 bytes)
constexpr int CHUNKS = BM * BK / 8 / NT;  // 16-byte copies per thread per operand
static_assert(BM == BN, "A and B tiles share the copy loop");
static_assert(CHUNKS * NT * 8 == BM * BK, "the copy loop covers the tile");
static_assert((LDS * 2) % 16 == 0, "ldmatrix and cp.async need 16-byte aligned rows");

constexpr int ACT_NONE = 0, ACT_GELU = 1, ACT_QUICK_GELU = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a b, a: m16 x k16 (row), b: k16 x n8 (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int ACT>
__device__ __forceinline__ float epilogue(float v) {
  if (ACT == ACT_NONE) return v;
  const float h = __bfloat162float(__float2bfloat16(v));  // fc1 rounded to bf16 first
  if (ACT == ACT_GELU) return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  return h / (1.f + expf(-1.702f * h));  // QuickGELU: h sigmoid(1.702 h)
}

// C[M, N] = epilogue(A[M, K] B[N, K]^T + bias[N]), all bf16 and row-major.
// Grid (N / BN, ceil(M / BM)): the blocks of one row tile run side by side
// and share its A rows in L2; B (a weight matrix) stays in L2 throughout.
template <int ACT>
__global__ void __launch_bounds__(NT) k5_gemm(const __nv_bfloat16* __restrict__ A,
                                              const __nv_bfloat16* __restrict__ B,
                                              const __nv_bfloat16* __restrict__ bias,
                                              __nv_bfloat16* __restrict__ C, int M, int N,
                                              int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [STAGES][BM][LDS]
  __nv_bfloat16* Bs = As + STAGES * BM * LDS;                       // [STAGES][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = K / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * NT;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int gm = m0 + r;
      const bool in = gm < M;
      cp_async16(smem_addr(As + (stage * BM + r) * LDS + col),
                 A + (int64_t)(in ? gm : m0) * K + k0 + col, in ? 16 : 0);
      cp_async16(smem_addr(Bs + (stage * BN + r) * LDS + col),
                 B + (int64_t)(n0 + r) * K + k0 + col, 16);
    }
  };

  float acc[MT][NF][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();  // an empty group keeps the wait counts uniform
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (for this thread)
    __syncthreads();              // ... for every thread; stage kt-1 is consumed
    const int pf = kt + STAGES - 1;
    if (pf < KT) load_stage(pf % STAGES, pf);
    cp_async_commit();

    const __nv_bfloat16* as = As + (kt % STAGES) * BM * LDS;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NF][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // matrices: rows 0-7 / 8-15 at k 0, then at k 8 (a0..a3 of the fragment)
        const int row = wm * WM + mt * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3], smem_addr(as + row * LDS + col));
      }
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {
        // matrices: n 0-7 at k 0 and k 8 (b0, b1 of fragment 2np), then n 8-15
        const int row = wn * WN + np * 16 + (lane >> 4) * 8 + (lane & 7);
        const int col = kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(b[2 * np][0], b[2 * np][1], b[2 * np + 1][0], b[2 * np + 1][1],
                    smem_addr(bs + row * LDS + col));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) mma_bf16(acc[mt][nf], a[mt], b[nf][0], b[nf][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: (row g, cols 2t, 2t+1) in e0, e1 and row g + 8 in e2, e3
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
    const int col = n0 + wn * WN + nf * 8 + t * 2;
    const float bias0 = __bfloat162float(bias[col]), bias1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * WM + mt * 16 + g + half * 8;
        if (row < M) {
          const float v0 = epilogue<ACT>(acc[mt][nf][2 * half] + bias0);
          const float v1 = epilogue<ACT>(acc[mt][nf][2 * half + 1] + bias1);
          *reinterpret_cast<__nv_bfloat162*>(C + (int64_t)row * N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int ACT>
cudaError_t launch_gemm(const void* A, const void* B, const void* bias, void* C, int M, int N,
                        int K, cudaStream_t stream) {
  const int smem = STAGES * (BM + BN) * LDS * (int)sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(k5_gemm<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  k5_gemm<ACT><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(C), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// act: 1 = exact-erf GELU, 2 = QuickGELU.  x [M, D], w1 [F, D], b1 [F],
// w2 [D, F], b2 [D], hidden [M, F] scratch, y [M, D]: contiguous bf16 with
// 16-byte aligned bases.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int k5_ffn(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* hidden, void* y, int M, int D, int F, int act,
                      void* stream) {
  if (M < 1 || D < BN || F < BN || D % BN || F % BN || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act == ACT_GELU)
    err = launch_gemm<ACT_GELU>(x, w1, b1, hidden, M, F, D, st);
  else if (act == ACT_QUICK_GELU)
    err = launch_gemm<ACT_QUICK_GELU>(x, w1, b1, hidden, M, F, D, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm<ACT_NONE>(hidden, w2, b2, y, M, D, F, st);
}

// ---------------------------------------------------------------- fp32, FFMA
//
// A classic shared-memory SGEMM on the CUDA cores, FFMA and no TF32.  128 x
// 128 block tiles, 256 threads, 8 x 8 outputs a thread (two 4-wide row and
// column groups, so shared-memory reads are conflict-free float4s), 8-deep k
// steps, the next step's tiles read into registers while this one computes
// and stored transposed into the other of two shared buffers.  Rows past M
// are read as zeros and not stored.  No split-K: at small M fc2 at D = 768
// has six blocks for 132 SMs, each walking all of F.

namespace {

template <int ACT>
__device__ __forceinline__ float act_fp32(float h) {
  if (ACT == ACT_GELU) return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  if (ACT == ACT_QUICK_GELU) return h / (1.f + expf(-1.702f * h));  // h sigmoid(1.702 h)
  return h;
}

constexpr int SM = 128, SN = 128, SK = 8;  // block tile and k step
constexpr int NT_S = 256;                  // 16 x 16 threads, 8 x 8 outputs each
constexpr int SLD = SM + 4;                // padded row of the transposed tiles

// C[M, N] = act(A[M, K] B[N, K]^T + bias[N]), fp32 row-major; K % 8 == 0,
// N % 128 == 0.  Grid (N / 128, ceil(M / 128)).
template <int ACT>
__global__ void __launch_bounds__(NT_S) k5_sgemm(const float* __restrict__ A,
                                                 const float* __restrict__ B,
                                                 const float* __restrict__ bias,
                                                 float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[2][SK][SLD];  // As[k][m]
  __shared__ __align__(16) float Bs[2][SK][SLD];  // Bs[k][n]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * SM, n0 = blockIdx.x * SN;
  // each thread copies one float4 (4 consecutive k) of one row of A and of B
  const int lr = tid / 2, lk = (tid % 2) * 4;
  const bool a_in = m0 + lr < M;
  const float* a_src = A + (int64_t)(a_in ? m0 + lr : 0) * K + lk;
  const float* b_src = B + (int64_t)(n0 + lr) * K + lk;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra = a_in ? *reinterpret_cast<const float4*>(a_src) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 rb = *reinterpret_cast<const float4*>(b_src);
  auto store = [&](int buf) {
    As[buf][lk + 0][lr] = ra.x, As[buf][lk + 1][lr] = ra.y;
    As[buf][lk + 2][lr] = ra.z, As[buf][lk + 3][lr] = ra.w;
    Bs[buf][lk + 0][lr] = rb.x, Bs[buf][lk + 1][lr] = rb.y;
    Bs[buf][lk + 2][lr] = rb.z, Bs[buf][lk + 3][lr] = rb.w;
  };
  store(0);
  __syncthreads();

  const int KT = K / SK;
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) {  // the next step's tiles into registers while this one computes
      if (a_in) ra = *reinterpret_cast<const float4*>(a_src + (kt + 1) * SK);
      rb = *reinterpret_cast<const float4*>(b_src + (kt + 1) * SK);
    }
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(&a[0]) = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      *reinterpret_cast<float4*>(&a[4]) =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      *reinterpret_cast<float4*>(&b[0]) = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      *reinterpret_cast<float4*>(&b[4]) =
          *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < KT) {
      store(buf ^ 1);  // the other buffer: its last readers passed the previous sync
      __syncthreads();
    }
  }

  // thread rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise with tx
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      const float4 bv = *reinterpret_cast<const float4*>(bias + col);
      float4 o;
      o.x = act_fp32<ACT>(acc[i][4 * h + 0] + bv.x);
      o.y = act_fp32<ACT>(acc[i][4 * h + 1] + bv.y);
      o.z = act_fp32<ACT>(acc[i][4 * h + 2] + bv.z);
      o.w = act_fp32<ACT>(acc[i][4 * h + 3] + bv.w);
      *reinterpret_cast<float4*>(C + (int64_t)row * N + col) = o;
    }
  }
}

template <int ACT>
cudaError_t launch_sgemm(const void* A, const void* B, const void* bias, void* C, int M, int N,
                         int K, cudaStream_t stream) {
  const dim3 grid(N / SN, (M + SM - 1) / SM);
  k5_sgemm<ACT><<<grid, NT_S, 0, stream>>>(static_cast<const float*>(A),
                                           static_cast<const float*>(B),
                                           static_cast<const float*>(bias),
                                           static_cast<float*>(C), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// The fp32 FFN on `k5_sgemm`: arguments as `k5_ffn`, all float32.
extern "C" int k5_ffn_fp32(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* hidden, void* y, int M, int D, int F, int act,
                           void* stream) {
  if (M < 1 || D < SN || F < SN || D % SN || F % SN || (M + SM - 1) / SM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act == ACT_GELU)
    err = launch_sgemm<ACT_GELU>(x, w1, b1, hidden, M, F, D, st);
  else if (act == ACT_QUICK_GELU)
    err = launch_sgemm<ACT_QUICK_GELU>(x, w1, b1, hidden, M, F, D, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sgemm<ACT_NONE>(hidden, w2, b2, y, M, D, F, st);
}
