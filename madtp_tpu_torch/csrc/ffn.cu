// K5 on Hopper: the transformer FFN, bf16 on the tensor cores by wgmma fed
// by TMA, fp32 on the CUDA cores.
//
// Replaces the TPU kernel madtp_tpu/ops/pallas/fused_ffn.py `fused_mlp_2d`
// (kernel body `_kernel`), which takes any dtype that the weights share.  For
// x [M, D], W1 [F, D], b1 [F], W2 [D, F], b2 [D], row-major in PyTorch's
// [out, in] weight layout, all bfloat16 or all float32:
//   h = x W1^T + b1              fp32 products and sums (bf16: rounded once)
//   g = act(h)                   in fp32: exact-erf GELU or QuickGELU
//                                (bf16: rounded once)
//   y = g W2^T + b2              fp32 products and sums, stored in x's dtype
// the roundings of the TPU kernel and of the plain PyTorch version
// (madtp_tpu_torch/ops/layers.py `mlp_plain`).  The TPU kernel evaluates
// erf by a polynomial because Mosaic has no erf; the bf16 path here takes
// the same polynomial (see `act_bf16`), the fp32 path `erff`.
//
// Bound on the card.  At the CLIP ViT-L/14@336 vision tower's shape (M =
// 32 images x 584 slots = 18,688 rows, D = 1024, F = 4096) the function does
// 4 M D F = 313 GFLOP, 0.317 ms at the dense bf16 tensor-core peak (989
// TFLOP/s), and must move about 93 MB (0.028 ms at 3.35 TB/s): it is bound
// by the operations.  In fp32 (the mask-mode train step: M = 32 x 592, D =
// 768, F = 3072, 179 GFLOP) it is bound by the CUDA cores' 67 TFLOP/s, 2.67
// ms.
//
// Both dtypes run one GEMM with a fused epilogue twice on the stream:
//   (a) hidden = act(x W1^T + b1), written in x's dtype to a scratch [M, F];
//   (b) y = hidden W2^T + b2.
// The TPU kernel keeps the hidden tile in VMEM; here a [128, D] fp32
// accumulator of fc2 at D = 1024 would need 512 KB, more than a block's
// registers, so the hidden goes through device memory: 2 M F 2 bytes in
// bf16, ~0.09 ms of HBM time beside the 0.32 ms of tensor-core time at the
// CLIP shape.  Keeping it on chip is later work.
//
// bf16 (`k5_wgmma`): a persistent grid of one block per SM walks the 128 x
// 128 output tiles in row-major tile order (n fastest: the weight matrix,
// 8 MB at most, stays in the 50 MB L2, and the row tiles in flight share
// their rows of the activations).  A block is three warpgroups: one
// producer thread issues TMA loads of 128 x 64 tiles of A and B, 128-byte
// swizzled, into a 5-stage shared-memory ring guarded by full and empty
// mbarriers, in the block's tile order; the two consumer warpgroups take
// the block's tiles in turns (ping-pong), each issuing two
// wgmma.m64n128k16 per 16-deep step (bf16 in, fp32 accumulate in 128
// registers a thread), keeping one wgmma group in flight and releasing a
// stage as soon as the group that read it has retired.  The epilogue
// (bias, roundings, activation) runs on the accumulator registers, writes
// the bf16 tile into the warpgroup's own staging buffer in shared memory
// (in the output tensor map's swizzle, free of bank conflicts) and one
// thread stores it by TMA, which clips the rows past M.  The epilogue is
// the cost to watch: at D = 768, fc1's main loop is 12 steps, and an
// exact-division QuickGELU and erff GELU with 4-byte stores straight to
// device memory left fc1 well below fc2's rate on the same FLOPs; so the
// activation takes the fast intrinsics and the TPU kernel's erf polynomial
// (`act_bf16`).  `setmaxnreg` moves registers from the producer
// (40) to the consumers (232).  The tensor maps are encoded on the host and
// the last 64 kept (a map depends only on the base, the shape and the box).
// What still holds it back: the GELU epilogue (fc1 still runs slower than
// fc2 at D = 768), each B tile crossing from L2 once per row tile
// (clusters with TMA multicast would share it; a first try with 2-block
// clusters ran slower and was not kept), and fc2's wave tail.
//
// fp32 (`k5_ffma`): FFMA on the CUDA cores, no TF32 (TF32 keeps ~3 decimal
// digits, and the fp32 parity checks hold features to 1e-5: 3xTF32 failed
// them in K1).  Each block computes a 16 TM x 128 tile (TM = 8, 4, 2 or 1)
// with 256 threads of TM x 8 outputs, in 16-deep steps: each step comes
// from device memory into registers while the one before it computes, and
// is stored transposed into the other of two shared buffers, one barrier a
// step.  For TM < 8 a thread keeps to 128 registers, so that two blocks (16
// warps) share an SM; the 128-row tile runs faster with one block and 161
// registers.  (A cp.async ring of 3-4 steps, in the tiles' own layout or
// transposed by 4-byte copies, and 32-deep steps all ran slower on the
// H100: PERF.md.)  The design it replaced (csrc/previous/ffn.cu
// `k5_sgemm`) had one 128 x 128 tile shape, 8-deep steps and no split: at
// small M fc2 at D = 768 had six blocks for 132 SMs, each walking all of F,
// a floor of ~0.48 ms a call.  Here a plan of each GEMM, a function of (M,
// N, K) chosen by the wrapper (madtp_tpu_torch/kernels/ffn.py
// `fp32_plan`), takes a row tile by M and, where the blocks fall short of
// the SMs, splits K into 2, 4 or 8 slices.  The slices of one tile are one
// thread-block cluster: each writes its partial tile into its own shared
// memory, and after a cluster barrier block z adds rows [z BM / s, (z + 1)
// BM / s) of the partials of blocks 0, 1, ..., s - 1 in that order over
// distributed shared memory, then the bias and activation.  Rows past M are
// read as zeros and not stored.  What still holds it back: at M <= 16 every
// block reads its 128 weight rows into shared memory for one useful row
// (~0.038 ms against the library's 0.013-0.020 at M = 1-2).
//
// No atomics: every sum runs in a fixed order, so two launches give the same
// bits.  Any M >= 1; D and F multiples of 128.  Each kernel's shared-memory
// attribute is set once per process.
//
// Launch count: the Python wrapper madtp_tpu_torch/kernels/ffn.py
// (`ffn_cuda`) adds one to `ffn_cuda.launches` per successful call of
// `k5_ffn` below (the two grid launches of one FFN).

#ifndef CUDA_EMULATOR
#include <cuda.h>
#endif
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ACT_NONE = 0, ACT_GELU = 1, ACT_QUICK_GELU = 2;

template <int ACT>
__device__ __forceinline__ float act_fp32(float h) {
  if (ACT == ACT_GELU) return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
  if (ACT == ACT_QUICK_GELU) return h / (1.f + expf(-1.702f * h));  // h sigmoid(1.702 h)
  return h;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The bf16 half (wgmma, TMA, mbarriers).  CUDA_EMULATOR builds the fp32 half
// alone: the CPU emulator of tests/cuda_emu.h models the CUDA cores, cp.async
// and clusters, not these.
#ifndef CUDA_EMULATOR

// bf16 epilogue: fc1's sum rounded to bf16 before the activation, which is
// rounded to bf16 again.  Its cost is the epilogue's, and the epilogue is
// on the critical path, so it takes the fast intrinsics (exponential,
// division: a few fp32 ulps) and, for GELU, the TPU kernel's own erf
// (Abramowitz & Stegun 7.1.26, |err| <= 1.5e-7, `_erf_poly`): errors four
// decimal orders below the bf16 rounding that follows.
template <int ACT>
__device__ __forceinline__ float act_bf16(float v) {
  if (ACT == ACT_NONE) return v;
  const float h = __bfloat162float(__float2bfloat16(v));
  if (ACT == ACT_QUICK_GELU) return __fdividef(h, 1.f + __expf(-1.702f * h));
  const float x = h * 0.70710678118654752f, ax = fabsf(x);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  const float erf_x = copysignf(1.f - poly * __expf(-ax * ax), x);
  return 0.5f * h * (1.f + erf_x);
}

// ---------------------------------------------------------------- bf16, wgmma

constexpr int BM = 128;        // rows of a tile (two wgmma of 64 rows)
constexpr int BN = 128;        // columns of a tile (the wgmma's N)
constexpr int BK = 64;         // depth of a stage: 64 bf16 = one 128-byte swizzle row
constexpr int STAGES = 5;      // TMA ring depth
constexpr int NT_WG = 384;     // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int C_BYTES = BM * BN * 2;  // a consumer's output tile, staged for the TMA store
constexpr int WG_SMEM =
    STAGES * (A_BYTES + B_BYTES) + 2 * C_BYTES + (2 * STAGES + 2) * 8 + 1024;  // + align

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Returns once the phase of parity `parity` of the barrier has completed.  A
// wait past 2^34 cycles (seconds) traps, so a fault shows as a failed launch
// and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// A box of the tensor map at (inner coordinate c0, row c1) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}


// A box of shared memory (128-byte swizzled) to the tensor map at (c0, c1);
// rows and columns past the tensor's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until the committed TMA stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to the TMA (async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A barrier for the 128 threads of one warpgroup (named barrier `id` >= 1).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzle: rows in groups of 8 (1024 bytes apart), the tile 1024-byte aligned.
__device__ __forceinline__ uint64_t gmma_desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The epilogue of one m64n128 accumulator into the staged output tile:
// register 4 j + 2 i + e holds tile row `row` + 8 i, column 8 j + `col` + e
// (row: 16 warp + lane / 4, plus 64 for the second accumulator; col: 2 (lane
// % 4)).  The tile is two 128 x 64 halves, each in the 128-byte swizzle of
// the output's tensor map: 16-byte chunk k of row r at chunk k ^ (r % 8),
// so the warp's 4-byte writes fall in 32 distinct banks.
template <int ACT>
__device__ __forceinline__ void stage_tile(const float (&d)[64],
                                           const __nv_bfloat16* __restrict__ bias,
                                           unsigned char* sC, int row, int col, int n0) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + col;
    const float b0 = __bfloat162float(bias[n0 + c]), b1 = __bfloat162float(bias[n0 + c + 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      *reinterpret_cast<__nv_bfloat162*>(sC + (j / 8) * (C_BYTES / 2) + r * 128 +
                                         (((j % 8) ^ (r % 8)) << 4) + (c % 8) * 2) =
          __floats2bfloat162_rn(act_bf16<ACT>(d[4 * j + 2 * i] + b0),
                                act_bf16<ACT>(d[4 * j + 2 * i + 1] + b1));
    }
  }
}

// C[M, N] = epilogue(A[M, K] B[N, K]^T + bias[N]) in bf16.  tmA, tmB, tmC:
// A, B and C in boxes of 64 columns x 128 rows, 128-byte swizzled.  The
// block's tiles alternate between its two consumer warpgroups (ping-pong):
// one runs its epilogue while the other's wgmma keep the tensor cores busy.
template <int ACT>
__global__ void __launch_bounds__(NT_WG, 1)
    k5_wgmma(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
             const __grid_constant__ CUtensorMap tmC, const __nv_bfloat16* __restrict__ bias,
             int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sA = base;                     // [STAGES][BM][BK], swizzled
  unsigned char* sB = base + STAGES * A_BYTES;  // [STAGES][BN][BK], swizzled
  unsigned char* sCs = sB + STAGES * B_BYTES;   // [2][BM][BN]: each consumer's output tile
  uint64_t* full = reinterpret_cast<uint64_t*>(sCs + 2 * C_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;  // turn[c]: consumer c has waited out a tile's stages

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], 4);  // one arrive per warp of the consuming warpgroup
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int KT = K / BK;

  if (wg == 0) {  // producer: every tile of the block in order, through one ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], A_BYTES + B_BYTES);
          tma_load(sA + stage * A_BYTES, &tmA, kt * BK, m0, &full[stage]);
          tma_load(sB + stage * B_BYTES, &tmB, kt * BK, n0, &full[stage]);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumer c takes the block's tiles c, c + 2, c + 4, ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // The full barriers tell phases apart by parity only, so a consumer may
    // wait on a stage only once its previous phase is complete: each waits
    // for the other to have waited out the tile before its own (`turn`),
    // which also makes their main loops take turns.
    int local = c, turns = 0;  // the tile's place in the block's sequence
    for (int tile = blockIdx.x + c * gridDim.x; tile < tiles; tile += 2 * gridDim.x) {
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
      float d0[64], d1[64];  // rows 0-63 and 64-127 of the tile
#pragma unroll
      for (int i = 0; i < 64; ++i) d0[i] = d1[i] = 0.f;
      if (local > 0) mbar_wait(&turn[1 - c], turns++ & 1);
      int pos = local * KT, prev = -1;
      for (int kt = 0; kt < KT; ++kt, ++pos) {
        const int stage = pos % STAGES;
        mbar_wait(&full[stage], (pos / STAGES) & 1);
        if (kt == KT - 1 && t == 0) mbar_arrive(&turn[c]);
        const uint64_t da = gmma_desc(sA + stage * A_BYTES);
        const uint64_t db = gmma_desc(sB + stage * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {  // 16 bf16 = 32 bytes = 2 descriptor units
          wgmma_m64n128k16(d0, da + 2 * kk, db + 2 * kk);
          wgmma_m64n128k16(d1, da + (64 * BK * 2 >> 4) + 2 * kk, db + 2 * kk);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group before this one has read its stage
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      local += 2;
#pragma unroll
      for (int i = 0; i < 64; ++i) {  // the epilogue reads d only after the wait
        asm volatile("" : "+f"(d0[i])::"memory");
        asm volatile("" : "+f"(d1[i])::"memory");
      }

      unsigned char* sC = sCs + c * C_BYTES;
      if (t == 0) bulk_wait_read();  // the last tile's store has read the staging buffer
      warpgroup_sync(1 + c);
      stage_tile<ACT>(d0, bias, sC, warp * 16 + lane / 4, 2 * (lane % 4), n0);
      stage_tile<ACT>(d1, bias, sC, 64 + warp * 16 + lane / 4, 2 * (lane % 4), n0);
      fence_async_shared();
      warpgroup_sync(1 + c);
      if (t == 0) {  // rows past M are clipped by the tensor map
        tma_store(&tmC, sC, n0, m0);
        tma_store(&tmC, sC + C_BYTES / 2, n0 + BN / 2, m0);
        bulk_commit();
      }
    }
    if (t == 0) bulk_wait();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once per process.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, cols] row-major bf16 matrix read in boxes of 64 columns x box_rows
// rows, 128-byte swizzled; reads past the last row give zeros.  A map
// depends on nothing but these four numbers, so the last MAP_CACHE maps are
// kept and reused (the weights' addresses repeat every call, and the
// caching allocator's often do): encoding one costs microseconds of host
// time on a path that the host binds.
constexpr int MAP_CACHE = 64;
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  struct Entry {
    const void* ptr;
    int rows, cols, box_rows;
    CUtensorMap map;
  };
  static Entry cache[MAP_CACHE];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  cache[next] = Entry{ptr, rows, cols, box_rows, *map};
  next = (next + 1) % MAP_CACHE;
  if (used < MAP_CACHE) ++used;
  return cudaSuccess;
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}

template <int ACT>
cudaError_t launch_wgmma(const void* A, const void* B, const void* bias, void* C, int M, int N,
                         int K, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(k5_wgmma<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap ta, tb, tc;
  cudaError_t err = make_map(&ta, A, M, K, BM);
  if (err == cudaSuccess) err = make_map(&tb, B, N, K, BN);
  if (err == cudaSuccess) err = make_map(&tc, C, M, N, BM);
  if (err != cudaSuccess) return err;
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  k5_wgmma<ACT><<<grid, NT_WG, WG_SMEM, stream>>>(ta, tb, tc,
                                                  static_cast<const __nv_bfloat16*>(bias), M, N, K);
  return cudaGetLastError();
}

#endif  // CUDA_EMULATOR

// ---------------------------------------------------------------- fp32, FFMA

constexpr int FBN = 128;        // columns of a block tile
constexpr int FBK = 16;         // depth of a main-loop step
constexpr int BLD = FBN + 4;    // a k row of the staged B tile, floats
constexpr int F_THREADS = 256;  // 16 row groups x 16 column groups
constexpr int PLD = FBN + 8;    // a row of the split-K partial tile
constexpr int MAX_SPLIT = 8;    // the portable cluster size

// a k row of the staged A tile (16 TM rows), floats
template <int TM>
__host__ __device__ constexpr int f_ald() {
  return 16 * TM + 4;
}
// Shared memory of the fp32 kernel with 16 TM rows a block: two staged
// steps of A and B, or the split-K partial tile, whichever is larger.
template <int TM>
constexpr int ffma_smem() {
  return 2 * FBK * (f_ald<TM>() + BLD) * 4 > 16 * TM * PLD * 4
             ? 2 * FBK * (f_ald<TM>() + BLD) * 4
             : 16 * TM * PLD * 4;
}

// Every thread of the cluster's blocks arrives; returns once all have, their
// shared-memory writes visible (the barrier's default release / acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}
// The float4 at `p` (this block's shared memory) in the cluster's block `rank`.
__device__ __forceinline__ float4 ld_cluster4(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// C[M, N] = act(A[M, K] B[N, K]^T + bias[N]), fp32 row-major, FFMA.  Grid
// (N / 128, ceil(M / (16 TM)), split): block z takes the z-th of `split`
// equal slices of K, and with split > 1 the split's blocks are one cluster
// (1, 1, split) that sums their partial tiles in rank order.  Each 16-deep
// step of A and B is read from device memory into registers (16-byte
// loads, 64 bytes of a row) while the step before it computes, then stored
// transposed, [k][row], into the other of two shared buffers: one barrier
// a step.  Thread (ty, tx) reads its TM rows ty TM .. ty TM + TM - 1 and
// its 8 columns 4 tx .. 4 tx + 3, 64 + 4 tx .. 64 + 4 tx + 3 at one k as
// float4s: two row groups a warp (broadcast) and 16 consecutive column
// groups, free of bank conflicts.
template <int TM, int ACT>
__global__ void __launch_bounds__(F_THREADS, TM == 8 ? 1 : 2)
    k5_ffma(const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K) {
  constexpr int BM = 16 * TM, ALD = f_ald<TM>();
  constexpr int STAGE = FBK * (ALD + BLD);           // floats of a staged step
  constexpr int RQ = FBK / 4;                       // float4s of a row in a step
  constexpr int UA = (BM * RQ + F_THREADS - 1) / F_THREADS;  // A float4s a thread
  constexpr int UB = FBN * RQ / F_THREADS;          // B float4s a thread
  extern __shared__ __align__(16) float fsmem[];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * FBN;
  const int split = gridDim.z, slice = K / split, kbeg = blockIdx.z * slice;

  float4 ra[UA], rb[UB];  // the next step, on its way from device memory
  // float4 c of a step: row c / RQ, k 4 (c % RQ) .. 4 (c % RQ) + 3; rows of A past M are zeros
  auto fetch = [&](int kt) {
    const int k = kbeg + kt * FBK;
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int c = tid + u * F_THREADS, row = m0 + c / RQ;
      ra[u] = (c < BM * RQ && row < M)
                  ? *reinterpret_cast<const float4*>(A + (int64_t)row * K + k + 4 * (c % RQ))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int c = tid + u * F_THREADS;
      rb[u] = *reinterpret_cast<const float4*>(B + (int64_t)(n0 + c / RQ) * K + k + 4 * (c % RQ));
    }
  };
  auto stash = [&](int buf) {
    float* sa = fsmem + buf * STAGE;
    float* sb = sa + FBK * ALD;
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int c = tid + u * F_THREADS, r = c / RQ, k = 4 * (c % RQ);
      if (c < BM * RQ) {
        sa[(k + 0) * ALD + r] = ra[u].x, sa[(k + 1) * ALD + r] = ra[u].y;
        sa[(k + 2) * ALD + r] = ra[u].z, sa[(k + 3) * ALD + r] = ra[u].w;
      }
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int c = tid + u * F_THREADS, r = c / RQ, k = 4 * (c % RQ);
      sb[(k + 0) * BLD + r] = rb[u].x, sb[(k + 1) * BLD + r] = rb[u].y;
      sb[(k + 2) * BLD + r] = rb[u].z, sb[(k + 3) * BLD + r] = rb[u].w;
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int KT = slice / FBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) fetch(kt + 1);  // in flight while step kt computes
    const float* sa = fsmem + (kt & 1) * STAGE + ty * TM;
    const float* sb = fsmem + (kt & 1) * STAGE + FBK * ALD + 4 * tx;
#pragma unroll
    for (int k = 0; k < FBK; ++k) {  // every output's sum runs k = 0, 1, ... in order
      float a[TM], b[8];
      if (TM >= 4) {
#pragma unroll
        for (int i = 0; i < TM; i += 4)
          *reinterpret_cast<float4*>(&a[i]) = *reinterpret_cast<const float4*>(sa + k * ALD + i);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = sa[k * ALD + i];
      }
      *reinterpret_cast<float4*>(&b[0]) = *reinterpret_cast<const float4*>(sb + k * BLD);
      *reinterpret_cast<float4*>(&b[4]) = *reinterpret_cast<const float4*>(sb + k * BLD + 64);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < KT) {
      stash((kt + 1) & 1);  // the other buffer: its readers passed the last barrier
      __syncthreads();
    }
  }

  if (split == 1) {
    float bj[8];
    *reinterpret_cast<float4*>(&bj[0]) = *reinterpret_cast<const float4*>(bias + n0 + 4 * tx);
    *reinterpret_cast<float4*>(&bj[4]) =
        *reinterpret_cast<const float4*>(bias + n0 + 64 + 4 * tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      if (row >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 o;
        o.x = act_fp32<ACT>(acc[i][4 * h + 0] + bj[4 * h + 0]);
        o.y = act_fp32<ACT>(acc[i][4 * h + 1] + bj[4 * h + 1]);
        o.z = act_fp32<ACT>(acc[i][4 * h + 2] + bj[4 * h + 2]);
        o.w = act_fp32<ACT>(acc[i][4 * h + 3] + bj[4 * h + 3]);
        *reinterpret_cast<float4*>(C + (int64_t)row * N + n0 + 64 * h + 4 * tx) = o;
      }
    }
    return;
  }
  __syncthreads();  // every thread is done with the staged steps: the partial tile goes there
  float* part = fsmem;  // [BM][PLD]
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(part + (ty * TM + i) * PLD + 64 * h + 4 * tx) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  cluster_sync();  // every block of the split has written its partial tile
  // block z finishes rows [z BM / split, (z + 1) BM / split): the partials of
  // blocks 0, 1, ..., split - 1 added in that order, then bias and activation
  const int rows = BM / split, rbeg = blockIdx.z * rows;
  for (int c = tid; c < rows * (FBN / 4); c += F_THREADS) {
    const int r = rbeg + c / (FBN / 4), q = c % (FBN / 4), row = m0 + r;
    if (row >= M) continue;
    const float* p = part + r * PLD + 4 * q;
    float4 s = ld_cluster4(p, 0);
    for (int z = 1; z < split; ++z) {
      const float4 t = ld_cluster4(p, z);
      s.x += t.x, s.y += t.y, s.z += t.z, s.w += t.w;
    }
    const float4 bv = *reinterpret_cast<const float4*>(bias + n0 + 4 * q);
    float4 o;
    o.x = act_fp32<ACT>(s.x + bv.x);
    o.y = act_fp32<ACT>(s.y + bv.y);
    o.z = act_fp32<ACT>(s.z + bv.z);
    o.w = act_fp32<ACT>(s.w + bv.w);
    *reinterpret_cast<float4*>(C + (int64_t)row * N + n0 + 4 * q) = o;
  }
  cluster_sync();  // no block leaves while another still reads its partial tile
}

template <int TM, int ACT>
cudaError_t launch_ffma(const void* A, const void* B, const void* bias, void* C, int M, int N,
                        int K, int split, cudaStream_t stream) {
  constexpr int smem = ffma_smem<TM>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        k5_ffma<TM, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / FBN, (M + 16 * TM - 1) / (16 * TM), split);
  cfg.blockDim = dim3(F_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, k5_ffma<TM, ACT>, static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(bias), static_cast<float*>(C), M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int ACT>
cudaError_t launch_fp32(const void* A, const void* B, const void* bias, void* C, int M, int N,
                        int K, int tm, int split, cudaStream_t st) {
  switch (tm) {
    case 8: return launch_ffma<8, ACT>(A, B, bias, C, M, N, K, split, st);
    case 4: return launch_ffma<4, ACT>(A, B, bias, C, M, N, K, split, st);
    case 2: return launch_ffma<2, ACT>(A, B, bias, C, M, N, K, split, st);
    case 1: return launch_ffma<1, ACT>(A, B, bias, C, M, N, K, split, st);
  }
  return cudaErrorInvalidValue;
}

// A plan (tm, split) for C[M, N] = A[M, K] B[N, K]^T that the kernel takes.
bool plan_ok(int M, int K, int tm, int split) {
  return (tm == 1 || tm == 2 || tm == 4 || tm == 8) &&
         (split == 1 || split == 2 || split == 4 || split == MAX_SPLIT) &&
         K % (FBK * split) == 0 && (M + 16 * tm - 1) / (16 * tm) <= 65535;
}

template <int ACT>
cudaError_t gemm(int dtype, const void* A, const void* B, const void* bias, void* C, int M, int N,
                 int K, int tm, int split, cudaStream_t st) {
#ifndef CUDA_EMULATOR
  if (dtype == 1) return launch_wgmma<ACT>(A, B, bias, C, M, N, K, st);
#endif
  return dtype == 0 ? launch_fp32<ACT>(A, B, bias, C, M, N, K, tm, split, st)
                    : cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  act: 1 = exact-erf GELU, 2 = QuickGELU.
// x [M, D], w1 [F, D], b1 [F], w2 [D, F], b2 [D], hidden [M, F] scratch,
// y [M, D]: contiguous, all of `dtype`, with 16-byte aligned bases.  fp32
// takes the plan of each GEMM, fc1 (tm1, split1) and fc2 (tm2, split2):
// 16 tm rows a block and K cut into `split` slices
// (madtp_tpu_torch/kernels/ffn.py `fp32_plan`); bf16 ignores them.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int k5_ffn(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* hidden, void* y, int M, int D, int F, int act,
                      int tm1, int split1, int tm2, int split2, void* stream) {
  if (M < 1 || D < 128 || F < 128 || D % 128 || F % 128 || (dtype != 0 && dtype != 1) ||
      (dtype == 0 && !(plan_ok(M, D, tm1, split1) && plan_ok(M, F, tm2, split2))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act == ACT_GELU)
    err = gemm<ACT_GELU>(dtype, x, w1, b1, hidden, M, F, D, tm1, split1, st);
  else if (act == ACT_QUICK_GELU)
    err = gemm<ACT_QUICK_GELU>(dtype, x, w1, b1, hidden, M, F, D, tm1, split1, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)gemm<ACT_NONE>(dtype, hidden, w2, b2, y, M, D, F, tm2, split2, st);
}
