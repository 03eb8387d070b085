// K1 on Hopper: multi-head attention with the DTP scoring side outputs; bf16
// on the tensor cores (mma.sync), fp32 on the CUDA cores.
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
// token and batch stride shared by the three, rows 16-byte aligned), the
// layout the qkv linear writes; out is [B, N, H, Dh] contiguous.  Any N >= 2;
// the ragged last tile is masked here, so the caller pads nothing.
//
// Design.  The TPU kernel keeps an [N, N] fp32 head-max plane in VMEM; at
// N = 592 that is 1.4 MB, and a block here has 227 KB.  So two passes:
//   pass A (`k1_fwd`), a FlashAttention-2 forward: one block per (image,
//     head, 64 query rows), one warp per 16 query rows (a short text buffer
//     of 26-40 rows runs 2-3 warps, so at most 15 rows are wasted).  Each
//     warp keeps its Q fragments in registers (bf16; fp32 rereads them from
//     L1 each tile, 64 registers saved); K and V stream in their input
//     dtype through a 2-stage cp.async ring of XOR-swizzled 64-key tiles,
//     read with ldmatrix, and the key bias of all N keys sits in shared
//     memory; S = q k^T sits in the mma accumulators, the online
//     softmax runs on them, and P is the A operand of P v straight from the
//     registers (in bf16 rounded to bf16, as the TPU kernel's
//     `p.astype(v.dtype)` and the plain version round it).  The epilogue
//     writes out, the row max m and sum-exp l, and the fp32 row norm r_h.
//   pass B (`k1_scores`), one block per (key tile, image), 8 warps: the K
//     tiles of all H heads stay in shared memory; the Q tiles of every
//     (128-row query tile, head) stream through a cp.async ring (4 stages in
//     bf16, 2 in fp32) with their rows' m and l (4-byte cp.async: a stage
//     waits on no load of its own).  Each warp takes 16 query rows against
//     all the block's keys.  S comes from the same mma sequence in the same
//     k-order as in pass A, so P recomputed from m and l is the P they
//     describe; the head max stays in the accumulator registers, and each
//     query tile's alive rows are added into per-lane column sums.  Column
//     sums close in a fixed order: shuffles across the 8 row lanes, then the
//     8 warps through shared memory.  The query tile holding row 0 forms
//     cls_attn.  Where ceil(N / key tile) B gives fewer than 528 blocks (four
//     waves of 132 SMs at one block an SM; CLIP's B = 32, N = 320: 160), the
//     query tiles are split into `chunks` ranges, one block each
//     (madtp_tpu_torch/kernels/attention_scores.py `pass_b_chunks`); each
//     writes fp32 column partials and `k1_colsum` adds them in chunk order.
// Sums run in a fixed order with no float atomics, so every output is the
// same bit for bit from run to run and the DTP decisions fed by col_mass
// cannot flip.  Exponentials run on the SFU (`ex2.approx`) as
// P = 2^((x - m) log2(e) - log2(l)) with x = scale q.k + bias: the max is
// subtracted in natural units, so pass B and K2 use pass A's m exactly.
// (Folding log2(e) into the scale would make the stored natural-unit m a
// rounded copy of the max, and with a PAD_BIAS key as a row's max, ulp(1e4)
// = 1e-3 of error in the exponent: P off by 0.07%.)
//
// The design above is bf16's.  fp32 (the mask-mode train step, the drivers'
// default, and the card-against-CPU checks) runs the same two passes on the
// CUDA cores (`simt::`, below; 3xTF32 on the tensor cores kept K1 within its
// fp32 tolerance but not the checks' limits), redesigned for
// occupancy, the measured limit of FFMA tiles here: pass A keeps 51 KB of
// shared memory so that four 128-thread blocks share an SM (Q once, K and V
// by cp.async in their own layout, P through the consumed K tile), pass B
// two 256-thread blocks of a 2-stage ring of (Q tile, K rows of its head)
// over row 0 and the alive rows only, packed; both hold 4 x 8 outputs a
// thread, take the logits in one fixed order and P = exp(x - m) times
// 1/l, and pass B takes the query split of bf16.  The
// first FFMA design is csrc/previous/attention_scores.cu.
//
// Bound on the card.  At the NLVR gather path's first layer (B = 64 images,
// H = 12, N = 584, Dh = 64, bf16) the function needs 4 N^2 Dh flops per
// (image, head), about 67 GFLOP or 0.068 ms of bf16 tensor cores at 989
// TFLOP/s, and moves about 230 MB (q, k, v in, out back), 0.069 ms at 3.35
// TB/s: it sits at the ridge.  This design does 6 N^2 Dh flops (pass B
// recomputes q k^T for every head) on mma.sync, below the wgmma rate, and
// 2 B H N^2 exponentials (0.5 G, about 0.12 ms of the SFUs at this shape),
// which bind beside the products once these run on tensor cores.  Measured
// on the H100 (PERF.md): 0.94 ms here, 14x the bound: neither bytes nor
// products bind, but latency with few warps an SM (4 blocks of 4 warps in
// pass A, 1 block of 8 in pass B).  In K3's
// range, at the VQA-640 gather path's first layer (B = 16, H = 12, N =
// 1608), about 127 GFLOP (0.128 ms) against 158 MB (0.047 ms): bound by
// operations.
//
// Launch count: the Python wrapper
// madtp_tpu_torch/kernels/attention_scores.py (`attention_scores_cuda`) adds
// one to `attention_scores_cuda.launches` per successful call of
// `k1_attention_scores` below, which launches both passes (and `k1_colsum`
// when pass B is split), and, when N > 1536, one to
// `attention_scores_cuda.large_n_launches` (K3's count); `attention_planes_cuda`
// adds one to its own count per call of `k1_attention_planes` (pass A and
// `k1_planes`, the tensor-parallel variant further below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;          // head dim (ViT-B/L and BERT-base)
constexpr int ROWS = 16;        // query rows per warp (the mma's M)
constexpr int QT = 64;          // query rows per tile: 4 warps
constexpr int KT = 64;          // keys per pass-A tile
constexpr int A_STAGES = 2;     // pass A's cp.async ring
constexpr int B_THREADS = 256;  // pass B: 8 warps of 16 query rows
constexpr int MAX_HEADS = 16;
constexpr int MAX_N = 16384;    // pass A keeps every key's bias in shared memory
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
// 4 bytes global -> shared (.ca: the 16-byte form needs 16-byte aligned rows).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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
// 2^x on the SFU (relative error below 2^-22; 0 at -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---------------------------------------------------------------- operand policy
//
// Tiles of 64-wide rows sit in shared memory XOR-swizzled by 16-byte chunk
// (chunk c of row r at c ^ (r & 7)), so that ldmatrix reads are free of
// bank conflicts.  A k-step covers 16 head dims in chunks 2s and 2s+1 of a
// row, so one ldmatrix.x4 of 8 rows and chunks 4p..4p+3 gives the B
// fragments of k-steps 2p and 2p+1, and one of 16 rows and chunks 2s, 2s+1
// gives the A fragment of k-step s.  (csrc/attention_scores_bwd.cu keeps a
// copy of these helpers with an fp32 policy, 3xTF32, beside it.)

template <typename T> struct Op;

template <> struct Op<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int NK = DH / 16;       // k-steps over the head dim
  static constexpr int ROWB = DH * 2;      // bytes of a tile row
  struct A { uint32_t r[4]; };
  __device__ __forceinline__ static void mma(float (&d)[4], const A& a, uint32_t b0,
                                             uint32_t b1) {
    mma_bf16(d, a.r, b0, b1);
  }
  __device__ __forceinline__ static A make_a(const uint32_t (&r)[4]) {
    A a;
#pragma unroll
    for (int e = 0; e < 4; ++e) a.r[e] = r[e];
    return a;
  }
  // A fragment of k-step s for rows r0 + g, r0 + g + 8 of a row-major
  // [row][DH] array in global memory; rows >= n are zero.
  __device__ __forceinline__ static A load_a(const T* base, int64_t stride, int r0, int n,
                                             int s, int g, int t) {
    A a;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e & 1) * 8, col = 16 * s + (e >> 1) * 8 + 2 * t;
      a.r[e] = row < n ? *reinterpret_cast<const uint32_t*>(base + (int64_t)row * stride + col)
                       : 0u;
    }
    return a;
  }
  // A fragment of k-step ks (16 keys) of a P-shaped product from the
  // accumulators sc[key blocks of 8][4], rounded to bf16.
  template <int NKB>
  __device__ __forceinline__ static A acc_a(const float (&sc)[NKB][4], int ks) {
    A a;
    a.r[0] = pack_bf16(sc[2 * ks][0], sc[2 * ks][1]);
    a.r[1] = pack_bf16(sc[2 * ks][2], sc[2 * ks][3]);
    a.r[2] = pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
    a.r[3] = pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
    return a;
  }
  // o[8 dim blocks][4] += P (16 x 8 NKB keys, sc) times rows row0 ..
  // row0 + 8 NKB - 1 of a swizzled [key][DH] tile: V by ldmatrix.trans.
  template <int NKB>
  __device__ __forceinline__ static void pv(float (&o)[8][4], const float (&sc)[NKB][4],
                                            const unsigned char* tile, int row0, int lane) {
    static_assert(NKB % 2 == 0, "a bf16 k-step covers 16 keys");
    const uint32_t base = smem_addr(tile);
    const int mat = lane / 8, mrow = lane % 8;
#pragma unroll
    for (int ks = 0; ks < NKB / 2; ++ks) {
      const A pa = acc_a(sc, ks);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t r[4];
        const int row = row0 + 16 * ks + (mat & 1) * 8 + mrow, ch = 2 * dp + (mat >> 1);
        ldmatrix_x4_trans(r, base + row * ROWB + ((ch ^ (row & 7)) << 4));
        mma(o[2 * dp], pa, r[0], r[1]);
        mma(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
  }
  __device__ __forceinline__ static void store2(T* dst, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  }
};

// Shared-memory address of chunk ch of row r of a swizzled tile.
template <int ROWB>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * ROWB + ((ch ^ (r & 7)) << 4);
}

// Issues the cp.async copies of rows [r0, r0 + rows) of a [row][DH] array
// (row stride `stride` elements) into a swizzled tile; rows >= n are zero.
// r0 < n, so the dummy source of a zero row is a valid address.
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* base, int64_t stride, int r0,
                                          int rows, int n, int tid, int nthreads) {
  constexpr int ROWB = Op<T>::ROWB, CH = ROWB / 16, EL = 16 / (int)sizeof(T);
  for (int c = tid; c < rows * CH; c += nthreads) {
    const int r = c / CH, ch = c % CH, row = r0 + r;
    const bool in = row < n;
    cp_async16(dst + swz<ROWB>(r, ch), base + (int64_t)(in ? row : r0) * stride + ch * EL,
               in ? 16 : 0);
  }
}

// S (16 rows x 8 NBLK keys) = A (the warp's rows, NK k-steps, A fragment s
// from get_a(s)) times the key rows [key0, key0 + 8 NBLK) of a swizzled tile
// at `base`, k-steps in order: the one sequence every pass runs.
template <typename T, int NBLK, class GetA>
__device__ __forceinline__ void qk(float (&s)[NBLK][4], GetA get_a, uint32_t base, int key0,
                                   int lane) {
  using O = Op<T>;
#pragma unroll
  for (int j = 0; j < NBLK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int sp = 0; sp < O::NK / 2; ++sp) {
    const typename O::A a0 = get_a(2 * sp), a1 = get_a(2 * sp + 1);
#pragma unroll
    for (int j = 0; j < NBLK; ++j) {
      uint32_t r[4];
      const int row = key0 + 8 * j + lane % 8;
      ldmatrix_x4(r, base + swz<O::ROWB>(row, 4 * sp + lane / 8));
      O::mma(s[j], a0, r[0], r[1]);
      O::mma(s[j], a1, r[2], r[3]);
    }
  }
}

// The A fragment of k-step s of rows row0 .. row0 + 15 of a swizzled tile.
template <typename T>
__device__ __forceinline__ typename Op<T>::A tile_a(uint32_t base, int row0, int s, int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, base + swz<Op<T>::ROWB>(row0 + (lane / 8 & 1) * 8 + lane % 8, 2 * s + lane / 16));
  return Op<T>::make_a(r);
}

// ---------------------------------------------------------------- pass A

// Grid (ceil(N / QT), B H): the query tiles of one (image, head) run side by
// side and share its K and V in L2.  blockDim 32 x min(4, ceil(N / 16)); at
// registers capped so that four blocks share an SM.
template <typename T>
__global__ void __launch_bounds__(128, 4) k1_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int64_t sb,
    int64_t sn, const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ stat_m, float* __restrict__ stat_l,
    float* __restrict__ rnorm, int N, int H, float scale) {
  using O = Op<T>;
  constexpr int TILE = KT * O::ROWB;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Ks = smem;                               // [A_STAGES][KT rows]
  unsigned char* Vs = smem + A_STAGES * TILE;             // [A_STAGES][KT rows]
  float* kb = reinterpret_cast<float*>(Vs + A_STAGES * TILE);  // [ceil(N / KT) KT]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * QT + warp * ROWS;
  const bool active = r0 < N;  // warp-uniform
  const int ntiles = (N + KT - 1) / KT;
  const int64_t head = (int64_t)b * sb + (int64_t)h * DH;

  auto load = [&](int stage, int tile) {
    load_tile<T>(smem_addr(Ks + stage * TILE), k + head, sn, tile * KT, KT, N, tid, nthreads);
    load_tile<T>(smem_addr(Vs + stage * TILE), v + head, sn, tile * KT, KT, N, tid, nthreads);
  };
  // the key bias of every key, -inf where dead or past N
  for (int key = tid; key < ntiles * KT; key += nthreads)
    kb[key] = (key < N && alive[(int64_t)b * N + key]) ? bias[(int64_t)b * N + key] : -INFINITY;

  typename O::A qa[O::NK];
#pragma unroll
  for (int s = 0; s < O::NK; ++s) qa[s] = O::load_a(q + head, sn, r0, N, s, g, t);

  float o[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < A_STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<A_STAGES - 2>();
    __syncthreads();  // this tile landed for every thread; the previous one is consumed
    const int pf = tile + A_STAGES - 1;
    if (pf < ntiles) load(pf % A_STAGES, pf);
    cp_async_commit();
    if (active) {
      const int stage = tile % A_STAGES;
      const float* kbs = kb + tile * KT;
      float sc[8][4];
      qk<T, 8>(sc, [&](int s) { return qa[s]; }, smem_addr(Ks + stage * TILE), 0, lane);

      // online softmax on the fragments: element e of block j is (row g + 8 (e >> 1),
      // key 8 j + 2 t + (e & 1))
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kbv = kbs[8 * j + 2 * t + (e & 1)];
          sc[j][e] = kbv == -INFINITY ? -INFINITY : fmaf(sc[j][e], scale, kbv);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        alpha[i] = mn == -INFINITY ? 1.f : ex2((m[i] - mn) * LOG2E);
        m[i] = mn;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          sc[j][e] = sc[j][e] == -INFINITY ? 0.f : ex2((sc[j][e] - m[i]) * LOG2E);
          l[i] += sc[j][e];
          o[j][e] *= alpha[i];
        }
      O::pv(o, sc, Vs + stage * TILE, 0, lane);
    }
  }
  cp_async_wait<0>();
  if (!active) return;  // no barrier follows

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);  // no alive key: o is 0
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][2 * i] *= inv;
      o[j][2 * i + 1] *= inv;
      sq = fmaf(o[j][2 * i], o[j][2 * i], sq);
      sq = fmaf(o[j][2 * i + 1], o[j][2 * i + 1], sq);
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    if (row >= N) continue;
    T* dst = out + (((int64_t)b * N + row) * H + h) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) O::store2(dst + 8 * j, o[j][2 * i], o[j][2 * i + 1]);
    if (t == 0) {
      const int64_t s_idx = ((int64_t)b * H + h) * N + row;
      stat_m[s_idx] = m[i] == -INFINITY ? 0.f : m[i];
      stat_l[s_idx] = l[i];
      rnorm[s_idx] = sqrtf(sq);
    }
  }
}

// ---------------------------------------------------------------- pass B

// Pass B's shape: keys per block (the K tiles of all heads stay in shared
// memory: 128 KB at H = 16), query rows per stage (8 warps x 16) and the
// ring's depth.
template <typename T> struct PassB {
  static constexpr int TK = 64;
  static constexpr int STAGES = 4;
};
constexpr int BQ = 128;  // query rows per pass-B stage

template <typename T>
constexpr int pass_b_smem(int H) {
  return H * PassB<T>::TK * Op<T>::ROWB                        // K tiles of all heads
         + PassB<T>::STAGES * (BQ * Op<T>::ROWB + BQ * 8)       // Q ring, rows' m and l
         + PassB<T>::TK * 4 * (H + 8);                          // r_h of each head, column sums
}

// Grid (ceil(N / TK), chunks, B); 256 threads.  Warp w takes query rows
// 16 w .. 16 w + 15 of each 128-row query tile against all TK keys of the
// block.  Chunk c walks query tiles [c per, min((c + 1) per, ceil(N / BQ))).
// With chunks == 1 it writes col; else fp32 partials part[c][b][n].
template <typename T>
__global__ void __launch_bounds__(B_THREADS) k1_scores(
    const T* __restrict__ q, const T* __restrict__ k, int64_t sb, int64_t sn,
    const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    const float* __restrict__ rnorm, float* __restrict__ col, float* __restrict__ part,
    float* __restrict__ cls, int N, int H, float scale) {
  using O = Op<T>;
  constexpr int TK = PassB<T>::TK, NB = TK / 8, S = PassB<T>::STAGES;
  constexpr int KTILE = TK * O::ROWB, QTILE = BQ * O::ROWB;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Kr = smem;                                    // [H][TK rows]
  unsigned char* Qr = Kr + H * KTILE;                          // [S][BQ rows]
  float* ml = reinterpret_cast<float*>(Qr + S * QTILE);        // [S][2][BQ]
  float* rnk = ml + S * 2 * BQ;                                // [H][TK]
  float* red = rnk + H * TK;                                   // [8][TK]

  const int k0 = blockIdx.x * TK, chunk = blockIdx.y, chunks = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nqt = (N + BQ - 1) / BQ, per = (nqt + chunks - 1) / chunks;
  const int qt0 = chunk * per, qt1 = min(nqt, qt0 + per);
  const int nst = (qt1 - qt0) * H;  // stages: (query tile, head), heads inner
  const int64_t bN = (int64_t)b * N;

  for (int hh = 0; hh < H; ++hh)
    load_tile<T>(smem_addr(Kr + hh * KTILE), k + (int64_t)b * sb + hh * DH, sn, k0, TK, N, tid,
                 B_THREADS);
  for (int i = tid; i < TK * H; i += B_THREADS) {
    const int j = k0 + i % TK;
    rnk[i] = j < N ? rnorm[((int64_t)b * H + i / TK) * N + j] : 0.f;
  }
  // a stage: the Q tile of one (query tile, head) and its rows' m and l (a
  // row past N gets l = 0)
  auto load_q = [&](int stage, int it) {
    const int qt = qt0 + it / H, hh = it % H;
    load_tile<T>(smem_addr(Qr + stage * QTILE), q + (int64_t)b * sb + hh * DH, sn, qt * BQ, BQ,
                 N, tid, B_THREADS);
    if (tid < BQ) {
      const int i = qt * BQ + tid;
      const int64_t s = ((int64_t)b * H + hh) * N + min(i, N - 1);
      const int bytes = i < N ? 4 : 0;
      cp_async4(smem_addr(ml + (stage * 2) * BQ + tid), stat_m + s, bytes);
      cp_async4(smem_addr(ml + (stage * 2 + 1) * BQ + tid), stat_l + s, bytes);
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nst) load_q(s, s);
    cp_async_commit();  // the K tiles ride in the first group
  }

  // this lane's keys 8 j + 2 t + c: natural-unit bias, -inf where dead or past N
  float mx[NB][4], colacc[NB][2], num[NB][2], den[NB][2], kbr[NB][2];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * j + 2 * t + c;
      kbr[j][c] = (key < N && alive[bN + key]) ? bias[bN + key] : -INFINITY;
      colacc[j][c] = num[j][c] = den[j][c] = 0.f;
    }

  for (int it = 0; it < nst; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();
    const int pf = it + S - 1;
    if (pf < nst) load_q(pf % S, pf);
    cp_async_commit();

    const int stage = it % S, qt = qt0 + it / H, hh = it % H;
    if (hh == 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[j][e] = 0.f;
    }
    if (qt * BQ + warp * ROWS < N) {  // warp-uniform: this warp has rows in the tile
      const uint32_t qbase = smem_addr(Qr + stage * QTILE);
      float sc[NB][4];
      qk<T, NB>(sc, [&](int s) { return tile_a<T>(qbase, warp * ROWS, s, lane); },
                smem_addr(Kr + hh * KTILE), 0, lane);
      // P = exp(x - m) / l = 2^((x - m) log2(e) - log2(l)); the max is
      // subtracted in natural units, so m from pass A is used exactly
      float rm[2], rl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * ROWS + g + 8 * i;
        const float lv = ml[(stage * 2 + 1) * BQ + r];
        rm[i] = ml[stage * 2 * BQ + r];
        rl[i] = lv > 0.f ? log2f(lv) : 0.f;  // no alive key: every x is -inf
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float x = fmaf(sc[j][e], scale, kbr[j][e & 1]);
          const float p = ex2(fmaf(x - rm[i], LOG2E, -rl[i]));
          mx[j][e] = fmaxf(mx[j][e], p);
          if (qt == 0 && warp == 0 && g == 0 && e < 2) {  // query row 0
            const float r = rnk[hh * TK + 8 * j + 2 * t + e];
            num[j][e] = fmaf(p, r, num[j][e]);
            den[j][e] += r;
          }
        }
      if (hh == H - 1) {  // the tile's head max is complete: add its alive rows
        const int i_lo = qt * BQ + warp * ROWS + g, i_hi = i_lo + 8;
        const bool a_lo = i_lo >= 1 && i_lo < N && alive[bN + i_lo];
        const bool a_hi = i_hi < N && alive[bN + i_hi];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            colacc[j][c] += (a_lo ? mx[j][c] : 0.f) + (a_hi ? mx[j][2 + c] : 0.f);
      }
    }
  }
  cp_async_wait<0>();

  // column sums: over the 8 row lanes (g), then the 8 warps in order
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x = colacc[j][c];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) red[warp * TK + 8 * j + 2 * t + c] = x;
    }
  __syncthreads();
  if (tid < TK && k0 + tid < N) {
    const int j = k0 + tid;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) acc += red[w * TK + tid];
    if (chunks == 1)
      col[bN + j] = alive[bN + j] ? acc : 0.f;
    else
      part[((int64_t)chunk * gridDim.z + b) * N + j] = acc;
  }
  if (qt0 == 0 && warp == 0 && g == 0) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t + c;
        if (key < N) cls[bN + key] = num[j][c] / (den[j][c] + 1e-8f);
      }
  }
}

// col[b, n] = the chunks' partials added in chunk order, 0 at dead n.
__global__ void __launch_bounds__(256) k1_colsum(const float* __restrict__ part,
                                                 const uint8_t* __restrict__ alive,
                                                 float* __restrict__ col, int B, int N,
                                                 int chunks) {
  const int64_t idx = (int64_t)blockIdx.x * 256 + threadIdx.x, total = (int64_t)B * N;
  if (idx >= total) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += part[c * total + idx];
  col[idx] = alive[idx] ? acc : 0.f;
}

// ---------------------------------------------------------------- the planes variant
//
// Tensor parallelism splits the heads of a MED self-attention over the ranks
// of a model group, and col_mass (a max over heads, then a sum over queries)
// and cls_attn (each head weighted by r_h / sum_h r_h) do not add up from
// the ranks' own col_mass and cls_attn.  So the variant `k1_attention_planes`
// runs pass A as above, then `k1_planes`, which writes what the group can
// combine:
//   plane[b, i-1, n-1] = max over the rank's heads of P_h[i, n] (i, n >= 1;
//                        0 where query i is dead), fp32, combined by a MAX;
//   num[b, n-1]        = sum over the rank's heads of P_h[0, n] r_h[n];
//   den[b, n-1]        = sum over the rank's heads of r_h[n], both combined
//                        by a SUM, then cls_attn = num / (den + 1e-8) and
//                        col_mass = the plane summed over its queries.
// P is recomputed from pass A's m and l: P = exp(x - m) / l, x = scale q.k +
// bias, summed over the head dims in order on FFMA from the inputs widened to
// fp32 (bf16 products are exact in fp32), 0 at a dead key.  Grid (ceil((N -
// 1) / 32) key tiles, ceil(N / 32) query tiles, B), 256 threads: thread (r,
// kl) holds query row r of the tile against keys kl + 8 j (j < 4); the
// tiles of each head pass through padded shared memory.  Text N is 26-40
// here, so a block or four an image.

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int PT = 32;  // query rows and keys of a planes tile

template <typename T>
__global__ void __launch_bounds__(256) k1_planes(
    const T* __restrict__ q, const T* __restrict__ k, int64_t sb, int64_t sn,
    const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    const float* __restrict__ rnorm, float* __restrict__ plane, float* __restrict__ num,
    float* __restrict__ den, int N, int H, float scale) {
  __shared__ float Qs[PT][DH + 1];
  __shared__ float Ks[PT][DH + 1];
  const int b = blockIdx.z, i0 = blockIdx.y * PT, n0 = 1 + blockIdx.x * PT;
  const int tid = threadIdx.x, r = tid / 8, kl = tid % 8, i = i0 + r;
  const int64_t bN = (int64_t)b * N;
  float mx[4] = {0.f, 0.f, 0.f, 0.f}, nm[4] = {0.f, 0.f, 0.f, 0.f},
        dn[4] = {0.f, 0.f, 0.f, 0.f};
  for (int h = 0; h < H; ++h) {
    __syncthreads();
    const T* qh = q + (int64_t)b * sb + (int64_t)h * DH;
    const T* kh = k + (int64_t)b * sb + (int64_t)h * DH;
    for (int e = tid; e < PT * DH; e += 256) {
      const int row = e / DH, d = e % DH, qi = i0 + row, kn = n0 + row;
      Qs[row][d] = qi < N ? widen(qh[(int64_t)qi * sn + d]) : 0.f;
      Ks[row][d] = kn < N ? widen(kh[(int64_t)kn * sn + d]) : 0.f;
    }
    __syncthreads();
    if (i >= N) continue;
    const int64_t st = ((int64_t)b * H + h) * N;
    const float m = stat_m[st + i], l = stat_l[st + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + kl + 8 * j;
      if (n >= N) continue;
      float p = 0.f;
      if (alive[bN + n] && l > 0.f) {
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) s = fmaf(Qs[r][d], Ks[kl + 8 * j][d], s);
        p = expf(s * scale + bias[bN + n] - m) / l;
      }
      mx[j] = fmaxf(mx[j], p);
      if (i == 0) {
        const float rr = rnorm[st + n];
        nm[j] = fmaf(p, rr, nm[j]);
        dn[j] += rr;
      }
    }
  }
  if (i >= N) return;
  const int P = N - 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + kl + 8 * j;
    if (n >= N) continue;
    if (i == 0) {
      num[(int64_t)b * P + n - 1] = nm[j];
      den[(int64_t)b * P + n - 1] = dn[j];
    } else {
      plane[((int64_t)b * P + i - 1) * P + n - 1] = alive[bN + i] ? mx[j] : 0.f;
    }
  }
}

template <typename T>
cudaError_t launch_planes(const T* q, const T* k, int64_t sb, int64_t sn, const uint8_t* alive,
                          const float* bias, const float* stat_m, const float* stat_l,
                          const float* rnorm, float* plane, float* num, float* den, int B,
                          int N, int H, float scale, cudaStream_t stream) {
  const dim3 grid((N - 1 + PT - 1) / PT, (N + PT - 1) / PT, B);
  k1_planes<T><<<grid, 256, 0, stream>>>(q, k, sb, sn, alive, bias, stat_m, stat_l, rnorm,
                                         plane, num, den, N, H, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32, CUDA cores

// fp32 multiplies on the CUDA cores (FFMA).  Tensor cores would mean
// 3xTF32, and the card's fp32 results then drift from the CPU's (the fp32
// plain version) twice as far as with FFMA: the VQA card-against-CPU
// check's question states by 1.1e-5 against its 1e-5 limit, even with a
// fourth (lo lo) product (PERF.md).  The same two passes as bf16, on FFMA
// tiles; every tile row is padded to 68 floats (272 bytes), so that a warp's
// float4 reads of 4 or 8 consecutive rows at one head dim fall in distinct
// bank groups.
namespace simt {

constexpr int LD = DH + 4;  // a padded Q, K, V or P row, floats
constexpr int TK = 64;      // keys of a pass-A tile and of a pass-B block
constexpr int A_TQ = 64;    // pass A: query rows a block
constexpr int A_NT = 128;   // pass A: 4 warps, four blocks an SM
constexpr int B_TQ = BQ;    // pass B: query rows a stage
constexpr int B_NT = 256;   // pass B: 8 warps, two blocks an SM
constexpr int A_SMEM = (A_TQ * LD + 2 * TK * LD + TK) * 4;
constexpr int B_STAGE = B_TQ * LD + TK * LD + 2 * B_TQ;  // floats: Q, K, the rows' m and l

constexpr int pass_b_smem(int H) { return (2 * B_STAGE + H * TK + 8 * TK + 2 * B_TQ) * 4; }

// cp.async of rows [row0, row0 + rows) of a [row][DH] fp32 array (row
// stride `sn`) into a padded tile; rows >= n are zeros.  row0 < n.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t sn, int row0,
                                          int rows, int n, int tid, int nthreads) {
  for (int c = tid; c < rows * (DH / 4); c += nthreads) {
    const int r = c / (DH / 4), ch = c % (DH / 4), row = row0 + r;
    const bool in = row < n;
    cp_async16(smem_addr(dst + r * LD + 4 * ch), src + (int64_t)(in ? row : row0) * sn + 4 * ch,
               in ? 16 : 0);
  }
}

// s[i][j] = the sum over d = 0, 1, ..., 63 in that order of Q row r0 +
// RS i times K row cl + 8 j, both padded tiles: the one sequence both
// passes run, so pass B's logits are pass A's bit for bit.
template <int RS>
__device__ __forceinline__ void qk(float (&s)[4][8], const float* Q, const float* K, int r0,
                                   int cl) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 kk[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) kk[j] = *reinterpret_cast<const float4*>(K + (cl + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(Q + (r0 + RS * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(a.x, kk[j].x, s[i][j]);
        s[i][j] = fmaf(a.y, kk[j].y, s[i][j]);
        s[i][j] = fmaf(a.z, kk[j].z, s[i][j]);
        s[i][j] = fmaf(a.w, kk[j].w, s[i][j]);
      }
    }
  }
}

// Pass A, a FlashAttention-2 forward: grid (ceil(N / 64), H, B), 128
// threads, 51 KB of shared memory, so that four blocks (16 warps) share an
// SM and hide each other's loads and barriers.  Q is loaded once; each
// 64-key tile of K and V lands by cp.async in its own row-major layout, and
// P goes to the P V product through the K tile's buffer, which S has
// consumed.  Thread (warp w, lane 8 rl + cl) holds query rows r0 + 16 i (r0
// = 4 w + rl, i < 4) against keys cl + 8 j (j < 8) of a tile for S, and the
// same rows of out at dims 4 cl .. 4 cl + 3 and 32 + 4 cl .. 32 + 4 cl + 3;
// a row's 64 keys live in 8 lanes of one warp, so its max and sum close by
// shuffles.
__global__ void __launch_bounds__(A_NT, 4) k1_fwd_simt(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    int64_t sb, int64_t sn, const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ stat_m, float* __restrict__ stat_l,
    float* __restrict__ rnorm, int N, int H, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;             // [A_TQ][LD]
  float* Ks = Qs + A_TQ * LD;  // [TK][LD]: K of the tile, then its P [A_TQ][LD]
  float* Vs = Ks + TK * LD;    // [TK][LD]
  float* kb = Vs + TK * LD;    // [TK]: key bias, -inf where dead or past N

  const int q0 = blockIdx.x * A_TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 4 * warp + lane / 8, cl = lane % 8;
  const int64_t head = (int64_t)b * sb + (int64_t)h * DH, bN = (int64_t)b * N;
  const int ntiles = (N + TK - 1) / TK;

  auto load_kv = [&](int tile) {
    load_rows(Ks, k + head, sn, tile * TK, TK, N, tid, A_NT);
    load_rows(Vs, v + head, sn, tile * TK, TK, N, tid, A_NT);
    cp_async_commit();
    if (tid < TK) {
      const int key = tile * TK + tid;
      kb[tid] = (key < N && alive[bN + key]) ? bias[bN + key] : -INFINITY;
    }
  };
  load_rows(Qs, q + head, sn, q0, A_TQ, N, tid, A_NT);
  load_kv(0);

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) o[i][d] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t and its key bias landed for every thread
    float s[4][8];
    qk<16>(s, Qs, Ks, r0, cl);
    __syncthreads();  // every thread has read the K tile: it takes P now
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kbv = kb[cl + 8 * j];
        s[i][j] = kbv == -INFINITY ? -INFINITY : fmaf(s[i][j], scale, kbv);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      const float alpha = mn == -INFINITY ? 1.f : expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < 8; ++d) o[i][d] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - mn);
        l[i] += p;
        Ks[(r0 + 16 * i) * LD + cl + 8 * j] = p;
      }
    }
    __syncthreads();  // P of the tile is written

#pragma unroll 2
    for (int kq = 0; kq < TK; kq += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ks + (r0 + 16 * i) * LD + kq);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 va = *reinterpret_cast<const float4*>(Vs + (kq + u) * LD + 4 * cl);
        const float4 vb = *reinterpret_cast<const float4*>(Vs + (kq + u) * LD + 32 + 4 * cl);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
          o[i][0] = fmaf(p, va.x, o[i][0]);
          o[i][1] = fmaf(p, va.y, o[i][1]);
          o[i][2] = fmaf(p, va.z, o[i][2]);
          o[i][3] = fmaf(p, va.w, o[i][3]);
          o[i][4] = fmaf(p, vb.x, o[i][4]);
          o[i][5] = fmaf(p, vb.y, o[i][5]);
          o[i][6] = fmaf(p, vb.z, o[i][6]);
          o[i][7] = fmaf(p, vb.w, o[i][7]);
        }
      }
    }
    if (t + 1 < ntiles) {
      __syncthreads();  // P and V of the tile are consumed
      load_kv(t + 1);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + 16 * i;
    float lsum = l[i];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 4);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);  // no alive key: o is 0
    float sq = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      o[i][d] *= inv;
      sq = fmaf(o[i][d], o[i][d], sq);
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    sq += __shfl_xor_sync(0xffffffffu, sq, 4);
    if (row >= N) continue;
    float* dst = out + ((bN + row) * H + h) * DH;
    *reinterpret_cast<float4*>(dst + 4 * cl) = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
    *reinterpret_cast<float4*>(dst + 32 + 4 * cl) =
        make_float4(o[i][4], o[i][5], o[i][6], o[i][7]);
    if (cl == 0) {
      const int64_t s_idx = ((int64_t)b * H + h) * N + row;
      stat_m[s_idx] = m[i] == -INFINITY ? 0.f : m[i];
      stat_l[s_idx] = lsum;
      rnorm[s_idx] = sqrtf(sq);
    }
  }
}

// Pass B: grid (ceil(N / 64), chunks, B), 256 threads, two blocks an SM.
// Only the rows that count are recomputed: row 0 (cls_attn) and the alive
// rows >= 1 (col_mass), in row order, packed into 128-row query tiles (the
// block scans its image's alive row once; mask mode's pruned tokens drop
// out).  The block's chunk walks its (packed query tile, head) stages,
// heads inner, through a 2-stage cp.async ring that holds the Q rows of the
// tile, the K rows of the block's 64 keys for that head and the rows' m
// and l.  (fp32 K rows of every head would take 192 KB at H = 12 and leave
// no room for the ring; streamed beside Q they cost half as many bytes
// again a stage.)  Thread (warp w, lane 8 rl + cl) holds tile rows r0 + 32
// i (r0 = 4 w + rl, i < 4) against keys cl + 8 j (j < 8).  P = exp(x - m)
// times the row's 1/l, from pass A's m and l and the logits x of `qk`, as
// in pass A; the head max stays in registers, and a tile's rows >= 1 add
// it into per-thread column sums after its last head.  Column sums close
// in a fixed order (the 4 row lanes by shuffles, then the 8 warps in
// order); chunk c walks packed tiles [c per, min((c + 1) per, packed
// tiles)), per = ceil(ceil(N / 128) / chunks), and with chunks > 1 writes
// fp32 partials part[c][b][n] (added by `k1_colsum`).  The block of chunk
// 0 forms cls_attn.
__global__ void __launch_bounds__(B_NT, 2) k1_scores_simt(
    const float* __restrict__ q, const float* __restrict__ k, int64_t sb, int64_t sn,
    const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    const float* __restrict__ rnorm, float* __restrict__ col, float* __restrict__ part,
    float* __restrict__ cls, int N, int H, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* rnk = fsm + 2 * B_STAGE;                              // [H][TK]: r_h of the keys
  float* red = rnk + H * TK;                                   // [8][TK]
  int* idx = reinterpret_cast<int*>(red + (B_NT / 32) * TK);   // [2][B_TQ]: tile rows, -1 past
  int* cnt = reinterpret_cast<int*>(red);                      // [B_NT], before `red` is used

  const int k0 = blockIdx.x * TK, chunk = blockIdx.y, chunks = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 4 * warp + lane / 8, cl = lane % 8;
  const int64_t bN = (int64_t)b * N;

  // pack the rows that count: thread t holds rows [s0, s1) and their first
  // place `base` among them
  const int seg = (N + B_NT - 1) / B_NT, s0 = min(N, tid * seg), s1 = min(N, s0 + seg);
  int mine = 0;
  for (int i = s0; i < s1; ++i) mine += (i == 0 || alive[bN + i]) ? 1 : 0;
  cnt[tid] = mine;
  __syncthreads();
  int base = 0, packed = 0;
  for (int j = 0; j < B_NT; ++j) {
    const int c = cnt[j];
    base += j < tid ? c : 0;
    packed += c;
  }
  const int nqt = (N + B_TQ - 1) / B_TQ, per = (nqt + chunks - 1) / chunks;
  const int qt0 = chunk * per, qt1 = min((packed + B_TQ - 1) / B_TQ, qt0 + per);
  const int nst = max(0, qt1 - qt0) * H;  // stages: (packed query tile, head), heads inner
  // the rows of packed tile qt into idx[buf]
  auto pack = [&](int buf, int qt) {
    int* ix = idx + buf * B_TQ;
    const int lo = qt * B_TQ;
    if (tid < B_TQ && lo + tid >= packed) ix[tid] = -1;
    int pos = base;
    for (int i = s0; i < s1 && pos < lo + B_TQ; ++i) {
      if (i != 0 && !alive[bN + i]) continue;
      if (pos >= lo) ix[pos - lo] = i;
      ++pos;
    }
  };

  for (int i = tid; i < H * TK; i += B_NT) {
    const int key = k0 + i % TK;
    rnk[i] = key < N ? rnorm[((int64_t)b * H + i / TK) * N + key] : 0.f;
  }
  // a stage: the Q rows and K rows of one (packed query tile, head) and the
  // rows' m and l (a place past the packed rows gets zeros)
  auto load = [&](int stage, int it) {
    const int* ix = idx + (it / H & 1) * B_TQ;
    const int hh = it % H;
    float* Qs = fsm + stage * B_STAGE;
    float* ml = Qs + B_TQ * LD + TK * LD;
    const int64_t head = (int64_t)b * sb + hh * DH;
    for (int c = tid; c < B_TQ * (DH / 4); c += B_NT) {
      const int r = c / (DH / 4), ch = c % (DH / 4), row = ix[r];
      cp_async16(smem_addr(Qs + r * LD + 4 * ch),
                 q + head + (int64_t)(row >= 0 ? row : 0) * sn + 4 * ch, row >= 0 ? 16 : 0);
    }
    load_rows(Qs + B_TQ * LD, k + head, sn, k0, TK, N, tid, B_NT);
    if (tid < B_TQ) {
      const int row = ix[tid];
      const int64_t s = ((int64_t)b * H + hh) * N + max(row, 0);
      const int bytes = row >= 0 ? 4 : 0;
      cp_async4(smem_addr(ml + tid), stat_m + s, bytes);
      cp_async4(smem_addr(ml + B_TQ + tid), stat_l + s, bytes);
    }
  };
  if (nst > 0) pack(0, qt0);
  __syncthreads();  // every count is read (`red` is reused at the end); the first tile packed
  if (nst > 0) load(0, 0);
  cp_async_commit();

  float kbr[8], mx[4][8], colacc[8], num[8], den[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = k0 + cl + 8 * j;
    kbr[j] = (key < N && alive[bN + key]) ? bias[bN + key] : -INFINITY;
    colacc[j] = num[j] = den[j] = 0.f;
  }

  for (int it = 0; it < nst; ++it) {
    const int st = it & 1, t = it / H, hh = it % H;
    cp_async_wait<0>();
    __syncthreads();  // stage it landed for every thread; stage it - 1 is consumed
    if (hh == 0 && qt0 + t + 1 < qt1) {
      pack((t + 1) & 1, qt0 + t + 1);  // the buffer of tile t - 1, whose loads are issued
      if (H == 1) __syncthreads();     // its first stage is loaded next
    }
    if (it + 1 < nst) load(st ^ 1, it + 1);
    cp_async_commit();
    if (hh == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mx[i][j] = 0.f;
    }
    const float* Qs = fsm + st * B_STAGE;
    const float* ml = Qs + B_TQ * LD + TK * LD;
    const int* ix = idx + (t & 1) * B_TQ;
    float s[4][8];
    qk<32>(s, Qs, Qs + B_TQ * LD, r0, cl);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 32 * i;
      const float rm = ml[r], lv = ml[B_TQ + r];
      const float rinv = lv > 0.f ? 1.f / lv : 0.f;  // no alive key, or no row: P is 0
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p =
            kbr[j] == -INFINITY ? 0.f : expf(fmaf(s[i][j], scale, kbr[j]) - rm) * rinv;
        mx[i][j] = fmaxf(mx[i][j], p);
        if (ix[r] == 0) {  // query row 0
          const float rr = rnk[hh * TK + cl + 8 * j];
          num[j] = fmaf(p, rr, num[j]);
          den[j] += rr;
        }
      }
    }
    if (hh == H - 1) {  // the tile's head max is complete: add its rows >= 1, all alive
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ix[r0 + 32 * i] >= 1) {
#pragma unroll
          for (int j = 0; j < 8; ++j) colacc[j] += mx[i][j];
        }
      }
    }
  }
  cp_async_wait<0>();

  // column sums: over the 4 row lanes, then the 8 warps in order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float x = colacc[j];
    x += __shfl_xor_sync(0xffffffffu, x, 8);
    x += __shfl_xor_sync(0xffffffffu, x, 16);
    if (lane < 8) red[warp * TK + cl + 8 * j] = x;
  }
  __syncthreads();
  if (tid < TK && k0 + tid < N) {
    const int key = k0 + tid;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < B_NT / 32; ++w) acc += red[w * TK + tid];
    if (chunks == 1)
      col[bN + key] = alive[bN + key] ? acc : 0.f;
    else
      part[((int64_t)chunk * gridDim.z + b) * N + key] = acc;
  }
  if (qt0 == 0 && lane < 8 && warp == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + cl + 8 * j;
      if (key < N) cls[bN + key] = num[j] / (den[j] + 1e-8f);
    }
  }
}

cudaError_t launch_fwd(const float* q, const float* k, const float* v, int64_t sb, int64_t sn,
                       const uint8_t* alive, const float* bias, float* out, float* stat_m,
                       float* stat_l, float* rnorm, int B, int N, int H, float scale,
                       cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(k1_fwd_simt, cudaFuncAttributeMaxDynamicSharedMemorySize, A_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  k1_fwd_simt<<<dim3((N + A_TQ - 1) / A_TQ, H, B), A_NT, A_SMEM, stream>>>(
      q, k, v, sb, sn, alive, bias, out, stat_m, stat_l, rnorm, N, H, scale);
  return cudaGetLastError();
}

cudaError_t launch(const float* q, const float* k, const float* v, int64_t sb, int64_t sn,
                   const uint8_t* alive, const float* bias, float* out, float* col, float* cls,
                   float* stat_m, float* stat_l, float* rnorm, float* part, int B, int N, int H,
                   int chunks, float scale, cudaStream_t stream) {
  static bool configured = false;  // pass B's attribute at its largest, once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        k1_scores_simt, cudaFuncAttributeMaxDynamicSharedMemorySize, pass_b_smem(MAX_HEADS));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaError_t err = launch_fwd(q, k, v, sb, sn, alive, bias, out, stat_m, stat_l, rnorm, B, N, H,
                               scale, stream);
  if (err != cudaSuccess) return err;
  k1_scores_simt<<<dim3((N + TK - 1) / TK, chunks, B), B_NT, pass_b_smem(H), stream>>>(
      q, k, sb, sn, alive, bias, stat_m, stat_l, rnorm, col, part, cls, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const int64_t total = (int64_t)B * N;
  k1_colsum<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, alive, col, B, N, chunks);
  return cudaGetLastError();
}

}  // namespace simt

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, int64_t sb, int64_t sn,
                       const void* alive, const void* bias, void* out, void* stat_m,
                       void* stat_l, void* rnorm, int B, int N, int H, float scale,
                       cudaStream_t stream) {
  constexpr int ring_a = A_STAGES * 2 * KT * Op<T>::ROWB;
  const int smem_a = ring_a + (N + KT - 1) / KT * KT * 4;
  static bool configured = false;  // the attribute at its largest, once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        k1_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_a + MAX_N * 4);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int warps = N >= QT ? 4 : (N + ROWS - 1) / ROWS;
  const dim3 grid_a((N + QT - 1) / QT, B * H);
  k1_fwd<T><<<grid_a, 32 * warps, smem_a, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), sb, sn,
      static_cast<const uint8_t*>(alive), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(stat_m), static_cast<float*>(stat_l),
      static_cast<float*>(rnorm), N, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, int64_t sb, int64_t sn,
                   const void* alive, const void* bias, void* out, void* col, void* cls,
                   void* stat_m, void* stat_l, void* rnorm, void* part, int B, int N, int H,
                   int chunks, float scale, cudaStream_t stream) {
  const int smem_b = pass_b_smem<T>(H);
  static bool configured = false;  // pass B's attribute at its largest, once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        k1_scores<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, pass_b_smem<T>(MAX_HEADS));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaError_t err = launch_fwd<T>(q, k, v, sb, sn, alive, bias, out, stat_m, stat_l, rnorm, B,
                                  N, H, scale, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid_b((N + PassB<T>::TK - 1) / PassB<T>::TK, chunks, B);
  k1_scores<T><<<grid_b, B_THREADS, smem_b, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), sb, sn,
      static_cast<const uint8_t*>(alive), static_cast<const float*>(bias),
      static_cast<const float*>(stat_m), static_cast<const float*>(stat_l),
      static_cast<const float*>(rnorm), static_cast<float*>(col), static_cast<float*>(part),
      static_cast<float*>(cls), N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const int64_t total = (int64_t)B * N;
  k1_colsum<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const uint8_t*>(alive),
      static_cast<float*>(col), B, N, chunks);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements and shared by
// q, k and v.  Scratch stat_m, stat_l, rnorm: [B, H, N] fp32.  chunks: pass
// B's query split (madtp_tpu_torch/kernels/attention_scores.py
// `pass_b_chunks`); with chunks > 1, part is an fp32 scratch of chunks B N
// values.  Returns the cudaError_t of the launches (0 on success).
extern "C" int k1_attention_scores(int dtype, const void* q, const void* k, const void* v,
                                   long long sb, long long sn, const void* alive,
                                   const void* bias, void* out, void* col, void* cls,
                                   void* stat_m, void* stat_l, void* rnorm, void* part, int B,
                                   int N, int H, int Dh, int chunks, float scale, void* stream) {
  if (Dh != DH || N < 2 || N > MAX_N || B < 1 || H < 1 || H > MAX_HEADS || chunks < 1 ||
      chunks > (N + BQ - 1) / BQ || (chunks > 1 && part == nullptr) || B > 65535 ||
      (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)simt::launch(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        sb, sn, static_cast<const uint8_t*>(alive), static_cast<const float*>(bias),
        static_cast<float*>(out), static_cast<float*>(col), static_cast<float*>(cls),
        static_cast<float*>(stat_m), static_cast<float*>(stat_l), static_cast<float*>(rnorm),
        static_cast<float*>(part), B, N, H, chunks, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, sb, sn, alive, bias, out, col, cls, stat_m,
                                      stat_l, rnorm, part, B, N, H, chunks, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The planes variant (above `k1_planes`): pass A into out, stat_m, stat_l,
// rnorm ([B, H, N] fp32 scratch), then the rank's head-max plane [B, N-1,
// N-1] and the CLS row's num and den [B, N-1], fp32.  Same inputs and limits
// as `k1_attention_scores`.  Returns the cudaError_t of the launches.
extern "C" int k1_attention_planes(int dtype, const void* q, const void* k, const void* v,
                                   long long sb, long long sn, const void* alive,
                                   const void* bias, void* out, void* plane, void* num,
                                   void* den, void* stat_m, void* stat_l, void* rnorm, int B,
                                   int N, int H, int Dh, float scale, void* stream) {
  if (Dh != DH || N < 2 || N > MAX_N || B < 1 || H < 1 || H > MAX_HEADS || B > 65535 ||
      (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  const float* bi = static_cast<const float*>(bias);
  float *m = static_cast<float*>(stat_m), *l = static_cast<float*>(stat_l),
        *r = static_cast<float*>(rnorm);
  cudaError_t err;
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k);
    err = simt::launch_fwd(qf, kf, static_cast<const float*>(v), sb, sn, al, bi,
                           static_cast<float*>(out), m, l, r, B, N, H, scale, st);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_planes(qf, kf, sb, sn, al, bi, m, l, r, static_cast<float*>(plane),
                              static_cast<float*>(num), static_cast<float*>(den), B, N, H,
                              scale, st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    err = launch_fwd<T>(q, k, v, sb, sn, alive, bias, out, stat_m, stat_l, rnorm, B, N, H, scale,
                        st);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_planes(static_cast<const T*>(q), static_cast<const T*>(k), sb, sn, al, bi,
                              m, l, r, static_cast<float*>(plane), static_cast<float*>(num),
                              static_cast<float*>(den), B, N, H, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
