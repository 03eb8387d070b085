// K2 on Hopper: the backward of K1 (attention with the DTP scoring outputs),
// on the tensor cores (mma.sync): bf16 directly, fp32 as 3xTF32.
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
// contiguous, heads next, rows 16-byte aligned), as K1 takes them; out,
// dout, dq, dk, dv are contiguous [B, N, H, Dh].  Any N >= 2: the ragged
// tiles are masked here.
//
// Design.  The TPU kernel keeps two [N, N] fp32 planes (head max and tie
// count) on chip, 1.4 MB each at N = 592; a block here has 227 KB.  Five
// launches on one stream, no float atomics, every sum in a fixed order (two
// runs give the same bits), every product on mma.sync:
//   pass M (`k2_heads`), K1's pass B with the head-max mask: one block per
//     (key tile, image), the K tiles of all heads resident, the Q tiles of
//     every (128-row query tile, head) streamed through a cp.async ring with
//     their rows' m and l; P from the same mma sequence as K1's, the running
//     head max and the 16-bit mask of the heads that reach it kept in the
//     accumulator registers, the mask written per (query, key) in 64-key
//     groups ([B, ceil(N/64), N, 64], so that each (query tile, key tile) of
//     it is one contiguous block); the query tile of row 0 also writes
//     P_h[0, j], S and C.  The query tiles split across blocks as in K1
//     (`chunks`);
//   pass E (`k2_prep`): do_eff in the input dtype (the plain version sums
//     the two cotangents of out in its dtype too) and log2 of each row's l;
//   pass Q (`k2_dq`), one block per (image, head, 64 query rows), one warp
//     per 16 rows: over key tiles (K, V and the mask tile in a cp.async ring),
//     S = q k^T and dP = do_eff v^T on mma.sync, P and W = P dp on the
//     accumulators, then A += W k and B += P k on mma.sync with W and P as
//     the A operands (rounded to bf16 in bf16, as the plain version's bf16
//     matmuls round their operands), the two sharing each k fragment;
//     D = sum_j W, and dq = scale (A - D' B) with D' = sum_j W as rounded
//     for the products, so that one sweep gives dq and a row's rounding
//     cancels as it does in G = P (dp - D); writes dq and D;
//   pass K (`k2_dkv`), one block per (image, head, 64 keys), one warp per 16
//     keys: over query tiles (q, do_eff and the mask tile in the ring),
//     S^T = k q^T and dP^T = v do_eff^T, G^T = P^T (dP^T - D), then
//     dv += P^T do_eff and dk += G^T q on mma.sync, and the per-head dbias
//     as row sums of G^T (the FlashAttention-2 split: dq sums over keys,
//     dk / dv / dbias over queries);
//   a last pass (`k2_dbias`) sums dbias over heads.
// In passes Q and K the block's own 64 rows of its two A operands (q and
// do_eff, or k and v) sit in shared memory beside the ring, the streamed
// tiles hold 64 slots in bf16 and 32 in fp32 (whose rows are twice as wide),
// and the products run 32 slots at a time (fewer live accumulators).  P is
// 2^((x - m) log2(e) - log2(l)) as in K1, m used exactly.
// fp32 multiplies as 3xTF32 (see csrc/attention_scores.cu): a = hi + lo,
// the product hi hi + hi lo + lo hi accumulated in fp32.
//
// Bound on the card: the function's own work is one q k^T recompute and the
// four gradient products, 10 Dh flops per (head, query, alive key): at the
// NLVR train step's ViT shape (B = 32 images, H = 12, N = 592) about 86
// GFLOP, 0.09 ms at the bf16 tensor-core rate, 0.52 ms at the 3xTF32
// ceiling (495 / 3 TFLOP/s) and 1.3 ms at the 67 TFLOP/s fp32 CUDA-core
// rate; it moves q, k, v, dout in and dq, dk, dv out once, 0.06-0.09 ms at
// 3.35 TB/s.  This design does 18 Dh flops per (head, query, key): pass M
// recomputes S for every head, passes Q and K recompute S and dP each, and
// pass Q forms P k beside W k.  Measured on the H100 (PERF.md) it runs at
// 1.9 ms in bf16 and 5.7 ms in fp32 at that shape: the per-element work
// (P, the mask's term of dp, G) is as large as the products in bf16, and
// fp32 runs three mma.sync a product at two blocks an SM.
//
// Launch count: the Python wrapper
// madtp_tpu_torch/kernels/attention_scores_bwd.py (`attention_scores_bwd_cuda`)
// adds one to `attention_scores_bwd_cuda.launches` per successful call of
// `k2_attention_scores_bwd` below, which launches all five passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;          // head dim (ViT-B/L and BERT-base)
constexpr int ROWS = 16;        // rows per warp (the mma's M)
constexpr int QT = 64;          // query rows per tile: 4 warps
constexpr int KT = 64;          // keys per tile, and per group of the mask
constexpr int STAGES = 2;       // passes Q and K: cp.async ring
constexpr int B_THREADS = 256;  // pass M: 8 warps of 16 query rows
constexpr int MAX_HEADS = 16;   // the mask has 16 bits
constexpr int MAX_N = 8192;     // passes Q and K keep four values per slot in shared memory
constexpr int MASK_ROWB = KT * 2;  // bytes of a mask tile row
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
// d += a b, a: m16 x k8 (row), b: k8 x n8 (col), tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// fp32 -> tf32 (10-bit mantissa), round to nearest, ties away from zero.  The
// low 13 bits of cvt's result are unspecified: cleared, it is a float again.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
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
__device__ __forceinline__ float as_float(uint32_t u) { return __uint_as_float(u); }

// ---------------------------------------------------------------- operand policy
//
// Both dtypes keep tiles of 64-wide rows in shared memory, XOR-swizzled by
// 16-byte chunk (chunk c of row r at c ^ (r & 7)), so that ldmatrix and the
// fp32 column reads below are free of bank conflicts.  A k-step covers 16
// (bf16) or 8 (tf32) head dims; in both, chunks 2s and 2s+1 of a row hold
// k-step s, so one ldmatrix.x4 of 8 rows and chunks 4p..4p+3 gives the B
// fragments of k-steps 2p and 2p+1, and one of 16 rows and chunks 2s, 2s+1
// gives the A fragment of k-step s.

template <typename T> struct Op;

template <> struct Op<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int NK = DH / 16;       // k-steps over the head dim
  static constexpr int ROWB = DH * 2;      // bytes of a tile row
  static constexpr bool HOLD = true;       // pass A keeps the Q fragments in registers
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
  // x as the A fragments of pv carry it: rounded to bf16
  __device__ __forceinline__ static float round_a(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  // pv into o and, with P2 = sc2 over the same keys, into o2, each V
  // fragment read once (K2's pass Q: W k and P k)
  template <int NKB>
  __device__ __forceinline__ static void pv2(float (&o)[8][4], const float (&sc)[NKB][4],
                                             float (&o2)[8][4], const float (&sc2)[NKB][4],
                                             const unsigned char* tile, int row0, int lane) {
    const uint32_t base = smem_addr(tile);
    const int mat = lane / 8, mrow = lane % 8;
#pragma unroll
    for (int ks = 0; ks < NKB / 2; ++ks) {
      const A pa = acc_a(sc, ks), pa2 = acc_a(sc2, ks);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t r[4];
        const int row = row0 + 16 * ks + (mat & 1) * 8 + mrow, ch = 2 * dp + (mat >> 1);
        ldmatrix_x4_trans(r, base + row * ROWB + ((ch ^ (row & 7)) << 4));
        mma(o[2 * dp], pa, r[0], r[1]);
        mma(o[2 * dp + 1], pa, r[2], r[3]);
        mma(o2[2 * dp], pa2, r[0], r[1]);
        mma(o2[2 * dp + 1], pa2, r[2], r[3]);
      }
    }
  }
  __device__ __forceinline__ static void store2(T* dst, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  }
};

template <> struct Op<float> {
  using T = float;
  static constexpr int NK = DH / 8;
  static constexpr int ROWB = DH * 4;
  static constexpr bool HOLD = false;  // 64 registers: reread from L1 each tile instead
  struct A { uint32_t hi[4], lo[4]; };
  // 3xTF32: d += a_hi b_lo + a_lo b_hi + a_hi b_hi, the small terms first
  __device__ __forceinline__ static void mma(float (&d)[4], const A& a, uint32_t b0,
                                             uint32_t b1) {
    const uint32_t h0 = to_tf32(as_float(b0)), h1 = to_tf32(as_float(b1));
    const uint32_t l0 = to_tf32(as_float(b0) - as_float(h0));
    const uint32_t l1 = to_tf32(as_float(b1) - as_float(h1));
    mma_tf32(d, a.hi, l0, l1);
    mma_tf32(d, a.lo, h0, h1);
    mma_tf32(d, a.hi, h0, h1);
  }
  __device__ __forceinline__ static A make_a(const uint32_t (&r)[4]) {
    A a;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a.hi[e] = to_tf32(as_float(r[e]));
      a.lo[e] = to_tf32(as_float(r[e]) - as_float(a.hi[e]));
    }
    return a;
  }
  __device__ __forceinline__ static A load_a(const T* base, int64_t stride, int r0, int n,
                                             int s, int g, int t) {
    uint32_t r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e & 1) * 8, col = 8 * s + (e >> 1) * 4 + t;
      r[e] = row < n ? __float_as_uint(base[(int64_t)row * stride + col]) : 0u;
    }
    return make_a(r);
  }
  // k-step ks covers the 8 keys of accumulator block ks; k index t is key
  // 2t and k index t + 4 is key 2t + 1 (the B side reads rows alike).
  template <int NKB>
  __device__ __forceinline__ static A acc_a(const float (&sc)[NKB][4], int ks) {
    const uint32_t r[4] = {__float_as_uint(sc[ks][0]), __float_as_uint(sc[ks][2]),
                           __float_as_uint(sc[ks][1]), __float_as_uint(sc[ks][3])};
    return make_a(r);
  }
  // element (row, col) of a swizzled fp32 tile
  __device__ __forceinline__ static float at(const unsigned char* tile, int row, int col) {
    return *reinterpret_cast<const float*>(tile + row * ROWB + (((col >> 2) ^ (row & 7)) << 4) +
                                           (col & 3) * 4);
  }
  template <int NKB>
  __device__ __forceinline__ static void pv(float (&o)[8][4], const float (&sc)[NKB][4],
                                            const unsigned char* tile, int row0, int lane) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int ks = 0; ks < NKB; ++ks) {
      const A pa = acc_a(sc, ks);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float b0 = at(tile, row0 + 8 * ks + 2 * t, 8 * nb + g);
        const float b1 = at(tile, row0 + 8 * ks + 2 * t + 1, 8 * nb + g);
        mma(o[nb], pa, __float_as_uint(b0), __float_as_uint(b1));
      }
    }
  }
  // x as the A fragments of pv carry it: hi + lo holds it to ~2^-22
  __device__ __forceinline__ static float round_a(float x) { return x; }
  // pv into o and o2 sharing the split of each V fragment
  template <int NKB>
  __device__ __forceinline__ static void pv2(float (&o)[8][4], const float (&sc)[NKB][4],
                                             float (&o2)[8][4], const float (&sc2)[NKB][4],
                                             const unsigned char* tile, int row0, int lane) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int ks = 0; ks < NKB; ++ks) {
      const A pa = acc_a(sc, ks), pa2 = acc_a(sc2, ks);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float b0 = at(tile, row0 + 8 * ks + 2 * t, 8 * nb + g);
        const float b1 = at(tile, row0 + 8 * ks + 2 * t + 1, 8 * nb + g);
        const uint32_t h0 = to_tf32(b0), h1 = to_tf32(b1);
        const uint32_t l0 = to_tf32(b0 - as_float(h0)), l1 = to_tf32(b1 - as_float(h1));
        mma_tf32(o[nb], pa.hi, l0, l1);
        mma_tf32(o[nb], pa.lo, h0, h1);
        mma_tf32(o[nb], pa.hi, h0, h1);
        mma_tf32(o2[nb], pa2.hi, l0, l1);
        mma_tf32(o2[nb], pa2.lo, h0, h1);
        mma_tf32(o2[nb], pa2.hi, h0, h1);
      }
    }
  }
  __device__ __forceinline__ static void store2(T* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
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

// Issues the cp.async copies of chunks ch0 .. ch0 + nch - 1 (8 keys each) of
// rows [r0, r0 + rows) of the head-max mask group at `base` (row stride KT)
// into a swizzled tile of KT-key rows; rows >= n are zero.
__device__ __forceinline__ void load_mask(uint32_t dst, const uint16_t* base, int r0, int rows,
                                          int ch0, int nch, int n, int tid, int nthreads) {
  for (int c = tid; c < rows * nch; c += nthreads) {
    const int r = c / nch, ch = ch0 + c % nch, row = r0 + r;
    const bool in = row < n;
    cp_async16(dst + swz<MASK_ROWB>(r, ch), base + (int64_t)(in ? row : r0) * KT + ch * 8,
               in ? 16 : 0);
  }
}
// The mask bits of (row, key) of a swizzled mask tile.
__device__ __forceinline__ unsigned mask_at(const unsigned char* tile, int row, int key) {
  return *reinterpret_cast<const uint16_t*>(tile + swz<MASK_ROWB>(row, key >> 3) + (key & 7) * 2);
}
// The mask bits of (row, key) and (row, key + 1), key even: one 32-bit read.
__device__ __forceinline__ uint32_t mask_pair(const unsigned char* tile, int row, int key) {
  return *reinterpret_cast<const uint32_t*>(tile + swz<MASK_ROWB>(row, key >> 3) + (key & 7) * 2);
}

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  a = x.x;
  b = x.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __bfloat162float(x.x);
  b = __bfloat162float(x.y);
}

// ---------------------------------------------------------------- pass M

// Pass M's shape, as K1's pass B: keys per block, query rows per stage (8
// warps x 16), the ring's depth.
template <typename T> struct PassM {
  static constexpr int TK = sizeof(T) == 2 ? 64 : 32;
  static constexpr int STAGES = sizeof(T) == 2 ? 4 : 2;
};
constexpr int BQ = 128;  // query rows per pass-M stage

template <typename T>
constexpr int pass_m_smem(int H) {
  return H * PassM<T>::TK * Op<T>::ROWB + PassM<T>::STAGES * (BQ * Op<T>::ROWB + BQ * 8) +
         PassM<T>::TK * 4 * H;
}

// Grid (ceil(N / TK), chunks, B); 256 threads, laid out as K1's pass B.
template <typename T>
__global__ void __launch_bounds__(B_THREADS) k2_heads(
    const T* __restrict__ q, const T* __restrict__ k, int64_t sb, int64_t sn,
    const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    const float* __restrict__ stat_m, const float* __restrict__ stat_l,
    const float* __restrict__ rnorm, uint16_t* __restrict__ ismax, float* __restrict__ clsrow,
    float* __restrict__ ssum, float* __restrict__ csum, int N, int H, float scale) {
  using O = Op<T>;
  constexpr int TK = PassM<T>::TK, NB = TK / 8, S = PassM<T>::STAGES;
  constexpr int KTILE = TK * O::ROWB, QTILE = BQ * O::ROWB;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Kr = smem;                                    // [H][TK rows]
  unsigned char* Qr = Kr + H * KTILE;                          // [S][BQ rows]
  float* ml = reinterpret_cast<float*>(Qr + S * QTILE);        // [S][2][BQ]
  float* rnk = ml + S * 2 * BQ;                                // [H][TK]

  const int k0 = blockIdx.x * TK, chunk = blockIdx.y, chunks = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nqt = (N + BQ - 1) / BQ, per = (nqt + chunks - 1) / chunks;
  const int qt0 = chunk * per, qt1 = min(nqt, qt0 + per);
  const int nst = (qt1 - qt0) * H;
  const int64_t bN = (int64_t)b * N;
  const int ngroups = (N + KT - 1) / KT;

  for (int hh = 0; hh < H; ++hh)
    load_tile<T>(smem_addr(Kr + hh * KTILE), k + (int64_t)b * sb + hh * DH, sn, k0, TK, N, tid,
                 B_THREADS);
  for (int i = tid; i < TK * H; i += B_THREADS) {
    const int j = k0 + i % TK;
    rnk[i] = j < N ? rnorm[((int64_t)b * H + i / TK) * N + j] : 0.f;
  }
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
    cp_async_commit();
  }

  float mx[NB][4], num[NB][2], den[NB][2], kbr[NB][2];
  unsigned bits[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * j + 2 * t + c;
      kbr[j][c] = (key < N && alive[bN + key]) ? bias[bN + key] : -INFINITY;
      num[j][c] = den[j][c] = 0.f;
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
        for (int e = 0; e < 4; ++e) {
          mx[j][e] = 0.f;
          bits[j][e] = 0u;
        }
    }
    if (qt * BQ + warp * ROWS < N) {  // warp-uniform
      const uint32_t qbase = smem_addr(Qr + stage * QTILE);
      float sc[NB][4];
      qk<T, NB>(sc, [&](int s) { return tile_a<T>(qbase, warp * ROWS, s, lane); },
                smem_addr(Kr + hh * KTILE), 0, lane);
      float rm[2], rl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * ROWS + g + 8 * i;
        const float lv = ml[(stage * 2 + 1) * BQ + r];
        rm[i] = ml[stage * 2 * BQ + r];
        rl[i] = lv > 0.f ? log2f(lv) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float x = fmaf(sc[j][e], scale, kbr[j][e & 1]);
          const float p = ex2(fmaf(x - rm[i], LOG2E, -rl[i]));
          // mx starts at 0 and p >= 0: the heads with p >= max(0, max_h p)
          if (p > mx[j][e]) {
            mx[j][e] = p;
            bits[j][e] = 1u << hh;
          } else if (p == mx[j][e]) {
            bits[j][e] |= 1u << hh;
          }
          if (qt == 0 && warp == 0 && g == 0 && e < 2) {  // query row 0
            const int key = 8 * j + 2 * t + e;
            const float r = rnk[hh * TK + key];
            num[j][e] = fmaf(p, r, num[j][e]);
            den[j][e] += r;
            if (k0 + key < N) clsrow[((int64_t)b * H + hh) * N + k0 + key] = p;
          }
        }
      if (hh == H - 1) {  // the tile's mask is complete
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = qt * BQ + warp * ROWS + g + 8 * i;
          if (row >= N) continue;
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const int key = k0 + 8 * j + 2 * t;  // even: two keys a word
            uint16_t* dst = ismax + (((int64_t)b * ngroups + key / KT) * N + row) * KT + key % KT;
            *reinterpret_cast<uint32_t*>(dst) = bits[j][2 * i] | (bits[j][2 * i + 1] << 16);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (qt0 == 0 && warp == 0 && g == 0) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t + c;
        if (key < N) {
          ssum[bN + key] = den[j][c] + 1e-8f;
          csum[bN + key] = num[j][c];
        }
      }
  }
}

// ---------------------------------------------------------------- pass E

// One warp per (b, i, h) row of 64 values, two a lane: do_eff in the input
// dtype, and log2 of the row's sum-exp (0 for a row with no alive key).
template <typename T>
__global__ void __launch_bounds__(256) k2_prep(
    const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ stat_m,
    const float* __restrict__ stat_l, const float* __restrict__ rnorm,
    const float* __restrict__ clsrow, const float* __restrict__ ssum,
    const float* __restrict__ csum, const float* __restrict__ dcls, T* __restrict__ deff,
    float* __restrict__ rowlg, int B, int N, int H) {
  const int64_t r = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;  // (b N + i) H + h
  if (r >= (int64_t)B * N * H) return;
  const int lane = threadIdx.x % 32, h = (int)(r % H);
  const int64_t bi = r / H;
  const int i = (int)(bi % N), b = (int)(bi / N);
  const int64_t s = ((int64_t)b * H + h) * N + i;
  float coef = 0.f;
  if (i >= 1) {
    const float S = ssum[bi], C = csum[bi];
    const float drn = dcls[(int64_t)b * (N - 1) + i - 1] * (clsrow[s] * S - C) / (S * S);
    coef = drn / fmaxf(rnorm[s], 1e-30f);
  }
  float o0, o1, d0, d1;
  load2(out + r * DH + 2 * lane, o0, o1);
  load2(dout + r * DH + 2 * lane, d0, d1);
  Op<T>::store2(deff + r * DH + 2 * lane, fmaf(o0, coef, d0), fmaf(o1, coef, d1));
  if (lane == 0) {
    const float lv = stat_l[s];
    rowlg[s] = lv > 0.f ? log2f(lv) : 0.f;
  }
}

// ---------------------------------------------------------------- passes Q and K

// Passes Q and K stream tiles of ST slots (keys in pass Q, queries in pass K):
// 64 in bf16, 32 in fp32, whose tiles are twice as wide; the block's own 64
// rows of its two A operands stay in shared memory.
template <typename T> struct PassQK {
  static constexpr int ST = sizeof(T) == 2 ? 64 : 32;
  static constexpr int RING = STAGES * (2 * ST * Op<T>::ROWB + QT * MASK_ROWB);
  static constexpr int FIXED = 2 * QT * Op<T>::ROWB;
};
// the ring, the fixed tiles, then four fp32 values for each of N slots
// rounded up to a whole tile
template <typename T>
int pass_qk_smem(int N) {
  return PassQK<T>::RING + PassQK<T>::FIXED + 4 * ((N + KT - 1) / KT * KT) * 4;
}

// dp's column-mass and row-0 terms at (query i, key): qm = query i alive and
// >= 1, dc = the key's col_mass cotangent, r0 = dcls_j r_h[j] / S_j.
__device__ __forceinline__ float dp_extra(bool row0, bool qm, float dc, float r0, unsigned bt,
                                          int h) {
  const float share = (qm && ((bt >> h) & 1u)) ? __fdividef(dc, (float)__popc(bt)) : 0.f;
  return (row0 ? r0 : 0.f) + share;
}

// Pass Q: grid (ceil(N / QT), B H), the tiles of one (image, head) side by
// side for L2; blockDim 32 x min(4, ceil(N / 16)).  One sweep over the key
// tiles accumulates D_i = sum_j W, A = W k and B = P k (W = P dp), and
// dq = scale (A - D' B) = scale sum_j G k, where D' sums W as the products
// take it (rounded to bf16 in bf16), so that a row's terms cancel as they do
// in G (one alive key: dq exactly 0).
template <typename T>
__global__ void __launch_bounds__(128, sizeof(T) == 2 ? 3 : 2) k2_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int64_t sb,
    int64_t sn, const T* __restrict__ deff, const uint8_t* __restrict__ alive,
    const float* __restrict__ bias, const float* __restrict__ stat_m,
    const float* __restrict__ rowlg, const float* __restrict__ rnorm,
    const uint16_t* __restrict__ ismax, const float* __restrict__ ssum,
    const float* __restrict__ dcls, const float* __restrict__ dcol, T* __restrict__ dq,
    float* __restrict__ drow, int N, int H, float scale) {
  using O = Op<T>;
  constexpr int ST = PassQK<T>::ST, TILE = ST * O::ROWB, MTILE = QT * MASK_ROWB;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Ks = smem;                          // [STAGES][ST key rows]
  unsigned char* Vs = Ks + STAGES * TILE;            // [STAGES][ST key rows]
  unsigned char* Ms = Vs + STAGES * TILE;            // [STAGES][QT rows of KT keys]
  unsigned char* Qf = Ms + STAGES * MTILE;           // [QT rows] this block's q
  unsigned char* Ef = Qf + QT * O::ROWB;             // [QT rows] this block's do_eff
  const int ntiles = (N + ST - 1) / ST, NP = (N + KT - 1) / KT * KT;
  float* kbs = reinterpret_cast<float*>(Ef + QT * O::ROWB);  // [NP] bias
  float* dcs = kbs + NP;                                     // [NP] dcol
  float* r0s = dcs + NP;                                     // [NP] dcls_j r_h[j] / S_j

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * QT, r0 = q0 + warp * ROWS;
  const bool active = r0 < N;  // warp-uniform
  const int64_t head = (int64_t)b * sb + (int64_t)h * DH, rs = (int64_t)H * DH;
  const int64_t ehead = (int64_t)b * N * rs + (int64_t)h * DH;
  const int64_t srow = ((int64_t)b * H + h) * N, bN = (int64_t)b * N, bN1 = (int64_t)b * (N - 1);
  const int ngroups = (N + KT - 1) / KT;

  auto load = [&](int stage, int tile) {
    const int j0 = tile * ST;
    load_tile<T>(smem_addr(Ks + stage * TILE), k + head, sn, j0, ST, N, tid, nthreads);
    load_tile<T>(smem_addr(Vs + stage * TILE), v + head, sn, j0, ST, N, tid, nthreads);
    load_mask(smem_addr(Ms + stage * MTILE), ismax + ((int64_t)b * ngroups + j0 / KT) * N * KT,
              q0, QT, (j0 % KT) / 8, ST / 8, N, tid, nthreads);
  };
  load_tile<T>(smem_addr(Qf), q + head, sn, q0, QT, N, tid, nthreads);
  load_tile<T>(smem_addr(Ef), deff + ehead, rs, q0, QT, N, tid, nthreads);
  // per key: bias (-inf where dead or past N), dcol, r0
  for (int j = tid; j < NP; j += nthreads) {
    const bool in = j < N, c = in && j >= 1;
    kbs[j] = (in && alive[bN + j]) ? bias[bN + j] : -INFINITY;
    dcs[j] = c ? dcol[bN1 + j - 1] : 0.f;
    r0s[j] = c ? dcls[bN1 + j - 1] * rnorm[srow + j] / ssum[bN + j] : 0.f;
  }

  // the rows' max (+inf past N: P = 0) and log2 of their sum-exp
  float rm[2], rl[2], D[2] = {0.f, 0.f}, Dr[2] = {0.f, 0.f};
  bool qm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    rm[i] = row < N ? stat_m[srow + row] : INFINITY;
    rl[i] = row < N ? rowlg[srow + row] : 0.f;
    qm[i] = row >= 1 && row < N && alive[bN + row];
  }
  float A[8][4], Bk[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) A[j][e] = Bk[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();  // the fixed tiles ride in the first group
  }

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = it + STAGES - 1;
    if (pf < ntiles) load(pf % STAGES, pf);
    cp_async_commit();
    if (active) {
      const int stage = it % STAGES, j0 = it * ST;
      const unsigned char* mt = Ms + stage * MTILE;
      const uint32_t qf = smem_addr(Qf), ef = smem_addr(Ef);
#pragma unroll
      for (int kh = 0; kh < ST; kh += 32) {  // 32 keys at a time
        float sc[4][4], dp[4][4];
        qk<T, 4>(sc, [&](int s) { return tile_a<T>(qf, warp * ROWS, s, lane); },
                 smem_addr(Ks + stage * TILE), kh, lane);
        qk<T, 4>(dp, [&](int s) { return tile_a<T>(ef, warp * ROWS, s, lane); },
                 smem_addr(Vs + stage * TILE), kh, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, key = j0 + kh + 8 * j + 2 * t + (e & 1);
            const uint32_t pair = mask_pair(mt, warp * ROWS + g + 8 * i, (key & ~1) % KT);
            const float z = fmaf(sc[j][e], scale, kbs[key]);
            const float p = ex2(fmaf(z - rm[i], LOG2E, -rl[i]));
            const float x = dp[j][e] + dp_extra(r0 + g + 8 * i == 0, qm[i], dcs[key], r0s[key],
                                                (e & 1) ? pair >> 16 : pair & 0xffffu, h);
            const float w = p * x;
            D[i] += w;
            Dr[i] += O::round_a(w);
            sc[j][e] = p;
            dp[j][e] = w;
          }
        O::pv2(A, dp, Bk, sc, Ks + stage * TILE, kh, lane);  // A += W k, B += P k
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;  // no barrier follows

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    D[i] += __shfl_xor_sync(0xffffffffu, D[i], 1);
    D[i] += __shfl_xor_sync(0xffffffffu, D[i], 2);
    Dr[i] += __shfl_xor_sync(0xffffffffu, Dr[i], 1);
    Dr[i] += __shfl_xor_sync(0xffffffffu, Dr[i], 2);
    const int row = r0 + g + 8 * i;
    if (row >= N) continue;
    T* dst = dq + ehead + (int64_t)row * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      O::store2(dst + 8 * j, scale * (A[j][2 * i] - Dr[i] * Bk[j][2 * i]),
                scale * (A[j][2 * i + 1] - Dr[i] * Bk[j][2 * i + 1]));
    if (t == 0) drow[srow + row] = D[i];
  }
}

// Pass K: grid (ceil(N / KT), B H); blockDim 32 x min(4, ceil(N / 16)).  A
// warp's accumulators are transposed: rows are its 16 keys, columns queries.
template <typename T>
__global__ void __launch_bounds__(128, sizeof(T) == 2 ? 3 : 2) k2_dkv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, int64_t sb,
    int64_t sn, const T* __restrict__ deff, const uint8_t* __restrict__ alive,
    const float* __restrict__ bias, const float* __restrict__ stat_m,
    const float* __restrict__ rowlg, const float* __restrict__ rnorm,
    const uint16_t* __restrict__ ismax, const float* __restrict__ ssum,
    const float* __restrict__ dcls, const float* __restrict__ dcol,
    const float* __restrict__ drow, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dbias_h, int N, int H, float scale) {
  using O = Op<T>;
  constexpr int ST = PassQK<T>::ST, TILE = ST * O::ROWB, MTILE = QT * MASK_ROWB;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;                          // [STAGES][ST query rows]
  unsigned char* Es = Qs + STAGES * TILE;            // [STAGES][ST query rows] do_eff
  unsigned char* Ms = Es + STAGES * TILE;            // [STAGES][ST rows of KT keys]
  unsigned char* Kf = Ms + STAGES * MTILE;           // [KT rows] this block's k
  unsigned char* Vf = Kf + KT * O::ROWB;             // [KT rows] this block's v
  const int ntiles = (N + ST - 1) / ST, NP = (N + KT - 1) / KT * KT;
  float* rms = reinterpret_cast<float*>(Vf + KT * O::ROWB);  // [NP] m (+inf past N: P = 0)
  float* rls = rms + NP;                                     // [NP] log2(l)
  float* Ds = rls + NP;                                      // [NP] D
  float* qms = Ds + NP;                                      // [NP] col_mass query mask

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * KT, kw = k0 + warp * ROWS;
  const bool active = kw < N;  // warp-uniform
  const int64_t head = (int64_t)b * sb + (int64_t)h * DH, rs = (int64_t)H * DH;
  const int64_t ehead = (int64_t)b * N * rs + (int64_t)h * DH;
  const int64_t srow = ((int64_t)b * H + h) * N, bN = (int64_t)b * N, bN1 = (int64_t)b * (N - 1);
  const uint16_t* mgroup = ismax + ((int64_t)b * NP / KT + blockIdx.x) * N * KT;

  auto load = [&](int stage, int tile) {
    const int i0 = tile * ST;
    load_tile<T>(smem_addr(Qs + stage * TILE), q + head, sn, i0, ST, N, tid, nthreads);
    load_tile<T>(smem_addr(Es + stage * TILE), deff + ehead, rs, i0, ST, N, tid, nthreads);
    load_mask(smem_addr(Ms + stage * MTILE), mgroup, i0, ST, 0, KT / 8, N, tid, nthreads);
  };
  load_tile<T>(smem_addr(Kf), k + head, sn, k0, KT, N, tid, nthreads);
  load_tile<T>(smem_addr(Vf), v + head, sn, k0, KT, N, tid, nthreads);
  for (int i = tid; i < NP; i += nthreads) {
    const bool in = i < N;
    rms[i] = in ? stat_m[srow + i] : INFINITY;
    rls[i] = in ? rowlg[srow + i] : 0.f;
    Ds[i] = in ? drow[srow + i] : 0.f;
    qms[i] = (in && i >= 1 && alive[bN + i]) ? 1.f : 0.f;
  }

  // the warp's keys g and g + 8: bias, dcol, r0
  float kbv[2], dcv[2], r0v[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = kw + g + 8 * i;
    const bool in = j < N;
    kbv[i] = (in && alive[bN + j]) ? bias[bN + j] : -INFINITY;
    dcv[i] = (in && j >= 1) ? dcol[bN1 + j - 1] : 0.f;
    r0v[i] = (in && j >= 1) ? dcls[bN1 + j - 1] * rnorm[srow + j] / ssum[bN + j] : 0.f;
  }
  float dK[8][4], dV[8][4], dbp[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[j][e] = dV[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();  // the fixed tiles ride in the first group
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = tile + STAGES - 1;
    if (pf < ntiles) load(pf % STAGES, pf);
    cp_async_commit();
    if (active) {
      const int stage = tile % STAGES, i0 = tile * ST;
      const unsigned char* mt = Ms + stage * MTILE;
      const uint32_t kf = smem_addr(Kf), vf = smem_addr(Vf);
#pragma unroll
      for (int qh = 0; qh < ST; qh += 32) {  // 32 queries at a time
        float st[4][4], dpt[4][4];
        qk<T, 4>(st, [&](int s) { return tile_a<T>(kf, warp * ROWS, s, lane); },
                 smem_addr(Qs + stage * TILE), qh, lane);
        qk<T, 4>(dpt, [&](int s) { return tile_a<T>(vf, warp * ROWS, s, lane); },
                 smem_addr(Es + stage * TILE), qh, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, c = qh + 8 * j + 2 * t + (e & 1);  // key row g + 8 i, query c
            const float z = fmaf(st[j][e], scale, kbv[i]);
            const float p = ex2(fmaf(z - rms[i0 + c], LOG2E, -rls[i0 + c]));
            const float x = dpt[j][e] + dp_extra(i0 + c == 0, qms[i0 + c] != 0.f, dcv[i], r0v[i],
                                                 mask_at(mt, c, kw - k0 + g + 8 * i), h);
            const float gg = p * (x - Ds[i0 + c]);
            dbp[i] += gg;
            st[j][e] = p;
            dpt[j][e] = gg;
          }
        O::pv(dV, st, Es + stage * TILE, qh, lane);   // dv += P^T do_eff
        O::pv(dK, dpt, Qs + stage * TILE, qh, lane);  // dk += G^T q
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;  // no barrier follows

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 1);
    dbp[i] += __shfl_xor_sync(0xffffffffu, dbp[i], 2);
    const int key = kw + g + 8 * i;
    if (key >= N) continue;
    T* dkd = dk + ehead + (int64_t)key * rs + 2 * t;
    T* dvd = dv + ehead + (int64_t)key * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      O::store2(dkd + 8 * j, scale * dK[j][2 * i], scale * dK[j][2 * i + 1]);
      O::store2(dvd + 8 * j, dV[j][2 * i], dV[j][2 * i + 1]);
    }
    if (t == 0) dbias_h[srow + key] = dbp[i];
  }
}

// dbias[b, j] = sum_h dbias_h[b, h, j], heads in order.
__global__ void __launch_bounds__(256) k2_dbias(const float* __restrict__ dbias_h,
                                                float* __restrict__ dbias, int B, int N, int H) {
  const int64_t idx = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (int64_t)B * N) return;
  const int64_t b = idx / N, j = idx % N;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += dbias_h[(b * H + h) * N + j];
  dbias[idx] = acc;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, int64_t sb, int64_t sn,
                   const void* alive, const void* bias, const void* stat_m, const void* stat_l,
                   const void* rnorm, const void* out, const void* dout, const void* dcls,
                   const void* dcol, void* ismax, void* clsrow, void* ssum, void* csum,
                   void* drow, void* dbias_h, void* deff, void* rowlg, void* dq, void* dk,
                   void* dv, void* dbias, int B, int N, int H, int chunks, float scale,
                   cudaStream_t stream) {
  const int smem_qk = pass_qk_smem<T>(N);
  static bool configured = false;  // the attributes at their largest, once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        k2_heads<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, pass_m_smem<T>(MAX_HEADS));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(k2_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pass_qk_smem<T>(MAX_N));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(k2_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pass_qk_smem<T>(MAX_N));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* ep = static_cast<const T*>(deff);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  const float* bi = static_cast<const float*>(bias);
  const float* rn = static_cast<const float*>(rnorm);
  const float* sm = static_cast<const float*>(stat_m);
  const float* rg = static_cast<const float*>(rowlg);
  const uint16_t* im = static_cast<const uint16_t*>(ismax);
  const float* ss = static_cast<const float*>(ssum);
  const float* dc = static_cast<const float*>(dcls);
  const float* dl = static_cast<const float*>(dcol);

  k2_heads<T><<<dim3((N + PassM<T>::TK - 1) / PassM<T>::TK, chunks, B), B_THREADS,
                pass_m_smem<T>(H), stream>>>(
      qp, kp, sb, sn, al, bi, static_cast<const float*>(stat_m),
      static_cast<const float*>(stat_l), rn, static_cast<uint16_t*>(ismax),
      static_cast<float*>(clsrow), static_cast<float*>(ssum), static_cast<float*>(csum), N, H,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t rows = (int64_t)B * N * H;
  k2_prep<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<const float*>(stat_m),
      static_cast<const float*>(stat_l), rn, static_cast<const float*>(clsrow), ss,
      static_cast<const float*>(csum), dc, static_cast<T*>(deff), static_cast<float*>(rowlg), B,
      N, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = N >= QT ? 4 : (N + ROWS - 1) / ROWS;
  const dim3 grid((N + QT - 1) / QT, B * H);
  k2_dq<T><<<grid, 32 * warps, smem_qk, stream>>>(qp, kp, vp, sb, sn, ep, al, bi, sm, rg, rn, im,
                                                  ss, dc, dl, static_cast<T*>(dq),
                                                  static_cast<float*>(drow), N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2_dkv<T><<<grid, 32 * warps, smem_qk, stream>>>(
      qp, kp, vp, sb, sn, ep, al, bi, sm, rg, rn, im, ss, dc, dl, static_cast<const float*>(drow),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dbias_h), N, H, scale);
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
// dcol: [B, N-1] fp32.  Scratch: ismax [B, ceil(N/64), N, 64] 16-bit;
// clsrow, drow, dbias_h, rowlg [B, H, N] fp32; ssum, csum [B, N] fp32;
// deff [B, N, H, Dh] in the input dtype.  chunks: pass M's query split
// (madtp_tpu_torch/kernels/attention_scores_bwd.py `pass_m_chunks`).  Outputs
// dq, dk, dv [B, N, H, Dh] in the input dtype, dbias [B, N] fp32.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int k2_attention_scores_bwd(
    int dtype, const void* q, const void* k, const void* v, long long sb, long long sn,
    const void* alive, const void* bias, const void* stat_m, const void* stat_l,
    const void* rnorm, const void* out, const void* dout, const void* dcls, const void* dcol,
    void* ismax, void* clsrow, void* ssum, void* csum, void* drow, void* dbias_h, void* deff,
    void* rowlg, void* dq, void* dk, void* dv, void* dbias, int B, int N, int H, int Dh,
    int chunks, float scale, void* stream) {
  if (Dh != DH || N < 2 || N > MAX_N || B < 1 || H < 1 || H > MAX_HEADS || chunks < 1 ||
      chunks > (N + BQ - 1) / BQ || B > 65535 || (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, sb, sn, alive, bias, stat_m, stat_l, rnorm, out, dout,
                              dcls, dcol, ismax, clsrow, ssum, csum, drow, dbias_h, deff, rowlg,
                              dq, dk, dv, dbias, B, N, H, chunks, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, sb, sn, alive, bias, stat_m, stat_l, rnorm, out,
                                      dout, dcls, dcol, ismax, clsrow, ssum, csum, drow, dbias_h,
                                      deff, rowlg, dq, dk, dv, dbias, B, N, H, chunks, scale, st);
  return (int)cudaErrorInvalidValue;
}
