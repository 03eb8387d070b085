// K4 on Hopper: masked-softmax cross-attention, no scores; bf16 on the
// tensor cores (mma.sync) with P in registers, fp32 on the CUDA cores.
//
// Replaces the TPU kernel madtp_tpu/ops/pallas/cross_attention.py
// `fused_cross_attention` (kernel body `_kernel`).  For every (b, h):
//   out[b, :, h] = softmax(scale * q k^T + bias[b, :]) v,
// with dead keys (alive[b, j] == 0) at weight exactly 0, fp32 logits,
// softmax and accumulation, and the output stored in q's dtype.  A row of a
// batch with no alive key gets zeros, as the plain PyTorch version
// (madtp_tpu_torch/ops/attention.py `cross_attention_plain`) gives; the TPU
// kernel's finite -1e30 mask would give the mean of v there.  In bf16 the
// probabilities are rounded to bf16 before P v, as the TPU kernel
// (`p.astype(v.dtype)`) and the plain version do.
//
// Layout: q is a [B, Nq, H, Dh] view, k and v [B, S, H, Dh] views sharing
// their strides (Dh contiguous, heads next, any token and batch stride), the
// layouts the query, key and value linears write; out is [B, Nq, H, Dh]
// contiguous.  Any Nq >= 1 and S >= 1: the ragged query and key tiles are
// masked here, so the caller pads nothing.  bias may be null (no bias).
//
// Bound on the card.  At the ITM rerank's shape (B = 256 candidates, Nq = 35
// text queries, S = 256 image slots of the gather path, H = 12, Dh = 64,
// bf16) the function reads 201 MB of K and V, 0.06 ms at 3.35 TB/s, and
// needs 4 Nq S Dh flops per (b, h), 7 GFLOP, 0.007 ms of bf16 tensor cores:
// it is bound by the bytes, so the design streams K and V once, at as near
// the copy rate as it can, and keeps everything else on chip.
//
// bf16 (`k4_mma`): a block is one warp per 16 query rows (Nq = 35 or 40: 3
// warps; 22: 2; the BOS step's Nq = 1: 1; at most 4, more rows loop over
// blocks in grid y) of one (b, h) and one chunk of the keys.  K and V stay
// bf16: 16-byte cp.async copies (each (token, head) row is 128 contiguous
// bytes) fill a 2-stage ring of 64-key tiles, XOR-swizzled by 16-byte chunk
// so that ldmatrix reads are free of bank conflicts, and the next tile lands
// while this one computes (33 KB a block, so up to six blocks share an SM's
// shared memory; deeper rings measured slower).  Each warp loads its Q fragments once into
// registers; S = q k^T is mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with
// K fragments by ldmatrix; the online softmax runs on the accumulator
// fragments (bias added, dead keys to -inf and then exactly 0); P is
// rounded to bf16 in registers, where the accumulator layout of two
// 8-key blocks is the A operand of P v, and V fragments come by
// ldmatrix.trans.  P never goes through shared memory.
//
// Split rule: where B H (times the query tiles) gives fewer than 264 blocks,
// two on each of 132 SMs (VQA: 192 (b, h) and up to 1,616 keys), the keys
// are cut into chunks: madtp_tpu_torch/kernels/cross_attention.py
// `split_chunks` picks chunks = min(ceil(1056 / blocks), ceil(S / 256)),
// 1056 = 8 blocks an SM, with chunks of a whole number of 64-key tiles.
// Each chunk's block writes fp32 partials (running max,
// sum, unnormalised out) to a scratch tensor that the wrapper allocates,
// and `k4_combine` merges them in fixed chunk order, so two launches give
// the same bits.  There are no float atomics.
//
// fp32 (`k4_simt`): tensor cores would mean TF32, outside K4's fp32 limit
// of 1e-5, so fp32 multiplies on the CUDA cores: one block per (b, h) holds
// up to 64 queries and streams 64-key tiles of K and V, converted to
// transposed fp32 tiles in shared memory, with an online softmax; Nq > 64
// loops over query tiles inside the block.
//
// What still holds the bf16 path back: a block's ring starts empty (the
// first tile's latency is not hidden; at the retrieval shape a block sees
// only 4 tiles), the copies are issued by the compute warps themselves, and
// the partials of a split go through device memory.  Each kernel's
// shared-memory attribute is set once per process.
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

// ---------------------------------------------------------------- fp32, SIMT

constexpr int TQ = 64;      // query rows per tile
constexpr int TK = 64;      // key columns per tile
constexpr int NT = 256;     // threads: 16 row groups x 16 column groups
constexpr int LD = 68;      // padded leading dim of the transposed tiles
constexpr int ROWS_PER_WARP = 8;  // two row groups of 4 rows each
static_assert(TK == DH, "the K tile buffer is reused for P^T");
static_assert(LD % 4 == 0, "float4 reads need 16-byte aligned rows");

// dst[d * LD + r] = src[(r0 + r) * row_stride + d] in fp32; rows >= n are 0.
__device__ void load_transposed(float* dst, const float* __restrict__ src,
                                int64_t row_stride, int r0, int n) {
  for (int e = threadIdx.x; e < 64 * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    dst[d * LD + r] = (r0 + r < n) ? src[(int64_t)(r0 + r) * row_stride + d] : 0.f;
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

// fp32.  Grid (B, H).
__global__ void __launch_bounds__(NT) k4_simt(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    int64_t qsb, int64_t qsn, int64_t ksb, int64_t ksn, const uint8_t* __restrict__ alive,
    const float* __restrict__ bias, float* __restrict__ out, int Nq, int S, int H,
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
        Vs[e] = (k0 + r < S) ? v[khead + (int64_t)(k0 + r) * ksn + d] : 0.f;
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
          float* dst = out + (((int64_t)b * Nq + row) * H + h) * DH + cg * 4;
#pragma unroll
          for (int d = 0; d < 4; ++d) dst[d] = o[i][d] / denom;
        }
      }
    }
  }
}

cudaError_t launch_simt(const void* q, const void* k, const void* v, int64_t qsb, int64_t qsn,
                        int64_t ksb, int64_t ksn, const void* alive, const void* bias,
                        void* out, int B, int Nq, int S, int H, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = (2 * DH * LD + TK * DH + TK) * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(k4_simt, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  k4_simt<<<dim3(B, H), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qsb, qsn, ksb, ksn, static_cast<const uint8_t*>(alive), static_cast<const float*>(bias),
      static_cast<float*>(out), Nq, S, H, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16, mma.sync

constexpr int KT = 64;                    // keys per tile
constexpr int KSTAGES = 2;                // cp.async ring depth (3 and 4 measured slower)
constexpr int ROWS = 16;                  // query rows per warp (the mma's M)
constexpr int MAX_WARPS = 4;              // query rows per block: 64
constexpr int TILE_BYTES = KT * DH * 2;   // one K or V tile, bf16
constexpr int MMA_SMEM = KSTAGES * (2 * TILE_BYTES + KT * (int)sizeof(float));

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
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// Byte offset of 16-byte chunk `ch` (0..7) of row `r` in a swizzled tile of
// 128-byte rows.
__device__ __forceinline__ int swz(int r, int ch) { return r * 128 + ((ch ^ (r & 7)) << 4); }

// Grid (B H, ceil(Nq / (16 warps)), chunks); blockDim 32 warps.  Chunk z
// covers keys [z chunk_keys, min(S, (z + 1) chunk_keys)).  With one chunk
// (part == null) it writes out; else its fp32 partials at row index
// (z B H + b H + h) Nq + row: part[idx][0..63] the unnormalised out and
// part[R 64 chunks + 2 idx + {0, 1}] the running max and sum (R = B H Nq).
__global__ void __launch_bounds__(32 * MAX_WARPS) k4_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, int64_t qsb, int64_t qsn, int64_t ksb, int64_t ksn,
    const uint8_t* __restrict__ alive, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int B, int Nq, int S, int H,
    int chunk_keys, float scale) {
  extern __shared__ __align__(128) unsigned char ring[];
  unsigned char* Ks = ring;                          // [KSTAGES][KT][DH], swizzled
  unsigned char* Vs = ring + KSTAGES * TILE_BYTES;   // [KSTAGES][KT][DH], swizzled
  float* kb = reinterpret_cast<float*>(Vs + KSTAGES * TILE_BYTES);  // [KSTAGES][KT]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.y * (MAX_WARPS * ROWS) + warp * ROWS;  // this warp's first row
  const bool active = r0 < Nq;                                     // warp-uniform
  const int key0 = blockIdx.z * chunk_keys;
  const int key1 = min(S, key0 + chunk_keys);
  const int ntiles = (key1 - key0 + KT - 1) / KT;
  const __nv_bfloat16* kh = k + (int64_t)b * ksb + h * DH;
  const __nv_bfloat16* vh = v + (int64_t)b * ksb + h * DH;

  auto load_tile = [&](int stage, int tile) {
    const int j0 = key0 + tile * KT;
    for (int c = tid; c < KT * 8; c += nthreads) {
      const int r = c / 8, ch = c % 8, key = j0 + r;
      const bool in = key < key1;
      const int64_t off = (int64_t)(in ? key : j0) * ksn + ch * 8;
      const int dst = stage * TILE_BYTES + swz(r, ch);
      cp_async16(smem_addr(Ks + dst), kh + off, in ? 16 : 0);
      cp_async16(smem_addr(Vs + dst), vh + off, in ? 16 : 0);
    }
  };
  // The key bias of a tile (-inf where dead or past the chunk), KT / 32 keys a
  // lane: read into registers one iteration ahead (`kb_read`), so the loads'
  // latency hides behind a tile's arithmetic, and stored to shared memory
  // at the end of that iteration (`kb_store`).
  constexpr int KB_PER = KT / 32;
  float kb_next[KB_PER];
  auto kb_read = [&](int tile) {
#pragma unroll
    for (int i = 0; i < KB_PER; ++i) {
      const int key = key0 + tile * KT + lane + 32 * i;
      const bool in = tile < ntiles && key < key1;
      const uint8_t a = in ? alive[(int64_t)b * S + key] : 0;
      const float bv = in && bias ? bias[(int64_t)b * S + key] : 0.f;
      kb_next[i] = a ? bv : -INFINITY;
    }
  };
  auto kb_store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < KB_PER; ++i) kb[stage * KT + lane + 32 * i] = kb_next[i];
  };

  // Q fragments of rows r0 + g and r0 + g + 8, loaded once
  uint32_t qa[4][4];
  {
    const __nv_bfloat16* qh = q + (int64_t)b * qsb + h * DH;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + (e & 1) * 8, col = 16 * s + (e >> 1) * 8 + 2 * t;
        qa[s][e] = row < Nq
                       ? *reinterpret_cast<const uint32_t*>(qh + (int64_t)row * qsn + col)
                       : 0u;
      }
  }

  float o[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < KSTAGES - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();  // an empty group keeps the wait counts uniform
    if (warp == 0) {
      kb_read(s);
      kb_store(s);
    }
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<KSTAGES - 2>();
    __syncthreads();  // this tile landed for every thread; the previous one is consumed
    const int pf = tile + KSTAGES - 1;
    if (pf < ntiles) load_tile(pf % KSTAGES, pf);
    cp_async_commit();
    if (warp == 0) kb_read(pf);  // stored at the end of this iteration
    if (active) {
      const int stage = tile % KSTAGES;
      const uint32_t kbase = smem_addr(Ks + stage * TILE_BYTES);
      const uint32_t vbase = smem_addr(Vs + stage * TILE_BYTES);
      const float* kbs = kb + stage * KT;
      const int mat = lane / 8, mrow = lane % 8;

      // S = q k^T: 16 rows x 64 keys, 8 accumulator fragments of 8 keys
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t r[4];  // keys np*16 + {0-7, 0-7, 8-15, 8-15}, dims 16 s + {0-7, 8-15, 0-7, 8-15}
          ldmatrix_x4(r, kbase + swz(np * 16 + (mat >> 1) * 8 + mrow, 2 * s + (mat & 1)));
          mma_bf16(sc[2 * np], qa[s], r[0], r[1]);
          mma_bf16(sc[2 * np + 1], qa[s], r[2], r[3]);
        }

      // online softmax on the fragments: element e of fragment j is (row g + 8 (e >> 1),
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
        alpha[i] = mn == -INFINITY ? 1.f : expf(m[i] - mn);
        m[i] = mn;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          sc[j][e] = sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - m[i]);
          l[i] += sc[j][e];
          o[j][e] *= alpha[i];
        }

      // out += P v: P's fragments of keys 16 ks .. 16 ks + 15 are the A operand
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * ks][0], sc[2 * ks][1]),
                                pack_bf16(sc[2 * ks][2], sc[2 * ks][3]),
                                pack_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1]),
                                pack_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3])};
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t r[4];  // keys 16 ks + {0-7, 8-15, 0-7, 8-15}, dims 16 dp + {0-7, 0-7,
                          // 8-15, 8-15}
          ldmatrix_x4_trans(r, vbase + swz(16 * ks + (mat & 1) * 8 + mrow, 2 * dp + (mat >> 1)));
          mma_bf16(o[2 * dp], pa, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    }
    // stage pf % KSTAGES was consumed in the previous iteration: every warp
    // passed this iteration's barrier after it, and its readers come after
    // the barrier of iteration pf
    if (warp == 0 && pf < ntiles) kb_store(pf % KSTAGES);
  }
  cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int64_t R = (int64_t)B * H * Nq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= Nq) continue;
    if (part == nullptr) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);  // no alive key: o is 0
      __nv_bfloat16* dst = out + (((int64_t)b * Nq + row) * H + h) * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    } else {
      const int64_t idx = ((int64_t)blockIdx.z * B * H + bh) * Nq + row;
      float* dst = part + idx * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[j][2 * i], o[j][2 * i + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(part + R * DH * gridDim.z + 2 * idx) = make_float2(m[i], l[i]);
    }
  }
}

// Merges the chunks' partials of each row in chunk order 0, 1, ...: one warp
// a row of R = B H Nq, two of the 64 columns a lane.
__global__ void __launch_bounds__(256) k4_combine(const float* __restrict__ part,
                                                  __nv_bfloat16* __restrict__ out, int B,
                                                  int Nq, int H, int chunks) {
  const int64_t R = (int64_t)B * H * Nq;
  const int64_t r = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  if (r >= R) return;
  const int lane = threadIdx.x % 32;
  const float* ml = part + R * DH * chunks;
  float mmax = -INFINITY;
  for (int c = 0; c < chunks; ++c) mmax = fmaxf(mmax, ml[2 * (c * R + r)]);
  float L = 0.f, o0 = 0.f, o1 = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float mc = ml[2 * (c * R + r)];
    const float w = mc == -INFINITY ? 0.f : expf(mc - mmax);
    L = fmaf(w, ml[2 * (c * R + r) + 1], L);
    const float2 oc = *reinterpret_cast<const float2*>(part + (c * R + r) * DH + 2 * lane);
    o0 = fmaf(w, oc.x, o0);
    o1 = fmaf(w, oc.y, o1);
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  const int64_t bh = r / Nq, row = r % Nq, b = bh / H, h = bh % H;
  *reinterpret_cast<__nv_bfloat162*>(out + ((b * Nq + row) * H + h) * DH + 2 * lane) =
      __floats2bfloat162_rn(o0 * inv, o1 * inv);
}

cudaError_t launch_mma(const void* q, const void* k, const void* v, int64_t qsb, int64_t qsn,
                       int64_t ksb, int64_t ksn, const void* alive, const void* bias, void* out,
                       void* part, int B, int Nq, int S, int H, int chunks, int chunk_keys,
                       float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(k4_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int warps = Nq >= MAX_WARPS * ROWS ? MAX_WARPS : (Nq + ROWS - 1) / ROWS;
  const dim3 grid(B * H, (Nq + MAX_WARPS * ROWS - 1) / (MAX_WARPS * ROWS), chunks);
  k4_mma<<<grid, 32 * warps, MMA_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qsb, qsn, ksb, ksn,
      static_cast<const uint8_t*>(alive), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), chunks > 1 ? static_cast<float*>(part) : nullptr, B, Nq,
      S, H, chunk_keys, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const int64_t rows = (int64_t)B * H * Nq;
  k4_combine<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), B, Nq, H, chunks);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: (qsb, qsn) of
// q, (ksb, ksn) shared by k and v.  bias may be null.  chunks and
// chunk_keys: the bf16 split of the keys (madtp_tpu_torch/kernels/
// cross_attention.py `split_chunks`; fp32 takes 1 and S); with chunks > 1,
// part is an fp32 scratch of chunks B H Nq (64 + 2) values.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int k4_cross_attention(int dtype, const void* q, const void* k, const void* v,
                                  long long qsb, long long qsn, long long ksb, long long ksn,
                                  const void* alive, const void* bias, void* out, void* part,
                                  int B, int Nq, int S, int H, int Dh, int chunks,
                                  int chunk_keys, float scale, void* stream) {
  if (Dh != DH || B < 1 || Nq < 1 || S < 1 || H < 1 || chunks < 1 || chunk_keys < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (chunks != 1 || H > 65535) return (int)cudaErrorInvalidValue;
    return (int)launch_simt(q, k, v, qsb, qsn, ksb, ksn, alive, bias, out, B, Nq, S, H, scale,
                            st);
  }
  if (dtype != 1 || chunk_keys % KT || (int64_t)(chunks - 1) * chunk_keys >= S ||
      (int64_t)chunks * chunk_keys < S || chunks > 65535 || (chunks > 1 && part == nullptr) ||
      (int64_t)B * H > 0x7fffffff || (Nq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_mma(q, k, v, qsb, qsn, ksb, ksn, alive, bias, out, part, B, Nq, S, H,
                         chunks, chunk_keys, scale, st);
}
