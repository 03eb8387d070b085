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
// bf16 split rule: where B H (times the query tiles) gives fewer than 264 blocks,
// two on each of 132 SMs (VQA: 192 (b, h) and up to 1,616 keys), the keys
// are cut into chunks: madtp_tpu_torch/kernels/cross_attention.py
// `split_chunks` picks chunks = min(ceil(1056 / blocks), ceil(S / 256)),
// 1056 = 8 blocks an SM, with chunks of a whole number of 64-key tiles.
// Each chunk's block writes fp32 partials (running max,
// sum, unnormalised out) to a scratch tensor that the wrapper allocates,
// and `k4_combine` merges them in fixed chunk order, so two launches give
// the same bits.  There are no float atomics.
//
// fp32 (`k4_ffma`, `k4_ffma_decode`): tensor cores would mean TF32, outside
// K4's fp32 limit of 1e-5, so fp32 multiplies on the CUDA cores (FFMA).  At
// the NLVR train step's shape (B = 16, Nq = 40, S = 592, fp32) the function
// does 1.16 GFLOP (0.017 ms at 67 TFLOP/s) and moves 58 MB of K and V
// (0.017 ms at 3.35 TB/s) where every key is alive: neither limit binds
// first, filling the card and hiding the loads do.  Both plans share one
// ring (`KeyRing`): a block (one (b, h) and one chunk of the keys, the
// chunk's rule a function of the shape alone, `split_chunks`) first lists
// its chunk's alive keys in shared memory, then gathers only their K and V
// rows (256 contiguous bytes a (token, head)) into a 2-stage ring of 64-key
// tiles by 16-byte cp.async, rows padded to 68 floats so that float4 reads
// of 8 to 32 different rows hit distinct banks; the next tile lands while
// this one computes.  A dead key costs neither bytes nor arithmetic, which
// in mask mode (pruned slots dead, not removed) is a large share.  The row
// plan (`k4_ffma`, Nq > 4) gives each 8 query rows two warps, one per half
// of a tile's keys, each with its own online softmax, merged at the end:
// lanes over (2 rows, 4 keys) for q k^T with q from shared memory, P through
// a warp-private buffer, lanes over (2 rows, 8 dims) for P v; a block holds
// up to 40 rows (Nq = 40: 10 warps, none idle; 22: 6).  The decode plan
// (`k4_ffma_decode`, Nq <= 4, the beam decode's one query a row) gives each
// lane a key for q k^T and two of the 64 dims for P v, P shuffled from its
// lane and never stored; two warps per block, merged in order.  Where B H
// gives less than a block an SM the keys split into chunks (fp32 partials,
// `k4_combine`, as bf16), and a chunk holds at most 1,024 keys (the list's
// room in shared memory); measured, one chunk beats any split above that.
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

// out[0..1] = (a, b) in T: fp32 as it is, bf16 rounded to nearest.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Merges the chunks' partials of each row in chunk order 0, 1, ...: one warp
// a row of R = B H Nq, two of the 64 columns a lane.  Both dtypes' split
// kernels write the same fp32 partials; out is in q's dtype.
template <typename T>
__global__ void __launch_bounds__(256) k4_combine(const float* __restrict__ part,
                                                  T* __restrict__ out, int B, int Nq, int H,
                                                  int chunks) {
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
  store_pair(out + ((b * Nq + row) * H + h) * DH + 2 * lane, o0 * inv, o1 * inv);
}

template <typename T>
cudaError_t launch_combine(const void* part, void* out, int B, int Nq, int H, int chunks,
                           cudaStream_t stream) {
  const int64_t rows = (int64_t)B * H * Nq;
  k4_combine<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), B, Nq, H, chunks);
  return cudaGetLastError();
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
  return launch_combine<__nv_bfloat16>(part, out, B, Nq, H, chunks, stream);
}

// ---------------------------------------------------------------- fp32, CUDA cores

constexpr int FKT = 64;                             // keys per tile
constexpr int FLD = DH + 4;                         // padded K, V and q rows in shared memory
constexpr int FSTAGES = 2;                          // cp.async ring depth
constexpr int FTILE = FKT * FLD;                    // floats of one K or V tile
constexpr int FMAX_CHUNK = 32 * 32;                 // keys of an fp32 chunk: 32 ballots
// floats of the ring: K and V tiles, their key bias, then the chunk's alive
// keys (32 ballots, their offsets and count, 16-bit key offsets)
constexpr int FRING = FSTAGES * (2 * FTILE + FKT) + 32 + 32 + 4 + FMAX_CHUNK / 2;
constexpr int ROWS_W = 8;                           // query rows per warp: four groups of 2
constexpr int FMAX_RW = 5;                          // query rows per block: 40
constexpr int DEC_WARPS = 2;                        // the decode plan: a warp per 32 keys
constexpr int DEC_ROWS = 4;                         // the decode plan takes Nq <= 4
static_assert(FKT == KT && FKT == 32 * DEC_WARPS, "one key tile for both dtypes and plans");
static_assert(FLD % 4 == 0 && FRING % 4 == 0, "16-byte aligned rows and regions");
constexpr int ffma_smem(int rw) {  // rw warps of rows, each in two halves of the keys
  return (FRING + rw * ROWS_W * (FLD + FKT)) * (int)sizeof(float);
}
constexpr int DEC_SMEM =
    (FRING + DEC_ROWS * DH + DEC_WARPS * DEC_ROWS * (DH + 2)) * (int)sizeof(float);

// The alive keys of one block's chunk, streamed through shared memory.  First
// the block lists them in ascending order (`compact`: a ballot per 32 keys,
// their counts' prefix sum, each alive key's place); then 64-key tiles of
// their K and V rows, gathered by 16-byte cp.async into a ring of FSTAGES
// stages (the last tile's rows past the list read as zeros), and each tile's
// key bias (-inf past the list), which warp 0 reads into registers a tile
// ahead and stores after that tile's arithmetic, so that its loads' latency
// hides too.  Dead keys cost neither bytes nor arithmetic, and a chunk with
// no alive key no tile.
struct KeyRing {
  float* K;   // [FSTAGES][FKT][FLD]
  float* V;   // [FSTAGES][FKT][FLD]
  float* kb;  // [FSTAGES][FKT]
  uint32_t* ballots;  // [32]: the chunk's alive flags, 32 keys a word
  int* offsets;       // [32]: alive keys before each word
  int* count;         // [1]: the chunk's alive keys
  uint16_t* keys;     // [FMAX_CHUNK]: the alive keys' offsets from key0
  const float* kh;
  const float* vh;
  int64_t ksn;
  const uint8_t* alive;  // this batch row's
  const float* bias;     // this batch row's, or null
  int key0, key1, n, ntiles;
  float kb_next[FKT / 32];

  __device__ __forceinline__ void init(float* smem, const float* k, const float* v,
                                       int64_t ksb, int64_t ksn_, const uint8_t* alive_,
                                       const float* bias_, int b, int h, int S, int chunk_keys) {
    K = smem;
    V = K + FSTAGES * FTILE;
    kb = V + FSTAGES * FTILE;
    ballots = reinterpret_cast<uint32_t*>(kb + FSTAGES * FKT);
    offsets = reinterpret_cast<int*>(ballots + 32);
    count = offsets + 32;
    keys = reinterpret_cast<uint16_t*>(count + 4);
    kh = k + (int64_t)b * ksb + h * DH;
    vh = v + (int64_t)b * ksb + h * DH;
    ksn = ksn_;
    alive = alive_ + (int64_t)b * S;
    bias = bias_ ? bias_ + (int64_t)b * S : nullptr;
    key0 = blockIdx.z * chunk_keys;
    key1 = min(S, key0 + chunk_keys);
  }
  // Every thread of the block; ends with a barrier.
  __device__ __forceinline__ void compact(int tid, int nthreads) {
    const int warp = tid / 32, lane = tid % 32, warps = nthreads / 32;
    const int words = (key1 - key0 + 31) / 32;
    for (int w = warp; w < words; w += warps) {
      const int key = key0 + 32 * w + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu, key < key1 && alive[key]);
      if (lane == 0) ballots[w] = bits;
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix sum of the words' counts
      const int c = lane < words ? __popc(ballots[lane]) : 0;
      int x = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (lane < words) offsets[lane] = x - c;
      if (lane == 31) *count = x;
    }
    __syncthreads();
    for (int w = warp; w < words; w += warps) {
      const uint32_t bits = ballots[w];
      if ((bits >> lane) & 1u)
        keys[offsets[w] + __popc(bits & ((1u << lane) - 1u))] = (uint16_t)(32 * w + lane);
    }
    n = *count;
    ntiles = (n + FKT - 1) / FKT;
    __syncthreads();
  }
  __device__ __forceinline__ void load(int stage, int tile, int tid, int nthreads) {
    for (int c = tid; c < FKT * (DH / 4); c += nthreads) {
      const int r = c / (DH / 4), ch = c % (DH / 4), t = tile * FKT + r;
      const bool in = t < n;
      const int64_t off = (int64_t)(key0 + (in ? keys[t] : 0)) * ksn + ch * 4;
      const int dst = stage * FTILE + r * FLD + ch * 4;
      cp_async16(smem_addr(K + dst), kh + off, in ? 16 : 0);
      cp_async16(smem_addr(V + dst), vh + off, in ? 16 : 0);
    }
  }
  __device__ __forceinline__ void kb_read(int tile, int lane) {
#pragma unroll
    for (int i = 0; i < FKT / 32; ++i) {
      const int t = tile * FKT + lane + 32 * i;
      const bool in = tile < ntiles && t < n;
      kb_next[i] = !in ? -INFINITY : bias ? bias[key0 + keys[t]] : 0.f;
    }
  }
  __device__ __forceinline__ void kb_store(int stage, int lane) {
#pragma unroll
    for (int i = 0; i < FKT / 32; ++i) kb[stage * FKT + lane + 32 * i] = kb_next[i];
  }

  // Calls tile_fn(K tile, V tile, key bias) on each tile of the list in
  // order, every thread of the block; the next tile lands meanwhile.
  template <class F>
  __device__ __forceinline__ void run(int tid, int nthreads, F&& tile_fn) {
    compact(tid, nthreads);
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int s = 0; s < FSTAGES - 1; ++s) {
      if (s < ntiles) load(s, s, tid, nthreads);
      cp_async_commit();  // an empty group keeps the wait counts uniform
      if (warp == 0) {
        kb_read(s, lane);
        kb_store(s, lane);
      }
    }
    for (int tile = 0; tile < ntiles; ++tile) {
      cp_async_wait<FSTAGES - 2>();
      __syncthreads();  // this tile landed for every thread; the previous one is consumed
      const int pf = tile + FSTAGES - 1;
      if (pf < ntiles) load(pf % FSTAGES, pf, tid, nthreads);
      cp_async_commit();
      if (warp == 0) kb_read(pf, lane);
      const int stage = tile % FSTAGES;
      tile_fn(K + stage * FTILE, V + stage * FTILE, kb + stage * FKT);
      // stage pf % FSTAGES was consumed in the previous iteration, before
      // this iteration's barrier; its readers come after the barrier of
      // iteration pf
      if (warp == 0 && pf < ntiles) kb_store(pf % FSTAGES, lane);
    }
    cp_async_wait<0>();
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
// Over the 8 lanes of one row group.  Every lane of the warp takes part:
// callers branch only on warp-uniform conditions.
__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The row plan.  Grid (B H, query blocks, chunks); blockDim 64 ceil(block_rows
// / 8).  Block y holds query rows [y block_rows, min(Nq, (y + 1) block_rows)).
// Warp w = half RW + rw (RW = blockDim / 64) takes rows 8 rw .. 8 rw + 7 of
// those and keys 32 half .. 32 half + 31 of every tile, with its own online
// softmax; lane = 8 rg + cg holds rows 2 rg, 2 rg + 1 of its warp's, keys cg
// + 8 j (j < 4) of its half for q k^T and dims 4 cg + {0..3, 32..35} for P v.
// At the end the warps of half 1 hand their (max, sum, out) to those of half
// 0 through shared memory, merged in that order.  Chunk z covers keys [z
// chunk_keys, min(S, (z + 1) chunk_keys)); with one chunk (part == null) the
// block writes out, else fp32 partials as k4_mma does.
__global__ void __launch_bounds__(64 * FMAX_RW, 2) k4_ffma(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    int64_t qsb, int64_t qsn, int64_t ksb, int64_t ksn, const uint8_t* __restrict__ alive,
    const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ part, int B,
    int Nq, int S, int H, int block_rows, int chunk_keys, float scale) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int MW = DH + 4;  // a row's merge record, 16-byte aligned: out, then max and sum
  const int tid = threadIdx.x, nthreads = blockDim.x, RW = nthreads / 64;
  const int warp = tid / 32, lane = tid % 32, rw = warp % RW, half = warp / RW;
  const int rg = lane / 8, cg = lane % 8;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  KeyRing ring;
  ring.init(fsm, k, v, ksb, ksn, alive, bias, b, h, S, chunk_keys);
  float* Qs = fsm + FRING;                                      // [RW 8][FLD]
  float* Pw = Qs + RW * ROWS_W * FLD + warp * (FKT / 2) * ROWS_W;  // [32][8]: this warp's P
  const int row0 = blockIdx.y * block_rows;
  const int nrows = min(block_rows, Nq - row0);
  const int r0 = rw * ROWS_W + rg * 2;  // this lane's first row in the block
  const bool active = rw * ROWS_W < nrows;  // warp-uniform
  {
    const float* qh = q + (int64_t)b * qsb + (int64_t)h * DH;
    for (int e = tid; e < RW * ROWS_W * DH; e += nthreads) {
      const int r = e / DH, d = e % DH;
      Qs[r * FLD + d] = r < nrows ? qh[(int64_t)(row0 + r) * qsn + d] : 0.f;
    }  // read after the ring's first barrier
  }
  const float* Qr = Qs + r0 * FLD;
  const int kofs = half * (FKT / 2) + cg;  // this lane's first key of a tile

  float m[2], l[2], o[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) o[i][d] = 0.f;
  }

  ring.run(tid, nthreads, [&](const float* Kt, const float* Vt, const float* kbs) {
    if (!active) return;
    // s = q k^T over this lane's 2 rows x 4 keys, 4 dims a step: float4 reads,
    // q's broadcast over a row group's lanes and K's over 8 rows that the
    // padding puts in distinct banks
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 qv[2], kv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) qv[i] = *reinterpret_cast<const float4*>(Qr + i * FLD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Kt + (kofs + 8 * j) * FLD + d);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    // online softmax; l is a per-lane partial, summed over the row group at the end
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kbj = kbs[kofs + 8 * j];
        s[i][j] = kbj == -INFINITY ? -INFINITY : fmaf(s[i][j], scale, kbj);
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float mn = fmaxf(m[i], group8_max(tmax));
      const float alpha = mn == -INFINITY ? 1.f : expf(m[i] - mn);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - mn);
        psum += s[i][j];
      }
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int d = 0; d < 8; ++d) o[i][d] *= alpha;
      m[i] = mn;
    }
    // P to the warp's own [key][row] buffer: the lanes of a row group hold
    // different keys, and P v wants every key of the lane's rows
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(Pw + (cg + 8 * j) * ROWS_W + rg * 2) =
          make_float2(s[0][j], s[1][j]);
    __syncwarp();  // rewritten only after the ring's next barrier
    const float* Vh = Vt + half * (FKT / 2) * FLD + cg * 4;
#pragma unroll 8
    for (int key = 0; key < FKT / 2; ++key) {
      const float2 p = *reinterpret_cast<const float2*>(Pw + key * ROWS_W + rg * 2);
      const float4 w0 = *reinterpret_cast<const float4*>(Vh + key * FLD);
      const float4 w1 = *reinterpret_cast<const float4*>(Vh + key * FLD + 32);
      const float pv[2] = {p.x, p.y};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int d = 0; d < 8; ++d) o[i][d] = fmaf(pv[i], wv[d], o[i][d]);
    }
  });

  // half 1 hands its rows to half 0 through the ring's memory, now free
  float* Mg = fsm;  // [RW 8][MW]
  __syncthreads();
  if (active && half == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lsum = group8_sum(l[i]);
      float* rec = Mg + (r0 + i) * MW;
      *reinterpret_cast<float4*>(rec + cg * 4) = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      *reinterpret_cast<float4*>(rec + 32 + cg * 4) =
          make_float4(o[i][4], o[i][5], o[i][6], o[i][7]);
      if (cg == 0) *reinterpret_cast<float2*>(rec + DH) = make_float2(m[i], lsum);
    }
  }
  __syncthreads();
  if (!active || half == 1) return;

  const int64_t R = (int64_t)B * H * Nq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* rec = Mg + (r0 + i) * MW;
    const float2 ml = *reinterpret_cast<const float2*>(rec + DH);
    const float M = fmaxf(m[i], ml.x);
    const float w0 = m[i] == -INFINITY ? 0.f : expf(m[i] - M);
    const float w1 = ml.x == -INFINITY ? 0.f : expf(ml.x - M);
    const float L = fmaf(w1, ml.y, w0 * group8_sum(l[i]));
    const float4 a = *reinterpret_cast<const float4*>(rec + cg * 4);
    const float4 c = *reinterpret_cast<const float4*>(rec + 32 + cg * 4);
    const float oh[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
    float om[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) om[d] = fmaf(w1, oh[d], w0 * o[i][d]);
    if (r0 + i >= nrows) continue;
    const int row = row0 + r0 + i;
    float* dst;
    if (part == nullptr) {
      const float inv = 1.f / fmaxf(L, 1e-30f);  // no alive key: o is 0
#pragma unroll
      for (int d = 0; d < 8; ++d) om[d] *= inv;
      dst = out + (((int64_t)b * Nq + row) * H + h) * DH;
    } else {
      const int64_t idx = ((int64_t)blockIdx.z * B * H + bh) * Nq + row;
      dst = part + idx * DH;
      if (cg == 0)
        *reinterpret_cast<float2*>(part + R * DH * gridDim.z + 2 * idx) = make_float2(M, L);
    }
    *reinterpret_cast<float4*>(dst + cg * 4) = make_float4(om[0], om[1], om[2], om[3]);
    *reinterpret_cast<float4*>(dst + 32 + cg * 4) = make_float4(om[4], om[5], om[6], om[7]);
  }
}

// The decode plan, Nq <= NR <= 4.  Grid (B H, 1, chunks); DEC_WARPS warps,
// warp w taking keys 32 w .. 32 w + 31 of every tile with its own online
// softmax: a lane a key for q k^T (q broadcast from shared memory), then a
// lane two of the 64 dims for P v, each key's P from its lane by a shuffle.
// The warps' (max, sum, out) are merged in warp order at the end.
template <int NR>
__global__ void __launch_bounds__(32 * DEC_WARPS) k4_ffma_decode(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    int64_t qsb, int64_t qsn, int64_t ksb, int64_t ksn, const uint8_t* __restrict__ alive,
    const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ part, int B,
    int Nq, int S, int H, int chunk_keys, float scale) {
  extern __shared__ __align__(16) float dsm[];
  constexpr int MW = DH + 2;  // a row's merge record: out, then max and sum
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  KeyRing ring;
  ring.init(dsm, k, v, ksb, ksn, alive, bias, b, h, S, chunk_keys);
  float* Qs = dsm + FRING;          // [DEC_ROWS][DH]
  float* Ms = Qs + DEC_ROWS * DH;   // [DEC_WARPS][DEC_ROWS][MW]
  {
    const float* qh = q + (int64_t)b * qsb + (int64_t)h * DH;
    for (int e = tid; e < NR * DH; e += 32 * DEC_WARPS) {
      const int r = e / DH, d = e % DH;
      Qs[e] = r < Nq ? qh[(int64_t)r * qsn + d] : 0.f;
    }
  }
  const int key = warp * 32 + lane;  // this lane's key of each tile

  float m[NR], l[NR], o[NR][2];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = -INFINITY;
    l[r] = o[r][0] = o[r][1] = 0.f;
  }

  ring.run(tid, 32 * DEC_WARPS, [&](const float* Kt, const float* Vt, const float* kbs) {
    float s[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) s[r] = 0.f;
    const float* kr = Kt + key * FLD;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + r * DH + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    const float kbv = kbs[key];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      s[r] = kbv == -INFINITY ? -INFINITY : fmaf(s[r], scale, kbv);
      const float mn = fmaxf(m[r], warp_max(s[r]));
      const float alpha = mn == -INFINITY ? 1.f : expf(m[r] - mn);
      s[r] = s[r] == -INFINITY ? 0.f : expf(s[r] - mn);
      l[r] = l[r] * alpha + s[r];
      o[r][0] *= alpha;
      o[r][1] *= alpha;
      m[r] = mn;
    }
    const float* vw = Vt + warp * 32 * FLD + 2 * lane;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const float2 w = *reinterpret_cast<const float2*>(vw + j * FLD);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float p = __shfl_sync(0xffffffffu, s[r], j);
        o[r][0] = fmaf(p, w.x, o[r][0]);
        o[r][1] = fmaf(p, w.y, o[r][1]);
      }
    }
  });

#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float lw = warp_sum(l[r]);
    float* rec = Ms + (warp * DEC_ROWS + r) * MW;
    *reinterpret_cast<float2*>(rec + 2 * lane) = make_float2(o[r][0], o[r][1]);
    if (lane == 0) {
      rec[DH] = m[r];
      rec[DH + 1] = lw;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  const int64_t R = (int64_t)B * H * Nq;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r >= Nq) break;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, Ms[(w * DEC_ROWS + r) * MW + DH]);
    float L = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float* rec = Ms + (w * DEC_ROWS + r) * MW;
      const float wt = rec[DH] == -INFINITY ? 0.f : expf(rec[DH] - M);
      const float2 ow = *reinterpret_cast<const float2*>(rec + 2 * lane);
      L = fmaf(wt, rec[DH + 1], L);
      o0 = fmaf(wt, ow.x, o0);
      o1 = fmaf(wt, ow.y, o1);
    }
    if (part == nullptr) {
      const float inv = 1.f / fmaxf(L, 1e-30f);  // no alive key: o is 0
      *reinterpret_cast<float2*>(out + (((int64_t)b * Nq + r) * H + h) * DH + 2 * lane) =
          make_float2(o0 * inv, o1 * inv);
    } else {
      const int64_t idx = ((int64_t)blockIdx.z * B * H + bh) * Nq + r;
      *reinterpret_cast<float2*>(part + idx * DH + 2 * lane) = make_float2(o0, o1);
      if (lane == 0)
        *reinterpret_cast<float2*>(part + R * DH * gridDim.z + 2 * idx) = make_float2(M, L);
    }
  }
}

template <class F>
cudaError_t allow_smem(F kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t launch_ffma(const void* q, const void* k, const void* v, int64_t qsb, int64_t qsn,
                        int64_t ksb, int64_t ksn, const void* alive, const void* bias,
                        void* out, void* part, int B, int Nq, int S, int H, int chunks,
                        int chunk_keys, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(k4_ffma, ffma_smem(FMAX_RW));
    if (err == cudaSuccess) err = allow_smem(k4_ffma_decode<1>, DEC_SMEM);
    if (err == cudaSuccess) err = allow_smem(k4_ffma_decode<2>, DEC_SMEM);
    if (err == cudaSuccess) err = allow_smem(k4_ffma_decode<4>, DEC_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* al = static_cast<const uint8_t*>(alive);
  const float* bi = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  float* pt = chunks > 1 ? static_cast<float*>(part) : nullptr;
  if (Nq <= DEC_ROWS) {
    const dim3 grid(B * H, 1, chunks);
    if (Nq == 1)
      k4_ffma_decode<1><<<grid, 32 * DEC_WARPS, DEC_SMEM, stream>>>(
          qf, kf, vf, qsb, qsn, ksb, ksn, al, bi, of, pt, B, Nq, S, H, chunk_keys, scale);
    else if (Nq == 2)
      k4_ffma_decode<2><<<grid, 32 * DEC_WARPS, DEC_SMEM, stream>>>(
          qf, kf, vf, qsb, qsn, ksb, ksn, al, bi, of, pt, B, Nq, S, H, chunk_keys, scale);
    else
      k4_ffma_decode<4><<<grid, 32 * DEC_WARPS, DEC_SMEM, stream>>>(
          qf, kf, vf, qsb, qsn, ksb, ksn, al, bi, of, pt, B, Nq, S, H, chunk_keys, scale);
  } else {
    // the fewest 40-row query blocks, evened out, and two warps per 8 of their rows
    const int qblocks = (Nq + ROWS_W * FMAX_RW - 1) / (ROWS_W * FMAX_RW);
    const int block_rows = (Nq + qblocks - 1) / qblocks;
    const int rw = (block_rows + ROWS_W - 1) / ROWS_W;
    k4_ffma<<<dim3(B * H, qblocks, chunks), 64 * rw, ffma_smem(rw), stream>>>(
        qf, kf, vf, qsb, qsn, ksb, ksn, al, bi, of, pt, B, Nq, S, H, block_rows, chunk_keys,
        scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  return launch_combine<float>(part, out, B, Nq, H, chunks, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements: (qsb, qsn) of
// q, (ksb, ksn) shared by k and v.  bias may be null.  chunks and
// chunk_keys: the split of the keys (madtp_tpu_torch/kernels/
// cross_attention.py `split_chunks`, a rule for each dtype; fp32 chunks of
// at most FMAX_CHUNK keys); with chunks > 1, part is an fp32 scratch of
// chunks B H Nq (64 + 2) values.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int k4_cross_attention(int dtype, const void* q, const void* k, const void* v,
                                  long long qsb, long long qsn, long long ksb, long long ksn,
                                  const void* alive, const void* bias, void* out, void* part,
                                  int B, int Nq, int S, int H, int Dh, int chunks,
                                  int chunk_keys, float scale, void* stream) {
  if (Dh != DH || B < 1 || Nq < 1 || S < 1 || H < 1 || chunks < 1 || chunk_keys < 1 ||
      (dtype != 0 && dtype != 1) || chunk_keys % KT || (int64_t)(chunks - 1) * chunk_keys >= S ||
      (int64_t)chunks * chunk_keys < S || chunks > 65535 || (chunks > 1 && part == nullptr) ||
      (int64_t)B * H > 0x7fffffff || (Nq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int rows = ROWS_W * FMAX_RW;  // a block's query rows
    if (chunk_keys > FMAX_CHUNK || (Nq + rows - 1) / rows > 65535)
      return (int)cudaErrorInvalidValue;
    return (int)launch_ffma(q, k, v, qsb, qsn, ksb, ksn, alive, bias, out, part, B, Nq, S, H,
                            chunks, chunk_keys, scale, st);
  }
  return (int)launch_mma(q, k, v, qsb, qsn, ksb, ksn, alive, bias, out, part, B, Nq, S, H,
                         chunks, chunk_keys, scale, st);
}
