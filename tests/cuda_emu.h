// A CPU emulator of the CUDA features that the port's kernels use, for the
// CPU tests (tests/cuda_emu.py turns a kernel source into host C++ against
// this header).  Blocks run one after another, the blocks of a thread-block
// cluster together; each thread is a ucontext fiber.  __syncthreads, the
// cluster barrier and the warp collectives (shuffles, ballots, __syncwarp,
// ldmatrix, mma.sync) are barriers with data exchange, following the PTX fragment layouts; mma
// accumulates in double.  cp.async copies land at the wait that covers them,
// and dynamic shared memory starts filled with NaN bytes, so that a read
// before a landing or of memory never written shows.  A block reads another
// block's shared memory of its cluster through ld_cluster4.  Global memory is
// the host's.
#pragma once
#include <ucontext.h>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
#include <algorithm>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3v { unsigned x, y, z; };
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// ---------------------------------------------------------------- bf16
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = (uint32_t)h.x << 16; float f; memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if (std::isnan(f)) return __nv_bfloat16{0x7fc0};
  u += 0x7fff + ((u >> 16) & 1);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return __nv_bfloat162{__float2bfloat16(a), __float2bfloat16(b)};
}
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
inline float2 make_float2(float a, float b) { return float2{a, b}; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline float ex2(float x) { return exp2f(x); }
inline float __fdividef(float a, float b) { return a / b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }

// ---------------------------------------------------------------- fibers
struct EmuThread {
  ucontext_t ctx;
  uint3v tid;
  int lin;  // linear index in its block
  int blk;  // its block's rank in the cluster
  bool done;
  char* stack = nullptr;  // malloc'd once and kept: pages are touched only as used
  // pending cp.async groups: (dst offset, src, bytes)
  struct Copy { uint32_t dst; const void* src; int bytes; int size; };
  std::vector<Copy> open;
  std::vector<std::vector<Copy>> groups;
};

struct EmuBlock {
  uint3v bid;
  std::vector<unsigned char> smem;
  int alive = 0;
  // block barrier
  unsigned long gen = 0; int arrived = 0;
  // warp barriers
  unsigned long wgen[32] = {0}; int warrived[32] = {0};
  uint64_t wslot[32][32][16];
};

struct EmuState {
  ucontext_t sched;
  std::vector<EmuThread> th;
  EmuThread* cur = nullptr;
  uint3v bdim, gdim;
  std::vector<EmuBlock> blocks;  // the cluster's blocks, by rank
  // cluster barrier
  unsigned long cgen = 0; int carrived = 0, calive = 0;
  EmuBlock& blk() { return blocks[cur->blk]; }
};
inline EmuState& emu() { static EmuState s; return s; }

#define threadIdx (emu().cur->tid)
#define blockIdx (emu().blk().bid)
// free functions in kernels; members of cudaLaunchConfig_t in `cfg.gridDim`
inline uint3v& emu_bdim() { return emu().bdim; }
inline uint3v& emu_gdim() { return emu().gdim; }
#define blockDim emu_bdim()
#define gridDim emu_gdim()

inline void emu_yield() { swapcontext(&emu().cur->ctx, &emu().sched); }

inline void __syncthreads() {
  EmuBlock& b = emu().blk();
  unsigned long g0 = b.gen;
  if (++b.arrived == b.alive) { b.arrived = 0; b.gen++; return; }
  while (b.gen == g0) emu_yield();
}

// barrier.cluster.arrive + wait: every live thread of the cluster's blocks
inline void cluster_sync() {
  EmuState& s = emu();
  unsigned long g0 = s.cgen;
  if (++s.carrived == s.calive) { s.carrived = 0; s.cgen++; return; }
  while (s.cgen == g0) emu_yield();
}

// warp exchange: each lane deposits n words, then reads any lane's.
inline void emu_warp_sync() {
  EmuBlock& b = emu().blk();
  int w = emu().cur->lin / 32;
  unsigned long g0 = b.wgen[w];
  if (++b.warrived[w] == 32) { b.warrived[w] = 0; b.wgen[w]++; return; }
  while (b.wgen[w] == g0) emu_yield();
}
inline int emu_lane() { return emu().cur->lin % 32; }
inline uint64_t* emu_slot(int lane) { return emu().blk().wslot[emu().cur->lin / 32][lane]; }

template <class T> inline T __shfl_xor_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) <= 8, "");
  int lane = emu_lane();
  uint64_t u = 0; memcpy(&u, &v, sizeof(T));
  emu_slot(lane)[0] = u;
  emu_warp_sync();
  uint64_t r = emu_slot(lane ^ off)[0];
  emu_warp_sync();
  T out; memcpy(&out, &r, sizeof(T)); return out;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= 8, "");
  int lane = emu_lane();
  uint64_t u = 0; memcpy(&u, &v, sizeof(T));
  emu_slot(lane)[0] = u;
  emu_warp_sync();
  uint64_t r = emu_slot(src & 31)[0];
  emu_warp_sync();
  T out; memcpy(&out, &r, sizeof(T)); return out;
}
inline void __syncwarp() { emu_warp_sync(); }
template <class T> inline T __shfl_up_sync(unsigned, T v, int off) {
  static_assert(sizeof(T) <= 8, "");
  int lane = emu_lane();
  uint64_t u = 0; memcpy(&u, &v, sizeof(T));
  emu_slot(lane)[0] = u;
  emu_warp_sync();
  uint64_t r = emu_slot(lane >= off ? lane - off : lane)[0];
  emu_warp_sync();
  T out; memcpy(&out, &r, sizeof(T)); return out;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  int lane = emu_lane();
  emu_slot(lane)[0] = pred != 0;
  emu_warp_sync();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l) bits |= (unsigned)emu_slot(l)[0] << l;
  emu_warp_sync();
  return bits;
}

// ---------------------------------------------------------------- shared memory, PTX helpers
inline void* emu_dyn_smem() { return emu().blk().smem.data(); }
inline uint32_t smem_addr(const void* p) {
  const std::vector<unsigned char>& m = emu().blk().smem;
  long off = (const unsigned char*)p - m.data();
  if (off < 0 || off >= (long)m.size()) { fprintf(stderr, "smem_addr outside dynamic smem\n"); abort(); }
  return (uint32_t)off;
}
inline unsigned char* emu_sp(uint32_t a, int bytes) {
  std::vector<unsigned char>& m = emu().blk().smem;
  if ((size_t)a + bytes > m.size()) { fprintf(stderr, "smem access out of range %u\n", a); abort(); }
  return m.data() + a;
}
// the float4 at this block's shared address of p, in the shared memory of
// the cluster's block `rank` (mapa + ld.shared::cluster)
inline float4 ld_cluster4(const float* p, int rank) {
  EmuState& s = emu();
  uint32_t a = smem_addr(p);
  if (a % 16 || rank < 0 || rank >= (int)s.blocks.size() || a + 16 > s.blocks[rank].smem.size()) {
    fprintf(stderr, "ld_cluster4 out of range\n"); abort();
  }
  float4 v; memcpy(&v, s.blocks[rank].smem.data() + a, 16); return v;
}
inline void emu_do_copy(const EmuThread::Copy& c) {
  if (c.bytes) memcpy(emu_sp(c.dst, c.size), c.src, c.size); else memset(emu_sp(c.dst, c.size), 0, c.size);
}
inline void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  if (dst % 16) { fprintf(stderr, "cp.async dst misaligned\n"); abort(); }
  if ((uintptr_t)src % 16) { fprintf(stderr, "cp.async src misaligned\n"); abort(); }
  if (src_bytes != 0 && src_bytes != 16) { fprintf(stderr, "cp.async bytes\n"); abort(); }
  emu().cur->open.push_back(EmuThread::Copy{dst, src, src_bytes, 16});
}
inline void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  if (dst % 4 || (uintptr_t)src % 4 || (src_bytes != 0 && src_bytes != 4)) { fprintf(stderr, "cp.async4\n"); abort(); }
  emu().cur->open.push_back(EmuThread::Copy{dst, src, src_bytes, 4});
}
inline void cp_async_commit() {
  EmuThread* t = emu().cur;
  t->groups.push_back(t->open);
  t->open.clear();
}
template <int N> inline void cp_async_wait() {
  EmuThread* t = emu().cur;
  while ((int)t->groups.size() > N) {
    for (auto& c : t->groups.front()) emu_do_copy(c);
    t->groups.erase(t->groups.begin());
  }
}
inline void emu_ldm(uint32_t (&r)[4], uint32_t addr, int nmat, bool trans) {
  int lane = emu_lane();
  emu_slot(lane)[0] = addr;
  emu_warp_sync();
  for (int i = 0; i < nmat; ++i) {
    if (!trans) {
      uint32_t a = (uint32_t)emu_slot(8 * i + lane / 4)[0] + 4 * (lane % 4);
      memcpy(&r[i], emu_sp(a, 4), 4);
    } else {
      uint32_t a0 = (uint32_t)emu_slot(8 * i + 2 * (lane % 4))[0] + 2 * (lane / 4);
      uint32_t a1 = (uint32_t)emu_slot(8 * i + 2 * (lane % 4) + 1)[0] + 2 * (lane / 4);
      uint16_t lo, hi;
      memcpy(&lo, emu_sp(a0, 2), 2);
      memcpy(&hi, emu_sp(a1, 2), 2);
      r[i] = lo | ((uint32_t)hi << 16);
    }
  }
  emu_warp_sync();
}
inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) { emu_ldm(r, addr, 4, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) { emu_ldm(r, addr, 4, true); }
inline float emu_bf(uint32_t w, int hi) {
  uint16_t h = hi ? (w >> 16) : (w & 0xffff);
  return __bfloat162float(__nv_bfloat16{h});
}
inline float emu_tf(uint32_t w) { w &= 0xffffe000u; float f; memcpy(&f, &w, 4); return f; }
// d += a b, m16n8k16 bf16
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  int lane = emu_lane();
  uint64_t* sl = emu_slot(lane);
  for (int i = 0; i < 4; ++i) sl[i] = a[i];
  sl[4] = b0; sl[5] = b1;
  emu_warp_sync();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    int g = l / 4, t = l % 4;
    uint64_t* s = emu_slot(l);
    A[g][2 * t] = emu_bf(s[0], 0); A[g][2 * t + 1] = emu_bf(s[0], 1);
    A[g + 8][2 * t] = emu_bf(s[1], 0); A[g + 8][2 * t + 1] = emu_bf(s[1], 1);
    A[g][2 * t + 8] = emu_bf(s[2], 0); A[g][2 * t + 9] = emu_bf(s[2], 1);
    A[g + 8][2 * t + 8] = emu_bf(s[3], 0); A[g + 8][2 * t + 9] = emu_bf(s[3], 1);
    B[2 * t][g] = emu_bf(s[4], 0); B[2 * t + 1][g] = emu_bf(s[4], 1);
    B[2 * t + 8][g] = emu_bf(s[5], 0); B[2 * t + 9][g] = emu_bf(s[5], 1);
  }
  emu_warp_sync();
  int g = lane / 4, t = lane % 4;
  int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int e = 0; e < 4; ++e) {
    double acc = d[e];
    for (int k = 0; k < 16; ++k) acc += (double)A[rows[e]][k] * B[k][cols[e]];
    d[e] = (float)acc;
  }
}
// d += a b, m16n8k8 tf32
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  int lane = emu_lane();
  uint64_t* sl = emu_slot(lane);
  for (int i = 0; i < 4; ++i) sl[i] = a[i];
  sl[4] = b0; sl[5] = b1;
  emu_warp_sync();
  float A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    int g = l / 4, t = l % 4;
    uint64_t* s = emu_slot(l);
    A[g][t] = emu_tf(s[0]); A[g + 8][t] = emu_tf(s[1]);
    A[g][t + 4] = emu_tf(s[2]); A[g + 8][t + 4] = emu_tf(s[3]);
    B[t][g] = emu_tf(s[4]); B[t + 4][g] = emu_tf(s[5]);
  }
  emu_warp_sync();
  int g = lane / 4, t = lane % 4;
  int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int e = 0; e < 4; ++e) {
    double acc = d[e];
    for (int k = 0; k < 8; ++k) acc += (double)A[rows[e]][k] * B[k][cols[e]];
    d[e] = (float)acc;
  }
}
inline uint32_t to_tf32(float x) {
  uint32_t u; memcpy(&u, &x, 4);
  if (std::isfinite(x)) u = (u + 0x1000u) & 0xffffe000u;  // round to nearest, ties away
  return u;
}

// ---------------------------------------------------------------- launch
struct EmuCfg { dim3 grid, block; size_t smem; };
inline EmuCfg EMU_CFG(dim3 g, dim3 b, size_t smem = 0, cudaStream_t = nullptr) {
  return EmuCfg{g, b, smem};
}
inline void emu_trampoline(unsigned lo, unsigned hi) {
  auto* fn = reinterpret_cast<std::function<void()>*>((uintptr_t)lo | ((uintptr_t)hi << 32));
  (*fn)();
  emu().cur->done = true;
  swapcontext(&emu().cur->ctx, &emu().sched);
}
constexpr size_t EMU_STACK = 1 << 18;
// Runs the grid cluster by cluster (cluster dims `cl`, dividing the grid's),
// the blocks of a cluster together, ranked x fastest.
template <class K, class... A>
void emu_launch_cluster(EmuCfg cfg, dim3 cl, K kernel, A... args) {
  EmuState& s = emu();
  int nt = cfg.block.x * cfg.block.y * cfg.block.z;
  int nb = cl.x * cl.y * cl.z;
  if (cfg.grid.x % cl.x || cfg.grid.y % cl.y || cfg.grid.z % cl.z) { fprintf(stderr, "emu: cluster does not divide the grid\n"); abort(); }
  s.gdim = {cfg.grid.x, cfg.grid.y, cfg.grid.z};
  s.bdim = {cfg.block.x, cfg.block.y, cfg.block.z};
  std::function<void()> body = [&]() { kernel(args...); };
  if ((int)s.th.size() < nt * nb) s.th.resize(nt * nb);
  for (auto& t : s.th) if (!t.stack) t.stack = (char*)malloc(EMU_STACK);
  s.blocks.resize(nb);
  for (unsigned cz = 0; cz < cfg.grid.z; cz += cl.z)
    for (unsigned cy = 0; cy < cfg.grid.y; cy += cl.y)
      for (unsigned cx = 0; cx < cfg.grid.x; cx += cl.x) {
        for (int r = 0; r < nb; ++r) {
          EmuBlock& b = s.blocks[r];
          b.bid = {cx + r % cl.x, cy + (r / cl.x) % cl.y, cz + r / (cl.x * cl.y)};
          b.smem.assign(cfg.smem, 0xFF);  // NaN bytes: unwritten memory shows
          b.alive = nt;
          b.arrived = 0;
          for (int w = 0; w < 32; ++w) b.warrived[w] = 0;
        }
        s.calive = nt * nb;
        s.carrived = 0;
        for (int i = 0; i < nt * nb; ++i) {
          EmuThread& t = s.th[i];
          int l = i % nt;
          t.lin = l;
          t.blk = i / nt;
          t.tid = {(unsigned)(l % cfg.block.x), (unsigned)((l / cfg.block.x) % cfg.block.y),
                   (unsigned)(l / (cfg.block.x * cfg.block.y))};
          t.done = false;
          t.open.clear(); t.groups.clear();
          getcontext(&t.ctx);
          t.ctx.uc_stack.ss_sp = t.stack;
          t.ctx.uc_stack.ss_size = EMU_STACK;
          t.ctx.uc_link = nullptr;
          uintptr_t p = (uintptr_t)&body;
          makecontext(&t.ctx, (void (*)())emu_trampoline, 2, (unsigned)(p & 0xffffffffu),
                      (unsigned)(p >> 32));
        }
        long rounds = 0;
        while (true) {
          bool any = false;
          for (int i = 0; i < nt * nb; ++i) {
            EmuThread& t = s.th[i];
            if (t.done) continue;
            any = true;
            s.cur = &t;
            swapcontext(&s.sched, &t.ctx);
            if (t.done) {
              EmuBlock& b = s.blocks[t.blk];
              b.alive--;
              if (b.arrived > 0 && b.arrived == b.alive) { b.arrived = 0; b.gen++; }
              s.calive--;
              if (s.carrived > 0 && s.carrived == s.calive) { s.carrived = 0; s.cgen++; }
            }
          }
          if (!any) break;
          if (++rounds > 50000000) { fprintf(stderr, "emu: deadlock?\n"); abort(); }
        }
      }
}
template <class K, class... A>
void emu_launch(EmuCfg cfg, K kernel, A... args) {
  emu_launch_cluster(cfg, dim3(1, 1, 1), kernel, args...);
}

// cudaLaunchKernelEx with a cluster dimension attribute
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gd, bd;  // gridDim, blockDim
  dim3& emu_gdim() { return gd; }
  dim3& emu_bdim() { return bd; }
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*kernel)(E...), A&&... args) {
  dim3 cl(1, 1, 1);
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cl = dim3(c->attrs[i].val.clusterDim.x, c->attrs[i].val.clusterDim.y,
                c->attrs[i].val.clusterDim.z);
  if (cl.x * cl.y * cl.z > 8) return cudaErrorInvalidValue;
  emu_launch_cluster(EmuCfg{c->gd, c->bd, c->dynamicSmemBytes}, cl, kernel,
                     static_cast<E>(args)...);
  return cudaSuccess;
}
