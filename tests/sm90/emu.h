// A CPU emulation of the CUDA and Hopper features that the bf16 attention
// kernels (src/repro_torch/kernels/csrc/flash_attention{,_bwd}_sm90.cu), the
// float32 attention kernels' cp.async rings (csrc/flash_attention{,_bwd}.cu), the
// RG-LRU scans' TMA rings (csrc/rglru.cu) and the chunked WKV (csrc/wkv.cu)
// use, so their device code compiles with g++ and runs on CPU tensors:
//   * a block's threads are std::threads meeting at std::barriers (the
//     block, each warp, each warpgroup); shuffles go through shared slots;
//   * shared memory is one global array whose shared-space addresses start
//     48 bytes off a 1,024-byte boundary (the kernels align it themselves)
//     and is filled with garbage before each block;
//   * TMA copies a box at once, with the hardware's 128-byte swizzle (the
//     16-byte chunk bits [4:6] of the address XOR bits [7:9]) or unswizzled
//     (2-D and 3-D boxes of 4- or 2-byte elements), and zeros past every
//     bound, and then completes its bytes on the mbarrier; cp.async copies
//     its 16 bytes at once (or, with EMU_CP_ASYNC_DEFERRED, when its thread
//     waits for its group);
//   * mbarriers count arrivals and transaction bytes and flip a phase;
//   * wgmma decodes its shared-memory descriptors (start, LBO, SBO) as the
//     PTX ISA lays out K-major and MN-major 128B-swizzled operands, and
//     computes each thread's accumulator registers from the fragment
//     layouts of sm90.cuh (a register A operand is gathered from the
//     warpgroup's threads through shared slots; its B operand K-major or
//     MN-major).
// So the emulation checks the kernels' index math, masks, softmax and
// pipeline against their plain versions; that the card reads descriptors
// and fragments the same way is checked on the card (tests/test_torch_gpu.py,
// chip_smoke.py).  tests/test_torch_flash_sm90.py, test_torch_rglru_sm90.py,
// test_torch_wkv_sm90.py and test_torch_flash_f32_emu.py build and run it.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __restrict__ __restrict
#define __shared__ static
using std::max;
using std::min;
#define SM90_EMULATE
#include "sm90.cuh"

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;

struct __nv_bfloat16 {
  uint16_t x;
};
inline float bf2f(uint16_t b) {
  uint32_t u = (uint32_t)b << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint16_t f2bf(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return 0x7fc0;
  u += 0x7fff + ((u >> 16) & 1);
  return (uint16_t)(u >> 16);
}

// ---- block machinery ----
constexpr int kEmuSmemOffset = 48;   // shared addresses start off 1,024
alignas(4096) inline uint8_t smem_raw[256 * 1024];
struct Block {
  std::barrier<>* all;
  std::barrier<>* warp[8];
  std::barrier<>* wg[2];
  float shfl[256];
  uint32_t afrag[2][128][4];
};
inline Block g_block;

inline void __syncthreads() { g_block.all->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_block.warp[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int t = threadIdx.x;
  auto* b = g_block.warp[t / 32];
  g_block.shfl[t] = v;
  b->arrive_and_wait();
  const float r = g_block.shfl[(t & ~31) | ((t % 32) ^ off)];
  b->arrive_and_wait();
  return r;
}

struct CUtensorMap {
  const uint8_t* base;
  int rank, esize, swizzle;
  long long dims[4], strides[3];
  int box[2];
};

template <typename F>
void run_grid(dim3 grid, int threads, F kernel) {
  gridDim = grid;
  blockDim = dim3(threads);
  std::barrier<> all(threads);
  for (int w = 0; w < threads / 32; ++w) g_block.warp[w] = new std::barrier<>(32);
  for (int w = 0; w < threads / 128; ++w) g_block.wg[w] = new std::barrier<>(128);
  g_block.all = &all;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::memset(smem_raw, 0xCD, sizeof(smem_raw));   // garbage, not zeros
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([=] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            kernel();
          });
        for (auto& t : ts) t.join();
      }
  for (int w = 0; w < threads / 32; ++w) delete g_block.warp[w];
  for (int w = 0; w < threads / 128; ++w) delete g_block.wg[w];
}

namespace sm90 {
inline uint32_t smem_u32(const void* p) {
  return (uint32_t)((const uint8_t*)p - smem_raw) + kEmuSmemOffset;
}
inline uint8_t* smem_ptr(uint32_t a) { return smem_raw + (a - kEmuSmemOffset); }
inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)f2bf(lo) | ((uint32_t)f2bf(hi) << 16);
}

// ---- mbarriers ----
struct Mbar {
  int count = 0, pending = 0;
  long long tx = 0;
  long long phases = 0;
};
inline std::mutex g_mu;
inline std::condition_variable g_cv;
inline std::map<const void*, Mbar> g_bars;
inline void mbar_complete_if_done(Mbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    m.phases++;
    m.pending = m.count;
    g_cv.notify_all();
  }
}
inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> l(g_mu);
  g_bars[bar] = Mbar{count, count, 0, 0};
}
inline void fence_barrier_init() {}
inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> l(g_mu);
  Mbar& m = g_bars.at(bar);
  m.tx += bytes;
  m.pending--;
  if (m.pending < 0) std::abort();
  mbar_complete_if_done(m);
}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> l(g_mu);
  Mbar& m = g_bars.at(bar);
  m.pending--;
  if (m.pending < 0) std::abort();
  mbar_complete_if_done(m);
}
inline void mbar_wait(uint64_t* bar, int parity) {
  std::unique_lock<std::mutex> l(g_mu);
  g_cv.wait(l, [&] { return (g_bars.at(bar).phases & 1) != parity; });
}
inline void mbar_tx_done(uint64_t* bar, long long bytes) {
  std::lock_guard<std::mutex> l(g_mu);
  Mbar& m = g_bars.at(bar);
  m.tx -= bytes;
  if (m.tx < 0) std::abort();
  mbar_complete_if_done(m);
}

inline uint32_t swz(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

// ---- TMA ----
inline void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2, int c3) {
  const uint32_t d0 = smem_u32(dst);
  if (map->swizzle && (d0 % 1024)) std::abort();
  for (int r = 0; r < map->box[1]; ++r)
    for (int c = 0; c < map->box[0]; ++c) {
      const long long x0 = c0 + c, x1 = c1 + r;
      uint16_t v = 0;
      if (x0 >= 0 && x0 < map->dims[0] && x1 >= 0 && x1 < map->dims[1] &&
          c2 < map->dims[2] && c3 < map->dims[3]) {
        const uint8_t* p = map->base + x0 * 2 + x1 * map->strides[0] +
                           c2 * map->strides[1] + c3 * map->strides[2];
        std::memcpy(&v, p, 2);
      }
      uint32_t a = d0 + (r * map->box[0] + c) * 2;
      if (map->swizzle) a = swz(a);
      std::memcpy(smem_ptr(a), &v, 2);
    }
  mbar_tx_done(bar, (long long)map->box[0] * map->box[1] * 2);
}
inline void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1) {
  if (smem_u32(dst) % 128) std::abort();
  float* out = (float*)dst;
  for (int c = 0; c < map->box[0]; ++c) {
    const long long x0 = c0 + c;
    float v = 0.0f;
    if (x0 < map->dims[0] && c1 < map->dims[1])
      std::memcpy(&v, map->base + x0 * 4 + c1 * map->strides[0], 4);
    out[c] = v;
  }
  mbar_tx_done(bar, (long long)map->box[0] * 4);
}

// A 3-D box of box[0] x box[1] elements of esize bytes at plane c2,
// unswizzled, zeros past every bound (the RG-LRU scan's tiles).
inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2) {
  if (smem_u32(dst) % 128 || map->rank != 3 || map->swizzle) std::abort();
  const int es = map->esize;
  for (int r = 0; r < map->box[1]; ++r)
    for (int c = 0; c < map->box[0]; ++c) {
      const long long x0 = c0 + c, x1 = c1 + r;
      uint8_t v[4] = {0, 0, 0, 0};
      if (x0 >= 0 && x0 < map->dims[0] && x1 >= 0 && x1 < map->dims[1] &&
          c2 >= 0 && c2 < map->dims[2])
        std::memcpy(v, map->base + x0 * es + x1 * map->strides[0] +
                           c2 * map->strides[1], es);
      std::memcpy((uint8_t*)dst + ((long long)r * map->box[0] + c) * es, v,
                  es);
    }
  mbar_tx_done(bar, (long long)map->box[0] * map->box[1] * es);
}
inline void fence_proxy_async() {}
// The store reads the box at once and writes what lies inside the bounds.
inline void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                         int c1, int c2) {
  if (smem_u32(src) % 128 || map->rank != 3 || map->swizzle) std::abort();
  const int es = map->esize;
  for (int r = 0; r < map->box[1]; ++r)
    for (int c = 0; c < map->box[0]; ++c) {
      const long long x0 = c0 + c, x1 = c1 + r;
      if (x0 >= 0 && x0 < map->dims[0] && x1 >= 0 && x1 < map->dims[1] &&
          c2 >= 0 && c2 < map->dims[2])
        std::memcpy(const_cast<uint8_t*>(map->base) + x0 * es +
                        x1 * map->strides[0] + c2 * map->strides[1],
                    (const uint8_t*)src + ((long long)r * map->box[0] + c) * es,
                    es);
    }
}
inline void bulk_commit() {}
#ifndef EMU_CP_ASYNC_DEFERRED
// cp.async lands at once.
inline void cp_async16(void* dst, const void* src) {
  if (smem_u32(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16)
    std::abort();
  std::memcpy(dst, src, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
template <int N>
inline void cp_async_wait_group() {}
#else
// cp.async lands only when the issuing thread waits for its group
// (wait_group N: every committed group but the newest N; wait_all: every
// committed group), as late as the hardware may land it: a read before the
// wait, or by another thread before a barrier after it, sees the 0xCD
// garbage (the float32 attention kernels' harness).
inline thread_local std::vector<std::vector<std::pair<void*, const void*>>>
    t_cp_groups;
inline thread_local std::vector<std::pair<void*, const void*>> t_cp_open;
inline void cp_async16(void* dst, const void* src) {
  if (smem_u32(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16)
    std::abort();
  t_cp_open.emplace_back(dst, src);
}
inline void cp_async_commit() {
  t_cp_groups.push_back(std::move(t_cp_open));
  t_cp_open.clear();
}
inline void cp_async_land(size_t keep) {
  while (t_cp_groups.size() > keep) {
    for (const auto& c : t_cp_groups.front()) std::memcpy(c.first, c.second, 16);
    t_cp_groups.erase(t_cp_groups.begin());
  }
}
inline void cp_async_wait_all() { cp_async_land(0); }
template <int N>
inline void cp_async_wait_group() { cp_async_land(N); }
#endif
template <int N>
inline void bulk_wait_read() {}
inline void bulk_wait_all() {}

// ---- wgmma ----
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait0() {}
template <int N>
inline void fence_acc(float*) {}

struct Desc {
  uint32_t start, lbo, sbo;
};
inline Desc decode(uint64_t d) {
  if ((d >> 62) != 1) std::abort();
  return Desc{(uint32_t)(d & 0x3FFF) << 4, (uint32_t)((d >> 16) & 0x3FFF) << 4,
              (uint32_t)((d >> 32) & 0x3FFF) << 4};
}
inline float ld_bf(uint32_t a) {
  uint16_t v;
  std::memcpy(&v, smem_ptr(swz(a)), 2);
  return bf2f(v);
}
// K-major operand element (row m or n, k)
inline float kmajor(const Desc& d, int mn, int k) {
  return ld_bf(d.start + (mn / 8) * d.sbo + (mn % 8) * 128 + k * 2);
}
// MN-major operand element (k, n)
inline float mnmajor(const Desc& d, int k, int n) {
  return ld_bf(d.start + (n / 64) * d.lbo + (n % 64) * 2 + (k / 8) * d.sbo +
               (k % 8) * 128);
}

template <int N>
inline void wgmma_ss(float* d, uint64_t a, uint64_t b, int scale_d) {
  const int t = threadIdx.x % 128;
  const Desc da = decode(a), db = decode(b);
  for (int r = 0; r < N / 2; ++r) {
    const int row = acc_row(t, r), col = acc_col(t, r);
    float s = 0.0f;
    for (int k = 0; k < 16; ++k) s += kmajor(da, row, k) * kmajor(db, col, k);
    d[r] = (scale_d ? d[r] : 0.0f) + s;
  }
}
// The warpgroup's register A operand (64 x 16), gathered through shared
// slots from every thread's four registers.
inline void gather_afrag(const uint32_t* a, float (&A)[64][16]) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  for (int i = 0; i < 4; ++i) g_block.afrag[wg][t][i] = a[i];
  g_block.wg[wg]->arrive_and_wait();
  for (int u = 0; u < 128; ++u)
    for (int i = 0; i < 4; ++i)
      for (int e = 0; e < 2; ++e)
        A[afrag_row(u, i)][afrag_col(u, i, e)] =
            bf2f((uint16_t)(g_block.afrag[wg][u][i] >> (16 * e)));
  g_block.wg[wg]->arrive_and_wait();
}
// A in registers, B K-major in shared memory.
template <int N>
inline void wgmma_rs_k(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  static thread_local float A[64][16];
  gather_afrag(a, A);
  const int t = threadIdx.x % 128;
  const Desc db = decode(b);
  for (int r = 0; r < N / 2; ++r) {
    const int row = acc_row(t, r), col = acc_col(t, r);
    float s = 0.0f;
    for (int k = 0; k < 16; ++k) s += A[row][k] * kmajor(db, col, k);
    d[r] = (scale_d ? d[r] : 0.0f) + s;
  }
}
template <int N>
inline void wgmma_rs(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  for (int i = 0; i < 4; ++i) g_block.afrag[wg][t][i] = a[i];
  g_block.wg[wg]->arrive_and_wait();
  static thread_local float A[64][16];
  for (int u = 0; u < 128; ++u)
    for (int i = 0; i < 4; ++i)
      for (int e = 0; e < 2; ++e)
        A[afrag_row(u, i)][afrag_col(u, i, e)] =
            bf2f((uint16_t)(g_block.afrag[wg][u][i] >> (16 * e)));
  g_block.wg[wg]->arrive_and_wait();
  const Desc db = decode(b);
  for (int r = 0; r < N / 2; ++r) {
    const int row = acc_row(t, r), col = acc_col(t, r);
    float s = 0.0f;
    for (int k = 0; k < 16; ++k) s += A[row][k] * mnmajor(db, k, col);
    d[r] = (scale_d ? d[r] : 0.0f) + s;
  }
}
}  // namespace sm90
