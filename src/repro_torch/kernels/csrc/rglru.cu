// RG-LRU gated linear recurrence for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/rglru/rglru.py::rglru_scan (_rglru_kernel;
// pl.pallas_call at :61):
//     h_t = a_t * h_{t-1} + b_t        from h_{-1} = 0, per channel,
// a, b, h [B, T, C] (any element strides, the channel one 1).  The carry is
// float32; h is rounded to a's type.  A carried state h0 is the caller's:
// the model folds a_0 * h0 into b_0 (models/rglru.py:93-95).  Built with
// -fmad=false, so a_t * h is rounded before the add, as in the TPU kernel's
// `at * h + bt_` and in the plain version: the kernel equals it bit for bit.
//
// What bounds it on this card.  Two operations per element against 12 bytes
// (a and b read, h written, float32): at B 2, T 4096, C 2560 that is 252 MB,
// 0.075 ms at 3.35 TB/s, so it is bound by bytes.  The dependent chain of a
// channel (a rounded multiply, then an add: ~8 cycles a step) is ~20 us
// over 4,096 steps, far below that, once the loads' latency is hidden.
//
// Design.  The recurrence stays sequential per channel, in the plain
// version's order (a chunked associative scan would round differently).
// A block is one warp that owns W = 16 or 32 channels of one row b (the
// wrapper takes 32 when B x C / 32 blocks fill every SM, else 16, so a
// launch has about one block an SM or more); each lane walks one channel
// with the carry in a register.  a and b stream through shared memory: a
// ring of kStages stages, each a [Tc x W] tile of a and one of b (8 KB
// each: Tc = 8192 / (W x element size) steps), brought in by 3-D TMA over
// (C, T, B) with zeros past C and T, and completed on one mbarrier a stage.
// Lane 0 keeps kStages - 1 stages in flight while the warp walks one
// (~64 KB a block); it refills a stage after the whole warp has read it
// (__syncwarp, then a proxy fence).  Lanes read their column of a tile
// (consecutive words across the warp: no bank conflict), kUnroll steps of
// loads ahead of the chain, and store h straight from the register:
// consecutive addresses across the warp at every step.  Where TMA cannot
// address the inputs (T = 1, the decode step; a base address or a batch or
// time stride not a multiple of 16 bytes) the same block walks its
// channels straight from device memory, kUnroll steps of loads ahead: the
// result is the same bit for bit.
//
// The backward, rglru_bwd_kernel, is the port's own: JAX differentiates
// its associative scan in XLA (models/rglru.py:102) and has no Pallas
// backward.  With g = dL/dh (the output's gradient), the gradient through
// the carry is a reverse linear scan of the forward's shape:
//     lam_t = a_{t+1} * lam_{t+1} + g_t      (lam_{T-1} = g_{T-1}),
//     db_t = lam_t,    da_t = lam_t * h_{t-1}  (h_{-1} = 0),
// from the forward's saved h; da and db are float32.  Also built with
// -fmad=false, so each product is rounded before its add, as in the plain
// version (ref.py::rglru_bwd_ref): the kernel equals it bit for bit.  Its
// bound is bytes: a, h, g read and da, db written, 5 x 4 B x B T C in
// float32 (at B 2, T 4096, C 2560: 419 MB, 0.125 ms at 3.35 TB/s).  Its
// design is the first forward's, walked from t = T - 1 down: one thread per
// (b, c) in blocks of 128, the carry in a register, loads kUnroll steps
// ahead; the forward's TMA ring is the next step for it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 32;        // the forward: one warp a block
constexpr int kStages = 4;          // the forward's TMA ring
constexpr int kTileBytes = 8192;    // one operand's tile of a stage
constexpr int kSmem = 2 * kStages * kTileBytes + 128;   // + alignment
constexpr int kBwdThreads = 128;    // the backward
constexpr int kUnroll = 8;

// Steps of a stage's tile for W channels of T.
template <typename T, int W>
struct Ring {
  static constexpr int kTc = kTileBytes / (W * static_cast<int>(sizeof(T)));
  static_assert(kTc % kUnroll == 0 && kTc <= 256, "TMA box rows");
};

extern __shared__ uint8_t smem_raw[];

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One channel straight from device memory (the direct path).
template <typename T>
__device__ __forceinline__ void scan_direct(const T* ab, long long ast,
                                            const T* bb, long long bst,
                                            T* hb, long long hst,
                                            int T_len) {
  float carry = 0.0f;
  for (int t0 = 0; t0 < T_len; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const long long t = t0 + s;
      av[s] = t < T_len ? to_f32(ab[t * ast]) : 0.0f;
      bv[s] = t < T_len ? to_f32(bb[t * bst]) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const long long t = t0 + s;
      if (t < T_len) {
        carry = av[s] * carry + bv[s];
        store(hb + t * hst, carry);
      }
    }
  }
}

// Stage k % kStages of the ring: tile k of a and of b (steps k Tc ..),
// announced on its mbarrier.
template <typename T, int W>
__device__ __forceinline__ void load_stage(T* ring, uint64_t* full,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb, int k,
                                           int c0, int bi) {
  constexpr int kTc = Ring<T, W>::kTc;
  const int s = k % kStages;
  T* at = ring + s * 2 * kTc * W;
  sm90::mbar_expect_tx(&full[s], 2 * kTileBytes);
  sm90::tma_load_3d(at, ta, &full[s], c0, k * kTc, bi);
  sm90::tma_load_3d(at + kTc * W, tb, &full[s], c0, k * kTc, bi);
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb,
             const __grid_constant__ CUtensorMap th,
             const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ h, int C, int T_len, long long asb,
             long long ast, long long bsb, long long bst, long long hsb,
             long long hst, int tma) {
  constexpr int kTc = Ring<T, W>::kTc;
  const int lane = threadIdx.x;
  const int bi = blockIdx.y;
  const int c0 = blockIdx.x * W;
  const bool live = lane < W && c0 + lane < C;
  if (!tma) {
    if (live)
      scan_direct(a + bi * asb + c0 + lane, ast, b + bi * bsb + c0 + lane,
                  bst, h + bi * hsb + c0 + lane, hst, T_len);
    return;
  }
  __shared__ uint64_t full[kStages];
  // TMA reads and writes 128-byte-aligned tiles.
  T* ring = reinterpret_cast<T*>(
      smem_raw + ((128 - sm90::smem_u32(smem_raw) % 128) % 128));
  const int n_tiles = (T_len + kTc - 1) / kTc;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
    for (int k = 0; k < kStages - 1 && k < n_tiles; ++k)
      load_stage<T, W>(ring, full, &ta, &tb, k, c0, bi);
  }
  __syncwarp();
  float carry = 0.0f;
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kStages;
    sm90::mbar_wait(&full[s], (k / kStages) & 1);
    // h_t overwrites a_t in the stage's tile of a, which TMA then stores.
    T* at = ring + s * 2 * kTc * W;
    const T* bt = at + kTc * W;
    const int steps = T_len - k * kTc < kTc ? T_len - k * kTc : kTc;
    if (live) {
      for (int j0 = 0; j0 < steps; j0 += kUnroll) {
        float av[kUnroll], bv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          av[u] = to_f32(at[(j0 + u) * W + lane]);
          bv[u] = to_f32(bt[(j0 + u) * W + lane]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 + u < steps) {
            carry = av[u] * carry + bv[u];
            store(at + (j0 + u) * W + lane, carry);
          }
        }
      }
    }
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      sm90::tma_store_3d(&th, at, c0, k * kTc, bi);
      sm90::bulk_commit();
      // Refill the stage of tile k - 1 once its store has read it (this
      // tile's may still be reading): kStages - 2 tiles stay in flight.
      const int next = k - 1 + kStages;
      if (k >= 1 && next < n_tiles) {
        sm90::bulk_wait_read<1>();
        load_stage<T, W>(ring, full, &ta, &tb, next, c0, bi);
      } else if (k == 0 && kStages - 1 < n_tiles) {
        load_stage<T, W>(ring, full, &ta, &tb, kStages - 1, c0, bi);
      }
    }
  }
  if (lane == 0) sm90::bulk_wait_all();
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ g, float* __restrict__ da,
                 float* __restrict__ db, int C, int T_len, long long asb,
                 long long ast, long long hsb, long long hst, long long gsb,
                 long long gst, long long dasb, long long dast,
                 long long dbsb, long long dbst) {
  const int c = blockIdx.x * kBwdThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= C) return;
  const T* ab = a + bi * asb + c;
  const T* hb = h + bi * hsb + c;
  const T* gb = g + bi * gsb + c;
  float* dab = da + bi * dasb + c;
  float* dbb = db + bi * dbsb + c;
  float lam = 0.0f, a_next = 0.0f;   // lam_{t+1} and a_{t+1}
  for (int t0 = T_len - 1; t0 >= 0; t0 -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const long long t = t0 - s;
      av[s] = t >= 0 ? to_f32(ab[t * ast]) : 0.0f;
      gv[s] = t >= 0 ? to_f32(gb[t * gst]) : 0.0f;
      hv[s] = t >= 1 ? to_f32(hb[(t - 1) * hst]) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const long long t = t0 - s;
      if (t >= 0) {
        lam = a_next * lam + gv[s];
        dbb[t * dbst] = lam;
        dab[t * dast] = lam * hv[s];
        a_next = av[s];
      }
    }
  }
}

template <typename T, int W>
int launch_width(const void* a, const void* b, void* h, int B, int T_len,
                 int C, const long long* st, int tma, cudaStream_t stream);

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int T_len, int C,
           const long long* st, int width, int tma, cudaStream_t stream) {
  if (width == 32)
    return launch_width<T, 32>(a, b, h, B, T_len, C, st, tma, stream);
  if (width == 16)
    return launch_width<T, 16>(a, b, h, B, T_len, C, st, tma, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int W>
int launch_width(const void* a, const void* b, void* h, int B, int T_len,
                 int C, const long long* st, int tma, cudaStream_t stream) {
  CUtensorMap ta{}, tb{}, th{};
  if (tma) {
    constexpr CUtensorMapDataType kType =
        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const long long es = sizeof(T);
    const void* ptrs[3] = {a, b, h};
    CUtensorMap* maps[3] = {&ta, &tb, &th};
    for (int i = 0; i < 3; ++i) {
      const long long geom[8] = {C, T_len, B, st[2 * i + 1] * es,
                                 st[2 * i] * es, W, Ring<T, W>::kTc, 1};
      const int err = sm90::encode_3d(maps[i], kType, ptrs[i], geom);
      if (err != 0) return err;
    }
    // The ring's shared memory, allowed once per device (a bit of
    // `allowed` each): the attribute outlives the launch.
    static std::atomic<unsigned long long> allowed{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(allowed.load(std::memory_order_relaxed) & bit)) {
      e = cudaFuncSetAttribute(rglru_kernel<T, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
      if (e != cudaSuccess) return (int)e;
      allowed.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  const dim3 grid((C + W - 1) / W, B);
  rglru_kernel<T, W><<<grid, kThreads, tma ? kSmem : 0, stream>>>(
      ta, tb, th, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(h), C, T_len, st[0], st[1], st[2], st[3], st[4],
      st[5], tma);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* g, float* da,
               float* db, int B, int T_len, int C, const long long* st,
               cudaStream_t stream) {
  const dim3 grid((C + kBwdThreads - 1) / kBwdThreads, B);
  rglru_bwd_kernel<T><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(g), da, db, C, T_len, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// dtype (a, b, h): 0 = float32, 1 = bfloat16.  strides: 6 element strides
// (batch, time) of a, b, h in that order.  width: the channels of a block,
// 16 or 32.  tma: 1 streams a and b in and h out by TMA (base addresses
// and the batch and time strides of a, b and h 16-byte aligned), 0 takes
// the direct path.  Returns a cudaError_t (0 on success; 1,
// cudaErrorInvalidValue, for a dtype or width without an instantiation),
// or sm90.cuh's tensor-map error codes.
int rglru_launch(int dtype, const void* a, const void* b, void* h, int B,
                 int T, int C, const long long* strides, int width, int tma,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, h, B, T, C, strides, width, tma, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h, B, T, C, strides, width, tma, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dtype (a, h, g): 0 = float32, 1 = bfloat16; da and db
// float32.  strides: 10 element strides (batch, time) of a, h, g, da, db in
// that order.  Returns a cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for a dtype without an instantiation.
int rglru_bwd_launch(int dtype, const void* a, const void* h, const void* g,
                     float* da, float* db, int B, int T, int C,
                     const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(a, h, g, da, db, B, T, C, strides, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, h, g, da, db, B, T, C, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* rglru_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
