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
// design is the forward's, walked from the last tile down: one warp over
// W channels of one row, a ring of kStages stages of [Tc x W] tiles of a,
// h and g brought in by 3-D TMA, Tc = kTileBytes / (W x 4) (the steps of
// a float32 tile, for either input type).  h's box starts one step early
// (time coordinate k Tc - 1), so row j of its tile is h_{t-1} for t =
// k Tc + j, and TMA's zero fill past the tensor's start gives h_{-1} = 0
// as the plain loop has it.  a_{t+1} is carried across tiles in a
// register.  da and db go out by one TMA store each a tile: over the h and
// g tiles they were computed from (float32 inputs), or into two float32
// tiles of their own (bf16 inputs, whose tiles are half as wide).  A stage
// is refilled once its stores have read it, as in the forward.  Where TMA
// cannot address an operand (T = 1; a base address or a batch or time
// stride not a multiple of 16 bytes; rows that overlap) each lane walks
// its channel straight from device memory, kUnroll steps of loads ahead,
// with the same result bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 32;        // the forward: one warp a block
constexpr int kStages = 4;          // the forward's TMA ring
constexpr int kTileBytes = 8192;    // one operand's tile of a stage
constexpr int kSmem = 2 * kStages * kTileBytes + 128;   // + alignment
constexpr int kUnroll = 8;

// Steps of a stage's tile for W channels of T.
template <typename T, int W>
struct Ring {
  static constexpr int kTc = kTileBytes / (W * static_cast<int>(sizeof(T)));
  static_assert(kTc % kUnroll == 0 && kTc <= 256, "TMA box rows");
};

// The backward's stage for W channels of input type T: tiles of a, h and g
// (kIn bytes each), then, for bf16 inputs, float32 tiles of da and db
// (kTileBytes each); float32 inputs write da and db over h and g.  Tc is
// a float32 tile's steps for either type.
template <typename T, int W>
struct BwdRing {
  static constexpr int kTc = kTileBytes / (W * 4);
  static constexpr int kIn = kTc * W * static_cast<int>(sizeof(T));
  static constexpr bool kInPlace = sizeof(T) == 4;
  static constexpr int kDa = kInPlace ? kIn : 3 * kIn;
  static constexpr int kDb = kInPlace ? 2 * kIn : 3 * kIn + kTileBytes;
  static constexpr int kStage = kInPlace ? 3 * kIn : 3 * kIn + 2 * kTileBytes;
  static constexpr int kSmem = kStages * kStage + 128;   // + alignment
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

// One channel's backward straight from device memory (the direct path).
template <typename T>
__device__ __forceinline__ void bwd_direct(const T* ab, long long ast,
                                           const T* hb, long long hst,
                                           const T* gb, long long gst,
                                           float* dab, long long dast,
                                           float* dbb, long long dbst,
                                           int T_len) {
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

// Stage q % kStages of the backward's ring: tile k = n_tiles - 1 - q of a
// and g (steps k Tc ..) and of h one step earlier, on its mbarrier.
template <typename T, int W>
__device__ __forceinline__ void load_bwd_stage(uint8_t* ring, uint64_t* full,
                                               const CUtensorMap* ta,
                                               const CUtensorMap* th,
                                               const CUtensorMap* tg, int q,
                                               int n_tiles, int c0, int bi) {
  using R = BwdRing<T, W>;
  const int s = q % kStages;
  const int t0 = (n_tiles - 1 - q) * R::kTc;
  uint8_t* st = ring + s * R::kStage;
  sm90::mbar_expect_tx(&full[s], 3 * R::kIn);
  sm90::tma_load_3d(st, ta, &full[s], c0, t0, bi);
  sm90::tma_load_3d(st + R::kIn, th, &full[s], c0, t0 - 1, bi);
  sm90::tma_load_3d(st + 2 * R::kIn, tg, &full[s], c0, t0, bi);
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap th,
                 const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tda,
                 const __grid_constant__ CUtensorMap tdb,
                 const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ g, float* __restrict__ da,
                 float* __restrict__ db, int C, int T_len, long long asb,
                 long long ast, long long hsb, long long hst, long long gsb,
                 long long gst, long long dasb, long long dast,
                 long long dbsb, long long dbst, int tma) {
  using R = BwdRing<T, W>;
  constexpr int kTc = R::kTc;
  const int lane = threadIdx.x;
  const int bi = blockIdx.y;
  const int c0 = blockIdx.x * W;
  const bool live = lane < W && c0 + lane < C;
  if (!tma) {
    const int c = c0 + lane;
    if (live)
      bwd_direct(a + bi * asb + c, ast, h + bi * hsb + c, hst,
                 g + bi * gsb + c, gst, da + bi * dasb + c, dast,
                 db + bi * dbsb + c, dbst, T_len);
    return;
  }
  __shared__ uint64_t full[kStages];
  uint8_t* ring =
      smem_raw + ((128 - sm90::smem_u32(smem_raw) % 128) % 128);
  const int n_tiles = (T_len + kTc - 1) / kTc;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
    for (int q = 0; q < kStages - 1 && q < n_tiles; ++q)
      load_bwd_stage<T, W>(ring, full, &ta, &th, &tg, q, n_tiles, c0, bi);
  }
  __syncwarp();
  float lam = 0.0f, a_next = 0.0f;   // lam_{t+1} and a_{t+1}
  for (int q = 0; q < n_tiles; ++q) {
    const int s = q % kStages;
    const int k = n_tiles - 1 - q;
    sm90::mbar_wait(&full[s], (q / kStages) & 1);
    uint8_t* st = ring + s * R::kStage;
    const T* at = reinterpret_cast<const T*>(st);
    const T* ht = reinterpret_cast<const T*>(st + R::kIn);
    const T* gt = reinterpret_cast<const T*>(st + 2 * R::kIn);
    float* dat = reinterpret_cast<float*>(st + R::kDa);
    float* dbt = reinterpret_cast<float*>(st + R::kDb);
    const int steps = T_len - k * kTc < kTc ? T_len - k * kTc : kTc;
    if (live) {
      // Groups of kUnroll steps from the top of the tile (row steps - 1)
      // down; rows of a group below 0 are skipped.
      for (int j0 = steps - 1; j0 >= 0; j0 -= kUnroll) {
        float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 - u >= 0 ? j0 - u : 0;
          av[u] = to_f32(at[j * W + lane]);
          gv[u] = to_f32(gt[j * W + lane]);
          hv[u] = to_f32(ht[j * W + lane]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 - u >= 0) {
            lam = a_next * lam + gv[u];
            dbt[(j0 - u) * W + lane] = lam;
            dat[(j0 - u) * W + lane] = lam * hv[u];
            a_next = av[u];
          }
        }
      }
    }
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      sm90::tma_store_3d(&tda, dat, c0, k * kTc, bi);
      sm90::tma_store_3d(&tdb, dbt, c0, k * kTc, bi);
      sm90::bulk_commit();
      // Refill the stage of tile q - 1 once its stores have read it (this
      // tile's may still be reading), as the forward does.
      const int next = q - 1 + kStages;
      if (q >= 1 && next < n_tiles) {
        sm90::bulk_wait_read<1>();
        load_bwd_stage<T, W>(ring, full, &ta, &th, &tg, next, n_tiles, c0,
                             bi);
      } else if (q == 0 && kStages - 1 < n_tiles) {
        load_bwd_stage<T, W>(ring, full, &ta, &th, &tg, kStages - 1,
                             n_tiles, c0, bi);
      }
    }
  }
  if (lane == 0) sm90::bulk_wait_all();
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
    static std::atomic<unsigned long long> allowed{0};
    const int err = sm90::allow_smem(rglru_kernel<T, W>, kSmem, allowed);
    if (err != 0) return err;
  }
  const dim3 grid((C + W - 1) / W, B);
  rglru_kernel<T, W><<<grid, kThreads, tma ? kSmem : 0, stream>>>(
      ta, tb, th, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(h), C, T_len, st[0], st[1], st[2], st[3], st[4],
      st[5], tma);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_bwd_width(const void* a, const void* h, const void* g, float* da,
                     float* db, int B, int T_len, int C, const long long* st,
                     int tma, cudaStream_t stream) {
  using R = BwdRing<T, W>;
  CUtensorMap maps[5] = {};
  if (tma) {
    constexpr CUtensorMapDataType kType =
        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const void* ptrs[5] = {a, h, g, da, db};
    for (int i = 0; i < 5; ++i) {
      const long long es = i < 3 ? (long long)sizeof(T) : 4;
      const long long geom[8] = {C, T_len, B, st[2 * i + 1] * es,
                                 st[2 * i] * es, W, R::kTc, 1};
      const int err = sm90::encode_3d(
          &maps[i], i < 3 ? kType : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptrs[i],
          geom);
      if (err != 0) return err;
    }
    static std::atomic<unsigned long long> allowed{0};
    const int err =
        sm90::allow_smem(rglru_bwd_kernel<T, W>, R::kSmem, allowed);
    if (err != 0) return err;
  }
  const dim3 grid((C + W - 1) / W, B);
  rglru_bwd_kernel<T, W><<<grid, kThreads, tma ? R::kSmem : 0, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const T*>(a),
      static_cast<const T*>(h), static_cast<const T*>(g), da, db, C, T_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      tma);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* g, float* da,
               float* db, int B, int T_len, int C, const long long* st,
               int width, int tma, cudaStream_t stream) {
  if (width == 32)
    return launch_bwd_width<T, 32>(a, h, g, da, db, B, T_len, C, st, tma,
                                   stream);
  if (width == 16)
    return launch_bwd_width<T, 16>(a, h, g, da, db, B, T_len, C, st, tma,
                                   stream);
  return (int)cudaErrorInvalidValue;
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
// that order.  width: the channels of a block, 16 or 32.  tma: 1 streams a,
// h and g in and da and db out by TMA (base addresses and the batch and
// time strides of all five 16-byte aligned), 0 takes the direct path.
// Returns a cudaError_t (0 on success; 1, cudaErrorInvalidValue, for a
// dtype or width without an instantiation), or sm90.cuh's tensor-map error
// codes.
int rglru_bwd_launch(int dtype, const void* a, const void* h, const void* g,
                     float* da, float* db, int B, int T, int C,
                     const long long* strides, int width, int tma,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(a, h, g, da, db, B, T, C, strides, width, tma,
                             s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, h, g, da, db, B, T, C, strides,
                                     width, tma, s);
  return (int)cudaErrorInvalidValue;
}

const char* rglru_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
