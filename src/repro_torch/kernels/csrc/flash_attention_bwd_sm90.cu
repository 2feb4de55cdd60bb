// Flash-attention backward for Hopper (sm_90a), bf16: wgmma on tiles that
// TMA brings into shared memory.  Hand-written CUDA.
//
// Replaces the JAX package's Pallas TPU kernels
// src/repro/kernels/flash_attention/flash_attention_bwd.py::
// flash_attention_bwd_bhtd (_dq_kernel, pl.pallas_call at :151, and
// _dkdv_kernel, at :172) for bf16 inputs; float32 inputs go to
// flash_attention_bwd.cu (float32 FMAs), because wgmma on float32 is TF32.
// Same function as there, from the forward's saved log-sum-exp: with
// s = q.k^T * scale (scale 1/sqrt(hd)), the forward's masks,
// p = exp(s - lse) (0 where masked) and delta = rowsum(dO o o) (computed by
// the wrapper in float32):
//   dp = dO.v^T,  ds = p o (dp - delta) * scale,
//   dq = ds.k,    dk = ds^T.q,    dv = p^T.dO.
// Key j sits at position j and query row i at q_offset + i (the forward's
// positions, flash_attention_sm90.cu).  GQA: dk and dv are summed over each
// key/value head's group of query heads in float32 registers; a key tile
// that no query reaches (past the last query, under the causal mask) is
// written as zeros.  p and ds are rounded to bf16 before their products
// (as FlashAttention-2 and -3 do); the plain version keeps them in float32.
// Deterministic: no atomics, every output element is written once.
//
// What bounds it on this card.  Five products per reachable (query, key)
// pair and query head, 10 hd operations, against reading q, k, v, o, dO,
// lse once and writing dq, dk, dv once: bound by the tensor cores' 989
// TFLOP/s bf16 rate (one causal qwen3-0.6b layer, B 8 x T 2,048: 0.348 ms).
//
// What this design does about it.  All seven products of its two kernels
// run on the tensor cores (wgmma m64nNk16, float32 accumulators), on tiles
// that one thread loads by TMA (4-D tensor maps over the strided views,
// 128-byte swizzled) into a ring of 2 stages, the next tile requested before
// the products of the current one.  Both kernels recompute s and dp (14 hd
// operations per pair where the function needs 10), which keeps them free
// of atomics and deterministic; one fused pass would need float32 atomics
// on dq.
//   dq:    one block of two warpgroups per (128-row query tile, query
//          head, batch row), query tiles longest first; a loop over 64-row
//          K/V tiles.  S = Q K^T and dP = dO V^T from shared memory
//          (K-major), p and ds on the accumulator fragments, dQ += dS K
//          with dS packed in registers as the A operand and K read as an
//          MN-major B.
//   dk/dv: one block of two warpgroups per (128-row key tile, key/value
//          head, batch row); each warpgroup owns 64 keys.  A loop over the
//          group's query heads and the 64-row query tiles that reach the
//          key tile (their lse and delta come in by TMA beside Q and dO).
//          S^T = K Q^T and dP^T = V dO^T from shared memory, then
//          dV += P^T dO and dK += dS^T Q with P^T and dS^T in registers and
//          dO, Q read as MN-major B operands.
// Query / key tiles that the mask rules out for a whole block are never
// loaded; the mask runs only on tiles that cut it.
// Head widths 64, 128 and 256.  At 256 the hd-128 tiling needs 263 KB of
// shared memory a block and 256 dk/dv accumulators a thread, over the
// 227 KB and 255 registers there are.  So each block owns half of the
// output columns (128 of dq, or of dk and dv): it still reduces S and dP
// over all 256 (twice the k-steps, no more registers), and grids hold two
// blocks per tile, head and row.  Its tiles keep their rows, with one K/V
// (dq) or Q/dO (dk/dv) stage instead of two: 197,632 and 198,144 bytes.
// The price: S and dP are computed twice over (22 hd operations per pair
// where hd 128 takes 14), and the single stage does not overlap a tile's
// load with the previous tile's products.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
// dq kernel: 128 query rows a block, 64-row K/V stages
constexpr int kQBQ = 64 * kWarpgroups;
constexpr int kQBK = 64;
// dk/dv kernel: 128 key rows a block, 64-row Q/dO stages
constexpr int kKBK = 64 * kWarpgroups;
constexpr int kKBQ = 64;

template <int HD>
struct Bwd {
  static constexpr int kBoxes = HD / 64;
  // blocks per tile along the output columns, the columns each owns, and
  // the stages of the ring
  static constexpr int kSplit = HD > 128 ? 2 : 1;
  static constexpr int kOut = HD / kSplit;
  static constexpr int kStages = HD > 128 ? 1 : 2;
  // dq: Q, dO, then kStages stages of (K, V)
  static constexpr int kDqQ = kQBQ * HD * 2;
  static constexpr int kDqKV = kQBK * HD * 2;
  static constexpr int kDqSmem = 2 * kDqQ + 2 * kStages * kDqKV + 1024;
  // dk/dv: K, V, then kStages stages of (Q, dO), then kStages of (lse,
  // delta)
  static constexpr int kKvK = kKBK * HD * 2;
  static constexpr int kKvQ = kKBQ * HD * 2;
  static constexpr int kKvSmem =
      2 * kKvK + 2 * kStages * kKvQ + 2 * kStages * kKBQ * 4 + 1024;
};

// Element strides (batch, head, time) of dq, dk, dv.
struct OutStrides {
  long long dq[3], dk[3], dv[3];
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, int pitch,
                         __nv_bfloat16* __restrict__ dq, int H, int Hkv,
                         int Tq, int Tk, OutStrides st, int causal,
                         int window, float scale, int q_offset) {
  using C = Bwd<HD>;
  constexpr int NS = kQBK / 2;       // s / dp accumulators a thread
  constexpr int NO = C::kOut / 2;    // dq accumulators a thread
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_full[kStages], bar_empty[kStages];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sO = sQ + C::kDqQ;    // dO
  uint8_t* sK[kStages];
  uint8_t* sV[kStages];
  for (int s = 0; s < kStages; ++s) {
    sK[s] = sO + C::kDqQ + 2 * s * C::kDqKV;
    sV[s] = sK[s] + C::kDqKV;
  }

  const int h = blockIdx.x / C::kSplit;
  const int c0 = (blockIdx.x % C::kSplit) * C::kOut;   // first dq column
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kQBQ;   // longest first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;

  // Key tiles that some row of this block (positions p0 .. p0 + kQBQ - 1)
  // can reach.
  const int p0 = q_offset + q0;
  const int k_end = causal ? min(Tk, p0 + kQBQ) : Tk;
  int k_begin = window > 0 ? max(0, p0 - window + 1) : 0;
  k_begin = (k_begin / kQBK) * kQBK;
  const int n = k_end > k_begin ? (k_end - k_begin + kQBK - 1) / kQBK : 0;

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], kThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();
  auto load_kv = [&](int stage, int k0) {
    mbar_expect_tx(&bar_full[stage], 2 * C::kDqKV);
    for (int x = 0; x < C::kBoxes; ++x) {
      tma_load_4d(sK[stage] + x * kQBK * 128, &tk, &bar_full[stage], 64 * x,
                  k0, hk, b);
      tma_load_4d(sV[stage] + x * kQBK * 128, &tv, &bar_full[stage], 64 * x,
                  k0, hk, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&bar_q, 2 * C::kDqQ);
    for (int x = 0; x < C::kBoxes; ++x) {
      tma_load_4d(sQ + x * kQBQ * 128, &tq, &bar_q, 64 * x, q0, h, b);
      tma_load_4d(sO + x * kQBQ * 128, &tdo, &bar_q, 64 * x, q0, h, b);
    }
    for (int j = 0; j < kStages - 1 && j < n; ++j)
      load_kv(j, k_begin + j * kQBK);
  }

  const int row0 = q0 + 64 * wg + acc_row(t, 0);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long r = ((long long)b * H + h) * pitch + row;
    row_lse[i] = row < Tq ? lse[r] * kLog2e : 0.0f;
    row_delta[i] = row < Tq ? delta[r] : 0.0f;
  }
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  const uint32_t q_addr = smem_u32(sQ) + wg * 64 * 128;
  const uint32_t o_addr = smem_u32(sO) + wg * 64 * 128;
  const float scale_log2 = scale * kLog2e;
  mbar_wait(&bar_q, 0);

  for (int it = 0; it < n; ++it) {
    const int k0 = k_begin + it * kQBK;
    const int s = it % kStages;
    // request tile j = it + kStages - 1 once its stage is free (tile j -
    // kStages consumed)
    const int j = it + kStages - 1;
    if (tid == 0 && j < n) {
      if (j >= kStages)
        mbar_wait(&bar_empty[j % kStages], (j / kStages - 1) & 1);
      load_kv(j % kStages, k_begin + j * kQBK);
    }
    mbar_wait(&bar_full[s], (it / kStages) & 1);

    // S = Q K^T and dP = dO V^T.
    float sc[NS], dp[NS];
    const uint32_t k_addr = smem_u32(sK[s]);
    const uint32_t v_addr = smem_u32(sV[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t qoff = (kk / 4) * kQBQ * 128 + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kQBK * 128 + (kk % 4) * 32;
      wgmma_ss<kQBK>(sc, make_desc(q_addr + qoff, 16, 1024),
                     make_desc(k_addr + koff, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t qoff = (kk / 4) * kQBQ * 128 + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kQBK * 128 + (kk % 4) * 32;
      wgmma_ss<kQBK>(dp, make_desc(o_addr + qoff, 16, 1024),
                     make_desc(v_addr + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc<NS>(sc);
    fence_acc<NS>(dp);

    // p = exp(s scale - lse), ds = p (dp - delta) scale, packed in bf16 as
    // the A operand of dQ += dS K.
    const bool cut = k0 + kQBK > Tk || (causal && k0 + kQBK - 1 > p0) ||
                     (window > 0 && k0 <= p0 + kQBQ - 1 - window);
    uint32_t df[kQBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kQBK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * kk + 2 * i + e;
          const int ri = (r % 4) / 2;
          const bool hide =
              cut && hidden(q_offset + row0 + 8 * ri, k0 + acc_col(t, r), Tk,
                            causal, window);
          const float p =
              hide ? 0.0f : exp2f(sc[r] * scale_log2 - row_lse[ri]);
          ds[e] = p * (dp[r] - row_delta[ri]) * scale;
        }
        df[kk][i] = pack_bf16x2(ds[0], ds[1]);
      }
    }

    // dQ += dS K: K's columns c0.. as the MN-major B operand, 16 keys a
    // k-step.
    fence_acc<NO>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQBK / 16; ++kk)
      wgmma_rs<C::kOut>(acc, df[kk],
                        make_desc(k_addr + (c0 / 64) * kQBK * 128 + kk * 2048,
                                  kQBK * 128, 1024),
                        1);
    wgmma_commit();
    wgmma_wait0();
    fence_acc<NO>(acc);
    mbar_arrive(&bar_empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Tq) continue;
    __nv_bfloat16* out =
        dq + b * st.dq[0] + h * st.dq[1] + (long long)row * st.dq[2] + c0;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * (t % 4)) =
          pack_bf16x2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tlse,
                           const __grid_constant__ CUtensorMap tdelta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Hkv,
                           int Tq, int Tk, OutStrides st, int causal,
                           int window, float scale, int q_offset) {
  using C = Bwd<HD>;
  constexpr int NS = kKBQ / 2;       // s^T / dp^T accumulators a thread
  constexpr int NO = C::kOut / 2;    // dk and dv accumulators a thread, each
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_k, bar_full[kStages], bar_empty[kStages];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = sK + C::kKvK;
  float* sL = reinterpret_cast<float*>(sV + C::kKvK + 2 * kStages * C::kKvQ);
  uint8_t* sQ[kStages];
  uint8_t* sO[kStages];   // dO
  float* sLse[kStages];
  float* sDel[kStages];
  for (int s = 0; s < kStages; ++s) {
    sQ[s] = sV + C::kKvK + 2 * s * C::kKvQ;
    sO[s] = sQ[s] + C::kKvQ;
    sLse[s] = sL + s * kKBQ;
    sDel[s] = sL + (kStages + s) * kKBQ;
  }

  const int hk = blockIdx.x / C::kSplit;
  const int c0 = (blockIdx.x % C::kSplit) * C::kOut;   // first dk/dv column
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kKBK;   // causal: the first key tiles are
                                      // the longest
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;

  // Query tiles holding a query that can reach some key of this block
  // (query row i at position q_offset + i); none past the last query.
  const int q_begin = causal ? (max(0, k0 - q_offset) / kKBQ) * kKBQ : 0;
  const int q_end =
      window > 0 ? min(Tq, max(0, k0 + kKBK + window - 1 - q_offset)) : Tq;
  const int nqt = q_end > q_begin ? (q_end - q_begin + kKBQ - 1) / kKBQ : 0;
  const int n = group * nqt;

  if (tid == 0) {
    mbar_init(&bar_k, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], kThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();
  auto load_q = [&](int stage, int i) {
    const int h = hk * group + i / nqt;
    const int q0 = q_begin + (i % nqt) * kKBQ;
    mbar_expect_tx(&bar_full[stage], 2 * C::kKvQ + 2 * kKBQ * 4);
    for (int x = 0; x < C::kBoxes; ++x) {
      tma_load_4d(sQ[stage] + x * kKBQ * 128, &tq, &bar_full[stage], 64 * x,
                  q0, h, b);
      tma_load_4d(sO[stage] + x * kKBQ * 128, &tdo, &bar_full[stage],
                  64 * x, q0, h, b);
    }
    tma_load_2d(sLse[stage], &tlse, &bar_full[stage], q0, b * H + h);
    tma_load_2d(sDel[stage], &tdelta, &bar_full[stage], q0, b * H + h);
  };
  if (tid == 0) {
    mbar_expect_tx(&bar_k, 2 * C::kKvK);
    for (int x = 0; x < C::kBoxes; ++x) {
      tma_load_4d(sK + x * kKBK * 128, &tk, &bar_k, 64 * x, k0, hk, b);
      tma_load_4d(sV + x * kKBK * 128, &tv, &bar_k, 64 * x, k0, hk, b);
    }
    for (int j = 0; j < kStages - 1 && j < n; ++j) load_q(j, j);
  }

  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  // this thread's keys: kpos0 and kpos0 + 8
  const int kpos0 = k0 + 64 * wg + acc_row(t, 0);
  const uint32_t k_addr = smem_u32(sK) + wg * 64 * 128;
  const uint32_t v_addr = smem_u32(sV) + wg * 64 * 128;
  const float scale_log2 = scale * kLog2e;
  mbar_wait(&bar_k, 0);

  for (int it = 0; it < n; ++it) {
    const int q0 = q_begin + (it % nqt) * kKBQ;
    const int s = it % kStages;
    // request tile j = it + kStages - 1 once its stage is free
    const int j = it + kStages - 1;
    if (tid == 0 && j < n) {
      if (j >= kStages)
        mbar_wait(&bar_empty[j % kStages], (j / kStages - 1) & 1);
      load_q(j % kStages, j);
    }
    mbar_wait(&bar_full[s], (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T.
    float sc[NS], dp[NS];
    const uint32_t q_addr = smem_u32(sQ[s]);
    const uint32_t o_addr = smem_u32(sO[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t koff = (kk / 4) * kKBK * 128 + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kKBQ * 128 + (kk % 4) * 32;
      wgmma_ss<kKBQ>(sc, make_desc(k_addr + koff, 16, 1024),
                     make_desc(q_addr + qoff, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t koff = (kk / 4) * kKBK * 128 + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * kKBQ * 128 + (kk % 4) * 32;
      wgmma_ss<kKBQ>(dp, make_desc(v_addr + koff, 16, 1024),
                     make_desc(o_addr + qoff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc<NS>(sc);
    fence_acc<NS>(dp);

    // p^T and ds^T on the fragments (rows keys, columns queries), packed
    // in bf16 as the A operands of dV += P^T dO and dK += dS^T Q.
    const bool cut = q0 + kKBQ > Tq || k0 + kKBK > Tk ||
                     (causal && k0 + kKBK - 1 > q_offset + q0) ||
                     (window > 0 && k0 <= q_offset + q0 + kKBQ - 1 - window);
    uint32_t pf[kKBQ / 16][4], df[kKBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKBQ / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * kk + 2 * i + e;
          const int col = acc_col(t, r);
          const int qi = q0 + col;
          const bool hide =
              cut && (qi >= Tq || hidden(q_offset + qi,
                                         kpos0 + 8 * ((r % 4) / 2), Tk,
                                         causal, window));
          p[e] = hide ? 0.0f
                      : exp2f(sc[r] * scale_log2 - sLse[s][col] * kLog2e);
          ds[e] = p[e] * (dp[r] - sDel[s][col]) * scale;
        }
        pf[kk][i] = pack_bf16x2(p[0], p[1]);
        df[kk][i] = pack_bf16x2(ds[0], ds[1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: dO's and Q's columns c0.. are
    // MN-major B operands, 16 queries a k-step.
    const uint32_t col_off = (c0 / 64) * kKBQ * 128;
    fence_acc<NO>(dv_acc);
    fence_acc<NO>(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKBQ / 16; ++kk)
      wgmma_rs<C::kOut>(
          dv_acc, pf[kk],
          make_desc(o_addr + col_off + kk * 2048, kKBQ * 128, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < kKBQ / 16; ++kk)
      wgmma_rs<C::kOut>(
          dk_acc, df[kk],
          make_desc(q_addr + col_off + kk * 2048, kKBQ * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_acc<NO>(dv_acc);
    fence_acc<NO>(dk_acc);
    mbar_arrive(&bar_empty[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kpos0 + 8 * i;
    if (kpos >= Tk) continue;
    __nv_bfloat16* krow = dk + b * st.dk[0] + hk * st.dk[1] +
                          (long long)kpos * st.dk[2] + c0;
    __nv_bfloat16* vrow = dv + b * st.dv[0] + hk * st.dv[1] +
                          (long long)kpos * st.dv[2] + c0;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int c = 8 * j + 2 * (t % 4);
      *reinterpret_cast<uint32_t*>(krow + c) =
          pack_bf16x2(dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(vrow + c) =
          pack_bf16x2(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, int pitch, void* dq,
           void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tk,
           const long long* geom, const long long* ostr, int causal,
           int window, float scale, int q_offset, cudaStream_t stream) {
  using C = Bwd<HD>;
  OutStrides st;
  for (int i = 0; i < 3; ++i) {
    st.dq[i] = ostr[i];
    st.dk[i] = ostr[3 + i];
    st.dv[i] = ostr[6 + i];
  }
  // geom: q, k, v, dO for the dq kernel, then q, k, v, dO for dk/dv (the
  // boxes differ), 9 values each; the boxes must be the kernels' tiles.
  const int rows[8] = {kQBQ, kQBK, kQBK, kQBQ, kKBQ, kKBK, kKBK, kKBQ};
  for (int i = 0; i < 8; ++i)
    if (geom[9 * i + 7] != 64 || geom[9 * i + 8] != rows[i])
      return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8], tlse, tdelta;
  const void* ptrs[4] = {q, k, v, dout};
  int err = 0;
  for (int i = 0; i < 8 && err == 0; ++i)
    err = encode_bf16_4d(&maps[i], ptrs[i % 4], geom + 9 * i);
  if (err == 0)
    err = encode_f32_2d(&tlse, lse, Tq, (long long)B * H, pitch, kKBQ);
  if (err == 0)
    err = encode_f32_2d(&tdelta, delta, Tq, (long long)B * H, pitch, kKBQ);
  if (err != 0) return err;

  auto dq_kernel = flash_bwd_dq_sm90_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<dim3(H * C::kSplit, B, (Tq + kQBQ - 1) / kQBQ), kThreads,
              C::kDqSmem,
              stream>>>(maps[0], maps[1], maps[2], maps[3], lse, delta,
                        pitch, static_cast<__nv_bfloat16*>(dq), H, Hkv, Tq,
                        Tk, st, causal, window, scale, q_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kv_kernel = flash_bwd_dkdv_sm90_kernel<HD>;
  e = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kKvSmem);
  if (e != cudaSuccess) return (int)e;
  kv_kernel<<<dim3(Hkv * C::kSplit, B, (Tk + kKBK - 1) / kKBK), kThreads,
              C::kKvSmem,
              stream>>>(maps[4], maps[5], maps[6], maps[7], tlse, tdelta,
                        static_cast<__nv_bfloat16*>(dk),
                        static_cast<__nv_bfloat16*>(dv), H, Hkv, Tq, Tk, st,
                        causal, window, scale, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// bf16 q, k, v, dO, dq, dk, dv; hd 64, 128 or 256.  lse and delta: float32
// [B, H, pitch] with pitch >= Tq a multiple of 4 (TMA's 16-byte rows).
// geom: 8 x 9 values, the TMA maps of q, k, v, dO for the dq kernel and
// again for the dk/dv kernel (dims (hd, T, heads, B), byte strides of T,
// heads and B, box columns and rows).  ostrides: 9 element strides (batch,
// head, time) of dq, dk, dv.  q_offset: the position of query row 0 (keys
// from 0).  Launches the dq kernel and then the dk/dv
// kernel on ``stream``.  Returns a cudaError_t (0 on success), 1
// (cudaErrorInvalidValue) for an hd or box the kernels do not take, or a
// tensor-map error (flash_attention_bwd_sm90_error_string).
int flash_attention_bwd_sm90_launch(int hd, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    int pitch, void* dq, void* dk, void* dv,
                                    int B, int H, int Hkv, int Tq, int Tk,
                                    const long long* geom,
                                    const long long* ostrides, int causal,
                                    int window, float scale, int q_offset,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, k, v, dout, lse, delta, pitch, dq, dk, dv, B, H,
                      Hkv, Tq, Tk, geom, ostrides, causal, window, scale,
                      q_offset, s);
  if (hd == 128)
    return launch<128>(q, k, v, dout, lse, delta, pitch, dq, dk, dv, B, H,
                       Hkv, Tq, Tk, geom, ostrides, causal, window, scale,
                       q_offset, s);
  if (hd == 256)
    return launch<256>(q, k, v, dout, lse, delta, pitch, dq, dk, dv, B, H,
                       Hkv, Tq, Tk, geom, ostrides, causal, window, scale,
                       q_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_sm90_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
