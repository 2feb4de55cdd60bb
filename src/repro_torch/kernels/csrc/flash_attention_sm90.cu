// Flash-attention forward for Hopper (sm_90a), bf16: wgmma on tiles that
// TMA brings into shared memory.  Hand-written CUDA.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhtd
// (_fa_kernel; pl.pallas_call at :130) for bf16 inputs; float32 inputs go to
// flash_attention.cu (float32 FMAs), because wgmma on float32 is TF32.  Same
// function as there: scores in float32 with scale 1/sqrt(hd); masked entries
// (causal: key > query; window w > 0: key <= query - w; keys past Tk) set to
// -1e30; an online max and denominator per query row; o = acc / max(l,
// 1e-30) rounded to bf16; optionally lse = m + log(max(l, 1e-30)) in
// float32.  Query and key positions both count from 0.  GQA: query head h
// reads key/value head h / (H / Hkv).  One difference in rounding: the
// probabilities are rounded to bf16 before O += P V (as FlashAttention-2
// and -3 do); the plain version keeps them in float32.
//
// What bounds it on this card.  4 hd operations per reachable (query, key)
// pair and head against reading q, k, v and writing o once: bound by the
// tensor cores' 989 TFLOP/s bf16 rate at every serving and training shape
// (one causal qwen3-0.6b layer, B 8 x T 2,048: 0.139 ms).
//
// What this design does about it.  Both products run on the tensor cores
// (wgmma m64nNk16, float32 accumulators), fed from shared memory without
// a thread touching the tiles:
//   * one block of two warpgroups per (128-row query tile, head, batch
//     row); each warpgroup owns 64 query rows.  Query tiles are handed out
//     longest first (the last causal tile has the most keys), so causal
//     blocks leave no tail;
//   * one thread loads the Q tile and a ring of 2 K/V stages by TMA (4-D
//     tensor maps over the strided [B, T, H, hd] view, bounded by the
//     view's own T, so keys past Tk read as zeros and a longer cache
//     behind the view is never touched), 128-byte swizzled; it requests tile
//     i + 1 before the products of tile i;
//   * S = Q K^T with both operands in shared memory (K-major); the mask,
//     the online max and sum run on the accumulator fragment in
//     registers (the 4 threads of a row meet by shuffles); P is rounded to
//     bf16 and packed in registers as the A operand of O += P V, with V
//     read as an MN-major B, so neither P nor a transposed V exists in
//     memory;
//   * key tiles that the causal or window mask rules out for every row of
//     the block are never loaded; the mask runs only on tiles that cut it.
// Tiles: hd 64 and 128 take 128-key tiles (shared memory 80 / 160 KB), hd
// 256 64-key tiles (192 KB); one block an SM at hd 128 and 256.  Warp
// specialisation, register reallocation, persistent blocks and clusters
// are later work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kNegInf = -1.0e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBQ = 64 * kWarpgroups;   // query rows per block

template <int HD>
struct Fwd {
  static constexpr int kBK = HD == 256 ? 64 : 128;   // key rows per stage
  static constexpr int kBoxes = HD / 64;              // 64-column TMA boxes
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;       // one of K or V
  // Q, then 2 stages of (K, V); +1,024 to align the base for the swizzle.
  static constexpr int kSmem = kQBytes + 4 * kKVBytes + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int H, int Hkv, int Tq, int Tk, long long osb,
                      long long osh, long long ost, int causal, int window,
                      float scale_log2) {
  using C = Fwd<HD>;
  constexpr int kBK = C::kBK;
  constexpr int NS = kBK / 2;    // score accumulators a thread
  constexpr int NO = HD / 2;     // output accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q, bar_full[2], bar_empty[2];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK[2] = {sQ + C::kQBytes, sQ + C::kQBytes + 2 * C::kKVBytes};
  uint8_t* sV[2] = {sK[0] + C::kKVBytes, sK[1] + C::kKVBytes};

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;

  // Key tiles holding a key that some row of this block can reach.
  const int k_end = causal ? min(Tk, q0 + kBQ) : Tk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  const int n = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], kThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();
  auto load_kv = [&](int stage, int k0) {
    mbar_expect_tx(&bar_full[stage], 2 * C::kKVBytes);
    for (int x = 0; x < C::kBoxes; ++x) {
      tma_load_4d(sK[stage] + x * kBK * 128, &tk, &bar_full[stage], 64 * x,
                  k0, hk, b);
      tma_load_4d(sV[stage] + x * kBK * 128, &tv, &bar_full[stage], 64 * x,
                  k0, hk, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&bar_q, C::kQBytes);
    for (int x = 0; x < C::kBoxes; ++x)
      tma_load_4d(sQ + x * kBQ * 128, &tq, &bar_q, 64 * x, q0, h, b);
    if (n > 0) load_kv(0, k_begin);
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};     // this thread's share of the row sums
  // this thread's rows: row0 and row0 + 8
  const int row0 = q0 + 64 * wg + acc_row(t, 0);
  const uint32_t q_addr = smem_u32(sQ) + wg * 64 * 128;
  mbar_wait(&bar_q, 0);

  for (int it = 0; it < n; ++it) {
    const int k0 = k_begin + it * kBK;
    const int s = it & 1;
    if (tid == 0 && it + 1 < n) {
      if (it >= 1) mbar_wait(&bar_empty[s ^ 1], ((it - 1) >> 1) & 1);
      load_kv(s ^ 1, k0 + kBK);
    }
    mbar_wait(&bar_full[s], (it >> 1) & 1);

    // S = Q K^T: HD / 16 k-steps, 4 in each 64-column box.
    float sc[NS];
    const uint32_t k_addr = smem_u32(sK[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t da = make_desc(
          q_addr + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db = make_desc(
          k_addr + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024);
      wgmma_ss<kBK>(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc<NS>(sc);

    // Scale into the exp2 domain and mask, where the tile cuts the mask.
    const bool cut = k0 + kBK > Tk || (causal && k0 + kBK - 1 > q0) ||
                     (window > 0 && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      const float x = sc[r] * scale_log2;
      sc[r] = cut && hidden(row0 + 8 * ((r % 4) / 2), k0 + acc_col(t, r), Tk,
                            causal, window)
                  ? kNegInf
                  : x;
    }
    // Online max and sum over each row's 4 threads.
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * j + 2 * i + e] - m_new);
          sc[4 * j + 2 * i + e] = p;
          sum += p;
        }
      }
      l[i] = l[i] * corr[i] + sum;
    }
#pragma unroll
    for (int r = 0; r < NO; ++r) acc[r] *= corr[(r % 4) / 2];
    // P in bf16, packed as the A operand: k-step kk takes accumulator
    // registers 8 kk .. 8 kk + 7.
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[kk][i] = pack_bf16x2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

    // O += P V: V is the MN-major B operand, 16 keys a k-step.
    const uint32_t v_addr = smem_u32(sV[s]);
    fence_acc<NO>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<HD>(acc, pf[kk], make_desc(v_addr + kk * 2048, kBK * 128, 1024),
                   1);
    wgmma_commit();
    wgmma_wait0();
    fence_acc<NO>(acc);
    mbar_arrive(&bar_empty[s]);   // this thread is done with the stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = o + b * osb + h * osh + (long long)row * ost;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * (t % 4)) =
          pack_bf16x2(acc[4 * j + 2 * i] / lc, acc[4 * j + 2 * i + 1] / lc);
    if (lse != nullptr && t % 4 == 0)
      lse[((long long)b * H + h) * Tq + row] = m[i] * kLn2 + logf(lc);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Tq, int Tk, const long long* geom,
           const long long* ostr, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Fwd<HD>;
  // the boxes the wrapper computed must be the kernel's tiles
  if (geom[7] != 64 || geom[8] != kBQ || geom[16] != 64 ||
      geom[17] != C::kBK || geom[25] != 64 || geom[26] != C::kBK)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = encode_bf16_4d(&tq, q, geom);
  if (err == 0) err = encode_bf16_4d(&tk, k, geom + 9);
  if (err == 0) err = encode_bf16_4d(&tv, v, geom + 18);
  if (err != 0) return err;
  auto kernel = flash_fwd_sm90_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Tq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, H, Hkv, Tq, Tk,
      ostr[0], ostr[1], ostr[2], causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// bf16 q, k, v, o; hd 64, 128 or 256.  geom: for each of q, k, v, 9 values
// (dims (hd, T, heads, B), byte strides of T, heads and B, box columns and
// rows) of its TMA map.  ostrides: o's element strides (batch, head,
// time).  lse may be null.  Returns a cudaError_t (0 on success), 1
// (cudaErrorInvalidValue) for an hd or box the kernel does not take, or a
// tensor-map error (flash_attention_sm90_error_string).
int flash_attention_sm90_launch(int hd, const void* q, const void* k,
                                const void* v, void* o, float* lse, int B,
                                int H, int Hkv, int Tq, int Tk,
                                const long long* geom,
                                const long long* ostrides, int causal,
                                int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, geom, ostrides,
                      causal, window, scale, s);
  if (hd == 128)
    return launch<128>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, geom, ostrides,
                       causal, window, scale, s);
  if (hd == 256)
    return launch<256>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, geom, ostrides,
                       causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_sm90_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
