// RWKV-6 WKV recurrence for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/rwkv6/rwkv6.py::wkv_bhtd (_wkv_kernel; pl.pallas_call
// at :68).  Per (batch row, head), with the state S [64, 64] in float32:
//     y_t = r_t S + (r_t . (u o k_t)) v_t          (the old S)
//     S   = diag(w_t) S + k_t^T v_t
// r, k, v, w, y [B, H, T, 64] (any element strides, the last one 1), u
// [H, 64] float32.  All math is float32; y is rounded to r's type.  Beyond
// the TPU kernel, which starts from S = 0 and keeps S only in VMEM, this one
// takes an optional S0 [B, H, 64, 64] float32 (null: zeros) and always
// writes S_final [B, H, 64, 64] float32: serving hands the state from the
// prefill to decode, one token at a time.  r / k / v come in the
// activation type (float32 or bfloat16); w has its own type parameter,
// because the model keeps the decay in float32 (models/rwkv6.py:175-176: a
// bf16 decay near 1 loses the long memory).  Two kernels, chosen on the
// host from dtype and shapes (rwkv6.py, wkv_plan):
//
// wkv_chunk_kernel, the chunked route (bf16 r, k, v; T of a chunk or more;
// 16-byte aligned rows): the serving prefill.  Time runs in chunks of L =
// 64 steps from t0.  Writing P(a, b) = prod_{l=a..b} w_l (elementwise over
// the 64 key channels i; empty products 1):
//   inter-chunk   y_t += (r_t o P(t0, t-1)) S_t0           [64 x 64].[64 x NJ]
//   state         S_t0+L = diag(P(t0, t0+L-1)) S_t0 + kbar^T V,
//                 kbar_s = k_s o P(s+1, t0+L-1)            [64 x 64].[64 x NJ]
//   intra-chunk   y_t += sum_{s<t} A_ts v_s + bonus_t v_t,
//                 A_ts = sum_i r_ti k_si P(s+1, t-1)_i.
// A is cut into 16 x 16 blocks of 16-step sub-chunks.  For the rows of a
// sub-chunk after the columns of sub-chunk c (ending at m = 16 c + 15) the
// block is rhat khat^T with rhat_t = r_t o P(m+1, t-1) and khat_s = k_s o
// P(s+1, m), one [64 x 64].[64 x 16] product per c; the four diagonal
// blocks are summed on the CUDA cores.  So every scale factor is a product
// of decays, at most 1: there is no ratio, division or log/exp of a
// cumulative sum anywhere (the model's decays exp(-exp(x)) can be near 0,
// where a log-space ratio overflows float32 within a few steps).  The five
// products run on the tensor cores (wgmma m64nNk16, float32 accumulators).
// Their float32 operands (rhat, khat, kbar, A, S) are each split into bf16
// high and low parts, and the products summed as hi.hi + hi.lo + lo.hi (hi.v
// + lo.v where the other side is the exact bf16 v): about 16 bits of each
// operand, so S keeps ~1e-5 of its scale across chunks; S itself stays
// float32 in the accumulator registers, carried from chunk to chunk.
// A block is one warpgroup over one (b, h) and NJ = 32 or 64 columns j of
// S, v and y (the columns never mix): 64 / NJ blocks a head, so that B 1
// still fills the card.  Its chunk's r, k, v (its NJ columns) and w come
// in by cp.async (16 bytes a thread), the next chunk's while this one's
// products run.  A pass on the CUDA cores turns them into the products'
// operands: per channel i, the decay products within each sub-chunk
// (forward for rhat, backward for khat), the sub-chunks' own products G_d
// and their products GP(a, b) = G_a ... G_{b-1}, kbar as khat's walk times
// the later sub-chunks' G; V^T and the bonus.  rhat and the inter-chunk rows are
// formed in registers from (r o P(16 d, t-1)) x GP; A's blocks stay in
// registers from their product to A V (the accumulator layout of m64n16 is
// the A operand's of a k-step).  The diagonal blocks are summed while A's
// block products run; S^T's hi and lo tiles then go over the r and k
// tiles, which the pass has read (so a block at 64 columns takes ~102 KB
// and two fit an SM).  Every B operand is K-major with 128-byte rows (the
// reduction over 64 key channels or 64 steps), so a block's NJ columns are
// NJ rows of a tile.
//
// What bounds it on this card.  A step of one (b, h) is ~5 * 64^2 float32
// operations in the recurrent form, against 12 * 64 bytes in bf16 (r, k,
// v, y at 2 B, w at 4 B).  The chunked form moves those products to the
// tensor cores (with the split, ~80 GFLOP at B 8, T 2048, H 64: 0.08 ms at
// 989 TFLOP/s), below its bytes (814 MB: 0.24 ms at 3.35 TB/s): bound by
// bytes.  What it spends beyond that is the CUDA cores' pass over each
// chunk (the decay walks, the diagonal blocks, the operand splits): with
// two warpgroups an SM it is latency-bound, ~27k cycles a chunk a block
// on the H100 (PERF.md), of which the diagonal blocks take ~10k.
//
// wkv_kernel, the step route (float32 r, k, v; any type below a chunk,
// such as decode at T = 1; rows not 16-byte aligned): one block of 64 threads
// per (b, h); thread j holds column j of S (64 floats) in registers.  Time
// runs in chunks of kTC steps: the block stages r, k and w of a chunk in
// shared memory (double-buffered, so a chunk costs one barrier) together
// with the chunk's bonus scalars r.(u o k), reduced by warp shuffles.  Each
// thread then walks the chunk: for each i it reads S_ij once, adds r_i S_ij
// to y_j (four partial sums break the dependent chain) and writes w_i S_ij
// + k_i v_j back; v_j and y_j are its own column.  Bound by operations on
// the CUDA cores (5 hd^2 a step at 67 TFLOP/s); its per-step chain sets its
// time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kHD = 64;        // head width (rwkv6's, fixed)
constexpr int kThreads = 64;   // one per column of S
constexpr int kTC = 16;        // time steps staged per chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Strides {
  long long b, h, t;
};

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const TW* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ y, float* __restrict__ s_final, int H, int T_len,
           Strides rs, Strides ks, Strides vs, Strides ws, Strides ys) {
  // [buffer][step][i]: r_i, k_i, w_i of the staged chunk; bonus per step
  __shared__ __align__(16) float r_s[2][kTC][kHD];
  __shared__ __align__(16) float k_s[2][kTC][kHD];
  __shared__ __align__(16) float w_s[2][kTC][kHD];
  __shared__ float part_s[2][kTC][2];   // per-warp partial bonus sums

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;

  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const TW* wb = w + b * ws.b + h * ws.h;
  T* yb = y + b * ys.b + h * ys.h;
  const float uj = u[h * kHD + j];
  const long long sbase = (long long)bh * kHD * kHD;

  float S[kHD];   // column j: S[i] = S_ij
#pragma unroll
  for (int i = 0; i < kHD; ++i)
    S[i] = s0 == nullptr ? 0.0f : s0[sbase + (long long)i * kHD + j];

  for (int t0 = 0, c = 0; t0 < T_len; t0 += kTC, c ^= 1) {
    const int n = min(kTC, T_len - t0);
    // Stage the chunk: thread j loads element j of each step.  The buffer
    // written here was last read in the chunk before the previous one, and
    // every thread has passed the previous chunk's barrier since.
    for (int s = 0; s < n; ++s) {
      const long long t = t0 + s;
      const float rj = to_f32(rb[t * rs.t + j]);
      const float kj = to_f32(kb[t * ks.t + j]);
      r_s[c][s][j] = rj;
      k_s[c][s][j] = kj;
      w_s[c][s][j] = to_f32(wb[t * ws.t + j]);
      float p = rj * (uj * kj);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) part_s[c][s][warp] = p;
    }
    __syncthreads();

    for (int s = 0; s < n; ++s) {
      const long long t = t0 + s;
      const float vj = to_f32(vb[t * vs.t + j]);
      const float bonus = part_s[c][s][0] + part_s[c][s][1];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kHD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[c][s][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[c][s][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[c][s][i]);
        acc[0] = fmaf(r4.x, S[i], acc[0]);
        acc[1] = fmaf(r4.y, S[i + 1], acc[1]);
        acc[2] = fmaf(r4.z, S[i + 2], acc[2]);
        acc[3] = fmaf(r4.w, S[i + 3], acc[3]);
        S[i] = w4.x * S[i] + k4.x * vj;
        S[i + 1] = w4.y * S[i + 1] + k4.y * vj;
        S[i + 2] = w4.z * S[i + 2] + k4.z * vj;
        S[i + 3] = w4.w * S[i + 3] + k4.w * vj;
      }
      const float att = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      store(yb + t * ys.t + j, att + bonus * vj);
    }
  }

#pragma unroll
  for (int i = 0; i < kHD; ++i)
    s_final[sbase + (long long)i * kHD + j] = S[i];
}

// ---- the chunked route ----

constexpr int kL = 64;            // steps of a chunk
constexpr int kSub = 16;          // steps of a sub-chunk (one wgmma k-step)
constexpr int kCThreads = 128;    // one warpgroup
constexpr int kRePitch = 72;      // floats a row of re (bank spread)

extern __shared__ uint8_t smem_raw[];

#ifdef WKV_PROFILE
// A profiling build (tests/sm90/probe.py, step wkv_profile): lane 0 of
// each warp records clock64() at kProfMarks phase boundaries of chunk
// kProfChunk, per block.
constexpr int kProfChunk = 8, kProfMarks = 8;
__device__ long long g_wkv_prof[1 << 16];
#define WKV_MARK(m)                                                        \
  do {                                                                     \
    if (t0 == kProfChunk * kL && lane == 0)                                \
      g_wkv_prof[((blockIdx.y * gridDim.x + blockIdx.x) * 4 + warp) *      \
                     kProfMarks + (m)] = clock64();                        \
  } while (0)
#else
#define WKV_MARK(m) ((void)0)
#endif

// Index of GP(a, b) = G_a ... G_{b-1} (0 <= a < b <= 4) in gp[10][64].
__host__ __device__ __forceinline__ int gp_index(int a, int b) {
  return a * (9 - a) / 2 + b - a - 1;
}

// Shared memory of a block (byte offsets; the tiles first, 1,024-aligned).
// S^T's tiles take the place of the r and k input tiles, which the pass
// has read by the time they are written: a block at 64 columns fits two
// to an SM.
template <typename TW, int NJ>
struct Chunk {
  static constexpr int kKhat = 0;                  // c 0..2: hi, lo [16 x 64]
  static constexpr int kKbar = kKhat + 6 * 2048;   // hi, lo [64 i x 64 s]
  static constexpr int kVt = kKbar + 2 * 8192;     // [NJ j x 64 s]
  static constexpr int kR = kVt + NJ * 128;        // the chunk's inputs: r,
  static constexpr int kSt = kR;                   // then S^T hi, lo [NJ x 64]
  static constexpr int kK = kR + kL * 64 * 2;      // k bf16 [64][64],
  static constexpr int kV = kK + kL * 64 * 2;      // v bf16 [64][NJ],
  static constexpr int kW = kV + kL * NJ * 2;      // w [64][64]
  static constexpr int kRe = kW + kL * 64 * static_cast<int>(sizeof(TW));
  static constexpr int kDiag = kRe + kL * kRePitch * 4;   // float [4][16][16]
  static constexpr int kGp = kDiag + 4 * 256 * 4;  // float [10][64]
  static constexpr int kBonus = kGp + 10 * 64 * 4;  // float [64]
  static constexpr int kU = kBonus + 64 * 4;       // float [64]
  static constexpr int kSmem = kU + 64 * 4 + 1024;   // + alignment
  static_assert(kR % 1024 == 0 && 2 * NJ * 128 <= 2 * kL * 64 * 2,
                "S^T over the r and k tiles");
};

// Byte offset of element (row, k) of a K-major tile of 128-byte rows (64
// bf16) with the 128-byte swizzle, the tile on a 1,024-byte boundary.
__device__ __forceinline__ uint32_t swz_off(int row, int k) {
  const uint32_t off = row * 128 + k * 2;
  return off ^ (((off >> 7) & 7) << 4);
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// x's bf16 high part into tile hi and low part (x - hi) into tile lo.
__device__ __forceinline__ void split_store(uint8_t* hi, uint8_t* lo,
                                            uint32_t off, float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  *reinterpret_cast<__nv_bfloat16*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat16*>(lo + off) =
      __float2bfloat16_rn(x - __bfloat162float(h));
}
// Elements i and i + 1 (i even) of a row in one 4-byte (bf16) or 8-byte
// (float) load.
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a,
                                          float& b) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(u << 16);
  b = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void load_pair(const float* p, float& a,
                                          float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
// The high and low bf16 pairs of (x0, x1), packed as one A register each.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = sm90::pack_bf16x2(x0, x1);
  lo = sm90::pack_bf16x2(x0 - bf16_round(x0), x1 - bf16_round(x1));
}

// Part of diagonal block d (A_ts for s < t in sub-chunk d): lane (p, q) of
// the warp sums columns s = 16 d + p and 16 d + 15 - p over the channel
// pairs i = 2 q + 8 m, 2 q + 8 m + 1 for m in [m0, m1) (one 4- or 8-byte
// load a pair), walking t up with the product P(s+1, t-1) of each channel.
// Steps at or before a column leave its sum and product as they are
// (selects, so a pair's loads are all in flight at once); the second
// column starts past the sub-chunk's middle, so its first half is left out.
template <typename TW>
__device__ __forceinline__ void diag_steps(const __nv_bfloat16* r_in,
                                           const __nv_bfloat16* k_in,
                                           const TW* w_in, int d, int lane,
                                           int n, int m0, int m1,
                                           float (&accA)[kSub],
                                           float (&accB)[kSub]) {
  const int p = lane / 4, q = lane % 4;
  const int sa = d * kSub + p, sb = d * kSub + kSub - 1 - p;
  for (int m = m0; m < m1; ++m) {
    const int i = 2 * q + 8 * m;
    float r0[kSub], r1[kSub], w0[kSub], w1[kSub];
#pragma unroll
    for (int tl = 1; tl < kSub; ++tl) {
      const int t = d * kSub + tl;
      if (t < n) {
        load_pair(r_in + t * 64 + i, r0[tl], r1[tl]);
        load_pair(w_in + t * 64 + i, w0[tl], w1[tl]);
      } else {
        r0[tl] = r1[tl] = 0.0f;
        w0[tl] = w1[tl] = 1.0f;
      }
    }
    float pa0 = 0.0f, pa1 = 0.0f, pb0 = 0.0f, pb1 = 0.0f;
    if (sa < n) load_pair(k_in + sa * 64 + i, pa0, pa1);
    if (sb < n) load_pair(k_in + sb * 64 + i, pb0, pb1);
#pragma unroll
    for (int tl = 1; tl < kSub; ++tl) {
      const bool ina = tl >= kSub / 2 || tl > p;   // p < kSub / 2
      accA[tl] += ina ? r0[tl] * pa0 + r1[tl] * pa1 : 0.0f;
      pa0 = ina ? pa0 * w0[tl] : pa0;
      pa1 = ina ? pa1 * w1[tl] : pa1;
      if (tl >= kSub / 2) {
        const bool inb = tl > kSub - 1 - p;
        accB[tl] += inb ? r0[tl] * pb0 + r1[tl] * pb1 : 0.0f;
        pb0 = inb ? pb0 * w0[tl] : pb0;
        pb1 = inb ? pb1 * w1[tl] : pb1;
      }
    }
  }
}

template <typename TW, int NJ>
__global__ void __launch_bounds__(kCThreads)
wkv_chunk_kernel(const __nv_bfloat16* __restrict__ r,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const TW* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ s0, __nv_bfloat16* __restrict__ y,
                 float* __restrict__ s_final, int H, int T_len, Strides rs,
                 Strides ks, Strides vs, Strides ws, Strides ys) {
  using L = Chunk<TW, NJ>;
  using bf16 = __nv_bfloat16;
  constexpr int NA = NJ / 2;     // accumulators of an m64nNJ product
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* khat = smem + L::kKhat;        // tile c: hi at 4096 c, lo + 2048
  uint8_t* kbar_hi = smem + L::kKbar;
  uint8_t* kbar_lo = kbar_hi + 8192;
  uint8_t* st_hi = smem + L::kSt;      // over r_in and k_in
  uint8_t* st_lo = st_hi + NJ * 128;
  uint8_t* vt = smem + L::kVt;
  float* re = reinterpret_cast<float*>(smem + L::kRe);
  float* diag = reinterpret_cast<float*>(smem + L::kDiag);
  float* gp = reinterpret_cast<float*>(smem + L::kGp);
  float* bonus = reinterpret_cast<float*>(smem + L::kBonus);
  float* us = reinterpret_cast<float*>(smem + L::kU);
  bf16* r_in = reinterpret_cast<bf16*>(smem + L::kR);
  bf16* k_in = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* v_in = reinterpret_cast<bf16*>(smem + L::kV);
  TW* w_in = reinterpret_cast<TW*>(smem + L::kW);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int j0 = blockIdx.y * NJ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bf16* rb = r + b * rs.b + h * rs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h + j0;
  const TW* wb = w + b * ws.b + h * ws.h;
  bf16* yb = y + b * ys.b + h * ys.h + j0;
  const long long sbase = (long long)bh * 64 * 64 + j0;

  // The chunk from t0 into the input tiles (rows past T are not loaded;
  // the pass reads them as r = k = v = 0, w = 1): v and w, or r and k.
  auto load_chunk = [&](int t0, bool rk) {
    const int n = min(kL, T_len - t0);
    if (rk) {
      for (int p = tid; p < kL * 8; p += kCThreads) {
        const int t = p / 8, c = p % 8;
        if (t < n) {
          sm90::cp_async16(r_in + t * 64 + c * 8,
                           rb + (t0 + t) * rs.t + c * 8);
          sm90::cp_async16(k_in + t * 64 + c * 8,
                           kb + (t0 + t) * ks.t + c * 8);
        }
      }
    } else {
      constexpr int kPw = 64 * static_cast<int>(sizeof(TW)) / 16;
      constexpr int kEw = 16 / static_cast<int>(sizeof(TW));
      for (int p = tid; p < kL * (NJ / 8); p += kCThreads) {
        const int t = p / (NJ / 8), c = p % (NJ / 8);
        if (t < n)
          sm90::cp_async16(v_in + t * NJ + c * 8,
                           vb + (t0 + t) * vs.t + c * 8);
      }
      for (int p = tid; p < kL * kPw; p += kCThreads) {
        const int t = p / kPw, c = p % kPw;
        if (t < n)
          sm90::cp_async16(w_in + t * 64 + c * kEw,
                           wb + (t0 + t) * ws.t + c * kEw);
      }
    }
    sm90::cp_async_commit();
  };

  if (tid < 64) us[tid] = u[h * 64 + tid];
  float S[NA];   // S[i][j0 + jl], i = acc_row, jl = acc_col
#pragma unroll
  for (int q = 0; q < NA; ++q)
    S[q] = s0 == nullptr ? 0.0f
                         : s0[sbase + sm90::acc_row(tid, q) * 64 +
                              sm90::acc_col(tid, q)];
  load_chunk(0, false);
  load_chunk(0, true);

  for (int t0 = 0; t0 < T_len; t0 += kL) {
    const int n = min(kL, T_len - t0);
    sm90::cp_async_wait_all();
    __syncthreads();
    WKV_MARK(0);

    // ---- the pass on the CUDA cores ----
    // Each walk loads 16 steps into registers before it uses them, so the
    // loads are in flight together and only the decay product is a chain.
    // Channel i's backward walk within sub-chunk d gives kl_s = k_s o
    // P(s+1, 16 d + 15): khat^(d) itself, and kbar_s = kl_s o GP(d+1, 4).
    // Warps 0-1 walk sub-chunks 1 and 0 after their forward walk (which
    // gives GP), warps 2-3 sub-chunks 3 and 2 (G_3 from the first).
    const int ch = tid % 64;   // this thread's channel i
    auto back_walk = [&](int d, float gs) {
      float kv[kSub], wv[kSub];
#pragma unroll
      for (int sl = 0; sl < kSub; ++sl) {
        const int s = d * kSub + sl;
        kv[sl] = s < n ? to_f32(k_in[s * 64 + ch]) : 0.0f;
        wv[sl] = s < n ? to_f32(w_in[s * 64 + ch]) : 1.0f;
      }
      float F = 1.0f;
#pragma unroll
      for (int sl = kSub - 1; sl >= 0; --sl) {
        const float kl = kv[sl] * F;
        if (d < 3)
          split_store(khat + d * 4096, khat + d * 4096 + 2048,
                      swz_off(sl, ch), kl);
        split_store(kbar_hi, kbar_lo, swz_off(ch, d * kSub + sl), kl * gs);
        F *= wv[sl];
      }
      return F;   // G_d
    };
    if (tid < 64) {
      // re = r o P(16 d, t-1) within each sub-chunk d, G_d, GP(a, b).
      float G[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        float rv[kSub], wv[kSub];
#pragma unroll
        for (int tl = 0; tl < kSub; ++tl) {
          const int t = d * kSub + tl;
          rv[tl] = t < n ? to_f32(r_in[t * 64 + ch]) : 0.0f;
          wv[tl] = t < n ? to_f32(w_in[t * 64 + ch]) : 1.0f;
        }
        float E = 1.0f;
#pragma unroll
        for (int tl = 0; tl < kSub; ++tl) {
          re[(d * kSub + tl) * kRePitch + ch] = rv[tl] * E;
          E *= wv[tl];
        }
        G[d] = E;
      }
      float gp_later[4];   // GP(d+1, 4)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float p = 1.0f;
#pragma unroll
        for (int e = a + 1; e <= 4; ++e) {
          p *= G[e - 1];
          gp[gp_index(a, e) * 64 + ch] = p;
        }
        if (a > 0) gp_later[a - 1] = p;
      }
      back_walk(1, gp_later[1]);
      back_walk(0, gp_later[0]);
    } else {
      const float g3 = back_walk(3, 1.0f);
      back_walk(2, g3);
      // Step x = ch: its bonus.
      float bsum = 0.0f;
      if (ch < n) {
#pragma unroll
        for (int m0 = 0; m0 < 64; m0 += kSub) {
          float rv[kSub], kv[kSub], uv[kSub];
#pragma unroll
          for (int m = 0; m < kSub; ++m) {
            const int i = (m0 + m + ch) & 63;
            rv[m] = to_f32(r_in[ch * 64 + i]);
            kv[m] = to_f32(k_in[ch * 64 + i]);
            uv[m] = us[i];
          }
#pragma unroll
          for (int m = 0; m < kSub; ++m) bsum += rv[m] * (uv[m] * kv[m]);
        }
      }
      bonus[ch] = bsum;
    }
    {
      // Step x's column of V^T: columns jl of one half (warps 0-1 the
      // first NJ / 2, warps 2-3 the rest).
      const int x = tid % 64, j0h = (tid / 64) * (NJ / 2);
      constexpr int kH = NJ / 2 < kSub ? NJ / 2 : kSub;
#pragma unroll
      for (int m0 = 0; m0 < NJ / 2; m0 += kH) {
        bf16 vv[kH];
#pragma unroll
        for (int m = 0; m < kH; ++m)
          vv[m] = x < n ? v_in[x * NJ + j0h + (m0 + m + x) % (NJ / 2)]
                        : __float2bfloat16_rn(0.0f);
#pragma unroll
        for (int m = 0; m < kH; ++m)
          *reinterpret_cast<bf16*>(
              vt + swz_off(j0h + (m0 + m + x) % (NJ / 2), x)) = vv[m];
      }
    }
    WKV_MARK(1);
    sm90::fence_proxy_async();   // khat, kbar and V^T are read by wgmma
    __syncthreads();             // ... and re, gp by every warp
    WKV_MARK(2);

    // ---- A's off-diagonal blocks: A_c = rhat^(c) khat^(c)T ----
    // This warp's rows t (sub-chunk warp) after sub-chunk c: rhat^(c)_t =
    // re_t o GP(c+1, warp); rows at or before c are zero.  While each
    // group of products runs, the CUDA cores sum a third of the diagonal
    // blocks (diag_steps).
    float Ac[3][8];
    float accA[kSub], accB[kSub];
#pragma unroll
    for (int tl = 0; tl < kSub; ++tl) accA[tl] = accB[tl] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int t = sm90::afrag_row(tid, f);
          const int i = 16 * kk + sm90::afrag_col(tid, f, 0);
          float x0 = 0.0f, x1 = 0.0f;
          if (c < warp) {
            x0 = re[t * kRePitch + i];
            x1 = re[t * kRePitch + i + 1];
            if (c + 1 < warp) {
              const float* g = gp + gp_index(c + 1, warp) * 64;
              x0 *= g[i];
              x1 *= g[i + 1];
            }
          }
          split_pack(x0, x1, ah[kk][f], al[kk][f]);
        }
      }
      const uint32_t hi = sm90::smem_u32(khat + c * 4096);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dh = sm90::make_desc(hi + kk * 32, 16, 1024);
        const uint64_t dl = sm90::make_desc(hi + 2048 + kk * 32, 16, 1024);
        sm90::wgmma_rs_k<16>(Ac[c], ah[kk], dh, kk > 0);
        sm90::wgmma_rs_k<16>(Ac[c], ah[kk], dl, 1);
        sm90::wgmma_rs_k<16>(Ac[c], al[kk], dh, 1);
      }
      sm90::wgmma_commit();
      diag_steps(r_in, k_in, w_in, warp, lane, n, c * 3, c < 2 ? c * 3 + 3 : 8,
                 accA, accB);
      sm90::wgmma_wait0();
      sm90::fence_acc<8>(Ac[c]);
    }
    {
      // The diagonal blocks' sums over the 4 lanes of a column pair, into
      // diag (lane q writes rows 4 q .. 4 q + 3).
      const int d = warp, p = lane / 4, q = lane % 4;
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl) {
        accA[tl] += __shfl_xor_sync(0xffffffffu, accA[tl], 1);
        accA[tl] += __shfl_xor_sync(0xffffffffu, accA[tl], 2);
        accB[tl] += __shfl_xor_sync(0xffffffffu, accB[tl], 1);
        accB[tl] += __shfl_xor_sync(0xffffffffu, accB[tl], 2);
      }
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl) {
        if (tl / 4 == q) {
          diag[(d * kSub + tl) * kSub + p] = accA[tl];
          diag[(d * kSub + tl) * kSub + kSub - 1 - p] = accB[tl];
        }
      }
    }
    WKV_MARK(3);
    __syncthreads();   // diag is written; the inputs have been read
    if (t0 + kL < T_len) load_chunk(t0 + kL, false);
    // S^T's hi and lo tiles from the state's accumulators, over r and k.
#pragma unroll
    for (int q = 0; q < NA; ++q)
      split_store(st_hi, st_lo,
                  swz_off(sm90::acc_col(tid, q), sm90::acc_row(tid, q)),
                  S[q]);
    sm90::fence_proxy_async();   // the tiles are read by wgmma next
    __syncthreads();
    WKV_MARK(4);
    // A's k-step kk (columns of sub-chunk kk) for this warp's rows, as hi
    // and lo A registers: the product's block before the diagonal, the
    // diagonal block, zeros after.
    uint32_t pah[4][4], pal[4][4];
    {
      float dg[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        dg[q] = diag[(sm90::acc_row(tid, q)) * kSub + sm90::acc_col(tid, q)];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          float x0 = 0.0f, x1 = 0.0f;
          if (kk == warp) {
            x0 = dg[2 * f];
            x1 = dg[2 * f + 1];
          } else if (kk < warp && kk < 3) {
            x0 = Ac[kk][2 * f];
            x1 = Ac[kk][2 * f + 1];
          }
          split_pack(x0, x1, pah[kk][f], pal[kk][f]);
        }
      }
    }

    WKV_MARK(5);
    // ---- y = (r o P(t0, t-1)) S + A V; S = diag(P) S + kbar^T V ----
    uint32_t rh[4][4], rl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int t = sm90::afrag_row(tid, f);
        const int i = 16 * kk + sm90::afrag_col(tid, f, 0);
        float x0 = re[t * kRePitch + i], x1 = re[t * kRePitch + i + 1];
        if (warp > 0) {
          const float* g = gp + gp_index(0, warp) * 64;
          x0 *= g[i];
          x1 *= g[i + 1];
        }
        split_pack(x0, x1, rh[kk][f], rl[kk][f]);
      }
    }
    {
      const float* pall = gp + gp_index(0, 4) * 64;
#pragma unroll
      for (int q = 0; q < NA; ++q) S[q] *= pall[sm90::acc_row(tid, q)];
    }
    float Y[NA];
    const uint32_t sth = sm90::smem_u32(st_hi), stl = sm90::smem_u32(st_lo);
    const uint32_t vta = sm90::smem_u32(vt);
    const uint32_t kbh = sm90::smem_u32(kbar_hi);
    const uint32_t kbl = sm90::smem_u32(kbar_lo);
    sm90::fence_acc<NA>(S);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = sm90::make_desc(sth + kk * 32, 16, 1024);
      const uint64_t dl = sm90::make_desc(stl + kk * 32, 16, 1024);
      sm90::wgmma_rs_k<NJ>(Y, rh[kk], dh, kk > 0);
      sm90::wgmma_rs_k<NJ>(Y, rh[kk], dl, 1);
      sm90::wgmma_rs_k<NJ>(Y, rl[kk], dh, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sm90::make_desc(vta + kk * 32, 16, 1024);
      sm90::wgmma_rs_k<NJ>(Y, pah[kk], dv, 1);
      sm90::wgmma_rs_k<NJ>(Y, pal[kk], dv, 1);
      sm90::wgmma_ss<NJ>(S, sm90::make_desc(kbh + kk * 32, 16, 1024), dv, 1);
      sm90::wgmma_ss<NJ>(S, sm90::make_desc(kbl + kk * 32, 16, 1024), dv, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_acc<NA>(Y);
    sm90::fence_acc<NA>(S);
    __syncthreads();   // every warp's products have read S^T
    if (t0 + kL < T_len) load_chunk(t0 + kL, true);
    WKV_MARK(6);

    // y_t = Y_t + bonus_t v_t, rows of this chunk only.
    {
      float bv[2], vv[NA];
#pragma unroll
      for (int e = 0; e < 2; ++e) bv[e] = bonus[sm90::acc_row(tid, 2 * e)];
#pragma unroll
      for (int q = 0; q < NA; ++q)
        vv[q] = __bfloat162float(*reinterpret_cast<const bf16*>(
            vt + swz_off(sm90::acc_col(tid, q), sm90::acc_row(tid, q))));
#pragma unroll
      for (int q = 0; q < NA; q += 2) {
        const int t = sm90::acc_row(tid, q), jl = sm90::acc_col(tid, q);
        const float bt = bv[(q % 4) / 2];
        if (t < n)
          *reinterpret_cast<uint32_t*>(yb + (t0 + t) * ys.t + jl) =
              sm90::pack_bf16x2(Y[q] + bt * vv[q], Y[q + 1] + bt * vv[q + 1]);
      }
    }
    WKV_MARK(7);
  }

#pragma unroll
  for (int q = 0; q < NA; ++q)
    s_final[sbase + sm90::acc_row(tid, q) * 64 + sm90::acc_col(tid, q)] =
        S[q];
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, void* y, float* s_final, int B,
           int H, int T_len, const long long* st, cudaStream_t stream) {
  const Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  wkv_kernel<T, TW><<<B * H, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w), u, s0,
      static_cast<T*>(y), s_final, H, T_len, rs, ks, vs, ws, ys);
  return (int)cudaGetLastError();
}

template <typename TW, int NJ>
int launch_chunk(const void* r, const void* k, const void* v, const void* w,
                 const float* u, const float* s0, void* y, float* s_final,
                 int B, int H, int T_len, const long long* st,
                 cudaStream_t stream) {
  using L = Chunk<TW, NJ>;
  const Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  static std::atomic<unsigned long long> allowed{0};
  const int err =
      sm90::allow_smem(wkv_chunk_kernel<TW, NJ>, L::kSmem, allowed);
  if (err != 0) return err;
  const dim3 grid(B * H, 64 / NJ);
  wkv_chunk_kernel<TW, NJ><<<grid, kCThreads, L::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(r),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const TW*>(w), u,
      s0, static_cast<__nv_bfloat16*>(y), s_final, H, T_len, rs, ks, vs, ws,
      ys);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch_chunk_width(int nj, const void* r, const void* k, const void* v,
                       const void* w, const float* u, const float* s0,
                       void* y, float* s_final, int B, int H, int T_len,
                       const long long* st, cudaStream_t stream) {
  if (nj == 64)
    return launch_chunk<TW, 64>(r, k, v, w, u, s0, y, s_final, B, H, T_len,
                                st, stream);
  if (nj == 32)
    return launch_chunk<TW, 32>(r, k, v, w, u, s0, y, s_final, B, H, T_len,
                                st, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// dtype (r, k, v, y) and wdtype (w): 0 = float32, 1 = bfloat16.  u [H, 64]
// and S0 / S_final [B, H, 64, 64] are contiguous float32; s0 may be null
// (zeros).  strides: 15 element strides (batch, head, time) of r, k, v, w,
// y in that order.  route: 0 the step kernel (every type pair), 1 the
// chunked kernel (r, k, v bf16; base addresses and strides 16-byte
// aligned), over nj = 32 or 64 columns a block.  Returns a cudaError_t
// (0 on success); 1 (cudaErrorInvalidValue) for a type pair, route or nj
// without an instantiation.
int wkv_launch(int dtype, int wdtype, const void* r, const void* k,
               const void* v, const void* w, const float* u, const float* s0,
               void* y, float* s_final, int B, int H, int T,
               const long long* strides, int route, int nj, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype == 1 && wdtype == 0)
      return launch_chunk_width<float>(nj, r, k, v, w, u, s0, y, s_final, B,
                                       H, T, strides, s);
    if (dtype == 1 && wdtype == 1)
      return launch_chunk_width<__nv_bfloat16>(nj, r, k, v, w, u, s0, y,
                                               s_final, B, H, T, strides, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && wdtype == 0)
    return launch<float, float>(r, k, v, w, u, s0, y, s_final, B, H, T,
                                strides, s);
  if (dtype == 1 && wdtype == 0)
    return launch<__nv_bfloat16, float>(r, k, v, w, u, s0, y, s_final, B, H,
                                        T, strides, s);
  if (dtype == 1 && wdtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, y,
                                                s_final, B, H, T, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* wkv_error_string(int err) { return sm90::error_string(err); }

#ifdef WKV_PROFILE
// Copies the profiling build's first n marks to host memory.
int wkv_profile_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_wkv_prof, n * sizeof(long long));
}
#endif

}  // extern "C"
