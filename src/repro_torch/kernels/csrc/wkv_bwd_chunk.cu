// RWKV-6 WKV recurrence, backward, chunked on the tensor cores, for Hopper
// (sm_90a), hand-written CUDA: the backward's route for bf16 r, k, v, dy
// (w float32 or bf16) over a chunk or more with 16-byte aligned rows
// (rwkv6.py, wkv_bwd_plan).  csrc/wkv_bwd.cu is the step route (float32,
// short or misaligned inputs).
//
// Replaces no TPU kernel: the Pallas kernel
// src/repro/kernels/rwkv6/rwkv6.py::wkv_bhtd has no backward, and the JAX
// model trains through its lax.scan (src/repro/models/rwkv6.py:186).  This
// is the gradient of csrc/wkv.cu's recurrence (y_t = r_t S_t + (r_t . (u o
// k_t)) v_t, S_t+1 = diag(w_t) S_t + k_t^T v_t; S [64 i, 64 j] float32),
// in the chunked form of kernel 4's chunked route.  Time runs in chunks of
// L = 64 steps from t0, cut into 16-step sub-chunks d.  P(a, b) = prod
// w_a .. w_b (per key channel i; empty: 1).  Within sub-chunk d: E_t =
// P(16 d, t-1), F_t = P(t+1, 16 d + 15), G_d its whole product, GP(a, b) =
// G_a ... G_b-1; kF_s = k_s o F_s, rE_t = r_t o E_t.  Every factor is a
// product of decays, at most 1: no ratio, log or cumulative sum of logs
// (decays exp(-exp(x)) reach ~2e-9 at x = 3), as in kernel 4.
//
// Two kernels, one launch each, on the caller's stream:
//
// wkv_bwd_state_kernel, the state pass: one block per (b, h), NJ = 32 or
// 64 columns j of the state (the columns never mix) and direction (the two
// walks are independent).  Forward from S0 it stores each chunk's starting
// state S_c (S_c+1 = diag(P(t0, end)) S_c + kbar^T V, kbar_s = k_s o
// P(s+1, end)); backward from dS_final it stores the gradient of the state
// after each chunk dS_e (dS_c = diag(P(t0, end)) dS_e + rdec^T dY, rdec_t
// = r_t o P(t0, t-1)) and ends with dS0.  Each chunk is one pair of
// products on wgmma (m64nNJk16, the float32 kbar / rdec split into bf16
// high and low parts, as kernel 4 splits its operands).  The states go to
// two scratches of B H ceil(T/64) x 16 KB already split, as the chunk
// pass's tiles lay them out (a bf16 high and a low 128-byte swizzled tile
// each), so the chunk pass copies them in with cp.async.
//
// wkv_bwd_chunk_kernel, the chunk pass: one warpgroup per (b, h, chunk),
// so B H T / 64 independent chunks (8,192 at B 2 x T 4,096 x H 64) hide the
// latency that one chained walk cannot.  From S_c and dS_e it forms, with
// dA_ts = dy_t . v_s and c_t = dA_tt,
//   dv = kbar dS_e + A^T dY + (r . (u o k))_s dy_s    (A as kernel 4 forms
//        it: rhat khat^T blocks past the diagonal, diagonal blocks summed
//        on the CUDA cores)
//   dr_t = E_t o X_t + (diagonal block) + c_t u o k_t,
//        X_t = GP(0, d) (dY S_c^T)_t + sum_{c<d} GP(c+1, d) o
//              (dA_t,c kF_c)              (one k-step product per c)
//   dk_s = F_s o K_s + (diagonal block) + c_s u o r_s,
//        K_s = GP(c+1, 4) (V dS_e^T)_s + sum_{d>c} GP(c+1, d) o
//              (dA^T_s,d rE_d)            (one k-step product per d)
//   du  += sum_t c_t r_t o k_t (per (b, h, chunk): the wrapper sums it)
//   dw_t = E_t F_t C_d + E_t Qx_t + F_t Gk_t + (the pairs s < t < tau
//        within d), Qx a 16-step reverse scan of r o X, Gk a forward one
//        of k o K, and per channel C_d = GP(0, d) GP(d+1, 4) rowsum(S_c o
//        dS_e) + M_d + GP(0, d) sum_{e>d} GP(d+1, e) rho_e + GP(d+1, 4)
//        sum_{e<d} GP(e+1, d) phi_e, where rho_e, phi_e are column sums of
//        rE o (dY S_c^T) and kF o (V dS_e^T) over sub-chunk e and M_d those
//        of the pairs skipping d (s before d, tau after), from the same
//        products' rows.  tests/torch_parity.py::wkv_bwd_chunked_f64 is
//        this algebra in float64, held to the step form.
// The products (dA, dA^T, dY S_c^T, V dS_e^T, kbar dS_e, A^T dY, the
// per-sub-chunk blocks, A's blocks) run on wgmma with float32 operands
// split bf16 high + low (hi.hi + hi.lo + lo.hi), v and dy exact.  A
// warpgroup's accumulator rows 16 w .. 16 w + 15 are warp w's, one
// sub-chunk: the products over every row are kept, scaled and summed per
// warp.  The diagonal 16 x 16 blocks of dr, dk and A, the decay walks, the
// scans and the 16-step pair sums of dw run on the CUDA cores: thread
// (channel i, two sub-chunks) carries U_tau = sum_{s<t} dA_tau,s k_s
// P(s+1, t-1) forward (dr's block is U_t; dw's pairs are sum_{tau>t}
// P(t+1, tau-1) r_tau U_tau) and Horner sums backward for dk's block.
// A warpgroup's shared memory is ~110 KB (w float32): r and k are staged
// under A's array for the walks and again over the dead tiles for the last
// pass.  Its inputs come in two cp.async groups: r, k and w, which the
// walks and A's blocks need, then v, dy and dS_e, which land meanwhile;
// S_c's tiles land under A's array (once dv has read it) while K's
// products run, and X's products read them there.
// The code is long and runs once a chunk, so fetching it dominated
// (a second pass over a loop ran 3x faster than the first): a block holds
// two warpgroups, on chunks 2 x and 2 x + 1, that run the same code in step
// (one fetch serves both), and loops are rolled where that keeps registers.
//
// What bounds it on this card.  Bytes: r, k, v, dy read and dr, dk, dv
// written once in bf16, w read and dw written once in its type (~0.2 ms at
// B 2 x T 4,096 x H 64 at 3.35 TB/s; the scratch adds 2 x 128 MB written
// and read).  Operations: the route's tensor-core products with the
// splits (~93 GFLOP there, 0.094 ms at 989 TFLOP/s).  So it is bound by
// bytes; what it spends beyond is the CUDA cores' part of the chunk pass
// and the state pass's chain of 2 x T / 64 dependent chunks per (b, h).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 64;          // steps of a chunk
constexpr int kSub = 16;        // steps of a sub-chunk (one wgmma k-step)
constexpr int kThreads = 128;   // one warpgroup
constexpr int kWgs = 2;         // warpgroups of a chunk-pass block
constexpr int kXP = 68;         // floats a row of the [64][64] float arrays
constexpr int kStateBytes = 16384;   // a state's hi and lo bf16 tiles

extern __shared__ uint8_t smem_raw[];

#ifdef WKV_BWD_PROFILE
// A profiling build (tests/sm90/probe.py, step wkv_bwd_profile): lane 0 of
// each warp of the chunk pass's blocks over chunk kProfChunk records
// clock64() at kProfMarks points (tests/sm90/probe.py names the spans
// between them), per (b, h).
constexpr int kProfChunk = 8, kProfMarks = 21;
__device__ long long g_wkv_bwd_prof[1 << 16];
#define PROF_MARK(m)                                                       \
  do {                                                                     \
    if (valid && c == kProfChunk && lane == 0)                             \
      g_wkv_bwd_prof[(bh * 4 + warp) * kProfMarks + (m)] = clock64();      \
  } while (0)
#else
#define PROF_MARK(m) ((void)0)
#endif

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Strides {
  long long b, h, t;
};

template <typename TW>
struct Args {
  const bf16 *r, *k, *v;
  const TW* w;
  const bf16* dy;
  const float *u, *s0, *ds_final;
  bf16 *dr, *dk, *dv;
  TW* dw;
  float *du, *ds0, *sc, *dse;
  int H, T_len;
  Strides rs, ks, vs, ws, gs, drs, dks, dvs, dws;
};

// Byte offset of element (row, k) of a tile of 128-byte rows (64 bf16)
// with the 128-byte swizzle, the tile on a 1,024-byte boundary.
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
  const bf16 h = __float2bfloat16_rn(x);
  *reinterpret_cast<bf16*>(hi + off) = h;
  *reinterpret_cast<bf16*>(lo + off) =
      __float2bfloat16_rn(x - __bfloat162float(h));
}
// hi + lo of a split element.
__device__ __forceinline__ float tile_val(const uint8_t* hi, const uint8_t* lo,
                                          uint32_t off) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(hi + off)) +
         __bfloat162float(*reinterpret_cast<const bf16*>(lo + off));
}
// Elements i and i + 1 (i even) of a row in one 4-byte (bf16) or 8-byte
// (float) load.
__device__ __forceinline__ void load_pair(const bf16* p, float& a, float& b) {
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
template <typename TW>
__device__ __forceinline__ TW one();
template <>
__device__ __forceinline__ float one<float>() { return 1.0f; }
template <>
__device__ __forceinline__ bf16 one<bf16>() {
  return __float2bfloat16_rn(1.0f);
}

// One stage of a reduce-scatter over a warp: lanes ``OFF`` apart swap
// halves of their ``2 HALF`` terms, each keeping the sum of the half its
// lane bit ``OFF`` picks (the upper half where it is set) in p[0 .. HALF-1].
template <int HALF, int OFF>
__device__ __forceinline__ void scatter_half(float* p, int lane) {
  const bool hi = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = hi ? p[j] : p[j + HALF];
    const float keep = hi ? p[j + HALF] : p[j];
    p[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}
// The column sums over a warp's 16 accumulator rows of an m64n64 product:
// p[m] holds this thread's sum over its two rows of column 8 (m / 2) +
// 2 (lane % 4) + m % 2; the warp's 8 lanes of a lane % 4 are summed, and
// the 64 sums written to out[0 .. 63].
__device__ __forceinline__ void colsum_store(float (&p)[16], int lane,
                                             float* out) {
  scatter_half<8, 16>(p, lane);
  scatter_half<4, 8>(p, lane);
  scatter_half<2, 4>(p, lane);
  const int m = 8 * ((lane >> 4) & 1) + 4 * ((lane >> 3) & 1) +
                2 * ((lane >> 2) & 1);
  const int col = 8 * (m / 2) + 2 * (lane % 4);
  out[col] = p[0];
  out[col + 1] = p[1];
}
// Index of accumulator register q's column among a thread's 16.
__device__ __forceinline__ int col16(int q) { return 2 * (q / 4) + q % 2; }

// Part of A's diagonal block d (A_ts for s < t in sub-chunk d), as kernel
// 4 sums it (csrc/wkv.cu, diag_steps), from the chunk's r, k and w in
// shared memory: lane (p, q) sums columns s = 16 d + p and 16 d + 15 - p
// over the channel pairs i = 2 q + 8 m, 2 q + 8 m + 1 for m in [m0, m1).
template <typename TW>
__device__ __forceinline__ void diag_steps(const bf16* r_in, const bf16* k_in,
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

// ---- the state pass ----

// Shared memory of a state-pass block (byte offsets; the tiles first,
// 1,024-aligned): kbar^T or rdec^T's hi and lo [64 i x 64 s], V^T or
// dY^T [NJ j x 64 s] (K-major), two buffers of a chunk's inputs (k or r
// [64][64] bf16, w [64][64], v or dy [64][NJ] bf16), G and P(t0, end).
template <typename TW, int NJ>
struct StateSmem {
  static constexpr int kTile = 0;
  static constexpr int kBt = kTile + 2 * 8192;
  static constexpr int kBuf = kBt + NJ * 128;
  static constexpr int kInA = 0;
  static constexpr int kInW = kInA + kL * 64 * 2;
  static constexpr int kInB = kInW + kL * 64 * static_cast<int>(sizeof(TW));
  static constexpr int kBufBytes = kInB + kL * NJ * 2;
  static constexpr int kG = kBuf + 2 * kBufBytes;   // float [4][64]
  static constexpr int kPall = kG + 4 * 64 * 4;      // float [64]
  static constexpr int kStage = kPall + 64 * 4;      // a state's tiles
  static constexpr int kSmem = kStage + kStateBytes + 1024;   // + alignment
};

template <typename TW, int NJ>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_state_kernel(const Args<TW> a) {
  using L = StateSmem<TW, NJ>;
  constexpr int NA = NJ / 2;   // accumulators of an m64nNJ product
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* tile_hi = smem + L::kTile;
  uint8_t* tile_lo = tile_hi + 8192;
  uint8_t* bt = smem + L::kBt;
  float* gs = reinterpret_cast<float*>(smem + L::kG);
  float* pall = reinterpret_cast<float*>(smem + L::kPall);

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int j0 = blockIdx.y * NJ;
  const int tid = threadIdx.x;
  const int T_len = a.T_len;
  const int nc = (T_len + kL - 1) / kL;
  const bf16* rb = a.r + b * a.rs.b + h * a.rs.h;
  const bf16* kb = a.k + b * a.ks.b + h * a.ks.h;
  const bf16* vb = a.v + b * a.vs.b + h * a.vs.h + j0;
  const TW* wb = a.w + b * a.ws.b + h * a.ws.h;
  const bf16* gb = a.dy + b * a.gs.b + h * a.gs.h + j0;
  const long long sbase = (long long)bh * 64 * 64 + j0;
  // a chunk's state in the scratch: its bf16 hi and lo parts as the chunk
  // pass's tiles lay them out (16 KB; hi, then lo)
  uint8_t* sc = reinterpret_cast<uint8_t*>(a.sc) +
                (long long)bh * nc * kStateBytes;
  uint8_t* dse = reinterpret_cast<uint8_t*>(a.dse) +
                 (long long)bh * nc * kStateBytes;

  // Chunk c's k (fwd) or r, w, and v (fwd) or dy into buffer ``buf``
  // (rows past T are not loaded; the walks read them as 0, w = 1).
  auto load = [&](int buf, int c, bool fwd) {
    uint8_t* p = smem + L::kBuf + buf * L::kBufBytes;
    const int t0 = c * kL, n = min(kL, T_len - t0);
    const bf16* xa = fwd ? kb : rb;
    const long long sa = fwd ? a.ks.t : a.rs.t;
    const bf16* xb = fwd ? vb : gb;
    const long long sb = fwd ? a.vs.t : a.gs.t;
    for (int q = tid; q < kL * 8; q += kThreads) {
      const int t = q / 8, cc = q % 8;
      if (t < n)
        sm90::cp_async16(p + L::kInA + (t * 64 + cc * 8) * 2,
                         xa + (t0 + t) * sa + cc * 8);
    }
    constexpr int kPw = 64 * static_cast<int>(sizeof(TW)) / 16;
    constexpr int kEw = 16 / static_cast<int>(sizeof(TW));
    for (int q = tid; q < kL * kPw; q += kThreads) {
      const int t = q / kPw, cc = q % kPw;
      if (t < n)
        sm90::cp_async16(
            p + L::kInW + (t * 64 + cc * kEw) * static_cast<int>(sizeof(TW)),
            wb + (t0 + t) * a.ws.t + cc * kEw);
    }
    for (int q = tid; q < kL * (NJ / 8); q += kThreads) {
      const int t = q / (NJ / 8), cc = q % (NJ / 8);
      if (t < n)
        sm90::cp_async16(p + L::kInB + (t * NJ + cc * 8) * 2,
                         xb + (t0 + t) * sb + cc * 8);
    }
    sm90::cp_async_commit();
  };

  // The CUDA cores' pass over chunk c in buffer ``buf``: thread (channel
  // ch, half hh) walks sub-chunks 2 hh and 2 hh + 1.  fwd: kbar^T =
  // (k_s o F_s GP(d+1, 4))^T; else rdec^T = (r_t o E_t GP(0, d))^T; each
  // split into the hi / lo tiles.  Then P(t0, end) and the B tile (v or
  // dy transposed: step x's column of NJ / 2 columns a half).
  auto pass = [&](int buf, int c, bool fwd) {
    const uint8_t* p = smem + L::kBuf + buf * L::kBufBytes;
    const bf16* x_in = reinterpret_cast<const bf16*>(p + L::kInA);
    const TW* w_in = reinterpret_cast<const TW*>(p + L::kInW);
    const bf16* b_in = reinterpret_cast<const bf16*>(p + L::kInB);
    const int n = min(kL, T_len - c * kL);
    const int ch = tid % 64, hh = tid / 64;
    float xl[2][kSub];
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int d = 2 * hh + dd;
      float xv[kSub], wv[kSub];
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl) {
        const int t = d * kSub + tl;
        xv[tl] = t < n ? to_f32(x_in[t * 64 + ch]) : 0.0f;
        wv[tl] = t < n ? to_f32(w_in[t * 64 + ch]) : 1.0f;
      }
      float g = 1.0f;
      if (fwd) {
#pragma unroll
        for (int tl = kSub - 1; tl >= 0; --tl) {
          xl[dd][tl] = xv[tl] * g;
          g *= wv[tl];
        }
      } else {
#pragma unroll
        for (int tl = 0; tl < kSub; ++tl) {
          xl[dd][tl] = xv[tl] * g;
          g *= wv[tl];
        }
      }
      gs[d * 64 + ch] = g;
    }
    __syncthreads();
    float G[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) G[e] = gs[e * 64 + ch];
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int d = 2 * hh + dd;
      float sc_d = 1.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (fwd ? e > d : e < d) sc_d *= G[e];
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl)
        split_store(tile_hi, tile_lo, swz_off(ch, d * kSub + tl),
                    xl[dd][tl] * sc_d);
    }
    if (hh == 0) pall[ch] = (G[0] * G[1]) * (G[2] * G[3]);
    {
      const int x = tid % 64, j0h = (tid / 64) * (NJ / 2);
      constexpr int kH = NJ / 2 < kSub ? NJ / 2 : kSub;
#pragma unroll
      for (int m0 = 0; m0 < NJ / 2; m0 += kH) {
        bf16 vv[kH];
#pragma unroll
        for (int m = 0; m < kH; ++m)
          vv[m] = x < n ? b_in[x * NJ + j0h + (m0 + m + x) % (NJ / 2)]
                        : __float2bfloat16_rn(0.0f);
#pragma unroll
        for (int m = 0; m < kH; ++m)
          *reinterpret_cast<bf16*>(
              bt + swz_off(j0h + (m0 + m + x) % (NJ / 2), x)) = vv[m];
      }
    }
    sm90::fence_proxy_async();   // the tiles are read by wgmma next
    __syncthreads();             // ... and pall by every warp
  };

  // acc = diag(P(t0, end)) acc + tile^T . B
  auto product = [&](float* acc) {
#pragma unroll
    for (int q = 0; q < NA; ++q) acc[q] *= pall[sm90::acc_row(tid, q)];
    const uint32_t th = sm90::smem_u32(tile_hi), tl = sm90::smem_u32(tile_lo);
    const uint32_t ba = sm90::smem_u32(bt);
    sm90::fence_acc<NA>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = sm90::make_desc(ba + kk * 32, 16, 1024);
      sm90::wgmma_ss<NJ>(acc, sm90::make_desc(th + kk * 32, 16, 1024), db, 1);
      sm90::wgmma_ss<NJ>(acc, sm90::make_desc(tl + kk * 32, 16, 1024), db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_acc<NA>(acc);
  };
  // The block's columns of a state, split, into the scratch's tiles at
  // dst: through shared memory (the tiles' own layout), so that device
  // memory is written 16 bytes a thread in whole sectors.
  uint8_t* stage = smem + L::kStage;
  auto put = [&](uint8_t* dst, const float* acc) {
#pragma unroll
    for (int q = 0; q < NA; q += 2) {
      const uint32_t off =
          swz_off(sm90::acc_row(tid, q), j0 + sm90::acc_col(tid, q));
      uint32_t hi, lo;
      split_pack(acc[q], acc[q + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(stage + off) = hi;
      *reinterpret_cast<uint32_t*>(stage + 8192 + off) = lo;
    }
    __syncthreads();
    constexpr int kChunks = NJ / 8;   // 16-byte pieces of a row
    for (int e = tid; e < 2 * 64 * kChunks; e += kThreads) {
      const int row = (e / kChunks) % 64;
      const uint32_t off = (e / (64 * kChunks)) * 8192 + row * 128 +
                           (((j0 / 8 + e % kChunks) ^ (row & 7)) << 4);
      *reinterpret_cast<float4*>(dst + off) =
          *reinterpret_cast<const float4*>(stage + off);
    }
  };

  float S[NA];   // S[i][j0 + jl] or dS, i = acc_row, jl = acc_col
  if (blockIdx.z == 0) {   // forward from S0: S_c for c = 0 .. nc - 1
#pragma unroll
    for (int q = 0; q < NA; ++q)
      S[q] = a.s0 == nullptr ? 0.0f
                             : a.s0[sbase + sm90::acc_row(tid, q) * 64 +
                                    sm90::acc_col(tid, q)];
    put(sc, S);
    if (nc > 1) load(0, 0, true);
    for (int c = 0; c + 1 < nc; ++c) {
      sm90::cp_async_wait_all();
      __syncthreads();   // the buffer has landed; the last chunk's reads done
      if (c + 2 < nc) load((c + 1) & 1, c + 1, true);
      pass(c & 1, c, true);
      product(S);
      put(sc + (long long)(c + 1) * kStateBytes, S);
    }
  } else {   // backward from dS_final: dS_e for c = nc - 1 .. 0, then dS0
#pragma unroll
    for (int q = 0; q < NA; ++q)
      S[q] = a.ds_final == nullptr
                 ? 0.0f
                 : a.ds_final[sbase + sm90::acc_row(tid, q) * 64 +
                              sm90::acc_col(tid, q)];
    load((nc - 1) & 1, nc - 1, false);
    for (int c = nc - 1; c >= 0; --c) {
      put(dse + (long long)c * kStateBytes, S);
      sm90::cp_async_wait_all();
      __syncthreads();
      if (c > 0) load((c - 1) & 1, c - 1, false);
      pass(c & 1, c, false);
      product(S);
    }
#pragma unroll
    for (int q = 0; q < NA; q += 2)   // dS0, float32
      *reinterpret_cast<float2*>(a.ds0 + sbase + sm90::acc_row(tid, q) * 64 +
                                 sm90::acc_col(tid, q)) =
          make_float2(S[q], S[q + 1]);
  }
}

// ---- the chunk pass ----

// Shared memory of a chunk-pass block (byte offsets; the tiles first,
// 1,024-aligned).  X (dr's bracket) lies over the S / khat tiles at the
// end, K (dk's) over the A array once dv is formed.
template <typename TW>
struct ChunkSmem {
  static constexpr int kV = 0;              // v [64 s][64 j] bf16
  static constexpr int kDy = kV + 8192;     // dy [64 t][64 j] bf16
  static constexpr int kS = kDy + 8192;     // dS_e: hi, lo [i][j]; then K
  static constexpr int kKh = kS + 16384;    // kF of sub-chunk c: hi at
                                            // 4096 c, lo + 2048 [16 s][64 i]
  static constexpr int kRe = kKh + 16384;   // rE of sub-chunk d = 1..3: hi
                                            // at 4096 (d-1), lo + 2048
  static constexpr int kW = kRe + 12288;    // w [64][64]
  static constexpr int kA = kW + kL * 64 * static_cast<int>(sizeof(TW));
  static constexpr int kK = kS;             // K float [64][64]
  // A's region holds in turn r, k bf16 [64][64] each (the walks), A
  // float [64][kXP], S_c's tiles (X's products), X float [64][kXP].
  static constexpr int kRk = kA;
  static constexpr int kSc = kA;
  static constexpr int kX = kA;
  static constexpr int kRk2 = kKh;          // r, k again, at the end
  static constexpr int kDa = kA + kL * kXP * 4;   // dA's diagonal blocks
  static constexpr int kGp = kDa + 4 * 256 * 4;   // float [5][5][64]
  static constexpr int kG = kGp + 25 * 64 * 4;    // float [4][64]
  static constexpr int kRho = kG + 4 * 64 * 4;    // float [4][64] each:
  static constexpr int kPhi = kRho + 4 * 64 * 4;  // column sums by warp
  static constexpr int kM1 = kPhi + 4 * 64 * 4;
  static constexpr int kM2 = kM1 + 4 * 64 * 4;
  static constexpr int kRow = kM2 + 4 * 64 * 4;   // rowsum(S_c o dS_e)
  static constexpr int kBon = kRow + 64 * 4;      // r_t . (u o k_t)
  static constexpr int kU = kBon + 64 * 4;
  static constexpr int kDu = kU + 64 * 4;         // float [2][64]
  // a warpgroup's share, and the block's (+ alignment)
  static constexpr int kWgBytes = (kDu + 2 * 64 * 4 + 1023) / 1024 * 1024;
  static constexpr int kSmem = kWgs * kWgBytes + 1024;
  static_assert(kRk2 + 16384 <= kW && kL * 64 * 4 <= 16384 &&
                    16384 <= kL * kXP * 4 && kA % 1024 == 0,
                "r, k over the dead tiles, K over dS_e's; r, k and S_c's "
                "tiles (1,024-aligned) under A's array");
  static_assert(kW % 16 == 0, "16-byte rows");
};

template <typename TW>
__global__ void __launch_bounds__(kWgs * kThreads, 1)
wkv_bwd_chunk_kernel(const Args<TW> a) {
  using L = ChunkSmem<TW>;
  const int grp = threadIdx.x / kThreads;   // this warpgroup's chunk, share
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023) +
      grp * L::kWgBytes;
  uint8_t* vt = smem + L::kV;
  uint8_t* dyt = smem + L::kDy;
  uint8_t* s_hi = smem + L::kS;
  uint8_t* s_lo = s_hi + 8192;
  uint8_t* kh = smem + L::kKh;
  uint8_t* re = smem + L::kRe;
  TW* w_in = reinterpret_cast<TW*>(smem + L::kW);
  float* fa = reinterpret_cast<float*>(smem + L::kA);
  float* fk = reinterpret_cast<float*>(smem + L::kK);
  float* fx = reinterpret_cast<float*>(smem + L::kX);
  float* dad = reinterpret_cast<float*>(smem + L::kDa);
  float* gp = reinterpret_cast<float*>(smem + L::kGp);
  float* gs = reinterpret_cast<float*>(smem + L::kG);
  float* rho = reinterpret_cast<float*>(smem + L::kRho);
  float* phi = reinterpret_cast<float*>(smem + L::kPhi);
  float* m1 = reinterpret_cast<float*>(smem + L::kM1);
  float* m2 = reinterpret_cast<float*>(smem + L::kM2);
  float* rowsum = reinterpret_cast<float*>(smem + L::kRow);
  float* bonus = reinterpret_cast<float*>(smem + L::kBon);
  float* us = reinterpret_cast<float*>(smem + L::kU);
  float* dus = reinterpret_cast<float*>(smem + L::kDu);
  const bf16* r_in = reinterpret_cast<const bf16*>(smem + L::kRk);
  const bf16* k_in = r_in + kL * 64;

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int tid = threadIdx.x % kThreads;   // within the warpgroup
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int T_len = a.T_len;
  const int nc = (T_len + kL - 1) / kL;
  // A block's warpgroups take chunks 2 x and 2 x + 1 and run in step (the
  // same code at the same time, so one fetch of it serves both); past the
  // last chunk a warpgroup computes on zeros (n = 0) and stores nothing.
  const bool valid = kWgs * blockIdx.x + grp < nc;
  const int c = valid ? kWgs * blockIdx.x + grp : 0;
  const int t0 = c * kL;
  const int n = valid ? min(kL, T_len - t0) : 0;
  const bf16* rg = a.r + b * a.rs.b + h * a.rs.h + t0 * a.rs.t;
  const bf16* kg = a.k + b * a.ks.b + h * a.ks.h + t0 * a.ks.t;
  const bf16* vg = a.v + b * a.vs.b + h * a.vs.h + t0 * a.vs.t;
  const TW* wg = a.w + b * a.ws.b + h * a.ws.h + t0 * a.ws.t;
  const bf16* gg = a.dy + b * a.gs.b + h * a.gs.h + t0 * a.gs.t;
  const uint8_t* scp = reinterpret_cast<const uint8_t*>(a.sc) +
                       ((long long)bh * nc + c) * kStateBytes;
  const uint8_t* dsp = reinterpret_cast<const uint8_t*>(a.dse) +
                       ((long long)bh * nc + c) * kStateBytes;

  // GP(x, y) of channel i (1 for x >= y): one load, no branch.
  auto gpv = [&](int x, int y, int i) { return gp[(x * 5 + y) * 64 + i]; };
  auto kf_val = [&](int d, uint32_t off) {   // kF in sub-chunk d
    return tile_val(kh + d * 4096, kh + d * 4096 + 2048, off);
  };
  auto re_val = [&](int d, uint32_t off) {   // rE in sub-chunk d >= 1
    return tile_val(re + (d - 1) * 4096, re + (d - 1) * 4096 + 2048, off);
  };
  // A state's split tiles (the state pass's layout) into dst.
  auto load_state = [&](uint8_t* dst, const uint8_t* p) {
    for (int q = tid; q < kStateBytes / 16; q += kThreads)
      sm90::cp_async16(dst + q * 16, p + q * 16);
    sm90::cp_async_commit();
  };
  // The chunk's r and k into shared memory at ``dst`` (r, then k, each
  // [64][64] bf16; rows past T zero).
  auto stage_rk = [&](uint8_t* dst) {
    for (int q = tid; q < kL * 8; q += kThreads) {
      const int t = q / 8, cc = q % 8;
      uint8_t* pr = dst + (t * 64 + cc * 8) * 2;
      if (t < n) {
        sm90::cp_async16(pr, rg + t * a.rs.t + cc * 8);
        sm90::cp_async16(pr + kL * 64 * 2, kg + t * a.ks.t + cc * 8);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          reinterpret_cast<uint32_t*>(pr)[e] =
              reinterpret_cast<uint32_t*>(pr + kL * 64 * 2)[e] = 0u;
      }
    }
    sm90::cp_async_commit();
  };

  PROF_MARK(0);
  // ---- inputs, in two groups: r, k and w (rows past T zero, w one),
  // which the walks and A's blocks read; then the v, dy and dS_e tiles
  // (v, dy rows past T zero), which land while those run ----
  {
    constexpr int kPw = 64 * static_cast<int>(sizeof(TW)) / 16;
    constexpr int kEw = 16 / static_cast<int>(sizeof(TW));
    for (int q = tid; q < kL * kPw; q += kThreads) {
      const int t = q / kPw, cc = q % kPw;
      if (t < n) {
        sm90::cp_async16(w_in + t * 64 + cc * kEw, wg + t * a.ws.t + cc * kEw);
      } else {
#pragma unroll
        for (int e = 0; e < kEw; ++e) w_in[t * 64 + cc * kEw + e] = one<TW>();
      }
    }
  }
  stage_rk(smem + L::kRk);
  for (int q = tid; q < kL * 8; q += kThreads) {
    const int t = q / 8, cc = q % 8;
    if (t < n) {
      sm90::cp_async16(vt + swz_off(t, cc * 8), vg + t * a.vs.t + cc * 8);
      sm90::cp_async16(dyt + swz_off(t, cc * 8), gg + t * a.gs.t + cc * 8);
    } else {
      uint32_t* zv = reinterpret_cast<uint32_t*>(vt + swz_off(t, cc * 8));
      uint32_t* zg = reinterpret_cast<uint32_t*>(dyt + swz_off(t, cc * 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) zv[e] = zg[e] = 0u;
    }
  }
  load_state(s_hi, dsp);
  PROF_MARK(1);
  if (tid < 64) us[tid] = a.u[h * 64 + tid];
  PROF_MARK(2);
  sm90::cp_async_wait_group<1>();   // r, k and w
  __syncthreads();
  PROF_MARK(3);

  // ---- the decay walks: thread (channel ch, half hh), sub-chunks 2 hh,
  // 2 hh + 1: the kF and rE tiles and G; then step x's bonus ----
  {
    const int ch = tid % 64, hh = tid / 64;
#pragma unroll 1
    for (int dd = 0; dd < 2; ++dd) {
      const int d = 2 * hh + dd;
      float rv[kSub], kv[kSub], wv[kSub];
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl) {
        const int t = d * kSub + tl;
        rv[tl] = __bfloat162float(r_in[t * 64 + ch]);
        kv[tl] = __bfloat162float(k_in[t * 64 + ch]);
        wv[tl] = to_f32(w_in[t * 64 + ch]);
      }
      float E = 1.0f;
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl) {
        if (d > 0)
          split_store(re + (d - 1) * 4096, re + (d - 1) * 4096 + 2048,
                      swz_off(tl, ch), rv[tl] * E);
        E *= wv[tl];
      }
      float F = 1.0f;
#pragma unroll
      for (int tl = kSub - 1; tl >= 0; --tl) {
        split_store(kh + d * 4096, kh + d * 4096 + 2048, swz_off(tl, ch),
                    kv[tl] * F);
        F *= wv[tl];
      }
      gs[d * 64 + ch] = E;
    }
    // bonus of step x = tid / 2: channels 32 (tid % 2) .. + 31
    const int x = tid / 2, ib = 32 * (tid % 2);
    float bsum = 0.0f;
    if (x < n) {
#pragma unroll
      for (int m = 0; m < 32; m += 2) {
        float r0, r1, k0, k1;
        load_pair(r_in + x * 64 + ib + m, r0, r1);
        load_pair(k_in + x * 64 + ib + m, k0, k1);
        bsum += r0 * (us[ib + m] * k0) + r1 * (us[ib + m + 1] * k1);
      }
    }
    bsum += __shfl_xor_sync(0xffffffffu, bsum, 1);
    if (tid % 2 == 0) bonus[x] = bsum;
  }
  PROF_MARK(4);
  __syncthreads();
  if (tid < 64) {
    float G[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) G[e] = gs[e * 64 + tid];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      float p = 1.0f;
#pragma unroll
      for (int y = 0; y < 5; ++y) {
        if (y > x) p *= G[y - 1];
        gp[(x * 5 + y) * 64 + tid] = p;
      }
    }
  }
  sm90::fence_proxy_async();   // the kF, rE and dS_e tiles are read by wgmma
  __syncthreads();
  PROF_MARK(5);

  // ---- A's blocks past the diagonal (kernel 4's products: rows t of
  // sub-chunk w after c, rhat = rE_t GP(c+1, w), against kF of c), its
  // diagonal blocks on the CUDA cores meanwhile, into A's array ----
  {
    // The loop over c is rolled (one copy of its code): each block's
    // accumulators shift down A0 -> A1 -> A2, so A2, A1, A0 end as blocks
    // 0, 1, 2.
    float A0[8], A1[8], A2[8];
    float accA[kSub], accB[kSub];
#pragma unroll
    for (int tl = 0; tl < kSub; ++tl) accA[tl] = accB[tl] = 0.0f;
#pragma unroll 1
    for (int cc = 0; cc < 3; ++cc) {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int tl = sm90::afrag_row(tid, f) - 16 * warp;
          const int i = 16 * kk + sm90::afrag_col(tid, f, 0);
          float x0 = 0.0f, x1 = 0.0f;
          if (cc < warp) {
            const uint32_t off = swz_off(tl, i);
            x0 = re_val(warp, off) * gpv(cc + 1, warp, i);
            x1 = re_val(warp, off + 2) * gpv(cc + 1, warp, i + 1);
          }
          split_pack(x0, x1, ah[kk][f], al[kk][f]);
        }
      }
      if (cc == 0) PROF_MARK(6);
      const uint32_t hi = sm90::smem_u32(kh + cc * 4096);
      float acc[8];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dh = sm90::make_desc(hi + kk * 32, 16, 1024);
        const uint64_t dl = sm90::make_desc(hi + 2048 + kk * 32, 16, 1024);
        sm90::wgmma_rs_k<16>(acc, ah[kk], dh, kk > 0);
        sm90::wgmma_rs_k<16>(acc, ah[kk], dl, 1);
        sm90::wgmma_rs_k<16>(acc, al[kk], dh, 1);
      }
      sm90::wgmma_commit();
      diag_steps(r_in, k_in, w_in, warp, lane, n, cc * 3,
                 cc < 2 ? cc * 3 + 3 : 8, accA, accB);
      if (cc == 0) PROF_MARK(7);
      sm90::wgmma_wait0();
      sm90::fence_acc<8>(acc);
      if (cc == 0) PROF_MARK(8);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        A2[q] = A1[q];
        A1[q] = A0[q];
        A0[q] = acc[q];
      }
    }
    PROF_MARK(9);
    __syncthreads();   // every warp has read r and k under A's array
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      if (cc != warp) {   // blocks past the diagonal, zeros before it
        const float* blk = cc == 0 ? A2 : cc == 1 ? A1 : A0;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          fa[sm90::acc_row(tid, q) * kXP + 16 * cc + sm90::acc_col(tid, q)] =
              cc < warp ? blk[q] : 0.0f;
      }
    }
    const int p = lane / 4, q = lane % 4;
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
        float* row = fa + (16 * warp + tl) * kXP + 16 * warp;
        row[p] = accA[tl];
        row[kSub - 1 - p] = accB[tl];
      }
    }
  }
  PROF_MARK(10);
  sm90::cp_async_wait_all();    // v, dy and dS_e, read by wgmma next
  sm90::fence_proxy_async();
  __syncthreads();   // A's array is whole
  PROF_MARK(11);

  // ---- dv = kbar dS_e + A^T dY + bonus_s dy_s, rows s of warp w ----
  {
    uint32_t bh_[4][4], bl_[4][4], th[4][4], tl_[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int s = sm90::afrag_row(tid, f);
        const int i = 16 * kk + sm90::afrag_col(tid, f, 0);
        const uint32_t off = swz_off(s - 16 * warp, i);
        split_pack(kf_val(warp, off) * gpv(warp + 1, 4, i),
                   kf_val(warp, off + 2) * gpv(warp + 1, 4, i + 1),
                   bh_[kk][f], bl_[kk][f]);
        split_pack(fa[i * kXP + s], fa[(i + 1) * kXP + s], th[kk][f],
                   tl_[kk][f]);
      }
    }
    float D[32];
    const uint32_t sh = sm90::smem_u32(s_hi), sl = sm90::smem_u32(s_lo);
    const uint32_t ya = sm90::smem_u32(dyt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = sm90::make_desc(sh + kk * 2048, 8192, 1024);
      const uint64_t dl = sm90::make_desc(sl + kk * 2048, 8192, 1024);
      const uint64_t dy = sm90::make_desc(ya + kk * 2048, 8192, 1024);
      sm90::wgmma_rs<64>(D, bh_[kk], dh, kk > 0);
      sm90::wgmma_rs<64>(D, bh_[kk], dl, 1);
      sm90::wgmma_rs<64>(D, bl_[kk], dh, 1);
      sm90::wgmma_rs<64>(D, th[kk], dy, 1);
      sm90::wgmma_rs<64>(D, tl_[kk], dy, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_acc<32>(D);
    bf16* dvg = a.dv + b * a.dvs.b + h * a.dvs.h + t0 * a.dvs.t;
#pragma unroll
    for (int q = 0; q < 32; q += 2) {
      const int s = sm90::acc_row(tid, q), j = sm90::acc_col(tid, q);
      if (s < n) {
        const uint32_t off = swz_off(s, j);
        const float bs = bonus[s];
        const float y0 = __bfloat162float(*reinterpret_cast<const bf16*>(
                            dyt + off)),
                    y1 = __bfloat162float(*reinterpret_cast<const bf16*>(
                            dyt + off + 2));
        *reinterpret_cast<uint32_t*>(dvg + s * a.dvs.t + j) =
            sm90::pack_bf16x2(D[q] + bs * y0, D[q + 1] + bs * y1);
      }
    }
  }
  PROF_MARK(12);
  // S_c's tiles land in A's array (read by dv, free until X is stored
  // there) while K's products run; X's products read them there.
  __syncthreads();   // dv has read A's array
  load_state(reinterpret_cast<uint8_t*>(fa), scp);

  // ---- K = GP(w+1, 4) V dS_e^T + sum_{d > w} GP(w+1, d) (dA^T_d rE_d):
  // dk's bracket, rows s of warp w; phi_w = column sums of kF o V dS_e^T
  float K[32];
  {
    float acc[32];
    const uint32_t va = sm90::smem_u32(vt), ya = sm90::smem_u32(dyt);
    const uint32_t sh = sm90::smem_u32(s_hi), sl = sm90::smem_u32(s_lo);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // dA^T = V dY^T
      sm90::wgmma_ss<64>(acc, sm90::make_desc(va + kk * 32, 16, 1024),
                         sm90::make_desc(ya + kk * 32, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // V dS_e^T
      const uint64_t dv = sm90::make_desc(va + kk * 32, 16, 1024);
      sm90::wgmma_ss<64>(K, dv, sm90::make_desc(sh + kk * 32, 16, 1024),
                         kk > 0);
      sm90::wgmma_ss<64>(K, dv, sm90::make_desc(sl + kk * 32, 16, 1024), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_acc<32>(acc);
    sm90::fence_acc<32>(K);
    uint32_t fh[3][4], fl[3][4];   // dA^T's k-steps 1..3 as A registers
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_pack(acc[8 * kk + 2 * f], acc[8 * kk + 2 * f + 1],
                   fh[kk - 1][f], fl[kk - 1][f]);
    // (the loop over d below is rolled: its k-step's registers shift down)
    float pp[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) pp[m] = 0.0f;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int s = sm90::acc_row(tid, q), i = sm90::acc_col(tid, q);
      pp[col16(q)] += kf_val(warp, swz_off(s - 16 * warp, i)) * K[q];
      K[q] *= gpv(warp + 1, 4, i);
    }
#pragma unroll 1
    for (int d = 1; d < 4; ++d) {
      float tmp[32];
      const uint32_t hi = sm90::smem_u32(re + (d - 1) * 4096);
      sm90::wgmma_fence();
      sm90::wgmma_rs<64>(tmp, fh[0], sm90::make_desc(hi, 2048, 1024), 0);
      sm90::wgmma_rs<64>(tmp, fh[0], sm90::make_desc(hi + 2048, 2048, 1024),
                         1);
      sm90::wgmma_rs<64>(tmp, fl[0], sm90::make_desc(hi, 2048, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_acc<32>(tmp);
      if (warp < d) {
#pragma unroll
        for (int q = 0; q < 32; ++q)
          K[q] += gpv(warp + 1, d, sm90::acc_col(tid, q)) * tmp[q];
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        fh[0][f] = fh[1][f];
        fh[1][f] = fh[2][f];
        fl[0][f] = fl[1][f];
        fl[1][f] = fl[2][f];
      }
    }
    colsum_store(pp, lane, phi + warp * 64);
  }
  PROF_MARK(13);
  {
    // rowsum(S_c o dS_e): row tid / 2, columns 32 (tid % 2) .. + 31
    const int i = tid / 2, jb = 32 * (tid % 2);
    const uint8_t* sc_hi = smem + L::kSc;
    float rsum = 0.0f;
    sm90::cp_async_wait_all();
    sm90::fence_proxy_async();   // S_c's tiles are read by wgmma next
    __syncthreads();   // S_c has landed; K's products have read dS_e
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const uint32_t off = swz_off(i, jb + j);
      rsum = fmaf(tile_val(s_hi, s_lo, off),
                  tile_val(sc_hi, sc_hi + 8192, off), rsum);
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    if (tid % 2 == 0) rowsum[i] = rsum;
    __syncthreads();   // every thread has read dS_e
  }
#pragma unroll
  for (int q = 0; q < 32; ++q)   // K over dS_e's tiles
    fk[sm90::acc_row(tid, q) * 64 + sm90::acc_col(tid, q)] = K[q];
  PROF_MARK(14);

  // ---- X = GP(0, w) dY S_c^T + sum_{c < w} GP(c+1, w) (dA_c kF_c):
  // dr's bracket, rows t of warp w; rho_w = column sums of rE o dY S_c^T;
  // M_1, M_2 the pairs skipping a sub-chunk; dA's diagonal blocks ----
  float X[32];
  {
    float acc[32];
    const uint32_t va = sm90::smem_u32(vt), ya = sm90::smem_u32(dyt);
    const uint32_t sh = sm90::smem_u32(smem + L::kSc), sl = sh + 8192;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // dA = dY V^T
      sm90::wgmma_ss<64>(acc, sm90::make_desc(ya + kk * 32, 16, 1024),
                         sm90::make_desc(va + kk * 32, 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // dY S_c^T
      const uint64_t dg = sm90::make_desc(ya + kk * 32, 16, 1024);
      sm90::wgmma_ss<64>(X, dg, sm90::make_desc(sh + kk * 32, 16, 1024),
                         kk > 0);
      sm90::wgmma_ss<64>(X, dg, sm90::make_desc(sl + kk * 32, 16, 1024), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    sm90::fence_acc<32>(acc);
    sm90::fence_acc<32>(X);
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int t = sm90::acc_row(tid, q), s = sm90::acc_col(tid, q);
      if ((s >> 4) == warp) dad[warp * 256 + (t & 15) * 16 + (s & 15)] = acc[q];
    }
    uint32_t fh[3][4], fl[3][4];   // dA's k-steps 0..2 as A registers
#pragma unroll
    for (int kk = 0; kk < 3; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_pack(acc[8 * kk + 2 * f], acc[8 * kk + 2 * f + 1], fh[kk][f],
                   fl[kk][f]);
    float rev[32];
    float pp[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) pp[m] = 0.0f;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int t = sm90::acc_row(tid, q), i = sm90::acc_col(tid, q);
      rev[q] = warp > 0 ? re_val(warp, swz_off(t - 16 * warp, i)) : 0.0f;
      pp[col16(q)] += rev[q] * X[q];
      X[q] *= gpv(0, warp, i);
    }
    colsum_store(pp, lane, rho + warp * 64);
    float p1[16], p2[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) p1[m] = p2[m] = 0.0f;
#pragma unroll 1
    for (int cc = 0; cc < 3; ++cc) {   // rolled: the k-step's registers
      float tmp[32];                   // shift down
      const uint32_t hi = sm90::smem_u32(kh + cc * 4096);
      sm90::wgmma_fence();
      sm90::wgmma_rs<64>(tmp, fh[0], sm90::make_desc(hi, 2048, 1024), 0);
      sm90::wgmma_rs<64>(tmp, fh[0], sm90::make_desc(hi + 2048, 2048, 1024),
                         1);
      sm90::wgmma_rs<64>(tmp, fl[0], sm90::make_desc(hi, 2048, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait0();
      sm90::fence_acc<32>(tmp);
      if (cc < warp) {
        float rt[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) rt[m] = 0.0f;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          X[q] += gpv(cc + 1, warp, sm90::acc_col(tid, q)) * tmp[q];
          rt[col16(q)] += rev[q] * tmp[q];
        }
        // M_d, c < d < w: rE_tau GP(d+1, w) GP(c+1, d) over these rows
#pragma unroll
        for (int d = 1; d <= 2; ++d) {
          if (cc < d && d < warp) {
#pragma unroll
            for (int m = 0; m < 16; ++m) {
              const int i = 8 * (m / 2) + 2 * (lane % 4) + m % 2;
              const float coef = gpv(d + 1, warp, i) * gpv(cc + 1, d, i);
              if (d == 1) p1[m] += coef * rt[m];
              else p2[m] += coef * rt[m];
            }
          }
        }
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        fh[0][f] = fh[1][f];
        fh[1][f] = fh[2][f];
        fl[0][f] = fl[1][f];
        fl[1][f] = fl[2][f];
      }
    }
    colsum_store(p1, lane, m1 + warp * 64);
    colsum_store(p2, lane, m2 + warp * 64);
  }
  PROF_MARK(15);
  __syncthreads();   // every product has read the tiles
  stage_rk(smem + L::kRk2);
#pragma unroll
  for (int q = 0; q < 32; ++q)
    fx[sm90::acc_row(tid, q) * kXP + sm90::acc_col(tid, q)] = X[q];
  sm90::cp_async_wait_all();
  __syncthreads();
  PROF_MARK(16);

  // ---- per (channel ch, sub-chunk d): dr, dk and dw of its 16 steps ----
  {
    const int ch = tid % 64, hh = tid / 64;
    const float uc = us[ch];
    const bf16* r2 = reinterpret_cast<const bf16*>(smem + L::kRk2);
    const bf16* k2 = r2 + kL * 64;
    float du = 0.0f;
    bf16* drg = a.dr + b * a.drs.b + h * a.drs.h + t0 * a.drs.t + ch;
    bf16* dkg = a.dk + b * a.dks.b + h * a.dks.h + t0 * a.dks.t + ch;
    TW* dwg = a.dw + b * a.dws.b + h * a.dws.h + t0 * a.dws.t + ch;
#pragma unroll 1
    for (int dd = 0; dd < 2; ++dd) {
      const int d = 2 * hh + dd;
      const float* blk = dad + d * 256;   // dA_{tau, s} at [tau][s]
      float rv[kSub], kv[kSub], wv[kSub], E[kSub], F[kSub];
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl) {
        const int t = d * kSub + tl;
        rv[tl] = __bfloat162float(r2[t * 64 + ch]);
        kv[tl] = __bfloat162float(k2[t * 64 + ch]);
        wv[tl] = to_f32(w_in[t * 64 + ch]);
      }
      E[0] = 1.0f;
#pragma unroll
      for (int tl = 1; tl < kSub; ++tl) E[tl] = E[tl - 1] * wv[tl - 1];
      F[kSub - 1] = 1.0f;
#pragma unroll
      for (int tl = kSub - 2; tl >= 0; --tl) F[tl] = F[tl + 1] * wv[tl + 1];
      if (dd == 0) PROF_MARK(17);
      float Cd = gpv(0, d, ch) * gpv(d + 1, 4, ch) * rowsum[ch];
      if (d == 1 || d == 2) {
        const float* mm = d == 1 ? m1 : m2;
        Cd += (mm[ch] + mm[64 + ch]) + (mm[128 + ch] + mm[192 + ch]);
      }
      for (int e = d + 1; e < 4; ++e)
        Cd += gpv(0, d, ch) * gpv(d + 1, e, ch) * rho[e * 64 + ch];
      for (int e = 0; e < d; ++e)
        Cd += gpv(d + 1, 4, ch) * gpv(e + 1, d, ch) * phi[e * 64 + ch];
      // forward: U_tau = sum_{s<t} dA_tau,s k_s P(s+1, t-1)
      float U[kSub], dwp[kSub];
      float Gk = 0.0f;
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl) U[tl] = 0.0f;
#pragma unroll
      for (int tl = 0; tl < kSub; ++tl) {
        const int t = d * kSub + tl;
        float hr = 0.0f;   // sum_{tau>t} P(t+1, tau-1) r_tau U_tau
#pragma unroll
        for (int tau = kSub - 1; tau > tl; --tau)
          hr = fmaf(wv[tau], hr, rv[tau] * U[tau]);
        const float ct = blk[tl * 16 + tl];
        du = fmaf(ct, rv[tl] * kv[tl], du);
        if (t < n)
          store(drg + t * a.drs.t,
                E[tl] * fx[t * kXP + ch] + U[tl] + ct * (uc * kv[tl]));
        dwp[tl] = E[tl] * F[tl] * Cd + F[tl] * Gk + hr;
        Gk = fmaf(wv[tl], Gk, kv[tl] * fk[t * 64 + ch]);
#pragma unroll
        for (int tau = tl + 1; tau < kSub; ++tau)
          U[tau] = fmaf(wv[tl], U[tau], blk[tau * 16 + tl] * kv[tl]);
      }
      if (dd == 0) PROF_MARK(18);
      // backward: dk's block by Horner sums, Qx, dw
      float Qx = 0.0f;
#pragma unroll
      for (int sl = kSub - 1; sl >= 0; --sl) {
        const int s = d * kSub + sl;
        float hk = 0.0f;   // sum_{t>s} dA_t,s r_t P(s+1, t-1)
#pragma unroll
        for (int t = kSub - 1; t > sl; --t)
          hk = fmaf(wv[t], hk, blk[t * 16 + sl] * rv[t]);
        if (s < n) {
          const float cs = blk[sl * 16 + sl];
          store(dkg + s * a.dks.t,
                F[sl] * fk[s * 64 + ch] + hk + cs * (uc * rv[sl]));
          store(dwg + s * a.dws.t, dwp[sl] + E[sl] * Qx);
        }
        Qx = fmaf(wv[sl], Qx, rv[sl] * fx[s * kXP + ch]);
      }
      if (dd == 0) PROF_MARK(19);
    }
    dus[hh * 64 + ch] = du;
    __syncthreads();
    if (valid && tid < 64)
      a.du[((long long)bh * nc + c) * 64 + tid] = dus[tid] + dus[64 + tid];
  }
  PROF_MARK(20);
}

template <typename TW, int NJ>
int launch_state(const Args<TW>& a, int B, cudaStream_t stream) {
  using L = StateSmem<TW, NJ>;
  static std::atomic<unsigned long long> allowed{0};
  const int err =
      sm90::allow_smem(wkv_bwd_state_kernel<TW, NJ>, L::kSmem, allowed);
  if (err != 0) return err;
  wkv_bwd_state_kernel<TW, NJ>
      <<<dim3(B * a.H, 64 / NJ, 2), kThreads, L::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* dy, const float* u, const float* s0,
           const float* ds_final, void* dr, void* dk, void* dv, void* dw,
           float* du, float* ds0, float* sc, float* dse, int B, int H,
           int T_len, const long long* st, int nj, cudaStream_t stream) {
  Args<TW> a;
  a.r = static_cast<const bf16*>(r);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.w = static_cast<const TW*>(w);
  a.dy = static_cast<const bf16*>(dy);
  a.u = u;
  a.s0 = s0;
  a.ds_final = ds_final;
  a.dr = static_cast<bf16*>(dr);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.dw = static_cast<TW*>(dw);
  a.du = du;
  a.ds0 = ds0;
  a.sc = sc;
  a.dse = dse;
  a.H = H;
  a.T_len = T_len;
  Strides* ss[9] = {&a.rs, &a.ks, &a.vs, &a.ws, &a.gs,
                    &a.drs, &a.dks, &a.dvs, &a.dws};
  for (int x = 0; x < 9; ++x)
    *ss[x] = Strides{st[3 * x], st[3 * x + 1], st[3 * x + 2]};
  if (T_len < 1 || (nj != 32 && nj != 64)) return (int)cudaErrorInvalidValue;
  int err = nj == 64 ? launch_state<TW, 64>(a, B, stream)
                     : launch_state<TW, 32>(a, B, stream);
  if (err != 0) return err;
  using L = ChunkSmem<TW>;
  static std::atomic<unsigned long long> allowed{0};
  err = sm90::allow_smem(wkv_bwd_chunk_kernel<TW>, L::kSmem, allowed);
  if (err != 0) return err;
  const int nc = (T_len + kL - 1) / kL;
  wkv_bwd_chunk_kernel<TW><<<dim3((nc + kWgs - 1) / kWgs, B * H),
                             kWgs * kThreads, L::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// r, k, v, dy, dr, dk, dv bfloat16; wdtype (w, dw): 0 = float32, 1 =
// bfloat16.  u [H, 64], s0, ds_final and ds0 [B, H, 64, 64] contiguous
// float32; s0 and ds_final may be null (zeros).  du: [B, H, ceil(T/64),
// 64] float32 partials, one row per chunk; sc, dse: B H ceil(T/64) x 16 KB
// of scratch each (a chunk's state as split bf16 tiles).  strides: 27 element strides (batch, head, time)
// of r, k, v, w, dy, dr, dk, dv, dw in that order; base addresses and
// strides of r, k, v, w, dy 16-byte aligned.  T >= 1; nj = 32 or 64
// columns a state-pass block.  Two launches (the state pass, the chunk
// pass) on ``stream``.  Returns a cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for a w type, T or nj it does not take.
int wkv_bwd_chunk_launch(int wdtype, const void* r, const void* k,
                         const void* v, const void* w, const void* dy,
                         const float* u, const float* s0,
                         const float* ds_final, void* dr, void* dk, void* dv,
                         void* dw, float* du, float* ds0, float* sc,
                         float* dse, int B, int H, int T,
                         const long long* strides, int nj, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wdtype == 0)
    return launch<float>(r, k, v, w, dy, u, s0, ds_final, dr, dk, dv, dw, du,
                         ds0, sc, dse, B, H, T, strides, nj, s);
  if (wdtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, dy, u, s0, ds_final, dr, dk, dv,
                                 dw, du, ds0, sc, dse, B, H, T, strides, nj,
                                 s);
  return (int)cudaErrorInvalidValue;
}

const char* wkv_bwd_chunk_error_string(int err) {
  return sm90::error_string(err);
}

#ifdef WKV_BWD_PROFILE
// Copies the profiling build's first n marks to host memory.
int wkv_bwd_profile_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_wkv_bwd_prof, n * sizeof(long long));
}
#endif

}  // extern "C"
