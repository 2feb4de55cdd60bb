// Flash-attention backward for Hopper (sm_90a), hand-written CUDA: the
// float32 path.
//
// Replaces the JAX package's Pallas TPU kernels
// src/repro/kernels/flash_attention/flash_attention_bwd.py::
// flash_attention_bwd_bhtd (_dq_kernel, pl.pallas_call at :151, and
// _dkdv_kernel, at :172) for float32 inputs; bf16 inputs go to
// flash_attention_bwd_sm90.cu (wgmma on the tensor cores, which would round
// float32 to TF32).  Same function, from the forward's saved
// log-sum-exp: with s = q.k^T * scale (scale 1/sqrt(hd)), the forward's
// masks (causal: key > query; window w > 0: key <= query - w; keys past Tk),
// p = exp(s - lse) (0 where masked) and delta = rowsum(dO o o) (computed by
// the wrapper in float32, as JAX computes it outside Pallas, :144):
//   dp = dO.v^T,  ds = p o (dp - delta) * scale,
//   dq = ds.k,    dk = ds^T.q,    dv = p^T.dO.
// lse is the forward kernel's m + log(max(l, 1e-30)) over *scaled* scores
// (flash_attention.cu), so s is formed the same way: dot product, then
// times scale.  Key j sits at position j and query row i at q_offset + i
// (the forward's positions); a key tile that no query reaches (past the
// last query, under the causal mask) gets zero dk and dv.  GQA: query
// head h reads key/value head h / (H / Hkv); dk and dv are summed over
// the group's query heads in float32 (JAX keeps
// per-query-head [B, H, Tk, hd] intermediates rounded to the input type
// and sums them afterwards, :178-179, :188-189).
//
// What bounds it on this card.  The function's work is five products per
// reachable (query, key) pair and query head (s, dp, dq, dk, dv), 10 * hd
// operations, against reading q, k, v, o, dO and lse once and writing dq,
// dk, dv once.  For one causal qwen3-0.6b layer (H 16, Hkv 8, hd 128) at
// B = 1, T = 2048: 42.97 GFLOP, 0.6414 ms at the 67 TFLOP/s of float32 FMAs
// against 50.5 MB, 0.0151 ms at 3.35 TB/s: bound by operations.  As in the
// forward (flash_attention.cu), products stay float32 FMAs, which reach
// their rate only if each float read from shared memory feeds 4 FMAs and
// enough warps hide the loads.
//
// What the design does about that (pieces in flash_attention_f32.cuh).
// Two kernels on the same stream, each recomputing s and dp (14 hd
// operations a pair, 1.4x the function's count, for no atomics):
//   dq:    one block per (query tile, query head, batch row), a loop over
//          the key tiles it can reach.  Two halves of the block: lanes of
//          the first form s (8 query rows x 8 keys a lane, then p), of the
//          second dp on the same positions (then ds, from p in shared
//          memory); then every lane adds ds.k to its 8 x 8 of dq.
//   dk/dv: one block per (64-key tile, key/value head, batch row, share),
//          a loop over the group's query heads and the query tiles that
//          reach the key tile.  The first half forms s^T (keys x queries)
//          then p, and adds ds^T.q to its 8 keys x (8 or 16) columns of
//          dk; the second forms dp^T then ds, and adds p^T.dO to dv.
//          Where the key tiles, key/value heads and batch rows give fewer
//          blocks than twice the SMs' slots, the (head, query tile) items
//          of each key tile are cut into ``split`` consecutive shares, one
//          a block; each share's sums go to a float32 scratch and
//          flash_bwd_sum_kernel adds the shares in order.
// Every product is a register tile fed by 16-byte loads from unpadded,
// XOR-swizzled tiles: 8 x 8 (4 FMAs per float read) everywhere except the
// score tiles at hd 256 (8 x 4: 2.67; there the dk/dv lanes hold 8 x 16 dk
// or dv sums, 5.33 in their update).  The streamed tiles (K and V for dq,
// Q and dO for dk/dv) come by cp.async (16 bytes, .cg) into rings of two
// stages: tile j + 1 is copied during all of tile j's products.  Tiles the
// causal or window mask rules out for a whole block are skipped.  The
// backward is deterministic: no atomics; every element of dq, dk, dv (and
// of each share's scratch) is written once, by one lane, and shares are
// summed in a fixed order.
//
// The count behind the tiles (per block; an SM has 233,472 bytes of shared
// memory, 1,024 of them reserved per block, and 65,536 registers):
//   dq    hd   threads  BQ x BK   slices  shared (Q, dO, 2 x (K, V), ds)   blocks/SM  warps
//         64   128      128 x 32    1     32 + 32 + 32 + 16 KiB = 114,688     2         8
//         128  256      128 x 32    2     64 + 64 + 64 + 16 KiB = 212,992     1         8
//         256  256       64 x 16    4     64 + 64 + 64 + 4 KiB = 200,704      1         8
//   dk/dv hd   threads  BK x BQ   slices  shared (K, V, 2 x (Q, dO), p, ds)
//         64   128       64 x 32    2     32 + 32 + 16 KiB = 81,920           2         8
//         128  256       64 x 64    2     64 + 128 + 32 KiB = 229,376         1         8
//         256  256       64 x 16    4     128 + 64 + 8 KiB = 204,800          1         8
// At hd 256 the 128 KiB of Q and dO (dq) or K and V (dk/dv) leave 16-row
// stages, and so score tiles of 8 x 4.  A lane holds 64 (dk/dv at hd 256:
// 128) sums, a score tile of 64 (32) and its operands: under the 255
// registers a lane may hold, with nothing spilled (ptxas's count:
// chip_smoke.py's build phase).
//
// The kernels take element strides for q, k, v, dO, dq, dk and dv (the
// innermost dimension contiguous, rows 16-byte aligned), so the model's
// [B, T, H, hd] layout needs no copy; lse and delta are contiguous
// [B, H, Tq] float32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "flash_attention_f32.cuh"

namespace {

// Element strides (batch, head, time) of q, k, v, dO, dq, dk, dv.
struct Strides {
  long long q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3];
};

template <int HD>
struct Dq {
  static constexpr int kThreads = HD == 64 ? 128 : 256;
  static constexpr int kMinBlocks = HD == 64 ? 2 : 1;
  static constexpr int kBQ = HD == 256 ? 64 : 128;   // query rows a block
  static constexpr int kTB = HD == 256 ? 4 : 8;      // keys a score lane
  static constexpr int kNB = 4;                      // keys kg + 4 j
  static constexpr int kBK = kNB * kTB;              // keys a stage
  static constexpr int kS = HD / 64 == 1 ? 1 : HD / 64 == 2 ? 2 : 4;
  static constexpr int kRows = 8 / kS;               // rows a lane keeps
  static constexpr int kSmem = 4 * (2 * kBQ * HD + 4 * kBK * HD + kBK * kBQ);
  static_assert(kThreads / 2 == kNB * kS * kBQ / 8 &&
                kBQ * HD / 64 == kThreads, "lanes of both phases");
};

template <int HD>
struct Dkv {
  static constexpr int kThreads = HD == 64 ? 128 : 256;
  static constexpr int kMinBlocks = HD == 64 ? 2 : 1;
  static constexpr int kBK = 64;                     // key rows a block
  static constexpr int kBQ = HD == 64 ? 32 : HD == 128 ? 64 : 16;
  static constexpr int kTQ = HD == 256 ? 4 : 8;      // queries a score lane
  static constexpr int kNB = kBQ / kTQ;              // queries qg + kNB j
  static constexpr int kS = HD == 256 ? 4 : 2;
  static constexpr int kRows = 8 / kS;               // keys a lane keeps
  static constexpr int kNC = HD == 256 ? 4 : 2;      // output chunks a lane
  static constexpr int kCG = HD / 4 / kNC;           // output chunk groups
  static constexpr int kSmem =
      4 * (2 * kBK * HD + 4 * kBQ * HD + 2 * kBQ * kBK);
  static_assert(kThreads / 2 == kNB * 8 * kS && kThreads / 2 == 8 * kCG,
                "lanes of both phases");
};

// R consecutive floats (8, 4 or 2) from float 4 c + off of a row stored
// with swizzle sw (sw1 tiles), to or from x.
template <int R>
__device__ __forceinline__ void put(float* row, int c, int off, int sw,
                                    const float* x) {
  if constexpr (R == 8) {
    fa32::sts4(row + 4 * (c ^ sw), make_float4(x[0], x[1], x[2], x[3]));
    fa32::sts4(row + 4 * ((c + 1) ^ sw), make_float4(x[4], x[5], x[6], x[7]));
  } else if constexpr (R == 4) {
    fa32::sts4(row + 4 * (c ^ sw), make_float4(x[0], x[1], x[2], x[3]));
  } else {
    *reinterpret_cast<float2*>(row + 4 * (c ^ sw) + off) =
        make_float2(x[0], x[1]);
  }
}
template <int R>
__device__ __forceinline__ void get(const float* row, int c, int off, int sw,
                                    float* x) {
  if constexpr (R == 8) {
    const float4 a = fa32::lds4(row + 4 * (c ^ sw));
    const float4 b = fa32::lds4(row + 4 * ((c + 1) ^ sw));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (R == 4) {
    const float4 a = fa32::lds4(row + 4 * (c ^ sw));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(row + 4 * (c ^ sw) + off);
    x[0] = a.x; x[1] = a.y;
  }
}

// Query rows past Tq, and the causal or window mask and keys past Tk, with
// positions from 0 (a caller with a query offset shifts the keys and Tk
// by it instead: the dq kernel has no register to spare for it).
__device__ __forceinline__ bool masked(int qpos, int kpos, int Tq, int Tk,
                                       int causal, int window) {
  return qpos >= Tq || sm90::hidden(qpos, kpos, Tk, causal, window);
}

// The (head, query tile) items of one key tile of the dk/dv kernel: the
// group's heads x the query tiles [q_begin, q_begin + nq BQ) that reach
// keys [k0, k0 + BK) (none past the last query).
template <int HD>
__device__ __forceinline__ void kv_items(int k0, int Tq, int causal,
                                         int window, int q_offset,
                                         int* q_begin, int* nq) {
  constexpr int BQ = Dkv<HD>::kBQ, BK = Dkv<HD>::kBK;
  const int qb = causal ? (max(0, k0 - q_offset) / BQ) * BQ : 0;
  const int qe =
      window > 0 ? min(Tq, max(0, k0 + BK + window - 1 - q_offset)) : Tq;
  *q_begin = qb;
  *nq = qe > qb ? (qe - qb + BQ - 1) / BQ : 0;
}

// dq: one block per (query head, batch row, query tile x share), query
// tiles heaviest first.
template <int HD>
dim3 dq_grid(int B, int H, int Tq, int split) {
  return dim3(H, B, (Tq + Dq<HD>::kBQ - 1) / Dq<HD>::kBQ * split);
}
// dk/dv: one block per (key/value head x share, batch row, key tile).
template <int HD>
dim3 dkdv_grid(int B, int Hkv, int Tk, int split) {
  return dim3(Hkv * split, B, (Tk + Dkv<HD>::kBK - 1) / Dkv<HD>::kBK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Dq<HD>::kThreads, Dq<HD>::kMinBlocks)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Hkv, int Tq, int Tk, Strides st, int causal,
                    int window, float scale, int split,
                    float* __restrict__ part, int q_offset) {
  static_assert(sizeof(T) == 4, "the float32 path");
  using C = Dq<HD>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kS, R = C::kRows;
  constexpr int NT = C::kThreads, TB = C::kTB, L = HD / 4 / S;
  extern __shared__ uint8_t smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BQ][HD] sw2
  float* Os = Qs + BQ * HD;                         // dO [BQ][HD] sw2
  float* Ks = Os + BQ * HD;                         // 2 x [BK][HD] sw1
  float* Vs = Ks + 2 * BK * HD;                     // 2 x [BK][HD] sw1
  float* Ps = Vs + 2 * BK * HD;                     // p, then ds: [BK][BQ]

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int share = blockIdx.z % split;
  const int q0 = (gridDim.z / split - 1 - blockIdx.z / split) * BQ;
  const int hk = h / (H / Hkv);
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

  // Score lanes (each half): keys kg + 4 j, rows 8 sr + i, head-width
  // slice ds; after the slice sum rows 8 sr + ko + i (i < R).  Half 0 forms
  // s from Q and K, half 1 dp from dO and V.  dq lanes: rows 4 rg + i and
  // BQ / 2 + 4 rg + i, columns of chunks cg and cg + HD / 8.
  const int half = tid / (NT / 2);
  const int tt = tid % (NT / 2);
  const int kg = tt & 3;
  const int ds = (tt >> 3) & (S - 1);
  const int sr = ((tt >> 2) & 1) | ((tt >> (3 + fa32::log2i(S))) << 1);
  const int ko = fa32::kept_offset<8, S>(ds);
  const int cg = tid % (HD / 8);
  const int rg = tid / (HD / 8);

  // Key tiles that some row of this block (positions q_offset + q0 ..
  // q_offset + q0 + BQ - 1) reaches; this share's part.
  const int k_end = causal ? min(Tk, q_offset + q0 + BQ) : Tk;
  int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_all = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int t_begin = share * n_all / split;
  const int n_tiles = (share + 1) * n_all / split - t_begin;
  k_begin += t_begin * BK;

  fa32::load_rows<HD, BQ, NT, true>(Qs, q + b * st.q[0] + h * st.q[1],
                                    st.q[2], q0, Tq, tid);
  fa32::load_rows<HD, BQ, NT, true>(Os, dout + b * st.dout[0] +
                                    h * st.dout[1], st.dout[2], q0, Tq, tid);
  if (n_tiles > 0) {
    fa32::load_rows<HD, BK, NT, false>(Ks, kb, st.k[2], k_begin, Tk, tid);
    fa32::load_rows<HD, BK, NT, false>(Vs, vb, st.v[2], k_begin, Tk, tid);
  }
  sm90::cp_async_commit();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    const int stage = it & 1;
    sm90::cp_async_wait_all();   // stage `stage` landed
    __syncthreads();             // ... for all; tile it - 1 consumed
    if (it + 1 < n_tiles) {
      fa32::load_rows<HD, BK, NT, false>(Ks + (stage ^ 1) * BK * HD, kb,
                                         st.k[2], k0 + BK, Tk, tid);
      fa32::load_rows<HD, BK, NT, false>(Vs + (stage ^ 1) * BK * HD, vb,
                                         st.v[2], k0 + BK, Tk, tid);
    }
    sm90::cp_async_commit();

    float s[8][TB];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TB; ++j) s[i][j] = 0.0f;
    fa32::dot_tile<HD, 8, TB, 4, L, TB == 8 ? 2 : 8>(
        s, half ? Os : Qs, 8 * sr, sr & 7, (half ? Vs : Ks) + stage * BK * HD,
        kg, ds * L);
    fa32::reduce_slices<8, TB, S>(s, ds);
    // lse (half 0) or delta (half 1) of the lane's kept rows.
    float rowv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + 8 * sr + ko + i;
      rowv[i] = qpos < Tq ? (half ? delta : lse)[((long long)b * H + h) * Tq +
                                                  qpos]
                          : 0.0f;
    }

    // The mask in the block's own row indices: the tile's keys and Tk
    // shifted by the query offset.
    const int kq = k0 - q_offset;
    const bool edge = k0 + BK > Tk || (causal && kq + BK - 1 > q0) ||
                      (window > 0 && kq <= q0 + BQ - 1 - window);
    const int c = (8 * sr + ko) >> 2;
    if (half == 0) {
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        float x[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int qpos = q0 + 8 * sr + ko + i;
          x[i] = edge && masked(qpos, kq + kg + 4 * j, Tq, Tk - q_offset,
                                causal, window)
                     ? 0.0f
                     : expf(s[i][j] * scale - rowv[i]);
        }
        put<R>(Ps + (kg + 4 * j) * BQ, c, ko & 3, kg ^ (4 * (j & 1)), x);
      }
    }
    __syncthreads();   // p complete
    if (half == 1) {
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        float* prow = Ps + (kg + 4 * j) * BQ;
        const int sw = kg ^ (4 * (j & 1));
        float x[R];
        get<R>(prow, c, ko & 3, sw, x);
#pragma unroll
        for (int i = 0; i < R; ++i) x[i] = x[i] * (s[i][j] - rowv[i]) * scale;
        put<R>(prow, c, ko & 3, sw, x);
      }
    }
    __syncthreads();   // ds complete
    fa32::update<BK, BQ, BQ / 8, HD, 2, HD / 8>(acc, Ps, rg,
                                                Ks + stage * BK * HD, cg);
  }
  sm90::cp_async_wait_all();

  // dq, or this share's sums: [split][B][H][Tq][HD].
  T* out = dq + b * st.dq[0] + h * st.dq[1];
  long long rstride = st.dq[2];
  if (split > 1) {
    out = part + (((long long)share * gridDim.y + b) * H + h) * Tq * HD;
    rstride = HD;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + (i < 4 ? 4 * rg + i : BQ / 2 + 4 * rg + i - 4);
    if (row >= Tq) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      fa32::sts4(out + row * rstride + 4 * cg + u * (HD / 2),
                 make_float4(acc[i][4 * u], acc[i][4 * u + 1],
                             acc[i][4 * u + 2], acc[i][4 * u + 3]));
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Dkv<HD>::kThreads, Dkv<HD>::kMinBlocks)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, float* __restrict__ part, int H,
                      int Hkv, int Tq, int Tk, Strides st, int causal,
                      int window, float scale, int split, int q_offset) {
  static_assert(sizeof(T) == 4, "the float32 path");
  using C = Dkv<HD>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kS, R = C::kRows;
  constexpr int NT = C::kThreads, TQ = C::kTQ, NB = C::kNB, NC = C::kNC;
  constexpr int CG = C::kCG, L = HD / 4 / S;
  extern __shared__ uint8_t smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [BK][HD] sw2
  float* Vs = Ks + BK * HD;                         // [BK][HD] sw2
  float* Qs = Vs + BK * HD;                         // 2 x [BQ][HD] sw1
  float* Os = Qs + 2 * BQ * HD;                     // dO: 2 x [BQ][HD] sw1
  float* Pb = Os + 2 * BQ * HD;                     // p [BQ][BK] sw1
  float* Sb = Pb + BQ * BK;                         // ds [BQ][BK] sw1

  const int tid = threadIdx.x;
  const int hk = blockIdx.x / split;
  const int g = blockIdx.x % split;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BK;
  const int group = H / Hkv;

  // Score lanes (each half): queries qg + NB j, keys 8 kr + i, slice ds;
  // after the slice sum keys 8 kr + ko + i (i < R).  Half 0 forms s^T from
  // K and Q, then p, and sums dk; half 1 forms dp^T from V and dO, then
  // ds, and sums dv.  Sum lanes: keys 4 ka + i and BK / 2 + 4 ka + i,
  // columns of chunks cg + CG u.
  constexpr int kQB = fa32::log2i(NB);
  const int half = tid / (NT / 2);
  const int tt = tid % (NT / 2);
  const int qg = tt & (NB - 1);
  const int ds = (tt >> 3) & (S - 1);
  const int kr = ((tt >> kQB) & ((1 << (3 - kQB)) - 1)) |
                 ((tt >> (3 + fa32::log2i(S))) << (3 - kQB));
  const int ko = fa32::kept_offset<8, S>(ds);
  const int cg = tt % CG;
  const int ka = tt / CG;

  int q_begin, nq;
  kv_items<HD>(k0, Tq, causal, window, q_offset, &q_begin, &nq);
  const int n_items = group * nq;
  const int share = (n_items + split - 1) / split;
  const int i_begin = min(n_items, g * share);
  const int i_end = min(n_items, i_begin + share);

  const T* qh = q + b * st.q[0] + hk * group * st.q[1];
  const T* oh = dout + b * st.dout[0] + hk * group * st.dout[1];
  fa32::load_rows<HD, BK, NT, true>(Ks, k + b * st.k[0] + hk * st.k[1],
                                    st.k[2], k0, Tk, tid);
  fa32::load_rows<HD, BK, NT, true>(Vs, v + b * st.v[0] + hk * st.v[1],
                                    st.v[2], k0, Tk, tid);
  if (i_begin < i_end) {
    const int hh = i_begin / nq, q0 = q_begin + (i_begin % nq) * BQ;
    fa32::load_rows<HD, BQ, NT, false>(Qs, qh + hh * st.q[1], st.q[2], q0,
                                       Tq, tid);
    fa32::load_rows<HD, BQ, NT, false>(Os, oh + hh * st.dout[1], st.dout[2],
                                       q0, Tq, tid);
  }
  sm90::cp_async_commit();

  float acc[8][4 * NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.0f;

  for (int item = i_begin; item < i_end; ++item) {
    const int stage = (item - i_begin) & 1;
    const int hh = item / nq;
    const int q0 = q_begin + (item % nq) * BQ;
    sm90::cp_async_wait_all();   // stage `stage` landed
    __syncthreads();             // ... for all; the last item consumed
    if (item + 1 < i_end) {
      const int hn = (item + 1) / nq;
      const int qn = q_begin + ((item + 1) % nq) * BQ;
      fa32::load_rows<HD, BQ, NT, false>(Qs + (stage ^ 1) * BQ * HD,
                                         qh + hn * st.q[1], st.q[2], qn, Tq,
                                         tid);
      fa32::load_rows<HD, BQ, NT, false>(Os + (stage ^ 1) * BQ * HD,
                                         oh + hn * st.dout[1], st.dout[2],
                                         qn, Tq, tid);
    }
    sm90::cp_async_commit();

    // lse (half 0) or delta (half 1) of the lane's queries.
    const long long rbase = ((long long)b * H + hk * group + hh) * Tq;
    float s[8][TQ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TQ; ++j) s[i][j] = 0.0f;
    fa32::dot_tile<HD, 8, TQ, NB, L, HD == 256 ? 1 : 2>(
        s, half ? Vs : Ks, 8 * kr, kr & 7, (half ? Os : Qs) + stage * BQ * HD,
        qg, ds * L);
    fa32::reduce_slices<8, TQ, S>(s, ds);
    float colv[TQ];
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const int qpos = q0 + qg + NB * j;
      colv[j] = qpos < Tq ? (half ? delta : lse)[rbase + qpos] : 0.0f;
    }

    const bool edge = q0 + BQ > Tq || k0 + BK > Tk ||
                      (causal && k0 + BK - 1 > q_offset + q0) ||
                      (window > 0 && k0 <= q_offset + q0 + BQ - 1 - window);
    const int c = (8 * kr + ko) >> 2;
    if (half == 0) {
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int ql = qg + NB * j;
        float x[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          x[i] = edge && masked(q0 + ql, k0 - q_offset + 8 * kr + ko + i, Tq,
                                Tk - q_offset, causal, window)
                     ? 0.0f
                     : expf(s[i][j] * scale - colv[j]);
        put<R>(Pb + ql * BK, c, ko & 3, ql & 7, x);
      }
    }
    __syncthreads();   // p complete
    if (half == 1) {
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int ql = qg + NB * j;
        float x[R];
        get<R>(Pb + ql * BK, c, ko & 3, ql & 7, x);
#pragma unroll
        for (int i = 0; i < R; ++i) x[i] = x[i] * (s[i][j] - colv[j]) * scale;
        put<R>(Sb + ql * BK, c, ko & 3, ql & 7, x);
      }
    }
    __syncthreads();   // ds complete
    fa32::update<BQ, BK, BK / 8, HD, NC, CG>(
        acc, half ? Pb : Sb, ka, (half ? Os : Qs) + stage * BQ * HD, cg);
  }
  sm90::cp_async_wait_all();

  // dk (half 0) or dv (half 1): keys 4 ka + i and BK / 2 + 4 ka + i.
  T* out = half ? dv + b * st.dv[0] + hk * st.dv[1]
                : dk + b * st.dk[0] + hk * st.dk[1];
  long long rstride = half ? st.dv[2] : st.dk[2];
  if (split > 1) {   // this share's sums, [2][split][B][Hkv][Tk][HD]
    out = part + ((((long long)half * split + g) * gridDim.y + b) * Hkv + hk)
                     * Tk * HD;
    rstride = HD;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + (i < 4 ? 4 * ka + i : BK / 2 + 4 * ka + i - 4);
    if (key >= Tk) continue;
#pragma unroll
    for (int u = 0; u < NC; ++u)
      fa32::sts4(out + key * rstride + 4 * (cg + CG * u),
                 make_float4(acc[i][4 * u], acc[i][4 * u + 1],
                             acc[i][4 * u + 2], acc[i][4 * u + 3]));
  }
}

// An output (dq, dk or dv, [B][N][Tn][HD] with element strides s0, s1, s2)
// from its shares' float32 sums ([split][B][N][Tn][HD]): each 16-byte chunk
// summed over the shares in order.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int B, int N, int Tn, long long s0, long long s1,
                     long long s2, int split) {
  constexpr int kChunks = HD / 4;
  const long long rows = (long long)B * N * Tn;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < rows * kChunks;
       e += (long long)gridDim.x * 256) {
    const long long row = e / kChunks;   // (b N + n) Tn + t
    const int c = e % kChunks;
    const float* src = part + row * HD + 4 * c;
    float4 sum = fa32::lds4(src);
    for (int g = 1; g < split; ++g) {
      const float4 x = fa32::lds4(src + g * rows * HD);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int t = row % Tn;
    const int n = (row / Tn) % N;
    const int b = row / ((long long)Tn * N);
    fa32::sts4(out + b * s0 + n * s1 + t * s2 + 4 * c, sum);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int B, int H, int Hkv, int Tq, int Tk,
           const long long* s, int causal, int window, float scale,
           int split, float* part, int dq_split, float* dq_part,
           int q_offset, cudaStream_t stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.dout[i] = s[9 + i];
    st.dq[i] = s[12 + i];
    st.dk[i] = s[15 + i];
    st.dv[i] = s[18 + i];
  }
  if (split < 1 || (split > 1 && part == nullptr) || dq_split < 1 ||
      (dq_split > 1 && dq_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(dout);
  // One output from its n shares' sums (flash_bwd_sum_kernel).
  auto sum_shares = [&](const float* p, void* out, int N, int Tn,
                        const long long* os, int n) {
    const long long chunks = (long long)B * N * Tn * (HD / 4);
    const int blocks =
        chunks / 256 + 1 < 1056 ? (int)(chunks / 256 + 1) : 1056;
    flash_bwd_sum_kernel<T, HD><<<blocks, 256, 0, stream>>>(
        p, static_cast<T*>(out), B, N, Tn, os[0], os[1], os[2], n);
    return cudaGetLastError();
  };

  constexpr int dq_bytes = Dq<HD>::kSmem;
  auto dq_kernel = flash_bwd_dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dq_grid<HD>(B, H, Tq, dq_split), Dq<HD>::kThreads, dq_bytes,
              stream>>>(tq, tk, tv, to, lse, delta, static_cast<T*>(dq), H,
                        Hkv, Tq, Tk, st, causal, window, scale, dq_split,
                        dq_part, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dq_split > 1) {
    err = sum_shares(dq_part, dq, H, Tq, st.dq, dq_split);
    if (err != cudaSuccess) return (int)err;
  }

  constexpr int kv_bytes = Dkv<HD>::kSmem;
  auto kv_kernel = flash_bwd_dkdv_kernel<T, HD>;
  err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<dkdv_grid<HD>(B, Hkv, Tk, split), Dkv<HD>::kThreads, kv_bytes,
              stream>>>(tq, tk, tv, to, lse, delta, static_cast<T*>(dk),
                        static_cast<T*>(dv), part, H, Hkv, Tq, Tk, st,
                        causal, window, scale, split, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  err = sum_shares(part, dk, Hkv, Tk, st.dk, split);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_shares(part + (long long)split * B * Hkv * Tk * HD, dv, Hkv,
                         Tk, st.dv, split);
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// float32 q, k, v, dO, dq, dk, dv; hd 64, 128 or 256.  strides: 21 element
// strides (batch, head, time) of q, k, v, dO, dq, dk, dv in that order.
// lse and delta: contiguous [B, H, Tq] float32.  split: the shares each
// key tile's dk/dv items are cut into (1: the dk/dv kernel writes dk and
// dv; > 1: part is a float32 scratch of 2 x split x B x Hkv x Tk x hd
// floats, and flash_bwd_sum_kernel adds the shares); dq_split, dq_part: the
// same for each query tile's key tiles in the dq kernel (dq_part: dq_split
// x B x H x Tq x hd floats).  q_offset: the position of query row 0 (keys
// from 0).  Launches the dq kernel (and its sum), then
// the dk/dv kernel (and its sums) on ``stream``.  Returns a cudaError_t (0
// on success); 1 (cudaErrorInvalidValue) for an hd the kernels have no
// instantiation for or a split without its scratch.
int flash_attention_bwd_launch(int hd, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* delta,
                               void* dq, void* dk, void* dv, int B, int H,
                               int Hkv, int Tq, int Tk,
                               const long long* strides, int causal,
                               int window, float scale, int split,
                               float* part, int dq_split, float* dq_part,
                               int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                             Hkv, Tq, Tk, strides, causal, window, scale,
                             split, part, dq_split, dq_part, q_offset, s);
  if (hd == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                              Hkv, Tq, Tk, strides, causal, window, scale,
                              split, part, dq_split, dq_part, q_offset, s);
  if (hd == 256)
    return launch<float, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                              Hkv, Tq, Tk, strides, causal, window, scale,
                              split, part, dq_split, dq_part, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
