// Building blocks of the float32 flash-attention kernels
// (flash_attention.cu, the forward; flash_attention_bwd.cu, the backward):
// float32 tiles in shared memory, filled by cp.async, and register tiles of
// 8 x 8 (or 8 x 4, 8 x 16) products fed by 16-byte shared loads.
//
// Tiles.  A tile is R rows of W floats, each row W / 4 chunks of 16 bytes.
// Chunk c of row r is stored at chunk c ^ swz(r), where swz is either
// r & 7 (sw1) or (r ^ (r >> 3)) & 7 (sw2): rows are not padded, and the 8
// lanes of a quarter warp, which one 16-byte load serves together, read 8
// different bank groups wherever they read different rows at one logical
// chunk (sw1: rows that differ in r & 7; sw2: also rows 8 a + i and
// 8 a' + i of two row groups a, a').  Because swz(r) < 8 and a lane steps
// through chunks in runs of 8 aligned ones, the physical chunk of logical
// chunk 8 m + c is 8 m + (c ^ swz(r)): one XOR with the lane's own part of
// the swizzle per load (dot_tile), or one of 8 addresses a lane keeps in
// registers plus an immediate (update).
//
// Products.  dot_tile: a lane's s[i][j] (i < TA, j < TB) += A row (a0 + i)
// . B row (b0 + NB j) over a run of chunks (its slice of the head width):
// per chunk, TB + TA 16-byte loads feed 4 TA TB FMAs (8 x 8: 4 FMAs per
// float read).  reduce_slices sums the slices of lanes 8 and 16 apart with
// shuffles, each level halving the A rows a lane keeps, so a slice split
// costs shuffles and no shared memory.  update: a lane's acc[i][4 u + e]
// (i < 8, u < NC) += sum over the rows k of X (chunks xc, xc + XH of row k:
// 8 values) times Y (chunks yc + YG u of row k): per row, 2 + NC loads feed
// 32 NC FMAs.
#pragma once

namespace fa32 {

constexpr float kNegInf = -1.0e30f;

template <bool SW2>
__host__ __device__ __forceinline__ int swz(int r) {
  return SW2 ? ((r ^ (r >> 3)) & 7) : (r & 7);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void sts4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// v, through a register the compiler cannot see through: address tables
// built from it are rebuilt in the phase that uses them, not hoisted out of
// the loops around and held through the other phases (which spilled).
__device__ __forceinline__ int opaque(int v) {
#ifndef SM90_EMULATE
  asm volatile("" : "+r"(v));
#endif
  return v;
}

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// Rows [row0, row0 + R) of one (batch, head) slice (row stride ``stride``
// elements, rows 16-byte aligned) into a tile of W-float rows by cp.async,
// 16 bytes a copy, the NT threads of the block sharing the copies; rows at
// or past n_rows are zeros (stored directly).
template <int W, int R, int NT, bool SW2>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int n_rows, int tid) {
  constexpr int kChunks = W / 4;
#pragma unroll 4
  for (int i = tid; i < R * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    float* d = dst + r * W + ((c ^ swz<SW2>(r)) << 2);
    if (row0 + r < n_rows)
      sm90::cp_async16(d, src + (long long)(row0 + r) * stride + 4 * c);
    else
      sts4(d, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
}

// s[i][j] += A row (a0 + i) . B row (b0 + NB j), summed over the chunks
// [c0, c0 + L) of the rows (c0 and L multiples of 8).  A: rows a0 + i with
// a0 a multiple of 8, stored with swizzle ax ^ i (sw1: ax = 0; sw2:
// ax = (a0 >> 3) & 7).  B: rows b0 + NB j with b0 < NB (NB 2, 4 or 8),
// stored with sw1, whose swizzle is b0 ^ ((NB j) & 7).  Per chunk the TB B
// values are held (TB 16-byte loads) and each A row is loaded once; an
// address is the row's base plus (4 ax or 4 b0) ^ 4 (c ^ the part known at
// compile time).  CU: how far the chunk loop is unrolled (fully, the
// forward's; the backward kernels, whose lanes also hold their dq, dk or
// dv sums, spilled when ptxas filled every register with the next chunks'
// loads, so they unroll it 2 or 1 times).
template <int W, int TA, int TB, int NB, int L, int CU>
__device__ __forceinline__ void dot_tile(float (&s)[TA][TB], const float* A,
                                         int a0, int ax, const float* B,
                                         int b0, int c0) {
  static_assert(L % 8 == 0 && TA == 8, "runs of 8 chunks, 8 A rows");
  a0 = opaque(a0);
  b0 = opaque(b0);
  const float* Ab = A + a0 * W + 4 * c0;
  const float* Bb = B + b0 * W + 4 * c0;
  const int axs = 4 * ax, bxs = 4 * b0;
#pragma unroll
  for (int m = 0; m < L / 8; ++m) {
#pragma unroll CU
    for (int c = 0; c < 8; ++c) {
      float4 bv[TB];
#pragma unroll
      for (int j = 0; j < TB; ++j)
        bv[j] = lds4(Bb + (bxs ^ (4 * (c ^ ((NB * j) & 7)))) + NB * j * W +
                     32 * m);
#pragma unroll
      for (int i = 0; i < TA; ++i) {
        const float4 av = lds4(Ab + (axs ^ (4 * (c ^ i))) + i * W + 32 * m);
#pragma unroll
        for (int j = 0; j < TB; ++j) s[i][j] = dot4(av, bv[j], s[i][j]);
      }
    }
  }
}

#ifndef SM90_EMULATE
// v[i] = the v[i] of the lane ``off`` away (xor), for every i: N shuffles
// with nothing between them.
template <int N>
__device__ __forceinline__ void shfl_xor_n(float (&v)[N], int off) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __shfl_xor_sync(0xffffffffu, v[i], off);
}
#endif

// One level of the slice sum: the lane pair ``off`` apart exchanges halves
// of its rows; the lane with ``hi`` keeps rows [N, 2N) (moved to [0, N)),
// the other rows [0, N).  Each kept value is (own + partner's) once.
template <int TA, int TB, int N>
__device__ __forceinline__ void halve(float (&s)[TA][TB], int hi, int off) {
  float x[N * TB];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j) x[i * TB + j] = hi ? s[i][j] : s[i + N][j];
  shfl_xor_n(x, off);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j)
      s[i][j] = (hi ? s[i + N][j] : s[i][j]) + x[i * TB + j];
}

// Sums the partial tiles of S slices held by the lanes 8 (and 16) apart:
// afterwards rows [0, TA / S) of s hold the lane's kept rows, rows
// kept_offset(ds) + i of its A rows.
template <int TA, int TB, int S>
__device__ __forceinline__ void reduce_slices(float (&s)[TA][TB], int ds) {
  static_assert(S == 1 || S == 2 || S == 4, "1, 2 or 4 slices");
  if constexpr (S >= 2) halve<TA, TB, TA / 2>(s, ds & 1, 8);
  if constexpr (S >= 4) halve<TA, TB, TA / 4>(s, (ds >> 1) & 1, 16);
}
template <int TA, int S>
__host__ __device__ __forceinline__ int kept_offset(int ds) {
  return S == 1 ? 0 : S == 2 ? (TA / 2) * ds
                             : (TA / 2) * (ds & 1) + (TA / 4) * (ds >> 1);
}

// acc[i][4 u + e] += sum over rows k in [0, KR) of x_i(k) y_{4u+e}(k), with
// x_0..3 = X row k chunk xc, x_4..7 = chunk xc + XH, y = Y row k chunks
// yc + YG u (u < NC).  X ([KR][XW]) and Y ([KR][W]) are stored with sw1, so
// row k's swizzle is k & 7.  XH and YG are multiples of 8 (the second X
// chunk is the first plus XH after the swizzle too) or XH is handled by its
// own table.
template <int KR, int XW, int XH, int W, int NC, int YG>
__device__ __forceinline__ void update(float (&acc)[8][4 * NC],
                                       const float* X, int xc,
                                       const float* Y, int yc) {
  static_assert(KR % 8 == 0 && YG % 8 == 0, "aligned runs");
  xc = opaque(xc);
  yc = opaque(yc);
  int tx0[8], tx1[8], ty[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    tx0[v] = 4 * (xc ^ v);
    tx1[v] = XH % 8 == 0 ? tx0[v] + 4 * XH : 4 * ((xc + XH) ^ v);
    ty[v] = 4 * (yc ^ v);
  }
#pragma unroll 1
  for (int k8 = 0; k8 < KR; k8 += 8) {
    const float* xr = X + k8 * XW;
    const float* yr = Y + k8 * W;
#pragma unroll
    for (int kl = 0; kl < 8; ++kl) {
      const float4 x0 = lds4(xr + kl * XW + tx0[kl]);
      const float4 x1 = lds4(xr + kl * XW + tx1[kl]);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const float4 y = lds4(yr + kl * W + ty[kl] + 4 * YG * u);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][4 * u + 0] = fmaf(xv[i], y.x, acc[i][4 * u + 0]);
          acc[i][4 * u + 1] = fmaf(xv[i], y.y, acc[i][4 * u + 1]);
          acc[i][4 * u + 2] = fmaf(xv[i], y.z, acc[i][4 * u + 2]);
          acc[i][4 * u + 3] = fmaf(xv[i], y.w, acc[i][4 * u + 3]);
        }
      }
    }
  }
}

}  // namespace fa32
