// Flash-attention forward for Hopper (sm_90a), hand-written CUDA: the
// float32 path.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhtd
// (_fa_kernel; pl.pallas_call at :130) for float32 inputs; bf16 inputs go to
// flash_attention_sm90.cu (wgmma on the tensor cores, which would round
// float32 to TF32).  Same function: scores in float32
// with scale 1/sqrt(hd); masked entries (causal: key > query; window w > 0:
// key <= query - w; keys past Tk) set to -1e30; an online max and
// denominator per query row; o = acc / max(l, 1e-30) rounded to the input
// type; optionally lse = m + log(max(l, 1e-30)) in float32.  Key j sits
// at position j and query row i at q_offset + i (0: the TPU kernel's
// in-block indices; a rank's block of queries under context parallelism
// passes its first position).  GQA: query head h reads key/value head
// h / (H / Hkv).
//
// What bounds it on this card.  Counting only reachable score entries, the
// work is 4 * hd * H * B * sum(reachable (q, k)) operations against reading
// q, k, v and writing o once: for one causal qwen3-0.6b layer (H 16, Hkv 8,
// hd 128) at B = 1, T = 2048 that is 17.19 GFLOP against 25.2 MB (float32)
// -- 0.2565 ms at the 67 TFLOP/s of float32 FMAs on the CUDA cores against
// 0.0075 ms at 3.35 TB/s: bound by operations.  Every product stays a
// float32 FMA (wgmma would round to TF32, which the float32 tolerances do
// not allow).  An SM issues 128 FMAs a clock but reads only 32 floats a
// clock from shared memory, so an FMA kernel reaches the FMA rate only if
// each float it reads from shared memory feeds at least 4 FMAs, and only
// if enough warps hide the loads.
//
// What the design does about that (flash_attention_f32.cuh holds the
// pieces).
//   * Register tiles of 8 x 8: in S = Q K^T a lane holds 8 query rows x 8
//     keys (kg + 8 j) and per 16-byte chunk of the head width loads 8 key
//     and 8 query chunks for 256 FMAs; in O += P V it holds 8 rows x 8
//     columns and per key loads two chunks of P^T and two of V for 64 FMAs:
//     4 FMAs per float read, all loads 16 bytes wide.  Tiles are not
//     padded: chunks are XOR-swizzled by row, so a quarter warp reads 8
//     bank groups.
//   * The head width is split into S = hd / 64 slices for S = Q K^T, one a
//     lane, so that the 8 x 8 tile fits every width with as many lanes as
//     output tiles; lanes 8 and 16 apart sum their slices by shuffles.
//   * K and V come by cp.async (16 bytes, .cg) into a ring of two stages,
//     one a K tile and one a V tile: V_j is copied while S_j is computed,
//     K_{j+1} while O += P_j V_j is, so every copy overlaps a product.
//   * Key tiles that the causal or window mask rules out for every row of
//     the block are never loaded (about half the work at causal), and query
//     tiles run heaviest first (under the causal mask the last tile reaches
//     the most keys at any q_offset).
//
// The count behind the tiles (per block; an SM has 233,472 bytes of shared
// memory, 1,024 of them reserved per block, and 65,536 registers):
//   hd   threads  BQ x BK  slices  shared memory (Q, K, V, P^T, 2 x BQ)   blocks/SM  warps
//   64   128      128 x 64    1    32 + 16 + 16 + 32 KiB + 1 KiB = 99,328     2        8
//   128  128       64 x 64    2    32 + 32 + 32 + 16 KiB + 0.5  = 115,200     2        8
//   256  256       64 x 64    4    64 + 64 + 64 + 16 KiB + 0.5  = 213,504     1        8
// A lane holds 64 output accumulators, 64 scores, 32 floats of held key
// chunks and the update's 8-entry address tables: within the 255
// registers that 8 warps an SM leave a lane (ptxas uses 254-255 of them,
// the score product's chunk loop fully unrolled), with nothing spilled
// (ptxas's count: chip_smoke.py's build phase).
//
// The kernel takes element strides for q, k, v and o (the innermost
// dimension contiguous, rows 16-byte aligned), so the model's [B, T, H, hd]
// layout and a key/value view of a longer cache need no copy.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "flash_attention_f32.cuh"

namespace {

using fa32::kNegInf;

template <int HD>
struct Fwd {
  static constexpr int kThreads = HD == 256 ? 256 : 128;
  static constexpr int kMinBlocks = HD == 256 ? 1 : 2;
  static constexpr int kBQ = HD == 64 ? 128 : 64;   // query rows a block
  static constexpr int kBK = 64;                    // keys a tile
  static constexpr int kS = HD / 64;                // slices of S = Q K^T
  static constexpr int kRows = 8 / kS;              // score rows a lane keeps
  static constexpr int kSmem =
      4 * (kBQ * HD + 2 * kBK * HD + kBK * kBQ + 2 * kBQ);
  static_assert(kBQ * HD / 64 == kThreads && 8 * kS * kBQ / 8 == kThreads,
                "one 8 x 8 output tile and one 8 x 8 score tile a lane");
};

// One block per (head, batch row, query tile x share); query tiles
// heaviest first.
template <int HD>
dim3 fwd_grid(int B, int H, int Tq, int split) {
  return dim3(H, B, (Tq + Fwd<HD>::kBQ - 1) / Fwd<HD>::kBQ * split);
}

template <typename T, int HD>
__global__ void __launch_bounds__(Fwd<HD>::kThreads, Fwd<HD>::kMinBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                 long long qsb, long long qsh, long long qst, long long ksb,
                 long long ksh, long long kst, long long vsb, long long vsh,
                 long long vst, long long osb, long long osh, long long ost,
                 int causal, int window, float scale, int split,
                 float* __restrict__ part, int q_offset) {
  static_assert(sizeof(T) == 4, "the float32 path");
  using C = Fwd<HD>;
  constexpr int BQ = C::kBQ, BK = C::kBK, S = C::kS, R = C::kRows;
  constexpr int NT = C::kThreads, L = HD / 4 / S;
  extern __shared__ uint8_t smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BQ][HD] sw1
  float* Ks = Qs + BQ * HD;                         // [BK][HD] sw1
  float* Vs = Ks + BK * HD;                         // [BK][HD] sw1
  float* Pt = Vs + BK * HD;                         // p^T [BK][BQ] sw1
  float* Cs = Pt + BK * BQ;                         // each row's rescale
  float* Ls = Cs + BQ;                              // each row's denominator

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int share = blockIdx.z % split;
  const int q0 = (gridDim.z / split - 1 - blockIdx.z / split) * BQ;
  const int hk = h / (H / Hkv);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // Score lanes: keys kg + 8 j, rows 8 sr + i, head-width slice ds; after
  // the slice sum, rows 8 sr + ko + i (i < R).  Output lanes: rows
  // 4 rg + i and BQ / 2 + 4 rg + i, columns of chunks cg and cg + HD / 8.
  const int kg = tid & 7;
  const int ds = (tid >> 3) & (S - 1);
  const int sr = tid >> (3 + fa32::log2i(S));
  const int ko = fa32::kept_offset<8, S>(ds);
  const int cg = tid % (HD / 8);
  const int rg = tid / (HD / 8);

  // Key tiles holding a key that some row of this block (positions p0 ..
  // p0 + BQ - 1) can reach; this share's consecutive part of them.
  const int p0 = q_offset + q0;
  const int k_end = causal ? min(Tk, p0 + BQ) : Tk;
  int k_begin = window > 0 ? max(0, p0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_all = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int t_begin = share * n_all / split;
  const int n_tiles = (share + 1) * n_all / split - t_begin;
  k_begin += t_begin * BK;

  fa32::load_rows<HD, BQ, NT, false>(Qs, qb, qst, q0, Tq, tid);
  if (n_tiles > 0)
    fa32::load_rows<HD, BK, NT, false>(Ks, kb, kst, k_begin, Tk, tid);
  sm90::cp_async_commit();

  float acc[8][8], m[R], l[R];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    sm90::cp_async_wait_all();   // K_it (and Q) landed
    __syncthreads();             // ... for all; V, P^T and Cs consumed
    fa32::load_rows<HD, BK, NT, false>(Vs, vb, vst, k0, Tk, tid);
    sm90::cp_async_commit();

    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    fa32::dot_tile<HD, 8, 8, 8, L, 8>(s, Qs, 8 * sr, 0, Ks, kg, ds * L);
    fa32::reduce_slices<8, 8, S>(s, ds);

    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > p0) ||
                      (window > 0 && k0 <= p0 + BQ - 1 - window);
    // Each kept row's max over the tile's 64 keys (8 here, 8 lanes kg),
    // the online rescale, p and the row sum.
    float mx[R], sum[R], corr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      mx[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = s[i][j] * scale;
        if (edge && sm90::hidden(p0 + 8 * sr + ko + i, k0 + kg + 8 * j, Tk,
                                 causal, window))
          x = kNegInf;
        s[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      float other[R];
#pragma unroll
      for (int i = 0; i < R; ++i) other[i] = mx[i];
      fa32::shfl_xor_n(other, off);
#pragma unroll
      for (int i = 0; i < R; ++i) mx[i] = fmaxf(mx[i], other[i]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      sum[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum[i] += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      float other[R];
#pragma unroll
      for (int i = 0; i < R; ++i) other[i] = sum[i];
      fa32::shfl_xor_n(other, off);
#pragma unroll
      for (int i = 0; i < R; ++i) sum[i] += other[i];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      l[i] = l[i] * corr[i] + sum[i];
      if (kg == 0) Cs[8 * sr + ko + i] = corr[i];
    }
    // p^T: key row kg + 8 j (swizzle kg), this lane's R rows.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* prow = Pt + (kg + 8 * j) * BQ;
      const int c = (8 * sr + ko) >> 2;
      if constexpr (R == 8) {
        fa32::sts4(prow + 4 * (c ^ kg),
                   make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
        fa32::sts4(prow + 4 * ((c + 1) ^ kg),
                   make_float4(s[4][j], s[5][j], s[6][j], s[7][j]));
      } else if constexpr (R == 4) {
        fa32::sts4(prow + 4 * (c ^ kg),
                   make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
      } else {
        *reinterpret_cast<float2*>(prow + 4 * (c ^ kg) + (ko & 3)) =
            make_float2(s[0][j], s[1][j]);
      }
    }
    sm90::cp_async_wait_all();   // V_it landed
    __syncthreads();             // P^T, Cs and V_it ready; K_it consumed
    if (it + 1 < n_tiles)
      fa32::load_rows<HD, BK, NT, false>(Ks, kb, kst, k0 + BK, Tk, tid);
    sm90::cp_async_commit();

    const float4 c0 = fa32::lds4(Cs + 4 * rg);
    const float4 c1 = fa32::lds4(Cs + BQ / 2 + 4 * rg);
    const float rs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= rs[i];
    fa32::update<BK, BQ, BQ / 8, HD, 2, HD / 8>(acc, Pt, rg, Vs, cg);
  }
  sm90::cp_async_wait_all();

  if (split > 1) {
    // This share's unnormalised sums and each row's (m, l), for
    // flash_fwd_combine_kernel: [split][B][H][Tq][HD], then [..][Tq][2].
    const long long rows = (long long)gridDim.y * H * Tq;
    const long long base = ((long long)share * gridDim.y + b) * H + h;
    float* po = part + base * Tq * HD;
    float* pml = part + split * rows * HD + base * Tq * 2;
    if (kg == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + 8 * sr + ko + i;
        if (row < Tq)
          *reinterpret_cast<float2*>(pml + 2 * row) = make_float2(m[i], l[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + (i < 4 ? 4 * rg + i : BQ / 2 + 4 * rg + i - 4);
      if (row >= Tq) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        fa32::sts4(po + (long long)row * HD + 4 * cg + u * (HD / 2),
                   make_float4(acc[i][4 * u], acc[i][4 * u + 1],
                               acc[i][4 * u + 2], acc[i][4 * u + 3]));
    }
    return;
  }
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = 8 * sr + ko + i;
      Ls[row] = l[i];
      if (lse != nullptr && q0 + row < Tq)
        lse[((long long)b * H + h) * Tq + q0 + row] =
            m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i < 4 ? 4 * rg + i : BQ / 2 + 4 * rg + i - 4;
    if (q0 + row >= Tq) continue;
    const float lc = fmaxf(Ls[row], 1e-30f);
    T* orow = o + b * osb + h * osh + (long long)(q0 + row) * ost;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      fa32::sts4(orow + 4 * cg + u * (HD / 2),
                 make_float4(acc[i][4 * u] / lc, acc[i][4 * u + 1] / lc,
                             acc[i][4 * u + 2] / lc, acc[i][4 * u + 3] / lc));
  }
}

// o (and lse) from the shares' sums: per row, m = max of the shares' m,
// l = sum of l_s e^(m_s - m) and o = sum of acc_s e^(m_s - m) / max(l,
// 1e-30), the shares in order (the online softmax's rescale, once).
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_fwd_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                         float* __restrict__ lse, int B, int H, int Tq,
                         long long osb, long long osh, long long ost,
                         int split) {
  constexpr int kChunks = HD / 4;
  const long long rows = (long long)B * H * Tq;
  const float* pml = part + split * rows * HD;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < rows * kChunks;
       e += (long long)gridDim.x * 256) {
    const long long row = e / kChunks;   // (b H + h) Tq + t
    const int c = e % kChunks;
    float mx = kNegInf;
    for (int g = 0; g < split; ++g) mx = fmaxf(mx, pml[(g * rows + row) * 2]);
    float l = 0.0f;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int g = 0; g < split; ++g) {
      const float2 ml =
          *reinterpret_cast<const float2*>(pml + (g * rows + row) * 2);
      const float w = expf(ml.x - mx);
      l += ml.y * w;
      const float4 x = fa32::lds4(part + (g * rows + row) * HD + 4 * c);
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    const float lc = fmaxf(l, 1e-30f);
    const int t = row % Tq;
    const int h = (row / Tq) % H;
    const int b = row / ((long long)Tq * H);
    fa32::sts4(o + b * osb + h * osh + t * ost + 4 * c,
               make_float4(acc.x / lc, acc.y / lc, acc.z / lc, acc.w / lc));
    if (c == 0 && lse != nullptr) lse[row] = mx + logf(lc);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Tq, int Tk, const long long* st,
           int causal, int window, float scale, int split, float* part,
           int q_offset, cudaStream_t stream) {
  if (split < 1 || (split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = Fwd<HD>::kSmem;
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<fwd_grid<HD>(B, H, Tq, split), Fwd<HD>::kThreads, bytes,
           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, scale, split, part, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long chunks = (long long)B * H * Tq * (HD / 4);
  const int blocks = chunks / 256 + 1 < 1056 ? (int)(chunks / 256 + 1) : 1056;
  flash_fwd_combine_kernel<T, HD><<<blocks, 256, 0, stream>>>(
      part, static_cast<T*>(o), lse, B, H, Tq, st[9], st[10], st[11], split);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// float32 q, k, v, o; hd 64, 128 or 256.  strides: 12 element strides
// (batch, head, time) of q, k, v, o in that order.  lse may be null.
// split: the shares each query tile's key tiles are cut into (1: the kernel
// writes o; > 1: part is a float32 scratch of split x B x H x Tq x (hd + 2)
// floats and flash_fwd_combine_kernel writes o).  Returns a cudaError_t (0
// on success); 1 (cudaErrorInvalidValue) for an hd the kernel has no
// instantiation for or a split without its scratch.  q_offset: the position
// of query row 0 (keys from 0).
int flash_attention_launch(int hd, const void* q, const void* k,
                           const void* v, void* o, float* lse, int B, int H,
                           int Hkv, int Tq, int Tk, const long long* strides,
                           int causal, int window, float scale, int split,
                           float* part, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<float, 64>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, strides,
                             causal, window, scale, split, part, q_offset, s);
  if (hd == 128)
    return launch<float, 128>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, strides,
                              causal, window, scale, split, part, q_offset, s);
  if (hd == 256)
    return launch<float, 256>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, strides,
                              causal, window, scale, split, part, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
