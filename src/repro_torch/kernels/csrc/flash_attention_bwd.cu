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
// times scale.  Outputs are rounded to the input type once, at the end.
// GQA: query head h reads key/value head h / (H / Hkv); dk and dv are
// summed over the group's query heads inside one block, in float32 (JAX
// keeps per-query-head [B, H, Tk, hd] intermediates rounded to the input
// type and sums them afterwards, :178-179, :188-189).
//
// What bounds it on this card.  The function's work is five products per
// reachable (query, key) pair and query head (s, dp, dq, dk, dv), 10 * hd
// operations, against reading q, k, v, o, dO and lse once and writing dq,
// dk, dv once.  For one causal qwen3-0.6b layer (H 16, Hkv 8, hd 128, bf16)
// at B = 1, T = 2048: 42.97 GFLOP, 0.0434 ms on the tensor cores' 989
// TFLOP/s, against 50.5 MB, 0.0151 ms at 3.35 TB/s (NVIDIA's H100 SXM data
// sheet at the 700 W limit): bound by operations.
//
// What this simple design does about that bound.  It is a correct kernel
// for float32, not a fast one: every product is a float32 FMA on the CUDA
// cores (67 TFLOP/s peak), and both kernels recompute s and dp (14 * hd
// operations per pair, 1.4x the function's count).  It keeps the [Tq, Tk]
// scores, probabilities and their gradients out of device memory, skips
// key (query) tiles that the mask rules out for a whole block, and is
// deterministic: no atomics, every output element is written once by one
// thread.
//
// Layout.  Two kernels on the same stream, 128 threads each.
//   dq:   one block per (64-row query tile, query head, batch row); a loop
//         over 32-row key tiles held in shared memory as float32.  16 row
//         groups of 4 query rows x 8 column lanes; a thread holds 4 x 4
//         scores and dp entries, and 4 x hd/8 dq accumulators (columns
//         lane + 8 c).
//   dk/dv: one block per (32-row key tile, key/value head, batch row); a
//         loop over the group's query heads and over the 64-row query tiles
//         that can reach the key tile.  8 row groups of 4 key rows x 16
//         column lanes; a thread holds 4 x 4 transposed scores and dp
//         entries, and 4 x hd/16 dk and dv accumulators each.
// Head widths 64, 128 and 256; at 256 a thread holds 128 dq accumulators
// or 2 x 64 dk/dv ones, and a block 205,824 (dq) or 214,528 (dk/dv) bytes
// of shared memory, under the 232,448 a block may opt into.
// Shared rows are padded to hd + 1 floats, so the lanes of a warp read
// distinct banks both along rows and along columns.  The kernels take
// element strides for q, k, v, dO, dq, dk and dv (the innermost dimension
// contiguous), so the model's [B, T, H, hd] layout needs no copy; lse and
// delta are contiguous [B, H, Tq] float32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// dq kernel
constexpr int kQBQ = 64;                 // query rows per block
constexpr int kQBK = 32;                 // key rows per shared tile
constexpr int kQLanes = 8;               // column lanes per row group
constexpr int kQNJ = kQBK / kQLanes;     // score columns per thread
// dk/dv kernel
constexpr int kKBK = 32;                 // key rows per block
constexpr int kKBQ = 64;                 // query rows per shared tile
constexpr int kKLanes = 16;              // column lanes per row group
constexpr int kKNJ = kKBQ / kKLanes;     // score columns per thread
constexpr int kRows = 4;                 // rows per thread (both kernels)

// Element strides (batch, head, time) of q, k, v, dO, dq, dk, dv.
struct Strides {
  long long q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3];
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }

// Rows [row0, row0 + R) of one (batch, head) slice into shared memory as
// float32 with row pitch ld; rows at or past n_rows are zero.  16-byte loads.
template <typename T, int HD, int R>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = HD / V;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * V;
    float vals[V];
    if (row0 + r < n_rows) {
      load_vec(src + (long long)(row0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) vals[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) dst[r * ld + c + j] = vals[j];
  }
}

__device__ __forceinline__ bool masked(int qpos, int kpos, int Tq, int Tk,
                                       int causal, int window) {
  bool m = qpos >= Tq || kpos >= Tk;
  if (causal) m = m || kpos > qpos;
  if (window > 0) m = m || kpos <= qpos - window;
  return m;
}

template <int HD>
constexpr int dq_smem_floats() {
  return 2 * kQBQ * (HD + 1) + 2 * kQBK * (HD + 1) + kQBQ * (kQBK + 1);
}

template <int HD>
constexpr int dkdv_smem_floats() {
  return 2 * kKBK * (HD + 1) + 2 * kKBQ * (HD + 1) + 2 * kKBK * (kKBQ + 1)
         + 2 * kKBQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Hkv, int Tq, int Tk, Strides st, int causal,
                    int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int LDS = kQBK + 1;
  constexpr int kC = HD / kQLanes;   // dq columns per thread: lane + 8 c
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + kQBQ * LD;        // dO tile
  float* Ks = Os + kQBQ * LD;
  float* Vs = Ks + kQBK * LD;
  float* Ds = Vs + kQBK * LD;        // ds of the current key tile

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kQBQ;
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];
  const int tx = threadIdx.x % kQLanes;
  const int ty = threadIdx.x / kQLanes;

  load_tile<T, HD, kQBQ>(Qs, LD, q + b * st.q[0] + h * st.q[1], st.q[2], q0,
                         Tq);
  load_tile<T, HD, kQBQ>(Os, LD, dout + b * st.dout[0] + h * st.dout[1],
                         st.dout[2], q0, Tq);

  float row_lse[kRows], row_delta[kRows], acc[kRows][kC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    const long long r = ((long long)b * H + h) * Tq + qpos;
    row_lse[i] = qpos < Tq ? lse[r] : 0.0f;
    row_delta[i] = qpos < Tq ? delta[r] : 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.0f;
  }

  // Key tiles holding a key that some row of this block can reach.
  const int k_end = causal ? min(Tk, q0 + kQBQ) : Tk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kQBK) * kQBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kQBK) {
    __syncthreads();   // the previous tile's Ks / Vs / Ds are consumed
    load_tile<T, HD, kQBK>(Ks, LD, kb, st.k[2], k0, Tk);
    load_tile<T, HD, kQBK>(Vs, LD, vb, st.v[2], k0, Tk);
    __syncthreads();

    float s[kRows][kQNJ], dp[kRows][kQNJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kQNJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], ov[kRows], kv[kQNJ], vv[kQNJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = Qs[(ty * kRows + i) * LD + d];
        ov[i] = Os[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < kQNJ; ++j) {
        kv[j] = Ks[(tx + kQLanes * j) * LD + d];
        vv[j] = Vs[(tx + kQLanes * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kQNJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kQNJ; ++j) {
        const int kpos = k0 + tx + kQLanes * j;
        const float p = masked(qpos, kpos, Tq, Tk, causal, window)
                            ? 0.0f
                            : expf(s[i][j] * scale - row_lse[i]);
        Ds[(ty * kRows + i) * LDS + tx + kQLanes * j] =
            p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
    __syncthreads();   // Ds complete

#pragma unroll 4
    for (int kk = 0; kk < kQBK; ++kk) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = Ds[(ty * kRows + i) * LDS + kk];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float kval = Ks[kk * LD + tx + kQLanes * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i][c] = fmaf(dsv[i], kval, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= Tq) continue;
    T* row = dq + b * st.dq[0] + h * st.dq[1] + (long long)qpos * st.dq[2];
#pragma unroll
    for (int c = 0; c < kC; ++c) store_elem(row + tx + kQLanes * c, acc[i][c]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                      Strides st, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int LDP = kKBQ + 1;
  constexpr int kC = HD / kKLanes;   // dk/dv columns per thread: lane + 16 c
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kKBK * LD;
  float* Qs = Vs + kKBK * LD;
  float* Os = Qs + kKBQ * LD;        // dO tile
  float* Ps = Os + kKBQ * LD;        // p^T of the current query tile
  float* Ss = Ps + kKBK * LDP;       // ds^T of the current query tile
  float* Ls = Ss + kKBK * LDP;       // lse of the tile's query rows
  float* Dl = Ls + kKBQ;             // delta of the tile's query rows

  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * kKBK;
  const int tx = threadIdx.x % kKLanes;
  const int ty = threadIdx.x / kKLanes;

  load_tile<T, HD, kKBK>(Ks, LD, k + b * st.k[0] + hk * st.k[1], st.k[2], k0,
                         Tk);
  load_tile<T, HD, kKBK>(Vs, LD, v + b * st.v[0] + hk * st.v[1], st.v[2], k0,
                         Tk);

  float dk_acc[kRows][kC], dv_acc[kRows][kC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.0f;

  // Query tiles holding a query that can reach some key of this block.
  const int q_begin = causal ? (k0 / kKBQ) * kKBQ : 0;
  const int q_end = window > 0 ? min(Tq, k0 + kKBK + window - 1) : Tq;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const T* qb = q + b * st.q[0] + h * st.q[1];
    const T* ob = dout + b * st.dout[0] + h * st.dout[1];
    const long long rbase = ((long long)b * H + h) * Tq;
    for (int q0 = q_begin; q0 < q_end; q0 += kKBQ) {
      __syncthreads();   // the previous tile's Qs / Os / Ps / Ss consumed
      load_tile<T, HD, kKBQ>(Qs, LD, qb, st.q[2], q0, Tq);
      load_tile<T, HD, kKBQ>(Os, LD, ob, st.dout[2], q0, Tq);
      for (int i = threadIdx.x; i < kKBQ; i += kThreads) {
        const bool ok = q0 + i < Tq;
        Ls[i] = ok ? lse[rbase + q0 + i] : 0.0f;
        Dl[i] = ok ? delta[rbase + q0 + i] : 0.0f;
      }
      __syncthreads();

      float s[kRows][kKNJ], dp[kRows][kKNJ];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kKNJ; ++j) s[r][j] = dp[r][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[kRows], vv[kRows], qv[kKNJ], ov[kKNJ];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          kv[r] = Ks[(ty * kRows + r) * LD + d];
          vv[r] = Vs[(ty * kRows + r) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < kKNJ; ++j) {
          qv[j] = Qs[(tx + kKLanes * j) * LD + d];
          ov[j] = Os[(tx + kKLanes * j) * LD + d];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kKNJ; ++j) {
            s[r][j] = fmaf(qv[j], kv[r], s[r][j]);
            dp[r][j] = fmaf(ov[j], vv[r], dp[r][j]);
          }
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int kpos = k0 + ty * kRows + r;
#pragma unroll
        for (int j = 0; j < kKNJ; ++j) {
          const int i = tx + kKLanes * j;
          const float p = masked(q0 + i, kpos, Tq, Tk, causal, window)
                              ? 0.0f
                              : expf(s[r][j] * scale - Ls[i]);
          Ps[(ty * kRows + r) * LDP + i] = p;
          Ss[(ty * kRows + r) * LDP + i] = p * (dp[r][j] - Dl[i]) * scale;
        }
      }
      __syncthreads();   // Ps / Ss complete

#pragma unroll 4
      for (int i = 0; i < kKBQ; ++i) {
        float pv[kRows], sv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          pv[r] = Ps[(ty * kRows + r) * LDP + i];
          sv[r] = Ss[(ty * kRows + r) * LDP + i];
        }
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float ov = Os[i * LD + tx + kKLanes * c];
          const float qv = Qs[i * LD + tx + kKLanes * c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            dv_acc[r][c] = fmaf(pv[r], ov, dv_acc[r][c]);
            dk_acc[r][c] = fmaf(sv[r], qv, dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kpos = k0 + ty * kRows + r;
    if (kpos >= Tk) continue;
    T* krow = dk + b * st.dk[0] + hk * st.dk[1] + (long long)kpos * st.dk[2];
    T* vrow = dv + b * st.dv[0] + hk * st.dv[1] + (long long)kpos * st.dv[2];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      store_elem(krow + tx + kKLanes * c, dk_acc[r][c]);
      store_elem(vrow + tx + kKLanes * c, dv_acc[r][c]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int B, int H, int Hkv, int Tq, int Tk,
           const long long* s, int causal, int window, float scale,
           cudaStream_t stream) {
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
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(dout);

  constexpr int dq_bytes = dq_smem_floats<HD>() * (int)sizeof(float);
  auto dq_kernel = flash_bwd_dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3((Tq + kQBQ - 1) / kQBQ, H, B), kThreads, dq_bytes,
              stream>>>(tq, tk, tv, to, lse, delta, static_cast<T*>(dq), H,
                        Hkv, Tq, Tk, st, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int kv_bytes = dkdv_smem_floats<HD>() * (int)sizeof(float);
  auto kv_kernel = flash_bwd_dkdv_kernel<T, HD>;
  err = cudaFuncSetAttribute(
      kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<dim3((Tk + kKBK - 1) / kKBK, Hkv, B), kThreads, kv_bytes,
              stream>>>(tq, tk, tv, to, lse, delta, static_cast<T*>(dk),
                        static_cast<T*>(dv), H, Hkv, Tq, Tk, st, causal,
                        window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// float32 q, k, v, dO, dq, dk, dv; hd 64, 128 or 256.  strides: 21 element
// strides (batch, head, time) of q, k, v, dO, dq, dk, dv in that order.
// lse and delta: contiguous [B, H, Tq] float32.  Launches the dq kernel and
// then the dk/dv kernel on ``stream``.  Returns a cudaError_t (0 on
// success); 1 (cudaErrorInvalidValue) for an hd the kernels have no
// instantiation for.
int flash_attention_bwd_launch(int hd, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* delta,
                               void* dq, void* dk, void* dv, int B, int H,
                               int Hkv, int Tq, int Tk,
                               const long long* strides, int causal,
                               int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                             Hkv, Tq, Tk, strides, causal, window, scale, s);
  if (hd == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                              Hkv, Tq, Tk, strides, causal, window, scale, s);
  if (hd == 256)
    return launch<float, 256>(q, k, v, dout, lse, delta, dq, dk, dv, B, H,
                              Hkv, Tq, Tk, strides, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
