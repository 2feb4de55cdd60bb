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
// type; optionally lse = m + log(max(l, 1e-30)) in float32.  Query and key
// positions both count from 0 (the TPU kernel's in-block indices).  GQA:
// query head h reads key/value head h / (H / Hkv).
//
// What bounds it on this card.  Counting only reachable score entries, the
// work is 4 * hd * H * B * sum(reachable (q, k)) operations against reading
// q, k, v and writing o once: for one causal qwen3-0.6b layer (H 16, Hkv 8,
// hd 128, bf16) at B = 1, T = 2048 that is 17.19 GFLOP against 25.2 MB,
// 0.0174 ms on the tensor cores' 989 TFLOP/s and 0.0075 ms at 3.35 TB/s,
// so it is bound by operations, and more so at longer T (T = 32,768:
// 4.40 TFLOP, 4.45 ms).
//
// What this simple design does about that bound.  It is a correct kernel
// for float32, not a fast one: every product is a float32 FMA on the CUDA
// cores (67 TFLOP/s peak), so at best it reaches ~1/15 of the bf16 bound's
// rate; in float32 that rate is the one its inputs allow.  It keeps what
// the TPU kernel keeps out of device memory: the [Tq, Tk] scores and
// probabilities live only in registers and shared memory, q, k and v are
// read once per block, and key tiles that the causal or window mask rules
// out for every row of the block are never loaded (about half the work at
// causal).
//
// Head widths 64 (qwen2), 128 (qwen3) and 256 (recurrentgemma's MQA, which
// doubles the output accumulators to 128 floats a thread and the shared
// memory to 139,904 bytes; ptxas's registers and spills for it are printed
// by chip_smoke.py's build phase).
//
// Layout.  One thread block per (q tile of 64 rows, head, batch row); the
// TPU's sequential key grid axis is a loop inside the block over 32-row key
// tiles held in shared memory as float32.  128 threads: 16 row groups of 4
// query rows x 8 column lanes.  A thread holds 4 x 4 scores, the running max
// and denominator of its 4 rows (shared by the 8 lanes of a row group, which
// reduce with warp shuffles), and 4 x hd/8 output accumulators.  The kernel
// takes element strides for q, k, v and o (the innermost dimension must be
// contiguous), so the model's [B, T, H, hd] layout and a key/value view of a
// longer cache need no copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // key rows per shared-memory tile
constexpr int kThreads = 128;
constexpr int kLanes = 8;      // column lanes per row group
constexpr int kRows = 4;       // query rows per thread (16 groups x 4 = 64)
constexpr int kNJ = kBK / kLanes;   // score columns per thread

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

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                 long long qsb, long long qsh, long long qst, long long ksb,
                 long long ksh, long long kst, long long vsb, long long vsh,
                 long long vst, long long osb, long long osh, long long ost,
                 int causal, int window, float scale) {
  constexpr int LDQ = HD + 1;   // +1: the 4 row groups of a warp read
  constexpr int LDK = HD + 1;   //     distinct banks
  constexpr int LDV = HD;       // read as float4 along hd
  constexpr int LDP = kBK + 1;
  constexpr int kC = HD / 32;   // float4 output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LDQ;
  float* Vs = Ks + kBK * LDK;
  float* Ps = Vs + kBK * LDV;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;

  load_tile<T, HD, kBQ>(Qs, LDQ, qb, qst, q0, Tq);

  float m[kRows], l[kRows], acc[kRows][kC][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  // Key tiles holding a key that some row of this block can reach.
  const int k_end = causal ? min(Tk, q0 + kBQ) : Tk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's Ks / Vs / Ps are consumed
    load_tile<T, HD, kBK>(Ks, LDK, kb, kst, k0, Tk);
    load_tile<T, HD, kBK>(Vs, LDV, vb, vst, k0, Tk);
    __syncthreads();

    float s[kRows][kNJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kNJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) kv[j] = Ks[(tx + kLanes * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int kpos = k0 + tx + kLanes * j;
        bool masked = kpos >= Tk;
        if (causal) masked = masked || kpos > qpos;
        if (window > 0) masked = masked || kpos <= qpos - window;
        s[i][j] = masked ? kNegInf : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * kRows + i) * LDP + tx + kLanes * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();   // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[kk * LDV + c * 32 + tx * 4]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][c][0] = fmaf(pv[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(pv[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(pv[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(pv[i], vv.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + b * osb + h * osh + (long long)qpos * ost;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_elem(orow + c * 32 + tx * 4 + e, acc[i][c][e] / lc);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Tq + qpos] = m[i] + logf(lc);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Tq, int Tk, const long long* st,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// float32 q, k, v, o; hd 64, 128 or 256.  strides: 12 element strides
// (batch, head, time) of q, k, v, o in that order.  lse may be null.
// Returns a cudaError_t (0 on success); 1 (cudaErrorInvalidValue) for an hd
// the kernel has no instantiation for.
int flash_attention_launch(int hd, const void* q, const void* k,
                           const void* v, void* o, float* lse, int B, int H,
                           int Hkv, int Tq, int Tk, const long long* strides,
                           int causal, int window, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<float, 64>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, strides,
                             causal, window, scale, s);
  if (hd == 128)
    return launch<float, 128>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, strides,
                              causal, window, scale, s);
  if (hd == 256)
    return launch<float, 256>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, strides,
                              causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
