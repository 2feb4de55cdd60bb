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
// (a and b read, h written, float32): at B 8, T 2048, C 2560 that is 503 MB,
// 0.15 ms at 3.35 TB/s, so it is bound by bytes.
//
// What this simple design does about that bound.  One thread per (b, c)
// walks t, so every load and store is coalesced along c, and the carry
// lives in a register.  Loads run kUnroll steps ahead of the dependent
// multiply-add chain.  The grid is B x C / 128 blocks of 128 threads (160
// at B 8, C 2560): a few warps per SM, so it will not reach the memory
// rate; splitting time across blocks (a chunked scan with a carry pass) is
// the redesign's work.
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
// float32 (at B 2, T 4096, C 2560: 419 MB, 0.125 ms at 3.35 TB/s).  The
// design is the forward's, walked from t = T - 1 down: one thread per
// (b, c), the carry in a register, loads kUnroll steps ahead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ h, int C, int T_len, long long asb,
             long long ast, long long bsb, long long bst, long long hsb,
             long long hst) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= C) return;
  const T* ab = a + bi * asb + c;
  const T* bb = b + bi * bsb + c;
  T* hb = h + bi * hsb + c;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const T* __restrict__ g, float* __restrict__ da,
                 float* __restrict__ db, int C, int T_len, long long asb,
                 long long ast, long long hsb, long long hst, long long gsb,
                 long long gst, long long dasb, long long dast,
                 long long dbsb, long long dbst) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= C) return;
  const T* ab = a + bi * asb + c;
  const T* hb = h + bi * hsb + c;
  const T* gb = g + bi * gsb + c;
  float* dab = da + bi * dasb + c;
  float* dbb = db + bi * dbsb + c;
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

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int T_len, int C,
           const long long* st, cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      C, T_len, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* g, float* da,
               float* db, int B, int T_len, int C, const long long* st,
               cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(g), da, db, C, T_len, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// dtype (a, b, h): 0 = float32, 1 = bfloat16.  strides: 6 element strides
// (batch, time) of a, b, h in that order.  Returns a cudaError_t (0 on
// success); 1 (cudaErrorInvalidValue) for a dtype without an instantiation.
int rglru_launch(int dtype, const void* a, const void* b, void* h, int B,
                 int T, int C, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, B, T, C, strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h, B, T, C, strides, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dtype (a, h, g): 0 = float32, 1 = bfloat16; da and db
// float32.  strides: 10 element strides (batch, time) of a, h, g, da, db in
// that order.  Returns a cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for a dtype without an instantiation.
int rglru_bwd_launch(int dtype, const void* a, const void* h, const void* g,
                     float* da, float* db, int B, int T, int C,
                     const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(a, h, g, da, db, B, T, C, strides, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, h, g, da, db, B, T, C, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
