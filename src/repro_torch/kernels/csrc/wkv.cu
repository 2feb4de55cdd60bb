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
// prefill to decode, one token at a time (T = 1 is the same kernel).
// r / k / v come in the activation type (float32 or bfloat16); w has its own
// type parameter, because the model keeps the decay in float32
// (models/rwkv6.py:175-176: a bf16 decay near 1 loses the long memory).
//
// What bounds it on this card.  A step of one (b, h) is ~5 * 64^2 float32
// operations (r S, the decay, the outer product) against 12 * 64 bytes in
// bf16 (r, k, v, y at 2 B, w at 4 B): at B 8, T 2048, H 64 that is 21.5
// GFLOP (0.32 ms at the CUDA cores' 67 TFLOP/s) against 805 MB (0.24 ms at
// 3.35 TB/s), so it is bound by operations, on the CUDA cores: the
// recurrence is a matrix-vector product per step, which the tensor cores
// cannot take without a chunked reformulation.
//
// What this simple design does about that bound.  One block of 64 threads
// per (b, h); thread j holds column j of S (64 floats) in registers, so S
// never leaves the SM, as on the TPU.  Time runs in chunks of kTC steps: the
// block stages r, k and w of a chunk in shared memory (double-buffered, so a
// chunk costs one barrier) together with the chunk's bonus scalars r.(u o k),
// reduced by warp shuffles.  Each thread then walks the chunk: for each i it
// reads S_ij once, adds r_i S_ij to y_j (four partial sums break the
// dependent chain) and writes w_i S_ij + k_i v_j back; v_j and y_j are its
// own column, read and written directly (coalesced across the block).  The
// grid is B x H blocks (512 at B 8): about four small blocks per SM, so the
// per-step latency chain, not the arithmetic rate, is what it will show.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// dtype (r, k, v, y) and wdtype (w): 0 = float32, 1 = bfloat16.  u [H, 64]
// and S0 / S_final [B, H, 64, 64] are contiguous float32; s0 may be null
// (zeros).  strides: 15 element strides (batch, head, time) of r, k, v, w,
// y in that order.  Returns a cudaError_t (0 on success); 1
// (cudaErrorInvalidValue) for a type pair without an instantiation.
int wkv_launch(int dtype, int wdtype, const void* r, const void* k,
               const void* v, const void* w, const float* u, const float* s0,
               void* y, float* s_final, int B, int H, int T,
               const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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

const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
