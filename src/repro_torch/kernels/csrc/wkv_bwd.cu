// RWKV-6 WKV recurrence, backward, the step route, for Hopper (sm_90a),
// hand-written CUDA: float32 r, k, v, and any inputs shorter than a chunk
// (64 steps) or whose rows are not 16-byte aligned (rwkv6.py,
// wkv_bwd_plan).  bf16 r, k, v over a chunk or more take the chunked route,
// csrc/wkv_bwd_chunk.cu (the trainer's call).
//
// Replaces no TPU kernel: the Pallas kernel
// src/repro/kernels/rwkv6/rwkv6.py::wkv_bhtd has no backward, and the JAX
// model trains through its lax.scan (src/repro/models/rwkv6.py:186), which
// XLA differentiates.  This is the gradient of csrc/wkv.cu's recurrence
// (the port's own design, as the RG-LRU backward is kernel 5's).  Per
// (batch row, head), with S_t [64, 64] float32 the state BEFORE step t
// (rows i: k's channels; columns j: v's):
//     y_t = r_t S_t + (r_t . (u o k_t)) v_t,  S_t+1 = diag(w_t) S_t + k_t^T v_t
// Walking t down from T - 1 with dS = dS_t+1 (from dS_final, or zeros) and
// c_t = dy_t . v_t:
//     dr_t = dy_t S_t^T + c_t (u o k_t)       dw_t = rowsum(dS o S_t)
//     dk_t = dS v_t + c_t (u o r_t)           du  += c_t (r_t o k_t)
//     dv_t = k_t dS + (r_t . (u o k_t)) dy_t  dS  <- diag(w_t) dS + r_t^T dy_t
// and dS ends as dS0.  r, k, v, w, dy and dr, dk, dv, dw are [B, H, T, 64]
// (any element strides, the last one 1); r, k, v, dy, dr, dk, dv in the
// activation type (float32 or bfloat16), w and dw in the decay's (float32,
// or bfloat16 with bf16 activations); u [H, 64], S0 and dS_final (each may
// be null: zeros) and dS0 [B, H, 64, 64] float32.  du is written per
// (b, h), [B, H, 64] float32: the wrapper sums it over B, so no float
// atomics and the result is deterministic.  All math is float32.
//
// The states.  The backward needs S_t in reverse order, and the decays
// exp(-exp(x)) reach ~2e-9 (x = 3), so S_t is never recovered from S_t+1
// by dividing by w.  The kernel recomputes it instead, in three levels:
//   1. a forward walk from S0 stores S at every 64-step boundary in a
//      global float32 scratch (ckpt, B H ceil(T/64) x 16 KB);
//   2. chunk by chunk from the last, a walk from the chunk's checkpoint
//      stores S at every 8-step boundary in a second global scratch (sub,
//      B H x 8 x 16 KB: at B 2 x H 64 16 MB, which stays in the 50 MB L2);
//   3. sub-chunk by sub-chunk from the last, a walk from its
//      sub-checkpoint keeps its 8 states in shared memory (8 x 16 KB), and
//      the backward walks those 8 steps down.
// So every step's forward runs three times (twice for the last chunk),
// 2 x 16 float32 operations a thread, against the backward's ~9 x 16.
//
// The layout: row a thread-quad.  A block is 256 threads over one (b, h);
// thread tid holds row i = tid / 4, columns 16 q .. 16 q + 15 (q = tid % 4)
// of S and of dS in registers.  Four of the five per-step sums reduce over
// j (dr, dk, dw and c): each is a 16-term sum in the thread, then two
// shuffles over the row's four lanes.  dv reduces over i, across threads:
// each lane's 16 column terms are reduce-scattered over the 8 rows of its
// warp (shuffles at lane distances 16, 8, 4: 14 shuffles, leaving each lane
// two columns' sums), and the 8 warps' partials meet in shared memory,
// where the sub-chunk's end sums them (one barrier a sub-chunk, not one a
// step).  The bonus term of dv, (r . (u o k)) dy_j, is folded into each
// row's term as r_i u_i k_i dy_j, so no block-wide scalar is needed.  A
// column-a-thread layout (the forward's) would instead reduce three of the
// five sums across threads.  Each thread's stored states are its own 16
// floats: they lie thread-major in shared memory (float4 m of thread tid at
// [m][tid]), so no barrier guards them and no two lanes share a bank.  A
// sub-chunk's inputs are staged in shared memory as float32 by the whole
// block, and its dr, dk, dw, dv written at its end, a row of 64 at a time.
//
// What bounds it on this card.  A step and head is ~12 hd^2 float32
// operations with the recompute (25.8 GFLOP at B 2 x T 4,096 x H 64: 0.385
// ms at 67 TFLOP/s), against r, k, v, dy in and dr, dk, dv out in the
// activation type and w, dw in float32 (~0.8 GB at bf16: 0.24 ms at 3.35
// TB/s): bound by operations on the CUDA cores.  One block an SM (160 KB
// of shared memory, 8 warps) runs dependent chains of 16 FMAs and
// shuffles, so it is latency-bound, well above that bound (17.5x at B 2 x
// T 4,096 x H 64, PERF.md).  That is why bf16 inputs over a chunk take the
// chunked form on wgmma instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kHD = 64;          // head width (rwkv6's, fixed)
constexpr int kThreads = 256;    // 64 rows x 4 quarters of 16 columns
constexpr int kQ = 16;           // columns of S a thread holds
constexpr int kL = 64;           // steps between checkpoints
constexpr int kNS = 8;           // steps of a sub-chunk
constexpr int kSubs = kL / kNS;  // sub-checkpoints a chunk
constexpr int kState = kHD * kHD;   // floats of one state

// Shared memory, in floats: the sub-chunk's states (thread-major), its
// staged inputs (r, k, w, v, dy: [5][kNS][64]), the dr, dk, dw rows
// ([3][kNS][64]) and dv's warp partials ([kNS][8][64]).
constexpr int kSmStates = kNS * kThreads * kQ;
constexpr int kSmIn = 5 * kNS * kHD;
constexpr int kSmOut = 3 * kNS * kHD;
constexpr int kSmRed = kNS * 8 * kHD;
constexpr int kSmemBytes = (kSmStates + kSmIn + kSmOut + kSmRed) * 4;
enum { kInR = 0, kInK = 1, kInW = 2, kInV = 3, kInDy = 4 };

extern __shared__ uint8_t smem_raw[];

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
struct Args {
  const T *r, *k, *v;
  const TW* w;
  const T* dy;
  const float *u, *s0, *ds_final;
  T *dr, *dk, *dv;
  TW* dw;
  float *du, *ds0, *ckpt, *sub;
  int H, T_len;
  Strides rs, ks, vs, ws, gs, drs, dks, dvs, dws;
};

// A thread's 16 floats of a state, thread-major at ``base`` (shared or
// global): float4 m of thread tid at base + 4 (m kThreads + tid).
__device__ __forceinline__ void put_state(float* base, const float* x,
                                          int tid) {
#pragma unroll
  for (int m = 0; m < kQ / 4; ++m)
    *reinterpret_cast<float4*>(base + 4 * (m * kThreads + tid)) =
        make_float4(x[4 * m], x[4 * m + 1], x[4 * m + 2], x[4 * m + 3]);
}
__device__ __forceinline__ void get_state(const float* base, float* x,
                                          int tid) {
#pragma unroll
  for (int m = 0; m < kQ / 4; ++m) {
    const float4 f =
        *reinterpret_cast<const float4*>(base + 4 * (m * kThreads + tid));
    x[4 * m] = f.x;
    x[4 * m + 1] = f.y;
    x[4 * m + 2] = f.z;
    x[4 * m + 3] = f.w;
  }
}

// The row-major [64, 64] state at ``p`` (null: zeros): row i, columns
// j0 .. j0 + 15.
__device__ __forceinline__ void load_rows(const float* p, float* x, int i,
                                          int j0) {
#pragma unroll
  for (int m = 0; m < kQ / 4; ++m) {
    float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p != nullptr)
      f = *reinterpret_cast<const float4*>(p + i * kHD + j0 + 4 * m);
    x[4 * m] = f.x;
    x[4 * m + 1] = f.y;
    x[4 * m + 2] = f.z;
    x[4 * m + 3] = f.w;
  }
}

// 16 consecutive floats of a staged row (16-byte aligned).
__device__ __forceinline__ void get_row(const float* p, float* x) {
#pragma unroll
  for (int m = 0; m < kQ / 4; ++m) {
    const float4 f = reinterpret_cast<const float4*>(p)[m];
    x[4 * m] = f.x;
    x[4 * m + 1] = f.y;
    x[4 * m + 2] = f.z;
    x[4 * m + 3] = f.w;
  }
}

// Stage steps t0 .. t0 + n - 1 of k, w, v (and, with ``all``, r and dy) as
// float32 into in[a][step][channel].
template <typename T, typename TW>
__device__ __forceinline__ void stage(const T* rb, const T* kb, const T* vb,
                                      const TW* wb, const T* gb,
                                      const Args<T, TW>& a, float* in,
                                      int t0, int n, bool all, int tid) {
  for (int e = tid; e < kNS * kHD; e += kThreads) {
    const int s = e / kHD, c = e % kHD;
    if (s >= n) continue;
    const long long t = t0 + s;
    in[kInK * kNS * kHD + e] = to_f32(kb[t * a.ks.t + c]);
    in[kInW * kNS * kHD + e] = to_f32(wb[t * a.ws.t + c]);
    in[kInV * kNS * kHD + e] = to_f32(vb[t * a.vs.t + c]);
    if (all) {
      in[kInR * kNS * kHD + e] = to_f32(rb[t * a.rs.t + c]);
      in[kInDy * kNS * kHD + e] = to_f32(gb[t * a.gs.t + c]);
    }
  }
}

// One forward step of the thread's row segment from staged step s.
__device__ __forceinline__ void fwd_step(float* S, const float* in, int s,
                                         int i, int j0) {
  const float wi = in[kInW * kNS * kHD + s * kHD + i];
  const float ki = in[kInK * kNS * kHD + s * kHD + i];
  float vs[kQ];
  get_row(in + kInV * kNS * kHD + s * kHD + j0, vs);
#pragma unroll
  for (int m = 0; m < kQ; ++m) S[m] = wi * S[m] + ki * vs[m];
}

// One stage of dv's reduce-scatter: lanes ``OFF`` apart swap halves of
// their ``2 HALF`` column terms, each keeping the sum of the half its lane
// bit ``OFF`` picks (the upper half where it is set) in p[0 .. HALF - 1].
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

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_kernel(const Args<T, TW> a) {
  float* st_s = reinterpret_cast<float*>(smem_raw);   // the states
  float* in_s = st_s + kSmStates;          // staged inputs
  float* out_s = in_s + kSmIn;             // dr, dk, dw rows
  float* red_s = out_s + kSmOut;           // dv's warp partials

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int tid = threadIdx.x;
  const int i = tid >> 2;
  const int q = tid & 3;
  const int j0 = q * kQ;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T_len = a.T_len;
  const int n_chunks = (T_len + kL - 1) / kL;

  const T* rb = a.r + b * a.rs.b + h * a.rs.h;
  const T* kb = a.k + b * a.ks.b + h * a.ks.h;
  const T* vb = a.v + b * a.vs.b + h * a.vs.h;
  const TW* wb = a.w + b * a.ws.b + h * a.ws.h;
  const T* gb = a.dy + b * a.gs.b + h * a.gs.h;
  T* drb = a.dr + b * a.drs.b + h * a.drs.h;
  T* dkb = a.dk + b * a.dks.b + h * a.dks.h;
  T* dvb = a.dv + b * a.dvs.b + h * a.dvs.h;
  TW* dwb = a.dw + b * a.dws.b + h * a.dws.h;
  float* ckpt = a.ckpt + (long long)bh * n_chunks * kState;
  float* sub = a.sub + (long long)bh * kSubs * kState;
  const long long sbase = (long long)bh * kState;
  const float ui = a.u[h * kHD + i];

  float S[kQ], dS[kQ];

  // 1. the forward walk, a checkpoint at every kL-step boundary
  load_rows(a.s0 == nullptr ? nullptr : a.s0 + sbase, S, i, j0);
  for (int c = 0; c < n_chunks; ++c) {
    put_state(ckpt + (long long)c * kState, S, tid);
    if (c == n_chunks - 1) break;
    for (int s0 = 0; s0 < kL; s0 += kNS) {
      __syncthreads();
      stage(rb, kb, vb, wb, gb, a, in_s, c * kL + s0, kNS, false, tid);
      __syncthreads();
      for (int s = 0; s < kNS; ++s) fwd_step(S, in_s, s, i, j0);
    }
  }

  load_rows(a.ds_final == nullptr ? nullptr : a.ds_final + sbase, dS, i,
            j0);
  float du = 0.0f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int tc = c * kL;
    const int n_sub = (min(kL, T_len - tc) + kNS - 1) / kNS;
    // 2. the chunk's walk, a sub-checkpoint at every kNS-step boundary
    get_state(ckpt + (long long)c * kState, S, tid);
    for (int s = 0; s < n_sub; ++s) {
      put_state(sub + s * kState, S, tid);
      if (s == n_sub - 1) break;
      __syncthreads();
      stage(rb, kb, vb, wb, gb, a, in_s, tc + s * kNS, kNS, false, tid);
      __syncthreads();
      for (int m = 0; m < kNS; ++m) fwd_step(S, in_s, m, i, j0);
    }
    // 3. sub-chunks from the last: states into shared memory, then back
    for (int s = n_sub - 1; s >= 0; --s) {
      const int t0 = tc + s * kNS;
      const int n = min(kNS, T_len - t0);
      if (s != n_sub - 1) get_state(sub + s * kState, S, tid);
      __syncthreads();
      stage(rb, kb, vb, wb, gb, a, in_s, t0, n, true, tid);
      __syncthreads();
      for (int m = 0; m < n; ++m) {
        put_state(st_s + m * kThreads * kQ, S, tid);
        if (m + 1 < n) fwd_step(S, in_s, m, i, j0);
      }
      for (int m = n - 1; m >= 0; --m) {
        float St[kQ];
        get_state(st_s + m * kThreads * kQ, St, tid);
        const float* row = in_s + m * kHD;
        const float ri = row[kInR * kNS * kHD + i];
        const float ki = row[kInK * kNS * kHD + i];
        const float wi = row[kInW * kNS * kHD + i];
        float vs[kQ], gs[kQ];
        get_row(row + kInV * kNS * kHD + j0, vs);
        get_row(row + kInDy * kNS * kHD + j0, gs);
        const float bonus_i = ri * ui * ki;
        float cp = 0.0f, drp = 0.0f, dkp = 0.0f, dwp = 0.0f;
        float dvp[kQ];
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          const float g = gs[j], vj = vs[j];
          cp = fmaf(g, vj, cp);
          drp = fmaf(g, St[j], drp);
          dkp = fmaf(dS[j], vj, dkp);
          dwp = fmaf(dS[j], St[j], dwp);
          dvp[j] = ki * dS[j] + bonus_i * g;
          dS[j] = wi * dS[j] + ri * g;
        }
        const float ct = quad_sum(cp);
        drp = quad_sum(drp);
        dkp = quad_sum(dkp);
        dwp = quad_sum(dwp);
        du = fmaf(ct, ri * ki, du);
        float* out = out_s + m * kHD + i;
        if (q == 0) out[0] = drp + ct * (ui * ki);
        if (q == 1) out[kNS * kHD] = dkp + ct * (ui * ri);
        if (q == 2) out[2 * kNS * kHD] = dwp;
        // dv: reduce-scatter the 16 column terms over the warp's 8 rows
        // (lane bits 4, 3, 2), leaving columns j0 + 8 h4 + 4 h3 + 2 h2 +
        // {0, 1} summed over them in dvp[0], dvp[1]
        scatter_half<8, 16>(dvp, lane);
        scatter_half<4, 8>(dvp, lane);
        scatter_half<2, 4>(dvp, lane);
        const int col = j0 + 8 * ((lane >> 4) & 1) + 4 * ((lane >> 3) & 1) +
                        2 * ((lane >> 2) & 1);
        *reinterpret_cast<float2*>(red_s + (m * 8 + warp) * kHD + col) =
            make_float2(dvp[0], dvp[1]);
      }
      __syncthreads();
      // the sub-chunk's gradients, a row of 64 channels at a time
      for (int e = tid; e < n * kHD; e += kThreads) {
        const int m = e / kHD, j = e % kHD;
        const long long t = t0 + m;
        float dv = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < 8; ++w8) dv += red_s[(m * 8 + w8) * kHD + j];
        store(dvb + t * a.dvs.t + j, dv);
        store(drb + t * a.drs.t + j, out_s[e]);
        store(dkb + t * a.dks.t + j, out_s[kNS * kHD + e]);
        store(dwb + t * a.dws.t + j, out_s[2 * kNS * kHD + e]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kQ / 4; ++m)
    *reinterpret_cast<float4*>(a.ds0 + sbase + i * kHD + j0 + 4 * m) =
        make_float4(dS[4 * m], dS[4 * m + 1], dS[4 * m + 2], dS[4 * m + 3]);
  if (q == 0) a.du[(long long)bh * kHD + i] = du;
}

template <typename T, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* dy, const float* u, const float* s0,
           const float* ds_final, void* dr, void* dk, void* dv, void* dw,
           float* du, float* ds0, float* ckpt, float* sub, int B, int H,
           int T_len, const long long* st, cudaStream_t stream) {
  Args<T, TW> a;
  a.r = static_cast<const T*>(r);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.w = static_cast<const TW*>(w);
  a.dy = static_cast<const T*>(dy);
  a.u = u;
  a.s0 = s0;
  a.ds_final = ds_final;
  a.dr = static_cast<T*>(dr);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.dw = static_cast<TW*>(dw);
  a.du = du;
  a.ds0 = ds0;
  a.ckpt = ckpt;
  a.sub = sub;
  a.H = H;
  a.T_len = T_len;
  Strides* ss[9] = {&a.rs, &a.ks, &a.vs, &a.ws, &a.gs,
                    &a.drs, &a.dks, &a.dvs, &a.dws};
  for (int x = 0; x < 9; ++x) *ss[x] = Strides{st[3 * x], st[3 * x + 1],
                                               st[3 * x + 2]};
  static std::atomic<unsigned long long> allowed{0};
  const int err = sm90::allow_smem(wkv_bwd_kernel<T, TW>, kSmemBytes,
                                   allowed);
  if (err != 0) return err;
  wkv_bwd_kernel<T, TW><<<B * H, kThreads, kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- launch (plain C interface, loaded with ctypes) ----

extern "C" {

// dtype (r, k, v, dy, dr, dk, dv) and wdtype (w, dw): 0 = float32, 1 =
// bfloat16.  u [H, 64], s0, ds_final and ds0 [B, H, 64, 64], du [B, H, 64]
// contiguous float32; s0 and ds_final may be null (zeros).  ckpt: B H
// ceil(T / 64) x 4,096 floats, sub: B H x 8 x 4,096 floats of scratch.
// strides: 27 element strides (batch, head, time) of r, k, v, w, dy, dr,
// dk, dv, dw in that order (T = 0: dS0 = dS_final, du = 0).  Returns a cudaError_t (0 on
// success); 1 (cudaErrorInvalidValue) for a type pair without an
// instantiation.
int wkv_bwd_launch(int dtype, int wdtype, const void* r, const void* k,
                   const void* v, const void* w, const void* dy,
                   const float* u, const float* s0, const float* ds_final,
                   void* dr, void* dk, void* dv, void* dw, float* du,
                   float* ds0, float* ckpt, float* sub, int B, int H, int T,
                   const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0)
    return launch<float, float>(r, k, v, w, dy, u, s0, ds_final, dr, dk, dv,
                                dw, du, ds0, ckpt, sub, B, H, T, strides, s);
  if (dtype == 1 && wdtype == 0)
    return launch<__nv_bfloat16, float>(r, k, v, w, dy, u, s0, ds_final, dr,
                                        dk, dv, dw, du, ds0, ckpt, sub, B, H,
                                        T, strides, s);
  if (dtype == 1 && wdtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        r, k, v, w, dy, u, s0, ds_final, dr, dk, dv, dw, du, ds0, ckpt, sub,
        B, H, T, strides, s);
  return (int)cudaErrorInvalidValue;
}

const char* wkv_bwd_error_string(int err) { return sm90::error_string(err); }

}  // extern "C"
