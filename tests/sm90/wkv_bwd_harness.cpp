// csrc/wkv_bwd.cu's kernel on the CPU: the device code up to its launch
// function (wkv_bwd_cut.inc, cut by the tests, whose <<<>>> launch g++ does
// not parse), compiled against the sm90 emulator (tests/sm90/emu.h: a
// block's threads as std::threads meeting at barriers, shuffles through
// shared slots, dynamic shared memory as one array filled with garbage) and
// a bf16 stub.  tests/test_torch_wkv_bwd.py builds and runs it:
//   g++ -std=c++20 -O1 -fno-strict-aliasing -fvisibility=hidden
//       -fno-gnu-unique -shared -fPIC -pthread -I tests/sm90
//       -I src/repro_torch/kernels/csrc -I <dir of wkv_bwd_cut.inc>
//       tests/sm90/wkv_bwd_harness.cpp
#include "emu.h"

struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __bfloat162float(__nv_bfloat16 v) { return bf2f(v.x); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {f2bf(f)}; }

#include "wkv_bwd_cut.inc"

namespace {

template <typename T, typename TW>
void run(const void* r, const void* k, const void* v, const void* w,
         const void* dy, const float* u, const float* s0,
         const float* ds_final, void* dr, void* dk, void* dv, void* dw,
         float* du, float* ds0, float* ckpt, float* sub, int B, int H,
         int T_len, const long long* st) {
  wb::Args<T, TW> a;
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
  wb::Strides* ss[9] = {&a.rs, &a.ks, &a.vs, &a.ws, &a.gs,
                        &a.drs, &a.dks, &a.dvs, &a.dws};
  for (int x = 0; x < 9; ++x)
    *ss[x] = wb::Strides{st[3 * x], st[3 * x + 1], st[3 * x + 2]};
  if (wb::kSmemBytes > (int)sizeof(smem_raw)) std::abort();
  run_grid(dim3(B * H), wb::kThreads,
           [&] { wb::wkv_bwd_kernel<T, TW>(a); });
}

}  // namespace

// wkv_bwd_launch's arguments (csrc/wkv_bwd.cu), without the stream.
// Returns 0, or 1 for a type pair without an instantiation.
extern "C" __attribute__((visibility("default"))) int wkv_bwd_host(
    int dtype, int wdtype, const void* r, const void* k, const void* v,
    const void* w, const void* dy, const float* u, const float* s0,
    const float* ds_final, void* dr, void* dk, void* dv, void* dw,
    float* du, float* ds0, float* ckpt, float* sub, int B, int H, int T,
    const long long* st) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && wdtype == 0)
    run<float, float>(r, k, v, w, dy, u, s0, ds_final, dr, dk, dv, dw, du,
                      ds0, ckpt, sub, B, H, T, st);
  else if (dtype == 1 && wdtype == 0)
    run<bf16, float>(r, k, v, w, dy, u, s0, ds_final, dr, dk, dv, dw, du,
                     ds0, ckpt, sub, B, H, T, st);
  else if (dtype == 1 && wdtype == 1)
    run<bf16, bf16>(r, k, v, w, dy, u, s0, ds_final, dr, dk, dv, dw, du,
                    ds0, ckpt, sub, B, H, T, st);
  else
    return 1;
  return 0;
}
