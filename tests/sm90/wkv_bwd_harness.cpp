// csrc/wkv_bwd.cu's kernel (the step route) and csrc/wkv_bwd_chunk.cu's
// two kernels (the chunked route) on the CPU: each source's device code up
// to its launch functions (wkv_bwd_cut.inc, wkv_bwd_chunk_cut.inc, cut by
// the tests, whose <<<>>> launches g++ does not parse; in namespaces wb and
// wc), compiled against the sm90 emulator (tests/sm90/emu.h: a block's
// threads as std::threads meeting at barriers, shuffles through shared
// slots, cp.async, wgmma computed from its descriptors and fragment
// layouts, dynamic shared memory as one array filled with garbage) and a
// bf16 stub.  tests/test_torch_wkv_bwd.py builds and runs it:
//   g++ -std=c++20 -O1 -fno-strict-aliasing -fvisibility=hidden
//       -fno-gnu-unique -shared -fPIC -pthread -I tests/sm90
//       -I src/repro_torch/kernels/csrc -I <dir of the cuts>
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
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __bfloat162float(__nv_bfloat16 v) { return bf2f(v.x); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {f2bf(f)}; }

#include "wkv_bwd_cut.inc"
#include "wkv_bwd_chunk_cut.inc"

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

template <typename TW>
void run_chunk(const void* r, const void* k, const void* v, const void* w,
               const void* dy, const float* u, const float* s0,
               const float* ds_final, void* dr, void* dk, void* dv, void* dw,
               float* du, float* ds0, float* sc, float* dse, int B, int H,
               int T_len, const long long* st, int nj) {
  using bf16 = __nv_bfloat16;
  wc::Args<TW> a;
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
  wc::Strides* ss[9] = {&a.rs, &a.ks, &a.vs, &a.ws, &a.gs,
                        &a.drs, &a.dks, &a.dvs, &a.dws};
  for (int x = 0; x < 9; ++x)
    *ss[x] = wc::Strides{st[3 * x], st[3 * x + 1], st[3 * x + 2]};
  if (wc::ChunkSmem<TW>::kSmem > (int)sizeof(smem_raw) ||
      wc::StateSmem<TW, 64>::kSmem > (int)sizeof(smem_raw))
    std::abort();
  if (nj == 64)
    run_grid(dim3(B * H, 1, 2), wc::kThreads,
             [&] { wc::wkv_bwd_state_kernel<TW, 64>(a); });
  else
    run_grid(dim3(B * H, 2, 2), wc::kThreads,
             [&] { wc::wkv_bwd_state_kernel<TW, 32>(a); });
  run_grid(dim3((T_len + 127) / 128, B * H), wc::kWgs * wc::kThreads,
           [&] { wc::wkv_bwd_chunk_kernel<TW>(a); });
}

}  // namespace

// wkv_bwd_chunk_launch's arguments (csrc/wkv_bwd_chunk.cu), without the
// stream: the state pass over nj = 32 or 64 columns a block, then the
// chunk pass.  Returns 0, or 1 for what the launch refuses.
extern "C" __attribute__((visibility("default"))) int wkv_bwd_chunk_host(
    int wdtype, const void* r, const void* k, const void* v, const void* w,
    const void* dy, const float* u, const float* s0, const float* ds_final,
    void* dr, void* dk, void* dv, void* dw, float* du, float* ds0,
    float* sc, float* dse, int B, int H, int T, const long long* st,
    int nj) {
  if (T < 1 || (nj != 32 && nj != 64)) return 1;
  if (wdtype == 0)
    run_chunk<float>(r, k, v, w, dy, u, s0, ds_final, dr, dk, dv, dw, du,
                     ds0, sc, dse, B, H, T, st, nj);
  else if (wdtype == 1)
    run_chunk<__nv_bfloat16>(r, k, v, w, dy, u, s0, ds_final, dr, dk, dv,
                             dw, du, ds0, sc, dse, B, H, T, st, nj);
  else
    return 1;
  return 0;
}

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
