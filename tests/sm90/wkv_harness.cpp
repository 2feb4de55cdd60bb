// csrc/wkv.cu's kernels on the CPU: the device code up to its launch
// functions (wkv_cut.inc, cut by the tests, whose <<<>>> launches g++ does
// not parse), compiled against the sm90 emulator (tests/sm90/emu.h: a
// block's threads as std::threads meeting at barriers, shuffles, cp.async,
// wgmma computed from its descriptors and fragment layouts) and a bf16
// stub.  tests/test_torch_wkv_sm90.py builds and runs it:
//   g++ -std=c++20 -O1 -fno-strict-aliasing -fvisibility=hidden
//       -fno-gnu-unique -shared -fPIC -pthread -I tests/sm90
//       -I src/repro_torch/kernels/csrc -I <dir of wkv_cut.inc>
//       tests/sm90/wkv_harness.cpp
#include "emu.h"

#define __align__(n) __attribute__((aligned(n)))
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __bfloat162float(__nv_bfloat16 v) { return bf2f(v.x); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {f2bf(f)}; }

#include "wkv_cut.inc"

namespace {

template <typename T, typename TW>
void step(const void* r, const void* k, const void* v, const void* w,
          const float* u, const float* s0, void* y, float* sf, int B, int H,
          int T_len, const long long* st) {
  const wk::Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  run_grid(dim3(B * H), wk::kThreads, [&] {
    wk::wkv_kernel<T, TW>(static_cast<const T*>(r), static_cast<const T*>(k),
                          static_cast<const T*>(v),
                          static_cast<const TW*>(w), u, s0,
                          static_cast<T*>(y), sf, H, T_len, rs, ks, vs, ws,
                          ys);
  });
}

template <typename TW, int NJ>
void chunk(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, void* y, float* sf, int B, int H,
           int T_len, const long long* st) {
  using bf16 = __nv_bfloat16;
  const wk::Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      ys{st[12], st[13], st[14]};
  if (wk::Chunk<TW, NJ>::kSmem > (int)sizeof(smem_raw)) std::abort();
  run_grid(dim3(B * H, 64 / NJ), wk::kCThreads, [&] {
    wk::wkv_chunk_kernel<TW, NJ>(
        static_cast<const bf16*>(r), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const TW*>(w), u, s0,
        static_cast<bf16*>(y), sf, H, T_len, rs, ks, vs, ws, ys);
  });
}

template <typename TW>
int chunk_width(int nj, const void* r, const void* k, const void* v,
                const void* w, const float* u, const float* s0, void* y,
                float* sf, int B, int H, int T, const long long* st) {
  if (nj == 64) chunk<TW, 64>(r, k, v, w, u, s0, y, sf, B, H, T, st);
  else if (nj == 32) chunk<TW, 32>(r, k, v, w, u, s0, y, sf, B, H, T, st);
  else return 1;
  return 0;
}

}  // namespace

// wkv_launch's arguments (csrc/wkv.cu), without the stream: route 0 the
// step kernel, 1 the chunked kernel over nj columns a block.  Returns 0,
// or 1 for a combination without an instantiation.
extern "C" __attribute__((visibility("default"))) int wkv_host(
    int dtype, int wdtype, const void* r, const void* k, const void* v,
    const void* w, const float* u, const float* s0, void* y, float* sf,
    int B, int H, int T, const long long* st, int route, int nj) {
  using bf16 = __nv_bfloat16;
  if (route == 1) {
    if (dtype != 1) return 1;
    return wdtype == 0
               ? chunk_width<float>(nj, r, k, v, w, u, s0, y, sf, B, H, T, st)
               : chunk_width<bf16>(nj, r, k, v, w, u, s0, y, sf, B, H, T, st);
  }
  if (dtype == 0 && wdtype == 0)
    step<float, float>(r, k, v, w, u, s0, y, sf, B, H, T, st);
  else if (dtype == 1 && wdtype == 0)
    step<bf16, float>(r, k, v, w, u, s0, y, sf, B, H, T, st);
  else if (dtype == 1 && wdtype == 1)
    step<bf16, bf16>(r, k, v, w, u, s0, y, sf, B, H, T, st);
  else
    return 1;
  return 0;
}
