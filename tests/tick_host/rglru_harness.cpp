// csrc/rglru.cu's kernels on the CPU: the device code up to its launch
// functions (rglru_cut.inc, cut by tests/test_torch_rglru_bwd.py, whose
// <<<>>> launches g++ does not parse), compiled against the stub runtime of
// cuda_runtime.h and a bf16 stub, each grid walked thread by thread (the
// kernels share nothing between threads).  x86-64 g++ contracts no
// multiply-add without -mfma, as nvcc's -fmad=false, and flushes no
// subnormal, as the source's build.  Build:
//   g++ -std=c++17 -O1 -ffp-contract=off -shared -fPIC \
//       -I tests/tick_host -I <dir of rglru_cut.inc> \
//       tests/tick_host/rglru_harness.cpp
#include <cstdint>
#include <cstring>

#include "cuda_runtime.h"

struct __nv_bfloat16 {
  uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {0x7fc0};
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}

#include "rglru_cut.inc"

namespace {

template <typename F>
void walk(int B, int C, F kernel) {
  for (unsigned by = 0; by < (unsigned)B; ++by)
    for (unsigned bx = 0; bx * rg::kThreads < (unsigned)C; ++bx)
      for (unsigned t = 0; t < (unsigned)rg::kThreads; ++t) {
        blockIdx = dim3(bx, by);
        threadIdx = dim3(t);
        kernel();
      }
}

template <typename T>
void run(int bwd, const void* x, const void* y, const void* z, void* o0,
         void* o1, int B, int T_len, int C, const long long* st) {
  if (!bwd) {
    walk(B, C, [&] {
      rg::rglru_kernel<T>(static_cast<const T*>(x), static_cast<const T*>(y),
                          static_cast<T*>(o0), C, T_len, st[0], st[1], st[2],
                          st[3], st[4], st[5]);
    });
    return;
  }
  walk(B, C, [&] {
    rg::rglru_bwd_kernel<T>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(z), static_cast<float*>(o0),
        static_cast<float*>(o1), C, T_len, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9]);
  });
}

}  // namespace

// bwd 0: h = scan(x = a, y = b) into o0 (strides of a, b, h); bwd 1:
// (da, db) = (o0, o1) from x = a, y = h, z = g (strides of a, h, g, da,
// db).  dtype 0 = float32, 1 = bfloat16.
extern "C" void rglru_host(int bwd, int dtype, const void* x, const void* y,
                           const void* z, void* o0, void* o1, int B, int T,
                           int C, const long long* strides) {
  if (dtype == 0)
    run<float>(bwd, x, y, z, o0, o1, B, T, C, strides);
  else
    run<__nv_bfloat16>(bwd, x, y, z, o0, o1, B, T, C, strides);
}
