// csrc/rglru.cu's kernels on the CPU: the device code up to its launch
// functions (rglru_cut.inc, cut by the tests, whose <<<>>> launches g++
// does not parse), compiled against the sm90 emulator (tests/sm90/emu.h:
// a block's threads as std::threads meeting at barriers, __syncwarp, the
// mbarriers, unswizzled TMA loads with zeros past every bound and stores
// clipped to the bounds) and a
// bf16 stub.  x86-64 g++ contracts no multiply-add without -mfma, as
// nvcc's -fmad=false, and flushes no subnormal, as the source's build.
// Build:
//   g++ -std=c++20 -O1 -ffp-contract=off -fno-strict-aliasing \
//       -fvisibility=hidden -fno-gnu-unique -shared -fPIC -pthread \
//       -I tests/sm90 -I src/repro_torch/kernels/csrc \
//       -I <dir of rglru_cut.inc> tests/tick_host/rglru_harness.cpp
#include "emu.h"

inline float __bfloat162float(__nv_bfloat16 v) { return bf2f(v.x); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {f2bf(f)}; }
typedef void* cudaStream_t;   // the launch functions' declaration in the cut

#include "rglru_cut.inc"

namespace {

// The map rglru_launch encodes over a [B, T, C] operand: dims (C, T, B),
// the byte strides of T and B, a box of W channels x Tc steps.
CUtensorMap map3(const void* base, int es, int C, int T_len, int B,
                 long long st_t, long long st_b, int w, int tc) {
  CUtensorMap m{};
  m.base = static_cast<const uint8_t*>(base);
  m.rank = 3;
  m.esize = es;
  m.dims[0] = C;
  m.dims[1] = T_len;
  m.dims[2] = B;
  m.strides[0] = st_t * es;
  m.strides[1] = st_b * es;
  m.box[0] = w;
  m.box[1] = tc;
  return m;
}

template <typename T, int W>
void forward(const void* a, const void* b, void* h, int B, int T_len, int C,
             const long long* st, int tma) {
  CUtensorMap ta{}, tb{}, th{};
  if (tma) {
    constexpr int tc = rg::Ring<T, W>::kTc;
    ta = map3(a, sizeof(T), C, T_len, B, st[1], st[0], W, tc);
    tb = map3(b, sizeof(T), C, T_len, B, st[3], st[2], W, tc);
    th = map3(h, sizeof(T), C, T_len, B, st[5], st[4], W, tc);
  }
  run_grid(dim3((C + W - 1) / W, B), rg::kThreads, [&] {
    rg::rglru_kernel<T, W>(ta, tb, th, static_cast<const T*>(a),
                           static_cast<const T*>(b), static_cast<T*>(h), C,
                           T_len, st[0], st[1], st[2], st[3], st[4], st[5],
                           tma);
  });
}

template <typename T, int W>
void backward(const void* a, const void* h, const void* g, void* da,
              void* db, int B, int T_len, int C, const long long* st,
              int tma) {
  CUtensorMap m[5] = {};
  if (tma) {
    constexpr int tc = rg::BwdRing<T, W>::kTc;
    const void* ptrs[5] = {a, h, g, da, db};
    for (int i = 0; i < 5; ++i)
      m[i] = map3(ptrs[i], i < 3 ? (int)sizeof(T) : 4, C, T_len, B,
                  st[2 * i + 1], st[2 * i], W, tc);
  }
  run_grid(dim3((C + W - 1) / W, B), rg::kThreads, [&] {
    rg::rglru_bwd_kernel<T, W>(
        m[0], m[1], m[2], m[3], m[4], static_cast<const T*>(a),
        static_cast<const T*>(h), static_cast<const T*>(g),
        static_cast<float*>(da), static_cast<float*>(db), C, T_len, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], tma);
  });
}

template <typename T>
int run(int mode, const void* x, const void* y, const void* z, void* o0,
        void* o1, int B, int T_len, int C, const long long* st, int width) {
  if (width != 16 && width != 32) return 1;
  if (mode == 1 || mode == 3) {
    const int tma = mode == 3;
    if (width == 32) backward<T, 32>(x, y, z, o0, o1, B, T_len, C, st, tma);
    else backward<T, 16>(x, y, z, o0, o1, B, T_len, C, st, tma);
    return 0;
  }
  const int tma = mode == 2;
  if (width == 32) forward<T, 32>(x, y, o0, B, T_len, C, st, tma);
  else forward<T, 16>(x, y, o0, B, T_len, C, st, tma);
  return 0;
}

}  // namespace

// mode 0: h = scan(x = a, y = b) into o0 on the direct path (strides of a,
// b, h); mode 2: the same through the TMA ring.  mode 1: (da, db) = (o0,
// o1) from x = a, y = h, z = g (strides of a, h, g, da, db) on the
// backward's direct path; mode 3: the same through its TMA ring.  width:
// the block's channels (16 or 32).  dtype 0 = float32, 1 = bfloat16.
// Returns 0, or 1 for a width without an instantiation.
extern "C" __attribute__((visibility("default"))) int rglru_host(int mode, int dtype, const void* x, const void* y,
                          const void* z, void* o0, void* o1, int B, int T,
                          int C, const long long* strides, int width) {
  if (dtype == 0)
    return run<float>(mode, x, y, z, o0, o1, B, T, C, strides, width);
  return run<__nv_bfloat16>(mode, x, y, z, o0, o1, B, T, C, strides, width);
}
