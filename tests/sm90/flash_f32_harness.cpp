// The float32 attention kernels (csrc/flash_attention.cu, the forward;
// csrc/flash_attention_bwd.cu, the dq, dk/dv and share-sum kernels) on the
// CPU: their device code up to the launch functions (flash_f32_cut.inc, cut
// by the test, each source in its own namespace: fwdk, bwdk), compiled
// against the sm90 emulator (tests/sm90/emu.h: a block's threads as
// std::threads meeting at barriers, shuffles through shared slots, cp.async
// landing only when its thread waits for its group) and run with the launch
// functions' grids and block sizes.  tests/test_torch_flash_f32_emu.py
// builds and runs it:
//   g++ -std=c++20 -O1 -fno-strict-aliasing -fvisibility=hidden
//       -fno-gnu-unique -shared -fPIC -pthread -I tests/sm90
//       -I src/repro_torch/kernels/csrc -I <dir of flash_f32_cut.inc>
//       tests/sm90/flash_f32_harness.cpp
#define EMU_CP_ASYNC_DEFERRED
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

// The kernels' shuffle of a whole array (flash_attention_f32.cuh): one
// exchange through per-thread slots between two warp barriers, where a
// shuffle a value would take two barriers each.
namespace fa32 {
inline float g_shfl_n[256][64];
template <int N>
inline void shfl_xor_n(float (&v)[N], int off) {
  static_assert(N <= 64, "slots");
  const int t = threadIdx.x;
  auto* w = g_block.warp[t / 32];
  for (int i = 0; i < N; ++i) g_shfl_n[t][i] = v[i];
  w->arrive_and_wait();
  const int u = (t & ~31) | ((t % 32) ^ off);
  for (int i = 0; i < N; ++i) v[i] = g_shfl_n[u][i];
  w->arrive_and_wait();
}
}  // namespace fa32

#include "flash_attention_f32.cuh"
#include "flash_f32_cut.inc"

namespace {

template <int HD>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int B, int H, int Hkv, int Tq, int Tk, const long long* st,
        int causal, int window, float scale, int split, float* part,
        int q_offset) {
  using C = fwdk::Fwd<HD>;
  if (C::kSmem > 232448 || C::kSmem > (int)sizeof(smem_raw)) return 2;
  if (split < 1 || (split > 1 && part == nullptr)) return 1;
  run_grid(fwdk::fwd_grid<HD>(B, H, Tq, split), C::kThreads, [&] {
    fwdk::flash_fwd_kernel<float, HD>(
        q, k, v, o, lse, H, Hkv, Tq, Tk, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal, window,
        scale, split, part, q_offset);
  });
  if (split > 1)
    run_grid(dim3(4), 256, [&] {
      fwdk::flash_fwd_combine_kernel<float, HD>(part, o, lse, B, H, Tq,
                                                st[9], st[10], st[11], split);
    });
  return 0;
}

template <int HD>
int bwd(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dq, float* dk,
        float* dv, int B, int H, int Hkv, int Tq, int Tk, const long long* s,
        int causal, int window, float scale, int split, float* part,
        int dq_split, float* dq_part, int q_offset) {
  using Q = bwdk::Dq<HD>;
  using KV = bwdk::Dkv<HD>;
  if (Q::kSmem > 232448 || KV::kSmem > 232448) return 2;
  if (split < 1 || (split > 1 && part == nullptr) || dq_split < 1 ||
      (dq_split > 1 && dq_part == nullptr))
    return 1;
  bwdk::Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.dout[i] = s[9 + i];
    st.dq[i] = s[12 + i];
    st.dk[i] = s[15 + i];
    st.dv[i] = s[18 + i];
  }
  auto sum = [&](const float* p, float* out, int N, int Tn,
                 const long long* os, int n) {
    run_grid(dim3(4), 256, [&] {
      bwdk::flash_bwd_sum_kernel<float, HD>(p, out, B, N, Tn, os[0], os[1],
                                            os[2], n);
    });
  };
  run_grid(bwdk::dq_grid<HD>(B, H, Tq, dq_split), Q::kThreads, [&] {
    bwdk::flash_bwd_dq_kernel<float, HD>(q, k, v, dout, lse, delta, dq, H,
                                         Hkv, Tq, Tk, st, causal, window,
                                         scale, dq_split, dq_part, q_offset);
  });
  if (dq_split > 1) sum(dq_part, dq, H, Tq, st.dq, dq_split);
  run_grid(bwdk::dkdv_grid<HD>(B, Hkv, Tk, split), KV::kThreads, [&] {
    bwdk::flash_bwd_dkdv_kernel<float, HD>(q, k, v, dout, lse, delta, dk,
                                           dv, part, H, Hkv, Tq, Tk, st,
                                           causal, window, scale, split,
                                           q_offset);
  });
  if (split > 1) {
    sum(part, dk, Hkv, Tk, st.dk, split);
    sum(part + (long long)split * B * Hkv * Tk * HD, dv, Hkv, Tk, st.dv,
        split);
  }
  return 0;
}

}  // namespace

// flash_attention_launch's arguments (csrc/flash_attention.cu) without the
// stream.  Returns 0; 1 for an hd without an instantiation or a split
// without its scratch; 2 for a block over the shared-memory limit.
extern "C" __attribute__((visibility("default"))) int flash_f32_fwd_host(
    int hd, const float* q, const float* k, const float* v, float* o,
    float* lse, int B, int H, int Hkv, int Tq, int Tk, const long long* st,
    int causal, int window, float scale, int split, float* part,
    int q_offset) {
  if (hd == 64)
    return fwd<64>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, st, causal, window,
                   scale, split, part, q_offset);
  if (hd == 128)
    return fwd<128>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, st, causal, window,
                    scale, split, part, q_offset);
  if (hd == 256)
    return fwd<256>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, st, causal, window,
                    scale, split, part, q_offset);
  return 1;
}

// flash_attention_bwd_launch's arguments (csrc/flash_attention_bwd.cu)
// without the stream; the same returns.
extern "C" __attribute__((visibility("default"))) int flash_f32_bwd_host(
    int hd, const float* q, const float* k, const float* v,
    const float* dout, const float* lse, const float* delta, float* dq,
    float* dk, float* dv, int B, int H, int Hkv, int Tq, int Tk,
    const long long* st, int causal, int window, float scale, int split,
    float* part, int dq_split, float* dq_part, int q_offset) {
  if (hd == 64)
    return bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, Tq, Tk,
                   st, causal, window, scale, split, part, dq_split, dq_part,
                   q_offset);
  if (hd == 128)
    return bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, Tq,
                    Tk, st, causal, window, scale, split, part, dq_split,
                    dq_part, q_offset);
  if (hd == 256)
    return bwd<256>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Hkv, Tq,
                    Tk, st, causal, window, scale, split, part, dq_split,
                    dq_part, q_offset);
  return 1;
}
