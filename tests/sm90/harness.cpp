// Runs the bf16 attention kernels' device code under emu.h on inputs from a
// file, as their launch functions would on the card, and writes the
// outputs; or checks the fragment-layout helpers of sm90.cuh.
//   harness fwd <in> <out>    harness bwd <in> <out>    harness layout
// The input file is written by tests/test_torch_flash_sm90.py: a header of
// int64 (shapes, masks, the wrappers' TMA geometry, output strides, the
// storage sizes and offsets of every tensor) and the tensors' storages.
// kernels_cut.inc is the two sources' device code up to their launch
// functions, each in its own namespace (fwdk, bwdk).
#include "emu.h"

#include <cstdio>
#include <fstream>
#include <string>

#include "kernels_cut.inc"

static std::vector<long long> rd_ll(std::ifstream& f, int n) {
  std::vector<long long> v(n);
  f.read((char*)v.data(), n * 8);
  return v;
}
static std::vector<uint8_t> rd_bytes(std::ifstream& f, long long n) {
  std::vector<uint8_t> v(n);
  f.read((char*)v.data(), n);
  return v;
}
static CUtensorMap map4(const uint8_t* base, const long long* g) {
  CUtensorMap m{};
  m.base = base; m.rank = 4; m.esize = 2; m.swizzle = 1;
  for (int i = 0; i < 4; ++i) m.dims[i] = g[i];
  for (int i = 0; i < 3; ++i) m.strides[i] = g[4 + i];
  m.box[0] = g[7]; m.box[1] = g[8];
  return m;
}
static CUtensorMap map2(const float* base, long long T, long long rows, long long pitch, int box) {
  CUtensorMap m{};
  m.base = (const uint8_t*)base; m.rank = 2; m.esize = 4; m.swizzle = 0;
  m.dims[0] = T; m.dims[1] = rows; m.strides[0] = pitch * 4; m.box[0] = box; m.box[1] = 1;
  return m;
}

template <int HD>
void run_fwd(const std::vector<long long>& h, std::vector<uint8_t>& q, std::vector<uint8_t>& k,
         std::vector<uint8_t>& v, std::vector<uint8_t>& o, std::vector<float>& lse) {
  const int B = h[1], H = h[2], Hkv = h[3], Tq = h[4], Tk = h[5], causal = h[6], window = h[7];
  const long long* geom = &h[9];
  const long long* ostr = &h[36];
  const long long* off = &h[39 + 4];   // storage offsets q k v o (elements)
  using namespace fwdk;
  using C = Fwd<HD>;
  if (geom[8] != kBQ || geom[17] != C::kBK) { printf("box mismatch\n"); std::exit(3); }
  CUtensorMap tq = map4(q.data() + off[0] * 2, geom), tk = map4(k.data() + off[1] * 2, geom + 9),
              tv = map4(v.data() + off[2] * 2, geom + 18);
  __nv_bfloat16* op = (__nv_bfloat16*)(o.data() + off[3] * 2);
  float scale_log2 = (1.0f / std::sqrt((float)HD)) * 1.4426950408889634f;
  run_grid(dim3(H, B, (Tq + kBQ - 1) / kBQ), kThreads, [&] {
    flash_fwd_sm90_kernel<HD>(tq, tk, tv, op, h[8] ? lse.data() : nullptr, H, Hkv, Tq, Tk,
                              ostr[0], ostr[1], ostr[2], causal, window, scale_log2);
  });
  if (C::kSmem > 232448) { printf("smem too large\n"); std::exit(3); }
}

template <int HD>
void run_bwd(const std::vector<long long>& h, std::vector<std::vector<uint8_t>>& st,
         std::vector<float>& lse, std::vector<float>& delta) {
  const int B = h[1], H = h[2], Hkv = h[3], Tq = h[4], Tk = h[5], causal = h[6], window = h[7];
  const int pitch = h[8];
  const long long* geom = &h[9];
  const long long* ostr = &h[81];
  const long long* off = &h[90 + 7];
  using namespace bwdk;
  OutStrides os;
  for (int i = 0; i < 3; ++i) { os.dq[i] = ostr[i]; os.dk[i] = ostr[3 + i]; os.dv[i] = ostr[6 + i]; }
  const int rows[8] = {kQBQ, kQBK, kQBK, kQBQ, kKBQ, kKBK, kKBK, kKBQ};
  for (int i = 0; i < 8; ++i)
    if (geom[9 * i + 8] != rows[i]) { printf("box mismatch %d\n", i); std::exit(3); }
  CUtensorMap m[8];
  for (int i = 0; i < 8; ++i) m[i] = map4(st[i % 4].data() + off[i % 4] * 2, geom + 9 * i);
  CUtensorMap tl = map2(lse.data(), Tq, (long long)B * H, pitch, kKBQ);
  CUtensorMap td = map2(delta.data(), Tq, (long long)B * H, pitch, kKBQ);
  auto* dq = (__nv_bfloat16*)(st[4].data() + off[4] * 2);
  auto* dk = (__nv_bfloat16*)(st[5].data() + off[5] * 2);
  auto* dv = (__nv_bfloat16*)(st[6].data() + off[6] * 2);
  const float scale = 1.0f / std::sqrt((float)HD);
  using C = Bwd<HD>;
  if (C::kDqSmem > 232448 || C::kKvSmem > 232448) { printf("smem too large\n"); std::exit(3); }
  run_grid(dim3(H * C::kSplit, B, (Tq + kQBQ - 1) / kQBQ), kThreads, [&] {
    flash_bwd_dq_sm90_kernel<HD>(m[0], m[1], m[2], m[3], lse.data(), delta.data(), pitch, dq, H,
                                 Hkv, Tq, Tk, os, causal, window, scale);
  });
  run_grid(dim3(Hkv * C::kSplit, B, (Tk + kKBK - 1) / kKBK), kThreads, [&] {
    flash_bwd_dkdv_sm90_kernel<HD>(m[4], m[5], m[6], m[7], tl, td, dk, dv, H, Hkv, Tq, Tk, os,
                                   causal, window, scale);
  });
}

// The accumulator fragment of m64nN covers the 64 x N tile once, and its
// registers 8 kk .. 8 kk + 7 are the A fragment of k-step kk.
int check_layout() {
  using namespace sm90;
  std::vector<int> seen(64 * 256, 0);
  for (int t = 0; t < 128; ++t)
    for (int r = 0; r < 128; ++r) seen[acc_row(t, r) * 256 + acc_col(t, r)]++;
  for (int x : seen)
    if (x != 1) return 1;
  for (int t = 0; t < 128; ++t)
    for (int kk = 0; kk < 16; ++kk)
      for (int i = 0; i < 4; ++i)
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * kk + 2 * i + e;
          if (acc_row(t, r) != afrag_row(t, i) ||
              acc_col(t, r) != 16 * kk + afrag_col(t, i, e))
            return 2;
        }
  std::printf("layout ok\n");
  return 0;
}

int main(int argc, char** argv) {
  if (std::string(argv[1]) == "layout") return check_layout();
  std::ifstream f(argv[2], std::ios::binary);
  std::ofstream out(argv[3], std::ios::binary);
  if (std::string(argv[1]) == "fwd") {
    auto h = rd_ll(f, 39 + 8);
    const long long* n = &h[39];
    auto q = rd_bytes(f, n[0] * 2), k = rd_bytes(f, n[1] * 2), v = rd_bytes(f, n[2] * 2);
    std::vector<uint8_t> o(n[3] * 2, 0xFF);
    std::vector<float> lse((size_t)h[1] * h[2] * h[4]);
    const int hd = h[0];
    if (hd == 64) run_fwd<64>(h, q, k, v, o, lse);
    else if (hd == 128) run_fwd<128>(h, q, k, v, o, lse);
    else run_fwd<256>(h, q, k, v, o, lse);
    out.write((char*)o.data(), o.size());
    out.write((char*)lse.data(), lse.size() * 4);
  } else {
    auto h = rd_ll(f, 90 + 14);
    const long long* n = &h[90];
    std::vector<std::vector<uint8_t>> st(7);
    for (int i = 0; i < 4; ++i) st[i] = rd_bytes(f, n[i] * 2);
    for (int i = 4; i < 7; ++i) st[i] = std::vector<uint8_t>(n[i] * 2, 0xFF);
    const long long nl = (long long)h[1] * h[2] * h[8];
    std::vector<float> lse(nl), delta(nl);
    f.read((char*)lse.data(), nl * 4);
    f.read((char*)delta.data(), nl * 4);
    if (h[0] == 64) run_bwd<64>(h, st, lse, delta);
    else if (h[0] == 128) run_bwd<128>(h, st, lse, delta);
    else run_bwd<256>(h, st, lse, delta);
    for (int i = 4; i < 7; ++i) out.write((char*)st[i].data(), st[i].size());
  }
  return 0;
}
