// A probe of the building blocks in src/repro_torch/kernels/csrc/sm90.cuh on
// the card: TMA loads of 128-byte-swizzled tiles into wgmma, with both
// operands K-major in shared memory (probe_ss: S = A B^T, as S = Q K^T) and
// with A in registers and an MN-major B (probe_rs: O = A V, as O += P V).
// tests/sm90/probe.py builds it (-I the csrc directory) and holds both
// against torch.matmul.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "sm90.cuh"
using namespace sm90;

// S[64][64] = A[64][128] . B[64][128]^T
__global__ void probe_ss(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb, float* out) {
  extern __shared__ uint8_t raw[];
  __shared__ uint64_t bar;
  uint8_t* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint8_t* sA = sm;
  uint8_t* sB = sm + 64 * 128 * 2;
  const int t = threadIdx.x;
  if (t == 0) { mbar_init(&bar, 1); fence_barrier_init(); }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(&bar, 2 * 64 * 128 * 2);
    for (int x = 0; x < 2; ++x) {
      tma_load_4d(sA + x * 64 * 128, &ta, &bar, 64 * x, 0, 0, 0);
      tma_load_4d(sB + x * 64 * 128, &tb, &bar, 64 * x, 0, 0, 0);
    }
  }
  mbar_wait(&bar, 0);
  float d[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss<64>(d, make_desc(smem_u32(sA) + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
                 make_desc(smem_u32(sB) + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  fence_acc<32>(d);
  for (int r = 0; r < 32; ++r) out[acc_row(t, r) * 64 + acc_col(t, r)] = d[r];
}

// O[64][128] = A[64][64] (registers) . V[64][128] (MN-major)
__global__ void probe_rs(const __nv_bfloat16* a, const __grid_constant__ CUtensorMap tv,
                         float* out) {
  extern __shared__ uint8_t raw[];
  __shared__ uint64_t bar;
  uint8_t* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const int t = threadIdx.x;
  if (t == 0) { mbar_init(&bar, 1); fence_barrier_init(); }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(&bar, 64 * 128 * 2);
    for (int x = 0; x < 2; ++x) tma_load_4d(sm + x * 64 * 128, &tv, &bar, 64 * x, 0, 0, 0);
  }
  uint32_t af[4][4];
  for (int kk = 0; kk < 4; ++kk)
    for (int i = 0; i < 4; ++i) {
      const int row = afrag_row(t, i);
      const float lo = __bfloat162float(a[row * 64 + 16 * kk + afrag_col(t, i, 0)]);
      const float hi = __bfloat162float(a[row * 64 + 16 * kk + afrag_col(t, i, 1)]);
      af[kk][i] = pack_bf16x2(lo, hi);
    }
  mbar_wait(&bar, 0);
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  fence_acc<64>(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<128>(d, af[kk], make_desc(smem_u32(sm) + kk * 2048, 64 * 128, 1024), 1);
  wgmma_commit();
  wgmma_wait0();
  fence_acc<64>(d);
  for (int r = 0; r < 64; ++r) out[acc_row(t, r) * 128 + acc_col(t, r)] = d[r];
}

extern "C" int probe_launch(int which, const void* a, const void* b, float* out, void* stream) {
  // [1, 64, 1, 128] contiguous views: dims (128, 64, 1, 1)
  long long g[9] = {128, 64, 1, 1, 256, 256, 64 * 256, 64, 64};
  CUtensorMap ta, tb;
  int err = encode_bf16_4d(&ta, a, g);
  if (err) return err;
  err = encode_bf16_4d(&tb, b, g);
  if (err) return err;
  const int smem = 2 * 64 * 128 * 2 + 1024;
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) {
    cudaFuncSetAttribute(probe_ss, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    probe_ss<<<1, 128, smem, s>>>(ta, tb, out);
  } else {
    cudaFuncSetAttribute(probe_rs, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    probe_rs<<<1, 128, smem, s>>>((const __nv_bfloat16*)a, tb, out);
  }
  return (int)cudaGetLastError();
}
