// csrc/tick_loop.cu on the CPU: the whole source, launched through a
// cudaLaunchKernel that walks the grid, with subnormals flushed (FTZ | DAZ,
// as -ftz=true) around each launch.  Build (see
// tests/test_torch_tick_loop_host.py):
//   g++ -std=c++17 -O1 -ffp-contract=off -shared -fPIC -I tests/tick_host \
//       -I src/repro_torch/kernels/csrc tests/tick_host/harness.cpp
#include <xmmintrin.h>

#include "tick_loop.cu"

cudaError_t cudaLaunchKernel(const void* fn, dim3 grid, dim3 block,
                             void** params, size_t, cudaStream_t) {
  auto kernel = reinterpret_cast<void (*)(tick::Args)>(const_cast<void*>(fn));
  const tick::Args args = *static_cast<tick::Args*>(params[0]);
  blockDim = block;
  gridDim = grid;
  for (unsigned b = 0; b < grid.x; ++b) {
    for (unsigned t = 0; t < block.x; ++t) {
      blockIdx = dim3(b);
      threadIdx = dim3(t);
      kernel(args);
    }
  }
  return cudaSuccess;
}

// tick_loop_launch's signature, under FTZ | DAZ.
extern "C" int host_tick_loop_launch(
    int p, int kind, int scaling, const void* prow, const void* bw,
    const void* f0, const void* i0, void* fout, void* iout, void* tput,
    void* power, void* load, void* nch, void* cores, void* freq, void* done,
    int n_lanes, int n_steps, int ctrl_every, float dt,
    const float* cpu_consts, int n_freq, int num_cores, const int* env_codes,
    const float* env_consts, const void* env_bins, void* stream) {
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040);
  const int err = tick_loop_launch(
      p, kind, scaling, prow, bw, f0, i0, fout, iout, tput, power, load, nch,
      cores, freq, done, n_lanes, n_steps, ctrl_every, dt, cpu_consts, n_freq,
      num_cores, env_codes, env_consts, env_bins, stream);
  _mm_setcsr(csr);
  return err;
}
