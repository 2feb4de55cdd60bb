// csrc/tick_loop.cu on the CPU: the whole source, launched through a
// cudaLaunchKernel that walks the grid block by block, each block's threads
// as std::threads meeting at __syncthreads, with subnormals flushed
// (FTZ | DAZ, as -ftz=true) in every thread.  Build (see
// tests/test_torch_tick_loop_host.py):
//   g++ -std=c++17 -O1 -ffp-contract=off -shared -fPIC -pthread \
//       -I tests/tick_host -I src/repro_torch/kernels/csrc \
//       tests/tick_host/harness.cpp
#include <xmmintrin.h>

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include "tick_loop.cu"

// The running block's dynamic shared memory (blocks run one at a time).
float tick::policy_smem[16384];

namespace {

// A reusable barrier for the threads of one block.
struct Barrier {
  explicit Barrier(unsigned n) : n(n) {}
  void wait() {
    std::unique_lock<std::mutex> lock(mu);
    const unsigned gen = generation;
    if (++arrived == n) {
      arrived = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return gen != generation; });
    }
  }
  const unsigned n;
  unsigned arrived = 0, generation = 0;
  std::mutex mu;
  std::condition_variable cv;
};

Barrier* g_barrier = nullptr;

}  // namespace

void __syncthreads() { g_barrier->wait(); }

cudaError_t cudaLaunchKernel(const void* fn, dim3 grid, dim3 block,
                             void** params, size_t smem, cudaStream_t) {
  if (smem > sizeof(tick::policy_smem)) return cudaErrorInvalidValue;
  auto kernel = reinterpret_cast<void (*)(tick::Args)>(const_cast<void*>(fn));
  const tick::Args args = *static_cast<tick::Args*>(params[0]);
  const unsigned csr = _mm_getcsr();
  for (unsigned b = 0; b < grid.x; ++b) {
    Barrier barrier(block.x);
    g_barrier = &barrier;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t) {
      threads.emplace_back([=] {
        _mm_setcsr(csr);
        blockDim = block;
        gridDim = grid;
        blockIdx = dim3(b);
        threadIdx = dim3(t);
        kernel(args);
      });
    }
    for (auto& th : threads) th.join();
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
    const float* env_consts, const void* env_bins, const void* policy,
    const int* widths, int n_layers, void* stream) {
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040);
  const int err = tick_loop_launch(
      p, kind, scaling, prow, bw, f0, i0, fout, iout, tput, power, load, nch,
      cores, freq, done, n_lanes, n_steps, ctrl_every, dt, cpu_consts, n_freq,
      num_cores, env_codes, env_consts, env_bins, policy, widths, n_layers,
      stream);
  _mm_setcsr(csr);
  return err;
}
