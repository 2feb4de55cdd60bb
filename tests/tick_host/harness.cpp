// csrc/tick_loop.cu on the CPU: the whole source, launched through a
// cudaLaunchKernel that walks the grid block by block, each block's threads
// as std::threads meeting at __syncthreads, with subnormals flushed
// (FTZ | DAZ, as -ftz=true) in every thread.  The launch
// (tick_loop_grouped_launch, its descriptors filled by
// tick_loop_set_group) runs its blocks one after another.  Build (see
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

// Runs one block's threads as std::threads meeting at __syncthreads.
template <typename A>
void run_block(void (*kernel)(A), const A& args, dim3 grid, dim3 block,
               unsigned b, unsigned csr) {
  Barrier barrier(block.x);
  g_barrier = &barrier;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block.x; ++t) {
    threads.emplace_back([=, &args] {
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

cudaError_t cudaLaunchKernel(const void* fn, dim3 grid, dim3 block,
                             void** params, size_t smem, cudaStream_t) {
  if (smem > sizeof(tick::policy_smem)) return cudaErrorInvalidValue;
  const unsigned csr = _mm_getcsr();
  auto kernel =
      reinterpret_cast<void (*)(tick::GroupTable)>(const_cast<void*>(fn));
  const auto& table = *static_cast<tick::GroupTable*>(params[0]);
  for (unsigned b = 0; b < grid.x; ++b)
    run_block(kernel, table, grid, block, b, csr);
  return cudaSuccess;
}

// tick_loop_grouped_launch's signature, under FTZ | DAZ; its blocks run
// one after another.
extern "C" int host_tick_loop_grouped_launch(int p, const void* groups,
                                             int n_groups, void* stream) {
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040);
  const int err = tick_loop_grouped_launch(p, groups, n_groups, stream);
  _mm_setcsr(csr);
  return err;
}
