// A stub of the CUDA runtime for compiling csrc/tick_loop.cu with g++ on the
// CPU (tests/test_torch_tick_loop_host.py): the qualifiers vanish, the
// thread indices are thread-local globals, and cudaLaunchKernel (defined in
// harness.cpp) runs each block's threads as std::threads that meet at
// __syncthreads, with one global array as the block's dynamic shared
// memory (blocks run one after another).
#pragma once
#include <cmath>
#include <cstddef>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline thread_local dim3 blockIdx, threadIdx, blockDim, gridDim;

#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __global__
#define __launch_bounds__(x)
#define __shared__
#define __grid_constant__

void __syncthreads();

cudaError_t cudaLaunchKernel(const void* fn, dim3 grid, dim3 block,
                             void** params, size_t, cudaStream_t);
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}
