// A CPU stand-in for the little of CUDA that csrc/attention.cuh, attention.cu, the int8 sources,
// transformer_block.cu and the other covered sources use, so that those sources compile with g++ and
// their kernels run, slowly, where there is no card and no nvcc: one
// std::thread per CUDA thread, the blocks of a launch one after another.
// tools/cuda_emu/emulate.py rewrites the launch syntax and the shared-memory
// declarations and builds the library; see there for what is covered.

#pragma once

#include <math.h>

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x) __attribute__((aligned(x)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};

inline float __int2float_rn(int v) { return (float)v; }  // to nearest, as the host rounds
inline unsigned __float_as_uint(float v) {
  unsigned u;
  memcpy(&u, &v, 4);
  return u;
}
inline int __float_as_int(float v) { return (int)__float_as_uint(v); }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

constexpr size_t EMU_MAX_SHARED = 232448;  // what a block may ask for on an H100

template <typename F> cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > (int)EMU_MAX_SHARED ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) {  // one card
  *device = 0;
  return cudaSuccess;
}
// what a compiled kernel would report: nothing here (no registers, one block an SM)
struct cudaFuncAttributes {
  int numRegs;
};
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* attr, const void*) {
  attr->numRegs = 0;
  return cudaSuccess;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, const void*, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline float emu_shuffle[1024];
alignas(1024) inline float emu_shared[EMU_MAX_SHARED / sizeof(float)];  // dynamic shared memory of the running block

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

// whether any thread of the block passed a nonzero p: the flags meet in one word between two barriers, and a third
// lets thread 0 clear it before any thread can set it again
inline std::atomic<int> emu_any_flag{0};
inline int __syncthreads_or(int p) {
  if (p) emu_any_flag.store(1);
  emu_block_barrier->arrive_and_wait();
  const int any = emu_any_flag.load();
  emu_block_barrier->arrive_and_wait();
  if (threadIdx.x == 0) emu_any_flag.store(0);
  emu_block_barrier->arrive_and_wait();
  return any;
}

// Every lane of the warp must call it (as the kernels do: their shuffles sit
// under warp-uniform conditions only).
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x, w = t >> 5;
  emu_shuffle[t] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  const float r = emu_shuffle[t ^ lane_mask];
  emu_warp_barriers[w]->arrive_and_wait();
  return r;
}

// lanes past the warp's last read their own value, as on the card
inline float __shfl_down_sync(unsigned, float v, int delta) {
  const int t = threadIdx.x, w = t >> 5;
  emu_shuffle[t] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  const float r = (t & 31) + delta < 32 ? emu_shuffle[t + delta] : v;
  emu_warp_barriers[w]->arrive_and_wait();
  return r;
}

inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
// the warp's barrier: every lane of the warp calls it
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_barriers[threadIdx.x >> 5]->arrive_and_wait(); }
// the IEEE operations that nvcc never contracts into an FMA (g++ -O1 does not contract across statements either)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int min(int a, int b) { return a < b ? a : b; }

// kernel<<<grid, block, shared, stream>>>(args) becomes
// emu_launch(grid, block, shared, stream, [=] { kernel(args); }).  The block
// size must be a multiple of 32.  Dynamic shared memory is filled with NaN
// before each block (a word whose two bf16 halves are NaN as well), so a read
// of a word or half-word that was never written shows.
inline void emu_launch(dim3 grid, int block, size_t shared_bytes, cudaStream_t, std::function<void()> kernel) {
  if (shared_bytes > EMU_MAX_SHARED || block % 32 != 0) abort();
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> block_barrier(block);
        emu_block_barrier = &block_barrier;
        emu_warp_barriers.clear();
        for (int w = 0; w < block / 32; ++w) emu_warp_barriers.emplace_back(new std::barrier<>(32));
        const uint32_t poison = 0x7FC07FC0u;
        for (size_t i = 0; i < shared_bytes / sizeof(float); ++i) memcpy(&emu_shared[i], &poison, 4);
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t)
          threads.emplace_back([=] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            blockDim = dim3(block);
            gridDim = grid;
            kernel();
          });
        for (auto& th : threads) th.join();
      }
}
