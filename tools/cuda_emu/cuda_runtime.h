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
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }

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

// The shuffles and votes: every lane of the warp must call them (as the kernels do: they sit under warp-uniform
// conditions only), and in the same order.  The shuffles move any 4-byte value (float, int, unsigned) through one
// word a thread, in one of two buffers by turns: one barrier an exchange is enough, since a lane that writes a
// buffer again has passed the next exchange's barrier, which every lane reaches only after its last read of it.
inline uint32_t emu_shuffle[2][1024];
inline thread_local unsigned emu_turn = 0;
template <typename T> inline uint32_t emu_word(T v) {
  static_assert(sizeof(T) == 4, "4-byte shuffles");
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}
template <typename T> inline T emu_value(uint32_t u) {
  T v;
  memcpy(&v, &u, 4);
  return v;
}
// every lane's value of the warp's lane src(lane) (a lane of the warp's 32)
template <typename T, typename Src> inline T emu_exchange(T v, Src src) {
  const int t = threadIdx.x, w = t >> 5;
  uint32_t* const buf = emu_shuffle[emu_turn++ & 1];
  buf[t] = emu_word(v);
  emu_warp_barriers[w]->arrive_and_wait();
  return emu_value<T>(buf[(w << 5) | src(t & 31)]);
}
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return emu_exchange(v, [=](int l) { return l ^ lane_mask; });
}
// lanes past the warp's last (or before its first) read their own value, as on the card
template <typename T> inline T __shfl_down_sync(unsigned, T v, int delta) {
  return emu_exchange(v, [=](int l) { return l + delta < 32 ? l + delta : l; });
}
template <typename T> inline T __shfl_up_sync(unsigned, T v, int delta) {
  return emu_exchange(v, [=](int l) { return l - delta >= 0 ? l - delta : l; });
}
template <typename T> inline T __shfl_sync(unsigned, T v, int src_lane) {
  return emu_exchange(v, [=](int) { return src_lane & 31; });
}
// bit l: lane l's predicate
inline unsigned __ballot_sync(unsigned, int p) {
  const int t = threadIdx.x, w = t >> 5;
  uint32_t* const buf = emu_shuffle[emu_turn++ & 1];
  buf[t] = p != 0;
  emu_warp_barriers[w]->arrive_and_wait();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l) bits |= buf[(w << 5) | l] << l;
  return bits;
}
inline int __any_sync(unsigned mask, int p) { return __ballot_sync(mask, p) != 0; }
// the OR of every lane's v
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  const int t = threadIdx.x, w = t >> 5;
  uint32_t* const buf = emu_shuffle[emu_turn++ & 1];
  buf[t] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l) bits |= buf[(w << 5) | l];
  return bits;
}
// the 1-based position of the lowest set bit of x, 0 for none
inline int __ffsll(long long x) { return x ? __builtin_ctzll((unsigned long long)x) + 1 : 0; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
// the high word of (hi:lo) << (shift & 31), the low word of (hi:lo) >> (shift & 31)
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned shift) {
  return (unsigned)((((uint64_t)hi << 32 | lo) << (shift & 31)) >> 32);
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return (unsigned)(((uint64_t)hi << 32 | lo) >> (shift & 31));
}

inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
// the warp's barrier: every lane of the warp calls it
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_barriers[threadIdx.x >> 5]->arrive_and_wait(); }
// the IEEE operations that nvcc never contracts into an FMA (g++ -O1 does not contract across statements either)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __double2float_rn(double a) { return (float)a; }  // to nearest, as the host rounds
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

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
