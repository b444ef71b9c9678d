// A CPU stand-in for cpu_vision_tpu_torch/csrc/hopper.cuh: the same functions,
// for the emulated threads of cuda_runtime.h.  emulate.py puts this file in
// place of the real one, whose bodies are inline PTX.
//
// Shared addresses are byte offsets into emu_shared (1024-byte aligned, as
// the card's shared window).  A copy (cp_async16) and a product
// (wgmma_m64n128k16_bf16) are queued by the thread that starts them and run
// when its wait retires their group, the latest moment the card may run
// them: a missing wait or barrier reads or overwrites a stage too early and
// shows as a NaN of the poisoned shared memory or a wrong sum.  The product
// reads its operands through the descriptors' fields and the 128-byte
// swizzle as hopper.cuh describes them, and sums the 16 products of an
// output in order, so it checks the kernel's tiling against that reading of
// the hardware, not the hardware itself.

#pragma once

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <vector>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace cvt {

inline uint32_t smem_addr(const void* p) {
  return (uint32_t)((const char*)p - (const char*)emu_shared);
}

struct EmuQueue {
  std::vector<std::function<void()>> open;
  std::deque<std::vector<std::function<void()>>> groups;
  void commit() {
    groups.push_back(std::move(open));
    open.clear();
  }
  void wait(size_t pending) {
    while (groups.size() > pending) {
      for (auto& op : groups.front()) op();
      groups.pop_front();
    }
  }
};
inline thread_local EmuQueue emu_copies, emu_products;

inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  if (dst % 16 || dst + 16 > EMU_MAX_SHARED) abort();
  emu_copies.open.push_back([=] {
    char* to = (char*)emu_shared + dst;
    if (valid)
      memcpy(to, src, 16);
    else
      memset(to, 0, 16);
  });
}
inline void cp_async_commit() { emu_copies.commit(); }
template <int N> inline void cp_async_wait() { emu_copies.wait(N); }
inline void fence_proxy_async() {}

inline void wgmma_fence() {}
inline void wgmma_commit() { emu_products.commit(); }
template <int N> inline void wgmma_wait() { emu_products.wait(N); }
template <int N> inline void fence_sums(float (&)[N]) {}

inline uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// the bf16 at byte address addr of the 128-byte swizzled layout
inline float emu_sw128(uint32_t addr) {
  addr ^= ((addr >> 7) & 7) << 4;
  if (addr + 2 > EMU_MAX_SHARED) abort();
  __nv_bfloat16 v;
  memcpy(&v, (const char*)emu_shared + addr, 2);
  return __bfloat162float(v);
}

inline void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t a, uint64_t b) {
  if ((a >> 62) != 1 || (b >> 62) != 1) abort();  // only the 128-byte swizzle
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
  float* out = d;
  emu_products.open.push_back([=] {
    const uint32_t a0 = (uint32_t)(a & 0x3FFF) << 4, a_sbo = (uint32_t)((a >> 32) & 0x3FFF) << 4;
    const uint32_t b0 = (uint32_t)(b & 0x3FFF) << 4, b_lbo = (uint32_t)((b >> 16) & 0x3FFF) << 4,
                   b_sbo = (uint32_t)((b >> 32) & 0x3FFF) << 4;
    for (int j = 0; j < 16; ++j)
      for (int h = 0; h < 2; ++h)
        for (int e = 0; e < 2; ++e) {
          const int row = 16 * w + l / 4 + 8 * h, col = 8 * j + 2 * (l % 4) + e;
          float sum = 0.0f;
          for (int k = 0; k < 16; ++k) {
            // A K-major: rows of 128 bytes, groups of 8 rows SBO apart
            const float av = emu_sw128(a0 + (row / 8) * a_sbo + (row % 8) * 128 + k * 2);
            // B MN-major: k rows of 128 bytes (64 columns), groups of 8 k SBO apart, 64-column blocks LBO apart
            const float bv = emu_sw128(b0 + (col / 64) * b_lbo + (k / 8) * b_sbo + (k % 8) * 128 + (col % 64) * 2);
            sum += av * bv;
          }
          out[4 * j + 2 * h + e] += sum;
        }
  });
}

}  // namespace cvt
