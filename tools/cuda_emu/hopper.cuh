// A CPU stand-in for cpu_vision_tpu_torch/csrc/hopper.cuh: the same functions,
// for the emulated threads of cuda_runtime.h.  emulate.py puts this file in
// place of the real one, whose bodies are inline PTX.
//
// Shared addresses are byte offsets into emu_shared (1024-byte aligned, as
// the card's shared window).  A copy (cp_async16) and a product (the wgmma
// functions) are queued by the thread that starts them and run when its wait
// retires their group, the latest moment the card may run them: a missing
// wait or barrier reads or overwrites a stage too early and shows as a NaN of
// the poisoned shared memory or a wrong sum.  The products read their shared
// operands through the descriptors' fields and the 128- or 64-byte swizzle
// as hopper.cuh describes them, K-major or MN-major by the instruction's
// transpose flags, and A from registers out of the four registers of each
// thread of the warp that holds the output's row (read at the wait too, so a
// register changed before its product retired shows as a wrong sum); each
// output sums its 16 (tf32: 8) products in order, and scale_d 0 drops the sum
// it held.  A tf32 operand is read as the f32 word it is stored in with its 13
// low mantissa bits dropped, as the hardware truncates them, so a hi half
// that was not rounded before it was stored shows as a wrong sum;
// tf32_rna rounds to nearest, ties away from zero, as cvt.rna.  The s8
// products read int8 operands (K-major only, as PTX has them) and sum in
// int32, exactly: float sums of int8 products would stop being exact past 2^24.  It checks a
// kernel's tiling against that reading of the hardware, not the hardware
// itself.

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

constexpr int MAX_GRID_YZ = 65535;

inline uint32_t smem_addr(const void* p) {
  return (uint32_t)((const char*)p - (const char*)emu_shared);
}

// mma.sync m16n8k8 f64: the warp's A and B fragments by shuffles (a double as two words), then each lane's four
// sums of eight products in float64
inline double emu_shfl_f64(double v, int src) {
  uint64_t u;
  memcpy(&u, &v, 8);
  const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)u, src);
  const uint32_t hi = __shfl_sync(0xffffffffu, (uint32_t)(u >> 32), src);
  u = ((uint64_t)hi << 32) | lo;
  memcpy(&v, &u, 8);
  return v;
}
inline void dmma_m16n8k8(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
  double av[2][8], bv[2][8];  // A[g + 8 h][k] and B[k][2 t + i]
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 8; ++k) av[h][k] = emu_shfl_f64(a[h + 2 * (k / 4)], 4 * g + k % 4);
  for (int i = 0; i < 2; ++i)
    for (int k = 0; k < 8; ++k) bv[i][k] = emu_shfl_f64(b[k / 4], 4 * (2 * t + i) + k % 4);
  for (int h = 0; h < 2; ++h)
    for (int i = 0; i < 2; ++i)
      for (int k = 0; k < 8; ++k) d[2 * h + i] = fma(av[h][k], bv[i][k], d[2 * h + i]);
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
inline void cp_async4(uint32_t dst, const void* src, bool valid) {
  if (dst % 4 || dst + 4 > EMU_MAX_SHARED) abort();
  emu_copies.open.push_back([=] {
    if (valid)
      memcpy((char*)emu_shared + dst, src, 4);
    else
      memset((char*)emu_shared + dst, 0, 4);
  });
}
inline void cp_async_commit() { emu_copies.commit(); }
template <int N> inline void cp_async_wait() { emu_copies.wait(N); }
inline void fence_proxy_async() {}

inline void wgmma_fence() {}
inline void wgmma_commit() { emu_products.commit(); }
template <int N> inline void wgmma_wait() {
  emu_products.wait(N);
  emu_warp_barriers[threadIdx.x >> 5]->arrive_and_wait();  // see emu_wgmma_rs
}
template <int N> inline void fence_sums(float (&)[N]) {}
template <int N> inline void fence_sums(int (&)[N]) {}

inline uint64_t emu_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}
inline uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) { return emu_desc(addr, lbo, sbo, 1); }
inline uint64_t sw64_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) { return emu_desc(addr, lbo, sbo, 2); }

inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

inline float emu_bits_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline float tf32_rna(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;  // to nearest, ties away; inf, NaN kept
  return emu_bits_float(u);
}

// Element (mn, k) of a shared operand: K-major (rows of mn, k along the row)
// or MN-major (rows of k, mn along the row), in the descriptor's swizzle; bf16,
// or tf32 (4 bytes, the 13 low mantissa bits dropped).
inline float emu_operand(uint64_t desc, int mn, int k, bool k_major, bool tf32 = false) {
  const uint64_t layout = desc >> 62;
  if (layout != 1 && layout != 2) abort();  // the 128- and the 64-byte swizzle only
  const uint32_t row_bytes = layout == 1 ? 128 : 64;
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4, lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4,
                 sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  const uint32_t size = tf32 ? 4 : 2;
  uint32_t addr;
  if (k_major) {  // rows of mn, groups of 8 rows SBO apart; a step of k moves the start inside the row
    addr = start + (mn / 8) * sbo + (mn % 8) * row_bytes + k * size;
  } else {  // rows of k, groups of 8 k SBO apart; blocks of row_bytes / size columns of mn LBO apart
    if (tf32) abort();  // PTX has no MN-major tf32 operand
    const int width = (int)row_bytes / 2;
    addr = start + (mn / width) * lbo + (k / 8) * sbo + (k % 8) * row_bytes + (mn % width) * 2;
  }
  addr ^= ((addr >> 7) & (layout == 1 ? 7 : 3)) << 4;
  if (addr + size > EMU_MAX_SHARED) abort();
  if (tf32) {
    uint32_t u;
    memcpy(&u, (const char*)emu_shared + addr, 4);
    return emu_bits_float(u & 0xffffe000u);
  }
  __nv_bfloat16 v;
  memcpy(&v, (const char*)emu_shared + addr, 2);
  return __bfloat162float(v);
}

// Queues d[4 j + 2 h + e] (+)= sum over k < K of A(16 w + l / 4 + 8 h, k) B(k, 8 j + 2 (l % 4) + e), j < N / 8, for
// this thread (32 w + l of its warpgroup); a(row, k) and b(k, col) read the operands when the product runs, and
// scale_d 0 overwrites d then.
template <int N, int K = 16, typename FA, typename FB> inline void emu_wgmma(float* d, FA a, FB b, int scale_d = 1) {
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
  emu_products.open.push_back([=] {
    for (int j = 0; j < N / 8; ++j)
      for (int h = 0; h < 2; ++h)
        for (int e = 0; e < 2; ++e) {
          const int row = 16 * w + l / 4 + 8 * h, col = 8 * j + 2 * (l % 4) + e;
          float sum = 0.0f;
          for (int k = 0; k < K; ++k) sum += a(row, k) * b(k, col);
          d[4 * j + 2 * h + e] = (scale_d ? d[4 * j + 2 * h + e] : 0.0f) + sum;
        }
  });
}

inline void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t a, uint64_t b) {
  emu_wgmma<128>(d, [=](int row, int k) { return emu_operand(a, row, k, true); },
                 [=](int k, int col) { return emu_operand(b, col, k, false); });
}

inline void wgmma_m64n64k16_ss_kk(float (&d)[32], uint64_t a, uint64_t b) {
  emu_wgmma<64>(d, [=](int row, int k) { return emu_operand(a, row, k, true); },
                [=](int k, int col) { return emu_operand(b, col, k, true); });
}

// A and B both MN-major (the transpose flags of the 16-bit types)
inline void wgmma_m64n128k16_bf16_tt(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  emu_wgmma<128>(d, [=](int row, int k) { return emu_operand(a, row, k, false); },
                 [=](int k, int col) { return emu_operand(b, col, k, false); }, scale_d);
}
inline void wgmma_m64n64k16_bf16_tt(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  emu_wgmma<64>(d, [=](int row, int k) { return emu_operand(a, row, k, false); },
                [=](int k, int col) { return emu_operand(b, col, k, false); }, scale_d);
}

// A from registers: each thread publishes where its four registers live; a product reads, for its two rows, the
// registers of the four threads of its warp that hold them (lanes 4 (l / 4) .. + 3), when it runs.  The wait
// that runs it ends with a barrier of the warp (emu_rs_wait), so no thread writes its registers again before
// every product that reads them has run.
inline const uint32_t* emu_a_regs[1024];

template <int N> inline void emu_wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  emu_a_regs[t] = a;
  emu_warp_barriers[warp]->arrive_and_wait();
  const uint32_t* quad[4];
  for (int i = 0; i < 4; ++i) quad[i] = emu_a_regs[32 * warp + 4 * (lane / 4) + i];
  emu_warp_barriers[warp]->arrive_and_wait();
  emu_wgmma<N>(d,
               [=](int row, int k) {
                 // register r of lane 4 g + i: rows g (r even) or g + 8 (r odd), columns 2 i + 8 (r >= 2) and + 1
                 const int reg = ((row % 16) >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0), i = (k % 8) / 2;
                 const uint32_t u = quad[i][reg];
                 __nv_bfloat16 v;
                 v.bits = (uint16_t)(k % 2 ? u >> 16 : u & 0xFFFF);
                 return __bfloat162float(v);
               },
               [=](int k, int col) { return emu_operand(b, col, k, false); });
}

// tf32 A from registers: register r of lane 4 g + i holds row g (+ 8 where r is odd), column i (+ 4 where r >= 2),
// one f32 word, read with its 13 low mantissa bits dropped
template <int N> inline void emu_wgmma_rs_tf32(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  emu_a_regs[t] = a;
  emu_warp_barriers[warp]->arrive_and_wait();
  const uint32_t* quad[4];
  for (int i = 0; i < 4; ++i) quad[i] = emu_a_regs[32 * warp + 4 * (lane / 4) + i];
  emu_warp_barriers[warp]->arrive_and_wait();
  emu_wgmma<N, 8>(d,
                  [=](int row, int k) {
                    const int reg = ((row % 16) >= 8 ? 1 : 0) + (k >= 4 ? 2 : 0);
                    return emu_bits_float(quad[k % 4][reg] & 0xffffe000u);
                  },
                  [=](int k, int col) { return emu_operand(b, col, k, true, true); }, scale_d);
}

inline void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a, uint64_t b) { emu_wgmma_rs<64>(d, a, b); }
inline void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t* a, uint64_t b, int scale_d) {
  emu_wgmma_rs_tf32<128>(d, a, b, scale_d);
}
inline void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t* a, uint64_t b, int scale_d) {
  emu_wgmma_rs_tf32<64>(d, a, b, scale_d);
}
inline void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t* a, uint64_t b, int scale_d) {
  emu_wgmma_rs_tf32<32>(d, a, b, scale_d);
}
inline void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t* a, uint64_t b) { emu_wgmma_rs<32>(d, a, b); }

// Element (mn, k) of a K-major int8 operand in the descriptor's swizzle (a 128-byte row holds 128 k).
inline int emu_operand_s8(uint64_t desc, int mn, int k) {
  const uint64_t layout = desc >> 62;
  if (layout != 1 && layout != 2) abort();
  const uint32_t row_bytes = layout == 1 ? 128 : 64;
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4, sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  uint32_t addr = start + (mn / 8) * sbo + (mn % 8) * row_bytes + k;
  addr ^= ((addr >> 7) & (layout == 1 ? 7 : 3)) << 4;
  if (addr + 1 > EMU_MAX_SHARED) abort();
  int8_t v;
  memcpy(&v, (const char*)emu_shared + addr, 1);
  return v;
}

// d[64] (+)= A (64 x 32, K-major) . B (32 x 128, K-major), int8 into int32 sums, in the layout of emu_wgmma
inline void wgmma_m64n128k32_s8(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
  int* out = d;
  emu_products.open.push_back([=] {
    for (int j = 0; j < 16; ++j)
      for (int h = 0; h < 2; ++h)
        for (int e = 0; e < 2; ++e) {
          const int row = 16 * w + l / 4 + 8 * h, col = 8 * j + 2 * (l % 4) + e;
          int sum = 0;
          for (int k = 0; k < 32; ++k) sum += emu_operand_s8(a, row, k) * emu_operand_s8(b, col, k);
          out[4 * j + 2 * h + e] = (scale_d ? out[4 * j + 2 * h + e] : 0) + sum;
        }
  });
}

}  // namespace cvt
