// The few Hopper (sm_90a) instructions the tensor-core kernels are built
// from, each behind one small function: cp.async with zero fill, the
// async-proxy fence, wgmma's fence, commit and wait, the shared-memory matrix
// descriptors of the 128- and 64-byte swizzles, and four forms of
// wgmma.mma_async of bf16 into f32 sums: the product's 64 x 128 x 16 tile of
// ln_gemm.cuh (A K-major, B MN-major, both in shared memory), and the
// attention cores' tiles of tc_attention.cuh and swin_attention.cu, 64 x 64
// x 16 with A and B both K-major in shared memory (S = Q K^T), and 64 x 64 x
// 16 and 64 x 32 x 16 with A from registers and B MN-major (O += P V).
//
// tools/cuda_emu carries a CPU stand-in of this header with the same
// functions (the copies and the products deferred to their waits, the
// descriptors decoded as below), so a kernel's tiling can be rehearsed
// without a card.
//
// The swizzles.  A tile row of 64 bf16 values is 128 bytes, eight 16-byte
// chunks; in each aligned group of eight rows (1024 bytes) chunk c of row r is
// stored at chunk c ^ (r % 8) (layout 1).  A row of 32 bf16 values is 64
// bytes, four chunks; in each aligned group of eight rows (512 bytes) chunk c
// of row r is stored at chunk c ^ (r / 2 % 4) (layout 2).  Both XOR address
// bits 7-9 (7-8) into bits 4-6 (4-5), so the tiles start 1024-byte aligned.
// A descriptor holds the start address, the leading and the stride byte
// offsets (all >> 4) and the layout:
//   K-major operand (rows of k):   SBO = 8 rows, the next group of 8 rows
//                                  (1024 or 512 bytes); LBO unused (1);
//   MN-major operand (rows of n):  SBO = the next group of 8 k rows;
//                                  LBO = the next 64 (32) columns of n.
// A step of 16 k moves a K-major start address by 32 bytes inside the
// swizzled row, an MN-major one by 16 rows.  B is K-major when the
// instruction's transpose flag is 0 (the K tile of S = Q K^T: keys are B's
// columns, each key's head dims one row), MN-major when it is 1 (the
// weights of the product, V of O += P V).
//
// A from registers.  Thread t = 32 w + l of the warpgroup holds four 32-bit
// registers of bf16 pairs, (low, high) half = (column c, c + 1):
//   a[0] = A[16 w + l / 4][2 (l % 4)],      a[1] = A[16 w + l / 4 + 8][2 (l % 4)],
//   a[2] = A[16 w + l / 4][8 + 2 (l % 4)],  a[3] = A[16 w + l / 4 + 8][8 + 2 (l % 4)],
// which is, register for register, the f32 sums of a 64 x N product over 16
// of its columns (below): an attention core's probabilities become the A
// operand of P V where they were computed.  The registers are read
// asynchronously: they stay unchanged until the wait that retires the
// product, and wgmma_fence() comes between writing them and the product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cvt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src (global) to dst (shared), or 16 zero bytes where !valid;
// src must be a readable address either way
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's shared-memory writes before the async proxy's reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// until at most N of the warpgroup's committed groups are in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the sums across a wgmma wait
template <int N> __device__ __forceinline__ void fence_sums(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (2ull << 62);
}

// (lo, hi) rounded to bf16 as one register of an A fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64] += A (64 x 16, K-major, desc a) . B (16 x 128, MN-major, desc b), for
// the 128 threads of a warpgroup.  Thread t = 32 w + l holds, for j < 16,
// d[4 j + 2 h + e] = D[16 w + l / 4 + 8 h][8 j + 2 (l % 4) + e].
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d[32] += A (64 x 16, K-major, desc a) . B (16 x 64, K-major, desc b);
// thread t = 32 w + l holds, for j < 8, d[4 j + 2 h + e] = D[16 w + l / 4 + 8 h][8 j + 2 (l % 4) + e].
__device__ __forceinline__ void wgmma_m64n64k16_ss_kk(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d[32] += A (64 x 16, registers a[0..3]) . B (16 x 64, MN-major, desc b); d as above
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[16] += A (64 x 16, registers a[0..3]) . B (16 x 32, MN-major, desc b); d as above with j < 4
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace cvt
