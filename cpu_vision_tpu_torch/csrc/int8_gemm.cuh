// The int8 product on the int8 tensor cores that every int8 kernel of the port
// runs: int8_matmul.cu (int8_matmul_requant) and int8_transformer.cu
// (mlp_block_int8's and attention_block_int8's projections):
//
//   acc[m, n] = sum_k A[m, k] * B[k, n]      int8 x int8 -> int32, exact
//   out[m, n] = epilogue(acc[m, n])          in f32
//
// i8_tc_gemm_kernel: wgmma m64n128k32 s8 x s8 into int32 sums.  A block of
// two warpgroups owns 128 x 128 outputs, 64 sums a thread; k runs in tiles of
// 128 (one 128-byte swizzled row of int8), four k32 wgmma a tile, copied by
// all threads with cp.async into a ring of 3 stages (97 KB, two blocks an SM).
// 8-bit wgmma takes both operands K-major only: A is row-major (m, k) and B
// comes transposed, bt (n, k), a row of k for each output column.
//
// Domain.  k a multiple of 16 (a 16-byte chunk of a row), any m from 1 (the
// row tiles run on the grid's y, MAX_GRID_YZ a launch), n from 1; every
// row of A and bt starts 16-byte aligned.  Rows past m or n, and the chunks of
// the last k tile past k, are copied as zeros (cp.async's zero fill): a zero
// product adds nothing to an int32 sum, so every stage issues its four wgmma
// with no branch around them (a wgmma under a branch is serialised, ptxas
// C7518).
//
// Epilogues (EPI), on the int32 sum a = float(acc) (__int2float_rn), each the
// f32 operations of the code it replaced, one by one and in that order:
//   Q8_GELU          q(gelu(a * scale[c] + bias[c]), inv[c])       int8   the MLP's up-projection
//   Q8_RESID         resid + (a * scale[c] + bias[c])              T      the MLP's down-projection
//   Q8_AFFINE        a * scale[c] + bias[c]                        T      the attention block's QKV product
//   Q8_ATTN_RESID    (resid + a * scale[c]) + bias[c]              T      the attention block's output product
//   Q8_REQUANT       q(a * scale[c] + bias[c], *inv)               int8   int8_matmul_requant
//   Q8_REQUANT_RELU  q(max(a * scale[c] + bias[c], 0), *inv)       int8
//   Q8_LINEAR        a * scale[c] + bias[c]                        f32    int8_matmul_requant, no output scale
//   Q8_LINEAR_RELU   max(a * scale[c] + bias[c], 0)                f32
// with q(f, inv) = clamp(rint(f * inv), -127, 127), as the TPU kernels'
// _quant.  The two residual orders differ as the TPU kernels' do
// (int8_transformer.py's _mlp_kernel and _attn_kernel): merged, they would
// round differently.  Either way the tile goes through the free ring and out
// 16 bytes a thread: an int8 tile as it is; for T and f32, the f32 partials
// (the steps before the residual), finished where the residual is read 16
// bytes at a time.  Where n is not a multiple of 16 bytes' worth of values,
// the last chunks go out one value at a time.  A block reads its columns'
// scale, bias and inverse scale once into shared memory, where the epilogue
// takes them two columns at a time: read from global memory in the
// epilogue, they cost 7-16% of the call (tools/torch_int8_products_ab.py, in
// turns, on an H100).
//
// Exactness.  Every sum is one int32 sum over the whole k (|acc| <= k * 127^2,
// below 2^31 for k < 133,000), exact in any order.  The sources that include
// this header build with --fmad=false, so no product and sum of an epilogue
// is contracted into one rounding.

#pragma once

#include <stdint.h>

#include "ln_gemm.cuh"

namespace cvt {

// rint(f * inv), then clamp to +-127, as int8: the TPU kernels' _quant.  Clamped first (the same, for integer
// bounds), then rounded to nearest even by adding 1.5 * 2^23, where a float's step is 1: the integer is the low bits
// of the sum's word.  Adds and compares on the FP32 pipe, where rintf and a conversion to int would take the
// conversion pipe (16 results a clock an SM), the limit of an epilogue that writes int8
__device__ __forceinline__ int quant_i8(float f, float inv) {
  return __float_as_int(fminf(fmaxf(f * inv, -127.0f), 127.0f) + 12582912.0f) - 0x4B400000;
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24);
}

enum {
  Q8_GELU = 0,
  Q8_RESID = 1,
  Q8_AFFINE = 2,
  Q8_ATTN_RESID = 3,
  Q8_REQUANT = 4,
  Q8_REQUANT_RELU = 5,
  Q8_LINEAR = 6,
  Q8_LINEAR_RELU = 7
};

template <int EPI>
constexpr bool Q8_INT8_OUT = EPI == Q8_GELU || EPI == Q8_REQUANT || EPI == Q8_REQUANT_RELU;

constexpr int Q8_BM = 128;  // two warpgroups of 64 rows
constexpr int Q8_BN = 128;
constexpr int Q8_BK = 128;  // one 128-byte swizzled row of int8: four k32 steps
constexpr int Q8_KSTEP = 16;  // k is a multiple of this: one 16-byte chunk of a row
constexpr int Q8_STAGES = 3;
constexpr int Q8_AHEAD = Q8_STAGES - 1;  // tiles copied ahead of the products
constexpr int Q8_THREADS = 256;
constexpr int Q8_TILE_BYTES = Q8_BM * Q8_BK;  // the A and the B tile alike
constexpr int Q8_STAGE_BYTES = 2 * Q8_TILE_BYTES;
constexpr size_t Q8_SMEM = (size_t)Q8_STAGES * Q8_STAGE_BYTES + 1024;  // + room to align to 1024
constexpr int Q8_CHUNKS = Q8_TILE_BYTES / 16 / Q8_THREADS;              // 16-byte copies a thread a tile
constexpr int Q8_LDT = Q8_BN + 16;  // row stride of the int8 output tile staged in the ring (no bank conflicts)
constexpr int Q8_LDF = Q8_BN + 8;   // row stride of the f32 partials staged in the ring (no bank conflicts)
static_assert(Q8_BM == Q8_BN && Q8_CHUNKS == 4 && Q8_SMEM <= 113 * 1024 && Q8_BM * Q8_LDT <= Q8_STAGE_BYTES &&
                  Q8_BM * Q8_LDF * 4 <= Q8_STAGES * Q8_STAGE_BYTES,
              "tiles; two blocks an SM; the int8 tile fits a stage, the f32 partials the ring");

template <typename T>
struct Q8Epi {
  const float* scale;  // (n,)
  const float* bias;   // (n,)
  const float* inv;    // Q8_GELU: the output's inverse activation scale (n,); Q8_REQUANT*: one value
  const T* resid;      // Q8_RESID, Q8_ATTN_RESID: (m, n)
  void* out;           // (m, n) of int8 (Q8_GELU, Q8_REQUANT*) or T (T is float for Q8_LINEAR*)
};

// the int8 output of an int8 epilogue, from the sum a, the column's scale and bias and the inverse scale inv
template <int EPI>
__device__ __forceinline__ int q8_int8(int acc, float s, float b, float inv) {
  const float f = __int2float_rn(acc) * s + b;
  if (EPI == Q8_GELU) return quant_i8(gelu_erf(f), inv);
  if (EPI == Q8_REQUANT_RELU) return quant_i8(fmaxf(f, 0.0f), inv);
  return quant_i8(f, inv);
}

// The other epilogues in two steps: q8_partial on the sum, from the sums' fragment, and q8_finish on that partial p
// and the residual x, 16 bytes of output at a time: the f32 operations of the epilogue table, in its order
template <int EPI>
__device__ __forceinline__ float q8_partial(int acc, float s, float b) {
  const float a = __int2float_rn(acc);
  if (EPI == Q8_ATTN_RESID) return a * s;  // + x, then + bias, in q8_finish
  if (EPI == Q8_LINEAR_RELU) return fmaxf(a * s + b, 0.0f);
  return a * s + b;
}
template <int EPI>
__device__ __forceinline__ float q8_finish(float p, float x, const float* bias, int col) {
  if (EPI == Q8_RESID) return x + p;
  if (EPI == Q8_ATTN_RESID) return (x + p) + bias[col];
  return p;
}

// 16 bytes of T as f32 and back (p 16-byte aligned)
__device__ __forceinline__ void load16b(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load16b(const bf16* p, float (&v)[8]) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = to_f32<bf16>(h[e]);
}
__device__ __forceinline__ void store16b(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16b(bf16* p, const float (&v)[8]) {
  int4 raw;
  bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = from_f32<bf16>(v[e]);
  *reinterpret_cast<int4*>(p) = raw;
}

template <int EPI, typename T>
__global__ void __launch_bounds__(Q8_THREADS, 2)
i8_tc_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt, Q8Epi<T> epi, int m, int k, int n,
                  int row_tile0) {
  constexpr bool has_resid = EPI == Q8_RESID || EPI == Q8_ATTN_RESID;
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = (row_tile0 + blockIdx.y) * Q8_BM, n0 = blockIdx.x * Q8_BN;
  const int k_tiles = (k + Q8_BK - 1) / Q8_BK;
  // the epilogue's per-column scale, bias and (Q8_GELU) inverse scale of this tile, read once, visible after the
  // first barrier of the loop
  __shared__ __align__(16) float s_par[3][Q8_BN];
  if (tid < Q8_BN) {
    const int col = n0 + tid;
    const bool in = col < n;
    s_par[0][tid] = in ? epi.scale[col] : 0.0f;
    s_par[1][tid] = in ? epi.bias[col] : 0.0f;
    s_par[2][tid] = in && EPI == Q8_GELU ? epi.inv[col] : 0.0f;
  }

  // both tiles K-major: row r (of m, or of n), chunk c of 16 k at r * 128 + (c ^ r % 8) * 16; a chunk past k,
  // or of a row past m or n, is zero-filled
  auto load = [&](int stage, int kt) {
    const int k0 = kt * Q8_BK;
    const uint32_t sa = base + stage * Q8_STAGE_BYTES, sb = sa + Q8_TILE_BYTES;
#pragma unroll
    for (int i = 0; i < Q8_CHUNKS; ++i) {
      const int e = tid + i * Q8_THREADS;
      const int r = e >> 3, c = e & 7;
      const uint32_t at = r * 128 + ((c ^ (r & 7)) << 4);
      const bool k_ok = k0 + c * 16 < k;
      const bool a_ok = k_ok && m0 + r < m, b_ok = k_ok && n0 + r < n;
      cp_async16(sa + at, a + (a_ok ? (size_t)(m0 + r) * k + k0 + c * 16 : 0), a_ok);
      cp_async16(sb + at, bt + (b_ok ? (size_t)(n0 + r) * k + k0 + c * 16 : 0), b_ok);
    }
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  // the stage a step refills held the tile of the step before, whose products the wait that closed that step
  // retired in both warpgroups (the barrier orders them)
#pragma unroll
  for (int s = 0; s < Q8_AHEAD; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<Q8_AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    const int next = kt + Q8_AHEAD;
    if (next < k_tiles) load(next % Q8_STAGES, next);
    cp_async_commit();
    const uint32_t sa = base + (kt % Q8_STAGES) * Q8_STAGE_BYTES, sb = sa + Q8_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < Q8_BK / 32; ++s)
      wgmma_m64n128k32_s8(acc, sw128_desc(sa + wg * (64 * 128) + s * 32, 16, 1024), sw128_desc(sb + s * 32, 16, 1024),
                          1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_sums(acc);

  // sum 4 j + 2 h + e of this thread is output (t0 + 8 h, j * 8 + (lane % 4) * 2 + e) of the tile
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int t0 = wg * 64 + warp * 16 + (lane >> 2);
  if constexpr (Q8_INT8_OUT<EPI>) {
    // the int8 tile through shared memory (the ring is free: both warpgroups' products have retired, no copy is
    // in flight), then out 16 bytes a thread, eight threads a row
    int8_t* tile = reinterpret_cast<int8_t*>(smem) + (base - smem_addr(smem));
    cp_async_wait<0>();
    __syncthreads();
    const float inv = EPI == Q8_GELU ? 0.0f : *epi.inv;
#pragma unroll
    for (int j = 0; j < Q8_BN / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2, col = n0 + c;
      if (col >= n) continue;
      const float2 sc = *reinterpret_cast<const float2*>(&s_par[0][c]),
                   bb = *reinterpret_cast<const float2*>(&s_par[1][c]);
      const float sc0 = sc.x, b0 = bb.x, sc1 = sc.y, b1 = bb.y;
      const float2 iv = EPI == Q8_GELU ? *reinterpret_cast<const float2*>(&s_par[2][c]) : make_float2(inv, inv);
      const float inv0 = iv.x, inv1 = iv.y;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q0 = q8_int8<EPI>(acc[4 * j + 2 * h], sc0, b0, inv0);
        const int q1 = q8_int8<EPI>(acc[4 * j + 2 * h + 1], sc1, b1, inv1);
        *reinterpret_cast<uint16_t*>(tile + (t0 + 8 * h) * Q8_LDT + c) = (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    }
    __syncthreads();
    int8_t* out = static_cast<int8_t*>(epi.out);
#pragma unroll
    for (int i = 0; i < Q8_CHUNKS; ++i) {
      const int e = tid + i * Q8_THREADS;
      const int r = e >> 3, c = (e & 7) * 16;
      if (m0 + r >= m || n0 + c >= n) continue;
      int8_t* to = out + (size_t)(m0 + r) * n + n0 + c;
      if (n % 16 == 0) {  // every row and chunk 16-byte aligned, the chunk wholly in
        *reinterpret_cast<int4*>(to) = *reinterpret_cast<const int4*>(tile + r * Q8_LDT + c);
      } else {
        for (int b = 0; b < 16 && n0 + c + b < n; ++b) to[b] = tile[r * Q8_LDT + c + b];
      }
    }
    return;
  } else {
    // f32 partial values through shared memory (the epilogue's first steps, which need no residual), then out 16
    // bytes of T a thread, the residual read 16 bytes at a time, the last steps done there
    float* part = reinterpret_cast<float*>(smem) + (base - smem_addr(smem)) / 4;
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < Q8_BN / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2, col = n0 + c;
      if (col >= n) continue;
      const float2 sc = *reinterpret_cast<const float2*>(&s_par[0][c]),
                   bb = *reinterpret_cast<const float2*>(&s_par[1][c]);
      const float sc0 = sc.x, b0 = bb.x, sc1 = sc.y, b1 = bb.y;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (t0 + 8 * h) * Q8_LDF + c) =
            make_float2(q8_partial<EPI>(acc[4 * j + 2 * h], sc0, b0), q8_partial<EPI>(acc[4 * j + 2 * h + 1], sc1, b1));
    }
    __syncthreads();
    constexpr int V = 16 / sizeof(T), ROW_CHUNKS = Q8_BN / V;  // values of T in 16 bytes
    T* out = static_cast<T*>(epi.out);
#pragma unroll 2
    for (int i = 0; i < Q8_BM * ROW_CHUNKS / Q8_THREADS; ++i) {
      const int e = tid + i * Q8_THREADS;
      const int r = e / ROW_CHUNKS, c = e % ROW_CHUNKS * V, row = m0 + r, col = n0 + c;
      if (row >= m || col >= n) continue;
      const float* p = part + r * Q8_LDF + c;
      const size_t at = (size_t)row * n + col;
      if (n % V == 0) {  // every row and chunk 16-byte aligned, the chunk wholly in
        float v[V], x[V];
#pragma unroll
        for (int q = 0; q < V; q += 4) {
          const float4 f = *reinterpret_cast<const float4*>(p + q);
          v[q] = f.x, v[q + 1] = f.y, v[q + 2] = f.z, v[q + 3] = f.w;
        }
        if (has_resid) load16b(epi.resid + at, x);
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = q8_finish<EPI>(v[q], has_resid ? x[q] : 0.0f, s_par[1], c + q);
        store16b(out + at, v);
      } else {
        for (int q = 0; q < V && col + q < n; ++q)
          out[at + q] = from_f32<T>(q8_finish<EPI>(p[q], has_resid ? to_f32<T>(epi.resid[at + q]) : 0.0f, s_par[1],
                                                   c + q));
      }
    }
  }
}

// out = epilogue(a . bt^T) for a (m, k) and bt (n, k) int8 (see the domain above); cudaErrorInvalidValue outside it
template <int EPI, typename T>
cudaError_t launch_i8_tc_gemm(const int8_t* a, const int8_t* bt, const Q8Epi<T>& epi, int m, int k, int n,
                              cudaStream_t stream) {
  const int rows = (m + Q8_BM - 1) / Q8_BM, cols = (n + Q8_BN - 1) / Q8_BN;
  if (m < 1 || n < 1 || k < Q8_KSTEP || k % Q8_KSTEP) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(i8_tc_gemm_kernel<EPI, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q8_SMEM);
  if (err != cudaSuccess) return err;
  for (int r0 = 0; r0 < rows; r0 += MAX_GRID_YZ) {  // row tiles past the grid's y in further launches
    i8_tc_gemm_kernel<EPI, T><<<dim3(cols, min(MAX_GRID_YZ, rows - r0)), Q8_THREADS, Q8_SMEM, stream>>>(a, bt, epi, m,
                                                                                                       k, n, r0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace cvt
