// The float32 attention core on Hopper's tensor cores by split TF32 (3xTF32,
// tf32x3.cuh): softmax(scale * Q K^T) V per head at head dim 64, for
// attention.cuh's dispatcher, which sends float32 at head dim 64 (with a
// float32 output) here.  Included by attention.cuh after tc_attention.cuh.
//
// It replaces, for that type and width, the same Pallas TPU kernels as the
// scalar attention_core_kernel: flash_attention.py:_fwd_pallas :56
// (flash_mha) and transformer_block.py:_attn_fwd_pallas :237 (the core of
// attention_block).  The JAX kernels multiply in f32; this core multiplies
// split TF32, three tf32 products a product (tf32x3.cuh: a = a_hi + a_lo, the
// product a_hi b_hi + a_hi b_lo + a_lo b_hi), held to the float64 result no
// further than twice the scalar core it replaces.
//
// Bound.  At ViT-B/16 f32 batch 64 (S 197, 12 heads) the core reads q, k and
// v and writes the heads, 155 MB: 0.046 ms at the memory rate, against 7.78
// GFLOP of f32 products, 0.047 ms at 165 TFLOP/s (495 / 3; an H100 SXM's
// published 3.35 TB/s and 495 TFLOP/s of tf32).  The scalar core
// ran its products as f32 FMAs out of shared memory, bound at 0.116 ms by the
// 67 TFLOP/s of those units and measured at 0.53 ms (NVIDIA H100 80GB HBM3,
// 700 W).
//
// Design.  One warpgroup (128 threads) a block owns AX_BQ = 64 query rows of
// one head of one image (grid: query tiles x heads x images) and streams the
// keys in tiles of AX_BK = 32 with an online softmax, as the bf16 core does:
//   Q        copied once (cp.async) into shared memory as it lies, K-major in
//            the 128-byte swizzle, two halves of 32 head dims, and read back
//            as this thread's tf32 A fragments of the eight k8 steps, split
//            hi and lo in registers (64 registers for the whole block);
//   K, V     a ring of two raw stages (cp.async, zero past S), each thread
//            splitting the chunks it copied into one split tile: K hi and lo
//            K-major as they lie (keys x head dims: B of S = Q K^T); V
//            transposed while it is split (tf32 wgmma reads shared operands
//            K-major only), V^T hi and lo as rows of head dims, keys along the
//            row, with the keys of each group of 8 permuted (below);
//   S        24 wgmma m64n32k8 (8 k8 steps x 3), summed as two chains of 12
//            (head dims 0-31 and 32-63, each from a zero sum) added in
//            registers: no chain of the tensor cores' own rounding is longer
//            than the twelve that tf32x3.cuh's promotion allows;
//   softmax  keys >= S at -inf, scale, the row maximum and sum over the quad
//            that shares a row, alpha = exp(m_old - m_new), p = exp(s - m)
//            unrounded (l sums it; the division by l comes at the end);
//   P V      12 wgmma m64n64k8 (4 k8 steps x 3) with P as A from registers,
//            split hi and lo, into a zero sum, then O = O alpha + PV in
//            registers (the chain of twelve again).
// The P fragment.  The m64k8 tf32 A fragment holds columns t and t + 4 of
// each group of 8 (t = lane % 4); the sums of S hold columns 2 t and 2 t + 1.
// Rather than stage P through shared memory (a store, a barrier and a load a
// tile, and 16 KB more a block), the keys of each group of 8 are taken in the
// order 0 2 4 6 1 3 5 7 by the P V product: A's column t is key 2 t and column
// t + 4 key 2 t + 1, which this thread holds, and V^T's column c is staged
// from key 2 c (c < 4) or 2 (c - 4) + 1, a permutation applied for free while
// V is transposed.
// A step: start the copy of the next raw stage, wait for this one, split this
// thread's chunks, a barrier, S, softmax, P V, a barrier (the split tile is
// overwritten next step).  81 KB of shared memory a block: two blocks an SM.
// No atomics: every call gives the same bits.  Measured at that shape: 0.217
// ms against the scalar core's 0.533 and SDPA f32's 0.414, its float64 error
// 7.8e-7 against the scalar core's 8.0e-7 (chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700 W).

#pragma once

#include "tf32x3.cuh"

namespace cvt {

constexpr int AX_BQ = 64;         // query rows a block: one warpgroup
constexpr int AX_BK = 32;         // keys a tile
constexpr int AX_HD = 64;         // head dim
constexpr int AX_THREADS = 128;
constexpr int AX_HALF = AX_BQ * 128;      // bytes of Q's raw half: 64 rows x 32 head dims of f32
constexpr int AX_K_HALF = AX_BK * 128;    // bytes of a K half: 32 keys x 32 head dims
constexpr int AX_V_BYTES = AX_HD * 128;   // bytes of V^T (64 head dims x 32 keys), or of a raw V stage
constexpr int AX_RAW = 2 * AX_K_HALF + AX_V_BYTES;  // a raw stage: K's two halves, then V as it lies
// shared memory: Q's raw halves, two raw stages, the split tile (K hi, K lo, V^T hi, V^T lo); + room to align
constexpr int AX_SPLIT = 2 * (2 * AX_K_HALF) + 2 * AX_V_BYTES;
constexpr size_t AX_SMEM = 2 * (size_t)AX_HALF + 2 * (size_t)AX_RAW + AX_SPLIT + 1024;

using AxRawQ = X3RawA<true, AX_BQ, AX_THREADS>;  // a half of Q: 64 rows x 32 head dims, K-major
using AxRawK = X3RawA<true, AX_BK, AX_THREADS>;  // a half of K: 32 keys x 32 head dims, K-major
using AxRawV = X3RawB<AX_HD, AX_THREADS>;        // V: 32 keys (rows of k) x 64 head dims

template <typename OutT>
__global__ void __launch_bounds__(AX_THREADS)
attention_x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    OutT* __restrict__ o, int s_len, float scale, long long in_n, long long in_s, long long in_h,
                    long long o_n, long long o_s, long long o_h) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  char* const tiles = reinterpret_cast<char*>(smem) + (base - smem_addr(smem));
  // Q's halves at base, the raw stages after them, then the split tile
  const uint32_t raw0 = base + 2 * AX_HALF, split = raw0 + 2 * AX_RAW;
  const uint32_t k_hi = split, k_lo = k_hi + 2 * AX_K_HALF, v_hi = k_lo + 2 * AX_K_HALF, v_lo = v_hi + AX_V_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AX_BQ, k_tiles = (s_len + AX_BK - 1) / AX_BK;
  const long long in_base = (long long)blockIdx.z * in_n + (long long)blockIdx.y * in_h;
  const float* const qb = q + in_base;
  const float* const kb = k + in_base;
  const float* const vb = v + in_base;
  const int ld = (int)in_s;

  auto copy_raw = [&](int kt) {
    const uint32_t raw = raw0 + (kt & 1) * AX_RAW;
    const int key0 = kt * AX_BK;
    AxRawK::copy(raw, kb, ld, key0, s_len, 0, AX_HD);
    AxRawK::copy(raw + AX_K_HALF, kb, ld, key0, s_len, AX_HD / 2, AX_HD);
    AxRawV::copy(raw + 2 * AX_K_HALF, vb, ld, 0, AX_HD, key0, s_len);
  };
  // this thread's chunks of raw stage kt, split into the split tile: K in place, V transposed with its keys permuted
  auto split_raw = [&](int kt) {
    const char* raw = tiles + (raw0 - base) + (kt & 1) * AX_RAW;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < AxRawK::LOADS; ++i) {
        const int e = tid + i * AX_THREADS;
        const int off = half * AX_K_HALF + kmajor_at(e >> 3, (e & 7) * 4);
        const float4 r = *reinterpret_cast<const float4*>(raw + off);
        float4 h, l;
        split_tf32(r.x, h.x, l.x);
        split_tf32(r.y, h.y, l.y);
        split_tf32(r.z, h.z, l.z);
        split_tf32(r.w, h.w, l.w);
        *reinterpret_cast<float4*>(tiles + (k_hi - base) + off) = h;
        *reinterpret_cast<float4*>(tiles + (k_lo - base) + off) = l;
      }
#pragma unroll
    for (int i = 0; i < AxRawV::LOADS; ++i) {
      int n, key;
      AxRawV::at(i, n, key);
      const float4 r = *reinterpret_cast<const float4*>(raw + 2 * AX_K_HALF + (i * AX_THREADS + tid) * 16);
      const float vals[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float h, l;
        split_tf32(vals[c], h, l);
        const int at = kmajor_at(n + c, ax_key_column(key));
        *reinterpret_cast<float*>(tiles + (v_hi - base) + at) = h;
        *reinterpret_cast<float*>(tiles + (v_lo - base) + at) = l;
      }
    }
  };

  AxRawQ::copy(base, qb, ld, q0, s_len, 0, AX_HD);
  AxRawQ::copy(base + AX_HALF, qb, ld, q0, s_len, AX_HD / 2, AX_HD);
  copy_raw(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // this thread's A fragments of Q for the eight k8 steps over the head dims, split
  uint32_t q_hi[AX_HD / 8][4], q_lo[AX_HD / 8][4];
#pragma unroll
  for (int kk = 0; kk < AX_HD / 8; ++kk) AxRawQ::fragment(tiles + (kk / 4) * AX_HALF, 0, kk % 4, q_hi[kk], q_lo[kk]);

  float o_acc[32], m_run[2], l_run[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_run[h] = -INFINITY;
    l_run[h] = 0.0f;
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    // the raw stage refilled here held tile kt - 1, whose chunks this thread split at the step before
    if (kt + 1 < k_tiles) copy_raw(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    split_raw(kt);  // the products of kt - 1 that read the split tile retired before the barrier that closed it
    fence_proxy_async();
    __syncthreads();

    // S over head dims 0-31 and 32-63, two chains of 12 products from zero sums
    float sa[16], sb[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32(sa, q_lo[kk], k_hi + kk * 32, kk > 0);
      wgmma_tf32(sa, q_hi[kk], k_lo + kk * 32, 1);
      wgmma_tf32(sa, q_hi[kk], k_hi + kk * 32, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32(sb, q_lo[4 + kk], k_hi + AX_K_HALF + kk * 32, kk > 0);
      wgmma_tf32(sb, q_hi[4 + kk], k_lo + AX_K_HALF + kk * 32, 1);
      wgmma_tf32(sb, q_hi[4 + kk], k_hi + AX_K_HALF + kk * 32, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_sums(sa);
    fence_sums(sb);
    keep_fragments(q_hi, q_lo);

    // sa[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h, key kt * 32 + 8 j + 2 (lane % 4) + e; key kt * 32 is always
    // real, so each row's maximum is finite; exp(-inf - m) = 0 on the first tile
    const int key0 = kt * AX_BK + 2 * (lane & 3);
    float alpha[2], sum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& val = sa[4 * j + 2 * h + e];
          val = key0 + 8 * j + e < s_len ? (val + sb[4 * j + 2 * h + e]) * scale : -INFINITY;
          mx = fmaxf(mx, val);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
      sum[h] = 0.0f;
    }
    // P's A fragment of k8 step j: (row, key 2 t), (row + 8, key 2 t), (row, key 2 t + 1), (row + 8, key 2 t + 1)
    uint32_t p_hi[AX_BK / 8][4], p_lo[AX_BK / 8][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1, e = r >> 1;
        const float p = expf(sa[4 * j + 2 * h + e] - m_run[h]);
        sum[h] += p;
        float hi, lo;
        split_tf32(p, hi, lo);
        p_hi[j][r] = __float_as_uint(hi);
        p_lo[j][r] = __float_as_uint(lo);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
    }

    float pv[32];
    wgmma_fence();  // after writing the fragments, before the products read them
#pragma unroll
    for (int j = 0; j < AX_BK / 8; ++j) {
      wgmma_tf32(pv, p_lo[j], v_hi + j * 32, j > 0);
      wgmma_tf32(pv, p_hi[j], v_lo + j * 32, 1);
      wgmma_tf32(pv, p_hi[j], v_hi + j * 32, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_sums(pv);
    keep_fragments(p_hi, p_lo);
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = o_acc[i] * alpha[(i >> 1) & 1] + pv[i];
    __syncthreads();  // every thread's products retired: the next step may overwrite the split tile
  }

  OutT* ob = o + (long long)blockIdx.z * o_n + (long long)blockIdx.y * o_h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * h;
    if (row >= s_len) continue;
    const float inv = 1.0f / l_run[h];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      ob[(long long)row * o_s + col] = from_f32<OutT>(o_acc[4 * j + 2 * h] * inv);
      ob[(long long)row * o_s + col + 1] = from_f32<OutT>(o_acc[4 * j + 2 * h + 1] * inv);
    }
  }
}

// q, k, v 16-byte aligned and their strides multiples of 4 floats (cp.async copies 16 bytes)
inline cudaError_t launch_attention_x3(const float* q, const float* k, const float* v, float* o, int n, int s_len,
                                       int heads, float scale, long long in_n, long long in_s, long long in_h,
                                       long long o_n, long long o_s, long long o_h, cudaStream_t stream) {
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  if (bases % 16 || in_n % 4 || in_s % 4 || in_h % 4 || in_s > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_x3_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)AX_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + AX_BQ - 1) / AX_BQ, heads, n);
  attention_x3_kernel<float><<<grid, AX_THREADS, AX_SMEM, stream>>>(q, k, v, o, s_len, scale, in_n, in_s, in_h, o_n,
                                                                   o_s, o_h);
  return cudaGetLastError();
}

}  // namespace cvt
