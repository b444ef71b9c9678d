// The bf16 attention core on Hopper's tensor cores (wgmma through
// hopper.cuh): softmax(scale * Q K^T) V per head at head dims 16, 64 and 80,
// for attention.cuh's dispatcher, which sends every bf16 core here.  Included
// by attention.cuh after its type helpers (to_f32, core_out), and by nothing
// else.
//
// It replaces the Pallas TPU kernels flash_attention.py:_fwd_pallas :56
// (flash_mha), transformer_block.py:_attn_fwd_pallas :237 (attention_block)
// and the core of int8_transformer.py:attention_block_int8 :163, in bf16.
//
// Bound.  At ViT-B/16 batch 256 (S 197, 12 heads of 64) the core reads q, k
// and v out of the (N S, 3 D) bf16 buffer, 232 MB, and writes 77 MB of joined
// heads: 0.093 ms at the memory rate, against 31 GFLOP of products, 0.031 ms
// at the bf16 rate; at ViT-H/14 batch 64 (S 257, 16 heads of 80) 168 MB
// against 21.6 GFLOP, 0.050 against 0.022 ms.  Bytes bind it; the scalar core
// (attention.cuh) ran at 22x that bound on f32 FMAs out of f32-widened
// shared memory.
//
// Design.  One warpgroup (128 threads) a block owns ATC_BQ = 64 query rows of
// one head of one image (grid: query tiles x heads x images, as the scalar
// core) and streams the keys in tiles of 64 with an online softmax:
//   staging  the Q tile once, the K and V tiles through a ring of ATC_STAGES
//            stages, all by cp.async straight out of the strided buffer (a
//            head's row is HD / 8 contiguous 16-byte chunks), zero-filled past
//            S; no transposed copy of K or V.  A tile of 64 rows is laid as
//            its head dims 0-63 in the 128-byte swizzle (rows of 64 bf16),
//            then, for the 16 head dims past a multiple of 64 (hd 16, 80), a
//            part of rows of 16 bf16 in the 32-byte swizzle: one swizzle
//            width cannot hold a row of 80 bf16 (160 bytes), and zero padding
//            to 96 or 128 would add 20-60% of product work.  Each part is a
//            wgmma operand of its own;
//   S        a wgmma m64n64k16 a k16 step of the head dims (four over the
//            wide part, one over the narrow one), A = Q and B = the K tile,
//            both K-major in shared memory, into 32 f32 sums a thread: thread
//            32 w + l holds rows 16 w + l / 4 and + 8, keys 8 j + 2 (l % 4) + e;
//   softmax  keys >= S set to -inf (zero fill gives them score 0, not
//            -inf), scale, the row maximum and sum over the quad of threads
//            that share a row (two shuffles), alpha = exp(m_old - m_new);
//            l sums the unrounded p, p is rounded to bf16 before P V and not
//            normalised (the division by l comes at the end), as the scalar
//            core does;
//   P V      the 32 sums, packed as bf16 pairs, are register for register the
//            A fragments of four k16 steps: a wgmma m64n64k16 (wide part) and
//            an m64n16k16 (narrow part) a step with A from registers and B =
//            the V tile, MN-major, into HD / 2 f32 sums of O, rescaled by
//            alpha first;
//   out      O / l, core_out<OutT> (bf16, or int8 through o_inv), pairs of
//            adjacent columns; rows >= S are computed on zeros, not stored.
// The ring's next tile is copied while the current one is multiplied; no
// atomics, so every call gives the same bits.  A ring of 2 stages beat 3,
// and two warpgroups a block sharing the K and V tiles gained nothing
// (tools/torch_attention_core_ab.py, hd 64).

#pragma once

#include "hopper.cuh"

namespace cvt {

constexpr int ATC_BQ = 64;       // query rows a block: one warpgroup
constexpr int ATC_BK = 64;       // keys a tile
constexpr int ATC_STAGES = 2;    // K and V tiles in flight
constexpr int ATC_THREADS = 128;

// A 64-row tile of head dim HD: the wide part (head dims 0-63, 128-byte swizzle) at 0, the narrow part (the 16 head
// dims past it, 32-byte swizzle) after it; each part starts 1024-byte aligned when the tile does.
template <int HD>
struct AtcTile {
  static_assert(HD == 16 || HD == 64 || HD == 80, "head dims 16, 64 and 80");
  static constexpr int WIDE = HD >= 64 ? 64 : 0;  // head dims in the wide part
  static constexpr int NARROW = HD - WIDE;        // 0 or 16
  static constexpr int WIDE_BYTES = 64 * 2 * WIDE;
  static constexpr int BYTES = 64 * 2 * HD;
  static constexpr size_t SMEM = (size_t)(1 + 2 * ATC_STAGES) * BYTES + 1024;  // Q, the ring; + room to align

  // byte offset of 16-byte chunk c (head dims 8 c .. 8 c + 7) of row r
  static __device__ __forceinline__ int at(int r, int c) {
    const int wide = r * 128 + ((c ^ (r & 7)) << 4), narrow = r * 32 + (((c - WIDE / 8) ^ ((r >> 2) & 1)) << 4);
    if constexpr (NARROW == 0)
      return wide;
    else if constexpr (WIDE == 0)
      return narrow;
    else
      return c < WIDE / 8 ? wide : WIDE_BYTES + narrow;
  }
};

// two adjacent outputs of the core
__device__ __forceinline__ void core_out2(__nv_bfloat16* p, float v0, float v1, const float*, int) {
  __nv_bfloat162 v;
  v.x = from_f32<__nv_bfloat16>(v0);
  v.y = from_f32<__nv_bfloat16>(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}
__device__ __forceinline__ void core_out2(int8_t* p, float v0, float v1, const float* o_inv, int c) {
  p[0] = core_out<int8_t>(v0, o_inv, c);
  p[1] = core_out<int8_t>(v1, o_inv, c + 1);
}

template <int HD, typename OutT>
__global__ void __launch_bounds__(ATC_THREADS)
attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, OutT* __restrict__ o, int s_len, float scale, long long in_n,
                    long long in_s, long long in_h, long long o_n, long long o_s, long long o_h,
                    const float* __restrict__ o_inv) {
  using Tile = AtcTile<HD>;
  constexpr int WIDE = Tile::WIDE, NARROW = Tile::NARROW, TILE = Tile::BYTES, CHUNKS = HD / 8;
  extern __shared__ __align__(16) float smem[];
  const uint32_t s_q = (smem_addr(smem) + 1023u) & ~1023u;  // stage st: K at s_q + (1 + 2 st) TILE, V after it
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * ATC_BQ;
  const long long in_base = (long long)blockIdx.z * in_n + (long long)blockIdx.y * in_h;
  const __nv_bfloat16* qb = q + in_base;
  const __nv_bfloat16* kb = k + in_base;
  const __nv_bfloat16* vb = v + in_base;
  const int k_tiles = (s_len + ATC_BK - 1) / ATC_BK;

  // rows r0.. of src (stride in_s) as a tile at dst, chunk c of row r at Tile::at(r, c)
  auto load_tile = [&](uint32_t dst, const __nv_bfloat16* src, int r0) {
#pragma unroll
    for (int i = 0; i < 64 * CHUNKS / ATC_THREADS; ++i) {
      const unsigned e = tid + i * ATC_THREADS;
      const int r = e / CHUNKS, c = e % CHUNKS;
      const bool ok = r0 + r < s_len;
      cp_async16(dst + Tile::at(r, c), src + (ok ? (long long)(r0 + r) * in_s + c * 8 : 0), ok);
    }
  };
  auto load_kv = [&](int stage, int kt) {
    const uint32_t sk = s_q + (1 + 2 * stage) * TILE;
    load_tile(sk, kb, kt * ATC_BK);
    load_tile(sk + TILE, vb, kt * ATC_BK);
  };

  // the ring runs ATC_STAGES - 1 tiles ahead of the products; the stage a step
  // refills held the tile of the step before, whose products the wait that
  // closed that step retired (the barrier orders every thread after it)
  constexpr int AHEAD = ATC_STAGES - 1;
  load_tile(s_q, qb, q0);
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < k_tiles) load_kv(s, s);
    cp_async_commit();
  }

  // O's sums: acc_w[4 j + 2 h + e] head dim 8 j + 2 (l % 4) + e (j < 8), acc_n the 16 past WIDE (j < 2)
  float acc_w[WIDE ? 32 : 1], acc_n[NARROW ? 8 : 1], m_run[2], l_run[2];
#pragma unroll
  for (int i = 0; i < (WIDE ? 32 : 1); ++i) acc_w[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (NARROW ? 8 : 1); ++i) acc_n[i] = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_run[h] = -INFINITY;
    l_run[h] = 0.0f;
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (kt + AHEAD < k_tiles) load_kv((kt + AHEAD) % ATC_STAGES, kt + AHEAD);
    cp_async_commit();
    const uint32_t sk = s_q + (1 + 2 * (kt % ATC_STAGES)) * TILE, sv = sk + TILE;

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < WIDE / 16; ++s)
      wgmma_m64n64k16_ss_kk(sc, sw128_desc(s_q + s * 32, 16, 1024), sw128_desc(sk + s * 32, 16, 1024));
    if constexpr (NARROW > 0)
      wgmma_m64n64k16_ss_kk(sc, sw32_desc(s_q + Tile::WIDE_BYTES, 16, 256), sw32_desc(sk + Tile::WIDE_BYTES, 16, 256));
    wgmma_commit();
    wgmma_wait<0>();
    fence_sums(sc);

    // key kt * 64 is always real, so each row's maximum is finite; exp(-inf - m) = 0 on the first tile
    const int key0 = kt * ATC_BK + 2 * (lane & 3);
    float m_new[2], alpha[2], sum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& val = sc[4 * j + 2 * h + e];
          val = key0 + 8 * j + e < s_len ? val * scale : -INFINITY;
          mx = fmaxf(mx, val);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[h] = fmaxf(m_run[h], mx);
      alpha[h] = expf(m_run[h] - m_new[h]);
      sum[h] = 0.0f;
    }
    uint32_t pa[16];  // pa[i] = bf16 (p[2 i], p[2 i + 1]): the A fragment of k16 step s is pa[4 s .. 4 s + 3]
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int h = i & 1;
      const float p0 = expf(sc[2 * i] - m_new[h]), p1 = expf(sc[2 * i + 1] - m_new[h]);
      sum[h] += p0;
      sum[h] += p1;
      pa[i] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
      m_run[h] = m_new[h];
    }
    if constexpr (WIDE > 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_w[i] *= alpha[(i >> 1) & 1];
    }
    if constexpr (NARROW > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc_n[i] *= alpha[(i >> 1) & 1];
    }

    wgmma_fence();  // after writing pa and O's sums, before the products read them
#pragma unroll
    for (int s = 0; s < ATC_BK / 16; ++s) {
      if constexpr (WIDE > 0) wgmma_m64n64k16_rs(acc_w, pa + 4 * s, sw128_desc(sv + s * 2048, 8192, 1024));
      if constexpr (NARROW > 0)
        wgmma_m64n16k16_rs(acc_n, pa + 4 * s, sw32_desc(sv + Tile::WIDE_BYTES + s * 512, 2048, 256));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_sums(acc_w);
    fence_sums(acc_n);
  }

  OutT* ob = o + (long long)blockIdx.z * o_n + (long long)blockIdx.y * o_h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * h;
    if (row >= s_len) continue;
    const float inv = 1.0f / l_run[h];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const int i = j < WIDE / 8 ? 4 * j + 2 * h : 4 * (j - WIDE / 8) + 2 * h;
      const float v0 = j < WIDE / 8 ? acc_w[i] : acc_n[i], v1 = j < WIDE / 8 ? acc_w[i + 1] : acc_n[i + 1];
      core_out2(ob + (long long)row * o_s + col, v0 * inv, v1 * inv, o_inv, blockIdx.y * HD + col);
    }
  }
}

// q, k, v and the strides in, 16-byte aligned (cp.async copies 16 bytes); o_s
// even (pairs of outputs)
template <int HD, typename OutT>
cudaError_t launch_attention_tc(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, OutT* o, int n,
                                int s_len, int heads, float scale, long long in_n, long long in_s, long long in_h,
                                long long o_n, long long o_s, long long o_h, cudaStream_t stream, const float* o_inv) {
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  if (bases % 16 || in_n % 8 || in_s % 8 || in_h % 8 || o_s % 2 || o_n % 2 || o_h % 2) return cudaErrorInvalidValue;
  constexpr size_t smem = AtcTile<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(attention_tc_kernel<HD, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + ATC_BQ - 1) / ATC_BQ, heads, n);
  attention_tc_kernel<HD, OutT><<<grid, ATC_THREADS, smem, stream>>>(q, k, v, o, s_len, scale, in_n, in_s, in_h, o_n,
                                                                     o_s, o_h, o_inv);
  return cudaGetLastError();
}

}  // namespace cvt
