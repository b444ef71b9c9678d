// The backward of the bf16 attention core on Hopper's tensor cores (Kernel B;
// wgmma through hopper.cuh): for softmax(scale * Q K^T) V per head at head
// dim 64 and any S >= 1, given dO, the gradients dQ, dK and dV, and (WITH_O)
// the output O again.  Included by attention.cu alone; the backward of
// flash_mha and of attention_block
// (ops/kernels/flash_attention.py:attention_core_backward) launch it.
//
// It takes the place of the backward of the JAX package's custom_vjp around
// the TPU kernel flash_attention.py:_fwd_pallas :56 (flash_mha :70, _bwd
// :83-96), and of the same core inside attention_block :282 (_attn_bwd), with
// the formulas of _bwd:
//   s = scale q k^T, p = softmax(s) (f32), dv = bf16(p)^T do,
//   dp = bf16(do v^T), ds = tf32(p (dp - sum_k dp p) scale), dq = ds k, dk = ds^T q,
// each gradient summed in f32 and rounded to bf16 once: the rounding points of
// the plain twin (flash_mha_plain) under autograd, whose TF32 products round
// the f32 ds to tf32 (to nearest, cvt.rna here).  A tf32 value is exactly
// hi + lo with hi = bf16(ds) and lo = bf16(ds - hi), so dq and dk take two bf16
// products each, on hi and on lo: the twin's products term for term (one
// bf16 product of ds alone stood up to 5x the card test's tolerance from the
// twin's gradients at ViT-B/16's width; build/diag measurements, PERF.md).
// delta is the twin's sum_k bf16(dp) p, not rowsum(dO o O), which gives
// other bits.  With WITH_O it also writes O = bf16(bf16(p) v), the twin's
// joined heads, which attention_block's weight gradient of its output
// projection needs (the forward core rounds p before the division by the row
// sum, and its heads stood 0.03 of the card test's tolerance off the twin's
// through that product).
//
// Bound.  At ViT-B/16 b128 (S 197, 12 heads) the core backward reads q, k, v
// and do and writes dq, dk, dv and O, 310 MB: 0.0925 ms at the memory rate,
// against 6 S^2 hd products a head with O, 45.8 GFLOP, 0.046 ms at the bf16
// rate (an H100 SXM's published 3.35 TB/s and 989 TFLOP/s).  Bytes bind it.
//
// Design: FlashAttention-2's split by tile, in two launches of one warpgroup
// (128 threads) a block, 64-row tiles in the 128-byte swizzle (zero past S),
// streamed through rings of ABW_STAGES stages by cp.async, so that the next
// tile's copy overlaps the current tile's products; no log-sum-exp is saved
// by the forward, so
//   attention_bwd_q_kernel   a block a (query tile i, head, image), Q_i and
//            dO_i resident, the key tiles K_j, V_j streamed twice:
//            sweep 1  s_ij = Q_i K_j^T and dp_ij = dO_i V_j^T (two groups; the
//                     row maximum m and sum l run on s while dp is in flight),
//                     delta = sum_k bf16(dp) p as a running sum rescaled with
//                     l; m, l, 1 / l and delta of the 64 rows (padding rows
//                     too, finite: their q and do are zero) to the f32
//                     scratch `stats`, 1 KB a tile;
//            sweep 2  s_ij and dp_ij again, p and ds, dQ_i += ds_ij K_j (A from
//                     registers, hi then lo, K_j MN-major) and with WITH_O
//                     O_i += bf16(p_ij) V_j; dQ_i (and O_i) written;
//   attention_bwd_kv_kernel  a block a (key tile j, head, image), K_j, V_j
//            resident, Q_i, dO_i and the stats of tile i streamed: the
//            transposed tiles s^T = K_j Q_i^T and dp^T = V_j dO_i^T, p^T and
//            ds^T from the stats, dV_j += bf16(p^T) dO_i and dK_j += ds^T Q_i
//            with A from registers (the sums of s^T are, register for
//            register, the A fragments, as P of the forward) and dO_i, Q_i
//            MN-major; dK_j and dV_j written once.
// Each step's groups are committed in the order they can retire, and each
// wait leaves the newest group in flight: dp runs while p is computed from
// s, and the dV (or O) product while ds is computed from dp; a step's last
// group (dK, dQ) retires at the next step's first wait, so the ring needs
// a third stage (the stage refilled at step t held tile t - 2).  No S cap.
// Twelve 64 x 64 x 64 products a pair of tiles (thirteen WITH_O) where
// five would do: the price of keeping no S x S tile anywhere, of the hi/lo
// halves of ds, of the statistics the forward does not save, and of no
// atomics (dQ sums over key tiles in its own blocks).  Keys past S get no
// probability, query rows past S are computed on zeros and not stored.  No
// atomics: every call gives the same bits.
//
// What bounds it, measured (tools/torch_flash_kernels_ab.py, NVIDIA H100 80GB
// HBM3, 700 W): latency, not the tensor cores (about a fifth of their rate)
// nor the bytes.  So: three blocks an SM (ABW_BLOCKS: 65 and 68 KB of shared
// memory, at most 168 registers, no spill; two blocks read 0.81 ms, three
// 0.70), p's division by l as one IEEE division a row and Markstein's
// correction an element (the division's bits, 0.93 -> 0.81 ms; __expf
// instead of expf would gain 0.01-0.02 ms and change them), and the
// key-tile blocks' statistics read as pairs (0.70 -> 0.68 ms), at (128, 197,
// 12, 64), where SDPA's backward alone reads 0.34 ms.

#pragma once

#include "attention.cuh"  // over_images_heads
#include "hopper.cuh"

namespace cvt {

constexpr int ABW_T = 64;           // rows of a tile (queries or keys); head dim 64 = one 128-byte row
constexpr int ABW_THREADS = 128;    // one warpgroup a block
constexpr int ABW_STAGES = 3;       // streamed tiles: one in flight while one is read and one retires
constexpr int ABW_BLOCKS = 3;       // blocks an SM: at most 168 registers a thread
constexpr int ABW_TILE = 64 * 128;  // bytes of a 64 x 64 bf16 tile
constexpr int ABW_STATS = 4 * ABW_T;  // floats of a query tile's statistics: m, l, 1 / l, delta of its 64 rows
// query-tile blocks: Q_i, dO_i, then the stages of (K_j, V_j); + room to align
constexpr size_t ABW_Q_SMEM = (size_t)(2 + 2 * ABW_STAGES) * ABW_TILE + 1024;
// key-tile blocks: K_j, V_j, then the stages of (Q_i, dO_i, stats_i), a stage 1024-byte aligned
constexpr int ABW_KV_STAGE = 2 * ABW_TILE + 1024;
constexpr size_t ABW_KV_SMEM = (size_t)2 * ABW_TILE + (size_t)ABW_STAGES * ABW_KV_STAGE + 1024;

// rows r0 .. r0 + 63 of a head (row stride rs, zero past s_len) as a swizzled tile at dst: row r, chunk c of 8
// values at r * 128 + (c ^ r % 8) * 16
__device__ __forceinline__ void abw_load_tile(uint32_t dst, const __nv_bfloat16* src, long long rs, int r0,
                                              int s_len) {
#pragma unroll
  for (int i = 0; i < ABW_T * 8 / ABW_THREADS; ++i) {
    const int e = threadIdx.x + i * ABW_THREADS, r = e >> 3, c = e & 7;
    const bool ok = r0 + r < s_len;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), src + (ok ? (long long)(r0 + r) * rs + c * 8 : 0), ok);
  }
}

// acc += A B^T over the head dims, both 64-row tiles K-major (s = Q K^T, dp = dO V^T and their transposes)
__device__ __forceinline__ void abw_nt(float (&acc)[32], uint32_t ta, uint32_t tb) {
#pragma unroll
  for (int st = 0; st < 4; ++st)
    wgmma_m64n64k16_ss_kk(acc, sw128_desc(ta + st * 32, 16, 1024), sw128_desc(tb + st * 32, 16, 1024));
}

// acc += A B with A the registers a (64 x 64, four k16 steps) and B a 64-row tile MN-major (rows of k)
__device__ __forceinline__ void abw_rn(float (&acc)[32], const uint32_t (&a)[16], uint32_t tb) {
#pragma unroll
  for (int st = 0; st < 4; ++st) wgmma_m64n64k16_rs(acc, a + 4 * st, sw128_desc(tb + st * 2048, 8192, 1024));
}

// acc += (hi + lo) B: the two bf16 halves of tf32 ds, step by step
__device__ __forceinline__ void abw_rn2(float (&acc)[32], const uint32_t (&hi)[16], const uint32_t (&lo)[16],
                                        uint32_t tb) {
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const uint64_t b = sw128_desc(tb + st * 2048, 8192, 1024);
    wgmma_m64n64k16_rs(acc, hi + 4 * st, b);
    wgmma_m64n64k16_rs(acc, lo + 4 * st, b);
  }
}

// p = exp(s scale - m) / l, the quotient to nearest from inv_l = 1 / l (to nearest): q = e inv_l is within an ulp
// of it, r = e - q l exact (an FMA), and q + r inv_l rounds to it (Markstein's correction)
__device__ __forceinline__ float abw_prob(float s, float scale, float m, float l, float inv_l) {
  const float e = expf(s * scale - m), q = e * inv_l;
  return fmaf(fmaf(-q, l, e), inv_l, q);
}

// ds of one pair of columns as the A fragments of its two bf16 halves: t = tf32(ds), hi = bf16(t), lo = t - hi
__device__ __forceinline__ void abw_split(float d0, float d1, uint32_t& hi, uint32_t& lo) {
  const float t0 = tf32_rna(d0), t1 = tf32_rna(d1);
  const float h0 = round_to<__nv_bfloat16>(t0), h1 = round_to<__nv_bfloat16>(t1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(t0 - h0, t1 - h1);
}

template <int N> __device__ __forceinline__ void abw_zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

// a (64 x 64) sum as bf16 pairs to dst (rows below s_len), element (r, c) at dst + r rs + c.  This thread's sums of a
// 64 x 64 product hold rows 16 warp + lane / 4 (+ 8 for h = 1), columns 8 j + 2 (lane % 4) (+ 1 for e = 1) at index
// 4 j + 2 h + e; the pair at 2 x, 2 x + 1 (j = x / 2, h = x % 2) is, packed, A register x
__device__ __forceinline__ void abw_store(const float (&acc)[32], __nv_bfloat16* dst, long long rs, int r0,
                                          int s_len) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * h;
    if (r >= s_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + r * rs + 8 * j + 2 * (lane & 3)) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// The query-tile blocks: the row statistics of tile i (to stats), dQ_i and with WITH_O O_i.  Grid (tiles, heads, n).
template <bool WITH_O>
__global__ void __launch_bounds__(ABW_THREADS, ABW_BLOCKS)
attention_bwd_q_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ o, float* __restrict__ stats,
                       int s_len, float scale, long long in_n, long long in_s, long long in_h, long long o_n,
                       long long o_s, long long o_h, long long p_n, long long p_s, long long p_h) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t t_q = (smem_addr(smem) + 1023u) & ~1023u, t_do = t_q + ABW_TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (s_len + ABW_T - 1) / ABW_T, i0 = blockIdx.x * ABW_T;
  const long long in_base = (long long)blockIdx.z * in_n + (long long)blockIdx.y * in_h;
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);

  // step t of the two sweeps reads key tile t % tiles from stage t % ABW_STAGES: K there, V after it
  auto stage = [&](int t) { return t_q + (uint32_t)(2 + 2 * (t % ABW_STAGES)) * ABW_TILE; };
  auto load_kv = [&](int t) {
    abw_load_tile(stage(t), k + in_base, in_s, t % tiles * ABW_T, s_len);
    abw_load_tile(stage(t) + ABW_TILE, v + in_base, in_s, t % tiles * ABW_T, s_len);
  };
  abw_load_tile(t_q, q + in_base, in_s, i0, s_len);
  abw_load_tile(t_do, dout + (long long)blockIdx.z * o_n + (long long)blockIdx.y * o_h, o_s, i0, s_len);
  load_kv(0);
  cp_async_commit();
  // the stage refilled at step t held tile t - 2, whose last products the first wait of step t - 1 retired (the
  // barrier orders every thread after it)
  auto next_step = [&](int t) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < 2 * tiles) load_kv(t + 1);
    cp_async_commit();
  };

  float sc[32], dp[32];
  auto two_products = [&](uint32_t t_k) {  // s into sc, dp into dp: two groups
    abw_zero(sc);
    abw_zero(dp);
    wgmma_fence();
    abw_nt(sc, t_q, t_k);
    wgmma_commit();
    abw_nt(dp, t_do, t_k + ABW_TILE);
    wgmma_commit();
  };

  // sweep 1: each row's maximum m, sum l of exp(s - m) and delta, the sum of bf16(dp) p over its keys
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f}, d_run[2] = {0.0f, 0.0f};
  for (int t = 0; t < tiles; ++t) {
    next_step(t);
    two_products(stage(t));
    wgmma_wait<1>();  // s
    fence_sums(sc);
    float alpha[2];
    // key t * 64 + 0 is always real, so each row's maximum is finite
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& val = sc[4 * jj + 2 * h + e];
          val = t * ABW_T + 8 * jj + col0 + e < s_len ? val * scale : -INFINITY;
          mx = fmaxf(mx, val);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = expf(m_run[h] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& p = sc[4 * jj + 2 * h + e];
          p = expf(p - m_new);
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * alpha[h] + sum;
      m_run[h] = m_new;
    }
    wgmma_wait<0>();  // dp
    fence_sums(dp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float dsum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) dsum += round_to<__nv_bfloat16>(dp[4 * jj + 2 * h + e]) * sc[4 * jj + 2 * h + e];
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      d_run[h] = d_run[h] * alpha[h] + dsum;
    }
  }
  float delta[2], inv_l[2];
  float* st = stats + (((long long)blockIdx.z * gridDim.y + blockIdx.y) * tiles + blockIdx.x) * ABW_STATS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    delta[h] = d_run[h] / l_run[h];
    inv_l[h] = 1.0f / l_run[h];
    if ((lane & 3) == 0) {
      st[row0 + 8 * h] = m_run[h];
      st[ABW_T + row0 + 8 * h] = l_run[h];
      st[2 * ABW_T + row0 + 8 * h] = inv_l[h];
      st[3 * ABW_T + row0 + 8 * h] = delta[h];
    }
  }

  // sweep 2: dQ (and O) over the key tiles again
  float dq_acc[32], o_acc[WITH_O ? 32 : 1];
  abw_zero(dq_acc);
  abw_zero(o_acc);
  uint32_t pa[16], dh[16], dl[16];
  for (int t = tiles; t < 2 * tiles; ++t) {
    const int j = t - tiles;
    next_step(t);
    const uint32_t t_k = stage(t);
    two_products(t_k);
    wgmma_wait<1>();  // s, and the step before's dQ and O: pa, dh and dl are free
    fence_sums(sc);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int h = x & 1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool key_ok = j * ABW_T + 8 * (x >> 1) + col0 + e < s_len;
        sc[2 * x + e] = key_ok ? abw_prob(sc[2 * x + e], scale, m_run[h], l_run[h], inv_l[h]) : 0.0f;
      }
      pa[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);
    }
    if constexpr (WITH_O) {
      wgmma_fence();  // after writing pa, before the product reads it
      abw_rn(o_acc, pa, t_k + ABW_TILE);
      wgmma_commit();
    }
    wgmma_wait<WITH_O ? 1 : 0>();  // dp
    fence_sums(dp);
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const int h = x & 1;
      float d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) d2[e] = sc[2 * x + e] * (round_to<__nv_bfloat16>(dp[2 * x + e]) - delta[h]) * scale;
      abw_split(d2[0], d2[1], dh[x], dl[x]);
    }
    wgmma_fence();
    abw_rn2(dq_acc, dh, dl, t_k);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_sums(dq_acc);
  fence_sums(o_acc);
  abw_store(dq_acc, dq + in_base, in_s, i0, s_len);
  if constexpr (WITH_O) abw_store(o_acc, o + (long long)blockIdx.z * p_n + (long long)blockIdx.y * p_h, p_s, i0, s_len);
}

// The key-tile blocks: dK_j and dV_j, from the statistics the query-tile blocks wrote.  Grid (tiles, heads, n); the
// rows of s^T are keys, its columns queries.
__global__ void __launch_bounds__(ABW_THREADS, ABW_BLOCKS)
attention_bwd_kv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                        const float* __restrict__ stats, int s_len, float scale, long long in_n, long long in_s,
                        long long in_h, long long o_n, long long o_s, long long o_h) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t t_k = (smem_addr(smem) + 1023u) & ~1023u, t_v = t_k + ABW_TILE;
  // the statistics of a stage as floats: a shared address as a pointer
  auto floats_at = [&](uint32_t addr) {
    return reinterpret_cast<const float*>(reinterpret_cast<const char*>(smem) + (addr - smem_addr(smem)));
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (s_len + ABW_T - 1) / ABW_T, j0 = blockIdx.x * ABW_T;
  const long long in_base = (long long)blockIdx.z * in_n + (long long)blockIdx.y * in_h;
  const __nv_bfloat16* const do_b = dout + (long long)blockIdx.z * o_n + (long long)blockIdx.y * o_h;
  const float* const st_b = stats + ((long long)blockIdx.z * gridDim.y + blockIdx.y) * tiles * ABW_STATS;
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);

  // query tile i at stage i % ABW_STAGES: Q, dO after it, then its statistics
  auto stage = [&](int i) { return t_k + (uint32_t)(2 * ABW_TILE + i % ABW_STAGES * ABW_KV_STAGE); };
  auto load_q = [&](int i) {
    abw_load_tile(stage(i), q + in_base, in_s, i * ABW_T, s_len);
    abw_load_tile(stage(i) + ABW_TILE, do_b, o_s, i * ABW_T, s_len);
    if (tid < ABW_STATS / 4) cp_async16(stage(i) + 2 * ABW_TILE + tid * 16, st_b + i * ABW_STATS + tid * 4, true);
  };
  abw_load_tile(t_k, k + in_base, in_s, j0, s_len);
  abw_load_tile(t_v, v + in_base, in_s, j0, s_len);
  load_q(0);
  cp_async_commit();

  float dk_acc[32], dv_acc[32], sc[32], dp[32];
  abw_zero(dk_acc);
  abw_zero(dv_acc);
  uint32_t pa[16], dh[16], dl[16];
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_ok[h] = j0 + row0 + 8 * h < s_len;
  for (int i = 0; i < tiles; ++i) {
    // the stage refilled here held tile i - 2, whose dV and dK products the first wait of step i - 1 retired
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (i + 1 < tiles) load_q(i + 1);
    cp_async_commit();
    const uint32_t t_qi = stage(i), t_doi = t_qi + ABW_TILE;
    const float* const s_m = floats_at(t_qi + 2 * ABW_TILE);
    const float* const s_l = s_m + ABW_T;
    const float* const s_inv_l = s_m + 2 * ABW_T;
    const float* const s_delta = s_m + 3 * ABW_T;

    abw_zero(sc);
    abw_zero(dp);
    wgmma_fence();
    abw_nt(sc, t_k, t_qi);
    wgmma_commit();
    abw_nt(dp, t_v, t_doi);
    wgmma_commit();
    wgmma_wait<1>();  // s^T, and the step before's dV and dK: pa, dh and dl are free
    fence_sums(sc);
    const int q_rem = s_len - i * ABW_T;  // real query columns of this tile
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {  // the column pair 8 jj + col0, + 1: this thread's x = 2 jj (h 0), 2 jj + 1 (h 1)
      const int qc = 8 * jj + col0;
      const float2 m2 = *reinterpret_cast<const float2*>(s_m + qc), l2 = *reinterpret_cast<const float2*>(s_l + qc),
                   r2 = *reinterpret_cast<const float2*>(s_inv_l + qc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 2 * jj + h;
        sc[2 * x] = key_ok[h] && qc < q_rem ? abw_prob(sc[2 * x], scale, m2.x, l2.x, r2.x) : 0.0f;
        sc[2 * x + 1] = key_ok[h] && qc + 1 < q_rem ? abw_prob(sc[2 * x + 1], scale, m2.y, l2.y, r2.y) : 0.0f;
        pa[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);
      }
    }
    wgmma_fence();  // after writing pa, before the product reads it
    abw_rn(dv_acc, pa, t_doi);
    wgmma_commit();
    wgmma_wait<1>();  // dp^T
    fence_sums(dp);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 d2 = *reinterpret_cast<const float2*>(s_delta + 8 * jj + col0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = 2 * jj + h;
        abw_split(sc[2 * x] * (round_to<__nv_bfloat16>(dp[2 * x]) - d2.x) * scale,
                  sc[2 * x + 1] * (round_to<__nv_bfloat16>(dp[2 * x + 1]) - d2.y) * scale, dh[x], dl[x]);
      }
    }
    wgmma_fence();
    abw_rn2(dk_acc, dh, dl, t_qi);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_sums(dk_acc);
  fence_sums(dv_acc);
  abw_store(dk_acc, dk + in_base, in_s, j0, s_len);
  abw_store(dv_acc, dv + in_base, in_s, j0, s_len);
}

// floats of the statistics scratch the two launches share: 4 x 64 (m, l, 1/l, delta) a query tile of each head of
// each image, 16 bytes a query row with S padded to whole tiles
inline long long attention_bwd_stats_floats(int n, int s_len, int heads) {
  return (long long)n * heads * ((s_len + ABW_T - 1) / ABW_T) * ABW_STATS;
}

// q, k, v, dq, dk, dv share the strides in_*, dout has o_*, o (null: none) p_*; bases 16-byte aligned and strides
// multiples of 8 (cp.async copies 16 bytes, the results are stored in pairs); stats: attention_bwd_stats_floats
// floats, 16-byte aligned.  Two launches on `stream`: the query-tile blocks, then the key-tile blocks.
inline cudaError_t launch_attention_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                                        const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
                                        __nv_bfloat16* dv, __nv_bfloat16* o, float* stats, int n, int s_len,
                                        int heads, float scale, long long in_n, long long in_s, long long in_h,
                                        long long o_n, long long o_s, long long o_h, long long p_n, long long p_s,
                                        long long p_h, cudaStream_t stream) {
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq |
                          (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)o | (uintptr_t)stats;
  if (n < 1 || heads < 1 || s_len < 1 || bases % 16 || stats == nullptr ||
      (in_n | in_s | in_h | o_n | o_s | o_h | p_n | p_s | p_h) % 8)
    return cudaErrorInvalidValue;
  auto q_kernel = o != nullptr ? attention_bwd_q_kernel<true> : attention_bwd_q_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ABW_Q_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ABW_KV_SMEM);
  if (err != cudaSuccess) return err;
  // past MAX_GRID_YZ images or heads, one pair of launches a piece on the offset tensors; each piece has its own
  // part of the statistics, laid out as a call of its images and heads would lay them
  const long long tiles = (s_len + ABW_T - 1) / ABW_T;
  float* piece_stats = stats;
  return over_images_heads(n, heads, [&](int n0, int nc, int h0, int hc) {
    const long long in0 = n0 * in_n + h0 * in_h, o0 = n0 * o_n + h0 * o_h;
    const dim3 grid((unsigned)tiles, hc, nc);
    __nv_bfloat16* op = o == nullptr ? nullptr : o + n0 * p_n + h0 * p_h;
    q_kernel<<<grid, ABW_THREADS, ABW_Q_SMEM, stream>>>(q + in0, k + in0, v + in0, dout + o0, dq + in0, op,
                                                         piece_stats, s_len, scale, in_n, in_s, in_h, o_n, o_s, o_h,
                                                         p_n, p_s, p_h);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    attention_bwd_kv_kernel<<<grid, ABW_THREADS, ABW_KV_SMEM, stream>>>(q + in0, k + in0, v + in0, dout + o0,
                                                                        dk + in0, dv + in0, piece_stats, s_len, scale,
                                                                        in_n, in_s, in_h, o_n, o_s, o_h);
    piece_stats += (long long)nc * hc * tiles * ABW_STATS;
    return cudaGetLastError();
  });
}

}  // namespace cvt
