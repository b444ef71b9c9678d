// The backward of the bf16 attention core on Hopper's tensor cores (Kernel B;
// wgmma through hopper.cuh): for softmax(scale * Q K^T) V per head at head
// dim 64 and S <= ABW_MAX_TILES * 64 = 256, given dO, the gradients dQ, dK and
// dV, and (WITH_O) the output O again.  Included by attention.cu alone; the
// backward of flash_mha and of attention_block
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
// With WITH_O it also writes O = bf16(bf16(p) v), the twin's joined heads,
// which attention_block's weight gradient of its output projection needs
// (the forward core rounds p before the division by the row sum, and its
// heads stood 0.03 of the card test's tolerance off the twin's through that
// product).
//
// Bound.  At ViT-B/16 b128 (S 197, 12 heads) the core backward reads q, k, v
// and do and writes dq, dk and dv, 271 MB: 0.081 ms at the memory rate,
// against 5 S^2 hd products a head, 38 GFLOP, 0.039 ms at the bf16 rate.
//
// Design.  One block a (head, image), two warpgroups (256 threads), the whole
// sequence of the head on chip as the TPU forward keeps a head's scores in
// VMEM: Q, K, V and dO of S rows (zero past S), 64-row tiles in the 128-byte
// swizzle, copied once by cp.async (4 x 32 KB at S 256), and each row's
// softmax statistics.  No log-sum-exp is saved by the forward, so
//   phase 1  a warpgroup a query tile i: over the key tiles j, s_ij = Q_i K_j^T
//            and dp_ij = dO_i V_j^T (wgmma, K-major operands), the running
//            row maximum m and sum l, and delta = sum_k bf16(dp) p as a
//            running sum rescaled with l, into shared memory;
//   phase 2  a warpgroup a key tile j: over the query tiles i, the transposed
//            tiles s^T = K_j Q_i^T and dp^T = V_j dO_i^T, p^T and ds^T from the
//            row statistics, then dV_j += bf16(p^T) dO_i and dK_j += ds^T Q_i
//            with A from registers (the sums of s^T are, register for
//            register, the A fragments, as P of the forward) and dO_i, Q_i as
//            MN-major B; dK_j and dV_j written once;
//   phase 3  a warpgroup a query tile i: s_ij and dp_ij again, ds_ij, and
//            dQ_i += ds_ij K_j (A from registers, K_j MN-major), with WITH_O
//            O_i += bf16(p_ij) V_j; dQ_i (and O_i) written.
// Thirteen 64 x 64 x 64 products a pair of tiles (fourteen WITH_O) where
// five would do: the price of keeping no S x S tile in shared memory and of
// the hi/lo halves of ds (a first design, right before fast).  Keys past S
// get no probability, query rows past S are computed on zeros and not stored.
// No atomics: every call gives the same bits.

#pragma once

#include "hopper.cuh"

namespace cvt {

constexpr int ABW_T = 64;          // rows of a tile (queries or keys); head dim 64 = one 128-byte row
constexpr int ABW_MAX_TILES = 4;   // S <= 256
constexpr int ABW_THREADS = 256;   // two warpgroups
constexpr int ABW_TILE = 64 * 128;  // bytes of a 64 x 64 bf16 tile

// bytes of shared memory for `tiles` 64-row tiles of each of Q, K, V, dO and the row statistics
__host__ __device__ constexpr size_t abw_smem(int tiles) {
  return (size_t)4 * tiles * ABW_TILE + (size_t)3 * tiles * ABW_T * sizeof(float) + 1024;
}

// ds of one pair of columns as the A fragments of its two bf16 halves: t = tf32(ds), hi = bf16(t), lo = t - hi
__device__ __forceinline__ void abw_split(float d0, float d1, uint32_t& hi, uint32_t& lo) {
  const float t0 = tf32_rna(d0), t1 = tf32_rna(d1);
  const float h0 = round_to<__nv_bfloat16>(t0), h1 = round_to<__nv_bfloat16>(t1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(t0 - h0, t1 - h1);
}

template <bool WITH_O>
__global__ void __launch_bounds__(ABW_THREADS, 1)
attention_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     __nv_bfloat16* __restrict__ o, int s_len, float scale, long long in_n, long long in_s,
                     long long in_h, long long o_n, long long o_s, long long o_h, long long p_n, long long p_s,
                     long long p_h) {
  extern __shared__ __align__(16) float smem[];
  const int tiles = (s_len + ABW_T - 1) / ABW_T;
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  // tile t of array a (0 Q, 1 K, 2 V, 3 dO) at base + (a * tiles + t) * ABW_TILE
  auto tile = [&](int a, int t) { return base + (uint32_t)((a * tiles + t) * ABW_TILE); };
  float* stats = smem + ((base - smem_addr(smem)) + 4 * tiles * ABW_TILE) / sizeof(float);
  float* s_m = stats;                          // row maximum of s
  float* s_l = stats + tiles * ABW_T;          // row sum of exp(s - m)
  float* s_delta = stats + 2 * tiles * ABW_T;  // sum over keys of bf16(dp) p

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
  const long long in_base = (long long)blockIdx.y * in_n + (long long)blockIdx.x * in_h;
  const long long o_base = (long long)blockIdx.y * o_n + (long long)blockIdx.x * o_h;

  // rows of a head (stride rs) as swizzled tiles: row r, chunk c of 8 values at r * 128 + (c ^ r % 8) * 16
  auto load = [&](int a, const __nv_bfloat16* src, long long rs) {
    for (int e = tid; e < tiles * ABW_T * 8; e += ABW_THREADS) {
      const int r = e >> 3, c = e & 7;
      const bool ok = r < s_len;
      cp_async16(tile(a, r / ABW_T) + (r % ABW_T) * 128 + ((c ^ (r & 7)) << 4), src + (ok ? r * rs + c * 8 : 0), ok);
    }
  };
  load(0, q + in_base, in_s);
  load(1, k + in_base, in_s);
  load(2, v + in_base, in_s);
  load(3, dout + o_base, o_s);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // this thread's sums of a 64 x 64 product hold rows 16 warp + lane / 4 (+ 8 for h = 1), columns 8 j + 2 (lane % 4)
  // (+ 1 for e = 1) at index 4 j + 2 h + e; the pair at 2 x, 2 x + 1 (j = x / 2, h = x % 2) is, packed, A register x
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);

  // s (or s^T) = A B^T and dp (or dp^T) = C D^T over head dims, all four 64-row tiles K-major
  auto two_products = [&](float (&s)[32], float (&dp)[32], uint32_t ta, uint32_t tb, uint32_t tc, uint32_t td) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      wgmma_m64n64k16_ss_kk(s, sw128_desc(ta + st * 32, 16, 1024), sw128_desc(tb + st * 32, 16, 1024));
      wgmma_m64n64k16_ss_kk(dp, sw128_desc(tc + st * 32, 16, 1024), sw128_desc(td + st * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_sums(s);
    fence_sums(dp);
  };
  // a (64 x 64) sum as bf16 pairs to dst (rows below s_len), element (r, c) at dst + r rs + c
  auto store = [&](const float (&acc)[32], __nv_bfloat16* dst, long long rs, int r0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + row0 + 8 * h;
      if (r >= s_len) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + r * rs + 8 * jj + col0) = pack_bf16(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
    }
  };

  float sc[32], dp[32];

  // phase 1: row statistics of query tile i
  for (int i = wg; i < tiles; i += 2) {
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f}, d_run[2] = {0.0f, 0.0f};
    for (int j = 0; j < tiles; ++j) {
      two_products(sc, dp, tile(0, i), tile(1, j), tile(3, i), tile(2, j));
      // key j * 64 + 0 is always real, so each row's maximum is finite
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& val = sc[4 * jj + 2 * h + e];
            val = j * ABW_T + 8 * jj + col0 + e < s_len ? val * scale : -INFINITY;
            mx = fmaxf(mx, val);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx), alpha = expf(m_run[h] - m_new);
        float sum = 0.0f, dsum = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(sc[4 * jj + 2 * h + e] - m_new);
            sum += p;
            dsum += round_to<__nv_bfloat16>(dp[4 * jj + 2 * h + e]) * p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
        l_run[h] = l_run[h] * alpha + sum;
        d_run[h] = d_run[h] * alpha + dsum;
        m_run[h] = m_new;
      }
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i * ABW_T + row0 + 8 * h;
        s_m[r] = m_run[h];
        s_l[r] = l_run[h];
        s_delta[r] = d_run[h] / l_run[h];
      }
    }
  }
  __syncthreads();

  // phase 2: dK and dV of key tile j; the rows of s^T are keys, its columns queries
  for (int j = wg; j < tiles; j += 2) {
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) dk_acc[x] = dv_acc[x] = 0.0f;
    for (int i = 0; i < tiles; ++i) {
      two_products(sc, dp, tile(1, j), tile(0, i), tile(2, j), tile(3, i));
      uint32_t pa[16], dh[16], dl[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const bool key_ok = j * ABW_T + row0 + 8 * (x & 1) < s_len;
        float p2[2], d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qr = i * ABW_T + 8 * (x >> 1) + col0 + e;
          const float p = key_ok && qr < s_len ? expf(sc[2 * x + e] * scale - s_m[qr]) / s_l[qr] : 0.0f;
          p2[e] = p;
          d2[e] = p * (round_to<__nv_bfloat16>(dp[2 * x + e]) - s_delta[qr]) * scale;
        }
        pa[x] = pack_bf16(p2[0], p2[1]);
        abw_split(d2[0], d2[1], dh[x], dl[x]);
      }
      wgmma_fence();  // after writing the A registers and the sums, before the products read them
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint64_t b_do = sw128_desc(tile(3, i) + st * 2048, 8192, 1024), b_q = sw128_desc(tile(0, i) + st * 2048, 8192, 1024);
        wgmma_m64n64k16_rs(dv_acc, pa + 4 * st, b_do);
        wgmma_m64n64k16_rs(dk_acc, dh + 4 * st, b_q);
        wgmma_m64n64k16_rs(dk_acc, dl + 4 * st, b_q);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_sums(dk_acc);
      fence_sums(dv_acc);
    }
    store(dk_acc, dk + in_base, in_s, j * ABW_T);
    store(dv_acc, dv + in_base, in_s, j * ABW_T);
  }

  // phase 3: dQ (and O) of query tile i
  for (int i = wg; i < tiles; i += 2) {
    float dq_acc[32], o_acc[WITH_O ? 32 : 1];
#pragma unroll
    for (int x = 0; x < 32; ++x) dq_acc[x] = 0.0f;
#pragma unroll
    for (int x = 0; x < (WITH_O ? 32 : 1); ++x) o_acc[x] = 0.0f;
    float m_row[2], l_row[2], d_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * ABW_T + row0 + 8 * h;
      m_row[h] = s_m[r];
      l_row[h] = s_l[r];
      d_row[h] = s_delta[r];
    }
    for (int j = 0; j < tiles; ++j) {
      two_products(sc, dp, tile(0, i), tile(1, j), tile(3, i), tile(2, j));
      uint32_t pa[16], dh[16], dl[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int h = x & 1;
        float p2[2], d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool key_ok = j * ABW_T + 8 * (x >> 1) + col0 + e < s_len;
          const float p = key_ok ? expf(sc[2 * x + e] * scale - m_row[h]) / l_row[h] : 0.0f;
          p2[e] = p;
          d2[e] = p * (round_to<__nv_bfloat16>(dp[2 * x + e]) - d_row[h]) * scale;
        }
        pa[x] = pack_bf16(p2[0], p2[1]);
        abw_split(d2[0], d2[1], dh[x], dl[x]);
      }
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint64_t b_k = sw128_desc(tile(1, j) + st * 2048, 8192, 1024);
        wgmma_m64n64k16_rs(dq_acc, dh + 4 * st, b_k);
        wgmma_m64n64k16_rs(dq_acc, dl + 4 * st, b_k);
        if constexpr (WITH_O) wgmma_m64n64k16_rs(o_acc, pa + 4 * st, sw128_desc(tile(2, j) + st * 2048, 8192, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_sums(dq_acc);
      fence_sums(o_acc);
    }
    store(dq_acc, dq + in_base, in_s, i * ABW_T);
    if constexpr (WITH_O) store(o_acc, o + (long long)blockIdx.y * p_n + (long long)blockIdx.x * p_h, p_s, i * ABW_T);
  }
}

// q, k, v, dq, dk, dv share the strides in_*, dout has o_*, o (null: none) p_*; bases 16-byte aligned and strides
// multiples of 8 (cp.async copies 16 bytes, the results are stored in pairs)
inline cudaError_t launch_attention_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                                        const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk,
                                        __nv_bfloat16* dv, __nv_bfloat16* o, int n, int s_len, int heads, float scale,
                                        long long in_n, long long in_s, long long in_h, long long o_n, long long o_s,
                                        long long o_h, long long p_n, long long p_s, long long p_h,
                                        cudaStream_t stream) {
  const uintptr_t bases = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq |
                          (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)o;
  if (n < 1 || heads < 1 || s_len < 1 || s_len > ABW_MAX_TILES * ABW_T || n > 65535 || bases % 16 ||
      (in_n | in_s | in_h | o_n | o_s | o_h | p_n | p_s | p_h) % 8)
    return cudaErrorInvalidValue;
  const size_t smem = abw_smem((s_len + ABW_T - 1) / ABW_T);
  const dim3 grid(heads, n);
  if (o != nullptr) {
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)abw_smem(ABW_MAX_TILES));
    if (err != cudaSuccess) return err;
    attention_bwd_kernel<true><<<grid, ABW_THREADS, smem, stream>>>(q, k, v, dout, dq, dk, dv, o, s_len, scale, in_n,
                                                                    in_s, in_h, o_n, o_s, o_h, p_n, p_s, p_h);
  } else {
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)abw_smem(ABW_MAX_TILES));
    if (err != cudaSuccess) return err;
    attention_bwd_kernel<false><<<grid, ABW_THREADS, smem, stream>>>(q, k, v, dout, dq, dk, dv, o, s_len, scale, in_n,
                                                                     in_s, in_h, o_n, o_s, o_h, p_n, p_s, p_h);
  }
  return cudaGetLastError();
}

}  // namespace cvt
