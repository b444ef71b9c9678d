// The two fused sub-blocks of a pre-LN transformer encoder layer for Hopper
// (sm_90a), bound with ctypes:
//
//   cvt_mlp_block        out = x + W2 gelu(W1 LN(x) + b1) + b2
//                        post_norm:  out = x + LN(W2 gelu(W1 x + b1) + b2)
//                        with gamma: out = res + gamma * (W2 gelu(W1 LN(y) + b1) + b2)
//   cvt_attention_block  out = x + Wo MHA(Wqkv LN(x) + bqkv) + bo
//
// They replace the Pallas TPU kernels of
// cpu_vision_tpu/ops/pallas/transformer_block.py: _fwd_pallas :125
// (pallas_call at :134, reached through mlp_block :314), _cn_fwd_pallas :391
// (pallas_call at :402, reached through cn_mlp_block :437: the ConvNeXt block's
// tail, the same kernel here with a separate residual and a per-channel scale)
// and _attn_fwd_pallas :237 (pallas_call at :240, reached through
// attention_block :282).
//
// Types.  x, the weights and the output share one storage type T (float or
// bf16); LayerNorm parameters and biases are f32.  LayerNorm, gelu, softmax
// and every sum are f32; a value is rounded through T where the TPU kernels
// cast to the weight type: after LN, after bias + gelu, after bias of the QKV
// product, after softmax, after the heads are joined.  The erf is the
// Abramowitz-Stegun polynomial of the TPU kernel, not erff.
//
// mlp_block.  The TPU kernel keeps both weights resident in VMEM and carries
// a (block_m, D) accumulator across a sequential grid axis over the hidden
// dim.  Here a block of 512 threads owns 32 tokens (16 at D 1536, where 32
// rows of LN(x) would not fit): LN(x) of the tile sits in shared memory
// (32 x D f32), the (32, D) accumulator in registers, and the hidden dim is a
// loop inside the block over chunks of up to 256 columns of W1:
// (a) the chunk's up-projection from LN(x) and W1 tiles streamed through
// shared memory, (b) bias + gelu into a (32, 256) shared buffer, (c) the
// chunk's share of the down-projection from that buffer and W2 tiles.  The
// (tokens, 4 D) activations never reach device memory and the up-projection
// is computed once.  Thread (rg, cg) of 8 x 64 owns rows 4 rg .. 4 rg + 3 and
// columns 4 cg .. 4 cg + 3 of every 256-column group, so a warp reads 512
// contiguous bytes of a weight row and one broadcast word of an activation.
// Weight tiles are fetched into registers one tile ahead of their use.  D
// is one of 96, 128, 192, 256, 384, 512, 768, 1024, 1280, 1536 and the hidden
// dim a multiple of 256, or of 64 up to D 512 (the RAGGED instantiations,
// which mask a last chunk narrower than 256; the others keep the unmasked
// loops): such a chunk and a D that is no multiple of 256 leave the threads
// past the edge idle (at D 96 five eighths of them in the down-projection).
// The ragged last token tile is masked.
// post_norm (Swin v2) skips the LayerNorm of the input and normalises the
// branch instead: acc + b2 goes back into the shared rows that held LN(x),
// a warp takes each row's statistics, and the residual is added as the row
// is written.  ln_count > 0 takes either LayerNorm's statistics over the
// first ln_count channels of a zero-padded row (see ln_gemm.cuh).
//
// attention_block.  The TPU kernel holds one image's (S, 3 D) QKV product in
// VMEM (908 KB at ViT-B/16 in bf16); a block here has 227 KB, and the output
// projection sums over heads, which live in different blocks.  So it is
// three launches, all written here: (1) LN + QKV product + bias into a
// (N S, 3 D) buffer of T, (2) the attention core of attention.cuh reading
// q, k, v out of that buffer by strides and writing the joined heads as
// (N S, D) of T, (3) output projection + bias + residual.  The QKV buffer
// and the joined heads are the two intermediates that now touch device memory
// (8 D bytes a token in bf16, written once and read once); no transposed copy
// exists, as on the TPU.  (1) and (3) are one tiled product kernel, 128 x 128
// outputs a block of 256 threads, 8 x 8 a thread, K in steps of 16 with the
// next tiles fetched into registers during the current step; with LN it first
// takes the mean and variance of its 128 rows, and normalises A as it is
// staged.
//
// Bound.  At ViT-B/16 batch 256 (50,432 tokens, D 768) mlp_block does 476
// GFLOP on 155 MB (bf16) and attention_block 268 GFLOP: operations bind both,
// in either type.  This first version is scalar f32 FMAs from shared memory
// for both types: no mma, no cp.async, no TMA.  bf16 gains nothing over f32
// but halved bytes.

#include "ln_gemm.cuh"

namespace {

using cvt::from_f32;
using cvt::launch_ln_gemm;
using cvt::row_stats;
using cvt::round_to;
using cvt::to_f32;
using cvt::warp_sum;

__device__ __forceinline__ float erf_poly(float x) {
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return copysignf(1.0f - poly * expf(-a * a), x);
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erf_poly(h * 0.70710678118654752f));
}

template <typename T>
cudaError_t attention_block(const T* x, const float* ln_g, const float* ln_b, const T* w_qkv,
                            const float* b_qkv, const T* w_o, const float* b_o, T* qkv, T* heads_out, T* out,
                            int n, int s_len, int d, int heads, float scale, float eps, cudaStream_t stream) {
  if (heads < 1 || d % heads) return cudaErrorInvalidValue;
  const int m = n * s_len, hd = d / heads;
  cudaError_t err = launch_ln_gemm<T, T, true, false>(x, ln_g, ln_b, w_qkv, b_qkv, nullptr, qkv, m, d, 3 * d,
                                                      eps, 0, stream);
  if (err != cudaSuccess) return err;
  const long long row = 3LL * d;
  err = cvt::attention_core<T>(qkv, qkv + d, qkv + 2 * d, heads_out, n, s_len, heads, hd, scale, s_len * row,
                               row, hd, (long long)s_len * d, d, hd, stream);
  if (err != cudaSuccess) return err;
  return launch_ln_gemm<T, T, false, true>(heads_out, nullptr, nullptr, w_o, b_o, x, out, m, d, d, eps, 0, stream);
}

// ---------------------------------------------------------------- mlp_block

constexpr int M_HC = 256;       // hidden columns a chunk
constexpr int M_THREADS = 512;
constexpr int M_KT = 32;        // rows of a W1 tile
constexpr int M_TILE = M_KT * M_HC;  // words of the weight tile buffer
constexpr int M_FETCH = M_TILE / M_THREADS;
constexpr int M_LDG = M_HC + 4;

// RPT rows a thread, 8 RPT tokens a block
template <int D, int RPT> constexpr size_t mlp_smem_bytes() {
  return sizeof(float) * ((size_t)(8 * RPT) * (D + 4) + (size_t)(8 * RPT) * M_LDG + M_TILE);
}

// x is the tensor that is normalised and projected, resid the one the branch
// is added to (the same tensor for mlp_block), gamma the per-channel scale of
// the branch or null.
template <typename T, int D, int RPT, bool RAGGED>
__global__ void __launch_bounds__(M_THREADS, 1)
mlp_block_kernel(const T* __restrict__ x, const T* __restrict__ resid, const float* __restrict__ ln_g,
                 const float* __restrict__ ln_b, const T* __restrict__ w1, const float* __restrict__ b1,
                 const T* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ gamma,
                 T* __restrict__ out, int m, int dh, float eps, int post_norm, int ln_count) {
  constexpr int BM = 8 * RPT;
  constexpr int NREP = (D + 255) / 256;  // 256-column groups of the output
  constexpr bool FULL = D % 256 == 0;    // else the last group is cut at D
  constexpr int LDH = D + 4;
  // rows of a W2 tile
  constexpr int KT2 = M_TILE / D >= 32 ? 32 : M_TILE / D >= 16 ? 16 : M_TILE / D >= 8 ? 8 : 4;
  constexpr int TILE2 = KT2 * D;
  static_assert(D % M_KT == 0 && TILE2 <= M_TILE && 64 % KT2 == 0, "tiles");
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem;                 // [BM][LDH]   LN(x), rounded through T
  float* s_g = s_h + BM * LDH;       // [BM][M_LDG] gelu of the chunk, rounded through T
  float* s_w = s_g + BM * M_LDG;     // a W1 tile [M_KT][M_HC] or a W2 tile [KT2][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = tid >> 6, cg = tid & 63;
  const int m0 = blockIdx.x * BM;

  for (int r = warp; r < BM; r += M_THREADS / 32) {
    const int row = m0 + r;
    if (row < m) {
      const T* p = x + (size_t)row * D;
      if (post_norm) {
        for (int c = lane; c < D; c += 32) s_h[r * LDH + c] = to_f32<T>(p[c]);
      } else {
        float mean, rstd;
        row_stats<T>(p, D, eps, ln_count, lane, mean, rstd);
        for (int c = lane; c < D; c += 32)
          s_h[r * LDH + c] = round_to<T>((to_f32<T>(p[c]) - mean) * rstd * ln_g[c] + ln_b[c]);
      }
    } else {
      for (int c = lane; c < D; c += 32) s_h[r * LDH + c] = 0.0f;
    }
  }
  __syncthreads();

  float acc[RPT][4 * NREP];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NREP; ++j) acc[i][j] = 0.0f;
  float rw[M_FETCH];

  for (int h0 = 0; h0 < dh; h0 += M_HC) {
    const int hc = RAGGED ? min(M_HC, dh - h0) : M_HC;  // columns of this chunk, a multiple of 64
    const bool h_in = !RAGGED || cg * 4 < hc;           // this thread's four hidden columns exist
    // (a) the chunk's up-projection: hj = LN(x) . w1[:, h0 : h0 + hc]
    float hj[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) hj[i][j] = 0.0f;

    auto fetch1 = [&](int k0) {
#pragma unroll
      for (int j = 0; j < M_FETCH; ++j) {
        const int e = tid + M_THREADS * j;
        rw[j] = (!RAGGED || (e & 255) < hc) ? to_f32<T>(w1[(size_t)(k0 + (e >> 8)) * dh + h0 + (e & 255)]) : 0.0f;
      }
    };
    fetch1(0);
    for (int k0 = 0; k0 < D; k0 += M_KT) {
#pragma unroll
      for (int j = 0; j < M_FETCH; ++j) s_w[tid + M_THREADS * j] = rw[j];
      __syncthreads();
      if (k0 + M_KT < D) fetch1(k0 + M_KT);
      if (h_in) {
#pragma unroll 2
        for (int kk = 0; kk < M_KT; kk += 4) {
          float4 av[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            av[i] = *reinterpret_cast<const float4*>(s_h + (rg * RPT + i) * LDH + k0 + kk);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 bv = *reinterpret_cast<const float4*>(s_w + (kk + c) * M_HC + cg * 4);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float ai = c == 0 ? av[i].x : c == 1 ? av[i].y : c == 2 ? av[i].z : av[i].w;
              hj[i][0] += ai * bv.x;
              hj[i][1] += ai * bv.y;
              hj[i][2] += ai * bv.z;
              hj[i][3] += ai * bv.w;
            }
          }
        }
      }
      __syncthreads();
    }

    // (b) bias + gelu, rounded through T.  The chunk before is read to its end
    // (the barrier that closed its last W2 tile); the barrier of the first W2
    // tile below orders these writes before their reads.
    if (h_in) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s_g[(rg * RPT + i) * M_LDG + cg * 4 + j] = round_to<T>(gelu_erf(hj[i][j] + b1[h0 + cg * 4 + j]));
    }

    // (c) the chunk's share of the down-projection: acc += g . w2[h0 : h0 + hc, :]
    // (KT2 rows of w2 are one contiguous run of KT2 * D words)
    auto fetch2 = [&](int k0) {
      const T* src = w2 + (size_t)(h0 + k0) * D;
#pragma unroll
      for (int j = 0; j < M_FETCH; ++j) {
        const int e = tid + M_THREADS * j;
        if (e < TILE2) rw[j] = to_f32<T>(src[e]);
      }
    };
    fetch2(0);
    for (int k0 = 0; k0 < hc; k0 += KT2) {
#pragma unroll
      for (int j = 0; j < M_FETCH; ++j) {
        const int e = tid + M_THREADS * j;
        if (e < TILE2) s_w[e] = rw[j];
      }
      __syncthreads();
      if (k0 + KT2 < hc) fetch2(k0 + KT2);
#pragma unroll
      for (int kk = 0; kk < KT2; kk += 4) {
        float4 av[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          av[i] = *reinterpret_cast<const float4*>(s_g + (rg * RPT + i) * M_LDG + k0 + kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int rep = 0; rep < NREP; ++rep) {
            if (!FULL && rep * 256 + cg * 4 >= D) continue;
            const float4 bv = *reinterpret_cast<const float4*>(s_w + (kk + c) * D + rep * 256 + cg * 4);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float ai = c == 0 ? av[i].x : c == 1 ? av[i].y : c == 2 ? av[i].z : av[i].w;
              acc[i][rep * 4 + 0] += ai * bv.x;
              acc[i][rep * 4 + 1] += ai * bv.y;
              acc[i][rep * 4 + 2] += ai * bv.z;
              acc[i][rep * 4 + 3] += ai * bv.w;
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (!post_norm) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = m0 + rg * RPT + i;
      if (row >= m) continue;
#pragma unroll
      for (int rep = 0; rep < NREP; ++rep)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = rep * 256 + cg * 4 + j;
          if (!FULL && col >= D) continue;
          const size_t at = (size_t)row * D + col;
          float branch = acc[i][rep * 4 + j] + b2[col];
          if (gamma != nullptr) branch *= gamma[col];
          out[at] = from_f32<T>(to_f32<T>(resid[at]) + branch);
        }
    }
    return;
  }

  // post_norm: the branch's rows go where LN(x) was (read to its end before
  // the barrier that closed the last W2 tile), then a warp a row
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int rep = 0; rep < NREP; ++rep)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = rep * 256 + cg * 4 + j;
        if (!FULL && col >= D) continue;
        s_h[(rg * RPT + i) * LDH + col] = acc[i][rep * 4 + j] + b2[col];
      }
  __syncthreads();
  for (int r = warp; r < BM; r += M_THREADS / 32) {
    const int row = m0 + r;
    if (row >= m) continue;
    float mean, rstd;
    row_stats<float>(s_h + r * LDH, D, eps, ln_count, lane, mean, rstd);
    for (int c = lane; c < D; c += 32) {
      const size_t at = (size_t)row * D + c;
      out[at] = from_f32<T>(to_f32<T>(resid[at]) + ((s_h[r * LDH + c] - mean) * rstd * ln_g[c] + ln_b[c]));
    }
  }
}

template <typename T, int D, int RPT, bool RAGGED>
cudaError_t launch_mlp_block(const T* x, const T* resid, const float* ln_g, const float* ln_b, const T* w1,
                             const float* b1, const T* w2, const float* b2, const float* gamma, T* out, int m,
                             int dh, float eps, int post_norm, int ln_count, cudaStream_t stream) {
  constexpr size_t smem = mlp_smem_bytes<D, RPT>();
  cudaError_t err = cudaFuncSetAttribute(mlp_block_kernel<T, D, RPT, RAGGED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlp_block_kernel<T, D, RPT, RAGGED><<<(m + 8 * RPT - 1) / (8 * RPT), M_THREADS, smem, stream>>>(
      x, resid, ln_g, ln_b, w1, b1, w2, b2, gamma, out, m, dh, eps, post_norm, ln_count);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mlp_block(const T* x, const T* resid, const float* ln_g, const float* ln_b, const T* w1,
                      const float* b1, const T* w2, const float* b2, const float* gamma, T* out, int m, int d,
                      int dh, float eps, int post_norm, int ln_count, cudaStream_t stream) {
  if (m < 1 || dh < 64 || dh % 64 || ln_count < 0 || ln_count > d) return cudaErrorInvalidValue;
  // a hidden dim that is no multiple of 256 takes the RAGGED instantiation, which exists up to D 512
#define CVT_MLP_CASE(D, RPT)                                                                                   \
  case D:                                                                                                      \
    if (dh % M_HC == 0)                                                                                        \
      return launch_mlp_block<T, D, RPT, false>(x, resid, ln_g, ln_b, w1, b1, w2, b2, gamma, out, m, dh, eps,  \
                                                post_norm, ln_count, stream);                                 \
    if constexpr (D <= 512)                                                                                    \
      return launch_mlp_block<T, D, RPT, true>(x, resid, ln_g, ln_b, w1, b1, w2, b2, gamma, out, m, dh, eps,   \
                                               post_norm, ln_count, stream);                                  \
    return cudaErrorInvalidValue
  switch (d) {
    CVT_MLP_CASE(96, 4);
    CVT_MLP_CASE(128, 4);
    CVT_MLP_CASE(192, 4);
    CVT_MLP_CASE(256, 4);
    CVT_MLP_CASE(384, 4);
    CVT_MLP_CASE(512, 4);
    CVT_MLP_CASE(768, 4);
    CVT_MLP_CASE(1024, 4);
    CVT_MLP_CASE(1280, 4);
    CVT_MLP_CASE(1536, 2);
    default:
      return cudaErrorInvalidValue;
  }
#undef CVT_MLP_CASE
}

}  // namespace

extern "C" {

// Both launch on `stream` and return the first failed launch's cudaError_t
// (0 on success); neither synchronises.

// mlp_block: resid = x, gamma = null.  cn_mlp_block: x is the tensor that is
// normalised, resid the residual, gamma the layer scale (post_norm = 0).
int cvt_mlp_block(const void* x, const void* resid, const float* ln_g, const float* ln_b, const void* w1,
                  const float* b1, const void* w2, const float* b2, const float* gamma, void* out, int m, int d,
                  int dh, float eps, int post_norm, int ln_count, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)mlp_block<__nv_bfloat16>((const __nv_bfloat16*)x, (const __nv_bfloat16*)resid, ln_g, ln_b,
                                         (const __nv_bfloat16*)w1, b1, (const __nv_bfloat16*)w2, b2, gamma,
                                         (__nv_bfloat16*)out, m, d, dh, eps, post_norm, ln_count, st);
  return (int)mlp_block<float>((const float*)x, (const float*)resid, ln_g, ln_b, (const float*)w1, b1,
                               (const float*)w2, b2, gamma, (float*)out, m, d, dh, eps, post_norm, ln_count, st);
}

// qkv is scratch of n * s_len * 3 d values of T, heads_out of n * s_len * d.
int cvt_attention_block(const void* x, const float* ln_g, const float* ln_b, const void* w_qkv,
                        const float* b_qkv, const void* w_o, const float* b_o, void* qkv, void* heads_out,
                        void* out, int n, int s_len, int d, int heads, float scale, float eps, int is_bf16,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)attention_block<__nv_bfloat16>(
        (const __nv_bfloat16*)x, ln_g, ln_b, (const __nv_bfloat16*)w_qkv, b_qkv, (const __nv_bfloat16*)w_o, b_o,
        (__nv_bfloat16*)qkv, (__nv_bfloat16*)heads_out, (__nv_bfloat16*)out, n, s_len, d, heads, scale, eps, st);
  return (int)attention_block<float>((const float*)x, ln_g, ln_b, (const float*)w_qkv, b_qkv, (const float*)w_o,
                                     b_o, (float*)qkv, (float*)heads_out, (float*)out, n, s_len, d, heads, scale,
                                     eps, st);
}

}  // extern "C"
