// The two fused sub-blocks of a pre-LN transformer encoder layer for Hopper
// (sm_90a), bound with ctypes:
//
//   cvt_mlp_block        out = x + W2 gelu(W1 LN(x) + b1) + b2
//   cvt_attention_block  out = x + Wo MHA(Wqkv LN(x) + bqkv) + bo
//
// They replace the Pallas TPU kernels of
// cpu_vision_tpu/ops/pallas/transformer_block.py: _fwd_pallas :125
// (pallas_call at :134, reached through mlp_block :314) and _attn_fwd_pallas
// :237 (pallas_call at :240, reached through attention_block :282).
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
// dim.  Here a block of 512 threads owns 32 tokens: LN(x) of the tile sits in
// shared memory (32 x D f32), the (32, D) accumulator in registers, and the
// hidden dim is a loop inside the block over chunks of 256 columns of W1:
// (a) the chunk's up-projection from LN(x) and W1 tiles streamed through
// shared memory, (b) bias + gelu into a (32, 256) shared buffer, (c) the
// chunk's share of the down-projection from that buffer and W2 tiles.  The
// (tokens, 4 D) activations never reach device memory and the up-projection
// is computed once.  Thread (rg, cg) of 8 x 64 owns rows 4 rg .. 4 rg + 3 and
// columns 4 cg .. 4 cg + 3 of every 256-column group, so a warp reads 512
// contiguous bytes of a weight row and one broadcast word of an activation.
// Weight tiles are fetched into registers one tile ahead of their use.  D
// is 256, 768, 1024 or 1280 and the hidden dim a multiple of 256;
// the ragged last token tile is masked.
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

#include "attention.cuh"

namespace {

using cvt::from_f32;
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

// Mean and 1/sqrt(var + eps) of one row of `d` values, by a whole warp; two
// passes (mean, then centred squares), as the TPU kernel's _ln_f32.
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ p, int d, float eps, int lane, float& mean,
                                          float& rstd) {
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += to_f32<T>(p[c]);
  mean = warp_sum(s) / (float)d;
  float v = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float dv = to_f32<T>(p[c]) - mean;
    v += dv * dv;
  }
  rstd = rsqrtf(warp_sum(v) / (float)d + eps);
}

// ------------------------------------------------------------ tiled product

constexpr int G_BM = 128;
constexpr int G_BN = 128;
constexpr int G_BK = 16;
constexpr int G_THREADS = 256;
constexpr int G_LDA = G_BM + 4;

// out[m, n] = A'[m, :] . w[:, n] + bias[n]  (+ resid[m, n] first, with RESID),
// A' = LN(a) rounded through T with LN, else a.  a (m, k), w (k, n), k % 16 == 0.
template <typename T, bool LN, bool RESID>
__global__ void __launch_bounds__(G_THREADS, 2)
ln_gemm_kernel(const T* __restrict__ a, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
               const T* __restrict__ w, const float* __restrict__ bias, const T* __restrict__ resid,
               T* __restrict__ out, int m, int k, int n, float eps) {
  __shared__ __align__(16) float s_a[G_BK * G_LDA];  // [k][row]
  __shared__ __align__(16) float s_b[G_BK * G_BN];   // [k][col]
  __shared__ float s_mean[G_BM];
  __shared__ float s_rstd[G_BM];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * G_BM, n0 = blockIdx.x * G_BN;

  if (LN) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < G_BM; r += G_THREADS / 32) {
      float mean = 0.0f, rstd = 0.0f;
      if (m0 + r < m) row_stats<T>(a + (size_t)(m0 + r) * k, k, eps, lane, mean, rstd);
      if (lane == 0) {
        s_mean[r] = mean;
        s_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  // a thread stages 8 consecutive k of one row of A and 8 strided words of B
  const int a_row = tid >> 1, a_k = (tid & 1) * 8;
  const bool a_in = m0 + a_row < m;
  const T* a_ptr = a + (size_t)(a_in ? m0 + a_row : 0) * k + a_k;
  float a_mean = 0.0f, a_rstd = 0.0f;
  if (LN) {
    a_mean = s_mean[a_row];
    a_rstd = s_rstd[a_row];
  }
  float ra[8], rb[8];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float val = a_in ? to_f32<T>(a_ptr[k0 + j]) : 0.0f;
      if (LN && a_in) {
        const int kk = k0 + a_k + j;
        val = round_to<T>((val - a_mean) * a_rstd * ln_g[kk] + ln_b[kk]);
      }
      ra[j] = val;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = tid + G_THREADS * j;
      const int br = e >> 7, col = n0 + (e & 127);
      rb[j] = col < n ? to_f32<T>(w[(size_t)(k0 + br) * n + col]) : 0.0f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  fetch(0);
  for (int k0 = 0; k0 < k; k0 += G_BK) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s_a[(a_k + j) * G_LDA + a_row] = ra[j];
      s_b[tid + G_THREADS * j] = rb[j];
    }
    __syncthreads();
    if (k0 + G_BK < k) fetch(k0 + G_BK);
#pragma unroll
    for (int kk = 0; kk < G_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(s_a + kk * G_LDA + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(s_a + kk * G_LDA + ty * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(s_b + kk * G_BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(s_b + kk * G_BN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx * 4 + 64 * (j >> 2) + (j & 3);
      if (col >= n) continue;
      const size_t at = (size_t)row * n + col;
      float val = acc[i][j];
      if (RESID) val += to_f32<T>(resid[at]);
      out[at] = from_f32<T>(val + bias[col]);
    }
  }
}

template <typename T, bool LN, bool RESID>
cudaError_t launch_ln_gemm(const T* a, const float* ln_g, const float* ln_b, const T* w, const float* bias,
                           const T* resid, T* out, int m, int k, int n, float eps, cudaStream_t stream) {
  const int rows = (m + G_BM - 1) / G_BM, cols = (n + G_BN - 1) / G_BN;
  if (m < 1 || n < 1 || k < G_BK || k % G_BK || rows > 65535) return cudaErrorInvalidValue;
  ln_gemm_kernel<T, LN, RESID><<<dim3(cols, rows), G_THREADS, 0, stream>>>(a, ln_g, ln_b, w, bias, resid, out,
                                                                          m, k, n, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_block(const T* x, const float* ln_g, const float* ln_b, const T* w_qkv,
                            const float* b_qkv, const T* w_o, const float* b_o, T* qkv, T* heads_out, T* out,
                            int n, int s_len, int d, int heads, float scale, float eps, cudaStream_t stream) {
  if (heads < 1 || d % heads) return cudaErrorInvalidValue;
  const int m = n * s_len, hd = d / heads;
  cudaError_t err = launch_ln_gemm<T, true, false>(x, ln_g, ln_b, w_qkv, b_qkv, nullptr, qkv, m, d, 3 * d, eps,
                                                   stream);
  if (err != cudaSuccess) return err;
  const long long row = 3LL * d;
  err = cvt::attention_core<T>(qkv, qkv + d, qkv + 2 * d, heads_out, n, s_len, heads, hd, scale, s_len * row,
                               row, hd, (long long)s_len * d, d, hd, stream);
  if (err != cudaSuccess) return err;
  return launch_ln_gemm<T, false, true>(heads_out, nullptr, nullptr, w_o, b_o, x, out, m, d, d, eps, stream);
}

// ---------------------------------------------------------------- mlp_block

constexpr int M_BM = 32;        // tokens a block
constexpr int M_HC = 256;       // hidden columns a chunk
constexpr int M_THREADS = 512;
constexpr int M_KT = 32;        // rows of a W1 tile
constexpr int M_TILE = M_KT * M_HC;  // words of the weight tile buffer
constexpr int M_FETCH = M_TILE / M_THREADS;
constexpr int M_LDG = M_HC + 4;

template <int DREP> constexpr size_t mlp_smem_bytes() {
  return sizeof(float) * ((size_t)M_BM * (256 * DREP + 4) + (size_t)M_BM * M_LDG + M_TILE);
}

template <typename T, int DREP>
__global__ void __launch_bounds__(M_THREADS, 1)
mlp_block_kernel(const T* __restrict__ x, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                 const T* __restrict__ w1, const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int m, int dh, float eps) {
  constexpr int D = 256 * DREP;
  constexpr int LDH = D + 4;
  constexpr int KT2 = M_TILE / D >= 8 ? 8 : 4;  // rows of a W2 tile
  constexpr int TILE2 = KT2 * D;
  static_assert(TILE2 <= M_TILE && M_HC % KT2 == 0, "W2 tile");
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem;                 // [M_BM][LDH]   LN(x), rounded through T
  float* s_g = s_h + M_BM * LDH;     // [M_BM][M_LDG] gelu of the chunk, rounded through T
  float* s_w = s_g + M_BM * M_LDG;   // a W1 tile [M_KT][M_HC] or a W2 tile [KT2][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = tid >> 6, cg = tid & 63;
  const int m0 = blockIdx.x * M_BM;

  for (int r = warp; r < M_BM; r += M_THREADS / 32) {
    const int row = m0 + r;
    if (row < m) {
      const T* p = x + (size_t)row * D;
      float mean, rstd;
      row_stats<T>(p, D, eps, lane, mean, rstd);
      for (int c = lane; c < D; c += 32)
        s_h[r * LDH + c] = round_to<T>((to_f32<T>(p[c]) - mean) * rstd * ln_g[c] + ln_b[c]);
    } else {
      for (int c = lane; c < D; c += 32) s_h[r * LDH + c] = 0.0f;
    }
  }
  __syncthreads();

  float acc[4][4 * DREP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * DREP; ++j) acc[i][j] = 0.0f;
  float rw[M_FETCH];

  for (int h0 = 0; h0 < dh; h0 += M_HC) {
    // (a) the chunk's up-projection: hj = LN(x) . w1[:, h0 : h0 + 256]
    float hj[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) hj[i][j] = 0.0f;

    auto fetch1 = [&](int k0) {
#pragma unroll
      for (int j = 0; j < M_FETCH; ++j) {
        const int e = tid + M_THREADS * j;
        rw[j] = to_f32<T>(w1[(size_t)(k0 + (e >> 8)) * dh + h0 + (e & 255)]);
      }
    };
    fetch1(0);
    for (int k0 = 0; k0 < D; k0 += M_KT) {
#pragma unroll
      for (int j = 0; j < M_FETCH; ++j) s_w[tid + M_THREADS * j] = rw[j];
      __syncthreads();
      if (k0 + M_KT < D) fetch1(k0 + M_KT);
#pragma unroll 2
      for (int kk = 0; kk < M_KT; kk += 4) {
        float4 av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(s_h + (rg * 4 + i) * LDH + k0 + kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 bv = *reinterpret_cast<const float4*>(s_w + (kk + c) * M_HC + cg * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ai = c == 0 ? av[i].x : c == 1 ? av[i].y : c == 2 ? av[i].z : av[i].w;
            hj[i][0] += ai * bv.x;
            hj[i][1] += ai * bv.y;
            hj[i][2] += ai * bv.z;
            hj[i][3] += ai * bv.w;
          }
        }
      }
      __syncthreads();
    }

    // (b) bias + gelu, rounded through T.  The chunk before is read to its end
    // (the barrier that closed its last W2 tile); the barrier of the first W2
    // tile below orders these writes before their reads.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s_g[(rg * 4 + i) * M_LDG + cg * 4 + j] = round_to<T>(gelu_erf(hj[i][j] + b1[h0 + cg * 4 + j]));

    // (c) the chunk's share of the down-projection: acc += g . w2[h0 : h0 + 256, :]
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
    for (int k0 = 0; k0 < M_HC; k0 += KT2) {
#pragma unroll
      for (int j = 0; j < M_FETCH; ++j) {
        const int e = tid + M_THREADS * j;
        if (e < TILE2) s_w[e] = rw[j];
      }
      __syncthreads();
      if (k0 + KT2 < M_HC) fetch2(k0 + KT2);
#pragma unroll
      for (int kk = 0; kk < KT2; kk += 4) {
        float4 av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(s_g + (rg * 4 + i) * M_LDG + k0 + kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int rep = 0; rep < DREP; ++rep) {
            const float4 bv = *reinterpret_cast<const float4*>(s_w + (kk + c) * D + rep * 256 + cg * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + rg * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int rep = 0; rep < DREP; ++rep)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = rep * 256 + cg * 4 + j;
        const size_t at = (size_t)row * D + col;
        out[at] = from_f32<T>(to_f32<T>(x[at]) + (acc[i][rep * 4 + j] + b2[col]));
      }
  }
}

template <typename T, int DREP>
cudaError_t launch_mlp_block(const T* x, const float* ln_g, const float* ln_b, const T* w1, const float* b1,
                             const T* w2, const float* b2, T* out, int m, int dh, float eps,
                             cudaStream_t stream) {
  constexpr size_t smem = mlp_smem_bytes<DREP>();
  cudaError_t err = cudaFuncSetAttribute(mlp_block_kernel<T, DREP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  mlp_block_kernel<T, DREP><<<(m + M_BM - 1) / M_BM, M_THREADS, smem, stream>>>(x, ln_g, ln_b, w1, b1, w2, b2,
                                                                               out, m, dh, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mlp_block(const T* x, const float* ln_g, const float* ln_b, const T* w1, const float* b1,
                      const T* w2, const float* b2, T* out, int m, int d, int dh, float eps,
                      cudaStream_t stream) {
  if (m < 1 || dh < M_HC || dh % M_HC) return cudaErrorInvalidValue;
#define CVT_MLP_CASE(DREP)                                                                             \
  case 256 * DREP:                                                                                     \
    return launch_mlp_block<T, DREP>(x, ln_g, ln_b, w1, b1, w2, b2, out, m, dh, eps, stream)
  switch (d) {
    CVT_MLP_CASE(1);
    CVT_MLP_CASE(3);
    CVT_MLP_CASE(4);
    CVT_MLP_CASE(5);
    default:
      return cudaErrorInvalidValue;
  }
#undef CVT_MLP_CASE
}

}  // namespace

extern "C" {

// Both launch on `stream` and return the first failed launch's cudaError_t
// (0 on success); neither synchronises.

int cvt_mlp_block(const void* x, const float* ln_g, const float* ln_b, const void* w1, const float* b1,
                  const void* w2, const float* b2, void* out, int m, int d, int dh, float eps, int is_bf16,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)mlp_block<__nv_bfloat16>((const __nv_bfloat16*)x, ln_g, ln_b, (const __nv_bfloat16*)w1, b1,
                                         (const __nv_bfloat16*)w2, b2, (__nv_bfloat16*)out, m, d, dh, eps, st);
  return (int)mlp_block<float>((const float*)x, ln_g, ln_b, (const float*)w1, b1, (const float*)w2, b2,
                               (float*)out, m, d, dh, eps, st);
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
