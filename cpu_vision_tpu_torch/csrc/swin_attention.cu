// The attention sub-block of a Swin block over a batch of windows for Hopper
// (sm_90a), bound with ctypes:
//
//   cvt_window_attention_block
//     v1:  out = x + Wo WindowMSA(Wqkv LN(x) + bqkv) + bo
//     v2:  out = x + LN(Wo WindowMSA(Wqkv x + bqkv) + bo)
//
// with, per window w and head h, over the S <= 64 tokens of the window:
//   v1 scores = (q * scale) k^T                      + rel_bias[h] + mask[w mod nw_img]
//   v2 scores = (q/|q|) (k/|k|)^T * exp(min(ls[h], ln 100)) + rel_bias[h] + mask[w mod nw_img]
// and a float32 softmax over the keys of that head alone.
//
// It replaces the two Pallas TPU kernels of
// cpu_vision_tpu/ops/pallas/swin_attention.py: _fwd_pallas :234 (pallas_call
// at :282, one head at a time) and _fwd_pallas_packed :308 (pallas_call at
// :344, all heads of a window packed into one chain of products for the
// TPU's matrix unit), both reached through window_attention_block :411.  The
// packing (block masks, key padding with -1e9, window groups) serves that
// matrix unit and is not carried over: this is one function, per head, with a
// row maximum per head.
//
// Types.  x, the weights and the output share one storage type T (float or
// bf16); LayerNorm parameters, biases, rel_bias, mask and logit_scale are
// f32.  LayerNorm, the norms of q and k, softmax and every sum are f32; a
// value is rounded through T where the TPU kernel casts to the weight type:
// after LN, q * scale (v1) or q/|q| and k/|k| (v2), k, v, the probabilities
// (after the division by their sum), the joined heads.
//
// Launches.  A window's f32 QKV product at C = 768 is 451 KB and a block has
// 227 KB, and the output projection sums over heads; so, like
// attention_block, it is a chain of launches, all written here or in
// ln_gemm.cuh:
//   (1) LN (v1 only) + QKV product + bias into an (nw S, 3 C) buffer of f32
//       (f32, not T: v1 scales q and v2 normalises q and k before the cast);
//   (2) the window core, one block a (window, head), the windows on
//       gridDim.x: it stages the head's q, k, v (S x 32 each) in shared
//       memory by strides out of that buffer, computes all S x S scores as
//       one tile (64 keys at most, so no streaming softmax), adds bias and
//       mask, masks keys >= S with -inf, takes the softmax, multiplies by v
//       and writes the joined heads as (nw S, C) of T;
//   (3) v1: output projection + bias + residual into out.
//       v2: output projection + bias into an (nw S, C) buffer of f32, then
//   (4) v2: LayerNorm of each branch row + residual, a warp a row.
// Three launches for v1, four for v2.  The QKV buffer (12 C bytes a token),
// the joined heads and v2's branch rows are the intermediates that now touch
// device memory, each written once and read once; the TPU kernels keep them
// in VMEM.  The mask holds -100, not -inf: a fully masked row is still a
// softmax over its keys.
//
// Bound.  Operations: 8 C^2 a token for the two projections and
// S (4 hd + 5) a token and head for the core; at Swin-T's first stage
// (802,816 tokens, C 96) 59 GFLOP + 30 GFLOP against 308 MB of x and out in
// bf16.  The intermediates add 2.16 GB there: traffic of this split into
// launches, not of the function, so no part of its bound.  Scalar f32 FMAs
// for both types: no mma.

#include "ln_gemm.cuh"

namespace {

using cvt::from_f32;
using cvt::launch_ln_gemm;
using cvt::round_to;
using cvt::row_stats;
using cvt::to_f32;

constexpr int W_S = 64;  // most tokens a window
constexpr int W_THREADS = 256;
constexpr int W_LDP = W_S + 4;

template <int HD> constexpr size_t window_smem_bytes() {
  return sizeof(float) * ((size_t)3 * W_S * (HD + 4) + (size_t)W_S * W_LDP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(W_THREADS)
window_core_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_bias,
                   const float* __restrict__ mask, const float* __restrict__ logit_scale,
                   T* __restrict__ joined, int s_len, int c, int heads, int nw_img, float scale, int v2) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;  // head dims a thread owns
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;               // [W_S][LD]
  float* s_k = s_q + W_S * LD;     // [W_S][LD]
  float* s_v = s_k + W_S * LD;     // [W_S][LD]
  float* s_p = s_v + W_S * LD;     // [W_S][W_LDP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int win = blockIdx.x / heads, head = blockIdx.x - win * heads;
  const size_t row_words = (size_t)3 * c;
  const float* base = qkv + (size_t)win * s_len * row_words + head * HD;

  for (int e = tid; e < W_S * HD; e += W_THREADS) {
    const int r = e / HD, d = e - r * HD;
    float qv = 0.0f, kv = 0.0f, vv = 0.0f;
    if (r < s_len) {
      const float* p = base + r * row_words + d;
      qv = p[0];
      kv = p[c];
      vv = p[2 * c];
    }
    if (!v2) {
      qv = round_to<T>(qv * scale);
      kv = round_to<T>(kv);
    }
    s_q[r * LD + d] = qv;
    s_k[r * LD + d] = kv;
    s_v[r * LD + d] = round_to<T>(vv);
  }
  if (v2) {
    // cosine attention: a thread normalises one row of q or of k
    __syncthreads();
    if (tid < 2 * W_S) {
      float* p = (tid < W_S ? s_q : s_k) + (tid & (W_S - 1)) * LD;
      float ss = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; ++d) ss += p[d] * p[d];
      const float inv = rsqrtf(fmaxf(ss, 1e-12f));
#pragma unroll
      for (int d = 0; d < HD; ++d) p[d] = round_to<T>(p[d] * inv);
    }
  }
  __syncthreads();

  float sc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qa[4], ka[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(s_q + (4 * ty + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) ka[j] = *reinterpret_cast<const float4*>(s_k + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] += qa[i].x * ka[j].x;
        sc[i][j] += qa[i].y * ka[j].y;
        sc[i][j] += qa[i].z * ka[j].z;
        sc[i][j] += qa[i].w * ka[j].w;
      }
  }

  const float ls = v2 ? expf(fminf(logit_scale[head], 4.605170185988092f)) : 1.0f;  // ln 100
  const float* bias_h = rel_bias + (size_t)head * s_len * s_len;
  const float* mask_w = mask != nullptr ? mask + (size_t)(win % nw_img) * s_len * s_len : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
    const bool row_in = row < s_len;  // rows past S are computed on zeros and not stored
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tx + 16 * j;
      float val = -INFINITY;
      if (key < s_len) {
        val = v2 ? sc[i][j] * ls : sc[i][j];
        if (row_in) {
          val += bias_h[row * s_len + key];
          if (mask_w != nullptr) val += mask_w[row * s_len + key];
        }
      }
      sc[i][j] = val;
      mx = fmaxf(mx, val);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // key 0 is always real, so mx is finite
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[i][j] = expf(sc[i][j] - mx);
      sum += sc[i][j];
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int j = 0; j < 4; ++j) s_p[row * W_LDP + tx + 16 * j] = round_to<T>(sc[i][j] / sum);
  }
  __syncthreads();

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < W_S; kk += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(s_p + (4 * ty + i) * W_LDP + kk);
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const float v0 = s_v[(kk + 0) * LD + tx + 16 * e];
      const float v1 = s_v[(kk + 1) * LD + tx + 16 * e];
      const float v2_ = s_v[(kk + 2) * LD + tx + 16 * e];
      const float v3 = s_v[(kk + 3) * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][e] += pa[i].x * v0;
        acc[i][e] += pa[i].y * v1;
        acc[i][e] += pa[i].z * v2_;
        acc[i][e] += pa[i].w * v3;
      }
    }
  }

  T* ob = joined + (size_t)win * s_len * c + head * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
    if (row >= s_len) continue;
#pragma unroll
    for (int e = 0; e < DPT; ++e) ob[(size_t)row * c + tx + 16 * e] = from_f32<T>(acc[i][e]);
  }
}

// out[r, :] = x[r, :] + LN(branch[r, :]), a warp a row (v2's post-norm)
template <typename T>
__global__ void __launch_bounds__(W_THREADS)
ln_residual_kernel(const float* __restrict__ branch, const T* __restrict__ x, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, T* __restrict__ out, int m, int c, float eps, int ln_count) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (W_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= m) return;
  const float* p = branch + (size_t)row * c;
  float mean, rstd;
  row_stats<float>(p, c, eps, ln_count, lane, mean, rstd);
  for (int col = lane; col < c; col += 32) {
    const size_t at = (size_t)row * c + col;
    out[at] = from_f32<T>(to_f32<T>(x[at]) + ((p[col] - mean) * rstd * ln_g[col] + ln_b[col]));
  }
}

template <typename T>
cudaError_t window_attention_block(const T* x, const float* ln_g, const float* ln_b, const T* w_qkv,
                                   const float* b_qkv, const T* w_o, const float* b_o, const float* rel_bias,
                                   const float* mask, const float* logit_scale, float* qkv, T* joined,
                                   float* branch, T* out, int nw, int s_len, int c, int heads, int nw_img,
                                   float scale, float eps, int v2, int ln_count, cudaStream_t stream) {
  constexpr int HD = 32;
  if (nw < 1 || s_len < 1 || s_len > W_S || heads < 1 || c != heads * HD || nw_img < 1 ||
      (long long)nw * heads > 2147483647LL || (long long)nw * s_len > 2147483647LL)
    return cudaErrorInvalidValue;
  const int m = nw * s_len;
  cudaError_t err =
      v2 ? launch_ln_gemm<T, float, false, false>(x, nullptr, nullptr, w_qkv, b_qkv, nullptr, qkv, m, c, 3 * c,
                                                  eps, 0, stream)
         : launch_ln_gemm<T, float, true, false>(x, ln_g, ln_b, w_qkv, b_qkv, nullptr, qkv, m, c, 3 * c, eps,
                                                 ln_count, stream);
  if (err != cudaSuccess) return err;
  window_core_kernel<T, HD><<<nw * heads, W_THREADS, window_smem_bytes<HD>(), stream>>>(
      qkv, rel_bias, mask, logit_scale, joined, s_len, c, heads, nw_img, scale, v2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!v2) return launch_ln_gemm<T, T, false, true>(joined, nullptr, nullptr, w_o, b_o, x, out, m, c, c, eps, 0, stream);
  err = launch_ln_gemm<T, float, false, false>(joined, nullptr, nullptr, w_o, b_o, nullptr, branch, m, c, c, eps,
                                               0, stream);
  if (err != cudaSuccess) return err;
  const int rows_a_block = W_THREADS / 32;
  ln_residual_kernel<T><<<(m + rows_a_block - 1) / rows_a_block, W_THREADS, 0, stream>>>(branch, x, ln_g, ln_b, out,
                                                                                       m, c, eps, ln_count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x and out are (nw, s_len, c) of T; qkv is scratch of nw * s_len * 3 c
// floats, joined of nw * s_len * c values of T, branch (v2 only, else unused)
// of nw * s_len * c floats.  mask (nw_img, s, s) and logit_scale (heads) may
// be null (logit_scale only for v1).  Launches on `stream` and returns the
// first failed launch's cudaError_t (0 on success); does not synchronise.
int cvt_window_attention_block(const void* x, const float* ln_g, const float* ln_b, const void* w_qkv,
                               const float* b_qkv, const void* w_o, const float* b_o, const float* rel_bias,
                               const float* mask, const float* logit_scale, float* qkv, void* joined,
                               float* branch, void* out, int nw, int s_len, int c, int heads, int nw_img,
                               float scale, float eps, int v2, int ln_count, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (v2 && logit_scale == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)window_attention_block<__nv_bfloat16>(
        (const __nv_bfloat16*)x, ln_g, ln_b, (const __nv_bfloat16*)w_qkv, b_qkv, (const __nv_bfloat16*)w_o, b_o,
        rel_bias, mask, logit_scale, qkv, (__nv_bfloat16*)joined, branch, (__nv_bfloat16*)out, nw, s_len, c, heads,
        nw_img, scale, eps, v2, ln_count, st);
  return (int)window_attention_block<float>((const float*)x, ln_g, ln_b, (const float*)w_qkv, b_qkv,
                                            (const float*)w_o, b_o, rel_bias, mask, logit_scale, qkv,
                                            (float*)joined, branch, (float*)out, nw, s_len, c, heads, nw_img,
                                            scale, eps, v2, ln_count, st);
}

}  // extern "C"
