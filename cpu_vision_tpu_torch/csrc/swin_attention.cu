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
// ln_gemm.cuh and tf32x3.cuh:
//   (0) v1: LN(x) rounded to T, a warp a row (ln_rows_kernel);
//   (1) QKV product + bias into an (nw S, 3 C) buffer of f32 (f32, not T:
//       v1 scales q and v2 normalises q and k before the cast), of (0)'s rows
//       (v1) or of x (v2): bf16 tc_gemm_kernel (wgmma), float32
//       x3_gemm_kernel (split TF32 on wgmma, launch_x3_rows of tf32x3.cuh);
//   (2) the window core, one block a (window, head), the windows on
//       gridDim.x: it stages the head's q, k, v (S x 32 each) in shared
//       memory by strides out of that buffer, computes all S x S scores as
//       one tile (64 keys at most, so no streaming softmax), adds bias and
//       mask, masks keys >= S with -inf, takes the softmax, multiplies by v
//       and writes the joined heads as (nw S, C) of T: window_core_kernel,
//       scalar f32 FMAs, in float32; window_tc_kernel, wgmma, in bf16 (below);
//   (3) v1: output projection + bias + residual into out.
//       v2: output projection + bias into an (nw S, C) buffer of f32, then
//   (4) v2: LayerNorm of each branch row + residual, a warp a row
//       (ln_residual_kernel of ln_gemm.cuh).
// Four launches in either type, v1 or v2.  The QKV buffer
// (12 C bytes a token), the joined heads, v2's branch rows and the LN rows
// are the intermediates that now touch device memory, each written once and
// read once; the TPU kernels keep them in VMEM.  The mask holds -100, not
// -inf: a fully masked row is still a softmax over its keys.
//
// Bound.  Operations: 8 C^2 a token for the two projections and
// S (4 hd + 5) a token and head for the core; at Swin-T's first stage
// (802,816 tokens, C 96) 59 GFLOP + 30 GFLOP against 308 MB of x and out in
// bf16.  The intermediates add 2.16 GB there: traffic of this split into
// launches, not of the function, so no part of its bound.  The products run
// on the tensor cores in either type (float32 by split TF32); the core on
// them in bf16, as scalar f32 FMAs in float32.
//
// The bf16 core (window_tc_kernel).  At Swin-T's first stage it reads 925 MB
// of the f32 QKV buffer and writes 154 MB of joined heads, 0.32 ms at the
// memory rate, against 15.7 GFLOP: bytes bind it, and with 49,152 (window,
// head) pairs of 49 tokens each pair's fixed cost, not its arithmetic, sets
// the pace.  One warpgroup (128 threads) a pair; thread t stages half a row
// (16 head dims) of q, k and v of token t / 2 with float4 reads, rounds them
// as the scalar core does (v1: q * scale and k; v2: q / |q| and k / |k|, the
// norm's sum over the thread pair by one shuffle; v), and stores them as bf16
// in the 64-byte swizzle (hd 32 makes 64-byte rows), rows >= S as zeros.
// S = Q K^T is two wgmma m64n64k16 (A = Q, B = K, both K-major); v2 scales,
// bias and mask are added in the accumulator layout (thread 32 w + l: rows
// 16 w + l / 4 and + 8, keys 8 j + 2 (l % 4) + e), keys >= S set to -inf,
// and the softmax normalises before it rounds to bf16, by one reciprocal of
// each row's sum and a product (within an f32 step of the quotient): the
// shift mask's -100 leaves probabilities near e^-100, f32 denormals, on
// which each IEEE division took its slow path, 1.38x the core's time at
// Swin-T's first stage (tools/torch_attention_core_ab.py).  P V is four
// wgmma m64n32k16 with the probabilities as A from registers and V as B,
// MN-major.  Rows < S of the joined heads are stored in pairs.  One pair a
// block: several a block, the next pair's rows copied with cp.async while
// one is computed, ran slower (fewer pairs in flight an SM).

#include "ln_gemm.cuh"
#include "tf32x3.cuh"

namespace {

using cvt::bf16;
using cvt::from_f32;
using cvt::launch_ln_residual;
using cvt::launch_ln_rows;
using cvt::launch_tc_gemm;
using cvt::launch_x3_rows;
using cvt::ResidEpi;
using cvt::round_to;
using cvt::TC_BIAS;
using cvt::TC_RESID;

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

constexpr int WT_THREADS = 128;  // one warpgroup a (window, head)
constexpr int WT_TILE = W_S * 64;   // bytes of a 64 x 32 bf16 tile
constexpr size_t WT_SMEM = 3 * WT_TILE + 1024;  // Q, K, V; + room to align

// 16 values rounded to bf16 as two 16-byte chunks of row r of a 64-byte swizzled tile at generic address tile:
// chunk c of row r at r * 64 + (c ^ r / 2 % 4) * 16
__device__ __forceinline__ void store_half_row(char* tile, int r, int half, const float (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = 2 * half + i;
    uint4 u;
    u.x = cvt::pack_bf16(x[8 * i + 0], x[8 * i + 1]);
    u.y = cvt::pack_bf16(x[8 * i + 2], x[8 * i + 3]);
    u.z = cvt::pack_bf16(x[8 * i + 4], x[8 * i + 5]);
    u.w = cvt::pack_bf16(x[8 * i + 6], x[8 * i + 7]);
    *reinterpret_cast<uint4*>(tile + r * 64 + ((c ^ ((r >> 1) & 3)) << 4)) = u;
  }
}

__global__ void __launch_bounds__(WT_THREADS)
window_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_bias, const float* __restrict__ mask,
                 const float* __restrict__ logit_scale, bf16* __restrict__ joined, int s_len, int c, int heads,
                 int nw_img, float scale, int v2) {
  constexpr int HD = 32;
  extern __shared__ __align__(16) float smem[];
  const uint32_t s_q = (cvt::smem_addr(smem) + 1023u) & ~1023u, s_k = s_q + WT_TILE, s_v = s_k + WT_TILE;
  char* tiles = reinterpret_cast<char*>(smem) + (s_q - cvt::smem_addr(smem));  // s_q as a generic address

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int win = blockIdx.x / heads, head = blockIdx.x - win * heads;
  const size_t row_words = (size_t)3 * c;

  // staging: thread t owns head dims 16 (t % 2) .. + 15 of token t / 2 in q, k and v
  {
    const int r = tid >> 1, half = tid & 1;
    float qv[16], kv[16], vv[16];
    if (r < s_len) {
      const float* p = qkv + ((size_t)win * s_len + r) * row_words + head * HD + 16 * half;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(p + 4 * i);
        const float4 b = *reinterpret_cast<const float4*>(p + c + 4 * i);
        const float4 d = *reinterpret_cast<const float4*>(p + 2 * c + 4 * i);
        qv[4 * i] = a.x, qv[4 * i + 1] = a.y, qv[4 * i + 2] = a.z, qv[4 * i + 3] = a.w;
        kv[4 * i] = b.x, kv[4 * i + 1] = b.y, kv[4 * i + 2] = b.z, kv[4 * i + 3] = b.w;
        vv[4 * i] = d.x, vv[4 * i + 1] = d.y, vv[4 * i + 2] = d.z, vv[4 * i + 3] = d.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) qv[i] = kv[i] = vv[i] = 0.0f;
    }
    float q_mul = scale, k_mul = 1.0f;
    if (v2) {  // cosine attention: the row's sum of squares over the thread pair
      float qs = 0.0f, ks = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        qs += qv[i] * qv[i];
        ks += kv[i] * kv[i];
      }
      qs += __shfl_xor_sync(0xffffffffu, qs, 1);
      ks += __shfl_xor_sync(0xffffffffu, ks, 1);
      q_mul = rsqrtf(fmaxf(qs, 1e-12f));
      k_mul = rsqrtf(fmaxf(ks, 1e-12f));
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      qv[i] *= q_mul;
      kv[i] *= k_mul;
    }
    store_half_row(tiles, r, half, qv);
    store_half_row(tiles + WT_TILE, r, half, kv);
    store_half_row(tiles + 2 * WT_TILE, r, half, vv);
  }
  cvt::fence_proxy_async();  // the generic stores before wgmma's reads
  __syncthreads();

  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  cvt::wgmma_fence();
#pragma unroll
  for (int s = 0; s < HD / 16; ++s)
    cvt::wgmma_m64n64k16_ss_kk(sc, cvt::sw64_desc(s_q + s * 32, 16, 512), cvt::sw64_desc(s_k + s * 32, 16, 512));
  cvt::wgmma_commit();
  cvt::wgmma_wait<0>();
  cvt::fence_sums(sc);

  const float ls = v2 ? expf(fminf(logit_scale[head], 4.605170185988092f)) : 1.0f;  // ln 100
  const float* bias_h = rel_bias + (size_t)head * s_len * s_len;
  const float* mask_w = mask != nullptr ? mask + (size_t)(win % nw_img) * s_len * s_len : nullptr;
  const int key0 = 2 * (lane & 3);
  uint32_t pa[16];  // pa[i] = bf16 (p[2 i], p[2 i + 1]): the A fragment of k16 step s is pa[4 s .. 4 s + 3]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + (lane >> 2) + 8 * h;
    const bool row_in = row < s_len;  // rows past S are computed on zeros and not stored
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + e;
        float& val = sc[4 * j + 2 * h + e];
        if (key < s_len) {
          if (v2) val *= ls;
          if (row_in) {
            val += bias_h[row * s_len + key];
            if (mask_w != nullptr) val += mask_w[row * s_len + key];
          }
        } else {
          val = -INFINITY;
        }
        mx = fmaxf(mx, val);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // key 0 is always real, so mx is finite
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& val = sc[4 * j + 2 * h + e];
        val = expf(val - mx);
        sum += val;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.0f / sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) pa[2 * j + h] = cvt::pack_bf16(sc[4 * j + 2 * h] * inv, sc[4 * j + 2 * h + 1] * inv);
  }

  float o_acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o_acc[i] = 0.0f;
  cvt::wgmma_fence();  // after writing pa, before the products read it
#pragma unroll
  for (int s = 0; s < W_S / 16; ++s) cvt::wgmma_m64n32k16_rs(o_acc, pa + 4 * s, cvt::sw64_desc(s_v + s * 1024, 4096, 512));
  cvt::wgmma_commit();
  cvt::wgmma_wait<0>();
  cvt::fence_sums(o_acc);

  bf16* ob = joined + (size_t)win * s_len * c + head * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + (lane >> 2) + 8 * h;
    if (row >= s_len) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      cvt::store2(ob + (size_t)row * c + 8 * j + 2 * (lane & 3), o_acc[4 * j + 2 * h], o_acc[4 * j + 2 * h + 1]);
  }
}

// the window core: wgmma in bf16, scalar f32 FMAs in float32
cudaError_t window_core(const float* qkv, const float* rel_bias, const float* mask, const float* logit_scale,
                        float* joined, int nw, int s_len, int c, int heads, int nw_img, float scale, int v2,
                        cudaStream_t stream) {
  window_core_kernel<float, 32><<<nw * heads, W_THREADS, window_smem_bytes<32>(), stream>>>(
      qkv, rel_bias, mask, logit_scale, joined, s_len, c, heads, nw_img, scale, v2);
  return cudaGetLastError();
}

cudaError_t window_core(const float* qkv, const float* rel_bias, const float* mask, const float* logit_scale,
                        bf16* joined, int nw, int s_len, int c, int heads, int nw_img, float scale, int v2,
                        cudaStream_t stream) {
  window_tc_kernel<<<nw * heads, WT_THREADS, WT_SMEM, stream>>>(qkv, rel_bias, mask, logit_scale, joined, s_len, c,
                                                               heads, nw_img, scale, v2);
  return cudaGetLastError();
}

// The products of window_attention_block in T: QKV (f32 out, of LN(x) for
// v1, of x for v2) and the output projection (+ residual into out for v1,
// f32 branch for v2).  ln_buf: scratch of m c values of T (v1 only).
cudaError_t qkv_product(const float* x, const float* ln_g, const float* ln_b, const float* w_qkv, const float* b_qkv,
                        float* qkv, float* ln_buf, int m, int c, float eps, int v2, int ln_count, cudaStream_t stream) {
  if (!v2) {
    cudaError_t err = launch_ln_rows<float>(x, ln_g, ln_b, ln_buf, m, c, eps, ln_count, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_x3_rows(v2 ? x : ln_buf, w_qkv, m, 3 * c, c, ResidEpi{b_qkv, nullptr, nullptr, qkv, 3 * c}, stream);
}

cudaError_t qkv_product(const bf16* x, const float* ln_g, const float* ln_b, const bf16* w_qkv, const float* b_qkv,
                        float* qkv, bf16* ln_buf, int m, int c, float eps, int v2, int ln_count, cudaStream_t stream) {
  if (!v2) {
    cudaError_t err = launch_ln_rows<bf16>(x, ln_g, ln_b, ln_buf, m, c, eps, ln_count, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_tc_gemm<TC_BIAS, float>(v2 ? x : ln_buf, w_qkv, b_qkv, nullptr, nullptr, qkv, m, c, 3 * c, stream);
}

cudaError_t out_product(const float* joined, const float* w_o, const float* b_o, const float* x, float* out,
                        float* branch, int m, int c, float, int v2, cudaStream_t stream) {
  return v2 ? launch_x3_rows(joined, w_o, m, c, c, ResidEpi{b_o, nullptr, nullptr, branch, c}, stream)
            : launch_x3_rows(joined, w_o, m, c, c, ResidEpi{b_o, x, nullptr, out, c}, stream);
}

cudaError_t out_product(const bf16* joined, const bf16* w_o, const float* b_o, const bf16* x, bf16* out,
                        float* branch, int m, int c, float, int v2, cudaStream_t stream) {
  return v2 ? launch_tc_gemm<TC_BIAS, float>(joined, w_o, b_o, nullptr, nullptr, branch, m, c, c, stream)
            : launch_tc_gemm<TC_RESID, bf16>(joined, w_o, b_o, x, nullptr, out, m, c, c, stream);
}

template <typename T>
cudaError_t window_attention_block(const T* x, const float* ln_g, const float* ln_b, const T* w_qkv,
                                   const float* b_qkv, const T* w_o, const float* b_o, const float* rel_bias,
                                   const float* mask, const float* logit_scale, float* qkv, T* joined,
                                   float* branch, T* ln_buf, T* out, int nw, int s_len, int c, int heads, int nw_img,
                                   float scale, float eps, int v2, int ln_count, cudaStream_t stream) {
  constexpr int HD = 32;
  if (nw < 1 || s_len < 1 || s_len > W_S || heads < 1 || c != heads * HD || nw_img < 1 ||
      (long long)nw * heads > 2147483647LL || (long long)nw * s_len > 2147483647LL)
    return cudaErrorInvalidValue;
  const int m = nw * s_len;
  cudaError_t err = qkv_product(x, ln_g, ln_b, w_qkv, b_qkv, qkv, ln_buf, m, c, eps, v2, ln_count, stream);
  if (err != cudaSuccess) return err;
  err = window_core(qkv, rel_bias, mask, logit_scale, joined, nw, s_len, c, heads, nw_img, scale, v2, stream);
  if (err != cudaSuccess) return err;
  err = out_product(joined, w_o, b_o, x, out, branch, m, c, eps, v2, stream);
  if (err != cudaSuccess || !v2) return err;
  return launch_ln_residual<T>(branch, x, ln_g, ln_b, out, m, c, eps, ln_count, stream);
}

}  // namespace

extern "C" {

// x and out are (nw, s_len, c) of T; qkv is scratch of nw * s_len * 3 c
// floats, joined of nw * s_len * c values of T, branch (v2 only, else unused)
// of nw * s_len * c floats, ln_buf (v1 only, else unused) of nw * s_len * c
// values of T.  mask (nw_img, s, s) and logit_scale (heads) may
// be null (logit_scale only for v1).  Launches on `stream` and returns the
// first failed launch's cudaError_t (0 on success); does not synchronise.
int cvt_window_attention_block(const void* x, const float* ln_g, const float* ln_b, const void* w_qkv,
                               const float* b_qkv, const void* w_o, const float* b_o, const float* rel_bias,
                               const float* mask, const float* logit_scale, float* qkv, void* joined,
                               float* branch, void* ln_buf, void* out, int nw, int s_len, int c, int heads,
                               int nw_img, float scale, float eps, int v2, int ln_count, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (v2 && logit_scale == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)window_attention_block<bf16>((const bf16*)x, ln_g, ln_b, (const bf16*)w_qkv, b_qkv,
                                             (const bf16*)w_o, b_o, rel_bias, mask, logit_scale, qkv, (bf16*)joined,
                                             branch, (bf16*)ln_buf, (bf16*)out, nw, s_len, c, heads, nw_img, scale,
                                             eps, v2, ln_count, st);
  return (int)window_attention_block<float>((const float*)x, ln_g, ln_b, (const float*)w_qkv, b_qkv,
                                            (const float*)w_o, b_o, rel_bias, mask, logit_scale, qkv, (float*)joined,
                                            branch, (float*)ln_buf, (float*)out, nw, s_len, c, heads, nw_img, scale,
                                            eps, v2, ln_count, st);
}

}  // extern "C"
