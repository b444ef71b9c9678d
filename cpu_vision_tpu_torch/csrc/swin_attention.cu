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
//       bf16 v2 takes its q and k columns in a second launch, in float64
//       (qkv_f64_kernel, below);
//   (2) the window core, one block a (window, head), the windows on
//       gridDim.x: it stages the head's q, k, v (S x 32 each) in shared
//       memory by strides out of that buffer, computes all S x S scores as
//       one tile (64 keys at most, so no streaming softmax), adds bias and
//       mask, masks keys >= S with -inf, takes the softmax, multiplies by v
//       and writes the joined heads as (nw S, C) of T: window_x3_kernel,
//       split TF32 on wgmma, in float32; window_tc_kernel, wgmma, in bf16
//       (both below);
//   (3) v1: output projection + bias + residual into out.
//       v2: output projection + bias into an (nw S, C) buffer of f32, then
//   (4) v2: LayerNorm of each branch row + residual, a warp a row
//       (ln_residual_kernel of ln_gemm.cuh).
// Four launches in either type, v1 or v2, five in bf16 v2.  The QKV buffer
// (12 C bytes a token), the joined heads, v2's branch rows and the LN rows
// are the intermediates that now touch device memory, each written once and
// read once; the TPU kernels keep them in VMEM.  The mask holds -100, not
// -inf: a fully masked row is still a softmax over its keys.
//
// Bound.  Operations: 8 C^2 a token for the two projections and
// S (4 hd + 5) a token and head for the core; at Swin-T's first stage
// (802,816 tokens, C 96) 59 GFLOP + 30 GFLOP against 308 MB of x and out in
// bf16.  The intermediates add 2.16 GB there: traffic of this split into
// launches, not of the function, so no part of its bound.  The products and
// the core run on the tensor cores in either type (float32 by split TF32,
// tf32x3.cuh).
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
//
// The float32 core (window_x3_kernel).  At Swin-T's first stage it reads the
// same 925 MB and writes 308 MB of f32 joined heads, 0.37 ms at the memory
// rate, against 47 GFLOP of tf32 products (3 x 15.7), 0.10 ms at 495 TFLOP/s:
// bytes bind it.  The scalar core it replaced multiplied f32 FMAs out of
// shared memory on a tile padded to 64 tokens and divided each probability
// by its sum, an IEEE division that took its slow path on the denormals the
// shift mask leaves (4.6x its bound).  Here one warpgroup a pair, as the bf16
// core: thread t stages half a row of q, k and v of token t / 2 (float4
// reads, v1's scale or v2's norms by one shuffle, rows >= S zero); Q is
// stored as it will be multiplied (64 x 32 f32, K-major, 128-byte swizzle)
// and read back as this thread's tf32 A fragments, split hi and lo in
// registers; K hi and lo are stored K-major in the same swizzle; V is
// transposed and split while it is stored, V^T hi and lo as rows of head
// dims with the keys of each group of 8 at ax_key_column's places.  Every lo
// half is rounded to tf32 (an unbiased rest; the tensor cores would truncate
// it).  The tensor cores sum a chain of wgmma by truncation, each k8 step
// rounding toward zero at the chain's magnitude, so no chain of the large
// terms is longer than two k8 steps: S = Q K^T and P V run by halves of the
// 64 keys (wgmma m64n32k8), a half's hi hi products as two chains of two k8
// steps and its products with a lo half (2^-11 of them) as a third (P V's
// over both halves), each added to sums set to zero in registers, the
// chains added in registers.  Chains of twelve, as the flash core takes,
// stood up to 2.7x further from float64 than the twin at Swin-T's first
// stage, past the 2x the checks allow (PERF.md).  A half at a time
// keeps 80 registers of fragments and sums in flight, and ptxas still
// serialises the products at 128 registers a thread; at 168 (3 blocks an SM)
// it does not, and the core ran no faster.  The sums start from explicit
// zeros, not from scale_d 0: with undefined sums in the unrolled halves the
// card returned near-zero products that the emulator did not show.  rel_bias
// + mask of a thread's 32 scores are read in one loop, all loads in flight at
// once.  The softmax is taken in the accumulator layout, p = exp(s - m)
// unnormalised: each output row is scaled by one reciprocal of its sum at
// the end, 32 products a row in place of 64 divisions.  P is split into A
// fragments where it was computed (no round trip through shared memory).
// Rows < S are stored in pairs.  No atomics: every call gives the same bits.

#include "ln_gemm.cuh"
#include "tf32x3.cuh"

namespace {

using cvt::bf16;
using cvt::launch_ln_residual;
using cvt::launch_ln_rows;
using cvt::launch_tc_gemm;
using cvt::launch_x3_rows;
using cvt::ResidEpi;
using cvt::TC_BIAS;
using cvt::TC_RESID;

constexpr int W_S = 64;  // most tokens a window

constexpr int WX_THREADS = 128;   // one warpgroup a (window, head)
constexpr int WX_MIN_BLOCKS = 4;  // blocks an SM the registers must allow (at most 128 registers a thread)
constexpr int WX_TILE = W_S * 128;  // bytes of a 64 x 32 f32 tile of 128-byte rows
// shared memory: Q as read, K hi, K lo (64 keys x 32 head dims each), V^T hi, V^T lo (32 head dims x 64 keys, two
// halves of 32 keys, 4 KB each); + room to align
constexpr size_t WX_SMEM = 5 * (size_t)WX_TILE + 1024;  // 41 KB: no opt-in past 48 KB

using WxRawQ = cvt::X3RawA<true, W_S, WX_THREADS>;  // Q: 64 rows x 32 head dims, K-major, read as A fragments

__global__ void __launch_bounds__(WX_THREADS, WX_MIN_BLOCKS)
window_x3_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_bias, const float* __restrict__ mask,
                 const float* __restrict__ logit_scale, float* __restrict__ joined, int s_len, int c, int heads,
                 int nw_img, float scale, int v2) {
  constexpr int HD = 32;
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = (cvt::smem_addr(smem) + 1023u) & ~1023u;
  char* const tiles = reinterpret_cast<char*>(smem) + (base - cvt::smem_addr(smem));  // base as a generic address
  const uint32_t k_hi = base + WX_TILE, k_lo = k_hi + WX_TILE, v_hi = k_lo + WX_TILE, v_lo = v_hi + WX_TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int win = blockIdx.x / heads, head = blockIdx.x - win * heads;
  const size_t row_words = (size_t)3 * c;
  auto split = [](float v, float& hi, float& lo) {  // lo rounded to tf32 too: an unbiased rest
    cvt::split_tf32(v, hi, lo);
    lo = cvt::tf32_rna(lo);
  };

  // staging: thread t owns head dims 16 (t % 2) .. + 15 of token t / 2 in q, k and v; rows >= S are zeros
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
    // Q as it will be multiplied (split when read back as A fragments); K split, K-major
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = cvt::kmajor_at(r, 16 * half + 4 * i);
      float4 h, l;
      split(kv[4 * i] * k_mul, h.x, l.x);
      split(kv[4 * i + 1] * k_mul, h.y, l.y);
      split(kv[4 * i + 2] * k_mul, h.z, l.z);
      split(kv[4 * i + 3] * k_mul, h.w, l.w);
      *reinterpret_cast<float4*>(tiles + at) =
          make_float4(qv[4 * i] * q_mul, qv[4 * i + 1] * q_mul, qv[4 * i + 2] * q_mul, qv[4 * i + 3] * q_mul);
      *reinterpret_cast<float4*>(tiles + (k_hi - base) + at) = h;
      *reinterpret_cast<float4*>(tiles + (k_lo - base) + at) = l;
    }
    // V transposed and split: V^T's row d holds head dim d of the keys of its half, key r at its permuted column
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = 16 * half + i;
      const int at = (r >> 5) * (WX_TILE / 2) + cvt::kmajor_at(d, cvt::ax_key_column(r) & 31);
      float h, l;
      split(vv[i], h, l);
      *reinterpret_cast<float*>(tiles + (v_hi - base) + at) = h;
      *reinterpret_cast<float*>(tiles + (v_lo - base) + at) = l;
    }
  }
  cvt::fence_proxy_async();  // the generic stores before wgmma's reads
  __syncthreads();

  // S = Q K^T by halves of the 64 keys, wgmma m64n32k8 tf32: a half's hi hi products of k8 steps 0-1 and 2-3 as two
  // chains, its 8 products with a lo half as a third, each added to a zero set in registers (scale_d 1 throughout:
  // no sum of a chain is left undefined), the chains added in registers.  A half at a time, so that 80 registers are
  // in flight, not 128.
  uint32_t q_hi[HD / 8][4], q_lo[HD / 8][4];
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) WxRawQ::fragment<true>(tiles, 0, kk, q_hi[kk], q_lo[kk]);
  float sc[32];  // sc[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h, key 8 j + 2 (lane % 4) + e
  float ca[16], cb[16], cx[16];  // the chains of a half
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t kh = k_hi + half * (WX_TILE / 2), kl = k_lo + half * (WX_TILE / 2);
#pragma unroll
    for (int i = 0; i < 16; ++i) ca[i] = cb[i] = cx[i] = 0.0f;
    cvt::wgmma_fence();  // after writing the fragments and the sums, before the products
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      cvt::wgmma_tf32(cx, q_lo[kk], kh + kk * 32, 1);
      cvt::wgmma_tf32(cx, q_hi[kk], kl + kk * 32, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) cvt::wgmma_tf32(ca, q_hi[kk], kh + kk * 32, 1);
#pragma unroll
    for (int kk = 2; kk < 4; ++kk) cvt::wgmma_tf32(cb, q_hi[kk], kh + kk * 32, 1);
    cvt::wgmma_commit();
    cvt::wgmma_wait<0>();
    cvt::fence_sums(ca);
    cvt::fence_sums(cb);
    cvt::fence_sums(cx);
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[16 * half + i] = cx[i] + (ca[i] + cb[i]);
  }
  cvt::keep_fragments(q_hi, q_lo);  // the products read them until the last wait

  // the softmax in the accumulator layout: rel_bias + mask of this thread's scores read first, all at once (0 on
  // rows or keys >= S), then v2's scale, the bias, keys >= S at -inf, the row maximum over the quad that shares the row
  const float* bias_h = rel_bias + (size_t)head * s_len * s_len;
  const float* mask_w = mask != nullptr ? mask + (size_t)(win % nw_img) * s_len * s_len : nullptr;
  const float ls = v2 ? expf(fminf(logit_scale[head], 4.605170185988092f)) : 1.0f;  // ln 100
  const int key0 = 2 * (lane & 3);
  float add[32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + (lane >> 2) + 8 * h;  // rows past S are computed on zeros and not stored
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + e;
        float a = 0.0f;
        if (row < s_len && key < s_len) {
          a = bias_h[row * s_len + key];
          if (mask_w != nullptr) a += mask_w[row * s_len + key];
        }
        add[4 * j + 2 * h + e] = a;
      }
  }
  float mx[2], sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = -INFINITY;
    sum[h] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& val = sc[4 * j + 2 * h + e];
        val = key0 + 8 * j + e < s_len ? (v2 ? val * ls : val) + add[4 * j + 2 * h + e] : -INFINITY;
        mx[h] = fmaxf(mx[h], val);
      }
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));  // key 0 is always real, so it is finite
  }

  // O = P V by halves of the keys, wgmma m64n32k8 tf32: p = exp(s - m) left unnormalised (each output row is scaled
  // by 1 / its sum at the end) and split into P's A fragments where it was computed: k8 step j's registers (row, key
  // 2 t), (row + 8, key 2 t), (row, key 2 t + 1), (row + 8, key 2 t + 1) of its group of 8, t = lane % 4, which
  // V^T's permuted columns match.  A half's hi hi products as two chains of two k8 steps, the products with a lo
  // half as one chain over both halves, each added to a zero set in registers, the chains added in registers.
  auto v_at = [&](uint32_t v, int j) { return v + (j >> 2) * (WX_TILE / 2) + (j & 3) * 32; };  // k8 step j of V^T
  float o[16], ox[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) ox[i] = 0.0f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1, e = r >> 1;
        const float pv = expf(sc[4 * (4 * half + jj) + 2 * h + e] - mx[h]);
        sum[h] += pv;
        float hi, lo;
        split(pv, hi, lo);
        p_hi[jj][r] = __float_as_uint(hi);
        p_lo[jj][r] = __float_as_uint(lo);
      }
#pragma unroll
    for (int i = 0; i < 16; ++i) ca[i] = cb[i] = 0.0f;
    cvt::wgmma_fence();  // after writing the fragments and the sums, before the products
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      cvt::wgmma_tf32(ox, p_lo[jj], v_at(v_hi, 4 * half + jj), 1);
      cvt::wgmma_tf32(ox, p_hi[jj], v_at(v_lo, 4 * half + jj), 1);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) cvt::wgmma_tf32(ca, p_hi[jj], v_at(v_hi, 4 * half + jj), 1);
#pragma unroll
    for (int jj = 2; jj < 4; ++jj) cvt::wgmma_tf32(cb, p_hi[jj], v_at(v_hi, 4 * half + jj), 1);
    cvt::wgmma_commit();
    cvt::wgmma_wait<0>();
    cvt::fence_sums(ca);
    cvt::fence_sums(cb);
    cvt::fence_sums(ox);
    cvt::keep_fragments(p_hi, p_lo);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = half == 0 ? ca[i] + cb[i] : o[i] + (ca[i] + cb[i]);
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    inv[h] = 1.0f / sum[h];
  }

  float* ob_ = joined + (size_t)win * s_len * c + head * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + (lane >> 2) + 8 * h;
    if (row >= s_len) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int i = 4 * j + 2 * h;
      cvt::store2(ob_ + (size_t)row * c + 8 * j + key0, (o[i] + ox[i]) * inv[h], (o[i + 1] + ox[i + 1]) * inv[h]);
    }
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

// The sum of the squares of x[0..15] as a pairwise tree, (x0² + x1²) + (x2² + x3²) and so on up, with no fused
// multiply-add: the order of swin_attention._sum_of_squares over one half of a head, so that, with the halves
// added last (one shuffle), the bf16 v2 core takes the twin's float32 sum bit for bit.
__device__ __forceinline__ float sum_of_squares16(const float (&x)[16]) {
  float t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = __fadd_rn(__fmul_rn(x[2 * i], x[2 * i]), __fmul_rn(x[2 * i + 1], x[2 * i + 1]));
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) t[i] = __fadd_rn(t[2 * i], t[2 * i + 1]);
  return t[0];
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
    if (v2) {  // cosine attention: the row's sum of squares over the thread pair, in the twin's order
      float qs = sum_of_squares16(qv), ks = sum_of_squares16(kv);
      qs = __fadd_rn(qs, __shfl_xor_sync(0xffffffffu, qs, 1));
      ks = __fadd_rn(ks, __shfl_xor_sync(0xffffffffu, ks, 1));
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

// the window core on the tensor cores: split TF32 in float32, bf16 in bf16
cudaError_t window_core(const float* qkv, const float* rel_bias, const float* mask, const float* logit_scale,
                        float* joined, int nw, int s_len, int c, int heads, int nw_img, float scale, int v2,
                        cudaStream_t stream) {
  window_x3_kernel<<<nw * heads, WX_THREADS, WX_SMEM, stream>>>(qkv, rel_bias, mask, logit_scale, joined, s_len, c,
                                                                heads, nw_img, scale, v2);
  return cudaGetLastError();
}

cudaError_t window_core(const float* qkv, const float* rel_bias, const float* mask, const float* logit_scale,
                        bf16* joined, int nw, int s_len, int c, int heads, int nw_img, float scale, int v2,
                        cudaStream_t stream) {
  window_tc_kernel<<<nw * heads, WT_THREADS, WT_SMEM, stream>>>(qkv, rel_bias, mask, logit_scale, joined, s_len, c,
                                                               heads, nw_img, scale, v2);
  return cudaGetLastError();
}

// The q and k columns of the bf16 v2 block's QKV rows: qkv[i][j] = RN_f32(sum_k x[i][k] w[k][j]) + bias[j] for
// j < 2 C, the sum of the exact bf16 products taken in float64 and rounded to float32 once, then the bias added in
// float32.  That float32 sum does not depend on the order of the products (a float64 sum of at most a few hundred
// products of 16-bit significands is exact unless their exponents span more than about 30 bits), so the kernel
// gives its twin's rows bit for bit (swin_attention._qkv_rows: the same product by a float64 matrix product),
// where a float32 sum in another order flips the bf16 rounding of q/|q| and k/|k| that follows, and the logit
// scale (up to 100) carries one such flip past the block's rule (fault 1, tools/torch_window_fault1.py).  No TPU
// kernel is its counterpart: the Pallas kernel sums in float32 on the MXU (ops/pallas/swin_attention.py:177-183).
// Operations bind it: 2 m K N of FP64 work on the FP64 tensor cores (67 TFLOP/s on an H100 SXM; the FMA pipes
// give 34).  A block of eight warps computes a 128 x 64 tile, a warp 32 x 32 as 2 x 4 products m16n8k8
// (dmma_m16n8k8), over k tiles of 16 staged in shared memory as doubles, k-major with rows padded by 4 doubles so
// that a fragment's 16 lanes a phase read 16 banks; the next tile's x and w wait in registers while the products
// of this one run.  x is (m, K) bf16, w N columns of bf16 rows ld apart (K of them) and out N columns of rows ld
// apart, K a multiple of 16, N and ld of 4.  The v columns are not amplified (a flip there moves an output by one
// bf16 step of v): tc_gemm_kernel computes them.
constexpr int Q64_BM = 128, Q64_BN = 64, Q64_BK = 16, Q64_THREADS = 256, Q64_PAD = 4;

__global__ void __launch_bounds__(Q64_THREADS)
qkv_f64_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
               float* __restrict__ out, int m, int k_dim, int n, int ld) {
  __shared__ double a_s[Q64_BK][Q64_BM + Q64_PAD];  // x's tile, k-major
  __shared__ double b_s[Q64_BK][Q64_BN + Q64_PAD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;                  // a fragment's row (or column) and k
  const int wm = 32 * (warp & 3), wn = 32 * (warp >> 2);  // the warp's 32 x 32 of the tile
  const int row0 = blockIdx.x * Q64_BM, col0 = blockIdx.y * Q64_BN;
  const int xr = tid / 2, xk = 8 * (tid % 2);   // x: 8 values (16 bytes) of one row a thread
  const int wk = tid / 16, wc = 4 * (tid % 16);  // w: 4 values (8 bytes) of one row a thread
  const bool x_in = row0 + xr < m, w_in = col0 + wc < n;
  const bf16* xp = x + (size_t)(x_in ? row0 + xr : 0) * k_dim + xk;
  const bf16* wp = w + (size_t)wk * ld + (w_in ? col0 + wc : 0);
  uint4 xu = x_in ? *reinterpret_cast<const uint4*>(xp) : make_uint4(0u, 0u, 0u, 0u);
  float2 wu = w_in ? *reinterpret_cast<const float2*>(wp) : make_float2(0.0f, 0.0f);
  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
  for (int k0 = 0; k0 < k_dim; k0 += Q64_BK) {
    {
      const bf16* v = reinterpret_cast<const bf16*>(&xu);
#pragma unroll
      for (int e = 0; e < 8; ++e) a_s[xk + e][xr] = (double)__bfloat162float(v[e]);
      const bf16* u = reinterpret_cast<const bf16*>(&wu);
#pragma unroll
      for (int e = 0; e < 4; ++e) b_s[wk][wc + e] = (double)__bfloat162float(u[e]);
    }
    __syncthreads();
    if (k0 + Q64_BK < k_dim) {  // the next tile, in flight while this one's products run
      if (x_in) xu = *reinterpret_cast<const uint4*>(xp + k0 + Q64_BK);
      if (w_in) wu = *reinterpret_cast<const float2*>(wp + (size_t)(k0 + Q64_BK) * ld);
    }
#pragma unroll
    for (int k8 = 0; k8 < Q64_BK; k8 += 8) {
      double a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e] = a_s[k8 + t + 4 * (e >> 1)][wm + 16 * i + g + 8 * (e & 1)];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) b[j][e] = b_s[k8 + t + 4 * e][wn + 8 * j + g];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cvt::dmma_m16n8k8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + wn + 8 * j + 2 * t;  // even, and N a multiple of 4: col + 1 < N where col < N
    if (col >= n) continue;
    const float2 bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + 16 * i + g + 8 * h;
        if (row < m)
          *reinterpret_cast<float2*>(out + (size_t)row * ld + col) =
              make_float2(__fadd_rn(__double2float_rn(acc[i][j][2 * h]), bv.x),
                          __fadd_rn(__double2float_rn(acc[i][j][2 * h + 1]), bv.y));
      }
  }
}

cudaError_t launch_qkv_f64(const bf16* x, const bf16* w, const float* bias, float* out, int m, int k_dim, int n,
                           int ld, cudaStream_t stream) {
  if (m < 1 || k_dim % Q64_BK || n % 4 || ld < n || ld % 4 || (n + Q64_BN - 1) / Q64_BN > cvt::MAX_GRID_YZ)
    return cudaErrorInvalidValue;
  const dim3 grid((m + Q64_BM - 1) / Q64_BM, (n + Q64_BN - 1) / Q64_BN);
  qkv_f64_kernel<<<grid, Q64_THREADS, 0, stream>>>(x, w, bias, out, m, k_dim, n, ld);
  return cudaGetLastError();
}

// The products of window_attention_block in T: QKV (f32 out, of LN(x) for
// v1, of x for v2: in bf16 v2 the q and k columns by the float64 product
// above, v on the tensor cores) and the output projection (+ residual into
// out for v1, f32 branch for v2).  ln_buf: scratch of m c values of T (v1
// only).
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
  if (v2) {
    cudaError_t err = launch_tc_gemm<TC_BIAS, float>(x, w_qkv + 2 * c, b_qkv + 2 * c, nullptr, nullptr, qkv + 2 * c,
                                                     m, c, c, stream, 3 * c);
    if (err != cudaSuccess) return err;
    return launch_qkv_f64(x, w_qkv, b_qkv, qkv, m, c, 2 * c, 3 * c, stream);
  }
  cudaError_t err = launch_ln_rows<bf16>(x, ln_g, ln_b, ln_buf, m, c, eps, ln_count, stream);
  if (err != cudaSuccess) return err;
  return launch_tc_gemm<TC_BIAS, float>(ln_buf, w_qkv, b_qkv, nullptr, nullptr, qkv, m, c, 3 * c, stream);
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

// What the card gives a window core: its registers a thread, its dynamic shared memory a block and the blocks an SM
// can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  which: 0 the float32 core (window_x3_kernel), 1 the
// bf16 core (window_tc_kernel).
int cvt_window_core_info(int which, int* regs, int* smem_bytes, int* blocks_per_sm) {
  const void* fn;
  int threads, smem;
  switch (which) {
    case 0:
      fn = (const void*)window_x3_kernel, threads = WX_THREADS, smem = (int)WX_SMEM;
      break;
    case 1:
      fn = (const void*)window_tc_kernel, threads = WT_THREADS, smem = (int)WT_SMEM;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem);
  *regs = attr.numRegs;
  *smem_bytes = smem;
  return (int)err;
}

}  // extern "C"
