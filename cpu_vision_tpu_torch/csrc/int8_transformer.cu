// The int8 sub-blocks of a pre-LN transformer encoder layer (post-training
// quantised serving) for Hopper (sm_90a), bound with ctypes:
//
//   cvt_mlp_block_int8        out = x + (q2(gelu(q1(LN(x)) @ qW1 * s1 + b1)) @ qW2) * s2 + b2
//   cvt_attention_block_int8  out = x + qo(MHA(q1(LN(x)) @ qWqkv * s + b)) @ qWo * so + bo
//
// with q(f)[c] = clamp(rint(f[c] * inv[c]), -127, 127) as int8 (inv the
// per-channel inverse activation scale), every product int8 x int8 summed in
// int32, LayerNorm, gelu, softmax and every rescale in f32.  They replace the
// Pallas TPU kernels of cpu_vision_tpu/ops/pallas/int8_transformer.py:
// mlp_block_int8 :88 (pallas_call at :112) and attention_block_int8 :163
// (pallas_call at :183).  x and the output are of T (float or bf16); the QKV
// product is rounded through T after its bias, as the TPU kernel casts it.
//
// The TPU kernels keep the int8 weights resident in VMEM and the int8
// activations in vregs.  Here each sub-block is a chain of launches, as the
// bf16 blocks are (transformer_block.cu), and every product is the s8 product
// of int8_gemm.cuh (i8_tc_gemm_kernel: wgmma m64n128k32 s8 x s8 into int32
// sums, 128 x 128 outputs a block, a 3-stage cp.async ring):
//
// mlp_block_int8, three launches: (1) ln_quant_rows_kernel, a warp a row: the
// row's statistics once (row_stats), then q1(LN(x)) into an (m, D) int8
// buffer, four channels a word; (2) the up-projection q1 . qW1, epilogue
// Q8_GELU into an (m, Dh) int8 hidden; (3) the down-projection hidden . qW2,
// epilogue Q8_RESID, x + (acc * s2 + b2) rounded to T.  D and Dh are multiples
// of 128 (the wrapper takes D in 256 .. 1280 by 256 and Dh a multiple of 256).
// The int8 LN rows and the hidden make one round trip through device memory
// (2 m (D + Dh) bytes, 0.116 ms at ViT-B/16 b256), where the TPU kernel keeps
// them in VMEM: a down-projection fused behind the up-projection would hold
// (64, D) int32 sums a warpgroup, D / 2 registers a thread, past 255 at D 768.
// Its down-projection sums in int32 over the whole hidden dim: JAX's order
// wherever its hidden dim is one block (ViT-B and ViT-L), while at ViT-H it
// sums four f32 partials.
//
// attention_block_int8, four launches: (1) ln_quant_rows_kernel, q1(LN(x))
// into an (N S, D) int8 buffer; (2) the QKV product q1 . qWqkv, epilogue
// Q8_AFFINE, acc * s + b rounded to T into an (N S, 3 D) buffer; (3) the
// attention core of attention.cuh reading q, k, v out of that buffer by
// strides, its f32 head outputs quantised by qo in its epilogue into an (N S,
// D) int8 buffer (the TPU kernel quantises the f32 output, so nothing is
// rounded through T there); (4) the output product joined . qWo, epilogue
// Q8_ATTN_RESID, (x + acc * so) + bo rounded to T.  D a multiple of 16 and
// head dims 16, 64 and 80.  The int8 LN rows make one round trip through
// device memory (2 N S D bytes, 0.023 ms at ViT-B/16 b256), as do the QKV
// buffer and the joined heads.
//
// Bound.  At ViT-B/16 batch 256 (50,432 tokens) mlp_block_int8 does 476 G int8
// operations on 155 MB, attention_block_int8 268 G: operations bind both at
// the int8 tensor-core rate (1,979 TOP/s).  Built with --fmad=false: the f32
// steps are the twins' operations one by one (LayerNorm statistics and the
// exponentials still differ from the twins' in the last bits, so the quantised
// values may too).  Every sum is one exact int32 sum, and every f32 step is
// the dp4a kernels' that these replaced, one by one, so the outputs are theirs
// bit for bit.

#include "int8_gemm.cuh"

namespace {

using cvt::bf16;
using cvt::launch_i8_tc_gemm;
using cvt::pack4;
using cvt::Q8_AFFINE;
using cvt::Q8_ATTN_RESID;
using cvt::Q8_BK;
using cvt::Q8_GELU;
using cvt::Q8_KSTEP;
using cvt::Q8_RESID;
using cvt::Q8Epi;
using cvt::quant_i8;
using cvt::ROW_THREADS;
using cvt::row_stats;
using cvt::to_f32;

// ---------------------------------------------------------- both sub-blocks

// q1 = clamp(rint(LN(x) * inv1)) of each row into int8, a warp a row
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
ln_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                     const float* __restrict__ inv1, int8_t* __restrict__ q1, int m, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* p = x + row * d;
  float mean, rstd;
  row_stats<T>(p, d, eps, 0, lane, mean, rstd);
  int* o = reinterpret_cast<int*>(q1 + row * d);
  for (int w = lane; w < d / 4; w += 32) {
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * w + j;
      q[j] = quant_i8((to_f32<T>(p[c]) - mean) * rstd * ln_g[c] + ln_b[c], inv1[c]);
    }
    o[w] = pack4(q[0], q[1], q[2], q[3]);
  }
}

// ---------------------------------------------------------- mlp_block_int8

template <typename T>
cudaError_t mlp_block_int8(const T* x, const float* ln_g, const float* ln_b, const int8_t* w1t, const float* s1,
                           const float* b1, const int8_t* w2t, const float* s2, const float* b2,
                           const float* inv1, const float* inv2, int8_t* q1, int8_t* hidden, T* out, int m, int d,
                           int dh, float eps, cudaStream_t stream) {
  if (m < 1 || d < Q8_BK || d % Q8_BK || dh < Q8_BK || dh % Q8_BK) return cudaErrorInvalidValue;
  constexpr int rows = ROW_THREADS / 32;
  ln_quant_rows_kernel<T><<<(m + rows - 1) / rows, ROW_THREADS, 0, stream>>>(x, ln_g, ln_b, inv1, q1, m, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_i8_tc_gemm<Q8_GELU, T>(q1, w1t, Q8Epi<T>{s1, b1, inv2, nullptr, hidden}, m, d, dh, stream);
  if (err != cudaSuccess) return err;
  return launch_i8_tc_gemm<Q8_RESID, T>(hidden, w2t, Q8Epi<T>{s2, b2, nullptr, x, out}, m, dh, d, stream);
}

// ---------------------------------------------------- attention_block_int8

template <typename T>
cudaError_t attention_block_int8(const T* x, const float* ln_g, const float* ln_b, const int8_t* wqkv_t,
                                 const float* s_qkv, const float* b_qkv, const int8_t* wo_t, const float* s_o,
                                 const float* b_o, const float* inv1, const float* inv_o, int8_t* q1, T* qkv,
                                 int8_t* joined, T* out, int n, int s_len, int d, int heads, float scale, float eps,
                                 cudaStream_t stream) {
  if (heads < 1 || d % heads || d < Q8_KSTEP || d % Q8_KSTEP) return cudaErrorInvalidValue;
  const int m = n * s_len, hd = d / heads;
  constexpr int rows = ROW_THREADS / 32;
  ln_quant_rows_kernel<T><<<(m + rows - 1) / rows, ROW_THREADS, 0, stream>>>(x, ln_g, ln_b, inv1, q1, m, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_i8_tc_gemm<Q8_AFFINE, T>(q1, wqkv_t, Q8Epi<T>{s_qkv, b_qkv, nullptr, nullptr, qkv}, m, d, 3 * d,
                                        stream);
  if (err != cudaSuccess) return err;
  const long long row = 3LL * d;
  err = cvt::attention_core<T>(qkv, qkv + d, qkv + 2 * d, joined, n, s_len, heads, hd, scale, s_len * row, row,
                               hd, (long long)s_len * d, d, hd, stream, inv_o);
  if (err != cudaSuccess) return err;
  return launch_i8_tc_gemm<Q8_ATTN_RESID, T>(joined, wo_t, Q8Epi<T>{s_o, b_o, nullptr, x, out}, m, d, d, stream);
}

}  // namespace

extern "C" {

// Both launch on `stream` and return the first failed launch's cudaError_t
// (0 on success); neither synchronises.  Weights come transposed: w1t (dh, d),
// w2t (d, dh), wqkv_t (3 d, d), wo_t (d, d), all int8; scales, biases, LayerNorm
// parameters and inverse activation scales are f32 vectors of their width.

// q1 is scratch of m * d int8, hidden of m * dh int8; d and dh multiples of 128.
int cvt_mlp_block_int8(const void* x, const float* ln_g, const float* ln_b, const void* w1t, const float* s1,
                       const float* b1, const void* w2t, const float* s2, const float* b2, const float* inv1,
                       const float* inv2, void* q1, void* hidden, void* out, int m, int d, int dh, float eps,
                       int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* w1 = (const int8_t*)w1t;
  const int8_t* w2 = (const int8_t*)w2t;
  int8_t *pq = (int8_t*)q1, *ph = (int8_t*)hidden;
  if (is_bf16)
    return (int)mlp_block_int8<bf16>((const bf16*)x, ln_g, ln_b, w1, s1, b1, w2, s2, b2, inv1, inv2, pq, ph,
                                     (bf16*)out, m, d, dh, eps, st);
  return (int)mlp_block_int8<float>((const float*)x, ln_g, ln_b, w1, s1, b1, w2, s2, b2, inv1, inv2, pq, ph,
                                    (float*)out, m, d, dh, eps, st);
}

// q1 is scratch of n * s_len * d int8, qkv of n * s_len * 3 d values of T, joined of n * s_len * d int8.
int cvt_attention_block_int8(const void* x, const float* ln_g, const float* ln_b, const void* wqkv_t,
                             const float* s_qkv, const float* b_qkv, const void* wo_t, const float* s_o,
                             const float* b_o, const float* inv1, const float* inv_o, void* q1, void* qkv,
                             void* joined, void* out, int n, int s_len, int d, int heads, float scale, float eps,
                             int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* wqkv = (const int8_t*)wqkv_t;
  const int8_t* wo = (const int8_t*)wo_t;
  if (is_bf16)
    return (int)attention_block_int8<__nv_bfloat16>(
        (const __nv_bfloat16*)x, ln_g, ln_b, wqkv, s_qkv, b_qkv, wo, s_o, b_o, inv1, inv_o, (int8_t*)q1,
        (__nv_bfloat16*)qkv, (int8_t*)joined, (__nv_bfloat16*)out, n, s_len, d, heads, scale, eps, st);
  return (int)attention_block_int8<float>((const float*)x, ln_g, ln_b, wqkv, s_qkv, b_qkv, wo, s_o, b_o, inv1,
                                          inv_o, (int8_t*)q1, (float*)qkv, (int8_t*)joined, (float*)out, n, s_len,
                                          d, heads, scale, eps, st);
}

}  // extern "C"
