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
// float32.  mlp_block: the TPU kernel keeps both weights resident in VMEM
// and carries a (block_m, D) accumulator across a sequential grid axis over
// the hidden dim.  Here it is three launches, as in bfloat16 below: (1) LN(x)
// rows of f32 (ln_rows_kernel; not with post_norm), (2) the up-projection
// LN(x) W1 with bias + gelu into an f32 hidden (m, Dh), (3) the
// down-projection hidden W2 with resid + gamma * (acc + b2), or, with
// post_norm, acc + b2 into an f32 branch and (4) resid + LN(branch)
// (ln_residual_kernel).  Both products are x3_gemm_kernel of tf32x3.cuh:
// split TF32 on the tensor cores (three tf32 wgmma a product, f32 sums), 128
// x 128 outputs a block, every operand split in registers and stored K-major.
// The f32 hidden makes one round trip through device memory (8 m Dh bytes:
// 0.09 ms of the memory rate at ViT-B/16 batch 64), which the TPU kernel
// keeps in VMEM.  D is a multiple of 32 and Dh of 64; ragged token tiles and
// D past the last 128-column tile are masked.  post_norm (Swin v2) skips the
// LayerNorm of the input and normalises the branch instead.  ln_count > 0
// takes either LayerNorm's statistics over the first ln_count channels of a
// zero-padded row (see ln_gemm.cuh).
// attention_block: the TPU kernel holds one image's (S, 3 D) QKV product in
// VMEM (908 KB at ViT-B/16 in bf16); a block here has 227 KB, and the output
// projection sums over heads, which live in different blocks.  So it is
// three launches, all written here: (1) LN + QKV product + bias into a
// (N S, 3 D) buffer of T (ln_gemm_kernel), (2) the attention core of
// attention.cuh reading q, k, v out of that buffer by strides and writing the
// joined heads as (N S, D) of T, (3) output projection + bias + residual
// (ln_gemm_kernel).  The QKV buffer and the joined heads are the two
// intermediates that now touch device memory, written once and read once; no
// transposed copy exists, as on the TPU.  Its f32 products are still the
// scalar FMAs of ln_gemm_kernel.
//
// bfloat16.  Every product is tc_gemm_kernel of ln_gemm.cuh (wgmma, f32
// sums), a LayerNorm before one is ln_rows_kernel:
//   mlp_block     (1) LN(x) -> bf16 (m, D)   [not with post_norm]
//                 (2) LN(x) W1 + b1 -> gelu -> bf16 hidden (m, Dh)
//                 (3) resid + gamma * (hidden W2 + b2)     [gamma: cn_mlp_block]
//                     post_norm: hidden W2 + b2 -> f32 branch (m, D), then
//                 (4) resid + LN(branch), a warp a row (ln_residual_kernel)
//   attention_block  (1) LN(x) -> bf16  (2) LN(x) Wqkv + bqkv -> bf16 (m, 3 D)
//                 (3) the attention core  (4) x + (heads Wo + bo)
// A warpgroup's (64, D) f32 sums of a fused MLP would need D / 2 registers a
// thread (384 at D 768, past the 255 a thread may have), so the hidden makes
// a round trip through device memory: 4 m Dh bytes, written once and read
// once (0.185 ms of the memory rate at ViT-B/16 batch 256), which the TPU
// kernel keeps in VMEM.  The wrappers allocate the LN buffer, the hidden and
// the branch in either type; the kernels allocate nothing.
//
// Bound.  At ViT-B/16 batch 256 (50,432 tokens, D 768) mlp_block does 476
// GFLOP on 155 MB (bf16) and attention_block 268 GFLOP: operations bind both,
// in either type (the f32 MLP at 3 x 476 tf32 GFLOP / 495 TFLOP/s).

#include "ln_gemm.cuh"
#include "tf32x3.cuh"

namespace {

using cvt::bf16;
using cvt::gelu_erf;
using cvt::launch_ln_gemm;
using cvt::launch_ln_residual;
using cvt::launch_ln_rows;
using cvt::launch_tc_gemm;
using cvt::TC_BIAS;
using cvt::TC_GELU;
using cvt::TC_RESID;

cudaError_t attention_block_f32(const float* x, const float* ln_g, const float* ln_b, const float* w_qkv,
                                const float* b_qkv, const float* w_o, const float* b_o, float* qkv, float* heads_out,
                                float* out, int n, int s_len, int d, int heads, float scale, float eps,
                                cudaStream_t stream) {
  if (heads < 1 || d % heads) return cudaErrorInvalidValue;
  const int m = n * s_len, hd = d / heads;
  cudaError_t err = launch_ln_gemm<true, false>(x, ln_g, ln_b, w_qkv, b_qkv, nullptr, qkv, m, d, 3 * d, eps, 0, stream);
  if (err != cudaSuccess) return err;
  const long long row = 3LL * d;
  err = cvt::attention_core<float>(qkv, qkv + d, qkv + 2 * d, heads_out, n, s_len, heads, hd, scale, s_len * row,
                                   row, hd, (long long)s_len * d, d, hd, stream);
  if (err != cudaSuccess) return err;
  return launch_ln_gemm<false, true>(heads_out, nullptr, nullptr, w_o, b_o, x, out, m, d, d, eps, 0, stream);
}

// ln_buf: scratch of n s_len d bf16 values
cudaError_t attention_block_bf16(const bf16* x, const float* ln_g, const float* ln_b, const bf16* w_qkv,
                                 const float* b_qkv, const bf16* w_o, const float* b_o, bf16* qkv, bf16* heads_out,
                                 bf16* ln_buf, bf16* out, int n, int s_len, int d, int heads, float scale, float eps,
                                 cudaStream_t stream) {
  if (heads < 1 || d % heads) return cudaErrorInvalidValue;
  const int m = n * s_len, hd = d / heads;
  cudaError_t err = launch_ln_rows<bf16>(x, ln_g, ln_b, ln_buf, m, d, eps, 0, stream);
  if (err != cudaSuccess) return err;
  err = launch_tc_gemm<TC_BIAS, bf16>(ln_buf, w_qkv, b_qkv, nullptr, nullptr, qkv, m, d, 3 * d, stream);
  if (err != cudaSuccess) return err;
  const long long row = 3LL * d;
  err = cvt::attention_core<bf16>(qkv, qkv + d, qkv + 2 * d, heads_out, n, s_len, heads, hd, scale, s_len * row,
                                  row, hd, (long long)s_len * d, d, hd, stream);
  if (err != cudaSuccess) return err;
  return launch_tc_gemm<TC_RESID, bf16>(heads_out, w_o, b_o, x, nullptr, out, m, d, d, stream);
}

// ---------------------------------------------------------------- mlp_block

// the epilogues of the float32 MLP's two split-TF32 products (tf32x3.cuh)
struct GeluEpi {  // out = gelu(acc + bias): the hidden activations
  const float* bias;
  float* out;
  int ld;
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    cvt::store2(out + (size_t)row * ld + col, gelu_erf(v0 + bias[col]), gelu_erf(v1 + bias[col + 1]));
  }
};

struct ResidEpi {  // out = resid + gamma * (acc + bias), gamma null for none; or acc + bias alone (resid null)
  const float* bias;
  const float* resid;
  const float* gamma;
  float* out;
  int ld;
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    const size_t at = (size_t)row * ld + col;
    v0 += bias[col];
    v1 += bias[col + 1];
    if (gamma != nullptr) {
      v0 *= gamma[col];
      v1 *= gamma[col + 1];
    }
    if (resid != nullptr) {
      v0 = resid[at] + v0;
      v1 = resid[at + 1] + v1;
    }
    cvt::store2(out + at, v0, v1);
  }
};

bool mlp_dims_taken(int m, int d, int dh, int ln_count) {
  return m >= 1 && d >= 32 && d % 32 == 0 && dh >= 64 && dh % 64 == 0 && ln_count >= 0 && ln_count <= d;
}

// ln_buf (m, d) and hidden (m, dh) of f32 and, with post_norm, branch (m, d)
// of f32 are scratch
cudaError_t mlp_block_f32(const float* x, const float* resid, const float* ln_g, const float* ln_b, const float* w1,
                          const float* b1, const float* w2, const float* b2, const float* gamma, float* out,
                          float* ln_buf, float* hidden, float* branch, int m, int d, int dh, float eps, int post_norm,
                          int ln_count, cudaStream_t stream) {
  if (!mlp_dims_taken(m, d, dh, ln_count)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (!post_norm) {
    err = launch_ln_rows<float>(x, ln_g, ln_b, ln_buf, m, d, eps, ln_count, stream);
    if (err != cudaSuccess) return err;
  }
  err = cvt::launch_x3_gemm<true, 2, 128>(post_norm ? x : ln_buf, d, w1, dh, m, dh, d, d, GeluEpi{b1, hidden, dh},
                                          stream);
  if (err != cudaSuccess) return err;
  if (!post_norm)
    return cvt::launch_x3_gemm<true, 2, 128>(hidden, dh, w2, d, m, d, dh, dh, ResidEpi{b2, resid, gamma, out, d},
                                             stream);
  err = cvt::launch_x3_gemm<true, 2, 128>(hidden, dh, w2, d, m, d, dh, dh, ResidEpi{b2, nullptr, nullptr, branch, d},
                                          stream);
  if (err != cudaSuccess) return err;
  return launch_ln_residual<float>(branch, resid, ln_g, ln_b, out, m, d, eps, ln_count, stream);
}

// ln_buf (m, d) and hidden (m, dh) of bf16 and, with post_norm, branch (m, d)
// of f32 are scratch
cudaError_t mlp_block_bf16(const bf16* x, const bf16* resid, const float* ln_g, const float* ln_b, const bf16* w1,
                           const float* b1, const bf16* w2, const float* b2, const float* gamma, bf16* out,
                           bf16* ln_buf, bf16* hidden, float* branch, int m, int d, int dh, float eps, int post_norm,
                           int ln_count, cudaStream_t stream) {
  if (!mlp_dims_taken(m, d, dh, ln_count)) return cudaErrorInvalidValue;
  cudaError_t err;
  if (!post_norm) {
    err = launch_ln_rows<bf16>(x, ln_g, ln_b, ln_buf, m, d, eps, ln_count, stream);
    if (err != cudaSuccess) return err;
  }
  err = launch_tc_gemm<TC_GELU, bf16>(post_norm ? x : ln_buf, w1, b1, nullptr, nullptr, hidden, m, d, dh, stream);
  if (err != cudaSuccess) return err;
  if (!post_norm) return launch_tc_gemm<TC_RESID, bf16>(hidden, w2, b2, resid, gamma, out, m, dh, d, stream);
  err = launch_tc_gemm<TC_BIAS, float>(hidden, w2, b2, nullptr, nullptr, branch, m, dh, d, stream);
  if (err != cudaSuccess) return err;
  return launch_ln_residual<bf16>(branch, resid, ln_g, ln_b, out, m, d, eps, ln_count, stream);
}

}  // namespace

extern "C" {

// All launch on `stream` and return the first failed launch's cudaError_t
// (0 on success); none synchronises.

// mlp_block: resid = x, gamma = null.  cn_mlp_block: x is the tensor that is
// normalised, resid the residual, gamma the layer scale (post_norm = 0).
// Scratch: ln_buf (m, d) (not with post_norm) and hidden (m, dh) of T, branch
// (m, d) of f32 (post_norm only; null otherwise).
int cvt_mlp_block(const void* x, const void* resid, const float* ln_g, const float* ln_b, const void* w1,
                  const float* b1, const void* w2, const float* b2, const float* gamma, void* out, void* ln_buf,
                  void* hidden, float* branch, int m, int d, int dh, float eps, int post_norm, int ln_count,
                  int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)mlp_block_bf16((const bf16*)x, (const bf16*)resid, ln_g, ln_b, (const bf16*)w1, b1, (const bf16*)w2,
                               b2, gamma, (bf16*)out, (bf16*)ln_buf, (bf16*)hidden, branch, m, d, dh, eps, post_norm,
                               ln_count, st);
  return (int)mlp_block_f32((const float*)x, (const float*)resid, ln_g, ln_b, (const float*)w1, b1, (const float*)w2,
                            b2, gamma, (float*)out, (float*)ln_buf, (float*)hidden, branch, m, d, dh, eps, post_norm,
                            ln_count, st);
}

// qkv is scratch of n * s_len * 3 d values of T, heads_out of n * s_len * d,
// ln_buf (bf16 only, null for float32) of n * s_len * d.
int cvt_attention_block(const void* x, const float* ln_g, const float* ln_b, const void* w_qkv,
                        const float* b_qkv, const void* w_o, const float* b_o, void* qkv, void* heads_out,
                        void* ln_buf, void* out, int n, int s_len, int d, int heads, float scale, float eps,
                        int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)attention_block_bf16((const bf16*)x, ln_g, ln_b, (const bf16*)w_qkv, b_qkv, (const bf16*)w_o, b_o,
                                     (bf16*)qkv, (bf16*)heads_out, (bf16*)ln_buf, (bf16*)out, n, s_len, d, heads,
                                     scale, eps, st);
  return (int)attention_block_f32((const float*)x, ln_g, ln_b, (const float*)w_qkv, b_qkv, (const float*)w_o, b_o,
                                  (float*)qkv, (float*)heads_out, (float*)out, n, s_len, d, heads, scale, eps, st);
}

// The bf16 tensor-core product alone: out = Epi(a w), a (m, k), w (k, n) of
// bf16; epilogue 0 bias, 1 bias + gelu, 2 resid + gamma * (acc + bias) (resid
// (m, n) of bf16, gamma null for none); out of f32 where out_f32 (bias only),
// else bf16.
int cvt_bf16_product(const void* a, const void* w, const float* bias, const void* resid, const float* gamma,
                     void* out, int m, int k, int n, int epilogue, int out_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *pa = (const bf16*)a, *pw = (const bf16*)w;
  if (out_f32)
    return epilogue == TC_BIAS ? (int)launch_tc_gemm<TC_BIAS, float>(pa, pw, bias, nullptr, nullptr, (float*)out, m,
                                                                     k, n, st)
                               : (int)cudaErrorInvalidValue;
  switch (epilogue) {
    case TC_BIAS:
      return (int)launch_tc_gemm<TC_BIAS, bf16>(pa, pw, bias, nullptr, nullptr, (bf16*)out, m, k, n, st);
    case TC_GELU:
      return (int)launch_tc_gemm<TC_GELU, bf16>(pa, pw, bias, nullptr, nullptr, (bf16*)out, m, k, n, st);
    case TC_RESID:
      return (int)launch_tc_gemm<TC_RESID, bf16>(pa, pw, bias, (const bf16*)resid, gamma, (bf16*)out, m, k, n, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
