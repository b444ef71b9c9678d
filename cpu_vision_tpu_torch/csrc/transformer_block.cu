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
// projection sums over heads, which live in different blocks.  So it is four
// launches, all written here, in either type: (1) LN(x) rows of T
// (ln_rows_kernel), (2) QKV product + bias into a (N S, 3 D) buffer of T,
// (3) the attention core of attention.cuh reading q, k, v out of that buffer
// by strides and writing the joined heads as (N S, D) of T, (4) output
// projection + bias + residual.  In float32 both products are x3_gemm_kernel
// (launch_x3_rows of tf32x3.cuh: one slab, 128 x 128 or 128 x 64 tiles, the
// ResidEpi epilogue, resid null for the QKV bias) and the core at head dim 64
// attention_x3_kernel, split TF32 too.  The LN rows, the QKV buffer and the
// joined heads are the intermediates that now touch device memory, written
// once and read once; no transposed copy exists, as on the TPU.
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
//
// Backward, bfloat16 (ops/kernels/transformer_block.py: the gradients of
// mlp_block, cn_mlp_block and attention_block in place of the JAX package's
// custom_vjp _bwd :335-343, _cn_bwd :453, _attn_bwd :299-307, which take
// jax.grad of the same math).  Besides the port's bf16_product, wgrad_matmul
// and the attention core's backward (attention.cu), two kernels here:
//   cvt_mlp_gelu_backward  Kernel A, the MLP's elementwise backward through
//                          its gelu, fused (gelu_backward_kernel)
//   cvt_ln_backward        the LayerNorm backward rows of all three blocks
//                          (ln_backward_vec_kernel or ln_backward_kernel of
//                          ln_gemm.cuh), with dgamma and dbeta

#include "ln_gemm.cuh"
#include "tf32x3.cuh"

namespace {

using cvt::bf16;
using cvt::gelu_erf;
using cvt::launch_ln_residual;
using cvt::launch_ln_rows;
using cvt::launch_tc_gemm;
using cvt::ResidEpi;
using cvt::TC_BIAS;
using cvt::TC_GELU;
using cvt::TC_RESID;

// ln_buf: scratch of n s_len d f32 values
cudaError_t attention_block_f32(const float* x, const float* ln_g, const float* ln_b, const float* w_qkv,
                                const float* b_qkv, const float* w_o, const float* b_o, float* qkv, float* heads_out,
                                float* ln_buf, float* out, int n, int s_len, int d, int heads, float scale, float eps,
                                cudaStream_t stream) {
  if (heads < 1 || d % heads) return cudaErrorInvalidValue;
  const int m = n * s_len, hd = d / heads;
  cudaError_t err = launch_ln_rows<float>(x, ln_g, ln_b, ln_buf, m, d, eps, 0, stream);
  if (err != cudaSuccess) return err;
  err = cvt::launch_x3_rows(ln_buf, w_qkv, m, 3 * d, d, ResidEpi{b_qkv, nullptr, nullptr, qkv, 3 * d}, stream);
  if (err != cudaSuccess) return err;
  const long long row = 3LL * d;
  err = cvt::attention_core<float>(qkv, qkv + d, qkv + 2 * d, heads_out, n, s_len, heads, hd, scale, s_len * row,
                                   row, hd, (long long)s_len * d, d, hd, stream);
  if (err != cudaSuccess) return err;
  return cvt::launch_x3_rows(heads_out, w_o, m, d, d, ResidEpi{b_o, x, nullptr, out, d}, stream);
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

// the up-projection's epilogue of the float32 MLP (the down-projection's is ResidEpi of tf32x3.cuh)
struct GeluEpi {  // out = gelu(acc + bias): the hidden activations
  const float* bias;
  float* out;
  int ld;
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    cvt::store2(out + (size_t)row * ld + col, gelu_erf(v0 + bias[col]), gelu_erf(v1 + bias[col + 1]));
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

// ------------------------------------------------------------ Kernel A

// The MLP's elementwise backward through its gelu (Kernel A), for the bf16
// backward of mlp_block and cn_mlp_block.  The TPU kernel has no backward of
// its own: the JAX custom_vjp differentiates the same math with XLA, which
// fuses these elementwise chains; the port's plain twin under autograd ran
// them as ~50 launches of f32 elementwise kernels over the (m, Dh) hidden.
// From the float32 products of the recompute, h W1 and g W2^T, one pass:
//   u   = h W1 + b1 and da = bf16(g W2^T), rounded as the twin's operators
//         round them (an f32 add, a cast to nearest even);
//   a   = gelu(u) rounded to bf16: the twin's activations bit for bit, the
//         polynomial erf evaluated as its operators do, one rounding an
//         operation (__fmul_rn and friends: nothing is contracted into an FMA),
//         so that the weight gradient a^T g sees the twin's roundings;
//   du  = da gelu'(u) (the derivative of that polynomial, as the plain
//         version writes it out, evaluated the same way: its bits), rounded
//         to tf32 as the twin's TF32 products round it and
//         stored exactly as two bf16 halves [hi | lo] for the bf16 products
//         dW1 = h^T du and du W1^T;
//   each block's column sums of the unrounded du over its GB_ROWS rows (the
//         bias gradient, added in block order by the wrapper).
// A thread two adjacent columns, a block 2 GB_THREADS columns of GB_ROWS rows.
// Bound: bytes, both products (f32) read once, du2 and a written once: 1085 MB
// at ViT-B/16 b128, 0.32 ms.
constexpr int GB_THREADS = 256;
constexpr int GB_ROWS = 64;

// _gelu_f32 of the twin (transformer_block.py), one rounding an operator
__device__ __forceinline__ float gelu_twin(float h) {
  const float z = __fmul_rn(h, 0.70710678118654752f), a = fabsf(z);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, a)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  p = __fmul_rn(t, p);
  const float e = expf(__fmul_rn(-a, a));
  const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
  const float erf = __fmul_rn(sign, __fsub_rn(1.0f, __fmul_rn(p, e)));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, erf));
}

// _gelu_grad_f32 of the plain version (transformer_block.py): d gelu / dh, the derivative of the polynomial erf as
// autograd takes it, one rounding an operator in its order
__device__ __forceinline__ float gelu_grad_twin(float h) {
  const float z = __fmul_rn(h, 0.70710678118654752f), a = fabsf(z);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, a)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  p = __fmul_rn(t, p);
  float dp = __fadd_rn((float)(4.0 * -1.453152027), __fmul_rn(__fmul_rn(t, 5.0f), 1.061405429f));
  dp = __fadd_rn((float)(3.0 * 1.421413741), __fmul_rn(t, dp));
  dp = __fadd_rn((float)(2.0 * -0.284496736), __fmul_rn(t, dp));
  dp = __fadd_rn(0.254829592f, __fmul_rn(t, dp));
  const float e = expf(__fmul_rn(-a, a));
  const float sign = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
  const float erf = __fmul_rn(sign, __fsub_rn(1.0f, __fmul_rn(p, e)));
  const float derf = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(dp, 0.3275911f), t), t),
                                         __fmul_rn(__fmul_rn(2.0f, a), p)), e);
  return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(1.0f, erf)),
                   __fmul_rn(__fmul_rn(__fmul_rn(0.5f, h), derf), 0.70710678118654752f));
}

__global__ void __launch_bounds__(GB_THREADS)
gelu_backward_kernel(const float* __restrict__ da32, const float* __restrict__ hw, const float* __restrict__ b1,
                     bf16* __restrict__ du2, bf16* __restrict__ a, float* __restrict__ partial, int m, int n,
                     int row_tile0) {
  const int col = 2 * (blockIdx.x * GB_THREADS + threadIdx.x);
  if (col >= n) return;
  const int tile = row_tile0 + blockIdx.y;  // row tiles past the grid's 65,535 come in further launches
  const int r0 = tile * GB_ROWS, r1 = min(r0 + GB_ROWS, m);
  const float bias0 = b1[col], bias1 = b1[col + 1];
  float s0 = 0.0f, s1 = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const size_t at = (size_t)r * n + col;
    const float2 p = *reinterpret_cast<const float2*>(hw + at), q = *reinterpret_cast<const float2*>(da32 + at);
    float2 uu;
    uu.x = __fadd_rn(p.x, bias0);
    uu.y = __fadd_rn(p.y, bias1);
    const float d0 = __fmul_rn(cvt::round_to<bf16>(q.x), gelu_grad_twin(uu.x));
    const float d1 = __fmul_rn(cvt::round_to<bf16>(q.y), gelu_grad_twin(uu.y));
    s0 += d0;
    s1 += d1;
    const float t0 = cvt::tf32_rna(d0), t1 = cvt::tf32_rna(d1);
    const float h0 = cvt::round_to<bf16>(t0), h1 = cvt::round_to<bf16>(t1);
    cvt::store2(du2 + (size_t)r * 2 * n + col, h0, h1);
    cvt::store2(du2 + (size_t)r * 2 * n + n + col, t0 - h0, t1 - h1);
    cvt::store2(a + at, gelu_twin(uu.x), gelu_twin(uu.y));
  }
  partial[(size_t)tile * n + col] = s0;
  partial[(size_t)tile * n + col + 1] = s1;
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

// qkv is scratch of n * s_len * 3 d values of T, heads_out and ln_buf of
// n * s_len * d.
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
                                  (float*)qkv, (float*)heads_out, (float*)ln_buf, (float*)out, n, s_len, d, heads,
                                  scale, eps, st);
}

// Kernel A: from da32 = g W2^T and hw = h W1, (m, n) of f32, and b1 (n,): with u = hw + b1 and da = bf16(da32),
// du2 (m, 2 n) = [hi | lo] of du = tf32(da gelu'(u)), a (m, n) = gelu(u) of bf16 and partial (ceil(m / GB_ROWS), n) of
// f32, each block's column sums of the unrounded du.
int cvt_mlp_gelu_backward(const float* da32, const float* hw, const float* b1, void* du2, void* a, float* partial,
                          int m, int n, void* stream) {
  if (m < 1 || n < 2 || n % 2) return (int)cudaErrorInvalidValue;
  const int tiles = (m + GB_ROWS - 1) / GB_ROWS;
  for (int t0 = 0; t0 < tiles; t0 += cvt::MAX_GRID_YZ) {
    const dim3 grid((n / 2 + GB_THREADS - 1) / GB_THREADS, min(cvt::MAX_GRID_YZ, tiles - t0));
    gelu_backward_kernel<<<grid, GB_THREADS, 0, (cudaStream_t)stream>>>(da32, hw, b1, (bf16*)du2, (bf16*)a, partial,
                                                                         m, n, t0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The LayerNorm backward rows: dx = resid + LN'(x) dh of T (resid null for none), and sums (2, d) of f32, d ln_g
// and d ln_b; partial is scratch of capacity * 2 * d floats (the persistent grid has at most capacity blocks, sms
// the card's multiprocessors).
int cvt_ln_backward(const void* x, const float* ln_g, const void* dh, const void* resid, void* dx, float* partial,
                    float* sums, int m, int d, float eps, int sms, int capacity, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)cvt::launch_ln_backward<bf16>((const bf16*)x, ln_g, (const bf16*)dh, (const bf16*)resid, (bf16*)dx,
                                              partial, sums, m, d, eps, sms, capacity, nullptr, st);
  return (int)cvt::launch_ln_backward<float>((const float*)x, ln_g, (const float*)dh, (const float*)resid,
                                             (float*)dx, partial, sums, m, d, eps, sms, capacity, nullptr, st);
}

// What cvt_ln_backward would launch for these arguments, without launching: info[0..5] = chunks a lane (0: the
// scalar kernel), threads, shared bytes a block, blocks an SM, registers a thread, grid.
int cvt_ln_backward_info(const void* x, const float* ln_g, const void* dh, const void* resid, const void* dx, int m,
                         int d, int sms, int capacity, int is_bf16, int* info) {
  if (is_bf16)
    return (int)cvt::launch_ln_backward<bf16>((const bf16*)x, ln_g, (const bf16*)dh, (const bf16*)resid,
                                              (bf16*)dx, nullptr, nullptr, m, d, 0.0f, sms, capacity, info, nullptr);
  return (int)cvt::launch_ln_backward<float>((const float*)x, ln_g, (const float*)dh, (const float*)resid,
                                             (float*)dx, nullptr, nullptr, m, d, 0.0f, sms, capacity, info, nullptr);
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
