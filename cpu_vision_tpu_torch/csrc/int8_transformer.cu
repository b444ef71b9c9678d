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
// mlp_block_int8.  The TPU kernel keeps both int8 weights resident in VMEM and
// the int8 activations in vregs.  Here a block of 512 threads owns 32 tokens:
// q1(LN(x)) of the tile sits in shared memory as int8 (32 x D bytes), the
// (32, D) int32 accumulator in registers, and the hidden dim is a loop inside
// the block over chunks of 256 columns: (a) the chunk's up-projection from
// q1(LN(x)) and tiles of qW1 streamed through shared memory, (b) bias + gelu +
// q2 into a (32, 256) int8 buffer, (c) the chunk's share of the
// down-projection from that buffer and tiles of qW2.  The (tokens, Dh) int8
// activations never reach device memory.  One int32 sum runs over the whole
// hidden dim and is scaled by s2 once: JAX's order wherever its hidden dim is
// one block (ViT-B and ViT-L), while at ViT-H it sums four f32 partials.  The
// weights come transposed, qW1^T (Dh, D) and qW2^T (D, Dh), so that four
// consecutive k of a column are one word, the operand of __dp4a.  Thread
// (rg, cg) of 8 x 64 owns rows 4 rg .. 4 rg + 3 and, of the up-projection, the
// chunk's columns 4 cg .. 4 cg + 3 (one word of the buffer (b) writes), of
// the down-projection columns 4 cg .. 4 cg + 3 of every 256-column group.  D
// is a multiple of 256 (256 to 1280 instantiated), Dh of 256.
//
// attention_block_int8.  Three launches, as the bf16 attention_block:
// (1) LN + q1 + int8 QKV product + s * acc + b into an (N S, 3 D) buffer of T
// (the tiled product of int8_gemm.cuh, A quantised while it is staged);
// (2) the attention core of attention.cuh reading q, k, v out of that buffer
// by strides, its f32 head outputs quantised by qo in its epilogue into an
// (N S, D) int8 buffer (the TPU kernel quantises the f32 output, so nothing
// is rounded through T there); (3) the int8 output projection + so * acc + bo
// + residual.  Head dims 16, 64 and 80.
//
// Bound.  At ViT-B/16 batch 256 (50,432 tokens) mlp_block_int8 does 476 G int8
// operations on 155 MB, attention_block_int8 268 G: operations bind both at
// the int8 tensor-core rate.  This first version uses no tensor core: dp4a
// from shared memory.  Built with --fmad=false: the f32 steps are the twins'
// operations one by one (LayerNorm statistics and the exponentials still
// differ from the twins' in the last bits, so the quantised values may too).

#include "int8_gemm.cuh"

namespace {

using cvt::from_f32;
using cvt::gelu_erf;
using cvt::pack4;
using cvt::quant_i8;
using cvt::row_stats;
using cvt::to_f32;

// ---------------------------------------------------------- mlp_block_int8

constexpr int Q_BM = 32;          // tokens a block
constexpr int Q_THREADS = 512;
constexpr int Q_HC = 256;         // hidden columns a chunk
constexpr int Q_KW = 8;           // words of k a weight tile (32 bytes)
constexpr int Q_LDR = Q_BM + 4;   // row stride of the [word][row] buffers

template <int D> constexpr size_t mlp_int8_smem_bytes() {
  // q1(LN(x)) [D/4][Q_LDR], the gelu chunk [Q_HC/4][Q_LDR], a weight tile [Q_KW][max(Q_HC, D) + 4]
  return sizeof(int) * ((size_t)(D / 4) * Q_LDR + (size_t)(Q_HC / 4) * Q_LDR +
                        (size_t)Q_KW * ((D > Q_HC ? D : Q_HC) + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(Q_THREADS, 1)
mlp_int8_kernel(const T* __restrict__ x, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                const int8_t* __restrict__ w1t, const float* __restrict__ s1, const float* __restrict__ b1,
                const int8_t* __restrict__ w2t, const float* __restrict__ s2, const float* __restrict__ b2,
                const float* __restrict__ inv1, const float* __restrict__ inv2, T* __restrict__ out, int m,
                int dh, float eps) {
  constexpr int NREP = D / 256;             // 256-column groups of the output
  constexpr int LDW2 = D + 4;
  constexpr int NL2 = (2 * D + Q_THREADS - 1) / Q_THREADS;  // 16-byte loads of a qW2 tile a thread
  static_assert(D % 256 == 0, "D must be a multiple of 256");
  extern __shared__ __align__(16) float smem[];
  int* s_h = reinterpret_cast<int*>(smem);   // [D/4][Q_LDR]     q1(LN(x)), four channels a word
  int* s_g = s_h + (D / 4) * Q_LDR;          // [Q_HC/4][Q_LDR]  q2(gelu) of the chunk
  int* s_w = s_g + (Q_HC / 4) * Q_LDR;       // a qW1 tile [Q_KW][Q_HC + 4] or a qW2 tile [Q_KW][LDW2]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = tid >> 6, cg = tid & 63;
  const long long m0 = (long long)blockIdx.x * Q_BM;

  // q1(LN(x)): a warp a row, a lane four channels at a time
  for (int r = warp; r < Q_BM; r += Q_THREADS / 32) {
    const long long row = m0 + r;
    if (row < m) {
      const T* p = x + row * D;
      float mean, rstd;
      row_stats<T>(p, D, eps, 0, lane, mean, rstd);
      for (int w = lane; w < D / 4; w += 32) {
        int q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * w + j;
          q[j] = quant_i8((to_f32<T>(p[c]) - mean) * rstd * ln_g[c] + ln_b[c], inv1[c]);
        }
        s_h[w * Q_LDR + r] = pack4(q[0], q[1], q[2], q[3]);
      }
    } else {
      for (int w = lane; w < D / 4; w += 32) s_h[w * Q_LDR + r] = 0;
    }
  }
  __syncthreads();

  int acc[4][4 * NREP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NREP; ++j) acc[i][j] = 0;

  // a qW1 tile: 256 columns x 32 bytes of k, one 16-byte load a thread
  const int t_col = tid >> 1, t_w = (tid & 1) * 4;
  int4 r1;
  int4 r2[NL2];

  for (int h0 = 0; h0 < dh; h0 += Q_HC) {
    // (a) hj = q1(LN(x)) . qW1[:, h0 : h0 + 256]
    int hj[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) hj[i][j] = 0;
    const int8_t* w1p = w1t + (size_t)(h0 + t_col) * D + 4 * t_w;
    r1 = *reinterpret_cast<const int4*>(w1p);
    for (int k0 = 0; k0 < D / 4; k0 += Q_KW) {
      s_w[(t_w + 0) * (Q_HC + 4) + t_col] = r1.x;
      s_w[(t_w + 1) * (Q_HC + 4) + t_col] = r1.y;
      s_w[(t_w + 2) * (Q_HC + 4) + t_col] = r1.z;
      s_w[(t_w + 3) * (Q_HC + 4) + t_col] = r1.w;
      __syncthreads();
      if (k0 + Q_KW < D / 4) r1 = *reinterpret_cast<const int4*>(w1p + 4 * (k0 + Q_KW));
#pragma unroll
      for (int w = 0; w < Q_KW; ++w) {
        const int4 a = *reinterpret_cast<const int4*>(s_h + (k0 + w) * Q_LDR + 4 * rg);
        const int4 b = *reinterpret_cast<const int4*>(s_w + w * (Q_HC + 4) + 4 * cg);
        const int av[4] = {a.x, a.y, a.z, a.w};
        const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) hj[i][j] = __dp4a(av[i], bv[j], hj[i][j]);
      }
      __syncthreads();
    }

    // (b) q2(gelu(hj * s1 + b1)): this thread's four columns are word cg of the chunk.  The chunk
    // before was read to its end (the barrier that closed its last qW2 tile); the barrier of the
    // first qW2 tile below orders these writes before their reads.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = h0 + 4 * cg + j;
        q[j] = quant_i8(gelu_erf(__int2float_rn(hj[i][j]) * s1[h] + b1[h]), inv2[h]);
      }
      s_g[cg * Q_LDR + 4 * rg + i] = pack4(q[0], q[1], q[2], q[3]);
    }

    // (c) acc += q2 . qW2[h0 : h0 + 256, :], tiles of 32 hidden rows (8 words) by D columns
    auto fetch2 = [&](int k0) {
#pragma unroll
      for (int l = 0; l < NL2; ++l) {
        const int e = tid + Q_THREADS * l;
        if (e < 2 * D) r2[l] = *reinterpret_cast<const int4*>(w2t + (size_t)(e >> 1) * dh + h0 + 4 * k0 + 16 * (e & 1));
      }
    };
    fetch2(0);
    for (int k0 = 0; k0 < Q_HC / 4; k0 += Q_KW) {
#pragma unroll
      for (int l = 0; l < NL2; ++l) {
        const int e = tid + Q_THREADS * l;
        if (e < 2 * D) {
          const int col = e >> 1, w = (e & 1) * 4;
          s_w[(w + 0) * LDW2 + col] = r2[l].x;
          s_w[(w + 1) * LDW2 + col] = r2[l].y;
          s_w[(w + 2) * LDW2 + col] = r2[l].z;
          s_w[(w + 3) * LDW2 + col] = r2[l].w;
        }
      }
      __syncthreads();
      if (k0 + Q_KW < Q_HC / 4) fetch2(k0 + Q_KW);
#pragma unroll
      for (int w = 0; w < Q_KW; ++w) {
        const int4 a = *reinterpret_cast<const int4*>(s_g + (k0 + w) * Q_LDR + 4 * rg);
        const int av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int rep = 0; rep < NREP; ++rep) {
          const int4 b = *reinterpret_cast<const int4*>(s_w + w * LDW2 + rep * 256 + 4 * cg);
          const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][4 * rep + j] = __dp4a(av[i], bv[j], acc[i][4 * rep + j]);
        }
      }
      __syncthreads();
    }
  }

  // out = x + (acc * s2 + b2), in the TPU kernel's order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = m0 + 4 * rg + i;
    if (row >= m) continue;
#pragma unroll
    for (int rep = 0; rep < NREP; ++rep)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = rep * 256 + 4 * cg + j;
        const long long at = row * D + col;
        out[at] = from_f32<T>(to_f32<T>(x[at]) + (__int2float_rn(acc[i][4 * rep + j]) * s2[col] + b2[col]));
      }
  }
}

template <typename T, int D>
cudaError_t launch_mlp_int8(const T* x, const float* ln_g, const float* ln_b, const int8_t* w1t, const float* s1,
                            const float* b1, const int8_t* w2t, const float* s2, const float* b2, const float* inv1,
                            const float* inv2, T* out, int m, int dh, float eps, cudaStream_t stream) {
  constexpr size_t smem = mlp_int8_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(mlp_int8_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  mlp_int8_kernel<T, D><<<(unsigned)((m + Q_BM - 1) / Q_BM), Q_THREADS, smem, stream>>>(
      x, ln_g, ln_b, w1t, s1, b1, w2t, s2, b2, inv1, inv2, out, m, dh, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mlp_block_int8(const T* x, const float* ln_g, const float* ln_b, const int8_t* w1t, const float* s1,
                           const float* b1, const int8_t* w2t, const float* s2, const float* b2,
                           const float* inv1, const float* inv2, T* out, int m, int d, int dh, float eps,
                           cudaStream_t stream) {
  if (m < 1 || dh < Q_HC || dh % Q_HC) return cudaErrorInvalidValue;
#define CVT_MLP_I8_CASE(D) \
  case D:                  \
    return launch_mlp_int8<T, D>(x, ln_g, ln_b, w1t, s1, b1, w2t, s2, b2, inv1, inv2, out, m, dh, eps, stream)
  switch (d) {
    CVT_MLP_I8_CASE(256);
    CVT_MLP_I8_CASE(512);
    CVT_MLP_I8_CASE(768);
    CVT_MLP_I8_CASE(1024);
    CVT_MLP_I8_CASE(1280);
    default:
      return cudaErrorInvalidValue;
  }
#undef CVT_MLP_I8_CASE
}

// ---------------------------------------------------- attention_block_int8

template <typename T>
cudaError_t attention_block_int8(const T* x, const float* ln_g, const float* ln_b, const int8_t* wqkv_t,
                                 const float* s_qkv, const float* b_qkv, const int8_t* wo_t, const float* s_o,
                                 const float* b_o, const float* inv1, const float* inv_o, T* qkv, int8_t* joined,
                                 T* out, int n, int s_len, int d, int heads, float scale, float eps,
                                 cudaStream_t stream) {
  if (heads < 1 || d % heads) return cudaErrorInvalidValue;
  const int m = n * s_len, hd = d / heads;
  cvt::AOperand<T> a_ln{x, ln_g, ln_b, inv1, eps};
  cudaError_t err = cvt::launch_i8_gemm<T, cvt::A_LN>(a_ln, wqkv_t, m, d, 3 * d,
                                                      cvt::EpiAffine<T>{s_qkv, b_qkv, qkv}, stream);
  if (err != cudaSuccess) return err;
  const long long row = 3LL * d;
  err = cvt::attention_core<T>(qkv, qkv + d, qkv + 2 * d, joined, n, s_len, heads, hd, scale, s_len * row, row,
                               hd, (long long)s_len * d, d, hd, stream, inv_o);
  if (err != cudaSuccess) return err;
  cvt::AOperand<T> a_i8{joined, nullptr, nullptr, nullptr, 0.0f};
  return cvt::launch_i8_gemm<T, cvt::A_I8>(a_i8, wo_t, m, d, d, cvt::EpiResidual<T>{s_o, b_o, x, out}, stream);
}

}  // namespace

extern "C" {

// Both launch on `stream` and return the first failed launch's cudaError_t
// (0 on success); neither synchronises.  Weights come transposed: w1t (dh, d),
// w2t (d, dh), wqkv_t (3 d, d), wo_t (d, d), all int8; scales, biases, LayerNorm
// parameters and inverse activation scales are f32 vectors of their width.

int cvt_mlp_block_int8(const void* x, const float* ln_g, const float* ln_b, const void* w1t, const float* s1,
                       const float* b1, const void* w2t, const float* s2, const float* b2, const float* inv1,
                       const float* inv2, void* out, int m, int d, int dh, float eps, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* w1 = (const int8_t*)w1t;
  const int8_t* w2 = (const int8_t*)w2t;
  if (is_bf16)
    return (int)mlp_block_int8<__nv_bfloat16>((const __nv_bfloat16*)x, ln_g, ln_b, w1, s1, b1, w2, s2, b2, inv1,
                                              inv2, (__nv_bfloat16*)out, m, d, dh, eps, st);
  return (int)mlp_block_int8<float>((const float*)x, ln_g, ln_b, w1, s1, b1, w2, s2, b2, inv1, inv2, (float*)out, m,
                                    d, dh, eps, st);
}

// qkv is scratch of n * s_len * 3 d values of T, joined of n * s_len * d int8.
int cvt_attention_block_int8(const void* x, const float* ln_g, const float* ln_b, const void* wqkv_t,
                             const float* s_qkv, const float* b_qkv, const void* wo_t, const float* s_o,
                             const float* b_o, const float* inv1, const float* inv_o, void* qkv, void* joined,
                             void* out, int n, int s_len, int d, int heads, float scale, float eps, int is_bf16,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* wqkv = (const int8_t*)wqkv_t;
  const int8_t* wo = (const int8_t*)wo_t;
  if (is_bf16)
    return (int)attention_block_int8<__nv_bfloat16>(
        (const __nv_bfloat16*)x, ln_g, ln_b, wqkv, s_qkv, b_qkv, wo, s_o, b_o, inv1, inv_o, (__nv_bfloat16*)qkv,
        (int8_t*)joined, (__nv_bfloat16*)out, n, s_len, d, heads, scale, eps, st);
  return (int)attention_block_int8<float>((const float*)x, ln_g, ln_b, wqkv, s_qkv, b_qkv, wo, s_o, b_o, inv1,
                                          inv_o, (float*)qkv, (int8_t*)joined, (float*)out, n, s_len, d, heads,
                                          scale, eps, st);
}

}  // extern "C"
