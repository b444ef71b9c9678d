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
// the int8 activations in vregs.  Here it is three launches, as the bf16
// mlp_block is (transformer_block.cu):
// (1) ln_quant_rows_kernel, a warp a row: the row's statistics once
// (row_stats), then q1(LN(x)) into an (m, D) int8 buffer, four channels a word;
// (2) the up-projection q1 . qW1 on the int8 tensor cores (i8_tc_gemm_kernel,
// wgmma m64n128k32 s8 x s8 into int32 sums), its epilogue
// q2(gelu(acc * s1 + b1)) into an (m, Dh) int8 hidden, the 128 x 128 tile
// staged in the free ring and stored 16 bytes a thread;
// (3) the down-projection hidden . qW2 on the same product, its epilogue
// x + (acc * s2 + b2) rounded to T.
// The product is tc_gemm_kernel's (ln_gemm.cuh) in bytes: a block of two
// warpgroups owns 128 x 128 outputs, 64 int32 sums a thread; k runs in tiles of
// 128 (one 128-byte swizzled row of int8), four k32 wgmma a tile, copied by all
// threads with cp.async into a ring of 3 stages (97 KB, two blocks an SM).
// 8-bit wgmma takes both operands K-major only: A (q1 or the hidden) is
// row-major (m, k), and the weights come transposed, qW1^T (Dh, D) and qW2^T
// (D, Dh), a row of k for each output column.  Rows past m are copied as zeros
// (cp.async's zero fill) and not stored; D and Dh are multiples of 128 (the
// wrapper takes D in 256 .. 1280 by 256 and Dh a multiple of 256).  The int8
// LN rows and the hidden make one round trip through device memory (2 m (D +
// Dh) bytes, 0.116 ms at ViT-B/16 b256), where the TPU kernel keeps them in
// VMEM: a down-projection fused behind the up-projection would hold (64, D)
// int32 sums a warpgroup, D / 2 registers a thread, past 255 at D 768.  Every
// sum is one int32 sum over the whole k (exact in any order: |acc| <= 5120 *
// 127^2 < 2^31), and the f32 steps are the dp4a kernel's that this replaced,
// one by one, so the output is that kernel's bit for bit: JAX's order wherever
// its hidden dim is one block (ViT-B and ViT-L), while at ViT-H it sums four
// f32 partials.
//
// attention_block_int8.  Three launches, as the bf16 attention_block:
// (1) LN + q1 + int8 QKV product + s * acc + b into an (N S, 3 D) buffer of T
// (the tiled product of int8_gemm.cuh, A quantised while it is staged);
// (2) the attention core of attention.cuh reading q, k, v out of that buffer
// by strides, its f32 head outputs quantised by qo in its epilogue into an
// (N S, D) int8 buffer (the TPU kernel quantises the f32 output, so nothing
// is rounded through T there); (3) the int8 output projection + so * acc + bo
// + residual.  Head dims 16, 64 and 80.  Its two products are still the dp4a
// product of int8_gemm.cuh (no tensor core).
//
// Bound.  At ViT-B/16 batch 256 (50,432 tokens) mlp_block_int8 does 476 G int8
// operations on 155 MB, attention_block_int8 268 G: operations bind both at
// the int8 tensor-core rate (1,979 TOP/s).  Built with --fmad=false: the f32
// steps are the twins' operations one by one (LayerNorm statistics and the
// exponentials still differ from the twins' in the last bits, so the quantised
// values may too).

#include "int8_gemm.cuh"

namespace {

using cvt::bf16;
using cvt::cp_async16;
using cvt::cp_async_commit;
using cvt::cp_async_wait;
using cvt::fence_proxy_async;
using cvt::fence_sums;
using cvt::from_f32;
using cvt::gelu_erf;
using cvt::load2;
using cvt::pack4;
using cvt::quant_i8;
using cvt::ROW_THREADS;
using cvt::row_stats;
using cvt::smem_addr;
using cvt::store2;
using cvt::sw128_desc;
using cvt::to_f32;
using cvt::wgmma_commit;
using cvt::wgmma_fence;
using cvt::wgmma_m64n128k32_s8;
using cvt::wgmma_wait;

// ---------------------------------------------------------- mlp_block_int8

// (1) q1 = clamp(rint(LN(x) * inv1)) of each row into int8, a warp a row
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

// (2), (3) out = Epi(a . bt^T): a (m, k) and bt (n, k) int8, both rows of k; the epilogues, on the int32 sum:
//   Q8_GELU   q2(gelu(acc * scale[n] + bias[n])) with inv[n], into int8
//   Q8_RESID  resid[m, n] + (acc * scale[n] + bias[n]), rounded to T
enum { Q8_GELU = 0, Q8_RESID = 1 };

constexpr int Q8_BM = 128;  // two warpgroups of 64 rows
constexpr int Q8_BN = 128;
constexpr int Q8_BK = 128;  // one 128-byte swizzled row of int8: four k32 steps
constexpr int Q8_STAGES = 3;
constexpr int Q8_AHEAD = Q8_STAGES - 1;  // tiles copied ahead of the products
constexpr int Q8_THREADS = 256;
constexpr int Q8_TILE_BYTES = Q8_BM * Q8_BK;  // the A and the B tile alike
constexpr int Q8_STAGE_BYTES = 2 * Q8_TILE_BYTES;
constexpr size_t Q8_SMEM = (size_t)Q8_STAGES * Q8_STAGE_BYTES + 1024;  // + room to align to 1024
constexpr int Q8_CHUNKS = Q8_TILE_BYTES / 16 / Q8_THREADS;              // 16-byte copies a thread a tile
constexpr int Q8_LDT = Q8_BN + 16;  // row stride of the int8 output tile staged in the ring (no bank conflicts)
static_assert(Q8_BM == Q8_BN && Q8_CHUNKS == 4 && Q8_SMEM <= 113 * 1024 && Q8_BM * Q8_LDT <= Q8_STAGE_BYTES,
              "tiles; two blocks an SM; the output tile fits a stage");

template <typename T>
struct Q8Epi {
  const float* scale;  // (n,)
  const float* bias;   // (n,)
  const float* inv;    // Q8_GELU: the hidden's inverse activation scale (n,)
  const T* resid;      // Q8_RESID: (m, n)
  void* out;           // (m, n) of int8 (Q8_GELU) or T (Q8_RESID)
};

template <int EPI, typename T>
__global__ void __launch_bounds__(Q8_THREADS, 2)
i8_tc_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt, Q8Epi<T> epi, int m, int k, int n) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * Q8_BM, n0 = blockIdx.x * Q8_BN;
  const int k_tiles = k / Q8_BK;

  // both tiles K-major: row r (of m, or of n), chunk c of 16 k at r * 128 + (c ^ r % 8) * 16
  auto load = [&](int stage, int kt) {
    const int k0 = kt * Q8_BK;
    const uint32_t sa = base + stage * Q8_STAGE_BYTES, sb = sa + Q8_TILE_BYTES;
#pragma unroll
    for (int i = 0; i < Q8_CHUNKS; ++i) {
      const int e = tid + i * Q8_THREADS;
      const int r = e >> 3, c = e & 7;
      const uint32_t at = r * 128 + ((c ^ (r & 7)) << 4);
      const bool a_ok = m0 + r < m, b_ok = n0 + r < n;
      cp_async16(sa + at, a + (a_ok ? (size_t)(m0 + r) * k + k0 + c * 16 : 0), a_ok);
      cp_async16(sb + at, bt + (b_ok ? (size_t)(n0 + r) * k + k0 + c * 16 : 0), b_ok);
    }
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  // the stage a step refills held the tile of the step before, whose products the wait that closed that step
  // retired in both warpgroups (the barrier orders them)
#pragma unroll
  for (int s = 0; s < Q8_AHEAD; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<Q8_AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    const int next = kt + Q8_AHEAD;
    if (next < k_tiles) load(next % Q8_STAGES, next);
    cp_async_commit();
    const uint32_t sa = base + (kt % Q8_STAGES) * Q8_STAGE_BYTES, sb = sa + Q8_TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < Q8_BK / 32; ++s)
      wgmma_m64n128k32_s8(acc, sw128_desc(sa + wg * (64 * 128) + s * 32, 16, 1024), sw128_desc(sb + s * 32, 16, 1024),
                          1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_sums(acc);

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int t0 = wg * 64 + warp * 16 + (lane >> 2);  // this thread's first row in the tile
  if (EPI == Q8_GELU) {
    // the int8 tile through shared memory (the ring is free: both warpgroups' products have retired, no copy is
    // in flight), then to the hidden 16 bytes a thread, eight threads a row
    int8_t* tile = reinterpret_cast<int8_t*>(smem) + (base - smem_addr(smem));
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < Q8_BN / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2, col = n0 + c;  // n is a multiple of 16: the chunk is in or out
      if (col >= n) continue;
      const float sc0 = epi.scale[col], sc1 = epi.scale[col + 1], b0 = epi.bias[col], b1 = epi.bias[col + 1];
      const float inv0 = epi.inv[col], inv1 = epi.inv[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q0 = quant_i8(gelu_erf(__int2float_rn(acc[4 * j + 2 * h]) * sc0 + b0), inv0);
        const int q1 = quant_i8(gelu_erf(__int2float_rn(acc[4 * j + 2 * h + 1]) * sc1 + b1), inv1);
        *reinterpret_cast<uint16_t*>(tile + (t0 + 8 * h) * Q8_LDT + c) = (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < Q8_CHUNKS; ++i) {
      const int e = tid + i * Q8_THREADS;
      const int r = e >> 3, c = (e & 7) * 16;
      if (m0 + r < m && n0 + c < n)
        *reinterpret_cast<int4*>(static_cast<int8_t*>(epi.out) + (size_t)(m0 + r) * n + n0 + c) =
            *reinterpret_cast<const int4*>(tile + r * Q8_LDT + c);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < Q8_BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= n) continue;
    const float sc0 = epi.scale[col], sc1 = epi.scale[col + 1], b0 = epi.bias[col], b1 = epi.bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + t0 + 8 * h;
      if (row >= m) continue;
      const size_t at = (size_t)row * n + col;
      float x0, x1;
      load2(epi.resid + at, x0, x1);
      store2(static_cast<T*>(epi.out) + at, x0 + (__int2float_rn(acc[4 * j + 2 * h]) * sc0 + b0),
             x1 + (__int2float_rn(acc[4 * j + 2 * h + 1]) * sc1 + b1));
    }
  }
}

template <int EPI, typename T>
cudaError_t launch_i8_tc_gemm(const int8_t* a, const int8_t* bt, const Q8Epi<T>& epi, int m, int k, int n,
                              cudaStream_t stream) {
  const int rows = (m + Q8_BM - 1) / Q8_BM, cols = (n + Q8_BN - 1) / Q8_BN;
  if (m < 1 || n < 16 || n % 16 || k < Q8_BK || k % Q8_BK || rows > 65535) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(i8_tc_gemm_kernel<EPI, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q8_SMEM);
  if (err != cudaSuccess) return err;
  i8_tc_gemm_kernel<EPI, T><<<dim3(cols, rows), Q8_THREADS, Q8_SMEM, stream>>>(a, bt, epi, m, k, n);
  return cudaGetLastError();
}

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
