// The int8 tiled product that int8_matmul.cu (int8_matmul_requant) and
// int8_transformer.cu (attention_block_int8's two projections) instantiate:
//
//   acc[m, n] = sum_k A[m, k] * B[k, n]      int8 x int8 -> int32, exact
//   out[m, n] = Epi(acc[m, n], m, n)         an epilogue in f32
//
// B is given transposed, bt (n, k) row-major: both operands then run along k
// in memory, and four k of a row are one 32-bit word, the operand of __dp4a
// (four int8 products and their sum into an int32 in one instruction).  A is
// either an int8 (m, k) matrix (A_I8), or (A_LN) the LayerNorm of an (m, k)
// matrix of T, quantised while it is staged: q = clamp(rint(LN(x)[c] *
// inv[c]), -127, 127) with LN(x) = (x - mean) * rstd * g + b in f32, as the
// TPU kernels' _ln_f32 and _quant.
//
// 128 x 128 outputs a block of 256 threads, 8 x 8 a thread; K in steps of 32
// bytes (8 words) staged as [word][row] and [word][col] in shared memory, the
// next step's operands fetched into registers during the current one.  k is
// a multiple of 16 (one 16-byte load of a row a thread), and every row starts
// 16-byte aligned.  A ragged m or n is masked.  No mma, no cp.async, no TMA:
// dp4a from shared memory.
//
// Exactness.  Every sum is an integer sum in int32 (|acc| <= k * 127^2, below
// 2^31 for k < 133,000).  The epilogues convert acc with __int2float_rn and
// run their f32 operations one by one in the twins' order; the sources that
// include this header build with --fmad=false, so no product and sum are
// contracted into one rounding.

#pragma once

#include <stdint.h>

#include "ln_gemm.cuh"

namespace cvt {

constexpr int I_BM = 128;
constexpr int I_BN = 128;
constexpr int I_BKW = 8;  // words of k a step (32 bytes)
constexpr int I_THREADS = 256;
constexpr int I_LD = I_BM + 4;

// rint, then clamp to +-127, as int8: the TPU kernels' _quant
__device__ __forceinline__ int quant_i8(float f, float inv) {
  return (int)fminf(fmaxf(rintf(f * inv), -127.0f), 127.0f);
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24);
}

// 16 values of T at p as f32 (p 16-byte aligned)
template <typename T> __device__ __forceinline__ void load16(const T* p, float (&v)[16]);
template <> __device__ __forceinline__ void load16<float>(const float* p, float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = reinterpret_cast<const float4*>(p)[j];
    v[4 * j] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
}
template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p, float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int4 raw = reinterpret_cast<const int4*>(p)[j];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[8 * j + e] = __bfloat162float(h[e]);
  }
}

enum ASource { A_I8, A_LN };

// Operand A of a block: int8 rows (A_I8), or LN(x) of rows of T quantised by inv (A_LN).
template <typename T>
struct AOperand {
  const void* a;         // (m, k) of int8 or of T
  const float* ln_g;     // A_LN: LayerNorm scale and shift (k,) and the
  const float* ln_b;     //       per-channel inverse activation scale (k,)
  const float* inv;
  float eps;
};

template <typename T, ASource SRC, typename Epi>
__global__ void __launch_bounds__(I_THREADS, 2)
i8_gemm_kernel(AOperand<T> A, const int8_t* __restrict__ bt, int m, int k, int n, Epi epi) {
  __shared__ __align__(16) int s_a[I_BKW * I_LD];  // [word][row]
  __shared__ __align__(16) int s_b[I_BKW * I_LD];  // [word][col]
  __shared__ float s_mean[I_BM];
  __shared__ float s_rstd[I_BM];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * I_BM;
  const int n0 = blockIdx.y * I_BN;

  if (SRC == A_LN) {
    const int warp = tid >> 5, lane = tid & 31;
    const T* x = static_cast<const T*>(A.a);
    for (int r = warp; r < I_BM; r += I_THREADS / 32) {
      float mean = 0.0f, rstd = 0.0f;
      if (m0 + r < m) row_stats<T>(x + (m0 + r) * k, k, A.eps, 0, lane, mean, rstd);
      if (lane == 0) {
        s_mean[r] = mean;
        s_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  // a thread stages 16 k of one row of A and 16 k of one column of B
  const int s_row = tid >> 1, s_k = (tid & 1) * 16;
  const bool a_in = m0 + s_row < m, b_in = n0 + s_row < n;
  const int8_t* b_ptr = bt + (size_t)(b_in ? n0 + s_row : 0) * k + s_k;
  int4 ra, rb;

  // a step of 32 bytes may end half full (k a multiple of 16): that half is zeros
  auto fetch = [&](int k0) {
    const bool k_in = k0 + s_k < k;
    rb = b_in && k_in ? *reinterpret_cast<const int4*>(b_ptr + k0) : make_int4(0, 0, 0, 0);
    if (!a_in || !k_in) {
      ra = make_int4(0, 0, 0, 0);
    } else if (SRC == A_I8) {
      ra = *reinterpret_cast<const int4*>(static_cast<const int8_t*>(A.a) + (m0 + s_row) * k + k0 + s_k);
    } else {
      float v[16];
      load16<T>(static_cast<const T*>(A.a) + (m0 + s_row) * k + k0 + s_k, v);
      const float mean = s_mean[s_row], rstd = s_rstd[s_row];
      int q[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = k0 + s_k + j;
        q[j] = quant_i8((v[j] - mean) * rstd * A.ln_g[c] + A.ln_b[c], A.inv[c]);
      }
      ra = make_int4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                     pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
    }
  };

  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  const int w0 = (tid & 1) * 4;
  fetch(0);
  for (int k0 = 0; k0 < k; k0 += 4 * I_BKW) {
    s_a[(w0 + 0) * I_LD + s_row] = ra.x;
    s_a[(w0 + 1) * I_LD + s_row] = ra.y;
    s_a[(w0 + 2) * I_LD + s_row] = ra.z;
    s_a[(w0 + 3) * I_LD + s_row] = ra.w;
    s_b[(w0 + 0) * I_LD + s_row] = rb.x;
    s_b[(w0 + 1) * I_LD + s_row] = rb.y;
    s_b[(w0 + 2) * I_LD + s_row] = rb.z;
    s_b[(w0 + 3) * I_LD + s_row] = rb.w;
    __syncthreads();
    if (k0 + 4 * I_BKW < k) fetch(k0 + 4 * I_BKW);
#pragma unroll
    for (int w = 0; w < I_BKW; ++w) {
      const int4 a0 = *reinterpret_cast<const int4*>(s_a + w * I_LD + ty * 8);
      const int4 a1 = *reinterpret_cast<const int4*>(s_a + w * I_LD + ty * 8 + 4);
      const int4 b0 = *reinterpret_cast<const int4*>(s_b + w * I_LD + tx * 4);
      const int4 b1 = *reinterpret_cast<const int4*>(s_b + w * I_LD + 64 + tx * 4);
      const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + ty * 8 + i;
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + tx * 4;
      epi.store4(row, col, n, acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

// Launch on (m, k) x (k, n); the grid's x runs over rows (up to 2^31 - 1 blocks).
template <typename T, ASource SRC, typename Epi>
cudaError_t launch_i8_gemm(const AOperand<T>& a, const int8_t* bt, int m, int k, int n, const Epi& epi,
                           cudaStream_t stream) {
  const long long rows = ((long long)m + I_BM - 1) / I_BM;
  const int cols = (n + I_BN - 1) / I_BN;
  if (m < 1 || n < 1 || k < 16 || k % 16 || cols > 65535) return cudaErrorInvalidValue;
  i8_gemm_kernel<T, SRC, Epi><<<dim3((unsigned)rows, cols), I_THREADS, 0, stream>>>(a, bt, m, k, n, epi);
  return cudaGetLastError();
}

// Four consecutive outputs of a row (cols col .. col + 3, those below n).
// out = from_f32<OutT>(float(acc) * scale[c] + bias[c]), the affine epilogue.
template <typename OutT>
struct EpiAffine {
  const float* scale;
  const float* bias;
  OutT* out;
  __device__ __forceinline__ void store4(long long row, int col, int n, int a0, int a1, int a2, int a3) const {
    const int a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < n) out[row * n + col + j] = from_f32<OutT>(__int2float_rn(a[j]) * scale[col + j] + bias[col + j]);
  }
};

// out = from_f32<T>((resid + float(acc) * scale[c]) + bias[c]): an output
// projection added to its residual, in the TPU kernel's order.
template <typename T>
struct EpiResidual {
  const float* scale;
  const float* bias;
  const T* resid;
  T* out;
  __device__ __forceinline__ void store4(long long row, int col, int n, int a0, int a1, int a2, int a3) const {
    const int a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (col + j >= n) continue;
      const long long at = row * n + col + j;
      out[at] = from_f32<T>((to_f32<T>(resid[at]) + __int2float_rn(a[j]) * scale[col + j]) + bias[col + j]);
    }
  }
};

}  // namespace cvt
