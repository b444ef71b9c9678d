// The tiled product with an optional LayerNorm prologue that the fused
// sub-blocks share: transformer_block.cu (attention_block) and
// swin_attention.cu (window_attention_block) both instantiate it for their
// QKV and output projections.
//
//   out[m, n] = A'[m, :] . w[:, n] + bias[n]   (+ resid[m, n] first, with RESID)
//
// A' = LN(a) rounded through T with LN, else a.  a is (m, k) of T, w (k, n) of
// T, k a multiple of 16; out is (m, n) of OutT, which is T or float (a float
// output keeps the f32 sums for a later kernel that the TPU kernels kept in
// VMEM).  128 x 128 outputs a block of 256 threads, 8 x 8 a thread, K in steps
// of 16 with the next tiles fetched into registers during the current step;
// with LN the block first takes the mean and variance of its 128 rows and
// normalises A as it is staged.  Scalar f32 FMAs from shared memory for both
// types: no mma, no cp.async, no TMA.
//
// LayerNorm statistics: two passes (mean, then centred squares) over all k
// channels, or, with ln_count > 0, sums of x and x^2 over all k lanes divided
// by ln_count (a zero-padded channel layout whose first ln_count lanes are
// real: m = sum x / count, v = sum x^2 / count - m^2), as the TPU kernels'
// _ln_f32.

#pragma once

#include "attention.cuh"

namespace cvt {

// Mean and 1/sqrt(var + eps) of one row of `d` values, by a whole warp.
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ p, int d, float eps, int count, int lane,
                                          float& mean, float& rstd) {
  if (count > 0) {
    float s = 0.0f, ss = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float v = to_f32<T>(p[c]);
      s += v;
      ss += v * v;
    }
    mean = warp_sum(s) / (float)count;
    rstd = rsqrtf(warp_sum(ss) / (float)count - mean * mean + eps);
    return;
  }
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

constexpr int G_BM = 128;
constexpr int G_BN = 128;
constexpr int G_BK = 16;
constexpr int G_THREADS = 256;
constexpr int G_LDA = G_BM + 4;

template <typename T, typename OutT, bool LN, bool RESID>
__global__ void __launch_bounds__(G_THREADS, 2)
ln_gemm_kernel(const T* __restrict__ a, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
               const T* __restrict__ w, const float* __restrict__ bias, const T* __restrict__ resid,
               OutT* __restrict__ out, int m, int k, int n, float eps, int ln_count) {
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
      if (m0 + r < m) row_stats<T>(a + (size_t)(m0 + r) * k, k, eps, ln_count, lane, mean, rstd);
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
      out[at] = from_f32<OutT>(val + bias[col]);
    }
  }
}

template <typename T, typename OutT, bool LN, bool RESID>
cudaError_t launch_ln_gemm(const T* a, const float* ln_g, const float* ln_b, const T* w, const float* bias,
                           const T* resid, OutT* out, int m, int k, int n, float eps, int ln_count,
                           cudaStream_t stream) {
  const int rows = (m + G_BM - 1) / G_BM, cols = (n + G_BN - 1) / G_BN;
  if (m < 1 || n < 1 || k < G_BK || k % G_BK || rows > 65535) return cudaErrorInvalidValue;
  ln_gemm_kernel<T, OutT, LN, RESID><<<dim3(cols, rows), G_THREADS, 0, stream>>>(a, ln_g, ln_b, w, bias, resid,
                                                                                out, m, k, n, eps, ln_count);
  return cudaGetLastError();
}

}  // namespace cvt
