// Shared pieces of the transformer kernels for Hopper (sm_90a): the storage
// type helpers and the softmax(scale * Q K^T) V core that attention.cu
// (flash_mha), transformer_block.cu (attention_block) and int8_transformer.cu
// (attention_block_int8) instantiate.  attention_core() routes by type: bf16
// runs the tensor-core core of tc_attention.cuh, float32 the split-TF32 core
// of tf32x3_attention.cuh, each at head dims 16, 64 and 80, into T or (the
// int8 attention block) int8.  The scalar attention_core_kernel below serves
// no route: it is the float32 yardstick of the split-TF32 core's distance
// from float64 (attention.cu: cvt_attention_core_scalar).
//
// Types.  A kernel is a template over its storage type T, float or
// __nv_bfloat16.  Every operand is widened to f32 when it is staged in shared
// memory (exact for both types), every product and sum is an f32 FMA, and a
// value that the TPU kernels cast to the compute type (probabilities before
// P V, the head outputs) is rounded through T with round_to<T>, to nearest
// even, at the same place.
//
// The scalar core.  One block owns ATT_BQ = 64 query rows of one head of
// one image and streams the keys in tiles of ATT_BK = 64 with an online
// softmax (running row maximum and sum), so the (S, S) scores never exist in
// any memory: a tile of them lives in registers, its probabilities in shared
// memory.  Keys past S are masked with -inf before the row maximum, query rows
// past S are computed on zeros and not stored.  256 threads as 16 x 16: thread
// (ty, tx) owns query rows 4 ty .. 4 ty + 3, for the scores the keys
// tx + 16 j, for the output the head dims tx + 16 e.  Row reductions run over
// the 16 lanes of a half warp with shuffles.  Rows of Q, K, V sit in shared
// memory at a stride of hd + 4 words, which keeps float4 reads aligned and
// spreads eight rows over all 32 banks.
//
// Layouts are strides, so no transpose is ever materialised: element
// (n, s, h, d) of q, k and v is at n * in_n + s * in_s + h * in_h + d, and of
// the output at n * o_n + s * o_s + h * o_h + d.
//
// The output is of T, or (OutT = int8_t, for the int8 attention block) the f32
// head outputs quantised in the epilogue, clamp(rint(o * o_inv[h hd + d]),
// -127, 127), with o_inv the inverse activation scale of each joined channel:
// the quantised tensor is what the output projection reads, a quarter of the
// f32 one's bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cvt {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v after a cast to T, widened again
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// an attention output as OutT; o_inv[c] is read for int8 only
template <typename OutT> __device__ __forceinline__ OutT core_out(float v, const float* o_inv, int c) {
  return from_f32<OutT>(v);
}
template <> __device__ __forceinline__ int8_t core_out<int8_t>(float v, const float* o_inv, int c) {
  return (int8_t)fminf(fmaxf(rintf(v * o_inv[c]), -127.0f), 127.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Blocks of the kernel fn, at `threads` threads and `smem` dynamic shared bytes, that fit on an SM of the current
// card (a persistent grid's size: depthwise.cu, the LayerNorm backward of ln_gemm.cuh): asked of the runtime once
// a (card, kernel, threads, smem) and kept, so that a launch is its choice and the launch alone.  The kernel's
// shared-memory limit is raised to `smem_limit`, the most any of its launches takes, never to one call's smem: a
// later call with more would find it lowered.  Past 64 of them it asks each time.
inline cudaError_t blocks_per_sm(const void* fn, int threads, size_t smem, int smem_limit, int* per_sm) {
  struct Seen {
    int device;
    const void* fn;
    int threads;
    size_t smem;
    int per_sm;
  };
  static Seen seen[64];
  static int n_seen = 0;
  static std::mutex mu;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].device == device && seen[i].fn == fn && seen[i].threads == threads && seen[i].smem == smem) {
      *per_sm = seen[i].per_sm;
      return cudaSuccess;
    }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (n_seen < 64) seen[n_seen++] = Seen{device, fn, threads, smem, *per_sm};
  return cudaSuccess;
}

constexpr int ATT_BQ = 64;
constexpr int ATT_BK = 64;
constexpr int ATT_THREADS = 256;
constexpr int ATT_LDP = ATT_BK + 4;

template <int HD> constexpr size_t attention_smem_bytes() {
  return sizeof(float) * ((size_t)(ATT_BQ + 2 * ATT_BK) * (HD + 4) + (size_t)ATT_BQ * ATT_LDP);
}

template <typename T, int HD, typename OutT>
__global__ void __launch_bounds__(ATT_THREADS)
attention_core_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      OutT* __restrict__ o, int s_len, float scale, long long in_n, long long in_s,
                      long long in_h, long long o_n, long long o_s, long long o_h,
                      const float* __restrict__ o_inv) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;  // head dims a thread owns
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                 // [ATT_BQ][LD]
  float* s_k = s_q + ATT_BQ * LD;    // [ATT_BK][LD]
  float* s_v = s_k + ATT_BK * LD;    // [ATT_BK][LD]
  float* s_p = s_v + ATT_BK * LD;    // [ATT_BQ][ATT_LDP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * ATT_BQ;
  const long long in_base = (long long)blockIdx.z * in_n + (long long)blockIdx.y * in_h;
  const T* qb = q + in_base;
  const T* kb = k + in_base;
  const T* vb = v + in_base;

  for (int e = tid; e < ATT_BQ * HD; e += ATT_THREADS) {
    const int r = e / HD, d = e - r * HD;
    const int row = q0 + r;
    s_q[r * LD + d] = row < s_len ? to_f32<T>(qb[(long long)row * in_s + d]) : 0.0f;
  }

  float m_run[4], l_run[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.0f;
  }

  for (int k0 = 0; k0 < s_len; k0 += ATT_BK) {
    __syncthreads();  // the tile before is read to its end (and s_q is written)
    for (int e = tid; e < ATT_BK * HD; e += ATT_THREADS) {
      const int r = e / HD, d = e - r * HD;
      const int key = k0 + r;
      const bool in = key < s_len;
      s_k[r * LD + d] = in ? to_f32<T>(kb[(long long)key * in_s + d]) : 0.0f;
      s_v[r * LD + d] = in ? to_f32<T>(vb[(long long)key * in_s + d]) : 0.0f;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = (k0 + tx + 16 * j < s_len) ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // key k0 is always real, so m_new is finite; exp(-inf - m_new) = 0 on the first tile
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        s_p[(4 * ty + i) * ATT_LDP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < ATT_BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(s_p + (4 * ty + i) * ATT_LDP + kk);
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float v0 = s_v[(kk + 0) * LD + tx + 16 * e];
        const float v1 = s_v[(kk + 1) * LD + tx + 16 * e];
        const float v2 = s_v[(kk + 2) * LD + tx + 16 * e];
        const float v3 = s_v[(kk + 3) * LD + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][e] += pa[i].x * v0;
          acc[i][e] += pa[i].y * v1;
          acc[i][e] += pa[i].z * v2;
          acc[i][e] += pa[i].w * v3;
        }
      }
    }
  }

  OutT* ob = o + (long long)blockIdx.z * o_n + (long long)blockIdx.y * o_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= s_len) continue;
    const float inv = 1.0f / l_run[i];
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      ob[(long long)row * o_s + tx + 16 * e] = core_out<OutT>(acc[i][e] * inv, o_inv, blockIdx.y * HD + tx + 16 * e);
  }
}

template <typename T, int HD, typename OutT>
cudaError_t launch_attention_core(const T* q, const T* k, const T* v, OutT* o, int n, int s_len, int heads,
                                  float scale, long long in_n, long long in_s, long long in_h,
                                  long long o_n, long long o_s, long long o_h, cudaStream_t stream,
                                  const float* o_inv) {
  constexpr size_t smem = attention_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(attention_core_kernel<T, HD, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_len + ATT_BQ - 1) / ATT_BQ, heads, n);
  attention_core_kernel<T, HD, OutT><<<grid, ATT_THREADS, smem, stream>>>(q, k, v, o, s_len, scale, in_n, in_s,
                                                                          in_h, o_n, o_s, o_h, o_inv);
  return cudaGetLastError();
}

}  // namespace cvt

#include "tc_attention.cuh"
#include "tf32x3_attention.cuh"

namespace cvt {

// launch(n0, images, h0, heads) for the images and heads of a core in pieces of at most MAX_GRID_YZ of each (the
// grid's z and y); the first failed launch's error
template <class Launch>
cudaError_t over_images_heads(int n, int heads, Launch launch) {
  for (int n0 = 0; n0 < n; n0 += MAX_GRID_YZ)
    for (int h0 = 0; h0 < heads; h0 += MAX_GRID_YZ) {
      const cudaError_t err = launch(n0, min(MAX_GRID_YZ, n - n0), h0, min(MAX_GRID_YZ, heads - h0));
      if (err != cudaSuccess) return err;
    }
  return cudaSuccess;
}

// One launch of the tensor-core core of T at head dim HD, at most MAX_GRID_YZ images and heads.
template <int HD, typename T, typename OutT>
cudaError_t attention_tc_piece(const T* q, const T* k, const T* v, OutT* o, int n, int s_len, int heads, float scale,
                               long long in_n, long long in_s, long long in_h, long long o_n, long long o_s,
                               long long o_h, cudaStream_t stream, const float* o_inv) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_attention_tc<HD, OutT>(q, k, v, o, n, s_len, heads, scale, in_n, in_s, in_h, o_n, o_s, o_h, stream,
                                         o_inv);
  else
    return launch_attention_x3<HD, OutT>(q, k, v, o, n, s_len, heads, scale, in_n, in_s, in_h, o_n, o_s, o_h, stream,
                                         o_inv);
}

// f(std::integral_constant<int, HD>{}) at the cores' head dim hd (16, 64 or 80: HEAD_DIMS of
// ops/kernels/flash_attention.py); any other hd is refused.  The one list of the instantiated head dims.
template <class F>
cudaError_t with_head_dim(int hd, F f) {
  switch (hd) {
    case 16:
      return f(std::integral_constant<int, 16>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 80:
      return f(std::integral_constant<int, 80>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// Head dims 16, 64 and 80; any other is refused.  o_inv: the int8 output's
// inverse scales, one a joined channel (OutT = int8_t only).  Both cores copy
// 16 bytes at a time, so q, k, v and their strides must be 16-byte aligned;
// they are refused otherwise.  Any number of images and heads: pieces of
// MAX_GRID_YZ launch one after another on the offset tensors.
template <typename T, typename OutT>
cudaError_t attention_core(const T* q, const T* k, const T* v, OutT* o, int n, int s_len, int heads, int hd,
                           float scale, long long in_n, long long in_s, long long in_h, long long o_n,
                           long long o_s, long long o_h, cudaStream_t stream, const float* o_inv = nullptr) {
  if (n < 1 || heads < 1 || s_len < 1) return cudaErrorInvalidValue;
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    return over_images_heads(n, heads, [&](int n0, int nc, int h0, int hc) -> cudaError_t {
      const long long in0 = n0 * in_n + h0 * in_h;
      const float* inv = o_inv == nullptr ? nullptr : o_inv + (long long)h0 * HD;
      return attention_tc_piece<HD>(q + in0, k + in0, v + in0, o + n0 * o_n + h0 * o_h, nc, s_len, hc, scale, in_n,
                                    in_s, in_h, o_n, o_s, o_h, stream, inv);
    });
  });
}

}  // namespace cvt
