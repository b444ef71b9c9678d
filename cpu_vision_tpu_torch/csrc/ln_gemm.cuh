// The bf16 tiled product and the LayerNorm row passes that the fused
// sub-blocks share: transformer_block.cu (mlp_block, cn_mlp_block,
// attention_block) and swin_attention.cu (window_attention_block) launch them
// for their projections, and the int8 sources take row_stats and gelu_erf
// from here.  Their float32 products are split TF32 (tf32x3.cuh) after the
// same row passes.
//
// bfloat16: tc_gemm_kernel, the tensor cores through wgmma (hopper.cuh),
//
//   out[m, n] = Epi(a[m, :] . w[:, n])   a (m, k), w (k, n) bf16, f32 sums
//
// with the epilogues, on the f32 sum before one rounding to OutT (bf16, or
// f32 for a later kernel that the TPU kernels kept in VMEM):
//   TC_BIAS    acc + bias[n]
//   TC_GELU    gelu_erf(acc + bias[n])
//   TC_RESID   resid[m, n] + (acc + bias[n]) (* gamma[n] first, where given)
// A LayerNorm before the product is its own pass, ln_rows_kernel, a warp a
// row: LN(x) rounded to T (bf16, or f32 for the split-TF32 products) into an
// (m, k) buffer; each row's statistics are taken once, not once for each
// column tile.
//
// Bound and design.  The products of the transformer blocks do 2 k flops a
// byte and more (ViT-B/16's MLP 476 GFLOP on 155 MB), so the tensor cores
// bind them.  A block of 256 threads (two warpgroups) owns 128 x 128 outputs,
// each warpgroup 64 rows of them in 64 f32 registers a thread.  K runs in
// tiles of 64: the A tile (128 x 64) and the B tile (64 x 128) of a step are
// copied by all threads with cp.async into a ring of TC_STAGES stages of
// shared memory, in the 128-byte swizzle, TC_AHEAD tiles ahead of the
// products; each warpgroup then starts four wgmma m64n128k16 on the stage and
// waits for them (TC_INFLIGHT 0) while the next steps' copies land.  The ring
// of 3 stages (97 KB) lets two blocks share an SM, so one block's copies,
// products and epilogue hide behind the other's: 1.4-1.6x faster than 4
// stages and one block an SM, with one product left in flight or none
// (tools/torch_tc_product_ab.py).  Outputs are stored in pairs of adjacent
// columns.  Rows past m,
// columns past n and k past the end are copied as zeros (cp.async's zero
// fill) and not stored; k is a multiple of 16 (steps of 16 past k are
// skipped) and n of 8.  No atomics: every call gives the same bits.
//
// LayerNorm statistics: two passes (mean, then centred squares) over all k
// channels, or, with ln_count > 0, sums of x and x^2 over all k lanes divided
// by ln_count (a zero-padded channel layout whose first ln_count lanes are
// real: m = sum x / count, v = sum x^2 / count - m^2), as the TPU kernels'
// _ln_f32.

#pragma once

#include "attention.cuh"
#include "hopper.cuh"

namespace cvt {

// The TPU kernels' erf, the Abramowitz-Stegun 7.1.26 polynomial (|err| <
// 1.5e-7), not erff; and the exact-erf gelu over it.
__device__ __forceinline__ float erf_poly(float x) {
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return copysignf(1.0f - poly * expf(-a * a), x);
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erf_poly(h * 0.70710678118654752f));
}

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

// ------------------------------------------------------------ row passes

constexpr int ROW_THREADS = 256;  // a warp a row

// LN of a row of at most 32 HELD values, read once into HELD registers a lane:
// the sums of row_stats in its order (trailing zeros add nothing), with one
// trip to device memory instead of three
template <typename T, int HELD>
__device__ __forceinline__ void ln_row_held(const T* __restrict__ p, const float* __restrict__ ln_g,
                                            const float* __restrict__ ln_b, T* __restrict__ o, int d, float eps,
                                            int ln_count, int lane) {
  float v[HELD], s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int j = 0; j < HELD; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < d ? to_f32<T>(p[c]) : 0.0f;
    s += v[j];
    ss += v[j] * v[j];
  }
  float mean, rstd;
  if (ln_count > 0) {
    mean = warp_sum(s) / (float)ln_count;
    rstd = rsqrtf(warp_sum(ss) / (float)ln_count - mean * mean + eps);
  } else {
    mean = warp_sum(s) / (float)d;
    float var = 0.0f;
#pragma unroll
    for (int j = 0; j < HELD; ++j) {
      const float dv = v[j] - mean;
      if (lane + 32 * j < d) var += dv * dv;
    }
    rstd = rsqrtf(warp_sum(var) / (float)d + eps);
  }
#pragma unroll
  for (int j = 0; j < HELD; ++j) {
    const int c = lane + 32 * j;
    if (c < d) o[c] = from_f32<T>((v[j] - mean) * rstd * ln_g[c] + ln_b[c]);
  }
}

// rows up to 32 LN_HELD_MAX wide are held in registers (0: none); a warp
// then waits on one read of its row, not three, which is what a narrow row's
// pass waits on (Swin's and ConvNeXt's first stages, D 96 to 256)
constexpr int LN_HELD_MAX = 8;

// out[r, :] = LN(x[r, :]) rounded to T
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g, const float* __restrict__ ln_b,
               T* __restrict__ out, int m, int d, float eps, int ln_count) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* p = x + (size_t)row * d;
  T* o = out + (size_t)row * d;
  if (d <= 32 * 4 && LN_HELD_MAX >= 4) return ln_row_held<T, 4>(p, ln_g, ln_b, o, d, eps, ln_count, lane);
  if (d <= 32 * 8 && LN_HELD_MAX >= 8) return ln_row_held<T, 8>(p, ln_g, ln_b, o, d, eps, ln_count, lane);
  float mean, rstd;
  row_stats<T>(p, d, eps, ln_count, lane, mean, rstd);
  for (int c = lane; c < d; c += 32) o[c] = from_f32<T>((to_f32<T>(p[c]) - mean) * rstd * ln_g[c] + ln_b[c]);
}

// out[r, :] = x[r, :] + LN(branch[r, :]) (Swin v2's post-norm)
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
ln_residual_kernel(const float* __restrict__ branch, const T* __restrict__ x, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, T* __restrict__ out, int m, int c, float eps, int ln_count) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= m) return;
  const float* p = branch + (size_t)row * c;
  float mean, rstd;
  row_stats<float>(p, c, eps, ln_count, lane, mean, rstd);
  for (int col = lane; col < c; col += 32) {
    const size_t at = (size_t)row * c + col;
    out[at] = from_f32<T>(to_f32<T>(x[at]) + ((p[col] - mean) * rstd * ln_g[col] + ln_b[col]));
  }
}

template <typename T>
cudaError_t launch_ln_rows(const T* x, const float* ln_g, const float* ln_b, T* out, int m, int d, float eps,
                           int ln_count, cudaStream_t stream) {
  if (m < 1 || d < 1) return cudaErrorInvalidValue;
  constexpr int rows = ROW_THREADS / 32;
  ln_rows_kernel<T><<<(m + rows - 1) / rows, ROW_THREADS, 0, stream>>>(x, ln_g, ln_b, out, m, d, eps, ln_count);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln_residual(const float* branch, const T* x, const float* ln_g, const float* ln_b, T* out, int m,
                               int c, float eps, int ln_count, cudaStream_t stream) {
  if (m < 1 || c < 1) return cudaErrorInvalidValue;
  constexpr int rows = ROW_THREADS / 32;
  ln_residual_kernel<T><<<(m + rows - 1) / rows, ROW_THREADS, 0, stream>>>(branch, x, ln_g, ln_b, out, m, c, eps,
                                                                          ln_count);
  return cudaGetLastError();
}

// ------------------------------------------------- LayerNorm backward

// The backward of LN over rows of d values (count 0), a warp a row, shared by
// the bf16 backward of mlp_block, cn_mlp_block and attention_block
// (ln_backward_rows): with x^ = (x - mean) rstd, the statistics recomputed
// from x in f32 (mean, then the centred squares, as row_stats takes them), and
// gd = gamma dh,
//   dx = resid + rstd (gd - mean(gd) - x^ mean(gd x^))    (resid null: none)
// rounded to T once, and the sums over the rows of dh x^ (for dgamma) and of
// dh (for dbeta).  Bound: bytes, x, dh and resid read and dx written once
// (155 MB at ViT-B/16 b128, 0.046 ms).
//
// ln_backward_vec_kernel, the rule: a lane owns NC 16-byte chunks of the row
// (columns 8 c .. 8 c + 7 of chunk c = lane + 32 j in bf16, 4 c .. in f32), so
// a row is read once: x, dh and resid with 16-byte loads, held in registers
// through both passes, and dx stored 16 bytes at a time.  The parameters'
// sums stay in the lane's registers (its own columns) across every row its
// warp takes on a persistent grid (as many blocks as fit on the card,
// blocks_per_sm), and meet the block's other warps once, at the end, in
// shared memory.  It takes rows of d a multiple of 16 bytes, at most 32
// LNB_CHUNKS_MAX chunks, every row 16-byte aligned; ln_backward_kernel, the
// same sums by scalar loads through the caches and per-warp slices of shared
// memory, takes any other d (300; 2048 in bf16; a misaligned view).
//
// Both write each block's sums into partial[block][2][d], the warps added in
// warp order; ln_backward_reduce_kernel then adds the blocks in block order
// into sums[2][d].  Rows go to warps by a fixed stride, so every call on one
// card gives the same bits.  No atomics.
constexpr int LNB_THREADS = 256;     // ln_backward_vec_kernel: eight warps, a row each at a time
constexpr int LNB_SCALAR_THREADS = 128;
constexpr int LNB_CHUNKS_MAX = 6;    // bf16 rows up to 1536 values, f32 up to 768

// 16 bytes of T as f32 values, and back
template <typename T> struct Chunk {
  static constexpr int N = 16 / (int)sizeof(T);
};
template <typename T> __device__ __forceinline__ void unpack16(const int4& raw, float (&v)[Chunk<T>::N]) {
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < Chunk<T>::N; ++e) v[e] = to_f32<T>(h[e]);
}
template <typename T> __device__ __forceinline__ int4 pack16(const float (&v)[Chunk<T>::N]) {
  int4 raw;
  T* h = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < Chunk<T>::N; ++e) h[e] = from_f32<T>(v[e]);
  return raw;
}

// V f32 values at p (16-byte aligned), by 16-byte loads
template <int V> __device__ __forceinline__ void gamma_chunk(const float* p, float (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(LNB_THREADS)
ln_backward_vec_kernel(const T* __restrict__ x, const float* __restrict__ ln_g, const T* __restrict__ dh,
                       const T* __restrict__ resid, T* __restrict__ dx, float* __restrict__ partial, int m, int d,
                       float eps) {
  constexpr int V = Chunk<T>::N;
  extern __shared__ __align__(16) float smem[];  // [warp][2][d] at the end
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = d / V;
  float acc_g[NC][V], acc_b[NC][V];  // this lane's columns: sums of dh x^, of dh
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc_g[j][e] = acc_b[j][e] = 0.0f;

  for (int row = blockIdx.x * (LNB_THREADS / 32) + warp; row < m; row += gridDim.x * (LNB_THREADS / 32)) {
    const int4* px = reinterpret_cast<const int4*>(x + (size_t)row * d);
    const int4* pg = reinterpret_cast<const int4*>(dh + (size_t)row * d);
    const int4* pr = resid != nullptr ? reinterpret_cast<const int4*>(resid + (size_t)row * d) : nullptr;
    int4 rx[NC], rg[NC], rr[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int ch = lane + 32 * j;
      if (ch < chunks) {
        rx[j] = px[ch];
        rg[j] = pg[ch];
        if (resid != nullptr) rr[j] = pr[ch];
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (lane + 32 * j >= chunks) continue;
      float v[V];
      unpack16<T>(rx[j], v);
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[e];
    }
    const float mean = warp_sum(s) / (float)d;
    float var = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (lane + 32 * j >= chunks) continue;
      float v[V];
      unpack16<T>(rx[j], v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float dv = v[e] - mean;
        var += dv * dv;
      }
    }
    const float rstd = rsqrtf(warp_sum(var) / (float)d + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int ch = lane + 32 * j;
      if (ch >= chunks) continue;
      float xv[V], gv[V], lg[V];
      unpack16<T>(rx[j], xv);
      unpack16<T>(rg[j], gv);
      gamma_chunk<V>(ln_g + ch * V, lg);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = (xv[e] - mean) * rstd, gd = lg[e] * gv[e];
        s1 += gd;
        s2 += gd * xh;
        acc_g[j][e] += gv[e] * xh;
        acc_b[j][e] += gv[e];
      }
    }
    s1 = warp_sum(s1) / (float)d;
    s2 = warp_sum(s2) / (float)d;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int ch = lane + 32 * j;
      if (ch >= chunks) continue;
      float xv[V], gv[V], lg[V], rv[V];
      unpack16<T>(rx[j], xv);
      unpack16<T>(rg[j], gv);
      gamma_chunk<V>(ln_g + ch * V, lg);
      if (resid != nullptr) unpack16<T>(rr[j], rv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xh = (xv[e] - mean) * rstd, gd = lg[e] * gv[e];
        const float v = rstd * (gd - s1 - xh * s2);
        xv[e] = resid != nullptr ? rv[e] + v : v;
      }
      reinterpret_cast<int4*>(dx + (size_t)row * d)[ch] = pack16<T>(xv);
    }
  }
  float* mine = smem + 2 * d * warp;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int ch = lane + 32 * j;
    if (ch >= chunks) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      mine[ch * V + e] = acc_g[j][e];
      mine[d + ch * V + e] = acc_b[j][e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d; c += LNB_THREADS) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < LNB_THREADS / 32; ++w) sum += smem[2 * d * w + c];
    partial[(size_t)blockIdx.x * 2 * d + c] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(LNB_SCALAR_THREADS)
ln_backward_kernel(const T* __restrict__ x, const float* __restrict__ ln_g, const T* __restrict__ dh,
                   const T* __restrict__ resid, T* __restrict__ dx, float* __restrict__ partial, int m, int d,
                   float eps) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = smem + 2 * d * warp;  // [2][d]: sums of dh x^, of dh
  for (int c = lane; c < 2 * d; c += 32) acc[c] = 0.0f;
  for (int row = blockIdx.x * (LNB_SCALAR_THREADS / 32) + warp; row < m;
       row += gridDim.x * (LNB_SCALAR_THREADS / 32)) {
    const T* px = x + (size_t)row * d;
    const T* pg = dh + (size_t)row * d;
    float mean, rstd;
    row_stats<T>(px, d, eps, 0, lane, mean, rstd);
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float xh = (to_f32<T>(px[c]) - mean) * rstd, g = to_f32<T>(pg[c]), gd = ln_g[c] * g;
      s1 += gd;
      s2 += gd * xh;
      acc[c] += g * xh;
      acc[d + c] += g;
    }
    s1 = warp_sum(s1) / (float)d;
    s2 = warp_sum(s2) / (float)d;
    for (int c = lane; c < d; c += 32) {
      const size_t at = (size_t)row * d + c;
      const float xh = (to_f32<T>(px[c]) - mean) * rstd, gd = ln_g[c] * to_f32<T>(pg[c]);
      float v = rstd * (gd - s1 - xh * s2);
      if (resid != nullptr) v = to_f32<T>(resid[at]) + v;
      dx[at] = from_f32<T>(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d; c += LNB_SCALAR_THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < LNB_SCALAR_THREADS / 32; ++w) s += smem[2 * d * w + c];
    partial[(size_t)blockIdx.x * 2 * d + c] = s;
  }
}

// sums[c] = partial[0][c] + partial[1][c] + ... over `blocks` rows of `width`, in block order: warp w adds rows w,
// w + 8, ... of its 32 columns, then the eight warps' sums are added in warp order
constexpr int LNR_WARPS = 8;

__global__ void __launch_bounds__(LNR_WARPS * 32)
ln_backward_reduce_kernel(const float* __restrict__ partial, float* __restrict__ sums, int blocks, int width) {
  __shared__ float part[LNR_WARPS * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < width)
    for (int b = warp; b < blocks; b += LNR_WARPS) s += partial[(size_t)b * width + c];
  part[warp * 32 + lane] = s;
  __syncthreads();
  if (warp == 0 && c < width) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < LNR_WARPS; ++w) total += part[w * 32 + lane];
    sums[c] = total;
  }
}

template <typename T>
using LnBackwardKernel = void (*)(const T*, const float*, const T*, const T*, T*, float*, int, int, float);

// One call: the kernel of the row's path on a persistent grid of at most `capacity` blocks (partial holds
// capacity * 2 * d floats), then the blocks' sums into sums (2 * d floats).  With info, no launch: info[0..5] =
// path (NC 16-byte chunks a lane; 0 the scalar kernel), threads, shared bytes a block, blocks an SM, registers a
// thread, grid.
template <typename T>
cudaError_t launch_ln_backward(const T* x, const float* ln_g, const T* dh, const T* resid, T* dx, float* partial,
                               float* sums, int m, int d, float eps, int sms, int capacity, int* info,
                               cudaStream_t stream) {
  if (m < 1 || d < 1 || sms < 1 || capacity < 1) return cudaErrorInvalidValue;
  constexpr int V = Chunk<T>::N;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int nc = (d / V + 31) / 32;
  const bool vec = d % V == 0 && nc <= LNB_CHUNKS_MAX && aligned(x) && aligned(dh) && aligned(dx) &&
                   aligned(ln_g) && (resid == nullptr || aligned(resid));
  LnBackwardKernel<T> fn = ln_backward_kernel<T>;
  if (vec) {
    const LnBackwardKernel<T> by_chunks[LNB_CHUNKS_MAX] = {
        ln_backward_vec_kernel<T, 1>, ln_backward_vec_kernel<T, 2>, ln_backward_vec_kernel<T, 3>,
        ln_backward_vec_kernel<T, 4>, ln_backward_vec_kernel<T, 5>, ln_backward_vec_kernel<T, 6>};
    fn = by_chunks[nc - 1];
  }
  const int threads = vec ? LNB_THREADS : LNB_SCALAR_THREADS;
  const size_t smem = (size_t)2 * d * (threads / 32) * sizeof(float);
  if (smem > 232448) return cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm((const void*)fn, threads, smem, 232448, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long want = ((long long)m + threads / 32 - 1) / (threads / 32);
  long long grid = (long long)per_sm * sms;
  grid = want < grid ? want : grid;
  grid = capacity < grid ? capacity : grid;
  if (info != nullptr) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, (const void*)fn);
    if (err != cudaSuccess) return err;
    const int got[6] = {vec ? nc : 0, threads, (int)smem, per_sm, attr.numRegs, (int)grid};
    for (int i = 0; i < 6; ++i) info[i] = got[i];
    return cudaSuccess;
  }
  fn<<<(int)grid, threads, smem, stream>>>(x, ln_g, dh, resid, dx, partial, m, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_backward_reduce_kernel<<<(2 * d + 31) / 32, LNR_WARPS * 32, 0, stream>>>(partial, sums, (int)grid, 2 * d);
  return cudaGetLastError();
}

// ------------------------------------------- the bf16 tensor-core product

using bf16 = __nv_bfloat16;

enum { TC_BIAS = 0, TC_GELU = 1, TC_RESID = 2 };

constexpr int TC_BM = 128;  // two warpgroups of 64 rows
constexpr int TC_BN = 128;
constexpr int TC_BK = 64;   // one 128-byte swizzled row of bf16
constexpr int TC_STAGES = 3;
constexpr int TC_INFLIGHT = 0;                               // wgmma groups left in flight at a step's end
constexpr int TC_AHEAD = TC_STAGES - 1 - TC_INFLIGHT;         // tiles copied ahead of the products
constexpr int TC_THREADS = 256;
constexpr int TC_A_BYTES = TC_BM * TC_BK * 2;
constexpr int TC_B_BYTES = TC_BK * TC_BN * 2;
constexpr int TC_STAGE_BYTES = TC_A_BYTES + TC_B_BYTES;
constexpr size_t TC_SMEM = (size_t)TC_STAGES * TC_STAGE_BYTES + 1024;  // + room to align to 1024
constexpr int TC_BLOCKS_PER_SM = TC_SMEM <= 113 * 1024 ? 2 : 1;
constexpr int TC_CHUNKS = TC_A_BYTES / 16 / TC_THREADS;                 // 16-byte copies a thread a tile
static_assert(TC_A_BYTES == TC_B_BYTES && TC_CHUNKS == 4 && TC_AHEAD >= 1, "tiles");

// two adjacent outputs, one 4- or 8-byte store
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  float2 v;
  v.x = v0;
  v.y = v1;
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  __nv_bfloat162 v;
  v.x = from_f32<bf16>(v0);
  v.y = from_f32<bf16>(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// two adjacent values as f32, one 4- or 8-byte load
__device__ __forceinline__ void load2(const float* p, float& v0, float& v1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  v0 = v.x;
  v1 = v.y;
}
__device__ __forceinline__ void load2(const bf16* p, float& v0, float& v1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  v0 = to_f32<bf16>(v.x);
  v1 = to_f32<bf16>(v.y);
}

template <int EPI, typename OutT>
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS_PER_SM)
tc_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, const float* __restrict__ bias,
               const bf16* __restrict__ resid, const float* __restrict__ gamma, OutT* __restrict__ out, int m, int k,
               int n, int ld, int row_tile0) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = (row_tile0 + blockIdx.y) * TC_BM, n0 = blockIdx.x * TC_BN;
  const int k_tiles = (k + TC_BK - 1) / TC_BK;

  // A tile: row r, chunk c of 8 k at r * 128 + (c ^ r % 8) * 16.  B tile: two
  // 64-column halves of 64 k rows each, half h at h * 8192, k row r, chunk c
  // of 8 columns at r * 128 + (c ^ r % 8) * 16.
  auto load = [&](int stage, int kt) {
    const int k0 = kt * TC_BK;
    const uint32_t sa = base + stage * TC_STAGE_BYTES, sb = sa + TC_A_BYTES;
#pragma unroll
    for (int i = 0; i < TC_CHUNKS; ++i) {
      const int e = tid + i * TC_THREADS;
      const int r = e >> 3, c = e & 7;
      const int row = m0 + r, kk = k0 + c * 8;
      const bool ok = row < m && kk < k;
      cp_async16(sa + r * 128 + ((c ^ (r & 7)) << 4), a + (ok ? (size_t)row * k + kk : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < TC_CHUNKS; ++i) {
      const int e = tid + i * TC_THREADS;
      const int r = e >> 4, c = e & 15;
      const int kk = k0 + r, col = n0 + c * 8;
      const bool ok = kk < k && col < n;
      cp_async16(sb + (c >> 3) * (TC_BK * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                 w + (ok ? (size_t)kk * ld + col : 0), ok);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // TC_AHEAD tiles ahead: the stage a step refills last held the tile of
  // TC_INFLIGHT + 1 steps before, whose products the wait that closed the
  // step before has retired in both warpgroups (the barrier orders them)
#pragma unroll
  for (int s = 0; s < TC_AHEAD; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<TC_AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    const int next = kt + TC_AHEAD;
    if (next < k_tiles) load(next % TC_STAGES, next);
    cp_async_commit();
    const uint32_t sa = base + (kt % TC_STAGES) * TC_STAGE_BYTES, sb = sa + TC_A_BYTES;
    const int steps = min(TC_BK, k - kt * TC_BK) / 16;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < TC_BK / 16; ++s) {
      if (s < steps)
        wgmma_m64n128k16_bf16(acc, sw128_desc(sa + wg * (64 * 128) + s * 32, 16, 1024),
                              sw128_desc(sb + s * 2048, TC_BK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<TC_INFLIGHT>();
  }
  wgmma_wait<0>();
  fence_sums(acc);

  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < TC_BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;  // n is a multiple of 8: col + 1 < n with col
    if (col >= n) continue;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= m) continue;
      const size_t at = (size_t)row * ld + col;
      float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      if (EPI == TC_GELU) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      } else if (EPI == TC_RESID) {
        if (gamma != nullptr) {
          v0 *= gamma[col];
          v1 *= gamma[col + 1];
        }
        const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(resid + at);
        v0 = to_f32<bf16>(r.x) + v0;
        v1 = to_f32<bf16>(r.y) + v1;
      }
      store2(out + at, v0, v1);
    }
  }
}

// resid (TC_RESID) is (m, n) of bf16, gamma (TC_RESID) may be null.  w, out and resid are n columns of rows ld
// apart (ld = n where 0): a product into some columns of a wider buffer, of the same columns of a wider weight.
template <int EPI, typename OutT>
cudaError_t launch_tc_gemm(const bf16* a, const bf16* w, const float* bias, const bf16* resid, const float* gamma,
                           OutT* out, int m, int k, int n, cudaStream_t stream, int ld = 0) {
  const int rows = (m + TC_BM - 1) / TC_BM, cols = (n + TC_BN - 1) / TC_BN;
  if (ld == 0) ld = n;
  if (m < 1 || n < 8 || n % 8 || k < 16 || k % 16 || ld < n || ld % 8) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(tc_gemm_kernel<EPI, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
  if (err != cudaSuccess) return err;
  for (int r0 = 0; r0 < rows; r0 += MAX_GRID_YZ) {  // row tiles past the grid's y in further launches
    tc_gemm_kernel<EPI, OutT><<<dim3(cols, min(MAX_GRID_YZ, rows - r0)), TC_THREADS, TC_SMEM, stream>>>(
        a, w, bias, resid, gamma, out, m, k, n, ld, r0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace cvt
