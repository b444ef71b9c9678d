// Depthwise K x K convolution, stride 1, zero SAME padding, NHWC, for Hopper
// (sm_90a), bound with ctypes:
//
//   cvt_depthwise_conv2d   out[n, y, x, c] = bias[c] + sum_{i, j} in[n, y + i - K/2, x + j - K/2, c] * k[i, j, c]
//
// It replaces the Pallas TPU kernel of cpu_vision_tpu/ops/pallas/depthwise.py:
// _fwd_pallas :57 (pallas_call at :64, reached through depthwise_conv2d :96),
// which reads one zero-padded image into VMEM and runs the K * K taps there.
//
// Types.  The input, the taps and the output share one storage type T (float
// or bf16); the bias is f32.  Every operand is widened to f32, the taps are
// summed in f32 in (i, j) order as in the TPU kernel (as fused multiply-adds),
// the bias is added last and the sum is rounded to T once.
//
// Design.  There is no padded copy: a block owns 8 x 16 output pixels of one
// image and 32 channels, and stages their (8 + K - 1) x (16 + K - 1) window in
// shared memory with zeros where the window leaves the image.  Channels lie
// on consecutive threads (a warp reads one pixel's 32 consecutive channels,
// 128 or 64 contiguous bytes, and 32 different banks of shared memory).  A
// thread keeps its channel's K * K taps in registers and computes one output
// row of the tile in runs of 4 pixels: for each tap row it reads 4 + K - 1
// window words and does 4 K multiply-adds, 0.36 shared-memory reads a
// multiply-add at K = 7.  The whole grid is on gridDim.x.  K is 3, 5 or 7.
//
// Bound.  Bytes: each input and output element crosses device memory once
// (2 * N H W C elements; at 256 x 56 x 56 x 96 in bf16 308 MB, 0.09 ms at
// 3.35 TB/s) against 2 K^2 operations an output (7.6 GFLOP, 0.11 ms at the
// f32 rate): at K = 7 the two are close, and operations bind by a little.

#include "attention.cuh"

namespace {

using cvt::from_f32;
using cvt::to_f32;

constexpr int DW_CB = 32;   // channels a block
constexpr int DW_TH = 8;    // output rows a block, one a warp
constexpr int DW_TW = 16;   // output columns a block
constexpr int DW_PX = 4;    // outputs a thread computes at once
constexpr int DW_THREADS = DW_CB * DW_TH;

template <int K> constexpr size_t depthwise_smem_bytes() {
  return sizeof(float) * (size_t)(DW_TH + K - 1) * (DW_TW + K - 1) * DW_CB;
}

template <typename T, int K>
__global__ void __launch_bounds__(DW_THREADS)
depthwise_kernel(const T* __restrict__ in, const T* __restrict__ taps, const float* __restrict__ bias,
                 T* __restrict__ out, int h, int w, int c, int tiles_h, int tiles_w, int c_groups) {
  constexpr int R = DW_TH + K - 1, Q = DW_TW + K - 1, P = K / 2;
  extern __shared__ __align__(16) float smem[];  // [R][Q][DW_CB]

  const int lane = threadIdx.x & 31, ty = threadIdx.x >> 5;
  int b = blockIdx.x;
  const int cg = b % c_groups;
  b /= c_groups;
  const int tw = b % tiles_w;
  b /= tiles_w;
  const int th = b % tiles_h;
  const int img = b / tiles_h;
  const int ch = cg * DW_CB + lane;
  const bool c_in = ch < c;
  const int y0 = th * DW_TH, x0 = tw * DW_TW;

  float wt[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wt[t] = c_in ? to_f32<T>(taps[(size_t)t * c + ch]) : 0.0f;

  const T* img_in = in + (size_t)img * h * w * c;
  for (int e = ty; e < R * Q; e += DW_TH) {
    const int r = e / Q, q = e - r * Q;
    const int gy = y0 + r - P, gx = x0 + q - P;
    const bool inside = c_in && gy >= 0 && gy < h && gx >= 0 && gx < w;
    smem[e * DW_CB + lane] = inside ? to_f32<T>(img_in[((size_t)gy * w + gx) * c + ch]) : 0.0f;
  }
  __syncthreads();

  const int gy = y0 + ty;
  if (!c_in || gy >= h) return;
  const float bv = bias != nullptr ? bias[ch] : 0.0f;
  T* out_row = out + ((size_t)img * h + gy) * w * c;
  for (int seg = 0; seg < DW_TW && x0 + seg < w; seg += DW_PX) {
    float acc[DW_PX];
#pragma unroll
    for (int p = 0; p < DW_PX; ++p) acc[p] = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float xs[DW_PX + K - 1];
#pragma unroll
      for (int q = 0; q < DW_PX + K - 1; ++q) xs[q] = smem[((ty + i) * Q + seg + q) * DW_CB + lane];
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int p = 0; p < DW_PX; ++p) acc[p] += xs[p + j] * wt[i * K + j];
    }
#pragma unroll
    for (int p = 0; p < DW_PX; ++p) {
      const int gx = x0 + seg + p;
      if (gx < w) out_row[(size_t)gx * c + ch] = from_f32<T>(acc[p] + bv);
    }
  }
}

template <typename T, int K>
cudaError_t launch_depthwise(const T* in, const T* taps, const float* bias, T* out, int n, int h, int w, int c,
                             cudaStream_t stream) {
  const int tiles_h = (h + DW_TH - 1) / DW_TH, tiles_w = (w + DW_TW - 1) / DW_TW;
  const int c_groups = (c + DW_CB - 1) / DW_CB;
  const long long blocks = (long long)n * tiles_h * tiles_w * c_groups;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  depthwise_kernel<T, K><<<(unsigned)blocks, DW_THREADS, depthwise_smem_bytes<K>(), stream>>>(
      in, taps, bias, out, h, w, c, tiles_h, tiles_w, c_groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t depthwise(const T* in, const T* taps, const float* bias, T* out, int n, int h, int w, int c, int k,
                      cudaStream_t stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1) return cudaErrorInvalidValue;
  switch (k) {
    case 3:
      return launch_depthwise<T, 3>(in, taps, bias, out, n, h, w, c, stream);
    case 5:
      return launch_depthwise<T, 5>(in, taps, bias, out, n, h, w, c, stream);
    case 7:
      return launch_depthwise<T, 7>(in, taps, bias, out, n, h, w, c, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in and out are (n, h, w, c), taps (k, k, c), bias (c) of f32 or null.
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// does not synchronise.
int cvt_depthwise_conv2d(const void* in, const void* taps, const float* bias, void* out, int n, int h, int w,
                         int c, int k, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)depthwise<__nv_bfloat16>((const __nv_bfloat16*)in, (const __nv_bfloat16*)taps, bias,
                                         (__nv_bfloat16*)out, n, h, w, c, k, st);
  return (int)depthwise<float>((const float*)in, (const float*)taps, bias, (float*)out, n, h, w, c, k, st);
}

}  // extern "C"
