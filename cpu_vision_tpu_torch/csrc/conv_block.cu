// Fused conv3x3(SAME) + bias + ReLU + maxpool2x2 for Hopper (sm_90a), bound
// with ctypes.
//
// Replaces the Pallas TPU kernel fused_conv3x3_relu_pool of
// cpu_vision_tpu/ops/pallas/conv_block.py:36 (pallas_call at :88), which
// accumulates nine per-tap (TH*W, Cin) x (Cin, Cout) products over a row band.
//
// Layouts.  x (N, H, W, Cin) NHWC f32, w (3, 3, Cin, Cout) HWIO f32,
// b (Cout,) f32, out (N, H/2, W/2, Cout) f32; H and W even.
//
// Design.  One block owns a POOL_T x POOL_T tile of pooled pixels of one
// image and a slab of CO_SLAB output channels.  It stages in shared memory
//   * the slab of the weights, [9*Cin][CO_SLAB] (zero beyond Cout), and
//   * the (2*POOL_T+2)^2 input window around its conv pixels, zero outside
//     the image (SAME padding), transposed to [Cin][row][col] so that the
//     threads of a warp, which are neighbouring pixels, read neighbouring
//     words whatever Cin is (row stride WIN_S = 20 words: a warp's 8x4
//     pixels at column stride 2 fall on every even bank exactly twice).
// A thread owns one pooled pixel (its 2x2 conv pixels) and CO_T consecutive
// channels of the slab: 4*CO_T sums in registers.  The 64 pixels of a warp
// pair share their channels, so weight reads are broadcasts of two float4.
// The sums run in a fixed order (dy, dx, then ci); then bias, ReLU and the
// 2x2 max, and one write of CO_T consecutive floats.  Conv activations never
// reach device memory.
//
// Bound.  Cin=3 -> 32 channels at 224x224 moves 0.56 GB for 22 GFLOP and is
// bound by bytes; Cin=32 -> 64 at 112x112 does 118 GFLOP on 0.62 GB and is
// bound by f32 operations outside the tensor cores (67 TFLOP/s).  This
// kernel is the plain version of that: scalar FMAs fed from shared memory,
// no wgmma, no TMA, no cp.async, the input window read once per slab.

#include <cuda_runtime.h>

namespace {

constexpr int POOL_T = 8;               // pooled pixels per tile side
constexpr int CONV_T = 2 * POOL_T;      // conv pixels per tile side
constexpr int WIN = CONV_T + 2;         // input window side
constexpr int WIN_S = 20;               // its row stride in shared memory
constexpr int WIN_PLANE = WIN * WIN_S + 1;  // odd: channel planes fall on distinct banks
constexpr int CO_T = 8;                 // output channels per thread (two float4 of weights)
constexpr int CO_SLAB = 32;             // output channels per block
constexpr int THREADS = POOL_T * POOL_T * (CO_SLAB / CO_T);
constexpr size_t MAX_SMEM = 227 * 1024;  // a block's most: cin <= 89

size_t smem_bytes(int cin) {
  return sizeof(float) * ((size_t)9 * cin * CO_SLAB + (size_t)cin * WIN_PLANE);
}

__global__ void __launch_bounds__(THREADS)
conv3x3_relu_pool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, float* __restrict__ out,
                         int h, int wd, int cin, int cout, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                       // [9*cin][CO_SLAB]
  float* s_in = smem + 9 * cin * CO_SLAB;  // [cin][WIN rows, stride WIN_S]

  const int tile_y = blockIdx.x / tiles_x, tile_x = blockIdx.x - tile_y * tiles_x;
  const int co_base = blockIdx.y * CO_SLAB;
  const int n = blockIdx.z;
  const int y0 = tile_y * CONV_T - 1, x0 = tile_x * CONV_T - 1;  // window origin

  for (int i = threadIdx.x; i < 9 * cin * CO_SLAB; i += THREADS) {
    const int k = i / CO_SLAB, j = i - k * CO_SLAB;
    s_w[i] = co_base + j < cout ? w[(size_t)k * cout + co_base + j] : 0.0f;
  }
  const float* img = x + (size_t)n * h * wd * cin;
  const int row_words = WIN * cin;
  for (int i = threadIdx.x; i < WIN * row_words; i += THREADS) {
    const int r = i / row_words, rem = i - r * row_words;
    const int c = rem / cin, ci = rem - c * cin;
    const int y = y0 + r, xx = x0 + c;
    const bool inside = y >= 0 && y < h && xx >= 0 && xx < wd;
    s_in[ci * WIN_PLANE + r * WIN_S + c] = inside ? img[((size_t)y * wd + xx) * cin + ci] : 0.0f;
  }
  __syncthreads();

  const int pix = threadIdx.x % (POOL_T * POOL_T), cg = threadIdx.x / (POOL_T * POOL_T);
  const int py = pix / POOL_T, px = pix - py * POOL_T;
  float acc[4][CO_T];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < CO_T; ++j) acc[q][j] = 0.0f;

  for (int dy = 0; dy < 3; ++dy) {
    for (int dx = 0; dx < 3; ++dx) {
      const float* ip = s_in + (2 * py + dy) * WIN_S + 2 * px + dx;
      const float* wp = s_w + (dy * 3 + dx) * cin * CO_SLAB + cg * CO_T;
      for (int ci = 0; ci < cin; ++ci, ip += WIN_PLANE, wp += CO_SLAB) {
        const float v[4] = {ip[0], ip[1], ip[WIN_S], ip[WIN_S + 1]};
        const float4 wa = *reinterpret_cast<const float4*>(wp);
        const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
        const float wv[CO_T] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < CO_T; ++j) acc[q][j] += v[q] * wv[j];
      }
    }
  }

  const int oy = tile_y * POOL_T + py, ox = tile_x * POOL_T + px;
  if (oy >= h / 2 || ox >= wd / 2) return;
  const int co0 = co_base + cg * CO_T;
  float* o = out + (((size_t)n * (h / 2) + oy) * (wd / 2) + ox) * cout + co0;
#pragma unroll
  for (int j = 0; j < CO_T; ++j) {
    if (co0 + j >= cout) break;
    const float bias = b[co0 + j];
    float m = fmaxf(acc[0][j] + bias, 0.0f);
#pragma unroll
    for (int q = 1; q < 4; ++q) m = fmaxf(m, fmaxf(acc[q][j] + bias, 0.0f));
    o[j] = m;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// never synchronises.
int cvt_conv3x3_relu_pool(const float* x, const float* w, const float* b, float* out, int n, int h,
                          int wd, int cin, int cout, void* stream) {
  if (n < 1 || n > 65535 || h < 2 || wd < 2 || h % 2 || wd % 2 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(cin);
  const int slabs = (cout + CO_SLAB - 1) / CO_SLAB;
  if (smem > MAX_SMEM || slabs > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_relu_pool_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_x = (wd / 2 + POOL_T - 1) / POOL_T, tiles_y = (h / 2 + POOL_T - 1) / POOL_T;
  conv3x3_relu_pool_kernel<<<dim3(tiles_x * tiles_y, slabs, n), THREADS, smem, (cudaStream_t)stream>>>(
      x, w, b, out, h, wd, cin, cout, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
