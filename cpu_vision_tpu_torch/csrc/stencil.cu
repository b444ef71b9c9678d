// Halo-tiled fused stencil kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernels of cpu_vision_tpu/ops/pallas/stencil.py:
//   cvt_canny_stage1      <- canny_stage1          (stencil.py:446)
//   cvt_hysteresis_sweeps <- hysteresis_sweeps     (stencil.py:404)
//   cvt_blur_sobel        <- fused_blur_sobel      (stencil.py:377)
//   cvt_harris            <- harris_response_fused (stencil.py:591)
// and the halo row-band engine they share (_halo_stencil_call, stencil.py:66,
// and _halo_stencil_call_rowfused, stencil.py:171).
//
// Design.  The input is one (N, H, W) map, channels folded into N.  Every
// block owns one TILE_H x TILE_W output tile of one image: it loads the
// (TILE_H + 2*halo) x (TILE_W + 2*halo) window around it into shared memory
// with reflect indexing (numpy "reflect": edge not repeated, periodic for
// pads longer than the image), runs the whole pipeline in shared memory and
// writes its tile, masking the ragged edge.  Intermediates (blur, gradients,
// magnitude, structure tensor) never reach device memory: one read of the
// input and one write of the output per call.
//
// Bound.  All four read f32 (or the u8 class map) once and write once, and
// do a few tens of f32 operations per pixel, well under the H100's
// 67 TFLOP/s f32 rate against 3.35 TB/s, so device memory bounds them.  The
// halo windows overlap, so neighbouring blocks re-read up to ~1.6x the tile
// from L2, not from HBM.  No cp.async/TMA yet: plain loads, one tile per
// block, many blocks per SM to hide latency.
//
// Exactness.  Sums run in the order of the Pallas kernels (blur taps j=0..k-1
// along W, then i=0..k-1 along H; Sobel in stencil.py:327-339's order), with
// every product and sum rounded on its own: build with --fmad=false and
// without --use_fast_math, so no a*b+c is contracted and sqrtf is the
// correctly rounded square root.  Thresholds and k arrive as f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TAPS = 31;
constexpr int MAX_SWEEPS = 16;
constexpr int THREADS = 256;
constexpr int TILE_H = 32;
constexpr int TILE_W = 32;
constexpr int HYST_TILE_H = 32;
constexpr int HYST_TILE_W = 64;

struct Taps {
  float v[MAX_TAPS];
};

__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - m;
}

__device__ __forceinline__ void load_taps(const Taps& taps, float* s_k) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < MAX_TAPS; ++j) s_k[j] = taps.v[j];
  }
}

// s[r][c] = img[reflect(y0 + r)][reflect(x0 + c)] for a rows x cols window.
template <typename T>
__device__ void load_window(const T* __restrict__ img, int h, int w, int y0, int x0,
                            T* s, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    s[i] = img[(size_t)reflect(y0 + r, h) * w + reflect(x0 + c, w)];
  }
}

// dst[r][c] = sum_j src[r][c + j] * k[j], j = 0..K-1 in order.
__device__ void blur_along_w(const float* src, int src_cols, float* dst, int rows, int cols,
                             const float* k, int K) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    const float* p = src + r * src_cols + c;
    float acc = p[0] * k[0];
    for (int j = 1; j < K; ++j) acc = acc + p[j] * k[j];
    dst[i] = acc;
  }
}

// dst[r][c] = sum_i src[r + i][c] * k[i], i = 0..K-1 in order.
__device__ void blur_along_h(const float* src, int src_cols, float* dst, int rows, int cols,
                             const float* k, int K) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    const float* p = src + r * src_cols + c;
    float acc = p[0] * k[0];
    for (int t = 1; t < K; ++t) acc = acc + p[t * src_cols] * k[t];
    dst[i] = acc;
  }
}

// 3x3 Sobel of the window whose top-left is s, in stencil.py:327-339's order.
__device__ __forceinline__ void sobel_at(const float* s, int cols, float& gx, float& gy) {
  const float s00 = s[0], s01 = s[1], s02 = s[2];
  const float s10 = s[cols], s12 = s[cols + 2];
  const float s20 = s[2 * cols], s21 = s[2 * cols + 1], s22 = s[2 * cols + 2];
  gx = s00 * -1.0f;
  gx = gx + s02;
  gx = gx + s10 * -2.0f;
  gx = gx + s12 * 2.0f;
  gx = gx + s20 * -1.0f;
  gx = gx + s22;
  gy = s00 * -1.0f;
  gy = gy + s01 * -2.0f;
  gy = gy + s02 * -1.0f;
  gy = gy + s20;
  gy = gy + s21 * 2.0f;
  gy = gy + s22;
}

// ------------------------------------------------------------ canny_stage1
// blur -> Sobel -> |g| -> 4-bin NMS -> double threshold; halo = K/2 + 2.
struct CannyDims {
  int halo, in_h, in_w, hb_h, bw, vb_h, g_h, g_w;
  __host__ __device__ explicit CannyDims(int K)
      : halo(K / 2 + 2), in_h(TILE_H + 2 * halo), in_w(TILE_W + 2 * halo),
        hb_h(TILE_H + 4 + K - 1), bw(TILE_W + 4), vb_h(TILE_H + 4),
        g_h(TILE_H + 2), g_w(TILE_W + 2) {}
  __host__ __device__ int floats() const {
    return in_h * in_w + hb_h * bw + vb_h * bw + 3 * g_h * g_w;
  }
};

__global__ void __launch_bounds__(THREADS)
canny_stage1_kernel(const float* __restrict__ in, uint8_t* __restrict__ out, int h, int w,
                    Taps taps, int K, float low, float high) {
  extern __shared__ float smem[];
  __shared__ float s_k[MAX_TAPS];
  const CannyDims d(K);
  float* s_in = smem;
  float* s_hb = s_in + d.in_h * d.in_w;
  float* s_vb = s_hb + d.hb_h * d.bw;
  float* s_gx = s_vb + d.vb_h * d.bw;
  float* s_gy = s_gx + d.g_h * d.g_w;
  float* s_mag = s_gy + d.g_h * d.g_w;

  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t plane = (size_t)h * w;
  load_taps(taps, s_k);
  load_window(in + blockIdx.z * plane, h, w, y0 - d.halo, x0 - d.halo, s_in, d.in_h, d.in_w);
  __syncthreads();
  blur_along_w(s_in, d.in_w, s_hb, d.hb_h, d.bw, s_k, K);
  __syncthreads();
  blur_along_h(s_hb, d.bw, s_vb, d.vb_h, d.bw, s_k, K);
  __syncthreads();
  for (int i = threadIdx.x; i < d.g_h * d.g_w; i += blockDim.x) {
    const int r = i / d.g_w, c = i - r * d.g_w;
    float gx, gy;
    sobel_at(s_vb + r * d.bw + c, d.bw, gx, gy);
    s_gx[i] = gx;
    s_gy[i] = gy;
    s_mag[i] = sqrtf(gx * gx + gy * gy);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += blockDim.x) {
    const int r = i / TILE_W, c = i - r * TILE_W;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    const int ci = (1 + r) * d.g_w + (1 + c);
    const float gx0 = s_gx[ci], gy0 = s_gy[ci], m0 = s_mag[ci];
    const float ax = fabsf(gx0), ay = fabsf(gy0);
    const bool d0 = ay < 0.41421356f * ax;   // tan 22.5 deg
    const bool d90 = ay >= 2.4142137f * ax;  // tan 67.5 deg
    const bool d45 = !d0 && !d90 && (gx0 * gy0 >= 0.0f);
    // nb1 at (dy, dx), nb2 at (-dy, -dx)
    const int dy = d0 ? 0 : -1;
    const int dx = d0 ? 1 : (d45 ? 1 : (d90 ? 0 : -1));
    const float nb1 = s_mag[ci + dy * d.g_w + dx];
    const float nb2 = s_mag[ci - dy * d.g_w - dx];
    const float sup = (m0 >= nb1 && m0 > nb2) ? m0 : 0.0f;
    out[blockIdx.z * plane + (size_t)y * w + x] = sup >= high ? 2 : (sup >= low ? 1 : 0);
  }
}

// ------------------------------------------------------- hysteresis_sweeps
// `sweeps` steps of: a weak pixel (1) with a strong (2) 8-neighbour becomes
// strong.  halo = sweeps: each step leaves the outermost ring stale.
__global__ void __launch_bounds__(THREADS)
hysteresis_sweeps_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h, int w,
                         int sweeps, int* __restrict__ changed) {
  extern __shared__ uint8_t s_cls[];
  const int rows = HYST_TILE_H + 2 * sweeps, cols = HYST_TILE_W + 2 * sweeps;
  uint8_t* a = s_cls;
  uint8_t* b = s_cls + rows * cols;
  const int y0 = blockIdx.y * HYST_TILE_H, x0 = blockIdx.x * HYST_TILE_W;
  const size_t plane = (size_t)h * w;
  const uint8_t* src = in + blockIdx.z * plane;
  load_window(src, h, w, y0 - sweeps, x0 - sweeps, a, rows, cols);
  __syncthreads();
  for (int s = 1; s <= sweeps; ++s) {
    const int rr = rows - 2 * s, cc = cols - 2 * s;
    for (int i = threadIdx.x; i < rr * cc; i += blockDim.x) {
      const int r = s + i / cc, c = s + i % cc;
      const uint8_t t = a[r * cols + c];
      bool grow = false;
      if (t == 1) {
        for (int dr = -1; dr <= 1; ++dr)
          for (int dc = -1; dc <= 1; ++dc) grow |= a[(r + dr) * cols + c + dc] == 2;
      }
      b[r * cols + c] = grow ? 2 : t;
    }
    __syncthreads();
    uint8_t* t = a;
    a = b;
    b = t;
  }
  int any = 0;
  for (int i = threadIdx.x; i < HYST_TILE_H * HYST_TILE_W; i += blockDim.x) {
    const int r = i / HYST_TILE_W, c = i - r * HYST_TILE_W;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    const uint8_t v = a[(sweeps + r) * cols + sweeps + c];
    const size_t o = (size_t)y * w + x;
    any |= v != src[o];
    out[blockIdx.z * plane + o] = v;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0 && changed != nullptr) *changed = 1;
}

// --------------------------------------------------------- fused_blur_sobel
// sqrt(gx^2 + gy^2) of the Gaussian-blurred image; halo = K/2 + 1.
struct BlurSobelDims {
  int halo, in_h, in_w, hb_h, bw, vb_h;
  __host__ __device__ explicit BlurSobelDims(int K)
      : halo(K / 2 + 1), in_h(TILE_H + 2 * halo), in_w(TILE_W + 2 * halo),
        hb_h(TILE_H + 2 + K - 1), bw(TILE_W + 2), vb_h(TILE_H + 2) {}
  __host__ __device__ int floats() const { return in_h * in_w + hb_h * bw + vb_h * bw; }
};

__global__ void __launch_bounds__(THREADS)
blur_sobel_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
                  Taps taps, int K) {
  extern __shared__ float smem[];
  __shared__ float s_k[MAX_TAPS];
  const BlurSobelDims d(K);
  float* s_in = smem;
  float* s_hb = s_in + d.in_h * d.in_w;
  float* s_vb = s_hb + d.hb_h * d.bw;

  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t plane = (size_t)h * w;
  load_taps(taps, s_k);
  load_window(in + blockIdx.z * plane, h, w, y0 - d.halo, x0 - d.halo, s_in, d.in_h, d.in_w);
  __syncthreads();
  blur_along_w(s_in, d.in_w, s_hb, d.hb_h, d.bw, s_k, K);
  __syncthreads();
  blur_along_h(s_hb, d.bw, s_vb, d.vb_h, d.bw, s_k, K);
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += blockDim.x) {
    const int r = i / TILE_W, c = i - r * TILE_W;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    float gx, gy;
    sobel_at(s_vb + r * d.bw + c, d.bw, gx, gy);
    out[blockIdx.z * plane + (size_t)y * w + x] = sqrtf(gx * gx + gy * gy);
  }
}

// ---------------------------------------------------- harris_response_fused
// Sobel -> Ixx/Iyy/Ixy -> separable Gaussian window -> det - k*tr^2;
// halo = 1 + K/2.
struct HarrisDims {
  int r, halo, in_h, in_w, g_h, g_w;
  __host__ __device__ explicit HarrisDims(int K)
      : r(K / 2), halo(1 + K / 2), in_h(TILE_H + 2 * halo), in_w(TILE_W + 2 * halo),
        g_h(TILE_H + 2 * r), g_w(TILE_W + 2 * r) {}
  __host__ __device__ int floats() const { return in_h * in_w + 3 * g_h * g_w + 3 * g_h * TILE_W; }
};

__global__ void __launch_bounds__(THREADS)
harris_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
              Taps taps, int K, float k) {
  extern __shared__ float smem[];
  __shared__ float s_k[MAX_TAPS];
  const HarrisDims d(K);
  const int g_n = d.g_h * d.g_w, hb_n = d.g_h * TILE_W;
  float* s_in = smem;
  float* s_p = s_in + d.in_h * d.in_w;  // Ixx, Iyy, Ixy planes
  float* s_hb = s_p + 3 * g_n;           // their W-blurred planes

  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t plane = (size_t)h * w;
  load_taps(taps, s_k);
  load_window(in + blockIdx.z * plane, h, w, y0 - d.halo, x0 - d.halo, s_in, d.in_h, d.in_w);
  __syncthreads();
  for (int i = threadIdx.x; i < g_n; i += blockDim.x) {
    const int r = i / d.g_w, c = i - r * d.g_w;
    float gx, gy;
    sobel_at(s_in + r * d.in_w + c, d.in_w, gx, gy);
    s_p[i] = gx * gx;
    s_p[g_n + i] = gy * gy;
    s_p[2 * g_n + i] = gx * gy;
  }
  __syncthreads();
  for (int p = 0; p < 3; ++p)
    blur_along_w(s_p + p * g_n, d.g_w, s_hb + p * hb_n, d.g_h, TILE_W, s_k, K);
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += blockDim.x) {
    const int r = i / TILE_W, c = i - r * TILE_W;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    float s[3];
    for (int p = 0; p < 3; ++p) {
      const float* q = s_hb + p * hb_n + r * TILE_W + c;
      float acc = q[0] * s_k[0];
      for (int t = 1; t < K; ++t) acc = acc + q[t * TILE_W] * s_k[t];
      s[p] = acc;
    }
    const float det = s[0] * s[1] - s[2] * s[2];
    const float tr = s[0] + s[1];
    out[blockIdx.z * plane + (size_t)y * w + x] = det - k * tr * tr;
  }
}

// ------------------------------------------------------------ host helpers
Taps make_taps(const float* taps, int K) {
  Taps t = {};
  for (int j = 0; j < K; ++j) t.v[j] = taps[j];
  return t;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
}

dim3 grid_for(int n, int h, int w, int tile_h, int tile_w) {
  return dim3((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, n);
}

bool bad_shape(int n, int h, int w) { return n < 1 || n > 65535 || h < 1 || w < 1; }

}  // namespace

// Each entry point launches on `stream` and returns the launch's
// cudaError_t (0 on success); it never synchronises.
extern "C" {

int cvt_canny_stage1(const float* in, uint8_t* out, int n, int h, int w, const float* taps,
                     int ksize, float low, float high, void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * CannyDims(ksize).floats();
  cudaError_t err = prepare(canny_stage1_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  canny_stage1_kernel<<<grid_for(n, h, w, TILE_H, TILE_W), THREADS, smem, (cudaStream_t)stream>>>(
      in, out, h, w, make_taps(taps, ksize), ksize, low, high);
  return (int)cudaGetLastError();
}

int cvt_hysteresis_sweeps(const uint8_t* in, uint8_t* out, int n, int h, int w, int sweeps,
                          int* changed, void* stream) {
  if (bad_shape(n, h, w) || sweeps < 1 || sweeps > MAX_SWEEPS) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(HYST_TILE_H + 2 * sweeps) * (HYST_TILE_W + 2 * sweeps);
  cudaError_t err = prepare(hysteresis_sweeps_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  hysteresis_sweeps_kernel<<<grid_for(n, h, w, HYST_TILE_H, HYST_TILE_W), THREADS, smem,
                             (cudaStream_t)stream>>>(in, out, h, w, sweeps, changed);
  return (int)cudaGetLastError();
}

int cvt_blur_sobel(const float* in, float* out, int n, int h, int w, const float* taps, int ksize,
                   void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * BlurSobelDims(ksize).floats();
  cudaError_t err = prepare(blur_sobel_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  blur_sobel_kernel<<<grid_for(n, h, w, TILE_H, TILE_W), THREADS, smem, (cudaStream_t)stream>>>(
      in, out, h, w, make_taps(taps, ksize), ksize);
  return (int)cudaGetLastError();
}

int cvt_harris(const float* in, float* out, int n, int h, int w, const float* taps, int ksize,
               float k, void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * HarrisDims(ksize).floats();
  cudaError_t err = prepare(harris_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  harris_kernel<<<grid_for(n, h, w, TILE_H, TILE_W), THREADS, smem, (cudaStream_t)stream>>>(
      in, out, h, w, make_taps(taps, ksize), ksize, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
