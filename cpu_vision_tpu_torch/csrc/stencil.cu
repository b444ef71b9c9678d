// Halo-tiled fused stencil kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernels of cpu_vision_tpu/ops/pallas/stencil.py:
//   cvt_canny_stage1      <- canny_stage1          (stencil.py:446), with its
//                            in_tile_hysteresis option (stencil.py:499-538)
//   cvt_hysteresis_sweeps <- hysteresis_sweeps     (stencil.py:404)
//   cvt_blur_sobel        <- fused_blur_sobel      (stencil.py:377)
//   cvt_harris            <- harris_response_fused (stencil.py:591)
//   cvt_gaussian_blur     <- fused_gaussian_blur   (stencil.py:357)
// and the halo row-band engine they share (_halo_stencil_call, stencil.py:66,
// and _halo_stencil_call_rowfused, stencil.py:171).
//
// Design.  The input is one (N, H, W) map, channels folded into N.  Every
// block of the Canny, hysteresis, blur+Sobel and blur kernels owns one
// TILE_H x TILE_W output tile of one image: it loads the
// (TILE_H + 2*halo) x (TILE_W + 2*halo) window around it into shared memory
// with reflect indexing (numpy "reflect": edge not repeated, periodic for
// pads longer than the image), runs the whole pipeline in shared memory and
// writes its tile, masking the ragged edge.  Intermediates (blur, gradients,
// magnitude, structure tensor) never reach device memory: one read of the
// input and one write of the output per call.
//
// Bound.  All of them read f32 (or the u8 class map) once and write once, and
// do a few tens of f32 operations per pixel, well under the H100's
// 67 TFLOP/s f32 rate against 3.35 TB/s, so device memory bounds them.  The
// halo windows overlap, so neighbouring blocks re-read up to ~1.6x the tile
// from L2, not from HBM.  Those four use plain loads, one tile per block,
// many blocks per SM to hide latency; Harris streams rows through cp.async on
// a persistent grid (its own note below).
//
// Exactness.  Sums run in the order of the Pallas kernels (blur taps j=0..k-1
// along W, then i=0..k-1 along H; Sobel in stencil.py:327-339's order), with
// every product and sum rounded on its own: build with --fmad=false and
// without --use_fast_math, so no a*b+c is contracted and sqrtf is the
// correctly rounded square root.  Thresholds and k arrive as f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using cvt::cp_async16;
using cvt::cp_async4;
using cvt::cp_async_commit;
using cvt::cp_async_wait;
using cvt::smem_addr;

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

//
// IN_TILE (the in_tile_hysteresis option): before the tile is written, strong
// grows through 8-connected weak to a fixpoint inside the block's own
// TILE_H x TILE_W output tile, confined to real image pixels.  The class map
// then depends on the tiling; the fixpoint of the global hysteresis that
// follows does not.  The tile's classes sit in shared memory (in the input
// window's space, free after the blur) inside a ring of zeros; every thread
// promotes its weak pixels that touch a strong one, in place, until a whole
// round changes nothing.  A round may or may not see a neighbour's promotion
// of the same round: promotions only ever turn 1 into 2, so every order
// reaches the same fixpoint.
template <bool IN_TILE>
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
  // s_in is dead since the blur along W: its space holds the class tile,
  // zero outside the image and in the ring around the tile
  constexpr int CLS_W = TILE_W + 2;
  uint8_t* s_cls = reinterpret_cast<uint8_t*>(s_in);
  if (IN_TILE)
    for (int i = threadIdx.x; i < (TILE_H + 2) * CLS_W; i += blockDim.x) s_cls[i] = 0;
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
    const uint8_t cls = sup >= high ? 2 : (sup >= low ? 1 : 0);
    if (IN_TILE) {
      s_cls[(1 + r) * CLS_W + 1 + c] = cls;
    } else {
      out[blockIdx.z * plane + (size_t)y * w + x] = cls;
    }
  }
  if (!IN_TILE) return;
  int changed;
  do {
    __syncthreads();
    changed = 0;
    for (int i = threadIdx.x; i < TILE_H * TILE_W; i += blockDim.x) {
      volatile uint8_t* p = s_cls + (1 + i / TILE_W) * CLS_W + 1 + i % TILE_W;
      if (*p != 1) continue;
      bool grow = false;
      for (int dr = -1; dr <= 1; ++dr)
        for (int dc = -1; dc <= 1; ++dc) grow |= p[dr * CLS_W + dc] == 2;
      if (grow) {
        *p = 2;
        changed = 1;
      }
    }
  } while (__syncthreads_or(changed));
  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += blockDim.x) {
    const int r = i / TILE_W, c = i - r * TILE_W;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    out[blockIdx.z * plane + (size_t)y * w + x] = s_cls[(1 + r) * CLS_W + 1 + c];
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
//
// Redesigned for Hopper: the tile-at-once kernel it replaces spent about 45
// shared accesses, two integer % and runtime divides an output pixel, and
// three barriers a tile.  Here every warp works alone on a persistent grid,
// walking (frame, strip) tiles: a strip is 32 C columns of products, a lane C
// neighbouring ones, and 32 C - (K - 1) columns of outputs (the last lanes'
// outputs would need products past the strip), HR_TILE_H rows deep.  The warp
// streams the strip's rows of the reflect-padded frame through a ring of
// HR_RING rows in its own shared memory, HR_AHEAD rows ahead of the row it
// reads: rows of interior strips by 16-byte cp.async as they lie (from the
// 16-byte boundary at or before the strip's first column; the frame's rows
// 16-byte aligned), rows of border strips by 4-byte cp.async from reflected
// columns computed once a tile; a row's own reflection is computed once a
// row.  A lane's Sobel runs from a 3 x (C + 2) register window that takes
// C + 2 values of each new row; its C products of each plane blur along W
// with the K - 1 products after them taken from the next lanes by shuffles;
// the W-blurred rows of the last K rows sit in registers, and each new one
// completes the H blur of C outputs.  One __syncwarp a row, no block barrier.
// K and C are template arguments (C 4 up to K 5, 2 up to K 11, else 1, to
// bound the registers), so every loop over taps unrolls with the taps in the
// kernel's parameter space.  Sums in the order of the kernel it replaces and
// of the twin.
constexpr int HR_WARPS = 4;
constexpr int HR_THREADS = 32 * HR_WARPS;
constexpr int HR_TILE_H = 64;          // output rows of a strip
constexpr int HR_RING = 8;             // input rows in a warp's shared memory
constexpr int HR_AHEAD = HR_RING - 1;  // rows copied ahead of the row read

template <int K>
struct HarrisShape {
  static constexpr int C = K <= 5 ? 4 : (K <= 11 ? 2 : 1);  // product (and output) columns a lane
  static constexpr int R = K / 2, HALO = 1 + R;
  static constexpr int PW = 32 * C;         // product columns of a strip
  static constexpr int OW = PW - (K - 1);   // output columns of a strip
  static constexpr int IW = PW + 8;         // a staged row: the strip's PW + 2 input columns from up to 3 before
  static constexpr int CHUNKS = IW / 4;     // 16-byte chunks of an interior row
  static constexpr int LOADS = (IW + 31) / 32;  // 4-byte copies a lane of a border row
  static_assert(OW >= 1 && CHUNKS <= 64, "a strip");
  static constexpr size_t SMEM = sizeof(float) * HR_WARPS * HR_RING * IW;
};

// gx, gy of the 3 x 3 window at column c of v (rows top to bottom), in sobel_at's order
template <int W>
__device__ __forceinline__ void sobel3(const float (&v)[3][W], int c, float& gx, float& gy) {
  gx = v[0][c] * -1.0f;
  gx = gx + v[0][c + 2];
  gx = gx + v[1][c] * -2.0f;
  gx = gx + v[1][c + 2] * 2.0f;
  gx = gx + v[2][c] * -1.0f;
  gx = gx + v[2][c + 2];
  gy = v[0][c] * -1.0f;
  gy = gy + v[0][c + 1] * -2.0f;
  gy = gy + v[0][c + 2] * -1.0f;
  gy = gy + v[2][c];
  gy = gy + v[2][c + 1] * 2.0f;
  gy = gy + v[2][c + 2];
}

// the reflected index of i (numpy "reflect"), without a division where it lies inside
__device__ __forceinline__ int reflect_fast(int i, int n) { return (unsigned)i < (unsigned)n ? i : reflect(i, n); }

template <int K>
__global__ void __launch_bounds__(HR_THREADS)
harris_kernel(const float* __restrict__ in, float* __restrict__ out, int frames, int h, int w, int tiles_x,
              int tiles_y, int vec_rows, Taps taps, float k) {
  using S = HarrisShape<K>;
  constexpr int C = S::C;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const s_in = smem + warp * HR_RING * S::IW;  // [HR_RING][IW]
  const int per_frame = tiles_x * tiles_y;
  const size_t plane = (size_t)h * w;

  for (long long tile = (long long)blockIdx.x * HR_WARPS + warp; tile < (long long)frames * per_frame;
       tile += (long long)gridDim.x * HR_WARPS) {
    const int f = (int)(tile / per_frame), rem = (int)(tile - (long long)f * per_frame);
    const int ty = rem / tiles_x, tx = rem - ty * tiles_x;
    const int y0 = ty * HR_TILE_H, x0 = tx * S::OW;
    const int out_rows = min(HR_TILE_H, h - y0), rows_in = out_rows + 2 * S::HALO;
    const float* const img = in + f * plane;
    // a staged row holds input columns from first (the strip's first, x0 - HALO, or up to 3 before it: a 16-byte
    // boundary); interior: the row as it lies
    const int x_first = x0 - S::HALO, shift = vec_rows ? (x_first & 3) : 0, first = x_first - shift;
    const bool interior = vec_rows && first >= 0 && first + S::IW <= w;
    int col[S::LOADS];
#pragma unroll
    for (int c = 0; c < S::LOADS; ++c)
      col[c] = lane + 32 * c < S::IW ? reflect_fast(first + lane + 32 * c, w) : -1;
    auto load = [&](int i) {  // padded row i of the tile: frame row y0 - HALO + i, reflected
      const float* row = img + (size_t)reflect_fast(y0 - S::HALO + i, h) * w;
      const uint32_t dst = smem_addr(s_in + (i % HR_RING) * S::IW);
      if (interior) {
#pragma unroll
        for (int c = 0; c < (S::CHUNKS + 31) / 32; ++c)
          if (lane + 32 * c < S::CHUNKS) cp_async16(dst + 16 * (lane + 32 * c), row + first + 4 * (lane + 32 * c), true);
      } else {
#pragma unroll
        for (int c = 0; c < S::LOADS; ++c)
          if (col[c] >= 0) cp_async4(dst + 4 * (lane + 32 * c), row + col[c], true);
      }
    };

    float win[3][C + 2];  // the Sobel window of this lane's C product columns
    float ring[3][C][K];  // W-blurred products of the last K rows, oldest first
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < C + 2; ++b) win[a][b] = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < K; ++j) ring[a][c][j] = 0.0f;
    }

    __syncwarp();  // every lane's reads of the last tile's ring rows end before this tile's first copies
#pragma unroll
    for (int i = 0; i < HR_AHEAD; ++i) {
      if (i < rows_in) load(i);
      cp_async_commit();
    }
    // rows in runs of K, unrolled: the W-blurred row g = i - 2 takes ring slot g % K, fixed for each position of
    // the run, so the ring never moves
    for (int i0 = 0; i0 < rows_in; i0 += K) {
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int i = i0 + u;
        if (i >= rows_in) break;
        cp_async_wait<HR_AHEAD - 1>();  // this lane's copies of row i
        __syncwarp();                   // the warp's; and every read of the slot reused below is done
        if (i + HR_AHEAD < rows_in) load(i + HR_AHEAD);
        cp_async_commit();
        // the new row's values of this lane's window: padded columns C lane .. C lane + C + 1
        const float* r = s_in + (i % HR_RING) * S::IW + shift + C * lane;
#pragma unroll
        for (int b = 0; b < C + 2; ++b) {
          win[0][b] = win[1][b];
          win[1][b] = win[2][b];
          win[2][b] = r[b];
        }
        if (i < 2) continue;
        // products of row g = i - 2, blurred along W: the K - 1 products after a lane's own from the next lanes
        const int slot = (u + 2 * K - 2) % K;  // a constant once the run is unrolled
        float prod[3][C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float gx, gy;
          sobel3(win, c, gx, gy);
          prod[0][c] = gx * gx;
          prod[1][c] = gy * gy;
          prod[2][c] = gx * gy;
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float ext[C + K - 1];
#pragma unroll
          for (int e = 0; e < C + K - 1; ++e)
            ext[e] = e < C ? prod[q][e] : __shfl_down_sync(0xffffffffu, prod[q][e % C], e / C);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float acc = ext[c] * taps.v[0];
#pragma unroll
            for (int j = 1; j < K; ++j) acc = acc + ext[c + j] * taps.v[j];
            ring[q][c][slot] = acc;
          }
        }
        const int yo = i - 2 - (K - 1);  // the output row the ring completes: rows g - K + 1 .. g, oldest first
        if (yo < 0 || yo >= out_rows) continue;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int o = C * lane + c;
          if (o >= S::OW || x0 + o >= w) continue;
          float sm[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            float acc = ring[q][c][(u + K - 1) % K] * taps.v[0];
#pragma unroll
            for (int j = 1; j < K; ++j) acc = acc + ring[q][c][(u + j + K - 1) % K] * taps.v[j];
            sm[q] = acc;
          }
          const float det = sm[0] * sm[1] - sm[2] * sm[2];
          const float tr = sm[0] + sm[1];
          out[f * plane + (size_t)(y0 + yo) * w + x0 + o] = det - k * tr * tr;
        }
      }
    }
  }
}

// ------------------------------------------------------ fused_gaussian_blur
// Separable K-tap blur, taps along W then along H; halo = K/2.
struct BlurDims {
  int halo, in_h, in_w;
  __host__ __device__ explicit BlurDims(int K)
      : halo(K / 2), in_h(TILE_H + 2 * halo), in_w(TILE_W + 2 * halo) {}
  __host__ __device__ int floats() const { return in_h * in_w + in_h * TILE_W; }
};

__global__ void __launch_bounds__(THREADS)
gaussian_blur_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
                     Taps taps, int K) {
  extern __shared__ float smem[];
  __shared__ float s_k[MAX_TAPS];
  const BlurDims d(K);
  float* s_in = smem;
  float* s_hb = s_in + d.in_h * d.in_w;

  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t plane = (size_t)h * w;
  load_taps(taps, s_k);
  load_window(in + blockIdx.z * plane, h, w, y0 - d.halo, x0 - d.halo, s_in, d.in_h, d.in_w);
  __syncthreads();
  blur_along_w(s_in, d.in_w, s_hb, d.in_h, TILE_W, s_k, K);
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += blockDim.x) {
    const int r = i / TILE_W, c = i - r * TILE_W;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    const float* q = s_hb + r * TILE_W + c;
    float acc = q[0] * s_k[0];
    for (int t = 1; t < K; ++t) acc = acc + q[t * TILE_W] * s_k[t];
    out[blockIdx.z * plane + (size_t)y * w + x] = acc;
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

// launch(f0, frames) for the frames [f0, f0 + frames) of n, at most cvt::MAX_GRID_YZ a launch; the first failed
// launch's error
template <typename Launch>
cudaError_t over_frames(int n, Launch launch) {
  for (int f0 = 0; f0 < n; f0 += cvt::MAX_GRID_YZ) {
    launch(f0, n - f0 < cvt::MAX_GRID_YZ ? n - f0 : cvt::MAX_GRID_YZ);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool bad_shape(int n, int h, int w) { return n < 1 || h < 1 || w < 1; }

template <int K>
cudaError_t launch_harris(const float* in, float* out, int n, int h, int w, const Taps& taps, float k, int sms,
                          cudaStream_t stream) {
  using S = HarrisShape<K>;
  cudaError_t err = prepare(harris_kernel<K>, S::SMEM);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)harris_kernel<K>, HR_THREADS, S::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidValue;
  const int tiles_x = (w + HarrisShape<K>::OW - 1) / HarrisShape<K>::OW, tiles_y = (h + HR_TILE_H - 1) / HR_TILE_H;
  const long long blocks = ((long long)n * tiles_x * tiles_y + HR_WARPS - 1) / HR_WARPS;  // a strip a warp
  const int grid = (int)(blocks < (long long)per_sm * sms ? blocks : (long long)per_sm * sms);
  const int vec_rows = w % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;  // every row 16-byte aligned
  harris_kernel<K><<<grid, HR_THREADS, S::SMEM, stream>>>(in, out, n, h, w, tiles_x, tiles_y, vec_rows, taps, k);
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns the first failed
// launch's cudaError_t (0 on success); it never synchronises.  Any number of
// frames: past 65,535 (cvt::MAX_GRID_YZ) the tiled kernels launch once for
// each 65,535 frames; Harris walks its frames on a persistent grid.
extern "C" {

int cvt_canny_stage1(const float* in, uint8_t* out, int n, int h, int w, const float* taps,
                     int ksize, float low, float high, int in_tile, void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * CannyDims(ksize).floats();
  auto kernel = in_tile ? canny_stage1_kernel<true> : canny_stage1_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t plane = (size_t)h * w;
  const Taps t = make_taps(taps, ksize);
  return (int)over_frames(n, [&](int f0, int frames) {
    kernel<<<grid_for(frames, h, w, TILE_H, TILE_W), THREADS, smem, (cudaStream_t)stream>>>(
        in + f0 * plane, out + f0 * plane, h, w, t, ksize, low, high);
  });
}

int cvt_gaussian_blur(const float* in, float* out, int n, int h, int w, const float* taps, int ksize,
                      void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * BlurDims(ksize).floats();
  cudaError_t err = prepare(gaussian_blur_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t plane = (size_t)h * w;
  const Taps t = make_taps(taps, ksize);
  return (int)over_frames(n, [&](int f0, int frames) {
    gaussian_blur_kernel<<<grid_for(frames, h, w, TILE_H, TILE_W), THREADS, smem, (cudaStream_t)stream>>>(
        in + f0 * plane, out + f0 * plane, h, w, t, ksize);
  });
}

int cvt_hysteresis_sweeps(const uint8_t* in, uint8_t* out, int n, int h, int w, int sweeps,
                          int* changed, void* stream) {
  if (bad_shape(n, h, w) || sweeps < 1 || sweeps > MAX_SWEEPS) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(HYST_TILE_H + 2 * sweeps) * (HYST_TILE_W + 2 * sweeps);
  cudaError_t err = prepare(hysteresis_sweeps_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t plane = (size_t)h * w;
  return (int)over_frames(n, [&](int f0, int frames) {
    hysteresis_sweeps_kernel<<<grid_for(frames, h, w, HYST_TILE_H, HYST_TILE_W), THREADS, smem,
                               (cudaStream_t)stream>>>(in + f0 * plane, out + f0 * plane, h, w, sweeps, changed);
  });
}

int cvt_blur_sobel(const float* in, float* out, int n, int h, int w, const float* taps, int ksize,
                   void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * BlurSobelDims(ksize).floats();
  cudaError_t err = prepare(blur_sobel_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t plane = (size_t)h * w;
  const Taps t = make_taps(taps, ksize);
  return (int)over_frames(n, [&](int f0, int frames) {
    blur_sobel_kernel<<<grid_for(frames, h, w, TILE_H, TILE_W), THREADS, smem, (cudaStream_t)stream>>>(
        in + f0 * plane, out + f0 * plane, h, w, t, ksize);
  });
}

// sms: the card's multiprocessors, which size the persistent grid
int cvt_harris(const float* in, float* out, int n, int h, int w, const float* taps, int ksize,
               float k, int sms, void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const Taps t = make_taps(taps, ksize);
  cudaStream_t st = (cudaStream_t)stream;
  switch (ksize) {
#define CVT_HARRIS_K(K) \
  case K:               \
    return (int)launch_harris<K>(in, out, n, h, w, t, k, sms, st);
    CVT_HARRIS_K(1) CVT_HARRIS_K(2) CVT_HARRIS_K(3) CVT_HARRIS_K(4) CVT_HARRIS_K(5) CVT_HARRIS_K(6)
    CVT_HARRIS_K(7) CVT_HARRIS_K(8) CVT_HARRIS_K(9) CVT_HARRIS_K(10) CVT_HARRIS_K(11) CVT_HARRIS_K(12)
    CVT_HARRIS_K(13) CVT_HARRIS_K(14) CVT_HARRIS_K(15) CVT_HARRIS_K(16) CVT_HARRIS_K(17) CVT_HARRIS_K(18)
    CVT_HARRIS_K(19) CVT_HARRIS_K(20) CVT_HARRIS_K(21) CVT_HARRIS_K(22) CVT_HARRIS_K(23) CVT_HARRIS_K(24)
    CVT_HARRIS_K(25) CVT_HARRIS_K(26) CVT_HARRIS_K(27) CVT_HARRIS_K(28) CVT_HARRIS_K(29) CVT_HARRIS_K(30)
    CVT_HARRIS_K(31)
#undef CVT_HARRIS_K
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
