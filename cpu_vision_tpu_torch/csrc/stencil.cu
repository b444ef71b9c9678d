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
// Design.  The input is one (N, H, W) map, channels folded into N; the
// blur's is (N, H, W, C) frames as they lie.  Every block of Canny's in-tile
// option owns one TILE_H x TILE_W output tile of one image: it loads the
// (TILE_H + 2*halo) x (TILE_W + 2*halo) window around it into shared memory
// with reflect indexing (numpy "reflect": edge not repeated, periodic for
// pads longer than the image), runs the whole pipeline in shared memory and
// writes its tile, masking the ragged edge.  Canny's main kernel, the
// hysteresis sweeps, Harris, the blur and blur+Sobel are strip kernels
// instead: each warp walks (frame, strip) tiles on a persistent grid and
// streams a strip's rows through a cp.async ring in its own shared memory
// (Canny's, the blur's and blur+Sobel's through StripRows), with the stages
// between in registers (their own notes below).  Intermediates (blur, gradients,
// magnitude, structure tensor, the sweeps' masks) never reach device memory:
// one read of the input and one write of the output per call.
//
// Bound.  All of them read f32 (or the u8 class map) once and write once, and
// do a few tens of f32 operations per pixel (the sweeps a few integer
// operations for 32 pixels), well under the H100's 67 TFLOP/s f32 rate
// against 3.35 TB/s, so device memory bounds them.  The halo windows overlap,
// so neighbouring tiles re-read up to ~1.6x the tile (the strips 1.03-1.25x)
// from L2, not from HBM.

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

// The row staging of the strip kernels (Canny's front half, blur+Sobel, the blur): IW floats of a frame row, from
// its element `first` on, into a slot of a ring in the warp's own shared memory.  A row is w columns of CH channels,
// w CH floats.  Interior strips (the frame's rows 16-byte aligned, the staged span inside the row) copy 16-byte chunks
// as the row lies; border strips copy 4 bytes an element from the element of the reflected column (numpy
// "reflect", the channel kept: element x CH + c reads reflect(x) CH + c), found once a tile.  Every lane of the
// warp constructs it for a tile and calls copy() for each row.
template <int IW, int CH>
struct StripRows {
  static constexpr int CHUNKS = IW / 4;         // 16-byte chunks of an interior row
  static constexpr int LOADS = (IW + 31) / 32;  // 4-byte copies a lane of a border row
  const float* frame;
  float* ring;  // [slots][IW]
  int row_len, first, lane;
  bool interior;
  int src[LOADS];  // border strips: the row's element that each of this lane's copies reads, -1 past the span

  __device__ __forceinline__ StripRows(const float* frame, float* ring, int w, int first, bool interior, int lane)
      : frame(frame), ring(ring), row_len(w * CH), first(first), lane(lane), interior(interior) {
#pragma unroll
    for (int c = 0; c < LOADS; ++c) {
      const int e = first + lane + 32 * c;                   // an element of the reflect-padded row
      const int x = e >= 0 ? e / CH : -((CH - 1 - e) / CH);  // its column, rounded down
      src[c] = lane + 32 * c < IW ? reflect_fast(x, w) * CH + (e - x * CH) : -1;
    }
  }

  // frame row y (already reflected) into ring slot `slot`
  __device__ __forceinline__ void copy(int y, int slot) const {
    const float* row = frame + (size_t)y * row_len;
    const uint32_t dst = smem_addr(ring + slot * IW);
    if (interior) {
#pragma unroll
      for (int c = 0; c < (CHUNKS + 31) / 32; ++c)
        if (lane + 32 * c < CHUNKS) cp_async16(dst + 16 * (lane + 32 * c), row + first + 4 * (lane + 32 * c), true);
    } else {
#pragma unroll
      for (int c = 0; c < LOADS; ++c)
        if (src[c] >= 0) cp_async4(dst + 4 * (lane + 32 * c), row + src[c], true);
    }
  }
};

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

// The in_tile_hysteresis option (IN_TILE in the wrapper), the tile kernel of
// the port's first design, kept for this option alone: its class map depends
// on the TILE_H x TILE_W tiling.  Before the tile is written, strong grows
// through 8-connected weak to a fixpoint inside the block's own tile, confined
// to real image pixels.  The fixpoint of the global hysteresis that follows
// does not depend on the tiling.  The tile's classes sit in shared memory (in
// the input window's space, free after the blur) inside a ring of zeros;
// every thread promotes its weak pixels that touch a strong one, in place,
// until a whole round changes nothing.  A round may or may not see a
// neighbour's promotion of the same round: promotions only ever turn 1 into
// 2, so every order reaches the same fixpoint.
__global__ void __launch_bounds__(THREADS)
canny_in_tile_kernel(const float* __restrict__ in, uint8_t* __restrict__ out, int h, int w, Taps taps, int K,
                     float low, float high) {
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
    s_cls[(1 + r) * CLS_W + 1 + c] = sup >= high ? 2 : (sup >= low ? 1 : 0);
  }
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

// The main path's Canny front half, redesigned for Hopper.  The tile kernel
// above (which this kernel replaced on the main path) loaded a 1.56x window a
// tile with two integer % a pixel, ran its taps in runtime loops and its
// stages through shared memory with six barriers a tile: 11x its bytes bound.
// Here, as in harris_kernel, every warp works alone on a persistent grid,
// walking (frame, strip) tiles: a lane blurs C neighbouring columns, a strip
// is 32 C blurred columns and 30 C output columns (lanes 1..30; at C 1 lanes
// 2..29: the Sobel and NMS windows of the others would reach past the strip),
// CS_TILE_H rows deep.  The warp streams the strip's rows of the
// reflect-padded frame through a ring of CS_RING rows in its own shared
// memory (StripRows: 16-byte cp.async on interior strips, 4-byte ones from
// reflected columns computed once a tile on border strips) and blurs them in
// registers (BlurFront, which blur_sobel_strip_kernel shares).  The Sobel pair
// comes from BlurFront's 3-row ring of blurred rows; NMS from a 3-row ring of
// magnitudes (neighbours by shuffles) and of gradients.  Lanes store in
// pairs: the first of each pair stores the pair's 4 classes as one word where
// the rows allow it.  K and C are
// template arguments (C 2 up to K 15, else 1: a wider lane holds more
// registers, and fewer warps an SM hide the rows' latency), so every loop over
// taps unrolls with the taps in the kernel's parameter space.  Every product and
// sum in the twin's order (_sep_blur, _sobel_pair, canny_stage1_plain), the
// correctly rounded sqrtf.
constexpr int CS_WARPS = 4;
constexpr int CS_THREADS = 32 * CS_WARPS;
constexpr int CS_TILE_H = 32;          // output rows of a strip
constexpr int CS_MIN_BLOCKS = 5;       // blocks an SM the registers must allow (tools/torch_canny_variants_ab.py)
constexpr int CS_RING = 8;             // input rows in a warp's shared memory

template <int K>
struct CannyShape {
  static constexpr int C = K <= 15 ? 2 : 1;  // blurred (and output) columns a lane
  static constexpr int R = K / 2, HALO = R + 2;
  static constexpr int PAD = 4 * ((R + 3) / 4);  // input columns a lane reads beyond its C, each side (>= R)
  static constexpr int BW = 32 * C;              // blurred columns of a strip
  // the first lane with outputs: the magnitudes beside a lane's columns need the blurred columns 2 away
  static constexpr int LANE0 = C == 1 ? 2 : 1;
  static constexpr int OW = (32 - 2 * LANE0) * C;  // output columns of a strip: lanes LANE0 .. 31 - LANE0
  static constexpr int IW = BW + 2 * PAD + 4;    // a staged row: the strip's input columns from up to 3 before
  static constexpr size_t SMEM = sizeof(float) * CS_WARPS * CS_RING * IW;
};

// n floats from p into v, in vectors of C floats (p aligned to them)
template <int C, int N>
__device__ __forceinline__ void read_row(const float* p, float (&v)[N]) {
  static_assert(N % C == 0, "whole vectors");
  if constexpr (C == 4) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (C == 2) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 t = reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = t.x;
      v[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = p[q];
  }
}

// the 4-bin NMS and double threshold of column c + 1 of the middle row m1 (m0 above, m2 below)
template <int W>
__device__ __forceinline__ uint8_t nms_class(const float (&m0)[W], const float (&m1)[W], const float (&m2)[W], int c,
                                             float gx0, float gy0, float low, float high) {
  const float mc = m1[c + 1];
  const float ax = fabsf(gx0), ay = fabsf(gy0);
  const bool d0 = ay < 0.41421356f * ax;   // tan 22.5 deg
  const bool d90 = ay >= 2.4142137f * ax;  // tan 67.5 deg
  const bool d45 = !d0 && !d90 && (gx0 * gy0 >= 0.0f);
  const float nb1 = d0 ? m1[c + 2] : (d45 ? m0[c + 2] : (d90 ? m0[c + 1] : m0[c]));
  const float nb2 = d0 ? m1[c] : (d45 ? m2[c] : (d90 ? m2[c + 1] : m2[c + 2]));
  const float sup = (mc >= nb1 && mc > nb2) ? mc : 0.0f;
  return sup >= high ? 2 : (sup >= low ? 1 : 0);
}

// gx, gy of the 3 x 3 window at column c of the rows r0, r1, r2 (top to bottom), in sobel_at's order
template <int W>
__device__ __forceinline__ void sobel_rows(const float (&r0)[W], const float (&r1)[W], const float (&r2)[W], int c,
                                           float& gx, float& gy) {
  gx = r0[c] * -1.0f;
  gx = gx + r0[c + 2];
  gx = gx + r1[c] * -2.0f;
  gx = gx + r1[c + 2] * 2.0f;
  gx = gx + r2[c] * -1.0f;
  gx = gx + r2[c + 2];
  gy = r0[c] * -1.0f;
  gy = gy + r0[c + 1] * -2.0f;
  gy = gy + r0[c + 2] * -1.0f;
  gy = gy + r2[c];
  gy = gy + r2[c + 1] * 2.0f;
  gy = gy + r2[c + 2];
}

// The front half of the strip kernels that blur a strip and take Sobel's pair of it (canny_strip_kernel,
// blur_sobel_strip_kernel), for one lane of a warp.  The tile's rows of the reflect-padded frame arrive through a
// ring of RING slots of IW floats in the warp's own shared memory, RING - 1 rows ahead of the row read (`load(i)`
// copies padded row i of the tile into slot i % RING).  The lane reads its C + 2 PAD staged values of a row (from
// `lane_in` in slot 0) in vectors of C and blurs its C columns along W; the W-blurred rows of the last K rows sit in
// a register ring, and each new one completes the H blur of a row of C columns, kept in a ring of three blurred rows
// with the column before and after this lane's from the lanes beside it (by shuffles).  Rows come in runs of 3,
// unrolled: a blurred row's slot is fixed for each position of the run, so no window moves.  The ring of W-blurred
// rows shifts a row at a time, unless K divides 3 and its slots are fixed the same way (runs of lcm(K, 3) rows,
// which would fix them for every K, take more registers and twice the code).  Every product and sum in _sep_blur's
// order.  One __syncwarp a row, no block barrier.
template <int K, int C, int PAD, int IW, int RING>
struct BlurFront {
  static constexpr int R = K / 2, NV = C + 2 * PAD, AHEAD = RING - 1, RUN = 3;
  static constexpr bool RING_FIXED = RUN % K == 0;
  float ring[C][K];    // W-blurred rows of the last K rows
  float bw[3][C + 2];  // blurred rows, the column before this lane's to the one after

  // walks a tile's rows_in staged rows; from row K - 1 on, calls row_done(i, u, bq) at row i, position u of its
  // run, once bw[bq] holds blurred row i - K + 1 (bq is fixed for each u)
  template <typename Load, typename RowDone>
  __device__ __forceinline__ void walk(const Load& load, const float* lane_in, const Taps& taps, int rows_in,
                                       const RowDone& row_done) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < C + 2; ++b) bw[a][b] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < K; ++j) ring[c][j] = 0.0f;

    __syncwarp();  // every lane's reads of the last tile's ring rows end before this tile's first copies
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (i < rows_in) load(i);
      cp_async_commit();
    }
    for (int i0 = 0; i0 < rows_in; i0 += RUN) {
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        const int i = i0 + u;
        if (i >= rows_in) break;
        cp_async_wait<AHEAD - 1>();  // this lane's copies of row i
        __syncwarp();                // the warp's; and every read of the slot reused below is done
        if (i + AHEAD < rows_in) load(i + AHEAD);
        cp_async_commit();
        float v[NV];  // input columns C lane - PAD .. C lane + C + PAD - 1 of the strip's blurred ones
        read_row<C>(lane_in + (i % RING) * IW, v);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float acc = v[PAD - R + c] * taps.v[0];
#pragma unroll
          for (int j = 1; j < K; ++j) acc = acc + v[PAD - R + c + j] * taps.v[j];
          if (RING_FIXED) {
            ring[c][u % K] = acc;
          } else {
#pragma unroll
            for (int j = 0; j < K - 1; ++j) ring[c][j] = ring[c][j + 1];
            ring[c][K - 1] = acc;
          }
        }
        if (i < K - 1) continue;
        auto oldest = [&](int j) { return RING_FIXED ? (u + 1 + j) % K : j; };  // the slot of the j-th oldest row
        const int bq = ((u - K + 1) % 3 + 3) % 3;  // fixed for each position of the run, as i0 % 3 == 0
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float acc = ring[c][oldest(0)] * taps.v[0];
#pragma unroll
          for (int j = 1; j < K; ++j) acc = acc + ring[c][oldest(j)] * taps.v[j];
          bw[bq][c + 1] = acc;
        }
        bw[bq][0] = __shfl_up_sync(0xffffffffu, bw[bq][C], 1);
        bw[bq][C + 1] = __shfl_down_sync(0xffffffffu, bw[bq][1], 1);
        row_done(i, u, bq);
      }
    }
  }
};

template <int K>
__global__ void __launch_bounds__(CS_THREADS, CS_MIN_BLOCKS)
canny_strip_kernel(const float* __restrict__ in, uint8_t* __restrict__ out, int frames, int h, int w, int tiles_x,
                   int tiles_y, int vec_rows, int vec_out, Taps taps, float low, float high) {
  using S = CannyShape<K>;
  constexpr int C = S::C;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const s_in = smem + warp * CS_RING * S::IW;  // [CS_RING][IW]
  const int per_frame = tiles_x * tiles_y;
  const size_t plane = (size_t)h * w;
  const bool stores = lane >= S::LANE0 && lane <= 31 - S::LANE0;

  for (long long tile = (long long)blockIdx.x * CS_WARPS + warp; tile < (long long)frames * per_frame;
       tile += (long long)gridDim.x * CS_WARPS) {
    const int f = (int)(tile / per_frame), rem = (int)(tile - (long long)f * per_frame);
    const int ty = rem / tiles_x, tx = rem - ty * tiles_x;
    const int y0 = ty * CS_TILE_H, xs = tx * S::OW;  // first output row and column
    const int out_rows = min(CS_TILE_H, h - y0), rows_in = out_rows + K + 3;
    // lane l blurs columns xs + C (l - LANE0) ..: the strip's first blurred column is xs - C LANE0, its first
    // input column xs - C LANE0 - PAD; a staged row holds input columns from first (that one, or up to 3 before it:
    // a 16-byte boundary); interior: the row as it lies
    const int x_first = xs - C * S::LANE0 - S::PAD, shift = vec_rows ? (x_first & 3) : 0, first = x_first - shift;
    const StripRows<S::IW, 1> rows(in + f * plane, s_in, w, first, vec_rows && first >= 0 && first + S::IW <= w, lane);
    auto load = [&](int i) { rows.copy(reflect_fast(y0 - S::HALO + i, h), i % CS_RING); };  // padded row i of the tile
    // this lane's first output column, and its classes' first byte in the tile's first row
    const int x = xs + C * (lane - S::LANE0);
    uint8_t* const o_tile = out + f * plane + (size_t)y0 * w + x;

    BlurFront<K, C, S::PAD, S::IW, CS_RING> front;  // at row i, the blurred row of frame row y0 + i - K - 1
    float mw[3][C + 2];        // ring of magnitudes, the column before this lane's to the one after
    float gx[3][C], gy[3][C];  // the gradients of mw's rows
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < C + 2; ++b) mw[a][b] = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) gx[a][c] = gy[a][c] = 0.0f;
    }
    const auto& bw = front.bw;
    front.walk(load, s_in + shift + C * lane, taps, rows_in, [&](int i, int u, int bq) {
      if (i < K + 1) return;
      // the gradients and magnitude of frame row y0 + i - K - 2: the blurred rows bq - 2, bq - 1, bq; the
      // magnitude's slot mq (row i - K - 1 of the magnitudes, mod 3)
      const int mq = ((u - K - 1) % 3 + 3) % 3;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sobel_rows(bw[(bq + 1) % 3], bw[(bq + 2) % 3], bw[bq], c, gx[mq][c], gy[mq][c]);
        mw[mq][c + 1] = sqrtf(gx[mq][c] * gx[mq][c] + gy[mq][c] * gy[mq][c]);
      }
      mw[mq][0] = __shfl_up_sync(0xffffffffu, mw[mq][C], 1);
      mw[mq][C + 1] = __shfl_down_sync(0xffffffffu, mw[mq][1], 1);
      if (i < K + 3) return;
      // NMS and thresholds of output row i - K - 3 of the tile (the magnitudes' middle row, mq - 1)
      const int top = (mq + 1) % 3, mid = (mq + 2) % 3;
      uint8_t cls[C];
#pragma unroll
      for (int c = 0; c < C; ++c) cls[c] = nms_class(mw[top], mw[mid], mw[mq], c, gx[mid][c], gy[mid][c], low, high);
      uint8_t* const o = o_tile + (size_t)(i - K - 3) * w;
      if constexpr (C == 2) {
        // lanes in pairs (1, 2), (3, 4), ..: the first of each stores both lanes' 4 classes as one word
        const uint32_t mine = (uint32_t)cls[0] | (uint32_t)cls[1] << 8;
        const uint32_t word = mine | __shfl_down_sync(0xffffffffu, mine, 1) << 16;
        if (!stores || !(lane & 1)) return;
        if (vec_out && x + 4 <= w) {
          *reinterpret_cast<uint32_t*>(o) = word;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (x + c < w) o[c] = (uint8_t)(word >> (8 * c));
        }
      } else {
        if (stores && x < w) o[0] = cls[0];
      }
    });
  }
}

// ------------------------------------------------------- hysteresis_sweeps
// `sweeps` steps of: a weak pixel (1) with a strong (2) 8-neighbour becomes
// strong, on the class map reflected by `sweeps`: each step leaves the
// outermost ring stale.
//
// Redesigned for Hopper: the byte-wise tile kernel it replaced made 9
// shared-memory reads a weak pixel a sweep and a reflect % a byte, and read
// its input a second time for the changed flag: 21x its bytes bound.  The
// class map holds {0, 1, 2}, so a step is S' = S | (W & dilate8(S)) on two
// bit masks, a few integer operations for 32 pixels.  Every warp works alone
// on a persistent grid, walking (frame, strip) tiles: a strip is 1,024
// columns, a 32-bit word a lane, of which the middle HY_OW are output (a halo
// of HY_EDGE >= sweeps each side), HY_TILE_H output rows deep.  Rows of the
// reflected frame stream through a ring of HY_RING rows in the warp's shared
// memory by 16-byte cp.async (32 bytes a lane), HY_AHEAD rows ahead; a lane
// packs its 32 bytes of a row into the strong and weak masks by byte
// arithmetic.  Columns past the image's edges are reflected on the masks: a
// reflected column is a copy of an inner one, so the bits of the 16 columns
// past an edge are the strip's own bits mirrored about it (two shuffles, a
// funnel shift and a bit reversal).  Images whose rows are not whole 16-byte
// chunks take plain byte loads from reflected columns.  The sweeps run as a
// wavefront in registers: when row i arrives, sweep t computes row i - t from
// the last three rows of sweep t - 1 (the dilation's carries across words by
// shuffles, the rows above and below in registers), so each row is read once
// and every sweep's rows stay on chip.  The last sweep's rows are unpacked
// and stored 16 bytes a lane.  The flags come from the masks: a changed pixel
// is a weak one that is strong now, and the last sweep changed one where the
// last two sweeps' masks differ on the tile's output.  `sweeps` is a template
// argument, so every sweep's registers are named.
constexpr int HY_WARPS = 4;
constexpr int HY_THREADS = 32 * HY_WARPS;
constexpr int HY_TILE_H = 20;                 // output rows of a strip (tools/torch_canny_variants_ab.py)
constexpr int HY_RING = 8;                    // rows in a warp's shared memory
constexpr int HY_AHEAD = HY_RING - 1;         // rows copied ahead of the row read
constexpr int HY_SPAN = 32 * 32;              // columns of a strip: a 32-bit word a lane
constexpr int HY_EDGE = 16;                   // halo columns each side (MAX_SWEEPS)
constexpr int HY_OW = HY_SPAN - 2 * HY_EDGE;  // output columns of a strip
constexpr size_t HY_SMEM = (size_t)HY_WARPS * HY_RING * HY_SPAN;
static_assert(HY_EDGE >= MAX_SWEEPS && HY_EDGE % 16 == 0 && HY_OW % 16 == 0, "whole 16-byte chunks");

// bits [lo, hi) of a word, clamped to [0, 32)
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 32);
  if (hi <= lo) return 0u;
  return (hi - lo == 32 ? 0xffffffffu : (1u << (hi - lo)) - 1u) << lo;
}

// bits 0, 8, 16, 24 of x to bits 0..3; and back
__device__ __forceinline__ uint32_t gather4(uint32_t x) { return (x * 0x10204080u) >> 28; }
__device__ __forceinline__ uint32_t spread4(uint32_t n) { return (n * 0x00204081u) & 0x01010101u; }

// the strong (2) and weak (1) masks of 32 class bytes, 4 to a word, in column order
__device__ __forceinline__ void pack_classes(const uint32_t (&v)[8], uint32_t& strong, uint32_t& weak) {
  strong = weak = 0u;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    strong |= gather4((v[g] >> 1) & 0x01010101u) << (4 * g);
    weak |= gather4(v[g] & 0x01010101u) << (4 * g);
  }
}

// the class bytes (2 strong, 1 weak, 0 else) of the 16 columns of bits b .. b + 15, 4 to a word
__device__ __forceinline__ uint4 unpack_classes(uint32_t strong, uint32_t weak, int b) {
  const uint32_t s = strong >> b, wk = (weak & ~strong) >> b;
  uint32_t o[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) o[g] = spread4((s >> (4 * g)) & 15u) << 1 | spread4((wk >> (4 * g)) & 15u);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// word with its bits at the strip's positions [lo, hi) replaced by the bit at position 2 P - p (a reflection
// about position P); every lane of the warp calls it, and the sources must hold real columns of the strip
__device__ __forceinline__ uint32_t mirror(uint32_t word, int lane, int P, int lo, int hi) {
  const int a0 = 2 * P - 32 * lane - 31;  // the source of this lane's bit 31
  const int a = a0 >> 5;
  const uint32_t w0 = __shfl_sync(0xffffffffu, word, a & 31), w1 = __shfl_sync(0xffffffffu, word, (a + 1) & 31);
  const uint32_t rev = __brev(__funnelshift_r(w0, w1, a0 & 31));  // bit j: source 2 P - 32 lane - j
  const uint32_t m = bit_range(lo - 32 * lane, hi - 32 * lane);
  return (word & ~m) | (rev & m);
}

template <int SW>
__global__ void __launch_bounds__(HY_THREADS)
hysteresis_bits_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int frames, int h, int w,
                       int tiles_x, int tiles_y, int vec, int* __restrict__ changed, int* __restrict__ last_changed) {
  extern __shared__ __align__(16) uint8_t s_rows[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* const ring = s_rows + warp * HY_RING * HY_SPAN;  // [HY_RING][HY_SPAN]
  const int per_frame = tiles_x * tiles_y;
  const size_t plane = (size_t)h * w;
  bool any = false, any_last = false;

  for (long long tile = (long long)blockIdx.x * HY_WARPS + warp; tile < (long long)frames * per_frame;
       tile += (long long)gridDim.x * HY_WARPS) {
    const int f = (int)(tile / per_frame), rem = (int)(tile - (long long)f * per_frame);
    const int ty = rem / tiles_x, tx = rem - ty * tiles_x;
    const int y0 = ty * HY_TILE_H, x0 = tx * HY_OW;  // first output row and column
    const int base = x0 - HY_EDGE;                   // the column of the strip's position 0
    const int out_rows = min(HY_TILE_H, h - y0), rows_in = out_rows + 2 * SW;
    const uint8_t* const img = in + f * plane;
    // this lane's output bits: positions HY_EDGE .. HY_EDGE + HY_OW - 1 whose columns lie in the image
    const uint32_t outmask = bit_range(HY_EDGE - 32 * lane, min(HY_EDGE + HY_OW, w - base) - 32 * lane);
    const int p0 = -base, pw = w - 1 - base;  // the positions of columns 0 and w - 1
    const bool left = vec && p0 > 0, right = vec && pw + 1 < HY_SPAN;
    auto load = [&](int i) {  // padded row i of the tile: frame row y0 - SW + i, reflected; chunks past the image 0
      const uint8_t* row = img + (size_t)reflect_fast(y0 - SW + i, h) * w;
      const uint32_t dst = smem_addr(ring + (i % HY_RING) * HY_SPAN + 32 * lane);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = base + 32 * lane + 16 * k;
        const bool inside = c >= 0 && c + 16 <= w;
        cp_async16(dst + 16 * k, inside ? row + c : row, inside);
      }
    };

    uint32_t sw[SW][3];  // strong masks after sweeps 0 .. SW - 1 of the last three rows each, top to bottom
    uint32_t wk[SW + 1];  // weak masks of rows i, i - 1, .., i - SW
#pragma unroll
    for (int t = 0; t < SW; ++t) sw[t][0] = sw[t][1] = sw[t][2] = 0u;
#pragma unroll
    for (int t = 0; t <= SW; ++t) wk[t] = 0u;

    if (vec) {
      __syncwarp();  // every lane's reads of the last tile's ring rows end before this tile's first copies
#pragma unroll
      for (int i = 0; i < HY_AHEAD; ++i) {
        if (i < rows_in) load(i);
        cp_async_commit();
      }
    }
    for (int i = 0; i < rows_in; ++i) {
      uint32_t s0 = 0u, w0 = 0u;
      if (vec) {
        cp_async_wait<HY_AHEAD - 1>();  // this lane's copies of row i
        __syncwarp();                   // and every read of the slot reused below is done
        if (i + HY_AHEAD < rows_in) load(i + HY_AHEAD);
        cp_async_commit();
        const uint4* p = reinterpret_cast<const uint4*>(ring + (i % HY_RING) * HY_SPAN + 32 * lane);
        const uint4 a = p[0], b = p[1];
        const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        pack_classes(v, s0, w0);
        if (left) {  // columns -16 .. -1 are columns 16 .. 1
          s0 = mirror(s0, lane, p0, p0 - HY_EDGE, p0);
          w0 = mirror(w0, lane, p0, p0 - HY_EDGE, p0);
        }
        if (right) {  // columns w .. w + 15 are columns w - 2 .. w - 17
          s0 = mirror(s0, lane, pw, pw + 1, pw + 1 + HY_EDGE);
          w0 = mirror(w0, lane, pw, pw + 1, pw + 1 + HY_EDGE);
        }
      } else {  // byte loads from reflected columns, those within SW of the image only
        const uint8_t* row = img + (size_t)reflect_fast(y0 - SW + i, h) * w;
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          const int c = base + 32 * lane + j;
          if (c < -SW || c >= w + SW) continue;
          const uint32_t cls = row[reflect_fast(c, w)];
          s0 |= (cls >> 1 & 1u) << j;
          w0 |= (cls & 1u) << j;
        }
      }
#pragma unroll
      for (int t = SW; t > 0; --t) wk[t] = wk[t - 1];
      wk[0] = w0;
      sw[0][0] = sw[0][1];
      sw[0][1] = sw[0][2];
      sw[0][2] = s0;
#pragma unroll
      for (int t = 1; t <= SW; ++t) {  // sweep t on row i - t
        const uint32_t v = sw[t - 1][0] | sw[t - 1][1] | sw[t - 1][2];
        const uint32_t l = __shfl_up_sync(0xffffffffu, v, 1), r = __shfl_down_sync(0xffffffffu, v, 1);
        const uint32_t grown = sw[t - 1][1] | (wk[t] & (v | __funnelshift_l(l, v, 1) | __funnelshift_r(v, r, 1)));
        if (t < SW) {
          sw[t][0] = sw[t][1];
          sw[t][1] = sw[t][2];
          sw[t][2] = grown;
          continue;
        }
        if (i < 2 * SW) continue;  // row i - SW is an output row from here on: frame row y0 + i - 2 SW
        any |= (grown & wk[SW] & outmask) != 0u;
        any_last |= (grown & ~sw[SW - 1][1] & outmask) != 0u;
        uint8_t* const o = out + f * plane + (size_t)(y0 + i - 2 * SW) * w + base + 32 * lane;
        if (vec) {
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if ((outmask >> (16 * k)) & 1u) reinterpret_cast<uint4*>(o)[k] = unpack_classes(grown, wk[SW], 16 * k);
        } else {
#pragma unroll 4
          for (int j = 0; j < 32; ++j)
            if ((outmask >> j) & 1u) o[j] = (uint8_t)((grown >> j & 1u) << 1 | (wk[SW] & ~grown) >> j & 1u);
        }
      }
    }
  }
  any = __any_sync(0xffffffffu, any);
  any_last = __any_sync(0xffffffffu, any_last);
  if (lane == 0 && any && changed != nullptr) *changed = 1;
  if (lane == 0 && any_last && last_changed != nullptr) *last_changed = 1;
}

// --------------------------------------------------------- fused_blur_sobel
// sqrt(gx^2 + gy^2) of the Gaussian-blurred image; halo = K/2 + 1.
//
// Redesigned for Hopper: the tile kernel it replaced loaded a 1.4x window a
// 32 x 32 tile with two integer % a pixel, ran its taps in runtime loops out
// of shared memory and its stages behind three block barriers: 6.0x its
// bytes bound at 1080p b8.  It computes the front half of canny_strip_kernel
// (blur along W, along H, Sobel, magnitude) on the same engine: warps of
// CS_WARPS a block walk (frame, strip) tiles on a persistent grid, the
// strip's rows staged by StripRows through a ring of BS_RING rows and blurred
// by BlurFront.  A strip is 32 C blurred columns and 30 C output columns
// (lanes 1..30: the Sobel of a lane's columns takes the blurred column before
// and after from the lanes beside it), BS_TILE_H rows deep, or fewer, down to
// BS_LOW_TILE_H, where the frames would leave warps idle: a small image's time
// is one strip's latency, the rows of its strip one after another.  The
// magnitude is the correctly rounded sqrtf of Canny's sobel_rows, stored as C
// floats at once where the row allows it.  K is a template argument and C
// follows it (4 up to K 7, 2 up to K 15, else 1: the f32 output is 4x
// Canny's bytes, so a lane takes Canny's C or more).  Every product and sum
// in the twin's order (_sep_blur, _sobel_pair, fused_blur_sobel_plain), each
// rounded alone: the same bits as Canny's front half and as the twin.
constexpr int BS_TILE_H = 16;          // output rows of a strip, unless the frames make too few strips
constexpr int BS_LOW_TILE_H = 2;       // the fewest output rows of a strip
constexpr int BS_MIN_BLOCKS = 4;       // blocks an SM the registers must allow
constexpr int BS_RING = 6;             // input rows in a warp's shared memory
constexpr int BS_WIDE_K = 7;           // the largest K at four columns a lane

template <int K>
struct BlurSobelShape {
  static constexpr int C = K <= BS_WIDE_K ? 4 : (K <= 15 ? 2 : 1);  // blurred (and output) columns a lane
  static constexpr int R = K / 2, HALO = R + 1;
  static constexpr int PAD = 4 * ((R + 3) / 4);  // input columns a lane reads beyond its C, each side (>= R)
  static constexpr int BW = 32 * C;              // blurred columns of a strip
  static constexpr int OW = 30 * C;              // output columns of a strip: lanes 1 .. 30
  static constexpr int IW = BW + 2 * PAD + 4;    // a staged row: the strip's input columns from up to 3 before
  static constexpr size_t SMEM = sizeof(float) * CS_WARPS * BS_RING * IW;
};

template <int K>
__global__ void __launch_bounds__(CS_THREADS, BS_MIN_BLOCKS)
blur_sobel_strip_kernel(const float* __restrict__ in, float* __restrict__ out, int frames, int h, int w, int tiles_x,
                        int tiles_y, int tile_h, int vec_rows, int vec_out, Taps taps) {
  using S = BlurSobelShape<K>;
  constexpr int C = S::C;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const s_in = smem + warp * BS_RING * S::IW;  // [BS_RING][IW]
  const int per_frame = tiles_x * tiles_y;
  const size_t plane = (size_t)h * w;
  const bool stores = lane >= 1 && lane <= 30;

  for (long long tile = (long long)blockIdx.x * CS_WARPS + warp; tile < (long long)frames * per_frame;
       tile += (long long)gridDim.x * CS_WARPS) {
    const int f = (int)(tile / per_frame), rem = (int)(tile - (long long)f * per_frame);
    const int ty = rem / tiles_x, tx = rem - ty * tiles_x;
    const int y0 = ty * tile_h, xs = tx * S::OW;  // first output row and column
    const int out_rows = min(tile_h, h - y0), rows_in = out_rows + K + 1;
    // lane l blurs columns xs + C (l - 1) ..: the strip's first blurred column is xs - C, its first input column
    // xs - C - PAD; a staged row holds input columns from first (that one, or up to 3 before it: a 16-byte
    // boundary); interior: the row as it lies
    const int x_first = xs - C - S::PAD, shift = vec_rows ? (x_first & 3) : 0, first = x_first - shift;
    const StripRows<S::IW, 1> rows(in + f * plane, s_in, w, first, vec_rows && first >= 0 && first + S::IW <= w, lane);
    auto load = [&](int i) { rows.copy(reflect_fast(y0 - S::HALO + i, h), i % BS_RING); };  // padded row i of the tile
    const int x = xs + C * (lane - 1);  // this lane's first output column
    float* const o_tile = out + f * plane + (size_t)y0 * w + x;
    const bool whole = vec_out && x + C <= w;

    BlurFront<K, C, S::PAD, S::IW, BS_RING> front;  // at row i, the blurred row of frame row y0 + i - K
    const auto& bw = front.bw;
    front.walk(load, s_in + shift + C * lane, taps, rows_in, [&](int i, int, int bq) {
      if (i < K + 1) return;
      // output row i - K - 1 of the tile: the blurred rows bq - 2, bq - 1, bq
      float m[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float gx, gy;
        sobel_rows(bw[(bq + 1) % 3], bw[(bq + 2) % 3], bw[bq], c, gx, gy);
        m[c] = sqrtf(gx * gx + gy * gy);
      }
      if (!stores) return;
      float* const dst = o_tile + (size_t)(i - K - 1) * w;
      if constexpr (C == 4) {
        if (whole) {
          *reinterpret_cast<float4*>(dst) = make_float4(m[0], m[1], m[2], m[3]);
          return;
        }
      } else if constexpr (C == 2) {
        if (whole) {
          *reinterpret_cast<float2*>(dst) = make_float2(m[0], m[1]);
          return;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (x + c < w) dst[c] = m[c];
    });
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
// Separable K-tap blur of NHWC frames, taps along W then along H; halo = K/2.
//
// Redesigned for Hopper on Canny's strip engine.  The tile kernel it replaced
// took (N C, H, W) maps, which the wrapper made with a permuting copy of the
// whole batch, staged a 1.27x window a tile with two integer % a pixel, ran
// its taps in runtime loops and put its W-blurred rows through shared memory
// behind a block barrier: 5.8x its bytes bound with the copy.  Here the
// kernel reads the frames as they lie.  Row y of an (N, H, W, CH) frame is
// W CH floats, and along W the tap j of element e = x CH + c is element
// e + (j - R) CH: the W blur is a 1-D stencil over the row's elements with
// its taps CH apart, and the column past an edge is reflected with the
// channel kept (StripRows).  Every warp works alone on a persistent grid,
// walking (frame, strip) tiles: a strip is 32 Q elements of a row (Q a
// lane), BL_TILE_H output rows deep.  Its rows of the reflect-padded frame
// stream through a ring of BL_RING rows in the warp's shared memory,
// BL_AHEAD rows ahead of the row read (StripRows: 16-byte copies on interior
// strips, 4-byte ones on border strips).  A lane blurs its Q elements along
// W from the staged row (read in 16-byte vectors where Q is 4 and the window
// is short); the W-blurred rows of the last K rows sit in a register ring
// (in runs of K rows up to K 8, so no slot moves; a shifting ring past it),
// and each new row completes the H blur of Q outputs, stored as one vector.
// One __syncwarp a row, no block barrier.  K and CH are template arguments
// (CH 1, 3 and 4; other channel counts run at CH 1 on (N C, H, W) maps), so
// every loop over taps unrolls with the taps in the kernel's parameter space.
// Every product and sum in the twin's order (_sep_blur), each rounded alone.
constexpr int BL_WARPS = 4;
constexpr int BL_THREADS = 32 * BL_WARPS;
constexpr int BL_TILE_H = 32;          // output rows of a strip
constexpr int BL_MIN_BLOCKS = 1;       // blocks an SM the registers must allow (tools/torch_canny_variants_ab.py)
constexpr int BL_RING = 8;             // input rows in a warp's shared memory
constexpr int BL_AHEAD = BL_RING - 1;  // rows copied ahead of the row read

template <int K, int CH>
struct BlurShape {
  static constexpr int R = K / 2;
  static constexpr int Q = K <= 7 ? 4 : (K <= 15 ? 2 : 1);  // output elements a lane
  static constexpr int OW = 32 * Q;                         // output elements of a strip
  static constexpr int PAD = 4 * ((R * CH + 3) / 4);        // staged elements each side of the strip (>= R CH)
  static constexpr int IW = OW + 2 * PAD;                   // a staged row
  static constexpr int NV = Q + 2 * PAD;                    // the staged elements a lane's W blur reads from
  static constexpr bool VEC = Q == 4 && NV <= 32;           // read them in 16-byte vectors
  static constexpr int RUN = K <= 8 ? K : 1;                // rows unrolled: runs of K fix the ring's slots
  static constexpr size_t SMEM = sizeof(float) * BL_WARPS * BL_RING * IW;
};

template <int K, int CH>
__global__ void __launch_bounds__(BL_THREADS, BL_MIN_BLOCKS)
blur_strip_kernel(const float* __restrict__ in, float* __restrict__ out, int frames, int h, int w, int tiles_x,
                  int tiles_y, int vec_rows, int vec_out, Taps taps) {
  using S = BlurShape<K, CH>;
  constexpr int Q = S::Q, R = S::R, RUN = S::RUN;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const s_in = smem + warp * BL_RING * S::IW;  // [BL_RING][IW]
  const int row_len = w * CH, per_frame = tiles_x * tiles_y;
  const size_t plane = (size_t)h * row_len;

  for (long long tile = (long long)blockIdx.x * BL_WARPS + warp; tile < (long long)frames * per_frame;
       tile += (long long)gridDim.x * BL_WARPS) {
    const int f = (int)(tile / per_frame), rem = (int)(tile - (long long)f * per_frame);
    const int ty = rem / tiles_x, tx = rem - ty * tiles_x;
    const int y0 = ty * BL_TILE_H, es = tx * S::OW;  // first output row and element
    const int out_rows = min(BL_TILE_H, h - y0), rows_in = out_rows + K - 1;
    const int first = es - S::PAD;  // the staged row's first element: a multiple of 4
    const StripRows<S::IW, CH> rows(in + f * plane, s_in, w, first, vec_rows && first >= 0 && first + S::IW <= row_len,
                                    lane);
    auto load = [&](int i) { rows.copy(reflect_fast(y0 - R + i, h), i % BL_RING); };  // padded row i of the tile
    const int e = es + Q * lane;  // this lane's first output element
    float* const o_tile = out + f * plane + (size_t)y0 * row_len + e;
    const bool whole = vec_out && e + Q <= row_len;

    float ring[Q][K];  // W-blurred rows of the last K rows
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < K; ++j) ring[q][j] = 0.0f;

    __syncwarp();  // every lane's reads of the last tile's ring rows end before this tile's first copies
#pragma unroll
    for (int i = 0; i < BL_AHEAD; ++i) {
      if (i < rows_in) load(i);
      cp_async_commit();
    }
    for (int i0 = 0; i0 < rows_in; i0 += RUN) {
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        const int i = i0 + u;
        if (i >= rows_in) break;
        cp_async_wait<BL_AHEAD - 1>();  // this lane's copies of row i
        __syncwarp();                   // the warp's; and every read of the slot reused below is done
        if (i + BL_AHEAD < rows_in) load(i + BL_AHEAD);
        cp_async_commit();
        // staged elements Q lane .. Q lane + NV - 1: element e - PAD onward
        const float* const r = s_in + (i % BL_RING) * S::IW + Q * lane;
        float v[S::VEC ? S::NV : 1];
        if constexpr (S::VEC) {
#pragma unroll
          for (int g = 0; g < S::NV / 4; ++g) {
            const float4 t = reinterpret_cast<const float4*>(r)[g];
            v[4 * g] = t.x;
            v[4 * g + 1] = t.y;
            v[4 * g + 2] = t.z;
            v[4 * g + 3] = t.w;
          }
        }
        auto at = [&](int k) { return S::VEC ? v[S::VEC ? k : 0] : r[k]; };
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          constexpr int B = S::PAD - R * CH;  // tap 0 of element 0
          float acc = at(B + q) * taps.v[0];
#pragma unroll
          for (int j = 1; j < K; ++j) acc = acc + at(B + q + j * CH) * taps.v[j];
          if (RUN == K) {
            ring[q][u] = acc;
          } else {
#pragma unroll
            for (int j = 0; j < K - 1; ++j) ring[q][j] = ring[q][j + 1];
            ring[q][K - 1] = acc;
          }
        }
        if (i < K - 1) continue;
        // output row i - K + 1 of the tile: the W-blurred rows i - K + 1 .. i, oldest first
        auto oldest = [&](int j) { return RUN == K ? (u + 1 + j) % K : j; };  // the slot of the j-th oldest row
        float o[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float acc = ring[q][oldest(0)] * taps.v[0];
#pragma unroll
          for (int j = 1; j < K; ++j) acc = acc + ring[q][oldest(j)] * taps.v[j];
          o[q] = acc;
        }
        float* const dst = o_tile + (size_t)(i - K + 1) * row_len;
        if constexpr (Q == 4) {
          if (whole) {
            *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
            continue;
          }
        } else if constexpr (Q == 2) {
          if (whole) {
            *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
            continue;
          }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (e + q < row_len) dst[q] = o[q];
      }
    }
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

// grid for tiles warp tiles, a strip a warp, at most what is resident at once on sms multiprocessors
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, long long tiles, int warps, int sms, int& grid) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidValue;
  const long long blocks = (tiles + warps - 1) / warps;
  grid = (int)(blocks < (long long)per_sm * sms ? blocks : (long long)per_sm * sms);
  return cudaSuccess;
}

template <int K>
cudaError_t launch_canny(const float* in, uint8_t* out, int n, int h, int w, const Taps& taps, float low,
                         float high, int sms, cudaStream_t stream) {
  using S = CannyShape<K>;
  const int tiles_x = (w + S::OW - 1) / S::OW, tiles_y = (h + CS_TILE_H - 1) / CS_TILE_H;
  int grid = 0;
  cudaError_t err = persistent_grid(canny_strip_kernel<K>, CS_THREADS, S::SMEM, (long long)n * tiles_x * tiles_y,
                                    CS_WARPS, sms, grid);
  if (err != cudaSuccess) return err;
  const int vec_rows = w % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;  // every input row 16-byte aligned
  const int vec_out = w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;   // every output row 4-byte aligned
  canny_strip_kernel<K><<<grid, CS_THREADS, S::SMEM, stream>>>(in, out, n, h, w, tiles_x, tiles_y, vec_rows, vec_out,
                                                              taps, low, high);
  return cudaGetLastError();
}

template <int K, int CH>
cudaError_t launch_blur(const float* in, float* out, int n, int h, int w, const Taps& taps, int sms,
                        cudaStream_t stream) {
  using S = BlurShape<K, CH>;
  const int row_len = w * CH;
  const int tiles_x = (row_len + S::OW - 1) / S::OW, tiles_y = (h + BL_TILE_H - 1) / BL_TILE_H;
  int grid = 0;
  cudaError_t err = persistent_grid(blur_strip_kernel<K, CH>, BL_THREADS, S::SMEM, (long long)n * tiles_x * tiles_y,
                                    BL_WARPS, sms, grid);
  if (err != cudaSuccess) return err;
  const int vec_rows = row_len % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;   // every row 16-byte aligned
  const int vec_out = row_len % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  blur_strip_kernel<K, CH><<<grid, BL_THREADS, S::SMEM, stream>>>(in, out, n, h, w, tiles_x, tiles_y, vec_rows,
                                                                  vec_out, taps);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_blur_k(const float* in, float* out, int n, int h, int w, const Taps& taps, int ksize, int sms,
                          cudaStream_t stream) {
  switch (ksize) {
#define CVT_BLUR_K(K) \
  case K:             \
    return launch_blur<K, CH>(in, out, n, h, w, taps, sms, stream);
    CVT_BLUR_K(1) CVT_BLUR_K(2) CVT_BLUR_K(3) CVT_BLUR_K(4) CVT_BLUR_K(5) CVT_BLUR_K(6) CVT_BLUR_K(7) CVT_BLUR_K(8)
    CVT_BLUR_K(9) CVT_BLUR_K(10) CVT_BLUR_K(11) CVT_BLUR_K(12) CVT_BLUR_K(13) CVT_BLUR_K(14) CVT_BLUR_K(15)
    CVT_BLUR_K(16) CVT_BLUR_K(17) CVT_BLUR_K(18) CVT_BLUR_K(19) CVT_BLUR_K(20) CVT_BLUR_K(21) CVT_BLUR_K(22)
    CVT_BLUR_K(23) CVT_BLUR_K(24) CVT_BLUR_K(25) CVT_BLUR_K(26) CVT_BLUR_K(27) CVT_BLUR_K(28) CVT_BLUR_K(29)
    CVT_BLUR_K(30) CVT_BLUR_K(31)
#undef CVT_BLUR_K
    default:
      return cudaErrorInvalidValue;
  }
}

template <int K>
cudaError_t launch_blur_sobel(const float* in, float* out, int n, int h, int w, const Taps& taps, int sms,
                              cudaStream_t stream) {
  using S = BlurSobelShape<K>;
  const int tiles_x = (w + S::OW - 1) / S::OW;
  // strips BS_TILE_H rows deep, halved while there are fewer than the warps the card holds at once
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)blur_sobel_strip_kernel<K>,
                                                                  CS_THREADS, S::SMEM);
  if (err != cudaSuccess) return err;
  int tile_h = BS_TILE_H;
  while (tile_h > BS_LOW_TILE_H &&
         (long long)n * tiles_x * ((h + tile_h - 1) / tile_h) < (long long)per_sm * sms * CS_WARPS)
    tile_h /= 2;
  const int tiles_y = (h + tile_h - 1) / tile_h;
  int grid = 0;
  err = persistent_grid(blur_sobel_strip_kernel<K>, CS_THREADS, S::SMEM, (long long)n * tiles_x * tiles_y, CS_WARPS,
                        sms, grid);
  if (err != cudaSuccess) return err;
  const int vec_rows = w % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;  // every input row 16-byte aligned
  const int vec_out = w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;  // every output row too
  blur_sobel_strip_kernel<K><<<grid, CS_THREADS, S::SMEM, stream>>>(in, out, n, h, w, tiles_x, tiles_y, tile_h,
                                                                   vec_rows, vec_out, taps);
  return cudaGetLastError();
}

template <int SW>
cudaError_t launch_hysteresis(const uint8_t* in, uint8_t* out, int n, int h, int w, int* changed, int* last_changed,
                              int sms, cudaStream_t stream) {
  const int tiles_x = (w + HY_OW - 1) / HY_OW, tiles_y = (h + HY_TILE_H - 1) / HY_TILE_H;
  int grid = 0;
  cudaError_t err = persistent_grid(hysteresis_bits_kernel<SW>, HY_THREADS, HY_SMEM,
                                    (long long)n * tiles_x * tiles_y, HY_WARPS, sms, grid);
  if (err != cudaSuccess) return err;
  // rows of whole 16-byte chunks, 16-byte aligned, and wide enough that the 16 columns past an edge mirror real ones
  const int vec = w % 16 == 0 && w >= 32 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  hysteresis_bits_kernel<SW><<<grid, HY_THREADS, HY_SMEM, stream>>>(in, out, n, h, w, tiles_x, tiles_y, vec, changed,
                                                                   last_changed);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_harris(const float* in, float* out, int n, int h, int w, const Taps& taps, float k, int sms,
                          cudaStream_t stream) {
  using S = HarrisShape<K>;
  const int tiles_x = (w + S::OW - 1) / S::OW, tiles_y = (h + HR_TILE_H - 1) / HR_TILE_H;
  int grid = 0;
  cudaError_t err = persistent_grid(harris_kernel<K>, HR_THREADS, S::SMEM, (long long)n * tiles_x * tiles_y, HR_WARPS,
                                    sms, grid);
  if (err != cudaSuccess) return err;
  const int vec_rows = w % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;  // every row 16-byte aligned
  harris_kernel<K><<<grid, HR_THREADS, S::SMEM, stream>>>(in, out, n, h, w, tiles_x, tiles_y, vec_rows, taps, k);
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns the first failed
// launch's cudaError_t (0 on success); it never synchronises.  Any number of
// frames: past 65,535 (cvt::MAX_GRID_YZ) the tile kernel of Canny's in-tile
// option launches once for each 65,535 frames; the strip kernels walk theirs
// on a persistent grid.
extern "C" {

// sms (here and below): the card's multiprocessors, which size the persistent grids
int cvt_canny_stage1(const float* in, uint8_t* out, int n, int h, int w, const float* taps, int ksize, float low,
                     float high, int in_tile, int sms, void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const Taps t = make_taps(taps, ksize);
  cudaStream_t st = (cudaStream_t)stream;
  if (in_tile) {
    const size_t smem = sizeof(float) * CannyDims(ksize).floats();
    cudaError_t err = prepare(canny_in_tile_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const size_t plane = (size_t)h * w;
    return (int)over_frames(n, [&](int f0, int frames) {
      canny_in_tile_kernel<<<grid_for(frames, h, w, TILE_H, TILE_W), THREADS, smem, st>>>(
          in + f0 * plane, out + f0 * plane, h, w, t, ksize, low, high);
    });
  }
  switch (ksize) {
#define CVT_CANNY_K(K) \
  case K:              \
    return (int)launch_canny<K>(in, out, n, h, w, t, low, high, sms, st);
    CVT_CANNY_K(1) CVT_CANNY_K(2) CVT_CANNY_K(3) CVT_CANNY_K(4) CVT_CANNY_K(5) CVT_CANNY_K(6) CVT_CANNY_K(7)
    CVT_CANNY_K(8) CVT_CANNY_K(9) CVT_CANNY_K(10) CVT_CANNY_K(11) CVT_CANNY_K(12) CVT_CANNY_K(13) CVT_CANNY_K(14)
    CVT_CANNY_K(15) CVT_CANNY_K(16) CVT_CANNY_K(17) CVT_CANNY_K(18) CVT_CANNY_K(19) CVT_CANNY_K(20) CVT_CANNY_K(21)
    CVT_CANNY_K(22) CVT_CANNY_K(23) CVT_CANNY_K(24) CVT_CANNY_K(25) CVT_CANNY_K(26) CVT_CANNY_K(27) CVT_CANNY_K(28)
    CVT_CANNY_K(29) CVT_CANNY_K(30) CVT_CANNY_K(31)
#undef CVT_CANNY_K
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// in, out (n, h, w, channels) f32, contiguous; channels 1, 3 or 4 (other counts: (n channels, h, w) maps at 1)
int cvt_gaussian_blur(const float* in, float* out, int n, int h, int w, int channels, const float* taps, int ksize,
                      int sms, void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const Taps t = make_taps(taps, ksize);
  cudaStream_t st = (cudaStream_t)stream;
  switch (channels) {
    case 1:
      return (int)launch_blur_k<1>(in, out, n, h, w, t, ksize, sms, st);
    case 3:
      return (int)launch_blur_k<3>(in, out, n, h, w, t, ksize, sms, st);
    case 4:
      return (int)launch_blur_k<4>(in, out, n, h, w, t, ksize, sms, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// changed: set to 1 where a pixel changed; last_changed: where the last sweep changed a pixel (either may be null)
int cvt_hysteresis_sweeps(const uint8_t* in, uint8_t* out, int n, int h, int w, int sweeps, int* changed,
                          int* last_changed, int sms, void* stream) {
  if (bad_shape(n, h, w)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (sweeps) {
#define CVT_HYST_S(S) \
  case S:             \
    return (int)launch_hysteresis<S>(in, out, n, h, w, changed, last_changed, sms, st);
    CVT_HYST_S(1) CVT_HYST_S(2) CVT_HYST_S(3) CVT_HYST_S(4) CVT_HYST_S(5) CVT_HYST_S(6) CVT_HYST_S(7) CVT_HYST_S(8)
    CVT_HYST_S(9) CVT_HYST_S(10) CVT_HYST_S(11) CVT_HYST_S(12) CVT_HYST_S(13) CVT_HYST_S(14) CVT_HYST_S(15)
    CVT_HYST_S(16)
#undef CVT_HYST_S
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int cvt_blur_sobel(const float* in, float* out, int n, int h, int w, const float* taps, int ksize, int sms,
                   void* stream) {
  if (bad_shape(n, h, w) || ksize < 1 || ksize > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const Taps t = make_taps(taps, ksize);
  cudaStream_t st = (cudaStream_t)stream;
  switch (ksize) {
#define CVT_BLUR_SOBEL_K(K) \
  case K:                   \
    return (int)launch_blur_sobel<K>(in, out, n, h, w, t, sms, st);
    CVT_BLUR_SOBEL_K(1) CVT_BLUR_SOBEL_K(2) CVT_BLUR_SOBEL_K(3) CVT_BLUR_SOBEL_K(4) CVT_BLUR_SOBEL_K(5)
    CVT_BLUR_SOBEL_K(6) CVT_BLUR_SOBEL_K(7) CVT_BLUR_SOBEL_K(8) CVT_BLUR_SOBEL_K(9) CVT_BLUR_SOBEL_K(10)
    CVT_BLUR_SOBEL_K(11) CVT_BLUR_SOBEL_K(12) CVT_BLUR_SOBEL_K(13) CVT_BLUR_SOBEL_K(14) CVT_BLUR_SOBEL_K(15)
    CVT_BLUR_SOBEL_K(16) CVT_BLUR_SOBEL_K(17) CVT_BLUR_SOBEL_K(18) CVT_BLUR_SOBEL_K(19) CVT_BLUR_SOBEL_K(20)
    CVT_BLUR_SOBEL_K(21) CVT_BLUR_SOBEL_K(22) CVT_BLUR_SOBEL_K(23) CVT_BLUR_SOBEL_K(24) CVT_BLUR_SOBEL_K(25)
    CVT_BLUR_SOBEL_K(26) CVT_BLUR_SOBEL_K(27) CVT_BLUR_SOBEL_K(28) CVT_BLUR_SOBEL_K(29) CVT_BLUR_SOBEL_K(30)
    CVT_BLUR_SOBEL_K(31)
#undef CVT_BLUR_SOBEL_K
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
