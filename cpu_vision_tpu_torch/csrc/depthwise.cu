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
// or bf16); the bias is f32.  Every operand is widened to f32, each tap is
// one f32 fused multiply-add into a sum that starts at 0, in (i, j) order as
// in the TPU kernel, the bias is added last and the sum is rounded to T once.
//
// Bound.  Each input and output element crosses device memory once: at
// ConvNeXt-T's first stage (256 x 56 x 56 x 96, K 7) 308 MB in bf16, 0.092 ms
// at 3.35 TB/s, which bounds the function (its 7.55 GFLOP, 2 K^2 an output,
// take 0.008 ms at the bf16 tensor-core rate).  This kernel does them as f32
// FMAs on the CUDA cores in either type, so its own floor is the FMA pipe's:
// 0.113 ms at 67 TFLOP/s.
//
// Design.  A thread computes a 7 x 7 patch of outputs of one channel (lane =
// channel, a warp 32 channels) from the staged window, holding its K * K taps
// and the 49 sums in registers: it walks the patch's (6 + K)^2 window values
// row by row, each read from shared memory and widened once and used in
// every sum it feeds, at most K^2 of them (at K 7: 169 reads for 2401 FMAs,
// 0.07 a FMA).  The maps of ConvNeXt (56, 28, 14, 7) are multiples of 7, so
// the patches fit them without waste.
//   A tile is B x CT patches of one image and G groups of 32 channels, one
// warp a (patch, group); B, CT and G are picked per shape on the host
// (dw_tile: the least computed and staged work, whole maps at 14^2 and 7^2,
// several channel groups where a map is small), within DW_STAGE_MAX bytes of
// window a stage.  Its window, (7 B + K - 1) x (7 CT + K - 1) pixels of 32 G
// channels with zeros where it leaves the image, lies in shared memory as
// [group][row][col][32 channels]: a warp's read of one pixel is 32
// consecutive values, no bank conflict.  It is copied with cp.async, 16 bytes
// (8 bf16 or 4 f32 channels) a copy, its zero fill (src-size 0) giving the
// padding with no branch per element; where C is not a multiple of 8 (4) or
// the input is not 16-byte aligned, by plain loads instead.
//   The grid is persistent: at most as many blocks as fit the card, each
// walking tiles blockIdx.x, + gridDim.x, ... (channel groups fastest, then
// column tiles, band tiles, images), with a ring of two stages: the next
// tile's window is copied while this one's FMAs run.  No atomics: every call
// gives the same bits.

#include "attention.cuh"
#include "hopper.cuh"

namespace {

using cvt::from_f32;
using cvt::to_f32;

constexpr int DW_P = 7;            // a thread's patch: DW_P x DW_P outputs of one channel
constexpr int DW_CH = 32;          // channels of a group, one a lane
constexpr int DW_MAX_WARPS = 8;    // warps a block: one a (patch, channel group) of the tile
constexpr int DW_STAGE_MAX = 56 * 1024;  // bytes of window a stage: two stages of two blocks fit an SM's 228 KB

// a tile: b x ct patches of one image, g groups of DW_CH channels
struct DwGeom {
  int h, w, c;
  int b, ct, g;
  int wr, wc;                              // window rows and columns
  int band_tiles, col_tiles, cg_tiles, tiles;
  int vec;                                 // copies of 16 bytes (else plain loads)
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The tile of an (h, w, c) map at taps k and elem bytes a value: the least cost of the computed patches (those past
// the map too) and of the staged window, over B x CT x G <= DW_MAX_WARPS within DW_STAGE_MAX; more warps a block on
// a tie.  Units are cycles of an SM: a patch's 49 K^2 FMAs a lane at 128 a cycle, a window's bytes at 64 a cycle.
DwGeom dw_tile(int h, int w, int c, int k, int elem) {
  const int bandp = ceil_div(h, DW_P), colp = ceil_div(w, DW_P), cgs = ceil_div(c, DW_CH);
  DwGeom best{};
  double best_cost = 0.0;
  for (int b = 1; b <= bandp && b <= DW_MAX_WARPS; ++b)
    for (int ct = 1; ct <= colp && b * ct <= DW_MAX_WARPS; ++ct)
      for (int g = 1; g <= cgs && b * ct * g <= DW_MAX_WARPS; g *= 2) {
        const int wr = DW_P * b + k - 1, wc = DW_P * ct + k - 1;
        const double bytes = (double)g * wr * wc * DW_CH * elem;
        if (bytes > DW_STAGE_MAX) continue;
        const int nb = ceil_div(bandp, b), nc = ceil_div(colp, ct), ng = ceil_div(cgs, g);
        const double tiles = (double)nb * nc * ng;
        const double cost = (tiles * b * ct * g * DW_P * DW_P * k * k * DW_CH / 128.0 + tiles * bytes / 64.0) *
                            (1.0 + 0.02 * (DW_MAX_WARPS - b * ct * g));
        if (best.b == 0 || cost < best_cost) {
          best_cost = cost;
          best = DwGeom{h, w, c, b, ct, g, wr, wc, nb, nc, ng, 0, 0};
        }
      }
  return best;  // b 0: no tile fits (a single window past DW_STAGE_MAX)
}

// acc[y][p] = sum over (i, j), in that order, of win[(y + i) row][(p + j) col] * wt[i K + j], as f32 FMAs from 0;
// win points at this lane's value of the patch's first window pixel, row_elems values from one window row to the next
template <typename T, int K>
__device__ __forceinline__ void dw_patch(const T* win, int row_elems, const float (&wt)[K * K],
                                         float (&acc)[DW_P][DW_P]) {
#pragma unroll
  for (int y = 0; y < DW_P; ++y)
#pragma unroll
    for (int p = 0; p < DW_P; ++p) acc[y][p] = 0.0f;
  // window row r feeds output row y through tap row i = r - y; column q output column p through tap column j = q - p:
  // rows in order and, within a row, columns in order, so each sum takes its taps in (i, j) order
#pragma unroll
  for (int r = 0; r < DW_P + K - 1; ++r) {
    const T* row = win + r * row_elems;
#pragma unroll
    for (int q = 0; q < DW_P + K - 1; ++q) {
      const float v = to_f32<T>(row[q * DW_CH]);
#pragma unroll
      for (int y = 0; y < DW_P; ++y) {
        if (r - y < 0 || r - y >= K) continue;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (q - j < 0 || q - j >= DW_P) continue;
          acc[y][q - j] = fmaf(v, wt[(r - y) * K + j], acc[y][q - j]);
        }
      }
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(DW_MAX_WARPS * 32, 2)
depthwise_kernel(const T* __restrict__ in, const T* __restrict__ taps, const float* __restrict__ bias,
                 T* __restrict__ out, DwGeom gm) {
  constexpr int PAD = K / 2, EPC = 16 / (int)sizeof(T), CPP = DW_CH / EPC;  // values a copy, copies a group's pixel
  extern __shared__ __align__(16) float smem[];
  T* const win0 = reinterpret_cast<T*>(smem);
  const uint32_t win0_s = cvt::smem_addr(smem);
  const int npix = gm.wr * gm.wc, stage = gm.g * npix * DW_CH;  // values a stage

  auto origin = [&](int t, int& img, int& y0, int& x0, int& ch0) {
    ch0 = t % gm.cg_tiles * gm.g * DW_CH;
    t /= gm.cg_tiles;
    x0 = t % gm.col_tiles * gm.ct * DW_P;
    t /= gm.col_tiles;
    y0 = t % gm.band_tiles * gm.b * DW_P;
    img = t / gm.band_tiles;
  };
  // the window of tile t into stage s: this thread's 16-byte chunk cc of group cg at pixels pix0, pix0 + step, ...
  // (taken anew each time: no register holds them through the FMAs)
  auto copy = [&](int t, int s) {
    const int tid = threadIdx.x;
    const int cc = tid % CPP, cg = tid / CPP % gm.g, pix0 = tid / CPP / gm.g;
    const int step = blockDim.x / CPP / gm.g, step_r = step / gm.wc, step_c = step % gm.wc;
    int img, y0, x0, ch0;
    origin(t, img, y0, x0, ch0);
    const T* src = in + (size_t)img * gm.h * gm.w * gm.c;
    const int ch = ch0 + cg * DW_CH + cc * EPC;
    const int at = s * stage + cg * npix * DW_CH + cc * EPC;  // value of pixel 0 in this thread's chunk
    int r = pix0 / gm.wc, q = pix0 % gm.wc;
    for (int pix = pix0; pix < npix; pix += step) {
      const int y = y0 + r - PAD, x = x0 + q - PAD;
      const bool inside = y >= 0 && y < gm.h && x >= 0 && x < gm.w;
      const size_t from = ((size_t)y * gm.w + x) * gm.c + ch;
      if (gm.vec) {  // c a multiple of EPC: a chunk lies in the channels or past them
        const bool ok = inside && ch < gm.c;
        cvt::cp_async16(win0_s + (uint32_t)(at + pix * DW_CH) * (uint32_t)sizeof(T), src + (ok ? from : 0), ok);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          win0[at + pix * DW_CH + e] = inside && ch + e < gm.c ? src[from + e] : from_f32<T>(0.0f);
      }
      r += step_r;
      q += step_c;
      if (q >= gm.wc) {
        q -= gm.wc;
        ++r;
      }
    }
  };

  // compute: this warp's patch (pb, pc) of the tile in channel group pg; its taps held through the tiles of one
  // channel group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pg = warp % gm.g, pb = warp / gm.g / gm.ct, pc = warp / gm.g % gm.ct;
  float wt[K * K];
  int taps_of = -1;  // the channel of the taps held

  int s = 0;
  if ((int)blockIdx.x < gm.tiles) copy(blockIdx.x, 0);
  cvt::cp_async_commit();
  for (int t = blockIdx.x; t < gm.tiles; t += gridDim.x, s ^= 1) {
    if (t + (int)gridDim.x < gm.tiles) copy(t + gridDim.x, s ^ 1);  // the stage the step before finished with
    cvt::cp_async_commit();
    cvt::cp_async_wait<1>();  // this tile's copies, in this thread
    __syncthreads();          // and in every thread
    const int ch = t % gm.cg_tiles * gm.g * DW_CH + pg * DW_CH + lane;
    if (ch != taps_of) {
#pragma unroll
      for (int i = 0; i < K * K; ++i) wt[i] = ch < gm.c ? to_f32<T>(taps[(size_t)i * gm.c + ch]) : 0.0f;
      taps_of = ch;
    }
    float acc[DW_P][DW_P];
    dw_patch<T, K>(win0 + s * stage + ((pg * gm.wr + DW_P * pb) * gm.wc + DW_P * pc) * DW_CH + lane, gm.wc * DW_CH,
                   wt, acc);
    int img, y0, x0, ch0;
    origin(t, img, y0, x0, ch0);
    const bool c_in = ch < gm.c;
    const float bv = c_in && bias != nullptr ? bias[ch] : 0.0f;
    const int gy = y0 + DW_P * pb, gx = x0 + DW_P * pc;
    T* o = out + (((size_t)img * gm.h + gy) * gm.w + gx) * gm.c + ch;
#pragma unroll
    for (int y = 0; y < DW_P; ++y)
#pragma unroll
      for (int p = 0; p < DW_P; ++p)
        if (c_in && gy + y < gm.h && gx + p < gm.w) o[((size_t)y * gm.w + p) * gm.c] = from_f32<T>(acc[y][p] + bv);
    __syncthreads();  // every warp is done with stage s before the next step copies into it
  }
}

// The launch of one call: its tile, block size, shared memory and grid; with info, also the kernel's registers a
// thread and blocks an SM, into info[0..9] = b, ct, g, threads, shared bytes a block, blocks an SM, registers,
// grid, tiles, vec (no launch then).
template <typename T, int K>
cudaError_t launch_depthwise(const T* in, const T* taps, const float* bias, T* out, int n, int h, int w, int c,
                             int sms, int* info, cudaStream_t stream) {
  DwGeom gm = dw_tile(h, w, c, K, (int)sizeof(T));
  if (gm.b == 0) return cudaErrorInvalidValue;
  const long long tiles = (long long)n * gm.band_tiles * gm.col_tiles * gm.cg_tiles;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  gm.tiles = (int)tiles;
  gm.vec = c % (16 / (int)sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const int threads = gm.b * gm.ct * gm.g * 32;
  const size_t smem = 2 * (size_t)gm.g * gm.wr * gm.wc * DW_CH * sizeof(T);
  int per_sm = 0;
  cudaError_t err = cvt::blocks_per_sm((const void*)depthwise_kernel<T, K>, threads, smem, 2 * DW_STAGE_MAX, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms);
  if (info != nullptr) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, (const void*)depthwise_kernel<T, K>);
    if (err != cudaSuccess) return err;
    const int got[10] = {gm.b, gm.ct, gm.g, threads, (int)smem, per_sm, attr.numRegs, grid, gm.tiles, gm.vec};
    for (int i = 0; i < 10; ++i) info[i] = got[i];
    return cudaSuccess;
  }
  depthwise_kernel<T, K><<<grid, threads, smem, stream>>>(in, taps, bias, out, gm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t depthwise(const T* in, const T* taps, const float* bias, T* out, int n, int h, int w, int c, int k,
                      int sms, int* info, cudaStream_t stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1) return cudaErrorInvalidValue;
  switch (k) {
    case 3:
      return launch_depthwise<T, 3>(in, taps, bias, out, n, h, w, c, sms, info, stream);
    case 5:
      return launch_depthwise<T, 5>(in, taps, bias, out, n, h, w, c, sms, info, stream);
    case 7:
      return launch_depthwise<T, 7>(in, taps, bias, out, n, h, w, c, sms, info, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in and out are (n, h, w, c), taps (k, k, c), bias (c) of f32 or null; sms
// the card's multiprocessors (the persistent grid's size).  Launches on
// `stream` and returns the launch's cudaError_t (0 on success); does not
// synchronise.
int cvt_depthwise_conv2d(const void* in, const void* taps, const float* bias, void* out, int n, int h, int w,
                         int c, int k, int is_bf16, int sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)depthwise<__nv_bfloat16>((const __nv_bfloat16*)in, (const __nv_bfloat16*)taps, bias,
                                         (__nv_bfloat16*)out, n, h, w, c, k, sms, nullptr, st);
  return (int)depthwise<float>((const float*)in, (const float*)taps, bias, (float*)out, n, h, w, c, k, sms, nullptr,
                               st);
}

// What cvt_depthwise_conv2d would launch for these arguments (in's address
// decides the copies), into info[0..9]: the tile's patch rows, patch columns
// and channel groups, threads a block, shared bytes a block, blocks an SM,
// registers a thread, grid, tiles, 16-byte copies (1) or plain loads (0).
// Launches nothing.
int cvt_depthwise_info(const void* in, int n, int h, int w, int c, int k, int is_bf16, int sms, int* info) {
  if (is_bf16)
    return (int)depthwise<__nv_bfloat16>((const __nv_bfloat16*)in, nullptr, nullptr, nullptr, n, h, w, c, k, sms,
                                         info, nullptr);
  return (int)depthwise<float>((const float*)in, nullptr, nullptr, nullptr, n, h, w, c, k, sms, info, nullptr);
}

}  // extern "C"
