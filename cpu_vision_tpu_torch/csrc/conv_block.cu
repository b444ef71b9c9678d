// Fused conv3x3(SAME) + bias + ReLU + maxpool2x2 for Hopper (sm_90a), bound
// with ctypes: an implicit GEMM on the tensor cores by split TF32.
//
// Replaces the Pallas TPU kernel fused_conv3x3_relu_pool of
// cpu_vision_tpu/ops/pallas/conv_block.py:36 (pallas_call at :88), which
// accumulates nine per-tap (TH*W, Cin) x (Cin, Cout) products over a row band.
//
// Layouts.  x (N, H, W, Cin) NHWC f32, w (3, 3, Cin, Cout) HWIO f32 read as a
// (9 Cin, ldw) matrix (ldw >= Cout, a multiple of 4: the wrapper pads Cout),
// b (Cout,) f32, out (N, H/2, W/2, Cout) f32; H and W even; any N, Cin, Cout.
//
// The product.  M is the conv pixels, N is Cout, K is 9 Cin: out = pool(relu(A
// W + b)) with A the im2col of x, never built.  It runs on wgmma by split TF32
// (tf32x3.cuh's split: a = a_hi + a_lo, each half rounded to tf32 by cvt.rna),
// four tf32 products a product, the sums promoted into registers every stage
// of 32 k (every 8 k with 32 columns), so that it keeps float32 accuracy.  The
// tensor cores round the sums they chain toward zero, relative to the chain's
// magnitude: so the three products with a lo half (lo lo, lo hi, hi lo, 2^-11
// of hi hi and less) sum in a chain of their own, apart from hi hi's, and each
// chain is added into the registers' round-to-nearest sum.  On an H100
// (tools/torch_conv_harris_ab.py, PERF.md) at the CNN's 14x14 and 112x112
// 32 -> 64 stages: one chain of three products, 1.7-2.1x the twin's float64
// distance (TF32 off); rounding the lo halves too, the same; four products in
// one chain, 1.7-2.1x; four in two chains, 1.3-1.5x (1.13x the time of one
// chain); three in two chains, 1.55-1.8x.
//   * A.  A block stages its input window (the conv tile and its one-pixel
//     ring, zero outside the image: SAME padding) in shared memory by 4-byte
//     cp.async (zero fill), as [pixel][channel] at a channel stride cs = 2
//     mod 4, and each thread gathers its tf32 A fragments from it in
//     registers (im2col on the fly) through a table of the window offsets of
//     each k; the fragment loads of a warp hit 32 distinct banks.  At most
//     CHUNK channels are staged at a time: with Cin <= 32 all of them (K = 9
//     Cin zero-padded to whole stages, k = (dy, dx, ci) as the weights lie;
//     Cin 3 is one stage), with more the window is reloaded for each chunk of
//     32 and a stage is one tap of a chunk (k = ci).  Shared memory does not
//     grow with Cin.
//   * B.  The weights' rows of a stage (32 k x BN columns) stream through a
//     ring of raw slots (cp.async) and are split into K-major hi / lo tiles in
//     the 128-byte swizzle (tf32x3.cuh X3RawB), as the split-TF32 products do.
//   * Pixels to rows.  A block owns PT_H x PT_W = 4 x 8 pooled pixels of one
//     image (8 x 16 conv pixels) and BN = 32 or 64 output channels.  Its two
//     warpgroups own one m64 tile each: warpgroup g the conv rows 2 qy + g.  A
//     thread's accumulator rows r and r + 8 (hopper.cuh) are the conv pixels
//     2 qx and 2 qx + 1 of pooled pixel (qy, qx) = (warp, lane / 4).
//   * A stage's four k8 steps run on two fragments' registers, two steps'
//     products in flight, so that a block holds 128 registers a thread or
//     fewer and two blocks share an SM.
//   * Epilogue.  Bias, ReLU and the horizontal max in registers; the vertical
//     max through shared memory (the other warpgroup's half); the pooled tile
//     stored 16 bytes a thread.  Conv activations never reach device memory.
//
// Bound.  Cin 3 -> 32 at 224x224 b256 does 22 GFLOP on 0.56 GB and is bound by
// bytes; Cin 32 -> 64 at 112x112 does 118 GFLOP on 0.62 GB and is bound by
// operations, taken as for the split-TF32 products: 165 TFLOP/s of
// float32-accurate products, three tf32 products a product at 495 (2.5x the 67
// TFLOP/s of the FMA units; this kernel does four).  On an H100 the 32 -> 64
// stage runs at about a quarter of that rate and the 3 -> 32 stage at 9x its
// bytes bound: N is Cout, 64 or 32, and the products are m64n64k8 and
// m64n32k8.  Tried and slower there: persistent blocks, one an SM, every stage
// of B split once and kept in shared memory, the next tile's window read
// during a tile; the four k8 steps' fragments all live; one chain for each k8
// step at 64 columns.  With 64 columns a thread holds 128 registers and
// spills 204 bytes (two blocks an SM); one block an SM spills none and ran
// 1.16x slower.
// No atomics: every call gives the same bits.

#include <limits.h>

#include "tf32x3.cuh"

namespace {

using namespace cvt;

constexpr int PT_H = 4, PT_W = 8;                  // pooled pixels of a tile: a warp a row, a lane quad a column
constexpr int CT_H = 2 * PT_H, CT_W = 2 * PT_W;    // its conv pixels
constexpr int WIN_H = CT_H + 2, WIN_W = CT_W + 2;  // its input window
constexpr int CHUNK = 32;                          // input channels a window holds
constexpr int MAX_CS = 34;                         // the channel stride of a chunk of 32
constexpr int MAX_KT = 9 * CHUNK;                  // k of a chunk's stages
constexpr int THREADS = 256;                       // two warpgroups

template <int BN>
struct ConvShape {
  static constexpr int NACC = BN / 2;  // a thread's sums of its warpgroup's 64 x BN tile
  // With 32 columns (Cin 1 and 3 on the main path: K 9 and 27, one stage) each k8 step's products are chains
  // of their own, or the stage stood well past twice the twin's float64 distance (an H100); with 64 columns
  // (K 288) a stage's products are two chains (see the stage loop)
  static constexpr bool STEP_CHAINS = BN == 32;
  static constexpr int B_BYTES = BN * 128;  // a stage of B: 32 k x BN f32
  static constexpr int SPLIT_BYTES = 2 * B_BYTES;
  static constexpr int WIN_FLOATS = WIN_H * WIN_W * MAX_CS;
  static constexpr int OUT_LD = BN + 4;  // row stride of the epilogue's staged halves
  static constexpr size_t SMEM = 2 * (size_t)SPLIT_BYTES + (size_t)X3_RAW * B_BYTES + 4 * (size_t)WIN_FLOATS +
                                 4 * (size_t)MAX_KT + 1024;  // + room to align
  static_assert(2 * 32 * OUT_LD * 4 <= 2 * SPLIT_BYTES, "the epilogue's halves fit the split stages");
};

// the window's channel stride for cc staged channels: more than cc (the slots past cc are zero, and a k past K
// reads one) and 2 mod 4, so that the eight pixels 2 cs apart of a fragment load fall on distinct groups of banks
__device__ __forceinline__ int chan_stride(int cc) {
  const int cs = cc + 1;
  return cs + (6 - cs % 4) % 4;
}

using Frag = uint32_t[1][4];  // a k8 step's tf32 A fragment (hopper.cuh), as keep_fragments takes it

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_x3_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ out, int h, int wd, int cin, int cout, int ldw, int tiles_x, int tiles_y,
                  int col_tiles) {
  using S = ConvShape<BN>;
  using RawB = X3RawB<BN, THREADS>;
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  char* const tiles = reinterpret_cast<char*>(smem) + (base - smem_addr(smem));
  // shared memory: two split stages of B (hi, lo; the epilogue's halves after the last stage), X3_RAW raw slots of
  // B, the window, the k table
  const uint32_t raw0 = base + 2 * S::SPLIT_BYTES;
  const char* const raw_tiles = tiles + 2 * S::SPLIT_BYTES;
  float* const win = reinterpret_cast<float*>(tiles + 2 * S::SPLIT_BYTES + X3_RAW * S::B_BYTES);
  int* const tab = reinterpret_cast<int*>(win + S::WIN_FLOATS);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;

  int t = blockIdx.x;
  const int ct = t % col_tiles;
  t /= col_tiles;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y, img = t / tiles_y;
  const int n0 = ct * BN, cy0 = ty * CT_H, cx0 = tx * CT_W;

  const bool chunked = cin > CHUNK;
  const int chunks = chunked ? (cin + CHUNK - 1) / CHUNK : 1;
  const int spc = chunked ? 9 : (9 * cin + X3_BK - 1) / X3_BK;  // stages a chunk
  const int stages = chunks * spc;

  // B rows of stage s: with Cin <= 32, 32 of the 9 Cin rows of w; with more, one tap's rows of a chunk
  auto copy = [&](int s) {
    const int c = s / spc, ls = s - c * spc;
    const int row0 = chunked ? ls * cin + c * CHUNK : ls * X3_BK;
    const int rows = chunked ? min(CHUNK, cin - c * CHUNK) : min(X3_BK, 9 * cin - row0);
    RawB::copy(raw0 + s % X3_RAW * S::B_BYTES, w, ldw, n0, cout, row0, row0 + rows);
  };
  auto put = [&](int s) {  // B's raw chunks of this thread, split, into the split stage (s & 1)
    char* st = tiles + (s & 1) * S::SPLIT_BYTES;
    RawB::template split<true>(raw_tiles + s % X3_RAW * S::B_BYTES, st, st + S::B_BYTES);
  };

  // the window of chunk c, [pixel][channel] at stride cs, by 4-byte cp.async (zero outside the image and past
  // cc; the caller commits and waits), and the window offset of each k of its stages (plain stores)
  int cs = 0;
  auto stage_window = [&](int c) {
    const int c0 = c * CHUNK, cc = chunked ? min(CHUNK, cin - c0) : cin;
    cs = chan_stride(cc);
    const uint32_t w0 = smem_addr(win);
    for (int i = tid; i < WIN_H * WIN_W * cs; i += THREADS) {
      const int p = i / cs, ci = i - p * cs, r = p / WIN_W, col = p - r * WIN_W;
      const int y = cy0 - 1 + r, xx = cx0 - 1 + col;
      const bool ok = ci < cc && y >= 0 && y < h && xx >= 0 && xx < wd;
      cp_async4(w0 + 4 * i, ok ? x + (((size_t)img * h + y) * wd + xx) * cin + c0 + ci : x, ok);
    }
    for (int k = tid; k < spc * X3_BK; k += THREADS) {
      int tap = -1, ci = 0;
      if (chunked) {
        tap = k / X3_BK;
        ci = k - tap * X3_BK;
        if (ci >= cc) tap = -1;
      } else if (k < 9 * cin) {
        tap = k / cin;
        ci = k - tap * cin;
      }
      tab[k] = tap < 0 ? cc : (tap / 3 * WIN_W + tap % 3) * cs + ci;  // past K: the pixel's own zero slot cc
    }
  };

  // this thread's A fragment of k8 step kk of stage s from the window, split in registers: accumulator rows r,
  // r + 8 are the window pixels pix, pix + 1; k 8 kk + lane % 4 and 4 more (hopper.cuh)
  const int pix = (2 * warp + wg) * WIN_W + 2 * (lane >> 2);
  auto gather = [&](int s, int kk, Frag& hi, Frag& lo) {
    const int* tk = tab + s % spc * X3_BK + 8 * kk + (lane & 3);
    const int o0 = pix * cs + tk[0], o1 = pix * cs + tk[4];
    const float v[4] = {win[o0], win[o0 + cs], win[o1], win[o1 + cs]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float fh, fl;
      split_tf32(v[r], fh, fl);
      hi[0][r] = __float_as_uint(fh);
      lo[0][r] = __float_as_uint(tf32_rna(fl));
    }
  };

  // the sums: chains of products in acc0-acc3 (the stage loop), each added into sum in registers when it retires
  float acc0[S::NACC], acc1[S::NACC], acc2[S::NACC], acc3[S::NACC], sum[S::NACC];
#pragma unroll
  for (int i = 0; i < S::NACC; ++i) sum[i] = 0.0f;
  // a k8 step's four products from fragment (hi, lo), the smallest first: the three with a lo half into small, hi
  // hi into big, each a new chain or (chain) the one it holds; one group
  auto products = [&](int s, int kk, Frag& hi, Frag& lo, float(&small)[S::NACC], float(&big)[S::NACC], bool chain) {
    const uint32_t b_hi = base + (s & 1) * S::SPLIT_BYTES + kk * 32, b_lo = b_hi + S::B_BYTES;
    wgmma_fence();  // after writing the fragments, before the products read them
    wgmma_tf32(small, lo[0], b_lo, chain);
    wgmma_tf32(small, lo[0], b_hi, 1);
    wgmma_tf32(small, hi[0], b_lo, 1);
    wgmma_tf32(big, hi[0], b_hi, chain);
    wgmma_commit();
  };
  auto retire = [&](float(&d)[S::NACC]) {
    fence_sums(d);
#pragma unroll
    for (int i = 0; i < S::NACC; ++i) sum[i] += d[i];
  };

  // one cp.async group a stage, empty past the last (tf32x3.cuh's pipeline); the window rides in stage 0's
  stage_window(0);
#pragma unroll
  for (int r = 0; r < X3_RAW - 1; ++r) {
    if (r < stages) copy(r);
    cp_async_commit();
  }
  cp_async_wait<X3_RAW - 2>();
  put(0);
  fence_proxy_async();
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int c = s / spc, ls = s - c * spc;
    if (ls == 0 && s > 0) {  // the next chunk: every read of the window ended before the barrier that closed step s - 1
      stage_window(c);
      cp_async_commit();
      cp_async_wait<0>();  // the window, and the copies of B in flight with it
      __syncthreads();
    }
    // the raw slot of stage s - 1, split before the barrier that closed the step before, takes stage s + X3_RAW - 1
    if (s + X3_RAW - 1 < stages) copy(s + X3_RAW - 1);
    cp_async_commit();
    // the four k8 steps on two fragments: a step's fragment is gathered once the products two steps before it,
    // which read the same registers, retired; two steps' products in flight.  The tensor cores round the sums they
    // chain toward zero, so the products with a lo half (2^-11 of the rest) sum in a chain of their own, apart from
    // hi hi's.  With 32 columns each k8 step's chains are their own too (acc0/acc1 and acc2/acc3 by parity,
    // retired into sum two steps on); with 64 columns a stage's chains are acc0 and acc1
    if constexpr (S::STEP_CHAINS) {
      Frag a_hi, a_lo, b_hi, b_lo;
      gather(s, 0, a_hi, a_lo);
      products(s, 0, a_hi, a_lo, acc0, acc1, false);
      gather(s, 1, b_hi, b_lo);
      products(s, 1, b_hi, b_lo, acc2, acc3, false);
      wgmma_wait<1>();
      keep_fragments(a_hi, a_lo);
      retire(acc1);
      retire(acc0);
      gather(s, 2, a_hi, a_lo);
      products(s, 2, a_hi, a_lo, acc0, acc1, false);
      wgmma_wait<1>();
      keep_fragments(b_hi, b_lo);
      retire(acc3);
      retire(acc2);
      gather(s, 3, b_hi, b_lo);
      products(s, 3, b_hi, b_lo, acc2, acc3, false);
      if (s + 1 < stages) {  // the other split stage's products retired before the barrier that closed the step before
        cp_async_wait<X3_RAW - 2>();
        put(s + 1);
      }
      wgmma_wait<0>();
      keep_fragments(a_hi, a_lo);
      keep_fragments(b_hi, b_lo);
      retire(acc1);
      retire(acc0);
      retire(acc3);
      retire(acc2);
    } else {
      Frag a_hi, a_lo, b_hi, b_lo;
      gather(s, 0, a_hi, a_lo);
      products(s, 0, a_hi, a_lo, acc0, acc1, false);
      gather(s, 1, b_hi, b_lo);
      products(s, 1, b_hi, b_lo, acc0, acc1, true);
      wgmma_wait<1>();
      keep_fragments(a_hi, a_lo);
      gather(s, 2, a_hi, a_lo);
      products(s, 2, a_hi, a_lo, acc0, acc1, true);
      wgmma_wait<1>();
      keep_fragments(b_hi, b_lo);
      gather(s, 3, b_hi, b_lo);
      products(s, 3, b_hi, b_lo, acc0, acc1, true);
      if (s + 1 < stages) {  // the other split stage's products retired before the barrier that closed the step before
        cp_async_wait<X3_RAW - 2>();
        put(s + 1);
      }
      wgmma_wait<0>();
      keep_fragments(a_hi, a_lo);
      keep_fragments(b_hi, b_lo);
      retire(acc1);
      retire(acc0);
    }
    fence_proxy_async();
    __syncthreads();
  }

  // epilogue: sum[4 j + 2 h + e] is conv pixel (2 warp + wg, 2 (lane / 4) + h) at channel 8 j + 2 (lane % 4) + e.
  // Bias, ReLU, the max of h 0 and 1; each warpgroup's half into the split stages (free: every product retired
  // before the loop's last barrier), then the max of the two halves, 16 bytes a thread.
  float* const half = reinterpret_cast<float*>(tiles);
  const int q = 8 * warp + (lane >> 2);  // pooled pixel (warp, lane / 4) of the tile
#pragma unroll
  for (int j = 0; j < S::NACC / 4; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float b0 = n0 + col < cout ? bias[n0 + col] : 0.0f, b1 = n0 + col + 1 < cout ? bias[n0 + col + 1] : 0.0f;
    float2 v;
    v.x = fmaxf(fmaxf(sum[4 * j] + b0, 0.0f), fmaxf(sum[4 * j + 2] + b0, 0.0f));
    v.y = fmaxf(fmaxf(sum[4 * j + 1] + b1, 0.0f), fmaxf(sum[4 * j + 3] + b1, 0.0f));
    *reinterpret_cast<float2*>(half + (wg * 32 + q) * S::OUT_LD + col) = v;
  }
  __syncthreads();
  const int ho = h / 2, wo = wd / 2;
  for (int i = tid; i < 32 * BN / 4; i += THREADS) {
    const int qq = i / (BN / 4), c4 = (i - qq * (BN / 4)) * 4;
    const int py = ty * PT_H + (qq >> 3), px = tx * PT_W + (qq & 7);
    if (py >= ho || px >= wo || n0 + c4 >= cout) continue;
    const float4 u = *reinterpret_cast<const float4*>(half + qq * S::OUT_LD + c4);
    const float4 d = *reinterpret_cast<const float4*>(half + (32 + qq) * S::OUT_LD + c4);
    const float4 v = make_float4(fmaxf(u.x, d.x), fmaxf(u.y, d.y), fmaxf(u.z, d.z), fmaxf(u.w, d.w));
    float* o = out + (((size_t)img * ho + py) * wo + px) * cout + n0 + c4;
    if (cout % 4 == 0) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && n0 + c4 + e < cout; ++e) o[e] = vs[e];
    }
  }
}

template <int BN>
cudaError_t launch_conv(const float* x, const float* w, const float* b, float* out, int n, int h, int wd, int cin,
                        int cout, int ldw, cudaStream_t stream) {
  using S = ConvShape<BN>;
  cudaError_t err =
      cudaFuncSetAttribute(conv3x3_x3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd / 2 + PT_W - 1) / PT_W, tiles_y = (h / 2 + PT_H - 1) / PT_H;
  const int col_tiles = (cout + BN - 1) / BN;
  const long long per_image = (long long)tiles_x * tiles_y * col_tiles;
  const int images = (int)(INT_MAX / per_image < n ? INT_MAX / per_image : n);  // images a launch: grid.x < 2^31
  for (int i0 = 0; i0 < n; i0 += images) {
    const int cnt = min(images, n - i0);
    conv3x3_x3_kernel<BN><<<(unsigned)(cnt * per_image), THREADS, S::SMEM, stream>>>(
        x + (size_t)i0 * h * wd * cin, w, b, out + (size_t)i0 * (h / 2) * (wd / 2) * cout, h, wd, cin, cout, ldw,
        tiles_x, tiles_y, col_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// w is (9 cin, ldw) with ldw >= cout a multiple of 4, 16-byte aligned.  Launches on `stream` and returns the first
// failed launch's cudaError_t (0 on success); never synchronises.
int cvt_conv3x3_relu_pool(const float* x, const float* w, const float* b, float* out, int n, int h, int wd, int cin,
                          int cout, int ldw, void* stream) {
  if (n < 1 || h < 2 || wd < 2 || h % 2 || wd % 2 || cin < 1 || cout < 1 || ldw < cout || ldw % 4 ||
      (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (cout <= 32) return (int)launch_conv<32>(x, w, b, out, n, h, wd, cin, cout, ldw, st);
  return (int)launch_conv<64>(x, w, b, out, n, h, wd, cin, cout, ldw, st);
}

}  // extern "C"
