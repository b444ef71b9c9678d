// Weight gradient of a pointwise (1x1) convolution, dW = x^T . dy, for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel wgrad_matmul of
// cpu_vision_tpu/ops/pallas/wgrad_matmul.py:54 (pallas_call at :82), which
// streams M = N*H*W rows through VMEM in tiles on a sequential grid and keeps
// the whole (Cin, Cout) float32 sum resident on chip.  The TPU's 128-lane
// padding and the shrinking of block_m (:66-79) are Mosaic matters and are
// not copied here.
//
// Layouts.  x (M, Cin) and dy (M, Cout), row-major with row strides ldx and
// ldd (multiples of 8: the wrapper pads columns with zeros where Cin or Cout
// is not), both float32 or both bfloat16; dW (Cin, Cout) float32.  Products
// and sums are float32 (a product of two bfloat16 values is exact in
// float32).
//
// Design.  The shape is a huge contraction into a small output: at ResNet-50
// b128 layer 1, M = 401,408 and (Cin, Cout) = (64, 64), one output tile.  One
// block per output tile would leave 131 of 132 SMs idle, and the grid of a
// card runs blocks in no order, so nothing can carry a sum from one block to
// the next as the TPU's grid does.  So the grid is (Cout tiles, Cin tiles, M
// slabs): a block owns a (64 WGS) x BN output tile (WGS 1 or 2 warpgroups, 1
// where Cin <= 64; BN 64 where Cout <= 64, else 128) and one slab of rows,
// and sums it on the tensor cores (wgmma):
//   bfloat16: both operands as they lie, MN-major (A = x^T is Cin x M with Cin
//     contiguous, B = dy is M x Cout with Cout contiguous), which the bf16
//     wgmma reads with its transpose flags: cp.async copies 64 rows of x and
//     of dy a stage into a ring of three stages in the 128-byte swizzle, two
//     stages ahead of the products, and each warpgroup runs four m64nBNk16
//     products a stage;
//   float32: split TF32 (tf32x3.cuh), both operands staged through registers,
//     split into tf32 halves and stored K-major.
// Both start each stage's products from a zero wgmma sum and add it into a
// second f32 sum in registers when they retire (tf32x3.cuh: no chain of the
// tensor cores' own roundings is longer than a stage).  Each block writes its
// partial tile to a float32 scratch (slab, Cin, Cout); a second launch adds
// the slabs' partials of each output in slab order.  Every sum runs in a
// fixed order, so two calls give the same bits: no float atomicAdd, whose
// order changes from run to run.  With one slab the first launch writes dW
// itself.  The wrapper sizes the slabs so that the grid holds about four
// blocks per SM (ops/kernels/wgrad_matmul.py:slab_rows).
//
// Bound.  At (401,408, 64, 64) the function moves 103 MB in bfloat16 (205 MB
// in float32) and does 3.3 GFLOP (bf16) or 3 x 3.3 tf32 GFLOP (float32):
// bytes bound it.  At (25,088, 1024, 512) it does 26 GFLOP on 77 MB (bf16) or
// 3 x 26 tf32 GFLOP on 154 MB: operations bound it in float32, at
// 3 x 2 M Cin Cout / 495 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BF16_BK = 64;  // rows of x and dy a bf16 stage: one 128-byte swizzled row of 64 Cin (Cout)
constexpr int BF16_STAGES = 3;
constexpr int BF16_AHEAD = BF16_STAGES - 1;

// The partial tile of slab blockIdx.z: out + z * plane holds a (Cin, Cout) sum
struct PartialEpi {
  float* out;
  int cout;
  size_t plane;
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    float* p = out + blockIdx.z * plane + (size_t)row * cout + col;
    p[0] = v0;
    if (col + 1 < cout) p[1] = v1;
  }
};

template <int NACC>
__device__ __forceinline__ void wgmma_bf16_tt(float (&d)[NACC], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (NACC == 64)
    cvt::wgmma_m64n128k16_bf16_tt(d, a, b, scale_d);
  else
    cvt::wgmma_m64n64k16_bf16_tt(d, a, b, scale_d);
}

// The bf16 partial sums.  A stage holds 64 rows of x's (64 WGS) columns and of
// dy's BN columns, each in 64-column halves of 64 x 128 bytes: half h at h *
// 8192, row r (of M), chunk c of 8 columns at r * 128 + (c ^ r % 8) * 16.
template <int WGS, int BN>
__global__ void __launch_bounds__(128 * WGS, 1)
    wgrad_bf16_kernel(const bf16* __restrict__ x, int ldx, const bf16* __restrict__ dy, int ldd,
                      int m, int cin, int cout, int slab_rows, PartialEpi epi) {
  constexpr int THREADS = 128 * WGS, BM = 64 * WGS;
  constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128, STAGE_BYTES = A_BYTES + B_BYTES;
  constexpr int A_CHUNKS = BM * 8 / THREADS, B_CHUNKS = BN * 8 / THREADS;  // 16-byte copies a thread a stage
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = (cvt::smem_addr(smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int j0 = blockIdx.x * BN, i0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * slab_rows, k_end = min(m, k_begin + slab_rows);
  const int tiles = (k_end - k_begin + BF16_BK - 1) / BF16_BK;

  auto load = [&](int stage, int t) {
    const int k0 = k_begin + t * BF16_BK;
    const uint32_t sa = base + stage * STAGE_BYTES, sb = sa + A_BYTES;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int e = tid + i * THREADS, r = e / (BM / 8), c = e % (BM / 8);
      const int row = k0 + r, col = i0 + c * 8;
      const bool ok = row < k_end && col < cin;
      cvt::cp_async16(sa + (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                      x + (ok ? (size_t)row * ldx + col : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int e = tid + i * THREADS, r = e / (BN / 8), c = e % (BN / 8);
      const int row = k0 + r, col = j0 + c * 8;
      const bool ok = row < k_end && col < cout;
      cvt::cp_async16(sb + (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4),
                      dy + (ok ? (size_t)row * ldd + col : 0), ok);
    }
  };

  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.0f;

  // the stage a step refills held the tile of the step before, whose products
  // the wait that closed that step retired in both warpgroups (the barrier orders them)
#pragma unroll
  for (int s = 0; s < BF16_AHEAD; ++s) {
    if (s < tiles) load(s, s);
    cvt::cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cvt::cp_async_wait<BF16_AHEAD - 1>();
    cvt::fence_proxy_async();
    __syncthreads();
    const int next = t + BF16_AHEAD;
    if (next < tiles) load(next % BF16_STAGES, next);
    cvt::cp_async_commit();
    const uint32_t sa = base + (t % BF16_STAGES) * STAGE_BYTES, sb = sa + A_BYTES;
    cvt::wgmma_fence();
#pragma unroll
    for (int s = 0; s < BF16_BK / 16; ++s)  // a step of 16 rows: 16 rows of 128 bytes of either operand
      wgmma_bf16_tt(acc, cvt::sw128_desc(sa + wg * 8192 + s * 2048, 8192, 1024),
                    cvt::sw128_desc(sb + s * 2048, 8192, 1024), s > 0);
    cvt::wgmma_commit();
    cvt::wgmma_wait<0>();
    cvt::fence_sums(acc);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
  }
  cvt::store_tile(sum, i0 + wg * 64, j0, cin, cout, epi);
}

constexpr int REDUCE_GROUP = 16;  // slabs summed apart before their sum joins the total

// out[e] = the sum over slabs of partial[s][e] in a fixed order: groups of
// REDUCE_GROUP consecutive slabs summed apart, the groups' sums added in order
// (a chain of a few hundred slabs into one float would round more than
// torch.mm's sums do)
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int slabs,
                                    size_t count) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.0f;
  for (int g = 0; g < slabs; g += REDUCE_GROUP) {
    float part = 0.0f;
    for (int k = g; k < min(slabs, g + REDUCE_GROUP); ++k) part += partial[(size_t)k * count + e];
    s += part;
  }
  out[e] = s;
}

template <int WGS, int BN>
cudaError_t launch_bf16(const bf16* x, int ldx, const bf16* dy, int ldd, int m, int cin, int cout, int slab_rows,
                        int slabs, PartialEpi epi, cudaStream_t stream) {
  constexpr size_t smem = (size_t)BF16_STAGES * (64 * WGS + BN) * 128 + 1024;  // + room to align to 1024
  cudaError_t err =
      cudaFuncSetAttribute(wgrad_bf16_kernel<WGS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_j = (cout + BN - 1) / BN, tiles_i = (cin + 64 * WGS - 1) / (64 * WGS);
  wgrad_bf16_kernel<WGS, BN><<<dim3(tiles_j, tiles_i, slabs), 128 * WGS, smem, stream>>>(x, ldx, dy, ldd, m, cin,
                                                                                       cout, slab_rows, epi);
  return cudaGetLastError();
}

template <int WGS, int BN>
cudaError_t launch_partials(const void* x, int ldx, const void* dy, int ldd, int m, int cin, int cout, int slab_rows,
                            int slabs, int is_bf16, PartialEpi epi, cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<WGS, BN>(static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(dy), ldd, m, cin, cout,
                                slab_rows, slabs, epi, stream);
  return cvt::launch_x3_gemm<false, WGS, BN>(static_cast<const float*>(x), ldx, static_cast<const float*>(dy), ldd,
                                             cin, cout, m, slab_rows, epi, stream);
}

}  // namespace

extern "C" {

// dW (cin, cout) f32 = x^T dy for x (m, cin) and dy (m, cout) with row strides
// ldx and ldd (multiples of 8, at least cin and cout; the columns past cin and
// cout are read and must hold zeros), float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); slab_rows a multiple of 64; `partial` holds ceil(m / slab_rows) * cin *
// cout floats (unused with one slab).  The tile: 64 Cin rows where cin <= 64,
// else 128; 64 Cout columns where cout <= 64, else 128.  Launches on `stream`
// and returns the launches' cudaError_t (0 on success); never synchronises.
int cvt_wgrad_matmul(const void* x, const void* dy, float* partial, float* out, int m, int cin, int cout, int ldx,
                     int ldd, int slab_rows, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1 || cin < 1 || cout < 1 || ldx < cin || ldd < cout || ldx % 8 || ldd % 8 || slab_rows < BF16_BK ||
      slab_rows % BF16_BK)
    return (int)cudaErrorInvalidValue;
  const int slabs = (m + slab_rows - 1) / slab_rows;
  if (slabs > 65535 || (cin + 63) / 64 > 65535) return (int)cudaErrorInvalidValue;
  const PartialEpi epi{slabs == 1 ? out : partial, cout, (size_t)cin * cout};
  cudaError_t err;
  if (cin <= 64)
    err = cout <= 64 ? launch_partials<1, 64>(x, ldx, dy, ldd, m, cin, cout, slab_rows, slabs, is_bf16, epi, st)
                     : launch_partials<1, 128>(x, ldx, dy, ldd, m, cin, cout, slab_rows, slabs, is_bf16, epi, st);
  else
    err = cout <= 64 ? launch_partials<2, 64>(x, ldx, dy, ldd, m, cin, cout, slab_rows, slabs, is_bf16, epi, st)
                     : launch_partials<2, 128>(x, ldx, dy, ldd, m, cin, cout, slab_rows, slabs, is_bf16, epi, st);
  if (err != cudaSuccess || slabs == 1) return (int)err;
  const size_t count = (size_t)cin * cout;
  wgrad_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(partial, out, slabs, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
