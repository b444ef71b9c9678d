// Weight gradient of a pointwise (1x1) convolution, dW = x^T . dy, for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel wgrad_matmul of
// cpu_vision_tpu/ops/pallas/wgrad_matmul.py:54 (pallas_call at :82), which
// streams M = N*H*W rows through VMEM in tiles on a sequential grid and keeps
// the whole (Cin, Cout) float32 sum resident on chip.  The TPU's 128-lane
// padding and the shrinking of block_m (:66-79) are Mosaic matters and are
// not copied: no padding exists here, ragged edges are masked.
//
// Layouts.  x (M, Cin) and dy (M, Cout), row-major, both float32 or both
// bfloat16; dW (Cin, Cout) float32.  Products and sums are float32 (a product
// of two bfloat16 values is exact in float32).
//
// Design.  The shape is a huge contraction into a tiny output: at ResNet-50
// b128 layer 1, M = 401,408 and (Cin, Cout) = (64, 64), one output tile.  One
// block per output tile would leave 131 of 132 SMs idle, and the grid of a
// card runs blocks in no order, so nothing can carry a sum from one block to
// the next as the TPU's grid does.  So the grid is (Cout tiles, Cin tiles, M
// slabs): a block owns a 64x64 output tile and one slab of rows.  It walks its
// slab in chunks of 32 rows, staging the chunk's x and dy columns in shared
// memory as float32; each of its 256 threads keeps a 4x4 sum in registers and
// adds 32 outer products of a float4 of x and a float4 of dy per chunk.  Each
// block writes its 64x64 partial sum to a float32 scratch (slab, Cin, Cout);
// a second launch adds the slabs' partials of each output in slab order.
// Every sum runs in a fixed order, so two calls give the same bits: no
// float atomicAdd, whose order changes from run to run.  With one slab the
// first launch writes dW itself.  The wrapper sizes the slabs so that the
// grid holds about four blocks per SM.
//
// Bound.  At (401,408, 64, 64) the function moves 103 MB in bfloat16 (205 MB
// in float32) and does 3.3 GFLOP: bytes bound it.  At (25,088, 1024, 512) it
// does 26 GFLOP on 77 MB: float32 operations bound this kernel, which uses
// scalar FMAs and no tensor core (no wgmma, no TMA, no cp.async, one stage).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_I = 64;   // Cin per block
constexpr int TILE_J = 64;   // Cout per block
constexpr int CHUNK = 32;    // rows staged at once
constexpr int THREADS = 256; // 16 x 16 threads, each a 4 x 4 sum
constexpr int PER_T = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partial, int m,
                         int cin, int cout, int slab_rows) {
  __shared__ __align__(16) float xs[CHUNK][TILE_I];
  __shared__ __align__(16) float ds[CHUNK][TILE_J];

  const int j0 = blockIdx.x * TILE_J, i0 = blockIdx.y * TILE_I;
  const int m0 = blockIdx.z * slab_rows;
  const int m1 = min(m, m0 + slab_rows);
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;  // this thread's rows i0 + 4 ty.., columns j0 + 4 tx..
  const int lc = t % TILE_I, lr = t / TILE_I;  // load pattern: a column, rows lr, lr + 4, ...
  const bool x_col = i0 + lc < cin, d_col = j0 + lc < cout;

  float acc[PER_T][PER_T];
#pragma unroll
  for (int a = 0; a < PER_T; ++a)
#pragma unroll
    for (int b = 0; b < PER_T; ++b) acc[a][b] = 0.0f;

  for (int base = m0; base < m1; base += CHUNK) {
#pragma unroll
    for (int r = lr; r < CHUNK; r += THREADS / TILE_I) {
      const int row = base + r;
      const bool in = row < m1;
      xs[r][lc] = in && x_col ? to_f32(x[(size_t)row * cin + i0 + lc]) : 0.0f;
      ds[r][lc] = in && d_col ? to_f32(dy[(size_t)row * cout + j0 + lc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < CHUNK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * PER_T]);
      const float4 b = *reinterpret_cast<const float4*>(&ds[k][tx * PER_T]);
      const float av[PER_T] = {a.x, a.y, a.z, a.w};
      const float bv[PER_T] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < PER_T; ++p)
#pragma unroll
        for (int q = 0; q < PER_T; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }

  float* dst = partial + (size_t)blockIdx.z * cin * cout;
#pragma unroll
  for (int p = 0; p < PER_T; ++p) {
    const int i = i0 + ty * PER_T + p;
    if (i >= cin) break;
#pragma unroll
    for (int q = 0; q < PER_T; ++q) {
      const int j = j0 + tx * PER_T + q;
      if (j < cout) dst[(size_t)i * cout + j] = acc[p][q];
    }
  }
}

// out[e] = sum over slabs s = 0, 1, ... of partial[s][e], in that order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int slabs,
                                    size_t count) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.0f;
  for (int k = 0; k < slabs; ++k) s += partial[(size_t)k * count + e];
  out[e] = s;
}

template <typename T>
int launch(const T* x, const T* dy, float* partial, float* out, int m, int cin, int cout, int slab_rows,
           cudaStream_t stream) {
  if (m < 1 || cin < 1 || cout < 1 || slab_rows < CHUNK || slab_rows % CHUNK) return (int)cudaErrorInvalidValue;
  const int slabs = (m + slab_rows - 1) / slab_rows;
  const int tiles_j = (cout + TILE_J - 1) / TILE_J, tiles_i = (cin + TILE_I - 1) / TILE_I;
  if (slabs > 65535 || tiles_i > 65535) return (int)cudaErrorInvalidValue;
  wgrad_partial_kernel<T><<<dim3(tiles_j, tiles_i, slabs), THREADS, 0, stream>>>(
      x, dy, slabs == 1 ? out : partial, m, cin, cout, slab_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return (int)err;
  const size_t count = (size_t)cin * cout;
  wgrad_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(partial, out, slabs, count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dW (cin, cout) f32 = x^T dy for x (m, cin) and dy (m, cout), float32
// (bf16 = 0) or bfloat16 (bf16 = 1); `partial` holds ceil(m / slab_rows) *
// cin * cout floats (unused with one slab).  Launches on `stream` and returns
// the launches' cudaError_t (0 on success); never synchronises.
int cvt_wgrad_matmul(const void* x, const void* dy, float* partial, float* out, int m, int cin, int cout,
                     int slab_rows, int bf16, void* stream) {
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), partial, out, m,
                  cin, cout, slab_rows, (cudaStream_t)stream);
  return launch(static_cast<const float*>(x), static_cast<const float*>(dy), partial, out, m, cin, cout, slab_rows,
                (cudaStream_t)stream);
}

}  // extern "C"
