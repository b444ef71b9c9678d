// Greedy non-maximum suppression over boxes sorted by descending score, for
// Hopper (sm_90a), bound with ctypes:
//
//   cvt_nms_sorted   keep[p, i] = no kept box j < i of problem p has IoU(j, i) > thr
//
// It replaces the Pallas TPU kernel of cpu_vision_tpu/ops/pallas/nms.py:
// nms_sorted_pallas :93 (pallas_call at :111), which resolves blocks of 128
// boxes with a fixed-depth Jacobi fixpoint in VMEM.
//
// Arithmetic.  Boxes are (x1, y1, x2, y2) in f32.  The IoU of a pair is the
// Pallas kernel's _iou_tile (nms.py:31-40):
//   inter / max(area_a + area_b - inter, 1e-12),
//   inter = max(min(x2) - max(x1), 0) * max(min(y2) - max(y1), 0),
//   area  = (x2 - x1) * (y2 - y1),
// with IEEE division and no contraction into fused multiply-adds (the source
// is built with --fmad=false), so each decision IoU > thr equals the plain
// twin's (ops/kernels/nms.py) bit for bit.  The formula is symmetric in the
// two boxes to the last bit (max, min, + and * commute in IEEE arithmetic),
// and a pair whose intersection is 0 has IoU 0 whatever the union, so such a
// pair skips the rest (for finite boxes the decision is the same).
//
// Design: two launches, the quadratic work spread over the whole card and
// the sequential part kept to bit operations.
//   1. nms_mask_kernel, one block of 64 threads for each (problem, row block
//      of 64 boxes, column block of 64 boxes) on or above the diagonal: thread
//      i sets bit k of mask[p, i, cb] where box 64 cb + k comes after box i and
//      overlaps it above the threshold.  The upper triangle of the problem's
//      suppression matrix, N * ceil(N / 64) words, goes to device memory (the
//      wrapper allocates it; it stays in the 50 MB L2 at the detector's sizes).
//   2. nms_scan_kernel, one warp a problem, walks the boxes in tiles of 64 in
//      score order with the "removed" bits of every later box in shared
//      memory: lane 0 resolves the tile from its diagonal words (a box is kept
//      iff no kept box before it removed it), then the lanes OR the kept rows'
//      words into the removed bits of the later tiles.  That is the greedy
//      recursion exactly; the TPU kernel's blocks of 128 and its fixed 128
//      sweeps were a Mosaic work-around.
//
// Bound.  Operations: 3 f32 operations a box for its area, once; 9 a pair
// for the clipped sides and their product, which decides a pair whose
// product is 0; 14 a pair whose product is not 0 (the union, its floor, the
// division and the comparison added).  A problem with K boxes kept of N needs
// the K (K - 1) / 2 pairs of kept boxes and one meeting pair for each of the
// N - K struck boxes; at most 3 N + 14 N (N - 1) / 2 (0.94 GFLOP at N = 4096,
// P = 8).  The kernel computes the areas again for each meeting pair and
// tests the product against 0 besides.  Bytes: 16 N in and N out a problem
// (0.56 MB at N = 4096, P = 8); the mask adds 2 * 8 N ceil(N / 64) bytes of
// this split's own (33.6 MB at N = 4096, P = 8).

#include <cuda_runtime.h>

namespace {

constexpr int NMS_COLS = 64;         // boxes a mask word covers
constexpr int NMS_MAX_BOXES = 13600;
constexpr int NMS_MAX_WORDS = (NMS_MAX_BOXES + NMS_COLS - 1) / NMS_COLS;

__device__ __forceinline__ float box_area(float4 b) { return (b.z - b.x) * (b.w - b.y); }

__device__ __forceinline__ bool overlaps(float4 a, float4 b, float thr) {
  const float w = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float h = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  const float inter = w * h;
  if (inter == 0.0f) return 0.0f > thr;
  const float uni = box_area(a) + box_area(b) - inter;
  return inter / fmaxf(uni, 1e-12f) > thr;
}

__global__ void __launch_bounds__(NMS_COLS)
nms_mask_kernel(const float4* __restrict__ boxes, unsigned long long* __restrict__ mask, int n, int words, float thr) {
  const int rb = blockIdx.x, cb = blockIdx.y;
  if (cb < rb) return;  // below the diagonal: never read
  __shared__ float4 cols[NMS_COLS];
  const float4* src = boxes + (size_t)blockIdx.z * n;
  const int t = threadIdx.x, j0 = cb * NMS_COLS, cnt = min(NMS_COLS, n - j0);
  if (t < cnt) cols[t] = src[j0 + t];
  __syncthreads();
  const int i = rb * NMS_COLS + t;
  if (i >= n) return;
  const float4 b = src[i];
  unsigned long long bits = 0;
  for (int k = cb == rb ? t + 1 : 0; k < cnt; ++k)
    if (overlaps(b, cols[k], thr)) bits |= 1ull << k;
  mask[((size_t)blockIdx.z * n + i) * words + cb] = bits;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ mask, unsigned char* __restrict__ keep, int n, int words) {
  __shared__ unsigned long long removed[NMS_MAX_WORDS];
  __shared__ unsigned long long diag[NMS_COLS];
  __shared__ unsigned long long tile_kept;
  const int lane = threadIdx.x;
  const unsigned long long* m = mask + (size_t)blockIdx.x * n * words;
  unsigned char* dst = keep + (size_t)blockIdx.x * n;
  for (int w = lane; w < words; w += 32) removed[w] = 0;
  __syncthreads();
  for (int t = 0; t < words; ++t) {
    const int base = t * NMS_COLS, cnt = min(NMS_COLS, n - base);
    for (int k = lane; k < cnt; k += 32) diag[k] = m[(size_t)(base + k) * words + t];
    __syncthreads();
    if (lane == 0) {
      unsigned long long rem = removed[t], kept = 0;
      for (int k = 0; k < cnt; ++k)
        if (!((rem >> k) & 1ull)) {
          kept |= 1ull << k;
          rem |= diag[k];
        }
      tile_kept = kept;
    }
    __syncthreads();
    const unsigned long long kept = tile_kept;
    for (int k = lane; k < cnt; k += 32) dst[base + k] = (unsigned char)((kept >> k) & 1ull);
    for (int w = t + 1 + lane; w < words; w += 32) {
      unsigned long long acc = removed[w];
#pragma unroll 8
      for (int k = 0; k < cnt; ++k) {
        const unsigned long long row = m[(size_t)(base + k) * words + w];
        acc |= ((kept >> k) & 1ull) ? row : 0ull;
      }
      removed[w] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// The largest n one launch takes (the removed bits of a problem live in
// shared memory).
int cvt_nms_max_boxes() { return NMS_MAX_BOXES; }

// boxes (p, n, 4) f32, mask (p, n, ceil(n / 64)) 64-bit scratch, keep (p, n)
// bytes (0 or 1).  Launches both kernels on `stream` and returns the first
// cudaError_t that is not 0 (0 on success); does not synchronise.
int cvt_nms_sorted(const void* boxes, void* mask, void* keep, int p, int n, float thr, void* stream) {
  if (p < 1 || p > 65535 || n < 1 || n > NMS_MAX_BOXES) return (int)cudaErrorInvalidValue;
  const int words = (n + NMS_COLS - 1) / NMS_COLS;
  cudaStream_t st = (cudaStream_t)stream;
  nms_mask_kernel<<<dim3(words, words, p), NMS_COLS, 0, st>>>((const float4*)boxes, (unsigned long long*)mask, n,
                                                              words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<p, 32, 0, st>>>((const unsigned long long*)mask, (unsigned char*)keep, n, words);
  return (int)cudaGetLastError();
}

}  // extern "C"
