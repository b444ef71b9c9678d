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
// the sequential part kept to bit operations on chip.
//   1. nms_mask_kernel, one block of 64 threads for each (problem, row block
//      of 64 boxes, column block of 64 boxes) on or above the diagonal, and
//      no other: thread i sets bit k of its row's word where box 64 cb + k
//      comes after box i and overlaps it above the threshold.  It first finds
//      the column boxes that meet box i (both clipped sides above 0) without
//      a branch, then computes the IoU of those alone.  The
//      words go to device memory tile by tile, the 64 rows of a (row block,
//      column block) side by side and the row blocks' upper triangles packed
//      one after another (a block writes 512 contiguous bytes; a problem's
//      scratch is 64 W (W + 1) / 2 words, W = ceil(N / 64); it stays in the
//      50 MB L2 at the detector's sizes).
//   2. nms_scan_kernel, one block of 16 warps a problem on a persistent grid,
//      walks the row blocks ("tiles") in score order with the removed bits of
//      every box in shared memory.  A warp resolves a tile from its diagonal
//      words (resolve below: rounds of the twin's fixpoint over the warp's
//      lanes, then a serial walk with __ffsll where a chain is long).  The OR
//      of tile t's kept rows into each later word is one warp's: its lanes
//      take two of the 64 rows each, mask them by the kept bits, and reduce
//      with __reduce_or_sync, four words at once.  While warp 0 ORs the next word and at once
//      resolves tile t + 1 (the critical path), the other warps OR the words
//      after it, and cp.async brings tile t + 4's words from device memory:
//      five stages of up to NMS_STAGE_WORDS words a row (a tile's words past
//      them, N > 4,096 only, are read from device memory by the warps off the
//      critical path).  One block barrier a tile.  That is the greedy
//      recursion exactly; the TPU kernel's blocks of 128 and its fixed 128
//      sweeps were a Mosaic work-around.
//
// Bound.  Operations: 3 f32 operations a box for its area, once; 9 a pair
// for the clipped sides and their product, which decides a pair whose
// product is 0; 14 a pair whose product is not 0 (the union, its floor, the
// division and the comparison added).  A problem with K boxes kept of N needs
// the K (K - 1) / 2 pairs of kept boxes and one meeting pair for each of the
// N - K struck boxes; at most 3 N + 14 N (N - 1) / 2 (0.94 GFLOP at N = 4096,
// P = 8).  The kernel tests every pair of the upper triangle for a meeting
// (its two clipped sides above 0, without a branch) and computes the IoU of
// the pairs that meet.  Bytes: 16 N
// in and N out a problem (0.56 MB at N = 4096, P = 8); the mask adds
// 2 * 8 * 64 W (W + 1) / 2 bytes of this split's own (17.0 MB at N = 4096,
// P = 8).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using cvt::cp_async16;
using cvt::cp_async_commit;
using cvt::cp_async_wait;
using cvt::smem_addr;
using u64 = unsigned long long;

constexpr int NMS_COLS = 64;  // boxes a mask word covers, and the rows of a tile
constexpr int NMS_MAX_BOXES = 13600;
constexpr int NMS_MAX_WORDS = (NMS_MAX_BOXES + NMS_COLS - 1) / NMS_COLS;
constexpr int NMS_SCAN_WARPS = 16;
constexpr int NMS_SCAN_THREADS = 32 * NMS_SCAN_WARPS;
constexpr int NMS_STAGES = 5;             // tiles in shared memory: ORed (t), resolved (t + 1), three in flight
constexpr int NMS_AHEAD = NMS_STAGES - 1;  // tiles copied ahead: tile t + 4 at step t
constexpr int NMS_STAGE_WORDS = 64;       // words of a tile's rows a stage holds (5 x 32 KB: N <= 4,096 staged whole)
constexpr int NMS_JACOBI = 8;             // rounds of the warp's parallel resolve before the serial walk
constexpr int NMS_OR_WORDS = 4;           // later words a warp ORs at once
constexpr int NMS_BLOCKS_PER_SM = 4;      // the scan's grid: at most this many blocks an SM, each walking problems

__device__ __forceinline__ float box_area(float4 b) { return (b.z - b.x) * (b.w - b.y); }

// the first block of row block r in a problem's packed upper triangle of words x words blocks
__host__ __device__ __forceinline__ long long tile_start(int r, int words) {
  return (long long)r * words - (long long)r * (r - 1) / 2;
}

// grid (words (words + 1) / 2, p): block b of a problem is (row block rb, column block cb >= rb)
__global__ void __launch_bounds__(NMS_COLS)
nms_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask, int n, int words, long long tri, float thr) {
  const long long b = blockIdx.x;
  const double span = 2.0 * words + 1.0;
  int rb = (int)((span - sqrt(span * span - 8.0 * (double)b)) / 2.0);  // tile_start(rb) <= b, up to rounding
  while (rb > 0 && tile_start(rb, words) > b) --rb;
  while (rb + 1 < words && tile_start(rb + 1, words) <= b) ++rb;
  const int cb = rb + (int)(b - tile_start(rb, words));
  __shared__ float4 cols[NMS_COLS];
  __shared__ float col_area[NMS_COLS];
  const float4* src = boxes + (size_t)blockIdx.y * n;
  const int t = threadIdx.x, j0 = cb * NMS_COLS, cnt = min(NMS_COLS, n - j0);
  if (t < cnt) {
    cols[t] = src[j0 + t];
    col_area[t] = box_area(cols[t]);
  }
  __syncthreads();
  const int i = rb * NMS_COLS + t;
  u64 bits = 0;
  if (i < n) {
    const float4 box = src[i];
    // the column boxes whose clipped sides are both above 0, without a branch: the pairs that may meet
    auto sides = [&](float4 c, float& w, float& h) {
      w = fminf(box.z, c.z) - fmaxf(box.x, c.x);
      h = fminf(box.w, c.w) - fmaxf(box.y, c.y);
    };
    u64 meet = 0;
    if (cnt == NMS_COLS) {  // unrolled: each bit's shift a constant
#pragma unroll
      for (int k = 0; k < NMS_COLS; ++k) {
        float w, h;
        sides(cols[k], w, h);
        meet |= (u64)(w > 0.0f && h > 0.0f) << k;
      }
    } else {
      for (int k = 0; k < cnt; ++k) {
        float w, h;
        sides(cols[k], w, h);
        meet |= (u64)(w > 0.0f && h > 0.0f) << k;
      }
    }
    const u64 after = cb == rb ? ~0ull << t << 1 : ~0ull;  // on the diagonal, the boxes after box i only
    const u64 cols_live = cnt >= 64 ? ~0ull : (1ull << cnt) - 1;
    meet &= after;
    // a pair whose clipped sides' product is 0 has IoU 0: it decides 0 > thr
    bits = 0.0f > thr ? after & cols_live & ~meet : 0ull;
    const float area = box_area(box);
    while (meet) {
      const int k = __ffsll((long long)meet) - 1;
      meet &= meet - 1;
      float w, h;
      sides(cols[k], w, h);
      const float inter = w * h;  // w, h > 0: fmaxf(w, 0) fmaxf(h, 0)
      const bool above = inter == 0.0f ? 0.0f > thr : inter / fmaxf(area + col_area[k] - inter, 1e-12f) > thr;
      bits |= (u64)above << k;
    }
  }
  mask[((size_t)blockIdx.y * tri + b) * NMS_COLS + t] = bits;  // rows past n: 0
}

// The boxes kept of a tile of cnt boxes whose removed bits are `removed` on entry; every lane of a warp calls it
// with the same arguments, and lane 0's answer holds.  Every box standing in score order is kept and removes the
// boxes its diagonal word marks (all after it).  The warp first iterates kept = standing & ~(the OR of the kept
// boxes' words) from kept = standing, as the twin does, its lanes holding two rows each and the OR reduced with
// __reduce_or_sync: the greedy answer is the one fixed point, reached a round after the tile's longest chain of
// removals, and most tiles' chains are short.  After NMS_JACOBI rounds without it, lane 0 walks the boxes in
// order with __ffsll, a step for each standing box whose word marks a standing box.
__device__ __forceinline__ u64 resolve(const u64* diag, u64 removed, int cnt, int lane) {
  const u64 live = cnt >= 64 ? ~0ull : (1ull << cnt) - 1;
  const u64 standing = live & ~removed;
  const u64 da = diag[lane] & standing, db = diag[lane + 32] & standing;  // rows lane and lane + 32
  u64 kept = standing;
  for (int round = 0; round < NMS_JACOBI; ++round) {
    const u64 v = ((kept >> lane) & 1 ? da : 0ull) | ((kept >> (lane + 32)) & 1 ? db : 0ull);
    const u64 hit = (u64)__reduce_or_sync(0xffffffffu, (unsigned)(v >> 32)) << 32 |
                    __reduce_or_sync(0xffffffffu, (unsigned)v);
    const u64 next = standing & ~hit;
    if (next == kept) return kept;
    kept = next;
  }
  const u64 marks = (u64)__ballot_sync(0xffffffffu, db != 0) << 32 | __ballot_sync(0xffffffffu, da != 0);
  if (lane == 0) {
    u64 steps = standing & marks;
    while (steps) {
      const int k = __ffsll((long long)steps) - 1;
      removed |= diag[k];
      steps = live & ~removed & marks & (~0ull << k << 1);
    }
  }
  return live & ~removed;
}

__global__ void __launch_bounds__(NMS_SCAN_THREADS)
nms_scan_kernel(const u64* __restrict__ mask, unsigned char* __restrict__ keep, int p, int n, int words, long long tri,
                int stage_words) {
  extern __shared__ __align__(16) u64 s_rows[];  // [NMS_STAGES][stage_words][64]: a tile's words t.. of its rows
  __shared__ u64 removed[NMS_MAX_WORDS];
  __shared__ u64 kept[NMS_MAX_WORDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t stage = (size_t)stage_words * NMS_COLS;

  for (int prob = blockIdx.x; prob < p; prob += gridDim.x) {
    const u64* const m = mask + (size_t)prob * tri * NMS_COLS;
    auto copy_tile = [&](int t) {  // tile t's words t .. t + stage_words - 1 (those there are) into its stage
      if (t < words) {
        const int chunks = min(words - t, stage_words) * NMS_COLS / 2;  // 16 bytes each
        const u64* src = m + tile_start(t, words) * NMS_COLS;
        const uint32_t dst = smem_addr(s_rows + (t % NMS_STAGES) * stage);
        for (int c = tid; c < chunks; c += NMS_SCAN_THREADS) cp_async16(dst + 16 * c, src + 2 * c, true);
      }
      cp_async_commit();
    };
    auto tile_boxes = [&](int t) { return min(NMS_COLS, n - t * NMS_COLS); };

    for (int w = tid; w < words; w += NMS_SCAN_THREADS) removed[w] = 0;
#pragma unroll
    for (int a = 0; a < NMS_AHEAD; ++a) copy_tile(a);
    cp_async_wait<NMS_AHEAD - 2>();
    __syncthreads();  // tiles 0 and 1 here; the last problem's reads of kept[] done
    if (warp == 0) {
      const u64 k0 = resolve(s_rows, 0, tile_boxes(0), lane);
      if (lane == 0) kept[0] = k0;
    }
    __syncthreads();

    for (int t = 0; t < words; ++t) {
      copy_tile(t + NMS_AHEAD);  // into the stage of tile t - 1, whose reads ended at the last barrier
      const u64* const rows = s_rows + (t % NMS_STAGES) * stage;
      const u64 kt = kept[t];
      const u64 ka = (kt >> lane) & 1 ? ~0ull : 0ull, kb = (kt >> (lane + 32)) & 1 ? ~0ull : 0ull;
      // this lane's two rows of tile t's word w, masked by their kept bits: the OR over the warp's lanes is the
      // kept rows' OR (or_lanes; every lane of the warp calls it)
      auto kept_rows = [&](int w) {
        const int wi = w - t;
        if (wi < stage_words) return (rows[wi * NMS_COLS + lane] & ka) | (rows[wi * NMS_COLS + lane + 32] & kb);
        const u64* src = m + (tile_start(t, words) + wi) * NMS_COLS;  // past the stage: from device memory
        return (src[lane] & ka) | (src[lane + 32] & kb);
      };
      auto or_lanes = [](u64 v) {
        return (u64)__reduce_or_sync(0xffffffffu, (unsigned)(v >> 32)) << 32 | __reduce_or_sync(0xffffffffu, (unsigned)v);
      };
      if (warp == 0) {  // the next tile's removed bits complete, then the tile resolved
        if (t + 1 < words) {
          const u64 k1 = resolve(s_rows + ((t + 1) % NMS_STAGES) * stage, removed[t + 1] | or_lanes(kept_rows(t + 1)),
                                 tile_boxes(t + 1), lane);
          if (lane == 0) kept[t + 1] = k1;
        }
      } else {  // the later words, NMS_OR_WORDS at once a warp: their loads and reductions in flight together
        constexpr int STRIDE = NMS_SCAN_WARPS - 1;
        for (int w0 = t + 1 + warp; w0 < words; w0 += NMS_OR_WORDS * STRIDE) {
          u64 v[NMS_OR_WORDS];
#pragma unroll
          for (int j = 0; j < NMS_OR_WORDS; ++j) v[j] = w0 + j * STRIDE < words ? kept_rows(w0 + j * STRIDE) : 0ull;
#pragma unroll
          for (int j = 0; j < NMS_OR_WORDS; ++j) v[j] = or_lanes(v[j]);
          if (lane == 0) {
#pragma unroll
            for (int j = 0; j < NMS_OR_WORDS; ++j)
              if (w0 + j * STRIDE < words) removed[w0 + j * STRIDE] |= v[j];
          }
        }
      }
      cp_async_wait<NMS_AHEAD - 2>();
      __syncthreads();  // tile t + 1 resolved, the later words ORed, tile t + 2 here
    }
    unsigned char* const dst = keep + (size_t)prob * n;
    for (int i = tid; i < n; i += NMS_SCAN_THREADS) dst[i] = (unsigned char)((kept[i >> 6] >> (i & 63)) & 1ull);
  }
}

}  // namespace

extern "C" {

// The largest n one launch takes (the removed bits of a problem live in
// shared memory).
int cvt_nms_max_boxes() { return NMS_MAX_BOXES; }

// boxes (p, n, 4) f32, mask 64 W (W + 1) / 2 64-bit words a problem of scratch (W = ceil(n / 64); 16-byte
// aligned), keep (p, n)
// bytes (0 or 1); sms: the card's multiprocessors, which size the scan's grid.  Launches both kernels on `stream`
// and returns the first cudaError_t that is not 0 (0 on success); does not synchronise.
int cvt_nms_sorted(const void* boxes, void* mask, void* keep, int p, int n, float thr, int sms, void* stream) {
  if (p < 1 || p > 65535 || n < 1 || n > NMS_MAX_BOXES || sms < 1) return (int)cudaErrorInvalidValue;
  const int words = (n + NMS_COLS - 1) / NMS_COLS;
  const long long tri = (long long)words * (words + 1) / 2;
  cudaStream_t st = (cudaStream_t)stream;
  nms_mask_kernel<<<dim3((unsigned)tri, p), NMS_COLS, 0, st>>>((const float4*)boxes, (u64*)mask, n, words, tri, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int stage_words = words < NMS_STAGE_WORDS ? words : NMS_STAGE_WORDS;
  const size_t smem = sizeof(u64) * NMS_STAGES * stage_words * NMS_COLS;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = p < NMS_BLOCKS_PER_SM * sms ? p : NMS_BLOCKS_PER_SM * sms;
  nms_scan_kernel<<<grid, NMS_SCAN_THREADS, smem, st>>>((const u64*)mask, (unsigned char*)keep, p, n, words, tri,
                                                        stage_words);
  return (int)cudaGetLastError();
}

}  // extern "C"
