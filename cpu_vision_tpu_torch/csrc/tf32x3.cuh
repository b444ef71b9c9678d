// Float32 products on Hopper's tensor cores by split TF32 (3xTF32), for the
// kernels whose products must keep float32 accuracy: the weight gradient of
// wgrad_matmul.cu, the two products of the float32 MLP of
// transformer_block.cu, and the QKV and output projections of the float32
// attention_block (transformer_block.cu) and window_attention_block
// (swin_attention.cu).
//
//   out = Epi(A . B)   A (m x k), B (k x n) of f32, sums in f32
//
// The split.  TF32 keeps 11 significant bits of a float's 24, and the tensor
// cores ignore an operand's 13 low mantissa bits (they truncate).  So each
// operand is split, a = a_hi + a_lo with a_hi = tf32_rna(a) and a_lo = a -
// a_hi (exact in f32): a_hi must be rounded before it is stored, or the
// truncation would leave a_hi + a_lo short of a by up to 2^-11 a; a_lo (at
// most 2^-11 a) is stored as it is and left to the truncation, which drops at
// most 2^-10 of it, 2^-21 of a (rounding it too was 2-30% slower on an H100,
// tools/torch_f32_products_ab.py, for no change in the float64 checks).  A
// product is a_hi b_hi + a_hi b_lo + a_lo b_hi, three tf32 wgmma into one f32
// sum.  What is left out, a_lo b_lo and the rest of each operand below the
// tf32 of a_lo, is at most about 2^-20 of each product, at or below the
// rounding of the f32 sums of 768 to 401,408 terms that these products
// feed.
// Three tf32 products at 495 TFLOP/s (dense) make 165 TFLOP/s of products
// of float32 accuracy, 2.5x the 67 TFLOP/s of the f32 FMA units.
//
// Layout.  PTX reads tf32 operands in shared memory K-major only (the
// transpose flags are for 16-bit types), and some operands lie MN-major in
// device memory: x and dy of the weight gradient, the MLP's weights ((k, n)
// row-major).  So both operands are copied as they lie (cp.async, 16-byte
// chunks along the contiguous dim) into a raw slot of shared memory and split
// on the way out of it:
//   A comes to the products from registers (wgmma's A fragment, hopper.cuh):
//     each thread reads its fragment's f32 words from the raw A tile, laid so
//     that the 32 lanes of a read hit 32 distinct banks (the 128-byte swizzle
//     for a K-major source; rows of k with the row XORed by 8 (k % 4) for an
//     MN-major one), and splits them in registers;
//   B is read back by the thread that copied it, split, and both halves
//     stored K-major into the 128-byte swizzle (a row of 32 f32 is four k8
//     steps).  A warp copies an MN-major B a (16 k x 8 n) patch, two lanes a
//     32-byte run of one k row, and stores it transposed: a lane's four values
//     go to four rows at one k, and the 32 lanes of each store land in 32
//     distinct banks (the swizzle XORs the row into the chunk).
// A from registers leaves the products only B to read from shared memory
// (4 KB of the 6 KB of an SS m64n128k8) and A's split unstored: 1.1x (MLP)
// to 1.25x (weight gradient) faster than both operands split into shared
// memory, on an H100 (tools/torch_f32_products_ab.py).
//
// Pipeline.  A block of two warpgroups owns a (64 WGS) x BN tile of the
// output (BN 64 or 128): with WGS 2 each warpgroup sums 64 of its rows, with
// WGS 1 each sums BN / 2 of its columns, so that both run every product: a
// wgmma under a branch on the warpgroup is one ptxas serialises (C7518), and
// the kernel ran 1.05-1.2x slower so.  K runs in stages of 32: X3_RAW raw
// slots (A and B as read; three stages in flight while one is read) and two
// split stages of B (hi, lo), 193 KB at 128 x 128, one block an SM.  A step
// reads A's fragments of its stage, starts the copy of the stage X3_RAW - 1
// ahead into the slot the step before finished with, starts the stage's
// twelve wgmma (four k8 steps of three), splits the next stage's B while they
// run, and waits for them; a barrier closes the step.
//
// Promotion.  The stage's twelve products start from a zero wgmma sum
// (scale_d 0) and, once retired, are added into a second f32 sum in
// registers: the tensor cores round the sums they chain in their own way
// (not IEEE round-to-nearest), so no chain is longer than twelve products
// (n = 4 k8 steps), and the long sum over k is the registers', rounded to
// nearest.  The second sum costs as many registers as the first and one add
// a value a stage.  Without it the weight gradient stood 2-8x further from
// float64 than torch.mm (bf16 2-3x, float32 5-8x) and the MLP 27x further
// than its twin, on an H100; with it, 0.3-0.8x.
//
// Chain order.  The tensor cores cut a chain's sum toward zero at each k8
// step, at the running sum's magnitude, so a chain takes its eight products
// with a lo half (2^-11 of the rest) first and its four hi hi products last:
// eight of its twelve cuts fall at the lo products' magnitude, not the full
// one.  The attention blocks' projections (launch_x3_rows) also sum the hi hi
// products in two chains of two steps where their tiles are 64 columns wide
// (HI_CHAINS 2, a third set of sums).  On an H100 the float32 window block on
// ROADMAP.md's fault 2 draw stood 2.10x the twin's float64 distance with the
// interleaved chain, 1.54x with the lo products first and 0.95x with two hi
// hi chains, the core alone 0.94x (tools/torch_attention_core_ab.py).
//
// Bound.  max(bytes / 3.35 TB/s, 3 x 2 m n k / 495 TFLOP/s): the three tf32
// products are the work the card does.  No atomics: every call gives the
// same bits.

#pragma once

#include "hopper.cuh"

namespace cvt {

constexpr int X3_BK = 32;   // k a stage: one 128-byte swizzled row of f32
constexpr int X3_RAW = 4;   // raw stages of f32 tiles (cp.async): three in flight while one is read

// byte offset of element (row, k) in a K-major tile of 128-byte rows, 128-byte swizzle
__device__ __forceinline__ int kmajor_at(int row, int k) {
  return row * 128 + ((((k >> 2) ^ (row & 7)) << 4) | ((k & 3) << 2));
}

// v = hi + lo: hi rounded to tf32, lo the exact rest (the tensor cores truncate it to tf32)
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = tf32_rna(v);
  lo = v - hi;
}

// The column at which a P V product stages key k of a tile of V^T, so that P's A fragment is the sums of S = Q K^T
// as this thread holds them: the m64k8 tf32 A fragment holds columns t and t + 4 of each group of 8 keys (t = lane %
// 4), the sums columns 2 t and 2 t + 1; so the keys of each group of 8 are taken in the order 0 2 4 6 1 3 5 7
// (tf32x3_attention.cuh, swin_attention.cu)
__device__ __forceinline__ int ax_key_column(int k) { return (k & ~7) | ((k & 7) >> 1) | ((k & 1) << 2); }

template <int WGS, int BN>
struct X3Shape {
  static constexpr int THREADS = 256;                // two warpgroups
  static constexpr int BM = 64 * WGS;
  static constexpr int WN = WGS == 2 ? BN : BN / 2;  // a warpgroup's columns (its rows: 64)
  static constexpr int A_BYTES = BM * 128;           // a stage of A, 32 k of f32
  static constexpr int B_BYTES = BN * 128;
  static constexpr int RAW_BYTES = A_BYTES + B_BYTES;  // a raw stage: A and B as read
  static constexpr int SPLIT_BYTES = 2 * B_BYTES;      // hi and lo of B
  static constexpr size_t SMEM = 2 * (size_t)SPLIT_BYTES + (size_t)X3_RAW * RAW_BYTES + 1024;  // + room to align
};

// A's raw stage of BM rows x 32 k, which the warpgroups read as register
// fragments.  K-major source: element (row, k) at kmajor_at(row, k).
// MN-major source (rows of k): at k BM 4 + (row ^ 8 (k % 4)) 4.  Either way
// the 32 lanes of a fragment's load (rows g, g + 8; k t, t + 4 for lane 4 g
// + t) hit 32 distinct banks.  Any thread may copy a chunk another reads: the
// barrier that closes a step orders them.
template <bool KMAJOR, int BM, int THREADS>
struct X3RawA {
  static constexpr int LOADS = BM * 8 / THREADS;  // 16-byte chunks a thread a stage
  static_assert(LOADS >= 1 && BM * 8 % THREADS == 0, "tile");

  static __device__ __forceinline__ int at(int row, int k) {
    return KMAJOR ? kmajor_at(row, k) : k * (BM * 4) + ((row ^ ((k & 3) << 3)) << 2);
  }

  // rows past mn_end and k past k_end are zero; source element (row, k) at src[row * ld + k] (KMAJOR) or
  // src[k * ld + row], a warp's chunks along the contiguous dim
  static __device__ __forceinline__ void copy(uint32_t raw, const float* __restrict__ src, int ld, int mn0,
                                              int mn_end, int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int row = KMAJOR ? e >> 3 : e % (BM / 4) * 4, k = KMAJOR ? (e & 7) * 4 : e / (BM / 4);
      const bool ok = mn0 + row < mn_end && k0 + k < k_end;
      const size_t off = KMAJOR ? (size_t)(mn0 + row) * ld + k0 + k : (size_t)(k0 + k) * ld + mn0 + row;
      cp_async16(raw + at(row, k), src + (ok ? off : 0), ok);
    }
  }

  // this thread's A fragment of the k8 step kk for the 64 rows from r0 (hopper.cuh), split into tf32 hi and lo;
  // ROUND_LO: lo rounded to tf32 too (cvt.rna), not left to the tensor cores' truncation
  template <bool ROUND_LO = false>
  static __device__ __forceinline__ void fragment(const char* raw, int r0, int kk, uint32_t (&hi)[4],
                                                  uint32_t (&lo)[4]) {
    const int lane = threadIdx.x & 31, row = r0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float h, l;
      const int k = 8 * kk + (lane & 3) + 4 * (r >> 1);
      split_tf32(*reinterpret_cast<const float*>(raw + at(row + 8 * (r & 1), k)), h, l);
      if (ROUND_LO) l = tf32_rna(l);
      hi[r] = __float_as_uint(h);
      lo[r] = __float_as_uint(l);
    }
  }
};

// B's stage of 32 k x N columns, source element (k, n) at src[k * ld + n]
// (rows of k); chunks of four with n < n_end and k < k_end are read, the rest
// is zero; ld a multiple of 4 and src 16-byte aligned.  A thread copies its
// chunks (cp.async) into a raw slot at raw + (i THREADS + tid) 16 and later
// reads back the same chunks and no other, so its own cp.async wait is all
// the ordering the raw slots need; it splits them into hi and lo tiles,
// K-major (rows of n) in the 128-byte swizzle.
template <int N, int THREADS>
struct X3RawB {
  static constexpr int LOADS = N * 8 / THREADS;  // 16-byte chunks a thread a stage
  static_assert(LOADS >= 1 && N * 8 % THREADS == 0 && N % 8 == 0, "tile");

  // chunk i of this thread: row k, columns n .. n + 3 (a warp a patch of 16 k x 8 n)
  static __device__ __forceinline__ void at(int i, int& n, int& k) {
    const int patch = (threadIdx.x >> 5) + i * (THREADS / 32), lane = threadIdx.x & 31;
    n = patch % (N / 8) * 8 + (lane & 1) * 4;
    k = patch / (N / 8) * 16 + (lane >> 1);
  }

  static __device__ __forceinline__ void copy(uint32_t raw, const float* __restrict__ src, int ld, int n0, int n_end,
                                              int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      int n, k;
      at(i, n, k);
      const bool ok = n0 + n < n_end && k0 + k < k_end;
      cp_async16(raw + (i * THREADS + threadIdx.x) * 16, src + (ok ? (size_t)(k0 + k) * ld + n0 + n : 0), ok);
    }
  }

  // this thread's chunks of a raw slot, split, both halves into the tiles at hi and lo; ROUND_LO: lo rounded to
  // tf32 too (cvt.rna), not left to the tensor cores' truncation
  template <bool ROUND_LO = false>
  static __device__ __forceinline__ void split(const char* raw, char* hi, char* lo) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      int n, k;
      at(i, n, k);
      const float4 r = *reinterpret_cast<const float4*>(raw + (i * THREADS + threadIdx.x) * 16);
      const float v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float h, l;
        split_tf32(v[q], h, l);
        if (ROUND_LO) l = tf32_rna(l);
        *reinterpret_cast<float*>(hi + kmajor_at(n + q, k)) = h;
        *reinterpret_cast<float*>(lo + kmajor_at(n + q, k)) = l;
      }
    }
  }
};

// d (+)= A . B over one k8 step, A 64 rows from registers, B 2 NACC rows K-major in the 128-byte swizzle
template <int NACC>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NACC], const uint32_t (&a)[4], uint32_t b, int scale_d) {
  static_assert(NACC == 64 || NACC == 40 || NACC == 32 || NACC == 16 || NACC == 8, "n 128, 80, 64, 32 or 16");
  if constexpr (NACC == 64)
    wgmma_m64n128k8_tf32_rs(d, a, sw128_desc(b, 16, 1024), scale_d);
  else if constexpr (NACC == 40)
    wgmma_m64n80k8_tf32_rs(d, a, sw128_desc(b, 16, 1024), scale_d);
  else if constexpr (NACC == 32)
    wgmma_m64n64k8_tf32_rs(d, a, sw128_desc(b, 16, 1024), scale_d);
  else if constexpr (NACC == 16)
    wgmma_m64n32k8_tf32_rs(d, a, sw128_desc(b, 16, 1024), scale_d);
  else
    wgmma_m64n16k8_tf32_rs(d, a, sw128_desc(b, 16, 1024), scale_d);
}

// The sums of a warpgroup's 64 x (2 NACC) tile at rows r0.., columns n0..:
// thread t = 32 w + l holds d[4 j + 2 h + e] = D[16 w + l / 4 + 8 h][8 j + 2 (l % 4) + e].  Calls
// epi.store(row, col, v0, v1) for the pairs with row < m and col < n (col + 1 may be n).
template <int NACC, class Epi>
__device__ __forceinline__ void store_tile(const float (&d)[NACC], int r0, int n0, int m, int n, const Epi& epi) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row0 = r0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < m) epi.store(row, col, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// keeps the compiler from reusing the fragments' registers before the wait that retires their products
template <int K8>
__device__ __forceinline__ void keep_fragments(const uint32_t (&hi)[K8][4], const uint32_t (&lo)[K8][4]) {
#pragma unroll
  for (int kk = 0; kk < K8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" ::"r"(hi[kk][r]), "r"(lo[kk][r]) : "memory");
}

// out = Epi(A . B) for rows < m, columns < n: A element (i, kk) is a[i * lda + kk] (A_KMAJOR) or a[kk * lda +
// i], B element (kk, j) is b[kk * ldb + j].  blockIdx.z sums kk over [z k_slab, min(k, (z + 1) k_slab)).
// HI_CHAINS: the chains a stage's hi hi products are summed in, 1 (four k8 steps) or 2 (two each, a second set of
// sums: the attention blocks' projections, whose float64 rule needs them; at 128 x 128 tiles they spill).
template <bool A_KMAJOR, int WGS, int BN, class Epi, int HI_CHAINS = 1>
__global__ void __launch_bounds__(256, 1)
x3_gemm_kernel(const float* __restrict__ a, int lda, const float* __restrict__ b, int ldb, int m, int n, int k,
               int k_slab, Epi epi, int row_tile0) {
  using S = X3Shape<WGS, BN>;
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  char* const tiles = reinterpret_cast<char*>(smem) + (base - smem_addr(smem));
  const int wg = threadIdx.x >> 7;
  const int m0 = (row_tile0 + blockIdx.y) * S::BM, n0 = blockIdx.x * BN;
  const int wg_row = WGS == 2 ? wg * 64 : 0, wg_col = WGS == 2 ? 0 : wg * S::WN;  // this warpgroup's part
  const int k_begin = blockIdx.z * k_slab, k_end = min(k, k_begin + k_slab);
  const int stages = (k_end - k_begin + X3_BK - 1) / X3_BK;

  using RawA = X3RawA<A_KMAJOR, S::BM, S::THREADS>;
  using RawB = X3RawB<BN, S::THREADS>;
  // shared memory: two split stages of B (hi, lo), then X3_RAW raw slots (A, B); a raw stage is copied
  // X3_RAW - 1 stages ahead of the products
  const uint32_t raw0 = base + 2 * S::SPLIT_BYTES;
  const char* const raw_tiles = tiles + 2 * S::SPLIT_BYTES;
  auto copy = [&](int stage) {
    const uint32_t raw = raw0 + stage % X3_RAW * S::RAW_BYTES;
    const int k0 = k_begin + stage * X3_BK;
    RawA::copy(raw, a, lda, m0, m, k0, k_end);
    RawB::copy(raw + S::A_BYTES, b, ldb, n0, n, k0, k_end);
  };
  auto put = [&](int stage) {  // B's raw chunks of this thread, split, into the split stage (stage & 1)
    char* st = tiles + (stage & 1) * S::SPLIT_BYTES;
    RawB::split(raw_tiles + stage % X3_RAW * S::RAW_BYTES + S::A_BYTES, st, st + S::B_BYTES);
  };

  static_assert(HI_CHAINS == 1 || HI_CHAINS == 2, "one or two chains of hi hi products a stage");
  float acc[S::WN / 2], acc2[HI_CHAINS == 2 ? S::WN / 2 : 1], sum[S::WN / 2];
#pragma unroll
  for (int i = 0; i < S::WN / 2; ++i) acc[i] = sum[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (HI_CHAINS == 2 ? S::WN / 2 : 1); ++i) acc2[i] = 0.0f;

  // one cp.async group a stage, empty past the last, so that a wait for all but X3_RAW - 2 groups is one for
  // the stage split next
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
    // A's fragments of stage s (its raw slot complete in every thread since the barrier that closed the step
    // before), split in registers
    uint32_t a_hi[X3_BK / 8][4], a_lo[X3_BK / 8][4];
    const char* raw_a = raw_tiles + s % X3_RAW * S::RAW_BYTES;
#pragma unroll
    for (int kk = 0; kk < X3_BK / 8; ++kk) RawA::fragment(raw_a, wg_row, kk, a_hi[kk], a_lo[kk]);
    // the raw slot of stage s - 1, read to its end before that barrier, takes stage s + X3_RAW - 1
    if (s + X3_RAW - 1 < stages) copy(s + X3_RAW - 1);
    cp_async_commit();
    const uint32_t b_hi = base + (s & 1) * S::SPLIT_BYTES + wg_col * 128, b_lo = b_hi + S::B_BYTES;
    wgmma_fence();  // after writing the fragments, before the products read them
#pragma unroll
    for (int kk = 0; kk < X3_BK / 8; ++kk) {  // a step of 8 k: 32 bytes along B's swizzled rows; lo products first
      wgmma_tf32(acc, a_lo[kk], b_hi + kk * 32, kk > 0);
      wgmma_tf32(acc, a_hi[kk], b_lo + kk * 32, 1);
    }
    // then the hi hi ones: all in acc, or the stage's second half in acc2 from zero
    constexpr int IN_ACC = HI_CHAINS == 2 ? X3_BK / 16 : X3_BK / 8;
#pragma unroll
    for (int kk = 0; kk < IN_ACC; ++kk) wgmma_tf32(acc, a_hi[kk], b_hi + kk * 32, 1);
    if constexpr (HI_CHAINS == 2) {
#pragma unroll
      for (int kk = IN_ACC; kk < X3_BK / 8; ++kk) wgmma_tf32(acc2, a_hi[kk], b_hi + kk * 32, kk > IN_ACC);
    }
    wgmma_commit();
    // the other split stage's products retired before the barrier that closed the step before
    if (s + 1 < stages) {
      cp_async_wait<X3_RAW - 2>();
      put(s + 1);
    }
    wgmma_wait<0>();
    fence_sums(acc);
    if constexpr (HI_CHAINS == 2) fence_sums(acc2);
    keep_fragments(a_hi, a_lo);  // the products read them until the wait
#pragma unroll
    for (int i = 0; i < S::WN / 2; ++i) sum[i] += HI_CHAINS == 2 ? acc[i] + acc2[i] : acc[i];
    fence_proxy_async();
    __syncthreads();
  }
  store_tile(sum, m0 + wg_row, n0 + wg_col, m, n, epi);
}

// grid (n tiles, m tiles, slabs), the m tiles past the grid's y in further launches; lda and ldb multiples of 4,
// k_slab of X3_BK
template <bool A_KMAJOR, int WGS, int BN, class Epi, int HI_CHAINS = 1>
cudaError_t launch_x3_gemm(const float* a, int lda, const float* b, int ldb, int m, int n, int k, int k_slab,
                           Epi epi, cudaStream_t stream) {
  using S = X3Shape<WGS, BN>;
  if (m < 1 || n < 1 || k < 1 || lda % 4 || ldb % 4 || k_slab < X3_BK || k_slab % X3_BK)
    return cudaErrorInvalidValue;
  const int rows = (m + S::BM - 1) / S::BM, cols = (n + BN - 1) / BN, slabs = (k + k_slab - 1) / k_slab;
  if (slabs > MAX_GRID_YZ) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(x3_gemm_kernel<A_KMAJOR, WGS, BN, Epi, HI_CHAINS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return err;
  for (int r0 = 0; r0 < rows; r0 += MAX_GRID_YZ) {
    x3_gemm_kernel<A_KMAJOR, WGS, BN, Epi, HI_CHAINS><<<dim3(cols, min(MAX_GRID_YZ, rows - r0), slabs), S::THREADS,
                                                        S::SMEM, stream>>>(a, lda, b, ldb, m, n, k, k_slab, epi, r0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The epilogue of the float32 blocks' products: out = resid + gamma * (acc +
// bias) in f32, stored in pairs of columns at row stride ld; gamma null for
// none, and with resid null out = acc + bias alone (a bias epilogue).
struct ResidEpi {
  const float* bias;
  const float* resid;
  const float* gamma;
  float* out;
  int ld;
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    const size_t at = (size_t)row * ld + col;
    v0 += bias[col];
    v1 += bias[col + 1];
    if (gamma != nullptr) {
      v0 *= gamma[col];
      v1 *= gamma[col + 1];
    }
    if (resid != nullptr) {
      v0 = resid[at] + v0;
      v1 = resid[at + 1] + v1;
    }
    float2 v;
    v.x = v0;
    v.y = v1;
    *reinterpret_cast<float2*>(out + at) = v;
  }
};

// out = Epi(a . b) for a (m, k) and b (k, n), both row-major (lda k, ldb n: multiples of 4), in one slab (the
// epilogue needs the whole sum): the attention blocks' projections.  Up to 128 columns, and where 64-column tiles pad
// n less, tiles of 128 x 64 with the hi hi products in two chains a stage (HI_CHAINS 2: the float64 rule of the
// narrow blocks, Swin-T's first two stages, needs them, and at 128 x 128 the second set of sums spills); otherwise
// 128 x 128 tiles, one chain (A read once a column tile; with two chains at 128 x 64 the wider blocks ran 1.15-1.17x
// slower on an H100).  N 288 (Swin-T's first QKV) takes 5 tiles of 64, 320 columns, not 3 of 128 (384).
template <class Epi>
cudaError_t launch_x3_rows(const float* a, const float* b, int m, int n, int k, Epi epi, cudaStream_t stream) {
  const int k_slab = (k + X3_BK - 1) / X3_BK * X3_BK;
  if (n <= 128 || (n + 63) / 64 * 64 < (n + 127) / 128 * 128)
    return launch_x3_gemm<true, 2, 64, Epi, 2>(a, k, b, n, m, n, k, k_slab, epi, stream);
  return launch_x3_gemm<true, 2, 128, Epi, 1>(a, k, b, n, m, n, k, k_slab, epi, stream);
}

}  // namespace cvt
