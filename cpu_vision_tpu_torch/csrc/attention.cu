// flash_mha for Hopper (sm_90a), bound with ctypes: softmax(scale * Q K^T) V
// per head with the scores kept on chip.
//
// Replaces the Pallas TPU kernel of cpu_vision_tpu/ops/pallas/flash_attention.py
// (_fwd_pallas :56, pallas_call at :59, reached through flash_mha :70).  That
// kernel takes one image a grid step and holds all heads' (S, S) scores in
// VMEM; a block here has 227 KB, so the core in attention.cuh streams key
// tiles with an online softmax instead.
//
// Layouts.  q, k, v (N, S, H, hd) as the QKV projection leaves them; the
// output is (N, H, S, hd), as the TPU kernel returns it.  Both are given to
// the core as strides: no transposed copy of q, k or v is made (the TPU
// wrapper makes three).
//
// Bound.  ViT-B/16 in f32 at batch 64 (S 197, 12 heads of 64): 4 S^2 hd
// operations a head, 7.6 GFLOP in all, against 155 MB of q, k, v and o.  At
// head dims 16, 64 and 80 both types run on the tensor cores: bf16 in
// tc_attention.cuh (bytes bind it), float32 by split TF32 in
// tf32x3_attention.cuh (three tf32 products a product: bytes and products
// about even).
//
// cvt_attention_core_backward is the backward of the bf16 core at head dim 64
// (tc_attention_bwd.cuh, Kernel B), for flash_mha's and attention_block's
// gradients.  cvt_attention_core_scalar launches the scalar float32 core
// (attention.cuh's attention_core_kernel) that the split-TF32 core replaced,
// at head dims 16, 64 and 80, kept as that core's yardstick of float64
// accuracy (tests and chip_smoke.py; no path runs it).

#include "attention.cuh"
#include "tc_attention_bwd.cuh"

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// never synchronises.
int cvt_flash_mha(const void* q, const void* k, const void* v, void* o, int n, int s_len, int heads,
                  int hd, float scale, int is_bf16, void* stream) {
  const long long in_s = (long long)heads * hd, in_n = (long long)s_len * in_s;
  const long long o_h = (long long)s_len * hd, o_n = (long long)heads * o_h;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return (int)cvt::attention_core<__nv_bfloat16>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (__nv_bfloat16*)o, n,
        s_len, heads, hd, scale, in_n, in_s, hd, o_n, hd, o_h, st);
  return (int)cvt::attention_core<float>((const float*)q, (const float*)k, (const float*)v, (float*)o, n,
                                         s_len, heads, hd, scale, in_n, in_s, hd, o_n, hd, o_h, st);
}

// The scalar float32 core (attention_core_kernel) at head dim hd (16, 64 or 80), strides and result as
// cvt_flash_mha's.
int cvt_attention_core_scalar(const void* q, const void* k, const void* v, void* o, int n, int s_len, int heads,
                              int hd, float scale, void* stream) {
  const long long in_s = (long long)heads * hd, in_n = (long long)s_len * in_s;
  const long long o_h = (long long)s_len * hd, o_n = (long long)heads * o_h;
  if (n < 1 || heads < 1 || s_len < 1) return (int)cudaErrorInvalidValue;
  return (int)cvt::with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    return cvt::over_images_heads(n, heads, [&](int n0, int nc, int h0, int hc) -> cudaError_t {
      const long long in0 = n0 * in_n + h0 * (long long)HD;
      return cvt::launch_attention_core<float, HD, float>((const float*)q + in0, (const float*)k + in0,
                                                          (const float*)v + in0, (float*)o + n0 * o_n + h0 * o_h, nc,
                                                          s_len, hc, scale, in_n, in_s, HD, o_n, HD, o_h,
                                                          (cudaStream_t)stream, nullptr);
    });
  });
}

// dq, dk, dv of softmax(scale q k^T) v given dout, bf16 at head dim 64, any S: q, k, v and the gradients share the
// strides in_* (element (n, s, h, d) at n in_n + s in_s + h in_h + d), dout has o_*; o (null: not written) gets the
// output again, bf16(bf16(p) v), at the strides p_*; stats: cvt_attention_core_backward_stats_floats(n, s_len,
// heads) floats of scratch.  Two launches.
int cvt_attention_core_backward(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                                void* dv, void* o, void* stats, int n, int s_len, int heads, float scale,
                                long long in_n, long long in_s, long long in_h, long long o_n, long long o_s,
                                long long o_h, long long p_n, long long p_s, long long p_h, void* stream) {
  using bf = __nv_bfloat16;
  return (int)cvt::launch_attention_bwd((const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, (bf*)dq, (bf*)dk,
                                        (bf*)dv, (bf*)o, (float*)stats, n, s_len, heads, scale, in_n, in_s, in_h, o_n,
                                        o_s, o_h, p_n, p_s, p_h, (cudaStream_t)stream);
}

long long cvt_attention_core_backward_stats_floats(int n, int s_len, int heads) {
  return cvt::attention_bwd_stats_floats(n, s_len, heads);
}

// What the card gives a kernel of this library: its registers a thread, its dynamic shared memory a block and the
// blocks an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  which: 0 the backward's query-tile
// blocks (with O), 1 its key-tile blocks (hd ignored), 2 the split-TF32 float32 core, 3 the bf16 tensor-core core,
// both at head dim hd.
int cvt_attention_kernel_info(int which, int hd, int* regs, int* smem_bytes, int* blocks_per_sm) {
  const void* fn = nullptr;
  int threads = 0, smem = 0;
  if (which == 0) {
    fn = (const void*)cvt::attention_bwd_q_kernel<true>, threads = cvt::ABW_THREADS, smem = (int)cvt::ABW_Q_SMEM;
  } else if (which == 1) {
    fn = (const void*)cvt::attention_bwd_kv_kernel, threads = cvt::ABW_THREADS, smem = (int)cvt::ABW_KV_SMEM;
  } else if (which == 2 || which == 3) {
    const cudaError_t picked = cvt::with_head_dim(hd, [&](auto hd_c) {
      constexpr int HD = decltype(hd_c)::value;
      if (which == 2)
        fn = (const void*)cvt::attention_x3_kernel<HD, float>, threads = cvt::AX_THREADS,
        smem = (int)cvt::AxShape<HD>::SMEM;
      else
        fn = (const void*)cvt::attention_tc_kernel<HD, __nv_bfloat16>, threads = cvt::ATC_THREADS,
        smem = (int)cvt::AtcTile<HD>::SMEM;
      return cudaSuccess;
    });
    if (picked != cudaSuccess) return (int)picked;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem);
  *regs = attr.numRegs;
  *smem_bytes = smem;
  return (int)err;
}

}  // extern "C"
