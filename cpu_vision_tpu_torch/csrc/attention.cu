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
// operations a head, 7.6 GFLOP in all, against 155 MB of q, k, v and o:
// operations bind at the f32 rate outside the tensor cores, where float32
// runs as scalar FMAs from shared memory.  bf16 at head dim 64 runs on the
// tensor cores (tc_attention.cuh); bytes bind it there.

#include "attention.cuh"

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

}  // extern "C"
