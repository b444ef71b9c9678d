// The int8 product with a requantising epilogue for Hopper (sm_90a), bound
// with ctypes:
//
//   cvt_int8_matmul_requant   out = q(relu(float(qx @ qw) * scale + bias))
//
// with q(f) = clamp(rint(f * inv_out), -127, 127) as int8, or out = f as f32
// when no output scale is given.  It replaces the Pallas TPU kernel
// cpu_vision_tpu/ops/pallas/int8_matmul.py:int8_matmul_requant :55 (the
// pallas_call at :85), ResNet's 1x1 convolutions in the int8 engine.
//
// One launch of the s8 product of int8_gemm.cuh (i8_tc_gemm_kernel: wgmma
// m64n128k32 s8 into int32 sums, 128 x 128 outputs a block), its epilogue
// Q8_REQUANT(_RELU) (the int8 tile staged in shared memory, stored 16 bytes a
// thread) or Q8_LINEAR(_RELU) for an f32 output.
//
// Bound.  At ResNet-50's 1x1 shapes (M = N H W up to 802,816 rows, K and N
// 64 to 2048) the product does 2 M K N operations on M (K + N) + K N bytes of
// int8: at K = 256, N = 64 it is 26 G operations on 257 MB, 0.077 ms at the
// memory rate against 0.013 ms at the int8 tensor-core rate, so most of its
// shapes are bound by bytes.  A K of 64 fills half of a k tile of 128 (the
// rest is zero-filled) and an N of 64 half of a column tile: the tensor cores
// have the room.  Built with --fmad=false: the epilogue is the twin's f32
// operations one by one, so the int8 output equals the twin's bit for bit.

#include "int8_gemm.cuh"

namespace {

template <int EPI>
cudaError_t run(const int8_t* qx, const int8_t* qwt, const float* scale, const float* bias, const float* inv_out,
                void* out, int m, int k, int n, cudaStream_t stream) {
  return cvt::launch_i8_tc_gemm<EPI, float>(qx, qwt, cvt::Q8Epi<float>{scale, bias, inv_out, nullptr, out}, m, k, n,
                                            stream);
}

}  // namespace

extern "C" {

// qx (m, k) int8, qwt (n, k) int8 (the weight transposed), scale and bias (n,)
// f32, inv_out one f32 value (1 / output scale) or null for an f32 output;
// out (m, n) int8 or f32.  k a multiple of 16, rows 16-byte aligned, any m
// (one launch for each 65,535 row tiles of 128).  Launches on `stream`,
// returns the first failed launch's cudaError_t (0 on success), does not
// synchronise.
int cvt_int8_matmul_requant(const void* qx, const void* qwt, const float* scale, const float* bias,
                            const float* inv_out, void* out, int m, int k, int n, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* a = (const int8_t*)qx;
  const int8_t* b = (const int8_t*)qwt;
  if (inv_out != nullptr)
    return (int)(relu ? run<cvt::Q8_REQUANT_RELU>(a, b, scale, bias, inv_out, out, m, k, n, st)
                      : run<cvt::Q8_REQUANT>(a, b, scale, bias, inv_out, out, m, k, n, st));
  return (int)(relu ? run<cvt::Q8_LINEAR_RELU>(a, b, scale, bias, nullptr, out, m, k, n, st)
                    : run<cvt::Q8_LINEAR>(a, b, scale, bias, nullptr, out, m, k, n, st));
}

}  // extern "C"
