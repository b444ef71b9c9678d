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
// Bound.  At ResNet-50's 1x1 shapes (M = N H W up to 802,816 rows, K and N
// 64 to 2048) the product does 2 M K N operations on M (K + N) + K N bytes of
// int8: at K = 256, N = 64 it is 26 G operations on 257 MB, 0.077 ms at the
// memory rate against 0.013 ms at the int8 tensor-core rate.  So it is bound
// by bytes; this first version multiplies with dp4a from shared memory (the
// tiled product of int8_gemm.cuh, 128 x 128 outputs a block), reads each row
// of qx once a 128-column tile of qw and writes the int8 output four bytes at
// a time where the row allows it.  Built with --fmad=false: the epilogue is
// the twin's f32 operations one by one, so the int8 output equals the twin's
// bit for bit.

#include "int8_gemm.cuh"

namespace {

using cvt::quant_i8;

template <bool RELU, bool QUANT>
struct EpiRequant {
  const float* scale;
  const float* bias;
  const float* inv_out;  // a single value (QUANT)
  void* out;             // int8 (QUANT) or f32
  __device__ __forceinline__ void store4(long long row, int col, int n, int a0, int a1, int a2, int a3) const {
    const int a[4] = {a0, a1, a2, a3};
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[j] = col + j < n ? __int2float_rn(a[j]) * scale[col + j] + bias[col + j] : 0.0f;
      if (RELU) f[j] = fmaxf(f[j], 0.0f);
    }
    const long long at = row * n + col;
    if (!QUANT) {
      float* o = static_cast<float*>(out);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n) o[at + j] = f[j];
      return;
    }
    const float inv = *inv_out;
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] = quant_i8(f[j], inv);
    int8_t* o = static_cast<int8_t*>(out);
    if (n % 4 == 0 && col + 3 < n) {
      *reinterpret_cast<int*>(o + at) = cvt::pack4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n) o[at + j] = (int8_t)q[j];
    }
  }
};

template <bool RELU, bool QUANT>
cudaError_t run(const int8_t* qx, const int8_t* qwt, const float* scale, const float* bias, const float* inv_out,
                void* out, int m, int k, int n, cudaStream_t stream) {
  cvt::AOperand<float> a{qx, nullptr, nullptr, nullptr, 0.0f};
  return cvt::launch_i8_gemm<float, cvt::A_I8>(a, qwt, m, k, n, EpiRequant<RELU, QUANT>{scale, bias, inv_out, out},
                                               stream);
}

}  // namespace

extern "C" {

// qx (m, k) int8, qwt (n, k) int8 (the weight transposed), scale and bias (n,)
// f32, inv_out one f32 value (1 / output scale) or null for an f32 output;
// out (m, n) int8 or f32.  k a multiple of 16, rows 16-byte aligned.  Launches
// on `stream`, returns the launch's cudaError_t (0 on success), does not
// synchronise.
int cvt_int8_matmul_requant(const void* qx, const void* qwt, const float* scale, const float* bias,
                            const float* inv_out, void* out, int m, int k, int n, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* a = (const int8_t*)qx;
  const int8_t* b = (const int8_t*)qwt;
  if (inv_out != nullptr)
    return (int)(relu ? run<true, true>(a, b, scale, bias, inv_out, out, m, k, n, st)
                      : run<false, true>(a, b, scale, bias, inv_out, out, m, k, n, st));
  return (int)(relu ? run<true, false>(a, b, scale, bias, nullptr, out, m, k, n, st)
                    : run<false, false>(a, b, scale, bias, nullptr, out, m, k, n, st));
}

}  // extern "C"
