// The int8 engine's requant arithmetic past the dequant (int8_mma.cuh's
// `dequant`: y = RN(RN(float(acc) * deq) + bias)), shared by the two
// kernels that end a conv step: csrc/requant_epilogue.cu (on a GEMM's int32
// accumulator read back from memory) and csrc/conv3x3.cu (on the
// accumulators of its own GEMM, in registers). Written once here, so both
// give the engine's codes, sums and logits bit for bit.
//
// Every operation rounds to nearest as the plain version's eager ops do
// (kernels/requant_epilogue.py `epilogue_reference`): the products and sums
// are __fmul_rn / __fadd_rn, and -fmad=false keeps nvcc from contracting
// anything else; the residual's product is rounded before it is added; the
// quotient is __fdiv_rn's (a multiply by the reciprocal flips codes at
// rounding boundaries: `codes` divides wherever that product could round
// otherwise); bf16 is __float2bfloat16_rn. float(acc) is int8_mma.cuh's
// acc_to_float and rint-then-clip the 1.5 * 2^23 add, equal bit for bit to
// __int2float_rn and to rintf (half to even) with the clamp, without the
// conversion instructions, which issue at a sixteenth of the float32 rate.

#pragma once

#include <cuda_bf16.h>

#include "int8_mma.cuh"

namespace requant {

// y = RN(y + RN(float(r) * s)), an int8 residual at scale s added.
__device__ __forceinline__ float add_resid(float y, int r, float s) {
  return __fadd_rn(y, __fmul_rn(int8mma::acc_to_float(r), s));
}

// clip(rint(q), low, 127), half to even: the clip first (rint is monotone),
// then the add of 1.5 * 2^23, which rounds to an integer as rint does. low
// is 0 (a ReLU) or -127.
__device__ __forceinline__ int round_clip(float q, float low) {
  q = fminf(fmaxf(q, low), 127.0f);
  return __float_as_int(__fadd_rn(q, 12582912.0f)) - 0x4B400000;
}

// The codes clip(rint(RN(y[i] / s)), low, 127) of N values, bit for bit,
// the divide taken only where it can matter (int8_mma.cuh's argument): the
// quotient is first y times inv_s = RN(1 / s), within 2.3e-5 of RN(y / s)
// where |y / s| <= 128, so the two round alike unless it lies within 2^-13
// of a half-integer; above 128 both clip. Where any of the N lies that
// near, all N take __fdiv_rn: one branch for N values, rarely taken, keeps
// their fast paths side by side.
template <int N>
__device__ __forceinline__ void codes(const float (&y)[N], int (&q)[N], float s, float inv_s,
                                      float low) {
  float f[N];
  bool near = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[i] = __fmul_rn(y[i], inv_s);
    const float k = __fsub_rn(__fadd_rn(f[i], 12582912.0f), 12582912.0f);
    near |= fabsf(__fsub_rn(f[i], k)) > 0.5f - 0x1p-13f;
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = int8mma::exact_quotient(y[i], s);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = round_clip(f[i], low);
}

// The bits of RN(y) in bfloat16.
__device__ __forceinline__ unsigned short bf16_bits(float y) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(y));
}

}  // namespace requant
