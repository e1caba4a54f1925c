// The int8 tensor-core building block of csrc/bottleneck.cu and
// csrc/stem_fp.cu: mma.sync m16n8k32 on s8 with s32 accumulators, A
// fragments by ldmatrix from shared memory, B fragments from a layout packed
// on the host in the order the fragments are read, cp.async copies, and the
// engine's requant epilogue in the form both kernels share.
//
// Why mma.sync and not wgmma. Both kernels are implicit-GEMM convolutions
// whose A rows are pixels gathered at arbitrary shared-memory addresses (the
// nine taps of a 3x3, the halo of a tile); ldmatrix takes one address per
// row, so a tap is an address offset and nothing is copied. wgmma wants its
// shared-memory operands in its own swizzled core-matrix layout, which would
// cost a re-layout of every tap, and a 64-row warpgroup tile. mma.sync keeps
// the build to inline PTX (seconds of nvcc) and gives the epilogue each
// value in a known thread.
//
// Fragments of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (PTX ISA),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 32, rows are pixels): a[0] row g,     bytes 4t .. 4t + 3
//                                 a[1] row g + 8, bytes 4t .. 4t + 3
//                                 a[2] row g,     bytes 16 + 4t .. 16 + 4t + 3
//                                 a[3] row g + 8, bytes 16 + 4t .. 16 + 4t + 3
//   B (32 x 8, columns are output channels): b[0] column g, k 4t .. 4t + 3;
//                                            b[1] column g, k 16 + 4t .. 16 + 4t + 3
//   C/D (16 x 8 int32): c[i] at row g + 8 * (i / 2), column 2t + (i % 2).
//
// Packed B layout (kernels/int8_pack.py `pack_b_operand`): a (K, N) int8
// kernel, K a multiple of 32 and N of 64, as int8 [N / 64][K / 32][4][32][16]:
// for pass p (64 output channels), k-step s and pair q (n-tiles 2q and
// 2q + 1 of the pass), lane L's 16 bytes are b[0], b[1] of n-tile 2q, then
// b[0], b[1] of n-tile 2q + 1. A warp reads one pair of one k-step as 512
// consecutive bytes, 16 a lane, without bank conflicts, and a (pass, k-step
// range) is one contiguous run that cp.async copies as it lies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace int8mma {

constexpr int kPassN = 64;            // output channels of one pass in the packed layout
constexpr int kStepK = 32;            // k of one mma
constexpr int kStepBytes = 2048;      // one k-step of one pass: 4 pairs x 32 lanes x 16 bytes
constexpr int kPairBytes = 512;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// d += a . b on the tensor cores, exact in int32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16 x 32 tile whose rows lie anywhere in shared memory:
// lane L passes the address of row L % 16 plus 16 * (L / 16) bytes. Each row
// address is 16-byte aligned.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The B fragments of one pair of n-tiles: b[0], b[1] of n-tile 2q and of 2q + 1.
__device__ __forceinline__ uint4 load_pair(const int8_t* pair_base, int lane) {
  return *reinterpret_cast<const uint4*>(pair_base + 16 * lane);
}

// 16 bytes global -> shared, asynchronously; zero-filled where !valid (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The engine's requant epilogue, bit for bit, without its slow instructions.
// The engine computes clip(rint(y / s), -127, 127) with y = max(float(acc) *
// deq + bias [+ extra], 0), each operation rounded (IEEE divide, rint half
// to even). Here:
//  - float(acc) is exact by the exponent trick where |acc| < 2^22 (the bits
//    of 1.5 * 2^23 plus acc, less 1.5 * 2^23), else a conversion;
//  - the quotient is y times inv_s = RN(1 / s). For |y / s| <= 128 that is
//    within 2.3e-5 of RN(y / s) (three roundings of 2^-24 relative), so
//    unless it lies within 2^-13 of a half-integer both round to the same
//    integer; there (about 2.4e-4 of the values) it divides, IEEE. Above
//    128 both clip to 127;
//  - rint and the clip are a clamp to [-127, 127] and an add of 1.5 * 2^23,
//    whose rounding to nearest even is rint's.
__device__ __forceinline__ float acc_to_float(int a) {
  if (static_cast<unsigned>(a + (1 << 22)) < (1u << 23)) {
    return __fsub_rn(__int_as_float(0x4B400000 + a), 12582912.0f);
  }
  return __int2float_rn(a);
}

__device__ __forceinline__ int round_clip127(float q) {
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return __float_as_int(__fadd_rn(q, 12582912.0f)) - 0x4B400000;
}

// The IEEE quotient, out of line: the rare path keeps the code small.
__device__ __noinline__ float exact_quotient(float y, float s) { return __fdiv_rn(y, s); }

// clip(rint(x / s), -127, 127) of a signed value, bit for bit, with the
// divide only where the product by inv_s = RN(1 / s) could round to another
// code: for |x / s| <= 128 the two quotients lie within 2.3e-5 of each
// other, so beyond 2^-13 of a half-integer they round alike; above 128 both
// clip. No ReLU: the L2Norm's codes and the ResNet stem's input codes are
// signed (requant2 is the ReLU'd form).
__device__ __forceinline__ int quantize_code(float x, float s, float inv_s) {
  float q = __fmul_rn(x, inv_s);
  const float k = __fsub_rn(__fadd_rn(q, 12582912.0f), 12582912.0f);
  if (fabsf(__fsub_rn(q, k)) > 0.5f - 0x1p-13f) q = exact_quotient(x, s);
  return round_clip127(q);
}

__device__ __forceinline__ float dequant(int acc, float deq, float bias) {
  return __fadd_rn(__fmul_rn(acc_to_float(acc), deq), bias);
}

// Two codes as the low 16 bits, first in the low byte.
__device__ __forceinline__ unsigned short pack2(int lo, int hi) {
  return static_cast<unsigned short>((lo & 0xff) | ((hi & 0xff) << 8));
}

// The codes of two values ya, yb (dequantized, before the ReLU), packed,
// first in the low byte. Both quotients go the fast way side by side; one
// branch takes both the exact way where either lies near a rounding
// boundary, which keeps the fast paths of many values interleaved.
__device__ __forceinline__ unsigned short requant2(float ya, float yb, float s, float inv_s) {
  ya = fmaxf(ya, 0.0f);
  yb = fmaxf(yb, 0.0f);
  float qa = __fmul_rn(ya, inv_s), qb = __fmul_rn(yb, inv_s);
  const float ka = __fsub_rn(__fadd_rn(qa, 12582912.0f), 12582912.0f);
  const float kb = __fsub_rn(__fadd_rn(qb, 12582912.0f), 12582912.0f);
  if (fmaxf(fabsf(__fsub_rn(qa, ka)), fabsf(__fsub_rn(qb, kb))) > 0.5f - 0x1p-13f) {
    qa = exact_quotient(ya, s);
    qb = exact_quotient(yb, s);
  }
  return pack2(round_clip127(qa), round_clip127(qb));
}

}  // namespace int8mma
