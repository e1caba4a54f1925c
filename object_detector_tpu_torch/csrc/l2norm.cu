// Int8 L2Norm + learned scale + requant over the channels of each pixel.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/l2norm_pallas.py
// ::_l2norm_kernel (:35, launched through l2norm_requant, pallas_call at :63).
// The TPU kernel folds gamma / out_scale into one vector; that changes codes
// at rounding boundaries and is not carried over.
//
// Contract. x (P, C) int8 codes, one row per pixel (the (B, H, W, C) tap
// flattened), C a multiple of 16 up to 2048 (so C * 127^2 < 2^24); gamma
// (C,) float32; out_scale float32. out (P, C) int8 =
//   clip(rint(x * (1 / sqrt(sum_c x^2 + 1e-12)) * gamma / out_scale), -127, 127),
// with the products taken left to right. This is the reference's serving
// default, the unfolded jnp form of quant/engine.py:1242-1248 (times gamma,
// then divide by the scale); the TPU kernel folds gamma / out_scale and is
// allowed one code off on < 1e-3 of the elements against it.
//
// Bit-exactness. sum_c x^2 is an integer below 2^24, so it is exact in int32
// and in float32 in any order. inv = RN(1 / RN(sqrt(RN(ss + 1e-12)))) and y =
// RN(RN(x * inv) * gamma) round after every operation (__fsqrt_rn, __fdiv_rn,
// __fmul_rn), as the plain PyTorch version does. The quotient y / out_scale
// is the exact form of csrc/int8_mma.cuh `quantize_code`: y * RN(1 /
// out_scale), and an IEEE divide only where that lies within 2^-13 of a
// half-integer (about 2.4e-4 of the values), then rint half to even and the
// clip. Zero pixels give y = 0 and code 0.
//
// What bounds it on an H100. At SSD-300 bs=64 the tap is (64, 38, 38, 512):
// 47.3 MB read and 47.3 MB written, 0.028 ms at 3.35 TB/s. About 8 float32
// operations an element (0.38 G) take 0.011 ms at 33.5e12 non-FMA
// operations/s. The bytes bound it.
//
// Design. A persistent grid: as many blocks of 8 warps as fit on the card.
// Each warp walks pixels with a stride of all the grid's warps; lane L holds
// channels 16 (32 k + L) .. + 15 of chunk k (C / 512 chunks, a template
// argument) as one 16-byte load, and loads the next pixel's chunks (a
// streaming load) before it reduces and requantizes the current one, so two
// pixels a warp are in flight. Its gamma values depend on the lane and the
// chunk only and stay in registers for the whole walk. The squares are summed
// with __dp4a and five shuffles; the codes leave in one streaming 16-byte
// store a chunk. Device memory is read once and written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using int8mma::quantize_code;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float code_of(const int4& v, int i) {
  const int word = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return static_cast<float>(static_cast<int8_t>((word >> (8 * (i & 3))) & 0xff));
}

// The lane's chunks of pixel row `row`; chunks past C are left as zeros.
template <int kChunks>
__device__ __forceinline__ void load_row(int4 (&v)[kChunks], const int8_t* __restrict__ row,
                                         int lane, int c) {
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int base = (k * 32 + lane) * 16;
    v[k] = base < c ? __ldcs(reinterpret_cast<const int4*>(row + base)) : make_int4(0, 0, 0, 0);
  }
}

// Four codes, the first in the low byte.
__device__ __forceinline__ int pack4(int c0, int c1, int c2, int c3) {
  return static_cast<int>(__byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                                      0x5410));
}

template <int kChunks>
__global__ void __launch_bounds__(kThreads) l2norm_requant_kernel(
    const int8_t* __restrict__ x, const float* __restrict__ gamma, float out_scale,
    long long pixels, int c, int8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long pixel = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const float inv_s = __frcp_rn(out_scale);

  // The lane's gamma values, once for the walk.
  float g[kChunks][16];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int base = (k * 32 + lane) * 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = base < c ? reinterpret_cast<const float4*>(gamma + base)[j]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      g[k][4 * j] = f.x;
      g[k][4 * j + 1] = f.y;
      g[k][4 * j + 2] = f.z;
      g[k][4 * j + 3] = f.w;
    }
  }

  int4 cur[kChunks];
  if (pixel < pixels) load_row<kChunks>(cur, x + pixel * c, lane, c);  // warp-uniform
  for (; pixel < pixels; pixel += stride) {
    // The next pixel's chunks, in flight while this one is reduced and stored.
    int4 next[kChunks];
    if (pixel + stride < pixels) {
      load_row<kChunks>(next, x + (pixel + stride) * c, lane, c);
    } else {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) next[k] = make_int4(0, 0, 0, 0);
    }

    int ss = 0;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      ss = __dp4a(cur[k].x, cur[k].x, ss);
      ss = __dp4a(cur[k].y, cur[k].y, ss);
      ss = __dp4a(cur[k].z, cur[k].z, ss);
      ss = __dp4a(cur[k].w, cur[k].w, ss);
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, offset);
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__int2float_rn(ss), 1e-12f)));

    int8_t* out_row = out + pixel * c;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int base = (k * 32 + lane) * 16;
      if (base < c) {
        int q[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float y = __fmul_rn(__fmul_rn(code_of(cur[k], i), inv), g[k][i]);
          q[i] = quantize_code(y, out_scale, inv_s);
        }
        __stcs(reinterpret_cast<int4*>(out_row + base),
               make_int4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                         pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15])));
      }
      cur[k] = next[k];
    }
  }
}

template <int kChunks>
cudaError_t launch(const int8_t* x, const float* gamma, float out_scale, long long pixels, int c,
                   int8_t* out, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, l2norm_requant_kernel<kChunks>, kThreads, 0)) != cudaSuccess)
    return err;
  const long long needed = (pixels + kWarps - 1) / kWarps;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(needed < resident ? needed : resident);
  l2norm_requant_kernel<kChunks><<<blocks, kThreads, 0, stream>>>(x, gamma, out_scale, pixels, c,
                                                                   out);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int l2norm_requant(const int8_t* x, const float* gamma, float out_scale,
                              long long pixels, int c, int8_t* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((c + 511) / 512) {
    case 1: err = launch<1>(x, gamma, out_scale, pixels, c, out, s); break;
    case 2: err = launch<2>(x, gamma, out_scale, pixels, c, out, s); break;
    case 3: err = launch<3>(x, gamma, out_scale, pixels, c, out, s); break;
    case 4: err = launch<4>(x, gamma, out_scale, pixels, c, out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
