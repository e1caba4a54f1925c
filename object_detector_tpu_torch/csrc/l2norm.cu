// Int8 L2Norm + learned scale + requant over the channels of each pixel.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/l2norm_pallas.py
// ::_l2norm_kernel (:35, launched through l2norm_requant, pallas_call at :63).
//
// Contract. x (P, C) int8 codes, one row per pixel (the (B, H, W, C) tap
// flattened), C a multiple of 16 with C * 127^2 < 2^24; gamma (C,) float32;
// out_scale float32. out (P, C) int8 =
//   clip(rint(x * (1 / sqrt(sum_c x^2 + 1e-12)) * gamma / out_scale), -127, 127),
// with the products taken left to right. This is the reference's serving
// default, the unfolded jnp form of quant/engine.py:1242-1248 (times gamma,
// then divide by the scale); the TPU kernel folds gamma / out_scale and is
// allowed one code off on < 1e-3 of the elements against it.
//
// Bit-exactness. sum_c x^2 is an integer below 2^24, so it is exact in int32
// and in float32 in any order. The rest rounds after every operation with
// IEEE intrinsics (__fsqrt_rn, __fdiv_rn, __fmul_rn), divides by out_scale
// and rounds half to even (rintf), as the plain PyTorch version does.
//
// What bounds it on an H100. At SSD-300 bs=64 the tap is (64, 38, 38, 512):
// 47.3 MB read and 47.3 MB written, 0.028 ms at 3.35 TB/s. About 8 float32
// operations an element (0.38 G) take 0.011 ms at 33.5e12 non-FMA
// operations/s. The bytes bound it.
//
// Design. One warp per pixel. Each lane loads 16 codes with one 16-byte load
// per 512 channels, the squares are summed with __dp4a and a shuffle
// reduction, and the same registers are scaled, requantized and stored with
// one 16-byte store: device memory is read once and written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 4;  // 16-byte chunks a lane holds: C <= 2048

__device__ __forceinline__ int code_of(const int4& v, int i) {
  const int word = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return static_cast<int>(static_cast<int8_t>((word >> (8 * (i & 3))) & 0xff));
}

__global__ void __launch_bounds__(kThreads) l2norm_requant_kernel(
    const int8_t* __restrict__ x, const float* __restrict__ gamma, float out_scale,
    long long pixels, int c, int8_t* __restrict__ out) {
  const long long pixel = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pixel >= pixels) return;  // warp-uniform
  const int8_t* row = x + pixel * c;
  int8_t* out_row = out + pixel * c;

  int4 v[kMaxChunks];
  int ss = 0;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int base = (k * 32 + lane) * 16;
    if (base < c) {
      v[k] = *reinterpret_cast<const int4*>(row + base);
      ss = __dp4a(v[k].x, v[k].x, ss);
      ss = __dp4a(v[k].y, v[k].y, ss);
      ss = __dp4a(v[k].z, v[k].z, ss);
      ss = __dp4a(v[k].w, v[k].w, ss);
    }
  }
  for (int offset = 16; offset > 0; offset >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, offset);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__int2float_rn(ss), 1e-12f)));

#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int base = (k * 32 + lane) * 16;
    if (base < c) {
      int words[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float y = __fmul_rn(__fmul_rn(static_cast<float>(code_of(v[k], i)), inv),
                                  gamma[base + i]);
        float code = rintf(__fdiv_rn(y, out_scale));
        code = fminf(fmaxf(code, -127.0f), 127.0f);
        words[i / 4] |= (static_cast<int>(code) & 0xff) << (8 * (i % 4));
      }
      *reinterpret_cast<int4*>(out_row + base) = make_int4(words[0], words[1], words[2], words[3]);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int l2norm_requant(const int8_t* x, const float* gamma, float out_scale,
                              long long pixels, int c, int8_t* out, void* stream) {
  const long long blocks = (pixels + kWarps - 1) / kWarps;
  l2norm_requant_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, gamma, out_scale, pixels, c,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}
