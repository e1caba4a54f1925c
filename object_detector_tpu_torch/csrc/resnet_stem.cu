// The ResNet stem in int8, fused: input quantize, 7x7/s2 pad-3 conv (3 -> 64)
// with int32 accumulation on the int8 tensor cores (mma.sync m16n8k32,
// csrc/int8_mma.cuh), acc * deq + bias, ReLU, requant, and the 3x3/s2 pad-1
// max pool on the codes.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/
// resnet_stem_pallas.py::_stem_kernel (:160, entry resnet_stem_int8 :334,
// pallas_call at :296). The TPU kernel's staged (16, W/4) input layout, its
// three lane-rolled copies, the (3, 128, 128) packed weights and the chunked
// im2col serve the TPU's tiles and matrix unit and are not carried over; the
// contract is the function, on NHWC tensors. This kernel reads the float
// image itself, so the quantized image never reaches device memory.
//
// Contract. images (B, H, W, 3) float32, H and W multiples of 4; wp the
// (7, 7, 3, 64) HWIO int8 kernel as the (192, 64) space-to-depth matrix below,
// its columns in the order the accumulators are read (column 8 nt + 2 t + i
// holds output channel 16 t + 2 nt + i), in the packed B layout of
// csrc/int8_mma.cuh (kernels/resnet_stem.py `pack_weights`); deq and bias
// (64,) float32; in_scale and out_scale float32.
//   x   = clip(rint(images / in_scale), -127, 127)
//   y   = max(conv7x7_s2_pad3(x, w).f32 * deq + bias, 0)
//   q   = clip(rint(y * (1.0f / out_scale)), -127, 127)
//   out = maxpool3x3_s2_pad1(q), (B, H/4, W/4, 64) int8
// Input pixels outside the image are zero codes; conv outputs outside the
// image are the pool's pad, -128.
//
// Space-to-depth. With the input zero-padded by 3, conv pixel (oy, ox) reads
// padded rows 2 oy + ky, ky < 7. Writing ky = 2 dy + py (dy < 4, py < 2) and
// the same for columns turns the 7x7/s2 conv over 3 channels into a 4x4/s1
// conv over the 12 channels (py, px, c) of the image's 2x2 phases, with the
// kernel zero-padded to 8x8: K = 4 x 4 x 12 = 192, six k32 steps and no
// padding waste, row k = 48 dy + 12 dx + 6 py + 3 px + c. In the phase patch
// a pixel's 12 bytes lie together, so its A row is four runs of 48 contiguous
// bytes, one per dy, and every A word is one aligned 32-bit shared load. The
// int32 sums are exact in any order, so the codes are those of the 7x7 conv.
//
// Bit-exactness. |acc| <= 147 * 127 * 128 < 2^22, so acc -> float is exact
// (by the 1.5 * 2^23 trick). The input quantize is a true divide, computed as
// the multiply by RN(1 / in_scale) wherever that cannot round to another code
// and as an IEEE divide within 2^-13 of a half-integer (csrc/int8_mma.cuh
// `quantize_code`, shared with the L2Norm). The requant multiplies by the
// float32 reciprocal of out_scale, taken once (__frcp_rn, then __fmul_rn), as
// the TPU kernel does; every other requant of the engine divides. Every
// operation rounds on its own (_rn intrinsics; the build passes -fmad=false
// too) and the rounding is half to even.
//
// What bounds it on an H100. At SSD-512 bs=64 the conv is
// 2 * 64 * 256 * 256 * 64 * 147 = 7.9e10 int8 operations, 0.040 ms at the
// tensor cores' 1,979e12 operations/s; the bytes (201 MB of float image in,
// 67 MB of codes out) take 0.080 ms at 3.35 TB/s. The bytes bound it. Beside
// them, every conv output pays an epilogue (about nine instructions a value,
// two of them half-rate min/max, on 294 M values at bs=64, 8% of them the
// tile's recomputed halo), each input value a quantize, and shared memory
// carries the A words, the B fragments (2 KB a k-step for each pair of m16
// tiles), the codes and the pool's reads. The first design ran the products
// as __dp4a on the CUDA cores: 1.76 ms at bs=64. This one takes 0.442 ms at
// bs=64 (5.5x its bound, 0.57x the same products as one torch._int_mm) and
// 0.0121 ms at bs=1 (chip_smoke.py, CUDA-graph replay, NVIDIA H100 80GB
// HBM3, 700.00 W); the epilogue is the largest part of it, then the pool and
// the quantize, and the tensor cores the smallest.
//
// Design. A persistent grid (two blocks of 256 threads an SM, 101,840 bytes
// of dynamic shared memory each) walks 8 x 16 tiles of pooled outputs. A
// tile needs the 17 x 33 conv outputs at rows 2 pr0 - 1 .. 2 pr0 + 15 and
// columns 2 pc0 - 1 .. 2 pc0 + 31, and those the 20 x 36 phase pixels, the
// 40 x 72 x 3 input patch. A block copies the 12,288 bytes of packed
// weights by cp.async once. For each tile it:
//  - quantizes the patch, staged as floats in shared memory, into the phase
//    layout, one phase pixel (12 codes, three 32-bit stores) a thread;
//  - starts the cp.async copy of the next tile's float patch (16 bytes a
//    copy, zero-filled outside the image), which lands while this tile is
//    computed;
//  - runs the conv as an implicit GEMM: M = 561 conv pixels in 36 m16 tiles
//    (pixel 16 mt + r, row-major in the tile), N = 64, K = 192. Warp w takes
//    m16 tiles w, w + 8, ... two at a time, so that each B fragment loaded
//    from shared memory feeds both. A thread's accumulators are 16
//    consecutive output channels of its two pixels (the column order of the
//    packed weights), so its epilogue reads deq and bias as float4s and
//    writes each pixel's 16 codes in one 16-byte shared store;
//  - pools: the per-byte maximum of 9 pixels' codes, 16 channels a thread,
//    three instructions a word (`max7x4`), and one 16-byte store to device
//    memory.
// Neither the quantized image nor the pre-pool codes reach device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace int8mma;

constexpr int kC = 64;                        // output channels
constexpr int kTileH = 8;                     // pooled rows per block
constexpr int kTileW = 16;                    // pooled columns per block
constexpr int kConvH = 2 * kTileH + 1;        // conv rows per block: 17
constexpr int kConvW = 2 * kTileW + 1;        // conv columns per block: 33
constexpr int kConvPix = kConvH * kConvW;     // 561
constexpr int kMTiles = (kConvPix + 15) / 16; // 36 m16 tiles
constexpr int kZH = kConvH + 3;               // phase rows: 20
constexpr int kZW = kConvW + 3;               // phase columns: 36
constexpr int kZStride = 448;                 // bytes per phase row (36 x 12, padded)
constexpr int kInH = 2 * kZH;                 // input rows per tile: 40
constexpr int kRawChunks = 55;                // 16-byte chunks per staged input row
constexpr int kRawRow = 4 * kRawChunks;       // floats per staged input row: 220
constexpr int kKSteps = 192 / kStepK;         // 6
constexpr int kWBytes = kKSteps * kStepBytes; // 12,288
constexpr int kCodeStride = 80;               // bytes per conv pixel's codes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kRawBytes = kInH * kRawRow * sizeof(float);  // 35,200
constexpr size_t kSmemBytes = kWBytes + kRawBytes + kZH * kZStride + kConvPix * kCodeStride +
                              2 * kC * sizeof(float);
constexpr float kMagic = 12582912.0f;         // 1.5 * 2^23

static_assert(kZW * 12 <= kZStride, "a phase row must fit its stride");

// Byte offset in the phase patch of 16-byte chunk j (< 12) of a pixel's A row.
__host__ __device__ constexpr int chunk_offset(int j) { return (j / 3) * kZStride + (j % 3) * 16; }

// float(a) for |a| < 2^22, exactly.
__device__ __forceinline__ float small_acc_to_float(int a) {
  return __fsub_rn(__int_as_float(0x4B400000 + a), kMagic);
}

// The code of one conv output as the low byte of the returned word:
// clip(rint(max(acc * deq + bias, 0) * inv), 0, 127) + 1.5 * 2^23, whose low
// byte is the code.
__device__ __forceinline__ unsigned code_bits(int acc, float deq, float bias, float inv) {
  const float y = fmaxf(__fadd_rn(__fmul_rn(small_acc_to_float(acc), deq), bias), 0.0f);
  return __float_as_uint(__fadd_rn(fminf(__fmul_rn(y, inv), 127.0f), kMagic));
}

// The per-byte maximum of two words of four codes in [0, 127]: per byte,
// a + 128 - b lies in [1, 255], so no borrow crosses a byte and its top bit
// says a >= b; prmt with selector 0xBA98 spreads that bit over its byte (the
// sign-replicating mode, which __byte_perm masks off). Three instructions,
// where __vmaxs4 is emulated in about seven.
__device__ __forceinline__ unsigned max7x4(unsigned a, unsigned b) {
  unsigned ge;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(ge) : "r"(a + 0x80808080u - b));
  return (a & ge) | (b & ~ge);
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// The conv of NT m16 tiles (conv pixels 16 mts[i] .. 16 mts[i] + 15 of the
// tile), then their epilogue into the shared codes.
template <int NT>
__device__ __forceinline__ void conv_tiles(const int (&mts)[NT], const int8_t* s_w,
                                           const int8_t* s_z, int8_t* s_codes,
                                           const float* s_deq, const float* s_bias, int lane,
                                           int cy0, int cx0, int ho, int wo, float inv_out) {
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int8_t* rows[NT][2];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      int p = mts[i] * 16 + gq + 8 * half;
      p = p < kConvPix ? p : 0;  // rows past the tile read pixel 0 and are not stored
      const int ly = p / kConvW;
      const int lx = p - ly * kConvW;
      rows[i][half] = s_z + ly * kZStride + lx * 12 + 4 * tq;
    }
  }
  int acc[NT][8][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][nt][r] = 0;
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    unsigned a[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      a[i][0] = lds32(rows[i][0] + chunk_offset(2 * s));
      a[i][1] = lds32(rows[i][1] + chunk_offset(2 * s));
      a[i][2] = lds32(rows[i][0] + chunk_offset(2 * s + 1));
      a[i][3] = lds32(rows[i][1] + chunk_offset(2 * s + 1));
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 b = load_pair(s_w + s * kStepBytes + q * kPairBytes, lane);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        mma_s8(acc[i][2 * q], a[i], b.x, b.y);
        mma_s8(acc[i][2 * q + 1], a[i], b.z, b.w);
      }
    }
  }
  // Epilogue: the thread's accumulators of n-tile nt, column 2 tq + c, are
  // output channel 16 tq + 2 nt + c of pixel gq (registers 0, 1) and gq + 8
  // (2, 3).
  const float4* deq4 = reinterpret_cast<const float4*>(s_deq + 16 * tq);
  const float4* bias4 = reinterpret_cast<const float4*>(s_bias + 16 * tq);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = mts[i] * 16 + gq + 8 * half;
      if (p >= kConvPix) continue;
      const int ly = p / kConvW;
      const int lx = p - ly * kConvW;
      const int cy = cy0 + ly;
      const int cx = cx0 + lx;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);  // the pool's pad (see the pool)
      if (cy >= 0 && cy < ho && cx >= 0 && cx < wo) {
        unsigned words[4];
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          const float4 d = deq4[w4];
          const float4 bb = bias4[w4];
          // n-tile 2 w4 holds channels 16 tq + 4 w4 and + 1, n-tile 2 w4 + 1 the next two.
          const unsigned c0 = code_bits(acc[i][2 * w4][2 * half], d.x, bb.x, inv_out);
          const unsigned c1 = code_bits(acc[i][2 * w4][2 * half + 1], d.y, bb.y, inv_out);
          const unsigned c2 = code_bits(acc[i][2 * w4 + 1][2 * half], d.z, bb.z, inv_out);
          const unsigned c3 = code_bits(acc[i][2 * w4 + 1][2 * half + 1], d.w, bb.w, inv_out);
          words[w4] = __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040), 0x5410);
        }
        v = make_uint4(words[0], words[1], words[2], words[3]);
      }
      *reinterpret_cast<uint4*>(s_codes + p * kCodeStride + 16 * tq) = v;
    }
  }
}

struct Tile {
  int b, pr0, pc0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_x, int tiles_per_image) {
  Tile r;
  r.b = t / tiles_per_image;
  const int i = t - r.b * tiles_per_image;
  r.pr0 = (i / tiles_x) * kTileH;
  r.pc0 = (i % tiles_x) * kTileW;
  return r;
}

// The tile's float input rows 4 pr0 - 5 .. 4 pr0 + 34 into s_raw by cp.async,
// 16 bytes a copy: staged float 4 q + e of row r is image float
// 12 pc0 - 16 + 4 q + e of the row, so patch float f (column 4 pc0 - 5 + f / 3)
// is staged float f + 1. An image row's floats start and end on 16-byte
// boundaries (W is a multiple of 4), so each copy lies wholly inside the image
// or wholly outside, where it is zero-filled (zero codes).
__device__ __forceinline__ void stage_raw(const float* __restrict__ images, const Tile& t,
                                          int h, int w, float* s_raw) {
  const unsigned dst0 = smem_addr(s_raw);
  for (int i = threadIdx.x; i < kInH * kRawChunks; i += kThreads) {
    const int r = i / kRawChunks;
    const int q = i - r * kRawChunks;
    const int y = 4 * t.pr0 - 5 + r;
    const int f0 = 12 * t.pc0 - 16 + 4 * q;
    const bool inside = y >= 0 && y < h && f0 >= 0 && f0 < 3 * w;
    const float* src = inside ? images + (static_cast<size_t>(t.b) * h + y) * w * 3 + f0 : images;
    cp_async16(dst0 + 16 * i, src, inside);
  }
}

__global__ void __launch_bounds__(kThreads, 2) resnet_stem_kernel(
    const float* __restrict__ images, const int8_t* __restrict__ wp,
    const float* __restrict__ deq, const float* __restrict__ bias, float in_scale,
    float out_scale, int batch, int h, int w, int8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int8_t* s_w = reinterpret_cast<int8_t*>(smem4);
  float* s_raw = reinterpret_cast<float*>(s_w + kWBytes);
  int8_t* s_z = reinterpret_cast<int8_t*>(s_raw) + kRawBytes;
  int8_t* s_codes = s_z + kZH * kZStride;
  float* s_deq = reinterpret_cast<float*>(s_codes + kConvPix * kCodeStride);
  float* s_bias = s_deq + kC;

  const int ho = h / 2, wo = w / 2;     // conv output size
  const int hp = h / 4, wpool = w / 4;  // pooled size
  const int tiles_x = (wpool + kTileW - 1) / kTileW;
  const int tiles_per_image = tiles_x * ((hp + kTileH - 1) / kTileH);
  const int tiles = batch * tiles_per_image;
  const float inv_in = __frcp_rn(in_scale);
  const float inv_out = __frcp_rn(out_scale);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // The packed weights and the two vectors once a block; the first tile's input.
  {
    const unsigned dst = smem_addr(s_w);
    for (int i = threadIdx.x; i < kWBytes / 16; i += kThreads) {
      cp_async16(dst + 16 * i, wp + 16 * i, true);
    }
    if (static_cast<int>(blockIdx.x) < tiles) {
      stage_raw(images, tile_of(blockIdx.x, tiles_x, tiles_per_image), h, w, s_raw);
    }
    cp_async_commit();
    if (threadIdx.x < kC) {
      s_deq[threadIdx.x] = deq[threadIdx.x];
      s_bias[threadIdx.x] = bias[threadIdx.x];
    }
  }

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile cur = tile_of(t, tiles_x, tiles_per_image);
    cp_async_wait<0>();
    __syncthreads();

    // The phase patch: phase pixel (zy, zx) holds input rows 2 zy, 2 zy + 1
    // (py), columns 2 zx, 2 zx + 1 (px), 3 channels, at byte 6 py + 3 px + c:
    // of staged row 2 zy + py, the 6 floats from 6 zx + 1.
    for (int i = threadIdx.x; i < kZH * kZW; i += kThreads) {
      const int zy = i / kZW;
      const int zx = i - zy * kZW;
      unsigned words[3];
#pragma unroll
      for (int py = 0; py < 2; ++py) {
        const float* src = s_raw + (2 * zy + py) * kRawRow + 6 * zx + 1;
        unsigned c[6];
#pragma unroll
        for (int e = 0; e < 6; ++e) c[e] = quantize_code(src[e], in_scale, inv_in) & 0xffu;
        // bytes 6 py .. 6 py + 5 of the pixel's 12
        if (py == 0) {
          words[0] = c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
          words[1] = c[4] | (c[5] << 8);
        } else {
          words[1] |= (c[0] << 16) | (c[1] << 24);
          words[2] = c[2] | (c[3] << 8) | (c[4] << 16) | (c[5] << 24);
        }
      }
      unsigned* dst = reinterpret_cast<unsigned*>(s_z + zy * kZStride + zx * 12);
      dst[0] = words[0];
      dst[1] = words[1];
      dst[2] = words[2];
    }
    __syncthreads();
    // The next tile's input, in flight while this one is computed.
    if (t + static_cast<int>(gridDim.x) < tiles) {
      stage_raw(images, tile_of(t + gridDim.x, tiles_x, tiles_per_image), h, w, s_raw);
    }
    cp_async_commit();

    // The conv and its epilogue: warp w takes m16 tiles w, w + 8, ..., two at a time.
    const int cy0 = 2 * cur.pr0 - 1;
    const int cx0 = 2 * cur.pc0 - 1;
    for (int mt = warp; mt < kMTiles; mt += 2 * kWarps) {
      if (mt + kWarps < kMTiles) {
        const int mts[2] = {mt, mt + kWarps};
        conv_tiles<2>(mts, s_w, s_z, s_codes, s_deq, s_bias, lane, cy0, cx0, ho, wo, inv_out);
      } else {
        const int mts[1] = {mt};
        conv_tiles<1>(mts, s_w, s_z, s_codes, s_deq, s_bias, lane, cy0, cx0, ho, wo, inv_out);
      }
    }
    __syncthreads();

    // The pool: pooled pixel (py, px) of the tile takes conv pixels
    // (2 py + dy, 2 px + dx), dy, dx < 3; 16 channels a thread. Conv pixels
    // outside the image hold 0, not -128: every code is >= 0 (the ReLU comes
    // before the requant), and every window holds its centre (2 pr, 2 pc),
    // which lies inside the image, so both pads give the same maximum.
    for (int i = threadIdx.x; i < kTileH * kTileW * 4; i += kThreads) {
      const int part = i & 3;
      const int p = i >> 2;
      const int py = p / kTileW;
      const int px = p - py * kTileW;
      const int pr = cur.pr0 + py;
      const int pc = cur.pc0 + px;
      if (pr >= hp || pc >= wpool) continue;
      uint4 m = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              s_codes + ((2 * py + dy) * kConvW + 2 * px + dx) * kCodeStride + 16 * part);
          m.x = max7x4(m.x, v.x);
          m.y = max7x4(m.y, v.y);
          m.z = max7x4(m.z, v.z);
          m.w = max7x4(m.w, v.w);
        }
      }
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(cur.b) * hp + pr) * wpool + pc) * kC +
                                16 * part) = m;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int resnet_stem(const float* images, const int8_t* wp, const float* deq,
                           const float* bias, float in_scale, float out_scale, int batch,
                           int h, int w, int8_t* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(resnet_stem_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resnet_stem_kernel, kThreads,
                                                           kSmemBytes)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = batch * ((h / 4 + kTileH - 1) / kTileH) * ((w / 4 + kTileW - 1) / kTileW);
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = tiles < resident ? tiles : resident;
  resnet_stem_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      images, wp, deq, bias, in_scale, out_scale, batch, h, w, out);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block takes, in bytes.
extern "C" int resnet_stem_smem_bytes() { return static_cast<int>(kSmemBytes); }
