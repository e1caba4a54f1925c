// VGG block 1's conv1_2 + requant + 2x2/s2 max pool of one 8 x 8 tile of
// pooled pixels, on the int8 tensor cores: the stage that csrc/stem.cu (B2,
// which reads conv1_1's codes from device memory) and csrc/stem_fp.cu (B4,
// which computes them itself) share, so the two kernels cannot drift apart.
//
// A block of 256 threads (8 warps) holds in shared memory:
//  - s_mid: conv1_1's codes of the tile's 18 x 18 pixels (pre-pool rows
//    2 pr0 - 1 .. 2 pr0 + 16, columns likewise), kMidStride bytes a pixel,
//    zero codes outside the image (conv1_2's SAME padding);
//  - s_w2: the (576, 64) conv1_2 kernel, row 64 * tap + cin, in the packed
//    B layout of csrc/int8_mma.cuh (18 k-steps);
//  - deq2 and bias2, 64 floats each.
//
// conv1_2 is an implicit GEMM over s_mid, M = 256 pre-pool pixels, N = 64,
// K = 9 * 64: warp w owns pooled row w, as two m16 tiles of two pre-pool rows
// by 8 columns, by all 8 n8 tiles. Row r of an m16 tile is pre-pool row r /
// 8, column r % 8, so accumulator registers c[0], c[2] of a thread are
// vertical neighbours (the vertical max stays in the thread) and lane ^ 4
// holds the horizontal neighbour (one __shfl_xor_sync). The two lanes of a
// pair then requant one channel each (requant2, the exact form) into s_out,
// the tile's pooled codes, which leave in 16-byte stores. The pool runs
// before the requant, on the float values, which is exact: the requant is
// monotone. 80 bytes a pixel keep ldmatrix's eight row addresses on distinct
// banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace conv12 {

using namespace int8mma;

constexpr int kC = 64;                          // channels of conv1_1's output and conv1_2's
constexpr int kTile = 8;                        // pooled rows and columns per tile
constexpr int kMid = 2 * kTile + 2;             // conv1_1 rows and columns, with halo: 18
constexpr int kMidPix = kMid * kMid;            // 324
constexpr int kMidStride = kC + 16;             // bytes per staged conv1_1 pixel
constexpr int kW2Bytes = 18 * kStepBytes;       // (576, 64) packed: 18 k-steps
constexpr int kOutBytes = kTile * kTile * kC;   // 4,096
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;           // 8, one per pooled row

struct Tile {
  int b, pr0, pc0;
};

// Tile t of a batch walked image by image, rows of tiles, then columns.
__device__ __forceinline__ Tile tile_of(int t, int tiles_x, int tiles_per_image) {
  Tile r;
  r.b = t / tiles_per_image;
  const int i = t - r.b * tiles_per_image;
  r.pr0 = (i / tiles_x) * kTile;
  r.pc0 = (i % tiles_x) * kTile;
  return r;
}

// conv1_2, the pool and the requant of one tile, s_mid -> s_out (pooled
// pixel p's 64 codes at byte 64 p). Every warp of the block calls it.
__device__ __forceinline__ void conv_pool_tile(const int8_t* s_mid, const int8_t* s_w2,
                                               const float* s_deq2, const float* s_bias2,
                                               float s2, float inv2, int8_t* s_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int r = lane & 15;
  unsigned base[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    base[j] = smem_addr(s_mid + ((2 * warp + (r >> 3)) * kMid + 8 * j + (r & 7)) * kMidStride) +
              16 * (lane >> 4);
  }
  int acc[2][8][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0;
#pragma unroll 2
  for (int s = 0; s < 18; ++s) {
    const int tap = s >> 1;
    const unsigned off = ((tap / 3) * kMid + tap % 3) * kMidStride + (s & 1) * kStepK;
    unsigned a[2][4];
    ldmatrix_x4(a[0], base[0] + off);
    ldmatrix_x4(a[1], base[1] + off);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 b = load_pair(s_w2 + s * kStepBytes + q * kPairBytes, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma_s8(acc[j][2 * q], a[j], b.x, b.y);
        mma_s8(acc[j][2 * q + 1], a[j], b.z, b.w);
      }
    }
  }
  // Vertical max in the thread, horizontal with lane ^ 4; then the pair's
  // even lane requants channel ch, the odd one ch + 1, of both m16 tiles
  // (the ReLU floor is the requant's).
  const int odd = gq & 1;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int ch = nt * 8 + 2 * tq;
    const float d0 = s_deq2[ch], d1 = s_deq2[ch + 1];
    const float b0 = s_bias2[ch], b1 = s_bias2[ch + 1];
    float m[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int* c = acc[j][nt];
      float v0 = fmaxf(dequant(c[0], d0, b0), dequant(c[2], d0, b0));
      float v1 = fmaxf(dequant(c[1], d1, b1), dequant(c[3], d1, b1));
      v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
      v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
      m[j] = odd ? v1 : v0;
    }
    const unsigned short codes = requant2(m[0], m[1], s2, inv2);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s_out[(warp * kTile + 4 * j + (gq >> 1)) * kC + ch + odd] =
          static_cast<int8_t>(codes >> (8 * j));
    }
  }
}

// The pooled tile to device memory, 16 bytes a thread; pixels past the
// image's pooled size (a partial tile) are not written.
__device__ __forceinline__ void store_tile(const int8_t* s_out, int8_t* __restrict__ out,
                                          const Tile& t, int h2, int w2) {
  const int px = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int pr = t.pr0 + px / kTile;
  const int pc = t.pc0 + px % kTile;
  if (pr < h2 && pc < w2) {
    *reinterpret_cast<int4*>(out + ((static_cast<size_t>(t.b) * h2 + pr) * w2 + pc) * kC +
                             16 * part) = *reinterpret_cast<const int4*>(s_out + px * kC + 16 * part);
  }
}

}  // namespace conv12
