// All of VGG block 1 in int8: conv1_1 (3x3 SAME, 3 -> 64) over the input
// codes, requant, conv1_2 (3x3 SAME, 64 -> 64), requant and the 2x2/s2 max
// pool, with int32 accumulation on the int8 tensor cores (mma.sync
// m16n8k32, csrc/int8_mma.cuh) and the engine's float32 epilogues.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/stem_pallas.py
// ::_stem_fp_kernel (:514, launched through stem_fused_producer :650,
// pallas_call at :687). The TPU kernel reads a 128-lane tap stack of the
// input (build_stem_x6), odd-pair-packed weights, a column-halo mask and a
// (row, pair, batch, channel) layout; those serve Mosaic's tiling and the
// TPU's matrix unit and are not carried over. A block here reads the
// 3-channel codes directly. The contract is the function, on NHWC codes.
//
// Contract. x_q (B, H, W, 3) int8 input codes, H and W even; w1 the (3, 3,
// 3, 64) HWIO conv1_1 kernel as a (32, 64) matrix, k = 3 * tap + cin for k <
// 27 and zero rows after, and w2 the (3, 3, 64, 64) conv1_2 kernel as a (576,
// 64) matrix, k = 64 * tap + cin, both in the packed B layout of
// csrc/int8_mma.cuh; deq1, bias1, deq2, bias2 (64,) float32; s1, s2 float32.
// With rq(v, s) = clip(rint(v / s), -127, 127):
//   q1  = rq(max(conv3x3_same(x_q, w1) * deq1 + bias1, 0), s1)
//   out = maxpool2x2(rq(max(conv3x3_same(q1, w2) * deq2 + bias2, 0), s2))
// (B, H/2, W/2, 64) int8. conv1_2's SAME padding reads zero codes: q1 is 0
// outside the image, not rq(relu(bias1)). The pool runs before the second
// requant, on the float values, which is exact: the requant is monotone.
//
// Bit-exactness. |acc1| <= 27 * 127^2 and |acc2| <= 576 * 127^2 are below
// 2^24, so acc -> float is exact, and int32 sums are exact in any order.
// Each epilogue rounds after every operation (__fmul_rn, __fadd_rn), divides
// by the scale and rounds half to even, as the engine's op-by-op requant
// does, in the exact form of csrc/int8_mma.cuh `requant2` (a multiply by RN(1
// / s) alone flips codes at rounding boundaries; there it divides). The
// build passes -fmad=false too.
//
// What bounds it on an H100. At SSD-300 bs=64 the two convs are
// 2 * (27 + 576) * 64 int8 operations a pixel over 5.76e6 pixels, 4.4e11,
// 0.22 ms at the tensor cores' 1,979e12 int8 operations/s; the bytes (17 MB
// of input codes in, 92 MB of pooled codes out) take 0.03 ms at 3.35 TB/s.
// The operations bound it. Beside the bound, every conv1_1 output pays a
// requant (20,736 a tile), a floor that the tile size sets.
//
// Design. A persistent grid (as many blocks as fit on the card) walks the
// 8 x 8 pooled tiles; a block stages both packed kernels and the four
// vectors in shared memory once, and loads the next tile's 20 x 20 input
// pixels into registers while it computes the current tile. Per tile:
//  - conv1_1 for the 18 x 18 pixels conv1_2 needs, as one k32 step: 21 m16
//    tiles of pixels by 8 n8 tiles, K = 27 padded to 32. A warp builds its
//    A fragment in registers from the staged input words (each a pixel's 3
//    codes and a zero byte) with __byte_perm, so no im2col buffer exists.
//    Pixels outside the image get 0.
//  - conv1_2, the pool and the requant as an implicit GEMM over the staged
//    conv1_1 codes, M = 256 pre-pool pixels, N = 64, K = 9 * 64: the stage
//    of csrc/conv12_pool.cuh, which B2 (csrc/stem.cu) runs on codes it
//    copies from device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv12_pool.cuh"
#include "int8_mma.cuh"

namespace {

using namespace int8mma;
using namespace conv12;

constexpr int kMidTiles = (kMidPix + 15) / 16;  // 21 m16 tiles
constexpr int kInX = kMid + 2;                  // input rows and columns, with halo: 20
constexpr int kXWords = kInX * kInX;            // 400
constexpr int kW1Bytes = kStepBytes;            // (32, 64) packed: one k-step
constexpr int kXPerThread = (kXWords + kThreads - 1) / kThreads;  // 2
constexpr size_t kSmemBytes = kW2Bytes + kW1Bytes + 4 * kC * sizeof(float) +
                              kMidPix * kMidStride + kOutBytes + kXWords * sizeof(int);

// Input pixel word k (< 400) of a tile: rows 2*pr0 - 2 .., columns 2*pc0 - 2
// .., 3 codes and a zero byte, zero outside the image (conv1_1's padding).
__device__ __forceinline__ int input_word(const int8_t* __restrict__ x_q, const Tile& t, int k,
                                         int h, int w) {
  const int y = 2 * t.pr0 - 2 + k / kInX;
  const int x = 2 * t.pc0 - 2 + k % kInX;
  if (y < 0 || y >= h || x < 0 || x >= w) return 0;
  const uint8_t* p =
      reinterpret_cast<const uint8_t*>(x_q + ((static_cast<size_t>(t.b) * h + y) * w + x) * 3);
  return static_cast<int>(p[0] | (p[1] << 8) | (p[2] << 16));
}

// Word j (0..7) of the 32-byte im2col row of mid pixel (my, mx): bytes
// 3 * tap + cin for the nine taps, then zeros. Word j spans taps a = j +
// j / 3 and a + 1; __byte_perm picks their bytes.
__device__ __forceinline__ unsigned im2col_word(const int* s_x, int my, int mx, int j) {
  if (j == 7) return 0u;
  const int a = j + j / 3;
  const unsigned lo = static_cast<unsigned>(s_x[(my + a / 3) * kInX + mx + a % 3]);
  const unsigned hi = a < 8 ? static_cast<unsigned>(s_x[(my + (a + 1) / 3) * kInX + mx + (a + 1) % 3])
                            : 0u;
  const int r = j % 3;
  return __byte_perm(lo, hi, r == 0 ? 0x4210 : (r == 1 ? 0x5421 : 0x6542));
}

__global__ void __launch_bounds__(kThreads, 2) stem_fp_kernel(
    const int8_t* __restrict__ x_q, const int8_t* __restrict__ w1p,
    const int8_t* __restrict__ w2p, const float* __restrict__ deq1,
    const float* __restrict__ bias1, float s1, const float* __restrict__ deq2,
    const float* __restrict__ bias2, float s2, int batch, int h, int w,
    int8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int8_t* s_w2 = reinterpret_cast<int8_t*>(smem4);
  int8_t* s_w1 = s_w2 + kW2Bytes;
  float* s_vec = reinterpret_cast<float*>(s_w1 + kW1Bytes);  // deq1, bias1, deq2, bias2
  int8_t* s_mid = reinterpret_cast<int8_t*>(s_vec + 4 * kC);
  int8_t* s_out = s_mid + kMidPix * kMidStride;
  int* s_x = reinterpret_cast<int*>(s_out + kOutBytes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int h2 = h / 2;
  const int w2 = w / 2;
  const int tiles_x = (w2 + kTile - 1) / kTile;
  const int tiles_per_image = tiles_x * ((h2 + kTile - 1) / kTile);
  const int tiles = batch * tiles_per_image;
  const float inv1 = __frcp_rn(s1), inv2 = __frcp_rn(s2);

  // Both kernels and the four vectors, once per block.
  {
    const unsigned dst = smem_addr(s_w2);
    for (int i = threadIdx.x; i < kW2Bytes / 16; i += kThreads) cp_async16(dst + 16 * i, w2p + 16 * i, true);
    const unsigned dst1 = smem_addr(s_w1);
    for (int i = threadIdx.x; i < kW1Bytes / 16; i += kThreads) cp_async16(dst1 + 16 * i, w1p + 16 * i, true);
    cp_async_commit();
    for (int i = threadIdx.x; i < kC; i += kThreads) {
      s_vec[i] = deq1[i];
      s_vec[kC + i] = bias1[i];
      s_vec[2 * kC + i] = deq2[i];
      s_vec[3 * kC + i] = bias2[i];
    }
  }

  int xw[kXPerThread];
  int t = blockIdx.x;
  if (t < tiles) {
    const Tile first = tile_of(t, tiles_x, tiles_per_image);
#pragma unroll
    for (int r = 0; r < kXPerThread; ++r) {
      const int k = threadIdx.x + r * kThreads;
      xw[r] = k < kXWords ? input_word(x_q, first, k, h, w) : 0;
    }
  }
  cp_async_wait<0>();

  for (; t < tiles; t += gridDim.x) {
    const Tile cur = tile_of(t, tiles_x, tiles_per_image);
#pragma unroll
    for (int r = 0; r < kXPerThread; ++r) {
      const int k = threadIdx.x + r * kThreads;
      if (k < kXWords) s_x[k] = xw[r];
    }
    __syncthreads();
    // The next tile's input, in flight while this one is computed.
    if (t + static_cast<int>(gridDim.x) < tiles) {
      const Tile next = tile_of(t + gridDim.x, tiles_x, tiles_per_image);
#pragma unroll
      for (int r = 0; r < kXPerThread; ++r) {
        const int k = threadIdx.x + r * kThreads;
        xw[r] = k < kXWords ? input_word(x_q, next, k, h, w) : 0;
      }
    }

    // conv1_1: m16 tile mt covers mid pixels 16 mt .. 16 mt + 15 (rows past
    // 323 read pixel 0 and are not stored).
    for (int mt = warp; mt < kMidTiles; mt += kWarps) {
      int row[2];
      unsigned a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        row[half] = mt * 16 + gq + 8 * half;
        const int p = row[half] < kMidPix ? row[half] : 0;
        const int my = p / kMid;
        const int mx = p - my * kMid;
        a[half] = im2col_word(s_x, my, mx, tq);
        a[2 + half] = im2col_word(s_x, my, mx, tq + 4);
      }
      int acc[8][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 b = load_pair(s_w1 + q * kPairBytes, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[2 * q][i] = acc[2 * q + 1][i] = 0;
        mma_s8(acc[2 * q], a, b.x, b.y);
        mma_s8(acc[2 * q + 1], a, b.z, b.w);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = row[half];
        if (p >= kMidPix) continue;
        const int my = p / kMid;
        const int mx = p - my * kMid;
        const int y = 2 * cur.pr0 - 1 + my;
        const int x = 2 * cur.pc0 - 1 + mx;
        const bool inside = y >= 0 && y < h && x >= 0 && x < w;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int ch = nt * 8 + 2 * tq;
          unsigned short v = 0;  // zero codes outside the image: conv1_2's SAME padding
          if (inside) {
            v = requant2(dequant(acc[nt][2 * half], s_vec[ch], s_vec[kC + ch]),
                     dequant(acc[nt][2 * half + 1], s_vec[ch + 1], s_vec[kC + ch + 1]), s1, inv1);
          }
          *reinterpret_cast<unsigned short*>(s_mid + p * kMidStride + ch) = v;
        }
      }
    }
    __syncthreads();

    // conv1_2 + pool + requant (csrc/conv12_pool.cuh), then the pooled
    // tile to device memory.
    conv_pool_tile(s_mid, s_w2, s_vec + 2 * kC, s_vec + 3 * kC, s2, inv2, s_out);
    __syncthreads();
    store_tile(s_out, out, cur, h2, w2);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int stem_fused_producer(const int8_t* x_q, const int8_t* w1p, const int8_t* w2p,
                                   const float* deq1, const float* bias1, float s1,
                                   const float* deq2, const float* bias2, float s2, int batch,
                                   int h, int w, int8_t* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_fp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_fp_kernel, kThreads,
                                                           kSmemBytes)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = batch * ((h / 2 + kTile - 1) / kTile) * ((w / 2 + kTile - 1) / kTile);
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = tiles < resident ? tiles : resident;
  stem_fp_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_q, w1p, w2p, deq1, bias1, s1, deq2, bias2, s2, batch, h, w, out);
  return static_cast<int>(cudaGetLastError());
}
