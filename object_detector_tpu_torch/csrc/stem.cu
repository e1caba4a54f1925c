// VGG block 1's tail in int8: conv1_2 (3x3 SAME, 64 -> 64) with int32
// accumulation on the int8 tensor cores (mma.sync m16n8k32,
// csrc/int8_mma.cuh), then acc * deq + bias, ReLU, requant and the 2x2/s2
// max pool.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/stem_pallas.py
// ::_stem_kernel (:209, launched through conv12_pool_pair, pallas_call at
// :412). The TPU kernel's odd-pair lane packing, halo mask, band DMA and
// (row, pair, batch, channel) transposes serve the TPU's (8, 128) tiles and
// are not carried over; the contract is the function, on NHWC codes.
//
// Contract. q1 (B, H, W, 64) int8 conv1_1 codes, H and W even; w2p the (3,
// 3, 64, 64) HWIO conv1_2 kernel as a (576, 64) matrix, row 64 * tap + cin,
// in the packed B layout of csrc/int8_mma.cuh (kernels/stem.py
// `pack_weights`); deq and bias (64,) float32; out_scale float32.
// out (B, H/2, W/2, 64) int8 =
//   maxpool2x2(clip(rint(max(acc * deq + bias, 0) / out_scale), -127, 127)),
// acc = the 3x3 conv over zero-padded codes. The pool runs before the
// requant, on the float values, which is exact: the requant is monotone.
//
// Bit-exactness. |acc| <= 576 * 127^2 < 2^24, so acc -> float is exact and
// int32 sums are exact in any order. The epilogue rounds after every
// operation (__fmul_rn, __fadd_rn), divides by out_scale and rounds half to
// even, as the reference's op-by-op requant does, in the exact form of
// csrc/int8_mma.cuh `requant2` (a multiply by RN(1 / s), and an IEEE divide
// within 2^-13 of a half-integer). The build passes -fmad=false too.
//
// What bounds it on an H100. At SSD-300 bs=64 the conv is
// 2 * 64 * 300 * 300 * 64 * 64 * 9 = 4.2e11 int8 operations, 0.21 ms at the
// tensor cores' 1,979e12 int8 operations/s; the bytes (369 MB of codes in,
// 92 MB out) take 0.14 ms at 3.35 TB/s. The operations bound it, the bytes
// are close behind: q1 is read once (plus the halo of each tile, 27% more,
// mostly from L2) and the pre-pool output never reaches device memory.
//
// Design. B4's conv1_2 stage (csrc/conv12_pool.cuh, shared so that the two
// cannot drift apart) fed from device memory. A persistent grid (as many
// blocks as fit on the card, two an SM) walks the 8 x 8 pooled tiles; a
// block stages the packed kernel (36,864 bytes), deq and bias once. Per
// tile, its 18 x 18 conv1_1 pixels go into one of two shared-memory buffers
// at B4's 80-byte pixel stride by cp.async, 16 bytes a copy, while the
// other buffer's tile is computed; pixels outside the image are copied with
// a source size of 0, which fills zeros, the SAME padding. Then the shared
// stage: the implicit GEMM M = 256 x N = 64 x K = 576, the pool in
// registers and through lane ^ 4, requant2, 16-byte stores. A partial tile
// at the image's edge reads zeros past it and writes only its own pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv12_pool.cuh"
#include "int8_mma.cuh"

namespace {

using namespace int8mma;
using namespace conv12;

constexpr int kCopies = kMidPix * (kC / 16);    // 16-byte copies a tile: 1,296
constexpr int kMidBytes = kMidPix * kMidStride; // one buffer: 25,920
constexpr size_t kSmemBytes = kW2Bytes + 2 * kC * sizeof(float) + 2 * kMidBytes + kOutBytes;

// Tile t's 18 x 18 conv1_1 pixels (rows 2 pr0 - 1 .., columns 2 pc0 - 1 ..)
// into the buffer at shared address dst, asynchronously; zeros outside the
// image.
__device__ __forceinline__ void copy_tile(const int8_t* __restrict__ q1, const Tile& t, int h,
                                          int w, unsigned dst) {
  const int8_t* img = q1 + static_cast<size_t>(t.b) * h * w * kC;
  for (int i = threadIdx.x; i < kCopies; i += kThreads) {
    const int pix = i >> 2;
    const int part = i & 3;
    const int my = pix / kMid;
    const int y = 2 * t.pr0 - 1 + my;
    const int x = 2 * t.pc0 - 1 + pix - my * kMid;
    const bool inside = y >= 0 && y < h && x >= 0 && x < w;
    const int8_t* src = inside ? img + (static_cast<size_t>(y) * w + x) * kC + 16 * part : q1;
    cp_async16(dst + pix * kMidStride + 16 * part, src, inside);
  }
}

__global__ void __launch_bounds__(kThreads, 2) stem_conv12_pool_kernel(
    const int8_t* __restrict__ q1, const int8_t* __restrict__ w2p,
    const float* __restrict__ deq, const float* __restrict__ bias, float out_scale, int batch,
    int h, int w, int8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int8_t* s_w2 = reinterpret_cast<int8_t*>(smem4);
  float* s_vec = reinterpret_cast<float*>(s_w2 + kW2Bytes);  // deq, bias
  int8_t* s_mid = reinterpret_cast<int8_t*>(s_vec + 2 * kC);  // two buffers
  int8_t* s_out = s_mid + 2 * kMidBytes;

  const int h2 = h / 2;
  const int w2 = w / 2;
  const int tiles_x = (w2 + kTile - 1) / kTile;
  const int tiles_per_image = tiles_x * ((h2 + kTile - 1) / kTile);
  const int tiles = batch * tiles_per_image;
  const float inv = __frcp_rn(out_scale);

  // The kernel and the two vectors once per block, the first tile with them.
  {
    const unsigned dst = smem_addr(s_w2);
    for (int i = threadIdx.x; i < kW2Bytes / 16; i += kThreads) cp_async16(dst + 16 * i, w2p + 16 * i, true);
    for (int i = threadIdx.x; i < kC; i += kThreads) {
      s_vec[i] = deq[i];
      s_vec[kC + i] = bias[i];
    }
  }
  int t = blockIdx.x;
  if (t < tiles) copy_tile(q1, tile_of(t, tiles_x, tiles_per_image), h, w, smem_addr(s_mid));
  cp_async_commit();

  for (int buf = 0; t < tiles; t += gridDim.x, buf ^= 1) {
    // The next tile's copy goes into the other buffer, which the previous
    // iteration's compute has left (the barrier after it); it stays in
    // flight while this tile is computed. An empty group where there is none.
    const int next = t + gridDim.x;
    if (next < tiles) {
      copy_tile(q1, tile_of(next, tiles_x, tiles_per_image), h, w,
                smem_addr(s_mid + (buf ^ 1) * kMidBytes));
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this tile (and the kernel) have landed
    __syncthreads();
    conv_pool_tile(s_mid + buf * kMidBytes, s_w2, s_vec, s_vec + kC, out_scale, inv, s_out);
    __syncthreads();
    store_tile(s_out, out, tile_of(t, tiles_x, tiles_per_image), h2, w2);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int stem_conv12_pool(const int8_t* q1, const int8_t* w2p, const float* deq,
                                const float* bias, float out_scale, int batch, int h, int w,
                                int8_t* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_conv12_pool_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_conv12_pool_kernel,
                                                           kThreads, kSmemBytes)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = batch * ((h / 2 + kTile - 1) / kTile) * ((w / 2 + kTile - 1) / kTile);
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = tiles < resident ? tiles : resident;
  stem_conv12_pool_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q1, w2p, deq, bias, out_scale, batch, h, w, out);
  return static_cast<int>(cudaGetLastError());
}
