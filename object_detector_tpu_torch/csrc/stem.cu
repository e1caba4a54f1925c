// VGG block 1's tail in int8: conv1_2 (3x3 SAME, 64 -> 64) with int32
// accumulation, then acc * deq + bias, ReLU, requant and the 2x2/s2 max pool.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/stem_pallas.py
// ::_stem_kernel (:209, launched through conv12_pool_pair, pallas_call at
// :412). The TPU kernel's odd-pair lane packing, halo mask, band DMA and
// (row, pair, batch, channel) transposes serve the TPU's (8, 128) tiles and
// are not carried over; the contract is the function, on NHWC codes.
//
// Contract. q1 (B, H, W, 64) int8 conv1_1 codes, H and W even; w_words the
// (3, 3, 64, 64) HWIO int8 kernel regrouped as 32-bit words
// [ky*3+kx][cin/4][cout], each word holding 4 consecutive input channels
// (the operand of __dp4a); deq and bias (64,) float32; out_scale float32.
// out (B, H/2, W/2, 64) int8 =
//   maxpool2x2(clip(rint(max(acc * deq + bias, 0) / out_scale), -127, 127)),
// acc = the 3x3 conv over zero-padded codes. The pool runs before the
// requant, on the float values, which is exact: the requant is monotone.
//
// Bit-exactness. |acc| <= 576 * 127^2 < 2^24, so acc -> float is exact. The
// epilogue rounds after every operation (__fmul_rn, __fadd_rn), divides by
// out_scale (__fdiv_rn; a reciprocal multiply flips codes at rounding
// boundaries) and rounds half to even (rintf), as the reference's op-by-op
// requant does. The build passes -fmad=false too.
//
// What bounds it on an H100. At SSD-300 bs=64 the conv is
// 2 * 64 * 300 * 300 * 64 * 64 * 9 = 4.2e11 int8 operations, 0.21 ms at the
// tensor cores' 1,979e12 int8 operations/s; the bytes (369 MB of codes in,
// 92 MB out) take 0.14 ms at 3.35 TB/s. The operations bound it. This first
// kernel runs them as __dp4a on the CUDA cores, far below the tensor-core
// rate; an mma/wgmma version is later work.
//
// Design. The pre-pool conv1_2 output ((B, 300, 300, 64), 369 MB at bs=64)
// never reaches device memory: q1 is read once and the pooled codes are
// written once. Each block owns an 8 x 8 tile of pooled pixels of one image.
// It stages the (2*8+2) x (2*8+2) x 64 input tile with its zero halo and the
// 36,864-byte kernel in shared memory. Thread t owns pooled pixel t / 8 and
// output channels (t % 8) + 8j, j < 8: it keeps the four pre-pool int32 sums
// of each, 32 accumulators, and feeds them with __dp4a over 4-channel words.
// A warp reads 8 consecutive weight words (no bank conflict) and 4 pixels two
// columns apart; the 80-byte pixel stride in shared memory puts those 4 on
// distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                          // channels in and out
constexpr int kTile = 8;                        // pooled rows and columns per block
constexpr int kGroups = 8;                      // output-channel groups
constexpr int kPerThread = kC / kGroups;        // channels per thread
constexpr int kThreads = kTile * kTile * kGroups;  // 512
constexpr int kIn = 2 * kTile + 2;              // input tile rows and columns, with halo
constexpr int kWordsPerPixel = kC / 4;          // 16 words of 4 channels
constexpr int kPixelStride = 20;                // words per staged pixel (16 used)
constexpr int kWWords = 9 * kWordsPerPixel * kC;          // 9216 words
constexpr int kInWords = kIn * kIn * kPixelStride;        // 6480 words
constexpr size_t kSmemBytes = (kWWords + kInWords) * sizeof(int);

__global__ void __launch_bounds__(kThreads) stem_conv12_pool_kernel(
    const int8_t* __restrict__ q1, const int* __restrict__ w_words,
    const float* __restrict__ deq, const float* __restrict__ bias, float out_scale,
    int h, int w, int8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* s_w = reinterpret_cast<int*>(smem4);
  int* s_in = s_w + kWWords;

  const int b = blockIdx.z;
  const int h2 = h / 2;
  const int w2 = w / 2;
  const int pr0 = blockIdx.y * kTile;
  const int pc0 = blockIdx.x * kTile;

  const int4* w_src = reinterpret_cast<const int4*>(w_words);
  for (int i = threadIdx.x; i < kWWords / 4; i += kThreads) smem4[i] = w_src[i];

  // Input rows 2*pr0 - 1 .. 2*pr0 + 2*kTile and the same columns, zero
  // outside the image (conv1_2's SAME padding in codes).
  const int y0 = 2 * pr0 - 1;
  const int x0 = 2 * pc0 - 1;
  const int8_t* img = q1 + static_cast<size_t>(b) * h * w * kC;
  for (int i = threadIdx.x; i < kIn * kIn * 4; i += kThreads) {
    const int part = i & 3;
    const int pix = i >> 2;
    const int y = y0 + pix / kIn;
    const int x = x0 + pix % kIn;
    int4 v = make_int4(0, 0, 0, 0);
    if (y >= 0 && y < h && x >= 0 && x < w) {
      v = *reinterpret_cast<const int4*>(img + (static_cast<size_t>(y) * w + x) * kC + part * 16);
    }
    *reinterpret_cast<int4*>(s_in + pix * kPixelStride + part * 4) = v;
  }
  __syncthreads();

  const int g = threadIdx.x % kGroups;
  const int p = threadIdx.x / kGroups;
  const int py = p / kTile;
  const int px = p % kTile;

  int acc[4][kPerThread];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[q][j] = 0;
  }

  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const int* wk = s_w + (ky * 3 + kx) * kWordsPerPixel * kC + g;
      // Pre-pool position (2py + dy, 2px + dx) reads staged pixel
      // (2py + dy + ky, 2px + dx + kx).
      const int* in00 = s_in + ((2 * py + ky) * kIn + 2 * px + kx) * kPixelStride;
#pragma unroll 4
      for (int c4 = 0; c4 < kWordsPerPixel; ++c4) {
        const int a0 = in00[c4];
        const int a1 = in00[kPixelStride + c4];
        const int a2 = in00[kIn * kPixelStride + c4];
        const int a3 = in00[(kIn + 1) * kPixelStride + c4];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int wv = wk[c4 * kC + j * kGroups];
          acc[0][j] = __dp4a(a0, wv, acc[0][j]);
          acc[1][j] = __dp4a(a1, wv, acc[1][j]);
          acc[2][j] = __dp4a(a2, wv, acc[2][j]);
          acc[3][j] = __dp4a(a3, wv, acc[3][j]);
        }
      }
    }
  }

  const int pr = pr0 + py;
  const int pc = pc0 + px;
  if (pr >= h2 || pc >= w2) return;
  int8_t* o = out + ((static_cast<size_t>(b) * h2 + pr) * w2 + pc) * kC;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = j * kGroups + g;
    const float d = deq[c];
    const float bb = bias[c];
    float m = 0.0f;  // the ReLU floor; the max of the four ReLU'd values
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[q][j]), d), bb);
      m = fmaxf(m, y);
    }
    float code = rintf(__fdiv_rn(m, out_scale));
    code = fminf(fmaxf(code, -127.0f), 127.0f);
    o[c] = static_cast<int8_t>(static_cast<int>(code));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int stem_conv12_pool(const int8_t* q1, const int* w_words, const float* deq,
                                const float* bias, float out_scale, int batch, int h, int w,
                                int8_t* out, void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      stem_conv12_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((w / 2 + kTile - 1) / kTile, (h / 2 + kTile - 1) / kTile, batch);
  stem_conv12_pool_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q1, w_words, deq, bias, out_scale, h, w, out);
  return static_cast<int>(cudaGetLastError());
}
