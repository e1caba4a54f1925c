// All of VGG block 1 in int8: conv1_1 (3x3 SAME, 3 -> 64) over the input
// codes, requant, conv1_2 (3x3 SAME, 64 -> 64), requant and the 2x2/s2 max
// pool, with int32 accumulation and the engine's float32 epilogues.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/stem_pallas.py
// ::_stem_fp_kernel (:514, launched through stem_fused_producer :650,
// pallas_call at :687). The TPU kernel reads a 128-lane tap stack of the
// input (build_stem_x6), odd-pair-packed weights, a column-halo mask and a
// (row, pair, batch, channel) layout; those serve Mosaic's tiling and the
// TPU's matrix unit and are not carried over. A block here reads the
// 3-channel codes directly. The contract is the function, on NHWC codes.
//
// Contract. x_q (B, H, W, 3) int8 input codes, H and W even; w1_words the
// (3, 3, 3, 64) HWIO conv1_1 kernel as 32-bit words [ky*3+kx][j][cg], each
// holding input channels 0..2 of output channel 4*cg + j and a zero byte;
// w2_words the (3, 3, 64, 64) conv1_2 kernel as words [ky*3+kx][cin/4][cout]
// of 4 input channels (the layout of csrc/stem.cu); deq1, bias1, deq2, bias2
// (64,) float32; s1, s2 float32. With rq(v, s) = clip(rint(v / s), -127, 127):
//   q1  = rq(max(conv3x3_same(x_q, w1) * deq1 + bias1, 0), s1)
//   out = maxpool2x2(rq(max(conv3x3_same(q1, w2) * deq2 + bias2, 0), s2))
// (B, H/2, W/2, 64) int8. conv1_2's SAME padding reads zero codes: q1 is 0
// outside the image, not rq(relu(bias1)). The pool runs before the second
// requant, on the float values, which is exact: the requant is monotone.
//
// Bit-exactness. |acc1| <= 27 * 127^2 and |acc2| <= 576 * 127^2 are below
// 2^24, so acc -> float is exact. Each epilogue rounds after every operation
// (__fmul_rn, __fadd_rn), divides by the scale (__fdiv_rn; a reciprocal
// multiply flips codes at rounding boundaries) and rounds half to even
// (rintf), as the engine's op-by-op requant does. The build passes
// -fmad=false too.
//
// What bounds it on an H100. At SSD-300 bs=64 the two convs are
// 2 * (27 + 576) * 64 int8 operations a pixel over 5.76e6 pixels, 4.4e11,
// 0.22 ms at the tensor cores' 1,979e12 int8 operations/s; the bytes (17 MB
// of input codes in, 92 MB of pooled codes out) take 0.03 ms at 3.35 TB/s.
// The operations bound it. This first kernel runs them as __dp4a on the CUDA
// cores, far below the tensor-core rate; an mma/wgmma version is later work.
//
// Design. csrc/stem.cu's block with conv1_1 in front: neither conv1_1's
// output (369 MB of codes at bs=64, 1.47 GB as int32 sums) nor conv1_2's
// reaches device memory. Each block owns an 8 x 8 tile of pooled pixels of
// one image. It stages the 20 x 20 input pixels around the tile, each as one
// word (3 codes and a zero byte), and both kernels in shared memory; it
// computes conv1_1 for the 18 x 18 pixels conv1_2 needs (the tile and its
// one-pixel halo), 4 output channels a work item (9 __dp4a each), writing 0
// for pixels outside the image; then runs csrc/stem.cu's conv1_2 + pool
// loop on those codes. conv1_1 is under a tenth of conv1_2's work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                          // channels of conv1_1's output and conv1_2's
constexpr int kTile = 8;                        // pooled rows and columns per block
constexpr int kGroups = 8;                      // conv1_2 output-channel groups
constexpr int kPerThread = kC / kGroups;        // conv1_2 channels per thread
constexpr int kThreads = kTile * kTile * kGroups;  // 512
constexpr int kMid = 2 * kTile + 2;             // conv1_1 rows and columns, with halo
constexpr int kInX = kMid + 2;                  // input rows and columns, with halo
constexpr int kWordsPerPixel = kC / 4;          // 16 words of 4 channels
constexpr int kPixelStride = 20;                // words per staged conv1_1 pixel (16 used)
constexpr int kW2Words = 9 * kWordsPerPixel * kC;         // 9216 words
constexpr int kW1Words = 9 * 4 * kWordsPerPixel;          // 576 words
constexpr int kMidWords = kMid * kMid * kPixelStride;     // 6480 words
constexpr int kXWords = kInX * kInX;                      // 400 words
constexpr size_t kSmemBytes = (kW2Words + kMidWords + kW1Words + kXWords) * sizeof(int);

__device__ __forceinline__ float requant(int acc, float deq, float bias, float scale) {
  const float y = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), deq), bias), 0.0f);
  return fminf(fmaxf(rintf(__fdiv_rn(y, scale)), -127.0f), 127.0f);
}

__global__ void __launch_bounds__(kThreads) stem_fp_kernel(
    const int8_t* __restrict__ x_q, const int* __restrict__ w1_words,
    const int* __restrict__ w2_words, const float* __restrict__ deq1,
    const float* __restrict__ bias1, float s1, const float* __restrict__ deq2,
    const float* __restrict__ bias2, float s2, int h, int w, int8_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int* s_w2 = reinterpret_cast<int*>(smem4);
  int* s_mid = s_w2 + kW2Words;
  int* s_w1 = s_mid + kMidWords;
  int* s_x = s_w1 + kW1Words;

  const int b = blockIdx.z;
  const int h2 = h / 2;
  const int w2 = w / 2;
  const int pr0 = blockIdx.y * kTile;
  const int pc0 = blockIdx.x * kTile;

  const int4* w2_src = reinterpret_cast<const int4*>(w2_words);
  for (int i = threadIdx.x; i < kW2Words / 4; i += kThreads) smem4[i] = w2_src[i];
  for (int i = threadIdx.x; i < kW1Words; i += kThreads) s_w1[i] = w1_words[i];

  // Input rows 2*pr0 - 2 .. 2*pr0 + 2*kTile + 1 and the same columns, one
  // word a pixel, zero outside the image (conv1_1's SAME padding).
  const int iy0 = 2 * pr0 - 2;
  const int ix0 = 2 * pc0 - 2;
  const int8_t* img = x_q + static_cast<size_t>(b) * h * w * 3;
  for (int i = threadIdx.x; i < kXWords; i += kThreads) {
    const int y = iy0 + i / kInX;
    const int x = ix0 + i % kInX;
    int v = 0;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const uint8_t* p = reinterpret_cast<const uint8_t*>(img + (static_cast<size_t>(y) * w + x) * 3);
      v = static_cast<int>(p[0] | (p[1] << 8) | (p[2] << 16));
    }
    s_x[i] = v;
  }
  __syncthreads();

  // conv1_1 over rows 2*pr0 - 1 .. 2*pr0 + 2*kTile (the mid tile): mid pixel
  // (my, mx) reads staged input pixels (my + ky, mx + kx). A work item is one
  // pixel's 4 output channels 4*cg .. 4*cg + 3, packed into one word.
  for (int i = threadIdx.x; i < kMid * kMid * kWordsPerPixel; i += kThreads) {
    const int cg = i % kWordsPerPixel;
    const int pix = i / kWordsPerPixel;
    const int my = pix / kMid;
    const int mx = pix % kMid;
    const int y = 2 * pr0 - 1 + my;
    const int x = 2 * pc0 - 1 + mx;
    int word = 0;  // zero codes outside the image: conv1_2's SAME padding
    if (y >= 0 && y < h && x >= 0 && x < w) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int a = s_x[(my + ky) * kInX + mx + kx];
          const int* wt = s_w1 + (ky * 3 + kx) * 4 * kWordsPerPixel + cg;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = __dp4a(a, wt[j * kWordsPerPixel], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * cg + j;
        const int code = static_cast<int>(requant(acc[j], deq1[c], bias1[c], s1));
        word |= (code & 0xff) << (8 * j);
      }
    }
    s_mid[pix * kPixelStride + cg] = word;
  }
  __syncthreads();

  // conv1_2 + pool, as csrc/stem.cu. Thread t owns pooled pixel t / 8 and
  // output channels (t % 8) + 8j, j < 8, with the four pre-pool sums of each.
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
      const int* wk = s_w2 + (ky * 3 + kx) * kWordsPerPixel * kC + g;
      // Pre-pool position (2py + dy, 2px + dx) reads mid pixel
      // (2py + dy + ky, 2px + dx + kx).
      const int* in00 = s_mid + ((2 * py + ky) * kMid + 2 * px + kx) * kPixelStride;
#pragma unroll 4
      for (int c4 = 0; c4 < kWordsPerPixel; ++c4) {
        const int a0 = in00[c4];
        const int a1 = in00[kPixelStride + c4];
        const int a2 = in00[kMid * kPixelStride + c4];
        const int a3 = in00[(kMid + 1) * kPixelStride + c4];
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
    const float d = deq2[c];
    const float bb = bias2[c];
    float m = 0.0f;  // the ReLU floor; the max of the four ReLU'd values
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      m = fmaxf(m, __fadd_rn(__fmul_rn(__int2float_rn(acc[q][j]), d), bb));
    }
    const float code = fminf(fmaxf(rintf(__fdiv_rn(m, s2)), -127.0f), 127.0f);
    o[c] = static_cast<int8_t>(static_cast<int>(code));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int stem_fused_producer(const int8_t* x_q, const int* w1_words, const int* w2_words,
                                   const float* deq1, const float* bias1, float s1,
                                   const float* deq2, const float* bias2, float s2, int batch,
                                   int h, int w, int8_t* out, void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      stem_fp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((w / 2 + kTile - 1) / kTile, (h / 2 + kTile - 1) / kTile, batch);
  stem_fp_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_q, w1_words, w2_words, deq1, bias1, s1, deq2, bias2, s2, h, w, out);
  return static_cast<int>(cudaGetLastError());
}
