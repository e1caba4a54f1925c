// The ResNet stem in int8, fused: input quantize, 7x7/s2 pad-3 conv (3 -> 64)
// with int32 accumulation, acc * deq + bias, ReLU, requant, and the 3x3/s2
// pad-1 max pool on the codes.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/
// resnet_stem_pallas.py::_stem_kernel (:160, entry resnet_stem_int8 :334,
// pallas_call at :296). The TPU kernel's staged (16, W/4) input layout, its
// three lane-rolled copies, the (3, 128, 128) packed weights and the chunked
// im2col serve the TPU's tiles and matrix unit and are not carried over; the
// contract is the function, on NHWC tensors. This kernel reads the float
// image itself, so the quantized image never reaches device memory.
//
// Contract. images (B, H, W, 3) float32, H and W multiples of 4; w_words the
// (7, 7, 3, 64) HWIO int8 kernel regrouped as 32-bit words [ky][j][cout],
// j < 6: bytes 4j .. 4j+3 of kernel row ky for that output channel, a row
// being its 21 (kx, cin) bytes and 3 zero bytes (the operand of __dp4a); deq
// and bias (64,) float32; in_scale and out_scale float32.
//   x   = clip(rint(images / in_scale), -127, 127)
//   y   = max(conv7x7_s2_pad3(x, w).f32 * deq + bias, 0)
//   q   = clip(rint(y * (1.0f / out_scale)), -127, 127)
//   out = maxpool3x3_s2_pad1(q), (B, H/4, W/4, 64) int8
// Input pixels outside the image are zero codes; conv outputs outside the
// image are the pool's pad, -128.
//
// Bit-exactness. |acc| <= 147 * 127^2 < 2^24, so acc -> float is exact. The
// input quantize is a true divide (__fdiv_rn). The requant multiplies by the
// float32 reciprocal of out_scale, taken once (__fdiv_rn(1, s), then
// __fmul_rn), as the TPU kernel does; every other requant of the engine
// divides. Every operation rounds on its own (_rn intrinsics; the build passes
// -fmad=false too) and the rounding is half to even (rintf).
//
// What bounds it on an H100. At SSD-512 bs=64 the conv is
// 2 * 64 * 256 * 256 * 64 * 147 = 7.9e10 int8 operations, 0.040 ms at the
// tensor cores' 1,979e12 operations/s; the bytes (201 MB of float image in,
// 67 MB of codes out) take 0.080 ms at 3.35 TB/s. The bytes bound it. This
// first kernel runs the products as __dp4a on the CUDA cores and is bound by
// those instead; a tensor-core version is later work.
//
// Design. One block per 8 x 8 tile of pooled outputs of one image. The tile
// needs the 17 x 17 conv outputs at rows 2*pr0 - 1 .. 2*pr0 + 15 (and the
// same columns), and those the 39 x 39 x 3 input patch at rows
// 4*pr0 - 5 .. 4*pr0 + 33. The block quantizes the patch into shared memory
// (rows of 117 bytes in a 120-byte stride), holds the 10,752 bytes of weight
// words in shared memory, and gives conv pixel t to thread t < 289: 7 kernel
// rows x 6 words against all 64 output channels, in two passes of 32
// accumulators. A conv pixel's 21 row bytes start at byte 6 * lx of the patch
// row, which is 2 bytes past a word for odd lx; the thread reads 7 aligned
// words and shifts (__funnelshift_r). All threads of a warp read the same
// weight words (a broadcast). The codes go to shared memory ([pixel][64] with
// a 68-byte stride) and the pool takes the per-byte maximum (__vmaxs4) of 9
// of them for 4 channels at a time. Neither the quantized image nor the
// pre-pool codes reach device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                 // output channels
constexpr int kTile = 8;               // pooled rows and columns per block
constexpr int kConv = 2 * kTile + 1;   // conv rows and columns per block: 17
constexpr int kPatch = 4 * kTile + 7;  // input rows and columns per block: 39
constexpr int kRowBytes = kPatch * 3;  // 117
constexpr int kRowStride = 120;        // bytes per staged patch row
constexpr int kRowWords = kRowStride / 4;
constexpr int kKernel = 7;
constexpr int kWordsPerRow = 6;        // 21 kernel-row bytes padded to 24
constexpr int kWWords = kKernel * kWordsPerRow * kC;  // 2688 words
constexpr int kPatchWords = kPatch * kRowWords + 2;   // one word read past the last row
constexpr int kCodeStride = kC / 4 + 1;               // words per conv pixel's codes: 17
constexpr int kCodeWords = kConv * kConv * kCodeStride;
constexpr int kThreads = 320;          // 289 conv pixels, rounded up to warps
constexpr int kPass = 32;              // output channels per pass

__global__ void __launch_bounds__(kThreads) resnet_stem_kernel(
    const float* __restrict__ images, const int* __restrict__ w_words,
    const float* __restrict__ deq, const float* __restrict__ bias, float in_scale,
    float out_scale, int h, int w, int8_t* __restrict__ out) {
  __shared__ int4 s_w4[kWWords / 4];
  __shared__ int s_patch[kPatchWords];
  __shared__ int s_codes[kCodeWords];
  const int* s_w = reinterpret_cast<const int*>(s_w4);

  const int b = blockIdx.z;
  const int pr0 = blockIdx.y * kTile;
  const int pc0 = blockIdx.x * kTile;
  const int ho = h / 2, wo = w / 2;  // conv output size
  const int hp = h / 4, wp = w / 4;  // pooled size

  const int4* w_src = reinterpret_cast<const int4*>(w_words);
  for (int i = threadIdx.x; i < kWWords / 4; i += kThreads) s_w4[i] = w_src[i];

  // The patch: input rows 4*pr0 - 5 .. 4*pr0 + 33 and the same columns,
  // quantized; zero codes outside the image and in the stride's last bytes.
  const int y0 = 4 * pr0 - 5;
  const int xb0 = (4 * pc0 - 5) * 3;  // first byte (column * 3 + channel) of a patch row
  const float* img = images + static_cast<size_t>(b) * h * w * 3;
  int8_t* patch_bytes = reinterpret_cast<int8_t*>(s_patch);
  for (int i = threadIdx.x; i < kPatchWords * 4; i += kThreads) {
    const int row = i / kRowStride;
    const int col = i - row * kRowStride;
    const int y = y0 + row;
    const int xb = xb0 + col;
    float code = 0.0f;
    if (row < kPatch && col < kRowBytes && y >= 0 && y < h && xb >= 0 && xb < w * 3) {
      code = rintf(__fdiv_rn(img[static_cast<size_t>(y) * w * 3 + xb], in_scale));
      code = fminf(fmaxf(code, -127.0f), 127.0f);
    }
    patch_bytes[i] = static_cast<int8_t>(static_cast<int>(code));
  }
  __syncthreads();

  // The conv: thread t owns conv pixel (t / 17, t % 17) of the tile.
  const int t = threadIdx.x;
  if (t < kConv * kConv) {
    const int ly = t / kConv;
    const int lx = t - ly * kConv;
    const int cy = 2 * pr0 - 1 + ly;
    const int cx = 2 * pc0 - 1 + lx;
    int* codes = s_codes + t * kCodeStride;
    if (cy < 0 || cy >= ho || cx < 0 || cx >= wo) {
      // Outside the image: the pool's pad.
#pragma unroll
      for (int j = 0; j < kC / 4; ++j) codes[j] = static_cast<int>(0x80808080u);
    } else {
      const float inv = __fdiv_rn(1.0f, out_scale);
      const int first = (6 * lx) >> 2;        // first aligned word of the row's bytes
      const int shift = ((6 * lx) & 3) * 8;   // 0 or 16 bits
      for (int pass = 0; pass < kC / kPass; ++pass) {
        int acc[kPass];
#pragma unroll
        for (int j = 0; j < kPass; ++j) acc[j] = 0;
        for (int ky = 0; ky < kKernel; ++ky) {
          const int* row = s_patch + (2 * ly + ky) * kRowWords + first;
          int a[kWordsPerRow + 1];
#pragma unroll
          for (int i = 0; i <= kWordsPerRow; ++i) a[i] = row[i];
#pragma unroll
          for (int i = 0; i < kWordsPerRow; ++i) {
            const int av = __funnelshift_r(a[i], a[i + 1], shift);
            const int4* wk = reinterpret_cast<const int4*>(
                s_w + (ky * kWordsPerRow + i) * kC + pass * kPass);
#pragma unroll
            for (int j4 = 0; j4 < kPass / 4; ++j4) {
              const int4 wv = wk[j4];
              acc[4 * j4 + 0] = __dp4a(av, wv.x, acc[4 * j4 + 0]);
              acc[4 * j4 + 1] = __dp4a(av, wv.y, acc[4 * j4 + 1]);
              acc[4 * j4 + 2] = __dp4a(av, wv.z, acc[4 * j4 + 2]);
              acc[4 * j4 + 3] = __dp4a(av, wv.w, acc[4 * j4 + 3]);
            }
          }
        }
#pragma unroll
        for (int j4 = 0; j4 < kPass / 4; ++j4) {
          unsigned word = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = pass * kPass + 4 * j4 + k;
            float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j4 + k]), deq[c]), bias[c]);
            y = fmaxf(y, 0.0f);
            float code = rintf(__fmul_rn(y, inv));
            code = fminf(fmaxf(code, -127.0f), 127.0f);
            word |= (static_cast<unsigned>(static_cast<int>(code)) & 0xffu) << (8 * k);
          }
          codes[pass * (kPass / 4) + j4] = static_cast<int>(word);
        }
      }
    }
  }
  __syncthreads();

  // The pool: pooled pixel (py, px) takes conv pixels (2py + dy, 2px + dx),
  // dy, dx < 3, of the tile (the tile's first conv row is 2*pr0 - 1).
  for (int i = threadIdx.x; i < kTile * kTile * (kC / 4); i += kThreads) {
    const int j = i % (kC / 4);
    const int p = i / (kC / 4);
    const int py = p / kTile;
    const int px = p - py * kTile;
    const int pr = pr0 + py;
    const int pc = pc0 + px;
    if (pr >= hp || pc >= wp) continue;
    unsigned m = 0x80808080u;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int q = (2 * py + dy) * kConv + 2 * px + dx;
        m = __vmaxs4(m, static_cast<unsigned>(s_codes[q * kCodeStride + j]));
      }
    }
    int* o = reinterpret_cast<int*>(out + ((static_cast<size_t>(b) * hp + pr) * wp + pc) * kC);
    o[j] = static_cast<int>(m);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int resnet_stem(const float* images, const int* w_words, const float* deq,
                           const float* bias, float in_scale, float out_scale, int batch,
                           int h, int w, int8_t* out, void* stream) {
  const dim3 grid((w / 4 + kTile - 1) / kTile, (h / 4 + kTile - 1) / kTile, batch);
  resnet_stem_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      images, w_words, deq, bias, in_scale, out_scale, h, w, out);
  return static_cast<int>(cudaGetLastError());
}
