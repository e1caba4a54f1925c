// A stride-1 ResNet bottleneck in int8 as one kernel: 1x1 conv -> 3x3 SAME
// conv -> 1x1 conv plus the residual, each with int32 accumulation, dequant,
// bias, ReLU and requant. Both intermediates stay in shared memory.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/
// bottleneck_pallas.py::_bottleneck_kernel (:75, entry fused_bottleneck :147,
// pallas_call at :188). The TPU kernel walks row bands with one-row halo
// blocks and holds all three kernels in its fast memory; neither is carried
// over (the widest block's kernels are 4.4 MB against 227 KB of shared
// memory). The contract is the function, on NHWC codes.
//
// Contract. x (B, H, W, C) int8; w1, w2, w3 the (C, Cm), (3, 3, Cm, Cm) and
// (Cm, C) int8 kernels regrouped as 32-bit words [k / 4][n] (w2: [tap][k / 4]
// [n]), each word holding 4 consecutive input channels k of output channel n
// (the operand of __dp4a); deq* and bias* float32 per output channel; s1, s2,
// s3, resid_scale float32. C and Cm are multiples of 16.
//   mid1 = rq(max(x . w1 * deq1 + bias1, 0), s1)
//   mid2 = rq(max(conv3x3_same(mid1, w2) * deq2 + bias2, 0), s2)
//   out  = rq(max(mid2 . w3 * deq3 + bias3 + float(x) * resid_scale, 0), s3)
//   rq(y, s) = clip(rint(y / s), -127, 127)
// The 3x3's SAME padding is zero codes of mid1: a tile computes conv1 on its
// halo pixels and writes 0 for those that lie outside the image.
//
// Bit-exactness. The sums are exact in int32; acc -> float rounds to nearest
// even where |acc| >= 2^24, as a cast does. The epilogue rounds after every
// operation (__fmul_rn, __fadd_rn; the residual product is rounded before it
// is added), divides by the scale (__fdiv_rn) and rounds half to even
// (rintf), as the engine's op-by-op requant does. The build passes
// -fmad=false too.
//
// What bounds it on an H100. Each of the four shapes of ResNet-50 at SSD-512
// bs=64 needs 34 * Cm^2 int8 operations a pixel, 1.46e11 a launch, 0.074 ms
// at the tensor cores' 1,979e12 operations/s; x read once and the output
// written once take 0.160, 0.080, 0.040 and 0.020 ms at 3.35 TB/s. Stage 1 is
// bound by bytes, stages 3 and 4 by operations. This first kernel runs the
// products as __dp4a on the CUDA cores and is bound by those instead; a
// tensor-core version is later work.
//
// Design. One block of 256 threads per image and 8 x 8 spatial tile. Each of
// the three convs is a product A (pixels x K, int8 rows in shared memory) by
// W (K x N words), computed in passes of up to 128 output channels and
// chunks of up to 256 input channels; a chunk's weights are staged from
// device memory (they stay in the 50 MB L2) into shared memory, and for conv1
// so are the same channels of the tile's 10 x 10 halo pixels of x. A thread
// owns a unit of 4 pixels by 8 output channels (32 accumulators; conv1's 100
// pixels make up to 400 units, so it keeps two), reads 16 input channels of
// each pixel as one 16-byte load and the matching weight words as 16-byte
// loads that the lanes of a warp share or read from consecutive addresses
// (a unit's 8 channels are two runs of 4, half a pass apart, for that), and
// runs 128 __dp4a on them. conv1 writes mid1 (10 x 10 x Cm, zero outside
// the image) to shared memory, conv2 reads it at the nine taps and writes
// mid2 (8 x 8 x Cm), conv3 reads mid2, adds the residual from x and writes
// the output. Activation rows carry 16 bytes of padding so that the pixels of
// a warp fall on different banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;                      // output rows and columns per block
constexpr int kHalo = kTile + 2;              // with the 3x3's halo
constexpr int kHaloPix = kHalo * kHalo;       // 100
constexpr int kTilePix = kTile * kTile;       // 64
constexpr int kThreads = 256;
constexpr int kKc = 256;                      // input channels per staged chunk
constexpr int kNc = 128;                      // output channels per pass
constexpr int kP = 4;                         // pixels per unit
constexpr int kQ = 8;                         // output channels per unit
constexpr int kRowPad = 16;                   // bytes of padding per activation row
constexpr int kWBytes = (kKc / 4) * kNc * 4;  // staged weight chunk: 32,768
constexpr int kXStride = kKc + kRowPad;       // staged x row: 272
constexpr int kXBytes = kHaloPix * kXStride;  // 27,200

struct Args {
  const int8_t* x;
  const int* w1;
  const int* w2;
  const int* w3;
  const float* deq1;
  const float* bias1;
  const float* deq2;
  const float* bias2;
  const float* deq3;
  const float* bias3;
  float s1, s2, s3, resid_scale;
  int h, w, c, cm;
  int8_t* out;
};

// Copies `rows` rows of `nc` words from a [k / 4][n] weight array (row stride
// `n` words, `src` at the chunk's first word) into s_w (row stride kNc).
__device__ __forceinline__ void stage_weights(int* s_w, const int* __restrict__ src, int n,
                                              int rows, int nc) {
  const int vecs = nc / 4;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int v = i - r * vecs;
    *reinterpret_cast<int4*>(s_w + r * kNc + 4 * v) =
        __ldg(reinterpret_cast<const int4*>(src + static_cast<size_t>(r) * n + 4 * v));
  }
}

// acc[p][q] += sum over kc input channels of a[p][k] * W[k][channel q of
// group ng], the weights staged in s_w. A unit's channels are 4 * ng + q for
// q < 4 and half + 4 * ng + (q - 4) after, in the pass's numbering.
__device__ __forceinline__ void mac_chunk(int (&acc)[kP][kQ], const int8_t* const (&a)[kP],
                                          int kc, const int* s_w, int ng, int half) {
  for (int k = 0; k < kc; k += 16) {
    int av[kP][4];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int4 v = *reinterpret_cast<const int4*>(a[p] + k);
      av[p][0] = v.x;
      av[p][1] = v.y;
      av[p][2] = v.z;
      av[p][3] = v.w;
    }
    const int* wrow = s_w + (k >> 2) * kNc + 4 * ng;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int4 w0 = *reinterpret_cast<const int4*>(wrow + kk * kNc);
      const int4 w1 = *reinterpret_cast<const int4*>(wrow + kk * kNc + half);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int v = av[p][kk];
        acc[p][0] = __dp4a(v, w0.x, acc[p][0]);
        acc[p][1] = __dp4a(v, w0.y, acc[p][1]);
        acc[p][2] = __dp4a(v, w0.z, acc[p][2]);
        acc[p][3] = __dp4a(v, w0.w, acc[p][3]);
        acc[p][4] = __dp4a(v, w1.x, acc[p][4]);
        acc[p][5] = __dp4a(v, w1.y, acc[p][5]);
        acc[p][6] = __dp4a(v, w1.z, acc[p][6]);
        acc[p][7] = __dp4a(v, w1.w, acc[p][7]);
      }
    }
  }
}

// The engine's requant epilogue for one value, as a code in the low byte.
__device__ __forceinline__ unsigned requant(int acc, float deq, float bias, float extra,
                                            bool has_extra, float scale) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), deq), bias);
  if (has_extra) y = __fadd_rn(y, extra);
  y = fmaxf(y, 0.0f);
  float code = rintf(__fdiv_rn(y, scale));
  code = fminf(fmaxf(code, -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(code)) & 0xffu;
}

// The first channel (in the conv's numbering) of a unit's run `run` (0 or 1).
__device__ __forceinline__ int run_channel(int n0, int ng, int groups, int run) {
  return n0 + run * 4 * groups + 4 * ng;
}

__global__ void __launch_bounds__(kThreads) bottleneck_kernel(const Args g) {
  extern __shared__ int4 smem4[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem4);
  int* s_w = reinterpret_cast<int*>(smem);
  int8_t* s_x = smem + kWBytes;
  const int mid_stride = g.cm + kRowPad;
  int8_t* s_mid1 = s_x + kXBytes;
  int8_t* s_mid2 = s_mid1 + kHaloPix * mid_stride;

  const int tid = threadIdx.x;
  const int h = g.h, w = g.w, c = g.c, cm = g.cm;
  const int ty0 = blockIdx.y * kTile;
  const int tx0 = blockIdx.x * kTile;
  const size_t image = static_cast<size_t>(blockIdx.z) * h * w * c;
  const int8_t* xb = g.x + image;
  int8_t* ob = g.out + image;

  // conv1 (1x1, C -> Cm) over the tile and its halo -> s_mid1.
  for (int n0 = 0; n0 < cm; n0 += kNc) {
    const int nc = min(kNc, cm - n0);
    const int groups = nc / kQ;
    const int units = (kHaloPix / kP) * groups;  // up to 400: two per thread
    int acc[2][kP][kQ];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int q = 0; q < kQ; ++q) acc[r][p][q] = 0;
    for (int k0 = 0; k0 < c; k0 += kKc) {
      const int kc = min(kKc, c - k0);
      __syncthreads();
      stage_weights(s_w, g.w1 + static_cast<size_t>(k0 / 4) * cm + n0, cm, kc / 4, nc);
      const int vecs = kc / 16;
      for (int i = tid; i < kHaloPix * vecs; i += kThreads) {
        const int pix = i / vecs;
        const int v = i - pix * vecs;
        const int gy = ty0 - 1 + pix / kHalo;
        const int gx = tx0 - 1 + pix % kHalo;
        int4 val = make_int4(0, 0, 0, 0);
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
          val = __ldg(reinterpret_cast<const int4*>(
              xb + (static_cast<size_t>(gy) * w + gx) * c + k0 + 16 * v));
        }
        *reinterpret_cast<int4*>(s_x + pix * kXStride + 16 * v) = val;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int u = tid + r * kThreads;
        if (u < units) {
          const int ng = u % groups;
          const int pg = u / groups;
          const int8_t* a[kP];
#pragma unroll
          for (int p = 0; p < kP; ++p) a[p] = s_x + (pg * kP + p) * kXStride;
          mac_chunk(acc[r], a, kc, s_w, ng, 4 * groups);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int u = tid + r * kThreads;
      if (u < units) {
        const int ng = u % groups;
        const int pg = u / groups;
#pragma unroll
        for (int run = 0; run < 2; ++run) {
          const int ch = run_channel(n0, ng, groups, run);
          float d[4], bb[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            d[j] = g.deq1[ch + j];
            bb[j] = g.bias1[ch + j];
          }
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            const int pix = pg * kP + p;
            const int gy = ty0 - 1 + pix / kHalo;
            const int gx = tx0 - 1 + pix % kHalo;
            unsigned word = 0;  // outside the image: the 3x3's zero padding
            if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                word |= requant(acc[r][p][4 * run + j], d[j], bb[j], 0.0f, false, g.s1) << (8 * j);
              }
            }
            *reinterpret_cast<unsigned*>(s_mid1 + pix * mid_stride + ch) = word;
          }
        }
      }
    }
  }

  // conv2 (3x3 SAME, Cm -> Cm) over the tile, from s_mid1 -> s_mid2.
  for (int n0 = 0; n0 < cm; n0 += kNc) {
    const int nc = min(kNc, cm - n0);
    const int groups = nc / kQ;
    const bool active = tid < (kTilePix / kP) * groups;  // up to 256 units
    const int ng = tid % groups;
    const int pg = tid / groups;
    int acc[kP][kQ];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[p][q] = 0;
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - 3 * ky;
      for (int k0 = 0; k0 < cm; k0 += kKc) {
        const int kc = min(kKc, cm - k0);
        __syncthreads();
        stage_weights(s_w, g.w2 + (static_cast<size_t>(tap) * (cm / 4) + k0 / 4) * cm + n0, cm,
                      kc / 4, nc);
        __syncthreads();
        if (active) {
          const int8_t* a[kP];
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            const int idx = pg * kP + p;
            const int ty = idx / kTile;
            const int tx = idx - ty * kTile;
            a[p] = s_mid1 + ((ty + ky) * kHalo + tx + kx) * mid_stride + k0;
          }
          mac_chunk(acc, a, kc, s_w, ng, 4 * groups);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int run = 0; run < 2; ++run) {
        const int ch = run_channel(n0, ng, groups, run);
        float d[4], bb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[j] = g.deq2[ch + j];
          bb[j] = g.bias2[ch + j];
        }
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          unsigned word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            word |= requant(acc[p][4 * run + j], d[j], bb[j], 0.0f, false, g.s2) << (8 * j);
          }
          *reinterpret_cast<unsigned*>(s_mid2 + (pg * kP + p) * mid_stride + ch) = word;
        }
      }
    }
  }

  // conv3 (1x1, Cm -> C) from s_mid2, plus the residual from x -> out.
  for (int n0 = 0; n0 < c; n0 += kNc) {
    const int nc = min(kNc, c - n0);
    const int groups = nc / kQ;
    const bool active = tid < (kTilePix / kP) * groups;
    const int ng = tid % groups;
    const int pg = tid / groups;
    int acc[kP][kQ];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[p][q] = 0;
    for (int k0 = 0; k0 < cm; k0 += kKc) {
      const int kc = min(kKc, cm - k0);
      __syncthreads();
      stage_weights(s_w, g.w3 + static_cast<size_t>(k0 / 4) * c + n0, c, kc / 4, nc);
      __syncthreads();
      if (active) {
        const int8_t* a[kP];
#pragma unroll
        for (int p = 0; p < kP; ++p) a[p] = s_mid2 + (pg * kP + p) * mid_stride + k0;
        mac_chunk(acc, a, kc, s_w, ng, 4 * groups);
      }
    }
    if (active) {
#pragma unroll
      for (int run = 0; run < 2; ++run) {
        const int ch = run_channel(n0, ng, groups, run);
        float d[4], bb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[j] = g.deq3[ch + j];
          bb[j] = g.bias3[ch + j];
        }
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const int idx = pg * kP + p;
          const int gy = ty0 + idx / kTile;
          const int gx = tx0 + idx % kTile;
          if (gy >= h || gx >= w) continue;
          const size_t at = (static_cast<size_t>(gy) * w + gx) * c + ch;
          const unsigned resid = __ldg(reinterpret_cast<const unsigned*>(xb + at));
          unsigned word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int code = static_cast<int8_t>((resid >> (8 * j)) & 0xffu);
            const float extra = __fmul_rn(__int2float_rn(code), g.resid_scale);
            word |= requant(acc[p][4 * run + j], d[j], bb[j], extra, true, g.s3) << (8 * j);
          }
          *reinterpret_cast<unsigned*>(ob + at) = word;
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int fused_bottleneck(const int8_t* x, const int* w1, const int* w2, const int* w3,
                                const float* deq1, const float* bias1, const float* deq2,
                                const float* bias2, const float* deq3, const float* bias3,
                                float s1, float s2, float s3, float resid_scale, int batch,
                                int h, int w, int c, int cm, int8_t* out, void* stream) {
  const size_t smem = kWBytes + kXBytes + static_cast<size_t>(kHaloPix + kTilePix) * (cm + kRowPad);
  const cudaError_t attr = cudaFuncSetAttribute(
      bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Args g;
  g.x = x; g.w1 = w1; g.w2 = w2; g.w3 = w3;
  g.deq1 = deq1; g.bias1 = bias1; g.deq2 = deq2; g.bias2 = bias2; g.deq3 = deq3; g.bias3 = bias3;
  g.s1 = s1; g.s2 = s2; g.s3 = s3; g.resid_scale = resid_scale;
  g.h = h; g.w = w; g.c = c; g.cm = cm;
  g.out = out;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  bottleneck_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
