// A stride-1 ResNet bottleneck in int8 as one kernel: 1x1 conv -> 3x3 SAME
// conv -> 1x1 conv plus the residual, each with int32 accumulation, dequant,
// bias, ReLU and requant. Both intermediates stay in shared memory; the
// products run on the int8 tensor cores (mma.sync m16n8k32, csrc/int8_mma.cuh).
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/
// bottleneck_pallas.py::_bottleneck_kernel (:75, entry fused_bottleneck :147,
// pallas_call at :188). The TPU kernel walks row bands with one-row halo
// blocks and holds all three kernels in its fast memory; neither is carried
// over (the widest block's kernels are 4.4 MB against 227 KB of shared
// memory). The contract is the function, on NHWC codes.
//
// Contract. x (B, H, W, C) int8; w1, w2, w3 the (C, Cm), (3, 3, Cm, Cm) and
// (Cm, C) int8 kernels as (K, N) matrices (w2: K = 9 * Cm, tap-major) in the
// packed B layout of csrc/int8_mma.cuh; deq* and bias* float32 per output
// channel; s1, s2, s3, resid_scale float32. C and Cm are multiples of 64.
//   mid1 = rq(max(x . w1 * deq1 + bias1, 0), s1)
//   mid2 = rq(max(conv3x3_same(mid1, w2) * deq2 + bias2, 0), s2)
//   out  = rq(max(mid2 . w3 * deq3 + bias3 + float(x) * resid_scale, 0), s3)
//   rq(y, s) = clip(rint(y / s), -127, 127)
// The 3x3's SAME padding is zero codes of mid1: a tile computes conv1 on its
// halo pixels and writes 0 for those that lie outside the image.
//
// Bit-exactness. The sums are exact in int32 in any order (|acc| <= 2048 *
// 127^2 < 2^31); acc -> float rounds to nearest even where |acc| >= 2^24, as
// a cast does. The epilogue is the engine's requant rounded after every
// operation (__fmul_rn, __fadd_rn; the residual product is rounded before it
// is added), a divide by the scale and rint half to even, in the exact form
// of csrc/int8_mma.cuh `requant2` (a multiply by RN(1 / s) that divides where
// the quotient lies near a rounding boundary). The build passes -fmad=false
// too. Only the thread that holds each value differs from the first
// (__dp4a) design.
//
// What bounds it on an H100. Each of the four shapes of ResNet-50 at SSD-512
// bs=64 needs 34 * Cm^2 int8 operations a pixel, 1.46e11 a launch, 0.074 ms
// at the tensor cores' 1,979e12 operations/s; x read once and the output
// written once take 0.160, 0.080, 0.040 and 0.020 ms at 3.35 TB/s. Stage 1 is
// bound by bytes, stages 3 and 4 by operations. Beside the bound, every block
// reads all three kernels (17 * Cm^2 bytes) from L2, and the dividing
// epilogue costs about as much as the products at Cm = 64.
//
// Design. One block of 256 threads (8 warps as 4 along the pixels by 2 along
// the channels) per image and 8 x 16 spatial tile: 128 output pixels, 180
// halo pixels for conv1 (1.41x conv1's useful work; the first design's 8 x 8
// tile had 1.56x and re-read the weights twice as often). Each conv is an
// implicit GEMM, pixels (rows) by output channels in passes of 64, with K cut
// into chunks; each chunk's weights (and for conv1 the chunk's channels of
// x at the 180 halo pixels) go by cp.async into one of two shared-memory
// buffers while the other chunk is multiplied. A warp owns 3 (conv1: 192
// rows cover the 180) or 2 (conv2, conv3) m16 tiles by 4 n8 tiles; its A
// fragments come by ldmatrix from one row address a pixel (a 3x3 tap is an
// offset of that address into mid1), its B fragments by 16-byte loads of the
// packed layout. conv1 writes mid1 (10 x 18 x Cm, zero outside the image),
// conv2 reads it at the nine taps and writes mid2 (8 x 16 x Cm) over conv1's
// x buffers, conv3 reads mid2, adds the residual from x and writes the
// output. Activation rows carry 16 bytes of padding, so the eight rows of an
// ldmatrix phase fall on distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace int8mma;

constexpr int kTH = 8;                        // output rows per block
constexpr int kTW = 16;                       // output columns per block
constexpr int kHW = kTW + 2;                  // halo columns
constexpr int kHaloPix = (kTH + 2) * kHW;     // 180
constexpr int kTilePix = kTH * kTW;           // 128
constexpr int kThreads = 256;
constexpr int kMT1 = 3;                       // conv1 m16 tiles a warp: 4 x 3 x 16 = 192 rows
constexpr int kMT2 = 2;                       // conv2, conv3: 4 x 2 x 16 = 128 rows
constexpr int kNT = 4;                        // n8 tiles a warp: 2 x 4 x 8 = 64, one pass
constexpr int kRowPad = 16;                   // bytes of padding per activation row
constexpr int kXChunk = 128;                  // most channels of x staged per conv1 chunk
constexpr int kWChunk = 256;                  // most k of a conv2 or conv3 weight chunk
constexpr int kPixBytes = 768;                // the halo pixels' offsets (180 ints), padded
constexpr int kResStride = kPassN + kRowPad;  // staged residual row: 64 channels
constexpr int kResBuf = kTilePix * kResStride;  // 10,240
constexpr int kResBufs = 3;                   // a pass's residual in, its codes out

struct Args {
  const int8_t* x;
  const int8_t* w1;
  const int8_t* w2;
  const int8_t* w3;
  const float* deq1;
  const float* bias1;
  const float* deq2;
  const float* bias2;
  const float* deq3;
  const float* bias3;
  float s1, s2, s3, resid_scale;
  int h, w, c, cm;
  int kc1, kc2;       // k of a chunk: conv1; conv2 and conv3
  int wbuf;           // bytes of one weight buffer
  int8_t* out;
};

// One conv as an implicit GEMM over J = (n_total / 64) * (k_total / kc)
// chunks, double-buffered. a_base(mt, buf, k0) is this lane's ldmatrix
// address for m-tile mt at the chunk starting at k0 (x buffer buf for
// conv1); stage(buf, p, k0) starts the copies of x that a chunk of pass p
// needs beside its weights (conv1: the chunk's channels at the halo pixels;
// conv3: the residual of the pass, with its first chunk; conv2: none);
// epi(acc, n) runs after a pass's last chunk, n the warp's first output
// channel, and post(p) after the barrier that follows it. kc is a multiple
// of 64: an even number of k-steps.
template <int MT, typename ABase, typename Stage, typename Epilogue, typename Post>
__device__ __forceinline__ void conv_gemm(const int8_t* __restrict__ w, int n_total, int k_total,
                                          int kc, int8_t* s_w, int wbuf, ABase a_base,
                                          Stage stage, Epilogue epi, Post post) {
  const int lane = threadIdx.x & 31;
  const int wn = (threadIdx.x >> 5) & 1;
  const int chunks_k = k_total / kc;
  const int steps = kc / kStepK;
  const int chunk_vecs = steps * kStepBytes / 16;
  const int jn = (n_total / kPassN) * chunks_k;

  auto fetch = [&](int j) {
    const int p = j / chunks_k;
    const int c = j - p * chunks_k;
    const int8_t* src =
        w + (static_cast<size_t>(p) * (k_total / kStepK) + c * steps) * kStepBytes;
    const unsigned dst = smem_addr(s_w + (j & 1) * wbuf);
    for (int i = threadIdx.x; i < chunk_vecs; i += kThreads) cp_async16(dst + 16 * i, src + 16 * i, true);
    stage(j & 1, p, c * kc);
    cp_async_commit();
  };

  int acc[MT][kNT][4];
  fetch(0);
  for (int j = 0; j < jn; ++j) {
    if (j + 1 < jn) {
      fetch(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int p = j / chunks_k;
    const int c = j - p * chunks_k;
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    }
    unsigned base[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) base[mt] = a_base(mt, j & 1, c * kc);
    const int8_t* wb = s_w + (j & 1) * wbuf + 2 * wn * kPairBytes;
    // Two k-steps an iteration (steps is even), each one's fragments loaded
    // while the other's products run; fixed register names keep the
    // fragments out of local memory.
    unsigned a0[MT][4], a1[MT][4];
    uint4 b0[2], b1[2];
    auto load = [&](unsigned (&a)[MT][4], uint4 (&b)[2], int s) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], base[mt] + s * kStepK);
      b[0] = load_pair(wb + s * kStepBytes, lane);
      b[1] = load_pair(wb + s * kStepBytes + kPairBytes, lane);
    };
    auto mma = [&](const unsigned (&a)[MT][4], const uint4 (&b)[2]) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_s8(acc[mt][0], a[mt], b[0].x, b[0].y);
        mma_s8(acc[mt][1], a[mt], b[0].z, b[0].w);
        mma_s8(acc[mt][2], a[mt], b[1].x, b[1].y);
        mma_s8(acc[mt][3], a[mt], b[1].z, b[1].w);
      }
    };
    load(a0, b0, 0);
    for (int s = 0; s < steps; s += 2) {
      load(a1, b1, s + 1);
      mma(a0, b0);
      if (s + 2 < steps) load(a0, b0, s + 2);
      mma(a1, b1);
    }
    if (c == chunks_k - 1) epi(acc, p * kPassN + wn * (kNT * 8));
    __syncthreads();
    if (c == chunks_k - 1) post(p);
  }
}

__global__ void __launch_bounds__(kThreads, 2) bottleneck_kernel(const Args g) {
  extern __shared__ int4 smem4[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem4);
  const int ms = g.cm + kRowPad;               // mid row stride
  const int xs = g.kc1 + kRowPad;              // staged x row stride
  const int xbuf = kHaloPix * xs;
  int* s_pix = reinterpret_cast<int*>(smem);   // 180 halo pixel offsets into x, -1 outside
  int8_t* s_w = smem + kPixBytes;              // two weight buffers
  int8_t* s_mid1 = s_w + 2 * g.wbuf;           // 180 x ms
  int8_t* s_x = s_mid1 + kHaloPix * ms;        // two x buffers (conv1) ...
  int8_t* s_mid2 = s_x;                        // ... then mid2, 128 x ms, and
  int8_t* s_res = s_mid2 + kTilePix * ms;      // three residual buffers (conv3)

  const int lane = threadIdx.x & 31;
  const int wm = threadIdx.x >> 6;             // 0..3 along the pixels
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int h = g.h, w = g.w, c = g.c, cm = g.cm;
  const int ty0 = blockIdx.y * kTH;
  const int tx0 = blockIdx.x * kTW;
  const size_t image = static_cast<size_t>(blockIdx.z) * h * w * c;
  const int8_t* xb = g.x + image;
  int8_t* ob = g.out + image;
  const unsigned lane_k = 16 * (lane >> 4);    // the lane's 16-byte half of a k-step
  const float inv1 = __frcp_rn(g.s1), inv2 = __frcp_rn(g.s2), inv3 = __frcp_rn(g.s3);

  for (int i = threadIdx.x; i < kHaloPix; i += kThreads) {
    const int gy = ty0 - 1 + i / kHW;
    const int gx = tx0 - 1 + i % kHW;
    s_pix[i] = gy >= 0 && gy < h && gx >= 0 && gx < w ? (gy * w + gx) * c : -1;
  }
  __syncthreads();

  // conv1 (1x1, C -> Cm) over the 180 halo pixels -> s_mid1. Rows 180..191
  // of the last m-tiles read row 0 and are not stored.
  auto x_base = [&](int mt, int buf, int) {
    int hp = (wm * kMT1 + mt) * 16 + (lane & 15);
    if (hp >= kHaloPix) hp = 0;
    return smem_addr(s_x + buf * xbuf + hp * xs) + lane_k;
  };
  auto x_stage = [&](int buf, int, int k0) {
    const int shift = g.kc1 == kXChunk ? 3 : 2;  // log2 of 16-byte vectors a pixel
    const unsigned dst = smem_addr(s_x + buf * xbuf);
    for (int i = threadIdx.x; i < kHaloPix << shift; i += kThreads) {
      const int pix = i >> shift;
      const int v = i & ((1 << shift) - 1);
      const int off = s_pix[pix];
      cp_async16(dst + pix * xs + 16 * v, off >= 0 ? xb + off + k0 + 16 * v : xb, off >= 0);
    }
  };
  auto conv1_epi = [&](int (&acc)[kMT1][kNT][4], int n) {
    float d[kNT][2], bb[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        d[nt][e] = __ldg(g.deq1 + n + nt * 8 + 2 * tq + e);
        bb[nt][e] = __ldg(g.bias1 + n + nt * 8 + 2 * tq + e);
      }
#pragma unroll
    for (int mt = 0; mt < kMT1; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int hp = (wm * kMT1 + mt) * 16 + gq + 8 * half;
        if (hp >= kHaloPix) continue;
        const bool inside = s_pix[hp] >= 0;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          unsigned short v = 0;  // outside the image: the 3x3's zero padding
          if (inside) {
            v = requant2(dequant(acc[mt][nt][2 * half], d[nt][0], bb[nt][0]),
                     dequant(acc[mt][nt][2 * half + 1], d[nt][1], bb[nt][1]), g.s1, inv1);
          }
          *reinterpret_cast<unsigned short*>(s_mid1 + hp * ms + n + nt * 8 + 2 * tq) = v;
        }
      }
  };
  auto no_post = [](int) {};
  conv_gemm<kMT1>(g.w1, cm, c, g.kc1, s_w, g.wbuf, x_base, x_stage, conv1_epi, no_post);

  // conv2 (3x3 SAME, Cm -> Cm) over the tile, from s_mid1 -> s_mid2. m-tile
  // (wm * 2 + mt) is tile row ty; a chunk lies inside one tap.
  auto no_stage = [](int, int, int) {};
  auto mid1_base = [&](int mt, int, int k0) {
    const int ty = wm * kMT2 + mt;
    const int tx = lane & 15;
    const int tap = k0 / cm;
    const int ky = tap / 3;
    const int kx = tap - 3 * ky;
    return smem_addr(s_mid1 + ((ty + ky) * kHW + tx + kx) * ms + (k0 - tap * cm)) + lane_k;
  };
  auto conv2_epi = [&](int (&acc)[kMT2][kNT][4], int n) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int ch = n + nt * 8 + 2 * tq;
      const float d0 = __ldg(g.deq2 + ch), d1 = __ldg(g.deq2 + ch + 1);
      const float b0 = __ldg(g.bias2 + ch), b1 = __ldg(g.bias2 + ch + 1);
#pragma unroll
      for (int mt = 0; mt < kMT2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pm = (wm * kMT2 + mt) * 16 + gq + 8 * half;
          *reinterpret_cast<unsigned short*>(s_mid2 + pm * ms + ch) =
              requant2(dequant(acc[mt][nt][2 * half], d0, b0),
                     dequant(acc[mt][nt][2 * half + 1], d1, b1), g.s2, inv2);
        }
    }
  };
  conv_gemm<kMT2>(g.w2, cm, 9 * cm, g.kc2, s_w, g.wbuf, mid1_base, no_stage, conv2_epi, no_post);

  // conv3 (1x1, Cm -> C) from s_mid2, plus the residual -> out. The
  // residual's 64 channels of pass p come into s_res buffer p % 3 with the
  // pass's first chunk; the epilogue writes the pass's codes over them, and
  // after the barrier they leave in 16-byte stores. Tile pixel pm is halo
  // pixel (pm / 16 + 1) * 18 + pm % 16 + 1.
  auto tile_off = [&](int pm) { return s_pix[(pm / kTW + 1) * kHW + pm % kTW + 1]; };
  auto mid2_base = [&](int mt, int, int k0) {
    const int pm = (wm * kMT2 + mt) * 16 + (lane & 15);
    return smem_addr(s_mid2 + pm * ms + k0) + lane_k;
  };
  auto res_stage = [&](int, int p, int k0) {
    if (k0 != 0) return;
    const unsigned dst = smem_addr(s_res + (p % kResBufs) * kResBuf);
    for (int i = threadIdx.x; i < kTilePix * 4; i += kThreads) {
      const int pm = i >> 2;
      const int v = i & 3;
      const int off = tile_off(pm);
      cp_async16(dst + pm * kResStride + 16 * v, off >= 0 ? xb + off + p * kPassN + 16 * v : xb,
                 off >= 0);
    }
  };
  auto conv3_epi = [&](int (&acc)[kMT2][kNT][4], int n) {
    int8_t* res = s_res + ((n / kPassN) % kResBufs) * kResBuf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int ch = n + nt * 8 + 2 * tq;
      const float d0 = __ldg(g.deq3 + ch), d1 = __ldg(g.deq3 + ch + 1);
      const float b0 = __ldg(g.bias3 + ch), b1 = __ldg(g.bias3 + ch + 1);
#pragma unroll
      for (int mt = 0; mt < kMT2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pm = (wm * kMT2 + mt) * 16 + gq + 8 * half;
          unsigned short* at =
              reinterpret_cast<unsigned short*>(res + pm * kResStride + (ch & (kPassN - 1)));
          const unsigned short resid = *at;
          // The residual term, rounded before it is added.
          const float e0 = __fmul_rn(acc_to_float(static_cast<int8_t>(resid & 0xff)),
                                     g.resid_scale);
          const float e1 = __fmul_rn(acc_to_float(static_cast<int8_t>(resid >> 8)),
                                     g.resid_scale);
          *at = requant2(__fadd_rn(dequant(acc[mt][nt][2 * half], d0, b0), e0),
                     __fadd_rn(dequant(acc[mt][nt][2 * half + 1], d1, b1), e1), g.s3, inv3);
        }
    }
  };
  auto out_store = [&](int p) {
    const int8_t* res = s_res + (p % kResBufs) * kResBuf;
    for (int i = threadIdx.x; i < kTilePix * 4; i += kThreads) {
      const int pm = i >> 2;
      const int v = i & 3;
      const int off = tile_off(pm);
      if (off >= 0) {
        *reinterpret_cast<int4*>(ob + off + p * kPassN + 16 * v) =
            *reinterpret_cast<const int4*>(res + pm * kResStride + 16 * v);
      }
    }
  };
  conv_gemm<kMT2>(g.w3, c, cm, g.kc2, s_w, g.wbuf, mid2_base, res_stage, conv3_epi, out_store);
}

// k of a conv1 chunk: 128 channels of x where they divide C, else 64.
int chunk1(int c) { return c % kXChunk == 0 ? kXChunk : 64; }

// k of a conv2 or conv3 chunk: all of Cm up to 256, else the largest of 256,
// 128 and 64 that divides it (a conv2 chunk stays inside one tap).
int chunk2(int cm) {
  if (cm <= kWChunk) return cm;
  return cm % kWChunk == 0 ? kWChunk : (cm % 128 == 0 ? 128 : 64);
}

// Shared memory of one block for widths c, cm (see bottleneck_kernel).
int smem_bytes(int c, int cm) {
  const int kc1 = chunk1(c);
  const int kc2 = chunk2(cm);
  const int wbuf = (kc1 > kc2 ? kc1 : kc2) / kStepK * kStepBytes;
  const int conv3 = kTilePix * (cm + kRowPad) + kResBufs * kResBuf;  // mid2, residual
  const int xbufs = 2 * kHaloPix * (kc1 + kRowPad);
  return kPixBytes + 2 * wbuf + kHaloPix * (cm + kRowPad) + (conv3 > xbufs ? conv3 : xbufs);
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int fused_bottleneck(const int8_t* x, const int8_t* w1, const int8_t* w2,
                                const int8_t* w3, const float* deq1, const float* bias1,
                                const float* deq2, const float* bias2, const float* deq3,
                                const float* bias3, float s1, float s2, float s3,
                                float resid_scale, int batch, int h, int w, int c, int cm,
                                int8_t* out, void* stream) {
  const int smem = smem_bytes(c, cm);
  const cudaError_t attr =
      cudaFuncSetAttribute(bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Args g;
  g.x = x; g.w1 = w1; g.w2 = w2; g.w3 = w3;
  g.deq1 = deq1; g.bias1 = bias1; g.deq2 = deq2; g.bias2 = bias2; g.deq3 = deq3; g.bias3 = bias3;
  g.s1 = s1; g.s2 = s2; g.s3 = s3; g.resid_scale = resid_scale;
  g.h = h; g.w = w; g.c = c; g.cm = cm;
  g.kc1 = chunk1(c);
  g.kc2 = chunk2(cm);
  g.wbuf = (g.kc1 > g.kc2 ? g.kc1 : g.kc2) / kStepK * kStepBytes;
  g.out = out;
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, batch);
  bottleneck_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
