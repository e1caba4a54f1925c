// Multi-scale deformable attention's core (Deformable DETR, arXiv:2010.04159
// eq. 3): for each query and head, 4 levels x 4 points, each a bilinear sample
// of the level's value map at a fractional location the query predicts,
// weighted by a softmax over the 16.
//
// Replaces no Pallas kernel: the JAX package has no Deformable DETR. No
// library op computes it (the public code's PyTorch form is one
// F.grid_sample a level, a stack and a sum). It is the port's first kernel
// whose reads are gathers at addresses that depend on the data.
//
// Contract (kernels/msda.py `msda`). value (B, Len, heads, 32) bf16, dense,
// heads a multiple of 8,
// the levels' tokens level after level (padded tokens already zero); ref
// (B, Lq, 4, 2) f32 dense; offsets (B, Lq, heads * 32) f32 in (head, level,
// point, xy) order and logits (B, Lq, heads * 16) f32 in (head, level, point)
// order, each row 16-byte aligned at any row and batch stride; query_pad
// (B, Lq) bytes, nonzero where a query row is padding, or null. out (B, Lq,
// heads * 32) bf16, dense; a padded row is written as zeros.
//
// Numbers. Everything but the values and the output is f32: the softmax
// (expf, IEEE division), the location ref + offset / W, the pixel coordinate
// loc * W - 0.5 (F.grid_sample's align_corners=False), the four bilinear
// weights (each times the point's softmax weight once), and the sum, one
// product and one add a corner and channel (-fmad=false: no FMA). A corner off
// the map weighs 0 and is not read.
//
// What bounds it on an H100: its float32 work, 2 operations a corner and
// channel, one instruction each at 33.5e12/s, against gathers of 64-byte rows
// (one head's 32 channels) that neighbouring queries mostly share in L1 and
// L2. The design:
//  - a warp takes one query row and 8 heads; in the sampling phase lane
//    (head = lane / 4, level = lane % 4) computes its level's 4 points: the
//    head's 16 logits are a float4 a lane and the softmax's max and sum two
//    shuffles each, the offsets two float4 a lane, so the loads of a warp are
//    512 contiguous bytes;
//  - in the gather phase lane (head, chunk = lane % 4) sums 8 channels of its
//    head: each corner is one 16-byte load a lane, 64 contiguous bytes a head,
//    and a level's 4 points (a point's first corner and its four weights) are
//    taken from the lane that computed them by shuffles; a level's 16 corner
//    loads are issued before any is summed;
//  - no shared memory, so the SM's 256 KB stay L1 for the gathers, and 8 warps
//    a block, one query row each, walk the rows in order, so that the warps on
//    an SM sample neighbouring regions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 4;
constexpr int kPoints = 4;
constexpr int kHeadDim = 32;
constexpr int kLanesPerHead = 4;
constexpr int kHeadsPerWarp = 32 / kLanesPerHead;
constexpr int kChannels = kHeadDim / kLanesPerHead;  // 8 channels, 16 bytes, a lane
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const __nv_bfloat16* value;
  const float* ref;
  const float* off;
  long long off_bs, off_rs;  // batch and row strides, in elements
  const float* logit;
  long long lg_bs, lg_rs;
  const uint8_t* qpad;
  __nv_bfloat16* out;
  int lq, len, heads, groups;  // groups: warps a query row, heads / 8
  long long tasks;             // B * Lq * groups
  int h[kLevels], w[kLevels], start[kLevels];
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// arr[i] by selects, so that a lane-dependent index into the kernel's
// parameters takes no copy of them to local memory.
__device__ __forceinline__ int pick(const int (&arr)[kLevels], int i) {
  return i == 0 ? arr[0] : i == 1 ? arr[1] : i == 2 ? arr[2] : arr[3];
}

__global__ void __launch_bounds__(kWarps * 32) msda_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (task >= a.tasks) return;  // the whole warp
  const long long row = task / a.groups;
  const int group = static_cast<int>(task - row * a.groups);
  const long long b = row / a.lq;
  const long long q = row - b * a.lq;
  const int head = group * kHeadsPerWarp + lane / kLanesPerHead;
  const int sub = lane % kLanesPerHead;  // the level in the sampling phase, the chunk in the gather
  const int stride = a.heads * kHeadDim;
  uint4* out = reinterpret_cast<uint4*>(a.out + row * stride + head * kHeadDim + sub * kChannels);
  if (a.qpad != nullptr && a.qpad[row]) {  // the whole warp
    *out = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  // Sampling phase: this lane's level's 4 points.
  const float4 lg = *reinterpret_cast<const float4*>(
      a.logit + b * a.lg_bs + q * a.lg_rs + head * (kLevels * kPoints) + sub * kPoints);
  float m = fmaxf(fmaxf(lg.x, lg.y), fmaxf(lg.z, lg.w));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
  float e[kPoints] = {expf(lg.x - m), expf(lg.y - m), expf(lg.z - m), expf(lg.w - m)};
  float s = (e[0] + e[1]) + (e[2] + e[3]);
  s += __shfl_xor_sync(kFull, s, 1);
  s += __shfl_xor_sync(kFull, s, 2);
  const float* offp = a.off + b * a.off_bs + q * a.off_rs + (head * kLevels + sub) * kPoints * 2;
  const float4 o01 = *reinterpret_cast<const float4*>(offp);
  const float4 o23 = *reinterpret_cast<const float4*>(offp + 4);
  const float ox[kPoints] = {o01.x, o01.z, o23.x, o23.z};
  const float oy[kPoints] = {o01.y, o01.w, o23.y, o23.w};
  const float2 r = *reinterpret_cast<const float2*>(a.ref + (row * kLevels + sub) * 2);
  const int hl = pick(a.h, sub), wl = pick(a.w, sub);
  const float fh = static_cast<float>(hl), fw = static_cast<float>(wl);
  int base[kPoints];  // the point's top-left corner, a token index
  float cw[kPoints][4];  // its corners' weights: (0,0), (0,1), (1,0), (1,1)
#pragma unroll
  for (int p = 0; p < kPoints; ++p) {
    const float attn = e[p] / s;
    // Pixel coordinates, clamped where every corner is off the map anyway.
    const float x = fminf(fmaxf((r.x + ox[p] / fw) * fw - 0.5f, -2.0f), fw);
    const float y = fminf(fmaxf((r.y + oy[p] / fh) * fh - 0.5f, -2.0f), fh);
    const float x0f = floorf(x), y0f = floorf(y);
    const float fx = x - x0f, fy = y - y0f;
    const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
    const bool xin0 = x0 >= 0 && x0 < wl, xin1 = x0 + 1 >= 0 && x0 + 1 < wl;
    const bool yin0 = y0 >= 0 && y0 < hl, yin1 = y0 + 1 >= 0 && y0 + 1 < hl;
    cw[p][0] = (yin0 && xin0) ? attn * ((1.0f - fy) * (1.0f - fx)) : 0.0f;
    cw[p][1] = (yin0 && xin1) ? attn * ((1.0f - fy) * fx) : 0.0f;
    cw[p][2] = (yin1 && xin0) ? attn * (fy * (1.0f - fx)) : 0.0f;
    cw[p][3] = (yin1 && xin1) ? attn * (fy * fx) : 0.0f;
    base[p] = pick(a.start, sub) + y0 * wl + x0;
  }

  // Gather phase: 8 channels of this lane's head, over the head's 16 points.
  const __nv_bfloat16* vbase = a.value + b * a.len * stride + head * kHeadDim + sub * kChannels;
  float acc[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) acc[c] = 0.0f;
  const int quad = lane & ~(kLanesPerHead - 1);
#pragma unroll 1
  for (int level = 0; level < kLevels; ++level) {
    const int src = quad + level;
    const int wsrc = __shfl_sync(kFull, wl, src);
    float wt[kPoints * 4];
    uint4 v[kPoints * 4];
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      const int t = __shfl_sync(kFull, base[p], src);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float wk = __shfl_sync(kFull, cw[p][k], src);
        wt[p * 4 + k] = wk;
        const int token = t + (k >> 1) * wsrc + (k & 1);
        v[p * 4 + k] = wk != 0.0f
                           ? __ldg(reinterpret_cast<const uint4*>(vbase + token * stride))
                           : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < kPoints * 4; ++i) {
      const unsigned u[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[2 * j] += wt[i] * __uint_as_float(u[j] << 16);
        acc[2 * j + 1] += wt[i] * __uint_as_float(u[j] & 0xffff0000u);
      }
    }
  }
  *out = make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                    pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
}

}  // namespace

extern "C" int msda(const void* value, const void* ref, const void* offsets, long long off_bs,
                    long long off_rs, const void* logits, long long lg_bs, long long lg_rs,
                    const void* query_pad, void* out, int batch, int lq, int len, int heads,
                    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
                    void* stream) {
  Args a{};
  a.value = static_cast<const __nv_bfloat16*>(value);
  a.ref = static_cast<const float*>(ref);
  a.off = static_cast<const float*>(offsets);
  a.off_bs = off_bs;
  a.off_rs = off_rs;
  a.logit = static_cast<const float*>(logits);
  a.lg_bs = lg_bs;
  a.lg_rs = lg_rs;
  a.qpad = static_cast<const uint8_t*>(query_pad);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lq = lq;
  a.len = len;
  a.heads = heads;
  a.groups = heads / kHeadsPerWarp;
  a.tasks = static_cast<long long>(batch) * lq * a.groups;
  const int hs[kLevels] = {h0, h1, h2, h3}, ws[kLevels] = {w0, w1, w2, w3};
  int start = 0;
  for (int l = 0; l < kLevels; ++l) {
    a.h[l] = hs[l];
    a.w[l] = ws[l];
    a.start[l] = start;
    start += hs[l] * ws[l];
  }
  const long long blocks = (a.tasks + kWarps - 1) / kWarps;
  msda_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
