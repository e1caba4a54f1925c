// Backward of a 2x2 / stride-2 max pool: each window's cotangent goes whole to
// the first maximum in the order (0,0), (0,1), (1,0), (1,1).
//
// Replaces the Pallas TPU kernel object_detector_tpu/ops/pooling.py
// ::_pool_bwd_kernel (:76, launched through _max_pool_bwd_pallas, pallas_call
// at :135, from the VJP of max_pool_2x2_fastgrad).
//
// Contract. x (B, H, W, C) and g (B, H/2, W/2, C), channel fastest in memory
// (an NCHW tensor in PyTorch's channels-last format), H and W even, float32 or
// bfloat16. dx (B, H, W, C) of x's type: within each window, the first
// position whose value equals the window's maximum takes g, the other three
// take +0. Values are compared after an exact upcast to float32, so bfloat16
// orders as float32 does and -0 equals +0.
//
// The maximum is recomputed from the window's four x values and y is not
// read. The recomputed maximum propagates a NaN as the forward pool does (a
// window holding a NaN then equals nothing and gets all zeros), so on
// y = maxpool(x) the result is the same as comparing against y.
//
// What bounds it on an H100. No arithmetic to speak of: 4 reads of x, 1 of g
// and 4 writes of dx per window and channel, 18 bytes in bfloat16. At SSD-300
// bs=32 pool 1 has 32 x 150 x 150 x 64 = 46.1e6 of them, 829 MB, 0.25 ms at
// 3.35 TB/s. The bytes bound it.
//
// Design. One thread per window and 16 bytes of channels (8 bfloat16 or 4
// float32): four 16-byte loads of x, one of g, four 16-byte stores, each
// element of device memory touched once. Neighbouring threads hold
// neighbouring channel groups and then neighbouring windows of a row, so a
// warp's loads are contiguous runs of both window rows. Where C is not a
// multiple of the group or a pointer is not 16-byte aligned, the same kernel
// runs with one channel a thread. The TPU kernel's (B, H, W/2, 2C) lane
// pairing, its row blocks and its lane concats are layout devices of that
// machine and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
// bfloat16 is the high half of a float32: the upcast is a shift, and exact.
__device__ __forceinline__ float to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Group {
  T v[VEC];
};

// The forward pool's maximum: a NaN wins and stays.
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// T is the storage type (float, or uint16_t holding bfloat16 bits). rows is
// B * H/2 output rows, cg the channel groups of VEC channels a pixel.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) pool_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx, long long total,
    int w2, int cg) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int group = static_cast<int>(i % cg);
  const long long window = i / cg;  // (b * H/2 + oy) * W/2 + ox
  const int ox = static_cast<int>(window % w2);
  const long long row = window / w2;  // b * H/2 + oy; x's row 2 * row is b * H + 2 * oy
  const long long c = static_cast<long long>(cg) * VEC;
  const long long row_stride = 2LL * w2 * c;
  const long long top = (2 * row) * row_stride + 2LL * ox * c + static_cast<long long>(group) * VEC;
  const long long bottom = top + row_stride;

  using G = Group<T, VEC>;
  const G t0 = *reinterpret_cast<const G*>(x + top);
  const G t1 = *reinterpret_cast<const G*>(x + top + c);
  const G b0 = *reinterpret_cast<const G*>(x + bottom);
  const G b1 = *reinterpret_cast<const G*>(x + bottom + c);
  const G gg = *reinterpret_cast<const G*>(g + window * c + static_cast<long long>(group) * VEC);
  G d0, d1, d2, d3;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float f0 = to_float(t0.v[k]), f1 = to_float(t1.v[k]);
    const float f2 = to_float(b0.v[k]), f3 = to_float(b1.v[k]);
    const float m = pool_max(pool_max(pool_max(f0, f1), f2), f3);
    const bool e0 = f0 == m;
    const bool e1 = f1 == m && !e0;
    const bool e2 = f2 == m && !(e0 || e1);
    const bool e3 = f3 == m && !(e0 || e1 || e2);
    const T zero = T(0);
    d0.v[k] = e0 ? gg.v[k] : zero;
    d1.v[k] = e1 ? gg.v[k] : zero;
    d2.v[k] = e2 ? gg.v[k] : zero;
    d3.v[k] = e3 ? gg.v[k] : zero;
  }
  *reinterpret_cast<G*>(dx + top) = d0;
  *reinterpret_cast<G*>(dx + top + c) = d1;
  *reinterpret_cast<G*>(dx + bottom) = d2;
  *reinterpret_cast<G*>(dx + bottom + c) = d3;
}

template <typename T, int VEC>
int launch(const void* x, const void* g, void* dx, long long rows, int w2, int c,
           cudaStream_t stream) {
  const int cg = c / VEC;
  const long long total = rows * w2 * cg;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  pool_bwd_kernel<T, VEC><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), total, w2, cg);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (rows * 2, w2 * 2, c) and g (rows, w2, c) with rows = B * H/2; bf16 != 0
// for bfloat16, else float32. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int pool_bwd(const void* x, const void* g, void* dx, long long rows, int w2, int c,
                        int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = aligned16(x) && aligned16(g) && aligned16(dx);
  if (bf16) {
    if (wide && c % 8 == 0) return launch<uint16_t, 8>(x, g, dx, rows, w2, c, s);
    return launch<uint16_t, 1>(x, g, dx, rows, w2, c, s);
  }
  if (wide && c % 4 == 0) return launch<float, 4>(x, g, dx, rows, w2, c, s);
  return launch<float, 1>(x, g, dx, rows, w2, c, s);
}
