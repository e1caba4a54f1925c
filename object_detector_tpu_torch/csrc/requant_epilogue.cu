// The int8 engine's epilogue as one pass: from a GEMM's int32 accumulator to
// the next layer's int8 codes, a float32 sum, or the logits.
//
// Replaces no Pallas kernel. The reference (object_detector_tpu/quant/
// engine.py) left this arithmetic to XLA, which fuses it; the port ran it as
// five to eight eager float32 passes (ops/int8.py requant_epilogue, the
// heads' dequant, the FPN's upsample-adds and requants), each reading and
// writing a float32 plane, and those passes were 54% (SSD-300) and 65%
// (RetinaNet) of the int8 forward's device time at bs=64 on an H100. It was
// added for that: here each accumulator is read once and each output written
// once.
//
// Contract (kernels/requant_epilogue.py `epilogue`). acc (rows, cols) int32
// with row stride ld (int_matmul pads rows to 32 and widths to 8 and returns
// a sliced view); deq, bias (cols,) float32. Each element is
//   y = RN(RN(float(acc) * deq) + bias)
//   [y = RN(y + RN(float(resid) * resid_scale))]   int8 residual codes, rows x cols
//   [y = RN(y + addend)]                           float32 (B, H / 2, W / 2, cols),
//                                                  read as its 2x nearest upsample
// and the kernel writes any of: the sum y (float32, or RN to bfloat16);
// the codes clip(rint(RN(y / out_scale)), low, 127), low 0 (a ReLU) or
// -127; and the ReLU'd codes max(code, 0). Outputs are rows x cols, dense.
//
// Bit-exactness. The per-element arithmetic is csrc/requant.cuh's, which
// csrc/conv3x3.cu shares: every operation rounds to nearest as the plain
// version's eager ops do (see there).
//
// What bounds it on an H100: bytes. An element reads 4 bytes of accumulator
// (1 of residual or 4 of addend) and writes 1 byte of code (or 4 or 2 of
// sum) against some 25 instructions: at 3.35 TB/s and 5 bytes an element,
// 670e9 elements/s need about 17e12 instructions/s of the card's 30e12.
//
// Design. A thread owns one group of 4 channels for the whole launch, so its
// deq and bias stay in registers, and walks rows with a stride of all the
// grid's threads over the groups; neighbouring threads hold neighbouring
// groups of a row, so a warp reads 512 contiguous bytes of accumulator. It
// loads 16 bytes (4 int32) a row, four rows ahead of its arithmetic, and
// stores the 4 codes as one 32-bit word (the sum as 16 or 8 bytes). Where
// the width is not a multiple of 4 (the SSD heads' 126) or a pointer is not
// aligned, the same walk loads and stores element by element. The grid is
// as many blocks as the rows and groups fill, up to all that fit on the
// card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsAhead = 4;  // rows a thread loads before it computes the first
constexpr int kMaxDevices = 64;

enum SumKind { kNoSum = 0, kSumF32 = 1, kSumBf16 = 2 };

struct Args {
  const int* acc;
  long long ld;  // acc's row stride, in elements
  int rows, cols, groups;  // groups = ceil(cols / 4)
  const float* deq;
  const float* bias;
  const int8_t* resid;  // or null
  float resid_scale;
  const float* addend;  // or null
  int h, w;  // the acc plane's height and width: row = (b * h + y) * w + x
  float out_scale, inv_scale, low;  // inv_scale = RN(1 / out_scale)
  int8_t* codes;  // or null
  int8_t* relu_codes;  // or null
  void* sum;  // float32 or bfloat16, or null
};

__device__ __forceinline__ unsigned pack4(const int (&q)[4]) {
  return (q[0] & 0xffu) | ((q[1] & 0xffu) << 8) | ((q[2] & 0xffu) << 16) |
         ((q[3] & 0xffu) << 24);
}

// The addend's row of acc row `row`: (b, y / 2, x / 2) at half the height
// and width. Rows are below 2^31, so 32-bit divides do.
__device__ __forceinline__ long long coarse_row(const Args& a, int row) {
  const unsigned t = static_cast<unsigned>(row) / a.w;
  const unsigned x = static_cast<unsigned>(row) - t * a.w;
  const unsigned b = t / a.h;
  const unsigned y = t - b * a.h;
  return (static_cast<long long>(b) * (a.h / 2) + y / 2) * (a.w / 2) + x / 2;
}

template <int kVec>
__device__ __forceinline__ void load_acc(int (&v)[4], const Args& a, int row, int c0, int n) {
  const int* p = a.acc + static_cast<long long>(row) * a.ld + c0;
  if (kVec) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p));  // read once: evict first
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n ? __ldcs(p + j) : 0;
  }
}

template <int kSum, int kVec>
__device__ __forceinline__ void finish_row(const Args& a, const int (&v)[4], int row, int c0,
                                           int n, const float (&deq)[4], const float (&bias)[4]) {
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = int8mma::dequant(v[j], deq[j], bias[j]);
  const long long at = static_cast<long long>(row) * a.cols + c0;
  if (a.resid != nullptr) {
    int r[4];
    if (kVec) {
      const int word = __ldcs(reinterpret_cast<const int*>(a.resid + at));
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = static_cast<int8_t>((word >> (8 * j)) & 0xff);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = j < n ? a.resid[at + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = requant::add_resid(y[j], r[j], a.resid_scale);
  }
  if (a.addend != nullptr) {
    const float* p = a.addend + coarse_row(a, row) * a.cols + c0;
    float e[4];
    if (kVec) {
      const float4 q = *reinterpret_cast<const float4*>(p);  // read by four rows: kept
      e[0] = q.x;
      e[1] = q.y;
      e[2] = q.z;
      e[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = j < n ? p[j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = __fadd_rn(y[j], e[j]);
  }
  if (kSum == kSumF32) {
    float* s = static_cast<float*>(a.sum) + at;
    if (kVec) {
      *reinterpret_cast<float4*>(s) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) s[j] = y[j];
    }
  } else if (kSum == kSumBf16) {
    __nv_bfloat16* s = static_cast<__nv_bfloat16*>(a.sum) + at;
    unsigned short b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = requant::bf16_bits(y[j]);
    if (kVec) {
      *reinterpret_cast<uint2*>(s) = make_uint2(b[0] | (static_cast<unsigned>(b[1]) << 16),
                                                b[2] | (static_cast<unsigned>(b[3]) << 16));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) s[j] = __ushort_as_bfloat16(b[j]);
    }
  }
  if (a.codes != nullptr) {
    int q[4];
    requant::codes(y, q, a.out_scale, a.inv_scale, a.low);
    if (kVec) {
      *reinterpret_cast<unsigned*>(a.codes + at) = pack4(q);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) a.codes[at + j] = static_cast<int8_t>(q[j]);
    }
    if (a.relu_codes != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = max(q[j], 0);
      if (kVec) {
        *reinterpret_cast<unsigned*>(a.relu_codes + at) = pack4(q);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n) a.relu_codes[at + j] = static_cast<int8_t>(q[j]);
      }
    }
  }
}

template <int kSum, int kVec>
__global__ void __launch_bounds__(kThreads) requant_epilogue_kernel(const Args a) {
  // The grid holds fewer than 2^31 threads and a launch fewer than 2^31 rows.
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int row_step = gridDim.x * kThreads / a.groups;
  const int g = tid % a.groups;
  if (tid / a.groups >= row_step) return;  // past the last whole round of groups
  const int c0 = 4 * g;
  const int n = min(4, a.cols - c0);
  float deq[4], bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    deq[j] = j < n ? a.deq[c0 + j] : 0.0f;
    bias[j] = j < n ? a.bias[c0 + j] : 0.0f;
  }
  // row + u * row_step stays below 2^31: rows and row_step are.
  for (long long row = tid / a.groups; row < a.rows; row += kRowsAhead * row_step) {
    int v[kRowsAhead][4];
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      const long long r = row + static_cast<long long>(u) * row_step;
      if (r < a.rows) load_acc<kVec>(v[u], a, static_cast<int>(r), c0, n);
    }
#pragma unroll
    for (int u = 0; u < kRowsAhead; ++u) {
      const long long r = row + static_cast<long long>(u) * row_step;
      if (r < a.rows) finish_row<kSum, kVec>(a, v[u], static_cast<int>(r), c0, n, deq, bias);
    }
  }
}

template <int kSum, int kVec>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // The SM count and blocks an SM holds, once per device.
  static int resident[kMaxDevices];
  int device = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, requant_epilogue_kernel<kSum, kVec>, kThreads, 0)) != cudaSuccess)
      return err;
    resident[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long items = static_cast<long long>(a.rows) * a.groups;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > resident[device]) blocks = resident[device];
  const long long least = (a.groups + kThreads - 1) / kThreads;  // one thread a group
  if (blocks < least) blocks = least;
  requant_epilogue_kernel<kSum, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). Null
// resid, addend, codes, relu_codes or sum leave that input or output out;
// sum_kind is 0 (no sum), 1 (float32) or 2 (bfloat16); relu sets the
// codes' lower clip to 0 (else -127). rows * cols > 0.
extern "C" int requant_epilogue(const int* acc, long long ld, int rows, int cols,
                                const float* deq, const float* bias, const int8_t* resid,
                                float resid_scale, const float* addend, int h, int w,
                                float out_scale, int relu, int8_t* codes, int8_t* relu_codes,
                                void* sum, int sum_kind, void* stream) {
  Args a{acc, ld, rows, cols, (cols + 3) / 4, deq, bias, resid, resid_scale, addend, h, w,
         out_scale, 1.0f / out_scale, relu ? 0.0f : -127.0f, codes, relu_codes, sum};
  const bool vec = cols % 4 == 0 && ld % 4 == 0 && aligned(acc, 16) && aligned(resid, 4) &&
                   aligned(addend, 16) && aligned(codes, 4) && aligned(relu_codes, 4) &&
                   aligned(sum, sum_kind == kSumBf16 ? 8 : 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sum_kind * 2 + (vec ? 1 : 0)) {
    case 0: return static_cast<int>(launch<kNoSum, 0>(a, s));
    case 1: return static_cast<int>(launch<kNoSum, 1>(a, s));
    case 2: return static_cast<int>(launch<kSumF32, 0>(a, s));
    case 3: return static_cast<int>(launch<kSumF32, 1>(a, s));
    case 4: return static_cast<int>(launch<kSumBf16, 0>(a, s));
    case 5: return static_cast<int>(launch<kSumBf16, 1>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
