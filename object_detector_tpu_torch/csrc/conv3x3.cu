// The int8 engine's 3x3 stride-1 conv and its requant epilogue as one kernel:
// an implicit GEMM that reads the NHWC int8 codes in place and writes only
// the step's output (the next layer's codes, a float32 sum or bf16 logits).
//
// Replaces no Pallas kernel. The reference (object_detector_tpu/quant/
// engine.py `_conv`) left the conv to XLA. The port ran each such step as
// three stages (kernels/conv3x3.py `conv3x3_reference`): im2col, a copy
// that writes every pixel's 9 * Cin window (9 bytes of traffic for each
// byte of input), cuBLASLt's int8 GEMM (an Ampere mma.sync kernel on this
// card) into an int32 accumulator, and csrc/requant_epilogue.cu, which
// reads that accumulator back (4 bytes an output element). Those three
// were 72 to 78% of the int8 forward's device time at bs=64 (SSD-300,
// RetinaNet) on an H100.
//
// What bounds it on an H100: the tensor cores on the trunk's and the FPN's
// convs (K = 9 * Cin = 576 to 9216 multiply-adds an output element), the
// reads of the codes on the heads' narrow convs; and, at small K, the
// epilogue's some 25 instructions an output element.
//
// Design (Hopper):
//  - A block computes a tile of `rows` (64 or 128) output pixels by BN output
//    channels: each of two consumer warpgroups issues wgmma m64nBNk32
//    s8.s8 -> s32 (csrc/wgmma_s8.cuh) on its 64 rows, both operands K-major
//    in shared memory, the sums in registers. One producer warp keeps TMA
//    loads in flight into a ring of stages, each a K-slice of `bk` bytes
//    (32, 64 or 128: one tap's channels) of both operands, handed over by
//    mbarriers. The k-steps of a slice are fixed at compile time, so only
//    wgmma touches the accumulators between its fence and its commit.
//  - A is loaded by TMA in im2col mode: the tensor map walks the output
//    pixels in order, across rows and images, and each load reads one
//    tap's channels at an offset of (kx, ky) * dilation from every pixel's
//    window corner, with zeros outside the image. So padding (SAME, VALID)
//    and dilation (1, 2, 6) cost nothing, no im2col copy is written, and a
//    tile of 64 or 128 pixels wastes no lanes on the 19, 10, 5, 3 and 1 px
//    maps. B is the engine's laid-out weight (`gemm_operand`: (Cout, K)
//    row-major, K-major as wgmma wants it), loaded by a tiled tensor map.
//    Both land in the swizzle of width bk that the wgmma descriptors name.
//  - The epilogue runs csrc/requant.cuh on the accumulators in registers,
//    8 values at a time, and stores each thread's pairs of columns. It
//    costs more issue slots than the tensor cores' time for the same tile
//    at K = 1152, so it gets the threads: two warpgroups of 64 rows each
//    rather than one of 128, and two blocks an SM (at most 110 KB of
//    shared memory and 112 registers a thread), whose epilogues run beside
//    each other's tensor-core work.
//  - Tiles follow the shapes: BN is the narrowest of 16, 24, 32, 48, 64, 96
//    and 128 that holds Cout (the SSD heads' 16, 24, 84, 126, RetinaNet's 36)
//    or 128 beyond; rows fall to 64 (one warpgroup) where 128 would leave
//    SMs without a tile (the small maps at small batch).
//
// Bit-exactness: the int32 sums are exact in any order (|acc| <= 127^2 *
// 9216 < 2^31), and the epilogue is the engine's arithmetic, shared with
// csrc/requant_epilogue.cu, so the outputs equal the three-stage chain's bit
// for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "requant.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int kThreads = 288;   // two consumer warpgroups and one producer warp
constexpr int kMaxStages = 8;
constexpr int kSmemBudget = 110 * 1024;  // a block's stages: two blocks fit on an SM
constexpr int kAlign = 1024;    // the 128-byte swizzle's period, which TMA and wgmma share
constexpr int kMaxDevices = 64;

enum SumKind { kNoSum = 0, kSumF32 = 1, kSumBf16 = 2 };

struct Params {
  int m;        // output pixels, B * Ho * Wo
  int hw, wo;   // Ho * Wo and Wo
  int cin, cout;
  int pad, dilation;
  int bk, k_blocks, stages, rows, n_tiles;
  int a_bytes, stage_bytes;  // a stage: A (rows x bk), then B (BN x bk), each 1024-aligned
  const float* deq;
  const float* bias;
  float out_scale, inv_scale, low;  // inv_scale = RN(1 / out_scale)
  int8_t* codes;  // or null
  void* sum;      // or null
  int sum_kind;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that lasts
// seconds can only be a fault of the kernel: it traps, so the launch fails
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 33)) {
      asm volatile("trap;");
    }
  }
}

__device__ __forceinline__ void tma_tile_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// One tap's channels [c, c + bk) of `rows` output pixels from the pixel whose
// window corner is (w, h) in image n, the tap at (w + dw, h + dh).
__device__ __forceinline__ void tma_im2col_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int c, int w, int h, int n, uint16_t dw,
                                              uint16_t dh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(dw), "h"(dh)
      : "memory");
}

// A K-major shared-memory operand in the swizzle of width bk (32, 64 or 128
// bytes): start address, leading offset 1 (unused by swizzled K-major
// layouts), 8 rows of bk bytes between core-matrix groups, layout type
// 1 / 2 / 3 for 128 / 64 / 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int bk) {
  const uint64_t layout = bk == 128 ? 1 : bk == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * bk) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// wgmma's issue and wait.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The block's producer: lane 0 of warp 8 loads every K-slice of the tile.
template <int BN>
__device__ __forceinline__ void produce(const CUtensorMap* a_map, const CUtensorMap* b_map,
                                        const Params& p, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int m0, int n0) {
  const int img = m0 / p.hw;
  const int rem = m0 - img * p.hw;
  const int oy = rem / p.wo;
  const int ox = rem - oy * p.wo;
  const int per_tap = p.cin / p.bk;
  const unsigned bytes = static_cast<unsigned>((p.rows + BN) * p.bk);
  for (int kb = 0; kb < p.k_blocks; ++kb) {
    const int s = kb % p.stages;
    mbar_wait(&empty[s], ((kb / p.stages) & 1) ^ 1);
    uint8_t* a = smem + s * p.stage_bytes;
    mbar_expect_tx(&full[s], bytes);
    const int tap = kb / per_tap;
    const int c = (kb - tap * per_tap) * p.bk;
    const int ky = tap / 3;
    const int kx = tap - 3 * ky;
    tma_im2col_4d(a, a_map, &full[s], c, ox - p.pad, oy - p.pad, img,
                  static_cast<uint16_t>(kx * p.dilation), static_cast<uint16_t>(ky * p.dilation));
    tma_tile_2d(a + p.a_bytes, b_map, &full[s], kb * p.bk, n0);
  }
}

// The dequantized values of G groups of 8 columns, j and on, of a
// warpgroup's 64 rows: this thread's columns c = n + 8g and c + 1 at rows
// m_row (y[4g], y[4g + 1]) and m_row + 8 (y[4g + 2], y[4g + 3]). Columns
// past Cout read deq = bias = 0.
template <int BN, int G>
__device__ __forceinline__ void dequant_groups(const Params& p, const int (&acc)[BN / 2], int j,
                                               int n, float (&y)[4 * G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int c = n + 8 * g;
    const bool in0 = c < p.cout, in1 = c + 1 < p.cout;
    const float d0 = in0 ? __ldg(p.deq + c) : 0.0f, b0 = in0 ? __ldg(p.bias + c) : 0.0f;
    const float d1 = in1 ? __ldg(p.deq + c + 1) : 0.0f, b1 = in1 ? __ldg(p.bias + c + 1) : 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * (j + g) + 2 * r;  // the accumulators of (row + 8r, c) and (.., c + 1)
      y[4 * g + 2 * r] = int8mma::dequant(acc[i], d0, b0);
      y[4 * g + 2 * r + 1] = int8mma::dequant(acc[i + 1], d1, b1);
    }
  }
}

// How a launch stores its one output: at even Cout a column pair is in or
// out whole and 2-aligned (one store a pair); at odd Cout element by element.
enum StoreMode { kPairCodes = 0, kPairF32 = 1, kPairBf16 = 2, kEach = 3 };

// The outputs of G groups of 8 columns, j and on, of a warpgroup's 64 rows
// from their sums: 4 G values side by side, one branch for their rare
// divides, then one store a column pair by the launch's mode (uniform).
template <int BN, int G>
__device__ __forceinline__ void finish_groups(const Params& p, int mode, const int (&acc)[BN / 2],
                                              int j, long long m_row, int n) {
  float y[4 * G];
  dequant_groups<BN, G>(p, acc, j, n, y);
  int q[4 * G];
  if (p.codes != nullptr) requant::codes(y, q, p.out_scale, p.inv_scale, p.low);
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = n + 8 * g;
      const long long m = m_row + 8 * r;
      const long long at = m * p.cout + c;
      const int i = 4 * g + 2 * r;
      const bool in = c < p.cout && m < p.m;
      if (mode == kPairCodes) {
        if (in) *reinterpret_cast<unsigned short*>(p.codes + at) = int8mma::pack2(q[i], q[i + 1]);
      } else if (mode == kPairF32) {
        float2* out = reinterpret_cast<float2*>(static_cast<float*>(p.sum) + at);
        if (in) *out = make_float2(y[i], y[i + 1]);
      } else if (mode == kPairBf16) {
        const unsigned word =
            requant::bf16_bits(y[i]) | (static_cast<unsigned>(requant::bf16_bits(y[i + 1])) << 16);
        if (in) *reinterpret_cast<unsigned*>(static_cast<unsigned short*>(p.sum) + at) = word;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!in || c + e >= p.cout) continue;
          if (p.codes != nullptr) {
            p.codes[at + e] = static_cast<int8_t>(q[i + e]);
          } else if (p.sum_kind == kSumF32) {
            static_cast<float*>(p.sum)[at + e] = y[i + e];
          } else {
            static_cast<unsigned short*>(p.sum)[at + e] = requant::bf16_bits(y[i + e]);
          }
        }
      }
    }
  }
}

// The GEMM of one consumer warpgroup over every K-slice: KSTEPS wgmma
// k-steps a slice (bk / 32) on its 64 rows of A (from byte a_off of each
// stage). The shape is fixed at compile time, so nothing but wgmma touches
// the accumulators between a slice's fence and its commit.
template <int BN, int KSTEPS>
__device__ __forceinline__ void mainloop(const Params& p, int (&acc)[BN / 2], uint8_t* smem,
                                         int a_off, uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x % 32;
  for (int kb = 0; kb < p.k_blocks; ++kb) {
    const int s = kb % p.stages;
    mbar_wait(&full[s], (kb / p.stages) & 1);
    const uint8_t* a = smem + s * p.stage_bytes;
    const uint64_t da = smem_desc(a + a_off, p.bk);
    const uint64_t db = smem_desc(a + p.a_bytes, p.bk);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k) {  // 32 bytes of K a step: +2 in the address field
      wgmma_s8::mma(acc, da + 2 * k, db + 2 * k);
    }
    wgmma_commit();
    // The previous slice's products are done: its stage goes back to the
    // producer while this slice's run.
    wgmma_wait<1>();
    fence_acc(acc);
    if (kb > 0 && lane == 0) mbar_arrive(&empty[(kb - 1) % p.stages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// A consumer warpgroup (wg 0 or 1): the GEMM of its 64 rows of the tile,
// then the epilogue on its registers.
template <int BN>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int m0, int n0, int wg) {
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int a_off = wg * 64 * p.bk;
  switch (p.bk) {
    case 32: mainloop<BN, 1>(p, acc, smem, a_off, full, empty); break;
    case 64: mainloop<BN, 2>(p, acc, smem, a_off, full, empty); break;
    default: mainloop<BN, 4>(p, acc, smem, a_off, full, empty); break;
  }
  const int t = threadIdx.x % 128;
  const long long m_row = static_cast<long long>(m0) + 64 * wg + 16 * (t / 32) + t % 32 / 4;
  const int n = n0 + 2 * (t % 4);
  const int mode = p.cout % 2 != 0         ? kEach
                   : p.codes != nullptr      ? kPairCodes
                   : p.sum_kind == kSumF32   ? kPairF32
                                             : kPairBf16;
#pragma unroll
  for (int j = 0; j + 1 < BN / 8; j += 2) {
    if (n + 8 * j < p.cout) finish_groups<BN, 2>(p, mode, acc, j, m_row, n + 8 * j);
  }
  constexpr int last = BN / 8 - 1;  // an odd count of groups (BN 24): the last alone
  if (last % 2 == 0 && n + 8 * last < p.cout) {
    finish_groups<BN, 1>(p, mode, acc, last, m_row, n + 8 * last);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_requant_kernel(const __grid_constant__ CUtensorMap a_map,
                           const __grid_constant__ CUtensorMap b_map, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~static_cast<uintptr_t>(kAlign - 1));
  const int n_tile = blockIdx.x % p.n_tiles;  // the tiles of one pixel range run side by side
  const int m0 = (blockIdx.x / p.n_tiles) * p.rows;
  const int n0 = n_tile * BN;
  const int halves = p.rows / 64;  // consumer warpgroups with rows to compute
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * halves);  // lane 0 of each working consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x == 256) produce<BN>(&a_map, &b_map, p, smem, full, empty, m0, n0);
    return;
  }
  if (wg < halves) consume<BN>(p, smem, full, empty, m0, n0, wg);
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A driver entry point through the runtime, so the library needs no -lcuda.
void* driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &found) !=
      cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found) != cudaSuccess)
    return nullptr;
#endif
  return found == cudaDriverEntryPointSuccess ? fn : nullptr;
}

CUtensorMapSwizzle swizzle_of(int bk) {
  return bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <int BN>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& b_map, const Params& p,
                   int smem_bytes, long long blocks, cudaStream_t stream) {
  static bool attribute_set[kMaxDevices];
  int device = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!attribute_set[device]) {
    if ((err = cudaFuncSetAttribute(conv3x3_requant_kernel<BN>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSmemBudget + kAlign)) != cudaSuccess)
      return err;
    attribute_set[device] = true;
  }
  conv3x3_requant_kernel<BN>
      <<<static_cast<unsigned>(blocks), kThreads, smem_bytes, stream>>>(a_map, b_map, p);
  return cudaGetLastError();
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The tile's width: the narrowest of the wgmma widths that holds cout, or
// the widest, tiled.
int tile_width(int cout) {
  for (int width : {16, 24, 32, 48, 64, 96}) {
    if (width >= cout) return width;
  }
  return 128;
}

}  // namespace

// x (b, h, w, cin) int8 NHWC codes, contiguous and 16-byte aligned; weight
// the (cout, 9 * cin) int8 rows of `gemm_operand`, K in (ky, kx, cin)
// order, at row stride ldw bytes (a multiple of 16); deq, bias (cout,)
// float32. The conv is 3x3, stride 1, dilation `dilation`, `pad` zero rows
// and columns on every side (SAME: pad = dilation; VALID: 0), so the output
// is (b, h + 2 pad - 2 dilation, w + 2 pad - 2 dilation, cout). Writes
// either the codes (codes non-null, sum_kind 0; low clip 0 if relu, else
// -127) or the sum (codes null; sum_kind 1 float32, 2 bfloat16). cin is a
// multiple of 32.
// Returns 0, a CUDA error, or a CUresult + 10000 from a tensor map's
// encoding. Launches on `stream`.
extern "C" int conv3x3_requant(const int8_t* x, int b, int h, int w, int cin, const int8_t* weight,
                               long long ldw, int cout, int pad, int dilation, const float* deq,
                               const float* bias, float out_scale, int relu, int8_t* codes,
                               void* sum, int sum_kind, void* stream) {
  static EncodeIm2col encode_im2col = nullptr;
  static EncodeTiled encode_tiled = nullptr;
  static int sms[kMaxDevices];
  if (encode_im2col == nullptr) {
    encode_im2col = reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
    encode_tiled = reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
    if (encode_im2col == nullptr || encode_tiled == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
  }
  int device = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0 &&
      (err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return static_cast<int>(err);

  Params p{};
  const int ho = h + 2 * pad - 2 * dilation, wo = w + 2 * pad - 2 * dilation;
  p.m = b * ho * wo;
  p.hw = ho * wo;
  p.wo = wo;
  p.cin = cin;
  p.cout = cout;
  p.pad = pad;
  p.dilation = dilation;
  p.bk = cin % 128 == 0 ? 128 : cin % 64 == 0 ? 64 : 32;
  p.k_blocks = 9 * cin / p.bk;
  const int bn = tile_width(cout);
  p.n_tiles = (cout + bn - 1) / bn;
  p.rows = 128;
  if (static_cast<long long>((p.m + 127) / 128) * p.n_tiles < sms[device]) p.rows = 64;
  p.a_bytes = round_up(p.rows * p.bk, kAlign);
  p.stage_bytes = p.a_bytes + round_up(bn * p.bk, kAlign);
  p.stages = kSmemBudget / p.stage_bytes;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.deq = deq;
  p.bias = bias;
  p.out_scale = out_scale;
  p.inv_scale = 1.0f / out_scale;
  p.low = relu ? 0.0f : -127.0f;
  p.codes = codes;
  p.sum = sum;
  p.sum_kind = sum_kind;

  // A: the codes as (cin, w, h, b), walked in im2col mode. The box's corners
  // bound the window corners of the output pixels: from -pad to
  // (size - 1) + pad - 2 dilation on each axis.
  CUtensorMap a_map, b_map;
  const cuuint64_t a_dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(w),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t a_strides[3] = {static_cast<cuuint64_t>(cin),
                                   static_cast<cuuint64_t>(cin) * w,
                                   static_cast<cuuint64_t>(cin) * w * h};
  const int lower[2] = {-pad, -pad};
  const int upper[2] = {pad - 2 * dilation, pad - 2 * dilation};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult res = encode_im2col(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x),
                               a_dims, a_strides, lower, upper, static_cast<cuuint32_t>(p.bk),
                               static_cast<cuuint32_t>(p.rows), unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               swizzle_of(p.bk), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
  // B: the weight rows as (9 cin, cout); rows past cout read as zeros.
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(9 * cin), static_cast<cuuint64_t>(cout)};
  const cuuint64_t b_strides[1] = {static_cast<cuuint64_t>(ldw)};
  const cuuint32_t b_box[2] = {static_cast<cuuint32_t>(p.bk), static_cast<cuuint32_t>(bn)};
  res = encode_tiled(&b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(weight), b_dims,
                     b_strides, b_box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(p.bk),
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);

  const long long blocks = static_cast<long long>((p.m + p.rows - 1) / p.rows) * p.n_tiles;
  const int smem_bytes = p.stages * p.stage_bytes + kAlign;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return static_cast<int>(launch<16>(a_map, b_map, p, smem_bytes, blocks, s));
    case 24: return static_cast<int>(launch<24>(a_map, b_map, p, smem_bytes, blocks, s));
    case 32: return static_cast<int>(launch<32>(a_map, b_map, p, smem_bytes, blocks, s));
    case 48: return static_cast<int>(launch<48>(a_map, b_map, p, smem_bytes, blocks, s));
    case 64: return static_cast<int>(launch<64>(a_map, b_map, p, smem_bytes, blocks, s));
    case 96: return static_cast<int>(launch<96>(a_map, b_map, p, smem_bytes, blocks, s));
    default: return static_cast<int>(launch<128>(a_map, b_map, p, smem_bytes, blocks, s));
  }
}

