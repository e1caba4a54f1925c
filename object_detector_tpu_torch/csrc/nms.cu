// Greedy per-class NMS over rows of candidates, by argmax emit.
//
// Replaces the Pallas TPU kernel object_detector_tpu/kernels/nms_pallas.py
// ::_nms_kernel (:61, launched through _nms_rows, pallas_call at :343).
//
// Contract. Each of R rows holds k candidate columns: corner planes x1, y1,
// x2, y2 (coords, laid out (4, R, k)) and scores (R, k), float32. The
// kernel makes up to max_out emit steps per row. Each step takes the argmax
// of the remaining scores (the first index wins a tie); the winner is valid
// only if its score > score_threshold; a valid winner's score and column go
// to slot j. Then the winner and every column with
// inter > area * t + w_area * t are zeroed, where t = iou / (1 + iou) is
// rounded once to float32 on the host, area = max(x2 - x1, 0) *
// max(y2 - y1, 0), the winner's corners are max(x[w], 0) as the
// reference's masked max with identity 0 gives them (x[w] itself for the
// [0, 1] boxes that decode produces), and inter =
// max(min(wx2, x2) - max(wx1, x1), 0) * (min(wy2, y2) - max(wy1, y1)) with
// one clamp only. This is the union-free form of IoU > iou. A row stops at its first invalid step; every slot from
// there on holds score 0 and column 0, as the reference's zeroed
// accumulators do. The kernel writes every output slot.
//
// Bit-exactness. The reference rounds after every operation. nvcc would
// contract a * b + c into one FMA, so every product and sum here is an
// explicit round-to-nearest intrinsic, and the build passes -fmad=false too.
//
// Coordinates in bfloat16 (nms_rows_bf16, the reference's coord_bf16: the
// same _nms_kernel reads the planes' dtype at nms_pallas.py:76 and runs its
// plane arithmetic in it). Scores, the argmax and the emitted scores stay
// float32. Every coordinate operation (the areas, area * t, w_area * t, the
// intersection's sides, inter, the right-hand side's add) is computed in
// float32 by its _rn intrinsic and rounded to bfloat16 at once with
// __float2bfloat16_rn; min, max and the clamps are exact on bfloat16 values.
// Only the suppress compare reads the two bfloat16 values as float32, as
// the reference upcasts its one compare (:137-141). This is how PyTorch's
// bf16 elementwise ops round, so the kernel equals its plain version bit for
// bit. t is rounded on the host to bfloat16 (through float32, as the
// reference's ml_dtypes scalar cdt.type(t) is). The registers and the
// shared memory hold the coordinates as float32 in both instantiations:
// bfloat16 halves only the bytes read from device memory, and each rounding
// is a float32 -> bfloat16 -> float32 conversion pair on the critical path,
// so this instantiation is slower than the float32 one (PERF.md). Hopper's
// packed bfloat16 arithmetic (HADD2/HMUL2.BF16) rounds once in bfloat16,
// where PyTorch's ops round a float32 result; a faster design has to show
// those agree on every input it runs.
//
// What bounds it on an H100. At the SSD-300 bs=64 shape (R = 1280,
// k = 512, max_out = 100) the kernel reads 13 MB, about 4 us at 3.35 TB/s,
// and does 12 float32 operations per column per emit step (2 argmax
// compares, 7 for the intersection's sides, its multiply, the right-hand
// side's add, the suppress compare), about 0.79 G operations at most. None
// is an FMA, so they issue at half the data sheet's 67 TFLOP/s: about 23 us.
// The operations bound it, not the bytes. Past both lies the serial chain
// inside a row: every step is an argmax over the whole row that the next
// step depends on. The first design gave each row a block of 128 threads
// and paid three __syncthreads and a serial combine in one thread a step:
// 0.180 ms at 1280 rows and 0.590 ms at 5120, where the barriers, not the
// operations, set the pace. This one takes 0.0764 ms at the SSD-300 bs=64
// path's 1280 rows and 0.233 ms at SSD-512's 5120 (5.9x and 3.0x the
// bound), and 0.0378 and 0.0386 ms at the bs=1 paths' 20 and 80 rows, where
// one row's chain of emit steps sets the time and a few blocks cannot fill
// 132 SMs (chip_smoke.py, CUDA-graph replay, NVIDIA H100 80GB HBM3,
// 700.00 W). Most of a step's instructions are the suppress test's min/max
// and compares, 16 columns a lane at k = 512, which run at half rate.
//
// Design. Rows of up to kWarpMaxK = 512 columns (every serving path's) take
// the warp route: one warp owns a row, four rows a block. Lane l holds
// columns l, l + 32, ... (J = 1, 2, 4, 8 or 16 of them, the fewest that
// cover k) in registers: the four corners, area * t and the remaining
// score, 96 registers at k = 512; columns past k hold score -inf and
// area * t = +inf, so they never win and are never suppressed. A step takes
// the lane's best as a tree (four dependent compares at k = 512, not
// sixteen), then the warp's with two __reduce_max_sync / __reduce_min_sync
// (one instruction each, where five __shfl_xor_sync rounds of (score,
// column) are five dependent shuffle pairs): the largest score as an
// order-preserving key, then the lowest column among the lanes that hold
// it. The winner's corners come in one 16-byte broadcast read from the
// warp's own copy of the row's boxes in shared memory, written once when the
// row is loaded (16 bytes a column, 8 KB at k = 512): picking them from the
// owning lane's registers would take 60 selects a step, which run at half
// rate. Each lane then suppresses its own columns. The emit loop has no
// barrier and writes no shared memory; device memory is read once and
// written once. Wider rows (k up to 8192) take the block route, the first
// design: one block of 128 threads a row, the row in shared memory (24 bytes
// a column).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpMaxK = 512;  // the widest row of the warp route: 16 columns a lane

// Coordinate planes of type T: a load to float32, and the rounding of a
// float32 result to T (none for float32).
__device__ __forceinline__ float load_coord(const float* p) { return *p; }
__device__ __forceinline__ float load_coord(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// a - b, a * b, a + b rounded to nearest in float32 and then to T.
template <typename T>
__device__ __forceinline__ float sub(float a, float b) { return round_to<T>(__fsub_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float mul(float a, float b) { return round_to<T>(__fmul_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float add(float a, float b) { return round_to<T>(__fadd_rn(a, b)); }

// max(x2 - x1, 0) * max(y2 - y1, 0) in T's rounding.
template <typename T>
__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return mul<T>(fmaxf(sub<T>(x2, x1), 0.0f), fmaxf(sub<T>(y2, y1), 0.0f));
}

// A key whose unsigned order is the float order of s, with -0 taken as +0
// (they compare equal): the warp's argmax is then one __reduce_max_sync.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(__fadd_rn(s, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The first of the largest of v[0 .. J) and its index, as a tree over
// neighbouring ranges (the left range holds the lower indices, so a strict >
// keeps the first on ties): log2(J) dependent steps, not J.
template <int J>
__device__ __forceinline__ void lane_argmax(const float (&v)[J], float& s, int& j) {
  float ts[J];
  int tj[J];
#pragma unroll
  for (int i = 0; i < J; ++i) {
    ts[i] = v[i];
    tj[i] = i;
  }
#pragma unroll
  for (int step = 1; step < J; step *= 2) {
#pragma unroll
    for (int i = 0; i + step < J; i += 2 * step) {
      if (ts[i + step] > ts[i]) {
        ts[i] = ts[i + step];
        tj[i] = tj[i + step];
      }
    }
  }
  s = ts[0];
  j = tj[0];
}

// (s, i) takes (os, oi) if it has the higher score, or the same score at a
// lower column.
__device__ __forceinline__ void take_better(float& s, int& i, float os, int oi) {
  if (os > s || (os == s && oi < i)) {
    s = os;
    i = oi;
  }
}

// The warp route: warp w of block b owns row 4 b + w; lane l holds columns
// l + 32 j, j < J. T is the coordinates' type.
template <typename T, int J>
__global__ void __launch_bounds__(kThreads, 4) nms_rows_kernel(
    const T* __restrict__ coords, const float* __restrict__ scores,
    int rows, int k, int max_out, float t_ratio, float score_threshold,
    float* __restrict__ out_scores, int* __restrict__ out_cols) {
  extern __shared__ float4 s_boxes_all[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float4* s_boxes = s_boxes_all + (threadIdx.x >> 5) * 32 * J;  // this warp's row
  const size_t plane = static_cast<size_t>(rows) * k;
  const T* x1_row = coords + static_cast<size_t>(row) * k;
  const float* score_row = scores + static_cast<size_t>(row) * k;
  float x1[J], y1[J], x2[J], y2[J], area_scaled[J], remaining[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    if (c < k) {
      x1[j] = load_coord(x1_row + c);
      y1[j] = load_coord(x1_row + plane + c);
      x2[j] = load_coord(x1_row + 2 * plane + c);
      y2[j] = load_coord(x1_row + 3 * plane + c);
      s_boxes[c] = make_float4(x1[j], y1[j], x2[j], y2[j]);
      area_scaled[j] = mul<T>(box_area<T>(x1[j], y1[j], x2[j], y2[j]), t_ratio);
      remaining[j] = score_row[c];
    } else {
      x1[j] = y1[j] = x2[j] = y2[j] = 0.0f;
      area_scaled[j] = CUDART_INF_F;
      remaining[j] = -CUDART_INF_F;
    }
  }
  __syncwarp();

  float* out_s = out_scores + static_cast<size_t>(row) * max_out;
  int* out_c = out_cols + static_cast<size_t>(row) * max_out;
  const unsigned threshold_key = order_key(score_threshold);
  int j = 0;
  for (; j < max_out; ++j) {
    // The lane's best (the first of equal scores), then the warp's: the
    // largest key, and among the lanes that hold it the lowest column.
    float best_s;
    int best_j;
    lane_argmax(remaining, best_s, best_j);
    const unsigned key = order_key(best_s);
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    // Uniform across the warp: the winner's score is valid iff its key is
    // above the threshold's.
    if (!(top > threshold_key)) break;
    const int w = static_cast<int>(__reduce_min_sync(
        0xffffffffu, key == top ? static_cast<unsigned>(lane + 32 * best_j) : 0xffffffffu));
    const int owner = w & 31;
    if (lane == owner) {  // its own best is the winner: no lower column holds the top score
      out_s[j] = best_s;
      out_c[j] = w;
    }
    const float4 wbox = s_boxes[w];  // one broadcast read
    float wx1 = wbox.x, wy1 = wbox.y, wx2 = wbox.z, wy2 = wbox.w;
    // The reference's masked max with identity 0: max(x[w], 0) once the row
    // has a second column.
    if (k > 1) {
      wx1 = fmaxf(wx1, 0.0f);
      wy1 = fmaxf(wy1, 0.0f);
      wx2 = fmaxf(wx2, 0.0f);
      wy2 = fmaxf(wy2, 0.0f);
    }
    const float w_scaled = mul<T>(box_area<T>(wx1, wy1, wx2, wy2), t_ratio);
    const int mine = lane == owner ? best_j : -1;  // the winner's slot in this lane
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const float iw = fmaxf(sub<T>(fminf(wx2, x2[jj]), fmaxf(wx1, x1[jj])), 0.0f);
      const float ih = sub<T>(fminf(wy2, y2[jj]), fmaxf(wy1, y1[jj]));
      const float inter = mul<T>(iw, ih);
      // Both tests evaluated and one select: a short-circuit || compiles to a
      // branch a column.
      const bool hit = inter > add<T>(area_scaled[jj], w_scaled);
      remaining[jj] = (hit | (jj == mine)) ? 0.0f : remaining[jj];
    }
  }
  for (int slot = j + lane; slot < max_out; slot += 32) {
    out_s[slot] = 0.0f;
    out_c[slot] = 0;
  }
}

// The block route for rows wider than kWarpMaxK: one block of 128 threads a
// row; thread t owns columns t, t + 128, ... . The row's four corner planes,
// its remaining scores and the hoisted area * t stay in shared memory (24
// bytes a column) for all steps. Each step reduces (score, column) pairs with
// warp shuffles and then across the four warps, ties going to the lower
// column, and reads the winner's corners straight from shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads) nms_rows_block_kernel(
    const T* __restrict__ coords, const float* __restrict__ scores,
    int rows, int k, int max_out, float t_ratio, float score_threshold,
    float* __restrict__ out_scores, int* __restrict__ out_cols) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  float* remaining = sy2 + k;
  float* area_scaled = remaining + k;
  __shared__ float warp_best_s[kWarps];
  __shared__ int warp_best_i[kWarps];
  __shared__ float winner_s;
  __shared__ int winner_i;

  const int row = blockIdx.x;
  const size_t plane = static_cast<size_t>(rows) * k;
  const T* x1_row = coords + static_cast<size_t>(row) * k;
  const float* score_row = scores + static_cast<size_t>(row) * k;
  for (int c = threadIdx.x; c < k; c += kThreads) {
    const float x1 = load_coord(x1_row + c);
    const float y1 = load_coord(x1_row + plane + c);
    const float x2 = load_coord(x1_row + 2 * plane + c);
    const float y2 = load_coord(x1_row + 3 * plane + c);
    sx1[c] = x1;
    sy1[c] = y1;
    sx2[c] = x2;
    sy2[c] = y2;
    area_scaled[c] = mul<T>(box_area<T>(x1, y1, x2, y2), t_ratio);
    remaining[c] = score_row[c];
  }
  __syncthreads();

  float* out_s = out_scores + static_cast<size_t>(row) * max_out;
  int* out_c = out_cols + static_cast<size_t>(row) * max_out;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int j = 0;
  for (; j < max_out; ++j) {
    float best_s = -CUDART_INF_F;
    int best_i = k;
    for (int c = threadIdx.x; c < k; c += kThreads) {
      take_better(best_s, best_i, remaining[c], c);
    }
    for (int offset = 16; offset > 0; offset >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, best_s, offset);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, offset);
      take_better(best_s, best_i, os, oi);
    }
    if (lane == 0) {
      warp_best_s[warp] = best_s;
      warp_best_i[warp] = best_i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = warp_best_s[0];
      int i = warp_best_i[0];
      for (int w = 1; w < kWarps; ++w) take_better(s, i, warp_best_s[w], warp_best_i[w]);
      winner_s = s;
      winner_i = i;
    }
    __syncthreads();
    const float s = winner_s;
    const int w = winner_i;
    // Uniform across the block: every thread read the same winner.
    if (!(s > score_threshold)) break;
    if (threadIdx.x == 0) {
      out_s[j] = s;
      out_c[j] = w;
    }
    // The reference takes the winner's corners as a masked max over the row
    // with 0 as the identity, which is max(x[w], 0) once the row has a
    // second column.
    const float wx1 = k > 1 ? fmaxf(sx1[w], 0.0f) : sx1[w];
    const float wy1 = k > 1 ? fmaxf(sy1[w], 0.0f) : sy1[w];
    const float wx2 = k > 1 ? fmaxf(sx2[w], 0.0f) : sx2[w];
    const float wy2 = k > 1 ? fmaxf(sy2[w], 0.0f) : sy2[w];
    const float w_scaled = mul<T>(box_area<T>(wx1, wy1, wx2, wy2), t_ratio);
    for (int c = threadIdx.x; c < k; c += kThreads) {
      const float iw = fmaxf(sub<T>(fminf(wx2, sx2[c]), fmaxf(wx1, sx1[c])), 0.0f);
      const float ih = sub<T>(fminf(wy2, sy2[c]), fmaxf(wy1, sy1[c]));
      const float inter = mul<T>(iw, ih);
      if (c == w || inter > add<T>(area_scaled[c], w_scaled)) remaining[c] = 0.0f;
    }
    __syncthreads();
  }
  for (int slot = j + threadIdx.x; slot < max_out; slot += kThreads) {
    out_s[slot] = 0.0f;
    out_c[slot] = 0;
  }
}

template <typename T, int J>
void launch_warp_route(const T* coords, const float* scores, int rows, int k, int max_out,
                       float t_ratio, float score_threshold, float* out_scores, int* out_cols,
                       cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  const size_t smem = kWarps * 32 * J * sizeof(float4);
  nms_rows_kernel<T, J><<<blocks, kThreads, smem, stream>>>(
      coords, scores, rows, k, max_out, t_ratio, score_threshold, out_scores, out_cols);
}

// Launches either route on `stream` and returns cudaGetLastError() (0 on
// success).
template <typename T>
int launch(const T* coords, const float* scores, int rows, int k, int max_out, float t_ratio,
           float score_threshold, float* out_scores, int* out_cols, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= kWarpMaxK) {
    // The fewest columns a lane that cover the row.
    const auto warp = k <= 32    ? launch_warp_route<T, 1>
                      : k <= 64  ? launch_warp_route<T, 2>
                      : k <= 128 ? launch_warp_route<T, 4>
                      : k <= 256 ? launch_warp_route<T, 8>
                                 : launch_warp_route<T, 16>;
    warp(coords, scores, rows, k, max_out, t_ratio, score_threshold, out_scores, out_cols, st);
    return static_cast<int>(cudaGetLastError());
  }
  const auto block = nms_rows_block_kernel<T>;
  // The dynamic shared memory is allowed for every k: the block's static
  // shared memory (the per-warp bests and the winner) comes on top, so rows
  // just under the default 48 KB of dynamic memory (2041 to 2048 columns)
  // would not launch without it either.
  const size_t smem = 6 * static_cast<size_t>(k) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      block, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  block<<<rows, kThreads, smem, st>>>(
      coords, scores, rows, k, max_out, t_ratio, score_threshold, out_scores, out_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Float32 coordinates. Launches on `stream` and returns cudaGetLastError().
extern "C" int nms_rows(const float* coords, const float* scores, int rows, int k,
                        int max_out, float t_ratio, float score_threshold,
                        float* out_scores, int* out_cols, void* stream) {
  return launch(coords, scores, rows, k, max_out, t_ratio, score_threshold, out_scores, out_cols,
                stream);
}

// Bfloat16 coordinates (scores float32); t_ratio must be a bfloat16 value.
extern "C" int nms_rows_bf16(const __nv_bfloat16* coords, const float* scores, int rows, int k,
                             int max_out, float t_ratio, float score_threshold,
                             float* out_scores, int* out_cols, void* stream) {
  return launch(coords, scores, rows, k, max_out, t_ratio, score_threshold, out_scores, out_cols,
                stream);
}

// The widest row of the warp route.
extern "C" int nms_rows_warp_max_k() { return kWarpMaxK; }
