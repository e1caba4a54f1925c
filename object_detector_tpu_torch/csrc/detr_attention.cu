// DETR's multi-head attention core, softmax(Q K^T / sqrt(32)) V per head,
// with each image's padded keys left out: one pass over the unmasked keys
// only, in bfloat16 on the tensor cores with an fp32 online softmax.
//
// Replaces no Pallas kernel: the JAX package has no DETR. It replaces a
// library call on the port's main path (models/detr.py `attend` called
// torch's scaled_dot_product_attention with a boolean key mask, which ran
// cuDNN's fused kernel over every key, masked or not). On a DETR-DC5 batch of
// 32 canvases of 1088 px, C5 holds 4,624 tokens of which about 3,350 are an
// image, and the masked keys of a portrait image lie in almost every block
// of 128 in row-major order, so skipping whole masked blocks would help only
// the landscape images. Here each block gathers its image's unmasked keys
// instead.
//
// Contract (kernels/attention.py `masked_attention`). q (B, Lq, d), k and v
// (B, Lk, d), bfloat16, heads as d-slices of 32, each row 16-byte aligned at
// any row and batch stride (the q / k halves of the fused in-projection go in
// as they lie); key_pad (B, Lk) bytes, nonzero where a key is padding, or
// null. out (B, Lq, d) bfloat16, dense. Every query row is computed, padded
// ones included; a padded key contributes nothing: it is never read.
//
// Numbers. QK^T and PV are mma.sync m16n8k16 on bf16 with fp32 accumulation.
// The softmax is online in fp32 with a running max m and sum l per row: a
// score s becomes p = 2^(s c - m c), c = log2(e) / sqrt(32), one FMA
// (__fmaf_rn: the build's -fmad=false contracts nothing) and one
// ex2.approx.ftz. P is rounded to bf16 for PV, and l is that P times a
// column of ones on the tensor cores, fp32 sums. The output is O divided by
// l once, at the end. m moves only where a tile's largest score passes it by
// more than 8 / c (2^8 in p), so p stays at most 256 and most tiles rescale
// nothing.
//
// What bounds it on an H100: the exponentials. A query-key pair costs 4 * 32
// tensor-core FLOPs and one ex2; at 989e12 FLOP/s and the 16 ex2 a clock an
// SM the MUFU takes about twice the tensor cores' time, and the softmax's
// other fp32 work (max, FMA, conversion: about 3.5 instructions a pair)
// shares the issue slots with both. So the design is about overlap and about
// not computing masked pairs:
//  - a block takes one image, one head and 128 queries (4 warps of 32 rows,
//    two m16 tiles a warp, so a K or V fragment read from shared memory
//    feeds two MMAs: 4 bytes of shared memory a pair, under the MUFU's rate);
//  - at its start the block compacts its image's key_pad into a list of the
//    unmasked key indices in shared memory (a block-wide prefix sum; no host
//    sync, no extra launch);
//  - K and V tiles of 64 listed keys stream through a 3-stage cp.async ring,
//    gathered by index (a head's row is 64 bytes, four 16-byte copies, so a
//    gathered row costs what a contiguous one does); the last tile, ragged,
//    is masked by the count in a copy of the tile's code of its own;
//  - three blocks an SM (12 warps, 168 registers) let one warp's
//    exponentials run while another's MMAs do.
// Shared-memory rows are 64 bytes with their four 16-byte chunks swizzled by
// (row / 2) % 4, so each ldmatrix phase of eight rows hits 32 banks.
// (Measured on an H100 at the DETR cell's shapes: a warpgroup-MMA form of
// the same loop, with or without the next tile's QK^T in flight, ran within
// 5% of this one.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using int8mma::cp_async16;
using int8mma::cp_async_commit;
using int8mma::cp_async_wait;
using int8mma::ldmatrix_x4;
using int8mma::smem_addr;

constexpr int kHeadDim = 32;
constexpr int kRowBytes = kHeadDim * 2;  // one head's row of bf16
constexpr int kChunks = kRowBytes / 16;  // 16-byte copies a row
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQueryTile = kWarps * 32;  // two m16 tiles a warp
constexpr int kKeyTile = 64;
constexpr int kStages = 3;
constexpr int kTileBytes = kKeyTile * kRowBytes;  // K or V of one key tile
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kQBytes = kQueryTile * kRowBytes;
constexpr unsigned kOnes = 0x3F803F80u;  // two bf16 ones
constexpr float kSlackLog2 = 8.0f;       // how far p may rise above 1

struct Args {
  const __nv_bfloat16* q;
  long long q_bs, q_rs;  // batch and row strides, in elements
  const __nv_bfloat16* k;
  long long k_bs, k_rs;
  const __nv_bfloat16* v;
  long long v_bs, v_rs;
  const uint8_t* pad;  // (B, Lk) at batch stride pad_bs, or null
  long long pad_bs;
  __nv_bfloat16* out;  // (B, Lq, heads * 32), dense
  int lq, lk, heads;
  float scale_log2;  // c = log2(e) / sqrt(32)
};

// Byte offset of 16-byte chunk c of row r in a swizzled tile.
__device__ __forceinline__ unsigned swz(int r, int c) {
  return r * kRowBytes + ((c ^ ((r >> 1) & 3)) << 4);
}

// B fragments of PV from V rows (keys) in shared memory: lane L passes the
// address of row L % 8 + 8 * ((L / 8) % 2), chunk 2 * dp + L / 16.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += a . b, bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// The indices of the unmasked keys of one image, in order, into idx; returns
// their count. Each thread scans a contiguous run of the mask; a block-wide
// exclusive prefix sum of the runs' counts places each run's indices.
__device__ int compact_keys(const uint8_t* pad, int lk, uint16_t* idx, int* warp_total) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = (lk + kThreads - 1) / kThreads;
  const int lo = min(tid * per, lk), hi = min(lo + per, lk);
  int n = 0;
  for (int j = lo; j < hi; ++j) n += __ldg(pad + j) == 0;
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int at = incl - n, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_total[w];
    total += t;
    if (w < warp) at += t;
  }
  for (int j = lo; j < hi; ++j)
    if (__ldg(pad + j) == 0) idx[at++] = static_cast<uint16_t>(j);
  __syncthreads();
  return total;
}

// The running state of a warp's 32 query rows: O (two m-tiles by four
// n-tiles of 8 dims) and, per row (g and g + 8 of each m-tile, g = lane / 4),
// the running max m, m * c and the sum l. l is P times a column of ones, an
// m16n8 accumulator whose 8 columns are equal, so every lane of a quad holds
// its rows' sums: l[mt][2 hr] is row hr's.
struct Rows {
  float o[2][4][4];
  float m[2][2], mc[2][2];
  float l[2][4];
};

// One key tile of 64 listed keys (K at sk, V at sv) into the rows' state.
// kRagged: only the first `left` keys are real (the last tile).
template <bool kRagged>
__device__ __forceinline__ void attend_tile(unsigned sk, unsigned sv, const unsigned (&qf)[2][2][4],
                                            Rows& r, float c, float slack, int left, int lane) {
  // S = Q K^T: n-tile nt holds keys 8 nt .. 8 nt + 7.
  float s[2][8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    unsigned kf[4];
    ldmatrix_x4(kf, sk + swz(nt * 8 + (lane & 7), lane >> 3));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.0f;
      mma_bf16(s[mt][nt], qf[mt][0], kf[0], kf[1]);
      mma_bf16(s[mt][nt], qf[mt][1], kf[2], kf[3]);
    }
  }
  if (kRagged) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (nt * 8 + 2 * (lane & 3) + (e & 1) >= left) {
          s[0][nt][e] = -INFINITY;
          s[1][nt][e] = -INFINITY;
        }
  }

  // Each row's largest score in the tile; a row's 64 scores lie in the 4
  // lanes of a quad.
  float mx[2][2];
  bool grow = false;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float x = fmaxf(s[mt][0][2 * hr], s[mt][0][2 * hr + 1]);
#pragma unroll
      for (int nt = 1; nt < 8; ++nt) x = fmaxf(x, fmaxf(s[mt][nt][2 * hr], s[mt][nt][2 * hr + 1]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      mx[mt][hr] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      grow |= mx[mt][hr] > __fadd_rn(r.m[mt][hr], slack);
    }
  // Rescale the rows whose max moves (all of them on the first tile).
  if (__any_sync(0xffffffffu, grow)) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (!(mx[mt][hr] > __fadd_rn(r.m[mt][hr], slack))) continue;
        const float mc = __fmul_rn(mx[mt][hr], c);
        const float alpha = ex2(__fmaf_rn(r.m[mt][hr], c, -mc));
        r.m[mt][hr] = mx[mt][hr];
        r.mc[mt][hr] = mc;
        r.l[mt][2 * hr] *= alpha;
        r.l[mt][2 * hr + 1] *= alpha;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          r.o[mt][n][2 * hr] *= alpha;
          r.o[mt][n][2 * hr + 1] *= alpha;
        }
      }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = ex2(__fmaf_rn(s[mt][nt][e], c, -r.mc[mt][e / 2]));

  // O += P V and l += P 1: k-step kk covers keys 16 kk .. 16 kk + 15 (S
  // n-tiles 2 kk and 2 kk + 1).
#pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk) {
    unsigned pa[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      mma_bf16(r.l[mt], pa[mt], kOnes, kOnes);
    }
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      unsigned vf[4];
      ldmatrix_x4_trans(vf, sv + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                     dp * 2 + (lane >> 4)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(r.o[mt][2 * dp], pa[mt], vf[0], vf[1]);
        mma_bf16(r.o[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3) attention_kernel(Args a) {
  // The query tile, the K/V ring and, with a mask, the list of unmasked keys.
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int warp_total[kWarps];
  unsigned char* sq = smem;
  unsigned char* skv = smem + kQBytes;
  uint16_t* sidx = reinterpret_cast<uint16_t*>(smem + kQBytes + kStages * kStageBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQueryTile;
  const __nv_bfloat16* qb = a.q + b * a.q_bs + h * kHeadDim;
  const __nv_bfloat16* kb = a.k + b * a.k_bs + h * kHeadDim;
  const __nv_bfloat16* vb = a.v + b * a.v_bs + h * kHeadDim;

  // The query tile; rows past Lq are zero and never written out.
#pragma unroll
  for (int i = 0; i < kQueryTile * kChunks / kThreads; ++i) {
    const int c = i * kThreads + tid, r = c / kChunks, ch = c % kChunks;
    const bool ok = q0 + r < a.lq;
    cp_async16(smem_addr(sq + swz(r, ch)), (ok ? qb + (q0 + r) * a.q_rs : qb) + ch * 8, ok);
  }
  cp_async_commit();

  const bool listed = a.pad != nullptr;
  const int count = listed ? compact_keys(a.pad + b * a.pad_bs, a.lk, sidx, warp_total) : a.lk;
  const int tiles = (count + kKeyTile - 1) / kKeyTile;

  // K and V of key tile t (listed keys 64 t ..) into the stage at byte offset
  // `stage`; keys past the count are zero-filled. Thread tid copies 16-byte
  // chunk tid % 4 of the tile's keys tid / 4 and tid / 4 + 32 (whose
  // swizzled rows lie half a tile apart).
  const int lr = tid / kChunks, lch = tid % kChunks;
  const unsigned kv_dst = smem_addr(skv) + swz(lr, lch);
  const __nv_bfloat16* kc = kb + lch * 8;
  const __nv_bfloat16* vc = vb + lch * 8;
  auto load_tile = [&](int t, unsigned stage) {
    const int j0 = t * kKeyTile + lr, j1 = j0 + kKeyTile / 2;
    const bool ok0 = j0 < count, ok1 = j1 < count;
    int key0 = 0, key1 = 0;
    if (ok0) key0 = listed ? sidx[j0] : j0;
    if (ok1) key1 = listed ? sidx[j1] : j1;
    const unsigned dst = kv_dst + stage;
    cp_async16(dst, kc + key0 * a.k_rs, ok0);
    cp_async16(dst + kTileBytes / 2, kc + key1 * a.k_rs, ok1);
    cp_async16(dst + kTileBytes, vc + key0 * a.v_rs, ok0);
    cp_async16(dst + kTileBytes + kTileBytes / 2, vc + key1 * a.v_rs, ok1);
  };
  auto next = [](unsigned stage) {
    return stage == (kStages - 1) * kStageBytes ? 0u : stage + kStageBytes;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile(s, s * kStageBytes);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the query tile
  __syncthreads();

  // Q's A fragments: m-tile mt (rows 32 warp + 16 mt ..), k-step ks (dims 16 ks ..).
  unsigned qf[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldmatrix_x4(qf[mt][ks], smem_addr(sq + swz(warp * 32 + mt * 16 + (lane & 7) +
                                                     ((lane >> 3) & 1) * 8,
                                                 ks * 2 + (lane >> 4))));

  Rows r;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) r.o[mt][n][e] = 0.0f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) r.m[mt][hr] = r.mc[mt][hr] = -INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e) r.l[mt][e] = 0.0f;
  }

  const float c = a.scale_log2, slack = __fdiv_rn(kSlackLog2, c);
  const int full = count / kKeyTile;  // tiles of 64 real keys; then one ragged, if any
  unsigned rd = 0, wr = (kStages - 1) * kStageBytes;  // stages read and written
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for all; tile t - 1's stage is free
    if (t + kStages - 1 < tiles) load_tile(t + kStages - 1, wr);
    cp_async_commit();
    const unsigned sk = smem_addr(skv) + rd, sv = sk + kTileBytes;
    if (t < full)
      attend_tile<false>(sk, sv, qf, r, c, slack, kKeyTile, lane);
    else
      attend_tile<true>(sk, sv, qf, r, c, slack, count - t * kKeyTile, lane);
    rd = next(rd);
    wr = next(wr);
  }
  cp_async_wait<0>();

  // O / l, rounded to bf16. With no unmasked key l is 0 and the row is NaN,
  // as a softmax over nothing is.
  const int d = a.heads * kHeadDim;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float l = r.l[mt][2 * hr];
      const int row = q0 + warp * 32 + mt * 16 + (lane >> 2) + hr * 8;
      if (row >= a.lq) continue;
      __nv_bfloat16* dst = a.out + (static_cast<long long>(b) * a.lq + row) * d +
                           h * kHeadDim + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<unsigned*>(dst + n * 8) =
            pack_bf16(__fdiv_rn(r.o[mt][n][2 * hr], l), __fdiv_rn(r.o[mt][n][2 * hr + 1], l));
    }
}

}  // namespace

extern "C" int detr_attention(const void* q, long long q_bs, long long q_rs, const void* k,
                              long long k_bs, long long k_rs, const void* v, long long v_bs,
                              long long v_rs, const void* key_pad, long long pad_bs, void* out,
                              int batch, int lq, int lk, int heads, float scale_log2,
                              void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q), q_bs, q_rs,
               static_cast<const __nv_bfloat16*>(k), k_bs, k_rs,
               static_cast<const __nv_bfloat16*>(v), v_bs, v_rs,
               static_cast<const uint8_t*>(key_pad), pad_bs,
               static_cast<__nv_bfloat16*>(out), lq, lk, heads, scale_log2};
  // The query tile, the K/V ring and, with a mask, the list of unmasked keys:
  // within the 48 KB a block has without opting in (the wrapper refuses
  // more than 8184 masked keys).
  const int smem =
      kQBytes + kStages * kStageBytes + (key_pad != nullptr ? (2 * lk + 15) / 16 * 16 : 0);
  const dim3 grid((lq + kQueryTile - 1) / kQueryTile, heads, batch);
  attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
