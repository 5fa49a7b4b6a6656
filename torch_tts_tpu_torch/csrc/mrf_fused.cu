// Fused HiFi-GAN MRF bank: a planned sequence of launches, each running one
// ResBlock1 iteration (two convs and the residual) on time tiles held in
// shared memory, every conv an implicit GEMM on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel torch_tts_tpu/kernels/mrf_fused.py (mrf_fused ->
// _mrf_kernel). Contract of the Python wrapper
// (torch_tts_tpu_torch/kernels/mrf_fused.py): x [B, T, C] fp32, per conv a
// flat weight [k*C, C] (row tap*C + ci, column co), a bias [C] and static
// output-relative tap offsets; out = mean over blocks of the block's output.
//
// Bound on the H100: operations. At the decoder's shapes the bank is about
// 473.5 GFLOP per B=1, 1024-frame call. fp32 outside the tensor cores peaks
// at 67 TFLOP/s; the TF32 tensor cores at 495, and 3xTF32 (three TF32
// products a fp32 product, fp32-level error) at 165.
//
// Design:
// - One launch per ResBlock1 iteration (lrelu -> conv1 -> lrelu -> conv2 ->
//   residual add), so a launch's halo is that iteration's reach (at most
//   30 frames, for k=11 at dilation 5). The iterations of a block pass
//   their [B, T, C] result through two scratch buffers in global memory;
//   the block's last iteration accumulates the mean over blocks into `out`,
//   which each CTA owns for its tile. The Python planner (plan_mrf) orders
//   the launches and picks each one's tile.
// - Shared memory: two [W, C] fp32 window buffers (rows padded to C + 4
//   floats), the residual stream xb and the intermediate t, and a ring
//   holding one weight chunk [32 input channels, C] as two TF32 tiles, hi
//   and lo. Conv 1 reads lrelu(xb) and writes lrelu(conv) to t; conv 2
//   reads t and adds into xb in place.
// - Each conv is out[r, co] = sum_tap sum_ci in[r + off_tap, ci] w[tap, ci, co]:
//   M = the window rows it computes ([lo, hi), planned in Python), N = C,
//   K = taps x C, on Hopper's warpgroup products: wgmma.m64nCk8 tf32, A
//   from registers, B from shared memory. A dilated tap shifts the A rows by
//   any offset; with A in registers each thread loads its fragment rows from
//   the window, so a shift costs nothing. (A in shared memory would need
//   the rows of each 8-row core matrix at fixed strides.) B is K-major, as
//   tf32 requires, with no swizzle: 8-row x 16-byte core matrices, LBO the
//   stride between the two K halves of a k8 step, SBO between 8-row groups.
// - 8 warps, two warpgroups: at C=128 each takes 64 rows, at C<=64 two
//   m64 tiles, so a pass covers 128 rows at C=128 and 256 at C<=64
//   (rows_per_pass in mrf_fused.py); a warpgroup whose rows all lie past
//   hi skips the products.
// - 3xTF32 (wgmma_tf32.cuh, shared with the WN backward). Weights are
//   split once a CTA, while staged into the ring; activations as their
//   fragments are read from the window
//   (after the leaky ReLU for conv 1).
// - Weight staging: the chunks of a conv (per pass, per tap, per 32 input
//   channels) come from L2 into registers while the previous chunk is
//   multiplied, then are split and transposed into the ring (cp.async
//   cannot split on the way). A second ring slot would cost window rows:
//   on the card, a two-slot ring of 16-channel chunks that overlapped the
//   staging with the products was slower than this one.
// - Every conv output is multiplied by the validity of its position
//   (0 <= pos < T) before the next activation, which reproduces zero
//   padding at the sequence ends exactly.
// - CTAs run in any order; nothing is carried between them.

#include <cuda_runtime.h>
#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

using namespace tts_wgmma;

constexpr int kThreads = 256;
constexpr int kKChunk = 32;    // input channels per staged weight chunk
constexpr int kMaxTaps = 16;
constexpr int kMetaPerConv = 3 + kMaxTaps;
constexpr int kMetaHead = 6;
constexpr int kMetaPerLaunch = kMetaHead + 2 * kMetaPerConv;
constexpr float kSlope = 0.1f;
constexpr int kPad = 4;   // floats of padding per window row

// epilogue: dst = xb | dst += xb | dst = (dst + xb) / div | dst = xb / div
enum Mode { kStore = 0, kAdd = 1, kAddDiv = 2, kDiv = 3 };

struct MrfConv {
  const float* w;  // [k*C, C]
  const float* b;  // [C]
  int k;
  int lo, hi;      // window rows computed by this conv
  int off[kMaxTaps];
};

struct MrfLaunch {
  int T, T0, halo, W;
  int mode;
  float div;
  MrfConv conv[2];  // conv1 (reads lrelu(x)), conv2 (adds into x)
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

// dst[r] = epilogue(sum_tap src[r + off[tap]] @ w[tap]) for window rows
// r in [c.lo, c.hi). FIRST: src is the residual stream (lrelu on load) and
// dst[r] = lrelu(valid * (acc + b)); else dst[r] += valid * (acc + b).
// Window rows are C + kPad floats apart.
template <int C, bool FIRST>
__device__ __forceinline__ void conv_rows(const float* __restrict__ src, float* __restrict__ dst,
                                          float* __restrict__ ring, const MrfConv& c,
                                          int win_start, int T) {
  constexpr int MT = C == 128 ? 1 : 2;      // m64 tiles a warpgroup
  constexpr int ROWS = 2 * 64 * MT;         // two warpgroups
  constexpr int NR = C / 2;                 // accumulator registers a tile
  constexpr int CP = C + kPad;
  constexpr int CHUNKS = C / kKChunk;
  constexpr int NQ = kKChunk / 4 * C;       // (ci4, co) pairs a chunk
  constexpr int PIECES = NQ / kThreads;
  static_assert(PIECES * kThreads == NQ, "chunk copy");
  constexpr int TILE = kKChunk * C;         // floats of one (hi or lo) tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg = warp >> 2;
  const int m0 = wg * 64 * MT + (warp & 3) * 16;  // this warp's first row in the pass
  const int per_pass = c.k * CHUNKS;
  const int n_steps = (c.hi - c.lo + ROWS - 1) / ROWS * per_pass;
  float* ring_hi = ring;
  float* ring_lo = ring + TILE;

  // chunk [kKChunk ci, C co] -> K-major core matrices: (ci / 4, co / 8) at
  // float (ci / 4 * C / 8 + co / 8) * 32, element (co % 8) * 4 + ci % 4
  float wreg[PIECES][4];
  auto fetch = [&](int step) {
    const int st = step % per_pass;
    const float* wsrc = c.w + (size_t)((st / CHUNKS) * C + (st % CHUNKS) * kKChunk) * C;
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int p = threadIdx.x + i * kThreads;
      const int co = p % C, ci4 = p / C;
#pragma unroll
      for (int q = 0; q < 4; ++q) wreg[i][q] = __ldg(wsrc + (size_t)(ci4 * 4 + q) * C + co);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int p = threadIdx.x + i * kThreads;
      const int co = p % C, ci4 = p / C;
      uint32_t h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(wreg[i][q], h[q], l[q]);
      const int o = (ci4 * (C / 8) + co / 8) * 32 + (co % 8) * 4;
      *reinterpret_cast<uint4*>(ring_hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(ring_lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  };

  float acc[MT][NR];
  fetch(0);
  for (int step = 0; step < n_steps; ++step) {
    const int st = step % per_pass;
    const int pass_base = c.lo + (step / per_pass) * ROWS;
    const bool active = pass_base + wg * 64 * MT < c.hi;  // uniform in the warpgroup
    if (st == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < NR; ++e) acc[mt][e] = 0.f;
    }
    stage();
    fence_async_shared();
    __syncthreads();  // chunk `step` is in the ring for every warpgroup
    if (step + 1 < n_steps) fetch(step + 1);

    if (active) {
      const int off = c.off[st / CHUNKS];
      const int ci0 = (st % CHUNKS) * kKChunk;
      uint32_t ah[MT][kKChunk / 8][4], al[MT][kKChunk / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = min(pass_base + m0 + mt * 64 + g, c.hi - 1);
        const int r1 = min(pass_base + m0 + mt * 64 + g + 8, c.hi - 1);
        const float* a0 = src + (r0 + off) * CP + ci0 + t4;
        const float* a1 = src + (r1 + off) * CP + ci0 + t4;
#pragma unroll
        for (int kk = 0; kk < kKChunk / 8; ++kk) {
          float v[4] = {a0[8 * kk], a1[8 * kk], a0[8 * kk + 4], a1[8 * kk + 4]};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(FIRST ? lrelu(v[e]) : v[e], ah[mt][kk][e], al[mt][kk][e]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < NR; ++e) keep(acc[mt][e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKChunk / 8; ++kk) {
        const uint64_t dh = smem_desc(ring_hi + 2 * kk * (C / 8) * 32, (C / 8) * 128, 128);
        const uint64_t dl = smem_desc(ring_lo + 2 * kk * (C / 8) * 32, (C / 8) * 128, 128);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) wgmma_tf32<C>(acc[mt], al[mt][kk], dh);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) wgmma_tf32<C>(acc[mt], ah[mt][kk], dl);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) wgmma_tf32<C>(acc[mt], ah[mt][kk], dh);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < NR; ++e) keep(acc[mt][e]);
#pragma unroll
        for (int kk = 0; kk < kKChunk / 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) { keep(ah[mt][kk][e]); keep(al[mt][kk][e]); }
      }

      if (st == per_pass - 1) {
        // d[4 j + {0, 1}] at (g, 8 j + 2 t4 + {0, 1}); d[4 j + {2, 3}] at (g + 8, ...)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = pass_base + m0 + mt * 64 + h * 8 + g;
            if (r >= c.hi) continue;
            const int pos = win_start + r;
            const float valid = (pos >= 0 && pos < T) ? 1.f : 0.f;
#pragma unroll
            for (int j = 0; j < C / 8; ++j) {
              const int co = j * 8 + 2 * t4;
              const float2 bias = __ldg(reinterpret_cast<const float2*>(c.b + co));
              const float v0 = (acc[mt][4 * j + 2 * h] + bias.x) * valid;
              const float v1 = (acc[mt][4 * j + 2 * h + 1] + bias.y) * valid;
              float2* d = reinterpret_cast<float2*>(dst + r * CP + co);
              if (FIRST) {
                *d = make_float2(lrelu(v0), lrelu(v1));
              } else {
                float2 o = *d;
                o.x += v0;
                o.y += v1;
                *d = o;
              }
            }
          }
      }
    }
    __syncthreads();
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
mrf_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const __grid_constant__ MrfLaunch a) {
  extern __shared__ float4 smem4[];
  constexpr int C4 = C / 4;
  constexpr int CP4 = (C + kPad) / 4;
  float* xb = reinterpret_cast<float*>(smem4);
  float* tb = xb + a.W * (C + kPad);
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(tb + a.W * (C + kPad)) + 127) & ~(uintptr_t)127);
  const int tile = blockIdx.x;
  const int win_start = tile * a.T0 - a.halo;
  const float* xbat = x + (size_t)blockIdx.y * a.T * C;
  float* obat = out + (size_t)blockIdx.y * a.T * C;

  for (int i = threadIdx.x; i < a.W * C4; i += kThreads) {
    const int r = i / C4;
    const int pos = win_start + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos >= 0 && pos < a.T)
      v = __ldg(reinterpret_cast<const float4*>(xbat + (size_t)pos * C) + i % C4);
    smem4[r * CP4 + i % C4] = v;
  }
  __syncthreads();

  conv_rows<C, true>(xb, tb, ring, a.conv[0], win_start, a.T);
  conv_rows<C, false>(tb, xb, ring, a.conv[1], win_start, a.T);

  for (int i = threadIdx.x; i < a.T0 * C4; i += kThreads) {
    const int r = i / C4;
    const int pos = tile * a.T0 + r;
    if (pos >= a.T) continue;
    const float4 v = smem4[(a.halo + r) * CP4 + i % C4];
    float4* o = reinterpret_cast<float4*>(obat + (size_t)pos * C) + i % C4;
    float4 res;
    if (a.mode == kStore) {
      res = v;
    } else if (a.mode == kDiv) {
      res = make_float4(v.x / a.div, v.y / a.div, v.z / a.div, v.w / a.div);
    } else {
      res = *o;
      res.x += v.x; res.y += v.y; res.z += v.z; res.w += v.w;
      if (a.mode == kAddDiv) {
        res.x /= a.div; res.y /= a.div; res.z /= a.div; res.w /= a.div;
      }
    }
    *o = res;
  }
}

template <int C>
cudaError_t launch_one(const float* x, float* out, int B, const MrfLaunch& blk,
                       cudaStream_t stream) {
  const size_t smem = ((size_t)2 * blk.W * (C + kPad) + 2 * kKChunk * C) * sizeof(float) + 128;
  cudaError_t err = cudaFuncSetAttribute(
      mrf_block_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((blk.T + blk.T0 - 1) / blk.T0, B);
  mrf_block_kernel<C><<<grid, kThreads, smem, stream>>>(x, out, blk);
  return cudaGetLastError();
}

}  // namespace

// One call runs a planned sequence of launches on `stream`, each over
// buffers chosen from {0: x, 1: out, 2: scratch0, 3: scratch1}.
// meta: per launch kMetaPerLaunch ints = [T0, halo, src, dst, mode, div]
// then for conv1 and conv2 [k, lo, hi, off[kMaxTaps]]; w_ptrs / b_ptrs: per
// launch 2 device pointers. Returns the first CUDA error (0 on success).
extern "C" int tts_mrf_fused_forward(const float* x, float* out, float* scratch0,
                                     float* scratch1, int B, int T, int C, int n_launch,
                                     const int* meta, const long long* w_ptrs,
                                     const long long* b_ptrs, void* stream) {
  if (n_launch < 1 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* bufs[4] = {const_cast<float*>(x), out, scratch0, scratch1};
  for (int li = 0; li < n_launch; ++li) {
    const int* m = meta + li * kMetaPerLaunch;
    MrfLaunch blk;
    blk.T = T;
    blk.T0 = m[0];
    blk.halo = m[1];
    blk.W = blk.T0 + 2 * blk.halo;
    const int src = m[2], dst = m[3];
    blk.mode = m[4];
    blk.div = (float)m[5];
    if (blk.T0 < 1 || src < 0 || src > 3 || dst < 1 || dst > 3 || src == dst ||
        blk.mode < kStore || blk.mode > kDiv || m[5] < 1)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 2; ++j) {
      const int* cm = m + kMetaHead + j * kMetaPerConv;
      MrfConv& cv = blk.conv[j];
      cv.w = reinterpret_cast<const float*>(w_ptrs[li * 2 + j]);
      cv.b = reinterpret_cast<const float*>(b_ptrs[li * 2 + j]);
      cv.k = cm[0];
      cv.lo = cm[1];
      cv.hi = cm[2];
      if (cv.k < 1 || cv.k > kMaxTaps || cv.lo < 0 || cv.hi > blk.W || cv.lo >= cv.hi)
        return (int)cudaErrorInvalidValue;
      for (int t = 0; t < kMaxTaps; ++t) cv.off[t] = t < cv.k ? cm[3 + t] : 0;
      for (int t = 0; t < cv.k; ++t)
        if (cv.lo + cv.off[t] < 0 || cv.hi - 1 + cv.off[t] >= blk.W)
          return (int)cudaErrorInvalidValue;
    }
    cudaError_t err;
    switch (C) {
      case 32: err = launch_one<32>(bufs[src], bufs[dst], B, blk, s); break;
      case 64: err = launch_one<64>(bufs[src], bufs[dst], B, blk, s); break;
      case 128: err = launch_one<128>(bufs[src], bufs[dst], B, blk, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
