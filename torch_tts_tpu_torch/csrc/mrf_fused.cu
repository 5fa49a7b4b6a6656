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
// - 3xTF32: a = a_hi + a_lo, b = b_hi + b_lo with hi = cvt.rna.tf32(v) and
//   lo = cvt.rna.tf32(v - hi); acc += a_lo b_hi, then a_hi b_lo, then
//   a_hi b_hi, all in one fp32 accumulator (a_lo b_lo, about 2^-22 of the
//   product, is dropped). Weights are split once a CTA, while staged into
//   the ring; activations as their fragments are read from the window
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

namespace {

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

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a b on the warpgroup's tensor cores: a 64x8 tf32 fragment in
// registers, b an 8xN K-major tile behind a shared-memory descriptor, d
// 64xN fp32 (N / 2 registers a thread)
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (N == 32) wgmma_n32(d, a, desc);
  else if constexpr (N == 64) wgmma_n64(d, a, desc);
  else wgmma_n128(d, a, desc);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// makes this thread's shared-memory stores visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pins a register at this point of the program: the accumulators are not
// read above the wait, and the A fragments' registers not reused before it
__device__ __forceinline__ void keep(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// K-major, no swizzle: 8-row x 16-byte core matrices; LBO between the two
// K halves of a k8 step, SBO between 8-row groups of N
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

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
