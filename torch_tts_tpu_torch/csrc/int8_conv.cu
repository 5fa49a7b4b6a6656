// W8A8 int8 decoder convolutions for Hopper: the dynamic activation
// quantizer (one cooperative launch, its pre-activation applied as it
// reads) and an int8 implicit-GEMM conv1d on TMA-fed wgmma s8.
//
// Replaces no Pallas kernel: in the JAX package the int8 decoder
// (`quantize_decoder`, torch_tts_tpu/ops/quant.py) is XLA work, the
// max / round / clip of `quantize_act_dynamic` (ops/quant.py:47) on the
// activation `mask * leaky_relu(x)` that the decoder forms before each int8
// conv (ops/hifigan.py:74, 85, 111, 197), and `int8_conv1d`'s
// lax.conv_general_dilated with int32 accumulation (ops/quant.py:54-80),
// whose output the resblocks add to their residual. PyTorch has no int8
// convolution on the card, so the port computes both here. Contract of the
// Python wrappers (torch_tts_tpu_torch/kernels/int8_conv.py):
//
// - quantize: x [B, C, T] fp32, a leaky ReLU slope and a mask [B, 1, T],
//   each optional -> v = fl((x >= 0 ? x : fl(x * slope)) * mask) (a slope
//   or mask not given is 1, an exact product), x_q [B, T, Cp] int8
//   channels-last (Cp = C rounded up to 32, zero past C) and
//   s_x = max(max |v|, 1e-12) *
//   fp32(1 / 127) over the whole tensor, on the device (XLA's form of the
//   JAX package's division by the constant 127 under jit); x_q =
//   clip(rint(v / s_x), -127, 127) (IEEE division, round half to even, as
//   jnp.round and torch.round).
// - conv: x_q [B, T, Cp] int8, w_q [N, k, Cp] int8 (zero past the real
//   channels), s_w [N] fp32, bias [N / phases] fp32 or null, res [B, N /
//   phases, T_out * phases] fp32 or null. N = C_out * phases, column n =
//   o * phases + r. acc[b, t, n] = sum_j sum_c x_q[b, t + j * dil - pad_lo,
//   c] * w_q[n, j, c] in int32, rows outside [0, T) zero;
//   out[b, o, t * phases + r] = float(acc) * (s_x * s_w[n]) (+ bias[o])
//   (+ res[b, o, t * phases + r]), each operation rounded (__fmul_rn /
//   __fadd_rn, no fused multiply-add, the plain version's order), out [B,
//   C_out, T_out * phases] fp32: the port's layout, with the subpixel
//   transposed conv's depth-to-space (phases = its stride) folded into the
//   store. res is ResBlock1's and ResBlock2's `c2(xt) + x`.
//
// Bound on the H100 (dense int8 tensor cores 1,979 TOPS; HBM3 3.35 TB/s):
// a conv does 2 M N K operations (M = B T_out, K = k C_in) and must move
// x_q (B T C_in bytes), w_q (N K), its fp32 output (4 M N) and, with a
// residual, 4 M N more. At the decoder's shapes the two are close: the
// C=128 bank's k=11 conv at 65,536 frames is 23.6 GOP (11.9 us) against
// 42 MB (12.5 us), 75 MB (22.5 us) with its residual. The quantizer reads 4
// bytes an element (and the mask) and writes 1: bytes.
//
// Design of the conv (int8_conv_kernel):
// - A tile of BM rows (frames t of one item b; tiles never cross items) x
//   BN columns, on a producer warp, two consumer warpgroups and a storer
//   warpgroup. One thread of the producer issues TMA loads into an
//   mbarrier ring of about 128 KB (4, 5 or 8 stages by the tile); a stage
//   is one 128-byte K step: the A box x_q[b, t0 + j dil - pad_lo + (0 ..
//   BM), c0 .. c0 + 128) of a 3D map over [B, T, Cp] and the B box w_q[n0 ..
//   n0 + BN, j Cp + c0 .. + 128) of a 2D map over [N, k Cp], both 128-byte
//   swizzled, K-major. TMA's zero fill of out-of-bounds elements gives the
//   padding, the item edges and the K tail past Cp (conv_pre's Cp = 192 in
//   two 128-byte steps) with no copy or predicate: a K tail's A bytes are
//   zero, so whatever the next tap's weights hold there adds nothing.
// - The consumers run wgmma.mma_async m64nNk32.s32.s8.s8 from the shared
//   tiles (4 a stage), int32 accumulators in registers, one group in
//   flight while the next stage's products issue; with BM = 128 each takes
//   64 rows x BN, with BM = 64 each 64 rows x BN / 2.
// - Tiles by the grid (kernels/int8_conv.py `conv_tile`): 128 x 128, then
//   64 x 128, then 64 x 64 while the tiles number fewer than the SMs (the
//   128-frame patch window's convs, conv_pre and up_0 at B=1). The CTAs
//   are persistent (at most a co-resident wave), walking tiles with the
//   column tile fastest; the ring's phases run on across tiles, so the
//   producer loads the next tile while the consumers stage this one.
// - Epilogue: the consumers dequantize and add the bias, each rounded as
//   above, into a shared staging tile laid out as the output's rows (o,
//   then t * phases + r; a warp's stores fall in distinct banks), the
//   tile's scales and biases read from a table in shared memory that they
//   fill before staging (a global load in the staging loop would order
//   every store behind it). The storer warpgroup writes the staged tile
//   (with the residual added) as float4 runs along the output's time axis,
//   512 contiguous bytes a warp instruction, while the consumers run the
//   next tile's products; the output stream then sets a tile's pace. A tile
//   holds whole phase groups: its columns are BN rounded down to a multiple
//   of phases, or, for phases > BN, a divisor of phases (a run of r within
//   one o).
// - Tried on the H100 and dropped (no faster, or slower, in A/B runs of
//   variants): TMA stores of the staging tile (in 128-byte swizzled boxes,
//   the residual brought in by TMA), L2 prefetches of the next tile's x_q
//   rows and residual, a deeper storer batch.
//
// Design of the quantizer (quantize_kernel), one cooperative launch:
// - A unit is 32 channels x 256 frames of one item; a thread takes one
//   frame's 32 channels (32 coalesced loads along t, the mask once), so
//   its x_q piece is one 32-byte row segment, two 16-byte stores, and no
//   transpose through shared memory is needed.
// - Pass 1: max |v| (the pre-activation applied as it reads: all 32
//   loads of a thread issued before any is used), each CTA's first unit
//   kept in registers; a CTA's maximum to its own word of the scratch, the
//   grid synchronised (cooperative groups), then every CTA reduces the
//   words itself (every CTA the same s_x). Pass 2 quantizes the kept unit
//   from registers and reads the others again (last read first). It
//   rounds v times the rounded 1 / s_x, and divides only where that
//   product lies within 2^-15 of a half (round_div). No memset, one
//   launch; nothing persists between launches, so a CUDA graph replays it
//   as it is. Keeping two more units a CTA in shared memory (no second
//   read at 65,536 frames) was no faster on the H100.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>

#include "tma_pipeline.cuh"

namespace {

using namespace tts_wgmma;
namespace cg = cooperative_groups;

constexpr float kEps = 1e-12f;
constexpr float kInv127 = 1.0f / 127.0f;  // fp32(1 / 127)
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// int8 conv

constexpr int kKStep = 128;       // bytes of K a ring stage: one swizzle row
constexpr int kConsumers = 2;     // consumer warpgroups a CTA
constexpr int kStorer = kConsumers * 4;       // first warp of the storer warpgroup
constexpr int kProducer = kStorer + 4;        // the producer warp
constexpr int kConvThreads = kProducer * 32 + 32;
constexpr int kStagePad = 4;      // floats of padding a staged row
constexpr int kStoreBatch = 8;    // rows a storer thread loads (with their residual) before storing

// d (64 x N int32, N / 2 registers a thread, the fp32 layout of
// wgmma_bf16.cuh) += a (64 x 32 int8) b (32 x N int8), both K-major behind
// 128-byte-swizzle descriptors; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 128 || N == 64 || N == 32, "int8 product widths");
  if constexpr (N == 128) wgmma_s8_n128(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_s8_n64(d, da, db, scale_d);
  else wgmma_s8_n32(d, da, db, scale_d);
}

__device__ __forceinline__ void consumers_sync() {  // the consumer warpgroups only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

struct ConvArgs {
  const float* sx;
  const float* sw;
  const float* bias;  // or null
  const float* res;   // or null
  float* out;
  int T_out, N, C_out, phases, k, dil, pad_lo, Cp, cblocks;
  int bn_eff;  // columns a tile writes: whole phase groups, or a run of one group
  int rc;      // min(phases, bn_eff): the r of one o a staged row holds
  int mtiles, ntiles, tiles;
  int vec;     // float4 stores: whole groups, T_out * phases % 4 == 0, 16-byte aligned
};

template <int BM, int BN>
struct ConvTile {
  static constexpr bool kSplitM = BM == 128;  // else the warpgroups split the columns
  static constexpr int WN = kSplitM ? BN : BN / 2;
  static constexpr int kABytes = BM * kKStep, kBBytes = BN * kKStep;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // about 128 KB of loads in flight whatever the tile: 4, 5 or 8 stages
  static constexpr int kStages = (128 * 1024) / kStageBytes;
  static constexpr int kStaged = BN * BM + kStagePad * BN;  // floats
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + kStaged * 4 +
                                  5 * BN * 4 + (2 * kStages + 2) * 8;
  static_assert(BM == 128 || BM == 64, "tile rows");
};

struct TileAt {
  int b, t0, n0;
};
__device__ __forceinline__ TileAt tile_at(const ConvArgs& p, int tile, int bm) {
  const int per_item = p.mtiles * p.ntiles;
  return {tile / per_item, tile % per_item / p.ntiles * bm, tile % p.ntiles * p.bn_eff};
}

template <int BM, int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
int8_conv_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, const ConvArgs p) {
  using Tl = ConvTile<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* base = smem_raw + (ring - smem_addr(smem_raw));
  float* staged = reinterpret_cast<float*>(base + Tl::kStages * Tl::kStageBytes);
  int* col_off = reinterpret_cast<int*>(staged + Tl::kStaged);  // a column's staged offset
  int* col_o = col_off + BN;                                    // and its o past the tile's
  // the tile's columns: (s_x s_w[n], bias[o]) and the staged offset, -1 past N
  float2* tab_sb = reinterpret_cast<float2*>(col_o + BN);
  int* tab_off = reinterpret_cast<int*>(tab_sb + BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab_off + BN);
  uint64_t* empty = full + Tl::kStages;
  uint64_t* staged_full = empty + Tl::kStages;   // the consumers wrote a tile
  uint64_t* staged_empty = staged_full + 1;  // the storer read it
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int steps = p.k * p.cblocks;
  const int S = BM * p.rc + kStagePad;  // floats a staged row: one o, its (t, r) in order

  if (tid == 0) {
    for (int i = 0; i < Tl::kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    mbar_init(staged_full, kConsumers * 128);
    mbar_init(staged_empty, 128);
    fence_barrier_init();
  }
  for (int nl = tid; nl < BN; nl += kConvThreads) {
    col_off[nl] = nl / p.rc * S + nl % p.rc;
    col_o[nl] = p.rc == p.phases ? nl / p.phases : 0;
  }
  __syncthreads();

  if (warp == kProducer) {  // --- the producer warp
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const TileAt at = tile_at(p, tile, BM);
        for (int j = 0; j < p.k; ++j)
          for (int cb = 0; cb < p.cblocks; ++cb, ++it) {
            const int slot = it % Tl::kStages;
            if (it >= Tl::kStages) mbar_wait(empty + slot, ((it / Tl::kStages) & 1) ^ 1);
            const uint32_t st = ring + slot * Tl::kStageBytes;
            mbar_expect(full + slot, Tl::kStageBytes);
            tma_3d(st, &a_map, cb * kKStep, at.t0 + j * p.dil - p.pad_lo, at.b, full + slot);
            tma_2d(st + Tl::kABytes, &b_map, j * p.Cp + cb * kKStep, at.n0, full + slot);
          }
      }
    }
    return;
  }

  if (warp >= kStorer) {  // --- the storer warpgroup: staged tile -> out (+ res)
    // warp w takes staged rows w, w + 4, ...; its lanes walk a row in order, so a
    // store instruction writes 512 contiguous bytes; kStoreBatch rows in flight
    const int sw = warp - kStorer;
    const long long L = (long long)p.T_out * p.phases;
    int lt = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++lt) {
      const TileAt at = tile_at(p, tile, BM);
      mbar_wait(staged_full, lt & 1);
      // staged row ol is output row o0 + ol from (t0, r0) on
      const int rows = min(p.bn_eff, p.N - at.n0) / p.rc;
      const int len = min(BM, p.T_out - at.t0) * p.rc;
      const long long row0 = (long long)at.b * p.C_out + at.n0 / p.phases;
      const long long col0 = (long long)at.t0 * p.phases + at.n0 % p.phases;
      if (p.vec) {  // rc == phases: a staged row is one contiguous run of the output row
        const int len4 = len / 4;
        for (int ol0 = sw; ol0 < rows; ol0 += 4 * kStoreBatch)
          for (int q = lane; q < len4; q += 32) {
            float4 y[kStoreBatch], r[kStoreBatch];
#pragma unroll
            for (int u = 0; u < kStoreBatch; ++u) {
              const int ol = ol0 + 4 * u;
              if (ol >= rows) continue;
              y[u] = reinterpret_cast<const float4*>(staged + ol * S)[q];
              if (p.res != nullptr)
                r[u] = __ldg(reinterpret_cast<const float4*>(p.res + (row0 + ol) * L + col0) + q);
            }
#pragma unroll
            for (int u = 0; u < kStoreBatch; ++u) {
              const int ol = ol0 + 4 * u;
              if (ol >= rows) continue;
              if (p.res != nullptr)
                y[u] = make_float4(__fadd_rn(y[u].x, r[u].x), __fadd_rn(y[u].y, r[u].y),
                                   __fadd_rn(y[u].z, r[u].z), __fadd_rn(y[u].w, r[u].w));
              reinterpret_cast<float4*>(p.out + (row0 + ol) * L + col0)[q] = y[u];
            }
          }
      } else {  // element by element: a run of r per frame when rc < phases
        for (int ol = sw; ol < rows; ol += 4)
          for (int q = lane; q < len; q += 32) {
            const long long off = (row0 + ol) * L + col0 +
                                  (p.rc == p.phases ? q : q / p.rc * p.phases + q % p.rc);
            const float y = staged[ol * S + q];
            p.out[off] = p.res != nullptr ? __fadd_rn(y, __ldg(p.res + off)) : y;
          }
      }
      mbar_arrive(staged_empty);  // this thread's reads of the staging tile are done
    }
    return;
  }

  // --- the consumer warpgroups
  const int wg = warp >> 2;
  const int row0 = Tl::kSplitM ? 64 * wg : 0;       // the warpgroup's rows of the tile
  const int col0 = Tl::kSplitM ? 0 : wg * Tl::WN;   // and columns
  const int g = lane >> 2, t4 = lane & 3, wr = row0 + 16 * (warp & 3) + g;
  const float s_x = *p.sx;
  int it = 0, lt = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++lt) {
    const TileAt at = tile_at(p, tile, BM);
    // this tile's column tables: loaded now, written after the products (which hide
    // the loads' latency), once every consumer has staged the last tile
    const int tn = at.n0 + tid;
    const bool tok = tid < BN && tid < p.bn_eff && tn < p.N;
    const float t_sw = tok ? __ldg(p.sw + tn) : 0.f;
    const float t_b = tok && p.bias != nullptr ? __ldg(p.bias + at.n0 / p.phases + col_o[tid]) : 0.f;
    int acc[Tl::WN / 2];
#pragma unroll
    for (int e = 0; e < Tl::WN / 2; ++e) acc[e] = 0;
    for (int s = 0; s < steps; ++s, ++it) {
      const int slot = it % Tl::kStages;
      mbar_wait(full + slot, (it / Tl::kStages) & 1);
      const uint32_t st = ring + slot * Tl::kStageBytes;
      const uint32_t a_t = st + row0 * kKStep, b_t = st + Tl::kABytes + col0 * kKStep;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kKStep / 32; ++kk)
        wgmma_s8<Tl::WN>(acc, kmajor_sw128(a_t, kk), kmajor_sw128(b_t, kk), 1);
      wg_commit();
      wg_wait<1>();
      if (s > 0 && (tid & 127) == 0) mbar_arrive(empty + (it - 1) % Tl::kStages);
    }
    wg_wait<0>();
    if ((tid & 127) == 0) mbar_arrive(empty + (it - 1) % Tl::kStages);
#pragma unroll
    for (int e = 0; e < Tl::WN / 2; ++e) pin(acc[e]);

    // stage: acc[4 j + 2 h + e] is row wr + 8 h, column col0 + 8 j + 2 t4 + e; the
    // dequantize and bias, each rounded, in the plain version's order. Each group of
    // four j reads its columns' table entries before any of its stores
    consumers_sync();  // every consumer has staged the last tile: the tables are free
    if (tid < BN) {
      tab_sb[tid] = make_float2(__fmul_rn(s_x, t_sw), t_b);
      tab_off[tid] = tok ? col_off[tid] : -1;
    }
    consumers_sync();  // the tables are written
    if (lt > 0) mbar_wait(staged_empty, (lt - 1) & 1);  // the storer read the last tile
#pragma unroll
    for (int j0 = 0; j0 < Tl::WN / 8; j0 += 4) {
      float2 sb[4][2];
      int off[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nl = col0 + 8 * (j0 + jj) + 2 * t4 + e;
          sb[jj][e] = tab_sb[nl];
          off[jj][e] = tab_off[nl];
        }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (off[jj][e] < 0) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float y = __fmul_rn(__int2float_rn(acc[4 * (j0 + jj) + 2 * h + e]), sb[jj][e].x);
            if (p.bias != nullptr) y = __fadd_rn(y, sb[jj][e].y);
            staged[off[jj][e] + (wr + 8 * h) * p.rc] = y;
          }
        }
    }
    mbar_arrive(staged_full);
  }
}

// a uint8 tensor of `rank` dims (innermost first, byte strides of the outer
// ones) as boxes, 128-byte swizzled; out-of-bounds elements read as zero
bool make_map_u8(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the shared-memory limit is raised, and the CTAs an SM holds read, once per
// device and kernel (not per launch, so a launch under CUDA graph capture
// makes no such call); 0 until then
template <typename Kernel>
cudaError_t ctas_per_sm(Kernel kernel, int threads, size_t smem, std::atomic<int>* cache,
                        int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *n = cache[dev].load();
  if (*n > 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (*n < 1) return cudaErrorInvalidConfiguration;
  cache[dev].store(*n);
  return cudaSuccess;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int BM, int BN>
cudaError_t launch_conv(const int8_t* xq, const int8_t* wq, const ConvArgs& p, int B, int T,
                        cudaStream_t stream) {
  using Tl = ConvTile<BM, BN>;
  static std::atomic<int> cache[kMaxDevices];  // zero-initialised
  int per_sm = 0;
  cudaError_t err = ctas_per_sm(int8_conv_kernel<BM, BN>, kConvThreads, Tl::kSmem, cache, &per_sm);
  if (err != cudaSuccess) return err;
  CUtensorMap a_map, b_map;
  const cuuint64_t a_dims[3] = {(cuuint64_t)p.Cp, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t a_strides[2] = {(cuuint64_t)p.Cp, (cuuint64_t)p.Cp * T};
  const cuuint32_t a_box[3] = {kKStep, BM, 1};
  const cuuint64_t b_dims[2] = {(cuuint64_t)p.k * p.Cp, (cuuint64_t)p.N};
  const cuuint64_t b_strides[1] = {(cuuint64_t)p.k * p.Cp};
  const cuuint32_t b_box[2] = {kKStep, BN};
  if (!make_map_u8(&a_map, xq, 3, a_dims, a_strides, a_box) ||
      !make_map_u8(&b_map, wq, 2, b_dims, b_strides, b_box))
    return cudaErrorInvalidValue;
  const long long cap = (long long)sm_count() * per_sm;
  const int grid = (int)(p.tiles < cap ? p.tiles : cap);
  int8_conv_kernel<BM, BN><<<grid, kConvThreads, Tl::kSmem, stream>>>(a_map, b_map, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// activation quantizer

constexpr int kQThreads = 256;     // frames a unit
constexpr int kQGroup = 32;        // channels a unit (and a thread)
constexpr int kQChunk = 16;        // loads in flight a thread for a unit past the first
constexpr int kQMaxCtas = 1024;    // words of the scratch after s_x

struct QuantArgs {
  const float* x;     // [B, C, T]
  const float* mask;  // [B, 1, T] or null (a mask of ones)
  int8_t* xq;         // [B, T, Cp]
  float* scale;       // [0] s_x; [1 + i] CTA i's max |v| bits
  float slope;        // 1 without a leaky ReLU
  int B, C, Cp, T, groups, spans, units;
};

// x >= 0 ? x : fl(x * slope), times the mask: jnp.where(x >= 0, x, x * slope) * mask.
// Without a slope or a mask the wrapper passes 1 for it: a product with 1 is exact
__device__ __forceinline__ float pre_act(float v, float m, float slope) {
  return __fmul_rn(v >= 0.f ? v : __fmul_rn(v, slope), m);
}

struct Unit {
  const float* x;  // x[b, c0, t], or null for a frame past T
  float m;
  int nc;          // real channels of the group (0 .. 32)
  size_t q_off;    // x_q[b, t, c0]
};

__device__ __forceinline__ Unit unit_of(const QuantArgs& a, int u) {
  const int span = u % a.spans, grp = u / a.spans % a.groups, b = u / (a.spans * a.groups);
  const int t = span * kQThreads + threadIdx.x, c0 = grp * kQGroup;
  Unit r;
  r.x = t < a.T ? a.x + ((size_t)b * a.C + c0) * a.T + t : nullptr;
  r.m = (r.x != nullptr && a.mask != nullptr) ? __ldg(a.mask + (size_t)b * a.T + t) : 1.f;
  r.nc = min(kQGroup, max(0, a.C - c0));
  r.q_off = ((size_t)b * a.T + t) * a.Cp + c0;
  return r;
}

// a thread's 32 values of a unit: every load issued before any is used
template <int N>
__device__ __forceinline__ void load_unit(const QuantArgs& a, const Unit& r, int i0, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = (r.x != nullptr && i0 + i < r.nc) ? r.x[(size_t)(i0 + i) * a.T] : 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = pre_act(v[i], r.m, a.slope);
}

__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(fabsf(v)); }

// the 32 values of one frame to its 32 bytes of x_q
// rint(v / s) with the IEEE division of the plain version. For |v / s| <= 128
// (|v| <= max |v| = 127 s), v times the rounded reciprocal 1 / s lies within 2^-16
// of v / s, so the two round alike unless that product is within 2^-15 of a half
// (a tie, or NaN): only then is the quotient computed
__device__ __forceinline__ float round_div(float v, float s, float inv_s) {
  const float y = __fmul_rn(v, inv_s);
  return fabsf(y - floorf(y) - 0.5f) > 3.0517578125e-5f ? rintf(y) : rintf(__fdiv_rn(v, s));
}

__device__ __forceinline__ void store_q(const QuantArgs& a, const Unit& r, const float (&v)[kQGroup],
                                        float s) {
  if (r.x == nullptr) return;
  const float inv_s = __frcp_rn(s);
  uint32_t w[kQGroup / 4];
#pragma unroll
  for (int i = 0; i < kQGroup / 4; ++i) w[i] = 0u;
#pragma unroll
  for (int i = 0; i < kQGroup; ++i) {
    const float q = fminf(fmaxf(round_div(v[i], s, inv_s), -127.0f), 127.0f);
    w[i / 4] |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(q) << (8 * (i % 4));
  }
  uint4* dst = reinterpret_cast<uint4*>(a.xq + r.q_off);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// the CTA's max over each thread's m (bit patterns of non-negative floats
// order as integers, NaN above inf), to every thread
__device__ __forceinline__ unsigned cta_max(unsigned m, unsigned* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = __reduce_max_sync(0xffffffffu, m);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = lane < kQThreads / 32 ? red[lane] : 0u;
  return __reduce_max_sync(0xffffffffu, m);
}

__global__ void __launch_bounds__(kQThreads, 3) quantize_kernel(const QuantArgs a) {
  __shared__ unsigned red[kQThreads / 32];
  unsigned* part = reinterpret_cast<unsigned*>(a.scale + 1);
  float kept[kQGroup];
  unsigned m = 0u;
  // pass 1: max |v|; the CTA's first unit stays in registers
  if ((int)blockIdx.x < a.units) {
    load_unit(a, unit_of(a, blockIdx.x), 0, kept);
#pragma unroll
    for (int i = 0; i < kQGroup; ++i) m = max(m, abs_bits(kept[i]));
  }
  for (int u = blockIdx.x + gridDim.x; u < a.units; u += (int)gridDim.x) {
    const Unit r = unit_of(a, u);
#pragma unroll
    for (int i0 = 0; i0 < kQGroup; i0 += kQChunk) {
      float v[kQChunk];
      load_unit(a, r, i0, v);
#pragma unroll
      for (int i = 0; i < kQChunk; ++i) m = max(m, abs_bits(v[i]));
    }
  }
  m = cta_max(m, red);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
  cg::this_grid().sync();
  m = 0u;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kQThreads) m = max(m, __ldcg(part + i));
  const float amax = __uint_as_float(cta_max(m, red));
  const float s = __fmul_rn(amax < kEps ? kEps : amax, kInv127);  // NaN stays NaN
  if (blockIdx.x == 0 && threadIdx.x == 0) a.scale[0] = s;
  // pass 2: the kept unit from registers, the others read again, last read first
  if ((int)blockIdx.x < a.units) store_q(a, unit_of(a, blockIdx.x), kept, s);
  int last = blockIdx.x;
  while (last + (int)gridDim.x < a.units) last += (int)gridDim.x;
  for (int u = last; u > (int)blockIdx.x; u -= (int)gridDim.x) {
    const Unit r = unit_of(a, u);
    float v[kQGroup];
    load_unit(a, r, 0, v);
    store_q(a, r, v, s);
  }
}

}  // namespace

// The activation quantizer on `stream` (contract above): x [B, C, T] fp32,
// mask [B, 1, T] fp32 or null, the slope's fp32 bits (1 for none) -> x_q [B, T, Cp]
// int8, Cp = C rounded up to a multiple of 32 (the conv's K granule), zero
// past C; scale holds 1 + 1024 words: [0] s_x (written), then scratch. One
// cooperative launch. Returns the CUDA error (0 on success).
extern "C" int tts_int8_quantize(const float* x, const float* mask, int slope_bits, int8_t* xq,
                                 float* scale, int B, int C, int Cp, int T, void* stream) {
  if (B < 1 || C < 1 || T < 1 || Cp != (C + 31) / 32 * 32)
    return (int)cudaErrorInvalidValue;
  static std::atomic<int> cache[kMaxDevices];
  int per_sm = 0;
  cudaError_t err = ctas_per_sm(quantize_kernel, kQThreads, 0, cache, &per_sm);
  if (err != cudaSuccess) return (int)err;
  QuantArgs a;
  a.x = x;
  a.mask = mask;
  a.xq = xq;
  a.scale = scale;
  std::memcpy(&a.slope, &slope_bits, sizeof(float));
  a.B = B;
  a.C = C;
  a.Cp = Cp;
  a.T = T;
  a.groups = Cp / kQGroup;
  a.spans = (T + kQThreads - 1) / kQThreads;
  const long long units = (long long)B * a.groups * a.spans;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.units = (int)units;
  long long grid = (long long)sm_count() * per_sm;
  if (grid > kQMaxCtas) grid = kQMaxCtas;
  if (grid > units) grid = units;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(quantize_kernel), dim3((unsigned)grid),
                                    dim3(kQThreads), args, 0,
                                    reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The int8 conv on `stream` (contract above). Cp a multiple of 32, N a
// multiple of phases, k * Cp at most 131072 (int32 sums of 127^2
// products); x_q, w_q, out and res 16-byte aligned. The tile (bm x bn,
// bn_eff of its columns written) is the wrapper's `conv_tile`: 128 x 128,
// 64 x 128 or 64 x 64; bn_eff a multiple of phases up to bn, or a divisor
// of phases. Returns the CUDA error (0 on success).
extern "C" int tts_int8_conv1d(const int8_t* xq, const float* sx, const int8_t* wq,
                               const float* sw, const float* bias, const float* res, float* out,
                               int B, int T, int Cp, int N, int k, int dil, int pad_lo,
                               int T_out, int phases, int bm, int bn, int bn_eff, void* stream) {
  if (B < 1 || T < 1 || T_out < 1 || Cp < 32 || Cp % 32 != 0 || N < 1 || k < 1 || dil < 1 ||
      phases < 1 || N % phases != 0 || (long long)k * Cp > 131072 || bn_eff < 1 || bn_eff > bn ||
      (bn_eff % phases != 0 && phases % bn_eff != 0) ||
      ((uintptr_t)xq | (uintptr_t)wq) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  ConvArgs p;
  p.sx = sx;
  p.sw = sw;
  p.bias = bias;
  p.res = res;
  p.out = out;
  p.T_out = T_out;
  p.N = N;
  p.C_out = N / phases;
  p.phases = phases;
  p.k = k;
  p.dil = dil;
  p.pad_lo = pad_lo;
  p.Cp = Cp;
  p.cblocks = (Cp + kKStep - 1) / kKStep;
  p.bn_eff = bn_eff;
  p.rc = phases < bn_eff ? phases : bn_eff;
  p.mtiles = (T_out + bm - 1) / bm;
  p.ntiles = (N + bn_eff - 1) / bn_eff;
  const long long tiles = (long long)B * p.mtiles * p.ntiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.vec = p.rc == phases && (long long)T_out * phases % 4 == 0 &&
          (((uintptr_t)out | (uintptr_t)res) % 16 == 0);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128) return (int)launch_conv<128, 128>(xq, wq, p, B, T, s);
  if (bm == 64 && bn == 128) return (int)launch_conv<64, 128>(xq, wq, p, B, T, s);
  if (bm == 64 && bn == 64) return (int)launch_conv<64, 64>(xq, wq, p, B, T, s);
  return (int)cudaErrorInvalidValue;
}
