// Monotonic alignment search (MAS): Viterbi DP and backtrack, one CTA per
// batch item.
//
// Replaces the TPU kernel torch_tts_tpu/kernels/mas_pallas.py
// (maximum_path_pallas -> _mas_kernel). Contract of the Python wrapper
// (torch_tts_tpu_torch/kernels/mas.py): neg_cent [B, T_y, T_x] fp32, already
// set to MAX_NEG outside each item's [t_y, t_x] box, int32 t_ys and t_xs [B]
// -> path [B, T_y, T_x] fp32 with one-hot rows; rows y >= t_y are zero.
//
// The DP is the TPU kernel's, in the same fp32 operations and order, so the
// path equals the plain version's bit for bit, ties included:
//   v[0, x] = x == 0 ? nc[0, 0] : MAX_NEG
//   v[y, x] = max(nc[y, x] + max(x == y ? MAX_NEG : v[y-1, x],
//                                 x == 0 ? MAX_NEG : v[y-1, x-1]), MAX_NEG)
// The backtrack starts at index t_x - 1 on row t_y - 1: row y is one-hot at
// index, then index moves left when index > 0 and (index == y or
// v[y-1, index] < v[y-1, index-1]). (Columns x >= t_x hold other values
// than the plain version's MAX_NEG, but no column left of them reads them.)
//
// Bound on the H100: not bytes (about 12 MB at [8, 1000, 192], 4 us at
// 3.35 TB/s) nor operations, but the two chains of T_y dependent steps:
// the DP's rows and the backtrack's. chip_smoke.py measures their floor with
// tts_mas_chain_probe (the same row and backtrack steps, the rows already in
// shared memory). Design:
// - Warp 0 runs the DP. Lane l owns the CPL contiguous columns l*CPL ..
//   l*CPL + CPL - 1, so a cell's left neighbour is the lane's own previous
//   column, and a row takes one shuffle (lane l - 1's last column), not one
//   per column. Per row and column: an add, two max, a compare into the
//   move bits.
// - Warp 1 streams neg_cent into a ring of NB slots of 32 rows in shared
//   memory, up to NB slots in flight: a TMA bulk copy a row (cp.async of 4
//   bytes where a row is not a multiple of 16 bytes), completing on the
//   slot's mbarrier; a slot is empty again when warp 0 arrives on its named
//   barrier. The DP reads every row from shared memory.
// - The move bit of (y, x) is bit y % 32 of the word [y / 32][x % CPL][x / CPL]:
//   each lane ORs its columns' bits into CPL registers and stores them every
//   32 rows (shared memory, or a global scratch buffer the wrapper
//   allocates when they do not fit). x == y and x == 0 are left to the
//   backtrack.
// - Warp 0 walks the bits back a 32-row block at a time: a load and 32
//   ballots a block turn the walk into a shift, a mask and an add a row
//   (see backtrack).
// - Warps 2-7 write the item's zeros while the DP runs; after a block
//   barrier the T_y ones are written.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kMaxNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kBatch = 32;          // rows of a ring slot, and of a move-bit word
constexpr int kSmemLimit = 232448;  // dynamic shared memory per block on Hopper
constexpr int kHead = 64;           // bytes before the ring: the slots' mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// one TMA bulk copy of `bytes` (a multiple of 16) completing on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// the slot's mbarrier counts this thread's arrival once its cp.asyncs so far landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// named barriers between warp 0 (the DP) and warp 1 (the copies): 64 threads
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// DP rows y0 + r0 .. y0 + 31 (stopping at ty) of one 32-row block, read
// from `slot` (row r at slot + r * 32 CPL); v holds the lane's columns of
// row y0 + r0 - 1 on entry and of the block's last row on exit. The
// block's move bits go to bits[j * 32 + lane].
template <int CPL>
__device__ __forceinline__ void dp_block(const float* __restrict__ slot, float (&v)[CPL],
                                         unsigned* __restrict__ bits, int y0, int r0, int ty,
                                         int lane) {
  constexpr int RS = 32 * CPL;
  unsigned w[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) w[j] = 0u;
  const float* base = slot + lane * CPL;
#pragma unroll
  for (int r = 0; r < kBatch; ++r) {
    const int y = y0 + r;
    if (r < r0) continue;
    if (y >= ty) break;
    float nc[CPL];
    const float* row = base + r * RS;
    if constexpr (CPL % 4 == 0) {
#pragma unroll
      for (int j = 0; j < CPL; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(row + j);
        nc[j] = q.x; nc[j + 1] = q.y; nc[j + 2] = q.z; nc[j + 3] = q.w;
      }
    } else if constexpr (CPL % 2 == 0) {
#pragma unroll
      for (int j = 0; j < CPL; j += 2) {
        const float2 q = *reinterpret_cast<const float2*>(row + j);
        nc[j] = q.x; nc[j + 1] = q.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < CPL; ++j) nc[j] = row[j];
    }
    const float up = __shfl_up_sync(kFull, v[CPL - 1], 1);
    const float left0 = lane > 0 ? up : kMaxNeg;
    const int dy = y - lane * CPL;  // the column j with x == y
    float nv[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float left = j > 0 ? v[j - 1] : left0;
      if (v[j] < left) w[j] |= 1u << r;
      const float stay = dy == j ? kMaxNeg : v[j];
      nv[j] = fmaxf(nc[j] + fmaxf(stay, left), kMaxNeg);
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) v[j] = nv[j];
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) bits[j * 32 + lane] = w[j];
}

// The path's index on rows 0 .. ty - 1 -> rec, from the move bits; the
// whole warp, one 32-row block at a time from the top. Entering a block at
// index X, the walk stays in columns X - 31 .. X: lane d loads column
// X - d's word and adds its forced move (row y = x); 32 ballots transpose
// the words into t[r] (bit d: the walk moves at row r if it is d columns
// left of X), so a row's step is a shift, a mask and an add, with no load.
// Lane r stores row r's index.
template <int CPL>
__device__ __forceinline__ void backtrack(const unsigned* __restrict__ bits, int ty, int tx,
                                          int* __restrict__ rec, int lane) {
  int X = max(tx - 1, 0);
  for (int blk = (ty - 1) >> 5; blk >= 0; --blk) {
    const int y0 = blk * 32, x = X - lane;
    unsigned m = 0u;
    if (x > 0) {
      m = bits[(blk * CPL + x % CPL) * 32 + x / CPL];
      if (x >= y0 && x < y0 + 32) m |= 1u << (x - y0);
    }
    unsigned t[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) t[r] = __ballot_sync(kFull, (m >> r) & 1u);
    const int r_top = min(ty - 1 - y0, 31);
    int d = 0, mine = 0;
#pragma unroll
    for (int r = 31; r >= 0; --r) {
      if (r > r_top) continue;
      if (r == lane) mine = d;
      d += (t[r] >> d) & 1u;  // to row r - 1 (row 0's move is never used)
    }
    if (lane <= r_top) rec[y0 + lane] = X - mine;
    X -= d;
  }
}

template <int CPL>
__global__ void __launch_bounds__(kThreads)
mas_kernel(const float* __restrict__ nc, const int* __restrict__ t_ys,
           const int* __restrict__ t_xs, float* __restrict__ path,
           unsigned* __restrict__ gbits, int T_y, int T_x, int NB) {
  constexpr int RS = 32 * CPL;  // ring row stride, floats
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = min(max(t_ys[b], 0), T_y);
  const int tx = min(max(t_xs[b], 0), T_x);
  const int nblk = (T_y + kBatch - 1) / kBatch;
  const int nbatch = (ty + kBatch - 1) / kBatch;

  extern __shared__ float4 smem4[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem4);      // [NB], in kHead bytes
  float* ring = reinterpret_cast<float*>(smem4) + kHead / 4;  // [NB * 32, RS]
  int* rec = reinterpret_cast<int*>(ring + NB * kBatch * RS);  // [T_y]
  unsigned* bits = gbits != nullptr ? gbits + (size_t)b * nblk * CPL * 32
                                    : reinterpret_cast<unsigned*>(rec + T_y);
  const float* ncb = nc + (size_t)b * T_y * T_x;

  // rows of 16-byte multiples on 16-byte boundaries come by TMA bulk
  // copies, one a row (the slot's barrier expects their bytes and lane 0's
  // arrival); other rows by the copying warp's 4-byte cp.asyncs (the
  // barrier expects its 32 lanes)
  const bool bulk = T_x % 4 == 0 && reinterpret_cast<uintptr_t>(nc) % 16 == 0;
  if (tid == 0) {
    for (int i = 0; i < NB; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(full + i)),
                   "r"(bulk ? 1 : 32)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // columns T_x .. RS - 1 of every ring row read as MAX_NEG
  for (int i = tid; i < NB * kBatch * (RS - T_x); i += kThreads) {
    const int r = i / (RS - T_x);
    ring[r * RS + T_x + i % (RS - T_x)] = kMaxNeg;
  }
  __syncthreads();

  if (warp == 0) {
    if (ty > 0) {
      float v[CPL];
      for (int q = 0; q < nbatch; ++q) {
        const float* slot = ring + (q % NB) * kBatch * RS;
        mbar_wait(full + q % NB, (q / NB) & 1);  // the slot's rows landed
        if (q == 0) {
#pragma unroll
          for (int j = 0; j < CPL; ++j) v[j] = (lane == 0 && j == 0) ? slot[0] : kMaxNeg;
        }
        dp_block<CPL>(slot, v, bits + (size_t)q * CPL * 32, q * kBatch, q == 0 ? 1 : 0, ty, lane);
        if (q + NB < nbatch) bar_arrive(1 + q % NB);  // slot empty
      }
      __syncwarp();
      backtrack<CPL>(bits, ty, tx, rec, lane);
    }
  } else if (warp == 1) {
    for (int q = 0; q < nbatch; ++q) {
      if (q >= NB) bar_sync(1 + q % NB);  // wait until warp 0 is done with the slot
      float* slot = ring + (q % NB) * kBatch * RS;
      uint64_t* bar = full + q % NB;
      const int rows = min(kBatch, ty - q * kBatch);
      const float* src = ncb + (size_t)q * kBatch * T_x;
      if (bulk) {
        if (lane == 0) expect_bytes(bar, (uint32_t)(rows * T_x * sizeof(float)));
        __syncwarp();
        if (lane < rows) bulk_copy(slot + lane * RS, src + lane * T_x, T_x * sizeof(float), bar);
      } else {
        for (int r = 0; r < rows; ++r)
          for (int c = lane; c < T_x; c += 32) cp_async4(slot + r * RS + c, src + r * T_x + c);
        cp_async_arrive(bar);  // the slot is full when every lane's copies landed
      }
    }
  } else {  // zeros, while the DP runs
    float* pb = path + (size_t)b * T_y * T_x;
    const size_t n = (size_t)T_y * T_x;
    const int t = tid - 64, nt = kThreads - 64;
    if (n % 4 == 0) {
      float4* p4 = reinterpret_cast<float4*>(pb);
      for (size_t i = t; i < n / 4; i += nt) p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (size_t i = t; i < n; i += nt) pb[i] = 0.f;
    }
  }
  __syncthreads();
  for (int y = tid; y < ty; y += kThreads) path[((size_t)b * T_y + y) * T_x + rec[y]] = 1.f;
}

// The chain floor: one warp runs the DP's row steps over n_rows rows of
// the 32-row block `rows` [32, T_x] already in shared memory (the same
// block again for every 32 rows), then the backtrack over their move bits
// (bits: [ceil(n_rows / 32), CPL, 32] words, rec: [n_rows]).
template <int CPL>
__global__ void __launch_bounds__(32)
mas_probe_kernel(const float* __restrict__ rows, unsigned* __restrict__ bits,
                 int* __restrict__ rec, int n_rows, int T_x) {
  constexpr int RS = 32 * CPL;
  extern __shared__ float slot[];  // [32, RS]
  const int lane = threadIdx.x;
  for (int i = lane; i < kBatch * RS; i += 32) {
    const int r = i / RS, c = i % RS;
    slot[i] = c < T_x ? rows[r * T_x + c] : kMaxNeg;
  }
  __syncwarp();
  float v[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) v[j] = (lane == 0 && j == 0) ? slot[0] : kMaxNeg;
  for (int q = 0; q * kBatch < n_rows; ++q)
    dp_block<CPL>(slot, v, bits + (size_t)q * CPL * 32, q * kBatch, q == 0 ? 1 : 0, n_rows, lane);
  __syncwarp();
  backtrack<CPL>(bits, n_rows, T_x, rec, lane);
}

size_t ring_bytes(int cpl, int nb) { return kHead + (size_t)nb * kBatch * 32 * cpl * sizeof(float); }

template <int CPL>
cudaError_t launch(const float* nc, const int* t_ys, const int* t_xs, float* path,
                   unsigned* gbits, int B, int T_y, int T_x, cudaStream_t stream) {
  const size_t bits = (size_t)(T_y + kBatch - 1) / kBatch * CPL * 32 * sizeof(unsigned);
  const size_t fixed = (size_t)T_y * sizeof(int) + (gbits != nullptr ? 0 : bits);
  // three ring slots where they fit, else two
  const int nb = fixed + ring_bytes(CPL, 3) <= (size_t)kSmemLimit ? 3 : 2;
  const size_t smem = fixed + ring_bytes(CPL, nb);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mas_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mas_kernel<CPL><<<B, kThreads, smem, stream>>>(nc, t_ys, t_xs, path, gbits, T_y, T_x, nb);
  return cudaGetLastError();
}

template <int CPL>
cudaError_t launch_probe(const float* rows, unsigned* bits, int* rec, int n_rows, int T_x,
                         cudaStream_t stream) {
  const int smem = (int)(kBatch * 32 * CPL * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(mas_probe_kernel<CPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mas_probe_kernel<CPL><<<1, 32, smem, stream>>>(rows, bits, rec, n_rows, T_x);
  return cudaGetLastError();
}

}  // namespace

// MAS over B items on `stream`. bits is null (move bits in shared memory)
// or a [B, ceil(T_y / 32), cols_per_lane, 32] uint32 scratch buffer,
// cols_per_lane being the wrapper's `cols_per_lane(T_x)`. Returns the CUDA
// error (0 on success).
extern "C" int tts_mas_forward(const float* neg_cent, const int* t_ys, const int* t_xs,
                               float* path, unsigned* bits, int B, int T_y, int T_x,
                               void* stream) {
  if (B < 1 || T_y < 1 || T_x < 1 || T_x > 512) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int words = (T_x + 31) / 32;
  if (words <= 1) return (int)launch<1>(neg_cent, t_ys, t_xs, path, bits, B, T_y, T_x, s);
  if (words <= 2) return (int)launch<2>(neg_cent, t_ys, t_xs, path, bits, B, T_y, T_x, s);
  if (words <= 4) return (int)launch<4>(neg_cent, t_ys, t_xs, path, bits, B, T_y, T_x, s);
  if (words <= 6) return (int)launch<6>(neg_cent, t_ys, t_xs, path, bits, B, T_y, T_x, s);
  if (words <= 8) return (int)launch<8>(neg_cent, t_ys, t_xs, path, bits, B, T_y, T_x, s);
  if (words <= 12) return (int)launch<12>(neg_cent, t_ys, t_xs, path, bits, B, T_y, T_x, s);
  return (int)launch<16>(neg_cent, t_ys, t_xs, path, bits, B, T_y, T_x, s);
}

// The chain floor probe on `stream` (see mas_probe_kernel): rows [32, T_x]
// fp32, bits [ceil(n_rows / 32), cols_per_lane(T_x), 32] uint32, rec
// [n_rows] int32. Returns the CUDA error (0 on success).
extern "C" int tts_mas_chain_probe(const float* rows, unsigned* bits, int* rec, int n_rows,
                                   int T_x, void* stream) {
  if (n_rows < 1 || T_x < 1 || T_x > 512) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int words = (T_x + 31) / 32;
  if (words <= 1) return (int)launch_probe<1>(rows, bits, rec, n_rows, T_x, s);
  if (words <= 2) return (int)launch_probe<2>(rows, bits, rec, n_rows, T_x, s);
  if (words <= 4) return (int)launch_probe<4>(rows, bits, rec, n_rows, T_x, s);
  if (words <= 6) return (int)launch_probe<6>(rows, bits, rec, n_rows, T_x, s);
  if (words <= 8) return (int)launch_probe<8>(rows, bits, rec, n_rows, T_x, s);
  if (words <= 12) return (int)launch_probe<12>(rows, bits, rec, n_rows, T_x, s);
  return (int)launch_probe<16>(rows, bits, rec, n_rows, T_x, s);
}
