// Monotonic alignment search (MAS): Viterbi DP and backtrack, one warp per
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
// v[y-1, index] < v[y-1, index-1]).
//
// Bound on the H100: not bytes (about 12 MB at [8, 1000, 192], 4 us at
// 3.35 TB/s) nor operations, but the two chains of T_y dependent row steps.
// Design:
// - One warp runs an item's DP; lane l owns columns l, l + 32, ...; the
//   left neighbour v[y-1, x-1] comes from lane l-1 by __shfl_up_sync (lane 0
//   takes lane 31's previous column), so a row needs no block barrier.
// - Only the move decisions survive the DP: one bit per cell, a
//   __ballot_sync per 32 columns, kept in shared memory (T_y * ceil(T_x/32)
//   words, 24 KB at 1000 x 192) or, when that does not fit, in a global
//   scratch buffer the wrapper allocates.
// - Rows of neg_cent are loaded kRows ahead into registers.
// - Lane 0 walks the bits and records each row's index in shared memory;
//   then the block's eight warps write the one-hot rows, zeros included,
//   with neighbouring lanes on neighbouring addresses.

#include <cuda_runtime.h>

namespace {

constexpr float kMaxNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // dynamic shared memory per block on Hopper

template <int CPL>
__global__ void __launch_bounds__(kThreads)
mas_kernel(const float* __restrict__ nc, const int* __restrict__ t_ys,
           const int* __restrict__ t_xs, float* __restrict__ path,
           unsigned* __restrict__ gbits, int T_y, int T_x) {
  constexpr int kRows = CPL <= 8 ? 8 : 4;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ty = min(max(t_ys[b], 0), T_y);
  const int tx = min(max(t_xs[b], 0), T_x);

  extern __shared__ unsigned smem[];
  int* rec = reinterpret_cast<int*>(smem);  // [T_y] path index per row
  unsigned* bits = gbits != nullptr ? gbits + (size_t)b * T_y * CPL : smem + T_y;  // [T_y, CPL]
  const float* ncb = nc + (size_t)b * T_y * T_x;

  if (warp == 0 && ty > 0) {
    float prev[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) prev[j] = (lane + 32 * j == 0) ? ncb[0] : kMaxNeg;

    float buf[kRows][CPL];
    auto load_rows = [&](float (&dst)[kRows][CPL], int y0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int x = lane + 32 * j;
          dst[r][j] = (y0 + r < ty && x < tx) ? __ldg(ncb + (size_t)(y0 + r) * T_x + x) : kMaxNeg;
        }
    };
    load_rows(buf, 1);
    for (int y0 = 1; y0 < ty; y0 += kRows) {
      float nxt[kRows][CPL];
      load_rows(nxt, y0 + kRows);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int y = y0 + r;
        if (y >= ty) break;
        float left[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const float up = __shfl_up_sync(kFull, prev[j], 1);
          const float wrap = __shfl_sync(kFull, prev[j > 0 ? j - 1 : 0], 31);
          left[j] = lane > 0 ? up : (j > 0 ? wrap : kMaxNeg);
        }
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int x = lane + 32 * j;
          const bool move = x > 0 && (x == y || prev[j] < left[j]);
          const unsigned word = __ballot_sync(kFull, move);
          if (lane == 0) bits[(size_t)y * CPL + j] = word;
          const float stay = x == y ? kMaxNeg : prev[j];
          prev[j] = fmaxf(buf[r][j] + fmaxf(stay, left[j]), kMaxNeg);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < CPL; ++j) buf[r][j] = nxt[r][j];
    }

    if (lane == 0) {
      int index = max(tx - 1, 0);
      for (int y = ty - 1; y >= 0; --y) {
        rec[y] = index;
        if (y > 0 && index > 0 && ((bits[(size_t)y * CPL + (index >> 5)] >> (index & 31)) & 1u))
          --index;
      }
    }
  }
  __syncthreads();

  float* pb = path + (size_t)b * T_y * T_x;
  for (int y = warp; y < T_y; y += kThreads / 32) {
    const int idx = y < ty ? rec[y] : -1;
    for (int x = lane; x < T_x; x += 32) pb[(size_t)y * T_x + x] = x == idx ? 1.f : 0.f;
  }
}

template <int CPL>
cudaError_t launch(const float* nc, const int* t_ys, const int* t_xs, float* path,
                   unsigned* gbits, int B, int T_y, int T_x, cudaStream_t stream) {
  const size_t smem = (size_t)T_y * sizeof(int) +
                      (gbits != nullptr ? 0 : (size_t)T_y * CPL * sizeof(unsigned));
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mas_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mas_kernel<CPL><<<B, kThreads, smem, stream>>>(nc, t_ys, t_xs, path, gbits, T_y, T_x);
  return cudaGetLastError();
}

}  // namespace

// MAS over B items on `stream`. bits is null (move bits in shared memory)
// or a [B, T_y, cols_per_lane] uint32 scratch buffer, cols_per_lane being
// the wrapper's `cols_per_lane(T_x)`. Returns the CUDA error (0 on success).
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
