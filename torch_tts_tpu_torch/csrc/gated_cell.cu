// LLTM gated cell forward: the gate product and the cell update in one
// kernel, one warp per state unit.
//
// Replaces the TPU kernel torch_tts_tpu/kernels/gated_cell.py
// (_lltm_fwd_pallas -> _fwd_kernel). Contract of the Python wrapper
// (torch_tts_tpu_torch/kernels/gated_cell.py): x [B, I], w [3H, H + I],
// bias [3H], h and c [B, H], all fp32 -> new_h, new_c [B, H] and the raw
// gates [B, 3H] (the backward's residual), as
//   gates = [h, x] @ w^T + bias
//   ig = sigmoid(gates[:, :H]), og = sigmoid(gates[:, H:2H])
//   cand = elu(gates[:, 2H:]) with elu(z) = z > 0 ? z : exp(min(z, 0)) - 1
//   new_c = c + cand * ig, new_h = tanh(new_c) * og
//
// Bound on the H100: neither. At the PyTorch extension tutorial's LLTM
// (B = 16, I = 32, H = 128) the cell is 2.0 MFLOP and 0.31 MB, well under a
// microsecond at either peak; a launch costs a few microseconds, so the
// kernel is launch-bound. Design: the CTA stages [h, x] for all B rows in
// shared memory (rows padded by one float, so lanes on different rows hit
// different banks); warp w takes unit j and stages rows j, H + j and 2H + j
// of w; lane b computes the three gate sums of row b (lanes loop over rows
// when B > 32), so the whole epilogue is local to one thread.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory per block on Hopper

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

__global__ void __launch_bounds__(kWarps * 32)
lltm_forward_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ h,
                    const float* __restrict__ c, float* __restrict__ new_h,
                    float* __restrict__ new_c, float* __restrict__ gates, int B, int I, int H) {
  extern __shared__ float smem[];
  const int K = H + I;
  float* Xs = smem;                        // [B][K + 1]
  float* Ws = Xs + (size_t)B * (K + 1);    // [kWarps][3][K]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < B * K; e += blockDim.x) {
    const int b = e / K, k = e % K;
    Xs[b * (K + 1) + k] = k < H ? h[(size_t)b * H + k] : x[(size_t)b * I + (k - H)];
  }
  const int j = blockIdx.x * kWarps + warp;
  float* ws = Ws + (size_t)warp * 3 * K;
  if (j < H) {
    for (int r = 0; r < 3; ++r)
      for (int k = lane; k < K; k += 32) ws[r * K + k] = w[(size_t)(r * H + j) * K + k];
  }
  __syncthreads();
  if (j >= H) return;

  for (int b = lane; b < B; b += 32) {
    const float* xb = Xs + b * (K + 1);
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    for (int k = 0; k < K; ++k) {
      const float v = xb[k];
      g0 = fmaf(v, ws[k], g0);
      g1 = fmaf(v, ws[K + k], g1);
      g2 = fmaf(v, ws[2 * K + k], g2);
    }
    g0 += bias[j];
    g1 += bias[H + j];
    g2 += bias[2 * H + j];
    float* gb = gates + (size_t)b * 3 * H;
    gb[j] = g0;
    gb[H + j] = g1;
    gb[2 * H + j] = g2;
    const float ig = sigmoid(g0), og = sigmoid(g1);
    const float cand = g2 > 0.f ? g2 : expf(fminf(g2, 0.f)) - 1.f;
    const float nc = c[(size_t)b * H + j] + cand * ig;
    new_c[(size_t)b * H + j] = nc;
    new_h[(size_t)b * H + j] = tanhf(nc) * og;
  }
}

}  // namespace

// One LLTM cell forward on `stream`. Returns the CUDA error (0 on success);
// cudaErrorInvalidValue when [h, x] for B rows and three weight rows per
// warp do not fit in shared memory.
extern "C" int tts_lltm_forward(const float* x, const float* w, const float* bias,
                                const float* h, const float* c, float* new_h, float* new_c,
                                float* gates, int B, int I, int H, void* stream) {
  if (B < 1 || I < 0 || H < 1) return (int)cudaErrorInvalidValue;
  const int K = H + I;
  const size_t smem = ((size_t)B * (K + 1) + (size_t)kWarps * 3 * K) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lltm_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lltm_forward_kernel<<<(H + kWarps - 1) / kWarps, kWarps * 32, smem,
                        reinterpret_cast<cudaStream_t>(stream)>>>(x, w, bias, h, c, new_h, new_c,
                                                                  gates, B, I, H);
  return (int)cudaGetLastError();
}
