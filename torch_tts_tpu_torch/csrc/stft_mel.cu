// Fused STFT + log-mel as an FFT on chip: window -> real FFT (an n_fft / 2
// point complex FFT and the two-for-one split) -> magnitude -> mel product
// over each mel's nonzero bins -> log, one warp per frame.
//
// Replaces the TPU kernel torch_tts_tpu/kernels/stft.py
// (mel_spectrogram_fused -> _stft_mel_kernel), which computes the DFT as two
// dense products. Contract of the Python wrapper
// (torch_tts_tpu_torch/kernels/stft.py): yp [B, Lp] fp32, the reflect-padded
// waveform; window [n_fft]; twiddle [n_fft] complex (re, im) fp32 with
// twiddle[k] = exp(-2 pi i k / n_fft), computed in float64 on the host;
// mel [M, F] fp32, F = n_fft / 2 + 1; ranges [M, 2] int32, the half-open
// range [lo_m, hi_m) of mel m's nonzero bins -> out [B, T, M] with
//   frame (b, t)[j] = yp[b, t * hop + j] * window[j]
//   X = rfft(frame)                            (bins 0 .. n_fft / 2)
//   mag = sqrt(re^2 + im^2 + 1e-6)
//   out[b, t, m] = log(max(sum_{f in [lo_m, hi_m)} mag[f] mel[m, f], 1e-5))
//
// Bound on the H100 at 8 x 10 s (6,888 frames, n_fft 1024, 80 mels): the
// function's least work, a real FFT and the mel product, is about 0.70
// GFLOP (0.010 ms at 67 TFLOP/s fp32), against 13 MB of waveform, basis and
// output (0.004 ms at 3.35 TB/s). This kernel does about 0.13 GFLOP of FFT
// and, with the ranges of a triangular basis, under 0.03 GFLOP of mel
// product; it is bound by latency and shared-memory traffic, not by either.
// Design:
// - A CTA of kWarps warps takes kWarps consecutive frames of the flattened
//   [B * T] frame axis, a warp a frame, so 256 frames still give 64 CTAs.
//   Frames are read straight from yp at stride hop and windowed on load;
//   nothing is framed in device memory.
// - Two-for-one: z[j] = x[2 j] + i x[2 j + 1], an N = n_fft / 2 point
//   complex FFT Z of z, then for k = 0 .. N
//     X[k] = (Z[k] + conj Z[N - k]) / 2 - i W^k (Z[k] - conj Z[N - k]) / 2
//   with W = exp(-2 pi i / n_fft) and Z[N] = Z[0] (bins 0 and N both from Z[0]).
// - The complex FFT is Stockham, decimation in frequency, in two float2
//   buffers of N per warp in shared memory: radix-4 stages, then one
//   radix-2 stage when log2 N is odd (stft.fft_radices). A stage of length
//   n and stride s (n s = N) takes butterfly (p, q), p < n / r, q < s, from
//   x[q + s (p + j n / r)], j < r, and writes y[q + s (r p + j)] times
//   W_n^(j p); the output lands in natural order. Stage 0 reads z from the
//   waveform. Twiddles W_N^e = twiddle[2 e] come from the table, staged in
//   shared memory once per CTA.
// - Magnitudes of the N + 1 bins go to the warp's free buffer; lane l then
//   sums mels l, l + 32, ... over their ranges (a triangular basis costs
//   about two multiply-adds a bin in all; a dense basis gives full ranges
//   and stays exact), and stores the log.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // frames per CTA
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
// i * a
__device__ __forceinline__ float2 cmul_i(float2 a) { return make_float2(-a.y, a.x); }

__global__ void __launch_bounds__(kThreads)
stft_mel_kernel(const float* __restrict__ yp, const float* __restrict__ window,
                const float2* __restrict__ twiddle, const float* __restrict__ mel,
                const int* __restrict__ ranges, float* __restrict__ out, int Lp, int T,
                int n_frames, int n_fft, int hop, int M) {
  extern __shared__ __align__(16) float2 smem[];
  const int N = n_fft / 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float2* tw = smem;                               // [n_fft]
  float2* x = smem + n_fft + warp * 2 * N;         // [N]
  float2* y = x + N;                               // [N]

  for (int i = threadIdx.x; i < n_fft; i += kThreads) tw[i] = twiddle[i];
  __syncthreads();  // the only CTA-wide barrier: warps past n_frames leave below

  const int n = blockIdx.x * kWarps + warp;
  if (n >= n_frames) return;
  const float* frame = yp + (size_t)(n / T) * Lp + (size_t)(n % T) * hop;

  int len = N, log2_s = 0;
  bool first = true;
  while (len > 1) {
    const int s = 1 << log2_s;
    if (len >= 4) {
      const int m = len >> 2;
      for (int b = lane; b < N / 4; b += 32) {
        const int p = b >> log2_s, q = b & (s - 1);
        float2 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = q + s * (p + j * m);
          if (first) {
            v[j] = make_float2(__ldg(frame + 2 * i) * __ldg(window + 2 * i),
                               __ldg(frame + 2 * i + 1) * __ldg(window + 2 * i + 1));
          } else {
            v[j] = x[i];
          }
        }
        const float2 apc = cadd(v[0], v[2]), amc = csub(v[0], v[2]);
        const float2 bpd = cadd(v[1], v[3]), jbmd = cmul_i(csub(v[1], v[3]));
        const int e = 2 * p * s;  // twiddle[e] = W_N^(p s) = W_len^p
        float2* o = y + q + s * 4 * p;
        o[0] = cadd(apc, bpd);
        o[s] = cmul(csub(amc, jbmd), tw[e]);
        o[2 * s] = cmul(csub(apc, bpd), tw[2 * e]);
        o[3 * s] = cmul(cadd(amc, jbmd), tw[3 * e]);
      }
      len >>= 2;
      log2_s += 2;
    } else {  // len == 2: p = 0, no twiddle
      for (int q = lane; q < N / 2; q += 32) {
        const float2 a = x[q], b = x[q + s];
        y[q] = cadd(a, b);
        y[q + s] = csub(a, b);
      }
      len = 1;
      log2_s += 1;
    }
    first = false;
    float2* t = x;
    x = y;
    y = t;
    __syncwarp();
  }

  // two-for-one split and magnitudes of bins 0 .. N into the free buffer
  float* mag = reinterpret_cast<float*>(y);
  for (int k = lane; k <= N; k += 32) {
    const float2 zk = x[k & (N - 1)], zc = x[(N - k) & (N - 1)];
    const float er = 0.5f * (zk.x + zc.x), ei = 0.5f * (zk.y - zc.y);
    // O = -i (Z[k] - conj Z[N - k]) / 2
    const float o_r = 0.5f * (zk.y + zc.y), o_i = -0.5f * (zk.x - zc.x);
    const float2 w = tw[k];
    const float re = er + w.x * o_r - w.y * o_i;
    const float im = ei + w.x * o_i + w.y * o_r;
    mag[k] = sqrtf(re * re + im * im + 1e-6f);
  }
  __syncwarp();

  const int F = N + 1;
  for (int m = lane; m < M; m += 32) {
    const int lo = __ldg(ranges + 2 * m), hi = __ldg(ranges + 2 * m + 1);
    const float* row = mel + (size_t)m * F;
    float acc = 0.f;
    for (int f = lo; f < hi; ++f) acc = fmaf(mag[f], __ldg(row + f), acc);
    out[(size_t)n * M + m] = logf(acc < 1e-5f ? 1e-5f : acc);  // NaN stays NaN
  }
}

}  // namespace

// Log-mel of B reflect-padded waveforms [B, Lp] into out [B, T, M] on
// `stream`; n_fft a power of two in [256, 2048], 1 <= M <= 128,
// B * Lp < 2^31, every range within [0, n_fft / 2 + 1). Returns the CUDA
// error (0 on success).
extern "C" int tts_stft_mel_forward(const float* yp, const float* window, const float* twiddle,
                                    const float* mel, const int* ranges, float* out, int B,
                                    int Lp, int T, int n_fft, int hop, int M, void* stream) {
  int log2_n = 0;
  while ((1 << log2_n) < n_fft) ++log2_n;
  if (B < 1 || T < 1 || hop < 1 || n_fft < 256 || n_fft > 2048 || (1 << log2_n) != n_fft ||
      M < 1 || M > 128 || (T - 1) * hop + n_fft > Lp)
    return (int)cudaErrorInvalidValue;
  const int n_frames = B * T;
  const size_t smem = (size_t)(n_fft + kWarps * n_fft) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(stft_mel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stft_mel_kernel<<<(n_frames + kWarps - 1) / kWarps, kThreads, smem,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      yp, window, reinterpret_cast<const float2*>(twiddle), mel, ranges, out, Lp, T, n_frames,
      n_fft, hop, M);
  return (int)cudaGetLastError();
}
