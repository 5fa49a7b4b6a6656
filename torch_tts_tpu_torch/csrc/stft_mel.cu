// Fused STFT + log-mel: window -> real DFT as two products -> magnitude ->
// mel product -> log, one CTA per block of 32 frames.
//
// Replaces the TPU kernel torch_tts_tpu/kernels/stft.py
// (mel_spectrogram_fused -> _stft_mel_kernel). Contract of the Python wrapper
// (torch_tts_tpu_torch/kernels/stft.py): yp [B, Lp] fp32, the reflect-padded
// waveform; window [n_fft]; dft [n_fft / 128, n_fft, 128], per tile of 64
// bins their cos columns then their sin columns, tile 0's first sin column
// (bin 0's, which is zero) replaced by the Nyquist bin's cos column;
// mel_t [n_fft / 2 + 1, M], the mel basis transposed -> out [B, T, M] with
//   frame (b, t)[k] = yp[b, t * hop + k] * window[k]
//   re, im = frame @ cos, frame @ sin          (bins 0 .. n_fft / 2)
//   mag = sqrt(re^2 + im^2 + 1e-6)
//   out[b, t] = log(max(mag @ mel_t, 1e-5))
// as the TPU kernel computes it. The Nyquist bin's sin column (sin(-pi n) in
// float64, at most about 1e-13) is dropped: its square is below 1e-24 next
// to the 1e-6 under the root.
//
// Work on the H100 at 8 x 10 s (6,888 frames, n_fft 1024, 80 mels): the
// products here are 2 * 6888 * 513 * (2 * 1024 + 80) = 15.0 GFLOP, 0.22 ms at
// 67 TFLOP/s fp32, against 13 MB of waveform, constants and output (4 us at
// 3.35 TB/s). A real FFT and the mel product need about 0.70 GFLOP (0.010 ms):
// the DFT as products is the TPU kernel's formulation, here in fp32 SIMT FMAs.
// Design:
// - A CTA of 128 threads takes 32 consecutive frames of the flattened
//   [B * T] frame axis and reads them straight from yp at stride hop (the
//   frames overlap n_fft / hop times; nothing is framed in device memory).
// - Bins in tiles of 64: per tile the DFT is a [32 x n_fft] @ [n_fft x 128]
//   product (cos and sin columns side by side) in K steps of 32, each step's
//   windowed frame tile and DFT tile staged in shared memory, double
//   buffered through registers. A thread owns 4 frames x 4 bins and holds
//   both re and im, so the magnitude is its own epilogue.
// - The tile's magnitudes go to shared memory, and the mel sums [32 x M]
//   stay in registers across all tiles (4 frames x up to 8 mels a thread).
//   n_fft / 2 bins are n_fft / 128 whole tiles; the odd bin, Nyquist, rides
//   in tile 0's spare column, so no tile is partly empty.
// - The log and the clamp are applied on the store; frames past B * T are
//   zeros and are not stored.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFrames = 32;          // frames per CTA
constexpr int kFreqs = 64;           // bins per tile
constexpr int kCols = 2 * kFreqs;    // cos and sin columns of a tile
constexpr int kK = 32;               // DFT depth per staged step
constexpr int kAStride = kFrames + 4;        // frame-tile row, float4-aligned
constexpr int kMStride = kFreqs + 1;         // magnitude row, bin kFreqs = Nyquist
constexpr int kMelsPerThread = 8;            // M <= 128
constexpr int kAPerThread = kK * kFrames / kThreads;          // 8
constexpr int kBPerThread = kK * kCols / 4 / kThreads;        // 8 float4
constexpr int kSmemFloats = 2 * kK * kAStride + 2 * kK * kCols + kFrames * kMStride;

__global__ void __launch_bounds__(kThreads)
stft_mel_kernel(const float* __restrict__ yp, const float* __restrict__ window,
                const float* __restrict__ dft, const float* __restrict__ mel_t,
                float* __restrict__ out, int Lp, int T, int N, int n_fft, int hop, int M) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [2][kK][kAStride] windowed frames, k-major
  float* Bs = As + 2 * kK * kAStride;        // [2][kK][kCols]   DFT columns
  float* Ms = Bs + 2 * kK * kCols;           // [kFrames][kMStride] magnitudes

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kFrames;
  const int fr = tid & 7;   // frames 4 fr .. 4 fr + 3 (DFT and mel)
  const int fq = tid >> 3;  // bins 4 fq .. 4 fq + 3; mels fq + 16 q

  // staging: this thread's frames warp + 4 r, sample k0 + lane of each
  int a_off[kAPerThread];
#pragma unroll
  for (int r = 0; r < kAPerThread; ++r) {
    const int n = n0 + warp + 4 * r;
    a_off[r] = n < N ? (n / T) * Lp + (n % T) * hop : -1;
  }

  float mel[4][kMelsPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < kMelsPerThread; ++q) mel[i][q] = 0.f;

  const int n_tiles = n_fft / kCols;
  const int n_steps = n_fft / kK;
  for (int j = 0; j < n_tiles; ++j) {
    const float4* dft_tile = reinterpret_cast<const float4*>(dft + (size_t)j * n_fft * kCols);
    float a_reg[kAPerThread];
    float4 b_reg[kBPerThread];
    auto load = [&](int step) {
      const int k = step * kK + lane;
      const float w = __ldg(window + k);
#pragma unroll
      for (int r = 0; r < kAPerThread; ++r)
        a_reg[r] = a_off[r] >= 0 ? __ldg(yp + a_off[r] + k) * w : 0.f;
#pragma unroll
      for (int r = 0; r < kBPerThread; ++r)
        b_reg[r] = __ldg(dft_tile + (size_t)step * (kK * kCols / 4) + tid + r * kThreads);
    };
    auto store = [&](int buf) {
      float* as = As + buf * kK * kAStride;
#pragma unroll
      for (int r = 0; r < kAPerThread; ++r) as[lane * kAStride + warp + 4 * r] = a_reg[r];
      float4* bs = reinterpret_cast<float4*>(Bs + buf * kK * kCols);
#pragma unroll
      for (int r = 0; r < kBPerThread; ++r) bs[tid + r * kThreads] = b_reg[r];
    };

    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) re[i][q] = im[i][q] = 0.f;

    load(0);
    store(0);
    __syncthreads();
    for (int step = 0; step < n_steps; ++step) {
      const int buf = step & 1;
      if (step + 1 < n_steps) load(step + 1);
      const float* as = As + buf * kK * kAStride + 4 * fr;
      const float* bs = Bs + buf * kK * kCols + 4 * fq;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(as + kk * kAStride);
        const float4 c4 = *reinterpret_cast<const float4*>(bs + kk * kCols);
        const float4 s4 = *reinterpret_cast<const float4*>(bs + kk * kCols + kFreqs);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float c[4] = {c4.x, c4.y, c4.z, c4.w};
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            re[i][q] = fmaf(a[i], c[q], re[i][q]);
            im[i][q] = fmaf(a[i], s[q], im[i][q]);
          }
      }
      if (step + 1 < n_steps) store(buf ^ 1);
      __syncthreads();
    }

    // magnitudes of the tile (and of the Nyquist bin in tile 0's spare column)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* row = Ms + (4 * fr + i) * kMStride;
        if (j == 0 && fq == 0 && q == 0) {
          row[0] = sqrtf(re[i][0] * re[i][0] + 1e-6f);
          row[kFreqs] = sqrtf(im[i][0] * im[i][0] + 1e-6f);
        } else {
          row[4 * fq + q] = sqrtf(re[i][q] * re[i][q] + im[i][q] * im[i][q] + 1e-6f);
        }
      }
    __syncthreads();

    // mel sums: this thread's 4 frames x mels fq + 16 q
    const int n_bins = j == 0 ? kFreqs + 1 : kFreqs;
    for (int c = 0; c < n_bins; ++c) {
      const int f = c < kFreqs ? j * kFreqs + c : n_fft / 2;
      float m4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) m4[i] = Ms[(4 * fr + i) * kMStride + c];
#pragma unroll
      for (int q = 0; q < kMelsPerThread; ++q) {
        const int m = fq + 16 * q;
        if (m < M) {
          const float w = __ldg(mel_t + (size_t)f * M + m);
#pragma unroll
          for (int i = 0; i < 4; ++i) mel[i][q] = fmaf(m4[i], w, mel[i][q]);
        }
      }
    }
    __syncthreads();  // Ms is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * fr + i;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < kMelsPerThread; ++q) {
      const int m = fq + 16 * q;
      if (m < M) {
        const float v = mel[i][q];
        out[(size_t)n * M + m] = logf(v < 1e-5f ? 1e-5f : v);  // NaN stays NaN
      }
    }
  }
}

}  // namespace

// Log-mel of B reflect-padded waveforms [B, Lp] into out [B, T, M] on
// `stream`; n_fft a multiple of 128, 1 <= M <= 128, B * Lp < 2^31. Returns
// the CUDA error (0 on success).
extern "C" int tts_stft_mel_forward(const float* yp, const float* window, const float* dft,
                                    const float* mel_t, float* out, int B, int Lp, int T,
                                    int n_fft, int hop, int M, void* stream) {
  if (B < 1 || T < 1 || hop < 1 || n_fft < kCols || n_fft % kCols != 0 || M < 1 ||
      M > 16 * kMelsPerThread || (T - 1) * hop + n_fft > Lp)
    return (int)cudaErrorInvalidValue;
  const int N = B * T;
  const size_t smem = (size_t)kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stft_mel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stft_mel_kernel<<<(N + kFrames - 1) / kFrames, kThreads, smem,
                    reinterpret_cast<cudaStream_t>(stream)>>>(yp, window, dft, mel_t, out, Lp, T,
                                                              N, n_fft, hop, M);
  return (int)cudaGetLastError();
}
