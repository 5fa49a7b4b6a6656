// W8A8 int8 decoder convolutions: the dynamic activation quantizer and an
// int8 implicit-GEMM conv1d on the tensor cores.
//
// Replaces no Pallas kernel: in the JAX package the int8 decoder
// (`quantize_decoder`, torch_tts_tpu/ops/quant.py) is XLA work, the
// max / round / clip of `quantize_act_dynamic` (ops/quant.py:47) and
// `int8_conv1d`'s lax.conv_general_dilated with int32 accumulation
// (ops/quant.py:54-80). PyTorch has no int8 convolution on the card, so the
// port computes both here. Contract of the Python wrappers
// (torch_tts_tpu_torch/kernels/int8_conv.py):
//
// - quantize: x [B, C, T] fp32 -> x_q [B, T, C] int8, channels-last so that
//   the conv's K axis is contiguous, and s_x = max(max |x|, 1e-12) / 127 over
//   the whole tensor, on the device, as max(...) * fp32(1 / 127) (XLA's form
//   of the JAX package's division by the constant 127 under jit);
//   x_q = clip(rint(x / s_x), -127, 127) (IEEE division, round half to
//   even, as jnp.round and torch.round). x_q's rows are C rounded up to 32
//   apart, zero past C, so that the conv below takes any C_in: the wrapper
//   passes the padded width, and w_q's rows are padded with zeros to match.
// - conv: x_q [B, T, C_in] int8, w_q [N, k, C_in] int8, s_w [N] fp32, bias
//   [N / phases] fp32 or null. N = C_out * phases, column n = o * phases + r.
//   acc[b, t, n] = sum_j sum_c x_q[b, t + j * dil - pad_lo, c] * w_q[n, j, c]
//   in int32, rows outside [0, T) zero;
//   out[b, o, t * phases + r] = float(acc) * (s_x * s_w[n]) (+ bias[o]), out
//   [B, C_out, T_out * phases] fp32: the port's layout, with the subpixel
//   transposed conv's depth-to-space (phases = its stride) folded into the
//   store.
//
// Bound on the H100 (dense int8 tensor cores 1,979 TOPS; HBM3 3.35 TB/s):
// a conv does 2 M N K operations (M = B T_out, K = k C_in) and must move
// x_q (B T C_in bytes), w_q (N K) and its fp32 output (4 M N). At the
// decoder's shapes the two are close, because the fp32 output is 4 bytes a
// product column: the C=256 bank's k=3 conv at B=1 (8192 frames) is 3.2 GOP
// (1.6 us) against 10.7 MB (3.2 us), bound by bytes; its k=11 conv 11.8 GOP
// (6.0 us) against 11.2 MB (3.3 us), bound by operations. The quantizer
// reads 4 bytes an element and writes 1: bytes.
//
// Design (simple first; wgmma s8 and TMA come later):
// - conv: an implicit GEMM with no im2col buffer. The A tile of tap j is
//   x_q's rows t + j * dil - pad_lo, brought into shared memory by 16-byte
//   cp.async copies that zero-fill rows outside [0, T), so padding costs no
//   copy; the B tile is w_q's rows, K-contiguous. mma.sync m16n8k32 s8 x s8
//   -> s32; a CTA tile of 128 rows x 128 columns, 8 warps of 32 x 64; a
//   3-stage cp.async ring of BK = 64 (C_in % 64 == 0) or 32 bytes of K;
//   shared rows padded by 16 bytes so that a warp's fragment loads hit 32
//   distinct banks.
// - The epilogue writes the fp32 output once, in its final layout: no int32
//   tensor, no dequantize, reshape or transpose pass. With the columns
//   ordered (o, phase), a thread's two columns are adjacent samples of the
//   upsampled output.
// - The epilogue keeps the JAX order, float(acc) * (s_x * s_w[n]) then + bias,
//   each rounded (__fmul_rn / __fadd_rn, no fused multiply-add), so the
//   kernel equals its plain version bit for bit.
// - quantize: one kernel takes max |x| into a device word (atomicMax on the
//   bit pattern: non-negative floats order as integers, NaN above inf),
//   a second quantizes and transposes 32 x 32 tiles through shared memory.
//   s_x stays on the device: no host sync on the decode path.

#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;      // output rows (b, t) a CTA
constexpr int kBN = 128;      // output columns n a CTA
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kRowPad = 16;   // bytes of padding per shared row
constexpr float kEps = 1e-12f;
constexpr float kInv127 = 1.0f / 127.0f;  // fp32(1 / 127)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int BK>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx, const int8_t* __restrict__ wq,
    const float* __restrict__ sw, const float* __restrict__ bias, float* __restrict__ out,
    int B, int T, int C_in, int N, int k, int dil, int pad_lo, int T_out, int phases) {
  constexpr int kStride = BK + kRowPad;              // bytes per shared row
  constexpr int kChunks = BK / 16;                   // 16-byte copies per row
  constexpr int kACopies = kBM * kChunks / kThreads;
  constexpr int kBCopies = kBN * kChunks / kThreads;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sA = smem;                                 // [kStages][kBM][kStride]
  int8_t* sB = smem + kStages * kBM * kStride;       // [kStages][kBN][kStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;           // 4 x 2 warps of 32 x 64
  const int g = lane >> 2, tg = lane & 3;
  const long long M = (long long)B * T_out;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long K = (long long)k * C_in;
  const int cin_steps = C_in / BK;
  const int iters = k * cin_steps;

  // each thread's copies keep their rows and 16-byte columns over the K loop
  int a_row[kACopies], a_col[kACopies], a_t[kACopies];
  long long a_base[kACopies];
  bool a_ok[kACopies];
#pragma unroll
  for (int i = 0; i < kACopies; ++i) {
    const int idx = tid + i * kThreads;
    a_row[i] = idx / kChunks;
    a_col[i] = (idx % kChunks) * 16;
    const long long m = m0 + a_row[i];
    a_ok[i] = m < M;
    const long long b = a_ok[i] ? m / T_out : 0;
    a_t[i] = a_ok[i] ? (int)(m - b * T_out) - pad_lo : 0;
    a_base[i] = b * T;
  }
  int b_row[kBCopies], b_col[kBCopies];
  bool b_ok[kBCopies];
#pragma unroll
  for (int i = 0; i < kBCopies; ++i) {
    const int idx = tid + i * kThreads;
    b_row[i] = idx / kChunks;
    b_col[i] = (idx % kChunks) * 16;
    b_ok[i] = n0 + b_row[i] < N;
  }

  auto load = [&](int it, int stage) {
    const int j = it / cin_steps;
    const int c0 = (it - j * cin_steps) * BK;
    int8_t* dA = sA + stage * kBM * kStride;
#pragma unroll
    for (int i = 0; i < kACopies; ++i) {
      const int t = a_t[i] + j * dil;
      const bool ok = a_ok[i] && t >= 0 && t < T;
      const int8_t* src = ok ? xq + (a_base[i] + t) * C_in + c0 + a_col[i] : xq;
      cp_async_16(dA + a_row[i] * kStride + a_col[i], src, ok);
    }
    int8_t* dB = sB + stage * kBN * kStride;
#pragma unroll
    for (int i = 0; i < kBCopies; ++i) {
      const int8_t* src =
          b_ok[i] ? wq + (long long)(n0 + b_row[i]) * K + (long long)j * C_in + c0 + b_col[i]
                  : wq;
      cp_async_16(dB + b_row[i] * kStride + b_col[i], src, b_ok[i]);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` has landed; stage it - 1 is free to refill
    const int nxt = it + kStages - 1;
    if (nxt < iters) load(nxt, nxt % kStages);
    cp_async_commit();
    const int8_t* tA = sA + (it % kStages) * kBM * kStride;
    const int8_t* tB = sB + (it % kStages) * kBN * kStride;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = tA + (wm * 32 + mi * 16 + g) * kStride + ks + tg * 4;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * kStride);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* p = tB + (wn * 64 + ni * 8 + g) * kStride + ks + tg * 4;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  // epilogue: out[b, o, t * phases + r] for column n = o * phases + r
  const float s_x = *sx;
  const int C_out = N / phases;
  const long long L = (long long)T_out * phases;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 32 + mi * 16 + g + h * 8;
      if (m >= M) continue;
      const long long b = m / T_out;
      const long long t = m - b * T_out;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 64 + ni * 8 + tg * 2 + e;
          if (n >= N) continue;
          const int o = n / phases, r = n - o * phases;
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + e]), __fmul_rn(s_x, sw[n]));
          if (bias != nullptr) y = __fadd_rn(y, bias[o]);
          out[(b * C_out + o) * L + t * phases + r] = y;
        }
      }
    }
  }
}

// max |x| over n floats into *amax as a bit pattern (zeroed beforehand)
__global__ void __launch_bounds__(kThreads) absmax_kernel(const float* __restrict__ x,
                                                          long long n,
                                                          unsigned* __restrict__ amax) {
  unsigned m = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n / 4;
    for (long long i = start; i < n4; i += stride) {
      const float4 v = __ldg(x4 + i);
      m = max(m, max(max(__float_as_uint(fabsf(v.x)), __float_as_uint(fabsf(v.y))),
                     max(__float_as_uint(fabsf(v.z)), __float_as_uint(fabsf(v.w)))));
    }
    done = n4 * 4;
  }
  for (long long i = done + start; i < n; i += stride) m = max(m, __float_as_uint(fabsf(x[i])));
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned red[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? red[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(amax, m);
  }
}

// x [B, C, T] -> x_q [B, T, Cp], rows Cp (C rounded up to 32) apart, zero
// past C; grid (T / 32, Cp / 32, B), block (32, 8)
__global__ void quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                                const unsigned* __restrict__ amax, float* __restrict__ s_out,
                                int C, int Cp, int T) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, c0 = blockIdx.y * 32, t0 = blockIdx.x * 32;
  const float a = __uint_as_float(*amax);
  const float s = __fmul_rn(a < kEps ? kEps : a, kInv127);  // NaN stays NaN, as max(NaN, eps)
  if (blockIdx.x == 0 && blockIdx.y == 0 && b == 0 && threadIdx.x == 0 && threadIdx.y == 0)
    *s_out = s;
  const float* xb = x + (long long)b * C * T;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, t = t0 + threadIdx.x;
    tile[i][threadIdx.x] = (c < C && t < T) ? xb[(long long)c * T + t] : 0.0f;
  }
  __syncthreads();
  int8_t* qb = xq + (long long)b * T * Cp;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int t = t0 + i, c = c0 + threadIdx.x;
    if (t < T && c < Cp) {  // the tile holds 0 past C, which quantizes to 0
      const float q = fminf(fmaxf(rintf(__fdiv_rn(tile[threadIdx.x][i], s)), -127.0f), 127.0f);
      qb[(long long)t * Cp + c] = static_cast<int8_t>(__float2int_rn(q));
    }
  }
}

template <int BK>
cudaError_t launch_conv(const int8_t* xq, const float* sx, const int8_t* wq, const float* sw,
                        const float* bias, float* out, int B, int T, int C_in, int N, int k,
                        int dil, int pad_lo, int T_out, int phases, cudaStream_t stream) {
  const int smem = kStages * (kBM + kBN) * (BK + kRowPad);
  // the shared-memory limit is raised once per device (not per launch, so a
  // launch under CUDA graph capture makes no such call)
  static std::atomic<bool> raised[kMaxDevices];  // zero-initialised: false
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev].load()) {
    err = cudaFuncSetAttribute(int8_conv_kernel<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    raised[dev].store(true);
  }
  const long long M = (long long)B * T_out;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + kBN - 1) / kBN));
  int8_conv_kernel<BK><<<grid, kThreads, smem, stream>>>(xq, sx, wq, sw, bias, out, B, T, C_in,
                                                          N, k, dil, pad_lo, T_out, phases);
  return cudaGetLastError();
}

}  // namespace

// The activation quantizer on `stream`: x [B, C, T] fp32 -> x_q [B, T, Cp]
// int8, Cp = C rounded up to a multiple of 32 (the conv's K step), zero
// past C; scale holds two words: [0] s_x (written), [1] the max |x| bits
// (scratch). Returns the CUDA error (0 on success).
extern "C" int tts_int8_quantize(const float* x, int8_t* xq, float* scale, int B, int C, int Cp,
                                 int T, void* stream) {
  if (B < 1 || C < 1 || T < 1 || Cp != (C + 31) / 32 * 32 || Cp > 65535 * 32 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  unsigned* amax = reinterpret_cast<unsigned*>(scale + 1);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long n = (long long)B * C * T;
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  if (blocks < 1) blocks = 1;
  absmax_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, n, amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + 31) / 32), (unsigned)(Cp / 32), (unsigned)B);
  quantize_kernel<<<grid, dim3(32, 8), 0, s>>>(x, xq, amax, scale, C, Cp, T);
  return (int)cudaGetLastError();
}

// The int8 conv on `stream` (contract above). C_in a multiple of 32 (the
// wrapper passes any other width padded: rows of x_q and w_q that far
// apart, the weights zero past the real channels), N a multiple of phases, k * C_in at most 131072 (int32 sums of 127^2
// products). Returns the CUDA error (0 on success).
extern "C" int tts_int8_conv1d(const int8_t* xq, const float* sx, const int8_t* wq,
                               const float* sw, const float* bias, float* out, int B, int T,
                               int C_in, int N, int k, int dil, int pad_lo, int T_out,
                               int phases, void* stream) {
  if (B < 1 || T < 1 || T_out < 1 || C_in < 32 || C_in % 32 != 0 || N < 1 || k < 1 ||
      dil < 1 || phases < 1 || N % phases != 0 || (long long)k * C_in > 131072 ||
      (N + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (C_in % 64 == 0)
    return (int)launch_conv<64>(xq, sx, wq, sw, bias, out, B, T, C_in, N, k, dil, pad_lo, T_out,
                                phases, s);
  return (int)launch_conv<32>(xq, sx, wq, sw, bias, out, B, T, C_in, N, k, dil, pad_lo, T_out,
                              phases, s);
}
