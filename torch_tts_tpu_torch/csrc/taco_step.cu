// One eval-mode Taco2Prod decoder step (Tacotron-2 autoregressive step) in
// one cooperative launch.
//
// Replaces the TPU kernels torch_tts_tpu/kernels/taco_step.py
// taco_step_fused -> _kernel (weights resident in VMEM) and
// taco_step_streamed -> _streamed_kernel (the four big LSTM matrices
// double-buffered from HBM, fp32 or bf16). On Hopper both are this one
// kernel: the wrapper passes the w_ih and w_hh parts of each LSTM matrix as
// two pointers, which for the streamed entry point are the two row blocks
// of the pre-concatenated [w_ih; w_hh] matrix.
//
// What it computes (the contract of torch_tts_tpu_torch/kernels/taco_step.py),
// fp32 activations, B <= 8 rows:
//   x1    = drop1(relu(y_in W1 + b1)); x_pre = drop2(relu(x1 W2 + b2))
//   h_att, c_att = LSTM([x_pre, ctx, h_att] [W_ih; W_hh] + b)   zoneout blend
//   q = h_att Wq; e = memory q; e[:, L-1] = 1e4; p = isru_sigmoid(e)
//   w' = (w p + shift_right(w (1 - p))) * mmask; ctx' = w' memory
//   h_dec, c_dec = LSTM([h_att, ctx', h_dec] [W_ih; W_hh] + b)
//   y = leaky_relu([h_dec, ctx'] W_mel + b_mel, 0.01); s = [h_dec, ctx'] W_stop + b_stop
// drop_i(x) = mask_i ? x / keep : 0 when the wrapper passes PreNet keep
// masks, else the identity (the TPU kernel's contract). Weights are in the
// JAX layout, [K, N] row-major. bf16 LSTM weights are widened with
// __bfloat162float; activations stay fp32 (the TPU kernel rounds them to
// bf16 as well).
//
// Bound on the H100: bytes. At the LJSpeech widths (D_mel 80, P 256,
// Dc 512, H 1024) the step reads 74 MB of fp32 weights (39 MB with bf16 LSTM
// matrices) against about 2 B multiply-adds per 4 weight bytes at B <= 8:
// about 22 us at 3.35 TB/s in fp32. Design:
// - One persistent CTA per SM, 512 threads, cooperative launch; the step's
//   four all-to-all dependencies (x_pre, h_att, ctx, h_dec) and the
//   PreNet's and attention's inner ones are seven grid.sync() barriers
//   between eight phases. Small intermediates (x1, x_pre, q, p) go through
//   a global scratch buffer the wrapper allocates; later phases read
//   anything written inside the launch with __ldcg (L2), never through the
//   non-coherent path.
// - Each phase stages its input vector [K, B] in shared memory once, then
//   walks its tiles; every weight byte is read once per step for all B rows.
// - LSTM phases: a tile is 8 hidden units and all four of their gate
//   columns (gate-interleaved ownership, no repack: in the [K, 4H] layout a
//   gate's 8 fp32 columns are one 32-byte sector). Threads are 8 column
//   groups x 64 lanes over K, each loading 4 columns (16 bytes fp32, 8
//   bytes bf16) of 4 rows at a time; a shuffle and a shared-memory pass
//   reduce over K, and the LSTM nonlinearity and zoneout blend are the
//   epilogue, so no barrier separates gates from cell.
// - Small products (PreNet, query, mel/stop): tiles of 8 columns, 64 lanes
//   over K, one fp32 load each.
// - Attention: one warp per (b, l) dot for e and p; then per (b, 32 channels)
//   the new weights (recomputed per CTA from p) and the context.
// No tensor cores (fp32 SIMT FMAs), no TMA: later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;               // hidden units per LSTM tile (x 4 gates)
constexpr int kCols = 8;                // columns per small-product tile
constexpr int kKLanes = kThreads / 8;   // lanes over K in both tile kinds
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;      // dynamic shared memory per block on Hopper

// Order of the wrapper's pointer array.
enum Ptr {
  kYIn, kW, kCtx, kHAtt, kCAtt, kHDec, kCDec, kMemory, kMMask, kPMask1, kPMask2,
  kPW1, kPB1, kPW2, kPB2, kAttIH, kAttHH, kAttB, kQW, kDecIH, kDecHH, kDecB,
  kMelW, kMelB, kStopW, kStopB,
  kYOut, kSOut, kWOut, kCtxOut, kHAttOut, kCAttOut, kHDecOut, kCDecOut, kScratch,
  kNumPtrs
};

struct Params {
  const float *y_in, *w, *ctx, *h_att, *c_att, *h_dec, *c_dec, *memory, *mmask, *pmask1, *pmask2;
  const float *pw1, *pb1, *pw2, *pb2;
  const void *att_ih, *att_hh;
  const float *att_b, *qw;
  const void *dec_ih, *dec_hh;
  const float *dec_b, *mel_w, *mel_b, *stop_w, *stop_b;
  float *y, *s, *w_out, *ctx_out, *h_att_out, *c_att_out, *h_dec_out, *c_dec_out;
  float *q, *x1, *xpre, *p;  // scratch: [B, Dc], [B, P], [B, P], [B, L]
  int B, L, Dm, P, Dc, H1, H2, r, xs_floats;
  float p_zoneout, keep;
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __bfloat162float(lo.x); v[1] = __bfloat162float(lo.y);
  v[2] = __bfloat162float(hi.x); v[3] = __bfloat162float(hi.y);
}

// xs[(k0 + k) * NB + b] = src[b, k] for k < n (rows b >= B are zero);
// src may have been written earlier in this launch, so it is read via L2.
template <int NB>
__device__ void stage(float* xs, int k0, const float* src, int n, int B) {
  for (int i = threadIdx.x; i < n * NB; i += kThreads) {
    const int b = i / n, k = i - b * n;
    xs[(k0 + k) * NB + b] = b < B ? __ldcg(src + (size_t)b * n + k) : 0.f;
  }
}

// out[b, n] = sum_k xs[k, b] W[k, n] for the 8 columns n0..n0+7 (< N);
// epi(n, b, sum) for b < B. Whole block; red holds kWarps * 8 * NB floats.
template <int NB, typename Epi>
__device__ void dense_tile(const float* xs, int K, const float* __restrict__ W, int N, int n0,
                           int B, float* red, Epi epi) {
  const int t = threadIdx.x, c = t & 7, kl = t >> 3, lane = t & 31, warp = t >> 5;
  const int n = n0 + c;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  if (n < N) {
#pragma unroll 4
    for (int k = kl; k < K; k += kKLanes) {
      const float wv = __ldg(W + (size_t)k * N + n);
      const float* xk = xs + k * NB;
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = fmaf(wv, xk[b], acc[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {  // the warp's 4 lanes over K
    acc[b] += __shfl_xor_sync(kFull, acc[b], 8);
    acc[b] += __shfl_xor_sync(kFull, acc[b], 16);
  }
  if (lane < 8) {
#pragma unroll
    for (int b = 0; b < NB; ++b) red[(warp * 8 + c) * NB + b] = acc[b];
  }
  __syncthreads();
  if (t < 8 * NB) {
    const int cc = t / NB, b = t - cc * NB;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * 8 + cc) * NB + b];
    if (n0 + cc < N && b < B) epi(n0 + cc, b, sum);
  }
  __syncthreads();
}

// One LSTM tile: hidden units u0..u0+7, all four gates. xs holds [x, h]
// (K_ih + H rows); W_ih [K_ih, 4H], W_hh [H, 4H]. Writes the zoneout-blended
// h and c. red holds (kWarps * 32 + 32) * NB floats.
template <int NB, typename WT>
__device__ void lstm_tile(const float* xs, int K_ih, const WT* __restrict__ W_ih,
                          const WT* __restrict__ W_hh, int H, int u0, const float* __restrict__ bias,
                          const float* h_prev, const float* c_prev, float* h_out, float* c_out,
                          float pz, int B, float* red) {
  const int t = threadIdx.x, grp = t & 7, kl = t >> 3, lane = t & 31, warp = t >> 5;
  const size_t ld = 4 * (size_t)H;
  const int col = (grp >> 1) * H + u0 + 4 * (grp & 1);
  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;

  auto run = [&](const WT* __restrict__ W, const float* x, int K) {
    int k = kl;
    for (; k + 3 * kKLanes < K; k += 4 * kKLanes) {
      float wv[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) load4(W + (size_t)(k + u * kKLanes) * ld + col, wv[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* xk = x + (k + u * kKLanes) * NB;
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[b][j] = fmaf(wv[u][j], xk[b], acc[b][j]);
      }
    }
    for (; k < K; k += kKLanes) {
      float wv[4];
      load4(W + (size_t)k * ld + col, wv);
      const float* xk = x + k * NB;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][j] = fmaf(wv[j], xk[b], acc[b][j]);
    }
  };
  run(W_ih, xs, K_ih);
  run(W_hh, xs + K_ih * NB, H);

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[b][j] += __shfl_xor_sync(kFull, acc[b][j], 8);
      acc[b][j] += __shfl_xor_sync(kFull, acc[b][j], 16);
    }
  if (lane < 8) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(warp * 32 + grp * 4 + j) * NB + b] = acc[b][j];
  }
  __syncthreads();
  float* gates = red + kWarps * 32 * NB;  // [gate * 8 + unit][b]
  for (int i = t; i < 32 * NB; i += kThreads) {
    const int ci = i / NB, b = i - ci * NB;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * 32 + ci) * NB + b];
    gates[i] = sum;
  }
  __syncthreads();
  if (t < kUnits * NB) {
    const int u = t / NB, b = t - u * NB, j = u0 + u;
    if (b < B) {
      const float gi = sigmoidf(gates[(0 * 8 + u) * NB + b] + bias[j]);
      const float gf = sigmoidf(gates[(1 * 8 + u) * NB + b] + bias[H + j]);
      const float gg = tanhf(gates[(2 * 8 + u) * NB + b] + bias[2 * H + j]);
      const float go = sigmoidf(gates[(3 * 8 + u) * NB + b] + bias[3 * H + j]);
      const float hp = h_prev[(size_t)b * H + j], cp = c_prev[(size_t)b * H + j];
      const float c_new = gf * cp + gi * gg;
      const float h_new = go * tanhf(c_new);
      h_out[(size_t)b * H + j] = pz * hp + (1.f - pz) * h_new;
      c_out[(size_t)b * H + j] = pz * cp + (1.f - pz) * c_new;
    }
  }
  __syncthreads();
}

template <int NB, typename WT>
__global__ void __launch_bounds__(kThreads, 1) taco_step_kernel(Params a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* xs = smem;
  float* red = smem + a.xs_floats;
  const int G = gridDim.x, cta = blockIdx.x, t = threadIdx.x;
  const int B = a.B, L = a.L, P = a.P, Dc = a.Dc, H1 = a.H1, H2 = a.H2;

  // 1. PreNet layer 1: x1 = drop1(relu(y_in W1 + b1))
  int tiles = cdiv(P, kCols);
  if (cta < tiles) {
    stage<NB>(xs, 0, a.y_in, a.Dm, B);
    __syncthreads();
    for (int tile = cta; tile < tiles; tile += G)
      dense_tile<NB>(xs, a.Dm, a.pw1, P, tile * kCols, B, red, [&](int n, int b, float v) {
        v = fmaxf(v + a.pb1[n], 0.f);
        if (a.pmask1 != nullptr) v = a.pmask1[b * P + n] != 0.f ? v / a.keep : 0.f;
        a.x1[b * P + n] = v;
      });
  }
  grid.sync();

  // 2. PreNet layer 2: x_pre = drop2(relu(x1 W2 + b2))
  if (cta < tiles) {
    stage<NB>(xs, 0, a.x1, P, B);
    __syncthreads();
    for (int tile = cta; tile < tiles; tile += G)
      dense_tile<NB>(xs, P, a.pw2, P, tile * kCols, B, red, [&](int n, int b, float v) {
        v = fmaxf(v + a.pb2[n], 0.f);
        if (a.pmask2 != nullptr) v = a.pmask2[b * P + n] != 0.f ? v / a.keep : 0.f;
        a.xpre[b * P + n] = v;
      });
  }
  grid.sync();

  // 3. attention LSTM on [x_pre, ctx, h_att]
  tiles = H1 / kUnits;
  if (cta < tiles) {
    stage<NB>(xs, 0, a.xpre, P, B);
    stage<NB>(xs, P, a.ctx, Dc, B);
    stage<NB>(xs, P + Dc, a.h_att, H1, B);
    __syncthreads();
    for (int tile = cta; tile < tiles; tile += G)
      lstm_tile<NB, WT>(xs, P + Dc, static_cast<const WT*>(a.att_ih), static_cast<const WT*>(a.att_hh),
                        H1, tile * kUnits, a.att_b, a.h_att, a.c_att, a.h_att_out, a.c_att_out,
                        a.p_zoneout, B, red);
  }
  grid.sync();

  // 4. query q = h_att Wq
  tiles = cdiv(Dc, kCols);
  if (cta < tiles) {
    stage<NB>(xs, 0, a.h_att_out, H1, B);
    __syncthreads();
    for (int tile = cta; tile < tiles; tile += G)
      dense_tile<NB>(xs, H1, a.qw, Dc, tile * kCols, B, red,
                     [&](int n, int b, float v) { a.q[b * Dc + n] = v; });
  }
  grid.sync();

  // 5a. energies and stay probabilities, one warp per (b, l)
  {
    const int lane = t & 31;
    for (int item = cta * kWarps + (t >> 5); item < B * L; item += G * kWarps) {
      const int b = item / L, l = item - b * L;
      const float* m = a.memory + (size_t)item * Dc;
      const float* q = a.q + (size_t)b * Dc;
      float e = 0.f;
      for (int d = lane * 4; d < Dc; d += 128) {
        const float4 mv = __ldg(reinterpret_cast<const float4*>(m + d));
        const float4 qv = __ldcg(reinterpret_cast<const float4*>(q + d));
        e += mv.x * qv.x + mv.y * qv.y + mv.z * qv.z + mv.w * qv.w;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(kFull, e, o);
      if (lane == 0) {
        if (l == L - 1) e = 1e4f;  // sink: always stay at the last position
        const float h = e / 2.f;
        a.p[item] = (1.f + h / sqrtf(1.f + h * h)) / 2.f;
      }
    }
  }
  grid.sync();

  // 5b. new weights and context, per (b, 32 channels)
  {
    const int dt = cdiv(Dc, 32);
    float* wn = xs;  // [L]
    for (int item = cta; item < B * dt; item += G) {
      const int b = item / dt, d0 = (item - b * dt) * 32;
      const float* wb = a.w + (size_t)b * L;
      const float* pb = a.p + (size_t)b * L;
      for (int l = t; l < L; l += kThreads) {
        float v = wb[l] * __ldcg(pb + l);
        if (l > 0) v += wb[l - 1] * (1.f - __ldcg(pb + l - 1));
        v *= a.mmask[(size_t)b * L + l];
        wn[l] = v;
        if (d0 == 0) a.w_out[(size_t)b * L + l] = v;
      }
      __syncthreads();
      const int d = t & 31, ll = t >> 5;
      float acc = 0.f;
      if (d0 + d < Dc)
        for (int l = ll; l < L; l += kWarps)
          acc = fmaf(wn[l], __ldg(a.memory + ((size_t)b * L + l) * Dc + d0 + d), acc);
      red[ll * 32 + d] = acc;
      __syncthreads();
      if (t < 32 && d0 + t < Dc) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w * 32 + t];
        a.ctx_out[(size_t)b * Dc + d0 + t] = sum;
      }
      __syncthreads();
    }
  }
  grid.sync();

  // 6. decoder LSTM on [h_att, ctx, h_dec]
  tiles = H2 / kUnits;
  if (cta < tiles) {
    stage<NB>(xs, 0, a.h_att_out, H1, B);
    stage<NB>(xs, H1, a.ctx_out, Dc, B);
    stage<NB>(xs, H1 + Dc, a.h_dec, H2, B);
    __syncthreads();
    for (int tile = cta; tile < tiles; tile += G)
      lstm_tile<NB, WT>(xs, H1 + Dc, static_cast<const WT*>(a.dec_ih), static_cast<const WT*>(a.dec_hh),
                        H2, tile * kUnits, a.dec_b, a.h_dec, a.c_dec, a.h_dec_out, a.c_dec_out,
                        a.p_zoneout, B, red);
  }
  grid.sync();

  // 7. projections of [h_dec, ctx]: mel frames (leaky ReLU) and stop logits
  const int n_mel = a.r * a.Dm, mel_tiles = cdiv(n_mel, kCols);
  tiles = mel_tiles + cdiv(a.r, kCols);
  if (cta < tiles) {
    stage<NB>(xs, 0, a.h_dec_out, H2, B);
    stage<NB>(xs, H2, a.ctx_out, Dc, B);
    __syncthreads();
    for (int tile = cta; tile < tiles; tile += G) {
      if (tile < mel_tiles) {
        dense_tile<NB>(xs, H2 + Dc, a.mel_w, n_mel, tile * kCols, B, red, [&](int n, int b, float v) {
          v += a.mel_b[n];
          a.y[b * n_mel + n] = v >= 0.f ? v : 0.01f * v;
        });
      } else {
        dense_tile<NB>(xs, H2 + Dc, a.stop_w, a.r, (tile - mel_tiles) * kCols, B, red,
                       [&](int n, int b, float v) { a.s[b * a.r + n] = v + a.stop_b[n]; });
      }
    }
  }
}

template <int NB, typename WT>
cudaError_t launch(Params a, cudaStream_t stream) {
  const int k_max = std::max({a.Dm, a.P, a.P + a.Dc + a.H1, a.H1 + a.Dc + a.H2, a.H2 + a.Dc});
  a.xs_floats = (std::max(k_max * NB, a.L) + 3) / 4 * 4;
  const size_t smem = ((size_t)a.xs_floats + (size_t)(kWarps * 32 + 32) * NB) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = taco_step_kernel<NB, WT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(sms), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename WT>
cudaError_t dispatch(const Params& a, cudaStream_t s) {
  if (a.B <= 1) return launch<1, WT>(a, s);
  if (a.B <= 2) return launch<2, WT>(a, s);
  if (a.B <= 4) return launch<4, WT>(a, s);
  return launch<8, WT>(a, s);
}

}  // namespace

// One step on `stream`. ptrs: a host array of kNumPtrs device pointers in
// the order of enum Ptr (pmask1/pmask2 may be null: no PreNet dropout; the
// four LSTM matrices fp32, or bf16 when weights_bf16; everything else fp32
// and contiguous). scalars: host {p_zoneout, keep}. scratch holds
// B * (Dc + 2 P + L) floats. Requires 1 <= B <= 8, H1 and H2 multiples of 8,
// Dc a multiple of 4, and 16-byte aligned tensors. Returns the CUDA error
// (0 on success).
extern "C" int tts_taco_step_forward(const long long* ptrs, const float* scalars, int B, int L,
                                     int D_mel, int P, int Dc, int H1, int H2, int r,
                                     int weights_bf16, void* stream) {
  if (B < 1 || B > 8 || L < 1 || D_mel < 1 || P < 1 || Dc < 4 || Dc % 4 || H1 < 8 || H1 % 8 ||
      H2 < 8 || H2 % 8 || r < 1)
    return (int)cudaErrorInvalidValue;
  auto f = [&](int i) { return reinterpret_cast<float*>(ptrs[i]); };
  auto v = [&](int i) { return reinterpret_cast<const void*>(ptrs[i]); };
  Params a;
  a.y_in = f(kYIn); a.w = f(kW); a.ctx = f(kCtx); a.h_att = f(kHAtt); a.c_att = f(kCAtt);
  a.h_dec = f(kHDec); a.c_dec = f(kCDec); a.memory = f(kMemory); a.mmask = f(kMMask);
  a.pmask1 = f(kPMask1); a.pmask2 = f(kPMask2);
  a.pw1 = f(kPW1); a.pb1 = f(kPB1); a.pw2 = f(kPW2); a.pb2 = f(kPB2);
  a.att_ih = v(kAttIH); a.att_hh = v(kAttHH); a.att_b = f(kAttB); a.qw = f(kQW);
  a.dec_ih = v(kDecIH); a.dec_hh = v(kDecHH); a.dec_b = f(kDecB);
  a.mel_w = f(kMelW); a.mel_b = f(kMelB); a.stop_w = f(kStopW); a.stop_b = f(kStopB);
  a.y = f(kYOut); a.s = f(kSOut); a.w_out = f(kWOut); a.ctx_out = f(kCtxOut);
  a.h_att_out = f(kHAttOut); a.c_att_out = f(kCAttOut); a.h_dec_out = f(kHDecOut);
  a.c_dec_out = f(kCDecOut);
  float* scratch = f(kScratch);
  a.q = scratch;
  a.x1 = a.q + (size_t)B * Dc;
  a.xpre = a.x1 + (size_t)B * P;
  a.p = a.xpre + (size_t)B * P;
  a.B = B; a.L = L; a.Dm = D_mel; a.P = P; a.Dc = Dc; a.H1 = H1; a.H2 = H2; a.r = r;
  a.xs_floats = 0;
  a.p_zoneout = scalars[0];
  a.keep = scalars[1];
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(weights_bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s));
}
