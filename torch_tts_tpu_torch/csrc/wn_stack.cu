// Fused WaveNet (WN) layer group: the forward (L gated layers on a time
// tile held in shared memory) and, below it, the backward.
//
// Replaces the TPU kernel torch_tts_tpu/kernels/wn_stack.py (wn_group ->
// _wn_group_pallas -> _wn_fwd_kernel). Contract of the Python wrapper
// (torch_tts_tpu_torch/kernels/wn_stack.py): x [B, T, H], mask [B, T, 1],
// gl [B, L, 2H] or null, w_in [L, k, H, 2H], b_in [L, 2H], w_rs [L, H, 2H],
// b_rs [L, 2H] (final layer's residual half zero), all fp32 ->
// x_out [B, T, H] and skip * mask [B, T, H]. Per layer:
//   x_in = conv_k(x) + b_in + gl;  acts = tanh(x_in[:H]) * sigmoid(x_in[H:])
//   rs = acts @ w_rs + b_rs;  x = (x + rs[:H]) * mask;  skip += rs[H:]
//
// Bound on the H100: fp32 FMA issue (about 3.6 GFLOP per flow at B=1,
// 1024 frames, H=192, k=5, L=4), and at B=1 the grid: 1024 frames in
// 16-frame tiles is still only 64 CTAs for 132 SMs. The weights (about
// 7 MB for four layers) stay in L2.
//
// Design:
// - A CTA owns T0 output frames and loads a window of T0 + 2*L*(k-1)/2
//   rows of x and the mask; all L layers run on it, and each layer
//   computes only the rows that later layers still read, so the computed
//   range shrinks by (k-1)/2 per side per layer.
// - Shared memory: x [W, H + 4], acts [W, H + 4], skip [T0, H], mask [W]. The
//   conv's x_in never exists as a whole: each thread computes the tanh and
//   sigmoid halves of the same 4 channels and writes the gated product.
// - The 1x1 res/skip product updates x in place (each element is written
//   by the thread that reads it) and accumulates skip on the tile's own
//   rows only.
// - Register tiling: each thread owns kTM rows x 4 channels in both halves;
//   a warp owns 16 channels and 8 row groups, so each weight is read by one
//   warp per pass. Rows of x and acts are padded to H + 4 floats so the 8
//   rows a warp reads at once fall in distinct banks.
// - Window positions outside [0, T) load as zero with mask 0, which
//   reproduces the reference's zero padding.

#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kTM = 4;     // rows per thread per pass
constexpr int kNRG = 8;    // row groups
constexpr int kMaxTaps = 15;
constexpr int kPad = 4;    // floats of padding per shared-memory row of x and acts

template <int H>
__host__ __device__ constexpr int wn_threads() { return (H / 4) * kNRG; }

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// SAVE (the training forward) also writes each layer's input and
// pre-activation on the tile's own rows; a template flag, so the inference
// variant compiles without those stores.
template <int H, bool SAVE>
__global__ void __launch_bounds__((H / 4) * kNRG)
wn_group_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                const float* __restrict__ gl, const float* __restrict__ w_in,
                const float* __restrict__ b_in, const float* __restrict__ w_rs,
                const float* __restrict__ b_rs, float* __restrict__ x_out,
                float* __restrict__ skip_out, float* __restrict__ save_x,
                float* __restrict__ save_xin, int T, int L, int k, int T0) {
  constexpr int NT = wn_threads<H>();
  constexpr int NCG = H / 4;
  constexpr int H4 = H / 4;
  constexpr int ROWS = kNRG * kTM;
  constexpr int H2 = 2 * H;
  constexpr int HP = H + kPad;
  constexpr int HP4 = HP / 4;
  const int p = (k - 1) / 2;
  const int halo = L * p;
  const int W = T0 + 2 * halo;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int win_start = tile * T0 - halo;

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [W, HP]
  float* acts = xs + W * HP;                    // [W, HP]
  float* skip = acts + W * HP;                  // [T0, H]
  float* ms = skip + T0 * H;                    // [W]

  const float* xbat = x + (size_t)b * T * H;
  for (int i = threadIdx.x; i < W * H4; i += NT) {
    const int r = i / H4;
    const int pos = win_start + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos >= 0 && pos < T)
      v = __ldg(reinterpret_cast<const float4*>(xbat + (size_t)pos * H) + i % H4);
    smem4[r * HP4 + i % H4] = v;
  }
  for (int i = threadIdx.x; i < T0 * H4; i += NT)
    reinterpret_cast<float4*>(skip)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = threadIdx.x; r < W; r += NT) {
    const int pos = win_start + r;
    ms[r] = (pos >= 0 && pos < T) ? __ldg(mask + (size_t)b * T + pos) : 0.f;
  }
  __syncthreads();

  // a warp owns 16 channels (4 groups of 4, lane & 3) in both halves and
  // the 8 row groups (lane >> 2), so each weight is read by one warp
  static_assert(NT / 32 == NCG / 4, "one warp per 16 channels");
  const int lane = threadIdx.x & 31;
  const int c0 = ((threadIdx.x >> 5) * 4 + (lane & 3)) * 4;
  const int rg = lane >> 2;

  const int B = gridDim.y;
  for (int l = 0; l < L; ++l) {
    const int lo = (l + 1) * p;
    const int hi = W - (l + 1) * p;

    // training forward: keep the layer's input on the tile's own rows
    if (SAVE) {
      float* sx = save_x + ((size_t)l * B + b) * T * H;
      for (int i = threadIdx.x; i < T0 * H4; i += NT) {
        const int pos = tile * T0 + i / H4;
        if (pos < T)
          reinterpret_cast<float4*>(sx + (size_t)pos * H)[i % H4] =
              smem4[(halo + i / H4) * HP4 + i % H4];
      }
    }

    // --- dilated-1 conv + bias + conditioning, gated into acts
    {
      const float4 ba = __ldg(reinterpret_cast<const float4*>(b_in + l * H2 + c0));
      const float4 bb = __ldg(reinterpret_cast<const float4*>(b_in + l * H2 + H + c0));
      float4 ga = make_float4(0.f, 0.f, 0.f, 0.f), gb = ga;
      if (gl != nullptr) {
        const float* g = gl + ((size_t)b * L + l) * H2;
        ga = __ldg(reinterpret_cast<const float4*>(g + c0));
        gb = __ldg(reinterpret_cast<const float4*>(g + H + c0));
      }
      for (int base = lo; base < hi; base += ROWS) {
        int rows[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) rows[i] = min(base + rg + i * kNRG, hi - 1);
        float aa[kTM][4], ab[kTM][4];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) { aa[i][j] = 0.f; ab[i][j] = 0.f; }

        for (int t = 0; t < k; ++t) {
          const float* wt = w_in + ((size_t)(l * k + t) * H) * H2 + c0;
          int idx[kTM];
#pragma unroll
          for (int i = 0; i < kTM; ++i) idx[i] = (rows[i] + t - p) * HP;
#pragma unroll 2
          for (int ci = 0; ci < H; ci += 4) {
            float4 wa[4], wb[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              wa[q] = __ldg(reinterpret_cast<const float4*>(wt + (ci + q) * H2));
              wb[q] = __ldg(reinterpret_cast<const float4*>(wt + (ci + q) * H2 + H));
            }
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
              const float4 a = *reinterpret_cast<const float4*>(xs + idx[i] + ci);
              const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                aa[i][0] = fmaf(av[q], wa[q].x, aa[i][0]);
                aa[i][1] = fmaf(av[q], wa[q].y, aa[i][1]);
                aa[i][2] = fmaf(av[q], wa[q].z, aa[i][2]);
                aa[i][3] = fmaf(av[q], wa[q].w, aa[i][3]);
                ab[i][0] = fmaf(av[q], wb[q].x, ab[i][0]);
                ab[i][1] = fmaf(av[q], wb[q].y, ab[i][1]);
                ab[i][2] = fmaf(av[q], wb[q].z, ab[i][2]);
                ab[i][3] = fmaf(av[q], wb[q].w, ab[i][3]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int r = base + rg + i * kNRG;
          if (r >= hi) continue;
          float4 xa, xb, o;
          xa.x = aa[i][0] + ba.x + ga.x; xb.x = ab[i][0] + bb.x + gb.x;
          xa.y = aa[i][1] + ba.y + ga.y; xb.y = ab[i][1] + bb.y + gb.y;
          xa.z = aa[i][2] + ba.z + ga.z; xb.z = ab[i][2] + bb.z + gb.z;
          xa.w = aa[i][3] + ba.w + ga.w; xb.w = ab[i][3] + bb.w + gb.w;
          o.x = tanhf(xa.x) * sigmoidf_(xb.x);
          o.y = tanhf(xa.y) * sigmoidf_(xb.y);
          o.z = tanhf(xa.z) * sigmoidf_(xb.z);
          o.w = tanhf(xa.w) * sigmoidf_(xb.w);
          *reinterpret_cast<float4*>(acts + r * HP + c0) = o;
          const int pos = win_start + r;
          if (SAVE && r >= halo && r < halo + T0 && pos < T) {
            float* si = save_xin + (((size_t)l * B + b) * T + pos) * H2;
            *reinterpret_cast<float4*>(si + c0) = xa;
            *reinterpret_cast<float4*>(si + H + c0) = xb;
          }
        }
      }
    }
    __syncthreads();

    // --- 1x1 res/skip: x = (x + rs[:H]) * mask, skip += rs[H:]
    {
      const float4 br = __ldg(reinterpret_cast<const float4*>(b_rs + l * H2 + c0));
      const float4 bs = __ldg(reinterpret_cast<const float4*>(b_rs + l * H2 + H + c0));
      const float* wl = w_rs + (size_t)l * H * H2 + c0;
      for (int base = lo; base < hi; base += ROWS) {
        int rows[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) rows[i] = min(base + rg + i * kNRG, hi - 1);
        float ar[kTM][4], as[kTM][4];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) { ar[i][j] = 0.f; as[i][j] = 0.f; }
#pragma unroll 2
        for (int ci = 0; ci < H; ci += 4) {
          float4 wr[4], ws[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wr[q] = __ldg(reinterpret_cast<const float4*>(wl + (ci + q) * H2));
            ws[q] = __ldg(reinterpret_cast<const float4*>(wl + (ci + q) * H2 + H));
          }
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(acts + rows[i] * HP + ci);
            const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              ar[i][0] = fmaf(av[q], wr[q].x, ar[i][0]);
              ar[i][1] = fmaf(av[q], wr[q].y, ar[i][1]);
              ar[i][2] = fmaf(av[q], wr[q].z, ar[i][2]);
              ar[i][3] = fmaf(av[q], wr[q].w, ar[i][3]);
              as[i][0] = fmaf(av[q], ws[q].x, as[i][0]);
              as[i][1] = fmaf(av[q], ws[q].y, as[i][1]);
              as[i][2] = fmaf(av[q], ws[q].z, as[i][2]);
              as[i][3] = fmaf(av[q], ws[q].w, as[i][3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int r = base + rg + i * kNRG;
          if (r >= hi) continue;
          const float m = ms[r];
          float4* xr = reinterpret_cast<float4*>(xs + r * HP + c0);
          float4 xv = *xr;
          xv.x = (xv.x + (ar[i][0] + br.x)) * m;
          xv.y = (xv.y + (ar[i][1] + br.y)) * m;
          xv.z = (xv.z + (ar[i][2] + br.z)) * m;
          xv.w = (xv.w + (ar[i][3] + br.w)) * m;
          *xr = xv;
          if (r >= halo && r < halo + T0) {
            float4* sr = reinterpret_cast<float4*>(skip + (r - halo) * H + c0);
            float4 sv = *sr;
            sv.x += as[i][0] + bs.x;
            sv.y += as[i][1] + bs.y;
            sv.z += as[i][2] + bs.z;
            sv.w += as[i][3] + bs.w;
            *sr = sv;
          }
        }
      }
    }
    __syncthreads();
  }

  float* xo = x_out + (size_t)b * T * H;
  float* so = skip_out + (size_t)b * T * H;
  for (int i = threadIdx.x; i < T0 * H4; i += NT) {
    const int r = i / H4;
    const int pos = tile * T0 + r;
    if (pos >= T) continue;
    const float m = ms[halo + r];
    const float4 xv = smem4[(halo + r) * HP4 + i % H4];
    float4 sv = reinterpret_cast<const float4*>(skip)[i];
    sv.x *= m; sv.y *= m; sv.z *= m; sv.w *= m;
    reinterpret_cast<float4*>(xo + (size_t)pos * H)[i % H4] = xv;
    reinterpret_cast<float4*>(so + (size_t)pos * H)[i % H4] = sv;
  }
}

template <int H>
cudaError_t launch_group(const float* x, const float* mask, const float* gl,
                         const float* w_in, const float* b_in, const float* w_rs,
                         const float* b_rs, float* x_out, float* skip_out, float* save_x,
                         float* save_xin, int B, int T, int L, int k, int T0,
                         cudaStream_t stream) {
  const int W = T0 + 2 * L * ((k - 1) / 2);
  const size_t smem = ((size_t)2 * W * (H + kPad) + (size_t)T0 * H + W) * sizeof(float);
  const auto kernel = save_x != nullptr ? wn_group_kernel<H, true> : wn_group_kernel<H, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + T0 - 1) / T0, B);
  kernel<<<grid, wn_threads<H>(), smem, stream>>>(x, mask, gl, w_in, b_in, w_rs, b_rs, x_out,
                                                  skip_out, save_x, save_xin, T, L, k, T0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward of one group (replaces torch_tts_tpu/kernels/wn_stack.py
// _wn_group_pallas_bwd -> _wn_bwd_kernel).
//
// The TPU kernel rematerialises the group's forward per tile with a 4L-frame
// halo and keeps every layer's input and pre-activation in VMEM. On Hopper
// those are about 9 KB per frame at H=192, L=4, more than a useful tile
// fits in 227 KB of shared memory. So the training forward (the kernel
// above, with save_x / save_xin) writes each layer's input x_i [B, T, H]
// and pre-activation x_in [B, T, 2H] to HBM (74 MB per group at B=8,
// T=1000), and the backward walks the layers in reverse over the whole
// sequence. Per layer i, with r = b*T + t a frame and d_x the gradient
// arriving from layer i + 1 (d_xo for the last layer):
//   d_rs   = [d_x * m, d_skip * m]
//   d_acts = d_rs @ w_rs[i]^T;  t = tanh(x_in[:H]), s = sigmoid(x_in[H:])
//   d_xin  = [d_acts * s * (1 - t^2), d_acts * t * s * (1 - s)]   (ActsGrad)
//   d_x    = d_rs[:, :H] + sum_tau d_xin[r + p - tau] @ w_in[i, tau]^T
//                                                                (InputGrad)
//   d_w_in[i, tau] = sum_r x_i[r + tau - p]^T d_xin[r]          (WeightInGrad)
//   d_w_rs[i]      = sum_r acts[r]^T d_rs[r]                     (WeightRsGrad)
//   d_b_in[i] = sum_r d_xin[r], d_gl[b, i] = sum_t d_xin[b, t], d_b_rs[i] = sum_r d_rs[r]
// with zeros outside [0, T) for the shifted reads. d_rs never exists in
// memory: the products that read it form it from d_x, d_skip and the mask
// as they load.
//
// Work at B=8, T=1000, H=192, k=5, L=4: about 57 GFLOP per group, bound by
// operations: 0.343 ms at 3xTF32's 165 TFLOP/s (0.85 ms at fp32's 67).
// Design:
// - Every product is a tiled GEMM on Hopper's warpgroup tensor cores,
//   wgmma tf32 in 3xTF32 (wgmma_tf32.cuh, the route of mrf_fused.cu): a
//   CTA of two warpgroups owns 128 rows x 64 columns and walks K in
//   32-deep chunks; two CTAs share an SM, so one's loads overlap the
//   other's products.
// - A comes from registers (wgmma's RS form, as mrf_fused.cu): each thread
//   loads its fragment rows through per-row descriptors made once a tile,
//   which write in the tap shift, the batch-item bounds, the transposes of
//   the weight products (K = frames is their strided axis), the mask and
//   the rows of ones. B is staged K-major into a two-slot shared-memory
//   ring, split into hi and lo tiles as it is stored (the weight products'
//   frame-major B transposed on that store); chunk c + 1 is loaded while
//   the products of chunk c run. (Staging A in shared memory too, wgmma's
//   SS form, was slower on the card: its staging set the time.)
// - The weight products reduce over B*T frames. Each batch item is one
//   K-split: its partial sums go to a [B, M, N] buffer, and a second pass
//   adds the B partials in a fixed order. A row of ones in A turns the same
//   product into the bias sums, and its per-item partial is d_gl. No
//   atomics: the result has the same bits on every run.
// - Launches per layer: ActsGrad; InputGrad, WeightInGrad and
//   WeightRsGrad together (one grid, CTAs assigned to problems by index);
//   the two reductions together. 3 per layer, 12 per group of 4 layers.

using namespace tts_wgmma;

constexpr int kBwdThreads = 256;  // two warpgroups
constexpr int kBM = 128;          // rows a CTA, 64 a warpgroup
constexpr int kBN = 64;           // columns a CTA
constexpr int kBK = 32;           // K of a staged chunk

// Each problem gives a per-row descriptor (row, for A's rows m of item z,
// computed once a tile), A(m, k0 + off) through it (a; k0 a chunk start,
// so per-chunk index math is shared by a thread's loads), B(k..k+3, n)
// (b4), zero outside [0, M) x [0, K), and the epilogue store(z, m, n, v).

// d_acts = d_rs @ w_rs^T over frames r; the epilogue applies the gate
// derivative and writes d_xin [R, 2H] and acts [R, H].
struct ActsGrad {
  int M, N, K, items;  // R, H, 2H, 1
  const float* d_x;    // [R, H], from the layer above
  const float* d_sk;   // [R, H]
  const float* mask;   // [R]
  const float* w_rs;   // [H, 2H], this layer
  const float* x_in;   // [R, 2H], this layer
  float* d_xin;
  float* acts;
  struct Row { const float* dx; const float* ds; float m; };
  __device__ Row row(int, int r) const {
    const int rr = r < M ? r : 0;
    return {d_x + (size_t)rr * N, d_sk + (size_t)rr * N, r < M ? __ldg(mask + rr) : 0.f};
  }
  __device__ float a(const Row& w, int k0, int off) const {  // d_rs[r, k]
    const int k = k0 + off;
    return (k0 < N ? __ldg(w.dx + k) : __ldg(w.ds + k - N)) * w.m;  // a chunk lies in one half
  }
  __device__ float4 b4(int, int k, int n) const {  // w_rs[n, k..k+3]
    return __ldg(reinterpret_cast<const float4*>(w_rs + (size_t)n * K + k));
  }
  __device__ void store(int, int m, int n, float d_act) const {
    const float* xr = x_in + (size_t)m * K;
    const float t = tanhf(xr[n]);
    const float s = sigmoidf_(xr[N + n]);
    float* dr = d_xin + (size_t)m * K;
    dr[n] = d_act * s * (1.f - t * t);
    dr[N + n] = d_act * t * s * (1.f - s);
    acts[(size_t)m * N + n] = t * s;
  }
};

// d_x[r] = d_rs[r, :H] + sum_{tau, j} d_xin[r + p - tau, j] * w_in[tau, c, j]
// (the transposed k-tap conv), zero where t + p - tau leaves [0, T).
struct InputGrad {
  int M, N, K, items;  // R, H, k*2H, 1
  int T, pad, H2;
  const float* d_xin;  // [R, 2H]
  const float* w_in;   // [k, H, 2H], this layer
  const float* d_x;    // [R, H], from the layer above
  const float* mask;   // [R]
  float* d_x_out;      // [R, H]
  struct Row { int r, t; };
  __device__ Row row(int, int r) const { return {r < M ? r : -1, r % T}; }
  __device__ float a(const Row& w, int k0, int off) const {  // d_xin[r + p - tau, j]
    const int tau = k0 / H2, j = k0 - tau * H2 + off;  // a chunk lies in one tap
    const int st = w.t + pad - tau;
    return (w.r >= 0 && st >= 0 && st < T)
               ? __ldg(d_xin + (size_t)(w.r + pad - tau) * H2 + j) : 0.f;
  }
  __device__ float4 b4(int, int k, int n) const {  // w_in[tau, n, j..j+3]
    const int tau = k / H2, j = k - tau * H2;
    return __ldg(reinterpret_cast<const float4*>(w_in + ((size_t)tau * N + n) * H2 + j));
  }
  __device__ void store(int, int m, int n, float v) const {
    d_x_out[(size_t)m * N + n] = __ldg(d_x + (size_t)m * N + n) * __ldg(mask + m) + v;
  }
};

// Per batch item z: part[z][(tau, ci), j] = sum_t x_i[z, t + tau - p, ci] d_xin[z, t, j];
// row k*H (a row of ones) gives sum_t d_xin[z, t, j].
struct WeightInGrad {
  int M, N, K, items;  // k*H + 1, 2H, T, B
  int H, pad;
  const float* x_i;    // [B, T, H], this layer
  const float* d_xin;  // [B, T, 2H]
  float* part;         // [B, M, N]
  struct Row { const float* xb; int shift, kind; };  // kind: 0 x, 1 ones, 2 none
  __device__ Row row(int z, int m) const {
    const int km = M - 1, tau = m < km ? m / H : 0;
    return {x_i + (size_t)z * K * H + (m < km ? m - tau * H : 0), tau - pad,
            m < km ? 0 : (m == km ? 1 : 2)};
  }
  __device__ float a(const Row& w, int k0, int off) const {  // x_i[z, t + tau - p, ci]
    const int t = k0 + off, st = t + w.shift;
    if (t >= K || w.kind == 2) return 0.f;
    if (w.kind == 1) return 1.f;
    return (st >= 0 && st < K) ? __ldg(w.xb + (size_t)st * H) : 0.f;
  }
  __device__ float4 b4(int z, int t, int n) const {  // d_xin[z, t..t+3, n]
    const float* d = d_xin + ((size_t)z * K + t) * N + n;
    return make_float4(t < K ? __ldg(d) : 0.f, t + 1 < K ? __ldg(d + N) : 0.f,
                       t + 2 < K ? __ldg(d + 2 * N) : 0.f, t + 3 < K ? __ldg(d + 3 * N) : 0.f);
  }
  __device__ void store(int z, int m, int n, float v) const {
    part[((size_t)z * M + m) * N + n] = v;
  }
};

// Per batch item z: part[z][c, j] = sum_t acts[z, t, c] d_rs[z, t, j]; row H
// (ones) gives sum_t d_rs[z, t, j].
struct WeightRsGrad {
  int M, N, K, items;  // H + 1, 2H, T, B
  const float* acts;   // [B, T, H]
  const float* d_x;    // [B, T, H], from the layer above
  const float* d_sk;   // [B, T, H]
  const float* mask;   // [B, T]
  float* part;         // [B, M, N]
  struct Row { const float* ab; int kind; };
  __device__ Row row(int z, int m) const {
    const int H = M - 1;
    return {acts + (size_t)z * K * H + (m < H ? m : 0), m < H ? 0 : (m == H ? 1 : 2)};
  }
  __device__ float a(const Row& w, int k0, int off) const {  // acts[z, t, c]
    const int t = k0 + off;
    if (t >= K || w.kind == 2) return 0.f;
    return w.kind == 1 ? 1.f : __ldg(w.ab + (size_t)t * (M - 1));
  }
  __device__ float4 b4(int z, int t, int n) const {  // d_rs[z, t..t+3, n]
    const int H = M - 1;
    const float* src = n < H ? d_x : d_sk;
    const int c = n < H ? n : n - H;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t r = (size_t)z * K + t + q;
      v[q] = t + q < K ? __ldg(src + r * H + c) * __ldg(mask + r) : 0.f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ void store(int z, int m, int n, float v) const {
    part[((size_t)z * M + m) * N + n] = v;
  }
};

template <class P>
__host__ __device__ constexpr int tiles_m(const P& p) { return (p.M + kBM - 1) / kBM; }
template <class P>
__host__ __device__ constexpr int tiles_of(const P& p) {
  return p.items * tiles_m(p) * ((p.N + kBN - 1) / kBN);
}

// One 128 x 64 output tile of problem p for batch item z in 3xTF32. A is in
// registers (wgmma's RS form): each thread loads its fragment rows through
// the problem's row descriptors, so any shift, transpose or row of ones is
// free. B is staged K-major into a two-slot shared-memory ring, split into
// hi and lo tiles as it is stored: chunk c + 1's A and B are loaded, and
// its B stored, while the products of chunk c run.
template <class P>
__device__ __forceinline__ void run_tile(const P& p, int z, int mt, int nt, float* ring) {
  constexpr int NR = kBN / 2;                      // accumulator registers a thread
  constexpr int B_TILE = kBK * kBN;                // floats of one hi or lo tile
  constexpr int BP = kBN * kBK / 4 / kBwdThreads;  // B float4 groups a thread
  static_assert(BP * kBwdThreads * 4 == B_TILE, "chunk copy");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = mt * kBM + (warp >> 2) * 64 + (warp & 3) * 16;  // this warp's 16 rows
  const int n0 = nt * kBN;
  const int nk = (p.K + kBK - 1) / kBK;
  const typename P::Row r0 = p.row(z, m0 + g), r1 = p.row(z, m0 + g + 8);

  float an[kBK / 8][4];  // A fragments of the next chunk, fp32
  float4 bv[BP];  // B of the next chunk: group q is (k4, n) = ((q >> 3) & 7, 8 (q >> 6) + (q & 7))
  auto fetch = [&](int c) {
    const int k0 = c * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      an[kk][0] = p.a(r0, k0, 8 * kk + t4);
      an[kk][1] = p.a(r1, k0, 8 * kk + t4);
      an[kk][2] = p.a(r0, k0, 8 * kk + t4 + 4);
      an[kk][3] = p.a(r1, k0, 8 * kk + t4 + 4);
    }
#pragma unroll
    for (int i = 0; i < BP; ++i) {
      const int q = tid + i * kBwdThreads;
      bv[i] = p.b4(z, k0 + 4 * ((q >> 3) & 7), n0 + ((q >> 6) << 3) + (q & 7));
    }
  };
  auto stage_b = [&](float* hi) {  // 8 threads store 128 contiguous bytes
#pragma unroll
    for (int i = 0; i < BP; ++i) {
      const int q = tid + i * kBwdThreads;
      const int o = kmajor_offset<kBN>(4 * ((q >> 3) & 7), ((q >> 6) << 3) + (q & 7));
      uint32_t h[4], l[4];
      split_tf32(bv[i].x, h[0], l[0]);
      split_tf32(bv[i].y, h[1], l[1]);
      split_tf32(bv[i].z, h[2], l[2]);
      split_tf32(bv[i].w, h[3], l[3]);
      *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(hi + B_TILE + o) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    fence_async_shared();
  };
  uint32_t ah[kBK / 8][4], al[kBK / 8][4];
  auto split_a = [&] {
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(an[kk][e], ah[kk][e], al[kk][e]);
  };

  float acc[NR];
#pragma unroll
  for (int e = 0; e < NR; ++e) acc[e] = 0.f;
  fetch(0);
  stage_b(ring);
  split_a();
  __syncthreads();
  for (int c = 0; c < nk; ++c) {
    const float* b_hi = ring + (c & 1) * 2 * B_TILE;
    const float* b_lo = b_hi + B_TILE;
#pragma unroll
    for (int e = 0; e < NR; ++e) keep(acc[e]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint64_t dh = kmajor_desc<kBN>(b_hi, kk), dl = kmajor_desc<kBN>(b_lo, kk);
      wgmma_tf32<kBN>(acc, al[kk], dh);
      wgmma_tf32<kBN>(acc, ah[kk], dl);
      wgmma_tf32<kBN>(acc, ah[kk], dh);
    }
    wgmma_commit();
    if (c + 1 < nk) {  // the next chunk, while the products run
      fetch(c + 1);
      stage_b(ring + ((c + 1) & 1) * 2 * B_TILE);
    }
    wgmma_wait0();
#pragma unroll
    for (int e = 0; e < NR; ++e) keep(acc[e]);
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) { keep(ah[kk][e]); keep(al[kk][e]); }
    if (c + 1 < nk) split_a();  // the products no longer read ah / al
    __syncthreads();            // slot c & 1 is free; chunk c + 1's B is in place
  }
  // acc[4 j + {0, 1}] at (g, 8 j + 2 t4 + {0, 1}); acc[4 j + {2, 3}] at (g + 8, ...)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t4;
      if (n < p.N) p.store(z, m, n, acc[4 * j + 2 * h]);
      if (n + 1 < p.N) p.store(z, m, n + 1, acc[4 * j + 2 * h + 1]);
    }
  }
}

// runs blockIdx.x's tile if it falls in p's range, else moves the index past it
template <class P>
__device__ __forceinline__ bool run_if_mine(const P& p, int& bid, float* ring) {
  const int n = tiles_of(p);
  if (bid >= n) {
    bid -= n;
    return false;
  }
  const int tn = (p.N + kBN - 1) / kBN, per_item = tiles_m(p) * tn;
  const int z = bid / per_item, rem = bid - z * per_item;
  run_tile(p, z, rem / tn, rem % tn, ring);
  return true;
}

// One grid over several problems: CTA i runs the i-th tile in order.
template <class... Ps>
__global__ void __launch_bounds__(kBwdThreads, 2) tiles_kernel(Ps... ps) {
  extern __shared__ __align__(128) float ring[];
  int bid = blockIdx.x;
  (run_if_mine(ps, bid, ring) || ...);
}

template <class... Ps>
cudaError_t launch_tiles(cudaStream_t stream, const Ps&... ps) {
  const size_t smem = (size_t)4 * kBN * kBK * sizeof(float);  // two slots of B's hi + lo
  const auto kernel = tiles_kernel<Ps...>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (tiles_of(ps) + ...);
  kernel<<<grid, kBwdThreads, smem, stream>>>(ps...);
  return cudaGetLastError();
}

// out_w[m, n] = sum_z part[z, m, n] for m < M - 1 (z in order); row M - 1
// goes to out_b, and, when d_gl is given, each item's own row to
// d_gl[z, layer]. blockIdx.y picks the reduction: 0 of WeightInGrad, 1 of
// WeightRsGrad.
struct Reduce {
  const float* part;
  int M;
  float* out_w;
  float* out_b;
  float* d_gl;
};

__global__ void reduce_parts_kernel(const Reduce ra, const Reduce rb, int Z, int N, int layer,
                                    int L) {
  const Reduce& r = blockIdx.y == 0 ? ra : rb;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= r.M * N) return;
  float s = 0.f;
  for (int z = 0; z < Z; ++z) s += r.part[(size_t)z * r.M * N + idx];
  const int m = idx / N, n = idx - (idx / N) * N;
  if (m < r.M - 1) {
    r.out_w[idx] = s;
  } else {
    r.out_b[n] = s;
    if (r.d_gl != nullptr)
      for (int z = 0; z < Z; ++z)
        r.d_gl[((size_t)z * L + layer) * N + n] = r.part[(size_t)z * r.M * N + idx];
  }
}

}  // namespace

// One WN layer group on `stream`; gl may be null (no conditioning). With
// save_x / save_xin (both or neither) it also writes each layer's input
// [L, B, T, H] and pre-activation [L, B, T, 2H] for the backward. Returns
// the launch's CUDA error (0 on success).
extern "C" int tts_wn_group_forward(const float* x, const float* mask, const float* gl,
                                    const float* w_in, const float* b_in,
                                    const float* w_rs, const float* b_rs, float* x_out,
                                    float* skip_out, float* save_x, float* save_xin, int B,
                                    int T, int H, int L, int k, int tile, void* stream) {
  if (B < 1 || T < 1 || L < 1 || tile < 1 || k < 1 || k % 2 == 0 || k > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  if ((save_x == nullptr) != (save_xin == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // every shipped config has hidden_channels 192
  if (H != 192) return (int)cudaErrorInvalidValue;
  return (int)launch_group<192>(x, mask, gl, w_in, b_in, w_rs, b_rs, x_out, skip_out, save_x,
                                save_xin, B, T, L, k, tile, s);
}

// Backward of one group on `stream`, from the forward's save_x / save_xin
// and the cotangents d_xo, d_sk [B, T, H]: writes d_x [B, T, H], d_gl
// [B, L, 2H] (skipped when null), d_w_in [L, k, H, 2H], d_b_in [L, 2H],
// d_w_rs [L, H, 2H], d_b_rs [L, 2H]. `work` holds
// B*T*4H + B*(k*H + 1)*2H + B*(H + 1)*2H floats (the wrapper's
// `backward_workspace`). Returns the first CUDA error (0 on success).
extern "C" int tts_wn_group_backward(const float* mask, const float* w_in, const float* w_rs,
                                     const float* save_x, const float* save_xin,
                                     const float* d_xo, const float* d_sk, float* d_x,
                                     float* d_gl, float* d_w_in, float* d_b_in, float* d_w_rs,
                                     float* d_b_rs, float* work, int B, int T, int H, int L,
                                     int k, void* stream) {
  if (B < 1 || T < 1 || L < 1 || k < 1 || k % 2 == 0 || k > kMaxTaps || H != 192)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int R = B * T, H2 = 2 * H, pad = (k - 1) / 2;
  const int Ma = k * H + 1, Mb = H + 1;
  float* dx_tmp = work;                          // [R, H]
  float* d_xin = dx_tmp + (size_t)R * H;         // [R, 2H]
  float* acts = d_xin + (size_t)R * H2;          // [R, H]
  float* part_a = acts + (size_t)R * H;          // [B, Ma, 2H]
  float* part_b = part_a + (size_t)B * Ma * H2;  // [B, Mb, 2H]

  const float* cur = d_xo;
  for (int i = L - 1; i >= 0; --i) {
    float* nxt = (i % 2 == 0) ? d_x : dx_tmp;  // layer 0 lands in d_x
    const float* xi = save_x + (size_t)i * R * H;
    const float* xin = save_xin + (size_t)i * R * H2;
    const float* w_in_i = w_in + (size_t)i * k * H * H2;
    const float* w_rs_i = w_rs + (size_t)i * H * H2;
    cudaError_t err;

    const ActsGrad pa{R, H, H2, 1, cur, d_sk, mask, w_rs_i, xin, d_xin, acts};
    if ((err = launch_tiles(s, pa)) != cudaSuccess) return (int)err;

    const InputGrad pi{R, H, k * H2, 1, T, pad, H2, d_xin, w_in_i, cur, mask, nxt};
    const WeightInGrad pw{Ma, H2, T, B, H, pad, xi, d_xin, part_a};
    const WeightRsGrad pr{Mb, H2, T, B, acts, cur, d_sk, mask, part_b};
    if ((err = launch_tiles(s, pi, pw, pr)) != cudaSuccess) return (int)err;

    const Reduce ra{part_a, Ma, d_w_in + (size_t)i * k * H * H2, d_b_in + (size_t)i * H2, d_gl};
    const Reduce rb{part_b, Mb, d_w_rs + (size_t)i * H * H2, d_b_rs + (size_t)i * H2, nullptr};
    reduce_parts_kernel<<<dim3((Ma * H2 + 255) / 256, 2), 256, 0, s>>>(ra, rb, B, H2, i, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    cur = nxt;
  }
  return 0;
}
