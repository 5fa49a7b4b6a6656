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
// sequence. Per layer i, with r = b*T + t a frame:
//   d_rs   = [d_x * m, d_skip * m]                               (prep)
//   d_acts = d_rs @ w_rs[i]^T;  t = tanh(x_in[:H]), s = sigmoid(x_in[H:])
//   d_xin  = [d_acts * s * (1 - t^2), d_acts * t * s * (1 - s)]   (ActsGrad)
//   d_x    = d_rs[:, :H] + sum_tau d_xin[r + p - tau] @ w_in[i, tau]^T
//                                                                (InputGrad)
//   d_w_in[i, tau] = sum_r x_i[r + tau - p]^T d_xin[r]          (WeightInGrad)
//   d_w_rs[i]      = sum_r acts[r]^T d_rs[r]                     (WeightRsGrad)
//   d_b_in[i] = sum_r d_xin[r], d_gl[b, i] = sum_t d_xin[b, t], d_b_rs[i] = sum_r d_rs[r]
// with zeros outside [0, T) for the shifted reads.
//
// All four products run through one fp32 SIMT tiled-product kernel
// (gemm_kernel): 128 x 64 output tiles, 16-deep K chunks double-buffered
// in shared memory, 8 x 4 outputs per thread. A "problem" struct supplies
// the operand loads (with the shift, the transposes and the zero padding
// written into them) and the epilogue. Which operand dimension is
// contiguous in memory picks the thread-to-element map of the loads, so
// neighbouring threads read neighbouring addresses.
//
// The weight products reduce over B*T frames. Each batch item is one
// K-split (blockIdx.z): its partial sums go to a [B, M, N] buffer, and a
// second pass adds the B partials in a fixed order. A row of ones appended
// to the left operand turns the same product into the bias sums, and its
// per-item partial is d_gl. No atomics: the result has the same bits on
// every run.
//
// Work at B=8, T=1000, H=192, k=5, L=4: about 57 GFLOP per group, 0.85 ms
// at the H100's 67 TFLOP/s fp32 peak; the products are bound by FMA issue.

constexpr int kBM = 128, kBN = 64, kBK = 16, kGemmThreads = 256, kGTM = 8, kGTN = 4;

template <bool A_KCONTIG, bool B_KCONTIG>
__device__ __forceinline__ void store_tiles(float (*As)[kBM + 4], float (*Bs)[kBN + 4],
                                            const float (&ra)[8], const float (&rb)[4],
                                            int tid) {
  if (A_KCONTIG) {
#pragma unroll
    for (int i = 0; i < 8; ++i) As[tid % kBK][tid / kBK + 16 * i] = ra[i];
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) As[tid / kBM + 2 * i][tid % kBM] = ra[i];
  }
  if (B_KCONTIG) {
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[tid % kBK][tid / kBK + 16 * i] = rb[i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[tid / kBN + 4 * i][tid % kBN] = rb[i];
  }
}

// C[z][m, n] = sum_k A(z, m, k) B(z, k, n); P supplies M, N, K, the loads
// (A_KCONTIG: thread tid loads A(m0 + tid/16 + 16i, k0 + tid%16), else
// A(m0 + tid%128, k0 + tid/128 + 2i); B likewise with 16 / 64) and store().
template <class P>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(const P p) {
  __shared__ __align__(16) float As[2][kBK][kBM + 4];
  __shared__ __align__(16) float Bs[2][kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, z = blockIdx.z;
  const typename P::Loader ld(p, m0, n0, z, tid);
  float ra[8], rb[4];
  ld.load(p, 0, ra, rb);
  store_tiles<P::A_KCONTIG, P::B_KCONTIG>(As[0], Bs[0], ra, rb, tid);
  __syncthreads();

  float acc[kGTM][kGTN];
#pragma unroll
  for (int i = 0; i < kGTM; ++i)
#pragma unroll
    for (int j = 0; j < kGTN; ++j) acc[i][j] = 0.f;
  const int ty = tid / 16, tx = tid % 16;
  const int nk = (p.K + kBK - 1) / kBK;
  for (int c = 0; c < nk; ++c) {
    const int cur = c & 1;
    if (c + 1 < nk) ld.load(p, (c + 1) * kBK, ra, rb);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * kGTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * kGTM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * kGTN]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < kGTM; ++i) {
        acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
      }
    }
    if (c + 1 < nk) store_tiles<P::A_KCONTIG, P::B_KCONTIG>(As[cur ^ 1], Bs[cur ^ 1], ra, rb, tid);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kGTM; ++i) {
    const int m = m0 + ty * kGTM + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < kGTN; ++j) {
      const int n = n0 + tx * kGTN + j;
      if (n < p.N) p.store(z, m, n, acc[i][j]);
    }
  }
}

// d_acts = d_rs @ w_rs^T over frames r; the epilogue applies the gate
// derivative and writes d_xin [R, 2H] and acts [R, H].
struct ActsGrad {
  static constexpr bool A_KCONTIG = true, B_KCONTIG = true;
  int M, N, K;  // R, H, 2H
  const float* d_rs;  // [R, 2H]
  const float* w_rs;  // [H, 2H], this layer
  const float* x_in;  // [R, 2H], this layer
  float* d_xin;
  float* acts;
  struct Loader {
    const float* arow[8];
    const float* brow[4];
    int kk;
    __device__ Loader(const ActsGrad& p, int m0, int n0, int, int tid) : kk(tid % kBK) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + tid / kBK + 16 * i;
        arow[i] = m < p.M ? p.d_rs + (size_t)m * p.K : nullptr;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + tid / kBK + 16 * i;
        brow[i] = n < p.N ? p.w_rs + (size_t)n * p.K : nullptr;
      }
    }
    __device__ void load(const ActsGrad& p, int k0, float (&ra)[8], float (&rb)[4]) const {
      const int k = k0 + kk;
      const bool kv = k < p.K;
#pragma unroll
      for (int i = 0; i < 8; ++i) ra[i] = (arow[i] != nullptr && kv) ? __ldg(arow[i] + k) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) rb[i] = (brow[i] != nullptr && kv) ? __ldg(brow[i] + k) : 0.f;
    }
  };
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
  static constexpr bool A_KCONTIG = true, B_KCONTIG = true;
  int M, N, K;  // R, H, k*2H
  int T, pad, H2;
  const float* d_xin;  // [R, 2H]
  const float* w_in;   // [k, H, 2H], this layer
  const float* d_rs;   // [R, 2H]
  float* d_x;          // [R, H]
  struct Loader {
    int row[8], t[8], col[4];
    int kk;
    __device__ Loader(const InputGrad& p, int m0, int n0, int, int tid) : kk(tid % kBK) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + tid / kBK + 16 * i;
        row[i] = m < p.M ? m : -1;
        t[i] = m % p.T;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + tid / kBK + 16 * i;
        col[i] = n < p.N ? n : -1;
      }
    }
    __device__ void load(const InputGrad& p, int k0, float (&ra)[8], float (&rb)[4]) const {
      const int k = k0 + kk;
      const bool kv = k < p.K;
      const int tau = k / p.H2, j = k - tau * p.H2;
      const int shift = p.pad - tau;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int st = t[i] + shift;
        ra[i] = (kv && row[i] >= 0 && st >= 0 && st < p.T)
                    ? __ldg(p.d_xin + (size_t)(row[i] + shift) * p.H2 + j) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rb[i] = (kv && col[i] >= 0) ? __ldg(p.w_in + ((size_t)tau * p.N + col[i]) * p.H2 + j) : 0.f;
    }
  };
  __device__ void store(int, int m, int n, float v) const {
    d_x[(size_t)m * N + n] = d_rs[(size_t)m * H2 + n] + v;
  }
};

// Per batch item z: part[z][(tau, ci), j] = sum_t x_i[z, t + tau - p, ci] d_xin[z, t, j];
// row k*H (a row of ones) gives sum_t d_xin[z, t, j].
struct WeightInGrad {
  static constexpr bool A_KCONTIG = false, B_KCONTIG = false;
  int M, N, K;  // k*H + 1, 2H, T
  int H, pad;
  const float* x_i;    // [B, T, H], this layer
  const float* d_xin;  // [B, T, 2H]
  float* part;         // [B, M, N]
  struct Loader {
    const float* xb;
    const float* db;
    int ci, shift, kind, kk_a, col, kk_b;  // kind: 0 x row, 1 ones row, 2 padding
    __device__ Loader(const WeightInGrad& p, int m0, int n0, int z, int tid) {
      const int m = m0 + tid % kBM;
      const int km = p.M - 1;
      kind = m < km ? 0 : (m == km ? 1 : 2);
      const int tau = m < km ? m / p.H : 0;
      ci = m < km ? m - tau * p.H : 0;
      shift = tau - p.pad;
      kk_a = tid / kBM;
      col = n0 + tid % kBN;
      kk_b = tid / kBN;
      xb = p.x_i + (size_t)z * p.K * p.H;
      db = p.d_xin + (size_t)z * p.K * p.N;
    }
    __device__ void load(const WeightInGrad& p, int k0, float (&ra)[8], float (&rb)[4]) const {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = k0 + kk_a + 2 * i;
        const int st = t + shift;
        float v = 0.f;
        if (t < p.K) {
          if (kind == 0) {
            if (st >= 0 && st < p.K) v = __ldg(xb + (size_t)st * p.H + ci);
          } else if (kind == 1) {
            v = 1.f;
          }
        }
        ra[i] = v;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = k0 + kk_b + 4 * i;
        rb[i] = (t < p.K && col < p.N) ? __ldg(db + (size_t)t * p.N + col) : 0.f;
      }
    }
  };
  __device__ void store(int z, int m, int n, float v) const {
    part[((size_t)z * M + m) * N + n] = v;
  }
};

// Per batch item z: part[z][c, j] = sum_t acts[z, t, c] d_rs[z, t, j]; row H
// (ones) gives sum_t d_rs[z, t, j].
struct WeightRsGrad {
  static constexpr bool A_KCONTIG = false, B_KCONTIG = false;
  int M, N, K;  // H + 1, 2H, T
  const float* acts;  // [B, T, H]
  const float* d_rs;  // [B, T, 2H]
  float* part;        // [B, M, N]
  struct Loader {
    const float* ab;
    const float* db;
    int row, kind, kk_a, col, kk_b;
    __device__ Loader(const WeightRsGrad& p, int m0, int n0, int z, int tid) {
      row = m0 + tid % kBM;
      kind = row < p.M - 1 ? 0 : (row == p.M - 1 ? 1 : 2);
      kk_a = tid / kBM;
      col = n0 + tid % kBN;
      kk_b = tid / kBN;
      ab = p.acts + (size_t)z * p.K * (p.M - 1);
      db = p.d_rs + (size_t)z * p.K * p.N;
    }
    __device__ void load(const WeightRsGrad& p, int k0, float (&ra)[8], float (&rb)[4]) const {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = k0 + kk_a + 2 * i;
        float v = 0.f;
        if (t < p.K) v = kind == 0 ? __ldg(ab + (size_t)t * (p.M - 1) + row) : (kind == 1 ? 1.f : 0.f);
        ra[i] = v;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = k0 + kk_b + 4 * i;
        rb[i] = (t < p.K && col < p.N) ? __ldg(db + (size_t)t * p.N + col) : 0.f;
      }
    }
  };
  __device__ void store(int z, int m, int n, float v) const {
    part[((size_t)z * M + m) * N + n] = v;
  }
};

// d_rs = [d_x * m, d_skip * m] over R frames.
__global__ void prep_drs_kernel(const float* __restrict__ d_x, const float* __restrict__ d_sk,
                                const float* __restrict__ mask, float* __restrict__ d_rs,
                                int R, int H) {
  const size_t n = (size_t)R * 2 * H;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / (2 * H);
    const int c = (int)(i - r * 2 * H);
    const float g = c < H ? d_x[r * H + c] : d_sk[r * H + c - H];
    d_rs[i] = g * mask[r];
  }
}

// out_w[m, n] = sum_z part[z, m, n] for m < M - 1 (z in order); row M - 1
// goes to out_b, and, when d_gl is given, each item's own row to
// d_gl[z, layer].
__global__ void reduce_parts_kernel(const float* __restrict__ part, int Z, int M, int N,
                                    float* __restrict__ out_w, float* __restrict__ out_b,
                                    float* __restrict__ d_gl, int layer, int L) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * N) return;
  float s = 0.f;
  for (int z = 0; z < Z; ++z) s += part[(size_t)z * M * N + idx];
  const int m = idx / N, n = idx - (idx / N) * N;
  if (m < M - 1) {
    out_w[idx] = s;
  } else {
    out_b[n] = s;
    if (d_gl != nullptr)
      for (int z = 0; z < Z; ++z) d_gl[((size_t)z * L + layer) * N + n] = part[(size_t)z * M * N + idx];
  }
}

template <class P>
cudaError_t launch_gemm(const P& p, int Z, cudaStream_t stream) {
  dim3 grid((p.M + kBM - 1) / kBM, (p.N + kBN - 1) / kBN, Z);
  gemm_kernel<P><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
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
// B*T*6H + B*(k*H + 1)*2H + B*(H + 1)*2H floats (the wrapper's
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
  float* dx_tmp = work;                       // [R, H]
  float* d_rs = dx_tmp + (size_t)R * H;       // [R, 2H]
  float* d_xin = d_rs + (size_t)R * H2;       // [R, 2H]
  float* acts = d_xin + (size_t)R * H2;       // [R, H]
  float* part_a = acts + (size_t)R * H;       // [B, Ma, 2H]
  float* part_b = part_a + (size_t)B * Ma * H2;  // [B, Mb, 2H]

  const float* cur = d_xo;
  for (int i = L - 1; i >= 0; --i) {
    float* nxt = (i % 2 == 0) ? d_x : dx_tmp;  // layer 0 lands in d_x
    const float* xi = save_x + (size_t)i * R * H;
    const float* xin = save_xin + (size_t)i * R * H2;
    const float* w_in_i = w_in + (size_t)i * k * H * H2;
    const float* w_rs_i = w_rs + (size_t)i * H * H2;
    cudaError_t err;

    prep_drs_kernel<<<264, 256, 0, s>>>(cur, d_sk, mask, d_rs, R, H);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    ActsGrad pa{R, H, H2, d_rs, w_rs_i, xin, d_xin, acts};
    if ((err = launch_gemm(pa, 1, s)) != cudaSuccess) return (int)err;

    InputGrad pi{R, H, k * H2, T, pad, H2, d_xin, w_in_i, d_rs, nxt};
    if ((err = launch_gemm(pi, 1, s)) != cudaSuccess) return (int)err;

    WeightInGrad pw{Ma, H2, T, H, pad, xi, d_xin, part_a};
    if ((err = launch_gemm(pw, B, s)) != cudaSuccess) return (int)err;

    WeightRsGrad pr{Mb, H2, T, acts, d_rs, part_b};
    if ((err = launch_gemm(pr, B, s)) != cudaSuccess) return (int)err;

    reduce_parts_kernel<<<(Ma * H2 + 255) / 256, 256, 0, s>>>(
        part_a, B, Ma, H2, d_w_in + (size_t)i * k * H * H2, d_b_in + (size_t)i * H2, d_gl, i, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    reduce_parts_kernel<<<(Mb * H2 + 255) / 256, 256, 0, s>>>(
        part_b, B, Mb, H2, d_w_rs + (size_t)i * H * H2, d_b_rs + (size_t)i * H2, nullptr, i, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    cur = nxt;
  }
  return 0;
}
