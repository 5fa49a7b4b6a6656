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
// Bound on the H100: operations. A flow's group (H=192, k=5, L=4) is about
// 3.6 GFLOP per 1024 frames: 0.022 ms at B=1 at 3xTF32's 165 TFLOP/s (the
// rate that keeps fp32 accuracy on the tensor cores), 0.054 ms at fp32
// SIMT's 67. Each time tile also recomputes a halo of L (k - 1) / 2 frames
// a side.
//
// Design:
// - Both products of a layer run on Hopper's warpgroup tensor cores in
//   3xTF32 (wgmma_tf32.cuh, the route of mrf_fused.cu and the backward
//   below): the k-tap conv as an implicit GEMM [64 rows x kH] @ [kH x 2H],
//   the 1x1 as [64 rows x H] @ [H x 2H], K in chunks of 32. A comes from
//   registers: the conv's from the x window, which shared memory holds
//   already split into TF32 hi and lo parts (a tap's row shift is free),
//   the 1x1's from acts, split as loaded; chunk s + 1's A loads while chunk
//   s's products run.
// - B, the weights: a first kernel splits w_in and w_rs into hi and lo
//   once a call (split_weights_kernel, into the wrapper's workspace), laid
//   out as the ring holds them; thread 0 then brings each chunk into a
//   two-slot ring by one TMA bulk copy, two chunks ahead, completing on the
//   slot's mbarrier. No thread loads, splits or stores a weight.
// - A CTA of one warpgroup holds a window of 64 rows and owns the
//   T0 = 64 - 2 L (k - 1) / 2 frames in its middle (48 at k=5, L=4: a halo
//   share of 25%); all L layers run on it, so x never leaves the chip
//   inside a group. Every layer computes all 64 rows: the rows a layer
//   leaves wrong lie in the halo, which the next layers' results on the
//   owned rows do not read. The x window has (k - 1) / 2 zero rows above
//   and below, so the edge rows' tap reads stay in bounds.
// - The 2H columns are split over a thread block cluster of C = H / NC
//   CTAs, each owning NC channels: their tanh columns c and sigmoid
//   columns c + H in the conv, their residual and skip columns in the 1x1.
//   The B tile puts a channel's two columns in matched accumulator
//   registers, so the gate forms in the accumulators with no exchange.
//   Each CTA writes its acts, and after the 1x1 its updated x channels
//   (split again), into every CTA of the cluster (distributed shared
//   memory), and a cluster barrier follows: two a layer.
// - Plans (`plan_forward` in the wrapper): C = 4 (NC = 48, 96-column
//   products) when every tile's cluster fits in one wave on the card (B=1,
//   T=1024: 22 tiles, 88 CTAs), else C = 3 (NC = 64, 128-column products,
//   the more efficient over several waves); C = 4 also where C = 3 does not
//   fit in shared memory (k >= 13). chip_smoke.py times both at the flows'
//   B=1 and B=8 shapes. A 6-CTA split (132 CTAs at B=1, but fewer of its
//   clusters fit on the card at once), two warpgroups a CTA splitting the
//   columns, 128-row windows, a three-slot ring and products kept in
//   flight across chunks (wgmma.wait_group 1) were each slower in
//   throwaway A/B copies on the H100.
// - The 1x1's skip columns are never zeroed: their accumulators sum the
//   skip over the layers, and the epilogue adds the summed biases, masks
//   and stores the owned rows. The last layer writes x_out from its
//   registers.
// - SAVE (the training forward) also writes each layer's input x_i (the
//   window's hi + lo) and pre-activation x_in on the owned rows and
//   channels, for the backward.
// - Window positions outside [0, T) load as zero with mask 0, which
//   reproduces the reference's zero padding.

#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tf32.cuh"

namespace {

using namespace tts_wgmma;

constexpr int kMaxTaps = 15;
constexpr int kPad = 4;            // floats of padding per shared-memory row of x and acts
constexpr int kFwdThreads = 128;  // one warpgroup
constexpr int kWindow = 64;       // rows of x a forward CTA holds

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// distributed shared memory: this CTA's address p as seen in CTA `rank` of
// the cluster, a float2 store there, and the cluster-wide barrier
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v.x), "f"(v.y)
               : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct WnFwdArgs {
  const float* x;
  const float* mask;
  const float* gl;  // or null
  const float* b_in;
  const float* b_rs;
  float* wsplit;  // the weights' chunks, split (split_weights_kernel)
  float* x_out;
  float* skip_out;
  float* save_x;    // [L, B, T, H] or null
  float* save_xin;  // [L, B, T, 2H] or null
  int B, T, L, k, T0;
};

template <int H, int NC>
struct FwdShape {
  static constexpr int C = H / NC;        // CTAs a cluster
  static constexpr int W = kWindow;       // window rows
  static constexpr int NCTA = 2 * NC;     // columns of the CTA's products
  static constexpr int KC = 32;           // K of a staged chunk
  static constexpr int TILE = KC * NCTA;  // floats of a hi or lo tile
  static constexpr int SLOTS = 2;         // ring slots
  static size_t smem_bytes(int k) {
    return ((size_t)2 * SLOTS * TILE + (size_t)2 * (W + k - 1) * (H + kPad) +
            (size_t)W * (H + kPad) + W) * sizeof(float) + SLOTS * sizeof(uint64_t);
  }
};

// The weights as the ring holds them: for chunk s (KC rows of w_in[l]
// viewed as [k H, 2H], then of w_rs[l] [H, 2H], layer by layer) and CTA
// rank r of the cluster, 2 TILE floats: the hi tile, then the lo tile, each
// K-major (kmajor_offset<NCTA>) over the CTA's NCTA columns: column n is
// the CTA's channel n % NC, in the tanh / residual half if n < NC, else in
// the sigmoid / skip half (global column + H). One thread splits 4 rows of
// one column.
template <int H, int NC>
__global__ void __launch_bounds__(256)
split_weights_kernel(const float* __restrict__ w_in, const float* __restrict__ w_rs,
                     float* __restrict__ out, int L, int k) {
  using S = FwdShape<H, NC>;
  constexpr int C = S::C, NCTA = S::NCTA, KC = S::KC, TILE = S::TILE;
  constexpr int H2 = 2 * H, CPK = H / KC;
  const int per_layer = (k + 1) * CPK, conv_chunks = k * CPK;
  const long long total = (long long)L * per_layer * C * (KC / 4) * NCTA;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i % NCTA), k4 = (int)(i / NCTA % (KC / 4));
    const long long sr = i / NCTA / (KC / 4);  // s * C + r
    const int r = (int)(sr % C), s = (int)(sr / C);
    const int l = s / per_layer, c = s - l * per_layer;
    const int col = n / NC * H + r * NC + n % NC;
    const float* w = c < conv_chunks ? w_in + ((size_t)l * k * H + c * KC) * H2
                                     : w_rs + ((size_t)l * H + (c - conv_chunks) * KC) * H2;
    float* hi = out + sr * 2 * TILE + kmajor_offset<NCTA>(4 * k4, n);
    float h[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __ldg(w + (size_t)(4 * k4 + e) * H2 + col);
      h[e] = __uint_as_float(tf32_rna(v));
      lo[e] = __uint_as_float(tf32_rna(v - h[e]));
    }
    *reinterpret_cast<float4*>(hi) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(hi + TILE) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one thread: copy `bytes` from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int H, int NC, bool SAVE>
__global__ void __launch_bounds__(kFwdThreads, 1)
wn_fwd_kernel(const __grid_constant__ WnFwdArgs a) {
  using S = FwdShape<H, NC>;
  constexpr int C = S::C, W = S::W, NCTA = S::NCTA, KC = S::KC, TILE = S::TILE;
  constexpr int SLOTS = S::SLOTS;
  constexpr int NR = NCTA / 2;   // accumulator registers a thread
  constexpr int J2 = NC / 8;     // n8 groups of one half (tanh / residual)
  constexpr int HP = H + kPad, H2 = 2 * H, H4 = H / 4, HP4 = HP / 4;
  constexpr int CPK = H / KC;    // chunks of one tap, or of the 1x1
  static_assert(C * NC == H && H % KC == 0 && NC % 16 == 0, "column split");

  const int rank = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int T = a.T, L = a.L, k = a.k, T0 = a.T0, B = a.B;
  const int p = (k - 1) / 2, halo = L * p;
  const int win_start = tile * T0 - halo;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = warp * 16;       // the warp's first window row
  const int ch0 = rank * NC;      // the CTA's first channel

  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                              // SLOTS x (hi, lo) x TILE
  uint32_t* xh = reinterpret_cast<uint32_t*>(ring + 2 * SLOTS * TILE);  // [W + 2p, HP] tf32 hi
  uint32_t* xl = xh + (W + 2 * p) * HP;            // ... and lo; row i holds window row i - p
  float* acts = reinterpret_cast<float*>(xl + (W + 2 * p) * HP);  // [W, HP]
  float* ms = acts + W * HP;                       // [W]
  uint64_t* full = reinterpret_cast<uint64_t*>(ms + W);  // [SLOTS]

  // --- weight chunks come into the ring by TMA bulk copies from wsplit,
  // issued by thread 0 two chunks ahead
  const int per_layer = (k + 1) * CPK, conv_chunks = k * CPK, total = L * per_layer;
  auto issue = [&](int s) {
    bulk_load(ring + (s % SLOTS) * 2 * TILE, a.wsplit + ((size_t)s * C + rank) * 2 * TILE,
              2 * TILE * sizeof(float), full + s % SLOTS);
  };
  if (tid == 0) {
    for (int i = 0; i < SLOTS; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < SLOTS && s < total; ++s) issue(s);
  }

  // --- the x window, split into TF32 hi and lo (zero outside [0, T) and in
  // the pad rows), and the mask
  {
    const float* xb = a.x + (size_t)b * T * H;
    for (int i = tid; i < (W + 2 * p) * H4; i += kFwdThreads) {
      const int row = i / H4, pos = win_start + row - p;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row >= p && row < W + p && pos >= 0 && pos < T)
        v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)pos * H) + i % H4);
      uint4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      reinterpret_cast<uint4*>(xh)[row * HP4 + i % H4] = h;
      reinterpret_cast<uint4*>(xl)[row * HP4 + i % H4] = l;
    }
    for (int r = tid; r < W; r += kFwdThreads) {
      const int pos = win_start + r;
      ms[r] = (pos >= 0 && pos < T) ? __ldg(a.mask + (size_t)b * T + pos) : 0.f;
    }
  }

  // --- A fragments: the conv's from the split x window shifted by the tap,
  // the 1x1's from acts, split as loaded. Two sets, so chunk s + 1's load
  // while chunk s's products run.
  using Frag = uint32_t[KC / 8][4];
  Frag ah0, al0, ah1, al1;
  auto fetch_a = [&](int s, Frag& h, Frag& l) {
    const int c = s % per_layer;
    if (c < conv_chunks) {
      const int o = (m0 + g + c / CPK) * HP + (c % CPK) * KC + t4;  // row r + tap
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const int q = o + 8 * kk;
        h[kk][0] = xh[q]; h[kk][1] = xh[q + 8 * HP]; h[kk][2] = xh[q + 4]; h[kk][3] = xh[q + 8 * HP + 4];
        l[kk][0] = xl[q]; l[kk][1] = xl[q + 8 * HP]; l[kk][2] = xl[q + 4]; l[kk][3] = xl[q + 8 * HP + 4];
      }
    } else {
      const float* a0 = acts + (m0 + g) * HP + (c - conv_chunks) * KC + t4;
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        split_tf32(a0[8 * kk], h[kk][0], l[kk][0]);
        split_tf32(a0[8 * kk + 8 * HP], h[kk][1], l[kk][1]);
        split_tf32(a0[8 * kk + 4], h[kk][2], l[kk][2]);
        split_tf32(a0[8 * kk + 8 * HP + 4], h[kk][3], l[kk][3]);
      }
    }
  };

  // Chunk s of a product into acc, its A in (h, l); `more`: chunk s + 1
  // belongs to the same product, its A goes to (nh, nl) while chunk s's
  // products run. After the block barrier that follows them, thread 0
  // refills the slot with chunk s + SLOTS.
  auto step = [&](float (&acc)[NR], int s, bool more, Frag& h, Frag& l, Frag& nh, Frag& nl) {
    const float* b_hi = ring + (s % SLOTS) * 2 * TILE;
    mbar_wait(full + s % SLOTS, (s / SLOTS) & 1);
#pragma unroll
    for (int e = 0; e < NR; ++e) keep(acc[e]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      const uint64_t dh = kmajor_desc<NCTA>(b_hi, kk), dl = kmajor_desc<NCTA>(b_hi + TILE, kk);
      wgmma_tf32<NCTA>(acc, l[kk], dh);
      wgmma_tf32<NCTA>(acc, h[kk], dl);
      wgmma_tf32<NCTA>(acc, h[kk], dh);
    }
    wgmma_commit();
    if (more) fetch_a(s + 1, nh, nl);
    wgmma_wait0();
#pragma unroll
    for (int e = 0; e < NR; ++e) keep(acc[e]);
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) { keep(h[kk][e]); keep(l[kk][e]); }
    __syncthreads();  // no warpgroup reads slot s % SLOTS any more
    if (tid == 0 && s + SLOTS < total) issue(s + SLOTS);
  };
  // chunks s0 .. s0 + n - 1 of one product into acc
  auto run = [&](float (&acc)[NR], int s0, int n) {
    fetch_a(s0, ah0, al0);
    for (int c = 0; c < n; c += 2) {
      step(acc, s0 + c, c + 1 < n, ah0, al0, ah1, al1);
      if (c + 1 < n) step(acc, s0 + c + 1, c + 2 < n, ah1, al1, ah0, al0);
    }
  };

  // every CTA's buffers as seen from this one
  uint32_t acts_at[C], xh_at[C], xl_at[C];
#pragma unroll
  for (int r = 0; r < C; ++r) {
    acts_at[r] = cluster_addr(acts, r);
    xh_at[r] = cluster_addr(xh, r);
    xl_at[r] = cluster_addr(xl, r);
  }
  cluster_sync();  // the window and the barriers are in place, and every CTA of the cluster runs

  // acc[4 j + {0, 1}] at (g, 8 j + 2 t4 + {0, 1}), acc[4 j + {2, 3}] at
  // (g + 8, ...): n8 group j < J2 is a channel's tanh / residual column,
  // j + J2 its sigmoid / skip column
  float acc_c[NR], acc_r[NR];
#pragma unroll
  for (int e = 0; e < NR; ++e) acc_r[e] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int s0 = l * per_layer;
    if (SAVE) {  // the layer's input (hi + lo) on the owned rows and the CTA's channels
      float* sx = a.save_x + ((size_t)l * B + b) * T * H;
      for (int i = tid; i < T0 * (NC / 4); i += kFwdThreads) {
        const int r = i / (NC / 4), pos = tile * T0 + r, c4 = rank * (NC / 4) + i % (NC / 4);
        if (pos < T) {
          const uint4 h = reinterpret_cast<const uint4*>(xh + (halo + r + p) * HP)[c4];
          const uint4 lo = reinterpret_cast<const uint4*>(xl + (halo + r + p) * HP)[c4];
          reinterpret_cast<float4*>(sx + (size_t)pos * H)[c4] = make_float4(
              __uint_as_float(h.x) + __uint_as_float(lo.x), __uint_as_float(h.y) + __uint_as_float(lo.y),
              __uint_as_float(h.z) + __uint_as_float(lo.z), __uint_as_float(h.w) + __uint_as_float(lo.w));
        }
      }
    }

    // --- the k-tap conv, gated into acts (every CTA's copy)
#pragma unroll
    for (int e = 0; e < NR; ++e) acc_c[e] = 0.f;
    run(acc_c, s0, conv_chunks);
    {
      const float* bl = a.b_in + l * H2;
      const float* gll = a.gl != nullptr ? a.gl + ((size_t)b * L + l) * H2 : nullptr;
#pragma unroll
      for (int j = 0; j < J2; ++j) {
        const int ch = ch0 + 8 * j + 2 * t4;
        float2 bt = __ldg(reinterpret_cast<const float2*>(bl + ch));
        float2 bs = __ldg(reinterpret_cast<const float2*>(bl + H + ch));
        if (gll != nullptr) {
          const float2 gt = __ldg(reinterpret_cast<const float2*>(gll + ch));
          const float2 gs = __ldg(reinterpret_cast<const float2*>(gll + H + ch));
          bt.x += gt.x; bt.y += gt.y; bs.x += gs.x; bs.y += gs.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h;
          const float2 pt = make_float2(acc_c[4 * j + 2 * h] + bt.x, acc_c[4 * j + 2 * h + 1] + bt.y);
          const float2 ps = make_float2(acc_c[4 * (j + J2) + 2 * h] + bs.x,
                                        acc_c[4 * (j + J2) + 2 * h + 1] + bs.y);
          const float2 v = make_float2(tanhf(pt.x) * sigmoidf_(ps.x), tanhf(pt.y) * sigmoidf_(ps.y));
          const uint32_t off = (uint32_t)(r * HP + ch) * 4u;
#pragma unroll
          for (int q = 0; q < C; ++q) st_cluster(acts_at[q] + off, v);
          const int pos = win_start + r;
          if (SAVE && r >= halo && r < halo + T0 && pos < T) {
            float* si = a.save_xin + (((size_t)l * B + b) * T + pos) * H2;
            *reinterpret_cast<float2*>(si + ch) = pt;
            *reinterpret_cast<float2*>(si + H + ch) = ps;
          }
        }
      }
    }
    cluster_sync();  // every CTA holds the layer's acts

    // --- the 1x1: x = (x + rs[:H]) * mask on every CTA; the skip half sums on
#pragma unroll
    for (int j = 0; j < J2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_r[4 * j + e] = 0.f;
    run(acc_r, s0 + conv_chunks, CPK);
    {
      const bool last = l == L - 1;
      const float* br = a.b_rs + l * H2;
#pragma unroll
      for (int j = 0; j < J2; ++j) {
        const int ch = ch0 + 8 * j + 2 * t4;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(br + ch));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h;
          const float m = ms[r];
          const int o = (r + p) * HP + ch;
          const uint2 xhv = *reinterpret_cast<const uint2*>(xh + o);
          const uint2 xlv = *reinterpret_cast<const uint2*>(xl + o);
          const float2 v = make_float2(
              (__uint_as_float(xhv.x) + __uint_as_float(xlv.x) + (acc_r[4 * j + 2 * h] + bias.x)) * m,
              (__uint_as_float(xhv.y) + __uint_as_float(xlv.y) + (acc_r[4 * j + 2 * h + 1] + bias.y)) * m);
          if (last) {
            const int pos = win_start + r;
            if (r >= halo && r < halo + T0 && pos < T)
              *reinterpret_cast<float2*>(a.x_out + ((size_t)b * T + pos) * H + ch) = v;
          } else {
            uint32_t h0, l0, h1, l1;
            split_tf32(v.x, h0, l0);
            split_tf32(v.y, h1, l1);
            const float2 vh = make_float2(__uint_as_float(h0), __uint_as_float(h1));
            const float2 vl = make_float2(__uint_as_float(l0), __uint_as_float(l1));
#pragma unroll
            for (int q = 0; q < C; ++q) {
              st_cluster(xh_at[q] + o * 4u, vh);
              st_cluster(xl_at[q] + o * 4u, vl);
            }
          }
        }
      }
    }
    if (l + 1 < L) cluster_sync();  // every CTA holds the updated x
  }

  // --- skip * mask on the owned rows: the summed products plus the summed biases
#pragma unroll
  for (int j = 0; j < J2; ++j) {
    const int ch = ch0 + 8 * j + 2 * t4;
    float2 bias = make_float2(0.f, 0.f);
    for (int l = 0; l < L; ++l) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(a.b_rs + l * H2 + H + ch));
      bias.x += v.x;
      bias.y += v.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h, pos = win_start + r;
      if (r < halo || r >= halo + T0 || pos >= T) continue;
      const float m = ms[r];
      *reinterpret_cast<float2*>(a.skip_out + ((size_t)b * T + pos) * H + ch) =
          make_float2((acc_r[4 * (j + J2) + 2 * h] + bias.x) * m,
                      (acc_r[4 * (j + J2) + 2 * h + 1] + bias.y) * m);
    }
  }
}

template <int H, int NC>
cudaLaunchConfig_t fwd_config(const WnFwdArgs& a, cudaStream_t stream, cudaLaunchAttribute* attr) {
  using S = FwdShape<H, NC>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S::C, (a.T + a.T0 - 1) / a.T0, a.B);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = S::smem_bytes(a.k);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// splits the weights into a.wsplit, then launches the forward (max_clusters
// null); or writes how many of its clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters)
template <int H, int NC, bool SAVE>
cudaError_t launch_fwd(const WnFwdArgs& a, const float* w_in, const float* w_rs,
                       cudaStream_t stream, int* max_clusters) {
  const auto kernel = wn_fwd_kernel<H, NC, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FwdShape<H, NC>::smem_bytes(a.k));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fwd_config<H, NC>(a, stream, attr);
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  split_weights_kernel<H, NC><<<4 * 132, 256, 0, stream>>>(w_in, w_rs, a.wsplit, a.L, a.k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int NC>
cudaError_t launch_fwd_plan(const WnFwdArgs& a, const float* w_in, const float* w_rs, bool save,
                            cudaStream_t stream, int* max_clusters) {
  return save ? launch_fwd<192, NC, true>(a, w_in, w_rs, stream, max_clusters)
              : launch_fwd<192, NC, false>(a, w_in, w_rs, stream, max_clusters);
}

// the cluster sizes the wrapper may pick
cudaError_t launch_forward(const WnFwdArgs& a, const float* w_in, const float* w_rs, int cluster,
                           bool save, cudaStream_t stream, int* max_clusters) {
  if (cluster == 3) return launch_fwd_plan<64>(a, w_in, w_rs, save, stream, max_clusters);
  if (cluster == 4) return launch_fwd_plan<48>(a, w_in, w_rs, save, stream, max_clusters);
  return cudaErrorInvalidValue;
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
// [L, B, T, H] and pre-activation [L, B, T, 2H] for the backward. wsplit
// holds 2 L (k + 1) H 2H floats (the wrapper's `split_weights_floats`);
// `cluster` (3 or 4: the CTAs that split the 2H columns) is the wrapper's
// plan. Each CTA owns 64 - 2 L (k - 1) / 2 frames. Returns the first CUDA
// error (0 on success).
extern "C" int tts_wn_group_forward(const float* x, const float* mask, const float* gl,
                                    const float* w_in, const float* b_in,
                                    const float* w_rs, const float* b_rs, float* x_out,
                                    float* skip_out, float* save_x, float* save_xin,
                                    float* wsplit, int B, int T, int H, int L, int k,
                                    int cluster, void* stream) {
  // every shipped config has hidden_channels 192
  if (B < 1 || T < 1 || L < 1 || k < 1 || k % 2 == 0 || k > kMaxTaps || H != 192)
    return (int)cudaErrorInvalidValue;
  if ((save_x == nullptr) != (save_xin == nullptr)) return (int)cudaErrorInvalidValue;
  const int T0 = kWindow - 2 * L * ((k - 1) / 2);
  if (T0 < 1) return (int)cudaErrorInvalidValue;
  const WnFwdArgs a{x, mask, gl, b_in, b_rs, wsplit, x_out, skip_out, save_x, save_xin,
                    B, T, L, k, T0};
  return (int)launch_forward(a, w_in, w_rs, cluster, save_x != nullptr,
                             reinterpret_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of `cluster` CTAs of the forward for k taps the card
// holds at once -> *out. Returns the CUDA error (0 on success).
extern "C" int tts_wn_forward_max_clusters(int cluster, int k, int* out) {
  if (k < 1 || k % 2 == 0 || k > kMaxTaps || out == nullptr) return (int)cudaErrorInvalidValue;
  WnFwdArgs a{};
  a.B = a.T = a.T0 = a.L = 1;
  a.k = k;
  return (int)launch_forward(a, nullptr, nullptr, cluster, false, nullptr, out);
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
