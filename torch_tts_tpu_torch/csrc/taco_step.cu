// One eval-mode Taco2Prod decoder step (Tacotron-2 autoregressive step) in
// one cooperative launch.
//
// Replaces the TPU kernels torch_tts_tpu/kernels/taco_step.py
// taco_step_fused -> _kernel (weights resident in VMEM) and
// taco_step_streamed -> _streamed_kernel (the four big LSTM matrices
// double-buffered from HBM, fp32 or bf16). On Hopper both are this one
// kernel: the fused entry passes each LSTM's w_ih and w_hh in the JAX
// layout, the streamed one pack_streamed's tile-major [w_ih; w_hh].
//
// What it computes (the contract of torch_tts_tpu_torch/kernels/taco_step.py),
// fp32 activations, B <= 8 rows a launch (the wrapper launches once per
// group of at most 8 rows):
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
// Dc 512, H 1024) the step reads 74.5 MB of fp32 weights (39 MB with bf16
// LSTM matrices) against about 2 B multiply-adds per 4 weight bytes at
// B <= 8: about 22 us at 3.35 TB/s in fp32. 42 MB of those depend only on
// the previous step's state: the ctx rows of att_w_ih, att_w_hh and
// dec_w_hh. The chain that depends on this step is the PreNet (0.34 MB),
// the x_pre rows of att_w_ih (4.2 MB), the query (2.1 MB), the energies and
// context over memory, dec_w_ih (25.2 MB) and the mel/stop projection
// (0.5 MB). Design, for the byte stream rather than the barriers:
// - One persistent CTA per SM, 512 threads, cooperative launch (every CTA
//   resident, so a CTA may wait for another). No grid-wide barrier: each
//   dependency is a counter in global memory that every CTA adds one to
//   once per launch (arrive), and only the CTAs that read the result wait
//   for it (wait_for). Counters persist across launches: launch e of a
//   stream waits for e * gridDim.x arrivals (the wrapper keeps e).
// - At launch every CTA first computes the off-chain gate sums of the LSTM
//   tiles it owns: [ctx, h_att] through the ctx rows of att_w_ih and
//   att_w_hh, h_dec through dec_w_hh, kept in shared memory. The PreNet's
//   layer 1 runs first, on 32 CTAs; nobody waits on the PreNet but the
//   CTAs that read x_pre, after their off-chain sums.
// - L2 policies: the off-chain stream is read evict_first; the weights on
//   the chain (the PreNet, the x_pre rows of att_w_ih, the query, memory,
//   dec_w_ih and the mel/stop projection, about 32 MB at dim_rnn 1024) are
//   read and bulk-prefetched (cp.async.bulk.prefetch.L2, issued after the
//   attention's off-chain sums) evict_last, so HBM stays busy while the
//   chain's small phases pass their dependencies and, from step to step of
//   a decode, they may stay in L2.
// - Each phase issues its first batch of weight loads before it waits for
//   its dependency and stages its input vector (the prologue of gate_sums
//   and dense_tile), so the wait overlaps the weights' first round trip.
// - pack_streamed's tile-major layout [H / 8, K, 32] gives each LSTM tile
//   one contiguous range of rows; the fused entry's JAX layout [K, 4H]
//   reads a tile as 4 sectors of 32 bytes a row (gate-interleaved
//   ownership, no repack). A tile is 8 hidden units and all four of their
//   gate columns. Threads are 8 column groups x 64 lanes over K, each
//   loading 4 columns (16 bytes fp32, 8 bytes bf16) of 8 rows at a time; a
//   shuffle and a shared-memory pass reduce over K (gate_sums), and the
//   LSTM nonlinearity and zoneout blend are the epilogue (lstm_cell) of
//   the on-chain sum plus the off-chain one.
// - Small products (PreNet, query, mel/stop): tiles of 8 columns, 64 lanes
//   over K, 16 fp32 loads in flight a thread. Small intermediates (x1,
//   x_pre, q, p) go through a global scratch buffer; anything written
//   inside the launch is read with __ldcg (L2), never through the
//   non-coherent path.
// - Attention: one warp per (b, l) dot for e and p (its memory row loaded
//   before the wait for q); then per (b, 32 channels) the new weights
//   (recomputed per CTA from p) and the context.
// - A wait that has not ended after kTimeoutNs traps (a launch error, not
//   a hung card).
// No tensor cores (fp32 SIMT FMAs at about 2 B flops per weight).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;               // hidden units per LSTM tile (x 4 gates)
constexpr int kCols = 8;                // columns per small-product tile
constexpr int kKLanes = kThreads / 8;   // lanes over K in both tile kinds
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;      // dynamic shared memory per block on Hopper
constexpr unsigned long long kTimeoutNs = 2000000000ull;

// Order of the wrapper's pointer array.
enum Ptr {
  kYIn, kW, kCtx, kHAtt, kCAtt, kHDec, kCDec, kMemory, kMMask, kPMask1, kPMask2,
  kPW1, kPB1, kPW2, kPB2, kAttIH, kAttHH, kAttB, kQW, kDecIH, kDecHH, kDecB,
  kMelW, kMelB, kStopW, kStopB,
  kYOut, kSOut, kWOut, kCtxOut, kHAttOut, kCAttOut, kHDecOut, kCDecOut, kScratch,
  kNumPtrs
};

// The launch's dependencies, one counter each (x1, x_pre, h_att, q, p, ctx, h_dec).
enum Counter { cX1, cXPre, cHAtt, cQ, cP, cCtx, cHDec, kNumCounters };

struct Params {
  const float *y_in, *w, *ctx, *h_att, *c_att, *h_dec, *c_dec, *memory, *mmask, *pmask1, *pmask2;
  const float *pw1, *pb1, *pw2, *pb2;
  const void *att_ih, *att_hh;
  const float *att_b, *qw;
  const void *dec_ih, *dec_hh;
  const float *dec_b, *mel_w, *mel_b, *stop_w, *stop_b;
  float *y, *s, *w_out, *ctx_out, *h_att_out, *c_att_out, *h_dec_out, *c_dec_out;
  float *q, *x1, *xpre, *p;  // scratch: [B, Dc], [B, P], [B, P], [B, L]
  unsigned* ctr;             // kNumCounters counters, persistent across launches
  unsigned target;           // their value once every CTA of this launch arrived
  int B, L, Dm, P, Dc, H1, H2, r, xs_floats, att_own, dec_own;
  // LSTM matrix layout: element (k, gate, unit u0 + u) of the tile holding
  // unit u0 at W + (u0 / 8) tile_stride + k ld + gate gs + u. The JAX layout
  // [K, 4H]: tile_stride 8, ld 4H, gs H. pack_streamed's tile-major layout
  // [H / 8, K, 32]: tile_stride 32 K, ld 32, gs 8 (W_hh = W_ih + 32 K_ih).
  int tile_major;
  long long att_ts, dec_ts;
  int att_ld, dec_ld, att_gs, dec_gs;
  float p_zoneout, keep;
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// L2 eviction policies: the weights on this step's chain stay in L2 across
// steps (evict_last); the off-chain stream passes through (evict_first)
__device__ __forceinline__ uint64_t l2_policy_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_policy_stream() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ float load1(const float* p, uint64_t pol) {
  float v;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4], uint64_t pol) {
  asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "l"(p), "l"(pol));
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4], uint64_t pol) {
  uint32_t x, y;
  asm volatile("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
               : "=r"(x), "=r"(y)
               : "l"(p), "l"(pol));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&y);
  v[0] = __bfloat162float(lo.x); v[1] = __bfloat162float(lo.y);
  v[2] = __bfloat162float(hi.x); v[3] = __bfloat162float(hi.y);
}

// L2 prefetch of [p, p + bytes) by the tensor memory accelerator with
// eviction policy pol, issued by thread `by` (p 16-byte aligned, bytes a
// multiple of 16); the other threads go on at once
__device__ __forceinline__ void prefetch_bulk(const void* p, size_t bytes, uint64_t pol,
                                              int by) {
  if (threadIdx.x != by) return;
  const char* c = static_cast<const char*>(p);
  for (size_t off = 0; off < bytes; off += 65536) {
    const unsigned n = (unsigned)(bytes - off < 65536 ? bytes - off : 65536);
    asm volatile("cp.async.bulk.prefetch.L2.global.L2::cache_hint [%0], %1, %2;"
                 ::"l"(c + off), "r"(n), "l"(pol) : "memory");
  }
}

// this CTA's 1/gridDim.x share of [p, p + bytes) into L2
__device__ __forceinline__ void prefetch_share(const void* p, size_t bytes, uint64_t pol,
                                               int by) {
  const size_t chunk = (bytes / gridDim.x + 15) & ~(size_t)15;
  const size_t off = chunk * blockIdx.x;
  if (off < bytes)
    prefetch_bulk(static_cast<const char*>(p) + off, bytes - off < chunk ? bytes - off : chunk,
                  pol, by);
}

// this CTA's results are written: add one to the counter (release: the
// CTA's writes, ordered before it by the barrier, are visible first)
__device__ __forceinline__ void arrive(unsigned* ctr) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr) : "memory");
}

// wait until every CTA of this launch arrived at the counter
__device__ __forceinline__ void wait_for(const unsigned* ctr, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned long long t0, now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    for (;;) {
      unsigned v;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(ctr) : "memory");
      if ((int)(v - target) >= 0) break;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (now - t0 > kTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// xs[(k0 + k) * NB + b] = src[b, k] for k < n (rows b >= B are zero);
// src may have been written earlier in this launch, so it is read via L2.
// Loads are issued 8 at a time before their stores, so a vector costs one
// round trip per 8 * kThreads elements, not per kThreads.
template <int NB>
__device__ void stage(float* xs, int k0, const float* src, int n, int B) {
  constexpr int U = 8;
  for (int i0 = threadIdx.x; i0 < n * NB; i0 += U * kThreads) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads, b = i / n, k = i - b * n;
      v[u] = (i < n * NB && b < B) ? __ldcg(src + (size_t)b * n + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads, b = i / n, k = i - b * n;
      if (i < n * NB) xs[(k0 + k) * NB + b] = v[u];
    }
  }
}

// Each phase issues its first batch of weight loads, then runs `pro` (on
// every thread: wait for the phase's dependency, stage its vector), then
// a barrier, then the products: the wait and the staging overlap the
// weights' first round trip. The weights do not depend on the step.

// out[b, n] = sum_k xs[k, b] W[k, n] for the 8 columns n0..n0+7 (< N);
// epi(n, b, sum) for b < B. Whole block; red holds kWarps * 8 * NB floats.
template <int NB, typename Pro, typename Epi>
__device__ void dense_tile(const float* xs, int K, const float* __restrict__ W, int N, int n0,
                           int B, float* red, uint64_t pol, Pro pro, Epi epi) {
  constexpr int U = 16;  // loads in flight a thread
  const int t = threadIdx.x, c = t & 7, kl = t >> 3, lane = t & 31, warp = t >> 5;
  const int n = min(n0 + c, N - 1);  // columns past N load a valid one, never stored
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  float wv[U];
  auto load = [&](int k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * kKLanes;
      wv[u] = kk < K ? load1(W + (size_t)kk * N + n, pol) : 0.f;
    }
  };
  auto fma = [&](int k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * kKLanes;
      if (kk < K) {
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b] = fmaf(wv[u], xs[kk * NB + b], acc[b]);
      }
    }
  };
  load(kl);
  pro();
  __syncthreads();
  fma(kl);
  for (int k = kl + U * kKLanes; k < K; k += U * kKLanes) {
    load(k);
    fma(k);
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

// Gate sums of one LSTM tile (8 hidden units, all four gates):
// out[(gate * 8 + unit) * NB + b] = add[...] + sum_k xa[k, b] Wa(k, gate, unit)
// + sum_k xb[k, b] Wb(k, gate, unit) over Ka >= 1 and Kb rows (Kb may be 0),
// with W(k, gate, unit) = W[k ld + gate gs + unit] from the tile's pointers;
// add may be null. red holds kWarps * 32 * NB floats.
template <int NB, typename WT, typename Pro>
__device__ void gate_sums(const float* xa, const WT* __restrict__ Wa, int Ka, const float* xb,
                          const WT* __restrict__ Wb, int Kb, int ld, int gs, float* red,
                          float* out, const float* add, uint64_t pol, Pro pro) {
  constexpr int U = 8;  // loads of 4 columns in flight a thread
  const int t = threadIdx.x, grp = t & 7, kl = t >> 3, lane = t & 31, warp = t >> 5;
  const int col = (grp >> 1) * gs + 4 * (grp & 1);
  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
  float wv[U][4];
  auto load = [&](const WT* __restrict__ W, int K, int k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * kKLanes;
      if (kk < K) {
        load4(W + (size_t)kk * ld + col, wv[u], pol);
      } else {
        wv[u][0] = wv[u][1] = wv[u][2] = wv[u][3] = 0.f;
      }
    }
  };
  auto fma = [&](const float* x, int K, int k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * kKLanes;
      if (kk < K) {
        const float* xk = x + kk * NB;
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[b][j] = fmaf(wv[u][j], xk[b], acc[b][j]);
      }
    }
  };
  auto run = [&](const WT* __restrict__ W, const float* x, int K, int k) {
    for (; k < K; k += U * kKLanes) {
      load(W, K, k);
      fma(x, K, k);
    }
  };
  load(Wa, Ka, kl);
  pro();
  __syncthreads();
  fma(xa, Ka, kl);
  run(Wa, xa, Ka, kl + U * kKLanes);
  if (Kb > 0) run(Wb, xb, Kb, kl);

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
  for (int i = t; i < 32 * NB; i += kThreads) {
    const int ci = i / NB, b = i - ci * NB;
    float sum = add != nullptr ? add[i] : 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * 32 + ci) * NB + b];
    out[i] = sum;
  }
  __syncthreads();
}

// The inputs of one thread's LSTM cell epilogue (thread t < 8 NB: unit
// u0 + t / NB, row t % NB), loaded before the phase's products
struct CellIn {
  float b[4], h, c;
};

template <int NB>
__device__ __forceinline__ CellIn cell_in(int H, int u0, const float* __restrict__ bias,
                                          const float* h_prev, const float* c_prev, int B) {
  CellIn ci{{0.f, 0.f, 0.f, 0.f}, 0.f, 0.f};
  const int t = threadIdx.x, u = t / NB, b = t - u * NB, j = u0 + u;
  if (t < kUnits * NB && b < B) {
#pragma unroll
    for (int g = 0; g < 4; ++g) ci.b[g] = __ldg(bias + g * H + j);
    ci.h = __ldg(h_prev + (size_t)b * H + j);
    ci.c = __ldg(c_prev + (size_t)b * H + j);
  }
  return ci;
}

// The LSTM cell and zoneout blend of units u0..u0+7 from their gate sums.
template <int NB>
__device__ void lstm_cell(const float* gates, const CellIn& ci, int H, int u0, float* h_out,
                          float* c_out, float pz, int B) {
  const int t = threadIdx.x;
  if (t < kUnits * NB) {
    const int u = t / NB, b = t - u * NB, j = u0 + u;
    if (b < B) {
      const float gi = sigmoidf(gates[(0 * 8 + u) * NB + b] + ci.b[0]);
      const float gf = sigmoidf(gates[(1 * 8 + u) * NB + b] + ci.b[1]);
      const float gg = tanhf(gates[(2 * 8 + u) * NB + b] + ci.b[2]);
      const float go = sigmoidf(gates[(3 * 8 + u) * NB + b] + ci.b[3]);
      const float c_new = gf * ci.c + gi * gg;
      const float h_new = go * tanhf(c_new);
      h_out[(size_t)b * H + j] = pz * ci.h + (1.f - pz) * h_new;
      c_out[(size_t)b * H + j] = pz * ci.c + (1.f - pz) * c_new;
    }
  }
  __syncthreads();
}

// L2 prefetch of the first `rows` rows of an LSTM matrix: in the
// tile-major layout each tile's rows are one range (its owner prefetches
// them); in the JAX layout the rows are one range, shared by all CTAs
template <typename WT>
__device__ void prefetch_rows(const WT* W, int rows, int tiles, long long ts, int ld,
                              bool tile_major, uint64_t pol, int by) {
  if (tile_major) {
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      prefetch_bulk(W + tile * ts, (size_t)rows * ld * sizeof(WT), pol, by);
  } else {
    prefetch_share(W, (size_t)rows * ld * sizeof(WT), pol, by);
  }
}

template <int NB, typename WT>
__global__ void __launch_bounds__(kThreads, 1) taco_step_kernel(Params a) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* red = xs + a.xs_floats;          // kWarps * 32 * NB
  float* gates = red + kWarps * 32 * NB;  // 32 * NB
  float* part = gates + 32 * NB;          // (att_own + dec_own) * 32 * NB
  const int G = gridDim.x, cta = blockIdx.x, t = threadIdx.x;
  const int B = a.B, L = a.L, P = a.P, Dc = a.Dc, H1 = a.H1, H2 = a.H2;
  const WT* att_ih = static_cast<const WT*>(a.att_ih);
  const WT* att_hh = static_cast<const WT*>(a.att_hh);
  const WT* dec_ih = static_cast<const WT*>(a.dec_ih);
  const WT* dec_hh = static_cast<const WT*>(a.dec_hh);
  const int p_tiles = cdiv(P, kCols), att_tiles = H1 / kUnits, dec_tiles = H2 / kUnits;
  const int q_tiles = cdiv(Dc, kCols), dt = cdiv(Dc, 32);
  const int n_mel = a.r * a.Dm, mel_tiles = cdiv(n_mel, kCols);
  const int out_tiles = mel_tiles + cdiv(a.r, kCols);
  unsigned* ctr = a.ctr;
  const bool tm = a.tile_major != 0;
  const uint64_t keep = l2_policy_keep(), stream = l2_policy_stream();

  // 1. PreNet layer 1: x1 = drop1(relu(y_in W1 + b1)), at launch, before
  // HBM is loaded. When at least one CTA a PreNet tile owns no LSTM tile
  // (dim_rnn 320: 92 of 132), the PreNet runs there and layer 2 follows at
  // once; else on the first CTAs, which run layer 2 after their attention
  // off-chain sums (on a few free CTAs the tiles of a layer would run one
  // after another, each a round trip under the full stream: slower).
  const int lstm_ctas = max(att_tiles, dec_tiles);
  const int p_base = G - lstm_ctas >= p_tiles ? lstm_ctas : 0;
  const bool p_cta = cta >= p_base && cta < p_base + p_tiles;
  auto prenet = [&](int K, const float* W, const float* bias, const float* mask, float* dst,
                    auto pro) {
    bool first = true;
    for (int tile = cta - p_base; tile < p_tiles; tile += G, first = false)
      dense_tile<NB>(xs, K, W, P, tile * kCols, B, red, keep, [&] { if (first) pro(); },
                     [&](int n, int b, float v) {
                       v = fmaxf(v + bias[n], 0.f);
                       if (mask != nullptr) v = mask[b * P + n] != 0.f ? v / a.keep : 0.f;
                       dst[b * P + n] = v;
                     });
  };
  auto prenet2 = [&] {
    prenet(P, a.pw2, a.pb2, a.pmask2, a.xpre, [&] {
      wait_for(ctr + cX1, a.target);
      stage<NB>(xs, 0, a.x1, P, B);
    });
  };
  if (p_cta)
    prenet(a.Dm, a.pw1, a.pb1, a.pmask1, a.x1, [&] { stage<NB>(xs, 0, a.y_in, a.Dm, B); });
  arrive(ctr + cX1);
  if (p_base > 0) {  // layer 2 on the free CTAs, at once
    if (p_cta) prenet2();
    arrive(ctr + cXPre);
  }

  // 2. off-chain gate sums of the attention LSTM, from the previous state
  // only: [ctx, h_att] through the ctx rows of att_w_ih and att_w_hh
  if (cta < att_tiles) {
    int i = 0;
    for (int tile = cta; tile < att_tiles; tile += G, ++i)
      gate_sums<NB, WT>(xs, att_ih + tile * a.att_ts + (size_t)P * a.att_ld, Dc, xs + Dc * NB,
                        att_hh + tile * a.att_ts, H1, a.att_ld, a.att_gs, red,
                        part + i * 32 * NB, nullptr, stream, [&] {
                          if (i == 0) {
                            stage<NB>(xs, 0, a.ctx, Dc, B);
                            stage<NB>(xs, Dc, a.h_att, H1, B);
                          }
                        });
  }

  // 3. PreNet layer 2: x_pre = drop2(relu(x1 W2 + b2)), by the first CTAs
  // after their off-chain sums, when x1 is long written
  if (p_base == 0) {
    if (p_cta) prenet2();
    arrive(ctr + cXPre);
  }

  // 4. L2 prefetch (evict_last) of the chain's operands, each by its own
  // warp: they stay in L2 from step to step (the off-chain stream is
  // evict_first), so this matters for a first step
  prefetch_share(a.pw1, (size_t)a.Dm * P * sizeof(float), keep, 0);
  prefetch_share(a.pw2, (size_t)P * P * sizeof(float), keep, 32);
  prefetch_rows(att_ih, P, att_tiles, a.att_ts, a.att_ld, tm, keep, 64);
  prefetch_share(a.qw, (size_t)H1 * Dc * sizeof(float), keep, 96);
  prefetch_share(a.memory, (size_t)B * L * Dc * sizeof(float), keep, 128);
  prefetch_share(a.mel_w, (size_t)(H2 + Dc) * n_mel * sizeof(float), keep, 160);
  prefetch_rows(dec_ih, H1 + Dc, dec_tiles, a.dec_ts, a.dec_ld, tm, keep, 192);

  // 5. the decoder LSTM's off-chain sums: h_dec through dec_w_hh
  if (cta < dec_tiles) {
    int i = a.att_own;
    for (int tile = cta; tile < dec_tiles; tile += G, ++i)
      gate_sums<NB, WT>(xs, dec_hh + tile * a.dec_ts, H2, nullptr, nullptr, 0, a.dec_ld,
                        a.dec_gs, red, part + i * 32 * NB, nullptr, stream, [&] {
                          if (i == a.att_own) stage<NB>(xs, 0, a.h_dec, H2, B);
                        });
  }

  // 6. attention LSTM: the x_pre rows, plus the off-chain sums
  if (cta < att_tiles) {
    int i = 0;
    for (int tile = cta; tile < att_tiles; tile += G, ++i) {
      const CellIn ci = cell_in<NB>(H1, tile * kUnits, a.att_b, a.h_att, a.c_att, B);
      gate_sums<NB, WT>(xs, att_ih + tile * a.att_ts, P, nullptr, nullptr, 0, a.att_ld, a.att_gs,
                        red, gates, part + i * 32 * NB, keep, [&] {
                          if (i == 0) {
                            wait_for(ctr + cXPre, a.target);
                            stage<NB>(xs, 0, a.xpre, P, B);
                          }
                        });
      lstm_cell<NB>(gates, ci, H1, tile * kUnits, a.h_att_out, a.c_att_out, a.p_zoneout, B);
    }
  }
  arrive(ctr + cHAtt);

  // 7. query q = h_att Wq
  if (cta < q_tiles) {
    bool first = true;
    for (int tile = cta; tile < q_tiles; tile += G, first = false)
      dense_tile<NB>(xs, H1, a.qw, Dc, tile * kCols, B, red, keep,
                     [&] {
                       if (first) {
                         wait_for(ctr + cHAtt, a.target);
                         stage<NB>(xs, 0, a.h_att_out, H1, B);
                       }
                     },
                     [&](int n, int b, float v) { a.q[b * Dc + n] = v; });
  }
  arrive(ctr + cQ);

  // 8. energies and stay probabilities, one warp per (b, l); memory is
  // loaded before the wait for q
  if (cta * kWarps < B * L) {
    const int lane = t & 31;
    constexpr int kMaxDc4 = 8;  // float4s of a memory row a lane holds (Dc <= 1024)
    for (int item0 = cta * kWarps; item0 < B * L; item0 += G * kWarps) {
      const int item = item0 + (t >> 5);
      const bool valid = item < B * L;
      const int b = valid ? item / L : 0, l = valid ? item - b * L : 0;
      const float* m = a.memory + (size_t)(valid ? item : 0) * Dc;
      float4 mv[kMaxDc4];
#pragma unroll
      for (int i = 0; i < kMaxDc4; ++i) {
        const int d = lane * 4 + i * 128;
        mv[i] = d < Dc ? __ldg(reinterpret_cast<const float4*>(m + d))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (item0 == cta * kWarps) wait_for(ctr + cQ, a.target);
      const float* q = a.q + (size_t)b * Dc;
      float e = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDc4; ++i) {
        const int d = lane * 4 + i * 128;
        if (d < Dc) {
          const float4 qv = __ldcg(reinterpret_cast<const float4*>(q + d));
          e += mv[i].x * qv.x + mv[i].y * qv.y + mv[i].z * qv.z + mv[i].w * qv.w;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(kFull, e, o);
      if (lane == 0 && valid) {
        if (l == L - 1) e = 1e4f;  // sink: always stay at the last position
        const float h = e / 2.f;
        a.p[item] = (1.f + h / sqrtf(1.f + h * h)) / 2.f;
      }
    }
  }
  arrive(ctr + cP);

  // 9. new weights and context, per (b, 32 channels)
  if (cta < B * dt) {
    float* wn = xs;  // [L]
    for (int item = cta; item < B * dt; item += G) {
      const int b = item / dt, d0 = (item - b * dt) * 32;
      if (item == cta) wait_for(ctr + cP, a.target);
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
#pragma unroll 8
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
  arrive(ctr + cCtx);

  // 10. decoder LSTM: [h_att, ctx] through dec_w_ih, plus the off-chain sums
  if (cta < dec_tiles) {
    int i = a.att_own;
    for (int tile = cta; tile < dec_tiles; tile += G, ++i) {
      const CellIn ci = cell_in<NB>(H2, tile * kUnits, a.dec_b, a.h_dec, a.c_dec, B);
      gate_sums<NB, WT>(xs, dec_ih + tile * a.dec_ts, H1 + Dc, nullptr, nullptr, 0, a.dec_ld,
                        a.dec_gs, red, gates, part + i * 32 * NB, keep, [&] {
                          if (i == a.att_own) {
                            wait_for(ctr + cCtx, a.target);
                            stage<NB>(xs, 0, a.h_att_out, H1, B);
                            stage<NB>(xs, H1, a.ctx_out, Dc, B);
                          }
                        });
      lstm_cell<NB>(gates, ci, H2, tile * kUnits, a.h_dec_out, a.c_dec_out, a.p_zoneout, B);
    }
  }
  arrive(ctr + cHDec);

  // 11. projections of [h_dec, ctx]: mel frames (leaky ReLU) and stop logits
  if (cta < out_tiles) {
    bool first = true;
    auto pro = [&] {
      if (first) {
        wait_for(ctr + cHDec, a.target);
        stage<NB>(xs, 0, a.h_dec_out, H2, B);
        stage<NB>(xs, H2, a.ctx_out, Dc, B);
      }
    };
    for (int tile = cta; tile < out_tiles; tile += G, first = false) {
      if (tile < mel_tiles) {
        dense_tile<NB>(xs, H2 + Dc, a.mel_w, n_mel, tile * kCols, B, red, keep, pro,
                       [&](int n, int b, float v) {
                         v += a.mel_b[n];
                         a.y[b * n_mel + n] = v >= 0.f ? v : 0.01f * v;
                       });
      } else {
        dense_tile<NB>(xs, H2 + Dc, a.stop_w, a.r, (tile - mel_tiles) * kCols, B, red, keep, pro,
                       [&](int n, int b, float v) { a.s[b * a.r + n] = v + a.stop_b[n]; });
      }
    }
  }
}

template <int NB, typename WT>
cudaError_t launch(Params a, unsigned epoch, cudaStream_t stream) {
  auto kernel = taco_step_kernel<NB, WT>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  a.att_own = (a.H1 / kUnits + sms - 1) / sms;
  a.dec_own = (a.H2 / kUnits + sms - 1) / sms;
  const int k_max = std::max({a.Dm, a.P, a.Dc + a.H1, a.H2, a.H2 + a.Dc});
  a.xs_floats = (std::max(k_max * NB, a.L) + 3) / 4 * 4;
  const size_t smem = ((size_t)a.xs_floats + (size_t)(kWarps * 32 + 32) * NB +
                       (size_t)(a.att_own + a.dec_own) * 32 * NB) * sizeof(float);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  a.target = epoch * (unsigned)sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(sms), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename WT>
cudaError_t dispatch(const Params& a, unsigned epoch, cudaStream_t s) {
  if (a.B <= 1) return launch<1, WT>(a, epoch, s);
  if (a.B <= 2) return launch<2, WT>(a, epoch, s);
  if (a.B <= 4) return launch<4, WT>(a, epoch, s);
  return launch<8, WT>(a, epoch, s);
}

}  // namespace

// One step of at most 8 rows on `stream`. ptrs: a host array of kNumPtrs
// device pointers in the order of enum Ptr (pmask1/pmask2 may be null: no
// PreNet dropout; the four LSTM matrices fp32, or bf16 when weights_bf16,
// in the JAX layout, or with tile_major each LSTM's [W_ih; W_hh] in
// pack_streamed's [H / 8, K_ih + H, 32] layout, at kAttIH / kDecIH, with
// kAttHH / kDecHH unused; everything else fp32 and contiguous). scalars: host {p_zoneout, keep}.
// scratch holds B * (Dc + 2 P + L) floats. counters: 8 device uint32, zero
// before a stream's first launch and used by no other stream; epoch: the
// number of this launch among the stream's launches on them (1, 2, ...).
// Requires 1 <= B <= 8, H1 and H2 multiples of 8, Dc a multiple of 4 and at
// most 1024, and 16-byte aligned tensors. Returns the CUDA error (0 on success).
extern "C" int tts_taco_step_forward(const long long* ptrs, const float* scalars, int B, int L,
                                     int D_mel, int P, int Dc, int H1, int H2, int r,
                                     int weights_bf16, int tile_major, unsigned* counters,
                                     int epoch, void* stream) {
  if (B < 1 || B > 8 || L < 1 || D_mel < 1 || P < 1 || Dc < 4 || Dc % 4 || Dc > 1024 ||
      H1 < 8 || H1 % 8 || H2 < 8 || H2 % 8 || r < 1 || counters == nullptr)
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
  a.ctr = counters;
  a.target = 0;
  a.B = B; a.L = L; a.Dm = D_mel; a.P = P; a.Dc = Dc; a.H1 = H1; a.H2 = H2; a.r = r;
  a.xs_floats = a.att_own = a.dec_own = 0;
  a.tile_major = tile_major;
  if (tile_major) {
    const size_t wb = weights_bf16 ? 2 : 4;
    a.att_ts = 32LL * (P + Dc + H1);
    a.dec_ts = 32LL * (H1 + Dc + H2);
    a.att_hh = static_cast<const char*>(a.att_ih) + 32 * (size_t)(P + Dc) * wb;
    a.dec_hh = static_cast<const char*>(a.dec_ih) + 32 * (size_t)(H1 + Dc) * wb;
    a.att_ld = a.dec_ld = 32;
    a.att_gs = a.dec_gs = 8;
  } else {
    a.att_ts = a.dec_ts = kUnits;
    a.att_ld = 4 * H1;
    a.dec_ld = 4 * H2;
    a.att_gs = H1;
    a.dec_gs = H2;
  }
  a.p_zoneout = scalars[0];
  a.keep = scalars[1];
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned e = static_cast<unsigned>(epoch);  // the launch count's low 32 bits
  return (int)(weights_bf16 ? dispatch<__nv_bfloat16>(a, e, s) : dispatch<float>(a, e, s));
}
