// LLTM gated cell forward on the H100: the gate product on the tensor cores
// in 3xTF32, K split over a 4-CTA cluster, and the cell update.
//
// Replaces the TPU kernel torch_tts_tpu/kernels/gated_cell.py:81
// (_lltm_fwd_pallas -> _fwd_kernel). Contract of the Python wrapper
// (torch_tts_tpu_torch/kernels/gated_cell.py, whose kernel_args casts every
// input to contiguous fp32 as the JAX wrapper does): x [B, I], w [3H, H + I],
// bias [3H], h and c [B, H] -> new_h, new_c [B, H] and the raw gates [B, 3H]
// (the backward's residual), any B >= 1, I >= 0, H >= 1, as
//   gates = [h, x] @ w^T + bias
//   ig = sigmoid(gates[:, :H]), og = sigmoid(gates[:, H:2H])
//   cand = elu(gates[:, 2H:]) with elu(z) = z > 0 ? z : exp(min(z, 0)) - 1
//   new_c = c + cand * ig, new_h = tanh(new_c) * og
//
// Bound on the H100 (the function's bytes, each input read once and each
// output written once, at 3.35 TB/s; its products at 3xTF32's 165 TFLOP/s):
// B=16, I=32, H=128 (the PyTorch extension tutorial's LLTM) 0.00009 ms of
// bytes (0.31 MB; 2.0 MFLOP); B=512, I=32, H=128 0.00064 ms of bytes
// (2.15 MB; 63 MFLOP); B=64, I=256, H=1024 0.0053 ms of bytes (17.6 MB, of
// them 15.7 MB of weights; 0.50 GFLOP, 0.0030 ms at 3xTF32 and 0.0075 ms
// at the fp32 SIMT rate). At the tutorial's shape the kernel is bound by
// its launch and the latency of its one pass, at the large shape by bytes.
// Its times are in PERF.md (chip_smoke.py). At the large shapes the
// products, the pushes and the epilogue set the time: in A/B runs of
// throwaway variants, removing the copies saved less than removing the
// products.
//
// Design. A CTA (four warps) owns NT tiles of 8 state units (24 weight rows
// a tile: the input, output and candidate gates of the same 8 units, three
// n8 tiles of mma.sync.m16n8k8), a row group of MT 16-row tiles of B (MT
// up to 4), and a quarter of K: the four CTAs of a cluster take the four
// quarters of the same units and rows. NT is the largest of 4, 2, 1 that
// still gives 128 CTAs (one an SM): 1 at B=16, H=128 (64 CTAs), 4 at
// B=64, H=1024 and at B=512, H=128 (128 CTAs, one wave). Targets of 256
// and 512 CTAs (smaller NT: more [h, x] rows copied for each weight row)
// were slower at both large shapes in an A/B run.
// - The latency chain: no thread walks K. K goes in 16-deep steps over the
//   cluster's CTAs and, when a CTA has fewer unit tiles than warps, over
//   its warps too (warp w takes unit tile w % NT and every (4 / NT)-th step
//   of its CTA's quarter): at the tutorial's shape a warp runs one step of
//   18 products or none. Partial sums go by st.shared::cluster to the CTA
//   that owns their rows (rank q owns rows [q R / 4, (q + 1) R / 4) of the
//   group), a cluster barrier, and the owner sums them in a fixed order
//   (rank, then warp), so two runs give the same bits; no atomics. Bias
//   and c are loaded while the partial sums travel.
// - One round trip before any product: every thread issues its 16-byte
//   cp.async copies (4-byte ones when H or I is not a multiple of 4, or a
//   pointer is not 16-byte aligned) of the CTA's weight rows and [h, x]
//   rows into a ring of 4 slots of two steps each. A quarter of at most 6
//   steps (the tutorial's 2-3) is copied whole, then one wait; a longer one
//   streams through the ring, three slots in flight (cp.async.wait_group,
//   a block barrier a slot); 8 slots, or 4-step slots, were slower in an
//   A/B run. A slot holds each step as [rows][16 floats]:
//   a lane reads its fragments as float4s (k = 4 t4 .. 4 t4 + 3, the two
//   products of a step taking k pairs (4 t4 + 2 h, 4 t4 + 2 h + 1) in A and
//   B alike), and a quarter warp's two rows are 128 contiguous bytes, so
//   no bank conflict.
// - 3xTF32 products (a_lo b_hi, a_hi b_lo, a_hi b_hi, as in
//   wgmma_tf32.cuh), the products of every two steps added to the
//   thread's fp32 sums: 1xTF32 misses the fp32 plain version's 1e-5, and
//   the tensor core's own accumulator adds, over all of K, brought the
//   gates' error at B=64, I=256, H=1024 close to 1e-5. The split is in integer operations
//   (cvt.rna runs on the slower conversion unit, and was slower in an A/B
//   run at the large shapes). A warp covers every row tile of its group, so
//   each weight fragment is split once. At the large shape the products
//   are 0.0030 ms at the 3xTF32 rate under 0.0053 ms of bytes, where the
//   fp32 SIMT rate (0.0075 ms) would make them the bound; a SIMT-FMA
//   variant of this kernel, timed against it in A/B runs, was slower at
//   all three shapes, by the most at the large ones.
// - The epilogue in registers: the m16n8 accumulator puts the three gates
//   of one (row, unit) in one thread, and the owner's thread for that
//   (row, unit) sums its partials of all three, so sigmoid, ELU, the cell
//   update and tanh need no exchange.
// - The shapes (MT, NT) are template parameters, so every index is
//   computed with constant divisors.
// - cudaFuncSetAttribute runs once per device, kernel and size.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCluster = 4;            // CTAs a cluster: the K quarters
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnits = 8;              // state units a unit tile
constexpr int kStep = 16;              // K of a step: two m16n8k8 products
constexpr int kChunk = 2;              // steps a ring slot
constexpr int kSlots = 4;              // ring slots, kSlots - 1 in flight
constexpr int kMaxTiles = 4;           // 16-row tiles of a row group
constexpr int kFillCtas = 128;         // CTAs that NT leaves at least, where it can
constexpr int kMaxDevices = 64;
constexpr int kKernels = 2 * kMaxTiles * 3;  // (16-byte copies, MT, NT) instantiations

struct LltmArgs {
  const float* x;
  const float* w;
  const float* bias;
  const float* h;
  const float* c;
  float* new_h;
  float* new_c;
  float* gates;
  int B, I, H;
};

// A CTA's shape: MT row tiles, NT unit tiles.
template <int MT, int NT>
struct Shape {
  static constexpr int R = 16 * MT;                 // rows of a row group
  static constexpr int RO = R / kCluster;           // rows a CTA of the cluster owns
  static constexpr int WROWS = 3 * kUnits * NT;     // weight rows, and gate columns
  static constexpr int ROWS = WROWS + R;            // rows of a step in a slot
  static constexpr int SUB = kWarps / NT;           // K sub-parts over the warps
  static constexpr int SLOT = kChunk * ROWS * kStep;  // floats of a ring slot
  // the receive buffer: [rank][sub-part][RO rows][WROWS gate columns]
  static constexpr int RECV = kCluster * SUB * RO * WROWS;
  static constexpr int PAIRS = (RO * NT * kUnits + kThreads - 1) / kThreads;  // a thread's (row, unit)s
  static constexpr size_t smem_bytes() { return (size_t)(kSlots * SLOT + RECV) * sizeof(float); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes from global memory into shared memory; src_bytes 0
// writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// d += a b, a the 16x8 tf32 fragment of the warp's row tile, b the 8x8 one
// of a gate's 8 units (a[0] = A(g, t4), a[1] = A(g + 8, t4), a[2] = A(g,
// t4 + 4), a[3] = A(g + 8, t4 + 4); b0 = B(t4, g), b1 = B(t4 + 4, g);
// d[0..1] at (g, 2 t4 + {0, 1}), d[2..3] at (g + 8, ...))
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cvt.rna.tf32.f32 in integer operations (the same bits for finite v, as
// kernels/mrf_fused.py:split_tf32 computes them on the CPU): half a tf32
// ulp added to the magnitude, the low 13 bits cleared. The ALU does it at
// four times the conversion unit's rate.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// One 16-deep step of a warp in 3xTF32 (a_lo b_hi, a_hi b_lo, a_hi b_hi,
// as wgmma_tf32.cuh orders them), added to d: st points at the step's
// [rows][16] block, lane column 4 t4; the warp's weight rows are
// wrow + gi * 8 + g, its row tiles' rows xrow + 16 mi + g (+ 8). Product hh
// takes k = 4 t4 + 2 hh (fragment column t4) and 4 t4 + 2 hh + 1 (column
// t4 + 4).
template <int MT>
__device__ __forceinline__ void mma_step(float (&d)[MT][3][4], const float* st, int wrow, int xrow,
                                         int g) {
  uint32_t bh[3][4], bl[3][4];
#pragma unroll
  for (int gi = 0; gi < 3; ++gi) {
    const float4 w = *reinterpret_cast<const float4*>(st + (wrow + gi * kUnits + g) * kStep);
    split_tf32(w.x, bh[gi][0], bl[gi][0]);
    split_tf32(w.y, bh[gi][1], bl[gi][1]);
    split_tf32(w.z, bh[gi][2], bl[gi][2]);
    split_tf32(w.w, bh[gi][3], bl[gi][3]);
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const float4 xa = *reinterpret_cast<const float4*>(st + (xrow + mi * 16 + g) * kStep);
    const float4 xb = *reinterpret_cast<const float4*>(st + (xrow + mi * 16 + g + 8) * kStep);
    const float a0[4] = {xa.x, xa.y, xa.z, xa.w}, a1[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t ah[4], al[4];
      split_tf32(a0[2 * hh], ah[0], al[0]);
      split_tf32(a1[2 * hh], ah[1], al[1]);
      split_tf32(a0[2 * hh + 1], ah[2], al[2]);
      split_tf32(a1[2 * hh + 1], ah[3], al[3]);
#pragma unroll
      for (int gi = 0; gi < 3; ++gi) {
        mma_tf32(d[mi][gi], al, bh[gi][2 * hh], bh[gi][2 * hh + 1]);
        mma_tf32(d[mi][gi], ah, bl[gi][2 * hh], bl[gi][2 * hh + 1]);
        mma_tf32(d[mi][gi], ah, bh[gi][2 * hh], bh[gi][2 * hh + 1]);
      }
    }
  }
}

// acc += d by fp32 adds, d = 0: the tensor core's accumulator adds do not
// round to nearest: over a K of 1280 (480 of them) the gates' error came
// close to 1e-5; folded every two steps (12 adds) it is at the level of the
// fp32 plain version's own summation order (PERF.md).
template <int MT>
__device__ __forceinline__ void fold(float (&acc)[MT][3][4], float (&d)[MT][3][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int gi = 0; gi < 3; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][gi][e] += d[mi][gi][e];
        d[mi][gi][e] = 0.f;
      }
}

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

// element k of a weight row (xrow nullptr) or of [h, x] (k < K)
__device__ __forceinline__ const float* source(const float* row, const float* xrow, int k, int H) {
  return xrow == nullptr || k < H ? row + k : xrow + (k - H);
}

// Elements k .. k + 3 of a row into dst: zeros past K or for a missing
// row (nullptr); `any` is a valid address for the zero-fill.
template <bool kVec>
__device__ __forceinline__ void copy_quad(float* dst, const float* row, const float* xrow, int k,
                                          int K, int H, const float* any) {
  if (kVec) {  // H % 4 == 0 and K % 4 == 0: the quad is all in or all out, all h or all x
    const bool in = row != nullptr && k < K;
    cp_async16(dst, in ? source(row, xrow, k, H) : any, in ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = row != nullptr && k + e < K;
      cp_async4(dst + e, in ? source(row, xrow, k + e, H) : any, in ? 4 : 0);
    }
  }
}

template <bool kVec, int MT, int NT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
lltm_forward_kernel(const LltmArgs a) {
  using S = Shape<MT, NT>;
  extern __shared__ __align__(16) float smem[];
  const int K = a.H + a.I;
  const int rank = (int)cluster_rank();
  const int j0 = (blockIdx.x / kCluster) * NT * kUnits;  // first unit
  const int b0 = blockIdx.y * S::R;                       // first row of the row group
  const int steps = (K + kStep - 1) / kStep;
  const int s0 = rank * steps / kCluster, n = (rank + 1) * steps / kCluster - s0;
  const int nch = (n + kChunk - 1) / kChunk;
  float* ring = smem;
  float* recv = smem + kSlots * S::SLOT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // every CTA of the cluster runs before any partial goes to it (waited
  // on before the pushes)
  cluster_arrive_relaxed();

  // a slot's step holds the weight rows r (unit tile r / 24, gate r % 24 /
  // 8, unit r % 8), then the row group's [h, x] rows; a thread copies quad
  // e of each part (step e / (rows 4), row e / 4 % rows, floats 4 (e % 4)
  // on)
  auto stage = [&](int ch) {
    float* slot = ring + (ch % kSlots) * S::SLOT;
    const int kc = (s0 + ch * kChunk) * kStep, left = n - ch * kChunk;
#pragma unroll
    for (int e = tid; e < kChunk * S::WROWS * 4; e += kThreads) {
      const int ss = e / (S::WROWS * 4), r = e / 4 % S::WROWS, q = e % 4;
      const int j = j0 + r / (3 * kUnits) * kUnits + r % kUnits;
      if (ss < left)
        copy_quad<kVec>(slot + (ss * S::ROWS + r) * kStep + 4 * q,
                        j < a.H ? a.w + (size_t)(r % (3 * kUnits) / kUnits * a.H + j) * K : nullptr,
                        nullptr, kc + ss * kStep + 4 * q, K, a.H, a.h);
    }
#pragma unroll
    for (int e = tid; e < kChunk * S::R * 4; e += kThreads) {
      const int ss = e / (S::R * 4), r = e / 4 % S::R, q = e % 4;
      const bool in = b0 + r < a.B;
      if (ss < left)
        copy_quad<kVec>(slot + (ss * S::ROWS + S::WROWS + r) * kStep + 4 * q,
                        in ? a.h + (size_t)(b0 + r) * a.H : nullptr,
                        in ? a.x + (size_t)(b0 + r) * a.I : nullptr, kc + ss * kStep + 4 * q, K,
                        a.H, a.h);
    }
  };

  // warp: unit tile nt, K sub-part p (every SUB-th step of the quarter),
  // every row tile
  const int nt = warp % NT, p = warp / NT;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[MT][3][4] = {}, d[MT][3][4] = {};
  if (nch < kSlots) {  // the whole quarter in one round trip
    for (int ch = 0; ch < nch; ++ch) stage(ch);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int js = p, i = 1; js < n; js += S::SUB, ++i) {
      mma_step<MT>(d, ring + js / kChunk * S::SLOT + (js % kChunk) * S::ROWS * kStep + 4 * t4,
                   nt * 3 * kUnits, S::WROWS, g);
      if (i % kChunk == 0) fold(acc, d);
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < kSlots - 1; ++ch) {
      stage(ch);
      cp_async_commit();
    }
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<kSlots - 2>();
      __syncthreads();  // slot ch landed for every thread; slot ch - 1 is free
      if (ch + kSlots - 1 < nch) stage(ch + kSlots - 1);
      cp_async_commit();
      const float* slot = ring + (ch % kSlots) * S::SLOT;
#pragma unroll
      for (int ss = 0; ss < kChunk; ++ss) {
        const int js = ch * kChunk + ss;
        if (js < n && js % S::SUB == p)
          mma_step<MT>(d, slot + ss * S::ROWS * kStep + 4 * t4, nt * 3 * kUnits, S::WROWS, g);
      }
      fold(acc, d);
    }
  }
  fold(acc, d);

  // the epilogue's (row, unit) pairs of this thread, and their bias and c,
  // loaded while the partial sums travel
  float bias[S::PAIRS][3], c_old[S::PAIRS];
#pragma unroll
  for (int pi = 0; pi < S::PAIRS; ++pi) {
    const int pair = tid + pi * kThreads, lr = pair / (NT * kUnits);
    const int bo = b0 + rank * S::RO + lr, j = j0 + pair % (NT * kUnits);
    const bool live = lr < S::RO && bo < a.B && j < a.H;
#pragma unroll
    for (int gi = 0; gi < 3; ++gi) bias[pi][gi] = live ? a.bias[gi * a.H + j] : 0.f;
    c_old[pi] = live ? a.c[(size_t)bo * a.H + j] : 0.f;
  }

  // partial sums to the owners of their rows, then one cluster barrier
  cluster_wait();
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gr = mi * 16 + g + 8 * hh;
      const uint32_t at = cluster_addr(
          recv + ((rank * S::SUB + p) * S::RO + gr % S::RO) * S::WROWS + nt * 3 * kUnits,
          (uint32_t)(gr / S::RO));
#pragma unroll
      for (int gi = 0; gi < 3; ++gi)
        st_cluster(at + (uint32_t)(gi * kUnits + 2 * t4) * 4u, acc[mi][gi][2 * hh],
                   acc[mi][gi][2 * hh + 1]);
    }
  cluster_arrive();
  cluster_wait();

#pragma unroll
  for (int pi = 0; pi < S::PAIRS; ++pi) {
    const int pair = tid + pi * kThreads, lr = pair / (NT * kUnits), uu = pair % (NT * kUnits);
    const int bo = b0 + rank * S::RO + lr, j = j0 + uu;
    if (lr >= S::RO || bo >= a.B || j >= a.H) continue;
    const float* rp = recv + lr * S::WROWS + uu / kUnits * 3 * kUnits + uu % kUnits;
    float z[3];
#pragma unroll
    for (int gi = 0; gi < 3; ++gi) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster * S::SUB; ++r) sum += rp[r * S::RO * S::WROWS + gi * kUnits];
      z[gi] = sum + bias[pi][gi];
    }
    float* gb = a.gates + (size_t)bo * 3 * a.H;
    gb[j] = z[0];
    gb[a.H + j] = z[1];
    gb[2 * a.H + j] = z[2];
    const float ig = sigmoid(z[0]), og = sigmoid(z[1]);
    const float cand = z[2] > 0.f ? z[2] : expf(fminf(z[2], 0.f)) - 1.f;
    const float nc = c_old[pi] + cand * ig;
    a.new_c[(size_t)bo * a.H + j] = nc;
    a.new_h[(size_t)bo * a.H + j] = tanhf(nc) * og;
  }
}

// The launch floor: launched as the kernel is, doing nothing.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
lltm_floor_kernel(int) {}

// A launch's plan: the kernel, its grid and shared memory.
struct Launch {
  void (*kernel)(LltmArgs);
  int index;  // of the kernel among the instantiations
  dim3 grid;
  size_t smem;
};

template <bool kVec, int MT, int NT>
Launch launch_of(int B, int H) {
  const int tiles = (H + kUnits - 1) / kUnits;
  return {lltm_forward_kernel<kVec, MT, NT>, (kVec * kMaxTiles + MT - 1) * 3 + (NT == 1 ? 0 : NT / 2),
          dim3(kCluster * ((tiles + NT - 1) / NT), (B + 16 * MT - 1) / (16 * MT)),
          Shape<MT, NT>::smem_bytes()};
}

template <bool kVec, int MT>
Launch launch_nt(int B, int H, int nt) {
  return nt == 4 ? launch_of<kVec, MT, 4>(B, H)
                 : nt == 2 ? launch_of<kVec, MT, 2>(B, H) : launch_of<kVec, MT, 1>(B, H);
}

template <bool kVec>
Launch launch_mt(int B, int H, int mt, int nt) {
  switch (mt) {
    case 1: return launch_nt<kVec, 1>(B, H, nt);
    case 2: return launch_nt<kVec, 2>(B, H, nt);
    case 3: return launch_nt<kVec, 3>(B, H, nt);
    default: return launch_nt<kVec, 4>(B, H, nt);
  }
}

// MT: the row tiles of B up to 4; NT: the largest of 4, 2, 1 whose grid
// keeps kFillCtas CTAs (else 1)
Launch plan(int B, int H, bool vec) {
  const int mt = (B + 15) / 16 < kMaxTiles ? (B + 15) / 16 : kMaxTiles;
  const int tiles = (H + kUnits - 1) / kUnits, groups = (B + 16 * mt - 1) / (16 * mt);
  int nt = 4;
  while (nt > 1 && (tiles + nt - 1) / nt * kCluster * groups < kFillCtas) nt /= 2;
  return vec ? launch_mt<true>(B, H, mt, nt) : launch_mt<false>(B, H, mt, nt);
}

// The dynamic shared memory set so far per device and kernel (the
// instantiations, then the launch floor).
size_t smem_set[kMaxDevices][kKernels + 1];

// Dynamic shared memory of `kernel` set once per device, kernel and size
// (the largest set so far covers every smaller launch).
template <class Kernel>
cudaError_t ensure_smem(Kernel kernel, int which, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem_set[dev][which] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) smem_set[dev][which] = bytes;
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// One LLTM cell forward on `stream`. Returns the CUDA error (0 on success);
// cudaErrorInvalidValue for B < 1, I < 0 or H < 1.
extern "C" int tts_lltm_forward(const float* x, const float* w, const float* bias,
                                const float* h, const float* c, float* new_h, float* new_c,
                                float* gates, int B, int I, int H, void* stream) {
  if (B < 1 || I < 0 || H < 1) return (int)cudaErrorInvalidValue;
  const bool vec = H % 4 == 0 && I % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(h);
  const Launch l = plan(B, H, vec);
  cudaError_t err = ensure_smem(l.kernel, l.index, l.smem);
  if (err != cudaSuccess) return (int)err;
  const LltmArgs a{x, w, bias, h, c, new_h, new_c, gates, B, I, H};
  l.kernel<<<l.grid, kThreads, l.smem, reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// An empty kernel with the forward's grid, cluster, block and shared memory
// at this shape: the device time of the launch alone.
extern "C" int tts_lltm_launch_floor(int B, int I, int H, void* stream) {
  if (B < 1 || I < 0 || H < 1) return (int)cudaErrorInvalidValue;
  const Launch l = plan(B, H, H % 4 == 0 && I % 4 == 0);
  cudaError_t err = ensure_smem(lltm_floor_kernel, kKernels, l.smem);
  if (err != cudaSuccess) return (int)err;
  lltm_floor_kernel<<<l.grid, kThreads, l.smem, reinterpret_cast<cudaStream_t>(stream)>>>(0);
  return (int)cudaGetLastError();
}
