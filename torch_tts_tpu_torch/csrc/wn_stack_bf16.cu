// The bf16 WaveNet (WN) layer group kernels of bf16 training
// (`train.use_bf16`): the forward (all L gated layers of a group on a time
// window held in shared memory, with the saves for the backward) and the
// backward (the layers in reverse over the whole sequence).
//
// Replace the TPU kernels torch_tts_tpu/kernels/wn_stack.py (wn_group ->
// _wn_group_pallas -> _wn_fwd_kernel, and _wn_group_pallas_bwd ->
// _wn_bwd_kernel) on bf16 tensors; wn_stack.cu holds the fp32 kernels, whose
// contract and algorithm these follow (see there). Contract of the Python
// wrapper (torch_tts_tpu_torch/kernels/wn_stack.py): x [B, T, H], mask
// [B, T, 1], gl [B, L, 2H] or null, w_in [L, k, H, 2H], b_in [L, 2H], w_rs
// [L, H, 2H], b_rs [L, 2H], all bf16 -> x_out and skip * mask [B, T, H] in
// bf16, and the gradients in bf16. H = 192 (every shipped config).
//
// Numerics, as the TPU kernel's: every tensor-core operand is bf16, rounded
// once, and every product accumulates in fp32; the residual x and the skip
// sums stay fp32 through the group, the pre-activation x_in is saved in
// fp32 and d_x between layers is fp32. What only the tensor cores read is
// stored in bf16: the saved layer inputs x_i, and in the backward acts,
// d_xin, d_x * m and d_sk * m.
//
// Bound on the H100: operations. At the posterior encoder's training shape
// (B=8, T=1000, H=192, L=4, k=5) the forward is 28.3 GFLOP, 0.0286 ms at
// bf16's 989 TFLOP/s, the backward 56.6 GFLOP, 0.0573 ms.
//
// Both are built from the same pieces: operand tiles brought into a ring of
// shared-memory slots by TMA (cp.async.bulk.tensor, 128-byte swizzle),
// completing on each slot's full mbarrier; a producer (a warp, in the
// forward a warpgroup) one thread of which issues the loads ahead and waits
// on each slot's empty mbarrier before refilling it; two consumer
// warpgroups that run wgmma bf16 on the tiles that have landed,
// each chunk's products kept in flight while the next chunk's are issued
// (wgmma.wait_group 1).
//
// Forward (wn_fwd_bf16_kernel):
// - A cluster of 3 CTAs splits the 2H columns, each owning 64 channels: its
//   tanh and sigmoid columns in the conv, its residual and skip columns in
//   the 1x1 (a 128-column product whose two 64-column halves meet in
//   matching accumulator registers, so the gate forms with no exchange).
// - A CTA holds a window of 128 rows (two m64 warpgroups) and owns the
//   T0 = 128 - 2 L (k - 1) / 2 frames in its middle (112 at k=5, L=4: a halo
//   share of 12.5%). Shared memory holds the x window in bf16 over all H
//   channels, with (k - 1) / 2 zero rows a side, and acts in bf16; the
//   conv's A fragments are taken from the window shifted by the tap through
//   ldmatrix (any row address), the 1x1's from acts. The residual x of the
//   CTA's own channels stays in fp32 beside them.
// - The weights come straight from w_in and w_rs by TMA: each 64-deep chunk
//   is two 64 x 64 boxes (the CTA's channels in each half), read by wgmma
//   MN-major from a four-slot ring. No packing pass.
// - Each layer's acts and updated x (bf16) go to every CTA of the cluster
//   through distributed shared memory, each followed by a cluster barrier;
//   the producer takes part in them split (arrive, then wait after the
//   next layer's loads are issued), so its loads run ahead across them.
// - The producer is a whole warpgroup (one thread issues the loads), so
//   that the consumers can take its registers (setmaxnreg).
// - SAVE also writes each layer's input x_i (bf16, the window's values) and
//   its pre-activation x_in (fp32) on the owned rows and channels.
//
// Backward (bwd_tiles_kernel): per layer i, with r a frame, the four
// products of wn_stack.cu's backward as tiled GEMMs of 128 rows (64 a
// warpgroup) x 192 columns, K in chunks of 64:
//   ActsGrad      d_acts = [d_x m, d_sk m] @ w_rs^T, its epilogue writes
//                 d_xin [R, 2H] and acts [R, H] in bf16
//   InputGrad     d_x = d_x m + sum_tau d_xin[r + p - tau] @ w_in[tau]^T, its
//                 epilogue writes d_x (fp32) and d_x m (bf16, the next
//                 layer's operand), or d_x (bf16) at layer 0
//   WeightInGrad  per item z: [x_i shifted by each tap; ones]^T @ d_xin
//   WeightRsGrad  per item z: [acts; ones]^T @ [d_x m, d_sk m]
// - Every operand is a TMA box of a bf16 tensor map over [B, T, C]: a tap's
//   shift is the box's T coordinate and an item's edges read as zero, as the
//   shifted reads need. The weight-gradient products (K = frames) read both
//   operands MN-major. Their rows of ones (the bias and d_gl sums) are a
//   constant tile in shared memory.
// - The weight products are split-K by batch item into fp32 partials, which
//   a reduction sums in item order: two runs give the same bits. The
//   partials alternate between two buffers by layer, so that a layer's
//   reduction can run beside the next layer's products.
// - Launches a call: one that forms d_xo m and d_sk m, ActsGrad of the top
//   layer, then per layer the three gradient products in one grid (with
//   the reduction of the layer above in CTAs past its tiles) and ActsGrad
//   of the layer below, then the last reduction: 2 L + 2 (10 at L=4).
//   ActsGrad takes 96-column tiles: twice the CTAs, since its epilogue,
//   which reads x_in in fp32, sets its time.
// - Each no faster on the H100 in throwaway A/B runs: TMA multicast of B
//   across 2-CTA clusters of tiles that share it (slower), a fifth ring
//   slot, an L2 prefetch of ActsGrad's x_in, programmatic dependent launch.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_bf16.cuh"

namespace {

using namespace tts_wgmma;

constexpr int kH = 192;              // hidden channels
constexpr int kMaxTaps = 15;
constexpr int kChunk = 64;           // K of a staged chunk, the rows of a swizzle atom
constexpr int kBox = 64 * 64 * 2;    // bytes of a 64 x 64 bf16 box
constexpr int kConsumers = 2;        // consumer warpgroups a CTA
constexpr int kThreads = kConsumers * 128 + 32;  // and the producer warp

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float bf16_to_f(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }
__device__ __forceinline__ float2 ld_bf16x2(const uint16_t* p) {
  const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(bf16_lo(v), bf16_hi(v));
}
__device__ __forceinline__ void st_bf16x2(uint16_t* p, float2 v) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t align1024(uint32_t a) { return (a + 1023) & ~1023u; }

// distributed shared memory: p as seen in CTA `rank` of the cluster, a
// 4-byte store there; the cluster barrier, whole or split
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// Tensor maps (host)

// a bf16 tensor [items, rows, cols] (items 1: a matrix) as boxes of 64
// columns x box_rows rows of one item, 128-byte swizzled; out-of-bounds
// elements read as zero
bool make_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows, uint64_t items,
              uint32_t box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, items};
  const cuuint64_t strides[2] = {cols * 2, cols * rows * 2};
  const cuuint32_t box[3] = {64, box_rows, 1}, elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Forward

constexpr int kCluster = 3;                 // CTAs that split the 2H columns
constexpr int kNC = kH / kCluster;          // channels a CTA owns
constexpr int kWin = 128;                   // window rows, 64 a consumer warpgroup
constexpr int kFwdSlots = 4;
constexpr int kFwdSlot = 2 * kBox;          // a chunk: 64 K rows x (tanh | sigmoid) 64 columns
constexpr int kXP = kH + 8;                 // bf16 a row of the x window and of acts
// two consumer warpgroups and a producer warpgroup, whose registers the
// consumers take (setmaxnreg): 2 x 128 x 232 + 128 x 40 <= 65,536. At the
// 168 registers a thread that 384 threads get without it, ptxas
// serialized the forward's wgmma for want of registers.
constexpr int kFwdThreads = 3 * 128;
constexpr int kRP = kNC + 8;                // floats a row of the residual x

size_t fwd_smem_bytes(int k) {
  return 1024 + (size_t)kFwdSlots * kFwdSlot + (size_t)(kWin + k - 1) * kXP * 2 +
         (size_t)kWin * kXP * 2 + (size_t)kWin * kRP * 4 + kWin * 4 + 2 * kFwdSlots * 8;
}

struct FwdArgs {
  const uint16_t* x;
  const uint16_t* mask;
  const uint16_t* gl;  // or null
  const uint16_t* b_in;
  const uint16_t* b_rs;
  uint16_t* x_out;
  uint16_t* skip_out;
  uint16_t* save_x;  // [L, B, T, H] or null
  float* save_xin;   // [L, B, T, 2H] or null
  int B, T, L, k, T0;
};

template <bool SAVE>
__global__ void __launch_bounds__(kFwdThreads, 1)
wn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap w_in_map,
                   const __grid_constant__ CUtensorMap w_rs_map, const __grid_constant__ FwdArgs a) {
  constexpr int H2 = 2 * kH, J2 = kNC / 8, CPK = kH / kChunk;
  const int rank = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int T = a.T, L = a.L, k = a.k, T0 = a.T0, B = a.B;
  const int p = (k - 1) / 2, halo = L * p;
  const int win_start = tile * T0 - halo;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ch0 = rank * kNC;  // the CTA's first channel

  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = align1024(smem_addr(smem_raw));  // kFwdSlots x kFwdSlot
  uint8_t* base = smem_raw + (ring - smem_addr(smem_raw));
  uint16_t* xw = reinterpret_cast<uint16_t*>(base + kFwdSlots * kFwdSlot);  // [kWin + 2p, kXP]
  uint16_t* acts = xw + (kWin + 2 * p) * kXP;                                // [kWin, kXP]
  float* xres = reinterpret_cast<float*>(acts + kWin * kXP);                 // [kWin, kRP]
  float* ms = xres + kWin * kRP;                                             // [kWin]
  uint64_t* full = reinterpret_cast<uint64_t*>(ms + kWin);
  uint64_t* empty = full + kFwdSlots;

  if (tid == 0) {
    for (int i = 0; i < kFwdSlots; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    fence_barrier_init();
  }
  // the x window in bf16 (row i holds window row i - p; zero outside [0, T)
  // and in the pad rows), the residual x of the CTA's channels in fp32, the mask
  {
    const uint16_t* xb = a.x + (size_t)b * T * kH;
    for (int i = tid; i < (kWin + 2 * p) * (kH / 8); i += kFwdThreads) {
      const int row = i / (kH / 8), c8 = i % (kH / 8), pos = win_start + row - p;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row >= p && row < kWin + p && pos >= 0 && pos < T)
        v = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)pos * kH) + c8);
      *reinterpret_cast<uint4*>(xw + row * kXP + 8 * c8) = v;
    }
    for (int i = tid; i < kWin * (kNC / 2); i += kFwdThreads) {
      const int r = i / (kNC / 2), c = 2 * (i % (kNC / 2)), pos = win_start + r;
      const float2 v = (pos >= 0 && pos < T) ? ld_bf16x2(xb + (size_t)pos * kH + ch0 + c)
                                             : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(xres + r * kRP + c) = v;
    }
    for (int r = tid; r < kWin; r += kFwdThreads) {
      const int pos = win_start + r;
      ms[r] = (pos >= 0 && pos < T) ? bf16_to_f(__ldg(a.mask + (size_t)b * T + pos)) : 0.f;
    }
  }
  cluster_sync();  // the window and the barriers are in place, and every CTA of the cluster runs

  const int conv_chunks = k * CPK;
  if (warp >= 2 * 4) {  // --- the producer warpgroup: the weights' chunks, layer by layer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    int s = 0;
    auto load = [&](const CUtensorMap* map, int row) {
      if (tid == 2 * 128) {
        const int slot = s % kFwdSlots;
        if (s >= kFwdSlots) mbar_wait(empty + slot, ((s / kFwdSlots) & 1) ^ 1);
        mbar_expect(full + slot, kFwdSlot);
        tma_3d(ring + slot * kFwdSlot, map, ch0, row, 0, full + slot);
        tma_3d(ring + slot * kFwdSlot + kBox, map, kH + ch0, row, 0, full + slot);
      }
      __syncwarp();
      ++s;
    };
    for (int l = 0; l < L; ++l) {
      for (int c = 0; c < conv_chunks; ++c)
        load(&w_in_map, (l * k + c / CPK) * kH + (c % CPK) * kChunk);
      if (l > 0) cluster_wait();  // x of layer l is in place
      cluster_arrive();
      for (int c = 0; c < CPK; ++c) load(&w_rs_map, l * kH + c * kChunk);
      cluster_wait();  // acts of layer l are in place
      if (l + 1 < L) cluster_arrive();
    }
    return;
  }

  // --- the consumer warpgroups: window rows 64 w .. 64 w + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int m0 = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's first window row
  const bool leader = (tid & 127) == 0;
  // ldmatrix.x4: lanes 0-15 give rows m0 + lane of the fragment's first 8
  // columns, lanes 16-31 of its second 8
  const uint32_t a_lane = ((m0 + (lane & 15)) * kXP + (lane >> 4) * 8) * 2;
  const uint32_t xw_a = smem_addr(xw) + a_lane, acts_a = smem_addr(acts) + a_lane;
  uint32_t acts_at[kCluster], xw_at[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) {
    acts_at[q] = cluster_addr(acts, q);
    xw_at[q] = cluster_addr(xw, q);
  }

  int s = 0;  // chunks consumed, in the producer's order
  uint32_t fa[4][4], fb[4][4];
  // one chunk of a product into acc: its A fragments from `addr`, the
  // weights from the ring
  auto issue = [&](float (&acc)[64], uint32_t addr, uint32_t (&f)[4][4], bool zero) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(f[kk], addr + 32 * kk);
    const int slot = s % kFwdSlots;
    mbar_wait(full + slot, (s / kFwdSlots) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128<1>(acc, f[kk], mnmajor_sw128(ring + slot * kFwdSlot, kk, kBox),
                       (zero && kk == 0) ? 0 : 1);
    wg_commit();
    ++s;
  };
  auto pin_frag = [&](uint32_t (&f)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(f[kk][e]);
  };
  // n chunks of one product; chunk c's A at addr(c). After each chunk is
  // issued the one before it completes and its slot is released.
  auto run = [&](float (&acc)[64], int n, bool zero, auto addr) {
    for (int c = 0; c < n; c += 2) {
      issue(acc, addr(c), fa, zero && c == 0);
      if (c > 0) {
        wg_wait<1>();
        pin_frag(fb);
        if (leader) mbar_arrive(empty + (s - 2) % kFwdSlots);
      }
      if (c + 1 < n) {
        issue(acc, addr(c + 1), fb, false);
        wg_wait<1>();
        pin_frag(fa);
        if (leader) mbar_arrive(empty + (s - 2) % kFwdSlots);
      }
    }
    wg_wait<0>();
    pin_frag(fa);
    pin_frag(fb);
#pragma unroll
    for (int e = 0; e < 64; ++e) pin(acc[e]);
    if (leader) mbar_arrive(empty + (s - 1) % kFwdSlots);
  };

  // acc[4 j + {0, 1}] at (g, 8 j + 2 t4 + {0, 1}), acc[4 j + {2, 3}] at
  // (g + 8, ...): n8 group j < J2 is a channel's tanh / residual column,
  // j + J2 its sigmoid / skip column
  float acc_c[64], acc_r[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc_r[e] = 0.f;

  for (int l = 0; l < L; ++l) {
    if (SAVE) {  // the layer's input (bf16, as the conv reads it) on the owned rows and channels
      uint16_t* sx = a.save_x + ((size_t)l * B + b) * T * kH + ch0;
      for (int i = tid; i < T0 * (kNC / 8); i += 2 * 128) {
        const int r = i / (kNC / 8), c8 = i % (kNC / 8), pos = tile * T0 + r;
        if (pos < T)
          *reinterpret_cast<uint4*>(sx + (size_t)pos * kH + 8 * c8) =
              *reinterpret_cast<const uint4*>(xw + (halo + r + p) * kXP + ch0 + 8 * c8);
      }
    }

    // --- the k-tap conv: tap tau reads window row r + tau - p, x row r + tau
    run(acc_c, conv_chunks, true, [&](int c) {
      return xw_a + ((c / CPK) * kXP + (c % CPK) * kChunk) * 2;
    });
    {  // the gate, into every CTA's acts
      const uint16_t* bl = a.b_in + l * H2;
      const uint16_t* gll = a.gl != nullptr ? a.gl + ((size_t)b * L + l) * H2 : nullptr;
#pragma unroll
      for (int j = 0; j < J2; ++j) {
        const int ch = ch0 + 8 * j + 2 * t4;
        float2 bt = ld_bf16x2(bl + ch);
        float2 bs = ld_bf16x2(bl + kH + ch);
        if (gll != nullptr) {
          const float2 gt = ld_bf16x2(gll + ch);
          const float2 gs = ld_bf16x2(gll + kH + ch);
          bt.x += gt.x; bt.y += gt.y; bs.x += gs.x; bs.y += gs.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h;
          const float2 pt = make_float2(acc_c[4 * j + 2 * h] + bt.x, acc_c[4 * j + 2 * h + 1] + bt.y);
          const float2 ps = make_float2(acc_c[4 * (j + J2) + 2 * h] + bs.x,
                                        acc_c[4 * (j + J2) + 2 * h + 1] + bs.y);
          const uint32_t v = pack_bf16(tanhf(pt.x) * sigmoidf_(ps.x), tanhf(pt.y) * sigmoidf_(ps.y));
          const uint32_t off = (uint32_t)(r * kXP + ch) * 2u;
#pragma unroll
          for (int q = 0; q < kCluster; ++q) st_cluster(acts_at[q] + off, v);
          const int pos = win_start + r;
          if (SAVE && r >= halo && r < halo + T0 && pos < T) {
            float* si = a.save_xin + (((size_t)l * B + b) * T + pos) * H2;
            *reinterpret_cast<float2*>(si + ch) = pt;
            *reinterpret_cast<float2*>(si + kH + ch) = ps;
          }
        }
      }
    }
    cluster_sync();  // every CTA holds the layer's acts

    // --- the 1x1: x = (x + rs[:H]) * mask; the skip half sums on
#pragma unroll
    for (int j = 0; j < J2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_r[4 * j + e] = 0.f;
    run(acc_r, CPK, false, [&](int c) { return acts_a + c * kChunk * 2; });
    {
      const bool last = l == L - 1;
      const uint16_t* br = a.b_rs + l * H2;
#pragma unroll
      for (int j = 0; j < J2; ++j) {
        const int cl = 8 * j + 2 * t4, ch = ch0 + cl;
        const float2 bias = ld_bf16x2(br + ch);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h;
          const float m = ms[r];
          float2* xr = reinterpret_cast<float2*>(xres + r * kRP + cl);
          const float2 xo = *xr;
          const float2 v = make_float2((xo.x + (acc_r[4 * j + 2 * h] + bias.x)) * m,
                                       (xo.y + (acc_r[4 * j + 2 * h + 1] + bias.y)) * m);
          if (last) {
            const int pos = win_start + r;
            if (r >= halo && r < halo + T0 && pos < T)
              st_bf16x2(a.x_out + ((size_t)b * T + pos) * kH + ch, v);
          } else {
            *xr = v;
            const uint32_t vb = pack_bf16(v.x, v.y);
            const uint32_t off = (uint32_t)((r + p) * kXP + ch) * 2u;
#pragma unroll
            for (int q = 0; q < kCluster; ++q) st_cluster(xw_at[q] + off, vb);
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
      const float2 v = ld_bf16x2(a.b_rs + l * H2 + kH + ch);
      bias.x += v.x;
      bias.y += v.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h, pos = win_start + r;
      if (r < halo || r >= halo + T0 || pos >= T) continue;
      const float m = ms[r];
      st_bf16x2(a.skip_out + ((size_t)b * T + pos) * kH + ch,
                make_float2((acc_r[4 * (j + J2) + 2 * h] + bias.x) * m,
                            (acc_r[4 * (j + J2) + 2 * h + 1] + bias.y) * m));
    }
  }
}

// ---------------------------------------------------------------------------
// Backward

constexpr int kSlots = 4;                         // ring slots
constexpr int kSlot = kConsumers * kBox + 192 * kChunk * 2;  // A of each warpgroup, then B
constexpr size_t kBwdSmem = 1024 + (size_t)kSlots * kSlot + kBox + 2 * kSlots * 8;

struct BwdMaps {
  CUtensorMap dxm[2];  // d_x * m [B, T, H], the layer's and the next one's
  CUtensorMap dskm;    // d_sk * m [B, T, H]
  CUtensorMap d_xin;   // [B, T, 2H]
  CUtensorMap acts;    // [B, T, H]
  CUtensorMap save_x;  // [L B, T, H]
  CUtensorMap w_in;    // [L k H, 2H], boxes of 192 rows
  CUtensorMap w_rs;    // [L H, 2H], boxes of 96 rows
};

struct Tile { int z, mt, nt; };

// Each problem gives its tiles (a CTA's 128 rows x BN columns, as (item,
// row tile, column tile)), its K chunks, the TMA loads of chunk c into a
// slot (A of warpgroup 0 at a0, of warpgroup 1 at a0 + kBox, B at b) and
// their bytes, whether warpgroup w's A is the row of ones, and the
// epilogue of warpgroup w's row rr (of its 64) and column pair n: `fetch`
// its inputs, then `put` the results, fetches batched ahead of the puts.

// d_acts = [d_x m, d_sk m] @ w_rs^T over 64-frame row blocks of one item,
// in two 96-column halves
struct ActsGrad {
  static constexpr int TA = 0, TB = 0, BN = 96;  // both K-major
  using In = float4;  // x_in's tanh and sigmoid pairs
  int B, T, layer, cur;
  const float* x_in;  // [B, T, 2H], this layer
  uint16_t* d_xin;    // [B, T, 2H]
  uint16_t* acts;     // [B, T, H]
  __device__ int mtiles() const { return (T + 127) / 128; }
  __device__ int tiles() const { return B * mtiles() * 2; }
  __device__ Tile tile(int i) const { return {i / (2 * mtiles()), i / 2 % mtiles(), i % 2}; }
  __device__ int chunks() const { return 2 * kH / kChunk; }
  __device__ bool ones(const Tile&, int) const { return false; }
  __device__ uint32_t bytes(const Tile&) const { return 2 * kBox + BN * kChunk * 2; }
  __device__ void load(const BwdMaps& m, const Tile& t, int c, uint32_t a0, uint32_t b,
                       uint64_t* bar) const {
    const int half = c / (kH / kChunk), col = c * kChunk - half * kH;
    const CUtensorMap* am = half ? &m.dskm : &m.dxm[cur];
    tma_3d(a0, am, col, t.mt * 128, t.z, bar);
    tma_3d(a0 + kBox, am, col, t.mt * 128 + 64, t.z, bar);
    tma_3d(b, &m.w_rs, c * kChunk, layer * kH + t.nt * BN, 0, bar);
  }
  __device__ In fetch(const Tile& t, int w, int rr, int n) const {
    const int tt = t.mt * 128 + 64 * w + rr;
    if (tt >= T) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* xr = x_in + ((size_t)t.z * T + tt) * 2 * kH + t.nt * BN + n;
    const float2 xt = __ldg(reinterpret_cast<const float2*>(xr));
    const float2 xs = __ldg(reinterpret_cast<const float2*>(xr + kH));
    return make_float4(xt.x, xt.y, xs.x, xs.y);
  }
  __device__ void put(const Tile& t, int w, int rr, int n, float2 d_act, const In& x) const {
    const int tt = t.mt * 128 + 64 * w + rr;
    if (tt >= T) return;
    const size_t r = (size_t)t.z * T + tt;
    n += t.nt * BN;
    const float2 th = make_float2(tanhf(x.x), tanhf(x.y));
    const float2 sg = make_float2(sigmoidf_(x.z), sigmoidf_(x.w));
    st_bf16x2(d_xin + r * 2 * kH + n, make_float2(d_act.x * sg.x * (1.f - th.x * th.x),
                                                  d_act.y * sg.y * (1.f - th.y * th.y)));
    st_bf16x2(d_xin + r * 2 * kH + kH + n, make_float2(d_act.x * th.x * sg.x * (1.f - sg.x),
                                                       d_act.y * th.y * sg.y * (1.f - sg.y)));
    st_bf16x2(acts + r * kH + n, make_float2(th.x * sg.x, th.y * sg.y));
  }
};

// d_x[r] = d_x[r] m + sum_{tau, j} d_xin[r + p - tau, j] w_in[tau, c, j]
struct InputGrad {
  static constexpr int TA = 0, TB = 0, BN = 192;
  using In = float4;  // d_x's pair and the mask
  int B, T, k, layer;
  const uint16_t* mask;  // [B, T]
  const uint16_t* d_xo;  // [B, T, H]: the gradient from above at the top layer, else null
  float* dx32;           // [B, T, H]: d_x between layers, updated in place
  uint16_t* dxm_next;    // [B, T, H]: d_x m for the layer below
  uint16_t* d_x_out;     // [B, T, H] at layer 0, else null
  __device__ int mtiles() const { return (T + 127) / 128; }
  __device__ int tiles() const { return B * mtiles(); }
  __device__ Tile tile(int i) const { return {i / mtiles(), i % mtiles(), 0}; }
  __device__ int chunks() const { return k * 2 * kH / kChunk; }
  __device__ bool ones(const Tile&, int) const { return false; }
  __device__ uint32_t bytes(const Tile&) const { return 2 * kBox + BN * kChunk * 2; }
  __device__ void load(const BwdMaps& m, const Tile& t, int c, uint32_t a0, uint32_t b,
                       uint64_t* bar) const {
    constexpr int per_tap = 2 * kH / kChunk;
    const int tau = c / per_tap, col = (c % per_tap) * kChunk, row = t.mt * 128 + (k - 1) / 2 - tau;
    tma_3d(a0, &m.d_xin, col, row, t.z, bar);
    tma_3d(a0 + kBox, &m.d_xin, col, row + 64, t.z, bar);
    tma_3d(b, &m.w_in, col, (layer * k + tau) * kH, 0, bar);
  }
  __device__ In fetch(const Tile& t, int w, int rr, int n) const {
    const int tt = t.mt * 128 + 64 * w + rr;
    if (tt >= T) return make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t r = (size_t)t.z * T + tt, o = r * kH + n;
    const float2 old = d_xo != nullptr ? ld_bf16x2(d_xo + o)
                                       : *reinterpret_cast<const float2*>(dx32 + o);
    return make_float4(old.x, old.y, bf16_to_f(__ldg(mask + r)), 0.f);
  }
  __device__ void put(const Tile& t, int w, int rr, int n, float2 v, const In& x) const {
    const int tt = t.mt * 128 + 64 * w + rr;
    if (tt >= T) return;
    const size_t o = ((size_t)t.z * T + tt) * kH + n;
    const float2 d = make_float2(x.x * x.z + v.x, x.y * x.z + v.y);
    if (d_x_out != nullptr) {
      st_bf16x2(d_x_out + o, d);
    } else {
      *reinterpret_cast<float2*>(dx32 + o) = d;
      st_bf16x2(dxm_next + o, make_float2(d.x * x.z, d.y * x.z));
    }
  }
};

// Per item z: part[z][(tau, ci), j] = sum_t x_i[z, t + tau - p, ci] d_xin[z, t, j];
// row k H (the ones) sums d_xin. Rows in 64-row granules, 3 a tap, then the ones.
struct WeightInGrad {
  static constexpr int TA = 1, TB = 1, BN = 192;  // both MN-major (K = frames)
  using In = int;  // nothing to fetch
  int B, T, k, layer;
  float* part;  // [B, k H + 1, 2H]
  __device__ int mtiles() const { return (3 * k + 1) / 2; }
  __device__ int tiles() const { return B * mtiles() * 2; }
  __device__ Tile tile(int i) const { return {i / (2 * mtiles()), i / 2 % mtiles(), i % 2}; }
  __device__ int chunks() const { return (T + kChunk - 1) / kChunk; }
  __device__ bool ones(const Tile& t, int w) const { return 2 * t.mt + w == 3 * k; }
  __device__ uint32_t bytes(const Tile& t) const {
    return (ones(t, 0) || ones(t, 1) ? 1 : 2) * kBox + BN * kChunk * 2;
  }
  __device__ void load(const BwdMaps& m, const Tile& t, int c, uint32_t a0, uint32_t b,
                       uint64_t* bar) const {
    const int t0 = c * kChunk;
    for (int w = 0; w < kConsumers; ++w) {
      const int gr = 2 * t.mt + w;
      if (gr < 3 * k)
        tma_3d(a0 + w * kBox, &m.save_x, (gr % 3) * 64, t0 + gr / 3 - (k - 1) / 2,
               layer * B + t.z, bar);
    }
    for (int q = 0; q < 3; ++q) tma_3d(b + q * kBox, &m.d_xin, t.nt * BN + 64 * q, t0, t.z, bar);
  }
  __device__ In fetch(const Tile&, int, int, int) const { return 0; }
  __device__ void put(const Tile& t, int w, int rr, int n, float2 v, In) const {
    const int gr = 2 * t.mt + w;
    if (gr == 3 * k && rr != 0) return;
    const int Ma = k * kH + 1;
    *reinterpret_cast<float2*>(part + ((size_t)t.z * Ma + gr * 64 + rr) * 2 * kH + t.nt * BN + n) = v;
  }
};

// Per item z: part[z][c, j] = sum_t acts[z, t, c] [d_x m, d_sk m][z, t, j];
// row H (the ones) sums [d_x m, d_sk m]
struct WeightRsGrad {
  static constexpr int TA = 1, TB = 1, BN = 192;
  using In = int;
  int B, T, cur;
  float* part;  // [B, H + 1, 2H]
  __device__ int tiles() const { return B * 2 * 2; }
  __device__ Tile tile(int i) const { return {i / 4, i / 2 % 2, i % 2}; }
  __device__ int chunks() const { return (T + kChunk - 1) / kChunk; }
  __device__ bool ones(const Tile& t, int w) const { return 2 * t.mt + w == 3; }
  __device__ uint32_t bytes(const Tile& t) const {
    return (ones(t, 0) || ones(t, 1) ? 1 : 2) * kBox + BN * kChunk * 2;
  }
  __device__ void load(const BwdMaps& m, const Tile& t, int c, uint32_t a0, uint32_t b,
                       uint64_t* bar) const {
    const int t0 = c * kChunk;
    for (int w = 0; w < kConsumers; ++w) {
      const int gr = 2 * t.mt + w;
      if (gr < 3) tma_3d(a0 + w * kBox, &m.acts, gr * 64, t0, t.z, bar);
    }
    const CUtensorMap* bm = t.nt == 0 ? &m.dxm[cur] : &m.dskm;
    for (int q = 0; q < 3; ++q) tma_3d(b + q * kBox, bm, 64 * q, t0, t.z, bar);
  }
  __device__ In fetch(const Tile&, int, int, int) const { return 0; }
  __device__ void put(const Tile& t, int w, int rr, int n, float2 v, In) const {
    const int gr = 2 * t.mt + w;
    if (gr == 3 && rr != 0) return;
    *reinterpret_cast<float2*>(part + ((size_t)t.z * (kH + 1) + gr * 64 + rr) * 2 * kH +
                               t.nt * BN + n) = v;
  }
};

// out_w[m, n] = sum_z part[z, m, n] for m < M - 1 (z in order); row M - 1
// goes to out_b and, when d_gl is given, each item's own row to d_gl[z,
// layer]; for both weight products of a layer, in bf16. Run by the CTAs of a
// launch past its tiles, four outputs a thread at a time.
struct Reduce {
  const float* part_a;  // WeightInGrad's, M = k H + 1
  const float* part_b;  // WeightRsGrad's, M = H + 1
  uint16_t* dw_a;
  uint16_t* db_a;
  uint16_t* d_gl;  // or null
  uint16_t* dw_b;
  uint16_t* db_b;
  int Ma, B, layer, L;
};

__device__ void reduce_parts(const Reduce& r, int cta, int ctas) {
  constexpr int N = 2 * kH, Mb = kH + 1;
  const int na = r.Ma * N / 4, total = na + Mb * N / 4;  // groups of 4 (N % 4 == 0)
  for (int idx = cta * blockDim.x + threadIdx.x; idx < total; idx += ctas * blockDim.x) {
    const bool is_a = idx < na;
    const int i = 4 * (is_a ? idx : idx - na), M = is_a ? r.Ma : Mb;
    const float4* part = reinterpret_cast<const float4*>((is_a ? r.part_a : r.part_b) + i);
    const size_t stride = (size_t)M * N / 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int z = 0; z < r.B; ++z) {
      const float4 v = __ldg(part + z * stride);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const int m = i / N, n = i - m * N;
    const uint2 packed = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    if (m < M - 1) {
      *reinterpret_cast<uint2*>((is_a ? r.dw_a : r.dw_b) + i) = packed;
    } else {
      *reinterpret_cast<uint2*>((is_a ? r.db_a : r.db_b) + n) = packed;
      if (is_a && r.d_gl != nullptr)
        for (int z = 0; z < r.B; ++z) {
          const float4 v = __ldg(part + z * stride);
          *reinterpret_cast<uint2*>(r.d_gl + ((size_t)z * r.L + r.layer) * N + n) =
              make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
        }
    }
  }
}

// one tile of problem p on this CTA
template <class P>
__device__ __forceinline__ void run_tile(const BwdMaps& maps, const P& p, const Tile& t,
                                         uint8_t* smem_raw) {
  constexpr int NR = P::BN / 2, NJ = P::BN / 8, JB = 6;  // JB: epilogue fetches in flight
  static_assert(NJ % JB == 0, "epilogue batches");
  const uint32_t ring = align1024(smem_addr(smem_raw));
  const uint32_t ones = ring + kSlots * kSlot;  // the MN-major row of ones: 64 K rows x 64
  uint8_t* base = smem_raw + (ring - smem_addr(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kSlots * kSlot + kBox);
  uint64_t* empty = full + kSlots;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = p.chunks();

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    fence_barrier_init();
  }
  if (p.ones(t, 0) || p.ones(t, 1)) {
    // element (k, 0) of each K row: its 16-byte chunk k % 8 under the swizzle
    uint4* o = reinterpret_cast<uint4*>(base + kSlots * kSlot);
    for (int i = tid; i < kBox / 16; i += kThreads)
      o[i] = make_uint4((i & 7) == ((i >> 3) & 7) ? 0x3F80u : 0u, 0u, 0u, 0u);
    fence_async_shared();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // --- the producer warp
    if (lane == 0) {
      for (int c = 0; c < nk; ++c) {
        const int slot = c % kSlots;
        if (c >= kSlots) mbar_wait(empty + slot, ((c / kSlots) & 1) ^ 1);
        const uint32_t st = ring + slot * kSlot;
        mbar_expect(full + slot, p.bytes(t));
        p.load(maps, t, c, st, st + kConsumers * kBox, full + slot);
      }
    }
    return;
  }

  // --- a consumer warpgroup: 64 rows of the tile
  const int w = warp >> 2;
  const bool a_ones = p.ones(t, w);
  float acc[NR];
#pragma unroll
  for (int e = 0; e < NR; ++e) acc[e] = 0.f;
  for (int c = 0; c < nk; ++c) {
    const int slot = c % kSlots;
    mbar_wait(full + slot, (c / kSlots) & 1);
    const uint32_t st = ring + slot * kSlot;
    const uint32_t at = a_ones ? ones : st + w * kBox, bt = st + kConsumers * kBox;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = P::TA ? mnmajor_sw128(at, kk, kBox) : kmajor_sw128(at, kk);
      const uint64_t db = P::TB ? mnmajor_sw128(bt, kk, kBox) : kmajor_sw128(bt, kk);
      wgmma_ss<P::BN, P::TA, P::TB>(acc, da, db, 1);
    }
    wg_commit();
    wg_wait<1>();
    if (c > 0 && (tid & 127) == 0) mbar_arrive(empty + (c - 1) % kSlots);
  }
  wg_wait<0>();
#pragma unroll
  for (int e = 0; e < NR; ++e) pin(acc[e]);
  // acc[4 j + 2 h + {0, 1}] at row 16 ww + g + 8 h, columns 8 j + 2 t4 + {0, 1}
  const int g = lane >> 2, t4 = lane & 3, rr0 = 16 * (warp & 3) + g;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += JB) {
      typename P::In in[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) in[q] = p.fetch(t, w, rr0 + 8 * h, 8 * (j0 + q) + 2 * t4);
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const int j = j0 + q;
        p.put(t, w, rr0 + 8 * h, 8 * j + 2 * t4,
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), in[q]);
      }
    }
}

template <class P>
__device__ __forceinline__ bool run_if_mine(const BwdMaps& maps, const P& p, int& bid,
                                            uint8_t* smem) {
  const int n = p.tiles();
  if (bid >= n) {
    bid -= n;
    return false;
  }
  run_tile(maps, p, p.tile(bid), smem);
  return true;
}

// One grid over several problems (CTA i runs the i-th tile in order), and
// past their tiles CTAs that run the reduction r
template <class... Ps>
__global__ void __launch_bounds__(kThreads, 1)
bwd_tiles_kernel(const __grid_constant__ BwdMaps maps, const __grid_constant__ Reduce r,
                 Ps... ps) {
  extern __shared__ uint8_t smem[];
  const int tiles = (0 + ... + ps.tiles());
  int bid = blockIdx.x;
  if (bid >= tiles) {
    reduce_parts(r, bid - tiles, gridDim.x - tiles);
    return;
  }
  (void)(run_if_mine(maps, ps, bid, smem) || ...);
}

template <class... Ps>
cudaError_t launch_tiles(cudaStream_t stream, const BwdMaps& maps, const Reduce& r, int tiles,
                         int reduce_ctas, const Ps&... ps) {
  const auto kernel = bwd_tiles_kernel<Ps...>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBwdSmem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles + reduce_ctas, kThreads, tiles > 0 ? kBwdSmem : 0, stream>>>(maps, r, ps...);
  return cudaGetLastError();
}

// d_xo m and d_sk m in bf16 (the top layer's operands), two values a thread
__global__ void mask_cotangents_kernel(const uint16_t* __restrict__ d_xo,
                                       const uint16_t* __restrict__ d_sk,
                                       const uint16_t* __restrict__ mask, uint16_t* __restrict__ dxm,
                                       uint16_t* __restrict__ dskm, long long pairs) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < pairs;
       i += (long long)gridDim.x * blockDim.x) {
    const float m = bf16_to_f(mask[2 * i / kH]);
    const uint32_t x = reinterpret_cast<const uint32_t*>(d_xo)[i];
    const uint32_t s = reinterpret_cast<const uint32_t*>(d_sk)[i];
    reinterpret_cast<uint32_t*>(dxm)[i] = pack_bf16(bf16_lo(x) * m, bf16_hi(x) * m);
    reinterpret_cast<uint32_t*>(dskm)[i] = pack_bf16(bf16_lo(s) * m, bf16_hi(s) * m);
  }
}

}  // namespace

// One bf16 WN group on `stream`; gl may be null. With save_x (bf16 [L, B, T,
// H]) and save_xin (fp32 [L, B, T, 2H]), both or neither, it also writes
// each layer's input and pre-activation for the backward. Each cluster of 3
// CTAs owns 128 - 2 L (k - 1) / 2 frames. Returns the first CUDA error (0
// on success).
extern "C" int tts_wn_group_forward_bf16(const void* x, const void* mask, const void* gl,
                                         const void* w_in, const void* b_in, const void* w_rs,
                                         const void* b_rs, void* x_out, void* skip_out,
                                         void* save_x, float* save_xin, int B, int T, int H, int L,
                                         int k, void* stream) {
  if (B < 1 || T < 1 || L < 1 || k < 1 || k % 2 == 0 || k > kMaxTaps || H != kH)
    return (int)cudaErrorInvalidValue;
  if ((save_x == nullptr) != (save_xin == nullptr)) return (int)cudaErrorInvalidValue;
  const int T0 = kWin - 2 * L * ((k - 1) / 2);
  if (T0 < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap w_in_map, w_rs_map;
  if (!make_map(&w_in_map, w_in, 2 * kH, (uint64_t)L * k * kH, 1, 64) ||
      !make_map(&w_rs_map, w_rs, 2 * kH, (uint64_t)L * kH, 1, 64))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{static_cast<const uint16_t*>(x),    static_cast<const uint16_t*>(mask),
                  static_cast<const uint16_t*>(gl),   static_cast<const uint16_t*>(b_in),
                  static_cast<const uint16_t*>(b_rs), static_cast<uint16_t*>(x_out),
                  static_cast<uint16_t*>(skip_out),   static_cast<uint16_t*>(save_x),
                  save_xin,                           B, T, L, k, T0};
  const auto kernel = save_x != nullptr ? wn_fwd_bf16_kernel<true> : wn_fwd_bf16_kernel<false>;
  const size_t smem = fwd_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, (T + T0 - 1) / T0, B);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, w_in_map, w_rs_map, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Backward of one bf16 group on `stream`, from the forward's saves (save_x
// bf16 [L, B, T, H], save_xin fp32 [L, B, T, 2H]) and the cotangents d_xo,
// d_sk [B, T, H]: writes d_x [B, T, H], d_gl [B, L, 2H] (skipped when null),
// d_w_in [L, k, H, 2H], d_b_in [L, 2H], d_w_rs [L, H, 2H], d_b_rs [L, 2H],
// all bf16. `work` holds B T 4H + 2 B (k H + 1) 2H + 2 B (H + 1) 2H floats
// (the wrapper's `backward_workspace` for bf16, laid out as its
// `backward_buffers`). Returns the first CUDA error (0 on success).
extern "C" int tts_wn_group_backward_bf16(const void* mask, const void* w_in, const void* w_rs,
                                          const void* save_x, const float* save_xin,
                                          const void* d_xo, const void* d_sk, void* d_x,
                                          void* d_gl, void* d_w_in, void* d_b_in, void* d_w_rs,
                                          void* d_b_rs, float* work, int B, int T, int H, int L,
                                          int k, void* stream) {
  if (B < 1 || T < 1 || L < 1 || k < 1 || k % 2 == 0 || k > kMaxTaps || H != kH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t R = (size_t)B * T;
  const int H2 = 2 * kH, Ma = k * kH + 1, Mb = kH + 1;
  float* dx32 = work;                                         // [R, H]
  float* part_a[2] = {dx32 + R * kH, dx32 + R * kH + (size_t)B * Ma * H2};  // [B, Ma, 2H] each
  float* part_b[2] = {part_a[1] + (size_t)B * Ma * H2,
                      part_a[1] + (size_t)B * Ma * H2 + (size_t)B * Mb * H2};  // [B, Mb, 2H]
  uint16_t* d_xin = reinterpret_cast<uint16_t*>(part_b[1] + (size_t)B * Mb * H2);  // [R, 2H]
  uint16_t* acts = d_xin + R * H2;                            // [R, H]
  uint16_t* dxm[2] = {acts + R * kH, acts + 2 * R * kH};      // [R, H] each
  uint16_t* dskm = acts + 3 * R * kH;                         // [R, H]

  BwdMaps maps;
  if (!make_map(&maps.dxm[0], dxm[0], kH, T, B, 64) || !make_map(&maps.dxm[1], dxm[1], kH, T, B, 64) ||
      !make_map(&maps.dskm, dskm, kH, T, B, 64) || !make_map(&maps.d_xin, d_xin, H2, T, B, 64) ||
      !make_map(&maps.acts, acts, kH, T, B, 64) ||
      !make_map(&maps.save_x, save_x, kH, T, (uint64_t)L * B, 64) ||
      !make_map(&maps.w_in, w_in, H2, (uint64_t)L * k * kH, 1, InputGrad::BN) ||
      !make_map(&maps.w_rs, w_rs, H2, (uint64_t)L * kH, 1, ActsGrad::BN))
    return (int)cudaErrorInvalidValue;

  const long long pairs = (long long)R * kH / 2;
  mask_cotangents_kernel<<<(unsigned)(pairs / 256 + 1 < 4 * 132 ? pairs / 256 + 1 : 4 * 132), 256, 0,
                           s>>>(static_cast<const uint16_t*>(d_xo), static_cast<const uint16_t*>(d_sk),
                                static_cast<const uint16_t*>(mask), dxm[0], dskm, pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // layer i's weight products write part_*[i % 2]; their reduction runs in
  // the CTAs past the next grid of products (layer i - 1's), the last alone
  auto reduction = [&](int i) {
    return Reduce{part_a[i % 2], part_b[i % 2],
                  static_cast<uint16_t*>(d_w_in) + (size_t)i * k * kH * H2,
                  static_cast<uint16_t*>(d_b_in) + (size_t)i * H2, static_cast<uint16_t*>(d_gl),
                  static_cast<uint16_t*>(d_w_rs) + (size_t)i * kH * H2,
                  static_cast<uint16_t*>(d_b_rs) + (size_t)i * H2, Ma, B, i, L};
  };
  const Reduce none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, Ma, B, 0, L};
  const int mt = (T + 127) / 128, reduce_ctas = 48;
  auto acts_grad = [&](int i, int cur) {
    const ActsGrad pa{B, T, i, cur, save_xin + (size_t)i * R * H2, d_xin, acts};
    return launch_tiles(s, maps, none, 2 * B * mt, 0, pa);
  };
  if ((err = acts_grad(L - 1, 0)) != cudaSuccess) return (int)err;
  int cur = 0;
  for (int i = L - 1; i >= 0; --i) {
    const InputGrad pi{B, T, k, i, static_cast<const uint16_t*>(mask),
                       i == L - 1 ? static_cast<const uint16_t*>(d_xo) : nullptr, dx32,
                       dxm[cur ^ 1], i == 0 ? static_cast<uint16_t*>(d_x) : nullptr};
    const WeightInGrad pw{B, T, k, i, part_a[i % 2]};
    const WeightRsGrad pr{B, T, cur, part_b[i % 2]};
    const int tiles = B * mt + B * (3 * k + 1) + B * 4;
    const bool above = i + 1 < L;  // the layer above's reduction rides along
    err = launch_tiles(s, maps, above ? reduction(i + 1) : none, tiles, above ? reduce_ctas : 0,
                       pi, pw, pr);
    if (err != cudaSuccess) return (int)err;
    if (i > 0 && (err = acts_grad(i - 1, cur ^ 1)) != cudaSuccess) return (int)err;
    cur ^= 1;
  }
  return (int)launch_tiles(s, maps, reduction(0), 0, 4 * reduce_ctas);
}
