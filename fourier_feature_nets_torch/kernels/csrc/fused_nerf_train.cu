// Fused NeRF recompute-backward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels fourier_feature_nets_tpu/ops/
// fused_nerf_train.py::_bwd_kernel (row-major) and ops/fused_nerf_train_fm.py
// ::_bwd_kernel_fm (feature-major, the same function). Given positions,
// views, the packed weights and the (N, 4) f32 cotangent g of the logits
// [r, g, b, opacity], it recomputes the forward on chip (rounding where K1,
// fused_nerf.cu, rounds), backpropagates, and returns the f32 gradient of
// every packed weight and bias. Positions and views get no gradient.
//
// What bounds it on an H100. Three products a layer (the recompute, dX and
// dW), ~3.6 MFLOP a point at the 8x256 flagship: 0.47 ms of bf16 tensor-core
// time for a 131,072-point step, 2.83 ms in f32 as 3xTF32. The TPU kernel
// kept every weight and every gradient accumulator resident in VMEM across
// a sequential grid. Here blocks run in parallel, and neither the ~1.2 MB
// pack nor its 2.4 MB of f32 gradients fits a block: every tile streams the
// pack's slabs from L2 twice (recompute, dX), and a tile's dW cannot stay on
// chip until the grid is done.
//
// bf16: two passes and a sum, a slice of at most kSlicePoints points at a
// time (the scratch holds one slice). Summing dW with per-tile atomics, as
// a one-pass kernel does, cost 0.77 of its 2.69 ms at the flagship on an
// H100 (PERF.md, section 6), and the atomics' order made the gradients
// differ from launch to launch. Instead, as tiny-cuda-nn's fused MLP does, pass 1 stores what each
// dW reads and pass 2 sums dW over all points:
// * Pass 1, fused_nerf_backward_bf16_kernel, persistent and warp-specialised
//   on K1's tile (fused_nerf_wgmma.cuh): one block per SM walks 128-point
//   tiles, two consumer warpgroups own 64 rows each, one producer warp
//   streams slabs of the slab image through a ring of bulk-copy stages,
//   three encode. The recompute is K1's code (layer_product, encode_rows,
//   store_layer), so it sums every layer in K1's k16 order: the forward that K2 differentiates is K1's, bit for
//   bit; it skips the heads' products. Every tensor a dW reads leaves shared
//   memory with one bulk copy, its 8 KB blocks as they lie (128-byte
//   swizzled), into the records (Records: a scratch indexed by 64-point row
//   block, tensor-major): each body layer's input h, the bottleneck's output,
//   the positional and view features, and each layer's dz after its cast to
//   bf16 (the operand dW read before). Since dW leaves, a warpgroup keeps
//   K1's shared memory, one region of activations written in place: the
//   recompute's epilogue also keeps each h's ReLU mask (16 bytes a thread
//   and layer in the scratch), and the backward reads that instead of h.
//   The ring then gets 4 stages at the flagship where the one-pass kernel,
//   which kept h and dz apart, got 2 and waited on L2 for its slabs. dX = dz
//   W^T: per warpgroup, M its 64 points, K the layer's outputs, B = W^T the
//   slab as it lies, read MN-major; the epilogue adds the opacity head's f32
//   term (bottleneck, its weights in shared memory), masks, casts and stores
//   dz over the last. The heads' weight and bias gradients are summed on
//   the CUDA cores in f32 over each warpgroup's 64 rows (the opacity head's
//   right after h_{L-1}) and written to the row block's row of a small
//   buffer; no step needs the other warpgroup's rows.
// * Pass 2, fused_nerf_backward_dw_bf16_kernel: dW = X^T dz of the body
//   layers, the bottleneck and the hidden layer, split-K over the points. An
//   item is (layer, range of row blocks, a pair of 64-column slices of the
//   layer's input); the producer loads each row block's two X blocks and its
//   dz blocks into a ring of stages, and each consumer warpgroup runs wgmma
//   with both operands MN-major (M = its slice, K = 64 points a stage, N =
//   the layer's outputs), accumulating in f32 registers over the whole range
//   (thousands of points, not 128). The first pair of a layer also sums dz's
//   columns: the bias gradient. Each item writes its 64 x N block into its
//   range's row of a [ranges, weights + biases] f32 buffer. The ranges
//   (dw_plan) follow from N, the layers' widths and the SM count: enough
//   items for kDwWaves a block, each range at least kDwMinRows row blocks.
// * fused_nerf_backward_sum_kernel sums the ranges' rows in order and the
//   tiles' head rows in a fixed order, and writes every gradient (a later
//   slice adds its sum to the earlier slices'): the caller zeroes nothing,
//   and every gradient is the same bit for bit from launch to launch.
// What bounds them now (flagship, N = 131,072): pass 1 writes ~10 KB a
// point (9.7 KB of records, the masks) besides its two forwards and the
// slab stream; pass 2 reads the records once or, where a layer's dz feeds
// two items, twice (9.7-15 KB a point).
// Shared memory, pass 1, per warpgroup: the activations (C columns), the
// positional and the view features (in 64-column blocks), and two or more
// ring stages of C x 128 bytes: the one budget is bf16_shared_bytes, and a
// model that does not fit makes the launch raise. Pass 2: stages of two X
// blocks and a dz row block (dw_shared_bytes). The positional and view
// features are stored rather than encoded again in pass 2: 256 bytes a point
// at the flagship, and pass 2 keeps one producer and no encoder.
//
// f32: fused_nerf_backward_tf32_kernel, persistent and warp-specialised on
// K1's f32 routines (fused_nerf_tf32.cuh): 3xTF32 products (tf32 hi and lo
// of each operand, lo hi + hi lo + hi hi summed in f32), one block per SM
// walking 64-point tiles with one consumer warpgroup; in the producer
// warpgroup one thread streams the f32 slab image, three warps encode.
// * Shared memory is the binding constraint (tf32_shared_bytes, the one
//   budget): f32 rows of 64 points take 64 KB of dz^T and 88 KB of x ([h |
//   positional | view]) at the flagship, and two 32 KB ring stages, 222,376
//   bytes in all. A 128-point tile would need twice the rows: so 64 points,
//   one warpgroup, and twice bf16's L2 slab reads a point.
// * The recompute is K1's code (layer_tf32, store_f32, encode_rows_f32) over
//   the same image, so the forward K2 differentiates is K1's, bit for bit.
//   Body layers' h are parked in the wrapper's scratch (L x 64 KB a block)
//   with one bulk copy each and reloaded during dX; the hidden layer's output
//   stays in registers and where dz^T goes.
// * dX = dz W^T on wgmma: A = dz, read into registers from dz^T (which lies
//   feature-major, K-major for dW's B below), B = the image's transposed
//   slabs (W^T of the first C rows, K-major: tf32 has no MN-major operand).
//   The epilogue adds the opacity head's f32 term (bottleneck), applies the
//   ReLU mask of the input's h (bits read before the next reload) and stores
//   dz^T.
// * dW = X^T dz on mma.sync m16n8k8 (dw_sync): with tf32 both wgmma operands
//   would have to lie in shared memory K-major, that is point-contiguous, as
//   hi and lo copies, which the budget has no room for; mma.sync loads its
//   fragments from any layout into registers (X point-major by scalar loads,
//   dz^T by ldmatrix), where they are split. The consumer's four warps and
//   the three encoder warps (idle by then) take its chunks in turn; each
//   pair of lanes adds its fragments with float4 atomics. It is the largest
//   suspect for what holds the kernel (PERF.md, section 7).
// * Biases and heads on the CUDA cores, each summed over the tile's 64
//   points before its atomic; the heads use the pack's exact weights (the
//   end of the image).
// L2 traffic a 64-point tile, at the flagship: the image's forward and dX
// slabs, hi and lo (9.2 MB, 144 KB a point) and 2.4 MB of f32 dW reductions
// (37.5 KB a point).
//
// Rounding points (bf16). Each body layer's f32 sum + bias is cast and then
// ReLU'd, the bottleneck is cast, the hidden layer is ReLU'd and cast (K1).
// Every dz is cast to the working type before it feeds a product. The heads
// take the f32 cotangent as f32 on the CUDA cores: the color head's
// dhidden, the color and opacity weight gradients, and the g_opacity x
// opacity_w^T term of dh, since JAX promotes a bf16 x f32 product to f32.
// The ReLU mask is h > 0 (the TPU's ceil(min(h, 1)) is a Mosaic workaround
// with the same 0/1 values). Against the plain twin at the flagship (H100):
// see chip_smoke.py's GRAD_SHARE for the limits and their readings
// (kernels/fused_nerf_train.py holds K2_BF16_*, the ones chip_smoke.py and
// the card tests share).
//
// In f32 nothing is cast: every sum, dz and head is f32 (the plain twin's
// f32 GEMMs), and the limits against the twin are chip_smoke.py's GRAD_SHARE
// f32, which the twin on single tf32 products fails.
//
// The kernels mask the ragged last tile themselves (zero inputs and zero
// cotangent rows, so dead points add nothing) and launch on the caller's
// stream; the entry point returns the first launch error. Their one
// allocation, the scratch (bf16: the records, the heads' rows and the
// partials; f32: the parked activations), is the wrapper's (torch.empty, of
// the size fused_nerf_backward_scratch_bytes gives); no kernel allocates.

#include "fused_nerf_common.cuh"
#include "fused_nerf_tf32.cuh"
#include "fused_nerf_wgmma.cuh"
#include "hopper.cuh"
#include "shared_limit.cuh"

namespace {

using ffn::Desc;
using ffn::kHeadWidth;
// ---------------------------------------------------------------------------
// bf16: the wgmma kernel
// ---------------------------------------------------------------------------

using Bf16 = __nv_bfloat16;
using namespace ffn::wgmma;

// full and empty per stage; per consumer warpgroup, ready and free for its
// positional and its view features
constexpr int kBarrierBytes = (2 * kMaxStages + 8) * 8;

// The byte offset of every packed layer's slabs in the slab image.
struct SlabOffsets {
  long long at[ffn::kMaxLayers + 4];
};

SlabOffsets slab_offsets(const Desc& d) {
  SlabOffsets offsets{};
  long long at = 0;
  for (int j = 0; j < d.num_layers + 4; ++j) {
    int K, N;
    layer_shape(d, j, &K, &N);
    offsets.at[j] = at;
    at += static_cast<long long>((K + kSlabK - 1) / kSlabK) * N * 128;
  }
  return offsets;
}

// One consumer warpgroup's shared memory, in 8 KB blocks of its 64 rows:
// [act (H) | positional features (Pb) | view features (Vb)], H = ceil(C /
// 64): K1's layout. The recompute writes each layer's output over its input
// in act, the hidden layer over the bottleneck; the backward writes each dz
// there, over the last. From act, the features start at columns 64 H and
// 64 (H + Pb).
struct Region {
  int H, Pb, Vb;
  __host__ __device__ uint32_t bytes() const {
    return (H + Pb + Vb) * kBlockBytes;
  }
  __host__ __device__ uint32_t pos() const { return H * kBlockBytes; }
  __host__ __device__ uint32_t view() const {
    return (H + Pb) * kBlockBytes;
  }
};

__host__ __device__ inline Region region_of(const Desc& d) {
  return Region{(d.channels + 63) / 64, (d.pos_width + 63) / 64,
                (d.view_width + 63) / 64};
}

// The records pass 1 leaves for pass 2: per 64-point row block (one
// warpgroup's rows of a tile, block r = 2 tile + warpgroup), every tensor a
// layer's dW reads, as 8 KB blocks of 64 columns exactly as they lie in
// shared memory (128-byte swizzled). Tensor-major: tensor t of every row
// block, then the next tensor. Tensors: h_0 .. h_{L-1}, the bottleneck's
// output b, the positional and the view features, dz_0 .. dz_{L-1}, the
// bottleneck's dz and the hidden layer's dz.
struct Records {
  int L, H, Pb, Vb, Hh;      // Hh: the hidden layer's dz blocks
  long long rows;            // row blocks

  __host__ __device__ int h(int i) const { return i; }
  __host__ __device__ int b() const { return L; }
  __host__ __device__ int pos() const { return L + 1; }
  __host__ __device__ int view() const { return L + 2; }
  __host__ __device__ int dz(int i) const { return L + 3 + i; }
  __host__ __device__ int dz_bottleneck() const { return 2 * L + 3; }
  __host__ __device__ int dz_hidden() const { return 2 * L + 4; }
  __host__ __device__ int blocks(int t) const {
    return t == pos() ? Pb : t == view() ? Vb : t == dz_hidden() ? Hh : H;
  }
  // 8 KB blocks a row block holds in all
  __host__ __device__ int row_blocks() const {
    return 2 * (L + 1) * H + Pb + Vb + Hh;
  }
  // the byte offset of tensor t's blocks of row block r
  __host__ __device__ long long at(int t, long long r) const {
    const int before = t <= pos() ? t * H
                       : t == view() ? (L + 1) * H + Pb
                                     : (t - 2) * H + Pb + Vb;
    return (before * rows + r * blocks(t)) * kBlockBytes;
  }
  __host__ __device__ long long bytes() const {
    return row_blocks() * rows * kBlockBytes;
  }
};

__host__ __device__ inline Records records_of(const Desc& d,
                                              long long num_points) {
  const Region reg = region_of(d);
  return Records{d.num_layers, reg.H, reg.Pb, reg.Vb,
                 (d.channels / 2 + 63) / 64,
                 2 * ((num_points + kTileRows - 1) / kTileRows)};
}

// The heads' sums of a row block, in f32 (head_floats of them, each
// element's row blocks in a run): the color head's dW (C / 2 rows of 3), the
// opacity head's (C), the color bias (3) and the opacity bias.
__host__ __device__ inline int head_floats(int C) { return 5 * C / 2 + 4; }

// The ReLU masks pass 1's backward reads: for each row block and body layer
// i, each consumer thread's bits of h_i > 0 at its dX fragment (relu_mask's
// layout), as one 16-byte word of up to four 32-bit words.
constexpr int kMaskBytes = 16;
__host__ __device__ inline long long mask_bytes(const Desc& d,
                                                long long rows) {
  return rows * d.num_layers * 128 * kMaskBytes;
}

// The value at shared-memory address `at`, read through a generic pointer:
// the CUDA-core loops read their operands so, which lets the compiler keep
// many loads in flight (a volatile ld.shared in inline PTX issues one at a
// time).
template <typename T>
__device__ __forceinline__ T shared_at(uint32_t at) {
  return *static_cast<const T*>(__cvta_shared_to_generic(at));
}

__device__ __forceinline__ float shared_bf16(uint32_t at) {
  return __bfloat162float(shared_at<Bf16>(at));
}

// The 8-column groups whose bias loads store_layer (fused_nerf_wgmma.cuh)
// issues ahead of their stores in the recompute: one L2 latency a batch,
// where K1's loads, a pair beside each store, pay one a pair.
constexpr int kBiasBatch = 16;

// The warpgroup of this thread, warp-uniform as the compiler sees it: with
// threadIdx.x / 128 the consumer's products sat on a path ptxas took for
// divergent and serialized (its C7520 note), and it spilled more.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// W[k][n] of the packed layer whose slabs start at byte `at` of the slab
// image and that has `width` outputs (kernels/fused_nerf.py::slab_index).
__device__ __forceinline__ float slab_weight(const char* image, long long at,
                                             int width, int k, int n) {
  const long long byte = at + static_cast<long long>(k >> 6) * width * 128
                         + n * 128 + ((((k & 63) >> 3) ^ (n & 7)) << 4)
                         + (k & 7) * 2;
  return __bfloat162float(__ldg(reinterpret_cast<const Bf16*>(image + byte)));
}

// acc[32 s ..] = dz W^T for dX's columns 64 s .. 64 s + 63, s < kChunks:
// A = dz (K-major, K = the layer's N outputs), B = slab s of the layer read
// MN-major, one slab a chunk. Returns with the products complete and every
// slab released.
template <int N, int kChunks>
__device__ __forceinline__ void dx_product(float* acc, Ring& ring,
                                           uint32_t dz, bool releases) {
  hopper::fence_registers<32 * kChunks>(acc);
  hopper::wgmma_fence();
  int held = -1;
#pragma unroll
  for (int s = 0; s < kChunks; ++s) {
    hopper::mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    const uint32_t slab = ring.base + ring.stage * ring.stage_bytes;
#pragma unroll
    for (int k = 0; k < N; k += 16) {
      hopper::mma<64, 0, 1>(
          acc + 32 * s,
          hopper::desc_sw128(dz + (k >> 6) * kBlockBytes + (k & 63) * 2),
          hopper::desc_sw128_mn(slab + k * 128), k > 0);
    }
    hopper::wgmma_commit();
    if (held >= 0) {
      hopper::wgmma_wait<1>();
      if (releases) hopper::mbar_arrive(ring.empty + 8 * held);
    }
    held = ring.stage;
    ring.advance();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_registers<32 * kChunks>(acc);
  if (releases) hopper::mbar_arrive(ring.empty + 8 * held);
}

// dz[:, 0:C] = bf16 of dX, with the opacity head's f32 term g_op opacity_w
// added (kOpacity; g0 and g8 are g_op of rows r0 and r0 + 8, opacity_w the
// head's weights in shared memory) and the ReLU mask applied (kMask), stored
// into the swizzled rows in place.
template <int C, bool kOpacity, bool kMask>
__device__ __forceinline__ void store_dz(const float* acc,
                                         const uint32_t* mask, uint32_t dz,
                                         const Fragment& f, int pair,
                                         float g0, float g8,
                                         const float* opacity_w) {
#pragma unroll
  for (int s = 0; s < (C + 63) / 64; ++s) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      if (64 * s + 8 * j < C) {
        uint32_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {   // group j + q / 2, row r0 + 8 (q % 2)
          const int jj = j + q / 2;
          const int h = q % 2;
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int bit = 4 * jj + 2 * h + c;
            float x = acc[32 * s + bit];
            if (kOpacity) {
              x += (h ? g8 : g0) * opacity_w[64 * s + 8 * jj + pair + c];
            }
            if (kMask && !((mask[s] >> bit) & 1u)) x = 0.0f;
            v[c] = x;
          }
          r[q] = pack_bf16x2(v[0], v[1], false);
        }
        store_groups(dz + s * kBlockBytes, f, j, r[0], r[1], r[2], r[3]);
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kBf16Threads, 1)
fused_nerf_backward_bf16_kernel(const float* __restrict__ positions,
                                const float* __restrict__ views,
                                const float* __restrict__ pos_enc,
                                const float* __restrict__ view_enc,
                                const Bf16* __restrict__ slabs,
                                const float* __restrict__ biases,
                                const float* __restrict__ g,
                                float* __restrict__ heads,
                                uint4* __restrict__ masks,
                                char* __restrict__ records,
                                long long num_points, Desc d,
                                SlabOffsets offsets, int stages) {
  constexpr int H = (C + 63) / 64;
  extern __shared__ __align__(1024) unsigned char bf16_smem[];
  const uint32_t base = (hopper::smem_addr(bf16_smem) + kAlignSlack - 1)
                        & ~static_cast<uint32_t>(kAlignSlack - 1);
  const Region reg = region_of(d);
  const uint32_t region_bytes = reg.bytes();
  const uint32_t ring_base = base + 2 * region_bytes;
  const uint32_t stage_bytes = C * 128;
  const uint32_t full = ring_base + stages * stage_bytes;
  const uint32_t empty = full + 8 * kMaxStages;
  // [warpgroup]: features written, features read (for the next tile)
  const uint32_t pos_ready = empty + 8 * kMaxStages;
  const uint32_t pos_free = pos_ready + 16;
  const uint32_t view_ready = pos_free + 16;
  const uint32_t view_free = view_ready + 16;
  float* const opacity_w =
      static_cast<float*>(__cvta_shared_to_generic(view_free + 16));
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    for (int w = 0; w < 2; ++w) {
      hopper::mbar_init(pos_ready + 8 * w, kEncoderThreads);
      hopper::mbar_init(pos_free + 8 * w, kConsumerWarps / 2);
      hopper::mbar_init(view_ready + 8 * w, kEncoderThreads);
      hopper::mbar_init(view_free + 8 * w, kConsumerWarps / 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const long long num_tiles = (num_points + kTileRows - 1) / kTileRows;
  const int L = d.num_layers;
  const char* const image = reinterpret_cast<const char*>(slabs);
  const int wg = warpgroup();
  if (wg == 2) {
    hopper::regs_decrease<kProducerRegs>();
    if (threadIdx.x == 256) {
      // Producer: one thread streams each tile's slab sequence, the
      // recompute's (body, bottleneck, hidden layer: the heads' products are
      // not needed) then the backward's (the first H slabs of the hidden
      // layer, the bottleneck and body layers L-1 .. 1: the C rows of W that
      // feed dX).
      int stage = 0;
      uint32_t phase = 0;
      auto stream = [&](int j, int s) {
        int K, N;
        layer_shape(d, j, &K, &N);
        const uint32_t bytes = N * 128;
        hopper::mbar_wait(empty + 8 * stage, phase ^ 1u);
        hopper::mbar_arrive_expect_tx(full + 8 * stage, bytes);
        hopper::bulk_load(ring_base + stage * stage_bytes,
                          image + offsets.at[j]
                              + static_cast<long long>(s) * bytes,
                          bytes, full + 8 * stage);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1u;
        }
      };
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        for (int j = 0; j < L + 3; ++j) {
          if (j == L) continue;
          int K, N;
          layer_shape(d, j, &K, &N);
          for (int s = 0; s * kSlabK < K; ++s) stream(j, s);
        }
        for (int s = 0; s < H; ++s) stream(L + 2, s);
        for (int s = 0; s < H; ++s) stream(L + 1, s);
        for (int j = L - 1; j >= 1; --j) {
          for (int s = 0; s < H; ++s) stream(j, s);
        }
      }
      // Leave only once the consumers have released every stage.
      for (int s = 0; s < stages; ++s) {
        hopper::mbar_wait(empty + 8 * stage, phase ^ 1u);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    } else if (threadIdx.x >= 256 + 32) {
      // Encoders: a tile's features go into a consumer warpgroup's blocks
      // once its backward has read the last tile's (view: after the hidden
      // layer's dW; positional: after layer 0's).
      const int warp = (threadIdx.x - 256) / 32 - 1;   // 0..2
      const int lane = threadIdx.x & 31;
      uint32_t parity = 0;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        for (int w = 0; w < 2; ++w) {
          hopper::mbar_wait(pos_free + 8 * w, parity ^ 1u);
          encode_rows(positions, tile * kTileRows + w * kWgRows, num_points,
                      pos_enc, d.e_pos, d.include_inputs, d.pos_width,
                      base + w * region_bytes + reg.pos(), 0, warp,
                      kEncoderWarps, lane);
          hopper::fence_async_shared();
          hopper::mbar_arrive(pos_ready + 8 * w);
        }
        for (int w = 0; w < 2; ++w) {
          hopper::mbar_wait(view_free + 8 * w, parity ^ 1u);
          encode_rows(views, tile * kTileRows + w * kWgRows, num_points,
                      view_enc, d.e_view, d.include_inputs, d.view_width,
                      base + w * region_bytes + reg.view(), 0, warp,
                      kEncoderWarps, lane);
          hopper::fence_async_shared();
          hopper::mbar_arrive(view_ready + 8 * w);
        }
        parity ^= 1u;
      }
    }
    return;
  }

  hopper::regs_increase<kConsumerRegs>();
  const int t = threadIdx.x & 127;
  const int ct = threadIdx.x;          // 0..255 over both warpgroups
  const int warp = t >> 5;
  const int lane = t & 31;
  const uint32_t act = base + wg * region_bytes;
  const uint32_t barrier_id = 1 + wg;
  const bool releases = lane == 0;
  const bool copies = t == 0;          // issues the warpgroup's bulk copies
  const int r0 = 16 * warp + (lane >> 2);
  const int pair = 2 * (lane & 3);
  const Fragment f = fragment_of(warp, lane);
  Ring ring{ring_base, stage_bytes, full, empty, stages, 0, 0u};
  const int P = d.pos_width;
  const int V = d.view_width;
  const int pos_col = H * 64;              // from act
  const int view_col = (H + reg.Pb) * 64;
  const Records rec = records_of(d, num_points);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  auto g_row = [&](long long p) {
    return p < num_points ? __ldg(g4 + p) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto wg_sync = [&] { hopper::named_barrier(barrier_id, 128); };
  long long row_block = 0;
  // the blocks at `from` leave for tensor `tensor`'s record of this row block
  auto park = [&](int tensor, uint32_t from) {
    if (copies) {
      hopper::bulk_store(records + rec.at(tensor, row_block), from,
                         rec.blocks(tensor) * kBlockBytes);
      hopper::bulk_commit();
    }
  };
  // before act is written again: every park has read it
  auto parked = [&] {
    if (copies) hopper::bulk_wait_read();
    wg_sync();
  };
  // element e of this row block's head sums (element-major: the sum kernel
  // reads each element's row blocks in one run)
  auto head = [&](int e) -> float& {
    return heads[e * rec.rows + row_block];
  };
  // the ReLU mask of h_i at this thread's fragment, in and out of `masks`
  auto mask_word = [&](int i) {
    return masks + (row_block * L + i) * 128 + t;
  };
  auto load_mask = [&](int i, uint32_t* mask) {
    const uint4 m = *mask_word(i);
    const uint32_t w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int s = 0; s < H; ++s) mask[s] = w[s];
  };
  // the opacity head's weights, f32, for the bottleneck's dX epilogue (read
  // after the first tile's barriers)
  for (int k = t; k < C; k += 128) {
    opacity_w[k] = slab_weight(image, offsets.at[L], kHeadWidth, k, 0);
  }
  float acc[32 * H];
  uint32_t mask[4];
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows + wg * kWgRows;
    row_block = 2 * tile + wg;
    // ---- the recompute: K1's products and epilogues, each input parked ----
    hopper::mbar_wait(pos_ready + 8 * wg, parity);
    park(rec.pos(), act + reg.pos());
    for (int i = 0; i < L; ++i) {
      const bool skip = i > 0 && ((d.skip_mask >> i) & 1u);
      const int K = i == 0 ? P : C + (skip ? P : 0);
      layer_product<C>(acc, ring, act, K, i == 0 ? 0 : C,
                       i == 0 ? pos_col : pos_col - C, releases);
      parked();
      store_layer<C, true, true, kBiasBatch, true>(acc, biases + d.b_off[i],
                                                   act, f, pair, mask);
      *mask_word(i) = make_uint4(mask[0], H > 1 ? mask[1] : 0u,
                                 H > 2 ? mask[2] : 0u, H > 3 ? mask[3] : 0u);
      rows_ready(barrier_id);
      park(rec.h(i), act);
    }
    // the opacity head's dW over h_{L-1}, f32 on the CUDA cores: a column a
    // thread, the rows in order, g broadcast 32 rows at a time by shuffles
    for (int c0 = 0; c0 < C; c0 += 128) {
      const int c = c0 + t;
      float s = 0.0f;
      for (int r = 0; r < kWgRows; r += 32) {
        const float gl = g_row(row0 + r + lane).w;
#pragma unroll 8
        for (int q = 0; q < 32; ++q) {
          s = fmaf(shared_bf16(act_addr(act, r + q, c < C ? c : 0)),
                   __shfl_sync(0xffffffffu, gl, q), s);
        }
      }
      if (c < C) head(3 * C / 2 + c) = s;
    }
    // the bottleneck, in place over h_{L-1}
    layer_product<C>(acc, ring, act, C, C, 0, releases);
    parked();
    store_layer<C, false, true, kBiasBatch>(acc, biases + d.b_off[L + 1], act,
                                             f, pair);
    rows_ready(barrier_id);
    park(rec.b(), act);
    // the hidden layer over [bottleneck | view features], in place
    hopper::mbar_wait(view_ready + 8 * wg, parity);
    park(rec.view(), act + reg.view());
    layer_product<C / 2>(acc, ring, act, C + V, C, view_col - C, releases);
    // the parks have read the features: free for the next tile's (the
    // backward reads neither)
    parked();
    if (releases) {
      hopper::mbar_arrive(pos_free + 8 * wg);
      hopper::mbar_arrive(view_free + 8 * wg);
    }
    store_layer<C / 2, true, true, kBiasBatch>(acc, biases + d.b_off[L + 2],
                                                act, f, pair);
    rows_ready(barrier_id);

    // ---- the color head and the heads' biases, f32 over the 64 rows ----
    // (g reaches a warp 32 rows at a time, a row a lane, and each row is
    // broadcast by shuffles: a load a row for every thread waited on L2 one
    // row after another)
    if (t < (C / 2 + 31) / 32 * 32) {
      // a column a thread, the rows in order
      const int c = t < C / 2 ? t : 0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      for (int r = 0; r < kWgRows; r += 32) {
        const float4 gl = g_row(row0 + r + lane);
#pragma unroll 8
        for (int q = 0; q < 32; ++q) {
          const float h = shared_bf16(act_addr(act, r + q, c));
          s0 = fmaf(h, __shfl_sync(0xffffffffu, gl.x, q), s0);
          s1 = fmaf(h, __shfl_sync(0xffffffffu, gl.y, q), s1);
          s2 = fmaf(h, __shfl_sync(0xffffffffu, gl.z, q), s2);
        }
      }
      if (t < C / 2) {
        head(3 * t) = s0;
        head(3 * t + 1) = s1;
        head(3 * t + 2) = s2;
      }
    }
    if (warp == 0) {
      // lane l sums rows l and l + 32, then a fixed butterfly over the lanes
      const float4 a = g_row(row0 + lane);
      const float4 b = g_row(row0 + 32 + lane);
      float4 s = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
        s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
        s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
        s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
      }
      if (lane == 0) {
        head(5 * C / 2) = s.x;
        head(5 * C / 2 + 1) = s.y;
        head(5 * C / 2 + 2) = s.z;
        head(5 * C / 2 + 3) = s.w;
      }
    }
    wg_sync();
    // dz of the hidden layer, in place over it: (g_color color_w^T) masked;
    // a thread a column, its three color weights read once, g broadcast as
    // in the heads
    if (t < (C / 2 + 31) / 32 * 32) {
      const int c = t < C / 2 ? t : 0;
      const long long color = offsets.at[L + 3];
      const float w0 = slab_weight(image, color, kHeadWidth, c, 0);
      const float w1 = slab_weight(image, color, kHeadWidth, c, 1);
      const float w2 = slab_weight(image, color, kHeadWidth, c, 2);
      for (int r = 0; r < kWgRows; r += 32) {
        const float4 gl = g_row(row0 + r + lane);
#pragma unroll 8
        for (int q = 0; q < 32; ++q) {
          const uint32_t at = act_addr(act, r + q, c);
          const float dh = fmaf(__shfl_sync(0xffffffffu, gl.z, q), w2,
                                fmaf(__shfl_sync(0xffffffffu, gl.y, q), w1,
                                     __shfl_sync(0xffffffffu, gl.x, q) * w0));
          if (t < C / 2) st_bf16(at, shared_bf16(at) > 0.0f ? dh : 0.0f);
        }
      }
    }
    rows_ready(barrier_id);

    // ---- the backward: each dz parked, then dz <- its dX, in place ----
    // the hidden layer: d bottleneck = dz W^T, unmasked
    park(rec.dz_hidden(), act);
    dx_product<C / 2, H>(acc, ring, act, releases);
    parked();
    store_dz<C, false, false>(acc, mask, act, f, pair, 0.0f, 0.0f, nullptr);
    rows_ready(barrier_id);
    park(rec.dz_bottleneck(), act);
    // the bottleneck: dh_{L-1} = d_b W^T + g_op opacity_w, masked by h_{L-1}
    load_mask(L - 1, mask);
    dx_product<C, H>(acc, ring, act, releases);
    parked();
    store_dz<C, true, true>(acc, mask, act, f, pair, g_row(row0 + r0).w,
                            g_row(row0 + r0 + 8).w, opacity_w);
    rows_ready(barrier_id);
    // body layers, last to first: dz_{i-1} = (dz_i W^T) masked by h_{i-1}
    for (int i = L - 1; i >= 0; --i) {
      park(rec.dz(i), act);
      if (i == 0) break;
      load_mask(i - 1, mask);
      dx_product<C, H>(acc, ring, act, releases);
      parked();
      store_dz<C, false, true>(acc, mask, act, f, pair, 0.0f, 0.0f, nullptr);
      rows_ready(barrier_id);
    }
    parity ^= 1u;
  }
  // the last parks are written before the block leaves
  if (copies) hopper::bulk_wait();
}

// The shared memory a bf16 launch needs (0 if the model does not fit with
// two ring stages) and the stages it gets: two warpgroups' regions, the
// ring, its barriers and the opacity head's f32 weights.
size_t bf16_shared_bytes(const Desc& d, int* stages) {
  const size_t fixed = kAlignSlack + 2ull * region_of(d).bytes()
                       + kBarrierBytes + 4ull * d.channels;
  const size_t stage = static_cast<size_t>(d.channels) * 128;
  if (fixed + 2 * stage > kSharedLimit) return 0;
  const size_t fit = (kSharedLimit - fixed) / stage;
  *stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return fixed + *stages * stage;
}

// The blocks of a launch on the current device over tiles of `rows`
// points: one per tile, at most one per SM.
cudaError_t block_grid(long long num_points, int rows, long long* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (num_points + rows - 1) / rows;
  *grid = tiles < sms ? tiles : sms;
  return cudaSuccess;
}

// ---- pass 2: dW = X^T dz over all points, split-K in a fixed order ------

// One input segment of a layer's dW: tensor `tensor` of the records feeds
// rows [out_row, out_row + rows) of the weight.
struct DwSegment {
  int tensor;
  int rows;
  int out_row;
};

// dW layer k of pass 2 (body layers 0 .. L-1, then the bottleneck, then the
// hidden layer): its packed layer, its dz tensor, its outputs N, and its
// input segments (returned: 1 or 2).
struct DwLayer {
  int packed;
  int dz;
  int N;
  int count;
  DwSegment seg[2];
  // 64-row slices of its inputs
  __host__ __device__ int slices() const {
    int n = 0;
    for (int s = 0; s < count; ++s) n += (seg[s].rows + 63) / 64;
    return n;
  }
  // two slices an item: one for each consumer warpgroup
  __host__ __device__ int pairs() const { return (slices() + 1) / 2; }
  // the tensor, 8 KB block and first weight row of slice q (rows: how many
  // of its 64 rows the weight has)
  __host__ __device__ DwSegment slice(int q, int* block) const {
    int s = 0;
    int first = (seg[0].rows + 63) / 64;
    if (q >= first) {
      s = 1;
      q -= first;
    }
    const int left = seg[s].rows - 64 * q;
    *block = q;
    return DwSegment{seg[s].tensor, left < 64 ? left : 64,
                     seg[s].out_row + 64 * q};
  }
};

__host__ __device__ inline DwLayer dw_layer(const Desc& d, const Records& r,
                                            int k) {
  const int L = d.num_layers;
  const int C = d.channels;
  DwLayer l{};
  if (k < L) {
    l.packed = k;
    l.dz = r.dz(k);
    l.N = C;
    if (k == 0) {
      l.count = 1;
      l.seg[0] = DwSegment{r.pos(), d.pos_width, 0};
    } else {
      l.count = ((d.skip_mask >> k) & 1u) ? 2 : 1;
      l.seg[0] = DwSegment{r.h(k - 1), C, 0};
      l.seg[1] = DwSegment{r.pos(), d.pos_width, C};
    }
  } else if (k == L) {
    l.packed = L + 1;
    l.dz = r.dz_bottleneck();
    l.N = C;
    l.count = 1;
    l.seg[0] = DwSegment{r.h(L - 1), C, 0};
  } else {
    l.packed = L + 2;
    l.dz = r.dz_hidden();
    l.N = C / 2;
    l.count = 2;
    l.seg[0] = DwSegment{r.b(), C, 0};
    l.seg[1] = DwSegment{r.view(), d.view_width, C};
  }
  return l;
}

// Pass 2's split: `ranges` ranges of `range_rows` row blocks (the last
// shorter), and an item for each (layer, range, pair of slices), in that
// order, so the items that read one dz range run side by side.
struct DwPlan {
  int ranges;
  long long range_rows;
  int items;
};

// Items enough for kDwWaves per SM, each range at least kDwMinRows row
// blocks (4,096 points), so that a partial's write stays a small share of
// what its item reads.
constexpr int kDwWaves = 4;
constexpr long long kDwMinRows = 64;

DwPlan dw_plan(const Desc& d, const Records& r, int sms) {
  int pairs = 0;
  for (int k = 0; k < d.num_layers + 2; ++k) pairs += dw_layer(d, r, k).pairs();
  long long ranges = (static_cast<long long>(kDwWaves) * sms + pairs - 1)
                     / pairs;
  const long long most = r.rows / kDwMinRows;
  if (ranges > most) ranges = most;
  if (ranges < 1) ranges = 1;
  DwPlan plan;
  plan.range_rows = (r.rows + ranges - 1) / ranges;
  plan.ranges = static_cast<int>((r.rows + plan.range_rows - 1)
                                 / plan.range_rows);
  plan.items = plan.ranges * pairs;
  return plan;
}

// The weights' and the biases' elements of the pack.
__host__ __device__ inline long long weight_count(const Desc& d) {
  return d.w_off[d.num_layers + 3] + (d.channels / 2) * kHeadWidth;
}
__host__ __device__ inline long long bias_count(const Desc& d) {
  return d.b_off[d.num_layers + 3] + kHeadWidth;
}

constexpr int kDwStageSlices = 2;    // X blocks a stage, one a warpgroup

// One item's products for a consumer warpgroup: acc = sum over the range's
// row blocks of X_slice^T dz (M = 64 input columns, K = 64 points a row
// block, N outputs; both operands MN-major as they lie), and, when `bias`,
// the column sums of dz for the thread's column `ct`. Every stage is
// released once its products and sums are done.
template <int N>
__device__ __forceinline__ void dw_range(float* acc, float* bias_sum,
                                         Ring& ring, long long rows,
                                         bool has, bool bias,
                                         int wg, int ct, bool releases) {
  const uint32_t dz_at = kDwStageSlices * kBlockBytes;
  hopper::fence_registers<N / 2>(acc);
  hopper::wgmma_fence();
  float s = 0.0f;
  int held = -1;
  for (long long r = 0; r < rows; ++r) {
    hopper::mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    const uint32_t stage = ring.base + ring.stage * ring.stage_bytes;
    if (has) {
#pragma unroll
      for (int k = 0; k < kWgRows; k += 16) {
        hopper::mma<N, 1, 1>(
            acc, hopper::desc_sw128_mn(stage + wg * kBlockBytes + k * 128),
            hopper::desc_sw128_mn(stage + dz_at + k * 128), r > 0 || k > 0);
      }
      hopper::wgmma_commit();
    }
    if (bias && ct < N) {
      const uint32_t dz = stage + dz_at;
#pragma unroll 8
      for (int p = 0; p < kWgRows; ++p) {
        s += shared_bf16(act_addr(dz, p, ct));
      }
    }
    if (held >= 0) {
      if (has) hopper::wgmma_wait<1>();
      if (releases) hopper::mbar_arrive(ring.empty + 8 * held);
    }
    held = ring.stage;
    ring.advance();
  }
  if (has) hopper::wgmma_wait<0>();
  hopper::fence_registers<N / 2>(acc);
  if (releases && held >= 0) hopper::mbar_arrive(ring.empty + 8 * held);
  *bias_sum = s;
}

// acc (the thread's fragment of a 64 x N product) into rows [0, rows) of
// the f32 matrix at `out`, N floats a row.
template <int N>
__device__ __forceinline__ void store_fragment(const float* acc, float* out,
                                               int rows, int r0, int pair) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    if (m < rows) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        *reinterpret_cast<float2*>(out + static_cast<long long>(m) * N + 8 * j
                                   + pair) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// Pass 2, persistent and warp-specialised: one block per SM walks the items
// of `plan` (item = blockIdx.x, + gridDim.x, ...). One producer thread loads
// each row block's X slices (one 8 KB block per consumer warpgroup) and the
// layer's dz blocks through a ring of stages with bulk copies; each consumer
// warpgroup sums X_slice^T dz over the item's range of row blocks in f32
// registers (K = every point of the range) and writes the 64 x N result,
// and on the first pair of a layer the bias sums, into the range's row of
// `partial` ([ranges, weights + biases] f32), in the pack's layout.
template <int C>
__global__ void __launch_bounds__(kBf16Threads, 1)
fused_nerf_backward_dw_bf16_kernel(const char* __restrict__ records,
                                   float* __restrict__ partial, Desc d,
                                   Records rec, DwPlan plan, int stages) {
  extern __shared__ __align__(1024) unsigned char dw_smem[];
  const uint32_t base = (hopper::smem_addr(dw_smem) + kAlignSlack - 1)
                        & ~static_cast<uint32_t>(kAlignSlack - 1);
  const uint32_t stage_bytes = (kDwStageSlices + rec.H) * kBlockBytes;
  const uint32_t full = base + stages * stage_bytes;
  const uint32_t empty = full + 8 * kMaxStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // item -> its layer, range and pair
  auto decode = [&](int item, DwLayer* layer, int* range, int* pair) {
    int k = 0;
    for (;; ++k) {
      *layer = dw_layer(d, rec, k);
      const int here = plan.ranges * layer->pairs();
      if (item < here) break;
      item -= here;
    }
    *range = item / layer->pairs();
    *pair = item - *range * layer->pairs();
  };
  const int wg = warpgroup();
  if (wg == 2) {
    hopper::regs_decrease<kProducerRegs>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < plan.items; item += gridDim.x) {
        DwLayer layer;
        int range, pair;
        decode(item, &layer, &range, &pair);
        const int slices = layer.slices();
        DwSegment x[kDwStageSlices];
        int block[kDwStageSlices];
        for (int w = 0; w < kDwStageSlices; ++w) {
          if (2 * pair + w < slices) {
            x[w] = layer.slice(2 * pair + w, &block[w]);
          }
        }
        const bool two = 2 * pair + 1 < slices;
        const uint32_t dz_bytes = rec.blocks(layer.dz) * kBlockBytes;
        const long long r0 = range * plan.range_rows;
        long long r1 = r0 + plan.range_rows;
        if (r1 > rec.rows) r1 = rec.rows;
        for (long long r = r0; r < r1; ++r) {
          const uint32_t at = base + stage * stage_bytes;
          hopper::mbar_wait(empty + 8 * stage, phase ^ 1u);
          hopper::mbar_arrive_expect_tx(
              full + 8 * stage, (two ? 2 : 1) * kBlockBytes + dz_bytes);
          for (int w = 0; w < (two ? 2 : 1); ++w) {
            hopper::bulk_load(at + w * kBlockBytes,
                              records + rec.at(x[w].tensor, r)
                                  + block[w] * kBlockBytes,
                              kBlockBytes, full + 8 * stage);
          }
          hopper::bulk_load(at + kDwStageSlices * kBlockBytes,
                            records + rec.at(layer.dz, r), dz_bytes,
                            full + 8 * stage);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
      // Leave only once the consumers have released every stage.
      for (int s = 0; s < stages; ++s) {
        hopper::mbar_wait(empty + 8 * stage, phase ^ 1u);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  hopper::regs_increase<kConsumerRegs>();
  const int t = threadIdx.x & 127;
  const int ct = threadIdx.x;          // 0..255 over both warpgroups
  const int lane = t & 31;
  const bool releases = lane == 0;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
  const int pair_col = 2 * (lane & 3);
  const long long params = weight_count(d) + bias_count(d);
  Ring ring{base, stage_bytes, full, empty, stages, 0, 0u};
  float acc[C / 2];
  for (int item = blockIdx.x; item < plan.items; item += gridDim.x) {
    DwLayer layer;
    int range, pair;
    decode(item, &layer, &range, &pair);
    const bool has = 2 * pair + wg < layer.slices();
    const bool bias = pair == 0;
    const long long first = range * plan.range_rows;
    long long rows = rec.rows - first;
    if (rows > plan.range_rows) rows = plan.range_rows;
    float* const row = partial + range * params;
    float bias_sum = 0.0f;
    if (layer.N == C) {
      dw_range<C>(acc, &bias_sum, ring, rows, has, bias, wg, ct, releases);
    } else {
      dw_range<C / 2>(acc, &bias_sum, ring, rows, has, bias, wg, ct,
                      releases);
    }
    if (has) {
      int block;
      const DwSegment s = layer.slice(2 * pair + wg, &block);
      float* const out = row + d.w_off[layer.packed]
                         + static_cast<long long>(s.out_row) * layer.N;
      if (layer.N == C) {
        store_fragment<C>(acc, out, s.rows, r0, pair_col);
      } else {
        store_fragment<C / 2>(acc, out, s.rows, r0, pair_col);
      }
    }
    if (bias && ct < layer.N) {
      row[weight_count(d) + d.b_off[layer.packed] + ct] = bias_sum;
    }
  }
}

// The sum (written, or added to what is there when `accumulate`) of every
// weight and bias gradient: the `ranges` rows of `partial` in order for the
// layers pass 2 reduced; for the heads, pass 1's sums of `rows` row blocks,
// each warp one element: lane l the row blocks l, l + 32, ... in order, then
// a fixed butterfly over the lanes; zero for the heads' padding columns. The
// first `main_blocks` blocks take the layers' elements, the rest the heads'.
__global__ void __launch_bounds__(256)
fused_nerf_backward_sum_kernel(const float* __restrict__ partial, int ranges,
                               const float* __restrict__ heads,
                               long long rows, float* __restrict__ d_weights,
                               float* __restrict__ d_biases, Desc d,
                               int main_blocks, int accumulate) {
  const int L = d.num_layers;
  const int C = d.channels;
  const long long num_w = weight_count(d);
  const long long params = num_w + bias_count(d);
  if (static_cast<int>(blockIdx.x) < main_blocks) {
    const long long opacity_w = d.w_off[L];
    const long long color_w = d.w_off[L + 3];
    const long long opacity_b = num_w + d.b_off[L];
    const long long color_b = num_w + d.b_off[L + 3];
    for (long long i = blockIdx.x * 256ll + threadIdx.x; i < params;
         i += main_blocks * 256ll) {
      const bool in_head = (i >= opacity_w && i < opacity_w + C * kHeadWidth)
                           || (i >= color_w && i < num_w)
                           || (i >= opacity_b && i < opacity_b + kHeadWidth)
                           || i >= color_b;
      float* const out = i < num_w ? d_weights + i : d_biases + (i - num_w);
      if (in_head) {
        // padding columns: 0; the heads' own columns: the warps below
        const long long c = i < num_w ? (i - (i < color_w ? opacity_w
                                                          : color_w))
                                            % kHeadWidth
                                      : i - (i < color_b ? opacity_b
                                                         : color_b);
        const bool own = (i < color_w || (i >= opacity_b && i < color_b))
                             ? c == 0 : c < 3;
        if (!own && !accumulate) *out = 0.0f;
        continue;
      }
      float v = 0.0f;
      for (int s = 0; s < ranges; ++s) v += partial[s * params + i];
      *out = accumulate ? *out + v : v;
    }
    return;
  }
  const int hf = head_floats(C);
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x - main_blocks) * 8;
  for (int e = (blockIdx.x - main_blocks) * 8 + threadIdx.x / 32; e < hf;
       e += warps) {
    float v = 0.0f;
    for (long long r = lane; r < rows; r += 32) v += heads[e * rows + r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) {
      float* out;
      if (e < 3 * C / 2) {
        out = d_weights + d.w_off[L + 3] + (e / 3) * kHeadWidth + e % 3;
      } else if (e < 5 * C / 2) {
        out = d_weights + d.w_off[L] + (e - 3 * C / 2) * kHeadWidth;
      } else if (e < 5 * C / 2 + 3) {
        out = d_biases + d.b_off[L + 3] + (e - 5 * C / 2);
      } else {
        out = d_biases + d.b_off[L];
      }
      *out = accumulate ? *out + v : v;
    }
  }
}

// The points of a slice: K2 bf16 runs both passes a slice at a time, so its
// records hold at most this many points (2.5 GB at the flagship).
constexpr long long kSlicePoints = 262144;

// The bf16 scratch of a launch over num_points: the records of one slice,
// the heads' sums and the ReLU masks of its row blocks, and pass 2's
// partials (at 1024-byte boundaries).
struct Bf16Scratch {
  long long records, heads, masks, partial, bytes;
};

inline long long align_up(long long x) { return (x + 1023) / 1024 * 1024; }

Bf16Scratch bf16_scratch(const Desc& d, long long num_points, int sms) {
  const long long points = num_points < kSlicePoints ? num_points
                                                     : kSlicePoints;
  const Records rec = records_of(d, points);
  Bf16Scratch s;
  s.records = 0;
  s.heads = align_up(rec.bytes());
  s.masks = s.heads + align_up(rec.rows * head_floats(d.channels) * 4ll);
  s.partial = s.masks + align_up(mask_bytes(d, rec.rows));
  s.bytes = s.partial + align_up(dw_plan(d, rec, sms).ranges * 4ll
                                 * (weight_count(d) + bias_count(d)));
  return s;
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// The shared memory of a pass-2 launch and its stages: as many stages of
// two X blocks and a dz row block as fit, up to kMaxStages.
size_t dw_shared_bytes(const Desc& d, int* stages) {
  const size_t fixed = kAlignSlack + 16 * kMaxStages;
  const size_t stage = (kDwStageSlices + region_of(d).H) * kBlockBytes;
  const size_t fit = (kSharedLimit - fixed) / stage;
  *stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return fixed + *stages * stage;
}

template <int C>
cudaError_t launch_bf16(const void* positions, const void* views,
                        const void* pos_enc, const void* view_enc,
                        const void* slabs, const void* biases, const void* g,
                        void* d_weights, void* d_biases, void* scratch,
                        long long scratch_bytes, long long num_points,
                        const Desc& d, long long* dw_launches,
                        cudaStream_t stream) {
  static ffn::SharedLimit limit, dw_limit;
  int stages = 0, dw_stages = 0;
  const size_t smem = bf16_shared_bytes(d, &stages);
  if (smem == 0) return cudaErrorInvalidValue;
  const size_t dw_smem = dw_shared_bytes(d, &dw_stages);
  cudaError_t err =
      ffn::reserve_shared(fused_nerf_backward_bf16_kernel<C>, smem, limit);
  if (err != cudaSuccess) return err;
  err = ffn::reserve_shared(fused_nerf_backward_dw_bf16_kernel<C>, dw_smem,
                            dw_limit);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Bf16Scratch carve = bf16_scratch(d, num_points, sms);
  if (scratch_bytes < carve.bytes) return cudaErrorInvalidValue;
  char* const base = static_cast<char*>(scratch);
  char* const records = base + carve.records;
  float* const heads = reinterpret_cast<float*>(base + carve.heads);
  uint4* const masks = reinterpret_cast<uint4*>(base + carve.masks);
  float* const partial = reinterpret_cast<float*>(base + carve.partial);
  const SlabOffsets offsets = slab_offsets(d);
  const float* const pos = static_cast<const float*>(positions);
  const float* const dir = static_cast<const float*>(views);
  const float* const cot = static_cast<const float*>(g);
  const long long params = weight_count(d) + bias_count(d);
  for (long long p0 = 0; p0 < num_points; p0 += kSlicePoints) {
    const long long n = num_points - p0 < kSlicePoints ? num_points - p0
                                                       : kSlicePoints;
    const Records rec = records_of(d, n);
    const long long tiles = rec.rows / 2;
    const long long grid = tiles < sms ? tiles : sms;
    fused_nerf_backward_bf16_kernel<C>
        <<<static_cast<unsigned>(grid), kBf16Threads, smem, stream>>>(
            pos + 3 * p0, dir + 3 * p0, static_cast<const float*>(pos_enc),
            static_cast<const float*>(view_enc),
            static_cast<const Bf16*>(slabs), static_cast<const float*>(biases),
            cot + 4 * p0, heads, masks, records, n, d, offsets, stages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const DwPlan plan = dw_plan(d, rec, sms);
    const int dw_grid = plan.items < sms ? plan.items : sms;
    fused_nerf_backward_dw_bf16_kernel<C>
        <<<dw_grid, kBf16Threads, dw_smem, stream>>>(records, partial, d, rec,
                                                      plan, dw_stages);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*dw_launches;
    const int main_blocks = static_cast<int>((params + 255) / 256 < 2 * sms
                                                 ? (params + 255) / 256
                                                 : 2 * sms);
    const int head_blocks = (head_floats(d.channels) + 7) / 8;
    fused_nerf_backward_sum_kernel<<<main_blocks + head_blocks, 256, 0,
                                     stream>>>(
        partial, plan.ranges, heads, rec.rows, static_cast<float*>(d_weights),
        static_cast<float*>(d_biases), d, main_blocks, p0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// f32: the 3xTF32 kernel on K1's f32 routines (fused_nerf_tf32.cuh)
// ---------------------------------------------------------------------------

namespace t32 = ffn::tf32;

constexpr int kTf32Threads = 256;     // one consumer warpgroup, one producer
constexpr int kTf32Rows = 64;         // points a tile
constexpr int kTf32ConsumerWarps = 4;
// full and empty per stage; positional and view features written and read;
// the arrival of the reloaded h
constexpr int kTf32BarrierBytes = (2 * kMaxStages + 5) * 8;
constexpr uint32_t kWgBarrier = 1;
// dW's workers: the consumer warpgroup's four warps and the three encoder
// warps, which meet at a barrier of their own before and after each layer's
// dW
constexpr int kDwWorkers = kTf32ConsumerWarps + kEncoderWarps;
constexpr uint32_t kDwBarrier = 2;

// The consumer warpgroup's shared memory: dz^T, feature-major (C rows of the
// tile's 64 points, as two 32-column blocks of C rows), then x, point-major
// (64 rows of [h (C) | positional features (Pb blocks) | view features (Vb
// blocks)], 32-column blocks). The recompute writes h in x and the hidden
// layer, point-major, where dz^T goes.
struct Tf32Region {
  int C, Pb, Vb;
  __host__ __device__ uint32_t dzt_bytes() const { return C * 256u; }
  __host__ __device__ uint32_t bytes() const {
    return dzt_bytes() + (C / 32 + Pb + Vb) * t32::kBlockBytes;
  }
  __host__ __device__ int pos_col() const { return C; }
  __host__ __device__ int view_col() const { return C + 32 * Pb; }
};

__host__ __device__ inline Tf32Region tf32_region_of(const Desc& d) {
  return Tf32Region{d.channels, (d.pos_width + 31) / 32,
                    (d.view_width + 31) / 32};
}

// A fragment loader for dz (points x outputs) from dz^T, which holds C rows:
// a[0] = dz[r0][k + tig], a[1] row + 8, a[2] column + 4, a[3] both.
struct FeatureMajorA {
  uint32_t dzt;
  int rows;
  int r0;
  int tig;
  __device__ __forceinline__ void operator()(int k, uint32_t* x) const {
    x[0] = __float_as_uint(t32::ld_f32(t32::f32_addr(dzt, k + tig, r0, rows)));
    x[1] = __float_as_uint(
        t32::ld_f32(t32::f32_addr(dzt, k + tig, r0 + 8, rows)));
    x[2] = __float_as_uint(
        t32::ld_f32(t32::f32_addr(dzt, k + tig + 4, r0, rows)));
    x[3] = __float_as_uint(
        t32::ld_f32(t32::f32_addr(dzt, k + tig + 4, r0 + 8, rows)));
  }
};

// Columns [col, col + rows) of x that feed rows [out_row, out_row + rows)
// of a layer's dW.
struct XCols {
  int col;
  int rows;
  int out_row;
};

// dW[out_row + f][n] += sum over the tile's 64 points of X[p][f] dz[p][n],
// for each segment of X, on mma.sync m16n8k8 (3xTF32 as in layer_tf32: X
// lies point-major and dz feature-major, and wgmma would need both K-major,
// that is feature-major, in shared memory as hi and lo copies, which the
// budget has no room for; mma.sync loads its fragments from any layout into
// registers, where they are split). kDwWorkers warps (the consumer's four
// and the three encoders, which are idle then) take chunks of 32 x 64 of dW
// in turn; each pair of lanes adds its two fragments with two float4
// atomics. X is read through a generic pointer to the shared rows (`x`), so
// that the compiler may schedule those loads among the products.
template <int N>
__device__ __forceinline__ void dw_sync(const XCols* segs, int count,
                                        const float* x, uint32_t dzt, int C,
                                        float* __restrict__ grad, int worker,
                                        int lane) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
  int chunk = 0;
  for (int s = 0; s < count; ++s) {
    const XCols seg = segs[s];
    for (int f0 = 0; f0 < seg.rows; f0 += 32) {
      for (int n0 = 0; n0 < N; n0 += 64, ++chunk) {
        if (chunk % kDwWorkers != worker) continue;
        float acc[2][8][4] = {};
        for (int k0 = 0; k0 < kTf32Rows; k0 += 8) {
          uint32_t ah[2][4], al[2][4], bh[8][2], bl[8][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (f0 + 16 * mt < seg.rows) {
              const int col = seg.col + f0 + 16 * mt + gid;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float v = x[t32::f32_addr(0, k0 + tig + 4 * (i >> 1),
                                                col + 8 * (i & 1)) / 4];
                hopper::tf32_split(v, &ah[mt][i], &al[mt][i]);
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < 8; nt += 2) {   // N is a multiple of 16
            if (n0 + 8 * nt < N) {
              // b[0], b[1] of tiles nt and nt + 1: four 8x4 f32 blocks
              uint32_t b[4];
              hopper::ldmatrix_x4(
                  t32::f32_addr(dzt, n0 + 8 * (nt + (lane >> 4)) + (lane & 7),
                                k0 + 4 * ((lane >> 3) & 1), C),
                  b);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                hopper::tf32_split(__uint_as_float(b[i]),
                                   &bh[nt + i / 2][i % 2],
                                   &bl[nt + i / 2][i % 2]);
              }
            }
          }
          // the three terms in turn over all 16 tiles, so that no product
          // waits on the one before it into the same sum
#pragma unroll
          for (int term = 0; term < 3; ++term) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                if (f0 + 16 * mt < seg.rows && n0 + 8 * nt < N) {
                  hopper::mma_sync_tf32(acc[mt][nt],
                                        term == 0 ? al[mt] : ah[mt],
                                        term == 1 ? bl[nt] : bh[nt]);
                }
              }
            }
          }
        }
        // one float4 atomic a lane and tile: a lane with even tig adds row
        // gid, columns 2 tig .. 2 tig + 3 (its own pair and its neighbour's),
        // its neighbour row gid + 8 at the same columns
        const bool even = (tig & 1) == 0;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (f0 + 16 * mt < seg.rows && n0 + 8 * nt < N) {
              const float* a = acc[mt][nt];
              const float r0 = __shfl_xor_sync(0xffffffffu,
                                               even ? a[2] : a[0], 1);
              const float r1 = __shfl_xor_sync(0xffffffffu,
                                               even ? a[3] : a[1], 1);
              float* out = grad
                           + static_cast<long long>(seg.out_row + f0 + 16 * mt
                                                    + gid + (even ? 0 : 8))
                                 * N
                           + n0 + 8 * nt + 2 * (tig & 2);
              atomicAdd(reinterpret_cast<float4*>(out),
                        even ? make_float4(a[0], a[1], r0, r1)
                             : make_float4(r0, r1, a[2], a[3]));
            }
          }
        }
      }
    }
  }
}

// db[n] += sum over the tile's 64 points of dz[p][n], n < N: a thread a
// column, its row of dz^T read a chunk at a time.
__device__ __forceinline__ void bias_grad_f32(uint32_t dzt, int C, int N,
                                              int t,
                                              float* __restrict__ grad) {
  for (int n = t; n < N; n += 128) {
    float s = 0.0f;
    for (int p = 0; p < kTf32Rows; p += 4) {
      const float4 v = t32::ld_f32x4(t32::f32_addr(dzt, n, p, C));
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
    }
    atomicAdd(grad + n, s);
  }
}

// The ReLU mask of this thread's dX fragment: bit 4 (j % 8) + 2 h + c of
// word j / 8 says x[r0 + 8h][8j + pair + c] > 0.
template <int C>
__device__ __forceinline__ void relu_mask_f32(uint32_t* mask, uint32_t x,
                                              int r0, int pair) {
#pragma unroll
  for (int w = 0; w < (C + 63) / 64; ++w) mask[w] = 0;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float v =
            t32::ld_f32(t32::f32_addr(x, r0 + 8 * h, 8 * j + pair + c));
        mask[j >> 3] |= static_cast<uint32_t>(v > 0.0f)
                        << (4 * (j & 7) + 2 * h + c);
      }
    }
  }
}

// dz^T[:, rows r0, r0 + 8] = dX with the opacity head's f32 term g_op w_op
// added (kOpacity; g0, g8 the rows' g_op, w_op the exact (C, 16) head) and
// the ReLU mask applied (kMask).
template <int C, bool kOpacity, bool kMask>
__device__ __forceinline__ void store_dzt(const float* acc,
                                          const uint32_t* mask, uint32_t dzt,
                                          int r0, int pair, float g0,
                                          float g8,
                                          const float* __restrict__ w_op) {
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 8 * j + pair + c;
        float v = acc[4 * j + 2 * h + c];
        if (kOpacity) v += (h ? g8 : g0) * __ldg(w_op + n * kHeadWidth);
        if (kMask && !((mask[j >> 3] >> (4 * (j & 7) + 2 * h + c)) & 1u)) {
          v = 0.0f;
        }
        t32::st_f32(t32::f32_addr(dzt, n, r0 + 8 * h, C), v);
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kTf32Threads, 1)
fused_nerf_backward_tf32_kernel(const float* __restrict__ positions,
                                const float* __restrict__ views,
                                const float* __restrict__ pos_enc,
                                const float* __restrict__ view_enc,
                                const float* __restrict__ image,
                                const float* __restrict__ biases,
                                const float* __restrict__ g,
                                float* __restrict__ d_weights,
                                float* __restrict__ d_biases,
                                char* __restrict__ scratch,
                                long long num_points, Desc d,
                                long long opacity_at, long long color_at,
                                int stages) {
  extern __shared__ __align__(1024) unsigned char tf32_smem[];
  const uint32_t base = (hopper::smem_addr(tf32_smem) + kAlignSlack - 1)
                        & ~static_cast<uint32_t>(kAlignSlack - 1);
  const Tf32Region reg = tf32_region_of(d);
  const uint32_t ring_base = base + reg.bytes();
  const uint32_t slot_bytes = t32::stage_bytes(C);
  const uint32_t full = ring_base + stages * slot_bytes;
  const uint32_t empty = full + 8 * kMaxStages;
  const uint32_t pos_ready = empty + 8 * kMaxStages;
  const uint32_t pos_free = pos_ready + 8;
  const uint32_t view_ready = pos_free + 8;
  const uint32_t view_free = view_ready + 8;
  const uint32_t x_full = view_free + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kTf32ConsumerWarps);
    }
    hopper::mbar_init(pos_ready, kEncoderThreads);
    hopper::mbar_init(pos_free, kTf32ConsumerWarps);
    hopper::mbar_init(view_ready, kEncoderThreads);
    hopper::mbar_init(view_free, kTf32ConsumerWarps);
    hopper::mbar_init(x_full, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const long long num_tiles = (num_points + kTf32Rows - 1) / kTf32Rows;
  const int L = d.num_layers;
  const int P = d.pos_width;
  const int V = d.view_width;
  const int lane = threadIdx.x & 31;
  const uint32_t dzt = base;
  const uint32_t x = base + reg.dzt_bytes();
  // x's rows through a generic pointer, for loads the compiler may schedule
  const float* const x_rows = reinterpret_cast<const float*>(
      tf32_smem + (x - hopper::smem_addr(tf32_smem)));
  // The dW of backward step `step` (0 the hidden layer, 1 the bottleneck,
  // 2 + k body layer L - 1 - k), worker `worker`'s chunks, between two
  // barriers of all kDwWorkers warps.
  auto dw_gate = [] {
    hopper::named_barrier(kDwBarrier, 32 * kDwWorkers);
  };
  auto dw_step = [&](int step, int worker) {
    if (step == 0) {
      const XCols segs[2] = {{0, C, 0}, {reg.view_col(), V, C}};
      dw_sync<C / 2>(segs, 2, x_rows, dzt, C, d_weights + d.w_off[L + 2],
                     worker, lane);
      return;
    }
    const int j = step == 1 ? L + 1 : L + 1 - step;
    XCols segs[2] = {{0, C, 0}, {reg.pos_col(), P, C}};
    int count = 1;
    if (step >= 2 && j == 0) {
      segs[0] = XCols{reg.pos_col(), P, 0};
    } else if (step >= 2 && ((d.skip_mask >> j) & 1u)) {
      count = 2;
    }
    dw_sync<C>(segs, count, x_rows, dzt, C, d_weights + d.w_off[j], worker,
               lane);
  };
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      // Producer: one thread streams each tile's slabs, the recompute's
      // (body, bottleneck, hidden layer) then the backward's dX operands
      // (hidden, bottleneck, body L-1 .. 1): the image up to its heads, in
      // order.
      int stage = 0;
      uint32_t phase = 0;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const char* src = reinterpret_cast<const char*>(image);
        for (int j = 0; j < L + 3; ++j) {
          if (j == L) continue;
          int K, N;
          layer_shape(d, j, &K, &N);
          src = t32::stream_slabs(src, K, N, ring_base, slot_bytes, full,
                                  empty, stages, &stage, &phase);
        }
        for (int j = L + 2; j >= 1; --j) {
          if (j == L) continue;
          int K, N;
          layer_shape(d, j, &K, &N);
          src = t32::stream_slabs(src, N, C, ring_base, slot_bytes, full,
                                  empty, stages, &stage, &phase);
        }
      }
      for (int s = 0; s < stages; ++s) {
        hopper::mbar_wait(empty + 8 * stage, phase ^ 1u);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    } else if (threadIdx.x >= 128 + 32) {
      // Encoders: a tile's features go into x once the backward has read
      // the last tile's (view: after the hidden layer's dW; positional:
      // after layer 0's); then the three warps work on each layer's dW
      // beside the consumer's.
      const int warp = (threadIdx.x - 128) / 32 - 1;   // 0..2
      uint32_t parity = 0;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        hopper::mbar_wait(pos_free, parity ^ 1u);
        t32::encode_rows_f32(positions, tile * kTf32Rows, num_points,
                             pos_enc, d.e_pos, d.include_inputs, d.pos_width,
                             x, reg.pos_col(), warp, kEncoderWarps, lane);
        hopper::mbar_arrive(pos_ready);
        hopper::mbar_wait(view_free, parity ^ 1u);
        t32::encode_rows_f32(views, tile * kTf32Rows, num_points, view_enc,
                             d.e_view, d.include_inputs, d.view_width, x,
                             reg.view_col(), warp, kEncoderWarps, lane);
        hopper::mbar_arrive(view_ready);
        for (int step = 0; step < L + 2; ++step) {
          dw_gate();
          dw_step(step, kTf32ConsumerWarps + warp);
          dw_gate();
        }
        parity ^= 1u;
      }
    }
    return;
  }

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const bool releases = lane == 0;
  const bool copies = t == 0;          // issues the warpgroup's bulk copies
  const int r0 = 16 * warp + (lane >> 2);
  const int pair = 2 * (lane & 3);
  Ring ring{ring_base, slot_bytes, full, empty, stages, 0, 0u};
  const uint32_t h_bytes = C * 256u;   // x's h: 64 rows of C
  char* const slots = scratch + static_cast<long long>(blockIdx.x) * L
                                    * h_bytes;
  const FeatureMajorA dz_a{dzt, C, r0, lane & 3};
  const float4* g4 = reinterpret_cast<const float4*>(g);
  auto g_row = [&](long long p) {
    return p < num_points ? __ldg(g4 + p) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto wg_sync = [] { hopper::named_barrier(kWgBarrier, 128); };
  auto park = [&](int i) {
    if (copies) {
      hopper::bulk_store(slots + static_cast<long long>(i) * h_bytes, x,
                         h_bytes);
      hopper::bulk_commit();
    }
  };
  auto parked = [&] {
    if (copies) hopper::bulk_wait_read();
    wg_sync();
  };
  uint32_t x_phase = 0;
  auto reload = [&](int i) {
    if (copies) {
      hopper::mbar_arrive_expect_tx(x_full, h_bytes);
      hopper::bulk_load(x, slots + static_cast<long long>(i) * h_bytes,
                        h_bytes, x_full);
    }
  };
  auto reloaded = [&] {
    hopper::mbar_wait(x_full, x_phase);
    x_phase ^= 1u;
  };
  float acc[C / 2];
  uint32_t mask[(C + 63) / 64];
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long tile0 = tile * kTf32Rows;
    // ---- the recompute: K1's products and epilogues, h_i parked ----
    hopper::mbar_wait(pos_ready, parity);
    for (int i = 0; i < L; ++i) {
      const bool skip = i > 0 && ((d.skip_mask >> i) & 1u);
      const int K = i == 0 ? P : C + (skip ? P : 0);
      t32::layer_tf32<C>(acc, ring, K,
                         t32::point_major_a(x, warp, lane, i == 0 ? 0 : K,
                                            i == 0 ? reg.pos_col() : 0),
                         releases);
      if (i > 0) parked();
      t32::store_f32<C, true>(acc, biases + d.b_off[i], x, r0, pair);
      hopper::fence_async_shared();
      wg_sync();
      park(i);
    }
    // the bottleneck, in place over h_{L-1}
    t32::layer_tf32<C>(acc, ring, C, t32::point_major_a(x, warp, lane, C, 0),
                       releases);
    parked();
    t32::store_f32<C, false>(acc, biases + d.b_off[L + 1], x, r0, pair);
    __syncwarp();
    // the hidden layer over [bottleneck | view features], kept in registers
    // and written point-major where dz^T goes
    hopper::mbar_wait(view_ready, parity);
    t32::layer_tf32<C / 2>(acc, ring, C + V,
                           t32::point_major_a(x, warp, lane, C,
                                              reg.view_col() - C),
                           releases);
    {
      const float* bias = biases + d.b_off[L + 2];
#pragma unroll
      for (int j = 0; j < C / 16; ++j) {
        const float2 b =
            __ldg(reinterpret_cast<const float2*>(bias + 8 * j + pair));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* v = acc + 4 * j + 2 * h;
          v[0] = fmaxf(v[0] + b.x, 0.0f);
          v[1] = fmaxf(v[1] + b.y, 0.0f);
          t32::st_f32x2(t32::f32_addr(dzt, r0 + 8 * h, 8 * j + pair), v[0],
                        v[1]);
        }
      }
    }
    if (copies) hopper::bulk_wait();   // the parks are written: reloadable
    wg_sync();

    // ---- the heads, f32 on the CUDA cores, over the tile's 64 points ----
    if (t < C / 2) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      for (int p = 0; p < kTf32Rows; ++p) {
        const float h = t32::ld_f32(t32::f32_addr(dzt, p, t));
        const float4 gv = g_row(tile0 + p);
        s0 = fmaf(h, gv.x, s0);
        s1 = fmaf(h, gv.y, s1);
        s2 = fmaf(h, gv.z, s2);
      }
      float* dw = d_weights + d.w_off[L + 3] + t * kHeadWidth;
      atomicAdd(dw, s0);
      atomicAdd(dw + 1, s1);
      atomicAdd(dw + 2, s2);
    }
    if (t < 4) {
      float s = 0.0f;
      for (int p = 0; p < kTf32Rows; ++p) {
        const float4 gv = g_row(tile0 + p);
        s += t == 0 ? gv.x : t == 1 ? gv.y : t == 2 ? gv.z : gv.w;
      }
      atomicAdd(t < 3 ? d_biases + d.b_off[L + 3] + t : d_biases + d.b_off[L],
                s);
    }
    wg_sync();
    // dz of the hidden layer, over it: (g_color color_w^T) where h > 0
    {
      const float4 g0 = g_row(tile0 + r0);
      const float4 g8 = g_row(tile0 + r0 + 8);
      const float* color_w = image + color_at;
#pragma unroll
      for (int j = 0; j < C / 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 gv = h ? g8 : g0;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = 8 * j + pair + c;
            const float* w = color_w + n * kHeadWidth;
            const float dh = fmaf(gv.z, __ldg(w + 2),
                                  fmaf(gv.y, __ldg(w + 1), gv.x * __ldg(w)));
            t32::st_f32(t32::f32_addr(dzt, n, r0 + 8 * h, C),
                        acc[4 * j + 2 * h + c] > 0.0f ? dh : 0.0f);
          }
        }
      }
    }

    // ---- the hidden layer: dW over [bottleneck | view]; dz <- d bottleneck
    {
      dw_gate();
      dw_step(0, warp);
      bias_grad_f32(dzt, C, C / 2, t, d_biases + d.b_off[L + 2]);
      dw_gate();
      if (releases) hopper::mbar_arrive(view_free);
      reload(L - 1);
      t32::layer_tf32<C>(acc, ring, C / 2, dz_a, releases);
      store_dzt<C, false, false>(acc, mask, dzt, r0, pair, 0.0f, 0.0f,
                                 nullptr);
      reloaded();
      wg_sync();
    }
    // ---- the bottleneck over h_{L-1}, and the opacity head's dW ----
    {
      for (int c = t; c < C; c += 128) {
        float s = 0.0f;
        for (int p = 0; p < kTf32Rows; ++p) {
          s = fmaf(t32::ld_f32(t32::f32_addr(x, p, c)), g_row(tile0 + p).w,
                   s);
        }
        atomicAdd(d_weights + d.w_off[L] + c * kHeadWidth, s);
      }
      dw_gate();
      dw_step(1, warp);
      bias_grad_f32(dzt, C, C, t, d_biases + d.b_off[L + 1]);
      relu_mask_f32<C>(mask, x, r0, pair);
      dw_gate();
      if (L >= 2) reload(L - 2);
      t32::layer_tf32<C>(acc, ring, C, dz_a, releases);
      store_dzt<C, true, true>(acc, mask, dzt, r0, pair,
                               g_row(tile0 + r0).w, g_row(tile0 + r0 + 8).w,
                               image + opacity_at);
      if (L >= 2) reloaded();
      wg_sync();
    }
    // ---- body layers, last to first: X = [h_{i-1} | pos] or pos ----
    for (int i = L - 1; i >= 0; --i) {
      dw_gate();
      dw_step(L + 1 - i, warp);
      bias_grad_f32(dzt, C, C, t, d_biases + d.b_off[i]);
      if (i > 0) relu_mask_f32<C>(mask, x, r0, pair);
      dw_gate();
      if (i == 0) {
        if (releases) hopper::mbar_arrive(pos_free);
        break;
      }
      if (i >= 2) reload(i - 2);
      t32::layer_tf32<C>(acc, ring, C, dz_a, releases);
      store_dzt<C, false, true>(acc, mask, dzt, r0, pair, 0.0f, 0.0f,
                                nullptr);
      if (i >= 2) reloaded();
      wg_sync();
    }
    parity ^= 1u;
  }
}

// The shared memory an f32 launch needs (0 if the model does not fit with
// two ring stages) and the stages it gets: the consumer's region and the
// ring.
size_t tf32_shared_bytes(const Desc& d, int* stages) {
  const size_t fixed = kAlignSlack + tf32_region_of(d).bytes()
                       + kTf32BarrierBytes;
  const size_t stage = t32::stage_bytes(d.channels);
  if (fixed + 2 * stage > kSharedLimit) return 0;
  const size_t fit = (kSharedLimit - fixed) / stage;
  *stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return fixed + *stages * stage;
}

// The scratch bytes one f32 block parks its tiles' activations in: L
// layers' h, 64 rows of C.
long long tf32_scratch_per_block(const Desc& d) {
  return static_cast<long long>(d.num_layers) * d.channels * 256;
}

template <int C>
cudaError_t launch_tf32(const void* positions, const void* views,
                        const void* pos_enc, const void* view_enc,
                        const void* image, const void* biases, const void* g,
                        void* d_weights, void* d_biases, void* scratch,
                        long long scratch_bytes, long long num_points,
                        const Desc& d, cudaStream_t stream) {
  static ffn::SharedLimit limit;
  int stages = 0;
  const size_t smem = tf32_shared_bytes(d, &stages);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err =
      ffn::reserve_shared(fused_nerf_backward_tf32_kernel<C>, smem, limit);
  if (err != cudaSuccess) return err;
  long long grid = 0;
  err = block_grid(num_points, kTf32Rows, &grid);
  if (err != cudaSuccess) return err;
  if (grid <= 0 || scratch_bytes < grid * tf32_scratch_per_block(d)) {
    return cudaErrorInvalidValue;
  }
  const long long opacity_at = t32::heads_at(d);
  fused_nerf_backward_tf32_kernel<C>
      <<<static_cast<unsigned>(grid), kTf32Threads, smem, stream>>>(
          static_cast<const float*>(positions),
          static_cast<const float*>(views),
          static_cast<const float*>(pos_enc),
          static_cast<const float*>(view_enc),
          static_cast<const float*>(image), static_cast<const float*>(biases),
          static_cast<const float*>(g), static_cast<float*>(d_weights),
          static_cast<float*>(d_biases), static_cast<char*>(scratch),
          num_points, d, opacity_at,
          opacity_at + d.channels * kHeadWidth, stages);
  return cudaGetLastError();
}

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// g: (N, 4) f32 cotangent. d_weights / d_biases: f32 buffers in the pack's
// layout: bf16 writes every element; f32 adds into them, so the caller
// zeroes them.
// weight_dtype: 0 = f32, `weights` the f32 slab image of kernels/
// fused_nerf.py::f32_slab_image; 1 = bf16, `weights` the slab image of
// kernels/fused_nerf.py::slab_image. `scratch`: scratch_bytes of device
// memory, at least what fused_nerf_backward_scratch_bytes gives for the
// type (else the launch fails with cudaErrorInvalidValue): in bf16 one
// slice's records (each layer's input and dz, the features), its row
// blocks' head sums and ReLU masks, and pass 2's partials; in f32 each
// block's parked activations. *dw_launches: set to the launches of pass 2's
// dW kernel that succeeded (one a slice in bf16, none in f32), also when a
// later launch fails.
extern "C" int fused_nerf_backward(const void* positions, const void* views,
                                   const void* pos_enc, const void* view_enc,
                                   const void* weights, const void* biases,
                                   const void* meta, const void* g,
                                   void* d_weights, void* d_biases,
                                   void* scratch, long long scratch_bytes,
                                   long long num_points, int weight_dtype,
                                   long long* dw_launches, void* stream) {
  Desc d;
  *dw_launches = 0;
  if (!ffn::parse_desc(static_cast<const long long*>(meta), &d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_points <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (weight_dtype == 1) {
    switch (d.channels) {
#define FFN_BF16_CASE(C)                                                     \
  case C:                                                                    \
    err = launch_bf16<C>(positions, views, pos_enc, view_enc, weights,       \
                         biases, g, d_weights, d_biases, scratch,            \
                         scratch_bytes, num_points, d, dw_launches, s);      \
    break;
      FFN_BF16_CASE(32)
      FFN_BF16_CASE(64)
      FFN_BF16_CASE(96)
      FFN_BF16_CASE(128)
      FFN_BF16_CASE(160)
      FFN_BF16_CASE(192)
      FFN_BF16_CASE(224)
      FFN_BF16_CASE(256)
#undef FFN_BF16_CASE
      default:
        err = cudaErrorInvalidValue;
    }
  } else if (weight_dtype == 0) {
    switch (d.channels) {
#define FFN_TF32_CASE(C)                                                     \
  case C:                                                                    \
    err = launch_tf32<C>(positions, views, pos_enc, view_enc, weights,       \
                         biases, g, d_weights, d_biases, scratch,            \
                         scratch_bytes, num_points, d, s);                   \
    break;
      FFN_TF32_CASE(32)
      FFN_TF32_CASE(64)
      FFN_TF32_CASE(96)
      FFN_TF32_CASE(128)
      FFN_TF32_CASE(160)
      FFN_TF32_CASE(192)
      FFN_TF32_CASE(224)
      FFN_TF32_CASE(256)
#undef FFN_TF32_CASE
      default:
        err = cudaErrorInvalidValue;
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// *bytes: the scratch a launch of num_points points needs on the current
// device: bf16 (weight_dtype 1), the records of min(num_points, 262,144)
// points (Records::row_blocks() 8 KB blocks a 64-point row block: 9,728
// bytes a point at the flagship), their row blocks' head sums and ReLU
// masks, and pass 2's partials (DwPlan::ranges rows of every weight and
// bias, f32); f32 (0),
// min(tiles of 64, SMs) blocks of L x 64 rows of C floats. The stream is
// unused (every entry point takes one).
extern "C" int fused_nerf_backward_scratch_bytes(const void* meta,
                                                 long long num_points,
                                                 int weight_dtype,
                                                 long long* bytes,
                                                 void* stream) {
  (void)stream;
  Desc d;
  *bytes = 0;
  if (!ffn::parse_desc(static_cast<const long long*>(meta), &d)
      || (weight_dtype != 0 && weight_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_points <= 0) return static_cast<int>(cudaSuccess);
  if (weight_dtype == 1) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err == cudaSuccess) *bytes = bf16_scratch(d, num_points, sms).bytes;
    return static_cast<int>(err);
  }
  long long grid = 0;
  const cudaError_t err = block_grid(num_points, kTf32Rows, &grid);
  if (err == cudaSuccess) *bytes = grid * tf32_scratch_per_block(d);
  return static_cast<int>(err);
}

extern "C" const char* fused_nerf_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
