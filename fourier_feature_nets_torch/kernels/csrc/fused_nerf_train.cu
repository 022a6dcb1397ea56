// Fused NeRF recompute-backward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels fourier_feature_nets_tpu/ops/
// fused_nerf_train.py::_bwd_kernel (row-major) and ops/fused_nerf_train_fm.py
// ::_bwd_kernel_fm (feature-major, the same function). Given positions,
// views, the packed weights and the (N, 4) f32 cotangent g of the logits
// [r, g, b, opacity], it recomputes the forward on chip (rounding where K1,
// fused_nerf.cu, rounds), then backpropagates and adds every tile's share of
// every packed weight and bias gradient into one f32 gradient buffer.
// Positions and views get no gradient.
//
// What bounds it on an H100. Three products a layer (the recompute, dX and
// dW), ~3.6 MFLOP a point at the 8x256 flagship: 0.47 ms of bf16 tensor-core
// time for a 131,072-point step, 2.83 ms in f32 as 3xTF32. The TPU kernel
// kept every weight and every gradient accumulator resident in VMEM across
// a sequential grid. Here
// blocks run in parallel, and neither the ~1.2 MB pack nor its 2.4 MB of f32
// gradients fits a block, so every tile pays for them: its slabs stream from
// L2 twice (recompute, dX) and its partial dW goes to the f32 buffer with
// atomics (reductions the L2 serves). Per point that traffic falls with the
// tile, so the bf16 tile is as large as K1's.
//
// bf16: fused_nerf_backward_bf16_kernel, persistent and warp-specialised on
// K1's tile (fused_nerf_wgmma.cuh): one block per SM walks 128-point tiles,
// two consumer warpgroups own 64 rows each, one producer warp streams slabs
// of the slab image through a ring of bulk-copy stages, three encode.
// * The recompute is K1's code (layer_product, store_layer, encode_rows), so
//   it sums every layer in K1's k16 order: the forward that K2 differentiates
//   is K1's, bit for bit. It skips the two heads' products (the backward needs
//   only g). After each body layer's epilogue, the warpgroup's swizzled h
//   blocks go out as they are, with one bulk copy from shared to global
//   memory, into a per-block scratch region that the wrapper allocates (L x
//   ceil(C / 64) x 8 KB a warpgroup); the backward brings each back with a
//   bulk load into the same layout while its dX products run.
// * dW = X^T dz: M is 64 of the layer's input columns, K the tile's 128
//   points (8 k16 steps, across both warpgroups' rows), N its outputs. Both
//   operands are read MN-major (wgmma's imm-trans = 1) from the rows as they
//   lie, so nothing is transposed. The M slices alternate between the two
//   warpgroups, so each sums all 128 points once, and each thread adds its
//   f32 fragment with float2 atomics. A skip layer's input [h | pos] and the
//   hidden layer's [bottleneck | view] are two segments, each sliced from
//   the start of its own 64-column block.
// * dX = dz W^T: per warpgroup, M its 64 points, K the layer's outputs, and
//   B = W^T is the slab as it lies, read MN-major: each slab of the first C
//   rows of W gives one 64-column chunk of dX. The epilogue works on the
//   fragment in registers: the opacity head's f32 term (bottleneck), the
//   ReLU mask of the input's h (read into bits before the next reload
//   overwrites it), the cast, stmatrix into dz in place.
// * Biases and heads on the CUDA cores, each summed over the tile's 128
//   points before its atomic.
// The two warpgroups meet at a barrier over both between dz's producers and
// dW's readers. The sum order of the atomics varies from run to run, so the
// gradients are not bitwise reproducible. Shared memory, per warpgroup: dz
// (C columns), the input's h (C), the positional and the view features (in
// 64-column blocks), and two or more ring stages of C x 128 bytes: the one
// budget is bf16_shared_bytes, and a model that does not fit makes the
// launch raise.
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
//   one warpgroup, and twice bf16's atomics and L2 slab reads a point.
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
// (37.5 KB a point); bf16 read 18 KB and reduced 18.6 KB a point.
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
// Both kernels mask the ragged last tile themselves (zero inputs and zero
// cotangent rows, so dead points add nothing) and launch on the caller's
// stream; the entry point returns cudaGetLastError(). Their one allocation,
// the scratch their tiles park their activations in, is the wrapper's
// (torch.empty, of the size fused_nerf_backward_scratch_bytes gives);
// neither kernel allocates.

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
// positional and its view features, and the arrival of its reloaded h
constexpr int kBarrierBytes = (2 * kMaxStages + 10) * 8;
constexpr uint32_t kPairBarrier = 3;   // both consumer warpgroups

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
// [dz (H) | x: the input's h (H) | positional features (Pb) | view features
// (Vb)], H = ceil(C / 64). The recompute writes h in x, the hidden layer in
// dz; from x, the features start at columns 64 H and 64 (H + Pb).
struct Region {
  int H, Pb, Vb;
  __host__ __device__ uint32_t bytes() const {
    return (2 * H + Pb + Vb) * kBlockBytes;
  }
  __host__ __device__ uint32_t x() const { return H * kBlockBytes; }
  __host__ __device__ uint32_t pos() const { return 2 * H * kBlockBytes; }
  __host__ __device__ uint32_t view() const {
    return (2 * H + Pb) * kBlockBytes;
  }
};

__host__ __device__ inline Region region_of(const Desc& d) {
  return Region{(d.channels + 63) / 64, (d.pos_width + 63) / 64,
                (d.view_width + 63) / 64};
}

// Rows [out_row, out_row + rows) of a layer's dW, whose inputs are the
// columns from the block at byte `at` of each warpgroup's region.
struct XSeg {
  uint32_t at;
  int rows;
  int out_row;
};

__device__ __forceinline__ float ld_bf16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint32_t ld_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
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

// dW[out_row + m][n] += sum over the tile's 128 points of X[p][m] dz[p][n],
// for each segment of X. The 64-row M slices alternate between the
// warpgroups; a slice reads A = X^T and B = dz MN-major from both
// warpgroups' rows (dz at the start of each region), and its thread adds
// its f32 fragment with float2 atomics.
template <int N>
__device__ __forceinline__ void dw_product(float* acc, const XSeg* segs,
                                           int count, uint32_t base,
                                           uint32_t region_bytes, int wg,
                                           int r0, int pair,
                                           float* __restrict__ grad) {
  int slice = 0;
  for (int s = 0; s < count; ++s) {
    for (int m0 = 0; m0 < segs[s].rows; m0 += 64, ++slice) {
      if ((slice & 1) != wg) continue;
      hopper::fence_registers<N / 2>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int p0 = 0; p0 < kTileRows; p0 += 16) {
        const uint32_t rows = base + (p0 / kWgRows) * region_bytes
                              + (p0 % kWgRows) * 128;
        hopper::mma<N, 1, 1>(
            acc,
            hopper::desc_sw128_mn(rows + segs[s].at + (m0 / 64) * kBlockBytes),
            hopper::desc_sw128_mn(rows), p0 > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_registers<N / 2>(acc);
      float* out = grad + static_cast<long long>(segs[s].out_row + m0) * N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + 8 * h;
        if (m0 + m < segs[s].rows) {
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            atomicAdd(reinterpret_cast<float2*>(out + m * N + 8 * j + pair),
                      make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
          }
        }
      }
    }
  }
}

// db[n] += sum over the tile's 128 points of dz[p][n], n < N: one consumer
// thread a column.
__device__ __forceinline__ void bias_grad_tile(uint32_t base,
                                               uint32_t region_bytes, int N,
                                               int ct,
                                               float* __restrict__ grad) {
  if (ct < N) {
    float s = 0.0f;
    for (int p = 0; p < kTileRows; ++p) {
      s += ld_bf16(act_addr(base + (p / kWgRows) * region_bytes, p % kWgRows,
                            ct));
    }
    atomicAdd(grad + ct, s);
  }
}

// The ReLU mask of this thread's dX fragment: bit 4j + 2h + c of word s
// says x[r0 + 8h][64 s + 8j + pair + c] > 0.
template <int C>
__device__ __forceinline__ void relu_mask(uint32_t* mask, uint32_t x, int r0,
                                          int pair) {
#pragma unroll
  for (int s = 0; s < (C + 63) / 64; ++s) {
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (64 * s + 8 * j < C) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // two bf16: positive when the sign is clear and the rest is not 0
          const uint32_t v = ld_b32(act_addr(x, r0 + 8 * h,
                                             64 * s + 8 * j + pair));
          const uint32_t lo = (v & 0x8000u) == 0 && (v & 0x7FFFu) != 0;
          const uint32_t hi = (v & 0x80000000u) == 0 && (v & 0x7FFF0000u) != 0;
          bits |= (lo | (hi << 1)) << (4 * j + 2 * h);
        }
      }
    }
    mask[s] = bits;
  }
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
// added (kOpacity; g0 and g8 are g_op of rows r0 and r0 + 8) and the ReLU
// mask applied (kMask), stored into the swizzled rows in place.
template <int C, bool kOpacity, bool kMask>
__device__ __forceinline__ void store_dz(const float* acc,
                                         const uint32_t* mask, uint32_t dz,
                                         const Fragment& f, int pair,
                                         float g0, float g8, const char* image,
                                         long long opacity_at) {
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
              x += (h ? g8 : g0) * slab_weight(image, opacity_at, kHeadWidth,
                                               64 * s + 8 * jj + pair + c, 0);
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
                                float* __restrict__ d_weights,
                                float* __restrict__ d_biases,
                                char* __restrict__ scratch,
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
  // [warpgroup]: features written, features read (for the next tile), h
  // reloaded
  const uint32_t pos_ready = empty + 8 * kMaxStages;
  const uint32_t pos_free = pos_ready + 16;
  const uint32_t view_ready = pos_free + 16;
  const uint32_t view_free = view_ready + 16;
  const uint32_t x_full = view_free + 16;
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
      hopper::mbar_init(x_full + 8 * w, 1);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const long long num_tiles = (num_points + kTileRows - 1) / kTileRows;
  const int L = d.num_layers;
  const char* const image = reinterpret_cast<const char*>(slabs);
  const int wg = threadIdx.x / 128;
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
  const uint32_t dz = base + wg * region_bytes;
  const uint32_t x = dz + reg.x();
  const uint32_t barrier_id = 1 + wg;
  const bool releases = lane == 0;
  const bool copies = t == 0;          // issues the warpgroup's bulk copies
  const int r0 = 16 * warp + (lane >> 2);
  const int pair = 2 * (lane & 3);
  const Fragment f = fragment_of(warp, lane);
  Ring ring{ring_base, stage_bytes, full, empty, stages, 0, 0u};
  const int P = d.pos_width;
  const int V = d.view_width;
  const int pos_col = H * 64;              // from x
  const int view_col = (H + reg.Pb) * 64;
  const uint32_t h_bytes = H * kBlockBytes;
  char* const slots = scratch + static_cast<long long>(blockIdx.x * 2 + wg)
                                    * L * h_bytes;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  auto g_row = [&](long long p) {
    return p < num_points ? __ldg(g4 + p) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto both_ready = [] { hopper::named_barrier(kPairBarrier, 256); };
  // x's h leaves for slot i of the scratch
  auto park = [&](int i) {
    if (copies) {
      hopper::bulk_store(slots + static_cast<long long>(i) * h_bytes, x,
                         h_bytes);
      hopper::bulk_commit();
    }
  };
  // before x is written again: the last park has read it
  auto parked = [&] {
    if (copies) hopper::bulk_wait_read();
    hopper::named_barrier(barrier_id, 128);
  };
  uint32_t x_phase = 0;
  auto reload = [&](int i) {
    if (copies) {
      hopper::mbar_arrive_expect_tx(x_full + 8 * wg, h_bytes);
      hopper::bulk_load(x, slots + static_cast<long long>(i) * h_bytes,
                        h_bytes, x_full + 8 * wg);
    }
  };
  auto reloaded = [&] {
    hopper::mbar_wait(x_full + 8 * wg, x_phase);
    x_phase ^= 1u;
  };
  float acc[32 * H];
  uint32_t mask[H];
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long tile0 = tile * kTileRows;
    const long long row0 = tile0 + wg * kWgRows;
    // ---- the recompute: K1's products and epilogues, h_i parked ----
    hopper::mbar_wait(pos_ready + 8 * wg, parity);
    for (int i = 0; i < L; ++i) {
      const bool skip = i > 0 && ((d.skip_mask >> i) & 1u);
      const int K = i == 0 ? P : C + (skip ? P : 0);
      layer_product<C>(acc, ring, x, K, i == 0 ? 0 : C,
                       i == 0 ? pos_col : pos_col - C, releases);
      if (i > 0) parked();
      store_layer<C, true>(acc, biases + d.b_off[i], x, f, pair);
      rows_ready(barrier_id);
      park(i);
    }
    // the bottleneck, in place over h_{L-1}
    layer_product<C>(acc, ring, x, C, C, 0, releases);
    parked();
    store_layer<C, false>(acc, biases + d.b_off[L + 1], x, f, pair);
    rows_ready(barrier_id);
    // the hidden layer over [bottleneck | view features], into dz
    hopper::mbar_wait(view_ready + 8 * wg, parity);
    layer_product<C / 2>(acc, ring, x, C + V, C, view_col - C, releases);
    store_layer<C / 2, true>(acc, biases + d.b_off[L + 2], dz, f, pair);
    if (copies) hopper::bulk_wait();   // the parks are written: reloadable
    both_ready();

    // ---- the heads, f32 on the CUDA cores, over the tile's 128 points ----
    if (ct < C / 2) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      for (int p = 0; p < kTileRows; ++p) {
        const float h = ld_bf16(act_addr(base + (p / kWgRows) * region_bytes,
                                         p % kWgRows, ct));
        const float4 gv = g_row(tile0 + p);
        s0 = fmaf(h, gv.x, s0);
        s1 = fmaf(h, gv.y, s1);
        s2 = fmaf(h, gv.z, s2);
      }
      float* dw = d_weights + d.w_off[L + 3] + ct * kHeadWidth;
      atomicAdd(dw, s0);
      atomicAdd(dw + 1, s1);
      atomicAdd(dw + 2, s2);
    } else if (ct >= 252) {
      const int k = ct - 252;
      float s = 0.0f;
      for (int p = 0; p < kTileRows; ++p) {
        const float4 gv = g_row(tile0 + p);
        s += k == 0 ? gv.x : k == 1 ? gv.y : k == 2 ? gv.z : gv.w;
      }
      atomicAdd(k < 3 ? d_biases + d.b_off[L + 3] + k : d_biases + d.b_off[L],
                s);
    }
    both_ready();
    // dz of the hidden layer, in place over it: (g_color color_w^T) masked
    for (int idx = t; idx < kWgRows * (C / 2); idx += 128) {
      const int row = idx / (C / 2);
      const int c = idx - row * (C / 2);
      const uint32_t at = act_addr(dz, row, c);
      const float4 gv = g_row(row0 + row);
      const long long color = offsets.at[L + 3];
      const float dh = fmaf(
          gv.z, slab_weight(image, color, kHeadWidth, c, 2),
          fmaf(gv.y, slab_weight(image, color, kHeadWidth, c, 1),
               gv.x * slab_weight(image, color, kHeadWidth, c, 0)));
      st_bf16(at, ld_bf16(at) > 0.0f ? dh : 0.0f);
    }
    hopper::fence_async_shared();
    both_ready();

    // ---- the hidden layer: dW over [bottleneck | view]; dz <- d bottleneck
    {
      const XSeg segs[2] = {{reg.x(), C, 0}, {reg.view(), V, C}};
      dw_product<C / 2>(acc, segs, 2, base, region_bytes, wg, r0, pair,
                        d_weights + d.w_off[L + 2]);
      bias_grad_tile(base, region_bytes, C / 2, ct,
                     d_biases + d.b_off[L + 2]);
      both_ready();
      if (releases) hopper::mbar_arrive(view_free + 8 * wg);
      reload(L - 1);
      dx_product<C / 2, H>(acc, ring, dz, releases);
      store_dz<C, false, false>(acc, mask, dz, f, pair, 0.0f, 0.0f, image, 0);
      hopper::fence_async_shared();
      reloaded();
      both_ready();
    }
    // ---- the bottleneck over h_{L-1}, and the opacity head's dW ----
    {
      if (ct < C) {
        float s = 0.0f;
        for (int p = 0; p < kTileRows; ++p) {
          s = fmaf(ld_bf16(act_addr(base + (p / kWgRows) * region_bytes
                                        + reg.x(), p % kWgRows, ct)),
                   g_row(tile0 + p).w, s);
        }
        atomicAdd(d_weights + d.w_off[L] + ct * kHeadWidth, s);
      }
      const XSeg segs[1] = {{reg.x(), C, 0}};
      dw_product<C>(acc, segs, 1, base, region_bytes, wg, r0, pair,
                    d_weights + d.w_off[L + 1]);
      bias_grad_tile(base, region_bytes, C, ct, d_biases + d.b_off[L + 1]);
      relu_mask<C>(mask, x, r0, pair);
      both_ready();
      if (L >= 2) reload(L - 2);
      dx_product<C, H>(acc, ring, dz, releases);
      store_dz<C, true, true>(acc, mask, dz, f, pair, g_row(row0 + r0).w,
                              g_row(row0 + r0 + 8).w, image, offsets.at[L]);
      hopper::fence_async_shared();
      if (L >= 2) reloaded();
      both_ready();
    }
    // ---- body layers, last to first: X = [h_{i-1} | pos] or pos ----
    for (int i = L - 1; i >= 0; --i) {
      const bool skip = i > 0 && ((d.skip_mask >> i) & 1u);
      XSeg segs[2] = {{reg.x(), C, 0}, {reg.pos(), P, C}};
      if (i == 0) segs[0] = XSeg{reg.pos(), P, 0};
      dw_product<C>(acc, segs, skip ? 2 : 1, base, region_bytes, wg, r0,
                    pair, d_weights + d.w_off[i]);
      bias_grad_tile(base, region_bytes, C, ct, d_biases + d.b_off[i]);
      if (i > 0) relu_mask<C>(mask, x, r0, pair);
      both_ready();
      if (i == 0) {
        if (releases) hopper::mbar_arrive(pos_free + 8 * wg);
        break;
      }
      if (i >= 2) reload(i - 2);
      dx_product<C, H>(acc, ring, dz, releases);
      store_dz<C, false, true>(acc, mask, dz, f, pair, 0.0f, 0.0f, image, 0);
      hopper::fence_async_shared();
      if (i >= 2) reloaded();
      both_ready();
    }
    parity ^= 1u;
  }
}

// The shared memory a bf16 launch needs (0 if the model does not fit with
// two ring stages) and the stages it gets: two warpgroups' regions and the
// ring.
size_t bf16_shared_bytes(const Desc& d, int* stages) {
  const size_t fixed = kAlignSlack + 2ull * region_of(d).bytes()
                       + kBarrierBytes;
  const size_t stage = static_cast<size_t>(d.channels) * 128;
  if (fixed + 2 * stage > kSharedLimit) return 0;
  const size_t fit = (kSharedLimit - fixed) / stage;
  *stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return fixed + *stages * stage;
}

// The scratch bytes one block parks its tiles' activations in.
long long bf16_scratch_per_block(const Desc& d) {
  return 2ll * d.num_layers * region_of(d).H * kBlockBytes;
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

template <int C>
cudaError_t launch_bf16(const void* positions, const void* views,
                        const void* pos_enc, const void* view_enc,
                        const void* slabs, const void* biases, const void* g,
                        void* d_weights, void* d_biases, void* scratch,
                        long long scratch_bytes, long long num_points,
                        const Desc& d, cudaStream_t stream) {
  static ffn::SharedLimit limit;
  int stages = 0;
  const size_t smem = bf16_shared_bytes(d, &stages);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err =
      ffn::reserve_shared(fused_nerf_backward_bf16_kernel<C>, smem, limit);
  if (err != cudaSuccess) return err;
  long long grid = 0;
  err = block_grid(num_points, kTileRows, &grid);
  if (err != cudaSuccess) return err;
  if (grid <= 0 || scratch_bytes < grid * bf16_scratch_per_block(d)) {
    return cudaErrorInvalidValue;
  }
  fused_nerf_backward_bf16_kernel<C>
      <<<static_cast<unsigned>(grid), kBf16Threads, smem, stream>>>(
          static_cast<const float*>(positions),
          static_cast<const float*>(views),
          static_cast<const float*>(pos_enc),
          static_cast<const float*>(view_enc),
          static_cast<const Bf16*>(slabs), static_cast<const float*>(biases),
          static_cast<const float*>(g), static_cast<float*>(d_weights),
          static_cast<float*>(d_biases), static_cast<char*>(scratch),
          num_points, d, slab_offsets(d), stages);
  return cudaGetLastError();
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
// layout, zeroed by the caller; the kernel adds into them.
// weight_dtype: 0 = f32, `weights` the f32 slab image of kernels/
// fused_nerf.py::f32_slab_image; 1 = bf16, `weights` the slab image of
// kernels/fused_nerf.py::slab_image. `scratch`: scratch_bytes of device
// memory for the activations the tiles park, at least what
// fused_nerf_backward_scratch_bytes gives for the type (else the launch
// fails with cudaErrorInvalidValue).
extern "C" int fused_nerf_backward(const void* positions, const void* views,
                                   const void* pos_enc, const void* view_enc,
                                   const void* weights, const void* biases,
                                   const void* meta, const void* g,
                                   void* d_weights, void* d_biases,
                                   void* scratch, long long scratch_bytes,
                                   long long num_points, int weight_dtype,
                                   void* stream) {
  Desc d;
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
                         scratch_bytes, num_points, d, s);                   \
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
// device: bf16 (weight_dtype 1), min(tiles of 128, SMs) blocks of 2 L
// ceil(C / 64) x 8 KB; f32 (0), min(tiles of 64, SMs) blocks of L x 64
// rows of C floats. The stream is unused (every entry point takes one).
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
  long long grid = 0;
  const cudaError_t err =
      block_grid(num_points, weight_dtype == 1 ? kTileRows : kTf32Rows, &grid);
  if (err == cudaSuccess) {
    *bytes = grid * (weight_dtype == 1 ? bf16_scratch_per_block(d)
                                       : tf32_scratch_per_block(d));
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_nerf_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
