// The wgmma tile shared by K1's bf16 forward (fused_nerf.cu) and K2's bf16
// recompute-backward (fused_nerf_train.cu): one block per SM walks tiles of
// 128 points; two consumer warpgroups own 64 rows each; in the producer
// warpgroup one warp streams weight slabs through a ring of shared-memory
// stages and three warps encode. K2's recompute runs these same routines over
// the same slab image, so it sums every layer in K1's k16 order and rounds
// where K1 rounds: the two forwards agree bit for bit.
//
// Weights arrive as slabs: 64 K-rows of one layer's (K, N) weight, stored
// N-major (W^T) in the 128-byte swizzled K-major layout of hopper.cuh, so a
// slab is one contiguous run of N * 128 bytes (kernels/fused_nerf.py::
// slab_image). Activations live in shared memory in the same layout: per
// warpgroup, 64 rows in 64-column blocks of 8 KB.

#pragma once

#include "fused_nerf_common.cuh"
#include "hopper.cuh"

namespace ffn {
namespace wgmma {

constexpr int kWgRows = 64;                  // rows a consumer warpgroup owns
constexpr int kTileRows = 2 * kWgRows;       // points a tile
constexpr int kSlabK = 64;                   // K rows a weight slab
constexpr uint32_t kBlockBytes = kWgRows * 128;   // 64 columns of 64 rows
static_assert(kBlockBytes == hopper::kMnAtomStride,
              "MN-major operands step one activation block per 64 columns");
constexpr int kBf16Threads = 384;            // 2 consumer warpgroups, 1 producer
constexpr int kConsumerWarps = 8;            // arrivals that free a stage
constexpr int kEncoderWarps = 3;             // the producer warpgroup's warps 1-3
constexpr int kEncoderThreads = 32 * kEncoderWarps;
constexpr int kMaxStages = 8;
// setmaxnreg's split of the 64K registers: 2 x 128 x 208 + 128 x 88. With
// 40 for the producer warpgroup the encoders spilled (152 bytes) and K1
// ran slower; 208 hold a consumer's 128 accumulators with no spill.
constexpr uint32_t kConsumerRegs = 208;
constexpr uint32_t kProducerRegs = 88;
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "registers of one block");
constexpr int kSharedLimit = 232448;         // 227 KB a block
constexpr int kAlignSlack = 1024;            // swizzled blocks start 1024-aligned

// (K, N) of packed layer j: body 0..L-1, opacity head, bottleneck, hidden,
// color head.
__host__ __device__ __forceinline__ void layer_shape(const Desc& d, int j,
                                                     int* K, int* N) {
  const int C = d.channels;
  const int L = d.num_layers;
  if (j < L) {
    *N = C;
    *K = j == 0 ? d.pos_width
                : C + (((d.skip_mask >> j) & 1u) ? d.pos_width : 0);
  } else if (j == L) {
    *K = C;
    *N = kHeadWidth;
  } else if (j == L + 1) {
    *K = C;
    *N = C;
  } else if (j == L + 2) {
    *K = C + d.view_width;
    *N = C / 2;
  } else {
    *K = C / 2;
    *N = kHeadWidth;
  }
}

// The shared-memory byte address of (row, col) of a warpgroup's activations.
__device__ __forceinline__ uint32_t act_addr(uint32_t base, int row, int col) {
  return base + (col >> 6) * kBlockBytes + row * 128
         + ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void st_bf16(uint32_t addr, float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  asm volatile("st.shared.b16 [%0], %1;\n"
               :: "r"(addr), "h"(*reinterpret_cast<const uint16_t*>(&h)));
}

// The consumer side of the weight ring. Every consumer thread walks the same
// slab sequence; stage and phase run on across layers and tiles.
struct Ring {
  uint32_t base;          // stage 0
  uint32_t stage_bytes;
  uint32_t full;          // full barriers, 8 bytes each
  uint32_t empty;         // empty barriers
  int stages;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// acc = A[:, col(k)] W for the layer's K rows, k streamed slab by slab;
// col(k) = k below `split`, k + `shift` from it. Returns with the products
// complete and every slab released.
template <int N>
__device__ __forceinline__ void layer_product(float* acc, Ring& ring,
                                              uint32_t act, int K, int split,
                                              int shift, bool releases) {
  hopper::fence_registers<N / 2>(acc);
  hopper::wgmma_fence();
  int held = -1;
  for (int k0 = 0; k0 < K; k0 += kSlabK) {
    hopper::mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    const uint32_t slab = ring.base + ring.stage * ring.stage_bytes;
    const int k_end = min(k0 + kSlabK, K);
    for (int k = k0; k < k_end; k += 16) {
      const int col = k < split ? k : k + shift;
      hopper::mma<N>(acc,
                     hopper::desc_sw128(act + (col >> 6) * kBlockBytes
                                        + (col & 63) * 2),
                     hopper::desc_sw128(slab + (k & 63) * 2), k > 0);
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
  hopper::fence_registers<N / 2>(acc);
  if (releases) hopper::mbar_arrive(ring.empty + 8 * held);
}

// Where this thread's accumulator fragment lands in its warpgroup's rows:
// rows r0 = 16 warp + lane / 4 and r0 + 8, column pair 2 (lane % 4) of each
// 8-column group j. stmatrix stores four 8x8 tiles from such fragments:
// rows 0-7 and 8-15 of the warp's 16, for groups j and j + 1, each tile row
// (16 bytes) at the address one lane gives: lane l the row 8 ((l / 8) % 2) +
// l % 8 of group j + l / 16.
struct Fragment {
  uint32_t row_bytes;   // the row this lane addresses, times 128
  uint32_t key;         // its swizzle, row % 8
  uint32_t group;       // 0 or 1: group j or j + 1
};

__device__ __forceinline__ Fragment fragment_of(int warp, int lane) {
  return Fragment{
      static_cast<uint32_t>((16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7))
                            * 128),
      static_cast<uint32_t>(lane & 7), static_cast<uint32_t>(lane >> 4)};
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi,
                                                bool relu) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  if (relu) v = __hmax2(v, __float2bfloat162_rn(0.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8x8 bf16 tiles of a fragment into the swizzled rows, for 8-column
// groups j (even) and j + 1 of the block at `block`.
__device__ __forceinline__ void store_groups(uint32_t block, const Fragment& f,
                                             int j, uint32_t r0_j,
                                             uint32_t r8_j, uint32_t r0_j1,
                                             uint32_t r8_j1) {
  const uint32_t addr = block + f.row_bytes + (((j + f.group) ^ f.key) << 4);
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(addr), "r"(r0_j), "r"(r8_j), "r"(r0_j1), "r"(r8_j1));
}

// h[:, 0:N] = bf16(acc + bias), then ReLU'd if kRelu, into the swizzled rows.
template <int N, bool kRelu>
__device__ __forceinline__ void store_layer(const float* acc,
                                            const float* __restrict__ bias,
                                            uint32_t act, const Fragment& f,
                                            int pair) {
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    const float2 b =
        __ldg(reinterpret_cast<const float2*>(bias + 8 * j + pair));
    const float2 c =
        __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 8 + pair));
    store_groups(
        act + (j / 8) * kBlockBytes, f, j % 8,
        pack_bf16x2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y, kRelu),
        pack_bf16x2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y, kRelu),
        pack_bf16x2(acc[4 * j + 4] + c.x, acc[4 * j + 5] + c.y, kRelu),
        pack_bf16x2(acc[4 * j + 6] + c.x, acc[4 * j + 7] + c.y, kRelu));
  }
}

// Publishes a warpgroup's shared-memory stores to its next wgmma.
__device__ __forceinline__ void rows_ready(uint32_t barrier_id) {
  hopper::fence_async_shared();
  hopper::named_barrier(barrier_id, 128);
}

// [cos(xB) | sin(xB) | x (optional) | zeros] of `width` columns at col0 for
// 64 rows from row0 (rows past num_points encode 0), by `warps` warps: warp
// w takes rows w, w + warps, ...; lane e takes phase e (then e + 32, ...),
// with its column of B in registers.
__device__ __forceinline__ void encode_rows(const float* __restrict__ x,
                                            long long row0,
                                            long long num_points,
                                            const float* __restrict__ enc,
                                            int E, int include_inputs,
                                            int width, uint32_t act, int col0,
                                            int warp, int warps, int lane) {
  for (int e = lane; e < E; e += 32) {
    const float b0 = __ldg(enc + e);
    const float b1 = __ldg(enc + E + e);
    const float b2 = __ldg(enc + 2 * E + e);
#pragma unroll 4
    for (int row = warp; row < kWgRows; row += warps) {
      const long long g = row0 + row;
      float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
      if (g < num_points) {
        x0 = __ldg(x + 3 * g);
        x1 = __ldg(x + 3 * g + 1);
        x2 = __ldg(x + 3 * g + 2);
      }
      float s, c;
      fast_sincos(fmaf(x2, b2, fmaf(x1, b1, x0 * b0)), &s, &c);
      st_bf16(act_addr(act, row, col0 + e), c);
      st_bf16(act_addr(act, row, col0 + E + e), s);
    }
  }
  const int tail = width - 2 * E;   // raw inputs and zero padding, < 32
  if (lane < tail) {
    for (int row = warp; row < kWgRows; row += warps) {
      const long long g = row0 + row;
      const float v = (include_inputs && lane < 3 && g < num_points)
                          ? __ldg(x + 3 * g + lane) : 0.0f;
      st_bf16(act_addr(act, row, col0 + 2 * E + lane), v);
    }
  }
}

}  // namespace wgmma
}  // namespace ffn
