// The f32 tile shared by K1's f32 forward (fused_nerf.cu) and K2's f32
// recompute-backward (fused_nerf_train.cu): 3xTF32 wgmma products (hopper.cuh)
// over f32 activations kept in shared memory, the weights streamed from the
// f32 slab image through the ring of fused_nerf_wgmma.cuh. K2's recompute runs
// these same routines over the same image, so it sums every layer in K1's
// order: the two forwards agree bit for bit.
//
// Layouts. An f32 operand is stored as blocks of 128-byte rows (32 values)
// in the 128-byte swizzle of hopper.cuh: the 16-byte chunk q (4 values) of
// row r sits at chunk q ^ (r % 8), each block 1024-byte aligned.
// * Activations, point-major: per warpgroup 64 rows (points) in blocks of 32
//   columns (8 KB).
// * The f32 slab image (kernels/fused_nerf.py::f32_slab_image): a (K, N)
//   matrix streamed as slabs of 32 K-rows; a slab is stored N-major (one
//   128-byte row a column of N) as pieces(N) pieces of N / pieces(N) rows,
//   each piece its hi block then its lo block (tf32 values of W and of the
//   rest of W). One piece is one ring stage, one bulk copy.
//   The image holds, in this order: the forward's layers (body 0..L-1,
//   bottleneck, hidden: K the layer's inputs, N its outputs); K2's dX
//   operands, W^T of the first C rows of the hidden layer, the bottleneck and
//   body layers L-1 .. 1 (K the layer's outputs, N = C); then the opacity
//   and the color head as they lie in the flat pack ((in, 16), f32, exact),
//   which run on the CUDA cores.
//
// Products. A (the activations, or K2's dz) is read from shared memory into
// registers and split there; B (a slab piece) is read by the tensor cores as
// its hi and lo blocks. wgmma reads A from registers as long as the product
// runs, so a slab's A registers are loaded after the last slab's products
// have completed (wgmma.wait_group 0): a warpgroup's products pause at each
// slab boundary, and the other warpgroup's (K1) fill the tensor cores then.

#pragma once

#include "fused_nerf_wgmma.cuh"

namespace ffn {
namespace tf32 {

using wgmma::kWgRows;
using wgmma::Ring;

constexpr int kSlabK = 32;                    // K rows of an f32 slab
constexpr uint32_t kBlockBytes = kWgRows * 128;
constexpr int kMaxPiece = 128;                // N of one stage's products

// Pieces of a slab of N columns and the columns of one.
__host__ __device__ constexpr int pieces(int N) {
  return N > kMaxPiece ? 2 : 1;
}
__host__ __device__ constexpr int piece_width(int N) { return N / pieces(N); }

// Bytes of one stage of a matrix of N columns: a piece's hi and lo blocks.
__host__ __device__ constexpr uint32_t stage_bytes(int N) {
  return 2u * piece_width(N) * 128u;
}

// The byte address of (row, col) of a swizzled f32 operand whose 32-column
// blocks hold `rows` rows each.
__device__ __forceinline__ uint32_t f32_addr(uint32_t base, int row, int col,
                                             int rows = kWgRows) {
  return base + (col >> 5) * rows * 128 + row * 128
         + ((((col >> 2) & 7) ^ (row & 7)) << 4) + (col & 3) * 4;
}

__device__ __forceinline__ float ld_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_f32x2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(a), "f"(b) : "memory");
}

// Floats of a (K, N) matrix's slabs: ceil(K / 32) slabs of 2 N rows of 32.
__host__ __device__ inline long long slab_floats(int K, int N) {
  return static_cast<long long>((K + kSlabK - 1) / kSlabK) * 2 * N * kSlabK;
}

// Where the heads start in the f32 slab image, in floats: after the
// forward's slabs (body, bottleneck, hidden) and K2's dX slabs (W^T of the
// first C rows of the hidden layer, the bottleneck and body layers L-1 ..
// 1); the color head follows the opacity head's C x 16.
inline long long heads_at(const Desc& d) {
  long long at = 0;
  for (int j = 0; j < d.num_layers + 3; ++j) {
    if (j == d.num_layers) continue;      // the opacity head: CUDA cores
    int K, N;
    wgmma::layer_shape(d, j, &K, &N);
    at += slab_floats(K, N);
    if (j > 0) at += slab_floats(N, d.channels);   // W[0:C, :]^T
  }
  return at;
}

// A fragment loader for the activations, point-major: this lane's
// ldmatrix row (lanes 8m .. 8m + 7 address matrix m: rows 0-7, 8-15 of its
// warp's 16 at columns + 0, then the same at + 4), and the column map of a
// layer's input: col(k) = k below `split`, k + `shift` from it.
struct PointMajorA {
  uint32_t act;
  int row;
  int col4;
  int split;
  int shift;
  __device__ __forceinline__ void operator()(int k, uint32_t* x) const {
    const int col = (k < split ? k : k + shift) + col4;
    hopper::ldmatrix_x4(f32_addr(act, row, col), x);
  }
};

__device__ __forceinline__ PointMajorA point_major_a(uint32_t act, int warp,
                                                     int lane, int split,
                                                     int shift) {
  return PointMajorA{act, 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1),
                     4 * (lane >> 4), split, shift};
}

// acc (this warpgroup's 64 rows x N, f32) = A W over the layer's K rows of
// W, the slabs taken from the ring in order, each slab in pieces(N) stages;
// load_a(k, x) gives this thread's four A values of the k8 step at k.
// Per k8 step and piece three products: lo_A hi_W, hi_A lo_W, hi_A hi_W.
// Returns with the products complete and every stage released.
template <int N, typename LoadA>
__device__ __forceinline__ void layer_tf32(float* acc, Ring& ring, int K,
                                           const LoadA& load_a,
                                           bool releases) {
  constexpr int kPieces = pieces(N);
  constexpr int kPiece = N / kPieces;
  // The first product of each piece overwrites acc; zeroing it first ends
  // the life of its last values here, not at the first product.
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  int held = -1;
  // kept live up to each wait: the products read them until they complete
  uint32_t hi[4][4] = {}, lo[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kSlabK) {
    if (k0 > 0) {   // the last slab's products read hi and lo
      hopper::wgmma_wait<0>();
      hopper::fence_registers<N / 2>(acc);
      hopper::fence_registers<16>(&hi[0][0]);
      hopper::fence_registers<16>(&lo[0][0]);
      if (releases && held >= 0) hopper::mbar_arrive(ring.empty + 8 * held);
      held = -1;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (k0 + 8 * s < K) {   // K is a multiple of 16
        uint32_t x[4];
        load_a(k0 + 8 * s, x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hopper::tf32_split(__uint_as_float(x[i]), &hi[s][i], &lo[s][i]);
        }
      }
    }
    hopper::fence_registers<N / 2>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      hopper::mbar_wait(ring.full + 8 * ring.stage, ring.phase);
      const uint32_t stage = ring.base + ring.stage * ring.stage_bytes;
      float* d = acc + q * (kPiece / 2);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (k0 + 8 * s < K) {
          const uint64_t w_hi = hopper::desc_sw128(stage + 32 * s);
          const uint64_t w_lo =
              hopper::desc_sw128(stage + kPiece * 128 + 32 * s);
          hopper::mma_tf32<kPiece>(d, lo[s], w_hi, k0 + s > 0);
          hopper::mma_tf32<kPiece>(d, hi[s], w_lo, 1);
          hopper::mma_tf32<kPiece>(d, hi[s], w_hi, 1);
        }
      }
      hopper::wgmma_commit();
      if (held >= 0) {
        hopper::wgmma_wait<1>();
        if (releases) hopper::mbar_arrive(ring.empty + 8 * held);
      }
      held = ring.stage;
      ring.advance();
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_registers<N / 2>(acc);
  hopper::fence_registers<16>(&hi[0][0]);
  hopper::fence_registers<16>(&lo[0][0]);
  if (releases) hopper::mbar_arrive(ring.empty + 8 * held);
}

// h[:, 0:N] = acc + bias (acc alone without kBias), ReLU'd if kRelu,
// point-major into this thread's rows r0 and r0 + 8 of `act` (each warp
// writes only its own 16 rows).
template <int N, bool kRelu, bool kBias = true>
__device__ __forceinline__ void store_f32(const float* acc,
                                          const float* __restrict__ bias,
                                          uint32_t act, int r0, int pair) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float2 b = make_float2(0.0f, 0.0f);
    if constexpr (kBias) {
      b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + pair));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + b.x;
      float v1 = acc[4 * j + 2 * h + 1] + b.y;
      if (kRelu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      st_f32x2(f32_addr(act, r0 + 8 * h, 8 * j + pair), v0, v1);
    }
  }
}

// The encode of fused_nerf_wgmma.cuh into f32 rows of a warpgroup at `act`.
template <bool kSincos = true>
__device__ __forceinline__ void encode_rows_f32(
    const float* __restrict__ x, long long row0, long long num_points,
    const float* __restrict__ enc, int E, int include_inputs, int width,
    uint32_t act, int col0, int warp, int warps, int lane) {
  wgmma::encode_rows_to<kSincos>(x, row0, num_points, enc, E, include_inputs,
                                 width, col0, warp, warps, lane,
                                 [act](int row, int col, float v) {
                                   st_f32(f32_addr(act, row, col), v);
                                 });
}

// One producer thread streams the image's slabs of a (K, N) matrix from
// `src` through the ring; returns the source past them.
__device__ __forceinline__ const char* stream_slabs(const char* src, int K,
                                                    int N, uint32_t ring_base,
                                                    uint32_t slot_bytes,
                                                    uint32_t full,
                                                    uint32_t empty,
                                                    int stages, int* stage,
                                                    uint32_t* phase) {
  const uint32_t bytes = stage_bytes(N);
  for (int k0 = 0; k0 < K; k0 += kSlabK) {
    for (int q = 0; q < pieces(N); ++q) {
      hopper::mbar_wait(empty + 8 * *stage, *phase ^ 1u);
      hopper::mbar_arrive_expect_tx(full + 8 * *stage, bytes);
      hopper::bulk_load(ring_base + *stage * slot_bytes, src, bytes,
                        full + 8 * *stage);
      src += bytes;
      if (++*stage == stages) {
        *stage = 0;
        *phase ^= 1u;
      }
    }
  }
  return src;
}

}  // namespace tf32
}  // namespace ffn
