// Fused NeRF recompute-backward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels fourier_feature_nets_tpu/ops/
// fused_nerf_train.py::_bwd_kernel (row-major) and ops/fused_nerf_train_fm.py
// ::_bwd_kernel_fm (feature-major, the same function). Given positions,
// views, the packed weights and the (N, 4) f32 cotangent g of the logits
// [r, g, b, opacity], one block takes a tile of points, recomputes the
// forward on chip (rounding where K1, fused_nerf.cu, rounds; the encode and
// sin/cos are K1's, from fused_nerf_common.cuh), then backpropagates and adds
// the tile's share of every packed weight and bias gradient into one f32
// gradient buffer. Positions and views get no gradient.
//
// What bounds it on an H100. The backward needs every layer's activation of
// the tile: per point [enc P | venc V | h_0 .. h_{L-1} | bottleneck |
// hidden], 2,480 values for the 8x256 flagship. They stay in shared memory,
// so the tile is small: 32 points in bf16 (159 KB of activations) and 16 in
// f32 (the same bytes). Weights are read from global memory, where the
// ~1.2 MB pack stays resident in L2, as in K1. The TPU kernel kept its
// gradient accumulators resident across a sequential grid; here blocks run
// in parallel and the flagship's ~0.6 M weight gradients (2.4 MB f32) do not
// fit a block, so each block adds its tile's partial dW = h^T dz into the
// global f32 buffer with float4 atomicAdd (sm_90), which the L2 serves:
// ~0.6 M adds per tile, 4,096 tiles per 131,072-point step in bf16. The sum
// order of the atomics varies from run to run, so the gradients are not
// bitwise reproducible. Against the plain twin at the flagship (H100): a
// same-sign cotangent agrees to < 4e-4 of the largest gradient of each
// leaf in both types; a random-sign one, whose sums cancel, to ~1e-2,
// because a pre-activation within rounding of 0 can take the other ReLU
// side here and in the twin (f32), and because tensor-core sums round a
// few bf16 activations one step away from the twin's (bf16). In f32, with
// the cotangent of the points near a ReLU boundary zeroed, they agree to
// < 1e-5. chip_smoke.py holds K2 to each of these.
// This first version is the simple, right one: one block per SM (shared
// memory), WMMA (mma.sync) rather than wgmma, a scratch round trip per
// output fragment, and atomics for the cross-block reduction.
//
// Rounding points (bf16). Each body layer's f32 sum + bias is cast and then
// ReLU'd, the bottleneck is cast, the hidden layer is ReLU'd and cast (K1).
// Every dz is cast to the working type before it feeds a product. The heads
// take the f32 cotangent as f32 on the CUDA cores: the color head's
// dhidden, the color and opacity weight gradients, and the g_opacity x
// opacity_w^T term of dh, since JAX promotes a bf16 x f32 product to f32.
// The ReLU mask is h > 0 (the TPU's ceil(min(h, 1)) is a Mosaic workaround
// with the same 0/1 values).
//
// Products. bf16 uses WMMA 16x16x16 with f32 accumulation:
//   forward  z = [h | features] @ W            (row-major A and B)
//   dh       dh = dz @ W^T                      (W loaded as col_major B)
//   dW       dW += h^T @ dz                     (h loaded as col_major A)
// f32 uses exact FFMA on the CUDA cores with the same three products.
// Inputs that concatenate two activations ([h | pos features] of a skip
// layer, [bottleneck | view features] of the hidden layer) are two column
// ranges of the activation row, walked as one K range. A skip layer's dh
// uses only the first C rows of W (encode features get no gradient).
//
// The kernel masks the ragged last tile itself (zero inputs and zero
// cotangent rows, so dead points add nothing), launches on the caller's
// stream and allocates nothing; the entry point returns cudaGetLastError().

#include <mma.h>

#include "fused_nerf_common.cuh"

namespace {

using ffn::Desc;
using ffn::kHeadWidth;
using ffn::kMaxChannels;
using ffn::to_f;
using ffn::to_t;

constexpr int kRowPad = 8;      // elements of padding per shared row
constexpr int kStageK = 16;     // f32 weight rows staged per chunk

// Points per block and threads per block. Shared memory holds one block
// per SM either way; 16 warps hide the bf16 path's L2 latency better than
// 8 (7.9 vs 9.9 ms at the flagship's 131,072 points on an H100 80GB HBM3
// at 700 W), while the f32 path, whose warps each own two tile rows, is
// faster with 8 (40 vs 45 ms).
template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kRows = 32;
  static constexpr int kThreads = 512;
  static constexpr int kWarps = kThreads / 32;
};
template <>
struct Tile<float> {
  static constexpr int kRows = 16;
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
};

// bf16: one 16x16 f32 tile per warp; f32: kStageK staged weight rows (the
// transposed stage of dh has one column of padding per row)
constexpr int kScratchFloats = kStageK * (kMaxChannels + 4);
static_assert(kScratchFloats >= Tile<__nv_bfloat16>::kWarps * 256,
              "scratch too small");

// An input of K columns read from one or two column ranges of the
// activation row: columns [0, len0) at col0, the rest at col1. len0 is a
// multiple of 16, so no 16-wide k step straddles the two.
struct Seg {
  int col0;
  int len0;
  int col1;
  __device__ __forceinline__ int at(int k) const {
    return k < len0 ? col0 + k : col1 + (k - len0);
  }
};

// Where the tile's values live in shared memory.
struct Layout {
  int C, L, P, V;
  int lda;   // activation row: [enc P | venc V | h_0..h_{L-1} | bott | hidden]
  int ldd;   // dz row
  __device__ __forceinline__ int enc() const { return 0; }
  __device__ __forceinline__ int venc() const { return P; }
  __device__ __forceinline__ int h(int i) const { return P + V + i * C; }
  __device__ __forceinline__ int bottleneck() const { return h(L); }
  __device__ __forceinline__ int hidden() const { return h(L) + C; }
};

__host__ __device__ inline int act_width(const Desc& d) {
  return d.pos_width + d.view_width + (d.num_layers + 1) * d.channels
         + d.channels / 2;
}

__device__ __forceinline__ void atomic_add4(float* p, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

// Finished forward value of a body/hidden layer (relu=true: cast, then
// ReLU, which commutes with the rounding) or the bottleneck (cast).
template <typename T>
__device__ __forceinline__ T forward_value(float v, bool relu) {
  const T t = to_t<T>(v);
  return relu ? to_t<T>(fmaxf(to_f(t), 0.0f)) : t;
}

// dh epilogue: adds the opacity head's f32 term, applies the ReLU mask of
// the activation at mask_col (mask_col < 0: no mask), casts.
template <typename T>
__device__ __forceinline__ T dz_value(float v, int row, int col,
                                      const T* act, int lda, int mask_col,
                                      const T* __restrict__ opacity_w,
                                      const float* gs) {
  if (opacity_w != nullptr) {
    v += gs[row * 4 + 3] * to_f(opacity_w[col * kHeadWidth]);
  }
  if (mask_col >= 0 && !(to_f(act[row * lda + mask_col + col]) > 0.0f)) {
    v = 0.0f;
  }
  return to_t<T>(v);
}

// ---------------------------------------------------------------------------
// bf16: WMMA 16x16x16, f32 accumulation
// ---------------------------------------------------------------------------

using Bf16 = __nv_bfloat16;
constexpr int kRowsBf16 = Tile<Bf16>::kRows;
constexpr int kWarpsBf16 = Tile<Bf16>::kWarps;
constexpr int kRowBlocks = kRowsBf16 / 16;
constexpr int kColBlocksPerWarp = kMaxChannels / (16 * kWarpsBf16);

// act[:, out_col : out_col + N] = finish(act[:, in] @ W + b).
__device__ void forward_layer(Bf16* act, int lda, Seg in, int K,
                              const Bf16* __restrict__ w, int N,
                              const float* __restrict__ bias, bool relu,
                              int out_col, float* scratch) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int num_col_blocks = N / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      acc[kColBlocksPerWarp][kRowBlocks];
#pragma unroll
  for (int j = 0; j < kColBlocksPerWarp; ++j) {
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i) wmma::fill_fragment(acc[j][i], 0.0f);
  }
  if (warp < num_col_blocks) {
    for (int k = 0; k < K; k += 16) {
      const int src = in.at(k);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, Bf16, wmma::row_major>
          a[kRowBlocks];
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) {
        wmma::load_matrix_sync(a[i], act + i * 16 * lda + src, lda);
      }
#pragma unroll
      for (int j = 0; j < kColBlocksPerWarp; ++j) {
        const int cb = warp + j * kWarpsBf16;
        if (cb < num_col_blocks) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, Bf16, wmma::row_major> b;
          wmma::load_matrix_sync(
              b, w + static_cast<long long>(k) * N + cb * 16, N);
#pragma unroll
          for (int i = 0; i < kRowBlocks; ++i) {
            wmma::mma_sync(acc[j][i], a[i], b, acc[j][i]);
          }
        }
      }
    }
  }
  // out_col is a column range no warp reads in this layer: no barrier
  float* mine = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < kColBlocksPerWarp; ++j) {
    const int cb = warp + j * kWarpsBf16;
    if (cb < num_col_blocks) {
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) {
        wmma::store_matrix_sync(mine, acc[j][i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int col = cb * 16 + (e & 15);
          const int row = i * 16 + (e >> 4);
          act[row * lda + out_col + col] =
              forward_value<Bf16>(mine[e] + __ldg(bias + col), relu);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// grad[K, N] += act[:, in]^T @ dz[:, 0:N], one 16x16 output fragment at a
// time per warp, added to the f32 buffer with float4 atomics.
__device__ void weight_grad(const Bf16* act, int lda, Seg in, int K,
                            const Bf16* dz, int ldd, int N,
                            float* __restrict__ grad, float* scratch) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col_blocks = N / 16;
  const int fragments = (K / 16) * col_blocks;
  float* mine = scratch + warp * 256;
  for (int f = warp; f < fragments; f += kWarpsBf16) {
    const int kb = f / col_blocks;
    const int nb = f - kb * col_blocks;
    const int src = in.at(kb * 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int m = 0; m < kRowsBf16; m += 16) {
      // A = act^T: element (k, m) sits at act[m * lda + src + k]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, Bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, Bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, act + m * lda + src, lda);
      wmma::load_matrix_sync(b, dz + m * ldd + nb * 16, ldd);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(mine, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int q = lane; q < 64; q += 32) {
      const int r = q >> 2;
      const int c = (q & 3) * 4;
      atomic_add4(grad + static_cast<long long>(kb * 16 + r) * N + nb * 16 + c,
                  make_float4(mine[r * 16 + c], mine[r * 16 + c + 1],
                              mine[r * 16 + c + 2], mine[r * 16 + c + 3]));
    }
    __syncwarp();
  }
}

// dz[:, 0:Kout] = dz_value(dz[:, 0:N] @ W[0:Kout, :]^T): W (K, N) row-major
// is read as a col_major B. Overwrites dz after every warp has read it.
__device__ void input_grad(Bf16* dz, int ldd, int N,
                           const Bf16* __restrict__ w, int Kout,
                           const Bf16* act, int lda, int mask_col,
                           const Bf16* __restrict__ opacity_w,
                           const float* gs, float* scratch) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int num_col_blocks = Kout / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      acc[kColBlocksPerWarp][kRowBlocks];
#pragma unroll
  for (int j = 0; j < kColBlocksPerWarp; ++j) {
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i) wmma::fill_fragment(acc[j][i], 0.0f);
  }
  if (warp < num_col_blocks) {
    for (int n = 0; n < N; n += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, Bf16, wmma::row_major>
          a[kRowBlocks];
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) {
        wmma::load_matrix_sync(a[i], dz + i * 16 * ldd + n, ldd);
      }
#pragma unroll
      for (int j = 0; j < kColBlocksPerWarp; ++j) {
        const int cb = warp + j * kWarpsBf16;
        if (cb < num_col_blocks) {
          // B = W^T: element (n, k) sits at w[k * N + n]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, Bf16, wmma::col_major> b;
          wmma::load_matrix_sync(
              b, w + static_cast<long long>(cb * 16) * N + n, N);
#pragma unroll
          for (int i = 0; i < kRowBlocks; ++i) {
            wmma::mma_sync(acc[j][i], a[i], b, acc[j][i]);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp has read dz before any warp writes it
  float* mine = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < kColBlocksPerWarp; ++j) {
    const int cb = warp + j * kWarpsBf16;
    if (cb < num_col_blocks) {
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) {
        wmma::store_matrix_sync(mine, acc[j][i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int col = cb * 16 + (e & 15);
          const int row = i * 16 + (e >> 4);
          dz[row * ldd + col] = dz_value<Bf16>(mine[e], row, col, act, lda,
                                               mask_col, opacity_w, gs);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// f32: exact FFMA on the CUDA cores. Warp w owns tile rows [2w, 2w + 2) of
// the row-output products; lane l owns columns l + 32j.
// ---------------------------------------------------------------------------

constexpr int kRowsF32 = Tile<float>::kRows;
constexpr int kThreadsF32 = Tile<float>::kThreads;
constexpr int kWarpsF32 = Tile<float>::kWarps;
constexpr int kWarpRows = kRowsF32 / kWarpsF32;
constexpr int kLaneCols = kMaxChannels / 32;

__device__ void forward_layer(float* act, int lda, Seg in, int K,
                              const float* __restrict__ w, int N,
                              const float* __restrict__ bias, bool relu,
                              int out_col, float* stage) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[kWarpRows][kLaneCols];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) acc[r][j] = 0.0f;
  }
  const int row_quads = N / 4;
  for (int k0 = 0; k0 < K; k0 += kStageK) {   // K is a multiple of kStageK
    const float4* src =
        reinterpret_cast<const float4*>(w + static_cast<long long>(k0) * N);
    float4* dst = reinterpret_cast<float4*>(stage);
    for (int idx = threadIdx.x; idx < kStageK * row_quads;
         idx += kThreadsF32) {
      dst[idx] = __ldg(src + idx);
    }
    __syncthreads();
    const float* a_rows = act + warp * kWarpRows * lda + in.at(k0);
#pragma unroll 4
    for (int kk = 0; kk < kStageK; ++kk) {
      float a[kWarpRows];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) a[r] = a_rows[r * lda + kk];
      const float* w_row = stage + kk * N;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const int col = lane + 32 * j;
        if (col < N) {
          const float wv = w_row[col];
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) {
            acc[r][j] = fmaf(a[r], wv, acc[r][j]);
          }
        }
      }
    }
    __syncthreads();  // stage reused by the next chunk
  }
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      const int col = lane + 32 * j;
      if (col < N) {
        act[(warp * kWarpRows + r) * lda + out_col + col] =
            forward_value<float>(acc[r][j] + __ldg(bias + col), relu);
      }
    }
  }
  __syncthreads();
}

// grad[K, N] += act[:, in]^T @ dz[:, 0:N]. Warp w owns groups of four
// consecutive output rows (4g .. 4g+3 for g = w, w + 8, ...); lane l owns
// columns 4l + 128j .. +3, added with float4 atomics.
__device__ void weight_grad(const float* act, int lda, Seg in, int K,
                            const float* dz, int ldd, int N,
                            float* __restrict__ grad, float*) {
  constexpr int kGroupCols = kMaxChannels / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int g = warp; g < K / 4; g += kWarpsF32) {
    const int src = in.at(4 * g);
    float4 acc[4][kGroupCols];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < kGroupCols; ++j) {
        acc[q][j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll 4
    for (int m = 0; m < kRowsF32; ++m) {
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = act[m * lda + src + q];
#pragma unroll
      for (int j = 0; j < kGroupCols; ++j) {
        const int col = 4 * lane + 128 * j;
        if (col < N) {
          const float4 b =
              *reinterpret_cast<const float4*>(dz + m * ldd + col);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q][j].x = fmaf(a[q], b.x, acc[q][j].x);
            acc[q][j].y = fmaf(a[q], b.y, acc[q][j].y);
            acc[q][j].z = fmaf(a[q], b.z, acc[q][j].z);
            acc[q][j].w = fmaf(a[q], b.w, acc[q][j].w);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroupCols; ++j) {
      const int col = 4 * lane + 128 * j;
      if (col < N) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          atomic_add4(grad + static_cast<long long>(4 * g + q) * N + col,
                      acc[q][j]);
        }
      }
    }
  }
}

// dz[:, 0:Kout] = dz_value(dz[:, 0:N] @ W[0:Kout, :]^T). kStageK columns of
// W at a time are staged transposed (stage[n][k], one float of padding per
// row against bank conflicts), so lanes read consecutive k.
__device__ void input_grad(float* dz, int ldd, int N,
                           const float* __restrict__ w, int Kout,
                           const float* act, int lda, int mask_col,
                           const float* __restrict__ opacity_w,
                           const float* gs, float* stage) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lds = Kout + 1;
  float acc[kWarpRows][kLaneCols];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) acc[r][j] = 0.0f;
  }
  for (int n0 = 0; n0 < N; n0 += kStageK) {   // N is a multiple of kStageK
    for (int idx = threadIdx.x; idx < Kout * kStageK; idx += kThreadsF32) {
      const int k = idx / kStageK;
      const int nn = idx - k * kStageK;
      stage[nn * lds + k] = __ldg(w + static_cast<long long>(k) * N + n0 + nn);
    }
    __syncthreads();
    const float* a_rows = dz + warp * kWarpRows * ldd + n0;
#pragma unroll 4
    for (int nn = 0; nn < kStageK; ++nn) {
      float a[kWarpRows];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) a[r] = a_rows[r * ldd + nn];
      const float* w_col = stage + nn * lds;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const int col = lane + 32 * j;
        if (col < Kout) {
          const float wv = w_col[col];
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) {
            acc[r][j] = fmaf(a[r], wv, acc[r][j]);
          }
        }
      }
    }
    __syncthreads();  // stage reused; after the last chunk, dz fully read
  }
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int row = warp * kWarpRows + r;
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      const int col = lane + 32 * j;
      if (col < Kout) {
        dz[row * ldd + col] = dz_value<float>(acc[r][j], row, col, act, lda,
                                              mask_col, opacity_w, gs);
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Both types
// ---------------------------------------------------------------------------

// db[0:N] += column sums of dz (working-type values summed in f32).
template <typename T>
__device__ void bias_grad(const T* dz, int ldd, int N, int rows,
                          float* __restrict__ grad) {
  for (int n = threadIdx.x; n < N; n += Tile<T>::kThreads) {
    float s = 0.0f;
    for (int m = 0; m < rows; ++m) s += to_f(dz[m * ldd + n]);
    atomicAdd(grad + n, s);
  }
}

// The heads, in f32 on the CUDA cores: the color head's weight and bias
// gradients and dz of the hidden layer (written to dz[:, 0:C/2]), and the
// opacity head's weight and bias gradients.
template <typename T, int kRows>
__device__ void head_grads(const T* act, const Layout& lay, T* dz,
                           const float* gs, const T* __restrict__ color_w,
                           const T* __restrict__ opacity_w, float* d_color_w,
                           float* d_color_b, float* d_opacity_w,
                           float* d_opacity_b) {
  const int half = lay.C / 2;
  const int hidden = lay.hidden();
  for (int idx = threadIdx.x; idx < kRows * half;
       idx += Tile<T>::kThreads) {
    const int m = idx / half;
    const int c = idx - m * half;
    const float* g = gs + m * 4;
    const T* w = color_w + c * kHeadWidth;
    const float dh = fmaf(g[2], to_f(w[2]),
                          fmaf(g[1], to_f(w[1]), g[0] * to_f(w[0])));
    const bool live = to_f(act[m * lay.lda + hidden + c]) > 0.0f;
    dz[m * lay.ldd + c] = to_t<T>(live ? dh : 0.0f);
  }
  const int last = lay.h(lay.L - 1);
  for (int c = threadIdx.x; c < lay.C; c += Tile<T>::kThreads) {
    float op = 0.0f;
    for (int m = 0; m < kRows; ++m) {
      op = fmaf(to_f(act[m * lay.lda + last + c]), gs[m * 4 + 3], op);
    }
    atomicAdd(d_opacity_w + c * kHeadWidth, op);
    if (c < half) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      for (int m = 0; m < kRows; ++m) {
        const float h = to_f(act[m * lay.lda + hidden + c]);
        s0 = fmaf(h, gs[m * 4 + 0], s0);
        s1 = fmaf(h, gs[m * 4 + 1], s1);
        s2 = fmaf(h, gs[m * 4 + 2], s2);
      }
      atomicAdd(d_color_w + c * kHeadWidth + 0, s0);
      atomicAdd(d_color_w + c * kHeadWidth + 1, s1);
      atomicAdd(d_color_w + c * kHeadWidth + 2, s2);
    }
  }
  if (threadIdx.x < 4) {
    float s = 0.0f;
    for (int m = 0; m < kRows; ++m) s += gs[m * 4 + threadIdx.x];
    atomicAdd(threadIdx.x < 3 ? d_color_b + threadIdx.x : d_opacity_b, s);
  }
  __syncthreads();
}

template <typename T>
size_t shared_bytes(const Desc& d) {
  constexpr int kRows = Tile<T>::kRows;
  const size_t lda = act_width(d) + kRowPad;
  const size_t ldd = d.channels + kRowPad;
  return kScratchFloats * sizeof(float) + kRows * lda * sizeof(T)
         + kRows * ldd * sizeof(T) + kRows * 10 * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(Tile<T>::kThreads)
fused_nerf_backward_kernel(const float* __restrict__ positions,
                           const float* __restrict__ views,
                           const float* __restrict__ pos_enc,
                           const float* __restrict__ view_enc,
                           const T* __restrict__ weights,
                           const float* __restrict__ biases,
                           const float* __restrict__ g,
                           float* __restrict__ d_weights,
                           float* __restrict__ d_biases,
                           long long num_points, Desc d) {
  constexpr int kRows = Tile<T>::kRows;
  constexpr int kThreads = Tile<T>::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  Layout lay;
  lay.C = d.channels;
  lay.L = d.num_layers;
  lay.P = d.pos_width;
  lay.V = d.view_width;
  lay.lda = act_width(d) + kRowPad;
  lay.ldd = d.channels + kRowPad;
  const int C = lay.C;
  const int L = lay.L;
  float* scratch = reinterpret_cast<float*>(smem);
  T* act = reinterpret_cast<T*>(smem + kScratchFloats * sizeof(float));
  T* dz = act + kRows * lay.lda;
  float* xs = reinterpret_cast<float*>(dz + kRows * lay.ldd);
  float* vs = xs + kRows * 3;
  float* gs = vs + kRows * 3;

  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int idx = threadIdx.x; idx < kRows * 3; idx += kThreads) {
    const bool live = row0 + idx / 3 < num_points;   // ragged last tile
    xs[idx] = live ? positions[row0 * 3 + idx] : 0.0f;
    vs[idx] = live ? views[row0 * 3 + idx] : 0.0f;
  }
  for (int idx = threadIdx.x; idx < kRows * 4; idx += kThreads) {
    gs[idx] = row0 + idx / 4 < num_points ? g[row0 * 4 + idx] : 0.0f;
  }
  __syncthreads();
  ffn::encode<kRows, kThreads, T>(xs, pos_enc, d.e_pos, d.include_inputs,
                                  lay.P, act, lay.lda, lay.enc());
  ffn::encode<kRows, kThreads, T>(vs, view_enc, d.e_view, d.include_inputs,
                                  lay.V, act, lay.lda, lay.venc());
  __syncthreads();

  // the inputs of body layer i, as one K range
  auto body_input = [&](int i, int* K) {
    if (i == 0) {
      *K = lay.P;
      return Seg{lay.enc(), lay.P, 0};
    }
    if ((d.skip_mask >> i) & 1u) {
      *K = C + lay.P;
      return Seg{lay.h(i - 1), C, lay.enc()};
    }
    *K = C;
    return Seg{lay.h(i - 1), C, 0};
  };
  const Seg hidden_in{lay.bottleneck(), C, lay.venc()};

  // ---- forward recompute: every activation stays in shared memory ----
  for (int i = 0; i < L; ++i) {
    int K;
    const Seg in = body_input(i, &K);
    forward_layer(act, lay.lda, in, K, weights + d.w_off[i], C,
                  biases + d.b_off[i], true, lay.h(i), scratch);
  }
  forward_layer(act, lay.lda, Seg{lay.h(L - 1), C, 0}, C,
                weights + d.w_off[L + 1], C, biases + d.b_off[L + 1], false,
                lay.bottleneck(), scratch);
  forward_layer(act, lay.lda, hidden_in, C + lay.V, weights + d.w_off[L + 2],
                C / 2, biases + d.b_off[L + 2], true, lay.hidden(), scratch);

  // ---- backward ----
  // heads: dz = dz of the hidden layer
  head_grads<T, kRows>(act, lay, dz, gs, weights + d.w_off[L + 3],
                       weights + d.w_off[L], d_weights + d.w_off[L + 3],
                       d_biases + d.b_off[L + 3], d_weights + d.w_off[L],
                       d_biases + d.b_off[L]);
  // hidden layer; dz <- d_bottleneck (cast, no activation)
  weight_grad(act, lay.lda, hidden_in, C + lay.V, dz, lay.ldd, C / 2,
              d_weights + d.w_off[L + 2], scratch);
  bias_grad(dz, lay.ldd, C / 2, kRows, d_biases + d.b_off[L + 2]);
  input_grad(dz, lay.ldd, C / 2, weights + d.w_off[L + 2], C, act, lay.lda,
             -1, static_cast<const T*>(nullptr), gs, scratch);
  // bottleneck; dz <- dz of the last body layer, with the opacity term
  weight_grad(act, lay.lda, Seg{lay.h(L - 1), C, 0}, C, dz, lay.ldd, C,
              d_weights + d.w_off[L + 1], scratch);
  bias_grad(dz, lay.ldd, C, kRows, d_biases + d.b_off[L + 1]);
  input_grad(dz, lay.ldd, C, weights + d.w_off[L + 1], C, act, lay.lda,
             lay.h(L - 1), weights + d.w_off[L], gs, scratch);
  // body, last layer to first
  for (int i = L - 1; i >= 0; --i) {
    int K;
    const Seg in = body_input(i, &K);
    weight_grad(act, lay.lda, in, K, dz, lay.ldd, C, d_weights + d.w_off[i],
                scratch);
    bias_grad(dz, lay.ldd, C, kRows, d_biases + d.b_off[i]);
    if (i > 0) {
      input_grad(dz, lay.ldd, C, weights + d.w_off[i], C, act, lay.lda,
                 lay.h(i - 1), static_cast<const T*>(nullptr), gs, scratch);
    }
  }
}

template <typename T>
cudaError_t launch(const void* positions, const void* views,
                   const void* pos_enc, const void* view_enc,
                   const void* weights, const void* biases, const void* g,
                   void* d_weights, void* d_biases, long long num_points,
                   const Desc& d, cudaStream_t stream) {
  constexpr int kRows = Tile<T>::kRows;
  const size_t smem = shared_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_backward_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (num_points + kRows - 1) / kRows;
  fused_nerf_backward_kernel<T><<<static_cast<unsigned>(blocks),
                                  Tile<T>::kThreads,
                                  smem, stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(views),
      static_cast<const float*>(pos_enc), static_cast<const float*>(view_enc),
      static_cast<const T*>(weights), static_cast<const float*>(biases),
      static_cast<const float*>(g), static_cast<float*>(d_weights),
      static_cast<float*>(d_biases), num_points, d);
  return cudaGetLastError();
}

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// g: (N, 4) f32 cotangent. d_weights / d_biases: f32 buffers in the pack's
// layout, zeroed by the caller; the kernel adds into them.
// weight_dtype: 0 = f32, 1 = bf16.
extern "C" int fused_nerf_backward(const void* positions, const void* views,
                                   const void* pos_enc, const void* view_enc,
                                   const void* weights, const void* biases,
                                   const void* meta, const void* g,
                                   void* d_weights, void* d_biases,
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
    err = launch<__nv_bfloat16>(positions, views, pos_enc, view_enc, weights,
                                biases, g, d_weights, d_biases, num_points, d,
                                s);
  } else if (weight_dtype == 0) {
    err = launch<float>(positions, views, pos_enc, view_enc, weights, biases,
                        g, d_weights, d_biases, num_points, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_nerf_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
