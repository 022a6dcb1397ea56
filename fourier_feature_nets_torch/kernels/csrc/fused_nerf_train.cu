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
// time for a 131,072-point step. The TPU kernel kept every weight and every
// gradient accumulator resident in VMEM across a sequential grid. Here
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
// f32: exact FFMA on the CUDA cores over 16-point tiles. Every activation of
// the tile stays in shared memory; weights are read from global memory (L2)
// with their rows staged in chunks of kStageK; each block adds its tile's
// partial dW = h^T dz into the global f32 buffer with float4 atomicAdd.
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
// Both kernels mask the ragged last tile themselves (zero inputs and zero
// cotangent rows, so dead points add nothing) and launch on the caller's
// stream; the entry point returns cudaGetLastError(). The bf16 kernel's one
// allocation, the scratch its tiles park their activations in, is the
// wrapper's (torch.empty, of the size fused_nerf_backward_scratch_bytes
// gives); neither kernel allocates.

#include "fused_nerf_common.cuh"
#include "fused_nerf_wgmma.cuh"
#include "hopper.cuh"
#include "shared_limit.cuh"

namespace {

using ffn::Desc;
using ffn::kHeadWidth;
using ffn::kMaxChannels;
using ffn::to_f;
using ffn::to_t;

constexpr int kRowPad = 8;      // elements of padding per shared row
constexpr int kStageK = 16;     // f32 weight rows staged per chunk

// Points per block and threads per block of the f32 tile: its warps each
// own two tile rows, which ran faster with 8 warps than with 16 (40 vs 45
// ms at the flagship's 131,072 points on an H100 80GB HBM3 at 700 W).
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kRows = 16;
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
};

// f32: kStageK staged weight rows (the transposed stage of dh has one
// column of padding per row)
constexpr int kScratchFloats = kStageK * (kMaxChannels + 4);

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
// f32: the biases and the heads
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

// The blocks of a bf16 launch on the current device: one per tile, at most
// one per SM.
cudaError_t bf16_grid(long long num_points, long long* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (num_points + kTileRows - 1) / kTileRows;
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
  err = bf16_grid(num_points, &grid);
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

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// g: (N, 4) f32 cotangent. d_weights / d_biases: f32 buffers in the pack's
// layout, zeroed by the caller; the kernel adds into them.
// weight_dtype: 0 = f32, `weights` the flat (in, out) pack, no scratch; 1 =
// bf16, `weights` the slab image of kernels/fused_nerf.py::slab_image, and
// `scratch` scratch_bytes of device memory for the activations the tiles
// park, at least what fused_nerf_backward_scratch_bytes gives (else the
// launch fails with cudaErrorInvalidValue).
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
    err = launch<float>(positions, views, pos_enc, view_enc, weights, biases,
                        g, d_weights, d_biases, num_points, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// *bytes: the scratch a bf16 launch of num_points points needs on the
// current device, min(tiles, SMs) blocks of 2 L ceil(C / 64) x 8 KB. The
// stream is unused (every entry point takes one).
extern "C" int fused_nerf_backward_scratch_bytes(const void* meta,
                                                 long long num_points,
                                                 long long* bytes,
                                                 void* stream) {
  (void)stream;
  Desc d;
  if (!ffn::parse_desc(static_cast<const long long*>(meta), &d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long grid = 0;
  const cudaError_t err = bf16_grid(num_points, &grid);
  *bytes = err == cudaSuccess ? grid * bf16_scratch_per_block(d) : 0;
  return static_cast<int>(err);
}

extern "C" const char* fused_nerf_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
