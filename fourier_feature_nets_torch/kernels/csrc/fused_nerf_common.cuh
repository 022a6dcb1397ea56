// Device code shared by the fused NeRF forward (fused_nerf.cu, K1), the
// recompute backward (fused_nerf_train.cu, K2), the fused ray render
// (fused_ray_render.cu, K3) and the ablations (fused_nerf_ablation.cu, P2):
// the packed-model descriptor, the working-type conversions, the positional
// encode with the TPU kernels' sin/cos
// (fourier_feature_nets_tpu/ops/fused_nerf.py::_fast_sincos), so that K2's
// recomputed forward rounds where K1 rounds, and the 64-point forward tile
// (finish and the two dense overloads): K3 runs it in both types (K1's, K2's
// and P2's paths are the wgmma kernels of fused_nerf_forward.cuh and
// fused_nerf_train.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace ffn {

constexpr int kMaxLayers = 16;
constexpr int kMaxChannels = 256;
constexpr int kHeadWidth = 16;  // heads padded to the MMA tile width

// The packed model, read from the int64 meta array of the Python pack:
// num_layers, channels, P, V, e_pos, e_view, include_inputs, skip_mask,
// then num_layers + 4 weight offsets (elements) and as many bias offsets.
// Layer order: body 0..L-1, opacity head, bottleneck, hidden, color head.
struct Desc {
  int num_layers;
  int channels;
  int pos_width;    // P: [cos E | sin E | raw 3 | zero pad] rounded to 16
  int view_width;   // V: the same for the view encode
  int e_pos;
  int e_view;
  int include_inputs;
  unsigned skip_mask;
  long long w_off[kMaxLayers + 4];
  long long b_off[kMaxLayers + 4];
};

// Fills `d` from `meta`; false if the kernels cannot take the model.
inline bool parse_desc(const long long* m, Desc* d) {
  d->num_layers = static_cast<int>(m[0]);
  d->channels = static_cast<int>(m[1]);
  d->pos_width = static_cast<int>(m[2]);
  d->view_width = static_cast<int>(m[3]);
  d->e_pos = static_cast<int>(m[4]);
  d->e_view = static_cast<int>(m[5]);
  d->include_inputs = static_cast<int>(m[6]);
  d->skip_mask = static_cast<unsigned>(m[7]);
  if (d->num_layers < 1 || d->num_layers > kMaxLayers
      || d->channels % 32 != 0 || d->channels > kMaxChannels
      || d->pos_width % 16 != 0 || d->view_width % 16 != 0
      || (d->skip_mask & 1u)) {
    return false;
  }
  const int num_packed = d->num_layers + 4;
  for (int i = 0; i < num_packed; ++i) {
    d->w_off[i] = m[8 + i];
    d->b_off[i] = m[8 + num_packed + i];
  }
  return true;
}

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ float to_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Same reduction and polynomial as ops/fused_nerf.py::_fast_sincos.
__device__ __forceinline__ void fast_sincos(float x, float* s, float* c) {
  const float two_pi = 6.283185307179586f;
  float f = x * 0.15915494309189535f;
  f = f - rintf(f);
  const float t = f * two_pi;
  const float t2 = t * t;
  *c = 1.0f + t2 * (-0.5f + t2 * (4.1666666666666664e-2f + t2 * (
      -1.3888888888888889e-3f + t2 * (2.4801587301587302e-5f + t2 * (
          -2.7557319223985893e-7f + t2 * (2.08767569878681e-9f
                                          - t2 * 1.1470745597729725e-11f))))));
  *s = t * (1.0f + t2 * (-1.6666666666666666e-1f + t2 * (
      8.3333333333333332e-3f + t2 * (-1.9841269841269841e-4f + t2 * (
          2.7557319223985893e-6f + t2 * (-2.5052108385441720e-8f
                                         + t2 * 1.6059043836821613e-10f))))));
}

// Writes [cos(xB) | sin(xB) | x (optional) | zeros] for kRows points into
// act[:, col0 : col0 + width]. B is (3, E) f32; the phase is three f32
// multiply-adds, never a reduced-precision product.
template <int kRows, int kNThreads, typename T>
__device__ void encode(const float* xs, const float* __restrict__ enc, int E,
                       int include_inputs, int width, T* act, int lda,
                       int col0) {
  for (int idx = threadIdx.x; idx < kRows * E; idx += kNThreads) {
    const int r = idx / E;
    const int e = idx - r * E;
    const float* x = xs + 3 * r;
    const float phase = fmaf(x[2], __ldg(enc + 2 * E + e),
                             fmaf(x[1], __ldg(enc + E + e),
                                  x[0] * __ldg(enc + e)));
    float s, c;
    fast_sincos(phase, &s, &c);
    act[r * lda + col0 + e] = to_t<T>(c);
    act[r * lda + col0 + E + e] = to_t<T>(s);
  }
  const int tail = width - 2 * E;
  for (int idx = threadIdx.x; idx < kRows * tail; idx += kNThreads) {
    const int r = idx / tail;
    const int j = idx - r * tail;
    const float v = (include_inputs && j < 3) ? xs[3 * r + j] : 0.0f;
    act[r * lda + col0 + 2 * E + j] = to_t<T>(v);
  }
}

// ---------------------------------------------------------------------------
// The 64-point forward tile (K3): one block of kThreads
// threads holds kTile points' activation rows in shared memory and walks
// the layers, reading each layer's weights from global memory (L2).
// ---------------------------------------------------------------------------

constexpr int kTile = 64;       // points per tile
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowBlocks = kTile / 16;
constexpr int kMaxColBlocksPerWarp = 2;   // N <= 16 * 8 * 2 = 256
static_assert(kMaxChannels == 16 * kWarps * kMaxColBlocksPerWarp,
              "one column block per warp and step covers the widest layer");
constexpr int kRowPad = 8;      // elements of padding per activation row
constexpr int kStageK = 16;     // f32 weight rows staged per chunk
// per-block scratch: bf16 path, one 16x16 f32 tile per warp; f32 path,
// kStageK weight rows
constexpr int kScratchFloats = kStageK * kMaxChannels;
static_assert(kScratchFloats >= kWarps * 256, "scratch too small");

enum Mode { kReluCast = 0, kCast = 1, kToOutput = 2 };

// How a layer turns an output's f32 sum into its finished value, chosen at
// compile time: K1's layers add the bias (AddBias); K3's hidden layer first
// adds its ray's view product (AddRowThenBias); K3's view product adds
// nothing (NoBias).
struct AddBias {
  __device__ __forceinline__ float operator()(float acc, int, int col,
                                              const float* bias) const {
    return acc + __ldg(bias + col);
  }
};

struct NoBias {
  __device__ __forceinline__ float operator()(float acc, int, int,
                                              const float*) const {
    return acc;
  }
};

// Adds table[row_index[row] * ld + col] (working type), then the bias.
template <typename T>
struct AddRowThenBias {
  const T* table;
  const int* row_index;
  int ld;
  __device__ __forceinline__ float operator()(float acc, int row, int col,
                                              const float* bias) const {
    return (acc + to_f(table[row_index[row] * ld + col])) + __ldg(bias + col);
  }
};

// Stores one finished f32 value of output (row, col).
template <typename T>
__device__ __forceinline__ void finish(float v, int row, int col, int mode,
                                       T* act, int lda, float* out,
                                       long long row0, long long num_points,
                                       int out_col, int out_count) {
  if (mode == kToOutput) {
    if (col < out_count && row0 + row < num_points) {
      out[(row0 + row) * 4 + out_col + col] = v;
    }
  } else if (mode == kReluCast) {
    // cast the f32 sum, then ReLU (ReLU commutes with the rounding)
    act[row * lda + col] = to_t<T>(fmaxf(to_f(to_t<T>(v)), 0.0f));
  } else {
    act[row * lda + col] = to_t<T>(v);
  }
}

// One dense layer over the tile, bf16 tensor cores, f32 accumulation.
// Reads act[:, a_col : a_col + K]; in modes kReluCast/kCast overwrites
// act[:, 0 : N] after every warp has finished reading. In mode kToOutput
// writes out[(row0 + row) * 4 + out_col + col] for col < out_count and
// row0 + row < num_points (out may be global or shared memory).
template <typename Epilogue = AddBias>
__device__ void dense(const __nv_bfloat16* act_in, __nv_bfloat16* act,
                      int lda, int a_col, int K,
                      const __nv_bfloat16* __restrict__ w, int N,
                      const float* __restrict__ bias, int mode, float* out,
                      long long row0, long long num_points, int out_col,
                      int out_count, float* scratch,
                      Epilogue epilogue = Epilogue()) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int num_col_blocks = N / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      acc[kMaxColBlocksPerWarp][kRowBlocks];
#pragma unroll
  for (int j = 0; j < kMaxColBlocksPerWarp; ++j) {
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i) wmma::fill_fragment(acc[j][i], 0.0f);
  }
  if (warp < num_col_blocks) {
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[kRowBlocks];
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) {
        wmma::load_matrix_sync(a[i], act_in + i * 16 * lda + a_col + k, lda);
      }
#pragma unroll
      for (int j = 0; j < kMaxColBlocksPerWarp; ++j) {
        const int cb = warp + j * kWarps;
        if (cb < num_col_blocks) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(b, w + static_cast<long long>(k) * N + cb * 16,
                                 N);
#pragma unroll
          for (int i = 0; i < kRowBlocks; ++i) {
            wmma::mma_sync(acc[j][i], a[i], b, acc[j][i]);
          }
        }
      }
    }
  }
  __syncthreads();  // all reads of act are done before any warp writes it
  float* mine = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < kMaxColBlocksPerWarp; ++j) {
    const int cb = warp + j * kWarps;
    if (cb < num_col_blocks) {
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) {
        wmma::store_matrix_sync(mine, acc[j][i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = i * 16 + (e >> 4);
          const int col = cb * 16 + (e & 15);
          finish(epilogue(mine[e], row, col, bias), row, col,
                 mode, act, lda, out, row0, num_points, out_col, out_count);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// The same layer in exact f32 on the CUDA cores. The block stages kStageK
// weight rows at a time in shared memory (one coalesced read per block
// instead of one per warp); warp w owns rows [8w, 8w + 8), lane l owns
// columns l + 32j (broadcast activation reads, conflict-free weight reads).
template <typename Epilogue = AddBias>
__device__ void dense(const float* act_in, float* act, int lda, int a_col,
                      int K, const float* __restrict__ w, int N,
                      const float* __restrict__ bias, int mode, float* out,
                      long long row0, long long num_points, int out_col,
                      int out_count, float* stage,
                      Epilogue epilogue = Epilogue()) {
  constexpr int kRows = kTile / kWarps;
  constexpr int kCols = kMaxChannels / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;
  }
  const float* a_rows = act_in + warp * kRows * lda + a_col;
  const int row_quads = N / 4;
  for (int k0 = 0; k0 < K; k0 += kStageK) {   // K is a multiple of kStageK
    const float4* src =
        reinterpret_cast<const float4*>(w + static_cast<long long>(k0) * N);
    float4* dst = reinterpret_cast<float4*>(stage);
    for (int idx = threadIdx.x; idx < kStageK * row_quads; idx += kThreads) {
      dst[idx] = __ldg(src + idx);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kStageK; ++kk) {
      float a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = a_rows[r * lda + k0 + kk];
      const float* w_row = stage + kk * N;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + 32 * j;
        if (col < N) {
          const float wv = w_row[col];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][j] = fmaf(a[r], wv, acc[r][j]);
          }
        }
      }
    }
    __syncthreads();  // stage reused next chunk; act free to overwrite
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = lane + 32 * j;
      if (col < N) {
        const int row = warp * kRows + r;
        finish(epilogue(acc[r][j], row, col, bias), row, col,
               mode, act, lda, out, row0, num_points, out_col, out_count);
      }
    }
  }
  __syncthreads();
}

}  // namespace ffn
