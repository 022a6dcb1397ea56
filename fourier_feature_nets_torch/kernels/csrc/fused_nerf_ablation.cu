// The fused NeRF forward's ablations for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel of tools/kernel_ablation_bench.py::main
// (make_kernel(mode) :50, pallas_call :154): a copy of the fused NeRF
// forward (ops/fused_nerf.py::_kernel) in which one part of the work is
// taken out or changed, to see what each part costs. The modes:
//   base         the forward unchanged (K1's function);
//   no-view      no bottleneck, view encode, hidden layer or color head:
//                color = opacity * 0 + color bias on every row;
//   no-bias      the body layers add no bias;
//   no-relu      the body layers are cast without a ReLU;
//   matmul-only  both of the last two;
//   bf16-accum   the body products are bf16 (the tool's
//                preferred_element_type=bf16, :51-52, :54-57);
//   no-sincos    the position encode is [phase | phase * 0.5 | raw]
//                (:68-71): it bounds what the sin/cos cost.
// As in the tool, the modes touch only the body layers and the position
// encode: the heads keep their bias and the hidden layer its ReLU, and the
// view encode keeps its sin/cos. The tool's run times the first five
// (:174); the last two are defined there and run here too.
//
// Where bf16-accum rounds. Hopper's bf16 MMA accumulates only in f32, so
// the kernel rounds its f32 sums to bf16 where the tool's bf16 dots and
// adds round (:78-82, :87-93, :101-106):
//   1. each product over one input part (layer 0: cos, sin, raw; a skip
//      layer: those and h; a middle layer: h) is its f32 MMA sum, rounded;
//   2. the parts are added in bf16 in the tool's order, one rounding an
//      add: layer 0 ((cos + sin) + raw), a skip layer h + ((cos + sin) +
//      raw);
//   3. the bias, rounded to bf16, is added in bf16; then the ReLU.
// For that the encode writes each part into its own run of activation
// columns, 16-deep MMA steps long (Parts): the parts of the packed layer
// are 30 rows deep (flagship) and do not start on a 16-row step. A run
// multiplies a 16-aligned window of the layer's weight rows that holds the
// part's rows; its other columns are zero, so the rows of the neighbouring
// part or padding it also reads add exact zeros.
//
// What bounds it on an H100: what bounds the 64-point WMMA tile of
// fused_nerf_common.cuh, K1's bf16 tile until its wgmma redesign
// (fused_nerf.cu), which K3 still runs: ~1.2 MFLOP per point on the tensor
// cores from WMMA, with each 64-point tile re-reading the ~1.2 MB weight
// pack from L2 and a per-layer epilogue through shared memory between two
// block barriers. Its design is that tile's, from the same tile code
// (fused_nerf_common.cuh, untouched), with the mode a template
// parameter: a runtime branch in the per-layer epilogue cost K1 ~1.5% (H100
// 80GB HBM3 at 700 W), so each mode is its own instantiation. no-bias is the
// NoBias epilogue policy, no-relu is the kCast finish in place of
// kReluCast, no-view skips the dead code, no-sincos and bf16-accum have
// their own encode here, and bf16-accum its own body layer. The kernel
// masks the ragged last tile, launches on the caller's stream and allocates
// nothing; the entry point returns cudaGetLastError().

#include "fused_nerf_common.cuh"

#include <type_traits>

namespace {

using ffn::AddBias;
using ffn::dense;
using ffn::Desc;
using ffn::kCast;
using ffn::kHeadWidth;
using ffn::kMaxColBlocksPerWarp;
using ffn::kReluCast;
using ffn::kRowBlocks;
using ffn::kRowPad;
using ffn::kScratchFloats;
using ffn::kThreads;
using ffn::kTile;
using ffn::kToOutput;
using ffn::kWarps;
using ffn::NoBias;

enum Ablation { kBase = 0, kNoView = 1, kNoBias = 2, kNoRelu = 3,
                kMatmulOnly = 4, kBf16Accum = 5, kNoSincos = 6 };

// bf16-accum's position encode: part p (cos, sin, raw) sits in activation
// columns [col[p], col[p] + depth[p]) after the encode's first column, at
// offset lead[p]; that run multiplies weight rows [row[p], row[p] +
// depth[p]) of the encode's rows, which hold the part's rows at the same
// offset and stay inside the packed layer.
struct Parts {
  int count;      // 2, or 3 with raw inputs
  int col[3];
  int row[3];
  int depth[3];   // a multiple of 16
  int lead[3];
  int width;      // the columns of all runs
};

__host__ __device__ inline Parts make_parts(const Desc& d) {
  const int first[3] = {0, d.e_pos, 2 * d.e_pos};
  const int length[3] = {d.e_pos, d.e_pos, 3};
  Parts parts;
  parts.count = d.include_inputs ? 3 : 2;
  parts.width = 0;
  for (int p = 0; p < parts.count; ++p) {
    const int depth = (length[p] + 15) / 16 * 16;
    const int row = first[p] + depth <= d.pos_width ? first[p]
                                                    : d.pos_width - depth;
    parts.col[p] = parts.width;
    parts.row[p] = row;
    parts.depth[p] = depth;
    parts.lead[p] = first[p] - row;
    parts.width += depth;
  }
  return parts;
}

// The activation columns after the C body channels: the position encode's
// (bf16-accum: its runs) or the view encode's, whichever is wider.
__host__ __device__ inline int act_region(const Desc& d, int mode) {
  const int pos = mode == kBf16Accum ? make_parts(d).width : d.pos_width;
  return pos > d.view_width ? pos : d.view_width;
}

// One product run of a bf16-accum layer: act columns [a_col, a_col +
// depth) times weight rows [w_row, w_row + depth).
struct Run {
  int a_col;
  int w_row;
  int depth;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int kMode>
struct Body {   // how a body layer finishes its f32 sum
  static constexpr bool kBias = kMode != kNoBias && kMode != kMatmulOnly;
  static constexpr int kFinish =
      (kMode == kNoRelu || kMode == kMatmulOnly) ? kCast : kReluCast;
};

template <typename T>
size_t shared_bytes(const Desc& d, int mode) {
  const size_t lda = d.channels + act_region(d, mode) + kRowPad;
  return kScratchFloats * sizeof(float) + kTile * lda * sizeof(T)
         + 2 * kTile * 3 * sizeof(float);
}

template <int kMode, typename T>
__device__ __forceinline__ void body_layer(const T* act_in, T* act, int lda,
                                           int a_col, int K, const T* w, int N,
                                           const float* bias, float* out,
                                           long long row0,
                                           long long num_points,
                                           float* scratch) {
  if constexpr (Body<kMode>::kBias) {
    dense<AddBias>(act_in, act, lda, a_col, K, w, N, bias,
                   Body<kMode>::kFinish, out, row0, num_points, 0, 0, scratch);
  } else {
    dense<NoBias>(act_in, act, lda, a_col, K, w, N, bias,
                  Body<kMode>::kFinish, out, row0, num_points, 0, 0, scratch);
  }
}

// no-sincos's position encode: ffn::encode with the phase and half the
// phase in place of its cos and sin: [phase | phase * 0.5 | raw | zeros].
template <typename T>
__device__ void encode_phases(const float* xs, const float* __restrict__ enc,
                              int E, int include_inputs, int width, T* act,
                              int lda, int col0) {
  for (int idx = threadIdx.x; idx < kTile * E; idx += kThreads) {
    const int r = idx / E;
    const int e = idx - r * E;
    const float* x = xs + 3 * r;
    const float phase = fmaf(x[2], __ldg(enc + 2 * E + e),
                             fmaf(x[1], __ldg(enc + E + e),
                                  x[0] * __ldg(enc + e)));
    act[r * lda + col0 + e] = ffn::to_t<T>(phase);
    act[r * lda + col0 + E + e] = ffn::to_t<T>(phase * 0.5f);
  }
  const int tail = width - 2 * E;
  for (int idx = threadIdx.x; idx < kTile * tail; idx += kThreads) {
    const int r = idx / tail;
    const int j = idx - r * tail;
    const float v = (include_inputs && j < 3) ? xs[3 * r + j] : 0.0f;
    act[r * lda + col0 + 2 * E + j] = ffn::to_t<T>(v);
  }
}

// bf16-accum's position encode: K1's cos, sin and raw values, each part in
// its own run of columns (Parts), zeros elsewhere in the runs.
__device__ void encode_runs(const float* xs, const float* __restrict__ enc,
                            const Desc& d, const Parts& parts,
                            __nv_bfloat16* act, int lda, int col0) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int idx = threadIdx.x; idx < kTile * parts.width; idx += kThreads) {
    const int r = idx / parts.width;
    act[r * lda + col0 + idx - r * parts.width] = zero;
  }
  __syncthreads();
  const int E = d.e_pos;
  const int cos_col = col0 + parts.col[0] + parts.lead[0];
  const int sin_col = col0 + parts.col[1] + parts.lead[1];
  for (int idx = threadIdx.x; idx < kTile * E; idx += kThreads) {
    const int r = idx / E;
    const int e = idx - r * E;
    const float* x = xs + 3 * r;
    const float phase = fmaf(x[2], __ldg(enc + 2 * E + e),
                             fmaf(x[1], __ldg(enc + E + e),
                                  x[0] * __ldg(enc + e)));
    float s, c;
    ffn::fast_sincos(phase, &s, &c);
    act[r * lda + cos_col + e] = __float2bfloat16_rn(c);
    act[r * lda + sin_col + e] = __float2bfloat16_rn(s);
  }
  if (parts.count == 3) {
    const int raw_col = col0 + parts.col[2] + parts.lead[2];
    for (int idx = threadIdx.x; idx < kTile * 3; idx += kThreads) {
      const int r = idx / 3;
      act[r * lda + raw_col + idx - r * 3] = __float2bfloat16_rn(xs[idx]);
    }
  }
}

// One bf16-accum body layer over the tile (N = C outputs): for each run in
// order, its product on the tensor cores (f32 sum), rounded to bf16 and
// added to the layer's running bf16 sum in bf16 (the first run starts it);
// then the bf16 bias add and the ReLU into act[:, 0 : N]. Each warp takes
// its column blocks one at a time, so two sets of accumulators (the sum
// and the current product) fit in its registers.
__device__ void dense_bf16_accum(const __nv_bfloat16* act_in,
                                 __nv_bfloat16* act, int lda, const Run* runs,
                                 int num_runs,
                                 const __nv_bfloat16* __restrict__ w, int N,
                                 const float* __restrict__ bias,
                                 float* scratch) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int num_col_blocks = N / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      sum[kMaxColBlocksPerWarp][kRowBlocks];
#pragma unroll
  for (int j = 0; j < kMaxColBlocksPerWarp; ++j) {
    const int cb = warp + j * kWarps;
    if (cb >= num_col_blocks) continue;
    for (int r = 0; r < num_runs; ++r) {
      const Run run = runs[r];
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[kRowBlocks];
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) wmma::fill_fragment(part[i], 0.0f);
      for (int k = 0; k < run.depth; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(
            b, w + static_cast<long long>(run.w_row + k) * N + cb * 16, N);
#pragma unroll
        for (int i = 0; i < kRowBlocks; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::load_matrix_sync(a, act_in + i * 16 * lda + run.a_col + k,
                                 lda);
          wmma::mma_sync(part[i], a, b, part[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowBlocks; ++i) {
#pragma unroll
        for (int t = 0; t < part[i].num_elements; ++t) {
          // rounding points 1 (the product) and 2 (the sum)
          const float product = round_bf16(part[i].x[t]);
          sum[j][i].x[t] = r == 0 ? product
                                  : round_bf16(sum[j][i].x[t] + product);
        }
      }
    }
  }
  __syncthreads();  // all reads of act are done before any warp writes it
  float* mine = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < kMaxColBlocksPerWarp; ++j) {
    const int cb = warp + j * kWarps;
    if (cb >= num_col_blocks) continue;
#pragma unroll
    for (int i = 0; i < kRowBlocks; ++i) {
      wmma::store_matrix_sync(mine, sum[j][i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = i * 16 + (e >> 4);
        const int col = cb * 16 + (e & 15);
        // rounding point 3: the bias add
        const float v = round_bf16(mine[e] + round_bf16(__ldg(bias + col)));
        act[row * lda + col] = __float2bfloat16_rn(fmaxf(v, 0.0f));
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// bf16-accum's body: layer 0 over the encode's runs, then each layer over
// h, a skip layer over the encode's runs first and h last (the tool's
// h + ((cos + sin) + raw)). The encode's rows follow h's C rows in a skip
// layer's weights.
__device__ void body_bf16_accum(__nv_bfloat16* act, int lda, const Desc& d,
                                const Parts& parts,
                                const __nv_bfloat16* __restrict__ weights,
                                const float* __restrict__ biases,
                                float* scratch) {
  const int C = d.channels;
  Run runs[4];
  for (int p = 0; p < parts.count; ++p) {
    runs[p] = Run{C + parts.col[p], parts.row[p], parts.depth[p]};
  }
  dense_bf16_accum(act, act, lda, runs, parts.count, weights + d.w_off[0], C,
                   biases + d.b_off[0], scratch);
  for (int p = 0; p < parts.count; ++p) runs[p].w_row += C;
  runs[parts.count] = Run{0, 0, C};
  const Run h_only = Run{0, 0, C};
  for (int i = 1; i < d.num_layers; ++i) {
    const bool skip = (d.skip_mask >> i) & 1u;
    dense_bf16_accum(act, act, lda, skip ? runs : &h_only,
                     skip ? parts.count + 1 : 1, weights + d.w_off[i], C,
                     biases + d.b_off[i], scratch);
  }
}

// One 64-point tile in mode kMode; the kernels below run it.
template <typename T, int kMode>
__device__ __forceinline__ void ablation_tile(
    const float* __restrict__ positions, const float* __restrict__ views,
    const float* __restrict__ pos_enc, const float* __restrict__ view_enc,
    const T* __restrict__ weights, const float* __restrict__ biases,
    float* __restrict__ out, long long num_points, Desc d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = d.channels;
  const int lda = C + act_region(d, kMode) + kRowPad;
  float* scratch = reinterpret_cast<float*>(smem);
  T* act = reinterpret_cast<T*>(smem + kScratchFloats * sizeof(float));
  float* xs = reinterpret_cast<float*>(act + kTile * lda);
  float* vs = xs + kTile * 3;

  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  for (int idx = threadIdx.x; idx < kTile * 3; idx += kThreads) {
    const bool live = row0 + idx / 3 < num_points;   // ragged last tile
    xs[idx] = live ? positions[row0 * 3 + idx] : 0.0f;
    vs[idx] = live ? views[row0 * 3 + idx] : 0.0f;
  }
  __syncthreads();
  const int L = d.num_layers;
  if constexpr (kMode == kBf16Accum) {
    const Parts parts = make_parts(d);
    encode_runs(xs, pos_enc, d, parts, act, lda, C);
    __syncthreads();
    body_bf16_accum(act, lda, d, parts, weights, biases, scratch);
  } else {
    if constexpr (kMode == kNoSincos) {
      encode_phases<T>(xs, pos_enc, d.e_pos, d.include_inputs, d.pos_width,
                       act, lda, C);
    } else {
      ffn::encode<kTile, kThreads, T>(xs, pos_enc, d.e_pos, d.include_inputs,
                                      d.pos_width, act, lda, C);
    }
    __syncthreads();
    body_layer<kMode>(act, act, lda, C, d.pos_width, weights + d.w_off[0], C,
                      biases + d.b_off[0], out, row0, num_points, scratch);
    for (int i = 1; i < L; ++i) {
      const int K = ((d.skip_mask >> i) & 1u) ? C + d.pos_width : C;
      body_layer<kMode>(act, act, lda, 0, K, weights + d.w_off[i], C,
                        biases + d.b_off[i], out, row0, num_points, scratch);
    }
  }
  // opacity head -> out[:, 3]
  dense(act, act, lda, 0, C, weights + d.w_off[L], kHeadWidth,
        biases + d.b_off[L], kToOutput, out, row0, num_points, 3, 1, scratch);
  if constexpr (kMode == kNoView) {
    // color = opacity * 0 + color bias (the tool's `opacity * 0.0 +
    // color_b`); dense ended in a block barrier, so out[:, 3] is written
    const float* color_b = biases + d.b_off[L + 3];
    for (int idx = threadIdx.x; idx < kTile * 3; idx += kThreads) {
      const long long row = row0 + idx / 3;
      if (row < num_points) {
        out[row * 4 + idx % 3] = out[row * 4 + 3] * 0.0f
                                 + __ldg(color_b + idx % 3);
      }
    }
  } else {
    // bottleneck, cast to the weight type
    dense(act, act, lda, 0, C, weights + d.w_off[L + 1], C,
          biases + d.b_off[L + 1], kCast, out, row0, num_points, 0, 0,
          scratch);
    ffn::encode<kTile, kThreads, T>(vs, view_enc, d.e_view, d.include_inputs,
                                    d.view_width, act, lda, C);
    __syncthreads();
    // hidden layer over [bottleneck | view features]
    dense(act, act, lda, 0, C + d.view_width, weights + d.w_off[L + 2], C / 2,
          biases + d.b_off[L + 2], kReluCast, out, row0, num_points, 0, 0,
          scratch);
    // color head -> out[:, 0:3]
    dense(act, act, lda, 0, C / 2, weights + d.w_off[L + 3], kHeadWidth,
          biases + d.b_off[L + 3], kToOutput, out, row0, num_points, 0, 3,
          scratch);
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
fused_nerf_ablation_kernel(const float* __restrict__ positions,
                           const float* __restrict__ views,
                           const float* __restrict__ pos_enc,
                           const float* __restrict__ view_enc,
                           const T* __restrict__ weights,
                           const float* __restrict__ biases,
                           float* __restrict__ out, long long num_points,
                           Desc d) {
  ablation_tile<T, kMode>(positions, views, pos_enc, view_enc, weights,
                          biases, out, num_points, d);
}

// bf16-accum holds a second set of accumulators (the running sum and the
// current product). Bounded to two blocks an SM, the occupancy the other
// modes run at, its time is its arithmetic and not fewer resident blocks.
__global__ void __launch_bounds__(kThreads, 2)
fused_nerf_ablation_accum_kernel(const float* __restrict__ positions,
                                 const float* __restrict__ views,
                                 const float* __restrict__ pos_enc,
                                 const float* __restrict__ view_enc,
                                 const __nv_bfloat16* __restrict__ weights,
                                 const float* __restrict__ biases,
                                 float* __restrict__ out,
                                 long long num_points, Desc d) {
  ablation_tile<__nv_bfloat16, kBf16Accum>(positions, views, pos_enc,
                                           view_enc, weights, biases, out,
                                           num_points, d);
}

template <typename T, int kMode>
constexpr auto ablation_kernel() {
  if constexpr (kMode == kBf16Accum) {
    return &fused_nerf_ablation_accum_kernel;
  } else {
    return &fused_nerf_ablation_kernel<T, kMode>;
  }
}

template <typename T, int kMode>
cudaError_t launch(const void* positions, const void* views,
                   const void* pos_enc, const void* view_enc,
                   const void* weights, const void* biases, void* out,
                   long long num_points, const Desc& d, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(d, kMode);
  const auto kernel = ablation_kernel<T, kMode>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (num_points + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          static_cast<const float*>(positions),
          static_cast<const float*>(views),
          static_cast<const float*>(pos_enc),
          static_cast<const float*>(view_enc),
          static_cast<const T*>(weights), static_cast<const float*>(biases),
          static_cast<float*>(out), num_points, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, const void* positions, const void* views,
                        const void* pos_enc, const void* view_enc,
                        const void* weights, const void* biases, void* out,
                        long long num_points, const Desc& d,
                        cudaStream_t stream) {
  switch (mode) {
    case kBase:
      return launch<T, kBase>(positions, views, pos_enc, view_enc, weights,
                              biases, out, num_points, d, stream);
    case kNoView:
      return launch<T, kNoView>(positions, views, pos_enc, view_enc, weights,
                                biases, out, num_points, d, stream);
    case kNoBias:
      return launch<T, kNoBias>(positions, views, pos_enc, view_enc, weights,
                                biases, out, num_points, d, stream);
    case kNoRelu:
      return launch<T, kNoRelu>(positions, views, pos_enc, view_enc, weights,
                                biases, out, num_points, d, stream);
    case kMatmulOnly:
      return launch<T, kMatmulOnly>(positions, views, pos_enc, view_enc,
                                    weights, biases, out, num_points, d,
                                    stream);
    case kBf16Accum:   // bf16 packs only: the tool's weights are bf16
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        return launch<T, kBf16Accum>(positions, views, pos_enc, view_enc,
                                     weights, biases, out, num_points, d,
                                     stream);
      } else {
        return cudaErrorInvalidValue;
      }
    case kNoSincos:
      return launch<T, kNoSincos>(positions, views, pos_enc, view_enc,
                                  weights, biases, out, num_points, d,
                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// mode: the Ablation code (0 base .. 4 matmul-only, 5 bf16-accum with bf16
// weights only, 6 no-sincos). weight_dtype: 0 = f32, 1 = bf16.
extern "C" int fused_nerf_ablation_forward(
    const void* positions, const void* views, const void* pos_enc,
    const void* view_enc, const void* weights, const void* biases,
    const void* meta, void* out, long long num_points, int mode,
    int weight_dtype, void* stream) {
  Desc d;
  if (!ffn::parse_desc(static_cast<const long long*>(meta), &d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_points <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (weight_dtype == 1) {
    err = launch_mode<__nv_bfloat16>(mode, positions, views, pos_enc,
                                     view_enc, weights, biases, out,
                                     num_points, d, s);
  } else if (weight_dtype == 0) {
    err = launch_mode<float>(mode, positions, views, pos_enc, view_enc,
                             weights, biases, out, num_points, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_nerf_ablation_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
