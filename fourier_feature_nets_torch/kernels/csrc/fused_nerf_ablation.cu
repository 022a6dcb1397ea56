// The fused NeRF forward's ablations for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel of tools/kernel_ablation_bench.py::main
// (make_kernel(mode), pallas_call :154): a copy of the fused NeRF forward
// (ops/fused_nerf.py::_kernel) in which one part of the work is taken out,
// to see what each part costs. The modes, as that tool runs them:
//   base         the forward unchanged (K1's function);
//   no-view      no bottleneck, view encode, hidden layer or color head:
//                color = opacity * 0 + color bias on every row;
//   no-bias      the body layers add no bias;
//   no-relu      the body layers are cast without a ReLU;
//   matmul-only  both of the last two.
// As in the tool, the modes touch only the body layers: the heads keep their
// bias and the hidden layer its ReLU. (The tool's bf16-accum and no-sincos
// modes are defined there but never run, and are not ported.)
//
// What bounds it on an H100: what bounds K1 (fused_nerf.cu): ~1.2 MFLOP per
// point on the tensor cores from WMMA, with each 64-point tile re-reading
// the ~1.2 MB weight pack from L2 and a per-layer epilogue through shared
// memory between two block barriers. Its design is K1's, from the same tile
// code (fused_nerf_common.cuh, untouched), with the mode a template
// parameter: a runtime branch in the per-layer epilogue cost K1 ~1.5% (H100
// 80GB HBM3 at 700 W), so each mode is its own instantiation. no-bias is the NoBias epilogue policy,
// no-relu is the kCast finish in place of kReluCast, and no-view skips the
// dead code. The kernel masks the ragged last tile, launches on the
// caller's stream and allocates nothing; the entry point returns
// cudaGetLastError().

#include "fused_nerf_common.cuh"

namespace {

using ffn::AddBias;
using ffn::dense;
using ffn::Desc;
using ffn::kCast;
using ffn::kHeadWidth;
using ffn::kReluCast;
using ffn::kRowPad;
using ffn::kScratchFloats;
using ffn::kThreads;
using ffn::kTile;
using ffn::kToOutput;
using ffn::NoBias;

enum Ablation { kBase = 0, kNoView = 1, kNoBias = 2, kNoRelu = 3,
                kMatmulOnly = 4 };

template <int kMode>
struct Body {   // how a body layer finishes its f32 sum
  static constexpr bool kBias = kMode != kNoBias && kMode != kMatmulOnly;
  static constexpr int kFinish =
      (kMode == kNoRelu || kMode == kMatmulOnly) ? kCast : kReluCast;
};

template <typename T>
size_t shared_bytes(const Desc& d) {
  const int region = d.pos_width > d.view_width ? d.pos_width : d.view_width;
  const size_t lda = d.channels + region + kRowPad;
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
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = d.channels;
  const int region = d.pos_width > d.view_width ? d.pos_width : d.view_width;
  const int lda = C + region + kRowPad;
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
  ffn::encode<kTile, kThreads, T>(xs, pos_enc, d.e_pos, d.include_inputs,
                                  d.pos_width, act, lda, C);
  __syncthreads();

  const int L = d.num_layers;
  body_layer<kMode>(act, act, lda, C, d.pos_width, weights + d.w_off[0], C,
                    biases + d.b_off[0], out, row0, num_points, scratch);
  for (int i = 1; i < L; ++i) {
    const int K = ((d.skip_mask >> i) & 1u) ? C + d.pos_width : C;
    body_layer<kMode>(act, act, lda, 0, K, weights + d.w_off[i], C,
                      biases + d.b_off[i], out, row0, num_points, scratch);
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
cudaError_t launch(const void* positions, const void* views,
                   const void* pos_enc, const void* view_enc,
                   const void* weights, const void* biases, void* out,
                   long long num_points, const Desc& d, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_ablation_kernel<T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (num_points + kTile - 1) / kTile;
  fused_nerf_ablation_kernel<T, kMode>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
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
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// mode: the Ablation code (0 base .. 4 matmul-only). weight_dtype: 0 = f32,
// 1 = bf16.
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
