// Fused NeRF forward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels fourier_feature_nets_tpu/ops/fused_nerf.py
// ::_kernel (row-major) and ops/fused_nerf_fm.py::_kernel_fm (feature-major,
// a TPU lane-layout twin of the same function). Per point it computes the
// positional encode (phases as three f32 FMAs, sin/cos with the explicit
// range reduction and Taylor tails of _fast_sincos), the ReLU skip-MLP body,
// the opacity head, the bottleneck, the view encode, the half-width hidden
// layer and the color head, and writes (N, 4) f32 logits [r, g, b, opacity].
//
// What bounds it on an H100. The TPU kernel keeps every weight resident in
// VMEM (~1.2 MB bf16 for the 8x256 flagship). A block has at most 227 KB of
// shared memory, so here only the activations stay on chip: one block takes
// a tile of kTile points, keeps the tile's activation rows and encoded
// features in shared memory for the whole network, and walks the layers,
// reading each layer's weights from global memory, where the 1.2 MB pack
// stays resident in the 50 MB L2. Each block re-reads the whole weight pack
// from L2 once: ~16 KB per point against ~1.2 MFLOP per point. On an H100
// the bf16 path runs at ~112 TFLOP/s, ~11% of the dense tensor-core peak,
// while moving ~1.5 TB/s from L2, below what L2 sustains; prefetching the
// next weight fragments made it slower, so neither L2 bandwidth nor load
// latency binds first. What remains is the issue side: WMMA (mma.sync)
// instead of wgmma, and a per-layer epilogue that round-trips every output
// through shared memory between two block barriers. This first version is
// the simple, right one: a register epilogue with known fragment layouts,
// larger tiles, TMA weight staging and wgmma are the levers of later work.
//
// Layout. Activation rows are [h (C) | features (R)], R = max(P, V): P is the
// positional encode width [cos E | sin E | raw 3 | zero pad] rounded up to 16,
// V the same for the view encode. The skip layers read [h | pos features] and
// the hidden layer reads [bottleneck | view features] as ONE contiguous K
// range (the TPU kernel's split matmuls were a relayout workaround). Weights
// arrive packed (in, out) row-major with K padded to the features' padded
// width and the two heads padded to 16 output columns, the MMA tile width.
//
// Types. bf16 weights use tensor-core WMMA 16x16x16 with f32 accumulation
// and round where the TPU kernel rounds: each body layer's f32 sum + bias is
// cast to bf16 and then ReLU'd, the bottleneck is cast, the hidden layer is
// ReLU'd and then cast. f32 weights use exact f32 FFMA on the CUDA cores,
// with weight rows staged through shared memory in chunks of kStageK.
//
// The tile code (finish, the two dense overloads) lives in
// fused_nerf_common.cuh, which the fused ray render (K3) shares. The kernel
// masks the ragged last tile itself, launches on the caller's stream and
// allocates nothing; the entry point returns cudaGetLastError().

#include "fused_nerf_common.cuh"

namespace {

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

template <typename T>
size_t shared_bytes(const Desc& d) {
  const int region = d.pos_width > d.view_width ? d.pos_width : d.view_width;
  const size_t lda = d.channels + region + kRowPad;
  return kScratchFloats * sizeof(float) + kTile * lda * sizeof(T)
         + 2 * kTile * 3 * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_nerf_kernel(const float* __restrict__ positions,
                  const float* __restrict__ views,
                  const float* __restrict__ pos_enc,
                  const float* __restrict__ view_enc,
                  const T* __restrict__ weights,
                  const float* __restrict__ biases, float* __restrict__ out,
                  long long num_points, Desc d) {
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
  dense(act, act, lda, C, d.pos_width, weights + d.w_off[0], C,
        biases + d.b_off[0], kReluCast, out, row0, num_points, 0, 0, scratch);
  for (int i = 1; i < L; ++i) {
    const int K = ((d.skip_mask >> i) & 1u) ? C + d.pos_width : C;
    dense(act, act, lda, 0, K, weights + d.w_off[i], C, biases + d.b_off[i],
          kReluCast, out, row0, num_points, 0, 0, scratch);
  }
  // opacity head -> out[:, 3]
  dense(act, act, lda, 0, C, weights + d.w_off[L], kHeadWidth,
        biases + d.b_off[L], kToOutput, out, row0, num_points, 3, 1, scratch);
  // bottleneck, cast to the weight type
  dense(act, act, lda, 0, C, weights + d.w_off[L + 1], C,
        biases + d.b_off[L + 1], kCast, out, row0, num_points, 0, 0, scratch);
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

template <typename T>
cudaError_t launch(const void* positions, const void* views,
                   const void* pos_enc, const void* view_enc,
                   const void* weights, const void* biases, void* out,
                   long long num_points, const Desc& d, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (num_points + kTile - 1) / kTile;
  fused_nerf_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(views),
      static_cast<const float*>(pos_enc), static_cast<const float*>(view_enc),
      static_cast<const T*>(weights), static_cast<const float*>(biases),
      static_cast<float*>(out), num_points, d);
  return cudaGetLastError();
}

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// weight_dtype: 0 = f32, 1 = bf16.
extern "C" int fused_nerf_forward(const void* positions, const void* views,
                                  const void* pos_enc, const void* view_enc,
                                  const void* weights, const void* biases,
                                  const void* meta, void* out,
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
                                biases, out, num_points, d, s);
  } else if (weight_dtype == 0) {
    err = launch<float>(positions, views, pos_enc, view_enc, weights, biases,
                        out, num_points, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
