// The fused NeRF forward's ablations for Hopper (sm_90a): K1's own kernels
// with one part of the work taken out or changed.
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
//                preferred_element_type=bf16, :51-52, :54-57), bf16 packs
//                only;
//   no-sincos    the position encode is [phase | phase * 0.5 | raw]
//                (:68-71): it bounds what the sin/cos cost.
// As in the tool, the modes touch only the body layers and the position
// encode: the heads keep their bias and the hidden layer its ReLU, and the
// view encode keeps its sin/cos. The tool's run times the first five
// (:174); the last two are defined there and run here too.
//
// What it runs and what it measures. Each mode is an instantiation of K1's
// kernels (fused_nerf_forward.cuh): in bf16 the persistent, warp-specialised
// wgmma kernel, in f32 the 3xTF32 kernel, both over 128-point tiles, with
// the mode a compile-time policy. base is K1's own instantiation, so it is
// K1 bit for bit and takes K1's time, and each other mode's time minus
// base's is the share of K1's time that its part costs: the split of the
// kernel the serving and training paths run. What bounds it is what bounds
// K1 (fused_nerf.cu): the products, ~1.2 MFLOP a point at the flagship.
//
// Where bf16-accum rounds. Hopper's bf16 products accumulate only in f32, so
// the kernel rounds its f32 sums to bf16 where the tool's bf16 dots and adds
// round (:78-82, :87-93, :101-106):
//   1. each product over one input part (layer 0: cos, sin, raw; a skip
//      layer: those and h; a middle layer: h) is its f32 wgmma sum, rounded;
//   2. the parts are added in bf16 in the tool's order, one rounding an
//      add: layer 0 ((cos + sin) + raw), a skip layer h + ((cos + sin) +
//      raw);
//   3. the bias, rounded to bf16, is added in bf16; then the ReLU.
// For that its slab image (kernels/fused_nerf_ablation.py::
// accum_slab_image) and its activation rows give each part its own run of
// 16-aligned rows and columns (fused_nerf_forward.cuh, AccumParts); the
// kernel launches on the caller's stream, masks the ragged last tile and
// allocates nothing; the entry point returns cudaGetLastError().

#include "fused_nerf_forward.cuh"

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// mode: the Ablation code (0 base .. 4 matmul-only, 5 bf16-accum with bf16
// weights only, 6 no-sincos). weight_dtype: 0 = f32, `weights` the f32 slab
// image of kernels/fused_nerf.py::f32_slab_image; 1 = bf16, `weights` the
// slab image of kernels/fused_nerf.py::slab_image, or in bf16-accum
// kernels/fused_nerf_ablation.py::accum_slab_image.
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
  switch (mode) {
#define FFN_MODE_CASE(M)                                                     \
  case M:                                                                    \
    err = launch_forward<M>(positions, views, pos_enc, view_enc, weights,    \
                            biases, out, num_points, d, weight_dtype, s);    \
    break;
    FFN_MODE_CASE(kBase)
    FFN_MODE_CASE(kNoView)
    FFN_MODE_CASE(kNoBias)
    FFN_MODE_CASE(kNoRelu)
    FFN_MODE_CASE(kMatmulOnly)
    FFN_MODE_CASE(kBf16Accum)
    FFN_MODE_CASE(kNoSincos)
#undef FFN_MODE_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory a bf16 launch in `mode` takes for the model of
// `meta` (0 if it does not fit), in *bytes: its two warpgroups' activation
// rows ([h | position encode (bf16-accum: its runs) | view encode]), the
// weight ring and the barriers. Launches nothing.
extern "C" int fused_nerf_ablation_shared_bytes(const void* meta, int mode,
                                                long long* bytes, void*) {
  Desc d;
  if (!ffn::parse_desc(static_cast<const long long*>(meta), &d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int stages = 0, act_blocks = 0;
  *bytes = static_cast<long long>(
      bf16_shared_bytes(d, mode, &stages, &act_blocks));
  return static_cast<int>(cudaSuccess);
}

extern "C" const char* fused_nerf_ablation_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
