// Fused ray render for Hopper (sm_90a): K3, and T1's lane scan.
//
// Replaces the TPU Pallas kernel fourier_feature_nets_tpu/ops/
// fused_ray_render.py::_kernel, which goes from ray geometry to composited
// color in one pass (K3), and the lane-scan test kernel of
// tests/test_fused_ray_render.py:26 around _exclusive_cumprod_lanes (T1,
// described at its kernel below). K3's inputs are (R, S, 3) sample
// positions, ray-major, (R, 3) view directions and (R, S) depths, all f32,
// and the weights pack of kernels/fused_nerf.py (bf16 or f32): its slab
// image and, for the view rows of the hidden layer, its flat weights. The
// output is (R, 4) f32: the composited RGB and an alpha that excludes the
// absorbing tail sample.
//
// Design. K3 is K1's own kernels (fused_nerf_forward.cuh: the bf16 wgmma
// kernel, the f32 3xTF32 kernel) with K3's policies, RayComposite (the
// comment there says how they work):
// * a consumer warpgroup takes a group of whole rays (the wrapper's
//   kernels/fused_ray_render.py::ray_group: S = 128 one ray, S = 48 four,
//   S = 42 thirty-two), in 64-row pieces, so no ray straddles two
//   warpgroups and the composite carries a ray's transmittance and sums
//   from one piece to the next;
// * per ray, the view product venc . W_hidden[C:C+V] rounded to the working
//   type, as the TPU kernel rounds it (vdot.astype(compute_dtype)); the
//   encoder warps compute it on the CUDA cores once a piece. K1 instead sums
//   the view features into every sample's hidden layer in f32, so in bf16 K3
//   is not K1 followed by compositing;
// * per point, K1's layers with K1's rounding points; the hidden layer reads
//   only the bottleneck and adds its ray's view product before the bias;
// * per piece, the heads' logits stay on chip, and an encoder warp
//   composites them while the consumers go on: softplus(sigma),
//   sigmoid(rgb), deltas t[s+1] - t[s] with 1e10 at the last sample (a
//   compare), alpha = 1 - exp(-sigma delta), transmittance as the exclusive
//   cumulative product of min(1, 1 - alpha + 1e-10), color the sum of w *
//   rgb over all S samples, alpha of w over the first S - 1.
// Device memory sees only the ray geometry in and (R, 4) out.
//
// What bounds it on an H100. The MLP, as in K1: ~1.2 MFLOP a sample at the
// flagship against 16 B of position and depth read; the view products and
// the composite are ~1% of the work. Against K1 followed by the plain
// composite, K3 saves K1's per-point view encode, 32 of the hidden layer's
// 288 input rows and the (N, 4) logits round trip through device memory; it
// pays the view products and the composite on the encoder warps, which
// K1's view encode leaves idle most of a piece, and one more mbarrier
// arrival a piece on the consumers. The TPU kernel's ray-membership matmuls
// (agg/expand), its arithmetic gates and roll-based scan and its pad of R to
// a multiple of its ray tile are not ported: a warpgroup indexes its rays
// directly, compares are cheap here, and the kernel masks the ragged last
// group itself. A small launch takes groups of fewer rays, so that every
// SM gets a pair (kernels/fused_ray_render.py::ray_group).
//
// The kernels launch on the caller's stream and allocate nothing; the entry
// points return cudaGetLastError().

#include <cstdint>

#include "fused_nerf_forward.cuh"

namespace {

constexpr int kMaxSamples = 4096;
constexpr int kMaxGroupRays = 32;

// T1: the exclusive cumulative product along each row of a (rows, lanes) f32
// array, first lane 1. Bound by bytes: at the render batch's (16384, 128) it
// reads 8.4 MB and writes 8.4 MB, 5.0 us at 3.35 TB/s (less when x sits in
// the 50 MB L2), for 2.1 M multiplies. The design keeps memory busy and the
// scan short:
// * one warp a row, eight warps a block, up to 64 warps an SM, so many rows'
//   loads are in flight at once;
// * each lane holds four consecutive values, loaded as one float4: a warp
//   covers 128 lanes of a row with one 512-byte coalesced load, and issues
//   the loads of up to kScanUnroll such passes (512 lanes) before its first
//   scan step;
// * per pass: the lane's product of its four values, one 5-step
//   __shfl_up_sync scan over the 32 lane products, and an exclusive shift;
//   a row longer than 128 lanes carries the product of each pass into the
//   next; results leave as float4 stores;
// * a scalar path (the same scan, four 4-byte loads and stores a lane,
//   masked) takes lane counts that are not a multiple of 4 and bases that
//   are not 16-byte aligned.
// The products are taken in another order than a sequential cumprod: each
// of the two carries at most lanes - 1 roundings of 2^-24 relative error.
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanPass = 128;     // lanes one float4 a lane covers
constexpr int kScanUnroll = 4;     // passes whose loads issue together

// The exclusive products of the four consecutive values v of each lane of a
// full warp, times *carry; *carry is multiplied by the product of all 128.
__device__ __forceinline__ float4 exclusive_cumprod_quad(float4 v,
                                                         float* carry) {
  const int lane = threadIdx.x % 32;
  const float p1 = v.x * v.y;
  const float p2 = p1 * v.z;
  float inclusive = p2 * v.w;
#pragma unroll
  for (int shift = 1; shift < 32; shift <<= 1) {
    const float lower = __shfl_up_sync(0xffffffffu, inclusive, shift);
    if (lane >= shift) inclusive *= lower;
  }
  float before = __shfl_up_sync(0xffffffffu, inclusive, 1);
  if (lane == 0) before = 1.0f;
  const float base = *carry * before;
  *carry *= __shfl_sync(0xffffffffu, inclusive, 31);
  return make_float4(base, base * v.x, base * p1, base * p2);
}

// Lanes i..i+3 of a row; 1 past its end.
template <bool kVector>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ row,
                                            int i, int lanes) {
  if (kVector) {   // lanes % 4 == 0: i < lanes means all four are in
    return i < lanes ? __ldg(reinterpret_cast<const float4*>(row + i))
                     : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  }
  return make_float4(i < lanes ? row[i] : 1.0f,
                     i + 1 < lanes ? row[i + 1] : 1.0f,
                     i + 2 < lanes ? row[i + 2] : 1.0f,
                     i + 3 < lanes ? row[i + 3] : 1.0f);
}

template <bool kVector>
__device__ __forceinline__ void store_quad(float* __restrict__ row, int i,
                                           int lanes, float4 v) {
  if (kVector) {
    if (i < lanes) *reinterpret_cast<float4*>(row + i) = v;
    return;
  }
  if (i < lanes) row[i] = v.x;
  if (i + 1 < lanes) row[i + 1] = v.y;
  if (i + 2 < lanes) row[i + 2] = v.z;
  if (i + 3 < lanes) row[i + 3] = v.w;
}

template <bool kVector>
__global__ void __launch_bounds__(kScanThreads)
exclusive_cumprod_kernel(const float* __restrict__ x, float* __restrict__ out,
                         long long rows, int lanes) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kScanWarps + threadIdx.x / 32;
  if (row >= rows) return;   // the whole warp leaves together
  const int quad = (threadIdx.x % 32) * 4;
  const float* in_row = x + row * lanes;
  float* out_row = out + row * lanes;
  float carry = 1.0f;
  for (int c0 = 0; c0 < lanes; c0 += kScanPass * kScanUnroll) {
    float4 v[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      v[u] = load_quad<kVector>(in_row, c0 + u * kScanPass + quad, lanes);
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int c = c0 + u * kScanPass;
      if (c >= lanes) break;   // the same for the whole warp
      store_quad<kVector>(out_row, c + quad, lanes,
                          exclusive_cumprod_quad(v[u], &carry));
    }
  }
}

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// weight_dtype: 0 = f32, `slabs` the f32 slab image of kernels/
// fused_nerf.py::f32_slab_image; 1 = bf16, `slabs` the slab image of
// kernels/fused_nerf.py::slab_image; `weights` the pack's flat weights of
// that type. 2 <= num_samples <= 4096; group_rays in [1, 32] with
// group_rays * num_samples <= 4096. logits (f32 only; bf16 keeps them in
// shared memory): scratch of 2 KB (128 float4) for each of the device's
// multiprocessors, one block's.
extern "C" int fused_ray_render(const void* positions, const void* views,
                                const void* t_values, const void* pos_enc,
                                const void* view_enc, const void* slabs,
                                const void* weights, const void* biases,
                                const void* meta, void* logits, void* out,
                                long long num_rays, int num_samples,
                                int group_rays, int weight_dtype,
                                void* stream) {
  Desc d;
  if (!ffn::parse_desc(static_cast<const long long*>(meta), &d)
      || num_samples < 2 || num_samples > kMaxSamples || group_rays < 1
      || group_rays > kMaxGroupRays
      || group_rays * num_samples > kMaxSamples
      || (weight_dtype != 0 && weight_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rays <= 0) return static_cast<int>(cudaSuccess);
  const int C = d.channels;
  const long long view_rows = d.w_off[d.num_layers + 2]
                              + static_cast<long long>(C) * (C / 2);
  RayComposite rays{};
  rays.t_values = static_cast<const float*>(t_values);
  rays.view_rows = static_cast<const char*>(weights)
                   + view_rows * (weight_dtype == 1 ? 2 : 4);
  rays.num_rays = num_rays;
  rays.samples = num_samples;
  rays.group_rays = group_rays;
  rays.group_points = group_rays * num_samples;
  rays.pieces = (rays.group_points + kWgRows - 1) / kWgRows;
  const int spanned = (kWgRows - 1) / num_samples + 2;
  rays.piece_rays = spanned < group_rays ? spanned : group_rays;
  rays.tiles = ((num_rays + group_rays - 1) / group_rays + 1) / 2;
  rays.logits = static_cast<float4*>(logits);
  return static_cast<int>(launch_forward<kBase>(
      positions, views, pos_enc, view_enc, slabs, biases, out,
      num_rays * num_samples, d, weight_dtype,
      static_cast<cudaStream_t>(stream), rays));
}

// x and out: (rows, lanes) f32, row-major.
extern "C" int exclusive_cumprod_scan(const void* x, void* out,
                                      long long rows, int lanes,
                                      void* stream) {
  if (lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks =
      static_cast<unsigned>((rows + kScanWarps - 1) / kScanWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vector = lanes % 4 == 0
                      && reinterpret_cast<std::uintptr_t>(x) % 16 == 0
                      && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  if (vector) {
    exclusive_cumprod_kernel<true><<<blocks, kScanThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, lanes);
  } else {
    exclusive_cumprod_kernel<false><<<blocks, kScanThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_ray_render_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
