// Fused ray render for Hopper (sm_90a): K3, and T1's lane scan.
//
// Replaces the TPU Pallas kernel fourier_feature_nets_tpu/ops/
// fused_ray_render.py::_kernel, which goes from ray geometry to composited
// color in one pass (K3), and the lane-scan test kernel of
// tests/test_fused_ray_render.py:26 around _exclusive_cumprod_lanes (T1,
// described at its kernel below). K3's inputs
// are (R, S, 3) sample positions, ray-major, (R, 3) view directions and
// (R, S) depths, all f32, and the weights pack of kernels/fused_nerf.py
// (bf16 or f32); the output is (R, 4) f32: the composited RGB and an alpha
// that excludes the absorbing tail sample.
//
// Design. A block owns rays_per_block whole rays (chosen by the wrapper so
// that its rays' samples fill whole 64-point tiles where they can).
// 1. Per ray: the view encode and the view product venc . W_hidden[C:C+V],
//    run as one dense layer over the rays and rounded to the working type,
//    as the TPU kernel rounds it (vdot.astype(compute_dtype)). K1 instead
//    sums the view features into every sample's hidden layer in f32, so in
//    bf16 K3 is not K1 followed by compositing.
// 2. Per point: the 64-point tile code of K1's f32 path (ffn::encode,
//    ffn::dense in fused_nerf_common.cuh; in bf16 the WMMA tile K1 ran
//    before its wgmma redesign) over the block's rays_per_block * S points, with
//    the same rounding points; the hidden layer reads only the bottleneck
//    and adds its ray's view product before the bias. Each sample's four
//    logits stay in shared memory (16 B a sample).
// 3. Per ray, one warp: softplus(sigma), sigmoid(rgb), deltas t[s+1] - t[s]
//    with 1e10 at the last sample (a compare), alpha = 1 - exp(-sigma delta),
//    transmittance as the exclusive cumulative product of
//    min(1, 1 - alpha + 1e-10), scanned with __shfl_up_sync over chunks of 32
//    samples with a carried product (exclusive_cumprod_chunk); color sums
//    w * rgb over all S samples, alpha sums w over the first S - 1.
// Device memory sees only the ray geometry in and (R, 4) out.
//
// What bounds it on an H100. The MLP, as in K1: ~0.6 MFLOP per sample at
// the flagship against 16 B of position and 4 B of depth read; the view
// branch and the compositing are ~1% of the work. Per sample, K3 saves K1's
// view encode, 32 of the hidden layer's 288 input rows and the (N, 4) logits
// round trip through device memory; it pays one block barrier per ray
// block for the view product and a composite whose warps idle while they
// wait for a block's last tile. The TPU kernel's ray-membership matmuls
// (agg/expand), its arithmetic gates and roll-based scan and its pad of R
// to a multiple of its ray tile are not ported: a block indexes its rays
// directly, compares are cheap here, and the kernel masks the ragged last
// ray block itself. wgmma, TMA and tuning are later work.
//
// The kernels launch on the caller's stream and allocate nothing; the entry
// points return cudaGetLastError().

#include <cstdint>

#include "fused_nerf_common.cuh"
#include "shared_limit.cuh"

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
using ffn::kWarps;

constexpr int kMaxRaysPerBlock = 32;
constexpr int kMaxBlockPoints = 4096;   // 64 KB of logits

// K3's scan: one chunk of an exclusive cumulative product, one value per
// lane of a full warp. Returns carry times the product of the lower lanes' values and
// multiplies carry by the product of all 32; a lane past the end of the
// row passes 1.
__device__ __forceinline__ float exclusive_cumprod_chunk(float x,
                                                         float* carry) {
  const int lane = threadIdx.x % 32;
  float inclusive = x;
#pragma unroll
  for (int shift = 1; shift < 32; shift <<= 1) {
    const float lower = __shfl_up_sync(0xffffffffu, inclusive, shift);
    if (lane >= shift) inclusive *= lower;
  }
  float exclusive = __shfl_up_sync(0xffffffffu, inclusive, 1);
  if (lane == 0) exclusive = 1.0f;
  const float result = *carry * exclusive;
  *carry *= __shfl_sync(0xffffffffu, inclusive, 31);
  return result;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int mask = 16; mask > 0; mask >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, mask);
  }
  return v;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
size_t shared_bytes(const Desc& d, int rays_per_block, int num_samples) {
  const int region = d.pos_width > d.view_width ? d.pos_width : d.view_width;
  const size_t lda = d.channels + region + kRowPad;
  return kScratchFloats * sizeof(float) + kTile * lda * sizeof(T)
         + static_cast<size_t>(rays_per_block) * num_samples * 4
               * sizeof(float)
         + kTile * 3 * sizeof(float) + kTile * sizeof(int)
         + static_cast<size_t>(rays_per_block) * (d.channels / 2) * sizeof(T);
}

// Two blocks per SM, as K1 gets: the cap keeps each thread at 128 registers
// (the f32 instantiation takes 149 without it and runs one block per SM).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_ray_render_kernel(const float* __restrict__ positions,
                        const float* __restrict__ views,
                        const float* __restrict__ t_values,
                        const float* __restrict__ pos_enc,
                        const float* __restrict__ view_enc,
                        const T* __restrict__ weights,
                        const float* __restrict__ biases,
                        float* __restrict__ out, long long num_rays,
                        int num_samples, int rays_per_block, Desc d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = d.channels;
  const int hidden = C / 2;
  const int region = d.pos_width > d.view_width ? d.pos_width : d.view_width;
  const int lda = C + region + kRowPad;
  float* scratch = reinterpret_cast<float*>(smem);
  T* act = reinterpret_cast<T*>(smem + kScratchFloats * sizeof(float));
  float* logits = reinterpret_cast<float*>(act + kTile * lda);
  float* xs = logits + rays_per_block * num_samples * 4;
  int* row_ray = reinterpret_cast<int*>(xs + kTile * 3);
  T* ray_view = reinterpret_cast<T*>(row_ray + kTile);

  const long long ray0 = static_cast<long long>(blockIdx.x) * rays_per_block;
  const int rays = static_cast<int>(
      num_rays - ray0 < rays_per_block ? num_rays - ray0 : rays_per_block);
  const int points = rays * num_samples;
  const int L = d.num_layers;
  const T* w_hidden = weights + d.w_off[L + 2];

  // 1. per ray: view features into act[:, C : C + V] (rows past the block's
  // rays encode a zero view and are never read), then the view product,
  // rounded to T, into act[:, 0 : C / 2], kept in ray_view
  for (int idx = threadIdx.x; idx < kTile * 3; idx += kThreads) {
    xs[idx] = idx / 3 < rays ? views[ray0 * 3 + idx] : 0.0f;
  }
  __syncthreads();
  ffn::encode<kTile, kThreads, T>(xs, view_enc, d.e_view, d.include_inputs,
                                  d.view_width, act, lda, C);
  __syncthreads();
  dense(act, act, lda, C, d.view_width,
        w_hidden + static_cast<long long>(C) * hidden, hidden, nullptr,
        kCast, nullptr, 0, 0, 0, 0, scratch, ffn::NoBias());
  for (int idx = threadIdx.x; idx < rays * hidden; idx += kThreads) {
    const int r = idx / hidden;
    ray_view[idx] = act[r * lda + idx - r * hidden];
  }
  __syncthreads();

  // 2. per point: K1's tile over the block's points, logits to shared
  const float* block_positions = positions + ray0 * num_samples * 3;
  const ffn::AddRowThenBias<T> view_term = {ray_view, row_ray, hidden};
  for (int p0 = 0; p0 < points; p0 += kTile) {
    for (int idx = threadIdx.x; idx < kTile * 3; idx += kThreads) {
      xs[idx] = p0 + idx / 3 < points ? block_positions[p0 * 3 + idx] : 0.0f;
    }
    if (threadIdx.x < kTile) {
      const int p = p0 + threadIdx.x < points ? p0 + threadIdx.x : points - 1;
      row_ray[threadIdx.x] = p / num_samples;
    }
    __syncthreads();
    ffn::encode<kTile, kThreads, T>(xs, pos_enc, d.e_pos, d.include_inputs,
                                    d.pos_width, act, lda, C);
    __syncthreads();
    dense(act, act, lda, C, d.pos_width, weights + d.w_off[0], C,
          biases + d.b_off[0], kReluCast, logits, p0, points, 0, 0, scratch);
    for (int i = 1; i < L; ++i) {
      const int K = ((d.skip_mask >> i) & 1u) ? C + d.pos_width : C;
      dense(act, act, lda, 0, K, weights + d.w_off[i], C, biases + d.b_off[i],
            kReluCast, logits, p0, points, 0, 0, scratch);
    }
    // opacity head -> logits[:, 3]
    dense(act, act, lda, 0, C, weights + d.w_off[L], kHeadWidth,
          biases + d.b_off[L], kToOutput, logits, p0, points, 3, 1, scratch);
    // bottleneck, cast to the weight type
    dense(act, act, lda, 0, C, weights + d.w_off[L + 1], C,
          biases + d.b_off[L + 1], kCast, logits, p0, points, 0, 0, scratch);
    // hidden layer: bottleneck . W_hidden[:C] + the ray's view product + b
    dense(act, act, lda, 0, C, w_hidden, hidden, biases + d.b_off[L + 2],
          kReluCast, logits, p0, points, 0, 0, scratch, view_term);
    // color head -> logits[:, 0:3]
    dense(act, act, lda, 0, hidden, weights + d.w_off[L + 3], kHeadWidth,
          biases + d.b_off[L + 3], kToOutput, logits, p0, points, 0, 3,
          scratch);
  }

  // 3. per ray, one warp: composite (dense ended with a block barrier)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rays; r += kWarps) {
    const float* t = t_values + (ray0 + r) * num_samples;
    const float4* ray_logits =
        reinterpret_cast<const float4*>(logits) + r * num_samples;
    float carry = 1.0f;
    float red = 0.0f, green = 0.0f, blue = 0.0f, alpha = 0.0f;
    for (int s0 = 0; s0 < num_samples; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < num_samples;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float a = 0.0f;
      if (live) {
        v = ray_logits[s];
        const float delta = s == num_samples - 1 ? 1e10f : t[s + 1] - t[s];
        a = 1.0f - expf(-softplus(v.w) * delta);
      }
      const float trans =
          exclusive_cumprod_chunk(fminf(1.0f, 1.0f - a + 1e-10f), &carry);
      if (live) {
        const float w = a * trans;
        red += w * sigmoid(v.x);
        green += w * sigmoid(v.y);
        blue += w * sigmoid(v.z);
        if (s < num_samples - 1) alpha += w;
      }
    }
    red = warp_sum(red);
    green = warp_sum(green);
    blue = warp_sum(blue);
    alpha = warp_sum(alpha);
    if (lane == 0) {
      float4* o = reinterpret_cast<float4*>(out) + ray0 + r;
      *o = make_float4(red, green, blue, alpha);
    }
  }
}

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

template <typename T>
cudaError_t launch(const void* positions, const void* views,
                   const void* t_values, const void* pos_enc,
                   const void* view_enc, const void* weights,
                   const void* biases, void* out, long long num_rays,
                   int num_samples, int rays_per_block, const Desc& d,
                   cudaStream_t stream) {
  static ffn::SharedLimit limit;
  const size_t smem = shared_bytes<T>(d, rays_per_block, num_samples);
  const cudaError_t err =
      ffn::reserve_shared(fused_ray_render_kernel<T>, smem, limit);
  if (err != cudaSuccess) return err;
  const long long blocks = (num_rays + rays_per_block - 1) / rays_per_block;
  fused_ray_render_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(views),
      static_cast<const float*>(t_values), static_cast<const float*>(pos_enc),
      static_cast<const float*>(view_enc), static_cast<const T*>(weights),
      static_cast<const float*>(biases), static_cast<float*>(out), num_rays,
      num_samples, rays_per_block, d);
  return cudaGetLastError();
}

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// weight_dtype: 0 = f32, 1 = bf16. rays_per_block in [1, 32] with
// rays_per_block * num_samples <= 4096; num_samples >= 2.
extern "C" int fused_ray_render(const void* positions, const void* views,
                                const void* t_values, const void* pos_enc,
                                const void* view_enc, const void* weights,
                                const void* biases, const void* meta,
                                void* out, long long num_rays,
                                int num_samples, int rays_per_block,
                                int weight_dtype, void* stream) {
  Desc d;
  if (!ffn::parse_desc(static_cast<const long long*>(meta), &d)
      || num_samples < 2 || rays_per_block < 1
      || rays_per_block > kMaxRaysPerBlock
      || rays_per_block * num_samples > kMaxBlockPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_rays <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (weight_dtype == 1) {
    err = launch<__nv_bfloat16>(positions, views, t_values, pos_enc, view_enc,
                                weights, biases, out, num_rays, num_samples,
                                rays_per_block, d, s);
  } else if (weight_dtype == 0) {
    err = launch<float>(positions, views, t_values, pos_enc, view_enc,
                        weights, biases, out, num_rays, num_samples,
                        rays_per_block, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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
