// Fused NeRF forward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels fourier_feature_nets_tpu/ops/fused_nerf.py
// ::_kernel (row-major) and ops/fused_nerf_fm.py::_kernel_fm (feature-major,
// a TPU lane-layout twin of the same function). Per point it computes the
// positional encode (phases as three f32 FMAs, sin/cos with the explicit
// range reduction and Taylor tails of _fast_sincos), the ReLU skip-MLP body,
// the opacity head, the bottleneck, the view encode, the half-width hidden
// layer and the color head, and writes (N, 4) f32 logits [r, g, b, opacity].
// Both weight types round where the TPU kernel rounds: each body layer's f32
// sum + bias is cast to the weight type and then ReLU'd, the bottleneck is
// cast, the hidden layer is ReLU'd and then cast, the heads stay f32.
//
// What bounds it on an H100. ~1.2 MFLOP a point against 40 bytes of input
// and output: the products bound it (0.94 ms for 786,432 points in bf16).
// The TPU kernel keeps every weight resident in VMEM (~1.2 MB bf16 for the
// 8x256 flagship); a block has at most 227 KB of shared memory, so here the
// weights stream from the 50 MB L2 and only a tile's activations stay on
// chip. A first bf16 design (WMMA mma.sync over 64-point tiles, eight warps,
// weights read from L2 by every warp, a shared-memory epilogue between two
// block barriers per layer) ran at ~11% of the dense peak and was bound by
// its issue side, not by L2 or latency.
//
// bf16: fused_nerf_bf16_kernel, a persistent, warp-specialised wgmma kernel
// (its tile's routines, shared with K2, are in fused_nerf_wgmma.cuh).
// * One block per SM walks tiles of 128 points (tile += gridDim.x). Two
//   consumer warpgroups own 64 rows each. In the producer warpgroup one warp
//   only issues copies and three warps encode. setmaxnreg gives the
//   consumers 208 registers (a 64x256 f32 accumulator is 128 a thread) and
//   the producer warpgroup 88.
// * Weights arrive as slabs: 64 K-rows of one layer's (K, N) weight, stored
//   N-major (W^T) in the 128-byte swizzled K-major layout of hopper.cuh, so
//   that a slab is one contiguous run of N * 128 bytes. The Python pack
//   (kernels/fused_nerf.py::slab_image) writes every layer's slabs in the
//   order the kernel consumes them; the producer streams them with bulk
//   asynchronous copies (cp.async.bulk, the copy engine behind TMA) through
//   a ring of 2-8 stages of C * 128 bytes with full/empty mbarriers. Both
//   warpgroups read every stage, so a tile reads the pack from L2 once for
//   128 points: 9.4 KB a point at the flagship, half the WMMA tile's share.
//   The whole K range of a layer is one chain of m64nNk16 wgmmas; the stage
//   before the newest is released once wgmma.wait_group 1 says its products
//   are done, so the tensor cores never wait on a release.
// * Activations stay in shared memory in the same swizzled layout, read by
//   wgmma's A descriptor: per warpgroup, 64 rows of [h (C) | pos features (P)
//   | view features (V)] in 64-column blocks of 8 KB. The skip layers read
//   [h | pos] as one K range; the hidden layer reads [bottleneck | view],
//   its K steps past C shifted by P. A K step is 16 columns, so widths that
//   are multiples of 16 (32, 96, 288, ...) need no padding: a block's unused
//   columns are never read.
// * The epilogue works on the accumulator fragment in registers: bias, cast,
//   ReLU on bf16 pairs, then stmatrix stores four 8x8 tiles at a time
//   straight into the swizzled rows of h, in place (the layer's products
//   have completed). Each warpgroup owns its rows, so between layers it
//   needs only fence.proxy.async and a named barrier over its 128 threads,
//   never a block barrier. The heads keep their logits in registers and one
//   float4 a point goes to `out`, masked for the ragged last tile.
// * The encode runs beside the products: the three encoder warps write the
//   next tile's [cos | sin | raw | zeros] features (ffn::fast_sincos, lane e
//   on phase e) into a consumer warpgroup's rows once it has read this
//   tile's (positions after the body, views after the hidden layer), and
//   mbarriers hand them over; on the consumers it ran between tiles with
//   no product in flight.
// Both warpgroups run their epilogues at once, because they share the ring;
// staggering them needs a ring that holds a layer longer than 227 KB allows.
// wgmma sums a layer's products in another order than the twin's f32 GEMM,
// so a near-zero pre-activation may take the other side of a ReLU in each
// (PERF.md, ROADMAP.md section 3). K2's bf16 recompute runs this kernel's
// routines (fused_nerf_wgmma.cuh) on the same slab image: its forward is
// this one, bit for bit.
//
// f32: exact f32 FFMA on the CUDA cores over 64-point tiles (the tile code in
// fused_nerf_common.cuh), weight rows staged through shared memory in chunks
// of kStageK.
//
// Layout of the f32 tile. Activation rows are [h (C) | features (R)], R =
// max(P, V): P is the positional encode width [cos E | sin E | raw 3 | zero
// pad] rounded up to 16, V the same for the view encode; the view encode
// overwrites the positional features after the bottleneck. Weights arrive
// packed (in, out) row-major with K padded to the features' padded width and
// the two heads padded to 16 output columns.
//
// Both kernels mask the ragged last tile themselves, launch on the caller's
// stream and allocate nothing; the entry point returns cudaGetLastError().

#include "fused_nerf_common.cuh"
#include "fused_nerf_wgmma.cuh"
#include "hopper.cuh"
#include "shared_limit.cuh"

namespace {

using ffn::Desc;
using ffn::kHeadWidth;
using namespace ffn::wgmma;

// ---------------------------------------------------------------------------
// bf16: the wgmma kernel (the tile's routines are in fused_nerf_wgmma.cuh)
// ---------------------------------------------------------------------------

// full and empty per stage; per consumer warpgroup, ready and free for its
// positional and its view features
constexpr int kBarrierBytes = (2 * kMaxStages + 8) * 8;

template <int C>
__global__ void __launch_bounds__(kBf16Threads, 1)
fused_nerf_bf16_kernel(const float* __restrict__ positions,
                       const float* __restrict__ views,
                       const float* __restrict__ pos_enc,
                       const float* __restrict__ view_enc,
                       const __nv_bfloat16* __restrict__ slabs,
                       const float* __restrict__ biases,
                       float* __restrict__ out, long long num_points, Desc d,
                       int stages, int act_blocks) {
  extern __shared__ __align__(1024) unsigned char bf16_smem[];
  const uint32_t base = (hopper::smem_addr(bf16_smem) + kAlignSlack - 1)
                        & ~static_cast<uint32_t>(kAlignSlack - 1);
  const uint32_t act_bytes = act_blocks * kBlockBytes;   // one warpgroup's
  const uint32_t ring_base = base + 2 * act_bytes;
  const uint32_t stage_bytes = C * 128;
  const uint32_t full = ring_base + stages * stage_bytes;
  const uint32_t empty = full + 8 * kMaxStages;
  // [warpgroup]: features written, features read (for the next tile)
  const uint32_t pos_ready = empty + 8 * kMaxStages;
  const uint32_t pos_free = pos_ready + 16;
  const uint32_t view_ready = pos_free + 16;
  const uint32_t view_free = view_ready + 16;
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
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const long long num_tiles = (num_points + kTileRows - 1) / kTileRows;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: one thread streams every tile's slab sequence.
    hopper::regs_decrease<kProducerRegs>();
    if (threadIdx.x == 256) {
      const char* const image = reinterpret_cast<const char*>(slabs);
      int stage = 0;
      uint32_t phase = 0;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const char* src = image;
        for (int j = 0; j < d.num_layers + 4; ++j) {
          int K, N;
          layer_shape(d, j, &K, &N);
          const uint32_t bytes = N * 128;
          for (int k0 = 0; k0 < K; k0 += kSlabK) {
            hopper::mbar_wait(empty + 8 * stage, phase ^ 1u);
            hopper::mbar_arrive_expect_tx(full + 8 * stage, bytes);
            hopper::bulk_load(ring_base + stage * stage_bytes, src, bytes,
                              full + 8 * stage);
            src += bytes;
            if (++stage == stages) {
              stage = 0;
              phase ^= 1u;
            }
          }
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
      // Encoders: each tile's features go into a consumer warpgroup's rows
      // as soon as it has read the last tile's (positional: after its body;
      // view: after its hidden layer), so no consumer waits on an encode.
      const int warp = (threadIdx.x - 256) / 32 - 1;   // 0..2
      const int lane = threadIdx.x & 31;
      uint32_t parity = 0;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        for (int w = 0; w < 2; ++w) {
          hopper::mbar_wait(pos_free + 8 * w, parity ^ 1u);
          encode_rows(positions, tile * kTileRows + w * kWgRows, num_points,
                      pos_enc, d.e_pos, d.include_inputs, d.pos_width,
                      base + w * act_bytes, C, warp, kEncoderWarps, lane);
          hopper::fence_async_shared();
          hopper::mbar_arrive(pos_ready + 8 * w);
        }
        for (int w = 0; w < 2; ++w) {
          hopper::mbar_wait(view_free + 8 * w, parity ^ 1u);
          encode_rows(views, tile * kTileRows + w * kWgRows, num_points,
                      view_enc, d.e_view, d.include_inputs, d.view_width,
                      base + w * act_bytes, C + d.pos_width, warp,
                      kEncoderWarps, lane);
          hopper::fence_async_shared();
          hopper::mbar_arrive(view_ready + 8 * w);
        }
        parity ^= 1u;
      }
    }
  } else {
    hopper::regs_increase<kConsumerRegs>();
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const int lane = t & 31;
    const uint32_t act = base + wg * act_bytes;
    const uint32_t barrier_id = 1 + wg;
    const bool releases = lane == 0;
    const int r0 = 16 * warp + (lane >> 2);
    const int pair = 2 * (lane & 3);
    const Fragment f = fragment_of(warp, lane);
    Ring ring{ring_base, stage_bytes, full, empty, stages, 0, 0u};
    const int L = d.num_layers;
    const int P = d.pos_width;
    const int V = d.view_width;
    float acc[C / 2];
    uint32_t parity = 0;
    for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
      const long long row0 = tile * kTileRows + wg * kWgRows;
      hopper::mbar_wait(pos_ready + 8 * wg, parity);
      // body: layer 0 reads the positional features, a skip layer [h | pos]
      for (int i = 0; i < L; ++i) {
        const int K = i == 0 ? P : C + (((d.skip_mask >> i) & 1u) ? P : 0);
        layer_product<C>(acc, ring, act, K, i == 0 ? 0 : K, i == 0 ? C : 0,
                         releases);
        if (i == L - 1 && releases) hopper::mbar_arrive(pos_free + 8 * wg);
        store_layer<C, true>(acc, biases + d.b_off[i], act, f, pair);
        rows_ready(barrier_id);
      }
      // opacity head: column 0 for rows r0 and r0 + 8 (lanes with lane % 4
      // == 0 hold it)
      layer_product<kHeadWidth>(acc, ring, act, C, C, 0, releases);
      const float opacity_bias = __ldg(biases + d.b_off[L]);
      const float opacity0 = acc[0] + opacity_bias;
      const float opacity1 = acc[2] + opacity_bias;
      // bottleneck, cast
      layer_product<C>(acc, ring, act, C, C, 0, releases);
      store_layer<C, false>(acc, biases + d.b_off[L + 1], act, f, pair);
      rows_ready(barrier_id);
      // hidden layer over [bottleneck | view features]
      hopper::mbar_wait(view_ready + 8 * wg, parity);
      layer_product<C / 2>(acc, ring, act, C + V, C, P, releases);
      if (releases) hopper::mbar_arrive(view_free + 8 * wg);
      store_layer<C / 2, true>(acc, biases + d.b_off[L + 2], act, f, pair);
      rows_ready(barrier_id);
      // color head: columns 0, 1 on lane % 4 == 0, column 2 on the next lane
      layer_product<kHeadWidth>(acc, ring, act, C / 2, C / 2, 0, releases);
      const float* color_bias = biases + d.b_off[L + 3];
      const float blue0 = __shfl_down_sync(0xffffffffu, acc[0], 1);
      const float blue1 = __shfl_down_sync(0xffffffffu, acc[2], 1);
      if ((lane & 3) == 0) {
        const float b0 = __ldg(color_bias);
        const float b1 = __ldg(color_bias + 1);
        const float b2 = __ldg(color_bias + 2);
        const long long g = row0 + r0;
        if (g < num_points) {
          reinterpret_cast<float4*>(out)[g] =
              make_float4(acc[0] + b0, acc[1] + b1, blue0 + b2, opacity0);
        }
        if (g + 8 < num_points) {
          reinterpret_cast<float4*>(out)[g + 8] =
              make_float4(acc[2] + b0, acc[3] + b1, blue1 + b2, opacity1);
        }
      }
      parity ^= 1u;
    }
  }
}

// The shared memory a bf16 launch needs (0 if the model does not fit with
// two stages) and the stages it gets.
size_t bf16_shared_bytes(const Desc& d, int* stages, int* act_blocks) {
  *act_blocks = (d.channels + d.pos_width + d.view_width + 63) / 64;
  const size_t fixed = kAlignSlack + 2ull * *act_blocks * kBlockBytes
                       + kBarrierBytes;
  const size_t stage = static_cast<size_t>(d.channels) * 128;
  if (fixed + 2 * stage > kSharedLimit) return 0;
  const size_t fit = (kSharedLimit - fixed) / stage;
  *stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return fixed + *stages * stage;
}

template <int C>
cudaError_t launch_bf16(const void* positions, const void* views,
                        const void* pos_enc, const void* view_enc,
                        const void* slabs, const void* biases, void* out,
                        long long num_points, const Desc& d,
                        cudaStream_t stream) {
  static ffn::SharedLimit limit;
  int stages = 0, act_blocks = 0;
  const size_t smem = bf16_shared_bytes(d, &stages, &act_blocks);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err =
      ffn::reserve_shared(fused_nerf_bf16_kernel<C>, smem, limit);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (num_points + kTileRows - 1) / kTileRows;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  fused_nerf_bf16_kernel<C><<<grid, kBf16Threads, smem, stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(views),
      static_cast<const float*>(pos_enc), static_cast<const float*>(view_enc),
      static_cast<const __nv_bfloat16*>(slabs),
      static_cast<const float*>(biases), static_cast<float*>(out), num_points,
      d, stages, act_blocks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the FFMA tile
// ---------------------------------------------------------------------------

using ffn::dense;
using ffn::kCast;
using ffn::kReluCast;
using ffn::kRowPad;
using ffn::kScratchFloats;
using ffn::kThreads;
using ffn::kTile;
using ffn::kToOutput;

size_t f32_shared_bytes(const Desc& d) {
  const int region = d.pos_width > d.view_width ? d.pos_width : d.view_width;
  const size_t lda = d.channels + region + kRowPad;
  return kScratchFloats * sizeof(float) + kTile * lda * sizeof(float)
         + 2 * kTile * 3 * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
fused_nerf_f32_kernel(const float* __restrict__ positions,
                      const float* __restrict__ views,
                      const float* __restrict__ pos_enc,
                      const float* __restrict__ view_enc,
                      const float* __restrict__ weights,
                      const float* __restrict__ biases, float* __restrict__ out,
                      long long num_points, Desc d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = d.channels;
  const int region = d.pos_width > d.view_width ? d.pos_width : d.view_width;
  const int lda = C + region + kRowPad;
  float* scratch = reinterpret_cast<float*>(smem);
  float* act = reinterpret_cast<float*>(smem + kScratchFloats * sizeof(float));
  float* xs = act + kTile * lda;
  float* vs = xs + kTile * 3;

  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  for (int idx = threadIdx.x; idx < kTile * 3; idx += kThreads) {
    const bool live = row0 + idx / 3 < num_points;   // ragged last tile
    xs[idx] = live ? positions[row0 * 3 + idx] : 0.0f;
    vs[idx] = live ? views[row0 * 3 + idx] : 0.0f;
  }
  __syncthreads();
  ffn::encode<kTile, kThreads, float>(xs, pos_enc, d.e_pos, d.include_inputs,
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
  // bottleneck
  dense(act, act, lda, 0, C, weights + d.w_off[L + 1], C,
        biases + d.b_off[L + 1], kCast, out, row0, num_points, 0, 0, scratch);
  ffn::encode<kTile, kThreads, float>(vs, view_enc, d.e_view,
                                      d.include_inputs, d.view_width, act,
                                      lda, C);
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

cudaError_t launch_f32(const void* positions, const void* views,
                       const void* pos_enc, const void* view_enc,
                       const void* weights, const void* biases, void* out,
                       long long num_points, const Desc& d,
                       cudaStream_t stream) {
  const size_t smem = f32_shared_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (num_points + kTile - 1) / kTile;
  fused_nerf_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(views),
      static_cast<const float*>(pos_enc), static_cast<const float*>(view_enc),
      static_cast<const float*>(weights), static_cast<const float*>(biases),
      static_cast<float*>(out), num_points, d);
  return cudaGetLastError();
}

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// weight_dtype: 0 = f32, `weights` the flat (in, out) pack; 1 = bf16,
// `weights` the slab image of kernels/fused_nerf.py::slab_image.
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
    switch (d.channels) {
#define FFN_BF16_CASE(C)                                                     \
  case C:                                                                    \
    err = launch_bf16<C>(positions, views, pos_enc, view_enc, weights,       \
                         biases, out, num_points, d, s);                     \
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
    err = launch_f32(positions, views, pos_enc, view_enc, weights, biases, out,
                     num_points, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
