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
// f32: fused_nerf_tf32_kernel, the same persistent, warp-specialised shape
// (one block per SM, 128-point tiles, two consumer warpgroups, one copy warp,
// three encoder warps) with f32 activations and 3xTF32 products; its tile's
// routines, shared with K2's f32 recompute, are in fused_nerf_tf32.cuh.
// * Products. Each f32 operand is split into tf32 hi and lo (cvt.rna, then
//   cvt.rna of the rest) and each product summed as lo hi + hi lo + hi hi in
//   the f32 accumulator: f32 accuracy, no single tf32 product anywhere. wgmma
//   reads a tf32 operand in shared memory only K-major, so A (the
//   activations) comes from registers (ldmatrix, split there) and B from the
//   f32 slab image (kernels/fused_nerf.py::f32_slab_image), whose slabs of 32
//   K-rows hold W's hi and lo parts, made once a pack, in pieces of at most
//   128 columns: one piece (32 KB at the flagship) is one ring stage.
// * Shared memory is the binding constraint (tf32_shared_bytes is the one
//   budget): a warpgroup's 64 rows of [h (C) | features] in f32, where the
//   view features overwrite the positional ones once the body has read them
//   (80 KB at the flagship), and two 32 KB stages: 230,576 bytes. The
//   encoders alternate: a tile's view features once its body is done, the
//   next tile's positional features once its hidden layer is done.
// * L2 traffic: each 128-point tile streams the forward part of the image,
//   hi and lo (4.75 MB at the flagship, 37 KB a point, four times bf16's).
//   Bound: 3xTF32 is three tf32 products (495 TFLOP/s dense) for each f32
//   one, 15.1 ms at 2,097,152 points against 37.2 for f32 FFMA.
// * The epilogue adds the bias and applies the ReLU in registers and stores
//   the rows in place (st.shared.v2, each warp its own 16 rows: no barrier,
//   no proxy fence, since A is read with ldmatrix). The heads run in f32 on
//   the CUDA cores with the pack's exact head weights (kept at the end of the
//   image), two lanes a point.
// * A slab's A registers are reloaded only after its products complete
//   (wgmma.wait_group 0), so a warpgroup's products pause at each slab; the
//   other warpgroup's fill the tensor cores then.

// Both kernels mask the ragged last tile themselves, launch on the caller's
// stream and allocate nothing; the entry point returns cudaGetLastError().

#include "fused_nerf_common.cuh"
#include "fused_nerf_tf32.cuh"
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
// f32: the 3xTF32 wgmma kernel (the tile's routines are in fused_nerf_tf32.cuh)
// ---------------------------------------------------------------------------

// full and empty per stage; per consumer warpgroup, its features written
// (positional, view) and its feature columns read
constexpr int kTf32BarrierBytes = (2 * kMaxStages + 6) * 8;

// One warp's part of a head over its 16 rows of `act`, on the CUDA cores in
// f32: lane l takes row 16 warp + l / 2 and half l % 2 of the K inputs, and
// the pair of lanes adds its two halves. w is the head's exact (K, 16)
// weight; returns its columns 0 .. kOuts - 1 without the bias.
template <int kOuts>
__device__ __forceinline__ void head_f32(uint32_t act, int K,
                                         const float* __restrict__ w,
                                         int warp, int lane, float* sums) {
  const int row = 16 * warp + (lane >> 1);
  const int c0 = (lane & 1) * (K / 2);
#pragma unroll
  for (int o = 0; o < kOuts; ++o) sums[o] = 0.0f;
  for (int c = c0; c < c0 + K / 2; c += 4) {
    const float4 h = ffn::tf32::ld_f32x4(ffn::tf32::f32_addr(act, row, c));
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      sums[o] = fmaf(h.x, __ldg(w + (c + 0) * kHeadWidth + o), sums[o]);
      sums[o] = fmaf(h.y, __ldg(w + (c + 1) * kHeadWidth + o), sums[o]);
      sums[o] = fmaf(h.z, __ldg(w + (c + 2) * kHeadWidth + o), sums[o]);
      sums[o] = fmaf(h.w, __ldg(w + (c + 3) * kHeadWidth + o), sums[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
    sums[o] += __shfl_xor_sync(0xffffffffu, sums[o], 1);
  }
}

template <int C>
__global__ void __launch_bounds__(kBf16Threads, 1)
fused_nerf_tf32_kernel(const float* __restrict__ positions,
                       const float* __restrict__ views,
                       const float* __restrict__ pos_enc,
                       const float* __restrict__ view_enc,
                       const float* __restrict__ image,
                       const float* __restrict__ biases,
                       float* __restrict__ out, long long num_points, Desc d,
                       int stages, int act_blocks, long long opacity_at,
                       long long color_at) {
  namespace t32 = ffn::tf32;
  extern __shared__ __align__(1024) unsigned char tf32_smem[];
  const uint32_t base = (hopper::smem_addr(tf32_smem) + kAlignSlack - 1)
                        & ~static_cast<uint32_t>(kAlignSlack - 1);
  const uint32_t act_bytes = act_blocks * t32::kBlockBytes;   // a warpgroup's
  const uint32_t ring_base = base + 2 * act_bytes;
  const uint32_t slot_bytes = t32::stage_bytes(C);
  const uint32_t full = ring_base + stages * slot_bytes;
  const uint32_t empty = full + 8 * kMaxStages;
  // [warpgroup]: positional features written, view features written, and
  // the feature columns read (twice a tile: after the body, which read the
  // positional features, and after the hidden layer, which read the view's)
  const uint32_t pos_ready = empty + 8 * kMaxStages;
  const uint32_t view_ready = pos_ready + 16;
  const uint32_t feat_free = view_ready + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    for (int w = 0; w < 2; ++w) {
      hopper::mbar_init(pos_ready + 8 * w, kEncoderThreads);
      hopper::mbar_init(view_ready + 8 * w, kEncoderThreads);
      hopper::mbar_init(feat_free + 8 * w, kConsumerWarps / 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const long long num_tiles = (num_points + kTileRows - 1) / kTileRows;
  const int L = d.num_layers;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hopper::regs_decrease<kProducerRegs>();
    if (threadIdx.x == 256) {
      // Producer: one thread streams each tile's slabs, the forward part of
      // the image (body, bottleneck, hidden: the heads run on the CUDA
      // cores), from its start.
      int stage = 0;
      uint32_t phase = 0;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const char* src = reinterpret_cast<const char*>(image);
        for (int j = 0; j < L + 3; ++j) {
          if (j == L) continue;
          int K, N;
          layer_shape(d, j, &K, &N);
          src = t32::stream_slabs(src, K, N, ring_base, slot_bytes, full,
                                  empty, stages, &stage, &phase);
        }
      }
      for (int s = 0; s < stages; ++s) {
        hopper::mbar_wait(empty + 8 * stage, phase ^ 1u);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    } else if (threadIdx.x >= 256 + 32) {
      // Encoders: the positional and the view features share a warpgroup's
      // feature columns. A tile's positional features go in once the last
      // tile's hidden layer has read its view features (for the first tile,
      // at once), its view features once its body has read the positional.
      const int warp = (threadIdx.x - 256) / 32 - 1;   // 0..2
      const int lane = threadIdx.x & 31;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        for (int w = 0; w < 2; ++w) {
          hopper::mbar_wait(feat_free + 8 * w, 1u);
          t32::encode_rows_f32(positions, tile * kTileRows + w * kWgRows,
                               num_points, pos_enc, d.e_pos, d.include_inputs,
                               d.pos_width, base + w * act_bytes, C, warp,
                               kEncoderWarps, lane);
          hopper::mbar_arrive(pos_ready + 8 * w);
        }
        for (int w = 0; w < 2; ++w) {
          hopper::mbar_wait(feat_free + 8 * w, 0u);
          t32::encode_rows_f32(views, tile * kTileRows + w * kWgRows,
                               num_points, view_enc, d.e_view,
                               d.include_inputs, d.view_width,
                               base + w * act_bytes, C, warp, kEncoderWarps,
                               lane);
          hopper::mbar_arrive(view_ready + 8 * w);
        }
      }
    }
    return;
  }

  hopper::regs_increase<kConsumerRegs>();
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const uint32_t act = base + wg * act_bytes;
  const bool releases = lane == 0;
  const int r0 = 16 * warp + (lane >> 2);
  const int pair = 2 * (lane & 3);
  Ring ring{ring_base, slot_bytes, full, empty, stages, 0, 0u};
  const int P = d.pos_width;
  const int V = d.view_width;
  float acc[C / 2];
  uint32_t parity = 0;
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    // body: layer 0 reads the features at column C, a skip layer [h | pos]
    hopper::mbar_wait(pos_ready + 8 * wg, parity);
    for (int i = 0; i < L; ++i) {
      const int K = i == 0 ? P : C + (((d.skip_mask >> i) & 1u) ? P : 0);
      t32::layer_tf32<C>(acc, ring, K,
                         t32::point_major_a(act, warp, lane, i == 0 ? 0 : K,
                                            i == 0 ? C : 0),
                         releases);
      if (i == L - 1 && releases) hopper::mbar_arrive(feat_free + 8 * wg);
      t32::store_f32<C, true>(acc, biases + d.b_off[i], act, r0, pair);
      __syncwarp();
    }
    // opacity head, f32 on the CUDA cores, before the bottleneck overwrites h
    float opacity;
    head_f32<1>(act, C, image + opacity_at, warp, lane, &opacity);
    opacity += __ldg(biases + d.b_off[L]);
    // bottleneck, in place
    t32::layer_tf32<C>(acc, ring, C, t32::point_major_a(act, warp, lane, C, 0),
                       releases);
    t32::store_f32<C, false>(acc, biases + d.b_off[L + 1], act, r0, pair);
    __syncwarp();
    // hidden layer over [bottleneck | view features at column C]
    hopper::mbar_wait(view_ready + 8 * wg, parity);
    t32::layer_tf32<C / 2>(acc, ring, C + V,
                           t32::point_major_a(act, warp, lane, C + V, 0),
                           releases);
    if (releases) hopper::mbar_arrive(feat_free + 8 * wg);
    t32::store_f32<C / 2, true>(acc, biases + d.b_off[L + 2], act, r0, pair);
    __syncwarp();
    // color head, f32 on the CUDA cores; one float4 a point
    float color[3];
    head_f32<3>(act, C / 2, image + color_at, warp, lane, color);
    if ((lane & 1) == 0) {
      const long long g = tile * kTileRows + wg * kWgRows + 16 * warp
                          + (lane >> 1);
      const float* color_bias = biases + d.b_off[L + 3];
      if (g < num_points) {
        reinterpret_cast<float4*>(out)[g] = make_float4(
            color[0] + __ldg(color_bias), color[1] + __ldg(color_bias + 1),
            color[2] + __ldg(color_bias + 2), opacity);
      }
    }
    parity ^= 1u;
  }
}

// The shared memory an f32 launch needs (0 if the model does not fit with
// two stages) and the stages it gets: per warpgroup 64 rows of [h (C) |
// features (the larger of P and V)] in 32-column blocks, then the ring.
size_t tf32_shared_bytes(const Desc& d, int* stages, int* act_blocks) {
  const int features = d.pos_width > d.view_width ? d.pos_width
                                                   : d.view_width;
  *act_blocks = (d.channels + 31) / 32 + (features + 31) / 32;
  const size_t fixed = kAlignSlack
                       + 2ull * *act_blocks * ffn::tf32::kBlockBytes
                       + kTf32BarrierBytes;
  const size_t stage = ffn::tf32::stage_bytes(d.channels);
  if (fixed + 2 * stage > kSharedLimit) return 0;
  const size_t fit = (kSharedLimit - fixed) / stage;
  *stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return fixed + *stages * stage;
}

template <int C>
cudaError_t launch_tf32(const void* positions, const void* views,
                        const void* pos_enc, const void* view_enc,
                        const void* image, const void* biases, void* out,
                        long long num_points, const Desc& d,
                        cudaStream_t stream) {
  static ffn::SharedLimit limit;
  int stages = 0, act_blocks = 0;
  const size_t smem = tf32_shared_bytes(d, &stages, &act_blocks);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err =
      ffn::reserve_shared(fused_nerf_tf32_kernel<C>, smem, limit);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long opacity_at = ffn::tf32::heads_at(d);
  const long long tiles = (num_points + kTileRows - 1) / kTileRows;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  fused_nerf_tf32_kernel<C><<<grid, kBf16Threads, smem, stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(views),
      static_cast<const float*>(pos_enc), static_cast<const float*>(view_enc),
      static_cast<const float*>(image), static_cast<const float*>(biases),
      static_cast<float*>(out), num_points, d, stages, act_blocks,
      opacity_at, opacity_at + d.channels * kHeadWidth);
  return cudaGetLastError();
}

}  // namespace

// meta: the host int64 descriptor of ffn::parse_desc (fused_nerf_common.cuh).
// weight_dtype: 0 = f32, `weights` the f32 slab image of kernels/
// fused_nerf.py::f32_slab_image; 1 = bf16, `weights` the slab image of
// kernels/fused_nerf.py::slab_image.
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
    switch (d.channels) {
#define FFN_TF32_CASE(C)                                                     \
  case C:                                                                    \
    err = launch_tf32<C>(positions, views, pos_enc, view_enc, weights,       \
                         biases, out, num_points, d, s);                     \
    break;
      FFN_TF32_CASE(32)
      FFN_TF32_CASE(64)
      FFN_TF32_CASE(96)
      FFN_TF32_CASE(128)
      FFN_TF32_CASE(160)
      FFN_TF32_CASE(192)
      FFN_TF32_CASE(224)
      FFN_TF32_CASE(256)
#undef FFN_TF32_CASE
      default:
        err = cudaErrorInvalidValue;
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
