// K1's two forward kernels, the bf16 wgmma kernel and the f32 3xTF32 kernel
// (fused_nerf.cu says what bounds them and how they are built), as templates
// over a mode: the ablation of tools/kernel_ablation_bench.py that the
// launch runs (Ablation). K1 (fused_nerf.cu) instantiates kBase, P2
// (fused_nerf_ablation.cu) every mode, so P2's base is K1's own kernel and
// its other modes split K1's time. Each mode is its own instantiation, a
// compile-time policy (a never-taken runtime branch cost K1 ~1.5% on its
// first tile, PERF.md); kBase compiles to the code K1 had before the modes.
//
// The modes change only the body layers and the position encode, as the
// tool does: the heads keep their bias, the hidden layer its ReLU, the view
// encode its sin/cos.
//   kNoView      the producer streams only the body's and the opacity
//                head's slabs (f32: the body's), the encoders write no view
//                features, and the consumers write color = opacity * 0 +
//                color bias;
//   kNoBias, kNoRelu, kMatmulOnly
//                the body layers' epilogue adds no bias, applies no ReLU,
//                or neither;
//   kNoSincos    the position encode is [phase | 0.5 phase | raw];
//   kBf16Accum   (bf16 only) each body product over one input part (layer
//                0: cos, sin, raw; a skip layer: those, then h) is rounded
//                to bf16 and the parts are added in bf16 in the tool's
//                order, then the bf16 bias. Each part is one chain of K1's
//                layer_product, with its own fresh f32 accumulator, over
//                its own slabs of the mode's slab image (kernels/
//                fused_nerf_ablation.py::accum_slab_image), and its own
//                16-aligned run of activation columns (AccumParts); a
//                layer's outputs are computed in pieces of accum_piece(C)
//                columns, so a piece's accumulator beside the layer's
//                packed bf16 outputs (32 + 64 registers at C = 256) fits
//                where a whole layer's accumulator beside its running sum
//                (128 + 64) would not.

#pragma once

#include "fused_nerf_common.cuh"
#include "fused_nerf_tf32.cuh"
#include "fused_nerf_wgmma.cuh"
#include "hopper.cuh"
#include "shared_limit.cuh"

namespace {

using ffn::Desc;
using ffn::kHeadWidth;
using namespace ffn::wgmma;

enum Ablation { kBase = 0, kNoView = 1, kNoBias = 2, kNoRelu = 3,
                kMatmulOnly = 4, kBf16Accum = 5, kNoSincos = 6 };

template <int kMode>
struct Mode {
  static constexpr bool kView = kMode != kNoView;
  static constexpr bool kBias = kMode != kNoBias && kMode != kMatmulOnly;
  static constexpr bool kRelu = kMode != kNoRelu && kMode != kMatmulOnly;
  static constexpr bool kSincos = kMode != kNoSincos;
  static constexpr bool kAccum = kMode == kBf16Accum;
};

// bf16-accum's position encode: part p (cos, sin, raw: e_pos, e_pos and 3
// values) takes a run of depth[p] activation columns from C + off[p], its
// values first and zeros after; depth[p] is its length rounded up to 16, a
// whole number of wgmma k16 steps.
struct AccumParts {
  int count;      // 2, or 3 with raw inputs
  int off[3];
  int depth[3];
  int width;      // columns of all runs
};

__host__ __device__ inline AccumParts accum_parts(const Desc& d) {
  AccumParts parts = {d.include_inputs ? 3 : 2, {0, 0, 0}, {0, 0, 0}, 0};
  for (int p = 0; p < parts.count; ++p) {
    parts.depth[p] = ((p < 2 ? d.e_pos : 3) + 15) / 16 * 16;
    parts.off[p] = parts.width;
    parts.width += parts.depth[p];
  }
  if (parts.count == 2) parts.off[2] = parts.width;
  return parts;
}

// The output columns of one product of a bf16-accum body layer.
__host__ __device__ constexpr int accum_piece(int C) {
  return C % 64 == 0 ? 64 : 32;
}

// The columns between h and the view features: the position encode's.
__host__ __device__ inline int pos_columns(const Desc& d, int mode) {
  return mode == kBf16Accum ? accum_parts(d).width : d.pos_width;
}

// ---------------------------------------------------------------------------
// bf16: the wgmma kernel (the tile's routines are in fused_nerf_wgmma.cuh)
// ---------------------------------------------------------------------------

// full and empty per stage; per consumer warpgroup, ready and free for its
// positional and its view features
constexpr int kBarrierBytes = (2 * kMaxStages + 8) * 8;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16-accum: sum (N / 4 packed bf16 pairs, acc's fragment order) = bf16 of
// acc's products rounded to bf16 (first part), or bf16(sum + that).
template <int N>
__device__ __forceinline__ void fold_part(const float* acc, uint32_t* sum,
                                          bool first) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float p0 = round_bf16(acc[2 * i]);
    const float p1 = round_bf16(acc[2 * i + 1]);
    float s0 = p0, s1 = p1;
    if (!first) {
      const __nv_bfloat162 s = *reinterpret_cast<const __nv_bfloat162*>(
          &sum[i]);
      s0 = __low2float(s) + p0;
      s1 = __high2float(s) + p1;
    }
    const __nv_bfloat162 r = __floats2bfloat162_rn(s0, s1);
    sum[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
}

// bf16-accum's epilogue of a piece: out = ReLU(bf16(sum + bf16(bias))),
// packed as sum is; bias points at the piece's first column.
template <int N>
__device__ __forceinline__ void accum_finish(uint32_t* sum,
                                             const float* __restrict__ bias,
                                             int pair) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(
        bias + 8 * (i >> 1) + pair));
    const __nv_bfloat162 s = *reinterpret_cast<const __nv_bfloat162*>(
        &sum[i]);
    __nv_bfloat162 r =
        __floats2bfloat162_rn(__low2float(s) + round_bf16(b.x),
                              __high2float(s) + round_bf16(b.y));
    r = __hmax2(r, __float2bfloat162_rn(0.0f));
    sum[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
}

// Packed bf16 pairs (sum's order) into the swizzled rows, columns col0 ..
// col0 + N - 1 (col0 a multiple of 16).
template <int N>
__device__ __forceinline__ void store_packed(const uint32_t* v, uint32_t act,
                                             const Fragment& f, int col0) {
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    const int g = col0 / 8 + j;
    store_groups(act + (g / 8) * kBlockBytes, f, g % 8, v[2 * j],
                 v[2 * j + 1], v[2 * j + 2], v[2 * j + 3]);
  }
}

template <int C, int kMode>
__global__ void __launch_bounds__(kBf16Threads, 1)
fused_nerf_bf16_kernel(const float* __restrict__ positions,
                       const float* __restrict__ views,
                       const float* __restrict__ pos_enc,
                       const float* __restrict__ view_enc,
                       const __nv_bfloat16* __restrict__ slabs,
                       const float* __restrict__ biases,
                       float* __restrict__ out, long long num_points, Desc d,
                       int stages, int act_blocks) {
  using M = Mode<kMode>;
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
  if constexpr (M::kAccum) {
    // the runs' padding columns, which no encode writes, hold zeros
    const int pos_cols = accum_parts(d).width;
    for (int i = threadIdx.x; i < 2 * kWgRows * pos_cols; i += kBf16Threads) {
      const int w = i / (kWgRows * pos_cols);
      const int row = (i / pos_cols) % kWgRows;
      st_bf16(act_addr(base + w * act_bytes, row, C + i % pos_cols), 0.0f);
    }
    hopper::fence_async_shared();
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
      // bf16-accum: the slabs of a (K, N) part
      auto stream = [&](const char* src, int K, int N) {
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
        return src;
      };
      // no-view: the body and the opacity head only
      const int packed = M::kView ? d.num_layers + 4 : d.num_layers + 1;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const char* src = image;
        for (int j = 0; j < packed; ++j) {
          int K, N;
          layer_shape(d, j, &K, &N);
          if constexpr (M::kAccum) {
            if (j < d.num_layers) {
              // per piece of the outputs: each position part's slabs (layer
              // 0, skip layers), then h's (every layer but 0)
              const AccumParts parts = accum_parts(d);
              const bool pos = j == 0 || ((d.skip_mask >> j) & 1u);
              for (int q = 0; q < C / accum_piece(C); ++q) {
                for (int p = 0; p < (pos ? parts.count : 0); ++p) {
                  src = stream(src, parts.depth[p], accum_piece(C));
                }
                if (j > 0) src = stream(src, C, accum_piece(C));
              }
              continue;
            }
          }
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
          if constexpr (M::kAccum) {
            const AccumParts parts = accum_parts(d);
            const uint32_t act = base + w * act_bytes;
            encode_rows_to(positions, tile * kTileRows + w * kWgRows,
                           num_points, pos_enc, d.e_pos, d.include_inputs,
                           parts.off[1], parts.off[2],
                           parts.count == 3 ? 3 : 0, C, warp, kEncoderWarps,
                           lane, [act](int row, int col, float v) {
                             st_bf16(act_addr(act, row, col), v);
                           });
          } else {
            encode_rows<M::kSincos>(positions, tile * kTileRows + w * kWgRows,
                                    num_points, pos_enc, d.e_pos,
                                    d.include_inputs, d.pos_width,
                                    base + w * act_bytes, C, warp,
                                    kEncoderWarps, lane);
          }
          hopper::fence_async_shared();
          hopper::mbar_arrive(pos_ready + 8 * w);
        }
        if constexpr (M::kView) {
          for (int w = 0; w < 2; ++w) {
            hopper::mbar_wait(view_free + 8 * w, parity ^ 1u);
            encode_rows(views, tile * kTileRows + w * kWgRows, num_points,
                        view_enc, d.e_view, d.include_inputs, d.view_width,
                        base + w * act_bytes,
                        C + pos_columns(d, kMode), warp, kEncoderWarps,
                        lane);
            hopper::fence_async_shared();
            hopper::mbar_arrive(view_ready + 8 * w);
          }
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
    const int P = pos_columns(d, kMode);   // bf16-accum: the encode's runs
    const int V = d.view_width;
    float acc[C / 2];
    uint32_t parity = 0;
    for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
      const long long row0 = tile * kTileRows + wg * kWgRows;
      hopper::mbar_wait(pos_ready + 8 * wg, parity);
      // body: layer 0 reads the positional features, a skip layer [h | pos]
      for (int i = 0; i < L; ++i) {
        const bool skip = (d.skip_mask >> i) & 1u;
        if constexpr (M::kAccum) {
          // per piece: each part's chain, rounded and added in bf16 (the
          // encode's parts, then h), then the bias and the ReLU
          const AccumParts parts = accum_parts(d);
          const bool pos = i == 0 || skip;
          constexpr int kPiece = accum_piece(C);
          uint32_t outs[C / 4];   // the layer's outputs, packed in pairs
#pragma unroll
          for (int q = 0; q < C / kPiece; ++q) {
            uint32_t* sum = outs + q * (kPiece / 4);
            bool first = true;
            for (int p = 0; p < (pos ? parts.count : 0); ++p) {
              layer_product<kPiece>(acc, ring, act, parts.depth[p], 0,
                                    C + parts.off[p], releases);
              fold_part<kPiece>(acc, sum, first);
              first = false;
            }
            if (i > 0) {
              layer_product<kPiece>(acc, ring, act, C, C, 0, releases);
              fold_part<kPiece>(acc, sum, first);
            }
            accum_finish<kPiece>(sum, biases + d.b_off[i] + q * kPiece, pair);
          }
          if (i == L - 1 && releases) hopper::mbar_arrive(pos_free + 8 * wg);
          store_packed<C>(outs, act, f, 0);
        } else {
          const int K = i == 0 ? P : C + (skip ? P : 0);
          layer_product<C>(acc, ring, act, K, i == 0 ? 0 : K,
                           i == 0 ? C : 0, releases);
          if (i == L - 1 && releases) hopper::mbar_arrive(pos_free + 8 * wg);
          store_layer<C, M::kRelu, M::kBias>(acc, biases + d.b_off[i], act,
                                             f, pair);
        }
        rows_ready(barrier_id);
      }
      // opacity head: column 0 for rows r0 and r0 + 8 (lanes with lane % 4
      // == 0 hold it)
      layer_product<kHeadWidth>(acc, ring, act, C, C, 0, releases);
      const float opacity_bias = __ldg(biases + d.b_off[L]);
      const float opacity0 = acc[0] + opacity_bias;
      const float opacity1 = acc[2] + opacity_bias;
      if constexpr (!M::kView) {
        // color = opacity * 0 + color bias (the tool's `opacity * 0.0 +
        // color_b`)
        if ((lane & 3) == 0) {
          const float* color_bias = biases + d.b_off[L + 3];
          const float b0 = __ldg(color_bias);
          const float b1 = __ldg(color_bias + 1);
          const float b2 = __ldg(color_bias + 2);
          const long long g = row0 + r0;
          if (g < num_points) {
            reinterpret_cast<float4*>(out)[g] = make_float4(
                opacity0 * 0.0f + b0, opacity0 * 0.0f + b1,
                opacity0 * 0.0f + b2, opacity0);
          }
          if (g + 8 < num_points) {
            reinterpret_cast<float4*>(out)[g + 8] = make_float4(
                opacity1 * 0.0f + b0, opacity1 * 0.0f + b1,
                opacity1 * 0.0f + b2, opacity1);
          }
        }
        parity ^= 1u;
        continue;
      }
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

// The shared memory a bf16 launch in `mode` needs (0 if the model does not
// fit with two stages) and the stages it gets.
size_t bf16_shared_bytes(const Desc& d, int mode, int* stages,
                         int* act_blocks) {
  *act_blocks =
      (d.channels + pos_columns(d, mode) + d.view_width + 63) / 64;
  const size_t fixed = kAlignSlack + 2ull * *act_blocks * kBlockBytes
                       + kBarrierBytes;
  const size_t stage = static_cast<size_t>(d.channels) * 128;
  if (fixed + 2 * stage > kSharedLimit) return 0;
  const size_t fit = (kSharedLimit - fixed) / stage;
  *stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return fixed + *stages * stage;
}

template <int C, int kMode>
cudaError_t launch_bf16(const void* positions, const void* views,
                        const void* pos_enc, const void* view_enc,
                        const void* slabs, const void* biases, void* out,
                        long long num_points, const Desc& d,
                        cudaStream_t stream) {
  static ffn::SharedLimit limit;
  int stages = 0, act_blocks = 0;
  const size_t smem = bf16_shared_bytes(d, kMode, &stages, &act_blocks);
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err =
      ffn::reserve_shared(fused_nerf_bf16_kernel<C, kMode>, smem, limit);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (num_points + kTileRows - 1) / kTileRows;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  fused_nerf_bf16_kernel<C, kMode><<<grid, kBf16Threads, smem, stream>>>(
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

template <int C, int kMode>
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
  using M = Mode<kMode>;
  static_assert(!M::kAccum, "bf16-accum takes a bf16 pack");
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
  // positional features, and after the hidden layer, which read the view's;
  // no-view: once, after the body)
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
      // cores; no-view: the body), from its start.
      int stage = 0;
      uint32_t phase = 0;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const char* src = reinterpret_cast<const char*>(image);
        for (int j = 0; j < (M::kView ? L + 3 : L); ++j) {
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
      // at once; no-view: once the last tile's body has read its positional
      // features), its view features once its body has read the positional.
      const int warp = (threadIdx.x - 256) / 32 - 1;   // 0..2
      const int lane = threadIdx.x & 31;
      uint32_t parity = 0;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        for (int w = 0; w < 2; ++w) {
          hopper::mbar_wait(feat_free + 8 * w, M::kView ? 1u : parity ^ 1u);
          t32::encode_rows_f32<M::kSincos>(
              positions, tile * kTileRows + w * kWgRows, num_points, pos_enc,
              d.e_pos, d.include_inputs, d.pos_width, base + w * act_bytes, C,
              warp, kEncoderWarps, lane);
          hopper::mbar_arrive(pos_ready + 8 * w);
        }
        if constexpr (M::kView) {
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
        parity ^= 1u;
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
      t32::store_f32<C, M::kRelu, M::kBias>(acc, biases + d.b_off[i], act, r0,
                                            pair);
      __syncwarp();
    }
    // opacity head, f32 on the CUDA cores, before the bottleneck overwrites h
    float opacity;
    head_f32<1>(act, C, image + opacity_at, warp, lane, &opacity);
    opacity += __ldg(biases + d.b_off[L]);
    if constexpr (!M::kView) {
      // color = opacity * 0 + color bias (the tool's `opacity * 0.0 +
      // color_b`)
      if ((lane & 1) == 0) {
        const long long g = tile * kTileRows + wg * kWgRows + 16 * warp
                            + (lane >> 1);
        const float* color_bias = biases + d.b_off[L + 3];
        if (g < num_points) {
          reinterpret_cast<float4*>(out)[g] = make_float4(
              opacity * 0.0f + __ldg(color_bias),
              opacity * 0.0f + __ldg(color_bias + 1),
              opacity * 0.0f + __ldg(color_bias + 2), opacity);
        }
      }
      parity ^= 1u;
      continue;
    }
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

template <int C, int kMode>
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
      ffn::reserve_shared(fused_nerf_tf32_kernel<C, kMode>, smem, limit);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long opacity_at = ffn::tf32::heads_at(d);
  const long long tiles = (num_points + kTileRows - 1) / kTileRows;
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  fused_nerf_tf32_kernel<C, kMode><<<grid, kBf16Threads, smem, stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(views),
      static_cast<const float*>(pos_enc), static_cast<const float*>(view_enc),
      static_cast<const float*>(image), static_cast<const float*>(biases),
      static_cast<float*>(out), num_points, d, stages, act_blocks,
      opacity_at, opacity_at + d.channels * kHeadWidth);
  return cudaGetLastError();
}

// K1's forward in `kMode` for any channel width the kernels take: `weights`
// the bf16 pack's slab image (weight_dtype 1; bf16-accum: its accum image)
// or the f32 pack's f32 slab image (weight_dtype 0).
template <int kMode>
cudaError_t launch_forward(const void* positions, const void* views,
                           const void* pos_enc, const void* view_enc,
                           const void* weights, const void* biases, void* out,
                           long long num_points, const Desc& d,
                           int weight_dtype, cudaStream_t s) {
  if (weight_dtype == 1) {
    switch (d.channels) {
#define FFN_BF16_CASE(C)                                                     \
  case C:                                                                    \
    return launch_bf16<C, kMode>(positions, views, pos_enc, view_enc,        \
                                 weights, biases, out, num_points, d, s);
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
        return cudaErrorInvalidValue;
    }
  }
  if constexpr (kMode != kBf16Accum) {   // bf16-accum: bf16 packs only
    if (weight_dtype == 0) {
      switch (d.channels) {
#define FFN_TF32_CASE(C)                                                     \
  case C:                                                                    \
    return launch_tf32<C, kMode>(positions, views, pos_enc, view_enc,        \
                                 weights, biases, out, num_points, d, s);
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
          return cudaErrorInvalidValue;
      }
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
