// K1's two forward kernels, the bf16 wgmma kernel and the f32 3xTF32 kernel
// (fused_nerf.cu says what bounds them and how they are built), as templates
// over two compile-time policies:
// * a mode: the ablation of tools/kernel_ablation_bench.py that the launch
//   runs (Ablation). K1 (fused_nerf.cu) instantiates kBase, P2
//   (fused_nerf_ablation.cu) every mode, so P2's base is K1's own kernel and
//   its other modes split K1's time;
// * an output: K1's per-point logits (PointLogits), or K3's composited rays
//   (RayComposite, fused_ray_render.cu), which keeps K3's own rounding point:
//   the view product once a ray, rounded to the working type.
// Each is its own instantiation, a compile-time policy (a never-taken
// runtime branch cost K1 ~1.5% on its first tile, PERF.md); kBase with
// PointLogits compiles to the code K1 had before the policies.
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
//
// RayComposite changes the rows, the view branch and the output:
// * rows: N = R S points, ray-major. A consumer warpgroup takes a group of
//   group_rays whole rays (the wrapper's rule, kernels/fused_ray_render.py::
//   ray_group), its group_rays S rows in `pieces` pieces of 64 rows, so no
//   ray straddles two warpgroups; the two warpgroups of a tile take groups
//   2 tile and 2 tile + 1, piece by piece, and stay in step over the
//   producer's slab stream, which streams the layers once a piece. The
//   ragged last group's rows past N are masked as K1 masks its last tile;
//   the rows past a group's rays are padding, never output;
// * view: per ray, not per point. The encoder warps write, once a piece, the
//   view product venc . W_hidden[C:C+V] of each ray the piece's rows hold
//   (view_products: the encode in f32, rounded to the working type, the
//   products in f32 on the CUDA cores from the flat pack's rows, the sum
//   rounded to the working type), where K1 writes per-point view features:
//   bf16, a region of its own after [h | pos]; f32, the feature columns
//   once the body has read the positional features. The hidden layer's
//   product runs over the bottleneck's C rows alone (the producer skips the
//   slabs past them), and its epilogue adds the row's ray's view product,
//   then the bias (store_layer_view, store_f32_view), as the TPU kernel's
//   dot(bottleneck, W) + vdot + b;
// * output: after the heads each row's logits go to the warpgroup's slot
//   (shared_logits in bf16, scratch_logits in f32) and an mbarrier hands
//   them to an encoder warp (warp 0 for warpgroup 0, warp 1 for warpgroup
//   1), which composites the piece (composite_piece) while the warpgroup
//   goes on: softplus, sigmoid, alpha, a segmented scan over the 64 rows,
//   two a lane, for each ray's exclusive transmittance and its sums,
//   carried into the next piece for the ray the piece leaves open; a ray's
//   (R, 4) [color | alpha] is written by the lane that holds its last
//   sample. The encoders composite a piece between the next piece's
//   positional features and its view products, so no consumer waits on
//   the composite. (Composited on the consumers, K3 bf16 took 9% longer
//   than K1 followed by the plain composite at R = 16384, S = 128, H100
//   80GB HBM3 at 700 W: the tensor cores idle while a warpgroup waits.)

#pragma once

#include <type_traits>

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
// The output policies: K1's logits, K3's composited rays
// ---------------------------------------------------------------------------

// K1: per-point view features and (N, 4) logits.
struct PointLogits {};

// K3: rays of `samples` points; see the comment at the top.
struct RayComposite {
  const float* t_values;   // (R, S) depths
  const void* view_rows;   // W_hidden[C : C + V] of the flat pack, (V, C / 2)
  long long num_rays;
  int samples;             // S
  int group_rays;          // rays of a warpgroup's group
  int group_points;        // group_rays * S
  int pieces;              // 64-row pieces of a group
  int piece_rays;          // the most rays one piece's rows hold
  long long tiles;         // pairs of groups: ceil(ceil(R / group_rays) / 2)
  float4* logits;          // f32: [block][warpgroup][64 rows] of logits
  uint32_t view_at;        // bytes from a warpgroup's rows to its view products
};

template <typename Out>
constexpr bool kRays = std::is_same<Out, RayComposite>::value;

// The tiles a launch walks: K1's of 128 points, K3's pairs of ray groups
// (counted on the host: a 64-bit division in the kernel is a subroutine
// call, and with calls ptxas spilled more of the consumers' registers).
template <typename Out>
__host__ __device__ __forceinline__ long long tile_count(
    const Out& rays, long long num_points) {
  if constexpr (kRays<Out>) {
    return rays.tiles;
  } else {
    return (num_points + kTileRows - 1) / kTileRows;
  }
}

// The pieces of a tile: K3's group pieces, K1's one.
template <typename Out>
__device__ __forceinline__ int tile_pieces(const Out& rays) {
  if constexpr (kRays<Out>) {
    return rays.pieces;
  } else {
    return 1;
  }
}

// The first point of warpgroup w's rows in piece `piece` of tile `tile`,
// and in *end the point where its live rows end.
template <typename Out>
__device__ __forceinline__ long long piece_rows(const Out& rays,
                                                long long tile, int piece,
                                                int w, long long num_points,
                                                long long* end) {
  if constexpr (kRays<Out>) {
    const long long first = (2 * tile + w) * rays.group_points;
    const long long stop = first + rays.group_points;
    *end = stop < num_points ? stop : num_points;
    return first + piece * kWgRows;
  } else {
    *end = num_points;
    return tile * kTileRows + w * kWgRows;
  }
}

// The rays whose samples lie in piece `piece` of group `group`: the first
// (a global ray index) and, in *count, how many (<= rays.piece_rays).
__device__ __forceinline__ long long rays_of_piece(const RayComposite& rays,
                                                   long long group,
                                                   int piece, int* count) {
  const int first = piece * kWgRows / rays.samples;
  int last = (piece * kWgRows + kWgRows - 1) / rays.samples;
  if (last > rays.group_rays - 1) last = rays.group_rays - 1;
  *count = last - first + 1;
  return group * rays.group_rays + first;
}

// The byte offset of row r's ray's view products among a piece's (rows
// past the group's rays read the last slot; they are never output).
__device__ __forceinline__ uint32_t view_slot(const RayComposite& rays,
                                              int piece, int r,
                                              uint32_t slot_bytes) {
  const int first = piece * kWgRows / rays.samples;
  int slot = (piece * kWgRows + r) / rays.samples - first;
  if (slot > rays.piece_rays - 1) slot = rays.piece_rays - 1;
  return static_cast<uint32_t>(slot) * slot_bytes;
}

// K3's view products of the `count` rays from `ray0` (those below
// num_rays): vp[slot][c] = T(sum_k venc[k] w[k][c]) for c < H = C / 2, at
// vp + slot * H * sizeof(T), where venc is the ray's view encode [cos | sin
// | x | zeros] as encode_rows_to makes it, rounded to T, and w the pack's
// (V, H) view rows. The warps share out (ray, 32 columns) items: for each,
// lane e makes feature e (then e + 32, ...), each feature is handed round
// with a shuffle, and lane l sums column 32 j + l in f32 FMAs, as the twin's
// f32 product of T values.
template <int H, typename T>
__device__ __forceinline__ void view_products(
    const float* __restrict__ views, long long ray0, int count,
    long long num_rays, const float* __restrict__ enc, int E,
    int include_inputs, const T* __restrict__ w, uint32_t vp, int warp,
    int warps, int lane) {
  constexpr int kChunks = (H + 31) / 32;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  auto to_t = [](float v) {   // v rounded to T
    return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  };
  const int features = 2 * E + (include_inputs ? 3 : 0);
  for (int item = warp; item < count * kChunks; item += warps) {
    const int slot = item / kChunks;
    const int c = (item % kChunks) * 32 + lane;
    const long long ray = ray0 + slot;
    if (ray >= num_rays) break;   // the same for the whole warp
    const float x0 = __ldg(views + 3 * ray);
    const float x1 = __ldg(views + 3 * ray + 1);
    const float x2 = __ldg(views + 3 * ray + 2);
    float acc = 0.0f;
    for (int k0 = 0; k0 < features; k0 += 32) {
      const int k = k0 + lane;
      float v = 0.0f;
      if (k < 2 * E) {
        const int e = k < E ? k : k - E;
        const float phase = fmaf(x2, __ldg(enc + 2 * E + e),
                                 fmaf(x1, __ldg(enc + E + e),
                                      x0 * __ldg(enc + e)));
        float sn, cs;
        ffn::fast_sincos(phase, &sn, &cs);
        v = k < E ? cs : sn;
      } else if (k < features) {
        v = k == 2 * E ? x0 : k == 2 * E + 1 ? x1 : x2;
      }
      v = to_t(v);
      const int n = features - k0 < 32 ? features - k0 : 32;
      const T* row = w + static_cast<long long>(k0) * H + (c < H ? c : 0);
#pragma unroll 8
      for (int kk = 0; kk < n; ++kk) {
        const float feature = __shfl_sync(0xffffffffu, v, kk);
        acc = fmaf(feature,
                   static_cast<float>(row[static_cast<long long>(kk) * H]),
                   acc);
      }
    }
    if (c < H) {
      const uint32_t at = vp + static_cast<uint32_t>((slot * H + c)
                                                     * sizeof(T));
      if constexpr (kBf16) {
        st_bf16(at, acc);
      } else {
        ffn::tf32::st_f32(at, acc);
      }
    }
  }
}

__device__ __forceinline__ float2 ld_bf16x2(uint32_t addr) {
  uint32_t bits;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(bits) : "r"(addr)
               : "memory");
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  return make_float2(__low2float(v), __high2float(v));
}

__device__ __forceinline__ float2 ld_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// K3's hidden epilogue in bf16: store_layer<N, true> with the ray's view
// product (bf16, at view0 for row r0 and view8 for row r0 + 8) added to
// each sum before the bias: h = ReLU(bf16((acc + view) + bias)).
template <int N>
__device__ __forceinline__ void store_layer_view(const float* acc,
                                                 const float* __restrict__ bias,
                                                 uint32_t view0,
                                                 uint32_t view8, uint32_t act,
                                                 const Fragment& f,
                                                 int pair) {
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j
                                                             + pair));
    const float2 c = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 8
                                                             + pair));
    const float2 v0 = ld_bf16x2(view0 + (8 * j + pair) * 2);
    const float2 v8 = ld_bf16x2(view8 + (8 * j + pair) * 2);
    const float2 w0 = ld_bf16x2(view0 + (8 * j + 8 + pair) * 2);
    const float2 w8 = ld_bf16x2(view8 + (8 * j + 8 + pair) * 2);
    store_groups(
        act + (j / 8) * kBlockBytes, f, j % 8,
        pack_bf16x2(acc[4 * j] + v0.x + b.x, acc[4 * j + 1] + v0.y + b.y,
                    true),
        pack_bf16x2(acc[4 * j + 2] + v8.x + b.x,
                    acc[4 * j + 3] + v8.y + b.y, true),
        pack_bf16x2(acc[4 * j + 4] + w0.x + c.x,
                    acc[4 * j + 5] + w0.y + c.y, true),
        pack_bf16x2(acc[4 * j + 6] + w8.x + c.x,
                    acc[4 * j + 7] + w8.y + c.y, true));
  }
}

// The same in f32 (store_f32<N, true>, the view products f32).
template <int N>
__device__ __forceinline__ void store_f32_view(const float* acc,
                                               const float* __restrict__ bias,
                                               uint32_t view0, uint32_t view8,
                                               uint32_t act, int r0,
                                               int pair) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j
                                                             + pair));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = ld_f32x2((h == 0 ? view0 : view8) + (8 * j + pair) * 4);
      const float v0 = fmaxf(acc[4 * j + 2 * h] + v.x + b.x, 0.0f);
      const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + v.y + b.y, 0.0f);
      ffn::tf32::st_f32x2(ffn::tf32::f32_addr(act, r0 + 8 * h, 8 * j + pair),
                          v0, v1);
    }
  }
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// With the fast reciprocal (within 2 ulp): an IEEE division's slow path is a
// subroutine call, and with calls ptxas spilled more of the consumers'
// registers.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + expf(-x));
}

// Where a warpgroup keeps its piece's logits for the composite, 64 rows of
// [r, g, b, opacity]: in bf16 in shared memory after its view products
// (`rows`: the generic address of its rows), in f32, which has no shared
// memory left, in the wrapper's scratch (warpgroup w of this block). Nothing
// writes them again before the composite has read them: the next piece's
// logits follow its hidden layer, which waits for view products that the
// encoders write only after the composite, and view products go to the
// slots before them.
__device__ __forceinline__ float4* shared_logits(unsigned char* rows,
                                                 const RayComposite& rays,
                                                 int C) {
  return reinterpret_cast<float4*>(rows + rays.view_at
                                   + rays.piece_rays * C);
}

__device__ __forceinline__ float4* scratch_logits(const RayComposite& rays,
                                                  int w) {
  return rays.logits + (2 * blockIdx.x + w) * kWgRows;
}

// The ray a piece leaves open: the transmittance after its last sample in
// the piece, and its sums so far (color, alpha).
struct OpenRay {
  float t;
  float4 sums;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_up4(float4 v, int d) {
  return make_float4(__shfl_up_sync(0xffffffffu, v.x, d),
                     __shfl_up_sync(0xffffffffu, v.y, d),
                     __shfl_up_sync(0xffffffffu, v.z, d),
                     __shfl_up_sync(0xffffffffu, v.w, d));
}

__device__ __forceinline__ float4 shfl4(float4 v, int lane) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, lane),
                     __shfl_sync(0xffffffffu, v.y, lane),
                     __shfl_sync(0xffffffffu, v.z, lane),
                     __shfl_sync(0xffffffffu, v.w, lane));
}

// One sample's alpha and sigmoid colors from its logits [r, g, b, opacity]
// and delta = t[p + 1] - t[p] (1e10 at a ray's last sample).
struct Sample {
  float alpha;
  float keep;      // min(1, 1 - alpha + 1e-10): its share of transmittance
  float4 color;    // sigmoid(r, g, b), and 1 where alpha counts (s < S - 1)
  bool head;       // a ray's first sample, or a dead row
  bool last;       // a ray's last sample
};

__device__ __forceinline__ Sample sample_of(float4 logits, float delta,
                                            bool live, int s, int S) {
  Sample x;
  x.head = !live || s == 0;
  x.last = live && s == S - 1;
  x.alpha = 0.0f;
  x.keep = 1.0f;
  x.color = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) {
    if (s == S - 1) delta = 1e10f;
    x.alpha = 1.0f - expf(-(softplus(logits.w) * delta));
    x.keep = fminf(1.0f, 1.0f - x.alpha + 1e-10f);
    x.color = make_float4(sigmoid(logits.x), sigmoid(logits.y),
                          sigmoid(logits.z), s < S - 1 ? 1.0f : 0.0f);
  }
  return x;
}

// w * [r, g, b, alpha-count] of one sample with transmittance `trans`.
__device__ __forceinline__ float4 weighted(const Sample& x, float trans) {
  const float w = x.alpha * trans;
  return make_float4(w * x.color.x, w * x.color.y, w * x.color.z,
                     w * x.color.w);
}

// K3's composite of one piece of a warpgroup, by one encoder warp: rows
// row0 .. row0 + 63 (those below `end` live), piece `piece` of the group
// whose first ray is `group_ray`. Lane l takes rows 2 l and 2 l + 1: their
// depths first (no logits needed), then, once `ready` completes its phase
// of parity `parity`, their logits (at `logits`), their samples, and one
// segmented inclusive scan over the lanes (a segment a ray, a dead row its
// own) of the transmittance product and the four sums. *open carries the
// ray the last piece left open in, and the one this piece leaves open out.
__device__ __forceinline__ void composite_piece(
    const float4* logits, uint32_t ready, uint32_t parity, int lane,
    const RayComposite& rays, long long row0, long long end, int piece,
    long long group_ray, float* __restrict__ out, OpenRay* open) {
  const int S = rays.samples;
  const int ra = 2 * lane;
  const long long pa = row0 + ra;
  const bool live_a = pa < end;
  const bool live_b = pa + 1 < end;
  const int gi = piece * kWgRows + ra;      // row a's index in the group
  const int sa = gi % S;
  const int sb = sa + 1 == S ? 0 : sa + 1;
  const float* t = rays.t_values;
  const float t_a = live_a ? __ldg(t + pa) : 0.0f;
  const float t_b = live_b ? __ldg(t + pa + 1) : 0.0f;
  const float t_next = live_b && sb + 1 < S ? __ldg(t + pa + 2) : 0.0f;
  hopper::mbar_wait(ready, parity);
  const float4 logits_a = logits[ra];
  const float4 logits_b = logits[ra + 1];
  const Sample a = sample_of(logits_a, t_b - t_a, live_a, sa, S);
  const Sample b = sample_of(logits_b, t_next - t_b, live_b, sb, S);
  // the lane's tail segment: its product and sums, the open ray folded
  // into lane 0's when both its rows continue it
  float product = b.head ? b.keep : a.keep * b.keep;
  const bool head = a.head || b.head;
  if (lane == 0 && !head) product = open->t * product;
  // products first: the sums need each row's transmittance
  bool seg = head;
  for (int d = 1; d < 32; d <<= 1) {
    const float lower = __shfl_up_sync(0xffffffffu, product, d);
    const int lower_seg = __shfl_up_sync(0xffffffffu, static_cast<int>(seg),
                                         d);
    if (lane >= d) {
      if (!seg) product = lower * product;
      seg = seg || lower_seg;
    }
  }
  float before = __shfl_up_sync(0xffffffffu, product, 1);
  if (lane == 0) before = open->t;
  const float trans_a = a.head ? 1.0f : before;
  const float trans_b = b.head ? 1.0f : trans_a * a.keep;
  const float4 wa = weighted(a, trans_a);
  const float4 wb = weighted(b, trans_b);
  float4 sums = b.head ? wb : add4(wa, wb);
  if (lane == 0 && !head) sums = add4(open->sums, sums);
  seg = head;
  for (int d = 1; d < 32; d <<= 1) {
    const float4 lower = shfl_up4(sums, d);
    const int lower_seg = __shfl_up_sync(0xffffffffu, static_cast<int>(seg),
                                         d);
    if (lane >= d) {
      if (!seg) sums = add4(lower, sums);
      seg = seg || lower_seg;
    }
  }
  float4 sums_before = shfl_up4(sums, 1);
  if (lane == 0) sums_before = open->sums;
  const long long ray_a = group_ray + gi / S;
  if (a.last) {
    reinterpret_cast<float4*>(out)[ray_a] =
        a.head ? wa : add4(sums_before, wa);
  }
  if (b.last) {
    reinterpret_cast<float4*>(out)[sa + 1 == S ? ray_a + 1 : ray_a] = sums;
  }
  // row 63 (lane 31's b) leaves its ray open unless it is its last sample
  const bool left_open = __shfl_sync(0xffffffffu,
                                     static_cast<int>(live_b && !b.last), 31);
  open->t = left_open ? __shfl_sync(0xffffffffu, product, 31) : 1.0f;
  open->sums = left_open ? shfl4(sums, 31)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// ---------------------------------------------------------------------------
// bf16: the wgmma kernel (the tile's routines are in fused_nerf_wgmma.cuh)
// ---------------------------------------------------------------------------

// full and empty per stage; per consumer warpgroup, ready and free for its
// positional and its view features (K3: and for its logits)
constexpr int kBarrierBytes = (2 * kMaxStages + 8) * 8;
constexpr int kRayBarrierBytes = kBarrierBytes + 2 * 8;

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

template <int C, int kMode, typename Out = PointLogits>
__global__ void __launch_bounds__(kBf16Threads, 1)
fused_nerf_bf16_kernel(const float* __restrict__ positions,
                       const float* __restrict__ views,
                       const float* __restrict__ pos_enc,
                       const float* __restrict__ view_enc,
                       const __nv_bfloat16* __restrict__ slabs,
                       const float* __restrict__ biases,
                       float* __restrict__ out, long long num_points, Desc d,
                       int stages, int act_blocks, Out rays) {
  using M = Mode<kMode>;
  static_assert(!kRays<Out> || kMode == kBase, "K3 runs K1's base mode");
  extern __shared__ __align__(1024) unsigned char bf16_smem[];
  const uint32_t base = (hopper::smem_addr(bf16_smem) + kAlignSlack - 1)
                        & ~static_cast<uint32_t>(kAlignSlack - 1);
  // K3: the same rows as a generic address, for the logits
  unsigned char* const rows = bf16_smem + (base
                                           - hopper::smem_addr(bf16_smem));
  const uint32_t act_bytes = act_blocks * kBlockBytes;   // one warpgroup's
  const uint32_t ring_base = base + 2 * act_bytes;
  const uint32_t stage_bytes = C * 128;
  const uint32_t full = ring_base + stages * stage_bytes;
  const uint32_t empty = full + 8 * kMaxStages;
  // [warpgroup]: features written, features read (for the next tile); K3:
  // the view features are the rays' view products, and a piece's logits
  // are written for the composite
  const uint32_t pos_ready = empty + 8 * kMaxStages;
  const uint32_t pos_free = pos_ready + 16;
  const uint32_t view_ready = pos_free + 16;
  const uint32_t view_free = view_ready + 16;
  const uint32_t logits_ready = view_free + 16;
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
      if constexpr (kRays<Out>) {
        hopper::mbar_init(logits_ready + 8 * w, 128);
      }
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

  const long long num_tiles = tile_count(rays, num_points);
  const int pieces = tile_pieces(rays);
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
        for (int piece = 0; piece < pieces; ++piece) {
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
            long long skip = 0;
            if constexpr (kRays<Out>) {
              if (j == d.num_layers + 2) {
                // K3's hidden layer: the bottleneck's rows only
                skip = static_cast<long long>((K + kSlabK - 1) / kSlabK
                                              - (C + kSlabK - 1) / kSlabK)
                       * bytes;
                K = C;
              }
            }
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
            src += skip;
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
      // K3: between the two, warps 0 and 1 composite the last piece of
      // warpgroups 0 and 1.
      const int warp = (threadIdx.x - 256) / 32 - 1;   // 0..2
      const int lane = threadIdx.x & 31;
      uint32_t parity = 0;
      OpenRay open{1.0f, make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
      long long last_tile = -1;   // K3: the piece not composited yet
      int last_piece = 0;
      auto composite = [&](long long tile, int piece, uint32_t phase) {
        if constexpr (kRays<Out>) {
          if (warp < 2) {
            long long end;
            const long long row0 = piece_rows(rays, tile, piece, warp,
                                              num_points, &end);
            composite_piece(shared_logits(rows + warp * act_bytes, rays, C),
                            logits_ready + 8 * warp, phase, lane, rays, row0,
                            end, piece, (2 * tile + warp) * rays.group_rays,
                            out, &open);
          }
        }
      };
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        for (int piece = 0; piece < pieces; ++piece) {
          for (int w = 0; w < 2; ++w) {
            hopper::mbar_wait(pos_free + 8 * w, parity ^ 1u);
            long long end;
            const long long row0 = piece_rows(rays, tile, piece, w, num_points,
                                              &end);
            if constexpr (M::kAccum) {
              const AccumParts parts = accum_parts(d);
              const uint32_t act = base + w * act_bytes;
              encode_rows_to(positions, row0, end, pos_enc, d.e_pos,
                             d.include_inputs, parts.off[1], parts.off[2],
                             parts.count == 3 ? 3 : 0, C, warp, kEncoderWarps,
                             lane, [act](int row, int col, float v) {
                               st_bf16(act_addr(act, row, col), v);
                             });
            } else {
              encode_rows<M::kSincos>(positions, row0, end, pos_enc, d.e_pos,
                                      d.include_inputs, d.pos_width,
                                      base + w * act_bytes, C, warp,
                                      kEncoderWarps, lane);
            }
            hopper::fence_async_shared();
            hopper::mbar_arrive(pos_ready + 8 * w);
          }
          if constexpr (kRays<Out>) {
            if (last_tile >= 0) composite(last_tile, last_piece, parity ^ 1u);
            last_tile = tile;
            last_piece = piece;
          }
          if constexpr (M::kView) {
            for (int w = 0; w < 2; ++w) {
              hopper::mbar_wait(view_free + 8 * w, parity ^ 1u);
              if constexpr (kRays<Out>) {
                int count;
                const long long ray0 = rays_of_piece(rays, 2 * tile + w, piece,
                                                     &count);
                view_products<C / 2>(
                    views, ray0, count, rays.num_rays, view_enc, d.e_view,
                    d.include_inputs,
                    static_cast<const __nv_bfloat16*>(rays.view_rows),
                    base + w * act_bytes + rays.view_at, warp, kEncoderWarps,
                    lane);
              } else {
                encode_rows(views, tile * kTileRows + w * kWgRows, num_points,
                            view_enc, d.e_view, d.include_inputs, d.view_width,
                            base + w * act_bytes,
                            C + pos_columns(d, kMode), warp, kEncoderWarps,
                            lane);
              }
              hopper::fence_async_shared();
              hopper::mbar_arrive(view_ready + 8 * w);
            }
          }
          parity ^= 1u;
        }
      }
      if constexpr (kRays<Out>) {
        if (last_tile >= 0) composite(last_tile, last_piece, parity ^ 1u);
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
      for (int piece = 0; piece < pieces; ++piece) {
        long long end;
        const long long row0 = piece_rows(rays, tile, piece, wg, num_points,
                                          &end);
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
        if constexpr (kRays<Out>) {
          // hidden layer over the bottleneck; its rows' rays' view products
          // join the sums before the bias
          hopper::mbar_wait(view_ready + 8 * wg, parity);
          layer_product<C / 2>(acc, ring, act, C, C, 0, releases);
          const uint32_t views_at = act + rays.view_at;
          store_layer_view<C / 2>(acc, biases + d.b_off[L + 2],
                                  views_at + view_slot(rays, piece, r0, C),
                                  views_at + view_slot(rays, piece, r0 + 8, C),
                                  act, f, pair);
          if (releases) hopper::mbar_arrive(view_free + 8 * wg);
        } else {
          // hidden layer over [bottleneck | view features]
          hopper::mbar_wait(view_ready + 8 * wg, parity);
          layer_product<C / 2>(acc, ring, act, C + V, C, P, releases);
          if (releases) hopper::mbar_arrive(view_free + 8 * wg);
          store_layer<C / 2, true>(acc, biases + d.b_off[L + 2], act, f, pair);
        }
        rows_ready(barrier_id);
        // color head: columns 0, 1 on lane % 4 == 0, column 2 on the next lane
        layer_product<kHeadWidth>(acc, ring, act, C / 2, C / 2, 0, releases);
        const float* color_bias = biases + d.b_off[L + 3];
        const float blue0 = __shfl_down_sync(0xffffffffu, acc[0], 1);
        const float blue1 = __shfl_down_sync(0xffffffffu, acc[2], 1);
        if constexpr (kRays<Out>) {
          // the logits to the encoders' composite; every thread arrives
          // after its own stores
          if ((lane & 3) == 0) {
            const float b0 = __ldg(color_bias);
            const float b1 = __ldg(color_bias + 1);
            const float b2 = __ldg(color_bias + 2);
            float4* logits = shared_logits(rows + wg * act_bytes, rays, C);
            logits[r0] = make_float4(acc[0] + b0, acc[1] + b1, blue0 + b2,
                                     opacity0);
            logits[r0 + 8] = make_float4(acc[2] + b0, acc[3] + b1,
                                         blue1 + b2, opacity1);
          }
          hopper::mbar_arrive(logits_ready + 8 * wg);
        } else {
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
        }
        parity ^= 1u;
      }
    }
  }
}

// The shared memory of a launch with `act_blocks` blocks of `block_bytes`
// for each warpgroup's rows, a ring of stages of `stage` bytes and
// `barrier_bytes` of mbarriers (0 if two stages do not fit), and the stages
// it gets.
inline size_t ring_shared_bytes(int act_blocks, size_t block_bytes,
                                size_t stage, size_t barrier_bytes,
                                int* stages) {
  const size_t fixed = kAlignSlack + 2ull * act_blocks * block_bytes
                       + barrier_bytes;
  if (fixed + 2 * stage > kSharedLimit) return 0;
  const size_t fit = (kSharedLimit - fixed) / stage;
  *stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  return fixed + *stages * stage;
}

// The shared memory a bf16 launch in `mode` needs (0 if the model does not
// fit with two stages) and the stages it gets.
size_t bf16_shared_bytes(const Desc& d, int mode, int* stages,
                         int* act_blocks) {
  *act_blocks =
      (d.channels + pos_columns(d, mode) + d.view_width + 63) / 64;
  return ring_shared_bytes(*act_blocks, kBlockBytes,
                           static_cast<size_t>(d.channels) * 128,
                           kBarrierBytes, stages);
}

// K3's in bf16: a warpgroup's rows of [h | pos], then its view products, a
// piece's rays' C / 2 bf16 values each (*view_at: their offset), then its
// piece's logits, 64 x 16 bytes.
size_t bf16_ray_shared_bytes(const Desc& d, int piece_rays, int* stages,
                             int* act_blocks, uint32_t* view_at) {
  const int rows = (d.channels + d.pos_width + 63) / 64;
  *view_at = rows * kBlockBytes;
  *act_blocks = rows + (piece_rays * d.channels + kWgRows * 16
                        + kBlockBytes - 1) / kBlockBytes;
  return ring_shared_bytes(*act_blocks, kBlockBytes,
                           static_cast<size_t>(d.channels) * 128,
                           kRayBarrierBytes, stages);
}

template <int C, int kMode, typename Out>
cudaError_t launch_bf16(const void* positions, const void* views,
                        const void* pos_enc, const void* view_enc,
                        const void* slabs, const void* biases, void* out,
                        long long num_points, const Desc& d,
                        cudaStream_t stream, Out rays) {
  static ffn::SharedLimit limit;
  int stages = 0, act_blocks = 0;
  size_t smem;
  if constexpr (kRays<Out>) {
    smem = bf16_ray_shared_bytes(d, rays.piece_rays, &stages, &act_blocks,
                                 &rays.view_at);
  } else {
    smem = bf16_shared_bytes(d, kMode, &stages, &act_blocks);
  }
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = ffn::reserve_shared(fused_nerf_bf16_kernel<C, kMode, Out>,
                                        smem, limit);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = tile_count(rays, num_points);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  fused_nerf_bf16_kernel<C, kMode, Out><<<grid, kBf16Threads, smem, stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(views),
      static_cast<const float*>(pos_enc), static_cast<const float*>(view_enc),
      static_cast<const __nv_bfloat16*>(slabs),
      static_cast<const float*>(biases), static_cast<float*>(out), num_points,
      d, stages, act_blocks, rays);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the 3xTF32 wgmma kernel (the tile's routines are in fused_nerf_tf32.cuh)
// ---------------------------------------------------------------------------

// full and empty per stage; per consumer warpgroup, its features written
// (positional, view) and its feature columns read (K3: and its logits
// written and read)
constexpr int kTf32BarrierBytes = (2 * kMaxStages + 6) * 8;
constexpr int kTf32RayBarrierBytes = kTf32BarrierBytes + 2 * 8;

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

template <int C, int kMode, typename Out>
__global__ void __launch_bounds__(kBf16Threads, 1)
fused_nerf_tf32_kernel(const float* __restrict__ positions,
                       const float* __restrict__ views,
                       const float* __restrict__ pos_enc,
                       const float* __restrict__ view_enc,
                       const float* __restrict__ image,
                       const float* __restrict__ biases,
                       float* __restrict__ out, long long num_points, Desc d,
                       int stages, int act_blocks, long long opacity_at,
                       long long color_at, Out rays) {
  using M = Mode<kMode>;
  static_assert(!M::kAccum, "bf16-accum takes a bf16 pack");
  static_assert(!kRays<Out> || kMode == kBase, "K3 runs K1's base mode");
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
  // no-view: once, after the body). K3: the view features are the rays'
  // view products, read by the hidden layer's epilogue, and a piece's
  // logits are written for the composite.
  const uint32_t pos_ready = empty + 8 * kMaxStages;
  const uint32_t view_ready = pos_ready + 16;
  const uint32_t feat_free = view_ready + 16;
  const uint32_t logits_ready = feat_free + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    for (int w = 0; w < 2; ++w) {
      hopper::mbar_init(pos_ready + 8 * w, kEncoderThreads);
      hopper::mbar_init(view_ready + 8 * w, kEncoderThreads);
      hopper::mbar_init(feat_free + 8 * w, kConsumerWarps / 2);
      if constexpr (kRays<Out>) {
        hopper::mbar_init(logits_ready + 8 * w, 128);
      }
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const long long num_tiles = tile_count(rays, num_points);
  const int pieces = tile_pieces(rays);
  const int L = d.num_layers;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hopper::regs_decrease<kProducerRegs>();
    if (threadIdx.x == 256) {
      // Producer: one thread streams each tile's slabs, the forward part of
      // the image (body, bottleneck, hidden: the heads run on the CUDA
      // cores; no-view: the body; K3: the hidden layer's first C rows),
      // from its start.
      int stage = 0;
      uint32_t phase = 0;
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        for (int piece = 0; piece < pieces; ++piece) {
          const char* src = reinterpret_cast<const char*>(image);
          for (int j = 0; j < (M::kView ? L + 3 : L); ++j) {
            if (j == L) continue;
            int K, N;
            layer_shape(d, j, &K, &N);
            const char* next = nullptr;
            if constexpr (kRays<Out>) {
              if (j == L + 2) {
                next = src + t32::slab_floats(K, N) * 4;
                K = C;
              }
            }
            src = t32::stream_slabs(src, K, N, ring_base, slot_bytes, full,
                                    empty, stages, &stage, &phase);
            if constexpr (kRays<Out>) {
              if (next != nullptr) src = next;
            }
          }
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
      // K3: between the two, warps 0 and 1 composite the last piece of
      // warpgroups 0 and 1.
      const int warp = (threadIdx.x - 256) / 32 - 1;   // 0..2
      const int lane = threadIdx.x & 31;
      uint32_t parity = 0;
      OpenRay open{1.0f, make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
      long long last_tile = -1;   // K3: the piece not composited yet
      int last_piece = 0;
      auto composite = [&](long long tile, int piece, uint32_t phase) {
        if constexpr (kRays<Out>) {
          if (warp < 2) {
            long long end;
            const long long row0 = piece_rows(rays, tile, piece, warp,
                                              num_points, &end);
            composite_piece(scratch_logits(rays, warp),
                            logits_ready + 8 * warp, phase, lane, rays, row0,
                            end, piece, (2 * tile + warp) * rays.group_rays,
                            out, &open);
          }
        }
      };
      for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        for (int piece = 0; piece < pieces; ++piece) {
          for (int w = 0; w < 2; ++w) {
            hopper::mbar_wait(feat_free + 8 * w, M::kView ? 1u : parity ^ 1u);
            long long end;
            const long long row0 = piece_rows(rays, tile, piece, w, num_points,
                                              &end);
            t32::encode_rows_f32<M::kSincos>(
                positions, row0, end, pos_enc, d.e_pos, d.include_inputs,
                d.pos_width, base + w * act_bytes, C, warp, kEncoderWarps,
                lane);
            hopper::mbar_arrive(pos_ready + 8 * w);
          }
          if constexpr (kRays<Out>) {
            if (last_tile >= 0) composite(last_tile, last_piece, parity ^ 1u);
            last_tile = tile;
            last_piece = piece;
          }
          if constexpr (M::kView) {
            for (int w = 0; w < 2; ++w) {
              hopper::mbar_wait(feat_free + 8 * w, 0u);
              if constexpr (kRays<Out>) {
                int count;
                const long long ray0 = rays_of_piece(rays, 2 * tile + w, piece,
                                                     &count);
                view_products<C / 2>(
                    views, ray0, count, rays.num_rays, view_enc, d.e_view,
                    d.include_inputs, static_cast<const float*>(rays.view_rows),
                    base + w * act_bytes + rays.view_at, warp, kEncoderWarps,
                    lane);
              } else {
                t32::encode_rows_f32(views, tile * kTileRows + w * kWgRows,
                                     num_points, view_enc, d.e_view,
                                     d.include_inputs, d.view_width,
                                     base + w * act_bytes, C, warp,
                                     kEncoderWarps, lane);
              }
              hopper::mbar_arrive(view_ready + 8 * w);
            }
          }
          parity ^= 1u;
        }
      }
      if constexpr (kRays<Out>) {
        if (last_tile >= 0) composite(last_tile, last_piece, parity ^ 1u);
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
    for (int piece = 0; piece < pieces; ++piece) {
      long long end;
      const long long row0 = piece_rows(rays, tile, piece, wg, num_points,
                                        &end);
      // body: layer 0 reads the features at column C, a skip layer [h | pos]
      hopper::mbar_wait(pos_ready + 8 * wg, parity);
      for (int i = 0; i < L; ++i) {
        const int K = i == 0 ? P : C + (((d.skip_mask >> i) & 1u) ? P : 0);
        t32::layer_tf32<C>(acc, ring, K,
                           t32::point_major_a(act, warp, lane, i == 0 ? 0 : K,
                                              i == 0 ? C : 0),
                           releases);
        if (i == L - 1 && releases) hopper::mbar_arrive(feat_free + 8 * wg);
        t32::store_f32<C, M::kRelu, M::kBias>(acc, biases + d.b_off[i], act,
                                              r0, pair);
        __syncwarp();
      }
      // opacity head, f32 on the CUDA cores, before the bottleneck overwrites
      // h
      float opacity;
      head_f32<1>(act, C, image + opacity_at, warp, lane, &opacity);
      opacity += __ldg(biases + d.b_off[L]);
      if constexpr (!M::kView) {
        // color = opacity * 0 + color bias (the tool's `opacity * 0.0 +
        // color_b`)
        if ((lane & 1) == 0) {
          const long long g = row0 + 16 * warp + (lane >> 1);
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
      t32::layer_tf32<C>(acc, ring, C,
                         t32::point_major_a(act, warp, lane, C, 0), releases);
      t32::store_f32<C, false>(acc, biases + d.b_off[L + 1], act, r0, pair);
      __syncwarp();
      if constexpr (kRays<Out>) {
        // hidden layer over the bottleneck; its rows' rays' view products
        // join the sums before the bias
        hopper::mbar_wait(view_ready + 8 * wg, parity);
        t32::layer_tf32<C / 2>(acc, ring, C,
                               t32::point_major_a(act, warp, lane, C, 0),
                               releases);
        const uint32_t views_at = act + rays.view_at;
        store_f32_view<C / 2>(acc, biases + d.b_off[L + 2],
                              views_at + view_slot(rays, piece, r0, 2 * C),
                              views_at + view_slot(rays, piece, r0 + 8, 2 * C),
                              act, r0, pair);
        if (releases) hopper::mbar_arrive(feat_free + 8 * wg);
      } else {
        // hidden layer over [bottleneck | view features at column C]
        hopper::mbar_wait(view_ready + 8 * wg, parity);
        t32::layer_tf32<C / 2>(acc, ring, C + V,
                               t32::point_major_a(act, warp, lane, C + V, 0),
                               releases);
        if (releases) hopper::mbar_arrive(feat_free + 8 * wg);
        t32::store_f32<C / 2, true>(acc, biases + d.b_off[L + 2], act, r0,
                                    pair);
      }
      __syncwarp();
      // color head, f32 on the CUDA cores; one float4 a point
      float color[3];
      head_f32<3>(act, C / 2, image + color_at, warp, lane, color);
      const float* color_bias = biases + d.b_off[L + 3];
      if constexpr (kRays<Out>) {
        // the logits to the encoders' composite; every thread arrives after
        // its own stores
        if ((lane & 1) == 0) {
          scratch_logits(rays, wg)[16 * warp + (lane >> 1)] = make_float4(
              color[0] + __ldg(color_bias), color[1] + __ldg(color_bias + 1),
              color[2] + __ldg(color_bias + 2), opacity);
        }
        hopper::mbar_arrive(logits_ready + 8 * wg);
      } else {
        if ((lane & 1) == 0) {
          const long long g = row0 + 16 * warp + (lane >> 1);
          if (g < num_points) {
            reinterpret_cast<float4*>(out)[g] = make_float4(
                color[0] + __ldg(color_bias), color[1] + __ldg(color_bias + 1),
                color[2] + __ldg(color_bias + 2), opacity);
          }
        }
      }
      parity ^= 1u;
    }
  }
}

// The shared memory an f32 launch needs (0 if the model does not fit with
// two stages) and the stages it gets: per warpgroup 64 rows of [h (C) |
// features (the larger of P and V)] in 32-column blocks, then the ring.
size_t tf32_shared_bytes(const Desc& d, int* stages, int* act_blocks) {
  const int features = d.pos_width > d.view_width ? d.pos_width
                                                   : d.view_width;
  *act_blocks = (d.channels + 31) / 32 + (features + 31) / 32;
  return ring_shared_bytes(*act_blocks, ffn::tf32::kBlockBytes,
                           ffn::tf32::stage_bytes(d.channels),
                           kTf32BarrierBytes, stages);
}

// K3's in f32: the feature columns hold the positional features, then a
// piece's rays' view products, C / 2 floats each, from *view_at.
size_t tf32_ray_shared_bytes(const Desc& d, int piece_rays, int* stages,
                             int* act_blocks, uint32_t* view_at) {
  const int h = (d.channels + 31) / 32;
  const int pos = (d.pos_width + 31) / 32;
  const int products = (piece_rays * 2 * d.channels
                        + ffn::tf32::kBlockBytes - 1)
                       / ffn::tf32::kBlockBytes;
  *view_at = h * ffn::tf32::kBlockBytes;
  *act_blocks = h + (pos > products ? pos : products);
  return ring_shared_bytes(*act_blocks, ffn::tf32::kBlockBytes,
                           ffn::tf32::stage_bytes(d.channels),
                           kTf32RayBarrierBytes, stages);
}

template <int C, int kMode, typename Out>
cudaError_t launch_tf32(const void* positions, const void* views,
                        const void* pos_enc, const void* view_enc,
                        const void* image, const void* biases, void* out,
                        long long num_points, const Desc& d,
                        cudaStream_t stream, Out rays) {
  static ffn::SharedLimit limit;
  int stages = 0, act_blocks = 0;
  size_t smem;
  if constexpr (kRays<Out>) {
    smem = tf32_ray_shared_bytes(d, rays.piece_rays, &stages, &act_blocks,
                                 &rays.view_at);
  } else {
    smem = tf32_shared_bytes(d, &stages, &act_blocks);
  }
  if (smem == 0) return cudaErrorInvalidValue;
  cudaError_t err = ffn::reserve_shared(fused_nerf_tf32_kernel<C, kMode, Out>,
                                        smem, limit);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long opacity_at = ffn::tf32::heads_at(d);
  const long long tiles = tile_count(rays, num_points);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  fused_nerf_tf32_kernel<C, kMode, Out><<<grid, kBf16Threads, smem, stream>>>(
      static_cast<const float*>(positions), static_cast<const float*>(views),
      static_cast<const float*>(pos_enc), static_cast<const float*>(view_enc),
      static_cast<const float*>(image), static_cast<const float*>(biases),
      static_cast<float*>(out), num_points, d, stages, act_blocks,
      opacity_at, opacity_at + d.channels * kHeadWidth, rays);
  return cudaGetLastError();
}

// K1's forward in `kMode` (K3: with `rays`) for any channel width the
// kernels take: `weights` the bf16 pack's slab image (weight_dtype 1;
// bf16-accum: its accum image) or the f32 pack's f32 slab image
// (weight_dtype 0).
template <int kMode, typename Out = PointLogits>
cudaError_t launch_forward(const void* positions, const void* views,
                           const void* pos_enc, const void* view_enc,
                           const void* weights, const void* biases, void* out,
                           long long num_points, const Desc& d,
                           int weight_dtype, cudaStream_t s,
                           Out rays = Out()) {
  if (weight_dtype == 1) {
    switch (d.channels) {
#define FFN_BF16_CASE(C)                                                     \
  case C:                                                                    \
    return launch_bf16<C, kMode>(positions, views, pos_enc, view_enc,        \
                                 weights, biases, out, num_points, d, s,     \
                                 rays);
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
                                 weights, biases, out, num_points, d, s,     \
                                 rays);
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
