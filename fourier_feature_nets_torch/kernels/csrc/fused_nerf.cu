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

// The two kernels are templates over the ablation mode of P2
// (fused_nerf_forward.cuh); K1 is their kBase instantiation.

#include "fused_nerf_forward.cuh"

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
  return static_cast<int>(launch_forward<kBase>(
      positions, views, pos_enc, view_enc, weights, biases, out, num_points,
      d, weight_dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* fused_nerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
