// The int8 tensor-core probe for Hopper (sm_90a): three kernels.
//
// Replaces the TPU Pallas kernels of tools/int8_probe.py::main:
//   P1a  k_int8 (pallas_call :41): int8 W (M, K) @ int8 h (K, N) -> int32,
//        exact;
//   P1b  k_quant (pallas_call :74): f32 x (K, N) -> scale = max|x| / 127 +
//        1e-30, q = round(x / scale) as int8, int8 W (M, K) @ q -> int32,
//        times scale -> f32;
//   P1c  stack_kernel (pallas_call :119): L chained layers
//        h <- cast(max(W_l @ h, 0)), W_l (C, C), h (C, N), bf16 with f32
//        accumulation or int8 with int32 accumulation (the int8 cast wraps,
//        two's complement, as astype(int8) and Tensor.to(torch.int8) do);
//        writes h as f32 (C, N).
// The layout is the JAX tool's: W (rows = outputs, cols = inputs) @ h.
//
// What bounds them on an H100. At the probe's shapes none of them is near
// a roofline: P1a and P1b move ~0.2-0.3 MB and do ~8 MOP (under 0.1 us of
// HBM time and under 0.01 us of int8 tensor-core time), and P1c's chain of
// eight 192x192 @ 192x2048 products is 1.21 GOP (0.61 us at the int8 peak,
// 1.22 us at the bf16 peak) over ~2.3-3 MB. Latency bounds them: the launch,
// the round trips to memory, and in P1c the serial dependence from one layer
// to the next, each layer a short product that every block of a cluster
// must finish before any block starts the next.
//
// P1a and P1b share one kernel, built for that latency. A block owns a
// 32x32 output tile, so the tool's (128, 128) @ (128, 256) spreads over 32
// blocks, and stages K 128 bytes at a time: at K <= 128 one stage holds the
// whole product, with one barrier between the copies and the products. W's
// rows go to shared memory as 16-byte cp.async copies (zero-filled past M
// and K) into rows padded to 144 bytes, so the eight rows an ldmatrix reads
// start on distinct banks. The int8 tensor-core instruction, mma.sync
// m16n8k32, takes B K-contiguous and B's source is N-contiguous: each thread
// reads four consecutive rows of 8 columns, transposes each 4x4 byte block
// with __byte_perm and stores B^T as (N, K) rows. ldmatrix.x4 feeds A and B;
// each of the four warps owns a 16x16 quarter of the tile as two n8
// accumulators, stored from registers in pairs. A byte-wise path inside the
// kernel stages W when its base or K is not 16-byte aligned and B when its
// base or N is not aligned (the tool's ragged (100, 72, 250) takes both);
// the edge stores are masked. The B source is a compile-time policy:
// * P1a (Int8Source): int8 h, 8 bytes a row piece;
// * P1b (QuantSource): f32 x, quantized as the block stages it. Every block
//   needs max|x| first, so each reduces all of x itself (128 KB at the
//   tool's shape, from L2 after the first block's reads: no second launch
//   and no exchange between blocks), then quantizes each value as it loads
//   it (32 bytes a row piece, IEEE division and round-half-even, as
//   jnp.round: this file must not be built with --use_fast_math) and
//   dequantizes in the epilogue, int32 sum times scale in f32.
// P1c spreads the chain over the card (its first design, a block a
// 64-column slab of h that copied each layer's whole W into shared memory
// and ran WMMA, gave 32 blocks for 132 SMs at the tool's N = 2048 and took
// 81.0 us int8 and 102.2 us bf16 a call, H100 80GB HBM3 at 700 W). Now:
// * points are wgmma's rows: a layer is D^T (64 points x C) = h^T W^T, A =
//   h^T and B = W's rows as they lie in memory, both K-major, so neither is
//   transposed (the s8 wgmma reads only K-major operands); h0 is transposed
//   once as a block loads it, the output once on its f32 store;
// * a cluster of 4 blocks (2 when C is an odd multiple of 32, else 1) owns
//   a 64-point tile, each block a slice of C / 4 output channels: 128
//   blocks at the tool's (192, 2048, 8); each keeps its slices of the
//   next layers' W in a ring of shared memory, copied with cp.async ahead
//   of the layer that reads them, as many as fit in half an SM's shared
//   memory (3 layers bf16, 6 int8 at the tool's shape) so that two blocks
//   fit an SM and the clusters pack onto the GPCs;
// * each layer's epilogue (ReLU, the cast: bf16 rounds, int8 wraps) writes
//   the block's slice of the next layer's A rows into its own shared
//   memory, then sends the slice 16 bytes at a time into every other
//   block of the cluster through distributed shared memory (st.async,
//   two A buffers, ping-pong), each store counted on the receiver's
//   mbarrier for that buffer, so a block starts a layer once its peers'
//   bytes have landed, with no cluster barrier between layers; a peer
//   writes a buffer only after it has received this block's next slice,
//   which this block sends only once its products have read that buffer.
//   What bounds the chain is that exchange and the product's latency, L
//   times.
// The kernels launch on the caller's stream and allocate nothing; each
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "shared_limit.cuh"

namespace {

constexpr int kMaxChannels = 256;   // P1c

// --- P1a and P1b --------------------------------------------------------------

constexpr int kMmaTile = 32;             // output tile side
constexpr int kMmaThreads = 128;         // 4 warps, a 16x16 quarter each
constexpr int kMmaK = 128;               // K bytes staged at a time
constexpr int kMmaPitch = kMmaK + 16;    // padded shared row, 16-byte aligned

static_assert((kMmaK / 4) * (kMmaTile / 8) == kMmaThreads,
              "stage_b gives each thread 4 rows x 8 columns of B");

struct MmaShared {
  __align__(16) signed char a[kMmaTile * kMmaPitch];    // W (m, k)
  __align__(16) signed char bt[kMmaTile * kMmaPitch];   // B^T (n, k)
};

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `bytes` of 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(shared_address(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// Four 8x8 matrices of 16-bit elements (8 rows of 16 bytes each); lanes
// 8q..8q+7 give the row addresses of matrix q, and each lane receives the
// 4-byte word (lane % 4) of row lane / 4 of every matrix.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_address(row))
      : "memory");
}

// d += a (16x32, row) @ b (32x8, col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of a 4x4 byte block: r[i] holds bytes (i, 0..3), c[j]
// gets bytes (0..3, j), both little-endian.
__device__ __forceinline__ void transpose4x4(const unsigned (&r)[4],
                                             unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);   // r0.0 r1.0 r0.1 r1.1
  const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);   // r0.2 r1.2 r0.3 r1.3
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// W rows m0.. and columns k0.. of one stage into s.a, zero past M and K.
__device__ __forceinline__ void stage_w(const signed char* __restrict__ w,
                                        int M, int K, int m0, int k0,
                                        bool vector, MmaShared& s) {
  if (vector) {   // w and K 16-byte aligned: a piece is all in or all out
    constexpr int kPieces = kMmaK / 16;
    for (int idx = threadIdx.x; idx < kMmaTile * kPieces;
         idx += kMmaThreads) {
      const int r = idx / kPieces;
      const int k = k0 + (idx % kPieces) * 16;
      const bool live = m0 + r < M && k < K;
      cp_async16(s.a + r * kMmaPitch + k - k0,
                 live ? w + static_cast<long long>(m0 + r) * K + k : w,
                 live ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kMmaTile * kMmaK; idx += kMmaThreads) {
    const int r = idx / kMmaK;
    const int c = idx % kMmaK;
    s.a[r * kMmaPitch + c] =
        m0 + r < M && k0 + c < K
            ? w[static_cast<long long>(m0 + r) * K + k0 + c] : 0;
  }
}

// B's source. P1a: int8 h (K, N) as it lies in memory.
struct Int8Source {
  const signed char* __restrict__ h;

  // Nothing to do before the product.
  __device__ __forceinline__ void prepare(int, int, MmaShared&) {}
  // Row k's bytes of columns n .. n + 7 at offset k N + n (vector path:
  // 8-byte aligned, all in).
  __device__ __forceinline__ uint2 load8(long long offset) const {
    return __ldg(reinterpret_cast<const uint2*>(h + offset));
  }
  __device__ __forceinline__ signed char at(long long offset) const {
    return h[offset];
  }
  // An int32 sum as it is stored.
  __device__ __forceinline__ int finish(int v) const { return v; }
};

// P1b: f32 x (K, N), each value round(x / scale) as int8, with scale =
// max|x| / 127 + 1e-30 found by prepare; sums are stored times scale.
struct QuantSource {
  const float* __restrict__ x;
  float scale;

  // scale, from every value of x: each thread's max of |x| over every
  // 128th float4 (or value, at a base that is not 16-byte aligned), then
  // the warps' maxima through shared memory.
  __device__ __forceinline__ void prepare(int K, int N, MmaShared& s) {
    const long long count = static_cast<long long>(K) * N;
    float m = 0.0f;
    long long i = threadIdx.x;
    if (reinterpret_cast<std::uintptr_t>(x) % 16 == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 8
      for (; i < count / 4; i += kMmaThreads) {
        const float4 v = __ldg(x4 + i);
        m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                           fmaxf(fabsf(v.z), fabsf(v.w))));
      }
      i = count / 4 * 4 + threadIdx.x;   // the last count % 4 values
    }
    for (; i < count; i += kMmaThreads) m = fmaxf(m, fabsf(__ldg(x + i)));
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
    }
    float* warp_max = reinterpret_cast<float*>(s.bt);
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
    __syncthreads();
    m = fmaxf(fmaxf(warp_max[0], warp_max[1]),
              fmaxf(warp_max[2], warp_max[3]));
    scale = m / 127.0f + 1e-30f;   // IEEE division, as jnp
    __syncthreads();   // warp_max is read before s.bt is staged
  }
  __device__ __forceinline__ uint32_t quantize(float v) const {
    return static_cast<uint32_t>(static_cast<unsigned char>(
        static_cast<signed char>(__float2int_rn(v / scale))));
  }
  __device__ __forceinline__ uint32_t quantize4(float4 v) const {
    return quantize(v.x) | (quantize(v.y) << 8) | (quantize(v.z) << 16)
           | (quantize(v.w) << 24);
  }
  // (vector path: x 16-byte aligned and N a multiple of 8)
  __device__ __forceinline__ uint2 load8(long long offset) const {
    const float4* p = reinterpret_cast<const float4*>(x + offset);
    return make_uint2(quantize4(__ldg(p)), quantize4(__ldg(p + 1)));
  }
  __device__ __forceinline__ signed char at(long long offset) const {
    return static_cast<signed char>(__float2int_rn(x[offset] / scale));
  }
  __device__ __forceinline__ float finish(int v) const {
    return static_cast<float>(v) * scale;
  }
};

// B rows k0.. and columns n0.. of one stage, transposed into s.bt.
template <typename Source>
__device__ __forceinline__ void stage_b(const Source& src, int K, int N,
                                        int n0, int k0, bool vector,
                                        MmaShared& s) {
  if (vector) {   // a row piece of 8 columns is all in or all out
    // thread: rows k0 + 4 * kg .. + 3, columns n0 + 8 * ng .. + 7
    const int kg = threadIdx.x / 4;
    const int ng = threadIdx.x % 4;
    const int n = n0 + ng * 8;
    unsigned lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + kg * 4 + i;
      uint2 v = make_uint2(0u, 0u);
      if (k < K && n < N) v = src.load8(static_cast<long long>(k) * N + n);
      lo[i] = v.x;
      hi[i] = v.y;
    }
    unsigned c[4];
    transpose4x4(lo, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<unsigned*>(s.bt + (ng * 8 + j) * kMmaPitch
                                   + kg * 4) = c[j];
    }
    transpose4x4(hi, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<unsigned*>(s.bt + (ng * 8 + 4 + j) * kMmaPitch
                                   + kg * 4) = c[j];
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kMmaTile * kMmaK; idx += kMmaThreads) {
    const int kk = idx / kMmaTile;
    const int c = idx % kMmaTile;
    s.bt[c * kMmaPitch + kk] =
        k0 + kk < K && n0 + c < N
            ? src.at(static_cast<long long>(k0 + kk) * N + n0 + c) : 0;
  }
}

__device__ __forceinline__ void store2(int* p, int v0, int v1) {
  *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// out[r, c..c+1] = (v0, v1), masked to (M, N); one 8-byte store where it
// can.
template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ out, int M, int N,
                                           int r, int c, T v0, T v1,
                                           bool vector) {
  if (r >= M || c >= N) return;
  T* p = out + static_cast<long long>(r) * N + c;
  if (vector) {   // N even and out 8-byte aligned: c + 1 < N too
    store2(p, v0, v1);
    return;
  }
  p[0] = v0;
  if (c + 1 < N) p[1] = v1;
}

// out (M, N) = W (M, K) @ B (K, N), B from `src`, each sum finished by
// src.finish: one 32x32 tile a block.
template <typename Source, typename T>
__global__ void __launch_bounds__(kMmaThreads)
int8_matmul_kernel(const signed char* __restrict__ w, Source src,
                   T* __restrict__ out, int M, int K, int N, bool w_vector,
                   bool b_vector, bool out_vector) {
  __shared__ MmaShared s;
  const int m0 = blockIdx.y * kMmaTile;
  const int n0 = blockIdx.x * kMmaTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 16;   // the warp's quarter of the tile
  const int wn = (warp % 2) * 16;
  int acc[2][4] = {};
  src.prepare(K, N, s);
  for (int k0 = 0; k0 < K; k0 += kMmaK) {
    stage_w(w, M, K, m0, k0, w_vector, s);
    stage_b(src, K, N, n0, k0, b_vector, s);
    cp_async_wait_all();
    __syncthreads();
    const int depth = K - k0 < kMmaK ? K - k0 : kMmaK;   // zeros beyond
    for (int kk = 0; kk < depth; kk += 32) {
      unsigned a[4], b[4];
      // A: rows wm + (lane % 16), bytes kk + 16 * (lane / 16)
      ldmatrix_x4(a, s.a + (wm + lane % 16) * kMmaPitch + kk
                         + (lane / 16) * 16);
      // B: matrix q = lane / 8 is n8 tile q / 2, k half q % 2
      ldmatrix_x4(b, s.bt + (wn + (lane / 16) * 8 + lane % 8) * kMmaPitch
                          + kk + ((lane / 8) % 2) * 16);
      mma_s8(acc[0], a, b[0], b[1]);
      mma_s8(acc[1], a, b[2], b[3]);
    }
    if (k0 + kMmaK < K) __syncthreads();   // the stage is restaged
  }
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = n0 + wn + j * 8 + 2 * t;
    store_pair(out, M, N, m0 + wm + g, c, src.finish(acc[j][0]),
               src.finish(acc[j][1]), out_vector);
    store_pair(out, M, N, m0 + wm + g + 8, c, src.finish(acc[j][2]),
               src.finish(acc[j][3]), out_vector);
  }
}

template <typename Source, typename T>
cudaError_t launch_matmul(const void* w, Source src, void* out, int M, int K,
                          int N, bool b_vector, cudaStream_t stream) {
  const auto address = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  const bool w_vector = address(w) % 16 == 0 && K % 16 == 0;
  const bool out_vector = address(out) % 8 == 0 && N % 2 == 0;
  const dim3 grid((N + kMmaTile - 1) / kMmaTile, (M + kMmaTile - 1) / kMmaTile);
  int8_matmul_kernel<Source, T><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const signed char*>(w), src, static_cast<T*>(out), M, K, N,
      w_vector, b_vector, out_vector);
  return cudaGetLastError();
}

// --- P1c ----------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
template <>
__device__ __forceinline__ signed char zero_of<signed char>() { return 0; }

// cast(max(acc, 0)): bf16 rounds to nearest even; int8 wraps mod 256.
__device__ __forceinline__ __nv_bfloat16 relu_cast(float v) {
  return __float2bfloat16_rn(fmaxf(v, 0.0f));
}
__device__ __forceinline__ signed char relu_cast(int v) {
  return static_cast<signed char>(static_cast<unsigned>(v > 0 ? v : 0)
                                  & 0xffu);
}

constexpr int kStackRows = 64;        // points of a tile: wgmma's M
constexpr int kStackThreads = 128;    // one warpgroup
constexpr int kStackMaxStages = 8;
constexpr uint32_t kStackBlock = kStackRows * 128;   // 128 K-bytes of a tile
constexpr int kStackSlack = 1024;     // swizzled blocks start 1024-aligned
constexpr size_t kStackSharedLimit = 232448;   // 227 KB a block
constexpr int kStackBarrierBytes = 16;     // ready[2], after the ring

// How a (C, N, L) stack is cut: blocks of a cluster share a 64-point tile,
// each computing `slice` of the C output channels; K (C inputs) is padded
// to whole 32-byte wgmma steps; the ring holds `stages` layers' slices.
struct StackPlan {
  int cluster;        // blocks a tile: 4, 2 or 1
  int slice;          // output channels a block, a multiple of 16
  int k_bytes;        // C * sizeof(T) rounded up to 32
  int k_blocks;       // 128-byte column blocks of A and of a slice
  int stages;         // layers' weight slices resident at once
  size_t smem;        // dynamic shared memory of a block
};

__host__ __device__ inline int stack_cluster(int C) {
  return C % 64 == 0 ? 4 : C % 32 == 0 ? 2 : 1;
}

// The plan of a stack in elements of `size` bytes: two A buffers (the
// layer's input h^T and the next layer's, 64 rows of k_blocks blocks), then
// the ring. Up to 8 layers' slices are kept; a plan takes as many as fit in
// half the SM's shared memory (two blocks an SM, so clusters pack onto the
// GPCs), or in all of it if fewer than two layers' slices fit there.
inline StackPlan stack_plan(int C, int L, int size) {
  StackPlan p;
  p.cluster = stack_cluster(C);
  p.slice = C / p.cluster;
  p.k_bytes = (C * size + 31) / 32 * 32;
  p.k_blocks = (p.k_bytes + 127) / 128;
  const size_t fixed = kStackSlack + 2ull * p.k_blocks * kStackBlock
                       + kStackBarrierBytes;
  const size_t slice_bytes = static_cast<size_t>(p.k_blocks) * p.slice * 128;
  const int want = L < 1 ? 1 : L < kStackMaxStages ? L : kStackMaxStages;
  const size_t half = kStackSharedLimit / 2;
  int fit = static_cast<int>((half - fixed) / slice_bytes);
  if (fit < (want < 2 ? want : 2)) {
    fit = static_cast<int>((kStackSharedLimit - fixed) / slice_bytes);
  }
  p.stages = fit < want ? fit : want;
  p.smem = fixed + p.stages * slice_bytes;
  return p;
}

// The byte address of (row, byte column) of a swizzled operand whose
// 128-byte column blocks hold `rows` rows each.
__device__ __forceinline__ uint32_t swizzled(uint32_t base, int row, int col,
                                             int rows) {
  return base + (col >> 7) * rows * 128 + row * 128
         + ((((col >> 4) & 7) ^ (row & 7)) << 4) + (col & 15);
}

// (No memory clobber: the loads of h0 may move ahead of these stores; the
// barrier after them orders them before any read.)
__device__ __forceinline__ void st_shared_elem(uint32_t addr,
                                               __nv_bfloat16 v) {
  asm volatile("st.shared.b16 [%0], %1;\n"
               :: "r"(addr), "h"(*reinterpret_cast<const uint16_t*>(&v)));
}
__device__ __forceinline__ void st_shared_elem(uint32_t addr, signed char v) {
  asm volatile("st.shared.b8 [%0], %1;\n"
               :: "r"(addr), "h"(static_cast<uint16_t>(
                   static_cast<unsigned char>(v))));
}

__device__ __forceinline__ float ld_shared_float(uint32_t addr,
                                                 const __nv_bfloat16*) {
  uint16_t bits;
  asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(bits) : "r"(addr)
               : "memory");
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(&bits));
}
__device__ __forceinline__ float ld_shared_float(uint32_t addr,
                                                 const signed char*) {
  uint16_t bits;
  asm volatile("ld.shared.s8 %0, [%1];\n" : "=h"(bits) : "r"(addr)
               : "memory");
  return static_cast<float>(static_cast<short>(bits));
}

// Two adjacent outputs cast and packed as the bytes they take in h.
__device__ __forceinline__ uint32_t pack_pair(float a, float b) {
  const __nv_bfloat16 x = relu_cast(a);
  const __nv_bfloat16 y = relu_cast(b);
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&x))
         | (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&y))
            << 16);
}
__device__ __forceinline__ uint32_t pack_pair(int a, int b) {
  return static_cast<uint32_t>(static_cast<unsigned char>(relu_cast(a)))
         | (static_cast<uint32_t>(static_cast<unsigned char>(relu_cast(b)))
            << 8);
}

// Waits until at most `pending` of this thread's cp.async groups are
// outstanding (0..kStackMaxStages - 1).
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// T: bf16 with f32 sums, or signed char with s32 sums; NC: the block's
// slice of output channels. Cluster c of the grid owns points [64c, 64c +
// 64); its block of rank r computes output channels [r NC, r NC + NC) of
// every layer, as D^T (64 points x NC) = h^T (64 x C) W_slice^T: A is h^T,
// K-major (a point's C inputs contiguous), B is the slice's rows of W as
// they lie in memory (an output's C inputs contiguous), so neither operand
// is transposed and the s8 wgmma, which reads both K-major, takes them.
template <typename T, int NC>
__global__ void __launch_bounds__(kStackThreads, 1)
layer_stack_kernel(const T* __restrict__ h0, const T* __restrict__ ws,
                   float* __restrict__ out, int C, int N, int L, int cluster,
                   int k_bytes, int k_blocks, int stages) {
  using Acc = typename std::conditional<std::is_same<T, signed char>::value,
                                        int, float>::type;
  constexpr int kSize = sizeof(T);
  extern __shared__ __align__(1024) unsigned char stack_smem[];
  const uint32_t base = (hopper::smem_addr(stack_smem) + kStackSlack - 1)
                        & ~static_cast<uint32_t>(kStackSlack - 1);
  const uint32_t a_bytes = k_blocks * kStackBlock;
  const uint32_t ring = base + 2 * a_bytes;
  const uint32_t slice_bytes = k_blocks * NC * 128;
  // ready[b]: the peers' slices of the A rows in buffer b have landed
  const uint32_t ready = ring + stages * slice_bytes;
  const uint32_t rank = cluster > 1 ? hopper::cluster_rank() : 0;
  const long long p0 = static_cast<long long>(blockIdx.x / cluster)
                       * kStackRows;
  const int n0 = rank * NC;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  // Layer l's slice of W (rows n0 .. n0 + NC - 1, C inputs each) into ring
  // stage l % stages, one cp.async group, 16 bytes a copy: chunk q of a row
  // at chunk q ^ (row % 8) of its 128-byte block row; chunks past C * size
  // (an int8 C that is an odd multiple of 16) are zero-filled.
  const int row_chunks = k_bytes / 16;
  auto load_slice = [&](int l) {
    if (l < L) {
      const char* src = reinterpret_cast<const char*>(
          ws + (static_cast<long long>(l) * C + n0) * C);
      const uint32_t dst = ring + (l % stages) * slice_bytes;
      for (int i = t; i < NC * row_chunks; i += kStackThreads) {
        const int row = i / row_chunks;
        const int q = i - row * row_chunks;
        const bool live = q * 16 < C * kSize;
        const char* from = live ? src + static_cast<long long>(row) * C * kSize
                                      + q * 16
                                : src;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(swizzled(dst, row, q * 16, NC)), "l"(from),
                        "r"(live ? 16 : 0)
                     : "memory");
      }
    }
    cp_async_commit();   // one group a layer, empty past L
  };
  // layer 0's slice first; the others after h0's loads, which would
  // otherwise queue behind them (their issue alone takes microseconds)
  load_slice(0);

  // h0's 64 columns of this tile, transposed into A buffer 0 (zeros past N
  // and in the pad columns, which buffer 1 gets too). Where h0's rows are
  // 16-byte aligned and the tile is whole, a thread reads 16 bytes of one
  // channel (kVec points) at a time, the loads of a batch issued before
  // any of their stores; else one element at a time.
  constexpr int kVec = 16 / kSize;
  const int k_cols = k_bytes / kSize;
  const bool vector = reinterpret_cast<std::uintptr_t>(h0) % 16 == 0
                      && (static_cast<long long>(N) * kSize) % 16 == 0
                      && p0 + kStackRows <= N;
  if (vector) {
    constexpr int kGroups = kStackRows / kVec;   // vectors a channel
    constexpr int kBatch = 4;
    for (int i0 = t; i0 < C * kGroups; i0 += kBatch * kStackThreads) {
      int4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kStackThreads;
        if (i < C * kGroups) {
          v[b] = __ldg(reinterpret_cast<const int4*>(
              h0 + static_cast<long long>(i / kGroups) * N + p0
              + (i % kGroups) * kVec));
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kStackThreads;
        if (i < C * kGroups) {
          const T* e = reinterpret_cast<const T*>(&v[b]);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            st_shared_elem(swizzled(base, (i % kGroups) * kVec + j,
                                    (i / kGroups) * kSize, kStackRows),
                           e[j]);
          }
        }
      }
    }
  }
  for (int i = t; i < k_cols * kStackRows; i += kStackThreads) {
    const int c = i / kStackRows;
    const int p = i - c * kStackRows;
    if (vector && c < C) continue;
    T v = zero_of<T>();
    if (c < C && p0 + p < N) v = h0[static_cast<long long>(c) * N + p0 + p];
    st_shared_elem(swizzled(base, p, c * kSize, kStackRows), v);
    if (c >= C) {
      st_shared_elem(swizzled(base + a_bytes, p, c * kSize, kStackRows), v);
    }
  }
  for (int l = 1; l < stages; ++l) load_slice(l);
  if (t == 0) {
    hopper::mbar_init(ready, 1);
    hopper::mbar_init(ready + 8, 1);
    hopper::mbar_fence_init();
  }
  hopper::fence_async_shared();
  // the peers run, their barriers are initialised, every A_0 row is written
  hopper::cluster_sync();

  const int r0 = 16 * warp + (lane >> 2);
  const int pair = 2 * (lane & 3);
  // the bytes of A_{l+1} the peers send this block each layer
  const uint32_t incoming = (cluster - 1) * kStackRows * NC * kSize;
  uint32_t parity = 0;   // bit b: the phase of ready[b] to wait for
  int cur = 0;
  Acc acc[NC / 2];
  for (int l = 0; l < L; ++l) {
    const uint32_t a = base + cur * a_bytes;
    const uint32_t b = ring + (l % stages) * slice_bytes;
    if (l > 0) {   // the peers' slices of A_l
      hopper::mbar_wait(ready + 8 * cur, (parity >> cur) & 1u);
      parity ^= 1u << cur;
    }
    cp_async_wait_pending(stages - 1);   // this thread's copies of layer l
    hopper::fence_async_shared();
    __syncthreads();   // every thread's copies of layer l
    hopper::fence_registers<NC / 2>(acc);
    hopper::wgmma_fence();
    for (int k = 0; k < k_bytes; k += 32) {
      const uint64_t da = hopper::desc_sw128(a + (k >> 7) * kStackBlock
                                             + (k & 127));
      const uint64_t db = hopper::desc_sw128(b + (k >> 7) * NC * 128
                                             + (k & 127));
      if constexpr (std::is_same<T, signed char>::value) {
        hopper::mma_s8<NC>(acc, da, db, k > 0);
      } else {
        hopper::mma<NC>(acc, da, db, k > 0);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_registers<NC / 2>(acc);
    // cast(max(acc, 0)) into this block's slice of the next A buffer, then
    // the slice, 16 bytes at a time, into every other block of the cluster
    // (a 2- or 4-byte remote store each would be six times the
    // transactions)
    const uint32_t next = base + (cur ^ 1) * a_bytes;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v = pack_pair(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        const uint32_t addr = swizzled(next, r0 + 8 * h,
                                       (n0 + 8 * j + pair) * kSize,
                                       kStackRows);
        if constexpr (kSize == 2) {
          asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v)
                       : "memory");
        } else {
          asm volatile("st.shared.b16 [%0], %1;\n"
                       :: "r"(addr), "h"(static_cast<uint16_t>(v))
                       : "memory");
        }
      }
    }
    hopper::fence_async_shared();
    __syncthreads();   // the slice is whole; every product of layer l done
    const uint32_t arrived = ready + 8 * (cur ^ 1);
    if (t == 0) hopper::mbar_arrive_expect_tx(arrived, incoming);
    constexpr int kSliceChunks = NC * kSize / 16;   // a row's 16-byte chunks
    for (int i = t; i < kStackRows * kSliceChunks; i += kStackThreads) {
      const int row = i / kSliceChunks;
      const uint32_t addr = swizzled(next, row,
                                     n0 * kSize + (i % kSliceChunks) * 16,
                                     kStackRows);
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(addr) : "memory");
      for (int peer = 1; peer < cluster; ++peer) {
        const uint32_t to = (rank + peer) % cluster;
        hopper::st_async_v4(hopper::map_shared(addr, to), v,
                            hopper::map_shared(arrived, to));
      }
    }
    load_slice(l + stages);   // the stage of layer l is free
    cur ^= 1;
  }
  if (L > 0) hopper::mbar_wait(ready + 8 * cur, (parity >> cur) & 1u);
  // h as f32 (C, N): this block's channels, points contiguous
  const uint32_t a = base + cur * a_bytes;
  for (int i = t; i < NC * kStackRows; i += kStackThreads) {
    const int c = i / kStackRows;
    const int p = i - c * kStackRows;
    if (p0 + p < N) {
      out[static_cast<long long>(n0 + c) * N + p0 + p] = ld_shared_float(
          swizzled(a, p, (n0 + c) * kSize, kStackRows),
          static_cast<const T*>(nullptr));
    }
  }
  cp_async_wait_pending(0);
  hopper::cluster_sync();   // no block leaves while a peer may write to it
}

template <typename T, int NC>
cudaError_t launch_stack(const void* h0, const void* ws, void* out, int C,
                         int N, int L, cudaStream_t stream) {
  static ffn::SharedLimit limit;
  const StackPlan p = stack_plan(C, L, sizeof(T));
  if (p.stages < 1) return cudaErrorInvalidValue;
  const cudaError_t err =
      ffn::reserve_shared(layer_stack_kernel<T, NC>, p.smem, limit);
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(N) + kStackRows - 1)
                          / kStackRows;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles * p.cluster));
  config.blockDim = dim3(kStackThreads);
  config.dynamicSmemBytes = p.smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = p.cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  cudaError_t launched = cudaLaunchKernelEx(
      &config, layer_stack_kernel<T, NC>, static_cast<const T*>(h0),
      static_cast<const T*>(ws), static_cast<float*>(out), C, N, L,
      p.cluster, p.k_bytes, p.k_blocks, p.stages);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stack_slice(const void* h0, const void* ws, void* out,
                               int C, int N, int L, cudaStream_t stream) {
  switch (C / stack_cluster(C)) {
#define FFN_STACK_CASE(NC)                                                   \
  case NC:                                                                   \
    return launch_stack<T, NC>(h0, ws, out, C, N, L, stream);
    FFN_STACK_CASE(16)
    FFN_STACK_CASE(32)
    FFN_STACK_CASE(48)
    FFN_STACK_CASE(64)
    FFN_STACK_CASE(80)
    FFN_STACK_CASE(112)
    FFN_STACK_CASE(144)
    FFN_STACK_CASE(176)
    FFN_STACK_CASE(208)
    FFN_STACK_CASE(240)
#undef FFN_STACK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// P1a: w (M, K) int8 @ h (K, N) int8 -> out (M, N) int32.
extern "C" int int8_matmul(const void* w, const void* h, void* out, int M,
                           int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool h_vector = reinterpret_cast<std::uintptr_t>(h) % 8 == 0
                        && N % 8 == 0;
  return static_cast<int>(launch_matmul<Int8Source, int>(
      w, Int8Source{static_cast<const signed char*>(h)}, out, M, K, N,
      h_vector, static_cast<cudaStream_t>(stream)));
}

// P1b: x (K, N) f32, w (M, K) int8 -> out (M, N) f32, over P1a's grid.
extern "C" int quantized_matmul(const void* x, const void* w, void* out, int M,
                                int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool x_vector = reinterpret_cast<std::uintptr_t>(x) % 16 == 0
                        && N % 8 == 0;
  return static_cast<int>(launch_matmul<QuantSource, float>(
      w, QuantSource{static_cast<const float*>(x), 0.0f}, out, M, K, N,
      x_vector, static_cast<cudaStream_t>(stream)));
}

// P1c: h0 (C, N), ws (L, C, C) -> out (C, N) f32. dtype: 0 = int8, 1 = bf16.
extern "C" int layer_stack(const void* h0, const void* ws, void* out, int C,
                           int N, int L, int dtype, void* stream) {
  if (C <= 0 || C % 16 != 0 || C > kMaxChannels || N <= 0 || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = launch_stack_slice<__nv_bfloat16>(h0, ws, out, C, N, L, s);
  } else if (dtype == 0) {
    err = launch_stack_slice<signed char>(h0, ws, out, C, N, L, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// P1c's launch for (C, N, L, dtype) as layer_stack makes it: plan[0] the
// blocks of the grid, [1] the blocks of a cluster, [2] the layers' weight
// slices a block keeps at once, [3] its dynamic shared memory in bytes.
// Launches nothing.
extern "C" int layer_stack_plan(int C, int N, int L, int dtype,
                                long long* plan, void*) {
  if (C <= 0 || C % 16 != 0 || C > kMaxChannels || N <= 0 || L < 0
      || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StackPlan p = stack_plan(C, L, dtype == 1 ? 2 : 1);
  plan[0] = (static_cast<long long>(N) + kStackRows - 1) / kStackRows
            * p.cluster;
  plan[1] = p.cluster;
  plan[2] = p.stages;
  plan[3] = static_cast<long long>(p.smem);
  return static_cast<int>(cudaSuccess);
}

extern "C" const char* int8_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
