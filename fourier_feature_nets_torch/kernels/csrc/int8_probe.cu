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
// to the next; P1c's 64-column slabs give 32 blocks for 132 SMs.
//
// P1a is built for that latency. A block owns a 32x32 output tile, so the
// tool's (128, 128) @ (128, 256) spreads over 32 blocks, and stages K 128
// bytes at a time: at K <= 128 one stage holds the whole product, with one
// barrier between the copies and the products. W's rows go to shared memory
// as 16-byte cp.async copies (zero-filled past M and K) into rows padded to
// 144 bytes, so the eight rows an ldmatrix reads start on distinct banks.
// The int8 tensor-core instruction, mma.sync m16n8k32, takes B K-contiguous
// and h is N-contiguous: each thread reads 8 bytes of four consecutive rows
// of h, transposes each 4x4 byte block with __byte_perm and stores h^T as
// (N, K) rows. ldmatrix.x4 feeds A and B; each of the four warps owns a
// 16x16 quarter of the tile as two n8 accumulators, stored from registers
// as int2 pairs. A byte-wise path inside the kernel stages W when its base
// or K is not 16-byte aligned and h when its base or N is not 8-byte
// aligned (the tool's ragged (100, 72, 250) takes both); the edge stores
// are masked.
//
// P1b and P1c keep a simpler scheme:
// * every operand goes through shared memory as 16x16 row-major panels,
//   each 256 elements from the last, so every WMMA pointer is 32-byte
//   aligned for int8 and bf16 alike and any M, K, N can be zero-padded;
// * P1b: one block (it needs max|x| over all of x first), which reduces
//   the max, quantizes x as it stages it (IEEE division and
//   round-half-even, as jnp.round; this file must not be built with
//   --use_fast_math), walks the 64x64 output tiles with K in chunks of 64,
//   each warp owning two 16x16 int32 accumulators, and dequantizes in the
//   epilogue;
// * P1c: a block owns a 64-column slab of h, keeps it in shared memory
//   through every layer and stages each layer's W from L2 in 16-byte
//   vectors; one template serves bf16 and int8. (On an H100 80GB HBM3 at
//   700 W, cli/int8_probe: one 1- or 2-byte load per weight ran 148.6 us
//   bf16 and 127.3 us int8 a call, 16-byte loads 105.5 and 83.5 us, and
//   cp.async copies of the next layer's W during this layer's epilogue
//   100.8 and 84.3 us, so the copies are not what bounds it now; the
//   simpler vector loads stay.)
// The kernels launch on the caller's stream and allocate nothing; each
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "shared_limit.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 256;     // elements of one 16x16 panel
constexpr int kTile = 64;       // P1b: output tile side and K chunk
constexpr int kTilePanels = kTile / 16;
constexpr int kSlab = 64;       // P1c: columns of h per block
constexpr int kSlabPanels = kSlab / 16;
constexpr int kMaxChannels = 256;
constexpr int kMaxFragsPerWarp = (kMaxChannels / 16) * kSlabPanels / kWarps;

// Element (r, c) of a matrix staged as 16x16 row-major panels,
// `panels_per_row` panels to a panel row.
__device__ __forceinline__ int panel_index(int r, int c, int panels_per_row) {
  return ((r >> 4) * panels_per_row + (c >> 4)) * kPanel + (r & 15) * 16
         + (c & 15);
}

// --- P1a ----------------------------------------------------------------------

constexpr int kMmaTile = 32;             // output tile side
constexpr int kMmaThreads = 128;         // 4 warps, a 16x16 quarter each
constexpr int kMmaK = 128;               // K bytes staged at a time
constexpr int kMmaPitch = kMmaK + 16;    // padded shared row, 16-byte aligned

static_assert((kMmaK / 4) * (kMmaTile / 8) == kMmaThreads,
              "stage_h gives each thread 4 rows x 8 columns of h");

struct MmaShared {
  __align__(16) signed char a[kMmaTile * kMmaPitch];    // W (m, k)
  __align__(16) signed char bt[kMmaTile * kMmaPitch];   // h^T (n, k)
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

// h rows k0.. and columns n0.. of one stage, transposed into s.bt.
__device__ __forceinline__ void stage_h(const signed char* __restrict__ h,
                                        int K, int N, int n0, int k0,
                                        bool vector, MmaShared& s) {
  if (vector) {   // h and N 8-byte aligned: a piece is all in or all out
    // thread: rows k0 + 4 * kg .. + 3, columns n0 + 8 * ng .. + 7
    const int kg = threadIdx.x / 4;
    const int ng = threadIdx.x % 4;
    const int n = n0 + ng * 8;
    unsigned lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + kg * 4 + i;
      uint2 v = make_uint2(0u, 0u);
      if (k < K && n < N) {
        v = __ldg(reinterpret_cast<const uint2*>(
            h + static_cast<long long>(k) * N + n));
      }
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
            ? h[static_cast<long long>(k0 + kk) * N + n0 + c] : 0;
  }
}

// out[r, c..c+1] = (v0, v1), masked to (M, N); one int2 where it can.
__device__ __forceinline__ void store_pair(int* __restrict__ out, int M,
                                           int N, int r, int c, int v0,
                                           int v1, bool vector) {
  if (r >= M || c >= N) return;
  int* p = out + static_cast<long long>(r) * N + c;
  if (vector) {   // N even and out 8-byte aligned: c + 1 < N too
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    return;
  }
  p[0] = v0;
  if (c + 1 < N) p[1] = v1;
}

__global__ void __launch_bounds__(kMmaThreads)
int8_matmul_kernel(const signed char* __restrict__ w,
                   const signed char* __restrict__ h, int* __restrict__ out,
                   int M, int K, int N, bool w_vector, bool h_vector,
                   bool out_vector) {
  __shared__ MmaShared s;
  const int m0 = blockIdx.y * kMmaTile;
  const int n0 = blockIdx.x * kMmaTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 16;   // the warp's quarter of the tile
  const int wn = (warp % 2) * 16;
  int acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += kMmaK) {
    stage_w(w, M, K, m0, k0, w_vector, s);
    stage_h(h, K, N, n0, k0, h_vector, s);
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
    store_pair(out, M, N, m0 + wm + g, c, acc[j][0], acc[j][1], out_vector);
    store_pair(out, M, N, m0 + wm + g + 8, c, acc[j][2], acc[j][3],
               out_vector);
  }
}

// --- P1b ----------------------------------------------------------------------

struct QuantSource {         // B is round(x / scale) as int8
  const float* x;
  float scale;
  __device__ signed char operator()(long long idx) const {
    return static_cast<signed char>(__float2int_rn(x[idx] / scale));
  }
};

struct StoreScaled {
  float* out;
  float scale;
  __device__ void operator()(long long idx, int v) const {
    out[idx] = static_cast<float>(v) * scale;
  }
};

struct GemmShared {
  __align__(32) signed char a[kTile * kTile];
  __align__(32) signed char b[kTile * kTile];
  __align__(32) int c[kTile * kTile];
};

// C = A (M, K) @ B (K, N) in int8 with int32 sums, for the 64x64 output
// tiles first_tile, first_tile + tile_step, ...; store(index, value)
// finishes each element of C.
template <typename Source, typename Store>
__device__ void gemm_tiles(const signed char* __restrict__ a, Source src,
                           Store store, int M, int K, int N, int first_tile,
                           int tile_step, GemmShared& s) {
  const int tiles_n = (N + kTile - 1) / kTile;
  const int tiles = ((M + kTile - 1) / kTile) * tiles_n;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;          // the warp's row panel
  const int wn = (warp % 2) * 2;    // the first of its two column panels
  for (int tile = first_tile; tile < tiles; tile += tile_step) {
    const int m0 = (tile / tiles_n) * kTile;
    const int n0 = (tile % tiles_n) * kTile;
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2];
    wmma::fill_fragment(acc[0], 0);
    wmma::fill_fragment(acc[1], 0);
    for (int k0 = 0; k0 < K; k0 += kTile) {
      for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
        const int r = idx / kTile;
        const int c = idx % kTile;
        const int slot = panel_index(r, c, kTilePanels);
        s.a[slot] = (m0 + r < M && k0 + c < K)
                        ? a[static_cast<long long>(m0 + r) * K + k0 + c] : 0;
        s.b[slot] = (k0 + r < K && n0 + c < N)
                        ? src(static_cast<long long>(k0 + r) * N + n0 + c) : 0;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTilePanels; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, s.a + (wm * kTilePanels + kk) * kPanel, 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(
              fb, s.b + (kk * kTilePanels + wn + j) * kPanel, 16);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();   // the panels are restaged next chunk
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(s.c + wm * 16 * kTile + (wn + j) * 16, acc[j],
                              kTile, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int r = idx / kTile;
      const int c = idx % kTile;
      if (m0 + r < M && n0 + c < N) {
        store(static_cast<long long>(m0 + r) * N + n0 + c, s.c[idx]);
      }
    }
    __syncthreads();
  }
}

// One block: max|x|, then every tile of W @ round(x / scale), dequantized.
__global__ void __launch_bounds__(kThreads)
quantized_matmul_kernel(const float* __restrict__ x,
                        const signed char* __restrict__ w,
                        float* __restrict__ out, int M, int K, int N) {
  __shared__ GemmShared s;
  __shared__ float warp_max[kWarps];
  float m = 0.0f;
  const long long count = static_cast<long long>(K) * N;
  for (long long i = threadIdx.x; i < count; i += kThreads) {
    m = fmaxf(m, fabsf(x[i]));
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
  }
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, warp_max[i]);
  const float scale = m / 127.0f + 1e-30f;   // IEEE division, as jnp
  gemm_tiles(w, QuantSource{x, scale}, StoreScaled{out, scale}, M, K, N, 0,
             1, s);
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

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(signed char v) {
  return static_cast<float>(v);
}

template <typename T>
size_t stack_shared_bytes(int C) {
  return (static_cast<size_t>(C) * kSlab + static_cast<size_t>(C) * C)
             * sizeof(T)
         + kWarps * kPanel * 4;
}

// T: bf16 with float sums, or signed char with int sums. Block b owns
// columns [64b, 64b + 64) of h, kept in shared memory as (C/16) x 4 panels;
// warp w owns output panels w, w + 8, ... of each layer.
template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads)
layer_stack_kernel(const T* __restrict__ h0, const T* __restrict__ ws,
                   float* __restrict__ out, int C, int N, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* h_s = reinterpret_cast<T*>(smem);
  T* w_s = h_s + C * kSlab;
  Acc* scratch = reinterpret_cast<Acc*>(w_s + C * C);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kSlab;
  const int cp = C / 16;
  const int frags = cp * kSlabPanels;
  for (int idx = threadIdx.x; idx < C * kSlab; idx += kThreads) {
    const int r = idx / kSlab;
    const int c = idx % kSlab;
    h_s[panel_index(r, c, kSlabPanels)] =
        n0 + c < N ? h0[static_cast<long long>(r) * N + n0 + c]
                   : zero_of<T>();   // zero columns stay zero
  }
  // W_l moves as 16-byte vectors: C is a multiple of 16, so the kVec
  // elements of one vector lie in one row of one panel
  constexpr int kVec = 16 / sizeof(T);
  for (int l = 0; l < L; ++l) {
    const int4* w = reinterpret_cast<const int4*>(
        ws + static_cast<long long>(l) * C * C);
    for (int v = threadIdx.x; v < C * C / kVec; v += kThreads) {
      const int idx = v * kVec;
      *reinterpret_cast<int4*>(w_s + panel_index(idx / C, idx % C, cp)) =
          w[v];
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[kMaxFragsPerWarp];
#pragma unroll
    for (int f = 0; f < kMaxFragsPerWarp; ++f) {
      wmma::fill_fragment(acc[f], static_cast<Acc>(0));
    }
#pragma unroll
    for (int f = 0; f < kMaxFragsPerWarp; ++f) {
      const int frag = warp + f * kWarps;
      if (frag < frags) {
        const int i = frag / kSlabPanels;
        const int j = frag % kSlabPanels;
        for (int k = 0; k < cp; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
          wmma::load_matrix_sync(a, w_s + (i * cp + k) * kPanel, 16);
          wmma::load_matrix_sync(b, h_s + (k * kSlabPanels + j) * kPanel, 16);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    __syncthreads();   // every read of h_s and w_s is done
    Acc* mine = scratch + warp * kPanel;
#pragma unroll
    for (int f = 0; f < kMaxFragsPerWarp; ++f) {
      const int frag = warp + f * kWarps;
      if (frag < frags) {
        wmma::store_matrix_sync(mine, acc[f], 16, wmma::mem_row_major);
        __syncwarp();
        // output panel (i, j) is panel i * 4 + j of the next layer's h
        T* dst = h_s + frag * kPanel;
        for (int e = lane; e < kPanel; e += 32) dst[e] = relu_cast(mine[e]);
        __syncwarp();
      }
    }
    __syncthreads();
  }
  __syncthreads();   // L = 0: the slab was just staged
  for (int idx = threadIdx.x; idx < C * kSlab; idx += kThreads) {
    const int r = idx / kSlab;
    const int c = idx % kSlab;
    if (n0 + c < N) {
      out[static_cast<long long>(r) * N + n0 + c] =
          to_float(h_s[panel_index(r, c, kSlabPanels)]);
    }
  }
}

template <typename T, typename Acc>
cudaError_t launch_stack(const void* h0, const void* ws, void* out, int C,
                         int N, int L, cudaStream_t stream) {
  static ffn::SharedLimit limit;
  const size_t smem = stack_shared_bytes<T>(C);
  const cudaError_t err =
      ffn::reserve_shared(layer_stack_kernel<T, Acc>, smem, limit);
  if (err != cudaSuccess) return err;
  const int blocks = (N + kSlab - 1) / kSlab;
  layer_stack_kernel<T, Acc><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(h0), static_cast<const T*>(ws),
      static_cast<float*>(out), C, N, L);
  return cudaGetLastError();
}

}  // namespace

// P1a: w (M, K) int8 @ h (K, N) int8 -> out (M, N) int32.
extern "C" int int8_matmul(const void* w, const void* h, void* out, int M,
                           int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto address = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  const bool w_vector = address(w) % 16 == 0 && K % 16 == 0;
  const bool h_vector = address(h) % 8 == 0 && N % 8 == 0;
  const bool out_vector = address(out) % 8 == 0 && N % 2 == 0;
  const dim3 grid((N + kMmaTile - 1) / kMmaTile, (M + kMmaTile - 1) / kMmaTile);
  int8_matmul_kernel<<<grid, kMmaThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(w), static_cast<const signed char*>(h),
      static_cast<int*>(out), M, K, N, w_vector, h_vector, out_vector);
  return static_cast<int>(cudaGetLastError());
}

// P1b: x (K, N) f32, w (M, K) int8 -> out (M, N) f32, in one block.
extern "C" int quantized_matmul(const void* x, const void* w, void* out, int M,
                                int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  quantized_matmul_kernel<<<1, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const signed char*>(w),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
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
    err = launch_stack<__nv_bfloat16, float>(h0, ws, out, C, N, L, s);
  } else if (dtype == 0) {
    err = launch_stack<signed char, int>(h0, ws, out, C, N, L, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* int8_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
