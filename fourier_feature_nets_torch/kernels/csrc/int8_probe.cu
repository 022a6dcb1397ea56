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
// 1.22 us at the bf16 peak) over ~2.3-3 MB. Launch latency and the serial
// dependence from one layer to the next bound them; P1c's 64-column slabs
// give 32 blocks for 132 SMs. The design does not fight that (it is a
// probe of numerics and of the int8/bf16 ratio); it keeps the work on the
// tensor cores and off device memory:
// * every operand goes through shared memory as 16x16 row-major panels,
//   each 256 elements from the last, so every WMMA pointer is 32-byte
//   aligned for int8 and bf16 alike and any M, K, N can be zero-padded;
// * P1a/P1b: one 64x64 output tile per step, K in chunks of 64; each warp
//   owns two 16x16 int32 accumulators. P1a gives each tile a block; P1b is
//   one block (it needs max|x| over all of x first), which reduces the max,
//   quantizes x as it stages it (IEEE division and round-half-even, as
//   jnp.round; this file must not be built with --use_fast_math) and
//   dequantizes in the epilogue;
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

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 256;     // elements of one 16x16 panel
constexpr int kTile = 64;       // P1a/P1b: output tile side and K chunk
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

// --- P1a / P1b --------------------------------------------------------------

struct Int8Source {          // P1a: B is an int8 matrix
  const signed char* b;
  __device__ signed char operator()(long long idx) const { return b[idx]; }
};

struct QuantSource {         // P1b: B is round(x / scale) as int8
  const float* x;
  float scale;
  __device__ signed char operator()(long long idx) const {
    return static_cast<signed char>(__float2int_rn(x[idx] / scale));
  }
};

struct StoreInt32 {
  int* out;
  __device__ void operator()(long long idx, int v) const { out[idx] = v; }
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

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const signed char* __restrict__ w,
                   const signed char* __restrict__ h, int* __restrict__ out,
                   int M, int K, int N) {
  __shared__ GemmShared s;
  gemm_tiles(w, Int8Source{h}, StoreInt32{out}, M, K, N, blockIdx.x,
             gridDim.x, s);
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
  const size_t smem = stack_shared_bytes<T>(C);
  cudaError_t err = cudaFuncSetAttribute(
      layer_stack_kernel<T, Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
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
  const int tiles = ((M + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  int8_matmul_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(w), static_cast<const signed char*>(h),
      static_cast<int*>(out), M, K, N);
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
