// Instant-NGP's multiresolution hash encoding for Hopper (sm_90a): the
// forward (positions -> each level's trilinearly interpolated features)
// and the backward (the table's gradient).
//
// It replaces no TPU kernel: the JAX package has no hash grid. The port's
// HashGridNeRF (models/hash_grid.py) calls it through kernels/hash_grid.py,
// whose plain twin (corner_indices, hash_grid_encode_reference,
// hash_grid_backward_reference) follows the same arithmetic in the same
// order: the position divided by the box, plus 1, halved and clamped to
// [0, 1]; q = x * s_l + 0.5 with no fused multiply-add; corner c of 8 (bit
// d: above floor(q) on axis d) weighted by the product over x, y, z of w_d
// or 1 - w_d, left to right; each feature the sum over the corners in
// order, f32 products and adds rounded one by one (__fmul_rn, __fadd_rn),
// so the forward equals the twin's f32 sums bit for bit. A level whose
// res^3 fits its n_l entries is indexed densely (x + y res + z res^2),
// any other by tiny-cuda-nn's hash (x ^ y 2654435761 ^ z 805459861 in
// uint32 arithmetic); either modulo n_l.
//
// What bounds it on an H100: memory, and above all latency and atomics.
// A point reads 12 bytes of position and writes 2 features a level; the
// tables it gathers from are 6,098,120 x 8 bytes (48.8 MB, near the 50 MB
// L2) at the published configuration. The compulsory bytes of a step at
// 262,144 points (each table entry read once, each gradient entry written
// once, positions and features once each way) take ~41 us at 3.35 TB/s in
// bf16 (h100_bench/counts/hash_grid.py). The gathers are 8 random
// 8-byte rows a point and level (33.5M a step), the backward 33.5M
// float2 atomic adds. On an H100 80GB HBM3 at 700 W, in the training
// step's ray samples, the encode takes 0.158 ms and the backward 0.420 ms
// (7.1% of that bound, PERF.md): the gathers' latency and the atomics,
// which pile onto the few rows of the coarse levels (~500 adds a row and
// step at level 0), set the time, not the bytes.
//
// Design: one thread a (point, level), a block's 256 threads on 256
// points of one level (blockIdx.y is the level). The level's parameters
// are then uniform over a block, so a warp never diverges between the
// dense and the hashed index, and as blocks are issued in order of
// blockIdx.x within a level, the card works on one level's table (at most
// 4 MB) at a time, which stays in L2. Each thread reads its position
// (a warp: 384 contiguous bytes, the same for every level, from L2 after
// the first), gathers its 8 corners with __ldg as float2 and stores its
// two features as one 8-byte (f32) or 4-byte (bf16) word at a 64- or
// 128-byte stride: the (N, L * 2) row-major layout the MLP reads, whose
// partial sectors L2 merges before they reach memory. The backward reads
// the two cotangents the same way and adds each corner's weighted pair
// into the f32 gradient with one sm_90 float2 atomicAdd (a RED with the
// result unused). The sums' order then changes from launch to launch.
// The kernels launch on the caller's stream and allocate nothing (the
// wrapper zeroes the gradient); each entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;   // kernels/hash_grid.py, MAX_LEVELS
constexpr unsigned kPrimeY = 2654435761u;
constexpr unsigned kPrimeZ = 805459861u;

// Every level's geometry, passed by value (a CUDA graph keeps a copy).
struct Grid {
  float scale[kMaxLevels];
  unsigned res[kMaxLevels];
  unsigned size[kMaxLevels];
  unsigned offset[kMaxLevels];
  unsigned dense;   // bit l: level l is indexed densely
  float box;        // the scene's half extent
};

struct Corners {
  unsigned low[3];
  float frac[3];
};

__device__ __forceinline__ Corners locate(const float* __restrict__ positions,
                                          long long i, float scale,
                                          float box) {
  Corners c;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float p = __ldg(positions + 3 * i + d);
    float x = __fmul_rn(__fadd_rn(__fdiv_rn(p, box), 1.0f), 0.5f);
    x = fminf(fmaxf(x, 0.0f), 1.0f);
    const float q = __fadd_rn(__fmul_rn(x, scale), 0.5f);
    const float low = floorf(q);
    c.low[d] = static_cast<unsigned>(low);
    c.frac[d] = __fsub_rn(q, low);   // exact: the fraction of a float
  }
  return c;
}

// Corner `corner`'s table row (the level's offset added) and weight.
__device__ __forceinline__ unsigned corner_row(const Corners& c, int corner,
                                               unsigned res, unsigned size,
                                               bool dense, unsigned offset,
                                               float* weight) {
  unsigned pos[3];
  float w = 1.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const unsigned up = (corner >> d) & 1u;
    pos[d] = c.low[d] + up;
    const float term = up ? c.frac[d] : __fsub_rn(1.0f, c.frac[d]);
    w = d == 0 ? term : __fmul_rn(w, term);
  }
  *weight = w;
  const unsigned index = dense ? pos[0] + pos[1] * res + pos[2] * res * res
                               : pos[0] ^ (pos[1] * kPrimeY)
                                     ^ (pos[2] * kPrimeZ);
  return offset + index % size;
}

__device__ __forceinline__ void store2(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

__device__ __forceinline__ float2 load2(const float* in) {
  return *reinterpret_cast<const float2*>(in);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* in) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(in);
  return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hash_grid_encode_kernel(const float* __restrict__ positions,
                        const float2* __restrict__ table,
                        T* __restrict__ features, long long n,
                        const Grid grid, int levels) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int level = blockIdx.y;
  if (i >= n) return;
  const Corners c = locate(positions, i, grid.scale[level], grid.box);
  const unsigned res = grid.res[level];
  const unsigned size = grid.size[level];
  const unsigned offset = grid.offset[level];
  const bool dense = (grid.dense >> level) & 1u;
  float a = 0.0f, b = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float w;
    const unsigned row = corner_row(c, corner, res, size, dense, offset, &w);
    const float2 v = __ldg(table + row);
    a = __fadd_rn(a, __fmul_rn(w, v.x));
    b = __fadd_rn(b, __fmul_rn(w, v.y));
  }
  store2(features + i * (2 * levels) + 2 * level, a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hash_grid_backward_kernel(const float* __restrict__ positions,
                          const T* __restrict__ grad,
                          float2* __restrict__ table_grad, long long n,
                          const Grid grid, int levels) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const int level = blockIdx.y;
  if (i >= n) return;
  const float2 g = load2(grad + i * (2 * levels) + 2 * level);
  const Corners c = locate(positions, i, grid.scale[level], grid.box);
  const unsigned res = grid.res[level];
  const unsigned size = grid.size[level];
  const unsigned offset = grid.offset[level];
  const bool dense = (grid.dense >> level) & 1u;
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    float w;
    const unsigned row = corner_row(c, corner, res, size, dense, offset, &w);
    atomicAdd(table_grad + row,
              make_float2(__fmul_rn(w, g.x), __fmul_rn(w, g.y)));
  }
}

// The Grid of the wrapper's arrays: scales (L) f32 and meta (L, 4) int64
// rows of offset, size, resolution and dense.
bool make_grid(const void* scales, const void* meta, int levels, float box,
               Grid* grid) {
  if (levels <= 0 || levels > kMaxLevels || !(box > 0.0f)) return false;
  const float* s = static_cast<const float*>(scales);
  const long long* m = static_cast<const long long*>(meta);
  grid->dense = 0;
  grid->box = box;
  for (int l = 0; l < levels; ++l) {
    const long long offset = m[4 * l], size = m[4 * l + 1],
                    res = m[4 * l + 2];
    if (offset < 0 || size <= 0 || res <= 0 || offset + size > (1LL << 32)) {
      return false;
    }
    grid->scale[l] = s[l];
    grid->offset[l] = static_cast<unsigned>(offset);
    grid->size[l] = static_cast<unsigned>(size);
    grid->res[l] = static_cast<unsigned>(res);
    if (m[4 * l + 3]) grid->dense |= 1u << l;
  }
  return true;
}

dim3 blocks_for(long long n, int levels) {
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads),
              static_cast<unsigned>(levels));
}

}  // namespace

// positions (n, 3) f32; table (entries, 2) f32; scales (L) f32 and meta
// (L, 4) int64 on the host; features (n, 2L), f32 (dtype 0) or bf16 (1).
extern "C" int hash_grid_encode(const void* positions, const void* table,
                                const void* scales, const void* meta,
                                int levels, float box, void* features,
                                long long n, int dtype, void* stream) {
  Grid grid;
  if (n <= 0 || (dtype != 0 && dtype != 1)
      || !make_grid(scales, meta, levels, box, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(positions);
  const float2* t = static_cast<const float2*>(table);
  if (dtype == 0) {
    hash_grid_encode_kernel<float><<<blocks_for(n, levels), kThreads, 0, s>>>(
        p, t, static_cast<float*>(features), n, grid, levels);
  } else {
    hash_grid_encode_kernel<__nv_bfloat16>
        <<<blocks_for(n, levels), kThreads, 0, s>>>(
            p, t, static_cast<__nv_bfloat16*>(features), n, grid, levels);
  }
  return static_cast<int>(cudaGetLastError());
}

// positions (n, 3) f32; grad (n, 2L), f32 (dtype 0) or bf16 (1); scales and
// meta as above; table_grad (entries, 2) f32, zeroed by the caller.
extern "C" int hash_grid_backward(const void* positions, const void* grad,
                                  const void* scales, const void* meta,
                                  int levels, float box, void* table_grad,
                                  long long n, int dtype, void* stream) {
  Grid grid;
  if (n <= 0 || (dtype != 0 && dtype != 1)
      || !make_grid(scales, meta, levels, box, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(positions);
  float2* out = static_cast<float2*>(table_grad);
  if (dtype == 0) {
    hash_grid_backward_kernel<float>
        <<<blocks_for(n, levels), kThreads, 0, s>>>(
            p, static_cast<const float*>(grad), out, n, grid, levels);
  } else {
    hash_grid_backward_kernel<__nv_bfloat16>
        <<<blocks_for(n, levels), kThreads, 0, s>>>(
            p, static_cast<const __nv_bfloat16*>(grad), out, n, grid,
            levels);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hash_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
