// The IO-floor copy kernels for Hopper (sm_90a).
//
// Replace the TPU Pallas kernels of tools/kernel_io_floor_bench.py::main,
// which measure what moving the fused NeRF forward's inputs and outputs
// costs without its math:
//   io-narrow  io_kernel (:142, pallas_call :146): (n, 3) positions +
//              (n, 3) views -> (n, 4) = [p, v[:, :1]];
//   io-wide    io_wide_kernel (:165, pallas_call :168): (n, 128) f32 ->
//              x * 2;
//   packed8    p8_kernel (:185, pallas_call :190): (n, 8) f32 ->
//              [x[:, :3], x[:, 3:4], x[:, :4] * 0] (a NaN stays a NaN).
//
// What bounds them on an H100: bytes. There is no arithmetic to speak of,
// so the least time is the bytes moved over the 3.35 TB/s of HBM: 40 B a
// row for io-narrow, 1 KB for io-wide, 64 B for packed8 (each input read
// once, each output written once). At the tool's n = 786,432 the io-narrow
// (31.5 MB) and packed8 (50 MB) traffic fits in or near the 50 MB L2, so
// back-to-back launches may read warm data and beat the HBM bound; io-wide
// (805 MB) cannot.
//
// io-narrow. The first design read p and v as float4 at a 48-byte lane
// stride and had each lane store four float4 rows at a 64-byte stride, so
// each warp store wrote half of each of 64 sectors and four store
// instructions did the work of one contiguous one; each thread moved only
// two 4-row groups, with little to overlap the launch and the drain. It
// took 13.1-14.1 us on the card against torch.cat's 11.4-11.7 (H100 80GB
// HBM3, 700 W, CUDA-graph replay; chip_smoke.py --times-only, as PERF.md
// section 6 records for every time here). Now a block's rows (the tool's `tile`,
// a multiple of 4) go through shared memory in chunks of kChunkRows: the
// chunk's p and v slices are each one contiguous span of rows * 12 bytes,
// copied with 16-byte cp.async by consecutive threads (the ragged end of
// the last chunk as one zero-filled partial copy), two chunks in flight,
// so the next chunk loads while this one stores. Each thread then builds
// whole output rows (p0, p1, p2, v0) from shared memory (a stride of 3
// words: no bank conflicts) and a warp stores 512 contiguous bytes. It
// takes 6.2-6.4 us at either tile, under the HBM bound (the data is warm
// in L2).
//
// io-wide. The first design tied the grid to `tile` (384 blocks of 256
// threads at n = 786,432), and each thread walked its block's rows one
// float4 at a time: 0.282-0.288 ms, 83-85% of the HBM bound, where
// `x * 2` takes 0.266-0.269 (H100 80GB HBM3, 700 W, CUDA-graph replay, as
// below). Neither more bytes in flight nor the copy engine closed the
// gap: a grid of SMs x resident blocks walking the array with 8 or 16
// float4 loads a thread in flight, with or without the streaming hints,
// took 0.2808-0.2855 ms; one block an SM with a ring of 8 or 12 x 16 KB
// bulk copies (TMA) and mbarriers took 0.2764-0.2808. What reaches HBM's
// pace is a grid that follows the array: blocks that each move a few KB
// and retire, so the block scheduler streams a compact window of
// addresses. Here one float4 a thread, 4 KB a block (2 or 4 float4 a
// thread, or streaming hints, read the same within 0.4%). The tool's tile
// has no counterpart.
//
// packed8 keeps its first design: one float4 load and two float4 stores a
// row. The kernels launch on the caller's stream and allocate nothing;
// each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkRows = 1024;        // io-narrow rows a stage holds
constexpr int kChunkFloats = kChunkRows * 3;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies `floats` floats from src (16-byte aligned) to shared memory as
// 16-byte pieces, one a thread in turn; the last piece may be partial
// (the rest of it zero-filled, nothing read past src + floats).
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int floats) {
  const int pieces = (floats + 3) / 4;
  for (int i = threadIdx.x; i < pieces; i += kThreads) {
    const int left = floats - 4 * i;
    cp_async16(dst + 4 * i, src + 4 * i, left >= 4 ? 16 : 4 * left);
  }
}

__global__ void __launch_bounds__(kThreads)
io_narrow_kernel(const float* __restrict__ p, const float* __restrict__ v,
                 float4* __restrict__ out, long long n, int tile) {
  __shared__ __align__(16) float ps[2][kChunkFloats];
  __shared__ __align__(16) float vs[2][kChunkFloats];
  const long long row0 = static_cast<long long>(blockIdx.x) * tile;
  const long long end = row0 + tile < n ? row0 + tile : n;
  const int rows = static_cast<int>(end - row0);
  const int chunks = (rows + kChunkRows - 1) / kChunkRows;
  auto chunk_rows = [&](int c) {
    const int left = rows - c * kChunkRows;
    return left < kChunkRows ? left : kChunkRows;
  };
  auto load = [&](int c) {   // one commit group a call, empty past the end
    if (c < chunks) {
      const long long first = (row0 + static_cast<long long>(c) * kChunkRows)
                              * 3;
      stage(ps[c & 1], p + first, chunk_rows(c) * 3);
      stage(vs[c & 1], v + first, chunk_rows(c) * 3);
    }
    cp_async_commit();
  };
  load(0);
  load(1);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_one();     // this thread's copies of chunk c have landed
    __syncthreads();         // and every other thread's
    const float* pc = ps[c & 1];
    const float* vc = vs[c & 1];
    float4* oc = out + row0 + static_cast<long long>(c) * kChunkRows;
    const int count = chunk_rows(c);
    for (int r = threadIdx.x; r < count; r += kThreads) {
      oc[r] = make_float4(pc[3 * r], pc[3 * r + 1], pc[3 * r + 2], vc[3 * r]);
    }
    __syncthreads();         // the buffer is free before chunk c + 2 fills it
    load(c + 2);
  }
}

// One float4 a thread, one block for every kThreads of them: the grid
// follows the array.
__global__ void __launch_bounds__(kThreads)
io_wide_kernel(const float4* __restrict__ x, float4* __restrict__ out,
               long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i < total) {
    const float4 a = x[i];
    out[i] = make_float4(a.x * 2.0f, a.y * 2.0f, a.z * 2.0f, a.w * 2.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
packed8_kernel(const float4* __restrict__ x, float4* __restrict__ out,
               long long n, int tile) {
  const long long row0 = static_cast<long long>(blockIdx.x) * tile;
  const long long end = row0 + tile < n ? row0 + tile : n;
  for (long long r = row0 + threadIdx.x; r < end; r += kThreads) {
    const float4 a = x[2 * r];          // x[r, 0:4]; x[r, 4:8] is not used
    out[2 * r] = a;
    out[2 * r + 1] = make_float4(a.x * 0.0f, a.y * 0.0f, a.z * 0.0f,
                                 a.w * 0.0f);
  }
}

unsigned blocks_for(long long n, int tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

}  // namespace

// p, v: (n, 3) f32, 16-byte aligned; out: (n, 4) f32; tile: rows per
// block, a multiple of 4.
extern "C" int io_narrow(const void* p, const void* v, void* out, long long n,
                         int tile, void* stream) {
  if (n <= 0 || tile <= 0 || tile % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  io_narrow_kernel<<<blocks_for(n, tile), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(v),
      static_cast<float4*>(out), n, tile);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (n, 128) f32, 16-byte aligned.
extern "C" int io_wide(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = n * (128 / 4);
  io_wide_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), total);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (n, 8) f32; tile: rows per block.
extern "C" int packed8(const void* x, void* out, long long n, int tile,
                       void* stream) {
  if (n <= 0 || tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  packed8_kernel<<<blocks_for(n, tile), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), n, tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* io_floor_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
