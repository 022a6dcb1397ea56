// The IO-floor copy kernels for Hopper (sm_90a).
//
// Replace the TPU Pallas kernels of tools/kernel_io_floor_bench.py::main,
// which measure what moving the fused NeRF forward's inputs and outputs
// costs without its math:
//   io-narrow  io_kernel (pallas_call :146): (n, 3) positions + (n, 3)
//              views -> (n, 4) = [p, v[:, :1]];
//   io-wide    io_wide_kernel (pallas_call :168): (n, 128) f32 -> x * 2;
//   packed8    p8_kernel (pallas_call :190): (n, 8) f32 ->
//              [x[:, :3], x[:, 3:4], x[:, :4] * 0] (a NaN stays a NaN).
// The tool's `tile` is the rows each block copies here.
//
// What bounds them on an H100: bytes. There is no arithmetic to speak of,
// so the least time is the bytes moved over the 3.35 TB/s of HBM: 40 B a
// row for io-narrow, 1 KB for io-wide, 64 B for packed8 (each input read
// once, each output written once). At the tool's n = 786,432 the io-narrow
// (31.5 MB) and packed8 (50 MB) traffic fits in or near the 50 MB L2, so
// back-to-back launches may read warm data and beat the HBM bound; io-wide
// (805 MB) cannot. The design: every thread moves 16-byte vectors, and
// neighbouring threads neighbouring vectors. io-narrow takes four rows a
// step, three float4 of p and of v (12 floats, 16-byte aligned because the
// tile is a multiple of 4 rows), and writes four float4 rows; the ragged
// edge (n not a multiple of the tile, or of 4) is masked, row by row. The
// kernels launch on the caller's stream and allocate nothing; each entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
io_narrow_kernel(const float* __restrict__ p, const float* __restrict__ v,
                 float* __restrict__ out, long long n, int tile) {
  const long long row0 = static_cast<long long>(blockIdx.x) * tile;
  const long long end = row0 + tile < n ? row0 + tile : n;
  const long long groups = (end - row0) / 4;
  const float4* p4 = reinterpret_cast<const float4*>(p + row0 * 3);
  const float4* v4 = reinterpret_cast<const float4*>(v + row0 * 3);
  float4* o4 = reinterpret_cast<float4*>(out + row0 * 4);
  for (long long g = threadIdx.x; g < groups; g += kThreads) {
    const float4 a0 = p4[3 * g], a1 = p4[3 * g + 1], a2 = p4[3 * g + 2];
    const float4 b0 = v4[3 * g], b1 = v4[3 * g + 1], b2 = v4[3 * g + 2];
    o4[4 * g] = make_float4(a0.x, a0.y, a0.z, b0.x);
    o4[4 * g + 1] = make_float4(a0.w, a1.x, a1.y, b0.w);
    o4[4 * g + 2] = make_float4(a1.z, a1.w, a2.x, b1.z);
    o4[4 * g + 3] = make_float4(a2.y, a2.z, a2.w, b2.y);
  }
  for (long long r = row0 + groups * 4 + threadIdx.x; r < end; r += kThreads) {
    out[r * 4] = p[r * 3];
    out[r * 4 + 1] = p[r * 3 + 1];
    out[r * 4 + 2] = p[r * 3 + 2];
    out[r * 4 + 3] = v[r * 3];
  }
}

__global__ void __launch_bounds__(kThreads)
io_wide_kernel(const float4* __restrict__ x, float4* __restrict__ out,
               long long n, int tile) {
  constexpr int kVectors = 128 / 4;   // float4 per row
  const long long first = static_cast<long long>(blockIdx.x) * tile * kVectors;
  const long long total = n * kVectors;
  const long long end = first + static_cast<long long>(tile) * kVectors < total
                            ? first + static_cast<long long>(tile) * kVectors
                            : total;
  for (long long i = first + threadIdx.x; i < end; i += kThreads) {
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

// p, v: (n, 3) f32; out: (n, 4) f32; tile: rows per block, a multiple of 4.
extern "C" int io_narrow(const void* p, const void* v, void* out, long long n,
                         int tile, void* stream) {
  if (n <= 0 || tile <= 0 || tile % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  io_narrow_kernel<<<blocks_for(n, tile), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(v),
      static_cast<float*>(out), n, tile);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (n, 128) f32; tile: rows per block.
extern "C" int io_wide(const void* x, void* out, long long n, int tile,
                       void* stream) {
  if (n <= 0 || tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  io_wide_kernel<<<blocks_for(n, tile), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), n, tile);
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
