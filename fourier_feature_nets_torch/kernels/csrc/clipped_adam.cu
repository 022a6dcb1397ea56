// The trainer's optimizer step for Hopper (sm_90a): every gradient element
// clipped to [-clip_value, clip_value], all gradients scaled by
// clip_norm / (norm + 1e-6) (at most 1) under their global L2 norm, then
// torch.optim.Adam with L2 weight decay, in two launches over a list of
// f32 tensors.
//
// It replaces no TPU kernel: the JAX package updates its weights in plain
// XLA (utils/optim.py there). The port's ClippedAdam (utils/optim.py)
// calls it through kernels/clipped_adam.py for CUDA parameters; its plain
// twin is what ClippedAdam runs for CPU parameters, torch's own calls:
// clip_grad_value_, clip_grad_norm_ and torch.optim.Adam. Those make 12
// passes over the parameters (clamp_min, clamp_max, the norm, the scale,
// then Adam's lerp, mul, addcmul, sqrt, two divisions by lists of 0-d
// tensors, the eps add and addcdiv), 1.42 GB at Instant-NGP's 12,205,648
// values. This makes two: the norm pass reads the gradient (49 MB), the
// update pass reads and writes g, p, m and v (391 MB), 0.44 GB in all,
// 0.131 ms at the H100's 3.35 TB/s. Its bound is memory, not arithmetic
// (some 20 flops an element).
//
// Design. The tensors of a launch (at most kMaxTensors; the wrapper splits
// a longer list into groups) are passed by value in the launch's
// parameters, so a CUDA graph keeps a copy: each tensor's p, g, m, v and
// step pointers, its element count and its first chunk. A chunk is
// kChunk elements of one tensor; a tensor whose four arrays are 16-byte
// aligned is read and written as float4, any other (and a chunk's tail)
// element by element.
//
// 1. Norm pass (clipped_adam_norm_kernel). Block 0 first adds one to every
//    tensor's 0-d step count, as torch's _foreach_add_(steps, 1): nothing
//    after it in the launch reads a step, and the update pass reads the
//    new count. With a norm clip, each of at most kNormBlocks blocks then
//    takes every gridDim-th chunk, clamps each element, sums the squares
//    in f32 in a fixed order (each thread its elements in turn, then a
//    fixed tree over the block) and writes one partial sum; no atomics.
//    Without a norm clip the launch is that one block alone.
// 2. Update pass (clipped_adam_update_kernel). Every block first sums all
//    partials in one fixed order, the same in every block, and computes
//    torch's coef = clip_norm * (1 / (norm + 1e-6)) (torch's float /
//    tensor is a reciprocal and a product), clamped to at most 1. Then
//    each tensor's bias corrections from its step t, as torch's capturable
//    Adam computes them: step_size = 1 / ((beta1^t - 1) / lr) and
//    sqrt(-(beta2^t - 1)); the learning rate is read from the device when
//    it is a tensor, so nothing reads the host. Then each element, in
//    torch's float order: g clamped and scaled, written back to the
//    gradient; d = g + weight_decay p (one fused multiply-add, as nvcc
//    contracts torch's a + alpha * b); m = lerp(m, d, 1 - beta1); v = v
//    beta2, then v + (1 - beta2) (d d); s = sqrt(v) / sqrt(1 - beta2^t) +
//    eps, s = s / step_size; p = p + m / s. Every operation is an explicit
//    round-to-nearest intrinsic (__fmaf_rn where torch's kernels contract
//    a product into an add, __fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn
//    elsewhere), so nvcc contracts nothing else. The grid is the card's
//    resident blocks (or fewer, one a chunk), each taking every
//    gridDim-th chunk.
//
// Tolerances against torch (kernels/clipped_adam.py's K5_ULPS and
// K5_FLOOR; tests/test_torch_clipped_adam_cuda.py and chip_smoke.py hold
// K5 to them). Two sums differ from torch's in order. First the norm:
// torch takes each tensor's norm, then the norm of those norms, each a
// sum of its own order; this sums every square in one fixed order. f32
// sums of many squares stray by several ulps (torch's own f32 norm on the
// CPU lies 1.2e-6, 20 ulps, from the f64 norm of the 8x256 NeRF's first
// four gradients of N(0, 0.05) clipped at 0.1). The coefs then differ
// when the norm clip acts (without it both are exactly 1), and every
// gradient with them. Second, any fused multiply-add that torch's
// kernels contract otherwise than assumed above. A gradient and v carry
// that relative gap; m, a decaying mean of gradients of either sign, and
// p, which adds m / s each step, carry it as an absolute gap of the
// gradients' scale, which a value near zero cannot absorb. Read on an H100
// 80GB HBM3 (700 W) after 20 steps, in ulps of the largest magnitude in
// torch's tensor: without the norm clip 0 everywhere (bit for bit, so the
// float order above is torch's); with it gradients 2-5, v 3-6, p 4-6 and
// m 3-32, the most in the 8x256 NeRF's few-valued tensors, whose largest
// m lies far below their gradients. So without the norm clip every
// gradient, moment, parameter and step must equal torch's bit for bit;
// with it every gradient, moment and parameter must lie within K5_ULPS =
// 128 of those ulps (K5_FLOOR = 1), 4x the largest reading, and the steps
// equal; two launches, and a launch against a graph replay, agree bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 32;      // kernels/clipped_adam.py, MAX_TENSORS
constexpr long long kChunk = 2048;   // kernels/clipped_adam.py, CHUNK
constexpr int kNormBlocks = 512;     // kernels/clipped_adam.py, NORM_BLOCKS
constexpr int kMaxDevices = 64;

// One launch's tensors, passed by value (a CUDA graph keeps a copy).
struct Tensors {
  float* p[kMaxTensors];
  float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  float* step[kMaxTensors];
  long long n[kMaxTensors];
  long long first_chunk[kMaxTensors + 1];   // prefix of chunk counts
  unsigned vec;   // bit i: tensor i's p, g, m and v are 16-byte aligned
  int count;
};

// The update's scalars; lr is read from the device when lr_ptr is set.
struct Update {
  const float* partials;   // the norm pass's sums; null: no norm clip
  int num_partials;
  int clip;                // clamp to [-clip_value, clip_value]
  float clip_value;
  float clip_norm;
  const float* lr_ptr;
  float lr;
  float beta1, beta2;      // as f32, as torch's kernels take them
  float lerp_weight;       // 1 - beta1, rounded from f64 as torch does
  float one_minus_beta2;   // likewise
  float eps;
  float weight_decay;
};

struct Chunk {
  int tensor;
  long long start, length;
};

__device__ __forceinline__ Chunk locate(const Tensors& ts, long long c) {
  int t = 0;
  while (c >= ts.first_chunk[t + 1]) ++t;
  const long long start = (c - ts.first_chunk[t]) * kChunk;
  const long long rest = ts.n[t] - start;
  return {t, start, rest < kChunk ? rest : kChunk};
}

// torch's clamp_min_ then clamp_max_: a NaN stays NaN.
__device__ __forceinline__ float clamp_value(float g, float c) {
  if (g != g) return g;
  g = g < -c ? -c : g;
  return g > c ? c : g;
}

// The block's sum of x in a fixed order (a shuffle tree in each warp, then
// the warps' sums in turn), returned to every thread.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warps[kThreads / 32];
  __shared__ float total;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, offset));
  }
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = warps[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) sum = __fadd_rn(sum, warps[w]);
    total = sum;
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ float square_sum(float4 x, int clip, float c,
                                            float sum) {
  if (clip) {
    x.x = clamp_value(x.x, c);
    x.y = clamp_value(x.y, c);
    x.z = clamp_value(x.z, c);
    x.w = clamp_value(x.w, c);
  }
  sum = __fmaf_rn(x.x, x.x, sum);
  sum = __fmaf_rn(x.y, x.y, sum);
  sum = __fmaf_rn(x.z, x.z, sum);
  return __fmaf_rn(x.w, x.w, sum);
}

__global__ void __launch_bounds__(kThreads)
clipped_adam_norm_kernel(const Tensors ts, int norm, int clip,
                         float clip_value, float* __restrict__ partials) {
  if (blockIdx.x == 0 && threadIdx.x < ts.count) {
    ts.step[threadIdx.x][0] = __fadd_rn(ts.step[threadIdx.x][0], 1.0f);
  }
  if (!norm) return;
  float sum = 0.0f;
  const long long chunks = ts.first_chunk[ts.count];
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const Chunk chunk = locate(ts, c);
    const float* g = ts.g[chunk.tensor] + chunk.start;
    long long head = 0;
    if ((ts.vec >> chunk.tensor) & 1u) {
      head = chunk.length / 4 * 4;
      const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll 2
      for (long long k = threadIdx.x; k < head / 4; k += kThreads) {
        sum = square_sum(__ldg(g4 + k), clip, clip_value, sum);
      }
    }
    for (long long k = head + threadIdx.x; k < chunk.length; k += kThreads) {
      float x = __ldg(g + k);
      if (clip) x = clamp_value(x, clip_value);
      sum = __fmaf_rn(x, x, sum);
    }
  }
  sum = block_sum(sum);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// One element's update in torch's float order (see the file's head).
__device__ __forceinline__ void adam(float& p, float& g, float& m, float& v,
                                     const Update& u, float coef,
                                     float step_size, float bc2_sqrt) {
  if (u.clip) g = clamp_value(g, u.clip_value);
  if (u.partials) g = __fmul_rn(g, coef);
  const float d = u.weight_decay != 0.0f ? __fmaf_rn(u.weight_decay, p, g)
                                         : g;
  // torch's lerp: self + w (end - self) below a weight of 0.5, else
  // end - (end - self) (1 - w)
  const float diff = __fsub_rn(d, m);
  m = u.lerp_weight < 0.5f
          ? __fmaf_rn(u.lerp_weight, diff, m)
          : __fmaf_rn(-diff, __fsub_rn(1.0f, u.lerp_weight), d);
  v = __fmaf_rn(u.one_minus_beta2, __fmul_rn(d, d), __fmul_rn(v, u.beta2));
  float s = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), bc2_sqrt), u.eps);
  s = __fdiv_rn(s, step_size);
  p = __fadd_rn(p, __fdiv_rn(m, s));
}

__global__ void __launch_bounds__(kThreads)
clipped_adam_update_kernel(const Tensors ts, const Update u) {
  __shared__ float step_size[kMaxTensors];
  __shared__ float bc2_sqrt[kMaxTensors];
  float coef = 1.0f;
  if (u.partials) {
    float sum = 0.0f;
    for (int k = threadIdx.x; k < u.num_partials; k += kThreads) {
      sum = __fadd_rn(sum, u.partials[k]);
    }
    const float norm = __fsqrt_rn(block_sum(sum));
    coef = __fmul_rn(__fdiv_rn(1.0f, __fadd_rn(norm, 1e-6f)), u.clip_norm);
    coef = coef > 1.0f ? 1.0f : coef;   // torch's clamp(max=1): NaN stays
  }
  if (threadIdx.x < ts.count) {
    const float t = ts.step[threadIdx.x][0];
    const float lr = u.lr_ptr ? *u.lr_ptr : u.lr;
    const float bc1 = __fdiv_rn(__fsub_rn(powf(u.beta1, t), 1.0f), lr);
    step_size[threadIdx.x] = __fdiv_rn(1.0f, bc1);
    bc2_sqrt[threadIdx.x] = __fsqrt_rn(-__fsub_rn(powf(u.beta2, t), 1.0f));
  }
  __syncthreads();
  const long long chunks = ts.first_chunk[ts.count];
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const Chunk chunk = locate(ts, c);
    const int t = chunk.tensor;
    const float size = step_size[t], bc2 = bc2_sqrt[t];
    float* p = ts.p[t] + chunk.start;
    float* g = ts.g[t] + chunk.start;
    float* m = ts.m[t] + chunk.start;
    float* v = ts.v[t] + chunk.start;
    long long head = 0;
    if ((ts.vec >> t) & 1u) {
      head = chunk.length / 4 * 4;
      float4* p4 = reinterpret_cast<float4*>(p);
      float4* g4 = reinterpret_cast<float4*>(g);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
#pragma unroll 2
      for (long long k = threadIdx.x; k < head / 4; k += kThreads) {
        float4 pk = p4[k], gk = g4[k], mk = m4[k], vk = v4[k];
        adam(pk.x, gk.x, mk.x, vk.x, u, coef, size, bc2);
        adam(pk.y, gk.y, mk.y, vk.y, u, coef, size, bc2);
        adam(pk.z, gk.z, mk.z, vk.z, u, coef, size, bc2);
        adam(pk.w, gk.w, mk.w, vk.w, u, coef, size, bc2);
        p4[k] = pk;
        g4[k] = gk;
        m4[k] = mk;
        v4[k] = vk;
      }
    }
    for (long long k = head + threadIdx.x; k < chunk.length; k += kThreads) {
      adam(p[k], g[k], m[k], v[k], u, coef, size, bc2);
    }
  }
}

// The launch's Tensors from the wrapper's (count, 6) int64 rows of p, g,
// m, v and step pointers and element count.
bool make_tensors(const void* rows, int count, Tensors* ts) {
  if (count <= 0 || count > kMaxTensors) return false;
  const long long* r = static_cast<const long long*>(rows);
  ts->count = count;
  ts->vec = 0;
  ts->first_chunk[0] = 0;
  for (int i = 0; i < count; ++i) {
    const long long* row = r + 6 * i;
    if (row[5] < 0) return false;
    // an empty tensor's arrays may be null; its step is not
    for (int k = row[5] > 0 ? 0 : 4; k < 5; ++k) {
      if (row[k] == 0 || row[k] % 4 != 0) return false;
    }
    ts->p[i] = reinterpret_cast<float*>(row[0]);
    ts->g[i] = reinterpret_cast<float*>(row[1]);
    ts->m[i] = reinterpret_cast<float*>(row[2]);
    ts->v[i] = reinterpret_cast<float*>(row[3]);
    ts->step[i] = reinterpret_cast<float*>(row[4]);
    ts->n[i] = row[5];
    if (((row[0] | row[1] | row[2] | row[3]) & 15) == 0) ts->vec |= 1u << i;
    ts->first_chunk[i + 1] = ts->first_chunk[i] + (row[5] + kChunk - 1)
                                                      / kChunk;
  }
  for (int i = count + 1; i <= kMaxTensors; ++i) {
    ts->first_chunk[i] = ts->first_chunk[count];
  }
  return true;
}

// The update pass's resident blocks on the current device, found once.
int resident_blocks(int* blocks) {
  static int cached[kMaxDevices] = {0};
  int device = 0;
  cudaError_t error = cudaGetDevice(&device);
  if (error != cudaSuccess) return static_cast<int>(error);
  if (device < kMaxDevices && cached[device] > 0) {
    *blocks = cached[device];
    return 0;
  }
  int sms = 0, per_sm = 0;
  error = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (error == cudaSuccess) {
    error = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, clipped_adam_update_kernel, kThreads, 0);
  }
  if (error != cudaSuccess) return static_cast<int>(error);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (device < kMaxDevices) cached[device] = *blocks;
  return 0;
}

}  // namespace

// rows (count, 6) int64 on the host: p, g, m, v, step pointers and element
// count; partials: at least min(chunks, kNormBlocks) f32 on the device,
// written when norm is set. Adds one to each step; with norm, writes the
// partial sums of the clipped gradients' squares.
extern "C" int clipped_adam_norm(const void* rows, int count, int norm,
                                 int clip, float clip_value, void* partials,
                                 void* stream) {
  Tensors ts;
  if (!make_tensors(rows, count, &ts) || (norm && partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = ts.first_chunk[count];
  const int blocks = !norm || chunks <= 1
                         ? 1
                         : static_cast<int>(chunks < kNormBlocks
                                                ? chunks : kNormBlocks);
  clipped_adam_norm_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      ts, norm, clip, clip_value,
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// rows as above; partials and num_partials: every norm pass's sums (null
// and 0 without a norm clip); lr_ptr: a 0-d f32 device tensor, or null to
// take lr.
extern "C" int clipped_adam_update(
    const void* rows, int count, const void* partials, int num_partials,
    int clip, float clip_value, float clip_norm, const void* lr_ptr,
    float lr, float beta1, float beta2, float lerp_weight,
    float one_minus_beta2, float eps, float weight_decay, void* stream) {
  Tensors ts;
  if (!make_tensors(rows, count, &ts)
      || (partials != nullptr && num_partials <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = ts.first_chunk[count];
  if (chunks == 0) return 0;
  int blocks = 0;
  const int error = resident_blocks(&blocks);
  if (error != 0) return error;
  if (chunks < blocks) blocks = static_cast<int>(chunks);
  const Update u{static_cast<const float*>(partials), num_partials, clip,
                 clip_value, clip_norm, static_cast<const float*>(lr_ptr),
                 lr, beta1, beta2, lerp_weight, one_minus_beta2, eps,
                 weight_decay};
  clipped_adam_update_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(ts, u);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* clipped_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
