// Hopper (sm_90a) building blocks in inline PTX for the bf16 kernels of K1
// (fused_nerf.cu) and K2 (fused_nerf_train.cu): mbarriers, bulk
// asynchronous copies (the copy engine behind TMA) in both directions,
// warpgroup matrix products (wgmma) on shared-memory operands in the
// 128-byte swizzled layout, and the fences and barriers between them.
//
// The layout. An operand is stored as blocks of 128-byte rows (64 bf16);
// the 16-byte chunk q of row r sits at chunk q ^ (r % 8) of its row, and
// each block starts on a 1024-byte boundary.
// * K-major (desc_sw128): a row holds 64 K-values of one M or N index. The
//   descriptor names the start of a k16 step (block + 32 bytes per step, so
//   bits 7-9 of the start address stay 0 and the base offset field is 0),
//   the 1024-byte stride between 8-row groups (SBO) and the 128-byte
//   swizzle; the leading offset is unused.
// * MN-major (desc_sw128_mn, wgmma's imm-trans = 1): a row holds 64 M or N
//   values of one K index, so the same bytes read as the transpose. A k16
//   step starts 16 rows (2048 bytes) on; SBO is again the 1024 bytes
//   between 8-row K groups, and LBO the stride between 64-wide M or N atoms
//   (kMnAtomStride: the next 8 KB block of 64 rows).

#pragma once

#include <cstdint>

namespace hopper {

constexpr uint32_t kMnAtomStride = 64 * 128;   // bytes between MN atoms

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (the copy
// engine); a block barrier follows before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; its bytes count towards the
// transaction count of barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One bulk copy of `bytes` from shared to global memory, in this thread's
// current bulk group (bulk_commit closes it).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's bulk groups are complete, their writes to
// global memory visible, and orders them before later async-proxy reads.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ---- fences, barriers, registers -----------------------------------------

// Orders this thread's generic-proxy stores to shared memory before later
// async-proxy reads of it (the next wgmma).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over `threads` threads (a warpgroup: 128) with its own id
// (1..15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <uint32_t kRegs>
__device__ __forceinline__ void regs_increase() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

template <uint32_t kRegs>
__device__ __forceinline__ void regs_decrease() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kRegs));
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t kSbo = 1024 >> 4;
  constexpr uint64_t kLbo = 1;                     // unused by this layout
  constexpr uint64_t kSwizzle128 = 1;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (kLbo << 16)
         | (kSbo << 32) | (kSwizzle128 << 62);
}

// The MN-major descriptor: SBO the 1024 bytes between 8-row K groups, LBO
// the kMnAtomStride bytes between 64-column MN atoms.
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr) {
  constexpr uint64_t kSbo = 1024 >> 4;
  constexpr uint64_t kLbo = kMnAtomStride >> 4;
  constexpr uint64_t kSwizzle128 = 1;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (kLbo << 16)
         | (kSbo << 32) | (kSwizzle128 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n"
               :: "n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma fence or wait: the registers change under an in-flight
// product without the compiler seeing it.
template <int kCount>
__device__ __forceinline__ void fence_registers(float* d) {
#pragma unroll
  for (int i = 0; i < kCount; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x N, f32, the warpgroup's fragment) = A (64 x 16) * B (16 x N)
// [+ D when `accumulate`], both operands bf16 in shared memory, each
// K-major or, with its transpose immediate 1, MN-major.
// Thread t of the warpgroup holds d[4j + 2h + c] at row
// 16 (t / 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + c.
template <int N, int kTransA, int kTransB>
struct Mma;

template <int kTransA, int kTransB>
struct Mma<16, kTransA, kTransB> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  }
};

template <int kTransA, int kTransB>
struct Mma<32, kTransA, kTransB> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  }
};

template <int kTransA, int kTransB>
struct Mma<64, kTransA, kTransB> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  }
};

template <int kTransA, int kTransB>
struct Mma<128, kTransA, kTransB> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  }
};

template <int kTransA, int kTransB>
struct Mma<256, kTransA, kTransB> {
  static __device__ __forceinline__ void run(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
  }
};

// D = op(A) op(B) [+ D]: kTransA / kTransB = 1 reads that operand MN-major
// (desc_sw128_mn). An N that is not a power of two runs as the largest
// power of two below it and the rest: the accumulator runs on, B's
// descriptor moves on by the N already done (kDone): 128 bytes a row
// K-major; MN-major, kMnAtomStride bytes a 64-column atom and 2 bytes a
// column within one.
template <int N, int kTransA = 0, int kTransB = 0, int kDone = 0>
__device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                    int accumulate) {
  constexpr int kHead = (N >= 256) ? 256 : (N >= 128) ? 128 : (N >= 64) ? 64
                        : (N >= 32) ? 32 : 16;
  static_assert(N % 16 == 0 && N >= 16 && N <= 256, "N: 16..256 by 16");
  constexpr uint32_t kOffset =
      kTransB ? (kDone / 64) * kMnAtomStride + (kDone % 64) * 2
              : kDone * 128;
  Mma<kHead, kTransA, kTransB>::run(d, a, b + (kOffset >> 4), accumulate);
  if constexpr (N > kHead) {
    mma<N - kHead, kTransA, kTransB, kDone + kHead>(d + kHead / 2, a, b,
                                                    accumulate);
  }
}

}  // namespace hopper
