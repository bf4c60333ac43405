// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels
// (systolic_gemm.cu, flash_attention.cu): mbarriers, TMA loads and stores,
// 128-byte-swizzle wgmma descriptors, the wgmma instructions with their
// fences, setmaxnreg, cp.async, and the host-side lookup of
// cuTensorMapEncodeTiled.  Every function is inline; a source that
// includes this header is still built by one nvcc call with a plain C
// interface (repro_torch/kernels/_build.py passes -I for this directory and
// hashes this header into every library's name).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// shared memory, mbarriers, named barriers, proxies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// the barriers' initialisation is visible to the other threads and to TMA
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed.
// Keep the loop bare: a deadlock check here (clock64 and a trap) cost the
// flash kernel's consumers registers and made ptxas spill.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// barrier of the 128 threads of one warpgroup (id 0 is __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// named barrier `id` of `threads` threads (a multiple of 32): sync waits
// until all of them have synced or arrived; arrive counts the caller in
// and goes on
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory are visible to the TMA unit
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// hand registers back (producer) or take them (consumers); all four warps
// of a warpgroup execute it together
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---------------------------------------------------------------------------
// TMA: boxes of a tensor map into and out of shared memory
// ---------------------------------------------------------------------------

// one 2-D box into shared memory; the barrier counts its bytes (the whole
// box, zero-filled where it lies out of bounds)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

// the same for a 3-D map: zero-filled past each dimension's bound, so a box
// that runs past the rows of one head reads zeros, not the next head
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar) : "memory");
}

// one 2-D box from shared memory into a tensor map (clipped at its bounds)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// one 3-D box from shared memory (clipped at every dimension's bound)
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"((uint64_t)map), "r"(src),
      "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N committed store groups still read their shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// a contiguous run of `bytes` bytes (a multiple of 16; both addresses
// 16-byte aligned) from global into shared memory, counted by the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory descriptor of a tile in the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers across the
// asynchronous wgmma instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the accumulator operands: "+f" (read and written) or "=f" (written only)
#define HOPPER_D8(c, d, i)                                                 \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),             \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define HOPPER_D64(c, d, i)                                                \
  HOPPER_D8(c, d, i), HOPPER_D8(c, d, i + 8), HOPPER_D8(c, d, i + 16),     \
      HOPPER_D8(c, d, i + 24), HOPPER_D8(c, d, i + 32),                    \
      HOPPER_D8(c, d, i + 40), HOPPER_D8(c, d, i + 48),                    \
      HOPPER_D8(c, d, i + 56)
#define HOPPER_R64                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                     \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "           \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "           \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "           \
  "%60, %61, %62, %63"
#define HOPPER_R64_127                                                     \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "           \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "           \
  "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "           \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "     \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "     \
  "%122, %123, %124, %125, %126, %127"

// D (64 x N, float32) (+)= A (64 x 16) B (16 x N), bf16 operands; the
// width N is the accumulator's: 128 floats a thread for N = 256, 64 for
// N = 128.  "ss": A and B by shared-memory descriptor, A K-major; "rs": A
// from registers (the m16n8k16 A fragment of each of the warpgroup's four
// warps).  TRANS_B = 0: B is K-major (its N rows hold k contiguously);
// 1: N-major (its k rows hold n contiguously), read through the transpose
// bit.  scale_d = 0 overwrites D; wgmma_ss_set always does, and does not
// read D's old values, so they need not stay live before it.

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" HOPPER_R64
      ", " HOPPER_R64_127 "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : HOPPER_D64("+f", d, 0), HOPPER_D64("+f", d, 64)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R64
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_D64("+f", d, 0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_set(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R64
      "}, %64, %65, 0, 1, 1, 0, %66;\n"
      : HOPPER_D64("=f", d, 0)
      : "l"(da), "l"(db), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOPPER_D64("+f", d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// the same at N = 64 (32 floats a thread), A from registers: flash
// attention's P v at Dv = 64
#define HOPPER_D32(c, d, i)                                                \
  HOPPER_D8(c, d, i), HOPPER_D8(c, d, i + 8), HOPPER_D8(c, d, i + 16),     \
      HOPPER_D8(c, d, i + 24)
#define HOPPER_R32                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                     \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "           \
  "%24, %25, %26, %27, %28, %29, %30, %31"

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_D32("+f", d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// the same at N = 96 and N = 120 (48 and 60 floats a thread), A from
// registers: flash attention's P v at Dv = 96 and 120.  v's tile is
// N-major in the 128-byte swizzle, whose atom is 64 columns wide, so the
// product ends inside its second atom; on an H100 it gives what n = 128
// over the zero-filled columns gives, and faster (PERF.md)
#define HOPPER_D4(c, d, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define HOPPER_R48                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                     \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "           \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "           \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_R48_59                                                      \
  ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59"

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {" HOPPER_R48
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : HOPPER_D32("+f", d, 0), HOPPER_D8("+f", d, 32),
        HOPPER_D8("+f", d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[60],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {" HOPPER_R48
      HOPPER_R48_59 "}, {%60, %61, %62, %63}, %64, p, 1, 1, %66;\n}\n"
      : HOPPER_D32("+f", d, 0), HOPPER_D8("+f", d, 32),
        HOPPER_D8("+f", d, 40), HOPPER_D8("+f", d, 48),
        HOPPER_D4("+f", d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// D (64 x 64, float32) (+)= A (64 x 16) B (16 x 64), both operands by
// shared-memory descriptor (32 floats a thread): the backward of flash
// attention's score-shaped products over 64-row tiles
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_R32
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_D32("+f", d, 0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_set(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_R32
      "}, %32, %33, 0, 1, 1, 0, %34;\n"
      : HOPPER_D32("=f", d, 0)
      : "l"(da), "l"(db), "n"(TRANS_B));
}

#undef HOPPER_D4
#undef HOPPER_D8
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_R32
#undef HOPPER_R48
#undef HOPPER_R48_59
#undef HOPPER_R64
#undef HOPPER_R64_127

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

// 16 bytes from global into shared memory, zero-filled when src_bytes = 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found once through the runtime (no
// -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace hopper
