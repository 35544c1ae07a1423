// Hopper building blocks shared by the tensor-core attention kernels
// (flash_attention_sm90.cu, the forward, and flash_attention_bwd_sm90.cu,
// its backward): wgmma with bf16 operands and float32 accumulators, the
// swizzled shared-memory layout it reads, mbarriers, TMA copies and the
// tensor maps that drive them. Plain inline device functions: each source
// that includes this compiles its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_sm90 {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t b, h, l;  // element strides of the batch, head and position dims
};

// ---------------------------------------------------------------------------
// wgmma wrappers: every accumulator register is named in the asm, so the
// arrays are indexed with constants only. ss: A and B from shared memory,
// both K-major. rs<kTransB>: A from registers (bf16 pairs), B from shared
// memory K-major (kTransB = 0: K in S = Q.K^T) or MN-major (kTransB = 1:
// V in O += P.V).
// ---------------------------------------------------------------------------

#define SM90_D8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SM90_D32(i) SM90_D8(i), SM90_D8(i + 8), SM90_D8(i + 16), SM90_D8(i + 24)
// the A fragment, B's descriptor, the transpose immediate and scale-d (1: accumulate)
#define SM90_RS_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(kTransB), "r"(1)

template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  // d[16] += A (shared, K-major) * B (shared, K-major), m64n32k16
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, 0, 0;\n}\n"
        : SM90_D8(0), SM90_D8(8)
        : "l"(da), "l"(db), "r"(1));
  }
  // d[16] += A (registers) * B (shared), m64n32k16
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
        : SM90_D8(0), SM90_D8(8)
        : SM90_RS_IN);
  }
};

template <> struct Wgmma<64> {
  // d[32] += A (shared, K-major) * B (shared, K-major), m64n64k16
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n}\n"
        : SM90_D32(0)
        : "l"(da), "l"(db), "r"(1));
  }
  // d[32] += A (registers) * B (shared), m64n64k16
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        : SM90_D32(0)
        : SM90_RS_IN);
  }
};

template <> struct Wgmma<80> {
  // d[40] += A (registers) * B (shared), m64n80k16
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39},"
        " {%40, %41, %42, %43}, %44, p, 1, 1, %45;\n}\n"
        : SM90_D32(0), SM90_D8(32)
        : SM90_RS_IN);
  }
};

template <> struct Wgmma<120> {
  // d[60] += A (registers) * B (shared), m64n120k16
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[60], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59},"
        " {%60, %61, %62, %63}, %64, p, 1, 1, %65;\n}\n"
        : SM90_D32(0), SM90_D8(32), SM90_D8(40), SM90_D8(48), SM90_D4(56)
        : SM90_RS_IN);
  }
};

template <> struct Wgmma<128> {
  // d[64] += A (registers) * B (shared), m64n128k16
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
        : SM90_D32(0), SM90_D32(32)
        : SM90_RS_IN);
  }
};

template <> struct Wgmma<192> {
  // d[96] += A (registers) * B (shared), m64n192k16
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95},"
        " {%96, %97, %98, %99}, %100, p, 1, 1, %101;\n}\n"
        : SM90_D32(0), SM90_D32(32), SM90_D32(64)
        : SM90_RS_IN);
  }
};

template <> struct Wgmma<256> {
  // d[128] += A (registers) * B (shared), m64n256k16
  template <int kTransB>
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %134, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " {%128, %129, %130, %131}, %132, p, 1, 1, %133;\n}\n"
        : SM90_D32(0), SM90_D32(32), SM90_D32(64), SM90_D32(96)
        : SM90_RS_IN);
  }
};

#undef SM90_RS_IN
#undef SM90_D32
#undef SM90_D8
#undef SM90_D4

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for a register A operand: it stays in its registers until the
// wgmma that reads it has been waited for.
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy; wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// spins until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a barrier whose phase completes after `count` arrivals (and the bytes any
// expect_tx announces)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// one arrival where `pred` holds, releasing this thread's earlier reads and
// writes to the waiters; predicated inside the asm, so that no branch
// diverges between a wgmma and its wait (ptxas would serialise the wgmma)
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<uint32_t>(pred))
      : "memory");
}
// a barrier of `threads` threads (a multiple of 32) on hardware barrier `id`
// (1-15; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// a warpgroup's per-thread register budget, raised or lowered; every warp of
// the warpgroup executes it
template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
// TMA: the box at coordinates (c0 innermost .. c3) of the tensor map into
// shared memory, completion counted in bytes on the barrier
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// A bulk copy of `bytes` contiguous bytes (a multiple of 16, both addresses
// 16-byte aligned) into shared memory, completion counted on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// four 8x8 bf16 matrices from shared memory, lane L giving the address of
// row L % 8 of matrix L / 8; thread t gets row t / 4, columns 2(t % 4) and
// 2(t % 4) + 1 of each (wgmma's A fragment when the four are the (rows
// 0-7, 8-15) x (columns 0-7, 8-15) blocks of a warp's 16 x 16 k-step)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint4 ld_shared_b128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x within 2 ulp; +0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Shared-memory layout of a ROWS-row bf16 tile of DH columns (a Q, K, V or
// dO tile): the columns are cut into atoms of one swizzle width (64
// elements, 128 bytes; 32 and 64 bytes at DH 32), each atom ROWS rows of
// that width, and the 16-byte chunks of row j are permuted by XOR with the
// row's bits, as wgmma's 128B (64B) swizzle mode expects. A tile is read
// K-major when its columns are the product's reduction dim (Q and K in S =
// Q.K^T), MN-major when they are the output dim (V in O += P.V).
template <int DH, int ROWS> struct Tile {
  static_assert(DH == 32 || DH % 64 == 0, "a tile is whole swizzle atoms");
  static constexpr int kRowBytes = DH >= 64 ? 128 : 64;
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr int kElemsPerRow = kRowBytes / 2;
  static constexpr int kAtoms = DH / kElemsPerRow;
  static constexpr int kAtomBytes = ROWS * kRowBytes;
  static constexpr int kBytes = ROWS * DH * 2;
  static constexpr uint64_t kMode = DH >= 64 ? 1 : 2;  // descriptor: 1 = 128B swizzle, 2 = 64B

  // byte offset of 16-byte chunk c (of DH / 8) of row j
  static __device__ __forceinline__ uint32_t offset(int j, int c) {
    const uint32_t lin = (c / kChunksPerRow) * kAtomBytes + j * kRowBytes + (c % kChunksPerRow) * 16;
    return lin ^ ((lin >> 3) & ((kChunksPerRow - 1) << 4));
  }
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
           (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (kMode << 62);
  }
  // byte offset of k-step kk (16 elements of DH) from a tile's start
  static __host__ __device__ constexpr uint32_t k_offset(int kk) {
    return (kk * 16 / kElemsPerRow) * kAtomBytes + (kk * 16 % kElemsPerRow) * 2;
  }
  // k-step kk of a K-major operand from the descriptor of its k-step 0: only
  // the start address field moves (a shared-memory address >> 4 stays below
  // 2^14, so the sum never carries out of the field)
  static __device__ __forceinline__ uint64_t k_step(uint64_t desc0, int kk) {
    return desc0 + (k_offset(kk) >> 4);
  }
  // the same for k-step kk (16 rows) of an MN-major operand
  static __device__ __forceinline__ uint64_t mn_step(uint64_t desc0, int kk) {
    return desc0 + ((kk * 16 * kRowBytes) >> 4);
  }
  // k-step kk (16 elements of DH) of a K-major operand: inside one atom the
  // start moves by 32 bytes; SBO is the stride of 8-row groups
  static __device__ __forceinline__ uint64_t k_major(uint32_t base, int kk) {
    const int e = kk * 16;
    return desc(base + (e / kElemsPerRow) * kAtomBytes + (e % kElemsPerRow) * 2, 16,
                8 * kRowBytes);
  }
  // k-step kk (16 rows) of an MN-major operand: LBO is the stride between
  // atoms along DH, SBO the stride of 8-row groups
  static __device__ __forceinline__ uint64_t mn_major(uint32_t base, int kk) {
    return desc(base + kk * 16 * kRowBytes, kAtomBytes, 8 * kRowBytes);
  }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, heads, L, width] tensor through its strides as a 4-d map
// (width, L, heads, B), one box = one swizzle atom of a tile T (rows past L
// and columns past the width arrive as zeros)
template <typename T>
static bool encode_4d(CUtensorMap* map, const void* base, int batch, int heads, int len,
                      int width, const Strides& st) {
  constexpr int DH = T::kElemsPerRow * T::kAtoms;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.l) * 2, static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {T::kElemsPerRow, T::kAtomBytes / T::kRowBytes, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                DH >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace repro_sm90
