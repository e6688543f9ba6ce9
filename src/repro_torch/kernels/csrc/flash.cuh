// What kernel 11 (flash_attn.cu) and its backward kernels
// (flash_attn_bwd.cu) share: shared-memory addresses, the bf16 pack and
// base-2 exponent of their softmax, and Hopper's warpgroup products
// (wgmma): the shared-memory matrix descriptor, the fence, commit and wait
// of an async group, register fences, and the m64nNk16 bf16 products with
// fp32 accumulators, B from shared memory K-major or MN-major (the
// transpose bit), A from shared memory or from registers.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>

// Internal linkage: each library that includes this header (flash_attn,
// flash_attn_bwd) gets its own copy.
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode in bits 62-63
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
        | ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
// that is in flight on these registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
    #pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
    #pragma unroll
    for (int i = 0; i < N; ++i)
        #pragma unroll
        for (int j = 0; j < M; ++j)
            asm volatile("" : "+r"(r[i][j]) :: "memory");
}

#define WG_R16 "{" \
    "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15}"

#define WG_R32 "{" \
    "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31}"

#define WG_R64 "{" \
    "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63}"

#define WG_R128 "{" \
    "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63, " \
    "%64, %65, %66, %67, %68, %69, %70, %71, " \
    "%72, %73, %74, %75, %76, %77, %78, %79, " \
    "%80, %81, %82, %83, %84, %85, %86, %87, " \
    "%88, %89, %90, %91, %92, %93, %94, %95, " \
    "%96, %97, %98, %99, %100, %101, %102, %103, " \
    "%104, %105, %106, %107, %108, %109, %110, %111, " \
    "%112, %113, %114, %115, %116, %117, %118, %119, " \
    "%120, %121, %122, %123, %124, %125, %126, %127}"

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_D32(i) WG_D16(i), WG_D16(i + 16)
#define WG_D64(i) WG_D32(i), WG_D32(i + 32)
#define WG_D128(i) WG_D64(i), WG_D64(i + 64)

// d (64 x N fp32) = a (64 x 16, shared, K-major) . b (N x 16, shared,
// K-major)^T + (scale_d ? d : 0)
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);

// d (64 x N fp32) += a (64 x 16 bf16, registers) . b (16 x N, shared,
// MN-major: the transpose bit)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

#define WG_SS(N, R, ARGS, IA, IB, IS)                                         \
    template <>                                                               \
    __device__ __forceinline__ void wgmma_ss<N>(float (&d)[R], uint64_t da,   \
                                                uint64_t db, int scale_d) {   \
        asm volatile(                                                         \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                 \
            "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "       \
            WG_R##R ", %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"               \
            : ARGS : "l"(da), "l"(db), "r"(scale_d));                         \
    }

#define WG_RS(N, R, ARGS, I0, I1, I2, I3, IB, IS)                             \
    template <>                                                               \
    __device__ __forceinline__ void wgmma_rs<N>(float (&d)[R],                \
                                                const uint32_t (&a)[4],       \
                                                uint64_t db) {                \
        asm volatile(                                                         \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                 \
            "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "       \
            WG_R##R ", {%" #I0 ", %" #I1 ", %" #I2 ", %" #I3 "}, %" #IB       \
            ", p, 1, 1, 1;\n}\n"                                              \
            : ARGS : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
              "r"(1));                                                        \
    }

WG_SS(64, 32, WG_D32(0), 32, 33, 34)
WG_SS(128, 64, WG_D64(0), 64, 65, 66)
WG_RS(32, 16, WG_D16(0), 16, 17, 18, 19, 20, 21)
WG_RS(64, 32, WG_D32(0), 32, 33, 34, 35, 36, 37)
WG_RS(128, 64, WG_D64(0), 64, 65, 66, 67, 68, 69)
WG_RS(256, 128, WG_D128(0), 128, 129, 130, 131, 132, 133)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

}  // namespace
