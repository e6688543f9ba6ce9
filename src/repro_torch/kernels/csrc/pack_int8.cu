// Block-scaled int8 pack and unpack on Hopper: the int8 wire format of
// ops.pack_int8 / ops.unpack_int8, one fp32 scale per 128-lane row.
//
// Replaces kernels/pack_int8.py:pack_int8_pallas and unpack_int8_pallas,
// which take (256, 128) fp32 VMEM blocks and reduce each row's amax across
// the TPU's 128 lanes. Here one warp owns one row: each of its 32 threads
// loads a float4 (16 bytes, neighbouring threads on neighbouring
// addresses), the row's amax is a warp-shuffle max, and lane 0 writes the
// scale. scale = amax / 127 (1 for a zero row) and q = rint(x / scale)
// clamped to +-127 are IEEE divides (__fdiv_rn: no reciprocal, no
// --use_fast_math), rintf rounds half to even, as jnp.round does.
// Unpack is one thread per four elements (a char4 in, a float4 out),
// q * scale[row].
//
// Both are bound by memory: 4 bytes in and 1 out an element (or the
// reverse), plus 4 bytes a row; a 25 MiB bucket (6 553 600 fp32) is
// 33.0 MB, about 10 us at 3.35 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

#define PACK_LANES 128

__global__ void inc_k_pack_int8(const float4* __restrict__ x, int64_t rows,
                                char4* __restrict__ q,
                                float* __restrict__ scale) {
    const int lane = threadIdx.x & 31;
    const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
    for (int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
         row < rows; row += warps) {
        const float4 v = x[row * (PACK_LANES / 4) + lane];
        float a = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                        fmaxf(fabsf(v.z), fabsf(v.w)));
        for (int off = 16; off > 0; off >>= 1)
            a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
        const float s = a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
        char4 o;
        o.x = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.x, s)), -127.0f), 127.0f);
        o.y = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.y, s)), -127.0f), 127.0f);
        o.z = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.z, s)), -127.0f), 127.0f);
        o.w = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.w, s)), -127.0f), 127.0f);
        q[row * (PACK_LANES / 4) + lane] = o;
        if (lane == 0) scale[row] = s;
    }
}

// four elements a thread: a char4 load and a float4 store (a row is 32
// of them, so each group of four shares its row's scale)
__global__ void inc_k_unpack_int8(const char4* __restrict__ q,
                                  const float* __restrict__ scale,
                                  int64_t n4, float4* __restrict__ out) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
         i += (int64_t)gridDim.x * blockDim.x) {
        const char4 c = q[i];
        const float s = scale[i / (PACK_LANES / 4)];
        out[i] = make_float4(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s),
                             __fmul_rn((float)c.z, s), __fmul_rn((float)c.w, s));
    }
}

static int grid_for(int64_t work, int threads) {
    int64_t b = (work + threads - 1) / threads;
    return (int)(b < 1 ? 1 : (b > 65535 ? 65535 : b));
}

// x: fp32 (rows, 128), 16-byte aligned -> q int8 (rows, 128), scale (rows,)
extern "C" int repro_pack_int8(const float* x, int64_t rows, int8_t* q,
                               float* scale, void* stream) {
    if (rows <= 0) return 0;
    inc_k_pack_int8<<<grid_for(rows * 32, 256), 256, 0,
                      (cudaStream_t)stream>>>(
        (const float4*)x, rows, (char4*)q, scale);
    return (int)cudaGetLastError();
}

// q int8 (rows, 128), 4-byte aligned, scale (rows,) -> out fp32 (rows, 128)
extern "C" int repro_unpack_int8(const int8_t* q, const float* scale,
                                 int64_t rows, float* out, void* stream) {
    if (rows <= 0) return 0;
    const int64_t n4 = rows * (PACK_LANES / 4);
    inc_k_unpack_int8<<<grid_for(n4, 256), 256, 0, (cudaStream_t)stream>>>(
        (const char4*)q, scale, n4, (float4*)out);
    return (int)cudaGetLastError();
}
