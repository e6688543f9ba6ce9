// Fixed-point quantize on Hopper: the transmit side of the SyncAgtr path
// (core/quantize.py), every gradient element scaled by 10**Precision,
// rounded half to even and saturated to the overflow sentinels.
//
// Replaces kernels/quantize.py:quantize_pallas, which tiles a (rows, 128)
// fp32 stream in (256, 128) VMEM blocks. Here the stream is flat, one
// thread an element, neighbouring threads on neighbouring addresses; the
// arithmetic is inc_quantize of inc.cuh (__fmul_rn keeps the product from
// fusing, rintf rounds half to even, the thresholds compare in fp32 as the
// reference does). It moves 8 bytes an element (fp32 in, int32 out): a
// 25 MiB bucket is 52.4 MB, about 16 us at 3.35 TB/s, bound by memory.
#include "inc.cuh"

__global__ void inc_k_quantize(const float* x, int64_t n, float scale,
                               int32_t* out) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x)
        out[i] = inc_quantize(x[i], scale);
}

extern "C" int repro_quantize(const float* x, int64_t n, float scale,
                              int32_t* out, void* stream) {
    if (n <= 0) return 0;
    inc_k_quantize<<<inc_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        x, n, scale, out);
    return (int)cudaGetLastError();
}
