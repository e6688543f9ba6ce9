// Fixed-point dequantize with the overflow mask on Hopper: the receive
// side of the SyncAgtr path (core/quantize.py). Sentinel lanes are flagged
// so the caller repairs exactly those lanes in fp32 (paper §5.2.1).
//
// Replaces kernels/dequantize.py:dequantize_pallas ((256, 128) blocks of a
// (rows, 128) stream). The value is q * (1 / f32(scale)), a multiply by the
// fp32 reciprocal that the wrapper computes once, never a divide, so it
// agrees bit for bit with the reference and with fused_read; the mask is
// q == +-(2**31 - 1). One thread an element, flat stream. It moves 9 bytes
// an element (int32 in, fp32 and one mask byte out): a 25 MiB bucket is
// 59.0 MB, about 18 us at 3.35 TB/s, bound by memory.
#include "inc.cuh"

__global__ void inc_k_dequantize(const int32_t* q, int64_t n, float inv,
                                 float* out, uint8_t* mask) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        int32_t v = q[i];
        out[i] = __fmul_rn(__int2float_rn(v), inv);
        mask[i] = inc_is_sentinel(v);
    }
}

extern "C" int repro_dequantize(const int32_t* q, int64_t n, float inv,
                                float* out, uint8_t* mask, void* stream) {
    if (n <= 0) return 0;
    inc_k_dequantize<<<inc_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        q, n, inv, out, mask);
    return (int)cudaGetLastError();
}
