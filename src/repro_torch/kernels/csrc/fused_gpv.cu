// The device-resident GPV data plane on Hopper: the fused transmit and
// receive verbs of a DeviceSegment (core/inc_map.py).
//
// repro_fused_addto replaces kernels/fused_gpv.py:fused_addto_pallas: it
// quantizes an fp32 stream and saturating-adds it into regs[start, start+n).
// repro_fused_read replaces fused_read_pallas: it gathers regs[start,
// start+n), dequantizes by the fp32 reciprocal and writes the sentinel mask.
// Both are one elementwise pass, bound by memory: fused_addto moves 12 bytes
// an element (fp32 in, int32 read and written back), fused_read 9 (int32
// in, fp32 and one mask byte out); at 3.35 TB/s a 40 000-slot segment is
// about 0.14 us of traffic, so at the path's sizes launch latency
// dominates. The design keeps each element in one thread with neighbouring
// threads on neighbouring addresses, and updates the segment in place (the
// Pallas kernel copies the whole segment to its output).
//
// repro_fused_scatter replaces fused_scatter_pallas: the same quantize, then
// the ordered saturating scatter-add of scatter.cuh (one cluster launch with
// its scratch in distributed shared memory at the path's segments).
//
// repro_fused_fold replaces fused_fold_pallas, the device lane of
// local_accum: R fp32 rounds of n elements, each quantized and folded in
// round order with the switch's saturating add, so a round that saturates
// leaves the sticky sentinel (never the exact int64 sum of the host lane's
// fold_rounds). The fold is sequential in the rounds, so one thread owns
// one element and loops over R; at round r neighbouring threads read
// neighbouring addresses of row r, so every read is coalesced. It moves
// 4R + 4 bytes an element (each round read once, the fold written once):
// at R = 8 and n = 262 144 that is 9.4 MB, about 2.8 us at 3.35 TB/s, and
// the loop keeps the accumulator in a register, so nothing but the rounds
// and the result touches device memory (the Pallas kernel holds the whole
// (R, n) stack in one VMEM block).
#include "scatter.cuh"

__global__ void inc_k_fused_addto(int32_t* regs, const float* fvals,
                                  int64_t n, float scale) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x)
        regs[i] = inc_sat_add(regs[i], inc_quantize(fvals[i], scale));
}

__global__ void inc_k_fused_read(const int32_t* regs, int64_t n, float inv,
                                 float* out, uint8_t* mask) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        int32_t q = regs[i];
        out[i] = __fmul_rn(__int2float_rn(q), inv);
        mask[i] = inc_is_sentinel(q);
    }
}

__global__ void inc_k_fused_fold(const float* fstack, int64_t rounds,
                                 int64_t n, float scale, int32_t* out) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        int32_t acc = inc_quantize(fstack[i], scale);
        for (int64_t r = 1; r < rounds; ++r)
            acc = inc_sat_add(acc, inc_quantize(fstack[r * n + i], scale));
        out[i] = acc;
    }
}

extern "C" int repro_fused_addto(int32_t* regs, int64_t start,
                                 const float* fvals, int64_t n, float scale,
                                 void* stream) {
    if (n <= 0) return 0;
    inc_k_fused_addto<<<inc_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        regs + start, fvals, n, scale);
    return (int)cudaGetLastError();
}

extern "C" int repro_fused_read(const int32_t* regs, int64_t start,
                                int64_t n, float inv, float* out,
                                uint8_t* mask, void* stream) {
    if (n <= 0) return 0;
    inc_k_fused_read<<<inc_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        regs + start, n, inv, out, mask);
    return (int)cudaGetLastError();
}

// words and unsafe: the large lane's scratch, null on the cluster lane
extern "C" int repro_fused_scatter(int32_t* regs, int64_t n_slots,
                                   const int32_t* idx, const float* fvals,
                                   int64_t k, float scale, inc_u64* words,
                                   uint8_t* unsafe, void* stream) {
    return (int)inc_scatter(regs, n_slots, idx, F32Vals{fvals, scale}, k,
                            words, unsafe, (cudaStream_t)stream);
}

extern "C" int repro_fused_fold(const float* fstack, int64_t rounds,
                                int64_t n, float scale, int32_t* out,
                                void* stream) {
    if (n <= 0 || rounds <= 0) return 0;
    inc_k_fused_fold<<<inc_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        fstack, rounds, n, scale, out);
    return (int)cudaGetLastError();
}
