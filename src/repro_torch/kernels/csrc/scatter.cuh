// Ordered saturating scatter-add into a register segment, shared by
// sparse_addto (int32 values) and fused_scatter (fp32 values quantized in
// the kernel).
//
// Replaces the serial fori_loop of the TPU kernels (kernels/sparse_addto.py
// sparse_addto_pallas, kernels/fused_gpv.py fused_scatter_pallas), which
// apply k updates one by one in stream order. A plain atomicAdd scatter is
// wrong here: once a slot saturates, the order of its updates decides the
// result. The split of kernels/ops.py:sparse_addto_host makes it parallel:
//
//   1. mass[j] = sum |q_i| over the updates of slot j (int64 atomics);
//   2. slot j is safe when |regs[j]| + mass[j] <= SAT_MAX: no prefix of
//      its updates, in any order, can reach a sentinel, so its updates
//      collapse into an exact int64 atomic sum; other updates are flagged;
//   3. every safe slot takes its sum in one add;
//   4. one block walks the flags in stream order (ballots into shared
//      memory, one thread applying the flagged updates), so unsafe slots
//      see exactly the sequential oracle; it returns at once when step 2
//      flagged nothing, the common case on the path.
//
// Every update of a slot falls on the same side of the split, and the
// safe and unsafe slots are disjoint, so the result is exact. The bound
// is memory: k reads of (idx, value) and a read-modify-write of each
// touched slot; the scratch (two int64 words per slot) stays in L2 at a
// 40 000-slot segment. Step 4 is serial only over flagged updates.
#pragma once
#include "inc.cuh"

typedef unsigned long long inc_u64;

struct IntVals {
    const int32_t* v;
    __device__ __forceinline__ int32_t operator()(int64_t i) const {
        return v[i];
    }
};

struct F32Vals {
    const float* v;
    float scale;
    __device__ __forceinline__ int32_t operator()(int64_t i) const {
        return inc_quantize(v[i], scale);
    }
};

__device__ __forceinline__ bool inc_in_range(int32_t j, int64_t n_slots) {
    return j >= 0 && j < n_slots;
}

__global__ void inc_k_scatter_zero(inc_u64* words, int64_t n) {
    for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
         j += (int64_t)gridDim.x * blockDim.x)
        words[j] = 0;
}

template <class V>
__global__ void inc_k_scatter_mass(const int32_t* idx, V val, int64_t k,
                                   int64_t n_slots, inc_u64* mass) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < k;
         i += (int64_t)gridDim.x * blockDim.x) {
        int32_t j = idx[i];
        if (!inc_in_range(j, n_slots)) continue;
        long long q = val(i);
        atomicAdd(&mass[j], (inc_u64)(q < 0 ? -q : q));
    }
}

template <class V>
__global__ void inc_k_scatter_safe_sum(const int32_t* regs,
                                       const int32_t* idx, V val, int64_t k,
                                       int64_t n_slots, const inc_u64* mass,
                                       inc_u64* sum, inc_u64* n_unsafe,
                                       uint8_t* unsafe) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < k;
         i += (int64_t)gridDim.x * blockDim.x) {
        int32_t j = idx[i];
        if (!inc_in_range(j, n_slots)) { unsafe[i] = 0; continue; }
        long long r = regs[j];
        bool safe = (r < 0 ? -r : r) + (long long)mass[j] <= INC_SAT_MAX;
        unsafe[i] = !safe;
        if (safe)
            atomicAdd(&sum[j], (inc_u64)(long long)val(i));
        else
            atomicAdd(n_unsafe, 1ull);
    }
}

__global__ void inc_k_scatter_apply_safe(int32_t* regs, int64_t n_slots,
                                         const inc_u64* mass,
                                         const inc_u64* sum) {
    for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
         j < n_slots; j += (int64_t)gridDim.x * blockDim.x) {
        long long m = (long long)mass[j];
        if (m == 0) continue;
        long long r = regs[j];
        if ((r < 0 ? -r : r) + m <= INC_SAT_MAX)
            regs[j] = (int32_t)(r + (long long)sum[j]);
    }
}

// one block of 1024 threads: each pass ballots 1024 flags into shared
// memory, then lane 0 of warp 0 applies the flagged updates in stream
// order, visiting only the non-empty ballot words
template <class V>
__global__ void inc_k_scatter_serial(int32_t* regs, const int32_t* idx, V val,
                                     int64_t k, const inc_u64* n_unsafe,
                                     const uint8_t* unsafe) {
    if (*n_unsafe == 0) return;
    __shared__ unsigned words[32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int64_t base = 0; base < k; base += 1024) {
        int64_t i = base + threadIdx.x;
        unsigned m = __ballot_sync(0xffffffffu, i < k && unsafe[i]);
        if (lane == 0) words[warp] = m;
        __syncthreads();
        if (warp == 0) {
            unsigned nz = __ballot_sync(0xffffffffu, words[lane] != 0);
            if (lane == 0) {
                while (nz) {
                    int w = __ffs(nz) - 1;
                    nz &= nz - 1;
                    unsigned bits = words[w];
                    while (bits) {
                        int b = __ffs(bits) - 1;
                        bits &= bits - 1;
                        int64_t u = base + w * 32 + b;
                        int32_t j = idx[u];
                        regs[j] = inc_sat_add(regs[j], val(u));
                    }
                }
            }
        }
        __syncthreads();
    }
}

// scratch from the caller: 2 * n_slots + 1 int64 words (mass, sum and the
// unsafe count, zeroed here) and k flag bytes
template <class V>
cudaError_t inc_scatter(int32_t* regs, int64_t n_slots, const int32_t* idx,
                        V val, int64_t k, inc_u64* words, uint8_t* unsafe,
                        cudaStream_t stream) {
    if (k <= 0) return cudaSuccess;
    inc_u64 *mass = words, *sum = words + n_slots,
            *n_unsafe = words + 2 * n_slots;
    const int t = 256;
    inc_k_scatter_zero<<<inc_blocks(2 * n_slots + 1, t), t, 0, stream>>>(
        words, 2 * n_slots + 1);
    inc_k_scatter_mass<V><<<inc_blocks(k, t), t, 0, stream>>>(idx, val, k,
                                                              n_slots, mass);
    inc_k_scatter_safe_sum<V><<<inc_blocks(k, t), t, 0, stream>>>(
        regs, idx, val, k, n_slots, mass, sum, n_unsafe, unsafe);
    inc_k_scatter_apply_safe<<<inc_blocks(n_slots, t), t, 0, stream>>>(
        regs, n_slots, mass, sum);
    inc_k_scatter_serial<V><<<1, 1024, 0, stream>>>(regs, idx, val, k,
                                                    n_unsafe, unsafe);
    return cudaGetLastError();
}
