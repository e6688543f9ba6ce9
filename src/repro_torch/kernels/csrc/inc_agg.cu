// The switch's saturating Map.addTo on Hopper: every hop of the SyncAgtr
// ring (core/ring.py) and every accumulate of the clear policies
// (core/clear_policy.py).
//
// repro_sat_add replaces kernels/inc_agg.py:sat_add_pallas, an elementwise
// int32 add with sticky sentinels over (rows, 128) tiles of 256 rows. Here
// it takes a flat stream of any length: one thread an element, neighbouring
// threads on neighbouring addresses, no padding to the TPU tile. It moves
// 12 bytes an element (two int32 in, one out): a 25 MiB gradient bucket
// (6 553 600 elements) is 78.6 MB, about 23 us at 3.35 TB/s, so it is bound
// by memory and the arithmetic (inc_sat_add of inc.cuh: the add in uint32,
// then the overflow rebuilt from the signs) hides under the loads.
//
// repro_sat_add_batch replaces the lax.scan over sat_add_pallas of
// kernels/ops.py:_sat_add_batch_tpu: B stacked rows folded into acc in row
// order, in one launch. The sticky-sentinel rule makes the fold depend on
// the order, so each thread owns one element and folds the rows in order,
// keeping the running value in a register; row b is read coalesced across
// threads. It moves 4B + 8 bytes an element (each row read once, acc read
// and written once), where B launches of sat_add would move 12B. At the
// clear policies' n = 40 000 that is about one CTA an SM, so the loads'
// latency, not their bytes, sets the time if each row is folded before the
// next is loaded. So the rows are read in batches of INC_BATCH_ROWS into
// registers, every load of a batch issued before the first fold (a row
// past B reads as 0, which sat_add leaves unchanged): a fold of up to
// INC_BATCH_ROWS rows waits about once. The fold itself was then the cost:
// on the card a plain sum of the same 16 loads took well under the
// saturating fold's time, until inc_sat_add (inc.cuh) became branch-free
// selects. CTAs of 128 threads spread n = 40 000 over more SMs than 256
// did. (Batches of 8 and 32 rows, 32 to 256 threads and an exact int64
// prefix-sum form of the fold were no faster; int2 and int4 loads were
// slower; the lane-safe plain sum of the reference's _sat_add_batch_fast
// won where few lanes saturate and lost where many warps hold one.)
#include "inc.cuh"

#define INC_BATCH_ROWS 16

__global__ void inc_k_sat_add(const int32_t* a, const int32_t* b,
                              int32_t* out, int64_t n) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x)
        out[i] = inc_sat_add(a[i], b[i]);
}

__global__ void inc_k_sat_add_batch(const int32_t* __restrict__ acc,
                                    const int32_t* __restrict__ qs,
                                    int64_t rows, int64_t n,
                                    int32_t* __restrict__ out) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        int32_t v = __ldg(acc + i);
        for (int64_t r = 0; r < rows; r += INC_BATCH_ROWS) {
            int32_t x[INC_BATCH_ROWS];
#pragma unroll
            for (int u = 0; u < INC_BATCH_ROWS; ++u)
                x[u] = r + u < rows ? __ldg(qs + (r + u) * n + i) : 0;
#pragma unroll
            for (int u = 0; u < INC_BATCH_ROWS; ++u) v = inc_sat_add(v, x[u]);
        }
        out[i] = v;
    }
}

extern "C" int repro_sat_add(const int32_t* a, const int32_t* b,
                             int32_t* out, int64_t n, void* stream) {
    if (n <= 0) return 0;
    inc_k_sat_add<<<inc_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        a, b, out, n);
    return (int)cudaGetLastError();
}

extern "C" int repro_sat_add_batch(const int32_t* acc, const int32_t* qs,
                                   int64_t rows, int64_t n, int32_t* out,
                                   void* stream) {
    if (n <= 0) return 0;
    inc_k_sat_add_batch<<<inc_blocks(n, 128), 128, 0,
                          (cudaStream_t)stream>>>(acc, qs, rows, n, out);
    return (int)cudaGetLastError();
}
