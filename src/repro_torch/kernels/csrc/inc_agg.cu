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
// the order, so each thread owns one element and loops over the rows,
// keeping the running value in a register; row b is read coalesced across
// threads. It moves 4B + 8 bytes an element (each row read once, acc read
// and written once), where B launches of sat_add would move 12B.
#include "inc.cuh"

__global__ void inc_k_sat_add(const int32_t* a, const int32_t* b,
                              int32_t* out, int64_t n) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x)
        out[i] = inc_sat_add(a[i], b[i]);
}

__global__ void inc_k_sat_add_batch(const int32_t* acc, const int32_t* qs,
                                    int64_t rows, int64_t n, int32_t* out) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        int32_t v = acc[i];
        for (int64_t r = 0; r < rows; ++r) v = inc_sat_add(v, qs[r * n + i]);
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
    inc_k_sat_add_batch<<<inc_blocks(n, 256), 256, 0,
                          (cudaStream_t)stream>>>(acc, qs, rows, n, out);
    return (int)cudaGetLastError();
}
