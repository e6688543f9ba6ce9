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
// repro_fused_addto_runs is the same function over several runs at once,
// the multi-segment transmit (core/inc_map.py:SwitchMemory.addto_f32): run
// r adds fvals[foff_r, foff_r + n_r) into its own segment's slots
// [start_r, start_r + n_r). A 262 144-element stream over 7 segments was 7
// launches, each at the ~1.4 us launch floor for 0.14 us of traffic; it is
// now one. The run table (at most INC_MAX_RUNS runs) is a kernel parameter,
// passed by value, with a prefix of block counts: each block belongs to one
// run, found by a uniform scan of the table, so the pass stays one element
// a thread with neighbouring threads on neighbouring addresses, whatever
// slot a run starts at. Runs write disjoint segments, so their order does
// not matter. A single run keeps inc_k_fused_addto above.
//
// repro_fused_read_runs is fused_read over several runs, the reply that
// spans several segments (core/inc_map.py:SwitchMemory.read_f32): run r
// reads slots [start_r, start_r + n_r) of its own segment and writes
// out[off_r, off_r + n_r) and the mask there, and, when the caller passes
// raw, the int32 registers too (the copy a clear policy writes back). The
// same run table, one launch a table. It moves 9 bytes an element (13 with
// raw): a 262 144-value reply is about 1 us of traffic at 3.35 TB/s, so
// replacing 7 per-segment gathers and host copies with one launch is the
// gain. A reply in one segment keeps inc_k_fused_read below.
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

#define INC_MAX_RUNS 32
#define INC_RUN_THREADS 256

// one run of repro_fused_addto_runs or repro_fused_read_runs, as the
// host passes it
struct IncRun {
    int32_t* regs;      // the segment's registers
    int64_t start;      // first slot
    int64_t n;          // slots
    int64_t off;        // offset of the run in the stream (values read by
                        // fused_addto, outputs written by fused_read)
};

// the table of one launch: block b works on the run r with
// block0[r] <= b < block0[r + 1]
struct IncRunTable {
    int32_t* regs[INC_MAX_RUNS];     // regs + start
    int64_t off[INC_MAX_RUNS];
    int64_t n[INC_MAX_RUNS];
    int32_t block0[INC_MAX_RUNS + 1];
    int32_t n_runs;
};

// the run of this block (a scan of the table, uniform in the block) and
// the element of its thread in that run
__device__ __forceinline__ int inc_run_of(const IncRunTable& t, int64_t* i) {
    int r = 0;
    while (r + 1 < t.n_runs && (int32_t)blockIdx.x >= t.block0[r + 1]) ++r;
    *i = (int64_t)(blockIdx.x - t.block0[r]) * INC_RUN_THREADS + threadIdx.x;
    return r;
}

__global__ void inc_k_fused_addto_runs(const __grid_constant__ IncRunTable t,
                                       const float* fvals, float scale) {
    int64_t i;
    int r = inc_run_of(t, &i);
    if (i < t.n[r]) {
        int32_t* regs = t.regs[r];
        regs[i] = inc_sat_add(regs[i],
                              inc_quantize(fvals[t.off[r] + i], scale));
    }
}

__global__ void inc_k_fused_read_runs(const __grid_constant__ IncRunTable t,
                                      float inv, float* out, uint8_t* mask,
                                      int32_t* raw) {
    int64_t i;
    int r = inc_run_of(t, &i);
    if (i < t.n[r]) {
        int32_t q = t.regs[r][i];
        int64_t o = t.off[r] + i;
        out[o] = __fmul_rn(__int2float_rn(q), inv);
        mask[o] = inc_is_sentinel(q);
        if (raw != nullptr) raw[o] = q;
    }
}

// fills t from runs (empty runs skipped); returns the blocks of its
// launch (0: nothing to do), or -1 for a table the kernels refuse
static int64_t inc_run_table(const IncRun* runs, int64_t n_runs,
                             IncRunTable* t) {
    if (n_runs < 0 || n_runs > INC_MAX_RUNS) return -1;
    int64_t blocks = 0;
    t->n_runs = 0;
    for (int64_t r = 0; r < n_runs; ++r) {
        if (runs[r].n <= 0) continue;
        int k = t->n_runs++;
        t->regs[k] = runs[r].regs + runs[r].start;
        t->off[k] = runs[r].off;
        t->n[k] = runs[r].n;
        t->block0[k] = (int32_t)blocks;
        blocks += (runs[r].n + INC_RUN_THREADS - 1) / INC_RUN_THREADS;
        if (blocks > 0x7fffffff) return -1;
    }
    t->block0[t->n_runs] = (int32_t)blocks;
    return blocks;
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

// runs: n_runs <= INC_MAX_RUNS runs of one launch (a call with more runs
// is split by the caller, one launch each); empty runs are skipped
extern "C" int repro_fused_addto_runs(const IncRun* runs, int64_t n_runs,
                                      const float* fvals, float scale,
                                      void* stream) {
    IncRunTable t;
    int64_t blocks = inc_run_table(runs, n_runs, &t);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    inc_k_fused_addto_runs<<<(unsigned)blocks, INC_RUN_THREADS, 0,
                             (cudaStream_t)stream>>>(t, fvals, scale);
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

// the same limits as repro_fused_addto_runs; raw may be null
extern "C" int repro_fused_read_runs(const IncRun* runs, int64_t n_runs,
                                     float inv, float* out, uint8_t* mask,
                                     int32_t* raw, void* stream) {
    IncRunTable t;
    int64_t blocks = inc_run_table(runs, n_runs, &t);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    inc_k_fused_read_runs<<<(unsigned)blocks, INC_RUN_THREADS, 0,
                            (cudaStream_t)stream>>>(t, inv, out, mask, raw);
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
