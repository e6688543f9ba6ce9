// Ordered saturating scatter-add into a register segment, shared by
// sparse_addto (int32 values) and fused_scatter (fp32 values quantized in
// the kernel).
//
// Replaces the serial fori_loop of the TPU kernels (kernels/sparse_addto.py
// sparse_addto_pallas, kernels/fused_gpv.py fused_scatter_pallas), which
// hold the whole segment in VMEM and apply the k updates one by one in
// stream order. A plain atomicAdd scatter is wrong here: once a slot
// saturates, the order of its updates decides the result. The split of
// kernels/ops.py:sparse_addto_host makes it parallel:
//
//   1. mass[j] = sum |q_i| and sum[j] = sum q_i over the updates of slot j;
//   2. slot j is safe when |regs[j]| + mass[j] <= SAT_MAX: no prefix of
//      its updates, in any order, can reach a sentinel, so they collapse
//      into the exact sum, applied in one add; every other slot is flagged;
//   3. the updates of flagged slots are applied one by one in stream
//      order, so those slots see exactly the sequential oracle.
//
// A sentinel register or value has magnitude > SAT_MAX and so is never
// safe; every update of a slot falls on the same side of the split, and
// the safe and flagged slots are disjoint, so the result is exact. The
// bound is memory: k reads of (idx, value) and a read-modify-write of each
// touched slot, 0.23 us at 3.35 TB/s for k = 65 536 into a 40 000-slot
// segment, well below one launch.
//
// Two lanes, chosen by size (inc_cluster_lane):
//
// The cluster lane (every launch of the path: 40 000 slots, k <= 80 000) is
// ONE launch of INC_GRID thread-block clusters of INC_CLUSTER CTAs (15 x 8
// = 120 CTAs, one an SM: the H100 holds 15 such clusters at once, and a
// 16th would run in a second wave). The slots are dealt out in 32-slot
// blocks: block b goes to CTA o = b mod 120 (inc_owner), which keeps the
// mass and sum of its slots (two u64 words a slot) in its own shared
// memory and zeroes them itself. Each cluster reads the whole stream, its
// CTAs a 32-update unit each in turn, and keeps the updates of its own
// slots; the CTAs reach each other's words through distributed shared
// memory (DSMEM). So the scratch never touches device memory, no zero
// kernel runs, the atomics stay on chip, and the large lane's kernel
// boundaries become cluster barriers.
//   pass 1: a warp loads INC_CLUSTER_ITEMS units at once; the lanes of a
//     warp that hit one slot are summed by one of them (__match_any_sync,
//     taken when more than two lanes of the warp hit the cluster, so that a
//     hot slot costs one atomic a warp, not 32), which adds |q| and q to
//     the owner's words with DSMEM atomics;
//   pass 2: each owner settles its slots: a safe slot's register is
//     written, the rest are flagged (mass = INC_UNSAFE, sum = the
//     register, a bit in the CTA's flag words);
//   pass 3, only in a cluster where a slot was flagged: each CTA copies
//     the cluster's flag words; each warp lists the flagged updates
//     (slot, value) of its contiguous part of its CTA's contiguous share
//     of the stream, in stream order (ballots, no block barrier); then one
//     warp of each owner walks the cluster's 256 lists as one, in (rank,
//     warp) order, which is stream order, 32 entries at a time, and
//     applies the entries of its own slots to the registers held in its
//     shared memory, the lanes of one slot in lane order, different slots
//     at once; the owners write them back.
// Why 15 clusters and not one: on the H100 a DSMEM atomic costs its SM
// several times a local shared atomic, so a single cluster of 8 SMs ran
// k = 65 536 slower than the large lane's five launches over the whole
// card (PERF.md, PR 18); 15 clusters that each read the whole stream
// spread the atomics over 120 SMs, at 64 KB of reads an SM.
// Shared memory a CTA: 16 bytes an owned slot, 36 bytes an owned block
// (flag words) and 8 bytes an update of its share (list), 70 KB at 40 000
// slots and k = 65 536; INC_CLUSTER_MAX_SLOTS and INC_CLUSTER_MAX_K keep
// the largest call within the 227 KB a CTA may have.
//
// The large lane (past either limit) is five launches over a global
// scratch of two int64 words a slot from the caller: zero it, the mass
// atomics, the safe-sum atomics, the safe apply, and one block that walks
// the flags in stream order (ballots into shared memory, one thread
// applying the flagged updates; it returns at once when nothing was
// flagged).
#pragma once
#include <cooperative_groups.h>

#include "inc.cuh"

namespace cg = cooperative_groups;

// Internal linkage: each library that includes this header (sparse_addto,
// fused_gpv) keeps its own kernels and its own first-use state, which a
// process loading both must not share.
namespace {

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

// -- the large lane -----------------------------------------------------------

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

// -- the cluster lane ---------------------------------------------------------

#define INC_CLUSTER 8                  // CTAs of a cluster (portable size)
#define INC_GRID 15                    // clusters of a launch (all resident)
#define INC_CTAS (INC_CLUSTER * INC_GRID)
#define INC_CLUSTER_THREADS 1024
#define INC_CLUSTER_WARPS (INC_CLUSTER_THREADS / 32)
#define INC_CLUSTER_ITEMS 4            // 32-update units a warp loads at once
#define INC_SCAN_UNITS 8               // the same in pass 3
#define INC_SUBLISTS (INC_CLUSTER * INC_CLUSTER_WARPS)   // pass 3's lists
#define INC_MAX_DEVICES 64
constexpr int64_t INC_CLUSTER_MAX_SLOTS = 1 << 19;
constexpr int64_t INC_CLUSTER_MAX_K = 1 << 17;       // the path's k <= 80 000
constexpr inc_u64 INC_UNSAFE = ~0ull;  // mass word of a flagged slot

__host__ __device__ constexpr int64_t inc_ceil_div(int64_t a, int64_t b) {
    return (a + b - 1) / b;
}

// 32-slot blocks a CTA owns at most
__host__ __device__ constexpr int64_t inc_cluster_blocks(int64_t n_slots) {
    return inc_ceil_div(inc_ceil_div(n_slots, 32), INC_CTAS);
}

// u32 flag words of a CTA: its own and the cluster's, INC_CLUSTER + 1 a
// block, rounded up to an even count (the list after them is 8-byte
// aligned)
__host__ __device__ constexpr int64_t inc_flag_words(int64_t Pb) {
    return 2 * inc_ceil_div((INC_CLUSTER + 1) * Pb, 2);
}

// updates a warp of a CTA lists at most in pass 3: its part of the CTA's
// share S = ceil(k / INC_CLUSTER)
__host__ __device__ constexpr int inc_warp_share(int64_t S) {
    return (int)inc_ceil_div(S, INC_CLUSTER_WARPS);
}

// dynamic shared memory of a launch: mass and sum (u64) of the owned
// slots, the flag words, and the warps' lists of (slot, value) pairs of
// the share's flagged updates
__host__ __device__ constexpr int64_t inc_cluster_smem(int64_t n_slots,
                                                       int64_t k) {
    return 16 * 32 * inc_cluster_blocks(n_slots) +
           4 * inc_flag_words(inc_cluster_blocks(n_slots)) +
           8 * INC_CLUSTER_WARPS *
               (int64_t)inc_warp_share(inc_ceil_div(k, INC_CLUSTER));
}
constexpr int64_t INC_CLUSTER_SMEM_MAX =
    inc_cluster_smem(INC_CLUSTER_MAX_SLOTS, INC_CLUSTER_MAX_K);
// with the static arrays of the kernel (stage, warp counts, two words),
// within the 232 448 bytes a CTA may have
static_assert(INC_CLUSTER_SMEM_MAX + 4 * 32 * INC_CLUSTER_WARPS +
                  4 * INC_CLUSTER_WARPS + 4 * INC_SUBLISTS + 4 <= 232448,
              "the cluster lane's limits exceed a CTA's shared memory");
static_assert(INC_SUBLISTS % 32 == 0, "pass 3b counts whole lists a lane");

inline bool inc_cluster_lane(int64_t n_slots, int64_t k) {
    return n_slots <= INC_CLUSTER_MAX_SLOTS && k <= INC_CLUSTER_MAX_K;
}

// The owner of slot j: its 32-slot block b = j / 32 goes to CTA
// o = b mod INC_CTAS, that is cluster o mod INC_GRID, rank o / INC_GRID,
// at local slot (b / INC_CTAS) * 32 + j mod 32. Neighbouring blocks land in
// different clusters, so a hot run of slots is spread over the card.
struct IncOwner {
    int cl, rank, l;
};

__device__ __forceinline__ IncOwner inc_owner(int32_t j) {
    const int b = j >> 5, o = b % INC_CTAS;
    return {o % INC_GRID, o / INC_GRID, (b / INC_CTAS) * 32 + (j & 31)};
}

// own 32-slot blocks of CTA o
__device__ __forceinline__ int inc_owned_blocks(int o, int64_t n_slots) {
    const int64_t nb = inc_ceil_div(n_slots, 32);
    return o < nb ? (int)((nb - 1 - o) / INC_CTAS + 1) : 0;
}

template <class V>
__global__ void __launch_bounds__(INC_CLUSTER_THREADS, 1)
inc_k_scatter_cluster(int32_t* regs, int64_t n_slots, const int32_t* idx,
                      V val, int64_t k, int Pb, int S) {
    extern __shared__ __align__(16) unsigned char inc_smem[];
    __shared__ int32_t stage[INC_CLUSTER_WARPS][32];
    __shared__ unsigned warp_cnt[INC_CLUSTER_WARPS];
    __shared__ unsigned sub_end[INC_SUBLISTS];
    __shared__ unsigned any_unsafe;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int g = blockIdx.x / INC_CLUSTER, o = rank * INC_GRID + g;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned all = 0xffffffffu;
    const int P = 32 * Pb, nbo = inc_owned_blocks(o, n_slots);
    inc_u64* mass = (inc_u64*)inc_smem;
    inc_u64* sum = mass + P;
    uint32_t* ubits = (uint32_t*)(sum + P);     // own flag words
    uint32_t* flags = ubits + Pb;               // the cluster's, in pass 3
    int2* list = (int2*)(ubits + inc_flag_words(Pb));

    uint4* words = (uint4*)inc_smem;            // mass and sum: 16 P bytes
    for (int i = tid; i < P; i += INC_CLUSTER_THREADS)
        words[i] = make_uint4(0, 0, 0, 0);
    if (tid == 0) any_unsafe = 0;

    // pass 1's first loads go out before the barrier
    int32_t j[INC_CLUSTER_ITEMS], q[INC_CLUSTER_ITEMS];
    const int64_t unit0 = rank * INC_CLUSTER_WARPS + warp;
    const int64_t stride = (int64_t)INC_CLUSTER * INC_CLUSTER_WARPS;
    int64_t base = 0;
    auto load = [&]() {
#pragma unroll
        for (int m = 0; m < INC_CLUSTER_ITEMS; ++m) {
            const int64_t i = (base + m * stride + unit0) * 32 + lane;
            j[m] = i < k ? idx[i] : -1;
            q[m] = i < k ? val(i) : 0;
            if (!inc_in_range(j[m], n_slots) || inc_owner(j[m]).cl != g)
                j[m] = -1;
        }
    };
    load();
    cluster.sync();             // every CTA runs and its words are zero

    // pass 1: mass and sum of this cluster's slots, into their owners'
    // shared memory; the lanes of a warp on one slot are summed first
    for (;;) {
#pragma unroll
        for (int m = 0; m < INC_CLUSTER_ITEMS; ++m) {
            const bool in = j[m] >= 0;
            const unsigned in_mask = __ballot_sync(all, in);
            if (in_mask == 0) continue;
            unsigned peers = in ? 1u << lane : 0;
            if (__popc(in_mask) > 2) {     // else at most 2 atomics a slot
                stage[warp][lane] = q[m];
                if (in) peers = __match_any_sync(in_mask, j[m]);
                __syncwarp();
            }
            if (in && lane == __ffs(peers) - 1) {
                inc_u64 am = 0, as = 0;
                for (unsigned b = peers; b; b &= b - 1) {
                    const long long x =
                        peers == 1u << lane ? q[m] : stage[warp][__ffs(b) - 1];
                    am += (inc_u64)(x < 0 ? -x : x);
                    as += (inc_u64)x;
                }
                if (am != 0) {
                    const IncOwner w = inc_owner(j[m]);
                    atomicAdd(cluster.map_shared_rank(mass, w.rank) + w.l, am);
                    atomicAdd(cluster.map_shared_rank(sum, w.rank) + w.l, as);
                }
            }
            __syncwarp();
        }
        base += INC_CLUSTER_ITEMS * stride;
        if (base * 32 >= k) break;
        load();
    }
    cluster.sync();             // every atomic has landed

    // pass 2: the owner settles its slots, warp w its blocks w, w + W, ...,
    // a lane a slot: a safe slot's register is written, a flagged one is
    // marked (mass = INC_UNSAFE, sum = the register, a bit in ubits)
    bool flagged = false;
    for (int t = warp; t < nbo; t += INC_CLUSTER_WARPS) {
        const int l = t * 32 + lane;
        const int64_t jg = ((int64_t)t * INC_CTAS + o) * 32 + lane;
        const inc_u64 m = mass[l];
        bool unsafe = false;
        if (m != 0) {
            const long long r = regs[jg];
            unsafe = (inc_u64)(r < 0 ? -r : r) + m > (inc_u64)INC_SAT_MAX;
            if (unsafe) {
                mass[l] = INC_UNSAFE;
                sum[l] = (inc_u64)r;
            } else {
                regs[jg] = (int32_t)(r + (long long)sum[l]);
            }
        }
        const unsigned bits = __ballot_sync(all, unsafe);
        if (lane == 0) ubits[t] = bits;
        flagged |= bits != 0;
    }
    if (flagged && lane == 0)   // tell every CTA of the cluster: pass 3 runs
        for (int s = 0; s < INC_CLUSTER; ++s)
            atomicOr(cluster.map_shared_rank(&any_unsafe, s), 1u);
    cluster.sync();             // flags final; any_unsafe alike in the cluster
    if (any_unsafe == 0) return;    // no CTA reads a peer past this point

    // pass 3a: the cluster's flag words, then the flagged updates of this
    // CTA's contiguous share of the stream, in stream order
    for (int x = tid; x < Pb * INC_CLUSTER; x += INC_CLUSTER_THREADS) {
        const int s = x % INC_CLUSTER, t = x / INC_CLUSTER;
        flags[x] = t < inc_owned_blocks(s * INC_GRID + g, n_slots)
                       ? cluster.map_shared_rank(ubits, s)[t] : 0u;
    }
    __syncthreads();
    // each warp lists the flagged updates of its own contiguous part of
    // the CTA's share, in stream order, with no block barrier
    const int64_t lo = (int64_t)rank * S < k ? (int64_t)rank * S : k;
    const int64_t hi = lo + S < k ? lo + S : k;
    const int Sw = inc_warp_share(S);
    const int64_t wlo = lo + (int64_t)warp * Sw < hi ? lo + (int64_t)warp * Sw
                                                     : hi;
    const int64_t whi = wlo + Sw < hi ? wlo + Sw : hi;
    int2* wlist = list + warp * Sw;
    unsigned count = 0;
    for (int64_t b0 = wlo; b0 < whi; b0 += 32 * INC_SCAN_UNITS) {
        int32_t jj[INC_SCAN_UNITS];         // loaded at once
#pragma unroll
        for (int m = 0; m < INC_SCAN_UNITS; ++m) {
            const int64_t i = b0 + m * 32 + lane;
            jj[m] = i < whi ? idx[i] : -1;
        }
#pragma unroll
        for (int m = 0; m < INC_SCAN_UNITS; ++m) {
            const int64_t i = b0 + m * 32 + lane;
            bool f = false;
            if (inc_in_range(jj[m], n_slots)) {
                const IncOwner w = inc_owner(jj[m]);
                f = w.cl == g && (flags[(w.l >> 5) * INC_CLUSTER + w.rank] >>
                                  (jj[m] & 31)) & 1;
            }
            const unsigned bits = __ballot_sync(all, f);
            if (f) wlist[count + __popc(bits & ((1u << lane) - 1))] =
                       make_int2(jj[m], val(i));
            count += __popc(bits);
        }
    }
    if (lane == 0) warp_cnt[warp] = count;
    cluster.sync();             // every list complete

    // pass 3b: warp 0 walks the cluster's lists as one, in (rank, warp)
    // order, which is stream order, 32 entries at a time, and applies the
    // entries of this CTA's slots to sum[], which holds their registers;
    // the lanes of one slot go in lane order
    if (warp == 0) {
        constexpr int per = INC_SUBLISTS / 32;   // lists a lane counts
        unsigned end[per], run = 0;
#pragma unroll
        for (int x = 0; x < per; ++x) {
            const int sl = lane * per + x;
            run += cluster.map_shared_rank(warp_cnt, sl / INC_CLUSTER_WARPS)
                       [sl % INC_CLUSTER_WARPS];
            end[x] = run;
        }
        unsigned before = run;              // exclusive prefix over lanes
        for (int d = 1; d < 32; d <<= 1) {
            const unsigned y = __shfl_up_sync(all, before, d);
            if (lane >= d) before += y;
        }
        before -= run;
#pragma unroll
        for (int x = 0; x < per; ++x) sub_end[lane * per + x] = before + end[x];
        __syncwarp();
        const unsigned total = sub_end[INC_SUBLISTS - 1];
        for (unsigned e = 0; e < total; e += 32) {
            const unsigned v = e + lane;
            bool mine = false;
            int2 u = make_int2(-1, 0);
            if (v < total) {
                int lo_s = 0, hi_s = INC_SUBLISTS - 1;  // first end > v
                while (lo_s < hi_s) {
                    const int mid = (lo_s + hi_s) / 2;
                    if (sub_end[mid] > v) hi_s = mid; else lo_s = mid + 1;
                }
                const unsigned start = lo_s ? sub_end[lo_s - 1] : 0;
                u = cluster.map_shared_rank(list, lo_s / INC_CLUSTER_WARPS)
                        [(lo_s % INC_CLUSTER_WARPS) * Sw + (v - start)];
                mine = inc_owner(u.x).rank == rank;
            }
            const unsigned mm = __ballot_sync(all, mine);
            if (mm == 0) continue;
            stage[0][lane] = u.y;
            const unsigned peers = mine ? __match_any_sync(mm, u.x) : 0;
            __syncwarp();
            if (mine && lane == __ffs(peers) - 1) {
                const int l = inc_owner(u.x).l;
                int32_t acc = (int32_t)(long long)sum[l];
                for (unsigned b = peers; b; b &= b - 1)
                    acc = inc_sat_add(acc, stage[0][__ffs(b) - 1]);
                sum[l] = (inc_u64)(long long)acc;
            }
            __syncwarp();
        }
    }
    __syncthreads();
    for (int t = warp; t < nbo; t += INC_CLUSTER_WARPS) {
        const int l = t * 32 + lane;
        if ((ubits[t] >> lane) & 1)
            regs[((int64_t)t * INC_CTAS + o) * 32 + lane] =
                (int32_t)(long long)sum[l];
    }
    cluster.sync();             // no CTA exits while a peer reads its list
}

// First use on a device: lift the kernel's dynamic shared memory above
// 48 KB and check that a cluster of it can be resident (n_clusters gets
// cudaOccupancyMaxActiveClusters at the largest launch); an error, or no
// resident cluster, is returned and the wrapper raises.
template <class V>
cudaError_t inc_cluster_ready(int* n_clusters) {
    static int ready[INC_MAX_DEVICES];         // 0 unknown, else clusters
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < INC_MAX_DEVICES && ready[dev] > 0) {
        *n_clusters = ready[dev];
        return cudaSuccess;
    }
    err = cudaFuncSetAttribute(inc_k_scatter_cluster<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)INC_CLUSTER_SMEM_MAX);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = INC_CLUSTER;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(INC_CTAS);
    cfg.blockDim = dim3(INC_CLUSTER_THREADS);
    cfg.dynamicSmemBytes = INC_CLUSTER_SMEM_MAX;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(n_clusters, inc_k_scatter_cluster<V>,
                                         &cfg);
    if (err != cudaSuccess) return err;
    if (*n_clusters < 1) return cudaErrorInvalidConfiguration;
    if (dev < INC_MAX_DEVICES) ready[dev] = *n_clusters;
    return cudaSuccess;
}

template <class V>
cudaError_t inc_scatter_cluster(int32_t* regs, int64_t n_slots,
                                const int32_t* idx, V val, int64_t k,
                                cudaStream_t stream) {
    int n_clusters = 0;
    cudaError_t err = inc_cluster_ready<V>(&n_clusters);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = INC_CLUSTER;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(INC_CTAS);
    cfg.blockDim = dim3(INC_CLUSTER_THREADS);
    cfg.dynamicSmemBytes = (size_t)inc_cluster_smem(n_slots, k);
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, inc_k_scatter_cluster<V>, regs, n_slots,
                             idx, val, k, (int)inc_cluster_blocks(n_slots),
                             (int)inc_ceil_div(k, INC_CLUSTER));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// -- the entry point ----------------------------------------------------------

// The cluster lane when the call fits it, else the large lane, whose
// scratch comes from the caller: 2 * n_slots + 1 int64 words (mass, sum and
// the unsafe count, zeroed here) and k flag bytes (null on the cluster
// lane, where a missing scratch is an error only if the call does not fit).
template <class V>
cudaError_t inc_scatter(int32_t* regs, int64_t n_slots, const int32_t* idx,
                        V val, int64_t k, inc_u64* words, uint8_t* unsafe,
                        cudaStream_t stream) {
    if (k <= 0) return cudaSuccess;
    if (inc_cluster_lane(n_slots, k))
        return inc_scatter_cluster(regs, n_slots, idx, val, k, stream);
    if (words == nullptr || unsafe == nullptr) return cudaErrorInvalidValue;
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

// The lane limits, for the wrappers (which allocate the large lane's
// scratch) and for reports: {max slots, max k, CTAs a cluster, clusters a
// launch, threads a CTA, largest dynamic shared memory a CTA}.
inline void inc_scatter_limits(int64_t* out) {
    out[0] = INC_CLUSTER_MAX_SLOTS;
    out[1] = INC_CLUSTER_MAX_K;
    out[2] = INC_CLUSTER;
    out[3] = INC_GRID;
    out[4] = INC_CLUSTER_THREADS;
    out[5] = INC_CLUSTER_SMEM_MAX;
}

}  // namespace
