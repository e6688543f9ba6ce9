// The backward of causal flash attention (kernel 11) on Hopper, as three
// kernels: the train lane's gradient of kernels/flash_attn.py. The TPU
// kernel (repro/kernels/flash_attn.py:flash_attention_pallas) has no VJP;
// the reference trains under REPRO_FLASH_ATTN=1 through the chunked oracle
// (flash_attention_chunked_ref), which JAX differentiates, and its roofline
// counts that path as "recompute-fwd + bwd dq/dk/dv"
// (repro/roofline/flash_model.py). These kernels are written from that
// function's gradient.
//
//   (a) flash_k_bwd_delta: delta[b,h,i] = sum_d dO[b,i,h,d] * O[b,i,h,d] in
//       fp32, one warp a row.
//   (b) flash_k_bwd_dkdv: dK and dV of one (batch, KV head, 64-key tile,
//       column chunk) are the work of one thread block cluster of c CTAs,
//       c the largest divisor of the group (H / KV) up to 8
//       (roofline/flash_model.py:dkdv_split, passed in by the wrapper).
//       Cluster rank r walks query heads r * G / c .. (r + 1) * G / c - 1
//       of the group in turn and, for each, the 64-row query tiles that can
//       see its keys (from the diagonal tile to the last one within the
//       window). Per tile it recomputes S^T = K Q^T, P^T = exp2(S^T * scale
//       * log2(e) - lse2), dP^T = V dO^T, dS^T = P^T * (dP^T - delta), then
//       dV += P^T dO and dK += dS^T Q, in fp32 registers. At the end each
//       CTA writes its partial dK and dV to its own shared memory, the
//       cluster syncs, and rank r sums rows r * ceil(64 / c) .. of every
//       rank's partial, ranks 0 .. c - 1 in that order, through distributed
//       shared memory (mapa, ld.shared::cluster); it scales dK, rounds
//       once to bf16, stores, and syncs the cluster again before it exits.
//       The sum has one fixed order, with no atomics and no scratch in
//       device memory: the result is deterministic, which the
//       checkpoint's recompute relies on.
//   (c) flash_k_bwd_dq: one CTA per (batch, query head, 64-row query tile,
//       column chunk of dQ); it walks the key tiles its rows can see and
//       forms S, P, dP and dS the same way, then dQ += dS K, scaled at the
//       end.
//
// Semantics, against the forward (csrc/flash_attn.cu):
//   - scores are fp32 dots of bf16 rows, scaled after the dot; masked keys
//     (kpos > qpos, qpos - kpos >= window, or past S) get P = 0;
//   - lse2 is the forward's base-2 log-sum-exp (B, H, S), fp32;
//   - P and dS are rounded to bf16 before the products that take them
//     (P^T dO, dS^T Q, dS K), the products accumulate in fp32, and dQ, dK,
//     dV are rounded once to bf16 at the store.
//
// Layout: q, dO, dq (B, S, H, D) and k, v, dk, dv (B, S, KV, D), bf16, read
// and written through their element strides (the last dim contiguous, every
// other stride a multiple of 8 elements, 16-byte aligned bases); query head
// h reads KV head h / (H / KV).
//
// Design: one warpgroup (four warps, 16 rows each) a CTA on 64-row tiles
// (keys in (b), queries in (c)); every product is a wgmma m64nNk16 bf16
// with fp32 accumulators in registers.
//   - Parallelism: (b) splits a group's query heads over a cluster, so at
//     phase z's shape (16 query heads on 2 KV heads) 512 CTAs share the
//     work that 64 CTAs walked in turn before, and the partial sums meet in
//     shared memory, not in device memory.
//   - Order: both grids are one-dimensional, numbered so that the longest
//     walks start first (in (b) the causal key tiles from the first, in (c)
//     the query tiles from the last) and the short ones fill the tail.
//   - Loads: the tiles that stream (Q, dO, lse and delta in (b); K and V in
//     (c)) go through a two-stage ring filled with cp.async, 16 bytes a
//     copy (4 for lse and delta), rows past S zero-filled: tile i + 1 is in
//     flight while tile i computes. The fixed tiles (K and V in (b), Q and
//     dO in (c)) are loaded once with the first ring stage. Each tile lands
//     in the layout kernel 11's TMA loads give its wgmma (Tile<D>: boxes of
//     64 columns, 128-byte rows swizzled; 32 and 64 bytes at D = 32), and a
//     proxy fence orders the copies before the products that read them.
//   - Products: S^T = K Q^T and dP^T = V dO^T (in (c) S = Q K^T and dP =
//     dO V^T) take both operands from shared memory, K-major; dV += P^T dO
//     and dK += dS^T Q (dQ += dS K) take P^T and dS^T in bf16 from
//     registers as A (a thread's m64 accumulator is its share of the A
//     operand) and dO and Q (K) from shared memory MN-major, through the
//     transpose bit. S and dP are two commit groups, so P is formed while
//     dP's product runs, and in (b) dV's product runs while dS is formed.
//   - A tile that masks no pair (below the diagonal, inside the window,
//     before S) skips the mask.
//   - dK/dV (or dQ) stay in registers for a chunk of DC = min(D, 128)
//     columns; at D = 256 a second chunk of CTAs recomputes S and dP (1.5
//     times the products) rather than spill.
//
// Bound: at phase z's shape (B=2, H=16, KV=2, S=1024, D=128) the five
// products over the causal half are 21.5 GFLOP against 38.0 MB of inputs
// and outputs: the tensor cores bound it, not memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;            // query rows a tile
constexpr int BK = 64;            // key rows a tile
constexpr int THREADS = 128;      // four warps of 16 rows
constexpr int STAGES = 2;         // the ring of streamed tiles
constexpr int MAX_CLUSTER = 8;    // CTAs a cluster in (b): the portable most
constexpr int DELTA_ROWS = 8;     // rows (warps) a delta CTA
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
    int64_t b, s, h;              // element strides; d is contiguous
};

struct Bwd {
    const bf16 *q, *k, *v, *dout;
    const float *lse, *delta;     // (B, H, S) fp32
    bf16 *dq, *dk, *dv;
    Strides qs, ks, vs, gs, dqs, dks, dvs;
    int B, S, H, KV, causal, window; // window 0: none
    int cluster, heads;           // (b): CTAs a cluster, query heads a CTA
    float scale, scale_log2;      // sm_scale, sm_scale * log2(e)
};

// -- cp.async ------------------------------------------------------------------

// 16 (or 4) bytes from global to shared memory, in flight until the
// group's wait; zeros where !in (a source size of 0 reads nothing)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool in) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// -- the cluster ---------------------------------------------------------------

// every thread of every CTA of the cluster arrives; shared-memory writes
// before it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// four floats at shared address a (of this CTA's layout) in CTA `rank` of
// the cluster: distributed shared memory
__device__ __forceinline__ float4 ld_rank(uint32_t a, uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(a), "r"(rank));
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(remote) : "memory");
    return v;
}

// -- wgmma ---------------------------------------------------------------------

// Shared tiles for wgmma, as kernel 11's TMA loads lay them out: a tile of
// R rows x D columns is D / BOXC boxes of R rows x BOXC columns (64, or 32
// at D = 32), each box ROWB = 2 BOXC bytes a row, swizzled in 128 bytes
// (64 at D = 32): the 16-byte chunk c of row r lands at chunk c ^ (r % 8)
// (c ^ (r / 2 % 4)). Box bases are 1024-byte aligned.
template <int D>
struct Tile {
    static constexpr int BOXC = D == 32 ? 32 : 64;    // columns a box
    static constexpr int ROWB = BOXC * 2;             // bytes a box row
    static constexpr int KPB = BOXC / 16;             // k16 steps a box
    static constexpr uint32_t SWZ = D == 32 ? 0x30 : 0x70;
    static constexpr uint64_t LAYOUT = D == 32 ? 2 : 1;   // B64 : B128
    static constexpr uint32_t SBO = 8 * ROWB;         // next 8-row group
    static constexpr int BOX = 64 * ROWB;             // a box of 64 rows
    static constexpr int BYTES = 64 * D * 2;          // a 64-row tile
};

// k16 step kk of a 64-row tile at t read K-major (its rows are the
// product's rows, or B's columns)
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t t, int kk) {
    using T = Tile<D>;
    return gmma_desc(t + kk / T::KPB * T::BOX + kk % T::KPB * 32, 16,
                     T::SBO, T::LAYOUT);
}

// k16 step kk of a 64-row tile at t read MN-major from column c0: B[k][n]
// = t[16 kk + k][c0 + n] (the transpose bit)
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t t, int c0, int kk) {
    using T = Tile<D>;
    return gmma_desc(t + c0 / T::BOXC * T::BOX + kk * 16 * T::ROWB, T::BOX,
                     T::SBO, T::LAYOUT);
}

// the generic proxy's writes to shared memory (cp.async, st.shared) seen
// by the async proxy's reads (wgmma)
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// P or dS (fp32 accumulators of a 64 x 64 wgmma, 32 a thread) as the bf16
// A operand of the next product: k16 step kk holds columns 16 kk ..
// 16 kk + 15 of the thread's two rows
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&c)[32]) {
    #pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        #pragma unroll
        for (int i = 0; i < 4; ++i)
            a[kk][i] = pack_bf16(c[kk * 8 + 2 * i], c[kk * 8 + 2 * i + 1]);
}

// -- tiles -------------------------------------------------------------------

// rows row0..row0+63 of a (S, D) slice with row stride ss into the
// swizzled shared tile at dst (Tile<D>), by cp.async; rows at or past S
// are zeros
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int64_t ss, int row0, int S) {
    using T = Tile<D>;
    constexpr int PER_ROW = D / 8, PER_BOX = T::BOXC / 8;
    for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
        const int r = i / PER_ROW, c = i % PER_ROW;
        const bool in = row0 + r < S;
        const uint32_t off = c / PER_BOX * T::BOX + r * T::ROWB
            + c % PER_BOX * 16;
        cp16(dst + (off ^ ((off >> 3) & T::SWZ)),
             src + (int64_t)(in ? row0 + r : 0) * ss + c * 8, in);
    }
}

// lse2 and delta of query rows row0.. of one (batch, head) into shared
// memory by cp.async; rows at or past S read 0 (their P is masked to 0)
__device__ __forceinline__ void load_rows(float* ls, float* ds, const Bwd& p,
                                          int b, int h, int row0) {
    const int64_t base = ((int64_t)b * p.H + h) * p.S;
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
        const int r = i % BQ;
        const bool in = row0 + r < p.S;
        const int64_t at = base + (in ? row0 + r : 0);
        if (i < BQ) cp4(ls + r, p.lse + at, in);
        else cp4(ds + r, p.delta + at, in);
    }
}

__device__ __forceinline__ bool kept(const Bwd& p, int qpos, int kpos) {
    bool ok = qpos < p.S && kpos < p.S;
    if (p.causal) {
        ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
    }
    return ok;
}

// every pair of the query tile at q0 and the key tile at k0 is kept
__device__ __forceinline__ bool open_tile(const Bwd& p, int q0, int k0) {
    bool ok = q0 + BQ <= p.S && k0 + BK <= p.S;
    if (p.causal) {
        ok = ok && q0 >= k0 + BK - 1;
        if (p.window > 0) ok = ok && q0 + BQ - 1 - k0 < p.window;
    }
    return ok;
}

// the query tiles [begin, end) whose rows can see a key of the tile at k0
__device__ __forceinline__ void q_tiles(const Bwd& p, int k0, int& begin,
                                        int& end) {
    begin = 0;
    end = (p.S + BQ - 1) / BQ;
    if (p.causal) {
        begin = k0 / BQ;
        if (p.window > 0) {
            const int k_last = min(k0 + BK, p.S) - 1;
            end = min(p.S - 1, k_last + p.window - 1) / BQ + 1;
        }
    }
}

// the key tiles [begin, end) that the rows of the tile at q0 can see
__device__ __forceinline__ void k_tiles(const Bwd& p, int q0, int& begin,
                                        int& end) {
    begin = 0;
    end = (p.S + BK - 1) / BK;
    if (p.causal) {
        end = (min(q0 + BQ, p.S) - 1) / BK + 1;
        if (p.window > 0) {
            const int first = q0 - (p.window - 1);
            begin = first > 0 ? first / BK : 0;
        }
    }
}

template <int D>
__host__ __device__ constexpr int chunk() { return D < 128 ? D : 128; }

// (b): K, V, STAGES x Q, STAGES x dO, then STAGES x (lse, delta), after
// 1024 bytes to align the base; at the end the same memory holds the fp32
// partials of dK and dV, rows of pitch DC + 8. (c): Q, dO, STAGES x (K,
// V), lse, delta
template <int D>
__host__ __device__ constexpr int bwd_smem() {
    return 1024 + (2 + 2 * STAGES) * Tile<D>::BYTES + STAGES * 2 * BQ * 4;
}

// -- (a) delta -----------------------------------------------------------------

__global__ void __launch_bounds__(DELTA_ROWS * 32)
flash_k_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ g,
                  float* __restrict__ delta, int B, int S, int H, int D,
                  Strides os, Strides gs) {
    const int64_t row = (int64_t)blockIdx.x * DELTA_ROWS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= (int64_t)B * S * H) return;
    const int h = (int)(row % H);
    const int s = (int)(row / H % S);
    const int b = (int)(row / ((int64_t)H * S));
    const bf16* orow = o + b * os.b + s * os.s + h * os.h;
    const bf16* grow = g + b * gs.b + s * gs.s + h * gs.h;
    float acc = 0.f;
    for (int d = lane * 2; d < D; d += 64) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + d));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(grow + d));
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
    }
    #pragma unroll
    for (int off = 16; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[((int64_t)b * H + h) * S + s] = acc;
}

// -- (b) dK and dV -------------------------------------------------------------

// blockIdx.x = ((key tile * B * NCH + batch * NCH + chunk) * KV + kv head)
// * cluster + rank: a cluster is c consecutive CTAs, and the key tiles
// count slowest, so the first tiles (the longest causal walks) start first
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_k_bwd_dkdv(const Bwd p) {
    using T = Tile<D>;
    constexpr int DC = chunk<D>(), NCH = D / DC;
    constexpr int RP = DC + 8;                      // partials' row pitch
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024)
                                      % 1024);
    const uint32_t ks = smem_u32(smem), vs = ks + T::BYTES;
    const uint32_t qring = vs + T::BYTES;           // STAGES tiles of Q
    const uint32_t gring = qring + STAGES * T::BYTES;   // and of dO
    float* rows = reinterpret_cast<float*>(smem + (2 + 2 * STAGES)
                                           * T::BYTES);
    const int c = p.cluster, group = p.H / p.KV;
    int rest = blockIdx.x;
    const int rank = rest % c;
    rest /= c;
    const int kvh = rest % p.KV;
    rest /= p.KV;
    const int b = rest % (p.B * NCH) / NCH, c0 = rest % NCH * DC;
    const int k0 = rest / (p.B * NCH) * BK;
    const int h0 = kvh * group + rank * p.heads;   // my first query head
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int key0 = k0 + warp * 16 + lane / 4;    // my rows: key0, key0 + 8

    int qt_begin, qt_end;
    q_tiles(p, k0, qt_begin, qt_end);
    const int nqt = qt_end - qt_begin, n = p.heads * nqt;
    // item i: query head h0 + i / nqt, query tile qt_begin + i % nqt
    auto issue = [&](int i, int st) {
        const int h = h0 + i / nqt, q0 = (qt_begin + i % nqt) * BQ;
        load_tile<D>(qring + st * T::BYTES, p.q + b * p.qs.b + h * p.qs.h,
                     p.qs.s, q0, p.S);
        load_tile<D>(gring + st * T::BYTES,
                     p.dout + b * p.gs.b + h * p.gs.h, p.gs.s, q0, p.S);
        load_rows(rows + st * 2 * BQ, rows + st * 2 * BQ + BQ, p, b, h, q0);
    };

    load_tile<D>(ks, p.k + b * p.ks.b + kvh * p.ks.h, p.ks.s, k0, p.S);
    load_tile<D>(vs, p.v + b * p.vs.b + kvh * p.vs.h, p.vs.s, k0, p.S);
    if (n > 0) issue(0, 0);
    cp_commit();

    float dk[DC / 2], dv[DC / 2];
    #pragma unroll
    for (int j = 0; j < DC / 2; ++j) dk[j] = dv[j] = 0.f;

    for (int i = 0; i < n; ++i) {
        const int st = i % STAGES;
        if (i + 1 < n) issue(i + 1, (i + 1) % STAGES);
        cp_commit();
        cp_wait<1>();                 // item i (and K, V) have landed
        fence_async_shared();
        __syncthreads();
        const uint32_t qs = qring + st * T::BYTES, gs = gring + st * T::BYTES;
        const float* ls = rows + st * 2 * BQ;
        const float* ds = ls + BQ;
        const int q0 = (qt_begin + i % nqt) * BQ;

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries, my warp's
        // rows key0 and key0 + 8; element 4 j + e at query 8 j + 2 (lane %
        // 4) + (e & 1), key + 8 for e >= 2
        // (two groups: P^T is formed while dP^T's product runs)
        float sp[BQ / 2], dp[BQ / 2];
        fence_regs(sp);
        fence_regs(dp);
        wgmma_fence();
        #pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BQ>(sp, desc_k<D>(ks, kk), desc_k<D>(qs, kk), kk > 0);
        wgmma_commit();
        #pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BQ>(dp, desc_k<D>(vs, kk), desc_k<D>(gs, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sp);
        // P^T, fp32, then in bf16 as the A operand of dV += P^T dO (dO
        // MN-major), which runs while dS^T is formed
        const bool open = open_tile(p, q0, k0);
        #pragma unroll
        for (int x = 0; x < BQ / 2; ++x) {
            const int qi = x / 4 * 8 + (lane % 4) * 2 + (x & 1);
            const int kpos = key0 + (x % 4 >= 2 ? 8 : 0);
            sp[x] = open || kept(p, q0 + qi, kpos)
                ? ex2(sp[x] * p.scale_log2 - ls[qi]) : 0.f;
        }
        uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
        acc_to_a(pa, sp);
        fence_regs(pa);
        fence_regs(dv);
        wgmma_fence();
        #pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<DC>(dv, pa[kk], desc_mn<D>(gs, c0, kk));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dp);
        // dS^T = P^T (dP^T - delta), fp32, then dK += dS^T Q (Q MN-major)
        #pragma unroll
        for (int x = 0; x < BQ / 2; ++x) {
            const int qi = x / 4 * 8 + (lane % 4) * 2 + (x & 1);
            dp[x] = sp[x] * (dp[x] - ds[qi]);
        }
        acc_to_a(sa, dp);
        fence_regs(sa);
        fence_regs(dk);
        wgmma_fence();
        #pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<DC>(dk, sa[kk], desc_mn<D>(qs, c0, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pa);
        fence_regs(sa);
        fence_regs(dv);
        fence_regs(dk);
        __syncthreads();              // every warp is done with stage st
    }
    cp_wait<0>();
    __syncthreads();

    // my partials into my shared memory: rows key0 - k0 and + 8, columns
    // 8 j + 2 (lane % 4) and the next; dK's rows first, then dV's
    float* part = reinterpret_cast<float*>(smem);
    #pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
        const int col = j * 8 + (lane % 4) * 2;
        #pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = key0 - k0 + half * 8;
            *reinterpret_cast<float2*>(part + r * RP + col) =
                make_float2(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
            *reinterpret_cast<float2*>(part + (BK + r) * RP + col) =
                make_float2(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
        }
    }
    cluster_sync();                   // every rank's partials are written

    // rank r sums rows [r0, r1) over ranks 0 .. c - 1 in that order
    const int per = (BK + c - 1) / c;
    const int r0 = rank * per, r1 = min(BK, r0 + per);
    const int quads = (r1 > r0 ? r1 - r0 : 0) * (DC / 4);
    bf16* dkg = p.dk + b * p.dks.b + kvh * p.dks.h;
    bf16* dvg = p.dv + b * p.dvs.b + kvh * p.dvs.h;
    for (int i = threadIdx.x; i < 2 * quads; i += THREADS) {
        const int which = i / quads, at = i % quads;   // 0: dK, 1: dV
        const int r = r0 + at / (DC / 4), col = at % (DC / 4) * 4;
        const int off = (which * BK + r) * RP + col;
        const uint32_t at_s = smem_u32(part + off);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < c; ++q) {
            const float4 x = ld_rank(at_s, (uint32_t)q);
            acc.x += x.x;
            acc.y += x.y;
            acc.z += x.z;
            acc.w += x.w;
        }
        if (k0 + r >= p.S) continue;
        const float s = which ? 1.f : p.scale;
        bf16* dst = which
            ? dvg + (int64_t)(k0 + r) * p.dvs.s + c0 + col
            : dkg + (int64_t)(k0 + r) * p.dks.s + c0 + col;
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            pack_bf16(acc.x * s, acc.y * s), pack_bf16(acc.z * s, acc.w * s));
    }
    cluster_sync();                   // no rank leaves while read from
}

// -- (c) dQ --------------------------------------------------------------------

// blockIdx.x = (reversed query tile * B * NCH + batch * NCH + chunk) * H +
// head: the last query tiles (the longest causal walks) start first
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_k_bwd_dq(const Bwd p) {
    using T = Tile<D>;
    constexpr int DC = chunk<D>(), NCH = D / DC;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024)
                                      % 1024);
    const uint32_t qs = smem_u32(smem), gs = qs + T::BYTES;
    const uint32_t ring = gs + T::BYTES;            // STAGES x (K, V)
    float* ls = reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * T::BYTES);
    float* ds = ls + BQ;
    const int nqt = (p.S + BQ - 1) / BQ;
    int rest = blockIdx.x;
    const int h = rest % p.H;
    rest /= p.H;
    const int b = rest % (p.B * NCH) / NCH, c0 = rest % NCH * DC;
    const int q0 = (nqt - 1 - rest / (p.B * NCH)) * BQ;
    const int kvh = h / (p.H / p.KV);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int qi0 = warp * 16 + lane / 4;          // my rows: qi0, qi0 + 8

    int kt_begin, kt_end;
    k_tiles(p, q0, kt_begin, kt_end);
    const int n = kt_end - kt_begin;
    auto issue = [&](int i, int st) {
        const int k0 = (kt_begin + i) * BK;
        const uint32_t kt = ring + st * 2 * T::BYTES;
        load_tile<D>(kt, p.k + b * p.ks.b + kvh * p.ks.h, p.ks.s, k0, p.S);
        load_tile<D>(kt + T::BYTES, p.v + b * p.vs.b + kvh * p.vs.h, p.vs.s,
                     k0, p.S);
    };

    load_tile<D>(qs, p.q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.S);
    load_tile<D>(gs, p.dout + b * p.gs.b + h * p.gs.h, p.gs.s, q0, p.S);
    load_rows(ls, ds, p, b, h, q0);
    if (n > 0) issue(0, 0);
    cp_commit();

    float dq[DC / 2];
    #pragma unroll
    for (int j = 0; j < DC / 2; ++j) dq[j] = 0.f;

    for (int i = 0; i < n; ++i) {
        const int st = i % STAGES;
        if (i + 1 < n) issue(i + 1, (i + 1) % STAGES);
        cp_commit();
        cp_wait<1>();                 // tile i (and Q, dO) have landed
        fence_async_shared();
        __syncthreads();
        const uint32_t ks = ring + st * 2 * T::BYTES, vs = ks + T::BYTES;
        const int k0 = (kt_begin + i) * BK;

        // S = Q K^T and dP = dO V^T: 64 queries x BK keys, my warp's rows
        // qi0 and qi0 + 8; element 4 j + e at key 8 j + 2 (lane % 4) +
        // (e & 1), row + 8 for e >= 2
        // (two groups: P is formed while dP's product runs)
        float sp[BK / 2], dp[BK / 2];
        fence_regs(sp);
        fence_regs(dp);
        wgmma_fence();
        #pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BK>(sp, desc_k<D>(qs, kk), desc_k<D>(ks, kk), kk > 0);
        wgmma_commit();
        #pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<BK>(dp, desc_k<D>(gs, kk), desc_k<D>(vs, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sp);
        // P, then dS = P (dP - delta), fp32
        const bool open = open_tile(p, q0, k0);
        #pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
            const int qi = qi0 + (x % 4 >= 2 ? 8 : 0);
            const int kpos = k0 + x / 4 * 8 + (lane % 4) * 2 + (x & 1);
            sp[x] = open || kept(p, q0 + qi, kpos)
                ? ex2(sp[x] * p.scale_log2 - ls[qi]) : 0.f;
        }
        wgmma_wait<0>();
        fence_regs(dp);
        #pragma unroll
        for (int x = 0; x < BK / 2; ++x)
            dp[x] = sp[x] * (dp[x] - ds[qi0 + (x % 4 >= 2 ? 8 : 0)]);
        // dQ += dS K over this CTA's columns, dS in bf16 from registers, K
        // MN-major
        uint32_t sa[BK / 16][4];
        acc_to_a(sa, dp);
        fence_regs(sa);
        fence_regs(dq);
        wgmma_fence();
        #pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs<DC>(dq, sa[kk], desc_mn<D>(ks, c0, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        __syncthreads();              // every warp is done with stage st
    }
    bf16* dqg = p.dq + b * p.dqs.b + h * p.dqs.h;
    #pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
        const int col = c0 + j * 8 + (lane % 4) * 2;
        #pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = q0 + qi0 + half * 8;
            if (r >= p.S) continue;
            *reinterpret_cast<uint32_t*>(dqg + (int64_t)r * p.dqs.s + col) =
                pack_bf16(dq[4 * j + 2 * half] * p.scale,
                          dq[4 * j + 2 * half + 1] * p.scale);
        }
    }
}

// CTAs of (b) and (c), or -1 past the one-dimensional grid's limit
template <int D>
int64_t dkdv_blocks(const Bwd& p) {
    const int64_t n = (int64_t)((p.S + BK - 1) / BK) * p.B * (D / chunk<D>())
        * p.KV * p.cluster;
    return n <= 0x7fffffff ? n : -1;
}

template <int D>
int64_t dq_blocks(const Bwd& p) {
    const int64_t n = (int64_t)((p.S + BQ - 1) / BQ) * p.B * (D / chunk<D>())
        * p.H;
    return n <= 0x7fffffff ? n : -1;
}

template <int D>
int launch_dkdv(const Bwd& p, cudaStream_t st) {
    const int64_t blocks = dkdv_blocks<D>(p);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_k_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bwd_smem<D>());
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = bwd_smem<D>();
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, flash_k_bwd_dkdv<D>, p);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Bwd& p, cudaStream_t st) {
    const int64_t blocks = dq_blocks<D>(p);
    if (blocks < 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        flash_k_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bwd_smem<D>());
    if (e != cudaSuccess) return (int)e;
    flash_k_bwd_dq<D><<<(unsigned)blocks, THREADS, bwd_smem<D>(), st>>>(p);
    return (int)cudaGetLastError();
}

Bwd params(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, int64_t B, int64_t S,
           int64_t H, int64_t KV, const int64_t* st, int64_t causal,
           int64_t window, float sm_scale) {
    Bwd p{};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.dout = static_cast<const bf16*>(dout);
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.qs = {st[0], st[1], st[2]};
    p.ks = {st[3], st[4], st[5]};
    p.vs = {st[6], st[7], st[8]};
    p.gs = {st[9], st[10], st[11]};
    p.B = (int)B; p.S = (int)S; p.H = (int)H; p.KV = (int)KV;
    p.causal = (int)causal;
    p.window = (int)window;
    p.cluster = 1;
    p.heads = (int)(H / KV);
    p.scale = sm_scale;
    p.scale_log2 = sm_scale * LOG2E;
    return p;
}

bool dims_ok(int64_t B, int64_t S, int64_t H, int64_t KV) {
    return B <= 0x7fffffff && S <= 0x7fffffff && H <= 0x7fffffff && KV > 0
        && H % KV == 0;
}

}  // namespace

extern "C" int repro_flash_bwd_delta(
        const void* o, const void* dout, void* delta, int64_t B, int64_t S,
        int64_t H, int64_t D, int64_t o_sb, int64_t o_ss, int64_t o_sh,
        int64_t g_sb, int64_t g_ss, int64_t g_sh, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    const int64_t rows = B * S * H;
    const int64_t blocks = (rows + DELTA_ROWS - 1) / DELTA_ROWS;
    if (blocks > 0x7fffffff || D % 2 || D > 256)
        return (int)cudaErrorInvalidValue;
    flash_k_bwd_delta<<<(unsigned)blocks, DELTA_ROWS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        static_cast<float*>(delta), (int)B, (int)S, (int)H, (int)D,
        Strides{o_sb, o_ss, o_sh}, Strides{g_sb, g_ss, g_sh});
    return (int)cudaGetLastError();
}

// strides: q, k, v, dO, then dk, dv (each b, s, h); cluster and heads: the
// group's split (roofline/flash_model.py:dkdv_split), cluster * heads =
// H / KV with cluster <= 8
extern "C" int repro_flash_bwd_dkdv(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int64_t B,
        int64_t S, int64_t H, int64_t KV, int64_t D, int64_t q_sb,
        int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
        int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t g_sb, int64_t g_ss,
        int64_t g_sh, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
        int64_t dv_sb, int64_t dv_ss, int64_t dv_sh, int64_t cluster,
        int64_t heads, int64_t causal, int64_t window, float sm_scale,
        void* stream) {
    if (B <= 0 || S <= 0) return 0;
    if (!dims_ok(B, S, H, KV) || cluster < 1 || cluster > MAX_CLUSTER
            || heads < 1 || cluster * heads != H / KV)
        return (int)cudaErrorInvalidValue;
    const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, g_sb, g_ss, g_sh};
    Bwd p = params(q, k, v, dout, lse, delta, B, S, H, KV, st, causal,
                   window, sm_scale);
    p.cluster = (int)cluster;
    p.heads = (int)heads;
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.dks = {dk_sb, dk_ss, dk_sh};
    p.dvs = {dv_sb, dv_ss, dv_sh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 32) return launch_dkdv<32>(p, s);
    if (D == 64) return launch_dkdv<64>(p, s);
    if (D == 128) return launch_dkdv<128>(p, s);
    if (D == 256) return launch_dkdv<256>(p, s);
    return (int)cudaErrorInvalidValue;
}

// strides: q, k, v, dO, then dq (each b, s, h)
extern "C" int repro_flash_bwd_dq(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, int64_t B, int64_t S,
        int64_t H, int64_t KV, int64_t D, int64_t q_sb, int64_t q_ss,
        int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
        int64_t v_ss, int64_t v_sh, int64_t g_sb, int64_t g_ss, int64_t g_sh,
        int64_t dq_sb, int64_t dq_ss, int64_t dq_sh, int64_t causal,
        int64_t window, float sm_scale, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    if (!dims_ok(B, S, H, KV)) return (int)cudaErrorInvalidValue;
    const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, g_sb, g_ss, g_sh};
    Bwd p = params(q, k, v, dout, lse, delta, B, S, H, KV, st, causal,
                   window, sm_scale);
    p.dq = static_cast<bf16*>(dq);
    p.dqs = {dq_sb, dq_ss, dq_sh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 32) return launch_dq<32>(p, s);
    if (D == 64) return launch_dq<64>(p, s);
    if (D == 128) return launch_dq<128>(p, s);
    if (D == 256) return launch_dq<256>(p, s);
    return (int)cudaErrorInvalidValue;
}
