// Causal flash attention with an optional sliding window and grouped KV
// heads, on Hopper. It replaces kernels/flash_attn.py:flash_attention_pallas
// (the prefill lane of models/attention.py under the flash switch).
//
// Semantics kept from the TPU kernel (_flash_kernel):
//   - score = fp32 dot(q, k) * sm_scale, the scale applied after the dot;
//   - masked scores are -1e30: kpos > qpos, or qpos - kpos >= window, and
//     keys at or past S;
//   - running (online) max m and sum l in fp32; l sums the unrounded fp32
//     p, while p is rounded to bf16 before the p.V product;
//   - fp32 accumulator; out = acc / max(l, 1e-30), rounded to bf16;
//   - optionally the log-sum-exp of each row, fp32 (B, H, S), in the
//     kernel's base-2 domain: lse2 = m + log2(max(l, 1e-30)) from the same
//     running m and l, so exp2(s2 - lse2) is the row's softmax. The train
//     lane's backward (csrc/flash_attn_bwd.cu) recomputes P from it; a null
//     pointer skips the store (the prefill);
//   - tiles wholly above the diagonal or left of the window are skipped.
//     The diagonal tile is always visited last, so a row that a window
//     masks wholly in an earlier tile (its state then holds p = 1 for
//     every key) is wiped by that tile's alpha = 0, as on the TPU.
// The one change in arithmetic is the exponent. The kernel works in the
// base-2 domain: s2 = dot * (sm_scale * log2(e)), m and the masked -1e30
// are base-2 values, p = ex2.approx(s2 - m) and alpha = ex2.approx(m_old -
// m_new). That is exp(s - m) of the reference up to a few fp32 ulp (one
// FFMA and one MUFU op an element, where expf takes a long sequence), far
// below the bf16 rounding p gets before p.V.
//
// Layout: q and out (B, S, H, D), k and v (B, S, KV, D), bf16, read through
// their strides (the last dim contiguous), so the model's (B, S, H, D)
// tensors and strided views need no copy. The kv head of query head h is
// h / (H / KV); K and V are never broadcast over the group.
//
// Design: CTAs of three warpgroups over 128-row q tiles of a head.
//   - Warpgroup 0 is the producer: it drops to 24 registers (setmaxnreg)
//     and one thread issues every load with TMA. q, k and v are 4-D tensor
//     maps (D, S, heads, B) with the tensors' own strides; a tile is D/64
//     boxes of 64 columns (one of 32 at D = 32), 128-byte swizzled (64-byte
//     at D = 32) to match the wgmma descriptors. Rows at or past S come
//     back as zeros from outside the map and are masked. Q is loaded once
//     a work item; K and V tiles stream through a 2-stage ring, each stage
//     with a "full" mbarrier (TMA's byte count) and an "empty" one (the
//     consumers' release), K and V on barriers of their own.
//   - Warpgroups 1 and 2 are consumers (240 registers), 64 q rows each.
//     S = Q K^T is a wgmma with both operands in shared memory (K-major);
//     O += P V is a wgmma with P, rounded to bf16, from registers, and V
//     from shared memory as it lands, (keys, D) with D contiguous: the
//     MN-major (transposed) B operand. Each warpgroup issues tile i's
//     Q K^T together with tile i-1's P V, then does tile i's softmax while
//     that P V runs. The two warpgroups take turns on two named barriers
//     to issue their products, so one's softmax overlaps the other's
//     products. The first and last issue points (Q K^T alone, P V alone)
//     are peeled off the loop: a wgmma on a divergent path makes ptxas
//     serialise every wgmma of the kernel (warning C7520).
//   - A tile that masks no row of a warpgroup skips the mask: one FFMA and
//     one ex2 an element.
//   - Tile sizes are a template over D: BN = 128 keys for D <= 128 (160 KB
//     of shared memory at D = 128, one CTA an SM) and BN = 64 at D = 256,
//     where O alone is 128 registers a consumer thread and Q is 64 KB.
//   - Persistent CTAs, one an SM, walk the work items (a q tile of one
//     batch and head), numbered longest first, in rounds of alternating
//     direction: a static schedule that evens out the causal triangle's
//     unequal items. The producer loads the next item's Q (once both
//     warpgroups are done with this one's: a q_empty mbarrier) and tiles
//     while the consumers finish this one.
// Out is stored from registers, 4 bytes a thread.
//
// Bound: at the prefill shape of qwen2.5-3b (B=4, H=16, KV=2, S=2048,
// D=128) the causal half of the two products is 68.7 GFLOP against
// 75.5 MB of q, k, v and out, so the tensor cores bound it, not memory.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash.cuh"

namespace {

constexpr int BM = 128;          // q rows per CTA: 64 per consumer warpgroup
constexpr int STAGES = 2;        // K/V ring depth
constexpr int THREADS = 384;     // producer + two consumer warpgroups
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BAR_WG0 = 1, BAR_WG1 = 2;   // named barriers: turn to issue

template <int D>
struct Tile {
    static constexpr int BN = D == 256 ? 64 : 128;    // keys per K/V tile
    static constexpr int BOXC = D == 32 ? 32 : 64;    // columns per TMA box
    static constexpr int ROWB = BOXC * 2;             // bytes a box row
    static constexpr int NBOX = D / BOXC;
    static constexpr int KPB = BOXC / 16;             // k16 steps per box
    static constexpr uint64_t LAYOUT = D == 32 ? 2 : 1;   // B64 : B128
    static constexpr int Q_BYTES = BM * D * 2;
    static constexpr int KV_BYTES = BN * D * 2;
    static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES;
    static constexpr int SMEM_ALLOC = SMEM + 1024 + 128;   // align + barriers
};

// -- mbarriers and TMA ---------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@done bra DONE;\n"
        "bra WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

struct Params {
    __nv_bfloat16* o;
    float* lse;                  // (B, H, S) base-2 log-sum-exp, or null
    int64_t o_sb, o_ss, o_sh;    // element strides of out (d stride 1)
    int B, S, H, KV;
    int causal;
    int window;                  // 0: no window
    float scale_log2;            // sm_scale * log2(e)
};

// The softmax of one tile for this thread's two rows (r0 and r0 + 8):
// s holds the raw dots on entry and p (fp32) on exit; returns alpha for
// each row and adds the tile's p to l.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], bool open,
                                             int k0, int r0, int tcol,
                                             const Params& p, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1) {
    const float c = p.scale_log2;
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (open) {
        // no row masks a key: max of the raw dots, then one FFMA and one
        // ex2 an element (c > 0, so max(dot) * c = max(dot * c))
        #pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            if (i % 4 < 2) mx0 = fmaxf(mx0, s[i]);
            else mx1 = fmaxf(mx1, s[i]);
        }
        mx0 *= c;
        mx1 *= c;
    } else {
        #pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            const int qpos = i % 4 < 2 ? r0 : r0 + 8;
            const int kpos = k0 + (i / 4) * 8 + tcol + (i & 1);
            bool ok = kpos < p.S;
            if (p.causal) {
                ok = ok && qpos >= kpos;
                if (p.window > 0) ok = ok && qpos - kpos < p.window;
            }
            const float x = ok ? s[i] * c : NEG_INF;
            s[i] = x;
            if (i % 4 < 2) mx0 = fmaxf(mx0, x);
            else mx1 = fmaxf(mx1, x);
        }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    alpha0 = ex2(m0 - mn0);
    alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    if (open) {
        #pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            if (i % 4 < 2) { s[i] = ex2(fmaf(s[i], c, -mn0)); sum0 += s[i]; }
            else { s[i] = ex2(fmaf(s[i], c, -mn1)); sum1 += s[i]; }
        }
    } else {
        #pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            if (i % 4 < 2) { s[i] = ex2(s[i] - mn0); sum0 += s[i]; }
            else { s[i] = ex2(s[i] - mn1); sum1 += s[i]; }
        }
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
}

// One work item: a 128-row q tile of one (batch, head), and the key tiles
// it needs. Items are numbered longest first (the q tiles nearest the end
// of the sequence see the most keys), heads and batches fastest.
struct Item {
    int q0, h, b, kvh, kt_begin, ntiles;
};

template <int BN>
__device__ __forceinline__ Item item_at(int idx, int nq, const Params& p) {
    Item w;
    const int hb = p.H * p.B;
    w.q0 = (nq - 1 - idx / hb) * BM;
    w.h = idx % hb % p.H;
    w.b = idx % hb / p.H;
    w.kvh = w.h / (p.H / p.KV);
    const int q_last = min(w.q0 + BM - 1, p.S - 1);
    const int kt_end = p.causal ? q_last / BN + 1 : (p.S + BN - 1) / BN;
    w.kt_begin = 0;
    if (p.causal && p.window > 0) {
        const int first_key = w.q0 - (p.window - 1);
        w.kt_begin = first_key > 0 ? first_key / BN : 0;
    }
    w.ntiles = kt_end - w.kt_begin;
    return w;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_k_attn_fwd(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Params p) {
    using T = Tile<D>;
    constexpr int BN = T::BN;
    extern __shared__ unsigned char smem_raw[];
    // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
    const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t k_s = q_s + T::Q_BYTES;               // STAGES tiles
    const uint32_t v_s = k_s + STAGES * T::KV_BYTES;     // STAGES tiles
    // mbarriers: q_full, q_empty, then full_k, full_v, empty_k, empty_v
    // per stage
    const uint32_t q_full = v_s + STAGES * T::KV_BYTES, q_empty = q_full + 8;
    const uint32_t full_k = q_empty + 8, full_v = full_k + 8 * STAGES;
    const uint32_t empty_k = full_v + 8 * STAGES;
    const uint32_t empty_v = empty_k + 8 * STAGES;
    const int nq = (p.S + BM - 1) / BM;
    const int n_items = nq * p.H * p.B;
    // this CTA's item of round r: rounds alternate direction, so a CTA that
    // took one of the longest items of a round takes one of the shortest
    // of the next, and the sums even out
    auto item_index = [&](int r) {
        const int g = (int)gridDim.x, j = (int)blockIdx.x;
        return r * g + (r % 2 ? g - 1 - j : j);
    };

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        mbar_init(q_empty, 256);                 // every consumer thread
        #pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_k + 8 * s, 1);
            mbar_init(full_v + 8 * s, 1);
            mbar_init(empty_k + 8 * s, 256);
            mbar_init(empty_v + 8 * s, 256);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // warp-uniform for the compiler: wgmma must not sit on a divergent path
    const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
    if (wg == 0) {
        // == producer: one thread issues every TMA load, item after item;
        // the next item's Q and first tiles load while the consumers
        // finish this one ==
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (threadIdx.x == 0) {
            int it = 0;                          // K/V tiles so far
            int n = 0;                           // items so far
            for (int r = 0;; ++r) {
                const int idx = item_index(r);
                if (idx >= n_items) break;
                const Item w = item_at<BN>(idx, nq, p);
                if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
                mbar_expect_tx(q_full, T::Q_BYTES);
                #pragma unroll
                for (int x = 0; x < T::NBOX; ++x)
                    tma_load_4d(q_s + x * BM * T::ROWB, &qmap, q_full,
                                x * T::BOXC, w.q0, w.h, w.b);
                for (int i = 0; i < w.ntiles; ++i, ++it) {
                    const int st = it % STAGES;
                    const uint32_t parity = ((it / STAGES) & 1) ^ 1;
                    const int row = (w.kt_begin + i) * BN;
                    if (it >= STAGES) mbar_wait(empty_k + 8 * st, parity);
                    mbar_expect_tx(full_k + 8 * st, T::KV_BYTES);
                    #pragma unroll
                    for (int x = 0; x < T::NBOX; ++x)
                        tma_load_4d(
                            k_s + st * T::KV_BYTES + x * BN * T::ROWB, &kmap,
                            full_k + 8 * st, x * T::BOXC, row, w.kvh, w.b);
                    if (it >= STAGES) mbar_wait(empty_v + 8 * st, parity);
                    mbar_expect_tx(full_v + 8 * st, T::KV_BYTES);
                    #pragma unroll
                    for (int x = 0; x < T::NBOX; ++x)
                        tma_load_4d(
                            v_s + st * T::KV_BYTES + x * BN * T::ROWB, &vmap,
                            full_v + 8 * st, x * T::BOXC, row, w.kvh, w.b);
                }
                ++n;
            }
        }
    } else {
        // == consumers: 64 q rows a warpgroup ==
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int c = wg - 1;
        const int tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32;
        const int tcol = (lane % 4) * 2;
        const int my_bar = c == 0 ? BAR_WG0 : BAR_WG1;
        const int other_bar = c == 0 ? BAR_WG1 : BAR_WG0;
        constexpr uint32_t SBO = 8 * T::ROWB;        // next 8-row group
        const uint32_t q_wg = q_s + c * 64 * T::ROWB;

        float o[D / 2];
        float s[BN / 2];
        uint32_t pf[BN / 16][4];
        float m0, m1, l0, l1;
        int it = 0;                                  // K/V tiles so far
        int n = 0;                                   // items so far
        Item w{};
        int wr0, r0;                  // this warpgroup's first row, and mine

        // S_i = Q K_i^T, both operands in shared memory (K-major)
        auto issue_s = [&](int i) {
            const int st = (it + i) % STAGES;
            const uint32_t k_t = k_s + st * T::KV_BYTES;
            #pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t box = kk / T::KPB, step = (kk % T::KPB) * 32;
                wgmma_ss<BN>(s,
                    gmma_desc(q_wg + box * BM * T::ROWB + step, 16, SBO,
                              T::LAYOUT),
                    gmma_desc(k_t + box * BN * T::ROWB + step, 16, SBO,
                              T::LAYOUT),
                    kk > 0);
            }
            wgmma_commit();
        };
        // O += P_i V_i, P from registers, V MN-major in shared memory
        auto issue_pv = [&](int i) {
            const int st = (it + i) % STAGES;
            mbar_wait(full_v + 8 * st, ((it + i) / STAGES) & 1);
            const uint32_t v_t = v_s + st * T::KV_BYTES;
            #pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
                wgmma_rs<D>(o, pf[kk], gmma_desc(v_t + kk * 16 * T::ROWB,
                                                 BN * T::ROWB, SBO,
                                                 T::LAYOUT));
            wgmma_commit();
        };
        // S_i landed: release K_i (and Q after the item's last tile),
        // softmax; rescale O once no P V is in flight, then P_i in bf16 as
        // wgmma's register A operand (k16 step kk holds keys 16kk..16kk+15
        // of rows r0 and r0 + 8)
        auto softmax = [&](int i, bool pv_in_flight) {
            fence_regs(s);
            mbar_arrive(empty_k + 8 * ((it + i) % STAGES));
            if (i == w.ntiles - 1) mbar_arrive(q_empty);
            const int k0 = (w.kt_begin + i) * BN;
            const bool open = k0 + BN <= p.S && (!p.causal
                || (k0 + BN - 1 <= wr0
                    && (p.window <= 0 || wr0 + 63 - k0 < p.window)));
            float alpha0, alpha1;
            softmax_tile<BN>(s, open, k0, r0, tcol, p, m0, m1, l0, l1,
                             alpha0, alpha1);
            if (pv_in_flight) {
                wgmma_wait<0>();
                fence_regs(o);
                mbar_arrive(empty_v + 8 * ((it + i - 1) % STAGES));
            }
            #pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                o[j * 4 + 0] *= alpha0;
                o[j * 4 + 1] *= alpha0;
                o[j * 4 + 2] *= alpha1;
                o[j * 4 + 3] *= alpha1;
            }
            #pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                pf[kk][0] = pack_bf16(s[kk * 8 + 0], s[kk * 8 + 1]);
                pf[kk][1] = pack_bf16(s[kk * 8 + 2], s[kk * 8 + 3]);
                pf[kk][2] = pack_bf16(s[kk * 8 + 4], s[kk * 8 + 5]);
                pf[kk][3] = pack_bf16(s[kk * 8 + 6], s[kk * 8 + 7]);
            }
        };

        for (int r = 0;; ++r) {
            const int idx = item_index(r);
            if (idx >= n_items) break;
            w = item_at<BN>(idx, nq, p);
            wr0 = w.q0 + c * 64;
            r0 = wr0 + warp * 16 + lane / 4;
            #pragma unroll
            for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
            m0 = m1 = NEG_INF;
            l0 = l1 = 0.f;

            // the warpgroups take turns to issue: BAR_WG0 lets warpgroup 0
            // go, BAR_WG1 warpgroup 1; each sync is paired with one arrive
            if (c == 1) named_arrive(BAR_WG0);       // warpgroup 0 first
            mbar_wait(q_full, n & 1);
            mbar_wait(full_k + 8 * (it % STAGES), (it / STAGES) & 1);
            named_sync(my_bar);
            fence_regs(s);
            wgmma_fence();
            issue_s(0);
            named_arrive(other_bar);
            wgmma_wait<0>();
            softmax(0, false);
            // tile i's Q K^T with tile i-1's P V; the softmax of the one
            // runs while the other's product does
            for (int i = 1; i < w.ntiles; ++i) {
                mbar_wait(full_k + 8 * ((it + i) % STAGES),
                          ((it + i) / STAGES) & 1);
                named_sync(my_bar);
                fence_regs(s);
                fence_regs(o);
                fence_regs(pf);
                wgmma_fence();
                issue_s(i);
                issue_pv(i - 1);
                named_arrive(other_bar);
                wgmma_wait<1>();
                softmax(i, true);
            }
            named_sync(my_bar);
            fence_regs(o);
            fence_regs(pf);
            wgmma_fence();
            issue_pv(w.ntiles - 1);
            if (c == 0) named_arrive(other_bar);      // warpgroup 1 ends
            wgmma_wait<0>();
            fence_regs(o);
            mbar_arrive(empty_v + 8 * ((it + w.ntiles - 1) % STAGES));
            it += w.ntiles;
            ++n;

            // the row sums: each of the 4 threads of a quad holds a share
            l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
            l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
            l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
            l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
            const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
            __nv_bfloat16* og = p.o + w.b * p.o_sb + w.h * p.o_sh;
            const int r1 = r0 + 8;
            if (p.lse != nullptr && lane % 4 == 0) {
                // m and l are the same in the four threads of a quad
                float* lg = p.lse + ((int64_t)w.b * p.H + w.h) * p.S;
                if (r0 < p.S) lg[r0] = m0 + log2f(d0);
                if (r1 < p.S) lg[r1] = m1 + log2f(d1);
            }
            #pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                const int col = j * 8 + tcol;
                if (r0 < p.S)
                    *reinterpret_cast<uint32_t*>(
                        og + (int64_t)r0 * p.o_ss + col)
                        = pack_bf16(o[j * 4 + 0] / d0, o[j * 4 + 1] / d0);
                if (r1 < p.S)
                    *reinterpret_cast<uint32_t*>(
                        og + (int64_t)r1 * p.o_ss + col)
                        = pack_bf16(o[j * 4 + 2] / d1, o[j * 4 + 3] / d1);
            }
        }
    }
}

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library links against no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// a (D, S, heads, B) bf16 tensor with element strides ss, sh, sb, cut into
// boxes of (boxc columns, rows) and swizzled to match the wgmma descriptors
int encode(CUtensorMap* map, const void* ptr, int64_t D, int64_t S,
           int64_t heads, int64_t B, int64_t ss, int64_t sh, int64_t sb,
           int boxc, int rows) {
    EncodeTiled fn = encoder();
    if (fn == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                                (cuuint64_t)heads, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                   (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {(cuuint32_t)boxc, (cuuint32_t)rows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      boxc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);    // zeros
    return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int64_t B, const int64_t* qs, const int64_t* ks,
           const int64_t* vs, cudaStream_t stream) {
    using T = Tile<D>;
    CUtensorMap qm, km, vm;
    int err = encode(&qm, q, D, p.S, p.H, B, qs[1], qs[2], qs[0], T::BOXC, BM);
    if (!err)
        err = encode(&km, k, D, p.S, p.KV, B, ks[1], ks[2], ks[0], T::BOXC,
                     T::BN);
    if (!err)
        err = encode(&vm, v, D, p.S, p.KV, B, vs[1], vs[2], vs[0], T::BOXC,
                     T::BN);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(
        flash_k_attn_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM_ALLOC);
    if (e != cudaSuccess) return (int)e;
    // persistent: one CTA an SM, each walking items longest first
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int64_t items = (p.S + BM - 1) / BM * (int64_t)p.H * B;
    const int grid = (int)(items < sms ? items : sms);
    flash_k_attn_fwd<D><<<grid, THREADS, T::SMEM_ALLOC, stream>>>(qm, km, vm,
                                                                  p);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attn(
        const void* q, const void* k, const void* v, void* o, void* lse,
        int64_t B, int64_t S, int64_t H, int64_t KV, int64_t D,
        int64_t q_sb, int64_t q_ss, int64_t q_sh,
        int64_t k_sb, int64_t k_ss, int64_t k_sh,
        int64_t v_sb, int64_t v_ss, int64_t v_sh,
        int64_t o_sb, int64_t o_ss, int64_t o_sh,
        int64_t causal, int64_t window, float sm_scale, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    if ((S + BM - 1) / BM * H * B > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lse = static_cast<float*>(lse);
    p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
    p.B = (int)B; p.S = (int)S; p.H = (int)H; p.KV = (int)KV;
    p.causal = (int)causal;
    p.window = (int)window;
    p.scale_log2 = sm_scale * LOG2E;
    const int64_t qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh},
                  vs[3] = {v_sb, v_ss, v_sh};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 32) return launch<32>(q, k, v, p, B, qs, ks, vs, st);
    if (D == 64) return launch<64>(q, k, v, p, B, qs, ks, vs, st);
    if (D == 128) return launch<128>(q, k, v, p, B, qs, ks, vs, st);
    if (D == 256) return launch<256>(q, k, v, p, B, qs, ks, vs, st);
    return (int)cudaErrorInvalidValue;
}
