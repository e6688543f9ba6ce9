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
//   (b) flash_k_bwd_dkdv: one CTA per (batch, KV head, 64-key tile, column
//       chunk of dK/dV). It walks every query head of the KV head's group
//       and, for each, the 64-row query tiles that can see its keys (from
//       the diagonal tile to the last one within the window), so dK and dV
//       are summed over the group in one fixed order, with no atomics: the
//       result is deterministic, which the checkpoint's recompute relies on.
//       Per tile it recomputes S^T = K Q^T, P^T = exp2(S^T * scale * log2(e)
//       - lse2), dP^T = V dO^T, dS^T = P^T * (dP^T - delta), then
//       dV += P^T dO and dK += dS^T Q; dK is scaled once at the end.
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
// Design (a simple kernel first, PERF.md §6 keeps its times): four warps a
// CTA, 16 rows each (keys in (b), queries in (c)); every product is an
// mma.sync m16n8k16 bf16 tile with fp32 accumulators. The CTA stages its
// K, V, Q and dO tiles in shared memory with 16-byte loads, rows padded by
// 8 elements so a warp's fragment loads hit 32 banks; the operand that
// enters a product transposed (dO and Q in (b), K in (c)) is read as two
// 16-bit loads a register. P and dS go from the accumulators straight into
// the A operand of the next product (the m16n8 accumulator of two adjacent
// n-tiles is the m16k16 A fragment). dK/dV (or dQ) stay in registers for a
// chunk of DC = min(D, 128) columns; at D = 256 a second chunk of CTAs
// recomputes S and dP (1.5 times the products) rather than spill.
//
// Bound: at phase z's shape (B=2, H=16, KV=2, S=1024, D=128) the five
// products over the causal half are 21.5 GFLOP against 38.0 MB of inputs
// and outputs: the tensor cores bound it, not memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;            // query rows a tile
constexpr int BK = 64;            // key rows a tile
constexpr int THREADS = 128;      // four warps of 16 rows
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
    int S, H, KV, causal, window; // window 0: none
    float scale, scale_log2;      // sm_scale, sm_scale * log2(e)
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo)
        | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row-major) . b (16 x 8 bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of the m16n8k16 product from a shared tile t with row pitch
// ld (elements). Lane l holds rows g = l / 4 and g + 8, and the column
// pair c = 2 (l % 4) and c + 8 of its 16-wide k slice.

// A (16 x 16): rows row0.. of t, columns k0..
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int row0, int k0, int lane) {
    const bf16* p = t + (row0 + lane / 4) * ld + k0 + (lane % 4) * 2;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * ld);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * ld + 8);
}

// B (16 x 8) with B[k][n] = t[n0 + n][k0 + k]: the rows of t are B's
// columns (a product with t transposed, as S = Q K^T)
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1,
                                            const bf16* t, int ld, int n0,
                                            int k0, int lane) {
    const bf16* p = t + (n0 + lane / 4) * ld + k0 + (lane % 4) * 2;
    b0 = ld32(p);
    b1 = ld32(p + 8);
}

// B (16 x 8) with B[k][n] = t[k0 + k][n0 + n] (a product with t as it is,
// as dV = P^T dO): two 16-bit loads a register
__device__ __forceinline__ void frag_b_cols(uint32_t& b0, uint32_t& b1,
                                            const bf16* t, int ld, int k0,
                                            int n0, int lane) {
    const bf16* p = t + (k0 + (lane % 4) * 2) * ld + n0 + lane / 4;
    b0 = pack2(p[0], p[ld]);
    b1 = pack2(p[8 * ld], p[9 * ld]);
}

// the A operand (16 x 16 bf16) of k slice kk from accumulators of 16 x 8
// n-tiles: tiles 2 kk and 2 kk + 1 hold its columns 0-7 and 8-15
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         float (&c)[N][4], int kk) {
    a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows row0..row0+R-1 of a (S, D) slice with row stride ss into a shared
// tile of pitch D + 8, 16 bytes a load; rows at or past S are zeros
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t ss, int row0, int S) {
    constexpr int PER_ROW = D / 8;
    for (int i = threadIdx.x; i < R * PER_ROW; i += THREADS) {
        const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < S)
            val = *reinterpret_cast<const uint4*>(
                src + (int64_t)(row0 + r) * ss + c);
        *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
    }
}

// lse2 and delta of query rows row0.. of one (batch, head) into shared
// memory; rows at or past S read 0 (their P is masked to 0)
__device__ __forceinline__ void load_rows(float* ls, float* ds, const Bwd& p,
                                          int b, int h, int row0) {
    const int64_t base = ((int64_t)b * p.H + h) * p.S;
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool in = row0 + i < p.S;
        ls[i] = in ? p.lse[base + row0 + i] : 0.f;
        ds[i] = in ? p.delta[base + row0 + i] : 0.f;
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

template <int D>
__host__ __device__ constexpr int chunk() { return D < 128 ? D : 128; }

template <int D>
__host__ __device__ constexpr int smem_bytes() {
    return (2 * BQ + 2 * BK) * (D + 8) * 2 + 2 * BQ * 4;
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_k_bwd_dkdv(const Bwd p) {
    constexpr int LD = D + 8, DC = chunk<D>(), NCH = D / DC;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* ks = reinterpret_cast<bf16*>(smem);      // BK x LD
    bf16* vs = ks + BK * LD;                        // BK x LD
    bf16* qs = vs + BK * LD;                        // BQ x LD
    bf16* gs = qs + BQ * LD;                        // BQ x LD: dO
    float* ls = reinterpret_cast<float*>(gs + BQ * LD);
    float* ds = ls + BQ;
    const int k0 = blockIdx.x * BK, kvh = blockIdx.y;
    const int b = blockIdx.z / NCH, c0 = blockIdx.z % NCH * DC;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int group = p.H / p.KV;
    const int key0 = k0 + warp * 16 + lane / 4;    // my rows: key0, key0 + 8

    load_tile<D, BK>(ks, p.k + b * p.ks.b + kvh * p.ks.h, p.ks.s, k0, p.S);
    load_tile<D, BK>(vs, p.v + b * p.vs.b + kvh * p.vs.h, p.vs.s, k0, p.S);

    float dk[DC / 8][4], dv[DC / 8][4];
    #pragma unroll
    for (int j = 0; j < DC / 8; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

    // the query tiles whose rows can see a key of this tile
    int qt_begin = 0, qt_end = (p.S + BQ - 1) / BQ;
    if (p.causal) {
        qt_begin = k0 / BQ;
        if (p.window > 0) {
            const int k_last = min(k0 + BK, p.S) - 1;
            const int q_last = min(p.S - 1, k_last + p.window - 1);
            qt_end = q_last / BQ + 1;
        }
    }
    for (int hh = 0; hh < group; ++hh) {
        const int h = kvh * group + hh;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();          // every warp is done with the last tile
            load_tile<D, BQ>(qs, p.q + b * p.qs.b + h * p.qs.h, p.qs.s, q0,
                             p.S);
            load_tile<D, BQ>(gs, p.dout + b * p.gs.b + h * p.gs.h, p.gs.s,
                             q0, p.S);
            load_rows(ls, ds, p, b, h, q0);
            __syncthreads();

            // S^T = K Q^T and dP^T = V dO^T: my warp's 16 keys x BQ queries
            float st[BQ / 8][4], dp[BQ / 8][4];
            #pragma unroll
            for (int j = 0; j < BQ / 8; ++j)
                #pragma unroll
                for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
            #pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t ak[4], av[4];
                frag_a(ak, ks, LD, warp * 16, kk * 16, lane);
                frag_a(av, vs, LD, warp * 16, kk * 16, lane);
                #pragma unroll
                for (int j = 0; j < BQ / 8; ++j) {
                    uint32_t b0, b1;
                    frag_b_rows(b0, b1, qs, LD, j * 8, kk * 16, lane);
                    mma(st[j], ak, b0, b1);
                    frag_b_rows(b0, b1, gs, LD, j * 8, kk * 16, lane);
                    mma(dp[j], av, b0, b1);
                }
            }
            // P^T and dS^T = P^T (dP^T - delta), fp32
            #pragma unroll
            for (int j = 0; j < BQ / 8; ++j)
                #pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qi = j * 8 + (lane % 4) * 2 + (e & 1);
                    const int kpos = key0 + (e >= 2 ? 8 : 0);
                    const float pe = kept(p, q0 + qi, kpos)
                        ? ex2(st[j][e] * p.scale_log2 - ls[qi]) : 0.f;
                    st[j][e] = pe;
                    dp[j][e] = pe * (dp[j][e] - ds[qi]);
                }
            // dV += P^T dO and dK += dS^T Q over this CTA's columns
            #pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) {
                uint32_t pa[4], sa[4];
                acc_to_a(pa, st, kk);
                acc_to_a(sa, dp, kk);
                #pragma unroll
                for (int j = 0; j < DC / 8; ++j) {
                    uint32_t b0, b1;
                    frag_b_cols(b0, b1, gs, LD, kk * 16, c0 + j * 8, lane);
                    mma(dv[j], pa, b0, b1);
                    frag_b_cols(b0, b1, qs, LD, kk * 16, c0 + j * 8, lane);
                    mma(dk[j], sa, b0, b1);
                }
            }
        }
    }
    // rows key0 and key0 + 8, columns c0 + 8 j + 2 (lane % 4) and the next
    bf16* dkg = p.dk + b * p.dks.b + kvh * p.dks.h;
    bf16* dvg = p.dv + b * p.dvs.b + kvh * p.dvs.h;
    #pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
        const int col = c0 + j * 8 + (lane % 4) * 2;
        #pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = key0 + half * 8;
            if (r >= p.S) continue;
            *reinterpret_cast<uint32_t*>(dkg + (int64_t)r * p.dks.s + col) =
                pack_bf16(dk[j][2 * half] * p.scale,
                          dk[j][2 * half + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(dvg + (int64_t)r * p.dvs.s + col) =
                pack_bf16(dv[j][2 * half], dv[j][2 * half + 1]);
        }
    }
}

// -- (c) dQ --------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_k_bwd_dq(const Bwd p) {
    constexpr int LD = D + 8, DC = chunk<D>(), NCH = D / DC;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* qs = reinterpret_cast<bf16*>(smem);      // BQ x LD
    bf16* gs = qs + BQ * LD;                        // BQ x LD: dO
    bf16* ks = gs + BQ * LD;                        // BK x LD
    bf16* vs = ks + BK * LD;                        // BK x LD
    float* ls = reinterpret_cast<float*>(vs + BK * LD);
    float* ds = ls + BQ;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y;
    const int b = blockIdx.z / NCH, c0 = blockIdx.z % NCH * DC;
    const int kvh = h / (p.H / p.KV);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int qi0 = warp * 16 + lane / 4;          // my rows: qi0, qi0 + 8

    load_tile<D, BQ>(qs, p.q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.S);
    load_tile<D, BQ>(gs, p.dout + b * p.gs.b + h * p.gs.h, p.gs.s, q0, p.S);
    load_rows(ls, ds, p, b, h, q0);

    float dq[DC / 8][4];
    #pragma unroll
    for (int j = 0; j < DC / 8; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

    // the key tiles this tile's rows can see
    int kt_begin = 0, kt_end = (p.S + BK - 1) / BK;
    if (p.causal) {
        kt_end = (min(q0 + BQ, p.S) - 1) / BK + 1;
        if (p.window > 0) {
            const int first = q0 - (p.window - 1);
            kt_begin = first > 0 ? first / BK : 0;
        }
    }
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();              // every warp is done with the last tile
        load_tile<D, BK>(ks, p.k + b * p.ks.b + kvh * p.ks.h, p.ks.s, k0,
                         p.S);
        load_tile<D, BK>(vs, p.v + b * p.vs.b + kvh * p.vs.h, p.vs.s, k0,
                         p.S);
        __syncthreads();

        // S = Q K^T and dP = dO V^T: my warp's 16 queries x BK keys
        float st[BK / 8][4], dp[BK / 8][4];
        #pragma unroll
        for (int j = 0; j < BK / 8; ++j)
            #pragma unroll
            for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
        #pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t aq[4], ag[4];
            frag_a(aq, qs, LD, warp * 16, kk * 16, lane);
            frag_a(ag, gs, LD, warp * 16, kk * 16, lane);
            #pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                uint32_t b0, b1;
                frag_b_rows(b0, b1, ks, LD, j * 8, kk * 16, lane);
                mma(st[j], aq, b0, b1);
                frag_b_rows(b0, b1, vs, LD, j * 8, kk * 16, lane);
                mma(dp[j], ag, b0, b1);
            }
        }
        // P and dS = P (dP - delta), fp32
        #pragma unroll
        for (int j = 0; j < BK / 8; ++j)
            #pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = qi0 + (e >= 2 ? 8 : 0);
                const int kpos = k0 + j * 8 + (lane % 4) * 2 + (e & 1);
                const float pe = kept(p, q0 + qi, kpos)
                    ? ex2(st[j][e] * p.scale_log2 - ls[qi]) : 0.f;
                dp[j][e] = pe * (dp[j][e] - ds[qi]);
            }
        // dQ += dS K over this CTA's columns
        #pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t sa[4];
            acc_to_a(sa, dp, kk);
            #pragma unroll
            for (int j = 0; j < DC / 8; ++j) {
                uint32_t b0, b1;
                frag_b_cols(b0, b1, ks, LD, kk * 16, c0 + j * 8, lane);
                mma(dq[j], sa, b0, b1);
            }
        }
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
                pack_bf16(dq[j][2 * half] * p.scale,
                          dq[j][2 * half + 1] * p.scale);
        }
    }
}

template <int D>
int launch_dkdv(const Bwd& p, int B, cudaStream_t st) {
    constexpr int NCH = D / chunk<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_k_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.S + BK - 1) / BK, p.KV, B * NCH);
    flash_k_bwd_dkdv<D><<<grid, THREADS, smem_bytes<D>(), st>>>(p);
    return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const Bwd& p, int B, cudaStream_t st) {
    constexpr int NCH = D / chunk<D>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_k_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((p.S + BQ - 1) / BQ, p.H, B * NCH);
    flash_k_bwd_dq<D><<<grid, THREADS, smem_bytes<D>(), st>>>(p);
    return (int)cudaGetLastError();
}

Bwd params(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, int64_t S, int64_t H,
           int64_t KV, const int64_t* st, int64_t causal, int64_t window,
           float sm_scale) {
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
    p.S = (int)S; p.H = (int)H; p.KV = (int)KV;
    p.causal = (int)causal;
    p.window = (int)window;
    p.scale = sm_scale;
    p.scale_log2 = sm_scale * LOG2E;
    return p;
}

bool grid_fits(int64_t B, int64_t S, int64_t heads, int64_t D) {
    // blockIdx.y and .z are at most 65 535
    return heads <= 65535 && B * (D > 128 ? 2 : 1) <= 65535 && S <= 0x7fffffff;
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

// strides: q, k, v, dO, then dk, dv (each b, s, h)
extern "C" int repro_flash_bwd_dkdv(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int64_t B,
        int64_t S, int64_t H, int64_t KV, int64_t D, int64_t q_sb,
        int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
        int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t g_sb, int64_t g_ss,
        int64_t g_sh, int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
        int64_t dv_sb, int64_t dv_ss, int64_t dv_sh, int64_t causal,
        int64_t window, float sm_scale, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    if (!grid_fits(B, S, KV, D) || KV <= 0 || H % KV)
        return (int)cudaErrorInvalidValue;
    const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, g_sb, g_ss, g_sh};
    Bwd p = params(q, k, v, dout, lse, delta, S, H, KV, st, causal, window,
                   sm_scale);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.dks = {dk_sb, dk_ss, dk_sh};
    p.dvs = {dv_sb, dv_ss, dv_sh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 32) return launch_dkdv<32>(p, (int)B, s);
    if (D == 64) return launch_dkdv<64>(p, (int)B, s);
    if (D == 128) return launch_dkdv<128>(p, (int)B, s);
    if (D == 256) return launch_dkdv<256>(p, (int)B, s);
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
    if (!grid_fits(B, S, H, D) || KV <= 0 || H % KV)
        return (int)cudaErrorInvalidValue;
    const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, g_sb, g_ss, g_sh};
    Bwd p = params(q, k, v, dout, lse, delta, S, H, KV, st, causal, window,
                   sm_scale);
    p.dq = static_cast<bf16*>(dq);
    p.dqs = {dq_sb, dq_ss, dq_sh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 32) return launch_dq<32>(p, (int)B, s);
    if (D == 64) return launch_dq<64>(p, (int)B, s);
    if (D == 128) return launch_dq<128>(p, (int)B, s);
    if (D == 256) return launch_dq<256>(p, (int)B, s);
    return (int)cudaErrorInvalidValue;
}
