// Causal flash attention with an optional sliding window and grouped KV
// heads, on Hopper. It replaces kernels/flash_attn.py:flash_attention_pallas
// (the prefill lane of models/attention.py under the flash switch).
//
// Semantics kept from the TPU kernel (_flash_kernel):
//   - score = fp32 dot(q, k) * sm_scale, the scale applied after the dot;
//   - masked scores are -1e30: kpos > qpos, or qpos - kpos >= window;
//   - running (online) max m and sum l in fp32; p = exp(s - m_new) with
//     expf, alpha = exp(m_prev - m_new); l sums the unrounded fp32 p,
//     while p is rounded to bf16 before the p.V product;
//   - fp32 accumulator; out = acc / max(l, 1e-30), rounded to bf16;
//   - tiles wholly above the diagonal or left of the window are skipped.
//     The diagonal tile is always visited last, so a row that a window
//     masks wholly in an earlier tile (its state then holds p = 1 for
//     every key) is wiped by that tile's alpha = 0, as on the TPU.
//
// Layout: q and out (B, S, H, D), k and v (B, S, KV, D), bf16, addressed
// by explicit strides (the last dim contiguous), so the model's (B,S,H,D)
// tensors need no transpose. The kv head of query head h is h / (H / KV);
// K and V are never broadcast over the group.
//
// Design (a first, simple form; wgmma, TMA and warp specialisation are
// later work): one CTA of 4 warps per (64-row q tile, head, batch); each
// warp owns 16 q rows and keeps their row state (m, l, the 16 x D fp32
// accumulator) in registers. K/V tiles of 32 keys stream through shared
// memory in increasing key order, double-buffered with cp.async so the
// next tile loads while this one computes. With the accurate expf the
// softmax's per-element work, not the tensor cores, sets the pace: tiles
// of 32 keys ran faster on the H100 than tiles of 64, and a tile that no
// row of a warp masks skips the mask. Both products run on the
// tensor cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate);
// fragments come from shared memory through ldmatrix (.trans for V).
// Rows and keys past S (a ragged last tile) load as zeros and are masked.
//
// Bound: at the prefill shape of qwen2.5-3b (B=4, H=16, KV=2, S=2048,
// D=128) the causal half of the two products is 68.7 GFLOP against
// 75.5 MB of q, k, v and out, so the tensor cores bound it, not memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;           // q rows per CTA
constexpr int BN = 32;           // keys per tile
constexpr int WARPS = 4;         // 16 q rows each
constexpr int PAD = 8;           // bf16 of row padding: conflict-free ldmatrix
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

struct Params {
    const __nv_bfloat16* q;
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    __nv_bfloat16* o;
    int64_t q_sb, q_ss, q_sh;    // element strides of q (d stride 1)
    int64_t k_sb, k_ss, k_sh;
    int64_t v_sb, v_ss, v_sh;
    int64_t o_sb, o_ss, o_sh;
    int S, H, KV;
    int causal;
    int window;                  // 0: no window
    float sm_scale;
};

// rows x D bf16 tile (row stride D + PAD in shared memory) from rows
// [row0, row0 + rows) of a (S, D) slice with row stride `ss`
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t ss, int row0, int S) {
    constexpr int CHUNKS = D / 8;                 // 16 B chunks per row
    for (int c = threadIdx.x; c < ROWS * CHUNKS; c += WARPS * 32) {
        int r = c / CHUNKS, col = (c % CHUNKS) * 8;
        bool valid = row0 + r < S;
        const __nv_bfloat16* g = valid ? src + (int64_t)(row0 + r) * ss + col
                                       : src;
        cp_async16(dst + r * (D + PAD) + col, g, valid);
    }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_k_attn_fwd(Params p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Ks = Qs + BM * (D + PAD);       // two buffers
    __nv_bfloat16* Vs = Ks + 2 * BN * (D + PAD);   // two buffers

    const int nq = (p.S + BM - 1) / BM;
    const int qi = nq - 1 - (int)blockIdx.x;       // longest rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int kvh = h / (p.H / p.KV);
    const int q0 = qi * BM;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;          // mma group, thread in it

    const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
    const __nv_bfloat16* vg = p.v + b * p.v_sb + kvh * p.v_sh;

    // key tiles this q tile needs
    const int q_last = min(q0 + BM - 1, p.S - 1);
    const int nk = (p.S + BN - 1) / BN;
    int kt_end = p.causal ? q_last / BN + 1 : nk;
    int kt_begin = 0;
    if (p.causal && p.window > 0) {
        int first_key = q0 - (p.window - 1);
        kt_begin = first_key > 0 ? first_key / BN : 0;
    }

    load_tile<D, BM>(Qs, qg, p.q_ss, q0, p.S);
    load_tile<D, BN>(Ks, kg, p.k_ss, kt_begin * BN, p.S);
    load_tile<D, BN>(Vs, vg, p.v_ss, kt_begin * BN, p.S);
    cp_async_commit();

    uint32_t qf[D / 16][4];                        // this warp's q rows
    float acc[D / 8][4];
    #pragma unroll
    for (int i = 0; i < D / 8; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF;              // rows g and g + 8
    float l0 = 0.f, l1 = 0.f;                      // this thread's share
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int buf = (kt - kt_begin) & 1;
        if (kt + 1 < kt_end) {
            load_tile<D, BN>(Ks + (buf ^ 1) * BN * (D + PAD), kg, p.k_ss,
                             (kt + 1) * BN, p.S);
            load_tile<D, BN>(Vs + (buf ^ 1) * BN * (D + PAD), vg, p.v_ss,
                             (kt + 1) * BN, p.S);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (kt == kt_begin) {
            #pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const __nv_bfloat16* a = Qs + (warp * 16 + (lane % 16))
                    * (D + PAD) + kk * 16 + (lane / 16) * 8;
                ldsm_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], a);
            }
        }
        const __nv_bfloat16* Kb = Ks + buf * BN * (D + PAD);
        const __nv_bfloat16* Vb = Vs + buf * BN * (D + PAD);

        // s = q . k^T over this tile: 8 column blocks of 8 keys
        float s[BN / 8][4];
        #pragma unroll
        for (int j = 0; j < BN / 8; ++j)
            s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        #pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            #pragma unroll
            for (int j = 0; j < BN / 8; j += 2) {
                uint32_t b0, b1, b2, b3;
                const __nv_bfloat16* a = Kb
                    + ((j + (lane / 16)) * 8 + (lane % 8)) * (D + PAD)
                    + kk * 16 + ((lane / 8) % 2) * 8;
                ldsm_x4(b0, b1, b2, b3, a);
                mma_bf16(s[j], qf[kk], b0, b1);
                mma_bf16(s[j + 1], qf[kk], b2, b3);
            }
        }

        // scale, mask, running max. A tile whose every key every row of
        // this warp sees needs no mask (the same values, less work).
        const int k0 = kt * BN;
        const int w0 = q0 + warp * 16;                // this warp's rows
        const bool open = k0 + BN <= p.S && (!p.causal
            || (k0 + BN - 1 <= w0
                && (p.window <= 0 || w0 + 15 - k0 < p.window)));
        float mx0 = NEG_INF, mx1 = NEG_INF;
        if (open) {
            #pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                #pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float x = s[j][e] * p.sm_scale;
                    s[j][e] = x;
                    if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
                }
            }
        } else {
            #pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                #pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qpos = e < 2 ? r0 : r1;
                    const int kpos = k0 + j * 8 + t * 2 + (e & 1);
                    bool ok = kpos < p.S;
                    if (p.causal) {
                        ok = ok && qpos >= kpos;
                        if (p.window > 0) ok = ok && qpos - kpos < p.window;
                    }
                    const float x = ok ? s[j][e] * p.sm_scale : NEG_INF;
                    s[j][e] = x;
                    if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
                }
            }
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;

        // p = exp(s - m_new); l sums it unrounded, p.V takes it in bf16
        uint32_t pf[BN / 16][4];
        float sum0 = 0.f, sum1 = 0.f;
        #pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const float p0 = expf(s[j][0] - mn0), p1 = expf(s[j][1] - mn0);
            const float p2 = expf(s[j][2] - mn1), p3 = expf(s[j][3] - mn1);
            sum0 += p0 + p1;
            sum1 += p2 + p3;
            pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
            pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
        }
        l0 = alpha0 * l0 + sum0;
        l1 = alpha1 * l1 + sum1;
        #pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            acc[i][0] *= alpha0;
            acc[i][1] *= alpha0;
            acc[i][2] *= alpha1;
            acc[i][3] *= alpha1;
        }

        // acc += p . v: 4 key steps of 16, D/8 column blocks of 8
        #pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            #pragma unroll
            for (int i = 0; i < D / 8; i += 2) {
                uint32_t b0, b1, b2, b3;
                const __nv_bfloat16* a = Vb
                    + (kk * 16 + (lane % 16)) * (D + PAD)
                    + (i + lane / 16) * 8;
                ldsm_x4_trans(b0, b1, b2, b3, a);
                mma_bf16(acc[i], pf[kk], b0, b1);
                mma_bf16(acc[i + 1], pf[kk], b2, b3);
            }
        }
        __syncthreads();       // this buffer is reloaded two tiles on
    }

    // the row sums: each of the 4 threads of a group holds a share
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
    #pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        const int col = i * 8 + t * 2;
        if (r0 < p.S)
            *reinterpret_cast<uint32_t*>(og + (int64_t)r0 * p.o_ss + col) =
                pack_bf16(acc[i][0] / d0, acc[i][1] / d0);
        if (r1 < p.S)
            *reinterpret_cast<uint32_t*>(og + (int64_t)r1 * p.o_ss + col) =
                pack_bf16(acc[i][2] / d1, acc[i][3] / d1);
    }
}

template <int D>
int launch(const Params& p, int B, cudaStream_t stream) {
    constexpr int smem = (BM + 4 * BN) * (D + PAD) * 2;   // 52 224 B at D=128
    cudaError_t err = cudaFuncSetAttribute(
        flash_k_attn_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((p.S + BM - 1) / BM, p.H, B);
    flash_k_attn_fwd<D><<<grid, WARPS * 32, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attn(
        const void* q, const void* k, const void* v, void* o,
        int64_t B, int64_t S, int64_t H, int64_t KV, int64_t D,
        int64_t q_sb, int64_t q_ss, int64_t q_sh,
        int64_t k_sb, int64_t k_ss, int64_t k_sh,
        int64_t v_sb, int64_t v_ss, int64_t v_sh,
        int64_t o_sb, int64_t o_ss, int64_t o_sh,
        int64_t causal, int64_t window, float sm_scale, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    Params p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.o = static_cast<__nv_bfloat16*>(o);
    p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
    p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
    p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
    p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
    p.S = (int)S; p.H = (int)H; p.KV = (int)KV;
    p.causal = (int)causal;
    p.window = (int)window;
    p.sm_scale = sm_scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 32) return launch<32>(p, (int)B, st);
    if (D == 64) return launch<64>(p, (int)B, st);
    if (D == 128) return launch<128>(p, (int)B, st);
    return (int)cudaErrorInvalidValue;
}
