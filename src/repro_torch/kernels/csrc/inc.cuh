// Device arithmetic shared by the INC kernels: the switch's saturating
// add with sticky sentinels, and fixed-point quantize with sentinel
// saturation. Both match kernels/ref.py element for element.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define INC_SENT_POS 2147483647          // +overflow sentinel, 2**31 - 1
#define INC_SENT_NEG (-2147483647)       // -overflow sentinel, -(2**31 - 1)
#define INC_SAT_MAX 2147483646LL         // largest non-sentinel magnitude

__device__ __forceinline__ bool inc_is_sentinel(int32_t q) {
    return q == INC_SENT_POS || q == INC_SENT_NEG;
}

// _sat_add_block of the reference: a's sentinel wins, then b's, then the
// wrapped sum's overflow reconstruction. The add runs in uint32, since
// signed overflow is undefined in C++; a sum of exactly -2**31 is kept.
// Written as selects: early returns compiled to branches (four a call),
// which serialised a fold of many adds (sat_add_batch) on the card.
__device__ __forceinline__ int32_t inc_sat_add(int32_t a, int32_t b) {
    int32_t s = (int32_t)((uint32_t)a + (uint32_t)b);
    int32_t r = (a > 0 && b > 0 && s < a) ? INC_SENT_POS : s;
    r = (a < 0 && b < 0 && s > a) ? INC_SENT_NEG : r;
    r = inc_is_sentinel(b) ? b : r;
    return inc_is_sentinel(a) ? a : r;
}

// round-half-even(x * scale) in fp32. The thresholds compare in fp32,
// where SAT_MAX rounds to 2**31: y >= 2**31 is the +sentinel (2**31 itself
// through the saturating convert), y < -2**31 the -sentinel, and
// y == -2**31 stores -2147483648. __float2int_rn turns NaN into 0.
__device__ __forceinline__ int32_t inc_quantize(float x, float scale) {
    float y = rintf(__fmul_rn(x, scale));
    if (y >= 2147483648.0f) return INC_SENT_POS;
    if (y < -2147483648.0f) return INC_SENT_NEG;
    return __float2int_rn(y);
}

inline int inc_blocks(int64_t n, int threads) {
    int64_t b = (n + threads - 1) / threads;
    return (int)(b < 1 ? 1 : (b > 8192 ? 8192 : b));
}
