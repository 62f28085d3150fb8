// Activation codecs for Hopper (sm_90a): int8 and packed int4, quantise
// and dequantise.
//
// Replaces the TPU kernels of src/repro/kernels/activation_codec/kernel.py:
//   quantize_int8_pallas (_quant_kernel)       -> quantize_int8_kernel
//   dequantize_int8_pallas (_dequant_kernel)   -> dequantize_int8_kernel
//   quantize_int4_pallas (_quant4_kernel)      -> quantize_int4_kernel
//   dequantize_int4_pallas (_dequant4_kernel)  -> dequantize_int4_kernel
//
// int8, per (row, block) of a contiguous (R, D) array with D % block == 0
// (block 128 wherever D allows it; the JAX package's rule makes the block
// the whole row otherwise, e.g. at the reduced d_model = 64):
//   amax  = max |x|
//   scale = amax > 0 ? amax * (1/127) : 1           (float32)
//   q     = clamp(rint(x / scale), -127, 127)       (IEEE division, half-even)
// and back: out = float(q) * scale, rounded once to the output type.
//
// packed int4, per (row, 256-column tile) with D % 256 == 0: the tile is two
// 128-blocks lo = x[0:128], hi = x[128:256], each with its own
//   scale = amax > 0 ? amax * (1/7) : 1
//   q     = clamp(rint(x / scale), -7, 7) + 7       in [0, 14]
// and byte j of the tile's 128 packed bytes is q_lo[j] + 16 * q_hi[j] - 128,
// in [-128, 110].  Element j pairs with element j + 128, not with its
// neighbour: that layout is the wire format of the JAX package.  Back:
// p + 128 >= 0, so lo = p % 16 - 7 and hi = p / 16 - 7 are exact, each times
// its block's scale, rounded once to the output type.
//
// Bound: bytes.  Each element is read once and written once and there are
// a handful of operations per element, so every kernel is one pass with no
// intermediate in device memory.  At the served sizes (a few megabytes,
// already in L2 behind the layer that wrote it) a call lasts about as long
// as the card takes to start and drain a grid, so what a design can still
// win is latency: bytes in flight early, and a short chain of dependent
// instructions after them.  Compile without --use_fast_math: the payloads
// are held bit-equal to the plain PyTorch versions.
//
// int8: one warp owns one 128-column block, each lane holds 4 consecutive
// elements (one 8- or 16-byte load), the abs-max goes through 5 warp
// shuffles, and each lane writes its 4 int8 values with one 32-bit store.
// A block of another width takes a second kernel: one warp per block still,
// walking it in 128-column strides with the tail guarded, for the abs-max
// and then (from L1) for the rounding; vector loads and stores where the
// width is a multiple of 4.  The grid is flat over warps.
//
// int4 (redesigned for Hopper): one warp owns one 256-column tile, and the
// grid is one warp per tile (546 blocks of 8 warps at CogACT-7B's 273 x
// 4096, under the blocks the card holds at once).  Lane l holds elements
// 4l .. 4l+3 of the low block and the 4 elements 128 columns on that pair
// with them (two 8-byte loads for bfloat16, two 16-byte ones for float32),
// and writes its 4 packed bytes with one 32-bit store; lane 0 writes the
// tile's two scales as one float2.  Dequantising, lane l reads the same 4
// bytes and the float2 of scales, and writes 4 low and 4 high values.
// What the measurements on the H100 kept, against the first design's
// warp-per-tile kernels:
//  - programmatic dependent launch (both kernels): the grid becomes
//    resident while the kernel ahead of it finishes, and waits on
//    griddepcontrol.wait before its first load, so nothing is read or
//    written early.  This hides most of the launch, the largest part of a
//    call at the served sizes;
//  - the abs-max of a block by one redux.sync over the float bits (|x| >= 0
//    orders as its bits) in place of five shuffle levels, and for bfloat16
//    the lane's part of it on bf16x2 pairs;
//  - no conversion instruction per element (F2I, I2F and FRND run at a
//    quarter of the FMA rate or less): rint by the 1.5 * 2^23 magic add,
//    whose bits also give the nibble, and the nibble's float back by an
//    OR into the same constant's bits and one subtraction;
//  - no division per element (below).
// Measured and not kept: half a warp or a quarter per tile with 16-byte
// loads and stores, and several tiles' loads in flight per warp (slower at
// the served sizes, the grid then too thin to hide latency); a grid capped
// at the resident blocks, which binds at no served shape.

// Rounding without a division per element, bit-exact.  Per block the lane
// computes r = RN(1/s) once, then per element y = RN(x * r) and takes
// rint(y), unless y lies within kTieMargin = 2^-18 of a half-integer; such
// an element (and every element of a block with s < FLT_MIN, where r may
// overflow) takes rintf(__fdiv_rn(x, s)) as before.  Why that is exact:
// |x| <= amax and s = RN(amax * RN(1/7)), so Q = x / s satisfies
// |Q| <= 7 (1 + 2^-22).  With s >= FLT_MIN, 1/s is a normal float, so
// r = (1/s)(1 + d1) and y = x r (1 + d2) with |d1|, |d2| <= 2^-24 (an
// underflowing y is off by at most 2^-150), hence
// |y - Q| <= |Q| (2^-23 + 2^-48) < 2^-20; and the correctly rounded
// quotient fl(Q) lies within half an ulp of Q, at most 2^-22 below 8.  So
// |fl(Q) - y| < 2^-19, half the margin: when y is more than 2^-18 from
// every half-integer, fl(Q) lies strictly inside the same interval
// (k - 1/2, k + 1/2) as y, and rint(fl(Q)) = rint(y) = k, which lies in
// [-7, 7] since |y| < 7.5 (no clamp).  Ties and near-ties take the
// division; so does a NaN y, so NaN and Inf inputs give what the division
// gives.  Products and sums are written __fmul_rn / __fadd_rn, so none is
// fused.  On random bfloat16 activations about 0.3 % of the elements
// divide (their quotients are ratios of 8-bit numbers and land on
// half-integers more often), on float32 ones a few in a million.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
    const __nv_bfloat162 a = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                                __float2bfloat16_rn(v[1]));
    const __nv_bfloat162 b = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                                __float2bfloat16_rn(v[3]));
    uint2 t;
    t.x = *reinterpret_cast<const uint32_t*>(&a);
    t.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, long long n_blocks) {
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_blocks) return;                    // whole warps leave together
    const int lane = threadIdx.x & 31;
    const long long off = w * 128 + lane * 4;
    float v[4];
    load4(x + off, v);
    float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                       fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
    const float scale = amax > 0.0f ? amax * (1.0f / 127.0f) : 1.0f;
    char4 out;
    out.x = (signed char)fminf(fmaxf(rintf(v[0] / scale), -127.0f), 127.0f);
    out.y = (signed char)fminf(fmaxf(rintf(v[1] / scale), -127.0f), 127.0f);
    out.z = (signed char)fminf(fmaxf(rintf(v[2] / scale), -127.0f), 127.0f);
    out.w = (signed char)fminf(fmaxf(rintf(v[3] / scale), -127.0f), 127.0f);
    *reinterpret_cast<char4*>(q + off) = out;
    if (lane == 0) scales[w] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_int8_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scales, T* __restrict__ out,
                       long long n_blocks) {
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_blocks) return;
    const int lane = threadIdx.x & 31;
    const long long off = w * 128 + lane * 4;
    const char4 in = *reinterpret_cast<const char4*>(q + off);
    const float scale = scales[w];
    float v[4];
    v[0] = (float)in.x * scale;
    v[1] = (float)in.y * scale;
    v[2] = (float)in.z * scale;
    v[3] = (float)in.w * scale;
    store4(out + off, v);
}

// Elements c0 .. c0 + 3 of a block of `width`, zeros past its end; one
// vector load where the block's width is a multiple of 4.
template <typename T>
__device__ __forceinline__ void load4_any(const T* p, int c0, int width,
                                          float (&v)[4]) {
    if (width % 4 == 0) {
        load4(p + c0, v);
        return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
        v[k] = c0 + k < width ? to_f(p[c0 + k]) : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int8_any_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scales, long long n_blocks,
                         int width) {
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_blocks) return;
    const int lane = threadIdx.x & 31;
    const T* xb = x + w * width;
    int8_t* qb = q + w * width;
    float amax = 0.0f;
    for (int c0 = lane * 4; c0 < width; c0 += 128) {
        float v[4];
        load4_any(xb, c0, width, v);
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                                 fmaxf(fabsf(v[2]), fabsf(v[3]))));
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
    const float scale = amax > 0.0f ? amax * (1.0f / 127.0f) : 1.0f;
    for (int c0 = lane * 4; c0 < width; c0 += 128) {
        float v[4];
        load4_any(xb, c0, width, v);
        signed char o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            o[k] = (signed char)fminf(fmaxf(rintf(v[k] / scale), -127.0f),
                                      127.0f);
        if (width % 4 == 0) {
            *reinterpret_cast<char4*>(qb + c0) = make_char4(o[0], o[1], o[2],
                                                            o[3]);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (c0 + k < width) qb[c0 + k] = o[k];
        }
    }
    if (lane == 0) scales[w] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_int8_any_kernel(const int8_t* __restrict__ q,
                           const float* __restrict__ scales,
                           T* __restrict__ out, long long n_blocks,
                           int width) {
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_blocks) return;
    const int lane = threadIdx.x & 31;
    const int8_t* qb = q + w * width;
    T* ob = out + w * width;
    const float scale = scales[w];
    for (int c0 = lane * 4; c0 < width; c0 += 128) {
        float v[4];
        if (width % 4 == 0) {
            const char4 in = *reinterpret_cast<const char4*>(qb + c0);
            v[0] = (float)in.x * scale;
            v[1] = (float)in.y * scale;
            v[2] = (float)in.z * scale;
            v[3] = (float)in.w * scale;
            store4(ob + c0, v);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (c0 + k < width) store1(ob + c0 + k, (float)qb[c0 + k] * scale);
        }
    }
}

// ------------------------------------------------------------ packed int4
constexpr float kTieMargin = 0x1p-18f;    // see the header
// 1.5 * 2^23: for |y| < 2^22, RN(y + kMagic) = kMagic + rint(y) (ties to
// even), and its bits are kMagicBits + rint(y).  So rint, its integer and
// the float back run on the FMA and integer pipes, with no conversion
// instruction (F2I, I2F and FRND run at a quarter of the FMA rate or less
// on this card).
constexpr float kMagic = 12582912.0f;
constexpr uint32_t kMagicBits = 0x4B400000u;

// Programmatic dependent launch: the grid may be resident before the kernel
// ahead of it in the stream has ended, but reads and writes nothing before
// that kernel's writes are visible; and the kernel after it may be
// scheduled as soon as this one runs.
__device__ __forceinline__ void wait_for_the_kernel_ahead() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;" :::);
}

// One lane's share of a tile: the 4 elements 4l .. 4l+3 of the low block
// and the 4 that pair with them in the high block, one 8-byte load each
// for bfloat16 (kept two to a register; their abs-max runs on bf16x2
// pairs, exact since a maximum is one of its inputs) and one 16-byte load
// each for float32.
template <typename T> struct Slice;

template <> struct Slice<__nv_bfloat16> {
    uint32_t lo[2], hi[2];

    __device__ __forceinline__ void load(const __nv_bfloat16* p) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(p + 128));
        lo[0] = a.x; lo[1] = a.y; hi[0] = b.x; hi[1] = b.y;
    }
    __device__ __forceinline__ static float at(const uint32_t (&w)[2], int k) {
        return __uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
    }
    __device__ __forceinline__ float lo_at(int k) const { return at(lo, k); }
    __device__ __forceinline__ float hi_at(int k) const { return at(hi, k); }
    // (abs-max of the lane's low elements, of its high elements)
    __device__ __forceinline__ float2 amax() const {
        const __nv_bfloat162 ml = __hmax2(__habs2(b2(lo[0])), __habs2(b2(lo[1])));
        const __nv_bfloat162 mh = __hmax2(__habs2(b2(hi[0])), __habs2(b2(hi[1])));
        const __nv_bfloat162 m = __hmax2(__lows2bfloat162(ml, mh),
                                         __highs2bfloat162(ml, mh));
        const uint32_t w = *reinterpret_cast<const uint32_t*>(&m);
        return make_float2(__uint_as_float(w << 16),
                           __uint_as_float(w & 0xffff0000u));
    }
    __device__ __forceinline__ static __nv_bfloat162 b2(uint32_t w) {
        return *reinterpret_cast<const __nv_bfloat162*>(&w);
    }
};

template <> struct Slice<float> {
    float lo[4], hi[4];

    __device__ __forceinline__ void load(const float* p) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p + 128));
        lo[0] = a.x; lo[1] = a.y; lo[2] = a.z; lo[3] = a.w;
        hi[0] = b.x; hi[1] = b.y; hi[2] = b.z; hi[3] = b.w;
    }
    __device__ __forceinline__ float lo_at(int k) const { return lo[k]; }
    __device__ __forceinline__ float hi_at(int k) const { return hi[k]; }
    __device__ __forceinline__ float2 amax() const {
        return make_float2(
            fmaxf(fmaxf(fabsf(lo[0]), fabsf(lo[1])), fmaxf(fabsf(lo[2]), fabsf(lo[3]))),
            fmaxf(fmaxf(fabsf(hi[0]), fabsf(hi[1])), fmaxf(fabsf(hi[2]), fabsf(hi[3]))));
    }
};

// The maximum over the warp of m >= 0: a non-negative float orders as its
// bits, so one integer reduction (redux.sync) replaces five shuffles.
__device__ __forceinline__ float warp_max(float m) {
    return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(m)));
}

// clamp(rint(x / s), -7, 7) + 7 with the IEEE quotient; out of line, so
// that the common path carries none of the division's code.
__device__ __noinline__ uint32_t nibble_by_division(float x, float s) {
    return (uint32_t)((int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -7.0f), 7.0f)
                      + 7);
}

// The nibbles rint(x / s) + 7 of the lane's 4 elements of one block
// (x = get(k)).  y = RN(x r) with r = RN(1/s), t = RN(y + kMagic + 7),
// whose bits are kMagicBits + 7 + rint(y), and d = y - (t - kMagic - 7) =
// y - rint(y) (both exact).  |d| >= 1/2 - kTieMargin means y lies within
// the margin of a half-integer (or is NaN), and the element divides;
// otherwise the nibble is bits(t) & 15, since rint(y) lies in [-7, 7]
// (the header's bound) and needs no clamp.  The divisions sit behind one
// branch.
template <typename Get>
__device__ __forceinline__ void nibbles(Get get, float s, uint32_t (&q)[4]) {
    constexpr float kMagic7 = kMagic + 7.0f;
    const bool all = s < FLT_MIN;             // 1/s may overflow: divide all
    const float r = __frcp_rn(s);
    bool any = all;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float y = __fmul_rn(get(k), r);
        const float t = __fadd_rn(y, kMagic7);
        q[k] = __float_as_uint(t) & 15u;
        any |= !(fabsf(__fsub_rn(y, __fsub_rn(t, kMagic7))) <
                 0.5f - kTieMargin);
    }
    if (any) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float y = __fmul_rn(get(k), r);
            const float d = __fsub_rn(y, __fsub_rn(__fadd_rn(y, kMagic7),
                                                   kMagic7));
            if (all || !(fabsf(d) < 0.5f - kTieMargin))
                q[k] = nibble_by_division(get(k), s);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int4_kernel(const T* __restrict__ x, int8_t* __restrict__ packed,
                     float* __restrict__ scales, long long n_tiles) {
    wait_for_the_kernel_ahead();
    const long long t = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (t >= n_tiles) return;                     // whole warps leave together
    const int lane = threadIdx.x & 31;
    Slice<T> v;
    v.load(x + t * 256 + lane * 4);
    const float2 m = v.amax();
    const float a_lo = warp_max(m.x), a_hi = warp_max(m.y);
    const float s_lo = a_lo > 0.0f ? a_lo * (1.0f / 7.0f) : 1.0f;
    const float s_hi = a_hi > 0.0f ? a_hi * (1.0f / 7.0f) : 1.0f;
    uint32_t q_lo[4], q_hi[4];
    nibbles([&](int k) { return v.lo_at(k); }, s_lo, q_lo);
    nibbles([&](int k) { return v.hi_at(k); }, s_hi, q_hi);
    uint32_t word = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        word |= (q_lo[k] | q_hi[k] << 4) << (8 * k);
    *reinterpret_cast<uint32_t*>(packed + t * 128 + lane * 4) =
        word ^ 0x80808080u;                       // q_lo + 16 q_hi - 128
    if (lane == 0)
        *reinterpret_cast<float2*>(scales + 2 * t) = make_float2(s_lo, s_hi);
}

// float(n - 7) for the low 4 bits n of `bits`, exact: the float with bits
// kMagicBits | n is kMagic + n.  (No I2F: see kMagic.)
__device__ __forceinline__ float nibble_value(uint32_t bits) {
    return __fsub_rn(__uint_as_float(kMagicBits | (bits & 15u)),
                     kMagic + 7.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_int4_kernel(const int8_t* __restrict__ packed,
                       const float* __restrict__ scales, T* __restrict__ out,
                       long long n_tiles) {
    wait_for_the_kernel_ahead();
    const long long t = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (t >= n_tiles) return;
    const int lane = threadIdx.x & 31;
    // bytes 4l .. 4l+3 of the tile, each + 128 (in [0, 255])
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(
                           packed + t * 128) + lane) ^ 0x80808080u;
    const float2 s = __ldg(reinterpret_cast<const float2*>(scales) + t);
    float lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        lo[k] = __fmul_rn(nibble_value(w >> (8 * k)), s.x);
        hi[k] = __fmul_rn(nibble_value(w >> (8 * k + 4)), s.y);
    }
    store4(out + t * 256 + lane * 4, lo);
    store4(out + t * 256 + 128 + lane * 4, hi);
}

inline unsigned grid_for(long long n_blocks) {
    return (unsigned)((n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// Launch `kern` with programmatic stream serialisation (the kernel waits in
// wait_for_the_kernel_ahead before touching memory).
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kern)(Params...), unsigned grid,
                             cudaStream_t st, Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename T>
int launch_quantize_int4(const void* x, void* packed, void* scales,
                         long long n_tiles, cudaStream_t st) {
    return (int)launch_dependent(quantize_int4_kernel<T>, grid_for(n_tiles),
                                 st, (const T*)x, (int8_t*)packed,
                                 (float*)scales, n_tiles);
}

template <typename T>
int launch_dequantize_int4(const void* packed, const void* scales, void* out,
                           long long n_tiles, cudaStream_t st) {
    return (int)launch_dependent(dequantize_int4_kernel<T>, grid_for(n_tiles),
                                 st, (const int8_t*)packed,
                                 (const float*)scales, (T*)out, n_tiles);
}

}  // namespace

// n_blocks blocks of `block` columns each (n_blocks * block = R * D); a
// block of 128 takes the kernel built for it, any other width the general
// one.  dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 = launched), or -1 for arguments the kernel does not take.
extern "C" int rt_quantize_int8(const void* x, void* q, void* scales,
                                long long n_blocks, int block, int dtype,
                                void* stream) {
    if (n_blocks <= 0 || n_blocks > 0x7fffffffLL * kWarpsPerBlock) return -1;
    if (block <= 0) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned grid = grid_for(n_blocks);
    if (dtype == 0 && block == 128) {
        quantize_int8_kernel<float><<<grid, kThreads, 0, st>>>(
            (const float*)x, (int8_t*)q, (float*)scales, n_blocks);
    } else if (dtype == 1 && block == 128) {
        quantize_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
            (const __nv_bfloat16*)x, (int8_t*)q, (float*)scales, n_blocks);
    } else if (dtype == 0) {
        quantize_int8_any_kernel<float><<<grid, kThreads, 0, st>>>(
            (const float*)x, (int8_t*)q, (float*)scales, n_blocks, block);
    } else if (dtype == 1) {
        quantize_int8_any_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
            (const __nv_bfloat16*)x, (int8_t*)q, (float*)scales, n_blocks,
            block);
    } else {
        return -1;
    }
    return (int)cudaGetLastError();
}

extern "C" int rt_dequantize_int8(const void* q, const void* scales, void* out,
                                  long long n_blocks, int block, int dtype,
                                  void* stream) {
    if (n_blocks <= 0 || n_blocks > 0x7fffffffLL * kWarpsPerBlock) return -1;
    if (block <= 0) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned grid = grid_for(n_blocks);
    if (dtype == 0 && block == 128) {
        dequantize_int8_kernel<float><<<grid, kThreads, 0, st>>>(
            (const int8_t*)q, (const float*)scales, (float*)out, n_blocks);
    } else if (dtype == 1 && block == 128) {
        dequantize_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
            (const int8_t*)q, (const float*)scales, (__nv_bfloat16*)out, n_blocks);
    } else if (dtype == 0) {
        dequantize_int8_any_kernel<float><<<grid, kThreads, 0, st>>>(
            (const int8_t*)q, (const float*)scales, (float*)out, n_blocks,
            block);
    } else if (dtype == 1) {
        dequantize_int8_any_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
            (const int8_t*)q, (const float*)scales, (__nv_bfloat16*)out,
            n_blocks, block);
    } else {
        return -1;
    }
    return (int)cudaGetLastError();
}

// One tile is 256 columns of one row: n_tiles = R * D / 256.
extern "C" int rt_quantize_int4(const void* x, void* packed, void* scales,
                                long long n_tiles, int dtype, void* stream) {
    if (n_tiles <= 0 || n_tiles > 0x7fffffffLL * kWarpsPerBlock) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_quantize_int4<float>(x, packed, scales, n_tiles, st);
    if (dtype == 1)
        return launch_quantize_int4<__nv_bfloat16>(x, packed, scales,
                                                   n_tiles, st);
    return -1;
}

extern "C" int rt_dequantize_int4(const void* packed, const void* scales,
                                  void* out, long long n_tiles, int dtype,
                                  void* stream) {
    if (n_tiles <= 0 || n_tiles > 0x7fffffffLL * kWarpsPerBlock) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_dequantize_int4<float>(packed, scales, out, n_tiles, st);
    if (dtype == 1)
        return launch_dequantize_int4<__nv_bfloat16>(packed, scales, out,
                                                     n_tiles, st);
    return -1;
}
