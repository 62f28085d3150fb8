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
// Layout: one warp owns one int8 128-column block or one int4 256-column
// tile, and the grid is one warp per block or tile, 8 warps to a thread
// block (1 092 thread blocks for an int8 273 x 4096 array, more than the
// card holds at once; 546 for int4).  int8: lane l holds elements
// 4l .. 4l+3 of its block (one 8-byte load for bfloat16, one 16-byte load
// for float32) and writes its 4 int8 values with one 32-bit store; lane 0
// writes the block's scale.  int4: lane l holds those 4 elements of the
// low block and the 4 that lie 128 columns on (two such loads) and writes
// its 4 packed bytes with one 32-bit store; lane 0 writes the tile's two
// scales as one float2.  Dequantising, lane l reads the same
// 4 bytes and its block's scale (int4: the float2) and writes the same
// elements.  An int8 block of another width takes a second pair of kernels:
// one warp per block still, walking it in 128-column strides with the tail
// guarded, for the abs-max and then (from L1) for the rounding; vector
// loads and stores where the width is a multiple of 4.
// What the measurements on the H100 kept, against the first design (five
// shuffle levels for the abs-max, a division, rintf and F2I per element,
// I2F back, an ordinary launch):
//  - programmatic dependent launch (every kernel): the grid becomes
//    resident while the kernel ahead of it finishes, and waits on
//    griddepcontrol.wait before its first load, so nothing is read or
//    written early.  This hides most of the launch, the largest part of a
//    call at the served sizes;
//  - the abs-max of a block by one redux.sync over the float bits (|x| >= 0
//    orders as its bits) in place of five shuffle levels; the lane's own
//    part is a maximum of the bits too (for bfloat16 on bf16x2 pairs), so
//    that a NaN is the largest value and reaches the scale;
//  - no conversion instruction per element (F2I, I2F and FRND run at a
//    quarter of the FMA rate or less): rint by the 1.5 * 2^23 magic add,
//    whose bits also give the code (int4's nibble, int8's byte), and the
//    code's float back by an OR into the same constant's bits and one
//    subtraction;
//  - no division per element (below), and the division where an element
//    takes it inline, not an out-of-line call.
// Measured and not kept (int4): half a warp or a quarter per tile with
// 16-byte loads and stores, and several tiles' loads in flight per warp
// (slower at the served sizes, the grid then too thin to hide latency); a
// grid capped at the resident blocks, which binds at no served shape.

// Rounding without a division per element, bit-exact.  The quantum is
// Q = 7 (int4) or Q = 127 (int8).  Per block the lane computes r = RN(1/s)
// once, then per element y = RN(x * r) and takes rint(y), unless y lies
// within the codec's margin m of a half-integer; such an element (and
// every element of a block with s < FLT_MIN, where r may overflow, or with
// a NaN abs-max, below) takes clamp(rintf(__fdiv_rn(x, s)), -Q, Q) as
// before.  Why that is exact: |x| <= amax and s = RN(amax * RN(1/Q)), so
// q = x / s satisfies |q| <= Q (1 + 2^-22).  With s >= FLT_MIN, 1/s is a
// normal float, so r = (1/s)(1 + d1) and y = x r (1 + d2) with |d1|, |d2|
// <= 2^-24 (an underflowing y is off by at most 2^-150), hence
// |y - q| <= |q| (2^-23 + 2^-48); and the correctly rounded quotient fl(q)
// lies within half an ulp of q.
//  - int4, Q = 7: |y - q| < 2^-20, and half an ulp below 8 is at most
//    2^-22, so |fl(q) - y| < 2^-19: kTieMargin = 2^-18 holds it twice.
//  - int8, Q = 127: |q| < 128, so |y - q| < 2^7 (2^-23 + 2^-48) <= 2^-16,
//    and half an ulp in [64, 128) is 2^-18, so |fl(q) - y| < 2^-16 + 2^-18
//    < 2^-15.6: the margin has to be wider, and kTieMargin8 = 2^-15 holds
//    it.
// When y is more than m from every half-integer, fl(q) lies strictly
// inside the same interval (k - 1/2, k + 1/2) as y, and rint(fl(q)) =
// rint(y) = k, which lies in [-Q, Q] since |y| < Q + 1/2 (no clamp).  Ties
// and near-ties take the division; so does a NaN y.  Products and sums are
// written __fmul_rn / __fadd_rn, so none is fused.  On random bfloat16
// activations about 0.3 % (int4) and 0.5 % (int8) of the elements divide
// (their quotients are ratios of 8-bit numbers and land on half-integers
// more often), on float32 ones a few in a million (int4) or in a hundred
// thousand (int8).
//
// Non-finite inputs.  The plain version's cast of a NaN to an integer is
// undefined, so only finite inputs are held bit-equal; what the kernels
// give is this:
//  - a block that holds a NaN has a NaN abs-max and so the scale 1.0, as
//    the plain version's where(amax > 0, ..., 1) gives.  Every element of
//    it divides (no bound holds for x / 1): the others get the plain
//    version's values (+-Inf: +-Q), and a NaN gets -Q;
//  - a block that holds +-Inf and no NaN has the scale Inf, as the plain
//    version's.  Its finite elements give 0 (x * RN(1/Inf) = 0), as the
//    plain version's x / Inf does; +-Inf gives -Q (Inf * 0 is NaN, which
//    divides: Inf / Inf is NaN again).
// For int4 the nibble is that value + 7.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

constexpr float kTieMargin = 0x1p-18f;    // int4's margin: see the header
constexpr float kTieMargin8 = 0x1p-15f;   // int8's margin: see the header
// 1.5 * 2^23: for |y| < 2^22, RN(y + kMagic) = kMagic + rint(y) (ties to
// even), and its bits are kMagicBits + rint(y).  So rint, its integer and
// the float back run on the FMA and integer pipes, with no conversion
// instruction (F2I, I2F and FRND run at a quarter of the FMA rate or less
// on this card).  kMagicBits' low 22 bits are 0, so the low byte of
// kMagicBits + k is k in two's complement for |k| <= 127.
constexpr float kMagic = 12582912.0f;
constexpr uint32_t kMagicBits = 0x4B400000u;

// The two codecs' codes: q = clamp(rint(x / s), -kQ, kQ), kept as the low
// bits kMask of q + kBias: int4's nibble q + 7, int8's byte q in two's
// complement.
struct Int4Code {
    static constexpr float kQ = 7.0f, kMargin = kTieMargin;
    static constexpr int kBias = 7;
    static constexpr uint32_t kMask = 15u;
};

struct Int8Code {
    static constexpr float kQ = 127.0f, kMargin = kTieMargin8;
    static constexpr int kBias = 0;
    static constexpr uint32_t kMask = 255u;
};

// Programmatic dependent launch: the grid may be resident before the kernel
// ahead of it in the stream has ended, but reads and writes nothing before
// that kernel's writes are visible; and the kernel after it may be
// scheduled as soon as this one runs.
__device__ __forceinline__ void wait_for_the_kernel_ahead() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;" :::);
}

// Four consecutive elements of one block, as a lane holds them: one 8-byte
// load for bfloat16 (kept two to a register; their abs-max runs on bf16x2
// pairs, exact since a maximum is one of its inputs) and one 16-byte load
// for float32.
template <typename T> struct Quad;

template <> struct Quad<__nv_bfloat16> {
    uint32_t w[2];

    __device__ __forceinline__ void load(const __nv_bfloat16* p) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = a.x; w[1] = a.y;
    }
    // elements c0 .. c0 + 3 of a block of `width`, zeros past its end
    __device__ __forceinline__ void load_any(const __nv_bfloat16* p, int c0,
                                             int width) {
        if (width % 4 == 0) {
            load(p + c0);
            return;
        }
        uint32_t h[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            h[k] = c0 + k < width ? __bfloat16_as_ushort(p[c0 + k]) : 0u;
        w[0] = h[0] | h[1] << 16; w[1] = h[2] | h[3] << 16;
    }
    __device__ __forceinline__ float at(int k) const {
        return __uint_as_float(k % 2 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16);
    }
    // the float bits of max |x| over the 4, a NaN the largest
    __device__ __forceinline__ uint32_t amax_bits() const {
        const __nv_bfloat162 m = __hmax2_nan(__habs2(b2(w[0])), __habs2(b2(w[1])));
        const uint32_t u = *reinterpret_cast<const uint32_t*>(&m);
        return max(u << 16, u & 0xffff0000u);
    }
    __device__ __forceinline__ static __nv_bfloat162 b2(uint32_t u) {
        return *reinterpret_cast<const __nv_bfloat162*>(&u);
    }
};

template <> struct Quad<float> {
    float v[4];

    __device__ __forceinline__ void load(const float* p) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    }
    __device__ __forceinline__ void load_any(const float* p, int c0,
                                             int width) {
        if (width % 4 == 0) {
            load(p + c0);
            return;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
            v[k] = c0 + k < width ? p[c0 + k] : 0.0f;
    }
    __device__ __forceinline__ float at(int k) const { return v[k]; }
    __device__ __forceinline__ uint32_t amax_bits() const {
        uint32_t m = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            m = max(m, __float_as_uint(v[k]) & 0x7fffffffu);
        return m;
    }
};

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// The maximum over the warp of the bits of m >= 0, as a float: a
// non-negative float orders as its bits, so one integer reduction
// (redux.sync) replaces five shuffles.
__device__ __forceinline__ float warp_max(uint32_t m) {
    return __uint_as_float(__reduce_max_sync(0xffffffffu, m));
}

// A block's scale from its abs-max a, as the plain version forms it, and
// whether every element of the block takes the division: where
// s < FLT_MIN (RN(1/s) may overflow) and where a is NaN (s = 1, and no
// bound holds for x / s).
template <typename C>
struct BlockScale {
    float s;
    bool divide_all;

    __device__ __forceinline__ explicit BlockScale(float a)
        : s(a > 0.0f ? a * (1.0f / C::kQ) : 1.0f),
          divide_all(s < FLT_MIN || a != a) {}
};

// The code of clamp(rint(x / s), -kQ, kQ) with the IEEE quotient.  Inline:
// as an out-of-line call it cost the int8 and int4 quantise kernels
// 0.1-0.3 us more a call at the served shapes on the H100.
template <typename C>
__device__ __forceinline__ uint32_t code_by_division(float x, float s) {
    return (uint32_t)((int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -C::kQ), C::kQ)
                      + C::kBias) & C::kMask;
}

// The codes of the lane's 4 elements of one block (x = get(k)), for both
// codecs.  y = RN(x r) with r = RN(1/s), t = RN(y + kMagic + kBias), whose
// bits are kMagicBits + kBias + rint(y), and d = y - (t - kMagic - kBias) =
// y - rint(y) (both exact).  |d| >= 1/2 - kMargin means y lies within the
// margin of a half-integer (or is NaN), and the element divides; otherwise
// the code is bits(t) & kMask, since rint(y) lies in [-kQ, kQ] (the
// header's bound) and needs no clamp.  The divisions sit behind one branch,
// which about a quarter of the int8 warps and half the int4 ones take on
// random bfloat16 activations.
template <typename C, typename Get>
__device__ __forceinline__ void codes(Get get, const BlockScale<C>& b,
                                      uint32_t (&q)[4]) {
    constexpr float kShift = kMagic + (float)C::kBias;
    constexpr float kNear = 0.5f - C::kMargin;
    const float r = __frcp_rn(b.s);
    bool any = b.divide_all;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float y = __fmul_rn(get(k), r);
        const float t = __fadd_rn(y, kShift);
        q[k] = __float_as_uint(t) & C::kMask;
        any |= !(fabsf(__fsub_rn(y, __fsub_rn(t, kShift))) < kNear);
    }
    if (any) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float y = __fmul_rn(get(k), r);
            const float d = __fsub_rn(y, __fsub_rn(__fadd_rn(y, kShift),
                                                   kShift));
            if (b.divide_all || !(fabsf(d) < kNear))
                q[k] = code_by_division<C>(get(k), b.s);
        }
    }
}

// The value of the code n = q + bias in the low bits kMask of `bits`
// (int4's nibble, q + 7; int8's byte with its top bit flipped, q + 128) as
// a float, exact: the float with bits kMagicBits | n is kMagic + n, and
// minus kMagic + bias that is q.  (No I2F: see kMagic.)
template <uint32_t kMask, int kBias>
__device__ __forceinline__ float code_value(uint32_t bits) {
    return __fsub_rn(__uint_as_float(kMagicBits | (bits & kMask)),
                     kMagic + (float)kBias);
}

__device__ __forceinline__ uint32_t pack4(const uint32_t (&c)[4]) {
    return c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24;
}

// ------------------------------------------------------------------ int8
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, long long n_blocks) {
    wait_for_the_kernel_ahead();
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_blocks) return;                    // whole warps leave together
    const int lane = threadIdx.x & 31;
    Quad<T> v;
    v.load(x + w * 128 + lane * 4);
    const BlockScale<Int8Code> b(warp_max(v.amax_bits()));
    uint32_t c[4];
    codes([&](int k) { return v.at(k); }, b, c);
    *reinterpret_cast<uint32_t*>(q + w * 128 + lane * 4) = pack4(c);
    if (lane == 0) scales[w] = b.s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_int8_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scales, T* __restrict__ out,
                       long long n_blocks) {
    wait_for_the_kernel_ahead();
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_blocks) return;
    const int lane = threadIdx.x & 31;
    // bytes 4l .. 4l+3 of the block, each + 128 (in [0, 255])
    const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(
                           q + w * 128) + lane) ^ 0x80808080u;
    const float s = __ldg(scales + w);
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        v[k] = __fmul_rn(code_value<255u, 128>(u >> (8 * k)), s);
    store4(out + w * 128 + lane * 4, v);
}

// A block of any other width: the warp walks it in 128-column strides,
// every lane reaching the reduction after its walk (a lane past the
// block's end holds zeros, so the full mask stays valid).
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int8_any_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scales, long long n_blocks,
                         int width) {
    wait_for_the_kernel_ahead();
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_blocks) return;
    const int lane = threadIdx.x & 31;
    const T* xb = x + w * width;
    int8_t* qb = q + w * width;
    uint32_t m = 0u;
    for (int c0 = lane * 4; c0 < width; c0 += 128) {
        Quad<T> v;
        v.load_any(xb, c0, width);
        m = max(m, v.amax_bits());
    }
    const BlockScale<Int8Code> b(warp_max(m));
    for (int c0 = lane * 4; c0 < width; c0 += 128) {
        Quad<T> v;
        v.load_any(xb, c0, width);
        uint32_t c[4];
        codes([&](int k) { return v.at(k); }, b, c);
        if (width % 4 == 0) {
            *reinterpret_cast<uint32_t*>(qb + c0) = pack4(c);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (c0 + k < width) qb[c0 + k] = (int8_t)(uint8_t)c[k];
        }
    }
    if (lane == 0) scales[w] = b.s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_int8_any_kernel(const int8_t* __restrict__ q,
                           const float* __restrict__ scales,
                           T* __restrict__ out, long long n_blocks,
                           int width) {
    wait_for_the_kernel_ahead();
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_blocks) return;
    const int lane = threadIdx.x & 31;
    const int8_t* qb = q + w * width;
    T* ob = out + w * width;
    const float s = __ldg(scales + w);
    for (int c0 = lane * 4; c0 < width; c0 += 128) {
        if (width % 4 == 0) {
            const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(
                                   qb + c0)) ^ 0x80808080u;
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
                v[k] = __fmul_rn(code_value<255u, 128>(u >> (8 * k)), s);
            store4(ob + c0, v);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (c0 + k < width)
                    store1(ob + c0 + k, __fmul_rn(code_value<255u, 128>(
                        (uint8_t)qb[c0 + k] ^ 0x80u), s));
        }
    }
}

// ------------------------------------------------------------ packed int4
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int4_kernel(const T* __restrict__ x, int8_t* __restrict__ packed,
                     float* __restrict__ scales, long long n_tiles) {
    wait_for_the_kernel_ahead();
    const long long t = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (t >= n_tiles) return;                     // whole warps leave together
    const int lane = threadIdx.x & 31;
    Quad<T> lo, hi;
    lo.load(x + t * 256 + lane * 4);
    hi.load(x + t * 256 + 128 + lane * 4);
    const BlockScale<Int4Code> s_lo(warp_max(lo.amax_bits()));
    const BlockScale<Int4Code> s_hi(warp_max(hi.amax_bits()));
    uint32_t q_lo[4], q_hi[4];
    codes([&](int k) { return lo.at(k); }, s_lo, q_lo);
    codes([&](int k) { return hi.at(k); }, s_hi, q_hi);
    uint32_t word = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        word |= (q_lo[k] | q_hi[k] << 4) << (8 * k);
    *reinterpret_cast<uint32_t*>(packed + t * 128 + lane * 4) =
        word ^ 0x80808080u;                       // q_lo + 16 q_hi - 128
    if (lane == 0)
        *reinterpret_cast<float2*>(scales + 2 * t) = make_float2(s_lo.s,
                                                                 s_hi.s);
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
        lo[k] = __fmul_rn(code_value<15u, 7>(w >> (8 * k)), s.x);
        hi[k] = __fmul_rn(code_value<15u, 7>(w >> (8 * k + 4)), s.y);
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
int launch_quantize_int8(const void* x, void* q, void* scales,
                         long long n_blocks, int block, cudaStream_t st) {
    const unsigned grid = grid_for(n_blocks);
    if (block == 128)
        return (int)launch_dependent(quantize_int8_kernel<T>, grid, st,
                                     (const T*)x, (int8_t*)q, (float*)scales,
                                     n_blocks);
    return (int)launch_dependent(quantize_int8_any_kernel<T>, grid, st,
                                 (const T*)x, (int8_t*)q, (float*)scales,
                                 n_blocks, block);
}

template <typename T>
int launch_dequantize_int8(const void* q, const void* scales, void* out,
                           long long n_blocks, int block, cudaStream_t st) {
    const unsigned grid = grid_for(n_blocks);
    if (block == 128)
        return (int)launch_dependent(dequantize_int8_kernel<T>, grid, st,
                                     (const int8_t*)q, (const float*)scales,
                                     (T*)out, n_blocks);
    return (int)launch_dependent(dequantize_int8_any_kernel<T>, grid, st,
                                 (const int8_t*)q, (const float*)scales,
                                 (T*)out, n_blocks, block);
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
    if (dtype == 0)
        return launch_quantize_int8<float>(x, q, scales, n_blocks, block, st);
    if (dtype == 1)
        return launch_quantize_int8<__nv_bfloat16>(x, q, scales, n_blocks,
                                                   block, st);
    return -1;
}

extern "C" int rt_dequantize_int8(const void* q, const void* scales, void* out,
                                  long long n_blocks, int block, int dtype,
                                  void* stream) {
    if (n_blocks <= 0 || n_blocks > 0x7fffffffLL * kWarpsPerBlock) return -1;
    if (block <= 0) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_dequantize_int8<float>(q, scales, out, n_blocks, block,
                                             st);
    if (dtype == 1)
        return launch_dequantize_int8<__nv_bfloat16>(q, scales, out,
                                                     n_blocks, block, st);
    return -1;
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
