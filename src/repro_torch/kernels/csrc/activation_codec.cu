// Activation codecs for Hopper (sm_90a): int8 and packed int4, quantise
// and dequantise.
//
// Replaces the TPU kernels of src/repro/kernels/activation_codec/kernel.py:
//   quantize_int8_pallas (_quant_kernel)       -> quantize_int8_kernel
//   dequantize_int8_pallas (_dequant_kernel)   -> dequantize_int8_kernel
//   quantize_int4_pallas (_quant4_kernel)      -> quantize_int4_kernel
//   dequantize_int4_pallas (_dequant4_kernel)  -> dequantize_int4_kernel
//
// int8, per (row, 128-column block) of a contiguous (R, D) array with
// D % 128 == 0:
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
// a handful of operations per element, so the design is one pass with no
// intermediate in device memory.  int8: one warp owns one 128-column block,
// each lane holds 4 consecutive elements (one 8- or 16-byte load), the
// abs-max goes through 5 warp shuffles, and each lane writes its 4 int8
// values with one 32-bit store.  int4: one warp owns one 256-column tile,
// each lane holds 4 elements of the low block and the 4 elements 128 columns
// on that pair with them, two abs-max reductions run side by side, and each
// lane writes its 4 packed bytes with one 32-bit store; lane 0 writes the
// two scales.  Blocks and tiles are independent, so the grid is flat over
// warps.  Compile without --use_fast_math: the payloads are held bit-equal
// to the plain PyTorch versions.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int4_kernel(const T* __restrict__ x, int8_t* __restrict__ packed,
                     float* __restrict__ scales, long long n_tiles) {
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_tiles) return;
    const int lane = threadIdx.x & 31;
    const long long off = w * 256 + lane * 4;
    float lo[4], hi[4];
    load4(x + off, lo);
    load4(x + off + 128, hi);
    float amax_lo = fmaxf(fmaxf(fabsf(lo[0]), fabsf(lo[1])),
                          fmaxf(fabsf(lo[2]), fabsf(lo[3])));
    float amax_hi = fmaxf(fmaxf(fabsf(hi[0]), fabsf(hi[1])),
                          fmaxf(fabsf(hi[2]), fabsf(hi[3])));
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
        amax_lo = fmaxf(amax_lo, __shfl_xor_sync(0xffffffffu, amax_lo, m));
        amax_hi = fmaxf(amax_hi, __shfl_xor_sync(0xffffffffu, amax_hi, m));
    }
    const float s_lo = amax_lo > 0.0f ? amax_lo * (1.0f / 7.0f) : 1.0f;
    const float s_hi = amax_hi > 0.0f ? amax_hi * (1.0f / 7.0f) : 1.0f;
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int q_lo = (int)fminf(fmaxf(rintf(lo[k] / s_lo), -7.0f), 7.0f) + 7;
        const int q_hi = (int)fminf(fmaxf(rintf(hi[k] / s_hi), -7.0f), 7.0f) + 7;
        const int byte = q_lo + 16 * q_hi - 128;             // [-128, 110]
        word |= (uint32_t)(uint8_t)(int8_t)byte << (8 * k);
    }
    *reinterpret_cast<uint32_t*>(packed + w * 128 + lane * 4) = word;
    if (lane == 0) {
        scales[2 * w] = s_lo;
        scales[2 * w + 1] = s_hi;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_int4_kernel(const int8_t* __restrict__ packed,
                       const float* __restrict__ scales, T* __restrict__ out,
                       long long n_tiles) {
    const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (w >= n_tiles) return;
    const int lane = threadIdx.x & 31;
    const char4 in = *reinterpret_cast<const char4*>(packed + w * 128 + lane * 4);
    const float s_lo = scales[2 * w];
    const float s_hi = scales[2 * w + 1];
    const int p[4] = {(int)in.x + 128, (int)in.y + 128, (int)in.z + 128,
                      (int)in.w + 128};                       // [0, 238]
    float lo[4], hi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        lo[k] = (float)(p[k] % 16 - 7) * s_lo;
        hi[k] = (float)(p[k] / 16 - 7) * s_hi;
    }
    const long long off = w * 256 + lane * 4;
    store4(out + off, lo);
    store4(out + off + 128, hi);
}

inline unsigned grid_for(long long n_blocks) {
    return (unsigned)((n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 = launched), or -1 for arguments the kernel does not take.
extern "C" int rt_quantize_int8(const void* x, void* q, void* scales,
                                long long n_blocks, int dtype, void* stream) {
    if (n_blocks <= 0 || n_blocks > 0x7fffffffLL * kWarpsPerBlock) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        quantize_int8_kernel<float><<<grid_for(n_blocks), kThreads, 0, st>>>(
            (const float*)x, (int8_t*)q, (float*)scales, n_blocks);
    } else if (dtype == 1) {
        quantize_int8_kernel<__nv_bfloat16><<<grid_for(n_blocks), kThreads, 0, st>>>(
            (const __nv_bfloat16*)x, (int8_t*)q, (float*)scales, n_blocks);
    } else {
        return -1;
    }
    return (int)cudaGetLastError();
}

extern "C" int rt_dequantize_int8(const void* q, const void* scales, void* out,
                                  long long n_blocks, int dtype, void* stream) {
    if (n_blocks <= 0 || n_blocks > 0x7fffffffLL * kWarpsPerBlock) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        dequantize_int8_kernel<float><<<grid_for(n_blocks), kThreads, 0, st>>>(
            (const int8_t*)q, (const float*)scales, (float*)out, n_blocks);
    } else if (dtype == 1) {
        dequantize_int8_kernel<__nv_bfloat16><<<grid_for(n_blocks), kThreads, 0, st>>>(
            (const int8_t*)q, (const float*)scales, (__nv_bfloat16*)out, n_blocks);
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
    if (dtype == 0) {
        quantize_int4_kernel<float><<<grid_for(n_tiles), kThreads, 0, st>>>(
            (const float*)x, (int8_t*)packed, (float*)scales, n_tiles);
    } else if (dtype == 1) {
        quantize_int4_kernel<__nv_bfloat16><<<grid_for(n_tiles), kThreads, 0, st>>>(
            (const __nv_bfloat16*)x, (int8_t*)packed, (float*)scales, n_tiles);
    } else {
        return -1;
    }
    return (int)cudaGetLastError();
}

extern "C" int rt_dequantize_int4(const void* packed, const void* scales,
                                  void* out, long long n_tiles, int dtype,
                                  void* stream) {
    if (n_tiles <= 0 || n_tiles > 0x7fffffffLL * kWarpsPerBlock) return -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0) {
        dequantize_int4_kernel<float><<<grid_for(n_tiles), kThreads, 0, st>>>(
            (const int8_t*)packed, (const float*)scales, (float*)out, n_tiles);
    } else if (dtype == 1) {
        dequantize_int4_kernel<__nv_bfloat16><<<grid_for(n_tiles), kThreads, 0, st>>>(
            (const int8_t*)packed, (const float*)scales, (__nv_bfloat16*)out, n_tiles);
    } else {
        return -1;
    }
    return (int)cudaGetLastError();
}
