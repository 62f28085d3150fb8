// int8 activation codec for Hopper (sm_90a): quantise and dequantise.
//
// Replaces the TPU kernels quantize_int8_pallas (_quant_kernel) and
// dequantize_int8_pallas (_dequant_kernel) of
// src/repro/kernels/activation_codec/kernel.py.
//
// What it computes, per (row, 128-column block) of a contiguous (R, D)
// array with D % 128 == 0:
//   amax  = max |x|
//   scale = amax > 0 ? amax * (1/127) : 1           (float32)
//   q     = clamp(rint(x / scale), -127, 127)       (IEEE division, half-even)
// and back: out = float(q) * scale, rounded once to the output type.
//
// Bound: bytes.  Each element is read once and written once and there are
// a handful of operations per element, so the design is one pass with no
// intermediate in device memory: one warp owns one 128-column block, each
// lane holds 4 consecutive elements (one 8- or 16-byte load), the abs-max
// goes through 5 warp shuffles, and each lane writes its 4 int8 values with
// one 32-bit store.  Blocks are independent, so the grid is flat over
// R * D/128 warps.  Compile without --use_fast_math: the payload is held
// bit-equal to the plain PyTorch version.
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
