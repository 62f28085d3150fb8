// Flash-decode for Hopper (sm_90a): one query token per head against a KV
// cache of live length kv_len, grouped-query heads by index.
//
// Replaces the TPU kernel decode_attention_pallas (_kernel) of
// src/repro/kernels/decode_attention/kernel.py.
//
// What it computes, as the TPU kernel does: s = (q . k) * D^-0.5 in float32,
// keys at index >= kv_len masked to -1e30, an online softmax with float32
// (m, l, acc), p = 0 where m <= -0.5e30, p rounded to v's type before the
// p . v product while l sums the unrounded p, l == 0 -> 1 at the end, the
// output in q's type.
//
// Bound: bytes.  A decode step reads the live K/V prefix once and does two
// multiply-adds per element read for each query head of the group, far
// below the card's ridge point (2 * 576 * 8 * 128 * 2 B = 2.36 MB at the
// served shape, 0.71 us at 3.35 TB/s).  So the design is about reading those
// bytes once and with enough blocks in flight, not about tensor cores:
//  * the cache is read where the model keeps it, through (batch, head, seq)
//    strides: the flat (B, S_max, KV*hd) cache is never transposed or copied;
//  * one block serves one (batch, kv head) and every query head of its group,
//    so each K/V row is read once per group, never repeated in memory;
//  * the KV axis is split across blocks (grid (B*KV, n_split)) because B*KV
//    alone is 8 blocks at batch 1.  Each block runs the TPU kernel's
//    sequential K axis as a loop over 32-key tiles staged in shared memory
//    (16-byte loads), with the carry (m, l, acc) in shared memory, and writes
//    its partial (m, l, acc) to float32 scratch; a second kernel combines the
//    partials by log-sum-exp;
//  * n_split follows from the buffer length T, never from kv_len, and a block
//    whose range starts at or past kv_len returns before it reads anything:
//    one launch configuration serves every position and dead cache is never
//    read, as scalar prefetch gives the TPU kernel;
//  * kv_len arrives as an int argument, or as a device int32 that both
//    kernels read (no host synchronisation), clamped to [0, T]; a ragged T
//    and a ragged tail of the live range are masked here.
// q . k and p . v are scalar float32 FMAs: a handful of query rows gives the
// tensor cores nothing to do.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int TK = 32;            // keys per tile: one score per lane
constexpr float NEG_INF = -1e30f;

struct Strides {                  // elements
    long long q_b, q_h, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// p as it enters the p . v product: rounded to v's type
__device__ __forceinline__ float round_like(float p, const float*) { return p; }
__device__ __forceinline__ float round_like(float p, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, w);
    return x;
}

__device__ __forceinline__ int live_len(int kv_len, const int* kv_len_dev,
                                        int T_len) {
    const int L = kv_len_dev != nullptr ? *kv_len_dev : kv_len;
    return min(max(L, 0), T_len);
}

template <typename T, int D>
size_t split_smem_bytes(int G) {
    return 2 * (size_t)TK * D * sizeof(T)
        + ((size_t)2 * G * D + (size_t)G * TK + 3 * (size_t)G) * sizeof(float);
}

// ---------------------------------------------------------------- pass 1
// grid (B*KV, n_split): block (b, kv head) reduces keys
// [split * chunk, min((split + 1) * chunk, kv_len)) for the G query heads of
// its group to a partial (m, l, acc).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int H, int KV, int T_len,
                    int kv_len, const int* __restrict__ kv_len_dev, int chunk,
                    int n_split, Strides st, float scale) {
    constexpr int E = 16 / sizeof(T);        // elements per 16-byte piece
    constexpr int LPR = D / E;               // lanes (pieces) per row
    constexpr int RPW = 32 / LPR;            // rows a warp scores at once
    static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "head dim");
    static_assert(TK == 32, "one score per lane in the softmax step");

    const int G = H / KV;
    const int bkv = blockIdx.x;
    const int b = bkv / KV;
    const int kvh = bkv - b * KV;
    const int split = blockIdx.y;
    const int L = live_len(kv_len, kv_len_dev, T_len);
    const int lo = split * chunk;
    if (lo >= L) return;                     // dead split: reads nothing
    const int hi = min(lo + chunk, L);

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* k_s = reinterpret_cast<T*>(smem_raw);
    T* v_s = k_s + TK * D;
    float* q_s = reinterpret_cast<float*>(v_s + TK * D);   // (G, D)
    float* p_s = q_s + G * D;                               // (G, TK)
    float* acc_s = p_s + G * TK;                            // (G, D)
    float* m_s = acc_s + G * D;
    float* l_s = m_s + G;
    float* a_s = l_s + G;                                   // alpha per row

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    for (int i = tid; i < G * D; i += kThreads) {
        const int g = i / D;
        const int d = i - g * D;
        q_s[i] = to_f(q[b * st.q_b + (kvh * G + g) * st.q_h + d]);
        acc_s[i] = 0.f;
    }
    for (int g = tid; g < G; g += kThreads) {
        m_s[g] = NEG_INF;
        l_s[g] = 0.f;
    }
    const T* k_base = k + b * st.k_b + kvh * st.k_h;
    const T* v_base = v + b * st.v_b + kvh * st.v_h;
    const int sub = lane / LPR;              // which row of the warp's RPW
    const int part = lane - sub * LPR;       // which 16-byte piece of it

    for (int t0 = lo; t0 < hi; t0 += TK) {
        const int n = min(TK, hi - t0);      // live keys in this tile
        __syncthreads();                     // previous tile consumed
        for (int idx = tid; idx < TK * LPR; idx += kThreads) {
            const int r = idx / LPR;
            const int c = (idx - r * LPR) * E;
            uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
            if (r < n) {
                kk = *reinterpret_cast<const uint4*>(
                    k_base + (long long)(t0 + r) * st.k_s + c);
                vv = *reinterpret_cast<const uint4*>(
                    v_base + (long long)(t0 + r) * st.v_s + c);
            }
            *reinterpret_cast<uint4*>(k_s + r * D + c) = kk;
            *reinterpret_cast<uint4*>(v_s + r * D + c) = vv;
        }
        __syncthreads();

        // ---- scores: LPR lanes per key row, a shuffle tree over them
        for (int r0 = warp * RPW; r0 < TK; r0 += kWarps * RPW) {
            const int r = r0 + sub;
            float kf[E];
#pragma unroll
            for (int e = 0; e < E; ++e) kf[e] = to_f(k_s[r * D + part * E + e]);
            for (int g = 0; g < G; ++g) {
                const float* qg = q_s + g * D + part * E;
                float s = 0.f;
#pragma unroll
                for (int e = 0; e < E; ++e) s = fmaf(qg[e], kf[e], s);
#pragma unroll
                for (int w = LPR / 2; w > 0; w >>= 1)
                    s += __shfl_xor_sync(0xffffffffu, s, w);
                if (part == 0) p_s[g * TK + r] = r < n ? s * scale : NEG_INF;
            }
        }
        __syncthreads();

        // ---- online softmax: one warp per query row, one key per lane
        for (int g = warp; g < G; g += kWarps) {
            const float x = p_s[g * TK + lane];
            const float m_old = m_s[g];
            const float l_old = l_s[g];
            const float m_new = fmaxf(m_old, warp_max(x));
            const float p = m_new <= 0.5f * NEG_INF ? 0.f : expf(x - m_new);
            const float alpha = expf(m_old - m_new);
            const float row_sum = warp_sum(p);
            __syncwarp();
            p_s[g * TK + lane] = round_like(p, k_s);
            if (lane == 0) {
                m_s[g] = m_new;
                l_s[g] = alpha * l_old + row_sum;
                a_s[g] = alpha;
            }
        }
        __syncthreads();

        // ---- acc = alpha * acc + p . v, one (row, column) per thread step
        for (int i = tid; i < G * D; i += kThreads) {
            const int g = i / D;
            const int d = i - g * D;
            const float* pg = p_s + g * TK;
            float a = acc_s[i] * a_s[g];
#pragma unroll 8
            for (int j = 0; j < TK; ++j)
                a = fmaf(pg[j], to_f(v_s[j * D + d]), a);
            acc_s[i] = a;
        }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
        const int g = i / D;
        const int d = i - g * D;
        const long long bh = (long long)b * H + kvh * G + g;
        part_acc[(bh * n_split + split) * D + d] = acc_s[i];
    }
    for (int g = tid; g < G; g += kThreads) {
        const long long bh = (long long)b * H + kvh * G + g;
        part_ml[(bh * n_split + split) * 2] = m_s[g];
        part_ml[(bh * n_split + split) * 2 + 1] = l_s[g];
    }
}

// ---------------------------------------------------------------- pass 2
// grid (B*H): the live splits' partials -> one output row, by log-sum-exp.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc, T* __restrict__ o,
                      int H, int T_len, int kv_len,
                      const int* __restrict__ kv_len_dev, int chunk,
                      int n_split, long long o_b, long long o_h) {
    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh - b * H;
    const int d = threadIdx.x;
    const int L = live_len(kv_len, kv_len_dev, T_len);
    const int n_live = min(n_split, (L + chunk - 1) / chunk);
    const float* ml = part_ml + (long long)bh * n_split * 2;
    const float* acc = part_acc + (long long)bh * n_split * D;
    float m = NEG_INF;
    for (int i = 0; i < n_live; ++i) m = fmaxf(m, ml[2 * i]);
    float l = 0.f, a = 0.f;
    for (int i = 0; i < n_live; ++i) {
        const float w = expf(ml[2 * i] - m);
        l = fmaf(w, ml[2 * i + 1], l);
        a = fmaf(w, acc[i * D + d], a);
    }
    if (l == 0.f) l = 1.f;
    store(o + b * o_b + h * o_h + d, a / l);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           float* part_ml, float* part_acc, int B, int H, int KV, int T_len,
           int kv_len, const int* kv_len_dev, int chunk, int n_split,
           const Strides& st, float scale, cudaStream_t stream) {
    const size_t smem = split_smem_bytes<T, D>(H / KV);
    if (smem > 227 * 1024) return -4;        // a group too large for one SM
    auto split_kern = decode_split_kernel<T, D>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            split_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((unsigned)(B * KV), (unsigned)n_split);
    split_kern<<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, part_ml, part_acc, H, KV,
        T_len, kv_len, kv_len_dev, chunk, n_split, st, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    decode_combine_kernel<T, D><<<(unsigned)(B * H), D, 0, stream>>>(
        part_ml, part_acc, (T*)o, H, T_len, kv_len, kv_len_dev, chunk,
        n_split, st.o_b, st.o_h);
    return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, D) through (batch, head) strides; k, v: (B, KV, T, D) through
// (batch, head, seq) strides; o: (B, H, D) through (batch, head) strides;
// innermost stride 1 everywhere, every K/V row on a 16-byte boundary.
// part_ml: (B*H, n_split, 2) and part_acc: (B*H, n_split, D) float32 scratch.
// kv_len_dev, when not null, points to a device int32 that replaces kv_len.
// chunk: keys per split, a multiple of 32, n_split == ceil(T / chunk).
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 = launched), or a negative code for arguments the kernel does not take.
extern "C" int rt_decode_attention(
        const void* q, const void* k, const void* v, void* o, void* part_ml,
        void* part_acc, int B, int H, int KV, int T_len, int D, int kv_len,
        const void* kv_len_dev, int chunk, int n_split,
        long long q_sb, long long q_sh, long long k_sb, long long k_sh,
        long long k_ss, long long v_sb, long long v_sh, long long v_ss,
        long long o_sb, long long o_sh, float scale, int dtype, void* stream) {
    if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || T_len <= 0) return -2;
    if (chunk <= 0 || chunk % TK != 0 || n_split != (T_len + chunk - 1) / chunk
            || n_split > 65535)
        return -3;
    if (dtype != 0 && dtype != 1) return -1;
    const Strides st = {q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                        o_sb, o_sh};
    const int* kl = (const int*)kv_len_dev;
    float* ml = (float*)part_ml;
    float* acc = (float*)part_acc;
    cudaStream_t cs = (cudaStream_t)stream;
    switch (D) {
#define RT_CASE(n)                                                            \
        case n:                                                               \
            return dtype == 0                                                 \
                ? launch<float, n>(q, k, v, o, ml, acc, B, H, KV, T_len,      \
                                   kv_len, kl, chunk, n_split, st, scale, cs) \
                : launch<__nv_bfloat16, n>(q, k, v, o, ml, acc, B, H, KV,     \
                                           T_len, kv_len, kl, chunk, n_split, \
                                           st, scale, cs);
        RT_CASE(16) RT_CASE(32) RT_CASE(64) RT_CASE(128)
#undef RT_CASE
        default: return -1;
    }
}
