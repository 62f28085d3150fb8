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
// served shape, 0.71 us at 3.35 TB/s; 33.5 MB and 10 us at 8192
// positions).  So the design is about keeping enough bytes in flight and
// paying one launch, not about tensor throughput:
//  * the cache is read where the model keeps it, through (batch, head, seq)
//    strides: the flat (B, S_max, KV*hd) cache is never transposed or copied;
//  * one block serves one (batch, kv head) and every query head of its group,
//    so each K/V row is read once per group, never repeated in memory;
//  * grid (B*KV, n_split): the KV axis is split across blocks because B*KV
//    alone is 8 blocks at batch 1.  n_split follows from the buffer length
//    T, never from kv_len, and a block whose range starts at or past kv_len
//    returns before it reads anything: one launch configuration serves every
//    position and dead cache is never read, as scalar prefetch gives the TPU
//    kernel;
//  * ONE launch per call: the splits merge on chip.  Each live split writes
//    its (m, l, acc) to a per-card scratch and takes a ticket (an atomic
//    counter per (batch, kv head)); the last live split to arrive merges all
//    partials by log-sum-exp in split order (so the result does not depend
//    on which block came last: two calls are bit-equal) and puts the ticket
//    back to 0, so the next call and a replayed CUDA graph start clean.  A
//    call with one live split writes its output directly.  A cluster with a
//    merge through distributed shared memory was not taken: a portable
//    cluster holds 8 blocks, which at batch 1 (8 pairs) leaves half of the
//    132 SMs idle.  The scratch is read with ld.global.cg (L2, never a stale
//    L1 line of an earlier call);
//  * kv_len arrives as an int argument, or as a device int32 that the kernel
//    reads (no host synchronisation), clamped to [0, T]; a ragged T and a
//    ragged tail of the live range are masked here.
//
// Two kernels, by input type:
//  * bfloat16 (the served type): K/V stream through a ring of STAGES = 3
//    stages of 64 keys in shared memory, filled by 16-byte cp.async with one
//    commit group per stage: while tile i is scored, tiles i+1 and i+2 are
//    in flight (106 KB of shared memory per block at D = 128, 81 KB at 96:
//    two blocks per SM at every head dim).  The only
//    block-wide barrier in the loop is the stage hand-off.  Warps own keys,
//    not phases: warp w takes keys 16w..16w+15 of every tile, scores them
//    for all G query rows of the group (padded to one m16 tile, so any G up
//    to 16 costs the same) and keeps its own (m, l, acc) and its q fragments
//    in registers.  Both products are mma.sync.m16n8k16 (bf16 in, float32
//    accumulate) fed by ldmatrix, the softmax runs on the accumulators in
//    exp2 with scale * log2(e) folded into one multiply, and the four warps
//    merge once, at the end, through shared memory.
//  * float32 (not on a served path; the float32 checks use it): the first
//    design's loop over 32-key tiles with scalar FMAs and the carry in shared
//    memory, ending in the same one-launch merge.
#include "common.cuh"

namespace {

constexpr int MAX_SMEM = 227 * 1024;

struct Strides {                  // elements
    long long q_b, q_h, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h;
};

// part: (B*H, n_split, D + 2) float32, acc then (m, l), per (row, split);
// ticket: (B*KV) counters, 0 between calls
struct Scratch {
    float* part;
    unsigned* ticket;
};

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

// An empty live range has no softmax: split 0 writes zeros (l == 0 -> 1).
template <typename T, int D, int THREADS>
__device__ __forceinline__ void write_zeros(T* o, const Strides& st, int b,
                                            int kvh, int G) {
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
        const int g = i / D;
        store(o + b * st.o_b + (kvh * G + g) * st.o_h + (i - g * D), 0.f);
    }
}

// The end of every live block: the (m, l, acc) of its G rows, in shared
// memory, become the output (one live split) or a partial plus a ticket; the
// last live split of its (batch, kv head) merges every partial in split
// order and resets the ticket.  LOG2: m is in log2 units (exp2 softmax).
template <typename T, int D, bool LOG2, int THREADS>
__device__ __forceinline__ void finish_split(
        const float* __restrict__ m_s, const float* __restrict__ l_s,
        const float* __restrict__ acc_s, T* __restrict__ o, const Strides& st,
        const Scratch& sc, int b, int kvh, int H, int G, int KV, int split,
        int n_split, int n_live) {
    const int tid = threadIdx.x;
    if (n_live == 1) {
        for (int i = tid; i < G * D; i += THREADS) {
            const int g = i / D;
            float l = l_s[g];
            if (l == 0.f) l = 1.f;
            store(o + b * st.o_b + (kvh * G + g) * st.o_h + (i - g * D),
                  acc_s[i] / l);
        }
        return;
    }
    constexpr int W = D + 2;
    const long long row0 = (long long)b * H + (long long)kvh * G;
    for (int i = tid; i < G * D; i += THREADS) {
        const int g = i / D;
        __stcg(sc.part + ((row0 + g) * n_split + split) * W + (i - g * D),
               acc_s[i]);
    }
    for (int g = tid; g < G; g += THREADS) {
        float* p = sc.part + ((row0 + g) * n_split + split) * W + D;
        __stcg(p, m_s[g]);
        __stcg(p + 1, l_s[g]);
    }
    __threadfence();                       // the partial before the ticket
    __syncthreads();
    __shared__ int is_last;
    if (tid == 0) {
        unsigned* t = sc.ticket + ((long long)b * KV + kvh);
        const unsigned n = atomicAdd(t, 1u);
        is_last = n == (unsigned)(n_live - 1);
        if (is_last) *t = 0u;              // every live split has arrived
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();                       // the others' partials after it
    // warp w merges rows w, w + warps, ...: the lanes take the splits 32 at
    // a time for the row's (m, l), then hand each split's weight round by
    // shuffle while each lane sums its columns, splits in order; the loads
    // of successive splits are independent, so UNROLL splits' are in
    // flight together
    constexpr int DPL = (D + 31) / 32;     // columns per lane
    constexpr int UNROLL = LOG2 ? 8 : 4;   // float32: 8 would spill
    const int warp = tid >> 5;
    const int lane = tid & 31;
    for (int g = warp; g < G; g += THREADS / 32) {
        const float* p = sc.part + (row0 + g) * n_split * W;
        float m = NEG_INF;
        for (int s = lane; s < n_live; s += 32)
            m = fmaxf(m, __ldcg(p + s * W + D));
        m = warp_max(m);
        float l = 0.f, a[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) a[c] = 0.f;
        for (int s0 = 0; s0 < n_live; s0 += 32) {
            const int s = s0 + lane;
            float w = 0.f;
            if (s < n_live) {
                const float ms = __ldcg(p + s * W + D);
                w = LOG2 ? exp2f(ms - m) : expf(ms - m);
                l = fmaf(w, __ldcg(p + s * W + D + 1), l);
            }
            const int n = min(32, n_live - s0);
#pragma unroll UNROLL
            for (int j = 0; j < n; ++j) {
                const float wj = __shfl_sync(0xffffffffu, w, j);
                const float* ps = p + (s0 + j) * W;
#pragma unroll
                for (int c = 0; c < DPL; ++c)
                    if (lane + 32 * c < D)
                        a[c] = fmaf(wj, __ldcg(ps + lane + 32 * c), a[c]);
            }
        }
        l = warp_sum(l);
        if (l == 0.f) l = 1.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c)
            if (lane + 32 * c < D)
                store(o + b * st.o_b + (kvh * G + g) * st.o_h + lane + 32 * c,
                      a[c] / l);
    }
}

// ============================================================ bfloat16, mma
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 128;    // 4 warps, 16 keys of every tile each
constexpr int kWarps = kThreads / 32;
constexpr int TK = 64;           // keys per stage
constexpr int STAGES = 3;        // ring depth: two tiles in flight
constexpr int GMAX = 16;         // query rows of a group: one m16 tile
constexpr int PAD = 8;           // 16 bytes: ldmatrix rows free of conflicts

template <int D>
constexpr size_t smem_bytes() {
    return (size_t)(GMAX + 2 * STAGES * TK) * (D + PAD) * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             Scratch sc, int H, int KV, int T_len, int kv_len,
                             const int* __restrict__ kv_len_dev, int chunk,
                             int n_split, Strides st, float scale_log2) {
    constexpr int LD = D + PAD;
    constexpr int KS = D / 16;       // k-steps of q k^T = column pairs of p v
    constexpr int OT = D / 8;        // 8-column output tiles
    constexpr int PIECES = D / 8;    // 16-byte pieces per row
    constexpr int STAGE = 2 * TK * LD;

    const int G = H / KV;
    const int bkv = blockIdx.x;
    const int b = bkv / KV;
    const int kvh = bkv - b * KV;
    const int split = blockIdx.y;
    const int L = live_len(kv_len, kv_len_dev, T_len);
    if (L == 0) {
        if (split == 0) write_zeros<bf16, D, kThreads>(o, st, b, kvh, G);
        return;
    }
    const int lo = split * chunk;
    if (lo >= L) return;                     // dead split: reads nothing
    const int hi = min(lo + chunk, L);
    const int n_live = min(n_split, (L + chunk - 1) / chunk);
    const int n_tiles = (hi - lo + TK - 1) / TK;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* q_s = reinterpret_cast<bf16*>(smem_raw);        // (GMAX, LD)
    bf16* ring = q_s + GMAX * LD;                          // STAGES x (K, V)

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;         // row of the fragment this lane holds
    const int tg = lane & 3;         // column pair within the fragment
    const int mi = lane >> 3;        // ldmatrix: which 8x8 matrix this lane
    const int mr = lane & 7;         //           addresses, and which row

    const bf16* k_base = k + b * st.k_b + kvh * st.k_h;
    const bf16* v_base = v + b * st.v_b + kvh * st.v_h;

    // q rows of the group, zero rows up to 16; in the first commit group
    for (int i = tid; i < GMAX * PIECES; i += kThreads) {
        const int r = i / PIECES;
        const int c = (i - r * PIECES) * 8;
        bf16* dst = q_s + r * LD + c;
        if (r < G)
            cp_async16((uint32_t)__cvta_generic_to_shared(dst),
                       q + b * st.q_b + (kvh * G + r) * st.q_h + c);
        else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    // tile i of this split into its stage; keys at or past hi are never
    // read: their rows become zeros.  Every thread copies the same column
    // piece of rows pr, pr + RSTEP, ... of every tile, so its addresses step
    // by constants.  Where the pieces of a row do not divide the threads
    // (D = 96: 12 pieces, so 10 rows of 120 threads a pass), the last
    // threads idle and the last pass stops at row TK.
    constexpr int RSTEP = kThreads / PIECES;
    constexpr int PASSES = (TK + RSTEP - 1) / RSTEP;
    constexpr bool RAGGED = RSTEP * PIECES != kThreads || TK % RSTEP != 0;
    static_assert(D % 8 == 0 && PIECES <= kThreads, "tile shape");
    const bool copier = !RAGGED || tid < RSTEP * PIECES;
    const int pr = tid / PIECES;
    const int pc = (tid % PIECES) * 8;
    const bf16* k_src = k_base + (long long)pr * st.k_s + pc;
    const bf16* v_src = v_base + (long long)pr * st.v_s + pc;
    auto issue = [&](int i) {
        if (!copier) return;
        bf16* k_s = ring + (i % STAGES) * STAGE;
        bf16* v_s = k_s + TK * LD;
        const int t0 = lo + i * TK;
        const bf16* ks = k_src + (long long)t0 * st.k_s;
        const bf16* vs = v_src + (long long)t0 * st.v_s;
        const uint32_t kd =
            (uint32_t)__cvta_generic_to_shared(k_s + pr * LD + pc);
        const uint32_t vd =
            (uint32_t)__cvta_generic_to_shared(v_s + pr * LD + pc);
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
            if (RAGGED && pr + p * RSTEP >= TK) break;
            if (t0 + pr + p * RSTEP < hi) {
                cp_async16(kd + p * RSTEP * LD * (int)sizeof(bf16),
                           ks + (long long)p * RSTEP * st.k_s);
                cp_async16(vd + p * RSTEP * LD * (int)sizeof(bf16),
                           vs + (long long)p * RSTEP * st.v_s);
            } else {
                *reinterpret_cast<uint4*>(k_s + (pr + p * RSTEP) * LD + pc) =
                    make_uint4(0u, 0u, 0u, 0u);
                *reinterpret_cast<uint4*>(v_s + (pr + p * RSTEP) * LD + pc) =
                    make_uint4(0u, 0u, 0u, 0u);
            }
        }
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < n_tiles) issue(i);
        cp_async_commit();
    }

    uint32_t qf[KS][4];
    float o_acc[OT][4];
#pragma unroll
    for (int t = 0; t < OT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_acc[t][e] = 0.f;
    float m_i[2] = {NEG_INF, NEG_INF};   // rows g and g + 8, log2 units
    float l_i[2] = {0.f, 0.f};           // this lane's share of the row sum

    for (int it = 0; it < n_tiles; ++it) {
        cp_async_wait<STAGES - 2>();     // tile it has landed (this thread's)
        __syncthreads();                 // ... everyone's; tile it-1 consumed
        if (it == 0) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
                ldmatrix_x4(qf[ks], q_s + ((mi & 1) * 8 + mr) * LD + ks * 16
                                        + (mi >> 1) * 8);
        }
        if (it + STAGES - 1 < n_tiles) issue(it + STAGES - 1);
        cp_async_commit();               // empty past the end: counts align

        const bf16* k_s = ring + (it % STAGES) * STAGE;
        const bf16* v_s = k_s + TK * LD;
        const int key0 = lo + it * TK + warp * 16;

        // ---- scores of this warp's 16 keys: s[0] keys 0-7, s[1] keys 8-15
        float s[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            // matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15),
            //          (keys 8-15, d 0-7), (keys 8-15, d 8-15)
            uint32_t kb[4];
            ldmatrix_x4(kb, k_s + (warp * 16 + (mi >> 1) * 8 + mr) * LD
                                + ks * 16 + (mi & 1) * 8);
            mma_bf16(s[0], qf[ks], kb[0], kb[1]);
            mma_bf16(s[1], qf[ks], kb[2], kb[3]);
        }

        // ---- mask and online softmax on the accumulators: s[t][0..1] belong
        // to row g, s[t][2..3] to row g + 8, keys key0 + 8t + 2tg + {0, 1}
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float m_cur = NEG_INF;
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float x = s[t][half * 2 + e] * scale_log2;
                    if (key0 + t * 8 + 2 * tg + e >= hi) x = NEG_INF;
                    s[t][half * 2 + e] = x;
                    m_cur = fmaxf(m_cur, x);
                }
            m_cur = quad_max(m_cur);
            const float m_new = fmaxf(m_i[half], m_cur);
            const bool dead = m_new <= 0.5f * NEG_INF;      // no valid key yet
            float row_sum = 0.f;
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float p =
                        dead ? 0.f : fast_exp2(s[t][half * 2 + e] - m_new);
                    row_sum += p;
                    s[t][half * 2 + e] = p;
                }
            const float alpha = fast_exp2(m_i[half] - m_new);
            l_i[half] = alpha * l_i[half] + row_sum;
            m_i[half] = m_new;
#pragma unroll
            for (int t = 0; t < OT; ++t) {
                o_acc[t][half * 2] *= alpha;
                o_acc[t][half * 2 + 1] *= alpha;
            }
        }

        // ---- o (16 x D) += p v: the warp's 16 keys, rounded to bf16, are
        // exactly the A fragment of one k-step
        uint32_t pa[4];
        pa[0] = pack_bf16(s[0][0], s[0][1]);
        pa[1] = pack_bf16(s[0][2], s[0][3]);
        pa[2] = pack_bf16(s[1][0], s[1][1]);
        pa[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
            // transposed: matrices (keys 0-7, d 0-7), (keys 8-15, d 0-7),
            //                      (keys 0-7, d 8-15), (keys 8-15, d 8-15)
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, v_s + (warp * 16 + (mi & 1) * 8 + mr) * LD
                                      + dp * 16 + (mi >> 1) * 8);
            mma_bf16(o_acc[2 * dp], pa, vb[0], vb[1]);
            mma_bf16(o_acc[2 * dp + 1], pa, vb[2], vb[3]);
        }
    }

    // ---- the four warps merge once: their (m, l, acc) through shared
    // memory (the ring is free now), then the block's through finish_split
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(ring);       // (kWarps, GMAX, D)
    float* red_m = red + kWarps * GMAX * D;            // (kWarps, GMAX)
    float* red_l = red_m + kWarps * GMAX;              // (kWarps, GMAX)
    float* fin_acc = red_l + kWarps * GMAX;            // (G, D)
    float* fin_m = fin_acc + GMAX * D;                 // (G)
    float* fin_l = fin_m + GMAX;                       // (G)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = g + half * 8;
        const float l = quad_sum(l_i[half]);
        if (row >= G) continue;              // padding rows of the m16 tile
        if (tg == 0) {
            red_m[warp * GMAX + row] = m_i[half];
            red_l[warp * GMAX + row] = l;
        }
        float* dst = red + (warp * GMAX + row) * D;
#pragma unroll
        for (int t = 0; t < OT; ++t) {
            dst[t * 8 + 2 * tg] = o_acc[t][half * 2];
            dst[t * 8 + 2 * tg + 1] = o_acc[t][half * 2 + 1];
        }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
        const int r = i / D;
        float m = NEG_INF;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_m[w * GMAX + r]);
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
            a = fmaf(fast_exp2(red_m[w * GMAX + r] - m),
                     red[(w * GMAX + r) * D + (i - r * D)], a);
        fin_acc[i] = a;
    }
    for (int r = tid; r < G; r += kThreads) {
        float m = NEG_INF;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_m[w * GMAX + r]);
        float l = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
            l = fmaf(fast_exp2(red_m[w * GMAX + r] - m), red_l[w * GMAX + r],
                     l);
        fin_m[r] = m;
        fin_l[r] = l;
    }
    __syncthreads();
    finish_split<bf16, D, true, kThreads>(fin_m, fin_l, fin_acc, o, st, sc, b,
                                          kvh, H, G, KV, split, n_split,
                                          n_live);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Scratch& sc, int B, int H, int KV, int T_len, int kv_len,
           const int* kv_len_dev, int chunk, int n_split, const Strides& st,
           float scale, cudaStream_t stream) {
    static_assert((size_t)(kWarps + 1) * GMAX * (D + 2) * sizeof(float)
                      <= 2 * STAGES * TK * (D + PAD) * sizeof(bf16),
                  "the warps' merge fits in the ring");
    if (H / KV > GMAX) return -4;            // a group past one m16 tile
    auto kern = decode_attention_bf16_kernel<D>;
    static int set[32] = {};
    const int e = allow_smem(kern, smem_bytes<D>(), set);
    if (e != 0) return e;
    dim3 grid((unsigned)(B * KV), (unsigned)n_split);
    kern<<<grid, kThreads, smem_bytes<D>(), stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, sc, H, KV,
        T_len, kv_len, kv_len_dev, chunk, n_split, st, scale * LOG2E);
    return (int)cudaGetLastError();
}

}  // namespace tc

// ========================================================= float32, scalar
namespace fp32 {

constexpr int kThreads = 128;     // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int TK = 32;            // keys per tile: one score per lane

template <int D>
size_t smem_bytes(int G) {
    return 2 * (size_t)TK * D * sizeof(float)
        + ((size_t)2 * G * D + (size_t)G * TK + 3 * (size_t)G) * sizeof(float);
}

// grid (B*KV, n_split): block (b, kv head) reduces keys
// [split * chunk, min((split + 1) * chunk, kv_len)) for the G query heads of
// its group, 32-key tiles with the carry in shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            Scratch sc, int H, int KV, int T_len, int kv_len,
                            const int* __restrict__ kv_len_dev, int chunk,
                            int n_split, Strides st, float scale) {
    typedef float T;
    constexpr int E = 16 / sizeof(T);        // elements per 16-byte piece
    constexpr int LPR = D / E;               // 16-byte pieces per row
    // lanes per row: the pieces rounded up to a power of two (D = 96: 24
    // pieces on 32 lanes, the last 8 adding zeros to the row's sum)
    constexpr int LANES = LPR <= 4 ? 4 : LPR <= 8 ? 8 : LPR <= 16 ? 16 : 32;
    constexpr int RPW = 32 / LANES;          // rows a warp scores at once
    static_assert(D % E == 0 && LPR <= 32, "head dim");

    const int G = H / KV;
    const int bkv = blockIdx.x;
    const int b = bkv / KV;
    const int kvh = bkv - b * KV;
    const int split = blockIdx.y;
    const int L = live_len(kv_len, kv_len_dev, T_len);
    if (L == 0) {
        if (split == 0) write_zeros<T, D, kThreads>(o, st, b, kvh, G);
        return;
    }
    const int lo = split * chunk;
    if (lo >= L) return;                     // dead split: reads nothing
    const int hi = min(lo + chunk, L);
    const int n_live = min(n_split, (L + chunk - 1) / chunk);

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
        q_s[i] = q[b * st.q_b + (kvh * G + g) * st.q_h + d];
        acc_s[i] = 0.f;
    }
    for (int g = tid; g < G; g += kThreads) {
        m_s[g] = NEG_INF;
        l_s[g] = 0.f;
    }
    const T* k_base = k + b * st.k_b + kvh * st.k_h;
    const T* v_base = v + b * st.v_b + kvh * st.v_h;
    const int sub = lane / LANES;            // which row of the warp's RPW
    const int part = lane - sub * LANES;     // which 16-byte piece of it
    const bool live = part < LPR;            // lanes past the row's pieces

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
            for (int e = 0; e < E; ++e)
                kf[e] = live ? k_s[r * D + part * E + e] : 0.f;
            for (int g = 0; g < G; ++g) {
                const float* qg = q_s + g * D + (live ? part * E : 0);
                float s = 0.f;
#pragma unroll
                for (int e = 0; e < E; ++e) s = fmaf(qg[e], kf[e], s);
                if (!live) s = 0.f;
#pragma unroll
                for (int w = LANES / 2; w > 0; w >>= 1)
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
            p_s[g * TK + lane] = p;           // float32: p . v takes p as is
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
                a = fmaf(pg[j], v_s[j * D + d], a);
            acc_s[i] = a;
        }
    }
    __syncthreads();
    finish_split<T, D, false, kThreads>(m_s, l_s, acc_s, o, st, sc, b, kvh, H,
                                        G, KV, split, n_split, n_live);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Scratch& sc, int B, int H, int KV, int T_len, int kv_len,
           const int* kv_len_dev, int chunk, int n_split, const Strides& st,
           float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>(H / KV);
    if (smem > (size_t)MAX_SMEM) return -4;  // a group too large for one SM
    auto kern = decode_attention_f32_kernel<D>;
    static int set[32] = {};
    const int e = allow_smem(kern, smem, set);
    if (e != 0) return e;
    dim3 grid((unsigned)(B * KV), (unsigned)n_split);
    kern<<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, sc, H,
        KV, T_len, kv_len, kv_len_dev, chunk, n_split, st, scale);
    return (int)cudaGetLastError();
}

}  // namespace fp32

}  // namespace

// q: (B, H, D) through (batch, head) strides; k, v: (B, KV, T, D) through
// (batch, head, seq) strides; o: (B, H, D) through (batch, head) strides;
// innermost stride 1 everywhere, every row on a 16-byte boundary.
// part: float32 scratch of at least B*H*n_split*(D+2) values, ticket: at
// least B*KV unsigned counters, all 0 before the first call; the kernel
// leaves them 0.  Calls that share a scratch run one after another (one
// stream).  kv_len_dev, when not null, points to a device int32 that
// replaces kv_len.  chunk: keys per split, a multiple of 64,
// n_split == ceil(T / chunk).  dtype: 0 = float32, 1 = bfloat16.  Returns the
// launch's cudaError_t (0 = launched), or a negative code for arguments the
// kernel does not take.
extern "C" int rt_decode_attention(
        const void* q, const void* k, const void* v, void* o, void* part,
        void* ticket, int B, int H, int KV, int T_len, int D, int kv_len,
        const void* kv_len_dev, int chunk, int n_split,
        long long q_sb, long long q_sh, long long k_sb, long long k_sh,
        long long k_ss, long long v_sb, long long v_sh, long long v_ss,
        long long o_sb, long long o_sh, float scale, int dtype, void* stream) {
    if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || T_len <= 0) return -2;
    if (chunk <= 0 || chunk % tc::TK != 0
            || n_split != (T_len + chunk - 1) / chunk || n_split > 65535)
        return -3;
    if (dtype != 0 && dtype != 1) return -1;
    const Strides st = {q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                        o_sb, o_sh};
    const Scratch sc = {(float*)part, (unsigned*)ticket};
    const int* kl = (const int*)kv_len_dev;
    cudaStream_t cs = (cudaStream_t)stream;
    switch (D) {
#define RT_CASE(n)                                                            \
        case n:                                                               \
            return dtype == 0                                                 \
                ? fp32::launch<n>(q, k, v, o, sc, B, H, KV, T_len, kv_len,    \
                                  kl, chunk, n_split, st, scale, cs)          \
                : tc::launch<n>(q, k, v, o, sc, B, H, KV, T_len, kv_len, kl,  \
                                chunk, n_split, st, scale, cs);
        RT_CASE(16) RT_CASE(32) RT_CASE(64) RT_CASE(96) RT_CASE(128)
#undef RT_CASE
        default: return -1;
    }
}
