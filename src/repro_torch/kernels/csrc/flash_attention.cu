// Blocked online-softmax attention for Hopper (sm_90a): prefill, causal or
// not, grouped-query heads by index.
//
// Replaces the TPU kernel flash_attention_pallas (_kernel) of
// src/repro/kernels/flash_attention/kernel.py.
//
// What it computes: out = softmax(q k^T * scale [+ causal mask]) v, with the
// running (m, l, acc) of the online softmax in float32, p = 0 for a row that
// has seen no valid key (m <= -0.5e30), l == 0 -> 1 at the end, and p rounded
// to v's type before the second product.  The causal mask is q index >= k
// index.
//
// Bound at the served shapes (273 tokens, 32 heads of 128): the bytes of
// q, k, v and out, 2.7 us; the two products are 0.31 GFLOP, 0.31 us at the
// bf16 tensor rate.  What costs time is therefore load latency and
// occupancy, not traffic or tensor throughput, and the design aims at many
// independent blocks whose loads overlap their products:
//  * one block per (batch * head, 64-row query tile).  The TPU kernel's
//    sequential innermost grid axis over K blocks is a loop inside the block
//    over 64-row K/V tiles staged in shared memory; the loop stops at the
//    diagonal when causal, and the heaviest query tiles are scheduled first.
//  * q, k, v and out are addressed through (batch, seq, head) strides, so the
//    (B, S, H, D) layout of the model is read in place: no transposes, and a
//    K/V head is shared by its query group through kv_head = h / group.
//  * ragged tails in S and T are masked here (rows past the end load zeros,
//    columns past T score -1e30), so any sequence length is taken.
//
// Two kernels, by input type:
//  * bfloat16 (the served type): Q and the first K and V tiles are issued
//    together as 16-byte cp.async copies, then K and V stream through a ring
//    of two stages each: while tile j is in the products, tile j+1 is on its
//    way.  K and V are separate commit groups, so the scores wait for K only
//    and the p v product for V.  Each thread copies one column piece of
//    rows r, r + 8, ... of every tile, so its addresses step by constants:
//    issuing the copies costs a few instructions each (at D = 96 the last 8
//    threads idle while the others copy).  87 KB of shared memory at
//    D = 128 (65 KB at 96) and 128 threads, so two blocks share an SM (160
//    blocks at the served shape, all resident on 132 SMs).  Both products
//    run on the tensor cores through mma.sync.m16n8k16 with float32
//    accumulators, fed by ldmatrix: Q fragments stay in registers for the
//    whole block, the softmax runs on the accumulator registers in exp2
//    (one ex2.approx each) with scale * log2(e) folded into one multiply,
//    masking only the tiles that cross the diagonal or the end of T, and the
//    rounded probabilities are repacked in registers as the A operand of the
//    second product, so neither scores nor probabilities ever touch memory.
//    mma.sync and not wgmma: clock stamps inside the loop on the H100 found
//    each tile already landed when its step began, and the two products
//    under half of a step's cycles; issuing the copies and the softmax took
//    the rest, so those were made cheaper instead.
//  * float32: scalar FMAs (TF32 would not hold the 2e-5 the callers are given).
//    256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
//    4*ty..4*ty+3, score columns tx + 16*j and output columns tx + 16*c, so a
//    row's statistics live in one half-warp; probabilities pass through shared
//    memory between the two products.  Not on a served path; it keeps the
//    first design's synchronous tile loop.
// Rows in shared memory are padded so that strided row reads and ldmatrix are
// free of bank conflicts.
//
// Both kernels are templated on the head dim of q and k (DQK) and that of v
// and out (DV).  The equal pairs 16/32/64/96/128 serve the GQA models; (192,
// 128) is DeepSeek-V2's multi-head latent attention prefill (128 no-RoPE plus
// 64 RoPE dims in q and k, values of 128), (24, 16) the same at the reduced
// width (the bf16 kernel carries q and k in 32-column tiles, zero-padded).  The TPU kernel takes one head dim
// only (its V block is (1, bk, D) with D from q), and the JAX package runs
// that attention through XLA.  At (192, 128) the bf16 kernel's shared memory
// is Q 25.6 KB + the K ring 51.2 KB + the V ring 34.8 KB, 109 KB, so two
// blocks still share an SM; a warp keeps 48 registers of Q fragments beside
// the 64 of its output accumulator.
#include "common.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // key/value rows per tile

struct Strides {                 // elements, per (batch, seq, head)
    long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// Copy rows [row0, row0 + 64) x D of a strided global array into a padded
// shared tile in 16-byte pieces; rows at or past n_rows become zeros.
template <typename T, int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n_rows) {
    constexpr int E = 16 / sizeof(T);             // elements per piece
    constexpr int PIECES = D / E;                 // pieces per row
    for (int idx = threadIdx.x; idx < 64 * PIECES; idx += THREADS) {
        const int r = idx / PIECES;
        const int c = (idx - r * PIECES) * E;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < n_rows)
            val = *reinterpret_cast<const uint4*>(
                src + (long long)(row0 + r) * row_stride + c);
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
}

// ============================================================ bfloat16, mma
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 128;    // 4 warps x 16 query rows
constexpr int STAGES = 2;        // ring depth of K and of V
constexpr int PAD = 8;           // 16 bytes: keeps rows 16-byte aligned

// q k^T runs over 16-column steps: a q/k head dim of 8 past a multiple of
// 16 (the reduced MLA's 24) is carried in tiles of the next multiple, the
// extra 8 columns zero
template <int DQK>
__host__ __device__ constexpr int padded_qk() { return (DQK + 15) / 16 * 16; }

template <int DQK, int DV>
constexpr size_t smem_bytes() {  // Q, then the K stages and the V stages
    return ((size_t)(BQ + STAGES * BK) * (padded_qk<DQK>() + PAD)
            + (size_t)STAGES * BK * (DV + PAD)) * sizeof(bf16);
}

// Issue rows [row0, row0 + 64) x D of a strided global array into a padded
// shared tile as 16-byte cp.async copies; rows at or past n_rows are never
// read and become zeros.  Every thread copies the same column piece of
// rows r, r + RSTEP, ..., so its addresses step by constants.  Where the
// pieces of a row do not divide the threads (D = 96: 12 pieces, so 10 rows
// of 120 threads a pass), the last threads idle and the last pass stops at
// row 64.
template <int D, int LD>
__device__ __forceinline__ void issue_tile(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           long long row_stride, int row0,
                                           int n_rows) {
    constexpr int PIECES = D / 8;                 // 16-byte pieces per row
    constexpr int RSTEP = kThreads / PIECES;      // rows per pass
    constexpr int PASSES = (64 + RSTEP - 1) / RSTEP;
    constexpr bool RAGGED = RSTEP * PIECES != kThreads || 64 % RSTEP != 0;
    static_assert(D % 8 == 0 && PIECES <= kThreads, "tile shape");
    if (RAGGED && threadIdx.x >= RSTEP * PIECES) return;
    const int r = threadIdx.x / PIECES;
    const int c = (threadIdx.x % PIECES) * 8;
    const bf16* sp = src + (long long)(row0 + r) * row_stride + c;
    const uint32_t dp =
        (uint32_t)__cvta_generic_to_shared(dst + r * LD + c);
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
        if (RAGGED && r + i * RSTEP >= 64) break;
        if (row0 + r + i * RSTEP < n_rows)
            cp_async16(dp + i * RSTEP * LD * (int)sizeof(bf16),
                       sp + (long long)i * RSTEP * row_stride);
        else
            *reinterpret_cast<uint4*>(dst + (r + i * RSTEP) * LD + c) =
                make_uint4(0u, 0u, 0u, 0u);
    }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            bf16* __restrict__ o,
                            int S, int T_len, int H, int KV, Strides st,
                            float scale_log2, int causal) {
    constexpr int DP = padded_qk<DQK>();
    constexpr int LD = DP + PAD;     // rows of Q and K
    constexpr int LDV = DV + PAD;    // rows of V
    constexpr int KS = DP / 16;      // k-steps of q k^T
    static_assert(DP == DQK || DP == DQK + 8, "q/k head dim");
    static_assert(DV % 16 == 0, "v head dim");
    constexpr int VS = DV / 16;      // column pairs of p v
    constexpr int NT = BK / 8;       // 8-column score tiles per K tile
    constexpr int OT = DV / 8;       // 8-column output tiles
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
    bf16* k_ring = q_s + BQ * LD;    // STAGES K tiles
    bf16* v_ring = k_ring + STAGES * BK * LD;   // STAGES V tiles

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;         // row of the fragment this lane holds
    const int tg = lane & 3;         // column pair within the fragment
    const int mi = lane >> 3;        // ldmatrix: which 8x8 matrix this lane
    const int mr = lane & 7;         //           addresses, and which row
    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh - b * H;
    const int kvh = h / (H / KV);
    const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;   // heavy first

    const bf16* q_base = q + b * st.q_b + h * st.q_h;
    const bf16* k_base = k + b * st.k_b + kvh * st.k_h;
    const bf16* v_base = v + b * st.v_b + kvh * st.v_h;
    bf16* o_base = o + b * st.o_b + h * st.o_h;

    int k_end = T_len;
    if (causal) k_end = min(T_len, q0 + BQ);
    const int n_k = (k_end + BK - 1) / BK;

    // Q with K tile 0 (one group), V tile 0 (the next), then the K and V
    // groups of the tiles up to STAGES - 1: all in flight together
    if (DP != DQK) {
        // the pad columns of Q and of every K stage are never copied into:
        // zero them once, before the first wait, so they add 0 to q k^T
        for (int r = threadIdx.x; r < BQ + STAGES * BK; r += kThreads)
            *reinterpret_cast<uint4*>(q_s + r * LD + DQK) =
                make_uint4(0u, 0u, 0u, 0u);
    }
    issue_tile<DQK, LD>(q_s, q_base, st.q_s, q0, S);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < n_k)
            issue_tile<DQK, LD>(k_ring + i * BK * LD, k_base, st.k_s, i * BK,
                                T_len);
        cp_async_commit();
        if (i < n_k)
            issue_tile<DV, LDV>(v_ring + i * BK * LDV, v_base, st.v_s, i * BK,
                                T_len);
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

    for (int j = 0; j < n_k; ++j) {
        const int k0 = j * BK;
        const bf16* k_s = k_ring + (j % STAGES) * BK * LD;
        const bf16* v_s = v_ring + (j % STAGES) * BK * LDV;
        cp_async_wait<2 * STAGES - 3>();   // K tile j (and Q) landed
        __syncthreads();             // ... for every thread; tile j-1 consumed
        if (j == 0) {
            // A fragments of this warp's 16 query rows, kept for the block:
            // (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), ...
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
                ldmatrix_x4(qf[ks], q_s + (warp * 16 + (mi & 1) * 8 + mr) * LD
                                        + ks * 16 + (mi >> 1) * 8);
        }
        // tile j + STAGES - 1 into the stages tile j-1 left; empty groups
        // past the end keep the count
        const int nj = j + STAGES - 1;
        if (nj < n_k)
            issue_tile<DQK, LD>(k_ring + (nj % STAGES) * BK * LD, k_base,
                                st.k_s, nj * BK, T_len);
        cp_async_commit();
        if (nj < n_k)
            issue_tile<DV, LDV>(v_ring + (nj % STAGES) * BK * LDV, v_base,
                                st.v_s, nj * BK, T_len);
        cp_async_commit();

        // ---- scores s (16 x 64 per warp) = q k^T
        float s[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                // matrices (keys 0-7, d 0-7), (keys 0-7, d 8-15),
                //          (keys 8-15, d 0-7), (keys 8-15, d 8-15)
                uint32_t kb[4];
                ldmatrix_x4(kb, k_s + (np * 16 + (mi >> 1) * 8 + mr) * LD
                                    + ks * 16 + (mi & 1) * 8);
                mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
                mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
            }
        }

        // ---- mask (only a tile that crosses the diagonal or the end of T
        // has anything to mask) and online softmax on the accumulator
        // registers, in log2 units: s[t][0..1] belong to row g, s[t][2..3]
        // to row g + 8, columns 8*t + 2*tg + {0, 1}
        const bool masked = k0 + BK > T_len || (causal && k0 + BK - 1 > q0);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int qi = q0 + warp * 16 + g + half * 8;
            float m_cur = NEG_INF;
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float x = s[t][half * 2 + e] * scale_log2;
                    if (masked) {
                        const int ki = k0 + t * 8 + 2 * tg + e;
                        if (ki >= T_len || (causal && ki > qi)) x = NEG_INF;
                    }
                    s[t][half * 2 + e] = x;
                    m_cur = fmaxf(m_cur, x);
                }
            m_cur = quad_max(m_cur);
            const float m_new = fmaxf(m_i[half], m_cur);
            const bool dead = m_new <= 0.5f * NEG_INF;      // no valid key yet
            float row_sum = 0.f;
#pragma unroll
            for (int t = 0; t < NT; ++t)
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

        cp_async_wait<2 * STAGES - 2>();   // V tile j landed
        __syncthreads();

        // ---- o (16 x DV per warp) += p v: two neighbouring score tiles,
        // rounded to bf16, are exactly the A fragment of a 16-key step
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
            pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
            pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
            pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
            for (int dp = 0; dp < VS; ++dp) {
                // transposed: matrices (keys 0-7, d 0-7), (keys 8-15, d 0-7),
                //                      (keys 0-7, d 8-15), (keys 8-15, d 8-15)
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, v_s + (ks * 16 + (mi & 1) * 8 + mr) * LDV
                                          + dp * 16 + (mi >> 1) * 8);
                mma_bf16(o_acc[2 * dp], pa, vb[0], vb[1]);
                mma_bf16(o_acc[2 * dp + 1], pa, vb[2], vb[3]);
            }
        }
    }
    cp_async_wait<0>();              // nothing left in flight at exit

    // ---- finish: out = acc / l, rows past S are not written
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int qi = q0 + warp * 16 + g + half * 8;
        float l = quad_sum(l_i[half]);
        if (l == 0.f) l = 1.f;
        if (qi >= S) continue;
        bf16* row = o_base + (long long)qi * st.o_s;
#pragma unroll
        for (int t = 0; t < OT; ++t)
            *reinterpret_cast<__nv_bfloat162*>(row + t * 8 + 2 * tg) =
                __floats2bfloat162_rn(o_acc[t][half * 2] / l,
                                      o_acc[t][half * 2 + 1] / l);
    }
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T_len, int H, int KV, const Strides& st, float scale,
           int causal, cudaStream_t stream) {
    auto kern = flash_attention_bf16_kernel<DQK, DV>;
    static int set[32] = {};
    const int e = allow_smem(kern, smem_bytes<DQK, DV>(), set);
    if (e != 0) return e;
    dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
    kern<<<grid, kThreads, smem_bytes<DQK, DV>(), stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, T_len, H,
        KV, st, scale * LOG2E, causal);
    return (int)cudaGetLastError();
}

template <int DQK, int DV>
int occupancy(int* blocks) {
    auto kern = flash_attention_bf16_kernel<DQK, DV>;
    static int set[32] = {};
    const int e = allow_smem(kern, smem_bytes<DQK, DV>(), set);
    if (e != 0) return e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kern, kThreads, smem_bytes<DQK, DV>());
}

}  // namespace tc

// ========================================================= float32, scalar
namespace fp32 {

constexpr int kThreads = 256;    // 16 (ty) x 16 (tx)
constexpr int PAD = 4;           // elements of padding per shared row
constexpr int SS = BK + 4;       // row stride of the probability tile

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int S, int T_len, int H, int KV, Strides st,
                           float scale, int causal) {
    constexpr int LD = DQK + PAD;                 // rows of Q and K
    constexpr int LDV = DV + PAD;                 // rows of V
    constexpr int CPT = DV / 16;                  // output columns per thread
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* q_s = reinterpret_cast<float*>(smem_raw);
    float* k_s = q_s + BQ * LD;
    float* v_s = k_s + BK * LD;
    float* p_s = v_s + BK * LDV;

    const int ty = threadIdx.x >> 4;
    const int tx = threadIdx.x & 15;
    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh - b * H;
    const int kvh = h / (H / KV);
    const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;   // heavy first

    const float* q_base = q + b * st.q_b + h * st.q_h;
    const float* k_base = k + b * st.k_b + kvh * st.k_h;
    const float* v_base = v + b * st.v_b + kvh * st.v_h;
    float* o_base = o + b * st.o_b + h * st.o_h;

    load_tile<float, DQK, LD, kThreads>(q_s, q_base, st.q_s, q0, S);

    float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_i[i] = NEG_INF;
        l_i[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    }

    int k_end = T_len;                            // keys this tile can see
    if (causal) k_end = min(T_len, q0 + BQ);

    for (int k0 = 0; k0 < k_end; k0 += BK) {
        __syncthreads();                          // previous tile fully consumed
        load_tile<float, DQK, LD, kThreads>(k_s, k_base, st.k_s, k0, T_len);
        load_tile<float, DV, LDV, kThreads>(v_s, v_base, st.v_s, k0, T_len);
        __syncthreads();

        // ---- scores: s[i][j] = q[4*ty+i] . k[tx+16*j]
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DQK; d += 4) {
            float qv[4][4], kv[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) load4(q_s + (4 * ty + i) * LD + d, qv[i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) load4(k_s + (tx + 16 * j) * LD + d, kv[j]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
        }

        // ---- mask, online softmax statistics per row (one half-warp a row)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qi = q0 + 4 * ty + i;
            float m_cur = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int ki = k0 + tx + 16 * j;
                float x = s[i][j] * scale;
                if (ki >= T_len || (causal && ki > qi)) x = NEG_INF;
                s[i][j] = x;
                m_cur = fmaxf(m_cur, x);
            }
#pragma unroll
            for (int w = 8; w > 0; w >>= 1)
                m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, w));
            const float m_new = fmaxf(m_i[i], m_cur);
            const bool dead = m_new <= 0.5f * NEG_INF;      // no valid key yet
            float row_sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = dead ? 0.f : expf(s[i][j] - m_new);
                row_sum += p;
                p_s[(4 * ty + i) * SS + tx + 16 * j] = p;
            }
#pragma unroll
            for (int w = 8; w > 0; w >>= 1)
                row_sum += __shfl_xor_sync(0xffffffffu, row_sum, w);
            const float alpha = expf(m_i[i] - m_new);
            l_i[i] = alpha * l_i[i] + row_sum;
            m_i[i] = m_new;
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

        // ---- acc[i][c] += sum_t p[4*ty+i][t] * v[t][tx + 16*c]
#pragma unroll 2
        for (int t = 0; t < BK; t += 4) {
            float pv[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) load4(p_s + (4 * ty + i) * SS + t, pv[i]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    const float vv = v_s[(t + e) * LDV + tx + 16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[i][c] = fmaf(pv[i][e], vv, acc[i][c]);
                }
            }
        }
    }

    // ---- finish: out = acc / l, rows past S are not written
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = q0 + 4 * ty + i;
        if (qi >= S) continue;
        const float l = l_i[i] == 0.f ? 1.f : l_i[i];
        float* row = o_base + (long long)qi * st.o_s;
#pragma unroll
        for (int c = 0; c < CPT; ++c) row[tx + 16 * c] = acc[i][c] / l;
    }
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int T_len, int H, int KV, const Strides& st, float scale,
           int causal, cudaStream_t stream) {
    const size_t smem = ((size_t)(BQ + BK) * (DQK + PAD)
                         + (size_t)BK * (DV + PAD) + (size_t)BQ * SS)
                        * sizeof(float);
    auto kern = flash_attention_f32_kernel<DQK, DV>;
    static int set[32] = {};
    const int e = allow_smem(kern, smem, set);
    if (e != 0) return e;
    dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
    kern<<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, S, T_len,
        H, KV, st, scale, causal);
    return (int)cudaGetLastError();
}

}  // namespace fp32

}  // namespace

// The (DQK, DV) head dims built: the equal ones, MLA's (192, 128) and the
// reduced MLA's (24, 16) (deepseek-v2-lite-16b's config reduced, as the
// serving driver runs it).
#define RT_PAIRS(X) X(16, 16) X(32, 32) X(64, 64) X(96, 96) X(128, 128) \
                    X(192, 128) X(24, 16)

// q: (B, S, H, D), k: (B, T, KV, D), v: (B, T, KV, Dv), o: (B, S, H, Dv),
// innermost stride 1, the others given in elements as (batch, seq, head) per
// array; every row the kernel reads must start on a 16-byte boundary.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 = launched), or a negative code for arguments the kernel does not take.
extern "C" int rt_flash_attention(
        const void* q, const void* k, const void* v, void* o,
        int B, int S, int T_len, int H, int KV, int D, int Dv,
        long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh,
        long long v_sb, long long v_ss, long long v_sh,
        long long o_sb, long long o_ss, long long o_sh,
        float scale, int causal, int dtype, void* stream) {
    if (B <= 0 || S <= 0 || T_len <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
        return -2;
    if ((S + BQ - 1) / BQ > 65535) return -3;
    if (dtype != 0 && dtype != 1) return -1;
    const Strides st = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                        v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
    cudaStream_t cs = (cudaStream_t)stream;
#define RT_CASE(dqk, dv)                                                      \
    if (D == dqk && Dv == dv)                                                 \
        return dtype == 0                                                     \
            ? fp32::launch<dqk, dv>(q, k, v, o, B, S, T_len, H, KV, st,       \
                                    scale, causal, cs)                        \
            : tc::launch<dqk, dv>(q, k, v, o, B, S, T_len, H, KV, st, scale,  \
                                  causal, cs);
    RT_PAIRS(RT_CASE)
#undef RT_CASE
    return -1;
}

// Blocks of the bf16 kernel at (D, Dv) that one SM holds at once, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor with the kernel's shared
// memory, written to *blocks.  Returns the cudaError_t, or -1 for a pair
// that is not built.
extern "C" int rt_flash_attention_occupancy(int D, int Dv, int* blocks) {
#define RT_CASE(dqk, dv)                                                      \
    if (D == dqk && Dv == dv) return tc::occupancy<dqk, dv>(blocks);
    RT_PAIRS(RT_CASE)
#undef RT_CASE
    return -1;
}
