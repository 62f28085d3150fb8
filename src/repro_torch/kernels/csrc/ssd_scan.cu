// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_scan_pallas (_kernel) of
// src/repro/kernels/ssd_scan/kernel.py.
//
// What it computes, as the TPU kernel does, for each (batch, head) and each
// chunk of Q positions, with a float32 state S (N, P) that starts at zero
// and is carried from chunk to chunk:
//   dA = dt * A, cs = its inclusive cumsum over the chunk, xdt = x * dt;
//   y  = ((C B^T) . L) @ xdt with L[i, j] = exp(cs_i - cs_j) for i >= j,
//        else 0;
//   y += exp(cs) * (C @ S);
//   S <- exp(cs_last) * S + B^T @ (xdt * exp(cs_last - cs)).
// Everything is float32 arithmetic or exact to float32 rounding (the cumsum
// accumulates in float64, see below); y is rounded to x's type once, at the
// end, and the final S is written in float32.  B and C (n_groups = 1) are
// shared by every head of a batch row; A is one scalar per head.
//
// Decays are only ever taken of differences that are <= 0: exp(cs_i - cs_j)
// for i >= j, exp(cs_last - cs_j), exp(cs_i), exp(cs_last).  The cumulative
// dA of a 256-position chunk reaches about -180 at the served widths, so the
// factored form exp(cs_i) * exp(-cs_j) would overflow float32.
//
// Bound, at Mamba2-1.3B's served shape (batch 1, 512 positions, 64 heads of
// 64, N = 128, chunk 256): the call moves about 10.9 MB (3.2 us at 3.35
// TB/s) and needs about 1.6 GFLOP in its least form, 1.7 us at the bf16
// tensor-core rate: bytes bound it.
//
// Design: the SSD paper's chunked decomposition (arXiv:2405.21060, section
// 6), which leaves one cheap step serial over the chunks.  One call of the C
// entry queues two kernels on the caller's stream:
//  1. ssd_state_kernel, grid (B*H + tiles, chunks, N / 64 row slices): per
//     (batch, head, chunk) the cumsum, then the chunk's own state
//     S_c = B^T @ (xdt * exp(cs_last - cs)), with no dependency between
//     chunks; and, in the blocks past B*H, C B^T once per (batch, chunk) for
//     all heads, its 64 x 64 tiles at or below the diagonal (10 a chunk of
//     256).  It writes S_c, the cumsum and C B^T into workspaces that the
//     wrapper allocates for the call (PyTorch's caching allocator; no
//     scratch kept between calls): C B^T is 512 KB at batch 1, which L2
//     holds for the next kernel.
//  2. ssd_out_kernel, grid (B*H, chunks, row blocks): per (batch, head,
//     chunk, 64-row block) y = exp(cs) * (C @ S_in) + sum over key blocks at
//     or below the diagonal of (C B_j^T . L) @ xdt_j, the heaviest row
//     blocks first; 512 blocks at batch 1.  Each thread reads its score
//     fragments of C B_j^T straight from the workspace into registers, so
//     a key block stages only xdt_j.  The state passing is folded into the
//     staging of S_in: S = 0, then S = exp(cs_last_c') * S + S_c' for every
//     earlier chunk c' (one chunk state read at the served two chunks; a
//     prompt of n chunks has its last blocks read n - 1), and the first row
//     block of the last chunk carries it one chunk further and writes the
//     final state.  That saves a third, element-wise kernel, whose launch
//     and pass over every chunk state cost more than the reads folded in.
//  * Every product runs on mma.sync.m16n8k16 (bf16 in, float32 accumulate),
//    fed by ldmatrix from padded bf16 planes in shared memory.  An operand
//    that is float32 (xdt and its decayed form, the scores C B^T . L, the
//    carried state) is split into bf16 pieces hi + lo (+ lo2), v = sum of
//    the pieces to 2^-16 (2^-24 with three), and the pieces' cross products
//    down to that order are summed: 2 passes for a bf16 times a two-piece
//    operand, 3 for two two-piece operands.  The chunk states take three
//    pieces (the state is held to float32's 2e-5 of its largest value, even
//    for bf16 inputs: two pieces come within a third of that, one misses it
//    a hundredfold, in the CPU emulation of tests/test_torch_ssd_scan.py);
//    y, which is held to two bf16 units, takes two (OutPieces: on the H100
//    one piece held the limit at about half of it, three were no more
//    accurate than two).
//  * Float32 inputs (the float32 checks; not a served type) run the same
//    kernels with every product as scalar float32 FMAs in k order, on
//    operands staged as three bf16 pieces and rebuilt exactly, and decays
//    by expf.  On the tensor cores, even with three pieces of every operand
//    and each pass summed into its own accumulator, the float32 models of
//    chip_smoke.py ended measurably further from their full forward than
//    with FMAs, at the edge of their limit: the tensor cores' float32 sums
//    do not round to nearest.
//  * Operands are staged by 16-byte loads (element loads where a row is not
//    16-byte aligned), converted, scaled and split on the way into shared
//    memory and stored 16 bytes a piece (the split needs registers, so
//    cp.async cannot place them); several blocks per SM overlap one block's
//    loads with another's products.
//  * The cumsum is a block scan, two positions per thread (Q <= 256),
//    accumulated in float64 and rounded to float32 once.  A float32 scan
//    drifts by a few units in the last place of |cs| (up to ~400 at the
//    served widths), which moves y by ~1e-5 of its largest value; the plain
//    version accumulates in float64 too.
//  * x is read in the model's (B, T, H, P) layout through strides, B and C
//    through their (batch, seq) strides: no transpose or padded copy.
//    Positions past T (a ragged last chunk, or T < chunk) load as zeros with
//    dt = 0, which leaves the state unchanged and writes no y row.
//  * State dims N in {8, 16, 32, 64, 128} run padded to NP in {32, 64, 128}
//    with zero rows, head dims P in {8, 16, 32, 64} padded to 64 with zero
//    columns.
#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 128;     // 4 warps
constexpr int R = 64;             // positions per row, key and k block
constexpr int MAX_CHUNK = 256;    // two positions per thread in the cumsum
constexpr int PP = 64;            // columns of P, padded
constexpr int PADH = 8;           // bf16 elements added to every plane row

struct Args {
    int B, T, H, P, N, Q, nc;
    long long x_b, x_t, x_h;      // x (B, T, H, P), innermost stride 1
    long long dt_b, dt_t;         // dt (B, T, H), innermost stride 1
    long long b_b, b_t, c_b, c_t; // Bm, Cm (B, T, N), innermost stride 1
};

template <typename T> struct Pieces { static constexpr int value = 3; };
template <> struct Pieces<bf16> { static constexpr int value = 1; };
// pieces of y's float32 operands: two for bf16 inputs, three (rebuilt
// exactly for the FMAs) for float32 inputs
template <typename T> struct OutPieces { static constexpr int value = 3; };
template <> struct OutPieces<bf16> { static constexpr int value = 2; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
    *p = __float2bfloat16(x);
}

// 8 consecutive elements as floats: one 16-byte load of bf16, two of
// float32
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
    }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 float32 values v as NPC bf16 pieces, one 16-byte store per piece
template <int NPC>
__device__ __forceinline__ void put8(bf16* dst, int plane, float (&v)[8]) {
#pragma unroll
    for (int q = 0; q < NPC; ++q) {
        uint4 u;
        uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const __nv_bfloat162 t =
                __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
            w[k] = *reinterpret_cast<const uint32_t*>(&t);
            v[2 * k] -= __low2float(t);
            v[2 * k + 1] -= __high2float(t);
        }
        *reinterpret_cast<uint4*>(dst + q * plane) = u;
    }
}

// Rows [0, ROWS) x columns [0, COLS) of a strided global array into NPC
// bf16 planes (row stride ld, plane after plane), row r times s1[r] and
// then s2[r] where given; rows at or past `rows` and columns at or past
// `cols` (a multiple of 8) are zeros.  Each thread takes 8 columns a step,
// the loads of up to 4 steps issued before their stores: one 16-byte load
// where the array's rows are 16-byte aligned (VEC), element loads where
// they are not.
template <int ROWS, int COLS, int NPC, bool VEC, typename T>
__device__ __forceinline__ void stage_as(bf16* dst, int ld, int plane,
                                         const T* __restrict__ src,
                                         long long stride, int rows,
                                         int cols, const float* s1,
                                         const float* s2) {
    constexpr int G = COLS / 8;
    constexpr int STEPS = ROWS * G / kThreads;
    constexpr int GRP = STEPS < 4 ? STEPS : 4;
    static_assert(ROWS * G % kThreads == 0 && STEPS % GRP == 0,
                  "whole steps");
#pragma unroll
    for (int g0 = 0; g0 < STEPS; g0 += GRP) {
        float v[GRP][8];
#pragma unroll
        for (int j = 0; j < GRP; ++j) {
            const int i = threadIdx.x + (g0 + j) * kThreads;
            const int r = i / G;
            const int c = (i - r * G) * 8;
            if (r < rows && c < cols) {
                const T* p = src + (long long)r * stride + c;
                if (VEC) {
                    load8(p, v[j]);
                } else {
#pragma unroll
                    for (int k = 0; k < 8; ++k) v[j][k] = to_f(p[k]);
                }
            } else {
#pragma unroll
                for (int k = 0; k < 8; ++k) v[j][k] = 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < GRP; ++j) {
            const int i = threadIdx.x + (g0 + j) * kThreads;
            const int r = i / G;
            const int c = (i - r * G) * 8;
            if (s1 != nullptr) {
                const float f = s1[r];
#pragma unroll
                for (int k = 0; k < 8; ++k) v[j][k] *= f;
            }
            if (s2 != nullptr) {
                const float f = s2[r];
#pragma unroll
                for (int k = 0; k < 8; ++k) v[j][k] *= f;
            }
            put8<NPC>(dst + r * ld + c, plane, v[j]);
        }
    }
}

template <int ROWS, int COLS, int NPC, typename T>
__device__ __forceinline__ void stage(bf16* dst, int ld, int plane,
                                      const T* __restrict__ src,
                                      long long stride, int rows, int cols,
                                      const float* s1, const float* s2) {
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0
            && (stride * (long long)sizeof(T)) % 16 == 0)
        stage_as<ROWS, COLS, NPC, true>(dst, ld, plane, src, stride, rows,
                                        cols, s1, s2);
    else
        stage_as<ROWS, COLS, NPC, false>(dst, ld, plane, src, stride, rows,
                                         cols, s1, s2);
}

// The state entering chunk c of (batch * head) bh, as the plain version
// passes it: S = 0, then S = S * exp(cs_last_c') + S_c' for c' < c, rows n
// < N of the chunk states in ws (float32, (N, P) each), into NPC bf16
// planes of NP rows x PP columns; with `final_state`, carried one chunk
// further (through chunk c) and written there as well.  Each thread takes
// 8 columns of up to 4 rows at once, their loads issued together.
template <int NP, int NPC>
__device__ __forceinline__ void stage_state(bf16* dst, int ld, int plane,
                                            const float* __restrict__ ws,
                                            const float* __restrict__ ws_cs,
                                            long long bh, int c, bool stage_in,
                                            float* final_state,
                                            const Args& a) {
    constexpr int G = PP / 8;
    constexpr int STEPS = NP * G / kThreads;
    constexpr int GRP = STEPS < 4 ? STEPS : 4;
    static_assert(NP * G % kThreads == 0 && STEPS % GRP == 0, "whole steps");
    const bool fin = final_state != nullptr;
#pragma unroll
    for (int g0 = 0; g0 < STEPS; g0 += GRP) {
        float v[GRP][8];
#pragma unroll
        for (int j = 0; j < GRP; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k) v[j][k] = 0.f;
        for (int cc = 0; cc < c + (fin ? 1 : 0); ++cc) {
            const int qe = min(a.Q, a.T - cc * a.Q);
            const float d = expf(ws_cs[(bh * a.nc + cc) * a.Q + qe - 1]);
            float t[GRP][8];
#pragma unroll
            for (int j = 0; j < GRP; ++j) {
                const int i = threadIdx.x + (g0 + j) * kThreads;
                const int n = i / G;
                const int col = (i - n * G) * 8;
                if (n < a.N && col < a.P) {
                    load8(ws + ((bh * a.nc + cc) * a.N + n) * a.P + col, t[j]);
                } else {
#pragma unroll
                    for (int k = 0; k < 8; ++k) t[j][k] = 0.f;
                }
            }
#pragma unroll
            for (int j = 0; j < GRP; ++j) {
                float f[8];
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    f[k] = __fadd_rn(__fmul_rn(v[j][k], d), t[j][k]);
                if (cc < c) {
#pragma unroll
                    for (int k = 0; k < 8; ++k) v[j][k] = f[k];
                    continue;
                }
                const int i = threadIdx.x + (g0 + j) * kThreads;
                const int n = i / G;
                const int col = (i - n * G) * 8;
                if (n < a.N && col < a.P) {        // cc == c: the final state
                    float* o = final_state + (bh * a.N + n) * a.P + col;
                    *reinterpret_cast<float4*>(o) =
                        make_float4(f[0], f[1], f[2], f[3]);
                    *reinterpret_cast<float4*>(o + 4) =
                        make_float4(f[4], f[5], f[6], f[7]);
                }
            }
        }
        if (stage_in) {
#pragma unroll
            for (int j = 0; j < GRP; ++j) {
                const int i = threadIdx.x + (g0 + j) * kThreads;
                const int n = i / G;
                const int col = (i - n * G) * 8;
                put8<NPC>(dst + n * ld + col, plane, v[j]);
            }
        }
    }
}

// two values as NPC packed bf16x2 pieces, piece i at dst[i * stride]
template <int NPC>
__device__ __forceinline__ void pack_pieces(uint32_t* dst, int stride,
                                            float lo, float hi) {
#pragma unroll
    for (int i = 0; i < NPC; ++i) {
        const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
        dst[i * stride] = *reinterpret_cast<const uint32_t*>(&t);
        lo -= __low2float(t);
        hi -= __high2float(t);
    }
}

// ldmatrix addressing of a 16x16 tile: lane l names row (l & 7) of matrix
// (l >> 3)
__device__ __forceinline__ int lm_i() { return (threadIdx.x & 31) >> 3; }
__device__ __forceinline__ int lm_r() { return threadIdx.x & 7; }

// A fragment (rows m0.., k k0..) of a row-major [m][k] plane
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* p,
                                       int ld, int m0, int k0) {
    ldmatrix_x4(a, p + (m0 + (lm_i() & 1) * 8 + lm_r()) * ld + k0
                       + (lm_i() >> 1) * 8);
}

// A fragment of a plane stored transposed, [k][m]
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* p,
                                         int ld, int m0, int k0) {
    ldmatrix_x4_trans(a, p + (k0 + (lm_i() >> 1) * 8 + lm_r()) * ld + m0
                             + (lm_i() & 1) * 8);
}

// B fragments of two n8 tiles (n0.., n0 + 8..) from a [k][n] plane: regs
// 0-1 the first tile, 2-3 the second
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* p,
                                          int ld, int k0, int n0) {
    ldmatrix_x4_trans(b, p + (k0 + (lm_i() & 1) * 8 + lm_r()) * ld + n0
                             + (lm_i() >> 1) * 8);
}

// the same from an [n][k] plane
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* p,
                                          int ld, int k0, int n0) {
    ldmatrix_x4(b, p + (n0 + (lm_i() >> 1) * 8 + lm_r()) * ld + k0
                       + (lm_i() & 1) * 8);
}

// c += (sum of a's PA pieces) (sum of b's PB pieces), n8 tile `half` of b,
// keeping the cross products of order below max(PA, PB)
template <int PA, int PB>
__device__ __forceinline__ void mma_pieces(float (&c)[4],
                                           const uint32_t (&a)[PA][4],
                                           const uint32_t (&b)[PB][4],
                                           int half) {
    constexpr int M = PA > PB ? PA : PB;
#pragma unroll
    for (int i = 0; i < PA; ++i)
#pragma unroll
        for (int j = 0; j < PB; ++j)
            if (i + j < M) mma_bf16(c, a[i], b[j][2 * half], b[j][2 * half + 1]);
}

// A float32 value from its three bf16 pieces, planes apart: exact, the
// pieces hold its 24 bits
__device__ __forceinline__ float rec3(const bf16* p, int plane) {
    return (__bfloat162float(p[0]) + __bfloat162float(p[plane]))
        + __bfloat162float(p[2 * plane]);
}

// Float32 inputs: c, one n8 tile of a warp's 16 rows in the mma layout
// (c[0..1] row g, c[2..3] row g + 8, columns 2tg, 2tg + 1), plus
// A[m0.., k0..k0 + 15] B[k0.., n0..] by scalar float32 FMAs in k order, as
// a float32 product sums.  A(m, k) and B(k, n) read shared memory.
template <typename FA, typename FB>
__device__ __forceinline__ void fma16(float (&c)[4], FA A, FB B, int m0,
                                      int n0, int k0) {
    const int g = (threadIdx.x & 31) >> 2;
    const int tg = threadIdx.x & 3;
#pragma unroll 4
    for (int k = k0; k < k0 + 16; ++k) {
        const float a0 = A(m0 + g, k);
        const float a1 = A(m0 + g + 8, k);
        const float b0 = B(k, n0 + 2 * tg);
        const float b1 = B(k, n0 + 2 * tg + 1);
        c[0] = fmaf(a0, b0, c[0]);
        c[1] = fmaf(a0, b1, c[1]);
        c[2] = fmaf(a1, b0, c[2]);
        c[3] = fmaf(a1, b1, c[3]);
    }
}

// Inclusive cumsum of dt * A over the chunk's Qe live positions (two per
// thread), in float64, rounded once: cs_s[i], and dt_s[i] (zero past Qe).
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dtc,
                                             long long dt_t, float Ah, int Qe,
                                             float* cs_s, float* dt_s,
                                             double* wsum) {
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int i0 = 2 * t;
    const float d0 = i0 < Qe ? dtc[(long long)i0 * dt_t] : 0.f;
    const float d1 = i0 + 1 < Qe ? dtc[(long long)(i0 + 1) * dt_t] : 0.f;
    const double a0 = (double)(d0 * Ah);
    const double a1 = (double)(d1 * Ah);
    double v = a0 + a1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    double ex = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) ex = 0.0;
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) ex += wsum[w];
    cs_s[i0] = (float)(ex + a0);
    cs_s[i0 + 1] = (float)(ex + a0 + a1);
    dt_s[i0] = d0;
    dt_s[i0 + 1] = d1;
}

// ------------------------------------------------------- 1. chunk states
constexpr int PV_STATE = 3;       // pieces of the chunk states' float32 operand

template <typename T, int MB>
struct StateLayout {                       // shared memory, in bytes
    static constexpr int PV = PV_STATE;
    static constexpr int PC = Pieces<T>::value;
    static constexpr int LDB = MB + PADH;  // B rows: [j][n], R rows
    static constexpr int LDX = PP + PADH;  // weighted xdt: [j][p], R rows
    static constexpr int BK = 0;
    static constexpr int VX = BK + PC * R * LDB * 2;
    static constexpr int CS = VX + PV * R * LDX * 2;
    static constexpr int DT = CS + MAX_CHUNK * 4;
    static constexpr int W = DT + MAX_CHUNK * 4;
    static constexpr int WSUM = W + MAX_CHUNK * 4;
    static constexpr int BYTES = WSUM + (kThreads / 32) * 8;
};

template <typename T, int NP>
struct CBLayout {                          // shared memory, in bytes
    static constexpr int PC = Pieces<T>::value;
    static constexpr int LDN = NP + PADH;  // C and B rows: [i][n], R rows
    static constexpr int CI = 0;
    static constexpr int BJ = CI + PC * R * LDN * 2;
    static constexpr int BYTES = BJ + PC * R * LDN * 2;
};

// One 64 x 64 tile of C B^T at or below the diagonal, for every head of
// batch row b and chunk c: tile t of the chunk's lower tiles (0, 0),
// (1, 0), (1, 1), (2, 0), ...  Rows i0.. of C against rows j0.. of B on
// the tensor cores (exact products for bf16 inputs), written in float32 to
// the chunk's (Qp, Qp) square of ws_cb, Qp = 64 x row blocks.
template <typename T, int NP>
__device__ __forceinline__ void cb_tile(const T* __restrict__ Bm,
                                        const T* __restrict__ Cm,
                                        float* __restrict__ ws_cb,
                                        const Args& a, int bt, int c,
                                        unsigned char* smem) {
    using L = CBLayout<T, NP>;
    constexpr int PC = L::PC;
    const int nb = ((a.Q < a.T ? a.Q : a.T) + R - 1) / R;
    const int nt = nb * (nb + 1) / 2;
    const int b = bt / nt;
    int jb = bt - b * nt, ib = 0;
    while (jb > ib) {                      // the lower tile's (ib, jb)
        jb -= ib + 1;
        ++ib;
    }
    const int c0 = c * a.Q;
    const int Qe = min(a.Q, a.T - c0);
    const int i0 = ib * R;
    const int j0 = jb * R;
    if (i0 >= Qe) return;                  // past a short last chunk
    bf16* ci = reinterpret_cast<bf16*>(smem + L::CI);
    bf16* bj = reinterpret_cast<bf16*>(smem + L::BJ);
    stage<R, NP, PC>(ci, L::LDN, R * L::LDN,
                     Cm + b * a.c_b + (long long)(c0 + i0) * a.c_t, a.c_t,
                     min(R, Qe - i0), a.N, nullptr, nullptr);
    stage<R, NP, PC>(bj, L::LDN, R * L::LDN,
                     Bm + b * a.b_b + (long long)(c0 + j0) * a.b_t, a.b_t,
                     min(R, Qe - j0), a.N, nullptr, nullptr);
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    float s[R / 8][4];
#pragma unroll
    for (int t = 0; t < R / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    constexpr int PL = R * L::LDN;         // plane stride
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks) {
        if constexpr (PC == 3) {
            auto A = [&](int m, int k) { return rec3(ci + m * L::LDN + k, PL); };
            auto B = [&](int k, int n) { return rec3(bj + n * L::LDN + k, PL); };
#pragma unroll
            for (int t = 0; t < R / 8; ++t)
                fma16(s[t], A, B, warp * 16, t * 8, ks * 16);
            continue;
        }
        uint32_t aq[PC][4];
#pragma unroll
        for (int q = 0; q < PC; ++q)
            frag_a(aq[q], ci + q * PL, L::LDN, warp * 16, ks * 16);
#pragma unroll
        for (int np = 0; np < R / 16; ++np) {
            uint32_t bq[PC][4];
#pragma unroll
            for (int q = 0; q < PC; ++q)
                frag_b_nk(bq[q], bj + q * PL, L::LDN, ks * 16, np * 16);
            mma_pieces<PC, PC>(s[2 * np], aq, bq, 0);
            mma_pieces<PC, PC>(s[2 * np + 1], aq, bq, 1);
        }
    }
    const int Qp = nb * R;
    float* o = ws_cb + ((long long)(b * a.nc + c) * Qp + i0 + warp * 16
                        + (lane >> 2)) * Qp + j0 + 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < R / 8; ++t) {
        *reinterpret_cast<float2*>(o + t * 8) = make_float2(s[t][0], s[t][1]);
        *reinterpret_cast<float2*>(o + 8 * Qp + t * 8) =
            make_float2(s[t][2], s[t][3]);
    }
}

// Blocks x < B*H: the chunk state of (batch * head) x, chunk y, state rows
// z * 64..; blocks past them: a C B^T tile (at z = 0; the others return).
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ ws_state,
                 float* __restrict__ ws_cs, float* __restrict__ ws_cb,
                 Args a) {
    constexpr int MB = NP < 64 ? NP : 64;  // state rows per block
    using L = StateLayout<T, MB>;
    constexpr int PV = L::PV;
    constexpr int PC = L::PC;
    constexpr int MT = MB / 16;            // m16 tiles of state rows
    extern __shared__ __align__(16) unsigned char smem[];
    if ((int)blockIdx.x >= a.B * a.H) {
        if (blockIdx.z == 0)
            cb_tile<T, NP>(Bm, Cm, ws_cb, a, blockIdx.x - a.B * a.H,
                           blockIdx.y, smem);
        return;
    }
    bf16* bk = reinterpret_cast<bf16*>(smem + L::BK);
    bf16* vx = reinterpret_cast<bf16*>(smem + L::VX);
    float* cs_s = reinterpret_cast<float*>(smem + L::CS);
    float* dt_s = reinterpret_cast<float*>(smem + L::DT);
    float* w_s = reinterpret_cast<float*>(smem + L::W);
    double* wsum = reinterpret_cast<double*>(smem + L::WSUM);

    const int bh = blockIdx.x;
    const int c = blockIdx.y;
    const int n0 = blockIdx.z * MB;
    const int b = bh / a.H;
    const int h = bh - b * a.H;
    const int c0 = c * a.Q;
    const int Qe = min(a.Q, a.T - c0);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;

    chunk_cumsum(dt + b * a.dt_b + (long long)c0 * a.dt_t + h, a.dt_t, A[h],
                 Qe, cs_s, dt_s, wsum);
    __syncthreads();
    const float cs_last = cs_s[Qe - 1];
    for (int i = tid; i < MAX_CHUNK; i += kThreads)
        w_s[i] = i < Qe ? expf(cs_last - cs_s[i]) : 0.f;
    if (blockIdx.z == 0)
        for (int i = tid; i < Qe; i += kThreads)
            ws_cs[((long long)bh * a.nc + c) * a.Q + i] = cs_s[i];

    const T* xb = x + b * a.x_b + (long long)c0 * a.x_t + h * a.x_h;
    const T* Bb = Bm + b * a.b_b + (long long)c0 * a.b_t + n0;
    float acc[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;

    for (int j0 = 0; j0 < Qe; j0 += R) {
        const int rows = min(R, Qe - j0);
        __syncthreads();                   // the last k block is consumed
        stage<R, MB, PC>(bk, L::LDB, R * L::LDB, Bb + (long long)j0 * a.b_t,
                         a.b_t, rows, min(MB, a.N - n0), nullptr, nullptr);
        stage<R, PP, PV>(vx, L::LDX, R * L::LDX, xb + (long long)j0 * a.x_t,
                         a.x_t, rows, a.P, dt_s + j0, w_s + j0);
        __syncthreads();
        // S_c[n][p] += sum_j B[j][n] v[j][p]: warp w owns columns 16w..16w+15
#pragma unroll
        for (int ks = 0; ks < R / 16; ++ks) {
            if constexpr (PC == 3) {
                auto Af = [&](int m, int k) {
                    return rec3(bk + k * L::LDB + m, R * L::LDB);
                };
                auto Bf = [&](int k, int n) {
                    return rec3(vx + k * L::LDX + n, R * L::LDX);
                };
#pragma unroll
                for (int m = 0; m < MT; ++m)
#pragma unroll
                    for (int t = 0; t < 2; ++t)
                        fma16(acc[m][t], Af, Bf, m * 16, warp * 16 + t * 8,
                              ks * 16);
                continue;
            }
            uint32_t bq[PV][4];
#pragma unroll
            for (int q = 0; q < PV; ++q)
                frag_b_kn(bq[q], vx + q * R * L::LDX, L::LDX, ks * 16,
                          warp * 16);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                uint32_t aq[PC][4];
#pragma unroll
                for (int q = 0; q < PC; ++q)
                    frag_a_t(aq[q], bk + q * R * L::LDB, L::LDB, m * 16,
                             ks * 16);
                mma_pieces<PC, PV>(acc[m][0], aq, bq, 0);
                mma_pieces<PC, PV>(acc[m][1], aq, bq, 1);
            }
        }
    }

    const int g = lane >> 2;
    const int tg = lane & 3;
    float* out = ws_state + ((long long)bh * a.nc + c) * a.N * a.P;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = n0 + m * 16 + g + (e >> 1) * 8;
                const int p = warp * 16 + t * 8 + 2 * tg + (e & 1);
                if (n < a.N && p < a.P) out[n * a.P + p] = acc[m][t][e];
            }
}

// -------------------------------------------------------------- 2. outputs
template <typename T, int NP, int PV>
struct OutLayout {                         // shared memory, in bytes
    static constexpr int PC = Pieces<T>::value;
    static constexpr int LDC = NP + PADH;  // C rows of the block: [i][n]
    static constexpr int LDS = PP + PADH;  // S_in: [n][p], NP rows
    static constexpr int LDX = PP + PADH;  // xdt of a key block: [j][p]
    static constexpr int CI = 0;
    static constexpr int U = CI + PC * R * LDC * 2;     // S_in, then X_j
    static constexpr int SIN_BYTES = PV * NP * LDS * 2;
    static constexpr int XJ = U;
    static constexpr int KEY_BYTES = PV * R * LDX * 2;
    static constexpr int CS = U + (SIN_BYTES > KEY_BYTES ? SIN_BYTES
                                                          : KEY_BYTES);
    static constexpr int DT = CS + MAX_CHUNK * 4;
    static constexpr int LDSC = R + 4;     // float32: the scores, (R, R)
    static constexpr int SC = DT + MAX_CHUNK * 4;
    static constexpr int BYTES = SC + (PC == 3 ? R * LDSC * 4 : 0);
};

template <typename T, int NP, int PV>
__global__ void __launch_bounds__(kThreads, 4)
ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ Cm, T* __restrict__ y,
               float* __restrict__ state, const float* __restrict__ ws_state,
               const float* __restrict__ ws_cs,
               const float* __restrict__ ws_cb, Args a) {
    using L = OutLayout<T, NP, PV>;
    constexpr int PC = L::PC;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* ci = reinterpret_cast<bf16*>(smem + L::CI);
    bf16* s_in = reinterpret_cast<bf16*>(smem + L::U);
    bf16* xj = reinterpret_cast<bf16*>(smem + L::XJ);
    float* cs_s = reinterpret_cast<float*>(smem + L::CS);
    float* dt_s = reinterpret_cast<float*>(smem + L::DT);
    float* sc = reinterpret_cast<float*>(smem + L::SC);

    const int bh = blockIdx.x;
    const int c = blockIdx.y;
    const int ib = (int)gridDim.z - 1 - (int)blockIdx.z;   // heavy first
    const int i0 = ib * R;
    const int b = bh / a.H;
    const int h = bh - b * a.H;
    const int c0 = c * a.Q;
    const int Qe = min(a.Q, a.T - c0);
    if (i0 >= Qe) return;                  // past a short last chunk
    const int rows_i = min(R, Qe - i0);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;

    const float* csc = ws_cs + ((long long)bh * a.nc + c) * a.Q;
    const float* dtc = dt + b * a.dt_b + (long long)c0 * a.dt_t + h;
    for (int i = tid; i < i0 + R; i += kThreads) {   // past Qe: the last cs
        cs_s[i] = csc[min(i, Qe - 1)];
        dt_s[i] = i < Qe ? dtc[(long long)i * a.dt_t] : 0.f;
    }
    stage<R, NP, PC>(ci, L::LDC, R * L::LDC,
                     Cm + b * a.c_b + (long long)(c0 + i0) * a.c_t, a.c_t,
                     rows_i, a.N, nullptr, nullptr);
    const bool last = c == a.nc - 1 && ib == 0;   // writes the final state
    if (c > 0 || last)
        stage_state<NP, PV>(s_in, L::LDS, NP * L::LDS, ws_state, ws_cs, bh,
                            c, c > 0, last ? state : nullptr, a);
    __syncthreads();

    // ---- y = exp(cs) (C @ S_in): warp w owns rows 16w..16w+15 of the block
    float yacc[PP / 8][4];
#pragma unroll
    for (int t = 0; t < PP / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[t][e] = 0.f;
    if (c > 0) {
#pragma unroll
        for (int ks = 0; ks < NP / 16; ++ks) {
            if constexpr (PC == 3) {
                auto Af = [&](int m, int k) {
                    return rec3(ci + m * L::LDC + k, R * L::LDC);
                };
                auto Bf = [&](int k, int n) {
                    return rec3(s_in + k * L::LDS + n, NP * L::LDS);
                };
#pragma unroll
                for (int t = 0; t < PP / 8; ++t)
                    fma16(yacc[t], Af, Bf, warp * 16, t * 8, ks * 16);
                continue;
            }
            uint32_t aq[PC][4];
#pragma unroll
            for (int q = 0; q < PC; ++q)
                frag_a(aq[q], ci + q * R * L::LDC, L::LDC, warp * 16, ks * 16);
#pragma unroll
            for (int np = 0; np < PP / 16; ++np) {
                uint32_t bq[PV][4];
#pragma unroll
                for (int q = 0; q < PV; ++q)
                    frag_b_kn(bq[q], s_in + q * NP * L::LDS, L::LDS, ks * 16,
                              np * 16);
                mma_pieces<PC, PV>(yacc[2 * np], aq, bq, 0);
                mma_pieces<PC, PV>(yacc[2 * np + 1], aq, bq, 1);
            }
        }
        const float e0 = expf(cs_s[i0 + warp * 16 + g]);
        const float e1 = expf(cs_s[i0 + warp * 16 + g + 8]);
#pragma unroll
        for (int t = 0; t < PP / 8; ++t) {
            yacc[t][0] *= e0;
            yacc[t][1] *= e0;
            yacc[t][2] *= e1;
            yacc[t][3] *= e1;
        }
    }

    // ---- y += (C B_j^T . L) @ xdt_j over the key blocks j <= i, C B_j^T
    // read from the tiles the state kernel wrote for every head
    const T* xb = x + b * a.x_b + (long long)c0 * a.x_t + h * a.x_h;
    const int Qp = (int)gridDim.z * R;
    const float* cbt = ws_cb + ((long long)(b * a.nc + c) * Qp + i0
                                + warp * 16 + g) * Qp + 2 * tg;
    for (int jb = 0; jb <= ib; ++jb) {
        const int j0 = jb * R;
        const int rows_j = min(R, Qe - j0);
        // scores s (16 x 64 per warp): s[t][0..1] row g, [2..3] row g + 8,
        // columns 8t + 2tg + {0, 1}
        float s[R / 8][4];
#pragma unroll
        for (int t = 0; t < R / 8; ++t) {
            const float2 u = *reinterpret_cast<const float2*>(
                cbt + j0 + t * 8);
            const float2 w = *reinterpret_cast<const float2*>(
                cbt + 8 * Qp + j0 + t * 8);
            s[t][0] = u.x;
            s[t][1] = u.y;
            s[t][2] = w.x;
            s[t][3] = w.y;
        }
        __syncthreads();                   // S_in or the last key block used
        stage<R, PP, PV>(xj, L::LDX, R * L::LDX, xb + (long long)j0 * a.x_t,
                         a.x_t, rows_j, a.P, dt_s + j0, nullptr);
        __syncthreads();

        // decay exp(cs_i - cs_j) for j <= i, zero above the diagonal:
        // s[t][0..1] belong to row g, s[t][2..3] to row g + 8, columns
        // 8t + 2tg + {0, 1}
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int il = warp * 16 + g + half * 8;
            const float csi = cs_s[i0 + il];
#pragma unroll
            for (int t = 0; t < R / 8; ++t)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int jl = t * 8 + 2 * tg + e;
                    const bool keep = jb < ib || jl <= il;
                    const float d = csi - cs_s[j0 + jl];
                    // float32 inputs: expf, whose range reduction keeps
                    // the relative error near one unit; exp2 of d log2(e)
                    // rounds the product first, an error of |d| 2^-24
                    // (1e-6 at d = -20) that bf16's y never sees
                    const float L = PC == 3 ? expf(d) : fast_exp2(d * LOG2E);
                    s[t][half * 2 + e] = keep ? s[t][half * 2 + e] * L : 0.f;
                }
        }
        if constexpr (PC == 3) {           // float32: through shared memory
#pragma unroll
            for (int t = 0; t < R / 8; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    sc[(warp * 16 + g + (e >> 1) * 8) * L::LDSC + t * 8
                       + 2 * tg + (e & 1)] = s[t][e];
            __syncwarp();
            auto Af = [&](int m, int k) { return sc[m * L::LDSC + k]; };
            auto Bf = [&](int k, int n) {
                return rec3(xj + k * L::LDX + n, R * L::LDX);
            };
#pragma unroll
            for (int ks = 0; ks < R / 16; ++ks)
#pragma unroll
                for (int t = 0; t < PP / 8; ++t)
                    fma16(yacc[t], Af, Bf, warp * 16, t * 8, ks * 16);
            continue;
        }
        // y += s @ xdt_j: two neighbouring score tiles are the A fragment of
        // a 16-key step, split into PV pieces in registers
#pragma unroll
        for (int ks = 0; ks < R / 16; ++ks) {
            uint32_t pa[PV][4];
            pack_pieces<PV>(&pa[0][0], 4, s[2 * ks][0], s[2 * ks][1]);
            pack_pieces<PV>(&pa[0][1], 4, s[2 * ks][2], s[2 * ks][3]);
            pack_pieces<PV>(&pa[0][2], 4, s[2 * ks + 1][0], s[2 * ks + 1][1]);
            pack_pieces<PV>(&pa[0][3], 4, s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
            for (int np = 0; np < PP / 16; ++np) {
                uint32_t bq[PV][4];
#pragma unroll
                for (int q = 0; q < PV; ++q)
                    frag_b_kn(bq[q], xj + q * R * L::LDX, L::LDX, ks * 16,
                              np * 16);
                mma_pieces<PV, PV>(yacc[2 * np], pa, bq, 0);
                mma_pieces<PV, PV>(yacc[2 * np + 1], pa, bq, 1);
            }
        }
    }

    // ---- y rows of the block, rounded once to x's type
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int il = warp * 16 + g + half * 8;
        if (il >= rows_i) continue;
        T* yr = y + (((long long)b * a.T + c0 + i0 + il) * a.H + h) * a.P;
#pragma unroll
        for (int t = 0; t < PP / 8; ++t)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int p = t * 8 + 2 * tg + e;
                if (p < a.P) store(yr + p, yacc[t][half * 2 + e]);
            }
    }
}

template <typename T, int NP>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, float* ws_state,
           float* ws_cs, float* ws_cb, const Args& a, cudaStream_t stream) {
    constexpr int MB = NP < 64 ? NP : 64;  // state rows per block
    constexpr int S1 = StateLayout<T, MB>::BYTES;
    constexpr int S2 = CBLayout<T, NP>::BYTES;
    constexpr int K1_BYTES = S1 > S2 ? S1 : S2;
    constexpr int PV = OutPieces<T>::value;
    using OL = OutLayout<T, NP, PV>;
    auto k1 = ssd_state_kernel<T, NP>;
    auto k3 = ssd_out_kernel<T, NP, PV>;
    static int set1[32] = {}, set3[32] = {};
    int e = allow_smem(k1, K1_BYTES, set1);
    if (e == 0) e = allow_smem(k3, OL::BYTES, set3);
    if (e != 0) return e;
    const int row_blocks = ((a.Q < a.T ? a.Q : a.T) + R - 1) / R;
    const int tiles = a.B * row_blocks * (row_blocks + 1) / 2;
    const unsigned bhs = (unsigned)(a.B * a.H);
    k1<<<dim3(bhs + tiles, a.nc, NP / MB), kThreads, K1_BYTES, stream>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
        (const T*)Cm, ws_state, ws_cs, ws_cb, a);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    k3<<<dim3(bhs, a.nc, row_blocks), kThreads, OL::BYTES, stream>>>(
        (const T*)x, (const float*)dt, (const T*)Cm, (T*)y, (float*)state,
        ws_state, ws_cs, ws_cb, a);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_np(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, void* y, void* state, float* ws_state,
                float* ws_cs, float* ws_cb, const Args& a, cudaStream_t s) {
    const int np = a.N <= 32 ? 32 : a.N;     // 8, 16, 32 run padded to 32
    if (np == 32)
        return launch<T, 32>(x, dt, A, Bm, Cm, y, state, ws_state, ws_cs,
                             ws_cb, a, s);
    if (np == 64)
        return launch<T, 64>(x, dt, A, Bm, Cm, y, state, ws_state, ws_cs,
                             ws_cb, a, s);
    if (np == 128)
        return launch<T, 128>(x, dt, A, Bm, Cm, y, state, ws_state, ws_cs,
                              ws_cb, a, s);
    return -1;
}

}  // namespace

// x: (B, T, H, P) through (batch, seq, head) strides; dt: (B, T, H) float32
// through (batch, seq) strides; A: (H,) float32; Bm, Cm: (B, T, N) through
// (batch, seq) strides; innermost stride 1 everywhere.  y: (B, T, H, P)
// contiguous, in x's type; state: (B, H, N, P) float32, contiguous.
// Float32 workspaces, all overwritten: ws_state of B*H*n_chunks*N*P
// values, ws_cs of B*H*n_chunks*chunk, ws_cb of B*n_chunks*Qp*Qp with Qp =
// 64 * ceil(min(chunk, T) / 64).  chunk: 1 .. 256 positions, n_chunks ==
// ceil(T / chunk).  N in {8, 16, 32, 64, 128}, P in {8, 16, 32, 64}.
// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  Returns the
// first failed launch's cudaError_t (0 = both launched), or a negative code
// for arguments the kernels do not take.
extern "C" int rt_ssd_scan(
        const void* x, const void* dt, const void* A, const void* Bm,
        const void* Cm, void* y, void* state, void* ws_state, void* ws_cs,
        void* ws_cb, int B, int T, int H, int P, int N, int chunk,
        int n_chunks, long long x_b, long long x_t, long long x_h,
        long long dt_b, long long dt_t, long long b_b, long long b_t,
        long long c_b, long long c_t, int dtype, void* stream) {
    if (B <= 0 || T <= 0 || H <= 0) return -2;
    if (chunk <= 0 || chunk > MAX_CHUNK) return -3;
    if (n_chunks != (T + chunk - 1) / chunk || n_chunks > 65535) return -3;
    if (N != 8 && N != 16 && N != 32 && N != 64 && N != 128) return -1;
    if (P != 8 && P != 16 && P != 32 && P != 64) return -1;
    if ((long long)B * H + (long long)B * 10 > 2147483647LL) return -2;
    const Args a = {B, T, H, P, N, chunk, n_chunks, x_b, x_t, x_h, dt_b,
                    dt_t, b_b, b_t, c_b, c_t};
    float* wss = (float*)ws_state;
    float* wcs = (float*)ws_cs;
    float* wcb = (float*)ws_cb;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch_np<float>(x, dt, A, Bm, Cm, y, state, wss, wcs, wcb,
                                  a, s);
    if (dtype == 1)
        return dispatch_np<bf16>(x, dt, A, Bm, Cm, y, state, wss, wcs, wcb,
                                 a, s);
    return -1;
}
