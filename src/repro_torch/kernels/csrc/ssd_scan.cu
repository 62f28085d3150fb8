// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_scan_pallas (_kernel) of
// src/repro/kernels/ssd_scan/kernel.py.
//
// What it computes, as the TPU kernel does, for each (batch, head) and each
// chunk of Q positions in order, with a float32 state S (N, P) that starts
// at zero and is carried from chunk to chunk:
//   dA = dt * A, cs = its inclusive cumsum over the chunk, xdt = x * dt;
//   y  = ((C B^T) . L) @ xdt with L[i, j] = exp(cs_i - cs_j) for i >= j,
//        else 0;
//   y += exp(cs) * (C @ S);
//   S <- exp(cs_last) * S + B^T @ (xdt * exp(cs_last - cs)).
// All arithmetic is float32 (the cumsum accumulates in float64, see below);
// y is rounded to x's type once, at the end, and the final S is written in
// float32.  B and C (n_groups = 1) are shared by
// every head of a batch row; A is one scalar per head.
//
// Decays are only ever taken of differences that are <= 0: exp(cs_i - cs_j)
// for i >= j, exp(cs_last - cs_j), exp(cs_i), exp(cs_last).  The cumulative
// dA of a 256-position chunk reaches about -180 at the served widths, so the
// factored form exp(cs_i) * exp(-cs_j) would overflow float32.
//
// Bound, at Mamba2-1.3B's served shape (batch 1, 512 positions, 64 heads of
// 64, N = 128, chunk 256): the call moves about 10.9 MB (3.2 us at 3.35
// TB/s) and needs about 1.6 GFLOP in its least form (C B^T once per batch
// row and chunk, lower triangles only), 1.7 us at the bf16 tensor-core rate:
// bytes bound it.  This first version does scalar float32 FMAs and
// recomputes C B^T for every head and column tile (about 2.2 GFLOP at batch
// 1), so it is bound by its own arithmetic, far above that bound.
//
// Design:
//  * The TPU kernel's sequential chunk axis is a loop inside one block; the
//    (N, P) state stays in shared memory across the loop.
//  * grid (B*H, P / PT): one block per (batch, head) and tile of PT columns
//    of P.  The columns of y and of S are independent, so a 64-wide P may
//    run as two 32-wide tiles, each recomputing C B^T: the wrapper does so
//    when B*H alone would leave SMs idle (64 blocks for 132 SMs at batch 1).
//  * A (Q, Q) float32 score tile is 256 KB at Q = 256, more than a block may
//    hold, so the chunk is cut into row blocks of R = 64 positions.  Row
//    block i takes C_i @ S, then for each key block j <= i the scores
//    C_i B_j^T (64 x 64, decay and causal mask applied, blocks above the
//    diagonal never computed) times xdt_j.  The state update then runs over
//    the key blocks once more with xdt weighted by exp(cs_last - cs).
//  * Every product is the same 256-thread register tile: a 16 x 16 thread
//    grid, each thread MR rows x NC columns strided by 16, operands in
//    shared memory as float32, rows padded by 4 floats so the A operand's
//    two rows per warp fall in different banks.
//  * The cumsum is a block scan: one position per thread (Q <= 256), warp
//    shuffles, then the warp totals, accumulated in float64 and rounded to
//    float32 once.  A float32 scan drifts by a few units in the last place
//    of |cs| (up to ~400 at the served widths), which moves y by ~1e-5 of
//    its largest value; the plain version accumulates in float64 too.
//  * x is read in the model's (B, T, H, P) layout through strides, B and C
//    through their (batch, seq) strides: no transpose or padded copy.
//    Positions past T (a ragged last chunk, or T < chunk) load as zeros with
//    dt = 0, which leaves the state unchanged and writes no y row.
//  * State dims N in {8, 16, 32, 64, 128} run padded to NP in {32, 64, 128}
//    with zero rows, head dims P in {8, 16, 32, 64} padded to a tile of 32
//    or 64 with zero columns.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr int R = 64;             // positions per row (and key) block
constexpr int MAX_CHUNK = 256;    // one position per thread in the cumsum
constexpr int PAD = 4;            // floats added to rows read as A operand

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

struct Args {
    int B, T, H, P, N, Q;
    long long x_b, x_t, x_h;      // x (B, T, H, P), innermost stride 1
    long long dt_b, dt_t;         // dt (B, T, H), innermost stride 1
    long long b_b, b_t, c_b, c_t; // Bm, Cm (B, T, N), innermost stride 1
};

template <int NP, int PT>
struct Layout {                   // shared memory, in floats
    static constexpr int LDC = NP + PAD;   // C_i rows: (R, NP)
    static constexpr int LDB = R + PAD;    // B_j^T rows: (NP, R)
    static constexpr int LDS = R + PAD;    // scores: (R, R)
    static constexpr int S = 0;                          // (NP, PT)
    static constexpr int C = S + NP * PT;
    static constexpr int BT = C + R * LDC;
    static constexpr int X = BT + NP * LDB;              // (R, PT)
    static constexpr int SC = X + R * PT;
    static constexpr int CS = SC + R * LDS;              // cumsum
    static constexpr int DT = CS + MAX_CHUNK;
    static constexpr int W = DT + MAX_CHUNK;             // exp(cs_last - cs)
    static constexpr int WSUM = W + MAX_CHUNK;           // warp totals,
    static constexpr int FLOATS = WSUM + 2 * (kThreads / 32);  // as double
    static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// acc[r][c] += sum_k a[(ty + 16 r) * lda + k] * b[k * ldb + tx + 16 c]
template <int MR, int NC>
__device__ __forceinline__ void mac(float (&acc)[MR][NC],
                                   const float* __restrict__ a, int lda,
                                   const float* __restrict__ b, int ldb,
                                   int K, int ty, int tx) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
        float av[MR], bv[NC];
#pragma unroll
        for (int r = 0; r < MR; ++r) av[r] = a[(ty + 16 * r) * lda + k];
#pragma unroll
        for (int c = 0; c < NC; ++c) bv[c] = b[k * ldb + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c)
                acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
}

template <int MR, int NC>
__device__ __forceinline__ void zero(float (&acc)[MR][NC]) {
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
}

// C rows t0 .. t0 + R of this chunk as dst[r * ld + n]; rows at or past
// `rows` and columns at or past N are zero.
template <typename T, int NP>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          long long st_t, int t0, int rows,
                                          int N) {
    for (int i = threadIdx.x; i < R * NP; i += kThreads) {
        const int r = i / NP;
        const int n = i - r * NP;
        dst[r * ld + n] = (r < rows && n < N)
            ? to_f(src[(long long)(t0 + r) * st_t + n]) : 0.f;
    }
}

// The same rows transposed: dst[n * ld + r].
template <typename T, int NP>
__device__ __forceinline__ void load_rows_t(float* dst, int ld,
                                            const T* __restrict__ src,
                                            long long st_t, int t0, int rows,
                                            int N) {
    for (int i = threadIdx.x; i < R * NP; i += kThreads) {
        const int r = i / NP;
        const int n = i - r * NP;
        dst[n * ld + r] = (r < rows && n < N)
            ? to_f(src[(long long)(t0 + r) * st_t + n]) : 0.f;
    }
}

// x dt (times w when w is given) for positions j0 .. j0 + R of the chunk and
// the block's PT columns: dst[j * PT + p].
template <typename T, int PT>
__device__ __forceinline__ void load_xdt(float* dst, const T* __restrict__ xb,
                                         long long x_t, int t0, int j0,
                                         int rows, int pw,
                                         const float* dt_s,
                                         const float* w_s) {
    for (int i = threadIdx.x; i < R * PT; i += kThreads) {
        const int r = i / PT;
        const int p = i - r * PT;
        float v = 0.f;
        if (r < rows && p < pw) {
            v = to_f(xb[(long long)(t0 + r) * x_t + p]) * dt_s[j0 + r];
            if (w_s != nullptr) v *= w_s[j0 + r];
        }
        dst[i] = v;
    }
}

// Inclusive prefix sum over the block, one value per thread.
__device__ __forceinline__ double block_scan(double v, double* wsum) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wsum[w];
    return v;
}

template <typename T, int NP, int PT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state, Args a) {
    using L = Layout<NP, PT>;
    constexpr int NC = PT / 16;          // columns per thread
    constexpr int MS = NP / 16;          // state rows per thread
    const int bh = blockIdx.x;
    const int b = bh / a.H;
    const int h = bh - b * a.H;
    const int p0 = blockIdx.y * PT;
    const int pw = min(PT, a.P - p0);    // live columns of this tile
    const int tid = threadIdx.x;
    const int ty = tid >> 4;
    const int tx = tid & 15;

    extern __shared__ __align__(16) float smem[];
    float* S_s = smem + L::S;
    float* C_s = smem + L::C;
    float* Bt_s = smem + L::BT;
    float* X_s = smem + L::X;
    float* Sc_s = smem + L::SC;
    float* cs_s = smem + L::CS;
    float* dt_s = smem + L::DT;
    float* w_s = smem + L::W;
    // WSUM is an even offset from a 16-byte aligned base: 8-byte aligned
    double* wsum = reinterpret_cast<double*>(smem + L::WSUM);

    for (int i = tid; i < NP * PT; i += kThreads) S_s[i] = 0.f;
    const float Ah = A[h];
    const T* xb = x + b * a.x_b + h * a.x_h + p0;
    const float* dtb = dt + b * a.dt_b + h;
    const T* Bb = Bm + b * a.b_b;
    const T* Cb = Cm + b * a.c_b;

    for (int c0 = 0; c0 < a.T; c0 += a.Q) {
        const int Qe = min(a.Q, a.T - c0);   // live positions of the chunk
        __syncthreads();                     // the last chunk is consumed
        const float d = tid < Qe ? dtb[(long long)(c0 + tid) * a.dt_t] : 0.f;
        const float cs = (float)block_scan((double)(d * Ah), wsum);
        dt_s[tid] = d;
        cs_s[tid] = cs;
        __syncthreads();
        const float cs_last = cs_s[Qe - 1];
        w_s[tid] = tid < Qe ? expf(cs_last - cs) : 0.f;
        const int nb = (Qe + R - 1) / R;

        // ---- y, one row block of the chunk at a time
        for (int ib = 0; ib < nb; ++ib) {
            const int i0 = ib * R;
            __syncthreads();                 // C_s free
            load_rows<T, NP>(C_s, L::LDC, Cb, a.c_t, c0 + i0, Qe - i0, a.N);
            __syncthreads();
            float acc[4][NC];
            zero(acc);
            mac<4, NC>(acc, C_s, L::LDC, S_s, PT, NP, ty, tx);   // C_i @ S
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float e = expf(cs_s[i0 + ty + 16 * r]);
#pragma unroll
                for (int c = 0; c < NC; ++c) acc[r][c] *= e;
            }
            for (int jb = 0; jb <= ib; ++jb) {
                const int j0 = jb * R;
                __syncthreads();             // Bt_s, X_s, Sc_s free
                load_rows_t<T, NP>(Bt_s, L::LDB, Bb, a.b_t, c0 + j0, Qe - j0,
                                   a.N);
                load_xdt<T, PT>(X_s, xb, a.x_t, c0 + j0, j0, Qe - j0, pw,
                                dt_s, nullptr);
                __syncthreads();
                float sc[4][4];
                zero(sc);
                mac<4, 4>(sc, C_s, L::LDC, Bt_s, L::LDB, NP, ty, tx);
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int i = i0 + ty + 16 * r;
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int j = j0 + tx + 16 * c;
                        Sc_s[(ty + 16 * r) * L::LDS + tx + 16 * c] =
                            i >= j ? sc[r][c] * expf(cs_s[i] - cs_s[j]) : 0.f;
                    }
                }
                __syncthreads();
                mac<4, NC>(acc, Sc_s, L::LDS, X_s, PT, R, ty, tx);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int row = i0 + ty + 16 * r;
                if (row >= Qe) continue;
                T* yr = y + (((long long)b * a.T + c0 + row) * a.H + h) * a.P
                    + p0;
#pragma unroll
                for (int c = 0; c < NC; ++c)
                    if (tx + 16 * c < pw) store(yr + tx + 16 * c, acc[r][c]);
            }
        }

        // ---- S <- exp(cs_last) S + sum_j B_j^T (xdt_j * exp(cs_last - cs_j))
        float sacc[MS][NC];
        zero(sacc);
        for (int jb = 0; jb < nb; ++jb) {
            const int j0 = jb * R;
            __syncthreads();
            load_rows_t<T, NP>(Bt_s, L::LDB, Bb, a.b_t, c0 + j0, Qe - j0,
                               a.N);
            load_xdt<T, PT>(X_s, xb, a.x_t, c0 + j0, j0, Qe - j0, pw, dt_s,
                            w_s);
            __syncthreads();
            mac<MS, NC>(sacc, Bt_s, L::LDB, X_s, PT, R, ty, tx);
        }
        const float decay = expf(cs_last);
#pragma unroll
        for (int r = 0; r < MS; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                float* s = S_s + (ty + 16 * r) * PT + tx + 16 * c;
                *s = decay * *s + sacc[r][c];
            }
    }
    __syncthreads();
    float* sb = state + ((long long)b * a.H + h) * a.N * a.P + p0;
    for (int i = tid; i < NP * PT; i += kThreads) {
        const int n = i / PT;
        const int p = i - n * PT;
        if (n < a.N && p < pw) sb[(long long)n * a.P + p] = S_s[i];
    }
}

template <typename T, int NP, int PT>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, const Args& a,
           cudaStream_t stream) {
    using L = Layout<NP, PT>;
    auto kern = ssd_scan_kernel<T, NP, PT>;
    if (L::BYTES > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)L::BYTES);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.P + PT - 1) / PT));
    kern<<<grid, kThreads, L::BYTES, stream>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
        (const T*)Cm, (T*)y, (float*)state, a);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, void* state, const Args& a, int p_tile,
             cudaStream_t s) {
    const int np = a.N <= 32 ? 32 : a.N;     // 8, 16, 32 run padded to 32
#define RT_CASE(NPV, PTV)                                                     \
    if (np == NPV && p_tile == PTV)                                           \
        return launch<T, NPV, PTV>(x, dt, A, Bm, Cm, y, state, a, s);
    RT_CASE(32, 32) RT_CASE(32, 64) RT_CASE(64, 32) RT_CASE(64, 64)
    RT_CASE(128, 32) RT_CASE(128, 64)
#undef RT_CASE
    return -1;
}

}  // namespace

// x: (B, T, H, P) through (batch, seq, head) strides; dt: (B, T, H) float32
// through (batch, seq) strides; A: (H,) float32; Bm, Cm: (B, T, N) through
// (batch, seq) strides; innermost stride 1 everywhere.  y: (B, T, H, P)
// contiguous, in x's type; state: (B, H, N, P) float32, contiguous.
// chunk: 1 .. 256 positions; p_tile: columns of P per block, 32 or 64, with
// P <= p_tile or P == 64.  N in {8, 16, 32, 64, 128}, P in {8, 16, 32, 64}.
// dtype (of x, Bm, Cm and y): 0 = float32, 1 = bfloat16.  Returns the
// launch's cudaError_t (0 = launched), or a negative code for arguments the
// kernel does not take.
extern "C" int rt_ssd_scan(
        const void* x, const void* dt, const void* A, const void* Bm,
        const void* Cm, void* y, void* state, int B, int T, int H, int P,
        int N, int chunk, int p_tile, long long x_b, long long x_t,
        long long x_h, long long dt_b, long long dt_t, long long b_b,
        long long b_t, long long c_b, long long c_t, int dtype,
        void* stream) {
    if (B <= 0 || T <= 0 || H <= 0) return -2;
    if (chunk <= 0 || chunk > MAX_CHUNK) return -3;
    if (N != 8 && N != 16 && N != 32 && N != 64 && N != 128) return -1;
    if (P != 8 && P != 16 && P != 32 && P != 64) return -1;
    if ((p_tile != 32 && p_tile != 64) || (P > p_tile && P != 64)) return -1;
    if ((long long)B * H > 2147483647LL) return -2;
    const Args a = {B, T, H, P, N, chunk, x_b, x_t, x_h, dt_b, dt_t,
                    b_b, b_t, c_b, c_t};
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return dispatch<float>(x, dt, A, Bm, Cm, y, state, a, p_tile, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, a, p_tile,
                                       s);
    return -1;
}
