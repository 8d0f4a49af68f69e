// Mamba2 SSD intra-chunk contraction, forward, for Hopper (sm_90a).  Plain
// C interface, loaded with ctypes by ../build.py; the Python wrapper, which
// picks the regime and the block's group, lives in ../ops.py and the plain
// PyTorch version in ../ref.py.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py  _kernel / ssd_chunk_pallas
// and computes what it computes, per (batch, chunk, head) with cum the
// within-chunk cumulative sum of dt·A:
//
//   y_diag[t,:] = Σ_{s<=t} exp(cum_t − cum_s) · (C_t·B_s) · x_s
//   state[n,:]  = Σ_s B_s[n] · exp(cum_last − cum_s) · x_s
//
// x [B, nc, Q, nh, hp] (dt-weighted), cum [B, nc, Q, nh], B and C
// [B, nc, Q, N], all float32 and contiguous; y_diag [B, nc, Q, nh, hp] and
// the chunk states [B, nc, nh, N, hp], float32.  The exponent cum_t − cum_s
// is formed only for s <= t: an upper-triangle difference is large and
// positive and its exp overflows (the note in models/mamba2.py).  The
// inter-chunk recurrence and the off-diagonal term stay plain torch
// (../ops.py), as in the JAX package.
//
// What bounds it on this card.  At the training path's shape (B = 960
// client-samples, nc = 4 chunks of Q = 8, nh = 8, hp = 8, N = 16) a call
// reads x, cum, B, C and writes y_diag and the states once, about 36 MB
// (the states 43 % of it), against about 0.09 GFLOP: bytes, 11 µs at
// 3.35 TB/s.  At the JAX configs' chunk (Q = 256, hp = 64, N = 16 or 128)
// the work per chunk grows as Q² and the Q×Q score matrix no longer fits a
// block's shared memory.  Two regimes, one launch per call either way:
//
// * small chunks (Q <= 32): ssd_small_kernel.  One block covers every head
//   of G consecutive (batch·chunk) rows.  Their x, cum, B and C slabs are
//   contiguous and are staged with 16-byte cp.async copies; the lower
//   triangle of C·Bᵀ is formed once per chunk (it does not depend on the
//   head), each head's decay is applied to it once, and y_diag and the
//   chunk's contiguous [nh, N, hp] state slab are written as float4 by
//   neighbouring threads (coalesced).  The wrapper sizes G so that each
//   block has work for its 256 threads and several blocks reside per SM.
//   Where Q, nh, hp / 4 and N are all powers of two (the backbone presets'
//   chunk among them), the index arithmetic of every loop is shifts and
//   masks instead of run-time divisions, which at Q = 8 cost as much as
//   the rest of the kernel.
// * large chunks: ssd_large_kernel<HP>, one grid of two kinds of block,
//   each over a tile of HP of the hp columns (HP the least of 8, 16, 32,
//   64, 128 that covers hp, or 128 with several tiles).
//   A y block owns 64 query rows of one (row, head, column tile) and
//   streams the keys in tiles of 32 (double-buffered cp.async): the 64×32
//   score tile C·Bᵀ, register-blocked over N in float4 steps, is masked,
//   weighted by the decay and folded into the 64×HP accumulator, which
//   stays in registers; no Q×Q matrix is ever held.  A state block owns a
//   tile of N rows of one (row, head, column tile) and forms
//   Bᵀ·(decay ∘ x) as its own tiled product over s.  N is zero-padded to a
//   multiple of 4 in shared memory and the hp columns past hp are zeros:
//   a B/C row or x row that is not a whole number of 16-byte pieces is
//   copied with plain loads instead of cp.async.  All of it is FFMA in
//   float32: TF32 tensor cores would break the float32 tolerance (1e-4)
//   the JAX package holds its kernel to.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SMEM 232448            // bytes of shared memory a block may use
#define SMALL_THREADS 256
#define SMALL_MAX_Q 32
#define TQ 64                      // large: query rows per y block
#define TS 32                      // large: keys (s) per streamed tile

// ---------------------------------------------------------------------------
// cp.async helpers: a 16-byte copy global -> shared, zero-filled when the
// source is out of range
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int n = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ static inline long long ru4(long long n) { return (n + 3) / 4 * 4; }

// ---------------------------------------------------------------------------
// small chunks: all heads of G (batch·chunk) rows per block
// ---------------------------------------------------------------------------
static long long small_floats(int G, int Q, int nh, int hp, int N) {
    return ru4((long long)G * Q * nh * hp)      // x
           + ru4((long long)G * Q * nh)         // cum
           + 2 * ru4((long long)G * Q * N)      // B, C
           + (long long)G * Q * Q               // C·Bᵀ, lower triangle
           + (long long)G * nh * Q              // exp(cum_last − cum_s)
           + (long long)G * nh * (Q * Q + 1);   // W = L ∘ C·Bᵀ per head
}

// copy n contiguous floats into shared memory: 16-byte cp.async where the
// source is aligned, else one float at a time (a uniform branch)
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long n) {
    if ((((uintptr_t)src) & 15) == 0 && (n & 3) == 0) {
        for (long long i = threadIdx.x; i < n / 4; i += blockDim.x)
            cp_async16(dst + 4 * i, src + 4 * i, true);
    } else {
        for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
    }
}

// acc[0..V) += w · xv[0..V), with one 16-byte shared load for V = 4
template <int V>
__device__ __forceinline__ void fma_v(float* acc, float w, const float* xv) {
    if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(xv);
        acc[0] = fmaf(w, q.x, acc[0]);
        acc[1] = fmaf(w, q.y, acc[1]);
        acc[2] = fmaf(w, q.z, acc[2]);
        acc[3] = fmaf(w, q.w, acc[3]);
    } else {
        acc[0] = fmaf(w, xv[0], acc[0]);
    }
}

template <int V>
__device__ __forceinline__ void store_v(float* out, const float* acc) {
    if constexpr (V == 4)
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    else
        out[0] = acc[0];
}

// i / d and i % d for a divisor fixed for the launch: a shift and a mask
// where every divisor of the launch is a power of two (P2), else a
// division.  l is log2(d) when P2.
template <bool P2>
struct Div {
    int d, l;
    __device__ __forceinline__ int q(int i) const { return P2 ? i >> l : i / d; }
    __device__ __forceinline__ int r(int i) const {
        return P2 ? i & (d - 1) : i % d;
    }
};

// V: floats per output item, 4 or 1; P2: Q, nh, hp / V and N are all
// powers of two.
template <int V, bool P2>
__global__ void __launch_bounds__(SMALL_THREADS)
ssd_small_kernel(const float* __restrict__ x, const float* __restrict__ cum,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ st, long long R,
                 int G, Div<P2> dq, Div<P2> dh, Div<P2> dp, Div<P2> dn) {
    const int Q = dq.d, nh = dh.d, PV = dp.d, N = dn.d, hp = PV * V;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int XR = Q * nh * hp, CR = Q * nh, BR = Q * N, QQ = Q * Q;
    const int WH = QQ + 1;                         // per-head stride of W
    float* xs = smem;                              // [G][Q][nh][hp]
    float* cs = xs + ru4((long long)G * XR);       // [G][Q][nh]
    float* bs = cs + ru4((long long)G * CR);       // [G][Q][N]
    float* ccs = bs + ru4((long long)G * BR);      // [G][Q][N]
    float* sc = ccs + ru4((long long)G * BR);      // [G][Q][Q]
    float* dec = sc + G * QQ;                      // [G][nh][Q]
    float* W = dec + G * nh * Q;                   // [G][nh][Q·Q + 1]

    const long long r0 = (long long)blockIdx.x * G;
    const int gn = (int)min((long long)G, R - r0);
    stage(xs, x + r0 * XR, (long long)gn * XR);
    stage(cs, cum + r0 * CR, (long long)gn * CR);
    stage(bs, Bm + r0 * BR, (long long)gn * BR);
    stage(ccs, Cm + r0 * BR, (long long)gn * BR);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // the scores C_t·B_s of each chunk, once for all its heads, and the
    // decay of each (head, s) to the chunk's end
    for (int i = threadIdx.x; i < gn * QQ; i += SMALL_THREADS) {
        const int s = dq.r(i), t = dq.r(dq.q(i)), g = dq.q(dq.q(i));
        if (s <= t) {
            const float* cr = ccs + (g * Q + t) * N;
            const float* br = bs + (g * Q + s) * N;
            float dot = 0.0f;
#pragma unroll 4
            for (int n = 0; n < N; ++n) dot = fmaf(cr[n], br[n], dot);
            sc[i] = dot;
        }
    }
    for (int i = threadIdx.x; i < gn * nh * Q; i += SMALL_THREADS) {
        const int h = dh.r(dq.q(i)), g = dh.q(dq.q(i)), s = dq.r(i);
        const float* cg = cs + g * CR;
        dec[i] = expf(cg[(Q - 1) * nh + h] - cg[s * nh + h]);
    }
    __syncthreads();

    // each head's decay applied to the shared scores, lower triangle only
    for (int i = threadIdx.x; i < gn * nh * QQ; i += SMALL_THREADS) {
        const int s = dq.r(i), r = dq.q(i), t = dq.r(r);
        const int h = dh.r(dq.q(r)), g = dh.q(dq.q(r));
        if (s <= t) {
            const float* cg = cs + g * CR;
            W[(g * nh + h) * WH + t * Q + s] =
                expf(cg[t * nh + h] - cg[s * nh + h]) * sc[g * QQ + t * Q + s];
        }
    }
    __syncthreads();

    // y_diag then the states, V neighbouring floats per item
    const int ny = gn * Q * nh * PV, nst = gn * nh * N * PV;
    for (int i = threadIdx.x; i < ny + nst; i += SMALL_THREADS) {
        float acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = 0.0f;
        if (i < ny) {
            const int p = dp.r(i) * V, r = dp.q(i), h = dh.r(r);
            const int t = dq.r(dh.q(r)), g = dq.q(dh.q(r));
            const float* wr = W + (g * nh + h) * WH + t * Q;
            const float* xg = xs + g * XR + h * hp + p;
#pragma unroll 4
            for (int s = 0; s <= t; ++s)
                fma_v<V>(acc, wr[s], xg + s * nh * hp);
            store_v<V>(y + (r0 + g) * XR + (t * nh + h) * hp + p, acc);
        } else {
            const int j = i - ny;
            const int p = dp.r(j) * V, r = dp.q(j), n = dn.r(r);
            const int h = dh.r(dn.q(r)), g = dh.q(dn.q(r));
            const float* dg = dec + (g * nh + h) * Q;
            const float* bg = bs + g * BR + n;
            const float* xg = xs + g * XR + h * hp + p;
#pragma unroll 4
            for (int s = 0; s < Q; ++s)
                fma_v<V>(acc, bg[s * N] * dg[s], xg + s * nh * hp);
            store_v<V>(st + ((r0 + g) * nh + h) * (long long)N * hp
                           + (long long)n * hp + p, acc);
        }
    }
}

// ---------------------------------------------------------------------------
// large chunks: y tiles of 64 query rows and state tiles, per (row, head,
// tile of HP columns)
// ---------------------------------------------------------------------------
template <int HP>
struct Large {
    static constexpr int TX = HP / 4;               // threads across hp
    static constexpr int RT = HP >= 64 ? 4 : (HP == 32 ? 2 : 1);
    static constexpr int TY = TQ / RT;              // threads across rows
    static constexpr int THREADS = TX * TY;
    static constexpr int SY = THREADS / 8;          // score threads across t
    static constexpr int SR = TQ / SY;              // score rows per thread
    static constexpr int NT = 4 * TY;               // state rows per block
    static_assert(THREADS <= 1024 && TQ % SY == 0 && SR >= 1, "layout");
};

// the column tile of a head dim: the least of 8 .. 128 that covers it
static int large_hp_tile(int hp) {
    int t = 8;
    while (t < hp && t < 128) t *= 2;
    return t;
}

static int large_nt(int HP) { return 4 * (TQ / (HP >= 64 ? 4 : HP == 32 ? 2 : 1)); }

static long long large_floats(int hp, int N) {
    const long long HP = large_hp_tile(hp), NP = ru4(N) + 4, NT = large_nt(HP);
    const long long yb = TQ * NP + TQ + 2 * (TS * NP + TS * HP + TS)
                         + (long long)TQ * (TS + 1);
    const long long sb = 2 * (TS * (NT + 4) + TS * HP + TS);
    return yb > sb ? yb : sb;
}

// rows [r0, r0 + rows) of an operand with rows of w floats at a stride of
// sld into shared memory rows of stride ld: columns [c0, c0 + cols), cols
// a multiple of 4; rows past nrows and columns past w are zeros.  16-byte
// cp.async where w and sld are multiples of 4 (then every piece is 16-byte
// aligned), else plain loads.
__device__ __forceinline__ void tile_in(float* dst, int ld, const float* src,
                                        long long sld, long long r0, int rows,
                                        int nrows, int c0, int cols, int w,
                                        int tid, int nthreads) {
    if (((w | sld) & 3) == 0) {
        const int c4 = cols / 4;
        for (int i = tid; i < rows * c4; i += nthreads) {
            const int r = i / c4, c = 4 * (i % c4);
            const bool in = r < nrows && c0 + c < w;
            cp_async16(dst + r * ld + c,
                       src + (in ? (r0 + r) * sld + c0 + c : 0), in);
        }
    } else {
        for (int i = tid; i < rows * cols; i += nthreads) {
            const int r = i / cols, c = i % cols;
            dst[r * ld + c] = r < nrows && c0 + c < w
                                  ? src[(r0 + r) * sld + c0 + c] : 0.0f;
        }
    }
}

// four neighbouring columns c .. c + 3 of a row of width w: one float4
// store where w is a multiple of 4, else the columns inside w one by one
__device__ __forceinline__ void row_out(float* dst, int c, int w,
                                        const float* a) {
    if ((w & 3) == 0) {
        if (c < w)
            *reinterpret_cast<float4*>(dst + c) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (c + j < w) dst[c + j] = a[j];
    }
}

template <int HP>
__global__ void __launch_bounds__(Large<HP>::THREADS)
ssd_large_kernel(const float* __restrict__ x, const float* __restrict__ cum,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ st,
                 long long n_yblocks, int Q, int nh, int hp, int N) {
    using L = Large<HP>;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int tid = threadIdx.x;
    const int tx = tid % L::TX, ty = tid / L::TX;
    const int N4 = (N + 3) / 4, NP = 4 * N4 + 4;
    const int nq = (Q + TQ - 1) / TQ;
    const int ns = (Q + TS - 1) / TS;
    const int nph = (hp + HP - 1) / HP;
    const long long xs = (long long)nh * hp;         // x's stride per token

    if ((long long)blockIdx.x < n_yblocks) {
        // ---------------- y_diag: query rows t0 .. t0 + TQ, columns p0 ..
        // p0 + HP of (row, head)
        const long long bid = blockIdx.x;
        const int qt = (int)(bid % nq);
        const int p0 = (int)((bid / nq) % nph) * HP;
        const int h = (int)((bid / ((long long)nq * nph)) % nh);
        const long long row = bid / ((long long)nq * nph * nh);
        const long long tok = row * Q;               // the chunk's first token
        const int t0 = qt * TQ;
        float* Cs = smem;                            // [TQ][NP]
        float* ct = Cs + TQ * NP;                    // [TQ]
        float* Bs = ct + TQ;                         // 2 × [TS][NP]
        float* Xs = Bs + 2 * TS * NP;                // 2 × [TS][HP]
        float* cst = Xs + 2 * TS * HP;               // 2 × [TS]
        float* W = cst + 2 * TS;                     // [TQ][TS + 1]

        tile_in(Cs, NP, Cm, N, tok + t0, TQ, Q - t0, 0, 4 * N4, N, tid,
                L::THREADS);
        for (int i = tid; i < TQ; i += L::THREADS)
            ct[i] = t0 + i < Q ? cum[(tok + t0 + i) * nh + h] : 0.0f;

        auto issue = [&](int k, int buf) {
            const int s0 = k * TS;
            tile_in(Bs + buf * TS * NP, NP, Bm, N, tok + s0, TS, Q - s0, 0,
                    4 * N4, N, tid, L::THREADS);
            tile_in(Xs + buf * TS * HP, HP, x + h * (long long)hp, xs,
                    tok + s0, TS, Q - s0, p0, HP, hp, tid, L::THREADS);
            for (int i = tid; i < TS; i += L::THREADS)
                cst[buf * TS + i] =
                    s0 + i < Q ? cum[(tok + s0 + i) * nh + h] : 0.0f;
        };

        // keys up to the tile's last row; later tiles are all masked
        const int nk = (min(Q, t0 + TQ) + TS - 1) / TS;
        issue(0, 0);
        cp_async_commit();

        float acc[L::RT][4];
#pragma unroll
        for (int i = 0; i < L::RT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

        const int sx = tid % 8, sy = tid / 8;
        for (int k = 0; k < nk; ++k) {
            const int buf = k & 1;
            if (k + 1 < nk) issue(k + 1, buf ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
            __syncthreads();

            // score tile: rows sy + SY·i, keys sx + 8·j
            const int s0 = k * TS;
            const float* bb = Bs + buf * TS * NP;
            float sacc[L::SR][4];
#pragma unroll
            for (int i = 0; i < L::SR; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) sacc[i][j] = 0.0f;
            for (int c = 0; c < N4; ++c) {
                float4 cv[L::SR], bv[4];
#pragma unroll
                for (int i = 0; i < L::SR; ++i)
                    cv[i] = *reinterpret_cast<const float4*>(
                        Cs + (sy + L::SY * i) * NP + 4 * c);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    bv[j] = *reinterpret_cast<const float4*>(
                        bb + (sx + 8 * j) * NP + 4 * c);
#pragma unroll
                for (int i = 0; i < L::SR; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        float a = sacc[i][j];
                        a = fmaf(cv[i].x, bv[j].x, a);
                        a = fmaf(cv[i].y, bv[j].y, a);
                        a = fmaf(cv[i].z, bv[j].z, a);
                        a = fmaf(cv[i].w, bv[j].w, a);
                        sacc[i][j] = a;
                    }
            }
#pragma unroll
            for (int i = 0; i < L::SR; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int t = sy + L::SY * i, s = sx + 8 * j;
                    const int gt = t0 + t, gs = s0 + s;
                    W[t * (TS + 1) + s] =
                        (gs <= gt && gt < Q)
                            ? expf(ct[t] - cst[buf * TS + s]) * sacc[i][j]
                            : 0.0f;
                }
            __syncthreads();

            // y += W · x over this key tile
            const float* xb = Xs + buf * TS * HP + 4 * tx;
#pragma unroll 4
            for (int s = 0; s < TS; ++s) {
                const float4 xv = *reinterpret_cast<const float4*>(xb + s * HP);
#pragma unroll
                for (int i = 0; i < L::RT; ++i) {
                    const float w = W[(ty + L::TY * i) * (TS + 1) + s];
                    acc[i][0] = fmaf(w, xv.x, acc[i][0]);
                    acc[i][1] = fmaf(w, xv.y, acc[i][1]);
                    acc[i][2] = fmaf(w, xv.z, acc[i][2]);
                    acc[i][3] = fmaf(w, xv.w, acc[i][3]);
                }
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < L::RT; ++i) {
            const int t = t0 + ty + L::TY * i;
            if (t < Q)
                row_out(y + ((tok + t) * nh + h) * hp, p0 + 4 * tx, hp,
                        acc[i]);
        }
        return;
    }

    // ---------------- states: rows n0 .. n0 + NT, columns p0 .. p0 + HP
    // of (row, head)
    const int nnt = (N + L::NT - 1) / L::NT;
    const long long bid = blockIdx.x - n_yblocks;
    const int nt_i = (int)(bid % nnt);
    const int p0 = (int)((bid / nnt) % nph) * HP;
    const int h = (int)((bid / ((long long)nnt * nph)) % nh);
    const long long row = bid / ((long long)nnt * nph * nh);
    const long long tok = row * Q;
    const int n0 = nt_i * L::NT;
    constexpr int NTP = L::NT + 4;
    float* Bt = smem;                                // 2 × [TS][NTP]
    float* Xs = Bt + 2 * TS * NTP;                   // 2 × [TS][HP]
    float* dec = Xs + 2 * TS * HP;                   // 2 × [TS]
    const float c_last = cum[(tok + Q - 1) * nh + h];

    auto issue = [&](int k, int buf) {
        const int s0 = k * TS;
        tile_in(Bt + buf * TS * NTP, NTP, Bm, N, tok + s0, TS, Q - s0, n0,
                L::NT, N, tid, L::THREADS);
        tile_in(Xs + buf * TS * HP, HP, x + h * (long long)hp, xs, tok + s0,
                TS, Q - s0, p0, HP, hp, tid, L::THREADS);
        for (int i = tid; i < TS; i += L::THREADS)
            dec[buf * TS + i] =
                s0 + i < Q ? expf(c_last - cum[(tok + s0 + i) * nh + h])
                           : 0.0f;
    };

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    issue(0, 0);
    cp_async_commit();
    for (int k = 0; k < ns; ++k) {
        const int buf = k & 1;
        if (k + 1 < ns) issue(k + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* bb = Bt + buf * TS * NTP + ty;
        const float* xb = Xs + buf * TS * HP + 4 * tx;
        const float* db = dec + buf * TS;
#pragma unroll 4
        for (int s = 0; s < TS; ++s) {
            const float4 xv = *reinterpret_cast<const float4*>(xb + s * HP);
            const float d = db[s];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float b = bb[s * NTP + L::TY * i] * d;
                acc[i][0] = fmaf(b, xv.x, acc[i][0]);
                acc[i][1] = fmaf(b, xv.y, acc[i][1]);
                acc[i][2] = fmaf(b, xv.z, acc[i][2]);
                acc[i][3] = fmaf(b, xv.w, acc[i][3]);
            }
        }
        __syncthreads();
    }
    float* sb = st + (row * nh + h) * (long long)N * hp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int n = n0 + ty + L::TY * i;
        if (n < N) row_out(sb + (long long)n * hp, p0 + 4 * tx, hp, acc[i]);
    }
}

template <int HP>
static int launch_large(const float* x, const float* cum, const float* Bm,
                        const float* Cm, float* y, float* st, long long R,
                        int Q, int nh, int hp, int N, size_t smem,
                        cudaStream_t stream) {
    using L = Large<HP>;
    const long long per = R * nh * ((hp + HP - 1) / HP);
    const long long ny = per * ((Q + TQ - 1) / TQ);
    const long long nst = per * ((N + L::NT - 1) / L::NT);
    if (ny + nst > 2147483647LL) return -3;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            ssd_large_kernel<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    ssd_large_kernel<HP><<<(unsigned)(ny + nst), L::THREADS, smem, stream>>>(
        x, cum, Bm, Cm, y, st, ny, Q, nh, hp, N);
    return (int)cudaGetLastError();
}

static bool pow2(int n) { return (n & (n - 1)) == 0; }
static int log2i(int n) { int l = 0; while ((1 << l) < n) ++l; return l; }

template <int V, bool P2>
static int launch_small(const float* x, const float* cum, const float* Bm,
                        const float* Cm, float* y, float* st, long long R,
                        int G, int Q, int nh, int hp, int N, size_t smem,
                        cudaStream_t stream) {
    auto kern = ssd_small_kernel<V, P2>;
    const long long nblocks = (R + G - 1) / G;
    if (nblocks > 2147483647LL) return -3;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const Div<P2> dq{Q, log2i(Q)}, dh{nh, log2i(nh)},
        dp{hp / V, log2i(hp / V)}, dn{N, log2i(N)};
    kern<<<(unsigned)nblocks, SMALL_THREADS, smem, stream>>>(
        x, cum, Bm, Cm, y, st, R, G, dq, dh, dp, dn);
    return (int)cudaGetLastError();
}

// Shared memory one block of the regime needs (0 small, 1 large), in
// bytes; -1 for a shape the regime does not take.
extern "C" int ssd_chunk_smem_bytes(int regime, int G, int Q, int nh,
                                    int hp, int N) {
    long long b = -1;
    if (regime == 0 && Q <= SMALL_MAX_Q && G >= 1)
        b = 4 * small_floats(G, Q, nh, hp, N);
    if (regime == 1) b = 4 * large_floats(hp, N);
    return b > 2147483647LL ? -1 : (int)b;
}

extern "C" int ssd_chunk_max_smem_bytes(void) { return MAX_SMEM; }

// Returns a cudaError_t, or a negative code for arguments the kernel
// refuses: -1 a non-positive size, -2 a regime that does not take the
// shape or needs more shared memory than a block has, -3 too many blocks,
// -4 an operand not aligned to 16 bytes (large regime).
extern "C" int ssd_chunk_fwd(const void* x, const void* cum, const void* Bm,
                             const void* Cm, void* y, void* st, int Bsz,
                             int nc, int Q, int nh, int hp, int N, int regime,
                             int G, void* stream) {
    if (Bsz <= 0 || nc <= 0 || Q <= 0 || nh <= 0 || hp <= 0 || N <= 0)
        return -1;
    const int smem = ssd_chunk_smem_bytes(regime, G, Q, nh, hp, N);
    if (smem < 0 || smem > MAX_SMEM) return -2;
    const long long R = (long long)Bsz * nc;
    const float *fx = (const float*)x, *fc = (const float*)cum,
                *fb = (const float*)Bm, *fcc = (const float*)Cm;
    float *fy = (float*)y, *fs = (float*)st;
    cudaStream_t s = (cudaStream_t)stream;
    if (regime == 0) {
        const int V = hp % 4 == 0 ? 4 : 1;
        const bool p2 = pow2(Q) && pow2(nh) && pow2(hp / V) && pow2(N);
        if (V == 4)
            return p2 ? launch_small<4, true>(fx, fc, fb, fcc, fy, fs, R, G, Q,
                                              nh, hp, N, (size_t)smem, s)
                      : launch_small<4, false>(fx, fc, fb, fcc, fy, fs, R, G,
                                               Q, nh, hp, N, (size_t)smem, s);
        return p2 ? launch_small<1, true>(fx, fc, fb, fcc, fy, fs, R, G, Q,
                                          nh, hp, N, (size_t)smem, s)
                  : launch_small<1, false>(fx, fc, fb, fcc, fy, fs, R, G, Q,
                                           nh, hp, N, (size_t)smem, s);
    }
    const uintptr_t any = (uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm
                          | (uintptr_t)y | (uintptr_t)st;
    if (any & 15) return -4;
    switch (large_hp_tile(hp)) {
        case 8: return launch_large<8>(fx, fc, fb, fcc, fy, fs, R, Q, nh, hp, N, (size_t)smem, s);
        case 16: return launch_large<16>(fx, fc, fb, fcc, fy, fs, R, Q, nh, hp, N, (size_t)smem, s);
        case 32: return launch_large<32>(fx, fc, fb, fcc, fy, fs, R, Q, nh, hp, N, (size_t)smem, s);
        case 64: return launch_large<64>(fx, fc, fb, fcc, fy, fs, R, Q, nh, hp, N, (size_t)smem, s);
        case 128: return launch_large<128>(fx, fc, fb, fcc, fy, fs, R, Q, nh, hp, N, (size_t)smem, s);
    }
    return -2;
}
