// Fusion loss (decision-level fusion + softmax cross-entropy), forward and
// backward, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// ../build.py; the Python wrappers live in ../ops.py and the plain PyTorch
// versions in ../ref.py.
//
// Replaces the JAX package's Pallas TPU kernels
//   src/repro/kernels/fusion_loss/kernel.py  _fwd_kernel / fusion_loss_fwd_pallas
//   src/repro/kernels/fusion_loss/kernel.py  _bwd_kernel / fusion_loss_bwd_pallas
// and computes what they compute, for a whole client cohort at once:
//
//   fused[r,v]     = Σ_m a[m,r]·x_m[r,v] / max(Σ_m a[m,r], 1e-9)
//   fused_nll[r]   = lse(fused[r,:]) − fused[r,y_r]
//   modal_nll[m,r] = (lse(x_m[r,:]) − x_m[r,y_r]) · a[m,r]
//   dx_m[r,v]      = df[r]·(a/den)·(p_f − 1{v=y}) + dm[m,r]·a·(p_m − 1{v=y})
//   gsq[k,m]       = Σ_{r∈k,v} dx_m²,  gdot[k,m] = Σ_{r∈k,v} dx_m·df·(p_f − 1{v=y})
//
// Rows r = k·T + t run over the K clients of the cohort; the cohort axis is
// a grid dimension (blockIdx.y), so no vmap is involved.  Each row gets one
// warp; lanes stride over the vocab V and keep an online max/sum per lane
// for the fused mixture and each of the M ≤ 4 heads, combined by a warp
// shuffle.  The kernel masks its own V edge, so nothing is padded.  Up to
// four modality operands arrive as separate pointers in a struct passed by
// value; a broadcast head (seg[m] = S) is a compact [K·B, V] operand read at
// row r / S.
//
// Bound on the card: bytes.  Each call reads the M logit operands once
// (K·M·T·V·4 bytes, plus labels and availability) and, in the backward,
// writes the same amount of gradient; the arithmetic is a handful of
// operations and one or two exp per element, far below the 67 TFLOP/s of
// float32.  At the paper's shape (K=10, T=96, V=6, M=2) that is about 46 KB
// per call — 14 ns at 3.35 TB/s — so in practice each call is bound by the
// launch itself: two launches per round, the forward and the backward.  The
// training step reads no gsq/gdot, so its backward passes no partials buffer
// and launches no reduce; only fusion_loss_grads asks for them, at the cost
// of a third launch.  This design does the simple right thing:
// one pass over the logits in each direction, probabilities never stored.
// Making it fast (a thread per row when V ≤ 32, fusing the loss into the
// cohort step, CUDA graphs) is later work.
//
// gsq/gdot need a sum across blocks; blocks run in no order, so a
// deterministic two-stage reduction takes the place of the TPU's sequential
// grid: each block writes its partials to [K, nblk, M, 2], and a second
// small kernel sums them in a fixed order.  The results are bitwise the same
// from run to run.  With partials == NULL the backward writes only dlogits.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_M 4
#define WARPS 8                    // rows (warps) per block
#define NEG_INF (-1e30f)
#define FULL_MASK 0xffffffffu

struct Operands {
    const float* x[MAX_M];         // [K·T, V] or, for seg[m] = S, [K·B, V]
    int seg[MAX_M];
};

struct Grads {
    float* d[MAX_M];               // [K·T, V] each
};

__device__ __forceinline__ void lse_push(float& m, float& s, float x) {
    if (x > m) {
        s = s * expf(m - x) + 1.0f;
        m = x;
    } else {
        s += expf(x - m);
    }
}

__device__ __forceinline__ void lse_warp_reduce(float& m, float& s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        float m2 = __shfl_xor_sync(FULL_MASK, m, off);
        float s2 = __shfl_xor_sync(FULL_MASK, s, off);
        float mn = fmaxf(m, m2);
        s = s * expf(m - mn) + s2 * expf(m2 - mn);
        m = mn;
    }
}

__device__ __forceinline__ float sum_warp_reduce(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(FULL_MASK, v, off);
    return v;
}

__device__ __forceinline__ const float* operand_row(const Operands& ops,
                                                    int m, long row, int V) {
    long r = ops.seg[m] ? row / ops.seg[m] : row;
    return ops.x[m] + r * (long)V;
}

// ---------------------------------------------------------------------------
// forward: one warp per row; grid (ceil(T / WARPS), K)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(WARPS * 32)
fusion_fwd_kernel(Operands ops, int M, const int* __restrict__ labels,
                  const float* __restrict__ avail, long KT, int T, int V,
                  float* __restrict__ fused_nll, float* __restrict__ modal_nll,
                  float* __restrict__ f_max, float* __restrict__ f_lse,
                  float* __restrict__ m_max, float* __restrict__ m_lse) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + warp;
    if (t >= T) return;                         // whole warp leaves together
    const long row = (long)blockIdx.y * T + t;

    const float* xr[MAX_M];
    float a[MAX_M], mm[MAX_M], sm[MAX_M], gm[MAX_M];
    float den = 0.0f;
#pragma unroll
    for (int m = 0; m < MAX_M; ++m) {
        if (m < M) {
            xr[m] = operand_row(ops, m, row, V);
            a[m] = avail[m * KT + row];
            den += a[m];
        }
        mm[m] = NEG_INF;
        sm[m] = 0.0f;
        gm[m] = 0.0f;
    }
    den = fmaxf(den, 1e-9f);
    const int y = labels[row];
    float mf = NEG_INF, sf = 0.0f, gf = 0.0f;

    for (int v = lane; v < V; v += 32) {
        float num = 0.0f;
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) {
            if (m < M) {
                const float xv = xr[m][v];
                num += a[m] * xv;
                lse_push(mm[m], sm[m], xv);
                if (v == y) gm[m] = xv;
            }
        }
        const float fu = num / den;
        lse_push(mf, sf, fu);
        if (v == y) gf = fu;
    }

    // the gold logit lives in lane y % 32 (lanes stride the vocab by 32)
    const int owner = y & 31;
    lse_warp_reduce(mf, sf);
    gf = __shfl_sync(FULL_MASK, gf, owner);
#pragma unroll
    for (int m = 0; m < MAX_M; ++m) {
        if (m < M) {
            lse_warp_reduce(mm[m], sm[m]);
            gm[m] = __shfl_sync(FULL_MASK, gm[m], owner);
        }
    }
    if (lane == 0) {
        const float fl = mf + logf(sf);
        fused_nll[row] = fl - gf;
        f_max[row] = mf;
        f_lse[row] = fl;
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) {
            if (m < M) {
                const float ml = mm[m] + logf(sm[m]);
                modal_nll[m * KT + row] = (ml - gm[m]) * a[m];
                m_max[m * KT + row] = mm[m];
                m_lse[m * KT + row] = ml;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// backward: same row mapping; per-block partials of gsq/gdot
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(WARPS * 32)
fusion_bwd_kernel(Operands ops, int M, const int* __restrict__ labels,
                  const float* __restrict__ avail,
                  const float* __restrict__ d_fused,
                  const float* __restrict__ d_modal,
                  const float* __restrict__ f_lse,
                  const float* __restrict__ m_lse, long KT, int T, int V,
                  Grads out, float* __restrict__ partials) {
    __shared__ float sh_sq[WARPS][MAX_M];
    __shared__ float sh_dot[WARPS][MAX_M];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + warp;
    float sq[MAX_M], dot[MAX_M];
#pragma unroll
    for (int m = 0; m < MAX_M; ++m) {
        sq[m] = 0.0f;
        dot[m] = 0.0f;
    }

    if (t < T) {                                // warp-uniform
        const long row = (long)blockIdx.y * T + t;
        const float* xr[MAX_M];
        float a[MAX_M], cf[MAX_M], cm[MAX_M], ml[MAX_M];
        float den = 0.0f;
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) {
            if (m < M) {
                xr[m] = operand_row(ops, m, row, V);
                a[m] = avail[m * KT + row];
                den += a[m];
                ml[m] = m_lse[m * KT + row];
                cm[m] = d_modal[m * KT + row] * a[m];
            }
        }
        den = fmaxf(den, 1e-9f);
#pragma unroll
        for (int m = 0; m < MAX_M; ++m)
            if (m < M) cf[m] = a[m] / den;
        const int y = labels[row];
        const float df = d_fused[row];
        const float fl = f_lse[row];

        for (int v = lane; v < V; v += 32) {
            float xv[MAX_M];
            float num = 0.0f;
#pragma unroll
            for (int m = 0; m < MAX_M; ++m) {
                if (m < M) {
                    xv[m] = xr[m][v];
                    num += a[m] * xv[m];
                }
            }
            const float pick = (v == y) ? 1.0f : 0.0f;
            const float base = df * (expf(num / den - fl) - pick);
#pragma unroll
            for (int m = 0; m < MAX_M; ++m) {
                if (m < M) {
                    const float d = cf[m] * base
                                    + cm[m] * (expf(xv[m] - ml[m]) - pick);
                    out.d[m][row * V + v] = d;
                    sq[m] += d * d;
                    dot[m] += d * base;
                }
            }
        }
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) {
            if (m < M) {
                sq[m] = sum_warp_reduce(sq[m]);
                dot[m] = sum_warp_reduce(dot[m]);
            }
        }
    }
    if (partials == nullptr) return;            // uniform over the grid
    if (lane == 0) {
#pragma unroll
        for (int m = 0; m < MAX_M; ++m) {
            sh_sq[warp][m] = sq[m];
            sh_dot[warp][m] = dot[m];
        }
    }
    __syncthreads();
    if (threadIdx.x < M) {
        const int m = threadIdx.x;
        float s = 0.0f, d = 0.0f;
        for (int w = 0; w < WARPS; ++w) {       // fixed order
            s += sh_sq[w][m];
            d += sh_dot[w][m];
        }
        const long p = ((long)blockIdx.y * gridDim.x + blockIdx.x) * M + m;
        partials[2 * p] = s;
        partials[2 * p + 1] = d;
    }
}

// ---------------------------------------------------------------------------
// second stage: gsq/gdot [K, M] from the [K, nblk, M, 2] partials, summed
// over the blocks in a fixed order (one thread per (k, m))
// ---------------------------------------------------------------------------
__global__ void fusion_partials_reduce_kernel(const float* __restrict__ partials,
                                              int K, int nblk, int M,
                                              float* __restrict__ gsq,
                                              float* __restrict__ gdot) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= K * M) return;
    const int k = i / M, m = i % M;
    float s = 0.0f, d = 0.0f;
    for (int b = 0; b < nblk; ++b) {
        const long p = ((long)k * nblk + b) * M + m;
        s += partials[2 * p];
        d += partials[2 * p + 1];
    }
    gsq[i] = s;
    gdot[i] = d;
}

// ---------------------------------------------------------------------------
// C interface: every pointer is a device pointer (or NULL for an unused
// operand slot, or for the backward's partials when gsq/gdot are not
// wanted), the stream is a cudaStream_t; each returns the launch's
// cudaGetLastError() as an int (0 = launched)
// ---------------------------------------------------------------------------
static Operands make_operands(const void* x0, const void* x1, const void* x2,
                              const void* x3, int s0, int s1, int s2, int s3) {
    Operands ops;
    ops.x[0] = (const float*)x0;
    ops.x[1] = (const float*)x1;
    ops.x[2] = (const float*)x2;
    ops.x[3] = (const float*)x3;
    ops.seg[0] = s0;
    ops.seg[1] = s1;
    ops.seg[2] = s2;
    ops.seg[3] = s3;
    return ops;
}

extern "C" int fusion_loss_fwd(const void* x0, const void* x1, const void* x2,
                               const void* x3, int s0, int s1, int s2, int s3,
                               int M, const void* labels, const void* avail,
                               int K, int T, int V, void* fused_nll,
                               void* modal_nll, void* f_max, void* f_lse,
                               void* m_max, void* m_lse, void* stream) {
    Operands ops = make_operands(x0, x1, x2, x3, s0, s1, s2, s3);
    dim3 grid((T + WARPS - 1) / WARPS, K);
    fusion_fwd_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        ops, M, (const int*)labels, (const float*)avail, (long)K * T, T, V,
        (float*)fused_nll, (float*)modal_nll, (float*)f_max, (float*)f_lse,
        (float*)m_max, (float*)m_lse);
    return (int)cudaGetLastError();
}

extern "C" int fusion_loss_bwd_blocks(int T) {
    return (T + WARPS - 1) / WARPS;
}

extern "C" int fusion_loss_bwd(const void* x0, const void* x1, const void* x2,
                               const void* x3, int s0, int s1, int s2, int s3,
                               int M, const void* labels, const void* avail,
                               const void* d_fused, const void* d_modal,
                               const void* f_lse, const void* m_lse, int K,
                               int T, int V, void* d0, void* d1, void* d2,
                               void* d3, void* partials, void* stream) {
    Operands ops = make_operands(x0, x1, x2, x3, s0, s1, s2, s3);
    Grads out;
    out.d[0] = (float*)d0;
    out.d[1] = (float*)d1;
    out.d[2] = (float*)d2;
    out.d[3] = (float*)d3;
    dim3 grid((T + WARPS - 1) / WARPS, K);
    fusion_bwd_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        ops, M, (const int*)labels, (const float*)avail,
        (const float*)d_fused, (const float*)d_modal, (const float*)f_lse,
        (const float*)m_lse, (long)K * T, T, V, out, (float*)partials);
    return (int)cudaGetLastError();
}

extern "C" int fusion_loss_reduce(const void* partials, int K, int nblk,
                                  int M, void* gsq, void* gdot, void* stream) {
    const int n = K * M;
    const int threads = 128;
    fusion_partials_reduce_kernel<<<(n + threads - 1) / threads, threads, 0,
                                    (cudaStream_t)stream>>>(
        (const float*)partials, K, nblk, M, (float*)gsq, (float*)gdot);
    return (int)cudaGetLastError();
}
