// Mamba2 SSD intra-chunk contraction, forward, for Hopper (sm_90a).  Plain
// C interface, loaded with ctypes by ../build.py; the Python wrapper lives
// in ../ops.py and the plain PyTorch version in ../ref.py.
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
// the chunk states [B, nc, nh, N, hp], float32.  The inter-chunk recurrence
// and the off-diagonal term stay plain torch (../ops.py), as in the JAX
// package.
//
// Layout: one block per (batch, chunk, head).  The block stages the
// chunk's x (its head), cum, B and C in shared memory, forms the masked
// decay-weighted scores W = L ∘ C·Bᵀ there — the exponent cum_t − cum_s is
// formed only for s <= t, because an upper-triangle difference is large and
// positive and its exp overflows (the note in models/mamba2.py) — and then
// writes y_diag = W·x and state = Bᵀ·(x ∘ decay) from shared memory.  A
// shape whose chunk does not fit in one block's shared memory is refused
// (code -2) before launch; the wrapper raises a clear error for it.
//
// Bound on the card: bytes.  At the training path's shape (B = 960
// client-samples, S = 32 as nc = 4 chunks of Q = 8, nh = 8, hp = 8, N = 16)
// a call reads x, cum, B, C and writes y_diag and the states once, about
// 36 MB, against about 0.15 GFLOP — 11 µs at 3.35 TB/s, 2 µs at
// 67 TFLOP/s of float32.  The design does the simple right thing: one pass
// over the chunk's inputs, W never leaves shared memory.  Making it fast
// (all heads of a chunk in one block so B and C are staged once,
// tensor-core MMA at large Q) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define MAX_SMEM 232448            // bytes of shared memory a block may use

static size_t smem_bytes(int Q, int hp, int N) {
    return sizeof(float) * ((size_t)Q * hp             // x
                            + 2 * (size_t)Q            // cum, decay to end
                            + 2 * (size_t)Q * (N + 1)  // B, C (rows padded)
                            + (size_t)Q * (Q + 1));    // W = L ∘ C·Bᵀ
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_fwd_kernel(const float* __restrict__ x, const float* __restrict__ cum,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     float* __restrict__ y, float* __restrict__ st, int Q,
                     int nh, int hp, int N) {
    extern __shared__ float smem[];
    float* xs = smem;                  // [Q][hp]
    float* cs = xs + Q * hp;           // [Q]
    float* dec = cs + Q;               // [Q]
    float* Bs = dec + Q;               // [Q][N + 1]
    float* Cs = Bs + Q * (N + 1);      // [Q][N + 1]
    float* W = Cs + Q * (N + 1);       // [Q][Q + 1]

    const int tid = threadIdx.x;
    const int h = (int)(blockIdx.x % nh);
    const long long bc = blockIdx.x / nh;          // batch · nc + chunk
    const long long row0 = bc * Q;                 // the chunk's first token

    for (int i = tid; i < Q * hp; i += THREADS) {
        const int t = i / hp, p = i % hp;
        xs[i] = x[((row0 + t) * nh + h) * hp + p];
    }
    for (int t = tid; t < Q; t += THREADS) cs[t] = cum[(row0 + t) * nh + h];
    for (int i = tid; i < Q * N; i += THREADS) {
        const int t = i / N, n = i % N;
        Bs[t * (N + 1) + n] = Bm[(row0 + t) * N + n];
        Cs[t * (N + 1) + n] = Cm[(row0 + t) * N + n];
    }
    __syncthreads();

    const float c_last = cs[Q - 1];
    for (int s = tid; s < Q; s += THREADS) dec[s] = expf(c_last - cs[s]);
    for (int i = tid; i < Q * Q; i += THREADS) {
        const int t = i / Q, s = i % Q;
        float w = 0.0f;
        if (s <= t) {              // never exp of an upper-triangle difference
            float dot = 0.0f;
            for (int n = 0; n < N; ++n)
                dot = fmaf(Cs[t * (N + 1) + n], Bs[s * (N + 1) + n], dot);
            w = expf(cs[t] - cs[s]) * dot;
        }
        W[t * (Q + 1) + s] = w;
    }
    __syncthreads();

    for (int i = tid; i < Q * hp; i += THREADS) {
        const int t = i / hp, p = i % hp;
        float acc = 0.0f;
        for (int s = 0; s <= t; ++s)
            acc = fmaf(W[t * (Q + 1) + s], xs[s * hp + p], acc);
        y[((row0 + t) * nh + h) * hp + p] = acc;
    }
    float* stb = st + (bc * nh + h) * (long long)N * hp;
    for (int i = tid; i < N * hp; i += THREADS) {
        const int n = i / hp, p = i % hp;
        float acc = 0.0f;
        for (int s = 0; s < Q; ++s)
            acc = fmaf(Bs[s * (N + 1) + n] * dec[s], xs[s * hp + p], acc);
        stb[i] = acc;
    }
}

// Shared memory one block needs for a chunk of this shape, in bytes.
extern "C" int ssd_chunk_smem_bytes(int Q, int hp, int N) {
    return (int)smem_bytes(Q, hp, N);
}

extern "C" int ssd_chunk_max_smem_bytes(void) { return MAX_SMEM; }

// Returns a cudaError_t, or a negative code for arguments the kernel
// refuses: -1 a non-positive size, -2 a chunk too large for shared memory,
// -3 too many blocks.
extern "C" int ssd_chunk_fwd(const void* x, const void* cum, const void* Bm,
                             const void* Cm, void* y, void* st, int Bsz,
                             int nc, int Q, int nh, int hp, int N,
                             void* stream) {
    if (Bsz <= 0 || nc <= 0 || Q <= 0 || nh <= 0 || hp <= 0 || N <= 0)
        return -1;
    const size_t smem = smem_bytes(Q, hp, N);
    if (smem > MAX_SMEM) return -2;
    const long long nblocks = (long long)Bsz * nc * nh;
    if (nblocks > 2147483647LL) return -3;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            ssd_chunk_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    ssd_chunk_fwd_kernel<<<(unsigned)nblocks, THREADS, smem,
                           (cudaStream_t)stream>>>(
        (const float*)x, (const float*)cum, (const float*)Bm, (const float*)Cm,
        (float*)y, (float*)st, Q, nh, hp, N);
    return (int)cudaGetLastError();
}
