// Causal (optionally sliding-window) GQA attention, forward, for Hopper
// (sm_90a).
// Plain C interface, loaded with ctypes by ../build.py; the Python wrapper
// lives in ../ops.py and the plain PyTorch version in ../ref.py.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py  _kernel / flash_attention_pallas
// and computes what it computes:
//
//   s[q,k] = (Q_q · K_k) / sqrt(hd),   masked to -1e30 unless k <= q and
//            k > q - window (sliding window)
//   O_q    = Σ_k softmax_k(s[q,:]) V_k   (online max/sum, f32 accumulate)
//
// with the KV head of query head h at h / (H / KH) (GQA) and the output in
// the input's type (float32 or bfloat16).  The TPU kernel's non-causal
// mode has no caller in the repository and is not carried over.
//
// Layout: one block per (batch, query head, tile of BQ query rows).  The
// block stages its query tile once, then walks the key tiles it can see —
// tiles past the causal edge or before the window are skipped, as the TPU
// kernel skips them with pl.when — staging K and V in shared memory.  Each
// tile runs three steps, each over all 128 threads: the BQ×BK scores (one
// dot product of length hd per thread and entry), the online softmax (four
// threads per query row, merged with warp shuffles), and the rescaled P·V
// update of the f32 accumulator, which stays in shared memory so that any
// head dim up to 256 fits.  Ragged edges (S not a multiple of the tile, as
// S=24 on the training path) are masked in the kernel, never padded in the
// caller's tensors.  Q, K, V and O are read and written through their
// strides with the head dim contiguous, so the model's [B, S, H, hd] layout
// and the reference's [B, H, S, hd] layout both go in without a copy.
//
// Bound on the card: bytes.  At the training path's shape (B = 960
// client-samples, S = 32, H = KH = 4, hd = 8) a call reads Q, K, V and
// writes O once, about 15.7 MB, and does about 0.07 GFLOP (the causal half
// of Q·Kᵀ and P·V) — 4.7 µs at 3.35 TB/s against 1 µs at 67 TFLOP/s of
// float32.  The design does the simple right thing: one pass over K and V
// per query tile, the S×S scores never leave shared memory.  Making it fast
// (tensor-core MMA for the two products, several heads per block at
// hd = 8, TMA staging) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 32                      // query rows per block
#define BK 32                      // keys per shared-memory tile
#define THREADS 128
#define TPR (THREADS / BQ)         // threads per query row in the softmax
#define MAX_HD 256
#define MAX_SMEM 232448            // bytes of shared memory a block may use
#define NEG_INF (-1e30f)
#define FULL_MASK 0xffffffffu

static_assert(THREADS == BQ * TPR && 32 % TPR == 0,
              "a query row's softmax lanes must sit inside one warp");

struct Layout {                    // element strides; the head dim has stride 1
    long long b, s, h;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

static size_t smem_bytes(int hd) {
    return sizeof(float) * ((size_t)BQ * hd          // query tile
                            + (size_t)BK * (hd + 1)  // key tile, rows padded
                            + (size_t)BK * hd        // value tile
                            + (size_t)BQ * (BK + 1)  // scores, then P
                            + (size_t)BQ * hd        // output accumulator
                            + 3 * BQ);               // running max, sum, rescale
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Layout lq, Layout lk, Layout lv, Layout lo,
                           int H, int KH, int S, int hd, int nq, float scale,
                           int window) {
    extern __shared__ float smem[];
    float* qs = smem;                          // [BQ][hd]
    float* ks = qs + BQ * hd;                  // [BK][hd + 1]
    float* vs = ks + BK * (hd + 1);            // [BK][hd]
    float* ps = vs + BK * hd;                  // [BQ][BK + 1]
    float* acc = ps + BQ * (BK + 1);           // [BQ][hd]
    float* m_s = acc + BQ * hd;                // [BQ]
    float* l_s = m_s + BQ;                     // [BQ]
    float* a_s = l_s + BQ;                     // [BQ]

    const int tid = threadIdx.x;
    const long long bid = blockIdx.x;
    const int qt = (int)(bid % nq);
    const int h = (int)((bid / nq) % H);
    const long long b = bid / ((long long)nq * H);
    const int kvh = h / (H / KH);
    const int q0 = qt * BQ;

    const T* qb = q + b * lq.b + (long long)h * lq.h;
    const T* kb = k + b * lk.b + (long long)kvh * lk.h;
    const T* vb = v + b * lv.b + (long long)kvh * lv.h;

    for (int i = tid; i < BQ * hd; i += THREADS) {
        const int r = i / hd, d = i % hd;
        qs[i] = (q0 + r < S) ? load_f(qb + (long long)(q0 + r) * lq.s + d)
                             : 0.0f;
        acc[i] = 0.0f;
    }
    if (tid < BQ) {
        m_s[tid] = NEG_INF;
        l_s[tid] = 0.0f;
    }

    // the keys this query tile can see; every other tile is skipped
    const int k_lo = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
    const int k_hi = min(S, q0 + BQ);

    for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
        __syncthreads();           // the previous tile's readers are done
        for (int i = tid; i < BK * hd; i += THREADS) {
            const int j = i / hd, d = i % hd;
            const bool in = k0 + j < S;
            ks[j * (hd + 1) + d] =
                in ? load_f(kb + (long long)(k0 + j) * lk.s + d) : 0.0f;
            vs[i] = in ? load_f(vb + (long long)(k0 + j) * lv.s + d) : 0.0f;
        }
        __syncthreads();

        // scores, masked in place
        for (int i = tid; i < BQ * BK; i += THREADS) {
            const int r = i / BK, j = i % BK;
            const int qp = q0 + r, kp = k0 + j;
            const bool ok = kp < S && kp <= qp &&
                            (window <= 0 || kp > qp - window);
            float s = NEG_INF;
            if (ok) {
                const float* qr = qs + r * hd;
                const float* kr = ks + j * (hd + 1);
                float dot = 0.0f;
                for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
                s = dot * scale;
            }
            ps[r * (BK + 1) + j] = s;
        }
        __syncthreads();

        // online softmax: TPR neighbouring lanes per query row
        {
            const int r = tid / TPR, sub = tid % TPR;
            float* pr = ps + r * (BK + 1);
            float mx = NEG_INF;
            for (int j = sub; j < BK; j += TPR) mx = fmaxf(mx, pr[j]);
#pragma unroll
            for (int off = TPR / 2; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
            const float m_prev = m_s[r];
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.0f;
            for (int j = sub; j < BK; j += TPR) {
                const float p = expf(pr[j] - m_new);
                pr[j] = p;
                sum += p;
            }
#pragma unroll
            for (int off = TPR / 2; off > 0; off >>= 1)
                sum += __shfl_xor_sync(FULL_MASK, sum, off);
            if (sub == 0) {        // every lane of the row has read m_s[r]
                const float alpha = expf(m_prev - m_new);
                a_s[r] = alpha;
                l_s[r] = l_s[r] * alpha + sum;
                m_s[r] = m_new;
            }
        }
        __syncthreads();

        // acc = acc·alpha + P·V
        for (int i = tid; i < BQ * hd; i += THREADS) {
            const int r = i / hd, d = i % hd;
            const float* pr = ps + r * (BK + 1);
            float pv = 0.0f;
            for (int j = 0; j < BK; ++j) pv = fmaf(pr[j], vs[j * hd + d], pv);
            acc[i] = acc[i] * a_s[r] + pv;
        }
    }
    __syncthreads();

    T* ob = o + b * lo.b + (long long)h * lo.h;
    for (int i = tid; i < BQ * hd; i += THREADS) {
        const int r = i / hd, d = i % hd;
        if (q0 + r < S)
            store_f(ob + (long long)(q0 + r) * lo.s + d,
                    acc[i] / fmaxf(l_s[r], 1e-30f));
    }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  Layout lq, Layout lk, Layout lv, Layout lo, int B, int H,
                  int KH, int S, int hd, int window, cudaStream_t stream) {
    const size_t smem = smem_bytes(hd);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            flash_attention_fwd_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int nq = (S + BQ - 1) / BQ;
    const long long nblocks = (long long)B * H * nq;
    flash_attention_fwd_kernel<T><<<(unsigned)nblocks, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, lq, lk, lv, lo, H, KH,
        S, hd, nq, 1.0f / sqrtf((float)hd), window);
    return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  Returns
// a cudaError_t, or a negative code for arguments the kernel refuses.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long os,
    long long oh, int dtype, int B, int H, int KH, int S, int hd, int window,
    void* stream) {
    if (B <= 0 || S <= 0 || hd <= 0 || hd > MAX_HD || KH <= 0 || H % KH)
        return -1;
    if (smem_bytes(hd) > MAX_SMEM) return -2;
    if ((long long)B * H * ((S + BQ - 1) / BQ) > 2147483647LL) return -3;
    const Layout lq{qb, qs, qh}, lk{kb, ks, kh}, lv{vb, vs, vh},
        lo{ob, os, oh};
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return launch<float>(q, k, v, o, lq, lk, lv, lo, B, H, KH, S, hd,
                             window, st);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q, k, v, o, lq, lk, lv, lo, B, H, KH, S,
                                     hd, window, st);
    return -4;
}
