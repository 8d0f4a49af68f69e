// Fusion loss (decision-level fusion + softmax cross-entropy), forward and
// backward, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// ../build.py; the Python wrappers, which pick the regime and its width,
// live in ../ops.py and the plain PyTorch versions in ../ref.py.
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
// Rows r = k·T + t run over the K clients of the cohort.  Up to four
// modality operands arrive as separate pointers in a struct passed by
// value, all of one type (float32, bfloat16 or float16), read as they are
// and converted to float32 in registers, as the JAX kernel upcasts in VMEM;
// all arithmetic and every output is float32.  A broadcast head (seg[m] =
// S) is a compact [K·B, V] operand read at row r / S.  Nothing is padded:
// the kernels mask their own edges.
//
// What bounds it on this card: bytes.  A call reads the M operands once
// and, in the backward, writes M float32 gradients; per element there are
// a handful of FLOPs and M + 1 exponentials.  Two shapes matter, and each
// gets a regime (the wrapper picks it, and its width, from the shapes):
//
// * rows (small V: the paper's 6 and 10 classes).  One thread per row,
//   ROWS_R rows a block (card sweep: 32 to 256 rows within 3 % forward, 32
//   the best backward), one client per block.  The block's rows of each operand
//   are one contiguous slab, staged into shared memory by coalesced 16-byte
//   cp.async copies of the 16-byte pieces that cover it (a row stride such
//   as V = 6 floats leaves the slab anywhere in a piece; the thread reads
//   from the slab's offset).  Each thread then takes its row in chunks of
//   CH elements, as below, and reads the gold logits once, at index y; no
//   shuffles.  Rows read their elements in an order rotated by the row, so
//   that a warp's reads fall in different banks.  The backward needs no
//   reduction over a row: its 256 threads take the block's R·V elements in
//   order (one each at the paper's shapes) and store the gradients
//   coalesced.  Both load their rows' scalars while the slabs are in
//   flight.  At the paper's shape a call moves about 46 KB and is bound by
//   the launch and one round trip to memory.
// * group (large V: an LM vocabulary).  G = 32..512 threads per row (a
//   warp per row, several rows a block, for moderate V; a whole block per
//   row at LM V); the backward, which also writes M gradients, is built at
//   32, 256 and 512 only.  Each thread walks its part of the row in chunks of CH
//   elements per operand, CH·size / 16 loads of 16 bytes each, all issued
//   before their first use.  A row whose operands share their offset within
//   16 bytes is read in 16-byte pieces, with scalar loads for the head and
//   tail; any other row (or a broadcast head out of step with the others)
//   is read with scalar loads in the same chunks.  The per-thread (max,
//   sum) pairs merge in a fixed order: warp shuffles, then shared memory.
//   The backward recomputes p_f once per element from the saved
//   log-sum-exp (no max needed), shared by the M heads, and stores the
//   gradients as float4.
//
// A chunk's max comes first and the running sum is rescaled once per
// chunk, not once per element behind a branch; the mixture is num·(1/den).
// M is a template argument, so every per-modality array is registers of
// exactly M entries.
//
// gsq/gdot need a sum across blocks; blocks run in no order, so the
// backward writes one partial per block into [K, nblk, M, 2] (a block never
// spans two clients) and a second small kernel sums them in a fixed order:
// bitwise the same from run to run.  With partials == NULL the backward
// writes only dlogits (the training step).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_M 4
#define MAX_SMEM 232448                // bytes of shared memory a block may use
#define ROWS_MAX_V 64                  // widest row the rows regime takes
#define ROWS_R 32                      // rows a block in the rows regime
#define CH 8                           // elements a thread takes a chunk
#define BWD_ROWS_THREADS 256           // threads of a rows-regime backward block
#define NEG_INF (-1e30f)
#define FULL_MASK 0xffffffffu

struct Operands {
    const void* x[MAX_M];              // [K·T, V] or, for seg[m] = S, [K·B, V]
    int seg[MAX_M];
};

struct Grads {
    float* d[MAX_M];                   // [K·T, V] each
};

struct Outs {
    float *f_nll, *m_nll, *f_max, *f_lse, *m_max, *m_lse;
};

// ---------------------------------------------------------------------------
// element types: scalar loads (global and shared) and 16-byte unpacking
// ---------------------------------------------------------------------------
template <typename T> struct Elem;

template <> struct Elem<float> {
    static constexpr int VEC = 4;
    __device__ static float ld(const float* p) { return __ldg(p); }
    __device__ static float lds(const float* p) { return *p; }
    __device__ static void unpack(const uint4& u, float* o) {
        o[0] = __uint_as_float(u.x);
        o[1] = __uint_as_float(u.y);
        o[2] = __uint_as_float(u.z);
        o[3] = __uint_as_float(u.w);
    }
};

template <> struct Elem<__nv_bfloat16> {
    static constexpr int VEC = 8;
    __device__ static float bits(unsigned short h) {
        return __uint_as_float((unsigned)h << 16);
    }
    __device__ static float ld(const __nv_bfloat16* p) {
        return bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
    }
    __device__ static float lds(const __nv_bfloat16* p) {
        return bits(*reinterpret_cast<const unsigned short*>(p));
    }
    __device__ static void unpack(const uint4& u, float* o) {
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            o[2 * i] = __uint_as_float(w[i] << 16);
            o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
};

template <> struct Elem<__half> {
    static constexpr int VEC = 8;
    __device__ static float bits(unsigned short h) {
        return __half2float(__ushort_as_half(h));
    }
    __device__ static float ld(const __half* p) {
        return bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
    }
    __device__ static float lds(const __half* p) {
        return bits(*reinterpret_cast<const unsigned short*>(p));
    }
    __device__ static void unpack(const uint4& u, float* o) {
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            o[2 * i] = bits((unsigned short)(w[i] & 0xffffu));
            o[2 * i + 1] = bits((unsigned short)(w[i] >> 16));
        }
    }
};

// ---------------------------------------------------------------------------
// log-sum-exp pieces and reductions
// ---------------------------------------------------------------------------
// e^x as ex2.approx(x·log2 e) (__expf): its error grows with |x|, but every
// argument here is a logit minus its row's max or log-sum-exp, and the
// terms that carry a sum have small ones; the float32 tolerances of the
// card checks hold at every shape (chip_smoke.py).
#define EXP(x) __expf(x)

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
    const float mn = fmaxf(m, m2);
    s = s * EXP(m - mn) + s2 * EXP(m2 - mn);
    m = mn;
}

__device__ __forceinline__ void lse_warp(float& m, float& s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(FULL_MASK, m, off);
        const float s2 = __shfl_xor_sync(FULL_MASK, s, off);
        lse_merge(m, s, m2, s2);
    }
}

__device__ __forceinline__ float sum_warp(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(FULL_MASK, v, off);
    return v;
}

// fold a chunk of CH values (masked entries NEG_INF, entry 0 always real)
// into a running (max, sum): the chunk's max first, one rescale
__device__ __forceinline__ void lse_chunk(float& m, float& s, const float* x) {
    float cm = x[0];
#pragma unroll
    for (int e = 1; e < CH; ++e) cm = fmaxf(cm, x[e]);
    const float mn = fmaxf(m, cm);
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < CH; ++e) acc += EXP(x[e] - mn);
    s = s * EXP(m - mn) + acc;
    m = mn;
}

// the chunk's mixture: Σ_m a_m·x_m[e] / den, NEG_INF past the row's end
template <int M>
__device__ __forceinline__ void mix_chunk(const float (&x)[M][CH],
                                          const float* a, float inv, int nok,
                                          float* f) {
#pragma unroll
    for (int e = 0; e < CH; ++e) {
        float num = 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m) num += a[m] * x[m][e];
        f[e] = e < nok ? num * inv : NEG_INF;
    }
}

// the gradients d[m] of one element from its M logits, accumulated into
// the partials: p_f once, shared by the M heads, from the saved lse
template <int M>
struct RowGrad {
    float a[M], cf[M], cm[M], ml[M];
    float inv, df, fl;
    int y;
    __device__ __forceinline__ void at(const float* xv, int v, float* d,
                                       float* sq, float* dot) const {
        float num = 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m) num += a[m] * xv[m];
        const float pick = (v == y) ? 1.0f : 0.0f;
        const float base = df * (EXP(num * inv - fl) - pick);
#pragma unroll
        for (int m = 0; m < M; ++m) {
            d[m] = cf[m] * base + cm[m] * (EXP(xv[m] - ml[m]) - pick);
            sq[m] += d[m] * d[m];
            dot[m] += d[m] * base;
        }
    }
};

template <int M>
__device__ __forceinline__ RowGrad<M> row_grad(
    long long row, long long KT, const int* labels, const float* avail,
    const float* d_fused, const float* d_modal, const float* f_lse,
    const float* m_lse) {
    RowGrad<M> g;
    float den = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        g.a[m] = avail[m * KT + row];
        den += g.a[m];
        g.ml[m] = m_lse[m * KT + row];
        g.cm[m] = d_modal[m * KT + row] * g.a[m];
    }
    g.inv = 1.0f / fmaxf(den, 1e-9f);
#pragma unroll
    for (int m = 0; m < M; ++m) g.cf[m] = g.a[m] * g.inv;
    g.y = labels[row];
    g.df = d_fused[row];
    g.fl = f_lse[row];
    return g;
}

// one partial per block: the threads' sq/dot summed by warp shuffles, then
// over the block's warps in a fixed order
template <int M>
__device__ __forceinline__ void block_partials(const float* sq,
                                               const float* dot, float* red,
                                               float* partials) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const float s = sum_warp(sq[m]), d = sum_warp(dot[m]);
        if (lane == 0) {
            red[(w * M + m) * 2] = s;
            red[(w * M + m) * 2 + 1] = d;
        }
    }
    __syncthreads();
    if (threadIdx.x < M) {
        const int m = threadIdx.x;
        float s = 0.0f, d = 0.0f;
        for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {    // fixed order
            s += red[(i * M + m) * 2];
            d += red[(i * M + m) * 2 + 1];
        }
        partials[2 * ((long long)blockIdx.x * M + m)] = s;
        partials[2 * ((long long)blockIdx.x * M + m) + 1] = d;
    }
}

// ---------------------------------------------------------------------------
// cp.async: the 16-byte pieces covering [src, src + nbytes) into shared
// memory; returns src's offset in its first piece
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
}

__device__ __forceinline__ int stage_copy(char* dst, const void* src,
                                          long long nbytes) {
    const uintptr_t s = (uintptr_t)src;
    const char* base = (const char*)(s & ~(uintptr_t)15);
    const int off = (int)(s & 15);
    const int pieces = (int)((off + nbytes + 15) >> 4);
    for (int g = threadIdx.x; g < pieces; g += blockDim.x)
        cp_async16(dst + 16 * g, base + 16 * g);
    return off;
}

// Bytes of one operand's slab in the rows regime: R rows of V elements and
// one more 16-byte piece for the slab's offset.
__host__ __device__ static inline long long rows_slab(int R, int V, int esize) {
    return 16LL * (((long long)R * V * esize + 15) / 16 + 1);
}

// ---------------------------------------------------------------------------
// rows regime: ROWS_R rows of one client a block, one thread per row in the
// forward
// ---------------------------------------------------------------------------
template <typename T, int M>
struct RowsBlock {
    const T* slab[M];      // each operand's staged rows, from row first[m]
    long long first[M];
    long long row0;        // the block's first row
    int n;                 // and its rows (one client's)

    // issue the cp.async copies of the block's R rows of each operand
    __device__ __forceinline__ void stage(const Operands& ops, char* sm,
                                          int nbx, int T_, int V, int R) {
        const int k = blockIdx.x / nbx, t0 = (blockIdx.x - k * nbx) * R;
        n = min(R, T_ - t0);
        row0 = (long long)k * T_ + t0;
        const long long bytes = rows_slab(R, V, sizeof(T));
#pragma unroll
        for (int m = 0; m < M; ++m) {
            const int s = ops.seg[m];
            first[m] = s ? row0 / s : row0;
            const long long last = s ? (row0 + n - 1) / s : row0 + n - 1;
            char* dst = sm + m * bytes;
            const int off = stage_copy(dst, (const T*)ops.x[m] + first[m] * V,
                                       (last - first[m] + 1) * V
                                           * (long long)sizeof(T));
            slab[m] = (const T*)(dst + off);
        }
    }

    __device__ __forceinline__ void wait() const {
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
    }

    // row `row`'s V elements of operand m, in shared memory
    __device__ __forceinline__ const T* at(const Operands& ops, int m,
                                           long long row, int V) const {
        const int s = ops.seg[m];
        return slab[m] + ((s ? row / s : row) - first[m]) * V;
    }
};

template <typename T, int M>
__global__ void __launch_bounds__(ROWS_R)
fusion_fwd_rows(Operands ops, const int* __restrict__ labels,
                const float* __restrict__ avail, long long KT, int T_, int V,
                int nbx, Outs out) {
    extern __shared__ float4 smem4[];
    RowsBlock<T, M> b;
    b.stage(ops, (char*)smem4, nbx, T_, V, blockDim.x);
    const int i = threadIdx.x;
    const bool live = i < b.n;
    const long long row = b.row0 + i;
    // the row's scalars load while the slabs are in flight
    float a[M];
    int y = 0;
    if (live) {
#pragma unroll
        for (int m = 0; m < M; ++m) a[m] = avail[m * KT + row];
        y = labels[row];
    }
    b.wait();
    if (!live) return;
    const T* xr[M];
    float mm[M], sm[M];
    float den = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        xr[m] = b.at(ops, m, row, V);
        den += a[m];
        mm[m] = NEG_INF;
        sm[m] = 0.0f;
    }
    const float inv = 1.0f / fmaxf(den, 1e-9f);
    // elements in an order rotated by the row: a warp's reads fall in
    // different banks
    const int v0 = i % V;
    float mf = NEG_INF, sf = 0.0f;
    for (int c = 0; c < V; c += CH) {
        float x[M][CH], f[CH];
#pragma unroll
        for (int e = 0; e < CH; ++e) {
            int v = v0 + c + e;
            v = v >= V ? v - V : v;
#pragma unroll
            for (int m = 0; m < M; ++m)
                x[m][e] = c + e < V ? Elem<T>::lds(xr[m] + v) : NEG_INF;
        }
        mix_chunk<M>(x, a, inv, V - c, f);
#pragma unroll
        for (int m = 0; m < M; ++m) lse_chunk(mm[m], sm[m], x[m]);
        lse_chunk(mf, sf, f);
    }
    float gnum = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const float g = Elem<T>::lds(xr[m] + y);       // the gold logit, once
        gnum += a[m] * g;
        const float ml = mm[m] + logf(sm[m]);
        out.m_nll[m * KT + row] = (ml - g) * a[m];
        out.m_max[m * KT + row] = mm[m];
        out.m_lse[m * KT + row] = ml;
    }
    const float fl = mf + logf(sf);
    out.f_nll[row] = fl - gnum * inv;
    out.f_max[row] = mf;
    out.f_lse[row] = fl;
}

// The backward needs no reduction over a row: after staging the block's R
// rows, BWD_ROWS_THREADS threads take its R·V elements in order, one
// element each at the paper's shapes, and store the gradients coalesced.
// The per-row scalars they share are staged beside the slabs: a[M],
// m_lse[M], d_modal·a[M], 1/den, d_fused, f_lse, y.
template <typename T, int M>
__global__ void __launch_bounds__(BWD_ROWS_THREADS)
fusion_bwd_rows(Operands ops, const int* __restrict__ labels,
                const float* __restrict__ avail,
                const float* __restrict__ d_fused,
                const float* __restrict__ d_modal,
                const float* __restrict__ f_lse,
                const float* __restrict__ m_lse, long long KT, int T_, int V,
                int nbx, int R, Grads out, float* __restrict__ partials) {
    constexpr int NS = 3 * M + 4;
    extern __shared__ float4 smem4[];
    char* sm = (char*)smem4;
    RowsBlock<T, M> b;
    b.stage(ops, sm, nbx, T_, V, R);
    float* rs = (float*)(sm + M * rows_slab(R, V, sizeof(T)));   // [R][NS]
    float* red = rs + R * NS;                                     // [8][M][2]
    for (int i = threadIdx.x; i < b.n; i += blockDim.x) {
        const long long row = b.row0 + i;
        float* r = rs + i * NS;
        float den = 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m) {
            const float a = avail[m * KT + row];
            den += a;
            r[m] = a;
            r[M + m] = m_lse[m * KT + row];
            r[2 * M + m] = d_modal[m * KT + row] * a;
        }
        r[3 * M] = 1.0f / fmaxf(den, 1e-9f);
        r[3 * M + 1] = d_fused[row];
        r[3 * M + 2] = f_lse[row];
        r[3 * M + 3] = __int_as_float(labels[row]);
    }
    b.wait();

    float sq[M], dot[M];
#pragma unroll
    for (int m = 0; m < M; ++m) sq[m] = dot[m] = 0.0f;
    const int nel = b.n * V;
    for (int e = threadIdx.x; e < nel; e += blockDim.x) {
        const int i = e / V, v = e - i * V;
        const long long row = b.row0 + i;
        const float* r = rs + i * NS;
        const float inv = r[3 * M], df = r[3 * M + 1], fl = r[3 * M + 2];
        const int y = __float_as_int(r[3 * M + 3]);
        float xv[M];
        float num = 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m) {
            xv[m] = Elem<T>::lds(b.at(ops, m, row, V) + v);
            num += r[m] * xv[m];
        }
        const float pick = (v == y) ? 1.0f : 0.0f;
        const float base = df * (EXP(num * inv - fl) - pick);
#pragma unroll
        for (int m = 0; m < M; ++m) {
            const float d = r[m] * inv * base
                            + r[2 * M + m] * (EXP(xv[m] - r[M + m]) - pick);
            out.d[m][b.row0 * V + e] = d;
            sq[m] += d * d;
            dot[m] += d * base;
        }
    }
    if (partials != nullptr)                          // uniform over the grid
        block_partials<M>(sq, dot, red, partials);
}

// ---------------------------------------------------------------------------
// group regime: G threads per row, RB rows a block
// ---------------------------------------------------------------------------
template <int G> struct Group {
    static constexpr int RB = G >= 256 ? 1 : 256 / G;   // rows a block
    static constexpr int W = G / 32;                    // warps a row
    static constexpr int THREADS = G * RB;
};

// The row's operand pointers and where its 16-byte pieces start: rows whose
// operands (and, in the backward, gradients) share their offset within 16
// bytes are read in pieces from element `head` on, the others element by
// element (head = V, nvec = 0).
template <typename T, int M>
__device__ __forceinline__ void row_layout(const Operands& ops,
                                           long long row, int V,
                                           const T** p, float* const* o,
                                           int& head, int& nvec) {
    constexpr int VEC = Elem<T>::VEC;
    unsigned off = 0;
    bool same = true;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const int s = ops.seg[m];
        p[m] = (const T*)ops.x[m] + (s ? row / s : row) * (long long)V;
        const unsigned o16 = (unsigned)((uintptr_t)p[m] & 15);
        if (m == 0) off = o16;
        same = same && o16 == off;
    }
    head = min(V, (int)(((16 - off) & 15) / sizeof(T)));
    if (o != nullptr) {
#pragma unroll
        for (int m = 0; m < M; ++m)
            same = same && (((uintptr_t)(o[m] + head)) & 15) == 0;
    }
    if (!same) head = V;
    nvec = (V - head) / VEC;
}

// chunk loaders of the group regime: scalar entries v0 + e·G of [., hi),
// or the U = CH / VEC 16-byte pieces j0 + u·G of the row's nvec pieces;
// masked entries NEG_INF, entry 0 always real; returns the real entries
template <typename T, int M, int G>
__device__ __forceinline__ int scalar_chunk(const T* const* p, int v0, int hi,
                                            float (&x)[M][CH]) {
#pragma unroll
    for (int e = 0; e < CH; ++e) {
        const int v = v0 + e * G;
#pragma unroll
        for (int m = 0; m < M; ++m)
            x[m][e] = v < hi ? Elem<T>::ld(p[m] + v) : NEG_INF;
    }
    return min(CH, (hi - v0 + G - 1) / G);
}

template <typename T, int M, int G>
__device__ __forceinline__ int vector_chunk(const T* const* p, int head,
                                            int j0, int nvec,
                                            float (&x)[M][CH]) {
    constexpr int VEC = Elem<T>::VEC, U = CH / VEC;
    uint4 raw[M][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const bool ok = j0 + u * G < nvec;
#pragma unroll
        for (int m = 0; m < M; ++m)
            raw[m][u] = ok ? __ldg(reinterpret_cast<const uint4*>(p[m] + head)
                                   + j0 + u * G)
                           : make_uint4(0, 0, 0, 0);
    }
    int nok = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const bool ok = j0 + u * G < nvec;
        nok += ok ? VEC : 0;
#pragma unroll
        for (int m = 0; m < M; ++m) {
            Elem<T>::unpack(raw[m][u], &x[m][u * VEC]);
            if (!ok) {
#pragma unroll
                for (int q = 0; q < VEC; ++q) x[m][u * VEC + q] = NEG_INF;
            }
        }
    }
    return nok;
}

template <typename T, int M, int G>
__global__ void __launch_bounds__(Group<G>::THREADS)
fusion_fwd_group(Operands ops, const int* __restrict__ labels,
                 const float* __restrict__ avail, long long KT, int T_, int V,
                 int nbx, Outs out) {
    using Gp = Group<G>;
    constexpr int VEC = Elem<T>::VEC, U = CH / VEC;
    extern __shared__ float4 smem4[];
    float* red = (float*)smem4;                       // [RB][W][M+1][2]
    const int grp = threadIdx.x / G, tid = threadIdx.x % G;
    const int warp = tid >> 5, lane = tid & 31;
    const int k = blockIdx.x / nbx;
    const int t = (blockIdx.x - k * nbx) * Gp::RB + grp;
    const bool live = t < T_;                         // whole warps
    const long long row = (long long)k * T_ + t;

    float a[M], mm[M], sm[M], gm[M];
    float mf = NEG_INF, sf = 0.0f, inv = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        mm[m] = NEG_INF;
        sm[m] = 0.0f;
        gm[m] = 0.0f;
    }
    if (live) {
        const T* p[M];
        int head, nvec;
        row_layout<T, M>(ops, row, V, p, nullptr, head, nvec);
        float den = 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m) {
            a[m] = avail[m * KT + row];
            den += a[m];
        }
        inv = 1.0f / fmaxf(den, 1e-9f);
        if (tid == 0) {                               // the gold logits, once
            const int y = labels[row];
#pragma unroll
            for (int m = 0; m < M; ++m) gm[m] = Elem<T>::ld(p[m] + y);
        }
        float x[M][CH], f[CH];
        for (int v0 = tid; v0 < head; v0 += G * CH) {
            mix_chunk<M>(x, a, inv, scalar_chunk<T, M, G>(p, v0, head, x), f);
#pragma unroll
            for (int m = 0; m < M; ++m) lse_chunk(mm[m], sm[m], x[m]);
            lse_chunk(mf, sf, f);
        }
        for (int j0 = tid; j0 < nvec; j0 += G * U) {
            mix_chunk<M>(x, a, inv, vector_chunk<T, M, G>(p, head, j0, nvec, x),
                         f);
#pragma unroll
            for (int m = 0; m < M; ++m) lse_chunk(mm[m], sm[m], x[m]);
            lse_chunk(mf, sf, f);
        }
        for (int v0 = head + nvec * VEC + tid; v0 < V; v0 += G * CH) {
            mix_chunk<M>(x, a, inv, scalar_chunk<T, M, G>(p, v0, V, x), f);
#pragma unroll
            for (int m = 0; m < M; ++m) lse_chunk(mm[m], sm[m], x[m]);
            lse_chunk(mf, sf, f);
        }
        lse_warp(mf, sf);
#pragma unroll
        for (int m = 0; m < M; ++m) lse_warp(mm[m], sm[m]);
    }
    if constexpr (Gp::W > 1) {
        // the row's W warp results, merged by its first warp in a fixed
        // order: lane w holds warp w's, then log2(W) shuffle levels
        float* r = red + (grp * Gp::W) * (M + 1) * 2;
        if (live && lane == 0) {
            float* rw = r + warp * (M + 1) * 2;
            rw[0] = mf;
            rw[1] = sf;
#pragma unroll
            for (int m = 0; m < M; ++m) {
                rw[2 + 2 * m] = mm[m];
                rw[3 + 2 * m] = sm[m];
            }
        }
        __syncthreads();
        if (live && warp == 0) {
            const float* rw = r + (lane < Gp::W ? lane : 0) * (M + 1) * 2;
            const bool own = lane < Gp::W;
#pragma unroll
            for (int k = 0; k <= M; ++k) {
                float m2 = own ? rw[2 * k] : NEG_INF;
                float s2 = own ? rw[2 * k + 1] : 0.0f;
#pragma unroll
                for (int off = Gp::W / 2; off > 0; off >>= 1) {
                    const float m3 = __shfl_xor_sync(FULL_MASK, m2, off);
                    const float s3 = __shfl_xor_sync(FULL_MASK, s2, off);
                    lse_merge(m2, s2, m3, s3);
                }
                if (k == 0) {
                    mf = m2;
                    sf = s2;
                } else {
                    mm[k - 1] = m2;
                    sm[k - 1] = s2;
                }
            }
        }
    }
    if (live && tid == 0) {
        const float fl = mf + logf(sf);
        float gnum = 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m) {
            gnum += a[m] * gm[m];
            const float ml = mm[m] + logf(sm[m]);
            out.m_nll[m * KT + row] = (ml - gm[m]) * a[m];
            out.m_max[m * KT + row] = mm[m];
            out.m_lse[m * KT + row] = ml;
        }
        out.f_nll[row] = fl - gnum * inv;
        out.f_max[row] = mf;
        out.f_lse[row] = fl;
    }
}

template <typename T, int M, int G>
__global__ void __launch_bounds__(Group<G>::THREADS)
fusion_bwd_group(Operands ops, const int* __restrict__ labels,
                 const float* __restrict__ avail,
                 const float* __restrict__ d_fused,
                 const float* __restrict__ d_modal,
                 const float* __restrict__ f_lse,
                 const float* __restrict__ m_lse, long long KT, int T_, int V,
                 int nbx, Grads out, float* __restrict__ partials) {
    using Gp = Group<G>;
    constexpr int VEC = Elem<T>::VEC, U = CH / VEC;
    extern __shared__ float4 smem4[];
    const int grp = threadIdx.x / G, tid = threadIdx.x % G;
    const int k = blockIdx.x / nbx;
    const int t = (blockIdx.x - k * nbx) * Gp::RB + grp;
    const long long row = (long long)k * T_ + t;

    float sq[M], dot[M];
#pragma unroll
    for (int m = 0; m < M; ++m) sq[m] = dot[m] = 0.0f;
    if (t < T_) {                                     // whole warps
        const T* p[M];
        float* o[M];
#pragma unroll
        for (int m = 0; m < M; ++m) o[m] = out.d[m] + row * V;
        int head, nvec;
        row_layout<T, M>(ops, row, V, p, o, head, nvec);
        const RowGrad<M> g = row_grad<M>(row, KT, labels, avail, d_fused,
                                         d_modal, f_lse, m_lse);
        // element by element where the row is not in 16-byte pieces
        auto scalar_part = [&](int lo, int hi) {
            for (int v0 = lo + tid; v0 < hi; v0 += G * CH) {
                float x[M][CH];
                scalar_chunk<T, M, G>(p, v0, hi, x);
#pragma unroll
                for (int e = 0; e < CH; ++e) {
                    const int v = v0 + e * G;
                    if (v < hi) {
                        float xv[M], d[M];
#pragma unroll
                        for (int m = 0; m < M; ++m) xv[m] = x[m][e];
                        g.at(xv, v, d, sq, dot);
#pragma unroll
                        for (int m = 0; m < M; ++m) o[m][v] = d[m];
                    }
                }
            }
        };
        scalar_part(0, head);
        for (int j0 = tid; j0 < nvec; j0 += G * U) {
            float x[M][CH];
            vector_chunk<T, M, G>(p, head, j0, nvec, x);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int j = j0 + u * G;
                if (j < nvec) {
                    float d[M][VEC];
#pragma unroll
                    for (int q = 0; q < VEC; ++q) {
                        float xv[M], dq[M];
#pragma unroll
                        for (int m = 0; m < M; ++m) xv[m] = x[m][u * VEC + q];
                        g.at(xv, head + j * VEC + q, dq, sq, dot);
#pragma unroll
                        for (int m = 0; m < M; ++m) d[m][q] = dq[m];
                    }
#pragma unroll
                    for (int m = 0; m < M; ++m) {
                        float4* dst = reinterpret_cast<float4*>(
                            o[m] + head + (long long)j * VEC);
#pragma unroll
                        for (int q = 0; q < VEC / 4; ++q)
                            dst[q] = make_float4(d[m][4 * q], d[m][4 * q + 1],
                                                 d[m][4 * q + 2],
                                                 d[m][4 * q + 3]);
                    }
                }
            }
        }
        scalar_part(head + nvec * VEC, V);
    }
    if (partials != nullptr)                          // uniform over the grid
        block_partials<M>(sq, dot, (float*)smem4, partials);
}

// ---------------------------------------------------------------------------
// second stage: gsq/gdot [K, M] from the [K, nblk, M, 2] partials, summed
// over the blocks in a fixed order: a warp per (k, m), lane l taking
// blocks l, l + 32, ..., then a shuffle tree
// ---------------------------------------------------------------------------
__global__ void fusion_partials_reduce_kernel(const float* __restrict__ partials,
                                              int K, int nblk, int M,
                                              float* __restrict__ gsq,
                                              float* __restrict__ gdot) {
    const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (w >= K * M) return;                           // whole warps
    const int k = w / M, m = w % M;
    float s = 0.0f, d = 0.0f;
    for (int b = lane; b < nblk; b += 32) {
        const long long p = ((long long)k * nblk + b) * M + m;
        s += partials[2 * p];
        d += partials[2 * p + 1];
    }
    s = sum_warp(s);
    d = sum_warp(d);
    if (lane == 0) {
        gsq[w] = s;
        gdot[w] = d;
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
enum { REGIME_ROWS = 0, REGIME_GROUP = 1 };

// threads a row the group regime builds: the forward 32..512, the backward
// 32, 256 or 512 (the widths the plan gives it)
static bool group_width(int G, int backward) {
    return G == 32 || G == 256 || G == 512
           || (!backward && (G == 64 || G == 128));
}
static int group_rows(int G) { return G >= 256 ? 1 : 256 / G; }

// Dynamic shared memory of one block, in bytes: rows regime the M staged
// slabs (and, backward, the rows' scalars and the per-warp partials);
// group regime the per-warp (max, sum) pairs (forward, a row of several
// warps) or the per-warp partials (backward).  -1 for a regime or width
// the kernels do not take.
static long long smem_bytes(int regime, int backward, int width, int V, int M,
                            int esize) {
    if (regime == REGIME_ROWS) {
        if (width != ROWS_R || V > ROWS_MAX_V) return -1;
        long long b = M * rows_slab(width, V, esize);
        if (backward)
            b += 4LL * width * (3 * M + 4) + 4LL * (BWD_ROWS_THREADS / 32) * M * 2;
        return b;
    }
    if (regime == REGIME_GROUP) {
        if (!group_width(width, backward)) return -1;
        const long long warps = (long long)group_rows(width) * (width / 32);
        if (backward) return 4 * warps * M * 2;
        return width > 32 ? 4 * warps * (M + 1) * 2 : 0;
    }
    return -1;
}

extern "C" int fusion_loss_smem_bytes(int regime, int backward, int width,
                                      int V, int M, int esize) {
    const long long b = smem_bytes(regime, backward, width, V, M, esize);
    return b > 2147483647LL ? -1 : (int)b;
}

struct Launch {
    unsigned blocks;
    int threads, nbx;
    size_t smem;
    cudaStream_t stream;
};

// -1 a non-positive size or M outside 1..4, -2 a regime or width the
// kernels do not take or more shared memory than a block has, -3 too many
// blocks
static int plan_launch(int regime, int backward, int width, int M, int esize,
                       int K, int T, int V, Launch& L) {
    if (M < 1 || M > MAX_M || K <= 0 || T <= 0 || V <= 0) return -1;
    const long long smem = smem_bytes(regime, backward, width, V, M, esize);
    if (smem < 0 || smem > MAX_SMEM) return -2;
    const int rows = regime == REGIME_ROWS ? width : group_rows(width);
    L.nbx = (T + rows - 1) / rows;
    const long long blocks = (long long)K * L.nbx;
    if (blocks > 2147483647LL) return -3;
    L.blocks = (unsigned)blocks;
    L.threads = regime == REGIME_ROWS ? (backward ? BWD_ROWS_THREADS : width)
                                      : width * rows;
    L.smem = (size_t)smem;
    return 0;
}

template <typename Kern, typename... Args>
static int run(Kern kernel, const Launch& L, Args... args) {
    if (L.smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<L.blocks, L.threads, L.smem, L.stream>>>(args...);
    return (int)cudaGetLastError();
}

// the kernel of (type, M, regime, width) for each direction
template <typename T, int M>
struct Kernels {
    template <typename... Args>
    static int fwd(int regime, int width, const Launch& L, Args... a) {
        if (regime == REGIME_ROWS) return run(fusion_fwd_rows<T, M>, L, a...);
        switch (width) {
            case 32: return run(fusion_fwd_group<T, M, 32>, L, a...);
            case 64: return run(fusion_fwd_group<T, M, 64>, L, a...);
            case 128: return run(fusion_fwd_group<T, M, 128>, L, a...);
            case 256: return run(fusion_fwd_group<T, M, 256>, L, a...);
            case 512: return run(fusion_fwd_group<T, M, 512>, L, a...);
        }
        return -2;
    }
    // a: the arguments up to nbx, b: those after it (the rows kernel
    // also takes its rows a block, R = width)
    template <typename... A>
    static int bwd(int regime, int width, const Launch& L, const Grads& out,
                   float* partials, A... a) {
        if (regime == REGIME_ROWS)
            return run(fusion_bwd_rows<T, M>, L, a..., width, out, partials);
        switch (width) {
            case 32: return run(fusion_bwd_group<T, M, 32>, L, a..., out, partials);
            case 256: return run(fusion_bwd_group<T, M, 256>, L, a..., out, partials);
            case 512: return run(fusion_bwd_group<T, M, 512>, L, a..., out, partials);
        }
        return -2;
    }
};

template <typename T, typename... Args>
static int fwd_of(int M, int regime, int width, const Launch& L, Args... a) {
    switch (M) {
        case 1: return Kernels<T, 1>::fwd(regime, width, L, a...);
        case 2: return Kernels<T, 2>::fwd(regime, width, L, a...);
        case 3: return Kernels<T, 3>::fwd(regime, width, L, a...);
        case 4: return Kernels<T, 4>::fwd(regime, width, L, a...);
    }
    return -1;
}

template <typename T, typename... Args>
static int bwd_of(int M, int regime, int width, const Launch& L,
                  const Grads& out, float* partials, Args... a) {
    switch (M) {
        case 1: return Kernels<T, 1>::bwd(regime, width, L, out, partials, a...);
        case 2: return Kernels<T, 2>::bwd(regime, width, L, out, partials, a...);
        case 3: return Kernels<T, 3>::bwd(regime, width, L, out, partials, a...);
        case 4: return Kernels<T, 4>::bwd(regime, width, L, out, partials, a...);
    }
    return -1;
}

static int esize_of(int dtype) {
    return dtype == 0 ? 4 : (dtype == 1 || dtype == 2) ? 2 : -1;
}

static Operands make_operands(const void* x0, const void* x1, const void* x2,
                              const void* x3, int s0, int s1, int s2, int s3) {
    Operands ops;
    ops.x[0] = x0;
    ops.x[1] = x1;
    ops.x[2] = x2;
    ops.x[3] = x3;
    ops.seg[0] = s0;
    ops.seg[1] = s1;
    ops.seg[2] = s2;
    ops.seg[3] = s3;
    return ops;
}

// ---------------------------------------------------------------------------
// C interface: every pointer is a device pointer (or NULL for an unused
// operand slot, or for the backward's partials when gsq/gdot are not
// wanted), the stream is a cudaStream_t; dtype 0 float32, 1 bfloat16, 2
// float16; regime 0 rows (width = rows a block), 1 group (width = threads
// a row).  Each returns the launch's cudaGetLastError() as an int (0 =
// launched), or a negative code for arguments it refuses (plan_launch;
// -5 an operand type the kernels do not read).
// ---------------------------------------------------------------------------
extern "C" int fusion_loss_fwd(const void* x0, const void* x1, const void* x2,
                               const void* x3, int s0, int s1, int s2, int s3,
                               int M, int dtype, const void* labels,
                               const void* avail, int K, int T, int V,
                               int regime, int width, void* fused_nll,
                               void* modal_nll, void* f_max, void* f_lse,
                               void* m_max, void* m_lse, void* stream) {
    const int esize = esize_of(dtype);
    if (esize < 0) return -5;
    Launch L;
    const int rc = plan_launch(regime, 0, width, M, esize, K, T, V, L);
    if (rc) return rc;
    L.stream = (cudaStream_t)stream;
    const Operands ops = make_operands(x0, x1, x2, x3, s0, s1, s2, s3);
    const Outs out = {(float*)fused_nll, (float*)modal_nll, (float*)f_max,
                      (float*)f_lse, (float*)m_max, (float*)m_lse};
    const int* lab = (const int*)labels;
    const float* av = (const float*)avail;
    const long long KT = (long long)K * T;
    if (dtype == 0)
        return fwd_of<float>(M, regime, width, L, ops, lab, av, KT, T, V,
                             L.nbx, out);
    if (dtype == 1)
        return fwd_of<__nv_bfloat16>(M, regime, width, L, ops, lab, av, KT, T,
                                     V, L.nbx, out);
    return fwd_of<__half>(M, regime, width, L, ops, lab, av, KT, T, V, L.nbx,
                          out);
}

extern "C" int fusion_loss_bwd(const void* x0, const void* x1, const void* x2,
                               const void* x3, int s0, int s1, int s2, int s3,
                               int M, int dtype, const void* labels,
                               const void* avail, const void* d_fused,
                               const void* d_modal, const void* f_lse,
                               const void* m_lse, int K, int T, int V,
                               int regime, int width, void* d0, void* d1,
                               void* d2, void* d3, void* partials,
                               void* stream) {
    const int esize = esize_of(dtype);
    if (esize < 0) return -5;
    Launch L;
    const int rc = plan_launch(regime, 1, width, M, esize, K, T, V, L);
    if (rc) return rc;
    L.stream = (cudaStream_t)stream;
    const Operands ops = make_operands(x0, x1, x2, x3, s0, s1, s2, s3);
    Grads out;
    out.d[0] = (float*)d0;
    out.d[1] = (float*)d1;
    out.d[2] = (float*)d2;
    out.d[3] = (float*)d3;
    const int* lab = (const int*)labels;
    const float *av = (const float*)avail, *df = (const float*)d_fused,
                *dm = (const float*)d_modal, *fl = (const float*)f_lse,
                *ml = (const float*)m_lse;
    float* part = (float*)partials;
    const long long KT = (long long)K * T;
    if (dtype == 0)
        return bwd_of<float>(M, regime, width, L, out, part, ops, lab, av, df,
                             dm, fl, ml, KT, T, V, L.nbx);
    if (dtype == 1)
        return bwd_of<__nv_bfloat16>(M, regime, width, L, out, part, ops, lab,
                                     av, df, dm, fl, ml, KT, T, V, L.nbx);
    return bwd_of<__half>(M, regime, width, L, out, part, ops, lab, av, df,
                          dm, fl, ml, KT, T, V, L.nbx);
}

extern "C" int fusion_loss_reduce(const void* partials, int K, int nblk,
                                  int M, void* gsq, void* gdot, void* stream) {
    const long long n = 32LL * K * M;                  // a warp per (k, m)
    const int threads = 128;
    fusion_partials_reduce_kernel<<<(unsigned)((n + threads - 1) / threads),
                                    threads, 0, (cudaStream_t)stream>>>(
        (const float*)partials, K, nblk, M, (float*)gsq, (float*)gdot);
    return (int)cudaGetLastError();
}
