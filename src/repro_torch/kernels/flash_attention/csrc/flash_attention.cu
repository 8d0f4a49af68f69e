// Causal (optionally sliding-window) GQA attention, forward, for Hopper
// (sm_90a).
// Plain C interface, loaded with ctypes by ../build.py; the Python wrapper,
// which picks the regime, lives in ../ops.py and the plain PyTorch version
// in ../ref.py.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py  _kernel / flash_attention_pallas
// and computes what it computes:
//
//   s[q,k] = (Q_q · K_k) / sqrt(hd),   masked unless k <= q and
//            k > q - window (sliding window)
//   O_q    = Σ_k softmax_k(s[q,:]) V_k   (online max/sum, f32 accumulate)
//
// with the KV head of query head h at h / (H / KH) (GQA) and the output in
// the input's type (float32 or bfloat16).  The TPU kernel's non-causal
// mode has no caller in the repository and is not carried over.  Q, K, V
// and O are read and written through their strides with the head dim
// contiguous, so the model's [B, S, H, hd] layout and the reference's
// [B, H, S, hd] layout both go in without a copy; a ragged S is masked in
// the kernel, never padded in the caller's tensors.
//
// What bounds it on this card.  At the training path's shape (B = 960
// client-samples, S = 32, H = KH = 4, hd = 8) a call moves about 15.7 MB
// against 0.07 GFLOP: bytes, 4.7 µs at 3.35 TB/s; with 8-wide heads the
// work per row is so small that instruction issue, and the lanes the causal
// triangle leaves idle, weigh as much as the bytes.  At the JAX sweep's
// shapes (S 128–512, hd 32–128) and the LMs' (S 256–4096, hd 64–256) it is
// operations: the tensor cores in bfloat16, FFMA in float32 (TF32 would not
// hold the float32 tolerance, 2e-5).  Four regimes, one launch per call:
//
// * short (S <= 64, hd 8, 16 or 32): attn_short_kernel.  One block per
//   (batch row, group of heads), a lane per (query row, head): a warp
//   covers up to 8 heads × 32/8 consecutive rows, so its lanes walk key
//   ranges that differ by a few keys (the triangle's idle lanes stay few).
//   K and V of the row's KV heads are staged once with 16-byte cp.async
//   copies and shared by the warps of a GQA group; the q row,
//   the running max and sum and the output accumulator live in registers
//   (templated on hd).  The lanes walk the warp's keys eight at a time,
//   branch-free (a key a lane cannot see weighs 0), with one rescale per
//   eight; no score matrix and no barrier in the key loop.
// * long (hd 16, 32, 64 or 128, 16-byte aligned operands): blocks of
//   query-row tiles, K/V tiles double-buffered with cp.async, the tiles
//   past the causal edge or before the window skipped, heavy query tiles
//   scheduled first, the mask applied only on tiles that meet an edge.
//   bfloat16: attn_mma_kernel, a warp per 16 query rows, Q·Kᵀ and P·V on
//   the tensor cores with mma.sync.m16n8k16 (f32 accumulate), fragments by
//   ldmatrix (V transposed), P kept in registers between the two products,
//   the output staged in shared memory for 16-byte stores.  A small grid
//   (the JAX sweep: a few heads of S 128–512) is bound by the chain of key
//   tiles of its longest block, not by the tensor cores, so there the
//   block splits its keys over 2 or 4 warp groups that merge their
//   softmax state at the end (ops.py:mma_layout picks rows, splits and the
//   key tile).  float32: attn_ffma_kernel, 64 rows and 4 warps a block,
//   register-blocked FFMA (4×4 scores and 4 rows × hd/8 outputs a thread).
// * wide (bfloat16, hd 112 or 256, 16-byte aligned operands):
//   attn_wide_kernel, the long regime's tensor-core loop (mma.sync.m16n8k16,
//   f32 accumulate; cp.async double-buffered K/V; tiles past the causal edge
//   or before the window skipped, heavy query tiles first, the mask only on
//   edge tiles) laid out for a head dim whose 16 x hd f32 output accumulator
//   takes 56 or 128 registers a lane: Q stays in shared memory and is read
//   by ldmatrix each key tile (16-wide head-dim steps, one A fragment live),
//   K fragments two key n-blocks per ldmatrix.x4 and V fragments two output
//   n-blocks per ldmatrix.x4.trans, so that nothing else is held across the
//   loop.  A block of 8 warps (hd 256) or 4 (hd 112), 16 query rows each,
//   serves as many query heads of one KV head as divide both its warps and
//   H / KH: each K/V tile is read once for all of them.  Key tiles of 64;
//   8 warps on a SM at either width (one block at hd 256, whose 16 x 256
//   accumulator takes the registers, two at hd 112).  ops.py:plan sends
//   the shapes here.
// * generic (float32 at any hd outside the long regime's, any other bfloat16
//   hd up to 256, or operands not aligned for 16-byte copies; not designed
//   for this card's tensor cores): attn_generic_kernel, one block per
//   (batch, head, 32 query rows) with the scores and the accumulator in
//   shared memory, scalar FFMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_HD 256
#define MAX_SMEM 232448            // bytes of shared memory a block may use
#define FULL_MASK 0xffffffffu
#define SHORT_MAX_S 64
#define SHORT_MAX_THREADS 512

typedef __nv_bfloat16 bf16;

struct Layout {                    // element strides; the head dim has stride 1
    long long b, s, h;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(bf16* p, float x) {
    *p = __float2bfloat16(x);
}

// 16 bytes of T from global memory as floats (4 float32 or 8 bfloat16)
__device__ __forceinline__ void load16(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
        const float2 f = __bfloat1622float2(h);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}
// 16 bytes of T to global memory from floats
__device__ __forceinline__ void store16(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store16(bf16* p, const float* in) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

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

// the visible keys of query row qp: kp <= qp, kp > qp - window, kp < S
__device__ __forceinline__ bool visible(int qp, int kp, int S, int window) {
    return kp <= qp && kp < S && (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// short: a lane per query row, K/V of the batch row staged once
// ---------------------------------------------------------------------------
// K and V in the input type, each KV head's rows padded by 16 bytes so
// that lanes of different heads read different banks
static size_t short_smem(int S, int hd, int nkv, int esz) {
    return (size_t)2 * nkv * ((size_t)esz * S * hd + 16);
}

#define LOG2E 1.4426950408889634f

// 2^x in one MUFU instruction (relative error about 2^-22, far inside the
// float32 tolerance); 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// heads a short warp covers: the largest power of two dividing the
// block's heads, at most 8 (so at least 4 rows a head)
__host__ __device__ inline int short_hpw(int hpb) {
    int w = 1;
    while (w < 8 && hpb % (2 * w) == 0) w *= 2;
    return w;
}

template <typename T, int HD>
__global__ void __launch_bounds__(SHORT_MAX_THREADS)
attn_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, Layout lq,
                  Layout lk, Layout lv, Layout lo, int H, int KH, int S,
                  int hpb, float scale, int window, int vec) {
    extern __shared__ float4 smem4[];
    constexpr int VE = 16 / sizeof(T);             // elements per 16 bytes
    static_assert(HD % VE == 0, "a head-dim row is whole 16-byte pieces");
    const int R = H / KH;
    const int ngrp = H / hpb;
    const long long b = blockIdx.x / ngrp;
    const int h0 = (int)(blockIdx.x % ngrp) * hpb;
    const int kv0 = h0 / R, nkv = (h0 + hpb - 1) / R - kv0 + 1;
    const int HS = S * HD + VE;                    // a KV head's stride
    T* Ks = reinterpret_cast<T*>(smem4);           // [nkv][S·HD + VE]
    T* Vs = Ks + nkv * HS;                         // [nkv][S·HD + VE]

    // K and V of the block's KV heads: 16-byte cp.async copies in flight
    // together while the lanes load their q rows
    const T* kb = k + b * lk.b + (long long)kv0 * lk.h;
    const T* vb = v + b * lv.b + (long long)kv0 * lv.h;
    if (vec) {
        constexpr int C = HD / VE;
        for (int i = threadIdx.x; i < nkv * S * C; i += blockDim.x) {
            const int j = i / (S * C), s = (i / C) % S, c = i % C;
            const int at = j * HS + (s * C + c) * VE;
            cp_async16(Ks + at, kb + s * lk.s + j * lk.h + c * VE, true);
            cp_async16(Vs + at, vb + s * lv.s + j * lv.h + c * VE, true);
        }
        cp_async_commit();
    } else {
        for (int i = threadIdx.x; i < nkv * S * HD; i += blockDim.x) {
            const int j = i / (S * HD), s = (i / HD) % S, d = i % HD;
            Ks[j * HS + s * HD + d] = kb[s * lk.s + j * lk.h + d];
            Vs[j * HS + s * HD + d] = vb[s * lv.s + j * lv.h + d];
        }
    }

    // a warp: hpw heads × rpw consecutive query rows, lane = row · hpw +
    // head, so that its lanes' key ranges differ by less than rpw
    const int hpw = short_hpw(hpb), rpw = 32 / hpw;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wpg = (S + rpw - 1) / rpw;           // warps per head group
    const int h = h0 + (warp / wpg) * hpw + lane % hpw;
    const int wq0 = (warp % wpg) * rpw;
    const int qi = wq0 + lane / hpw;
    const bool valid = qi < S;
    const T* kh = Ks + (h / R - kv0) * HS;
    const T* vh = Vs + (h / R - kv0) * HS;

    // the q row, scaled so that exp2 of a score difference is its softmax
    // weight
    float qr[HD], acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
        qr[d] = 0.0f;
        acc[d] = 0.0f;
    }
    const T* qp = q + b * lq.b + (long long)qi * lq.s + (long long)h * lq.h;
    if (valid) {
        if (vec) {
#pragma unroll
            for (int c = 0; c < HD / VE; ++c) load16(qp + c * VE, qr + c * VE);
        } else {
#pragma unroll
            for (int d = 0; d < HD; ++d) qr[d] = load_f(qp + d);
        }
    }
    const float qscale = scale * LOG2E;
    if (vec) cp_async_wait<0>();
    __syncthreads();

    float m = -INFINITY, l = 0.0f;                 // in log2 units
    const int first = window > 0 ? max(0, qi - window + 1) : 0;
    const int k_lo = window > 0 ? max(0, wq0 - window + 1) : 0;
    const int k_hi = min(S - 1, wq0 + rpw - 1);    // the warp's last row
    // eight keys at a time, branch-free: a key this lane cannot see gets
    // score -inf, hence weight 0 (its address is clamped into the tile)
    for (int kb0 = k_lo; kb0 <= k_hi; kb0 += 8) {
        float sc[8];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int kp = kb0 + j;
            const T* kr = kh + min(kp, S - 1) * HD;
            float dot = 0.0f;
#pragma unroll
            for (int d = 0; d < HD; d += VE) {
                float kv[VE];
                load16(kr + d, kv);
#pragma unroll
                for (int e = 0; e < VE; ++e) dot = fmaf(qr[d + e], kv[e], dot);
            }
            const bool vis = valid & (kp >= first) & (kp <= qi);
            sc[j] = vis ? dot * qscale : -INFINITY;
            mx = fmaxf(mx, sc[j]);
        }
        const float m_new = fmaxf(m, mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(m - m_use);
        m = m_new;
        l *= alpha;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float p = exp2f(sc[j] - m_use);
            l += p;
            const T* vr = vh + min(kb0 + j, S - 1) * HD;
#pragma unroll
            for (int d = 0; d < HD; d += VE) {
                float vv[VE];
                load16(vr + d, vv);
#pragma unroll
                for (int e = 0; e < VE; ++e)
                    acc[d + e] = fmaf(p, vv[e], acc[d + e]);
            }
        }
    }
    if (!valid) return;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= inv;
    T* op = o + b * lo.b + (long long)qi * lo.s + (long long)h * lo.h;
    if (vec) {
#pragma unroll
        for (int c = 0; c < HD / VE; ++c) store16(op + c * VE, acc + c * VE);
    } else {
#pragma unroll
        for (int d = 0; d < HD; ++d) store_f(op + d, acc[d]);
    }
}

// ---------------------------------------------------------------------------
// long, bfloat16: tensor cores (mma.sync.m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------
#define LQ 64                      // float32: query rows per block
#define MMA_BK 64                  // keys per tile, bfloat16 (or 32 with
                                   // four key splits)
#define FMA_BK 32                  // keys per tile, float32
#define LONG_THREADS 128

// K and V, two stages of ks tiles (one per key split), and the block's
// query rows (at most 64), rows padded by 8; the splits' merge and the
// output's staging reuse the K/V space
static size_t mma_smem(int hd, int ks, int bk) {
    return sizeof(bf16) * (4 * ks * (size_t)bk + 64) * (hd + 8);
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const bf16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(a));
}

// The tile's scores s (NB key n-blocks in the mma accumulator layout: this
// lane's rows g and g + 8, columns 2c and 2c + 1 of each n-block) masked to
// each row's visible offsets [lo, hi] from this lane's first column,
// scaled to log2 units and taken into the running max m and sum l (the
// four lanes of a row agree on m): s becomes the softmax weights, alpha
// each row's rescale of the output accumulator.
template <int NB>
__device__ __forceinline__ void online_softmax(float (&s)[NB][4],
                                               const int (&hi)[2],
                                               const int (&lo)[2],
                                               float qscale, float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2]) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int off = nb * 8 + (e & 1), r = e >> 1;
            const bool vis = (off <= hi[r]) & (off >= lo[r]);
            const float x = vis ? s[nb][e] * qscale : -INFINITY;
            s[nb][e] = x;
            mx[r] = fmaxf(mx[r], x);
        }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_use[r] = m_new == -INFINITY ? 0.0f : m_new;
        alpha[r] = fast_exp2(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float p = fast_exp2(s[nb][e] - m_use[e >> 1]);
            s[nb][e] = p;
            l[e >> 1] += p;
        }
}

// The warp's 16 output rows (the accumulator's HD / 8 n-blocks over the row
// sums l, summed here over a row's four lanes) through shared memory at os
// (rows of KP elements), then 16-byte stores of the rows below S to ob
// (row stride ls).
template <int HD, int KP>
__device__ __forceinline__ void store_rows(const float (&oacc)[HD / 8][4],
                                           float (&l)[2], bf16* os,
                                           bf16* ob, long long ls, int qw,
                                           int S) {
    constexpr int C = HD / 8;                     // 16-byte chunks a row
    const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL_MASK, l[r], 1);
        l[r] += __shfl_xor_sync(FULL_MASK, l[r], 2);
        const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int dn = 0; dn < HD / 8; ++dn)
            *reinterpret_cast<uint32_t*>(os + (g + 8 * r) * KP + dn * 8 + 2 * c) =
                pack_bf16(oacc[dn][2 * r] * inv, oacc[dn][2 * r + 1] * inv);
    }
    __syncwarp();
    for (int i = lane; i < 16 * C; i += 32) {
        const int r = i / C, cc = i % C;
        if (qw + r < S)
            *reinterpret_cast<uint4*>(ob + (long long)(qw + r) * ls + cc * 8) =
                *reinterpret_cast<const uint4*>(os + r * KP + cc * 8);
    }
}

// One block: 16·RG query rows of one (batch, head), RG·KS warps, key
// tiles of BK.  Warp w owns rows 16·(w % RG) .. +16 and every KS-th key
// tile from (w / RG): the KS key splits run side by side, so the longest
// block walks 1/KS as many tiles in a row, and merge their (max, sum,
// accumulator) at the end.  Two row groups (32 rows) a block spread a short
// sequence's few heavy warps over more SMs than four.
template <int HD, int RG, int KS, int BK>
__global__ void __launch_bounds__(32 * RG * KS)
attn_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, Layout lq,
                Layout lk, Layout lv, Layout lo, int H, int KH, int S, int nq,
                float scale, int window) {
    constexpr int KP = HD + 8;                    // padded row, elements
    constexpr int NB = BK / 8;                    // key n-blocks per tile
    constexpr int NG = HD >= 128 ? 2 : 4;         // n-blocks a K batch
    constexpr int C = HD / 8;                     // 16-byte chunks per row
    constexpr int TILE = BK * KP;
    extern __shared__ float4 smem4[];
    constexpr int THREADS = 32 * RG * KS, BQ = 16 * RG;
    bf16* Ks = reinterpret_cast<bf16*>(smem4);    // [stage][split][BK][KP]
    bf16* Vs = Ks + 2 * KS * TILE;                // [stage][split][BK][KP]
    bf16* Qs = Vs + 2 * KS * TILE;                // [BQ][KP]

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int rg = warp % RG, half = warp / RG;
    const long long bid = blockIdx.x;
    const int qt = nq - 1 - (int)(bid % nq);      // long rows first
    const int h = (int)((bid / nq) % H);
    const long long b = bid / ((long long)nq * H);
    const int kvh = h / (H / KH);
    const int q0 = qt * BQ, qw = q0 + rg * 16;
    const int rows[2] = {qw + g, qw + g + 8};

    const bf16* kb = k + b * lk.b + (long long)kvh * lk.h;
    const bf16* vb = v + b * lv.b + (long long)kvh * lv.h;
    const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
    const int kt_hi = (min(S, q0 + BQ) - 1) / BK;
    const int niter = (kt_hi - kt_lo + KS) / KS;  // groups of KS tiles
    auto issue = [&](int it, int buf) {
        for (int i = tid; i < 2 * KS * BK * C; i += THREADS) {
            const int which = i / (KS * BK * C);  // 0 K, 1 V
            const int hf = (i / (BK * C)) % KS;
            const int r = (i / C) % BK, cc = i % C;
            const int kt = kt_lo + KS * it + hf;
            if (kt > kt_hi) continue;
            const int key = kt * BK + r;
            const bool in = key < S;
            const bf16* src = which ? vb + (in ? key * lv.s : 0)
                                    : kb + (in ? key * lk.s : 0);
            bf16* dst = (which ? Vs : Ks) + (buf * KS + hf) * TILE + r * KP
                        + cc * 8;
            cp_async16(dst, src + cc * 8, in);
        }
    };
    // the block's query rows and the first key tiles, one copy group
    const bf16* qb = q + b * lq.b + (long long)h * lq.h;
    for (int i = tid; i < BQ * C; i += THREADS) {
        const int r = i / C, cc = i % C;
        const bool in = q0 + r < S;
        cp_async16(Qs + r * KP + cc * 8,
                   qb + (in ? (long long)(q0 + r) * lq.s : 0) + cc * 8, in);
    }
    issue(0, 0);
    cp_async_commit();
    uint32_t qa[HD / 16][4];           // this warp's rows as A fragments
    const float qscale = scale * LOG2E;           // scores in log2 units

    float oacc[HD / 8][4];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[i][e] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

    for (int it = 0; it < niter; ++it) {
        const int buf = it & 1;
        if (it + 1 < niter) issue(it + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (it == 0) {
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                const bf16* qr = Qs + (rg * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * KP
                                 + kk * 16 + 8 * (lane >> 4);
                ldmatrix_x4(qa[kk], qr);
            }
        }
        const int kt = kt_lo + KS * it + half;
        if (kt <= kt_hi) {
            const bf16* kt_s = Ks + (buf * KS + half) * TILE;
            const bf16* vt_s = Vs + (buf * KS + half) * TILE;

            // where the tile meets the causal edge, the window or the end
            // of the sequence: each row's visible keys as offsets from this
            // lane's first column, and the key n-blocks past the warp's
            // last row (skipped: fully masked)
            const int k0 = kt * BK;
            const bool edge = k0 + BK - 1 > qw || k0 + BK > S ||
                              (window > 0 && k0 <= qw + 15 - window);
            const int last = min(qw + 15, S - 1) - k0;
            const int nb_lim = !edge ? NB : (last < 0 ? 0 : min(NB, last / 8 + 1));
            int hi[2], lo[2];              // off-tile edges: no branch below
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                hi[r] = edge ? min(rows[r], S - 1) - k0 - 2 * c : BK;
                lo[r] = edge && window > 0
                            ? rows[r] - window + 1 - k0 - 2 * c : -BK;
            }

            // S = Q·Kᵀ, NG key n-blocks at a time: their K fragments first
            // (ldmatrix), then the MMAs with neighbouring ones independent
            // (one accumulator each), so that neither latency is exposed
            float s[NB][4];
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
            for (int nb0 = 0; nb0 < NB; nb0 += NG) {
                if (nb0 >= nb_lim) break;          // the rest fully masked
                uint32_t kf[NG][HD / 16][2];
#pragma unroll
                for (int i = 0; i < NG; ++i) {
                    const bf16* kr = kt_s + ((nb0 + i) * 8 + (lane & 7)) * KP;
                    if constexpr (HD / 16 == 1) {
                        const bf16* kq = kt_s + ((nb0 + i) * 8 + g) * KP + 2 * c;
                        kf[i][0][0] = ld32(kq);
                        kf[i][0][1] = ld32(kq + 8);
                    } else {
#pragma unroll
                        for (int kk = 0; kk < HD / 16; kk += 2) {
                            uint32_t r4[4];
                            ldmatrix_x4(r4, kr + kk * 16 + (lane >> 3) * 8);
                            kf[i][kk][0] = r4[0];
                            kf[i][kk][1] = r4[1];
                            kf[i][kk + 1][0] = r4[2];
                            kf[i][kk + 1][1] = r4[3];
                        }
                    }
                }
#pragma unroll
                for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
                    for (int i = 0; i < NG; ++i)
                        mma16816(s[nb0 + i], qa[kk], kf[i][kk][0],
                                 kf[i][kk][1]);
            }

            // mask, scale (to log2 units), online softmax
            float alpha[2];
            online_softmax(s, hi, lo, qscale, m, l, alpha);
#pragma unroll
            for (int i = 0; i < HD / 8; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) oacc[i][e] *= alpha[e >> 1];

            // O += P·V: P's accumulator layout is the A fragment's; the V
            // fragments of a 16-key step first (ldmatrix.trans), then its
            // MMAs, one accumulator each
#pragma unroll
            for (int j = 0; j < BK / 16; ++j) {
                if (2 * j >= nb_lim) break;
                const uint32_t pa[4] = {
                    pack_bf16(s[2 * j][0], s[2 * j][1]),
                    pack_bf16(s[2 * j][2], s[2 * j][3]),
                    pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                    pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
                const bf16* vr = vt_s + (j * 16 + (lane & 15)) * KP;
                uint32_t vf[HD / 8][2];
#pragma unroll
                for (int dn = 0; dn < HD / 8; ++dn)
                    ldmatrix_x2_trans(vf[dn], vr + dn * 8);
#pragma unroll
                for (int dn = 0; dn < HD / 8; ++dn)
                    mma16816(oacc[dn], pa, vf[dn][0], vf[dn][1]);
            }
        }
        __syncthreads();
    }

    // merge the other key splits into the first, through shared memory
    if constexpr (KS > 1) {
        constexpr int MW = 5 + HD / 2;            // floats handed over, + 1 pad
        float* xch = reinterpret_cast<float*>(smem4);
        if (half > 0) {
            float* w = xch + (((half - 1) * RG + rg) * 32 + lane) * MW;
            w[0] = m[0]; w[1] = m[1]; w[2] = l[0]; w[3] = l[1];
#pragma unroll
            for (int i = 0; i < HD / 8; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) w[4 + i * 4 + e] = oacc[i][e];
        }
        __syncthreads();
        if (half > 0) return;
#pragma unroll
        for (int sp = 1; sp < KS; ++sp) {
            const float* x = xch + (((sp - 1) * RG + rg) * 32 + lane) * MW;
            float wa[2], wb[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float mm = fmaxf(m[r], x[r]);
                const float mu = mm == -INFINITY ? 0.0f : mm;
                wa[r] = fast_exp2(m[r] - mu);
                wb[r] = fast_exp2(x[r] - mu);
                l[r] = l[r] * wa[r] + x[2 + r] * wb[r];
                m[r] = mm;
            }
#pragma unroll
            for (int i = 0; i < HD / 8; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    oacc[i][e] = oacc[i][e] * wa[e >> 1]
                                 + x[4 + i * 4 + e] * wb[e >> 1];
        }
    }

    // the warp's 16 output rows through shared memory (past the merge's
    // space)
    bf16* os = reinterpret_cast<bf16*>(reinterpret_cast<float*>(smem4)
                                       + (KS - 1) * RG * 32 * (5 + HD / 2))
               + rg * 16 * KP;
    store_rows<HD, KP>(oacc, l, os, o + b * lo.b + (long long)h * lo.h, lo.s,
                       qw, S);
}

// ---------------------------------------------------------------------------
// long, float32: register-blocked FFMA
// ---------------------------------------------------------------------------
static size_t ffma_smem(int hd) {
    return sizeof(float) * ((size_t)LQ * (hd + 4)            // Q tile
                            + 2 * (size_t)FMA_BK * (hd + 4)  // K, two stages
                            + 2 * (size_t)FMA_BK * hd        // V, two stages
                            + (size_t)LQ * (FMA_BK + 1));    // P
}

template <int HD>
__global__ void __launch_bounds__(LONG_THREADS)
attn_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Layout lq, Layout lk, Layout lv, Layout lo, int H, int KH,
                 int S, int nq, float scale, int window) {
    constexpr int QP = HD + 4;                    // padded row, floats
    constexpr int VW = HD >= 32 ? 4 : 2;          // output columns together
    constexpr int ND = HD / (8 * VW);
    constexpr int C = HD / 4;                     // 16-byte chunks per row
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);  // [LQ][QP]
    float* Ks = Qs + LQ * QP;                     // 2 × [FMA_BK][QP]
    float* Vs = Ks + 2 * FMA_BK * QP;             // 2 × [FMA_BK][HD]
    float* Ps = Vs + 2 * FMA_BK * HD;             // [LQ][FMA_BK + 1]

    const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
    const long long bid = blockIdx.x;
    const int qt = nq - 1 - (int)(bid % nq);      // long rows first
    const int h = (int)((bid / nq) % H);
    const long long b = bid / ((long long)nq * H);
    const int kvh = h / (H / KH);
    const int q0 = qt * LQ;

    const float* qb = q + b * lq.b + (long long)h * lq.h;
    const float* kb = k + b * lk.b + (long long)kvh * lk.h;
    const float* vb = v + b * lv.b + (long long)kvh * lv.h;
    for (int i = tid; i < LQ * C; i += LONG_THREADS) {
        const int r = i / C, cc = i % C;
        const bool in = q0 + r < S;
        cp_async16(Qs + r * QP + cc * 4,
                   qb + (in ? (long long)(q0 + r) * lq.s : 0) + cc * 4, in);
    }
    auto issue = [&](int kt, int buf) {
        for (int i = tid; i < 2 * FMA_BK * C; i += LONG_THREADS) {
            const int which = i / (FMA_BK * C);
            const int r = (i / C) % FMA_BK, cc = i % C;
            const int key = kt * FMA_BK + r;
            const bool in = key < S;
            if (which)
                cp_async16(Vs + (buf * FMA_BK + r) * HD + cc * 4,
                           vb + (in ? key * lv.s : 0) + cc * 4, in);
            else
                cp_async16(Ks + (buf * FMA_BK + r) * QP + cc * 4,
                           kb + (in ? key * lk.s : 0) + cc * 4, in);
        }
    };
    const int kt_lo = window > 0 ? max(0, q0 - window + 1) / FMA_BK : 0;
    const int kt_hi = (min(S, q0 + LQ) - 1) / FMA_BK;
    issue(kt_lo, 0);
    cp_async_commit();

    const float qscale = scale * LOG2E;
    float acc[4][ND * VW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND * VW; ++j) acc[i][j] = 0.0f;
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.0f;
    }

    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int buf = (kt - kt_lo) & 1;
        if (kt < kt_hi) issue(kt + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();

        // scores: rows ty + 16·i, keys tx + 8·j
        const float* kt_s = Ks + buf * FMA_BK * QP;
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4*>(
                    Qs + (ty + 16 * i) * QP + d);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kv[j] = *reinterpret_cast<const float4*>(
                    kt_s + (tx + 8 * j) * QP + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float a = s[i][j];
                    a = fmaf(qv[i].x, kv[j].x, a);
                    a = fmaf(qv[i].y, kv[j].y, a);
                    a = fmaf(qv[i].z, kv[j].z, a);
                    a = fmaf(qv[i].w, kv[j].w, a);
                    s[i][j] = a;
                }
        }
        // mask only where the tile meets the causal edge, the window or
        // the end of the sequence; scores in log2 units
        const int k0 = kt * FMA_BK;
        const bool edge = k0 + FMA_BK - 1 > q0 || k0 + FMA_BK > S ||
                          (window > 0 && k0 <= q0 + LQ - 1 - window);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qp = q0 + ty + 16 * i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = (!edge || visible(qp, k0 + tx + 8 * j, S, window))
                              ? s[i][j] * qscale
                              : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float m_use = m_new == -INFINITY ? 0.0f : m_new;
            const float alpha = fast_exp2(m[i] - m_use);
            m[i] = m_new;
            l[i] *= alpha;
#pragma unroll
            for (int j = 0; j < ND * VW; ++j) acc[i][j] *= alpha;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = fast_exp2(s[i][j] - m_use);
                l[i] += p;
                Ps[(ty + 16 * i) * (FMA_BK + 1) + tx + 8 * j] = p;
            }
        }
        __syncthreads();

        // O += P·V: rows ty + 16·i, columns VW·tx + 8·VW·dd
        const float* vt_s = Vs + buf * FMA_BK * HD + VW * tx;
#pragma unroll 4
        for (int kk = 0; kk < FMA_BK; ++kk) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                p[i] = Ps[(ty + 16 * i) * (FMA_BK + 1) + kk];
#pragma unroll
            for (int dd = 0; dd < ND; ++dd) {
                float vv[VW];
                if constexpr (VW == 4) {
                    const float4 t = *reinterpret_cast<const float4*>(
                        vt_s + kk * HD + 8 * VW * dd);
                    vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
                } else {
                    const float2 t = *reinterpret_cast<const float2*>(
                        vt_s + kk * HD + 8 * VW * dd);
                    vv[0] = t.x; vv[1] = t.y;
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < VW; ++e)
                        acc[i][dd * VW + e] =
                            fmaf(p[i], vv[e], acc[i][dd * VW + e]);
            }
        }
        __syncthreads();
    }

    float* ob = o + b * lo.b + (long long)h * lo.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
            l[i] += __shfl_xor_sync(FULL_MASK, l[i], off);
        const int qp = q0 + ty + 16 * i;
        if (qp >= S) continue;
        const float inv = 1.0f / fmaxf(l[i], 1e-30f);
        float* orow = ob + (long long)qp * lo.s + VW * tx;
#pragma unroll
        for (int dd = 0; dd < ND; ++dd)
#pragma unroll
            for (int e = 0; e < VW; ++e)
                orow[8 * VW * dd + e] = acc[i][dd * VW + e] * inv;
    }
}

// ---------------------------------------------------------------------------
// wide, bfloat16: hd 112 and 256 on the tensor cores
// ---------------------------------------------------------------------------
#define WIDE_BK 64                 // keys per tile
// warps a block, 16 query rows each: 8 warps on a SM either way (one block
// of 8 at hd 256, 242–246 registers a thread; two of 4 at hd 112).  At hd
// 256 one block of 8 warps with 64-key tiles ran 15–17 % faster than two
// blocks of 4 with 32-key tiles: half the K/V tiles written to shared
// memory and read from L2 per query row, half the tiles' barriers
__host__ __device__ constexpr int wide_warps(int hd) {
    return hd > 128 ? 8 : 4;
}
static bool wide_hd(int hd) { return hd == 112 || hd == 256; }

// the block's query rows, then K and V in two stages, rows padded by 8
// (16 bytes: ldmatrix's eight rows fall in distinct banks): 202 752 bytes
// at hd 256, 76 800 at hd 112
static size_t wide_smem(int hd) {
    return sizeof(bf16) * (16 * wide_warps(hd) + 4 * (size_t)WIDE_BK)
           * (hd + 8);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// One block: hpb query heads of one KV head (hpb divides R = H / KH and
// the block's NW warps) × the 16·(NW/hpb) query positions of tile qt;
// warp w serves head w / (NW/hpb), positions 16·(w % (NW/hpb)) onward.
// Grid: (qt, batch, KV head, head group), qt slowest and the longest
// tiles first.
template <int HD>
__global__ void __launch_bounds__(32 * wide_warps(HD), 8 / wide_warps(HD))
attn_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, Layout lq,
                 Layout lk, Layout lv, Layout lo, int H, int KH, int S,
                 int nq, int hpb, float scale, int window) {
    constexpr int NW = wide_warps(HD), BK = WIDE_BK;
    constexpr int KP = HD + 8;                    // padded row, elements
    constexpr int NB = BK / 8;                    // key n-blocks a tile
    constexpr int DN = HD / 8;                    // output n-blocks
    constexpr int C = HD / 8;                     // 16-byte chunks a row
    constexpr int TILE = BK * KP;
    static_assert(HD % 16 == 0 && DN % 2 == 0 && NB % 2 == 0, "tile shape");
    extern __shared__ float4 smem4[];
    bf16* Qs = reinterpret_cast<bf16*>(smem4);    // [NW·16][KP]
    bf16* Ks = Qs + 16 * NW * KP;                 // [stage][BK][KP]
    bf16* Vs = Ks + 2 * TILE;                     // [stage][BK][KP]

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int rgs = NW / hpb;                     // warps a head
    const int R = H / KH, ngrp = R / hpb, BQ = 16 * rgs;
    const long long inner = (long long)gridDim.x / nq;  // B · KH · ngrp
    const long long bid = blockIdx.x;
    const int qt = nq - 1 - (int)(bid / inner);   // long rows first
    const long long rest = bid % inner;
    const int hg = (int)(rest % ngrp);
    const int kvh = (int)((rest / ngrp) % KH);
    const long long b = rest / ((long long)ngrp * KH);
    const int h0 = kvh * R + hg * hpb;            // the block's first head
    const int q0 = qt * BQ;
    const int h = h0 + warp / rgs, qw = q0 + (warp % rgs) * 16;
    const int rows[2] = {qw + g, qw + g + 8};

    // the block's query rows (zero past S), then the first key tile
    for (int i = tid; i < 16 * NW * C; i += 32 * NW) {
        const int r = i / C, cc = i % C, w = r / 16;
        const int qp = q0 + (w % rgs) * 16 + r % 16;
        const bool in = qp < S;
        cp_async16(Qs + r * KP + cc * 8,
                   q + b * lq.b + (long long)(h0 + w / rgs) * lq.h
                     + (in ? (long long)qp * lq.s : 0) + cc * 8, in);
    }
    const bf16* kb = k + b * lk.b + (long long)kvh * lk.h;
    const bf16* vb = v + b * lv.b + (long long)kvh * lv.h;
    const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
    const int kt_hi = (min(S, q0 + BQ) - 1) / BK;
    auto issue = [&](int kt, int buf) {
        for (int i = tid; i < 2 * BK * C; i += 32 * NW) {
            const int which = i / (BK * C);       // 0 K, 1 V
            const int r = (i / C) % BK, cc = i % C;
            const int key = kt * BK + r;
            const bool in = key < S;
            const bf16* src = which ? vb + (in ? (long long)key * lv.s : 0)
                                    : kb + (in ? (long long)key * lk.s : 0);
            cp_async16((which ? Vs : Ks) + buf * TILE + r * KP + cc * 8,
                       src + cc * 8, in);
        }
    };
    issue(kt_lo, 0);
    cp_async_commit();

    const float qscale = scale * LOG2E;           // scores in log2 units
    float oacc[DN][4];
#pragma unroll
    for (int i = 0; i < DN; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[i][e] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    // ldmatrix row addresses: this lane's row of the warp's Q (A fragment:
    // rows 0-15, columns 0-7 then 8-15), of two key n-blocks (B fragments
    // of n-blocks nb and nb + 1, each its two 8-column halves) and of a
    // 16-key step of V (transposed: two 8-column output n-blocks)
    const bf16* qrow = Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1))
                                * KP + 8 * (lane >> 4);
    const int krow = ((lane & 7) + 8 * (lane >> 4)) * KP
                     + 8 * ((lane >> 3) & 1);
    const int vrow = (lane & 15) * KP + 8 * (lane >> 4);
    // the warp's key range: none past its last row, none before its first
    // row's window
    const int w_hi = min(qw + 15, S - 1);
    const int w_lo = window > 0 ? qw - window + 1 : 0;

    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int buf = (kt - kt_lo) & 1;
        if (kt < kt_hi) issue(kt + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const int k0 = kt * BK;
        if (qw < S && k0 <= w_hi && k0 + BK - 1 >= w_lo) {
            const bf16* kt_s = Ks + buf * TILE;
            const bf16* vt_s = Vs + buf * TILE;
            // where the tile meets the causal edge, the window or the end of
            // the sequence: each row's visible keys as offsets from this
            // lane's first column, and the key n-blocks past the warp's
            // last row (skipped: fully masked)
            const bool edge = k0 + BK - 1 > qw || k0 + BK > S ||
                              (window > 0 && k0 <= qw + 15 - window);
            const int nb_lim = !edge ? NB : min(NB, (w_hi - k0) / 8 + 1);
            int hi[2], lo[2];              // off-tile edges: no branch below
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                hi[r] = edge ? min(rows[r], S - 1) - k0 - 2 * c : BK;
                lo[r] = edge && window > 0
                            ? rows[r] - window + 1 - k0 - 2 * c : -BK;
            }

            // S = Q·Kᵀ over 16-wide head-dim steps: the step's Q fragment,
            // then two key n-blocks per ldmatrix.x4, NB accumulators
            float s[NB][4];
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                uint32_t qa[4];
                ldmatrix_x4(qa, qrow + kk * 16);
#pragma unroll
                for (int nb = 0; nb < NB; nb += 2) {
                    if (nb >= nb_lim) break;       // the rest fully masked
                    uint32_t kf[4];
                    ldmatrix_x4(kf, kt_s + krow + nb * 8 * KP + kk * 16);
                    mma16816(s[nb], qa, kf[0], kf[1]);
                    mma16816(s[nb + 1], qa, kf[2], kf[3]);
                }
            }

            // mask, scale (to log2 units), online softmax
            float alpha[2];
            online_softmax(s, hi, lo, qscale, m, l, alpha);
#pragma unroll
            for (int i = 0; i < DN; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) oacc[i][e] *= alpha[e >> 1];

            // O += P·V: P's accumulator layout is the A fragment's; per
            // 16-key step, two output n-blocks per ldmatrix.x4.trans
#pragma unroll
            for (int j = 0; j < BK / 16; ++j) {
                if (2 * j >= nb_lim) break;
                const uint32_t pa[4] = {
                    pack_bf16(s[2 * j][0], s[2 * j][1]),
                    pack_bf16(s[2 * j][2], s[2 * j][3]),
                    pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                    pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
                const bf16* vj = vt_s + vrow + j * 16 * KP;
#pragma unroll
                for (int dn = 0; dn < DN; dn += 2) {
                    uint32_t vf[4];
                    ldmatrix_x4_trans(vf, vj + dn * 8);
                    mma16816(oacc[dn], pa, vf[0], vf[1]);
                    mma16816(oacc[dn + 1], pa, vf[2], vf[3]);
                }
            }
        }
        __syncthreads();
    }

    // the warp's 16 output rows through its own Q rows in shared memory
    // (read by no other warp)
    store_rows<HD, KP>(oacc, l, Qs + warp * 16 * KP,
                       o + b * lo.b + (long long)h * lo.h, lo.s, qw, S);
}

// ---------------------------------------------------------------------------
// generic: float32 or unaligned operands outside the other regimes, any hd
// up to 256, any strides (scores and accumulator in shared memory; not
// designed for this card's tensor cores)
// ---------------------------------------------------------------------------
#define G_BQ 32                    // query rows per block
#define G_BK 32                    // keys per shared-memory tile
#define G_THREADS 128
#define G_TPR (G_THREADS / G_BQ)   // threads per query row in the softmax
#define NEG_INF (-1e30f)

static_assert(G_THREADS == G_BQ * G_TPR && 32 % G_TPR == 0,
              "a query row's softmax lanes must sit inside one warp");

static size_t generic_smem(int hd) {
    return sizeof(float) * ((size_t)G_BQ * hd          // query tile
                            + (size_t)G_BK * (hd + 1)  // key tile, padded
                            + (size_t)G_BK * hd        // value tile
                            + (size_t)G_BQ * (G_BK + 1)  // scores, then P
                            + (size_t)G_BQ * hd        // output accumulator
                            + 3 * G_BQ);               // max, sum, rescale
}

template <typename T>
__global__ void __launch_bounds__(G_THREADS)
attn_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, Layout lq,
                    Layout lk, Layout lv, Layout lo, int H, int KH, int S,
                    int hd, int nq, float scale, int window) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* qs = smem;                          // [G_BQ][hd]
    float* ks = qs + G_BQ * hd;                // [G_BK][hd + 1]
    float* vs = ks + G_BK * (hd + 1);          // [G_BK][hd]
    float* ps = vs + G_BK * hd;                // [G_BQ][G_BK + 1]
    float* acc = ps + G_BQ * (G_BK + 1);       // [G_BQ][hd]
    float* m_s = acc + G_BQ * hd;              // [G_BQ]
    float* l_s = m_s + G_BQ;                   // [G_BQ]
    float* a_s = l_s + G_BQ;                   // [G_BQ]

    const int tid = threadIdx.x;
    const long long bid = blockIdx.x;
    const int qt = (int)(bid % nq);
    const int h = (int)((bid / nq) % H);
    const long long b = bid / ((long long)nq * H);
    const int kvh = h / (H / KH);
    const int q0 = qt * G_BQ;

    const T* qb = q + b * lq.b + (long long)h * lq.h;
    const T* kb = k + b * lk.b + (long long)kvh * lk.h;
    const T* vb = v + b * lv.b + (long long)kvh * lv.h;

    for (int i = tid; i < G_BQ * hd; i += G_THREADS) {
        const int r = i / hd, d = i % hd;
        qs[i] = (q0 + r < S) ? load_f(qb + (long long)(q0 + r) * lq.s + d)
                             : 0.0f;
        acc[i] = 0.0f;
    }
    if (tid < G_BQ) {
        m_s[tid] = NEG_INF;
        l_s[tid] = 0.0f;
    }

    const int k_lo = window > 0 ? max(0, q0 - window + 1) / G_BK * G_BK : 0;
    const int k_hi = min(S, q0 + G_BQ);

    for (int k0 = k_lo; k0 < k_hi; k0 += G_BK) {
        __syncthreads();           // the previous tile's readers are done
        for (int i = tid; i < G_BK * hd; i += G_THREADS) {
            const int j = i / hd, d = i % hd;
            const bool in = k0 + j < S;
            ks[j * (hd + 1) + d] =
                in ? load_f(kb + (long long)(k0 + j) * lk.s + d) : 0.0f;
            vs[i] = in ? load_f(vb + (long long)(k0 + j) * lv.s + d) : 0.0f;
        }
        __syncthreads();

        for (int i = tid; i < G_BQ * G_BK; i += G_THREADS) {
            const int r = i / G_BK, j = i % G_BK;
            float s = NEG_INF;
            if (visible(q0 + r, k0 + j, S, window)) {
                const float* qr = qs + r * hd;
                const float* kr = ks + j * (hd + 1);
                float dot = 0.0f;
                for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
                s = dot * scale;
            }
            ps[r * (G_BK + 1) + j] = s;
        }
        __syncthreads();

        {
            const int r = tid / G_TPR, sub = tid % G_TPR;
            float* pr = ps + r * (G_BK + 1);
            float mx = NEG_INF;
            for (int j = sub; j < G_BK; j += G_TPR) mx = fmaxf(mx, pr[j]);
#pragma unroll
            for (int off = G_TPR / 2; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
            const float m_prev = m_s[r];
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.0f;
            for (int j = sub; j < G_BK; j += G_TPR) {
                const float p = expf(pr[j] - m_new);
                pr[j] = p;
                sum += p;
            }
#pragma unroll
            for (int off = G_TPR / 2; off > 0; off >>= 1)
                sum += __shfl_xor_sync(FULL_MASK, sum, off);
            if (sub == 0) {
                const float alpha = expf(m_prev - m_new);
                a_s[r] = alpha;
                l_s[r] = l_s[r] * alpha + sum;
                m_s[r] = m_new;
            }
        }
        __syncthreads();

        for (int i = tid; i < G_BQ * hd; i += G_THREADS) {
            const int r = i / hd, d = i % hd;
            const float* pr = ps + r * (G_BK + 1);
            float pv = 0.0f;
            for (int j = 0; j < G_BK; ++j) pv = fmaf(pr[j], vs[j * hd + d], pv);
            acc[i] = acc[i] * a_s[r] + pv;
        }
    }
    __syncthreads();

    T* ob = o + b * lo.b + (long long)h * lo.h;
    for (int i = tid; i < G_BQ * hd; i += G_THREADS) {
        const int r = i / hd, d = i % hd;
        if (q0 + r < S)
            store_f(ob + (long long)(q0 + r) * lo.s + d,
                    acc[i] / fmaxf(l_s[r], 1e-30f));
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
enum { R_SHORT = 0, R_LONG = 1, R_GENERIC = 2, R_WIDE = 3 };

static bool short_hd(int hd) { return hd == 8 || hd == 16 || hd == 32; }
static bool long_hd(int hd) {
    return hd == 16 || hd == 32 || hd == 64 || hd == 128;
}

// KV heads a short block of hpb query heads stages (hpb divides H, and
// hpb divides R or R divides hpb)
static int short_nkv(int hpb, int R) { return hpb >= R ? hpb / R : 1; }

// Shared memory one block of the regime needs, in bytes; -1 for a shape
// the regime does not take.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_smem_bytes(int regime, int dtype, int S,
                                          int hd, int hpb, int R, int bk) {
    if (regime == R_SHORT) {
        if (S > SHORT_MAX_S || !short_hd(hd) || hpb < 1 || R < 1 ||
            (hpb % R && R % hpb))
            return -1;
        return (int)short_smem(S, hd, short_nkv(hpb, R), dtype ? 2 : 4);
    }
    if (regime == R_LONG) {
        if (!long_hd(hd)) return -1;
        if (!dtype) return (int)ffma_smem(hd);
        if (hpb != 1 && hpb != 2 && hpb != 4) return -1;
        if (bk != MMA_BK && !(bk == 32 && hpb == 4)) return -1;
        return (int)mma_smem(hd, hpb, bk);
    }
    if (regime == R_GENERIC) {
        if (hd < 1 || hd > MAX_HD) return -1;
        return (int)generic_smem(hd);
    }
    if (regime == R_WIDE) {        // hpb: the block's query heads
        if (!dtype || !wide_hd(hd) || bk != WIDE_BK || R < 1 || hpb < 1 ||
            wide_warps(hd) % hpb || R % hpb)
            return -1;
        return (int)wide_smem(hd);
    }
    return -1;
}

template <typename K>
static int set_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
    const void *q, *k, *v;
    void* o;
    Layout lq, lk, lv, lo;
    int B, H, KH, S, hd, window, hpb, rg, bk, vec;
    float scale;
    cudaStream_t stream;
};

template <typename T, int HD>
static int launch_short(const Args& a, size_t smem) {
    auto kern = attn_short_kernel<T, HD>;
    if (int e = set_smem(kern, smem)) return e;
    const int hpw = short_hpw(a.hpb);
    const int threads = a.hpb / hpw * ((a.S + 32 / hpw - 1) / (32 / hpw)) * 32;
    const long long blocks = (long long)a.B * (a.H / a.hpb);
    if (threads > SHORT_MAX_THREADS) return -2;
    if (blocks > 2147483647LL) return -3;
    kern<<<(unsigned)blocks, threads, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.lq, a.lk,
        a.lv, a.lo, a.H, a.KH, a.S, a.hpb, a.scale, a.window, a.vec);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_short(const Args& a, size_t smem) {
    switch (a.hd) {
        case 8: return launch_short<T, 8>(a, smem);
        case 16: return launch_short<T, 16>(a, smem);
        case 32: return launch_short<T, 32>(a, smem);
    }
    return -2;
}

template <int HD, int RG, int KS, int BK = MMA_BK>
static int launch_mma(const Args& a, size_t smem) {
    auto kern = attn_mma_kernel<HD, RG, KS, BK>;
    const int nq = (a.S + 16 * RG - 1) / (16 * RG);
    const long long blocks = (long long)a.B * a.H * nq;
    if (blocks > 2147483647LL) return -3;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<(unsigned)blocks, 32 * RG * KS, smem, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o,
        a.lq, a.lk, a.lv, a.lo, a.H, a.KH, a.S, nq, a.scale, a.window);
    return (int)cudaGetLastError();
}

// The (row groups, key splits, key tile) layouts the wrapper plans
// (ops.py:mma_layout); any other is refused.
template <int HD>
static int launch_mma_layout(const Args& a, size_t smem) {
    const int rg = a.rg, ks = a.hpb, bk = a.bk;
    if (rg == 4 && ks == 1 && bk == MMA_BK) return launch_mma<HD, 4, 1>(a, smem);
    if (rg == 2 && ks == 1 && bk == MMA_BK) return launch_mma<HD, 2, 1>(a, smem);
    if (rg == 4 && ks == 2 && bk == MMA_BK) return launch_mma<HD, 4, 2>(a, smem);
    if constexpr (HD <= 64) {
        if (rg == 2 && ks == 4 && bk == MMA_BK)
            return launch_mma<HD, 2, 4>(a, smem);
        if (rg == 2 && ks == 4 && bk == 32)
            return launch_mma<HD, 2, 4, 32>(a, smem);
    }
    return -2;
}

template <int HD>
static int launch_long(const Args& a, int dtype, size_t smem) {
    if (dtype) return launch_mma_layout<HD>(a, smem);   // a.hpb: key splits
    const int nq = (a.S + LQ - 1) / LQ;
    const long long blocks = (long long)a.B * a.H * nq;
    if (blocks > 2147483647LL) return -3;
    {
        auto kern = attn_ffma_kernel<HD>;
        if (int e = set_smem(kern, smem)) return e;
        kern<<<(unsigned)blocks, LONG_THREADS, smem, a.stream>>>(
            (const float*)a.q, (const float*)a.k, (const float*)a.v,
            (float*)a.o, a.lq, a.lk, a.lv, a.lo, a.H, a.KH, a.S, nq, a.scale,
            a.window);
    }
    return (int)cudaGetLastError();
}

// a.hpb query heads a block, a.rg = wide_warps(HD) / a.hpb warps a head
template <int HD>
static int launch_wide(const Args& a, size_t smem) {
    if (a.hpb * a.rg != wide_warps(HD)) return -2;
    auto kern = attn_wide_kernel<HD>;
    const int nq = (a.S + 16 * a.rg - 1) / (16 * a.rg);
    const long long blocks =
        (long long)a.B * a.KH * (a.H / a.KH / a.hpb) * nq;
    if (blocks > 2147483647LL) return -3;
    if (int e = set_smem(kern, smem)) return e;
    kern<<<(unsigned)blocks, 32 * wide_warps(HD), smem, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o,
        a.lq, a.lk, a.lv, a.lo, a.H, a.KH, a.S, nq, a.hpb, a.scale,
        a.window);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_generic(const Args& a, size_t smem) {
    auto kern = attn_generic_kernel<T>;
    if (int e = set_smem(kern, smem)) return e;
    const int nq = (a.S + G_BQ - 1) / G_BQ;
    const long long blocks = (long long)a.B * a.H * nq;
    if (blocks > 2147483647LL) return -3;
    kern<<<(unsigned)blocks, G_THREADS, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.lq, a.lk,
        a.lv, a.lo, a.H, a.KH, a.S, a.hd, nq, a.scale, a.window);
    return (int)cudaGetLastError();
}

// 16-byte aligned operands: every pointer, and every stride in bytes
static bool aligned16(const Args& a, int esz) {
    const uintptr_t p = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                        (uintptr_t)a.o;
    const Layout* ls[4] = {&a.lq, &a.lk, &a.lv, &a.lo};
    long long s = 0;
    for (int i = 0; i < 4; ++i)
        s |= (ls[i]->b * esz) | (ls[i]->s * esz) | (ls[i]->h * esz);
    return (p & 15) == 0 && (s & 15) == 0 && (a.hd * esz) % 16 == 0;
}

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  regime:
// 0 short, 1 long, 2 generic, 3 wide; hpb the query heads of a short or
// wide block or the key splits of a long bfloat16 block, rg the row groups
// of a long block or the warps a head of a wide one, bk the key tile.
// Returns a cudaError_t, or a negative code for arguments the kernel
// refuses: -1 a bad size, -2 a regime that does not take the shape, -3 too
// many blocks, -4 an unknown dtype, -5 operands not 16-byte aligned (long,
// wide).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long os,
    long long oh, int dtype, int B, int H, int KH, int S, int hd, int window,
    int regime, int hpb, int rg, int bk, void* stream) {
    if (B <= 0 || S <= 0 || hd <= 0 || hd > MAX_HD || KH <= 0 || H % KH)
        return -1;
    if (dtype != 0 && dtype != 1) return -4;
    const int R = H / KH;
    if (regime == R_SHORT && (hpb < 1 || H % hpb)) return -2;
    const int smem = flash_attention_smem_bytes(regime, dtype, S, hd, hpb, R,
                                                bk);
    if (smem < 0 || smem > MAX_SMEM) return -2;
    Args a{q, k, v, o, {qb, qs, qh}, {kb, ks, kh}, {vb, vs, vh}, {ob, os, oh},
           B, H, KH, S, hd, window, hpb, rg, bk, 0, 1.0f / sqrtf((float)hd),
           (cudaStream_t)stream};
    const int esz = dtype ? 2 : 4;
    a.vec = aligned16(a, esz) ? 1 : 0;
    if (regime == R_SHORT)
        return dtype ? dispatch_short<bf16>(a, smem)
                     : dispatch_short<float>(a, smem);
    if (regime == R_LONG) {
        if (!a.vec) return -5;
        switch (hd) {
            case 16: return launch_long<16>(a, dtype, smem);
            case 32: return launch_long<32>(a, dtype, smem);
            case 64: return launch_long<64>(a, dtype, smem);
            case 128: return launch_long<128>(a, dtype, smem);
        }
        return -2;
    }
    if (regime == R_WIDE) {
        if (!a.vec) return -5;
        return hd == 256 ? launch_wide<256>(a, smem)
                         : launch_wide<112>(a, smem);
    }
    return dtype ? launch_generic<bf16>(a, smem)
                 : launch_generic<float>(a, smem);
}
