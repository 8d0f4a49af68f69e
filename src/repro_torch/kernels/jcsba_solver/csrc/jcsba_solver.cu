// The JCSBA solver's per-round numerical core as two CUDA kernels for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// No Pallas kernel of the JAX package covers this: there the whole solve
// (src/repro/wireless/solver/jaxsolver.py) is one XLA program, and XLA's
// fusion keeps the nested bisections on the chip.  Written as eager torch
// ops, one J(A) evaluation would be some 36 000 launches; these kernels
// stand in for that fusion.
//
// * jcsba_bmin_kernel (jaxsolver.py:_bmin, Eq. 41): a thread per client, a
//   fixed 30-step bisection of r(B) = Γ/τ_rem on [B_LO, 2·B_max], the
//   feasibility mask, B_CAP for infeasible clients, ×(1 + BMIN_SAFETY).
// * jcsba_population_kernel (allocate_batch + objective_batch, :113-184):
//   one block per antibody row, threads over clients, each thread keeping
//   its clients' bisection state in registers.  Per row: the feasibility
//   test (Eq. 42), the 40-step log(−κ) bisection around the 30-step φ⁻¹
//   bisection, the slack spread, the at-equality and all-Q≤0 branches,
//   the energy Σ a_k Q_k (p·Γ/r + e_cmp) and the Theorem-1 term of
//   objective_batched over [M, K]; an infeasible row gets J = +inf and
//   B = 0.
//
// What bounds them on this card: neither bytes nor operations.  At the
// paper's K = 10 a row is one warp walking a chain of 40 × 30 dependent
// bisection steps (a log1pf and two divisions each), so a launch is
// latency-bound; rows run in parallel, one block each.  The design keeps
// every step in registers and every cross-client sum in one block.
//
// Numerics follow the plain version (ref.py) operation by operation:
// built without fast math, without flush-to-zero and without FMA
// contraction (build.py), libm's logf/log1pf/expf/sqrtf.  Cross-client
// sums use a fixed order (a shuffle tree, then the warps' partials in
// order), so a result is bitwise repeatable from run to run; its order
// differs from the plain version's, which may move B by ulps near the κ
// root.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The round's fixed scalars, rounded to float32 by the caller as the plain
// version rounds them.  Must match build.py:SolverArgs field for field.
// V is not among them: the population kernel reads it from device memory,
// so a captured round replays under whatever V a scenario copies in.
struct SolverArgs {
  int K, M, n_bisect_b, n_bisect_k;
  float B_max, bmax_hi, bmax_lo;   // B_max, B_max + TOL_B, B_max - TOL_B
  float p_tx, N0, n0ln2;           // n0ln2 = N0·ln 2
  float er, c;                     // η·ρ, (2η − η²)/2
};

namespace {

constexpr unsigned FULL = 0xffffffffu;

// The solver's fixed constants (wireless/solver/common.py and ref.py), each
// the double the plain version holds, rounded to float32 as torch rounds a
// Python float against a float32 tensor.
constexpr float kBLo = (float)1e-3;                    // B_LO
constexpr float kBCap = (float)1e12;                   // B_CAP
constexpr float kSafety = (float)(1.0 + 1e-4);         // 1 + BMIN_SAFETY
constexpr float kTolB = (float)1.0;                    // TOL_B
constexpr float kSeriesX = (float)0.02;                // PHI_SERIES_X
constexpr float kLogKappaTiny = (float)-69.07755278982137;  // log(1e-30)
constexpr float kLn2 = (float)0.6931471805599453;      // math.log(2)
constexpr float kTwoThirds = (float)(2.0 / 3.0);
constexpr float kCeilFactor = (float)(1.0 - 1e-12);

__device__ __forceinline__ float rate(float B, float h, const SolverArgs& s) {
  const float x = s.p_tx * h / (B * s.N0);
  return B * log1pf(x) / kLn2;
}

// φ = ∂J₃/∂B (Eq. 37), series-stabilised for small x (jaxsolver.py:59-66)
__device__ __forceinline__ float phi(float B, float Q, float g, float h,
                                     const SolverArgs& s) {
  const float x = s.p_tx * h / (B * s.N0);
  const float ln1x = log1pf(x);
  const float exact = x / (1.0f + x) - ln1x;
  const float series = x * x * (-0.5f + x * (kTwoThirds - 0.75f * x));
  const float num = x < kSeriesX ? series : exact;
  return Q * s.p_tx * g * kLn2 * num / (B * B * ln1x * ln1x);
}

// Sum (or min) of NV values over the block, the same value in every
// thread: a shuffle-down tree in each warp, lane 0's total broadcast, then
// the warps' partials added in warp order.  Fixed order, so repeatable.
template <int NV, bool MIN>
__device__ __forceinline__ void block_reduce(float (&v)[NV], float* smem) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_down_sync(FULL, v[i], off);
      v[i] = MIN ? fminf(v[i], o) : v[i] + o;
    }
    v[i] = __shfl_sync(FULL, v[i], 0);
  }
  const int nw = blockDim.x >> 5;
  if (nw == 1) return;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                       // the previous call's reads are done
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) smem[i * 32 + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float t = smem[i * 32];
    for (int w = 1; w < nw; ++w)
      t = MIN ? fminf(t, smem[i * 32 + w]) : t + smem[i * 32 + w];
    v[i] = t;
  }
}

__global__ void jcsba_bmin_kernel(const float* __restrict__ gamma,
                                  const float* __restrict__ h,
                                  const float* __restrict__ tau_rem,
                                  float* __restrict__ bmin,
                                  uint8_t* __restrict__ ok, SolverArgs s) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= s.K) return;
  const float g = gamma[k], hk = h[k], tr = tau_rem[k];
  const float target = g / (tr > 0.0f ? tr : 1.0f);
  const float ceiling = s.p_tx * hk / s.n0ln2;
  const bool okk = (tr > 0.0f) && (target < ceiling * kCeilFactor);
  float lo = kBLo, hi = 2.0f * s.B_max;
  for (int i = 0; i < s.n_bisect_b; ++i) {
    const float mid = 0.5f * (lo + hi);
    const bool under = rate(mid, hk, s) < target;
    lo = under ? mid : lo;
    hi = under ? hi : mid;
  }
  bmin[k] = okk ? hi * kSafety : kBCap;
  ok[k] = okk ? 1 : 0;
}

// One block per antibody row; thread t holds clients t, t + T, ...,
// t + (CPT − 1)·T (T = blockDim.x).  Bounded for 1024 threads, so that a
// full block fits the SM's registers at every CPT (unbounded, CPT = 8 took
// 127 registers a thread).
template <int CPT>
__global__ void __launch_bounds__(1024) jcsba_population_kernel(
    const uint8_t* __restrict__ A, const float* __restrict__ bmin,
    const uint8_t* __restrict__ ok, const float* __restrict__ Qv,
    const float* __restrict__ gamma, const float* __restrict__ h,
    const float* __restrict__ e_cmp, const float* __restrict__ zeta2,
    const float* __restrict__ delta2, const float* __restrict__ wbar,
    const uint8_t* __restrict__ has, const float* __restrict__ D,
    const float* __restrict__ V, float* __restrict__ J,
    uint8_t* __restrict__ feasible, float* __restrict__ Bout,
    SolverArgs s) {
  __shared__ float smem[32 * 4];
  const int K = s.K;
  const long row = blockIdx.x;
  const uint8_t* Ar = A + row * K;

  bool a[CPT];
  float bm[CPT], q[CPT], g[CPT], hh[CPT], pb[CPT], B[CPT];
  // U, Σ a·B_min, any(a ∧ ¬ok), any(a ∧ Q > 0)
  float red[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float mn[1] = {0.0f};                    // min over active of φ(B_min), 0
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = threadIdx.x + c * blockDim.x;
    a[c] = k < K && Ar[k] != 0;
    bm[c] = q[c] = g[c] = hh[c] = pb[c] = B[c] = 0.0f;
    if (k < K) {
      bm[c] = bmin[k];
      q[c] = Qv[k];
      g[c] = gamma[k];
      hh[c] = h[k];
      pb[c] = phi(bm[c], q[c], g[c], hh[c], s);
    }
    if (a[c]) {
      red[0] += 1.0f;
      red[1] += bm[c];
      if (!ok[k]) red[2] = 1.0f;
      if (q[c] > 0.0f) {
        red[3] = 1.0f;
        mn[0] = fminf(mn[0], pb[c]);
      }
    }
  }
  block_reduce<4, false>(red, smem);
  block_reduce<1, true>(mn, smem);
  const float U = red[0], total_min = red[1];
  const bool feas = red[2] == 0.0f && total_min <= s.bmax_hi;
  if (!feas) {
    if (threadIdx.x == 0) {
      J[row] = INFINITY;
      feasible[row] = 0;
    }
    if (Bout) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int k = threadIdx.x + c * blockDim.x;
        if (k < K) Bout[row * K + k] = 0.0f;
      }
    }
    return;
  }

  if (total_min >= s.bmax_lo) {            // (42) with equality: B = B_min
#pragma unroll
    for (int c = 0; c < CPT; ++c) B[c] = a[c] ? bm[c] : 0.0f;
  } else if (red[3] == 0.0f) {             // every participant has Q ≤ 0
    const float share = (s.B_max - total_min) / fmaxf(U, 1.0f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) B[c] = a[c] ? bm[c] + share : 0.0f;
  } else {
    // κ* in log(−κ) space; B_k(κ) = φ⁻¹(κ) on [B_min, B_max], pinned at
    // B_min where φ(B_min) ≥ κ
    float u_a = logf(-fminf(mn[0], -1e-35f));
    float u_b = kLogKappaTiny;
    for (int it = 0; it <= s.n_bisect_k; ++it) {
      const bool last = it == s.n_bisect_k;
      const float u = last ? u_b : 0.5f * (u_a + u_b);
      const float kap = -expf(u);
      bool pin[CPT];
      float lo[CPT], hi[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        pin[c] = pb[c] >= kap;
        lo[c] = bm[c];
        hi[c] = s.B_max;
      }
      for (int i = 0; i < s.n_bisect_b; ++i) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (!a[c] || pin[c]) continue;
          const float mid = 0.5f * (lo[c] + hi[c]);
          const bool under = phi(mid, q[c], g[c], hh[c], s) < kap;
          lo[c] = under ? mid : lo[c];
          hi[c] = under ? hi[c] : mid;
        }
      }
      float t[1] = {0.0f};
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        B[c] = !a[c] ? 0.0f : (pin[c] ? bm[c] : 0.5f * (lo[c] + hi[c]));
        t[0] += B[c];
      }
      if (last) break;
      block_reduce<1, false>(t, smem);
      const bool under = t[0] < s.B_max;
      u_a = under ? u : u_a;
      u_b = under ? u_b : u;
    }
    // the residual rounding slack (keeps Σ = B_max): over the unpinned
    // participants if any, else over all participants
    float sl[2] = {0.0f, 0.0f};            // Σ B, count of free clients
    bool freem[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      sl[0] += B[c];
      freem[c] = a[c] && B[c] > bm[c] + kTolB;
      sl[1] += freem[c] ? 1.0f : 0.0f;
    }
    block_reduce<2, false>(sl, smem);
    const float slack = s.B_max - sl[0];
    const float nfree = sl[1];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float add = nfree > 0.0f
          ? (freem[c] ? slack / fmaxf(nfree, 1.0f) : 0.0f)
          : (a[c] ? slack / fmaxf(U, 1.0f) : 0.0f);
      B[c] = a[c] ? fmaxf(B[c] + add, bm[c]) : 0.0f;
    }
  }

  // J₂ = V·(Theorem-1 objective) + Σ_k a_k Q_k (p·Γ_k/r_k + e_cmp_k)
  float en[1] = {0.0f};
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int k = threadIdx.x + c * blockDim.x;
    if (a[c]) {
      const float r = rate(fmaxf(B[c], kBLo), hh[c], s);
      const float tcom = g[c] / fmaxf(r, 1e-30f);
      en[0] += q[c] * (s.p_tx * tcom + e_cmp[k]);
    }
    if (Bout && k < K) Bout[row * K + k] = B[c];
  }
  block_reduce<1, false>(en, smem);
  float A1 = 0.0f, A2 = 0.0f, covered = 0.0f;
  for (int m = 0; m < s.M; ++m) {
    const float* wb = wbar + (long)m * K;
    const uint8_t* hm = has + (long)m * K;
    float st[3] = {0.0f, 0.0f, 0.0f};      // Σ part·D, Σ a·w̄, any(part)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = threadIdx.x + c * blockDim.x;
      if (a[c] && hm[k]) {
        st[0] += D[k];
        st[2] = 1.0f;
      }
      if (a[c]) st[1] += wb[k];
    }
    block_reduce<3, false>(st, smem);
    const float denom = st[0];
    float cs[1] = {0.0f};                  // Σ_k coeff·δ²
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int k = threadIdx.x + c * blockDim.x;
      if (k < K) {
        const bool part = a[c] && hm[k];
        const float wt = (denom > 0.0f && part)
            ? D[k] / fmaxf(denom, 1e-30f) : 0.0f;
        const float af = a[c] ? 1.0f : 0.0f;
        const float coeff = wt + wb[k] - 2.0f * af * wb[k];
        cs[0] += coeff * delta2[(long)m * K + k];
      }
    }
    block_reduce<1, false>(cs, smem);
    const bool sched = st[2] != 0.0f;
    const float z2 = zeta2[m];
    if (sched) {
      A2 += 2.0f * (1.0f - st[1]) * cs[0];
      covered += z2;
    } else {
      A1 += z2;
    }
  }
  A2 = fmaxf(A2, 0.0f);
  if (threadIdx.x == 0) {
    const float bound = s.er * sqrtf(A1 + A2) - s.c * covered;
    J[row] = V[0] * bound + en[0];
    feasible[row] = 1;
  }
}

}  // namespace

extern "C" {

int jcsba_bmin(const void* gamma, const void* h, const void* tau_rem,
               void* bmin, void* ok, const SolverArgs* args, void* stream) {
  if (args->K <= 0) return -1;
  const int threads = 128;
  const int blocks = (args->K + threads - 1) / threads;
  jcsba_bmin_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)gamma, (const float*)h, (const float*)tau_rem,
      (float*)bmin, (uint8_t*)ok, *args);
  return (int)cudaGetLastError();
}

// threads: a multiple of 32 up to 1024; cpt: clients a thread, 1, 2, 4 or
// 8, with threads·cpt ≥ K (ops.py:plan); P rows, one block each; V a
// float32 scalar in device memory.
int jcsba_population(const void* A, const void* bmin, const void* ok,
                     const void* Q, const void* gamma, const void* h,
                     const void* e_cmp, const void* zeta2,
                     const void* delta2, const void* wbar, const void* has,
                     const void* D, const void* V, void* J,
                     void* feasible, void* B, int P,
                     int threads, int cpt, const SolverArgs* args,
                     void* stream) {
  const int K = args->K;
  if (P <= 0 || K <= 0) return -1;
  if (threads < 32 || threads > 1024 || threads % 32) return -2;
  if ((long)threads * cpt < K) return -3;
  if (args->M < 0) return -4;
  cudaStream_t st = (cudaStream_t)stream;
#define JCSBA_LAUNCH(C)                                                     \
  jcsba_population_kernel<C><<<P, threads, 0, st>>>(                        \
      (const uint8_t*)A, (const float*)bmin, (const uint8_t*)ok,            \
      (const float*)Q, (const float*)gamma, (const float*)h,                \
      (const float*)e_cmp, (const float*)zeta2, (const float*)delta2,       \
      (const float*)wbar, (const uint8_t*)has, (const float*)D,             \
      (const float*)V, (float*)J, (uint8_t*)feasible, (float*)B, *args)
  switch (cpt) {
    case 1: JCSBA_LAUNCH(1); break;
    case 2: JCSBA_LAUNCH(2); break;
    case 4: JCSBA_LAUNCH(4); break;
    case 8: JCSBA_LAUNCH(8); break;
    default: return -5;
  }
#undef JCSBA_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
