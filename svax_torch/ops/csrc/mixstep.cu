// mixstep: T complete GMM or Student-t-mixture (SMM) CVI steps in one
// kernel launch.
//
// Replaces the TPU kernel svax/ops/mixstep_pallas.py (_chunk_call →
// pallas_call, body _make_kernel). Each step, in order: per point the log
// ρ_nk over K and their logsumexp → per component the seven statistics
// over N (counts, Σw·x₁, Σw·x₂, Σw, Σw·x₁², Σw·x₁x₂, Σw·x₂², with w = r for
// the GMM and w = r·E[u] for the SMM) → the CVI update
// η ← (1−ρ)η + ρ(η₀ + scale·Δ) → the step's scaled local evidence → the
// next step's expected parameters (closed form at d = 2). For the SMM, η₂
// takes Σ r·E[u] while η₄ and the Dirichlet take the counts; the constant
// a₀·log a₀ + lnΓ(a) − lnΓ(a₀) comes from the host in double.
//
// Bound: latency, not arithmetic or bytes. At the pinwheel shape (N=400,
// K=10) a step is ~40k FLOP over data that fits in shared memory, and its
// parts depend on each other. Design: ONE block of 512 threads for the
// whole chunk (the TPU's sequential grid becomes the step loop), two
// __syncthreads() a step:
//   1. per point, one pass: the thread that owns a point evaluates its K
//      log ρ once (into its own column of shared memory), their
//      logsumexp, then r_nk (and E[u]) and the point's weighted statistics,
//      32 values at a time (5 GMM or 4 SMM components), which the warp
//      adds over its 32 points by a transposing shuffle tree (31 shuffles
//      for 32 sums; lane i ends with sum i) into its own partial in shared
//      memory, batch after batch in order; the evidence likewise;
//   2. per component k, the 8 lanes 8(k / 16)… of warp k % 16: the
//      statistics as the 16 warps' partials added in warp order, the CVI
//      update, and at once the component's next log-ρ coefficients, the
//      four digammas on four lanes at the same time (warps K… have none
//      and wait). Every warp also forms Σα of the updated Dirichlet
//      naturals itself (a fixed shuffle tree, the same bits in every warp),
//      so no third barrier is needed; the naturals are double-buffered.
// Step 2 is one chain of dependent operations, so its divisions go to the
// special-function unit (2 ulp) and the digamma's recurrence is summed as
// one fraction: the step's time is part 1's issue (13 warps at N=400) and
// part 2's latency, about two thirds and one third (PERF.md §6).
// No float atomics: two runs are bit-equal. x stays in device memory (read
// through the cache; each thread keeps its first point in registers), so
// shared memory holds the log-ρ scratch (512·K floats) at every N ≤ 16,384,
// K ≤ 64. U ∈ {1, 2, 4, 8} steps are unrolled per loop trip (a template
// parameter); the step math is the same at every U. The expected
// parameters of gmm_d2.cuh (tinystep's) are formed here as the coefficients
// log ρ reads: [E[log π] + ½E[log|Λ|] − log 2π (+ the SMM constant), E[Λ]₁₁,
// 2E[Λ]₁₂, E[Λ]₂₂, −2E[Λμ]₁, −2E[Λμ]₂, E[μᵀΛμ], 0].
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cmath>

#include "gmm_d2.cuh"
#include "phase_clock.cuh"

namespace {

using svax::kLog2;

constexpr int NT = 512;  // threads in the one block
constexpr int NW = NT / 32;
// svax_torch/ops/mixstep.py gates on the same limits.
constexpr int MAX_N = 16384;
constexpr int MAX_K = 64;
constexpr int NCO = 8;  // log-ρ coefficients a component
constexpr float kLog2Pi = 1.8378770664093453f;

// The statistics a component (C) and the components a group of 32 values
// (CPG) in the warp partials: GMM [r, r·x₁, r·x₂, r·x₁², r·x₁x₂, r·x₂²] (Σw
// is Σr), SMM [r, w·x₁, w·x₂, w, w·x₁², w·x₁x₂, w·x₂²].
template <bool SMM>
struct Slots {
  static constexpr int C = SMM ? 7 : 6;
  static constexpr int CPG = SMM ? 4 : 5;
};

template <bool SMM>
__host__ __device__ inline int groups(int k) {
  return (k + Slots<SMM>::CPG - 1) / Slots<SMM>::CPG;
}

// Slot of component k's statistic c in a warp's partial (G·32 floats).
template <bool SMM>
__device__ __forceinline__ int slot(int k, int c) {
  using S = Slots<SMM>;
  return (k / S::CPG) * 32 + (k % S::CPG) * S::C + c;
}

struct Args {
  const float* x;  // (N, 2)
  int n, k;
  const float* prior;  // (K, 9)
  float* nat;          // (K, 9), updated in place
  float* metrics;      // (T,): scaled local evidence per step
  int t_steps;
  float rho, scale;
  float a0, a, smm_const;  // SMM: a₀ = dof/2, a = a₀ + 1, the lnΓ constant
};

// The block's shared memory.
struct Smem {
  float* co;     // (K, NCO) log-ρ coefficients
  float* nat0;   // (K, 9) the naturals, double-buffered
  float* nat1;   // (K, 9)
  float* prior;  // (K, 9)
  float* part;   // (NW, G, 32) the warps' statistics
  float* ev;     // (NW) the warps' evidence
  float* lr;     // (K, NT) each thread's log ρ, then exp(log ρ − max)
  int g;         // G, the groups of 32 values
};

template <bool SMM>
__host__ __device__ inline size_t smem_floats(int k) {
  return static_cast<size_t>(k) * (NCO + 27) + NW * groups<SMM>(k) * 32 + NW +
         static_cast<size_t>(NT) * k;
}

// The quadratic form (x − μ)ᵀE[Λ](x − μ) + d/κ, expanded, from the
// coefficients.
__device__ __forceinline__ float quad_form(const float4& c0, const float4& c1, float x1,
                                           float x2, float xx11, float xx12, float xx22) {
  return fmaf(c0.y, xx11, fmaf(c0.z, xx12, fmaf(c0.w, xx22,
              fmaf(c1.x, x1, fmaf(c1.y, x2, c1.z)))));
}

// log ρ_nk of one point under component k's coefficients co.
template <bool SMM>
__device__ __forceinline__ float log_rho(const float* co, float x1, float x2, float xx11,
                                         float xx12, float xx22, const Args& a) {
  const float4 c0 = reinterpret_cast<const float4*>(co)[0];
  const float4 c1 = reinterpret_cast<const float4*>(co)[1];
  const float quad = quad_form(c0, c1, x1, x2, xx11, xx12, xx22);
  if (SMM) return c0.x - a.a * logf(a.a0 + 0.5f * quad);
  return c0.x - 0.5f * quad;
}

// E[u_nk] = a / (a₀ + ½ quad) (SMM), by the special-function unit's
// reciprocal (within 2 ulp for a divisor below 2¹²⁶).
__device__ __forceinline__ float e_u(const float* co, float x1, float x2, float xx11,
                                     float xx12, float xx22, const Args& a) {
  const float4 c0 = reinterpret_cast<const float4*>(co)[0];
  const float4 c1 = reinterpret_cast<const float4*>(co)[1];
  return __fdividef(a.a, a.a0 + 0.5f * quad_form(c0, c1, x1, x2, xx11, xx12, xx22));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 32 values a lane → lane i holds the sum of value i over the warp's lanes:
// at each level the lane keeps the half of its values whose index has the
// lane's bit and adds the partner's copy of it (the sums pair the lanes
// that differ in bit 4, then 3, …, 0). A template level a call, so every
// index is a constant and v stays in registers.
template <int O>
__device__ __forceinline__ void reduce_level(float (&v)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) reduce_level<O / 2>(v, lane);
}

__device__ __forceinline__ void transpose_reduce(float (&v)[32], int lane) {
  reduce_level<16>(v, lane);
}

// One natural's CVI update, each operation rounded as written.
__device__ __forceinline__ float cvi(float old, float p0, float delta, float rho, float scale) {
  return __fadd_rn(__fmul_rn(1.0f - rho, old),
                   __fmul_rn(rho, __fadd_rn(p0, __fmul_rn(scale, delta))));
}

// Σ_w part[w][slot], w in order.
__device__ __forceinline__ float part_sum(const Smem& s, int at) {
  float acc = 0.0f;
#pragma unroll
  for (int w = 0; w < NW; ++w) acc += s.part[w * s.g * 32 + at];
  return acc;
}

// Part 1: each warp's statistics and evidence over its points, into its
// partial. Point n = j·NT + warp·32 + lane of batch j.
template <bool SMM>
__device__ __forceinline__ void stats_pass(const Args& a, const Smem& s, float x1_0,
                                           float x2_0) {
  using S = Slots<SMM>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.n, K = a.k;
  float* lr = s.lr + tid;  // this thread's column: lr[k·NT]
  float ev = 0.0f;
  for (int j = 0, n0 = warp * 32; n0 < N; ++j, n0 += NT) {
    const int n = n0 + lane;
    const bool valid = n < N;
    float x1 = x1_0, x2 = x2_0;
    if (j > 0) {
      x1 = valid ? __ldg(a.x + 2 * n) : 0.0f;
      x2 = valid ? __ldg(a.x + 2 * n + 1) : 0.0f;
    }
    const float xx11 = x1 * x1, xx12 = x1 * x2, xx22 = x2 * x2;
    float m = -INFINITY;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float v = log_rho<SMM>(s.co + k * NCO, x1, x2, xx11, xx12, xx22, a);
      lr[k * NT] = v;
      m = fmaxf(m, v);
    }
    float sum = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float e = expf(lr[k * NT] - m);
      lr[k * NT] = e;
      sum += e;
    }
    const float inv = 1.0f / sum;
    if (valid) ev += m + logf(sum);
    PHASE_MARK(0);
    for (int g = 0; g < s.g; ++g) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.0f;
#pragma unroll
      for (int cl = 0; cl < S::CPG; ++cl) {
        const int k = g * S::CPG + cl;
        const int kk = k < K ? k : 0;
        const float r = (valid && k < K) ? lr[kk * NT] * inv : 0.0f;
        const float w = SMM ? r * e_u(s.co + kk * NCO, x1, x2, xx11, xx12, xx22, a) : r;
        const float wx1 = w * x1, wx2 = w * x2;
        float* o = v + cl * S::C;
        o[0] = r;
        o[1] = wx1;
        o[2] = wx2;
        if (SMM) o[3] = w;
        o[S::C - 3] = wx1 * x1;
        o[S::C - 2] = wx1 * x2;
        o[S::C - 1] = wx2 * x2;
      }
      transpose_reduce(v, lane);
      float* dst = s.part + (warp * s.g + g) * 32 + lane;
      *dst = j == 0 ? v[0] : *dst + v[0];
    }
    PHASE_MARK(1);
  }
  ev = warp_sum(ev);
  if (lane == 0) s.ev[warp] = ev;
}

// ψ(x), x > 0, by gmm_d2.cuh's recipe — an 8-step recurrence into the
// asymptotic series at x + 8 — with the recurrence's Σ_i 1/(x + i) formed
// as one fraction (p/q ← (p(x + i) + q)/(q(x + i)): eight multiply-adds and
// one division) and the series' reciprocal from the special-function unit:
// the same code on every lane, a short chain on the update's critical path.
__device__ __forceinline__ float digamma_mix(float x) {
  float p = 0.0f, q = 1.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float xi = x + static_cast<float>(i);
    p = fmaf(p, xi, q);
    q = q * xi;
  }
  const float y = x + 8.0f;
  const float inv = __fdividef(1.0f, y);
  const float inv2 = inv * inv;
  return logf(y) - 0.5f * inv -
         inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f)) - p / q;
}

// The log-ρ coefficient c of a component from its updated naturals nt
// (every lane of its 8-lane group holds them) and Σα: lanes c = 0..3 of the
// group take ψ(α), ψ(Σα), ψ(ν/2), ψ((ν−1)/2) at once (gmm_d2.cuh:
// expected_d2's formulas).
template <bool SMM>
__device__ __forceinline__ float coefficient(const float (&nt)[9], float sum_alpha, int c,
                                             int group, const Args& a) {
  const float alpha = nt[0] + 1.0f;
  const float kappa = nt[3], inv_kappa = __fdividef(1.0f, kappa);
  const float m1 = nt[1] * inv_kappa, m2 = nt[2] * inv_kappa;
  const float phi11 = nt[4] - kappa * m1 * m1;
  const float phi12 = nt[5] - kappa * m1 * m2;
  const float phi22 = nt[7] - kappa * m2 * m2;
  const float nu = nt[8] - 4.0f;  // η₄ = ν + d + 2
  const float det = phi11 * phi22 - phi12 * phi12, inv_det = __fdividef(1.0f, det);
  const float i11 = phi22 * inv_det, i12 = -phi12 * inv_det, i22 = phi11 * inv_det;
  const float pim1 = i11 * m1 + i12 * m2, pim2 = i12 * m1 + i22 * m2;
  const float arg = c == 0 ? alpha : c == 1 ? sum_alpha : c == 2 ? nu / 2.0f : (nu - 1.0f) / 2.0f;
  const float psi = digamma_mix(arg);
  const float psi_a = __shfl_sync(0xffffffffu, psi, group);
  const float psi_s = __shfl_sync(0xffffffffu, psi, group + 1);
  const float psi_2 = __shfl_sync(0xffffffffu, psi, group + 2);
  const float psi_3 = __shfl_sync(0xffffffffu, psi, group + 3);
  const float e_logpi = psi_a - psi_s;
  const float e_logdet = psi_2 + psi_3 + 2.0f * kLog2 - logf(det);
  float base = e_logpi + 0.5f * e_logdet - kLog2Pi;
  if (SMM) base += a.smm_const;
  const float e_quad = 2.0f * inv_kappa + nu * (m1 * pim1 + m2 * pim2);
  return c == 0   ? base
         : c == 1 ? nu * i11
         : c == 2 ? 2.0f * (nu * i12)
         : c == 3 ? nu * i22
         : c == 4 ? -2.0f * (nu * pim1)
         : c == 5 ? -2.0f * (nu * pim2)
         : c == 6 ? e_quad
                  : 0.0f;
}

// Part 2: the statistics from the warps' partials, the CVI update of the
// naturals cur → nxt and the next coefficients (warps K… own no component
// and skip it); metric t ≥ 0 gets the step's evidence. rho = 0 with zero
// partials forms the coefficients of cur as they stand (nxt = cur, bit for
// bit).
template <bool SMM>
__device__ __forceinline__ void apply(const Args& a, const Smem& s, const float* cur, float* nxt,
                                      float rho, int t) {
  using S = Slots<SMM>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int K = a.k;
  if (t >= 0 && tid == NT - 32) {
    float ev = 0.0f;
    for (int w = 0; w < NW; ++w) ev += s.ev[w];
    a.metrics[t] = a.scale * ev;
  }
  if (warp >= K) return;
  // Σα of the updated Dirichlet naturals, every warp alike: lane l holds
  // α_l (+ α_{l+32}), then the shuffle tree. Straight-line code, so that it
  // overlaps the statistics' sums below.
  const int jl = lane < K ? lane : 0;
  float av = cvi(cur[jl * 9], s.prior[jl * 9], part_sum(s, slot<SMM>(jl, 0)), rho, a.scale);
  av = lane < K ? av + 1.0f : 0.0f;
  if (K > 32) {
    const int jh = lane + 32 < K ? lane + 32 : 0;
    const float ah =
        cvi(cur[jh * 9], s.prior[jh * 9], part_sum(s, slot<SMM>(jh, 0)), rho, a.scale) + 1.0f;
    av = av + (lane + 32 < K ? ah : 0.0f);
  }
  // Component k = warp + NW·q on lanes 8q..8q+7; lane c holds statistic c.
  const int q = lane / 8, c = lane % 8, group = lane & ~7, k = warp + NW * q;
  const int kk = k < K ? k : K - 1;
  const float st = c < S::C ? part_sum(s, slot<SMM>(kk, c)) : 0.0f;
  const float sum_alpha = warp_sum(av);
  PHASE_MARK(5);
  float s7[7];
  if (SMM) {
#pragma unroll
    for (int i = 0; i < 7; ++i) s7[i] = __shfl_sync(0xffffffffu, st, group + i);
  } else {  // Σw = Σr: statistic 3 is statistic 0, the rest shift down
#pragma unroll
    for (int i = 0; i < 7; ++i)
      s7[i] = __shfl_sync(0xffffffffu, st, group + (i < 3 ? i : i == 3 ? 0 : i - 1));
  }
  const float delta[9] = {s7[0], s7[1], s7[2], s7[3], s7[4], s7[5], s7[5], s7[6], s7[0]};
  float nt[9];
#pragma unroll
  for (int i = 0; i < 9; ++i)
    nt[i] = cvi(cur[kk * 9 + i], s.prior[kk * 9 + i], delta[i], rho, a.scale);
  PHASE_MARK(6);
  const float co = coefficient<SMM>(nt, sum_alpha, c, group, a);
  PHASE_MARK(7);
  if (k < K) {
    float mine = nt[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) mine = c == i ? nt[i] : mine;
    nxt[k * 9 + c] = mine;
    if (c == 0) nxt[k * 9 + 8] = nt[8];
    s.co[k * NCO + c] = co;
  }
}

template <bool SMM, int U>
__global__ void __launch_bounds__(NT, 1) mixstep_kernel(Args a) {
  const int tid = threadIdx.x;
  const int N = a.n, K = a.k;
  extern __shared__ float4 smem4[];
  Smem s;
  s.g = groups<SMM>(K);
  s.co = reinterpret_cast<float*>(smem4);
  s.nat0 = s.co + K * NCO;
  s.nat1 = s.nat0 + K * 9;
  s.prior = s.nat1 + K * 9;
  s.part = s.prior + K * 9;
  s.ev = s.part + NW * s.g * 32;
  s.lr = s.ev + NW;

  for (int i = tid; i < K * 9; i += NT) {
    s.nat0[i] = a.nat[i];
    s.prior[i] = a.prior[i];
  }
  // Warps with no point never write their partial: it stays zero.
  for (int i = tid; i < NW * s.g * 32; i += NT) s.part[i] = 0.0f;
  const float x1_0 = tid < N ? a.x[2 * tid] : 0.0f;
  const float x2_0 = tid < N ? a.x[2 * tid + 1] : 0.0f;
  PHASE_START;
  __syncthreads();
  apply<SMM>(a, s, s.nat0, s.nat1, 0.0f, -1);
  __syncthreads();

  float* cur = s.nat1;
  float* nxt = s.nat0;
  for (int t = 0; t < a.t_steps; t += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      stats_pass<SMM>(a, s, x1_0, x2_0);
      __syncthreads();
      PHASE_MARK(2);
      apply<SMM>(a, s, cur, nxt, a.rho, t + u);
      PHASE_MARK(3);
      __syncthreads();
      PHASE_MARK(4);
      float* const done = nxt;
      nxt = cur;
      cur = done;
    }
  }

  for (int i = tid; i < K * 9; i += NT) a.nat[i] = cur[i];
}

template <bool SMM, int U>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_floats<SMM>(a.k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mixstep_kernel<SMM, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  mixstep_kernel<SMM, U><<<1, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool SMM>
int launch_unrolled(const Args& a, int unroll, cudaStream_t stream) {
  switch (unroll) {
    case 1: return launch<SMM, 1>(a, stream);
    case 2: return launch<SMM, 2>(a, stream);
    case 4: return launch<SMM, 4>(a, stream);
    case 8: return launch<SMM, 8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Phase clocks (slots 0–7; compiled in only with -DSVAX_PHASE_CLOCKS):
// thread 0's log ρ and logsumexp, its statistics and shuffle trees, the
// first barrier's wait, the rest of the update and the second barrier's
// wait; inside the update, Σα (5), the statistics and naturals (6) and the
// coefficients (7).
SVAX_PHASE_ENTRY(mixstep_phase_clocks)

extern "C" {

// dof > 0 selects the SMM; smm_const is a₀·log a₀ + lnΓ(a) − lnΓ(a₀).
int mixstep_train_chunk(const float* x, int n, int k, const float* prior, float* nat,
                        float* metrics, int t_steps, float rho, float scale, float dof,
                        float smm_const, int unroll, void* stream) {
  const bool unroll_ok = unroll == 1 || unroll == 2 || unroll == 4 || unroll == 8;
  if (!unroll_ok || n < 1 || n > MAX_N || k < 1 || k > MAX_K || t_steps < 1 ||
      t_steps % unroll != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float a0 = 0.5f * dof;
  Args a{x, n, k, prior, nat, metrics, t_steps, rho, scale, a0, a0 + 1.0f, smm_const};
  auto st = static_cast<cudaStream_t>(stream);
  return dof > 0.0f ? launch_unrolled<true>(a, unroll, st)
                    : launch_unrolled<false>(a, unroll, st);
}

}  // extern "C"
