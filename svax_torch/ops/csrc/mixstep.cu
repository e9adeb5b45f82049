// mixstep: T complete GMM or Student-t-mixture (SMM) CVI steps in one
// kernel launch.
//
// Replaces the TPU kernel svax/ops/mixstep_pallas.py (_chunk_call →
// pallas_call, body _make_kernel). Each step, in order: the expected
// parameters from the naturals (closed form at d = 2, gmm_d2.cuh) → per
// point the log ρ_nk over K and their logsumexp → per component the seven
// statistics over N (counts, Σw·x₁, Σw·x₂, Σw, Σw·x₁², Σw·x₁x₂, Σw·x₂²,
// with w = r for the GMM and w = r·E[u] for the SMM) → the CVI update
// η ← (1−ρ)η + ρ(η₀ + scale·Δ) → the step's scaled local evidence. For the
// SMM, η₂ takes Σ r·E[u] while η₄ and the Dirichlet take the counts; the
// constant a₀·log a₀ + lnΓ(a) − lnΓ(a₀) comes from the host in double.
//
// Bound: latency, not arithmetic or bytes. At the pinwheel shape (N=400,
// K=10) a step is ~40k FLOP over data that fits in shared memory, and its
// three phases depend on each other. Design: ONE block of 512 threads for
// the whole chunk (the TPU's sequential grid becomes the step loop), with
// the packed naturals, the prior, the expected parameters and x in shared
// memory; three __syncthreads() per step. Per point, one thread; per
// component, one warp, whose lanes recompute r (and E[u]) for their points
// from the stored logsumexp and reduce by a fixed shuffle tree — no float
// atomics, so two runs are bit-equal. U ∈ {1, 2, 4, 8} steps are unrolled
// per loop trip (a template parameter); the step math is the same at every
// U. Spreading N over a cluster and overlapping the phases is later work.
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cmath>

#include "gmm_d2.cuh"

namespace {

using namespace svax;  // gmm_d2.cuh: ExpSlot, expected_d2

constexpr int NT = 512;  // threads in the one block
constexpr int NW = NT / 32;
// x (2N) and the logsumexps (N) in shared memory: 203,264 bytes at the limits.
// svax_torch/ops/mixstep.py gates on the same limits.
constexpr int MAX_N = 16384;
constexpr int MAX_K = 64;
constexpr float kLog2Pi = 1.8378770664093453f;

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

// log ρ_nk of one point under component k's expected parameters e; for the
// SMM also E[u_nk] = a / b_nk.
template <bool SMM>
__device__ __forceinline__ float log_rho(const float* e, float x1, float x2,
                                         const Args& a, float* e_u) {
  const float quad = e[E_P11] * x1 * x1 + 2.0f * e[E_P12] * x1 * x2 +
                     e[E_P22] * x2 * x2 - 2.0f * (e[E_PM1] * x1 + e[E_PM2] * x2) +
                     e[E_QUAD];
  const float base = e[E_LOGPI] + 0.5f * e[E_LOGDET] - kLog2Pi;
  if (SMM) {
    const float b = a.a0 + 0.5f * quad;
    *e_u = a.a / b;
    return base + a.smm_const - a.a * logf(b);
  }
  *e_u = 1.0f;
  return base - 0.5f * quad;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool SMM>
__device__ __forceinline__ void one_step(const Args& a, int t, float* snat,
                                         const float* sprior, float* sexp,
                                         const float* sx1, const float* sx2,
                                         float* slse) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.n, K = a.k;

  // A: expected parameters from the naturals.
  if (tid < K) expected_d2(snat, K, tid, sexp + tid * NUM_EXP);
  __syncthreads();

  // B: per point, lse_k log ρ_nk (two passes: max, then Σ exp).
  for (int n = tid; n < N; n += NT) {
    const float x1 = sx1[n], x2 = sx2[n];
    float eu, m = -INFINITY;
    for (int k = 0; k < K; ++k)
      m = fmaxf(m, log_rho<SMM>(sexp + k * NUM_EXP, x1, x2, a, &eu));
    float s = 0.0f;
    for (int k = 0; k < K; ++k)
      s += expf(log_rho<SMM>(sexp + k * NUM_EXP, x1, x2, a, &eu) - m);
    slse[n] = m + logf(s);
  }
  __syncthreads();

  // C: one warp per component — statistics, then its CVI update; job K is
  // the step's evidence.
  for (int job = warp; job <= K; job += NW) {
    if (job == K) {
      float ev = 0.0f;
      for (int n = lane; n < N; n += 32) ev += slse[n];
      ev = warp_sum(ev);
      if (lane == 0) a.metrics[t] = a.scale * ev;
      continue;
    }
    const float* e = sexp + job * NUM_EXP;
    float st[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = lane; n < N; n += 32) {
      const float x1 = sx1[n], x2 = sx2[n];
      float eu;
      const float r = expf(log_rho<SMM>(e, x1, x2, a, &eu) - slse[n]);
      const float w = SMM ? r * eu : r;
      st[0] += r;
      st[1] += w * x1;
      st[2] += w * x2;
      st[3] += w;
      st[4] += w * x1 * x1;
      st[5] += w * x1 * x2;
      st[6] += w * x2 * x2;
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) st[i] = warp_sum(st[i]);
    if (lane == 0) {
      const float delta[9] = {st[0], st[1], st[2], st[3], st[4],
                              st[5], st[5], st[6], st[0]};
      float* nt = snat + job * 9;
      const float* p0 = sprior + job * 9;
#pragma unroll
      for (int c = 0; c < 9; ++c)
        nt[c] = (1.0f - a.rho) * nt[c] + a.rho * (p0[c] + a.scale * delta[c]);
    }
  }
  __syncthreads();
}

template <bool SMM, int U>
__global__ void __launch_bounds__(NT, 1) mixstep_kernel(Args a) {
  const int tid = threadIdx.x;
  const int N = a.n, K = a.k;
  extern __shared__ float smem[];
  float* snat = smem;               // (K, 9)
  float* sprior = snat + K * 9;     // (K, 9)
  float* sexp = sprior + K * 9;     // (K, NUM_EXP)
  float* sx1 = sexp + K * NUM_EXP;  // (N,)
  float* sx2 = sx1 + N;             // (N,)
  float* slse = sx2 + N;            // (N,)

  for (int i = tid; i < K * 9; i += NT) {
    snat[i] = a.nat[i];
    sprior[i] = a.prior[i];
  }
  for (int n = tid; n < N; n += NT) {
    sx1[n] = a.x[2 * n];
    sx2[n] = a.x[2 * n + 1];
  }
  __syncthreads();

  for (int t = 0; t < a.t_steps; t += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) one_step<SMM>(a, t + u, snat, sprior, sexp, sx1, sx2, slse);
  }

  for (int i = tid; i < K * 9; i += NT) a.nat[i] = snat[i];
}

template <bool SMM, int U>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = (static_cast<size_t>(a.k) * (18 + NUM_EXP) + 3 * a.n) * sizeof(float);
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
