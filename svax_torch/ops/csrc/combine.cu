// combine: the fused SIN combine, forward and recompute backward.
//
// Replaces the TPU kernels of svax/ops/combine_pallas.py: _fwd_call
// (pallas_call at :431) and _bwd_call's two recompute kernels (:588, :637),
// entry combine_fused (:754). Per (n, k), with no N·K·d·d tensor in device
// memory: J̃ = diag(Pₙ) + E[Λ_k] → L̃ = chol(J̃) → μ̃, log|J̃| → log ρ →
// softmax over K → Σ̃ = J̃⁻¹ → the local-KL row → z = μ̃ + L̃⁻ᵀε (S samples)
// → the (K, 1 + d + d²) statistics Σ_n r̃·[1, μ̃, Σ̃ + μ̃μ̃ᵀ]. The backward
// recomputes the forward per (n, k) and applies the hand-derived VJP of
// svax_torch/ops/combine.py: combine_grads_manual (tested there against
// autograd), giving the cotangents of pot_h, pot_p and the packed expected
// parameters w from those of z, log r̃, μ̃, the local row and the statistics.
//
// Bound: at bigk (N = 1024, K = 100, d = 10, S = 1) the forward writes z,
// μ̃ (4.1 MB each) and log r̃ (0.4 MB) and does ~0.2 GFLOP, so bytes and
// operations are within a factor of ~1.5 of each other (a few µs); at mnist
// (N = 256, K = 10, d = 8) the work is ~100 KB and the kernels are latency-
// bound: a launch plus one dependent chain of ~d³ operations per thread.
// Design: one thread per (n, k) runs the combine_tile.cuh device functions
// on register arrays (d a template parameter; at d = 10 the L̃, L̃⁻¹, Σ̃ and
// backward arrays spill to local memory, which L1 holds). A block holds R =
// 128 / K whole rows of K (K ≤ 128), so the softmax over K and the sums over
// k for the potentials' cotangents stay in shared memory. The (K, F)
// statistics and the (K, 3 + d + d²) dw are sums over n: each block writes
// its partial sum (rows added in order) and a second kernel adds the
// partials in block order, as estep.cu does. No float atomics: reruns are
// bit-equal. ε comes from the caller, or from Philox4x32-10 + Box–Muller
// (philox.cuh) keyed (seed, step) and counted by ((s·N + n)·K + k)·d + i, so
// the backward regenerates the forward's numbers whatever the tiling.
//
// Component parallelism (log_rho_fused, combine_pallas.py:722, and
// combine_fused's log_norm mode, _tile_core's norm=): with the mixture's K
// sharded over ranks, the softmax over K spans the shards. log_rho_fwd
// (replaces _rho_fwd_call's pallas_call, :288) writes this shard's
// pre-softmax log ρ (N, K); the caller takes the logsumexp across shards;
// combine_fwd<D, true> then reads that normaliser (N,) in place of its
// in-block softmax: log r̃ = log ρ − norm[n], r̃ = exp(log r̃), and
// combine_bwd<D, true> drops the softmax Jacobian (ρ̄ = lr̄) and writes the
// normaliser's cotangent dn[n] = −Σ_k lr̄ (the extra output of
// _fused_core_bwd, :682-697), which flows back through the lse into
// log_rho_bwd (replaces _rho_bwd_call's pallas_call, :342): per (n, k),
// log ρ = E[log π] + ½E[log|Λ|] − ½E[μᵀΛμ] + ½μ̃ᵀh̃ − ½log|J̃| gives
// h̃̄ = ρ̄μ̃ and the symmetric derivative in J̃, G = −½ρ̄(Σ̃ + μ̃μ̃ᵀ) — the
// tile_core_bwd formulas of combine_tile.cuh with no sample or local-KL
// cotangent — read back as combine_bwd reads its G. The mode is a template
// parameter, so the unsharded kernels keep their arithmetic (their outputs
// are bit-equal to those of the build before the mode existed). The
// ρ-kernels are bound by operations, as the combine is: at the bigk shard
// (N = 1024, K = 50, d = 10) ~32 MFLOP forward and ~80 backward, 0.5 and
// 1.2 µs at the card's f32 rate, against ~0.4 MB moved; one thread's
// dependent Cholesky chain and the launch set their time.
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "combine_tile.cuh"
#include "philox.cuh"

namespace {

using namespace svax;

constexpr int kThreads = 128;  // threads per block: R rows × K
constexpr int kMaxK = 128;

__host__ __device__ inline int rows_per_block(int k) { return k >= kThreads ? 1 : kThreads / k; }
__host__ __device__ inline int blocks_for(int n, int k) {
  const int r = rows_per_block(k);
  return (n + r - 1) / r;
}

struct FwdArgs {
  const float* __restrict__ ph;   // (N, D)
  const float* __restrict__ pp;   // (N, D)
  const float* __restrict__ w;    // (K, 3 + D + D²)
  const float* __restrict__ eps;  // (S, N, K, D) or null: in-kernel Philox
  const float* __restrict__ norm;  // (N,) log-normaliser (kNorm) or null
  int n, k, s;
  unsigned long long seed;
  uint32_t stream;
  float* z;         // (S, N, K, D)
  float* log_resp;  // (N, K)
  float* mean;      // (N, K, D)
  float* local;     // (N,)
  float* partial;   // (blocks, K, F)
};

struct BwdArgs {
  const float* __restrict__ ph;
  const float* __restrict__ pp;
  const float* __restrict__ w;
  const float* __restrict__ eps;
  const float* __restrict__ norm;  // (N,) (kNorm) or null
  int n, k, s;
  unsigned long long seed;
  uint32_t stream;
  const float* __restrict__ dz;      // (S, N, K, D) or null
  const float* __restrict__ dlr;     // (N, K) or null
  const float* __restrict__ dmu;     // (N, K, D) or null
  const float* __restrict__ dlocal;  // (N,) or null
  const float* __restrict__ dstats;  // (K, F) or null
  float* dph;                        // (N, D)
  float* dpp;                        // (N, D)
  float* partial;                    // (blocks, K, 3 + D + D²) or null: no dw
  float* dn;                         // (N,) (kNorm) or null
};

struct RhoArgs {
  const float* __restrict__ ph;    // (N, D)
  const float* __restrict__ pp;    // (N, D)
  const float* __restrict__ w;     // (K, 3 + D + D²)
  const float* __restrict__ drho;  // (N, K) cotangent (backward only)
  int n, k;
  float* log_rho;  // (N, K) (forward)
  float* dph;      // (N, D) (backward)
  float* dpp;      // (N, D)
  float* partial;  // (blocks, K, 3 + D + D²) or null: no dw
};

// The potentials of row n; rows past N get unit precision and zero h, so
// J̃ = I + E[Λ] stays PSD and every value they produce is finite.
template <int D>
__device__ __forceinline__ void load_row(const float* ph, const float* pp, int n, bool valid,
                                         float (&p)[D], float (&h)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    p[i] = valid ? pp[static_cast<size_t>(n) * D + i] : 1.0f;
    h[i] = valid ? ph[static_cast<size_t>(n) * D + i] : 0.0f;
  }
}

// log r̃ and r̃ of this thread from the row's log ρ in shared memory.
__device__ __forceinline__ void softmax_row(const float* row, int k, float log_rho,
                                            float& log_resp, float& resp) {
  float mx = -INFINITY;
  for (int c = 0; c < k; ++c) mx = fmaxf(mx, row[c]);
  float den = 0.0f;
  for (int c = 0; c < k; ++c) den += expf(row[c] - mx);
  log_resp = log_rho - (mx + logf(den));
  resp = expf(log_rho - mx) / den;
}

// log r̃ and r̃ against an external normaliser; rows past N take their own
// log ρ (r̃ = 1, finite; the callers zero what such rows add).
template <bool kNorm>
__device__ __forceinline__ void resp_of(const float* s_row, int k, const float* norm, int n,
                                        bool valid, float log_rho, float& log_resp,
                                        float& resp) {
  if constexpr (kNorm) {
    log_resp = log_rho - (valid ? norm[n] : log_rho);
    resp = expf(log_resp);
  } else {
    softmax_row(s_row, k, log_rho, log_resp, resp);
  }
}

template <int D>
__device__ __forceinline__ void noise(const float* eps, unsigned long long seed, uint32_t stream,
                                      size_t base, float (&e)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
    e[i] = eps ? eps[base + i] : philox_normal(seed, stream, static_cast<uint32_t>(base + i));
}

template <int D, bool kNorm>
__global__ void __launch_bounds__(kThreads) combine_fwd(FwdArgs a) {
  constexpr int F = 1 + D + D * D;
  const int K = a.k, R = rows_per_block(K);
  const int tid = threadIdx.x, row = tid / K, kk = tid % K;
  const int n = blockIdx.x * R + row;
  const bool valid = n < a.n;
  extern __shared__ float smem[];
  float* s_rho = smem;        // (R, K) log ρ
  float* s_loc = s_rho + R * K;  // (R, K) local-KL terms
  float* s_st = s_loc + R * K;   // (R, K, F) statistics terms

  const float* e = a.w + static_cast<size_t>(kk) * Slot<D>::SIZE;
  float p[D], h[D];
  load_row<D>(a.ph, a.pp, n, valid, p, h);
  float L[D][D], ht[D], mu[D], logdet_j, log_rho;
  tile_core<D>(e, p, h, L, ht, mu, logdet_j, log_rho);
  if constexpr (!kNorm) {
    s_rho[tid] = log_rho;
    __syncthreads();
  }
  float log_resp, resp;
  resp_of<kNorm>(s_rho + row * K, K, a.norm, n, valid, log_rho, log_resp, resp);

  const size_t nk = static_cast<size_t>(n) * K + kk;
  if (valid) {
    a.log_resp[nk] = log_resp;
#pragma unroll
    for (int i = 0; i < D; ++i) a.mean[nk * D + i] = mu[i];
    for (int s = 0; s < a.s; ++s) {
      const size_t base = ((static_cast<size_t>(s) * a.n + n) * K + kk) * D;
      float ev[D], u[D];
      noise<D>(a.eps, a.seed, a.stream, base, ev);
      solve_upper<D>(L, ev, u);
#pragma unroll
      for (int i = 0; i < D; ++i) a.z[base + i] = mu[i] + u[i];
    }
  }

  float Li[D][D], C[D][D];
  tri_inverse<D>(L, Li);
  cov_from_inverse<D>(Li, C);
  const float r = valid ? resp : 0.0f;
  const float a_nk = log_resp - 0.5f * D * (1.0f + kTileLog2Pi) + local_a0<D>(e, mu, C, logdet_j);
  s_loc[tid] = r * a_nk;
  float* st = s_st + static_cast<size_t>(tid) * F;
  st[0] = r;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    st[1 + i] = r * mu[i];
#pragma unroll
    for (int j = 0; j < D; ++j) st[1 + D + i * D + j] = r * (C[i][j] + mu[i] * mu[j]);
  }
  __syncthreads();

  if (valid && kk == 0) {
    float acc = 0.0f;
    for (int c = 0; c < K; ++c) acc += s_loc[row * K + c];
    a.local[n] = acc;
  }
  float* out = a.partial + static_cast<size_t>(blockIdx.x) * K * F;
  for (int idx = tid; idx < K * F; idx += blockDim.x) {
    float acc = 0.0f;
    for (int r2 = 0; r2 < R; ++r2) acc += s_st[static_cast<size_t>(r2 * K) * F + idx];
    out[idx] = acc;
  }
}

template <int D, bool kNorm>
__global__ void __launch_bounds__(kThreads) combine_bwd(BwdArgs a) {
  using S = Slot<D>;
  constexpr int F = 1 + D + D * D, W = S::SIZE, P = 2 * D;
  const int K = a.k, R = rows_per_block(K);
  const int tid = threadIdx.x, row = tid / K, kk = tid % K;
  const int n = blockIdx.x * R + row;
  const bool valid = n < a.n;
  extern __shared__ float smem[];
  float* s_rho = smem;            // (R, K) log ρ
  float* s_lrb = s_rho + R * K;   // (R, K) lr̄
  float* s_pot = s_lrb + R * K;   // (R, K, 2D) [h̃̄, diag G]
  float* s_dw = s_pot + R * K * P;  // (R, K, W) dw terms

  const float* e = a.w + static_cast<size_t>(kk) * W;
  float p[D], h[D];
  load_row<D>(a.ph, a.pp, n, valid, p, h);
  float L[D][D], ht[D], mu[D], logdet_j, log_rho;
  tile_core<D>(e, p, h, L, ht, mu, logdet_j, log_rho);
  if constexpr (!kNorm) {
    s_rho[tid] = log_rho;
    __syncthreads();
  }
  float log_resp, resp;
  resp_of<kNorm>(s_rho + row * K, K, a.norm, n, valid, log_rho, log_resp, resp);
  float Li[D][D], C[D][D];
  tri_inverse<D>(L, Li);
  cov_from_inverse<D>(Li, C);
  const float a_nk = log_resp - 0.5f * D * (1.0f + kTileLog2Pi) + local_a0<D>(e, mu, C, logdet_j);

  // Rows past N read no cotangent, so every term they add below is zero.
  const size_t nk = static_cast<size_t>(n) * K + kk;
  const float lb = (valid && a.dlocal) ? a.dlocal[n] : 0.0f;
  const float omega = lb * resp;
  const float* ds = (valid && a.dstats) ? a.dstats + static_cast<size_t>(kk) * F : nullptr;
  float rbar = lb * a_nk;
  if (ds) {
    rbar += ds[0];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      rbar += ds[1 + i] * mu[i];
#pragma unroll
      for (int j = 0; j < D; ++j) rbar += ds[1 + D + i * D + j] * (C[i][j] + mu[i] * mu[j]);
    }
  }
  const float lrbar = ((valid && a.dlr) ? a.dlr[nk] : 0.0f) + omega + rbar * resp;
  s_lrb[tid] = lrbar;
  __syncthreads();
  float rhobar;
  if constexpr (kNorm) {
    // log r̃ = log ρ − norm: no softmax Jacobian; the normaliser's cotangent
    // is −Σ_k lr̄.
    rhobar = lrbar;
    if (valid && kk == 0) {
      float lsum = 0.0f;
      for (int c = 0; c < K; ++c) lsum += s_lrb[row * K + c];
      a.dn[n] = -lsum;
    }
  } else {
    float lsum = 0.0f;
    for (int c = 0; c < K; ++c) lsum += s_lrb[row * K + c];
    rhobar = lrbar - resp * lsum;
  }

  // μ̄: the mean output, the local KL, the statistics and ½μ̃ᵀh̃ in log ρ.
  float mb[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float sp = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) sp += 0.5f * (e[S::PREC + i * D + j] + e[S::PREC + j * D + i]) * mu[j];
    mb[i] = omega * (sp - e[S::PM + i]) + 0.5f * rhobar * ht[i];
    if (valid && a.dmu) mb[i] += a.dmu[nk * D + i];
    if (ds) {
      float t = ds[1 + i];
#pragma unroll
      for (int j = 0; j < D; ++j) t += (ds[1 + D + i * D + j] + ds[1 + D + j * D + i]) * mu[j];
      mb[i] += resp * t;
    }
  }
  // Samples: z̄ reaches μ̃ directly and L̃ as L̄ = −Σ_s tril(u vᵀ), u = L̃⁻ᵀε,
  // v = L̃⁻¹z̄ (lower triangle kept).
  float Lb[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) Lb[i][j] = 0.0f;
  if (valid && a.dz) {
    for (int s = 0; s < a.s; ++s) {
      const size_t base = ((static_cast<size_t>(s) * a.n + n) * K + kk) * D;
      float ev[D], u[D], zb[D], v[D];
      noise<D>(a.eps, a.seed, a.stream, base, ev);
      solve_upper<D>(L, ev, u);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        zb[i] = a.dz[base + i];
        mb[i] += zb[i];
      }
      lower_times<D>(Li, zb, v);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) Lb[i][j] -= u[i] * v[j];
    }
  }
  const float ldbar = 0.5f * omega - 0.5f * rhobar;
  float cmb[D], htb[D];  // Σ̃μ̄ and h̃̄
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) acc += C[i][j] * mb[j];
    cmb[i] = acc;
    htb[i] = acc + 0.5f * rhobar * mu[i];
  }

  // Cholesky backward: X = Φ(L̃ᵀL̄) then Y = X L̃⁻¹, both in place in Lb (lower);
  // M = L̃⁻ᵀY.
#pragma unroll
  for (int r2 = 0; r2 < D; ++r2)
#pragma unroll
    for (int c = 0; c <= r2; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int m = r2; m < D; ++m) acc += L[m][r2] * Lb[m][c];
      Lb[r2][c] = r2 == c ? 0.5f * acc : acc;
    }
#pragma unroll
  for (int r2 = 0; r2 < D; ++r2)
#pragma unroll
    for (int c = 0; c <= r2; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int m = c; m <= r2; ++m) acc += Lb[r2][m] * Li[m][c];
      Lb[r2][c] = acc;
    }
  // T = Σ̄Σ̃ with Σ̄ = ½ω sym(E[Λ]) + r̃ sym(s̄₂).
  float T[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < D; ++b) {
        float sb = 0.5f * omega * 0.5f * (e[S::PREC + i * D + b] + e[S::PREC + b * D + i]);
        if (ds) sb += resp * 0.5f * (ds[1 + D + i * D + b] + ds[1 + D + b * D + i]);
        acc += sb * C[b][j];
      }
      T[i][j] = acc;
    }

  // G (lower triangle), the symmetric derivative in J̃, read back through
  // the Cholesky's lower triangle: P̄ₙ += diag G, E[Λ]‾ += tril(2G, −1) +
  // diag G, plus the local KL's direct ½ω(Σ̃ + μ̃μ̃ᵀ).
  float* dwt = s_dw + static_cast<size_t>(tid) * W;
  float* pot = s_pot + static_cast<size_t>(tid) * P;
  dwt[S::LOGPI] = rhobar - omega;
  dwt[S::LOGDET] = 0.5f * (rhobar - omega);
  dwt[S::QUAD] = 0.5f * (omega - rhobar);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    dwt[S::PM + i] = htb[i] - omega * mu[i];
    pot[i] = htb[i];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float gl = 0.0f;
      if (j <= i) {
        float m_ij = 0.0f, m_ji = 0.0f;
#pragma unroll
        for (int m = i; m < D; ++m) m_ij += Li[m][i] * Lb[m][j];
#pragma unroll
        for (int m = i; m < D; ++m) m_ji += Li[m][j] * Lb[m][i];
        float cpc = 0.0f;
#pragma unroll
        for (int b = 0; b < D; ++b) cpc += C[i][b] * T[b][j];
        const float g = ldbar * C[i][j] - 0.5f * (cmb[i] * mu[j] + cmb[j] * mu[i]) - cpc +
                        0.5f * (m_ij + m_ji);
        gl = i == j ? g : 2.0f * g;
        if (i == j) pot[D + i] = g;
      }
      dwt[S::PREC + i * D + j] = gl + 0.5f * omega * (C[i][j] + mu[i] * mu[j]);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < R * P; idx += blockDim.x) {
    const int r2 = idx / P, c = idx % P, n2 = blockIdx.x * R + r2;
    if (n2 >= a.n) continue;
    float acc = 0.0f;
    for (int c2 = 0; c2 < K; ++c2) acc += s_pot[static_cast<size_t>(r2 * K + c2) * P + c];
    if (c < D)
      a.dph[static_cast<size_t>(n2) * D + c] = acc;
    else
      a.dpp[static_cast<size_t>(n2) * D + c - D] = acc;
  }
  if (a.partial) {
    float* out = a.partial + static_cast<size_t>(blockIdx.x) * K * W;
    for (int idx = tid; idx < K * W; idx += blockDim.x) {
      float acc = 0.0f;
      for (int r2 = 0; r2 < R; ++r2) acc += s_dw[static_cast<size_t>(r2 * K) * W + idx];
      out[idx] = acc;
    }
  }
}

// log ρ per (n, k): one thread each.
template <int D>
__global__ void __launch_bounds__(kThreads) log_rho_fwd(RhoArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.n * a.k) return;
  const int n = idx / a.k, kk = idx % a.k;
  float p[D], h[D];
  load_row<D>(a.ph, a.pp, n, true, p, h);
  float L[D][D], ht[D], mu[D], logdet_j, log_rho;
  tile_core<D>(a.w + static_cast<size_t>(kk) * Slot<D>::SIZE, p, h, L, ht, mu, logdet_j,
               log_rho);
  a.log_rho[idx] = log_rho;
}

// The recompute backward of log_rho_fwd, laid out as combine_bwd: a block
// holds R whole rows of K, sums its rows' dph, dpp over k in shared memory
// and writes its (K, 3 + D + D²) dw partial for reduce_blocks.
template <int D>
__global__ void __launch_bounds__(kThreads) log_rho_bwd(RhoArgs a) {
  using S = Slot<D>;
  constexpr int W = S::SIZE, P = 2 * D;
  const int K = a.k, R = rows_per_block(K);
  const int tid = threadIdx.x, row = tid / K, kk = tid % K;
  const int n = blockIdx.x * R + row;
  const bool valid = n < a.n;
  extern __shared__ float smem[];
  float* s_pot = smem;              // (R, K, 2D) [h̃̄, diag G]
  float* s_dw = s_pot + R * K * P;  // (R, K, W) dw terms

  const float* e = a.w + static_cast<size_t>(kk) * W;
  float p[D], h[D];
  load_row<D>(a.ph, a.pp, n, valid, p, h);
  float L[D][D], ht[D], mu[D], logdet_j, log_rho;
  tile_core<D>(e, p, h, L, ht, mu, logdet_j, log_rho);
  float Li[D][D], C[D][D];
  tri_inverse<D>(L, Li);
  cov_from_inverse<D>(Li, C);
  // Rows past N read no cotangent: every term they add is zero.
  const float rb = valid ? a.drho[static_cast<size_t>(n) * K + kk] : 0.0f;

  float* dwt = s_dw + static_cast<size_t>(tid) * W;
  float* pot = s_pot + static_cast<size_t>(tid) * P;
  dwt[S::LOGPI] = rb;
  dwt[S::LOGDET] = 0.5f * rb;
  dwt[S::QUAD] = -0.5f * rb;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    dwt[S::PM + i] = rb * mu[i];
    pot[i] = rb * mu[i];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float g = -0.5f * rb * (C[i][j] + mu[i] * mu[j]);
      dwt[S::PREC + i * D + j] = j < i ? 2.0f * g : (j == i ? g : 0.0f);
      if (i == j) pot[D + i] = g;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < R * P; idx += blockDim.x) {
    const int r2 = idx / P, c = idx % P, n2 = blockIdx.x * R + r2;
    if (n2 >= a.n) continue;
    float acc = 0.0f;
    for (int c2 = 0; c2 < K; ++c2) acc += s_pot[static_cast<size_t>(r2 * K + c2) * P + c];
    if (c < D)
      a.dph[static_cast<size_t>(n2) * D + c] = acc;
    else
      a.dpp[static_cast<size_t>(n2) * D + c - D] = acc;
  }
  if (a.partial) {
    float* out = a.partial + static_cast<size_t>(blockIdx.x) * K * W;
    for (int idx = tid; idx < K * W; idx += blockDim.x) {
      float acc = 0.0f;
      for (int r2 = 0; r2 < R; ++r2) acc += s_dw[static_cast<size_t>(r2 * K) * W + idx];
      out[idx] = acc;
    }
  }
}

// out[e] = Σ_b partial[b·len + e], b in order.
__global__ void reduce_blocks(const float* partial, int blocks, int len, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * len + e];
  out[e] = s;
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const Args& a, int blocks, int threads, size_t bytes,
                   int& opted, cudaStream_t st) {
  if (static_cast<int>(bytes) > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted = static_cast<int>(bytes);
  }
  kernel<<<blocks, threads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D, bool kNorm>
cudaError_t forward_d(const FwdArgs& a, float* stats, cudaStream_t st) {
  constexpr int F = 1 + D + D * D;
  static int opted = 0;
  const int threads = rows_per_block(a.k) * a.k, blocks = blocks_for(a.n, a.k);
  const size_t bytes = static_cast<size_t>(threads) * (2 + F) * sizeof(float);
  cudaError_t err = launch(combine_fwd<D, kNorm>, a, blocks, threads, bytes, opted, st);
  if (err != cudaSuccess) return err;
  const int len = a.k * F;
  reduce_blocks<<<(len + 255) / 256, 256, 0, st>>>(a.partial, blocks, len, stats);
  return cudaGetLastError();
}

template <int D, bool kNorm>
cudaError_t backward_d(const BwdArgs& a, float* dw, cudaStream_t st) {
  constexpr int W = Slot<D>::SIZE;
  static int opted = 0;
  const int threads = rows_per_block(a.k) * a.k, blocks = blocks_for(a.n, a.k);
  const size_t bytes = static_cast<size_t>(threads) * (2 + 2 * D + W) * sizeof(float);
  cudaError_t err = launch(combine_bwd<D, kNorm>, a, blocks, threads, bytes, opted, st);
  if (err != cudaSuccess || !a.partial) return err;
  const int len = a.k * W;
  reduce_blocks<<<(len + 255) / 256, 256, 0, st>>>(a.partial, blocks, len, dw);
  return cudaGetLastError();
}

template <int D>
cudaError_t forward_mode(const FwdArgs& a, float* stats, cudaStream_t st) {
  return a.norm ? forward_d<D, true>(a, stats, st) : forward_d<D, false>(a, stats, st);
}

template <int D>
cudaError_t backward_mode(const BwdArgs& a, float* dw, cudaStream_t st) {
  return a.norm ? backward_d<D, true>(a, dw, st) : backward_d<D, false>(a, dw, st);
}

template <int D>
cudaError_t rho_forward_d(const RhoArgs& a, cudaStream_t st) {
  const int total = a.n * a.k;
  log_rho_fwd<D><<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t rho_backward_d(const RhoArgs& a, float* dw, cudaStream_t st) {
  constexpr int W = Slot<D>::SIZE;
  static int opted = 0;
  const int threads = rows_per_block(a.k) * a.k, blocks = blocks_for(a.n, a.k);
  const size_t bytes = static_cast<size_t>(threads) * (2 * D + W) * sizeof(float);
  cudaError_t err = launch(log_rho_bwd<D>, a, blocks, threads, bytes, opted, st);
  if (err != cudaSuccess || !a.partial) return err;
  const int len = a.k * W;
  reduce_blocks<<<(len + 255) / 256, 256, 0, st>>>(a.partial, blocks, len, dw);
  return cudaGetLastError();
}

bool shape_ok(int n, int k, int s) { return n >= 1 && k >= 1 && k <= kMaxK && s >= 1; }

}  // namespace

// The switch over d in the kernels' shape class: CALL(D) for each.
#define SVAX_BY_DIM(d, err, CALL)         \
  switch (d) {                            \
    case 2: err = CALL(2); break;         \
    case 3: err = CALL(3); break;         \
    case 4: err = CALL(4); break;         \
    case 6: err = CALL(6); break;         \
    case 8: err = CALL(8); break;         \
    case 10: err = CALL(10); break;       \
    default: err = cudaErrorInvalidValue; \
  }

extern "C" {

// Blocks for N points and K components: the partial buffers hold
// blocks·K·F (forward) and blocks·K·(3 + d + d²) (backward) floats, for
// the combine and the ρ-kernel alike.
int combine_blocks(int n, int k) { return blocks_for(n, k); }

// Forward: z (S, N, K, d), log r̃ (N, K), μ̃ (N, K, d), the local row (N,)
// and the raw statistics (K, 1 + d + d²), unscaled and unsymmetrised.
// norm (N,) null: the softmax over this K; else log r̃ = log ρ − norm.
int combine_forward(const float* ph, const float* pp, const float* w, const float* eps,
                    const float* norm, int n, int k, int d, int s, unsigned long long seed,
                    unsigned int stream_id, float* z, float* log_resp, float* mean, float* local,
                    float* partial, float* stats, void* stream) {
  if (!shape_ok(n, k, s)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{ph,       pp,   w,    eps,   norm,  n,      k,
                  s,        seed, stream_id, z, log_resp, mean, local, partial};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SVAX_CALL(D) forward_mode<D>(a, stats, st)
  SVAX_BY_DIM(d, err, SVAX_CALL)
#undef SVAX_CALL
  return static_cast<int>(err);
}

// Backward: the cotangents of pot_h, pot_p (N, d) and, when dw is not
// null, of w (K, 3 + d + d²), from those of the forward's outputs (each
// may be null: zero); with norm, also the normaliser's dn (N,).
int combine_backward(const float* ph, const float* pp, const float* w, const float* eps,
                     const float* norm, int n, int k, int d, int s, unsigned long long seed,
                     unsigned int stream_id, const float* dz, const float* dlr, const float* dmu,
                     const float* dlocal, const float* dstats, float* dph, float* dpp,
                     float* dn, float* partial, float* dw, void* stream) {
  if (!shape_ok(n, k, s) || (dw == nullptr) != (partial == nullptr) ||
      (norm == nullptr) != (dn == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{ph,     pp,  w,      eps,    norm, n,   k,       s,  seed,
                  stream_id, dz, dlr, dmu, dlocal, dstats, dph, dpp, partial, dn};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SVAX_CALL(D) backward_mode<D>(a, dw, st)
  SVAX_BY_DIM(d, err, SVAX_CALL)
#undef SVAX_CALL
  return static_cast<int>(err);
}

// The ρ-kernel: this K-shard's pre-softmax log ρ (N, K).
int rho_forward(const float* ph, const float* pp, const float* w, int n, int k, int d,
                float* log_rho, void* stream) {
  if (!shape_ok(n, k, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const RhoArgs a{ph, pp, w, nullptr, n, k, log_rho, nullptr, nullptr, nullptr};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SVAX_CALL(D) rho_forward_d<D>(a, st)
  SVAX_BY_DIM(d, err, SVAX_CALL)
#undef SVAX_CALL
  return static_cast<int>(err);
}

// Its backward: the cotangents of pot_h, pot_p (N, d) and, when dw is not
// null, of w (K, 3 + d + d²) from drho (N, K).
int rho_backward(const float* ph, const float* pp, const float* w, const float* drho, int n,
                 int k, int d, float* dph, float* dpp, float* partial, float* dw, void* stream) {
  if (!shape_ok(n, k, 1) || (dw == nullptr) != (partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const RhoArgs a{ph, pp, w, drho, n, k, nullptr, dph, dpp, partial};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SVAX_CALL(D) rho_backward_d<D>(a, dw, st)
  SVAX_BY_DIM(d, err, SVAX_CALL)
#undef SVAX_CALL
  return static_cast<int>(err);
}

}  // extern "C"
