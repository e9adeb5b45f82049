// combine_bwd: the fused SIN combine's backward for the train step's call.
//
// Replaces, for the call the train step makes, the two recompute kernels
// of svax/ops/combine_pallas.py's _bwd_call (pallas_call at :588, :637).
// The step differentiates the network's parameters only (the statistics go
// to the CVI update detached, and the expected parameters are constants of
// the step), so the backward receives the cotangents of z, log r̃ and the
// local row (and may receive μ̃'s), and owes the potentials' cotangents
// dpot_h = Σ_k h̃̄ and dpot_p = Σ_k diag G (with log_norm, also dn): no
// dstats and no dw. combine_bwd_lean computes just those, per (n, k):
//   ω = local̄ₙ r̃, lr̄ = dlr + ω + local̄ₙ a_nk r̃, ρ̄ = lr̄ − r̃ Σ_k lr̄,
//   μ̄ = μ̄_out + Σ_s z̄_s + ω(sym(E[Λ])μ̃ − E[Λμ]) + ½ρ̄ h̃,
//   h̃̄ = Σ̃μ̄ + ½ρ̄ μ̃,
//   G_ii = (½ω − ½ρ̄) Σ̃_ii − (Σ̃μ̄)_i μ̃_i − ½ω (Σ̃ sym(E[Λ]) Σ̃)_ii + M_ii,
// the last the Cholesky backward's term (svax_torch/ops/combine.py:
// combine_grads_manual; combine_grads_lean is this kernel's mirror). For
// L̄ = −Σ_s tril(u vᵀ) with u = L̃⁻ᵀε and v = L̃⁻¹z̄, L̃ᵀu = ε gives
// Φ(L̃ᵀL̄)_ab = −Σ_s φ_ab ε_a v_b (a ≥ b; φ = ½ on the diagonal), so
//   M_ii = (L̃⁻ᵀΦ(L̃ᵀL̄)L̃⁻¹)_ii = −Σ_s Σ_{a ≥ i} L̃⁻¹_ai ε_a P_a,
//   P_a = Σ_{i ≤ b < a} v_b L̃⁻¹_bi + ½ v_a L̃⁻¹_ai,
// a prefix sum down column i of L̃⁻¹: O(d²) a pair, and L̃ itself is never
// needed after its inverse. No off-diagonal G, no Σ̃Σ̄Σ̃ beyond its diagonal
// (a quadratic form in each column of Σ̃), no dw.
//
// Bound: at bigk (N = 1024, K = 100, d = 10, S = 1) it reads 4.5 MB (z̄, ε
// regenerated) and does ~0.4 GFLOP: operations, ~6 µs at the card's f32
// rate. Design: combine_core.cuh's layout (one thread per (n, k), packed
// L̃⁻¹ in registers, the component rows staged k-minor once per block, at
// most 256 / K rows a block, the row groups dealt to the card's capacity in
// contiguous runs); dpot_h, dpot_p and dn are sums over k of the block's
// rows, added in k order in shared memory. No atomics: reruns are
// bit-equal.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "combine_core.cuh"

namespace {

using svax::comb::BwdArgs;
using svax::comb::Planes;
using svax::comb::tidx;
using svax::comb::tri;

template <int D, bool kNorm>
__global__ void __launch_bounds__(svax::comb::kBlockThreads, 1) combine_bwd_lean(BwdArgs a) {
  namespace c = svax::comb;
  using P = Planes<D>;
  constexpr int T = tri(D);
  const int K = a.k, R = a.rows, NT = R * K;
  const int tid = threadIdx.x, r = tid / K, k = tid % K;
  extern __shared__ float smem[];
  float* s_w = smem;                 // (P::COUNT, K) the component rows
  float* s_rho = s_w + P::COUNT * K;  // (NT) log ρ
  float* s_ex = s_rho + NT;           // (NT) exp(log ρ − the row's max)
  float* s_lrb = s_ex + NT;           // (NT) lr̄
  float* s_pot = s_lrb + NT;          // (2D, NT) h̃̄, diag G
  c::stage<D>(a.w, nullptr, K, s_w);
  __syncthreads();

  const int g1 = c::run_begin(blockIdx.x + 1, a.groups, a.blocks);
  for (int g = c::run_begin(blockIdx.x, a.groups, a.blocks); g < g1; ++g) {
    const int n = g * R + r;
    const bool valid = n < a.n;
    float p[D], h[D];
    c::load_row<D>(a.ph, a.pp, n, valid, p, h);
    float L[T], ht[D], mu[D], logdet_j, log_rho;
    c::recompute<D>(s_w, K, k, p, h, L, ht, mu, logdet_j, log_rho);
    float log_resp, resp;
    c::responsibility<kNorm>(s_rho, s_ex, K, r, a.norm, n, valid, log_rho, log_resp, resp);
    c::invert<D>(L);  // L holds L̃⁻¹ from here

    // Rows past N read no cotangent, so every term they add below is zero.
    const size_t nk = static_cast<size_t>(n) * K + k;
    const bool has_local = valid && a.dlocal;
    const float lb = has_local ? a.dlocal[n] : 0.0f;
    const float omega = lb * resp;
    float rbar = 0.0f;
    if (has_local) rbar = lb * (log_resp + c::local_rest<D>(s_w, K, k, L, mu, logdet_j));
    const float lrbar = ((valid && a.dlr) ? a.dlr[nk] : 0.0f) + omega + rbar * resp;
    s_lrb[tid] = lrbar;
    __syncthreads();
    float lsum = 0.0f;
    for (int c2 = 0; c2 < K; ++c2) lsum += s_lrb[r * K + c2];
    float rhobar = lrbar;
    if constexpr (kNorm) {
      if (valid && k == 0) a.dn[n] = -lsum;
    } else {
      rhobar = lrbar - resp * lsum;
    }

    // μ̄ without the samples, then the samples: z̄ into μ̄ and the Cholesky
    // term's diagonal M_ii.
    float mb[D], mdiag[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      c::no_hoist();
      float sp = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) sp += c::esym<D>(s_w, K, k, i, j) * mu[j];
      mb[i] = omega * (sp - s_w[(P::PM + i) * K + k]) + 0.5f * rhobar * ht[i];
      if (valid && a.dmu) mb[i] += a.dmu[nk * D + i];
      mdiag[i] = 0.0f;
    }
    if (valid && a.dz) {
      for (int s = 0; s < a.s; ++s) {
        const size_t base = ((static_cast<size_t>(s) * a.n + n) * K + k) * D;
        float ev[D], zb[D], v[D];
        c::noise<D>(a.eps, a.word, base, ev);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          zb[i] = a.dz[base + i];
          mb[i] += zb[i];
        }
#pragma unroll
        for (int i = 0; i < D; ++i) {  // v = L̃⁻¹z̄
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j <= i; ++j) acc += L[tidx(i, j)] * zb[j];
          v[i] = acc;
        }
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float pre = 0.0f, term = 0.0f;
#pragma unroll
          for (int m = i; m < D; ++m) {
            const float y = L[tidx(m, i)];
            term += y * ev[m] * (pre + 0.5f * v[m] * y);
            pre += v[m] * y;
          }
          mdiag[i] -= term;
        }
      }
    }

    // Σ̃μ̄ = L̃⁻ᵀ(L̃⁻¹μ̄), then per i: h̃̄_i and G_ii.
    float t[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j <= i; ++j) acc += L[tidx(i, j)] * mb[j];
      t[i] = acc;
    }
    const float ldbar = 0.5f * omega - 0.5f * rhobar;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      c::no_hoist();
      float cmb = 0.0f, cii = 0.0f;
#pragma unroll
      for (int m = i; m < D; ++m) {
        cmb += L[tidx(m, i)] * t[m];
        cii += L[tidx(m, i)] * L[tidx(m, i)];
      }
      float quad = 0.0f;  // (Σ̃ sym(E[Λ]) Σ̃)_ii = cᵀ sym(E[Λ]) c, c = Σ̃ e_i
      if (has_local) {
        float col[D];
#pragma unroll
        for (int b = 0; b < D; ++b) col[b] = b == i ? cii : c::cov<D>(L, b, i);
#pragma unroll
        for (int a2 = 0; a2 < D; ++a2) {
          float row = 0.0f;
#pragma unroll
          for (int b = 0; b < a2; ++b) row += s_w[(P::ES + tidx(a2, b)) * K + k] * col[b];
          quad += col[a2] * (s_w[(P::ES + tidx(a2, a2)) * K + k] * col[a2] + 2.0f * row);
        }
      }
      s_pot[i * NT + tid] = cmb + 0.5f * rhobar * mu[i];
      s_pot[(D + i) * NT + tid] = ldbar * cii - cmb * mu[i] - 0.5f * omega * quad + mdiag[i];
    }
    __syncthreads();
    for (int idx = tid; idx < R * 2 * D; idx += NT) {
      const int r2 = idx / (2 * D), col = idx % (2 * D), n2 = g * R + r2;
      if (n2 >= a.n) continue;
      float acc = 0.0f;
      for (int c2 = 0; c2 < K; ++c2) acc += s_pot[col * NT + r2 * K + c2];
      if (col < D)
        a.dph[static_cast<size_t>(n2) * D + col] = acc;
      else
        a.dpp[static_cast<size_t>(n2) * D + col - D] = acc;
    }
  }
}

template <int D, bool kNorm>
cudaError_t lean_d(BwdArgs a, cudaStream_t st) {
  namespace c = svax::comb;
  static c::LaunchCache cache;
  int sms = 0, cap = 0;
  cudaError_t err = c::sm_count(sms);
  if (err != cudaSuccess) return err;
  a.rows = c::rows_per_block(a.n, a.k, c::kBlockThreads, sms);
  const int threads = a.rows * a.k;
  const size_t bytes = sizeof(float) * (static_cast<size_t>(Planes<D>::COUNT) * a.k +
                                        static_cast<size_t>(threads) * (3 + 2 * D));
  err = c::capacity(combine_bwd_lean<D, kNorm>, a.k, a.rows, bytes, sms, cache, cap);
  if (err != cudaSuccess) return err;
  a.groups = c::row_groups(a.n, a.rows);
  a.blocks = a.groups < cap ? a.groups : cap;
  combine_bwd_lean<D, kNorm><<<a.blocks, threads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t lean_mode(const BwdArgs& a, cudaStream_t st) {
  return a.norm ? lean_d<D, true>(a, st) : lean_d<D, false>(a, st);
}

}  // namespace

cudaError_t svax::comb::backward_lean(const BwdArgs& a, int d, cudaStream_t st) {
  switch (d) {
    case 2: return lean_mode<2>(a, st);
    case 3: return lean_mode<3>(a, st);
    case 4: return lean_mode<4>(a, st);
    case 6: return lean_mode<6>(a, st);
    case 8: return lean_mode<8>(a, st);
    case 10: return lean_mode<10>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
