// The SIN combine for one (n, k) pair at latent dimension D, forward and
// its hand-derived backward, as device functions on register arrays.
//
// Port of the tile math of svax/ops/combine_pallas.py (_tile_core,
// _tile_sampling, _tile_localstats — the functions its combine_fused and
// log_rho_fused kernels and flexstep_pallas run on (K_pad, T) slot planes;
// the backward there is jax.vjp). Here one thread owns one (n, k):
//
//   J̃ = diag(Pₙ) + E[Λ_k] → L̃ = chol(J̃) → μ̃ = J̃⁻¹(hₙ + E[Λμ]_k)
//   → log|J̃| → log ρ_nk → (softmax over K by the caller) → Σ̃ = J̃⁻¹
//   → the closed-form local-KL term → z = μ̃ + L̃⁻ᵀε.
//
// The backward (svax_torch/ops/flexstep.py: step_grads_manual is the same
// formulas in PyTorch, tested against autograd) needs only diag(J̄) and h̄,
// since the expected parameters are constants of the step:
//   d log|J̃| = tr(Σ̃ dJ̃), dμ̃ = Σ̃(dh̃ − dJ̃ μ̃), dΣ̃ = −Σ̃ dJ̃ Σ̃, and for the
//   samples the Cholesky backward J̄ ⊇ L̃⁻ᵀ Φ(L̃ᵀL̄) L̃⁻¹ (Murray 2016).
//
// Expected parameters of component k arrive as one slot row (combine_pallas's
// w block): [log π, E[log|Λ|], E[μᵀΛμ], E[Λμ] (D), E[Λ] (D×D row-major)].
// Matrices are [D][D] arrays of which only the lower triangle is used where
// the comment says so; D is a template parameter so everything unrolls
// into registers. Shared by flexstep.cu and combine.cu (the combine_fused
// port, whose kernel writes out the full backward, including J̄'s off-
// diagonal, the statistics' cotangent and dw, on top of these functions,
// and whose ρ-kernels — the log_rho_fused port — run tile_core and, for
// the backward, tri_inverse and cov_from_inverse).
#pragma once

namespace svax {

template <int D>
struct Slot {
  static constexpr int LOGPI = 0, LOGDET = 1, QUAD = 2, PM = 3, PREC = 3 + D;
  static constexpr int SIZE = 3 + D + D * D;
};

constexpr float kTileLog2Pi = 1.8378770664093453f;

// L = chol(A), reading A's lower triangle; L's upper triangle is zero.
template <int D>
__device__ __forceinline__ void cholesky(const float (&A)[D][D], float (&L)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) L[i][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = A[i][i];
#pragma unroll
    for (int m = 0; m < i; ++m) acc -= L[i][m] * L[i][m];
    L[i][i] = sqrtf(acc);
    const float inv = 1.0f / L[i][i];
#pragma unroll
    for (int r = i + 1; r < D; ++r) {
      float a = A[r][i];
#pragma unroll
      for (int m = 0; m < i; ++m) a -= L[r][m] * L[i][m];
      L[r][i] = a * inv;
    }
  }
}

// Forward core: L (lower), h̃, μ̃, log|J̃| and the pre-softmax log ρ.
template <int D>
__device__ __forceinline__ void tile_core(const float* e, const float (&p)[D],
                                          const float (&h)[D], float (&L)[D][D],
                                          float (&ht)[D], float (&mu)[D],
                                          float& logdet_j, float& log_rho) {
  using S = Slot<D>;
  float J[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    ht[i] = e[S::PM + i] + h[i];
#pragma unroll
    for (int j = 0; j < D; ++j) J[i][j] = e[S::PREC + i * D + j] + (i == j ? p[i] : 0.0f);
  }
  cholesky<D>(J, L);
  float y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = ht[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc -= L[i][j] * y[j];
    y[i] = acc / L[i][i];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int j = i + 1; j < D; ++j) acc -= L[j][i] * mu[j];
    mu[i] = acc / L[i][i];
  }
  logdet_j = 0.0f;
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    logdet_j += 2.0f * logf(L[i][i]);
    dot += mu[i] * ht[i];
  }
  log_rho = e[S::LOGPI] + 0.5f * e[S::LOGDET] - 0.5f * e[S::QUAD] + 0.5f * dot -
            0.5f * logdet_j;
}

// Li = L⁻¹ (lower).
template <int D>
__device__ __forceinline__ void tri_inverse(const float (&L)[D][D], float (&Li)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) Li[i][j] = 0.0f;
    Li[i][i] = 1.0f / L[i][i];
#pragma unroll
    for (int j = i - 1; j >= 0; --j) {
      float acc = 0.0f;
#pragma unroll
      for (int m = j; m < i; ++m) acc += L[i][m] * Li[m][j];
      Li[i][j] = -acc * Li[i][i];
    }
  }
}

// C = Σ̃ = J̃⁻¹ = L⁻ᵀL⁻¹ (full, symmetric).
template <int D>
__device__ __forceinline__ void cov_from_inverse(const float (&Li)[D][D], float (&C)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int m = i; m < D; ++m) acc += Li[m][i] * Li[m][j];
      C[i][j] = acc;
      C[j][i] = acc;
    }
}

// u = L⁻ᵀε: back substitution for Lᵀu = ε.
template <int D>
__device__ __forceinline__ void solve_upper(const float (&L)[D][D], const float (&e)[D],
                                            float (&u)[D]) {
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float acc = e[i];
#pragma unroll
    for (int j = i + 1; j < D; ++j) acc -= L[j][i] * u[j];
    u[i] = acc / L[i][i];
  }
}

// v = L⁻¹b from the explicit inverse.
template <int D>
__device__ __forceinline__ void lower_times(const float (&Li)[D][D], const float (&b)[D],
                                            float (&v)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j <= i; ++j) acc += Li[i][j] * b[j];
    v[i] = acc;
  }
}

// ½log|J̃| − E_q[log p̄(z, k)]: the part of the local-KL term
//   a_nk = log r̃_nk − (D/2)(1 + log 2π) + ½log|J̃| − E_q[log p̄(z, k)]
// that does not depend on the softmax (svae.local_kl_term), with
//   E_q[log p̄] = E[log π] + ḡ_k + E[Λμ]ᵀμ̃ − ½(tr(E[Λ]Σ̃) + μ̃ᵀE[Λ]μ̃),
//   ḡ_k = ½E[log|Λ|] − (D/2)log 2π − ½E[μᵀΛμ].
template <int D>
__device__ __forceinline__ float local_a0(const float* e, const float (&mu)[D],
                                          const float (&C)[D][D], float logdet_j) {
  using S = Slot<D>;
  float cross = 0.0f, trq = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    cross += e[S::PM + i] * mu[i];
#pragma unroll
    for (int j = 0; j < D; ++j) trq += e[S::PREC + i * D + j] * (C[i][j] + mu[i] * mu[j]);
  }
  const float g = 0.5f * e[S::LOGDET] - 0.5f * D * kTileLog2Pi - 0.5f * e[S::QUAD];
  const float e_log_pbar = e[S::LOGPI] + g + cross - 0.5f * trq;
  return 0.5f * logdet_j - e_log_pbar;
}

// Backward of one (n, k) to the encoder's potential: diag(J̄) (= the
// cotangent of Pₙ from this k) and h̄ (of hₙ).
//   mubar: Σ_s z̄_s (the samples' cotangent reaching μ̃ directly);
//   Lbar:  −Σ_s u_s (L⁻¹z̄_s)ᵀ, lower triangle (the samples' cotangent on L̃);
//   w:     the local KL's weight ∂neg_loss/∂local · r̃_nk;
//   rhobar: the cotangent of log ρ_nk after the softmax.
template <int D>
__device__ __forceinline__ void tile_core_bwd(const float* e, const float (&L)[D][D],
                                              const float (&Li)[D][D], const float (&C)[D][D],
                                              const float (&mu)[D], const float (&ht)[D],
                                              const float (&mubar)[D], const float (&Lbar)[D][D],
                                              float w, float rhobar, float (&jbar)[D],
                                              float (&hbar)[D]) {
  using S = Slot<D>;
  // μ̄: samples, the local KL (E[Λ]μ̃ − E[Λμ]) and ½μ̃ᵀh̃ in log ρ.
  float mb[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float pmu = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) pmu += e[S::PREC + i * D + j] * mu[j];
    mb[i] = mubar[i] + w * (pmu - e[S::PM + i]) + 0.5f * rhobar * ht[i];
  }
  float cmb[D];  // Σ̃μ̄
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) acc += C[i][j] * mb[j];
    cmb[i] = acc;
    hbar[i] = acc + 0.5f * rhobar * mu[i];
  }
  const float ldbar = 0.5f * w - 0.5f * rhobar;
  // X = Φ(Lᵀ L̄): lower triangle, diagonal halved.
  float X[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      float acc = 0.0f;
#pragma unroll
      for (int c = a; c < D; ++c) acc += L[c][a] * Lbar[c][b];
      X[a][b] = a == b ? 0.5f * acc : acc;
    }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    // (Σ̃ E[Λ] Σ̃)_ii and (L⁻ᵀ X L⁻¹)_ii.
    float cpc = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float pc = 0.0f;
#pragma unroll
      for (int b = 0; b < D; ++b) pc += e[S::PREC + a * D + b] * C[b][i];
      cpc += C[i][a] * pc;
    }
    float chol = 0.0f;
#pragma unroll
    for (int a = i; a < D; ++a)
#pragma unroll
      for (int b = i; b <= a; ++b) chol += Li[a][i] * X[a][b] * Li[b][i];
    jbar[i] = ldbar * C[i][i] - 0.5f * w * cpc - cmb[i] * mu[i] + chol;
  }
}

}  // namespace svax
