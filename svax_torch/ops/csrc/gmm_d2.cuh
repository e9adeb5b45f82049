// Expected GMM parameters at d = 2 in closed form, from the (K, 9) packed
// naturals (svax_torch/ops/tinystep.py: pack_nat's layout — dir, η₁(2),
// η₂, η₃(2×2 row-major), η₄). Shared by the tinystep and mixstep kernels;
// the PyTorch version is svax_torch/ops/tinystep.py: expected_cols.
#pragma once

namespace svax {

constexpr float kLog2 = 0.6931471805599453f;

// Expected-parameter slots per component.
enum ExpSlot { E_LOGPI, E_P11, E_P12, E_P22, E_PM1, E_PM2, E_QUAD, E_LOGDET, NUM_EXP };

// ψ(x), x > 0: 8-step recurrence into the asymptotic series (CUDA has no
// digamma; tinystep_pallas._digamma's recipe, ~1e-9 accurate).
__device__ inline float digammaf(float x) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc += 1.0f / (x + static_cast<float>(i));
  const float y = x + 8.0f;
  const float inv = 1.0f / y;
  const float inv2 = inv * inv;
  return logf(y) - 0.5f * inv -
         inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 / 252.0f)) - acc;
}

// e[0..NUM_EXP) ← E[log π_k], E[Λ_k] (3), E[Λ_k μ_k] (2), E[μ_kᵀΛ_k μ_k],
// E[log|Λ_k|] for component k of the K packed naturals in `nat`. The
// Dirichlet total Σα is summed over all K in index order.
__device__ inline void expected_d2(const float* nat, int K, int k, float* e) {
  const float* nt = nat + k * 9;
  float sum_alpha = 0.0f;
  for (int j = 0; j < K; ++j) sum_alpha += nat[j * 9] + 1.0f;
  const float alpha = nt[0] + 1.0f;
  const float kappa = nt[3];
  const float m1 = nt[1] / kappa, m2 = nt[2] / kappa;
  const float phi11 = nt[4] - kappa * m1 * m1;
  const float phi12 = nt[5] - kappa * m1 * m2;
  const float phi22 = nt[7] - kappa * m2 * m2;
  const float nu = nt[8] - 4.0f;  // η₄ = ν + d + 2
  const float det = phi11 * phi22 - phi12 * phi12;
  const float i11 = phi22 / det, i12 = -phi12 / det, i22 = phi11 / det;
  const float pim1 = i11 * m1 + i12 * m2, pim2 = i12 * m1 + i22 * m2;
  e[E_LOGPI] = digammaf(alpha) - digammaf(sum_alpha);
  e[E_P11] = nu * i11;
  e[E_P12] = nu * i12;
  e[E_P22] = nu * i22;
  e[E_PM1] = nu * pim1;
  e[E_PM2] = nu * pim2;
  e[E_QUAD] = 2.0f / kappa + nu * (m1 * pim1 + m2 * pim2);
  e[E_LOGDET] = digammaf(nu / 2.0f) + digammaf((nu - 1.0f) / 2.0f) +
                2.0f * kLog2 - logf(det);
}

}  // namespace svax
