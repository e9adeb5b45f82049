// combine_bwd_full: the fused SIN combine's backward for every cotangent,
// dw (the expected parameters' cotangent) included.
//
// Replaces svax/ops/combine_pallas.py's _bwd_call (its two recompute
// kernels, pallas_call at :588 and :637) for the calls that pass the
// statistics' cotangent or need dw: the tests, svax_torch/measure_mnist.py
// and any caller whose expected parameters require grad (the train step
// runs combine_bwd.cu). As the reference does (:477-486), the backward is
// split by cotangent into two kernels whose input cotangents add, each
// recomputing the forward:
//   combine_bwd_sample: z̄, lr̄_out and μ̄_out (the samples never meet the
//     local KL or the statistics: ω = 0, Σ̄ = 0);
//   combine_bwd_local: local̄ and s̄ (no samples: L̄ = 0).
// The first writes dpot_h, dpot_p (and dn), the second adds to them; each
// writes one dw partial per block, and reduce_planes (combine.cu) adds the
// 2·blocks partials in a fixed order. G (lower triangle) and the dw row are
// those of svax_torch/ops/combine.py: combine_grads_manual:
//   G = log|J̃|‾ Σ̃ − sym(Σ̃μ̄ μ̃ᵀ) − Σ̃Σ̄Σ̃ + sym(L̃⁻ᵀΦ(L̃ᵀL̄)L̃⁻¹),
//   E[Λ]‾ += tril(2G, −1) + diag G + ½ω(Σ̃ + μ̃μ̃ᵀ), E[log π]‾ = ρ̄ − ω,
//   E[log|Λ|]‾ = ½(ρ̄ − ω), E[μᵀΛμ]‾ = ½(ω − ρ̄), E[Λμ]‾ = h̃̄ − ωμ̃;
// in the sampling half the Cholesky term is −Aᵀ P per sample with
// A_ai = L̃⁻¹_ai ε_a and P_aj = Σ_{j ≤ b < a} v_b L̃⁻¹_bj + ½ v_a L̃⁻¹_aj
// (combine_bwd.cu derives it), each of its entries (i, j) added to dw's
// lower slot (max, min) directly; in the local half Σ̃Σ̄Σ̃ is formed column
// by column from Σ̃ (packed, in registers) and Σ̄ = ½ω sym(E[Λ]) + r̃ sym(s̄₂)
// (packed, per pair, in the thread's column of shared memory).
//
// Bound: operations (~0.8 GFLOP at bigk, ~12 µs at the card's f32 rate).
// Design: combine_core.cuh's layout at most 128 / K rows a block; each
// thread adds its (n, k)'s dw row in row order into its own column of
// shared memory ((3 + d + d²) × threads floats), and the block sums its R
// rows in order into its partial. No spills: each half holds one packed
// triangle of L̃⁻¹ or Σ̃ (and Σ̄) and accumulates G into shared memory
// instead of registers. No atomics: reruns are bit-equal.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "combine_core.cuh"

namespace {

using svax::comb::BwdArgs;
using svax::comb::Planes;
using svax::comb::tidx;
using svax::comb::tri;

// The shared-memory bytes of both halves: the staged rows (with the
// statistics' cotangent's planes), log ρ, exp(log ρ − max), lr̄, [h̃̄,
// diag G], dw and (the local half) each thread's Σ̄.
template <int D>
size_t full_bytes(int k, int nt) {
  return sizeof(float) * (static_cast<size_t>(Planes<D>::COUNT_DS) * k +
                          static_cast<size_t>(nt) * (3 + 2 * D + Planes<D>::W + tri(D)));
}

// Per-block epilogue of one row group: dpot_h, dpot_p summed over k from
// s_pot (written, or with `add` added to what the other half wrote).
template <int D>
__device__ __forceinline__ void row_sums(const BwdArgs& a, const float* s_pot, int g, int R,
                                         int NT, bool add) {
  const int K = a.k;
  for (int idx = threadIdx.x; idx < R * 2 * D; idx += NT) {
    const int r2 = idx / (2 * D), col = idx % (2 * D), n2 = g * R + r2;
    if (n2 >= a.n) continue;
    float acc = 0.0f;
    for (int c2 = 0; c2 < K; ++c2) acc += s_pot[col * NT + r2 * K + c2];
    float* out = col < D ? a.dph + static_cast<size_t>(n2) * D + col
                         : a.dpp + static_cast<size_t>(n2) * D + col - D;
    *out = add ? *out + acc : acc;
  }
}

// This block's dw partial: each (slot, k) of s_acc summed over the R rows;
// thread (r, k) takes slots r, r + R, … of component k.
template <int D>
__device__ __forceinline__ void block_partial(const float* s_acc, float* out, int K, int R,
                                              int NT) {
  const int r = threadIdx.x / K, k = threadIdx.x % K;
  for (int f = r; f < Planes<D>::W; f += R) {
    float acc = 0.0f;
    for (int r2 = 0; r2 < R; ++r2) acc += s_acc[f * NT + r2 * K + k];
    out[f * K + k] = acc;
  }
}

// The sampling half: cotangents of z, log r̃ and μ̃.
template <int D, bool kNorm>
__global__ void __launch_bounds__(svax::comb::kFullThreads, 1) combine_bwd_sample(BwdArgs a) {
  namespace c = svax::comb;
  using P = Planes<D>;
  constexpr int T = tri(D), PREC = 3 + D;
  const int K = a.k, R = a.rows, NT = R * K;
  const int tid = threadIdx.x, r = tid / K, k = tid % K;
  extern __shared__ float smem[];
  float* s_w = smem;                    // (P::COUNT_DS, K)
  float* s_rho = s_w + P::COUNT_DS * K;  // (NT)
  float* s_ex = s_rho + NT;              // (NT)
  float* s_lrb = s_ex + NT;              // (NT)
  float* s_pot = s_lrb + NT;             // (2D, NT)
  float* s_acc = s_pot + 2 * D * NT;     // (W, NT) dw terms
  const bool dw = a.partial != nullptr;
  c::stage<D>(a.w, nullptr, K, s_w);
  for (int f = 0; f < P::W; ++f) s_acc[f * NT + tid] = 0.0f;
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
    c::invert<D>(L);  // L̃⁻¹

    const size_t nk = static_cast<size_t>(n) * K + k;
    const float lrbar = (valid && a.dlr) ? a.dlr[nk] : 0.0f;
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

    float mb[D], mdiag[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      mb[i] = 0.5f * rhobar * ht[i] + ((valid && a.dmu) ? a.dmu[nk * D + i] : 0.0f);
      mdiag[i] = 0.0f;
    }
    if (valid && a.dz) {
      for (int s = 0; s < a.s; ++s) {
        const size_t base = ((static_cast<size_t>(s) * a.n + n) * K + k) * D;
        float ev[D], v[D];
        c::noise<D>(a.eps, a.word, base, ev);
#pragma unroll
        for (int i = 0; i < D; ++i) mb[i] += a.dz[base + i];
#pragma unroll
        for (int i = 0; i < D; ++i) {  // v = L̃⁻¹z̄
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j <= i; ++j) acc += L[tidx(i, j)] * a.dz[base + j];
          v[i] = acc;
        }
        // M = −Aᵀ P column by column: M_ij to dw's slot (max(i, j), min(i, j)).
#pragma unroll
        for (int j = 0; j < D; ++j) {
          c::no_hoist();
          float pj[D];
          float pre = 0.0f;
#pragma unroll
          for (int m = j; m < D; ++m) {
            const float y = L[tidx(m, j)];
            pj[m] = pre + 0.5f * v[m] * y;
            pre += v[m] * y;
          }
#pragma unroll
          for (int i = 0; i < D; ++i) {
            const int lo = i > j ? i : j;
            float m_ij = 0.0f;
#pragma unroll
            for (int m = 0; m < D; ++m)
              if (m >= lo) m_ij -= L[tidx(m, i)] * ev[m] * pj[m];
            if (i == j) mdiag[i] += m_ij;
            if (dw) {
              const int slot = PREC + (i > j ? i * D + j : j * D + i);
              s_acc[slot * NT + tid] += m_ij;
            }
          }
        }
      }
    }

    // Σ̃μ̄, h̃̄ and the rest of G: log|J̃|‾Σ̃ − sym(Σ̃μ̄ μ̃ᵀ) (ω = 0).
    float t[D], cmb[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j <= i; ++j) acc += L[tidx(i, j)] * mb[j];
      t[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int m = i; m < D; ++m) acc += L[tidx(m, i)] * t[m];
      cmb[i] = acc;
    }
    const float ldbar = -0.5f * rhobar;
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const float gv = ldbar * c::cov<D>(L, i, j) - 0.5f * (cmb[i] * mu[j] + cmb[j] * mu[i]);
        if (i == j) s_pot[(D + i) * NT + tid] = gv + mdiag[i];
        if (dw && valid) s_acc[(PREC + i * D + j) * NT + tid] += i == j ? gv : 2.0f * gv;
      }
      const float htb = cmb[i] + 0.5f * rhobar * mu[i];
      s_pot[i * NT + tid] = htb;
      if (dw && valid) s_acc[(3 + i) * NT + tid] += htb;
    }
    if (dw && valid) {
      s_acc[tid] += rhobar;
      s_acc[NT + tid] += 0.5f * rhobar;
      s_acc[2 * NT + tid] += -0.5f * rhobar;
    }
    __syncthreads();
    row_sums<D>(a, s_pot, g, R, NT, false);
  }
  if (!dw) return;
  __syncthreads();
  block_partial<D>(s_acc, a.partial + static_cast<size_t>(blockIdx.x) * P::W * K, K, R, NT);
}

// The local/statistics half: cotangents of the local row and the
// statistics.
template <int D, bool kNorm>
__global__ void __launch_bounds__(svax::comb::kFullThreads, 1) combine_bwd_local(BwdArgs a) {
  namespace c = svax::comb;
  using P = Planes<D>;
  constexpr int T = tri(D), PREC = 3 + D;
  const int K = a.k, R = a.rows, NT = R * K;
  const int tid = threadIdx.x, r = tid / K, k = tid % K;
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_rho = s_w + P::COUNT_DS * K;
  float* s_ex = s_rho + NT;
  float* s_lrb = s_ex + NT;
  float* s_pot = s_lrb + NT;
  float* s_acc = s_pot + 2 * D * NT;
  float* s_sig = s_acc + P::W * NT;  // (T, NT) Σ̄, packed
  const bool dw = a.partial != nullptr;
  c::stage<D>(a.w, a.dstats, K, s_w);
  for (int f = 0; f < P::W; ++f) s_acc[f * NT + tid] = 0.0f;
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
    c::invert<D>(L);
    const float a_rest = c::local_rest<D>(s_w, K, k, L, mu, logdet_j);
    float C[T];  // Σ̃ (packed); L̃⁻¹ is not needed past this
#pragma unroll
    for (int i = 0; i < D; ++i) {
      c::no_hoist();
#pragma unroll
      for (int j = 0; j <= i; ++j) C[tidx(i, j)] = c::cov<D>(L, i, j);
    }

    const bool has_ds = valid && a.dstats;
    const float lb = (valid && a.dlocal) ? a.dlocal[n] : 0.0f;
    const float omega = lb * resp;
    float rbar = lb * (log_resp + a_rest);
    if (has_ds) {
      rbar += s_w[P::DS0 * K + k];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        c::no_hoist();
        rbar += s_w[(P::DS1 + i) * K + k] * mu[i];
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          const float q = s_w[(P::DS2 + tidx(i, j)) * K + k];
          rbar += (i == j ? q : 2.0f * q) * (C[tidx(i, j)] + mu[i] * mu[j]);
        }
      }
    }
    const float lrbar = omega + rbar * resp;
    s_lrb[tid] = lrbar;
    __syncthreads();
    float lsum = 0.0f;
    for (int c2 = 0; c2 < K; ++c2) lsum += s_lrb[r * K + c2];
    float rhobar = lrbar;
    if constexpr (kNorm) {
      if (valid && k == 0) a.dn[n] -= lsum;
    } else {
      rhobar = lrbar - resp * lsum;
    }

    // μ̄ and Σ̄ = ½ω sym(E[Λ]) + r̃ sym(s̄₂) (packed).
    float mb[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      c::no_hoist();
      float sp = 0.0f, dp = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        sp += c::esym<D>(s_w, K, k, i, j) * mu[j];
        if (has_ds) dp += s_w[(P::DS2 + (i >= j ? tidx(i, j) : tidx(j, i))) * K + k] * mu[j];
      }
      mb[i] = omega * (sp - s_w[(P::PM + i) * K + k]) + 0.5f * rhobar * ht[i];
      if (has_ds) mb[i] += resp * (s_w[(P::DS1 + i) * K + k] + 2.0f * dp);
#pragma unroll
      for (int j = 0; j <= i; ++j)
        s_sig[tidx(i, j) * NT + tid] =
            0.5f * omega * s_w[(P::ES + tidx(i, j)) * K + k] +
            (has_ds ? resp * s_w[(P::DS2 + tidx(i, j)) * K + k] : 0.0f);
    }
    float cmb[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      c::no_hoist();
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) acc += C[i >= j ? tidx(i, j) : tidx(j, i)] * mb[j];
      cmb[i] = acc;
    }
    const float ldbar = 0.5f * omega - 0.5f * rhobar;
    // G column by column: (Σ̃Σ̄Σ̃)_ij = Σ̃_iᵀ (Σ̄ Σ̃_j).
#pragma unroll
    for (int j = 0; j < D; ++j) {
      c::no_hoist();
      float tj[D];
#pragma unroll
      for (int a2 = 0; a2 < D; ++a2) {
        float acc = 0.0f;
#pragma unroll
        for (int b = 0; b < D; ++b)
          acc += s_sig[(a2 >= b ? tidx(a2, b) : tidx(b, a2)) * NT + tid] *
                 C[b >= j ? tidx(b, j) : tidx(j, b)];
        tj[a2] = acc;
      }
#pragma unroll
      for (int i = j; i < D; ++i) {
        float cpc = 0.0f;
#pragma unroll
        for (int a2 = 0; a2 < D; ++a2) cpc += C[i >= a2 ? tidx(i, a2) : tidx(a2, i)] * tj[a2];
        const float gv = ldbar * C[tidx(i, j)] - 0.5f * (cmb[i] * mu[j] + cmb[j] * mu[i]) - cpc;
        if (i == j) s_pot[(D + i) * NT + tid] = gv;
        if (dw && valid) {
          const float ez = 0.5f * omega * (C[tidx(i, j)] + mu[i] * mu[j]);
          s_acc[(PREC + i * D + j) * NT + tid] += (i == j ? gv : 2.0f * gv) + ez;
          if (i != j) s_acc[(PREC + j * D + i) * NT + tid] += ez;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float htb = cmb[i] + 0.5f * rhobar * mu[i];
      s_pot[i * NT + tid] = htb;
      if (dw && valid) s_acc[(3 + i) * NT + tid] += htb - omega * mu[i];
    }
    if (dw && valid) {
      s_acc[tid] += rhobar - omega;
      s_acc[NT + tid] += 0.5f * (rhobar - omega);
      s_acc[2 * NT + tid] += 0.5f * (omega - rhobar);
    }
    __syncthreads();
    row_sums<D>(a, s_pot, g, R, NT, true);
  }
  if (!dw) return;
  __syncthreads();
  block_partial<D>(s_acc,
                   a.partial + (static_cast<size_t>(a.blocks) + blockIdx.x) * P::W * a.k, K,
                   R, NT);
}

// Both halves' plan for N, K: rows a block and one grid (the smaller of
// their capacities).
template <int D, bool kNorm>
cudaError_t plan_d(int n, int k, int& rows, int& blocks) {
  namespace c = svax::comb;
  static c::LaunchCache cache_s, cache_l;
  int sms = 0, cap_s = 0, cap_l = 0;
  cudaError_t err = c::sm_count(sms);
  if (err != cudaSuccess) return err;
  rows = c::rows_per_block(n, k, c::kFullThreads, sms);
  const size_t bytes = full_bytes<D>(k, rows * k);
  err = c::capacity(combine_bwd_sample<D, kNorm>, k, rows, bytes, sms, cache_s, cap_s);
  if (err != cudaSuccess) return err;
  err = c::capacity(combine_bwd_local<D, kNorm>, k, rows, bytes, sms, cache_l, cap_l);
  if (err != cudaSuccess) return err;
  const int groups = c::row_groups(n, rows);
  const int cap = cap_s < cap_l ? cap_s : cap_l;
  blocks = groups < cap ? groups : cap;
  return cudaSuccess;
}

template <int D, bool kNorm>
cudaError_t full_d(BwdArgs a, float* dw, cudaStream_t st) {
  namespace c = svax::comb;
  cudaError_t err = plan_d<D, kNorm>(a.n, a.k, a.rows, a.blocks);
  if (err != cudaSuccess) return err;
  a.groups = c::row_groups(a.n, a.rows);
  const int threads = a.rows * a.k;
  const size_t bytes = full_bytes<D>(a.k, threads);
  combine_bwd_sample<D, kNorm><<<a.blocks, threads, bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  combine_bwd_local<D, kNorm><<<a.blocks, threads, bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || !a.partial) return err;
  return c::launch_reduce(a.partial, 2 * a.blocks, Planes<D>::W, a.k, D, c::ReduceOut::kPlanes,
                         dw, st);
}

}  // namespace

cudaError_t svax::comb::backward_full(BwdArgs a, int d, float* dw, cudaStream_t st) {
#define SVAX_FULL(D) (a.norm ? full_d<D, true>(a, dw, st) : full_d<D, false>(a, dw, st))
  switch (d) {
    case 2: return SVAX_FULL(2);
    case 3: return SVAX_FULL(3);
    case 4: return SVAX_FULL(4);
    case 6: return SVAX_FULL(6);
    case 8: return SVAX_FULL(8);
    case 10: return SVAX_FULL(10);
    default: return cudaErrorInvalidValue;
  }
#undef SVAX_FULL
}

cudaError_t svax::comb::full_grid(int n, int k, int d, bool norm, int& blocks) {
  int rows = 0;
#define SVAX_GRID(D) \
  (norm ? plan_d<D, true>(n, k, rows, blocks) : plan_d<D, false>(n, k, rows, blocks))
  switch (d) {
    case 2: return SVAX_GRID(2);
    case 3: return SVAX_GRID(3);
    case 4: return SVAX_GRID(4);
    case 6: return SVAX_GRID(6);
    case 8: return SVAX_GRID(8);
    case 10: return SVAX_GRID(10);
    default: return cudaErrorInvalidValue;
  }
#undef SVAX_GRID
}
