// combine: the fused SIN combine's forward, the cross-block sums and the
// component-parallel ρ-kernels; the C entries of the combine.
//
// Replaces the TPU kernels of svax/ops/combine_pallas.py: _fwd_call
// (pallas_call at :431; combine_fwd here) and _bwd_call's two recompute
// kernels (:588, :637; combine_bwd.cu and combine_bwd_full.cu), entry
// combine_fused (:754). Per (n, k), with no N·K·d·d tensor in device
// memory: J̃ = diag(Pₙ) + E[Λ_k] → L̃ = chol(J̃) → μ̃, log|J̃| → log ρ →
// softmax over K → z = μ̃ + L̃⁻ᵀε (S samples) → L̃⁻¹ → the local-KL row →
// the (K, 1 + d + d²) statistics Σ_n r̃·[1, μ̃, Σ̃ + μ̃μ̃ᵀ] (Σ̃ = L̃⁻ᵀL̃⁻¹).
// z, log r̃ and μ̃ are computed in combine_tile.cuh's order (tile_core,
// solve_upper), so their bits do not depend on this kernel's layout.
//
// Bound: at bigk (N = 1024, K = 100, d = 10, S = 1) the forward writes z,
// μ̃ (4.1 MB each) and log r̃ (0.4 MB) and does ~0.2 GFLOP: a few µs either
// way; at mnist (N = 256, K = 10, d = 8) the work is ~100 KB and the kernel
// is latency-bound: one dependent chain of ~d³ operations per thread.
// Design (combine_core.cuh): one thread per (n, k) on packed triangles (L̃,
// then L̃⁻¹ in place; Σ̃ formed entry by entry), no spills at any d; the
// component rows staged once per block, k-minor; R rows of K a block (at
// most 256 / K; the softmax over K in shared memory; rows_per_block); the
// row groups dealt to a grid of
// the card's capacity in contiguous runs, so each block adds its rows'
// statistics (the lower triangle only: Σ̃ + μ̃μ̃ᵀ is symmetric) in row
// order into per-thread sums in shared memory and writes one (1 + d +
// d(d+1)/2, K) partial; reduce_planes adds the partials in a fixed
// two-level order and mirrors the triangle. No float atomics: reruns are
// bit-equal. ε comes from the caller, or from Philox4x32-10 + Box–Muller
// (philox.cuh) keyed (seed, step) and counted by ((s·N + n)·K + k)·d + i,
// so the backward regenerates the forward's numbers whatever the tiling.
// The key is read from a device word {seed, step}, not passed by value, so
// that a CUDA graph replaying the train step draws each step's own ε.
//
// Component parallelism (log_rho_fused, combine_pallas.py:722, and
// combine_fused's log_norm mode, _tile_core's norm=): with the mixture's K
// sharded over ranks, the softmax over K spans the shards. log_rho_fwd
// (replaces _rho_fwd_call's pallas_call, :288) writes this shard's
// pre-softmax log ρ (N, K); the caller takes the logsumexp across shards;
// combine_fwd<D, true> then reads that normaliser (N,) in place of its
// in-block softmax (log r̃ = log ρ − norm[n]), and the backwards drop the
// softmax Jacobian (ρ̄ = lr̄) and write the normaliser's cotangent dn[n] =
// −Σ_k lr̄ (_fused_core_bwd's extra output, :682-697), which flows back
// through the lse into log_rho_bwd (replaces _rho_bwd_call's pallas_call,
// :342): per (n, k), log ρ = E[log π] + ½E[log|Λ|] − ½E[μᵀΛμ] + ½μ̃ᵀh̃ −
// ½log|J̃| gives h̃̄ = ρ̄μ̃ and the symmetric derivative in J̃, G = −½ρ̄(Σ̃ +
// μ̃μ̃ᵀ), read back through the Cholesky's lower triangle. Both ρ-kernels
// run on combine_core.cuh's layout (the combine's: one thread per (n, k),
// packed triangles, R rows of K a block dealt to the card's capacity in
// contiguous runs, two blocks an SM), with w's rows copied to shared memory
// as they lie (no index arithmetic; the odd row length keeps a warp's reads
// on distinct banks), since neither needs a symmetrised E[Λ]. log_rho_fwd
// takes the copy from the copy engine (one TMA bulk copy a block, issued by
// one thread), its potentials by cp.async into shared memory (held in
// registers across the chain, they spilled at d = 10), and divides in the
// solves (recompute<D, kDivide>, the combine forward's arithmetic): its log
// ρ equals combine_fwd<D, true>'s log r̃ at a zero normaliser bit for bit.
// Bound: operations (~30 MFLOP at the bigk shard): under a µs; the time is
// the copy's latency and the SM's issue rate over the chain's ~1.4K
// instructions a thread (divisions, square roots and logarithms to IEEE
// rounding) on the SMs that hold two blocks.
// log_rho_bwd copies w with the block's threads (16-byte loads) and takes μ̃
// by recompute's products with the Cholesky's reciprocals, L̃⁻¹ packed and
// inverted in place. The train step's
// call owes no dw (the expected parameters are constants of the step), so
// it forms only h̃̄ and diag G — diag Σ̃ as the column sums of squares of
// L̃⁻¹, no full Σ̃ — and adds dpot_h, dpot_p over k in order in shared
// memory: one launch. With dw each block also writes one partial of 1 + d
// + d(d+1)/2 planes ([ρ̄, ρ̄μ̃, G's lower triangle]: the three scalar
// columns of dw are ±½ or 1 times Σρ̄), which reduce_planes adds in its
// fixed two-level order and expands into dw's (K, 3 + d + d²) row. Bound:
// operations (~50 MFLOP for the train step's call, ~80 with dw, at the
// bigk shard N = 1024, K = 50, d = 10): about a µs; the time is one
// thread's dependent Cholesky and inversion chain.
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "combine_core.cuh"
#include "phase_clock.cuh"

namespace {

using svax::comb::BwdArgs;
using svax::comb::FwdArgs;
using svax::comb::Planes;
using svax::comb::tidx;
using svax::comb::tri;

template <int D, bool kNorm>
__global__ void __launch_bounds__(svax::comb::kBlockThreads, 1) combine_fwd(FwdArgs a) {
  namespace c = svax::comb;
  using P = Planes<D>;
  constexpr int T = tri(D), FP = 1 + D + T;
  const int K = a.k, R = a.rows, NT = R * K;
  const int tid = threadIdx.x, r = tid / K, k = tid % K;
  extern __shared__ float smem[];
  float* s_w = smem;                 // (P::COUNT, K) the component rows
  float* s_rho = s_w + P::COUNT * K;  // (NT) log ρ
  float* s_ex = s_rho + NT;           // (NT) exp(log ρ − the row's max)
  float* s_loc = s_ex + NT;           // (NT) local-KL terms
  float* s_acc = s_loc + NT;          // (FP, NT) this thread's statistics
  c::stage<D>(a.w, nullptr, K, s_w);
#pragma unroll
  for (int f = 0; f < FP; ++f) s_acc[f * NT + tid] = 0.0f;
  __syncthreads();

  const int g1 = c::run_begin(blockIdx.x + 1, a.groups, a.blocks);
  for (int g = c::run_begin(blockIdx.x, a.groups, a.blocks); g < g1; ++g) {
    const int n = g * R + r;
    const bool valid = n < a.n;
    float p[D], h[D];
    c::load_row<D>(a.ph, a.pp, n, valid, p, h);
    float L[T], ht[D], mu[D], logdet_j, log_rho;
    c::recompute<D, true>(s_w, K, k, p, h, L, ht, mu, logdet_j, log_rho);
    float log_resp, resp;
    c::responsibility<kNorm>(s_rho, s_ex, K, r, a.norm, n, valid, log_rho, log_resp, resp);

    const size_t nk = static_cast<size_t>(n) * K + k;
    if (valid) {
      a.log_resp[nk] = log_resp;
#pragma unroll
      for (int i = 0; i < D; ++i) a.mean[nk * D + i] = mu[i];
      for (int s = 0; s < a.s; ++s) {
        const size_t base = ((static_cast<size_t>(s) * a.n + n) * K + k) * D;
        float ev[D], u[D];  // u = L̃⁻ᵀε by back substitution (solve_upper's order)
        c::noise<D>(a.eps, a.word, base, ev);
#pragma unroll
        for (int i = D - 1; i >= 0; --i) {
          float acc = ev[i];
#pragma unroll
          for (int j = i + 1; j < D; ++j) acc -= L[tidx(j, i)] * u[j];
          u[i] = acc / L[tidx(i, i)];
          a.z[base + i] = mu[i] + u[i];
        }
      }
    }
    c::invert<D>(L);  // L holds L̃⁻¹ from here

    // The local-KL term and the statistics r̃·[1, μ̃, Σ̃ + μ̃μ̃ᵀ], Σ̃ + μ̃μ̃ᵀ
    // formed once per entry of its lower triangle for both.
    const float rr = valid ? resp : 0.0f;
    float cross = 0.0f, trq = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      c::no_hoist();
      cross += s_w[(P::PM + i) * K + k] * mu[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const float ez = c::cov<D>(L, i, j) + mu[i] * mu[j];
        const float e = s_w[(P::ES + tidx(i, j)) * K + k];
        trq += (i == j ? e : 2.0f * e) * ez;
        if (valid) s_acc[(1 + D + tidx(i, j)) * NT + tid] += rr * ez;
      }
    }
    if (valid) {
      s_acc[tid] += rr;
#pragma unroll
      for (int i = 0; i < D; ++i) s_acc[(1 + i) * NT + tid] += rr * mu[i];
    }
    const float gk = 0.5f * s_w[P::LOGDET * K + k] - 0.5f * D * c::kLog2Pi -
                     0.5f * s_w[P::QUAD * K + k];
    const float e_log_pbar = s_w[P::LOGPI * K + k] + gk + cross - 0.5f * trq;
    const float a_nk = log_resp - 0.5f * D * (1.0f + c::kLog2Pi) + 0.5f * logdet_j - e_log_pbar;
    s_loc[tid] = rr * a_nk;
    __syncthreads();
    if (valid && k == 0) {
      float acc = 0.0f;
      for (int c2 = 0; c2 < K; ++c2) acc += s_loc[r * K + c2];
      a.local[n] = acc;
    }
  }
  __syncthreads();
  // This block's partial: each (plane, k) summed over the R rows in order;
  // thread (r, k) takes planes r, r + R, … of component k.
  float* out = a.partial + static_cast<size_t>(blockIdx.x) * FP * K;
  for (int f = r; f < FP; f += R) {
    float acc = 0.0f;
    for (int r2 = 0; r2 < R; ++r2) acc += s_acc[f * NT + r2 * K + k];
    out[f * K + k] = acc;
  }
}

constexpr int kReduceLanes = 32, kReduceGroups = 16;

// out = Σ_b partial[b] over `blocks` partials of `planes` × K floats: lane
// e of each of kReduceGroups warps adds its contiguous run of partials in
// order, then warp 0 adds the groups in order, and writes the sum in the
// layout `layout` (comb::ReduceOut): kPlanes (K, planes); kStats, the
// forward's packed planes [count, μ̃ (d), lower triangle] → raw (K, 1 + d +
// d²), the triangle written to both halves; kRhoDw, the ρ-backward's [Σρ̄,
// Σρ̄μ̃ (d), G's lower triangle] → dw (K, 3 + d + d²): [Σρ̄, ½Σρ̄, −½Σρ̄,
// Σρ̄μ̃, E[Λ]'s cotangent as the Cholesky reads E[Λ]: 2G below the
// diagonal, G on it, 0 above] (each factor a power of two, so the scaled
// sums are the sums of the scaled terms).
__global__ void __launch_bounds__(kReduceLanes* kReduceGroups)
    reduce_planes(const float* __restrict__ partial, int blocks, int planes, int k, int d,
                  int layout, float* out) {
  using svax::comb::ReduceOut;
  extern __shared__ float smem[];  // (kReduceGroups, kReduceLanes) the runs' sums
  const int lane = threadIdx.x % kReduceLanes, grp = threadIdx.x / kReduceLanes;
  const int len = planes * k, e = blockIdx.x * kReduceLanes + lane;
  float acc = 0.0f;
  if (e < len) {
    const int b1 = svax::comb::run_begin(grp + 1, blocks, kReduceGroups);
    for (int b = svax::comb::run_begin(grp, blocks, kReduceGroups); b < b1; ++b)
      acc += partial[static_cast<size_t>(b) * len + e];
  }
  smem[grp * kReduceLanes + lane] = acc;
  __syncthreads();
  if (grp != 0 || e >= len) return;
  float s = 0.0f;
  for (int g = 0; g < kReduceGroups; ++g) s += smem[g * kReduceLanes + lane];
  const int pl = e / k, kk = e % k;
  if (layout == static_cast<int>(ReduceOut::kPlanes)) {
    out[static_cast<size_t>(kk) * planes + pl] = s;
    return;
  }
  const int head = layout == static_cast<int>(ReduceOut::kStats) ? 1 : 3;
  float* row = out + static_cast<size_t>(kk) * (head + d + d * d);
  if (pl == 0 && head == 3) {
    row[0] = s;
    row[1] = 0.5f * s;
    row[2] = -0.5f * s;
  } else if (pl < 1 + d) {
    row[head - 1 + pl] = s;
  } else {
    int i, j;
    svax::comb::untri(pl - 1 - d, i, j);
    if (head == 1) {
      row[1 + d + i * d + j] = s;
      row[1 + d + j * d + i] = s;
    } else {
      row[3 + d + i * d + j] = i == j ? s : 2.0f * s;
      if (i != j) row[3 + d + j * d + i] = 0.0f;
    }
  }
}

template <int D>
size_t fwd_bytes(int k, int nt) {
  return sizeof(float) * (static_cast<size_t>(Planes<D>::COUNT) * k +
                          static_cast<size_t>(nt) * (3 + 1 + D + tri(D)));
}

// The forward's plan for N, K: rows a block and the grid.
template <int D, bool kNorm>
cudaError_t forward_plan(int n, int k, int& rows, int& blocks) {
  namespace c = svax::comb;
  static c::LaunchCache cache;
  int sms = 0, cap = 0;
  cudaError_t err = c::sm_count(sms);
  if (err != cudaSuccess) return err;
  rows = c::rows_per_block(n, k, c::kBlockThreads, sms);
  err = c::capacity(combine_fwd<D, kNorm>, k, rows, fwd_bytes<D>(k, rows * k), sms, cache, cap);
  if (err != cudaSuccess) return err;
  const int groups = c::row_groups(n, rows);
  blocks = groups < cap ? groups : cap;
  return cudaSuccess;
}

template <int D, bool kNorm>
cudaError_t forward_d(FwdArgs a, float* stats, cudaStream_t st) {
  namespace c = svax::comb;
  cudaError_t err = forward_plan<D, kNorm>(a.n, a.k, a.rows, a.blocks);
  if (err != cudaSuccess) return err;
  a.groups = c::row_groups(a.n, a.rows);
  const int threads = a.rows * a.k;
  combine_fwd<D, kNorm><<<a.blocks, threads, fwd_bytes<D>(a.k, threads), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return c::launch_reduce(a.partial, a.blocks, 1 + D + tri(D), a.k, D, c::ReduceOut::kStats,
                         stats, st);
}

// ---------------------------------------------------------- the ρ-kernels

using namespace svax;

struct RhoArgs {
  const float* __restrict__ ph;    // (N, D)
  const float* __restrict__ pp;    // (N, D)
  const float* __restrict__ w;     // (K, 3 + D + D²)
  const float* __restrict__ drho;  // (N, K) cotangent (backward only)
  int n, k;
  float* log_rho;  // (N, K) (forward)
  float* dph;      // (N, D) (backward)
  float* dpp;      // (N, D)
  float* partial;  // (blocks, 1 + D + D(D+1)/2, K) or null: no dw
  int rows, groups, blocks;  // rows a block, row groups and the grid
};

// log ρ per (n, k) on combine_core.cuh's plan: thread (r, k) of R rows of
// K; the row groups dealt to the blocks in contiguous runs. w's rows are
// copied to shared memory as they lie — one bulk copy by the copy engine,
// its tail of at most three floats by threads; faster than the block's
// threads copying it (copy_rows) or each thread reading its row from device
// memory, and than one copy a cluster multicast to its CTAs (PERF.md §6)
// — and read at the odd row stride; each row group's potentials are
// copied to shared memory by cp.async, the next group's while this one's
// chain runs (no registers held across the chain). recompute<D, kDivide>
// divides in the solves as combine_fwd does, so log ρ carries the
// combine's bits; the stores of a row group are consecutive. No sums: one
// launch, no atomics.
template <int D>
__global__ void __launch_bounds__(comb::kBlockThreads, 2) log_rho_fwd(RhoArgs a) {
  namespace c = svax::comb;
  using P = c::Planes<D>;
  const int K = a.k, R = a.rows, tid = threadIdx.x, r = tid / K, k = tid % K;
  const int count = K * P::W, body = c::bulk_body(count), pad = (count + 3) & ~3;
  extern __shared__ __align__(16) float rho_smem[];  // w's rows, the barrier, the potentials
  uint64_t* bar = reinterpret_cast<uint64_t*>(rho_smem + pad);
  float* s_pot = rho_smem + pad + 4;  // (2, R, 2D): two row groups' [h, p]
  PHASE_START;
  int g = c::run_begin(blockIdx.x, a.groups, a.blocks);
  const int g1 = c::run_begin(blockIdx.x + 1, a.groups, a.blocks);
  if (tid == 0) {
    c::bar_init(bar, 1);
    c::bar_expect(bar, 4u * body);
    c::bulk_copy(rho_smem, a.w, 4u * body, bar);
  }
  for (int e = body + tid; e < count; e += blockDim.x) rho_smem[e] = a.w[e];
  if (g < g1) c::stage_potentials<D>(a.ph, a.pp, a.n, g * R, R, s_pot);
  c::cp_async_wait_all();
  __syncthreads();
  c::bar_wait(bar, 0);
  PHASE_MARK(16);

  for (int it = 0; g < g1; ++g, ++it) {
    const float* row = s_pot + ((it & 1) * R + r) * 2 * D;
    if (g + 1 < g1)
      c::stage_potentials<D>(a.ph, a.pp, a.n, (g + 1) * R, R, s_pot + ((it + 1) & 1) * R * 2 * D);
    float p[D], h[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      h[i] = row[i];
      p[i] = row[D + i];
    }
    const int n = g * R + r;
    float L[c::tri(D)], ht[D], mu[D], logdet_j, log_rho;
    c::recompute<D, true, true>(rho_smem, K, k, p, h, L, ht, mu, logdet_j, log_rho);
    PHASE_MARK(17);
    if (n < a.n) a.log_rho[static_cast<size_t>(n) * K + k] = log_rho;
    c::cp_async_wait_all();
    __syncthreads();
    PHASE_MARK(18);
  }
}

template <int D, bool kDw>
__global__ void __launch_bounds__(comb::kBlockThreads, kDw ? 1 : 2) log_rho_bwd(RhoArgs a) {
  namespace c = svax::comb;
  using P = c::Planes<D>;
  constexpr int T = c::tri(D), FP = 1 + D + T;
  const int K = a.k, R = a.rows, NT = R * K, PS = NT | 1;
  const int tid = threadIdx.x, r = tid / K, k = tid % K;
  extern __shared__ float smem[];
  float* s_w = smem;                  // (K, P::W) w's rows as they lie
  float* s_pot = s_w + P::W * K;      // (2D, PS) h̃̄, diag G: an odd plane stride,
                                      // so the sums' lanes hit distinct banks
  float* s_acc = s_pot + 2 * D * PS;  // (FP, NT) kDw: this thread's dw terms
  PHASE_START;
  int g = c::run_begin(blockIdx.x, a.groups, a.blocks);
  const int g1 = c::run_begin(blockIdx.x + 1, a.groups, a.blocks);
  // The first row's potentials load while w is copied; each next row's
  // while this one's inverse and sums are formed.
  float p[D], h[D];
  c::load_row<D>(a.ph, a.pp, g * R + r, g * R + r < a.n, p, h);
  c::copy_rows(a.w, K * P::W, s_w);
  if constexpr (kDw) {
#pragma unroll
    for (int f = 0; f < FP; ++f) s_acc[f * NT + tid] = 0.0f;
  }
  __syncthreads();
  PHASE_MARK(0);

  for (; g < g1; ++g) {
    const int n = g * R + r;
    const bool valid = n < a.n;
    float L[T], ht[D], mu[D], dinv[D], logdet_j, log_rho;
    c::recompute<D, false, true>(s_w, K, k, p, h, L, ht, mu, logdet_j, log_rho, dinv);
    if (g + 1 < g1) c::load_row<D>(a.ph, a.pp, n + R, n + R < a.n, p, h);
    PHASE_MARK(1);
    c::invert<D>(L, dinv);  // L holds L̃⁻¹ from here
    // Rows past N read no cotangent: every term they add is zero.
    const float rb = valid ? a.drho[static_cast<size_t>(n) * K + k] : 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float cii = 0.0f;
#pragma unroll
      for (int m = i; m < D; ++m) cii += L[c::tidx(m, i)] * L[c::tidx(m, i)];
      s_pot[i * PS + tid] = rb * mu[i];
      s_pot[(D + i) * PS + tid] = -0.5f * rb * (cii + mu[i] * mu[i]);
    }
    if constexpr (kDw) {
      if (valid) {
        s_acc[tid] += rb;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          s_acc[(1 + i) * NT + tid] += rb * mu[i];
#pragma unroll
          for (int j = 0; j <= i; ++j)
            s_acc[(1 + D + c::tidx(i, j)) * NT + tid] +=
                -0.5f * rb * (c::cov<D>(L, i, j) + mu[i] * mu[j]);
        }
      }
    }
    PHASE_MARK(2);
    __syncthreads();
    PHASE_MARK(3);
    // dpot_h, dpot_p of the group's rows: each (row, column) summed over k
    // in order.
    for (int idx = tid; idx < R * 2 * D; idx += NT) {
      const int r2 = idx / (2 * D), col = idx % (2 * D), n2 = g * R + r2;
      if (n2 >= a.n) continue;
      float acc = 0.0f;
      for (int c2 = 0; c2 < K; ++c2) acc += s_pot[col * PS + r2 * K + c2];
      if (col < D)
        a.dph[static_cast<size_t>(n2) * D + col] = acc;
      else
        a.dpp[static_cast<size_t>(n2) * D + col - D] = acc;
    }
    __syncthreads();
    PHASE_MARK(4);
  }
  if constexpr (kDw) {
    // This block's partial: each (plane, k) summed over the R rows in order;
    // thread (r, k) takes planes r, r + R, … of component k.
    float* out = a.partial + static_cast<size_t>(blockIdx.x) * FP * K;
    for (int f = r; f < FP; f += R) {
      float acc = 0.0f;
      for (int r2 = 0; r2 < R; ++r2) acc += s_acc[f * NT + r2 * K + k];
      out[f * K + k] = acc;
    }
  }
}

template <int D, bool kDw>
size_t rho_bwd_bytes(int k, int nt) {
  return sizeof(float) * (static_cast<size_t>(comb::Planes<D>::W) * k +
                          static_cast<size_t>(nt | 1) * 2 * D +
                          static_cast<size_t>(nt) * (kDw ? 1 + D + comb::tri(D) : 0));
}

// log_rho_fwd's shared memory: w's rows padded to 16 bytes, its mbarrier
// (16 bytes), two row groups' potentials.
template <int D>
size_t rho_fwd_bytes(int k, int rows) {
  const size_t count = static_cast<size_t>(comb::Planes<D>::W) * k;
  return sizeof(float) * (((count + 3) & ~static_cast<size_t>(3)) + 4 + 4 * D * rows);
}

// The forward's plan and its one launch: R rows of K a block, the row
// groups dealt to the blocks that fit on the card at once.
template <int D>
cudaError_t rho_forward_d(RhoArgs a, cudaStream_t st) {
  static comb::LaunchCache cache;
  int sms = 0, cap = 0;
  cudaError_t err = comb::sm_count(sms);
  if (err != cudaSuccess) return err;
  if ((reinterpret_cast<uintptr_t>(a.w) & 15u) != 0)
    return cudaErrorMisalignedAddress;  // the bulk copy reads 16-byte pieces
  a.rows = comb::rows_per_block(a.n, a.k, comb::kBlockThreads, sms);
  a.groups = comb::row_groups(a.n, a.rows);
  const size_t bytes = rho_fwd_bytes<D>(a.k, a.rows);
  err = comb::capacity(log_rho_fwd<D>, a.k, a.rows, bytes, sms, cache, cap);
  if (err != cudaSuccess) return err;
  a.blocks = a.groups < cap ? a.groups : cap;
  log_rho_fwd<D><<<a.blocks, a.rows * a.k, bytes, st>>>(a);
  return cudaGetLastError();
}

// The backward's plan and launches: configuration (a) (no dw) is one launch;
// with dw, launch_reduce adds the partials and writes dw's (K, 3 + D + D²).
template <int D, bool kDw>
cudaError_t rho_backward_dw(RhoArgs a, float* dw, cudaStream_t st) {
  static comb::LaunchCache cache;
  int sms = 0, cap = 0;
  cudaError_t err = comb::sm_count(sms);
  if (err != cudaSuccess) return err;
  a.rows = comb::rows_per_block(a.n, a.k, comb::kBlockThreads, sms);
  const int threads = a.rows * a.k;
  const size_t bytes = rho_bwd_bytes<D, kDw>(a.k, threads);
  err = comb::capacity(log_rho_bwd<D, kDw>, a.k, a.rows, bytes, sms, cache, cap);
  if (err != cudaSuccess) return err;
  a.groups = comb::row_groups(a.n, a.rows);
  a.blocks = a.groups < cap ? a.groups : cap;
  log_rho_bwd<D, kDw><<<a.blocks, threads, bytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kDw) return err;
  return comb::launch_reduce(a.partial, a.blocks, 1 + D + comb::tri(D), a.k, D,
                             comb::ReduceOut::kRhoDw, dw, st);
}

template <int D>
cudaError_t rho_backward_d(const RhoArgs& a, float* dw, cudaStream_t st) {
  return a.partial ? rho_backward_dw<D, true>(a, dw, st) : rho_backward_dw<D, false>(a, dw, st);
}

bool shape_ok(int n, int k, int s) { return n >= 1 && k >= 1 && k <= comb::kMaxK && s >= 1; }

}  // namespace

// Phase clocks of the ρ-kernels (compiled in only with -DSVAX_PHASE_CLOCKS):
// log_rho_bwd's slots 0–4 — staging, the recompute, the inverse and the
// terms, the barrier's wait, the sums over k — and log_rho_fwd's 16–18 — the
// copy of w (with the first row's potentials), the chain (recompute and the
// next row's potentials), the store.
SVAX_PHASE_ENTRY(rho_phase_clocks)

cudaError_t svax::comb::launch_reduce(const float* partial, int blocks, int planes, int k, int d,
                                      ReduceOut layout, float* out, cudaStream_t st) {
  const int len = planes * k;
  reduce_planes<<<(len + kReduceLanes - 1) / kReduceLanes, kReduceLanes * kReduceGroups,
                  sizeof(float) * kReduceLanes * kReduceGroups, st>>>(
      partial, blocks, planes, k, d, static_cast<int>(layout), out);
  return cudaGetLastError();
}

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

// The combine's partial count for N points and K components at latent d:
// kind 0 the forward (softmax), 1 its log_norm mode — (blocks, 1 + d +
// d(d+1)/2, K) floats; 2 the backward with dw, 3 its log_norm mode — (2,
// blocks, 3 + d + d², K). Negative: a CUDA error code, negated.
int combine_grid(int n, int k, int d, int kind) {
  if (!shape_ok(n, k, 1) || kind < 0 || kind > 3) return -static_cast<int>(cudaErrorInvalidValue);
  int rows = 0, blocks = 0;
  cudaError_t err;
  if (kind >= 2) {
    err = comb::full_grid(n, k, d, kind == 3, blocks);
  } else {
#define SVAX_CALL(D) \
  (kind ? forward_plan<D, true>(n, k, rows, blocks) : forward_plan<D, false>(n, k, rows, blocks))
    SVAX_BY_DIM(d, err, SVAX_CALL)
#undef SVAX_CALL
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The ρ-kernels' blocks for N points and K components: at least the
// backward's grid at any d, so rho_backward's partial fits in
// rho_blocks(n, k)·K·(3 + d + d²) floats (it uses blocks·K·(1 + d +
// d(d+1)/2)). Negative: a CUDA error code, negated.
int rho_blocks(int n, int k) {
  if (!shape_ok(n, k, 1)) return -static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = comb::sm_count(sms);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return comb::row_groups(n, comb::rows_per_block(n, k, comb::kBlockThreads, sms));
}

// Forward: z (S, N, K, d), log r̃ (N, K), μ̃ (N, K, d), the local row (N,)
// and the raw statistics (K, 1 + d + d²), unscaled and unsymmetrised.
// norm (N,) null: the softmax over this K; else log r̃ = log ρ − norm.
// partial: combine_grid(n, k, d, norm ? 1 : 0) · (1 + d + d(d+1)/2) · K floats.
int combine_forward(const float* ph, const float* pp, const float* w, const float* eps,
                    const float* norm, int n, int k, int d, int s,
                    const unsigned long long* word, float* z, float* log_resp, float* mean,
                    float* local, float* partial, float* stats, void* stream) {
  if (!shape_ok(n, k, s) || (eps == nullptr && word == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{ph, pp, w, eps, norm, n, k, s, word, 0, 0, 0,
                  z,  log_resp, mean, local, partial};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SVAX_CALL(D) (norm ? forward_d<D, true>(a, stats, st) : forward_d<D, false>(a, stats, st))
  SVAX_BY_DIM(d, err, SVAX_CALL)
#undef SVAX_CALL
  return static_cast<int>(err);
}

// Backward: the cotangents of pot_h, pot_p (N, d) and, when dw is not
// null, of w (K, 3 + d + d²), from those of the forward's outputs (each
// may be null: zero); with norm, also the normaliser's dn (N,). A call with
// no dstats and no dw (the train step's) runs combine_bwd_lean, which forms
// only h̃̄ and diag G; any other the two halves of combine_bwd_full.cu.
// partial (with dw): 2 · combine_grid(n, k, d, norm ? 3 : 2) · (3 + d + d²)
// · K floats.
int combine_backward(const float* ph, const float* pp, const float* w, const float* eps,
                     const float* norm, int n, int k, int d, int s,
                     const unsigned long long* word, const float* dz, const float* dlr,
                     const float* dmu, const float* dlocal, const float* dstats, float* dph,
                     float* dpp, float* dn, float* partial, float* dw, void* stream) {
  if (!shape_ok(n, k, s) || (dw == nullptr) != (partial == nullptr) ||
      (eps == nullptr && word == nullptr) || (norm == nullptr) != (dn == nullptr) ||
      (d != 2 && d != 3 && d != 4 && d != 6 && d != 8 && d != 10))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{ph, pp, w,      eps,    norm, n,   k,   s,       word, 0, 0,
                  0,  dz, dlr,    dmu,    dlocal, dstats, dph, dpp, partial, dn};
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = (dstats == nullptr && dw == nullptr)
                              ? comb::backward_lean(a, d, st)
                              : comb::backward_full(a, d, dw, st);
  return static_cast<int>(err);
}

// The ρ-kernel: this K-shard's pre-softmax log ρ (N, K).
int rho_forward(const float* ph, const float* pp, const float* w, int n, int k, int d,
                float* log_rho, void* stream) {
  if (!shape_ok(n, k, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const RhoArgs a{ph, pp, w, nullptr, n, k, log_rho, nullptr, nullptr, nullptr, 0, 0, 0};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SVAX_CALL(D) rho_forward_d<D>(a, st)
  SVAX_BY_DIM(d, err, SVAX_CALL)
#undef SVAX_CALL
  return static_cast<int>(err);
}

// Its backward: the cotangents of pot_h, pot_p (N, d) and, when dw is not
// null, of w (K, 3 + d + d²) from drho (N, K); partial: rho_blocks(n, k) ·
// K · (3 + d + d²) floats. Without dw (the train step's call) one launch.
int rho_backward(const float* ph, const float* pp, const float* w, const float* drho, int n,
                 int k, int d, float* dph, float* dpp, float* partial, float* dw, void* stream) {
  if (!shape_ok(n, k, 1) || (dw == nullptr) != (partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const RhoArgs a{ph, pp, w, drho, n, k, nullptr, dph, dpp, partial, 0, 0, 0};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SVAX_CALL(D) rho_backward_d<D>(a, dw, st)
  SVAX_BY_DIM(d, err, SVAX_CALL)
#undef SVAX_CALL
  return static_cast<int>(err);
}

}  // extern "C"
