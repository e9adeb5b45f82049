// The fused SIN combine's shared parts: the block plan, the staged
// component rows, the per-(n, k) recompute on packed triangles, the noise
// and the host-side grid sizing. Included by combine.cu (the forward, the
// cross-block sums and the ρ-kernels), combine_bwd.cu (the train
// step's backward) and combine_bwd_full.cu (the backward for every
// cotangent, dw included).
//
// Layout. A block holds R rows of K components, one thread per (n, k):
// thread t owns row t / K of each row group and component t % K. The row
// groups (R consecutive rows each) are dealt to the blocks in contiguous
// runs, so a block adds its rows' terms in row order into one partial: the
// forward's statistics and the backwards' dw need one partial per block,
// and the grid is sized from the SM count and the kernel's blocks an SM.
// Every block first stages the K component rows of w in shared memory,
// plane by plane with k the fastest index ([plane][k]), so a warp's lanes
// read consecutive words: log π, E[log|Λ|], E[μᵀΛμ], E[Λμ] (D planes),
// E[Λ]'s lower triangle as given (what the Cholesky of J̃ reads) and E[Λ]
// symmetrised (what the local KL and the cotangents read), each triangle
// packed at compile-time indices.
//
// Registers. L̃ is held as a packed lower triangle (D(D+1)/2 floats) and,
// once the forward has drawn its samples, inverted in place into L̃⁻¹,
// which is all that the per-pair work needs afterwards: Σ̃ = L̃⁻ᵀL̃⁻¹ is
// formed entry by entry where it is used.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <map>

#include "philox.cuh"

namespace svax {
namespace comb {

constexpr int kMaxK = 128;
// Threads a block may hold: the forward, the train step's backward and the
// ρ-kernel's backward at most 256, the backward with dw (whose per-thread dw
// sums fill shared memory) at most 128. The kernels declare these with a minimum of one
// block an SM: without it ptxas held some of them to 64 or 128 registers
// (two or four blocks an SM) and spilled 4–84 bytes a thread.
constexpr int kBlockThreads = 256;
constexpr int kFullThreads = 128;
constexpr float kLog2Pi = 1.8378770664093453f;

__host__ __device__ constexpr int tri(int d) { return d * (d + 1) / 2; }
// Packed index of (i, j), i >= j, in a lower triangle.
__host__ __device__ constexpr int tidx(int i, int j) { return i * (i + 1) / 2 + j; }

// A compiler barrier: loads from shared memory after it are not hoisted
// above it. Placed at the top of an unrolled loop's trip, it keeps the
// staged planes in shared memory instead of letting the scheduler hoist
// every trip's loads into registers (without it the backwards spilled
// 16–104 bytes a thread at d = 6 and 10).
__device__ __forceinline__ void no_hoist() { asm volatile("" ::: "memory"); }

// (i, j) of packed index t (i >= j).
__host__ __device__ inline void untri(int t, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  if ((i + 1) * (i + 2) / 2 <= t) ++i;
  if (i * (i + 1) / 2 > t) --i;
  j = t - i * (i + 1) / 2;
}

// Rows a block holds at once (R·K threads) for N points and K components,
// at most `threads` threads a block, on a card of `sms` SMs: at least four
// warps' worth (128 / K rows: one warp for each of an SM's schedulers),
// more where N would leave blocks queueing for SMs (ceil(N / SMs)), at
// most threads / K.
__host__ __device__ inline int rows_per_block(int n, int k, int threads, int sms) {
  const int most = k >= threads ? 1 : threads / k;
  const int least = k >= 128 ? 1 : 128 / k;
  int r = (n + sms - 1) / sms;
  r = r < least ? least : r;
  return r > most ? most : r;
}
// Block b of `blocks` owns the row groups [run_begin(b), run_begin(b + 1)).
__host__ __device__ inline int run_begin(int b, int groups, int blocks) {
  return static_cast<int>((static_cast<long long>(b) * groups) / blocks);
}

// The staged planes of one component row, K floats each.
template <int D>
struct Planes {
  static constexpr int T = tri(D);
  static constexpr int LOGPI = 0, LOGDET = 1, QUAD = 2, PM = 3, EL = 3 + D, ES = 3 + D + T;
  static constexpr int COUNT = 3 + D + 2 * T;
  // The statistics' cotangent (the backward with dw): s̄₀, s̄₁ (D) and s̄₂
  // symmetrised (packed).
  static constexpr int DS0 = COUNT, DS1 = COUNT + 1, DS2 = COUNT + 1 + D;
  static constexpr int COUNT_DS = COUNT + 1 + D + T;
  // w's slot row and dstats' row in device memory.
  static constexpr int W = 3 + D + D * D, F = 1 + D + D * D;
};

// Stage the K component rows (and, with ds, the statistics' cotangent) into
// s[plane·K + k]. The block reads w (K, 3 + D + D²) and dstats (K, 1 + D +
// D²) in order, so a warp's loads are coalesced, kStageChunk entries a
// thread before their stores (a few L2 round trips a block); each E[Λ]
// (s̄₂) entry (i, j), i ≥ j, also reads its transpose (j, i), which lies
// in the same row, for the symmetrised plane. The caller synchronises.
constexpr int kStageChunk = 16;

template <int D, int Width, int Head>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int K, float* s,
                                           int head_plane, int low_plane, int sym_plane) {
  // src (K, Width): Head leading entries per row, then a D × D matrix.
  const int NT = blockDim.x, total = K * Width;
  for (int base = threadIdx.x; base < total; base += kStageChunk * NT) {
    float v[kStageChunk], vt[kStageChunk];
#pragma unroll
    for (int u = 0; u < kStageChunk; ++u) {
      const int idx = base + u * NT, k = idx / Width, slot = idx - k * Width;
      const int ij = slot - Head, i = ij / D, j = ij - i * D;
      v[u] = idx < total ? src[idx] : 0.0f;
      vt[u] = (idx < total && slot >= Head && i > j) ? src[k * Width + Head + j * D + i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageChunk; ++u) {
      const int idx = base + u * NT, k = idx / Width, slot = idx - k * Width;
      if (idx >= total) break;
      if (slot < Head) {
        s[(head_plane + slot) * K + k] = v[u];
        continue;
      }
      const int ij = slot - Head, i = ij / D, j = ij - i * D;
      if (i < j) continue;
      const int t = tidx(i, j);
      if (low_plane >= 0) s[(low_plane + t) * K + k] = v[u];
      s[(sym_plane + t) * K + k] = i == j ? v[u] : 0.5f * (v[u] + vt[u]);
    }
  }
}

template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ w, const float* __restrict__ ds,
                                      int K, float* s) {
  using P = Planes<D>;
  stage_rows<D, P::W, 3 + D>(w, K, s, P::LOGPI, P::EL, P::ES);
  if (ds) stage_rows<D, P::F, 1 + D>(ds, K, s, P::DS0, -1, P::DS2);
}

// Copy `count` floats of w to shared memory as they lie — (K, 3 + D + D²)
// rows, read by recompute<…, kRaw> — in 16-byte loads where w allows. The
// caller synchronises.
__device__ __forceinline__ void copy_rows(const float* __restrict__ src, int count, float* s) {
  const int n4 = (reinterpret_cast<uintptr_t>(src) & 15u) == 0 ? count / 4 : 0;
#pragma unroll 4
  for (int q = threadIdx.x; q < n4; q += blockDim.x)
    reinterpret_cast<float4*>(s)[q] = reinterpret_cast<const float4*>(src)[q];
  for (int e = 4 * n4 + threadIdx.x; e < count; e += blockDim.x) s[e] = src[e];
}

// w's K·W floats as the copy engine takes them: a body of whole 16-byte
// chunks, one TMA bulk copy, and a tail of at most three floats, copied by
// threads.
__host__ __device__ inline int bulk_body(int count) { return count & ~3; }

// The copy engine's PTX and cp.async (a g++ rehearsal defines SVAX_MOCK_PTX
// and supplies these as plain copies and barriers).
#ifndef SVAX_MOCK_PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// An mbarrier in shared memory expecting `count` arrivals, made visible to
// the copy engine.
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// One arrival that also expects `bytes` of bulk copies to land.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// src to shared dst by the copy engine, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// One float from global to shared memory without a register (cp.async), and
// the wait for this thread's.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
#endif

// The potentials of rows n0 … n0 + R − 1 into s (R, 2D): [h (D), p (D)] a
// row, by cp.async; rows past N get p = 1, h = 0 (load_row's). The caller
// waits (cp_async_wait_all) and synchronises.
template <int D>
__device__ __forceinline__ void stage_potentials(const float* ph, const float* pp, int n,
                                                 int n0, int R, float* s) {
  for (int t = threadIdx.x; t < R * 2 * D; t += blockDim.x) {
    const int row = n0 + t / (2 * D), col = t % (2 * D);
    if (row >= n)
      s[t] = col < D ? 0.0f : 1.0f;
    else if (col < D)
      cp_async4(s + t, ph + static_cast<size_t>(row) * D + col);
    else
      cp_async4(s + t, pp + static_cast<size_t>(row) * D + col - D);
  }
}

// Entry (plane, k) of the staged component rows: planes sw[plane·K + k]
// (stage), or with kRaw w's rows as copied (copy_rows), entry `raw` of row
// k — an odd row length, so a warp's lanes on consecutive k hit distinct
// banks.
template <int D, bool kRaw>
__device__ __forceinline__ float row_at(const float* sw, int K, int k, int plane, int raw) {
  return kRaw ? sw[k * Planes<D>::W + raw] : sw[plane * K + k];
}

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

// The forward per (n, k) on the staged row sw[plane·K + k]: L (packed
// lower) = chol(diag(p) + E[Λ]), h̃, μ̃ = J̃⁻¹h̃, log|J̃| and the pre-softmax
// log ρ. kDivide: combine_tile.cuh's tile_core arithmetic in the same
// order, the solves dividing by L̃_ii, so that the forward's μ̃, log r̃ and z
// carry tile_core's exact bits (a downstream check, chip_smoke.py's phase
// K, compares two decoders over three steps from these bits, and moved
// when z's bits changed); else (the backwards, whose recomputed μ̃ is never
// output) products with the Cholesky's reciprocals. kRaw: sw holds w's rows
// as copy_rows left them. dinv: the reciprocals 1 / L̃_ii.
template <int D, bool kDivide = false, bool kRaw = false>
__device__ __forceinline__ void recompute(const float* sw, int K, int k, const float (&p)[D],
                                          const float (&h)[D], float (&L)[tri(D)],
                                          float (&ht)[D], float (&mu)[D], float& logdet_j,
                                          float& log_rho, float (&dinv)[D]) {
  using P = Planes<D>;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    ht[i] = row_at<D, kRaw>(sw, K, k, P::PM + i, 3 + i) + h[i];
#pragma unroll
    for (int j = 0; j <= i; ++j)
      L[tidx(i, j)] = row_at<D, kRaw>(sw, K, k, P::EL + tidx(i, j), 3 + D + i * D + j) +
                      (i == j ? p[i] : 0.0f);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = L[tidx(i, i)];
#pragma unroll
    for (int m = 0; m < i; ++m) acc -= L[tidx(i, m)] * L[tidx(i, m)];
    L[tidx(i, i)] = sqrtf(acc);
    const float inv = 1.0f / L[tidx(i, i)];
    dinv[i] = inv;
#pragma unroll
    for (int r = i + 1; r < D; ++r) {
      float a = L[tidx(r, i)];
#pragma unroll
      for (int m = 0; m < i; ++m) a -= L[tidx(r, m)] * L[tidx(i, m)];
      L[tidx(r, i)] = a * inv;
    }
  }
  float y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = ht[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc -= L[tidx(i, j)] * y[j];
    y[i] = kDivide ? acc / L[tidx(i, i)] : acc * dinv[i];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int j = i + 1; j < D; ++j) acc -= L[tidx(j, i)] * mu[j];
    mu[i] = kDivide ? acc / L[tidx(i, i)] : acc * dinv[i];
  }
  logdet_j = 0.0f;
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    logdet_j += 2.0f * logf(L[tidx(i, i)]);
    dot += mu[i] * ht[i];
  }
  log_rho = row_at<D, kRaw>(sw, K, k, P::LOGPI, 0) +
            0.5f * row_at<D, kRaw>(sw, K, k, P::LOGDET, 1) -
            0.5f * row_at<D, kRaw>(sw, K, k, P::QUAD, 2) + 0.5f * dot - 0.5f * logdet_j;
}

template <int D, bool kDivide = false, bool kRaw = false>
__device__ __forceinline__ void recompute(const float* sw, int K, int k, const float (&p)[D],
                                          const float (&h)[D], float (&L)[tri(D)],
                                          float (&ht)[D], float (&mu)[D], float& logdet_j,
                                          float& log_rho) {
  float dinv[D];
  recompute<D, kDivide, kRaw>(sw, K, k, p, h, L, ht, mu, logdet_j, log_rho, dinv);
}

// L (packed lower) → L⁻¹ in place, row by row: row i of L⁻¹ needs row i of
// L and the rows of L⁻¹ above it; dinv holds 1 / L_ii (recompute's).
template <int D>
__device__ __forceinline__ void invert(float (&L)[tri(D)], const float (&dinv)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float dii = dinv[i];
#pragma unroll
    for (int j = 0; j < i; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int m = j; m < i; ++m) acc += L[tidx(i, m)] * L[tidx(m, j)];
      L[tidx(i, j)] = -acc * dii;
    }
    L[tidx(i, i)] = dii;
  }
}

template <int D>
__device__ __forceinline__ void invert(float (&L)[tri(D)]) {
  float dinv[D];
#pragma unroll
  for (int i = 0; i < D; ++i) dinv[i] = 1.0f / L[tidx(i, i)];
  invert<D>(L, dinv);
}

// Σ̃_ij = Σ_{m ≥ max(i, j)} L⁻¹_mi L⁻¹_mj from the packed L⁻¹.
template <int D>
__device__ __forceinline__ float cov(const float (&Li)[tri(D)], int i, int j) {
  const int lo = i > j ? i : j;
  float acc = 0.0f;
#pragma unroll
  for (int m = 0; m < D; ++m)
    if (m >= lo) acc += Li[tidx(m, i)] * Li[tidx(m, j)];
  return acc;
}

// log r̃ and r̃ of this thread: the softmax over its row's K — each thread
// takes the row's max from s_rho, its own exp once (into s_ex), and the
// denominator summed over k in order — or against the external normaliser
// (kNorm; rows past N take their own log ρ: r̃ = 1, finite, and the callers
// zero what such rows add). Every thread of the block calls it: it
// synchronises the block twice (kNorm: once, which orders the callers'
// reuse of their buffers as in the softmax mode).
template <bool kNorm>
__device__ __forceinline__ void responsibility(float* s_rho, float* s_ex, int K, int r,
                                               const float* norm, int n, bool valid,
                                               float log_rho, float& log_resp, float& resp) {
  if constexpr (kNorm) {
    __syncthreads();
    log_resp = log_rho - (valid ? norm[n] : log_rho);
    resp = expf(log_resp);
  } else {
    s_rho[threadIdx.x] = log_rho;
    __syncthreads();
    float mx = -INFINITY;
    for (int c = 0; c < K; ++c) mx = fmaxf(mx, s_rho[r * K + c]);
    const float ex = expf(log_rho - mx);
    s_ex[threadIdx.x] = ex;
    __syncthreads();
    float den = 0.0f;
    for (int c = 0; c < K; ++c) den += s_ex[r * K + c];
    log_resp = log_rho - (mx + logf(den));
    resp = ex / den;
  }
}

// ε for one sample of one (n, k): injected, or philox.cuh's normals
// base + i drawn two per Philox block (normals 2c and 2c + 1 are the two
// halves of block c): the numbers philox_normal gives, bit for bit. The
// Philox key is the device word `word` = {seed, step}: the seed, and the
// step's low 32 bits as the stream. A caller writes it before the launch;
// a replayed CUDA graph's step advances it on the device, so every replay
// reads its own step (a launch argument would be frozen at capture).
template <int D>
__device__ __forceinline__ void noise(const float* eps, const unsigned long long* word,
                                      size_t base, float (&e)[D]) {
  if (eps) {
#pragma unroll
    for (int i = 0; i < D; ++i) e[i] = eps[base + i];
    return;
  }
  const unsigned long long seed = __ldg(word);
  const uint32_t stream = static_cast<uint32_t>(__ldg(word + 1));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const uint32_t idx = static_cast<uint32_t>(base + i);
    if (i == 0 || (idx & 1u) == 0u) r = philox4x32_10(make_uint4(idx >> 1, stream, 0u, 0u), key);
    const uint32_t b1 = (idx & 1u) ? r.z : r.x;
    const uint32_t b2 = (idx & 1u) ? r.w : r.y;
    const float u1 = (static_cast<float>(b1 >> 8) + 0.5f) * (1.0f / 16777216.0f);
    const float u2 = static_cast<float>(b2 >> 8) * (1.0f / 16777216.0f);
    e[i] = sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
  }
}

// E[Λ]'s symmetrised entry (a, b) of this thread's component, staged.
template <int D>
__device__ __forceinline__ float esym(const float* sw, int K, int k, int a, int b) {
  return sw[(Planes<D>::ES + (a >= b ? tidx(a, b) : tidx(b, a))) * K + k];
}

// tr(E[Λ](Σ̃ + μ̃μ̃ᵀ)) and E[Λμ]ᵀμ̃ → a_nk's part that is not log r̃:
//   ½log|J̃| − E_q[log p̄(z, k)] − (D/2)(1 + log 2π)
// (combine_tile.cuh: local_a0, on the symmetrised E[Λ]).
template <int D>
__device__ __forceinline__ float local_rest(const float* sw, int K, int k,
                                            const float (&Li)[tri(D)], const float (&mu)[D],
                                            float logdet_j) {
  using P = Planes<D>;
  float cross = 0.0f, trq = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    no_hoist();
    cross += sw[(P::PM + i) * K + k] * mu[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float ez = cov<D>(Li, i, j) + mu[i] * mu[j];
      const float e = sw[(P::ES + tidx(i, j)) * K + k];
      trq += (i == j ? e : 2.0f * e) * ez;
    }
  }
  const float g = 0.5f * sw[P::LOGDET * K + k] - 0.5f * D * kLog2Pi - 0.5f * sw[P::QUAD * K + k];
  const float e_log_pbar = sw[P::LOGPI * K + k] + g + cross - 0.5f * trq;
  return 0.5f * logdet_j - e_log_pbar - 0.5f * D * (1.0f + kLog2Pi);
}

struct FwdArgs {
  const float* __restrict__ ph;    // (N, D)
  const float* __restrict__ pp;    // (N, D)
  const float* __restrict__ w;     // (K, 3 + D + D²)
  const float* __restrict__ eps;   // (S, N, K, D) or null: in-kernel Philox
  const float* __restrict__ norm;  // (N,) log-normaliser (kNorm) or null
  int n, k, s;
  const unsigned long long* __restrict__ word;  // {seed, step} (noise), or null with eps
  int rows, groups, blocks;  // rows a block, row groups and the grid
  float* z;                  // (S, N, K, D)
  float* log_resp;     // (N, K)
  float* mean;         // (N, K, D)
  float* local;        // (N,)
  float* partial;      // (blocks, 1 + D + D(D+1)/2, K)
};

struct BwdArgs {
  const float* __restrict__ ph;
  const float* __restrict__ pp;
  const float* __restrict__ w;
  const float* __restrict__ eps;
  const float* __restrict__ norm;  // (N,) (kNorm) or null
  int n, k, s;
  const unsigned long long* __restrict__ word;  // {seed, step}, or null with eps
  int rows, groups, blocks;
  const float* __restrict__ dz;      // (S, N, K, D) or null
  const float* __restrict__ dlr;     // (N, K) or null
  const float* __restrict__ dmu;     // (N, K, D) or null
  const float* __restrict__ dlocal;  // (N,) or null
  const float* __restrict__ dstats;  // (K, 1 + D + D²) or null
  float* dph;                        // (N, D)
  float* dpp;                        // (N, D)
  float* partial;                    // (2, blocks, 3 + D + D², K) or null: no dw
  float* dn;                         // (N,) (kNorm) or null
};

// A kernel instantiation's launch state: the dynamic shared memory it is
// opted in to (the most any call has asked for: the attribute is the
// kernel's, whatever the block) and, per block shape (K, R), the blocks
// that fit on the card at once.
struct LaunchCache {
  int opted = 0;
  std::map<int, int> cap;
};

inline cudaError_t sm_count(int& sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

// Blocks of R·K threads and `bytes` of dynamic shared memory that fit on
// the card at once (SM count × blocks an SM), after opting the kernel in to
// that much shared memory.
template <typename Kernel>
cudaError_t capacity(Kernel kernel, int k, int rows, size_t bytes, int sms, LaunchCache& cache,
                     int& cap) {
  cudaError_t err;
  if (static_cast<int>(bytes) > cache.opted) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    cache.opted = static_cast<int>(bytes);
  }
  const int key = k * 1024 + rows;
  const auto hit = cache.cap.find(key);
  if (hit != cache.cap.end()) {
    cap = hit->second;
    return cudaSuccess;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, rows * k, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cap = per_sm * sms;
  cache.cap[key] = cap;
  return cudaSuccess;
}

// What launch_reduce writes: the sums as (K, planes); the forward's (K, 1 +
// D + D²) raw statistics from its packed planes; or the ρ-backward's dw (K,
// 3 + D + D²) from its packed planes.
enum class ReduceOut { kPlanes, kStats, kRhoDw };

// Σ_b partial[b][plane][k] over `blocks` partials (a fixed two-level order),
// written in the layout `layout`. Defined in combine.cu.
cudaError_t launch_reduce(const float* partial, int blocks, int planes, int k, int d,
                          ReduceOut layout, float* out, cudaStream_t st);

// The backwards (combine_bwd.cu, combine_bwd_full.cu): the train step's
// (no dstats, no dw) and the one for every cotangent.
cudaError_t backward_lean(const BwdArgs& a, int d, cudaStream_t st);
cudaError_t backward_full(BwdArgs a, int d, float* dw, cudaStream_t st);
// The full backward's grid (each half's partial count) for N, K, d.
cudaError_t full_grid(int n, int k, int d, bool norm, int& blocks);
// ceil(N / R).
inline int row_groups(int n, int rows) { return (n + rows - 1) / rows; }

}  // namespace comb
}  // namespace svax
