// flexstep: T complete minibatch SVAE training steps in one kernel launch.
//
// Replaces the TPU kernel svax/ops/flexstep_pallas.py (_chunk_call →
// pallas_call, body _make_kernel/_step_math): the small-d minibatch class
// (auto-svae: M=64, d_in=8, latent d=4, K=10, S=4, tanh MLPs 100-100).
// Each step, one per row of the (T, M, d_in) batch stack: expected GMM
// parameters from the pre-update naturals (general d, ψ by recurrence) →
// encoder → diagonal potentials → the general-d SIN combine per (n, k)
// (combine_tile.cuh) → softmax over K → S samples per (n, k) → Gaussian
// decoder over K·S·M rows and its log-likelihood → local KL → a backward
// pass written by hand (svax_torch/ops/flexstep.py: step_grads_manual is
// the same formulas in PyTorch, tested against autograd) → Adam → CVI with
// ρ_t = ρ₀/(1 + decay·t) at the pre-update step, statistics × N/M.
//
// Bound: the decoder's forward, activation backward and weight gradients,
// about 94 M FMA per step at the auto shape (2,560 rows through
// 4→100→100→16, each product three times); the encoder adds 2 M. Design:
// ONE thread-block cluster of C = 8 or 16 CTAs of 512 threads
// (cluster_step.cuh). CTA r owns a contiguous range of the M minibatch
// rows and their K·S decoder rows, so the whole forward and backward down
// to the encoder needs only __syncthreads() inside the CTA. Each CTA keeps
// every parameter in its shared memory (96 KB at 100-100) for the whole
// chunk, with its slice of both Adam moments (192/C KB); its gradient,
// statistics and metric partials go to its slab of global scratch (L2),
// which the owners of the parameter slices read in rank order after the
// first of the step's two cluster barriers. Per-row data live
// feature-major in the CTA's own block of global scratch (row r of feature
// f at [f·ld + r]):
// * products Out = act(In·W): a thread owns 8 rows × 4 columns, the row
//   tile fastest across threads, so a warp reads consecutive rows of In as
//   float4 (coalesced) and shares its columns: W and Wᵀ are read straight
//   from the shared parameter copy as broadcasts;
// * weight gradients dW = Aᵀ·G (with a row of ones for the bias): a thread
//   owns a 4×4 block and sums it over the CTA's rows in row order;
// * per-(n, k) combine work (forward, softmax, sampling, backward): one
//   thread per (n, k), D a template parameter, all in registers.
// * registers: 512 threads, 128 registers each; the scratch layout and
//   both sides' offsets are kernel arguments and the CTA's counts 32-bit,
//   so they hold no registers across the step (no spills at d ≤ 4).
// No atomics, so two runs at one seed are bit-identical. f32 FMA on CUDA
// cores (no TF32). kBf16 (the reference's nn_precision DEFAULT): every
// product of gemm and weight_grads takes bf16-rounded operands with the
// same f32 FMAs and order; the weights are rounded once a step into the
// shared copy (cluster_step.cuh: reduce_adam_broadcast's master), the rows
// as a product reads them; the biases' sums, the combine, Adam and CVI
// stay f32. Measured per-phase split: PERF.md
// (svax_torch/measure_steps.py).
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_step.cuh"
#include "combine_tile.cuh"
#include "gmm_d2.cuh"
#include "philox.cuh"
#include "phase_clock.cuh"

namespace {

using namespace svax;  // combine_tile.cuh, digammaf (gmm_d2.cuh), philox_normal
namespace cs = svax::cluster_step;
namespace cg = cooperative_groups;

constexpr int NT = 512;  // threads in each CTA of the cluster
constexpr int TM = 8;    // rows per product tile
constexpr int TN = 4;    // columns per product tile
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kVarFloor = 1e-6f;
constexpr int kMaxHidden = 128, kMaxInput = 8, kMaxComponents = 64;

__host__ __device__ constexpr long long pad4(long long v) { return (v + 3) / 4 * 4; }
__host__ __device__ constexpr long long pad8(long long v) { return (v + 7) / 8 * 8; }

struct Dims {
  int m, d_in, d, k, s, h1e, h2e, h1d, h2d;
};

// One side's block of the flat parameter vector (svax_torch/ops/tinystep.py:
// flat_params): W1 (in, H1), b1, W2 (H1, H2), b2, W3 (H2, out), b3, each W
// (in, out) row-major as in svax/nets/mlp.py.
struct Side {
  int in, h1, h2, out, w1, b1, w2, b2, w3, b3, size;
  Side() = default;
  __host__ __device__ Side(int in_, int h1_, int h2_, int out_, int base)
      : in(in_), h1(h1_), h2(h2_), out(out_) {
    w1 = base;
    b1 = w1 + in * h1;
    w2 = b1 + h1;
    b2 = w2 + h1 * h2;
    w3 = b2 + h2;
    b3 = w3 + h2 * out;
    size = b3 + out - base;
  }
};

// Fields of the per-(n, k) record: log r̃ (log ρ before the softmax), r̃,
// a_nk (½log|J̃| − E log p̄ before the softmax), ∂/∂log r̃, then the
// statistics r̃μ̃ (D) and r̃(Σ̃ + μ̃μ̃ᵀ) (D²), then diag(J̄) (D) and h̄ (D).
enum RecField { R_LOGR, R_R, R_A, R_LRBAR, R_MU };
__host__ __device__ constexpr int rec_width(int d) { return R_MU + 3 * d + d * d; }

__host__ __device__ inline int n_params(const Dims& g) {
  const Side enc(g.d_in, g.h1e, g.h2e, 2 * g.d, 0);
  const Side dec(g.d, g.h1d, g.h2d, 2 * g.d_in, enc.size);
  return enc.size + dec.size;
}

// Offsets (floats) of one CTA's block of scratch, every buffer on 16
// bytes, sized for `g.m` points (the largest part, ⌈M/C⌉); the rows a CTA
// owns are local (its points from 0, its decoder rows (n·K + k)·S + s).
// After the C blocks come C slabs of partials: the gradient (P floats),
// then the statistics (K·(1 + d + d²)), recon and local.
struct Layout {
  long long mp, r, rp;  // encoder rows padded; decoder rows K·S·m and padded
  long long x, a1e, a2e, oe, obe, g2e, g1e;  // encoder, feature-major, ld = mp
  long long z, a1d, a2d, od, obd, g2d, g1d, zb, ll;  // decoder, ld = rp
  long long ph, nsc, rec, cta;
  long long stats, slab;  // offset of the statistics in a slab; a slab's size
  Layout() = default;
  __host__ __device__ explicit Layout(const Dims& g) {
    mp = pad8(g.m);
    r = static_cast<long long>(g.k) * g.s * g.m;
    rp = pad8(r);
    long long off = 0;
    auto take = [&off](long long n) {
      const long long at = off;
      off += pad4(n);
      return at;
    };
    x = take(g.d_in * mp);
    a1e = take(g.h1e * mp);
    a2e = take(g.h2e * mp);
    oe = take(2 * g.d * mp);
    obe = take(2 * g.d * mp);
    g2e = take(g.h2e * mp);
    g1e = take(g.h1e * mp);
    z = take(g.d * rp);
    a1d = take(g.h1d * rp);
    a2d = take(g.h2d * rp);
    od = take(2 * g.d_in * rp);
    obd = take(2 * g.d_in * rp);
    g2d = take(g.h2d * rp);
    g1d = take(g.h1d * rp);
    zb = take(g.d * rp);
    ll = take(rp);
    ph = take(2LL * g.d * g.m);
    nsc = take(3LL * g.m);
    rec = take(static_cast<long long>(g.m) * g.k * rec_width(g.d));
    cta = off;
    stats = pad4(n_params(g));
    slab = stats + pad4(static_cast<long long>(g.k) * (1 + g.d + g.d * g.d) + 2);
  }
};

// Shared memory of one CTA, in floats: the parameters (flat, the global
// layout), this CTA's slice of both Adam moments (and, in the bf16-product
// mode, the slice's f32 master), the naturals, the expected parameters
// (slot rows) and the cluster totals of the statistics, recon and local.
// svax_torch/ops/flexstep.py: smem_bytes is its Python twin.
struct Smem {
  long long m, v, master, nat, exp, tot, total;
  __host__ __device__ Smem(const Dims& g, int c, bool bf16) {
    const long long f = 3 + g.d + g.d * g.d;
    const long long p = n_params(g);
    const long long slice = pad4((p + c - 1) / c);
    m = pad4(p);
    v = m + slice;
    master = v + slice;
    nat = master + (bf16 ? slice : 0);
    exp = nat + pad4(g.k * f);
    tot = exp + pad4(g.k * f);
    total = tot + pad4(static_cast<long long>(g.k) * (1 + g.d + g.d * g.d) + 2);
  }
};

struct Args {
  const float* batches;  // (T, M, d_in)
  Dims g;              // the whole minibatch
  const float* prior;  // (K, F), F = 3 + d + d²: dir, η₁, η₂, η₃, η₄
  float* nat;          // (K, F), updated in place
  float* params;       // flat, updated in place
  float* m1;           // Adam first moments, flat, in place
  float* m2;           // Adam second moments
  float* metrics;      // (T, 4): recon, local_kl, neg_loss, rho
  float* scratch;
  const float* eps;  // (T, S, M, K, d) or null: in-kernel Philox
  int t_steps, adam_count, step0;
  unsigned long long seed;
  float lr;
  double rho0, rho_decay;
  float num_total;
  // Set by the host: one CTA's block of scratch (for ⌈M/C⌉ points) and both
  // sides' parameter offsets. Read from the kernel's parameter space where
  // they are used, they hold no registers across the step.
  Layout lo;
  Side enc, dec;
};

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

enum Epi { kBiasTanh, kBias, kDTanh, kNone };

// Out[c][r] = epi(Σ_q In[q][r]·B[q][c]) for r < rp (a multiple of 8),
// c < C, feature-major with row stride ld. B = W (Q×C row-major) or, with
// trans, Wᵀ for W (C×Q) row-major, read from the CTA's shared parameter
// copy. A thread owns an 8-row × 4-column tile, the row tile fastest across
// threads: a warp reads consecutive rows of In as float4 and shares its
// columns, so each W read is a broadcast. Epilogues: tanh(· + b), · + b,
// ·(1 − act²) (the tanh backward with act the layer's output), or none.
// kBf16: In is rounded to bf16 as it is read (W arrives rounded in the
// shared copy; the epilogue's b and act stay f32). All threads call; ends
// synchronised.
template <bool kBf16>
__device__ void gemm(const float* in, int Q, int C, long long ld, long long rp,
                     const float* W, bool trans, const float* bias, const float* act,
                     Epi epi, float* out) {
  const int ncb = (C + TN - 1) / TN;
  const long long nrt = rp / TM;
  const long long tiles = nrt * ncb;
  const int bstep = trans ? 1 : C;  // from B[q][c] to B[q + 1][c]
  for (long long t = threadIdx.x; t < tiles; t += NT) {
    const int c0 = static_cast<int>(t / nrt) * TN;
    const long long r0 = (t % nrt) * TM;
    const float* b[TN];  // column c0 + y of B (the last column past C)
#pragma unroll
    for (int y = 0; y < TN; ++y) {
      const int c = c0 + y < C ? c0 + y : C - 1;
      b[y] = trans ? W + c * Q : W + c;
    }
    float acc[TM][TN];
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) acc[x][y] = 0.0f;
    const float* a = in + r0;
#pragma unroll 2
    for (int q = 0; q < Q; ++q) {
      float4 a0 = ld4(a + q * ld), a1 = ld4(a + q * ld + 4);
      if (kBf16) {
        a0 = cs::bf16_round4(a0);
        a1 = cs::bf16_round4(a1);
      }
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
#pragma unroll
      for (int y = 0; y < TN; ++y) bv[y] = b[y][q * bstep];
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
    }
#pragma unroll
    for (int y = 0; y < TN; ++y) {
      const int c = c0 + y;
      if (c >= C) break;
      float h[TM] = {};
      if (epi == kDTanh) {  // the layer's output for these 8 rows, as two float4
        const float4 h0 = ld4(act + c * ld + r0), h1 = ld4(act + c * ld + r0 + 4);
        const float hv[TM] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int x = 0; x < TM; ++x) h[x] = hv[x];
      }
      float o[TM];
#pragma unroll
      for (int x = 0; x < TM; ++x) {
        float v = acc[x][y];
        if (epi == kBiasTanh) {
          v = tanhf(v + bias[c]);
        } else if (epi == kBias) {
          v += bias[c];
        } else if (epi == kDTanh) {
          v *= 1.0f - h[x] * h[x];
        }
        o[x] = v;
      }
      float4* dst = reinterpret_cast<float4*>(out + c * ld + r0);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    }
  }
  __syncthreads();
}

// One layer's weight gradient: dW[i][c] = Σ_r A[i][r]·G[c][r] (i < Q) at
// grad + w, and db[c] = Σ_r G[c][r] at grad + b; A (Q × ld) is the layer's
// input and G (C × ld) its output cotangent, feature-major.
struct WGrad {
  const float* a;
  const float* g;
  int q, c, w, b;
};

// The three layers of one side: a thread owns a 4×4 block of one layer's
// [dW; db] and sums it over the CTA's rp rows in row order (float4 loads
// of 4 consecutive rows), so the result does not depend on timing. Rows
// past the real ones carry G = 0. kBf16: dW takes bf16-rounded A and G,
// while db stays the f32 sum of G (the reference's bias cotangent is a
// sum, not a product), kept beside in accb. All threads call; ends
// synchronised.
template <bool kBf16>
__device__ void weight_grads(const WGrad& l0, const WGrad& l1, const WGrad& l2, long long ld,
                             long long rp, float* grad) {
  const WGrad* layers[3] = {&l0, &l1, &l2};
  int blocks[3], total = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    blocks[l] = ((layers[l]->q + 4) / 4) * ((layers[l]->c + 3) / 4);
    total += blocks[l];
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  for (int task = threadIdx.x; task < total; task += NT) {
    int l = 0, idx = task;
    while (idx >= blocks[l]) idx -= blocks[l++];
    const WGrad* L = layers[l];
    const int ncb = (L->c + 3) / 4;
    const int i0 = idx / ncb * 4, c0 = idx % ncb * 4;
    const float* arow[4];
    const float* grow[4];
    float4 aconst[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + x;
      arow[x] = i < L->q ? L->a + i * ld : nullptr;
      aconst[x] = i == L->q ? ones : zero;
      grow[x] = c0 + x < L->c ? L->g + (c0 + x) * ld : nullptr;
    }
    float acc[4][4], accb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
    for (long long r = 0; r < rp; r += 4) {
      float4 av[4], gv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        av[x] = arow[x] ? ld4(arow[x] + r) : aconst[x];
        gv[x] = grow[x] ? ld4(grow[x] + r) : zero;
      }
      if (kBf16) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          av[x] = cs::bf16_round4(av[x]);  // the ones and zeros are exact
          accb[x] = accb[x] + gv[x].x + gv[x].y + gv[x].z + gv[x].w;
          gv[x] = cs::bf16_round4(gv[x]);
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          acc[x][y] = fmaf(av[x].x, gv[y].x, acc[x][y]);
          acc[x][y] = fmaf(av[x].y, gv[y].y, acc[x][y]);
          acc[x][y] = fmaf(av[x].z, gv[y].z, acc[x][y]);
          acc[x][y] = fmaf(av[x].w, gv[y].w, acc[x][y]);
        }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = i0 + x, c = c0 + y;
        if (c < L->c && i < L->q) grad[L->w + i * L->c + c] = acc[x][y];
        else if (c < L->c && i == L->q) grad[L->b + c] = kBf16 ? accb[y] : acc[x][y];
      }
  }
  __syncthreads();
}

// The expected GMM parameters of component k as one slot row
// (combine_tile.cuh: Slot<D>) from the (K, F) packed naturals — the general-d
// NIW mean map of flexstep_pallas._expected_w_block (one Cholesky of Φ per
// component) and svax_torch/ops/flexstep.py: expected_slots. The Dirichlet
// total Σα is summed over all K in index order.
template <int D>
__device__ void expected_slots(const float* nat, int K, int k, float* e) {
  using S = Slot<D>;
  constexpr int F = 3 + D + D * D;
  const float* nt = nat + k * F;
  float sum_alpha = 0.0f;
  for (int j = 0; j < K; ++j) sum_alpha += nat[j * F] + 1.0f;
  const float kappa = nt[1 + D];
  const float nu = nt[2 + D + D * D] - (D + 2.0f);
  float m[D], phi[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) m[i] = nt[1 + i] / kappa;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) phi[i][j] = nt[2 + D + i * D + j] - kappa * m[i] * m[j];
  float L[D][D], Li[D][D], inv[D][D];
  cholesky<D>(phi, L);
  tri_inverse<D>(L, Li);
  cov_from_inverse<D>(Li, inv);
  float logdet = D * kLog2, quad = D / kappa;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    logdet += digammaf((nu - i) / 2.0f) - 2.0f * logf(L[i][i]);
    float pim = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) pim += inv[i][j] * m[j];
    quad += nu * m[i] * pim;
    e[S::PM + i] = nu * pim;
#pragma unroll
    for (int j = 0; j < D; ++j) e[S::PREC + i * D + j] = nu * inv[i][j];
  }
  e[S::LOGPI] = digammaf(nt[0] + 1.0f) - digammaf(sum_alpha);
  e[S::LOGDET] = logdet;
  e[S::QUAD] = quad;
}

// ε of sample s for (n, k) at step t: injected, or normal
// ((s·M + n)·K + k)·D + i of Philox stream t.
template <int D>
__device__ __forceinline__ void draw_eps(const Args& a, int t, int s, int n, int k,
                                         float (&e)[D]) {
  const long long base = ((static_cast<long long>(s) * a.g.m + n) * a.g.k + k) * D;
  if (a.eps) {
    const float* p =
        a.eps + static_cast<long long>(t) * a.g.s * a.g.m * a.g.k * D + base;
#pragma unroll
    for (int i = 0; i < D; ++i) e[i] = p[i];
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i)
      e[i] = philox_normal(a.seed, static_cast<uint32_t>(t), static_cast<uint32_t>(base + i));
  }
}

// Phase-clock slots (svax_torch/measure_steps.py names them): 0–10 the
// step's phases, then the two cluster barriers and the chunk's loads and
// stores.
enum FlexPhase { PH_BAR1 = 11, PH_BAR2 = 12, PH_IO = 13 };

// The value of flat parameter i in the CTAs' shared copies: in the
// bf16-product mode a weight is rounded to bf16 (once a step, as the update
// is broadcast) and a bias stays f32; else the f32 value.
template <bool kBf16>
struct SharedCopy {
  Side enc, dec;
  __device__ float operator()(long long i, float p) const {
    if (!kBf16) return p;
    const Side& sd = i < enc.size ? enc : dec;
    const int j = static_cast<int>(i) - sd.w1;
    const bool bias = (j >= sd.b1 - sd.w1 && j < sd.w2 - sd.w1) ||
                      (j >= sd.b2 - sd.w1 && j < sd.w3 - sd.w1) || j >= sd.b3 - sd.w1;
    return bias ? p : cs::bf16_round(p);
  }
};

template <int D, int C, bool kBf16>
__global__ void __launch_bounds__(NT, 1) flexstep_kernel(Args a) {
  constexpr int F = 3 + D + D * D;  // naturals and expected-parameter slots
  constexpr int FS = 1 + D + D * D;  // statistics: count, s1, s2
  constexpr int RW = rec_width(D);
  constexpr int R_ZZ = R_MU + D, R_JB = R_ZZ + D * D, R_HB = R_JB + D;
  static_assert(Slot<D>::SIZE == F, "the naturals and the slot rows share a width");
  PHASE_START;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const Dims& g = a.g;
  const int M = g.m, K = g.k, S = g.s, DI = g.d_in;
  const int P = n_params(g);
  // This CTA's minibatch rows [m0, m0 + mc) and parameter slice [p0, p1).
  const int m0 = static_cast<int>(cs::part_begin(M, C, rank));
  const int mc = static_cast<int>(cs::part_begin(M, C, rank + 1)) - m0;
  const int p0 = static_cast<int>(cs::part_begin(P, C, rank));
  const int p1 = static_cast<int>(cs::part_begin(P, C, rank + 1));
  const Layout& lo = a.lo;
  const int ldm = static_cast<int>(lo.mp), ldr = static_cast<int>(lo.rp);  // the block's strides
  const int mp = static_cast<int>(pad8(mc)), R = K * S * mc, rp = static_cast<int>(pad8(R));
  const Side &enc = a.enc, &dec = a.dec;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem so(g, C, kBf16);
  float* sp = smem;  // parameters (every CTA's copy identical)
  float* sm = smem + so.m;
  float* sv = smem + so.v;
  float* smaster = smem + so.master;  // kBf16: the slice's f32 parameters
  float* snat = smem + so.nat;
  float* sexp = smem + so.exp;
  float* stot = smem + so.tot;

  float* scr = a.scratch + rank * lo.cta;
  float *X = scr + lo.x, *A1E = scr + lo.a1e, *A2E = scr + lo.a2e, *OE = scr + lo.oe,
        *OBE = scr + lo.obe, *G2E = scr + lo.g2e, *G1E = scr + lo.g1e;
  float *Z = scr + lo.z, *A1D = scr + lo.a1d, *A2D = scr + lo.a2d, *OD = scr + lo.od,
        *OBD = scr + lo.obd, *G2D = scr + lo.g2d, *G1D = scr + lo.g1d, *ZB = scr + lo.zb,
        *LL = scr + lo.ll;
  float *PH = scr + lo.ph, *NSC = scr + lo.nsc, *REC = scr + lo.rec;
  float* slabs = a.scratch + C * lo.cta;  // rank 0's slab of partials
  float* grad = slabs + rank * lo.slab;
  float* spart = grad + lo.stats;  // statistics (K, FS), then recon and local
  const float* pw = sp;  // both sides' offsets are into the one flat block

  for (int i = tid; i < P; i += NT) sp[i] = SharedCopy<kBf16>{a.enc, a.dec}(i, a.params[i]);
  for (int i = p0 + tid; i < p1; i += NT) {
    sm[i - p0] = a.m1[i];
    sv[i - p0] = a.m2[i];
    if (kBf16) smaster[i - p0] = a.params[i];
  }
  for (int i = tid; i < K * F; i += NT) snat[i] = a.nat[i];
  __syncthreads();
  PHASE_MARK(PH_IO);

  const float scale = a.num_total / static_cast<float>(M);
  const float lbar = scale / a.num_total;  // ∂neg_loss/∂(Σ_n local_n)
  const float rbar = -lbar;                // ∂neg_loss/∂(Σ_n Σ_k r̃·mean_s ll)
  const float inv_s = 1.0f / static_cast<float>(S);
  const float half_d_const = 0.5f * D * (1.0f + kLog2Pi);

  for (int t = 0; t < a.t_steps; ++t) {
    const float* xb = a.batches + (static_cast<long long>(t) * M + m0) * DI;  // this CTA's rows

    // ---- 0: the batch, feature-major; expected parameters of the pre-update naturals.
    for (int i = tid; i < DI * mp; i += NT) {
      const int f = static_cast<int>(i / mp), n = static_cast<int>(i % mp);
      X[f * ldm + n] = n < mc ? xb[n * DI + f] : 0.0f;
    }
    if (tid < K) expected_slots<D>(snat, K, tid, sexp + tid * F);
    __syncthreads();
    PHASE_MARK(0);

    // ---- 1: encoder forward; the diagonal potential per row.
    gemm<kBf16>(X, DI, enc.h1, ldm, mp, pw + enc.w1, false, pw + enc.b1, nullptr, kBiasTanh, A1E);
    gemm<kBf16>(A1E, enc.h1, enc.h2, ldm, mp, pw + enc.w2,
                false, pw + enc.b2, nullptr, kBiasTanh, A2E);
    gemm<kBf16>(A2E, enc.h2, 2 * D, ldm, mp, pw + enc.w3, false, pw + enc.b3, nullptr, kBias, OE);
    for (int n = tid; n < mc; n += NT) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float p = 1.0f / (softplusf(OE[(D + i) * ldm + n]) + kVarFloor);
        PH[n * 2 * D + i] = p;
        PH[n * 2 * D + D + i] = OE[i * ldm + n] * p;
      }
    }
    __syncthreads();
    PHASE_MARK(1);

    // ---- 2: combine per (n, k): log ρ, the local-KL part, S samples.
    for (int q = tid; q < mc * K; q += NT) {
      const int n = q / K, k = q - n * K;
      const float* e = sexp + k * F;
      float p[D], h[D], L[D][D], ht[D], mu[D], Li[D][D], Cv[D][D], logdet_j, log_rho;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        p[i] = PH[n * 2 * D + i];
        h[i] = PH[n * 2 * D + D + i];
      }
      tile_core<D>(e, p, h, L, ht, mu, logdet_j, log_rho);
      tri_inverse<D>(L, Li);
      cov_from_inverse<D>(Li, Cv);
      float* rec = REC + static_cast<long long>(q) * RW;
      rec[R_LOGR] = log_rho;
      rec[R_A] = local_a0<D>(e, mu, Cv, logdet_j);
      for (int s = 0; s < S; ++s) {
        float ep[D], u[D];
        draw_eps<D>(a, t, s, m0 + n, k, ep);
        solve_upper<D>(L, ep, u);
        const long long r = static_cast<long long>(q) * S + s;
#pragma unroll
        for (int i = 0; i < D; ++i) Z[i * ldr + r] = mu[i] + u[i];
      }
    }
    for (int i = tid; i < D * (rp - R); i += NT) Z[(i / (rp - R)) * ldr + R + i % (rp - R)] = 0.0f;
    __syncthreads();
    PHASE_MARK(2);

    // ---- 3: softmax over K per row; r̃ and a_nk.
    for (int n = tid; n < mc; n += NT) {
      float* recs = REC + static_cast<long long>(n) * K * RW;
      float mx = -3.0e38f;
      for (int k = 0; k < K; ++k) mx = fmaxf(mx, recs[k * RW + R_LOGR]);
      float se = 0.0f;
      for (int k = 0; k < K; ++k) se += expf(recs[k * RW + R_LOGR] - mx);
      const float lse = mx + logf(se);
      for (int k = 0; k < K; ++k) {
        float* rec = recs + k * RW;
        const float log_r = rec[R_LOGR] - lse;
        rec[R_LOGR] = log_r;
        rec[R_R] = expf(log_r);
        rec[R_A] = log_r - half_d_const + rec[R_A];
      }
    }
    __syncthreads();
    PHASE_MARK(3);

    // ---- 4: decoder forward over the CTA's K·S·mc rows; log-likelihood and its cotangent.
    gemm<kBf16>(Z, D, dec.h1, ldr, rp, pw + dec.w1, false, pw + dec.b1, nullptr, kBiasTanh, A1D);
    gemm<kBf16>(A1D, dec.h1, dec.h2, ldr, rp, pw + dec.w2,
                false, pw + dec.b2, nullptr, kBiasTanh, A2D);
    gemm<kBf16>(A2D, dec.h2, 2 * DI, ldr, rp, pw + dec.w3, false, pw + dec.b3, nullptr, kBias, OD);
    for (int r = tid; r < rp; r += NT) {
      if (r >= R) {
        LL[r] = 0.0f;
        for (int j = 0; j < 2 * DI; ++j) OBD[j * ldr + r] = 0.0f;
        continue;
      }
      const int q = r / S;
      const int n = static_cast<int>(q / K);
      const float llbar = rbar * REC[q * RW + R_R] * inv_s;
      float ll = 0.0f;
      for (int j = 0; j < DI; ++j) {
        const float o = OD[j * ldr + r], raw = OD[(DI + j) * ldr + r];
        const float var = softplusf(raw) + kVarFloor;
        const float diff = xb[n * DI + j] - o;
        ll += logf(var) + diff * diff / var + kLog2Pi;
        OBD[j * ldr + r] = llbar * diff / var;
        OBD[(DI + j) * ldr + r] =
            llbar * -0.5f * (1.0f / var - diff * diff / (var * var)) * sigmoidf(raw);
      }
      LL[r] = -0.5f * ll;
    }
    __syncthreads();
    PHASE_MARK(4);

    // ---- 5: decoder backward to z̄; the decoder's weight-gradient partial.
    gemm<kBf16>(OBD, 2 * DI, dec.h2, ldr, rp, pw + dec.w3, true, nullptr, A2D, kDTanh, G2D);
    gemm<kBf16>(G2D, dec.h2, dec.h1, ldr, rp, pw + dec.w2, true, nullptr, A1D, kDTanh, G1D);
    gemm<kBf16>(G1D, dec.h1, D, ldr, rp, pw + dec.w1, true, nullptr, nullptr, kNone, ZB);
    weight_grads<kBf16>({Z, G1D, D, dec.h1, dec.w1, dec.b1},
                        {A1D, G2D, dec.h1, dec.h2, dec.w2, dec.b2},
                        {A2D, OBD, dec.h2, 2 * DI, dec.w3, dec.b3}, ldr, rp, grad);
    PHASE_MARK(5);

    // ---- 6: softmax backward per row (r̃ feeds recon weights and local KL).
    for (int n = tid; n < mc; n += NT) {
      float* recs = REC + static_cast<long long>(n) * K * RW;
      float sum_lr = 0.0f, recon_n = 0.0f, local_n = 0.0f;
      for (int k = 0; k < K; ++k) {
        float* rec = recs + k * RW;
        const long long r0 = (static_cast<long long>(n) * K + k) * S;
        float sum_ll = 0.0f;
        for (int s = 0; s < S; ++s) sum_ll += LL[r0 + s];
        const float r = rec[R_R];
        const float respbar = rbar * sum_ll * inv_s + lbar * rec[R_A];
        const float lrbar = lbar * r + respbar * r;
        rec[R_LRBAR] = lrbar;
        sum_lr += lrbar;
        recon_n += r * sum_ll;
        local_n += r * rec[R_A];
      }
      NSC[n * 3 + 0] = recon_n * inv_s;
      NSC[n * 3 + 1] = local_n;
      NSC[n * 3 + 2] = sum_lr;
    }
    __syncthreads();
    PHASE_MARK(6);

    // ---- 7: combine backward per (n, k); the statistics' terms.
    for (int q = tid; q < mc * K; q += NT) {
      const int n = q / K, k = q - n * K;
      const float* e = sexp + k * F;
      float p[D], h[D], L[D][D], ht[D], mu[D], Li[D][D], Cv[D][D], logdet_j, log_rho;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        p[i] = PH[n * 2 * D + i];
        h[i] = PH[n * 2 * D + D + i];
      }
      tile_core<D>(e, p, h, L, ht, mu, logdet_j, log_rho);
      tri_inverse<D>(L, Li);
      cov_from_inverse<D>(Li, Cv);
      float mubar[D], Lbar[D][D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        mubar[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j) Lbar[i][j] = 0.0f;
      }
      for (int s = 0; s < S; ++s) {
        float ep[D], u[D], zb[D], v[D];
        draw_eps<D>(a, t, s, m0 + n, k, ep);
        solve_upper<D>(L, ep, u);
        const long long r = static_cast<long long>(q) * S + s;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          zb[i] = ZB[i * ldr + r];
          mubar[i] += zb[i];
        }
        lower_times<D>(Li, zb, v);
#pragma unroll
        for (int i = 0; i < D; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) Lbar[i][j] -= u[i] * v[j];
      }
      float* rec = REC + static_cast<long long>(q) * RW;
      const float r = rec[R_R];
      const float rhobar = rec[R_LRBAR] - r * NSC[n * 3 + 2];
      float jbar[D], hbar[D];
      tile_core_bwd<D>(e, L, Li, Cv, mu, ht, mubar, Lbar, lbar * r, rhobar, jbar, hbar);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        rec[R_JB + i] = jbar[i];
        rec[R_HB + i] = hbar[i];
        rec[R_MU + i] = r * mu[i];
#pragma unroll
        for (int j = 0; j < D; ++j) rec[R_ZZ + i * D + j] = r * (Cv[i][j] + mu[i] * mu[j]);
      }
    }
    __syncthreads();
    PHASE_MARK(7);

    // ---- 8: diagonal head backward per row: p = 1/(softplus(raw) + floor), h = mean·p.
    for (int n = tid; n < mp; n += NT) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float ob_mean = 0.0f, ob_raw = 0.0f;
        if (n < mc) {
          float pb = 0.0f, hb = 0.0f;
          for (int k = 0; k < K; ++k) {
            const float* rec = REC + (static_cast<long long>(n) * K + k) * RW;
            pb += rec[R_JB + i];
            hb += rec[R_HB + i];
          }
          const float p = PH[n * 2 * D + i];
          ob_mean = hb * p;
          ob_raw = -(pb + hb * OE[i * ldm + n]) * p * p * sigmoidf(OE[(D + i) * ldm + n]);
        }
        OBE[i * ldm + n] = ob_mean;
        OBE[(D + i) * ldm + n] = ob_raw;
      }
    }
    __syncthreads();
    PHASE_MARK(8);

    // ---- 9: encoder backward and its weight-gradient partial; the
    // statistics' and metrics' partials over the CTA's rows in order.
    gemm<kBf16>(OBE, 2 * D, enc.h2, ldm, mp, pw + enc.w3, true, nullptr, A2E, kDTanh, G2E);
    gemm<kBf16>(G2E, enc.h2, enc.h1, ldm, mp, pw + enc.w2, true, nullptr, A1E, kDTanh, G1E);
    weight_grads<kBf16>({X, G1E, DI, enc.h1, enc.w1, enc.b1},
                        {A1E, G2E, enc.h1, enc.h2, enc.w2, enc.b2},
                        {A2E, OBE, enc.h2, 2 * D, enc.w3, enc.b3}, ldm, mp, grad);
    for (int i = tid; i < K * FS; i += NT) {
      const int k = i / FS, f = i - k * FS;
      const int field = f == 0 ? R_R : R_MU + f - 1;
      float acc = 0.0f;
      for (int n = 0; n < mc; ++n) acc += REC[(static_cast<long long>(n) * K + k) * RW + field];
      spart[i] = acc;
    }
    if (tid == NT - 1) {
      float recon = 0.0f, local = 0.0f;
      for (int n = 0; n < mc; ++n) {
        recon += NSC[n * 3 + 0];
        local += NSC[n * 3 + 1];
      }
      spart[K * FS] = recon;
      spart[K * FS + 1] = local;
    }
    __syncthreads();
    PHASE_MARK(9);
    cl.sync();  // every CTA's partials are in its slab
    PHASE_MARK(PH_BAR1);

    // ---- 10: the slice's gradient over the cluster in rank order, Adam
    // (optax.adam, bias correction at the global count) and the broadcast;
    // the statistics and metrics summed in rank order by every CTA; CVI.
    float bc1, bc2;
    cs::adam_bias(a.adam_count + t + 1, bc1, bc2);
    const cs::SlabPart grads{slabs, lo.slab}, parts{slabs + lo.stats, lo.slab};
    cs::reduce_adam_broadcast<C, NT>(cl, grads, sp, sm, sv, p0, p1, a.lr, bc1, bc2,
                                     kBf16 ? smaster : nullptr,
                                     SharedCopy<kBf16>{a.enc, a.dec});
    cs::sum_ranks<C, NT>(parts, K * FS + 2, stot);
    __syncthreads();
    const float rho_t = static_cast<float>(
        a.rho0 / (1.0 + a.rho_decay * static_cast<double>(a.step0 + t)));
    for (int i = tid; i < K * F; i += NT) {
      const int k = i / F, c = i - k * F;
      const float* st = stot + k * FS;
      // [dir, η₁ (D), η₂, η₃ (D²), η₄] ← [count, s1, count, s2, count]
      float delta;
      if (c == 0 || c == 1 + D || c == F - 1) delta = st[0];
      else if (c <= D) delta = st[c];
      else delta = st[1 + D + (c - 2 - D)];
      snat[i] = (1.0f - rho_t) * snat[i] + rho_t * (a.prior[i] + scale * delta);
    }
    if (rank == 0 && tid == 0) {
      const float recon = stot[K * FS] * scale, local = stot[K * FS + 1] * scale;
      a.metrics[t * 4 + 0] = recon;
      a.metrics[t * 4 + 1] = local;
      a.metrics[t * 4 + 2] = -(recon - local) / a.num_total;
      a.metrics[t * 4 + 3] = rho_t;
    }
    __syncthreads();
    PHASE_MARK(10);
    cl.sync();  // every parameter copy is updated; the slabs may be reused
    PHASE_MARK(PH_BAR2);
  }

  for (int i = p0 + tid; i < p1; i += NT) {
    a.params[i] = kBf16 ? smaster[i - p0] : sp[i];
    a.m1[i] = sm[i - p0];
    a.m2[i] = sv[i - p0];
  }
  if (rank == 0)
    for (int i = tid; i < K * F; i += NT) a.nat[i] = snat[i];
  PHASE_MARK(PH_IO);
}

template <int D, int C, bool kBf16>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = Smem(a.g, C, kBf16).total * sizeof(float);
  return cs::launch_cluster(flexstep_kernel<D, C, kBf16>, C, NT, bytes, stream, a);
}

}  // namespace

// The instantiations, in three translation units that the kernel build
// compiles in parallel (SVAX_STEP_PART): this file, f32 at C = 16 and the C
// entries; flexstep_c8.cu, f32 at C = 8 (part 1); flexstep_bf16.cu, the
// bf16-product mode at C = 16 only (part 2: C = 8 is the slower on every
// shape and no entry selects it). The entries reach the other parts
// through flexstep_launch_c8 and flexstep_launch_bf16 (the Args of every
// part are one layout, from one source).
#if defined(SVAX_STEP_PART) && SVAX_STEP_PART != 0

// Part 1: f32 at C = 8; part 2: the bf16-product mode at C = 16. Each part
// has its own phase clocks (measure_steps.py adds the parts' slots).
#if SVAX_STEP_PART == 1
#define SVAX_STEP_LAUNCH flexstep_launch_c8
#define SVAX_STEP_CLOCKS flexstep_c8_phase_clocks
#else
#define SVAX_STEP_LAUNCH flexstep_launch_bf16
#define SVAX_STEP_CLOCKS flexstep_bf16_phase_clocks
#endif

extern "C" int SVAX_STEP_LAUNCH(const void* args, void* stream) {
  constexpr int C = SVAX_STEP_PART == 1 ? 8 : 16;
  constexpr bool kBf16 = SVAX_STEP_PART == 2;
  const Args& a = *static_cast<const Args*>(args);
  auto st = static_cast<cudaStream_t>(stream);
  switch (a.g.d) {
    case 2: return launch<2, C, kBf16>(a, st);
    case 3: return launch<3, C, kBf16>(a, st);
    case 4: return launch<4, C, kBf16>(a, st);
    case 5: return launch<5, C, kBf16>(a, st);
    case 6: return launch<6, C, kBf16>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

SVAX_PHASE_ENTRY(SVAX_STEP_CLOCKS)

#else

extern "C" int flexstep_launch_c8(const void* args, void* stream);
extern "C" int flexstep_launch_bf16(const void* args, void* stream);

namespace {

template <int D>
int launch(const Args& a, int cluster, int bf16, cudaStream_t stream) {
  if (bf16) {
    if (cluster == 16) return flexstep_launch_bf16(&a, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cluster == 8) return flexstep_launch_c8(&a, stream);
  if (cluster == 16) return launch<D, 16, false>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

long long flexstep_scratch_floats(int m, int d_in, int d, int k, int s, int h1e, int h2e,
                                  int h1d, int h2d, int cluster) {
  const Dims g{m, d_in, d, k, s, h1e, h2e, h1d, h2d};
  Dims gc = g;
  gc.m = static_cast<int>(cs::part_max(m, cluster));
  const Layout lo(gc);
  return cluster * (lo.cta + lo.slab);
}

// Dynamic shared memory of one CTA (svax_torch/ops/flexstep.py: smem_bytes).
long long flexstep_smem_bytes(int m, int d_in, int d, int k, int s, int h1e, int h2e,
                              int h1d, int h2d, int cluster, int bf16) {
  const Dims g{m, d_in, d, k, s, h1e, h2e, h1d, h2d};
  return Smem(g, cluster, bf16 != 0).total * static_cast<long long>(sizeof(float));
}

int flexstep_train_chunk(const float* batches, int m, int d_in, int d, int k, int s, int h1e,
                         int h2e, int h1d, int h2d, const float* prior, float* nat,
                         float* params, float* m1, float* m2, float* metrics, float* scratch,
                         const float* eps, int t_steps, int adam_count, int step0,
                         unsigned long long seed, float lr, double rho0, double rho_decay,
                         float num_total, int cluster, int bf16, void* stream) {
  const Dims g{m, d_in, d, k, s, h1e, h2e, h1d, h2d};
  const int widths[4] = {h1e, h2e, h1d, h2d};
  for (int w : widths)
    if (w < 1 || w > kMaxHidden) return static_cast<int>(cudaErrorInvalidValue);
  if (m < 1 || s < 1 || d_in < 1 || d_in > kMaxInput || k < 1 || k > kMaxComponents ||
      (cluster != 8 && cluster != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{batches, g,     prior,   nat,   params,     m1,    m2,
         metrics, scratch, eps,   t_steps, adam_count, step0, seed,
         lr,      rho0,  rho_decay, num_total};
  Dims gc = g;
  gc.m = static_cast<int>(cs::part_max(m, cluster));
  a.lo = Layout(gc);
  a.enc = Side(d_in, h1e, h2e, 2 * d, 0);
  a.dec = Side(d, h1d, h2d, 2 * d_in, a.enc.size);
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch<2>(a, cluster, bf16, st);
    case 3: return launch<3>(a, cluster, bf16, st);
    case 4: return launch<4>(a, cluster, bf16, st);
    case 5: return launch<5>(a, cluster, bf16, st);
    case 6: return launch<6>(a, cluster, bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

SVAX_PHASE_ENTRY(flexstep_phase_clocks)

}  // extern "C"

#endif  // SVAX_STEP_PART
