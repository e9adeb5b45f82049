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
// ONE thread block of 512 threads on ONE SM, as tinystep — that SM is the
// design limit. The state does not fit in one SM's shared memory at
// 100-100 (parameters, Adam m and v are 288 KB), so parameters, moments and
// gradients stay in global memory (L2-resident, updated in place) and each
// product stages its weight matrix — W or Wᵀ — into shared memory. Per-row
// data live feature-major in a global scratch buffer (row r of feature f at
// [f·ld + r]), so every product reads float4s of 8 consecutive rows:
// * products Out = act(In·W): a thread owns 8 rows × 4 columns, reads its
//   rows as two float4 and its columns as one float4 of shared memory;
// * weight gradients dW = Aᵀ·G (with a row of ones for the bias): a warp
//   owns a 4×4 block, its lanes stride over the rows with coalesced float4
//   loads, and the lanes' sums are added in lane order;
// * per-(n, k) combine work (forward, softmax, sampling, backward): one
//   thread per (n, k), D a template parameter, all in registers.
// No atomics, so two runs at one seed are bit-identical. f32 FMA on CUDA
// cores (no TF32). Spreading the rows over a cluster, and wgmma for the
// 100×100 products, is later work (PERF.md).
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "combine_tile.cuh"
#include "gmm_d2.cuh"
#include "philox.cuh"

namespace {

using namespace svax;  // combine_tile.cuh, digammaf (gmm_d2.cuh), philox_normal

constexpr int NT = 512;  // threads in the one block
constexpr int NW = NT / 32;  // its warps
constexpr int RED_LD = 17;   // a lane's 16 weight-gradient sums, padded against bank conflicts
constexpr int TM = 8;    // rows per product tile
constexpr int TN = 4;    // columns per product tile
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kVarFloor = 1e-6f;
constexpr float kB1 = 0.9f, kB2 = 0.999f, kAdamEps = 1e-8f;
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

// Offsets (floats) of the scratch buffers; every one starts on 16 bytes.
struct Layout {
  long long mp, r, rp;  // encoder rows padded; decoder rows K·S·M and padded
  long long x, a1e, a2e, oe, obe, g2e, g1e;  // encoder, feature-major, ld = mp
  long long z, a1d, a2d, od, obd, g2d, g1d, zb, ll;  // decoder, ld = rp
  long long ph, nsc, rec, grad, total;
  __host__ __device__ Layout(const Dims& g, int n_params) {
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
    grad = take(n_params);
    total = off;
  }
};

__host__ __device__ inline int n_params(const Dims& g) {
  const Side enc(g.d_in, g.h1e, g.h2e, 2 * g.d, 0);
  const Side dec(g.d, g.h1d, g.h2d, 2 * g.d_in, enc.size);
  return enc.size + dec.size;
}

// The largest weight matrix a product stages: Q × pad4(C) floats.
__host__ __device__ inline long long stage_floats(const Dims& g) {
  const long long qc[10][2] = {
      {g.d_in, g.h1e}, {g.h1e, g.h2e}, {g.h2e, 2 * g.d}, {2 * g.d, g.h2e}, {g.h2e, g.h1e},
      {g.d, g.h1d},    {g.h1d, g.h2d}, {g.h2d, 2 * g.d_in}, {2 * g.d_in, g.h2d}, {g.h2d, g.h1d}};
  long long most = 0;
  for (const auto& p : qc) most = p[0] * pad4(p[1]) > most ? p[0] * pad4(p[1]) : most;
  return most;
}

// Shared memory: the staged weights, then per component the expected
// parameters (slot row), the naturals, the prior and the statistics, then
// the weight-gradient reduction buffer.
struct Smem {
  long long stage, exp, nat, prior, stat, red, total;
  __host__ __device__ explicit Smem(const Dims& g) {
    const int f = 3 + g.d + g.d * g.d;
    stage = 0;
    exp = pad4(stage_floats(g));
    nat = exp + pad4(static_cast<long long>(g.k) * f);
    prior = nat + pad4(static_cast<long long>(g.k) * f);
    stat = prior + pad4(static_cast<long long>(g.k) * f);
    red = stat + pad4(static_cast<long long>(g.k) * (1 + g.d + g.d * g.d));
    total = red + NW * 32 * RED_LD;
  }
};

struct Args {
  const float* batches;  // (T, M, d_in)
  Dims g;
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
};

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

enum Epi { kBiasTanh, kBias, kDTanh, kNone };

// Out[c][r] = epi(Σ_q In[q][r]·B[q][c]) for r < rp, c < C, feature-major
// with row stride ld. B = W (Q×C row-major) or, with trans, Wᵀ for W (C×Q)
// row-major; it is staged into shared memory with rows padded to pad4(C).
// Epilogues: tanh(· + b), · + b, ·(1 − act²) (the tanh backward with act
// the layer's output), or none. All threads call; ends synchronised.
__device__ void gemm(const float* in, int Q, int C, long long ld, long long rp,
                     const float* W, bool trans, const float* bias, const float* act,
                     Epi epi, float* out, float* sb) {
  const int cp = static_cast<int>(pad4(C));
  for (int i = threadIdx.x; i < Q * cp; i += NT) {
    const int q = i / cp, c = i - q * cp;
    sb[i] = c < C ? (trans ? W[c * Q + q] : W[q * C + c]) : 0.0f;
  }
  __syncthreads();
  const int ncb = cp / TN;
  const long long tiles = rp / TM * ncb;
  for (long long t = threadIdx.x; t < tiles; t += NT) {
    const int c0 = static_cast<int>(t % ncb) * TN;
    const long long r0 = t / ncb * TM;
    float acc[TM][TN];
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) acc[x][y] = 0.0f;
    const float* a = in + r0;
    const float* b = sb + c0;
#pragma unroll 2
    for (int q = 0; q < Q; ++q) {
      const float4 a0 = ld4(a + q * ld), a1 = ld4(a + q * ld + 4);
      const float4 bq = *reinterpret_cast<const float4*>(b + q * cp);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {bq.x, bq.y, bq.z, bq.w};
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

// The three layers of one side in one pass: a warp owns a 4×4 block of one
// layer's [dW; db]; its lanes take 4 consecutive rows each, 128 rows per
// pass (every load a coalesced 512-byte float4 run), then the 32 lanes'
// partial sums are added in lane order through shared memory `red` (NW ·
// 32 · RED_LD floats), so the result does not depend on timing. Rows past
// the real ones carry G = 0. Every warp runs the same number of rounds, so
// the barriers are uniform. All threads call; ends synchronised.
__device__ void weight_grads(const WGrad& l0, const WGrad& l1, const WGrad& l2, long long ld,
                             long long rp, float* grad, float* red) {
  const WGrad* layers[3] = {&l0, &l1, &l2};
  int blocks[3], total = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    blocks[l] = ((layers[l]->q + 4) / 4) * ((layers[l]->c + 3) / 4);
    total += blocks[l];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 ones = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  float* mine = red + warp * 32 * RED_LD;
  for (int base = 0; base < total; base += NW) {
    const int task = base + warp;
    float acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
    const WGrad* L = nullptr;
    int i0 = 0, c0 = 0;
    if (task < total) {
      int l = 0, idx = task;
      while (idx >= blocks[l]) idx -= blocks[l++];
      L = layers[l];
      const int ncb = (L->c + 3) / 4;
      i0 = idx / ncb * 4;
      c0 = idx % ncb * 4;
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
      for (long long r = 4 * lane; r < rp; r += 128) {
        float4 av[4], gv[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          av[x] = arow[x] ? ld4(arow[x] + r) : aconst[x];
          gv[x] = grow[x] ? ld4(grow[x] + r) : zero;
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
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) mine[lane * RED_LD + e] = acc[e / 4][e % 4];
    __syncthreads();
    if (L != nullptr && lane < 16) {
      const int i = i0 + lane / 4, c = c0 + lane % 4;
      float sum = 0.0f;
      for (int l = 0; l < 32; ++l) sum += mine[l * RED_LD + lane];
      if (c < L->c && i < L->q) grad[L->w + i * L->c + c] = sum;
      else if (c < L->c && i == L->q) grad[L->b + c] = sum;
    }
    __syncthreads();
  }
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

template <int D>
__global__ void __launch_bounds__(NT, 1) flexstep_kernel(Args a) {
  constexpr int F = 3 + D + D * D;  // naturals and expected-parameter slots
  constexpr int FS = 1 + D + D * D;  // statistics: count, s1, s2
  constexpr int RW = rec_width(D);
  constexpr int R_ZZ = R_MU + D, R_JB = R_ZZ + D * D, R_HB = R_JB + D;
  static_assert(Slot<D>::SIZE == F, "the naturals and the slot rows share a width");
  const int tid = threadIdx.x;
  const Dims& g = a.g;
  const int M = g.m, K = g.k, S = g.s, DI = g.d_in;
  const int P = n_params(g);
  const Layout lo(g, P);
  const long long mp = lo.mp, rp = lo.rp, R = lo.r;
  const Side enc(DI, g.h1e, g.h2e, 2 * D, 0);
  const Side dec(D, g.h1d, g.h2d, 2 * DI, enc.size);

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem so(g);
  float* sb = smem + so.stage;
  float* sexp = smem + so.exp;
  float* snat = smem + so.nat;
  float* sprior = smem + so.prior;
  float* sstat = smem + so.stat;
  float* sred = smem + so.red;

  float* scr = a.scratch;
  float *X = scr + lo.x, *A1E = scr + lo.a1e, *A2E = scr + lo.a2e, *OE = scr + lo.oe,
        *OBE = scr + lo.obe, *G2E = scr + lo.g2e, *G1E = scr + lo.g1e;
  float *Z = scr + lo.z, *A1D = scr + lo.a1d, *A2D = scr + lo.a2d, *OD = scr + lo.od,
        *OBD = scr + lo.obd, *G2D = scr + lo.g2d, *G1D = scr + lo.g1d, *ZB = scr + lo.zb,
        *LL = scr + lo.ll;
  float *PH = scr + lo.ph, *NSC = scr + lo.nsc, *REC = scr + lo.rec, *grad = scr + lo.grad;
  const float* pw = a.params;  // both sides' offsets are into the one flat block

  for (int i = tid; i < K * F; i += NT) {
    snat[i] = a.nat[i];
    sprior[i] = a.prior[i];
  }
  __syncthreads();

  const float scale = a.num_total / static_cast<float>(M);
  const float lbar = scale / a.num_total;  // ∂neg_loss/∂(Σ_n local_n)
  const float rbar = -lbar;                // ∂neg_loss/∂(Σ_n Σ_k r̃·mean_s ll)
  const float inv_s = 1.0f / static_cast<float>(S);
  const float half_d_const = 0.5f * D * (1.0f + kLog2Pi);

  for (int t = 0; t < a.t_steps; ++t) {
    const float* xb = a.batches + static_cast<long long>(t) * M * DI;

    // ---- 0: the batch, feature-major; expected parameters of the pre-update naturals.
    for (long long i = tid; i < DI * mp; i += NT) {
      const int f = static_cast<int>(i / mp), n = static_cast<int>(i % mp);
      X[i] = n < M ? xb[n * DI + f] : 0.0f;
    }
    if (tid < K) expected_slots<D>(snat, K, tid, sexp + tid * F);
    __syncthreads();

    // ---- 1: encoder forward; the diagonal potential per row.
    gemm(X, DI, enc.h1, mp, mp, pw + enc.w1, false, pw + enc.b1, nullptr, kBiasTanh, A1E, sb);
    gemm(A1E, enc.h1, enc.h2, mp, mp, pw + enc.w2, false, pw + enc.b2, nullptr, kBiasTanh, A2E,
         sb);
    gemm(A2E, enc.h2, 2 * D, mp, mp, pw + enc.w3, false, pw + enc.b3, nullptr, kBias, OE, sb);
    for (int n = tid; n < M; n += NT) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float p = 1.0f / (softplusf(OE[(D + i) * mp + n]) + kVarFloor);
        PH[n * 2 * D + i] = p;
        PH[n * 2 * D + D + i] = OE[i * mp + n] * p;
      }
    }
    __syncthreads();

    // ---- 2: combine per (n, k): log ρ, the local-KL part, S samples.
    for (int q = tid; q < M * K; q += NT) {
      const int n = q / K, k = q - n * K;
      const float* e = sexp + k * F;
      float p[D], h[D], L[D][D], ht[D], mu[D], Li[D][D], C[D][D], logdet_j, log_rho;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        p[i] = PH[n * 2 * D + i];
        h[i] = PH[n * 2 * D + D + i];
      }
      tile_core<D>(e, p, h, L, ht, mu, logdet_j, log_rho);
      tri_inverse<D>(L, Li);
      cov_from_inverse<D>(Li, C);
      float* rec = REC + static_cast<long long>(q) * RW;
      rec[R_LOGR] = log_rho;
      rec[R_A] = local_a0<D>(e, mu, C, logdet_j);
      for (int s = 0; s < S; ++s) {
        float ep[D], u[D];
        draw_eps<D>(a, t, s, n, k, ep);
        solve_upper<D>(L, ep, u);
        const long long r = static_cast<long long>(q) * S + s;
#pragma unroll
        for (int i = 0; i < D; ++i) Z[i * rp + r] = mu[i] + u[i];
      }
    }
    for (long long i = tid; i < D * (rp - R); i += NT) Z[(i / (rp - R)) * rp + R + i % (rp - R)] = 0.0f;
    __syncthreads();

    // ---- 3: softmax over K per row; r̃ and a_nk.
    for (int n = tid; n < M; n += NT) {
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

    // ---- 4: decoder forward over K·S·M rows; log-likelihood and its cotangent.
    gemm(Z, D, dec.h1, rp, rp, pw + dec.w1, false, pw + dec.b1, nullptr, kBiasTanh, A1D, sb);
    gemm(A1D, dec.h1, dec.h2, rp, rp, pw + dec.w2, false, pw + dec.b2, nullptr, kBiasTanh, A2D,
         sb);
    gemm(A2D, dec.h2, 2 * DI, rp, rp, pw + dec.w3, false, pw + dec.b3, nullptr, kBias, OD, sb);
    for (long long r = tid; r < rp; r += NT) {
      if (r >= R) {
        LL[r] = 0.0f;
        for (int j = 0; j < 2 * DI; ++j) OBD[j * rp + r] = 0.0f;
        continue;
      }
      const long long q = r / S;
      const int n = static_cast<int>(q / K);
      const float llbar = rbar * REC[q * RW + R_R] * inv_s;
      float ll = 0.0f;
      for (int j = 0; j < DI; ++j) {
        const float o = OD[j * rp + r], raw = OD[(DI + j) * rp + r];
        const float var = softplusf(raw) + kVarFloor;
        const float diff = xb[n * DI + j] - o;
        ll += logf(var) + diff * diff / var + kLog2Pi;
        OBD[j * rp + r] = llbar * diff / var;
        OBD[(DI + j) * rp + r] =
            llbar * -0.5f * (1.0f / var - diff * diff / (var * var)) * sigmoidf(raw);
      }
      LL[r] = -0.5f * ll;
    }
    __syncthreads();

    // ---- 5: decoder backward to z̄; decoder weight gradients.
    gemm(OBD, 2 * DI, dec.h2, rp, rp, pw + dec.w3, true, nullptr, A2D, kDTanh, G2D, sb);
    gemm(G2D, dec.h2, dec.h1, rp, rp, pw + dec.w2, true, nullptr, A1D, kDTanh, G1D, sb);
    gemm(G1D, dec.h1, D, rp, rp, pw + dec.w1, true, nullptr, nullptr, kNone, ZB, sb);
    weight_grads({Z, G1D, D, dec.h1, dec.w1, dec.b1}, {A1D, G2D, dec.h1, dec.h2, dec.w2, dec.b2},
                 {A2D, OBD, dec.h2, 2 * DI, dec.w3, dec.b3}, rp, rp, grad, sred);

    // ---- 6: softmax backward per row (r̃ feeds recon weights and local KL).
    for (int n = tid; n < M; n += NT) {
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

    // ---- 7: combine backward per (n, k); the statistics' terms.
    for (int q = tid; q < M * K; q += NT) {
      const int n = q / K, k = q - n * K;
      const float* e = sexp + k * F;
      float p[D], h[D], L[D][D], ht[D], mu[D], Li[D][D], C[D][D], logdet_j, log_rho;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        p[i] = PH[n * 2 * D + i];
        h[i] = PH[n * 2 * D + D + i];
      }
      tile_core<D>(e, p, h, L, ht, mu, logdet_j, log_rho);
      tri_inverse<D>(L, Li);
      cov_from_inverse<D>(Li, C);
      float mubar[D], Lbar[D][D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        mubar[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j) Lbar[i][j] = 0.0f;
      }
      for (int s = 0; s < S; ++s) {
        float ep[D], u[D], zb[D], v[D];
        draw_eps<D>(a, t, s, n, k, ep);
        solve_upper<D>(L, ep, u);
        const long long r = static_cast<long long>(q) * S + s;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          zb[i] = ZB[i * rp + r];
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
      tile_core_bwd<D>(e, L, Li, C, mu, ht, mubar, Lbar, lbar * r, rhobar, jbar, hbar);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        rec[R_JB + i] = jbar[i];
        rec[R_HB + i] = hbar[i];
        rec[R_MU + i] = r * mu[i];
#pragma unroll
        for (int j = 0; j < D; ++j) rec[R_ZZ + i * D + j] = r * (C[i][j] + mu[i] * mu[j]);
      }
    }
    __syncthreads();

    // ---- 8: diagonal head backward per row: p = 1/(softplus(raw) + floor), h = mean·p.
    for (int n = tid; n < mp; n += NT) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float ob_mean = 0.0f, ob_raw = 0.0f;
        if (n < M) {
          float pb = 0.0f, hb = 0.0f;
          for (int k = 0; k < K; ++k) {
            const float* rec = REC + (static_cast<long long>(n) * K + k) * RW;
            pb += rec[R_JB + i];
            hb += rec[R_HB + i];
          }
          const float p = PH[n * 2 * D + i];
          ob_mean = hb * p;
          ob_raw = -(pb + hb * OE[i * mp + n]) * p * p * sigmoidf(OE[(D + i) * mp + n]);
        }
        OBE[i * mp + n] = ob_mean;
        OBE[(D + i) * mp + n] = ob_raw;
      }
    }
    __syncthreads();

    // ---- 9: encoder backward and weight gradients; statistics; metrics.
    gemm(OBE, 2 * D, enc.h2, mp, mp, pw + enc.w3, true, nullptr, A2E, kDTanh, G2E, sb);
    gemm(G2E, enc.h2, enc.h1, mp, mp, pw + enc.w2, true, nullptr, A1E, kDTanh, G1E, sb);
    weight_grads({X, G1E, DI, enc.h1, enc.w1, enc.b1}, {A1E, G2E, enc.h1, enc.h2, enc.w2, enc.b2},
                 {A2E, OBE, enc.h2, 2 * D, enc.w3, enc.b3}, mp, mp, grad, sred);
    for (int i = tid; i < K * FS; i += NT) {
      const int k = i / FS, f = i - k * FS;
      const int field = f == 0 ? R_R : R_MU + f - 1;
      float acc = 0.0f;
      for (int n = 0; n < M; ++n) acc += REC[(static_cast<long long>(n) * K + k) * RW + field];
      sstat[i] = acc;
    }
    __syncthreads();

    // ---- 10: Adam (optax.adam, bias correction at the global count); CVI.
    const int count = a.adam_count + t + 1;
    const float bc1 = static_cast<float>(1.0 - pow(0.9, static_cast<double>(count)));
    const float bc2 = static_cast<float>(1.0 - pow(0.999, static_cast<double>(count)));
    for (int i = tid; i < P; i += NT) {
      const float gr = grad[i];
      const float mm = (1.0f - kB1) * gr + kB1 * a.m1[i];
      const float vv = (1.0f - kB2) * gr * gr + kB2 * a.m2[i];
      a.m1[i] = mm;
      a.m2[i] = vv;
      a.params[i] -= a.lr * ((mm / bc1) / (sqrtf(vv / bc2) + kAdamEps));
    }
    const float rho_t = static_cast<float>(
        a.rho0 / (1.0 + a.rho_decay * static_cast<double>(a.step0 + t)));
    for (int i = tid; i < K * F; i += NT) {
      const int k = i / F, c = i - k * F;
      const float* st = sstat + k * FS;
      // [dir, η₁ (D), η₂, η₃ (D²), η₄] ← [count, s1, count, s2, count]
      float delta;
      if (c == 0 || c == 1 + D || c == F - 1) delta = st[0];
      else if (c <= D) delta = st[c];
      else delta = st[1 + D + (c - 2 - D)];
      snat[i] = (1.0f - rho_t) * snat[i] + rho_t * (sprior[i] + scale * delta);
    }
    if (tid == 0) {
      float recon = 0.0f, local = 0.0f;
      for (int n = 0; n < M; ++n) {
        recon += NSC[n * 3 + 0];
        local += NSC[n * 3 + 1];
      }
      recon *= scale;
      local *= scale;
      a.metrics[t * 4 + 0] = recon;
      a.metrics[t * 4 + 1] = local;
      a.metrics[t * 4 + 2] = -(recon - local) / a.num_total;
      a.metrics[t * 4 + 3] = rho_t;
    }
    __syncthreads();
  }

  for (int i = tid; i < K * F; i += NT) a.nat[i] = snat[i];
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = Smem(a.g).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flexstep_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  flexstep_kernel<D><<<1, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

long long flexstep_scratch_floats(int m, int d_in, int d, int k, int s, int h1e, int h2e,
                                  int h1d, int h2d) {
  const Dims g{m, d_in, d, k, s, h1e, h2e, h1d, h2d};
  return Layout(g, n_params(g)).total;
}

int flexstep_train_chunk(const float* batches, int m, int d_in, int d, int k, int s, int h1e,
                         int h2e, int h1d, int h2d, const float* prior, float* nat,
                         float* params, float* m1, float* m2, float* metrics, float* scratch,
                         const float* eps, int t_steps, int adam_count, int step0,
                         unsigned long long seed, float lr, double rho0, double rho_decay,
                         float num_total, void* stream) {
  const Dims g{m, d_in, d, k, s, h1e, h2e, h1d, h2d};
  const int widths[4] = {h1e, h2e, h1d, h2d};
  for (int w : widths)
    if (w < 1 || w > kMaxHidden) return static_cast<int>(cudaErrorInvalidValue);
  if (m < 1 || s < 1 || d_in < 1 || d_in > kMaxInput || k < 1 || k > kMaxComponents)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{batches, g,     prior,   nat,   params,     m1,    m2,
         metrics, scratch, eps,   t_steps, adam_count, step0, seed,
         lr,      rho0,  rho_decay, num_total};
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch<2>(a, st);
    case 3: return launch<3>(a, st);
    case 4: return launch<4>(a, st);
    case 5: return launch<5>(a, st);
    case 6: return launch<6>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
