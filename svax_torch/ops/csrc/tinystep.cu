// tinystep: T complete pinwheel-SVAE training steps in one kernel launch.
//
// Replaces the TPU kernel svax/ops/tinystep_pallas.py (_chunk_call →
// pallas_call, body _make_kernel/_step_math), for the GMM prior and, with
// dof > 0, the Student-t mixture (SMM) prior, with in-kernel input-noise
// augmentation. Each step, in order: encoder → closed-form 2×2 SIN combine
// (SMM: smm_iters u–z coordinate rounds from ū = 1, then a final z-update
// at ū = a/b) → reparameterised samples through the 2×2 Cholesky →
// Gaussian decoder over S·N·K rows and its log-likelihood → the local term
// (GMM: the closed-form local KL; SMM: Σ r̃(log r̃ − A) with A the
// per-component free energy) → CVI sufficient statistics (SMM: weighted by
// r̃ū, the counts by r̃) → a backward pass written by hand
// (svax_torch/ops/tinystep.py: step_grads_manual is the same formulas in
// PyTorch, tested against autograd; the SMM's runs back through every
// round, recomputing each round's z-update from ū = 1, unless the envelope
// switch holds q(u) constant) → Adam → CVI.
//
// Bound: the decoder's forward and backward, about 135 M FMA per step at
// the pinwheel shape (S·N·K = 16,000 rows through 2→50→50→4, activation
// and weight gradients). Design: ONE thread-block cluster of C = 8 or 16
// CTAs of 512 threads on neighbouring SMs (cluster_step.cuh), so the
// step-to-step dependence stays inside one launch while the rows spread
// over C SMs. CTA r owns a contiguous range of the N points, their (n,k)
// records and their S·K decoder rows: encoder, combine, softmax, sampling,
// decoder rows and the backward down to the encoder need only
// __syncthreads() inside the CTA. Each CTA keeps the parameters, its
// gradient partial, its statistics partial and the naturals in shared
// memory for the whole chunk, and its slice of both Adam moments; two
// cluster barriers a step bracket the ordered reduce-scatter, Adam and
// broadcast (cluster_step.cuh). Per-(n,k) records and per-row activations
// and cotangents live in global scratch (≈13 MB at the pinwheel shape,
// L2-resident), each CTA touching only its own points' rows.
// * Per record: the combine and its backward run one thread per (n,k)
//   record; the encoder, the softmax and the sums over k one thread per
//   point.
// * Rows: one decoder row (s, n, k) per thread in registers (hidden widths
//   are template parameters). The 50×50 products read padded shared copies
//   of W2 and W2ᵀ as float4 and are formed 32 output columns at a time
//   (mlp_fwd, mlp_bwd), each column the same sequential sum as a whole
//   product. A row's work is split into passes over the CTA's rows
//   (sampling; MLP forward; log-likelihood; MLP backward; sampling terms),
//   so that the slow-path calls of IEEE division and Philox's cosf sit in
//   passes without the products. Each row's sampling-backward terms go to
//   scratch and a per-(n,k) pass adds them over s in order.
// * Registers: 512 threads, 128 registers each, and no spills. Only the
//   rows' products may hold registers across a pass: the sizes, the
//   scratch pointer, the K-dependent shared offsets and the step index sit
//   in shared memory (Sizes), and what a CTA owns (its points, slice and
//   slabs) is derived afresh from them in each pass — in the passes with
//   the products, for each row (Own) — from volatile reads, so the
//   compiler hoists none of it out of the step loop.
// * Weight gradients: the three layers of a side come from ONE pass over
//   the CTA's rows in 32-row tiles, each tile loaded as float4 into
//   registers while the previous one is consumed from shared memory; each
//   thread owns one 3×4 block of one layer's gradient and sums it in row
//   order into the CTA's partial.
// f32 FMA on CUDA cores throughout (no TF32). kBf16 (the reference's
// nn_precision DEFAULT, single-pass bf16 MXU products): every product of
// the MLPs forward and backward — the rows' layers, z̄ and the weight
// gradients — takes bf16-rounded operands with the same f32 FMAs and
// order; the weights are rounded once a step into the shared copies
// (cluster_step.cuh: reduce_adam_broadcast's master), the activations and
// cotangents where a product reads them; the head, the combine, the
// biases' sums, Adam and CVI stay f32. Measured per-phase split and
// history: PERF.md (svax_torch/measure_steps.py).
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster_step.cuh"
#include "gmm_d2.cuh"
#include "philox.cuh"
#include "phase_clock.cuh"

namespace {

using namespace svax;  // gmm_d2.cuh: ExpSlot, digammaf, expected_d2
namespace cs = svax::cluster_step;
namespace cg = cooperative_groups;

constexpr int NT = 512;  // threads in each CTA of the cluster
constexpr int TR = 32;   // rows per weight-gradient tile
constexpr int ROW_TERMS = 6;  // per decoder row: ll, z̄ (2), the three L̃-bar terms
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kVarFloor = 1e-6f;

// Fields of the per-(n,k) record in scratch (N·K records). The SMM adds
// ū (UBAR), the Gamma rate b (GB), Q_nk of the final z-update (QF), the
// free energy A (AFREE) and J̃12's cotangent from the sampling (JB12);
// PB1..HB2 are the record's share of the potential's cotangents.
enum Plane {
  J11, J12, J22, DET, S11, S12, S22, MU1, MU2, HT1, HT2, L11, L21, L22,
  RESP, LRESP, ANK, SUMLL, MUB1, MUB2, JB11, JB22,
  UBAR, GB, QF, AFREE, JB12, PB1, PB2, HB1, HB2, NUM_PLANES
};

// Statistic slots per component: counts Σ r̃, u_counts Σ r̃ū (= counts for
// the GMM), then the ū-weighted moments.
enum StatSlot { ST_N, ST_U, ST_S1, ST_S2, ST_S11, ST_S12, ST_S22, NUM_STATS };

__host__ __device__ constexpr int side_floats(int h1, int h2) {
  return 2 * h1 + h1 + h1 * h2 + h2 + h2 * 4 + 4;
}

// Offsets inside one side's parameter block: W1 (2,H1), b1, W2 (H1,H2),
// b2, W3 (H2,4), b3 — the (in, out) row-major layout of svax/nets/mlp.py.
struct SideOff {
  int w1, b1, w2, b2, w3, b3;
  __host__ __device__ constexpr SideOff(int h1, int h2)
      : w1(0), b1(2 * h1), w2(3 * h1), b2(3 * h1 + h1 * h2),
        w3(3 * h1 + h1 * h2 + h2), b3(3 * h1 + h1 * h2 + 5 * h2) {}
};

// Both sides keep their per-row features — in(2) a1(H1) a2(H2) g1(H1)
// g2(H2) gout(4), F in all — in one row-blocked block: rows are grouped
// 32 at a time and a group stores its F features one after another, 32
// floats each, so feature f of row r sits at
// block[(r / 32)·F·32 + f·32 + r % 32]. A row's features are 32 floats
// apart, a warp's 32 consecutive rows fill whole 128-byte lines, and a
// 32-row tile of all features is one contiguous run for
// side_weight_grads. The encoder's block has N rows, the decoder's S·N·K.
__host__ __device__ constexpr int side_features(int h1, int h2) {
  return 2 + 2 * h1 + 2 * h2 + 4;
}

__host__ __device__ constexpr long long pad32(long long v) { return (v + 31) / 32 * 32; }

// Global scratch. Per point: the encoder outputs, recon and local terms;
// per (n,k) record NUM_PLANES floats (indexed by the global n·K + k); per
// CTA a slab of its encoder rows, its decoder rows (local row
// s·(nc·K) + (n − n0)·K + k for its nc points from n0) and its rows'
// sampling-backward terms, each slab sized for ⌈N/C⌉ points.
struct ScratchOff {
  long long enc, eo, recn, locn, lrsum, planes, terms, rows, total;
  long long enc_slab, terms_slab, rows_slab;
  long long nk;
  ScratchOff() = default;
  __host__ __device__ ScratchOff(int n, int k, int s, int h1, int h2, int c) {
    nk = static_cast<long long>(n) * k;
    const long long np = cs::part_max(n, c);  // points of the largest part
    const int f = side_features(h1, h2);
    enc_slab = f * pad32(np);
    terms_slab = pad32(ROW_TERMS * np * k * s);
    rows_slab = f * pad32(np * k * s);
    enc = 0;
    eo = enc + c * enc_slab;  // encoder outputs, (N, 4)
    recn = eo + pad32(4LL * n);
    locn = recn + pad32(n);
    lrsum = locn + pad32(n);
    planes = lrsum + pad32(n);
    terms = planes + pad32(NUM_PLANES * nk);
    rows = terms + c * terms_slab;
    total = rows + c * rows_slab;
  }
};

struct Args {
  const float* x;  // (N, 2)
  int n, k, s;
  const float* prior;  // (K, 9)
  float* nat;          // (K, 9), updated in place
  float* params;       // flat, updated in place
  float* m;
  float* v;
  float* metrics;  // (T, 3): recon, local_kl, neg_loss
  float* scratch;
  const float* eps;      // (T, S, N, K, 2) or null: in-kernel Philox
  const float* aug_eps;  // (T, N, 2) or null
  int t_steps;
  int adam_count;
  unsigned long long seed;
  float lr, rho, aug;
  // SMM prior when dof > 0: a₀ = b₀ = dof/2, a = a₀ + 1; psi_a = ψ(a) and
  // k_u = a₀ log b₀ − lnΓ(a₀) + a + lnΓ(a) + (1 − a)ψ(a), from the host.
  float dof;
  int smm_iters;  // u–z rounds (at least one is run)
  int smm_env;    // envelope gradients: q(u) held constant in the backward
  float psi_a, k_u;
  // Set by the host for the instantiation launched: the scratch layout and
  // the shared-memory regions whose place depends on K (floats from the
  // base; the kernel reads them from its Sizes).
  ScratchOff so;
  int o_nat, o_prior, o_exp, o_part, o_tot, o_tile;
  float rbar, lbar, inv_s;  // ∂neg_loss/∂recon = −1/N, ∂neg_loss/∂local = 1/N, 1/S
  float a0, ga;  // SMM: a₀ = b₀ = dof/2 and a = a₀ + 1
  int rounds;    // SMM: max(smm_iters, 1)
};

// One z-update of the 2×2 combine at E[u] = u: J̃ = diag(p) + u·E[Λ],
// h̃ = h + u·E[Λμ], Σ̃ = J̃⁻¹, μ̃ = Σ̃h̃.
struct ZUp {
  float j11, j12, j22, ht1, ht2, det, s11, s12, s22, mu1, mu2;
};

__device__ __forceinline__ ZUp z_update(const float* e, float p1, float p2, float h1,
                                        float h2, float u) {
  ZUp c;
  c.j11 = u * e[E_P11] + p1;
  c.j12 = u * e[E_P12];
  c.j22 = u * e[E_P22] + p2;
  c.ht1 = u * e[E_PM1] + h1;
  c.ht2 = u * e[E_PM2] + h2;
  c.det = c.j11 * c.j22 - c.j12 * c.j12;
  c.s11 = c.j22 / c.det;
  c.s12 = -c.j12 / c.det;
  c.s22 = c.j11 / c.det;
  c.mu1 = c.s11 * c.ht1 + c.s12 * c.ht2;
  c.mu2 = c.s12 * c.ht1 + c.s22 * c.ht2;
  return c;
}

// Q_nk = E[(z − μ_k)ᵀΛ_k(z − μ_k)] under q(z|n,k).
__device__ __forceinline__ float quad_latent(const float* e, const ZUp& c) {
  return e[E_P11] * (c.s11 + c.mu1 * c.mu1) + 2.0f * e[E_P12] * (c.s12 + c.mu1 * c.mu2) +
         e[E_P22] * (c.s22 + c.mu2 * c.mu2) - 2.0f * (e[E_PM1] * c.mu1 + e[E_PM2] * c.mu2) +
         e[E_QUAD];
}

// ū after r u-updates from ū = 1 (b₀, a as in Args).
__device__ __forceinline__ float u_after(const float* e, float p1, float p2, float h1,
                                         float h2, int r, float b0, float ga) {
  float u = 1.0f;
  for (int q = 0; q < r; ++q) u = ga / (b0 + 0.5f * quad_latent(e, z_update(e, p1, p2, h1, h2, u)));
  return u;
}

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// Row r of an F-feature row-blocked block (see ScratchOff); its feature f
// is at [f·32].
template <int F>
__device__ __forceinline__ float* row_at(float* block, long long r) {
  return block + (r >> 5) * (F * 32) + (r & 31);
}

// A row's features are walked with a pointer bumped behind an empty asm,
// so the compiler cannot see the addresses ahead of time: with plain
// constant offsets it moved these loads and stores far from their use
// and spilled the register file (21 KB of stack per thread).
__device__ __forceinline__ float* bump32(float* p) {
  p += 32;
  asm volatile("" : "+l"(p));
  return p;
}

template <int N>
__device__ __forceinline__ void put(float* row, int f0, const float (&v)[N]) {
  float* p = row + f0 * 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    *p = v[i];
    p = bump32(p);
  }
}

template <int N>
__device__ __forceinline__ void get(float* row, int f0, float (&v)[N]) {
  float* p = row + f0 * 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = *p;
    p = bump32(p);
  }
}

__host__ __device__ constexpr int pad4(int v) { return (v + 3) / 4 * 4; }

// out = in · W + b, W (I, J) row-major in shared memory; kBf16 rounds the
// inputs (W is rounded in its shared copy).
template <int I, int J, bool kBf16>
__device__ __forceinline__ void dense(const float (&in)[I], const float* W,
                                      const float* b, float (&out)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) out[j] = b[j];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float xi = cs::operand<kBf16>(in[i]);
#pragma unroll
    for (int j = 0; j < J; ++j) out[j] = fmaf(xi, W[i * J + j], out[j]);
  }
}

// The 50×50 products are computed CH output columns at a time, so that a
// thread holds its input and one chunk of outputs (50 + 32 floats), not
// both whole vectors: with the chunk stored before the next is begun, the
// rows fit the 128 registers of 512 threads without spilling (ptxas; 16-
// to 28-column chunks spill 4–124 bytes at 50-50, PERF.md). Each output
// is the same sequential sum over the input as a whole product.
constexpr int CH = 32;

// out[0, n) = (in · W + b)[c0, c0 + n), n = min(CH, J − c0), with W (I, J)
// in a shared copy whose rows are padded to pad4(J) floats (16-byte
// aligned, read as float4); b may be null; kBf16 rounds the inputs.
template <int I, int J, bool kBf16>
__device__ __forceinline__ void dense_chunk(const float (&in)[I], const float* W,
                                            const float* b, int c0, float (&out)[CH]) {
  constexpr int JP = pad4(J);
  const int n = J - c0 < CH ? J - c0 : CH;
#pragma unroll
  for (int j = 0; j < CH; ++j) out[j] = (b && j < n) ? b[c0 + j] : 0.0f;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float xi = cs::operand<kBf16>(in[i]);
    const float4* w = reinterpret_cast<const float4*>(W + i * JP + c0);
#pragma unroll
    for (int j4 = 0; j4 < CH / 4; ++j4) {
      if (4 * j4 >= n) break;
      const float4 q = w[j4];
      const float c[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * j4 + u < n) out[4 * j4 + u] = fmaf(xi, c[u], out[4 * j4 + u]);
    }
  }
}

// One side's MLP forward for one row: a1 = tanh(in·W1 + b1), a2 =
// tanh(a1·W2 + b2) (W2 from its padded copy w2p), out = a2·W3 + b3, with
// p the side's parameters (SideOff); a1 and a2 are stored to the row's
// features f_a1, f_a2 as they are formed, in f32. kBf16: every product
// takes bf16-rounded operands (the weights arrive rounded).
template <int H1, int H2, bool kBf16>
__device__ __forceinline__ void mlp_fwd(const float (&in)[2], const float* p, const float* w2p,
                                        float* row, int f_a1, int f_a2, float (&out)[4]) {
  constexpr SideOff off(H1, H2);
  float a1[H1];
  dense<2, H1, kBf16>(in, p + off.w1, p + off.b1, a1);
#pragma unroll
  for (int j = 0; j < H1; ++j) a1[j] = tanhf(a1[j]);
  put<H1>(row, f_a1, a1);
  const float4* w3 = reinterpret_cast<const float4*>(p + off.w3);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = p[off.b3 + j];
#pragma unroll
  for (int c0 = 0; c0 < H2; c0 += CH) {
    float a2[CH];
    dense_chunk<H1, H2, kBf16>(a1, w2p, p + off.b2, c0, a2);
    const int n = H2 - c0 < CH ? H2 - c0 : CH;
    float* dst = row + (f_a2 + c0) * 32;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j >= n) break;
      a2[j] = tanhf(a2[j]);
      *dst = a2[j];
      dst = bump32(dst);
      const float4 q = w3[c0 + j];
      const float a = cs::operand<kBf16>(a2[j]);
      out[0] = fmaf(a, q.x, out[0]);
      out[1] = fmaf(a, q.y, out[1]);
      out[2] = fmaf(a, q.z, out[2]);
      out[3] = fmaf(a, q.w, out[3]);
    }
  }
}

// One side's MLP backward for one row, from the output cotangent gout:
// g2 = (gout·W3ᵀ) ⊙ (1 − a2²), g1 = (g2·W2ᵀ) ⊙ (1 − a1²) (W2ᵀ from its
// padded copy w2tp), a1 and a2 read back from the row's features, g2 and
// g1 stored to f_g2 and f_g1; with zb, also z̄ = g1·W1ᵀ (two interleaved
// accumulators per input, as the whole product had). kBf16: the products
// take bf16-rounded cotangents (the weights arrive rounded); g1 and g2 are
// stored in f32.
template <int H1, int H2, bool kBf16>
__device__ __forceinline__ void mlp_bwd(const float (&gout)[4], const float* p,
                                        const float* w2tp, float* row, int f_a1, int f_a2,
                                        int f_g1, int f_g2, float* zb) {
  static_assert(CH % 2 == 0 && H1 % 2 == 0, "z̄'s accumulator pairs");
  constexpr SideOff off(H1, H2);
  const float4* w3 = reinterpret_cast<const float4*>(p + off.w3);
  float go[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) go[i] = cs::operand<kBf16>(gout[i]);
  float g2[H2];
  get<H2>(row, f_a2, g2);
#pragma unroll
  for (int j = 0; j < H2; ++j) {
    const float4 q = w3[j];
    const float g = fmaf(go[0], q.x, fmaf(go[1], q.y, fmaf(go[2], q.z, go[3] * q.w)));
    g2[j] = g * (1.0f - g2[j] * g2[j]);
  }
  put<H2>(row, f_g2, g2);
  float z0[2] = {0.0f, 0.0f}, z1[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c0 = 0; c0 < H1; c0 += CH) {
    float g1[CH];
    dense_chunk<H2, H1, kBf16>(g2, w2tp, nullptr, c0, g1);
    const int n = H1 - c0 < CH ? H1 - c0 : CH;
    const float* src = row + (f_a1 + c0) * 32;
    float* dst = row + (f_g1 + c0) * 32;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j >= n) break;
      const float a = *src;
      src = bump32(const_cast<float*>(src));
      g1[j] *= 1.0f - a * a;
      *dst = g1[j];
      dst = bump32(dst);
    }
    if (zb) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < CH; j += 2) {
          if (j >= n) break;
          z0[i] = fmaf(cs::operand<kBf16>(g1[j]), p[off.w1 + i * H1 + c0 + j], z0[i]);
          z1[i] = fmaf(cs::operand<kBf16>(g1[j + 1]), p[off.w1 + i * H1 + c0 + j + 1],
                       z1[i]);
        }
    }
  }
  if (zb) {
    zb[0] = z0[0] + z1[0];
    zb[1] = z0[1] + z1[1];
  }
}

__host__ __device__ constexpr int pad3(int v) { return (v + 2) / 3 * 3; }

// Row layout of the shared tile that side_weight_grads consumes: the
// three A groups (inputs of each layer plus a row of ones, which yields
// the bias gradient) padded to multiples of 3 rows; the G groups (output
// cotangents) padded to multiples of 4 and stored "y-major" — feature j
// of a G group at row (j % 4)·NB + j / 4 — so that the g-blocks a warp
// reads at one y sit in consecutive rows (distinct shared-memory banks).
// A tile row holds 32 data rows in LD = 36 floats (16-byte aligned).
template <int H1, int H2>
struct Tile {
  static constexpr int LD = 36;
  static constexpr int Z = 0;                   // z0 z1 1
  static constexpr int A1 = 3;                  // a1 … 1
  static constexpr int A2 = A1 + pad3(H1 + 1);  // a2 … 1
  static constexpr int G1 = A2 + pad3(H2 + 1);  // g1, y-major
  static constexpr int G2 = G1 + pad4(H1);      // g2, y-major
  static constexpr int OB = G2 + pad4(H2);      // gout (4)
  static constexpr int ROWS = OB + 4;
  static constexpr int NA1 = pad3(H1 + 1) / 3, NA2 = pad3(H2 + 1) / 3;  // a-blocks
  static constexpr int NG1 = pad4(H1) / 4, NG2 = pad4(H2) / 4;          // g-blocks
  // Warps: dW2's NA1×NG2 blocks in warp tiles of 4 a-blocks × 8 g-blocks,
  // then one warp for dW3 (NA2 blocks) and dW1 (NG1 blocks).
  static constexpr int W2_WARPS = ((NA1 + 3) / 4) * ((NG2 + 7) / 8);
  static constexpr int F = side_features(H1, H2);
  static constexpr int LPV = (F * 8 + NT - 1) / NT;  // float4s loaded per thread
  __device__ static int g_row(int base, int nb, int j) { return base + (j & 3) * nb + (j >> 2); }
  // Tile row of feature f of the per-row block.
  __device__ static int row_of(int f) {
    if (f < 2) return Z + f;
    f -= 2;
    if (f < H1) return A1 + f;
    f -= H1;
    if (f < H2) return A2 + f;
    f -= H2;
    if (f < H1) return g_row(G1, NG1, f);
    f -= H1;
    if (f < H2) return g_row(G2, NG2, f);
    return OB + f - H2;
  }
};

// This thread's float4s of the 32-row tile starting at row r0 of the
// row-blocked F-feature block `cols`, zero for rows past R (dst < 0: none).
template <int F, int LPV>
__device__ __forceinline__ void load_tile(const float* cols, long long R, long long r0,
                                          const int (&dst)[LPV], const int (&row0)[LPV],
                                          float4 (&pre)[LPV]) {
  const float4* src = reinterpret_cast<const float4*>(cols + (r0 >> 5) * (F * 32));
#pragma unroll
  for (int u = 0; u < LPV; ++u) {
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (dst[u] >= 0) q = src[cs::thread_index() + u * NT];
    const long long left = R - r0 - row0[u];  // rows of this float4 that exist
    if (left < 4) {
      if (left < 1) q.x = 0.0f;
      if (left < 2) q.y = 0.0f;
      if (left < 3) q.z = 0.0f;
      q.w = 0.0f;
    }
    pre[u] = q;
  }
}

// Every weight and bias gradient of one side's MLP (2 → H1 → H2 → 4) in
// ONE pass over its R rows: dW[i, j] = Σ_r A[i, r]·G[j, r] per layer, from
// the row-blocked block `cols` (see ScratchOff). Each 32-row tile is one
// contiguous run of F·32 floats; the next one is loaded as float4 into
// registers while the current one is consumed from shared memory, and
// rows past R read as zero. A thread owns one 3×4 block of one layer's
// gradient and reads its A and G rows as float4 (4 data rows at a time),
// summing in row order. Result goes to the side's gradient block in the
// parameter layout. All threads call. kBf16: the weight gradients take
// bf16-rounded operands — A rounded as the tile is stored, G as it is
// read — while a bias gradient stays the f32 sum of G (the reference's
// bias cotangent is a sum, not a product), kept beside in accb.
template <int H1, int H2, bool kBf16>
__device__ void side_weight_grads(const float* cols, long long R, float* grad,
                                  float* tile) {
  using T = Tile<H1, H2>;
  static_assert((T::W2_WARPS + 1) * 32 <= NT, "one block per thread");
  static_assert(T::NA2 + T::NG1 <= 32, "dW3 and dW1 share one warp");
  static_assert(TR == 32, "tiles are the 32-row groups of the block");
  constexpr SideOff off(H1, H2);
  constexpr int LD = T::LD;
  const int tid = cs::thread_index(), warp = tid >> 5, lane = tid & 31;

  // This thread's block: layer (1, 2, 3 or 0 = idle), a-block, g-block.
  int layer = 0, ab = 0, gb = 0;
  if (warp < T::W2_WARPS) {
    constexpr int WG = (T::NG2 + 7) / 8;  // warp tiles along g
    ab = (warp / WG) * 4 + (lane >> 3);
    gb = (warp % WG) * 8 + (lane & 7);
    if (ab < T::NA1 && gb < T::NG2) layer = 2;
  } else if (warp == T::W2_WARPS) {
    if (lane < T::NA2) {
      layer = 3;
      ab = lane;
    } else if (lane < T::NA2 + T::NG1) {
      layer = 1;
      gb = lane - T::NA2;
    }
  }
  int a_off = 0, g_off[4] = {0, 0, 0, 0};
  if (layer == 2) a_off = (T::A1 + 3 * ab) * LD;
  if (layer == 3) a_off = (T::A2 + 3 * ab) * LD;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    if (layer == 2) g_off[y] = (T::G2 + y * T::NG2 + gb) * LD;
    if (layer == 3) g_off[y] = (T::OB + y) * LD;
    if (layer == 1) g_off[y] = (T::G1 + y * T::NG1 + gb) * LD;
  }

  // Constant rows: ones closing each A group, zeros padding the rest.
  for (int c = tid; c < LD; c += NT) {
    tile[(T::Z + 2) * LD + c] = 1.0f;
    tile[(T::A1 + H1) * LD + c] = 1.0f;
    for (int rr = T::A1 + H1 + 1; rr < T::A2; ++rr) tile[rr * LD + c] = 0.0f;
    tile[(T::A2 + H2) * LD + c] = 1.0f;
    for (int rr = T::A2 + H2 + 1; rr < T::G1; ++rr) tile[rr * LD + c] = 0.0f;
    for (int j = H1; j < pad4(H1); ++j) tile[T::g_row(T::G1, T::NG1, j) * LD + c] = 0.0f;
    for (int j = H2; j < pad4(H2); ++j) tile[T::g_row(T::G2, T::NG2, j) * LD + c] = 0.0f;
  }
  // Where each of this thread's float4s lands (4 consecutive rows of one
  // feature), the same for every tile; -1 past the tile.
  int dst[T::LPV], row0[T::LPV];
  bool a_group[T::LPV];  // a feature of the A groups (in, a1, a2)
#pragma unroll
  for (int u = 0; u < T::LPV; ++u) {
    const int v = tid + u * NT;
    row0[u] = (v & 7) * 4;
    dst[u] = v < T::F * 8 ? T::row_of(v >> 3) * LD + row0[u] : -1;
    a_group[u] = (v >> 3) < 2 + H1 + H2;
  }
  float4 pre[T::LPV];

  float acc[3][4], accb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;

  load_tile<T::F, T::LPV>(cols, R, 0, dst, row0, pre);
  for (long long r0 = 0; r0 < R; r0 += TR) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int u = 0; u < T::LPV; ++u)
      if (dst[u] >= 0)
        *reinterpret_cast<float4*>(tile + dst[u]) =
            kBf16 && a_group[u] ? cs::bf16_round4(pre[u]) : pre[u];
    __syncthreads();
    if (r0 + TR < R) load_tile<T::F, T::LPV>(cols, R, r0 + TR, dst, row0, pre);
    if (layer != 0) {
#pragma unroll 2
      for (int rq = 0; rq < TR; rq += 4) {
        float4 av[3], gv[4];
#pragma unroll
        for (int x = 0; x < 3; ++x)
          av[x] = *reinterpret_cast<const float4*>(tile + a_off + x * LD + rq);
#pragma unroll
        for (int y = 0; y < 4; ++y)
          gv[y] = *reinterpret_cast<const float4*>(tile + g_off[y] + rq);
        if (kBf16) {
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            accb[y] = accb[y] + gv[y].x + gv[y].y + gv[y].z + gv[y].w;
            gv[y] = cs::bf16_round4(gv[y]);
          }
        }
#pragma unroll
        for (int x = 0; x < 3; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            acc[x][y] = fmaf(av[x].x, gv[y].x, acc[x][y]);
            acc[x][y] = fmaf(av[x].y, gv[y].y, acc[x][y]);
            acc[x][y] = fmaf(av[x].z, gv[y].z, acc[x][y]);
            acc[x][y] = fmaf(av[x].w, gv[y].w, acc[x][y]);
          }
      }
    }
  }
  __syncthreads();
  if (layer == 0) return;
  // Scatter the block into the parameter layout (W (in, out), then b).
  int w, b, in, out, i0, j0;
  if (layer == 2) {
    w = off.w2; b = off.b2; in = H1; out = H2;
    i0 = 3 * ab; j0 = 4 * gb;
  } else if (layer == 3) {
    w = off.w3; b = off.b3; in = H2; out = 4;
    i0 = 3 * ab; j0 = 0;
  } else {
    w = off.w1; b = off.b1; in = 2; out = H1;
    i0 = 0; j0 = 4 * gb;
  }
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = i0 + x, j = j0 + y;
      if (i > in || j >= out) continue;
      if (i < in) grad[w + i * out + j] = acc[x][y];
      else grad[b + j] = kBf16 ? accb[y] : acc[x][y];
    }
}

// The value of flat parameter i in the CTAs' shared copies: in the
// bf16-product mode a weight is rounded to bf16 (once a step, as the update
// is broadcast) and a bias stays f32; else the f32 value.
template <int H1, int H2, bool kBf16>
struct SharedCopy {
  __device__ float operator()(long long i, float p) const {
    if (!kBf16) return p;
    constexpr SideOff off(H1, H2);
    const int j = static_cast<int>(i % side_floats(H1, H2));
    const bool bias = (j >= off.b1 && j < off.w2) || (j >= off.b2 && j < off.w3) || j >= off.b3;
    return bias ? p : cs::bf16_round(p);
  }
};

// Shared memory of one CTA, in floats; every region a multiple of 4 floats
// (the tile and the W2 copies are read as float4). svax_torch/ops/tinystep.py:
// smem_bytes is its Python twin.
template <int H1, int H2, bool kBf16>
struct Shape {
  static constexpr int P_SIDE = side_floats(H1, H2);
  static constexpr int P = 2 * P_SIDE;
  static constexpr int H1P = pad4(H1), H2P = pad4(H2);  // padded W2 / W2ᵀ rows
  __host__ __device__ static int slice(int c) { return pad4((P + c - 1) / c); }
  __host__ __device__ static int part_floats(int k) { return pad4(NUM_STATS * k + 2); }
  // Slices of the flat parameters a CTA keeps: Adam's m and v, and in the
  // bf16-product mode the f32 master of its slice.
  static constexpr int SLICES = kBf16 ? 3 : 2;
  // params, gradient partial, the slice's m and v (and master), the W2 and
  // W2ᵀ copies of both sides, then (K-dependent) the naturals, prior,
  // expected parameters, the statistics partial and its total, the tile.
  static void place(int k, int c, Args& a) {
    a.o_nat = 2 * P + SLICES * slice(c) + 2 * (H1 * H2P + H2 * H1P);
    a.o_prior = a.o_nat + pad4(9 * k);
    a.o_exp = a.o_prior + pad4(9 * k);
    a.o_part = a.o_exp + pad4(NUM_EXP * k);
    a.o_tot = a.o_part + part_floats(k);
    a.o_tile = a.o_tot + part_floats(k);
  }
  static size_t smem_floats(int k, int c) {
    Args a{};
    place(k, c, a);
    return a.o_tile + Tile<H1, H2>::ROWS * Tile<H1, H2>::LD;
  }
};

// The sizes, the scratch buffer, the shared regions' K-dependent offsets
// (Shape::place) and the step index: copied into the CTA's shared memory
// at the start and read where they are used (volatile loads, in Own), so
// that neither they nor what is derived from them sit in registers across
// the rows' products, which need all 128.
struct Sizes {
  int n, k, s, step;
  int o_nat, o_prior, o_exp, o_part, o_tot, o_tile;
  float* scr;
};

// What this CTA owns (cluster_step.cuh: part_begin): points [n0, n1), their
// nq = (n1 − n0)·K records from n0·K and rl = S·nq decoder rows, the flat
// parameters [p0, p1), and its slabs of scratch. Built at the top of every
// pass (in the passes with the MLP products, of every row) from volatile
// reads of the thread index, the rank and the Sizes, so that nothing
// derived from them is hoisted out of the step loop or held across a pass.
template <int C, int P>
struct Own {
  int tid, rank, n, k, s, n0, n1, nq, rl, p0, p1;
  float* scr;  // the scratch buffer
  __device__ __forceinline__ Own(const Args& a, const volatile Sizes& z)
      : tid(cs::thread_index()), rank(cs::cluster_rank()), n(z.n), k(z.k), s(z.s),
        scr(z.scr) {
    n0 = static_cast<int>(cs::part_begin(n, C, rank));
    n1 = static_cast<int>(cs::part_begin(n, C, rank + 1));
    nq = (n1 - n0) * k;
    rl = nq * s;
    p0 = static_cast<int>(cs::part_begin(P, C, rank));
    p1 = static_cast<int>(cs::part_begin(P, C, rank + 1));
  }
  __device__ __forceinline__ float* enc(const Args& a) const {  // its encoder rows
    return scr + a.so.enc + rank * a.so.enc_slab;
  }
  __device__ __forceinline__ float* dec(const Args& a) const {  // its decoder rows
    return scr + a.so.rows + rank * a.so.rows_slab;
  }
  __device__ __forceinline__ float* terms(const Args& a) const {  // (rl, ROW_TERMS)
    return scr + a.so.terms + rank * a.so.terms_slab;
  }
  // Per point (every CTA's): encoder outputs (N, 4), recon and local terms,
  // Σ_k ∂/∂log r̃; the N·K records of NUM_PLANES floats.
  __device__ __forceinline__ float4* eo(const Args& a) const {
    return reinterpret_cast<float4*>(scr + a.so.eo);
  }
  __device__ __forceinline__ float* recn(const Args& a) const { return scr + a.so.recn; }
  __device__ __forceinline__ float* locn(const Args& a) const { return scr + a.so.locn; }
  __device__ __forceinline__ float* lrsum(const Args& a) const { return scr + a.so.lrsum; }
  __device__ __forceinline__ float* pl(const Args& a) const { return scr + a.so.planes; }
  // The shared region at a K-dependent offset (a field of Sizes).
  __device__ __forceinline__ static float* at(float* smem, const volatile int& off) {
    return smem + off;
  }
};

// Phase-clock slots (svax_torch/measure_steps.py names them).
enum TinyPhase {
  PH_A, PH_B, PH_ROWS, PH_ROWSUM, PH_D, PH_E, PH_BAR1, PH_F, PH_BAR2, PH_IO,
  PH_B2, PH_B3, PH_D2, PH_D3
};

// Each pass below is a block of its own that builds its Own (and reads
// the K-dependent shared regions through Own::at): only the step counter
// lives across passes.
template <int H1, int H2, int C, bool kBf16>
__global__ void __launch_bounds__(NT, 1) tinystep_kernel(Args a) {
  using Sh = Shape<H1, H2, kBf16>;
  using O = Own<C, Sh::P>;
  constexpr int P_SIDE = Sh::P_SIDE, P = Sh::P, H1P = Sh::H1P, H2P = Sh::H2P;
  constexpr SideOff off(H1, H2);
  static_assert(P_SIDE % 4 == 0 && off.w3 % 4 == 0, "W3 rows must be 16-byte aligned");
  PHASE_START;

  cg::cluster_group cl = cg::this_cluster();

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sp = smem;                    // params (every CTA's copy identical)
  float* sg = sp + P;                  // this CTA's gradient partial
  float* sm = sg + P;                  // Adam m of the slice [p0, p1)
  float* sv = sm + Sh::slice(C);       // Adam v of the slice
  float* smaster = sv + Sh::slice(C);  // kBf16: the slice's f32 parameters
  float* sw2e = sv + (Sh::SLICES - 1) * Sh::slice(C);  // padded W2 and W2ᵀ per side
  float* sw2d = sw2e + H1 * H2P;       // (16-byte rows, read as float4)
  float* sw2te = sw2d + H1 * H2P;
  float* sw2td = sw2te + H2 * H1P;
  // K-dependent (O::at, offsets in Sizes): the naturals (K, 9) at o_nat,
  // the prior at o_prior, the expected parameters (K, NUM_EXP) at o_exp, the partial
  // (K, NUM_STATS) + recon, local at o_part, the same summed over the
  // cluster at o_tot, side_weight_grads' tile at o_tile.

  constexpr int F = side_features(H1, H2);
  // Feature offsets inside a row of either side's row-blocked block.
  constexpr int F_IN = 0, F_A1 = 2, F_A2 = 2 + H1, F_G1 = 2 + H1 + H2,
                F_G2 = 2 + 2 * H1 + H2, F_GO = 2 + 2 * H1 + 2 * H2;
  const float* encp = sp;
  const float* decp = sp + P_SIDE;

  __shared__ Sizes sz;
  if (threadIdx.x == 0)
    sz = Sizes{a.n, a.k, a.s, 0, a.o_nat, a.o_prior, a.o_exp, a.o_part, a.o_tot, a.o_tile,
               a.scratch};
  __syncthreads();
  const auto step = [&] { return *static_cast<volatile int*>(&sz.step); };
  {
    const O o(a, sz);
    const SharedCopy<H1, H2, kBf16> copy;
    for (int i = o.tid; i < P; i += NT) sp[i] = copy(i, a.params[i]);
    for (int i = o.p0 + o.tid; i < o.p1; i += NT) {
      sm[i - o.p0] = a.m[i];
      sv[i - o.p0] = a.v[i];
      if (kBf16) smaster[i - o.p0] = a.params[i];
    }
    float *snat = O::at(smem, sz.o_nat), *sprior = O::at(smem, sz.o_prior);
    for (int i = o.tid; i < o.k * 9; i += NT) {
      snat[i] = a.nat[i];
      sprior[i] = a.prior[i];
    }
    __syncthreads();
    PHASE_MARK(PH_IO);
  }

  while (step() < a.t_steps) {
    // ---- A: expected parameters from the pre-update naturals; W2 copies.
    {
      const O o(a, sz);
      const int tid = o.tid;
      for (int i = tid; i < H1 * H2P; i += NT) {
        const int r = i / H2P, c = i % H2P;
        sw2e[i] = c < H2 ? encp[off.w2 + r * H2 + c] : 0.0f;
        sw2d[i] = c < H2 ? decp[off.w2 + r * H2 + c] : 0.0f;
      }
      for (int i = tid; i < H2 * H1P; i += NT) {
        const int r = i / H1P, c = i % H1P;
        sw2te[i] = c < H1 ? encp[off.w2 + c * H2 + r] : 0.0f;
        sw2td[i] = c < H1 ? decp[off.w2 + c * H2 + r] : 0.0f;
      }
      if (tid < o.k)
        expected_d2(O::at(smem, sz.o_nat), o.k, tid, O::at(smem, sz.o_exp) + tid * NUM_EXP);
      __syncthreads();
      PHASE_MARK(PH_A);
    }

    // ---- B: augmentation and encoder (per n), in two passes over the same
    // points (each thread its own): the noise (Philox's cosf has a
    // slow-path call), then the MLP, so that no call sits in a loop with
    // the 50-wide products and spills around them.
    {
      const O o(a, sz);
      const int n0 = o.n0, n1 = o.n1;
      float* enc_rows = o.enc(a);
      const float aug = a.aug;
      for (int n = n0 + o.tid; n < n1; n += NT) {
        float xin[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          float xi = 0.0f;
          if (aug > 0.0f) {
            const int t = step();
            xi = a.aug_eps ? a.aug_eps[(static_cast<long long>(t) * o.n + n) * 2 + d]
                           : svax::philox_normal(a.seed, static_cast<uint32_t>(t) + (1u << 30),
                                                 static_cast<uint32_t>(n * 2 + d));
          }
          xin[d] = a.x[n * 2 + d] + aug * xi;
        }
        put<2>(row_at<F>(enc_rows, n - n0), F_IN, xin);
      }
    }
    for (int i = cs::thread_index();; i += NT) {  // i: the point's index in the CTA
      float* erow;
      {
        const O o(a, sz);
        if (i >= o.n1 - o.n0) break;
        erow = row_at<F>(o.enc(a), i);
      }
      float xin[2], out[4];
      get<2>(erow, F_IN, xin);
      mlp_fwd<H1, H2, kBf16>(xin, encp, sw2e, erow, F_A1, F_A2, out);
      const O o(a, sz);
      o.eo(a)[o.n0 + i] = make_float4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();
    PHASE_MARK(PH_B);

    // ---- B': the combine per (n,k) record: log ρ before the softmax.
    {
      const O o(a, sz);
      float4* eo = o.eo(a);
      float* pl = o.pl(a);
      const float* sexp = O::at(smem, sz.o_exp);
      const int n0 = o.n0, nq = o.nq, K = o.k;
      const bool smm = a.dof > 0.0f;
      const float b0 = a.a0, ga = a.ga;
      for (int ql = o.tid; ql < nq; ql += NT) {
        const long long q = n0 * static_cast<long long>(K) + ql;
        const int n = static_cast<int>(q / K), k = static_cast<int>(q % K);
        const float4 o4 = eo[n];
        const float p1 = 1.0f / (softplusf(o4.z) + kVarFloor);
        const float p2 = 1.0f / (softplusf(o4.w) + kVarFloor);
        const float h1 = o4.x * p1, h2 = o4.y * p2;
        const float* e = sexp + k * NUM_EXP;
        float* rec = pl + q * NUM_PLANES;
        if (smm) {
          // u–z rounds, then the final z-update at ū = a/b.
          const float a0 = a.a0;
          float u = 1.0f, gb = b0;
          for (int r = 0; r < a.rounds; ++r) {
            gb = b0 + 0.5f * quad_latent(e, z_update(e, p1, p2, h1, h2, u));
            u = ga / gb;
          }
          const ZUp c = z_update(e, p1, p2, h1, h2, u);
          const float qf = quad_latent(e, c);
          const float log_gb = logf(gb), logdet_j = logf(c.det);
          const float e_log_u = a.psi_a - log_gb;
          const float u_free = a.k_u + (a0 - 1.0f) * e_log_u - b0 * u - log_gb;
          const float l11 = sqrtf(c.j11), l21 = c.j12 / l11;
          rec[J11] = c.j11; rec[J12] = c.j12; rec[J22] = c.j22; rec[DET] = c.det;
          rec[S11] = c.s11; rec[S12] = c.s12; rec[S22] = c.s22;
          rec[MU1] = c.mu1; rec[MU2] = c.mu2; rec[HT1] = c.ht1; rec[HT2] = c.ht2;
          rec[L11] = l11; rec[L21] = l21; rec[L22] = sqrtf(c.j22 - l21 * l21);
          rec[LRESP] = e[E_LOGPI] + e_log_u - kLog2Pi + 0.5f * e[E_LOGDET] -
                       0.5f * u * e[E_QUAD] + 0.5f * (c.mu1 * c.ht1 + c.mu2 * c.ht2) -
                       0.5f * logdet_j + u_free;
          rec[UBAR] = u; rec[GB] = gb; rec[QF] = qf;
          rec[AFREE] = e[E_LOGPI] + e_log_u - kLog2Pi + 0.5f * e[E_LOGDET] - 0.5f * u * qf +
                       (1.0f + kLog2Pi) - 0.5f * logdet_j + u_free;
          continue;
        }
        const float j11 = e[E_P11] + p1, j12 = e[E_P12], j22 = e[E_P22] + p2;
        const float ht1 = e[E_PM1] + h1, ht2 = e[E_PM2] + h2;
        const float det = j11 * j22 - j12 * j12;
        const float s11 = j22 / det, s12 = -j12 / det, s22 = j11 / det;
        const float mu1 = s11 * ht1 + s12 * ht2, mu2 = s12 * ht1 + s22 * ht2;
        const float l11 = sqrtf(j11), l21 = j12 / l11;
        rec[J11] = j11; rec[J12] = j12; rec[J22] = j22; rec[DET] = det;
        rec[S11] = s11; rec[S12] = s12; rec[S22] = s22;
        rec[MU1] = mu1; rec[MU2] = mu2; rec[HT1] = ht1; rec[HT2] = ht2;
        rec[L11] = l11; rec[L21] = l21; rec[L22] = sqrtf(j22 - l21 * l21);
        rec[LRESP] = e[E_LOGPI] + 0.5f * e[E_LOGDET] - 0.5f * e[E_QUAD] +
                     0.5f * (mu1 * ht1 + mu2 * ht2) - 0.5f * logf(det);
      }
      __syncthreads();
      PHASE_MARK(PH_B2);
    }

    // ---- B'': softmax over K and the local-KL terms (per n).
    {
      const O o(a, sz);
      float *pl = o.pl(a), *locn = o.locn(a);
      const float* sexp = O::at(smem, sz.o_exp);
      const int n0 = o.n0, n1 = o.n1, K = o.k;
      const bool smm = a.dof > 0.0f;
      for (int n = n0 + o.tid; n < n1; n += NT) {
        float* recs = pl + static_cast<long long>(n) * K * NUM_PLANES;
        float row_max = -3.0e38f;
        for (int k = 0; k < K; ++k) row_max = fmaxf(row_max, recs[k * NUM_PLANES + LRESP]);
        float se = 0.0f;
        for (int k = 0; k < K; ++k) se += expf(recs[k * NUM_PLANES + LRESP] - row_max);
        const float lse = row_max + logf(se);
        float local_n = 0.0f;
        for (int k = 0; k < K; ++k) {
          const float* e = sexp + k * NUM_EXP;
          float* rec = recs + k * NUM_PLANES;
          const float log_resp = rec[LRESP] - lse;
          const float resp = expf(log_resp);
          float ank;
          if (smm) {
            ank = log_resp - rec[AFREE];
          } else {
            const float mu1 = rec[MU1], mu2 = rec[MU2];
            const float g_k = 0.5f * e[E_LOGDET] - kLog2Pi - 0.5f * e[E_QUAD];
            const float cross = e[E_PM1] * mu1 + e[E_PM2] * mu2;
            const float tr = e[E_P11] * rec[S11] + 2.0f * e[E_P12] * rec[S12] +
                             e[E_P22] * rec[S22];
            const float qmu = e[E_P11] * mu1 * mu1 + 2.0f * e[E_P12] * mu1 * mu2 +
                              e[E_P22] * mu2 * mu2;
            const float e_log_pbar = e[E_LOGPI] + g_k + cross - 0.5f * (tr + qmu);
            ank = log_resp - (1.0f + kLog2Pi) + 0.5f * logf(rec[DET]) - e_log_pbar;
          }
          rec[LRESP] = log_resp;
          rec[RESP] = resp;
          rec[ANK] = ank;
          local_n += resp * ank;
        }
        locn[n] = local_n;
      }
      __syncthreads();
      PHASE_MARK(PH_B3);
    }

    // ---- C: sampling, decoder forward + activation backward, one row
    // (s, n, k) per thread; local row lr = s·nq + (n − n0)·K + k. Five
    // passes over the same rows (each thread its own, so no barrier between
    // them): the sampling, the MLP forward, the log-likelihood and its
    // cotangent, the MLP backward, the sampling's backward terms. The IEEE
    // divisions' and Philox's slow-path calls sit in the passes without the
    // 50-wide products, which then keep every register.
    {
      const O o(a, sz);
      const float* pl = o.pl(a);
      const int n0 = o.n0, nq = o.nq, rl = o.rl, K = o.k;
      float *dec_rows = o.dec(a), *terms = o.terms(a);
      for (int lr = o.tid; lr < rl; lr += NT) {
        const int s = lr / nq;
        const long long q = n0 * static_cast<long long>(K) + (lr - s * nq);
        const int n = static_cast<int>(q / K), k = static_cast<int>(q % K);
        const float* rec = pl + q * NUM_PLANES;
        float e1, e2;
        const long long ei = ((static_cast<long long>(s) * o.n + n) * K + k) * 2;
        const int t = step();
        if (a.eps) {
          const float* ep = a.eps + static_cast<long long>(t) * o.s * a.so.nk * 2 + ei;
          e1 = ep[0];
          e2 = ep[1];
        } else {
          e1 = svax::philox_normal(a.seed, static_cast<uint32_t>(t), static_cast<uint32_t>(ei));
          e2 = svax::philox_normal(a.seed, static_cast<uint32_t>(t), static_cast<uint32_t>(ei + 1));
        }
        const float u2 = e2 / rec[L22];
        const float u1 = (e1 - rec[L21] * u2) / rec[L11];
        float* tm = terms + static_cast<long long>(lr) * ROW_TERMS;
        tm[4] = u1;  // the backward terms need u: parked in the row's terms
        tm[5] = u2;
        const float z[2] = {rec[MU1] + u1, rec[MU2] + u2};
        put<2>(row_at<F>(dec_rows, lr), F_IN, z);
      }
    }
    for (int lr = cs::thread_index();; lr += NT) {
      float* row;
      {
        const O o(a, sz);
        if (lr >= o.rl) break;
        row = row_at<F>(o.dec(a), lr);
      }
      float z[2], out[4];
      get<2>(row, F_IN, z);
      mlp_fwd<H1, H2, kBf16>(z, decp, sw2d, row, F_A1, F_A2, out);
      put<4>(row, F_GO, out);  // the output until the next pass makes it ō
    }
    {
      const O o(a, sz);
      const float* pl = o.pl(a);
      const int n0 = o.n0, nq = o.nq, K = o.k;
      float *enc_rows = o.enc(a), *dec_rows = o.dec(a), *terms = o.terms(a);
      const float rbar = a.rbar, inv_s = a.inv_s;
      for (int lr = o.tid; lr < o.rl; lr += NT) {
        const int s = lr / nq;
        const long long q = n0 * static_cast<long long>(K) + (lr - s * nq);
        const int n = static_cast<int>(q / K);
        float* row = row_at<F>(dec_rows, lr);
        float out[4];
        get<4>(row, F_GO, out);
        const float* erow = row_at<F>(enc_rows, n - n0);
        const float x0 = erow[F_IN * 32], x1 = erow[(F_IN + 1) * 32];
        const float llbar = rbar * pl[q * NUM_PLANES + RESP] * inv_s;
        const float va = softplusf(out[2]) + kVarFloor;
        const float vb = softplusf(out[3]) + kVarFloor;
        const float da = x0 - out[0], db = x1 - out[1];
        terms[static_cast<long long>(lr) * ROW_TERMS] =
            -0.5f * (logf(va) + da * da / va + logf(vb) + db * db / vb + 2.0f * kLog2Pi);
        const float ob[4] = {
            llbar * da / va,
            llbar * db / vb,
            llbar * -0.5f * (1.0f / va - da * da / (va * va)) * sigmoidf(out[2]),
            llbar * -0.5f * (1.0f / vb - db * db / (vb * vb)) * sigmoidf(out[3]),
        };
        put<4>(row, F_GO, ob);
      }
    }
    for (int lr = cs::thread_index();; lr += NT) {
      float* row;
      {
        const O o(a, sz);
        if (lr >= o.rl) break;
        row = row_at<F>(o.dec(a), lr);
      }
      float ob[4], zb[2];
      get<4>(row, F_GO, ob);
      mlp_bwd<H1, H2, kBf16>(ob, decp, sw2td, row, F_A1, F_A2, F_G1, F_G2, zb);
      const O o(a, sz);
      float* tm = o.terms(a) + static_cast<long long>(lr) * ROW_TERMS;
      tm[1] = zb[0];
      tm[2] = zb[1];
    }
    {
      const O o(a, sz);
      const float* pl = o.pl(a);
      const int n0 = o.n0, nq = o.nq, K = o.k;
      float* terms = o.terms(a);
      for (int lr = o.tid; lr < o.rl; lr += NT) {
        const int s = lr / nq;
        const long long q = n0 * static_cast<long long>(K) + (lr - s * nq);
        const float* rec = pl + q * NUM_PLANES;
        const float l11 = rec[L11], l21 = rec[L21], l22 = rec[L22];
        float* tm = terms + static_cast<long long>(lr) * ROW_TERMS;
        const float u1 = tm[4], u2 = tm[5];
        const float u1b = tm[1];
        const float u2b = tm[2] - u1b * l21 / l11;
        tm[3] = u1b * u1 / l11;
        tm[4] = u1b * u2 / l11;
        tm[5] = u2b * u2 / l22;
      }
      __syncthreads();
      PHASE_MARK(PH_ROWS);
    }

    // ---- C': per (n,k), the rows' terms added over s in order; back
    // through L̃ = chol(J̃): l22 = √(j22 − l21²), l21 = j12/l11, l11 = √j11.
    {
      const O o(a, sz);
      float* pl = o.pl(a);
      const int n0 = o.n0, nq = o.nq, K = o.k, S = o.s;
      const bool smm = a.dof > 0.0f;
      const float* terms = o.terms(a);
      for (int ql = o.tid; ql < nq; ql += NT) {
        float* rec = pl + (n0 * static_cast<long long>(K) + ql) * NUM_PLANES;
        const float l11 = rec[L11], l21 = rec[L21], l22 = rec[L22];
        float sum_ll = 0.0f, mub1 = 0.0f, mub2 = 0.0f;
        float l11b = 0.0f, l21b = 0.0f, l22b = 0.0f;
        for (int s = 0; s < S; ++s) {
          const float* tm = terms + static_cast<long long>(s * nq + ql) * ROW_TERMS;
          sum_ll += tm[0];
          mub1 += tm[1];
          mub2 += tm[2];
          l11b -= tm[3];
          l21b -= tm[4];
          l22b -= tm[5];
        }
        const float jb22 = l22b / (2.0f * l22);
        l21b -= l22b * l21 / l22;
        if (smm) rec[JB12] = l21b / l11;  // J̃12 = ū·E[Λ]12 moves with ū
        l11b -= l21b * l21 / l11;
        rec[SUMLL] = sum_ll;
        rec[MUB1] = mub1;
        rec[MUB2] = mub2;
        rec[JB11] = l11b / (2.0f * l11);
        rec[JB22] = jb22;
      }
      __syncthreads();
      PHASE_MARK(PH_ROWSUM);
    }

    // ---- D: the softmax backward's per-point sums.
    {
      const O o(a, sz);
      float *pl = o.pl(a), *recn = o.recn(a), *lrsum = o.lrsum(a);
      const int n0 = o.n0, n1 = o.n1, K = o.k;
      const float rbar = a.rbar, lbar = a.lbar, inv_s = a.inv_s;
      for (int n = n0 + o.tid; n < n1; n += NT) {
        float* recs = pl + static_cast<long long>(n) * K * NUM_PLANES;
        float sum_lr = 0.0f, recon_n = 0.0f;
        for (int k = 0; k < K; ++k) {
          float* rec = recs + k * NUM_PLANES;
          const float resp = rec[RESP];
          recon_n += resp * rec[SUMLL];
          const float respbar = rbar * rec[SUMLL] * inv_s + lbar * rec[ANK];
          const float lrbar = lbar * resp + respbar * resp;
          rec[ANK] = lrbar;  // ANK is dead from here on
          sum_lr += lrbar;
        }
        recn[n] = recon_n * inv_s;
        lrsum[n] = sum_lr;
      }
      __syncthreads();
      PHASE_MARK(PH_D);
    }

    // ---- D': local-KL and combine backward per (n,k) record: the record's
    // share of the potential's cotangents p̄ and h̄.
    {
      const O o(a, sz);
      float4* eo = o.eo(a);
      float *pl = o.pl(a), *lrsum = o.lrsum(a);
      const float* sexp = O::at(smem, sz.o_exp);
      const int n0 = o.n0, nq = o.nq, K = o.k;
      const bool smm = a.dof > 0.0f;
      const float lbar = a.lbar;
      for (int ql = o.tid; ql < nq; ql += NT) {
        const long long q = n0 * static_cast<long long>(K) + ql;
        const int n = static_cast<int>(q / K), k = static_cast<int>(q % K);
        const float* e = sexp + k * NUM_EXP;
        float* rec = pl + q * NUM_PLANES;
        const float resp = rec[RESP];
        const float rhobar = rec[ANK] - resp * lrsum[n];
        float p1b, p2b, h1b, h2b;
        if (smm) {
          // The final z-update: the local term's −½ū·Q_f scales the GMM's
          // μ̃/Σ̃ cotangents by ū; J̃12 = ū·E[Λ]12 now has one too.
          const float u = rec[UBAR];
          const float mu1 = rec[MU1], mu2 = rec[MU2];
          const float ht1 = rec[HT1], ht2 = rec[HT2];
          const float s11 = rec[S11], s12 = rec[S12], s22 = rec[S22];
          const float j11 = rec[J11], j12 = rec[J12], j22 = rec[J22], det = rec[DET];
          const float w = lbar * resp, uw = u * w;
          float mu1b = rec[MUB1] + uw * (-e[E_PM1] + e[E_P11] * mu1 + e[E_P12] * mu2) +
                       0.5f * rhobar * ht1;
          float mu2b = rec[MUB2] + uw * (-e[E_PM2] + e[E_P12] * mu1 + e[E_P22] * mu2) +
                       0.5f * rhobar * ht2;
          float s11b = 0.5f * uw * e[E_P11] + mu1b * ht1;
          float s12b = uw * e[E_P12] + mu1b * ht2 + mu2b * ht1;
          float s22b = 0.5f * uw * e[E_P22] + mu2b * ht2;
          const float ht1b = 0.5f * rhobar * mu1 + s11 * mu1b + s12 * mu2b;
          const float ht2b = 0.5f * rhobar * mu2 + s12 * mu1b + s22 * mu2b;
          const float detb =
              (0.5f * w - 0.5f * rhobar - (s11b * s11 + s12b * s12 + s22b * s22)) / det;
          const float j11b = rec[JB11] + s22b / det + detb * j22;
          const float j22b = rec[JB22] + s11b / det + detb * j11;
          const float j12b = rec[JB12] - s12b / det - 2.0f * detb * j12;
          p1b = j11b;
          p2b = j22b;
          h1b = ht1b;
          h2b = ht2b;
          if (!a.smm_env) {
            // Full chain: ū and b of the final update (log ρ and A carry
            // −(a/b)·log b, −½ū·E[μᵀΛμ] resp. −½ū·Q_f, and −b₀ū), then back
            // through every round; ū_r = a/b_{r−1} hands −ū̄_r·ū_r²/a to the
            // round before.
            const float b0 = a.a0, ga = a.ga;
            const float4 o4 = eo[n];
            const float p1 = 1.0f / (softplusf(o4.z) + kVarFloor);
            const float p2 = 1.0f / (softplusf(o4.w) + kVarFloor);
            const float h1 = o4.x * p1, h2 = o4.y * p2;
            const float gb = rec[GB];
            const float ub = -rhobar * (0.5f * e[E_QUAD] + b0) + w * (0.5f * rec[QF] + b0) +
                             j11b * e[E_P11] + j12b * e[E_P12] + j22b * e[E_P22] +
                             ht1b * e[E_PM1] + ht2b * e[E_PM2];
            float bb = -(rhobar - w) * ga / gb - ub * ga / (gb * gb);
            for (int r = a.rounds - 1; r >= 0; --r) {
              const float ur = u_after(e, p1, p2, h1, h2, r, b0, ga);
              const ZUp c = z_update(e, p1, p2, h1, h2, ur);
              const float qb = 0.5f * bb;
              const float m1 = 2.0f * qb * (e[E_P11] * c.mu1 + e[E_P12] * c.mu2 - e[E_PM1]);
              const float m2 = 2.0f * qb * (e[E_P12] * c.mu1 + e[E_P22] * c.mu2 - e[E_PM2]);
              const float sb11 = qb * e[E_P11] + m1 * c.ht1;
              const float sb12 = 2.0f * qb * e[E_P12] + m1 * c.ht2 + m2 * c.ht1;
              const float sb22 = qb * e[E_P22] + m2 * c.ht2;
              const float hb1 = c.s11 * m1 + c.s12 * m2, hb2 = c.s12 * m1 + c.s22 * m2;
              const float db = -(sb11 * c.s11 + sb12 * c.s12 + sb22 * c.s22) / c.det;
              const float jb11 = sb22 / c.det + db * c.j22;
              const float jb22 = sb11 / c.det + db * c.j11;
              const float jb12 = -sb12 / c.det - 2.0f * db * c.j12;
              p1b += jb11;
              p2b += jb22;
              h1b += hb1;
              h2b += hb2;
              bb = -(jb11 * e[E_P11] + jb12 * e[E_P12] + jb22 * e[E_P22] + hb1 * e[E_PM1] +
                     hb2 * e[E_PM2]) * ur * ur / ga;
            }
          }
        } else {
          const float mu1 = rec[MU1], mu2 = rec[MU2];
          const float ht1 = rec[HT1], ht2 = rec[HT2];
          const float s11 = rec[S11], s12 = rec[S12], s22 = rec[S22];
          const float j11 = rec[J11], j22 = rec[J22], det = rec[DET];
          const float w = lbar * resp;
          float mu1b = rec[MUB1] + w * (-e[E_PM1] + e[E_P11] * mu1 + e[E_P12] * mu2);
          float mu2b = rec[MUB2] + w * (-e[E_PM2] + e[E_P12] * mu1 + e[E_P22] * mu2);
          float s11b = 0.5f * w * e[E_P11];
          float s12b = w * e[E_P12];
          float s22b = 0.5f * w * e[E_P22];
          const float logdetb = 0.5f * w - 0.5f * rhobar;
          mu1b += 0.5f * rhobar * ht1;
          mu2b += 0.5f * rhobar * ht2;
          h1b = 0.5f * rhobar * mu1 + s11 * mu1b + s12 * mu2b;
          h2b = 0.5f * rhobar * mu2 + s12 * mu1b + s22 * mu2b;
          s11b += mu1b * ht1;
          s12b += mu1b * ht2 + mu2b * ht1;
          s22b += mu2b * ht2;
          const float detb = (logdetb - (s11b * s11 + s12b * s12 + s22b * s22)) / det;
          p1b = rec[JB11] + s22b / det + detb * j22;
          p2b = rec[JB22] + s11b / det + detb * j11;
        }
        rec[PB1] = p1b;
        rec[PB2] = p2b;
        rec[HB1] = h1b;
        rec[HB2] = h2b;
      }
      __syncthreads();
      PHASE_MARK(PH_D2);
    }

    // ---- D'': the records' p̄, h̄ added over k in order; the diagonal head
    // (p = 1/(softplus(raw) + floor), h = mean·p) and the encoder backward
    // (per n), the MLP in a pass of its own.
    {
      const O o(a, sz);
      float4* eo = o.eo(a);
      const float* pl = o.pl(a);
      const int n0 = o.n0, n1 = o.n1, K = o.k;
      float* enc_rows = o.enc(a);
      for (int n = n0 + o.tid; n < n1; n += NT) {
        const float* recs = pl + static_cast<long long>(n) * K * NUM_PLANES;
        float p1b = 0.0f, p2b = 0.0f, h1b = 0.0f, h2b = 0.0f;
        for (int k = 0; k < K; ++k) {
          const float* rec = recs + k * NUM_PLANES;
          p1b += rec[PB1];
          p2b += rec[PB2];
          h1b += rec[HB1];
          h2b += rec[HB2];
        }
        const float4 o4 = eo[n];
        const float out[4] = {o4.x, o4.y, o4.z, o4.w};
        float go[4];
        const float hb[2] = {h1b, h2b}, pb[2] = {p1b, p2b};
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const float p = 1.0f / (softplusf(out[2 + d]) + kVarFloor);
          go[d] = hb[d] * p;
          const float varb = -(pb[d] + hb[d] * out[d]) * p * p;
          go[2 + d] = varb * sigmoidf(out[2 + d]);
        }
        float* erow = row_at<F>(enc_rows, n - n0);
        put<4>(erow, F_GO, go);
      }
    }
    for (int i = cs::thread_index();; i += NT) {  // i: the point's index in the CTA
      float* erow;
      {
        const O o(a, sz);
        if (i >= o.n1 - o.n0) break;
        erow = row_at<F>(o.enc(a), i);
      }
      float go[4];
      get<4>(erow, F_GO, go);
      mlp_bwd<H1, H2, kBf16>(go, encp, sw2te, erow, F_A1, F_A2, F_G1, F_G2, nullptr);
    }
    __syncthreads();
    PHASE_MARK(PH_D3);

    // ---- E: this CTA's partials: statistics, metrics, every weight gradient.
    {
      const O o(a, sz);
      const int tid = o.tid, K = o.k;
      if (tid <= K) {
        const float* pl = o.pl(a);
        float* spart = O::at(smem, sz.o_part);
        const int n0 = o.n0, n1 = o.n1;
        if (tid < K) {
          const bool smm = a.dof > 0.0f;
          float st[NUM_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          for (int n = n0; n < n1; ++n) {
            const float* rec = pl + (static_cast<long long>(n) * K + tid) * NUM_PLANES;
            const float r = rec[RESP], mu1 = rec[MU1], mu2 = rec[MU2];
            const float ru = smm ? r * rec[UBAR] : r;
            st[ST_N] += r;
            st[ST_U] += ru;
            st[ST_S1] += ru * mu1;
            st[ST_S2] += ru * mu2;
            st[ST_S11] += ru * (rec[S11] + mu1 * mu1);
            st[ST_S12] += ru * (rec[S12] + mu1 * mu2);
            st[ST_S22] += ru * (rec[S22] + mu2 * mu2);
          }
#pragma unroll
          for (int i = 0; i < NUM_STATS; ++i) spart[tid * NUM_STATS + i] = st[i];
        } else {
          const float *recn = o.recn(a), *locn = o.locn(a);
          float recon = 0.0f, local = 0.0f;
          for (int n = n0; n < n1; ++n) {
            recon += recn[n];
            local += locn[n];
          }
          spart[K * NUM_STATS] = recon;
          spart[K * NUM_STATS + 1] = local;
        }
      }
    }
    {
      const O o(a, sz);
      side_weight_grads<H1, H2, kBf16>(o.dec(a), o.rl, sg + P_SIDE, O::at(smem, sz.o_tile));
    }
    {
      const O o(a, sz);
      side_weight_grads<H1, H2, kBf16>(o.enc(a), o.n1 - o.n0, sg, O::at(smem, sz.o_tile));
      __syncthreads();
      PHASE_MARK(PH_E);
    }
    cl.sync();  // every CTA's partials are complete
    PHASE_MARK(PH_BAR1);

    // ---- F: the slice's gradient over the cluster in rank order, Adam
    // (optax.adam, bias correction at the global count) and the broadcast;
    // the statistics and metrics summed in rank order by every CTA; CVI.
    {
      const O o(a, sz);
      const int tid = o.tid, K = o.k;
      const int t = step();
      float bc1, bc2;
      cs::adam_bias(a.adam_count + t + 1, bc1, bc2);
      const cs::SharedPart grads{&cl, sg}, parts{&cl, O::at(smem, sz.o_part)};
      float* stot = O::at(smem, sz.o_tot);
      cs::reduce_adam_broadcast<C, NT>(cl, grads, sp, sm, sv, o.p0, o.p1, a.lr, bc1, bc2,
                                       kBf16 ? smaster : nullptr,
                                       SharedCopy<H1, H2, kBf16>());
      cs::sum_ranks<C, NT>(parts, K * NUM_STATS + 2, stot);
      __syncthreads();
      if (tid < K) {
        const float* st = stot + tid * NUM_STATS;
        float *snat = O::at(smem, sz.o_nat), *sprior = O::at(smem, sz.o_prior);
        // Slot 3 (η₂) takes Σ r̃ū: the counts for the GMM.
        const float delta[9] = {st[ST_N], st[ST_S1], st[ST_S2], st[ST_U], st[ST_S11],
                                st[ST_S12], st[ST_S12], st[ST_S22], st[ST_N]};
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          float* slot = snat + tid * 9 + c;
          *slot = (1.0f - a.rho) * *slot + a.rho * (sprior[tid * 9 + c] + delta[c]);
        }
      }
      if (tid == 0 && o.rank == 0) {
        const float recon = stot[K * NUM_STATS], local = stot[K * NUM_STATS + 1];
        a.metrics[t * 3 + 0] = recon;
        a.metrics[t * 3 + 1] = local;
        a.metrics[t * 3 + 2] = -(recon - local) / static_cast<float>(o.n);
      }
      __syncthreads();
      if (tid == 0) sz.step = t + 1;  // every read of this step's index is done
      PHASE_MARK(PH_F);
    }
    cl.sync();  // every parameter copy is updated; the partials may be reused
    PHASE_MARK(PH_BAR2);
  }

  const O o(a, sz);
  for (int i = o.p0 + o.tid; i < o.p1; i += NT) {
    a.params[i] = kBf16 ? smaster[i - o.p0] : sp[i];
    a.m[i] = sm[i - o.p0];
    a.v[i] = sv[i - o.p0];
  }
  if (o.rank == 0) {
    const float* snat = O::at(smem, sz.o_nat);
    for (int i = o.tid; i < o.k * 9; i += NT) a.nat[i] = snat[i];
  }
  PHASE_MARK(PH_IO);
}

template <int H1, int H2, int C, bool kBf16>
int launch(const Args& args, cudaStream_t stream) {
  Args a = args;
  a.so = ScratchOff(a.n, a.k, a.s, H1, H2, C);
  a.rbar = -1.0f / static_cast<float>(a.n);
  a.lbar = 1.0f / static_cast<float>(a.n);
  a.inv_s = 1.0f / static_cast<float>(a.s);
  a.a0 = 0.5f * a.dof;
  a.ga = a.a0 + 1.0f;
  a.rounds = a.smm_iters > 1 ? a.smm_iters : 1;
  Shape<H1, H2, kBf16>::place(a.k, C, a);
  const size_t bytes = Shape<H1, H2, kBf16>::smem_floats(a.k, C) * sizeof(float);
  return cs::launch_cluster(tinystep_kernel<H1, H2, C, kBf16>, C, NT, bytes, stream, a);
}

// The instantiations, in three translation units that the kernel build
// compiles in parallel (SVAX_STEP_PART): this file, f32 at C = 16 and the C
// entries; tinystep_c8.cu, f32 at C = 8 (part 1); tinystep_bf16.cu, the
// bf16-product mode at C = 16 only (part 2: C = 8 is the slower on every
// shape and no entry selects it). The entries reach the other parts
// through tinystep_launch_c8 and tinystep_launch_bf16 (the Args of every
// part are one layout, from one source).
template <int H1, int H2>
int launch(const Args& a, int cluster, int bf16, cudaStream_t stream);

template <int H1, int H2>
long long smem_bytes(int k, int cluster, int bf16) {
  const size_t floats = bf16 ? Shape<H1, H2, true>::smem_floats(k, cluster)
                             : Shape<H1, H2, false>::smem_floats(k, cluster);
  return static_cast<long long>(floats * sizeof(float));
}

__global__ void philox_normals_kernel(unsigned long long seed, uint32_t base,
                                      float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = svax::philox_normal(seed, base, static_cast<uint32_t>(i));
}

}  // namespace

#if defined(SVAX_STEP_PART) && SVAX_STEP_PART != 0

// Part 1: f32 at C = 8; part 2: the bf16-product mode at C = 16. Each part
// has its own phase clocks (measure_steps.py adds the parts' slots).
#if SVAX_STEP_PART == 1
#define SVAX_STEP_LAUNCH tinystep_launch_c8
#define SVAX_STEP_CLOCKS tinystep_c8_phase_clocks
#else
#define SVAX_STEP_LAUNCH tinystep_launch_bf16
#define SVAX_STEP_CLOCKS tinystep_bf16_phase_clocks
#endif

extern "C" int SVAX_STEP_LAUNCH(const void* args, int h1, int h2, void* stream) {
  constexpr int C = SVAX_STEP_PART == 1 ? 8 : 16;
  constexpr bool kBf16 = SVAX_STEP_PART == 2;
  const Args& a = *static_cast<const Args*>(args);
  auto st = static_cast<cudaStream_t>(stream);
  if (h1 == 50 && h2 == 50) return launch<50, 50, C, kBf16>(a, st);
  if (h1 == 16 && h2 == 16) return launch<16, 16, C, kBf16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

SVAX_PHASE_ENTRY(SVAX_STEP_CLOCKS)

#else

extern "C" int tinystep_launch_c8(const void* args, int h1, int h2, void* stream);
extern "C" int tinystep_launch_bf16(const void* args, int h1, int h2, void* stream);

namespace {

template <int H1, int H2>
int launch(const Args& a, int cluster, int bf16, cudaStream_t stream) {
  if (bf16) {
    if (cluster == 16) return tinystep_launch_bf16(&a, H1, H2, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cluster == 8) return tinystep_launch_c8(&a, H1, H2, stream);
  if (cluster == 16) return launch<H1, H2, 16, false>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

long long tinystep_scratch_floats(int n, int k, int s, int h1, int h2, int cluster) {
  return ScratchOff(n, k, s, h1, h2, cluster).total;
}

// Dynamic shared memory of one CTA (svax_torch/ops/tinystep.py: smem_bytes).
long long tinystep_smem_bytes(int h1, int h2, int k, int cluster, int bf16) {
  if (h1 == 50 && h2 == 50) return smem_bytes<50, 50>(k, cluster, bf16);
  if (h1 == 16 && h2 == 16) return smem_bytes<16, 16>(k, cluster, bf16);
  return -1;
}

int tinystep_train_chunk(const float* x, int n, int k, int s, int h1, int h2,
                         const float* prior, float* nat, float* params, float* m,
                         float* v, float* metrics, float* scratch, const float* eps,
                         const float* aug_eps, int t_steps, int adam_count,
                         unsigned long long seed, float lr, float rho, float aug,
                         float dof, int smm_iters, int smm_env, float psi_a, float k_u,
                         int cluster, int bf16, void* stream) {
  Args a{x, n, k, s, prior, nat, params, m, v, metrics, scratch, eps, aug_eps,
         t_steps, adam_count, seed, lr, rho, aug, dof, smm_iters, smm_env, psi_a, k_u};
  auto st = static_cast<cudaStream_t>(stream);
  if (h1 == 50 && h2 == 50) return launch<50, 50>(a, cluster, bf16, st);
  if (h1 == 16 && h2 == 16) return launch<16, 16>(a, cluster, bf16, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's normal generator, exposed for distribution checks.
int philox_normals(unsigned long long seed, unsigned int base, float* out, int n,
                   void* stream) {
  const int threads = 256;
  philox_normals_kernel<<<(n + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(seed, base, out, n);
  return static_cast<int>(cudaGetLastError());
}

SVAX_PHASE_ENTRY(tinystep_phase_clocks)

}  // extern "C"

#endif  // SVAX_STEP_PART
