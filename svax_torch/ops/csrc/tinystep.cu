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
// and weight gradients). Design: ONE thread block of 512 threads on ONE
// SM — that SM is the design limit — with every parameter, both Adam
// moments, the gradients and the naturals in shared memory for the whole
// chunk; per-(n,k) records and per-row activations and cotangents live
// in a global scratch buffer (≈13 MB at the pinwheel shape, L2-resident).
// Phases are separated by __syncthreads().
// * Rows: one row per thread in registers (hidden widths are template
//   parameters); the 50×50 products read padded shared copies of W2 and
//   W2ᵀ as float4, so forward and backward both have 50 independent
//   accumulators.
// * Weight gradients: the three layers of a side come from ONE pass over
//   its rows in 32-row tiles, each tile loaded as float4 into registers
//   while the previous one is consumed from shared memory; each thread
//   owns one 3×4 block of one layer's gradient and sums it in row order,
//   so two runs at one seed are bit-identical.
// f32 FMA on CUDA cores throughout (no TF32). Measured per-phase split and
// history: PERF.md. Spreading the decoder rows over a cluster or the whole
// card, and wgmma for the 50×50 products, is later work.
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "gmm_d2.cuh"
#include "philox.cuh"

namespace {

using namespace svax;  // gmm_d2.cuh: ExpSlot, digammaf, expected_d2

constexpr int NT = 512;  // threads in the one block
constexpr int TR = 32;   // rows per weight-gradient tile
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kVarFloor = 1e-6f;
constexpr float kB1 = 0.9f, kB2 = 0.999f, kAdamEps = 1e-8f;

// Fields of the per-(n,k) record in scratch (N·K records). The SMM adds
// ū (UBAR), the Gamma rate b (GB), Q_nk of the final z-update (QF), the
// free energy A (AFREE) and J̃12's cotangent from the sampling (JB12).
enum Plane {
  J11, J12, J22, DET, S11, S12, S22, MU1, MU2, HT1, HT2, L11, L21, L22,
  RESP, LRESP, ANK, SUMLL, MUB1, MUB2, JB11, JB22,
  UBAR, GB, QF, AFREE, JB12, NUM_PLANES
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

struct ScratchOff {
  long long enc, eo, recn, locn, planes, rows, total;
  long long nk, r;
  __host__ __device__ ScratchOff(int n, int k, int s, int h1, int h2) {
    nk = static_cast<long long>(n) * k;
    r = nk * s;
    const int f = side_features(h1, h2);
    enc = 0;
    eo = enc + f * pad32(n);  // encoder outputs, (N, 4)
    recn = eo + pad32(4LL * n);
    locn = recn + pad32(n);
    planes = locn + pad32(n);
    rows = planes + pad32(NUM_PLANES * nk);
    total = rows + f * pad32(r);
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

// out = in · W + b (b may be null) with W (I, J) in a shared copy whose
// rows are padded to a multiple of 4 floats (16-byte aligned), read as
// float4.
template <int I, int J>
__device__ __forceinline__ void dense_p(const float (&in)[I], const float* W,
                                        const float* b, float (&out)[J]) {
  constexpr int JP = pad4(J);
#pragma unroll
  for (int j = 0; j < J; ++j) out[j] = b ? b[j] : 0.0f;
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float xi = in[i];
    const float4* w = reinterpret_cast<const float4*>(W + i * JP);
#pragma unroll
    for (int j4 = 0; j4 < JP / 4; ++j4) {
      const float4 q = w[j4];
      const float c[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * j4 + u < J) out[4 * j4 + u] = fmaf(xi, c[u], out[4 * j4 + u]);
    }
  }
}

// out = in · W3 + b3 with W3 (I, 4): one float4 per input (rows of 4
// floats, 16-byte aligned in the parameter block).
template <int I>
__device__ __forceinline__ void dense4(const float (&in)[I], const float* W,
                                       const float* b, float (&out)[4]) {
  const float4* w = reinterpret_cast<const float4*>(W);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = b[j];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float4 q = w[i];
    out[0] = fmaf(in[i], q.x, out[0]);
    out[1] = fmaf(in[i], q.y, out[1]);
    out[2] = fmaf(in[i], q.z, out[2]);
    out[3] = fmaf(in[i], q.w, out[3]);
  }
}

// gin[i] = Σ_j gout[j] · W3[i, j] with W3 (I, 4) as in dense4.
template <int I>
__device__ __forceinline__ void dense4_t(const float (&gout)[4], const float* W,
                                         float (&gin)[I]) {
  const float4* w = reinterpret_cast<const float4*>(W);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float4 q = w[i];
    gin[i] = fmaf(gout[0], q.x, fmaf(gout[1], q.y, fmaf(gout[2], q.z, gout[3] * q.w)));
  }
}

// out = in · W + b, W (I, J) row-major in shared memory.
template <int I, int J>
__device__ __forceinline__ void dense(const float (&in)[I], const float* W,
                                      const float* b, float (&out)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) out[j] = b[j];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float xi = in[i];
#pragma unroll
    for (int j = 0; j < J; ++j) out[j] = fmaf(xi, W[i * J + j], out[j]);
  }
}

// gin[i] = Σ_j gout[j] · W[i, j]  (the transpose product).
template <int I, int J>
__device__ __forceinline__ void dense_t(const float (&gout)[J], const float* W,
                                        float (&gin)[I]) {
#pragma unroll
  for (int i = 0; i < I; ++i) {
    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
    for (int j = 0; j + 1 < J; j += 2) {
      acc0 = fmaf(gout[j], W[i * J + j], acc0);
      acc1 = fmaf(gout[j + 1], W[i * J + j + 1], acc1);
    }
    if (J % 2) acc0 = fmaf(gout[J - 1], W[i * J + J - 1], acc0);
    gin[i] = acc0 + acc1;
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
    if (dst[u] >= 0) q = src[threadIdx.x + u * NT];
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
// parameter layout. All threads call.
template <int H1, int H2>
__device__ void side_weight_grads(const float* cols, long long R, float* grad,
                                  float* tile) {
  using T = Tile<H1, H2>;
  static_assert((T::W2_WARPS + 1) * 32 <= NT, "one block per thread");
  static_assert(T::NA2 + T::NG1 <= 32, "dW3 and dW1 share one warp");
  static_assert(TR == 32, "tiles are the 32-row groups of the block");
  constexpr SideOff off(H1, H2);
  constexpr int LD = T::LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

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
#pragma unroll
  for (int u = 0; u < T::LPV; ++u) {
    const int v = tid + u * NT;
    row0[u] = (v & 7) * 4;
    dst[u] = v < T::F * 8 ? T::row_of(v >> 3) * LD + row0[u] : -1;
  }
  float4 pre[T::LPV];

  float acc[3][4];
#pragma unroll
  for (int x = 0; x < 3; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;

  load_tile<T::F, T::LPV>(cols, R, 0, dst, row0, pre);
  for (long long r0 = 0; r0 < R; r0 += TR) {
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int u = 0; u < T::LPV; ++u)
      if (dst[u] >= 0) *reinterpret_cast<float4*>(tile + dst[u]) = pre[u];
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
      else grad[b + j] = acc[x][y];
    }
}

template <int H1, int H2>
struct Shape {
  static constexpr int P_SIDE = side_floats(H1, H2);
  static constexpr int P = 2 * P_SIDE;
  static constexpr int H1P = pad4(H1), H2P = pad4(H2);  // padded W2 / W2ᵀ rows
  static size_t smem_floats(int k) {
    return 4 * P + 2 * (H1 * H2P + H2 * H1P) + 2 * 9 * k + NUM_EXP * k +
           pad4(NUM_STATS * k) + 4 + Tile<H1, H2>::ROWS * Tile<H1, H2>::LD;
  }
};

template <int H1, int H2>
__global__ void __launch_bounds__(NT, 1) tinystep_kernel(Args a) {
  using Sh = Shape<H1, H2>;
  constexpr int P_SIDE = Sh::P_SIDE, P = Sh::P, H1P = Sh::H1P, H2P = Sh::H2P;
  constexpr SideOff off(H1, H2);
  static_assert(P_SIDE % 4 == 0 && off.w3 % 4 == 0, "W3 rows must be 16-byte aligned");

  const int tid = threadIdx.x;
  const int N = a.n, K = a.k, S = a.s;
  const ScratchOff so(N, K, S, H1, H2);
  const long long NK = so.nk, R = so.r;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sp = smem;            // params
  float* sm = sp + P;          // Adam m
  float* sv = sm + P;          // Adam v
  float* sg = sv + P;          // gradients of neg_loss
  float* sw2e = sg + P;        // padded copies of W2 and W2ᵀ per side
  float* sw2d = sw2e + H1 * H2P;  // (16-byte rows, read as float4)
  float* sw2te = sw2d + H1 * H2P;
  float* sw2td = sw2te + H2 * H1P;
  float* snat = sw2td + H2 * H1P;  // (K, 9)
  float* sprior = snat + K * 9;
  float* sexp = sprior + K * 9;         // (K, NUM_EXP)
  float* sstat = sexp + K * NUM_EXP;    // (K, NUM_STATS)
  float* smet = sstat + pad4(K * NUM_STATS);  // recon, local
  float* tile = smet + 4;  // side_weight_grads' tile (16-byte aligned: every
                           // region before it is a multiple of 4 floats)

  float* scr = a.scratch;
  constexpr int F = side_features(H1, H2);
  // Feature offsets inside a row of either side's row-blocked block.
  constexpr int F_IN = 0, F_A1 = 2, F_A2 = 2 + H1, F_G1 = 2 + H1 + H2,
                F_G2 = 2 + 2 * H1 + H2, F_GO = 2 + 2 * H1 + 2 * H2;
  float* enc_rows = scr + so.enc;   // N rows
  float* dec_rows = scr + so.rows;  // S·N·K rows
  float4* eo = reinterpret_cast<float4*>(scr + so.eo);  // encoder outputs (N, 4)
  float* recn = scr + so.recn;
  float* locn = scr + so.locn;
  float* pl = scr + so.planes;  // NK records of NUM_PLANES floats

  for (int i = tid; i < P; i += NT) {
    sp[i] = a.params[i];
    sm[i] = a.m[i];
    sv[i] = a.v[i];
  }
  for (int i = tid; i < K * 9; i += NT) {
    snat[i] = a.nat[i];
    sprior[i] = a.prior[i];
  }
  __syncthreads();

  const float* encp = sp;
  const float* decp = sp + P_SIDE;
  const float rbar = -1.0f / static_cast<float>(N);  // ∂neg_loss/∂recon
  const float lbar = 1.0f / static_cast<float>(N);   // ∂neg_loss/∂local
  const float inv_s = 1.0f / static_cast<float>(S);
  const bool smm = a.dof > 0.0f;
  const float a0 = 0.5f * a.dof, b0 = a0, ga = a0 + 1.0f;  // a = a₀ + d/2, d = 2
  const int rounds = a.smm_iters > 1 ? a.smm_iters : 1;

  for (int t = 0; t < a.t_steps; ++t) {
    // ---- A: expected parameters from the pre-update naturals; W2 copies.
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
    if (tid < K) expected_d2(snat, K, tid, sexp + tid * NUM_EXP);
    __syncthreads();

    // ---- B: augmentation, encoder, combine, softmax, local-KL terms (per n).
    for (int n = tid; n < N; n += NT) {
      float xin[2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        float xi = 0.0f;
        if (a.aug > 0.0f) {
          xi = a.aug_eps ? a.aug_eps[(static_cast<long long>(t) * N + n) * 2 + d]
                         : svax::philox_normal(a.seed, static_cast<uint32_t>(t) + (1u << 30),
                                               static_cast<uint32_t>(n * 2 + d));
        }
        xin[d] = a.x[n * 2 + d] + a.aug * xi;
      }
      float* erow = row_at<F>(enc_rows, n);
      put<2>(erow, F_IN, xin);
      float h1v[H1], h2v[H2], out[4];
      dense<2, H1>(xin, encp + off.w1, encp + off.b1, h1v);
#pragma unroll
      for (int j = 0; j < H1; ++j) h1v[j] = tanhf(h1v[j]);
      put<H1>(erow, F_A1, h1v);
      dense_p<H1, H2>(h1v, sw2e, encp + off.b2, h2v);
#pragma unroll
      for (int j = 0; j < H2; ++j) h2v[j] = tanhf(h2v[j]);
      put<H2>(erow, F_A2, h2v);
      dense4<H2>(h2v, encp + off.w3, encp + off.b3, out);
      eo[n] = make_float4(out[0], out[1], out[2], out[3]);
      const float p1 = 1.0f / (softplusf(out[2]) + kVarFloor);
      const float p2 = 1.0f / (softplusf(out[3]) + kVarFloor);
      const float h1 = out[0] * p1, h2 = out[1] * p2;

      float* recs = pl + static_cast<long long>(n) * K * NUM_PLANES;
      float row_max = -3.0e38f;
      for (int k = 0; k < K; ++k) {
        const float* e = sexp + k * NUM_EXP;
        float* rec = recs + k * NUM_PLANES;
        if (smm) {
          // u–z rounds, then the final z-update at ū = a/b.
          float u = 1.0f, gb = b0;
          for (int r = 0; r < rounds; ++r) {
            gb = b0 + 0.5f * quad_latent(e, z_update(e, p1, p2, h1, h2, u));
            u = ga / gb;
          }
          const ZUp c = z_update(e, p1, p2, h1, h2, u);
          const float qf = quad_latent(e, c);
          const float log_gb = logf(gb), logdet_j = logf(c.det);
          const float e_log_u = a.psi_a - log_gb;
          const float u_free = a.k_u + (a0 - 1.0f) * e_log_u - b0 * u - log_gb;
          const float log_rho = e[E_LOGPI] + e_log_u - kLog2Pi + 0.5f * e[E_LOGDET] -
                                0.5f * u * e[E_QUAD] + 0.5f * (c.mu1 * c.ht1 + c.mu2 * c.ht2) -
                                0.5f * logdet_j + u_free;
          const float l11 = sqrtf(c.j11), l21 = c.j12 / l11;
          rec[J11] = c.j11; rec[J12] = c.j12; rec[J22] = c.j22; rec[DET] = c.det;
          rec[S11] = c.s11; rec[S12] = c.s12; rec[S22] = c.s22;
          rec[MU1] = c.mu1; rec[MU2] = c.mu2; rec[HT1] = c.ht1; rec[HT2] = c.ht2;
          rec[L11] = l11; rec[L21] = l21; rec[L22] = sqrtf(c.j22 - l21 * l21);
          rec[LRESP] = log_rho;
          rec[UBAR] = u; rec[GB] = gb; rec[QF] = qf;
          rec[AFREE] = e[E_LOGPI] + e_log_u - kLog2Pi + 0.5f * e[E_LOGDET] - 0.5f * u * qf +
                       (1.0f + kLog2Pi) - 0.5f * logdet_j + u_free;
          row_max = fmaxf(row_max, log_rho);
          continue;
        }
        const float j11 = e[E_P11] + p1, j12 = e[E_P12], j22 = e[E_P22] + p2;
        const float ht1 = e[E_PM1] + h1, ht2 = e[E_PM2] + h2;
        const float det = j11 * j22 - j12 * j12;
        const float s11 = j22 / det, s12 = -j12 / det, s22 = j11 / det;
        const float mu1 = s11 * ht1 + s12 * ht2, mu2 = s12 * ht1 + s22 * ht2;
        const float log_rho = e[E_LOGPI] + 0.5f * e[E_LOGDET] - 0.5f * e[E_QUAD] +
                              0.5f * (mu1 * ht1 + mu2 * ht2) - 0.5f * logf(det);
        const float l11 = sqrtf(j11), l21 = j12 / l11;
        rec[J11] = j11; rec[J12] = j12; rec[J22] = j22; rec[DET] = det;
        rec[S11] = s11; rec[S12] = s12; rec[S22] = s22;
        rec[MU1] = mu1; rec[MU2] = mu2; rec[HT1] = ht1; rec[HT2] = ht2;
        rec[L11] = l11; rec[L21] = l21; rec[L22] = sqrtf(j22 - l21 * l21);
        rec[LRESP] = log_rho;
        row_max = fmaxf(row_max, log_rho);
      }
      float se = 0.0f;
      for (int k = 0; k < K; ++k) se += expf(recs[k * NUM_PLANES + LRESP] - row_max);
      const float lse = row_max + logf(se);
      float local_n = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float* e = sexp + k * NUM_EXP;
        float* rec = recs + k * NUM_PLANES;
        const float log_resp = rec[LRESP] - lse;
        const float resp = expf(log_resp);
        if (smm) {
          const float ank = log_resp - rec[AFREE];
          rec[LRESP] = log_resp;
          rec[RESP] = resp;
          rec[ANK] = ank;
          local_n += resp * ank;
          continue;
        }
        const float mu1 = rec[MU1], mu2 = rec[MU2];
        const float g_k = 0.5f * e[E_LOGDET] - kLog2Pi - 0.5f * e[E_QUAD];
        const float cross = e[E_PM1] * mu1 + e[E_PM2] * mu2;
        const float tr = e[E_P11] * rec[S11] + 2.0f * e[E_P12] * rec[S12] +
                         e[E_P22] * rec[S22];
        const float qmu = e[E_P11] * mu1 * mu1 + 2.0f * e[E_P12] * mu1 * mu2 +
                          e[E_P22] * mu2 * mu2;
        const float e_log_pbar = e[E_LOGPI] + g_k + cross - 0.5f * (tr + qmu);
        const float ank = log_resp - (1.0f + kLog2Pi) + 0.5f * logf(rec[DET]) - e_log_pbar;
        rec[LRESP] = log_resp;
        rec[RESP] = resp;
        rec[ANK] = ank;
        local_n += resp * ank;
      }
      locn[n] = local_n;
    }
    __syncthreads();

    // ---- C: sampling, decoder forward + activation backward (per (n,k), S rows).
    for (long long q = tid; q < NK; q += NT) {
      const int n = static_cast<int>(q / K), k = static_cast<int>(q % K);
      float* rec = pl + q * NUM_PLANES;
      const float mu1 = rec[MU1], mu2 = rec[MU2];
      const float l11 = rec[L11], l21 = rec[L21], l22 = rec[L22];
      const float llbar = rbar * rec[RESP] * inv_s;
      const float* erow = row_at<F>(enc_rows, n);
      const float x0 = erow[F_IN * 32], x1 = erow[(F_IN + 1) * 32];
      float sum_ll = 0.0f, mub1 = 0.0f, mub2 = 0.0f;
      float l11b = 0.0f, l21b = 0.0f, l22b = 0.0f;
      for (int s = 0; s < S; ++s) {
        const long long r = s * NK + q;
        float e1, e2;
        const long long ei = ((static_cast<long long>(s) * N + n) * K + k) * 2;
        if (a.eps) {
          const float* ep = a.eps + static_cast<long long>(t) * S * NK * 2 + ei;
          e1 = ep[0];
          e2 = ep[1];
        } else {
          e1 = svax::philox_normal(a.seed, static_cast<uint32_t>(t), static_cast<uint32_t>(ei));
          e2 = svax::philox_normal(a.seed, static_cast<uint32_t>(t), static_cast<uint32_t>(ei + 1));
        }
        const float u2 = e2 / l22;
        const float u1 = (e1 - l21 * u2) / l11;
        const float z[2] = {mu1 + u1, mu2 + u2};
        float* row = row_at<F>(dec_rows, r);
        put<2>(row, F_IN, z);
        float h1v[H1], h2v[H2], o[4];
        dense<2, H1>(z, decp + off.w1, decp + off.b1, h1v);
#pragma unroll
        for (int j = 0; j < H1; ++j) h1v[j] = tanhf(h1v[j]);
        put<H1>(row, F_A1, h1v);
        dense_p<H1, H2>(h1v, sw2d, decp + off.b2, h2v);
#pragma unroll
        for (int j = 0; j < H2; ++j) h2v[j] = tanhf(h2v[j]);
        put<H2>(row, F_A2, h2v);
        dense4<H2>(h2v, decp + off.w3, decp + off.b3, o);
        const float va = softplusf(o[2]) + kVarFloor;
        const float vb = softplusf(o[3]) + kVarFloor;
        const float da = x0 - o[0], db = x1 - o[1];
        sum_ll += -0.5f * (logf(va) + da * da / va + logf(vb) + db * db / vb + 2.0f * kLog2Pi);
        const float ob[4] = {
            llbar * da / va,
            llbar * db / vb,
            llbar * -0.5f * (1.0f / va - da * da / (va * va)) * sigmoidf(o[2]),
            llbar * -0.5f * (1.0f / vb - db * db / (vb * vb)) * sigmoidf(o[3]),
        };
        put<4>(row, F_GO, ob);
        // Activation backward in place: h2v becomes g2, then h1v becomes g1.
        {
          float g[H2];
          dense4_t<H2>(ob, decp + off.w3, g);
#pragma unroll
          for (int j = 0; j < H2; ++j) h2v[j] = g[j] * (1.0f - h2v[j] * h2v[j]);
        }
        put<H2>(row, F_G2, h2v);
        {
          // a1 is reloaded from the row block rather than kept live
          // across both 50×50 products (register pressure).
          float g[H1];
          dense_p<H2, H1>(h2v, sw2td, nullptr, g);
          get<H1>(row, F_A1, h1v);
#pragma unroll
          for (int j = 0; j < H1; ++j) h1v[j] = g[j] * (1.0f - h1v[j] * h1v[j]);
        }
        put<H1>(row, F_G1, h1v);
        float zb[2];
        dense_t<2, H1>(h1v, decp + off.w1, zb);
        const float u1b = zb[0];
        const float u2b = zb[1] - u1b * l21 / l11;
        mub1 += zb[0];
        mub2 += zb[1];
        l11b -= u1b * u1 / l11;
        l21b -= u1b * u2 / l11;
        l22b -= u2b * u2 / l22;
      }
      // Through L̃ = chol(J̃): l22 = √(j22 − l21²), l21 = j12/l11, l11 = √j11.
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

    // ---- D: softmax / local-KL / combine backward, encoder backward (per n).
    for (int n = tid; n < N; n += NT) {
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
      float p1b = 0.0f, p2b = 0.0f, h1b = 0.0f, h2b = 0.0f;
      float p1 = 0.0f, p2 = 0.0f, h1 = 0.0f, h2 = 0.0f;  // the potential (SMM rounds)
      if (smm && !a.smm_env) {
        const float4 o4 = eo[n];
        p1 = 1.0f / (softplusf(o4.z) + kVarFloor);
        p2 = 1.0f / (softplusf(o4.w) + kVarFloor);
        h1 = o4.x * p1;
        h2 = o4.y * p2;
      }
      for (int k = 0; k < K; ++k) {
        const float* e = sexp + k * NUM_EXP;
        const float* rec = recs + k * NUM_PLANES;
        const float resp = rec[RESP];
        const float rhobar = rec[ANK] - resp * sum_lr;
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
          p1b += j11b;
          p2b += j22b;
          h1b += ht1b;
          h2b += ht2b;
          if (a.smm_env) continue;
          // Full chain: ū and b of the final update (log ρ and A carry
          // −(a/b)·log b, −½ū·E[μᵀΛμ] resp. −½ū·Q_f, and −b₀ū), then back
          // through every round; ū_r = a/b_{r−1} hands −ū̄_r·ū_r²/a to the
          // round before.
          const float gb = rec[GB];
          const float ub = -rhobar * (0.5f * e[E_QUAD] + b0) + w * (0.5f * rec[QF] + b0) +
                           j11b * e[E_P11] + j12b * e[E_P12] + j22b * e[E_P22] +
                           ht1b * e[E_PM1] + ht2b * e[E_PM2];
          float bb = -(rhobar - w) * ga / gb - ub * ga / (gb * gb);
          for (int r = rounds - 1; r >= 0; --r) {
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
          continue;
        }
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
        h1b += 0.5f * rhobar * mu1 + s11 * mu1b + s12 * mu2b;
        h2b += 0.5f * rhobar * mu2 + s12 * mu1b + s22 * mu2b;
        s11b += mu1b * ht1;
        s12b += mu1b * ht2 + mu2b * ht1;
        s22b += mu2b * ht2;
        const float detb = (logdetb - (s11b * s11 + s12b * s12 + s22b * s22)) / det;
        p1b += rec[JB11] + s22b / det + detb * j22;
        p2b += rec[JB22] + s11b / det + detb * j11;
      }
      // Diagonal head: p = 1/(softplus(raw) + floor), h = mean·p.
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
      float* erow = row_at<F>(enc_rows, n);
      put<4>(erow, F_GO, go);
      float h1v[H1], h2v[H2];
      get<H2>(erow, F_A2, h2v);
      {
        float g[H2];
        dense4_t<H2>(go, encp + off.w3, g);
#pragma unroll
        for (int j = 0; j < H2; ++j) h2v[j] = g[j] * (1.0f - h2v[j] * h2v[j]);
      }
      put<H2>(erow, F_G2, h2v);
      {
        float g[H1];
        dense_p<H2, H1>(h2v, sw2te, nullptr, g);
        get<H1>(erow, F_A1, h1v);
#pragma unroll
        for (int j = 0; j < H1; ++j) h1v[j] = g[j] * (1.0f - h1v[j] * h1v[j]);
      }
      put<H1>(erow, F_G1, h1v);
    }
    __syncthreads();

    // ---- E: statistics, metrics, then every weight gradient.
    if (tid < K) {
      float st[NUM_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int n = 0; n < N; ++n) {
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
      for (int i = 0; i < NUM_STATS; ++i) sstat[tid * NUM_STATS + i] = st[i];
    } else if (tid == K) {
      float recon = 0.0f, local = 0.0f;
      for (int n = 0; n < N; ++n) {
        recon += recn[n];
        local += locn[n];
      }
      smet[0] = recon;
      smet[1] = local;
    }
    side_weight_grads<H1, H2>(dec_rows, R, sg + P_SIDE, tile);
    side_weight_grads<H1, H2>(enc_rows, N, sg, tile);
    __syncthreads();

    // ---- F: Adam (optax.adam, bias correction at the global count), CVI.
    const int count = a.adam_count + t + 1;
    const float bc1 = static_cast<float>(1.0 - pow(0.9, static_cast<double>(count)));
    const float bc2 = static_cast<float>(1.0 - pow(0.999, static_cast<double>(count)));
    for (int i = tid; i < P; i += NT) {
      const float g = sg[i];
      const float mm = (1.0f - kB1) * g + kB1 * sm[i];
      const float vv = (1.0f - kB2) * g * g + kB2 * sv[i];
      sm[i] = mm;
      sv[i] = vv;
      sp[i] -= a.lr * ((mm / bc1) / (sqrtf(vv / bc2) + kAdamEps));
    }
    if (tid < K) {
      const float* st = sstat + tid * NUM_STATS;
      // Slot 3 (η₂) takes Σ r̃ū: the counts for the GMM.
      const float delta[9] = {st[ST_N], st[ST_S1], st[ST_S2], st[ST_U], st[ST_S11],
                              st[ST_S12], st[ST_S12], st[ST_S22], st[ST_N]};
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        float* slot = snat + tid * 9 + c;
        *slot = (1.0f - a.rho) * *slot + a.rho * (sprior[tid * 9 + c] + delta[c]);
      }
    }
    if (tid == 0) {
      a.metrics[t * 3 + 0] = smet[0];
      a.metrics[t * 3 + 1] = smet[1];
      a.metrics[t * 3 + 2] = -(smet[0] - smet[1]) / static_cast<float>(N);
    }
    __syncthreads();
  }

  for (int i = tid; i < P; i += NT) {
    a.params[i] = sp[i];
    a.m[i] = sm[i];
    a.v[i] = sv[i];
  }
  for (int i = tid; i < K * 9; i += NT) a.nat[i] = snat[i];
}

template <int H1, int H2>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = Shape<H1, H2>::smem_floats(a.k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tinystep_kernel<H1, H2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  tinystep_kernel<H1, H2><<<1, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

__global__ void philox_normals_kernel(unsigned long long seed, uint32_t base,
                                      float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = svax::philox_normal(seed, base, static_cast<uint32_t>(i));
}

}  // namespace

extern "C" {

long long tinystep_scratch_floats(int n, int k, int s, int h1, int h2) {
  return ScratchOff(n, k, s, h1, h2).total;
}

int tinystep_train_chunk(const float* x, int n, int k, int s, int h1, int h2,
                         const float* prior, float* nat, float* params, float* m,
                         float* v, float* metrics, float* scratch, const float* eps,
                         const float* aug_eps, int t_steps, int adam_count,
                         unsigned long long seed, float lr, float rho, float aug,
                         float dof, int smm_iters, int smm_env, float psi_a, float k_u,
                         void* stream) {
  Args a{x, n, k, s, prior, nat, params, m, v, metrics, scratch, eps, aug_eps,
         t_steps, adam_count, seed, lr, rho, aug, dof, smm_iters, smm_env, psi_a, k_u};
  auto st = static_cast<cudaStream_t>(stream);
  if (h1 == 50 && h2 == 50) return launch<50, 50>(a, st);
  if (h1 == 16 && h2 == 16) return launch<16, 16>(a, st);
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

}  // extern "C"
