// decoder_mlp: the fused Bernoulli MLP decoder, forward and recompute backward.
//
// Replaces the TPU kernels of svax/ops/decoder_mlp_pallas.py: _fwd_call
// (pallas_call at :99) and _bwd_call (:205), entry
// bernoulli_mlp_loglik_fused (:290). Per row r = (s·N + n)·K + k of z
// (S, N, K, d):
//   h1 = tanh(z W1 + b1), h2 = tanh(h1 W2 + b2), o = h2 W3 + b3,
//   ll = ⟨h2, y_n⟩ + c_n + Σ_D logσ(−o),
// with y = x W3ᵀ and c = x·b3 formed outside (svax_torch/ops/decoder_mlp.py).
// Every product takes bf16 operands and sums in f32; h1, h2 and o stay f32
// between layers. The backward recomputes the forward and applies its VJP,
// rounding where plain autograd over `a.to(bf16).float() @ w.to(bf16).float()`
// rounds: each product's result that flows back through a bf16 cast (dz, the
// cotangents of h1 and of h2's product path, dW1..3) is rounded to bf16,
// and the f32 cotangent operand of every backward product is NOT rounded
// first (the reference's own rounding points, PERF.md): it enters as three
// bf16 parts, hi + mid + lo, which carry its 24 bits.
//
// Bound: at bigk (S·N·K = 102,400 rows, d = 10, 200-200, D = 784) the
// forward does 2·rows·(d·H1 + H1·H2 + H2·D) = 40.7 GFLOP (41 µs at the
// 989 TFLOP/s bf16 tensor-core peak) and ~201 M tanh and logσ evaluations
// (~48 µs at 16 special functions per clock per SM); the backward about
// three times the reference's products (123.5 µs; ~335 GFLOP of bf16
// tensor-core work as the backward below splits its f32 cotangents and
// recomputes o twice). Bytes are tens of µs: the kernels are bound by
// operations, not bytes.
//
// * Forward (decoder_fwd, not redesigned): mma.sync m16n8k16 with each
//   16-deep product added in f32, fragments built in registers, weights
//   read from L2 as zero-padded bf16 copies (d, H1, H2 and D padded to 16;
//   tanh(0) = 0 so padding adds nothing); a block of 8 warps takes 64 rows,
//   keeps z, h1 and h2 as bf16 in shared memory, forms the t-term from the
//   f32 h2 and walks the D columns in 8-wide tiles, each warp spanning all
//   64 rows; per-row partials are added in a fixed order (no atomics).
// * Backward, on the tensor-core engine of lastlayer_bwd.cuh (every operand
//   staged in shared memory in its bf16 parts by cp.async, products on
//   mma.sync fed by ldmatrix), five kernels:
//   mlp_rows (one block per 32 rows): h1 = tanh(z W1 + b1) and h2 = tanh(h1
//     W2 + b2), W1 staged whole and W2 in double-buffered 32-deep chunks;
//     bf16(h1), bf16(h2) and the f32 h2 written out; then engine block (a)
//     with H = bf16(h2), W = W3 and do = −dll·σ(o) in three parts, dh2 +=
//     do W3ᵀ over double-buffered W3 slabs (o accumulated on the tensor
//     cores: its drift is far inside the bars, as dh2 is rounded to bf16);
//     then dpre2 = (bf16(dh2) + dll·y_n)(1 − h2²), written in three bf16
//     parts.
//   mlp_tail (132 blocks, each walking row tiles in order): h1 again, dh1 =
//     dpre2 W2ᵀ (W2 staged once a block), dpre1 =
//     bf16(dh1)(1 − h1²), dz = bf16(dpre1 W1ᵀ); the block's dW1 = zᵀ dpre1
//     in registers and db1 in row order, one partial a block.
//   mlp_wbar (engine block (b), twice): dW3, db3 from bf16(h2) with do
//     formed again from o (W3 chunk staged once a block); dW2, db2 from
//     bf16(h1) and the loaded dpre2 parts; one partial per row split.
//   mlp_dy: dy[n] = Σ dll·h2 and dc[n] = Σ dll over the point's rows, in
//     row order.
//   reduce_partials: adds the partials in order and rounds dW to bf16.
//   No float atomics: reruns are bit-equal.
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "lastlayer_bwd.cuh"
#include "phase_clock.cuh"

namespace {

namespace ll = lastlayer;
using bf16 = __nv_bfloat16;

constexpr int kDP = 16;          // latent d padded to one k-step
constexpr int kMaxHidden = 256;
constexpr int kFwdRows = 64;     // rows per forward block
constexpr int kFwdThreads = 256;  // 8 warps
constexpr int kSmemMax = 232448;  // bytes a block may opt into (sm_90)

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// ------------------------------------------------------------ fragments

// Lane roles in m16n8k16 (PTX ISA): g = lane / 4 is the row (A, C) or the
// column (B); t = lane % 4 picks the pair of k (A, B) or columns (C).
// A regs: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..).
// B regs: (k = 2t..2t+1, n = g), (k = 2t+8..2t+9, n = g).
// C: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  ll::mma(c, a, b);
}

// A from bf16 row-major storage, base at (m0, k0).
__device__ __forceinline__ void a_bf16(uint32_t (&a)[4], const bf16* base, int ld, int g, int t) {
  const bf16* p0 = base + g * ld + 2 * t;
  const bf16* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B(k, n) from bf16 storage laid out [n][k] (k contiguous), base at (n0, k0).
__device__ __forceinline__ void b_bf16(uint32_t (&b)[2], const bf16* base, int ld, int g, int t) {
  const bf16* p = base + g * ld + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// c += A·B as an IEEE f32 add of the 16-term product: the tensor cores'
// own f32 accumulation truncates, and over a long k it drifts from a
// rounded sum (at H = 200..256 by ~1e-5 of the logits, measured); adding
// each step's product apart keeps the sum as accurate as a plain f32 one.
__device__ __forceinline__ void mma_add(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(p, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

// logσ(−o) = −softplus(o), as torch's log_sigmoid.
__device__ __forceinline__ float logsig_neg(float o) {
  return -(fmaxf(o, 0.0f) + log1pf(expf(-fabsf(o))));
}

// Sum over the four lanes of a quad (lanes 4g..4g+3); every lane gets it.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

struct Weights {
  const bf16* w1;   // (16, H1p)   (in, out)
  const bf16* w1t;  // (H1p, 16)   (out, in)
  const bf16* w2;   // (H1p, H2p)
  const bf16* w2t;  // (H2p, H1p)
  const bf16* w3;   // (H2p, Dp)
  const bf16* w3t;  // (Dp, H2p)
  const float* b1;  // (H1,)
  const float* b2;  // (H2,)
  const float* b3;  // (D,)
};

struct Shape {
  int n, k, s, d, h1, h2, dd, h1p, h2p, ddp;
};

// ------------------------------------------------------------- forward

struct FwdArgs {
  const float* __restrict__ z;  // (S·N·K, d)
  const float* __restrict__ y;  // (N, H2)
  const float* __restrict__ c;  // (N,)
  float* ll;                    // (S·N·K,)
  Weights w;
  Shape sh;
  long long rows;
};

// One block: 64 rows (4 m-tiles). Warp w takes all 4 m-tiles and the
// n8-tiles j = w + 8q of each product, so each weight fragment is read from
// L2 once per block and used for 4 products.
__global__ void __launch_bounds__(kFwdThreads) decoder_fwd(FwdArgs a) {
  constexpr int TM = kFwdRows, MT = TM / 16, NW = kFwdThreads / 32, NQ = 4;
  const Shape& sh = a.sh;
  const Weights& w = a.w;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* zb = reinterpret_cast<bf16*>(smem_raw);   // (TM, 16)
  bf16* h1b = zb + TM * kDP;                       // (TM, H1p)
  bf16* h2b = h1b + TM * sh.h1p;                   // (TM, H2p)
  float* tpart = reinterpret_cast<float*>(h2b + TM * sh.h2p);  // (TM, NW)
  float* rpart = tpart + TM * NW;                  // (TM, NW)
  int* rown = reinterpret_cast<int*>(rpart + TM * NW);  // (TM,) n, or −1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long r0 = static_cast<long long>(blockIdx.x) * TM;
  for (int idx = tid; idx < TM * kDP; idx += blockDim.x) {
    const int row = idx / kDP, col = idx % kDP;
    const long long r = r0 + row;
    const float v = (r < a.rows && col < sh.d) ? a.z[r * sh.d + col] : 0.0f;
    zb[idx] = __float2bfloat16_rn(v);
  }
  for (int row = tid; row < TM; row += blockDim.x) {
    const long long r = r0 + row;
    rown[row] = r < a.rows ? static_cast<int>((r / sh.k) % sh.n) : -1;
  }
  __syncthreads();

  float acc[MT][NQ][4];
  // acc[mt][q] += A(mt) · B(j_q) over the k-steps, A from bf16 shared memory
  // (ld lda), B from bf16 global memory laid out [n][k] (ld ldb).
  auto gemm = [&](const bf16* as, int lda, const bf16* bs, int ldb, int ksteps, int jq0,
                  int ntiles) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][q][i] = 0.0f;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t fa[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) a_bf16(fa[m], as + m * 16 * lda + ks * 16, lda, g, t);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int j = warp + NW * (jq0 + q);
        if (j < ntiles) {
          uint32_t fb[2];
          b_bf16(fb, bs + static_cast<size_t>(j) * 8 * ldb + ks * 16, ldb, g, t);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_add(acc[m][q], fa[m], fb);
        }
      }
    }
  };
  // The lane's element e of tile (m, q): row m·16 + g (+8), column j·8 + 2t (+1).
  auto row_of = [&](int m, int e) { return m * 16 + g + (e < 2 ? 0 : 8); };

  // h1 = tanh(z W1 + b1), stored bf16.
  const int n1 = sh.h1p / 8;
  gemm(zb, kDP, w.w1t, kDP, 1, 0, n1);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int j = warp + NW * q;
    if (j < n1) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const float v = col < sh.h1 ? tanhf(acc[m][q][e] + w.b1[col]) : 0.0f;
          h1b[row_of(m, e) * sh.h1p + col] = __float2bfloat16_rn(v);
        }
    }
  }
  __syncthreads();

  // h2 = tanh(h1 W2 + b2), stored bf16; the t-term ⟨h2, y_n⟩ from the f32 h2.
  const int n2 = sh.h2p / 8;
  gemm(h1b, sh.h1p, w.w2t, sh.h1p, sh.h1p / 16, 0, n2);
  {
    float tr[MT][2] = {};
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int j = warp + NW * q;
      if (j < n2) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row_of(m, e), col = j * 8 + 2 * t + (e & 1), nn = rown[row];
            float v = 0.0f;
            if (col < sh.h2) {
              v = tanhf(acc[m][q][e] + w.b2[col]);
              if (nn >= 0) tr[m][e / 2] += v * a.y[static_cast<size_t>(nn) * sh.h2 + col];
            }
            h2b[row * sh.h2p + col] = __float2bfloat16_rn(v);
          }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = quad_sum(tr[m][h]);
        if (t == 0) tpart[(m * 16 + g + 8 * h) * NW + warp] = v;
      }
  }
  __syncthreads();

  // o = h2 W3 + b3 over the D columns, NQ n8-tiles at a time; Σ logσ(−o).
  const int n3 = sh.ddp / 8;
  float rs[MT][2] = {};
  for (int qb = 0; warp + NW * NQ * qb < n3; ++qb) {
    gemm(h2b, sh.h2p, w.w3t, sh.h2p, sh.h2p / 16, qb * NQ, n3);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int j = warp + NW * (qb * NQ + q);
      if (j < n3) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * t + (e & 1);
            if (col < sh.dd) rs[m][e / 2] += logsig_neg(acc[m][q][e] + w.b3[col]);
          }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = quad_sum(rs[m][h]);
      if (t == 0) rpart[(m * 16 + g + 8 * h) * NW + warp] = v;
    }
  __syncthreads();

  for (int row = tid; row < TM; row += blockDim.x) {
    const int nn = rown[row];
    if (nn < 0) continue;
    float tsum = 0.0f, rsum = 0.0f;
    for (int q = 0; q < NW; ++q) {
      tsum += tpart[row * NW + q];
      rsum += rpart[row * NW + q];
    }
    a.ll[r0 + row] = (tsum + a.c[nn]) + rsum;
  }
}

// ------------------------------------------------------------ backward

// The engine's configurations, by the widest padded hidden width they take
// (224: every config's 200; 256: the class's limit), all in 8-warp blocks:
// mlp_rows takes 32 rows (64 at 256) and 64-column W3 slabs, mlp_wbar
// 64-row tiles and 32-column chunks (32 and 64 at 256) — at 224 two blocks
// of each share an SM, registers capped at 128 — and mlp_tail 64 rows (32
// at 256) with W2 staged whole, one block an SM.
template <int KPMAX>
using CfgRowsOf = ll::CfgA<KPMAX == 224 ? 32 : 64, 64, KPMAX == 224 ? 2 : 1, KPMAX, 8,
                           KPMAX == 224 ? 2 : 1>;
template <int KPMAX>
using CfgWOf = ll::CfgB<KPMAX == 224 ? 64 : 32, KPMAX == 224 ? 32 : 64, 2, KPMAX, 8,
                        KPMAX == 224 ? 2 : 1>;
constexpr int kKC = 32;  // depth of one W2 chunk in mlp_rows
template <int KPMAX>
using CfgTailOf = ll::CfgA<KPMAX == 224 ? 64 : 32, 64, 2, KPMAX, 8>;  // mlp_tail's layout
constexpr int kLdz = kDP + ll::kPad;
constexpr int kTailBlocks = 132;  // mlp_tail's grid: partials are added in block order
constexpr int kTailWarps = 8;
constexpr int kWaveBlocks = 264;  // mlp_wbar's grid: about two blocks per SM

struct BwdArgs {
  const float* z;    // (M, d)
  const float* dll;  // (M,)
  const float* y;    // (N, H2)
  Weights w;
  Shape sh;
  long long rows;    // M = S·N·K
  // Written by mlp_rows, read by the later kernels: bf16(h1) (M, H1p),
  // bf16(h2) (M, H2p), h2 (M, H2p) f32, dpre2 in three bf16 parts (M, H2p).
  bf16* h1b;
  bf16* h2b;
  float* h2f;
  bf16* dp2;
  float* dz;   // (M, d)
  float* pw1;  // mlp_tail's partials: (kTailBlocks, 16, H1p) and (kTailBlocks, H1p)
  float* pb1;
};

// A warp's tiles of a (TM × Np) product in the (a) block's layout: m-tile
// warp % WM, n16 pairs warp / WM + WN·q.
template <class Cfg>
__device__ __forceinline__ int pairs_of(int np, int warp) {
  return (np / 16 - warp / Cfg::WM + Cfg::WN - 1) / Cfg::WN;
}

// acc (zeroed first) = A · B for this warp's tiles of a TM-row product;
// A [m][k] 1 part at `a` (row stride lda), B [k][n] at `b` (row stride ldb).
template <class Cfg>
__device__ __forceinline__ void rows_product(float (&acc)[1][Cfg::NQ][2][4], const bf16* a,
                                             int lda, const bf16* b, int ldb, int np,
                                             int ksteps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ll::zero(acc);
  ll::warp_mma<1, Cfg::NQ, 1, 1, false, true, false>(acc, a, lda, 0, (warp % Cfg::WM) * 16, 0, 1,
                                                     b, ldb, 0, (warp / Cfg::WM) * 16,
                                                     Cfg::WN * 16, pairs_of<Cfg>(np, warp),
                                                     ksteps, lane);
}

// fn(row, col, value) over this warp's elements of a rows_product.
template <class Cfg, class Fn>
__device__ __forceinline__ void rows_each(float (&acc)[1][Cfg::NQ][2][4], int np, Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp % Cfg::WM) * 16, nq = pairs_of<Cfg>(np, warp);
#pragma unroll
  for (int q = 0; q < Cfg::NQ; ++q) {
    if (q >= nq) break;
    const int n0 = (warp / Cfg::WM + Cfg::WN * q) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(ll::frag_row(m0, lane, e), ll::frag_col(n0, h, lane, e), acc[0][q][h][e]);
  }
}

// z rows [r0, r0 + TM) as bf16, zero-padded to 16 columns and past M.
template <int TM>
__device__ __forceinline__ void stage_z(bf16* zb, const float* z, long long r0, long long rows,
                                        int d) {
  for (int idx = threadIdx.x; idx < TM * kDP; idx += blockDim.x) {
    const int row = idx / kDP, col = idx % kDP;
    const long long r = r0 + row;
    zb[row * kLdz + col] =
        __float2bfloat16_rn(r < rows && col < d ? z[r * d + col] : 0.0f);
  }
}

// Copy a (TM × cols) shared tile to global rows [r0, r0 + TM) (row stride
// cols), 16 bytes at a time, rows past M left out.
template <int TM, typename T>
__device__ __forceinline__ void store_rows(T* g, const T* s, int lds, long long r0,
                                           long long rows, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cols / kVec;
  for (int idx = threadIdx.x; idx < TM * per_row; idx += blockDim.x) {
    const int row = idx / per_row, c = (idx % per_row) * kVec;
    if (r0 + row < rows)
      *reinterpret_cast<uint4*>(g + (r0 + row) * cols + c) =
          *reinterpret_cast<const uint4*>(s + row * lds + c);
  }
}

// Shared memory of mlp_rows (bytes): zb, h2 (bf16), the rows' dll and
// point, then one region that holds in turn W1, bf16(h1) and two kKC-deep
// chunks of W2 (the recompute); the f32 h2 tile (its store); the W3 slabs
// and do parts (the engine); one part of dpre2 at a time (its store).
template <class CfgRows>
__host__ __device__ inline size_t rows_region(const Shape& sh) {
  constexpr int TM = CfgRows::TM;
  const int ld1 = sh.h1p + ll::kPad, ld2 = sh.h2p + ll::kPad;
  size_t r = static_cast<size_t>(kDP) * ld1 + static_cast<size_t>(TM) * ld1 +
             2 * static_cast<size_t>(kKC) * ld2;
  const size_t sizes[] = {static_cast<size_t>(TM) * (sh.h2p + 4) * 2,  // f32 h2, in bf16 units
                          CfgRows::ws_elems(sh.h2p, 1) + CfgRows::ds_elems(3),
                          static_cast<size_t>(TM) * ld2};
  for (size_t v : sizes) r = v > r ? v : r;
  return r;
}

template <class CfgRows>
__host__ __device__ inline size_t rows_smem(const Shape& sh) {
  constexpr int TM = CfgRows::TM;
  return sizeof(bf16) * (static_cast<size_t>(TM) * kLdz + static_cast<size_t>(TM) * (sh.h2p + ll::kPad) +
                         rows_region<CfgRows>(sh)) +
         (sizeof(float) + sizeof(int)) * TM;
}

template <int KPMAX>
__global__ void __launch_bounds__(CfgRowsOf<KPMAX>::THREADS, CfgRowsOf<KPMAX>::MINB) mlp_rows(BwdArgs a) {
  using CfgRows = CfgRowsOf<KPMAX>;
  constexpr int kNQ = CfgRows::NQ, TM = CfgRows::TM;
  const Shape& sh = a.sh;
  const Weights& w = a.w;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld1 = sh.h1p + ll::kPad, ld2 = sh.h2p + ll::kPad, ldf = sh.h2p + 4;
  bf16* zb = reinterpret_cast<bf16*>(smem_raw);  // [TM][kLdz]
  bf16* hs = zb + TM * kLdz;                      // [TM][ld2]: bf16(h2), the engine's H
  bf16* region = hs + TM * ld2;
  bf16* w1s = region;                             // [16][ld1]
  bf16* h1s = w1s + kDP * ld1;                    // [TM][ld1]
  bf16* w2c = h1s + TM * ld1;                     // 2 × [kKC][ld2] W2 chunks
  float* h2t = reinterpret_cast<float*>(region);  // [TM][ldf] f32 h2
  bf16* ws = region;                              // the engine's slabs, then do parts
  bf16* ds = ws + CfgRows::ws_elems(sh.h2p, 1);
  bf16* pt = region;                              // [TM][ld2] one part of dpre2
  float* srow = reinterpret_cast<float*>(region + rows_region<CfgRows>(sh));  // [TM] dll
  int* srn = reinterpret_cast<int*>(srow + TM);                              // [TM] point n
  PHASE_START;
  const long long r0 = static_cast<long long>(blockIdx.x) * TM;

  // W2's rows [c·kKC, (c + 1)·kKC) (zero past H1p) into chunk buffer c % 2.
  auto load_w2 = [&](int c) {
    ll::stage(w2c + (c % 2) * kKC * ld2, ld2, w.w2 + static_cast<size_t>(c) * kKC * sh.h2p,
              sh.h2p, kKC, sh.h2p, sh.h1p - c * kKC, sh.h2p);
    ll::cp_async_commit();
  };
  ll::stage(w1s, ld1, w.w1, sh.h1p, kDP, sh.h1p, kDP, sh.h1p);
  ll::cp_async_commit();
  load_w2(0);
  stage_z<TM>(zb, a.z, r0, a.rows, sh.d);
  for (int row = threadIdx.x; row < TM; row += blockDim.x) {
    const long long r = r0 + row;
    srow[row] = r < a.rows ? a.dll[r] : 0.0f;
    srn[row] = r < a.rows ? static_cast<int>((r / sh.k) % sh.n) : 0;
  }
  ll::cp_async_wait<1>();
  __syncthreads();

  float acc[1][kNQ][2][4];
  // h1 = tanh(z W1 + b1) → bf16.
  rows_product<CfgRows>(acc, zb, kLdz, w1s, ld1, sh.h1p, 1);
  rows_each<CfgRows>(acc, sh.h1p, [&](int row, int col, float v) {
    h1s[row * ld1 + col] = __float2bfloat16_rn(col < sh.h1 ? tanhf(v + w.b1[col]) : 0.0f);
  });
  __syncthreads();
  PHASE_MARK(0);
  // h2 = tanh(h1 W2 + b2) → bf16 (the engine's H and mlp_wbar's) and f32,
  // W2 in double-buffered kKC-deep chunks.
  const int chunks = (sh.h1p + kKC - 1) / kKC;
  ll::zero(acc);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      load_w2(c + 1);
      ll::cp_async_wait<1>();
    } else {
      ll::cp_async_wait<0>();
    }
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int ks = (sh.h1p - c * kKC < kKC ? sh.h1p - c * kKC : kKC) / 16;
    ll::warp_mma<1, kNQ, 1, 1, false, true, false>(
        acc, h1s + c * kKC, ld1, 0, (warp % CfgRows::WM) * 16, 0, 1, w2c + (c % 2) * kKC * ld2,
        ld2, 0, (warp / CfgRows::WM) * 16, CfgRows::WN * 16, pairs_of<CfgRows>(sh.h2p, warp), ks,
        lane);
    __syncthreads();  // the chunk is read
  }
  store_rows<TM>(a.h1b, h1s, ld1, r0, a.rows, sh.h1p);
  __syncthreads();  // h1 is stored: the region takes the f32 h2
  rows_each<CfgRows>(acc, sh.h2p, [&](int row, int col, float v) {
    const float h = col < sh.h2 ? tanhf(v + w.b2[col]) : 0.0f;
    hs[row * ld2 + col] = __float2bfloat16_rn(h);
    h2t[row * ldf + col] = h;
  });
  __syncthreads();
  store_rows<TM>(a.h2b, hs, ld2, r0, a.rows, sh.h2p);
  store_rows<TM>(a.h2f, h2t, ldf, r0, a.rows, sh.h2p);
  __syncthreads();  // the region is free for the engine
  PHASE_MARK(1);

  // dh2 = Σ_slabs do W3ᵀ, do = −dll·σ(h2 W3 + b3) in three parts.
  float dh2[1][CfgRows::NQ][2][4];
  ll::hbar_slabs<CfgRows, 1, 1, 3, true, false, true>(dh2, hs, TM * ld2, ws, ds, w.w3, 0,
                                                        sh.h2p, sh.dd, w.b3, srow);
  PHASE_MARK(2);
  // dpre2 = (bf16(dh2) + dll·y_n)(1 − h2²) in three parts, stored a part at
  // a time through the region.
  rows_each<CfgRows>(dh2, sh.h2p, [&](int row, int col, float& v) {
    const long long r = r0 + row;
    float out = 0.0f;
    if (col < sh.h2 && r < a.rows) {
      const float h = a.h2f[r * sh.h2p + col];
      out = (ll::round_bf16(v) + srow[row] * a.y[static_cast<size_t>(srn[row]) * sh.h2 + col]) *
            (1.0f - h * h);
    }
    v = out;
  });
  const size_t plane = static_cast<size_t>(a.rows) * sh.h2p;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    rows_each<CfgRows>(dh2, sh.h2p, [&](int row, int col, float& v) {
      const bf16 p = __float2bfloat16_rn(v);
      pt[row * ld2 + col] = p;
      v -= __bfloat162float(p);  // the remainder: the next part
    });
    __syncthreads();
    store_rows<TM>(a.dp2 + j * plane, pt, ld2, r0, a.rows, sh.h2p);
    __syncthreads();
  }
  PHASE_MARK(3);
}

// Shared memory of mlp_tail (bytes): zb, W1, W2 (staged once a block),
// and the dpre2 parts (then the dpre1 parts) of a tile.
template <int KPMAX>
__host__ __device__ inline size_t tail_smem(const Shape& sh) {
  constexpr int TM = CfgTailOf<KPMAX>::TM;
  const int ld1 = sh.h1p + ll::kPad, ld2 = sh.h2p + ll::kPad;
  const size_t dp = 3 * static_cast<size_t>(TM) * (ld2 > ld1 ? ld2 : ld1);
  return sizeof(bf16) * (static_cast<size_t>(TM) * kLdz + static_cast<size_t>(kDP) * ld1 +
                         static_cast<size_t>(sh.h1p) * ld2 + dp);
}

template <int KPMAX>
__global__ void __launch_bounds__(kTailWarps * 32, 1) mlp_tail(BwdArgs a) {
  using CfgRows = CfgTailOf<KPMAX>;
  constexpr int kNQ = CfgRows::NQ, TM = CfgRows::TM;
  const Shape& sh = a.sh;
  const Weights& w = a.w;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld1 = sh.h1p + ll::kPad, ld2 = sh.h2p + ll::kPad;
  const int dpl = TM * (ld2 > ld1 ? ld2 : ld1);  // one part's plane
  bf16* zb = reinterpret_cast<bf16*>(smem_raw);  // [TM][kLdz]
  bf16* w1s = zb + TM * kLdz;                     // [16][ld1]
  bf16* w2s = w1s + kDP * ld1;                    // [H1p][ld2]
  bf16* dp = w2s + sh.h1p * ld2;                  // 3 × [TM][ld2] dpre2, then [TM][ld1] dpre1
  PHASE_START;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(a.rows) * sh.h2p;
  const long long tiles = (a.rows + TM - 1) / TM;

  ll::stage(w1s, ld1, w.w1, sh.h1p, kDP, sh.h1p, kDP, sh.h1p);
  ll::stage(w2s, ld2, w.w2, sh.h2p, sh.h1p, sh.h2p, sh.h1p, sh.h2p);
  ll::cp_async_commit();
  // This block's dW1 = Σ zᵀ dpre1 (16 × H1p: n16 pairs warp + 8q) and db1.
  constexpr int kP1 = (KPMAX / 16 + kTailWarps - 1) / kTailWarps;
  float dw1[1][kP1][2][4];
  ll::zero(dw1);
  const int nq1 = (sh.h1p / 16 - warp + kTailWarps - 1) / kTailWarps;
  float db1 = 0.0f;  // thread tid < H1p

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * TM;
    for (int j = 0; j < 3; ++j)
      ll::stage(dp + j * dpl, ld2, a.dp2 + j * plane + r0 * sh.h2p, sh.h2p, TM, sh.h2p,
                static_cast<int>(a.rows - r0 < TM ? a.rows - r0 : TM), sh.h2p);
    ll::cp_async_commit();
    stage_z<TM>(zb, a.z, r0, a.rows, sh.d);
    ll::cp_async_wait<0>();
    __syncthreads();

    // h1 = tanh(z W1 + b1) in f32, in the layout of dh1's tiles.
    float h1[1][kNQ][2][4];
    rows_product<CfgRows>(h1, zb, kLdz, w1s, ld1, sh.h1p, 1);
    rows_each<CfgRows>(h1, sh.h1p, [&](int, int col, float& v) {
      v = col < sh.h1 ? tanhf(v + w.b1[col]) : 0.0f;
    });
    // dh1 = dpre2 · W2ᵀ: B(k = h2, n = h1) = W2[h1][h2] ([n][k]).
    float dh1[1][kNQ][2][4];
    ll::zero(dh1);
    ll::warp_mma<1, kNQ, 3, 1, false, false, false>(
        dh1, dp, ld2, dpl, (warp % CfgRows::WM) * 16, 0, 1, w2s, ld2, 0,
        (warp / CfgRows::WM) * 16, CfgRows::WN * 16, pairs_of<CfgRows>(sh.h1p, warp),
        sh.h2p / 16, lane);
    __syncthreads();  // every warp is done with the dpre2 parts
    PHASE_MARK(4);
    // dpre1 = bf16(dh1)(1 − h1²) in three parts, over the dpre2 parts.
    {
      const int m0 = (warp % CfgRows::WM) * 16, nq = pairs_of<CfgRows>(sh.h1p, warp);
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        if (q >= nq) break;
        const int n0 = (warp / CfgRows::WM + CfgRows::WN * q) * 16;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int row = ll::frag_row(m0, lane, e), col = ll::frag_col(n0, h, lane, e);
            bf16 p[2][3];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float hv = h1[0][q][h][e + j];
              const float v =
                  col + j < sh.h1 ? ll::round_bf16(dh1[0][q][h][e + j]) * (1.0f - hv * hv) : 0.0f;
              ll::split<3>(v, p[j]);
            }
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              __nv_bfloat162 pair;
              pair.x = p[0][k];
              pair.y = p[1][k];
              *reinterpret_cast<__nv_bfloat162*>(dp + k * dpl + row * ld1 + col) = pair;
            }
          }
      }
    }
    __syncthreads();
    // db1 += Σ_rows dpre1 in row order (the parts add up to the f32 value).
    if (tid < sh.h1p) {
#pragma unroll 8
      for (int row = 0; row < TM; ++row)
        db1 += (__bfloat162float(dp[row * ld1 + tid]) + __bfloat162float(dp[dpl + row * ld1 + tid])) +
               __bfloat162float(dp[2 * dpl + row * ld1 + tid]);
    }
    // dW1 += zᵀ dpre1: A(m = d, k = row) = z[row][d] ([k][m]), B(k = row, n = h1).
    ll::warp_mma<1, kP1, 1, 3, true, true, false>(dw1, zb, kLdz, 0, 0, 0, 1, dp, ld1, dpl,
                                                  warp * 16, kTailWarps * 16, nq1, TM / 16, lane);
    // dz = bf16(dpre1 W1ᵀ): B(k = h1, n = d) = W1[d][h1] ([n][k]); a warp an m-tile.
    if (warp < TM / 16) {
      float c1[1][1][2][4];
      ll::zero(c1);
      ll::warp_mma<1, 1, 3, 1, false, false, false>(c1, dp, ld1, dpl, warp * 16, 0, 1, w1s, ld1, 0,
                                                    0, 0, 1, sh.h1p / 16, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = ll::frag_row(warp * 16, lane, e), col = ll::frag_col(0, h, lane, e);
          if (r0 + row < a.rows && col < sh.d)
            a.dz[(r0 + row) * sh.d + col] = ll::round_bf16(c1[0][0][h][e]);
        }
    }
    __syncthreads();  // the tile's buffers are free
    PHASE_MARK(5);
  }
  // This block's partials.
  float* pw1 = a.pw1 + static_cast<size_t>(blockIdx.x) * kDP * sh.h1p;
#pragma unroll
  for (int q = 0; q < kP1; ++q) {
    if (q >= nq1) break;
    const int n0 = (warp + kTailWarps * q) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pw1[ll::frag_row(0, lane, e) * sh.h1p + ll::frag_col(n0, h, lane, e)] = dw1[0][q][h][e];
  }
  if (tid < sh.h1p) a.pb1[static_cast<size_t>(blockIdx.x) * sh.h1p + tid] = db1;
}

// Engine block (b): dW3 / db3 (do from o) or dW2 / db2 (dpre2 loaded).
template <int KPMAX, bool kFromO>
__global__ void __launch_bounds__(CfgWOf<KPMAX>::THREADS, CfgWOf<KPMAX>::MINB) mlp_wbar(ll::WbarArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PHASE_START;
  ll::wbar_tiles<CfgWOf<KPMAX>, 1, 1, 3, kFromO, true, true>(a, smem_raw);
  PHASE_MARK(kFromO ? 6 : 7);
}

// dy[n] = Σ dll·h2 and dc[n] = Σ dll over point n's rows (s, then k), one
// block a point, thread j < H2 on column j, the last thread on dc.
__global__ void mlp_dy(const float* dll, const float* h2f, Shape sh, float* dy, float* dc) {
  const int n = blockIdx.x, j = threadIdx.x;
  float acc = 0.0f;
  for (int s = 0; s < sh.s; ++s)
    for (int k = 0; k < sh.k; ++k) {
      const long long r = (static_cast<long long>(s) * sh.n + n) * sh.k + k;
      if (j < sh.h2) acc += dll[r] * h2f[r * sh.h2p + j];
      else if (j == blockDim.x - 1) acc += dll[r];
    }
  if (j < sh.h2) dy[static_cast<size_t>(n) * sh.h2 + j] = acc;
  else if (j == blockDim.x - 1) dc[n] = acc;
}

// out[i·cols + j] = Σ_b P[b·stride + i·ld + j], b in order; rounded to bf16
// when `rnd` (the cotangent of a weight read through a bf16 cast).
__global__ void reduce_partials(const float* P, int blocks, size_t stride, int rows, int cols,
                                int ld, bool rnd, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * cols) return;
  const int i = e / cols, j = e % cols;
  float s = 0.0f;
  for (int bb = 0; bb < blocks; ++bb) s += P[bb * stride + static_cast<size_t>(i) * ld + j];
  out[e] = rnd ? ll::round_bf16(s) : s;
}

Shape make_shape(int n, int k, int s, int d, int h1, int h2, int dd) {
  return Shape{n, k, s, d, h1, h2, dd, round16(h1), round16(h2), round16(dd)};
}

bool shape_ok(const Shape& sh) {
  return sh.n >= 1 && sh.k >= 1 && sh.s >= 1 && sh.d >= 1 && sh.d <= kDP && sh.h1 >= 1 &&
         sh.h1 <= kMaxHidden && sh.h2 >= 1 && sh.h2 <= kMaxHidden && sh.dd >= 1 &&
         static_cast<long long>(sh.n) * sh.k * sh.s < (1LL << 31);
}

// Row splits of an mlp_wbar grid over `cols` columns (about kWaveBlocks
// blocks, each split at least one row tile).
int wbar_splits(long long rows, int cols) {
  using CfgW = CfgWOf<kMaxHidden>;  // TMB and SNB are those of every width class
  const long long tiles = (rows + CfgW::TMB - 1) / CfgW::TMB;
  const int chunks = (round16(cols) + CfgW::SNB - 1) / CfgW::SNB;
  const long long p = kWaveBlocks / chunks;
  return static_cast<int>(p < 1 ? 1 : (p > tiles ? tiles : p));
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, int& opted) {
  if (static_cast<int>(bytes) <= opted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) opted = static_cast<int>(bytes);
  return err;
}

// The backward's scratch, in floats from its start (each 16-byte aligned):
// bf16(h1), bf16(h2), h2, dpre2's parts, then the partials of dW1/db1
// (mlp_tail), dW2/db2 and dW3/db3 (mlp_wbar).
struct Scratch {
  long long h1b, h2b, h2f, dp2, pw1, pb1, pw2, pb2, pw3, pb3, total;
  int s2, s3;  // row splits of the dW2 and dW3 grids
};

Scratch scratch_of(const Shape& sh) {
  const long long m = static_cast<long long>(sh.n) * sh.k * sh.s;
  Scratch c{};
  long long at = 0;
  auto take = [&](long long floats) {
    const long long here = at;
    at += (floats + 3) / 4 * 4;
    return here;
  };
  c.s2 = wbar_splits(m, sh.h2);
  c.s3 = wbar_splits(m, sh.dd);
  c.h1b = take((m * sh.h1p + 1) / 2);
  c.h2b = take((m * sh.h2p + 1) / 2);
  c.h2f = take(m * sh.h2p);
  c.dp2 = take((3 * m * sh.h2p + 1) / 2);
  c.pw1 = take(static_cast<long long>(kTailBlocks) * kDP * sh.h1p);
  c.pb1 = take(static_cast<long long>(kTailBlocks) * sh.h1p);
  c.pw2 = take(static_cast<long long>(c.s2) * sh.h1p * sh.h2p);
  c.pb2 = take(static_cast<long long>(c.s2) * sh.h2p);
  c.pw3 = take(static_cast<long long>(c.s3) * sh.h2p * sh.ddp);
  c.pb3 = take(static_cast<long long>(c.s3) * sh.ddp);
  c.total = at;
  return c;
}

// mlp_rows, mlp_tail and the two mlp_wbar grids for one width class.
template <int KPMAX>
cudaError_t backward(const BwdArgs& a, const Scratch& c, float* scratch, cudaStream_t st) {
  using CfgRows = CfgRowsOf<KPMAX>;
  using CfgW = CfgWOf<KPMAX>;
  const Shape& sh = a.sh;
  const size_t rbytes = rows_smem<CfgRows>(sh), tbytes = tail_smem<KPMAX>(sh);
  const size_t b3bytes = ll::wbar_smem<CfgW, 1, 1, 3, true>(sh.h2p);
  const size_t b2bytes = ll::wbar_smem<CfgW, 1, 1, 3, false>(sh.h1p);
  for (size_t bytes : {rbytes, tbytes, b3bytes, b2bytes})
    if (bytes > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  static int opted_r = 0, opted_t = 0, opted_w3 = 0, opted_w2 = 0;
  cudaError_t err = opt_in(mlp_rows<KPMAX>, rbytes, opted_r);
  if (err != cudaSuccess) return err;
  mlp_rows<KPMAX><<<static_cast<unsigned>((a.rows + CfgRows::TM - 1) / CfgRows::TM), CfgRows::THREADS,
                    rbytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = opt_in(mlp_tail<KPMAX>, tbytes, opted_t);
  if (err != cudaSuccess) return err;
  mlp_tail<KPMAX><<<kTailBlocks, kTailWarps * 32, tbytes, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ll::WbarArgs w3a{};  // dW3, db3: H = bf16(h2), do from o
  w3a.h = a.h2b;
  w3a.w = a.w.w3;
  w3a.bias = a.w.b3;
  w3a.srow = a.dll;
  w3a.m = static_cast<int>(a.rows);
  w3a.kp = sh.h2p;
  w3a.d = sh.dd;
  w3a.splits = c.s3;
  w3a.pw = scratch + c.pw3;
  w3a.pb = scratch + c.pb3;
  err = opt_in(mlp_wbar<KPMAX, true>, b3bytes, opted_w3);
  if (err != cudaSuccess) return err;
  mlp_wbar<KPMAX, true><<<dim3((sh.ddp + CfgW::SNB - 1) / CfgW::SNB, c.s3), CfgW::THREADS,
                          b3bytes, st>>>(w3a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ll::WbarArgs w2a{};  // dW2, db2: H = bf16(h1), dpre2 loaded
  w2a.h = a.h1b;
  w2a.g = a.dp2;
  w2a.gps = static_cast<size_t>(a.rows) * sh.h2p;
  w2a.m = static_cast<int>(a.rows);
  w2a.kp = sh.h1p;
  w2a.d = sh.h2;
  w2a.splits = c.s2;
  w2a.pw = scratch + c.pw2;
  w2a.pb = scratch + c.pb2;
  err = opt_in(mlp_wbar<KPMAX, false>, b2bytes, opted_w2);
  if (err != cudaSuccess) return err;
  mlp_wbar<KPMAX, false><<<dim3((sh.h2p + CfgW::SNB - 1) / CfgW::SNB, c.s2), CfgW::THREADS,
                           b2bytes, st>>>(w2a);
  return cudaGetLastError();
}

}  // namespace

SVAX_PHASE_ENTRY(decoder_mlp_phase_clocks)

extern "C" {

// Floats of the backward's scratch for these shapes (0: outside the class).
long long decoder_mlp_scratch_floats(int n, int k, int s, int d, int h1, int h2, int dd) {
  const Shape sh = make_shape(n, k, s, d, h1, h2, dd);
  return shape_ok(sh) ? scratch_of(sh).total : 0;
}

// Forward: ll (S·N·K) from z (S·N·K, d), the padded bf16 weights, the f32
// biases, y (N, H2) and c (N).
int decoder_mlp_forward(const float* z, int n, int k, int s, int d, int h1, int h2, int dd,
                        const bf16* w1, const bf16* w1t, const bf16* w2, const bf16* w2t,
                        const bf16* w3, const bf16* w3t, const float* b1, const float* b2,
                        const float* b3, const float* y, const float* c, float* ll,
                        void* stream) {
  const Shape sh = make_shape(n, k, s, d, h1, h2, dd);
  if (!shape_ok(sh)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int NW = kFwdThreads / 32;
  const size_t bytes = static_cast<size_t>(kFwdRows) * (kDP + sh.h1p + sh.h2p) * sizeof(bf16) +
                       static_cast<size_t>(kFwdRows) * (2 * NW * sizeof(float) + sizeof(int));
  static int opted = 0;
  cudaError_t err = opt_in(decoder_fwd, bytes, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdArgs a{z, y, c, ll, Weights{w1, w1t, w2, w2t, w3, w3t, b1, b2, b3}, sh,
            static_cast<long long>(n) * k * s};
  const long long blocks = (a.rows + kFwdRows - 1) / kFwdRows;
  decoder_fwd<<<static_cast<unsigned>(blocks), kFwdThreads, bytes,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Backward: from dll (S·N·K), the cotangents dz (S·N·K, d) (bf16-valued),
// dy (N, H2), dc (N), dW1 (d, H1), db1, dW2 (H1, H2), db2, dW3 (H2, D),
// db3; dW rounded to bf16. `scratch` holds decoder_mlp_scratch_floats.
int decoder_mlp_backward(const float* z, const float* dll, int n, int k, int s, int d, int h1,
                         int h2, int dd, const bf16* w1, const bf16* w1t, const bf16* w2,
                         const bf16* w2t, const bf16* w3, const bf16* w3t, const float* b1,
                         const float* b2, const float* b3, const float* y, float* dz, float* dy,
                         float* dc, float* scratch, float* dw1, float* db1, float* dw2,
                         float* db2, float* dw3, float* db3, void* stream) {
  const Shape sh = make_shape(n, k, s, d, h1, h2, dd);
  if (!shape_ok(sh)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch c = scratch_of(sh);
  const long long m = static_cast<long long>(n) * k * s;
  BwdArgs a{z, dll, y, Weights{w1, w1t, w2, w2t, w3, w3t, b1, b2, b3}, sh, m,
            reinterpret_cast<bf16*>(scratch + c.h1b), reinterpret_cast<bf16*>(scratch + c.h2b),
            scratch + c.h2f, reinterpret_cast<bf16*>(scratch + c.dp2), dz, scratch + c.pw1,
            scratch + c.pb1};
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = (sh.h1p <= 224 && sh.h2p <= 224)
                              ? backward<224>(a, c, scratch, st)
                              : backward<kMaxHidden>(a, c, scratch, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Each partial is (padded rows, ld); the outputs are unpadded.
  const struct {
    const float* p;
    int blocks, rows, padded_rows, cols, ld;
    bool rnd;
    float* out;
  } parts[] = {{scratch + c.pw1, kTailBlocks, d, kDP, h1, sh.h1p, true, dw1},
               {scratch + c.pb1, kTailBlocks, 1, 1, h1, sh.h1p, false, db1},
               {scratch + c.pw2, c.s2, h1, sh.h1p, h2, sh.h2p, true, dw2},
               {scratch + c.pb2, c.s2, 1, 1, h2, sh.h2p, false, db2},
               {scratch + c.pw3, c.s3, h2, sh.h2p, dd, sh.ddp, true, dw3},
               {scratch + c.pb3, c.s3, 1, 1, dd, sh.ddp, false, db3}};
  for (const auto& p : parts) {
    const int len = p.rows * p.cols;
    reduce_partials<<<(len + 255) / 256, 256, 0, st>>>(
        p.p, p.blocks, static_cast<size_t>(p.padded_rows) * p.ld, p.rows, p.cols, p.ld, p.rnd,
        p.out);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mlp_dy<<<n, h2 + 1, 0, st>>>(dll, a.h2f, sh, dy, dc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
