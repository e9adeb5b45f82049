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
// first (the reference's own rounding points, PERF.md).
//
// Bound: at bigk (S·N·K = 102,400 rows, d = 10, 200-200, D = 784) the
// forward does 2·rows·(d·H1 + H1·H2 + H2·D) = 40.7 GFLOP (41 µs at the
// 989 TFLOP/s bf16 tensor-core peak) and ~201 M tanh and logσ evaluations
// (~48 µs at 16 special functions per clock per SM); the backward about
// three times the products. Bytes (z, y, ll, the weights; ~6 MB) are
// under 2 µs: the kernels are bound by operations, not bytes.
//
// Design. Products are mma.sync m16n8k16 bf16 with f32 accumulation, one
// 16×8 output tile per instruction per warp, the fragments built in
// registers (operands rounded to bf16 with __float2bfloat16_rn, round-to-
// nearest-even as torch's casts). Weights come as zero-padded bf16 copies
// (d, H1, H2 and D padded to 16; tanh(0) = 0 so padding adds nothing), in
// both the (in, out) and (out, in) layouts, read from global memory (they
// stay in L2: 0.5 MB at bigk). An f32 operand that must not be rounded
// (a cotangent in the backward) is split into three bf16 parts, hi + mid +
// lo, which carry its 24 bits, and enters three products.
// * Forward: a block of 8 warps takes 64 rows, keeps z, h1 and h2 as bf16
//   in shared memory, forms the t-term from the f32 h2 in registers, and
//   walks the D columns of W3 in 8-wide tiles, adding logσ(−o) into
//   per-row sums; each warp spans all 64 rows, so a weight fragment read
//   from L2 serves four products; per-row partials are added in a fixed
//   order (no atomics).
// * Backward: a fixed number of blocks (min(132, N)) of 16 warps; each
//   block owns whole points n (all their (s, k) rows), so dy[n] and dc[n]
//   are written by one block alone. It walks its rows in tiles of 128 (64
//   for hidden widths above 208): recompute h1 and h2 (f32, shared memory,
//   rows padded by 4 floats against bank conflicts), then for each
//   64-column slab of D: o, do = −dll·σ(o), dh2 += do W3ᵀ (registers), and
//   this block's dW3 / db3 partial += h2ᵀ do (global memory, read-modify-
//   write by one thread per entry, in strips of 8 tiles that share one
//   split cotangent fragment); then dy, dc, dpre2 = (bf16(dh2) + dll·y)
//   (1 − h2²), dW2 and db2, dh1, dpre1, dW1, db1 and dz. A second kernel
//   adds the block partials in block order and rounds
//   dW to bf16. No float atomics: reruns are bit-equal.
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDP = 16;          // latent d padded to one k-step
constexpr int kMaxHidden = 256;
constexpr int kFwdRows = 64;     // rows per forward block
constexpr int kFwdThreads = 256;  // 8 warps
constexpr int kBwdThreads = 512;  // 16 warps
constexpr int kSlab = 64;        // D columns per backward slab
constexpr int kBwdBlocks = 132;  // partials are added in block order
constexpr int kTiles = 16;       // 16×8 accumulator tiles a warp holds
constexpr int kSmemMax = 232448;  // bytes a block may opt into (sm_90)

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// ------------------------------------------------------------ fragments

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v = p[0] + p[1] + p[2] with each part bf16 (the residues are exact in f32).
__device__ __forceinline__ void split3(float v, float (&p)[3]) {
  p[0] = round_bf16(v);
  const float r = v - p[0];
  p[1] = round_bf16(r);
  p[2] = round_bf16(r - p[1]);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Lane roles in m16n8k16 (PTX ISA): g = lane / 4 is the row (A, C) or the
// column (B); t = lane % 4 picks the pair of k (A, B) or columns (C).
// A regs: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..).
// B regs: (k = 2t..2t+1, n = g), (k = 2t+8..2t+9, n = g).
// C: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).

// A from bf16 row-major storage, base at (m0, k0).
__device__ __forceinline__ void a_bf16(uint32_t (&a)[4], const bf16* base, int ld, int g, int t) {
  const bf16* p0 = base + g * ld + 2 * t;
  const bf16* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// A from f32 row-major storage, rounded to bf16.
__device__ __forceinline__ void a_f32(uint32_t (&a)[4], const float* base, int ld, int g, int t) {
  const float* p0 = base + g * ld + 2 * t;
  const float* p1 = p0 + 8 * ld;
  a[0] = pack(p0[0], p0[1]);
  a[1] = pack(p1[0], p1[1]);
  a[2] = pack(p0[8], p0[9]);
  a[3] = pack(p1[8], p1[9]);
}

// A from f32 row-major storage, split into three bf16 parts.
__device__ __forceinline__ void a_split(uint32_t (&a)[3][4], const float* base, int ld, int g,
                                        int t) {
  const float* p0 = base + g * ld + 2 * t;
  const float* p1 = p0 + 8 * ld;
  const float v[8] = {p0[0], p0[1], p1[0], p1[1], p0[8], p0[9], p1[8], p1[9]};
  float s[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i) split3(v[i], s[i]);
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[q][r] = pack(s[2 * r][q], s[2 * r + 1][q]);
}

// A(m, k) = src[k][m] from f32 row-major storage (base at (k0, m0)), rounded.
__device__ __forceinline__ void a_f32_trans(uint32_t (&a)[4], const float* base, int ld, int g,
                                            int t) {
  const float* k0 = base + (2 * t) * ld;
  const float* k1 = k0 + ld;
  const float* k8 = k0 + 8 * ld;
  const float* k9 = k8 + ld;
  a[0] = pack(k0[g], k1[g]);
  a[1] = pack(k0[g + 8], k1[g + 8]);
  a[2] = pack(k8[g], k9[g]);
  a[3] = pack(k8[g + 8], k9[g + 8]);
}

// A(m, k) = src[k][m] from bf16 row-major storage.
__device__ __forceinline__ void a_bf16_trans(uint32_t (&a)[4], const bf16* base, int ld, int g,
                                             int t) {
  const bf16* k0 = base + (2 * t) * ld;
  const bf16* k1 = k0 + ld;
  const bf16* k8 = k0 + 8 * ld;
  const bf16* k9 = k8 + ld;
  a[0] = pack_raw(k0[g], k1[g]);
  a[1] = pack_raw(k0[g + 8], k1[g + 8]);
  a[2] = pack_raw(k8[g], k9[g]);
  a[3] = pack_raw(k8[g + 8], k9[g + 8]);
}

// B(k, n) from bf16 storage laid out [n][k] (k contiguous), base at (n0, k0).
__device__ __forceinline__ void b_bf16(uint32_t (&b)[2], const bf16* base, int ld, int g, int t) {
  const bf16* p = base + g * ld + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B(k, n) = src[k][n] from f32 row-major storage (base at (k0, n0)), split.
__device__ __forceinline__ void b_split(uint32_t (&b)[3][2], const float* base, int ld, int g,
                                        int t) {
  const float* p = base + (2 * t) * ld + g;
  float s[4][3];
  split3(p[0], s[0]);
  split3(p[ld], s[1]);
  split3(p[8 * ld], s[2]);
  split3(p[9 * ld], s[3]);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    b[q][0] = pack(s[0][q], s[1][q]);
    b[q][1] = pack(s[2][q], s[3][q]);
  }
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

// The same with A in three bf16 parts (smallest first into one product).
__device__ __forceinline__ void mma_add3a(float (&c)[4], const uint32_t (&a)[3][4],
                                          const uint32_t (&b)[2]) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(p, a[2], b);
  mma(p, a[1], b);
  mma(p, a[0], b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

// The same with B in three bf16 parts.
__device__ __forceinline__ void mma_add3b(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[3][2]) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma(p, a, b[2]);
  mma(p, a, b[1]);
  mma(p, a, b[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;
}

// logσ(−o) = −softplus(o), as torch's log_sigmoid.
__device__ __forceinline__ float logsig_neg(float o) {
  return -(fmaxf(o, 0.0f) + log1pf(expf(-fabsf(o))));
}

// σ(o), as torch's log_sigmoid_backward forms it for the input −o.
__device__ __forceinline__ float sigmoid_as_torch(float o) {
  const float e = expf(-fabsf(o));
  return o > 0.0f ? 1.0f - e / (1.0f + e) : e / (1.0f + e);
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
  const Shape sh = a.sh;
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

struct BwdArgs {
  const float* __restrict__ z;    // (S·N·K, d)
  const float* __restrict__ dll;  // (S·N·K,)
  const float* __restrict__ y;    // (N, H2)
  Weights w;
  Shape sh;
  int blocks;
  float* dz;  // (S·N·K, d)
  float* dy;  // (N, H2)
  float* dc;  // (N,)
  // This block's partial sums, each (blocks, ...): dW1 (16, H1p), db1
  // (H1p), dW2 (H1p, H2p), db2 (H2p), dW3 (H2p, Dp), db3 (Dp).
  float* pw1;
  float* pb1;
  float* pw2;
  float* pb2;
  float* pw3;
  float* pb3;
};

// Row strides of the backward's f32 tiles: 4 floats past the width, so the
// transposed fragment loads (lanes on rows 2t) fall in distinct banks and
// the row loads (lanes on rows g) in at most two.
__host__ __device__ inline int bwd_hs(const Shape& sh) { return sh.h2p + 4; }
__host__ __device__ inline int bwd_xw(const Shape& sh) {
  return (sh.h1p > kSlab ? sh.h1p : kSlab) + 4;
}

__host__ __device__ inline size_t bwd_smem(const Shape& sh, int tm) {
  return static_cast<size_t>(tm) * (bwd_hs(sh) + bwd_xw(sh)) * sizeof(float)  // h2f, X
         + static_cast<size_t>(tm) * kDP * sizeof(bf16)                     // zb
         + static_cast<size_t>(tm) * 3 * sizeof(float);                     // dll, n, r
}

// A strip of a block partial: the 16×8 tiles (m_begin + i, n0) for i <
// m_count ≤ kStrip, acc = (first ? 0 : P) + Aᵀ B over the tile's rows, then
// P = acc. A(m, k) = asrc[k][m] (f32 rounded to bf16, or bf16), B(k, n) =
// bsrc[k][n] (f32, split; the caller offsets bsrc to column n0). B's three
// parts are built once per k-step for the whole strip.
constexpr int kStrip = 8;

template <int TM, bool ABF16>
__device__ __forceinline__ void partial_strip(float* P, int ldp, int m_begin, int m_count,
                                              int n0, bool first, const void* asrc, int lda,
                                              const float* bsrc, int ldb, int g, int t) {
  float c[kStrip][4];
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    const float* p0 = P + ((m_begin + i) * 16 + g) * ldp + n0 + 2 * t;
    const float* p1 = p0 + 8 * ldp;
    const bool load = i < m_count && !first;
    c[i][0] = load ? p0[0] : 0.0f;
    c[i][1] = load ? p0[1] : 0.0f;
    c[i][2] = load ? p1[0] : 0.0f;
    c[i][3] = load ? p1[1] : 0.0f;
  }
  for (int ks = 0; ks < TM / 16; ++ks) {
    uint32_t fb[3][2];
    b_split(fb, bsrc + ks * 16 * ldb, ldb, g, t);
#pragma unroll
    for (int i = 0; i < kStrip; ++i) {
      if (i < m_count) {
        const int m0 = (m_begin + i) * 16;
        uint32_t fa[4];
        if constexpr (ABF16)
          a_bf16_trans(fa, static_cast<const bf16*>(asrc) + ks * 16 * lda + m0, lda, g, t);
        else
          a_f32_trans(fa, static_cast<const float*>(asrc) + ks * 16 * lda + m0, lda, g, t);
        mma_add3b(c[i], fa, fb);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    if (i < m_count) {
      float* p0 = P + ((m_begin + i) * 16 + g) * ldp + n0 + 2 * t;
      float* p1 = p0 + 8 * ldp;
      p0[0] = c[i][0];
      p0[1] = c[i][1];
      p1[0] = c[i][2];
      p1[1] = c[i][3];
    }
  }
}

// Every strip of a (mtiles × ntiles) partial, spread over the warps: item
// = (n-tile, chunk of kStrip m-tiles). bsrc points at column 0 of B.
template <int TM, bool ABF16>
__device__ __forceinline__ void partial_product(float* P, int ldp, int mtiles, int ntiles,
                                                int pcol0, bool first, const void* asrc,
                                                int lda, const float* bsrc, int ldb, int warp,
                                                int nwarps, int g, int t) {
  const int chunks = (mtiles + kStrip - 1) / kStrip;
  for (int item = warp; item < ntiles * chunks; item += nwarps) {
    const int nj = item % ntiles, ch = item / ntiles;
    const int mb = ch * kStrip, mc = mtiles - mb < kStrip ? mtiles - mb : kStrip;
    partial_strip<TM, ABF16>(P, ldp, mb, mc, pcol0 + nj * 8, first, asrc, lda, bsrc + nj * 8,
                             ldb, g, t);
  }
}

// A block's column sums of X (TM rows, ld) into P[col] (first: =, else +=).
template <int TM>
__device__ __forceinline__ void partial_colsum(float* P, const float* X, int ld, int cols,
                                               bool first) {
  for (int col = threadIdx.x; col < cols; col += blockDim.x) {
    float s = 0.0f;
    for (int row = 0; row < TM; ++row) s += X[row * ld + col];
    P[col] = first ? s : P[col] + s;
  }
}

template <int TM>
__global__ void __launch_bounds__(kBwdThreads, 1) decoder_bwd(BwdArgs a) {
  constexpr int MT = TM / 16, G = (kBwdThreads / 32) / MT, NW = kBwdThreads / 32;
  const Shape sh = a.sh;
  const Weights& w = a.w;
  const int xw = bwd_xw(sh), hs = bwd_hs(sh);  // row strides
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* h2f = reinterpret_cast<float*>(smem_raw);  // (TM, hs): h2, then dpre2
  float* X = h2f + TM * hs;                         // (TM, xw): h1 | do | dpre1
  bf16* zb = reinterpret_cast<bf16*>(X + TM * xw);  // (TM, 16)
  float* sg = reinterpret_cast<float*>(zb + TM * kDP);  // (TM,) dll, 0 past the end
  int* sn = reinterpret_cast<int*>(sg + TM);        // (TM,) n, −1 past the end
  int* sr = sn + TM;                                // (TM,) row of z, ll

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.x;
  const int p0 = static_cast<int>(static_cast<long long>(b) * sh.n / a.blocks);
  const int p1 = static_cast<int>(static_cast<long long>(b + 1) * sh.n / a.blocks);
  const long long per_s = static_cast<long long>(p1 - p0) * sh.k;
  const long long nrows = per_s * sh.s;
  const int ntiles = static_cast<int>((nrows + TM - 1) / TM);
  float* pw1 = a.pw1 + static_cast<size_t>(b) * kDP * sh.h1p;
  float* pb1 = a.pb1 + static_cast<size_t>(b) * sh.h1p;
  float* pw2 = a.pw2 + static_cast<size_t>(b) * sh.h1p * sh.h2p;
  float* pb2 = a.pb2 + static_cast<size_t>(b) * sh.h2p;
  float* pw3 = a.pw3 + static_cast<size_t>(b) * sh.h2p * sh.ddp;
  float* pb3 = a.pb3 + static_cast<size_t>(b) * sh.ddp;

  // dy and dc of this block's points: one thread per column of dy, and the
  // last thread for dc, zero them here and alone add into them below.
  const bool owns_dc = tid == kBwdThreads - 1;
  for (int p = p0; p < p1; ++p) {
    if (tid < sh.h2) a.dy[static_cast<size_t>(p) * sh.h2 + tid] = 0.0f;
    if (owns_dc) a.dc[p] = 0.0f;
  }

  const int mt = warp % MT, grp = warp / MT, m0 = mt * 16;
  const int rA = m0 + g, rB = m0 + g + 8;
  float acc[kTiles][4];  // dh2, then dh1: the warp's tiles of the (TM, H) cotangent

  // h1 = tanh(z W1 + b1) into X (f32).
  auto layer1 = [&]() {
    const int n1 = sh.h1p / 8;
    float c1[kTiles][4];
    zero(c1);
    uint32_t fa[4];
    a_bf16(fa, zb + m0 * kDP, kDP, g, t);
#pragma unroll
    for (int q = 0; q < kTiles; ++q) {
      const int j = grp + G * q;
      if (j < n1) {
        uint32_t fb[2];
        b_bf16(fb, w.w1t + j * 8 * kDP, kDP, g, t);
        mma_add(c1[q], fa, fb);
      }
    }
#pragma unroll
    for (int q = 0; q < kTiles; ++q) {
      const int j = grp + G * q;
      if (j < n1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? rA : rB, col = j * 8 + 2 * t + (e & 1);
          X[row * xw + col] = col < sh.h1 ? tanhf(c1[q][e] + w.b1[col]) : 0.0f;
        }
      }
    }
  };

  for (int tile = 0; tile < ntiles; ++tile) {
    const bool first = tile == 0;
    for (int row = tid; row < TM; row += blockDim.x) {
      const long long v = static_cast<long long>(tile) * TM + row;
      if (v < nrows) {
        const long long s = v / per_s, rem = v % per_s;
        const long long r = (s * sh.n + p0) * sh.k + rem;
        sr[row] = static_cast<int>(r);
        sn[row] = p0 + static_cast<int>(rem / sh.k);
        sg[row] = a.dll[r];
      } else {
        sr[row] = -1;
        sn[row] = -1;
        sg[row] = 0.0f;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < TM * kDP; idx += blockDim.x) {
      const int row = idx / kDP, col = idx % kDP;
      const int r = sr[row];
      zb[idx] = __float2bfloat16_rn(r >= 0 && col < sh.d ? a.z[static_cast<size_t>(r) * sh.d + col]
                                                         : 0.0f);
    }
    __syncthreads();
    layer1();
    __syncthreads();

    // h2 = tanh(h1 W2 + b2) into h2f.
    const int n2 = sh.h2p / 8;
    zero(acc);
    for (int ks = 0; ks < sh.h1p / 16; ++ks) {
      uint32_t fa[4];
      a_f32(fa, X + m0 * xw + ks * 16, xw, g, t);
#pragma unroll
      for (int q = 0; q < kTiles; ++q) {
        const int j = grp + G * q;
        if (j < n2) {
          uint32_t fb[2];
          b_bf16(fb, w.w2t + j * 8 * sh.h1p + ks * 16, sh.h1p, g, t);
          mma_add(acc[q], fa, fb);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kTiles; ++q) {
      const int j = grp + G * q;
      if (j < n2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? rA : rB, col = j * 8 + 2 * t + (e & 1);
          h2f[row * hs + col] = col < sh.h2 ? tanhf(acc[q][e] + w.b2[col]) : 0.0f;
        }
      }
    }
    __syncthreads();

    // The D slabs: do, dh2 += do W3ᵀ, and the dW3 / db3 partials.
    zero(acc);
    for (int c0 = 0; c0 < sh.ddp; c0 += kSlab) {
      const int ns = sh.ddp - c0 < kSlab ? sh.ddp - c0 : kSlab;  // a multiple of 16
      const int nt = ns / 8;
      {  // o = h2 W3[:, slab] + b3 → do = −dll·σ(o) into X.
        constexpr int NQ = kSlab / 8 / G > 0 ? kSlab / 8 / G : 1;
        float co[NQ][4];
        zero(co);
        for (int ks = 0; ks < sh.h2p / 16; ++ks) {
          uint32_t fa[4];
          a_f32(fa, h2f + m0 * hs + ks * 16, hs, g, t);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int j = grp + G * q;
            if (j < nt) {
              uint32_t fb[2];
              b_bf16(fb, w.w3t + static_cast<size_t>(c0 + j * 8) * sh.h2p + ks * 16, sh.h2p, g,
                     t);
              mma_add(co[q], fa, fb);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int j = grp + G * q;
          if (j < nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = e < 2 ? rA : rB, cl = j * 8 + 2 * t + (e & 1), col = c0 + cl;
              X[row * xw + cl] =
                  col < sh.dd ? -(sg[row] * sigmoid_as_torch(co[q][e] + w.b3[col])) : 0.0f;
            }
          }
        }
      }
      __syncthreads();
      // dh2 += do · W3[:, slab]ᵀ (do split: it is an f32 cotangent).
      for (int ks = 0; ks < ns / 16; ++ks) {
        uint32_t fa[3][4];
        a_split(fa, X + m0 * xw + ks * 16, xw, g, t);
#pragma unroll
        for (int q = 0; q < kTiles; ++q) {
          const int j = grp + G * q;
          if (j < n2) {
            uint32_t fb[2];
            b_bf16(fb, w.w3 + static_cast<size_t>(j) * 8 * sh.ddp + c0 + ks * 16, sh.ddp, g, t);
            mma_add3a(acc[q], fa, fb);
          }
        }
      }
      // dW3[:, slab] += h2ᵀ do; db3[slab] += Σ_rows do.
      partial_product<TM, false>(pw3, sh.ddp, sh.h2p / 16, nt, c0, first, h2f, hs, X, xw,
                                 warp, NW, g, t);
      partial_colsum<TM>(pb3 + c0, X, xw, ns, first);
      __syncthreads();
    }

    // dy[n] += Σ dll·h2, dc[n] += Σ dll over the tile's rows, in row order.
    if (tid < sh.h2 || owns_dc) {
      int cur = -1;
      float s = 0.0f;
      for (int row = 0; row < TM; ++row) {
        const int nn = sn[row];
        if (nn != cur) {
          if (cur >= 0) {
            if (owns_dc) a.dc[cur] += s; else a.dy[static_cast<size_t>(cur) * sh.h2 + tid] += s;
          }
          cur = nn;
          s = 0.0f;
        }
        if (nn >= 0) s += owns_dc ? sg[row] : sg[row] * h2f[row * hs + tid];
      }
      if (cur >= 0) {
        if (owns_dc) a.dc[cur] += s; else a.dy[static_cast<size_t>(cur) * sh.h2 + tid] += s;
      }
    }
    __syncthreads();

    // dpre2 = (bf16(dh2) + dll·y_n)(1 − h2²), in place of h2.
#pragma unroll
    for (int q = 0; q < kTiles; ++q) {
      const int j = grp + G * q;
      if (j < n2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? rA : rB, col = j * 8 + 2 * t + (e & 1);
          float v = 0.0f;
          const int nn = sn[row];
          if (col < sh.h2 && nn >= 0) {
            const float h = h2f[row * hs + col];
            const float dh = round_bf16(acc[q][e]) + sg[row] * a.y[static_cast<size_t>(nn) * sh.h2 + col];
            v = dh * (1.0f - h * h);
          }
          h2f[row * hs + col] = v;
        }
      }
    }
    __syncthreads();

    // h1 again (X held do), then dW2 += h1ᵀ dpre2 and db2 += Σ dpre2.
    layer1();
    __syncthreads();
    {
      partial_product<TM, false>(pw2, sh.h2p, sh.h1p / 16, sh.h2p / 8, 0, first, X, xw, h2f,
                                 hs, warp, NW, g, t);
      partial_colsum<TM>(pb2, h2f, hs, sh.h2p, first);
    }

    // dh1 = dpre2 W2ᵀ (dpre2 split).
    const int n1 = sh.h1p / 8;
    zero(acc);
    for (int ks = 0; ks < sh.h2p / 16; ++ks) {
      uint32_t fa[3][4];
      a_split(fa, h2f + m0 * hs + ks * 16, hs, g, t);
#pragma unroll
      for (int q = 0; q < kTiles; ++q) {
        const int j = grp + G * q;
        if (j < n1) {
          uint32_t fb[2];
          b_bf16(fb, w.w2 + j * 8 * sh.h2p + ks * 16, sh.h2p, g, t);
          mma_add3a(acc[q], fa, fb);
        }
      }
    }
    __syncthreads();  // every warp is done reading h1 in X
    // dpre1 = bf16(dh1)(1 − h1²), in place of h1.
#pragma unroll
    for (int q = 0; q < kTiles; ++q) {
      const int j = grp + G * q;
      if (j < n1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? rA : rB, col = j * 8 + 2 * t + (e & 1);
          const float h = X[row * xw + col];
          X[row * xw + col] = col < sh.h1 ? round_bf16(acc[q][e]) * (1.0f - h * h) : 0.0f;
        }
      }
    }
    __syncthreads();

    // dW1 += zᵀ dpre1, db1 += Σ dpre1, dz = bf16(dpre1 W1ᵀ).
    partial_product<TM, true>(pw1, sh.h1p, 1, n1, 0, first, zb, kDP, X, xw, warp, NW, g, t);
    partial_colsum<TM>(pb1, X, xw, sh.h1p, first);
    if (grp < kDP / 8) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int ks = 0; ks < sh.h1p / 16; ++ks) {
        uint32_t fa[3][4], fb[2];
        a_split(fa, X + m0 * xw + ks * 16, xw, g, t);
        b_bf16(fb, w.w1 + grp * 8 * sh.h1p + ks * 16, sh.h1p, g, t);
        mma_add3a(c, fa, fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? rA : rB, col = grp * 8 + 2 * t + (e & 1);
        const int r = sr[row];
        if (r >= 0 && col < sh.d) a.dz[static_cast<size_t>(r) * sh.d + col] = round_bf16(c[e]);
      }
    }
    __syncthreads();
  }
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
  out[e] = rnd ? round_bf16(s) : s;
}

Shape make_shape(int n, int k, int s, int d, int h1, int h2, int dd) {
  return Shape{n, k, s, d, h1, h2, dd, round16(h1), round16(h2), round16(dd)};
}

bool shape_ok(const Shape& sh) {
  return sh.n >= 1 && sh.k >= 1 && sh.s >= 1 && sh.d >= 1 && sh.d <= kDP && sh.h1 >= 1 &&
         sh.h1 <= kMaxHidden && sh.h2 >= 1 && sh.h2 <= kMaxHidden && sh.dd >= 1 &&
         static_cast<long long>(sh.n) * sh.k * sh.s < (1LL << 31);
}

int bwd_blocks(int n) { return n < kBwdBlocks ? n : kBwdBlocks; }

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, int& opted) {
  if (static_cast<int>(bytes) <= opted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) opted = static_cast<int>(bytes);
  return err;
}

}  // namespace

extern "C" {

// Floats of the backward's partial buffer for N points and these widths.
long long decoder_mlp_partial_floats(int n, int h1, int h2, int dd) {
  const long long h1p = round16(h1), h2p = round16(h2), ddp = round16(dd);
  return static_cast<long long>(bwd_blocks(n)) *
         (kDP * h1p + h1p + h1p * h2p + h2p + h2p * ddp + ddp);
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
// db3; dW rounded to bf16. `partial` holds decoder_mlp_partial_floats.
int decoder_mlp_backward(const float* z, const float* dll, int n, int k, int s, int d, int h1,
                         int h2, int dd, const bf16* w1, const bf16* w1t, const bf16* w2,
                         const bf16* w2t, const bf16* w3, const bf16* w3t, const float* b1,
                         const float* b2, const float* b3, const float* y, float* dz, float* dy,
                         float* dc, float* partial, float* dw1, float* db1, float* dw2,
                         float* db2, float* dw3, float* db3, void* stream) {
  const Shape sh = make_shape(n, k, s, d, h1, h2, dd);
  if (!shape_ok(sh)) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = bwd_blocks(n);
  float* pw1 = partial;
  float* pb1 = pw1 + static_cast<size_t>(nb) * kDP * sh.h1p;
  float* pw2 = pb1 + static_cast<size_t>(nb) * sh.h1p;
  float* pb2 = pw2 + static_cast<size_t>(nb) * sh.h1p * sh.h2p;
  float* pw3 = pb2 + static_cast<size_t>(nb) * sh.h2p;
  float* pb3 = pw3 + static_cast<size_t>(nb) * sh.h2p * sh.ddp;
  BwdArgs a{z, dll, y, Weights{w1, w1t, w2, w2t, w3, w3t, b1, b2, b3}, sh, nb, dz, dy, dc,
            pw1, pb1, pw2, pb2, pw3, pb3};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bwd_smem(sh, 128) <= static_cast<size_t>(kSmemMax)) {
    static int opted = 0;
    const size_t bytes = bwd_smem(sh, 128);
    err = opt_in(decoder_bwd<128>, bytes, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    decoder_bwd<128><<<nb, kBwdThreads, bytes, st>>>(a);
  } else {
    static int opted = 0;
    const size_t bytes = bwd_smem(sh, 64);
    err = opt_in(decoder_bwd<64>, bytes, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    decoder_bwd<64><<<nb, kBwdThreads, bytes, st>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Each block's partial is (padded rows, ld); the outputs are unpadded.
  const struct {
    const float* p;
    int rows, padded_rows, cols, ld;
    bool rnd;
    float* out;
  } parts[] = {{pw1, d, kDP, h1, sh.h1p, true, dw1},     {pb1, 1, 1, h1, sh.h1p, false, db1},
               {pw2, h1, sh.h1p, h2, sh.h2p, true, dw2}, {pb2, 1, 1, h2, sh.h2p, false, db2},
               {pw3, h2, sh.h2p, dd, sh.ddp, true, dw3}, {pb3, 1, 1, dd, sh.ddp, false, db3}};
  for (const auto& p : parts) {
    const int len = p.rows * p.cols;
    reduce_partials<<<(len + 255) / 256, 256, 0, st>>>(
        p.p, nb, static_cast<size_t>(p.padded_rows) * p.ld, p.rows, p.cols, p.ld, p.rnd, p.out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
