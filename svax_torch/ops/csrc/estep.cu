// estep: the fused GMM E-step and its sufficient statistics, general d.
//
// Replaces the TPU kernel svax/ops/estep_pallas.py (_fused_kernel_call →
// pallas_call, entry e_step_stats_fused). From x (N, d) and the expected
// parameters of K components (E[log π], E[log|Λ|], E[μᵀΛμ], E[Λμ], E[Λ])
// it writes the statistics — counts (K), Σ r x (K, d) and Σ r xxᵀ
// (K, d, d), times `scale` — and the per-point evidence lse_k log ρ (N).
//
// Folded features. log ρ = Φ′W′ and S′ = Φ′ᵀR, R = softmax_k(log ρ), with
// Φ′(x) = [1, x, x_i·x_j for i ≥ j]: F′ = 1 + d + d(d+1)/2 features (66 at
// d = 10, against the 111 of the reference's Φ = [1, x, vec(xxᵀ)]). W′ is
// packed here, in f32 and in svax_torch/ops/estep.py: pack_coeffs' order of
// operations, its row (i, j), i > j, the sum of pack_coeffs' rows (i, j)
// and (j, i) (estep.py: fold_coeffs mirrors it). The scatter statistic is
// formed on the lower triangle and mirrored as it is written: exactly
// symmetric, where the plain version's ½(S + Sᵀ) is so up to rounding.
//
// Products. Both run on the tensor cores, f32-accurate, on the last-layer
// engine (lastlayer.cuh: split<3>, ldsm/ldsm_t, warp_mma): every operand is
// split exactly into three bf16 parts, a product adds the six terms of
// order < 3, and each 16-deep step's terms go into a zeroed tile that is
// added to the sum in f32. Against the plain f32 version this meets the
// bars of 5e-5 on the statistics (max error over max |value|) and 1e-3
// absolute on the evidence (chip_smoke.py phase 7, the card tests;
// tests/test_torch_estep.py holds an emulation of these products to the
// same bars against the JAX reference on the CPU).
//
// Bound. At the design shape (N = 65,536, K = 128, d = 10) the two
// products are 2·2·N·F′·K ≈ 2.2 GFLOP: 13 µs as three TF32 passes at 495
// TFLOP/s (56 µs of f32 FMAs at 67 TFLOP/s over the unfolded F = 111),
// against 2.6 MB of x; operations bound it. At the pinwheel shape (N = 400,
// K = 10, d = 2) it is launch latency: one launch a call.
//
// Design. A block of 16 warps (128 registers a thread) walks a contiguous
// run of 64-point sub-tiles (the tiles dealt to at most the card's
// capacity, SMs × blocks an SM: one block an SM at K > 64, d = 10, with
// 156 KB of shared memory). It reads the expected parameters once into
// shared memory (16 loads in flight a thread: the load latency set the
// setup's time) and packs W′'s parts there. Per sub-tile it builds Φ′'s parts
// ([point][feature]); product 1 leaves the logits in the mma fragments
// (warp w: points 16·(w % 4).., component pairs w / 4 + H1·q, H1 = min(KQ,
// 4) warps on a point); the softmax takes each point's max and sum over the
// quad's lanes, then over those warps through shared memory, in one fixed
// order; R = e · (1 / Σe) goes to shared memory in its three parts (a
// division a point: e is often denormal, where a division takes its slow
// path); product 2 adds Φ′ᵀR into the block's (F′, K) sum, held in
// registers across the run (warp w: component pair w % KQ, feature tiles
// w / KQ + (16 / KQ)·i). One block writes the outputs itself. Otherwise
// each block writes one partial and the last block to finish (an integer
// ticket) adds the partials in block order and writes the outputs — or,
// where the partials pass kTicketFloats (one block would take long to add
// them), a reduce launch does, in four ordered runs of blocks. No float
// atomics: reruns are bit-equal.
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "lastlayer.cuh"

namespace {

using lastlayer::bf16;
using lastlayer::kPad;

constexpr int kThreads = 512, kWarps = 16;
constexpr int TN = 64;                   // points a sub-tile: four m16 tiles
constexpr int kMaxD = 10, kMaxK = 128;
constexpr int kXs = kMaxD + 2;           // a point's row in xs: x, then 1 and 0
constexpr int kTicketFloats = 1 << 15;   // partial floats the last block adds itself
constexpr double kLog2Pi = 1.8378770664093453;

// Blocks of the running launch that are done; the last one's atomicInc
// wraps it back to 0.
__device__ unsigned int g_ticket = 0;

__host__ __device__ constexpr int feats(int d) { return 1 + d + d * (d + 1) / 2; }

// The largest d whose folded features fit FM feature tiles.
__host__ __device__ constexpr int max_d(int fm) {
  int d = kMaxD;
  while (feats(d) > 16 * fm) --d;
  return d;
}

// Triangle feature q → (i, j), j ≤ i, in row order: q = i(i+1)/2 + j.
__host__ __device__ inline void untri(int q, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= q) ++i;
  j = q - i * (i + 1) / 2;
}

struct Args {
  const float* x;
  const float *log_pi, *logdet, *quad, *prec_mean, *prec;
  float *counts, *mean, *scatter, *evidence, *partial;
  int n, d, k, tiles;
  int ticket;  // several blocks: the last adds the partials (else a reduce launch)
  float scale;
};

// Shared memory of the tile kernel for KQ component pairs (K ≤ 16·KQ) and
// FM feature tiles (F′ ≤ 16·FM); bf16 rows kPad apart mod 128 bytes.
template <int KQ, int FM>
struct Smem {
  static constexpr int KP = 16 * KQ, FP = 16 * FM;
  static constexpr int LDW = KP + kPad, LDP = FP + kPad;
  static constexpr int W = 3 * FP * LDW, P = 3 * TN * LDP, R = 3 * TN * LDW;  // bf16
  static constexpr int H1 = KQ < kWarps / 4 ? KQ : kWarps / 4;  // product 1: warps on a row
  static constexpr int XS = TN * kXs, RED = 2 * H1 * TN;                       // float
  static constexpr int bytes = 2 * (W + P + R) + 4 * (XS + RED + FP);
  // The expected parameters are staged over Φ′ and R before the first sub-tile.
  static_assert(2 * (P + R) >= 4 * (3 * KP + (KP + 1) * max_d(FM) * (1 + max_d(FM))),
                "the staged fields fit");
};

// Σ_b p[b·fk] over b < blocks in block order, 16 loads in flight (L2: the
// partials of this launch or the last one).
__device__ __forceinline__ float sum_partials(const float* p, size_t fk, int blocks) {
  constexpr int kBatch = 16;
  float s = 0.0f;
  for (int b0 = 0; b0 < blocks; b0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = b0 + j < blocks ? __ldcg(p + (b0 + j) * fk) : 0.0f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (b0 + j < blocks) s += v[j];
  }
  return s;
}

// Statistic (feature f, component c), summed over the points, to the
// outputs: scaled, the triangle mirrored.
__device__ __forceinline__ void put_stat(const Args& a, int f, int c, float s) {
  const float v = a.scale * s;
  const int d = a.d;
  if (f == 0) {
    a.counts[c] = v;
  } else if (f <= d) {
    a.mean[c * d + f - 1] = v;
  } else {
    int i, j;
    untri(f - 1 - d, i, j);
    float* sc = a.scatter + static_cast<size_t>(c) * d * d;
    sc[i * d + j] = v;
    sc[j * d + i] = v;
  }
}

// W′[f][c] in pack_coeffs' f32 order from the expected parameters staged
// in shared memory (raw: log π, log|Λ|, E[μᵀΛμ] (K each), then E[Λμ] (d
// rows) and E[Λ] (d² rows, (i, j) at i·d + j), each row K + 1 apart,
// component-minor); a triangle feature f is x_i·x_j (its ftab entry).
__device__ __forceinline__ float coeff(const float* raw, int d, int k, int f, int c, int i,
                                       int j, float half_d_log2pi) {
  if (f == 0)
    return __fsub_rn(__fsub_rn(__fadd_rn(raw[c], __fmul_rn(0.5f, raw[k + c])),
                               __fmul_rn(0.5f, raw[2 * k + c])),
                     half_d_log2pi);
  const float* rows = raw + 3 * k + c;
  if (f <= d) return rows[(f - 1) * (k + 1)];
  rows += d * (k + 1);
  const float v = __fmul_rn(-0.5f, rows[(i * d + j) * (k + 1)]);
  return i == j ? v : __fadd_rn(v, __fmul_rn(-0.5f, rows[(j * d + i) * (k + 1)]));
}

template <int KQ, int FM>
__global__ void __launch_bounds__(kThreads, 1) estep_tiles(const Args a) {
  using S = Smem<KQ, FM>;
  constexpr int KP = S::KP, FP = S::FP, LDW = S::LDW, LDP = S::LDP;
  constexpr int H1 = S::H1, NQ1 = KQ / H1;   // product 1: warps on a point row, pairs a warp
  constexpr int WPQ = kWarps / KQ;           // product 2: warps on a component pair
  constexpr int MI2 = (FM + WPQ - 1) / WPQ;  // product 2: feature tiles a warp
  constexpr int XR = (TN * kMaxD + kThreads - 1) / kThreads;  // x values a thread stages
  PHASE_START;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int d = a.d, k = a.k, F = feats(d);

  extern __shared__ float4 smem4[];
  bf16* ws = reinterpret_cast<bf16*>(smem4);         // W′ parts [feature][component]
  bf16* ps = ws + S::W;                              // Φ′ parts [point][feature]
  bf16* rs = ps + S::P;                              // R parts [point][component]
  float* xs = reinterpret_cast<float*>(rs + S::R);   // [point][kXs]: x, 1, 0
  float* red = xs + S::XS;                           // row max [H1][TN], then sums [H1][TN]
  int* ftab = reinterpret_cast<int*>(red + S::RED);  // Φ′[p][f] = xs[p][a]·xs[p][b]: a | b << 8
  __shared__ bool last;

  // This block's run of sub-tiles; x is staged a sub-tile ahead in registers.
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * a.tiles / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * a.tiles / gridDim.x);
  const int tile_vals = TN * d;
  const long long nd = static_cast<long long>(a.n) * d;
  float xr[XR];
  auto fetch = [&](int t) {
    const long long base = static_cast<long long>(t) * tile_vals;
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      const int e = tid + r * kThreads;
      xr[r] = e < tile_vals && base + e < nd ? a.x[base + e] : 0.0f;
    }
  };
  fetch(t0);

  for (int f = tid; f < FP; f += kThreads) {
    int ia = d + 1, ib = d + 1;  // zero past F′
    if (f == 0) {
      ia = ib = d;
    } else if (f <= d) {
      ia = f - 1;
      ib = d;
    } else if (f < F) {
      untri(f - 1 - d, ia, ib);
    }
    ftab[f] = ia | ib << 8;
  }
  for (int p = tid; p < TN; p += kThreads) {
    xs[p * kXs + d] = 1.0f;
    xs[p * kXs + d + 1] = 0.0f;
  }
  // The expected parameters, read once in order into shared memory (over
  // Φ′ and R, unused until the first sub-tile), E[Λμ] and E[Λ] transposed
  // to component-minor rows K + 1 apart (no bank conflicts either way).
  float* raw = reinterpret_cast<float*>(ps);
  const int kd = k * d, dd = d * d, n_raw = k * (3 + d + dd);
  constexpr int kLoads = 16;  // loads in flight a thread: two rounds at K = 128, d = 10
  for (int e0 = tid; e0 < n_raw; e0 += kLoads * kThreads) {
    float v[kLoads];
    int dst[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int e = e0 + j * kThreads;
      const float* src = a.log_pi;
      dst[j] = e;
      if (e >= n_raw) {
        dst[j] = -1;
      } else if (e < 3 * k) {
        src = e < k ? a.log_pi + e : e < 2 * k ? a.logdet + e - k : a.quad + e - 2 * k;
      } else if (e < 3 * k + kd) {
        const int m = e - 3 * k;  // E[Λμ][c][i]: m = c·d + i
        src = a.prec_mean + m;
        dst[j] = 3 * k + (m % d) * (k + 1) + m / d;
      } else {
        const int m = e - 3 * k - kd;  // E[Λ][c][i][j]: m = c·d² + i·d + j
        src = a.prec + m;
        dst[j] = 3 * k + (d + m % dd) * (k + 1) + m / dd;
      }
      v[j] = *src;
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (dst[j] >= 0) raw[dst[j]] = v[j];
  }
  __syncthreads();  // ftab and the fields are in
  PHASE_MARK(16);
  // W′'s parts, a feature's components on neighbouring threads.
  const float half_d_log2pi = static_cast<float>(0.5 * d * kLog2Pi);
  for (int e = tid; e < FP * KP; e += kThreads) {
    const int f = e / KP, c = e % KP, t = ftab[f];
    bf16 pt[3];
    lastlayer::split<3>(
        f < F && c < k ? coeff(raw, d, k, f, c, t & 255, t >> 8, half_d_log2pi) : 0.0f, pt);
#pragma unroll
    for (int q = 0; q < 3; ++q) ws[q * FP * LDW + f * LDW + c] = pt[q];
  }
  PHASE_MARK(17);

  const int mt = warp % 4, h1 = warp / 4, c1 = 16 * h1;  // product 1's rows and columns
  const bool on1 = h1 < H1;                              // small K: the other warps sit out
  const int q2 = warp % KQ, h2 = warp / KQ;              // product 2's pair and tiles
  const int mi2 = h2 < FM ? (FM - h2 + WPQ - 1) / WPQ : 0;
  float acc[MI2][1][2][4];
  lastlayer::zero(acc);

  for (int t = t0; t < t1; ++t) {
    const int base = t * TN;
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      const int e = tid + r * kThreads;
      if (e < tile_vals) xs[(e / d) * kXs + e % d] = xr[r];
    }
    if (t + 1 < t1) fetch(t + 1);
    __syncthreads();  // xs is in; the last sub-tile's product 2 is done with Φ′ and R
    PHASE_MARK(18);

    // Φ′'s three parts, two features a thread.
    for (int e = tid; e < TN * FP / 2; e += kThreads) {
      const int p = e / (FP / 2), f = 2 * (e % (FP / 2));
      const float* xp = xs + p * kXs;
      const int ta = ftab[f], tb = ftab[f + 1];
      bf16 p0[3], p1[3];
      lastlayer::split<3>(xp[ta & 255] * xp[ta >> 8], p0);
      lastlayer::split<3>(xp[tb & 255] * xp[tb >> 8], p1);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        __nv_bfloat162 pair;
        pair.x = p0[q];
        pair.y = p1[q];
        *reinterpret_cast<__nv_bfloat162*>(ps + q * TN * LDP + p * LDP + f) = pair;
      }
    }
    __syncthreads();
    PHASE_MARK(19);

    // Product 1: the logits of points 16·mt.. in the fragments; then each
    // row's max over this warp's columns (masked past K).
    float lg[1][NQ1][2][4];
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.0f, 0.0f};
    if (on1) {
      lastlayer::zero(lg);
      lastlayer::warp_mma<1, NQ1, 3, 3, false, true, false>(lg, ps, LDP, TN * LDP, 16 * mt, 16,
                                                            1, ws, LDW, FP * LDW, c1, 16 * H1,
                                                            NQ1, FM, lane);
#pragma unroll
      for (int q = 0; q < NQ1; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c1 + 16 * H1 * q + 8 * hh + 2 * tq + (e & 1) < k)
              mx[e >> 1] = fmaxf(mx[e >> 1], lg[0][q][hh][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        if (tq == 0) red[h1 * TN + 16 * mt + g + 8 * r] = mx[r];
      }
    }
    __syncthreads();
    PHASE_MARK(20);
    // e = exp(logit − max) in place (the special-function unit's, within a
    // few 1e-7 of expf at logit − max ≤ 0), and its sums: the lane's in
    // order, the quad's, then (below) the row's warps' in order.
    if (on1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * mt + g + 8 * r;
        mx[r] = red[row];
#pragma unroll
        for (int h = 1; h < H1; ++h) mx[r] = fmaxf(mx[r], red[h * TN + row]);
      }
#pragma unroll
      for (int q = 0; q < NQ1; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = c1 + 16 * H1 * q + 8 * hh + 2 * tq + (e & 1) < k;
            const float v = ok ? __expf(lg[0][q][hh][e] - mx[e >> 1]) : 0.0f;
            lg[0][q][hh][e] = v;
            sm[e >> 1] += v;
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sm[r] = lastlayer::quad_sum(sm[r]);
        if (tq == 0) red[(H1 + h1) * TN + 16 * mt + g + 8 * r] = sm[r];
      }
    }
    __syncthreads();
    PHASE_MARK(21);
    // R = e · (1 / Σe) (0 past N) into its parts; the evidence m + log Σe.
    if (on1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * mt + g + 8 * r;
        float tot = red[H1 * TN + row];
#pragma unroll
        for (int h = 1; h < H1; ++h) tot += red[(H1 + h) * TN + row];
        const bool valid = base + row < a.n;
        if (valid && h1 == 0 && tq == 0) a.evidence[base + row] = mx[r] + logf(tot);
        // Σe ≥ 1 (the max's own term): one division a row, then products,
        // which take e's denormals at full rate.
        const float inv = valid ? 1.0f / tot : 0.0f;
#pragma unroll
        for (int q = 0; q < NQ1; ++q)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            bf16 p0[3], p1[3];
            lastlayer::split<3>(lg[0][q][hh][2 * r] * inv, p0);
            lastlayer::split<3>(lg[0][q][hh][2 * r + 1] * inv, p1);
            const int col = c1 + 16 * H1 * q + 8 * hh + 2 * tq;
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              __nv_bfloat162 pair;
              pair.x = p0[p];
              pair.y = p1[p];
              *reinterpret_cast<__nv_bfloat162*>(rs + p * TN * LDW + row * LDW + col) = pair;
            }
          }
      }
    }
    __syncthreads();
    PHASE_MARK(22);

    // Product 2: Φ′ᵀR into the block's sum, 16 points a step.
    if (mi2 > 0)
      lastlayer::warp_mma<MI2, 1, 3, 3, true, true, false>(acc, ps, LDP, TN * LDP, 16 * h2,
                                                           16 * WPQ, mi2, rs, LDW, TN * LDW,
                                                           16 * q2, 0, 1, TN / 16, lane);
    PHASE_MARK(23);
  }

  // The block's (F′, K) sum: the outputs (one block) or its partial.
  const bool alone = gridDim.x == 1;
  const int fk = F * k;
#pragma unroll
  for (int i = 0; i < MI2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 16 * (h2 + WPQ * i) + g + 8 * (e >> 1);
        const int c = 16 * q2 + 8 * hh + 2 * tq + (e & 1);
        if (i < mi2 && f < F && c < k) {
          if (alone)
            put_stat(a, f, c, acc[i][0][hh][e]);
          else
            a.partial[static_cast<size_t>(blockIdx.x) * fk + f * k + c] = acc[i][0][hh][e];
        }
      }
  if (alone || !a.ticket) return;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) last = atomicInc(&g_ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < fk; e += kThreads)
    put_stat(a, e / k, e % k, sum_partials(a.partial + e, fk, gridDim.x));
}

// The partials' sum where they are too many for one block: each statistic
// by kSegs threads, each adding a contiguous run of blocks in order, then
// the runs in order (reruns bit-equal); 64 statistics a block.
constexpr int kSegs = 4;

__global__ void __launch_bounds__(64 * kSegs) estep_reduce(const Args a, int blocks) {
  __shared__ float runs[kSegs][64];
  const size_t fk = static_cast<size_t>(feats(a.d)) * a.k;
  const int o = threadIdx.x % 64, sg = threadIdx.x / 64;
  const size_t e = static_cast<size_t>(blockIdx.x) * 64 + o;
  const int per = (blocks + kSegs - 1) / kSegs, b0 = sg * per;
  const int b1 = b0 + per < blocks ? b0 + per : blocks;
  runs[sg][o] = e < fk && b0 < b1 ? sum_partials(a.partial + b0 * fk + e, fk, b1 - b0) : 0.0f;
  __syncthreads();
  if (sg != 0 || e >= fk) return;
  float s = runs[0][o];
#pragma unroll
  for (int r = 1; r < kSegs; ++r) s += runs[r][o];
  put_stat(a, static_cast<int>(e / a.k), static_cast<int>(e % a.k), s);
}

// One instantiation's entry: with a null `a`, the card's capacity for it
// (SMs × blocks an SM) into *cap; else the launch of `blocks` blocks (and
// the reduce, where the ticket does not take the partials). Opts in to the
// kernel's shared memory once; its size is fixed per instantiation.
template <int KQ, int FM>
cudaError_t entry(const Args* a, int blocks, cudaStream_t st, int* cap) {
  constexpr int bytes = Smem<KQ, FM>::bytes;
  static bool opted = false;
  static int per_sm = 0;
  cudaError_t err;
  if (!opted) {
    err = cudaFuncSetAttribute(estep_tiles<KQ, FM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  if (a == nullptr) {
    if (per_sm == 0) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, estep_tiles<KQ, FM>, kThreads,
                                                          bytes);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
    }
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    *cap = per_sm * sms;
    return cudaSuccess;
  }
  Args args = *a;
  const long long fk = static_cast<long long>(feats(args.d)) * args.k;
  args.ticket = blocks * fk <= kTicketFloats;
  estep_tiles<KQ, FM><<<blocks, kThreads, bytes, st>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1 || args.ticket) return err;
  estep_reduce<<<static_cast<int>((fk + 63) / 64), 64 * kSegs, 0, st>>>(args, blocks);
  return cudaGetLastError();
}

using Entry = cudaError_t (*)(const Args*, int, cudaStream_t, int*);

#define SVAX_ESTEP_ROW(KQ) \
  { entry<KQ, 1>, entry<KQ, 2>, entry<KQ, 3>, entry<KQ, 4>, entry<KQ, 5> }
constexpr Entry kEntries[4][5] = {SVAX_ESTEP_ROW(1), SVAX_ESTEP_ROW(2), SVAX_ESTEP_ROW(4),
                                  SVAX_ESTEP_ROW(8)};
#undef SVAX_ESTEP_ROW

bool shape_ok(int d, int k) { return d >= 1 && d <= kMaxD && k >= 1 && k <= kMaxK; }

// The instantiation for d and K: component pairs 1, 2, 4 or 8; feature tiles 1–5.
Entry pick(int d, int k) {
  const int pairs = (k + 15) / 16;
  const int kq = pairs <= 1 ? 0 : pairs <= 2 ? 1 : pairs <= 4 ? 2 : 3;
  return kEntries[kq][(feats(d) + 15) / 16 - 1];
}

}  // namespace

extern "C" {

// Blocks of the tile kernel for d and K that fit on the card at once (SMs ×
// blocks an SM); the caller's plan deals the ⌈N / 64⌉ sub-tiles to at most
// that many. Negative: a CUDA error code, negated.
int estep_capacity(int d, int k) {
  if (!shape_ok(d, k)) return -static_cast<int>(cudaErrorInvalidValue);
  int cap = 0;
  const cudaError_t err = pick(d, k)(nullptr, 0, nullptr, &cap);
  return err == cudaSuccess ? cap : -static_cast<int>(err);
}

// x (N, d) and the expected parameters (log_pi, logdet, quad (K), prec_mean
// (K, d), prec (K, d, d)) → counts (K), mean (K, d), scatter (K, d, d), all
// times `scale`, and evidence (N), over `blocks` blocks (1 ≤ blocks ≤ ⌈N /
// 64⌉); partial: blocks · F′ · K floats where blocks > 1 (else unread).
int estep_stats(const float* x, int n, int d, int k, const float* log_pi, const float* logdet,
                const float* quad, const float* prec_mean, const float* prec, float scale,
                int blocks, float* counts, float* mean, float* scatter, float* evidence,
                float* partial, void* stream) {
  const int tiles = n >= 1 ? (n + TN - 1) / TN : 0;
  if (n < 1 || !shape_ok(d, k) || blocks < 1 || blocks > tiles ||
      (blocks > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,    log_pi, logdet,   quad, prec_mean, prec, counts, mean, scatter,
               evidence, partial, n, d, k, tiles, 0, scale};
  return static_cast<int>(pick(d, k)(&a, blocks, static_cast<cudaStream_t>(stream), nullptr));
}

}  // extern "C"

// Phase clocks (slots 16–23; compiled in only with -DSVAX_PHASE_CLOCKS):
// the fields staged, W′ packed, x in, Φ′, product 1 and the max, the sums,
// R, product 2.
SVAX_PHASE_ENTRY(estep_phase_clocks)
