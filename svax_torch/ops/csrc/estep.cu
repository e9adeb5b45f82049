// estep: the fused GMM E-step and its sufficient statistics, general d.
//
// Replaces the TPU kernel svax/ops/estep_pallas.py (_fused_kernel_call →
// pallas_call, entry e_step_stats_fused). With Φ(x) = [1, x, vec(xxᵀ)]
// (F = 1 + d + d² features) and the packed coefficients W (F, K) of
// svax_torch/ops/estep.py: pack_coeffs, it computes log ρ = Φ·W, the
// softmax R over K and the per-point evidence lse_k log ρ, and the
// statistics S = ΦᵀR (F, K) — without Φ or R ever leaving the block.
//
// Bound: at the design shape (N = 65,536, K = 128, d = 10) each of the two
// products is 2·N·F·K ≈ 1.9 GFLOP (3.7 GFLOP in all) against 2.6 MB of x,
// so arithmetic bounds it;
// at the pinwheel shape (N = 400, K = 10, d = 2) it is launch latency.
// Design: blocks own contiguous runs of 64-point sub-tiles (at most 128
// blocks, so one wave on the 132 SMs). For each sub-tile a block builds
// Φᵀ in shared memory, forms the logits with a register-tiled product
// (4 points × 4 components per thread, W read as float4), takes the
// softmax one warp per point, and adds ΦᵀR into its own (F, K) sum in
// shared memory (4 features × 4 components per thread). Both products are
// FMA loops in the kernel's body. Nothing carries over between blocks on
// this card, so each block writes its (F, K) partial sum and a second
// kernel adds the partials in block order. Every sum has one fixed order
// and there are no float atomics: two runs are bit-equal. At F = 111,
// K = 128 a block uses 175,292 bytes of shared memory (opted into with
// cudaFuncSetAttribute). wgmma for the two products is later work.
// Symmetrising the scatter statistic and applying the N/M scale stay in
// the wrapper, as in the TPU entry.
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int TN = 64;            // points per sub-tile
constexpr int TNP = TN + 1;       // Φᵀ row stride (odd: fewer bank conflicts)
constexpr int MAX_BLOCKS = 128;
constexpr int MAX_D = 10;         // F ≤ 111
constexpr int MAX_K = 128;
constexpr int RT = 4;             // register tile: 4 rows × 4 components

__host__ __device__ constexpr int pad4(int v) { return (v + 3) / 4 * 4; }

struct Geometry {
  int tiles, per_block, blocks;
};

// Sub-tiles and their split over blocks; a function of N alone, so the
// order of every sum is fixed for a given N.
__host__ __device__ inline Geometry geometry(int n) {
  Geometry g;
  g.tiles = (n + TN - 1) / TN;
  const int b = g.tiles < MAX_BLOCKS ? g.tiles : MAX_BLOCKS;
  g.per_block = (g.tiles + b - 1) / b;
  g.blocks = (g.tiles + g.per_block - 1) / g.per_block;
  return g;
}

__host__ __device__ inline size_t smem_floats(int f, int k) {
  return 2 * static_cast<size_t>(f) * pad4(k) + static_cast<size_t>(TN) * pad4(k) +
         static_cast<size_t>(f) * TNP;
}

// out[i·ldo + c] (+)= Σ_{j<J} A[i·sai + j·saj] · B[j·ldb + c] for i < I,
// c < C. Each thread owns 4×4 tiles of out and sums over j in order. B's
// rows are 16-byte aligned with ldb ≥ pad4(C); A's row index is clamped,
// so rows past I read valid memory and are dropped.
__device__ inline void tile_product(const float* A, int sai, int saj, const float* B,
                                    int ldb, int I, int J, int C, float* out, int ldo,
                                    bool accumulate) {
  const int ci = (I + RT - 1) / RT, cc = (C + RT - 1) / RT;
  for (int tile = threadIdx.x; tile < ci * cc; tile += NT) {
    const int i0 = (tile / cc) * RT, c0 = (tile % cc) * RT;
    int ia[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) ia[r] = (i0 + r < I ? i0 + r : I - 1) * sai;
    float acc[RT][RT] = {};
    for (int j = 0; j < J; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(B + j * ldb + c0);
      const float bv[RT] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float av = A[ia[r] + j * saj];
#pragma unroll
        for (int q = 0; q < RT; ++q) acc[r][q] = fmaf(av, bv[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        if (i0 + r < I && c0 + q < C) {
          float* o = out + (i0 + r) * ldo + c0 + q;
          *o = accumulate ? *o + acc[r][q] : acc[r][q];
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(NT) estep_tiles(const float* x, int n, int d, int k,
                                                  const float* w, float* partial,
                                                  float* evidence) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int F = 1 + d + d * d, KP = pad4(k);
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // (F, KP) W, zero-padded
  float* sc = sw + F * KP;                      // (F, KP) this block's Σ ΦᵀR
  float* sr = sc + F * KP;                      // (TN, KP) logits, then R
  float* sphi = sr + TN * KP;                   // (F, TNP) Φᵀ of the sub-tile

  for (int e = tid; e < F * KP; e += NT) {
    const int f = e / KP, c = e % KP;
    sw[e] = c < k ? w[f * k + c] : 0.0f;
    sc[e] = 0.0f;
  }

  const Geometry g = geometry(n);
  const int t0 = blockIdx.x * g.per_block;
  const int t1 = t0 + g.per_block < g.tiles ? t0 + g.per_block : g.tiles;
  for (int t = t0; t < t1; ++t) {
    const int base = t * TN;
    __syncthreads();  // W loaded / the previous sub-tile's sums are done
    for (int e = tid; e < F * TN; e += NT) {
      const int f = e / TN, p = e % TN, pt = base + p;
      float v = 0.0f;
      if (pt < n) {
        const float* xp = x + static_cast<size_t>(pt) * d;
        if (f == 0) {
          v = 1.0f;
        } else if (f <= d) {
          v = xp[f - 1];
        } else {
          const int q = f - 1 - d;
          v = xp[q / d] * xp[q % d];
        }
      }
      sphi[f * TNP + p] = v;
    }
    __syncthreads();

    // logits (TN, KP) = Φ (TN, F) · W (F, KP)
    tile_product(sphi, 1, TNP, sw, KP, TN, F, KP, sr, KP, false);
    __syncthreads();

    // softmax over the K components, one warp per point
    for (int p = warp; p < TN; p += NT / 32) {
      float* row = sr + p * KP;
      float m = -INFINITY;
      for (int c = lane; c < k; c += 32) m = fmaxf(m, row[c]);
      m = warp_max(m);
      float s = 0.0f;
      for (int c = lane; c < k; c += 32) s += expf(row[c] - m);
      s = warp_sum(s);
      const float lse = m + logf(s);
      const bool valid = base + p < n;
      for (int c = lane; c < KP; c += 32)
        row[c] = valid && c < k ? expf(row[c] - lse) : 0.0f;
      if (valid && lane == 0) evidence[base + p] = lse;
    }
    __syncthreads();

    // Σ ΦᵀR (F, K) += Φᵀ (F, TN) · R (TN, KP)
    tile_product(sphi, TNP, 1, sr, KP, F, TN, k, sc, KP, true);
  }
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.x) * F * k;
  for (int e = tid; e < F * k; e += NT) out[e] = sc[(e / k) * KP + e % k];
}

__global__ void estep_reduce(const float* partial, int blocks, int fk, float* stats) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= fk) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * fk + e];
  stats[e] = s;
}

}  // namespace

extern "C" {

// Blocks of the first kernel for N points: the partial buffer holds
// blocks·F·K floats.
int estep_blocks(int n) { return geometry(n).blocks; }

// x (N, d), w (F, K) → stats (F, K) = Σ_n Φ(x_n)ᵀ r_n and evidence (N,).
int estep_stats(const float* x, int n, int d, int k, const float* w, float* partial,
                float* stats, float* evidence, void* stream) {
  if (n < 1 || d < 1 || d > MAX_D || k < 1 || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int f = 1 + d + d * d;
  const size_t bytes = smem_floats(f, k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      estep_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(n);
  estep_tiles<<<g.blocks, NT, bytes, st>>>(x, n, d, k, w, partial, evidence);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fk = f * k;
  estep_reduce<<<(fk + 255) / 256, 256, 0, st>>>(partial, g.blocks, fk, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
