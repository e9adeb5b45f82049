// decoder: the x-free Bernoulli row sum, forward and recompute backward.
//
// Replaces the TPU kernels of svax/ops/decoder_pallas.py: _rowsum_fwd_call
// (pallas_call at :64) and _rowsum_bwd_call (:114), entries
// rowsum_logsig_neg (:193) and fused_bernoulli_loglik (:211). Over flat
// rows H (M, Dh), the decoder's last layer W (Dh, D) and bias b (D):
//   s_m = Σ_D logσ(−o_m),   o = H W + b,
// and its VJP from s̄ (M): do = −σ(o)·s̄, H̄ = do Wᵀ, W̄ = Hᵀ do, b̄ = Σ_m do.
// The (M, D) logits o and the cotangent do never reach device memory: every
// kernel forms its 64 × 64 tile of o in registers and consumes it there.
//
// Two modes, one body (template <bool BF16>): the f32 mode is plain f32 FMA
// (the reference's HIGHEST); the BF16 mode rounds H and W, and in the
// backward do, to bf16 (__float2bfloat16_rn, round-to-nearest-even) before
// each product and sums in f32, which is what a Mosaic dot at DEFAULT does.
// A product of two bf16 values is exact in f32, so the two sides differ
// only in the order of summation. b and b̄ stay f32 in both modes.
//
// Bound: at bigk (M = S·N·K = 102,400 rows, Dh = 200, D = 784) the forward
// is 2·M·Dh·D = 32.1 GFLOP (0.48 ms at the 67 TFLOP/s f32 peak; 32 µs at
// the 989 TFLOP/s bf16 tensor-core peak, where the 2·M·D special functions
// bound the mode instead) and the backward three such products; the bytes
// (H in, H̄ out, 82 MB each) take under 0.05 ms. Both directions are bound
// by operations.
//
// Design: simple and deterministic first (wgmma, TMA and 3×TF32 for the f32
// mode are later work). 256 threads as 16 × 16; a thread owns a 4 × 4
// micro-tile at rows ty + 16i and columns tx + 16j of a 64 × 64 output
// tile; operands are staged in shared memory in 32-deep chunks and
// multiplied with scalar FMAs.
// * rowsum_fwd: one block per 64 rows; walks D in 64-column chunks, adds
//   logσ(−o) into per-row sums in registers, then adds the 16 per-thread
//   partials of a row in a fixed order. Writes s (M) only.
// * The backward: the reference keeps W̄ and b̄ in its output block across a
//   sequential grid (decoder_pallas.py:102-112). Here blocks run in
//   parallel and in no order, and W̄ (627 KB at bigk) does not fit a
//   block's shared memory, so the backward is three kernels:
//   (a) rowsum_hbar: one block per 64 rows; per D chunk it recomputes o,
//       forms do in shared memory and adds do·Wᵀ into the block's H̄ tile
//       (64 × Dh, shared memory); writes H̄.
//   (b) rowsum_wbar: a grid of D chunks × P row splits; each block
//       recomputes o and do for its rows and columns, and writes a partial
//       W̄ chunk = Hᵀ do (Dh × 64, accumulated in shared memory) and a
//       partial b̄ chunk (column sums of the f32 do, in row order).
//   (c) rowsum_reduce: adds the P partials in split order.
//   No float atomics: reruns are bit-equal.
// The ragged edges of M, Dh and D are masked (zero operands, and masked
// columns left out of the sums). The reference pads D with a −40 bias
// instead (decoder_pallas.py:145-147), which adds logσ(40) ≈ −4e-18 per
// padded column; masking adds nothing. Dh is at most kMaxDh (the H̄ and W̄
// accumulators live in shared memory).
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;   // 16 × 16
constexpr int kTM = 64;         // rows per tile
constexpr int kTN = 64;         // D columns per chunk
constexpr int kKC = 32;         // depth of one staged chunk of the o product
constexpr int kKB = 64;         // Dh columns per chunk of the H̄ and W̄ products
constexpr int kMaxDh = 512;
constexpr int kWaveBlocks = 264;  // rowsum_wbar's grid: about two blocks per SM
// Leading dimensions of the shared tiles, chosen against bank conflicts: a
// warp's threads span 16 tx by 2 ty.
constexpr int kLdHs = kTM + 1;  // Hs[k][m], stored along k
constexpr int kLdDsT = kTN + 2;  // do transposed, ds[n][m], stored by (tx, ty)
constexpr int kLdWk = kKB + 1;  // W chunk transposed, wk[n][k], stored along n
constexpr int kLdRow = kTN + 16;  // [ty-row][tx-col] tiles: ds, wb
constexpr int kStage = kTN * kLdWk;  // ≥ kKC·kLdHs + kKC·kTN and kTM·kKB floats
constexpr int kSmemMax = 232448;

static_assert(kKC * kLdHs + kKC * kTN <= kStage, "stage holds the o-product chunks");
static_assert(kTM * kKB <= kStage, "stage holds an H chunk");

struct Args {
  const float* h;  // (M, Dh)
  const float* w;  // (Dh, D)
  const float* b;  // (D)
  const float* sbar;  // (M), the backward's cotangent
  int m, dh, d;
  int splits;  // rowsum_wbar's P
};

__host__ __device__ constexpr int round_up(int v, int q) { return (v + q - 1) / q * q; }

// H̄ tile row stride: ≡ 16 (mod 32) floats.
__host__ __device__ constexpr int hb_ld(int dh) { return round_up(dh, 32) + 16; }

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// logσ(−o) = −(max(o, 0) + log1p(exp(−|o|))), stable for any o.
__device__ __forceinline__ float logsig_neg(float o) {
  return -(fmaxf(o, 0.0f) + log1pf(expf(-fabsf(o))));
}

__device__ __forceinline__ float sigmoid(float o) { return 1.0f / (1.0f + expf(-o)); }

// acc[i][j] = Σ_k rnd(H[m0 + ty + 16i][k]) · rnd(W[k][n0 + tx + 16j]) over
// k in order (zero outside M, Dh, D); `stage` holds kStage floats and is
// free again on return.
template <bool BF16>
__device__ void tile_logits(const Args& a, int m0, int n0, float* stage, float (&acc)[4][4]) {
  float* hs = stage;              // [kKC][kLdHs]
  float* ws = stage + kKC * kLdHs;  // [kKC][kTN]
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < a.dh; k0 += kKC) {
#pragma unroll
    for (int e = 0; e < kTM * kKC / kThreads; ++e) {
      const int idx = t + kThreads * e, row = idx / kKC, kk = idx % kKC;
      const int r = m0 + row, k = k0 + kk;
      const float v = (r < a.m && k < a.dh) ? a.h[static_cast<size_t>(r) * a.dh + k] : 0.0f;
      hs[kk * kLdHs + row] = rnd<BF16>(v);
    }
#pragma unroll
    for (int e = 0; e < kKC * kTN / kThreads; ++e) {
      const int idx = t + kThreads * e, kk = idx / kTN, nn = idx % kTN;
      const int k = k0 + kk, n = n0 + nn;
      const float v = (k < a.dh && n < a.d) ? a.w[static_cast<size_t>(k) * a.d + n] : 0.0f;
      ws[kk * kTN + nn] = rnd<BF16>(v);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float hv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = hs[kk * kLdHs + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk * kTN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) rowsum_fwd(Args a, float* s) {
  __shared__ float stage[kStage];
  __shared__ float red[kTM][17];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.x * kTM;
  float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n0 = 0; n0 < a.d; n0 += kTN) {
    float acc[4][4];
    tile_logits<BF16>(a, m0, n0, stage, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < a.d) {
        const float bn = a.b[n];
#pragma unroll
        for (int i = 0; i < 4; ++i) rs[i] += logsig_neg(acc[i][j] + bn);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[ty + 16 * i][tx] = rs[i];
  __syncthreads();
  if (t < kTM && m0 + t < a.m) {
    float v = 0.0f;
    for (int q = 0; q < 16; ++q) v += red[t][q];
    s[m0 + t] = v;
  }
}

// (a) H̄ for one tile of 64 rows.
template <bool BF16>
__global__ void __launch_bounds__(kThreads) rowsum_hbar(Args a, float* hbar) {
  extern __shared__ float smem[];
  const int ldh = hb_ld(a.dh);
  float* hb = smem;                 // [kTM][ldh]: this block's H̄ rows
  float* ds = hb + kTM * ldh;       // [kTN][kLdDsT]: rnd(do) transposed
  float* stage = ds + kTN * kLdDsT;  // tile_logits' chunks, then wk[kTN][kLdWk]
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.x * kTM;
  for (int e = t; e < kTM * ldh; e += kThreads) hb[e] = 0.0f;
  float g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    g[i] = r < a.m ? a.sbar[r] : 0.0f;
  }
  for (int n0 = 0; n0 < a.d; n0 += kTN) {
    float acc[4][4];
    tile_logits<BF16>(a, m0, n0, stage, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      const float bn = n < a.d ? a.b[n] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = n < a.d ? -sigmoid(acc[i][j] + bn) * g[i] : 0.0f;
        ds[(tx + 16 * j) * kLdDsT + ty + 16 * i] = rnd<BF16>(v);
      }
    }
    for (int kc0 = 0; kc0 < a.dh; kc0 += kKB) {
      __syncthreads();  // ds is written; the stage is free
      for (int e = 0; e < kTN * kKB / kThreads; ++e) {
        const int idx = t + kThreads * e, kk = idx / kTN, nn = idx % kTN;
        const int k = kc0 + kk, n = n0 + nn;
        const float v = (k < a.dh && n < a.d) ? a.w[static_cast<size_t>(k) * a.d + n] : 0.0f;
        stage[nn * kLdWk + kk] = rnd<BF16>(v);
      }
      __syncthreads();
      float c[4][4] = {};
#pragma unroll 8
      for (int n = 0; n < kTN; ++n) {
        float dv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = ds[n * kLdDsT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = stage[n * kLdWk + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = fmaf(dv[i], wv[j], c[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kc0 + tx + 16 * j;
        if (k < a.dh) {
#pragma unroll
          for (int i = 0; i < 4; ++i) hb[(ty + 16 * i) * ldh + k] += c[i][j];
        }
      }
    }
    __syncthreads();  // before the next chunk overwrites ds and the stage
  }
  for (int e = t; e < kTM * a.dh; e += kThreads) {
    const int row = e / a.dh, k = e % a.dh;
    if (m0 + row < a.m) hbar[static_cast<size_t>(m0 + row) * a.dh + k] = hb[row * ldh + k];
  }
}

// (b) one split's partial W̄ (Dh × 64) and b̄ (64) for one D chunk.
template <bool BF16>
__global__ void __launch_bounds__(kThreads) rowsum_wbar(Args a, float* pw, float* pb) {
  extern __shared__ float smem[];
  float* wb = smem;                  // [Dh][kLdRow]: this block's W̄ chunk
  float* ds = wb + a.dh * kLdRow;     // [kTM][kLdRow]: do, then rnd(do)
  float* stage = ds + kTM * kLdRow;   // tile_logits' chunks, then hk[kTM][kKB]
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int n0 = blockIdx.x * kTN, p = blockIdx.y;
  const int tiles = (a.m + kTM - 1) / kTM;
  const int t0 = static_cast<int>(static_cast<long long>(p) * tiles / a.splits);
  const int t1 = static_cast<int>(static_cast<long long>(p + 1) * tiles / a.splits);
  for (int e = t; e < a.dh * kLdRow; e += kThreads) wb[e] = 0.0f;
  float bacc = 0.0f;  // thread t < 64: b̄ of column n0 + t
  for (int tile = t0; tile < t1; ++tile) {
    const int m0 = tile * kTM;
    float acc[4][4];
    tile_logits<BF16>(a, m0, n0, stage, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty + 16 * i;
      const float g = r < a.m ? a.sbar[r] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        ds[(ty + 16 * i) * kLdRow + tx + 16 * j] =
            n < a.d ? -sigmoid(acc[i][j] + a.b[n]) * g : 0.0f;
      }
    }
    __syncthreads();
    if (t < kTN) {
      for (int r = 0; r < kTM; ++r) bacc += ds[r * kLdRow + t];
    }
    if constexpr (BF16) {
      __syncthreads();  // b̄ has read the f32 do
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& v = ds[(ty + 16 * i) * kLdRow + tx + 16 * j];
          v = rnd<BF16>(v);
        }
    }
    for (int kc0 = 0; kc0 < a.dh; kc0 += kKB) {
      __syncthreads();  // ds is final; the stage is free
      for (int e = 0; e < kTM * kKB / kThreads; ++e) {
        const int idx = t + kThreads * e, mm = idx / kKB, kk = idx % kKB;
        const int r = m0 + mm, k = kc0 + kk;
        const float v = (r < a.m && k < a.dh) ? a.h[static_cast<size_t>(r) * a.dh + k] : 0.0f;
        stage[mm * kKB + kk] = rnd<BF16>(v);
      }
      __syncthreads();
      float c[4][4] = {};
#pragma unroll 8
      for (int r = 0; r < kTM; ++r) {
        float hv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = stage[r * kKB + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = ds[r * kLdRow + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = fmaf(hv[i], dv[j], c[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kc0 + ty + 16 * i;
        if (k < a.dh) {
#pragma unroll
          for (int j = 0; j < 4; ++j) wb[k * kLdRow + tx + 16 * j] += c[i][j];
        }
      }
    }
    __syncthreads();  // before the next tile overwrites ds and the stage
  }
  float* pw_p = pw + static_cast<size_t>(p) * a.dh * a.d;
  for (int e = t; e < a.dh * kTN; e += kThreads) {
    const int k = e / kTN, c = e % kTN;
    if (n0 + c < a.d) pw_p[static_cast<size_t>(k) * a.d + n0 + c] = wb[k * kLdRow + c];
  }
  if (t < kTN && n0 + t < a.d) pb[static_cast<size_t>(p) * a.d + n0 + t] = bacc;
}

// (c) out[e] = Σ_q part[q·len + e], q in split order.
__global__ void rowsum_reduce(const float* part, int parts, long long len, float* out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float v = 0.0f;
  for (int q = 0; q < parts; ++q) v += part[static_cast<size_t>(q) * len + e];
  out[e] = v;
}

bool shape_ok(int m, int dh, int d) {
  return m >= 1 && dh >= 1 && dh <= kMaxDh && d >= 1 &&
         static_cast<long long>(m) * dh < (1LL << 31) &&
         static_cast<long long>(dh) * d < (1LL << 31);
}

int wbar_splits(int m, int d) {
  const int tiles = (m + kTM - 1) / kTM, chunks = (d + kTN - 1) / kTN;
  const int p = kWaveBlocks / chunks;
  return p < 1 ? 1 : (p > tiles ? tiles : p);
}

size_t hbar_smem(int dh) {
  return sizeof(float) * (static_cast<size_t>(kTM) * hb_ld(dh) + kTN * kLdDsT + kStage);
}

size_t wbar_smem(int dh) {
  return sizeof(float) * (static_cast<size_t>(dh) * kLdRow + kTM * kLdRow + kStage);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, int& opted) {
  if (static_cast<int>(bytes) <= opted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) opted = static_cast<int>(bytes);
  return err;
}

template <bool BF16>
cudaError_t backward(const Args& a, float* hbar, float* pw, float* pb, cudaStream_t st) {
  static int opted_h = 0, opted_w = 0;
  const size_t hbytes = hbar_smem(a.dh), wbytes = wbar_smem(a.dh);
  cudaError_t err = opt_in(rowsum_hbar<BF16>, hbytes, opted_h);
  if (err != cudaSuccess) return err;
  err = opt_in(rowsum_wbar<BF16>, wbytes, opted_w);
  if (err != cudaSuccess) return err;
  rowsum_hbar<BF16><<<(a.m + kTM - 1) / kTM, kThreads, hbytes, st>>>(a, hbar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.d + kTN - 1) / kTN, a.splits);
  rowsum_wbar<BF16><<<grid, kThreads, wbytes, st>>>(a, pw, pb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the backward's partial buffer: P splits of W̄ (Dh × D) and b̄ (D).
long long rowsum_partial_floats(int m, int dh, int d) {
  return static_cast<long long>(wbar_splits(m, d)) * (static_cast<long long>(dh) * d + d);
}

// Forward: s (M) from H (M, Dh), W (Dh, D), b (D); bf16 != 0 is the BF16 mode.
int rowsum_forward(const float* h, const float* w, const float* b, int m, int dh, int d,
                   int bf16, float* s, void* stream) {
  if (!shape_ok(m, dh, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{h, w, b, nullptr, m, dh, d, 0};
  const unsigned blocks = static_cast<unsigned>((m + kTM - 1) / kTM);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    rowsum_fwd<true><<<blocks, kThreads, 0, st>>>(a, s);
  } else {
    rowsum_fwd<false><<<blocks, kThreads, 0, st>>>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: H̄ (M, Dh), W̄ (Dh, D), b̄ (D) from s̄ (M); `partial` holds
// rowsum_partial_floats(m, dh, d) floats.
int rowsum_backward(const float* h, const float* w, const float* b, const float* sbar, int m,
                    int dh, int d, int bf16, float* hbar, float* wbar, float* bbar,
                    float* partial, void* stream) {
  if (!shape_ok(m, dh, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (hbar_smem(dh) > static_cast<size_t>(kSmemMax) || wbar_smem(dh) > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{h, w, b, sbar, m, dh, d, wbar_splits(m, d)};
  float* pw = partial;
  float* pb = partial + static_cast<size_t>(a.splits) * dh * d;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? backward<true>(a, hbar, pw, pb, st) : backward<false>(a, hbar, pw, pb, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long lw = static_cast<long long>(dh) * d;
  rowsum_reduce<<<static_cast<unsigned>((lw + 255) / 256), 256, 0, st>>>(pw, a.splits, lw, wbar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rowsum_reduce<<<static_cast<unsigned>((d + 255) / 256), 256, 0, st>>>(pb, a.splits, d, bbar);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
