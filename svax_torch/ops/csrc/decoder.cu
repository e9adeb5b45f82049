// decoder: the x-free Bernoulli row sum, forward and recompute backward.
//
// Replaces the TPU kernels of svax/ops/decoder_pallas.py: _rowsum_fwd_call
// (pallas_call at :64) and _rowsum_bwd_call (:114), entries
// rowsum_logsig_neg (:193) and fused_bernoulli_loglik (:211). Over flat
// rows H (M, Dh), the decoder's last layer W (Dh, D) and bias b (D):
//   s_m = Σ_D logσ(−o_m),   o = H W + b,
// and its VJP from s̄ (M): do = −σ(o)·s̄, H̄ = do Wᵀ, W̄ = Hᵀ do, b̄ = Σ_m do.
// The (M, D) logits o never reach device memory; the cotangent do does only
// in the f32 mode's backward (in bf16 parts, between its two kernels).
//
// Two modes: the f32 mode (the reference's HIGHEST); the BF16 mode rounds
// H and W, and in the backward do, to bf16 (round-to-nearest-even) before
// each product and sums in f32, which is what a Mosaic dot at DEFAULT does.
// A product of two bf16 values is exact in f32, so the two sides differ
// only in the order of summation. b and b̄ stay f32 in both modes.
//
// Bound: at bigk (M = S·N·K = 102,400 rows, Dh = 200, D = 784) each of the
// products is 2·M·Dh·D = 32.1 GFLOP. An f32-accurate product on the tensor
// cores costs three TF32 passes (495 TFLOP/s) or six bf16 ones (989), so
// the forward is bound at 0.195 ms and the backward's three products at
// 0.584 ms (against 0.48 and 1.44 ms at the 67 TFLOP/s f32 FMA rate); the
// bf16 mode at 32 µs and 97 µs, or by the 2·M·D special functions; the
// bytes (H in, H̄ out, 82 MB each) take under 0.05 ms. Both directions are
// bound by operations.
//
// * rowsum_fwd (not redesigned): scalar f32 FMAs, 256 threads as 16 × 16,
//   a thread owning a 4 × 4 micro-tile of a 64 × 64 output tile, operands
//   staged in shared memory in 32-deep chunks; one block per 64 rows walks
//   D in 64-column chunks, adds logσ(−o) into per-row sums in registers,
//   then adds the 16 per-thread partials of a row in a fixed order.
// * The backward runs on the tensor-core engine of lastlayer_bwd.cuh, with
//   every operand in P bf16 parts: P = 3 in the f32 mode (an exact split,
//   and the six terms of order < 3 of each product: f32-accurate), P = 1 in
//   the bf16 mode.
//   (0) rowsum_split: H and W into their bf16 parts, zero-padded to
//       multiples of 16 (Dh → kp, D → np), so that every operand is staged
//       by cp.async.
//   (a) rowsum_hbar: one block per 64 rows (32 where Dh is wide): the H
//       tile staged once, W in column slabs; per slab o,
//       do and H̄ += do·Wᵀ on the tensor cores (engine block (a)); writes
//       H̄, and in the f32 mode do's three parts.
//   (b) rowsum_wbar: a grid of D chunks × row splits; each block walks its
//       row tiles: W̄ chunk += Hᵀ do in registers, b̄ from the f32 do in row
//       order (engine block (b)); one partial W̄ chunk and b̄ chunk a block.
//       The f32 mode loads do's parts (their sum is the f32 do exactly);
//       the bf16 mode stages its W chunk once and forms o and do again,
//       and forms again from a sequential f32 FMA chain over k any do
//       within 2048/65536 of a bf16 rounding tie (lastlayer_bwd.cuh:
//       kTieRepair), as the plain version's cuBLAS o rounds it: the one
//       scalar product left in the backward, kept because without it W̄
//       misses its 5e-5 bar at M = 1,000 (PERF.md).
//   (c) rowsum_reduce: adds the partials in split order.
//   No float atomics: reruns are bit-equal. The reference keeps W̄ and b̄ in
//   its output block across a sequential grid (decoder_pallas.py:102-112);
//   here blocks run in parallel, so W̄ goes through ordered partials.
// The ragged edges of M, Dh and D are masked (zero operands, and masked
// columns left out of the sums). The reference pads D with a −40 bias
// instead (decoder_pallas.py:145-147), which adds logσ(40) ≈ −4e-18 per
// padded column; masking adds nothing. Dh is at most kMaxDh.
//
// Plain C interface (loaded with ctypes by svax_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "lastlayer_bwd.cuh"
#include "phase_clock.cuh"

namespace {

namespace ll = lastlayer;
using ll::bf16;

constexpr int kThreads = 256;   // rowsum_fwd: 16 × 16
constexpr int kTM = 64;         // rows per tile
constexpr int kTN = 64;         // D columns per chunk
constexpr int kKC = 32;         // depth of one staged chunk of the o product
constexpr int kMaxDh = 512;
constexpr int kLdHs = kTM + 1;  // Hs[k][m], stored along k
constexpr int kStage = kTN * (kTN + 1);  // ≥ kKC·kLdHs + kKC·kTN floats
constexpr int kWaveBlocks = 264;  // rowsum_wbar's grid: about two blocks per SM
constexpr int kSmemMax = 232448;

static_assert(kKC * kLdHs + kKC * kTN <= kStage, "stage holds the o-product chunks");

struct Args {
  const float* h;  // (M, Dh)
  const float* w;  // (Dh, D)
  const float* b;  // (D)
  const float* sbar;  // (M), the backward's cotangent
  int m, dh, d;
};

template <typename T>
__host__ __device__ constexpr T round_up(T v, T q) { return (v + q - 1) / q * q; }

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

// ------------------------------------------------------------ backward

// (0) P bf16 parts of src (rows × cols, f32 row-major) into out, each part
// (prow × pcol, zero-padded) `prow·pcol` apart.
template <int P>
__global__ void rowsum_split(const float* src, int rows, int cols, int prow, int pcol, bf16* out) {
  const long long n = static_cast<long long>(prow) * pcol;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(e / pcol), c = static_cast<int>(e % pcol);
    const float v = r < rows && c < cols ? src[static_cast<size_t>(r) * cols + c] : 0.0f;
    bf16 p[P];
    ll::split<P>(v, p);
#pragma unroll
    for (int j = 0; j < P; ++j) out[j * n + e] = p[j];
  }
}

struct BwdArgs {
  const bf16* hp;  // P parts of H, each (M, kp)
  const bf16* wp;  // P parts of W, each (kp, np)
  const float* b;  // (D)
  const float* sbar;  // (M)
  int m, dh, d, kp, np;
  float* hbar;  // (M, Dh)
  bf16* dg;     // kLoadDo: P parts of do, each (M, np); else null
};

template <class Cfg, int P>
__host__ __device__ constexpr size_t hbar_smem(int kp) {
  return sizeof(bf16) * (static_cast<size_t>(P) * Cfg::TM * (kp + ll::kPad) + Cfg::ws_elems(kp, P) +
                         Cfg::ds_elems(P)) +
         sizeof(float) * Cfg::TM;
}

// (a) H̄ for one tile of Cfg::TM rows (and, with a.dg, do's parts).
template <class Cfg, int P>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MINB) rowsum_hbar(BwdArgs a) {
  constexpr int TM = Cfg::TM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = a.kp, ldh = kp + ll::kPad;
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);  // P × [TM][ldh]
  bf16* ws = hs + P * TM * ldh;                  // Cfg::ws_elems
  bf16* ds = ws + Cfg::ws_elems(kp, P);          // Cfg::ds_elems
  float* srow = reinterpret_cast<float*>(ds + Cfg::ds_elems(P));  // [TM]
  PHASE_START;
  const int m0 = blockIdx.x * TM;
  const size_t hps = static_cast<size_t>(a.m) * kp;
  for (int p = 0; p < P; ++p)
    ll::stage(hs + p * TM * ldh, ldh, a.hp + p * hps + static_cast<size_t>(m0) * kp, kp, TM, kp,
              a.m - m0, kp);
  ll::cp_async_commit();
  for (int r = threadIdx.x; r < TM; r += blockDim.x) srow[r] = m0 + r < a.m ? a.sbar[m0 + r] : 0.0f;
  float acc[1][Cfg::NQ][2][4];
  bf16* dg = a.dg != nullptr ? a.dg + static_cast<size_t>(m0) * a.np : nullptr;
  ll::hbar_slabs<Cfg, P, P, P, false, P == 1, false>(
      acc, hs, TM * ldh, ws, ds, a.wp, static_cast<size_t>(kp) * a.np, kp, a.d, a.b, srow, dg,
      static_cast<size_t>(a.m) * a.np, a.m - m0);
  PHASE_MARK(0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hm = (warp % Cfg::WM) * 16, hq0 = warp / Cfg::WM;
#pragma unroll
  for (int q = 0; q < Cfg::NQ; ++q) {
    const int n0 = (hq0 + Cfg::WN * q) * 16;
    if (n0 >= kp) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + ll::frag_row(hm, lane, e), col = ll::frag_col(n0, h, lane, e);
        if (row < a.m && col < a.dh) a.hbar[static_cast<size_t>(row) * a.dh + col] = acc[0][q][h][e];
      }
  }
  PHASE_MARK(1);
}

// (b) one split's partial W̄ chunk and b̄ chunk: do formed from o, or (kLoadDo)
// loaded in its parts from (a)'s copy.
template <class Cfg, int P, bool kLoadDo>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MINB) rowsum_wbar(ll::WbarArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PHASE_START;
  ll::wbar_tiles<Cfg, P, P, P, !kLoadDo, false, false, P == 1 && !kLoadDo>(a, smem_raw);
  PHASE_MARK(2);
}

// (c) out[i·cols + j] = Σ_q part[q·stride + i·ld + j], q in split order.
__global__ void rowsum_reduce(const float* part, int parts, size_t stride, int rows, int cols,
                              int ld, float* out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(rows) * cols) return;
  const int i = static_cast<int>(e / cols), j = static_cast<int>(e % cols);
  float v = 0.0f;
  for (int q = 0; q < parts; ++q) v += part[q * stride + static_cast<size_t>(i) * ld + j];
  out[e] = v;
}

bool shape_ok(int m, int dh, int d) {
  return m >= 1 && dh >= 1 && dh <= kMaxDh && d >= 1 &&
         static_cast<long long>(m) * round_up(dh, 16) < (1LL << 31) &&
         static_cast<long long>(round_up(dh, 16)) * round_up(d, 64) < (1LL << 31);
}

// The W̄ grid: D chunks × row splits (about kWaveBlocks blocks, each split
// at least one row tile).
template <class Cfg>
int wbar_splits(int m, int d) {
  const int tiles = (m + Cfg::TMB - 1) / Cfg::TMB, chunks = (d + Cfg::SNB - 1) / Cfg::SNB;
  const int p = kWaveBlocks / chunks;
  return p < 1 ? 1 : (p > tiles ? tiles : p);
}

// The engine's configurations, by mode (P parts: 1 the bf16 mode, 3 the f32
// mode): narrow (K ≤ 224: every config's decoder width) and wide (K ≤ 512,
// one block an SM). Two blocks share an SM where each takes ≤ 113 KB of
// shared memory and 128 registers a thread. Each (b) chunk reads all of H's
// parts, so wider chunks read it fewer times.
// * bf16: (a) 64 rows, 64-column W slabs double-buffered, two blocks an SM;
//   (b) 64-row tiles of 64-column chunks in 16 warps, one block an SM, do
//   formed from o.
// * f32: (a) 64 rows, 64-column slabs, one block an SM (each warp's o job
//   two m16 tiles, so each W fragment serves two), writing do's three parts
//   (6 bytes an entry: 482 MB at bigk, which cost less on the card than
//   forming o again in (b) in six-term products); (b) 32-row tiles of
//   64-column chunks that load them, double-buffered, two blocks an SM.
template <int P>
struct Narrow;
template <>
struct Narrow<1> {
  using A = ll::CfgA<64, 64, 2, 224, 8, 2>;
  using B = ll::CfgB<64, 64, 1, 224, 16, 1>;
  static constexpr bool kLoadDo = false;
};
template <>
struct Narrow<3> {
  using A = ll::CfgA<64, 64, 1, 224, 8, 1>;
  using B = ll::CfgB<32, 64, 2, 224, 8, 2>;
  static constexpr bool kLoadDo = true;
};
template <int P>
struct Wide {
  using A = ll::CfgAWide;
  using B = ll::CfgBWide;
  static constexpr bool kLoadDo = Narrow<P>::kLoadDo;
};

template <class C, int P>
size_t wbar_bytes(int kp) {
  return ll::wbar_smem<typename C::B, P, P, P, !C::kLoadDo, P == 1 && !C::kLoadDo>(kp);
}

// Whether a backward at this width and mode takes the narrow configurations:
// they take the width and their shared memory fits.
template <int P>
bool narrow_fits_p(int kp) {
  using N = Narrow<P>;
  return kp <= N::A::KPMAX && hbar_smem<typename N::A, P>(kp) <= static_cast<size_t>(kSmemMax) &&
         wbar_bytes<N, P>(kp) <= static_cast<size_t>(kSmemMax);
}

bool narrow_fits(int dh, bool bf16) {
  const int kp = round_up(dh, 16);
  return bf16 ? narrow_fits_p<1>(kp) : narrow_fits_p<3>(kp);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, int& opted) {
  if (static_cast<int>(bytes) <= opted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) opted = static_cast<int>(bytes);
  return err;
}

// Scratch layout of the backward: H's and W's bf16 parts (and do's, where
// (b) loads them), then the W̄ and b̄ partials (floats).
struct Scratch {
  long long h_parts, w_parts, do_parts, pw, pb;  // bf16 elements (parts), floats (partials)
  int splits;
};

template <class C, int P>
Scratch scratch_of(int m, int dh, int d) {
  const long long kp = round_up(dh, 16), np = round_up(d, 16);
  const int splits = wbar_splits<typename C::B>(m, d);
  return Scratch{P * m * kp, P * kp * np, C::kLoadDo ? P * m * np : 0, splits * kp * np,
                 splits * np, splits};
}

Scratch scratch_for(int m, int dh, int d, bool bf16) {
  const bool narrow = narrow_fits(dh, bf16);
  if (bf16) return narrow ? scratch_of<Narrow<1>, 1>(m, dh, d) : scratch_of<Wide<1>, 1>(m, dh, d);
  return narrow ? scratch_of<Narrow<3>, 3>(m, dh, d) : scratch_of<Wide<3>, 3>(m, dh, d);
}

// Floats before the partials: the bf16 parts, rounded up to 16 bytes.
long long parts_floats(const Scratch& s) {
  return round_up<long long>((s.h_parts + s.w_parts + s.do_parts + 1) / 2, 4);
}

long long scratch_floats(const Scratch& s) { return parts_floats(s) + s.pw + s.pb; }

template <class C, int P>
cudaError_t backward(const Args& a, float* hbar, float* wbar, float* bbar, float* scratch,
                     cudaStream_t st) {
  using CfgA = typename C::A;
  using CfgB = typename C::B;
  const int kp = round_up(a.dh, 16), np = round_up(a.d, 16);
  const Scratch sc = scratch_of<C, P>(a.m, a.dh, a.d);
  bf16* hp = reinterpret_cast<bf16*>(scratch);
  bf16* wp = hp + sc.h_parts;
  bf16* dg = C::kLoadDo ? wp + sc.w_parts : nullptr;  // 16-byte aligned: kp, np multiples of 16
  float* pw = scratch + parts_floats(sc);
  float* pb = pw + sc.pw;
  rowsum_split<P><<<1024, 256, 0, st>>>(a.h, a.m, a.dh, a.m, kp, hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rowsum_split<P><<<256, 256, 0, st>>>(a.w, a.dh, a.d, kp, np, wp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static int opted_h = 0, opted_w = 0;
  const size_t hbytes = hbar_smem<CfgA, P>(kp);
  const size_t wbytes = wbar_bytes<C, P>(kp);
  err = opt_in(rowsum_hbar<CfgA, P>, hbytes, opted_h);
  if (err != cudaSuccess) return err;
  err = opt_in(rowsum_wbar<CfgB, P, C::kLoadDo>, wbytes, opted_w);
  if (err != cudaSuccess) return err;
  const BwdArgs ba{hp, wp, a.b, a.sbar, a.m, a.dh, a.d, kp, np, hbar, dg};
  rowsum_hbar<CfgA, P><<<(a.m + CfgA::TM - 1) / CfgA::TM, CfgA::THREADS, hbytes, st>>>(ba);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ll::WbarArgs wa{};
  wa.h = hp;
  wa.hps = static_cast<size_t>(a.m) * kp;
  wa.w = wp;
  wa.wps = static_cast<size_t>(kp) * np;
  wa.bias = a.b;
  wa.srow = a.sbar;
  wa.g = dg;
  wa.gps = static_cast<size_t>(a.m) * np;
  wa.m = a.m;
  wa.kp = kp;
  wa.d = a.d;
  wa.splits = sc.splits;
  wa.pw = pw;
  wa.pb = pb;
  const dim3 grid((np + CfgB::SNB - 1) / CfgB::SNB, sc.splits);
  rowsum_wbar<CfgB, P, C::kLoadDo><<<grid, CfgB::THREADS, wbytes, st>>>(wa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long lw = static_cast<long long>(a.dh) * a.d;
  rowsum_reduce<<<static_cast<unsigned>((lw + 255) / 256), 256, 0, st>>>(
      pw, sc.splits, static_cast<size_t>(kp) * np, a.dh, a.d, np, wbar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rowsum_reduce<<<static_cast<unsigned>((a.d + 255) / 256), 256, 0, st>>>(pb, sc.splits, np, 1, a.d,
                                                                          np, bbar);
  return cudaGetLastError();
}

}  // namespace

SVAX_PHASE_ENTRY(rowsum_phase_clocks)

extern "C" {

// Floats of the backward's scratch: H's and W's bf16 parts and the W̄, b̄
// partials of its row splits.
long long rowsum_scratch_floats(int m, int dh, int d, int bf16) {
  if (!shape_ok(m, dh, d)) return 0;
  return scratch_floats(scratch_for(m, dh, d, bf16 != 0));
}

// Forward: s (M) from H (M, Dh), W (Dh, D), b (D); bf16 != 0 is the BF16 mode.
int rowsum_forward(const float* h, const float* w, const float* b, int m, int dh, int d,
                   int bf16, float* s, void* stream) {
  if (!shape_ok(m, dh, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{h, w, b, nullptr, m, dh, d};
  const unsigned blocks = static_cast<unsigned>((m + kTM - 1) / kTM);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    rowsum_fwd<true><<<blocks, kThreads, 0, st>>>(a, s);
  } else {
    rowsum_fwd<false><<<blocks, kThreads, 0, st>>>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: H̄ (M, Dh), W̄ (Dh, D), b̄ (D) from s̄ (M); `scratch` holds
// rowsum_scratch_floats(m, dh, d, bf16) floats.
int rowsum_backward(const float* h, const float* w, const float* b, const float* sbar, int m,
                    int dh, int d, int bf16, float* hbar, float* wbar, float* bbar,
                    float* scratch, void* stream) {
  if (!shape_ok(m, dh, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{h, w, b, sbar, m, dh, d};
  auto st = static_cast<cudaStream_t>(stream);
  const bool narrow = narrow_fits(dh, bf16 != 0);
  cudaError_t err;
  if (bf16) {
    err = narrow ? backward<Narrow<1>, 1>(a, hbar, wbar, bbar, scratch, st)
                 : backward<Wide<1>, 1>(a, hbar, wbar, bbar, scratch, st);
  } else {
    err = narrow ? backward<Narrow<3>, 3>(a, hbar, wbar, bbar, scratch, st)
                 : backward<Wide<3>, 3>(a, hbar, wbar, bbar, scratch, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
