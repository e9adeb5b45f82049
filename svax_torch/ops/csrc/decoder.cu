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
// Both directions run on the tensor-core engine of lastlayer.cuh, with
// every operand in P bf16 parts: P = 3 in the f32 mode (an exact split,
// and the six terms of order < 3 of each product: f32-accurate), P = 1 in
// the bf16 mode.
// * Forward: rowsum_split puts W's P parts (zero-padded to multiples of 16)
//   into scratch, once a call (157 k values at bigk); rowsum_fwd (one block
//   per 64 rows, 32 where Dh is wide) issues its first W slab, then reads
//   its H tile as f32 and splits it into its P parts while staging it in
//   shared memory (H is read once, 82 MB at bigk; splitting H ahead of the
//   kernel would write 128 MB of f32-mode parts and read them again, ~0.06
//   ms of traffic beside a 0.195 ms bound), then engine block (f) walks D in
//   64-column W slabs by cp.async, forms o on the tensor cores and adds
//   logσ(−(o + b)) into per-row Kahan sums, then adds each row's partials
//   in f64 in a fixed order. f32 mode: the 83 KB three-part H tile leaves
//   room for one slab stage (175 KB, one block of 16 warps an SM, each warp
//   one m16 × n16 tile a slab: on an H100 this beat 32-column slabs
//   double-buffered in 8 warps, and 8 warps of two tiles each);
//   bf16 mode: two stages, 88 KB, two blocks of 8 warps an SM, each warp
//   two m16 tiles, with the special-function units' logσ. Every block reads
//   all of W's parts from L2: 0.98 MB (f32) or 0.33 MB (bf16) a block, 1.57
//   GB or 0.52 GB a call at bigk (1,600 blocks).
// * Backward:
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
//       within 2048/65536 of a bf16 rounding tie (lastlayer.cuh:
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

#include "lastlayer.cuh"
#include "phase_clock.cuh"

namespace {

namespace ll = lastlayer;
using ll::bf16;

constexpr int kMaxDh = 512;
constexpr int kWaveBlocks = 264;  // rowsum_wbar's grid: about two blocks per SM
constexpr int kSmemMax = 232448;

struct Args {
  const float* h;  // (M, Dh)
  const float* w;  // (Dh, D)
  const float* b;  // (D)
  const float* sbar;  // (M), the backward's cotangent
  int m, dh, d;
};

template <typename T>
__host__ __device__ constexpr T round_up(T v, T q) { return (v + q - 1) / q * q; }

// ------------------------------------------------------------ operands

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

// ------------------------------------------------------------- forward

struct FwdArgs {
  const float* h;  // (M, Dh)
  const bf16* wp;  // P parts of W, each (kp, np)
  const float* b;  // (D)
  int m, dh, d, kp, np;
  float* s;  // (M)
};

template <class Cfg, int P>
__host__ __device__ constexpr size_t fwd_smem(int kp) {
  return sizeof(bf16) * (static_cast<size_t>(P) * Cfg::TM * (kp + ll::kPad) + Cfg::ws_elems(kp, P)) +
         sizeof(double) * Cfg::RED;
}

// s for one tile of Cfg::TM rows: the H tile split into its P parts while
// staged (the first W slab already in flight), then engine block (f) — the
// f32 mode with the exact logσ, the bf16 mode with the special-function
// units' (its bar allows it).
template <class Cfg, int P>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MINB) rowsum_fwd(FwdArgs a) {
  constexpr int TM = Cfg::TM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = a.kp, ldh = kp + ll::kPad;
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);                        // P × [TM][ldh]
  bf16* ws = hs + P * TM * ldh;                                        // Cfg::ws_elems
  double* red = reinterpret_cast<double*>(ws + Cfg::ws_elems(kp, P));  // Cfg::RED
  PHASE_START;
  const int m0 = blockIdx.x * TM;
  const size_t wps = static_cast<size_t>(kp) * a.np;
  ll::stage_slab<Cfg::SN, Cfg::ST, P>(ws, a.wp, wps, kp, a.np, 0);
  ll::stage_split<P>(hs, ldh, TM * ldh, a.h + static_cast<size_t>(m0) * a.dh, a.dh, TM, kp,
                     a.m - m0, a.dh);
  PHASE_MARK(16);
  float rs[Cfg::FMI][2], rc[Cfg::FMI][2];
  if constexpr (P == 3) {
    ll::rowsum_slabs<Cfg, P, P, false>(rs, rc, hs, TM * ldh, ws, a.wp, wps, kp, a.d, a.b,
                                       [](float o) { return ll::logsig_neg(o); });
  } else {
    ll::rowsum_slabs<Cfg, P, P, false>(rs, rc, hs, TM * ldh, ws, a.wp, wps, kp, a.d, a.b,
                                       [](float o) { return ll::logsig_neg_fast(o); });
  }
  ll::row_totals<Cfg>(rs, rc, red);
  for (int r = threadIdx.x; r < TM && m0 + r < a.m; r += blockDim.x)
    a.s[m0 + r] = ll::row_total<Cfg>(red, r);
  PHASE_MARK(17);
}

// ------------------------------------------------------------ backward

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
  using F = ll::CfgF<64, 64, 2, 224, 8, 2, 2>;
  using A = ll::CfgA<64, 64, 2, 224, 8, 2>;
  using B = ll::CfgB<64, 64, 1, 224, 16, 1>;
  static constexpr bool kLoadDo = false;
};
template <>
struct Narrow<3> {
  using F = ll::CfgF<64, 64, 1, 224, 16, 1, 1>;
  using A = ll::CfgA<64, 64, 1, 224, 8, 1>;
  using B = ll::CfgB<32, 64, 2, 224, 8, 2>;
  static constexpr bool kLoadDo = true;
};
template <int P>
struct Wide {
  using F = ll::CfgF<32, 16, 1, 512, 2, 1, 1>;
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

// The same for a forward.
template <int P>
bool fwd_narrow_fits_p(int kp) {
  using F = typename Narrow<P>::F;
  return kp <= F::KPMAX && fwd_smem<F, P>(kp) <= static_cast<size_t>(kSmemMax);
}

bool fwd_narrow_fits(int dh, bool bf16) {
  const int kp = round_up(dh, 16);
  return bf16 ? fwd_narrow_fits_p<1>(kp) : fwd_narrow_fits_p<3>(kp);
}

size_t fwd_bytes(int dh, bool bf16) {
  const int kp = round_up(dh, 16);
  const bool narrow = fwd_narrow_fits(dh, bf16);
  if (bf16) return narrow ? fwd_smem<Narrow<1>::F, 1>(kp) : fwd_smem<Wide<1>::F, 1>(kp);
  return narrow ? fwd_smem<Narrow<3>::F, 3>(kp) : fwd_smem<Wide<3>::F, 3>(kp);
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

// W's P parts into `scratch`, then rowsum_fwd over the row tiles.
template <class Cfg, int P>
cudaError_t forward(const Args& a, float* s, float* scratch, cudaStream_t st) {
  const int kp = round_up(a.dh, 16), np = round_up(a.d, 16);
  bf16* wp = reinterpret_cast<bf16*>(scratch);
  rowsum_split<P><<<256, 256, 0, st>>>(a.w, a.dh, a.d, kp, np, wp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static int opted = 0;
  const size_t bytes = fwd_smem<Cfg, P>(kp);
  err = opt_in(rowsum_fwd<Cfg, P>, bytes, opted);
  if (err != cudaSuccess) return err;
  const FwdArgs fa{a.h, wp, a.b, a.m, a.dh, a.d, kp, np, s};
  rowsum_fwd<Cfg, P><<<(a.m + Cfg::TM - 1) / Cfg::TM, Cfg::THREADS, bytes, st>>>(fa);
  return cudaGetLastError();
}

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

// Floats of the forward's scratch: W's bf16 parts.
long long rowsum_forward_scratch_floats(int dh, int d, int bf16) {
  if (!shape_ok(1, dh, d)) return 0;
  const long long parts = static_cast<long long>(bf16 ? 1 : 3) * round_up(dh, 16) * round_up(d, 16);
  return (parts + 1) / 2;
}

// Dynamic shared memory of the forward's rowsum_fwd block at this width.
long long rowsum_forward_smem_bytes(int dh, int bf16) {
  if (!shape_ok(1, dh, 1)) return 0;
  return static_cast<long long>(fwd_bytes(dh, bf16 != 0));
}

// Forward: s (M) from H (M, Dh), W (Dh, D), b (D); bf16 != 0 is the BF16 mode;
// `scratch` holds rowsum_forward_scratch_floats(dh, d, bf16) floats.
int rowsum_forward(const float* h, const float* w, const float* b, int m, int dh, int d,
                   int bf16, float* s, float* scratch, void* stream) {
  if (!shape_ok(m, dh, d)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{h, w, b, nullptr, m, dh, d};
  auto st = static_cast<cudaStream_t>(stream);
  const bool narrow = fwd_narrow_fits(dh, bf16 != 0);
  cudaError_t err;
  if (bf16) {
    err = narrow ? forward<Narrow<1>::F, 1>(a, s, scratch, st) : forward<Wide<1>::F, 1>(a, s, scratch, st);
  } else {
    err = narrow ? forward<Narrow<3>::F, 3>(a, s, scratch, st) : forward<Wide<3>::F, 3>(a, s, scratch, st);
  }
  return static_cast<int>(err);
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
