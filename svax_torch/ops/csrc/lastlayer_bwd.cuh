// lastlayer_bwd: the tensor-core engine shared by the decoders' last-layer
// backward (decoder.cu's row sum, decoder_mlp.cu's MLP decoder).
//
// Both backwards take rows H (M, K), a last layer W (K, D), a bias b (D) and
// a per-row scale s (M) and form, without writing the (M, D) logits,
//   o = H W + b,  do = −s·σ(o),  H̄ = do Wᵀ,  W̄ = Hᵀ do,  b̄ = Σ_m do.
// They differ only in where operands are rounded, so every product here is
// templated on the number of bf16 parts of each operand: 1 (rounded to bf16,
// round-to-nearest-even as torch's casts), 2 (hi + lo: 16 bits, within
// 2⁻¹⁶ of the f32 value) or 3 (hi + mid + lo: an f32 value's 24 bits, the
// split exact). A product of a P-part and a Q-part operand adds the cross
// terms of order i + j < max(P, Q), smallest first, into a zeroed f32 tile
// that is then added to the accumulator in IEEE f32 (tensor-core
// accumulation truncates: over a long k it drifts from a rounded sum); a
// 1 × 1 product may instead accumulate on the tensor cores (kChain). 3 × 1
// (the MLP decoder's f32 cotangent against bf16 weights) is that operand
// unrounded against a bf16 one; 3 × 3 (the row sum's f32 mode) is the six
// terms of order < 3 of two exact splits, f32-accurate (the terms left out
// are of order 2⁻²⁴ of the product, as in an f32 FMA's rounding).
//
// Products are mma.sync m16n8k16 bf16 → f32, fed by ldmatrix from shared
// memory: every operand is staged there already in its bf16 parts, by
// cp.async 16-byte copies from bf16 arrays in global memory (zero-padded to
// multiples of 16 columns; rows past the end are zero-filled by the copy).
// Tile loops have compile-time trip counts (a warp's tiles past the end
// repeat a valid one, unread), so each k-step is straight-line code.
// Two building blocks, each the body of a kernel:
// (a) hbar_slabs: a block owns TM rows whose H tile is in shared memory; it
//     walks D in slabs of SN columns, the W slab staged by cp.async
//     (double-buffered where shared memory allows); per slab it forms o on
//     the tensor cores, do = −s·σ(o + b) in registers (written to shared
//     memory in its parts) and adds do·Wᵀ into the block's H̄ tile, held in
//     registers across slabs; optionally it also writes do's parts to global
//     memory, for a (b) block that loads them instead of forming o again.
// (b) wbar_tiles: a block owns a D chunk of SNB columns and a range of row
//     tiles; it stages the chunk of W once, walks its row tiles with the H
//     tile (and, in the loaded mode, the cotangent tile) staged by cp.async
//     ahead of use, forms o → do (or takes the loaded cotangent), adds Hᵀ·do
//     into the chunk of W̄ in registers, and adds the f32 column sums of do
//     into b̄ in row order. Each block writes one partial; the caller adds
//     the partials in split order (no float atomics: reruns are bit-equal).
// A configuration (CfgA, CfgB) sets the tile sizes, stages, warps and the
// blocks an SM holds: with two, one block's σ epilogue and barriers overlap
// the other's products (registers capped at 128 a thread).
// The PTX helpers (mma, ldmatrix, cp.async) are the only inline assembly;
// a CPU rehearsal (a g++ mock of the CUDA runtime, SKILL.md) defines
// SVAX_MOCK_PTX and supplies scalar emulations with PTX's lane layouts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "phase_clock.cuh"

namespace lastlayer {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 past each shared row: rows 16 B apart mod 128 B

__host__ __device__ constexpr int round_up(int v, int q) { return (v + q - 1) / q * q; }

// ------------------------------------------------------------- PTX helpers

#ifndef SVAX_MOCK_PTX
// c += a·b on one 16×8 tile (m16n8k16, bf16 in, f32 accumulate).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8×8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register j of a lane holds matrix j's row
// lane / 4, columns 2·(lane % 4) and +1 (.trans: the transposed matrix).
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes global → shared, asynchronously; `bytes` < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

// ---------------------------------------------------------------- values

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v as P bf16 parts: P = 1 rounds; P = 2 carries 16 bits (v = p0 + p1 to
// 2⁻¹⁶ of v); P = 3 splits exactly (v = p0 + p1 + p2).
template <int P>
__device__ __forceinline__ void split(float v, bf16 (&p)[P]) {
  static_assert(P >= 1 && P <= 3, "1 to 3 parts");
  p[0] = __float2bfloat16_rn(v);
  if constexpr (P >= 2) {
    const float r = v - __bfloat162float(p[0]);
    p[1] = __float2bfloat16_rn(r);
    if constexpr (P == 3) p[2] = __float2bfloat16_rn(r - __bfloat162float(p[1]));
  }
}

// σ(o), as torch's log_sigmoid_backward forms it for the input −o (the MLP
// decoder's autograd), or as torch.sigmoid (the row sum's plain version).
template <bool kAsLogsigBackward>
__device__ __forceinline__ float sigmoid(float o) {
  if constexpr (kAsLogsigBackward) {
    const float e = expf(-fabsf(o));
    const float r = e * __frcp_rn(1.0f + e);  // within an ulp of e / (1 + e)
    return o > 0.0f ? 1.0f - r : r;
  } else {
    return __frcp_rn(1.0f + expf(-o));  // = 1 / (1 + e), correctly rounded
  }
}

// The do epilogue of a warp's o tiles: for its OMI m16 tiles at rows om.. and
// the n16 pair at column on (of the slab or chunk c0..), do = −s·σ(o + b)
// (0 past column d) into P parts at ds (row stride lds, part stride dps),
// two neighbouring columns a 32-bit store; and, with kF32, in f32 at dsf
// (row stride ldf). The rows' scales and the columns' biases are read first.
template <int OMI, int PD, bool kTorchSigmoid, bool kF32>
__device__ __forceinline__ void do_epilogue(const float (&o)[OMI][1][2][4], int om, int on, int c0,
                                            int d, const float* bias, const float* srow,
                                            bf16* ds, int lds, int dps, float* dsf, int ldf,
                                            int lane) {
  float bc[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = c0 + on + 8 * h + 2 * (lane & 3) + j;
      bc[h][j] = col < d ? bias[col] : 0.0f;
    }
#pragma unroll
  for (int i = 0; i < OMI; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = om + 16 * i + (lane >> 2) + 8 * r;
      const float sc = srow[row];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cl = on + 8 * h + 2 * (lane & 3);
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          v[j] = c0 + cl + j < d ? -(sc * sigmoid<kTorchSigmoid>(o[i][0][h][2 * r + j] + bc[h][j]))
                                 : 0.0f;
        bf16 p0[PD], p1[PD];
        split<PD>(v[0], p0);
        split<PD>(v[1], p1);
#pragma unroll
        for (int k = 0; k < PD; ++k) {
          __nv_bfloat162 pair;
          pair.x = p0[k];
          pair.y = p1[k];
          *reinterpret_cast<__nv_bfloat162*>(ds + k * dps + row * lds + cl) = pair;
        }
        if constexpr (kF32) *reinterpret_cast<float2*>(dsf + row * ldf + cl) = make_float2(v[0], v[1]);
      }
    }
}

// --------------------------------------------------------------- staging

// cp.async of a (rows × cols) bf16 block, cols a multiple of 8, from global
// (row stride ldg, rows below `rmax` valid, columns below `cmax` valid; the
// rest zero-filled) into shared memory (row stride lds). All threads call it.
__device__ __forceinline__ void stage(bf16* s, int lds, const bf16* g, size_t ldg, int rows,
                                      int cols, int rmax, int cmax) {
  const int per_row = cols / 8;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
    const int r = idx / per_row, c = (idx % per_row) * 8;
    const bool ok = r < rmax && c < cmax;
    cp_async16(s + r * lds + c, ok ? g + static_cast<size_t>(r) * ldg + c : g, ok ? 16 : 0);
  }
}

// ------------------------------------------------------------- products

// One 16×16 tile pair's terms: acc[h] += Σ_{i + j < max(PA, PB)} A_i · B_j
// for the two n8 halves h, A in PA parts, B in PB parts ({half 0: k 0-7,
// k 8-15; half 1: k 0-7, k 8-15} per part). kChain: a 1 × 1 product
// accumulates on the tensor cores; otherwise the terms go, smallest first,
// into a zeroed tile that is added to acc in f32.
template <int PA, int PB, bool kChain>
__device__ __forceinline__ void tile_terms(float (&acc)[2][4], const uint32_t (&fa)[PA][4],
                                           const uint32_t (&fb)[PB][4]) {
  constexpr int kOrders = PA > PB ? PA : PB;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (PA == 1 && PB == 1 && kChain) {
      const uint32_t bh[2] = {fb[0][2 * h], fb[0][2 * h + 1]};
      mma(acc[h], fa[0], bh);
    } else {
      float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s = kOrders - 1; s >= 0; --s)
#pragma unroll
        for (int pi = PA - 1; pi >= 0; --pi) {
          const int pj = s - pi;
          if (pj < 0 || pj >= PB) continue;
          const uint32_t bh[2] = {fb[pj][2 * h], fb[pj][2 * h + 1]};
          mma(t, fa[pi], bh);
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] += t[e];
    }
  }
}

// Fragments of an m16 × k16 A tile (rows m0.., k0..) in PA parts `pa` apart:
// ATR false: [m][k] storage (row stride lda); true: [k][m].
template <int PA, bool ATR>
__device__ __forceinline__ void load_a(uint32_t (&fa)[PA][4], const bf16* a, int lda, int pa,
                                       int m0, int k0, int lane) {
#pragma unroll
  for (int p = 0; p < PA; ++p) {
    if constexpr (ATR) {
      ldsm_t(fa[p], a + p * pa + (k0 + (lane & 7) + (lane >> 4) * 8) * lda + m0 +
                        ((lane >> 3) & 1) * 8);
    } else {
      ldsm(fa[p], a + p * pa + (m0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
    }
  }
}

// Fragments of a k16 × n16 B tile pair (k0.., columns n0..) in PB parts `pb`
// apart: BKN false: [n][k] storage (row stride ldb); true: [k][n].
template <int PB, bool BKN>
__device__ __forceinline__ void load_b(uint32_t (&fb)[PB][4], const bf16* b, int ldb, int pb,
                                       int n0, int k0, int lane) {
#pragma unroll
  for (int p = 0; p < PB; ++p) {
    if constexpr (BKN) {
      ldsm_t(fb[p], b + p * pb + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + n0 +
                        (lane >> 4) * 8);
    } else {
      ldsm(fb[p], b + p * pb + (n0 + (lane & 7) + (lane >> 4) * 8) * ldb + k0 +
                      ((lane >> 3) & 1) * 8);
    }
  }
}

// acc[i][q] += A · B over `ksteps` 16-deep steps from k = 0, for the m16
// tiles i < mi at rows m0 + i·ms and the n16 pairs q < nq at columns n0 +
// q·ns (A and B as load_a, load_b). MI == 1 keeps A's fragments and walks
// the pairs; otherwise NQ must be 1 and B's fragments stay while the m
// tiles are walked, so at most one operand's parts are held at a time.
// Every one of the MI × NQ tiles is computed, with no branch in the loop:
// a tile past mi (nq) repeats the last valid one (tile 0 if none is), and
// its sums are left unread by the caller.
template <int MI, int NQ, int PA, int PB, bool ATR, bool BKN, bool kChain>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NQ][2][4], const bf16* a, int lda,
                                         int pa, int m0, int ms, int mi, const bf16* b, int ldb,
                                         int pb, int n0, int ns, int nq, int ksteps, int lane) {
  static_assert(MI == 1 || NQ == 1, "one operand stays in registers");
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 16;
    if constexpr (MI == 1) {
      uint32_t fa[PA][4];
      load_a<PA, ATR>(fa, a, lda, pa, m0, k0, lane);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        uint32_t fb[PB][4];
        load_b<PB, BKN>(fb, b, ldb, pb, nq > 0 ? n0 + (q < nq ? q : nq - 1) * ns : 0, k0, lane);
        tile_terms<PA, PB, kChain>(acc[0][q], fa, fb);
      }
    } else {
      uint32_t fb[PB][4];
      load_b<PB, BKN>(fb, b, ldb, pb, n0, k0, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t fa[PA][4];
        load_a<PA, ATR>(fa, a, lda, pa, mi > 0 ? m0 + (i < mi ? i : mi - 1) * ms : 0, k0, lane);
        tile_terms<PA, PB, kChain>(acc[i][0], fa, fb);
      }
    }
  }
}

template <int MI, int NQ>
__device__ __forceinline__ void zero(float (&acc)[MI][NQ][2][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][h][e] = 0.0f;
}

// The row and column (within the tile) of a lane's element e of half h of
// a pair at column n0: row m0 + lane/4 (+8 for e ≥ 2), column n0 + 8h + 2(lane%4) + (e&1).
__device__ __forceinline__ int frag_row(int m0, int lane, int e) {
  return m0 + (lane >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int n0, int h, int lane, int e) {
  return n0 + 8 * h + 2 * (lane & 3) + (e & 1);
}

// ---------------------------------------------------- the (a) block: H̄

// Configurations: TM rows a block, SN columns a slab, ST stages of W slabs,
// KPMAX the widest padded K they take, WARPS warps. The H̄ tile is (TM/16)
// m16 tiles × (K/16) n16 pairs: warp w takes m-tile w % WM and pairs
// w / WM + WN·q.
template <int TM_, int SN_, int ST_, int KPMAX_, int WARPS_, int MINB_ = 1>
struct CfgA {
  static constexpr int TM = TM_, SN = SN_, ST = ST_, KPMAX = KPMAX_, WARPS = WARPS_;
  static constexpr int MINB = MINB_;  // blocks an SM holds (registers capped to fit)
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WM = TM / 16, WN = WARPS / WM;
  static constexpr int NQ = (KPMAX / 16 + WN - 1) / WN;
  // o per slab: jobs of OMI m16 tiles × one n16 pair (OMI = 2 where there
  // are two tiles a warp).
  static constexpr int OT = (TM / 16) * (SN / 16);
  static constexpr int OMI = OT >= 2 * WARPS && (TM / 16) % 2 == 0 ? 2 : 1;
  static constexpr int OJ = OT / OMI, OJM = TM / 16 / OMI;
  static_assert(WM * WN == WARPS, "warps tile the rows");
  // Shared memory (bf16 elements) of the slab loop, past the H tile.
  __host__ __device__ static constexpr int ws_elems(int kp, int pw) {
    return ST * pw * kp * (SN + kPad);
  }
  __host__ __device__ static constexpr int ds_elems(int pd) { return pd * TM * (SN + kPad); }
};

using CfgAWide = CfgA<32, 16, 1, 512, 8>;

// H̄ += do·Wᵀ over every slab of D, for the block's TM rows whose H parts
// (PH, `hps` apart, row stride kp + kPad) are in shared memory at `hs`.
// W: PW parts (global, `wps` apart, [kp][np] with np = round16(D)); Ws and
// Ds: the shared slab buffers (Cfg::ws_elems, Cfg::ds_elems); bias (D);
// srow: the rows' scales in shared memory (0 past the end). acc: this
// warp's H̄ tiles (m-tile warp % WM, pairs warp / WM + WN·q). dg, if not
// null: do's PD parts go there too, each [rows][np] (the block's first row
// at dg), `dgps` apart.
template <class Cfg, int PH, int PW, int PD, bool kChainO, bool kChainH, bool kTorchSigmoid>
__device__ void hbar_slabs(float (&acc)[1][Cfg::NQ][2][4], const bf16* hs, int hps, bf16* ws,
                           bf16* ds, const bf16* w, size_t wps, int kp, int d, const float* bias,
                           const float* srow, bf16* dg = nullptr, size_t dgps = 0,
                           int rows = 0) {
  constexpr int TM = Cfg::TM, SN = Cfg::SN, ST = Cfg::ST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int np = round_up(d, 16), ldh = kp + kPad, lds = SN + kPad;
  const int slabs = (d + SN - 1) / SN;
  const int wsz = PW * kp * lds;  // one stage
  auto load = [&](int s) {
    bf16* dst = ws + (s % ST) * wsz;
    for (int p = 0; p < PW; ++p)
      stage(dst + p * kp * lds, lds, w + p * wps + s * SN, np, kp, SN, kp, np - s * SN);
    cp_async_commit();
  };
  zero(acc);
  const int hm = warp % Cfg::WM, hq0 = warp / Cfg::WM;
  const int hnq = (kp / 16 - hq0 + Cfg::WN - 1) / Cfg::WN;
  load(0);
  for (int s = 0; s < slabs; ++s) {
    if (ST == 2 && s + 1 < slabs) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slab s is in
    PHASE_MARK(13);
    const bf16* wsl = ws + (s % ST) * wsz;
    // o = H · W[:, slab] + b, do = −s·σ(o) into Ds (masked past D).
    for (int t = warp; t < Cfg::OJ; t += Cfg::WARPS) {
      constexpr int OMI = Cfg::OMI;
      const int om = (t % Cfg::OJM) * 16 * OMI, on = (t / Cfg::OJM) * 16;
      float o[OMI][1][2][4];
      zero(o);
      warp_mma<OMI, 1, PH, PW, false, true, kChainO>(o, hs, ldh, hps, om, 16, OMI, wsl, lds,
                                                     kp * lds, on, 0, 1, kp / 16, lane);
      PHASE_MARK(14);
      do_epilogue<OMI, PD, kTorchSigmoid, false>(o, om, on, s * SN, d, bias, srow, ds, lds,
                                                 TM * lds, nullptr, 0, lane);
    }
    __syncthreads();  // Ds is written
    if (dg != nullptr) {  // 16-byte rows of do's parts, below `rows` and column np
      constexpr int kPer = SN / 8;
      for (int idx = threadIdx.x; idx < PD * TM * kPer; idx += Cfg::THREADS) {
        const int p = idx / (TM * kPer), r = idx / kPer % TM, c = idx % kPer * 8;
        if (r < rows && s * SN + c < np)
          *reinterpret_cast<uint4*>(dg + p * dgps + static_cast<size_t>(r) * np + s * SN + c) =
              *reinterpret_cast<const uint4*>(ds + p * TM * lds + r * lds + c);
      }
    }
    // H̄ += Ds · W[:, slab]ᵀ: B(k = slab column, n = h) = W[h][col], [n][k].
    PHASE_MARK(8);
    warp_mma<1, Cfg::NQ, PD, PW, false, false, kChainH>(acc, ds, lds, TM * lds, hm * 16, 0, 1, wsl,
                                                      lds, kp * lds, hq0 * 16, Cfg::WN * 16, hnq,
                                                      SN / 16, lane);
    __syncthreads();  // the slab and Ds are free
    PHASE_MARK(9);
    if (ST == 1 && s + 1 < slabs) load(s + 1);
  }
}

// ---------------------------------------------------- the (b) block: W̄

// Configurations: TMB rows a tile, SNB columns a chunk, ST stages of row
// tiles, KPMAX the widest padded K, WARPS warps. The W̄ chunk (K × SNB) is (K/16)
// m16 tiles × (SNB/16) n16 pairs: warp w takes pair w % WP and m-tiles
// w / WP + WG·q.
template <int TMB_, int SNB_, int ST_, int KPMAX_, int WARPS_, int MINB_ = 1>
struct CfgB {
  static constexpr int TMB = TMB_, SNB = SNB_, ST = ST_, KPMAX = KPMAX_, WARPS = WARPS_;
  static constexpr int MINB = MINB_;  // blocks an SM holds (registers capped to fit)
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WP = SNB / 16, WG = WARPS / WP;
  static constexpr int MQ = (KPMAX / 16 + WG - 1) / WG;
  static constexpr int OT = (TMB / 16) * (SNB / 16);
  static constexpr int OMI = OT >= 2 * WARPS && (TMB / 16) % 2 == 0 ? 2 : 1;
  static constexpr int OJ = OT / OMI, OJM = TMB / 16 / OMI;
  static_assert(WP * WG == WARPS, "warps tile the chunk");
};

using CfgBWide = CfgB<32, 16, 1, 512, 8>;

// The cotangent of a (b) block: formed from o (kFromO: do = −s·σ(H W + b))
// or loaded (G parts from global, as H's rows).
struct WbarArgs {
  const bf16* h;     // PH parts, each [m][kp], `hps` apart
  size_t hps;
  const bf16* w;     // kFromO: PW parts [kp][np], `wps` apart
  size_t wps;
  const float* bias; // kFromO: (D)
  const float* srow; // kFromO: (M) per-row scale
  const bf16* g;     // loaded: PD parts [m][np], `gps` apart
  size_t gps;
  int m, kp, d;      // rows, padded K, columns D
  int splits;        // row splits: block (chunk, split) takes tiles [t0, t1)
  float* pw;         // partials: (splits, kp, np) — rows ≥ K hold zeros
  float* pb;         // (splits, np)
};

// Shared memory (bytes) of a (b) block.
template <class Cfg, int PH, int PW, int PD, bool kFromO, bool kTieRepair = false>
__host__ __device__ constexpr size_t wbar_smem(int kp) {
  return sizeof(bf16) * (static_cast<size_t>(kFromO ? PW * kp * (Cfg::SNB + kPad) : 0) +
                         static_cast<size_t>(Cfg::ST) * (PH * Cfg::TMB * (kp + kPad) +
                                                         (kFromO ? 0 : PD * Cfg::TMB * (Cfg::SNB + kPad))) +
                         static_cast<size_t>(kFromO ? PD * Cfg::TMB * (Cfg::SNB + kPad) : 0)) +
         sizeof(float) * (static_cast<size_t>(kFromO ? Cfg::TMB * (Cfg::SNB + kPad) : 0) +
                          Cfg::ST * Cfg::TMB) +
         (kTieRepair ? sizeof(int) * (static_cast<size_t>(Cfg::TMB) * Cfg::SNB + 1) : 0);
}

// The rounding-tie window of the bf16 mode's do (see kTieRepair): f32 values
// whose 16 bits below bf16 precision lie within this many units of the half
// ulp (0x8000) — ~3% of them, wider than the difference between the tensor
// cores' logits and a sequential f32 FMA chain's.
constexpr unsigned kTieWindow = 2048;

// One (chunk, split) block: blockIdx.x the chunk of SNB columns, blockIdx.y
// the split. Writes its partial W̄ chunk (kp × SNB, through column np) and b̄.
// kTieRepair (1-part operands, do rounded to bf16): an f32 do near a bf16
// rounding tie is formed again from o summed as a sequential f32 FMA chain
// over k (in the order of a plain f32 product, as cuBLAS's SGEMM and the
// reference's f32 dot sum), so that it rounds as the plain version's does:
// the tensor cores sum each 16-deep step at once, and a do that rounds the
// other way moves W̄ by a bf16 ulp of one term.
template <class Cfg, int PH, int PW, int PD, bool kFromO, bool kChainO, bool kTorchSigmoid,
          bool kTieRepair = false>
__device__ void wbar_tiles(const WbarArgs& a, unsigned char* smem_raw) {
  static_assert(!kTieRepair || (kFromO && PH == 1 && PW == 1 && PD == 1), "1-part do from o");
  constexpr int TMB = Cfg::TMB, SNB = Cfg::SNB, ST = Cfg::ST, kLdf = SNB + kPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tid = threadIdx.x;
  const int kp = a.kp, ldh = kp + kPad, lds = SNB + kPad, np = round_up(a.d, 16);
  const int c0 = blockIdx.x * SNB, sp = blockIdx.y;
  const int tiles = (a.m + TMB - 1) / TMB;
  const int t0 = static_cast<int>(static_cast<long long>(sp) * tiles / a.splits);
  const int t1 = static_cast<int>(static_cast<long long>(sp + 1) * tiles / a.splits);
  bf16* wc = reinterpret_cast<bf16*>(smem_raw);                // PW × [kp][lds]
  bf16* hs = wc + (kFromO ? PW * kp * lds : 0);                 // ST × PH × [TMB][ldh]
  const int hsz = PH * TMB * ldh + (kFromO ? 0 : PD * TMB * lds);  // one stage (H, loaded G)
  bf16* ds = hs + ST * hsz;                                     // kFromO: PD × [TMB][lds]
  float* dsf = reinterpret_cast<float*>(ds + (kFromO ? PD * TMB * lds : 0));  // kFromO: [TMB][kLdf]
  float* ss = dsf + (kFromO ? TMB * kLdf : 0);                  // ST × [TMB] row scales
  int* rep_n = reinterpret_cast<int*>(ss + ST * TMB);           // kTieRepair: count, list
  int* rep = rep_n + 1;

  auto load = [&](int t) {
    bf16* dst = hs + ((t - t0) % ST) * hsz;
    const int r0 = t * TMB, rmax = a.m - r0;
    for (int p = 0; p < PH; ++p)
      stage(dst + p * TMB * ldh, ldh, a.h + p * a.hps + static_cast<size_t>(r0) * kp, kp, TMB, kp,
            rmax, kp);
    if constexpr (!kFromO) {
      for (int p = 0; p < PD; ++p)
        stage(dst + PH * TMB * ldh + p * TMB * lds, lds,
              a.g + p * a.gps + static_cast<size_t>(r0) * np + c0, np, TMB, SNB, rmax, np - c0);
    } else {
      float* sdst = ss + ((t - t0) % ST) * TMB;
      for (int r = tid; r < TMB; r += blockDim.x) sdst[r] = r0 + r < a.m ? a.srow[r0 + r] : 0.0f;
    }
    cp_async_commit();
  };

  if constexpr (kFromO) {
    for (int p = 0; p < PW; ++p)
      stage(wc + p * kp * lds, lds, a.w + p * a.wps + c0, np, kp, SNB, kp, np - c0);
  }
  float acc[Cfg::MQ][1][2][4];
  zero(acc);
  const int wp = warp % Cfg::WP, wg = warp / Cfg::WP;
  const int mq = (kp / 16 - wg + Cfg::WG - 1) / Cfg::WG;
  float bacc = 0.0f;  // thread tid < SNB: b̄ of column c0 + tid
  for (int t = t0; t < t0 + (ST > 1 ? ST - 1 : 1) && t < t1; ++t) load(t);
  for (int t = t0; t < t1; ++t) {
    if (ST > 1 && t + ST - 1 < t1) {
      load(t + ST - 1);
      cp_async_wait<(ST > 1 ? ST - 1 : 0)>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and the W chunk) are in
    PHASE_MARK(10);
    const bf16* ht = hs + ((t - t0) % ST) * hsz;
    const bf16* gt;
    int gps;
    if constexpr (kFromO) {
      const float* st = ss + ((t - t0) % ST) * TMB;
      for (int ot = warp; ot < Cfg::OJ; ot += Cfg::WARPS) {
        constexpr int OMI = Cfg::OMI;
        const int om = (ot % Cfg::OJM) * 16 * OMI, on = (ot / Cfg::OJM) * 16;
        float o[OMI][1][2][4];
        zero(o);
        warp_mma<OMI, 1, PH, PW, false, true, kChainO>(o, ht, ldh, TMB * ldh, om, 16, OMI, wc, lds,
                                                       kp * lds, on, 0, 1, kp / 16, lane);
        PHASE_MARK(15);
        do_epilogue<OMI, PD, kTorchSigmoid, true>(o, om, on, c0, a.d, a.bias, st, ds, lds,
                                                  TMB * lds, dsf, kLdf, lane);
      }
      if constexpr (kTieRepair) {
        if (tid == 0) *rep_n = 0;
        __syncthreads();  // do is written
        for (int idx = tid; idx < TMB * SNB; idx += blockDim.x) {
          const unsigned low = __float_as_uint(dsf[(idx / SNB) * kLdf + idx % SNB]) & 0xFFFFu;
          if (low - 0x8000u + kTieWindow < 2 * kTieWindow) rep[atomicAdd(rep_n, 1)] = idx;
        }
        __syncthreads();
        for (int i = tid; i < *rep_n; i += blockDim.x) {
          const int row = rep[i] / SNB, cl = rep[i] % SNB, col = c0 + cl;
          float o = 0.0f;
          for (int k0 = 0; k0 < kp; k0 += 8) {  // 8 operand pairs in flight, summed in k order
            const uint4 hq = *reinterpret_cast<const uint4*>(ht + row * ldh + k0);
            const bf16* hv = reinterpret_cast<const bf16*>(&hq);
            float wv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) wv[j] = __bfloat162float(wc[(k0 + j) * lds + cl]);
#pragma unroll
            for (int j = 0; j < 8; ++j) o = fmaf(__bfloat162float(hv[j]), wv[j], o);
          }
          const float v = col < a.d ? -(st[row] * sigmoid<kTorchSigmoid>(o + a.bias[col])) : 0.0f;
          dsf[row * kLdf + cl] = v;
          ds[row * lds + cl] = __float2bfloat16_rn(v);
        }
      }
      gt = ds;
      gps = TMB * lds;
    } else {
      gt = ht + PH * TMB * ldh;
      gps = TMB * lds;
    }
    __syncthreads();  // do (parts, and f32 where formed) is written
    PHASE_MARK(11);
    if (tid < SNB) {  // b̄: the f32 do (a loaded one is the sum of its parts), in row order
#pragma unroll
      for (int r = 0; r < TMB; ++r) {
        if constexpr (kFromO) {
          bacc += dsf[r * kLdf + tid];
        } else {
          float v = 0.0f;
#pragma unroll
          for (int j = PD - 1; j >= 0; --j) v += __bfloat162float(gt[j * gps + r * lds + tid]);
          bacc += v;
        }
      }
    }
    // W̄[:, chunk] += Hᵀ · do: A(m = k of H, k = row) = H[row][k] ([k][m]),
    // B(k = row, n = column) = do[row][col] ([k][n]).
    warp_mma<Cfg::MQ, 1, PH, PD, true, true, false>(acc, ht, ldh, TMB * ldh, wg * 16,
                                                    Cfg::WG * 16, mq, gt, lds, gps, wp * 16, 0, 1,
                                                    TMB / 16, lane);
    __syncthreads();  // the tile's buffers are free
    PHASE_MARK(12);
    if (ST == 1 && t + 1 < t1) load(t + 1);
  }
  // The partial: rows kp of the chunk (columns c0.. below np), and b̄.
  float* pw = a.pw + static_cast<size_t>(sp) * kp * np;
#pragma unroll
  for (int q = 0; q < Cfg::MQ; ++q) {
    if (q >= mq) break;
    const int m0 = (wg + Cfg::WG * q) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = frag_row(m0, lane, e), col = c0 + frag_col(wp * 16, h, lane, e);
        if (col < np) pw[static_cast<size_t>(row) * np + col] = acc[q][0][h][e];
      }
  }
  if (tid < SNB && c0 + tid < np) a.pb[static_cast<size_t>(sp) * np + c0 + tid] = bacc;
}

}  // namespace lastlayer
