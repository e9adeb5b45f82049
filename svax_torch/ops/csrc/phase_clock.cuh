// Phase clocks: where a block's time goes, by phase, read with clock64().
//
// Compiled in only with -DSVAX_PHASE_CLOCKS (svax_torch/measure_phases.py
// builds the sources that way into a library of its own); otherwise every
// macro is empty and the kernels are as shipped. PHASE_START at a kernel's
// top; PHASE_MARK(slot) — in the kernel or in a device function it calls —
// has thread 0 of the block add the clocks since its previous mark to the
// slot, so a mark placed after a __syncthreads() charges the whole block's
// time to the phase that just ended. Slots 0–7 are the backward kernels'
// own, 8–15 the engine's backward blocks (lastlayer.cuh), 16–23 the forward
// kernels' own and 24–31 the engine's forward block. Each source that includes this header
// owns its slots and reads them with the C entry SVAX_PHASE_ENTRY(name)
// defines: int name(unsigned long long* out) copies the kPhaseSlots sums
// to the host and zeroes them.

#pragma once

#ifdef SVAX_PHASE_CLOCKS

#include <cuda_runtime.h>

constexpr int kPhaseSlots = 32;
constexpr int kPhaseLast = 65536;  // thread 0's last clock, by block (mod)
static __device__ unsigned long long g_phase_clocks[kPhaseSlots];
static __device__ long long g_phase_last[kPhaseLast];

__device__ __forceinline__ long long& svax_phase_last() {
  const long long blk = blockIdx.x + static_cast<long long>(gridDim.x) * blockIdx.y;
  return g_phase_last[blk % kPhaseLast];
}

__device__ __forceinline__ void svax_phase_start() {
  if (threadIdx.x == 0) svax_phase_last() = clock64();
}

__device__ __forceinline__ void svax_phase_mark(int slot) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    long long& last = svax_phase_last();
    atomicAdd(&g_phase_clocks[slot], static_cast<unsigned long long>(now - last));
    last = now;
  }
}

#define PHASE_START svax_phase_start()
#define PHASE_MARK(slot) svax_phase_mark(slot)
#define SVAX_PHASE_ENTRY(name)                                                              \
  extern "C" int name(unsigned long long* out) {                                            \
    cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));   \
    if (err != cudaSuccess) return static_cast<int>(err);                                   \
    static const unsigned long long zeros[kPhaseSlots] = {};                                \
    return static_cast<int>(cudaMemcpyToSymbol(g_phase_clocks, zeros, sizeof(zeros)));     \
  }

#else

#define PHASE_START
#define PHASE_MARK(slot)
#define SVAX_PHASE_ENTRY(name)

#endif
