// cluster_step: the engine of the whole-step kernels (tinystep.cu,
// flexstep.cu) — one chunk of T training steps as ONE thread-block cluster
// of C CTAs on neighbouring SMs.
//
// * A partition by data point. CTA r owns points [part_begin(N, C, r),
//   part_begin(N, C, r + 1)): ragged, possibly empty (N < C). It owns every
//   per-point record and decoder row of those points, so everything from
//   the encoder down to the encoder's backward needs only __syncthreads()
//   inside the CTA. The flat parameter vector is cut the same way: CTA r
//   owns slice r for the reduction and Adam. The wrappers' cluster_plan
//   (svax_torch/ops/tinystep.py, flexstep.py) mirrors part_begin.
// * An ordered reduce-scatter, then a broadcast, per step. Each CTA leaves
//   its partial sums (weight gradients, statistics, metrics) in its shared
//   memory or in its slab of global scratch; one cluster barrier; CTA r
//   adds the C partials of its parameter slice in rank order 0..C−1
//   (through map_shared_rank or from the slabs), runs Adam on it with its
//   slice of the moments (kept in its own shared memory for the whole
//   chunk) and writes the updated slice into every CTA's parameter copy.
//   The statistics and metrics are a few floats: every CTA adds them
//   redundantly in the same rank order, so every CTA holds bit-identical
//   totals without a broadcast. A second cluster barrier ends the step.
//   No float atomics anywhere: two runs at one seed are bit-equal.
// * The bf16-product mode (the reference's nn_precision DEFAULT): every
//   MLP product takes bf16-rounded operands (bf16_round, operand<>) with
//   f32 FMAs and sums; the weights are rounded once a step, when the
//   update is broadcast into the CTAs' shared copies, from the f32 master
//   that the slice's owner keeps beside its Adam moments.
// * launch_cluster: the cluster launch (cudaLaunchKernelEx with the
//   cluster-dimension attribute; the non-portable size attribute above 8),
//   refused with an error when cudaOccupancyMaxActiveClusters finds no
//   place for one cluster. There is no smaller-cluster or one-block path.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace svax {
namespace cluster_step {

namespace cg = cooperative_groups;

constexpr float kB1 = 0.9f, kB2 = 0.999f, kAdamEps = 1e-8f;

// First item of part r when `count` items are cut into `parts` parts:
// ⌊r·count/parts⌋. Part r is [part_begin(r), part_begin(r + 1)).
__host__ __device__ inline long long part_begin(long long count, int parts, int r) {
  return count * r / parts;
}

// The CTA's rank in its cluster, read afresh at each call: a volatile
// read, so that what a kernel derives from it (its part, its slab) is
// recomputed where it is used instead of held in registers across a step.
__device__ __forceinline__ int cluster_rank() {
#ifndef SVAX_MOCK_PTX
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
#else
  return static_cast<int>(cg::this_cluster().block_rank());
#endif
}

// The thread's index in its CTA, read afresh at each call (a volatile
// read, as cluster_rank): what a kernel derives from it is not hoisted out
// of its step loop.
__device__ __forceinline__ int thread_index() {
#ifndef SVAX_MOCK_PTX
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
#else
  return static_cast<int>(threadIdx.x);
#endif
}

// The most items any part holds: ⌈count/parts⌉.
__host__ __device__ inline long long part_max(long long count, int parts) {
  return (count + parts - 1) / parts;
}

// Adam's bias corrections at the global count (optax.adam).
__device__ inline void adam_bias(int count, float& bc1, float& bc2) {
  bc1 = static_cast<float>(1.0 - pow(0.9, static_cast<double>(count)));
  bc2 = static_cast<float>(1.0 - pow(0.999, static_cast<double>(count)));
}

// The shared copy of an updated parameter: the f32 value itself.
struct SameValue {
  __device__ float operator()(long long, float p) const { return p; }
};

// CTA `rank`'s share of the step's update, between the two cluster
// barriers: for flat parameter i in [p0, p1), g = Σ_j part(j, i) in rank
// order, Adam with this CTA's moments m[i − p0], v[i − p0], and
// copy(i, new value) written into params[i] of every CTA of the cluster.
// With `master` (the slice's f32 values, master[i − p0]) Adam reads and
// writes the master and the shared copies may hold another form of it
// (the kernels' bf16-product mode: weights rounded to bf16 once a step);
// without, the shared copy is the master. All threads call; NT threads
// stride the slice.
template <int C, int NT, class Part, class Copy = SameValue>
__device__ void reduce_adam_broadcast(cg::cluster_group& cl, const Part& part, float* params,
                                      float* m, float* v, long long p0, long long p1, float lr,
                                      float bc1, float bc2, float* master = nullptr,
                                      const Copy& copy = Copy()) {
  for (long long i = p0 + thread_index(); i < p1; i += NT) {
    float g = part(0, i);
#pragma unroll 4
    for (int j = 1; j < C; ++j) g += part(j, i);
    const long long li = i - p0;
    const float mm = (1.0f - kB1) * g + kB1 * m[li];
    const float vv = (1.0f - kB2) * g * g + kB2 * v[li];
    m[li] = mm;
    v[li] = vv;
    const float old = master ? master[li] : params[i];
    const float p = old - lr * ((mm / bc1) / (sqrtf(vv / bc2) + kAdamEps));
    if (master) master[li] = p;
    const float shared = copy(i, p);
#pragma unroll 4
    for (int j = 0; j < C; ++j) *cl.map_shared_rank(params + i, j) = shared;
  }
}

// x rounded to bf16 (round to nearest even) and back: the operand of a
// product at the reference's Precision.DEFAULT (one bf16 pass, f32 sums).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 bf16_round4(float4 q) {
  return make_float4(bf16_round(q.x), bf16_round(q.y), bf16_round(q.z), bf16_round(q.w));
}

// A product operand in the kernels' mode: bf16-rounded when kBf16, else as is.
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  return kBf16 ? bf16_round(x) : x;
}

// out[i] = Σ_j part(j, i) in rank order, for i < count: every CTA computes
// the same totals. All threads call.
template <int C, int NT, class Part>
__device__ void sum_ranks(const Part& part, int count, float* out) {
  for (int i = thread_index(); i < count; i += NT) {
    float s = part(0, i);
#pragma unroll 4
    for (int j = 1; j < C; ++j) s += part(j, i);
    out[i] = s;
  }
}

// Rank j's partial of index i, read from its shared memory.
struct SharedPart {
  cg::cluster_group* cl;
  float* local;  // this CTA's partial; the others sit at the same offset
  __device__ float operator()(int j, long long i) const {
    return *cl->map_shared_rank(local + i, j);
  }
};

// Rank j's partial of index i, read from its slab of global scratch
// (ld.global.cg: from L2, past this SM's L1, which another SM's writes do
// not reach).
struct SlabPart {
  const float* base;  // rank 0's slab
  long long stride;   // floats from one rank's slab to the next
  __device__ float operator()(int j, long long i) const { return __ldcg(base + j * stride + i); }
};

// Launch `kernel(arg)` as one cluster of c CTAs of `threads` threads with
// `smem` bytes of dynamic shared memory each. Returns a cudaError_t: the
// attributes' or the launch's error, or cudaErrorInvalidClusterSize when
// no cluster of that shape fits on the card.
template <class Arg>
int launch_cluster(void (*kernel)(Arg), int c, int threads, size_t smem, cudaStream_t stream,
                   const Arg& arg) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidClusterSize);
  err = cudaLaunchKernelEx(&cfg, kernel, arg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cluster_step
}  // namespace svax
