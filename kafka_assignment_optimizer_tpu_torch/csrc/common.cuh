// Shared device helpers of the sweep kernels. Every float operation that
// takes part in an accept decision is written with an explicit rounding
// intrinsic (and the sources are built with --fmad=false), so the kernels
// round exactly as the plain PyTorch versions do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define KAO_MAX_R 16  // largest replica-slot count the kernels take
#define KAO_MAX_LANES 64  // most lanes one launch takes

// The model tables of every lane of a launch: lane l's table starts at
// base + l * stride elements, stride 0 where the lanes share one table
// (a portfolio's lanes share every table but their bands and penalty
// scale). The wrappers fill it from a single model (every stride 0) or a
// stacked one. The per-lane scalars are tables too (bands, penalty scale),
// read from device memory like the sweep's keys and temperatures, so one
// launch captured in a CUDA graph serves every model whose tables are
// copied into the same buffers.
struct ModelTabs {
  const int* a0;            // [P, R]
  long long a0_s;
  const int* rf;            // [P]
  long long rf_s;
  const uint8_t* valid;     // [P, R]
  long long valid_s;
  const int* part_rack_hi;  // [P]
  long long part_rack_hi_s;
  const int* w_lead;        // [P, B1]
  long long w_lead_s;
  const int* w_foll;        // [P, B1]
  long long w_foll_s;
  const int* rack_of;       // [B1]
  long long rack_of_s;
  const int* rack_lo;       // [K1]
  long long rack_lo_s;
  const int* rack_hi;       // [K1]
  long long rack_hi_s;
  const int* broker_band;   // [2] (lo, hi)
  long long broker_band_s;
  const int* leader_band;   // [2] (lo, hi)
  long long leader_band_s;
  const float* lam;         // [] penalty scale
  long long lam_s;
};

// lane l's copy of table x of a ModelTabs
#define KAO_LANE(t, x, l) ((t).x + (size_t)(l) * (t).x##_s)

// lane l's sweep key from the device keys [L, 2] (int64 words < 2^32)
__device__ __forceinline__ void lane_key(const long long* keys, int l,
                                         uint32_t& k0, uint32_t& k1) {
  k0 = (uint32_t)keys[2 * l];
  k1 = (uint32_t)keys[2 * l + 1];
}

// integer band-violation magnitude of count c vs [lo, hi]
__device__ __forceinline__ int band_pen(int c, int lo, int hi) {
  return max(c - hi, 0) + max(lo - c, 0);
}

// uint32 bits -> uniform float32 in [0, 1) from the top 24 bits: the
// int -> float conversion is exact, the scale a power of two
__device__ __forceinline__ float u01(uint32_t bits) {
  return __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f);
}

// floor(u * hi) clamped to hi - 1: the float32 product truncated toward
// zero, exactly as the reference's _rand_idx casts it
__device__ __forceinline__ int rand_idx(float u, int hi) {
  return min((int)__fmul_rn(u, (float)hi), hi - 1);
}

// the Metropolis test: delta >= 0, or u < exp(delta / max(temp, 1e-6))
__device__ __forceinline__ bool metropolis(float delta, float u, float temp) {
  return delta >= 0.f || u < expf(__fdiv_rn(delta, fmaxf(temp, 1e-6f)));
}

// max-accumulate a non-negative float into a priority map: the int bit
// patterns of non-negative floats order as the floats do, so an integer
// atomicMax is exact and independent of the order of the updates
__device__ __forceinline__ void map_max(float* map, float v) {
  atomicMax(reinterpret_cast<int*>(map), __float_as_int(v));
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// block-wide sum of v; the result is valid in thread 0
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? scratch[threadIdx.x] : 0;
  if (warp == 0) v = warp_sum(v);
  __syncthreads();
  return v;
}

// four threefry2x32 rounds with rotations r0..r3
__device__ __forceinline__ void tf_rounds(uint32_t& x0, uint32_t& x1, int r0,
                                          int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3) ^ x0;
}

// a jax.random.bits word at flat counter c under key (k0, k1), k2 the key
// schedule's third word: threefry2x32 of (c >> 32, c), outputs xor-ed
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint64_t c) {
  uint32_t x0 = (uint32_t)(c >> 32) + k0;
  uint32_t x1 = (uint32_t)c + k1;
  tf_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  tf_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  tf_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  tf_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  tf_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

// the split cluster barrier: arrive (publishing this thread's shared
// memory writes; all threads of a warp together) and wait (seeing every
// CTA's; each thread on its own)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

#define KAO_THREADS 256
