// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel here computes in fp32 registers and rounds to the storage
// type T (float or __nv_bfloat16) exactly where the plain PyTorch versions
// round: after each product and on the logits. dtype codes on the C
// interface: 0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define TG_CHECK()                                                      \
  do {                                                                  \
    cudaError_t tg_err_ = cudaGetLastError();                           \
    if (tg_err_ != cudaSuccess) return static_cast<int>(tg_err_);       \
  } while (0)

constexpr unsigned kFullMask = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value to the storage type and back.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Block-wide reductions over blockDim.x (a multiple of 32, at most 1024).
// `red` is shared scratch of at least 32 floats; every thread gets the
// result. The order of the sum is fixed, so results are deterministic.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = -INFINITY;
  for (int w = 0; w < nw; ++w) m = fmaxf(m, red[w]);
  return m;
}

// True = masked. Mirrors pallas_attention._mask_block and
// models/attention.build_attn_mask in the static ring's index space: causal
// edge, invalid left slots (count), same_length band, whole memory of a
// reset row.
__device__ __forceinline__ bool xl_masked(int i, int j, int q, int M, int count,
                                          bool reset_row, int same_length) {
  bool mk = (j > M + i) || (j < M - count);
  if (same_length) {
    const int j_dyn = j - (M - count);
    const int mask_len = count + q - M;
    const int shift = mask_len > 0 ? q - mask_len : q;
    mk = mk || (j_dyn <= i - shift);
  }
  return mk || (reset_row && j < M);
}

// Attention dropout bits: a counter-based hash of (seed, bh, i, j), so the
// forward and backward kernels and both plain versions draw the same mask
// whatever order the blocks run in (ops/attention.dropout_bits is the same
// function on tensors). The multipliers are below 2^31 so the plain version
// computes every product exactly in int64. Keep where bits >= thr,
// thr = rate * 2^32.
__device__ __forceinline__ unsigned int tg_mix(unsigned int x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x346ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ unsigned int drop_row_key(unsigned int seed, int bh, int i) {
  const unsigned int k = tg_mix(tg_mix(seed + 0x9e3779b9u) ^ (static_cast<unsigned int>(bh) + 0x7f4a7c15u));
  return tg_mix(k ^ (static_cast<unsigned int>(i) + 0x6a09e667u));
}

__device__ __forceinline__ bool drop_keep(unsigned int row_key, int j, unsigned int thr) {
  return tg_mix(row_key ^ (static_cast<unsigned int>(j) + 0xbb67ae85u)) >= thr;
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename K>
__host__ inline cudaError_t tg_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
