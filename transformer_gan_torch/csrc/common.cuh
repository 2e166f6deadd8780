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

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename K>
__host__ inline cudaError_t tg_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
