// Fused chunk sampling for generation, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel transformer_gan_tpu/ops/pallas_generate._gen_kernel
// (reached through _make_gen_call / fused_generate_chunk): n tokens of
// inference sampling, each one embed -> L decoder layers against the big K/V
// cache plus the staged ring -> logits -> logit surgery -> softmax -> top-k
// -> floor -> gumbel argmax -> the token fed back for the next step. The
// per-token chain and what bounds it are in decode_chain.cuh (fp32) and
// decode_chain_tc.cuh (bf16); this file adds the sampling epilogue.
#include <type_traits>

#include "decode_chain_tc.cuh"

namespace {

// Sampling epilogue, one block per lane: surgery, softmax(l / T), top-k in
// probability space (k-th largest counting duplicates, ties kept),
// log(max(p, 1e-38)) + g, argmax with the lowest index winning ties.
// technique: 0 topk, 1 random, 2 gumbel (argmax(l / T + g), no softmax).
template <typename T>
__global__ void sample_kernel(const T* __restrict__ logits, const float* __restrict__ g,
                              int* __restrict__ ids, int* __restrict__ er,
                              int* __restrict__ tok_out, int V, int technique, int topk,
                              float temperature, int exclude_bos, int num_empty,
                              int empty_token) {
  extern __shared__ float smem[];
  float* p = smem;            // [V]
  float* redv = p + V;        // [32]
  int* redi = reinterpret_cast<int*>(redv + 32);  // [32]
  const int b = blockIdx.x;
  pdl_wait();  // bf16: launched with programmatic serialization (decode_chain_tc.cuh)
  pdl_trigger();
  const bool suppress = num_empty > 0 && er[b] >= num_empty;

  float lmax = -INFINITY;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float l = to_f<T>(logits[b * V + v]);
    if (exclude_bos && v == 0) l = kNeg;
    if (suppress && v == empty_token) l = kNeg;
    if (temperature != 0.f) l = l / temperature;
    p[v] = l;
    lmax = fmaxf(lmax, l);
  }
  ArgMax best{-INFINITY, V};
  if (temperature == 0.f) {
    __syncthreads();
    for (int v = threadIdx.x; v < V; v += blockDim.x) best = better(best, ArgMax{p[v], v});
  } else if (technique == 2) {
    __syncthreads();
    for (int v = threadIdx.x; v < V; v += blockDim.x)
      best = better(best, ArgMax{p[v] + g[b * V + v], v});
  } else {
    const float zmax = block_max(lmax, redv);  // syncs: p holds z
    float lsum = 0.f;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      const float e = expf(p[v] - zmax);
      p[v] = e;
      lsum += e;
    }
    const float denom = block_sum(lsum, redv);  // syncs
    for (int v = threadIdx.x; v < V; v += blockDim.x) p[v] = p[v] / denom;
    __syncthreads();
    float kth = 0.f;
    const bool filter = technique == 0 && topk < V;
    if (filter) {
      // The k-th largest counting duplicates is the value whose rank in
      // (value descending, index ascending) order is k - 1.
      float found = -INFINITY;
      for (int v = threadIdx.x; v < V; v += blockDim.x) {
        const float pv = p[v];
        int rank = 0;
        for (int u = 0; u < V; ++u) {
          const float pu = p[u];
          rank += (pu > pv) || (pu == pv && u < v);
        }
        if (rank == topk - 1) found = pv;
      }
      kth = block_max(found, redv);
    }
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      const float pv = filter && p[v] < kth ? 0.f : p[v];
      best = better(best, ArgMax{logf(fmaxf(pv, 1e-38f)) + g[b * V + v], v});
    }
  }
  const ArgMax r = block_argmax(best, redv, redi);
  if (threadIdx.x == 0) {
    tok_out[b] = r.i;
    ids[b] = r.i;
    er[b] = r.i == empty_token ? er[b] + 1 : 0;
  }
}

}  // namespace

extern "C" int tg_generate_chunk(const GenArgs* a, void* stream) {
  if (a->HD % a->H != 0 || a->HD / a->H > 32 * kMaxDPL || a->t0 != 0 || a->C != a->n)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) -> int {
    using T = decltype(zero);
    const int B = a->B, V = a->V;
    const size_t samp_smem = sizeof(float) * (V + 64);
    cudaError_t e = tg_allow_smem(sample_kernel<T>, samp_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    auto samp = [&](const T* lg, int i, int) -> int {
      const float* g = a->g + static_cast<long long>(i) * B * V;
      if constexpr (!std::is_same<T, float>::value)
        return static_cast<int>(launch_pdl(sample_kernel<T>, dim3(B), 256, samp_smem, st,
                                           lg, g, a->ids, a->er, a->tokens + i * B, V,
                                           a->technique, a->topk, a->temperature,
                                           a->exclude_bos, a->num_empty, a->empty_token));
      sample_kernel<T><<<B, 256, samp_smem, st>>>(
          lg, g, a->ids, a->er, a->tokens + i * B, V, a->technique, a->topk, a->temperature,
          a->exclude_bos, a->num_empty, a->empty_token);
      TG_CHECK();
      return 0;
    };
    if constexpr (std::is_same<T, float>::value) return run_chain(*a, st, samp);
    else return run_chain_tc(*a, st, samp);
  };
  if (a->dtype == 0) return run(0.f);
  if (a->dtype == 1) return run(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tg_sizeof_gen_args() { return static_cast<int>(sizeof(GenArgs)); }

// The bf16 chain's layout constants (decode_chain_tc.cuh), for the Python
// side to check its own against: W^T's K and N padding, the key tile, the
// most key splits, the lane group and the most keys of a grouped split.
extern "C" void tg_decode_chain_layout(int* out) {
  out[0] = kKAlign;
  out[1] = kGemvN;
  out[2] = kKeyTile;
  out[3] = kMaxSplits;
  out[4] = kLaneGroup;
  out[5] = kGroupMaxKeys;
}
