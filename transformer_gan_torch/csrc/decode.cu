// GAN gumbel straight-through sampler, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of transformer_gan_tpu/ops/pallas_decode.py:
//   * K4, _decode_chunk_kernel (reached through _make_decode_chunk_call /
//     fused_decode_chunk): the n tokens of one sampling chunk in one call;
//   * K5, _decode_kernel (reached through _make_decode_call /
//     fused_decode_step): one token, the staged K/V ring passed in and out.
// Per token: embed -> L decoder layers against the big K/V cache plus the
// staged ring -> logits -> argmax(logits + g) -> the id fed back and its
// one-hot row written out. g is the caller's gumbel noise; the one-hot is the
// forward value of the straight-through gumbel-softmax, whose argmax the
// temperature does not move, so no temperature enters.
//
// The per-token chain, what bounds it (bytes: the K/V cache and the weights
// each token) and the design are in decode_chain.cuh (fp32) and
// decode_chain_tc.cuh (bf16), shared with the generation sampler (K3). The
// TPU kernels align the position term with lane rolls; here positions
// follow the distance rule of the plain decode step
// (big slot j at distance M - j + t, staged slot s at t - s). K5 is K4's
// code for one token at chunk step t0, behind its own entry point.
#include <type_traits>

#include "decode_chain_tc.cuh"

namespace {

// Sampling epilogue of K4 / K5, one block per lane: argmax over v of
// logits[b, v] + g[b, v] (logits in the compute type, the sum in fp32),
// lowest index on ties; writes the id and its one-hot row.
template <typename T>
__global__ void gumbel_onehot_kernel(const T* __restrict__ logits, const float* __restrict__ g,
                                     int* __restrict__ ids, float* __restrict__ onehot,
                                     int V) {
  __shared__ float redv[32];
  __shared__ int redi[32];
  const int b = blockIdx.x;
  pdl_wait();  // bf16: launched with programmatic serialization (decode_chain_tc.cuh)
  pdl_trigger();
  const long long row = static_cast<long long>(b) * V;
  ArgMax best{-INFINITY, V};
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    best = better(best, ArgMax{to_f<T>(logits[row + v]) + g[row + v], v});
  const ArgMax r = block_argmax(best, redv, redi);
  for (int v = threadIdx.x; v < V; v += blockDim.x) onehot[row + v] = v == r.i ? 1.f : 0.f;
  if (threadIdx.x == 0) ids[b] = r.i;
}

int decode_call(const GenArgs* a, void* stream) {
  if (a->HD % a->H != 0 || a->HD / a->H > 32 * kMaxDPL || a->onehot == nullptr ||
      a->t0 < 0 || a->t0 + a->n > a->C || a->n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) -> int {
    using T = decltype(zero);
    const int B = a->B, V = a->V;
    float* onehot = static_cast<float*>(a->onehot);
    auto samp = [&](const T* lg, int i, int) -> int {
      const long long off = static_cast<long long>(i) * B * V;
      if constexpr (!std::is_same<T, float>::value)
        return static_cast<int>(launch_pdl(gumbel_onehot_kernel<T>, dim3(B), 256, 0, st, lg,
                                           a->g + off, a->ids, onehot + off, V));
      gumbel_onehot_kernel<T><<<B, 256, 0, st>>>(lg, a->g + off, a->ids, onehot + off, V);
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

}  // namespace

// K4: tokens 0 .. n-1 of a chunk; the staged ring has n rows.
extern "C" int tg_decode_chunk(const GenArgs* a, void* stream) {
  if (a->t0 != 0 || a->C != a->n) return static_cast<int>(cudaErrorInvalidValue);
  return decode_call(a, stream);
}

// K5: the token at chunk step t0 against a C-row staged ring, in and out.
extern "C" int tg_decode_step(const GenArgs* a, void* stream) {
  if (a->n != 1) return static_cast<int>(cudaErrorInvalidValue);
  return decode_call(a, stream);
}
