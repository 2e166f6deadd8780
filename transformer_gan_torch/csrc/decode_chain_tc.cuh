// The bf16 per-token decoder chain for Hopper (sm_90a), shared by the fused
// samplers: generation (K3, generate.cu) and the GAN's gumbel straight-through
// sampler (K4, K5, decode.cu). fp32 keeps run_chain of decode_chain.cuh, the
// exact on-card reference.
//
// Replaces the per-token body of the TPU kernels
// transformer_gan_tpu/ops/pallas_generate._gen_kernel and
// pallas_decode._decode_chunk_kernel / _decode_kernel, which hold the
// weights, the big K/V cache and the staged ring in VMEM and walk a
// sequential (T, L) grid. Here one C entry point per call runs a host loop
// over the tokens and layers on the caller's stream (as run_chain does), and
// each token makes 5 launches a layer (6 with split keys below 8 lanes)
// plus 2:
//   qkv GEMV (embed gather or the last LayerNorm in its prologue; k and v
//   land in the staged ring at row t) -> split-key decode attention
//   [-> split combine] -> o GEMV (residual add in its epilogue) ->
//   FF1 GEMV (LayerNorm in its prologue, bias + ReLU) -> FF2 GEMV (bias +
//   residual add); then the logits GEMV (final LayerNorm in its prologue)
//   and the caller's sampling epilogue.
//
// What bounds it on the H100, and what the design does about it:
// * Decode attention at a long memory and few lanes (K3: B 1, M 4146) is
//   bound by bytes: each token reads every layer's K/V (49.7 MB) and R
//   (24.9 MB), more than the 50 MB L2, so it streams from HBM. One block
//   per (h, b) would leave most SMs idle; the grid is (H, B, S) with S key
//   splits chosen in Python (ops/generate.decode_key_splits) so that the
//   blocks fill about two waves and a split holds at most one 256-key
//   tile. A split's K, V and R rows are flat runs of 100-byte rows in the
//   h-major cache, ring and R copy, so a block copies them into shared
//   memory by 16-byte cp.async, every load in flight at once; it scores one
//   key a thread with q in shared memory (no shuffle tree per key) and
//   keeps its own softmax (m, l, unnormalised P V); a combine kernel merges
//   the splits in split order (the algebra of K1f / K2f's combine), no
//   atomics. 128 threads a block fit the GAN's 640 (h, b) blocks in one wave.
// * Decode attention over many lanes (K3 in the metrics eval: B 32, M 2048;
//   the CLI at B 8) is bound by the K/V bytes each token streams (at B 32
//   and a full ring, 133 MB a layer, 2.6x the L2). A block a (h, b) would
//   copy R's rows again for every lane, load everything and then compute,
//   with its SM idle on one or the other, and merge in a launch of its own.
//   Where the keys are split, B >= 8 and the grouped grid has a block for
//   each SM (ops/generate.decode_route), grouped_split_attn_kernel takes
//   (h, 8 lanes, split): R's rows are
//   copied once for the group; a ring of 3 cp.async stages of 32-key tiles
//   keeps two tiles (~58 KB) a block in flight while the third is scored or
//   summed; the splits (ops/generate.grouped_key_splits) are as many as
//   two blocks a multiprocessor hold, so the grid is one wave; the last
//   block of a group to arrive (an int count, reset by that block) merges
//   the group's splits, so no combine launch. 32 launches a token at L 6 on
//   this route. What bounds it now: at a full ring the K/V stream runs near
//   HBM rate (~2.6 TB/s on the added bytes), and a layer's attention has a
//   fixed cost of ~11 us (the chain after pdl_wait: q's loads, a tile's
//   scoring and P V behind block barriers, the parts' writes, the fence and
//   the arrival count, the merge) that dominates the short rings of a
//   call's first chunks; then the GEMV chain.
// * The GEMVs at the GAN's B 64 are bound by operations and at B 1 by
//   bytes (24 MB of weights a token). The old GEMV read every weight once
//   per lane; here a block owns 8 output columns for up to 64 lanes and
//   reads W once with 16-byte loads from a transposed, K-padded copy
//   (ops/decode_params.stack_decode_params: W^T [npad(N), kpad(K)]), the
//   lanes' input rows in shared memory (cp.async), mma.sync m16n8k16 with
//   fp32 accumulators (lanes are the M side, padded to 16), the warps
//   splitting K and adding their partials in a fixed order. N / 8 column
//   blocks (63 to 188 at HD 500) fill the card at B 1 without a second pass.
// * Launches: LayerNorms and residual adds ride in the GEMVs' prologues and
//   epilogues and q, k, v share one launch: 32 a token at L 6, 38 with split
//   keys on split_attn_kernel (57 before). Each block recomputes the LayerNorm statistics of its
//   lanes' 500-long rows in fp32, the cost of folding it in: at B 64 that
//   is the GEMVs' largest part, so wide lane tiles take 16 warps.
// * Each launch's fixed cost: every kernel is launched with programmatic
//   dependent launch (pdl_wait below), so it is resident and has its
//   weights, LayerNorm parameters and big-cache rows in flight while the
//   kernel before it finishes.
//
// The GEMV kernel takes its prologue and epilogue from a policy (GemvIo
// here); the bf16 reverse chain (chain_bwd_tc.cu, K6 / K7) runs the same
// kernel with its own (fp32 row ops in, fp32 or bf16 products out).
//
// Rounding follows the plain versions (ops/generate.py, ops/decode.py with
// `splits`): fp32 accumulation, rounded to bf16 after each product, on the
// residual sums and on the logits; LayerNorm in fp32, its output rounded;
// per split p = exp(s - m_s) rounded to bf16 before P V, l_s unrounded,
// ctx = rnd(sum_s w_s o_s / l).
#pragma once

#include <stdint.h>

#include "attention_tc.cuh"
#include "decode_chain.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;   // GEMVs at B <= 32, the split combine
constexpr int kLaneTile = 64;     // lanes a GEMV block takes (4 m-tiles)
constexpr int kSplitThreads = 128;  // decode attention: 4 warps
// The layout that the Python side builds its operands and picks its splits
// by (ops/decode_params.py K_ALIGN, N_ALIGN; ops/generate.py KEY_TILE,
// MAX_DECODE_SPLITS): tg_decode_chain_layout reports these four and every
// bf16 chain call checks them (ops/generate.chain_lib).
constexpr int kKAlign = 32;       // W^T rows padded to a multiple: a k-step of two MMAs
constexpr int kGemvN = 8;         // output columns a GEMV block takes; W^T rows padded to it
constexpr int kKeyTile = 256;     // keys a decode-attention tile holds
constexpr int kMaxSplits = 64;    // key splits the combine takes
// The lane-grouped decode attention (grouped_split_attn_kernel); the Python
// side routes and splits by the first and the last (ops/generate.py
// LANE_GROUP, GROUP_MAX_KEYS), and tg_decode_chain_layout reports them too.
constexpr int kLaneGroup = 8;       // lanes a block takes, a warp each
constexpr int kGroupTile = 32;      // keys a stage holds, a thread each
constexpr int kGroupStages = 3;     // stages of the shared-memory ring
constexpr int kGroupMaxKeys = 512;  // keys of a split, whose scores stay in shared memory

__host__ __device__ inline int kpad(int K) { return (K + kKAlign - 1) / kKAlign * kKAlign; }
__host__ __device__ inline int npad(int N) { return (N + kGemvN - 1) / kGemvN * kGemvN; }

// Where a GEMV's input rows come from. Rows of lanes b0 .. b0 + nb - 1.
struct GemvIn {
  const bf16* src;       // [B, K] rows at src_stride, or null: gather emb[ids[b]]
  long long src_stride;
  const int* ids;
  const bf16* emb;       // [V, K]
  const float* ln_s;     // LayerNorm of each row (K long), or null
  const float* ln_b;
  bf16* keep;            // column block 0 writes each row, LN'd when keep_ln
  int keep_ln;
};

// What a GEMV does with its products: y = rnd(acc); + bias, rounded;
// ReLU; + residual, rounded; column n goes to part p = n / part_n of up to
// three outputs, at out[p] + (c / seg) * seg_stride + b * out_stride + c % seg
// (c = n - p * part_n): seg = part_n is a plain row, seg = d_head scatters
// the heads into an h-major [H, B, ., d_head] buffer (the staged ring).
struct GemvOut {
  const bf16* bias;
  int relu;
  const bf16* res;
  long long res_stride;
  int part_n;
  bf16* out[3];
  long long out_stride[3];
  int seg[3];
  long long seg_stride[3];
};

__device__ __forceinline__ float2 bf2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(tc::smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(tc::smem_addr(dst)),
               "l"(src));
}

// Programmatic dependent launch (sm_90): every chain kernel is launched
// with programmatic stream serialization, so it can start while the kernel
// before it finishes. Before pdl_wait() a kernel touches only what no
// earlier kernel of the call writes (weights, LayerNorm parameters, the big
// K/V cache, R, its own shared memory); pdl_wait() returns once the kernel
// before it has completed and its writes are visible; pdl_trigger() after
// that lets the next kernel start its own preamble.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

constexpr int kLnRows = 4;  // rows a warp normalizes together (independent chains)

// Rows of the lane tile into xs (bf16, row stride ks): copied or gathered
// with cp.async (every load of the tile in flight at once), then the
// LayerNorm in fp32: a warp takes kLnRows rows at once, their sums
// interleaved (scale and bias already in lnw [2][K]); zero padding past K
// and past nb. Every block normalizes every lane row it multiplies, so the
// statistics take one pass.
__device__ void gemv_prologue(const GemvIn& in, bf16* xs, int ks, int b0, int nb, int K,
                              const float* lnw, int warps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto row_of = [&](int r) -> const bf16* {
    const int b = b0 + r;
    return in.src != nullptr ? in.src + b * in.src_stride
                             : in.emb + static_cast<long long>(in.ids[b]) * K;
  };
  const bf16* base = in.src != nullptr ? in.src : in.emb;
  const bool v8 = K % 4 == 0 && (in.src == nullptr || in.src_stride % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(base) & 7) == 0;
  for (int r = warp; r < nb; r += warps) {
    const bf16* row = row_of(r);
    if (v8)
      for (int u = lane; u < K / 4; u += 32) cp_async8(xs + r * ks + 4 * u, row + 4 * u);
    else
      for (int u = lane; u < K / 2; u += 32)
        tc::cp_async4(xs + r * ks + 2 * u, row + 2 * u, true);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  const int wpr = K / 2;  // bf16 pairs a row (K even)
  const int ks2 = ks / 2;
  uint32_t* x2 = reinterpret_cast<uint32_t*>(xs);
  const bool write_keep = in.keep != nullptr && blockIdx.x == 0;
  auto keep_rows = [&](int r) {
    uint32_t* keep = reinterpret_cast<uint32_t*>(in.keep + static_cast<long long>(b0 + r) * K);
    for (int w = lane; w < wpr; w += 32) keep[w] = x2[r * ks2 + w];
  };
  if (write_keep && !in.keep_ln)
    for (int r = warp; r < nb; r += warps) keep_rows(r);
  if (in.ln_s != nullptr) {
    const float2* sc2 = reinterpret_cast<const float2*>(lnw);
    const float2* bi2 = reinterpret_cast<const float2*>(lnw + K);
    for (int r0 = warp * kLnRows; r0 < nb; r0 += warps * kLnRows) {
      const int nr = min(kLnRows, nb - r0);
      // one pass over the row, shifted by its first element x0 (the sums of
      // d = x - x0 and d^2 keep the variance well conditioned):
      // mean = x0 + sum d / K, var = sum d^2 / K - (sum d / K)^2
      float x0[kLnRows], mean[kLnRows], inv[kLnRows];
#pragma unroll
      for (int q = 0; q < kLnRows; ++q) {
        x0[q] = q < nr ? bf2(x2[(r0 + q) * ks2]).x : 0.f;
        mean[q] = 0.f;
        inv[q] = 0.f;
      }
      for (int w = lane; w < wpr; w += 32)
#pragma unroll
        for (int q = 0; q < kLnRows; ++q)
          if (q < nr) {
            const float2 v = bf2(x2[(r0 + q) * ks2 + w]);
            const float dx = v.x - x0[q], dy = v.y - x0[q];
            mean[q] += dx + dy;
            inv[q] += dx * dx + dy * dy;
          }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < kLnRows; ++q) {
          mean[q] += __shfl_xor_sync(kFullMask, mean[q], o);
          inv[q] += __shfl_xor_sync(kFullMask, inv[q], o);
        }
      const float rk = 1.f / K;
#pragma unroll
      for (int q = 0; q < kLnRows; ++q) {
        const float d = mean[q] * rk;
        mean[q] = x0[q] + d;
        inv[q] = rsqrtf(fmaxf(inv[q] * rk - d * d, 0.f) + 1e-5f);
      }
      for (int w = lane; w < wpr; w += 32) {
        const float2 sc = sc2[w], bi = bi2[w];
#pragma unroll
        for (int q = 0; q < kLnRows; ++q)
          if (q < nr) {
            uint32_t* p = x2 + (r0 + q) * ks2 + w;
            const float2 v = bf2(*p);
            *p = tc::pack_bf16((v.x - mean[q]) * inv[q] * sc.x + bi.x,
                               (v.y - mean[q]) * inv[q] * sc.y + bi.y);
          }
      }
    }
    __syncwarp();
  }
  if (write_keep && in.keep_ln) {
    __syncthreads();  // rows normalized by other warps
    for (int r = warp; r < nb; r += warps) keep_rows(r);
  }
}

// The forward chain's GEMV policy (K3, K4, K5): input rows by gemv_prologue,
// products stored by GemvOut. tc_gemv_kernel takes its prologue and
// epilogue from a policy like this one; the reverse chain (chain_bwd_tc.cu)
// brings its own.
struct GemvIo {
  using In = GemvIn;
  using Out = GemvOut;
  // the input's LayerNorm parameters, loaded before the wait (by value: a
  // reference to the kernel's parameter moves the forward kernels' preamble)
  __device__ static __forceinline__ const float* ln_s(const GemvIn& in) { return in.ln_s; }
  __device__ static __forceinline__ const float* ln_b(const GemvIn& in) { return in.ln_b; }
  __device__ static __forceinline__ void prologue(const GemvIn& in, bf16* xs, int ks, int b0,
                                                  int nb, int K, const float* lnw, int warps) {
    gemv_prologue(in, xs, ks, b0, nb, K, lnw, warps);
  }
  // the product s of lane b and column n
  __device__ static __forceinline__ void store(const GemvOut& out, int b, int n, int, float s) {
    float y = rnd<bf16>(s);
    if (out.bias != nullptr) y = rnd<bf16>(y + __bfloat162float(out.bias[n]));
    if (out.relu) y = fmaxf(y, 0.f);
    if (out.res != nullptr) y = rnd<bf16>(__bfloat162float(out.res[b * out.res_stride + n]) + y);
    // constant indices keep the parameter arrays out of local memory; a
    // division only where a part scatters heads
    const int p = n < out.part_n ? 0 : (n < 2 * out.part_n ? 1 : 2);
    const int cn = n - p * out.part_n;
    bf16* dst = p == 0 ? out.out[0] : (p == 1 ? out.out[1] : out.out[2]);
    const long long ostr =
        p == 0 ? out.out_stride[0] : (p == 1 ? out.out_stride[1] : out.out_stride[2]);
    const int seg = p == 0 ? out.seg[0] : (p == 1 ? out.seg[1] : out.seg[2]);
    long long idx = b * ostr + cn;
    if (seg != out.part_n) {
      const long long sstr =
          p == 0 ? out.seg_stride[0] : (p == 1 ? out.seg_stride[1] : out.seg_stride[2]);
      const int hh = cn / seg;
      idx += hh * (sstr - seg);
    }
    dst[idx] = __float2bfloat16_rn(y);
  }
};

// out[b, n] for the 8 columns n0 .. n0+7 of block x and the lanes of block y:
// the lanes' rows [MT*16, K] (shared) times W^T rows n0 .. n0+7 [8, kpad(K)].
// Each of the WARPS warps takes every WARPS-th k-step of 32; a thread loads
// 16 bytes of W^T (8 consecutive k of one column) and of two lane rows and
// feeds two MMAs, the 16 k of each MMA permuted alike on both sides
// (slot 2t+j <- k 8t+j, slot 2t+8+j <- k 8t+2+j; then +4), which leaves the
// product unchanged. The warps add their partials in warp order. Wide lane
// tiles take 16 warps, so that a warp normalizes 4 of the 64 lane rows.
template <int MT, int WARPS, class Io = GemvIo>
__global__ void __launch_bounds__(WARPS * 32)
tc_gemv_kernel(typename Io::In in, const bf16* __restrict__ Wt, int K, int N,
               typename Io::Out out, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int rows = MT * 16;
  const int Kp = kpad(K), ks = Kp + 32;  // +64 bytes: the two rows of a phase on other banks
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  float* red = reinterpret_cast<float*>(xs + rows * ks);  // [WARPS][MT * 128]
  float* lnw = red + WARPS * MT * 128;                     // [2][K]
  const int b0 = blockIdx.y * kLaneTile;
  const int nb = min(kLaneTile, B - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * kGemvN;

  // before the wait: W (the first kAhead k-steps of the warp), the
  // LayerNorm parameters, the zero padding
  const bf16* wrow = Wt + static_cast<long long>(n0 + g) * Kp + 8 * c;
  const int nks = Kp / 32;
  constexpr int kAhead = 4;  // k-steps of W in flight a warp
  uint4 wv[kAhead];
  auto load_w = [&](int base) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int kk = base + j * WARPS;
      if (kk < nks) wv[j] = __ldg(reinterpret_cast<const uint4*>(wrow + kk * 32));
    }
  };
  load_w(warp);
  if (Io::ln_s(in) != nullptr)
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      tc::cp_async4(lnw + k, Io::ln_s(in) + k, true);
      tc::cp_async4(lnw + K + k, Io::ln_b(in) + k, true);
    }
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int r = warp; r < rows; r += WARPS)
    for (int k = (r < nb ? K : 0) + lane; k < Kp; k += 32) xs[r * ks + k] = zero;

  pdl_wait();
  pdl_trigger();
  Io::prologue(in, xs, ks, b0, nb, K, lnw, WARPS);
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j] = 0.f;
  for (int base = warp; base < nks; base += WARPS * kAhead) {
    if (base != warp) load_w(base);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int kk = base + j * WARPS;
      if (kk < nks) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* ar = xs + (mt * 16 + g) * ks + kk * 32 + 8 * c;
          const uint4 lo = *reinterpret_cast<const uint4*>(ar);
          const uint4 hi = *reinterpret_cast<const uint4*>(ar + 8 * ks);
          const uint32_t a1[4] = {lo.x, hi.x, lo.y, hi.y};
          tc::mma(acc[mt], a1, wv[j].x, wv[j].y);
          const uint32_t a2[4] = {lo.z, hi.z, lo.w, hi.w};
          tc::mma(acc[mt], a2, wv[j].z, wv[j].w);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(warp * MT + mt) * 128 + lane * 4 + j] = acc[mt][j];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * 128; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w * MT * 128 + e];
    // C fragment: c[j] = (row g + 8 (j >= 2), column 2t + (j & 1))
    const int mt = e >> 7, ln = (e >> 2) & 31, j = e & 3;
    const int r = mt * 16 + (ln >> 2) + (j >= 2 ? 8 : 0);
    const int n = n0 + 2 * (ln & 3) + (j & 1);
    if (r >= nb || n >= N) continue;
    Io::store(out, b0 + r, n, N, s);
  }
}

// Launch a chain kernel with programmatic stream serialization (see
// pdl_wait). Returns the launch's error.
template <typename... KArgs, typename... Args>
__host__ cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                                cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

__host__ inline size_t gemv_smem(int MT, int warps, int K) {
  return sizeof(bf16) * MT * 16 * (kpad(K) + 32) + sizeof(float) * (warps * MT * 128 + 2 * K);
}

// nbytes (a multiple of 4) from device memory to shared memory by cp.async:
// 16 bytes at a time where dst and src agree modulo 16, else 4.
__device__ __forceinline__ void flat_copy(unsigned char* dst, const unsigned char* src,
                                          int nbytes) {
  int head = nbytes, body = 0;
  if (((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    head = min(nbytes, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15));
    body = (nbytes - head) & ~15;
  }
  for (int i = threadIdx.x * 4; i < head; i += blockDim.x * 4)
    tc::cp_async4(dst + i, src + i, true);
  for (int i = head + threadIdx.x * 16; i < head + body; i += blockDim.x * 16)
    cp_async16(dst + i, src + i);
  for (int i = head + body + threadIdx.x * 4; i < nbytes; i += blockDim.x * 4)
    tc::cp_async4(dst + i, src + i, true);
}

// One token's attention for layer l, block (h, b, s): keys lo .. lo + n - 1
// of the token's n_keys = n_big + t + 1 (big slots jlo .. M-1, then staged
// slots 0 .. t), split s of S as torch.tensor_split cuts them. Key kk sits
// at distance M - jlo - kk + t, R row jlo + kk - t of the h-major copy
// Rh [H, M + 1, dh] (row r = distance M - r). A tile of up to tile_keys keys
// is three flat runs of 100-byte rows in device memory (K and V: the big
// cache's, then the ring's; R: one run), copied by 16-byte cp.async into
// shared tiles offset to the source's alignment, every load in flight at
// once (S is chosen so that a split is one tile at the op-points). Writes
// the split's unnormalised sum of rnd(p) v, m_s and l_s (opart, ml), or
// with S == 1 the normalised context row (ctx).
__global__ void __launch_bounds__(kSplitThreads)
split_attn_kernel(const bf16* __restrict__ qb, const bf16* __restrict__ Kb,
                  const bf16* __restrict__ Vb, const bf16* __restrict__ sk,
                  const bf16* __restrict__ sv, const bf16* __restrict__ Rh,
                  const bf16* __restrict__ rwb, const bf16* __restrict__ rrb,
                  float* __restrict__ opart, float* __restrict__ ml, bf16* __restrict__ ctx,
                  int M, int C, int HD, int dh, int t, int count, int sl, float scale,
                  int tile_keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int B = gridDim.y, S = gridDim.z, H = gridDim.x;
  const long long hb = static_cast<long long>(h) * B + b;
  const int tid = threadIdx.x;
  const int dw = dh / 2;              // bf16 pairs a row: odd dw reads without conflicts
  const int nrg = kSplitThreads / dw;  // rows a PV step takes (dw <= 32: >= 4)
  const int rg = tid / dw, w = tid - rg * dw;
  const int row_bytes = dh * 2;

  const int jlo = min(M, max(M - count, t + sl));
  const int n_big = M - jlo;
  const int n_keys = n_big + t + 1;
  const int base = n_keys / S, rem = n_keys % S;
  const int lo = split * base + min(split, rem);
  const int n = base + (split < rem ? 1 : 0);
  const bool one_tile = n <= tile_keys;

  const int buf_bytes = (tile_keys * row_bytes + 16 + 15) & ~15;
  float4* qq = reinterpret_cast<float4*>(smem_raw);                  // [dw]
  unsigned char* kbuf = smem_raw + sizeof(float4) * 32;
  unsigned char* rbuf = kbuf + buf_bytes;
  unsigned char* vbuf = rbuf + buf_bytes;
  float* part = reinterpret_cast<float*>(vbuf + buf_bytes);           // [nrg][dh]
  float* red = part + nrg * dh;                                       // [32]
  float* sc = red + 32;                                               // [n]

  const int hoff = h * dh;
  // keys t0 .. t0 + nt - 1 of the split from the big cache (part 0) or the
  // ring (part 1), K or V, into buf; returns the tile (buf offset to the
  // source's alignment)
  auto copy_kv = [&](unsigned char* buf, const bf16* big, const bf16* staged, int t0, int nt,
                     int part) -> const uint32_t* {
    const int k0 = lo + t0;
    const int nb1 = max(0, min(nt, n_big - k0));
    const unsigned char* s1 =
        reinterpret_cast<const unsigned char*>(big + (hb * M + jlo + k0) * dh);
    const unsigned char* s2 = reinterpret_cast<const unsigned char*>(
        staged + (hb * C + max(0, k0 - n_big)) * dh);
    unsigned char* tile = buf + (reinterpret_cast<uintptr_t>(nb1 > 0 ? s1 : s2) & 15);
    if (part == 0 && nb1 > 0) flat_copy(tile, s1, nb1 * row_bytes);
    if (part == 1 && nt > nb1) flat_copy(tile + nb1 * row_bytes, s2, (nt - nb1) * row_bytes);
    return reinterpret_cast<const uint32_t*>(tile);
  };
  auto copy_r = [&](int t0, int nt) -> const uint32_t* {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        Rh + (static_cast<long long>(h) * (M + 1) + jlo + lo + t0 - t) * dh);
    unsigned char* tile = rbuf + (reinterpret_cast<uintptr_t>(src) & 15);
    flat_copy(tile, src, nt * row_bytes);
    return reinterpret_cast<const uint32_t*>(tile);
  };

  // before the wait: the big cache's rows and R (one tile), which no
  // kernel of the call writes; groups: K big + R, V big, then after the
  // wait K staged, V staged
  const uint32_t *kt = nullptr, *rt = nullptr, *vt = nullptr;
  if (one_tile) {
    kt = copy_kv(kbuf, Kb, sk, 0, n, 0);
    rt = copy_r(0, n);
    tc::cp_async_commit();
    vt = copy_kv(vbuf, Vb, sv, 0, n, 0);
    tc::cp_async_commit();
  }
  pdl_wait();
  pdl_trigger();
  if (one_tile) {  // the ring's rows, then q; V is waited for after the softmax
    copy_kv(kbuf, Kb, sk, 0, n, 1);
    tc::cp_async_commit();
    copy_kv(vbuf, Vb, sv, 0, n, 1);
    tc::cp_async_commit();
  }
  if (tid < dw) {
    const float2 qv = bf2(reinterpret_cast<const uint32_t*>(qb + b * HD + hoff)[tid]);
    const float2 wb = bf2(reinterpret_cast<const uint32_t*>(rwb + hoff)[tid]);
    const float2 rb = bf2(reinterpret_cast<const uint32_t*>(rrb + hoff)[tid]);
    qq[tid] = make_float4(rnd<bf16>(qv.x + wb.x), rnd<bf16>(qv.y + wb.y),
                          rnd<bf16>(qv.x + rb.x), rnd<bf16>(qv.y + rb.y));
  }

  float lmax = -INFINITY;
  for (int t0 = 0; t0 < n; t0 += tile_keys) {
    const int nt = min(tile_keys, n - t0);
    if (one_tile) {
      tc::cp_async_wait<1>();
    } else {
      __syncthreads();  // the previous tile's scores are taken
      kt = copy_kv(kbuf, Kb, sk, t0, nt, 0);
      copy_kv(kbuf, Kb, sk, t0, nt, 1);
      rt = copy_r(t0, nt);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // the tile and qq are in shared memory
    for (int r = tid; r < nt; r += kSplitThreads) {
      float ac = 0.f, bd = 0.f;
      for (int i = 0; i < dw; ++i) {
        const float4 q4 = qq[i];
        const float2 kv = bf2(kt[r * dw + i]);
        const float2 rv = bf2(rt[r * dw + i]);
        ac += q4.x * kv.x + q4.y * kv.y;
        bd += q4.z * rv.x + q4.w * rv.y;
      }
      const float s = rnd<bf16>(rnd<bf16>(ac) + rnd<bf16>(bd)) * scale;
      sc[t0 + r] = s;
      lmax = fmaxf(lmax, s);
    }
  }
  const float m = block_max(lmax, red);  // syncs: sc is complete
  float lsum = 0.f;
  for (int i = tid; i < n; i += kSplitThreads) {
    const float e = expf(sc[i] - m);
    sc[i] = e;
    lsum += e;
  }
  const float l = block_sum(lsum, red);  // syncs

  float2 acc = make_float2(0.f, 0.f);
  for (int t0 = 0; t0 < n; t0 += tile_keys) {
    const int nt = min(tile_keys, n - t0);
    if (!one_tile) {
      __syncthreads();  // the previous V tile is taken
      vt = copy_kv(vbuf, Vb, sv, t0, nt, 0);
      copy_kv(vbuf, Vb, sv, t0, nt, 1);
      tc::cp_async_commit();
    }
    tc::cp_async_wait<0>();
    __syncthreads();
    if (rg < nrg)
      for (int r = rg; r < nt; r += nrg) {
        const float p = rnd<bf16>(sc[t0 + r]);
        const float2 v = bf2(vt[r * dw + w]);
        acc.x += p * v.x;
        acc.y += p * v.y;
      }
  }
  if (rg < nrg) {
    part[rg * dh + 2 * w] = acc.x;
    part[rg * dh + 2 * w + 1] = acc.y;
  }
  __syncthreads();
  for (int d = tid; d < dh; d += kSplitThreads) {
    float o = 0.f;
    for (int g = 0; g < nrg; ++g) o += part[g * dh + d];
    if (S == 1) {
      ctx[b * HD + hoff + d] = __float2bfloat16_rn(o * (1.f / l));
    } else {
      opart[(static_cast<long long>(split) * B + b) * HD + hoff + d] = o;
    }
  }
  if (S > 1 && tid == 0) {
    float* p = ml + ((static_cast<long long>(split) * B + b) * H + h) * 2;
    p[0] = m;  // -inf for an empty split
    p[1] = l;
  }
}

__host__ inline size_t split_attn_smem(int dh, int tile_keys, int max_keys) {
  const int nrg = kSplitThreads / (dh / 2);
  const int buf_bytes = (tile_keys * dh * 2 + 16 + 15) & ~15;
  return sizeof(float4) * 32 + 3 * static_cast<size_t>(buf_bytes) +
         sizeof(float) * (nrg * dh + 32 + max_keys);
}

// Merge the key splits of one (h, b), block (h, b), in split order of the
// weights: m = max m_s, w_s = exp(m_s - m) (0 for an empty split),
// l = sum w_s l_s, ctx = rnd(sum_s w_s o_s * (1 / l)) (combine_splits_plain;
// K1f / K2f's combine). A warp takes the weights; the sum over splits runs
// in kTcThreads / dh interleaved groups added in group order.
__global__ void __launch_bounds__(kTcThreads)
split_combine_kernel(const float* __restrict__ opart, const float* __restrict__ ml,
                     bf16* __restrict__ ctx, int S, int HD, int dh) {
  __shared__ float wts[kMaxSplits];
  __shared__ float part[kTcThreads];
  __shared__ float inv_l;
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, B = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31;
  auto mls = [&](int s) { return ml + ((static_cast<long long>(s) * B + b) * H + h) * 2; };
  pdl_wait();
  pdl_trigger();
  if (tid < 32) {
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, mls(s)[0]);
    m = warp_max(m);
    float l = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float ms = mls(s)[0];
      const float w = ms == -INFINITY ? 0.f : expf(ms - m);
      wts[s] = w;
      l += w * mls(s)[1];
    }
    l = warp_sum(l);
    if (lane == 0) inv_l = 1.f / l;
  }
  __syncthreads();
  const int ng = kTcThreads / dh, sg = tid / dh, d = tid - sg * dh;
  if (sg < ng) {
    float o = 0.f;
    for (int s = sg; s < S; s += ng)
      o += wts[s] * opart[(static_cast<long long>(s) * B + b) * HD + h * dh + d];
    part[sg * dh + d] = o;
  }
  __syncthreads();
  if (tid < dh) {
    float o = 0.f;
    for (int g = 0; g < ng; ++g) o += part[g * dh + tid];
    ctx[b * HD + h * dh + tid] = __float2bfloat16_rn(o * inv_l);
  }
}

// nbytes (a multiple of 4) from device memory to shared memory by cp.async,
// dst and src equal modulo 16: 16 bytes at a time, 4 at the two ends. The
// threads first, first + step, ... share the copy.
__device__ __forceinline__ void rows_copy(unsigned char* dst, const unsigned char* src,
                                          int nbytes, int first, int step) {
  const int head =
      min(nbytes, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15));
  const int body = (nbytes - head) & ~15;
  for (int i = first * 4; i < head; i += step * 4) tc::cp_async4(dst + i, src + i, true);
  for (int i = head + first * 16; i < head + body; i += step * 16) cp_async16(dst + i, src + i);
  for (int i = head + body + first * 4; i < nbytes; i += step * 4)
    tc::cp_async4(dst + i, src + i, true);
}

// Bytes of a stage's buffer for kGroupTile rows of dh: the big cache's rows
// at their source's offset modulo 16, then the ring's at theirs, so that
// both copy 16 bytes at a time (at most 39 bytes of offsets).
__host__ __device__ inline int group_tile_bytes(int dh) {
  return (kGroupTile * dh * 2 + 39 + 15) & ~15;
}

__host__ inline size_t grouped_attn_smem(int dh, int sc_stride) {
  return sizeof(float4) * kLaneGroup * 32 +
         static_cast<size_t>(kGroupStages) * (kLaneGroup + 1) * group_tile_bytes(dh) +
         sizeof(float) * (static_cast<size_t>(kLaneGroup) * sc_stride + 4);
}

// One lane's rows of a stage: keys k .. k + nt - 1 of the token (big slots
// jlo .. M-1, then ring slots 0 .. t), nb1 of them from the big cache (s1),
// the rest from the ring (s2), landing in the stage buffer at p1 and p2.
struct GroupRows {
  const unsigned char* s1;
  const unsigned char* s2;
  unsigned char* p1;
  unsigned char* p2;
  int nb1;
};

__device__ __forceinline__ GroupRows group_rows(unsigned char* buf, const bf16* big,
                                                const bf16* staged, long long hb, int M, int C,
                                                int jlo, int n_big, int k, int nt, int dh) {
  GroupRows r;
  r.nb1 = max(0, min(nt, n_big - k));
  r.s1 = reinterpret_cast<const unsigned char*>(big + (hb * M + jlo + k) * dh);
  r.s2 = reinterpret_cast<const unsigned char*>(staged + (hb * C + max(0, k - n_big)) * dh);
  const int o1 = r.nb1 > 0 ? static_cast<int>(reinterpret_cast<uintptr_t>(r.s1) & 15) : 0;
  r.p1 = buf + o1;
  r.p2 = buf + ((o1 + r.nb1 * dh * 2 + 15) & ~15) + (reinterpret_cast<uintptr_t>(r.s2) & 15);
  return r;
}

// One token's attention for layer l over a group of lanes, block (h, group,
// split): the keys of split s of S as split_attn_kernel cuts them, for lanes
// b0 .. b0 + ng - 1 (ng <= kLaneGroup), warp g taking lane b0 + g. The split
// streams through a ring of kGroupStages shared-memory stages of kGroupTile
// keys, kGroupStages - 1 of them in flight while one is used: first its key
// tiles (R's rows, copied once for the group, and each lane's K rows), then
// its value tiles (each lane's V rows). A thread scores one key of its
// warp's lane (q in shared memory); the split's scores stay in shared
// memory, so the softmax is the warp's own: m_s, p = rnd(exp(s - m_s)),
// l_s unrounded; lanes 0 .. dh/2 - 1 then sum rnd(p) v on two columns each.
// Each block writes its unnormalised sum, m_s and l_s (opart, ml) and counts
// itself in arrive[h, group]; the last of the S blocks merges the group's
// splits in split order (split_combine_kernel's algebra), writes ctx and
// sets the count back to 0 for the next launch.
__global__ void __launch_bounds__(kLaneGroup * 32, 2)
grouped_split_attn_kernel(const bf16* __restrict__ qb, const bf16* __restrict__ Kb,
                          const bf16* __restrict__ Vb, const bf16* __restrict__ sk,
                          const bf16* __restrict__ sv, const bf16* __restrict__ Rh,
                          const bf16* __restrict__ rwb, const bf16* __restrict__ rrb,
                          float* __restrict__ opart, float* __restrict__ ml,
                          int* __restrict__ arrive, bf16* __restrict__ ctx, int B, int M, int C,
                          int HD, int dh, int t, int count, int sl, float scale,
                          int sc_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kThreads = kLaneGroup * 32;
  constexpr int kAhead = kGroupStages - 1;
  const int h = blockIdx.x, grp = blockIdx.y, split = blockIdx.z;
  const int H = gridDim.x, S = gridDim.z;
  const int tid = threadIdx.x, g = tid >> 5, lane = tid & 31;
  const int b0 = grp * kLaneGroup, b = b0 + g;
  const bool active = b < B;
  const long long hb = static_cast<long long>(h) * B + b;
  const int dw = dh / 2, row_bytes = dh * 2;
  const int tile_bytes = group_tile_bytes(dh);
  const int stage_bytes = (kLaneGroup + 1) * tile_bytes;

  const int jlo = min(M, max(M - count, t + sl));
  const int n_big = M - jlo;
  const int n_keys = n_big + t + 1;
  const int base = n_keys / S, rem = n_keys % S;
  const int lo = split * base + min(split, rem);
  const int n = base + (split < rem ? 1 : 0);
  const int nkt = (n + kGroupTile - 1) / kGroupTile;
  const int items = 2 * nkt;  // the key tiles, then the value tiles

  float4* qq = reinterpret_cast<float4*>(smem_raw);  // [kLaneGroup][32]
  unsigned char* stages = smem_raw + sizeof(float4) * kLaneGroup * 32;
  float* sc = reinterpret_cast<float*>(stages + kGroupStages * stage_bytes);
  int* last = reinterpret_cast<int*>(sc + kLaneGroup * sc_stride);
  float* scg = sc + g * sc_stride;  // [sc_stride]: the lane's scores, then rnd(p)
  const float4* qg = qq + g * 32;

  const bf16* rsplit = Rh + (static_cast<long long>(h) * (M + 1) + jlo + lo - t) * dh;
  auto stage = [&](int i) { return stages + (i % kGroupStages) * stage_bytes; };
  auto first_key = [&](int i) { return (i < nkt ? i : i - nkt) * kGroupTile; };
  auto r_src = [&](int k0) {
    return reinterpret_cast<const unsigned char*>(rsplit + static_cast<long long>(k0) * dh);
  };
  auto lane_rows = [&](int i) {
    const int k0 = first_key(i);
    return group_rows(stage(i) + g * tile_bytes, i < nkt ? Kb : Vb, i < nkt ? sk : sv, hb, M,
                      C, jlo, n_big, lo + k0, min(kGroupTile, n - k0), dh);
  };
  // item i's copies: part 0 the big cache's rows and R's, which no kernel of
  // the call writes; part 1 the ring's, whose row t the qkv GEMV writes
  auto issue = [&](int i, int part) {
    const int k0 = first_key(i);
    const int nt = min(kGroupTile, n - k0);
    if (i < nkt && part == 0) {
      const unsigned char* src = r_src(k0);
      rows_copy(stage(i) + kLaneGroup * tile_bytes + (reinterpret_cast<uintptr_t>(src) & 15),
                src, nt * row_bytes, tid, kThreads);
    }
    if (active) {
      const GroupRows r = lane_rows(i);
      if (part == 0 && r.nb1 > 0) rows_copy(r.p1, r.s1, r.nb1 * row_bytes, lane, 32);
      if (part == 1 && nt > r.nb1) rows_copy(r.p2, r.s2, (nt - r.nb1) * row_bytes, lane, 32);
    }
  };

  // before the wait: the first stages' big-cache and R rows
  const int pre = min(kAhead, items);
  for (int i = 0; i < pre; ++i) issue(i, 0);
  tc::cp_async_commit();
  pdl_wait();
  pdl_trigger();
  for (int i = 0; i < pre; ++i) issue(i, 1);
  tc::cp_async_commit();
  for (int e = tid; e < kLaneGroup * dw; e += kThreads) {
    const int lg = e / dw, w = e - lg * dw;
    if (b0 + lg >= B) break;
    const int hoff = h * dh;
    const float2 qv =
        bf2(reinterpret_cast<const uint32_t*>(qb + static_cast<long long>(b0 + lg) * HD + hoff)[w]);
    const float2 wb = bf2(reinterpret_cast<const uint32_t*>(rwb + hoff)[w]);
    const float2 rb = bf2(reinterpret_cast<const uint32_t*>(rrb + hoff)[w]);
    qq[lg * 32 + w] = make_float4(rnd<bf16>(qv.x + wb.x), rnd<bf16>(qv.y + wb.y),
                                  rnd<bf16>(qv.x + rb.x), rnd<bf16>(qv.y + rb.y));
  }

  float lmax = -INFINITY, lsum = 0.f, m = -INFINITY;
  float2 acc = make_float2(0.f, 0.f);
  for (int i = 0; i < items; ++i) {
    if (i == 0)
      tc::cp_async_wait<0>();
    else
      tc::cp_async_wait<kAhead - 1>();
    __syncthreads();  // item i is in, item i - 1's stage is free, q is in
    if (i + kAhead < items) {
      issue(i + kAhead, 0);
      issue(i + kAhead, 1);
    }
    tc::cp_async_commit();
    if (!active) continue;
    const GroupRows r = lane_rows(i);
    const int k0 = first_key(i);
    const int nt = min(kGroupTile, n - k0);
    auto row = [&](int j) {
      return reinterpret_cast<const uint32_t*>(j < r.nb1 ? r.p1 + j * row_bytes
                                                         : r.p2 + (j - r.nb1) * row_bytes);
    };
    if (i < nkt) {
      if (lane < nt) {
        const unsigned char* src = r_src(k0);
        const uint32_t* rt =
            reinterpret_cast<const uint32_t*>(stage(i) + kLaneGroup * tile_bytes +
                                              (reinterpret_cast<uintptr_t>(src) & 15)) +
            lane * dw;
        const uint32_t* kt = row(lane);
        float ac = 0.f, bd = 0.f;
        for (int w = 0; w < dw; ++w) {
          const float4 q4 = qg[w];
          const float2 kv = bf2(kt[w]);
          const float2 rv = bf2(rt[w]);
          ac += q4.x * kv.x + q4.y * kv.y;
          bd += q4.z * rv.x + q4.w * rv.y;
        }
        const float s = rnd<bf16>(rnd<bf16>(ac) + rnd<bf16>(bd)) * scale;
        scg[k0 + lane] = s;
        lmax = fmaxf(lmax, s);
      }
      if (i == nkt - 1) {  // the split's scores are in: the lane's softmax
        m = warp_max(lmax);
        __syncwarp();
        for (int j = lane; j < n; j += 32) {
          const float e = expf(scg[j] - m);
          scg[j] = rnd<bf16>(e);
          lsum += e;
        }
        __syncwarp();
      }
    } else if (lane < dw) {
      for (int j = 0; j < nt; ++j) {
        const float p = scg[k0 + j];
        const float2 v = bf2(row(j)[lane]);
        acc.x += p * v.x;
        acc.y += p * v.y;
      }
    }
  }
  tc::cp_async_wait<0>();

  // the split's part; then the last block of the group merges
  if (active) {
    const float l = warp_sum(lsum);
    if (lane < dw)
      reinterpret_cast<float2*>(opart + (static_cast<long long>(split) * B + b) * HD +
                                h * dh)[lane] = acc;
    if (lane == 0) {
      float* p = ml + ((static_cast<long long>(split) * B + b) * H + h) * 2;
      p[0] = m;  // -inf for an empty split
      p[1] = l;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = arrive + h * gridDim.y + grp;
    const int prev = atomicAdd(cnt, 1);
    *last = prev == S - 1;
    if (prev == S - 1) atomicExch(cnt, 0);
  }
  __syncthreads();
  if (*last == 0 || !active) return;
  __threadfence();
  // lane b's splits in split order: m = max m_s, w_s = exp(m_s - m) (0 for
  // an empty split), l = sum w_s l_s, ctx = rnd(sum_s w_s o_s * (1 / l)),
  // the parts read from L2 (other blocks wrote them)
  float* wts = reinterpret_cast<float*>(stages) + g * 2 * kMaxSplits;  // w_s, then l_s
  auto mls = [&](int s) {
    return reinterpret_cast<const float2*>(ml +
                                           ((static_cast<long long>(s) * B + b) * H + h) * 2);
  };
  float mm = -INFINITY;
  for (int s = lane; s < S; s += 32) mm = fmaxf(mm, __ldcg(mls(s)).x);
  mm = warp_max(mm);
  for (int s = lane; s < S; s += 32) {
    const float2 p = __ldcg(mls(s));
    wts[s] = p.x == -INFINITY ? 0.f : expf(p.x - mm);
    wts[kMaxSplits + s] = p.y;
  }
  __syncwarp();
  if (lane < dw) {
    const float2* ob =
        reinterpret_cast<const float2*>(opart + static_cast<long long>(b) * HD + h * dh) + lane;
    const long long step = static_cast<long long>(B) * HD / 2;
    float l = 0.f;
    float2 o = make_float2(0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const float w = wts[s];
      const float2 v = __ldcg(ob + s * step);
      l += w * wts[kMaxSplits + s];
      o.x += w * v.x;
      o.y += w * v.y;
    }
    const float inv = 1.f / l;
    reinterpret_cast<uint32_t*>(ctx + static_cast<long long>(b) * HD + h * dh)[lane] =
        tc::pack_bf16(o.x * inv, o.y * inv);
  }
}

}  // namespace

// The bf16 chain for tokens t0 .. t0 + n - 1 of a chunk (see the top of
// this file); sample(logits, i, t) launches the caller's sampling epilogue.
// Scratch: x (the layer input, the residual of the o GEMV), attn (the
// attention block's residual sum), out (the FF block's residual), hid, ff
// (the layer's output sum), q, ctx, logits; opart / ml when splits > 1 or
// lane groups, and arrive (zeroed) with lane groups.
template <typename Sample>
static int run_chain_tc(const GenArgs& a, cudaStream_t st, Sample sample) {
  const int L = a.L, B = a.B, M = a.M, HD = a.HD, DI = a.DI, H = a.H, V = a.V, n = a.n;
  const int C = a.C, S = a.splits, G = a.lane_group;
  const int dh = HD / H;
  if (dh % 2 != 0 || dh > 64 || DI % 2 != 0 || S < 1 ||
      S > kMaxSplits ||
      a.qkv_t == nullptr || a.o_t == nullptr || a.ff1_t == nullptr || a.ff2_t == nullptr ||
      a.lg_t == nullptr || a.R_h == nullptr ||
      ((S > 1 || G != 0) && (a.opart == nullptr || a.ml == nullptr)) ||
      (G != 0 && (G != kLaneGroup || a.arrive == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long big_kv = static_cast<long long>(B) * M * HD;
  const long long st_kv = static_cast<long long>(B) * C * HD;
  auto P = [](const void* p) { return static_cast<const bf16*>(p); };
  auto W = [](void* p) { return static_cast<bf16*>(p); };
  bf16* staged = W(a.staged);
  bf16 *x = W(a.x), *q = W(a.q), *ctx = W(a.ctx), *s1 = W(a.attn), *outb = W(a.out),
       *hid = W(a.hid), *s2 = W(a.ff);
  const int Kh = kpad(HD), Kd = kpad(DI);

  const int lanes = B < kLaneTile ? B : kLaneTile;
  const int MT = (lanes + 15) / 16;
  const int GW = MT <= 2 ? 8 : 16;  // a GEMV block's warps
  const size_t gsmem = gemv_smem(MT, GW, HD > DI ? HD : DI);
  cudaError_t e = cudaSuccess;
  switch (MT) {
    case 1: e = tg_allow_smem(tc_gemv_kernel<1, 8>, gsmem); break;
    case 2: e = tg_allow_smem(tc_gemv_kernel<2, 8>, gsmem); break;
    case 3: e = tg_allow_smem(tc_gemv_kernel<3, 16>, gsmem); break;
    default: e = tg_allow_smem(tc_gemv_kernel<4, 16>, gsmem); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // decode attention: keys a split holds at most, its kernel's shared memory
  const int max_keys = (M + C + S - 1) / S;
  const int tile_keys = max_keys < kKeyTile ? max_keys : kKeyTile;
  size_t asmem;
  if (G != 0) {
    if (max_keys > kGroupMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
    asmem = grouped_attn_smem(dh, max_keys);
    e = tg_allow_smem(grouped_split_attn_kernel, asmem);
  } else {
    asmem = split_attn_smem(dh, tile_keys, max_keys);
    e = tg_allow_smem(split_attn_kernel, asmem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);

  auto gemv = [&](const GemvIn& in, const bf16* Wt, int K, int N, const GemvOut& o) -> int {
    dim3 grid(npad(N) / kGemvN, (B + kLaneTile - 1) / kLaneTile);
    const size_t smem = gemv_smem(MT, GW, K);
    const int th = GW * 32;
    cudaError_t err;
    switch (MT) {
      case 1: err = launch_pdl(tc_gemv_kernel<1, 8>, grid, th, smem, st, in, Wt, K, N, o, B); break;
      case 2: err = launch_pdl(tc_gemv_kernel<2, 8>, grid, th, smem, st, in, Wt, K, N, o, B); break;
      case 3:
        err = launch_pdl(tc_gemv_kernel<3, 16>, grid, th, smem, st, in, Wt, K, N, o, B);
        break;
      default:
        err = launch_pdl(tc_gemv_kernel<4, 16>, grid, th, smem, st, in, Wt, K, N, o, B);
        break;
    }
    return static_cast<int>(err);
  };
  auto row_out = [](bf16* p, int N) {
    GemvOut o{};
    o.part_n = N;
    o.out[0] = p;
    o.out_stride[0] = N;
    o.seg[0] = N;
    return o;
  };

  int rc;
  for (int i = 0; i < n; ++i) {
    const int t = a.t0 + i;
    for (int l = 0; l < L; ++l) {
      const long long wl = static_cast<long long>(l) * HD;
      const bf16* Kl = P(a.kv) + 2 * l * big_kv;
      bf16* skl = staged + 2 * l * st_kv;
      // q, k, v: input x = the embedding (layer 0) or the last layer's sum
      // s2, post-LN'd; pre-LN keeps x raw and feeds LN_a(x)
      GemvIn in{};
      if (l == 0) {
        in.ids = a.ids;
        in.emb = P(a.emb);
      } else {
        in.src = s2;
        in.src_stride = HD;
      }
      if (a.pre_lnorm) {
        in.ln_s = a.ln_as + wl;
        in.ln_b = a.ln_ab + wl;
      } else if (l > 0) {
        in.ln_s = a.ln_fs + wl - HD;
        in.ln_b = a.ln_fb + wl - HD;
      }
      in.keep = x;
      in.keep_ln = a.pre_lnorm ? 0 : 1;
      GemvOut o{};
      o.part_n = HD;
      o.out[0] = q;
      o.out_stride[0] = HD;
      o.seg[0] = HD;
      const long long row_t = static_cast<long long>(t) * dh;
      for (int p = 1; p < 3; ++p) {  // k, v: row t of the ring, head by head
        o.out[p] = skl + (p - 1) * st_kv + row_t;
        o.out_stride[p] = static_cast<long long>(C) * dh;
        o.seg[p] = dh;
        o.seg_stride[p] = static_cast<long long>(B) * C * dh;
      }
      if ((rc = gemv(in, P(a.qkv_t) + static_cast<long long>(l) * npad(3 * HD) * Kh, HD,
                     3 * HD, o)))
        return rc;
      const bf16* Rl = P(a.R_h) + static_cast<long long>(l) * (M + 1) * HD;
      if (G != 0) {  // lane groups: the splits merged by the last block of each
        if ((rc = launch_pdl(grouped_split_attn_kernel, dim3(H, (B + G - 1) / G, S),
                             kLaneGroup * 32, asmem, st, static_cast<const bf16*>(q), Kl,
                             Kl + big_kv, static_cast<const bf16*>(skl),
                             static_cast<const bf16*>(skl + st_kv), Rl, P(a.rwb), P(a.rrb),
                             a.opart, a.ml, a.arrive, ctx, B, M, C, HD, dh, t, a.count,
                             a.same_length ? 1 : 0, a.scale, max_keys)))
          return rc;
      } else {
        if ((rc = launch_pdl(split_attn_kernel, dim3(H, B, S), kSplitThreads, asmem, st,
                             static_cast<const bf16*>(q), Kl, Kl + big_kv,
                             static_cast<const bf16*>(skl), static_cast<const bf16*>(skl + st_kv),
                             Rl, P(a.rwb), P(a.rrb), a.opart, a.ml, ctx, M, C, HD, dh, t,
                             a.count, a.same_length ? 1 : 0, a.scale, tile_keys)))
          return rc;
        if (S > 1 && (rc = launch_pdl(split_combine_kernel, dim3(H, B), kTcThreads, 0, st,
                                      static_cast<const float*>(a.opart),
                                      static_cast<const float*>(a.ml), ctx, S, HD, dh)))
          return rc;
      }
      // o: s1 = rnd(x + rnd(ctx W_o))
      in = GemvIn{};
      in.src = ctx;
      in.src_stride = HD;
      o = row_out(s1, HD);
      o.res = x;
      o.res_stride = HD;
      if ((rc = gemv(in, P(a.o_t) + static_cast<long long>(l) * npad(HD) * Kh, HD, HD, o)))
        return rc;
      // FF1: post-LN out = LN_a(s1) (kept for FF2's residual); pre-LN LN_f(s1)
      in = GemvIn{};
      in.src = s1;
      in.src_stride = HD;
      in.ln_s = (a.pre_lnorm ? a.ln_fs : a.ln_as) + wl;
      in.ln_b = (a.pre_lnorm ? a.ln_fb : a.ln_ab) + wl;
      if (!a.pre_lnorm) {
        in.keep = outb;
        in.keep_ln = 1;
      }
      o = row_out(hid, DI);
      o.bias = P(a.fb1) + static_cast<long long>(l) * DI;
      o.relu = 1;
      if ((rc = gemv(in, P(a.ff1_t) + static_cast<long long>(l) * npad(DI) * Kh, HD, DI, o)))
        return rc;
      // FF2: s2 = rnd(res + rnd(rnd(hid W_2) + b_2))
      in = GemvIn{};
      in.src = hid;
      in.src_stride = DI;
      o = row_out(s2, HD);
      o.bias = P(a.fb2) + wl;
      o.res = a.pre_lnorm ? s1 : outb;
      o.res_stride = HD;
      if ((rc = gemv(in, P(a.ff2_t) + static_cast<long long>(l) * npad(HD) * Kd, DI, HD, o)))
        return rc;
    }
    // logits: post-LN x = LN_f(s2) of the last layer; pre-LN x = s2
    GemvIn in{};
    in.src = s2;
    in.src_stride = HD;
    if (!a.pre_lnorm) {
      in.ln_s = a.ln_fs + static_cast<long long>(L - 1) * HD;
      in.ln_b = a.ln_fb + static_cast<long long>(L - 1) * HD;
    }
    bf16* lg = a.logits_out != nullptr ? W(a.logits_out) + static_cast<long long>(i) * B * V
                                       : W(a.logits);
    GemvOut o = row_out(lg, V);
    o.bias = P(a.crit_bias);
    if ((rc = gemv(in, P(a.lg_t), HD, V, o))) return rc;
    if ((rc = sample(static_cast<const bf16*>(lg), i, t))) return rc;
  }
  return 0;
}
