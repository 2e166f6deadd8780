// The per-token decoder chain shared by the fused samplers, hand-written for
// Hopper (sm_90a): generation (K3, generate.cu) and the GAN's gumbel
// straight-through sampler (K4, K5, decode.cu).
//
// The TPU kernels walk a sequential (T, L) grid and carry the token and the
// staged K/V ring in VMEM scratch. Blocks on Hopper run in no order and carry
// nothing, so one C entry point per call runs a host loop over the tokens
// and the L layers that launches a short chain of small kernels on the
// caller's stream. Stream order is the step order; the token stays on the
// device between steps and Python is off the per-token path. Per token and
// layer:
//   embed gather (once per token) -> [pre-LN] -> q, k, v GEMVs (k and v land
//   in the staged ring at row t) -> decode attention -> o GEMV -> residual +
//   LN -> FF1 GEMV + ReLU -> FF2 GEMV -> residual + LN; then the logits GEMV
//   and the caller's sampling epilogue.
//
// What bounds it on the H100: each token reads the K/V cache,
// 2 * L * B * M * HD * 2 bytes in bf16, and the weights (L * (4 HD^2 +
// 2 HD DI) * 2 bytes, 24 MB, L2-resident across tokens) and does 2 FLOPs per
// weight and lane: bytes at a long memory and few lanes (K3: M 4146, B 1),
// operations at the GAN's B 64, M 64 (K4). In practice neither: the chain's
// ~57 launches a token and GEMVs that read the weights once per lane.
// Decode attention takes one block per (h, b) and a warp per key, lanes
// along d_head, so each key row is one coalesced read; GEMVs take a block
// per (32 columns, lane) with 8 warps splitting K. At small B this
// leaves the card mostly idle (H * B blocks). This chain (run_chain and its
// decode_attn_kernel) runs fp32 only, the exact on-card reference; bf16 runs
// the split-key, lane-tiled chain of decode_chain_tc.cuh (run_chain_tc).
// gemv_kernel, ln_kernel and embed_kernel stay generic: the reverse chain
// (chain_bwd.cu, K6 / K7) runs them in both types.
//
// Positions follow the distance rule of the plain decode step: at chunk step
// t, big slot j sits at distance M - j + t and staged slot s at t - s.
// Rounding follows the plain versions (ops/generate.py, ops/decode.py): fp32
// accumulation, results rounded to the compute type after each product, on
// the residual sums and on the logits; softmax and sampling in fp32.
#pragma once

#include "common.cuh"

namespace {


constexpr int kGemvCols = 32;
constexpr int kGemvWarps = 8;
constexpr int kAttnThreads = 256;
constexpr int kMaxDPL = 4;  // d_head <= 128
constexpr float kNeg = -1e30f;

template <typename T>
__global__ void embed_kernel(const int* __restrict__ ids, const T* __restrict__ emb,
                             T* __restrict__ x, int HD) {
  const int b = blockIdx.x;
  const long long row = static_cast<long long>(ids[b]) * HD;
  for (int d = threadIdx.x; d < HD; d += blockDim.x) x[b * HD + d] = emb[row + d];
}

// out[b, n] = rnd(rnd(x[b] . W[:, n]) + bias[n]), optionally ReLU'd.
// W is [K, N] row-major; grid (ceil(N / 32), B). Column n is stored at
// out + (n / seg) * seg_stride + b * out_stride + n % seg: seg = N is a plain
// row, seg = d_head scatters the heads into an h-major [H, B, ., d_head] buffer.
template <typename T>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_kernel(const T* __restrict__ x, long long x_stride, const T* __restrict__ W,
            int K, int N, const T* __restrict__ bias, int relu, T* __restrict__ out,
            long long out_stride, int seg, long long seg_stride) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [K]
  float* red = smem + K;            // [kGemvWarps][32]
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvCols + lane;
  for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = to_f<T>(x[b * x_stride + k]);
  __syncthreads();
  float acc = 0.f;
  if (n < N)
    for (int k = warp; k < K; k += kGemvWarps)
      acc += xs[k] * to_f<T>(W[static_cast<long long>(k) * N + n]);
  red[warp * 32 + lane] = acc;
  __syncthreads();
  if (warp == 0 && n < N) {
    float s = 0.f;
    for (int w = 0; w < kGemvWarps; ++w) s += red[w * 32 + lane];
    float y = rnd<T>(s);
    if (bias != nullptr) y = rnd<T>(y + to_f<T>(bias[n]));
    if (relu) y = fmaxf(y, 0.f);
    out[(n / seg) * seg_stride + b * out_stride + n % seg] = from_f<T>(y);
  }
}

// v = b ? rnd(a + b) : a; sum_out = v (optional); out = LN(v) if do_ln else v.
// LayerNorm statistics in fp32 (eps 1e-5), scale and bias in fp32.
template <typename T>
__global__ void ln_kernel(const T* __restrict__ a, const T* __restrict__ bsrc,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          T* __restrict__ sum_out, T* __restrict__ out, int N, int do_ln) {
  extern __shared__ float smem[];
  float* v = smem;         // [N]
  float* red = smem + N;   // [32]
  const int row = blockIdx.x;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float x = to_f<T>(a[row * N + n]);
    if (bsrc != nullptr) x = rnd<T>(x + to_f<T>(bsrc[row * N + n]));
    v[n] = x;
    if (sum_out != nullptr) sum_out[row * N + n] = from_f<T>(x);
  }
  __syncthreads();
  if (!do_ln) {
    for (int n = threadIdx.x; n < N; n += blockDim.x) out[row * N + n] = from_f<T>(v[n]);
    return;
  }
  float s = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) s += v[n];
  const float mean = block_sum(s, red) / N;
  float s2 = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float c = v[n] - mean;
    s2 += c * c;
  }
  const float var = block_sum(s2, red) / N;
  const float inv = rsqrtf(var + 1e-5f);
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    out[row * N + n] = from_f<T>((v[n] - mean) * inv * scale[n] + bias[n]);
}

// One token's attention for layer l, one block per (h, b). The big cache
// Kb, Vb is h-major [H, B, M, dh] and the staged ring sk, sv [H, B, C, dh],
// so the block's keys are one contiguous run of dh-long rows. Big slot j sits
// at distance M - j + t (R row j - t), staged slot s at t - s (R row
// M - t + s); R row r holds distance M - r. Masked: big j < max(M - count,
// t + sl), staged s > t.
__global__ void __launch_bounds__(kAttnThreads)
decode_attn_kernel(const float* __restrict__ qb, const float* __restrict__ Kb,
                   const float* __restrict__ Vb, const float* __restrict__ sk,
                   const float* __restrict__ sv, const float* __restrict__ R,
                   const float* __restrict__ rwb, const float* __restrict__ rrb,
                   float* __restrict__ ctx, int M, int C, int HD, int dh, int t, int count,
                   int sl, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const long long hb = static_cast<long long>(h) * gridDim.y + b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* qw = smem;                   // [dh]
  float* qr = qw + dh;                // [dh]
  float* red = qr + dh;               // [32]
  float* part = red + 32;             // [nw][dh]
  float* sc = part + nw * dh;         // [M + C]

  const int hoff = h * dh;
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    const float qv = qb[b * HD + hoff + d];
    qw[d] = qv + rwb[hoff + d];
    qr[d] = qv + rrb[hoff + d];
  }
  __syncthreads();

  const int jlo = min(M, max(M - count, t + sl));
  const int n_big = M - jlo;
  const int n_keys = n_big + t + 1;

  auto key_row = [&](int kk, const float* big, const float* staged) -> const float* {
    if (kk < n_big) return big + (hb * M + jlo + kk) * dh;
    return staged + (hb * C + (kk - n_big)) * dh;
  };

  float lmax = -INFINITY;
  for (int kk = warp; kk < n_keys; kk += nw) {
    const float* krow = key_row(kk, Kb, sk);
    const int r = kk < n_big ? jlo + kk - t : M - t + (kk - n_big);
    const float* rrow = R + static_cast<long long>(r) * HD + hoff;
    float ac = 0.f, bd = 0.f;
    for (int d = lane; d < dh; d += 32) {
      ac += qw[d] * krow[d];
      bd += qr[d] * rrow[d];
    }
    ac = warp_sum(ac);
    bd = warp_sum(bd);
    const float s = (ac + bd) * scale;
    if (lane == 0) sc[kk] = s;
    lmax = fmaxf(lmax, s);
  }
  const float mx = block_max(lmax, red);  // syncs: sc is complete after this
  float lsum = 0.f;
  for (int kk = threadIdx.x; kk < n_keys; kk += blockDim.x) {
    const float e = expf(sc[kk] - mx);
    sc[kk] = e;
    lsum += e;
  }
  const float denom = block_sum(lsum, red);  // syncs

  float acc[kMaxDPL];
#pragma unroll
  for (int c = 0; c < kMaxDPL; ++c) acc[c] = 0.f;
  for (int kk = warp; kk < n_keys; kk += nw) {
    const float p = sc[kk] / denom;
    const float* vrow = key_row(kk, Vb, sv);
#pragma unroll
    for (int c = 0; c < kMaxDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) acc[c] += p * vrow[d];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxDPL; ++c) {
    const int d = lane + 32 * c;
    if (d < dh) part[warp * dh + d] = acc[c];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += part[w * dh + d];
    ctx[b * HD + hoff + d] = s;
  }
}


// Argmax with the lowest index winning ties, over a block.
struct ArgMax {
  float v;
  int i;
};

__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  if (b.v > a.v || (b.v == a.v && b.i < a.i)) return b;
  return a;
}

__device__ ArgMax block_argmax(ArgMax a, float* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax other{__shfl_xor_sync(kFullMask, a.v, o), __shfl_xor_sync(kFullMask, a.i, o)};
    a = better(a, other);
  }
  __syncthreads();
  if (lane == 0) {
    redv[warp] = a.v;
    redi[warp] = a.i;
  }
  __syncthreads();
  ArgMax r{redv[0], redi[0]};
  for (int w = 1; w < nw; ++w) r = better(r, ArgMax{redv[w], redi[w]});
  return r;
}

}  // namespace

// Operands of one call of the chain (K3, K4, K5). Pointers are device pointers; T is the compute
// type (dtype 0 float32, 1 bfloat16) unless marked float or int.
struct GenArgs {
  int dtype, n, L, B, M, HD, DI, H, V;
  int pre_lnorm, same_length, technique, topk, exclude_bos, num_empty, empty_token;
  int count;
  int t0;             // chunk step of the call's first token
  int C;              // rows of the staged ring (>= t0 + n)
  int splits;         // bf16: key splits of decode attention (decode_chain_tc.cuh)
  int lane_group;     // bf16: 0, split_attn_kernel; kLaneGroup, grouped_split_attn_kernel
  float scale, temperature;
  const void* kv;     // [L, 2, H, B, M, dh] big K/V cache (the XL memory)
  const void* R;      // [L, M + 1, HD], row r = distance M - r
  const void* q_w;    // [L, HD, HD]
  const void* k_w;
  const void* v_w;
  const void* o_w;
  const void* ff1;    // [L, HD, DI]
  const void* fb1;    // [L, DI]
  const void* ff2;    // [L, DI, HD]
  const void* fb2;    // [L, HD]
  const float* ln_as; // [L, HD] float
  const float* ln_ab;
  const float* ln_fs;
  const float* ln_fb;
  const void* rwb;    // [HD]
  const void* rrb;
  const void* emb;    // [V, HD], pre-scaled by sqrt(d_model)
  const void* emb_t;  // [HD, V]
  const void* crit_bias;  // [V]
  const float* g;     // [n, B, V] float gumbel noise
  int* ids;           // [B] in: first token, out: last token
  int* er;            // [B] empty-run counters, in and out
  int* tokens;        // [n, B] out
  void* staged;       // [L, 2, H, B, C, dh] the chunk's K/V rows, row t0 + i
                      // written by the call's token i
  void* logits_out;   // [n, B, V] out, or null
  void* x;            // scratch [B, HD] x 6, [B, DI], [B, V]
  void* w_in;
  void* q;
  void* ctx;
  void* attn;
  void* out;
  void* hid;          // [B, DI]
  void* ff;
  void* logits;       // [B, V]
  void* onehot;       // [n, B, V] float out (K4, K5), or null
  // bf16 only (decode_chain_tc.cuh): W^T of each product, K padded to a
  // multiple of 32 and N to a multiple of 8 with zeros
  const void* qkv_t;  // [L, npad(3 HD), kpad(HD)]: q, k, v columns
  const void* o_t;    // [L, npad(HD), kpad(HD)]
  const void* ff1_t;  // [L, npad(DI), kpad(HD)]
  const void* ff2_t;  // [L, npad(HD), kpad(DI)]
  const void* lg_t;   // [npad(V), kpad(HD)]
  float* opart;       // [splits, B, HD] float scratch when splits > 1 or lane_group
  float* ml;          // [splits, B, H, 2] float scratch when splits > 1 or lane_group
  const void* R_h;    // [L, H, M + 1, dh]: R with each head's rows contiguous
  int* arrive;        // [H, ceil(B / lane_group)] zeroed int scratch when lane_group
};

// The chain for tokens t0 .. t0 + n - 1 of a chunk: per token the embed, the
// L layers and the logits GEMV; then sample(logits, i, t) launches the
// caller's sampling epilogue for the call's token i at chunk step t.
template <typename Sample>
static int run_chain(const GenArgs& a, cudaStream_t st, Sample sample) {
  const int L = a.L, B = a.B, M = a.M, HD = a.HD, DI = a.DI, H = a.H, V = a.V, n = a.n;
  const int C = a.C;
  const int dh = HD / H;
  // per layer: K then V, each h-major [H, B, rows, dh]
  const long long big_kv = static_cast<long long>(B) * M * HD;
  const long long st_kv = static_cast<long long>(B) * C * HD;
  using T = float;
  auto P = [](const void* p) { return static_cast<const T*>(p); };
  auto W = [](void* p) { return static_cast<T*>(p); };
  T* staged = W(a.staged);

  const int gemv_threads = kGemvWarps * 32;
  auto gemv_to = [&](const T* x, long long xs, const T* w, int K, int N, const T* bias,
                     int relu, T* out, long long os, int seg, long long seg_stride) -> int {
    const size_t smem = sizeof(float) * (K + kGemvWarps * 32);
    cudaError_t e = tg_allow_smem(gemv_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((N + kGemvCols - 1) / kGemvCols, B);
    gemv_kernel<T><<<grid, gemv_threads, smem, st>>>(x, xs, w, K, N, bias, relu, out, os,
                                                     seg, seg_stride);
    TG_CHECK();
    return 0;
  };
  auto gemv = [&](const T* x, long long xs, const T* w, int K, int N, const T* bias,
                  int relu, T* out, long long os) -> int {
    return gemv_to(x, xs, w, K, N, bias, relu, out, os, N, 0);
  };
  auto ln = [&](const T* x, const T* y, const float* sc, const float* bi, T* sum_out,
                T* out, int do_ln) -> int {
    const size_t smem = sizeof(float) * (HD + 32);
    cudaError_t e = tg_allow_smem(ln_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ln_kernel<T><<<B, 256, smem, st>>>(x, y, sc, bi, sum_out, out, HD, do_ln);
    TG_CHECK();
    return 0;
  };
  const size_t attn_smem =
      sizeof(float) * (2 * dh + 32 + (kAttnThreads / 32) * dh + M + C);
  {
    cudaError_t e = tg_allow_smem(decode_attn_kernel, attn_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  int rc;
  T* x = W(a.x);
  for (int i = 0; i < n; ++i) {
    const int t = a.t0 + i;
    embed_kernel<T><<<B, 256, 0, st>>>(a.ids, P(a.emb), x, HD);
    TG_CHECK();
    for (int l = 0; l < L; ++l) {
      const long long wl = static_cast<long long>(l) * HD;
      const T* w_in = x;
      if (a.pre_lnorm) {
        if ((rc = ln(x, nullptr, a.ln_as + wl, a.ln_ab + wl, nullptr, W(a.w_in), 1))) return rc;
        w_in = W(a.w_in);
      }
      const long long sq = static_cast<long long>(l) * HD * HD;
      const T* Kl = P(a.kv) + 2 * l * big_kv;
      T* skl = staged + 2 * l * st_kv;
      // k and v land in the staged ring at row t, head by head
      const long long row_b = static_cast<long long>(C) * dh;
      const long long row_h = static_cast<long long>(B) * C * dh;
      const long long row_t = static_cast<long long>(t) * dh;
      if ((rc = gemv(w_in, HD, P(a.q_w) + sq, HD, HD, nullptr, 0, W(a.q), HD))) return rc;
      if ((rc = gemv_to(w_in, HD, P(a.k_w) + sq, HD, HD, nullptr, 0, skl + row_t, row_b, dh,
                        row_h))) return rc;
      if ((rc = gemv_to(w_in, HD, P(a.v_w) + sq, HD, HD, nullptr, 0, skl + st_kv + row_t,
                        row_b, dh, row_h))) return rc;
      decode_attn_kernel<<<dim3(H, B), kAttnThreads, attn_smem, st>>>(
          W(a.q), Kl, Kl + big_kv, skl, skl + st_kv,
          P(a.R) + static_cast<long long>(l) * (M + 1) * HD, P(a.rwb), P(a.rrb),
          W(a.ctx), M, C, HD, dh, t, a.count, a.same_length ? 1 : 0, a.scale);
      TG_CHECK();
      if ((rc = gemv(W(a.ctx), HD, P(a.o_w) + sq, HD, HD, nullptr, 0, W(a.attn), HD)))
        return rc;
      const T* ff_in;
      if (a.pre_lnorm) {
        // out = x + attn; ff_in = LN_f(out)
        if ((rc = ln(x, W(a.attn), a.ln_fs + wl, a.ln_fb + wl, W(a.out), W(a.w_in), 1)))
          return rc;
        ff_in = W(a.w_in);
      } else {
        // out = LN_a(x + attn)
        if ((rc = ln(x, W(a.attn), a.ln_as + wl, a.ln_ab + wl, nullptr, W(a.out), 1)))
          return rc;
        ff_in = W(a.out);
      }
      const long long f1 = static_cast<long long>(l) * HD * DI;
      if ((rc = gemv(ff_in, HD, P(a.ff1) + f1, HD, DI,
                     P(a.fb1) + static_cast<long long>(l) * DI, 1, W(a.hid), DI)))
        return rc;
      if ((rc = gemv(W(a.hid), DI, P(a.ff2) + f1, DI, HD, P(a.fb2) + wl, 0, W(a.ff), HD)))
        return rc;
      if (a.pre_lnorm) {
        if ((rc = ln(W(a.out), W(a.ff), nullptr, nullptr, nullptr, x, 0))) return rc;
      } else {
        if ((rc = ln(W(a.out), W(a.ff), a.ln_fs + wl, a.ln_fb + wl, nullptr, x, 1)))
          return rc;
      }
    }
    T* lg = a.logits_out != nullptr
                ? W(a.logits_out) + static_cast<long long>(i) * B * V
                : W(a.logits);
    if ((rc = gemv(x, HD, P(a.emb_t), HD, V, P(a.crit_bias), 0, lg, V))) return rc;
    if ((rc = sample(static_cast<const T*>(lg), i, t))) return rc;
  }
  return 0;
}

