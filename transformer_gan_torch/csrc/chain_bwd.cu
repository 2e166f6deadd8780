// Reverse straight-through chain of the full-backprop GAN gen phase,
// hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of transformer_gan_tpu/ops/pallas_chain_bwd.py:
//   * K6, _chain_res_kernel (reached through _make_chain_res_call /
//     chain_bwd_q_res): the chain on the window pass's saved residuals;
//   * K7, _chain_kernel (reached through _make_chain_call / chain_bwd_q): the
//     chain recomputing each token's forward in the kernel.
// One call per sampled chunk runs the reverse loop over its n tokens. The only
// carry is chi [B, V], the cotangent of the token's input one-hot. Per token t
// (last first):
//   q_t = y_t * (m - <m, y_t>) / T with m = s_t + chi     -> Q[t]
//   dx  = q_t @ emb_t^T                                   (logits head)
//   [K7: the token's forward from its id against the lane buffers, keeping
//    x, z1, z2, ff_pre and the attention probabilities of every layer]
//   per layer, last first: layer-norm and feed-forward backward, then the
//   attention backward with every cross K/V lane constant and the token's
//   own lane (M + t) live: dS = P (dP - <P, dP>) * scale, dq from dS against
//   the keys and the positional rows, dk_self = dS_self * qw, dv_self =
//   P_self * dctx; dx += dq q_w^T + dk k_w^T + dv v_w^T
//   chi = dx @ emb^T                                      (for token t - 1)
//
// The TPU kernel carries chi and dx in VMEM scratch across a sequential
// (token, layer, batch block) grid. Blocks on Hopper run in no order and carry
// nothing, so, as in decode_chain.cuh, one C entry point runs a host loop over
// tokens and layers that launches a chain of small kernels on the caller's
// stream; chi and dx live in global memory (a few hundred KB, L2-resident).
// Lane algebra: token t sees lanes [max(M - count, t), M + t] of the
// [memory || window] lane buffers; lane j sits at distance M + t - j, so its
// positional row is R[j - t] (the TPU kernel's roll by t).
//
// What bounds it on the H100: per token and layer it reads the layer's
// weights (4 HD^2 + 2 HD DI values) and the token's K/V lanes (2 B (M + t)
// HD values) and does ~2 B multiply-adds per weight: operations and bytes
// about equally at B 64 (0.12 and 0.11 ms a 59-token chunk), in practice the
// latency of ~13 small launches per token and layer and GEMVs that read the
// weights once per lane. This chain (run_chain_bwd) runs fp32 only, the exact
// on-card reference; bf16 runs the lane-tiled tensor-core chain of
// chain_bwd_tc.cu (run_chain_bwd_tc).
// Rounding follows the plain version's compute type: each product's inputs are
// rounded to T, sums and cotangents stay fp32.
#include "chain_args.cuh"
#include "decode_chain.cuh"

namespace {

constexpr int kRowsWarps = 8;   // gemv_rows: one warp per output, 8 per block
constexpr int kBwdThreads = 256;

// Q[b, :] = y * (m - <m, y>) / T, m = s + chi (one block per lane).
__global__ void st_bwd_kernel(const float* __restrict__ S, const float* __restrict__ Y,
                              const float* __restrict__ chi, float* __restrict__ Q,
                              int V, float temperature) {
  __shared__ float red[32];
  const long long row = static_cast<long long>(blockIdx.x) * V;
  float part = 0.f;
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    part += (S[row + v] + chi[row + v]) * Y[row + v];
  const float dot = block_sum(part, red);
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const float m = S[row + v] + chi[row + v];
    Q[row + v] = (Y[row + v] * (m - dot)) / temperature;
  }
}

// out[b, n] (+)= sum_k rnd(x[b, k]) * W[n, k]: a product with a transposed
// row-major weight W [N, K] (a warp per output n, lanes along k, so W rows
// are read coalesced). mask (optional, T, row stride ms) zeroes outputs whose
// mask value is not positive (the ReLU's backward). Grid (ceil(N / 8), B).
template <typename T>
__global__ void __launch_bounds__(kRowsWarps * 32)
gemv_rows_kernel(const float* __restrict__ x, int K, const T* __restrict__ W, int N,
                 float* __restrict__ out, int accum, const T* __restrict__ mask,
                 long long ms) {
  extern __shared__ float xs[];  // [K]
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    xs[k] = rnd<T>(x[static_cast<long long>(b) * K + k]);
  __syncthreads();
  const int n = blockIdx.x * kRowsWarps + warp;
  if (n >= N) return;
  const T* w = W + static_cast<long long>(n) * K;
  float acc = 0.f;
  for (int k = lane; k < K; k += 32) acc += xs[k] * to_f<T>(w[k]);
  acc = warp_sum(acc);
  if (lane == 0) {
    if (mask != nullptr && !(to_f<T>(mask[b * ms + n]) > 0.f)) acc = 0.f;
    const long long o = static_cast<long long>(b) * N + n;
    out[o] = accum ? out[o] + acc : acc;
  }
}

// out = add + LN-backward(dy1 + dy2) at z: with zh = (z - mean) * rstd and
// g = dy * scale, (g - mean(g) - zh * mean(g * zh)) * rstd. dy2, add optional.
template <typename T>
__global__ void ln_bwd_kernel(const float* __restrict__ dy1, const float* __restrict__ dy2,
                              const T* __restrict__ z, const float* __restrict__ scale,
                              const float* __restrict__ add, float* __restrict__ out,
                              int N) {
  extern __shared__ float smem[];
  float* zs = smem;       // [N]
  float* gs = smem + N;   // [N]
  float* red = gs + N;    // [32]
  const long long row = static_cast<long long>(blockIdx.x) * N;
  float s = 0.f;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    zs[k] = to_f<T>(z[row + k]);
    s += zs[k];
  }
  const float mean = block_sum(s, red) / N;
  float s2 = 0.f;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const float c = zs[k] - mean;
    s2 += c * c;
  }
  const float rstd = rsqrtf(block_sum(s2, red) / N + 1e-5f);
  float sg = 0.f, sgz = 0.f;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const float dy = dy1[row + k] + (dy2 != nullptr ? dy2[row + k] : 0.f);
    const float g = dy * scale[k];
    const float zh = (zs[k] - mean) * rstd;
    gs[k] = g;
    zs[k] = zh;
    sg += g;
    sgz += g * zh;
  }
  const float mg = block_sum(sg, red) / N;
  const float mgz = block_sum(sgz, red) / N;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const float v = (gs[k] - mg - zs[k] * mgz) * rstd;
    out[row + k] = (add != nullptr ? add[row + k] : 0.f) + v;
  }
}

__global__ void add_kernel(const float* __restrict__ a, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] += a[i];
}

template <typename T>
__global__ void relu_kernel(const T* __restrict__ x, T* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = from_f<T>(fmaxf(to_f<T>(x[i]), 0.f));
}

// K7's forward attention of token t for layer l, one block per (h, b):
// lanes [jlo, M + t] of kf / vf [H, B, KL, dh], positional row R[j - t];
// s = rnd(rnd(qw . k) + rnd(qr . r)) * scale; writes the fp32 probabilities
// over all KL lanes (0 where masked) and ctx = sum_j rnd(p_j) v_j.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
chain_attn_fwd_kernel(const T* __restrict__ qb, const T* __restrict__ kf,
                      const T* __restrict__ vf, const T* __restrict__ R,
                      const T* __restrict__ rwb, const T* __restrict__ rrb,
                      float* __restrict__ prob, T* __restrict__ ctx, int M, int KL,
                      int HD, int dh, int t, int count, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const long long hb = static_cast<long long>(h) * gridDim.y + b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  float* qw = smem;            // [dh]
  float* qr = qw + dh;         // [dh]
  float* red = qr + dh;        // [32]
  float* part = red + 32;      // [nw][dh]
  float* sc = part + nw * dh;  // [KL]
  const int hoff = h * dh;
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    const float qv = to_f<T>(qb[b * HD + hoff + d]);
    qw[d] = rnd<T>(qv + to_f<T>(rwb[hoff + d]));
    qr[d] = rnd<T>(qv + to_f<T>(rrb[hoff + d]));
  }
  __syncthreads();
  const int jlo = min(M, max(M - count, t));
  const int nk = M + t - jlo + 1;
  float lmax = -INFINITY;
  for (int kk = warp; kk < nk; kk += nw) {
    const int j = jlo + kk;
    const T* krow = kf + (hb * KL + j) * dh;
    const T* rrow = R + static_cast<long long>(j - t) * HD + hoff;
    float ac = 0.f, bd = 0.f;
    for (int d = lane; d < dh; d += 32) {
      ac += qw[d] * to_f<T>(krow[d]);
      bd += qr[d] * to_f<T>(rrow[d]);
    }
    ac = warp_sum(ac);
    bd = warp_sum(bd);
    const float s = rnd<T>(rnd<T>(ac) + rnd<T>(bd)) * scale;
    if (lane == 0) sc[kk] = s;
    lmax = fmaxf(lmax, s);
  }
  const float mx = block_max(lmax, red);
  float lsum = 0.f;
  for (int kk = threadIdx.x; kk < nk; kk += blockDim.x) {
    const float e = expf(sc[kk] - mx);
    sc[kk] = e;
    lsum += e;
  }
  const float denom = block_sum(lsum, red);
  float* prow = prob + (static_cast<long long>(b) * H + h) * KL;
  for (int j = threadIdx.x; j < KL; j += blockDim.x)
    prow[j] = (j >= jlo && j <= M + t) ? sc[j - jlo] / denom : 0.f;
  float acc[kMaxDPL];
#pragma unroll
  for (int c = 0; c < kMaxDPL; ++c) acc[c] = 0.f;
  for (int kk = warp; kk < nk; kk += nw) {
    const float p = rnd<T>(sc[kk] / denom);
    const T* vrow = vf + (hb * KL + jlo + kk) * dh;
#pragma unroll
    for (int c = 0; c < kMaxDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) acc[c] += p * to_f<T>(vrow[d]);
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
    ctx[b * HD + hoff + d] = from_f<T>(s);
  }
}

// Attention backward of token t for layer l, one block per (h, b). prob:
// the token's fp32 probabilities over KL lanes (row (b, h) at stride
// H_stride * KL); dctx [B, HD] fp32; q [B, HD] the recomputed query.
// Writes dq = dS K + dS R (position rows) and the self lane's dk, dv.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
chain_attn_bwd_kernel(const float* __restrict__ prob, long long prob_bh,
                      const float* __restrict__ dctx, const T* __restrict__ qb,
                      const T* __restrict__ rwb, const T* __restrict__ kf,
                      const T* __restrict__ vf, const T* __restrict__ R,
                      float* __restrict__ dq, float* __restrict__ dk,
                      float* __restrict__ dv, int M, int KL, int HD, int dh, int t,
                      int count, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const long long hb = static_cast<long long>(h) * gridDim.y + b;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  float* dc = smem;            // [dh] dctx of this head, rounded to T
  float* qw = dc + dh;         // [dh] q + r_w_bias
  float* red = qw + dh;        // [32]
  float* part = red + 32;      // [nw][dh]
  float* sd = part + nw * dh;  // [KL] dP, then dS
  const int hoff = h * dh;
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    dc[d] = rnd<T>(dctx[b * HD + hoff + d]);
    qw[d] = rnd<T>(to_f<T>(qb[b * HD + hoff + d]) + to_f<T>(rwb[hoff + d]));
  }
  __syncthreads();
  const float* pr = prob + (static_cast<long long>(b) * H + h) * prob_bh;
  const int jlo = min(M, max(M - count, t));
  const int nk = M + t - jlo + 1;
  float pdp = 0.f;
  for (int kk = warp; kk < nk; kk += nw) {
    const T* vrow = vf + (hb * KL + jlo + kk) * dh;
    float dp = 0.f;
    for (int d = lane; d < dh; d += 32) dp += dc[d] * to_f<T>(vrow[d]);
    dp = warp_sum(dp);
    if (lane == 0) sd[kk] = dp;
    pdp += dp * pr[jlo + kk];   // identical in every lane of the warp
  }
  const float D = block_sum(lane == 0 ? pdp : 0.f, red);
  for (int kk = threadIdx.x; kk < nk; kk += blockDim.x)
    sd[kk] = pr[jlo + kk] * (sd[kk] - D) * scale;
  __syncthreads();
  const float ds_self = sd[nk - 1], p_self = pr[M + t];
  float aq[kMaxDPL];
#pragma unroll
  for (int c = 0; c < kMaxDPL; ++c) aq[c] = 0.f;
  for (int kk = warp; kk < nk; kk += nw) {
    const int j = jlo + kk;
    const float ds = rnd<T>(sd[kk]);
    const T* krow = kf + (hb * KL + j) * dh;
    const T* rrow = R + static_cast<long long>(j - t) * HD + hoff;
#pragma unroll
    for (int c = 0; c < kMaxDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) aq[c] += ds * (to_f<T>(krow[d]) + to_f<T>(rrow[d]));
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxDPL; ++c) {
    const int d = lane + 32 * c;
    if (d < dh) part[warp * dh + d] = aq[c];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += part[w * dh + d];
    const long long o = static_cast<long long>(b) * HD + hoff + d;
    dq[o] = s;
    dk[o] = ds_self * qw[d];
    dv[o] = p_self * dc[d];
  }
}

}  // namespace

template <typename T>
static int run_chain_bwd(const ChainArgs& a, cudaStream_t st) {
  const int L = a.L, B = a.B, M = a.M, HD = a.HD, DI = a.DI, H = a.H, V = a.V, n = a.n;
  const int dh = HD / H, KL = M + n;
  const int n_res = a.recompute ? 1 : n;
  auto P = [](const void* p) { return static_cast<const T*>(p); };
  auto W = [](void* p) { return static_cast<T*>(p); };
  const int nw = kBwdThreads / 32;
  const size_t attn_smem = sizeof(float) * (2 * dh + 32 + nw * dh + KL);
  {
    cudaError_t e = tg_allow_smem(chain_attn_bwd_kernel<T>, attn_smem);
    if (e == cudaSuccess) e = tg_allow_smem(chain_attn_fwd_kernel<T>, attn_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto rows = [&](const float* x, int K, const T* w, int N, float* out, int accum,
                  const T* mask, long long ms) -> int {
    const size_t smem = sizeof(float) * K;
    cudaError_t e = tg_allow_smem(gemv_rows_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((N + kRowsWarps - 1) / kRowsWarps, B);
    gemv_rows_kernel<T><<<grid, kRowsWarps * 32, smem, st>>>(x, K, w, N, out, accum,
                                                             mask, ms);
    TG_CHECK();
    return 0;
  };
  auto ln_bwd = [&](const float* dy1, const float* dy2, const T* z, const float* sc,
                    const float* add, float* out) -> int {
    const size_t smem = sizeof(float) * (2 * HD + 32);
    cudaError_t e = tg_allow_smem(ln_bwd_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ln_bwd_kernel<T><<<B, 256, smem, st>>>(dy1, dy2, z, sc, add, out, HD);
    TG_CHECK();
    return 0;
  };
  auto gemv = [&](const T* x, const T* w, int K, int N, const T* bias, T* out) -> int {
    const size_t smem = sizeof(float) * (K + kGemvWarps * 32);
    cudaError_t e = tg_allow_smem(gemv_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((N + kGemvCols - 1) / kGemvCols, B);
    gemv_kernel<T><<<grid, kGemvWarps * 32, smem, st>>>(x, K, w, K, N, bias, 0, out, N, N,
                                                        0);
    TG_CHECK();
    return 0;
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
  auto res_row = [&](void* base, int l, int ts, int width) -> T* {
    return W(base) + (static_cast<long long>(l) * n_res + ts) * B * width;
  };

  {
    const cudaError_t e = cudaMemsetAsync(a.chi, 0, sizeof(float) * B * V, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int rc;
  const long long lane_l = static_cast<long long>(H) * B * KL * dh;
  for (int t = n - 1; t >= 0; --t) {
    const long long tv = static_cast<long long>(t) * B * V;
    st_bwd_kernel<<<B, 256, 0, st>>>(a.S + tv, a.Y + tv, a.chi, a.Q + tv, V,
                                     a.temperature);
    TG_CHECK();
    if (t == 0) break;  // the chi of the token before the chunk is not needed
    const int ts = a.recompute ? 0 : t;
    if (a.recompute) {
      // the token's forward from its id, keeping every layer's activations
      embed_kernel<T><<<B, 256, 0, st>>>(a.ids + t * B, P(a.emb), res_row(a.res_x, 0, 0, HD),
                                         HD);
      TG_CHECK();
      for (int l = 0; l < L; ++l) {
        const long long wl = static_cast<long long>(l) * HD;
        const long long sq = static_cast<long long>(l) * HD * HD;
        const long long f1 = static_cast<long long>(l) * HD * DI;
        T* xin = res_row(a.res_x, l, 0, HD);
        T* z1 = res_row(a.res_z1, l, 0, HD);
        T* z2 = res_row(a.res_z2, l, 0, HD);
        T* ffp = res_row(a.res_ff, l, 0, DI);
        const T* w_in = xin;
        if (a.pre_lnorm) {
          if ((rc = ln(xin, nullptr, a.ln_as + wl, a.ln_ab + wl, nullptr, W(a.w_in), 1)))
            return rc;
          w_in = W(a.w_in);
        }
        if ((rc = gemv(w_in, P(a.q_w) + sq, HD, HD, nullptr, W(a.q)))) return rc;
        chain_attn_fwd_kernel<T><<<dim3(H, B), kBwdThreads, attn_smem, st>>>(
            W(a.q), P(a.kf) + l * lane_l, P(a.vf) + l * lane_l,
            P(a.R) + static_cast<long long>(l) * (M + 1) * HD, P(a.rwb), P(a.rrb),
            a.res_prob + static_cast<long long>(l) * B * H * KL, W(a.ctx), M, KL, HD, dh,
            t, a.count, a.scale);
        TG_CHECK();
        if ((rc = gemv(W(a.ctx), P(a.o_w) + sq, HD, HD, nullptr, W(a.attn)))) return rc;
        const T* ff_in;
        const T* h1;
        if (a.pre_lnorm) {
          // z1 = x + attn; ff_in = LN_f(z1); z2 = z1 + ff
          if ((rc = ln(xin, W(a.attn), a.ln_fs + wl, a.ln_fb + wl, z1, W(a.out), 1)))
            return rc;
          ff_in = W(a.out);
          h1 = z1;
        } else {
          // z1 = x + attn; h1 = ff_in = LN_a(z1); z2 = h1 + ff
          if ((rc = ln(xin, W(a.attn), a.ln_as + wl, a.ln_ab + wl, z1, W(a.out), 1)))
            return rc;
          ff_in = W(a.out);
          h1 = W(a.out);
        }
        if ((rc = gemv(ff_in, P(a.ff1) + f1, HD, DI,
                       P(a.fb1) + static_cast<long long>(l) * DI, ffp)))
          return rc;
        relu_kernel<T><<<(B * DI + 255) / 256, 256, 0, st>>>(ffp, W(a.hid), B * DI);
        TG_CHECK();
        if ((rc = gemv(W(a.hid), P(a.ff2) + f1, DI, HD, P(a.fb2) + wl, W(a.ff)))) return rc;
        T* x_next = l + 1 < L ? res_row(a.res_x, l + 1, 0, HD) : W(a.x);
        if (a.pre_lnorm) {
          if ((rc = ln(h1, W(a.ff), nullptr, nullptr, z2, x_next, 0))) return rc;
        } else {
          if ((rc = ln(h1, W(a.ff), a.ln_fs + wl, a.ln_fb + wl, z2, x_next, 1))) return rc;
        }
      }
    }
    // logits head: dx = q_t @ emb_t^T
    if ((rc = rows(a.Q + tv, V, P(a.emb_t), HD, a.dx, 0, nullptr, 0))) return rc;
    for (int l = L - 1; l >= 0; --l) {
      const long long wl = static_cast<long long>(l) * HD;
      const long long sq = static_cast<long long>(l) * HD * HD;
      const long long f1 = static_cast<long long>(l) * HD * DI;
      const T* xr = res_row(a.res_x, l, ts, HD);
      const T* z1 = res_row(a.res_z1, l, ts, HD);
      const T* z2 = res_row(a.res_z2, l, ts, HD);
      const T* ffp = res_row(a.res_ff, l, ts, DI);
      float* dz2 = a.pre_lnorm ? a.dx : a.dz2;
      if (!a.pre_lnorm && (rc = ln_bwd(a.dx, nullptr, z2, a.ln_fs + wl, nullptr, dz2)))
        return rc;
      if ((rc = rows(dz2, HD, P(a.ff2) + f1, DI, a.dff, 0, ffp, DI))) return rc;
      if ((rc = rows(a.dff, DI, P(a.ff1) + f1, HD, a.dffin, 0, nullptr, 0))) return rc;
      if (a.pre_lnorm) {
        // z2 = z1 + ff, ff_in = LN_f(z1)
        if ((rc = ln_bwd(a.dffin, nullptr, z1, a.ln_fs + wl, dz2, a.dz1))) return rc;
      } else {
        // z2 = h1 + ff, ff_in = h1 = LN_a(z1)
        if ((rc = ln_bwd(dz2, a.dffin, z1, a.ln_as + wl, nullptr, a.dz1))) return rc;
      }
      if ((rc = rows(a.dz1, HD, P(a.o_w) + sq, HD, a.dctx, 0, nullptr, 0))) return rc;
      // the token's query at this layer
      const T* w_in = xr;
      if (a.pre_lnorm) {
        if ((rc = ln(xr, nullptr, a.ln_as + wl, a.ln_ab + wl, nullptr, W(a.w_in), 1)))
          return rc;
        w_in = W(a.w_in);
      }
      if ((rc = gemv(w_in, P(a.q_w) + sq, HD, HD, nullptr, W(a.q)))) return rc;
      const float* prob =
          a.res_prob + (static_cast<long long>(l) * B * H * n_res + ts) * KL;
      chain_attn_bwd_kernel<T><<<dim3(H, B), kBwdThreads, attn_smem, st>>>(
          prob, static_cast<long long>(n_res) * KL, a.dctx, W(a.q), P(a.rwb),
          P(a.kf) + l * lane_l, P(a.vf) + l * lane_l,
          P(a.R) + static_cast<long long>(l) * (M + 1) * HD, a.dq, a.dk, a.dv, M, KL, HD,
          dh, t, a.count, a.scale);
      TG_CHECK();
      if ((rc = rows(a.dq, HD, P(a.q_w) + sq, HD, a.dwin, 0, nullptr, 0))) return rc;
      if ((rc = rows(a.dk, HD, P(a.k_w) + sq, HD, a.dwin, 1, nullptr, 0))) return rc;
      if ((rc = rows(a.dv, HD, P(a.v_w) + sq, HD, a.dwin, 1, nullptr, 0))) return rc;
      if (a.pre_lnorm) {
        if ((rc = ln_bwd(a.dwin, nullptr, xr, a.ln_as + wl, a.dz1, a.dx))) return rc;
      } else {
        const cudaError_t e = cudaMemcpyAsync(a.dx, a.dz1, sizeof(float) * B * HD,
                                              cudaMemcpyDeviceToDevice, st);
        if (e != cudaSuccess) return static_cast<int>(e);
        add_kernel<<<(B * HD + 255) / 256, 256, 0, st>>>(a.dwin, a.dx, B * HD);
        TG_CHECK();
      }
    }
    // embedding: chi for token t - 1
    if ((rc = rows(a.dx, HD, P(a.emb), V, a.chi, 0, nullptr, 0))) return rc;
  }
  return 0;
}

extern "C" int tg_chain_bwd(const ChainArgs* a, void* stream) {
  if (a->HD % a->H != 0 || a->HD / a->H > 32 * kMaxDPL || a->n < 1 || a->n > a->M)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) return run_chain_bwd<float>(*a, st);
  if (a->dtype == 1) return run_chain_bwd_tc(*a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tg_sizeof_chain_args() { return static_cast<int>(sizeof(ChainArgs)); }
