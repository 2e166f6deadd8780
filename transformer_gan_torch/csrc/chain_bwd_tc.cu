// The bf16 reverse straight-through chain (K6, K7) for Hopper (sm_90a), on
// the lane-tiled tensor-core GEMVs of decode_chain_tc.cuh. fp32 keeps
// run_chain_bwd of chain_bwd.cu, the exact on-card reference; tg_chain_bwd
// (chain_bwd.cu) sends dtype 1 here.
//
// Replaces the TPU kernels transformer_gan_tpu/ops/pallas_chain_bwd.py
// _chain_res_kernel (K6) and _chain_kernel (K7); what the chain computes is
// at the top of chain_bwd.cu. As there, one C entry point runs a host loop
// over the tokens (last first) and the layers (last first) on the caller's
// stream; chi [B, V] and the layer's cotangents live in global memory
// (L2-resident). Per token t >= 1 (post-norm; pre-norm alike, its
// LayerNorm backwards elsewhere):
//   head GEMV: Q[t] = st_bwd(S, Y, chi) in the prologue (column block 0
//     writes Q), dx = Q emb_t^T (fp32, and a bf16 copy);
//   per layer: LN_f backward at z2 (a row kernel: dz2 in fp32 and bf16)
//     -> ff2^T GEMV (the ReLU mask of ff_pre in the epilogue) -> ff1^T GEMV
//     (dffin, fp32) -> LN_a backward of dz2 + dffin at z1 (a row kernel:
//     dz1) -> o^T GEMV -> attention backward, one block per (h, b), writing
//     [dq | dk_self | dv_self] as one bf16 row -> qkv^T GEMV, one product
//     for the three (dx = dz1 + it, fp32 residual epilogue);
//   emb^T GEMV: chi = dx emb^T.
// That is 7 launches a layer and 2 a token (44 at L 6; 1 for token 0, whose
// Q alone is needed). K7 first runs the token's forward from its id, 5
// launches a layer on the same engine (q GEMV with the embed gather or the
// last LayerNorm in its prologue, attention forward writing the fp32
// probabilities, o GEMV + residual, FF1 with LayerNorm, bias and ReLU
// keeping ff_pre, FF2 + bias + residual), into the res_* rows the backward
// reads.
//
// What bounds it on the H100, and what the design does about it:
// * Operations and bytes about equally at B 64 (0.11 ms a 59-token chunk;
//   kernel_check.chain_work), and the K/V lanes each token rereads (50 MB a
//   token at count M, more than L2: a streaming floor of ~0.9 ms a chunk,
//   kernel_check.chain_stream_bytes). In practice the chain's latency: the
//   fp32 chain of chain_bwd.cu makes 75 launches a token, with GEMVs that
//   read every weight once per lane on the CUDA cores.
// * The backward product out[b, n] = sum_k x[b, k] W[n, k] takes the forward
//   weight as stored as the engine's W^T operand, padded
//   (ops/decode_params.chain_bwd_operands), so each weight is read once for
//   up to 64 lanes by mma.sync; dq, dk and dv share one product.
// * Cotangents stay fp32: a product's input rows are rounded to bf16 in its
//   prologue, its output is fp32 where a norm or a residual reads it and a
//   bf16 copy where only the next product does. The row ops (st_bwd, the
//   LayerNorm backwards) run in fp32, one warp a row: st_bwd in the head
//   GEMV's prologue, each LayerNorm backward in a row kernel of its own (B
//   blocks) that writes the fp32 row and its bf16 copy; in the prologues
//   (kLnBwdKernels false, the alternative profile_chain --ablate times) each
//   of a GEMV's column blocks would redo them.
// * The token's query comes from the window pass (res_q; K7: from its own
//   forward), off the serial path. The attention blocks copy the token's K,
//   V and head-major R rows, three flat runs of 100-byte rows, into shared
//   memory by 16-byte cp.async before they wait.
// * Every kernel is launched with programmatic dependent launch (PDL): it
//   loads its weights, LayerNorm parameters and lane rows before pdl_wait.
//   Before the wait a kernel reads nothing that a kernel of the same call
//   writes (K7's res_* rows are read after it).
// Rounding follows the plain chain in the compute type: each product's
// inputs rounded to bf16, sums and cotangents fp32; K7's forward rounds as
// decode_chain_tc.cuh does. Sums run in a fixed order, no atomics.
#include "chain_args.cuh"
#include "decode_chain_tc.cuh"

namespace {

// The layout ops/chain_bwd.chain_lib checks on every call
// (tg_chain_bwd_layout): the operands' padding (kKAlign, kGemvN of
// decode_chain_tc.cuh), the largest d_head and the widest row a row op takes.
constexpr int kChainMaxDh = 64;    // a head's row is at most 32 bf16 pairs
constexpr int kRowMax = 512;       // HD and V at most this
constexpr int kRowPer = kRowMax / 32;  // values of a row a lane holds
constexpr int kChainAttnThreads = 128;
// LayerNorm backward in a row kernel of its own before the GEMV that
// consumes it (true) or in that GEMV's prologue (false); profile_chain
// --ablate flips it. In the prologue every one of the GEMV's N / 8 column
// blocks redoes the row op over all its lane rows: on an H100 that made K6
// 2.1x slower (28.75 against 13.95 ms at n 59, B 64).
constexpr bool kLnBwdKernels = true;

// The fp32 row a reverse-chain product takes, one warp a row (lane holds
// k = lane + 32 i):
//   st_bwd (S set): v = Y (m - <m, Y>) / T, m = S + dy1 (dy1: chi, null = 0);
//   else v = dy1 + dy2 (dy2 optional), with scale the LayerNorm backward at
//   z: g = v scale, zh = (z - mean z) rstd,
//   v = (g - mean(g) - zh mean(g zh)) rstd; then v += add (optional).
// All [B, K] rows dense; z bf16 (the sum the forward normalized).
struct RowOp {
  const float* dy1;
  const float* dy2;
  const float* add;
  const bf16* z;
  const float* scale;
  const float* S;
  const float* Y;
  float temperature;
  float* keep;  // [B, K] the fp32 row (GEMV column block 0, or the row kernel)
};

__device__ __forceinline__ void row_op(const RowOp& op, int b, int K, float (&v)[kRowPer]) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(b) * K;
  const float rk = 1.f / K;
  if (op.S != nullptr) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int k = lane + 32 * i;
      v[i] = 0.f;
      if (k < K) {
        v[i] = op.S[row + k] + (op.dy1 != nullptr ? op.dy1[row + k] : 0.f);
        dot += v[i] * op.Y[row + k];
      }
    }
    dot = warp_sum(dot);
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int k = lane + 32 * i;
      if (k < K) v[i] = (op.Y[row + k] * (v[i] - dot)) / op.temperature;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kRowPer; ++i) {
    const int k = lane + 32 * i;
    v[i] = k < K ? op.dy1[row + k] + (op.dy2 != nullptr ? op.dy2[row + k] : 0.f) : 0.f;
  }
  if (op.scale != nullptr) {
    float zc[kRowPer];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int k = lane + 32 * i;
      zc[i] = k < K ? __bfloat162float(op.z[row + k]) : 0.f;
      s += zc[i];
    }
    const float mean = warp_sum(s) * rk;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int k = lane + 32 * i;
      zc[i] = k < K ? zc[i] - mean : 0.f;
      s2 += zc[i] * zc[i];
    }
    const float rstd = rsqrtf(warp_sum(s2) * rk + 1e-5f);
    float sg = 0.f, sgz = 0.f;
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int k = lane + 32 * i;
      if (k < K) {
        v[i] *= op.scale[k];
        zc[i] *= rstd;
        sg += v[i];
        sgz += v[i] * zc[i];
      }
    }
    const float mg = warp_sum(sg) * rk, mgz = warp_sum(sgz) * rk;
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) v[i] = (v[i] - mg - zc[i] * mgz) * rstd;
  }
  if (op.add != nullptr)
#pragma unroll
    for (int i = 0; i < kRowPer; ++i) {
      const int k = lane + 32 * i;
      if (k < K) v[i] += op.add[row + k];
    }
}

// A reverse-chain GEMV's input: bf16 rows as the forward chain takes them
// (f: a copy, an embed gather, a LayerNorm; row == 0), or rows made by a
// row op (row == 1).
struct ChainIn {
  GemvIn f;
  RowOp op;
  int row;
};

// What a reverse-chain GEMV does with the product s of lane b, column n
// (every row dense, N wide):
//   fwd (K7's forward, as GemvIo): y = rnd(s); + bias, rounded; pre = y
//     (ff_pre); ReLU; + res_h, rounded;
//   else (the backward, fp32): y = s, 0 where mask <= 0 (the ReLU's
//     backward at ff_pre); + res_f;
//   then out_f = y (fp32) and out_h = rnd(y) (bf16), each optional.
struct ChainOut {
  int fwd;
  const bf16* bias;
  int relu;
  const bf16* res_h;
  bf16* pre;
  const bf16* mask;
  const float* res_f;
  float* out_f;
  bf16* out_h;
};

struct ChainIo {
  using In = ChainIn;
  using Out = ChainOut;
  __device__ static __forceinline__ const float* ln_s(const ChainIn& in) { return in.f.ln_s; }
  __device__ static __forceinline__ const float* ln_b(const ChainIn& in) { return in.f.ln_b; }
  __device__ static __forceinline__ void prologue(const ChainIn& in, bf16* xs, int ks, int b0,
                                                  int nb, int K, const float* lnw, int warps) {
    if (!in.row) {
      gemv_prologue(in.f, xs, ks, b0, nb, K, lnw, warps);
      return;
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < nb; r += warps) {
      float v[kRowPer];
      row_op(in.op, b0 + r, K, v);
      bf16* xr = xs + r * ks;
      float* keep = in.op.keep != nullptr && blockIdx.x == 0
                        ? in.op.keep + static_cast<long long>(b0 + r) * K
                        : nullptr;
#pragma unroll
      for (int i = 0; i < kRowPer; ++i) {
        const int k = lane + 32 * i;
        if (k < K) {
          xr[k] = __float2bfloat16_rn(v[i]);
          if (keep != nullptr) keep[k] = v[i];
        }
      }
    }
  }
  __device__ static __forceinline__ void store(const ChainOut& o, int b, int n, int N, float s) {
    const long long i = static_cast<long long>(b) * N + n;
    float y = s;
    if (o.fwd) {
      y = rnd<bf16>(y);
      if (o.bias != nullptr) y = rnd<bf16>(y + __bfloat162float(o.bias[n]));
      if (o.pre != nullptr) o.pre[i] = __float2bfloat16_rn(y);
      if (o.relu) y = fmaxf(y, 0.f);
      if (o.res_h != nullptr) y = rnd<bf16>(__bfloat162float(o.res_h[i]) + y);
    } else {
      if (o.mask != nullptr && !(__bfloat162float(o.mask[i]) > 0.f)) y = 0.f;
      if (o.res_f != nullptr) y += o.res_f[i];
    }
    if (o.out_f != nullptr) o.out_f[i] = y;
    if (o.out_h != nullptr) o.out_h[i] = __float2bfloat16_rn(y);
  }
};

// A row op over every lane, one warp (block) a lane: keep = the fp32 row,
// out_h = its bf16 copy (optional). The LayerNorm backward's own kernel
// (kLnBwdKernels) and token 0's st_bwd.
__global__ void __launch_bounds__(32) row_op_kernel(RowOp op, int K, bf16* __restrict__ out_h) {
  pdl_wait();
  pdl_trigger();
  const int b = blockIdx.x, lane = threadIdx.x;
  float v[kRowPer];
  row_op(op, b, K, v);
  const long long row = static_cast<long long>(b) * K;
#pragma unroll
  for (int i = 0; i < kRowPer; ++i) {
    const int k = lane + 32 * i;
    if (k < K) {
      if (op.keep != nullptr) op.keep[row + k] = v[i];
      if (out_h != nullptr) out_h[row + k] = __float2bfloat16_rn(v[i]);
    }
  }
}

// Shared memory of the attention kernels: the token's K, R and V rows
// (three runs of nk dh-long rows, each tile offset to its source's
// alignment), then floats.
__host__ __device__ inline int lane_tile_bytes(int KL, int dh) {
  return (KL * dh * 2 + 16 + 15) & ~15;
}

__host__ inline size_t chain_attn_smem(int KL, int dh) {
  const int nrg = kChainAttnThreads / (dh / 2);
  return sizeof(float4) * 32 + 3 * static_cast<size_t>(lane_tile_bytes(KL, dh)) +
         sizeof(float) * (nrg * dh + 32 + 2 * KL);
}

// Token t's K, R, V rows of head h, lane b: lanes jlo .. jlo + nk - 1 of the
// h-major lane buffers kf / vf [H, B, KL, dh] and the head-major R rows
// jlo - t .. of Rh [H, M + 1, dh] (lane j at distance M + t - j), by
// 16-byte cp.async (one commit group).
__device__ __forceinline__ void copy_lane_rows(unsigned char* buf, int buf_bytes,
                                               const bf16* kf, const bf16* vf,
                                               const bf16* Rh, long long hb, int h, int M,
                                               int KL, int dh, int jlo, int nk, int t,
                                               const uint32_t** kt, const uint32_t** rt,
                                               const uint32_t** vt) {
  const int nbytes = nk * dh * 2;
  const unsigned char* src[3] = {
      reinterpret_cast<const unsigned char*>(kf + (hb * KL + jlo) * dh),
      reinterpret_cast<const unsigned char*>(Rh + (static_cast<long long>(h) * (M + 1) + jlo - t) * dh),
      reinterpret_cast<const unsigned char*>(vf + (hb * KL + jlo) * dh)};
  const uint32_t** dst[3] = {kt, rt, vt};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    unsigned char* tile = buf + i * buf_bytes + (reinterpret_cast<uintptr_t>(src[i]) & 15);
    flat_copy(tile, src[i], nbytes);
    *dst[i] = reinterpret_cast<const uint32_t*>(tile);
  }
  tc::cp_async_commit();
}

// Attention backward of token t for one layer, block (h, b): lanes
// jlo .. M + t (jlo = min(M, max(M - count, t))), every one constant but
// the token's own (M + t). prob: the token's fp32 probabilities (row (b, h)
// at prob + (b H + h) prob_bh, lane j at j); dctx, qres [B, HD] bf16
// (qres: w_in q_w, the token's query). With qw = rnd(q + r_w_bias),
// dP = dctx . V, D = <P, dP>, dS = P (dP - D) scale:
//   dq = sum_j rnd(dS_j) (K_j + R_j), dk_self = dS_self qw,
//   dv_self = P_self dctx,
// written rounded to bf16 into the row [dq | dk | dv] of dqkv [B, 3 HD].
__global__ void __launch_bounds__(kChainAttnThreads)
chain_attn_bwd_tc_kernel(const float* __restrict__ prob, long long prob_bh,
                      const bf16* __restrict__ dctx, const bf16* __restrict__ qres,
                      const bf16* __restrict__ rwb, const bf16* __restrict__ kf,
                      const bf16* __restrict__ vf, const bf16* __restrict__ Rh,
                      bf16* __restrict__ dqkv, int M, int KL, int HD, int dh, int t,
                      int count, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, B = gridDim.y;
  const long long hb = static_cast<long long>(h) * B + b;
  const int tid = threadIdx.x;
  const int dw = dh / 2, nrg = kChainAttnThreads / dw;
  const int rg = tid / dw, w = tid - rg * dw;
  const int jlo = min(M, max(M - count, t)), nk = M + t - jlo + 1;
  const int buf_bytes = lane_tile_bytes(KL, dh);
  float2* qw2 = reinterpret_cast<float2*>(smem_raw);  // [32] q + r_w_bias
  float2* dc2 = qw2 + 32;                             // [32] dctx
  unsigned char* buf = smem_raw + sizeof(float4) * 32;
  float* part = reinterpret_cast<float*>(buf + 3 * buf_bytes);  // [nrg][dh]
  float* red = part + nrg * dh;                                 // [32]
  float* pr = red + 32;                                         // [nk] P
  float* sd = pr + KL;                                          // [nk] dP, then dS

  const uint32_t *kt, *rt, *vt;
  copy_lane_rows(buf, buf_bytes, kf, vf, Rh, hb, h, M, KL, dh, jlo, nk, t, &kt, &rt, &vt);
  pdl_wait();
  pdl_trigger();
  const int hoff = h * dh;
  if (tid < dw) {
    const float2 q = bf2(reinterpret_cast<const uint32_t*>(qres + b * HD + hoff)[tid]);
    const float2 wb = bf2(reinterpret_cast<const uint32_t*>(rwb + hoff)[tid]);
    qw2[tid] = make_float2(rnd<bf16>(q.x + wb.x), rnd<bf16>(q.y + wb.y));
    dc2[tid] = bf2(reinterpret_cast<const uint32_t*>(dctx + b * HD + hoff)[tid]);
  }
  const float* prow = prob + (static_cast<long long>(b) * H + h) * prob_bh + jlo;
  for (int i = tid; i < nk; i += kChainAttnThreads) pr[i] = prow[i];
  tc::cp_async_wait<0>();
  __syncthreads();

  float pdp = 0.f;
  for (int r = tid; r < nk; r += kChainAttnThreads) {
    float dp = 0.f;
    for (int i = 0; i < dw; ++i) {
      const float2 c = dc2[i], v = bf2(vt[r * dw + i]);
      dp += c.x * v.x + c.y * v.y;
    }
    sd[r] = dp;
    pdp += dp * pr[r];
  }
  const float D = block_sum(pdp, red);  // syncs
  for (int r = tid; r < nk; r += kChainAttnThreads) sd[r] = pr[r] * (sd[r] - D) * scale;
  __syncthreads();
  if (rg < nrg) {
    float2 acc = make_float2(0.f, 0.f);
    for (int r = rg; r < nk; r += nrg) {
      const float ds = rnd<bf16>(sd[r]);
      const float2 k = bf2(kt[r * dw + w]), rr = bf2(rt[r * dw + w]);
      acc.x += ds * (k.x + rr.x);
      acc.y += ds * (k.y + rr.y);
    }
    part[rg * dh + 2 * w] = acc.x;
    part[rg * dh + 2 * w + 1] = acc.y;
  }
  __syncthreads();
  if (tid < dh) {
    float s = 0.f;
    for (int g = 0; g < nrg; ++g) s += part[g * dh + tid];
    const float2 q2 = qw2[tid >> 1], c2 = dc2[tid >> 1];
    const float qw = tid & 1 ? q2.y : q2.x, dc = tid & 1 ? c2.y : c2.x;
    bf16* o = dqkv + static_cast<long long>(b) * 3 * HD + hoff + tid;
    o[0] = __float2bfloat16_rn(s);
    o[HD] = __float2bfloat16_rn(sd[nk - 1] * qw);
    o[2 * HD] = __float2bfloat16_rn(pr[nk - 1] * dc);
  }
}

// K7's attention forward of token t for one layer, block (h, b), over the
// same lanes: s = rnd(rnd(qw . k) + rnd(qr . r)) scale, P = softmax(s);
// writes P over all KL lanes in fp32 (0 outside the window; row (b, h) at
// prob + (b H + h) KL) and ctx = rnd(sum_j rnd(P_j) v_j) [B, HD].
__global__ void __launch_bounds__(kChainAttnThreads)
chain_attn_fwd_tc_kernel(const bf16* __restrict__ qb, const bf16* __restrict__ kf,
                      const bf16* __restrict__ vf, const bf16* __restrict__ Rh,
                      const bf16* __restrict__ rwb, const bf16* __restrict__ rrb,
                      float* __restrict__ prob, bf16* __restrict__ ctx, int M, int KL, int HD,
                      int dh, int t, int count, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, B = gridDim.y;
  const long long hb = static_cast<long long>(h) * B + b;
  const int tid = threadIdx.x;
  const int dw = dh / 2, nrg = kChainAttnThreads / dw;
  const int rg = tid / dw, w = tid - rg * dw;
  const int jlo = min(M, max(M - count, t)), nk = M + t - jlo + 1;
  const int buf_bytes = lane_tile_bytes(KL, dh);
  float4* qq = reinterpret_cast<float4*>(smem_raw);  // [32] (qw, qr) pairs
  unsigned char* buf = smem_raw + sizeof(float4) * 32;
  float* part = reinterpret_cast<float*>(buf + 3 * buf_bytes);  // [nrg][dh]
  float* red = part + nrg * dh;                                 // [32]
  float* sc = red + 32;                                         // [nk]

  const uint32_t *kt, *rt, *vt;
  copy_lane_rows(buf, buf_bytes, kf, vf, Rh, hb, h, M, KL, dh, jlo, nk, t, &kt, &rt, &vt);
  pdl_wait();
  pdl_trigger();
  const int hoff = h * dh;
  if (tid < dw) {
    const float2 qv = bf2(reinterpret_cast<const uint32_t*>(qb + b * HD + hoff)[tid]);
    const float2 wb = bf2(reinterpret_cast<const uint32_t*>(rwb + hoff)[tid]);
    const float2 rb = bf2(reinterpret_cast<const uint32_t*>(rrb + hoff)[tid]);
    qq[tid] = make_float4(rnd<bf16>(qv.x + wb.x), rnd<bf16>(qv.y + wb.y),
                          rnd<bf16>(qv.x + rb.x), rnd<bf16>(qv.y + rb.y));
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  float lmax = -INFINITY;
  for (int r = tid; r < nk; r += kChainAttnThreads) {
    float ac = 0.f, bd = 0.f;
    for (int i = 0; i < dw; ++i) {
      const float4 q4 = qq[i];
      const float2 kv = bf2(kt[r * dw + i]), rv = bf2(rt[r * dw + i]);
      ac += q4.x * kv.x + q4.y * kv.y;
      bd += q4.z * rv.x + q4.w * rv.y;
    }
    const float s = rnd<bf16>(rnd<bf16>(ac) + rnd<bf16>(bd)) * scale;
    sc[r] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = block_max(lmax, red);  // syncs
  float lsum = 0.f;
  for (int r = tid; r < nk; r += kChainAttnThreads) {
    const float e = expf(sc[r] - m);
    sc[r] = e;
    lsum += e;
  }
  const float l = block_sum(lsum, red);  // syncs
  float* prow = prob + (static_cast<long long>(b) * H + h) * KL;
  for (int j = tid; j < KL; j += kChainAttnThreads)
    prow[j] = j >= jlo && j < jlo + nk ? sc[j - jlo] / l : 0.f;
  if (rg < nrg) {
    float2 acc = make_float2(0.f, 0.f);
    for (int r = rg; r < nk; r += nrg) {
      const float p = rnd<bf16>(sc[r] / l);
      const float2 v = bf2(vt[r * dw + w]);
      acc.x += p * v.x;
      acc.y += p * v.y;
    }
    part[rg * dh + 2 * w] = acc.x;
    part[rg * dh + 2 * w + 1] = acc.y;
  }
  __syncthreads();
  if (tid < dh) {
    float s = 0.f;
    for (int g = 0; g < nrg; ++g) s += part[g * dh + tid];
    ctx[b * HD + hoff + tid] = __float2bfloat16_rn(s);
  }
}

}  // namespace

int run_chain_bwd_tc(const ChainArgs& a, cudaStream_t st) {
  const int L = a.L, B = a.B, M = a.M, HD = a.HD, DI = a.DI, H = a.H, V = a.V, n = a.n;
  const int dh = HD / H, KL = M + n;
  const int n_res = a.recompute ? 1 : n;
  const bool pre = a.pre_lnorm != 0;
  if (dh % 2 != 0 || dh > kChainMaxDh || HD > kRowMax || V > kRowMax || DI % 2 != 0 ||
      a.qkv_bwd == nullptr || a.o_bwd == nullptr || a.ff1_bwd == nullptr ||
      a.ff2_bwd == nullptr || a.emb_t_bwd == nullptr || a.emb_bwd == nullptr ||
      a.R_h == nullptr || a.res_q == nullptr ||
      (a.recompute && (a.qkv_t == nullptr || a.o_t == nullptr || a.ff1_t == nullptr ||
                       a.ff2_t == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto P = [](const void* p) { return static_cast<const bf16*>(p); };
  auto W = [](void* p) { return static_cast<bf16*>(p); };
  const int Kh = kpad(HD), Kd = kpad(DI);

  const int lanes = B < kLaneTile ? B : kLaneTile;
  const int MT = (lanes + 15) / 16;
  const int GW = MT <= 2 ? 8 : 16;  // a GEMV block's warps
  // the widest product: qkv^T (3 HD) without a LayerNorm, or K7's with one
  auto smem_of = [&](int K, bool ln) {
    return gemv_smem(MT, GW, K) - (ln ? 0 : sizeof(float) * 2 * K);
  };
  const int widths[3] = {HD, DI, V};
  size_t gmax = smem_of(3 * HD, false);
  for (int K : widths) gmax = gmax > smem_of(K, true) ? gmax : smem_of(K, true);
  cudaError_t e = cudaSuccess;
  switch (MT) {
    case 1: e = tg_allow_smem(tc_gemv_kernel<1, 8, ChainIo>, gmax); break;
    case 2: e = tg_allow_smem(tc_gemv_kernel<2, 8, ChainIo>, gmax); break;
    case 3: e = tg_allow_smem(tc_gemv_kernel<3, 16, ChainIo>, gmax); break;
    default: e = tg_allow_smem(tc_gemv_kernel<4, 16, ChainIo>, gmax); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t asmem = chain_attn_smem(KL, dh);
  if ((e = tg_allow_smem(chain_attn_bwd_tc_kernel, asmem)) != cudaSuccess ||
      (e = tg_allow_smem(chain_attn_fwd_tc_kernel, asmem)) != cudaSuccess)
    return static_cast<int>(e);

  auto gemv = [&](const ChainIn& in, const bf16* Wt, int K, int N, const ChainOut& o) -> int {
    dim3 grid(npad(N) / kGemvN, (B + kLaneTile - 1) / kLaneTile);
    const size_t smem = smem_of(K, in.f.ln_s != nullptr);
    const int th = GW * 32;
    cudaError_t err;
    switch (MT) {
      case 1:
        err = launch_pdl(tc_gemv_kernel<1, 8, ChainIo>, grid, th, smem, st, in, Wt, K, N, o, B);
        break;
      case 2:
        err = launch_pdl(tc_gemv_kernel<2, 8, ChainIo>, grid, th, smem, st, in, Wt, K, N, o, B);
        break;
      case 3:
        err = launch_pdl(tc_gemv_kernel<3, 16, ChainIo>, grid, th, smem, st, in, Wt, K, N, o, B);
        break;
      default:
        err = launch_pdl(tc_gemv_kernel<4, 16, ChainIo>, grid, th, smem, st, in, Wt, K, N, o, B);
        break;
    }
    return static_cast<int>(err);
  };
  auto rows_in = [](const bf16* src, int K) {
    ChainIn in{};
    in.f.src = src;
    in.f.src_stride = K;
    return in;
  };
  // a product's input from a row op: in its prologue, or (kLnBwdKernels, a
  // LayerNorm backward) from a row kernel of its own into dz_h
  auto row_in = [&](const RowOp& op, int K, ChainIn* in) -> int {
    if (kLnBwdKernels && op.scale != nullptr) {
      *in = rows_in(W(a.dz_h), K);
      return static_cast<int>(
          launch_pdl(row_op_kernel, dim3(B), 32, 0, st, op, K, W(a.dz_h)));
    }
    *in = ChainIn{};
    in->op = op;
    in->row = 1;
    return 0;
  };
  auto res_row = [&](void* base, int l, int ts, int width) -> bf16* {
    return W(base) + (static_cast<long long>(l) * n_res + ts) * B * width;
  };
  const long long lane_l = static_cast<long long>(H) * B * KL * dh;
  const bf16* kf = P(a.kf);
  const bf16* vf = P(a.vf);

  // K7: token t's forward from its id, into the res_* rows at ts = 0
  auto forward = [&](int t) -> int {
    int rc;
    for (int l = 0; l < L; ++l) {
      const long long wl = static_cast<long long>(l) * HD;
      bf16* xin = res_row(a.res_x, l, 0, HD);
      bf16* z1 = res_row(a.res_z1, l, 0, HD);
      bf16* z2 = res_row(a.res_z2, l, 0, HD);
      bf16* q = res_row(a.res_q, l, 0, HD);
      // q: the first HD rows of qkv_t; input the embedding (layer 0) or the
      // last layer's z2, post-LN'd; pre-LN keeps x raw and feeds LN_a(x)
      ChainIn in{};
      if (l == 0) {
        in.f.ids = a.ids + static_cast<long long>(t) * B;
        in.f.emb = P(a.emb);
      } else {
        in.f.src = res_row(a.res_z2, l - 1, 0, HD);
        in.f.src_stride = HD;
      }
      if (pre) {
        in.f.ln_s = a.ln_as + wl;
        in.f.ln_b = a.ln_ab + wl;
      } else if (l > 0) {
        in.f.ln_s = a.ln_fs + wl - HD;
        in.f.ln_b = a.ln_fb + wl - HD;
      }
      in.f.keep = xin;
      in.f.keep_ln = pre ? 0 : 1;
      ChainOut o{};
      o.fwd = 1;
      o.out_h = q;
      if ((rc = gemv(in, P(a.qkv_t) + static_cast<long long>(l) * npad(3 * HD) * Kh, HD, HD,
                     o)))
        return rc;
      if ((rc = launch_pdl(chain_attn_fwd_tc_kernel, dim3(H, B), kChainAttnThreads, asmem, st,
                           static_cast<const bf16*>(q), kf + l * lane_l, vf + l * lane_l,
                           P(a.R_h) + static_cast<long long>(l) * (M + 1) * HD, P(a.rwb),
                           P(a.rrb), a.res_prob + static_cast<long long>(l) * B * H * KL,
                           W(a.ctx), M, KL, HD, dh, t, a.count, a.scale)))
        return rc;
      // o: z1 = rnd(x + rnd(ctx W_o))
      in = rows_in(W(a.ctx), HD);
      o = ChainOut{};
      o.fwd = 1;
      o.res_h = xin;
      o.out_h = z1;
      if ((rc = gemv(in, P(a.o_t) + static_cast<long long>(l) * npad(HD) * Kh, HD, HD, o)))
        return rc;
      // FF1: post-LN h1 = LN_a(z1) (kept for FF2's residual); pre-LN LN_f(z1)
      in = rows_in(z1, HD);
      in.f.ln_s = (pre ? a.ln_fs : a.ln_as) + wl;
      in.f.ln_b = (pre ? a.ln_fb : a.ln_ab) + wl;
      if (!pre) {
        in.f.keep = W(a.out);
        in.f.keep_ln = 1;
      }
      o = ChainOut{};
      o.fwd = 1;
      o.bias = P(a.fb1) + static_cast<long long>(l) * DI;
      o.pre = res_row(a.res_ff, l, 0, DI);
      o.relu = 1;
      o.out_h = W(a.hid);
      if ((rc = gemv(in, P(a.ff1_t) + static_cast<long long>(l) * npad(DI) * Kh, HD, DI, o)))
        return rc;
      // FF2: z2 = rnd(h1 + rnd(rnd(hid W_2) + b_2))
      in = rows_in(W(a.hid), DI);
      o = ChainOut{};
      o.fwd = 1;
      o.bias = P(a.fb2) + wl;
      o.res_h = pre ? z1 : W(a.out);
      o.out_h = z2;
      if ((rc = gemv(in, P(a.ff2_t) + static_cast<long long>(l) * npad(HD) * Kd, DI, HD, o)))
        return rc;
    }
    return 0;
  };

  int rc;
  for (int t = n - 1; t >= 0; --t) {
    const long long tv = static_cast<long long>(t) * B * V;
    RowOp stb{};
    stb.S = a.S + tv;
    stb.Y = a.Y + tv;
    stb.dy1 = t == n - 1 ? nullptr : a.chi;  // chi of the last token is 0
    stb.temperature = a.temperature;
    stb.keep = a.Q + tv;
    if (t == 0) {  // Q[0] alone: the chi of the token before the chunk is not needed
      if ((rc = static_cast<int>(
               launch_pdl(row_op_kernel, dim3(B), 32, 0, st, stb, V, static_cast<bf16*>(nullptr)))))
        return rc;
      break;
    }
    const int ts = a.recompute ? 0 : t;
    if (a.recompute && (rc = forward(t))) return rc;
    // head: Q[t] in the prologue, dx = Q emb_t^T (fp32 + bf16 copy)
    ChainIn in{};
    in.op = stb;
    in.row = 1;
    ChainOut o{};
    o.out_f = a.dx;
    o.out_h = W(a.dx_h);
    if ((rc = gemv(in, P(a.emb_t_bwd), V, HD, o))) return rc;
    for (int l = L - 1; l >= 0; --l) {
      const long long wl = static_cast<long long>(l) * HD;
      const bf16* z1 = res_row(a.res_z1, l, ts, HD);
      const bf16* z2 = res_row(a.res_z2, l, ts, HD);
      // ff2^T: dff = [ff_pre > 0] (dz2 ff2^T); post-LN dz2 = LN_f'(dx) at
      // z2; pre-LN dz2 = dx (the head's, or dz1 + LN_a'(dwin) at the input
      // of layer l + 1)
      const float* dz2 = a.dz2;
      RowOp op{};
      if (!pre) {
        op.dy1 = a.dx;
        op.z = z2;
        op.scale = a.ln_fs + wl;
        op.keep = a.dz2;
        if ((rc = row_in(op, HD, &in))) return rc;
      } else if (l == L - 1) {
        in = rows_in(W(a.dx_h), HD);
        dz2 = a.dx;
      } else {
        op.dy1 = a.dwin;
        op.z = res_row(a.res_x, l + 1, ts, HD);
        op.scale = a.ln_as + wl + HD;
        op.add = a.dz1;
        op.keep = a.dz2;
        if ((rc = row_in(op, HD, &in))) return rc;
      }
      o = ChainOut{};
      o.mask = res_row(a.res_ff, l, ts, DI);
      o.out_h = W(a.dff_h);
      if ((rc = gemv(in, P(a.ff2_bwd) + static_cast<long long>(l) * npad(DI) * Kh, HD, DI, o)))
        return rc;
      // ff1^T: dffin = dff ff1^T
      o = ChainOut{};
      o.out_f = a.dffin;
      if ((rc = gemv(rows_in(W(a.dff_h), DI),
                     P(a.ff1_bwd) + static_cast<long long>(l) * npad(HD) * Kd, DI, HD, o)))
        return rc;
      // o^T: dctx = dz1 o_w^T; post-LN dz1 = LN_a'(dz2 + dffin) at z1,
      // pre-LN dz1 = dz2 + LN_f'(dffin) at z1
      op = RowOp{};
      op.z = z1;
      op.keep = a.dz1;
      if (!pre) {
        op.dy1 = dz2;
        op.dy2 = a.dffin;
        op.scale = a.ln_as + wl;
      } else {
        op.dy1 = a.dffin;
        op.scale = a.ln_fs + wl;
        op.add = dz2;
      }
      if ((rc = row_in(op, HD, &in))) return rc;
      o = ChainOut{};
      o.out_h = W(a.dctx_h);
      if ((rc = gemv(in, P(a.o_bwd) + static_cast<long long>(l) * npad(HD) * Kh, HD, HD, o)))
        return rc;
      // attention backward: [dq | dk_self | dv_self]
      if ((rc = launch_pdl(chain_attn_bwd_tc_kernel, dim3(H, B), kChainAttnThreads, asmem, st,
                           static_cast<const float*>(a.res_prob) +
                               (static_cast<long long>(l) * B * H * n_res + ts) * KL,
                           static_cast<long long>(n_res) * KL,
                           static_cast<const bf16*>(W(a.dctx_h)),
                           static_cast<const bf16*>(res_row(a.res_q, l, ts, HD)), P(a.rwb),
                           kf + l * lane_l, vf + l * lane_l,
                           P(a.R_h) + static_cast<long long>(l) * (M + 1) * HD, W(a.dqkv_h), M,
                           KL, HD, dh, t, a.count, a.scale)))
        return rc;
      // qkv^T: dwin = [dq | dk | dv] qkv_w^T; post-LN dx = dz1 + dwin
      o = ChainOut{};
      if (!pre) {
        o.res_f = a.dz1;
        o.out_f = a.dx;
        if (l == 0) o.out_h = W(a.dx_h);
      } else {
        o.out_f = a.dwin;
      }
      if ((rc = gemv(rows_in(W(a.dqkv_h), 3 * HD),
                     P(a.qkv_bwd) + static_cast<long long>(l) * npad(HD) * kpad(3 * HD), 3 * HD,
                     HD, o)))
        return rc;
    }
    // emb^T: chi = dx emb^T; pre-LN dx = dz1 + LN_a'(dwin) at layer 0's input
    if (!pre) {
      in = rows_in(W(a.dx_h), HD);
    } else {
      RowOp op{};
      op.dy1 = a.dwin;
      op.z = res_row(a.res_x, 0, ts, HD);
      op.scale = a.ln_as;
      op.add = a.dz1;
      if ((rc = row_in(op, HD, &in))) return rc;
    }
    o = ChainOut{};
    o.out_f = a.chi;
    if ((rc = gemv(in, P(a.emb_bwd), HD, V, o))) return rc;
  }
  return 0;
}

extern "C" void tg_chain_bwd_layout(int* out) {
  out[0] = kKAlign;
  out[1] = kGemvN;
  out[2] = kChainMaxDh;
  out[3] = kRowMax;
}
