// K1b in bf16: Transformer-XL attention backward with the relative position
// term built inside the tiles, on Hopper's tensor cores (sm_90a, mma.sync
// m16n8k16 bf16 -> fp32).
//
// Replaces pallas_attention_v2._bwd_kernel (reached through _bwd_raw) of
// transformer_gan_tpu/ops for bf16 inputs; tg_xl_attn_bwd (attention_bwd.cu)
// sends bf16 K1b here, keeps fp32 on the CUDA-core kernels of
// attention_bwd.cu (the exact on-card reference of the fp32 checks) and
// adds the batch splits of drk in a fixed order (xl_attn_bwd_drk_reduce).
// Same function and rounding points as those kernels: P = exp(S - m) / l
// from the forward's row max and sum, with S = qrw k^T + BD recomputed as
// K1f builds it (attention_v2_tc.cu); the forward's dropout mask from the
// (seed, bh, i, j) hash; dS = P (dP - D) with D = rowsum(dout * o), and dS
// and P_drop rounded to bf16 before the products; fp32 accumulation rounded
// once on store; drk stays fp32. dout arrives in fp32 and is rounded to
// bf16 once for the tensor cores (dP and dv read it), as in K2b.
//
// What bounds it on the H100: bytes. At the MLE step's shape (H 10, B 128,
// q 128, M 1024, d_head 50) it reads the memory K/V once (262 MB of 464
// MB), 0.138 ms at 3.35 TB/s; its 1.3e11 flops take 0.13 ms on the tensor
// cores. The CUDA-core kernels it replaces recomputed the scores three
// times with fp32 50-long dot products on one lane a score.
// Design: FlashAttention-2's split of the sums by what they are indexed by,
// without atomics (dR is the same from run to run):
//   * prologue: D = rowsum(dout * o) and dout in bf16 (K2b's);
//   * row pass, one block of 4 warps per (64-row query tile, bh): walks the
//     key tiles the forward visits (K, V double-buffered, rk through a
//     ring of three 64-row segments), recomputes S (BD from
//     W = Qrr RK_win^T skewed, tc::skew) and dP = dout V^T, and accumulates
//     dqrw += dS K and dqrr += dW RK_win, where dW is dS written skewed into
//     a per-warp bf16 scratch (16 x 80, the transpose of the forward's skew;
//     the positions outside the band stay zero), taken as five k-steps. It
//     also writes dW to device memory in rk-row order, [BH, q, M + 2q] bf16
//     with zeros off the band (419 MB at the MLE shape, written once, read
//     once): unlike the TPU kernel, which keeps everything score-sized in
//     VMEM, this saves the drk pass a third recompute of the scores;
//   * key pass over the current keys only (the memory is detached), one
//     block per (64-key tile of j >= M, bh): walks the query tiles that see
//     its keys, recomputes the tile row by row as the row pass does, puts dS
//     and P_drop of the 64 x 64 tile in shared memory and accumulates
//     dk_cur += dS^T Qrw and dv_cur += P_drop^T dout, A read transposed by
//     ldmatrix;
//   * drk pass, one block per (64 rk rows, h, batch split): walks its
//     batches and query tiles in order, skipping tiles of dW that are zero,
//     with the next tile of dW and qrr double-buffered, and accumulates
//     drk += dW^T Qrr; the splits are added in order afterwards.
#include <type_traits>

#include "attention_args.cuh"
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
static_assert(kThreads == tc::kLoadThreads, "the tile loader's thread count");
constexpr int kT = tc::kTile;
constexpr int kE = tc::kTileElems;

struct BwdV2 {
  const bf16* qrw;
  const bf16* qrr;
  const bf16* kmem;
  const bf16* vmem;
  const bf16* kcur;
  const bf16* vcur;
  const bf16* rk;
  const bf16* dout;   // bf16 scratch [BH, q, dh]
  const float* dsum;  // D per row
  const float* m;
  const float* l;
  const int* reset;
  bf16* dqrw;
  bf16* dqrr;
  bf16* dk;           // [BH, q, dh]: current keys only
  bf16* dv;
  bf16* dw;           // [BH, q, M + 2q]: dS in rk-row order, dW[i, q-1-i+j]
  float* drk_part;    // [n_split, H, M + 2q, dh]
  int BH, B, H, q_len, M, dh, count, same_length, n_split;
  unsigned int seed, thr;
  float rate;
  bool vec, vec_dw;
};

// What a score gives the gradients: dS = P (dP - D) and P_drop, before
// rounding. s is the raw score (kMaskedScore in the uniform window).
struct ScoreGrad {
  float ds, pd;
};

__device__ __forceinline__ ScoreGrad score_grad(float s, float dpt, float m, float inv_l,
                                                float D, bool keep, float keep_scale) {
  const float p = __expf(s - m) * inv_l;
  const float dp = keep ? dpt * keep_scale : 0.f;
  return {p * (dp - D), keep ? p * keep_scale : 0.f};
}

// ---------------------------------------------------------------------------
// row pass: dqrw, dqrr
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) xl_attn_bwd_v2_tc_rows(BwdV2 a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);  // 2 buffers [key][d]
  bf16* s_v = s_k + 2 * kE;                       // 2 buffers [key][d]
  bf16* s_rk = s_v + 2 * kE;                      // ring of 3 segments
  bf16* s_dw = s_rk + 3 * kE;                     // a bf16 dW scratch per warp
  float* s_scr = reinterpret_cast<float*>(s_dw + 4 * tc::kDwElems);

  const int bh = blockIdx.y, i0 = blockIdx.x * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = a.q_len, M = a.M, dh = a.dh, klen = M + q, KP = klen + q;
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const bool uniform = xl_all_masked(M, a.same_length);
  int jlo = reset_row ? M : max(M - a.count, 0);
  jlo = (jlo / kT) * kT;
  const int jhi = uniform ? klen : min(klen, M + min(i0 + kT, q));
  const int nt = (jhi - jlo + kT - 1) / kT;

  const bf16* kmb = a.kmem + static_cast<long long>(bh) * M * dh;
  const bf16* vmb = a.vmem + static_cast<long long>(bh) * M * dh;
  const bf16* kcb = a.kcur + static_cast<long long>(bh) * q * dh;
  const bf16* vcb = a.vcur + static_cast<long long>(bh) * q * dh;
  const bf16* rkh = a.rk + static_cast<long long>(bh / a.B) * KP * dh;
  const int cb0 = q - 1 - (i0 + kT - 1) + jlo;

  auto load_kv = [&](int tile, int buf) {
    const int j0 = jlo + tile * kT;
    tc::load_rows<kT>(
        s_k + buf * kE, [&](int r) { return tc::kv_row(kmb, kcb, j0 + r, M, klen, dh); }, dh,
        a.vec, a.kcur);
    tc::load_rows<kT>(
        s_v + buf * kE, [&](int r) { return tc::kv_row(vmb, vcb, j0 + r, M, klen, dh); }, dh,
        a.vec, a.vcur);
  };
  auto load_rk = [&](int u) {
    const int c0 = cb0 + u * kT;
    tc::load_rows<kT>(
        s_rk + (u % 3) * kE,
        [&](int r) -> const bf16* {
          const int c = c0 + r;
          return c >= 0 && c < KP ? rkh + static_cast<long long>(c) * dh : nullptr;
        },
        dh, a.vec, a.rk);
  };
  if (nt > 0) {
    load_kv(0, 0);
    load_rk(0);
    load_rk(1);
  }
  tc::cp_async_commit();

  const int r0 = warp * 16, iw0 = i0 + r0;
  bf16* dw = s_dw + warp * tc::kDwElems;
  for (int e = lane; e < tc::kDwElems; e += 32) dw[e] = __float2bfloat16_rn(0.f);
  // Row i of dW takes the key tiles' columns [q-1-i+jlo, q-1-i+jlo+64 nt)
  // below; the rest of the row is zero.
  for (int r = 0; r < 16 && iw0 + r < q; ++r) {
    const int i = iw0 + r, lo = q - 1 - i + jlo, hi = min(KP, lo + nt * kT);
    bf16* row = a.dw + (static_cast<long long>(bh) * q + i) * KP;
    for (int c = lane; c < lo; c += 32) row[c] = __float2bfloat16_rn(0.f);
    for (int c = hi + lane; c < KP; c += 32) row[c] = __float2bfloat16_rn(0.f);
  }
  float* scr = s_scr + warp * tc::kScrFloats;
  const int wr0 = (3 - warp) * 16;

  uint32_t qw[4][4], qr[4][4], dof[4][4];
  const long long qoff = static_cast<long long>(bh) * q * dh;
  tc::load_a_global(qw, a.qrw + qoff, dh, iw0, q, dh, lane);
  tc::load_a_global(qr, a.qrr + qoff, dh, iw0, q, dh, lane);
  tc::load_a_global(dof, a.dout + qoff, dh, iw0, q, dh, lane);
  int rows[2];
  unsigned int row_key[2];
  float rm[2], ril[2], rD[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw0 + g + 8 * r;
    const long long row = static_cast<long long>(bh) * q + i;
    rows[r] = i;
    row_key[r] = drop_row_key(a.seed, bh, i);
    rm[r] = i < q ? a.m[row] : 0.f;
    ril[r] = i < q ? 1.f / a.l[row] : 1.f;
    rD[r] = i < q ? a.dsum[row] : 0.f;
  }
  const float keep_scale = 1.f / (1.f - a.rate);
  float dq[8][4], dqr[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = dqr[n][e] = 0.f;

  for (int u = 0; u < nt; ++u) {
    const int buf = u & 1;
    if (u + 1 < nt) {
      load_kv(u + 1, buf ^ 1);
      load_rk(u + 2);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* sk = s_k + buf * kE;
    const bf16* sv = s_v + buf * kE;
    const int j0 = jlo + u * kT;
    auto rk_row = [&](int x) {
      const int wr = wr0 + x;
      return s_rk + ((u + wr / kT) % 3) * kE + (wr % kT) * tc::kStride;
    };

    // S = BD + Qrw K^T and dP = dout V^T, 16 rows x 64 keys
    float s[8][4], dpt[8][4];
    {
      float w[tc::kWin / 8][4];
#pragma unroll
      for (int n = 0; n < tc::kWin / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[n][e] = 0.f;
      tc::window_product(w, qr, rk_row, lane);
      tc::skew_bd(s, w, scr, lane);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        tc::load_b_rows(b, sk, np * 16, kk * 16, lane);
        tc::mma(s[2 * np], qw[kk], b[0], b[1]);
        tc::mma(s[2 * np + 1], qw[kk], b[2], b[3]);
        tc::load_b_rows(b, sv, np * 16, kk * 16, lane);
        tc::mma(dpt[2 * np], dof[kk], b[0], b[1]);
        tc::mma(dpt[2 * np + 1], dof[kk], b[2], b[3]);
      }
    }

    // dS rounded to bf16: the A fragments of dS K, and dW[r, 15-r+jj] for
    // dW RK_win. A warp whose scores are all open skips the per-score mask.
    uint32_t dsf[8][2];
    auto grads = [&](auto all_open) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = g + 8 * r;
          float dsv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int jl = n * 8 + 2 * t + c, i = rows[r], j = j0 + jl;
            const bool valid =
                decltype(all_open)::value ||
                (i < q && j < klen &&
                 (uniform || !xl_masked(i, j, q, M, a.count, reset_row, a.same_length)));
            float ds = 0.f;
            if (valid) {
              const bool keep = a.thr == 0u || drop_keep(row_key[r], j, a.thr);
              ds = score_grad(uniform ? kMaskedScore : s[n][2 * r + c], dpt[n][2 * r + c],
                              rm[r], ril[r], rD[r], keep, keep_scale)
                       .ds;
            }
            dsv[c] = ds;
            dw[row * tc::kDwStride + jl + 15 - row] = __float2bfloat16_rn(ds);
          }
          dsf[n][r] = tc::pack_bf16(dsv[0], dsv[1]);
        }
      }
    };
    const int j1 = j0 + kT - 1;
    if (!uniform && iw0 + 15 < q && j1 < klen &&
        !xl_masked(iw0 + 15, j0, q, M, a.count, reset_row, a.same_length) &&
        !xl_masked(iw0, j1, q, M, a.count, reset_row, a.same_length))
      grads(std::true_type{});
    else
      grads(std::false_type{});
    __syncwarp();
    // this tile's dS to dW in device memory: row i at q-1-i+j0 ..
    for (int r = 0; r < 16 && iw0 + r < q; ++r) {
      const int i = iw0 + r, c_first = q - 1 - i + j0;
      bf16* row = a.dw + (static_cast<long long>(bh) * q + i) * KP + c_first;
      const bf16* src = dw + r * tc::kDwStride + 15 - r;
      for (int x = lane; x < kT; x += 32)
        if (c_first + x < KP) row[x] = src[x];
    }

    // dqrw += dS K: k-steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t da[4] = {dsf[2 * kk][0], dsf[2 * kk][1], dsf[2 * kk + 1][0],
                              dsf[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        if (dp * 16 >= dh) break;
        uint32_t b[4];
        tc::load_b_cols(b, sk, kk * 16, dp * 16, lane);
        tc::mma(dq[2 * dp], da, b[0], b[1]);
        if (dp * 16 + 8 < dh) tc::mma(dq[2 * dp + 1], da, b[2], b[3]);
      }
    }
    // dqrr += dW RK_win: k-steps of 16 window rows over 80
#pragma unroll
    for (int kk = 0; kk < tc::kWin / 16; ++kk) {
      uint32_t da[4];
      tc::ldmatrix_x4(da, dw + ((lane & 7) + ((lane >> 3) & 1) * 8) * tc::kDwStride + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        if (dp * 16 >= dh) break;
        uint32_t b[4];
        tc::ldmatrix_x4_trans(
            b, rk_row(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) + dp * 16 + (lane >> 4) * 8);
        tc::mma(dqr[2 * dp], da, b[0], b[1]);
        if (dp * 16 + 8 < dh) tc::mma(dqr[2 * dp + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with these buffers before they are refilled
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rows[r];
    if (i >= q) continue;
    const long long row = (static_cast<long long>(bh) * q + i) * dh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < dh) {
          a.dqrw[row + d] = __float2bfloat16_rn(dq[n][2 * r + c]);
          a.dqrr[row + d] = __float2bfloat16_rn(dqr[n][2 * r + c]);
        }
      }
    }
  }
}

// Per-row values of a 64-row query tile in shared memory: m, 1 / l, D and
// the dropout row key (rows >= q: m 0, 1 / l 1, D 0).
__device__ __forceinline__ void load_row_stats(const BwdV2& a, int bh, int i0, float* s_m,
                                               float* s_il, float* s_D, unsigned int* s_key) {
  if (threadIdx.x < kT) {
    const int i = i0 + threadIdx.x;
    const long long row = static_cast<long long>(bh) * a.q_len + i;
    const bool in = i < a.q_len;
    s_m[threadIdx.x] = in ? a.m[row] : 0.f;
    s_il[threadIdx.x] = in ? 1.f / a.l[row] : 1.f;
    s_D[threadIdx.x] = in ? a.dsum[row] : 0.f;
    s_key[threadIdx.x] = drop_row_key(a.seed, bh, i);
  }
}

// ---------------------------------------------------------------------------
// key pass: dk_cur, dv_cur
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) xl_attn_bwd_v2_tc_keys(BwdV2 a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);  // [key][d]
  bf16* s_v = s_k + kE;                           // [key][d]
  bf16* s_qw = s_v + kE;                          // [query][d]
  bf16* s_qr = s_qw + kE;
  bf16* s_do = s_qr + kE;
  bf16* s_rk = s_do + kE;                         // 128-row window [rk row][d]
  bf16* s_ds = s_rk + 2 * kE;                     // [query][key]
  bf16* s_pd = s_ds + kE;                         // [query][key]
  float* s_scr = reinterpret_cast<float*>(s_pd + kE);
  float* s_m = s_scr + 4 * tc::kScrFloats;
  float* s_il = s_m + kT;
  float* s_D = s_il + kT;
  unsigned int* s_key = reinterpret_cast<unsigned int*>(s_D + kT);

  const int bh = blockIdx.y, j0 = a.M + blockIdx.x * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = a.q_len, M = a.M, dh = a.dh, klen = M + q, KP = klen + q;
  const int nq = (q + kT - 1) / kT;
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const bool uniform = xl_all_masked(M, a.same_length);
  const long long qoff = static_cast<long long>(bh) * q * dh;
  const bf16* kcb = a.kcur + qoff;
  const bf16* vcb = a.vcur + qoff;
  const bf16* rkh = a.rk + static_cast<long long>(bh / a.B) * KP * dh;

  tc::load_tile(s_k, kcb, dh, j0 - M, q, dh, a.vec);
  tc::load_tile(s_v, vcb, dh, j0 - M, q, dh, a.vec);

  const int r0 = warp * 16;
  float* scr = s_scr + warp * tc::kScrFloats;
  const int wr0 = (3 - warp) * 16;
  const float keep_scale = 1.f / (1.f - a.rate);
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // query rows i >= j0 - M see the tile's keys (all rows in the uniform window)
  for (int qt = uniform ? 0 : (j0 - M) / kT; qt < nq; ++qt) {
    const int i0 = qt * kT;
    tc::load_tile(s_qw, a.qrw + qoff, dh, i0, q, dh, a.vec);
    tc::load_tile(s_qr, a.qrr + qoff, dh, i0, q, dh, a.vec);
    tc::load_tile(s_do, a.dout + qoff, dh, i0, q, dh, a.vec);
    const int cb = q - 1 - (i0 + kT - 1) + j0;
    tc::load_rows<2 * kT>(
        s_rk,
        [&](int r) -> const bf16* {
          const int c = cb + r;
          return c >= 0 && c < KP ? rkh + static_cast<long long>(c) * dh : nullptr;
        },
        dh, a.vec, a.rk);
    load_row_stats(a, bh, i0, s_m, s_il, s_D, s_key);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();

    uint32_t qw[4][4], qr[4][4], dof[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tc::load_a(qw[kk], s_qw, r0, kk * 16, lane);
      tc::load_a(qr[kk], s_qr, r0, kk * 16, lane);
      tc::load_a(dof[kk], s_do, r0, kk * 16, lane);
    }
    float s[8][4], dpt[8][4];
    {
      float w[tc::kWin / 8][4];
#pragma unroll
      for (int n = 0; n < tc::kWin / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[n][e] = 0.f;
      tc::window_product(w, qr, [&](int x) { return s_rk + (wr0 + x) * tc::kStride; }, lane);
      tc::skew_bd(s, w, scr, lane);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        tc::load_b_rows(b, s_k, np * 16, kk * 16, lane);
        tc::mma(s[2 * np], qw[kk], b[0], b[1]);
        tc::mma(s[2 * np + 1], qw[kk], b[2], b[3]);
        tc::load_b_rows(b, s_v, np * 16, kk * 16, lane);
        tc::mma(dpt[2 * np], dof[kk], b[0], b[1]);
        tc::mma(dpt[2 * np + 1], dof[kk], b[2], b[3]);
      }
    }
    // dS and P_drop of the 64 x 64 tile to shared memory, rounded to bf16
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int il = r0 + g + 8 * r, i = i0 + il;
        float dsv[2], pdv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + n * 8 + 2 * t + c;
          const bool valid =
              i < q && j < klen &&
              (uniform || !xl_masked(i, j, q, M, a.count, reset_row, a.same_length));
          ScoreGrad sg{0.f, 0.f};
          if (valid) {
            const bool keep = a.thr == 0u || drop_keep(s_key[il], j, a.thr);
            sg = score_grad(uniform ? kMaskedScore : s[n][2 * r + c], dpt[n][2 * r + c],
                            s_m[il], s_il[il], s_D[il], keep, keep_scale);
          }
          dsv[c] = sg.ds;
          pdv[c] = sg.pd;
        }
        const int off = il * tc::kStride + n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(s_ds + off) = tc::pack_bf16(dsv[0], dsv[1]);
        *reinterpret_cast<uint32_t*>(s_pd + off) = tc::pack_bf16(pdv[0], pdv[1]);
      }
    }
    __syncthreads();

    // dk += dS^T Qrw, dv += P_drop^T dout: this warp's 16 keys, k-steps of
    // 16 queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4], pa[4];
      tc::load_a_trans(da, s_ds, r0, kk * 16, lane);
      tc::load_a_trans(pa, s_pd, r0, kk * 16, lane);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        if (dp * 16 >= dh) break;
        uint32_t b[4];
        tc::load_b_cols(b, s_qw, kk * 16, dp * 16, lane);
        tc::mma(dk[2 * dp], da, b[0], b[1]);
        if (dp * 16 + 8 < dh) tc::mma(dk[2 * dp + 1], da, b[2], b[3]);
        tc::load_b_cols(b, s_do, kk * 16, dp * 16, lane);
        tc::mma(dv[2 * dp], pa, b[0], b[1]);
        if (dp * 16 + 8 < dh) tc::mma(dv[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // the tiles are refilled next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int jc = j0 - M + r0 + g + 8 * r;  // row of dk_cur / dv_cur
    if (jc >= q) continue;
    const long long row = qoff + static_cast<long long>(jc) * dh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < dh) {
          a.dk[row + d] = __float2bfloat16_rn(dk[n][2 * r + c]);
          a.dv[row + d] = __float2bfloat16_rn(dv[n][2 * r + c]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// drk pass: drk_part[split, h, c] = sum over the split's batches and the
// query rows of dW[i, c] qrr[i], dW from the row pass
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) xl_attn_bwd_v2_tc_drk(BwdV2 a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_w = reinterpret_cast<bf16*>(smem_raw);  // 2 buffers [query][c]
  bf16* s_qr = s_w + 2 * kE;                       // 2 buffers [query][d]

  const int c0 = blockIdx.x * kT, h = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = a.q_len, M = a.M, dh = a.dh, B = a.B, klen = M + q, KP = klen + q;
  const int nq = (q + kT - 1) / kT;
  const bool uniform = xl_all_masked(M, a.same_length);
  const int b_per = (B + a.n_split - 1) / a.n_split;
  const int b_lo = split * b_per, b_hi = min(B, b_lo + b_per);

  // Work items: (batch b_lo + it / nq, query tile it % nq), skipping those
  // whose tile of dW is zero (no open key among j = c-(q-1)+i for c in
  // [c0, c0+64), i in the tile); the next item loads while this one runs.
  const int n_items = max(b_hi - b_lo, 0) * nq;
  auto active = [&](int it) {
    const int b = b_lo + it / nq, i0 = (it % nq) * kT;
    const bool reset_row = a.reset != nullptr && a.reset[h * B + b] != 0;
    const int jb = c0 - (q - 1) + i0;
    const int open_lo = uniform ? 0 : (reset_row ? M : max(M - a.count, 0));
    const int open_hi = uniform ? klen - 1 : M + min(i0 + kT, q) - 1;
    return !(jb > open_hi || jb + 2 * kT - 2 < open_lo);
  };
  auto next_item = [&](int it) {
    do {
      ++it;
    } while (it < n_items && !active(it));
    return it;
  };
  auto load_item = [&](int it, int buf) {
    const int b = b_lo + it / nq, i0 = (it % nq) * kT;
    const long long rows = static_cast<long long>(h * B + b) * q;
    tc::load_rows<kT>(
        s_w + buf * kE,
        [&](int r) -> const bf16* {
          const int i = i0 + r;
          return i < q ? a.dw + (rows + i) * KP + c0 : nullptr;
        },
        min(kT, KP - c0), a.vec_dw, a.dw);
    tc::load_tile(s_qr + buf * kE, a.qrr + rows * dh, dh, i0, q, dh, a.vec);
  };

  int it = n_items > 0 && active(0) ? 0 : next_item(0);
  if (it < n_items) load_item(it, 0);
  tc::cp_async_commit();

  const int r0 = warp * 16;
  float acc[8][4];  // drk rows c0 + r0 + g (+ 8), columns of d_head
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int buf = 0; it < n_items; buf ^= 1) {
    const int nxt = next_item(it);
    if (nxt < n_items) load_item(nxt, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    // drk[c, d] += sum_i dW[i, c] qrr[i, d]: this warp's 16 rk rows,
    // k-steps of 16 queries
    const bf16* sw = s_w + buf * kE;
    const bf16* sqr = s_qr + buf * kE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      tc::load_a_trans(da, sw, r0, kk * 16, lane);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        if (dp * 16 >= dh) break;
        uint32_t bb[4];
        tc::load_b_cols(bb, sqr, kk * 16, dp * 16, lane);
        tc::mma(acc[2 * dp], da, bb[0], bb[1]);
        if (dp * 16 + 8 < dh) tc::mma(acc[2 * dp + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with these buffers before they are refilled
    it = nxt;
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = c0 + r0 + g + 8 * r;
    if (c >= KP) continue;
    float* out = a.drk_part + ((static_cast<long long>(split) * a.H + h) * KP + c) * dh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int d = n * 8 + 2 * t + cc;
        if (d < dh) out[d] = acc[n][2 * r + cc];
      }
    }
  }
}

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3u) == 0; }

}  // namespace

int xl_attn_bwd_v2_tc(const BwdArgs& args, cudaStream_t stream) {
  if (args.dh < 1 || args.dh > tc::kDPad || args.B < 1 || args.n_split < 1 ||
      args.dout_lp == nullptr || args.dsum == nullptr || args.dw == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = args.q, dh = args.dh, KP = args.M + 2 * q;
  const long long rows = static_cast<long long>(args.BH) * q;
  BwdV2 a;
  a.qrw = static_cast<const bf16*>(args.qrw);
  a.qrr = static_cast<const bf16*>(args.qrr);
  a.kmem = static_cast<const bf16*>(args.kmem);
  a.vmem = static_cast<const bf16*>(args.vmem);
  a.kcur = static_cast<const bf16*>(args.kcur);
  a.vcur = static_cast<const bf16*>(args.vcur);
  a.rk = static_cast<const bf16*>(args.rk);
  a.dout = static_cast<const bf16*>(args.dout_lp);
  a.dsum = args.dsum;
  a.m = args.m;
  a.l = args.l;
  a.reset = args.reset;
  a.dqrw = static_cast<bf16*>(args.dq);
  a.dqrr = static_cast<bf16*>(args.dqr);
  a.dk = static_cast<bf16*>(args.dk);
  a.dv = static_cast<bf16*>(args.dv);
  a.dw = static_cast<bf16*>(args.dw);
  a.drk_part = args.drk_part;
  a.BH = args.BH;
  a.B = args.B;
  a.H = args.BH / args.B;
  a.q_len = q;
  a.M = args.M;
  a.dh = dh;
  a.count = args.count;
  a.same_length = args.same_length;
  a.n_split = args.n_split;
  a.seed = args.seed;
  a.thr = args.thr;
  a.rate = args.rate;
  a.vec = dh % 2 == 0 && aligned4(a.qrw) && aligned4(a.qrr) && aligned4(a.kmem) &&
          aligned4(a.vmem) && aligned4(a.kcur) && aligned4(a.vcur) && aligned4(a.rk) &&
          aligned4(a.dout);
  a.vec_dw = KP % 2 == 0 && aligned4(a.dw);

  int rc = xl_attn_bwd_tc_prologue(args.dout, args.o, args.dout_lp, args.dsum, rows, dh, stream);
  if (rc != 0) return rc;
  const size_t stats = sizeof(float) * 4 * kT;
  {
    const size_t smem = sizeof(bf16) * (7 * kE + 4 * tc::kDwElems) +
                        sizeof(float) * 4 * tc::kScrFloats;
    cudaError_t e = tg_allow_smem(xl_attn_bwd_v2_tc_rows, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((q + kT - 1) / kT, args.BH);
    xl_attn_bwd_v2_tc_rows<<<grid, kThreads, smem, stream>>>(a);
    TG_CHECK();
  }
  {
    const size_t smem = sizeof(bf16) * 9 * kE + sizeof(float) * 4 * tc::kScrFloats + stats;
    cudaError_t e = tg_allow_smem(xl_attn_bwd_v2_tc_keys, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((q + kT - 1) / kT, args.BH);
    xl_attn_bwd_v2_tc_keys<<<grid, kThreads, smem, stream>>>(a);
    TG_CHECK();
  }
  {
    const size_t smem = sizeof(bf16) * 4 * kE;
    cudaError_t e = tg_allow_smem(xl_attn_bwd_v2_tc_drk, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((KP + kT - 1) / kT, a.H, args.n_split);
    xl_attn_bwd_v2_tc_drk<<<grid, kThreads, smem, stream>>>(a);
    TG_CHECK();
  }
  return 0;
}
