// Transformer-XL relative attention backward, hand-written for Hopper (sm_90a):
// the fp32 kernels, on the CUDA cores, and the entry point of every backward.
//
// Replaces two TPU kernels of transformer_gan_tpu/ops:
//   * pallas_attention_v2._bwd_kernel (reached through _bwd_raw), K1b: the
//     position term BD[i, j] = qrr[i] . rk[q-1-i+j] is recomputed in the
//     kernel (BD_IN = false); outputs dqrw, dqrr, dk_cur, dv_cur (current
//     key columns only: the XL memory is detached) and drk, summed over the
//     batch;
//   * pallas_attention._bwd_kernel (reached through _fused_bwd_raw), K2b: BD
//     is an input (BD_IN = true); outputs dq, dk and dv over all keys, and
//     dbd = dS * scale.
// Only fp32 runs here, the exact on-card reference of the fp32 checks:
// tg_xl_attn_bwd sends bf16 K1b to the tensor-core kernels of
// attention_v2_tc_bwd.cu (then adds its drk splits with the reduce kernel
// here) and bf16 K2b to those of attention_v1_tc_bwd.cu.
// Both recompute P = exp(S - m) / l from the forward's row max and sum, draw
// the forward's dropout mask again from the (seed, bh, i, j) hash, and use
// dS = P * (dP - D) with D_i = do_i . o_i, which equals rowsum(dP * P) with
// dropout too since o = P_drop V. The products accumulate in fp32 and are
// rounded once on store; drk stays fp32.
//
// What bounds it on the H100: recomputing the scores. At the training
// op-point (H 10, B 128, q 128, M 1024, dh 50) each layer call visits
// H * B * q * (M + q) = 1.9e8 score elements; each costs three dh-long dot
// products (AC, BD, dP) in every kernel that visits it, and the row kernel
// adds two dh-long accumulations. Bytes are small beside that (K/V memory,
// 0.5 GB in fp32, is read once by the row kernel). The kernels run on the
// CUDA cores in fp32.
// Design: the TPU kernel holds a whole (h, b) pair in VMEM and sums dR over
// the batch in a revisited output block. Hopper blocks run in no order, so
// the sums over query rows are split by what they are indexed by:
//   * rows kernel, one block per (16-row tile, bh): walks the key tiles as
//     the forward does (lane = key) and accumulates dq (and dqrr) per row;
//     K2b also writes dbd here;
//   * cols kernel, one block per (32-key tile, bh): walks the row tiles that
//     can see its keys and sums dk, dv over rows (dS and P_drop of a 16 x 32
//     tile go through shared memory, then each thread owns 32 * dh / 128
//     outputs);
//   * drk kernel (K1b only), one block per (32 rows of rk, h, batch split):
//     the rk row c meets the score diagonal j = c - (q-1) + i, so a block
//     walks its split of the batch and the row tiles, loads the 47-key window
//     that diagonal touches and sums dS * qrr over rows; a second small
//     kernel adds the splits in a fixed order (for the tensor-core K1b too).
//     No atomics, so dR is the same from run to run.
// Every kernel recomputes the scores it needs; nothing score-sized is
// written to device memory (except K2b's dbd output).
#include "attention_args.cuh"
#include "common.cuh"

namespace {

constexpr int kRows = 16;      // query rows per tile: 4 warps x 4 rows
constexpr int kKeyTile = 32;   // keys per tile: one per lane
constexpr int kThreads = 128;
constexpr int kMaxDPL = 4;     // row outputs per lane: d_head <= 128
constexpr int kMaxOut = kKeyTile * 32 * kMaxDPL / kThreads;  // column outputs per thread
constexpr int kDsStride = kKeyTile + 1;

__device__ __forceinline__ float load_kv(const float* mem, const float* cur, long long mem_bh,
                                         long long cur_bh, int bh, int j, int d, int M, int klen,
                                         int dh) {
  if (j < 0 || j >= klen) return 0.f;
  if (j < M) return mem[bh * mem_bh + static_cast<long long>(j) * dh + d];
  return cur[bh * cur_bh + static_cast<long long>(j - M) * dh + d];
}

// Load a 16-row query tile: qrw (and qrr), do, and per row m, l and
// D = do . o. One warp per four rows; s_D etc. are [kRows].
template <bool BD_IN>
__device__ void load_row_tile(const BwdArgs& a, int bh, int i0, int ds, float* s_qw,
                              float* s_qr, float* s_do, float* s_m, float* s_l,
                              float* s_D) {
  const int q = a.q, dh = a.dh;
  const long long qbase = static_cast<long long>(bh) * q * dh;
  const float* qrw = static_cast<const float*>(a.qrw);
  const float* qrr = static_cast<const float*>(a.qrr);
  for (int e = threadIdx.x; e < kRows * dh; e += blockDim.x) {
    const int r = e / dh, d = e % dh, i = i0 + r;
    float w = 0.f, rr = 0.f, g = 0.f;
    if (i < q) {
      const long long off = qbase + static_cast<long long>(i) * dh + d;
      w = qrw[off];
      if (!BD_IN) rr = qrr[off];
      g = a.dout[off];
    }
    s_qw[r * ds + d] = w;
    if (!BD_IN) s_qr[r * ds + d] = rr;
    s_do[r * ds + d] = g;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = 0; rr < 4; ++rr) {
    const int r = warp * 4 + rr, i = i0 + r;
    float part = 0.f;
    if (i < q) {
      const long long off = qbase + static_cast<long long>(i) * dh;
      for (int d = lane; d < dh; d += 32) part += a.dout[off + d] * a.o[off + d];
    }
    part = warp_sum(part);
    if (lane == 0) {
      s_D[r] = part;
      s_m[r] = i < q ? a.m[static_cast<long long>(bh) * q + i] : 0.f;
      s_l[r] = i < q ? a.l[static_cast<long long>(bh) * q + i] : 1.f;
    }
  }
}

// dS and P_drop of score (i, j): s is the masked-or-not raw score.
struct Grad {
  float ds;   // P * (dP - D) * scale
  float pd;   // P_drop
};

__device__ __forceinline__ Grad score_grad(bool valid, float s, float dp_raw, float m,
                                           float l, float D, bool keep, float rate,
                                           float scale) {
  Grad g{0.f, 0.f};
  if (!valid) return g;
  const float p = expf(s - m) / l;
  const float dp = keep ? dp_raw / (1.f - rate) : 0.f;
  g.ds = p * (dp - D) * scale;
  g.pd = keep ? p / (1.f - rate) : 0.f;
  return g;
}

// ---------------------------------------------------------------------------
// rows kernel: dq (dqrw), dqrr (K1b) or dbd (K2b)
// ---------------------------------------------------------------------------
template <bool BD_IN>
__global__ void __launch_bounds__(kThreads) xl_attn_bwd_rows(BwdArgs a) {
  extern __shared__ float smem[];
  const int bh = blockIdx.y, i0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = a.q, M = a.M, dh = a.dh, klen = M + q, kp = klen + q;
  const int ds = dh | 1;
  const int n_rk = kKeyTile + kRows - 1;
  float* s_qw = smem;
  float* s_qr = s_qw + kRows * ds;
  float* s_do = s_qr + kRows * ds;
  float* s_k = s_do + kRows * ds;
  float* s_v = s_k + kKeyTile * ds;
  float* s_rk = s_v + kKeyTile * ds;     // [n_rk][ds] (BD_IN == false)
  float* s_m = s_rk + (BD_IN ? 0 : n_rk * ds);
  float* s_l = s_m + kRows;
  float* s_D = s_l + kRows;

  const float* kmem = static_cast<const float*>(a.kmem);
  const float* vmem = static_cast<const float*>(a.vmem);
  const float* kcur = static_cast<const float*>(a.kcur);
  const float* vcur = static_cast<const float*>(a.vcur);
  const float* rk = static_cast<const float*>(a.rk);
  const float* bd = static_cast<const float*>(a.bd);
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const int h = bh / a.B;

  load_row_tile<BD_IN>(a, bh, i0, ds, s_qw, s_qr, s_do, s_m, s_l, s_D);

  float acc_q[4][kMaxDPL], acc_r[4][kMaxDPL];
  unsigned int row_key[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    row_key[rr] = drop_row_key(a.seed, bh, i0 + warp * 4 + rr);
#pragma unroll
    for (int c = 0; c < kMaxDPL; ++c) acc_q[rr][c] = acc_r[rr][c] = 0.f;
  }

  int jlo = reset_row ? M : max(M - a.count, 0);
  jlo = (jlo / kKeyTile) * kKeyTile;
  const bool uniform = xl_all_masked(M, a.same_length);
  const int jhi = uniform ? klen : min(klen, M + min(i0 + kRows, q));

  for (int j0 = jlo; j0 < jhi; j0 += kKeyTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kKeyTile * dh; e += blockDim.x) {
      const int r = e / dh, d = e % dh, j = j0 + r;
      s_k[r * ds + d] = load_kv(kmem, kcur, a.mem_bh, a.cur_bh, bh, j, d, M, klen, dh);
      s_v[r * ds + d] = load_kv(vmem, vcur, a.mem_bh, a.cur_bh, bh, j, d, M, klen, dh);
    }
    const int c0 = q - 1 - (i0 + kRows - 1) + j0;
    if (!BD_IN) {
      for (int e = threadIdx.x; e < n_rk * dh; e += blockDim.x) {
        const int r = e / dh, d = e % dh, c = c0 + r;
        s_rk[r * ds + d] =
            (c >= 0 && c < kp) ? rk[(static_cast<long long>(h) * kp + c) * dh + d]
                               : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = warp * 4 + rr, i = i0 + r;
      if (i >= q) continue;  // warp-uniform
      const int j = j0 + lane;
      const bool valid =
          j < klen && (uniform || !xl_masked(i, j, q, M, a.count, reset_row, a.same_length));
      float s = 0.f, dp = 0.f;
      if (valid) {
        float ac = 0.f;
        for (int d = 0; d < dh; ++d) {
          ac += s_qw[r * ds + d] * s_k[lane * ds + d];
          dp += s_do[r * ds + d] * s_v[lane * ds + d];
        }
        if (uniform) {
          s = kMaskedScore;
        } else if (BD_IN) {
          s = (ac + bd[(static_cast<long long>(bh) * q + i) * klen + j]) * a.scale;
        } else {
          const int c = q - 1 - i + j - c0;
          float bdv = 0.f;
          for (int d = 0; d < dh; ++d) bdv += s_qr[r * ds + d] * s_rk[c * ds + d];
          s = ac + bdv;
        }
      }
      const bool keep = a.thr == 0u || drop_keep(row_key[rr], j, a.thr);
      const Grad g = score_grad(valid, s, dp, s_m[r], s_l[r], s_D[r], keep, a.rate, a.scale);
      if (BD_IN && j < klen)
        static_cast<float*>(a.dbd)[(static_cast<long long>(bh) * q + i) * klen + j] =
            g.ds;
      for (int jj = 0; jj < kKeyTile; ++jj) {
        const float dsj = __shfl_sync(kFullMask, g.ds, jj);
        if (dsj == 0.f) continue;  // warp-uniform
        const int c = q - 1 - i + j0 + jj - c0;
#pragma unroll
        for (int cc = 0; cc < kMaxDPL; ++cc) {
          const int d = lane + 32 * cc;
          if (d < dh) {
            acc_q[rr][cc] += dsj * s_k[jj * ds + d];
            if (!BD_IN) acc_r[rr][cc] += dsj * s_rk[c * ds + d];
          }
        }
      }
    }
  }

  const long long qbase = static_cast<long long>(bh) * q * dh;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = i0 + warp * 4 + rr;
    if (i >= q) continue;
#pragma unroll
    for (int cc = 0; cc < kMaxDPL; ++cc) {
      const int d = lane + 32 * cc;
      if (d >= dh) continue;
      const long long off = qbase + static_cast<long long>(i) * dh + d;
      static_cast<float*>(a.dq)[off] = acc_q[rr][cc];
      if (!BD_IN) static_cast<float*>(a.dqr)[off] = acc_r[rr][cc];
    }
  }
}

// ---------------------------------------------------------------------------
// cols kernel: dk, dv summed over query rows (K1b: current keys only)
// ---------------------------------------------------------------------------
template <bool BD_IN>
__global__ void __launch_bounds__(kThreads) xl_attn_bwd_cols(BwdArgs a, int key_first) {
  extern __shared__ float smem[];
  const int bh = blockIdx.y, j0 = key_first + blockIdx.x * kKeyTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = a.q, M = a.M, dh = a.dh, klen = M + q, kp = klen + q;
  const int ds = dh | 1;
  const int n_rk = kKeyTile + kRows - 1;
  float* s_k = smem;
  float* s_v = s_k + kKeyTile * ds;
  float* s_qw = s_v + kKeyTile * ds;
  float* s_qr = s_qw + kRows * ds;
  float* s_do = s_qr + kRows * ds;
  float* s_rk = s_do + kRows * ds;       // [n_rk][ds] (BD_IN == false)
  float* s_ds = s_rk + (BD_IN ? 0 : n_rk * ds);  // [kRows][kDsStride]
  float* s_pd = s_ds + kRows * kDsStride;
  float* s_m = s_pd + kRows * kDsStride;
  float* s_l = s_m + kRows;
  float* s_D = s_l + kRows;

  const float* rk = static_cast<const float*>(a.rk);
  const float* bd = static_cast<const float*>(a.bd);
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const int h = bh / a.B;

  for (int e = threadIdx.x; e < kKeyTile * dh; e += blockDim.x) {
    const int r = e / dh, d = e % dh, j = j0 + r;
    s_k[r * ds + d] = load_kv(static_cast<const float*>(a.kmem),
                              static_cast<const float*>(a.kcur), a.mem_bh, a.cur_bh, bh, j,
                              d, M, klen, dh);
    s_v[r * ds + d] = load_kv(static_cast<const float*>(a.vmem),
                              static_cast<const float*>(a.vcur), a.mem_bh, a.cur_bh, bh, j,
                              d, M, klen, dh);
  }

  float acc_k[kMaxOut], acc_v[kMaxOut];
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) acc_k[t] = acc_v[t] = 0.f;

  // rows that can see a key of the tile: j <= M + i
  const bool uniform = xl_all_masked(M, a.same_length);
  const int ilo = uniform ? 0 : (max(j0 - M, 0) / kRows) * kRows;
  for (int i0 = ilo; i0 < q; i0 += kRows) {
    __syncthreads();
    load_row_tile<BD_IN>(a, bh, i0, ds, s_qw, s_qr, s_do, s_m, s_l, s_D);
    const int c0 = q - 1 - (i0 + kRows - 1) + j0;
    if (!BD_IN) {
      for (int e = threadIdx.x; e < n_rk * dh; e += blockDim.x) {
        const int r = e / dh, d = e % dh, c = c0 + r;
        s_rk[r * ds + d] =
            (c >= 0 && c < kp) ? rk[(static_cast<long long>(h) * kp + c) * dh + d]
                               : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = warp * 4 + rr, i = i0 + r, j = j0 + lane;
      const bool valid = i < q && j < klen &&
                         (uniform || !xl_masked(i, j, q, M, a.count, reset_row, a.same_length));
      float s = 0.f, dp = 0.f;
      if (valid) {
        float ac = 0.f;
        for (int d = 0; d < dh; ++d) {
          ac += s_qw[r * ds + d] * s_k[lane * ds + d];
          dp += s_do[r * ds + d] * s_v[lane * ds + d];
        }
        if (uniform) {
          s = kMaskedScore;
        } else if (BD_IN) {
          s = (ac + bd[(static_cast<long long>(bh) * q + i) * klen + j]) * a.scale;
        } else {
          const int c = q - 1 - i + j - c0;
          float bdv = 0.f;
          for (int d = 0; d < dh; ++d) bdv += s_qr[r * ds + d] * s_rk[c * ds + d];
          s = ac + bdv;
        }
      }
      const bool keep =
          a.thr == 0u || (valid && drop_keep(drop_row_key(a.seed, bh, i), j, a.thr));
      const Grad g = score_grad(valid, s, dp, s_m[r], s_l[r], s_D[r], keep, a.rate, a.scale);
      s_ds[r * kDsStride + lane] = g.ds;
      s_pd[r * kDsStride + lane] = g.pd;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kMaxOut; ++t) {
      const int e = threadIdx.x + t * kThreads;
      if (e >= kKeyTile * dh) break;
      const int jj = e / dh, d = e % dh;
      float sk = 0.f, sv = 0.f;
      for (int r = 0; r < kRows; ++r) {
        sk += s_ds[r * kDsStride + jj] * s_qw[r * ds + d];
        sv += s_pd[r * kDsStride + jj] * s_do[r * ds + d];
      }
      acc_k[t] += sk;
      acc_v[t] += sv;
    }
  }

#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) {
    const int e = threadIdx.x + t * kThreads;
    if (e >= kKeyTile * dh) break;
    const int jj = e / dh, d = e % dh, j = j0 + jj;
    if (j >= klen) continue;
    // K1b writes the current keys only (rows j - M of dk_cur / dv_cur)
    const long long off = bh * static_cast<long long>(klen - key_first) * dh +
                          static_cast<long long>(j - key_first) * dh + d;
    static_cast<float*>(a.dk)[off] = acc_k[t];
    static_cast<float*>(a.dv)[off] = acc_v[t];
  }
}

// ---------------------------------------------------------------------------
// drk kernel (K1b): drk[h, c] = sum_b sum_i dS_b[i, c-(q-1)+i] * qrr_b[i]
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) xl_attn_bwd_drk(BwdArgs a) {
  extern __shared__ float smem[];
  const int c0 = blockIdx.x * kKeyTile, h = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = a.q, M = a.M, dh = a.dh, B = a.B, klen = M + q, kp = klen + q;
  const int ds = dh | 1;
  const int n_kv = kKeyTile + kRows - 1;  // keys one (row tile, c tile) touches
  const bool uniform = xl_all_masked(M, a.same_length);
  float* s_rk = smem;                     // [kKeyTile][ds]
  float* s_qw = s_rk + kKeyTile * ds;
  float* s_qr = s_qw + kRows * ds;
  float* s_do = s_qr + kRows * ds;
  float* s_k = s_do + kRows * ds;         // [n_kv][ds]
  float* s_v = s_k + n_kv * ds;
  float* s_ds = s_v + n_kv * ds;          // [kRows][kDsStride]
  float* s_m = s_ds + kRows * kDsStride;
  float* s_l = s_m + kRows;
  float* s_D = s_l + kRows;

  const float* rk = static_cast<const float*>(a.rk);
  for (int e = threadIdx.x; e < kKeyTile * dh; e += blockDim.x) {
    const int r = e / dh, d = e % dh, c = c0 + r;
    s_rk[r * ds + d] =
        c < kp ? rk[(static_cast<long long>(h) * kp + c) * dh + d] : 0.f;
  }

  float acc[kMaxOut];
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) acc[t] = 0.f;

  const int b_per = (B + a.n_split - 1) / a.n_split;
  const int b_lo = split * b_per, b_hi = min(B, b_lo + b_per);
  for (int b = b_lo; b < b_hi; ++b) {
    const int bh = h * B + b;
    const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
    const int jvalid = reset_row ? M : max(M - a.count, 0);  // first key any row sees
    for (int i0 = 0; i0 < q; i0 += kRows) {
      // keys j = c - (q-1) + i of this tile: jw0 .. jw0 + n_kv - 1
      const int jw0 = c0 - (q - 1) + i0;
      if (uniform ? (jw0 > klen - 1 || jw0 + n_kv - 1 < 0)
                  : (jw0 > M + min(i0 + kRows, q) - 1 || jw0 + n_kv - 1 < jvalid))
        continue;
      __syncthreads();
      load_row_tile<false>(a, bh, i0, ds, s_qw, s_qr, s_do, s_m, s_l, s_D);
      for (int e = threadIdx.x; e < n_kv * dh; e += blockDim.x) {
        const int r = e / dh, d = e % dh, j = jw0 + r;
        s_k[r * ds + d] = load_kv(static_cast<const float*>(a.kmem),
                                  static_cast<const float*>(a.kcur), a.mem_bh, a.cur_bh, bh,
                                  j, d, M, klen, dh);
        s_v[r * ds + d] = load_kv(static_cast<const float*>(a.vmem),
                                  static_cast<const float*>(a.vcur), a.mem_bh, a.cur_bh, bh,
                                  j, d, M, klen, dh);
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int r = warp * 4 + rr, i = i0 + r, c = c0 + lane;
        const int j = c - (q - 1) + i, jw = lane + r;  // jw: key row in s_k
        const bool valid = i < q && j >= 0 && j < klen &&
                           (uniform || !xl_masked(i, j, q, M, a.count, reset_row,
                                                  a.same_length));
        float s = 0.f, dp = 0.f;
        if (valid) {
          float ac = 0.f, bdv = 0.f;
          for (int d = 0; d < dh; ++d) {
            ac += s_qw[r * ds + d] * s_k[jw * ds + d];
            bdv += s_qr[r * ds + d] * s_rk[lane * ds + d];
            dp += s_do[r * ds + d] * s_v[jw * ds + d];
          }
          s = uniform ? kMaskedScore : ac + bdv;
        }
        const bool keep =
            a.thr == 0u || (valid && drop_keep(drop_row_key(a.seed, bh, i), j, a.thr));
        const Grad g = score_grad(valid, s, dp, s_m[r], s_l[r], s_D[r], keep, a.rate, 1.f);
        s_ds[r * kDsStride + lane] = g.ds;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kMaxOut; ++t) {
        const int e = threadIdx.x + t * kThreads;
        if (e >= kKeyTile * dh) break;
        const int cc = e / dh, d = e % dh;
        float sum = 0.f;
        for (int r = 0; r < kRows; ++r) sum += s_ds[r * kDsStride + cc] * s_qr[r * ds + d];
        acc[t] += sum;
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) {
    const int e = threadIdx.x + t * kThreads;
    if (e >= kKeyTile * dh) break;
    const int cc = e / dh, d = e % dh, c = c0 + cc;
    if (c >= kp) continue;
    a.drk_part[((static_cast<long long>(split) * gridDim.y + h) * kp + c) * dh + d] = acc[t];
  }
}

// drk = sum over the batch splits, in split order.
__global__ void xl_attn_bwd_drk_reduce(const float* __restrict__ part, float* __restrict__ drk,
                                       long long n, int n_split) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += part[k * n + e];
  drk[e] = s;
}

// drk = the batch splits of drk_part added in split order.
int reduce_drk(const BwdArgs& a, cudaStream_t stream) {
  const long long n = static_cast<long long>(a.BH / a.B) * (a.M + 2 * a.q) * a.dh;
  xl_attn_bwd_drk_reduce<<<static_cast<unsigned int>((n + 255) / 256), 256, 0, stream>>>(
      a.drk_part, a.drk, n, a.n_split);
  TG_CHECK();
  return 0;
}

size_t rows_smem(int ds, bool bd_in) {
  return sizeof(float) * (ds * (3 * kRows + 2 * kKeyTile + (bd_in ? 0 : kKeyTile + kRows - 1)) +
                          3 * kRows);
}

size_t cols_smem(int ds, bool bd_in) {
  return sizeof(float) * (ds * (2 * kKeyTile + 3 * kRows + (bd_in ? 0 : kKeyTile + kRows - 1)) +
                          2 * kRows * kDsStride + 3 * kRows);
}

size_t drk_smem(int ds) {
  return sizeof(float) * (ds * (kKeyTile + 3 * kRows + 2 * (kKeyTile + kRows - 1)) +
                          kRows * kDsStride + 3 * kRows);
}

template <bool BD_IN>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int ds = a.dh | 1;
  const int klen = a.M + a.q;
  {
    auto kernel = xl_attn_bwd_rows<BD_IN>;
    const size_t smem = rows_smem(ds, BD_IN);
    cudaError_t e = tg_allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((a.q + kRows - 1) / kRows, a.BH);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    TG_CHECK();
  }
  {
    // K1b: current keys only (the memory is detached); K2b: every key
    const int key_first = BD_IN ? 0 : a.M;
    auto kernel = xl_attn_bwd_cols<BD_IN>;
    const size_t smem = cols_smem(ds, BD_IN);
    cudaError_t e = tg_allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((klen - key_first + kKeyTile - 1) / kKeyTile, a.BH);
    kernel<<<grid, kThreads, smem, stream>>>(a, key_first);
    TG_CHECK();
  }
  if (!BD_IN) {
    const int kp = klen + a.q;
    auto kernel = xl_attn_bwd_drk;
    const size_t smem = drk_smem(ds);
    cudaError_t e = tg_allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((kp + kKeyTile - 1) / kKeyTile, a.BH / a.B, a.n_split);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    TG_CHECK();
    return reduce_drk(a, stream);
  }
  return 0;
}

}  // namespace

extern "C" int tg_sizeof_attn_bwd_args() { return static_cast<int>(sizeof(BwdArgs)); }

// Layouts as tg_xl_attn_fwd; m, l: [BH, q] fp32; o, dout: [BH, q, dh] fp32.
// K1b (bd_in 0): dq = dqrw, dqr = dqrr [BH, q, dh]; dk, dv = dk_cur, dv_cur
// [BH, q, dh]; drk [H, M + 2q, dh] fp32 with scratch drk_part
// [n_split, H, M + 2q, dh]. K2b (bd_in 1): dq [BH, q, dh]; dk, dv
// [BH, M + q, dh]; dbd [BH, q, M + q] (fp32: the wrapper zeroes it, masked
// tiles the kernel skips stay 0; bf16: the tensor-core kernels write every
// entry). bf16 (K1b and K2b, the tensor-core kernels) takes the scratch
// dout_lp and dsum.
extern "C" int tg_xl_attn_bwd(const BwdArgs* args, void* stream) {
  const BwdArgs& a = *args;
  if (a.dh > 32 * kMaxDPL || a.dh < 1 || a.n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (a.dtype == 1 && a.bd_in) return xl_attn_bwd_v1_tc(a, st);
  if (a.dtype == 1) {
    const int rc = xl_attn_bwd_v2_tc(a, st);
    return rc != 0 ? rc : reduce_drk(a, st);
  }
  if (a.dtype == 0 && a.bd_in) return launch_bwd<true>(a, st);
  if (a.dtype == 0) return launch_bwd<false>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
