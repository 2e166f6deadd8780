// Transformer-XL relative attention backward, hand-written for Hopper (sm_90a).
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
// Both recompute P = exp(S - m) / l from the forward's row max and sum, draw
// the forward's dropout mask again from the (seed, bh, i, j) hash, and use
// dS = P * (dP - D) with D_i = do_i . o_i, which equals rowsum(dP * P) with
// dropout too since o = P_drop V. bf16 rounds where the TPU kernels round:
// dS (times scale) and P_drop are rounded to the compute type before the
// products; the products accumulate in fp32 and are rounded once on store;
// drk stays fp32.
//
// What bounds it on the H100: recomputing the scores. At the training
// op-point (H 10, B 128, q 128, M 1024, dh 50, bf16) each layer call visits
// H * B * q * (M + q) = 1.9e8 score elements; each costs three dh-long dot
// products (AC, BD, dP) in every kernel that visits it, and the row kernel
// adds two dh-long accumulations. Bytes are small beside that (K/V memory,
// 0.3 GB in bf16, is read once by the row kernel). The kernels run on the
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
//     kernel adds the splits in a fixed order. No atomics, so dR is the same
//     from run to run.
// Every kernel recomputes the scores it needs; nothing score-sized is
// written to device memory (except K2b's dbd output). Tensor-core MMA and
// fusing the three passes are left for later work.
#include "common.cuh"

// Arguments of tg_xl_attn_bwd (mirrored by ops/attention._BwdArgs).
struct BwdArgs {
  const void* qrw;
  const void* qrr;
  const void* kmem;
  const void* vmem;
  const void* kcur;
  const void* vcur;
  const void* rk;
  const void* bd;
  const int* reset;
  const float* m;
  const float* l;
  const float* o;
  const float* dout;
  void* dq;
  void* dqr;
  void* dk;
  void* dv;
  void* dbd;
  float* drk_part;
  float* drk;
  long long mem_bh;
  long long cur_bh;
  int dtype;
  int bd_in;
  int BH;
  int B;
  int q;
  int M;
  int dh;
  int count;
  int same_length;
  int n_split;
  unsigned int seed;
  unsigned int thr;
  float scale;
  float rate;
};

namespace {

constexpr int kRows = 16;      // query rows per tile: 4 warps x 4 rows
constexpr int kKeyTile = 32;   // keys per tile: one per lane
constexpr int kThreads = 128;
constexpr int kMaxDPL = 4;     // row outputs per lane: d_head <= 128
constexpr int kMaxOut = kKeyTile * 32 * kMaxDPL / kThreads;  // column outputs per thread
constexpr int kDsStride = kKeyTile + 1;

template <typename T>
__device__ __forceinline__ float load_kv(const T* mem, const T* cur, long long mem_bh,
                                         long long cur_bh, int bh, int j, int d, int M,
                                         int klen, int dh) {
  if (j < 0 || j >= klen) return 0.f;
  if (j < M) return to_f<T>(mem[bh * mem_bh + static_cast<long long>(j) * dh + d]);
  return to_f<T>(cur[bh * cur_bh + static_cast<long long>(j - M) * dh + d]);
}

// Load a 16-row query tile: qrw (and qrr), do, and per row m, l and
// D = do . o. One warp per four rows; s_D etc. are [kRows].
template <typename T, bool BD_IN>
__device__ void load_row_tile(const BwdArgs& a, int bh, int i0, int ds, float* s_qw,
                              float* s_qr, float* s_do, float* s_m, float* s_l,
                              float* s_D) {
  const int q = a.q, dh = a.dh;
  const long long qbase = static_cast<long long>(bh) * q * dh;
  const T* qrw = static_cast<const T*>(a.qrw);
  const T* qrr = static_cast<const T*>(a.qrr);
  for (int e = threadIdx.x; e < kRows * dh; e += blockDim.x) {
    const int r = e / dh, d = e % dh, i = i0 + r;
    float w = 0.f, rr = 0.f, g = 0.f;
    if (i < q) {
      const long long off = qbase + static_cast<long long>(i) * dh + d;
      w = to_f<T>(qrw[off]);
      if (!BD_IN) rr = to_f<T>(qrr[off]);
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
  float ds;   // P * (dP - D) * scale, rounded to T
  float pd;   // P_drop rounded to T
};

template <typename T>
__device__ __forceinline__ Grad score_grad(bool valid, float s, float dp_raw, float m,
                                           float l, float D, bool keep, float rate,
                                           float scale) {
  Grad g{0.f, 0.f};
  if (!valid) return g;
  const float p = expf(s - m) / l;
  const float dp = keep ? dp_raw / (1.f - rate) : 0.f;
  g.ds = rnd<T>(p * (dp - D) * scale);
  g.pd = rnd<T>(keep ? p / (1.f - rate) : 0.f);
  return g;
}

// ---------------------------------------------------------------------------
// rows kernel: dq (dqrw), dqrr (K1b) or dbd (K2b)
// ---------------------------------------------------------------------------
template <typename T, bool BD_IN>
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

  const T* kmem = static_cast<const T*>(a.kmem);
  const T* vmem = static_cast<const T*>(a.vmem);
  const T* kcur = static_cast<const T*>(a.kcur);
  const T* vcur = static_cast<const T*>(a.vcur);
  const T* rk = static_cast<const T*>(a.rk);
  const T* bd = static_cast<const T*>(a.bd);
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const int h = bh / a.B;

  load_row_tile<T, BD_IN>(a, bh, i0, ds, s_qw, s_qr, s_do, s_m, s_l, s_D);

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
      s_k[r * ds + d] = load_kv<T>(kmem, kcur, a.mem_bh, a.cur_bh, bh, j, d, M, klen, dh);
      s_v[r * ds + d] = load_kv<T>(vmem, vcur, a.mem_bh, a.cur_bh, bh, j, d, M, klen, dh);
    }
    const int c0 = q - 1 - (i0 + kRows - 1) + j0;
    if (!BD_IN) {
      for (int e = threadIdx.x; e < n_rk * dh; e += blockDim.x) {
        const int r = e / dh, d = e % dh, c = c0 + r;
        s_rk[r * ds + d] =
            (c >= 0 && c < kp) ? to_f<T>(rk[(static_cast<long long>(h) * kp + c) * dh + d])
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
          s = (ac + to_f<T>(bd[(static_cast<long long>(bh) * q + i) * klen + j])) * a.scale;
        } else {
          const int c = q - 1 - i + j - c0;
          float bdv = 0.f;
          for (int d = 0; d < dh; ++d) bdv += s_qr[r * ds + d] * s_rk[c * ds + d];
          s = ac + bdv;
        }
      }
      const bool keep = a.thr == 0u || drop_keep(row_key[rr], j, a.thr);
      const Grad g = score_grad<T>(valid, s, dp, s_m[r], s_l[r], s_D[r], keep, a.rate,
                                   a.scale);
      if (BD_IN && j < klen)
        static_cast<T*>(a.dbd)[(static_cast<long long>(bh) * q + i) * klen + j] =
            from_f<T>(g.ds);
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
      static_cast<T*>(a.dq)[off] = from_f<T>(acc_q[rr][cc]);
      if (!BD_IN) static_cast<T*>(a.dqr)[off] = from_f<T>(acc_r[rr][cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// cols kernel: dk, dv summed over query rows (K1b: current keys only)
// ---------------------------------------------------------------------------
template <typename T, bool BD_IN>
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

  const T* rk = static_cast<const T*>(a.rk);
  const T* bd = static_cast<const T*>(a.bd);
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const int h = bh / a.B;

  for (int e = threadIdx.x; e < kKeyTile * dh; e += blockDim.x) {
    const int r = e / dh, d = e % dh, j = j0 + r;
    s_k[r * ds + d] = load_kv<T>(static_cast<const T*>(a.kmem), static_cast<const T*>(a.kcur),
                                 a.mem_bh, a.cur_bh, bh, j, d, M, klen, dh);
    s_v[r * ds + d] = load_kv<T>(static_cast<const T*>(a.vmem), static_cast<const T*>(a.vcur),
                                 a.mem_bh, a.cur_bh, bh, j, d, M, klen, dh);
  }

  float acc_k[kMaxOut], acc_v[kMaxOut];
#pragma unroll
  for (int t = 0; t < kMaxOut; ++t) acc_k[t] = acc_v[t] = 0.f;

  // rows that can see a key of the tile: j <= M + i
  const bool uniform = xl_all_masked(M, a.same_length);
  const int ilo = uniform ? 0 : (max(j0 - M, 0) / kRows) * kRows;
  for (int i0 = ilo; i0 < q; i0 += kRows) {
    __syncthreads();
    load_row_tile<T, BD_IN>(a, bh, i0, ds, s_qw, s_qr, s_do, s_m, s_l, s_D);
    const int c0 = q - 1 - (i0 + kRows - 1) + j0;
    if (!BD_IN) {
      for (int e = threadIdx.x; e < n_rk * dh; e += blockDim.x) {
        const int r = e / dh, d = e % dh, c = c0 + r;
        s_rk[r * ds + d] =
            (c >= 0 && c < kp) ? to_f<T>(rk[(static_cast<long long>(h) * kp + c) * dh + d])
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
          s = (ac + to_f<T>(bd[(static_cast<long long>(bh) * q + i) * klen + j])) * a.scale;
        } else {
          const int c = q - 1 - i + j - c0;
          float bdv = 0.f;
          for (int d = 0; d < dh; ++d) bdv += s_qr[r * ds + d] * s_rk[c * ds + d];
          s = ac + bdv;
        }
      }
      const bool keep =
          a.thr == 0u || (valid && drop_keep(drop_row_key(a.seed, bh, i), j, a.thr));
      const Grad g = score_grad<T>(valid, s, dp, s_m[r], s_l[r], s_D[r], keep, a.rate,
                                   a.scale);
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
    static_cast<T*>(a.dk)[off] = from_f<T>(acc_k[t]);
    static_cast<T*>(a.dv)[off] = from_f<T>(acc_v[t]);
  }
}

// ---------------------------------------------------------------------------
// drk kernel (K1b): drk[h, c] = sum_b sum_i dS_b[i, c-(q-1)+i] * qrr_b[i]
// ---------------------------------------------------------------------------
template <typename T>
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

  const T* rk = static_cast<const T*>(a.rk);
  for (int e = threadIdx.x; e < kKeyTile * dh; e += blockDim.x) {
    const int r = e / dh, d = e % dh, c = c0 + r;
    s_rk[r * ds + d] =
        c < kp ? to_f<T>(rk[(static_cast<long long>(h) * kp + c) * dh + d]) : 0.f;
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
      load_row_tile<T, false>(a, bh, i0, ds, s_qw, s_qr, s_do, s_m, s_l, s_D);
      for (int e = threadIdx.x; e < n_kv * dh; e += blockDim.x) {
        const int r = e / dh, d = e % dh, j = jw0 + r;
        s_k[r * ds + d] = load_kv<T>(static_cast<const T*>(a.kmem),
                                     static_cast<const T*>(a.kcur), a.mem_bh, a.cur_bh,
                                     bh, j, d, M, klen, dh);
        s_v[r * ds + d] = load_kv<T>(static_cast<const T*>(a.vmem),
                                     static_cast<const T*>(a.vcur), a.mem_bh, a.cur_bh,
                                     bh, j, d, M, klen, dh);
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
        const Grad g = score_grad<T>(valid, s, dp, s_m[r], s_l[r], s_D[r], keep, a.rate,
                                     1.f);
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

template <typename T, bool BD_IN>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  const int ds = a.dh | 1;
  const int klen = a.M + a.q;
  {
    auto kernel = xl_attn_bwd_rows<T, BD_IN>;
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
    auto kernel = xl_attn_bwd_cols<T, BD_IN>;
    const size_t smem = cols_smem(ds, BD_IN);
    cudaError_t e = tg_allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((klen - key_first + kKeyTile - 1) / kKeyTile, a.BH);
    kernel<<<grid, kThreads, smem, stream>>>(a, key_first);
    TG_CHECK();
  }
  if (!BD_IN) {
    const int kp = klen + a.q;
    const int H = a.BH / a.B;
    auto kernel = xl_attn_bwd_drk<T>;
    const size_t smem = drk_smem(ds);
    cudaError_t e = tg_allow_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((kp + kKeyTile - 1) / kKeyTile, H, a.n_split);
    kernel<<<grid, kThreads, smem, stream>>>(a);
    TG_CHECK();
    const long long n = static_cast<long long>(H) * kp * a.dh;
    xl_attn_bwd_drk_reduce<<<static_cast<unsigned int>((n + 255) / 256), 256, 0, stream>>>(
        a.drk_part, a.drk, n, a.n_split);
    TG_CHECK();
  }
  return 0;
}

}  // namespace

extern "C" int tg_sizeof_attn_bwd_args() { return static_cast<int>(sizeof(BwdArgs)); }

// Layouts as tg_xl_attn_fwd; m, l: [BH, q] fp32; o, dout: [BH, q, dh] fp32.
// K1b (bd_in 0): dq = dqrw, dqr = dqrr [BH, q, dh]; dk, dv = dk_cur, dv_cur
// [BH, q, dh]; drk [H, M + 2q, dh] fp32 with scratch drk_part
// [n_split, H, M + 2q, dh]. K2b (bd_in 1): dq [BH, q, dh]; dk, dv
// [BH, M + q, dh]; dbd [BH, q, M + q] (the wrapper zeroes it: masked tiles
// the kernel skips stay 0).
extern "C" int tg_xl_attn_bwd(const BwdArgs* args, void* stream) {
  const BwdArgs& a = *args;
  if (a.dh > 32 * kMaxDPL || a.dh < 1 || a.n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (a.dtype == 0 && a.bd_in) return launch_bwd<float, true>(a, st);
  if (a.dtype == 0) return launch_bwd<float, false>(a, st);
  if (a.dtype == 1 && a.bd_in) return launch_bwd<__nv_bfloat16, true>(a, st);
  if (a.dtype == 1) return launch_bwd<__nv_bfloat16, false>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
