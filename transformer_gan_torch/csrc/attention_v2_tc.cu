// K1f in bf16: Transformer-XL attention forward with the relative position
// term built inside the tiles, on Hopper's tensor cores (sm_90a, mma.sync
// m16n8k16 bf16 -> fp32).
//
// Replaces pallas_attention_v2._fwd_kernel (reached through _fwd_raw) of
// transformer_gan_tpu/ops for bf16 inputs; tg_xl_attn_fwd (attention.cu)
// sends bf16 without a BD input here and keeps fp32 on the CUDA-core kernel
// of attention.cu, the exact on-card reference of the fp32 checks (tensor
// cores in fp32 would be TF32). Same function and rounding points as that
// kernel: queries arrive pre-scaled, S = qrw k^T + BD in fp32 with
// BD[i, j] = qrr_i . rk[q-1-i+j] kept in fp32, the xl_masked mask (the
// every-key-masked window counts every key with kMaskedScore), an online
// softmax, the (seed, bh, i, j) dropout hash, the unnormalised P rounded to
// bf16 before P V, o = acc / l / (1 - rate), and m, l of the undropped
// exponentials.
//
// What bounds it on the H100: bytes. At the MLE step's shape (H 10, B 128,
// q 128, M 1024, d_head 50) it reads the memory K/V once (262 MB of its 363
// MB), 0.108 ms at 3.35 TB/s; its 5.6e10 flops take 0.06 ms on the tensor
// cores. The CUDA-core kernel it replaces ran ~190x above that bound: two
// fp32 50-long dot products per score (AC and BD) on one lane and P V
// through 32 shuffles a key.
// Design (the tile engine of attention_tc.cuh, as K2f's attention_v1_tc.cu):
//   * one block of 4 warps per (64-row query tile, bh, key split); each warp
//     owns 16 query rows and keeps qrw and qrr as A fragments (d_head 50
//     zero-padded to 64: four k-steps of 16);
//   * 64-key tiles from the first slot the count and reset masks leave open
//     to the causal edge, K and V double-buffered by 4-byte cp.async from
//     two sources (the memory rows, then the current rows: a tile may
//     straddle j = M);
//   * the position term inside the tile: a key tile meets a 127-row window
//     of rk that advances by 64 rows a tile, so rk streams through two
//     64-row slots (one new segment a tile, loaded into the slot the window
//     leaves as soon as every warp has taken W, L2-resident: the B blocks of
//     a head share it; rows below 0 or past M + 2q read as zero);
//     each warp computes W = Qrr RK_win^T over its 80 window rows on the
//     tensor cores (25% more products than Q K^T) and takes BD[r, jj] =
//     W[r, 15-r+jj] through a per-warp fp32 scratch (tc::skew_bd) as the
//     initial value of the S accumulators;
//   * softmax on the accumulator fragments and O += P V as K2f;
//   * split keys when BH x query tiles leaves the card under-filled (20
//     tiles at generation's prime shape, B 1), merged by K2f's fixed-order
//     combine kernel (no atomics);
//   * 72 KB of shared memory a block, so three blocks share an SM.
#include <type_traits>

#include "attention_args.cuh"
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps x 16 query rows
static_assert(kThreads == tc::kLoadThreads, "the tile loader's thread count");
constexpr int kBlocksPerSm = 3;
constexpr int kT = tc::kTile;
constexpr int kE = tc::kTileElems;

struct FwdV2 {
  const bf16* qrw;
  const bf16* qrr;
  const bf16* kmem;
  const bf16* vmem;
  const bf16* kcur;
  const bf16* vcur;
  const bf16* rk;
  const int* reset;
  float* o;        // [BH, q, dh]  (n_split == 1)
  float* m;        // [BH, q]
  float* l;        // [BH, q]
  float* o_part;   // [n_split, BH, q, dh] unnormalised (n_split > 1)
  float* m_part;   // [n_split, BH, q]
  float* l_part;   // [n_split, BH, q]
  int BH, B, q_len, M, dh, count, same_length, n_split;
  unsigned int seed, thr;
  float rate;
  bool vec;
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) xl_attn_fwd_v2_tc_kernel(FwdV2 a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);  // 2 buffers [key][d]
  bf16* s_v = s_k + 2 * kE;                       // 2 buffers [key][d]
  bf16* s_rk = s_v + 2 * kE;                      // 2 slots of 64 rk rows [rk row][d]
  float* s_scr = reinterpret_cast<float*>(s_rk + 2 * kE);  // a scratch per warp

  const int bh = blockIdx.y, split = blockIdx.z;
  const int i0 = blockIdx.x * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = a.q_len, M = a.M, dh = a.dh, klen = M + q, KP = klen + q;
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const bool uniform = xl_all_masked(M, a.same_length);

  // Key tiles from the first open slot to the causal edge of the last row.
  int jlo = reset_row ? M : max(M - a.count, 0);
  jlo = (jlo / kT) * kT;
  const int jhi = uniform ? klen : min(klen, M + min(i0 + kT, q));
  const int n_t = (jhi - jlo + kT - 1) / kT;
  const int t_lo = split * n_t / a.n_split, t_hi = (split + 1) * n_t / a.n_split;
  const int nt = t_hi - t_lo;

  const bf16* kmb = a.kmem + static_cast<long long>(bh) * M * dh;
  const bf16* vmb = a.vmem + static_cast<long long>(bh) * M * dh;
  const bf16* kcb = a.kcur + static_cast<long long>(bh) * q * dh;
  const bf16* vcb = a.vcur + static_cast<long long>(bh) * q * dh;
  const bf16* rkh = a.rk + static_cast<long long>(bh / a.B) * KP * dh;
  // Segment u (slot u % 2) holds rk rows cb0 + 64 u ..: tile t_lo + u
  // reads the 128-row window of segments u and u + 1.
  const int cb0 = q - 1 - (i0 + kT - 1) + jlo + t_lo * kT;

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
        s_rk + (u % 2) * kE,
        [&](int r) -> const bf16* {
          const int c = c0 + r;
          return c >= 0 && c < KP ? rkh + static_cast<long long>(c) * dh : nullptr;
        },
        dh, a.vec, a.rk);
  };

  if (nt > 0) {
    load_kv(t_lo, 0);
    load_rk(0);
    load_rk(1);
  }
  tc::cp_async_commit();

  const int r0 = warp * 16, iw0 = i0 + r0;  // this warp's rows
  int rows[2];
  unsigned int row_key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = iw0 + g + 8 * r;
    row_key[r] = drop_row_key(a.seed, bh, rows[r]);
  }
  uint32_t qw[4][4], qr[4][4];
  const long long qoff = static_cast<long long>(bh) * q * dh;
  tc::load_a_global(qw, a.qrw + qoff, dh, iw0, q, dh, lane);
  tc::load_a_global(qr, a.qrr + qoff, dh, iw0, q, dh, lane);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float* scr = s_scr + warp * tc::kScrFloats;
  const int wr0 = (3 - warp) * 16;  // this warp's first row of the block's window

  for (int u = 0; u < nt; ++u) {
    const int tt = t_lo + u, buf = u & 1;
    if (u + 1 < nt) load_kv(tt + 1, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile's K, V and rk segments have landed
    __syncthreads();
    const bf16* sk = s_k + buf * kE;
    const bf16* sv = s_v + buf * kE;
    const int j0 = jlo + tt * kT;

    // S = BD + Qrw K^T: BD from W = Qrr RK_win^T skewed, 16 rows x 64 keys
    float s[8][4];
    {
      float w[tc::kWin / 8][4];
#pragma unroll
      for (int n = 0; n < tc::kWin / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[n][e] = 0.f;
      tc::window_product(
          w, qr,
          [&](int x) {
            const int wr = wr0 + x;
            return s_rk + ((u + wr / kT) % 2) * kE + (wr % kT) * tc::kStride;
          },
          lane);
      __syncthreads();  // every warp has read segment u: its slot takes u + 2
      if (u + 1 < nt) load_rk(u + 2);
      tc::cp_async_commit();
      tc::skew_bd(s, w, scr, lane);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        tc::load_b_rows(b, sk, np * 16, kk * 16, lane);
        tc::mma(s[2 * np], qw[kk], b[0], b[1]);
        tc::mma(s[2 * np + 1], qw[kk], b[2], b[3]);
      }
    }

    // Masked scores and the tile's row max over the quad. A warp whose
    // 16 x 64 scores are all open (two corners decide, as in K2f) skips the
    // per-score mask.
    float tmax[2] = {-INFINITY, -INFINITY};
    auto scores = [&](auto all_open) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = rows[r], j = j0 + n * 8 + 2 * t + c;
            const bool valid =
                decltype(all_open)::value ||
                (i < q && j < klen &&
                 (uniform || !xl_masked(i, j, q, M, a.count, reset_row, a.same_length)));
            float v = -INFINITY;
            if (valid) v = uniform ? kMaskedScore : s[n][2 * r + c];
            s[n][2 * r + c] = v;
            tmax[r] = fmaxf(tmax[r], v);
          }
        }
      }
    };
    const int j1 = j0 + kT - 1;
    if (!uniform && iw0 + 15 < q && j1 < klen &&
        !xl_masked(iw0 + 15, j0, q, M, a.count, reset_row, a.same_length) &&
        !xl_masked(iw0, j1, q, M, a.count, reset_row, a.same_length))
      scores(std::true_type{});
    else
      scores(std::false_type{});
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(kFullMask, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(kFullMask, tmax[r], 2));
      const float m_new = fmaxf(m_run[r], tmax[r]);
      corr[r] = m_run[r] == -INFINITY ? 0.f : __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }

    // P (fp32 into l), dropped and rounded to bf16 as P V's A fragments
    uint32_t pf[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float pv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float sv_ = s[n][2 * r + c];
          const float p = sv_ == -INFINITY ? 0.f : __expf(sv_ - m_run[r]);
          l_run[r] += p;
          const int j = j0 + n * 8 + 2 * t + c;
          const bool keep = a.thr == 0u || drop_keep(row_key[r], j, a.thr);
          pv[c] = keep ? p : 0.f;
        }
        pf[n][r] = tc::pack_bf16(pv[0], pv[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: k-steps of 16 keys, n-tiles of 8 columns up to d_head
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                              pf[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        if (dp * 16 >= dh) break;
        uint32_t b[4];
        tc::load_b_cols(b, sv, kk * 16, dp * 16, lane);
        tc::mma(acc[2 * dp], pa, b[0], b[1]);
        if (dp * 16 + 8 < dh) tc::mma(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with these buffers before they are refilled
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(kFullMask, l, 1);
    l += __shfl_xor_sync(kFullMask, l, 2);
    const int i = rows[r];
    if (i >= q) continue;
    const long long row = static_cast<long long>(bh) * q + i;
    const bool whole = a.n_split == 1;
    const long long prow = (static_cast<long long>(split) * a.BH * q) + row;
    const float inv = whole ? (1.f / l) / (1.f - a.rate) : 1.f;
    float* out = whole ? a.o + row * dh : a.o_part + prow * dh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < dh) out[d] = acc[n][2 * r + c] * inv;
      }
    }
    if (t == 0) {
      if (whole) {
        a.m[row] = m_run[r];
        a.l[row] = l;
      } else {
        a.m_part[prow] = m_run[r];
        a.l_part[prow] = l;
      }
    }
  }
}

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3u) == 0; }

}  // namespace

int xl_attn_fwd_v2_tc(const void* qrw, const void* qrr, const void* kmem, const void* vmem,
                      const void* kcur, const void* vcur, const void* rk, const int* reset,
                      float* o, float* m, float* l, float* part, int BH, int B, int q_len,
                      int M, int dh, int count, int same_length, unsigned int seed,
                      unsigned int thr, float rate, int n_split, cudaStream_t stream) {
  if (dh < 1 || dh > tc::kDPad || B < 1 || n_split < 1 || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(BH) * q_len;
  FwdV2 a;
  a.qrw = static_cast<const bf16*>(qrw);
  a.qrr = static_cast<const bf16*>(qrr);
  a.kmem = static_cast<const bf16*>(kmem);
  a.vmem = static_cast<const bf16*>(vmem);
  a.kcur = static_cast<const bf16*>(kcur);
  a.vcur = static_cast<const bf16*>(vcur);
  a.rk = static_cast<const bf16*>(rk);
  a.reset = reset;
  a.o = o;
  a.m = m;
  a.l = l;
  a.o_part = part;
  a.m_part = part == nullptr ? nullptr : part + n_split * rows * dh;
  a.l_part = part == nullptr ? nullptr : a.m_part + n_split * rows;
  a.BH = BH;
  a.B = B;
  a.q_len = q_len;
  a.M = M;
  a.dh = dh;
  a.count = count;
  a.same_length = same_length;
  a.n_split = n_split;
  a.seed = seed;
  a.thr = thr;
  a.rate = rate;
  a.vec = dh % 2 == 0 && aligned4(kmem) && aligned4(vmem) && aligned4(kcur) &&
          aligned4(vcur) && aligned4(rk);
  const size_t smem = sizeof(bf16) * 6 * kE + sizeof(float) * 4 * tc::kScrFloats;
  cudaError_t e = tg_allow_smem(xl_attn_fwd_v2_tc_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((q_len + kT - 1) / kT, BH, n_split);
  xl_attn_fwd_v2_tc_kernel<<<grid, kThreads, smem, stream>>>(a);
  TG_CHECK();
  if (n_split > 1) return xl_attn_fwd_tc_combine(part, o, m, l, rows, dh, n_split, rate, stream);
  return 0;
}
