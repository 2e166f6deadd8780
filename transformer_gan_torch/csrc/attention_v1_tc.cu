// K2f in bf16: Transformer-XL attention forward with a precomputed position
// term, on Hopper's tensor cores (sm_90a, mma.sync m16n8k16 bf16 -> fp32).
//
// Replaces pallas_attention._fwd_kernel (reached through _fused_fwd_raw) of
// transformer_gan_tpu/ops for bf16 inputs; tg_xl_attn_fwd (attention.cu)
// sends bf16 with BD input here and keeps fp32 on the CUDA-core kernel of
// attention.cu, the exact on-card reference of the fp32 checks (tensor
// cores in fp32 would be TF32). Same function and rounding points as that
// kernel: S = (q k^T + BD) * scale in fp32, the xl_masked mask (the every-key
// masked window counts every key with kMaskedScore), an online softmax, the
// (seed, bh, i, j) dropout hash, the unnormalised P rounded to bf16 before
// P V, o = acc / l / (1 - rate), and m, l of the undropped exponentials.
//
// What bounds it on the H100: bytes. Each (q, k) score reads one bf16 of BD
// and does 4 * d_head flops, about 100 flops a byte against the card's 295
// (989 TFLOP/s over 3.35 TB/s), so BD and the K/V memory stream at HBM rate
// at best. The CUDA-core kernel it replaces ran ~400x above that bound: an
// fp32 50-long dot product per score on one lane, P V through 32 shuffles a
// key, and 80 blocks for 132 SMs at generation's prime shape (B 1, M 4146).
// Design:
//   * one block of 4 warps per (64-row query tile, bh, key split); each warp
//     owns 16 query rows and keeps their Q as A fragments (d_head 50
//     zero-padded to 64: four k-steps of 16);
//   * 64-key tiles from the first slot the count and reset masks leave open
//     to the causal edge; K, V and BD tiles double-buffered into shared rows
//     of 72 bf16 (144 bytes: ldmatrix-aligned, no bank conflicts) by 4-byte
//     cp.async, since 100-byte K/V rows and klen-long BD rows are not
//     16-byte aligned;
//   * S = Q K^T and O += P V on the tensor cores (V through ldmatrix.trans),
//     the softmax on the accumulator fragments with the row max taken over
//     the quad's shuffles and the row sum kept per thread until the end;
//   * split-K when BH x query tiles leaves the card under-filled (20 tiles at
//     B 1): each split writes a partial (o, m, l) to fp32 scratch and a
//     combine kernel merges the splits in a fixed order (no atomics: the
//     result is the same from run to run); a split with no open key has
//     m = -inf, l = 0 and adds nothing.
#include <type_traits>

#include "attention_args.cuh"
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps x 16 query rows
static_assert(kThreads == tc::kLoadThreads, "the tile loader's thread count");
constexpr int kT = tc::kTile;

struct FwdTc {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* bd;
  const int* reset;
  float* o;        // [BH, q, dh]  (n_split == 1)
  float* m;        // [BH, q]
  float* l;        // [BH, q]
  float* o_part;   // [n_split, BH, q, dh] unnormalised (n_split > 1)
  float* m_part;   // [n_split, BH, q]
  float* l_part;   // [n_split, BH, q]
  int BH, q_len, M, dh, count, same_length, n_split;
  unsigned int seed, thr;
  float scale, rate;
  bool vec_qkv, vec_bd;
};

__global__ void __launch_bounds__(kThreads) xl_attn_fwd_v1_tc_kernel(FwdTc a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_k = s_q + tc::kTileElems;       // 2 buffers
  bf16* s_v = s_k + 2 * tc::kTileElems;   // 2 buffers
  bf16* s_bd = s_v + 2 * tc::kTileElems;  // 2 buffers [query][key]

  const int bh = blockIdx.y, split = blockIdx.z;
  const int i0 = blockIdx.x * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = a.q_len, M = a.M, dh = a.dh, klen = M + q;
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const bool uniform = xl_all_masked(M, a.same_length);

  // Key tiles from the first open slot to the causal edge of the last row.
  int jlo = reset_row ? M : max(M - a.count, 0);
  jlo = (jlo / kT) * kT;
  const int jhi = uniform ? klen : min(klen, M + min(i0 + kT, q));
  const int n_t = (jhi - jlo + kT - 1) / kT;
  const int t_lo = split * n_t / a.n_split, t_hi = (split + 1) * n_t / a.n_split;

  const bf16* qb = a.q + static_cast<long long>(bh) * q * dh;
  const bf16* kb = a.k + static_cast<long long>(bh) * klen * dh;
  const bf16* vb = a.v + static_cast<long long>(bh) * klen * dh;
  const bf16* bdb = a.bd + static_cast<long long>(bh) * q * klen;

  auto load_kv = [&](int tile, int buf) {
    const int j0 = jlo + tile * kT;
    tc::load_tile(s_k + buf * tc::kTileElems, kb, dh, j0, klen, dh, a.vec_qkv);
    tc::load_tile(s_v + buf * tc::kTileElems, vb, dh, j0, klen, dh, a.vec_qkv);
    tc::load_tile(s_bd + buf * tc::kTileElems, bdb + j0, klen, i0, q, min(kT, klen - j0),
                  a.vec_bd);
  };

  tc::load_tile(s_q, qb, dh, i0, q, dh, a.vec_qkv);
  if (t_lo < t_hi) load_kv(t_lo, 0);
  tc::cp_async_commit();

  const int r0 = warp * 16;  // this warp's rows within the tile
  int rows[2];
  unsigned int row_key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = i0 + r0 + g + 8 * r;
    row_key[r] = drop_row_key(a.seed, bh, rows[r]);
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[4][4];

  for (int tt = t_lo; tt < t_hi; ++tt) {
    const int buf = (tt - t_lo) & 1;
    if (tt + 1 < t_hi) load_kv(tt + 1, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    if (tt == t_lo) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) tc::load_a(qf[kk], s_q, r0, kk * 16, lane);
    }
    const bf16* sk = s_k + buf * tc::kTileElems;
    const bf16* sv = s_v + buf * tc::kTileElems;
    const bf16* sbd = s_bd + buf * tc::kTileElems;
    const int j0 = jlo + tt * kT;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        tc::load_b_rows(b, sk, np * 16, kk * 16, lane);
        tc::mma(s[2 * np], qf[kk], b[0], b[1]);
        tc::mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // (S + BD) * scale, masked; the tile's row max over the quad. A warp
    // whose 16 x 64 scores are all open (each row's open keys are one
    // interval whose ends grow with the row, so two corners decide) skips
    // the per-score mask.
    float tmax[2] = {-INFINITY, -INFINITY};
    auto scores = [&](auto all_open) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int il = r0 + g + 8 * r, jl = n * 8 + 2 * t;
          const float2 bdv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sbd + il * tc::kStride + jl));
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = rows[r], j = j0 + jl + c;
            const bool valid =
                decltype(all_open)::value ||
                (i < q && j < klen &&
                 (uniform || !xl_masked(i, j, q, M, a.count, reset_row, a.same_length)));
            float v = -INFINITY;
            if (valid)
              v = uniform ? kMaskedScore : (s[n][2 * r + c] + (c ? bdv.y : bdv.x)) * a.scale;
            s[n][2 * r + c] = v;
            tmax[r] = fmaxf(tmax[r], v);
          }
        }
      }
    };
    const int iw0 = i0 + r0, j1 = j0 + kT - 1;
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
    __syncthreads();  // every warp is done with this buffer before it is refilled
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

// Merge the key splits of each row in split order: m = max m_s,
// w_s = exp(m_s - m) (0 for a split with no open key), l = sum w_s l_s,
// o = sum w_s o_s / l / (1 - rate). One warp per row, d_head <= 64.
__global__ void __launch_bounds__(kThreads)
xl_attn_fwd_v1_combine(const float* __restrict__ o_part, const float* __restrict__ m_part,
                       const float* __restrict__ l_part, float* __restrict__ o,
                       float* __restrict__ m, float* __restrict__ l, long long rows, int dh,
                       int n_split, float rate) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float mx = -INFINITY;
  for (int sp = 0; sp < n_split; ++sp) mx = fmaxf(mx, m_part[sp * rows + row]);
  float lsum = 0.f, o0 = 0.f, o1 = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const float ms = m_part[sp * rows + row];
    const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
    lsum += w * l_part[sp * rows + row];
    const float* op = o_part + (sp * rows + row) * dh;
    if (lane < dh) o0 += w * op[lane];
    if (lane + 32 < dh) o1 += w * op[lane + 32];
  }
  const float inv = (1.f / lsum) / (1.f - rate);
  if (lane < dh) o[row * dh + lane] = o0 * inv;
  if (lane + 32 < dh) o[row * dh + lane + 32] = o1 * inv;
  if (lane == 0) {
    m[row] = mx;
    l[row] = lsum;
  }
}

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3u) == 0; }

}  // namespace

int xl_attn_fwd_v1_tc(const void* q, const void* k, const void* v, const void* bd,
                      const int* reset, float* o, float* m, float* l, float* part,
                      int BH, int q_len, int M, int dh, int count, float scale,
                      int same_length, unsigned int seed, unsigned int thr, float rate,
                      int n_split, cudaStream_t stream) {
  if (dh < 1 || dh > tc::kDPad || n_split < 1 || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int klen = M + q_len;
  const long long rows = static_cast<long long>(BH) * q_len;
  FwdTc a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bd = static_cast<const bf16*>(bd);
  a.reset = reset;
  a.o = o;
  a.m = m;
  a.l = l;
  a.o_part = part;
  a.m_part = part == nullptr ? nullptr : part + n_split * rows * dh;
  a.l_part = part == nullptr ? nullptr : a.m_part + n_split * rows;
  a.BH = BH;
  a.q_len = q_len;
  a.M = M;
  a.dh = dh;
  a.count = count;
  a.same_length = same_length;
  a.n_split = n_split;
  a.seed = seed;
  a.thr = thr;
  a.scale = scale;
  a.rate = rate;
  a.vec_qkv = dh % 2 == 0 && aligned4(q) && aligned4(k) && aligned4(v);
  a.vec_bd = klen % 2 == 0 && aligned4(bd);
  const size_t smem = sizeof(bf16) * 7 * tc::kTileElems;
  cudaError_t e = tg_allow_smem(xl_attn_fwd_v1_tc_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((q_len + kT - 1) / kT, BH, n_split);
  xl_attn_fwd_v1_tc_kernel<<<grid, kThreads, smem, stream>>>(a);
  TG_CHECK();
  if (n_split > 1) return xl_attn_fwd_tc_combine(part, o, m, l, rows, dh, n_split, rate, stream);
  return 0;
}

int xl_attn_fwd_tc_combine(const float* part, float* o, float* m, float* l, long long rows,
                           int dh, int n_split, float rate, cudaStream_t stream) {
  const float* m_part = part + n_split * rows * dh;
  const float* l_part = m_part + n_split * rows;
  const unsigned int blocks = static_cast<unsigned int>((rows + 3) / 4);
  xl_attn_fwd_v1_combine<<<blocks, kThreads, 0, stream>>>(part, m_part, l_part, o, m, l, rows,
                                                          dh, n_split, rate);
  TG_CHECK();
  return 0;
}
