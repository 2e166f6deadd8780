// K2b in bf16: Transformer-XL attention backward with a precomputed position
// term, on Hopper's tensor cores (sm_90a, mma.sync m16n8k16 bf16 -> fp32).
//
// Replaces pallas_attention._bwd_kernel (reached through _fused_bwd_raw) of
// transformer_gan_tpu/ops for bf16 inputs; tg_xl_attn_bwd (attention_bwd.cu)
// sends bf16 with BD input here and keeps fp32 on the CUDA-core kernels of
// attention_bwd.cu, the exact on-card reference of the fp32 checks. Same
// function and rounding points as those: P = exp(S - m) / l from the
// forward's row max and sum, the forward's dropout mask from the
// (seed, bh, i, j) hash, dS = P (dP - D) with D = rowsum(dout * o),
// dbd = dS * scale and P_drop rounded to bf16 before they feed dk, dv and
// dq, fp32 accumulation rounded once on store. dout arrives in fp32 and is
// rounded to bf16 once for the tensor cores (dP and dV read it).
//
// What bounds it on the H100: bytes. At the training shape (B 128, H 10,
// q 128, M 0) it reads q, k, v, BD, o and dout and writes dq, dk, dv and the
// score-sized dbd (42 MB in and 42 MB out for BD alone); the five products
// are about 20 flops a byte. The CUDA-core kernels it replaces recomputed S
// and dP twice in fp32 (a rows and a cols pass) and their wrapper zero-filled
// dbd before they wrote it.
// Design, FlashAttention-2 style:
//   * prologue: D = rowsum(dout * o) in fp32 and dout rounded to bf16 into
//     scratch, one warp a row;
//   * key pass: one block of 4 warps per (64-key tile, bh), each warp owning
//     16 keys. It walks the 64-row query tiles that can see its keys (Q,
//     dout and BD double-buffered by 4-byte cp.async into 144-byte shared
//     rows) and computes S^T = K Q^T + BD^T and dP^T = V dout^T on the
//     tensor cores, then P, dS and P_drop on the fragments, and accumulates
//     dV += P_drop^T dout and dK += dbd^T Q in registers from those
//     fragments. dbd goes through shared memory to coalesced stores; query
//     tiles that see none of the keys get their zeros written, so every
//     entry of dbd is written once and the wrapper does not zero it;
//   * dq pass: one block per (64-row query tile, bh) reads the bf16 dbd
//     just written (rounded as the plain version feeds dq) over the key
//     tiles the forward visits and computes dq = dbd K on the tensor cores.
//     Each output has one writer: no atomics.
#include <type_traits>

#include "attention_args.cuh"
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
static_assert(kThreads == tc::kLoadThreads, "the tile loader's thread count");
constexpr int kT = tc::kTile;

struct BwdTc {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* bd;
  const bf16* dout;   // bf16 scratch
  const float* dsum;  // D per row
  const float* m;
  const float* l;
  const int* reset;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  bf16* dbd;
  int BH, q_len, M, dh, count, same_length;
  unsigned int seed, thr;
  float scale, rate;
  bool vec_qkv, vec_bd;
};

// D = rowsum(dout * o) (fp32, in the order of attention_bwd.cu) and dout
// rounded to bf16; one warp a row.
__global__ void __launch_bounds__(kThreads)
xl_attn_bwd_v1_tc_prologue(const float* __restrict__ dout, const float* __restrict__ o,
                           bf16* __restrict__ dout_lp, float* __restrict__ dsum,
                           long long rows, int dh) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float part = 0.f;
  for (int d = lane; d < dh; d += 32) {
    const float g = dout[row * dh + d];
    part += g * o[row * dh + d];
    dout_lp[row * dh + d] = __float2bfloat16_rn(g);
  }
  part = warp_sum(part);
  if (lane == 0) dsum[row] = part;
}

__global__ void __launch_bounds__(kThreads) xl_attn_bwd_v1_tc_keys(BwdTc a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_v = s_k + tc::kTileElems;
  bf16* s_q = s_v + tc::kTileElems;      // 2 buffers [query][d]
  bf16* s_do = s_q + 2 * tc::kTileElems;  // 2 buffers [query][d]
  bf16* s_bd = s_do + 2 * tc::kTileElems; // 2 buffers [query][key]
  bf16* s_ds = s_bd + 2 * tc::kTileElems; // [query][key], dbd of the tile
  float* s_m = reinterpret_cast<float*>(s_ds + tc::kTileElems);  // [2][64]
  float* s_l = s_m + 2 * kT;
  float* s_D = s_l + 2 * kT;
  unsigned int* s_rk = reinterpret_cast<unsigned int*>(s_D + 2 * kT);

  const int bh = blockIdx.y, j0 = blockIdx.x * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = a.q_len, M = a.M, dh = a.dh, klen = M + q;
  const int nq = (q + kT - 1) / kT;
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const bool uniform = xl_all_masked(M, a.same_length);
  const int jfirst = reset_row ? M : max(M - a.count, 0);  // first key any row sees
  const int kcols = min(kT, klen - j0);

  // Query tiles [qt_lo, nq) can see a key of this tile; the others only get
  // the zeros of their dbd block.
  int qt_lo = 0;
  if (!uniform) {
    if (j0 + kT <= jfirst) {
      qt_lo = nq;
    } else {
      while (qt_lo < nq && M + min(qt_lo * kT + kT, q) <= j0) ++qt_lo;
    }
  }
  bf16* dbdb = a.dbd + static_cast<long long>(bh) * q * klen;
  const int zrows = min(qt_lo * kT, q);
  for (int e = threadIdx.x; e < zrows * kcols; e += kThreads) {
    const int i = e / kcols, c = e % kcols;
    dbdb[static_cast<long long>(i) * klen + j0 + c] = __float2bfloat16_rn(0.f);
  }

  const bf16* kb = a.k + static_cast<long long>(bh) * klen * dh;
  const bf16* vb = a.v + static_cast<long long>(bh) * klen * dh;
  const bf16* qb = a.q + static_cast<long long>(bh) * q * dh;
  const bf16* dob = a.dout + static_cast<long long>(bh) * q * dh;
  const bf16* bdb = a.bd + static_cast<long long>(bh) * q * klen;

  auto load_rows = [&](int qt, int buf) {
    const int i0 = qt * kT;
    tc::load_tile(s_q + buf * tc::kTileElems, qb, dh, i0, q, dh, a.vec_qkv);
    tc::load_tile(s_do + buf * tc::kTileElems, dob, dh, i0, q, dh, a.vec_qkv);
    tc::load_tile(s_bd + buf * tc::kTileElems, bdb + j0, klen, i0, q, kcols, a.vec_bd);
    if (threadIdx.x < kT) {
      const int i = i0 + threadIdx.x;
      const long long row = static_cast<long long>(bh) * q + i;
      s_m[buf * kT + threadIdx.x] = i < q ? a.m[row] : 0.f;
      s_l[buf * kT + threadIdx.x] = i < q ? 1.f / a.l[row] : 1.f;  // 1 / l
      s_D[buf * kT + threadIdx.x] = i < q ? a.dsum[row] : 0.f;
      s_rk[buf * kT + threadIdx.x] = drop_row_key(a.seed, bh, i);
    }
  };

  const int kw0 = warp * 16;  // this warp's keys within the tile
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (qt_lo < nq) {
    tc::load_tile(s_k, kb, dh, j0, klen, dh, a.vec_qkv);
    tc::load_tile(s_v, vb, dh, j0, klen, dh, a.vec_qkv);
    load_rows(qt_lo, 0);
  }
  tc::cp_async_commit();
  const float keep_scale = 1.f / (1.f - a.rate);

  for (int qt = qt_lo; qt < nq; ++qt) {
    const int buf = (qt - qt_lo) & 1;
    if (qt + 1 < nq) load_rows(qt + 1, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* sq = s_q + buf * tc::kTileElems;
    const bf16* sdo = s_do + buf * tc::kTileElems;
    const bf16* sbd = s_bd + buf * tc::kTileElems;
    const float* sm = s_m + buf * kT;
    const float* sl = s_l + buf * kT;
    const float* sD = s_D + buf * kT;
    const unsigned int* srk = s_rk + buf * kT;
    const int i0 = qt * kT;

    // S^T = K Q^T and dP^T = V dout^T: 16 keys x 64 queries per warp
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ka[4], va[4];
      tc::load_a(ka, s_k, kw0, kk * 16, lane);
      tc::load_a(va, s_v, kw0, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        tc::load_b_rows(b, sq, np * 16, kk * 16, lane);
        tc::mma(st[2 * np], ka, b[0], b[1]);
        tc::mma(st[2 * np + 1], ka, b[2], b[3]);
        tc::load_b_rows(b, sdo, np * 16, kk * 16, lane);
        tc::mma(dpt[2 * np], va, b[0], b[1]);
        tc::mma(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }

    // P, dS * scale and P_drop per element, rounded to bf16: packed as the
    // A fragments of dK and dV (rows = keys, k = queries), and dbd to shared.
    // A warp whose 16 keys x 64 queries are all open (two corners decide, as
    // in the forward) skips the per-score mask.
    uint32_t dsf[8][2], pdf[8][2];
    auto grads = [&](auto all_open) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int jl = kw0 + g + 8 * r, j = j0 + jl;
          float dsv[2], pdv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int il = n * 8 + 2 * t + c, i = i0 + il;
            const bool valid =
                decltype(all_open)::value ||
                (i < q && j < klen &&
                 (uniform || !xl_masked(i, j, q, M, a.count, reset_row, a.same_length)));
            float ds = 0.f, pd = 0.f;
            if (valid) {
              const float s =
                  uniform ? kMaskedScore
                          : (st[n][2 * r + c] +
                             __bfloat162float(sbd[il * tc::kStride + jl])) * a.scale;
              const float p = __expf(s - sm[il]) * sl[il];
              const bool keep = a.thr == 0u || drop_keep(srk[il], j, a.thr);
              const float dp = keep ? dpt[n][2 * r + c] * keep_scale : 0.f;
              ds = p * (dp - sD[il]) * a.scale;
              pd = keep ? p * keep_scale : 0.f;
            }
            dsv[c] = ds;
            pdv[c] = pd;
            s_ds[il * tc::kStride + jl] = __float2bfloat16_rn(ds);
          }
          dsf[n][r] = tc::pack_bf16(dsv[0], dsv[1]);
          pdf[n][r] = tc::pack_bf16(pdv[0], pdv[1]);
        }
      }
    };
    const int jw0 = j0 + kw0, jw1 = jw0 + 15;
    if (!uniform && i0 + kT - 1 < q && jw1 < klen &&
        !xl_masked(i0 + kT - 1, jw0, q, M, a.count, reset_row, a.same_length) &&
        !xl_masked(i0, jw1, q, M, a.count, reset_row, a.same_length))
      grads(std::true_type{});
    else
      grads(std::false_type{});

    // dV += P_drop^T dout, dK += dbd^T Q: k-steps of 16 queries
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pdf[2 * kk][0], pdf[2 * kk][1], pdf[2 * kk + 1][0],
                              pdf[2 * kk + 1][1]};
      const uint32_t da[4] = {dsf[2 * kk][0], dsf[2 * kk][1], dsf[2 * kk + 1][0],
                              dsf[2 * kk + 1][1]};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        if (dp * 16 >= dh) break;
        uint32_t b[4];
        tc::load_b_cols(b, sdo, kk * 16, dp * 16, lane);
        tc::mma(dv_acc[2 * dp], pa, b[0], b[1]);
        if (dp * 16 + 8 < dh) tc::mma(dv_acc[2 * dp + 1], pa, b[2], b[3]);
        tc::load_b_cols(b, sq, kk * 16, dp * 16, lane);
        tc::mma(dk_acc[2 * dp], da, b[0], b[1]);
        if (dp * 16 + 8 < dh) tc::mma(dk_acc[2 * dp + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // the tile's dbd is complete in shared memory

    const int qrows = min(kT, q - i0);
    if (a.vec_bd) {
      const int wpr = kcols >> 1;
      for (int e = threadIdx.x; e < qrows * wpr; e += kThreads) {
        const int il = e / wpr, c = (e % wpr) * 2;
        *reinterpret_cast<uint32_t*>(dbdb + static_cast<long long>(i0 + il) * klen + j0 + c) =
            *reinterpret_cast<const uint32_t*>(s_ds + il * tc::kStride + c);
      }
    } else {
      for (int e = threadIdx.x; e < qrows * kcols; e += kThreads) {
        const int il = e / kcols, c = e % kcols;
        dbdb[static_cast<long long>(i0 + il) * klen + j0 + c] = s_ds[il * tc::kStride + c];
      }
    }
    __syncthreads();  // buffers and s_ds are free for the next tile
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + kw0 + g + 8 * r;
    if (j >= klen) continue;
    const long long row = (static_cast<long long>(bh) * klen + j) * dh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < dh) {
          a.dk[row + d] = __float2bfloat16_rn(dk_acc[n][2 * r + c]);
          a.dv[row + d] = __float2bfloat16_rn(dv_acc[n][2 * r + c]);
        }
      }
    }
  }
}

// dq = dbd K over the key tiles the forward visits (dbd is zero outside).
__global__ void __launch_bounds__(kThreads) xl_attn_bwd_v1_tc_dq(BwdTc a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_a = reinterpret_cast<bf16*>(smem_raw);  // 2 buffers [query][key] of dbd
  bf16* s_k = s_a + 2 * tc::kTileElems;          // 2 buffers [key][d]

  const int bh = blockIdx.y, i0 = blockIdx.x * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = a.q_len, M = a.M, dh = a.dh, klen = M + q;
  const bool reset_row = a.reset != nullptr && a.reset[bh] != 0;
  const bool uniform = xl_all_masked(M, a.same_length);
  int jlo = reset_row ? M : max(M - a.count, 0);
  jlo = (jlo / kT) * kT;
  const int jhi = uniform ? klen : min(klen, M + min(i0 + kT, q));
  const int n_t = (jhi - jlo + kT - 1) / kT;

  const bf16* kb = a.k + static_cast<long long>(bh) * klen * dh;
  const bf16* dbdb = a.dbd + static_cast<long long>(bh) * q * klen;
  auto load = [&](int tile, int buf) {
    const int j0 = jlo + tile * kT;
    tc::load_tile(s_a + buf * tc::kTileElems, dbdb + j0, klen, i0, q, min(kT, klen - j0),
                  a.vec_bd);
    tc::load_tile(s_k + buf * tc::kTileElems, kb, dh, j0, klen, dh, a.vec_qkv);
  };
  load(0, 0);
  tc::cp_async_commit();

  const int r0 = warp * 16;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tt = 0; tt < n_t; ++tt) {
    const int buf = tt & 1;
    if (tt + 1 < n_t) load(tt + 1, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* sa = s_a + buf * tc::kTileElems;
    const bf16* sk = s_k + buf * tc::kTileElems;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      tc::load_a(af, sa, r0, kk * 16, lane);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        if (dp * 16 >= dh) break;
        uint32_t b[4];
        tc::load_b_cols(b, sk, kk * 16, dp * 16, lane);
        tc::mma(acc[2 * dp], af, b[0], b[1]);
        if (dp * 16 + 8 < dh) tc::mma(acc[2 * dp + 1], af, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r0 + g + 8 * r;
    if (i >= q) continue;
    const long long row = (static_cast<long long>(bh) * q + i) * dh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n * 8 + 2 * t + c;
        if (d < dh) a.dq[row + d] = __float2bfloat16_rn(acc[n][2 * r + c]);
      }
    }
  }
}

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3u) == 0; }

}  // namespace

int xl_attn_bwd_tc_prologue(const float* dout, const float* o, void* dout_lp, float* dsum,
                            long long rows, int dh, cudaStream_t stream) {
  xl_attn_bwd_v1_tc_prologue<<<static_cast<unsigned int>((rows + 3) / 4), kThreads, 0,
                               stream>>>(dout, o, static_cast<bf16*>(dout_lp), dsum, rows, dh);
  TG_CHECK();
  return 0;
}

int xl_attn_bwd_v1_tc(const BwdArgs& args, cudaStream_t stream) {
  if (args.dh < 1 || args.dh > tc::kDPad || args.dout_lp == nullptr || args.dsum == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = args.q, klen = args.M + args.q, dh = args.dh;
  const long long rows = static_cast<long long>(args.BH) * q;
  BwdTc a;
  a.q = static_cast<const bf16*>(args.qrw);
  a.k = static_cast<const bf16*>(args.kmem);
  a.v = static_cast<const bf16*>(args.vmem);
  a.bd = static_cast<const bf16*>(args.bd);
  a.dout = static_cast<const bf16*>(args.dout_lp);
  a.dsum = args.dsum;
  a.m = args.m;
  a.l = args.l;
  a.reset = args.reset;
  a.dq = static_cast<bf16*>(args.dq);
  a.dk = static_cast<bf16*>(args.dk);
  a.dv = static_cast<bf16*>(args.dv);
  a.dbd = static_cast<bf16*>(args.dbd);
  a.BH = args.BH;
  a.q_len = q;
  a.M = args.M;
  a.dh = dh;
  a.count = args.count;
  a.same_length = args.same_length;
  a.seed = args.seed;
  a.thr = args.thr;
  a.scale = args.scale;
  a.rate = args.rate;
  a.vec_qkv = dh % 2 == 0 && aligned4(a.q) && aligned4(a.k) && aligned4(a.v) &&
              aligned4(a.dout);
  a.vec_bd = klen % 2 == 0 && aligned4(a.bd) && aligned4(a.dbd);

  const int rc = xl_attn_bwd_tc_prologue(args.dout, args.o, args.dout_lp, args.dsum, rows, dh,
                                         stream);
  if (rc != 0) return rc;
  {
    const size_t smem = sizeof(bf16) * 9 * tc::kTileElems + sizeof(float) * 8 * kT;
    cudaError_t e = tg_allow_smem(xl_attn_bwd_v1_tc_keys, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((klen + kT - 1) / kT, args.BH);
    xl_attn_bwd_v1_tc_keys<<<grid, kThreads, smem, stream>>>(a);
    TG_CHECK();
  }
  {
    const size_t smem = sizeof(bf16) * 4 * tc::kTileElems;
    cudaError_t e = tg_allow_smem(xl_attn_bwd_v1_tc_dq, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((q + kT - 1) / kT, args.BH);
    xl_attn_bwd_v1_tc_dq<<<grid, kThreads, smem, stream>>>(a);
    TG_CHECK();
  }
  return 0;
}
