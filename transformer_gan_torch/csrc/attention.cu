// Transformer-XL relative attention forward, hand-written for Hopper (sm_90a).
//
// Replaces two TPU kernels of transformer_gan_tpu/ops:
//   * pallas_attention_v2._fwd_kernel (reached through _fwd_raw): the position
//     term BD[i, j] = qrr[i] . rk[q-1-i+j] is computed in the kernel
//     (BD_IN = false; the prime and the debug re-prime of generation use it);
//   * pallas_attention._fwd_kernel (reached through _fused_fwd_raw): BD is
//     read from a precomputed [BH, q, klen] input (BD_IN = true).
// Both write o = softmax(S) V in fp32 and the row max m and row sum l of the
// unnormalised exponentials, with the mask of pallas_attention._mask_block
// (memory valid count, per-row reset, same_length band; same_length without
// memory masks every key, and then every key counts with the masked score, a
// uniform average, as in the TPU kernels). Attention dropout
// (training) zeroes P where the (seed, bh, i, j) hash of common.cuh falls
// below thr and scales o by 1 / (1 - rate) after P V, as the TPU kernels do;
// l stays the sum of the undropped exponentials. The backward kernels
// (attention_bwd.cu) redraw the same mask.
//
// What bounds it on the H100: at the prime op-point (H 10, q <= 128, M 4146,
// dh 50) each (h, b) block streams its K/V memory once, 2 * M * dh * 2 bytes
// in bf16 (0.8 MB), and does 3 * q * (M + q) * dh multiply-adds (FLOPs and
// bytes are both small; the kernel runs on the CUDA cores in fp32).
// Design: one block per (16-row query tile, h * B + b); four warps own four
// query rows each and a lane owns one key of a 32-key tile, so a key tile is
// read from shared memory by all 16 rows. An online (running max) fp32
// softmax walks the key tiles, which starts at the first slot the count and
// reset masks leave open and stops at the causal edge. d_head 50 is no power
// of two: rows sit in shared memory at an odd stride (conflict-free column
// reads) and each lane keeps up to four output columns (d_head <= 128).
// Tensor-core MMA, TMA and splitting the keys across blocks are left for
// later work.
#include "common.cuh"

namespace {

constexpr int kRows = 16;      // query rows per block: 4 warps x 4 rows
constexpr int kKeyTile = 32;   // keys per tile: one per lane
constexpr int kThreads = 128;
constexpr int kMaxDPL = 4;     // output columns per lane: d_head <= 128

template <typename T, bool BD_IN>
__global__ void __launch_bounds__(kThreads)
xl_attn_fwd_kernel(const T* __restrict__ qrw, const T* __restrict__ qrr,
                   const T* __restrict__ kmem, const T* __restrict__ vmem,
                   long long mem_bh,
                   const T* __restrict__ kcur, const T* __restrict__ vcur,
                   long long cur_bh,
                   const T* __restrict__ rk, const T* __restrict__ bd,
                   const int* __restrict__ reset,
                   float* __restrict__ o, float* __restrict__ m_out,
                   float* __restrict__ l_out,
                   int B, int q, int M, int dh, int count, float scale,
                   int same_length, unsigned int seed, unsigned int thr,
                   float rate) {
  extern __shared__ float smem[];
  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int klen = M + q;
  const int kp = klen + q;               // rows of rk per head
  const int ds = dh | 1;                 // odd row stride in shared memory
  const int n_rk = kKeyTile + kRows - 1; // rk rows one key tile touches
  float* s_qw = smem;                    // [kRows][ds]
  float* s_qr = s_qw + kRows * ds;       // [kRows][ds]
  float* s_k = s_qr + kRows * ds;        // [kKeyTile][ds]
  float* s_v = s_k + kKeyTile * ds;      // [kKeyTile][ds]
  float* s_rk = s_v + kKeyTile * ds;     // [n_rk][ds]  (BD_IN == false)

  const bool reset_row = reset != nullptr && reset[bh] != 0;
  const long long qbase = static_cast<long long>(bh) * q * dh;

  for (int e = threadIdx.x; e < kRows * dh; e += blockDim.x) {
    const int r = e / dh, d = e % dh, i = i0 + r;
    float a = 0.f, b = 0.f;
    if (i < q) {
      a = to_f<T>(qrw[qbase + static_cast<long long>(i) * dh + d]);
      if (!BD_IN) b = to_f<T>(qrr[qbase + static_cast<long long>(i) * dh + d]);
    }
    s_qw[r * ds + d] = a;
    s_qr[r * ds + d] = b;
  }

  float m_run[4], l_run[4], acc[4][kMaxDPL];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    m_run[rr] = -INFINITY;
    l_run[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxDPL; ++c) acc[rr][c] = 0.f;
  }

  // Keys left of the valid tail (or all memory on a reset row) are masked
  // for every row; keys right of the last row's causal edge too.
  int jlo = reset_row ? M : max(M - count, 0);
  jlo = (jlo / kKeyTile) * kKeyTile;
  const bool uniform = xl_all_masked(M, same_length);
  const int jhi = uniform ? klen : min(klen, M + min(i0 + kRows, q));
  const int h = bh / B;

  for (int j0 = jlo; j0 < jhi; j0 += kKeyTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kKeyTile * dh; e += blockDim.x) {
      const int r = e / dh, d = e % dh, j = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < M) {
        const long long off = bh * mem_bh + static_cast<long long>(j) * dh + d;
        kv = to_f<T>(kmem[off]);
        vv = to_f<T>(vmem[off]);
      } else if (j < klen) {
        const long long off = bh * cur_bh + static_cast<long long>(j - M) * dh + d;
        kv = to_f<T>(kcur[off]);
        vv = to_f<T>(vcur[off]);
      }
      s_k[r * ds + d] = kv;
      s_v[r * ds + d] = vv;
    }
    // rk rows c = q-1-i+j for the tile's rows and keys: c0 .. c0+n_rk-1
    const int c0 = q - 1 - (i0 + kRows - 1) + j0;
    if (!BD_IN) {
      for (int e = threadIdx.x; e < n_rk * dh; e += blockDim.x) {
        const int r = e / dh, d = e % dh, c = c0 + r;
        float v = 0.f;
        if (c >= 0 && c < kp)
          v = to_f<T>(rk[(static_cast<long long>(h) * kp + c) * dh + d]);
        s_rk[r * ds + d] = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = warp * 4 + rr, i = i0 + r;
      if (i >= q) continue;  // warp-uniform
      const int j = j0 + lane;
      const bool valid =
          j < klen && (uniform || !xl_masked(i, j, q, M, count, reset_row, same_length));
      float s = -INFINITY;
      if (uniform && valid) {
        s = kMaskedScore;
      } else if (valid) {
        float ac = 0.f;
        for (int d = 0; d < dh; ++d) ac += s_qw[r * ds + d] * s_k[lane * ds + d];
        if (BD_IN) {
          const float b = to_f<T>(bd[(static_cast<long long>(bh) * q + i) * klen + j]);
          s = (ac + b) * scale;
        } else {
          const int c = q - 1 - i + j - c0;
          float bdv = 0.f;
          for (int d = 0; d < dh; ++d) bdv += s_qr[r * ds + d] * s_rk[c * ds + d];
          s = ac + bdv;  // queries arrive pre-scaled
        }
      }
      const float m_new = fmaxf(m_run[rr], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = m_run[rr] == -INFINITY ? 0.f : expf(m_run[rr] - m_new);
      l_run[rr] = l_run[rr] * corr + warp_sum(p);
      m_run[rr] = m_new;
      // P is rounded to the value type before P V (after dropout)
      const bool keep =
          thr == 0u || drop_keep(drop_row_key(seed, bh, i), j, thr);
      const float pv = rnd<T>(keep ? p : 0.f);
#pragma unroll
      for (int c = 0; c < kMaxDPL; ++c) acc[rr][c] *= corr;
      for (int jj = 0; jj < kKeyTile; ++jj) {
        const float pj = __shfl_sync(kFullMask, pv, jj);
        if (pj == 0.f) continue;  // warp-uniform
#pragma unroll
        for (int c = 0; c < kMaxDPL; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) acc[rr][c] += pj * s_v[jj * ds + d];
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = i0 + warp * 4 + rr;
    if (i >= q) continue;
    const float inv = (1.f / l_run[rr]) / (1.f - rate);
#pragma unroll
    for (int c = 0; c < kMaxDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) o[qbase + static_cast<long long>(i) * dh + d] = acc[rr][c] * inv;
    }
    if (lane == 0) {
      m_out[static_cast<long long>(bh) * q + i] = m_run[rr];
      l_out[static_cast<long long>(bh) * q + i] = l_run[rr];
    }
  }
}

template <typename T, bool BD_IN>
int launch(const void* qrw, const void* qrr, const void* kmem, const void* vmem,
           long long mem_bh, const void* kcur, const void* vcur, long long cur_bh,
           const void* rk, const void* bd, const int* reset, float* o, float* m,
           float* l, int BH, int B, int q, int M, int dh, int count, float scale,
           int same_length, unsigned int seed, unsigned int thr, float rate,
           cudaStream_t stream) {
  const int ds = dh | 1;
  const size_t smem =
      sizeof(float) * ds * (2 * kRows + 2 * kKeyTile + (BD_IN ? 0 : kKeyTile + kRows - 1));
  auto kernel = xl_attn_fwd_kernel<T, BD_IN>;
  cudaError_t e = tg_allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((q + kRows - 1) / kRows, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qrw), static_cast<const T*>(qrr),
      static_cast<const T*>(kmem), static_cast<const T*>(vmem), mem_bh,
      static_cast<const T*>(kcur), static_cast<const T*>(vcur), cur_bh,
      static_cast<const T*>(rk), static_cast<const T*>(bd), reset, o, m, l, B, q,
      M, dh, count, scale, same_length, seed, thr, rate);
  TG_CHECK();
  return 0;
}

}  // namespace

// o, m, l: fp32 [BH, q, dh], [BH, q], [BH, q]. Block index bh = h * B + b for
// the in-kernel-BD form; any [BH, ...] order for the BD-input form.
// Memory K/V of block bh start at kmem + bh * mem_bh, current K/V at
// kcur + bh * cur_bh; rows are dh apart. reset may be null (no reset rows).
// Dropout: thr = 0 keeps everything (rate must then be 0).
extern "C" int tg_xl_attn_fwd(int dtype, int bd_in, const void* qrw, const void* qrr,
                              const void* kmem, const void* vmem, long long mem_bh,
                              const void* kcur, const void* vcur, long long cur_bh,
                              const void* rk, const void* bd, const void* reset,
                              void* o, void* m, void* l, int BH, int B, int q, int M,
                              int dh, int count, float scale, int same_length,
                              unsigned int seed, unsigned int thr, float rate,
                              void* stream) {
  if (dh > 32 * kMaxDPL || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto rs = static_cast<const int*>(reset);
  auto fo = static_cast<float*>(o);
  auto fm = static_cast<float*>(m);
  auto fl = static_cast<float*>(l);
  if (dtype == 0 && bd_in)
    return launch<float, true>(qrw, qrr, kmem, vmem, mem_bh, kcur, vcur, cur_bh, rk, bd,
                               rs, fo, fm, fl, BH, B, q, M, dh, count, scale,
                               same_length, seed, thr, rate, st);
  if (dtype == 0)
    return launch<float, false>(qrw, qrr, kmem, vmem, mem_bh, kcur, vcur, cur_bh, rk, bd,
                                rs, fo, fm, fl, BH, B, q, M, dh, count, scale,
                                same_length, seed, thr, rate, st);
  if (dtype == 1 && bd_in)
    return launch<__nv_bfloat16, true>(qrw, qrr, kmem, vmem, mem_bh, kcur, vcur, cur_bh,
                                       rk, bd, rs, fo, fm, fl, BH, B, q, M, dh, count,
                                       scale, same_length, seed, thr, rate, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(qrw, qrr, kmem, vmem, mem_bh, kcur, vcur, cur_bh,
                                        rk, bd, rs, fo, fm, fl, BH, B, q, M, dh, count,
                                        scale, same_length, seed, thr, rate, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
