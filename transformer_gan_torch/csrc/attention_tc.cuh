// Tensor-core tile engine of the port's bf16 attention kernels (sm_90a):
// mma.sync.aligned.m16n8k16 bf16 -> fp32, ldmatrix, cp.async, and the
// loader that brings a ragged [rows][cols] bf16 tile into a padded shared
// tile.
//
// Shared tiles are kTile x kTile bf16 at a row stride of kStride
// (64 + 8 elements, 144 bytes): every row starts 16-byte aligned, as
// ldmatrix needs, and the eight rows of an 8x8 ldmatrix matrix fall on
// distinct banks. d_head <= 64 is zero-padded to 64, so every product runs
// four k-steps of 16 and the padding adds nothing.
//
// Fragment layouts (PTX ISA, m16n8k16; g = lane / 4, t = lane % 4):
//   A (16x16): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] = (g, 2t+8..),
//              a[3] = (g+8, 2t+8..)
//   B (16x8):  b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g)
//   C (16x8):  c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
// so the C fragments of two neighbouring 8-column tiles are the A fragment
// of one 16-wide k-step (the softmax's P feeds the next product from
// registers).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int kTile = 64;         // rows and columns of every tile
constexpr int kStride = 72;       // shared row stride in bf16 elements
constexpr int kTileElems = kTile * kStride;
constexpr int kDPad = 64;         // d_head padded to four k-steps
constexpr int kLoadThreads = 128; // threads of every block that loads tiles

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D += A B, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int c0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = c0 + (lane >> 4) * 8;
  ldmatrix_x4(a, tile + r * kStride + c);
}

// B fragments of a product X Y^T where Y is a row-major tile [n][k]: rows
// n0..n0+15 of Y (two 8-wide n-tiles), columns k0..k0+15.
// b[0], b[1]: n-tile n0; b[2], b[3]: n-tile n0 + 8.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                            int n0, int k0, int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4(b, tile + r * kStride + c);
}

// B fragments of a product X Y where Y is a row-major tile [k][n]: rows
// k0..k0+15 of Y, columns n0..n0+15 (two n-tiles), read transposed.
// b[0], b[1]: n-tile n0; b[2], b[3]: n-tile n0 + 8.
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                            int k0, int n0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldmatrix_x4_trans(b, tile + r * kStride + c);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;  // 0 source bytes: the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fill shared rows 0..kRows-1 of a tile with bf16 rows of device memory:
// row(r) gives the source of row r, or nullptr for a row that reads as zero
// (a ragged edge, a window row below 0, a key past the end); columns >=
// cols read as zero (the padding of d_head), so the padding adds nothing to
// any product. `any` is a valid device address, the source of the
// zero-filled copies. When `vec4` (even cols and every row 4-byte aligned)
// the copy is 4-byte cp.async with zero fill (the caller commits and
// waits), else 2-byte loads through registers. Rows need not be 16-byte
// aligned: d_head 50 gives 100-byte rows.
// Every kernel of the engine runs kLoadThreads threads: a warp copies one
// row a step, each lane one 4-byte word, so a thread's column is fixed and
// the row loop unrolls.
template <int kRows, typename RowPtr>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, RowPtr row, int cols,
                                          bool vec4, const __nv_bfloat16* any) {
  if (vec4) {
    constexpr int wpr = kTile / 2;  // 4-byte words per row
    static_assert(kRows * wpr % kLoadThreads == 0, "whole steps");
    const int c = (threadIdx.x % wpr) * 2, r0 = threadIdx.x / wpr;
    const bool col_ok = c < cols;
#pragma unroll
    for (int k = 0; k < kRows * wpr / kLoadThreads; ++k) {
      const int r = r0 + k * (kLoadThreads / wpr);
      const __nv_bfloat16* src = row(r);
      const bool ok = src != nullptr && col_ok;
      cp_async4(tile + r * kStride + c, ok ? src + c : any, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kTile; e += blockDim.x) {
      const int r = e / kTile, c = e % kTile;
      const __nv_bfloat16* src = row(r);
      tile[r * kStride + c] =
          (src != nullptr && c < cols) ? src[c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Rows r0..r0+63 of a row-major bf16 matrix with `ld` elements per row;
// rows >= n_rows read as zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                          long long ld, int r0, int n_rows, int cols,
                                          bool vec4) {
  load_rows<kTile>(
      tile,
      [=](int r) -> const __nv_bfloat16* {
        const int gr = r0 + r;
        return gr < n_rows ? src + static_cast<long long>(gr) * ld : nullptr;
      },
      cols, vec4, src);
}

// ---------------------------------------------------------------------------
// The relative position term inside a tile (K1f / K1b, attention_v2_tc*.cu)
// ---------------------------------------------------------------------------
//
// BD[i, j] = qrr_i . rk[q-1-i+j]. For a warp's rows iw0..iw0+15 and keys
// j0..j0+63 the rk rows form a window of 79 starting at
// c_w = q-1-(iw0+15)+j0, so the warp computes W = Qrr RK_win^T (16 x 80, ten
// n-tiles) on the tensor cores and reads BD[r, jj] = W[r, 15-r+jj]: a skew
// by one column a row, taken through a per-warp fp32 scratch. Its
// transpose writes dS into dW[r, 15-r+jj] for dqrr = dW RK_win (K1b).

constexpr int kWin = 80;       // window columns a warp's product covers
constexpr int kScrStride = 72; // fp32 scratch row stride: float2 reads conflict-free
constexpr int kScrFloats = 16 * kScrStride;  // one warp's scratch
constexpr int kDwStride = 88;  // bf16 dW scratch row stride (>= 80, ldmatrix-aligned)
constexpr int kDwElems = 16 * kDwStride;

// Key j of one (h, b) pair: the memory rows [0, M) then the current rows
// [M, klen), separate arrays of `dh`-element rows; nullptr past either end.
__device__ __forceinline__ const __nv_bfloat16* kv_row(const __nv_bfloat16* mem,
                                                       const __nv_bfloat16* cur, int j,
                                                       int M, int klen, int dh) {
  if (j < 0 || j >= klen) return nullptr;
  return j < M ? mem + static_cast<long long>(j) * dh : cur + static_cast<long long>(j - M) * dh;
}

// A fragments (four k-steps over d_head) of rows r0, r0+8 .. of a row-major
// bf16 matrix in device memory with `ld` elements a row; rows >= n_rows and
// columns >= cols read as zero.
__device__ __forceinline__ void load_a_global(uint32_t (&a)[4][4], const __nv_bfloat16* src,
                                              long long ld, int r0, int n_rows, int cols,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto pair = [&](int r, int c) -> uint32_t {
    float lo = 0.f, hi = 0.f;
    if (r < n_rows) {
      const __nv_bfloat16* p = src + static_cast<long long>(r) * ld;
      if (c < cols) lo = __bfloat162float(p[c]);
      if (c + 1 < cols) hi = __bfloat162float(p[c + 1]);
    }
    return pack_bf16(lo, hi);
  };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = pair(r0 + g, c);
    a[kk][1] = pair(r0 + g + 8, c);
    a[kk][2] = pair(r0 + g, c + 8);
    a[kk][3] = pair(r0 + g + 8, c + 8);
  }
}

// A fragment of the transpose of a row-major shared tile [k][m]: rows
// m0..m0+15 of A are columns m0.. of the tile, k0..k0+15 its rows.
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                             int m0, int k0, int lane) {
  const int r = k0 + (lane & 7) + (lane >> 4) * 8;
  const int c = m0 + ((lane >> 3) & 1) * 8;
  ldmatrix_x4_trans(a, tile + r * kStride + c);
}

// acc += A Y^T over the window's ten n-tiles, where Y's row x (x < 80) is
// the shared row row(x) (ldmatrix-aligned, d_head in its first 64 columns):
// the position product W = Qrr RK_win^T.
template <typename RowPtr>
__device__ __forceinline__ void window_product(float (&acc)[kWin / 8][4],
                                               const uint32_t (&a)[4][4], RowPtr row, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < kWin / 16; ++np) {
      uint32_t b[4];
      const int x = np * 16 + (lane & 7) + (lane >> 4) * 8;
      const int c = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(b, row(x) + c);
      mma(acc[2 * np], a[kk], b[0], b[1]);
      mma(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// BD of a warp's 16 rows x 64 keys from its window product w = W (16 x 80):
// BD[r, jj] = W[r, 15-r+jj], through the warp's fp32 scratch (each W entry
// is stored where it lands, the 16 per row that land nowhere are dropped).
// BD comes back in C-fragment order: out[n][2 rr + c] is row g + 8 rr,
// column 8 n + 2 t + c.
__device__ __forceinline__ void skew_bd(float (&out)[8][4], const float (&w)[kWin / 8][4],
                                        float* scr, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = g + 8 * rr;
#pragma unroll
    for (int n = 0; n < kWin / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int x = n * 8 + 2 * t + c + row - 15;
        if (x >= 0 && x < kTile) scr[row * kScrStride + x] = w[n][2 * rr + c];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = g + 8 * rr;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 v = *reinterpret_cast<const float2*>(scr + row * kScrStride + n * 8 + 2 * t);
      out[n][2 * rr] = v.x;
      out[n][2 * rr + 1] = v.y;
    }
  }
  __syncwarp();
}

}  // namespace tc
