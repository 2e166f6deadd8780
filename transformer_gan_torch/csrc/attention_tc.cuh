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

// Fill a shared tile with rows r0..r0+63, columns 0..63 of a row-major
// bf16 matrix with `ld` elements per row; rows >= n_rows and columns >=
// cols read as zero (the padding of d_head, ragged edges), so the padding
// adds nothing to any product. When `vec4` (even ld and cols, 4-byte
// aligned base) the copy is 4-byte cp.async with zero fill (the caller
// commits and waits), else 2-byte loads through registers. Global rows need
// not be 16-byte aligned: d_head 50 gives 100-byte rows.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                          long long ld, int r0, int n_rows, int cols,
                                          bool vec4) {
  if (vec4) {
    constexpr int wpr = kTile / 2;  // 4-byte words per row
    for (int e = threadIdx.x; e < kTile * wpr; e += blockDim.x) {
      const int r = e / wpr, c = (e % wpr) * 2, gr = r0 + r;
      const bool ok = gr < n_rows && c < cols;
      const __nv_bfloat16* p = ok ? src + static_cast<long long>(gr) * ld + c : src;
      cp_async4(tile + r * kStride + c, p, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x) {
      const int r = e / kTile, c = e % kTile, gr = r0 + r;
      tile[r * kStride + c] = (gr < n_rows && c < cols)
                                  ? src[static_cast<long long>(gr) * ld + c]
                                  : __float2bfloat16_rn(0.f);
    }
  }
}

}  // namespace tc
