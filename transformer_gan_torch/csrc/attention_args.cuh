// Arguments shared by the attention entry points (csrc/attention.cu,
// csrc/attention_bwd.cu) and the bf16 tensor-core kernels of K2f / K2b
// (csrc/attention_v1_tc.cu, csrc/attention_v1_tc_bwd.cu) and K1f / K1b
// (csrc/attention_v2_tc.cu, csrc/attention_v2_tc_bwd.cu).
#pragma once

#include <cuda_runtime.h>

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
  void* dout_lp;   // bf16 K1b / K2b: scratch [BH, q, dh], dout rounded to bf16
  float* dsum;     // bf16 K1b / K2b: scratch [BH, q], D = rowsum(dout * o)
  void* dw;        // bf16 K1b: scratch [BH, q, M + 2q], dS in rk-row order
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

// K2f in bf16 on the tensor cores (attention_v1_tc.cu): q [BH, q, dh], k, v
// [BH, M + q, dh], bd [BH, q, M + q]; o, m, l as tg_xl_attn_fwd. With
// n_split > 1 the keys are split across blocks: `part` is fp32 scratch of
// n_split * BH * q * (dh + 2) floats, merged by a combine kernel.
int xl_attn_fwd_v1_tc(const void* q, const void* k, const void* v, const void* bd,
                      const int* reset, float* o, float* m, float* l, float* part,
                      int BH, int q_len, int M, int dh, int count, float scale,
                      int same_length, unsigned int seed, unsigned int thr, float rate,
                      int n_split, cudaStream_t stream);

// K2b in bf16 on the tensor cores (attention_v1_tc_bwd.cu); takes the
// K2b fields of BwdArgs and its two scratch buffers.
int xl_attn_bwd_v1_tc(const BwdArgs& a, cudaStream_t stream);

// Merge the key splits of a tensor-core forward (K2f, K1f): `part` holds
// n_split partial (o [rows, dh], then m [rows], then l [rows]) blocks;
// merged in split order into o, m, l (attention_v1_tc.cu).
int xl_attn_fwd_tc_combine(const float* part, float* o, float* m, float* l, long long rows,
                           int dh, int n_split, float rate, cudaStream_t stream);

// D = rowsum(dout * o) and dout rounded to bf16, one warp a row, for the
// tensor-core backwards (K2b, K1b; attention_v1_tc_bwd.cu).
int xl_attn_bwd_tc_prologue(const float* dout, const float* o, void* dout_lp, float* dsum,
                            long long rows, int dh, cudaStream_t stream);

// K1f in bf16 on the tensor cores (attention_v2_tc.cu): qrw, qrr, kcur,
// vcur [H * B, q, dh], kmem, vmem [H * B, M, dh], rk [H, M + 2q, dh]
// (block bh = h * B + b); o, m, l and the key splits as xl_attn_fwd_v1_tc.
int xl_attn_fwd_v2_tc(const void* qrw, const void* qrr, const void* kmem, const void* vmem,
                      const void* kcur, const void* vcur, const void* rk, const int* reset,
                      float* o, float* m, float* l, float* part, int BH, int B, int q_len,
                      int M, int dh, int count, int same_length, unsigned int seed,
                      unsigned int thr, float rate, int n_split, cudaStream_t stream);

// K1b in bf16 on the tensor cores (attention_v2_tc_bwd.cu); takes the K1b
// fields of BwdArgs and its two scratch buffers and writes the batch
// splits of drk to drk_part (the caller adds them in order).
int xl_attn_bwd_v2_tc(const BwdArgs& a, cudaStream_t stream);
