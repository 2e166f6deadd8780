// Operands of one call of the reverse straight-through chain (K6, K7), shared
// by its fp32 chain (chain_bwd.cu) and its bf16 chain (chain_bwd_tc.cu);
// ops/chain_bwd.ChainArgs mirrors the struct.
#pragma once

#include <cuda_runtime.h>

// Operands of one chunk. T is the compute type (dtype 0 float32, 1 bfloat16)
// unless marked float or int. Residuals (res_*) are [L, n_res, B, .] with
// n_res = n (K6, the window pass's) or 1 (K7, this call's recomputation,
// written here); res_prob is [L, B, H, n_res, KL] fp32.
struct ChainArgs {
  int dtype, n, L, B, M, HD, DI, H, V, pre_lnorm, count, recompute;
  float scale, temperature;
  const void* kf;     // [L, H, B, KL, dh] lane buffers, KL = M + n
  const void* vf;
  const void* R;      // [L, M + 1, HD], row r = distance M - r
  const void* q_w;    // [L, HD, HD]
  const void* k_w;
  const void* v_w;
  const void* o_w;
  const void* ff1;    // [L, HD, DI]
  const void* fb1;    // [L, DI]
  const void* ff2;    // [L, DI, HD]
  const void* fb2;    // [L, HD]
  const float* ln_as; // [L, HD] float
  const float* ln_ab;
  const float* ln_fs;
  const float* ln_fb;
  const void* rwb;    // [HD]
  const void* rrb;
  const void* emb;    // [V, HD], pre-scaled by sqrt(d_model)
  const void* emb_t;  // [HD, V]
  const float* S;     // [n, B, V] straight-through cotangents
  const float* Y;     // [n, B, V] softmax outputs
  const int* ids;     // [n, B] input ids (K7)
  void* res_x;        // [L, n_res, B, HD] layer inputs
  void* res_z1;       // x + attn
  void* res_z2;       // h1 + ff
  void* res_ff;       // [L, n_res, B, DI] ff_pre
  float* res_prob;    // [L, B, H, n_res, KL]
  float* Q;           // [n, B, V] out
  float* chi;         // float scratch [B, V], [B, HD] x 4, [B, DI], [B, HD] x 5
  float* dx;
  float* dz2;
  float* dz1;
  float* dff;         // [B, DI]
  float* dffin;
  float* dctx;
  float* dq;
  float* dk;
  float* dv;
  float* dwin;
  void* q;            // T scratch [B, HD] x 2 (+ K7: [B, HD] x 4, [B, DI])
  void* w_in;
  void* x;
  void* ctx;
  void* attn;
  void* out;
  void* hid;          // [B, DI]
  void* ff;
  // bf16 only (chain_bwd_tc.cu). The backward products' weights as stored,
  // padded to [npad(N), kpad(K)] (decode_chain_tc.cuh), N the product's
  // output width and K its input width:
  const void* qkv_bwd;    // [L, npad(HD), kpad(3 HD)]: [dq | dk | dv] -> dx
  const void* o_bwd;      // [L, npad(HD), kpad(HD)]
  const void* ff1_bwd;    // [L, npad(HD), kpad(DI)]
  const void* ff2_bwd;    // [L, npad(DI), kpad(HD)]
  const void* emb_t_bwd;  // [npad(HD), kpad(V)]
  const void* emb_bwd;    // [npad(V), kpad(HD)]
  // K7's forward: the decode chain's W^T copies (ops/decode_params.py)
  const void* qkv_t;      // [L, npad(3 HD), kpad(HD)]
  const void* o_t;
  const void* ff1_t;
  const void* ff2_t;
  const void* R_h;        // [L, H, M + 1, dh]: R head-major
  void* res_q;            // [L, n_res, B, HD] each token's query, w_in q_w
  void* dx_h;             // bf16 scratch: [B, HD] copies of the rows a
  void* dz_h;             // product takes, [B, DI] dff, [B, 3 HD] dq|dk|dv
  void* dff_h;
  void* dctx_h;
  void* dqkv_h;
};

// The bf16 reverse chain (chain_bwd_tc.cu); returns a cudaError_t code.
int run_chain_bwd_tc(const ChainArgs& a, cudaStream_t st);
