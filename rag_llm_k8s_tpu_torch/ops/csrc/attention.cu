// Blockwise online-softmax GQA attention over fresh K/V for Hopper (sm_90a):
// one C entry point over the routines of attention_sm90.cuh.
//
// Replaces the Pallas TPU kernel flash_attention of
// rag_llm_k8s_tpu/ops/attention.py (entry :122, body _flash_kernel :41,
// pallas_call :163): fresh K/V [B, Sk, K, hd], causal (Llama prefill) or not
// (bge-m3), per-row key window [kv_start, kv_len).
//
// Bound on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the Llama prefill at
// S = 4096 (H = 32, hd = 128, causal) does ~137 GFLOP per layer, 0.14 ms,
// bound by operations; the bge-m3 encoder (8 x 512, H = K = 16, hd = 64,
// bidirectional, right-padded rows) is bound by its ~10 MB of bytes.
//
// What the design does about it. Two designs over one policy:
//   design 0  the wgmma chunk routine (chunk_kernel): cp.async ring, all
//             threads copy and compute, split-KV when the grid is small;
//   design 1  the warp-specialized routine (ws_kernel): a TMA producer warp
//             and two consumer warpgroups, one split. Its tensor maps are
//             built here from the tensors' own shapes and strides (Q
//             [B, S, H, hd], K and V [B, Sk, K, hd]).
// The caller (ops.attention.flash_launch_plan) picks the design by shape.

#include "attention_sm90.cuh"

using attn_sm90::bf16;

namespace {

// Fresh K/V [B, Sk, K, hd]: key kp of row b at b*sb + kp*st + kvh*sh
// (strides in elements), window [kv_start[b], min(kv_len[b], Tk)), query t at
// position t. In the tensor maps (dims hd, K, Sk, B) a key row is at
// (kvh, kp, b).
struct StridedKV {
  const bf16* k;
  long long k_sb, k_st, k_sh;
  const bf16* v;
  long long v_sb, v_st, v_sh;
  const int* kv_start;
  const int* kv_len;
  int Tk;

  __device__ int start(int b) const { return kv_start[b]; }
  __device__ int len(int b) const { return min(kv_len[b], Tk); }
  __device__ int offset(int) const { return 0; }
  __device__ const bf16* k_row(int b, int kvh, int kp) const {
    return k + b * k_sb + kp * k_st + kvh * k_sh;
  }
  __device__ const bf16* v_row(int b, int kvh, int kp) const {
    return v + b * v_sb + kp * v_st + kvh * v_sh;
  }
  __device__ int3 tma_row(int b, int kvh, int kp) const { return make_int3(kvh, kp, b); }
};

}  // namespace

// Fresh K/V. Strides are in elements; the head dim is contiguous; out is
// [B, S, H, hd] contiguous. part_* are the split scratch ([B*K, n_splits,
// S*H/K] and [..., hd], fp32), null when n_splits == 1. design 1 takes one
// split only.
extern "C" int flash_attention_sm90(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    void* o, const int* kv_start, const int* kv_len, void* part_m, void* part_l, void* part_acc,
    int B, int S, int Sk, int H, int K, int hd, int causal, int design,
    int block_rows, int split_keys, int n_splits, float scale, void* stream) {
  if (K < 1 || (n_splits > 1) != (part_m != nullptr)) return (int)cudaErrorInvalidValue;
  const int G = H / K;
  const attn_sm90::Params p{static_cast<const bf16*>(q), q_sb, q_st, q_sh, static_cast<bf16*>(o),
                            static_cast<float*>(part_m), static_cast<float*>(part_l),
                            static_cast<float*>(part_acc), S, H, K, G, causal, split_keys, n_splits,
                            scale * 1.4426950408889634f};
  const StridedKV kv{static_cast<const bf16*>(k), k_sb, k_st, k_sh,
                     static_cast<const bf16*>(v), v_sb, v_st, v_sh, kv_start, kv_len, Sk};
  if (design == 0) return attn_sm90::chunk(p, kv, B, hd, block_rows, stream);
  if (design != 1 || G < 1 || 128 % G) return (int)cudaErrorInvalidValue;
  // Q: a box of G heads x 128 / G positions; K, V: 1 kv head x WBN keys
  CUtensorMap tq, tk, tv;
  int rc = attn_sm90::make_tma_4d(&tq, q, B, S, H, hd, q_sb, q_st, q_sh, G, 128 / G);
  if (rc == 0) rc = attn_sm90::make_tma_4d(&tk, k, B, Sk, K, hd, k_sb, k_st, k_sh, 1, attn_sm90::WBN);
  if (rc == 0) rc = attn_sm90::make_tma_4d(&tv, v, B, Sk, K, hd, v_sb, v_st, v_sh, 1, attn_sm90::WBN);
  if (rc != 0) return rc;
  return attn_sm90::ws_chunk(p, kv, tq, tk, tv, B, hd, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
