// Blockwise online-softmax GQA attention over fresh K/V for sm_90a: one C
// entry point over the device routine in attention_tile.cuh.
//
// Replaces the Pallas TPU kernel flash_attention of
// rag_llm_k8s_tpu/ops/attention.py (body _flash_kernel): fresh K/V
// [B, S, K, hd], causal (Llama prefill) or not (bge-m3), per-row key window.
// The dense cache kernels (decode_attention, chunk_prefill_attention) run
// the Hopper routines of attention_sm90.cuh instead (attention_sm90.cu).
//
// Bound on an H100: prefill at S = 4096 (H = 32, hd = 128) is bound by
// operations, about 137 GFLOP per causal layer, 0.14 ms at 989 TFLOP/s
// bf16. This routine runs WMMA with scores, probabilities and the output
// accumulator in shared memory, far from that bound; moving flash_attention
// onto the wgmma routine of attention_sm90.cuh is queued work.

#include "attention_tile.cuh"

using attn_tile::bf16;

namespace {

// Fresh K/V [B, Sk, K, hd]: key kp of row b at b*sb + kp*st + kvh*sh
// (strides in elements), window [kv_start[b], min(kv_len[b], Tk)), one
// causal offset for every row.
struct StridedKV {
  static constexpr bool kInt8 = false;
  const bf16* k;
  long long k_sb, k_st, k_sh;
  const bf16* v;
  long long v_sb, v_st, v_sh;
  const int* kv_start;
  const int* kv_len;
  int Tk, q_offset;

  __device__ int start(int b) const { return kv_start[b]; }
  __device__ int len(int b) const { return min(kv_len[b], Tk); }
  __device__ int offset(int) const { return q_offset; }
  __device__ const bf16* k_row(int b, int kvh, int kp) const {
    return k + b * k_sb + kp * k_st + kvh * k_sh;
  }
  __device__ const bf16* v_row(int b, int kvh, int kp) const {
    return v + b * v_sb + kp * v_st + kvh * v_sh;
  }
};

attn_tile::QParams q_params(const void* q, long long q_sb, long long q_st, long long q_sh,
                            void* o, int S, int H, int K, int causal, float scale) {
  return attn_tile::QParams{static_cast<const bf16*>(q), q_sb, q_st, q_sh,
                            static_cast<bf16*>(o), S, H, K, H / (K > 0 ? K : 1),
                            causal, scale};
}

}  // namespace

// Fresh K/V. Strides are in elements; the head dim is contiguous.
extern "C" int flash_attention_bf16(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    void* o, const int* kv_start, const int* kv_len,
    int B, int S, int Sk, int H, int K, int hd, int causal, float scale, void* stream) {
  const StridedKV kv{static_cast<const bf16*>(k), k_sb, k_st, k_sh,
                     static_cast<const bf16*>(v), v_sb, v_st, v_sh,
                     kv_start, kv_len, Sk, 0};
  return attn_tile::dispatch(q_params(q, q_sb, q_st, q_sh, o, S, H, K, causal, scale),
                             kv, B, hd, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
