// Blockwise online-softmax GQA attention for sm_90a: three C entry points
// over the device routine in attention_tile.cuh.
//
// Replaces the Pallas TPU kernels of rag_llm_k8s_tpu/ops/attention.py:
//   flash_attention         (body _flash_kernel)  fresh K/V [B, S, K, hd]
//   decode_attention        (body _decode_kernel) one query over the stacked
//                                                 cache [L, B, K, T, hd] at layer
//   chunk_prefill_attention (body _chunk_kernel)  S queries at write_index over
//                                                 the cache, offset causality
// Fresh K/V and one cache layer differ only in strides and in the causal
// offset: one strided K/V addressing policy serves all three.
//
// Bounds on an H100. Prefill at S = 4096 (H = 32, hd = 128) is bound by
// operations: about 137 GFLOP per causal layer, 0.14 ms at 989 TFLOP/s bf16.
// Decode and the speculative verify at T = 4352 are bound by bytes: about
// 17 MB of live K/V across 32 layers, 5 us per layer at 3.35 TB/s. At B = 1
// the decode and verify grids hold only K = 8 blocks and underfill the 132
// SMs; split-KV, wgmma and TMA are left for later work.

#include "attention_tile.cuh"

using attn_tile::bf16;

namespace {

// Fresh K/V [B, Sk, K, hd] or one layer of the dense cache [L, B, K, T, hd]:
// key kp of row b at b*sb + kp*st + kvh*sh (strides in elements), window
// [kv_start[b], min(kv_len[b], Tk)), one causal offset for every row.
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

// One cache layer of a contiguous [L, B, K, T, hd] cache.
static int cache_attention(const void* q, const void* kc, const void* vc, void* o,
                           const int* kv_start, const int* kv_len,
                           int L, int B, int K, int T, int S, int H, int hd,
                           int layer, int causal, int q_offset, float scale, void* stream) {
  if (layer < 0 || layer >= L) return (int)cudaErrorInvalidValue;
  const long long layer_off = (long long)layer * B * K * T * hd;
  const long long sb = (long long)K * T * hd, sh = (long long)T * hd;
  const StridedKV kv{static_cast<const bf16*>(kc) + layer_off, sb, hd, sh,
                     static_cast<const bf16*>(vc) + layer_off, sb, hd, sh,
                     kv_start, kv_len, T, q_offset};
  return attn_tile::dispatch(
      q_params(q, (long long)S * H * hd, (long long)H * hd, hd, o, S, H, K, causal, scale),
      kv, B, hd, stream);
}

extern "C" int decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    const int* kv_start, const int* kv_len,
    int L, int B, int K, int T, int H, int hd, int layer, float scale, void* stream) {
  return cache_attention(q, k_cache, v_cache, o, kv_start, kv_len,
                         L, B, K, T, 1, H, hd, layer, 0, 0, scale, stream);
}

extern "C" int chunk_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    const int* kv_start, const int* kv_len,
    int L, int B, int K, int T, int S, int H, int hd, int layer, int write_index,
    float scale, void* stream) {
  return cache_attention(q, k_cache, v_cache, o, kv_start, kv_len,
                         L, B, K, T, S, H, hd, layer, 1, write_index, scale, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
