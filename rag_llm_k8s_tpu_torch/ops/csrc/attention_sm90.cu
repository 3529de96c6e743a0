// Dense bf16 cache attention for Hopper (sm_90a): two C entry points over
// the routines of attention_sm90.cuh.
//
// Replaces the Pallas TPU kernels of rag_llm_k8s_tpu/ops/attention.py:
//   chunk_prefill_attention (entry :428, body _chunk_kernel :352,
//                            pallas_call :468) S queries written at
//                            write_index over one layer of the stacked cache
//                            [L, B, K, T, hd], offset causality
//   decode_attention        (entry :276, body _decode_kernel :194,
//                            pallas_call :321) one query per row over the
//                            same cache at layer
//
// Bounds on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense). A long prompt's
// second chunk (S = 4096 at write_index 4096, H = 32, hd = 128, ~8,100
// visible keys) does ~405 GFLOP: 0.41 ms, bound by operations. The decode
// step and the speculative verify (S = 16) at T = 4352 read ~4,100 live keys
// of K and V per kv head, ~17 MB per layer: 5 us, bound by bytes.
//
// What the design does about it. Chunk: wgmma tiles with S, P and O in
// registers and a cp.async ring, so the S = 4096 chunk runs on the tensor
// cores at their own rate and never round-trips a score through shared
// memory. At S = 16 a (row tile, kv head) grid holds only K = 8 blocks, so
// the visible keys are cut into tile-aligned splits until the grid holds
// 2 x the SM count, and a merge pass combines them: every SM streams its
// share of the bytes. The S = 4096 chunk (one split) runs the
// warp-specialized routine instead (a TMA producer warp, two consumer
// warpgroups; tensor maps over the layer's [B, K, T, hd] planes), picked by
// ops.attention.chunk_design_plan. Decode: one warp per (split of ~128 keys, kv head,
// row) -- 272 warps at B = 1 -- with the G heads of a kv head as rows of an
// m16n8k16 tile, so no warp reduces across lanes per key, and a 4-stage
// ring of 16-byte copies keeps each warp's next 48 keys in flight.

#include "attention_sm90.cuh"

using attn_sm90::bf16;

namespace {

// One layer of the contiguous [L, B, K, T, hd] cache: key kp of row b at
// ((b * K + kvh) * T + kp) * hd, window [kv_start[b], min(kv_len[b], T)),
// query 0 of every row at the slot *write_index, read from device memory
// (null for decode, which has no causality), so a launch never carries the
// slot by value.
struct DenseKV {
  const bf16* k;
  const bf16* v;
  const int* kv_start;
  const int* kv_len;
  const int* write_index;
  int K, T, hd;

  __device__ int start(int b) const { return kv_start[b]; }
  __device__ int len(int b) const { return min(kv_len[b], T); }
  __device__ int offset(int) const { return *write_index; }
  __device__ long long row(int b, int kvh, int kp) const {
    return (((long long)b * K + kvh) * T + kp) * hd;
  }
  __device__ const bf16* k_row(int b, int kvh, int kp) const { return k + row(b, kvh, kp); }
  __device__ const bf16* v_row(int b, int kvh, int kp) const { return v + row(b, kvh, kp); }
  // in the layer's tensor maps (dims hd, T, K, B) a key row is at (kp, kvh, b)
  __device__ int3 tma_row(int b, int kvh, int kp) const { return make_int3(kp, kvh, b); }
};

attn_sm90::Params params(const void* q, void* o, void* part_m, void* part_l, void* part_acc,
                         int S, int H, int K, int hd, int causal, int split_keys, int n_splits,
                         float scale) {
  const int G = H / (K > 0 ? K : 1);
  return attn_sm90::Params{static_cast<const bf16*>(q), (long long)S * H * hd, (long long)H * hd, hd,
                           static_cast<bf16*>(o), static_cast<float*>(part_m), static_cast<float*>(part_l),
                           static_cast<float*>(part_acc), S, H, K, G, causal, split_keys, n_splits,
                           scale * 1.4426950408889634f};
}

DenseKV layer_kv(const void* k_cache, const void* v_cache, const int* kv_start, const int* kv_len,
                 const int* write_index, int B, int K, int T, int hd, int layer) {
  const long long off = (long long)layer * B * K * T * hd;
  return DenseKV{static_cast<const bf16*>(k_cache) + off, static_cast<const bf16*>(v_cache) + off,
                 kv_start, kv_len, write_index, K, T, hd};
}

}  // namespace

// q, out [B, S, H, hd] contiguous. write_index: one int32 in device memory,
// the slot of query 0 (JAX's scalar-prefetched write_index); the grid and
// the splits do not depend on it. part_* are the split scratch
// ([B*K, n_splits, S*H/K] and [..., hd], fp32), null when n_splits == 1.
// design 0: the chunk routine; 1: the warp-specialized routine (one split).
extern "C" int chunk_attention_sm90(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    const int* kv_start, const int* kv_len, const int* write_index, void* part_m, void* part_l, void* part_acc,
    int L, int B, int K, int T, int S, int H, int hd, int layer, int design,
    int block_rows, int split_keys, int n_splits, float scale, void* stream) {
  if (layer < 0 || layer >= L || K < 1 || write_index == nullptr || (n_splits > 1) != (part_m != nullptr))
    return (int)cudaErrorInvalidValue;
  const attn_sm90::Params p = params(q, o, part_m, part_l, part_acc, S, H, K, hd, 1, split_keys, n_splits, scale);
  const DenseKV kv = layer_kv(k_cache, v_cache, kv_start, kv_len, write_index, B, K, T, hd, layer);
  if (design == 0) return attn_sm90::chunk(p, kv, B, hd, block_rows, stream);
  if (design != 1 || 128 % p.G) return (int)cudaErrorInvalidValue;
  // Q: a box of G heads x 128 / G positions; K, V: WBN keys x 1 kv head of the layer
  CUtensorMap tq, tk, tv;
  const long long KT = (long long)K * T * hd;
  int rc = attn_sm90::make_tma_4d(&tq, q, B, S, H, hd, (long long)S * H * hd, (long long)H * hd, hd, p.G, 128 / p.G);
  if (rc == 0) rc = attn_sm90::make_tma_4d(&tk, kv.k, B, K, T, hd, KT, (long long)T * hd, hd, attn_sm90::WBN, 1);
  if (rc == 0) rc = attn_sm90::make_tma_4d(&tv, kv.v, B, K, T, hd, KT, (long long)T * hd, hd, attn_sm90::WBN, 1);
  if (rc != 0) return rc;
  return attn_sm90::ws_chunk(p, kv, tq, tk, tv, B, hd, stream);
}

// q, out [B, 1, H, hd] contiguous; part_* as above with S = 1.
extern "C" int decode_attention_sm90(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    const int* kv_start, const int* kv_len, void* part_m, void* part_l, void* part_acc,
    int L, int B, int K, int T, int H, int hd, int layer, int split_keys, int n_splits,
    float scale, void* stream) {
  if (layer < 0 || layer >= L || (n_splits > 1) != (part_m != nullptr)) return (int)cudaErrorInvalidValue;
  return attn_sm90::decode(params(q, o, part_m, part_l, part_acc, 1, H, K, hd, 0, split_keys, n_splits, scale),
                           layer_kv(k_cache, v_cache, kv_start, kv_len, nullptr, B, K, T, hd, layer),
                           B, hd, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
