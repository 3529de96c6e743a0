// Attention over an int8 KV cache for sm_90a: four C entry points.
//
// Replaces the Pallas TPU kernels of rag_llm_k8s_tpu/ops/attention.py:
//   decode_attention_q8        (entry :787, body _decode_kernel_q8 :709,
//                              pallas_call :827) one query over the dense
//                              int8 cache [L, B, K, T, hd] at layer
//   chunk_prefill_attention_q8 (entry :948, body _chunk_kernel_q8 :862,
//                              pallas_call :989) S queries at write_index
//                              over the dense int8 cache
//   paged_decode_attention_q8  (entry :1265, body _paged_decode_kernel_q8
//                              :1196, pallas_call :1299) one query per row
//                              over its live blocks of the int8 arena
//   paged_chunk_attention_q8   (entry :1588, body _paged_chunk_kernel_q8
//                              :1499, pallas_call :1634) S queries per row
//                              at a per-row write_index over the arena
// The payload is int8 with one fp32 scale per (token, kv head) row: the dense
// cache's scales are [L, B, K, T], the arena's [L, N, K, bs]. Dequantization
// rides the epilogues, as on the TPU: a score column is multiplied by its
// k-scale, a probability by its v-scale just before the bf16 rounding for the
// PV product; the payload is only converted (exactly) to bf16. Scales
// outside a row's window are zeroed before they multiply anything: slots past
// a frontier and blocks no row owns may hold NaN. A row with no visible key
// writes zeros.
//
// Bounds on an H100. One key costs 2 * K * hd bytes of payload and 2 * K * 4
// of scales per layer: 2,112 B at K = 8, hd = 128, against 4,096 in bf16.
// Decode at T = 4352 (B = 1, ~4,100 live keys) reads ~8.7 MB per layer, 2.6 us
// at 3.35 TB/s; the paged decode at B = 8 over 9,885 live keys ~21 MB, 6 us.
// Both are bound by bytes. The S = 16 verify at T = 4352 reads ~8.5 MB per
// layer (2.5 us, bytes); the mixed window at B = 8, S = 64 (15,000 live keys,
// every lane of a row computing) is bound by operations (~16 us); the
// S = 4096 chunk at write_index 4096 does ~405 GFLOP (0.41 ms, operations).
//
// Every entry point runs a routine of attention_sm90.cuh over one of two
// addressing policies (DenseQ8: strides and the window [kv_start, kv_len);
// PagedQ8: a table lookup and the window [0, kv_len)), with split-KV and the
// merge pass planned in ops.attention (the paged kernels from the host-known
// capacity MB * bs, never from kv_len).
//
// Decode (dense and paged): the int8 decode routine (decode_q8_kernel), the
// mma.sync decode routine of the bf16 kernels with the payload widened in
// registers. One warp per (split, kv head, row): split-KV from
// decode_launch_plan until the grid holds 2 x the SM count and no warp walks
// more than 8 tiles (a warp's tiles run one after another, so the longest
// split sets the time). The G heads are rows of one m16n8k16 tile; K and V
// fragments come straight from ldmatrix over the int8 tiles (no per-key
// reduction across the warp, no bf16 copy in shared memory). An 8-stage
// cp.async ring of 16-key tiles keeps at least the bf16 routine's bytes in
// flight per warp, and each tile's rows are addressed from its first key
// (a table lookup per tile, not per key).
//
// Chunk (dense and paged): the int8 chunk routine (chunk_q8_kernel), the
// wgmma chunk routine of the bf16 kernels with the payload widened to bf16 in
// shared memory and the scales acting on the score and probability
// fragments, with split-KV planned as for the bf16 chunk kernels
// (ops.attention.chunk_launch_plan).

#include "attention_sm90.cuh"

using attn_sm90::bf16;

namespace {

// One layer of the dense int8 cache: key kp of row b, kv head kvh at scale
// index (b * K + kvh) * T + kp, payload at that index * hd; window
// [max(kv_start, 0), min(kv_len, T)), query 0 of every row at the slot
// *write_index, read from device memory (null for decode).
struct DenseQ8 {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int* kv_start;
  const int* kv_len;
  const int* write_index;
  int K, T, hd;

  __device__ int start(int b) const { return max(kv_start[b], 0); }
  __device__ int len(int b) const { return min(kv_len[b], T); }
  __device__ int offset(int) const { return *write_index; }
  __device__ long long srow(int b, int kvh, int kp) const {
    return ((long long)b * K + kvh) * T + kp;
  }
  __device__ const int8_t* k_row(int b, int kvh, int kp) const { return k + srow(b, kvh, kp) * hd; }
  __device__ const int8_t* v_row(int b, int kvh, int kp) const { return v + srow(b, kvh, kp) * hd; }
  __device__ const float* k_scales(int b, int kvh, int kp) const { return ks + srow(b, kvh, kp); }
  __device__ const float* v_scales(int b, int kvh, int kp) const { return vs + srow(b, kvh, kp); }
};

// One layer of the int8 arena: key kp of row b in physical block
// tables[b * MB + kp / bs] at slot kp % bs, scale index (phys * K + kvh) * bs
// + kp % bs; window [0, min(kv_len, MB * bs)), query 0 at write_index[b].
struct PagedQ8 {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int* tables;
  const int* kv_len;
  const int* write_index;  // null for decode
  int K, MB, bs, hd;

  __device__ int start(int) const { return 0; }
  __device__ int len(int b) const { return min(kv_len[b], MB * bs); }
  __device__ int offset(int b) const { return write_index[b]; }
  __device__ long long srow(int b, int kvh, int kp) const {
    const long long phys = tables[b * MB + kp / bs];
    return (phys * K + kvh) * bs + kp % bs;
  }
  __device__ const int8_t* k_row(int b, int kvh, int kp) const { return k + srow(b, kvh, kp) * hd; }
  __device__ const int8_t* v_row(int b, int kvh, int kp) const { return v + srow(b, kvh, kp) * hd; }
  __device__ const float* k_scales(int b, int kvh, int kp) const { return ks + srow(b, kvh, kp); }
  __device__ const float* v_scales(int b, int kvh, int kp) const { return vs + srow(b, kvh, kp); }
};

// S queries per row (causal offset) or one (decode, no causality)
attn_sm90::Params params(const void* q, void* o, void* part_m, void* part_l, void* part_acc, int S, int H,
                         int K, int hd, int causal, int split_keys, int n_splits, float scale) {
  return attn_sm90::Params{static_cast<const bf16*>(q), (long long)S * H * hd, (long long)H * hd, hd,
                           static_cast<bf16*>(o), static_cast<float*>(part_m), static_cast<float*>(part_l),
                           static_cast<float*>(part_acc), S, H, K, H / K, causal, split_keys, n_splits,
                           scale * 1.4426950408889634f};
}

}  // namespace

// The dense cache: payload [L, B, K, T, hd] int8, scales [L, B, K, T] fp32.
// q, out [B, 1, H, hd] contiguous; part_* the split scratch ([B*K, n_splits,
// H/K] and [..., hd], fp32), null when n_splits == 1. T % 16 == 0.
extern "C" int decode_attention_q8(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, void* o, const int* kv_start, const int* kv_len,
    void* part_m, void* part_l, void* part_acc,
    int L, int B, int K, int T, int H, int hd, int layer, int split_keys, int n_splits,
    float scale, void* stream) {
  if (layer < 0 || layer >= L || K < 1 || T % attn_sm90::DBN || (n_splits > 1) != (part_m != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long s_off = (long long)layer * B * K * T;
  const DenseQ8 kv{static_cast<const int8_t*>(k_cache) + s_off * hd,
                   static_cast<const int8_t*>(v_cache) + s_off * hd,
                   static_cast<const float*>(k_scale) + s_off,
                   static_cast<const float*>(v_scale) + s_off,
                   kv_start, kv_len, nullptr, K, T, hd};
  return attn_sm90::decode_q8(params(q, o, part_m, part_l, part_acc, 1, H, K, hd, 0, split_keys, n_splits, scale),
                              kv, B, hd, stream);
}

// q, out [B, S, H, hd] contiguous; write_index one int32 in device memory
// (the slot of query 0); part_* the split scratch ([B*K, n_splits, S*H/K]
// and [..., hd], fp32), null when n_splits == 1. T % 4 == 0 (the scales
// travel in 16-byte pieces).
extern "C" int chunk_attention_q8(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, void* o, const int* kv_start, const int* kv_len, const int* write_index,
    void* part_m, void* part_l, void* part_acc,
    int L, int B, int K, int T, int S, int H, int hd, int layer,
    int block_rows, int split_keys, int n_splits, float scale, void* stream) {
  if (layer < 0 || layer >= L || K < 1 || T % 4 || write_index == nullptr || (n_splits > 1) != (part_m != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long s_off = (long long)layer * B * K * T;
  const DenseQ8 kv{static_cast<const int8_t*>(k_cache) + s_off * hd,
                   static_cast<const int8_t*>(v_cache) + s_off * hd,
                   static_cast<const float*>(k_scale) + s_off,
                   static_cast<const float*>(v_scale) + s_off,
                   kv_start, kv_len, write_index, K, T, hd};
  return attn_sm90::chunk_q8(params(q, o, part_m, part_l, part_acc, S, H, K, hd, 1, split_keys, n_splits, scale),
                             kv, B, hd, block_rows, stream);
}

// The arena: payload [L, N, K, bs, hd] int8, scales [L, N, K, bs] fp32.
// q, out and part_* as decode_attention_q8; bs % 16 == 0 (a 16-key tile
// never crosses a block).
extern "C" int paged_decode_attention_q8(
    const void* q, const void* k_arena, const void* v_arena, const void* k_scale,
    const void* v_scale, void* o, const int* tables, const int* kv_len,
    void* part_m, void* part_l, void* part_acc,
    int L, int N, int B, int K, int bs, int MB, int H, int hd, int layer,
    int split_keys, int n_splits, float scale, void* stream) {
  // the splits cover the capacity MB * bs (the merge pass reads n_splits
  // partials of every row)
  if (layer < 0 || layer >= L || K < 1 || bs < attn_sm90::DBN || bs % attn_sm90::DBN ||
      (n_splits > 1) != (part_m != nullptr) || (long long)n_splits * split_keys < (long long)MB * bs)
    return (int)cudaErrorInvalidValue;
  const long long s_off = (long long)layer * N * K * bs;
  const PagedQ8 kv{static_cast<const int8_t*>(k_arena) + s_off * hd,
                   static_cast<const int8_t*>(v_arena) + s_off * hd,
                   static_cast<const float*>(k_scale) + s_off,
                   static_cast<const float*>(v_scale) + s_off,
                   tables, kv_len, nullptr, K, MB, bs, hd};
  return attn_sm90::decode_q8(params(q, o, part_m, part_l, part_acc, 1, H, K, hd, 0, split_keys, n_splits, scale),
                              kv, B, hd, stream);
}

// q, out and part_* as chunk_attention_q8; bs % 4 == 0.
extern "C" int paged_chunk_attention_q8(
    const void* q, const void* k_arena, const void* v_arena, const void* k_scale,
    const void* v_scale, void* o, const int* tables, const int* kv_len, const int* write_index,
    void* part_m, void* part_l, void* part_acc,
    int L, int N, int B, int K, int bs, int MB, int S, int H, int hd, int layer,
    int block_rows, int split_keys, int n_splits, float scale, void* stream) {
  if (layer < 0 || layer >= L || K < 1 || bs < 4 || bs % 4 || (n_splits > 1) != (part_m != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long s_off = (long long)layer * N * K * bs;
  const PagedQ8 kv{static_cast<const int8_t*>(k_arena) + s_off * hd,
                   static_cast<const int8_t*>(v_arena) + s_off * hd,
                   static_cast<const float*>(k_scale) + s_off,
                   static_cast<const float*>(v_scale) + s_off,
                   tables, kv_len, write_index, K, MB, bs, hd};
  return attn_sm90::chunk_q8(params(q, o, part_m, part_l, part_acc, S, H, K, hd, 1, split_keys, n_splits, scale),
                             kv, B, hd, block_rows, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
