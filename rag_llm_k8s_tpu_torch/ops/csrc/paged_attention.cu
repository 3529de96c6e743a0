// Attention over the paged bf16 KV arena for sm_90a: two C entry points over
// the routines of attention_sm90.cuh. The file holds no routine of its own:
// it defines the paged addressing policy and launches the decode and chunk
// routines with it.
//
// Replaces the Pallas TPU kernels of rag_llm_k8s_tpu/ops/attention.py:
//   paged_decode_attention (entry :1134, body _paged_decode_kernel :1064,
//                           pallas_call :1165) one query per row over the
//                           row's live blocks of the [L, N, K, bs, hd] arena
//   paged_chunk_attention  (entry :1408, body _paged_chunk_kernel :1334,
//                           pallas_call :1465) S queries per row at a
//                           per-row write_index, offset causality
// Logical key t of row b sits in physical block tables[b * MB + t / bs], slot
// t % bs; rows are right-padded, so the window is [0, kv_len[b]). Blocks at or
// past kv_len are never read (their table entries are the null block 0), K/V
// slots past kv_len inside the frontier block are never let into a product
// (they may hold another request's data or NaN), and a row with kv_len = 0
// writes zeros.
//
// paged_decode_attention. Bound by bytes: at the continuous engine's mixed
// lengths (B = 8 rows, 9,885 live keys, K = 8, hd = 128) one layer reads
// ~40 MB of K/V, ~12 us at 3.35 TB/s, against ~0.3 GFLOP. What keeps a
// kernel from that bound is too few bytes in flight (B * K = 64 (row, kv
// head) pairs for 132 SMs, rows of very different lengths), and arithmetic
// that costs more than the bytes (a per-key reduction across a warp on
// CUDA cores). The design: the mma.sync decode routine (decode_kernel) with
// the paged policy. One warp per (split, kv head, row), each row's keys cut
// into splits of at most 8 16-key tiles (ops.attention.decode_launch_plan,
// from the host-known capacity MB * bs, never from kv_len), so at B = 8 the
// 2,176 warps keep every SM streaming and no warp walks more than 128 keys;
// a 4-stage cp.async ring keeps 3 tiles (24 KB) in flight per warp; the G
// heads of a kv head are rows of one m16n8k16 tile, so S, the softmax and O
// stay on tensor-core fragments with no per-key warp reduction; a tile's 16
// rows are addressed from one table lookup (bs % 16 == 0: a tile never
// crosses a block); the routine's merge pass combines the splits.
//
// paged_chunk_attention. Bound by bytes at the continuous engine's mixed
// window (B = 8, S = 64, H = 32, K = 8, hd = 128, bs = 16, MB = 272: rows 4 of
// decode, 3 of prompt chunks and an empty one, ~21 us). The wgmma chunk
// routine (chunk_kernel) with the paged policy: a 64-key tile gathers its
// rows through the table (one row pointer per copied row, cp.async with zero
// fill past the frontier), and the causal offset is the row's own
// write_index. With B * K (row tile, row, kv head) blocks the grid is small,
// so each row's visible keys are cut into tile-aligned splits planned from
// the host-known capacity MB * bs (no read of kv_len on the host) and merged
// by the routine's second pass. A lane past kv_len (the junk lanes of a
// decode row) sees every key below kv_len, as in the TPU kernel.

#include "attention_sm90.cuh"

using attn_sm90::bf16;

namespace {

// One layer of the arena: key kp of row b in physical block
// tables[b * MB + kp / bs] at slot kp % bs; window [0, min(kv_len, MB * bs)),
// query 0 of row b at logical position write_index[b] (null for decode,
// which has no causality).
struct PagedKV {
  const bf16* k;  // the layer's [N, K, bs, hd] planes
  const bf16* v;
  const int* tables;
  const int* kv_len;
  const int* write_index;
  long long blk_stride;  // K * bs * hd
  int MB, bs, hd;

  __device__ int start(int) const { return 0; }
  __device__ int len(int b) const { return min(kv_len[b], MB * bs); }
  __device__ int offset(int b) const { return write_index[b]; }
  __device__ long long row(int b, int kvh, int kp) const {
    const int phys = tables[b * MB + kp / bs];
    return phys * blk_stride + ((long long)kvh * bs + kp % bs) * hd;
  }
  __device__ const bf16* k_row(int b, int kvh, int kp) const { return k + row(b, kvh, kp); }
  __device__ const bf16* v_row(int b, int kvh, int kp) const { return v + row(b, kvh, kp); }
};

PagedKV layer_kv(const void* k_arena, const void* v_arena, const int* tables, const int* kv_len,
                 const int* write_index, int N, int K, int bs, int MB, int hd, int layer) {
  const long long blk_stride = (long long)K * bs * hd;
  const long long layer_off = (long long)layer * N * blk_stride;
  return PagedKV{static_cast<const bf16*>(k_arena) + layer_off, static_cast<const bf16*>(v_arena) + layer_off,
                 tables, kv_len, write_index, blk_stride, MB, bs, hd};
}

attn_sm90::Params params(const void* q, void* o, void* part_m, void* part_l, void* part_acc, int S, int H,
                         int K, int hd, int causal, int split_keys, int n_splits, float scale) {
  return attn_sm90::Params{static_cast<const bf16*>(q), (long long)S * H * hd, (long long)H * hd, hd,
                           static_cast<bf16*>(o), static_cast<float*>(part_m), static_cast<float*>(part_l),
                           static_cast<float*>(part_acc), S, H, K, H / K, causal, split_keys, n_splits,
                           scale * 1.4426950408889634f};
}

}  // namespace

// q, out [B, 1, H, hd] contiguous; part_* the split scratch ([B*K,
// n_splits, H/K] and [..., hd], fp32), null when n_splits == 1.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_arena, const void* v_arena, void* o,
    const int* tables, const int* kv_len, void* part_m, void* part_l, void* part_acc,
    int L, int N, int B, int K, int bs, int MB, int H, int hd, int layer,
    int split_keys, int n_splits, float scale, void* stream) {
  // the splits cover the capacity MB * bs (the merge pass reads n_splits
  // partials of every row)
  if (layer < 0 || layer >= L || K < 1 || bs < attn_sm90::DBN || bs % attn_sm90::DBN ||
      (n_splits > 1) != (part_m != nullptr) || (long long)n_splits * split_keys < (long long)MB * bs)
    return (int)cudaErrorInvalidValue;
  return attn_sm90::decode(params(q, o, part_m, part_l, part_acc, 1, H, K, hd, 0, split_keys, n_splits, scale),
                           layer_kv(k_arena, v_arena, tables, kv_len, nullptr, N, K, bs, MB, hd, layer),
                           B, hd, stream);
}

// q, out [B, S, H, hd] contiguous; part_* the split scratch ([B*K,
// n_splits, S*H/K] and [..., hd], fp32), null when n_splits == 1.
extern "C" int paged_chunk_attention_sm90(
    const void* q, const void* k_arena, const void* v_arena, void* o,
    const int* tables, const int* kv_len, const int* write_index,
    void* part_m, void* part_l, void* part_acc,
    int L, int N, int B, int K, int bs, int MB, int S, int H, int hd, int layer,
    int block_rows, int split_keys, int n_splits, float scale, void* stream) {
  if (layer < 0 || layer >= L || K < 1 || bs < 1 || (n_splits > 1) != (part_m != nullptr))
    return (int)cudaErrorInvalidValue;
  return attn_sm90::chunk(params(q, o, part_m, part_l, part_acc, S, H, K, hd, 1, split_keys, n_splits, scale),
                          layer_kv(k_arena, v_arena, tables, kv_len, write_index, N, K, bs, MB, hd, layer),
                          B, hd, block_rows, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
