// Attention over the paged KV arena for sm_90a: two C entry points.
//
// Replaces the Pallas TPU kernels of rag_llm_k8s_tpu/ops/attention.py:
//   paged_decode_attention (body _paged_decode_kernel) one query per row over
//                          the row's live blocks of the [L, N, K, bs, hd] arena
//   paged_chunk_attention  (body _paged_chunk_kernel)  S queries per row at a
//                          per-row write_index, offset causality
// Logical key t of row b sits in physical block tables[b * MB + t / bs], slot
// t % bs; rows are right-padded, so the window is [0, kv_len[b]). Blocks at or
// past kv_len are never read (their table entries are the null block 0), K/V
// slots past kv_len inside the frontier block are never let into a product
// (they may hold another request's data or NaN), and a row with kv_len = 0
// writes zeros.
//
// paged_decode_attention. Bound by bytes: at the continuous engine's mixed
// lengths (B = 8 rows, 9,885 live keys, K = 8, hd = 128) one layer reads
// ~40 MB of K/V, ~12 us at 3.35 TB/s. The TPU kernel carries m/l/acc across a
// sequential grid over the row's blocks; here the row's key range is cut into
// splits of `split_blocks` logical blocks, one block of four warps per (split,
// kv head, row), and a second kernel merges the splits. A warp owns whole
// 16-key units (one 4 KB slab of a (layer, block, kv head) at hd = 128): each
// lane loads its hd / 32 dims of all 16 K and V rows before any arithmetic,
// so 8 KB per warp are in flight; the G query heads of the kv head are
// computed together on CUDA cores (at G = 4 real rows a 16- or 64-row tensor
// core tile would be mostly padding). Scores reduce across the warp with
// shuffles, the softmax rescales per unit, p is rounded to bf16 before the PV
// product as on the TPU, and the four warps' states merge in shared memory.
//
// paged_chunk_attention. Bound by bytes at the continuous engine's mixed
// window (B = 8, S = 64, H = 32, K = 8, hd = 128, bs = 16, MB = 272: rows 4 of
// decode, 3 of prompt chunks and an empty one, ~21 us). The wgmma chunk
// routine of attention_sm90.cuh (chunk_kernel) with a paged addressing
// policy: a 64-key tile gathers its rows through the table (one row pointer
// per copied row, cp.async with zero fill past the frontier), and the causal
// offset is the row's own write_index. With B * K (row tile, row, kv head)
// blocks the grid is small, so each row's visible keys are cut into
// tile-aligned splits planned from the host-known capacity MB * bs (no read
// of kv_len on the host) and merged by the routine's second pass. A lane
// past kv_len (the junk lanes of a decode row) sees every key below kv_len,
// as in the TPU kernel.

#include "attention_sm90.cuh"

using attn_sm90::bf16;
using attn_sm90::NEG_INF;
using attn_sm90::warp_sum;

namespace {

// One layer of the arena: key kp of row b in physical block
// tables[b * MB + kp / bs] at slot kp % bs; window [0, min(kv_len, MB * bs)),
// query 0 of row b at logical position write_index[b].
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

constexpr int UNIT = 16;        // keys a warp takes at a time
constexpr int DEC_WARPS = 4;

struct DecodeParams {
  const bf16* q;  // [B, 1, H, hd]
  const bf16* k;  // the layer's [N, K, bs, hd] planes
  const bf16* v;
  bf16* o;        // [B, 1, H, hd]
  const int* tables;
  const int* kv_len;
  float* part_m;    // [B, K, n_splits, G]
  float* part_l;    // [B, K, n_splits, G]
  float* part_acc;  // [B, K, n_splits, G, hd]
  long long blk_stride;
  int K, bs, MB, H, split_blocks, n_splits;
  float scale;
};

// the hd / 32 bf16 values one lane holds of a key row
template <int DPL>
struct alignas(2 * DPL) LaneVec {
  __nv_bfloat162 h[DPL / 2];
};

template <int DPL>
__device__ __forceinline__ void unpack(const LaneVec<DPL>& x, float* f) {
#pragma unroll
  for (int i = 0; i < DPL / 2; ++i) {
    const float2 t = __bfloat1622float2(x.h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int HD, int G>
__global__ void __launch_bounds__(DEC_WARPS * 32) paged_decode_split(DecodeParams p) {
  constexpr int DPL = HD / 32;
  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kl = min(p.kv_len[b], p.MB * p.bs);
  const int units_per_block = p.bs / UNIT;
  const int n_units = (kl + UNIT - 1) / UNIT;
  const int u_lo = s * p.split_blocks * units_per_block;
  if (u_lo >= n_units) return;  // past the row's live blocks: the merge skips it
  const int u_hi = min(u_lo + p.split_blocks * units_per_block, n_units);

  float qr[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bf16* qp = p.q + ((long long)b * p.H + kvh * G + g) * HD + lane * DPL;
    unpack<DPL>(*reinterpret_cast<const LaneVec<DPL>*>(qp), qr[g]);
  }
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }

  for (int u = u_lo + warp; u < u_hi; u += DEC_WARPS) {
    const int kp0 = u * UNIT;
    const int phys = p.tables[b * p.MB + kp0 / p.bs];
    const long long base =
        phys * p.blk_stride + ((long long)kvh * p.bs + kp0 % p.bs) * HD + lane * DPL;
    // every load of the unit in flight before any arithmetic
    LaneVec<DPL> kx[UNIT], vx[UNIT];
#pragma unroll
    for (int j = 0; j < UNIT; ++j) {
      kx[j] = *reinterpret_cast<const LaneVec<DPL>*>(p.k + base + j * HD);
      vx[j] = *reinterpret_cast<const LaneVec<DPL>*>(p.v + base + j * HD);
    }
    float sc[G][UNIT];
#pragma unroll
    for (int j = 0; j < UNIT; ++j) {
      const bool valid = kp0 + j < kl;  // the frontier block's tail is never used
      float kf[DPL];
      unpack<DPL>(kx[j], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) dot += qr[g][d] * kf[d];
        dot = warp_sum(dot);
        sc[g][j] = valid ? dot * p.scale : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < UNIT; ++j) mx = fmaxf(mx, sc[g][j]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[g][d] *= alpha;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < UNIT; ++j) {
        if (kp0 + j < kl) {
          const float pj = expf(sc[g][j] - m_new);
          ps += pj;
          const float pb = __bfloat162float(__float2bfloat16(pj));
          float vf[DPL];
          unpack<DPL>(vx[j], vf);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[g][d] += pb * vf[d];
        }
      }
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
    }
  }

  // merge the four warps' states, then write this split's partial state
  __shared__ float sm_m[DEC_WARPS][G], sm_l[DEC_WARPS][G];
  __shared__ float sm_acc[DEC_WARPS][G][HD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) sm_acc[warp][g][lane * DPL + d] = acc[g][d];
  }
  __syncthreads();
  const long long part = ((long long)b * p.K + kvh) * p.n_splits + s;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float mt = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mt = fmaxf(mt, sm_m[w][g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float e = expf(sm_m[w][g] - mt);
      lt += sm_l[w][g] * e;
      at += sm_acc[w][g][d] * e;
    }
    p.part_acc[(part * G + g) * HD + d] = at;
    if (d == 0) {
      p.part_m[part * G + g] = mt;
      p.part_l[part * G + g] = lt;
    }
  }
}

// merges the splits of one (row, kv head); a row with no live key writes 0
template <int HD, int G>
__global__ void __launch_bounds__(128) paged_decode_merge(DecodeParams p) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kl = min(p.kv_len[b], p.MB * p.bs);
  const int units_per_split = p.split_blocks * (p.bs / UNIT);
  const int n_s = ((kl + UNIT - 1) / UNIT + units_per_split - 1) / units_per_split;
  const long long part0 = ((long long)b * p.K + kvh) * p.n_splits;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float mt = NEG_INF;
    for (int s = 0; s < n_s; ++s) mt = fmaxf(mt, p.part_m[(part0 + s) * G + g]);
    float lt = 0.f, at = 0.f;
    for (int s = 0; s < n_s; ++s) {
      const float e = expf(p.part_m[(part0 + s) * G + g] - mt);
      lt += p.part_l[(part0 + s) * G + g] * e;
      at += p.part_acc[((part0 + s) * G + g) * HD + d] * e;
    }
    p.o[((long long)b * p.H + kvh * G + g) * HD + d] = __float2bfloat16(at / fmaxf(lt, 1e-30f));
  }
}

template <int HD, int G>
int launch_decode(const DecodeParams& p, int B, cudaStream_t st) {
  paged_decode_split<HD, G><<<dim3(p.n_splits, p.K, B), DEC_WARPS * 32, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_merge<HD, G><<<dim3(p.K, B), 128, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch_decode(const DecodeParams& p, int B, int G, cudaStream_t st) {
  switch (G) {
    case 1: return launch_decode<HD, 1>(p, B, st);
    case 2: return launch_decode<HD, 2>(p, B, st);
    case 4: return launch_decode<HD, 4>(p, B, st);
    case 8: return launch_decode<HD, 8>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_arena, const void* v_arena, void* o,
    const int* tables, const int* kv_len, float* part_m, float* part_l, float* part_acc,
    int L, int N, int B, int K, int bs, int MB, int H, int hd, int layer,
    int split_blocks, int n_splits, float scale, void* stream) {
  if (layer < 0 || layer >= L || K < 1 || H % K != 0 || B < 1 || bs % UNIT != 0 ||
      split_blocks < 1 || n_splits * split_blocks < MB)
    return (int)cudaErrorInvalidValue;
  const long long blk_stride = (long long)K * bs * hd;
  const long long layer_off = (long long)layer * N * blk_stride;
  const DecodeParams p{static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k_arena) + layer_off,
                       static_cast<const bf16*>(v_arena) + layer_off,
                       static_cast<bf16*>(o), tables, kv_len, part_m, part_l, part_acc,
                       blk_stride, K, bs, MB, H, split_blocks, n_splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return dispatch_decode<128>(p, B, H / K, st);
  if (hd == 64) return dispatch_decode<64>(p, B, H / K, st);
  return (int)cudaErrorInvalidValue;
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
  const long long blk_stride = (long long)K * bs * hd;
  const long long layer_off = (long long)layer * N * blk_stride;
  const PagedKV kv{static_cast<const bf16*>(k_arena) + layer_off,
                   static_cast<const bf16*>(v_arena) + layer_off,
                   tables, kv_len, write_index, blk_stride, MB, bs, hd};
  const attn_sm90::Params p{static_cast<const bf16*>(q), (long long)S * H * hd, (long long)H * hd, hd,
                            static_cast<bf16*>(o), static_cast<float*>(part_m), static_cast<float*>(part_l),
                            static_cast<float*>(part_acc), S, H, K, H / K, 1, split_keys, n_splits,
                            scale * 1.4426950408889634f};
  return attn_sm90::chunk(p, kv, B, hd, block_rows, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
