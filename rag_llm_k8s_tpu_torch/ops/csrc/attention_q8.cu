// Attention over an int8 KV cache for sm_90a: four C entry points.
//
// Replaces the Pallas TPU kernels of rag_llm_k8s_tpu/ops/attention.py:
//   decode_attention_q8        (body _decode_kernel_q8)        one query over
//                              the dense int8 cache [L, B, K, T, hd] at layer
//   chunk_prefill_attention_q8 (body _chunk_kernel_q8)         S queries at
//                              write_index over the dense int8 cache
//   paged_decode_attention_q8  (body _paged_decode_kernel_q8)  one query per
//                              row over its live blocks of the int8 arena
//   paged_chunk_attention_q8   (body _paged_chunk_kernel_q8)   S queries per
//                              row at a per-row write_index over the arena
// The payload is int8 with one fp32 scale per (token, kv head) row: the dense
// cache's scales are [L, B, K, T], the arena's [L, N, K, bs]. Dequantization
// rides the epilogues, as on the TPU: a score column is multiplied by its
// k-scale, a probability by its v-scale just before the bf16 rounding for the
// PV product; the payload is only converted (exactly) to bf16 or fp32. Scales
// outside a row's window are zeroed before they multiply anything: slots past
// a frontier and blocks no row owns may hold NaN. A row with no visible key
// writes zeros.
//
// Bounds on an H100. One key costs 2 * K * hd bytes of payload and 2 * K * 4
// of scales per layer: 2,112 B at K = 8, hd = 128, against 4,096 in bf16.
// Decode at T = 4352 (B = 1, ~4,100 live keys) reads ~8.7 MB per layer, 2.6 us
// at 3.35 TB/s; the paged decode at B = 8 over 9,885 live keys ~21 MB, 6 us.
// Both are bound by bytes.
//
// Decode (dense and paged): one routine templated on where a key row lives
// (DenseQ8: strides and window [kv_start, kv_len); PagedQ8: a table lookup
// and window [0, kv_len)). A row's window is cut into splits of split_units
// 16-key units, one block of four warps per (split, kv head, row), and a
// second kernel merges the splits. A warp owns whole units (16 consecutive
// rows of one (layer, row or block, kv head) slab): each lane loads its hd / 32
// bytes of all 16 K and V rows and the 16 scale pairs before any arithmetic;
// the G query heads of the kv head are computed together on CUDA cores
// (a 16- or 64-row tensor core tile would be mostly padding at G = 4), scores
// reduce across the warp with shuffles, and the four warps' states merge in
// shared memory.
//
// Chunk (dense and paged): the int8 chunk routine of attention_sm90.cuh
// (chunk_q8_kernel), the wgmma chunk routine of the bf16 kernels with the
// payload widened to bf16 in shared memory and the scales acting on the score
// and probability fragments, with split-KV and the merge pass planned as for
// the bf16 chunk kernels (ops.attention.chunk_launch_plan; the paged one from
// the host-known capacity MB * bs). Bounds on an H100: the S = 16 verify at
// T = 4352 reads ~8.5 MB per layer (2.5 us, bytes); the mixed window at
// B = 8, S = 64 (15,000 live keys, every lane of a row computing) is bound by
// operations (~16 us); the S = 4096 chunk at write_index 4096 does ~405 GFLOP
// (0.41 ms, operations).

#include "attention_sm90.cuh"

using attn_sm90::bf16;
using attn_sm90::NEG_INF;
using attn_sm90::warp_sum;

namespace {

// One layer of the dense int8 cache: key kp of row b, kv head kvh at scale
// index (b * K + kvh) * T + kp, payload at that index * hd; window
// [max(kv_start, 0), min(kv_len, T)), query 0 at q_offset.
struct DenseQ8 {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int* kv_start;
  const int* kv_len;
  int K, T, hd, q_offset;

  __device__ int start(int b) const { return max(kv_start[b], 0); }
  __device__ int len(int b) const { return min(kv_len[b], T); }
  __device__ int offset(int) const { return q_offset; }
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

constexpr int UNIT = 16;  // keys a warp takes at a time (never across a block)
constexpr int DEC_WARPS = 4;

struct DecodeParams {
  const bf16* q;    // [B, 1, H, hd]
  bf16* o;          // [B, 1, H, hd]
  float* part_m;    // [B, K, n_splits, G]
  float* part_l;    // [B, K, n_splits, G]
  float* part_acc;  // [B, K, n_splits, G, hd]
  int K, H, split_units, n_splits;
  float scale;
};

// the hd / 32 int8 values one lane holds of a key row
template <int DPL> struct LaneI8;
template <> struct LaneI8<4> { using type = char4; };
template <> struct LaneI8<2> { using type = char2; };

__device__ __forceinline__ void unpack(const char4& x, float* f) {
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void unpack(const char2& x, float* f) {
  f[0] = x.x; f[1] = x.y;
}

// units [u_first, u_end) of row b's window, and how many splits cover them
template <class KV>
__device__ __forceinline__ int units_of(const KV& kv, int b, int* u_first, int* u_end) {
  const int lo = kv.start(b), hi = kv.len(b);
  *u_first = lo / UNIT;
  *u_end = hi > lo ? (hi + UNIT - 1) / UNIT : *u_first;
  return *u_end - *u_first;
}

template <int HD, int G, class KV>
__global__ void __launch_bounds__(DEC_WARPS * 32) decode_q8_split(DecodeParams p, KV kv) {
  constexpr int DPL = HD / 32;
  using Vec = typename LaneI8<DPL>::type;
  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = kv.start(b), hi = kv.len(b);
  int u_first, u_end;
  units_of(kv, b, &u_first, &u_end);
  const int u_lo = u_first + s * p.split_units;
  if (u_lo >= u_end) return;  // past the row's window: the merge skips it
  const int u_hi = min(u_lo + p.split_units, u_end);

  float qr[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bf16* qp = p.q + ((long long)b * p.H + kvh * G + g) * HD + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) qr[g][d] = __bfloat162float(qp[d]);
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
    const long long r0 = kv.srow(b, kvh, kp0);  // the unit's 16 rows are r0 .. r0 + 15
    // every load of the unit in flight before any arithmetic
    Vec kx[UNIT], vx[UNIT];
    float ksc[UNIT], vsc[UNIT];
#pragma unroll
    for (int j = 0; j < UNIT; ++j) {
      kx[j] = *reinterpret_cast<const Vec*>(kv.k + (r0 + j) * HD + lane * DPL);
      vx[j] = *reinterpret_cast<const Vec*>(kv.v + (r0 + j) * HD + lane * DPL);
      ksc[j] = kv.ks[r0 + j];
      vsc[j] = kv.vs[r0 + j];
    }
    bool valid[UNIT];
#pragma unroll
    for (int j = 0; j < UNIT; ++j) {
      valid[j] = kp0 + j >= lo && kp0 + j < hi;
      // a scale outside the window is never used: it may be NaN
      ksc[j] = valid[j] ? ksc[j] : 0.f;
      vsc[j] = valid[j] ? vsc[j] : 0.f;
    }
    float sc[G][UNIT];
#pragma unroll
    for (int j = 0; j < UNIT; ++j) {
      float kf[DPL];
      unpack(kx[j], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) dot += qr[g][d] * kf[d];
        dot = warp_sum(dot);
        sc[g][j] = valid[j] ? dot * p.scale * ksc[j] : NEG_INF;
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
        if (valid[j]) {
          const float pj = expf(sc[g][j] - m_new);
          ps += pj;
          // V's dequantization, then the bf16 rounding of the TPU's PV operand
          const float pb = __bfloat162float(__float2bfloat16(pj * vsc[j]));
          float vf[DPL];
          unpack(vx[j], vf);
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

// merges the splits of one (row, kv head); a row with no visible key writes 0
template <int HD, int G, class KV>
__global__ void __launch_bounds__(128) decode_q8_merge(DecodeParams p, KV kv) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  int u_first, u_end;
  const int units = units_of(kv, b, &u_first, &u_end);
  const int n_s = (units + p.split_units - 1) / p.split_units;
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

template <int HD, int G, class KV>
int launch_decode(const DecodeParams& p, const KV& kv, int B, cudaStream_t st) {
  decode_q8_split<HD, G, KV><<<dim3(p.n_splits, p.K, B), DEC_WARPS * 32, 0, st>>>(p, kv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_q8_merge<HD, G, KV><<<dim3(p.K, B), 128, 0, st>>>(p, kv);
  return (int)cudaGetLastError();
}

template <int HD, class KV>
int dispatch_g(const DecodeParams& p, const KV& kv, int B, cudaStream_t st) {
  switch (p.H / p.K) {
    case 1: return launch_decode<HD, 1>(p, kv, B, st);
    case 2: return launch_decode<HD, 2>(p, kv, B, st);
    case 4: return launch_decode<HD, 4>(p, kv, B, st);
    case 8: return launch_decode<HD, 8>(p, kv, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class KV>
int dispatch_decode(const DecodeParams& p, const KV& kv, int B, int hd, void* stream) {
  if (p.K < 1 || p.H % p.K != 0 || B < 1 || p.split_units < 1 || p.n_splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return dispatch_g<128>(p, kv, B, st);
  if (hd == 64) return dispatch_g<64>(p, kv, B, st);
  return (int)cudaErrorInvalidValue;
}

DecodeParams decode_params(const void* q, void* o, float* part_m, float* part_l, float* part_acc,
                           int K, int H, int split_units, int n_splits, float scale) {
  return DecodeParams{static_cast<const bf16*>(q), static_cast<bf16*>(o), part_m, part_l, part_acc,
                      K, H, split_units, n_splits, scale};
}

attn_sm90::Params chunk_params(const void* q, void* o, void* part_m, void* part_l, void* part_acc,
                               int S, int H, int K, int hd, int split_keys, int n_splits, float scale) {
  return attn_sm90::Params{static_cast<const bf16*>(q), (long long)S * H * hd, (long long)H * hd, hd,
                           static_cast<bf16*>(o), static_cast<float*>(part_m), static_cast<float*>(part_l),
                           static_cast<float*>(part_acc), S, H, K, H / K, 1, split_keys, n_splits,
                           scale * 1.4426950408889634f};
}

}  // namespace

// The dense cache: payload [L, B, K, T, hd] int8, scales [L, B, K, T] fp32.
// split_units * 16 keys per split; n_splits * split_units * 16 >= T.
extern "C" int decode_attention_q8(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, void* o, const int* kv_start, const int* kv_len,
    float* part_m, float* part_l, float* part_acc,
    int L, int B, int K, int T, int H, int hd, int layer, int split_units, int n_splits,
    float scale, void* stream) {
  if (layer < 0 || layer >= L || T % UNIT != 0 ||
      (long long)n_splits * split_units * UNIT < T)
    return (int)cudaErrorInvalidValue;
  const long long s_off = (long long)layer * B * K * T;
  const DenseQ8 kv{static_cast<const int8_t*>(k_cache) + s_off * hd,
                   static_cast<const int8_t*>(v_cache) + s_off * hd,
                   static_cast<const float*>(k_scale) + s_off,
                   static_cast<const float*>(v_scale) + s_off,
                   kv_start, kv_len, K, T, hd, 0};
  return dispatch_decode(decode_params(q, o, part_m, part_l, part_acc, K, H, split_units, n_splits, scale),
                         kv, B, hd, stream);
}

// q, out [B, S, H, hd] contiguous; part_* the split scratch ([B*K,
// n_splits, S*H/K] and [..., hd], fp32), null when n_splits == 1. T % 4 == 0
// (the scales travel in 16-byte pieces).
extern "C" int chunk_attention_q8(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, void* o, const int* kv_start, const int* kv_len,
    void* part_m, void* part_l, void* part_acc,
    int L, int B, int K, int T, int S, int H, int hd, int layer, int write_index,
    int block_rows, int split_keys, int n_splits, float scale, void* stream) {
  if (layer < 0 || layer >= L || K < 1 || T % 4 || (n_splits > 1) != (part_m != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long s_off = (long long)layer * B * K * T;
  const DenseQ8 kv{static_cast<const int8_t*>(k_cache) + s_off * hd,
                   static_cast<const int8_t*>(v_cache) + s_off * hd,
                   static_cast<const float*>(k_scale) + s_off,
                   static_cast<const float*>(v_scale) + s_off,
                   kv_start, kv_len, K, T, hd, write_index};
  return attn_sm90::chunk_q8(chunk_params(q, o, part_m, part_l, part_acc, S, H, K, hd, split_keys, n_splits, scale),
                             kv, B, hd, block_rows, stream);
}

// The arena: payload [L, N, K, bs, hd] int8, scales [L, N, K, bs] fp32.
extern "C" int paged_decode_attention_q8(
    const void* q, const void* k_arena, const void* v_arena, const void* k_scale,
    const void* v_scale, void* o, const int* tables, const int* kv_len,
    float* part_m, float* part_l, float* part_acc,
    int L, int N, int B, int K, int bs, int MB, int H, int hd, int layer,
    int split_units, int n_splits, float scale, void* stream) {
  if (layer < 0 || layer >= L || bs % UNIT != 0 ||
      (long long)n_splits * split_units * UNIT < (long long)MB * bs)
    return (int)cudaErrorInvalidValue;
  const long long s_off = (long long)layer * N * K * bs;
  const PagedQ8 kv{static_cast<const int8_t*>(k_arena) + s_off * hd,
                   static_cast<const int8_t*>(v_arena) + s_off * hd,
                   static_cast<const float*>(k_scale) + s_off,
                   static_cast<const float*>(v_scale) + s_off,
                   tables, kv_len, nullptr, K, MB, bs, hd};
  return dispatch_decode(decode_params(q, o, part_m, part_l, part_acc, K, H, split_units, n_splits, scale),
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
  return attn_sm90::chunk_q8(chunk_params(q, o, part_m, part_l, part_acc, S, H, K, hd, split_keys, n_splits, scale),
                             kv, B, hd, block_rows, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
