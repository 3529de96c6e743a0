// Blockwise online-softmax GQA attention for sm_90a: one device routine, three
// C entry points.
//
// Replaces the Pallas TPU kernels of rag_llm_k8s_tpu/ops/attention.py:
//   flash_attention         (body _flash_kernel)  fresh K/V [B, S, K, hd]
//   decode_attention        (body _decode_kernel) one query over the stacked
//                                                 cache [L, B, K, T, hd] at layer
//   chunk_prefill_attention (body _chunk_kernel)  S queries at write_index over
//                                                 the cache, offset causality
// Fresh K/V and one cache layer differ only in strides and in the causal
// offset, so one templated routine serves all three.
//
// Semantics kept from the TPU kernels: fp32 running max, sum and accumulator;
// the key window [kv_start, kv_len) per batch row plus (offset) causality
// t_k <= q_offset + t; K/V rows outside the window are zeroed in shared
// memory before any product (slots past the frontier may hold garbage, and
// 0 * NaN = NaN); p is cast to bf16 (the V dtype) before the PV product; a
// query row with no visible key writes 0; GQA reads kv head h / G directly,
// never a repeated copy.
//
// Bounds on an H100. Prefill at S = 4096 (H = 32, hd = 128) is bound by
// operations: about 137 GFLOP per causal layer, 0.14 ms at 989 TFLOP/s bf16.
// Decode and the speculative verify at T = 4352 are bound by bytes: about
// 17 MB of live K/V across 32 layers, 5 us per layer at 3.35 TB/s.
// Design, simple first: one block of four warps per (batch row, kv head,
// tile of 64 query rows), where a query row is a (position, head-in-group)
// pair, so a K/V tile loaded once serves all G heads of its group. Products
// run on the tensor cores through WMMA 16x16x16 bf16 fragments with fp32
// accumulation; scores, probabilities and the output accumulator go through
// shared memory so the softmax can rescale rows. The TPU grid's sequential
// K/V axis becomes a loop inside the block, with blocks wholly outside the
// window or above the causal diagonal skipped. At B = 1 the decode and verify
// grids hold only K = 8 blocks and underfill the 132 SMs; split-KV, wgmma and
// TMA are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64;      // query rows per block
constexpr int BN = 64;      // keys per tile
constexpr int NWARPS = 4;   // each warp owns 16 query rows
constexpr float NEG_INF = -1e30f;

struct AttnParams {
  const bf16* q;
  long long q_sb, q_st, q_sh;  // q[b, t, h, :] at b*q_sb + t*q_st + h*q_sh
  const bf16* k;
  long long k_sb, k_st, k_sh;  // k[b, t, kvh, :] at b*k_sb + t*k_st + kvh*k_sh
  const bf16* v;
  long long v_sb, v_st, v_sh;
  bf16* o;                     // [B, S, H, hd] contiguous
  const int* kv_start;
  const int* kv_len;
  int S, Tk, H, K, G;
  int causal, q_offset;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)BM * HD * sizeof(bf16)        // Q tile
         + 2 * (size_t)BN * HD * sizeof(bf16)  // K and V tiles
         + (size_t)BM * BN * sizeof(float)     // scores
         + (size_t)BM * BN * sizeof(bf16)      // probabilities
         + (size_t)BM * HD * sizeof(float);    // output accumulator
}

template <int HD>
__global__ void __launch_bounds__(NWARPS * 32) attn_kernel(AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * HD;
  bf16* Vs = Ks + BN * HD;
  float* Ss = reinterpret_cast<float*>(Vs + BN * HD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BM * BN);
  float* Os = reinterpret_cast<float*>(Ps + BM * BN);

  constexpr int VEC = 8;  // bf16 values per 16-byte load
  constexpr int RV = HD / VEC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / p.K, kvh = blockIdx.y % p.K;
  const int r0 = blockIdx.x * BM;
  const int n_rows = p.S * p.G;
  const int ks = p.kv_start[b], kl = p.kv_len[b];

  for (int x = tid; x < BM * RV; x += blockDim.x) {
    const int r = x / RV, c = (x % RV) * VEC, rr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rr < n_rows) {
      const int t = rr / p.G, h = kvh * p.G + rr % p.G;
      val = *reinterpret_cast<const uint4*>(p.q + b * p.q_sb + t * p.q_st + h * p.q_sh + c);
    }
    *reinterpret_cast<uint4*>(Qs + r * HD + c) = val;
  }
  for (int x = tid; x < BM * HD; x += blockDim.x) Os[x] = 0.f;

  // block skip: only K/V tiles overlapping the window and, when causal, at
  // or below this tile's last query position are visited
  const int lo = max(ks, 0);
  int hi = min(kl, p.Tk);
  if (p.causal) {
    const int last_row = min(r0 + BM, n_rows) - 1;
    hi = min(hi, p.q_offset + last_row / p.G + 1);
  }

  float m_r[16], l_r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
  }
  __syncthreads();

  for (int k0 = (lo / BN) * BN; k0 < hi; k0 += BN) {
    // K/V tiles; rows outside the window are zeros, never loaded
    for (int x = tid; x < BN * RV; x += blockDim.x) {
      const int n = x / RV, c = (x % RV) * VEC, kp = k0 + n;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (kp >= ks && kp < kl && kp < p.Tk) {
        kv = *reinterpret_cast<const uint4*>(p.k + b * p.k_sb + kp * p.k_st + kvh * p.k_sh + c);
        vv = *reinterpret_cast<const uint4*>(p.v + b * p.v_sb + kp * p.v_st + kvh * p.v_sh + c);
      }
      *reinterpret_cast<uint4*>(Ks + n * HD + c) = kv;
      *reinterpret_cast<uint4*>(Vs + n * HD + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows, fp32 accumulation
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + warp * 16 * HD + kk, HD);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, Ks + j * 16 * HD + kk, HD);
          wmma::mma_sync(acc[j], a, kb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * BN + j * 16, acc[j], BN, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time across the warp (2 keys per lane)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int rl = warp * 16 + i, rr = r0 + rl;
      const bool row_ok = rr < n_rows;
      const int qpos = p.q_offset + rr / p.G;
      float sv[2];
      bool ok[2];
      float mx = NEG_INF;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = lane + 32 * c2, kp = k0 + c;
        const bool valid = row_ok && kp >= ks && kp < kl && kp < p.Tk &&
                           (!p.causal || kp <= qpos);
        const float s = valid ? Ss[rl * BN + c] * p.scale : NEG_INF;
        sv[c2] = s;
        ok[c2] = valid;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = expf(m_r[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const float pv = ok[c2] ? expf(sv[c2] - m_new) : 0.f;
        ps += pv;
        Ps[rl * BN + lane + 32 * c2] = __float2bfloat16(pv);
      }
      ps = warp_sum(ps);
      for (int d = lane; d < HD; d += 32) Os[rl * HD + d] *= alpha;
      m_r[i] = m_new;
      l_r[i] = l_r[i] * alpha + ps;
    }
    __syncwarp();

    // O += P V
#pragma unroll
    for (int dj = 0; dj < HD / 16; ++dj) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, Os + warp * 16 * HD + dj * 16, HD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + warp * 16 * BN + kk, BN);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kk * HD + dj * 16, HD);
        wmma::mma_sync(o, a, vb, o);
      }
      wmma::store_matrix_sync(Os + warp * 16 * HD + dj * 16, o, HD, wmma::mem_row_major);
    }
    __syncthreads();
  }
  __syncwarp();

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int rl = warp * 16 + i, rr = r0 + rl;
    if (rr >= n_rows) continue;
    const int t = rr / p.G, h = kvh * p.G + rr % p.G;
    const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
    bf16* orow = p.o + ((long long)(b * p.S + t) * p.H + h) * HD;
    for (int d = lane; d < HD; d += 32) orow[d] = __float2bfloat16(Os[rl * HD + d] * inv);
  }
}

template <int HD>
int launch(const AttnParams& p, int B, cudaStream_t s) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S * p.G + BM - 1) / BM, B * p.K);
  attn_kernel<HD><<<grid, NWARPS * 32, smem, s>>>(p);
  return (int)cudaGetLastError();
}

int dispatch(const AttnParams& p, int B, int hd, void* stream) {
  if (p.K < 1 || p.H % p.K != 0 || p.S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(p, B, s);
  if (hd == 128) return launch<128>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Fresh K/V. Strides are in elements; the head dim is contiguous.
extern "C" int flash_attention_bf16(
    const void* q, long long q_sb, long long q_st, long long q_sh,
    const void* k, long long k_sb, long long k_st, long long k_sh,
    const void* v, long long v_sb, long long v_st, long long v_sh,
    void* o, const int* kv_start, const int* kv_len,
    int B, int S, int Sk, int H, int K, int hd, int causal, float scale, void* stream) {
  AttnParams p{static_cast<const bf16*>(q), q_sb, q_st, q_sh,
               static_cast<const bf16*>(k), k_sb, k_st, k_sh,
               static_cast<const bf16*>(v), v_sb, v_st, v_sh,
               static_cast<bf16*>(o), kv_start, kv_len,
               S, Sk, H, K, H / (K > 0 ? K : 1), causal, 0, scale};
  return dispatch(p, B, hd, stream);
}

// One cache layer of a contiguous [L, B, K, T, hd] cache.
static AttnParams cache_params(const void* q, const void* kc, const void* vc, void* o,
                               const int* kv_start, const int* kv_len,
                               int L, int B, int K, int T, int S, int H, int hd,
                               int layer, int causal, int q_offset, float scale) {
  const long long layer_off = (long long)layer * B * K * T * hd;
  const long long sb = (long long)K * T * hd, sh = (long long)T * hd;
  (void)L;
  return AttnParams{static_cast<const bf16*>(q), (long long)S * H * hd, (long long)H * hd, hd,
                    static_cast<const bf16*>(kc) + layer_off, sb, hd, sh,
                    static_cast<const bf16*>(vc) + layer_off, sb, hd, sh,
                    static_cast<bf16*>(o), kv_start, kv_len,
                    S, T, H, K, H / (K > 0 ? K : 1), causal, q_offset, scale};
}

extern "C" int decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    const int* kv_start, const int* kv_len,
    int L, int B, int K, int T, int H, int hd, int layer, float scale, void* stream) {
  if (layer < 0 || layer >= L) return (int)cudaErrorInvalidValue;
  AttnParams p = cache_params(q, k_cache, v_cache, o, kv_start, kv_len,
                              L, B, K, T, 1, H, hd, layer, 0, 0, scale);
  return dispatch(p, B, hd, stream);
}

extern "C" int chunk_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache, void* o,
    const int* kv_start, const int* kv_len,
    int L, int B, int K, int T, int S, int H, int hd, int layer, int write_index,
    float scale, void* stream) {
  if (layer < 0 || layer >= L) return (int)cudaErrorInvalidValue;
  AttnParams p = cache_params(q, k_cache, v_cache, o, kv_start, kv_len,
                              L, B, K, T, S, H, hd, layer, 1, write_index, scale);
  return dispatch(p, B, hd, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
