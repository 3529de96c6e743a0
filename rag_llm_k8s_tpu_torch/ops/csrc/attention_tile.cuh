// Blockwise online-softmax GQA attention for sm_90a: the device routine of
// attention_q8.cu's two int8 chunk kernels (dense cache and paged arena).
// Every bf16 attention kernel runs the Hopper routines of attention_sm90.cuh
// over the same policy interface. Where a key row lives is the only thing
// that differs, so the routine is a template over a K/V addressing policy:
//
//   struct KV {
//     static constexpr bool kInt8;  // payload type: bf16, or int8 + scales
//     int start(int b) const;    // first valid key position of row b
//     int len(int b) const;      // valid key frontier (exclusive)
//     int offset(int b) const;   // logical position of row b's query 0
//     const bf16* k_row(int b, int kvh, int kp) const;  // hd contiguous
//     const bf16* v_row(int b, int kvh, int kp) const;  // (int8_t* if kInt8)
//     float k_scale(int b, int kvh, int kp) const;      // kInt8 only
//     float v_scale(int b, int kvh, int kp) const;
//   };
//
// An int8 payload (one fp32 scale per key or value row) is converted to bf16
// as it enters shared memory, which is exact (|q| <= 127); the scales act in
// the epilogues, as in the TPU q8 kernels: each score column is multiplied by
// its k-scale, and each probability by its v-scale just before it is rounded
// to bf16 for the PV product. Scales outside the window are zeroed before
// they touch anything (they may be NaN).
//
// Semantics kept from the TPU kernels: fp32 running max, sum and accumulator;
// the key window [start, len) per batch row plus (offset) causality
// t_k <= offset + t; K/V rows outside the window are zeroed in shared memory
// before any product (slots past the frontier may hold garbage, and
// 0 * NaN = NaN); p is cast to bf16 (the V dtype) before the PV product; a
// query row with no visible key writes 0; GQA reads kv head h / G directly,
// never a repeated copy.
//
// Design, simple first: one block of four warps per (batch row, kv head, tile
// of 64 query rows), where a query row is a (position, head-in-group) pair,
// so a K/V tile loaded once serves all G heads of its group. Products run on
// the tensor cores through WMMA 16x16x16 bf16 fragments with fp32
// accumulation; scores, probabilities and the output accumulator go through
// shared memory so the softmax can rescale rows. The TPU grid's sequential
// K/V axis becomes a loop inside the block, with tiles wholly outside the
// window or above the causal diagonal skipped.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

namespace attn_tile {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;      // query rows per block
constexpr int BN = 64;      // keys per tile
constexpr int NWARPS = 4;   // each warp owns 16 query rows
constexpr float NEG_INF = -1e30f;

struct QParams {
  const bf16* q;
  long long q_sb, q_st, q_sh;  // q[b, t, h, :] at b*q_sb + t*q_st + h*q_sh
  bf16* o;                     // [B, S, H, hd] contiguous
  int S, H, K, G;
  int causal;
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

// 8 consecutive values of a key or value row as 8 bf16 (one 16-byte vector)
__device__ __forceinline__ uint4 load8(const bf16* row) {
  return *reinterpret_cast<const uint4*>(row);
}

__device__ __forceinline__ uint4 load8(const int8_t* row) {
  const uint2 raw = *reinterpret_cast<const uint2*>(row);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned w = i < 2 ? raw.x : raw.y;
    const int sh = 16 * (i % 2);
    // sign-extend bytes sh/8 and sh/8 + 1 of the word
    const float a = (float)((int)(w << (24 - sh)) >> 24);
    const float b = (float)((int)(w << (16 - sh)) >> 24);
    h[i] = __floats2bfloat162_rn(a, b);
  }
  return out;
}

template <int HD, bool Q8>
constexpr size_t smem_bytes() {
  return (size_t)BM * HD * sizeof(bf16)        // Q tile
         + 2 * (size_t)BN * HD * sizeof(bf16)  // K and V tiles
         + (size_t)BM * BN * sizeof(float)     // scores
         + (size_t)BM * BN * sizeof(bf16)      // probabilities
         + (size_t)BM * HD * sizeof(float)     // output accumulator
         + (Q8 ? 2 * (size_t)BN * sizeof(float) : 0);  // k- and v-scales
}

template <int HD, class KV>
__global__ void __launch_bounds__(NWARPS * 32) attn_kernel(QParams p, KV kv) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * HD;
  bf16* Vs = Ks + BN * HD;
  float* Ss = reinterpret_cast<float*>(Vs + BN * HD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BM * BN);
  float* Os = reinterpret_cast<float*>(Ps + BM * BN);
  float* KSs = Os + BM * HD;  // kInt8: the tile's k- and v-scales
  float* VSs = KSs + BN;

  constexpr int VEC = 8;  // bf16 values per 16-byte load
  constexpr int RV = HD / VEC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / p.K, kvh = blockIdx.y % p.K;
  const int r0 = blockIdx.x * BM;
  const int n_rows = p.S * p.G;
  const int ks = kv.start(b), kl = kv.len(b), q_offset = kv.offset(b);

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

  // tile skip: only K/V tiles overlapping the window and, when causal, at
  // or below this tile's last query position are visited
  const int lo = max(ks, 0);
  int hi = kl;
  if (p.causal) {
    const int last_row = min(r0 + BM, n_rows) - 1;
    hi = min(hi, q_offset + last_row / p.G + 1);
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
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (kp >= ks && kp < kl) {
        kx = load8(kv.k_row(b, kvh, kp) + c);
        vx = load8(kv.v_row(b, kvh, kp) + c);
      }
      *reinterpret_cast<uint4*>(Ks + n * HD + c) = kx;
      *reinterpret_cast<uint4*>(Vs + n * HD + c) = vx;
    }
    if constexpr (KV::kInt8) {
      // scales outside the window are zero, never loaded
      for (int n = tid; n < BN; n += blockDim.x) {
        const int kp = k0 + n;
        const bool in = kp >= ks && kp < kl;
        KSs[n] = in ? kv.k_scale(b, kvh, kp) : 0.f;
        VSs[n] = in ? kv.v_scale(b, kvh, kp) : 0.f;
      }
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
      const int qpos = q_offset + rr / p.G;
      float sv[2];
      bool ok[2];
      float mx = NEG_INF;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = lane + 32 * c2, kp = k0 + c;
        const bool valid = row_ok && kp >= ks && kp < kl && (!p.causal || kp <= qpos);
        float sc = Ss[rl * BN + c] * p.scale;
        if constexpr (KV::kInt8) sc *= KSs[c];
        const float s = valid ? sc : NEG_INF;
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
        float pw = pv;
        if constexpr (KV::kInt8) pw *= VSs[lane + 32 * c2];  // V's dequantization
        Ps[rl * BN + lane + 32 * c2] = __float2bfloat16(pw);
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

template <int HD, class KV>
int launch(const QParams& p, const KV& kv, int B, cudaStream_t s) {
  const size_t smem = smem_bytes<HD, KV::kInt8>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<HD, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S * p.G + BM - 1) / BM, B * p.K);
  attn_kernel<HD, KV><<<grid, NWARPS * 32, smem, s>>>(p, kv);
  return (int)cudaGetLastError();
}

template <class KV>
int dispatch(const QParams& p, const KV& kv, int B, int hd, void* stream) {
  if (p.K < 1 || p.H % p.K != 0 || p.S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(p, kv, B, s);
  if (hd == 128) return launch<128>(p, kv, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_tile
