// Brute-force squared-L2 top-k over the device-resident store, for sm_90a.
//
// Replaces the Pallas TPU kernel rag_llm_k8s_tpu/ops/knn.py:knn_topk_pallas
// (body _knn_kernel): d = |q|^2 + |e|^2 - 2 q.e in fp32, k smallest per query,
// ties to the lowest row id (the Pallas kernel's first argmin), padded rows
// carrying BIG norms never displacing the (BIG, -1) fill entries.
//
// Bound on an H100: reading the [N_pad, D] fp32 matrix once. At 65,536 x 1024
// that is 268 MB, 80 us at 3.35 TB/s; the distance arithmetic (2*Q*N*D fp32
// operations on CUDA cores, no TF32) is 16 us at Q = 8. Design: the TPU grid's
// sequential carry of a running top-k becomes two passes. Pass 1 gives each
// block a tile of 128 rows and up to 8 queries held in shared memory; each
// warp streams whole rows with 16-byte loads (neighbouring lanes on
// neighbouring addresses), reduces the dot products with shuffles and keeps a
// per-warp top-k; the block merges its warps' lists into a per-(query, tile)
// partial list. Pass 2 merges the partial lists of each query with one warp.
// 512 blocks at N_pad = 65,536 keep all 132 SMs streaming.

#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 8;
constexpr int TILE_N = 128;
constexpr int QCHUNK = 8;
constexpr int WARPS = 8;
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// Insert (v, i) into the ascending list (tv, ti) of length k.
__device__ __forceinline__ void insert(float* tv, int* ti, int k, float v, int i) {
  if (!before(v, i, tv[k - 1], ti[k - 1])) return;
  int j = k - 1;
  while (j > 0 && before(v, i, tv[j - 1], ti[j - 1])) {
    tv[j] = tv[j - 1];
    ti[j] = ti[j - 1];
    --j;
  }
  tv[j] = v;
  ti[j] = i;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
knn_partial(const float* __restrict__ q, const float* __restrict__ emb,
            const float* __restrict__ norms, float* __restrict__ part_v,
            int* __restrict__ part_i, int Q, int N, int D, int k, int n_tiles) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [QCHUNK, D]
  float* qn = qs + QCHUNK * D;           // [QCHUNK]
  float* wv = qn + QCHUNK;               // [WARPS, QCHUNK, KMAX]
  int* wi = reinterpret_cast<int*>(wv + WARPS * QCHUNK * KMAX);

  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * QCHUNK;
  const int nq = min(QCHUNK, Q - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int x = threadIdx.x; x < nq * D; x += blockDim.x) qs[x] = q[(size_t)q0 * D + x];
  __syncthreads();
  if (warp < nq) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) {
      float a = qs[warp * D + d];
      s += a * a;
    }
    s = warp_sum(s);
    if (lane == 0) qn[warp] = s;
  }
  __syncthreads();

  float tv[QCHUNK][KMAX];
  int ti[QCHUNK][KMAX];
  for (int a = 0; a < QCHUNK; ++a)
    for (int j = 0; j < KMAX; ++j) {
      tv[a][j] = BIG;
      ti[a][j] = -1;
    }

  const int D4 = D / 4;
  for (int r = warp; r < TILE_N; r += WARPS) {
    const int row = tile * TILE_N + r;
    if (row >= N) break;
    const float4* e4 = reinterpret_cast<const float4*>(emb + (size_t)row * D);
    float acc[QCHUNK];
#pragma unroll
    for (int a = 0; a < QCHUNK; ++a) acc[a] = 0.f;
    for (int d4 = lane; d4 < D4; d4 += 32) {
      const float4 e = e4[d4];
#pragma unroll
      for (int a = 0; a < QCHUNK; ++a) {
        if (a < nq) {
          const float4 qq = reinterpret_cast<const float4*>(qs + a * D)[d4];
          acc[a] += qq.x * e.x + qq.y * e.y + qq.z * e.z + qq.w * e.w;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < QCHUNK; ++a) acc[a] = warp_sum(acc[a]);
    if (lane == 0) {
      const float en = norms[row];
      for (int a = 0; a < nq; ++a) insert(tv[a], ti[a], k, qn[a] + en - 2.f * acc[a], row);
    }
  }
  if (lane == 0) {
    for (int a = 0; a < nq; ++a)
      for (int j = 0; j < k; ++j) {
        wv[(warp * QCHUNK + a) * KMAX + j] = tv[a][j];
        wi[(warp * QCHUNK + a) * KMAX + j] = ti[a][j];
      }
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    const int a = threadIdx.x;
    float mv[KMAX];
    int mi[KMAX];
    for (int j = 0; j < KMAX; ++j) {
      mv[j] = BIG;
      mi[j] = -1;
    }
    for (int w = 0; w < WARPS; ++w)
      for (int j = 0; j < k; ++j)
        insert(mv, mi, k, wv[(w * QCHUNK + a) * KMAX + j], wi[(w * QCHUNK + a) * KMAX + j]);
    const size_t base = ((size_t)(q0 + a) * n_tiles + tile) * k;
    for (int j = 0; j < k; ++j) {
      part_v[base + j] = mv[j];
      part_i[base + j] = mi[j];
    }
  }
}

// One warp per query: each lane keeps the k best of a strided share of the
// candidates, then k rounds of a warp-wide lexicographic argmin pop them.
__global__ void knn_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
                          float* __restrict__ out_v, int* __restrict__ out_i,
                          int n_cand, int k) {
  const int qi = blockIdx.x, lane = threadIdx.x;
  float lv[KMAX];
  int li[KMAX];
  for (int j = 0; j < KMAX; ++j) {
    lv[j] = BIG;
    li[j] = -1;
  }
  for (int c = lane; c < n_cand; c += 32)
    insert(lv, li, k, part_v[(size_t)qi * n_cand + c], part_i[(size_t)qi * n_cand + c]);
  int head = 0;
  for (int j = 0; j < k; ++j) {
    float v = head < k ? lv[head] : BIG;
    int i = head < k ? li[head] : 0x7fffffff;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (before(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (head < k && lv[head] == v && li[head] == i) ++head;
    if (lane == 0) {
      out_v[(size_t)qi * k + j] = v;
      out_i[(size_t)qi * k + j] = i;
    }
  }
}

}  // namespace

extern "C" int knn_topk_f32(const float* q, const float* emb, const float* norms,
                            float* part_v, int* part_i, float* out_v, int* out_i,
                            int Q, int N, int D, int k, void* stream) {
  if (k < 1 || k > KMAX || D % 4 != 0 || Q < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + TILE_N - 1) / TILE_N;
  const size_t smem = (size_t)(QCHUNK * D + QCHUNK) * sizeof(float) +
                      (size_t)WARPS * QCHUNK * KMAX * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      knn_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, (Q + QCHUNK - 1) / QCHUNK);
  knn_partial<<<grid, WARPS * 32, smem, s>>>(q, emb, norms, part_v, part_i, Q, N, D, k, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_merge<<<Q, 32, 0, s>>>(part_v, part_i, out_v, out_i, n_tiles * k, k);
  return (int)cudaGetLastError();
}

extern "C" int knn_tile_rows() { return TILE_N; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
