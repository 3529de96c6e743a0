// Exact squared-L2 top-k over the device-resident store, for sm_90a.
//
// Replaces the Pallas TPU kernel of rag_llm_k8s_tpu/ops/knn.py:
//   knn_topk_pallas (entry :87, body _knn_kernel :39, pallas_call :100)
// For each of Q fp32 queries over the padded fp32 store [N_pad, D]: the k <= 8
// smallest d = |q|^2 + |e|^2 - 2 q.e in fp32 (no TF32, no tensor core), |e|^2
// from sq_norms with BIG on padded rows, ties to the lowest row id (the
// Pallas kernel's first argmin), a slot with no real candidate (BIG, -1), and
// a padded row never displacing such a fill entry.
//
// Bound on an H100: reading the store once. At N_pad = 65,536 x D = 1024 that
// is 268 MB, 80 us at 3.35 TB/s; the 2 Q N D fp32 operations on CUDA cores
// take 16 us at Q = 8. So the kernel streams, and what keeps it from the
// bound is too few bytes in flight and too much work per byte. The design:
// - Specialized for D = 1024 (bge-m3). A block of 8 warps walks a contiguous
//   part of the rows (ops.knn.knn_launch_plan: two blocks per SM) in batches
//   of RB rows. Lane l of warp w owns float4 column 32 w + l of every row, so
//   a warp's loads of a row are 512 contiguous bytes, and issues the RB loads
//   of a batch together (a compile-time count: RB x 16 bytes in flight per
//   lane, 32 or 64 KB per block).
// - The lane holds its column of each query in registers (4 floats a
//   query), so a query is read once per block, never once per product.
// - The lane's (row, query) partial dot products are reduced across the warp
//   16 at a time by a transposing butterfly (16 shuffles for 16 sums, not 5
//   each), then across the 8 warps in shared memory.
// - Selection is cheap: one warp per batch, in turn, adds up the warps'
//   sums; each of its lanes keeps a sorted list of the 8 best (distance, id)
//   of one query in registers with static indices, and a row enters only
//   when it beats the list's last entry, a single compare for almost every
//   row. The block merges its lanes' lists per query into one list per
//   (query, part); a second pass of one block per query merges the parts'
//   lists (every list read at once: that pass is latency-bound). Every
//   comparison orders by (distance, id), so ties go to the lowest id at
//   every merge.
// - Two query counts are built: one query (what the retrieve sends), and 8
//   that share a pass over the store, of which the absent ones are masked
//   (zero columns, no selection, no list). More than 8 take one pass per 8
//   (ops.knn.knn_launch_plan's query chunks).
// - Any other width D (a multiple of 4) takes the same kernel with D known
//   at run time: the block's threads stride over the row's float4 columns,
//   a batch is the 16 (row, query) sums of one butterfly, and the queries'
//   columns are read (from L1) beside each row's.

#include <cuda_runtime.h>

namespace {

constexpr int D = 1024;        // the store's width the kernel is specialized for
constexpr int W = D / 128;     // warps a block: at D = 1024 each owns 128 columns
constexpr int F4 = D / 4;      // float4 columns of a row at D = 1024
constexpr int KMAX = 8;        // list length: k <= 8
constexpr int QMAX = 8;        // queries a pass
constexpr int PART_ALIGN = 16; // a part's rows are a multiple of every batch
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

// rows a batch: at D = 1024 as many as the loads, the queries' columns and
// the list fit in the 128 registers of two blocks an SM without a spill
// (ptxas): 16 for one query, 8 for 8; at any other D the rows of one
// butterfly's 16 sums
template <int QN, bool ANY_D>
struct Batch {
  static_assert(QN == 1 || QN == QMAX, "one query or a chunk of QMAX");
  static constexpr int RB = ANY_D ? 16 / QN : QN == 1 ? 16 : 8;
  static constexpr int NV = RB * QN;  // (row, query) sums a batch
  static constexpr int NC = NV / 16;  // butterflies of 16 sums
};

__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// The KMAX best (distance, id) seen, ascending, in registers (static indices)
struct TopK {
  float v[KMAX];
  int i[KMAX];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      v[s] = BIG;
      i[s] = -1;
    }
  }
  __device__ __forceinline__ bool enters(float x, int id) const { return before(x, id, v[KMAX - 1], i[KMAX - 1]); }
  // inserts (x, id), which enters: each slot takes the slot above it, x or itself
  __device__ __forceinline__ void insert(float x, int id) {
#pragma unroll
    for (int s = KMAX - 1; s > 0; --s) {
      const bool up = before(x, id, v[s - 1], i[s - 1]);
      const bool here = before(x, id, v[s], i[s]);
      v[s] = up ? v[s - 1] : here ? x : v[s];
      i[s] = up ? i[s - 1] : here ? id : i[s];
    }
    if (before(x, id, v[0], i[0])) {
      v[0] = x;
      i[0] = id;
    }
  }
  __device__ __forceinline__ void push(float x, int id) {
    if (enters(x, id)) insert(x, id);
  }
  // drops the head; the tail refills with (BIG, -1)
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int s = 0; s < KMAX - 1; ++s) {
      v[s] = v[s + 1];
      i[s] = i[s + 1];
    }
    v[KMAX - 1] = BIG;
    i[KMAX - 1] = -1;
  }
};

// Writes the first n of the union of the warp's lists, ascending, to
// (out_v, out_i) from lane 0: n rounds of a warp-wide (distance, id) argmin
// of the lists' heads, the winner popping its head. Ids are unique but for
// the (BIG, -1) fill entries, which are all alike.
__device__ __forceinline__ void warp_merge(TopK& t, float* out_v, int* out_i, int n, int lane) {
  for (int j = 0; j < n; ++j) {
    float v = t.v[0];
    int id = t.i[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, off);
      const int oi = __shfl_xor_sync(FULL, id, off);
      if (before(ov, oi, v, id)) {
        v = ov;
        id = oi;
      }
    }
    if (t.v[0] == v && t.i[0] == id) t.pop();
    if (lane == 0) {
      out_v[j] = v;
      out_i[j] = id;
    }
  }
}

// One step of transpose_sum16: x[0 .. 2H) -> x[0 .. H), the lane keeping
// the half its bit H selects plus its partner's copy of that half.
template <int H>
__device__ __forceinline__ void fold(float (&x)[16], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float keep = up ? x[j + H] : x[j];
    const float give = up ? x[j] : x[j + H];
    x[j] = keep + __shfl_xor_sync(FULL, give, H);
  }
}

// The sum over the warp of x[lane % 16], in lanes lane and lane ^ 16
// (8 + 4 + 2 + 1 + 1 shuffles for 16 sums).
__device__ __forceinline__ float transpose_sum16(float (&x)[16], int lane) {
  fold<8>(x, lane);
  fold<4>(x, lane);
  fold<2>(x, lane);
  fold<1>(x, lane);
  return x[0] + __shfl_xor_sync(FULL, x[0], 16);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// One block per part of the rows [part * rows_per_part, ...) for the nq <= QN
// queries at q (rows of dim floats; dim == D unless ANY_D): the part's list
// of the KMAX best per query into part_v / part_i [query, n_parts, KMAX]
// (pointers at the first query). Lane l keeps the list of query l % QN.
template <int QN, bool ANY_D>
__global__ void __launch_bounds__(W * 32, 2)
knn_scan_part(const float* __restrict__ q, const float4* __restrict__ emb, const float* __restrict__ norms,
              float* __restrict__ part_v, int* __restrict__ part_i, int nq, int dim, int N, int rows_per_part,
              int n_parts) {
  using Bt = Batch<QN, ANY_D>;
  constexpr int RB = Bt::RB, NV = Bt::NV, NC = Bt::NC;
  __shared__ float red[2][W][NC * 16];  // the warps' sums of a batch, two batches in turn
  __shared__ float q_sq[W][QN];         // the warps' shares of |q|^2
  __shared__ float list_v[W][32][KMAX];
  __shared__ int list_i[W][32][KMAX];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, col = warp * 32 + lane;
  const int f4 = ANY_D ? dim / 4 : F4;  // float4 columns of a row
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int part = blockIdx.x;
  const int row_lo = part * rows_per_part, row_hi = min(N, row_lo + rows_per_part);

  float4 qv[QN];  // at D = 1024 the lane's column of each query (absent: zero)
#pragma unroll
  for (int a = 0; a < QN; ++a) {
    float s = 0.f;
    if constexpr (ANY_D) {
      qv[a] = zero;
      if (a < nq)
        for (int c = col; c < f4; c += W * 32) {
          const float4 t = q4[(size_t)a * f4 + c];
          s += dot4(t, t);
        }
    } else {
      qv[a] = a < nq ? q4[(size_t)a * F4 + col] : zero;
      s = dot4(qv[a], qv[a]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) q_sq[warp][a] = s;
  }
  __syncthreads();
  const bool mine = lane % QN < nq;  // this lane's query is there
  float qn = 0.f;                    // |q|^2 of this lane's query
#pragma unroll
  for (int w = 0; w < W; ++w) qn += q_sq[w][lane % QN];

  TopK top;
  top.init();
  int batch = 0;
  for (int base = row_lo; base < row_hi; base += RB, ++batch) {
    const int buf = batch & 1, sel = batch % W;
    // the selecting warp's lane r holds the norm of the batch's row r
    const float en = warp == sel && lane < RB && base + lane < row_hi ? norms[base + lane] : 0.f;
    if constexpr (ANY_D) {
      float x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = 0.f;
      for (int c = col; c < f4; c += W * 32) {
        float4 e[RB], qc[QN];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          e[r] = base + r < row_hi ? __ldcs(emb + (size_t)(base + r) * f4 + c) : zero;
#pragma unroll
        for (int a = 0; a < QN; ++a) qc[a] = a < nq ? __ldg(q4 + (size_t)a * f4 + c) : zero;
#pragma unroll
        for (int j = 0; j < 16; ++j) x[j] += dot4(e[j / QN], qc[j % QN]);  // row j / QN, query j % QN
      }
      const float s = transpose_sum16(x, lane);
      if (lane < 16) red[buf][warp][lane] = s;
    } else {
      float4 e[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        e[r] = base + r < row_hi ? __ldcs(emb + (size_t)(base + r) * F4 + col) : zero;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float x[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int v = 16 * c + j;  // row v / QN, query v % QN
          x[j] = dot4(e[v / QN], qv[v % QN]);
        }
        const float s = transpose_sum16(x, lane);
        if (lane < 16) red[buf][warp][16 * c + lane] = s;
      }
    }
    __syncthreads();
    if (warp == sel) {
#pragma unroll
      for (int it = 0; it < (NV + 31) / 32; ++it) {
        const int v = lane + it * 32;  // query v % QN == lane % QN
        const int r = v < NV ? v / QN : 0;
        const float enr = __shfl_sync(FULL, en, r);
        if (v < NV && mine && base + r < row_hi) {
          float dot = 0.f;
#pragma unroll
          for (int w = 0; w < W; ++w) dot += red[buf][w][v];
          top.push(qn + enr - 2.f * dot, base + r);
        }
      }
    }
  }

  // the block's lists of each query, merged by one warp into the part's list
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    list_v[warp][lane][s] = top.v[s];
    list_i[warp][lane][s] = top.i[s];
  }
  __syncthreads();
  constexpr int PER_WARP = 32 / QN;  // lists a warp holds of one query
  for (int a = warp; a < nq; a += W) {
    TopK m;
    m.init();
    for (int x = lane; x < W * PER_WARP; x += 32) {
      const int w = x / PER_WARP, l = (x % PER_WARP) * QN + a;
      for (int s = 0; s < KMAX; ++s) {
        const float v = list_v[w][l][s];
        const int id = list_i[w][l][s];
        if (!m.enters(v, id)) break;  // the list is ascending: nothing after enters
        m.insert(v, id);
      }
    }
    const size_t o = ((size_t)a * n_parts + part) * KMAX;
    warp_merge(m, part_v + o, part_i + o, KMAX, lane);
  }
}

// One block per query: the first k of the union of its parts' lists. A
// thread reads whole lists (every load issued before any compare: the pass
// is latency-bound), each warp merges its threads' lists into shared memory
// and warp 0 merges the warps'.
constexpr int MERGE_WARPS = 8;

__global__ void __launch_bounds__(MERGE_WARPS * 32)
knn_merge_parts(const float* __restrict__ part_v, const int* __restrict__ part_i, float* __restrict__ out_v,
                int* __restrict__ out_i, int n_parts, int k) {
  __shared__ float warp_v[MERGE_WARPS][KMAX];
  __shared__ int warp_i[MERGE_WARPS][KMAX];
  const int qi = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  TopK m;
  m.init();
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
    const size_t o = ((size_t)qi * n_parts + p) * KMAX;
    const float4 v0 = *reinterpret_cast<const float4*>(part_v + o);
    const float4 v1 = *reinterpret_cast<const float4*>(part_v + o + 4);
    const int4 i0 = *reinterpret_cast<const int4*>(part_i + o);
    const int4 i1 = *reinterpret_cast<const int4*>(part_i + o + 4);
    const float v[KMAX] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    const int id[KMAX] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
    for (int s = 0; s < KMAX; ++s)
      if (s < k) m.push(v[s], id[s]);
  }
  warp_merge(m, warp_v[warp], warp_i[warp], KMAX, lane);
  __syncthreads();
  if (warp == 0) {
    m.init();
    if (lane < MERGE_WARPS) {
#pragma unroll
      for (int s = 0; s < KMAX; ++s) {
        m.v[s] = warp_v[lane][s];
        m.i[s] = warp_i[lane][s];
      }
    }
    warp_merge(m, out_v + (size_t)qi * k, out_i + (size_t)qi * k, k, lane);
  }
}

// one pass over the store for nq <= QMAX queries: the one-query kernel or
// the chunk kernel with the absent queries masked
template <bool ANY_D>
int launch_chunk(int nq, const float* q, const float* emb, const float* norms, float* part_v, int* part_i,
                 int dim, int N, int rows_per_part, int n_parts, cudaStream_t st) {
  const float4* e = reinterpret_cast<const float4*>(emb);
  if (nq == 1)
    knn_scan_part<1, ANY_D><<<n_parts, W * 32, 0, st>>>(q, e, norms, part_v, part_i, nq, dim, N, rows_per_part,
                                                        n_parts);
  else
    knn_scan_part<QMAX, ANY_D><<<n_parts, W * 32, 0, st>>>(q, e, norms, part_v, part_i, nq, dim, N,
                                                           rows_per_part, n_parts);
  return (int)cudaGetLastError();
}

}  // namespace

// q [Q, dim], emb [N, dim], norms [N], all fp32 contiguous with dim a
// multiple of 4 (the kernel specialized for D = 1024 when dim == D);
// part_v / part_i the scratch [Q, n_parts, KMAX]; out [Q, k]. The rows are
// cut into n_parts parts of rows_per_part (a multiple of 16) that cover
// them, as ops.knn.knn_launch_plan plans it.
extern "C" int knn_topk_f32(const float* q, const float* emb, const float* norms, float* part_v, int* part_i,
                            float* out_v, int* out_i, int Q, int N, int dim, int k, int rows_per_part,
                            int n_parts, void* stream) {
  if (dim < 4 || dim % 4 || k < 1 || k > KMAX || Q < 1 || N < 1 || rows_per_part < PART_ALIGN ||
      rows_per_part % PART_ALIGN || n_parts < 1 || (long long)n_parts * rows_per_part < N ||
      (long long)(n_parts - 1) * rows_per_part >= N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int q0 = 0; q0 < Q; q0 += QMAX) {
    const size_t o = (size_t)q0 * n_parts * KMAX;
    const int nq = Q - q0 < QMAX ? Q - q0 : QMAX;
    const float* qc = q + (size_t)q0 * dim;
    const int rc = dim == D ? launch_chunk<false>(nq, qc, emb, norms, part_v + o, part_i + o, dim, N,
                                                  rows_per_part, n_parts, st)
                            : launch_chunk<true>(nq, qc, emb, norms, part_v + o, part_i + o, dim, N,
                                                 rows_per_part, n_parts, st);
    if (rc != 0) return rc;
  }
  knn_merge_parts<<<Q, MERGE_WARPS * 32, 0, st>>>(part_v, part_i, out_v, out_i, n_parts, k);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
